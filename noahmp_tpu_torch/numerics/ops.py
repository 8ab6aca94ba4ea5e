"""Elementwise helpers that take Python scalars where ``torch`` wants
tensors.

The column physics mixes float32 tensors with Python float constants in
``max``/``min``/``where``/``clip``.  ``torch.maximum`` and
``torch.minimum`` refuse a Python scalar, so these thin wrappers route a
scalar operand to ``clamp``; a scalar never changes the tensor's dtype.
NaN propagates as in the array-array forms.
"""

import torch

F32 = torch.float32


def _is_scalar(x):
    return isinstance(x, (int, float))


def maximum(a, b):
    if _is_scalar(b):
        return a.clamp(min=b)
    if _is_scalar(a):
        return b.clamp(min=a)
    return torch.maximum(a, b)


def minimum(a, b):
    if _is_scalar(b):
        return a.clamp(max=b)
    if _is_scalar(a):
        return b.clamp(max=a)
    return torch.minimum(a, b)


def clip(x, lo, hi):
    """min(max(x, lo), hi); lo and hi may be scalars or tensors."""
    return minimum(maximum(x, lo), hi)


def where(cond, a, b):
    """``torch.where`` with Python scalars on either side.  Two scalars
    give a float32 result (never the default dtype by accident)."""
    if _is_scalar(a) and _is_scalar(b):
        a = torch.full((), a, dtype=F32, device=cond.device)
    return torch.where(cond, a, b)


def col(x):
    """Per-point scalar (n,) -> (n, 1), to broadcast against layer or
    band vectors (n, L)."""
    return x.unsqueeze(-1)


def sum_last(x):
    """Sum over the tiny last axis with strict left-to-right adds, so
    the result does not depend on how a device reduction associates."""
    acc = x[..., 0]
    for k in range(1, x.shape[-1]):
        acc = acc + x[..., k]
    return acc


def shift_down(x):
    """x[..., k-1] at slot k, 0 at slot 0 (the layer above)."""
    return torch.cat([torch.zeros_like(x[..., :1]), x[..., :-1]], dim=-1)


def shift_up(x):
    """x[..., k+1] at slot k, 0 at the last slot (the layer below)."""
    return torch.cat([x[..., 1:], torch.zeros_like(x[..., :1])], dim=-1)


def layer_index(x):
    """0..L-1 along x's last axis, int32 on x's device, shape (L,)."""
    return torch.arange(x.shape[-1], dtype=torch.int32, device=x.device)
