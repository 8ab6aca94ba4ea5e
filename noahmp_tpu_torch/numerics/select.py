"""Selects over the tiny layer axes (3 snow slots, 4 soil layers, 12
months) with one integer index per land point.

Counterpart of ``noahmp_tpu/numerics/select.py``.  The index is
in-bounds, so exactly one lane matches and every helper is bit-identical
to the gather/scatter it stands for.  They are written as unrolled
``torch.where`` chains over the last axis: no index tensor is widened to
int64 and nothing synchronises with the host.
"""

import torch


def vsel(x, idx):
    """x[i, idx[i]] over the last axis; ``idx`` has x's leading shape."""
    acc = x[..., 0]
    for k in range(1, x.shape[-1]):
        acc = torch.where(idx == k, x[..., k], acc)
    return acc


def vset(x, idx, val):
    """Copy of x with x[i, idx[i]] = val[i]."""
    return torch.stack([torch.where(idx == k, val, x[..., k])
                        for k in range(x.shape[-1])], dim=-1)


def vadd(x, idx, val):
    """Copy of x with x[i, idx[i]] += val[i]."""
    return torch.stack([torch.where(idx == k, x[..., k] + val, x[..., k])
                        for k in range(x.shape[-1])], dim=-1)


def cumsum_small(x):
    """Prefix sum over the tiny last axis with strict left-to-right
    adds.  ``torch.cumsum`` may reassociate on the device; the layer
    depths must not depend on that."""
    outs = []
    acc = None
    for k in range(x.shape[-1]):
        acc = x[..., k] if acc is None else acc + x[..., k]
        outs.append(acc)
    return torch.stack(outs, dim=-1)


def vperm(x, idxvec):
    """x[i, idxvec[i, :]]: a per-point permutation of the last axis."""
    return torch.stack([vsel(x, idxvec[..., i])
                        for i in range(x.shape[-1])], dim=-1)
