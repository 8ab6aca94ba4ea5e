"""Batched Thomas solve: the CUDA kernel's wrapper beside its plain
PyTorch version.

Replaces the TPU kernel ``noahmp_tpu/pallas/tridiag.py:thomas_pallas``
(``_thomas_kernel``): n independent L-row tridiagonal systems, L = 4
(soil moisture) or 7 (snow/soil heat), coefficients batch-major (n, L)
float32.

Bound on an H100: bytes.  The solve reads a, b, c, d and writes x once,
5*n*L*4 bytes (9.2 MB at n = 65,536, L = 7; 2.7 us at 3.35 TB/s),
against 3 divisions and ~8 multiply-adds a row, far under one operation
a byte.  The design therefore moves each byte once and nothing else:
one thread per system, ``template <int L>`` with the whole system in
registers, the grid masks ``i < n`` itself (no identity-row padding, no
copy of the inputs, which the TPU kernel needs for its 1024-point
blocks), and for L = 4 a row is one 16-byte ``float4`` load and store.
L = 7 rows are 28 bytes and unaligned, so they load as scalars;
neighbouring threads still cover one contiguous span.  Staging a block's
L = 7 rows through shared memory in 16-byte pieces was measured beside
this and was no faster at 65,536 systems (``csrc/tridiag.cu``).  At that
size the launch itself is a large part of the kernel's 5-6 us;
``chip_smoke.py`` times an empty kernel of the same grid beside it, and
both L at 1,048,576 systems, where the byte bound is the honest
yardstick.  The recurrence is a ``__device__`` function on
register arrays (csrc/tridiag.cuh) that the fused column kernels call
too.  The file is compiled with ``--fmad=false``: the plain version
rounds ``a*p`` before adding ``b``, and so does the kernel.
"""

import ctypes

import torch

from ._build import load_library

_ROWS = (4, 7)


def thomas_plain(a, b, c, d):
    """Unrolled Thomas solve along the last axis, any leading shape.
    Same operation order as ``noahmp_tpu.numerics.tridiag.thomas``."""
    n = a.shape[-1]
    p = [None] * n
    q = [None] * n
    p[0] = -c[..., 0] / b[..., 0]
    q[0] = d[..., 0] / b[..., 0]
    for k in range(1, n):
        denom = b[..., k] + a[..., k] * p[k - 1]
        p[k] = -c[..., k] / denom
        q[k] = (d[..., k] - a[..., k] * q[k - 1]) / denom
    x = [None] * n
    x[n - 1] = q[n - 1]
    for k in range(n - 2, -1, -1):
        x[k] = p[k] * x[k + 1] + q[k]
    return torch.stack(x, dim=-1)


def _launcher(rows):
    lib = load_library("tridiag")
    fn = getattr(lib, f"noahmp_thomas_l{rows}")
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int64,
                                               ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def thomas_cuda(a, b, c, d):
    """Solve (n, L) float32 systems on the card with the hand-written
    kernel.  Takes contiguous CUDA tensors with L in {4, 7} (16-byte
    aligned for L = 4) and raises on anything else; launches on the current stream, does not
    synchronise."""
    for name, t in (("a", a), ("b", b), ("c", c), ("d", d)):
        if not t.is_cuda:
            raise ValueError(f"thomas_cuda: {name} is on {t.device}, "
                             "needs a CUDA tensor")
        if t.dtype != torch.float32:
            raise TypeError(f"thomas_cuda: {name} is {t.dtype}, "
                            "needs float32")
        if t.shape != a.shape or t.device != a.device:
            raise ValueError(f"thomas_cuda: {name} has shape "
                             f"{tuple(t.shape)} on {t.device}, a has "
                             f"{tuple(a.shape)} on {a.device}")
        if not t.is_contiguous():
            raise ValueError(f"thomas_cuda: {name} is not contiguous")
    if a.dim() != 2 or a.shape[1] not in _ROWS:
        raise ValueError(f"thomas_cuda: shape {tuple(a.shape)}, needs "
                         f"(n, L) with L in {_ROWS}")
    n, rows = a.shape
    if rows == 4 and any(t.data_ptr() % 16 for t in (a, b, c, d)):
        raise ValueError("thomas_cuda: an L = 4 input does not start on a "
                         "16-byte boundary (rows move as float4)")
    x = torch.empty_like(a)
    if n == 0:
        return x
    fn = _launcher(rows)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(a.data_ptr(), b.data_ptr(), c.data_ptr(), d.data_ptr(),
                 x.data_ptr(), n, stream)
    thomas_cuda.launches += 1
    thomas_cuda.launches_by_rows[rows] += 1
    if err != 0:
        raise RuntimeError(f"thomas_cuda: launch failed, CUDA error {err}")
    return x


thomas_cuda.launches = 0
thomas_cuda.launches_by_rows = {rows: 0 for rows in _ROWS}


def reset_launches():
    thomas_cuda.launches = 0
    for rows in _ROWS:
        thomas_cuda.launches_by_rows[rows] = 0
