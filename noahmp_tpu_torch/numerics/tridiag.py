"""Tridiagonal (Thomas) solve along the last axis.

Counterpart of ``noahmp_tpu/numerics/tridiag.py``.  The reference's
rosr12 (core/module_noahmp_func.f90:4240-4288) solves a <=7-row system
per column with a variable top index.  Here the solve runs over a fixed
number of rows (4 or 7); variable-top systems pass identity rows
(a=c=0, b=1, d=0) for inactive slots, and because the first active row
has a=0 the forward elimination never mixes inactive rows into active
ones.

``thomas`` dispatches on where the tensors live: a CUDA tensor goes to
the hand-written kernel, a CPU tensor to the plain version.  There is no
switch that turns the kernel off and no fallback if it fails.
"""

import torch

from ..kernels.tridiag import thomas_cuda, thomas_plain


def thomas(a, b, c, d):
    """Solve the (n, L) tridiagonal systems.  a: sub-diagonal (a[...,0]
    ignored), b: diagonal, c: super-diagonal (c[...,L-1] ignored), d:
    right-hand side.  Returns x."""
    if a.is_cuda:
        return thomas_cuda(a.contiguous(), b.contiguous(),
                           c.contiguous(), d.contiguous())
    return thomas_plain(a, b, c, d)


def masked_identity_rows(active, a, b, c, d):
    """Replace rows where ``active`` is False with identity rows so a
    variable-top system can run through the fixed-size solve."""
    a = torch.where(active, a, 0.0)
    b = torch.where(active, b, 1.0)
    c = torch.where(active, c, 0.0)
    d = torch.where(active, d, 0.0)
    return a, b, c, d
