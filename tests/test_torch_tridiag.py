"""Port numerics against the JAX package on the CPU: the Thomas solve's
plain version (the arithmetic the CUDA kernel repeats) and the small-axis
select helpers.  Inputs come from numpy with a seed and go to both sides.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from noahmp_tpu.numerics import select as jsel
from noahmp_tpu.numerics.tridiag import (thomas as jthomas,
                                         masked_identity_rows as jmask)
from noahmp_tpu.pallas.tridiag import thomas_pallas

from noahmp_tpu_torch.kernels.tridiag import thomas_plain
from noahmp_tpu_torch.numerics import select as tsel
from noahmp_tpu_torch.numerics.tridiag import thomas, masked_identity_rows


def _system(seed, n, rows):
    rng = np.random.default_rng(seed)
    b = rng.uniform(1.5, 3.0, (n, rows)).astype(np.float32)
    a = rng.uniform(-0.5, 0.5, (n, rows)).astype(np.float32)
    c = rng.uniform(-0.5, 0.5, (n, rows)).astype(np.float32)
    d = rng.uniform(-1.0, 1.0, (n, rows)).astype(np.float32)
    return a, b, c, d


def _dense_solve(a, b, c, d):
    n, rows = a.shape
    mat = np.zeros((n, rows, rows), np.float64)
    for k in range(rows):
        mat[:, k, k] = b[:, k]
        if k > 0:
            mat[:, k, k - 1] = a[:, k]
        if k < rows - 1:
            mat[:, k, k + 1] = c[:, k]
    return np.linalg.solve(mat, d.astype(np.float64)[..., None])[..., 0]


def _torch(*arrs):
    return tuple(torch.from_numpy(x) for x in arrs)


def _scaled(ref, got):
    return float(np.max(np.abs(ref - got) / np.maximum(1.0, np.abs(ref))))


# same operation order in float32 on both sides: 1e-6 leaves room only
# for a last-bit difference in the division
SAME_ORDER_BAR = 1.0e-6
# float32 recurrence against a float64 dense solve of a well-conditioned
# (diagonally dominant) system
DENSE_BAR = 1.0e-4


@pytest.mark.parametrize("rows", [4, 7])
@pytest.mark.parametrize("n", [512, 700, 1])
def test_thomas_plain_matches_jax(rows, n):
    sysm = _system(rows * 1000 + n, n, rows)
    x = thomas_plain(*_torch(*sysm)).numpy()
    x_jax = np.asarray(jthomas(*map(jnp.asarray, sysm)))
    assert x.dtype == np.float32 and x.shape == (n, rows)
    assert _scaled(x_jax, x) <= SAME_ORDER_BAR


@pytest.mark.parametrize("rows", [4, 7])
def test_thomas_plain_matches_pallas_interpret(rows):
    """Ragged n (700 is not a multiple of the TPU kernel's block): the
    TPU kernel pads with identity rows, the port needs no padding."""
    sysm = _system(rows, 700, rows)
    x = thomas_plain(*_torch(*sysm)).numpy()
    x_pl = np.asarray(thomas_pallas(*map(jnp.asarray, sysm), block=512,
                                    interpret=True))
    assert _scaled(x_pl, x) <= SAME_ORDER_BAR


@pytest.mark.parametrize("rows", [4, 7])
def test_thomas_plain_matches_dense_solve(rows):
    sysm = _system(10 + rows, 300, rows)
    x = thomas_plain(*_torch(*sysm)).numpy()
    assert _scaled(_dense_solve(*sysm), x) <= DENSE_BAR


def test_thomas_identity_rows():
    """Variable-top systems: inactive slots become identity rows on both
    sides and solve to exactly zero; active rows agree."""
    n, rows = 256, 7
    a, b, c, d = _system(3, n, rows)
    rng = np.random.default_rng(4)
    top = rng.integers(0, 4, n)
    active = np.arange(rows)[None, :] >= top[:, None]
    a[np.arange(n), top] = 0.0     # the first active row has no sub-diagonal
    ta, tb, tc, td = masked_identity_rows(torch.from_numpy(active),
                                          *_torch(a, b, c, d))
    ja, jb, jc, jd = jmask(jnp.asarray(active),
                           *map(jnp.asarray, (a, b, c, d)))
    for t, j in ((ta, ja), (tb, jb), (tc, jc), (td, jd)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    x = thomas(ta, tb, tc, td).numpy()    # CPU tensors: the plain version
    x_jax = np.asarray(jthomas(ja, jb, jc, jd))
    assert np.all(x[~active] == 0.0)
    assert _scaled(x_jax, x) <= SAME_ORDER_BAR


def test_thomas_ignores_unused_corners():
    a, b, c, d = _system(5, 64, 4)
    x0 = thomas_plain(*_torch(a, b, c, d)).numpy()
    a[:, 0] = 123.0
    c[:, -1] = -456.0
    x1 = thomas_plain(*_torch(a, b, c, d)).numpy()
    np.testing.assert_array_equal(x0, x1)


@pytest.mark.parametrize("length", [3, 4, 7, 12])
def test_select_helpers_exact(length):
    """vsel/vset/vadd/vperm/cumsum_small: bit-identical to the JAX
    helpers (one lane matches, so nothing is rounded differently)."""
    rng = np.random.default_rng(length)
    n = 33
    x = rng.normal(size=(n, length)).astype(np.float32)
    idx = rng.integers(0, length, n).astype(np.int32)
    val = rng.normal(size=n).astype(np.float32)
    perm = np.stack([rng.permutation(length) for _ in range(n)]
                    ).astype(np.int32)
    tx, tidx, tval, tperm = _torch(x, idx, val, perm)
    jx, jidx, jval, jperm = map(jnp.asarray, (x, idx, val, perm))
    import jax
    pairs = [
        (tsel.vsel(tx, tidx), jax.vmap(jsel.vsel)(jx, jidx)),
        (tsel.vset(tx, tidx, tval), jax.vmap(jsel.vset)(jx, jidx, jval)),
        (tsel.vadd(tx, tidx, tval), jax.vmap(jsel.vadd)(jx, jidx, jval)),
        (tsel.vperm(tx, tperm), jax.vmap(jsel.vperm)(jx, jperm)),
        (tsel.cumsum_small(tx), jax.vmap(jsel.cumsum_small)(jx)),
    ]
    for got, ref in pairs:
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    # and against plain numpy indexing
    np.testing.assert_array_equal(tsel.vsel(tx, tidx).numpy(),
                                  x[np.arange(n), idx])
    np.testing.assert_array_equal(
        tsel.vperm(tx, tperm).numpy(),
        np.take_along_axis(x, perm.astype(np.int64), axis=1))
