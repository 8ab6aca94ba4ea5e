"""The port's ``gather_params`` against the JAX package's: the same
numpy class indices through both, every gathered field equal bit for
bit, and the port's field order equal to the list the kernel header
declares."""

import numpy as np
import pytest
import torch

from noahmp_tpu.params import load_params as jax_load_params
from noahmp_tpu.params.gathered import (PreGathered,
                                        gather_params as jax_gather_params)

from noahmp_tpu_torch import load_params
from noahmp_tpu_torch.kernels.column import header_layout
from noahmp_tpu_torch.params.gathered import (CLASS_SCALARS, GATHERED_FIELDS,
                                              GEN_BY_SLP, GEN_SCALARS,
                                              SOIL_BY_ISC, SOIL_BY_SLTYP,
                                              VEG_BY_LUTYP, gather_params)

SEED = 0
N = 64


@pytest.fixture(scope="module")
def gathered_pair():
    rng = np.random.default_rng(SEED)
    lutyp = rng.integers(1, 28, N).astype(np.int32)
    sltyp = rng.integers(1, 20, N).astype(np.int32)
    isc = rng.integers(1, 9, N).astype(np.int32)
    slptyp = rng.integers(1, 10, N).astype(np.int32)
    jg = jax_gather_params(jax_load_params(), lutyp, sltyp, isc, slptyp)
    tg = gather_params(load_params(device="cpu"),
                       *(torch.from_numpy(x) for x in (lutyp, sltyp, isc,
                                                       slptyp)))
    return jg, tg


def _jax_leaf(jg, name):
    for tree in (jg.veg, jg.soil, jg.gen):
        if hasattr(tree, name):
            return getattr(tree, name)
    raise KeyError(name)


@pytest.mark.parametrize("name", GATHERED_FIELDS)
def test_gathered_field_equal_bit_for_bit(gathered_pair, name):
    jg, tg = gathered_pair
    leaf = _jax_leaf(jg, name)
    assert isinstance(leaf, PreGathered)
    ref = np.asarray(leaf.v)
    got = tg.fields[name].numpy()
    assert got.dtype == ref.dtype and got.shape == ref.shape
    assert got.shape[0] == N
    np.testing.assert_array_equal(got, ref)
    assert tg.fields[name].is_contiguous()


def test_every_pregathered_jax_field_is_gathered(gathered_pair):
    """The port gathers exactly the fields the JAX package wraps."""
    jg, _tg = gathered_pair
    wrapped = [f for tree in (jg.veg, jg.soil, jg.gen) for f in tree._fields
               if isinstance(getattr(tree, f), PreGathered)]
    assert sorted(wrapped) == sorted(GATHERED_FIELDS)
    assert len(set(GATHERED_FIELDS)) == len(GATHERED_FIELDS)
    assert GATHERED_FIELDS == (VEG_BY_LUTYP + SOIL_BY_SLTYP + SOIL_BY_ISC
                               + GEN_BY_SLP)


def test_field_order_is_the_kernel_headers(gathered_pair):
    _jg, tg = gathered_pair
    head = header_layout()
    assert tuple(tg.fields) == tuple(n for n, _d, _w in head["PARAM"])
    for name, dtype, width in head["PARAM"]:
        t = tg.fields[name]
        assert t.dtype == dtype, name
        assert tuple(t.shape) == ((N,) if width == 1 else (N, width)), name
    assert head["CLASS"] == CLASS_SCALARS
    assert head["GEN"] == GEN_SCALARS


def test_scalars_and_plain_view(gathered_pair):
    """Table scalars come out as Python numbers in the header's order;
    the Params-shaped view answers any index with the gathered value and
    passes scalars through."""
    jg, tg = gathered_pair
    assert tg.class_scalars() == [int(getattr(jg.veg, n))
                                  for n in CLASS_SCALARS]
    gen = tg.gen_scalars()
    assert len(gen) == len(GEN_SCALARS)
    assert gen[GEN_SCALARS.index("csoil")] == float(jg.gen.csoil)
    assert gen[GEN_SCALARS.index("omegas_nir")] == float(jg.gen.omegas[1])
    view = tg.as_params()
    idx = torch.zeros(N, dtype=torch.long)
    assert view.veg.hvt[idx] is tg.fields["hvt"]
    assert view.soil.albsat[idx] is tg.fields["albsat"]
    assert view.gen.slope[idx] is tg.fields["slope"]
    assert view.veg.isurban is tg.params.veg.isurban
    assert view.gen.csoil is tg.params.gen.csoil
