"""The port's table loader and converters against the JAX package's
loader: exact, leaf by leaf."""

import numpy as np
import pytest
import torch

from noahmp_tpu.params import load_params as jax_load_params
from noahmp_tpu.params import VEG_SCHEMES, SOIL_SCHEMES

from noahmp_tpu_torch import convert
from noahmp_tpu_torch.params import load_params
from noahmp_tpu_torch.state import (State, Static, Forcing, Flux,
                                    init_state, init_static)
from noahmp_tpu import state as jstate


def _assert_tables_equal(got, ref):
    for part in ("veg", "soil", "gen"):
        g, r = getattr(got, part)._asdict(), getattr(ref, part)._asdict()
        assert list(g) == list(r)
        for name in r:
            gv, rv = g[name].numpy(), r[name].numpy()
            assert gv.dtype == rv.dtype, (part, name)
            np.testing.assert_array_equal(gv, rv, err_msg=f"{part}.{name}")


@pytest.mark.parametrize("soil_scheme", SOIL_SCHEMES)
@pytest.mark.parametrize("veg_scheme", VEG_SCHEMES)
@pytest.mark.parametrize("frzx_compat", [True, False])
def test_load_params_equals_jax_loader(veg_scheme, soil_scheme,
                                       frzx_compat):
    jp = jax_load_params(veg_scheme, soil_scheme, frzx_compat=frzx_compat,
                         to_device=False)
    ref = convert.params_from_numpy(jp.veg._asdict(), jp.soil._asdict(),
                                    jp.gen._asdict(), device="cpu")
    got = load_params(veg_scheme, soil_scheme, frzx_compat=frzx_compat,
                      device="cpu")
    _assert_tables_equal(got, ref)
    # field order and dtypes follow the JAX NamedTuples
    assert list(got.veg._asdict()) == list(jp.veg._fields)
    for name, leaf in got.gen._asdict().items():
        assert leaf.dtype == torch.float32, name
    assert got.veg.nroot.dtype == torch.int32
    # zero row at index 0, so 1-based classes index directly
    assert float(got.veg.hvt[0]) == 0.0 and float(got.soil.bexp[0]) == 0.0


def test_frzx_compat_quirk():
    """FRZX keeps the reference's 0.412/0468 integer-literal factor by
    default; frzx_compat=False gives the classic-Noah 0.412/0.468."""
    quirk = load_params(device="cpu").soil.frzx.numpy()
    fixed = load_params(frzx_compat=False, device="cpu").soil.frzx.numpy()
    ok = np.isfinite(quirk) & (quirk != 0)
    np.testing.assert_allclose(fixed[ok] / quirk[ok], 1000.0, rtol=1e-5)


def test_params_reject_float64():
    jp = jax_load_params(to_device=False)
    gen = dict(jp.gen._asdict())
    gen["csoil"] = np.float64(gen["csoil"])
    with pytest.raises(TypeError):
        convert.params_from_numpy(jp.veg._asdict(), jp.soil._asdict(), gen,
                                  device="cpu")


@pytest.mark.parametrize("cls", [State, Static, Forcing, Flux])
def test_containers_mirror_jax_fields(cls):
    assert cls._fields == getattr(jstate, cls.__name__)._fields


def test_init_and_convert_round_trip():
    n = 5
    js, jst = jstate.init_state(n, sneqv=3.0), jstate.init_static(n, lutyp=9)
    ts = init_state(n, device="cpu", sneqv=3.0)
    tst = init_static(n, device="cpu", lutyp=9)
    for jt, tt in ((js, ts), (jst, tst)):
        back = convert.tree_to_numpy(tt)
        for name in jt._fields:
            ref = np.asarray(getattr(jt, name))
            assert back[name].dtype == ref.dtype, name
            np.testing.assert_array_equal(back[name], ref, err_msg=name)
    again = convert.tree_from_numpy(State, convert.tree_to_numpy(ts), "cpu")
    for a, b in zip(again, ts):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert again.nsnow.dtype == torch.int32
