"""Dynamic-vegetation carbon (opt_veg 2 and 5) of the port against the
JAX package on the CPU: ``co2flux``, ``carbon`` and ``bvocflux`` module
by module (the JAX functions vmapped over seeded points), the whole step
on the four regimes, the fused step's plain version and the host build
of the kernels' headers against the plain step, and a free run.

Bars.  Module by module: pools, LAI and SAI within 2e-5 of the leaf's
largest magnitude, the fluxes within 1e-4 of theirs.  In the step: every
leaf within the step's bars (cases.py), and, because those are blind to
values of 1e-6, ``gpp``/``npp``/``nee`` and the six pools' change over
the step within ``cases.CARBON_BAR`` of the leaf's largest magnitude
(``cases.carbon_ratios``).
"""


import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from noahmp_tpu import state as jstate
from noahmp_tpu.driver.step import make_step as jax_make_step
from noahmp_tpu.options import Options as JOptions
from noahmp_tpu.params import load_params as jax_load_params
from noahmp_tpu.physics import carbon as jcarbon

from noahmp_tpu_torch import Options, load_params, make_fused_step, make_step
from noahmp_tpu_torch.cases import (CARBON_FLUXES, CARBON_POOLS, REGIMES,
                                    carbon_ratio, carbon_ratios, hetero_case,
                                    to_device, uniform_case)
from noahmp_tpu_torch.convert import tree_to_numpy
from noahmp_tpu_torch.kernels import column
from noahmp_tpu_torch.params.gathered import gather_params
from noahmp_tpu_torch.physics import carbon as tcarbon

from test_torch_column_host import host_lib, host_step  # noqa: F401
from test_torch_step import assert_residuals, assert_step_close

DT = 900.0
SEED = 0
N = 64
POOL_TOL = 2.0e-5       # of the leaf's largest magnitude
FLUX_TOL = 1.0e-4
VEG_OPTIONS = {"veg2": dict(veg=2, crs=1), "veg5": dict(veg=5)}
ZSOIL = np.array([-0.1, -0.4, -1.0, -2.0], np.float32)
NONVEG = (1, 16, 19, 24)     # urban, water, barren, ice


def module_inputs():
    """64 seeded points: every land-use class 1..27, and among them
    points without wood, with a root pool below zero (the reset),
    with a canopy colder than TMIN, outside the growing season and with
    closed stomata."""
    rng = np.random.default_rng(SEED)
    f32 = np.float32

    def u(lo, hi, shape=(N,)):
        return rng.uniform(lo, hi, shape).astype(f32)

    x = dict(
        lutyp=(np.arange(N) % 27 + 1).astype(np.int32),
        smcmax=u(0.33, 0.48), tv=u(262.0, 312.0), tg=u(262.0, 312.0),
        psn=u(0.0, 25.0), foln=u(0.3, 1.2), btran=u(0.0, 1.0),
        apar=u(0.0, 200.0), fveg=u(0.0, 1.0),
        igs=rng.integers(0, 2, N).astype(f32), troot=u(270.0, 295.0),
        ist=np.ones(N, np.int32), lai=u(0.05, 6.0), sai=u(0.01, 1.0),
        lfmass=u(0.5, 250.0), rtmass=u(50.0, 600.0), stmass=u(3.0, 120.0),
        wood=u(10.0, 900.0), stblcp=u(500.0, 1500.0),
        fastcp=u(200.0, 1500.0),
        zsoil=np.tile(ZSOIL, (N, 1)),
        stc=u(265.0, 300.0, (N, 7)), smc=u(0.05, 0.45, (N, 4)))
    x["dzsoil"] = np.tile(np.array([0.1, 0.3, 0.6, 1.0], f32), (N, 1))
    x["wood"][5::7] = 0.0
    # root respiration and turnover scale with the pool and cannot empty
    # it; only a pool that arrives below zero takes the reset
    x["rtmass"][3::9] = -0.5
    x["tv"][2::11] = 255.0              # colder than every TMIN
    x["igs"][2::11] = 0.0
    x["btran"][4::13] = 0.0
    return x


ORDER = ("smcmax", "zsoil", "dzsoil", "stc", "smc", "tv", "tg", "psn", "foln",
         "btran", "apar", "fveg", "igs", "troot", "ist", "lai", "sai",
         "lfmass", "rtmass", "stmass", "wood", "stblcp", "fastcp")


def jax_carbon(x):
    veg = jax_load_params().veg
    dt = jnp.float32(DT)

    def one(lutyp, *a):
        a = dict(zip(ORDER, a))
        return jcarbon.carbon(veg, lutyp, a["smcmax"], dt, *[
            a[k] for k in ORDER[1:]])

    out = jax.vmap(one)(jnp.asarray(x["lutyp"]),
                        *[jnp.asarray(x[k]) for k in ORDER])
    return {k: np.asarray(v) for k, v in out._asdict().items()}


def torch_carbon(x):
    veg = load_params(device="cpu").veg
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    out = tcarbon.carbon(veg, t["lutyp"].long(), t["smcmax"],
                         torch.tensor(DT), *[t[k] for k in ORDER[1:]])
    return {k: v.numpy() for k, v in out._asdict().items()}


def assert_outputs_close(ref, got):
    assert list(ref) == list(got) == list(tcarbon.CarbonOut._fields)
    for name, r in ref.items():
        g = got[name]
        assert g.dtype == np.float32 and g.shape == r.shape, name
        tol = FLUX_TOL if name in ("gpp", "npp", "nee", "autors",
                                   "heters") else POOL_TOL
        finite = np.isfinite(r)
        np.testing.assert_array_equal(np.isnan(g), np.isnan(r), err_msg=name)
        np.testing.assert_array_equal(g[~finite & ~np.isnan(r)],
                                      r[~finite & ~np.isnan(r)], err_msg=name)
        allowed = tol * np.abs(r[finite]).max()
        assert np.abs(g[finite] - r[finite]).max() <= allowed, name


def test_carbon_matches_jax_on_every_class():
    x = module_inputs()
    ref, got = jax_carbon(x), torch_carbon(x)
    assert_outputs_close(ref, got)
    # the cases the inputs were built to reach
    assert set(x["lutyp"].tolist()) == set(range(1, 28))
    gated = np.isin(x["lutyp"], NONVEG)
    for name, leaf in got.items():
        assert (leaf[gated] == 0.0).all(), name       # LAI and SAI too
    grows = ~gated & np.isfinite(got["lai"])
    assert (got["rtmass"][grows & (x["rtmass"] < 0.0)] == 0.0).all()
    assert (got["wood"][x["wood"] == 0.0] == 0.0).all()
    assert (got["lai"][grows] >= 0.05).all() and (got["sai"][grows]
                                                  >= 0.01).all()
    # sla = 0 without the gate (classes 26 and 27): inf and NaN as upstream
    assert not np.isfinite(got["lfmass"][~gated]).all()


def test_co2flux_matches_jax():
    """``co2flux`` alone, ungated, on the same points: the respiration
    and allocation terms that the gate would hide on four classes."""
    x = module_inputs()
    rng = np.random.default_rng(SEED + 1)
    wroot = rng.uniform(0.0, 1.0, N).astype(np.float32)
    lapm = rng.uniform(0.02, 0.09, N).astype(np.float32)
    names = ("igs", "stc1", "psn", "troot", "tv", "wroot", "wstres", "foln",
             "lapm", "lai", "sai", "lfmass", "rtmass", "stmass", "fastcp",
             "stblcp", "wood")
    vals = dict(x, stc1=x["stc"][:, 3], wroot=wroot, lapm=lapm,
                wstres=1.0 - x["btran"])
    jveg = jax_load_params().veg
    ref = jax.vmap(lambda lutyp, igs, *a: jcarbon.co2flux(
        jveg, lutyp, igs, jnp.float32(DT), *a))(
            jnp.asarray(x["lutyp"]), *[jnp.asarray(vals[k]) for k in names])
    t = {k: torch.from_numpy(np.ascontiguousarray(vals[k])) for k in names}
    got = tcarbon.co2flux(load_params(device="cpu").veg,
                          torch.from_numpy(x["lutyp"]).long(), t["igs"],
                          torch.tensor(DT), *[t[k] for k in names[1:]])
    assert_outputs_close({k: np.asarray(v) for k, v in ref._asdict().items()},
                         {k: v.numpy() for k, v in got._asdict().items()})
    neg = x["rtmass"] < 0.0
    assert neg.any() and (got.rtmass.numpy()[neg] == 0.0).all()
    # the reset hands this step's root production to the turnover BEFORE
    # the fast pool takes the turnover up: some 1e-2 g m-2 of fastcp,
    # seen on the scale of the pool's change and not of the pool
    change = {k: (np.asarray(getattr(ref, k)) - x[k],
                  getattr(got, k).numpy() - x[k]) for k in CARBON_POOLS}
    for k, (r, g) in change.items():
        top = float(np.abs(x[k]).max())
        assert carbon_ratio(r[neg], g[neg], floor=float(
            np.spacing(np.float32(top)))) <= 1.0, k
    assert np.abs(change["fastcp"][0][neg]).max() > 1.0e-2
    assert (got.gpp.numpy() == (x["psn"] * np.float32(12.0e-6))).all()


def test_bvocflux_matches_jax():
    x = module_inputs()
    jveg = jax_load_params().veg
    ref = jax.vmap(lambda *a: jcarbon.bvocflux(jveg, *a))(
        *[jnp.asarray(x[k]) for k in ("lutyp", "fveg", "apar", "tv")])
    got = tcarbon.bvocflux(load_params(device="cpu").veg,
                           torch.from_numpy(x["lutyp"]).long(),
                           *[torch.from_numpy(x[k])
                             for k in ("fveg", "apar", "tv")])
    assert tuple(got.shape) == (N, 5)
    ref = np.asarray(ref)
    np.testing.assert_allclose(got.numpy(), ref, rtol=2.0e-5,
                               atol=2.0e-5 * np.abs(ref).max())


@pytest.fixture(scope="module")
def jax_steps():
    """{option set: step} of the JAX package, each compiled once."""
    params = jax_load_params()
    return {key: jax_make_step(params, JOptions(**kw), DT, donate=False)
            for key, kw in VEG_OPTIONS.items()}


def jax_step(step, case):
    static, forcing, state = case
    s, f = step(jstate.Static(**static), jstate.Forcing(**forcing),
                jstate.State(**state))
    return ({k: np.asarray(v) for k, v in s._asdict().items()},
            {k: np.asarray(v) for k, v in f._asdict().items()})


def torch_step(case, opts, fused=False):
    static, forcing, state = to_device(case, "cpu")
    params = load_params(device="cpu")
    step = (make_fused_step(params, opts, DT, static, device="cpu") if fused
            else make_step(params, opts, DT, device="cpu"))
    s, f = step(static, forcing, state)
    return tree_to_numpy(s), tree_to_numpy(f)


def assert_carbon_close(old_state, ref, got):
    for name, ratio in carbon_ratios(old_state, ref, got).items():
        assert ratio <= 1.0, f"{name}: {ratio:.3g} x the carbon bar"


@pytest.mark.parametrize("regime", sorted(REGIMES))
@pytest.mark.parametrize("key", sorted(VEG_OPTIONS))
def test_carbon_step_matches_jax(jax_steps, key, regime):
    """Every State and Flux leaf of one step, eager and through the
    fused step's plain version, and the carbon leaves on their own
    scale."""
    case = hetero_case(regime)
    ref = jax_step(jax_steps[key], case)
    for fused in (False, True):
        got = torch_step(case, Options(**VEG_OPTIONS[key]), fused)
        assert_step_close(ref, got)
        assert_carbon_close(case[2], ref, got)
        assert_residuals(case[0], got[1])
    gated = np.isin(case[0]["lutyp"], NONVEG)
    for name in CARBON_POOLS + CARBON_FLUXES + ("lai", "sai"):
        leaf = got[0][name] if name in got[0] else got[1][name]
        assert (leaf[gated] == 0.0).all(), name
    assert (got[0]["lai"][~gated] >= 0.05).all()
    assert np.abs(ref[1]["nee"]).max() > 0.0
    if regime in ("warm_day", "hot_dry"):
        assert got[1]["gpp"].max() > 1.0e-6       # the sun is up


def test_carbon_ratio_sees_what_the_step_bars_miss():
    """A flux of 1e-5 that is off by a tenth passes the step's bar and
    fails the carbon bar; one ulp of a pool does not fail it."""
    ref = np.array([1.0e-5, 2.0e-5], np.float32)
    assert carbon_ratio(ref, ref * np.float32(1.1)) > 100.0
    assert carbon_ratio(ref, ref) == 0.0
    assert carbon_ratio(ref, ref[:1]) == float("inf")
    old = {k: np.full(2, 500.0, np.float32) for k in CARBON_POOLS}
    new = {k: v + np.float32(1.0e-3) for k, v in old.items()}
    flux = {k: ref for k in CARBON_FLUXES}
    ulp = {k: np.nextafter(v, np.float32(1e9)) for k, v in new.items()}
    assert max(carbon_ratios(old, (new, flux), (ulp, flux)).values()) <= 1.0
    off = {k: v + np.float32(5.0e-4) for k, v in new.items()}
    assert min(carbon_ratios(old, (new, flux), (off, flux))[k]
               for k in CARBON_POOLS) > 1.0


def test_dynamic_vegetation_free_run():
    """30 free-running steps with opt_veg = 2 (the JAX package's own
    conservation test): pools stay non-negative, LAI is prognosed from
    leaf mass, the budgets close."""
    case = uniform_case(4)
    case[0]["lutyp"][:] = 11
    case[0]["sltyp"][:] = 8
    case[1]["prcp"][:] = 0.0005
    static, forcing, state = to_device(case, "cpu")
    step = make_step(load_params(device="cpu"), Options(veg=2, crs=1), DT,
                     device="cpu")
    lai0 = state.lai.clone()
    for _ in range(30):
        state, flux = step(static, forcing, state)
    s, f = tree_to_numpy(state), tree_to_numpy(flux)
    for name in CARBON_POOLS:
        assert (s[name] >= 0.0).all(), name
    assert (s["lai"] >= 0.05).all() and (s["sai"] >= 0.01).all()
    assert not np.array_equal(s["lai"], lai0.numpy())
    assert np.isfinite(f["gpp"]).all() and np.isfinite(f["nee"]).all()
    assert_residuals(case[0], f)
    np.testing.assert_array_equal(
        s["lai"], np.maximum(s["lfmass"] * (np.float32(80.0) / 1000.0),
                             np.float32(0.05)).astype(np.float32))


@pytest.mark.parametrize("name", ["uniform"] + sorted(REGIMES))
@pytest.mark.parametrize("key", sorted(VEG_OPTIONS))
def test_host_build_of_carbon_matches_plain_step(host_lib, key, name):
    """The kernels' headers, built for the host, against ``column_plain``
    over four steps along the plain trajectory: the carbon leaves on
    their own scale (the step's bars on all 97 leaves are held by
    test_torch_column_host.py for both option values)."""
    opts = Options(**VEG_OPTIONS[key])
    case = uniform_case(8) if name == "uniform" else hetero_case(name, 8)
    static, forcing, state = to_device(case, "cpu")
    params = load_params(device="cpu")
    g = gather_params(params, static.lutyp, static.sltyp, static.isc,
                      static.slptyp)
    plan = column.ColumnPlan(g, opts, DT, static, need_cuda=False)
    assert plan.consts.cls[-1] == int(params.veg.isegblf) == 13
    gated = np.isin(case[0]["lutyp"], NONVEG)
    for _ in range(4):
        with torch.no_grad():
            ref = column.column_plain(g, opts, static, forcing, state,
                                      torch.tensor(DT))
        got = host_step(host_lib, plan, forcing, state)
        ref_np = tuple(tree_to_numpy(t) for t in ref)
        got_np = tuple(tree_to_numpy(t) for t in got)
        assert_carbon_close(tree_to_numpy(state), ref_np, got_np)
        for leaf in ("lai", "sai"):
            np.testing.assert_allclose(got_np[0][leaf], ref_np[0][leaf],
                                       rtol=POOL_TOL, err_msg=leaf)
            assert (got_np[0][leaf][gated] == 0.0).all()
        state = ref[0]


def test_host_build_without_carbon_passes_the_pools_through(host_lib):
    """Default options: the six pools come out as the very bits that
    went in, and the carbon fluxes are zero."""
    static, forcing, state = to_device(hetero_case("warm_day", 8), "cpu")
    g = gather_params(load_params(device="cpu"), static.lutyp, static.sltyp,
                      static.isc, static.slptyp)
    plan = column.ColumnPlan(g, Options(), DT, static, need_cuda=False)
    new_state, flux = host_step(host_lib, plan, forcing, state)
    for name in CARBON_POOLS:
        assert torch.equal(getattr(new_state, name), getattr(state, name))
    for name in CARBON_FLUXES:
        assert (getattr(flux, name) == 0.0).all()
