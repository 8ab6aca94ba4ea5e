"""Port physics modules against ``jax.vmap`` of the JAX functions, on the
CPU, module by module.  Inputs are made with numpy from a seed on a
heterogeneous 8-column block (forest, grass, urban, water, barren, ice,
cropland, shrub) and handed to both sides.

Bars are on the element-wise scale |ref - got| / max(1, |ref|):

* LOOP_FREE_BAR for modules without iteration: both sides run the same
  float32 operations in the same order, and differ only where exp, log
  and pow round the last bit differently in XLA's and PyTorch's CPU
  libraries (a few ulp, amplified by a handful of later operations).
* the full step's bars (cases.py) for ``energy`` and ``water``, which
  hold the Newton loops: a last-bit difference can move an iterate
  across a convergence threshold.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from noahmp_tpu.params import load_params as jload
from noahmp_tpu.options import Options as JOptions
from noahmp_tpu.physics import (atm as jatm, phenology as jphen,
                                thermo as jthermo, radiation as jrad,
                                soiltemp as jsoilt, soilwater as jsw,
                                water as jwater, energy as jenergy)

from noahmp_tpu_torch import Options, load_params
from noahmp_tpu_torch.cases import (FLUX_BAR, FLUX_CEILING, bar_ratio,
                                    scaled_err)
from noahmp_tpu_torch.physics import (atm as tatm, phenology as tphen,
                                      thermo as tthermo, radiation as trad,
                                      soiltemp as tsoilt, soilwater as tsw,
                                      water as twater, energy as tenergy)

LOOP_FREE_BAR = 1.0e-5
N = 8
DT = 900.0
LUTYP = np.array([7, 10, 1, 16, 19, 24, 2, 8], np.int32)
SLTYP = np.array([6, 4, 9, 14, 16, 12, 3, 7], np.int32)
IST = np.array([1, 1, 1, 2, 1, 1, 1, 1], np.int32)
ICE = np.array([0, 0, 0, 0, 0, 1, 0, 0], np.int32)
ISC = np.array([4, 2, 4, 4, 9, 4, 6, 4], np.int32)
ZSOIL = np.tile(np.array([-0.1, -0.4, -1.0, -2.0], np.float32), (N, 1))
DZ_SOIL = np.tile(np.array([0.1, 0.3, 0.6, 1.0], np.float32), (N, 1))


@pytest.fixture(scope="module")
def jp():
    return jload("USGS", "STAS")


@pytest.fixture(scope="module")
def tp():
    return load_params("USGS", "STAS", device="cpu")


def f32(x):
    return np.asarray(x, np.float32)


def T(x):
    """numpy -> torch; table indices widen to int64 as the step does."""
    return torch.from_numpy(np.ascontiguousarray(x))


def TL(x):
    return T(x).long()


def leaves(out):
    """Flatten NamedTuples, tuples and dicts of arrays to (path, array)."""
    if isinstance(out, dict):
        items = out.items()
    elif hasattr(out, "_fields"):
        items = zip(out._fields, out)
    elif isinstance(out, (tuple, list)):
        items = enumerate(out)
    else:
        arr = out.numpy() if torch.is_tensor(out) else np.asarray(out)
        return [("", arr)]
    flat = []
    for key, val in items:
        flat += [(f"{key}.{p}" if p else str(key), a)
                 for p, a in leaves(val)]
    return flat


def assert_close(ref, got, bar, ceiling=None):
    ref_l, got_l = leaves(ref), leaves(got)
    assert [p for p, _ in ref_l] == [p for p, _ in got_l]
    for (path, r), (_, g) in zip(ref_l, got_l):
        assert r.shape == g.shape, (path, r.shape, g.shape)
        if r.dtype.kind in "ib":
            np.testing.assert_array_equal(g, r, err_msg=path)
            continue
        assert r.dtype == np.float32 and g.dtype == np.float32, path
        if ceiling is None:
            err = scaled_err(r, g)
            assert err <= bar, f"{path}: scaled error {err} > {bar}"
        else:
            ratio = bar_ratio(r, g, bar, ceiling)
            assert ratio <= 1.0, f"{path}: {ratio} x the allowed error"


def snow_columns(seed, layers=None):
    """A consistent snow/soil column set: nsnow active layers per point
    (bottom-aligned 3-slot pack), depths, masses and temperatures."""
    rng = np.random.default_rng(seed)
    nsnow = (np.full(N, layers) if layers is not None
             else rng.integers(0, 4, N)).astype(np.int32)
    active = np.arange(3)[None, :] >= (3 - nsnow)[:, None]
    dzsnow = f32(np.where(active, rng.uniform(0.03, 0.15, (N, 3)), 0.0))
    snice = f32(dzsnow * rng.uniform(100.0, 300.0, (N, 3)))
    snliq = f32(dzsnow * rng.uniform(0.0, 20.0, (N, 3)))
    stc_snow = f32(np.where(active, rng.uniform(262.0, 273.0, (N, 3)), 0.0))
    stc = np.concatenate([stc_snow, f32(rng.uniform(268.0, 279.0, (N, 4)))],
                         axis=1)
    dzsnso = np.concatenate([dzsnow, DZ_SOIL], axis=1)
    full_active = np.arange(7)[None, :] >= (3 - nsnow)[:, None]
    zsnso = f32(np.where(full_active, -np.cumsum(dzsnso, axis=1,
                                                 dtype=np.float32), 0.0))
    bulk = f32(rng.uniform(0.0, 6.0, N))
    sneqv = f32(np.where(nsnow > 0, (snice + snliq).sum(1), bulk))
    snowh = f32(np.where(nsnow > 0, dzsnow.sum(1), bulk / 150.0))
    smc = f32(rng.uniform(0.15, 0.40, (N, 4)))
    frozen = stc[:, 3:] < 273.15
    swc = f32(np.where(frozen, smc * rng.uniform(0.4, 0.95, (N, 4)), smc))
    return dict(nsnow=nsnow, dzsnow=dzsnow, snice=snice, snliq=snliq,
                stc=stc, dzsnso=dzsnso, zsnso=zsnso, sneqv=sneqv,
                snowh=snowh, smc=smc, swc=swc)


def test_atm():
    rng = np.random.default_rng(1)
    args = [f32(rng.uniform(80000, 101000, N)), f32(rng.uniform(250, 310, N)),
            f32(rng.uniform(0.001, 0.02, N)), f32(rng.uniform(0, 0.003, N)),
            f32(rng.uniform(0, 900, N)), f32(rng.uniform(-0.3, 1.0, N))]
    ref = jax.vmap(jatm.atm)(*map(jnp.asarray, args))
    got = tatm.atm(*map(T, args))
    assert_close(ref, got, LOOP_FREE_BAR)


@pytest.mark.parametrize("opt_veg", [1, 3, 4])
def test_phenology_and_green_fraction(jp, tp, opt_veg):
    rng = np.random.default_rng(2)
    snowh = f32(rng.uniform(0, 1.5, N))
    tv = f32(rng.uniform(260, 300, N))
    lat = f32(rng.uniform(-1.0, 1.0, N))
    yearlen = f32(np.full(N, 365.0))
    julian = f32(rng.uniform(0, 365, N))
    julian[0], julian[1] = 0.2, 364.9      # month wrap on both ends
    lai = f32(rng.uniform(0, 5, N))
    sai = f32(rng.uniform(0, 1, N))
    shdfac = f32(rng.uniform(0.1, 0.9, N))
    shdmax = f32(rng.uniform(0.5, 0.95, N))

    def col(lutyp, snowh, tv, lat, yearlen, julian, lai, sai, shdfac, shdmax):
        ph = jphen.phenology(jp.veg, lutyp, snowh, tv, lat, yearlen, julian,
                             lai, sai, opt_veg)
        fveg = jphen.green_fraction(jp.veg, lutyp, shdfac, shdmax, ph.lai,
                                    ph.sai, ph.elai, ph.esai, opt_veg)
        return ph, fveg

    ref = jax.vmap(col)(*map(jnp.asarray, (LUTYP, snowh, tv, lat, yearlen,
                                           julian, lai, sai, shdfac, shdmax)))
    ph = tphen.phenology(tp.veg, TL(LUTYP), T(snowh), T(tv), T(lat),
                         T(yearlen), T(julian), T(lai), T(sai), opt_veg)
    fveg = tphen.green_fraction(tp.veg, TL(LUTYP), T(shdfac), T(shdmax),
                                ph.lai, ph.sai, ph.elai, ph.esai, opt_veg)
    assert_close(ref, (ph, fveg), LOOP_FREE_BAR)


def test_thermoprop(jp, tp):
    c = snow_columns(3)

    def col(sltyp, lutyp, ist, nsnow, dzsnso, snowh, snice, snliq, smc, swc,
            stc):
        return jthermo.thermoprop(jp.soil, jp.veg, jp.gen, sltyp, lutyp, ist,
                                  nsnow, jnp.float32(DT), dzsnso, snowh,
                                  snice, snliq, jp.gen.csoil, smc, swc, stc)

    names = ("nsnow", "dzsnso", "snowh", "snice", "snliq", "smc", "swc",
             "stc")
    ref = jax.vmap(col)(*map(jnp.asarray, (SLTYP, LUTYP, IST)),
                        *(jnp.asarray(c[k]) for k in names))
    got = tthermo.thermoprop(
        tp.soil, tp.veg, tp.gen, TL(SLTYP), TL(LUTYP), T(IST), T(c["nsnow"]),
        torch.tensor(DT), T(c["dzsnso"]), T(c["snowh"]), T(c["snice"]),
        T(c["snliq"]), tp.gen.csoil, T(c["smc"]), T(c["swc"]), T(c["stc"]))
    assert_close(ref, got, LOOP_FREE_BAR)


def _radiation_inputs(seed):
    rng = np.random.default_rng(seed)
    c = snow_columns(seed)
    cosz = f32(rng.uniform(0.05, 1.0, N))
    cosz[2] = -0.1                          # one night point
    elai = f32(rng.uniform(0.3, 4.0, N))
    esai = f32(rng.uniform(0.1, 0.8, N))
    nonveg = np.isin(LUTYP, (1, 16, 19, 24))
    elai[nonveg] = 0.0
    esai[nonveg] = 0.0
    soldn = f32(rng.uniform(100, 900, N))
    return dict(
        sneqvo=f32(c["sneqv"] * 0.9), sneqv=c["sneqv"], cosz=cosz,
        snowh=c["snowh"], tg=f32(rng.uniform(262, 290, N)),
        tv=f32(rng.uniform(262, 290, N)), fsno=f32(rng.uniform(0, 1, N)),
        qsnow=f32(rng.uniform(0, 0.002, N)), fwet=f32(rng.uniform(0, 1, N)),
        elai=elai, esai=esai, smc0=c["smc"][:, 0],
        solad=f32(np.stack([soldn * 0.35] * 2, 1)),
        solai=f32(np.stack([soldn * 0.15] * 2, 1)),
        fveg=f32(np.where(nonveg, 0.0, rng.uniform(0.3, 0.95, N))),
        albold=f32(rng.uniform(0.5, 0.8, N)),
        tauss=f32(rng.uniform(0, 1, N)))


@pytest.mark.parametrize("opt_alb,opt_rad", [(2, 1), (1, 3), (2, 2)])
def test_radiation(jp, tp, opt_alb, opt_rad):
    r = _radiation_inputs(4)
    keys = list(r)

    def col(lutyp, ist, isc, ice, *vals):
        v = dict(zip(keys, vals))
        return jrad.radiation(
            jp.veg, jp.soil, jp.gen, lutyp, ist, isc, ice, v["sneqvo"],
            v["sneqv"], jnp.float32(DT), v["cosz"], v["snowh"], v["tg"],
            v["tv"], v["fsno"], v["qsnow"], v["fwet"], v["elai"], v["esai"],
            v["smc0"], v["solad"], v["solai"], v["fveg"], v["albold"],
            v["tauss"], opt_alb, opt_rad)

    ref = jax.vmap(col)(*map(jnp.asarray, (LUTYP, IST, ISC, ICE)),
                        *(jnp.asarray(r[k]) for k in keys))
    v = {k: T(x) for k, x in r.items()}
    got = trad.radiation(
        tp.veg, tp.soil, tp.gen, TL(LUTYP), T(IST), TL(ISC), T(ICE),
        v["sneqvo"], v["sneqv"], torch.tensor(DT), v["cosz"], v["snowh"],
        v["tg"], v["tv"], v["fsno"], v["qsnow"], v["fwet"], v["elai"],
        v["esai"], v["smc0"], v["solad"], v["solai"], v["fveg"], v["albold"],
        v["tauss"], opt_alb, opt_rad)
    assert_close(ref, got, LOOP_FREE_BAR)


@pytest.mark.parametrize("opt_tbot,opt_stc", [(2, 1), (1, 2)])
def test_tsnosoi_holds_the_seven_row_solve(jp, tp, opt_tbot, opt_stc):
    rng = np.random.default_rng(5)
    c = snow_columns(5)
    tbot = f32(rng.uniform(275, 290, N))
    ssoil = f32(rng.uniform(-60, 120, N))
    df = f32(rng.uniform(0.1, 2.5, (N, 7)))
    hcpct = f32(rng.uniform(0.5e6, 3.0e6, (N, 7)))

    def col(nsnow, tbot, zsnso, ssoil, df, hcpct, snowh, stc):
        return jsoilt.tsnosoi(jnp.float32(DT), nsnow, tbot, jp.gen.zbot,
                              zsnso, ssoil, df, hcpct, snowh, stc,
                              opt_tbot, opt_stc)

    args = (c["nsnow"], tbot, c["zsnso"], ssoil, df, hcpct, c["snowh"],
            c["stc"])
    ref = jax.vmap(col)(*map(jnp.asarray, args))
    a = list(map(T, args))
    got = tsoilt.tsnosoi(torch.tensor(DT), a[0], a[1], tp.gen.zbot, *a[2:],
                         opt_tbot, opt_stc)
    assert_close(ref, got, LOOP_FREE_BAR)
    # inactive snow slots are identity rows: their temperature is kept
    inactive = np.arange(7)[None, :] < (3 - c["nsnow"])[:, None]
    np.testing.assert_array_equal(got.numpy()[inactive], c["stc"][inactive])


@pytest.mark.parametrize("opt_frz", [1, 2])
def test_phasechange(jp, tp, opt_frz):
    rng = np.random.default_rng(6)
    c = snow_columns(6)
    # some snow layers above freezing so that melt is reached
    c["stc"][:, :3] = np.where(c["stc"][:, :3] > 0,
                               c["stc"][:, :3] + 2.0, 0.0)
    fact = f32(rng.uniform(1e-4, 1e-2, (N, 7)))

    def col(sltyp, ist, nsnow, fact, dzsnso, stc, snice, snliq, sneqv, snowh,
            smc, swc):
        return jsoilt.phasechange(jp.soil, sltyp, ist, jnp.float32(DT), nsnow,
                                  fact, dzsnso, stc, snice, snliq, sneqv,
                                  snowh, smc, swc, opt_frz)

    args = (c["nsnow"], fact, c["dzsnso"], c["stc"], c["snice"], c["snliq"],
            c["sneqv"], c["snowh"], c["smc"], c["swc"])
    ref = jax.vmap(col)(jnp.asarray(SLTYP), jnp.asarray(IST),
                        *map(jnp.asarray, args))
    a = list(map(T, args))
    got = tsoilt.phasechange(tp.soil, TL(SLTYP), T(IST), torch.tensor(DT),
                             *a, opt_frz)
    assert got.imelt.dtype == torch.int32
    assert_close(ref, got, LOOP_FREE_BAR)
    assert int(got.imelt.sum()) > 0       # the case does melt or freeze


def _soil_inputs(seed):
    rng = np.random.default_rng(seed)
    c = snow_columns(seed, layers=0)
    sice = f32(np.maximum(c["smc"] - c["swc"], 0.0))
    qinsrf = f32(rng.uniform(0, 4e-6, N))
    qinsrf[1] = 3.0e-4          # heavy input: six Richards sub-steps
    qinsrf[4] = 0.0
    return dict(qinsrf=qinsrf, qseva=f32(rng.uniform(0, 3e-8, N)),
                etrani=f32(rng.uniform(0, 2e-8, (N, 4))), sice=sice,
                swc=c["swc"], smc=c["smc"], zwt=f32(rng.uniform(1.6, 8, N)),
                wa=f32(rng.uniform(4000, 5000, N)))


@pytest.mark.parametrize("opt_run,opt_inf", [(1, 1), (2, 1), (3, 2), (4, 1)])
def test_soilh2o_holds_the_four_row_solve(jp, tp, opt_run, opt_inf):
    s = _soil_inputs(7)
    slptyp = np.ones(N, np.int32)

    def col(sltyp, slptyp, lutyp, zsoil, dzsoil, qinsrf, qseva, etrani, sice,
            swc, smc, zwt):
        return jsw.soilh2o(jp.soil, jp.gen, jp.veg, sltyp, slptyp, lutyp,
                           jnp.float32(DT), zsoil, dzsoil, qinsrf, qseva,
                           etrani, sice, swc, smc, zwt, opt_run, opt_inf)

    args = (ZSOIL, DZ_SOIL, s["qinsrf"], s["qseva"], s["etrani"], s["sice"],
            s["swc"], s["smc"], s["zwt"])
    ref = jax.vmap(col)(*map(jnp.asarray, (SLTYP, slptyp, LUTYP)),
                        *map(jnp.asarray, args))
    got = tsw.soilh2o(tp.soil, tp.gen, tp.veg, TL(SLTYP), TL(slptyp),
                      TL(LUTYP), torch.tensor(DT), *map(T, args),
                      opt_run, opt_inf)
    assert_close(ref, got, LOOP_FREE_BAR)


def test_groundwater_float64_term(jp, tp):
    """SIMGM aquifer; its SMPFZ is computed in float64 and rounded once,
    where the JAX package uses two-float arithmetic to the same end."""
    rng = np.random.default_rng(8)
    s = _soil_inputs(8)
    s["zwt"][:3] = (0.3, 0.9, 1.9)      # water table inside the column
    s["smc"][5] = 0.001                 # S_NODE at its lower clamp
    s["swc"][5] = 0.001
    s["sice"][5] = 0.0
    wcnd = f32(rng.uniform(1e-8, 5e-6, (N, 4)))
    fcrmax = f32(rng.uniform(0, 0.5, N))

    def col(sltyp, zsoil, sice, wcnd, fcrmax, swc, zwt, wa):
        return jsw.groundwater(jp.soil, jp.gen, sltyp, jnp.float32(DT), zsoil,
                               sice, wcnd, fcrmax, swc, zwt, wa, wa)

    args = (ZSOIL, s["sice"], wcnd, fcrmax, s["swc"], s["zwt"], s["wa"])
    ref = jax.vmap(col)(jnp.asarray(SLTYP), *map(jnp.asarray, args))
    a = list(map(T, args))
    got = tsw.groundwater(tp.soil, tp.gen, TL(SLTYP), torch.tensor(DT), *a,
                          a[-1])
    assert got.qin.dtype == torch.float32
    assert_close(ref, got, LOOP_FREE_BAR)


def test_smpfz_float64_matches_two_float():
    """The one float64 spot against the JAX package's two-float value on
    a parameter sweep: the JAX side is documented as within 1 ulp of the
    float64 result, so the two agree to 2 ulp."""
    from noahmp_tpu.numerics.dfloat import smpfz_f64_parity
    rng = np.random.default_rng(9)
    m = 4096
    s_node = f32(rng.uniform(0.01, 1.0, m))
    s_node[:16] = 0.01
    bexp = f32(rng.uniform(2.5, 12.0, m))
    psisat = f32(rng.uniform(0.03, 0.8, m))
    at_clip = s_node <= np.float32(0.01)
    ref = np.asarray(smpfz_f64_parity(*map(jnp.asarray, (s_node, bexp, psisat,
                                                         at_clip))))
    got = tsw.smpfz_f64(T(s_node), T(bexp), T(psisat), T(at_clip)).numpy()
    assert got.dtype == np.float32
    ulp = np.spacing(np.abs(ref))
    assert np.max(np.abs(ref - got) / ulp) <= 2.0
    exact = (-psisat.astype(np.float64) * 1000.0
             * np.where(at_clip, 0.01, s_node.astype(np.float64))
             ** (-bexp.astype(np.float64))).astype(np.float32)
    np.testing.assert_array_equal(got, exact)


@pytest.mark.parametrize("layers", [0, 1, 2, 3])
def test_snowwater_full(jp, tp, layers):
    """Snow re-layering (snowfall, compact, combine, divide, percolation)
    from 0, 1, 2 and 3 active layers, with thin and thick layers so that
    merges and splits are reached."""
    rng = np.random.default_rng(10 + layers)
    c = snow_columns(10 + layers, layers=layers)
    if layers:
        top = 3 - layers
        c["dzsnow"][0, top] = 0.30          # too thick: divide
        c["dzsnow"][1, 2] = 0.012           # too thin: combine
        c["snice"][2, top] = 0.05           # vanishing ice: merge down
        c["dzsnow"][3, :] *= 0.05           # whole pack collapses
        c["snice"][3, :] *= 0.05
    imelt = rng.integers(0, 2, (N, 3)).astype(np.int32)
    sfctmp = f32(rng.uniform(258, 272, N))
    qsnow = f32(rng.uniform(0, 0.004, N))
    qsnow[5] = 0.04                         # 3.6 cm of snow in one step
    snowhin = f32(qsnow / 100.0)
    qsnfro = f32(rng.uniform(0, 1e-5, N))
    qsnsub = f32(rng.uniform(0, 3e-5, N))
    qsnsub[6] = 0.05                        # sublimates the top layer away
    qrain = f32(rng.uniform(0, 1e-3, N))
    ficeold = f32(rng.uniform(0.6, 1.0, (N, 3)))
    sice = f32(np.maximum(c["smc"] - c["swc"], 0.0))

    def col(zsoil, dzsnow, imelt, sfctmp, snowhin, qsnow, qsnfro, qsnsub,
            qrain, ficeold, nsnow, snowh, sneqv, snice, snliq, swc, sice,
            stc):
        return jwater.snowwater_full(jp.gen, jnp.float32(DT), zsoil, dzsnow,
                                     imelt, sfctmp, snowhin, qsnow, qsnfro,
                                     qsnsub, qrain, ficeold, nsnow, snowh,
                                     sneqv, snice, snliq, swc, sice, stc)

    args = (ZSOIL, c["dzsnow"], imelt, sfctmp, snowhin, qsnow, qsnfro, qsnsub,
            qrain, ficeold, c["nsnow"], c["snowh"], c["sneqv"], c["snice"],
            c["snliq"], c["swc"], sice, c["stc"])
    ref = jax.vmap(col)(*map(jnp.asarray, args))
    got = twater.snowwater_full(tp.gen, torch.tensor(DT), *map(T, args))
    assert got.nsnow.dtype == torch.int32
    assert_close(ref, got, LOOP_FREE_BAR)
    if layers:
        assert len(set(got.nsnow.tolist())) > 1   # layer counts did change


def _surface_inputs(seed):
    rng = np.random.default_rng(seed)
    c = snow_columns(seed)
    r = _radiation_inputs(seed)
    sfctmp = f32(rng.uniform(262, 300, N))
    sfcprs = f32(np.full(N, 90000.0))
    qair = f32(rng.uniform(0.002, 0.008, N))
    eair = f32(qair * sfcprs / (0.622 + 0.378 * qair))
    rhoair = f32((sfcprs - 0.378 * eair) / (287.04 * sfctmp))
    return c, r, dict(sfctmp=sfctmp, sfcprs=sfcprs, qair=qair, eair=eair,
                      rhoair=rhoair, lwdn=f32(rng.uniform(220, 400, N)),
                      uu=f32(rng.uniform(0.5, 6, N)),
                      vv=f32(rng.uniform(-3, 3, N)))


def test_energy(jp, tp):
    """The whole surface energy balance: radiation, both Newton loops,
    the heat solve and phase change."""
    rng = np.random.default_rng(11)
    c, r, a = _surface_inputs(11)
    r["tg"] = f32(a["sfctmp"] + rng.uniform(-3, 3, N))
    r["tv"] = f32(a["sfctmp"] + rng.uniform(-2, 2, N))
    per_point = dict(
        nsnow=c["nsnow"], dzsnso=c["dzsnso"], rhoair=a["rhoair"],
        sfcprs=a["sfcprs"], psfc=a["sfcprs"], qair=a["qair"],
        sfctmp=a["sfctmp"], thair=a["sfctmp"], lwdn=a["lwdn"], uu=a["uu"],
        vv=a["vv"], zref=f32(np.full(N, 10.0)), co2air=f32(np.full(N, 39.0)),
        o2air=f32(np.full(N, 18900.0)), solad=r["solad"], solai=r["solai"],
        cosz=r["cosz"], igs=f32(np.ones(N)), eair=a["eair"],
        htop=f32(np.array([20, 0.5, 1, 0.01, 0.01, 0.01, 1.5, 1.1])),
        tbot=f32(np.full(N, 283.0)), zsnso=c["zsnso"], zsoil=ZSOIL,
        elai=r["elai"], esai=r["esai"], fwet=r["fwet"],
        foln=f32(np.ones(N)), fveg=r["fveg"], qsnow=r["qsnow"],
        canliq=f32(rng.uniform(0, 0.3, N)), canice=f32(rng.uniform(0, 0.2, N)),
        tv=r["tv"], tg=r["tg"], stc=c["stc"], snowh=c["snowh"],
        eah=f32(a["eair"] * 1.1), tah=a["sfctmp"], sneqvo=r["sneqvo"],
        sneqv=c["sneqv"], swc=c["swc"], smc=c["smc"], snice=c["snice"],
        snliq=c["snliq"], albold=r["albold"], cm=f32(np.full(N, 0.01)),
        ch=f32(np.full(N, 0.01)), tauss=r["tauss"],
        qsfc=f32(np.full(N, 0.005)), lutyp=LUTYP, sltyp=SLTYP,
        slptyp=np.ones(N, np.int32), isc=ISC, ist=IST, ice=ICE)
    keys = list(per_point)

    def col(*vals):
        return jenergy.energy(jp, JOptions(), None, jnp.float32(DT), *vals)

    ref = jax.vmap(col)(*(jnp.asarray(per_point[k]) for k in keys))
    index = ("lutyp", "sltyp", "slptyp", "isc")
    got = tenergy.energy(tp, Options(), torch.tensor(DT),
                         *(TL(per_point[k]) if k in index
                           else T(per_point[k]) for k in keys))
    assert_close(ref, got, FLUX_BAR, FLUX_CEILING)


def test_water(jp, tp):
    """Canopy water, the snowpack driver, the Richards solve and the
    aquifer together."""
    rng = np.random.default_rng(12)
    c, r, a = _surface_inputs(12)
    frozen_ground = r["tg"] <= 273.15
    btrani = f32(np.tile([0.4, 0.3, 0.2, 0.1], (N, 1)))
    per_point = dict(
        lutyp=LUTYP, sltyp=SLTYP, slptyp=np.ones(N, np.int32), ist=IST,
        zsoil=ZSOIL, dzsnow=c["dzsnow"],
        imelt=rng.integers(0, 2, (N, 3)).astype(np.int32), uu=a["uu"],
        vv=a["vv"], fcev=f32(rng.uniform(-5, 30, N)),
        fctr=f32(rng.uniform(0, 80, N)), qprecc=f32(rng.uniform(0, 1e-4, N)),
        qprecl=f32(rng.uniform(0, 1e-3, N)), elai=r["elai"], esai=r["esai"],
        sfctmp=a["sfctmp"], qvap=f32(rng.uniform(0, 3e-5, N)),
        qdew=f32(rng.uniform(0, 3e-6, N)), btrani=btrani,
        ficeold=f32(rng.uniform(0.6, 1, (N, 3))),
        ponding=f32(rng.uniform(0, 0.5, N)), tg=r["tg"], fveg=r["fveg"],
        latheav=f32(np.where(r["tv"] <= 273.15, 2.844e6, 2.5104e6)),
        latheag=f32(np.where(frozen_ground, 2.844e6, 2.5104e6)),
        frozen_canopy=r["tv"] <= 273.15, frozen_ground=frozen_ground,
        nsnow=c["nsnow"], canliq=f32(rng.uniform(0, 0.3, N)),
        canice=f32(rng.uniform(0, 0.2, N)), tv=r["tv"], snowh=c["snowh"],
        sneqv=c["sneqv"], snice=c["snice"], snliq=c["snliq"], stc=c["stc"],
        swc=c["swc"], smc=c["smc"], zwt=f32(rng.uniform(1.6, 8, N)),
        wa=f32(rng.uniform(4000, 5000, N)), wt=f32(rng.uniform(4000, 5000, N)),
        wslake=f32(rng.uniform(0, 100, N)))
    keys = list(per_point)
    lead = ("lutyp", "sltyp", "slptyp", "ist")

    def col(*vals):
        v = dict(zip(keys, vals))
        rest = [v[k] for k in keys if k not in lead]
        return jwater.water(jp, JOptions(), v["lutyp"], v["sltyp"],
                            v["slptyp"], v["ist"], jnp.float32(DT), *rest)

    ref = jax.vmap(col)(*(jnp.asarray(per_point[k]) for k in keys))
    v = {k: T(x) for k, x in per_point.items()}
    got = twater.water(tp, Options(), TL(LUTYP), TL(SLTYP),
                       v["slptyp"].long(), v["ist"], torch.tensor(DT),
                       *(v[k] for k in keys if k not in lead))
    assert_close(ref, got, FLUX_BAR, FLUX_CEILING)
