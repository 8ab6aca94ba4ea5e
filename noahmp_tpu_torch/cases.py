"""Seeded reference cases for the port's tests and its on-card smoke run.

Two cases, both as plain dicts of numpy leaves so that the same arrays
can be handed to this package and to any other implementation:

* ``uniform_case``: every point the same evergreen forest column under
  warm daytime forcing (land use 7, soil 6), the case the repository's
  throughput measurements have always used.
* ``hetero_case``: a block of 8 columns (forest, grass, urban, water,
  barren, ice, cropland, shrub) under one of four forcing ``REGIMES``
  that reach the snow, frozen-soil and stomatal-stress branches; tiled
  to any n.

And one file-driven case for the offline driver: ``conus_case`` writes
a CONUS-flavoured domain, init and hourly forcing files and a namelist
(the port's copy of ``examples/make_case.py:conus``, the same arrays
from the same seed).

And the resync fuzz that the serial C++ oracle (``native``) holds the
port to, with its limits: ``fuzz_case``, ``fuzz_forcing``,
``FUZZ_COMBOS``, ``fuzz_shares``.
"""

import datetime
import os

import numpy as np

from .convert import tree_from_numpy, tree_to_numpy
from .options import Options
from .state import State, Static, Forcing, init_state, init_static

REGIMES = {
    # day, warm, light rain
    "warm_day": dict(sfctmp=293.0, q2=0.007, soldn=500.0, lwdn=330.0,
                     prcp=0.001, cosz=0.6, state={}),
    # night, subfreezing, snowing onto an existing shallow pack
    "cold_snow": dict(sfctmp=265.0, q2=0.002, soldn=0.0, lwdn=220.0,
                      prcp=0.002, cosz=-0.2,
                      state=dict(tg=268.0, tv=266.0, sneqv=25.0,
                                 snowh=0.12, stc_soil=271.0)),
    # frozen ground, clear morning, no precip
    "frozen_morning": dict(sfctmp=270.0, q2=0.003, soldn=300.0,
                           lwdn=250.0, prcp=0.0, cosz=0.35,
                           state=dict(tg=269.0, tv=269.0,
                                      stc_soil=270.0)),
    # hot dry bare-ish conditions (stomata/canres stress branch)
    "hot_dry": dict(sfctmp=310.0, q2=0.004, soldn=900.0, lwdn=400.0,
                    prcp=0.0, cosz=0.9,
                    state=dict(tg=312.0, tv=309.0, swc=0.08,
                               smc=0.08)),
}

# forest, grass, urban(1), water(16), barren(19), ice(24), cropland, shrub
_BLOCK = dict(
    lutyp=np.array([7, 10, 1, 16, 19, 24, 2, 8], np.int32),
    sltyp=np.array([6, 4, 9, 14, 16, 12, 3, 7], np.int32),
    ist=np.array([1, 1, 1, 2, 1, 1, 1, 1], np.int32),
    ice=np.array([0, 0, 0, 0, 0, 1, 0, 0], np.int32),
)


def _forcing(n, **over):
    vals = dict(sfctmp=295.0, sfcprs=90000.0, psfc=90000.0, uu=3.0,
                vv=1.0, q2=0.008, soldn=600.0, lwdn=350.0, prcp=0.001,
                cosz=0.7, co2air=39.0, o2air=18900.0, foln=1.0,
                julian=180.0, yearlen=366.0)
    vals.update(over)
    return {k: np.full((n,), vals[k], np.float32) for k in Forcing._fields}


def uniform_case(n):
    """(static, forcing, state) dicts of numpy leaves, n equal columns."""
    static = tree_to_numpy(init_static(n, device="cpu", lutyp=7, sltyp=6))
    state = tree_to_numpy(init_state(n, device="cpu"))
    return static, _forcing(n), state


def hetero_case(regime, n=8):
    """(static, forcing, state) dicts of numpy leaves: the 8-column
    block under ``REGIMES[regime]``, repeated to n points (n a multiple
    of 8)."""
    if n % 8:
        raise ValueError(f"n={n} is not a multiple of the 8-column block")
    r = REGIMES[regime]
    static = tree_to_numpy(init_static(n, device="cpu", lutyp=7, sltyp=6))
    for k, v in _BLOCK.items():
        static[k] = np.tile(v, n // 8)
    skw = dict(r["state"])
    stc_soil = skw.pop("stc_soil", None)
    state = tree_to_numpy(init_state(n, device="cpu", **skw))
    if stc_soil is not None:
        state["stc"][:, 3:] = stc_soil
    forcing = _forcing(n, **{k: v for k, v in r.items() if k != "state"})
    return static, forcing, state


def forcing_sequence(forcing, steps):
    """A Forcing dict of (n,) numpy leaves as ``steps`` steps stacked
    ``(steps, n)``, for the multi-step entry points: air temperature,
    shortwave and wind swing a little from step to step (a slow wave
    with a period of 24 steps), so that no two steps of a chunk are
    alike; everything else repeats."""
    wave = np.sin(2.0 * np.pi * np.arange(steps, dtype=np.float32) / 24.0)
    out = {k: np.repeat(v[None], steps, axis=0) for k, v in forcing.items()}
    out["sfctmp"] = (out["sfctmp"] + 1.5 * wave[:, None]).astype(np.float32)
    out["soldn"] = (out["soldn"] * (1.0 - 0.2 * wave[:, None] ** 2)).astype(
        np.float32)
    out["uu"] = (out["uu"] + 0.5 * wave[:, None]).astype(np.float32)
    return out


def to_device(case, device=None):
    """The (static, forcing, state) dicts as the port's containers on
    ``device`` (``None``: the card)."""
    static, forcing, state = case
    return (tree_from_numpy(Static, static, device),
            tree_from_numpy(Forcing, forcing, device),
            tree_from_numpy(State, state, device))


def scaled_err(a, b):
    """Worst element of |a - b| / max(1, |a|) over two numpy arrays (the
    element-wise scale: a field-global max would hide small fields).
    Equal infinities and NaN in both count as equal; a NaN in one only,
    or a shape mismatch, counts as infinite."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.shape != b.shape:
        return float("inf")
    if a.size == 0:
        return 0.0
    with np.errstate(invalid="ignore"):
        err = np.abs(a - b) / np.maximum(1.0, np.abs(a))
    err = np.where((a == b) | (np.isnan(a) & np.isnan(b)), 0.0, err)
    return float("inf") if np.isnan(err).any() else float(err.max())


# Bars of the full step, per leaf and per element.  A leaf passes when
# every element's |ref - got| is within BOTH
#   bar * max(1, |ref|)            (the element-wise scale), and
#   atol + rtol * |ref|            (the ceiling: what the fused TPU kernel
#                                   of the JAX package is held to against
#                                   its own plain step).
# The bars are about 4x the worst value measured between the port and
# the JAX step on the CPU, and between the card and the CPU (PERF.md);
# the step is not held to 1e-6 because exp/log/pow differ in the last
# bit between libraries and the Newton loops compare against thresholds.
STATE_BAR = 1.0e-4
STATE_CEILING = (1.0e-4, 8.0e-3)     # rtol, atol
FLUX_BAR = 5.0e-3
FLUX_CEILING = (1.0e-3, 0.2)


def bar_ratio(ref, got, bar, ceiling):
    """Worst element of |ref - got| / allowed, where allowed is the
    smaller of the two limits above; <= 1 passes.  Equal infinities and
    NaN in both count as equal, NaN in one or a shape mismatch as
    infinite."""
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    if ref.shape != got.shape:
        return float("inf")
    if ref.size == 0:
        return 0.0
    rtol, atol = ceiling
    mag = np.abs(ref)
    allowed = np.minimum(bar * np.maximum(1.0, mag), atol + rtol * mag)
    with np.errstate(invalid="ignore"):
        ratio = np.abs(ref - got) / allowed
    ratio = np.where((ref == got) | (np.isnan(ref) & np.isnan(got)),
                     0.0, ratio)
    return float("inf") if np.isnan(ratio).any() else float(ratio.max())


def run_ratio(ref, got, bar, ceiling, steps):
    """``bar_ratio`` for a field after ``steps`` steps of a run (an
    offline run's ldasout window, or its State): each step may add one
    step's bar of difference, so the field is held to ``steps`` times
    the step's bar; <= 1 passes.  Two implementations that differ in
    the last bit of a step drift apart where a point sits near one of
    the model's thresholds (canopy water at capacity, a soil layer at
    freezing): between the port and the JAX package on the CPU, 32
    points of the generated CONUS case reach 2.6 times the flux bar in
    ``ssoil`` after 8 steps and 3.6 times the state bar in ``canliq``
    after 16 (tests/test_torch_offline.py), then fall back under 1."""
    return bar_ratio(ref, got, bar, ceiling) / max(1, steps)


def point_ratios(ref, got, bar, ceiling, steps=1):
    """Per land point (the leading axis), the worst element of
    ``run_ratio``: |ref - got| over ``steps`` times the step's bars.
    Equal values (NaN in both included) give 0, NaN in one only inf.  A
    run of two implementations differs beyond the bars at a few points
    near a threshold (``run_ratio``); this says at which, and by how
    much, so a caller can count them."""
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    if ref.shape != got.shape:
        raise ValueError(f"shapes {ref.shape} and {got.shape}")
    rtol, atol = ceiling
    mag = np.abs(ref)
    allowed = np.minimum(bar * np.maximum(1.0, mag), atol + rtol * mag)
    with np.errstate(invalid="ignore"):
        ratio = np.abs(ref - got) / (allowed * max(1, steps))
    ratio = np.where((ref == got) | (np.isnan(ref) & np.isnan(got)), 0.0,
                     ratio)
    ratio = np.where(np.isnan(ratio), np.inf, ratio)
    return ratio.reshape(ratio.shape[0], -1).max(axis=1) if ratio.ndim \
        else ratio


# The carbon fluxes are of order 1e-6 g m-2 s-1 and the pools change by
# some 1e-3 g m-2 a step beside values of hundreds, so the step's bars
# above (which scale with max(1, |ref|)) are blind to them.  They are
# held relative to the leaf's largest magnitude in the case instead.  A
# pool's change over the step is the difference of two rounded pool
# values, so it is allowed one spacing of float32 at the pool's largest
# magnitude on top (3e-5 at 500 g m-2).
CARBON_FLUXES = ("gpp", "npp", "nee")
CARBON_POOLS = ("lfmass", "rtmass", "stmass", "wood", "stblcp", "fastcp")
CARBON_BAR = 1.0e-4


def carbon_ratio(ref, got, floor=0.0):
    """Worst |ref - got| over (CARBON_BAR x the largest finite |ref| of
    the leaf + floor); <= 1 passes.  Equal infinities and NaN in both
    count as equal, NaN in one or a shape mismatch as infinite."""
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    if ref.shape != got.shape:
        return float("inf")
    finite = np.isfinite(ref)
    if not finite.any():
        return 0.0 if np.array_equal(ref, got, equal_nan=True) else float(
            "inf")
    allowed = CARBON_BAR * np.abs(ref[finite]).max() + floor
    if allowed == 0.0:
        return 0.0 if np.array_equal(ref, got, equal_nan=True) else float(
            "inf")
    with np.errstate(invalid="ignore"):
        ratio = np.abs(ref - got) / allowed
    ratio = np.where((ref == got) | (np.isnan(ref) & np.isnan(got)),
                     0.0, ratio)
    return float("inf") if np.isnan(ratio).any() else float(ratio.max())


def carbon_ratios(old_state, ref, got):
    """{leaf: carbon_ratio} over gpp, npp, nee and the six pools' change
    over the step; ``ref`` and ``got`` are (state, flux) dicts of numpy
    leaves, ``old_state`` the state both started from."""
    out = {name: carbon_ratio(ref[1][name], got[1][name])
           for name in CARBON_FLUXES}
    for name in CARBON_POOLS:
        old = old_state[name]
        top = max(float(np.abs(ref[0][name]).max()), float(np.abs(old).max()))
        out[name] = carbon_ratio(ref[0][name] - old, got[0][name] - old,
                                 floor=float(np.spacing(np.float32(top))))
    return out


# USGS special land-use classes (params/data/VEGPARMMP.TBL header)
ISURBAN, ISWATER, ISBARREN, ISICE = 1, 16, 19, 24
# SOILPARMMP STAS row 14 is 'WATER' (all-zero hydraulics): only valid
# for water-body points
SOIL_WATER = 14


def conus_domain(n, rng):
    """Heterogeneous per-point types with CONUS-flavored fractions:
    ~87% vegetated/bare land over every ordinary USGS class, 3% urban,
    3% barren, 2% glacier ice, 5% inland water (ist=2)."""
    lat_deg = rng.uniform(25.0, 49.0, n).astype(np.float32)
    lon_deg = rng.uniform(-124.0, -67.0, n).astype(np.float32)

    ordinary = [c for c in range(1, 28)
                if c not in (ISURBAN, ISWATER, ISBARREN, ISICE)]
    u = rng.random(n)
    lutyp = rng.choice(ordinary, n).astype(np.int32)
    lutyp = np.where(u < 0.03, ISURBAN, lutyp)
    lutyp = np.where((u >= 0.03) & (u < 0.06), ISBARREN, lutyp)
    lutyp = np.where((u >= 0.06) & (u < 0.08), ISICE, lutyp)
    water = (u >= 0.08) & (u < 0.13)
    lutyp = np.where(water, ISWATER, lutyp).astype(np.int32)

    soil_land = [s for s in range(1, 20) if s != SOIL_WATER]
    sltyp = rng.choice(soil_land, n).astype(np.int32)
    sltyp = np.where(water, SOIL_WATER, sltyp).astype(np.int32)

    ist = np.where(water, 2, 1).astype(np.int32)
    ice = np.where(lutyp == ISICE, 1, 0).astype(np.int32)

    return {
        "lat": np.deg2rad(lat_deg).astype(np.float32),
        "lon": np.deg2rad(lon_deg).astype(np.float32),
        "lutyp": lutyp, "sltyp": sltyp,
        "slptyp": rng.integers(1, 10, n).astype(np.int32),
        "isc": rng.integers(1, 10, n).astype(np.int32),
        "ist": ist, "ice": ice,
        "shdfac": rng.uniform(0.1, 0.95, n).astype(np.float32),
        "shdmax": rng.uniform(0.5, 0.98, n).astype(np.float32),
        "tbot": (287.0 - 0.4 * (lat_deg - 25.0)).astype(np.float32),
        "zlvl": np.full(n, 10.0, np.float32),
        "zsoil": np.array([-0.1, -0.4, -1.0, -2.0], np.float32),
    }


def conus_case(n, seed=0, days=1, outdir="conus", start=None, fmt="nc"):
    """Write a file-driven offline case under ``outdir``: ``domain`` and
    ``init`` files, hourly ``ldasin/`` forcing for ``days`` days (plus
    two hours for the interpolation), empty ``ldasout/`` and
    ``restart/``, and ``case.nml`` (15-minute steps, 3-hourly output,
    daily restarts) naming them by absolute path.  ``fmt``: "nc"
    (classic NetCDF) or "npz".  Returns ``outdir``.

    Run it with ``python -m noahmp_tpu_torch.driver.cli
    <outdir>/case.nml [--device cpu]``."""
    from .driver.io import save_arrays

    rng = np.random.default_rng(seed)
    indir = os.path.join(outdir, "ldasin")
    os.makedirs(indir, exist_ok=True)
    for sub in ("ldasout", "restart"):
        os.makedirs(os.path.join(outdir, sub), exist_ok=True)

    dom = conus_domain(n, rng)
    ext = ".nc" if fmt == "nc" else ".npz"
    save_arrays(os.path.join(outdir, "domain" + ext), dom)

    lat_deg = np.rad2deg(dom["lat"])
    tg0 = (290.0 - 0.45 * (lat_deg - 25.0)
           + rng.normal(0.0, 1.0, n)).astype(np.float32)
    # one draw for both: swc must equal smc at an ice-free cold start
    # (swc > smc would mean negative soil ice; swc < smc implies ice
    # in unfrozen soil — either breaks the water budget from step 0)
    sm0 = np.broadcast_to(
        rng.uniform(0.15, 0.35, (n, 1)).astype(np.float32), (n, 4))
    save_arrays(os.path.join(outdir, "init" + ext), {
        "tg": tg0, "tv": tg0,
        "swc": sm0,
        "smc": sm0,
        "sneqv": np.where(lat_deg > 44.0, 20.0, 0.0).astype(np.float32),
        "snowh": np.where(lat_deg > 44.0, 0.1, 0.0).astype(np.float32),
    })

    # hourly forcing with latitudinal + diurnal structure and a moving
    # precipitation band; one extra hour for interpolation
    start = start or datetime.datetime(2000, 7, 1)
    lon_deg = np.rad2deg(dom["lon"])
    for h in range(days * 24 + 2):
        when = start + datetime.timedelta(hours=h)
        tod = (h + lon_deg / 15.0) % 24.0   # local solar time-ish
        day = np.maximum(0.0, np.sin((tod - 6.0) / 12.0 * np.pi))
        tair = (302.0 - 0.5 * (lat_deg - 25.0) + 9.0 * (day - 0.3)
                + rng.normal(0.0, 0.3, n))
        band = np.abs(lon_deg + 100.0 - 0.8 * h) < 4.0
        prcp = np.where(band, 2.0e-3 * rng.random(n), 0.0)
        save_arrays(os.path.join(indir, when.strftime("%Y%m%d%H") + ext), {
            "sfctmp": tair.astype(np.float32),
            "sfcprs": np.full(n, 95000.0, np.float32),
            "q2": (0.006 + 0.004 * day).astype(np.float32),
            "uu": rng.uniform(0.5, 8.0, n).astype(np.float32),
            "vv": rng.uniform(-3.0, 3.0, n).astype(np.float32),
            "soldn": (950.0 * day).astype(np.float32),
            "lwdn": (300.0 + 60.0 * day).astype(np.float32),
            "prcp": prcp.astype(np.float32),
            "lon": dom["lon"],
        })

    end = start + datetime.timedelta(days=days)
    rel = os.path.abspath(outdir)  # runnable from any cwd
    with open(os.path.join(outdir, "case.nml"), "w") as f:
        f.write(f"""&NOAHMP_OFFLINE
  ! generated by noahmp_tpu_torch.cases.conus_case (n={n}, seed={seed})
  static_parameter_file = '{rel}/domain{ext}'
  initialization_file = '{rel}/init{ext}'
  restart_file = 'restart.npz'

  input_directory = '{rel}/ldasin'
  input_frequency = '1 hour'
  output_directory = '{rel}/ldasout'
  output_frequency = '3 hour'
  restart_directory = '{rel}/restart'
  restart_frequency = '1 day'

  start_year = {start.year}
  start_month = {start.month}
  start_day = {start.day}
  start_hour = {start.hour}
  start_minute = 0
  start_second = 0

  end_year= {end.year}
  end_month = {end.month}
  end_day = {end.day}
  end_hour = {end.hour}
  end_minute = 0
  end_second = 0

  interval_seconds = 900

  opt_veg = 1
  opt_run = 1
  opt_btr = 1
  opt_rad = 1
  opt_tub = 1
  opt_can = 1
  opt_inf = 1
  opt_tbot = 1
  opt_snf = 1
/
""")
    return outdir


# The resync fuzz of tests/test_golden_native.py:248-292: ten columns
# (urban, barren, tundra and clay soils; a glacier column pre-loaded
# near the 2000 mm overflow, a lake column) under per-point weather drawn
# afresh every step, each step taken by the oracle from the State the
# step under test started from.  Limits (that file's, calibrated on the
# JAX package, 200-500 steps over three seeds): every column-step within
# FUZZ_CAP, at most FUZZ_OUTLIER_FRAC of them beyond FUZZ_TIGHT (rare
# Newton iteration-count flips at knife-edge states: 3 in 4,000
# column-steps there), the layer count equal everywhere.
FUZZ_LUTYP = (7, 14, 19, 11, 5, 2, 1, 21, 24, 16)
FUZZ_SLTYP = (6, 4, 1, 8, 9, 3, 12, 5, 1, 6)
FUZZ_ISC = (4, 2, 7, 5, 1, 3, 6, 8, 1, 4)
FUZZ_IST = (1, 1, 1, 1, 1, 1, 1, 1, 1, 2)
GLACIER_COL = 8

FUZZ_COMBOS = (
    ("default", Options()),
    ("frz2_tbot1", Options(frz=2, tbot=1)),
    ("jarvis_run3_inf2", Options(crs=2, run=3, inf=2)),
    ("dynveg2", Options(veg=2, crs=1)),
    ("snf2_stc2", Options(snf=2, stc=2)),
    ("btr3_run4_alb1_sfc2", Options(btr=3, run=4, alb=1, sfc=2)),
    ("rad2_run2", Options(rad=2, run=2)),
    ("rad3_frz2_snf3", Options(rad=3, frz=2, snf=3)),
)

FUZZ_TIGHT = dict(tg=0.1, tv=0.3, swc=1e-4, sneqv=0.05, canliq=0.02)
FUZZ_CAP = dict(tg=4.0, tv=2.5, swc=1e-3, sneqv=0.5, canliq=0.25)
FUZZ_OUTLIER_FRAC = 0.005


def fuzz_case(copies=1):
    """(static, state) dicts of numpy leaves: the ten fuzz columns, point
    p being column p % 10, ``copies`` times over.  The glacier column
    starts as a cold, fully layered 4 m pack just under the 2000 mm
    overflow (test_golden_native.py:313-337)."""
    n = len(FUZZ_LUTYP)
    static = tree_to_numpy(init_static(n, device="cpu"))
    for name, cols in (("lutyp", FUZZ_LUTYP), ("sltyp", FUZZ_SLTYP),
                       ("isc", FUZZ_ISC), ("ist", FUZZ_IST)):
        static[name] = np.asarray(cols, np.int32)
    state = tree_to_numpy(init_state(n, device="cpu", tg=278.0, tv=278.0,
                                     stc_soil=278.0))
    g = GLACIER_COL
    gl_dz = np.array([0.05, 0.2, 3.75], np.float32)
    gl_ice = np.array([25.0, 100.0, 1870.0], np.float32)  # ~500 kg/m3
    gl_z = -np.cumsum(np.concatenate(
        [gl_dz, np.diff(np.concatenate([[0.0], -static["zsoil"][g]]))]))
    state["nsnow"][g] = 3
    state["snice"][g] = gl_ice
    state["snliq"][g] = 0.0
    state["ficeold"][g] = 1.0
    state["zsnso"][g] = gl_z.astype(np.float32)
    state["stc"][g] = np.concatenate([np.full(3, 266.0), np.full(4, 268.0)])
    state["sneqv"][g] = state["sneqvo"][g] = gl_ice.sum()
    state["snowh"][g] = gl_dz.sum()
    state["tg"][g] = state["tv"][g] = 266.0

    def tile(leaves):
        return {k: np.ascontiguousarray(np.tile(
            v, (copies,) + (1,) * (v.ndim - 1))) for k, v in leaves.items()}
    return tile(static), tile(state)


def fuzz_forcing(rng, n):
    """A Forcing dict of (n,) leaves: weather drawn per point as
    test_golden_native.py:_fuzz_forcing draws it, day or night."""
    day = rng.random(n) < 0.5
    out = _forcing(n)
    out.update(
        sfctmp=rng.uniform(250.0, 305.0, n).astype(np.float32),
        uu=rng.uniform(0.5, 12.0, n).astype(np.float32),
        q2=rng.uniform(0.001, 0.012, n).astype(np.float32),
        soldn=np.where(day, rng.uniform(100.0, 900.0, n),
                       0.0).astype(np.float32),
        lwdn=rng.uniform(200.0, 400.0, n).astype(np.float32),
        prcp=rng.choice([0.0, 0.0002, 0.001, 0.004], n).astype(np.float32),
        cosz=np.where(day, rng.uniform(0.1, 0.95, n),
                      -0.2).astype(np.float32))
    return out


def fuzz_shares(got, ref):
    """Per point, over two dicts of State leaves (numpy, the point axis
    first) from the same step: the worst |got - ref| over FUZZ_TIGHT
    across the five fields, whether any field is beyond FUZZ_CAP, whether
    ``nsnow`` differs, and {field: |got - ref| over its FUZZ_TIGHT}.  A
    NaN counts as beyond both."""
    n = np.asarray(got["tg"]).shape[0]
    by_field = {}
    over_cap = np.zeros(n, bool)
    for name, tight in FUZZ_TIGHT.items():
        d = np.abs(np.asarray(got[name], np.float64)
                   - np.asarray(ref[name], np.float64))
        d = np.where(np.isnan(d), np.inf, d).reshape(n, -1).max(axis=1)
        by_field[name] = d / tight
        over_cap |= d > FUZZ_CAP[name]
    share = np.max(np.stack(list(by_field.values())), axis=0)
    nsnow = np.asarray(got["nsnow"]) != np.asarray(ref["nsnow"])
    return share, over_cap, nsnow, by_field
