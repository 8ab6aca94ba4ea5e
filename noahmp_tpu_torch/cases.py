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
"""

import numpy as np

from .convert import tree_from_numpy, tree_to_numpy
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
