"""Physics option flags.

Own copy of ``noahmp_tpu/options.py``.  The reference keeps 12 integer
option switches in module globals (reference:
core/module_noahmp_global.f90:15-74).  Here they are a frozen NamedTuple
read when a step is built: each ``opt_*`` is a Python ``if``, so the step
runs only the selected branch and never dispatches on the hot path.

``UNPORTED`` lists the option values whose branch the port does not hold
yet; ``check_ported`` raises for them when a step is built.
``FUSED_UNPORTED`` lists the values that the fused column kernel refuses
on top of those; ``check_fused_ported`` raises for them when a fused
step is built.
"""

from typing import NamedTuple


class Options(NamedTuple):
    """Static physics options.  Defaults follow the reference's suggested
    values (core/module_noahmp_global.f90 comments)."""

    # dynamic vegetation: 1 off (fveg=SHDFAC), 2 on (needs crs=1),
    # 3 off (fveg from LAI), 4/5 off (fveg=SHDMAX; 5 also runs carbon)
    veg: int = 4
    # canopy stomatal resistance: 1 Ball-Berry, 2 Jarvis
    crs: int = 1
    # soil-moisture stress for transpiration: 1 Noah, 2 CLM, 3 SSiB
    btr: int = 1
    # runoff & groundwater: 1 SIMGM (TOPMODEL+aquifer), 2 SIMTOP
    # (equilibrium water table), 3 Schaake96, 4 BATS
    run: int = 1
    # surface exchange coefficients: 1 Monin-Obukhov, 2 Chen97
    sfc: int = 1
    # supercooled liquid water: 1 Niu-Yang06 closed form, 2 Koren99 iteration
    frz: int = 1
    # frozen-soil permeability: 1 linear (NY06), 2 nonlinear (Koren99)
    inf: int = 1
    # canopy radiative transfer gaps: 1 3-D structure, 2 none, 3 1-fveg
    rad: int = 1
    # snow albedo: 1 BATS, 2 CLASS
    alb: int = 2
    # rain/snow partition: 1 Jordan91, 2 BATS (T<Tfrz+2.2), 3 T<Tfrz
    snf: int = 1
    # soil temperature lower BC: 1 zero flux, 2 TBOT at ZBOT
    tbot: int = 2
    # snow/soil temperature time scheme for layer 1: 1 semi-implicit,
    # 2 fully implicit
    stc: int = 1


DEFAULT_OPTIONS = Options()


# Option values whose physics the port does not hold yet.  A step built
# with one of them raises; it never runs another branch in its place.
UNPORTED = {
    "veg": {2: "dynamic vegetation (physics/carbon.py)",
            5: "carbon on prescribed vegetation (physics/carbon.py)"},
}


# Option values that the eager step runs but the fused column kernel
# (kernels/column.py) does not: a fused step built with one of them
# raises.  Every other value of every option is held against the plain
# version on the card by chip_smoke.py's fused_options phase.
FUSED_UNPORTED = {}

# Every value an option can take, for the checks that walk them all.
OPTION_VALUES = {
    "veg": (1, 2, 3, 4, 5), "crs": (1, 2), "btr": (1, 2, 3),
    "run": (1, 2, 3, 4), "sfc": (1, 2), "frz": (1, 2), "inf": (1, 2),
    "rad": (1, 2, 3), "alb": (1, 2), "snf": (1, 2, 3), "tbot": (1, 2),
    "stc": (1, 2),
}


def _missing(opts: Options, table: dict) -> list:
    return [f"opt_{name}={getattr(opts, name)}: {values[getattr(opts, name)]}"
            for name, values in table.items()
            if getattr(opts, name) in values]


def check_ported(opts: Options) -> None:
    """Raise NotImplementedError naming every option value of ``opts``
    that the port does not implement yet."""
    missing = _missing(opts, UNPORTED)
    if missing:
        raise NotImplementedError(
            "not ported to PyTorch yet: " + "; ".join(missing))


def check_fused_ported(opts: Options) -> None:
    """Raise NotImplementedError naming every option value of ``opts``
    that the fused column kernel refuses, or that is no value of its
    option at all (the kernel branches on the numbers it is given)."""
    unknown = [f"opt_{name}={getattr(opts, name)}"
               for name, values in OPTION_VALUES.items()
               if getattr(opts, name) not in values]
    if unknown:
        raise ValueError("unknown option values: " + "; ".join(unknown))
    missing = _missing(opts, FUSED_UNPORTED)
    if missing:
        raise NotImplementedError(
            "not in the fused column kernel yet: " + "; ".join(missing))


def fused_option_sets() -> list:
    """One ``Options`` per option value the fused step accepts that
    differs from the default: the default with that one value changed."""
    out = []
    for name, values in OPTION_VALUES.items():
        for v in values:
            if (v == getattr(DEFAULT_OPTIONS, name)
                    or v in UNPORTED.get(name, {})
                    or v in FUSED_UNPORTED.get(name, {})):
                continue
            out.append(DEFAULT_OPTIONS._replace(**{name: v}))
    return out
