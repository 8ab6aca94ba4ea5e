"""Physics option flags.

Own copy of ``noahmp_tpu/options.py``.  The reference keeps 12 integer
option switches in module globals (reference:
core/module_noahmp_global.f90:15-74).  Here they are a frozen NamedTuple
read when a step is built: each ``opt_*`` is a Python ``if``, so the step
runs only the selected branch and never dispatches on the hot path.

``UNPORTED`` lists the option values whose branch the port does not hold
yet; ``check_ported`` raises for them when a step is built.
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


def check_ported(opts: Options) -> None:
    """Raise NotImplementedError naming every option value of ``opts``
    that the port does not implement yet."""
    missing = [f"opt_{name}={getattr(opts, name)}: {values[getattr(opts, name)]}"
               for name, values in UNPORTED.items()
               if getattr(opts, name) in values]
    if missing:
        raise NotImplementedError(
            "not ported to PyTorch yet: " + "; ".join(missing))
