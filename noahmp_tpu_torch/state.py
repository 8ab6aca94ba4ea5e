"""State, forcing and flux containers.

Schema follows the reference's prognostic/forcing/flux enumeration
(core/module_noahmp_type.f90:10-116 and the inout list of noahmp_sflx,
core/module_noahmp_func.f90:142-171,286-295).  Counterpart of
``noahmp_tpu/state.py`` with the same field order, so the two can be
zipped leaf by leaf.  Everything is a NamedTuple of tensors with the
land-point axis first: per-point scalars are ``(n,)``, layer vectors
``(n, L)``; float32 and int32 only.

Snow/soil layer indexing: the reference indexes layers -MSNOW+1..NSOIL
with ISNOW <= 0 counting active snow layers downward.  Here combined
arrays have NLEVELS = MSNOW+NSOIL = 7 slots; python index
i = fortran_iz + MSNOW - 1.  Snow slots are 0..2 (bottom-aligned against
the soil: with ``nsnow`` active layers, slots MSNOW-nsnow..MSNOW-1 are
live), soil slots are 3..6.  ``nsnow = -ISNOW >= 0``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .constants import MSNOW, NSOIL, TFRZ
from .device import resolve_device

# Default soil layer-bottom depths [m] (classic Noah 4-layer grid used by
# the reference offline case).
DEFAULT_ZSOIL = (-0.1, -0.4, -1.0, -2.0)


class Static(NamedTuple):
    """Time-invariant per-point attributes."""
    lat: torch.Tensor      # latitude [radians]
    lutyp: torch.Tensor    # land-use class (1-based int)
    sltyp: torch.Tensor    # soil type (1-based int)
    slptyp: torch.Tensor   # slope type (1-based int)
    isc: torch.Tensor      # soil color class (1=lightest)
    ist: torch.Tensor      # surface type: 1 soil, 2 lake
    ice: torch.Tensor      # land-ice flag (1 = ice)
    zsoil: torch.Tensor    # (NSOIL,) layer-bottom depth from surface [m], <0
    shdfac: torch.Tensor   # green vegetation fraction [0-1]
    shdmax: torch.Tensor   # yearly max vegetation fraction [0-1]
    tbot: torch.Tensor     # deep soil temperature BC [K]
    zlvl: torch.Tensor     # atmospheric reference height [m]


class Forcing(NamedTuple):
    """Per-step atmospheric forcing."""
    sfctmp: torch.Tensor   # air temperature at zlvl [K]
    sfcprs: torch.Tensor   # surface pressure [Pa]
    psfc: torch.Tensor     # pressure at lowest model level [Pa]
    uu: torch.Tensor       # eastward wind [m s-1]
    vv: torch.Tensor       # northward wind [m s-1]
    q2: torch.Tensor       # specific humidity [kg kg-1]
    soldn: torch.Tensor    # downward shortwave [W m-2]
    lwdn: torch.Tensor     # downward longwave [W m-2]
    prcp: torch.Tensor     # precipitation rate [mm s-1]
    cosz: torch.Tensor     # cosine of solar zenith angle
    co2air: torch.Tensor   # CO2 partial pressure [Pa]
    o2air: torch.Tensor    # O2 partial pressure [Pa]
    foln: torch.Tensor     # foliage nitrogen [%]
    julian: torch.Tensor   # fractional day of year [0, yearlen)
    yearlen: torch.Tensor  # days in current year


class State(NamedTuple):
    """Prognostic (carried) state of one land column."""
    # canopy
    canliq: torch.Tensor   # intercepted liquid [mm]
    canice: torch.Tensor   # intercepted ice [mm]
    tv: torch.Tensor       # vegetation temperature [K]
    eah: torch.Tensor      # canopy air vapor pressure [Pa]
    tah: torch.Tensor      # canopy air temperature [K]
    fwet: torch.Tensor     # wetted/snowed canopy fraction
    lai: torch.Tensor      # leaf area index (unburied)
    sai: torch.Tensor      # stem area index (unburied)
    # surface
    tg: torch.Tensor       # ground temperature [K]
    qsfc: torch.Tensor     # surface specific humidity [kg kg-1]
    cm: torch.Tensor       # momentum exchange coefficient
    ch: torch.Tensor       # heat exchange coefficient
    # snow
    nsnow: torch.Tensor    # active snow layers (int, 0..MSNOW)
    snowh: torch.Tensor    # snow depth [m]
    sneqv: torch.Tensor    # snow water equivalent [mm]
    sneqvo: torch.Tensor   # SWE at previous step [mm]
    snice: torch.Tensor    # (MSNOW,) snow layer ice [mm]
    snliq: torch.Tensor    # (MSNOW,) snow layer liquid [mm]
    zsnso: torch.Tensor    # (NLEVELS,) layer-bottom depth from snow surface [m]
    albold: torch.Tensor   # previous snow albedo (CLASS scheme)
    tauss: torch.Tensor    # non-dimensional snow age
    ficeold: torch.Tensor  # (MSNOW,) snow ice fraction at previous step
    qsnow: torch.Tensor    # snowfall rate on ground [mm s-1]
    # soil
    stc: torch.Tensor      # (NLEVELS,) snow/soil temperature [K]
    swc: torch.Tensor      # (NSOIL,) liquid soil water [m3 m-3] ("soilwat")
    smc: torch.Tensor      # (NSOIL,) total soil water [m3 m-3]
    # groundwater
    zwt: torch.Tensor      # water table depth [m]
    wa: torch.Tensor       # aquifer storage [mm]
    wt: torch.Tensor       # aquifer + saturated-soil storage [mm]
    wslake: torch.Tensor   # lake water storage [mm]
    # carbon pools
    lfmass: torch.Tensor   # leaf mass [g m-2]
    rtmass: torch.Tensor   # fine-root mass [g m-2]
    stmass: torch.Tensor   # stem mass [g m-2]
    wood: torch.Tensor     # wood mass [g m-2]
    stblcp: torch.Tensor   # stable soil carbon [g m-2]
    fastcp: torch.Tensor   # fast soil carbon [g m-2]


class Flux(NamedTuple):
    """Per-step diagnostic outputs (the ~45 out-arguments of noahmp_sflx,
    core/module_noahmp_func.f90:173-278)."""
    fsa: torch.Tensor      # absorbed solar [W m-2]
    fsr: torch.Tensor      # reflected solar [W m-2]
    fira: torch.Tensor     # net LW to atmosphere [W m-2]
    fsh: torch.Tensor      # sensible heat to atmosphere [W m-2]
    fcev: torch.Tensor     # canopy evaporation heat [W m-2]
    fgev: torch.Tensor     # ground evaporation heat [W m-2]
    fctr: torch.Tensor     # transpiration heat [W m-2]
    ssoil: torch.Tensor    # ground heat flux [W m-2]
    trad: torch.Tensor     # radiative temperature [K]
    ecan: torch.Tensor     # canopy water evaporation [mm s-1]
    etran: torch.Tensor    # transpiration [mm s-1]
    edir: torch.Tensor     # soil surface evaporation [mm s-1]
    runsrf: torch.Tensor   # surface runoff [mm s-1]
    runsub: torch.Tensor   # subsurface runoff [mm s-1]
    apar: torch.Tensor     # absorbed PAR [W m-2]
    psn: torch.Tensor      # photosynthesis [umol CO2 m-2 s-1]
    sav: torch.Tensor      # solar absorbed by canopy [W m-2]
    sag: torch.Tensor      # solar absorbed by ground [W m-2]
    fsno: torch.Tensor     # snow cover fraction
    nee: torch.Tensor      # net ecosystem exchange [g m-2 s-1 CO2]
    gpp: torch.Tensor      # gross primary production [g m-2 s-1 C]
    npp: torch.Tensor      # net primary production [g m-2 s-1 C]
    fveg: torch.Tensor     # effective vegetation fraction
    albedo: torch.Tensor   # broadband surface albedo
    qsnbot: torch.Tensor   # snowpack bottom outflow [mm s-1]
    ponding: torch.Tensor  # surface ponding [mm]
    rssun: torch.Tensor    # sunlit stomatal resistance [s m-1]
    rssha: torch.Tensor    # shaded stomatal resistance [s m-1]
    bgap: torch.Tensor     # between-crown gap fraction
    wgap: torch.Tensor     # within-crown gap fraction
    tgv: torch.Tensor      # vegetated-tile ground temperature [K]
    tgb: torch.Tensor      # bare-tile ground temperature [K]
    chv: torch.Tensor      # veg-tile exchange coefficient
    chb: torch.Tensor      # bare-tile exchange coefficient
    emissi: torch.Tensor   # surface emissivity
    t2mv: torch.Tensor     # 2-m temperature, veg tile [K]
    t2mb: torch.Tensor     # 2-m temperature, bare tile [K]
    q2v: torch.Tensor      # 2-m humidity, veg tile
    q2b: torch.Tensor      # 2-m humidity, bare tile
    fpice: torch.Tensor    # snow fraction of precipitation
    # per-tile energy components (reference out-args func:252-263)
    irc: torch.Tensor      # canopy net LW [W m-2, + to atm]
    irg: torch.Tensor      # veg-tile ground net LW
    irb: torch.Tensor      # bare-tile net LW
    shc: torch.Tensor      # canopy sensible heat
    shg: torch.Tensor      # veg-tile ground sensible heat
    shb: torch.Tensor      # bare-tile sensible heat
    evc: torch.Tensor      # canopy evaporation heat
    evg: torch.Tensor      # veg-tile ground evaporation heat
    evb: torch.Tensor      # bare-tile evaporation heat
    ghv: torch.Tensor      # veg-tile ground heat flux
    ghb: torch.Tensor      # bare-tile ground heat flux
    tr: torch.Tensor       # transpiration heat
    chleaf: torch.Tensor   # leaf exchange coefficient
    chuc: torch.Tensor     # under-canopy exchange coefficient
    chv2: torch.Tensor     # 2-m exchange coefficient, veg tile
    chb2: torch.Tensor     # 2-m exchange coefficient, bare tile
    ponding1: torch.Tensor # snow-collapse ponding [mm]
    ponding2: torch.Tensor # shallow-pack collapse ponding [mm]
    # conservation diagnostics (reference aborts on |err|>0.01;
    # here returned for batched/psum checking, func:688-731)
    errwat: torch.Tensor   # water balance residual [mm]
    errsw: torch.Tensor    # shortwave budget residual [W m-2]
    erreng: torch.Tensor   # energy budget residual [W m-2]


def _rep(n, device):
    """rep(v, dtype): ``v`` broadcast over ``n`` points as a tensor on
    ``device`` (a real copy: the step may be handed these to update)."""
    def rep(v, dtype=np.float32):
        a = np.asarray(v, dtype=dtype)
        a = np.ascontiguousarray(np.broadcast_to(a, (n,) + a.shape))
        return torch.from_numpy(a).to(device)
    return rep


def init_static(n: int, *, device=None, lat=0.7, lutyp=7, sltyp=6,
                slptyp=1, isc=4, ist=1, ice=0, zsoil=DEFAULT_ZSOIL,
                shdfac=0.7, shdmax=0.8, tbot=285.0, zlvl=10.0) -> Static:
    """Build a Static container on ``device`` (``None``: the card);
    scalars broadcast over ``n`` points."""
    rep = _rep(n, resolve_device(device))
    return Static(
        lat=rep(lat), lutyp=rep(lutyp, np.int32), sltyp=rep(sltyp, np.int32),
        slptyp=rep(slptyp, np.int32), isc=rep(isc, np.int32),
        ist=rep(ist, np.int32), ice=rep(ice, np.int32),
        zsoil=rep(np.asarray(zsoil, np.float32)),
        shdfac=rep(shdfac), shdmax=rep(shdmax), tbot=rep(tbot),
        zlvl=rep(zlvl))


def init_state(n: int, *, device=None, tg=285.0, tv=285.0,
               swc=0.3, smc=0.3, stc_soil=285.0, zsoil=DEFAULT_ZSOIL,
               canliq=0.0, canice=0.0, sneqv=0.0, snowh=0.0,
               zwt=2.5, wa=4900.0, lai=2.0, sai=0.2) -> State:
    """Cold-start state.  Zero snow layers; aquifer near equilibrium
    (the reference's typical initialization for opt_run=1)."""
    rep = _rep(n, resolve_device(device))

    zsoil_arr = np.asarray(zsoil, np.float32)
    zsnso0 = np.concatenate([np.zeros(MSNOW, np.float32), zsoil_arr])
    stc0 = np.concatenate([np.full(MSNOW, TFRZ, np.float32),
                           np.full(NSOIL, stc_soil, np.float32)])
    return State(
        canliq=rep(canliq), canice=rep(canice), tv=rep(tv),
        eah=rep(1000.0), tah=rep(tv), fwet=rep(0.0),
        lai=rep(lai), sai=rep(sai),
        tg=rep(tg), qsfc=rep(0.01), cm=rep(0.01), ch=rep(0.01),
        nsnow=rep(0, np.int32), snowh=rep(snowh), sneqv=rep(sneqv),
        sneqvo=rep(sneqv),
        snice=rep(np.zeros(MSNOW)), snliq=rep(np.zeros(MSNOW)),
        zsnso=rep(zsnso0),
        albold=rep(0.65), tauss=rep(0.0),
        ficeold=rep(np.zeros(MSNOW)), qsnow=rep(0.0),
        stc=rep(stc0),
        swc=rep(np.full(NSOIL, swc)), smc=rep(np.full(NSOIL, smc)),
        zwt=rep(zwt), wa=rep(wa), wt=rep(wa), wslake=rep(0.0),
        lfmass=rep(50.0), rtmass=rep(500.0), stmass=rep(50.0),
        wood=rep(500.0), stblcp=rep(1000.0), fastcp=rep(1000.0),
    )
