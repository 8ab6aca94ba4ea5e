"""Parameter tables as tensors.

Counterpart of ``noahmp_tpu/params/tables.py``.  The reference keeps
per-class parameters in Fortran module globals filled from text tables
(core/module_noahmp_veg_param.f90:19-74,
core/module_noahmp_soil_param.f90:13-28,
core/module_noahmp_gen_param.f90:12-48).  Here each table is a small
buffer of an ``nn.Module`` (``Params`` with ``veg``/``soil``/``gen``
sub-modules), so ``.to(device)`` moves the whole set; per-point lookups
are ``table[lutyp]`` gathers on the device.

Arrays are padded with a zero row at index 0 so the 1-based class
indices from the data files index directly.  Scalars are 0-d float32 or
int32 tensors: a float64 scalar would silently widen the physics.
"""

from __future__ import annotations

import os

import numpy as np
import torch
from torch import nn

from . import reader
from ..device import resolve_device

DATA_DIR = os.path.join(os.path.dirname(__file__), "data")

VEG_SCHEMES = ("USGS", "MODIFIED_IGBP_MODIS_NOAH")
SOIL_SCHEMES = ("STAS", "STAS-RUC")


class _Table(nn.Module):
    """A set of named buffers built from a dict of numpy arrays."""

    FIELDS: tuple = ()

    def __init__(self, leaves: dict):
        super().__init__()
        missing = set(self.FIELDS) - set(leaves)
        extra = set(leaves) - set(self.FIELDS)
        if missing or extra:
            raise ValueError(f"{type(self).__name__}: missing "
                             f"{sorted(missing)}, unknown {sorted(extra)}")
        for name in self.FIELDS:
            arr = np.asarray(leaves[name])
            if arr.dtype not in (np.float32, np.int32):
                raise TypeError(f"{type(self).__name__}.{name} is "
                                f"{arr.dtype}, needs float32 or int32")
            self.register_buffer(name, torch.from_numpy(arr.copy()))

    def _asdict(self) -> dict:
        return {name: getattr(self, name) for name in self.FIELDS}


class VegParams(_Table):
    """Vegetation parameters, indexed by 1-based land-use class."""

    FIELDS = (
        "isurban",
        "iswater",
        "isbarren",
        "isice",
        "isegblf",
        "xl",  # leaf/stem orientation index
        "rhol",  # (n, 2) leaf reflectance vis/nir
        "rhos",  # (n, 2) stem reflectance
        "taul",  # (n, 2) leaf transmittance
        "taus",  # (n, 2) stem transmittance
        "lai12m",  # (n, 12)
        "sai12m",  # (n, 12)
        "nroot",  # rooting depth in layers (int)
        "canwmxp",  # max intercepted water per LAI+SAI [mm]
        "dleaf",  # characteristic leaf dimension [m]
        "z0mvt",  # momentum roughness length [m]
        "hvt",  # canopy top [m]
        "hvb",  # canopy bottom [m]
        "den",  # stem density [m-2]
        "rcrown",  # crown radius [m]
        "cwpvt",  # canopy wind parameter
        "sla",  # single-side leaf area per kg [m2 kg-1]
        "dilefc",  # cold-stress leaf death coefficient [s-1]
        "dilefw",  # drought-stress leaf death coefficient [s-1]
        "fragr",  # fraction of growth respiration
        "ltovrc",  # leaf turnover [s-1]
        "wrrat",  # wood-to-nonwood ratio
        "wdpool",  # wood pool switch (0/1)
        "tdlef",  # leaf freezing temperature [K]
        "c3c4",  # pathway: 1 C3, 2 C4 (int)
        "rgl",  # Jarvis radiation stress parameter
        "hs",  # Jarvis VPD parameter
        "kc25",  # CO2 Michaelis-Menten at 25C [Pa]
        "akc",  # Q10 for kc25
        "ko25",  # O2 Michaelis-Menten at 25C [Pa]
        "ako",  # Q10 for ko25
        "vcmx25",  # max carboxylation at 25C [umol m-2 s-1]
        "avcmx",  # Q10 for vcmx25
        "bp",  # minimum leaf conductance [umol m-2 s-1]
        "rsmax",  # maximum stomatal resistance [s m-1]
        "rsmin",  # minimum canopy resistance [s m-1]
        "mp",  # conductance-photosynthesis slope
        "qe25",  # quantum efficiency at 25C
        "aqe",  # Q10 for qe25
        "rmf25",  # leaf maintenance respiration at 25C
        "rms25",  # stem maintenance respiration at 25C
        "rmr25",  # root maintenance respiration at 25C
        "folnmx",  # foliage N concentration at f(N)=1 [%]
        "topt",  # optimum transpiration temperature [K]
        "tmin",  # min photosynthesis temperature [K]
        "arm",  # Q10 for maintenance respiration
        "mrp",  # microbial respiration parameter
        "slarea",
        "eps",  # (n, 5)
    )


class SoilParams(_Table):
    """Soil hydraulic/thermal parameters indexed by 1-based soil type,
    plus albedos indexed by 1-based soil color class."""

    FIELDS = (
        "bexp",  # Clapp-Hornberger B
        "smcmax",  # porosity [m3 m-3]
        "smcref",  # field capacity [m3 m-3]
        "smcwlt",  # wilting point [m3 m-3]
        "psisat",  # saturated matric potential [m]
        "dksat",  # saturated hydraulic conductivity [m s-1]
        "dwsat",  # saturated hydraulic diffusivity [m2 s-1]
        "quartz",  # quartz content
        "kdt",  # derived infiltration parameter
        "frzx",  # derived frozen-soil parameter
        "albsat",  # (ncolor, 2) saturated soil albedo vis/nir
        "albdry",  # (ncolor, 2) dry soil albedo vis/nir
    )


class GenParams(_Table):
    """General scalar parameters + slope table (GENPARMMP.TBL)."""

    FIELDS = (
        "slope",  # slope index by 1-based slope type
        "csoil",  # soil volumetric heat capacity [J m-3 K-1]
        "zbot",  # depth of soil temperature lower BC [m]
        "czil",  # Zilitinkevich coefficient
        "dkref",  # reference DKSAT for KDT scaling
        "kdtref",  # reference KDT
        "frzk",  # frozen-ground infiltration parameter
        "timean",  # grid-mean topographic index
        "fsatmax",  # max saturated fraction
        "mltfct",  # snowmelt factor for snow-cover fraction
        "z0sno",  # snow roughness length [m]
        "ssi",  # irreducible snow liquid saturation
        "swemax",  # fresh snow to refresh albedo [mm]
        "albice",  # (2,) land-ice albedo vis/nir
        "alblake",  # (2,) lake albedo vis/nir
        "omegas",  # (2,) two-stream snow omega vis/nir
        "betads",  # two-stream direct-beam snow parameter
        "betais",  # two-stream diffuse snow parameter
        "emssoil",  # soil emissivity
        "emslake",  # lake emissivity
    )


class Params(nn.Module):
    def __init__(self, veg: VegParams, soil: SoilParams, gen: GenParams):
        super().__init__()
        self.veg = veg
        self.soil = soil
        self.gen = gen


def _pad0(a: np.ndarray) -> np.ndarray:
    """Prepend a zero row so 1-based class indices index directly."""
    pad = np.zeros((1,) + a.shape[1:], dtype=a.dtype)
    return np.concatenate([pad, a], axis=0)


def read_veg_tables(tag: str, tbl_dir: str = DATA_DIR) -> dict:
    sec = reader.parse_sections(os.path.join(tbl_dir, "VEGPARMMP.TBL"))

    def scalar_i(name):
        return np.int32(int(reader.read_scalar(sec, f"{name}#{tag}")))

    rad = reader.read_table(sec, f"RAD#{tag}", 9)
    lai = reader.read_table(sec, f"LAI12M#{tag}", 12)
    sai = reader.read_table(sec, f"SAI12M#{tag}", 12)
    dveg = reader.read_table(sec, f"DVEG#{tag}", 8)
    phys = reader.read_table(sec, f"PHYS#{tag}", 9)
    photo = reader.read_table(sec, f"PHOTO#{tag}", 23)
    voc = reader.read_table(sec, f"VOC#{tag}", 6)

    return dict(
        isurban=scalar_i("ISURBAN"), iswater=scalar_i("ISWATER"),
        isbarren=scalar_i("ISBARREN"), isice=scalar_i("ISICE"),
        isegblf=scalar_i("ISEGBLF"),
        xl=_pad0(rad[:, 0]),
        rhol=_pad0(rad[:, 1:3]), rhos=_pad0(rad[:, 3:5]),
        taul=_pad0(rad[:, 5:7]), taus=_pad0(rad[:, 7:9]),
        lai12m=_pad0(lai), sai12m=_pad0(sai),
        nroot=_pad0(phys[:, 0].astype(np.int32)),
        canwmxp=_pad0(phys[:, 1]), dleaf=_pad0(phys[:, 2]),
        z0mvt=_pad0(phys[:, 3]), hvt=_pad0(phys[:, 4]),
        hvb=_pad0(phys[:, 5]), den=_pad0(phys[:, 6]),
        rcrown=_pad0(phys[:, 7]), cwpvt=_pad0(phys[:, 8]),
        sla=_pad0(dveg[:, 0]), dilefc=_pad0(dveg[:, 1]),
        dilefw=_pad0(dveg[:, 2]), fragr=_pad0(dveg[:, 3]),
        ltovrc=_pad0(dveg[:, 4]), wrrat=_pad0(dveg[:, 5]),
        wdpool=_pad0(dveg[:, 6]), tdlef=_pad0(dveg[:, 7]),
        c3c4=_pad0(photo[:, 0].astype(np.int32)),
        rgl=_pad0(photo[:, 1]), hs=_pad0(photo[:, 2]),
        kc25=_pad0(photo[:, 3]), akc=_pad0(photo[:, 4]),
        ko25=_pad0(photo[:, 5]), ako=_pad0(photo[:, 6]),
        vcmx25=_pad0(photo[:, 7]), avcmx=_pad0(photo[:, 8]),
        bp=_pad0(photo[:, 9]), rsmax=_pad0(photo[:, 10]),
        rsmin=_pad0(photo[:, 11]), mp=_pad0(photo[:, 12]),
        qe25=_pad0(photo[:, 13]), aqe=_pad0(photo[:, 14]),
        rmf25=_pad0(photo[:, 15]), rms25=_pad0(photo[:, 16]),
        rmr25=_pad0(photo[:, 17]), folnmx=_pad0(photo[:, 18]),
        topt=_pad0(photo[:, 19]), tmin=_pad0(photo[:, 20]),
        arm=_pad0(photo[:, 21]), mrp=_pad0(photo[:, 22]),
        slarea=_pad0(voc[:, 0]), eps=_pad0(voc[:, 1:6]),
    )


def read_soil_tables(tag: str, gen: dict,
                     tbl_dir: str = DATA_DIR,
                     frzx_compat: bool = True) -> dict:
    """Read the soil tables as numpy leaves.

    ``frzx_compat=True`` reproduces the reference's FRZX expression
    ``0.412 / 0468`` (core/module_noahmp_soil_param.f90:60) where the
    Fortran literal ``0468`` is the *integer* 468, i.e. a factor of
    0.412/468 rather than the intended 0.412/0.468.  Pass False to use
    the corrected classic-Noah value.
    """
    sec = reader.parse_sections(os.path.join(tbl_dir, "SOILPARMMP.TBL"))
    parm = reader.read_table(sec, f"PARM#{tag}", 8)
    color = reader.read_table(sec, "COLOR", 4)

    dksat = parm[:, 5]
    smcmax = parm[:, 1]
    smcref = parm[:, 2]
    kdt = np.asarray(gen["kdtref"]) * dksat / np.asarray(gen["dkref"])
    factor = 0.412 / 468.0 if frzx_compat else 0.412 / 0.468
    with np.errstate(divide="ignore", invalid="ignore"):
        frzx = np.where(smcref > 0.0,
                        np.asarray(gen["frzk"]) * (smcmax / smcref) * factor,
                        np.nan).astype(np.float32)

    return dict(
        bexp=_pad0(parm[:, 0]), smcmax=_pad0(smcmax),
        smcref=_pad0(smcref), smcwlt=_pad0(parm[:, 3]),
        psisat=_pad0(parm[:, 4]), dksat=_pad0(dksat),
        dwsat=_pad0(parm[:, 6]), quartz=_pad0(parm[:, 7]),
        kdt=_pad0(kdt.astype(np.float32)), frzx=_pad0(frzx),
        albsat=_pad0(color[:, 0:2]), albdry=_pad0(color[:, 2:4]),
    )


def read_gen_tables(tbl_dir: str = DATA_DIR) -> dict:
    sec = reader.parse_sections(os.path.join(tbl_dir, "GENPARMMP.TBL"))
    slope = reader.read_table(sec, "SLOPE", 1)[:, 0]

    def s(name):
        return np.float32(reader.read_scalar(sec, name))

    def v(name):
        return np.asarray(reader.read_vector(sec, name), np.float32)

    return dict(
        slope=_pad0(slope),
        csoil=s("CSOIL"), zbot=s("ZBOT"), czil=s("CZIL"),
        dkref=s("DKREF"), kdtref=s("KDTREF"), frzk=s("FRZK"),
        timean=s("TIMEAN"), fsatmax=s("FSATMAX"), mltfct=s("MLTFCT"),
        z0sno=s("Z0SNO"), ssi=s("SSI"), swemax=s("SWEMAX"),
        albice=v("ALBICE"), alblake=v("ALBLAKE"), omegas=v("OMEGAS"),
        betads=s("BETADS"), betais=s("BETAIS"),
        emssoil=s("EMSSOIL"), emslake=s("EMSLAKE"),
    )


def load_params(veg_scheme: str = "USGS", soil_scheme: str = "STAS",
                tbl_dir: str = DATA_DIR, frzx_compat: bool = True,
                device=None) -> Params:
    """Load all parameter tables onto ``device`` (``None``: the card)."""
    device = resolve_device(device)
    gen = read_gen_tables(tbl_dir)
    params = Params(
        veg=VegParams(read_veg_tables(veg_scheme, tbl_dir)),
        soil=SoilParams(read_soil_tables(soil_scheme, gen, tbl_dir,
                                         frzx_compat)),
        gen=GenParams(gen),
    )
    return params.to(device)
