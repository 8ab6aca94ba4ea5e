"""Geographic-domain ingestion: WRF geogrid (``geo_em.d01.nc``) fields
-> flattened land-point Static batch, plus the grid mapping to scatter
results back onto the 2-D domain.

The reference's namelist points at a geo_em file
(run/case.nml:2 ``static_parameter_file``) but never reads it; this
implements the intended ingestion using the native NetCDF backend
(classic or NetCDF-4).  Counterpart of ``noahmp_tpu/driver/geo.py``: the
Static it builds holds tensors on the device it is given.  WRF geogrid conventions: 2-D fields are
``(Time, south_north, west_east)``; monthly climatologies are
``(Time, month=12, sn, we)``; land-use metadata lives in global attrs
(``MMINLU``, ``ISWATER``, ``ISICE``, ``ISLAKE``, ``ISURBAN``).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..constants import NSOIL
from ..device import resolve_device
from ..state import Static, DEFAULT_ZSOIL
from . import netcdf


class GridMapping(NamedTuple):
    """Land-point <-> 2-D grid bookkeeping."""
    shape: Tuple[int, int]     # (south_north, west_east)
    index: np.ndarray          # flat grid index of each land point
    lat: np.ndarray            # [radians] per land point
    lon: np.ndarray            # [radians] per land point
    scheme: str                # MMINLU tag, e.g. MODIFIED_IGBP_MODIS_NOAH

    @property
    def n_points(self) -> int:
        return int(self.index.size)

    def scatter(self, values: np.ndarray, fill=np.nan) -> np.ndarray:
        """Land-point vector(s) -> full 2-D grid (extra axes trail)."""
        values = np.asarray(values)
        out = np.full(self.shape + values.shape[1:], fill,
                      dtype=values.dtype if values.dtype.kind == "f"
                      else np.float32)
        out.reshape((-1,) + values.shape[1:])[self.index] = values
        return out

    def gather(self, grid: np.ndarray) -> np.ndarray:
        """Full 2-D grid -> land-point vector (extra axes trail)."""
        grid = np.asarray(grid)
        return grid.reshape((-1,) + grid.shape[2:])[self.index]


def _squeeze_time(a: np.ndarray) -> np.ndarray:
    """Drop a leading WRF Time axis of length 1."""
    a = np.asarray(a)
    return a[0] if a.ndim >= 3 and a.shape[0] == 1 else a


def _field(ds: netcdf.NcDataset, *names: str) -> Optional[np.ndarray]:
    for nm in names:
        for key, var in ds.variables.items():
            if key.split("/")[-1].upper() == nm:
                return _squeeze_time(var.data)
    return None


def _attr(ds: netcdf.NcDataset, name: str, default=None):
    for k, v in ds.attrs.items():
        if k.upper() == name:
            if isinstance(v, (bytes, str)):
                s = v.decode() if isinstance(v, bytes) else v
                return s.strip()
            return np.asarray(v).ravel()[0]
    return default


def static_from_geo_em(path: str, *, month: int = 7,
                       zsoil=DEFAULT_ZSOIL, zlvl: float = 10.0,
                       tbot_default: float = 285.0, device=None,
                       ) -> Tuple[Static, GridMapping]:
    """Read a WRF geogrid file and build the land-point Static batch.

    ``month`` (1-12) selects the GREENFRAC climatology month used for
    ``shdfac``; ``shdmax`` is the climatology's yearly max.  Water cells
    (LANDMASK==0 or LU==ISWATER) are dropped; the returned GridMapping
    scatters results back onto the (sn, we) grid.  The Static's
    tensors are on ``device`` (``None``: the card).
    """
    device = resolve_device(device)
    ds = netcdf.read(path)

    lat2 = _field(ds, "XLAT_M", "XLAT", "LAT")
    lon2 = _field(ds, "XLONG_M", "XLONG", "LON")
    lu2 = _field(ds, "LU_INDEX", "LUTYP", "IVGTYP")
    if lat2 is None or lu2 is None:
        raise ValueError(f"{path!r} lacks XLAT_M/LU_INDEX geogrid fields")
    lat2 = np.asarray(lat2, np.float64)
    lon2 = np.asarray(lon2, np.float64) if lon2 is not None \
        else np.zeros_like(lat2)
    shape = lat2.shape
    lu = np.asarray(lu2, np.int32).ravel()

    scheme = _attr(ds, "MMINLU", "MODIFIED_IGBP_MODIS_NOAH") or \
        "MODIFIED_IGBP_MODIS_NOAH"
    iswater = int(_attr(ds, "ISWATER",
                        17 if "MODIS" in scheme.upper() else 16))
    isice = int(_attr(ds, "ISICE",
                      15 if "MODIS" in scheme.upper() else 24))
    islake = _attr(ds, "ISLAKE", None)

    landmask = _field(ds, "LANDMASK")
    if landmask is not None:
        land = np.asarray(landmask, np.float32).ravel() > 0.5
    else:
        land = lu != iswater
    land &= lu != iswater
    index = np.nonzero(land)[0]
    n = index.size
    if n == 0:
        raise ValueError(f"{path!r} has no land points")

    def take(grid2, dtype=np.float32):
        return np.asarray(grid2, dtype).reshape(
            (-1,) + np.shape(grid2)[2:])[index]

    lutyp = lu[index]

    sct = _field(ds, "SCT_DOM", "SLTYP", "ISLTYP")
    sltyp = take(sct, np.int32) if sct is not None \
        else np.full(n, 6, np.int32)
    sltyp = np.clip(sltyp, 1, None)

    slopecat = _field(ds, "SLOPECAT", "SLPTYP")
    slptyp = np.clip(take(slopecat, np.int32), 1, 9) \
        if slopecat is not None else np.ones(n, np.int32)

    scolor = _field(ds, "SOILCOLOR", "ISC", "SCB_DOM")
    isc = np.clip(take(scolor, np.int32), 1, 20) \
        if scolor is not None else np.full(n, 4, np.int32)

    soiltemp = _field(ds, "SOILTEMP", "TMN", "TBOT")
    if soiltemp is not None:
        tbot = take(soiltemp)
        tbot = np.where(tbot > 100.0, tbot, tbot_default)
    else:
        tbot = np.full(n, tbot_default, np.float32)

    greenfrac = _field(ds, "GREENFRAC", "SHDFAC12M")
    if greenfrac is not None and np.ndim(greenfrac) == 3:
        gf = np.asarray(greenfrac, np.float32).reshape(12, -1)[:, index]
        gf = np.where(gf > 1.5, gf / 100.0, gf)  # % vs fraction files
        shdfac = gf[month - 1]
        shdmax = gf.max(axis=0)
    else:
        shdfac = np.full(n, 0.7, np.float32)
        shdmax = np.full(n, 0.8, np.float32)

    ice = (lutyp == isice).astype(np.int32)
    ist = np.ones(n, np.int32)
    if islake is not None:
        ist = np.where(lutyp == int(islake), 2, ist).astype(np.int32)

    lat_pts = take(lat2)
    lon_pts = take(lon2)
    # geogrid stores degrees; accept radians if the range says so
    if np.max(np.abs(lat_pts)) > np.pi:
        lat_pts = np.deg2rad(lat_pts)
        lon_pts = np.deg2rad(lon_pts)

    def put(a, dtype=np.float32):
        a = np.ascontiguousarray(np.asarray(a, dtype))
        return torch.from_numpy(a.copy()).to(device)

    static = Static(
        lat=put(lat_pts),
        lutyp=put(lutyp, np.int32), sltyp=put(sltyp, np.int32),
        slptyp=put(slptyp, np.int32), isc=put(isc, np.int32),
        ist=put(ist, np.int32), ice=put(ice, np.int32),
        zsoil=put(np.broadcast_to(np.asarray(zsoil, np.float32),
                                  (n, NSOIL))),
        shdfac=put(shdfac), shdmax=put(shdmax),
        tbot=put(tbot),
        zlvl=put(np.full((n,), zlvl, np.float32)))
    mapping = GridMapping(shape=shape, index=index,
                          lat=np.asarray(lat_pts, np.float32),
                          lon=np.asarray(lon_pts, np.float32),
                          scheme=scheme)
    return static, mapping


def write_grid_output(path: str, mapping: GridMapping,
                      fields: Dict[str, np.ndarray],
                      attrs: Optional[Dict[str, object]] = None) -> str:
    """Scatter land-point fields (arrays or tensors on any device) onto
    the 2-D grid and write NetCDF."""
    arrays = {nm: mapping.scatter(v.detach().cpu().numpy()
                                  if isinstance(v, torch.Tensor) else v)
              for nm, v in fields.items()}
    arrays["XLAT_M"] = mapping.scatter(np.rad2deg(mapping.lat))
    arrays["XLONG_M"] = mapping.scatter(np.rad2deg(mapping.lon))
    ny, nx = mapping.shape
    a = dict(attrs or {})
    a.setdefault("MMINLU", mapping.scheme)
    return netcdf.write_classic(
        path, arrays, dims={"south_north": ny, "west_east": nx},
        attrs=a)
