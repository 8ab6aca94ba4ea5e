"""Solar geometry: cosine of the solar zenith angle.

Own copy of ``noahmp_tpu/driver/solar.py`` (float64 numpy), so that
the port's forcing equals the JAX package's bit for bit.

The reference receives COSZ as forcing (core/module_noahmp_func.f90:122);
its offline driver was meant to compute it.  Standard declination +
hour-angle formula.
"""

import numpy as np


def cos_zenith(lat_rad, lon_rad, julian, yearlen=365.0):
    """cosz for fractional day-of-year ``julian`` (0 <= julian <
    yearlen, fractional part = UTC time of day).

    All args may be arrays (broadcast); returns same shape.
    """
    return cos_zenith_from(*lat_terms(lat_rad), lon_rad, julian, yearlen)


def lat_terms(lat_rad):
    """float64 ``sin(lat)`` and ``cos(lat)``: the part of the formula
    that depends on the domain alone, for ``cos_zenith_from``."""
    lat = np.asarray(lat_rad, dtype=np.float64)
    return np.sin(lat), np.cos(lat)


def cos_zenith_from(sin_lat, cos_lat, lon_rad, julian, yearlen=365.0):
    """``cos_zenith`` from precomputed float64 ``sin(lat)`` and
    ``cos(lat)`` (``lat_terms``): the same expression in the same
    order, so the same bits."""
    lon = np.asarray(lon_rad, dtype=np.float64)
    jd = np.asarray(julian, dtype=np.float64)

    frac = jd - np.floor(jd)                       # UTC day fraction
    # solar declination (Cooper 1969)
    decl = 0.409 * np.sin(2.0 * np.pi * (jd + 284.0) / yearlen)
    # hour angle: local solar time from UTC fraction + longitude
    hang = 2.0 * np.pi * (frac - 0.5) + lon
    cosz = (sin_lat * np.sin(decl)
            + cos_lat * np.cos(decl) * np.cos(hang))
    return cosz.astype(np.float32)


def julian_day(dt, ref_year=None):
    """Fractional day-of-year (0-based) of a datetime."""
    start = dt.replace(month=1, day=1, hour=0, minute=0, second=0,
                       microsecond=0)
    return (dt - start).total_seconds() / 86400.0


def year_length(year: int) -> int:
    leap = (year % 4 == 0 and year % 100 != 0) or year % 400 == 0
    return 366 if leap else 365
