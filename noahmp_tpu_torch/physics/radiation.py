"""Shortwave radiation: snow age/albedo, ground albedo, the modified
two-stream canopy radiative transfer, and flux assembly
(reference: core/module_noahmp_func.f90:1598-2462).  Counterpart of
``noahmp_tpu/physics/radiation.py``.

All per-band quantities are (n, 2) tensors over the 2 bands (vis, nir),
band axis last; the direct/diffuse variants of the two-stream solve are
explicit calls.  The ``cosz <= 0`` nighttime early-return of the
reference becomes a mask applied to the outputs.
"""

from typing import NamedTuple

import torch

from ..constants import MPE, TFRZ
from ..numerics.ops import where, maximum, minimum, clip, col


class RadiationOut(NamedTuple):
    fsun: torch.Tensor     # sunlit fraction of canopy
    laisun: torch.Tensor   # sunlit LAI
    laisha: torch.Tensor   # shaded LAI
    parsun: torch.Tensor   # absorbed PAR per sunlit LAI [W m-2]
    parsha: torch.Tensor   # absorbed PAR per shaded LAI [W m-2]
    sav: torch.Tensor      # solar absorbed by canopy [W m-2]
    sag: torch.Tensor      # solar absorbed by ground [W m-2]
    fsa: torch.Tensor      # total absorbed [W m-2]
    fsr: torch.Tensor      # total reflected [W m-2]
    fsrv: torch.Tensor     # reflected by canopy [W m-2]
    fsrg: torch.Tensor     # reflected by ground [W m-2]
    bgap: torch.Tensor     # between-crown gap fraction
    wgap: torch.Tensor     # within-crown gap fraction
    albold: torch.Tensor   # updated CLASS snow albedo
    tauss: torch.Tensor    # updated snow age


def _band_sum(x):
    """vis + nir over the band axis."""
    return x[..., 0] + x[..., 1]


def snowage(gen, dt, tg, sneqvo, sneqv, tauss):
    """BATS snow age update (reference func:2008-2054)."""
    dela0 = 1.0e-6 * dt
    arg = 5.0e3 * (1.0 / TFRZ - 1.0 / tg)
    age1 = torch.exp(arg)
    age2 = torch.exp(minimum(0.0, 10.0 * arg))
    tage = age1 + age2 + 0.3
    dela = dela0 * tage
    dels = maximum(0.0, sneqv - sneqvo) / gen.swemax
    sge = (tauss + dela) * (1.0 - dels)
    tauss_new = where((sneqv <= 0.0) | (sneqv > 800.0),
                      0.0, maximum(0.0, sge))
    fage = tauss_new / (tauss_new + 1.0)
    return tauss_new, fage


def snowalb_bats(cosz, fage):
    """BATS snow albedo, (n, 2) direct + diffuse (reference func:2057-2102)."""
    c1, c2 = 0.2, 0.5
    sl = 2.0
    cf1 = (1.0 + 1.0 / sl) / (1.0 + 2.0 * sl * cosz) - 1.0 / sl
    fzen = maximum(cf1, 0.0)
    albsni = torch.stack([0.95 * (1.0 - c1 * fage),
                          0.65 * (1.0 - c2 * fage)], dim=-1)
    albsnd = albsni + 0.4 * col(fzen) * (1.0 - albsni)
    return albsnd, albsni


def snowalb_class(gen, qsnow, dt, albold):
    """CLASS snow albedo decay/refresh (reference func:2105-2151)."""
    alb = 0.55 + (albold - 0.55) * torch.exp(-0.01 * dt / 3600.0)
    alb = where(qsnow > 0.0,
                alb + minimum(qsnow * dt, gen.swemax)
                * (0.84 - alb) / gen.swemax,
                alb)
    albsnd = torch.stack([alb, alb], dim=-1)
    return albsnd, albsnd, alb


def groundalb(soil, gen, ice, ist, isc, fsno, smc0, albsnd, albsni,
              cosz, tg):
    """Ground (soil/lake + snow blend) albedo, (n, 2) direct & diffuse
    (reference func:2154-2212).  ``isc`` is an int64 index."""
    inc = maximum(0.11 - 0.40 * smc0, 0.0)
    alb_soil = minimum(soil.albsat[isc] + col(inc), soil.albdry[isc])
    alb_lake_unfrz_d = (torch.full_like(alb_soil, 0.06)
                        / col(maximum(0.01, cosz) ** 1.7 + 0.15))
    alb_lake_unfrz_i = torch.full_like(alb_soil, 0.06)
    soilpt = col(ist == 1)
    thawed = col(tg > TFRZ)
    albsod = where(soilpt, alb_soil,
                   where(thawed, alb_lake_unfrz_d, gen.alblake))
    albsoi = where(soilpt, alb_soil,
                   where(thawed, alb_lake_unfrz_i, gen.alblake))
    desert = col((ist == 1) & (isc == 9))
    albsod = where(desert, albsod + 0.10, albsod)
    albsoi = where(desert, albsoi + 0.10, albsoi)
    fs = col(fsno)
    albgrd = albsod * (1.0 - fs) + albsnd * fs
    albgri = albsoi * (1.0 - fs) + albsni * fs
    return albgrd, albgri


def _gaps(veg, gen, lutyp, cosz, vai, fveg, opt_rad: int):
    """Canopy gap probabilities (Niu-Yang 2004 modified two-stream),
    reference func:2305-2335."""
    pai = 3.14159265
    if opt_rad == 1:
        rc = maximum(veg.rcrown[lutyp], MPE)
        denfveg = -torch.log(maximum(1.0 - fveg, 0.01)) / (pai * rc ** 2)
        hd = veg.hvt[lutyp] - veg.hvb[lutyp]
        bb = 0.5 * hd
        # reference: THETAP = atan(b/R * tan(acos(cosz))), then
        # cos(THETAP) (func:2311-2317).  Only the cosine is consumed,
        # so use cos(atan(t)) = rsqrt(1+t^2) with t = b/R*tan(acos(c))
        # = b/R*sqrt(1-c^2)/c: algebraically exact and 4 fewer
        # transcendentals.
        c = clip(maximum(0.01, cosz), -1.0, 1.0)
        t = bb / rc * torch.sqrt(maximum(1.0 - c * c, 0.0)) / c
        cos_thetap = torch.rsqrt(1.0 + t * t)
        bgap = torch.exp(-denfveg * pai * rc ** 2 / cos_thetap)
        fa = vai / maximum(1.33 * pai * rc ** 3 * (bb / rc) * denfveg,
                           MPE)
        newvai = hd * fa
        wgap = (1.0 - bgap) * torch.exp(-0.5 * newvai
                                        / maximum(cosz, 0.001))
        gap = minimum(1.0 - fveg, bgap + wgap)
        kopen = torch.full_like(cosz, 0.05)
    elif opt_rad == 2:
        bgap = torch.zeros_like(fveg)
        wgap = torch.zeros_like(fveg)
        gap = torch.zeros_like(fveg)
        kopen = torch.zeros_like(fveg)
    elif opt_rad == 3:
        bgap = torch.zeros_like(fveg)
        wgap = torch.zeros_like(fveg)
        gap = 1.0 - fveg
        kopen = 1.0 - fveg
    else:
        raise ValueError(f"unknown opt_rad {opt_rad}")
    # no vegetation: fully open
    novai = vai == 0.0
    gap = where(novai, 1.0, gap)
    kopen = where(novai, 1.0, kopen)
    return gap, kopen, where(novai, 0.0, bgap), where(novai, 0.0, wgap)


def twostream(veg, gen, lutyp, direct: bool, cosz, vai, fwet, t,
              albgrd, albgri, rho, tau, fveg, gap, kopen):
    """Dickinson/Sellers two-stream with Niu-Yang gap modification,
    band-vectorized.  Returns (fab, fre, ftd, fti, frev, freg, gdir),
    each (n, 2) except gdir (n,) (reference func:2215-2462)."""
    coszi = maximum(0.001, cosz)
    chil = clip(veg.xl[lutyp], -0.4, 0.6)
    chil = where(torch.abs(chil) <= 0.01, 0.01, chil)
    phi1 = 0.5 - 0.633 * chil - 0.330 * chil * chil
    phi2 = 0.877 * (1.0 - 2.0 * phi1)
    gdir_pt = phi1 + phi2 * coszi
    ext = gdir_pt / coszi
    avmu = (1.0 - phi1 / phi2 * torch.log((phi1 + phi2) / phi1)) / phi2
    tmp0 = gdir_pt + phi2 * coszi
    tmp1 = phi1 * coszi
    # everything below carries the band axis: per-point scalars become
    # (n, 1)
    omegal = rho + tau
    gdir = col(gdir_pt)
    asu = (0.5 * omegal * gdir / col(tmp0)
           * col(1.0 - tmp1 / tmp0 * torch.log((tmp1 + tmp0) / tmp1)))
    ext = col(ext)
    avmu = col(avmu)
    chil = col(chil)
    vai = col(vai)
    fwet = col(fwet)
    gap = col(gap)
    kopen = col(kopen)
    betadl = (1.0 + avmu * ext) / (omegal * avmu * ext) * asu
    betail = 0.5 * (rho + tau + (rho - tau)
                    * ((1.0 + chil) / 2.0) ** 2) / omegal

    # snow-intercepted-canopy adjustment (func:2362-2370)
    frozen = col(t <= TFRZ)
    omega_s = gen.omegas       # (2,)
    om_frz = (1.0 - fwet) * omegal + fwet * omega_s
    betad_frz = ((1.0 - fwet) * omegal * betadl
                 + fwet * omega_s * gen.betads) / om_frz
    betai_frz = ((1.0 - fwet) * omegal * betail
                 + fwet * omega_s * gen.betais) / om_frz
    omega = where(frozen, om_frz, omegal)
    betad = where(frozen, betad_frz, betadl)
    betai = where(frozen, betai_frz, betail)

    b = 1.0 - omega + omega * betai
    c = omega * betai
    tmp0 = avmu * ext
    d = tmp0 * omega * betad
    f = tmp0 * omega * (1.0 - betad)
    tmp1 = b * b - c * c
    h = torch.sqrt(maximum(tmp1, MPE)) / avmu
    sigma = tmp0 * tmp0 - tmp1
    sigma = where(torch.abs(sigma) < 1.0e-6,
                  where(sigma >= 0, 1.0e-6, -1.0e-6), sigma)
    p1 = b + avmu * h
    p2 = b - avmu * h
    p3 = b + tmp0
    p4 = b - tmp0
    s1 = torch.exp(-minimum(h * vai, 50.0))
    s2 = torch.exp(-minimum(ext * vai, 50.0))
    albg = albgrd if direct else albgri
    u1 = b - c / maximum(albg, MPE)
    u2 = b - c * albg
    u3 = f + c * albg
    tmp2 = u1 - avmu * h
    tmp3 = u1 + avmu * h
    d1 = p1 * tmp2 / s1 - p2 * tmp3 * s1
    tmp4 = u2 + avmu * h
    tmp5 = u2 - avmu * h
    d2 = tmp4 / s1 - tmp5 * s1
    h1 = -d * p4 - c * f
    tmp6 = d - h1 * p3 / sigma
    tmp7 = (d - c - h1 / sigma * (u1 + tmp0)) * s2
    h2 = (tmp6 * tmp2 / s1 - p2 * tmp7) / d1
    h3 = -(tmp6 * tmp3 * s1 - p1 * tmp7) / d1
    h4 = -f * p3 - c * d
    tmp8 = h4 / sigma
    tmp9 = (u3 - tmp8 * (u2 - tmp0)) * s2
    h5 = -(tmp8 * tmp4 / s1 + tmp9) / d2
    h6 = (tmp8 * tmp5 * s1 + tmp9) / d2
    h7 = (c * tmp2) / (d1 * s1)
    h8 = (-c * tmp3 * s1) / d1
    h9 = tmp4 / (d2 * s1)
    h10 = (-tmp5 * s1) / d2

    if direct:
        ftd = (s2 * (1.0 - gap) + gap).expand_as(albg)
        fti = (h4 * s2 / sigma + h5 * s1 + h6 / s1) * (1.0 - gap)
        freveg = (h1 / sigma + h2 + h3) * (1.0 - gap)
        frebar = albgrd * gap
        fre = freveg + frebar
    else:
        ftd = torch.zeros_like(albg)
        fti = (h9 * s1 + h10 / s1) * (1.0 - kopen) + kopen
        fre = (h7 + h8) * (1.0 - kopen) + albgri * kopen
        freveg = fre
        frebar = torch.zeros_like(albg)

    fab = 1.0 - fre - (1.0 - albgrd) * ftd - (1.0 - albgri) * fti
    return fab, fre, ftd, fti, freveg, frebar, gdir_pt


def albedo(veg, soil, gen, lutyp, ist, isc, ice, dt, cosz, elai, esai,
           tg, tv, snowh, fsno, fwet, smc0, sneqvo, sneqv, qsnow, fveg,
           albold, tauss, opt_alb: int, opt_rad: int):
    """Surface albedo + canopy fluxes per unit incoming radiation
    (reference func:1717-1887)."""
    vai = elai + esai
    wl = col(elai / maximum(vai, MPE))
    ws = col(esai / maximum(vai, MPE))
    rho = maximum(veg.rhol[lutyp] * wl + veg.rhos[lutyp] * ws, MPE)
    tau = maximum(veg.taul[lutyp] * wl + veg.taus[lutyp] * ws, MPE)

    tauss_new, fage = snowage(gen, dt, tg, sneqvo, sneqv, tauss)

    if opt_alb == 1:
        albsnd, albsni = snowalb_bats(cosz, fage)
        albold_new = albold
    elif opt_alb == 2:
        albsnd, albsni, alb = snowalb_class(gen, qsnow, dt, albold)
        albold_new = alb
    else:
        raise ValueError(f"unknown opt_alb {opt_alb}")

    albgrd, albgri = groundalb(soil, gen, ice, ist, isc, fsno, smc0,
                               albsnd, albsni, cosz, tg)

    gap, kopen, bgap, wgap = _gaps(veg, gen, lutyp, cosz, vai, fveg,
                                   opt_rad)
    fabd, albd, ftdd, ftid, frevd, fregd, gdir = twostream(
        veg, gen, lutyp, True, cosz, vai, fwet, tv, albgrd, albgri,
        rho, tau, fveg, gap, kopen)
    fabi, albi, _ftdi, ftii, frevi, fregi, _ = twostream(
        veg, gen, lutyp, False, cosz, vai, fwet, tv, albgrd, albgri,
        rho, tau, fveg, gap, kopen)

    # sunlit canopy fraction (func:1875-1886)
    ext = gdir / maximum(cosz, 0.001) * torch.sqrt(
        maximum(1.0 - rho[..., 0] - tau[..., 0], 0.0))
    fsun = (1.0 - torch.exp(-minimum(ext * vai, 50.0))) \
        / maximum(ext * vai, MPE)
    fsun = where(fsun < 0.01, 0.0, fsun)

    # nighttime mask: zero everything computed for cosz>0 (func:1808-1823)
    day = cosz > 0
    day2 = col(day)

    def m(x):
        return where(day2, x, 0.0)

    return dict(
        albgrd=m(albgrd), albgri=m(albgri), albd=m(albd), albi=m(albi),
        fabd=m(fabd), fabi=m(fabi), ftdd=m(ftdd), ftid=m(ftid),
        ftii=m(ftii), fsun=where(day, fsun, 0.0),
        frevd=m(frevd), frevi=m(frevi), fregd=m(fregd), fregi=m(fregi),
        bgap=where(day, bgap, 0.0), wgap=where(day, wgap, 0.0),
        # snowage/snowalb are called only when cosz>0 in the reference,
        # so snow age and albedo freeze at night
        albold=where(day, albold_new, albold),
        tauss=where(day, tauss_new, tauss),
    )


def surrad(elai, vai, fsun, solad, solai, ab):
    """Assemble absorbed/reflected solar fluxes from per-unit factors
    (reference func:1890-2005).  ``ab`` is the albedo() output dict."""
    fsha = 1.0 - fsun
    laisun = elai * fsun
    laisha = elai * fsha

    cad = solad * ab["fabd"]
    cai = solai * ab["fabi"]
    sav = _band_sum(cad + cai)
    trd = solad * ab["ftdd"]
    tri = solad * ab["ftid"] + solai * ab["ftii"]
    absg = trd * (1.0 - ab["albgrd"]) + tri * (1.0 - ab["albgri"])
    sag = _band_sum(absg)
    fsa = sav + sag

    laifra = elai / maximum(vai, MPE)
    cad0 = cad[..., 0]
    cai0 = cai[..., 0]
    parsun_day = (cad0 + fsun * cai0) * laifra / maximum(laisun, MPE)
    parsha_day = (fsha * cai0) * laifra / maximum(laisha, MPE)
    parsha_night = (cad0 + cai0) * laifra / maximum(laisha, MPE)
    parsun = where(fsun > 0.0, parsun_day, 0.0)
    parsha = where(fsun > 0.0, parsha_day, parsha_night)

    fsr = _band_sum(ab["albd"] * solad + ab["albi"] * solai)
    fsrv = _band_sum(ab["frevd"] * solad + ab["frevi"] * solai)
    fsrg = _band_sum(ab["fregd"] * solad + ab["fregi"] * solai)
    return (fsun, laisun, laisha, parsun, parsha, sav, sag, fsa, fsr,
            fsrv, fsrg)


def radiation(veg, soil, gen, lutyp, ist, isc, ice, sneqvo, sneqv, dt,
              cosz, snowh, tg, tv, fsno, qsnow, fwet, elai, esai, smc0,
              solad, solai, fveg, albold, tauss,
              opt_alb: int, opt_rad: int) -> RadiationOut:
    """Radiation driver (reference func:1598-1714)."""
    ab = albedo(veg, soil, gen, lutyp, ist, isc, ice, dt, cosz, elai,
                esai, tg, tv, snowh, fsno, fwet, smc0, sneqvo, sneqv,
                qsnow, fveg, albold, tauss, opt_alb, opt_rad)
    vai = elai + esai
    (fsun, laisun, laisha, parsun, parsha, sav, sag, fsa, fsr, fsrv,
     fsrg) = surrad(elai, vai, ab["fsun"], solad, solai, ab)
    return RadiationOut(fsun, laisun, laisha, parsun, parsha, sav, sag,
                        fsa, fsr, fsrv, fsrg, ab["bgap"], ab["wgap"],
                        ab["albold"], ab["tauss"])
