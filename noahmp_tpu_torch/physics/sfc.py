"""Surface-layer building blocks: saturation vapor pressure, saturated
mixing ratio, Monin-Obukhov / Chen97 exchange coefficients, under-canopy
resistances, Ball-Berry stomatal conductance and Jarvis canopy resistance
(reference: core/module_noahmp_func.f90:3260-3984).  Counterpart of
``noahmp_tpu/physics/sfc.py``.

All iterative schemes are pure carry->carry updates so the calling
Newton loops can run them a fixed number of times with masked early
exit (frozen updates after convergence).  ``first`` is a Python bool:
the loops are Python ``for`` loops, so the first trip is known when the
step is built.
"""

from typing import NamedTuple

import torch

from ..constants import MPE, GRAV, KARMAN, CPAIR, RGAS, TFRZ
from ..numerics.ops import where, maximum, minimum, clip


def tdc(t):
    """Kelvin -> Celsius clamped to [-50, 50] (reference func:2688)."""
    return clip(t - TFRZ, -50.0, 50.0)


# 6th-order polynomials over water/ice (reference func:3692-3736)
_ESW = (6.107799961, 4.436518521e-1, 1.428945805e-2, 2.650648471e-4,
        3.031240396e-6, 2.034080948e-8, 6.136820929e-11)
_ESI = (6.109177956, 5.034698970e-1, 1.886013408e-2, 4.176223716e-4,
        5.824720280e-6, 4.838803174e-8, 1.838826904e-10)
_DSW = (4.438099984e-1, 2.857002636e-2, 7.938054040e-4, 1.215215065e-5,
        1.036561403e-7, 3.532421810e-10, -7.090244804e-13)
_DSI = (5.030305237e-1, 3.773255020e-2, 1.267995369e-3, 2.477563108e-5,
        3.005693132e-7, 2.158542548e-9, 7.131097725e-12)


def _poly(coefs, t):
    acc = torch.full_like(t, coefs[-1])
    for c in coefs[-2::-1]:
        acc = acc * t + c
    return 100.0 * acc


def esat(t):
    """Saturation vapor pressure + derivative over water and ice [Pa],
    t in Celsius."""
    return _poly(_ESW, t), _poly(_ESI, t), _poly(_DSW, t), _poly(_DSI, t)


def esat_t(tk):
    """(es, d(es)/dT) at temperature tk [K], picking water/ice branch."""
    t = tdc(tk)
    esw, esi, dsw, dsi = esat(t)
    warm = t > 0.0
    return where(warm, esw, esi), where(warm, dsw, dsi)


def calhum(sfctmp, sfcprs):
    """Saturated mixing ratio + d(qsat)/dT (reference func:3958-3984)."""
    a2, a3, a4 = 17.67, 273.15, 29.65
    elwv, e0, rv, eps = 2.501e6, 0.611, 461.0, 0.622
    es = e0 * torch.exp(elwv / rv * (1.0 / a3 - 1.0 / sfctmp))
    sfcprsx = sfcprs * 1.0e-3
    q2sat = eps * es / (sfcprsx - es) * 1.0e3
    dqsdt2 = (q2sat / (1.0 + q2sat)) * (a2 * (a3 - a4)) \
        / (sfctmp - a4) ** 2
    return q2sat * 1.0e-3, dqsdt2


class Sfcdif1Carry(NamedTuple):
    moz: torch.Tensor
    mozsgn: torch.Tensor   # sign-change count (int32)
    fm: torch.Tensor
    fh: torch.Tensor
    fm2: torch.Tensor
    fh2: torch.Tensor
    fv: torch.Tensor


def sfcdif1_init(like):
    z = torch.zeros_like(like)
    return Sfcdif1Carry(z, z.to(torch.int32), z, z, z, z, z + 0.1)


def sfcdif1(first: bool, carry: Sfcdif1Carry, sfctmp, rhoair, h, qair,
            zlvl, zpd, z0m, z0h, ur):
    """Monin-Obukhov exchange coefficients (reference func:3353-3508).
    ``first`` marks the first Newton iteration.
    Returns (cm, ch, ch2, new_carry)."""
    mozold = carry.moz
    dz = maximum(zlvl - zpd, MPE)
    tmpcm = torch.log(dz / z0m)
    tmpch = torch.log(dz / z0h)
    tmpcm2 = torch.log((2.0 + z0m) / z0m)
    tmpch2 = torch.log((2.0 + z0h) / z0h)

    if first:
        moz = torch.zeros_like(dz)
        moz2 = torch.zeros_like(dz)
    else:
        tvir = (1.0 + 0.61 * qair) * sfctmp
        tmp1 = KARMAN * (GRAV / tvir) * h / (rhoair * CPAIR)
        tmp1 = where(torch.abs(tmp1) <= MPE, MPE, tmp1)
        mol = -1.0 * carry.fv ** 3 / tmp1
        moz = minimum(dz / mol, 1.0)
        moz2 = minimum((2.0 + z0h) / mol, 1.0)

    mozsgn = carry.mozsgn + (mozold * moz < 0.0).to(carry.mozsgn.dtype)
    flip = mozsgn >= 2
    moz = where(flip, 0.0, moz)
    moz2 = where(flip, 0.0, moz2)
    fm = where(flip, 0.0, carry.fm)
    fh = where(flip, 0.0, carry.fh)
    fm2 = where(flip, 0.0, carry.fm2)
    fh2 = where(flip, 0.0, carry.fh2)

    def unstable(m):
        t1 = (1.0 - 16.0 * minimum(m, 0.0)) ** 0.25
        t2 = torch.log((1.0 + t1 * t1) / 2.0)
        t3 = torch.log((1.0 + t1) / 2.0)
        fmn = 2.0 * t3 + t2 - 2.0 * torch.atan(t1) + 1.5707963
        fhn = 2.0 * t2
        return fmn, fhn

    fmn_u, fhn_u = unstable(moz)
    fmn2_u, fhn2_u = unstable(moz2)
    neg = moz < 0.0
    fmnew = where(neg, fmn_u, -5.0 * moz)
    fhnew = where(neg, fhn_u, -5.0 * moz)
    fm2new = where(neg, fmn2_u, -5.0 * moz2)
    fh2new = where(neg, fhn2_u, -5.0 * moz2)

    if first:
        fm, fh, fm2, fh2 = fmnew, fhnew, fm2new, fh2new
    else:
        fm = 0.5 * (fm + fmnew)
        fh = 0.5 * (fh + fhnew)
        fm2 = 0.5 * (fm2 + fm2new)
        fh2 = 0.5 * (fh2 + fh2new)

    fh = minimum(fh, 0.9 * tmpch)
    fm = minimum(fm, 0.9 * tmpcm)
    fh2 = minimum(fh2, 0.9 * tmpch2)
    fm2 = minimum(fm2, 0.9 * tmpcm2)

    def guard(x):
        return where(torch.abs(x) <= MPE, MPE, x)

    cmfm = guard(tmpcm - fm)
    chfh = guard(tmpch - fh)
    ch2fh2 = guard(tmpch2 - fh2)
    cm = KARMAN * KARMAN / (cmfm * cmfm)
    ch = KARMAN * KARMAN / (cmfm * chfh)
    fv = ur * torch.sqrt(cm)
    ch2 = KARMAN * fv / ch2fh2

    return cm, ch, ch2, Sfcdif1Carry(moz, mozsgn, fm, fh, fm2, fh2, fv)


class Sfcdif2Carry(NamedTuple):
    akms: torch.Tensor
    akhs: torch.Tensor
    rlmo: torch.Tensor
    wstar2: torch.Tensor
    ustar: torch.Tensor


def sfcdif2(first: bool, carry: Sfcdif2Carry, z0, thz0, thlm, sfcspd,
            czil, zlm):
    """Chen97 exchange coefficients (reference func:3511-3689).
    ``akms``/``akhs`` are conductances [m s-1]; returns updated carry."""
    vkrm = 0.40
    wwst2 = 1.2 ** 2
    excm = 0.001
    btg = GRAV / 270.0
    elfc = vkrm * btg
    wold, wnew = 0.15, 0.85
    pihf = 3.14159265 / 2.0
    epsu2, epsust = 1.0e-4, 0.07
    ztmin, ztmax = -5.0, 1.0
    hpbl = 1000.0
    sqvisc = 258.2

    def pspmu(xx):
        return (-2.0 * torch.log((xx + 1.0) * 0.5)
                - torch.log((xx * xx + 1.0) * 0.5)
                + 2.0 * torch.atan(xx) - pihf)

    def psphu(xx):
        return -2.0 * torch.log((xx * xx + 1.0) * 0.5)

    zilfc = -czil * vkrm * sqvisc
    zu = z0
    rdz = 1.0 / zlm
    cxch = excm * rdz
    dthv = thlm - thz0
    du2 = maximum(sfcspd * sfcspd, epsu2)
    btgh = btg * hpbl

    if first:
        wstar2 = where(btgh * carry.akhs * dthv != 0.0,
                       wwst2 * torch.abs(btgh * carry.akhs * dthv)
                       ** (2.0 / 3.0), 0.0)
        ustar = maximum(torch.sqrt(carry.akms
                                   * torch.sqrt(du2 + wstar2)), epsust)
        rlmo = elfc * carry.akhs * dthv / ustar ** 3
    else:
        wstar2 = carry.wstar2
        ustar = carry.ustar
        rlmo = carry.rlmo

    zt = maximum(1.0e-6, torch.exp(zilfc * torch.sqrt(ustar * z0)) * z0)
    zslu = zlm + zu
    zslt = zlm + zt
    rlogu = torch.log(zslu / zu)
    rlogt = torch.log(zslt / zt)

    zetalt = maximum(zslt * rlmo, ztmin)
    rlmo = zetalt / zslt
    zetalu = zslu * rlmo
    zetau = zu * rlmo
    zetat = zt * rlmo

    # unstable (Paulson) branch
    def quarter_root(z):
        return torch.sqrt(torch.sqrt(maximum(1.0 - 16.0 * z, MPE)))

    xlu = quarter_root(zetalu)
    xlt = quarter_root(zetalt)
    xu = quarter_root(zetau)
    xt = quarter_root(zetat)
    simm_u = pspmu(xlu) - pspmu(xu) + rlogu
    simh_u = psphu(xlt) - psphu(xt) + rlogt
    # stable branch
    zetalu_s = minimum(zetalu, ztmax)
    zetalt_s = minimum(zetalt, ztmax)
    simm_s = 5.0 * zetalu_s - 5.0 * zetau + rlogu
    simh_s = 5.0 * zetalt_s - 5.0 * zetat + rlogt

    neg = rlmo < 0.0
    simm = where(neg, simm_u, simm_s)
    simh = where(neg, simh_u, simh_s)

    ustar = maximum(torch.sqrt(carry.akms * torch.sqrt(du2 + wstar2)),
                    epsust)
    ustark = ustar * vkrm
    akms = maximum(ustark / simm, cxch)
    akhs = maximum(ustark / simh, cxch)

    wstar2 = where(btgh * akhs * dthv != 0.0,
                   wwst2 * torch.abs(btgh * akhs * dthv) ** (2.0 / 3.0),
                   0.0)
    rlmn = elfc * akhs * dthv / ustar ** 3
    rlmo = rlmo * wold + rlmn * wnew
    return Sfcdif2Carry(akms, akhs, rlmo, wstar2, ustar)


def ragrb(veg, lutyp, first: bool, mozg_fhg, vai, rhoair, hg, tah, zpd,
          z0mg, z0hg, hcan, uc, z0h, fv, cwp):
    """Under-canopy aerodynamic + leaf boundary-layer resistances
    (reference func:3260-3350).  mozg_fhg = (mozg, fhg) carry."""
    _mozg_prev, fhg_prev = mozg_fhg
    if first:
        mozg = torch.zeros_like(tah)
    else:
        tmp1 = KARMAN * (GRAV / tah) * hg / (rhoair * CPAIR)
        tmp1 = where(torch.abs(tmp1) <= MPE, MPE, tmp1)
        molg = -1.0 * fv ** 3 / tmp1
        mozg = minimum((zpd - z0mg) / molg, 1.0)
    fhgnew = where(mozg < 0.0,
                   (1.0 - 15.0 * minimum(mozg, 0.0)) ** (-0.25),
                   1.0 + 4.7 * mozg)
    fhg = fhgnew if first else 0.5 * (fhg_prev + fhgnew)

    cwpc = torch.sqrt(maximum(cwp * vai * hcan * fhg, MPE))
    tmp1 = torch.exp(-cwpc * z0hg / hcan)
    tmp2 = torch.exp(-cwpc * (z0h + zpd) / hcan)
    tmprah2 = hcan * torch.exp(minimum(cwpc, 50.0)) / cwpc \
        * (tmp1 - tmp2)
    kh = maximum(KARMAN * fv * (hcan - zpd), MPE)
    rahg = tmprah2 / kh
    rawg = rahg
    tmprb = cwpc * 50.0 / (1.0 - torch.exp(-cwpc / 2.0))
    rb = tmprb * torch.sqrt(veg.dleaf[lutyp] / maximum(uc, MPE))
    return rahg, rawg, rb, (mozg, fhg)


STOMATA_TRIPS = 20


def stomata(veg, lutyp, igs, sfcprs, sfctmp, apar, tv, ea, ei, o2, co2,
            foln, btran, rb):
    """Ball-Berry stomatal resistance + photosynthesis with internal-CO2
    bisection (reference func:3739-3887).  Returns (rs [s m-1], psn)."""
    cf = sfcprs / (RGAS * sfctmp) * 1.0e6
    bp = veg.bp[lutyp]
    mp_ = veg.mp[lutyp]
    c3 = veg.c3c4[lutyp] == 1

    fnf = minimum(foln / maximum(MPE, veg.folnmx[lutyp]), 1.0)
    tc = tv - TFRZ
    ppf = 4.6 * apar
    j = ppf * veg.qe25[lutyp]
    kc = veg.kc25[lutyp] * veg.akc[lutyp] ** ((tc - 25.0) / 10.0)
    ko = veg.ko25[lutyp] * veg.ako[lutyp] ** ((tc - 25.0) / 10.0)
    awc = kc * (1.0 + o2 / ko)
    cp = 0.5 * kc / ko * o2 * 0.21
    vcmx = (veg.vcmx25[lutyp]
            / (1.0 + torch.exp((-2.2e5 + 710.0 * (tc + TFRZ))
                               / (8.314 * (tc + TFRZ))))
            * fnf * btran * veg.avcmx[lutyp] ** ((tc - 25.0) / 10.0))
    rlb = rb / cf

    def ci2ci(ci):
        wj_c3 = maximum(ci - cp, 0.0) * j / (ci + 2.0 * cp)
        wc_c3 = maximum(ci - cp, 0.0) * vcmx / (ci + awc)
        we_c3 = 0.5 * vcmx
        wj = where(c3, wj_c3, j)
        wc = where(c3, wc_c3, vcmx)
        we = where(c3, we_c3, 4000.0 * vcmx * ci / sfcprs)
        psn = minimum(minimum(wj, wc), we) * igs
        cs = maximum(co2 - 1.37 * rlb * sfcprs * psn, MPE)
        a = mp_ * psn * sfcprs * ea / (cs * ei) + bp
        b = (mp_ * psn * sfcprs / cs + bp) * rlb - 1.0
        c = -rlb
        disc = torch.sqrt(maximum(b * b - 4.0 * a * c, 0.0))
        q = where(b >= 0.0, -0.5 * (b + disc), -0.5 * (b - disc))
        rs = maximum(q / a, c / q)
        fci = maximum(cs - psn * sfcprs * 1.65 * rs, 0.0)
        return fci, rs, psn

    cierr = 5.0e-2

    z = torch.zeros_like(co2)
    cilow, cihigh, rs, psn = z, 1.5 * co2, 1.0 / bp + z, z
    done = torch.zeros_like(co2, dtype=torch.bool)
    # fixed 20 trips, frozen per point once converged: no host test of
    # the mask, which would synchronise with the card every trip
    for _ in range(STOMATA_TRIPS):
        ci = 0.5 * (cihigh + cilow)
        fci, rs_new, psn_new = ci2ci(ci)
        rs = where(done, rs, rs_new)
        psn = where(done, psn, psn_new)
        conv = ((cihigh - cilow) <= cierr) | (torch.abs(fci - ci) <= MPE)
        go_up = fci > ci
        move = ~done & ~conv
        cilow = where(move & go_up, ci, cilow)
        cihigh = where(move & ~go_up, ci, cihigh)
        done = done | conv
    rs = rs * cf

    # nighttime / out-of-season early return (func:3799-3806)
    dark = apar <= 0.0
    rs = where(dark, 1.0 / bp * cf, rs)
    psn = where(dark, 0.0, psn)
    return rs, psn


def canres(veg, lutyp, sfcprs, tv, par, eah, btran):
    """Jarvis canopy resistance (reference func:3890-3955).
    Returns (rs, psn=0)."""
    q2 = 0.622 * eah / (sfcprs - 0.378 * eah)
    q2 = q2 / (1.0 + q2)
    q2sat, _dq = calhum(tv, sfcprs)
    ff = 2.0 * par / veg.rgl[lutyp]
    rcs = clip((ff + veg.rsmin[lutyp] / veg.rsmax[lutyp])
               / (1.0 + ff), 0.0001, 1.0)
    rct = clip(1.0 - 0.0016 * (veg.topt[lutyp] - tv) ** 2,
               0.0001, 1.0)
    rcq = clip(1.0 / (1.0 + veg.hs[lutyp]
                      * maximum(0.0, q2sat - q2)), 0.01, 1.0)
    rs = veg.rsmin[lutyp] / (rcs * rct * rcq * maximum(btran, MPE))
    # reference sets psn = NaN here (unused with Jarvis); 0 is safer
    return rs, torch.zeros_like(rs)
