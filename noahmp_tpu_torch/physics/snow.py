"""Snowpack hydrology: snowfall, compaction, layer combine/divide, and
liquid percolation (reference: core/module_noahmp_func.f90:5049-5819).
Counterpart of ``noahmp_tpu/physics/snow.py``.

This is the main structural divergence from the reference: the Fortran
does data-dependent layer-count changes with in-place shifting and early
exits.  Here the pack is a fixed-shape (n, MSNOW) bottom-aligned
structure (slot MSNOW-1 touches the soil; with ``nsnow`` active layers,
slots MSNOW-nsnow .. MSNOW-1 are live) and every re-layering step is a
masked select over the 3 slots, iterated with static Python loops: the
same serial semantics per point, for all points at once.
"""

from typing import NamedTuple

import torch

from ..constants import (MSNOW, MPE, TFRZ, TTRI, CICE, CWAT,
                         HFUS, DENICE, DENWAT)
from ..numerics.ops import (where, maximum, minimum, clip, col, sum_last,
                            layer_index)
from ..numerics.select import vsel, vperm, cumsum_small

# minimum thickness per layer position for the combine pass
# (reference func:5272)
DZMIN = (0.025, 0.025, 0.1)


class Pack(NamedTuple):
    """Snowpack + first-soil-layer coupling state."""
    nsnow: torch.Tensor    # (n,) active layers (int32 0..MSNOW)
    dz: torch.Tensor       # (n, MSNOW) layer thickness [m] (0 if inactive)
    ice: torch.Tensor      # (n, MSNOW) layer ice [mm]
    liq: torch.Tensor      # (n, MSNOW) layer liquid [mm]
    stc: torch.Tensor      # (n, MSNOW) layer temperature [K]
    sneqv: torch.Tensor    # bulk SWE [mm]
    snowh: torch.Tensor    # depth [m]
    swc0: torch.Tensor     # first soil layer liquid [m3/m3]
    sice0: torch.Tensor    # first soil layer ice [m3/m3]
    dzsoil1: torch.Tensor  # first soil layer thickness [m] (constant)
    ponding1: torch.Tensor
    ponding2: torch.Tensor


def select_pack(cond, a: Pack, b: Pack) -> Pack:
    """Per point: Pack ``a`` where ``cond`` (n,), else ``b``."""
    return Pack(*(torch.where(col(cond) if x.dim() > cond.dim() else cond,
                              x, y) for x, y in zip(a, b)))


def _top(nsnow):
    return MSNOW - nsnow


def _shift_down(x, p, top):
    """x[i] = x[i-1] for i in [top+1, p] (the reference's element shift
    after removing a layer, func:5308-5315).  ``p`` is a Python int or a
    per-point index."""
    i3 = layer_index(x)
    rolled = torch.cat([x[..., :1], x[..., :-1]], dim=-1)
    hi = col(p) if torch.is_tensor(p) else p
    mask = (i3 >= col(top) + 1) & (i3 <= hi)
    return torch.where(mask, rolled, x)


def combo(dz1, liq1, ice1, t1, dz2, liq2, ice2, t2):
    """Enthalpy-conserving merge of layer 2 into layer 1
    (reference func:5536-5577)."""
    dzc = dz1 + dz2
    icec = ice1 + ice2
    liqc = liq1 + liq2
    h = (CICE * ice1 + CWAT * liq1) * (t1 - TFRZ) + HFUS * liq1
    h2 = (CICE * ice2 + CWAT * liq2) * (t2 - TFRZ) + HFUS * liq2
    hc = h + h2
    cden = maximum(CICE * icec + CWAT * liqc, MPE)
    tc = where(hc < 0.0, TFRZ + hc / cden,
               where(hc <= HFUS * liqc, TFRZ,
                     TFRZ + (hc - HFUS * liqc) / cden))
    return dzc, liqc, icec, tc


def snowfall(p: Pack, dt, qsnow, snowhin, sfctmp) -> Pack:
    """Add snowfall; create the first layer at 2.5 cm depth
    (reference func:5177-5233)."""
    i3 = layer_index(p.dz)
    no_layer = (p.nsnow == 0) & (qsnow > 0.0)
    snowh = where(no_layer, p.snowh + snowhin * dt, p.snowh)
    sneqv = where(no_layer, p.sneqv + qsnow * dt, p.sneqv)

    create = no_layer & (snowh >= 0.025)
    at_bot = col(create) & (i3 == MSNOW - 1)
    dz = where(at_bot, col(snowh), p.dz)
    stc = where(at_bot, col(minimum(TTRI, sfctmp)), p.stc)
    ice = where(at_bot, col(sneqv), p.ice)
    liq = where(at_bot, 0.0, p.liq)
    nsnow = where(create, 1, p.nsnow)
    snowh = where(create, 0.0, snowh)

    # layered pack: add to the top layer
    add = (p.nsnow > 0) & (qsnow > 0.0)
    at_top = col(add) & (i3 == col(_top(p.nsnow)))
    ice = where(at_top, ice + col(qsnow * dt), ice)
    dz = where(at_top, dz + col(snowhin * dt), dz)

    return p._replace(nsnow=nsnow, dz=dz, ice=ice, liq=liq, stc=stc,
                      sneqv=sneqv, snowh=snowh)


def compact(p: Pack, dt, imelt3, ficeold) -> Pack:
    """Snow compaction: destructive metamorphism, overburden, melt
    (reference func:5580-5677)."""
    c2, c3, c4, c5 = 21.0e-3, 2.5e-6, 0.04, 2.0
    dm, eta0 = 100.0, 0.8e6

    active = layer_index(p.dz) >= col(_top(p.nsnow))
    wx = p.ice + p.liq
    fice = p.ice / maximum(wx, MPE)
    dzs = maximum(p.dz, MPE)
    void = 1.0 - (p.ice / DENICE + p.liq / DENWAT) / dzs

    # burden: mass of overlying active layers (exclusive prefix sum)
    wx_act = where(active, wx, 0.0)
    burden = cumsum_small(wx_act) - wx_act

    bi = p.ice / dzs
    td = maximum(0.0, TFRZ - p.stc)
    dexpf = torch.exp(-c4 * td)
    ddz1 = -c3 * dexpf
    ddz1 = where(bi > dm, ddz1 * torch.exp(-46.0e-3 * (bi - dm)), ddz1)
    ddz1 = where(p.liq > 0.01 * dzs, ddz1 * c5, ddz1)
    ddz2 = -(burden + 0.5 * wx) * torch.exp(-0.08 * td - c2 * bi) / eta0
    ddz3 = where(imelt3 == 1,
                 -maximum(0.0, (ficeold - fice)
                          / maximum(1.0e-6, ficeold)) / dt,
                 0.0)
    pdzdtc = maximum(-0.5, (ddz1 + ddz2 + ddz3) * dt)
    compactable = active & (void > 0.001) & (p.ice > 0.1)
    dz = where(compactable, p.dz * (1.0 + pdzdtc), p.dz)
    return p._replace(dz=dz)


def combine(p: Pack) -> Pack:
    """Merge vanishing/thin layers (reference func:5236-5413)."""
    i3 = layer_index(p.dz)
    n0 = p.nsnow
    top0 = _top(n0)
    nsnow = n0
    dz, ice, liq, stc = p.dz, p.ice, p.liq, p.stc
    sneqv, snowh = p.sneqv, p.snowh
    swc0, sice0, pond1 = p.swc0, p.sice0, p.ponding1

    for pp in range(MSNOW):
        top_cur = _top(nsnow)
        was_active = top0 <= pp
        ice_pp = ice[..., pp]
        liq_pp = liq[..., pp]
        cond = was_active & (ice_pp <= 0.1) & (nsnow > 0)

        if pp != MSNOW - 1:
            # merge into the layer below (func:5278-5280)
            into = col(cond) & (i3 == pp + 1)
            liq = liq + where(into, col(liq_pp), 0.0)
            ice = ice + where(into, col(ice_pp), 0.0)
        else:
            multi = n0 > 1  # reference tests ISNOW_OLD < -1 (func:5282)
            into = col(cond & multi) & (i3 == pp - 1)
            liq = liq + where(into, col(liq_pp), 0.0)
            ice = ice + where(into, col(ice_pp), 0.0)
            # single-layer collapse (func:5286-5302); slot pp itself was
            # not touched by the merge above
            m_col = cond & ~multi
            pos = ice_pp >= 0.0
            pond1 = where(m_col & pos, liq_pp, pond1)
            sneqv = where(m_col, where(pos, ice_pp, 0.0), sneqv)
            snowh = where(m_col, where(pos, dz[..., pp], 0.0), snowh)
            p1_neg = liq_pp + ice_pp
            pond1 = where(m_col & ~pos, maximum(p1_neg, 0.0), pond1)
            sice0 = where(m_col & ~pos & (p1_neg < 0.0),
                          maximum(0.0, sice0 + p1_neg
                                  / (p.dzsoil1 * 1000.0)), sice0)
            here = col(m_col) & (i3 == pp)
            liq = where(here, 0.0, liq)
            ice = where(here, 0.0, ice)
            dz = where(here, 0.0, dz)

        # shift layers above down one slot (func:5308-5315)
        do_shift = col(cond & (top_cur < pp) & (nsnow >= 2))

        def sh(x):
            return torch.where(do_shift, _shift_down(x, pp, top_cur), x)

        stc = sh(stc)
        liq = sh(liq)
        ice = sh(ice)
        dz = sh(dz)
        nsnow = where(cond, nsnow - 1, nsnow)

    # conserve water after over-sublimation (func:5322-5325)
    neg = sice0 < 0.0
    swc0 = where(neg, swc0 + sice0, swc0)
    sice0 = where(neg, 0.0, sice0)

    multi = nsnow > 0
    active = i3 >= col(_top(nsnow))
    zwice = sum_last(where(active, ice, 0.0))
    zwliq = sum_last(where(active, liq, 0.0))
    sneqv = where(multi, zwice + zwliq, sneqv)
    snowh = where(multi, sum_last(where(active, dz, 0.0)), snowh)

    # total collapse when too shallow (func:5344-5350)
    collapse = multi & (snowh < 0.025)
    pond2 = where(collapse, zwliq, p.ponding2)
    sneqv = where(collapse, zwice, sneqv)
    snowh = where(collapse & (zwice <= 0.0), 0.0, snowh)
    nsnow = where(collapse, 0, nsnow)

    # thin-layer combination pass (func:5361-5411)
    n1 = nsnow
    top1 = _top(n1)
    mssi = torch.zeros_like(nsnow)
    exited = torch.zeros_like(nsnow, dtype=torch.bool)

    def dzmin_at(m):
        # DZMIN[min(m, 2)]
        return where(m >= 2, DZMIN[2], where(m == 1, DZMIN[1], DZMIN[0]))

    for pp in range(MSNOW):
        top_cur = _top(nsnow)
        was_active = (top1 <= pp) & (n1 >= 2)
        thin = was_active & ~exited & (dz[..., pp] < dzmin_at(mssi))

        # neighbor choice (func:5369-5376)
        here = torch.full_like(nsnow, pp)
        if pp == MSNOW - 1:
            neib_above = torch.ones_like(thin)
        else:
            below_sum = dz[..., pp + 1] + dz[..., pp]
            above_sum = dz[..., max(pp - 1, 0)] + dz[..., pp]
            neib_above = (top_cur != pp) & (above_sum < below_sum)
        jj = torch.where(neib_above, here,
                         torch.full_like(nsnow, min(pp + 1, MSNOW - 1)))
        ll = torch.where(neib_above,
                         torch.full_like(nsnow, max(pp - 1, 0)), here)

        dzj, liqj, icej, tj = (vsel(dz, jj), vsel(liq, jj),
                               vsel(ice, jj), vsel(stc, jj))
        dzl, liql, icel, tl = (vsel(dz, ll), vsel(liq, ll),
                               vsel(ice, ll), vsel(stc, ll))
        dzc, liqc, icec, tc = combo(dzj, liqj, icej, tj,
                                    dzl, liql, icel, tl)
        at_jj = col(thin) & (i3 == col(jj))
        dz = where(at_jj, col(dzc), dz)
        liq = where(at_jj, col(liqc), liq)
        ice = where(at_jj, col(icec), ice)
        stc = where(at_jj, col(tc), stc)

        # shift above the removed slot (func:5391-5398)
        do_shift = col(thin & (jj - 1 > top_cur))

        def sh2(x):
            return torch.where(do_shift, _shift_down(x, jj - 1, top_cur), x)

        stc = sh2(stc)
        ice = sh2(ice)
        liq = sh2(liq)
        dz = sh2(dz)
        nsnow = where(thin, nsnow - 1, nsnow)
        exited = exited | (thin & (nsnow <= 1))
        mssi = where(was_active & ~thin, mssi + 1, mssi)

    return p._replace(nsnow=nsnow, dz=dz, ice=ice, liq=liq, stc=stc,
                      sneqv=sneqv, snowh=snowh, swc0=swc0, sice0=sice0,
                      ponding1=pond1, ponding2=pond2)


def _slots(a, b, c):
    """Stack three per-point values (tensors or Python floats) into an
    (n, 3) layer vector."""
    ref = next(x for x in (a, b, c) if torch.is_tensor(x))
    return torch.stack([x if torch.is_tensor(x)
                        else torch.full_like(ref, x) for x in (a, b, c)],
                       dim=-1)


def divide(p: Pack) -> Pack:
    """Split too-thick layers back up to MSNOW layers
    (reference func:5416-5533).  Works on a top-aligned copy."""
    i3 = layer_index(p.dz)
    n = p.nsnow
    top = _top(n)
    idx = clip(col(top) + i3, 0, MSNOW - 1)
    dz = vperm(p.dz, idx)    # dz[..., 0] = top layer
    ice = vperm(p.ice, idx)
    liq = vperm(p.liq, idx)
    t = vperm(p.stc, idx)
    msno = n

    def s(v, k):
        return v[..., k]

    # single layer deeper than 5 cm -> split in two (func:5454-5466)
    split1 = (msno == 1) & (s(dz, 0) > 0.05)
    c1 = col(split1)
    half = s(dz, 0) / 2.0
    dz = where(c1, _slots(half, half, s(dz, 2)), dz)
    ice = where(c1, _slots(s(ice, 0) / 2, s(ice, 0) / 2, s(ice, 2)), ice)
    liq = where(c1, _slots(s(liq, 0) / 2, s(liq, 0) / 2, s(liq, 2)), liq)
    t = where(c1, _slots(s(t, 0), s(t, 0), s(t, 2)), t)
    msno = where(split1, 2, msno)

    # top layer > 5 cm with >=2 layers: push excess down (func:5468-5501)
    deep1 = (msno > 1) & (s(dz, 0) > 0.05)
    cd1 = col(deep1)
    drr = s(dz, 0) - 0.05
    propor = drr / maximum(s(dz, 0), MPE)
    zwice = propor * s(ice, 0)
    zwliq = propor * s(liq, 0)
    keep = 0.05 / maximum(s(dz, 0), MPE)
    ice0_new = keep * s(ice, 0)
    liq0_new = keep * s(liq, 0)
    dz2c, liq2c, ice2c, t2c = combo(s(dz, 1), s(liq, 1), s(ice, 1),
                                    s(t, 1), drr, zwliq, zwice, s(t, 0))
    dz = where(cd1, _slots(0.05, dz2c, s(dz, 2)), dz)
    ice = where(cd1, _slots(ice0_new, ice2c, s(ice, 2)), ice)
    liq = where(cd1, _slots(liq0_new, liq2c, s(liq, 2)), liq)
    t = where(cd1, _slots(s(t, 0), t2c, s(t, 2)), t)

    # subdivide layer 2 when only 2 layers and it got too thick
    split2 = deep1 & (msno <= 2) & (s(dz, 1) > 0.20)
    c2 = col(split2)
    dtdz = (s(t, 0) - s(t, 1)) / ((s(dz, 0) + s(dz, 1)) / 2.0)
    dz2h = s(dz, 1) / 2.0
    t3_try = s(t, 1) - dtdz * dz2h / 2.0
    t3_new = where(t3_try >= TFRZ, s(t, 1), t3_try)
    t2_new = where(t3_try >= TFRZ, s(t, 1), s(t, 1) + dtdz * dz2h / 2.0)
    dz = where(c2, _slots(s(dz, 0), dz2h, dz2h), dz)
    ice = where(c2, _slots(s(ice, 0), s(ice, 1) / 2, s(ice, 1) / 2), ice)
    liq = where(c2, _slots(s(liq, 0), s(liq, 1) / 2, s(liq, 1) / 2), liq)
    t = where(c2, _slots(s(t, 0), t2_new, t3_new), t)
    msno = where(split2, 3, msno)

    # 3 layers: layer 2 > 20 cm pushes excess into layer 3 (func:5504-5517)
    deep2 = (msno > 2) & (s(dz, 1) > 0.2)
    cd2 = col(deep2)
    drr2 = s(dz, 1) - 0.2
    prop2 = drr2 / maximum(s(dz, 1), MPE)
    zwice2 = prop2 * s(ice, 1)
    zwliq2 = prop2 * s(liq, 1)
    keep2 = 0.2 / maximum(s(dz, 1), MPE)
    dz3c, liq3c, ice3c, t3c = combo(s(dz, 2), s(liq, 2), s(ice, 2),
                                    s(t, 2), drr2, zwliq2, zwice2, s(t, 1))
    dz = where(cd2, _slots(s(dz, 0), 0.2, dz3c), dz)
    ice = where(cd2, _slots(s(ice, 0), keep2 * s(ice, 1), ice3c), ice)
    liq = where(cd2, _slots(s(liq, 0), keep2 * s(liq, 1), liq3c), liq)
    t = where(cd2, _slots(s(t, 0), s(t, 1), t3c), t)

    # write back bottom-aligned (func:5521-5526)
    k = i3 - col(_top(msno))       # top-aligned index for each slot
    valid = k >= 0
    kc = clip(k, 0, MSNOW - 1)
    dz_b = where(valid, vperm(dz, kc), 0.0)
    ice_b = where(valid, vperm(ice, kc), 0.0)
    liq_b = where(valid, vperm(liq, kc), 0.0)
    t_b = where(valid, vperm(t, kc), p.stc)
    return p._replace(nsnow=msno, dz=dz_b, ice=ice_b, liq=liq_b,
                      stc=t_b)


def snowh2o(p: Pack, dt, qsnfro, qsnsub, qrain, ssi) -> tuple:
    """Sublimation/frost on the pack + gravity drainage of liquid
    (reference func:5680-5819).  Returns (Pack, qsnbot)."""
    i3 = layer_index(p.dz)
    # no snow at all: frost/sublimation acts on soil ice (func:5726-5732)
    none_ = p.sneqv == 0.0
    sice0 = where(none_, p.sice0 + (qsnfro - qsnsub) * dt
                  / (p.dzsoil1 * 1000.0), p.sice0)
    swc0 = where(none_ & (sice0 < 0.0), p.swc0 + sice0, p.swc0)
    sice0 = where(none_ & (sice0 < 0.0), 0.0, sice0)

    # bulk shallow snow (func:5739-5754)
    bulk = (p.nsnow == 0) & (p.sneqv > 0.0)
    temp = p.sneqv
    sneqv = where(bulk, p.sneqv - qsnsub * dt + qsnfro * dt, p.sneqv)
    propor = sneqv / maximum(temp, MPE)
    snowh = where(bulk, maximum(0.0, propor * p.snowh), p.snowh)
    oversub = bulk & (sneqv < 0.0)
    sice0 = where(oversub, sice0 + sneqv / (p.dzsoil1 * 1000.0), sice0)
    sneqv = where(oversub, 0.0, sneqv)
    snowh = where(oversub, 0.0, snowh)
    fix = sice0 < 0.0
    swc0 = where(fix, swc0 + sice0, swc0)
    sice0 = where(fix, 0.0, sice0)

    tiny = (snowh <= 1.0e-8) | (sneqv <= 1.0e-6)
    snowh = where(tiny, 0.0, snowh)
    sneqv = where(tiny, 0.0, sneqv)

    p = p._replace(sneqv=sneqv, snowh=snowh, swc0=swc0, sice0=sice0)

    # deep snow: sublimation from the top layer (func:5763-5778)
    deep = p.nsnow > 0
    top = _top(p.nsnow)
    wgdif = vsel(p.ice, top) - qsnsub * dt + qsnfro * dt
    ice = where(col(deep) & (i3 == col(top)), col(wgdif), p.ice)
    p = p._replace(ice=ice)
    # if the top layer lost its ice, re-run combine
    need_combine = deep & (wgdif < 1.0e-6)
    p = select_pack(need_combine, combine(p), p)

    deep2 = p.nsnow > 0
    top2 = _top(p.nsnow)
    liq = where(col(deep2) & (i3 == col(top2)),
                col(maximum(0.0, vsel(p.liq, top2) + qrain * dt)), p.liq)
    p = p._replace(liq=liq)

    # percolation top -> bottom (func:5784-5814)
    active = i3 >= col(_top(p.nsnow))
    dzs = maximum(p.dz, MPE)
    vol_ice = minimum(1.0, p.ice / (dzs * DENICE))
    epore = 1.0 - vol_ice
    vol_liq = minimum(epore, p.liq / (dzs * DENWAT))

    liq_cols = [p.liq[..., j] for j in range(MSNOW)]
    qin = torch.zeros_like(p.sneqv)
    qout = torch.zeros_like(p.sneqv)
    for j in range(MSNOW):
        act = active[..., j]
        liq_j = liq_cols[j] + where(act, qin, 0.0)
        qo = maximum(0.0, (vol_liq[..., j] - ssi * epore[..., j])
                     * p.dz[..., j])
        if j < MSNOW - 1:
            blocked = (epore[..., j] < 0.05) | (epore[..., j + 1] < 0.05)
            qo = minimum(qo, (1.0 - vol_ice[..., j + 1]
                              - vol_liq[..., j + 1]) * p.dz[..., j + 1])
            qo = where(blocked, 0.0, qo)
        qo = qo * 1000.0
        liq_j = liq_j - where(act, qo, 0.0)
        liq_cols[j] = where(act, liq_j, liq_cols[j])
        qout = where(act, qo, qout)
        qin = where(act, qo, qin)

    qsnbot = qout / dt
    return p._replace(liq=torch.stack(liq_cols, dim=-1)), qsnbot
