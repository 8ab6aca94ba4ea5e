// Snowpack hydrology: snowfall, compaction, layer combine/divide and
// liquid percolation; counterpart of physics/snow.py.
//
// The pack is the plain version's fixed-shape structure: 3 slots,
// bottom-aligned (slot MSNOW-1 touches the soil; with nsnow layers the
// slots MSNOW-nsnow .. MSNOW-1 are live).  Every re-layering step is
// written as the same select over the 3 slots, so that nsnow and every
// layer value come out as the plain version's.
#pragma once

#include "column_args.cuh"
#include "common.cuh"

namespace nm {

struct Pack {
  int nsnow;
  float dz[MSNOW], ice[MSNOW], liq[MSNOW], stc[MSNOW];
  float sneqv, snowh;
  float swc0, sice0, dzsoil1;
  float ponding1, ponding2;
};

// x[i] = x[i-1] for i in [top+1, hi] (snow.py:_shift_down)
NM_INL void shift_down3(float (&x)[MSNOW], int hi, int top) {
  float r[MSNOW];
#pragma unroll
  for (int i = 0; i < MSNOW; ++i) {
    const float rolled = (i == 0) ? x[0] : x[i - 1];
    r[i] = (i >= top + 1 && i <= hi) ? rolled : x[i];
  }
#pragma unroll
  for (int i = 0; i < MSNOW; ++i) x[i] = r[i];
}

// Enthalpy-conserving merge of layer 2 into layer 1
NM_INL void combo(float dz1, float liq1, float ice1, float t1, float dz2,
                  float liq2, float ice2, float t2, float& dzc, float& liqc,
                  float& icec, float& tc) {
  dzc = dz1 + dz2;
  icec = ice1 + ice2;
  liqc = liq1 + liq2;
  const float h = (CICE * ice1 + CWAT * liq1) * (t1 - TFRZ) + HFUS * liq1;
  const float h2 = (CICE * ice2 + CWAT * liq2) * (t2 - TFRZ) + HFUS * liq2;
  const float hc = h + h2;
  const float cden = mx(CICE * icec + CWAT * liqc, MPE);
  if (hc < 0.0f) {
    tc = TFRZ + hc / cden;
  } else if (hc <= HFUS * liqc) {
    tc = TFRZ;
  } else {
    tc = TFRZ + (hc - HFUS * liqc) / cden;
  }
}

NM_INL void snowfall(Pack& p, float dt, float qsnow, float snowhin,
                    float sfctmp) {
  const int n0 = p.nsnow;
  const bool no_layer = (n0 == 0) && (qsnow > 0.0f);
  float snowh = no_layer ? p.snowh + snowhin * dt : p.snowh;
  const float sneqv = no_layer ? p.sneqv + qsnow * dt : p.sneqv;

  const bool create = no_layer && (snowh >= 0.025f);
  if (create) {
    p.dz[MSNOW - 1] = snowh;
    p.stc[MSNOW - 1] = mn(sfctmp, TTRI);
    p.ice[MSNOW - 1] = sneqv;
    p.liq[MSNOW - 1] = 0.0f;
    p.nsnow = 1;
    snowh = 0.0f;
  }

  // layered pack: add to the top layer
  const bool add = (n0 > 0) && (qsnow > 0.0f);
  const int top = MSNOW - n0;
#pragma unroll
  for (int i = 0; i < MSNOW; ++i) {
    if (add && i == top) {
      p.ice[i] = p.ice[i] + qsnow * dt;
      p.dz[i] = p.dz[i] + snowhin * dt;
    }
  }
  p.sneqv = sneqv;
  p.snowh = snowh;
}

NM_INL void compact(Pack& p, float dt, const int (&imelt3)[MSNOW],
                   const float (&ficeold)[MSNOW]) {
  const float c2 = 21.0e-3f, c3 = 2.5e-6f, c4 = 0.04f, c5 = 2.0f;
  const float dm = 100.0f, eta0 = 0.8e6f;
  const int top = MSNOW - p.nsnow;
  float burden_acc = 0.0f;
  float dz_new[MSNOW];
#pragma unroll
  for (int k = 0; k < MSNOW; ++k) {
    const bool active = k >= top;
    const float wx = p.ice[k] + p.liq[k];
    const float fice = p.ice[k] / mx(wx, MPE);
    const float dzs = mx(p.dz[k], MPE);
    const float voidf =
        1.0f - (divc(p.ice[k], DENICE) + divc(p.liq[k], DENWAT)) / dzs;

    // burden: mass of the overlying active layers (exclusive prefix)
    const float wx_act = active ? wx : 0.0f;
    burden_acc = (k == 0) ? wx_act : burden_acc + wx_act;
    const float burden = burden_acc - wx_act;

    const float bi = p.ice[k] / dzs;
    const float td = mx(TFRZ - p.stc[k], 0.0f);
    const float dexpf = expf(-c4 * td);
    float ddz1 = -c3 * dexpf;
    if (bi > dm) ddz1 = ddz1 * expf(-46.0e-3f * (bi - dm));
    if (p.liq[k] > 0.01f * dzs) ddz1 = ddz1 * c5;
    const float ddz2 =
        divc(-(burden + 0.5f * wx) * expf(-0.08f * td - c2 * bi), eta0);
    const float ddz3 =
        (imelt3[k] == 1)
            ? -mx((ficeold[k] - fice) / mx(ficeold[k], 1.0e-6f), 0.0f) / dt
            : 0.0f;
    const float pdzdtc = mx((ddz1 + ddz2 + ddz3) * dt, -0.5f);
    const bool compactable = active && (voidf > 0.001f) && (p.ice[k] > 0.1f);
    dz_new[k] = compactable ? p.dz[k] * (1.0f + pdzdtc) : p.dz[k];
  }
#pragma unroll
  for (int k = 0; k < MSNOW; ++k) p.dz[k] = dz_new[k];
}

NM_INL float dzmin_at(int m) {
  return (m >= 2) ? 0.1f : 0.025f;
}

NM_INL void combine(Pack& p) {
  const int n0 = p.nsnow;
  const int top0 = MSNOW - n0;
  int nsnow = n0;
  float sneqv = p.sneqv, snowh = p.snowh;
  float swc0 = p.swc0, sice0 = p.sice0, pond1 = p.ponding1;

#pragma unroll
  for (int pp = 0; pp < MSNOW; ++pp) {
    const int top_cur = MSNOW - nsnow;
    const bool was_active = top0 <= pp;
    const float ice_pp = p.ice[pp];
    const float liq_pp = p.liq[pp];
    const bool cond = was_active && (ice_pp <= 0.1f) && (nsnow > 0);

    if (pp != MSNOW - 1) {
      // merge into the layer below
      if (cond) {
        p.liq[pp + 1] = p.liq[pp + 1] + liq_pp;
        p.ice[pp + 1] = p.ice[pp + 1] + ice_pp;
      }
    } else {
      const bool multi = n0 > 1;
      if (cond && multi) {
        p.liq[pp - 1] = p.liq[pp - 1] + liq_pp;
        p.ice[pp - 1] = p.ice[pp - 1] + ice_pp;
      }
      // single-layer collapse
      const bool m_col = cond && !multi;
      if (m_col) {
        const bool pos = ice_pp >= 0.0f;
        const float p1_neg = liq_pp + ice_pp;
        if (pos) {
          pond1 = liq_pp;
        } else {
          pond1 = mx(p1_neg, 0.0f);
          if (p1_neg < 0.0f)
            sice0 = mx(sice0 + p1_neg / (p.dzsoil1 * 1000.0f), 0.0f);
        }
        sneqv = pos ? ice_pp : 0.0f;
        snowh = pos ? p.dz[pp] : 0.0f;
        p.liq[pp] = 0.0f;
        p.ice[pp] = 0.0f;
        p.dz[pp] = 0.0f;
      }
    }

    // shift the layers above down one slot
    if (cond && (top_cur < pp) && (nsnow >= 2)) {
      shift_down3(p.stc, pp, top_cur);
      shift_down3(p.liq, pp, top_cur);
      shift_down3(p.ice, pp, top_cur);
      shift_down3(p.dz, pp, top_cur);
    }
    if (cond) nsnow = nsnow - 1;
  }

  // conserve water after over-sublimation
  if (sice0 < 0.0f) {
    swc0 = swc0 + sice0;
    sice0 = 0.0f;
  }

  const bool multi = nsnow > 0;
  float zwice = 0.0f, zwliq = 0.0f, zdz = 0.0f;
  {
    const int top = MSNOW - nsnow;
    float ai[MSNOW], al[MSNOW], ad[MSNOW];
#pragma unroll
    for (int i = 0; i < MSNOW; ++i) {
      const bool active = i >= top;
      ai[i] = active ? p.ice[i] : 0.0f;
      al[i] = active ? p.liq[i] : 0.0f;
      ad[i] = active ? p.dz[i] : 0.0f;
    }
    zwice = sum_last(ai);
    zwliq = sum_last(al);
    zdz = sum_last(ad);
  }
  if (multi) {
    sneqv = zwice + zwliq;
    snowh = zdz;
  }

  // total collapse when too shallow
  const bool collapse = multi && (snowh < 0.025f);
  float pond2 = p.ponding2;
  if (collapse) {
    pond2 = zwliq;
    sneqv = zwice;
    if (zwice <= 0.0f) snowh = 0.0f;
    nsnow = 0;
  }

  // thin-layer combination pass
  const int n1 = nsnow;
  const int top1 = MSNOW - n1;
  int mssi = 0;
  bool exited = false;
#pragma unroll
  for (int pp = 0; pp < MSNOW; ++pp) {
    const int top_cur = MSNOW - nsnow;
    const bool was_active = (top1 <= pp) && (n1 >= 2);
    const bool thin = was_active && !exited && (p.dz[pp] < dzmin_at(mssi));

    // neighbour choice
    bool neib_above;
    if (pp == MSNOW - 1) {
      neib_above = true;
    } else {
      const float below_sum = p.dz[pp + 1] + p.dz[pp];
      const float above_sum = p.dz[(pp - 1 > 0) ? pp - 1 : 0] + p.dz[pp];
      neib_above = (top_cur != pp) && (above_sum < below_sum);
    }
    const int jj = neib_above ? pp : imin(pp + 1, MSNOW - 1);
    const int ll = neib_above ? imax(pp - 1, 0) : pp;

    if (thin) {
      float dzc, liqc, icec, tc;
      combo(vsel(p.dz, jj), vsel(p.liq, jj), vsel(p.ice, jj), vsel(p.stc, jj),
            vsel(p.dz, ll), vsel(p.liq, ll), vsel(p.ice, ll), vsel(p.stc, ll),
            dzc, liqc, icec, tc);
#pragma unroll
      for (int i = 0; i < MSNOW; ++i) {
        if (i == jj) {
          p.dz[i] = dzc;
          p.liq[i] = liqc;
          p.ice[i] = icec;
          p.stc[i] = tc;
        }
      }
      // shift above the removed slot
      if (jj - 1 > top_cur) {
        shift_down3(p.stc, jj - 1, top_cur);
        shift_down3(p.ice, jj - 1, top_cur);
        shift_down3(p.liq, jj - 1, top_cur);
        shift_down3(p.dz, jj - 1, top_cur);
      }
      nsnow = nsnow - 1;
      exited = exited || (nsnow <= 1);
    }
    if (was_active && !thin) mssi = mssi + 1;
  }

  p.nsnow = nsnow;
  p.sneqv = sneqv;
  p.snowh = snowh;
  p.swc0 = swc0;
  p.sice0 = sice0;
  p.ponding1 = pond1;
  p.ponding2 = pond2;
}

// x[idx[i]] for each slot i (numerics/select.py:vperm)
NM_INL void vperm3(const float (&x)[MSNOW], const int (&idx)[MSNOW],
                   float (&out)[MSNOW]) {
#pragma unroll
  for (int i = 0; i < MSNOW; ++i) out[i] = vsel(x, idx[i]);
}

// Split too-thick layers back up to MSNOW layers, on a top-aligned copy
NM_INL void divide(Pack& p) {
  const int n = p.nsnow;
  const int top = MSNOW - n;
  int idx[MSNOW];
#pragma unroll
  for (int i = 0; i < MSNOW; ++i) idx[i] = imin(imax(top + i, 0), MSNOW - 1);
  float dz[MSNOW], ice[MSNOW], liq[MSNOW], t[MSNOW];
  vperm3(p.dz, idx, dz);
  vperm3(p.ice, idx, ice);
  vperm3(p.liq, idx, liq);
  vperm3(p.stc, idx, t);
  int msno = n;

  // a single layer deeper than 5 cm splits in two
  const bool split1 = (msno == 1) && (dz[0] > 0.05f);
  if (split1) {
    const float half = divc(dz[0], 2.0f);
    dz[0] = half;
    dz[1] = half;
    const float ih = divc(ice[0], 2.0f);
    ice[0] = ih;
    ice[1] = ih;
    const float lh = divc(liq[0], 2.0f);
    liq[0] = lh;
    liq[1] = lh;
    t[1] = t[0];
    msno = 2;
  }

  // top layer over 5 cm with two or more layers: push the excess down
  const bool deep1 = (msno > 1) && (dz[0] > 0.05f);
  if (deep1) {
    const float drr = dz[0] - 0.05f;
    const float propor = drr / mx(dz[0], MPE);
    const float zwice = propor * ice[0];
    const float zwliq = propor * liq[0];
    const float keep = rdiv(0.05f, mx(dz[0], MPE));
    const float ice0_new = keep * ice[0];
    const float liq0_new = keep * liq[0];
    float dz2c, liq2c, ice2c, t2c;
    combo(dz[1], liq[1], ice[1], t[1], drr, zwliq, zwice, t[0], dz2c, liq2c,
          ice2c, t2c);
    dz[0] = 0.05f;
    dz[1] = dz2c;
    ice[0] = ice0_new;
    ice[1] = ice2c;
    liq[0] = liq0_new;
    liq[1] = liq2c;
    t[1] = t2c;
  }

  // subdivide layer 2 when there are only two layers and it got thick
  const bool split2 = deep1 && (msno <= 2) && (dz[1] > 0.20f);
  if (split2) {
    const float dtdz = (t[0] - t[1]) / divc(dz[0] + dz[1], 2.0f);
    const float dz2h = divc(dz[1], 2.0f);
    const float t3_try = t[1] - divc(dtdz * dz2h, 2.0f);
    const float t3_new = (t3_try >= TFRZ) ? t[1] : t3_try;
    const float t2_new =
        (t3_try >= TFRZ) ? t[1] : t[1] + divc(dtdz * dz2h, 2.0f);
    dz[1] = dz2h;
    dz[2] = dz2h;
    const float ih = divc(ice[1], 2.0f);
    ice[1] = ih;
    ice[2] = ih;
    const float lh = divc(liq[1], 2.0f);
    liq[1] = lh;
    liq[2] = lh;
    t[1] = t2_new;
    t[2] = t3_new;
    msno = 3;
  }

  // three layers: layer 2 over 20 cm pushes its excess into layer 3
  const bool deep2 = (msno > 2) && (dz[1] > 0.2f);
  if (deep2) {
    const float drr2 = dz[1] - 0.2f;
    const float prop2 = drr2 / mx(dz[1], MPE);
    const float zwice2 = prop2 * ice[1];
    const float zwliq2 = prop2 * liq[1];
    const float keep2 = rdiv(0.2f, mx(dz[1], MPE));
    float dz3c, liq3c, ice3c, t3c;
    combo(dz[2], liq[2], ice[2], t[2], drr2, zwliq2, zwice2, t[1], dz3c, liq3c,
          ice3c, t3c);
    dz[1] = 0.2f;
    dz[2] = dz3c;
    ice[1] = keep2 * ice[1];
    ice[2] = ice3c;
    liq[1] = keep2 * liq[1];
    liq[2] = liq3c;
    t[2] = t3c;
  }

  // write back bottom-aligned
  const int top_new = MSNOW - msno;
  int kc[MSNOW];
  bool valid[MSNOW];
#pragma unroll
  for (int i = 0; i < MSNOW; ++i) {
    const int k = i - top_new;
    valid[i] = k >= 0;
    kc[i] = imin(imax(k, 0), MSNOW - 1);
  }
  float dzb[MSNOW], iceb[MSNOW], liqb[MSNOW], tb[MSNOW];
  vperm3(dz, kc, dzb);
  vperm3(ice, kc, iceb);
  vperm3(liq, kc, liqb);
  vperm3(t, kc, tb);
#pragma unroll
  for (int i = 0; i < MSNOW; ++i) {
    p.dz[i] = valid[i] ? dzb[i] : 0.0f;
    p.ice[i] = valid[i] ? iceb[i] : 0.0f;
    p.liq[i] = valid[i] ? liqb[i] : 0.0f;
    p.stc[i] = valid[i] ? tb[i] : p.stc[i];
  }
  p.nsnow = msno;
}

// Sublimation/frost on the pack and gravity drainage of liquid.
// Returns qsnbot.
NM_INL float snowh2o(Pack& p, float dt, float qsnfro, float qsnsub,
                    float qrain, float ssi) {
  // no snow at all: frost/sublimation acts on the soil ice
  const bool none_ = p.sneqv == 0.0f;
  float sice0 = none_ ? p.sice0 + (qsnfro - qsnsub) * dt / (p.dzsoil1 * 1000.0f)
                      : p.sice0;
  float swc0 = (none_ && sice0 < 0.0f) ? p.swc0 + sice0 : p.swc0;
  if (none_ && sice0 < 0.0f) sice0 = 0.0f;

  // bulk shallow snow
  const bool bulk = (p.nsnow == 0) && (p.sneqv > 0.0f);
  const float temp = p.sneqv;
  float sneqv = bulk ? p.sneqv - qsnsub * dt + qsnfro * dt : p.sneqv;
  const float propor = sneqv / mx(temp, MPE);
  float snowh = bulk ? mx(propor * p.snowh, 0.0f) : p.snowh;
  const bool oversub = bulk && (sneqv < 0.0f);
  if (oversub) {
    sice0 = sice0 + sneqv / (p.dzsoil1 * 1000.0f);
    sneqv = 0.0f;
    snowh = 0.0f;
  }
  if (sice0 < 0.0f) {
    swc0 = swc0 + sice0;
    sice0 = 0.0f;
  }
  const bool tiny = (snowh <= 1.0e-8f) || (sneqv <= 1.0e-6f);
  if (tiny) {
    snowh = 0.0f;
    sneqv = 0.0f;
  }
  p.sneqv = sneqv;
  p.snowh = snowh;
  p.swc0 = swc0;
  p.sice0 = sice0;

  // deep snow: sublimation from the top layer
  const bool deep = p.nsnow > 0;
  const int top = MSNOW - p.nsnow;
  const float wgdif = vsel(p.ice, top) - qsnsub * dt + qsnfro * dt;
#pragma unroll
  for (int i = 0; i < MSNOW; ++i)
    if (deep && i == top) p.ice[i] = wgdif;
  // the top layer lost its ice: combine again
  if (deep && (wgdif < 1.0e-6f)) combine(p);

  const bool deep2 = p.nsnow > 0;
  const int top2 = MSNOW - p.nsnow;
  const float liq_top = mx(vsel(p.liq, top2) + qrain * dt, 0.0f);
#pragma unroll
  for (int i = 0; i < MSNOW; ++i)
    if (deep2 && i == top2) p.liq[i] = liq_top;

  // percolation, top to bottom
  float vol_ice[MSNOW], epore[MSNOW], vol_liq[MSNOW];
#pragma unroll
  for (int j = 0; j < MSNOW; ++j) {
    const float dzs = mx(p.dz[j], MPE);
    vol_ice[j] = mn(p.ice[j] / (dzs * DENICE), 1.0f);
    epore[j] = 1.0f - vol_ice[j];
    vol_liq[j] = mn(epore[j], p.liq[j] / (dzs * DENWAT));
  }
  float qin = 0.0f, qout = 0.0f;
#pragma unroll
  for (int j = 0; j < MSNOW; ++j) {
    const bool act = j >= top2;
    float liq_j = p.liq[j] + (act ? qin : 0.0f);
    float qo = mx((vol_liq[j] - ssi * epore[j]) * p.dz[j], 0.0f);
    if (j < MSNOW - 1) {
      const bool blocked = (epore[j] < 0.05f) || (epore[j + 1] < 0.05f);
      qo = mn(qo, (1.0f - vol_ice[j + 1] - vol_liq[j + 1]) * p.dz[j + 1]);
      if (blocked) qo = 0.0f;
    }
    qo = qo * 1000.0f;
    liq_j = liq_j - (act ? qo : 0.0f);
    if (act) {
      p.liq[j] = liq_j;
      qout = qo;
      qin = qo;
    }
  }
  return qout / dt;
}

}  // namespace nm
