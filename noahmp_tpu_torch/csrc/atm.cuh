// Atmospheric forcing pre-processing; counterpart of physics/atm.py.
#pragma once

#include "common.cuh"

namespace nm {

struct AtmOut {
  float thair, qair, eair, rhoair, qprecc, qprecl;
  float solad[2], solai[2];
  float swdown;
};

NM_INL void atm(float sfcprs, float sfctmp, float q2, float prcp,
                float soldn, float cosz, AtmOut& o) {
  // the surface pressure is its own reference pressure: thair == sfctmp
  o.thair = sfctmp * powf(sfcprs / sfcprs, F32(287.04 / 1004.64));
  o.qair = q2;
  o.eair = o.qair * sfcprs / (0.622f + 0.378f * o.qair);
  o.rhoair = (sfcprs - 0.378f * o.eair) / (RAIR * sfctmp);
  o.qprecc = 0.10f * prcp;
  o.qprecl = 0.90f * prcp;
  o.swdown = (cosz <= 0.0f) ? 0.0f : soldn;
  const float d = o.swdown * 0.7f * 0.5f;
  const float i = o.swdown * 0.3f * 0.5f;
  o.solad[0] = d;
  o.solad[1] = d;
  o.solai[0] = i;
  o.solai[1] = i;
}

}  // namespace nm
