// Thomas recurrence on register arrays.
//
// One thread solves one L-row tridiagonal system.  The function is a
// __device__ inline on plain arrays so that any kernel holding a
// column's coefficients in registers can call it: the batched solve in
// tridiag.cu and the ground and water stages of the fused column step.
//
// Operation order is that of the plain PyTorch version
// (kernels/tridiag.py:thomas_plain): p[0] = -c0/b0, q[0] = d0/b0;
// denom = b[k] + a[k]*p[k-1]; p[k] = -c[k]/denom;
// q[k] = (d[k] - a[k]*q[k-1])/denom; x[L-1] = q[L-1];
// x[k] = p[k]*x[k+1] + q[k].  a[0] and c[L-1] are never read.
// Products and sums use the round-to-nearest intrinsics so that no
// multiply-add is contracted whatever flags the including file is built
// with.
#pragma once

template <int L>
__device__ __forceinline__ void thomas_solve(const float (&a)[L],
                                             const float (&b)[L],
                                             const float (&c)[L],
                                             const float (&d)[L],
                                             float (&x)[L]) {
  float p[L];
  float q[L];
  p[0] = __fdiv_rn(-c[0], b[0]);
  q[0] = __fdiv_rn(d[0], b[0]);
#pragma unroll
  for (int k = 1; k < L; ++k) {
    const float denom = __fadd_rn(b[k], __fmul_rn(a[k], p[k - 1]));
    p[k] = __fdiv_rn(-c[k], denom);
    q[k] = __fdiv_rn(__fsub_rn(d[k], __fmul_rn(a[k], q[k - 1])), denom);
  }
  x[L - 1] = q[L - 1];
#pragma unroll
  for (int k = L - 2; k >= 0; --k) {
    x[k] = __fadd_rn(__fmul_rn(p[k], x[k + 1]), q[k]);
  }
}
