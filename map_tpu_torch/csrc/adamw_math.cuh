// AdamW's per-element arithmetic, shared by K1 (fused_adamw.cu, a dense
// gradient) and K7 (sparse_adamw.cu, the gradient assembled from two sorted
// streams), so that both round exactly as the plain PyTorch version
// (map_tpu_torch/ops/fused_adamw.py fused_adamw_plain):
//   mu  = b1 * mu + (1 - b1) * g
//   nu  = b2 * nu + (1 - b2) * g * g
//   upd = (mu / bc1) / (sqrt(nu / bc2) + eps) + wd * p
//   p   = p - lr * upd
// with bc = 1 - b^t computed on the host in float32 (optax.adamw's algebra,
// eps_root = 0). Every operation is an explicit round-to-nearest intrinsic
// (__fmul_rn, __fadd_rn, __fdiv_rn, __fsqrt_rn), which nvcc never contracts
// into an FMA, so the kernels round after each operation, in this order.
#pragma once

namespace {

struct Scalars {
  float lr, wd, b1, b2, eps, bc1, bc2, one_minus_b1, one_minus_b2;
};

// float minus float on the host is one IEEE single-precision subtraction, as
// XLA's `1.0 - b1` on a float32 scalar
inline Scalars make_scalars(float lr, float wd, float b1, float b2, float eps,
                            float bc1, float bc2) {
  return Scalars{lr, wd, b1, b2, eps, bc1, bc2, 1.0f - b1, 1.0f - b2};
}

__device__ __forceinline__ void adamw_elem(float& p, float& m, float& v,
                                           const float g, const Scalars& s) {
  m = __fadd_rn(__fmul_rn(s.b1, m), __fmul_rn(s.one_minus_b1, g));
  v = __fadd_rn(__fmul_rn(s.b2, v), __fmul_rn(__fmul_rn(s.one_minus_b2, g), g));
  const float m_hat = __fdiv_rn(m, s.bc1);
  const float v_hat = __fdiv_rn(v, s.bc2);
  const float upd = __fadd_rn(__fdiv_rn(m_hat, __fadd_rn(__fsqrt_rn(v_hat), s.eps)),
                              __fmul_rn(s.wd, p));
  p = __fsub_rn(p, __fmul_rn(s.lr, upd));
}

}  // namespace
