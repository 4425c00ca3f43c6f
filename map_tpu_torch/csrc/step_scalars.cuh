// A training step's AdamW scalars, read on the card from the row of the
// optimizer's (K, 8) float32 scalar buffer that the step owns (slot j of the
// K steps of one host call): [lr, wd, b1, b2, eps, bc1, bc2, 0], the layout
// of map_tpu's pack_scalars (map_tpu_torch/ops/fused_adamw.py scalar_row).
// The host writes the rows before each call, so a captured CUDA graph that
// replays the launch reads each call's lr, bc1 and bc2, not the captured
// ones. wd comes from the caller (per leaf in K1). 1 - b is one IEEE
// single-precision subtraction, as make_scalars computes it on the host, so
// adamw_math.cuh rounds as before.
#pragma once

#include "adamw_math.cuh"

namespace {

constexpr int kScalarWidth = 8;

__device__ __forceinline__ Scalars load_scalars(const float* __restrict__ row, float wd) {
  const float b1 = __ldg(row + 2), b2 = __ldg(row + 3);
  return Scalars{__ldg(row + 0), wd, b1, b2, __ldg(row + 4), __ldg(row + 5), __ldg(row + 6),
                 __fsub_rn(1.0f, b1), __fsub_rn(1.0f, b2)};
}

}  // namespace
