// Shared device helpers of the cornell_moe_tpu_torch kernels.
//
// Kernel codes (ops/kernels.py KERNEL_CODES): 0 = Matern nu=5/2,
// 1 = squared exponential.  Fields are amplitude-free functions of the
// squared scaled distance s (models/covariance.py):
//   unit_f0(s) = k(s) / alpha
//   unit_p(s)  = -2 dF0/ds / (alpha * p_scale), p_scale = 5/3 (Matern), 1 (SE)
#pragma once

#include <cuda_runtime.h>

#define CMOE_SQRT5 2.2360679774997896f
#define CMOE_SQRT5_F64 2.23606797749978969641

__device__ __forceinline__ float cmoe_unit_f0(float s, int kernel) {
  if (kernel == 1) return expf(-0.5f * s);
  const float r = sqrtf(s);
  return (1.0f + CMOE_SQRT5 * r + (5.0f / 3.0f) * s) * expf(-CMOE_SQRT5 * r);
}

// The same field in float64 (kernel B's float64 instance).
__device__ __forceinline__ double cmoe_unit_f0(double s, int kernel) {
  if (kernel == 1) return exp(-0.5 * s);
  const double r = sqrt(s);
  return (1.0 + CMOE_SQRT5_F64 * r + (5.0 / 3.0) * s) *
         exp(-CMOE_SQRT5_F64 * r);
}

__device__ __forceinline__ float cmoe_unit_p(float s, int kernel) {
  if (kernel == 1) return expf(-0.5f * s);
  const float r = sqrtf(s);
  return (1.0f + CMOE_SQRT5 * r) * expf(-CMOE_SQRT5 * r);
}
