// K + diag(noise) for every member of a GP ensemble.
//
// Replaces: cornell_moe_tpu/ops/pallas_kernels.py,
//   pallas_covariance_with_noise_full (_cov_full_kernel), which built one
//   (Np, Np) matrix per program in VMEM and was vmapped over the members.
// Bound on the H100: writes.  Each output element costs d subtractions, one
//   sqrt and one exp, and the S x n x n f32 output (16 x 512^2 x 4 B = 17 MB
//   at the main path's shapes) is the only traffic of any size.
// Design: a 2-D grid of 32 x 8 output tiles times S members, one element per
//   thread; neighbouring threads write neighbouring columns, so stores
//   coalesce.  Points and hyperparameters are tiny and stay in L1/L2.  No
//   padding: any n.

#include "common.cuh"

__global__ void cmoe_covariance_with_noise_kernel(
    const float* __restrict__ x, const float* __restrict__ hypers,
    const float* __restrict__ noise, float* __restrict__ out, int n, int d,
    int kernel) {
  const int s = blockIdx.z;
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= n || j >= n) return;
  const float* h = hypers + (size_t)s * (1 + d);
  float acc = 0.0f;
  for (int dd = 0; dd < d; ++dd) {
    const float diff = (x[(size_t)i * d + dd] - x[(size_t)j * d + dd]) / h[1 + dd];
    acc += diff * diff;
  }
  float v = h[0] * cmoe_unit_f0(acc, kernel);
  if (i == j) v += noise[(size_t)s * n + i];
  out[((size_t)s * n + i) * n + j] = v;
}

extern "C" int cmoe_covariance_with_noise(const float* x, const float* hypers,
                                          const float* noise, float* out,
                                          int S, int n, int d, int kernel,
                                          void* stream) {
  const dim3 block(32, 8);
  const dim3 grid((n + 31) / 32, (n + 7) / 8, S);
  cmoe_covariance_with_noise_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      x, hypers, noise, out, n, d, kernel);
  return (int)cudaGetLastError();
}
