// One ascent direction of -mu' (scaled coordinates) for every (ensemble
// member s, union b, MC draw m): the per-step route of the KG inner
// descent, where the caller takes each GD step.  The FMA instance of kernel
// D (C entry cmoe_descent_grad_fma), which ops/kernels.py takes where the
// tensor-core instance (descent_grad_mma.cu, Wr <= 16) does not fit.
//
// Replaces: cornell_moe_tpu/ops/pallas_kernels.py, pallas_descent_grad
//   (_descent_grad_kernel + _field_grad), grid (B,) with the whole (d, M)
//   block per program and the moment contraction on the MXU, vmapped over
//   the ensemble.
// At each draw's scaled point x it evaluates phi_n = P(|ws_n - x|^2) over
// the Np training points, a = W phi over the Wr moment rows
// W = c [K^-1 y | V | (those) * ws_dd], contracts the draw's normals z
// into s0 and sx and returns g = x s0 - sx + sum_j beta_j P(|x - u_j|^2)
// (x - u_j): the body of one step of descent_run.cu, without the step, the
// clamp and the averaging (the same __device__ code, field_grad.cuh).
// Bound on the H100: FMA and transcendental throughput (a sqrt and an exp
//   per training point and Wr + 3d FMAs, about 2e8 point evaluations at the
//   main path's shapes: S = 16, B = 200, M = 128, Np = 512).  Unlike
//   descent_run.cu, which stages its operands once for a whole descent,
//   each launch restages ws and this union's W rows (35 KB per block,
//   112 MB over the grid, mostly from L2) for a single field evaluation,
//   and the caller's GD step between launches goes through device memory.
// Design: one block per (s, b) (the member axis is a grid dimension where
//   the JAX package vmaps), one thread per draw (looping when M exceeds the
//   block).  ws and the W rows are staged in shared memory with coalesced
//   loads and read by every thread as broadcasts, so the restaging costs a
//   few microseconds against the field's arithmetic; dynamic shared memory
//   above 48 KB.  The contraction is full f32 FMA, not TF32.  A (d, q) =
//   (2, 4) instance with compile-time loop bounds and a generic instance
//   (d <= 8, q <= 16, Wr <= 64).  Any M and Np, no padding.

#include "field_grad.cuh"

template <int DT, int QT>
__global__ void cmoe_descent_grad_kernel(
    const float* __restrict__ xs, const float* __restrict__ ws,
    const float* __restrict__ wt, const float* __restrict__ beta,
    const float* __restrict__ z, const float* __restrict__ us,
    float* __restrict__ out, int B, int d_rt, int M, int Np, int q_rt,
    int kernel) {
  constexpr int DA = DescDims<DT, QT>::D;
  constexpr int QA = DescDims<DT, QT>::Q;
  constexpr int WA = DescDims<DT, QT>::W;
  const int d = DT > 0 ? DT : d_rt;
  const int q = QT > 0 ? QT : q_rt;
  const int wr = (1 + q) * (1 + d);

  extern __shared__ float smem[];
  const int sb = blockIdx.x;     // s * B + b
  cmoe_stage_field(smem, ws, wt, sb / B, sb, d, wr, Np);
  const float* sws = smem;             // (d, Np)
  const float* swt = smem + d * Np;    // (Wr, Np)

  float uq[QA * DA];
  cmoe_load_union<DA, QA>(us, sb, d, q, uq);
  for (int m = threadIdx.x; m < M; m += blockDim.x) {
    float x[DA], bz[QA], zz[QA], g[DA];
    cmoe_load_draw<DA, QA>(xs, beta, z, sb, d, q, M, m, x, bz, zz);
    cmoe_field_grad<DA, QA, WA>(x, sws, swt, Np, d, q, wr, bz, zz, uq,
                                kernel, g);
#pragma unroll
    for (int dd = 0; dd < DA; ++dd)
      if (dd < d) out[((size_t)sb * d + dd) * M + m] = g[dd];
  }
}

template <int DT, int QT>
static int launch_grad(const float* xs, const float* ws, const float* wt,
                       const float* beta, const float* z, const float* us,
                       float* out, int S, int B, int d, int M, int Np, int q,
                       int wr, int kernel, cudaStream_t stream) {
  const size_t smem = (size_t)(d + wr) * Np * sizeof(float);
  const int err = cmoe_field_smem(cmoe_descent_grad_kernel<DT, QT>, smem);
  if (err != (int)cudaSuccess) return err;
  cmoe_descent_grad_kernel<DT, QT><<<S * B, cmoe_field_threads(M), smem,
                                     stream>>>(xs, ws, wt, beta, z, us, out,
                                               B, d, M, Np, q, kernel);
  return (int)cudaGetLastError();
}

extern "C" int cmoe_descent_grad_fma(const float* xs, const float* ws,
                                     const float* wt, const float* beta,
                                     const float* z, const float* us,
                                     float* out, int S, int B, int d, int M,
                                     int Np, int q, int wr, int kernel,
                                     void* stream) {
  if (wr != (1 + q) * (1 + d) || d > DESC_MAXD || q > DESC_MAXQ ||
      wr > DESC_MAXW)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (d == 2 && q == 4)
    return launch_grad<2, 4>(xs, ws, wt, beta, z, us, out, S, B, d, M, Np,
                             q, wr, kernel, st);
  return launch_grad<0, 0>(xs, ws, wt, beta, z, us, out, S, B, d, M, Np, q,
                           wr, kernel, st);
}
