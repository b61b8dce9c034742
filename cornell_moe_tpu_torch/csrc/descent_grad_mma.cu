// One ascent direction of -mu' (scaled coordinates) for every (ensemble
// member s, union b, MC draw m), with the moment contraction on the tensor
// cores: the mma instance of kernel D (C entry cmoe_descent_grad_mma), for
// Wr = (1 + q)(1 + d) <= 16.
//
// Replaces: cornell_moe_tpu/ops/pallas_kernels.py, pallas_descent_grad
//   (_descent_grad_kernel + _field_grad), whose contraction ran on the MXU.
// It computes what descent_grad.cu (the FMA instance, taken for Wr > 16)
// computes: at each draw's scaled point x the moments a = W phi over the
// Np training points, then g = x s0 - sx + sum_j beta_j P(|x - u_j|^2)
// (x - u_j) (field_grad.cuh cmoe_moment_direction).  It is one step of
// kernel A's tensor-core instance (descent_run_mma.cu) without the step:
// the same staging and contraction (field_mma.cuh) and the same field, so
// D's direction at x is the one A's kernel forms at x.
//
// Bound on the H100 (S16 B200 M128 Np512, d 2, q 4): 2.1e8 (draw, point)
//   pairs, each 2 MUFU operations (the Matern field's sqrt and exp; 0.10 ms
//   at 16 per SM per clock); the contraction, 2 Wr FLOP per pair as three
//   TF32 products, 0.04 ms of the tensor cores.  Operands: 111 MB, 98 MB of
//   them the W rows, each staged once: 0.03 ms of HBM time.
//
// Design: one block per (s, b) and MMA_WARPS warps, one draw per lane,
//   looping when M exceeds 128; the block stages its union's W rows and ws
//   once (cmoe_mma_stage) and each warp runs one contraction per 32 draws
//   (cmoe_mma_moments), then each lane forms its draw's direction and
//   writes g (S, B, d, M).  A non-finite W or beta gives a non-finite g
//   where the plain version's is: a NaN W row stays in its moment for
//   every draw of the block, and a NaN beta in its draw's union term.
//   Instances: (d, q) = (2, 4) with compile-time bounds, and a generic one
//   for any Wr <= 16 (d, q <= 7); each for both fields.  Any M and Np while
//   the staged operands fit one block (cmoe_descent_run_mma_smem_bytes: the
//   layout is A's).

#include "field_mma.cuh"

template <int DT, int QT, int KERN>
__global__ void __launch_bounds__(MMA_WARPS * 32, DT > 0 ? 5 : 4)
    cmoe_descent_grad_mma_kernel(
        const float* __restrict__ xs, const float* __restrict__ ws,
        const float* __restrict__ wt, const float* __restrict__ beta,
        const float* __restrict__ z, const float* __restrict__ us,
        float* __restrict__ out, int B, int d_rt, int M, int Np, int q_rt) {
  constexpr int DA = DT > 0 ? DT : MMA_MAXD;
  constexpr int QA = QT > 0 ? QT : MMA_MAXQ;
  const int d = DT > 0 ? DT : d_rt;
  const int q = QT > 0 ? QT : q_rt;
  const int wr = (1 + q) * (1 + d);
  const int np8 = (Np + 7) / 8 * 8;
  const int ldw = cmoe_mma_ldw(np8);

  extern __shared__ __align__(16) float smem[];
  float* sw = smem;                        // (Wr, ldw) W rows
  float* sws = sw + wr * ldw;              // (d, np8) ws
  float* sus = sws + d * np8;              // (q, d) union points
  float* sab = sus + MMA_UQ;               // (warps, Wr, MMA_ABUF)
  const int sb = blockIdx.x;               // s * B + b

  cmoe_mma_stage(sw, sws, sus, ws, wt, us, sb / B, sb, d, q, wr, Np, np8,
                 ldw);
  const CmoeMmaWarp w = cmoe_mma_warp(sw, sws, sab, wr, ldw);
  const int warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  for (int base = warp * 32; base < M; base += nwarps * 32) {
    const int m = base + w.lane;           // this lane's draw
    float x[DA], bz[QA], zz[QA], a[MMA_ROWS], g[DA];
    cmoe_load_draw<DA, QA>(xs, beta, z, sb, d, q, M, m < M ? m : M - 1, x,
                           bz, zz);
    cmoe_mma_moments<DA, KERN>(w, x, d, wr, np8, a);
    cmoe_moment_direction<DA, QA>(a, x, d, q, bz, zz, sus, KERN, g);
    if (m < M) {
#pragma unroll
      for (int dd = 0; dd < DA; ++dd)
        if (dd < d) out[((size_t)sb * d + dd) * M + m] = g[dd];
    }
  }
}

template <int DT, int QT, int KERN>
static int launch_grad_mma(const float* xs, const float* ws, const float* wt,
                           const float* beta, const float* z, const float* us,
                           float* out, int S, int B, int d, int M, int Np,
                           int q, cudaStream_t stream) {
  const size_t smem = cmoe_mma_smem_bytes(d, q, Np);
  const int err =
      cmoe_field_smem(cmoe_descent_grad_mma_kernel<DT, QT, KERN>, smem);
  if (err != (int)cudaSuccess) return err;
  cmoe_descent_grad_mma_kernel<DT, QT, KERN>
      <<<S * B, 32 * cmoe_mma_warps(M), smem, stream>>>(xs, ws, wt, beta, z,
                                                        us, out, B, d, M, Np,
                                                        q);
  return (int)cudaGetLastError();
}

template <int DT, int QT>
static int launch_grad_mma_field(const float* xs, const float* ws,
                                 const float* wt, const float* beta,
                                 const float* z, const float* us, float* out,
                                 int S, int B, int d, int M, int Np, int q,
                                 int kernel, cudaStream_t st) {
  if (kernel == 1)
    return launch_grad_mma<DT, QT, 1>(xs, ws, wt, beta, z, us, out, S, B, d,
                                      M, Np, q, st);
  return launch_grad_mma<DT, QT, 0>(xs, ws, wt, beta, z, us, out, S, B, d, M,
                                    Np, q, st);
}

extern "C" int cmoe_descent_grad_mma(const float* xs, const float* ws,
                                     const float* wt, const float* beta,
                                     const float* z, const float* us,
                                     float* out, int S, int B, int d, int M,
                                     int Np, int q, int wr, int kernel,
                                     void* stream) {
  if (wr != (1 + q) * (1 + d) || wr > MMA_ROWS || d < 1 || q < 1 || M < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (d == 2 && q == 4)
    return launch_grad_mma_field<2, 4>(xs, ws, wt, beta, z, us, out, S, B, d,
                                       M, Np, q, kernel, st);
  return launch_grad_mma_field<0, 0>(xs, ws, wt, beta, z, us, out, S, B, d, M,
                                     Np, q, kernel, st);
}
