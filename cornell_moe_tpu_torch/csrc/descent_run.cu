// The KG inner posterior-mean descent for every (ensemble member s, union b,
// MC draw m) at once, run to the end inside the kernel: the FMA instance of
// kernel A (C entry cmoe_descent_run_fma).  ops/kernels.py takes it where
// the moment rows do not fit descent_run_mma.cu's one 16-row tensor-core
// tile (Wr > 16), and descent_run_fma launches it at any shape.
//
// Replaces: cornell_moe_tpu/ops/pallas_kernels.py, pallas_descent_run
//   (_descent_run_kernel + _field_grad), one program per member looping
//   over unions, vmapped over the ensemble.
// Each step of one descent evaluates, at the draw's scaled point x,
//   a = W phi,  phi_n = P(|ws_n - x|^2) over the Np training points,
// with the moment weights W = c [K^-1 y | V | (those) * ws_dd] (Wr rows),
// contracts a with the draw's normals z into the ascent direction of -mu',
// adds the union term beta_j P(|x - u_j|^2) (x - u_j), and takes one
// LimitUpdate-clamped step at rate pre_mult (i+1)^-gamma; the last avg_n
// points of each restart round are Polyak-averaged and clipped.
// Bound on the H100: FMA and transcendental throughput (a sqrt and an exp
//   per training point, Wr + 3d FMAs per point per step; about 2.5 GFLOP
//   for a cold evaluation of the main path's ensemble); the operands are a
//   few tens of KB per block, so bytes do not matter and latency does.
// Design: one block per (s, b), one thread per draw (looping when M exceeds
//   the block).  ws and this union's W rows are staged in shared memory
//   once ((d + Wr) Np floats, 35 KB at Np = 512, q = 4, d = 2) and every
//   thread reads them as broadcasts.  Each thread keeps its point, its Wr
//   running sums and its Polyak sum in registers and runs every step and
//   restart without synchronizing.  The contraction is full f32 FMA.  The
//   (d, q) = (2, 4) instance has compile-time loop bounds; other shapes use
//   the generic instance (d <= 8, q <= 16, Wr <= 64).  Any M and Np.  The
//   staging and the field gradient live in field_grad.cuh, shared with
//   descent_grad.cu (one direction per launch).

#include "field_grad.cuh"

template <int DT, int QT>
__global__ void cmoe_descent_run_kernel(
    const float* __restrict__ xs0, const float* __restrict__ ws,
    const float* __restrict__ wt, const float* __restrict__ beta,
    const float* __restrict__ z, const float* __restrict__ us,
    const float* __restrict__ geom, float* __restrict__ out, int B, int d_rt,
    int M, int Np, int q_rt, int steps, int restarts, int avg_n, float gamma,
    float pre_mult, float mrc, int kernel) {
  constexpr int DA = DescDims<DT, QT>::D;
  constexpr int QA = DescDims<DT, QT>::Q;
  constexpr int WA = DescDims<DT, QT>::W;
  const int d = DT > 0 ? DT : d_rt;
  const int q = QT > 0 ? QT : q_rt;
  const int wr = (1 + q) * (1 + d);

  extern __shared__ float smem[];
  const int sb = blockIdx.x;     // s * B + b
  const int s = sb / B;
  cmoe_stage_field(smem, ws, wt, s, sb, d, wr, Np);
  const float* sws = smem;             // (d, Np)
  const float* swt = smem + d * Np;    // (Wr, Np)

  float lo[DA], hi[DA], il2[DA], uq[QA * DA];
  const float* gs = geom + (size_t)s * 3 * d;
#pragma unroll
  for (int dd = 0; dd < DA; ++dd) {
    if (dd < d) {
      lo[dd] = gs[dd];
      hi[dd] = gs[d + dd];
      il2[dd] = gs[2 * d + dd];
    }
  }
  cmoe_load_union<DA, QA>(us, sb, d, q, uq);

  for (int m = threadIdx.x; m < M; m += blockDim.x) {
    float x[DA], bz[QA], zz[QA];
    cmoe_load_draw<DA, QA>(xs0, beta, z, sb, d, q, M, m, x, bz, zz);

    for (int rnd = 0; rnd < restarts; ++rnd) {
      float xsum[DA];
#pragma unroll
      for (int dd = 0; dd < DA; ++dd) xsum[dd] = 0.0f;
      int nsum = 0;
      for (int i = 0; i < steps; ++i) {
        float g[DA];
        cmoe_field_grad<DA, QA, WA>(x, sws, swt, Np, d, q, wr, bz, zz, uq,
                                    kernel, g);
        cmoe_limit_step<DA>(x, g, lo, hi, il2,
                            pre_mult * powf((float)(i + 1), -gamma), mrc, d);
        if (avg_n > 0 && i >= steps - avg_n) {
#pragma unroll
          for (int dd = 0; dd < DA; ++dd)
            if (dd < d) xsum[dd] += x[dd];
          ++nsum;
        }
      }
      if (nsum > 0) {
#pragma unroll
        for (int dd = 0; dd < DA; ++dd)
          if (dd < d) x[dd] = fminf(fmaxf(xsum[dd] / (float)nsum, lo[dd]), hi[dd]);
      }
    }
#pragma unroll
    for (int dd = 0; dd < DA; ++dd)
      if (dd < d) out[((size_t)sb * d + dd) * M + m] = x[dd];
  }
}

template <int DT, int QT>
static int launch_descent(const float* xs0, const float* ws, const float* wt,
                          const float* beta, const float* z, const float* us,
                          const float* geom, float* out, int S, int B, int d,
                          int M, int Np, int q, int wr, int steps,
                          int restarts, int avg_n, float gamma,
                          float pre_mult, float mrc, int kernel,
                          cudaStream_t stream) {
  const size_t smem = (size_t)(d + wr) * Np * sizeof(float);
  const int err = cmoe_field_smem(cmoe_descent_run_kernel<DT, QT>, smem);
  if (err != (int)cudaSuccess) return err;
  cmoe_descent_run_kernel<DT, QT><<<S * B, cmoe_field_threads(M), smem,
                                    stream>>>(
      xs0, ws, wt, beta, z, us, geom, out, B, d, M, Np, q, steps, restarts,
      avg_n, gamma, pre_mult, mrc, kernel);
  return (int)cudaGetLastError();
}

extern "C" int cmoe_descent_run_fma(const float* xs0, const float* ws,
                                    const float* wt, const float* beta,
                                    const float* z, const float* us,
                                    const float* geom, float* out, int S,
                                    int B, int d, int M, int Np, int q,
                                    int wr, int steps, int restarts,
                                    int avg_n, float gamma, float pre_mult,
                                    float mrc, int kernel, void* stream) {
  if (wr != (1 + q) * (1 + d) || d > DESC_MAXD || q > DESC_MAXQ ||
      wr > DESC_MAXW)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (d == 2 && q == 4)
    return launch_descent<2, 4>(xs0, ws, wt, beta, z, us, geom, out, S, B, d,
                                M, Np, q, wr, steps, restarts, avg_n, gamma,
                                pre_mult, mrc, kernel, st);
  return launch_descent<0, 0>(xs0, ws, wt, beta, z, us, geom, out, S, B, d, M,
                              Np, q, wr, steps, restarts, avg_n, gamma,
                              pre_mult, mrc, kernel, st);
}
