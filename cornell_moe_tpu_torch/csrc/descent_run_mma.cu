// The KG inner posterior-mean descent for every (ensemble member s, union b,
// MC draw m) at once, run to the end inside the kernel, with the moment
// contraction on the tensor cores: the mma instance of kernel A (C entry
// cmoe_descent_run_mma), for Wr = (1 + q)(1 + d) <= 16.
//
// Replaces: cornell_moe_tpu/ops/pallas_kernels.py, pallas_descent_run
//   (_descent_run_kernel + _field_grad), whose contraction ran on the MXU.
// It computes what descent_run.cu (the FMA instance, taken for Wr > 16)
// computes: per draw, `restarts` rounds of `steps` LimitUpdate-clamped GD
// steps on the fantasized mean, Polyak averaging of the last avg_n steps of
// a round and a final clip.  Each step needs, at the draw's scaled point x,
//   a (Wr) = W (Wr, Np) phi (Np),  phi_n = P(|ws_n - x|^2),
// and then the same direction and step as the FMA instance
// (field_grad.cuh cmoe_moment_direction, cmoe_limit_step).
//
// Bound on the H100 (S16 B200 M128 Np512, d 2, q 4, 6 steps): 1.26e9
//   (draw, point) pairs, each 2 MUFU operations (the sqrt and the exp of
//   the Matern field; 0.60 ms at 16 per SM per clock) and about 10 FP32
//   instructions of distance and field outside the contraction.  The
//   contraction itself, 2 Wr FLOP per pair, runs as TF32 mma.sync: about
//   120 GFLOP of tensor work at 3 products per pair, a small share of the
//   tensor cores' rate.  Operands: about 111 MB, 0.03 ms of HBM time.
//
// Design (the contraction and its staging: field_mma.cuh, shared with
// kernel D's tensor-core instance, descent_grad_mma.cu):
// - One block per (s, b) and MMA_WARPS warps; each warp owns 32 draws (four
//   n-tiles of 8), one per lane, and loops when M exceeds 128.  ws (d, Np)
//   and the union's W rows are staged into shared memory once per launch
//   (cmoe_mma_stage): 44,960 bytes at the main path's shapes, so 5 blocks
//   (20 warps) fit on an SM and its 3200 blocks run in 4.85 waves (at 4
//   blocks, 6.06: a seventh wave 6% full).
// - Each step runs one contraction a = W phi on the tensor cores in 3xTF32
//   (cmoe_mma_moments), and each lane forms its draw's direction, the
//   clamped step and the Polyak sum from its Wr moments with the FMA
//   instance's arithmetic (field_grad.cuh).
// - A non-finite W or beta keeps its NaN inside the block's accumulators
//   (columns of an mma do not mix), the step is zeroed, and the draw stands
//   still, as in the FMA instance.
// - Instances: (d, q) = (2, 4) with compile-time bounds, and a generic one
//   for any Wr <= 16 (d, q <= 7); each for both fields.  Any M and Np while
//   the staged operands fit one block (cmoe_descent_run_mma_smem_bytes).

#include "field_mma.cuh"

template <int DT, int QT, int KERN>
__global__ void __launch_bounds__(MMA_WARPS * 32, DT > 0 ? 5 : 4)
    cmoe_descent_run_mma_kernel(
        const float* __restrict__ xs0, const float* __restrict__ ws,
        const float* __restrict__ wt, const float* __restrict__ beta,
        const float* __restrict__ z, const float* __restrict__ us,
        const float* __restrict__ geom, float* __restrict__ out, int B,
        int d_rt, int M, int Np, int q_rt, int steps, int restarts,
        int avg_n, float gamma, float pre_mult, float mrc) {
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
  const int s = sb / B;

  cmoe_mma_stage(sw, sws, sus, ws, wt, us, s, sb, d, q, wr, Np, np8, ldw);

  float lo[DA], hi[DA], il2[DA];
  const float* gs = geom + (size_t)s * 3 * d;
#pragma unroll
  for (int dd = 0; dd < DA; ++dd) {
    if (dd < d) {
      lo[dd] = gs[dd];
      hi[dd] = gs[d + dd];
      il2[dd] = gs[2 * d + dd];
    }
  }

  const CmoeMmaWarp w = cmoe_mma_warp(sw, sws, sab, wr, ldw);
  const int warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  for (int base = warp * 32; base < M; base += nwarps * 32) {
    const int m = base + w.lane;           // this lane's draw
    float x[DA], bz[QA], zz[QA];
    cmoe_load_draw<DA, QA>(xs0, beta, z, sb, d, q, M, m < M ? m : M - 1, x,
                           bz, zz);

    for (int rnd = 0; rnd < restarts; ++rnd) {
      float xsum[DA];
#pragma unroll
      for (int dd = 0; dd < DA; ++dd) xsum[dd] = 0.0f;
      int nsum = 0;
      for (int i = 0; i < steps; ++i) {
        float a[MMA_ROWS], g[DA];
        cmoe_mma_moments<DA, KERN>(w, x, d, wr, np8, a);
        cmoe_moment_direction<DA, QA>(a, x, d, q, bz, zz, sus, KERN, g);
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
          if (dd < d)
            x[dd] = fminf(fmaxf(xsum[dd] / (float)nsum, lo[dd]), hi[dd]);
      }
    }
    if (m < M) {
#pragma unroll
      for (int dd = 0; dd < DA; ++dd)
        if (dd < d) out[((size_t)sb * d + dd) * M + m] = x[dd];
    }
  }
}

template <int DT, int QT, int KERN>
static int launch_mma(const float* xs0, const float* ws, const float* wt,
                      const float* beta, const float* z, const float* us,
                      const float* geom, float* out, int S, int B, int d,
                      int M, int Np, int q, int steps, int restarts,
                      int avg_n, float gamma, float pre_mult, float mrc,
                      cudaStream_t stream) {
  const size_t smem = cmoe_mma_smem_bytes(d, q, Np);
  const int err =
      cmoe_field_smem(cmoe_descent_run_mma_kernel<DT, QT, KERN>, smem);
  if (err != (int)cudaSuccess) return err;
  const int warps = cmoe_mma_warps(M);
  cmoe_descent_run_mma_kernel<DT, QT, KERN><<<S * B, 32 * warps, smem,
                                              stream>>>(
      xs0, ws, wt, beta, z, us, geom, out, B, d, M, Np, q, steps, restarts,
      avg_n, gamma, pre_mult, mrc);
  return (int)cudaGetLastError();
}

template <int DT, int QT>
static int launch_mma_field(const float* xs0, const float* ws,
                            const float* wt, const float* beta,
                            const float* z, const float* us,
                            const float* geom, float* out, int S, int B,
                            int d, int M, int Np, int q, int steps,
                            int restarts, int avg_n, float gamma,
                            float pre_mult, float mrc, int kernel,
                            cudaStream_t st) {
  if (kernel == 1)
    return launch_mma<DT, QT, 1>(xs0, ws, wt, beta, z, us, geom, out, S, B,
                                 d, M, Np, q, steps, restarts, avg_n, gamma,
                                 pre_mult, mrc, st);
  return launch_mma<DT, QT, 0>(xs0, ws, wt, beta, z, us, geom, out, S, B, d,
                               M, Np, q, steps, restarts, avg_n, gamma,
                               pre_mult, mrc, st);
}

// Dynamic shared memory of a block at (d, q, Np), in bytes.
extern "C" int cmoe_descent_run_mma_smem_bytes(int d, int q, int Np) {
  return (int)cmoe_mma_smem_bytes(d, q, Np);
}

template <int DT, int QT, int KERN>
static int mma_occupancy(int d, int q, int M, int Np, int* blocks) {
  auto fn = cmoe_descent_run_mma_kernel<DT, QT, KERN>;
  const size_t smem = cmoe_mma_smem_bytes(d, q, Np);
  const int err = cmoe_field_smem(fn, smem);
  if (err != (int)cudaSuccess) return err;
  const int warps = cmoe_mma_warps(M);
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, fn,
                                                            32 * warps, smem);
}

// Blocks of the instance that launch_mma takes at (d, q, M, Np, field)
// resident on one SM at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
extern "C" int cmoe_descent_run_mma_occupancy(int d, int q, int M, int Np,
                                              int kernel, int* blocks) {
  if (d == 2 && q == 4)
    return kernel == 1 ? mma_occupancy<2, 4, 1>(d, q, M, Np, blocks)
                       : mma_occupancy<2, 4, 0>(d, q, M, Np, blocks);
  return kernel == 1 ? mma_occupancy<0, 0, 1>(d, q, M, Np, blocks)
                     : mma_occupancy<0, 0, 0>(d, q, M, Np, blocks);
}

extern "C" int cmoe_descent_run_mma(const float* xs0, const float* ws,
                                    const float* wt, const float* beta,
                                    const float* z, const float* us,
                                    const float* geom, float* out, int S,
                                    int B, int d, int M, int Np, int q,
                                    int wr, int steps, int restarts,
                                    int avg_n, float gamma, float pre_mult,
                                    float mrc, int kernel, void* stream) {
  if (wr != (1 + q) * (1 + d) || wr > MMA_ROWS || d < 1 || q < 1 || M < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (d == 2 && q == 4)
    return launch_mma_field<2, 4>(xs0, ws, wt, beta, z, us, geom, out, S, B,
                                  d, M, Np, q, steps, restarts, avg_n, gamma,
                                  pre_mult, mrc, kernel, st);
  return launch_mma_field<0, 0>(xs0, ws, wt, beta, z, us, geom, out, S, B, d,
                                M, Np, q, steps, restarts, avg_n, gamma,
                                pre_mult, mrc, kernel, st);
}
