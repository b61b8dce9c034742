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
// Design:
// - One block per (s, b) and MMA_WARPS warps; each warp owns 32 draws (four
//   n-tiles of 8), one per lane, and loops when M exceeds 128.  ws (d, Np)
//   and the union's W rows are staged into shared memory once per launch
//   with cp.async (no pass through registers): Wr rows (the fragment's rows
//   from Wr to 15 read as zero), padded with zero weights to a multiple of
//   8 points; the padding points sit at 1e18, so their phi is 0.  44,960
//   bytes at the main path's shapes: 5 blocks (20 warps) fit on an SM, so
//   its 3200 blocks run in 4.85 waves (at 4 blocks, 6.06: a seventh wave
//   6% full).
// - a = W phi as mma.sync.aligned.m16n8k8 TF32 with the 3xTF32 split
//   (x_hi = x rounded to TF32 to nearest, ties away; x_lo = x - x_hi, read
//   by the mma as TF32; lo*hi + hi*lo + hi*hi), so the contraction keeps
//   close to float32 accuracy: g = x s0 - sx cancels, and plain TF32 would
//   not do.  Each k-tile's three products go into a fresh accumulator,
//   which is then added to the running sums by FADD: the tensor core's own
//   float32 accumulation truncates, and over the 192 accumulations of a
//   step at Np = 512 its bias flipped about 2.7x as many clamped steps as
//   the float32 plain descent (chip_smoke.py, per-quantile rule).  The
//   field takes rsqrt.approx and ex2.approx (cmoe_mma_unit_p).
// - Fragment layout (PTX ISA, mma.m16n8k8 .tf32; lane = 4 g + t):
//     A (16 x 8, W):   a0 (row g, k t), a1 (g + 8, t), a2 (g, t + 4),
//                      a3 (g + 8, t + 4);
//     B (8 x 8, phi):  b0 (k t, draw column g), b1 (k t + 4, column g);
//     C (16 x 8, a):   c0 (row g, column 2t), c1 (g, 2t + 1),
//                      c2 (g + 8, 2t), c3 (g + 8, 2t + 1).
//   The k order inside a tile is free as long as A and B agree: k index t is
//   point k0 + 2t and k index t + 4 is point k0 + 2t + 1, so a lane's W
//   values and ws values are float2 pairs.  W rows are staged at a stride
//   of 8 (mod 32) floats, so the eight row groups hit distinct banks.
// - The field is computed in the B fragment's layout: each lane evaluates
//   phi for its two points and its draw column of each n-tile from ws in
//   shared memory and the draw's x, broadcast from the owning lane by
//   shuffles.  No phi tile is written to shared memory.  W's fragments
//   (split once per k-tile) serve all four n-tiles of the warp.
// - After each step's contraction the warp writes its accumulators to a
//   Wr x 32 exchange buffer; each lane reads its own draw's Wr moments back
//   and forms the direction, the clamped step and the Polyak sum with the
//   FMA instance's arithmetic.  Warps own disjoint draws: only __syncwarp.
// - A non-finite W or beta keeps its NaN inside the block's accumulators
//   (columns of an mma do not mix), the step is zeroed, and the draw stands
//   still, as in the FMA instance.
// - Instances: (d, q) = (2, 4) with compile-time bounds, and a generic one
//   for any Wr <= 16 (d, q <= 7); each for both fields.  Any M and Np while
//   the staged operands fit one block (cmoe_descent_run_mma_smem_bytes).

#include "field_grad.cuh"

#define MMA_ROWS 16       // moment rows of one m16n8k8 tile: Wr <= 16
#define MMA_MAXD 7        // largest d (q >= 1) and q (d >= 1) at Wr <= 16
#define MMA_MAXQ 7
#define MMA_TILES 4       // n-tiles of 8 draws per warp: one draw per lane
#define MMA_WARPS 4       // warps per block (128 draws per pass)
#define MMA_UQ 16         // floats reserved for the union points (q d <= 9)
#define MMA_ABUF 40       // row stride of a warp's exchange buffer
#define MMA_FAR 1e18f     // coordinate of a padding point: phi = 0

// Row stride of the staged W: the least >= np8 that is 8 (mod 32).
__host__ __device__ inline int cmoe_mma_ldw(int np8) {
  return np8 + (40 - np8 % 32) % 32;
}

// Dynamic shared memory of a block: the Wr staged W rows, ws (d, np8), the
// union points and each warp's Wr-row exchange buffer.
static size_t mma_smem_bytes(int d, int q, int Np) {
  const int np8 = (Np + 7) / 8 * 8, wr = (1 + q) * (1 + d);
  return sizeof(float) * ((size_t)wr * cmoe_mma_ldw(np8) + (size_t)d * np8 +
                          MMA_UQ + MMA_WARPS * wr * MMA_ABUF);
}

// 3xTF32 split: x = hi + lo.  hi is x rounded to TF32, to nearest with
// ties away from zero (cvt.rna.tf32.f32, which sm_90 runs as a 5-instruction
// sequence, done here in 2: add half a TF32 ulp to the magnitude bits and
// clear the 13 low bits).  lo = x - hi is exact in float32, and the mma
// reads only its TF32 bits, so its rounding is skipped: that costs at most
// 2^-23 |x| against 2^-24 |x|.  An Inf or NaN x (whose hi may wrap) gives a
// NaN lo, so a non-finite operand still reaches the sums as NaN.
__device__ __forceinline__ void cmoe_split(float x, unsigned& hi,
                                           unsigned& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

#define CMOE_LOG2E 1.4426950408889634f

__device__ __forceinline__ float cmoe_ex2(float t) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(t));
  return y;
}

// common.cuh's cmoe_unit_p in fewer instructions: r = s rsqrt.approx(s)
// (2 instructions; s = 0 gives 0) in place of sqrtf, whose every call
// branches on a slow path for special inputs; e^-x as ex2.approx(-x log2 e)
// (2 instructions) in place of expf (8).  Both cost relative error: about
// 2^-22 in r, and rounding the argument about x 2^-24 where expf keeps
// about 2^-23.  The sums see absolute errors, and the field decays faster
// than these grow: at most about 1e-7 on a field value of at most 1.
__device__ __forceinline__ float cmoe_mma_unit_p(float s, int kernel) {
  if (kernel == 1) return cmoe_ex2(-0.5f * CMOE_LOG2E * s);
  float y;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(fmaxf(s, 1e-30f)));
  const float r = s * y;
  return (1.0f + CMOE_SQRT5 * r) * cmoe_ex2(-CMOE_SQRT5 * CMOE_LOG2E * r);
}

// c (16 x 8) += A (16 x 8) B (8 x 8), TF32 in, float32 accumulate.
__device__ __forceinline__ void cmoe_mma(float* c, const unsigned* a,
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cmoe_cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(s), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cmoe_cp_async16(float* dst,
                                                const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s), "l"(src)
               : "memory");
}

// Copy `rows` rows of n floats (global row pitch n) into shared memory at
// row pitch ld (a multiple of 4) with cp.async: 16-byte copies where every
// global row start is 16-byte aligned, else 4-byte copies.
__device__ __forceinline__ void cmoe_stage_rows(float* dst, int ld,
                                                const float* src, int rows,
                                                int n) {
  if (n % 4 == 0 && ((size_t)src & 15) == 0) {
    const int n4 = n / 4;
    for (int i = threadIdx.x; i < rows * n4; i += blockDim.x) {
      const int r = i / n4, c = 4 * (i - r * n4);
      cmoe_cp_async16(dst + r * ld + c, src + (size_t)r * n + c);
    }
  } else {
    for (int i = threadIdx.x; i < rows * n; i += blockDim.x) {
      const int r = i / n, c = i - r * n;
      cmoe_cp_async4(dst + r * ld + c, src + (size_t)r * n + c);
    }
  }
}

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

  // stage: data by cp.async, padding by plain stores (disjoint addresses)
  cmoe_stage_rows(sw, ldw, wt + (size_t)sb * wr * Np, wr, Np);
  cmoe_stage_rows(sws, np8, ws + (size_t)s * d * Np, d, Np);
  for (int i = threadIdx.x; i < wr * (np8 - Np); i += blockDim.x) {
    const int r = i / (np8 - Np), c = Np + i - r * (np8 - Np);
    sw[r * ldw + c] = 0.0f;
    if (r < d) sws[r * np8 + c] = MMA_FAR;
  }
  for (int i = threadIdx.x; i < q * d; i += blockDim.x)
    sus[i] = us[(size_t)sb * q * d + i];
  asm volatile("cp.async.wait_all;" ::: "memory");
  __syncthreads();

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

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int nwarps = blockDim.x >> 5;
  float* ab = sab + warp * wr * MMA_ABUF;
  // the A fragment's rows g and g + 8; rows from Wr to 15 are zero and
  // not staged
  const bool has0 = gq < wr, has1 = gq + 8 < wr;
  const float* wrow0 = sw + (has0 ? gq : 0) * ldw + 2 * tq;
  const float* wrow1 = sw + (has1 ? gq + 8 : 0) * ldw + 2 * tq;
  const float2 zero2 = make_float2(0.0f, 0.0f);
  const float* prow = sws + 2 * tq;

  for (int base = warp * 32; base < M; base += nwarps * 32) {
    const int m = base + lane;             // this lane's draw
    float x[DA], bz[QA], zz[QA];
    cmoe_load_draw<DA, QA>(xs0, beta, z, sb, d, q, M, m < M ? m : M - 1, x,
                           bz, zz);

    for (int rnd = 0; rnd < restarts; ++rnd) {
      float xsum[DA];
#pragma unroll
      for (int dd = 0; dd < DA; ++dd) xsum[dd] = 0.0f;
      int nsum = 0;
      for (int i = 0; i < steps; ++i) {
        // x of draw column g of each n-tile, from its owning lane
        float xb[MMA_TILES][DA];
#pragma unroll
        for (int j = 0; j < MMA_TILES; ++j)
#pragma unroll
          for (int dd = 0; dd < DA; ++dd)
            if (dd < d)
              xb[j][dd] = __shfl_sync(0xffffffffu, x[dd], 8 * j + gq);

        float acc[MMA_TILES][4];
#pragma unroll
        for (int j = 0; j < MMA_TILES; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[j][c] = 0.0f;

        for (int k = 0; k < np8; k += 8) {
          const float2 w0 =
              has0 ? *reinterpret_cast<const float2*>(wrow0 + k) : zero2;
          const float2 w1 =
              has1 ? *reinterpret_cast<const float2*>(wrow1 + k) : zero2;
          unsigned ah[4], al[4];
          cmoe_split(w0.x, ah[0], al[0]);
          cmoe_split(w1.x, ah[1], al[1]);
          cmoe_split(w0.y, ah[2], al[2]);
          cmoe_split(w1.y, ah[3], al[3]);
          float2 p[DA];
#pragma unroll
          for (int dd = 0; dd < DA; ++dd)
            if (dd < d)
              p[dd] = *reinterpret_cast<const float2*>(prow + dd * np8 + k);
#pragma unroll
          for (int j = 0; j < MMA_TILES; ++j) {
            float s0 = 0.0f, s1 = 0.0f;
#pragma unroll
            for (int dd = 0; dd < DA; ++dd) {
              if (dd < d) {
                const float e0 = p[dd].x - xb[j][dd];
                s0 = fmaf(e0, e0, s0);
                const float e1 = p[dd].y - xb[j][dd];
                s1 = fmaf(e1, e1, s1);
              }
            }
            unsigned bh0, bl0, bh1, bl1;
            cmoe_split(cmoe_mma_unit_p(s0, KERN), bh0, bl0);
            cmoe_split(cmoe_mma_unit_p(s1, KERN), bh1, bl1);
            // the tile's products in a fresh accumulator, small ones
            // first, then added to the running sums in float32 rounded
            // to nearest: the mma's own accumulation truncates
            float t[4] = {0.0f, 0.0f, 0.0f, 0.0f};
            cmoe_mma(t, al, bh0, bh1);
            cmoe_mma(t, ah, bl0, bl1);
            cmoe_mma(t, ah, bh0, bh1);
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[j][c] += t[c];
          }
        }

        // exchange: row r of draw column n of tile j -> ab[r][8 j + n]
        __syncwarp();
#pragma unroll
        for (int j = 0; j < MMA_TILES; ++j) {
          if (has0)
            *reinterpret_cast<float2*>(ab + gq * MMA_ABUF + 8 * j + 2 * tq) =
                make_float2(acc[j][0], acc[j][1]);
          if (has1)
            *reinterpret_cast<float2*>(ab + (gq + 8) * MMA_ABUF + 8 * j +
                                       2 * tq) =
                make_float2(acc[j][2], acc[j][3]);
        }
        __syncwarp();
        float a[MMA_ROWS], g[DA];
#pragma unroll
        for (int r = 0; r < MMA_ROWS; ++r)
          if (r < wr) a[r] = ab[r * MMA_ABUF + lane];
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
  const size_t smem = mma_smem_bytes(d, q, Np);
  const int err =
      cmoe_field_smem(cmoe_descent_run_mma_kernel<DT, QT, KERN>, smem);
  if (err != (int)cudaSuccess) return err;
  const int warps = (M + 31) / 32 < MMA_WARPS ? (M + 31) / 32 : MMA_WARPS;
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
  return (int)mma_smem_bytes(d, q, Np);
}

template <int DT, int QT, int KERN>
static int mma_occupancy(int d, int q, int M, int Np, int* blocks) {
  auto fn = cmoe_descent_run_mma_kernel<DT, QT, KERN>;
  const size_t smem = mma_smem_bytes(d, q, Np);
  const int err = cmoe_field_smem(fn, smem);
  if (err != (int)cudaSuccess) return err;
  const int warps = (M + 31) / 32 < MMA_WARPS ? (M + 31) / 32 : MMA_WARPS;
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
