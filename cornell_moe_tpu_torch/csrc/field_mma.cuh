// The KG inner descent's moment contraction on the tensor cores, shared by
// descent_run_mma.cu (kernel A's tensor-core instance, once per GD step) and
// descent_grad_mma.cu (kernel D's, once per launch): at a draw's scaled
// point x,
//   a (Wr) = W (Wr, Np) phi (Np),  phi_n = P(|ws_n - x|^2),
// for Wr = (1 + q)(1 + d) <= 16, one draw per lane of a warp.
//
// - The block's operands are staged into shared memory once
//   (cmoe_mma_stage, with cp.async, no pass through registers): Wr W rows
//   (the fragment's rows from Wr to 15 read as zero) and ws, padded with
//   zero weights to a multiple of 8 points; the padding points sit at 1e18,
//   so their phi is 0.  W rows are staged at a stride of 8 (mod 32) floats,
//   so the eight row groups hit distinct banks.
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
//   values and ws values are float2 pairs.
// - The field is computed in the B fragment's layout: each lane evaluates
//   phi for its two points and its draw column of each of the warp's four
//   n-tiles of 8 draws from ws in shared memory and the draw's x, broadcast
//   from the owning lane by shuffles.  No phi tile is written to shared
//   memory.  W's fragments (split once per k-tile) serve all four n-tiles.
// - After the contraction the warp writes its accumulators to a Wr x 32
//   exchange buffer, and each lane reads its own draw's Wr moments back.
//   Warps own disjoint draws: only __syncwarp.
// - A non-finite W keeps its NaN in its row of the accumulators (columns of
//   an mma do not mix): that moment is NaN for every draw of the block.
#pragma once

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
static inline size_t cmoe_mma_smem_bytes(int d, int q, int Np) {
  const int np8 = (Np + 7) / 8 * 8, wr = (1 + q) * (1 + d);
  return sizeof(float) * ((size_t)wr * cmoe_mma_ldw(np8) + (size_t)d * np8 +
                          MMA_UQ + MMA_WARPS * wr * MMA_ABUF);
}

// Warps of a block for M draws: one draw per lane, at most MMA_WARPS (a
// block loops over the draws beyond them).
static inline int cmoe_mma_warps(int M) {
  return (M + 31) / 32 < MMA_WARPS ? (M + 31) / 32 : MMA_WARPS;
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

// Stage block sb = s * B + b: its union's Wr W rows into sw (pitch ldw),
// member s's ws into sws (d, np8), both padded to np8 points, and the
// union's points into sus (q, d).  Data by cp.async, padding by plain
// stores (disjoint addresses).  Ends with a block barrier.
__device__ __forceinline__ void cmoe_mma_stage(
    float* sw, float* sws, float* sus, const float* __restrict__ ws,
    const float* __restrict__ wt, const float* __restrict__ us, int s,
    int sb, int d, int q, int wr, int Np, int np8, int ldw) {
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
}

// A warp's view of the staged operands in the fragments' layout.
struct CmoeMmaWarp {
  const float* wrow0;  // W row g of the A fragment (row 0 where g >= Wr)
  const float* wrow1;  // W row g + 8 (row 0 where g + 8 >= Wr)
  const float* prow;   // ws at this lane's first k index
  float* ab;           // this warp's Wr x MMA_ABUF exchange buffer
  int lane, gq, tq;    // lane = 4 gq + tq
  bool has0, has1;     // rows g and g + 8 below Wr (else read as zero)
};

// This warp's view of sw (Wr, ldw), sws (d, np8) and the exchange buffers
// sab (warps, Wr, MMA_ABUF).
__device__ __forceinline__ CmoeMmaWarp cmoe_mma_warp(const float* sw,
                                                     const float* sws,
                                                     float* sab, int wr,
                                                     int ldw) {
  CmoeMmaWarp w;
  w.lane = threadIdx.x & 31;
  w.gq = w.lane >> 2;
  w.tq = w.lane & 3;
  w.ab = sab + (threadIdx.x >> 5) * wr * MMA_ABUF;
  w.has0 = w.gq < wr;
  w.has1 = w.gq + 8 < wr;
  w.wrow0 = sw + (w.has0 ? w.gq : 0) * ldw + 2 * w.tq;
  w.wrow1 = sw + (w.has1 ? w.gq + 8 : 0) * ldw + 2 * w.tq;
  w.prow = sws + 2 * w.tq;
  return w;
}

// The Wr moments a = W phi of this lane's draw at its scaled point x (d),
// over the np8 staged points.  Every lane of the warp takes part (shuffles,
// mma.sync), each with a draw of its own.
template <int DA, int KERN>
__device__ __forceinline__ void cmoe_mma_moments(const CmoeMmaWarp& w,
                                                 const float* x, int d,
                                                 int wr, int np8, float* a) {
  // x of draw column g of each n-tile, from its owning lane
  float xb[MMA_TILES][DA];
#pragma unroll
  for (int j = 0; j < MMA_TILES; ++j)
#pragma unroll
    for (int dd = 0; dd < DA; ++dd)
      if (dd < d) xb[j][dd] = __shfl_sync(0xffffffffu, x[dd], 8 * j + w.gq);

  float acc[MMA_TILES][4];
#pragma unroll
  for (int j = 0; j < MMA_TILES; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[j][c] = 0.0f;

  const float2 zero2 = make_float2(0.0f, 0.0f);
  for (int k = 0; k < np8; k += 8) {
    const float2 w0 =
        w.has0 ? *reinterpret_cast<const float2*>(w.wrow0 + k) : zero2;
    const float2 w1 =
        w.has1 ? *reinterpret_cast<const float2*>(w.wrow1 + k) : zero2;
    unsigned ah[4], al[4];
    cmoe_split(w0.x, ah[0], al[0]);
    cmoe_split(w1.x, ah[1], al[1]);
    cmoe_split(w0.y, ah[2], al[2]);
    cmoe_split(w1.y, ah[3], al[3]);
    float2 p[DA];
#pragma unroll
    for (int dd = 0; dd < DA; ++dd)
      if (dd < d)
        p[dd] = *reinterpret_cast<const float2*>(w.prow + dd * np8 + k);
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
      // the tile's products in a fresh accumulator, small ones first, then
      // added to the running sums in float32 rounded to nearest: the mma's
      // own accumulation truncates
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
    if (w.has0)
      *reinterpret_cast<float2*>(w.ab + w.gq * MMA_ABUF + 8 * j + 2 * w.tq) =
          make_float2(acc[j][0], acc[j][1]);
    if (w.has1)
      *reinterpret_cast<float2*>(w.ab + (w.gq + 8) * MMA_ABUF + 8 * j +
                                 2 * w.tq) = make_float2(acc[j][2], acc[j][3]);
  }
  __syncwarp();
#pragma unroll
  for (int r = 0; r < MMA_ROWS; ++r)
    if (r < wr) a[r] = w.ab[r * MMA_ABUF + w.lane];
}
