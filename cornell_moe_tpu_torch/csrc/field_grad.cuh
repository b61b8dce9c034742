// The KG inner descent's field gradient, shared by descent_run.cu (the whole
// descent) and descent_grad.cu (one direction per launch), as _field_grad is
// shared by the two Pallas kernels of cornell_moe_tpu/ops/pallas_kernels.py;
// its direction from the moments also serves the tensor-core instances
// (descent_run_mma.cu, descent_grad_mma.cu), and its clamped step
// descent_run_mma.cu.
//
// Layouts (one ensemble member s, one union b; sb = s * B + b):
//   ws (S, d, Np) scaled training points; wt (S, B, Wr, Np) moment weights
//   c [K^-1 y | V | (those) * ws_dd], Wr = (1 + q)(1 + d); us (S, B, q, d)
//   scaled union points; per draw: beta (S, B, q, M), z (q, M).
#pragma once

#include "common.cuh"

#define DESC_MAXD 8
#define DESC_MAXQ 16
#define DESC_MAXW 64

// Register array bounds of an instance: compile-time (d, q) = (DT, QT), or
// the generic instance's maxima when DT = QT = 0.
template <int DT, int QT>
struct DescDims {
  static constexpr int D = DT > 0 ? DT : DESC_MAXD;
  static constexpr int Q = QT > 0 ? QT : DESC_MAXQ;
  static constexpr int W = (Q + 1) * (D + 1) < DESC_MAXW ? (Q + 1) * (D + 1)
                                                         : DESC_MAXW;
};

// Copy member s's ws and union sb's W rows into shared memory:
// (d + Wr) Np floats, ws first.  Ends with a block barrier.
__device__ __forceinline__ void cmoe_stage_field(
    float* smem, const float* __restrict__ ws, const float* __restrict__ wt,
    int s, int sb, int d, int wr, int Np) {
  const float* wsg = ws + (size_t)s * d * Np;
  const float* wtg = wt + (size_t)sb * wr * Np;
  float* swt = smem + d * Np;
  for (int i = threadIdx.x; i < d * Np; i += blockDim.x) smem[i] = wsg[i];
  for (int i = threadIdx.x; i < wr * Np; i += blockDim.x) swt[i] = wtg[i];
  __syncthreads();
}

// Union sb's scaled points into uq (q, d).
template <int DA, int QA>
__device__ __forceinline__ void cmoe_load_union(const float* __restrict__ us,
                                                int sb, int d, int q,
                                                float* uq) {
  const float* ub = us + (size_t)sb * q * d;
#pragma unroll
  for (int e = 0; e < QA * DA; ++e)
    if (e < q * d) uq[e] = ub[e];
}

// Draw m of union sb: its scaled point x (from xs (S, B, d, M)), its betas
// and its normals.
template <int DA, int QA>
__device__ __forceinline__ void cmoe_load_draw(
    const float* __restrict__ xs, const float* __restrict__ beta,
    const float* __restrict__ z, int sb, int d, int q, int M, int m,
    float* x, float* bz, float* zz) {
#pragma unroll
  for (int dd = 0; dd < DA; ++dd)
    if (dd < d) x[dd] = xs[((size_t)sb * d + dd) * M + m];
#pragma unroll
  for (int j = 0; j < QA; ++j) {
    if (j < q) {
      bz[j] = beta[((size_t)sb * q + j) * M + m];
      zz[j] = z[(size_t)j * M + m];
    }
  }
}

// Ascent direction g of -mu' at one draw's scaled point x (d) from its
// moments a = W phi (Wr rows):
//   g = x s0 - sx + sum_j beta_j P(|x - u_j|^2) (x - u_j),
// with s0, sx the draw's normals zz contracted into a; bz, zz the draw's
// beta and normals; uq (q, d) the scaled union points.
template <int DA, int QA>
__device__ __forceinline__ void cmoe_moment_direction(
    const float* a, const float* x, int d, int q, const float* bz,
    const float* zz, const float* uq, int kernel, float* g) {
  // contract the draw's normals: w_eff = K^-1 y - V z
  float s0 = a[0];
#pragma unroll
  for (int j = 0; j < QA; ++j)
    if (j < q) s0 -= a[1 + j] * zz[j];
#pragma unroll
  for (int dd = 0; dd < DA; ++dd) {
    if (dd < d) {
      float sx = a[1 + q + dd];
#pragma unroll
      for (int j = 0; j < QA; ++j)
        if (j < q) sx -= a[1 + q + (j + 1) * d + dd] * zz[j];
      g[dd] = x[dd] * s0 - sx;
    }
  }
  // union term
#pragma unroll
  for (int j = 0; j < QA; ++j) {
    if (j < q) {
      float su = 0.0f;
#pragma unroll
      for (int dd = 0; dd < DA; ++dd) {
        if (dd < d) {
          const float du = x[dd] - uq[j * d + dd];
          su += du * du;
        }
      }
      const float pb = cmoe_unit_p(su, kernel) * bz[j];
#pragma unroll
      for (int dd = 0; dd < DA; ++dd)
        if (dd < d) g[dd] += pb * (x[dd] - uq[j * d + dd]);
    }
  }
}

// Ascent direction g of -mu' at one draw's scaled point x (d):
//   a = W phi, phi_n = P(|ws_n - x|^2) over the Np staged training points,
// then cmoe_moment_direction.  sws, swt are the staged ws (d, Np) and
// W (Wr, Np).  Full f32 FMA.
template <int DA, int QA, int WA>
__device__ __forceinline__ void cmoe_field_grad(
    const float* x, const float* sws, const float* swt, int Np, int d, int q,
    int wr, const float* bz, const float* zz, const float* uq, int kernel,
    float* g) {
  // moment contraction a = W phi over the training points
  float a[WA];
#pragma unroll
  for (int w = 0; w < WA; ++w) a[w] = 0.0f;
  for (int n = 0; n < Np; ++n) {
    float s2 = 0.0f;
#pragma unroll
    for (int dd = 0; dd < DA; ++dd) {
      if (dd < d) {
        const float diff = sws[dd * Np + n] - x[dd];
        s2 = fmaf(diff, diff, s2);
      }
    }
    const float phi = cmoe_unit_p(s2, kernel);
#pragma unroll
    for (int w = 0; w < WA; ++w)
      if (w < wr) a[w] = fmaf(swt[w * Np + n], phi, a[w]);
  }
  cmoe_moment_direction<DA, QA>(a, x, d, q, bz, zz, uq, kernel, g);
}

// One LimitUpdate-clamped GD step of the draw's point x (d) along g at
// `rate` (TensorProductDomain.LimitUpdate): a non-finite step is 0, the
// step is capped at mrc times the distance to the nearer wall, and a step
// that still leaves the box goes half-way to the wall it crosses.
template <int DA>
__device__ __forceinline__ void cmoe_limit_step(float* x, const float* g,
                                                const float* lo,
                                                const float* hi,
                                                const float* il2, float rate,
                                                float mrc, int d) {
#pragma unroll
  for (int dd = 0; dd < DA; ++dd) {
    if (dd < d) {
      const float xr = x[dd];
      float dx = rate * g[dd] * il2[dd];
      if (!isfinite(dx)) dx = 0.0f;
      const float cap = mrc * fminf(xr - lo[dd], hi[dd] - xr);
      float step = dx;
      if (fabsf(dx) > cap) step = dx > 0.0f ? cap : (dx < 0.0f ? -cap : 0.0f);
      const float nxt = xr + step;
      const float half = step * 0.5f;
      const float fix_lo = (xr + half < lo[dd]) ? (lo[dd] - xr) * 0.5f : half;
      const float fix_hi = (xr + half > hi[dd]) ? (hi[dd] - xr) * 0.5f : half;
      if (nxt < lo[dd]) step = fix_lo;
      else if (nxt > hi[dd]) step = fix_hi;
      x[dd] = xr + step;
    }
  }
}

// Raise the block's dynamic shared-memory limit where (d + Wr) Np floats
// exceed the default 48 KB; returns a cudaError_t.
template <typename Kernel>
static int cmoe_field_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return (int)cudaSuccess;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// Threads of a block: one per draw, a multiple of 32, at most 256 (a block
// loops over the draws beyond that).
static inline int cmoe_field_threads(int M) {
  const int threads = ((M + 31) / 32) * 32;
  return threads > 256 ? 256 : threads;
}
