// Fused GP log-marginal-likelihood pieces for a batch of MCMC walkers:
// K = alpha k(us) + diag(noise), its Cholesky factor, the forward
// substitution of y, and (quad = y^T K^-1 y, logdet = sum log diag L),
// both summed over the first n_real rows only.  A non-positive pivot
// anywhere gives NaN outputs, as the plain version's cholesky_ex failure
// does.  Any Np (the last panel may be narrower than 32).
//
// Replaces: cornell_moe_tpu/ops/pallas_kernels.py, pallas_lml_fused
//   (_lml_fused_kernel), which kept (wb, Np, Np) in VMEM (up to 8 MB) and
//   ran a 32-column blocked right-looking Cholesky per walker batch.
//
// Two instances, chosen by Np alone (ops/kernels.py lml_fused):
//
// Cluster instance (cmoe_lml_fused_cluster), every Np whose fullest CTA
//   fits in 227 KB of shared memory (Np <= 640 at 8 CTAs).
//   Bound on the H100: latency of the dependent panel chain, not FLOPs
//   (Np^3 / 6 = 22 M FMAs per walker at Np = 512, a few us of the card's
//   float32 rate), and the main path calls it with only 8 walkers.  One
//   block per walker left 124 of 132 SMs idle and walked the trailing
//   update's 680 tiles one after another through L2.
//   Design: one thread-block cluster of 8 CTAs (512 threads each) per
//   walker, 64 SMs at W = 8, launched with cudaLaunchKernelEx.  K stays on
//   chip as the TPU kept it in VMEM, in the cluster's distributed shared
//   memory: the lower triangle in 32 x 32 tiles, tile row i (and its slice
//   of y) in CTA i mod 8, built there from us; no (W, Np, Np) scratch.
//   Per panel k: (a) the owner of tile row k factors the diagonal tile
//   (warp shuffles, rows in registers), substitutes its y block column by
//   column in the same warp, carries quad, logdet and the failure flag in
//   CTA 0's shared memory, and writes L11 and z_k into every CTA's shared
//   memory; (b) cluster barrier; (c) every CTA solves its own panel rows,
//   one row per thread, folds in y -= L21 z, and writes each row of L21
//   into the panel buffer of every CTA that updates with it; (d) cluster
//   barrier; (e) every CTA updates its own trailing tiles from its local
//   panel buffer, 4 x 4 elements per thread, with no block-wide sync per
//   tile.  Writes to a peer (st.shared::cluster) do not stall the writer,
//   and the cluster barriers' release/acquire order them before the
//   peer's reads.  Tiles are stored with their 16-byte chunks XOR-swizzled
//   by row, so the float4 reads of the update hit distinct banks.  What
//   bounds it now is the owner's step (a), one warp's dependent chain of
//   32 pivots, about half of each panel at Np = 512.
//
// Large-Np instance (cmoe_lml_fused_global), every Np above that capacity.
//   Bound: the cluster instance's, the owner's step (a) in every panel,
//   plus each CTA's read-modify-write of its trailing tiles in (e), which
//   here goes through L2.  A block per walker would leave 124 of 132 SMs
//   idle at W = 8 and walk the trailing update one tile at a time.
//   Design: the cluster kernel itself, instantiated with K's tiles in a
//   global scratch that the wrapper allocates (each CTA's tiles in a region
//   of its own, laid out as in shared memory: 12.6 MB at W = 8, Np = 768),
//   which stays resident in the 50 MB L2.  Only the panel buffer (Np - 32
//   rows), L11, z, the y slices and the carry stay in shared memory, so a
//   CTA needs about (Np / 32) 4 KB: 99 KB at Np = 768.  Above Np = 1792 the
//   panel buffer no longer fits either; it then goes to the scratch too,
//   one copy per walker that each row's owner writes once and every CTA
//   reads past L1 (ld.global.cg: the cluster barrier orders the writes, and
//   no stale L1 line can be read).  The decomposition, the DSMEM broadcast
//   of L11 and z, the barriers and every element's arithmetic are the
//   cluster instance's, so the two agree to the last bit wherever both
//   run.
//
// Precision: float32 throughout, as the Pallas kernel.  A float64 inside
//   was tried: the chain then settled on near-noiseless walkers at which
//   the float32 ensemble fit failed for every member.  With a float32
//   factorization, a walker it cannot factor gets a -inf log-posterior, so
//   the chain stays where the float32 GP can be fitted.

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

#define LML_PANEL 32
#define LML_THREADS 256
#define LML_CLUSTER 8
#define LML_CLUSTER_THREADS 512
#define LML_TILE (LML_PANEL * LML_PANEL)

// ---------------------------------------------------------------------------
// One 8-CTA cluster per walker: K in distributed shared memory (the cluster
// instance) or in an L2-resident global scratch (the large-Np instance)
// ---------------------------------------------------------------------------

// Tile rows CTA `rank` owns (rows rank, rank + C, ...) out of nt.
__host__ __device__ inline int lml_rows_of(int rank, int nt, int c) {
  return rank < nt ? (nt - 1 - rank) / c + 1 : 0;
}

// Tiles held before local tile row l of CTA `rank`: tile row i = rank + l c
// holds tiles (i, 0..i), stored one after another.
__host__ __device__ inline int lml_tile_base(int rank, int l, int c) {
  return l * (rank + 1) + c * l * (l - 1) / 2;
}

// Shared-memory layout of one CTA, in floats; the same in every CTA of the
// cluster (sized for the fullest), mirrored by ops/kernels.py
// lml_layout_floats.  `tiles` (the fullest CTA's tile count) and `pbuf`
// (the panel buffer) take no shared memory where they live in the global
// scratch.
struct LmlLayout {
  int nt, tiles;
  int pbuf, dl, zb, y, carry, floats;
};

__host__ __device__ inline LmlLayout lml_layout(int np_, int c,
                                                bool tiles_on_chip = true,
                                                bool pbuf_on_chip = true) {
  LmlLayout L;
  L.nt = (np_ + LML_PANEL - 1) / LML_PANEL;
  L.tiles = 0;
  for (int r = 0; r < c; ++r) {
    const int t = lml_tile_base(r, lml_rows_of(r, L.nt, c), c);
    L.tiles = t > L.tiles ? t : L.tiles;
  }
  int off = tiles_on_chip ? L.tiles * LML_TILE : 0;
  L.pbuf = off;
  if (pbuf_on_chip) off += (L.nt > 1 ? L.nt - 1 : 0) * LML_TILE;
  L.dl = off;    off += LML_PANEL * (LML_PANEL + 1);
  L.zb = off;    off += LML_PANEL;
  L.y = off;     off += lml_rows_of(0, L.nt, c) * LML_PANEL;
  L.carry = off; off += 4;
  L.floats = off;
  return L;
}

// Element (r, c) of a tile: row-major, 16-byte chunk c / 4 of row r stored
// at chunk position (c / 4) ^ (r % 8).
__device__ __forceinline__ int lml_sw(int r, int c) {
  return r * LML_PANEL + ((((c >> 2) ^ r) & 7) << 2) + (c & 3);
}

__device__ __forceinline__ float lml_f4(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// A panel-buffer read: past L1 where peers write the buffer in global
// memory.
template <bool GLOBAL>
__device__ __forceinline__ float4 lml_ld4(const float4* p) {
  if constexpr (GLOBAL) return __ldcg(p);
  else return *p;
}

// Global scratch of the large-Np instance, in floats: every walker's CTA
// regions of `tiles` tiles each, then (where the panel buffer is off chip)
// one panel buffer of nt - 1 tiles per walker.
__host__ __device__ inline size_t lml_scratch_floats(const LmlLayout& L,
                                                     int W, int c,
                                                     bool pbuf_on_chip) {
  return (size_t)W * c * L.tiles * LML_TILE +
         (pbuf_on_chip ? 0 : (size_t)W * (L.nt > 1 ? L.nt - 1 : 0) *
                                 LML_TILE);
}

// KG: K's tiles in `scratch`; PG: the panel buffer there too (KG only).
template <bool KG, bool PG>
__global__ void __launch_bounds__(LML_CLUSTER_THREADS)
cmoe_lml_fused_cluster_kernel(
    const float* __restrict__ us, const float* __restrict__ alpha,
    const float* __restrict__ noise, const float* __restrict__ y,
    float* scratch, float* __restrict__ quad_out,
    float* __restrict__ logdet_out, int d, int np_, int n_real,
    int kernel) {
  static_assert(KG || !PG, "the panel buffer leaves the chip only with K");
  extern __shared__ float4 lml_smem[];
  float* sm = reinterpret_cast<float*>(lml_smem);
  cg::cluster_group cluster = cg::this_cluster();
  const int C = LML_CLUSTER, T = LML_CLUSTER_THREADS, Q = LML_PANEL / 4;
  const int rank = (int)cluster.block_rank();
  const int w = blockIdx.x / C;
  const int tid = threadIdx.x;
  const LmlLayout L = lml_layout(np_, C, !KG, !PG);
  const int nt = L.nt;
  const int rows = lml_rows_of(rank, nt, C);
  float* tiles = KG ? scratch + (size_t)(w * C + rank) * L.tiles * LML_TILE
                    : sm;
  // PG: walker w's panel buffer follows every walker's tile regions
  float4* pbuf4 = reinterpret_cast<float4*>(
      PG ? scratch + (size_t)gridDim.x * L.tiles * LML_TILE +
               (size_t)w * (nt - 1) * LML_TILE
         : sm + L.pbuf);
  float (*D)[LML_PANEL + 1] =
      reinterpret_cast<float (*)[LML_PANEL + 1]>(sm + L.dl);
  float* zb = sm + L.zb;
  float* yl = sm + L.y;
  float* carry = sm + L.carry;     // quad, logdet, failed (CTA 0's is live)

  const float* u = us + (size_t)w * d * np_;
  const float* nz = noise + (size_t)w * np_;
  const float a = alpha[w];

  // --- build this CTA's tiles of K's lower triangle, and its y slices ------
  const int ntiles = lml_tile_base(rank, rows, C);
  for (int e = tid; e < ntiles * LML_TILE; e += T) {
    const int t = e / LML_TILE, r = (e / LML_PANEL) % LML_PANEL;
    const int c = e % LML_PANEL;
    int l = 0, base = 0;
    while (base + rank + l * C + 1 <= t) base += rank + (l++) * C + 1;
    const int i = LML_PANEL * (rank + l * C) + r;
    const int j = LML_PANEL * (t - base) + c;
    float v = 0.0f;
    if (i < np_ && j <= i) {
      float s = 0.0f;
      for (int dd = 0; dd < d; ++dd) {
        const float diff = u[(size_t)dd * np_ + i] - u[(size_t)dd * np_ + j];
        s += diff * diff;
      }
      v = a * cmoe_unit_f0(s, kernel);
      if (i == j) v += nz[i];
    }
    tiles[(size_t)t * LML_TILE + lml_sw(r, c)] = v;
  }
  for (int e = tid; e < rows * LML_PANEL; e += T) {
    const int i = LML_PANEL * (rank + (e / LML_PANEL) * C) + e % LML_PANEL;
    yl[e] = i < np_ ? y[(size_t)w * np_ + i] : 0.0f;
  }
  if (rank == 0 && tid < 3) carry[tid] = 0.0f;
  cluster.sync();    // every CTA is running and built before any DSMEM access

  for (int k = 0; k < nt; ++k) {
    const int c0 = k * LML_PANEL;
    const int pw = min(LML_PANEL, np_ - c0);

    // --- (a) the owner factors the diagonal tile, substitutes y, and
    //     sends L11 and z_k to every CTA -----------------------------------
    if (rank == k % C) {
      if (tid < 32) {
        const int r = tid;
        float* cr = cluster.map_shared_rank(carry, 0);
        float quad = 0.0f, logdet = 0.0f, failed = 0.0f;
        if (r == 0) { quad = cr[0]; logdet = cr[1]; failed = cr[2]; }
        const float* Akk =
            tiles + (size_t)(lml_tile_base(rank, k / C, C) + k) * LML_TILE;
        float row[LML_PANEL];
#pragma unroll
        for (int c = 0; c < LML_PANEL; ++c) {
          float v = 0.0f;
          if (r < pw && c <= r) v = Akk[lml_sw(r, c)];
          if (r >= pw && c == r) v = 1.0f;          // identity padding
          row[c] = v;
        }
#pragma unroll
        for (int j = 0; j < LML_PANEL; ++j) {
          const float piv = sqrtf(__shfl_sync(0xffffffffu, row[j], j));
          if (r == j) row[j] = piv;
          else if (r > j) row[j] = row[j] / piv;
#pragma unroll
          for (int c = j + 1; c < LML_PANEL; ++c) {
            const float lcj = __shfl_sync(0xffffffffu, row[j], c);
            if (r >= c) row[c] -= row[j] * lcj;
          }
        }
        // forward substitution by columns: lane j subtracts L[j][0] z_0,
        // ..., L[j][j-1] z_{j-1} in that order, as a serial loop would
        float acc = r < pw ? yl[(k / C) * LML_PANEL + r] : 0.0f;
        float z = 0.0f, ljj = 1.0f;
#pragma unroll
        for (int j = 0; j < LML_PANEL; ++j) {
          if (r == j) { ljj = row[j]; z = acc / ljj; }
          const float zj = __shfl_sync(0xffffffffu, z, j);
          if (r > j) acc -= row[j] * zj;
        }
#pragma unroll
        for (int c = 0; c < LML_PANEL; ++c) D[r][c] = (c <= r) ? row[c] : 0.0f;
        zb[r] = z;
        // the masked sums in row order, carried from panel to panel
        const float lg = logf(ljj);
        if (__any_sync(0xffffffffu, r < pw && !(ljj > 0.0f))) failed = 1.0f;
#pragma unroll
        for (int j = 0; j < LML_PANEL; ++j) {
          const float zj = __shfl_sync(0xffffffffu, z, j);
          const float lj = __shfl_sync(0xffffffffu, lg, j);
          if (j < pw && c0 + j < n_real) {
            quad += zj * zj;
            logdet += lj;
          }
        }
        if (r == 0) { cr[0] = quad; cr[1] = logdet; cr[2] = failed; }
      }
      __syncthreads();
      const int n = LML_PANEL * (LML_PANEL + 1) + LML_PANEL;   // D, then zb
      for (int e = tid; e < (C - 1) * n; e += T) {
        const int o = (rank + 1 + e / n) % C;
        cluster.map_shared_rank(&D[0][0], o)[e % n] = (&D[0][0])[e % n];
      }
    }
    cluster.sync();                                          // (b)

    // --- (c) own panel rows: L21 = A21 L11^-T, y -= L21 z_k; each row goes
    //     to the panel buffer of every CTA that updates with it --------------
    for (int t = tid; t < rows * LML_PANEL; t += T) {
      const int l = t / LML_PANEL, r = t % LML_PANEL;
      const int i = rank + l * C;
      if (i <= k || LML_PANEL * i + r >= np_) continue;
      const float4* ai = reinterpret_cast<const float4*>(tiles) +
          (size_t)(lml_tile_base(rank, l, C) + k) * (LML_TILE / 4) + r * Q;
      float x[LML_PANEL];
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const float4 v = ai[q ^ (r & 7)];
        x[4 * q] = v.x; x[4 * q + 1] = v.y; x[4 * q + 2] = v.z;
        x[4 * q + 3] = v.w;
      }
      float ydot = 0.0f;
#pragma unroll
      for (int j = 0; j < LML_PANEL; ++j) {
        if (j < pw) {
          float acc = x[j];
#pragma unroll
          for (int kk = 0; kk < j; ++kk) acc -= D[j][kk] * x[kk];
          x[j] = acc / D[j][j];
          ydot += x[j] * zb[j];
        } else {
          x[j] = 0.0f;
        }
      }
      yl[t] -= ydot;
      float4* dst = pbuf4 + (size_t)(i - k - 1) * (LML_TILE / 4) + r * Q;
      if constexpr (PG) {          // the walker's one copy, in the scratch
#pragma unroll
        for (int q = 0; q < Q; ++q)
          dst[q ^ (r & 7)] = make_float4(x[4 * q], x[4 * q + 1],
                                         x[4 * q + 2], x[4 * q + 3]);
        continue;
      }
      for (int o = 0; o < C; ++o) {
        if (o + (lml_rows_of(o, nt, C) - 1) * C < i) continue;  // not needed
        float4* po = cluster.map_shared_rank(dst, o);
#pragma unroll
        for (int q = 0; q < Q; ++q)
          po[q ^ (r & 7)] = make_float4(x[4 * q], x[4 * q + 1], x[4 * q + 2],
                                        x[4 * q + 3]);
      }
    }
    if constexpr (PG) __threadfence();   // the rows reach L2 before (d)
    cluster.sync();                                          // (d)

    // --- (e) own trailing tiles A(i, j) -= L(i, k) L(j, k)^T, k < j <= i,
    //     4 x 4 elements per thread, from the local panel buffer -------------
    const int l0 = k >= rank ? (k - rank) / C + 1 : 0;
    int nupd = 0;
    for (int l = l0; l < rows; ++l) nupd += rank + l * C - k;
    for (int e = tid; e < nupd * 64; e += T) {
      int tt = e / 64, l = l0;
      while (tt >= rank + l * C - k) tt -= rank + (l++) * C - k;
      const int i = rank + l * C, j = k + 1 + tt;
      const int tr = (e % 64) / 8, tc = e % 8;
      const float4* Li = pbuf4 + (size_t)(i - k - 1) * (LML_TILE / 4);
      const float4* Lj = pbuf4 + (size_t)(j - k - 1) * (LML_TILE / 4);
      float acc[4][4];
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int s = 0; s < 4; ++s) acc[p][s] = 0.0f;
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        float4 li[4], lj[4];
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          li[p] = lml_ld4<PG>(Li + (tr + 8 * p) * Q + (q ^ tr));
          lj[p] = lml_ld4<PG>(Lj + (tc + 8 * p) * Q + (q ^ tc));
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int p = 0; p < 4; ++p)
#pragma unroll
            for (int s = 0; s < 4; ++s)
              acc[p][s] += lml_f4(li[p], kk) * lml_f4(lj[s], kk);
      }
      float* At = tiles + (size_t)(lml_tile_base(rank, l, C) + j) * LML_TILE;
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int s = 0; s < 4; ++s)
          At[lml_sw(tr + 8 * p, tc + 8 * s)] -= acc[p][s];
    }
    __syncthreads();
  }

  cluster.sync();    // no CTA leaves while a peer may still write to it
  if (rank == 0 && tid == 0) {
    const float nan = __int_as_float(0x7fc00000);
    const bool failed = carry[2] != 0.0f;
    quad_out[w] = failed ? nan : carry[0];
    logdet_out[w] = failed ? nan : carry[1];
  }
}

#define LML_SMEM_LIMIT 232448   // shared memory one H100 block may opt into

static int lml_cluster_bytes(int np_, int c) {
  return lml_layout(np_, c).floats * (int)sizeof(float);
}

// The large-Np instance keeps its panel buffer on chip while it fits.
static bool lml_global_pbuf_on_chip(int np_) {
  return lml_layout(np_, LML_CLUSTER, false, true).floats *
             (int)sizeof(float) <= LML_SMEM_LIMIT;
}

static int lml_global_bytes(int np_) {
  return lml_layout(np_, LML_CLUSTER, false, lml_global_pbuf_on_chip(np_))
             .floats * (int)sizeof(float);
}

extern "C" int cmoe_lml_fused_cluster_smem_bytes(int np_) {
  return lml_cluster_bytes(np_, LML_CLUSTER);
}

extern "C" int cmoe_lml_fused_global_smem_bytes(int np_) {
  return lml_global_bytes(np_);
}

// Floats of the large-Np instance's global scratch per walker.
extern "C" int cmoe_lml_fused_global_scratch_floats(int np_) {
  return (int)lml_scratch_floats(lml_layout(np_, LML_CLUSTER), 1,
                                 LML_CLUSTER, lml_global_pbuf_on_chip(np_));
}

static cudaLaunchConfig_t lml_cluster_config(int W, int c, int bytes,
                                             cudaLaunchAttribute* attr,
                                             void* stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(W * c);
  cfg.blockDim = dim3(LML_CLUSTER_THREADS);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = (cudaStream_t)stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = c;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <bool KG, bool PG>
static int lml_launch(const float* us, const float* alpha, const float* noise,
                      const float* y, float* scratch, float* quad,
                      float* logdet, int W, int d, int np_, int n_real,
                      int kernel, int bytes, void* stream) {
  cudaError_t e = cudaFuncSetAttribute(
      cmoe_lml_fused_cluster_kernel<KG, PG>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      lml_cluster_config(W, LML_CLUSTER, bytes, &attr, stream);
  e = cudaLaunchKernelEx(&cfg, cmoe_lml_fused_cluster_kernel<KG, PG>, us,
                         alpha, noise, y, scratch, quad, logdet, d, np_,
                         n_real, kernel);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

extern "C" int cmoe_lml_fused_cluster(const float* us, const float* alpha,
                                      const float* noise, const float* y,
                                      float* quad, float* logdet, int W,
                                      int d, int np_, int n_real, int kernel,
                                      void* stream) {
  return lml_launch<false, false>(us, alpha, noise, y, nullptr, quad, logdet,
                                  W, d, np_, n_real, kernel,
                                  lml_cluster_bytes(np_, LML_CLUSTER),
                                  stream);
}

// scratch: W cmoe_lml_fused_global_scratch_floats(np_) floats.
extern "C" int cmoe_lml_fused_global(const float* us, const float* alpha,
                                     const float* noise, const float* y,
                                     float* scratch, float* quad,
                                     float* logdet, int W, int d, int np_,
                                     int n_real, int kernel, void* stream) {
  const int bytes = lml_global_bytes(np_);
  if (lml_global_pbuf_on_chip(np_))
    return lml_launch<true, false>(us, alpha, noise, y, scratch, quad,
                                   logdet, W, d, np_, n_real, kernel, bytes,
                                   stream);
  return lml_launch<true, true>(us, alpha, noise, y, scratch, quad, logdet,
                                W, d, np_, n_real, kernel, bytes, stream);
}

template <bool KG, bool PG>
static int lml_occupancy(int W, int c, int bytes, int* clusters) {
  const void* fn = (const void*)cmoe_lml_fused_cluster_kernel<KG, PG>;
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess && c > 8)
    e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = lml_cluster_config(W, c, bytes, &attr,
                                                    nullptr);
  return (int)cudaOccupancyMaxActiveClusters(clusters, fn, &cfg);
}

// cudaOccupancyMaxActiveClusters for the cluster kernel at W walkers,
// clusters of c CTAs (c > 8 is the non-portable size) holding `bytes` of
// shared memory each.
extern "C" int cmoe_lml_fused_cluster_occupancy(int W, int c, int bytes,
                                                int* clusters) {
  return lml_occupancy<false, false>(W, c, bytes, clusters);
}

// The same for the large-Np instance at W walkers and Np.
extern "C" int cmoe_lml_fused_global_occupancy(int W, int np_,
                                               int* clusters) {
  const int bytes = lml_global_bytes(np_);
  return lml_global_pbuf_on_chip(np_)
             ? lml_occupancy<true, false>(W, LML_CLUSTER, bytes, clusters)
             : lml_occupancy<true, true>(W, LML_CLUSTER, bytes, clusters);
}
