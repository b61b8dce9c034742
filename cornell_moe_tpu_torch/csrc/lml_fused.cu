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
// Two instances, chosen by Np and the element size alone (ops/kernels.py
// lml_fused):
//
// Cluster instance (cmoe_lml_fused_cluster), every Np whose fullest CTA
//   fits in 227 KB of shared memory (Np <= 640 at 8 CTAs in float32, 384
//   in float64).
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
// Precision: the kernel is a template on its element type, and each
//   instance computes in the precision of the model that launches it
//   (ops/kernels.py lml_fused takes the inputs' dtype).  Float32 models
//   get float32 throughout, as the Pallas kernel: a float64 inside was
//   tried for them and let the chain settle on near-noiseless walkers at
//   which the float32 ensemble fit failed for every member, whereas with a
//   float32 factorization a walker it cannot factor gets a -inf
//   log-posterior, so the chain stays where the float32 GP can be fitted.
//   Float64 models get float64 throughout (loads, stores, DFMA, float64
//   reciprocal square root and log, two-word shuffles; no float32 or TF32
//   operation): their fit is float64 too, so that concern does not arise.
//   The JAX package's TPU kernel has no float64 counterpart; this is its
//   counterpart at the configuration's precision.  A 16-byte vector holds
//   4 floats or 2 doubles, and the tiles' swizzle moves 16-byte chunks, so
//   the float32 instances' layout and arithmetic are the same as before
//   the template.  In float64 the cluster instance fits up to Np = 384,
//   and the large-Np instance keeps its panel column on chip up to 896,
//   the gate's upper end (132,128 B a CTA at Np = 512).  Float64's step
//   (a) is its own, as the owner's chain bounds the kernel and a float64
//   division or square root is a long sequence of dependent DFMAs: each
//   pivot takes one reciprocal square root, and every row of the panel a
//   product by it, so the kernel divides nowhere (the substitutions
//   multiply by 1 / L_jj, which the owner also hands to step (c) in D's
//   padding column); column j reaches the lanes through shared memory,
//   two elements a load, where two shuffles an element were the chain's
//   largest part; the masked sums are a tree over the lanes.  At W = 8,
//   Np = 512 on the H100 this took the kernel from 0.71 to 0.47 ms (CUDA
//   events) and the owner's step (a) from 23 to 10 us a panel.

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

// Shared-memory layout of one CTA, in elements (floats or doubles); the
// same in every CTA of the cluster (sized for the fullest), mirrored by
// ops/kernels.py lml_layout_bytes.  `tiles` (the fullest CTA's tile count)
// and `pbuf` (the panel buffer) take no shared memory where they live in
// the global scratch.
struct LmlLayout {
  int nt, tiles;
  int pbuf, dl, zb, y, carry, elems;
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
  L.elems = off;
  return L;
}

// The 16-byte vector of an element type: 4 floats or 2 doubles.
template <typename Real> struct LmlVec;
template <> struct LmlVec<float> { using V = float4; };
template <> struct LmlVec<double> { using V = double2; };

__device__ __forceinline__ float lml_el(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}
__device__ __forceinline__ double lml_el(const double2& v, int i) {
  return i == 0 ? v.x : v.y;
}
__device__ __forceinline__ float4 lml_pack(const float* x) {
  return make_float4(x[0], x[1], x[2], x[3]);
}
__device__ __forceinline__ double2 lml_pack(const double* x) {
  return make_double2(x[0], x[1]);
}

__device__ __forceinline__ float lml_log(float x) { return logf(x); }
__device__ __forceinline__ double lml_log(double x) { return log(x); }
__device__ __forceinline__ float lml_nan(float) {
  return __int_as_float(0x7fc00000);
}
__device__ __forceinline__ double lml_nan(double) {
  return __longlong_as_double(0x7ff8000000000000LL);
}

// Element (r, c) of a tile of `Real`: row-major, with the row's 16-byte
// chunks (4 floats or 2 doubles each) XOR-swizzled by r % 8: chunk c / E
// stored at chunk position (c / E) ^ (r % 8).
template <typename Real>
__device__ __forceinline__ int lml_sw(int r, int c) {
  constexpr int S = sizeof(Real) == 4 ? 2 : 1;    // log2 of E
  return r * LML_PANEL + (((c >> S) ^ (r & 7)) << S) + (c & ((1 << S) - 1));
}

// A panel-buffer read: past L1 where peers write the buffer in global
// memory.
template <bool GLOBAL, typename V>
__device__ __forceinline__ V lml_ld(const V* p) {
  if constexpr (GLOBAL) return __ldcg(p);
  else return *p;
}

// Global scratch of the large-Np instance, in elements: every walker's CTA
// regions of `tiles` tiles each, then (where the panel buffer is off chip)
// one panel buffer of nt - 1 tiles per walker.
__host__ __device__ inline size_t lml_scratch_elems(const LmlLayout& L,
                                                    int W, int c,
                                                    bool pbuf_on_chip) {
  return (size_t)W * c * L.tiles * LML_TILE +
         (pbuf_on_chip ? 0 : (size_t)W * (L.nt > 1 ? L.nt - 1 : 0) *
                                 LML_TILE);
}

// Real: the element type, float or double.  KG: K's tiles in `scratch`;
// PG: the panel buffer there too (KG only).
template <typename Real, bool KG, bool PG>
__global__ void __launch_bounds__(LML_CLUSTER_THREADS)
cmoe_lml_fused_cluster_kernel(
    const Real* __restrict__ us, const Real* __restrict__ alpha,
    const Real* __restrict__ noise, const Real* __restrict__ y,
    Real* scratch, Real* __restrict__ quad_out,
    Real* __restrict__ logdet_out, int d, int np_, int n_real,
    int kernel) {
  static_assert(KG || !PG, "the panel buffer leaves the chip only with K");
  using V = typename LmlVec<Real>::V;
  constexpr int E = 16 / (int)sizeof(Real);      // elements per vector
  constexpr bool F64 = sizeof(Real) == 8;
  extern __shared__ float4 lml_smem[];
  Real* sm = reinterpret_cast<Real*>(lml_smem);
  cg::cluster_group cluster = cg::this_cluster();
  const int C = LML_CLUSTER, T = LML_CLUSTER_THREADS, Q = LML_PANEL / E;
  const int rank = (int)cluster.block_rank();
  const int w = blockIdx.x / C;
  const int tid = threadIdx.x;
  const LmlLayout L = lml_layout(np_, C, !KG, !PG);
  const int nt = L.nt;
  const int rows = lml_rows_of(rank, nt, C);
  Real* tiles = KG ? scratch + (size_t)(w * C + rank) * L.tiles * LML_TILE
                   : sm;
  // PG: walker w's panel buffer follows every walker's tile regions
  V* pbufv = reinterpret_cast<V*>(
      PG ? scratch + (size_t)gridDim.x * L.tiles * LML_TILE +
               (size_t)w * (nt - 1) * LML_TILE
         : sm + L.pbuf);
  Real (*D)[LML_PANEL + 1] =
      reinterpret_cast<Real (*)[LML_PANEL + 1]>(sm + L.dl);
  Real* zb = sm + L.zb;
  Real* yl = sm + L.y;
  Real* carry = sm + L.carry;      // quad, logdet, failed (CTA 0's is live)

  const Real* u = us + (size_t)w * d * np_;
  const Real* nz = noise + (size_t)w * np_;
  const Real a = alpha[w];

  // --- build this CTA's tiles of K's lower triangle, and its y slices ------
  const int ntiles = lml_tile_base(rank, rows, C);
  for (int e = tid; e < ntiles * LML_TILE; e += T) {
    const int t = e / LML_TILE, r = (e / LML_PANEL) % LML_PANEL;
    const int c = e % LML_PANEL;
    int l = 0, base = 0;
    while (base + rank + l * C + 1 <= t) base += rank + (l++) * C + 1;
    const int i = LML_PANEL * (rank + l * C) + r;
    const int j = LML_PANEL * (t - base) + c;
    Real v = Real(0);
    if (i < np_ && j <= i) {
      Real s = Real(0);
      for (int dd = 0; dd < d; ++dd) {
        const Real diff = u[(size_t)dd * np_ + i] - u[(size_t)dd * np_ + j];
        s += diff * diff;
      }
      v = a * cmoe_unit_f0(s, kernel);
      if (i == j) v += nz[i];
    }
    tiles[(size_t)t * LML_TILE + lml_sw<Real>(r, c)] = v;
  }
  for (int e = tid; e < rows * LML_PANEL; e += T) {
    const int i = LML_PANEL * (rank + (e / LML_PANEL) * C) + e % LML_PANEL;
    yl[e] = i < np_ ? y[(size_t)w * np_ + i] : Real(0);
  }
  if (rank == 0 && tid < 3) carry[tid] = Real(0);
  cluster.sync();    // every CTA is running and built before any DSMEM access

  for (int k = 0; k < nt; ++k) {
    const int c0 = k * LML_PANEL;
    const int pw = min(LML_PANEL, np_ - c0);

    // --- (a) the owner factors the diagonal tile, substitutes y, and
    //     sends L11 and z_k to every CTA -----------------------------------
    if (rank == k % C) {
      if (tid < 32) {
        const int r = tid;
        Real* cr = cluster.map_shared_rank(carry, 0);
        Real quad = Real(0), logdet = Real(0), failed = Real(0);
        if (r == 0) { quad = cr[0]; logdet = cr[1]; failed = cr[2]; }
        const Real* Akk =
            tiles + (size_t)(lml_tile_base(rank, k / C, C) + k) * LML_TILE;
        Real row[LML_PANEL];
#pragma unroll
        for (int c = 0; c < LML_PANEL; ++c) {
          Real v = Real(0);
          if (r < pw && c <= r) v = Akk[lml_sw<Real>(r, c)];
          if (r >= pw && c == r) v = Real(1);       // identity padding
          row[c] = v;
        }
        // float64: each pivot's reciprocal square root, and products by it
        // in place of a square root and a division per lane (no float64
        // division anywhere; rinv keeps 1 / L_rr for the substitutions);
        // column j reaches every lane through zb (free until z is written),
        // two elements a load, in place of two shuffles an element
        Real rinv = Real(1);
#pragma unroll
        for (int j = 0; j < LML_PANEL; ++j) {
          if constexpr (F64) {
            const Real dj = __shfl_sync(0xffffffffu, row[j], j);
            const Real inv = rsqrt(dj);
            if (r == j) { row[j] = dj * inv; rinv = inv; }
            else if (r > j) row[j] *= inv;
            __syncwarp();
            zb[r] = row[j];
            __syncwarp();
            const V* col = reinterpret_cast<const V*>(zb);
#pragma unroll
            for (int c2 = (j + 1) / 2; c2 < LML_PANEL / 2; ++c2) {
              const V v = col[c2];
              if (2 * c2 > j && r >= 2 * c2)
                row[2 * c2] -= row[j] * lml_el(v, 0);
              if (r >= 2 * c2 + 1) row[2 * c2 + 1] -= row[j] * lml_el(v, 1);
            }
          } else {
            const Real piv = sqrtf(__shfl_sync(0xffffffffu, row[j], j));
            if (r == j) row[j] = piv;
            else if (r > j) row[j] = row[j] / piv;
#pragma unroll
            for (int c = j + 1; c < LML_PANEL; ++c) {
              const Real lcj = __shfl_sync(0xffffffffu, row[j], c);
              if (r >= c) row[c] -= row[j] * lcj;
            }
          }
        }
        // forward substitution by columns: lane j subtracts L[j][0] z_0,
        // ..., L[j][j-1] z_{j-1} in that order, as a serial loop would
        Real acc = r < pw ? yl[(k / C) * LML_PANEL + r] : Real(0);
        Real z = Real(0), ljj = Real(1);
#pragma unroll
        for (int j = 0; j < LML_PANEL; ++j) {
          if (r == j) {
            ljj = row[j];
            if constexpr (F64) z = acc * rinv;
            else z = acc / ljj;
          }
          const Real zj = __shfl_sync(0xffffffffu, z, j);
          if (r > j) acc -= row[j] * zj;
        }
#pragma unroll
        for (int c = 0; c < LML_PANEL; ++c)
          D[r][c] = (c <= r) ? row[c] : Real(0);
        if constexpr (F64) D[r][LML_PANEL] = rinv;   // the padding column
        zb[r] = z;
        const Real lg = lml_log(ljj);
        if (__any_sync(0xffffffffu, r < pw && !(ljj > Real(0))))
          failed = Real(1);
        if constexpr (F64) {
          // the masked sums as a tree over the lanes, carried from panel to
          // panel
          const bool in = r < pw && c0 + r < n_real;
          Real qs = in ? z * z : Real(0), ls = in ? lg : Real(0);
#pragma unroll
          for (int o = 16; o > 0; o >>= 1) {
            qs += __shfl_xor_sync(0xffffffffu, qs, o);
            ls += __shfl_xor_sync(0xffffffffu, ls, o);
          }
          quad += qs;
          logdet += ls;
        } else {
          // the masked sums in row order, carried from panel to panel
#pragma unroll
          for (int j = 0; j < LML_PANEL; ++j) {
            const Real zj = __shfl_sync(0xffffffffu, z, j);
            const Real lj = __shfl_sync(0xffffffffu, lg, j);
            if (j < pw && c0 + j < n_real) {
              quad += zj * zj;
              logdet += lj;
            }
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
      const V* ai = reinterpret_cast<const V*>(tiles) +
          (size_t)(lml_tile_base(rank, l, C) + k) * (LML_TILE / E) + r * Q;
      Real x[LML_PANEL];
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const V v = ai[q ^ (r & 7)];
#pragma unroll
        for (int h = 0; h < E; ++h) x[E * q + h] = lml_el(v, h);
      }
      Real ydot = Real(0);
#pragma unroll
      for (int j = 0; j < LML_PANEL; ++j) {
        if (j < pw) {
          Real acc = x[j];
#pragma unroll
          for (int kk = 0; kk < j; ++kk) acc -= D[j][kk] * x[kk];
          if constexpr (F64) x[j] = acc * D[j][LML_PANEL];  // 1 / L_jj
          else x[j] = acc / D[j][j];
          ydot += x[j] * zb[j];
        } else {
          x[j] = Real(0);
        }
      }
      yl[t] -= ydot;
      V* dst = pbufv + (size_t)(i - k - 1) * (LML_TILE / E) + r * Q;
      if constexpr (PG) {          // the walker's one copy, in the scratch
#pragma unroll
        for (int q = 0; q < Q; ++q) dst[q ^ (r & 7)] = lml_pack(x + E * q);
        continue;
      }
      for (int o = 0; o < C; ++o) {
        if (o + (lml_rows_of(o, nt, C) - 1) * C < i) continue;  // not needed
        V* po = cluster.map_shared_rank(dst, o);
#pragma unroll
        for (int q = 0; q < Q; ++q) po[q ^ (r & 7)] = lml_pack(x + E * q);
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
      const V* Li = pbufv + (size_t)(i - k - 1) * (LML_TILE / E);
      const V* Lj = pbufv + (size_t)(j - k - 1) * (LML_TILE / E);
      Real acc[4][4];
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int s = 0; s < 4; ++s) acc[p][s] = Real(0);
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        V li[4], lj[4];
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          li[p] = lml_ld<PG>(Li + (tr + 8 * p) * Q + (q ^ tr));
          lj[p] = lml_ld<PG>(Lj + (tc + 8 * p) * Q + (q ^ tc));
        }
#pragma unroll
        for (int kk = 0; kk < E; ++kk)
#pragma unroll
          for (int p = 0; p < 4; ++p)
#pragma unroll
            for (int s = 0; s < 4; ++s)
              acc[p][s] += lml_el(li[p], kk) * lml_el(lj[s], kk);
      }
      Real* At = tiles + (size_t)(lml_tile_base(rank, l, C) + j) * LML_TILE;
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int s = 0; s < 4; ++s)
          At[lml_sw<Real>(tr + 8 * p, tc + 8 * s)] -= acc[p][s];
    }
    __syncthreads();
  }

  cluster.sync();    // no CTA leaves while a peer may still write to it
  if (rank == 0 && tid == 0) {
    const bool failed = carry[2] != Real(0);
    quad_out[w] = failed ? lml_nan(Real(0)) : carry[0];
    logdet_out[w] = failed ? lml_nan(Real(0)) : carry[1];
  }
}

#define LML_SMEM_LIMIT 232448   // shared memory one H100 block may opt into

template <typename Real>
static int lml_cluster_bytes(int np_, int c) {
  return lml_layout(np_, c).elems * (int)sizeof(Real);
}

// The large-Np instance keeps its panel buffer on chip while it fits.
template <typename Real>
static bool lml_global_pbuf_on_chip(int np_) {
  return lml_layout(np_, LML_CLUSTER, false, true).elems *
             (int)sizeof(Real) <= LML_SMEM_LIMIT;
}

template <typename Real>
static int lml_global_bytes(int np_) {
  return lml_layout(np_, LML_CLUSTER, false,
                    lml_global_pbuf_on_chip<Real>(np_)).elems *
         (int)sizeof(Real);
}

// Elements of the large-Np instance's global scratch per walker.
template <typename Real>
static int lml_global_scratch(int np_) {
  return (int)lml_scratch_elems(lml_layout(np_, LML_CLUSTER), 1, LML_CLUSTER,
                                lml_global_pbuf_on_chip<Real>(np_));
}

extern "C" int cmoe_lml_fused_cluster_smem_bytes(int np_) {
  return lml_cluster_bytes<float>(np_, LML_CLUSTER);
}

extern "C" int cmoe_lml_fused_cluster_smem_bytes_f64(int np_) {
  return lml_cluster_bytes<double>(np_, LML_CLUSTER);
}

extern "C" int cmoe_lml_fused_global_smem_bytes(int np_) {
  return lml_global_bytes<float>(np_);
}

extern "C" int cmoe_lml_fused_global_smem_bytes_f64(int np_) {
  return lml_global_bytes<double>(np_);
}

// Floats of the large-Np instance's global scratch per walker.
extern "C" int cmoe_lml_fused_global_scratch_floats(int np_) {
  return lml_global_scratch<float>(np_);
}

// Doubles of the float64 large-Np instance's global scratch per walker.
extern "C" int cmoe_lml_fused_global_scratch_f64(int np_) {
  return lml_global_scratch<double>(np_);
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

template <typename Real, bool KG, bool PG>
static int lml_launch(const Real* us, const Real* alpha, const Real* noise,
                      const Real* y, Real* scratch, Real* quad,
                      Real* logdet, int W, int d, int np_, int n_real,
                      int kernel, int bytes, void* stream) {
  cudaError_t e = cudaFuncSetAttribute(
      cmoe_lml_fused_cluster_kernel<Real, KG, PG>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      lml_cluster_config(W, LML_CLUSTER, bytes, &attr, stream);
  e = cudaLaunchKernelEx(&cfg, cmoe_lml_fused_cluster_kernel<Real, KG, PG>,
                         us, alpha, noise, y, scratch, quad, logdet, d, np_,
                         n_real, kernel);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename Real>
static int lml_cluster(const Real* us, const Real* alpha, const Real* noise,
                       const Real* y, Real* quad, Real* logdet, int W, int d,
                       int np_, int n_real, int kernel, void* stream) {
  return lml_launch<Real, false, false>(
      us, alpha, noise, y, nullptr, quad, logdet, W, d, np_, n_real, kernel,
      lml_cluster_bytes<Real>(np_, LML_CLUSTER), stream);
}

template <typename Real>
static int lml_global(const Real* us, const Real* alpha, const Real* noise,
                      const Real* y, Real* scratch, Real* quad, Real* logdet,
                      int W, int d, int np_, int n_real, int kernel,
                      void* stream) {
  const int bytes = lml_global_bytes<Real>(np_);
  if (lml_global_pbuf_on_chip<Real>(np_))
    return lml_launch<Real, true, false>(us, alpha, noise, y, scratch, quad,
                                         logdet, W, d, np_, n_real, kernel,
                                         bytes, stream);
  return lml_launch<Real, true, true>(us, alpha, noise, y, scratch, quad,
                                      logdet, W, d, np_, n_real, kernel,
                                      bytes, stream);
}

extern "C" int cmoe_lml_fused_cluster(const float* us, const float* alpha,
                                      const float* noise, const float* y,
                                      float* quad, float* logdet, int W,
                                      int d, int np_, int n_real, int kernel,
                                      void* stream) {
  return lml_cluster<float>(us, alpha, noise, y, quad, logdet, W, d, np_,
                            n_real, kernel, stream);
}

extern "C" int cmoe_lml_fused_cluster_f64(const double* us,
                                          const double* alpha,
                                          const double* noise,
                                          const double* y, double* quad,
                                          double* logdet, int W, int d,
                                          int np_, int n_real, int kernel,
                                          void* stream) {
  return lml_cluster<double>(us, alpha, noise, y, quad, logdet, W, d, np_,
                             n_real, kernel, stream);
}

// scratch: W cmoe_lml_fused_global_scratch_floats(np_) floats.
extern "C" int cmoe_lml_fused_global(const float* us, const float* alpha,
                                     const float* noise, const float* y,
                                     float* scratch, float* quad,
                                     float* logdet, int W, int d, int np_,
                                     int n_real, int kernel, void* stream) {
  return lml_global<float>(us, alpha, noise, y, scratch, quad, logdet, W, d,
                           np_, n_real, kernel, stream);
}

// scratch: W cmoe_lml_fused_global_scratch_f64(np_) doubles.
extern "C" int cmoe_lml_fused_global_f64(const double* us,
                                         const double* alpha,
                                         const double* noise,
                                         const double* y, double* scratch,
                                         double* quad, double* logdet, int W,
                                         int d, int np_, int n_real,
                                         int kernel, void* stream) {
  return lml_global<double>(us, alpha, noise, y, scratch, quad, logdet, W, d,
                            np_, n_real, kernel, stream);
}

template <typename Real, bool KG, bool PG>
static int lml_occupancy(int W, int c, int bytes, int* clusters) {
  const void* fn = (const void*)cmoe_lml_fused_cluster_kernel<Real, KG, PG>;
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

// cudaOccupancyMaxActiveClusters for the float32 cluster kernel at W
// walkers, clusters of c CTAs (c > 8 is the non-portable size) holding
// `bytes` of shared memory each.
extern "C" int cmoe_lml_fused_cluster_occupancy(int W, int c, int bytes,
                                                int* clusters) {
  return lml_occupancy<float, false, false>(W, c, bytes, clusters);
}

template <typename Real>
static int lml_global_occupancy(int W, int np_, int* clusters) {
  const int bytes = lml_global_bytes<Real>(np_);
  return lml_global_pbuf_on_chip<Real>(np_)
             ? lml_occupancy<Real, true, false>(W, LML_CLUSTER, bytes,
                                                clusters)
             : lml_occupancy<Real, true, true>(W, LML_CLUSTER, bytes,
                                               clusters);
}

// The same for the large-Np instance at W walkers and Np.
extern "C" int cmoe_lml_fused_global_occupancy(int W, int np_,
                                               int* clusters) {
  return lml_global_occupancy<float>(W, np_, clusters);
}

extern "C" int cmoe_lml_fused_global_occupancy_f64(int W, int np_,
                                                   int* clusters) {
  return lml_global_occupancy<double>(W, np_, clusters);
}
