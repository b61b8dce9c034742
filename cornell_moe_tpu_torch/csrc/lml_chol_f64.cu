// The log marginal likelihood's two reductions of a few large float64
// systems, by a tiled Cholesky factorization on the FP64 tensor cores: for
// each of W matrices K_w (N x N, float64, K + diag(noise) as the plain path
// assembles it; only the lower triangle is read) and right-hand sides y_w,
//   quad_w = |L_w^-1 y_w|^2,  half_logdet_w = sum_i log (L_w)_ii,
// with K_w = L_w L_w^T.  K_w is factored in place: on return its lower
// triangle holds L_w.  A pivot that is not positive and finite gives NaN
// for both, as cholesky_ex's info does on the plain path.
//
// Replaces no TPU kernel.  The JAX package's float64 and derivative-channel
//   chains take jnp.linalg.cholesky (its Pallas LML kernel is float32 and
//   value channels only); the port's counterpart of that was the plain LML,
//   cuSOLVER's batched float64 potrf and two triangular solves.  At the
//   d-KG refit's K side 1536 with 8 walkers a half-step those took 5.1 ms a
//   call: batched routines built for many small matrices, at under 5% of
//   the card's float64 tensor-core rate, and a transposed solve the LML
//   does not need.
//
// Bound on the H100: the fp64_mma pipe.  W N^3 / 3 FLOP (9.66 GFLOP at W 8,
//   N 1536: 0.144 ms at 67 TFLOP/s) against 75 MB of K's lower triangle
//   (0.022 ms at 3.35 TB/s).  What keeps a tiled factorization of only 8
//   matrices from that rate is its critical path: the 24 diagonal tiles,
//   each factored after the panel and the update before it, 64 dependent
//   pivots each.
//
// Design: one persistent kernel, 2 CTAs of 8 warps on each SM, walking a
//   queue of tile tasks.  K is cut into 64 x 64 tiles and factored
//   right-looking, each task one tile of one walker:
//   - POTRF(j) first makes the panel tile L_j,j-1 (below), whose border
//     row is b_j, then subtracts L_j,j-1 L_j,j-1^T from tile (j, j) and
//     factors it in shared memory (chol_factor_diag: four 16-column
//     blocks, each factored by one warp in registers with shuffles, its
//     panel and trailing update and the blocks of L_jj^-1 on the tensor
//     cores), and solves the border: the forward solve rides in the
//     factorization as the last row of the bordered matrix [[K, 0],
//     [y^T, .]], whose row of L is (L^-1 y)^T, so z_j = L_jj^-1 b_j and no
//     transposed solve runs;
//   - TRSM(i, j), i >= j + 2, makes L_ij = A_ij L_jj^-T and updates the
//     border, b_i -= L_ij z_j;
//   - UPDATE(i, j, klo..khi) subtracts L_ik L_jk^T for up to CHOL_GROUP
//     columns k from tile (i, j) in place; a tile's last update comes with
//     the task that makes it L_ij.
//   Products run on the tensor cores (mma.sync m8n8k4 f64; wgmma has no f64
//   form), their operands staged in shared memory by cp.async through L2.
//   Each tile keeps a counter in scratch, the number of updates it has
//   taken, j + 1 once it holds L_ij: a task waits (acquire) on the counters
//   it reads and publishes its own (release), so the updates of a tile land
//   in k order and every result is the same whatever CTA runs what.  Tasks
//   are taken from a global counter in an order in which a task waits only
//   on lower-numbered ones, so a taken task always finishes and no schedule
//   deadlocks.  The order gives look-ahead (chol_decode): each step puts
//   the next diagonal tile, which makes its own panel tile, first, then the
//   trailing updates that are ready, spread evenly over the steps, then
//   the rest of the panel, so the diagonal tiles are factored as soon as
//   their last update lands, with no grid-wide drain between panel steps.
//   What bounds it then is that chain: about 24 us a step at W 1 (the
//   panel tile 5, the factorization 16, its stores 3), 17 of them in the
//   warps' pivot steps and barriers.  Each POTRF leaves z_j, sum z_j^2 and
//   sum log L_ii in scratch, and the walker's last one sums them in column
//   order.  Rows past N read as the identity (a ragged N adds 0 to quad
//   and to half_logdet); stores past N are masked.  The wrapper
//   (ops/kernels.py lml_chol_f64) allocates the scratch and zeroes the
//   counters and the queue, so the kernel allocates nothing and waits on no
//   host: it is capturable, and a replay equals the eager call bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

#define CHOL_T 64          // tile side
#define CHOL_LDS 68        // shared row pitch (doubles): 16-byte rows, and an
                           // mma fragment's 8 rows x 4 columns in 16 banks
#define CHOL_THREADS 256   // 8 warps; warp w holds rows 32 (w & 1) .. +31 and
                           // columns 16 (w >> 1) .. +15 of a tile's product
#define CHOL_TILE (CHOL_T * CHOL_LDS)
// shared memory, in doubles: tiles A and B, z, the pivots, the quarter
// sums, v, and the task
#define CHOL_SMEM_DOUBLES (2 * CHOL_TILE + 64 + 64 + 4 * 64 + 64 + 4)
#define CHOL_SMEM_BYTES (CHOL_SMEM_DOUBLES * 8)

#define CHOL_GROUP 8       // updates of one tile per UPDATE task
#define CHOL_UPDATE 0
#define CHOL_POTRF 1
#define CHOL_TRSM 2

// PTX wrappers

__device__ __forceinline__ void chol_cp_async16(double* dst,
                                                const double* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s), "l"(src)
               : "memory");
}

__device__ __forceinline__ void chol_cp_async_wait() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// Loads past L1: other SMs wrote the data since this one may have cached it.
__device__ __forceinline__ double chol_ld_cg(const double* p) {
  double v;
  asm volatile("ld.global.cg.f64 %0, [%1];" : "=d"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void chol_ld_cg2(const double* p, double& a,
                                            double& b) {
  asm volatile("ld.global.cg.v2.f64 {%0,%1}, [%2];"
               : "=d"(a), "=d"(b)
               : "l"(p)
               : "memory");
}

__device__ __forceinline__ int chol_ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];" : "=r"(v) : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void chol_st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

// c (8 x 8; this lane's row lane / 4, columns 2 (lane % 4) + {0, 1})
// += a (8 x 4; row lane / 4, column lane % 4) b (4 x 8; row lane % 4,
// column lane / 4), on the FP64 tensor cores.
__device__ __forceinline__ void chol_dmma(double& c0, double& c1, double a,
                                          double b) {
  asm("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0,%1}, {%2}, {%3}, "
      "{%0,%1};"
      : "+d"(c0), "+d"(c1)
      : "d"(a), "d"(b));
}

// 1 / d and 1 / sqrt(d) from the special-function unit's approximations
// and two Newton steps each (to the last bit or one from it: the IEEE
// division and square root are long subroutines, and the diagonal
// factorization's pivot chain waits on one of these per column).  NaN for
// d <= 0 in chol_rsqrt and for d = 0 or infinite in chol_rcp.
__device__ __forceinline__ double chol_rcp(double d) {
  double r;
  asm("rcp.approx.ftz.f64 %0, %1;" : "=d"(r) : "d"(d));
  double e = fma(-d, r, 1.0);
  r = fma(r, e, r);
  e = fma(-d, r, 1.0);
  return fma(r, e, r);
}

__device__ __forceinline__ double chol_rsqrt(double d) {
  double y;
  asm("rsqrt.approx.ftz.f64 %0, %1;" : "=d"(y) : "d"(d));
  const double h = 0.5 * d;
  y *= fma(-h * y, y, 1.5);
  y *= fma(-h * y, y, 1.5);
  return y;
}

// end of PTX wrappers

__device__ __forceinline__ void chol_wait(const int* counter, int value) {
  while (chol_ld_acquire(counter) < value) __nanosleep(32);
}

// A 64 x 64 tile of a row-major matrix (row pitch ld) into shared memory at
// pitch CHOL_LDS; rows >= nr and columns >= nc read as 0.  16-byte copies
// (cp.async, through L2 only) where both columns of a pair are in range and
// the rows are 16-byte aligned (vec), else 8-byte loads past L1.  The
// caller waits (chol_cp_async_wait) and syncs.
__device__ __forceinline__ void chol_load_tile(double* dst, const double* src,
                                               size_t ld, int nr, int nc,
                                               bool vec, int t) {
  for (int e = t; e < CHOL_T * CHOL_T / 2; e += CHOL_THREADS) {
    const int r = e >> 5, c = (e & 31) * 2;
    double* d = dst + r * CHOL_LDS + c;
    const double* s = src + (size_t)r * ld + c;
    if (vec && r < nr && c + 1 < nc) {
      chol_cp_async16(d, s);
    } else {
      d[0] = r < nr && c < nc ? chol_ld_cg(s) : 0.0;
      d[1] = r < nr && c + 1 < nc ? chol_ld_cg(s + 1) : 0.0;
    }
  }
}

// The warp's 32 x 16 block of a tile product: acc[mi][ni][e] is row
// chol_row(warp, lane, mi), column chol_col(warp, lane, ni) + e.
__device__ __forceinline__ int chol_row(int warp, int lane, int mi) {
  return 32 * (warp & 1) + 8 * mi + (lane >> 2);
}

__device__ __forceinline__ int chol_col(int warp, int lane, int ni) {
  return 16 * (warp >> 1) + 8 * ni + 2 * (lane & 3);
}

// acc += sign A B^T, A and B 64 x 64 tiles in shared memory.
__device__ __forceinline__ void chol_mma_tile(double (&acc)[4][2][2],
                                              const double* A,
                                              const double* B, double sign,
                                              int warp, int lane) {
  const double* a0 = A + chol_row(warp, lane, 0) * CHOL_LDS + (lane & 3);
  const double* b0 =
      B + (16 * (warp >> 1) + (lane >> 2)) * CHOL_LDS + (lane & 3);
#pragma unroll 4
  for (int k = 0; k < CHOL_T; k += 4) {
    double a[4], b[2];
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) a[mi] = sign * a0[8 * mi * CHOL_LDS + k];
#pragma unroll
    for (int ni = 0; ni < 2; ++ni) b[ni] = b0[8 * ni * CHOL_LDS + k];
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int ni = 0; ni < 2; ++ni)
        chol_dmma(acc[mi][ni][0], acc[mi][ni][1], a[mi], b[ni]);
  }
}

// acc into the tile at g (row pitch n): rows < nr, columns < nc, and on a
// diagonal tile (lower) columns <= row only.
__device__ __forceinline__ void chol_store_acc(const double (&acc)[4][2][2],
                                               double* g, size_t n, int nr,
                                               int nc, bool lower, bool vec,
                                               int warp, int lane) {
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 2; ++ni) {
      const int r = chol_row(warp, lane, mi), c = chol_col(warp, lane, ni);
      if (r >= nr) continue;
      const int ce = lower && nc > r + 1 ? r + 1 : nc;   // columns < ce
      double* p = g + (size_t)r * n + c;
      if (vec && c + 1 < ce) {
        *reinterpret_cast<double2*>(p) =
            make_double2(acc[mi][ni][0], acc[mi][ni][1]);
      } else {
        if (c < ce) p[0] = acc[mi][ni][0];
        if (c + 1 < ce) p[1] = acc[mi][ni][1];
      }
    }
}

// Row r's sum over the quarter h of the columns of a 64 x 64 shared tile
// times a vector (the start rotated by r, so that a warp's 32 rows read 16
// banks twice).
__device__ __forceinline__ double chol_quarter_dot(const double* M,
                                                   const double* v, int r,
                                                   int h) {
  double s = 0.0;
#pragma unroll
  for (int cc = 0; cc < 16; ++cc) {
    const int c = 16 * h + ((cc + r) & 15);
    s = fma(M[r * CHOL_LDS + c], v[c], s);
  }
  return s;
}

// acc (an 8 x 8 tile: this lane's row lane / 4, columns 2 (lane % 4) +
// {0, 1}) += sign A B over depth kd (a multiple of 4), A row-major and B
// given as Bt (n x k, bt) or as B (k x n), all in shared memory at pitch
// CHOL_LDS.
__device__ __forceinline__ void chol_mma8(double& c0, double& c1,
                                          const double* A, const double* B,
                                          int kd, bool bt, double sign,
                                          int lane) {
  const double* a = A + (lane >> 2) * CHOL_LDS + (lane & 3);
  const double* b = bt ? B + (lane >> 2) * CHOL_LDS + (lane & 3)
                       : B + (lane & 3) * CHOL_LDS + (lane >> 2);
  for (int k = 0; k < kd; k += 4)
    chol_dmma(c0, c1, sign * a[k], bt ? b[k] : b[k * CHOL_LDS]);
}

// The 8 x 8 tile at p (pitch CHOL_LDS) to and from an mma accumulator.
__device__ __forceinline__ void chol_get8(const double* p, double& c0,
                                          double& c1, int lane) {
  p += (lane >> 2) * CHOL_LDS + 2 * (lane & 3);
  c0 = p[0];
  c1 = p[1];
}

__device__ __forceinline__ void chol_put8(double* p, double c0, double c1,
                                          int lane) {
  p += (lane >> 2) * CHOL_LDS + 2 * (lane & 3);
  p[0] = c0;
  p[1] = c1;
}

// The diagonal tile (64 x 64 at S, pitch CHOL_LDS; its lower triangle)
// factored in place, S = L L^T, and L^-1 written to I (zero above the
// diagonal), the pivots L_ii^2 to piv.  Four blocks of 16 columns, each
// (1) factored by warp 0 in registers, lane l holding row l of the block:
// step j broadcasts the pivot and column j by shuffles, with no barrier,
// and subtracts m_l = S_lj / S_jj times column j from the later rows, so
// that the block ends as L1 D (L1 unit lower, D the pivots) and L = S
// D^-1/2; then lane l forms column l of the block's L^-1 by forward
// substitution; (2) its panel below, X = S L^-T, and (3) the trailing
// update S -= X X^T, both on the tensor cores in 8 x 8 tiles.  Then the
// blocks of L^-1 below the diagonal, block row by block row:
// (L^-1)_bc = -(L^-1)_bb sum_{m=c}^{b-1} L_bm (L^-1)_mc.  Ends synced.
__device__ void chol_factor_diag(double* S, double* I, double* piv, int t) {
  const int warp = t >> 5, lane = t & 31;
  for (int e = t; e < CHOL_TILE; e += CHOL_THREADS) I[e] = 0.0;
  __syncthreads();
  for (int b = 0; b < 4; ++b) {
    const int c0 = 16 * b;
    if (warp == 0) {
      const int l = lane & 15;   // lanes 16 .. 31 repeat lanes 0 .. 15
      double* row = S + (c0 + l) * CHOL_LDS + c0;
      double s[16];
#pragma unroll
      for (int c = 0; c < 16; ++c) s[c] = c <= l ? row[c] : 0.0;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const double d = __shfl_sync(0xffffffffu, s[j], j);
        const double m = s[j] * chol_rcp(d);
        if (lane == 0) piv[c0 + j] = d;
#pragma unroll
        for (int c = j + 1; c < 16; ++c) {
          const double v = __shfl_sync(0xffffffffu, s[j], c);
          if (l > j && c <= l) s[c] = fma(-m, v, s[c]);
        }
      }
      __syncwarp();
      const double rs = chol_rsqrt(piv[c0 + l]);   // 1 / L_ll
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const double v = __shfl_sync(0xffffffffu, rs, c);
        if (lane < 16) row[c] = c <= l ? s[c] * v : 0.0;
      }
      __syncwarp();
      // column l of the block's L^-1: x_r = (delta_rl - sum_{m<r} L_rm x_m)
      // / L_rr
      double x[16];
      double* icol = I + c0 * CHOL_LDS + c0 + l;
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        const double* lr = S + (c0 + r) * CHOL_LDS + c0;
        double a = r == l ? 1.0 : 0.0, a2 = 0.0;   // two chains
#pragma unroll
        for (int m = 0; m + 1 < r; m += 2) {
          a = fma(-lr[m], x[m], a);
          a2 = fma(-lr[m + 1], x[m + 1], a2);
        }
        if (r & 1) a = fma(-lr[r - 1], x[r - 1], a);
        x[r] = (a + a2) * __shfl_sync(0xffffffffu, rs, r);
        if (lane < 16) icol[r * CHOL_LDS] = x[r];
      }
    }
    __syncthreads();
    // (2) the panel, rows c0 + 16 .. 63: (48 - c0) / 8 x 2 tiles
    const int r8 = (48 - c0) / 8;
    double x[2][2];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int tt = warp + 8 * q, ti = tt >> 1, tj = tt & 1;
      x[q][0] = x[q][1] = 0.0;
      if (ti < r8)
        chol_mma8(x[q][0], x[q][1], S + (c0 + 16 + 8 * ti) * CHOL_LDS + c0,
                  I + (c0 + 8 * tj) * CHOL_LDS + c0, 16, true, 1.0, lane);
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int tt = warp + 8 * q, ti = tt >> 1, tj = tt & 1;
      if (ti < r8)
        chol_put8(S + (c0 + 16 + 8 * ti) * CHOL_LDS + c0 + 8 * tj, x[q][0],
                  x[q][1], lane);
    }
    __syncthreads();
    // (3) the trailing update, its lower 8 x 8 tiles
    for (int tt = warp; tt < r8 * (r8 + 1) / 2; tt += 8) {
      int ti = 0, tj = tt;
      while (tj > ti) tj -= ++ti;
      double* out = S + (c0 + 16 + 8 * ti) * CHOL_LDS + c0 + 16 + 8 * tj;
      double a0, a1;
      chol_get8(out, a0, a1, lane);
      chol_mma8(a0, a1, S + (c0 + 16 + 8 * ti) * CHOL_LDS + c0,
                S + (c0 + 16 + 8 * tj) * CHOL_LDS + c0, 16, true, -1.0,
                lane);
      chol_put8(out, a0, a1, lane);
    }
    __syncthreads();
  }
  // L^-1 below the diagonal blocks: block row b has b blocks of 2 x 2 tiles
  for (int b = 1; b < 4; ++b) {
    double x[2][2];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int tt = warp + 8 * q, c = tt >> 2, ti = (tt >> 1) & 1,
                tj = tt & 1;
      if (c >= b) continue;
      double a0 = 0.0, a1 = 0.0;
      for (int m = c; m < b; ++m)
        chol_mma8(a0, a1, S + (16 * b + 8 * ti) * CHOL_LDS + 16 * m,
                  I + 16 * m * CHOL_LDS + 16 * c + 8 * tj, 16, false, 1.0,
                  lane);
      chol_put8(I + (16 * b + 8 * ti) * CHOL_LDS + 16 * c + 8 * tj, a0, a1,
                lane);
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int tt = warp + 8 * q, c = tt >> 2, ti = (tt >> 1) & 1,
                tj = tt & 1;
      x[q][0] = x[q][1] = 0.0;
      if (c < b)
        chol_mma8(x[q][0], x[q][1],
                  I + (16 * b + 8 * ti) * CHOL_LDS + 16 * b,
                  I + 16 * b * CHOL_LDS + 16 * c + 8 * tj, 16, false, -1.0,
                  lane);
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int tt = warp + 8 * q, c = tt >> 2, ti = (tt >> 1) & 1,
                tj = tt & 1;
      if (c < b)
        chol_put8(I + (16 * b + 8 * ti) * CHOL_LDS + 16 * c + 8 * tj,
                  x[q][0], x[q][1], lane);
    }
    __syncthreads();
  }
}

// Task number -> {kind, i, j, klo, khi, w}; false past the last task.
// Tile (i, j) takes its updates 0 .. j - 1 in k order: the last, with
// column j - 1, in the task that makes it L_ij, the others in UPDATE tasks
// of CHOL_GROUP (G) columns each, counted back from the tile's end:
// [j - 1 - G, j - 2], [j - 1 - 2G, j - 2 - G], ..., the first from 0.  So
// each step ends the groups of every G-th column, and the trailing updates
// are spread evenly over the steps.  POTRF(j) first makes L_j,j-1 (the
// panel tile the next factorization waits on), then L_jj; TRSM(i, j)
// makes L_ij for i >= j + 2.  Per walker (walkers innermost in every
// group): POTRF(0), TRSM(i, 0); then for each step k < nt - 1: POTRF(k +
// 1), the UPDATE tasks whose last column is k, column by column, and
// TRSM(i, k + 1) for i >= k + 3: what runs while POTRF(k + 1) does is what
// is ready, the updates.  Every task comes after the tasks it waits on.
__device__ bool chol_decode(int rest, int W, int nt, int* tk) {
  int kind = -1, i = 0, j = 0, klo = 0, khi = -1;
  const int first = nt > 2 ? W * (nt - 2) : 0;
  if (rest < W) {
    kind = CHOL_POTRF;
  } else if ((rest -= W) < first) {
    kind = CHOL_TRSM;
    i = 2 + rest / W;
  } else {
    rest -= first;
    for (int k = 0; k < nt - 1 && kind < 0; ++k) {
      const int m = nt - 2 - k;   // tile rows from k + 2 on
      const int rows = m > 1 ? W * (m - 1) : 0;
      int d = 0;   // tiles in columns k + 2, k + 2 + G, ...
      for (int c = k + 2; c < nt; c += CHOL_GROUP) d += W * (nt - c);
      if (rest < W) {
        kind = CHOL_POTRF;
        i = j = k + 1;
      } else if ((rest -= W) < d) {
        kind = CHOL_UPDATE;
        int idx = rest / W;
        for (j = k + 2; idx >= nt - j; j += CHOL_GROUP) idx -= nt - j;
        i = j + idx;
        klo = k + 1 > CHOL_GROUP ? k + 1 - CHOL_GROUP : 0;
        khi = k;
      } else if ((rest -= d) < rows) {
        kind = CHOL_TRSM;
        i = k + 3 + rest / W;
        j = k + 1;
        klo = khi = k;
      } else {
        rest -= rows;
      }
    }
    if (kind < 0) return false;
  }
  tk[0] = kind;
  tk[1] = i;
  tk[2] = j;
  tk[3] = klo;
  tk[4] = khi;
  tk[5] = rest % W;
  return true;
}

// acc = this warp's block of the tile at g (row pitch n), 0 past nr rows
// and nc columns.
__device__ __forceinline__ void chol_load_acc(double (&acc)[4][2][2],
                                              const double* g, size_t n,
                                              int nr, int nc, bool vec,
                                              int warp, int lane) {
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 2; ++ni) {
      const int r = chol_row(warp, lane, mi), c = chol_col(warp, lane, ni);
      const double* p = g + (size_t)r * n + c;
      double a0 = 0.0, a1 = 0.0;
      if (vec && r < nr && c + 1 < nc) {
        chol_ld_cg2(p, a0, a1);
      } else {
        if (r < nr && c < nc) a0 = chol_ld_cg(p);
        if (r < nr && c + 1 < nc) a1 = chol_ld_cg(p + 1);
      }
      acc[mi][ni][0] = a0;
      acc[mi][ni][1] = a1;
    }
}

__device__ __forceinline__ void chol_acc_to_smem(const double (&acc)[4][2][2],
                                                 double* S, int warp,
                                                 int lane) {
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 2; ++ni) {
      const int r = chol_row(warp, lane, mi), c = chol_col(warp, lane, ni);
      S[r * CHOL_LDS + c] = acc[mi][ni][0];
      S[r * CHOL_LDS + c + 1] = acc[mi][ni][1];
    }
}

// The block's shared state: the tiles, the border's vectors, the pivots.
struct CholSmem {
  double* tA;
  double* tB;
  double* zsm;
  double* piv;
  double* vred;   // 4 x 64
  double* vsm;
};

// acc = tile (i, j) of the walker's K (Kw, counters cw) once its updates
// before klo have landed, less L_ik L_jk^T for k = klo .. khi (the tiles
// staged in tA, tB).
__device__ __forceinline__ void chol_updated_tile(
    double (&acc)[4][2][2], double* Kw, const int* cw, int n, int nt, int i,
    int j, int klo, int khi, bool vec, const CholSmem& sm, int t) {
  const int warp = t >> 5, lane = t & 31;
  const int nr = n - CHOL_T * i, ncj = n - CHOL_T * j;
  if (t == 0 && klo <= khi) chol_wait(cw + i * nt + j, klo);
  __syncthreads();   // also: the smem of what ran before is free
  chol_load_acc(acc, Kw + (size_t)CHOL_T * i * n + CHOL_T * j, n, nr, ncj,
                vec, warp, lane);
  for (int k = klo; k <= khi; ++k) {
    if (t == 0) {
      chol_wait(cw + i * nt + k, k + 1);
      chol_wait(cw + j * nt + k, k + 1);
    }
    __syncthreads();   // also: the last product's reads are done
    const int nck = n - CHOL_T * k;
    chol_load_tile(sm.tA, Kw + (size_t)CHOL_T * i * n + CHOL_T * k, n, nr,
                   nck, vec, t);
    if (i != j)
      chol_load_tile(sm.tB, Kw + (size_t)CHOL_T * j * n + CHOL_T * k, n, ncj,
                     nck, vec, t);
    chol_cp_async_wait();
    __syncthreads();
    chol_mma_tile(acc, sm.tA, i == j ? sm.tA : sm.tB, -1.0, warp, lane);
  }
}

// The panel tile L_ij = A L_jj^-T of the fully updated tile A in acc,
// once POTRF(j) has published (cjj reaches j + 1): into K at g and into
// tA; then the border, b_i - L_ij z_j, into bout from the first 64 threads
// (b: their b_i).
__device__ __forceinline__ void chol_panel(
    double (&acc)[4][2][2], double* g, int n, int nr, int ncj, bool vec,
    const int* cjj, int j, const double* linv_j, const double* z_j,
    double b, double* bout, const CholSmem& sm, int t) {
  const int warp = t >> 5, lane = t & 31, r64 = t & 63, h = t >> 6;
  if (t == 0) chol_wait(cjj, j + 1);
  __syncthreads();   // also: the update's reads of tA, tB are done
  chol_acc_to_smem(acc, sm.tA, warp, lane);
  chol_load_tile(sm.tB, linv_j, CHOL_T, CHOL_T, CHOL_T, true, t);
  if (t < 64) sm.zsm[t] = chol_ld_cg(z_j + t);
  chol_cp_async_wait();
  __syncthreads();
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 2; ++ni) acc[mi][ni][0] = acc[mi][ni][1] = 0.0;
  chol_mma_tile(acc, sm.tA, sm.tB, 1.0, warp, lane);
  chol_store_acc(acc, g, n, nr, ncj, false, vec, warp, lane);
  __syncthreads();   // the product's reads of tA are done
  chol_acc_to_smem(acc, sm.tA, warp, lane);
  __syncthreads();
  sm.vred[h * 64 + r64] = chol_quarter_dot(sm.tA, sm.zsm, r64, h);
  __syncthreads();
  if (t < 64)
    bout[t] = b - (sm.vred[t] + sm.vred[64 + t] + sm.vred[128 + t] +
                   sm.vred[192 + t]);
}

__device__ __forceinline__ void chol_publish(int* counter, int value, int t) {
  __syncthreads();   // every thread has made its stores of the tile
  if (t == 0) {
    __threadfence();
    chol_st_release(counter, value);
  }
}

// Scratch (the wrapper's): per walker w and tile column j, L_jj^-1 (64 x 64,
// row pitch 64) at linv + (w nt + j) 4096, z_j at zbuf + (w nt + j) 64, the
// border b_j at bbuf + (w nt + j) 64, sum z_j^2 at quadp[w nt + j] and
// sum log (L_jj)_ii at ldp[w nt + j]; the counter of tile (w, i, j) at
// counters[(w nt + i) nt + j] and the queue at counters[W nt nt], all zero
// at launch.
__global__ void __launch_bounds__(CHOL_THREADS, 2)
    cmoe_lml_chol_f64_kernel(double* __restrict__ K,
                             const double* __restrict__ y, int y_stride,
                             double* __restrict__ linv,
                             double* __restrict__ zbuf,
                             double* __restrict__ bbuf,
                             double* __restrict__ quadp,
                             double* __restrict__ ldp, int* counters,
                             double* __restrict__ quad,
                             double* __restrict__ half_logdet, int W, int n) {
  extern __shared__ __align__(16) double chol_smem[];
  CholSmem sm;
  sm.tA = chol_smem;
  sm.tB = sm.tA + CHOL_TILE;
  sm.zsm = sm.tB + CHOL_TILE;
  sm.piv = sm.zsm + 64;
  sm.vred = sm.piv + 64;
  sm.vsm = sm.vred + 256;
  int* task_sm = reinterpret_cast<int*>(sm.vsm + 64);   // 7 ints
  double* tA = sm.tA;
  double* tB = sm.tB;

  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int nt = (n + CHOL_T - 1) / CHOL_T;
  int* queue = counters + (size_t)W * nt * nt;
  const int r64 = t & 63, h = t >> 6;   // a row of the border, its quarter
  const bool vec = (n & 1) == 0 &&
                   ((reinterpret_cast<uintptr_t>(K) & 15) == 0);

  for (;;) {
    if (t == 0) task_sm[6] = chol_decode(atomicAdd(queue, 1), W, nt, task_sm);
    __syncthreads();
    if (!task_sm[6]) break;
    const int kind = task_sm[0], i = task_sm[1], j = task_sm[2];
    const int klo = task_sm[3], khi = task_sm[4], w = task_sm[5];
    double* Kw = K + (size_t)w * n * n;
    int* cw = counters + (size_t)w * nt * nt;
    const int nr = n - CHOL_T * i, ncj = n - CHOL_T * j;
    double* Aij = Kw + (size_t)CHOL_T * i * n + CHOL_T * j;
    double* bw = bbuf + (size_t)w * nt * 64;
    const double* yw = y + (size_t)w * y_stride;
    double acc[4][2][2];

    if (kind == CHOL_UPDATE) {
      chol_updated_tile(acc, Kw, cw, n, nt, i, j, klo, khi, vec, sm, t);
      chol_store_acc(acc, Aij, n, nr, ncj, i == j, vec, warp, lane);
      chol_publish(cw + i * nt + j, khi + 1, t);
    } else if (kind == CHOL_TRSM) {
      // L_ij = A_ij L_jj^-T, then b_i -= L_ij z_j
      chol_updated_tile(acc, Kw, cw, n, nt, i, j, klo, khi, vec, sm, t);
      double b = 0.0;
      if (t < 64)
        b = j == 0 ? (t < nr ? yw[CHOL_T * i + t] : 0.0)
                   : chol_ld_cg(bw + i * 64 + t);
      chol_panel(acc, Aij, n, nr, ncj, vec, cw + j * nt + j, j,
                 linv + ((size_t)w * nt + j) * CHOL_T * CHOL_T,
                 zbuf + ((size_t)w * nt + j) * 64, b, bw + i * 64, sm, t);
      chol_publish(cw + i * nt + j, j + 1, t);
    } else {
      // POTRF(j): for j > 0 first the panel tile L_j,j-1, whose border
      // row is b_j, then the tile (j, j) less L_j,j-1 L_j,j-1^T
      if (j > 0) {
        chol_updated_tile(acc, Kw, cw, n, nt, j, j - 1, j > 1 ? j - 2 : 0,
                          j - 2, vec, sm, t);
        double b = 0.0;
        if (t < 64)
          b = j == 1 ? (t < ncj ? yw[CHOL_T + t] : 0.0)
                     : chol_ld_cg(bw + j * 64 + t);
        chol_panel(acc, Aij - CHOL_T, n, ncj, ncj + CHOL_T, vec,
                   cw + (j - 1) * nt + j - 1, j - 1,
                   linv + ((size_t)w * nt + j - 1) * CHOL_T * CHOL_T,
                   zbuf + ((size_t)w * nt + j - 1) * 64, b, sm.vsm, sm, t);
        chol_publish(cw + j * nt + j - 1, j, t);
        if (t == 0) chol_wait(cw + j * nt + j, j - 1);
        __syncthreads();
        chol_load_acc(acc, Aij, n, nr, ncj, vec, warp, lane);
        chol_mma_tile(acc, tA, tA, -1.0, warp, lane);   // tA: L_j,j-1
      } else {
        chol_load_acc(acc, Aij, n, nr, ncj, vec, warp, lane);
        if (t < 64) sm.vsm[t] = t < ncj ? yw[t] : 0.0;
      }
      __syncthreads();   // the product's reads of tA are done
      chol_acc_to_smem(acc, tA, warp, lane);
      __syncthreads();
      if (t < 64 && t >= ncj) tA[t * CHOL_LDS + t] = 1.0;   // past n: I
      __syncthreads();
      chol_factor_diag(tA, tB, sm.piv, t);
      sm.vred[h * 64 + r64] = chol_quarter_dot(tB, sm.vsm, r64, h);
      __syncthreads();
      if (t < 64)
        sm.zsm[t] = sm.vred[t] + sm.vred[64 + t] + sm.vred[128 + t] +
                    sm.vred[192 + t];
      __syncthreads();
      // L_jj's lower triangle into K, L_jj^-1 and z_j into the scratch
      double* Ig = linv + ((size_t)w * nt + j) * CHOL_T * CHOL_T;
      for (int e = t; e < CHOL_T * CHOL_T; e += CHOL_THREADS) {
        const int r = e >> 6, c = e & 63;
        if (r < ncj && c <= r) Aij[(size_t)r * n + c] = tA[r * CHOL_LDS + c];
        Ig[e] = tB[r * CHOL_LDS + c];
      }
      double qz = 0.0, lg = 0.0;
      int bad = 0;
      if (t < 64) {
        zbuf[((size_t)w * nt + j) * 64 + t] = sm.zsm[t];
        qz = sm.zsm[t] * sm.zsm[t];
        lg = log(sm.piv[t]);
        bad = !(sm.piv[t] > 0.0) || !isfinite(sm.piv[t]);
      }
      bad = __syncthreads_or(bad);
      for (int o = 16; o > 0; o >>= 1) {
        qz += __shfl_xor_sync(0xffffffffu, qz, o);
        lg += __shfl_xor_sync(0xffffffffu, lg, o);
      }
      if (lane == 0 && warp < 2) {
        sm.vred[warp] = qz;
        sm.vred[2 + warp] = lg;
      }
      __syncthreads();
      if (t == 0) {
        const double nan = __longlong_as_double(0x7ff8000000000000LL);
        quadp[(size_t)w * nt + j] = sm.vred[0] + sm.vred[1];
        ldp[(size_t)w * nt + j] =
            bad ? nan : 0.5 * (sm.vred[2] + sm.vred[3]);
        if (j == nt - 1) {
          // every POTRF of walker w came before this one (each waited on
          // the last): their sums, in column order
          double qt = 0.0, lt = 0.0;
          for (int c = 0; c < nt; ++c) {
            qt += chol_ld_cg(quadp + (size_t)w * nt + c);
            lt += chol_ld_cg(ldp + (size_t)w * nt + c);
          }
          quad[w] = isnan(lt) ? nan : qt;
          half_logdet[w] = lt;
        }
      }
      chol_publish(cw + j * nt + j, j + 1, t);
    }
  }
}

// Host entry points

// The CTAs a launch takes: one per task, at most the card's resident CTAs.
static int chol_ctas(int tasks, int* ctas) {
  static int sms = 0, per_sm = 0;
  cudaError_t e = cudaFuncSetAttribute(
      cmoe_lml_chol_f64_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      CHOL_SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  if (per_sm == 0) {
    int dev = 0;
    e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, cmoe_lml_chol_f64_kernel, CHOL_THREADS, CHOL_SMEM_BYTES);
    if (e != cudaSuccess) return (int)e;
    if (per_sm == 0) return (int)cudaErrorInvalidConfiguration;
  }
  *ctas = tasks < sms * per_sm ? tasks : sms * per_sm;
  return (int)cudaSuccess;
}

// Tile tasks per walker at n (chol_decode's order): nt factorizations,
// each with the panel tile below it, the (nt - 1) (nt - 2) / 2 other panel
// tiles, and the UPDATE tasks.
static int chol_tasks(int n) {
  const int nt = (n + CHOL_T - 1) / CHOL_T;
  int tasks = nt + (nt - 1) * (nt - 2) / 2;
  for (int k = 0; k < nt - 1; ++k)
    for (int c = k + 2; c < nt; c += CHOL_GROUP) tasks += nt - c;
  return tasks;
}

// k: W x n x n (factored in place); y: n (y_stride 0) or W x n (y_stride
// n); linv: W nt 4096 doubles; zbuf, bbuf: W nt 64; quadp, ldp: W nt;
// counters: W nt nt + 1 ints, zero.
extern "C" int cmoe_lml_chol_f64(double* k, const double* y, int y_stride,
                                 double* linv, double* zbuf, double* bbuf,
                                 double* quadp, double* ldp, int* counters,
                                 double* quad, double* half_logdet, int W,
                                 int n, void* stream) {
  if (W == 0 || n == 0) return (int)cudaSuccess;
  int ctas = 0;
  const int rc = chol_ctas(W * chol_tasks(n), &ctas);
  if (rc != 0) return rc;
  cmoe_lml_chol_f64_kernel<<<ctas, CHOL_THREADS, CHOL_SMEM_BYTES,
                             (cudaStream_t)stream>>>(
      k, y, y_stride, linv, zbuf, bbuf, quadp, ldp, counters, quad,
      half_logdet, W, n);
  return (int)cudaGetLastError();
}
