// K + diag(noise) for every member of a GP ensemble.
//
// Replaces: cornell_moe_tpu/ops/pallas_kernels.py,
//   pallas_covariance_with_noise_full (_cov_full_kernel), which built one
//   (Np, Np) matrix per program in VMEM and was vmapped over the members.
// Bound on the H100: writes.  The S x n x n f32 output (16 x 512^2 x 4 B =
//   16.8 MB at the main path's shapes, 0.005 ms at 3.35 TB/s) is the only
//   traffic of any size.  Each element costs d IEEE divisions, an accurate
//   sqrtf and expf, about 50 instructions: computed for every element,
//   the instructions take about as long as the writes, so K's symmetry is
//   used to compute each element pair once.
// Design:
// - One block per (member s, pair of 64 x 64 tiles (I, J), I <= J): 36
//   pairs x 16 members = 576 blocks of 256 threads at n = 512, one wave.
//   An off-diagonal tile is computed once and written twice: straight, and
//   transposed through shared memory (rows padded to 65 floats against bank
//   conflicts), so that both writes are row-contiguous.  A diagonal tile is
//   computed whole.  (A variant that wrote each thread's 4 x 4 block and
//   its mirror straight from registers, with no barrier, ran slower on the
//   main path's operands: PERF.md, kernel C.)
// - Each thread owns 4 rows (16 apart) and 4 consecutive columns, and
//   writes each row's 4 values as one 16-byte store where every row start
//   is 16-byte aligned (n % 4 == 0), else as scalar stores.
// - The tile's row and column points are staged once per block in shared
//   memory, (dimension, point) so that a thread reads its 4 column points
//   as one float4, with the lengths beside them, in chunks of COV_DCH
//   dimensions, so any d runs in a fixed 33 KB.  The amplitude sits in a
//   register.
// - The arithmetic is that of the one-thread-per-element kernel this one
//   replaced, element by element: diff = (x_i[dd] - x_j[dd]) / l[dd] in dimension order,
//   acc = fmaf(diff, diff, acc), h0 * cmoe_unit_f0(acc), and + noise[s, i]
//   on the diagonal.  IEEE subtraction and division are antisymmetric and
//   the square drops the sign, so K(j, i) equals K(i, j) bit for bit and
//   the mirrored write keeps every bit of that kernel's output.  Divisions
//   stay divisions and the field stays the accurate one: K feeds a float32
//   Cholesky that is already ill-conditioned.
// - Any n (a ragged last tile is masked), any d, no padding.

#include "common.cuh"

#define COV_TILE 64                     // tile side
#define COV_LDT (COV_TILE + 1)          // row pitch of the transposing tile
#define COV_THREADS 256
#define COV_GROUPS (COV_TILE / 4)       // column groups of 4 per row
#define COV_PASS (COV_THREADS / COV_GROUPS)  // rows per pass of the block
#define COV_ROWS (COV_TILE / COV_PASS)  // rows per thread, COV_PASS apart
#define COV_DCH 32                      // dimensions staged per chunk

__global__ void __launch_bounds__(COV_THREADS)
    cmoe_covariance_with_noise_kernel(const float* __restrict__ x,
                                      const float* __restrict__ hypers,
                                      const float* __restrict__ noise,
                                      float* __restrict__ out, int n, int d,
                                      int nt, int kernel) {
  __shared__ __align__(16) float tile[COV_TILE * COV_LDT];  // straight tile
  __shared__ __align__(16) float xr[COV_DCH * COV_TILE];    // (dd, row)
  __shared__ __align__(16) float xc[COV_DCH * COV_TILE];    // (dd, column)
  __shared__ float sl[COV_DCH];                             // lengths

  // tile pair of this block: pairs enumerated row by row, J from I to nt - 1
  int p = blockIdx.x, I = 0;
  while (p >= nt - I) {
    p -= nt - I;
    ++I;
  }
  const int J = I + p;
  const int s = blockIdx.y;
  const float* h = hypers + (size_t)s * (1 + d);
  const float amp = h[0];
  const int i0 = I * COV_TILE, j0 = J * COV_TILE;
  const int t = threadIdx.x;
  const int r0 = t / COV_GROUPS;      // the thread's first row
  const int c = 4 * (t % COV_GROUPS);  // and first of its 4 columns

  float acc[COV_ROWS][4];
#pragma unroll
  for (int pr = 0; pr < COV_ROWS; ++pr)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[pr][k] = 0.0f;

  for (int d0 = 0; d0 < d; d0 += COV_DCH) {
    const int dn = d - d0 < COV_DCH ? d - d0 : COV_DCH;
    if (d0 > 0) __syncthreads();  // the last chunk's reads are done
    for (int e = t; e < COV_TILE * dn; e += COV_THREADS) {
      const int r = e / dn, dd = e - r * dn;
      xr[dd * COV_TILE + r] =
          i0 + r < n ? x[(size_t)(i0 + r) * d + d0 + dd] : 0.0f;
      xc[dd * COV_TILE + r] =
          j0 + r < n ? x[(size_t)(j0 + r) * d + d0 + dd] : 0.0f;
    }
    if (t < dn) sl[t] = h[1 + d0 + t];
    __syncthreads();
    for (int dd = 0; dd < dn; ++dd) {
      const float l = sl[dd];
      const float4 xj = *reinterpret_cast<const float4*>(xc + dd * COV_TILE +
                                                         c);
#pragma unroll
      for (int pr = 0; pr < COV_ROWS; ++pr) {
        const float xi = xr[dd * COV_TILE + r0 + COV_PASS * pr];
        const float e0 = (xi - xj.x) / l, e1 = (xi - xj.y) / l;
        const float e2 = (xi - xj.z) / l, e3 = (xi - xj.w) / l;
        acc[pr][0] = fmaf(e0, e0, acc[pr][0]);
        acc[pr][1] = fmaf(e1, e1, acc[pr][1]);
        acc[pr][2] = fmaf(e2, e2, acc[pr][2]);
        acc[pr][3] = fmaf(e3, e3, acc[pr][3]);
      }
    }
  }

  const bool vec = (n & 3) == 0;
  float* outs = out + (size_t)s * n * n;
#pragma unroll
  for (int pr = 0; pr < COV_ROWS; ++pr) {
    const int r = r0 + COV_PASS * pr, i = i0 + r;
    float v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      v[k] = amp * cmoe_unit_f0(acc[pr][k], kernel);
      if (i == j0 + c + k) v[k] += noise[(size_t)s * n + i];
      tile[r * COV_LDT + c + k] = v[k];
    }
    if (i >= n) continue;
    float* row = outs + (size_t)i * n + j0 + c;
    if (vec && j0 + c < n) {
      *reinterpret_cast<float4*>(row) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (j0 + c + k < n) row[k] = v[k];
    }
  }
  if (I == J) return;

  // the mirror: row j0 + r, columns i0 + c .. i0 + c + 3 (tile I is full,
  // since I < J)
  __syncthreads();
#pragma unroll
  for (int pr = 0; pr < COV_ROWS; ++pr) {
    const int r = r0 + COV_PASS * pr, j = j0 + r;
    if (j >= n) continue;
    float v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = tile[(c + k) * COV_LDT + r];
    float* row = outs + (size_t)j * n + i0 + c;
    if (vec) {
      *reinterpret_cast<float4*>(row) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) row[k] = v[k];
    }
  }
}

extern "C" int cmoe_covariance_with_noise(const float* x, const float* hypers,
                                          const float* noise, float* out,
                                          int S, int n, int d, int kernel,
                                          void* stream) {
  if (S == 0 || n == 0) return (int)cudaSuccess;
  const int nt = (n + COV_TILE - 1) / COV_TILE;
  const dim3 grid(nt * (nt + 1) / 2, S);
  cmoe_covariance_with_noise_kernel<<<grid, COV_THREADS, 0,
                                      (cudaStream_t)stream>>>(
      x, hypers, noise, out, n, d, nt, kernel);
  return (int)cudaGetLastError();
}
