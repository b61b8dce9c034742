// Fused GP log-marginal-likelihood pieces for a batch of MCMC walkers:
// K = alpha k(us) + diag(noise), its Cholesky factor, the forward
// substitution of y, and (quad = y^T K^-1 y, logdet = sum log diag L),
// both summed over the first n_real rows only.
//
// Replaces: cornell_moe_tpu/ops/pallas_kernels.py, pallas_lml_fused
//   (_lml_fused_kernel), which kept (wb, Np, Np) in VMEM (up to 8 MB) and
//   ran a 32-column blocked right-looking Cholesky per walker batch.
// Bound on the H100: latency of the dependent panel chain.  The work is
//   Np^3 / 6 FMAs per walker (22 M at Np = 512) but every panel waits for
//   the previous one, and the main path has only 8 walkers per call.  The
//   VMEM layout cannot carry over: a block has at most 227 KB of shared
//   memory and K is 1 MB per walker.
// Design: one block per walker, all walkers in one launch.  K lives in a
//   global scratch (W, Np, Np) the wrapper allocates, which stays resident
//   in the 50 MB L2.  K is built in place (lower triangle only), then
//   factored in 32-column panels: warp 0 factors the diagonal block in
//   registers with warp shuffles; thread 0 forward-substitutes that block
//   of y and accumulates the masked quad/logdet; every thread solves rows
//   of the panel below (L21 = A21 L11^-T) and folds the y update into the
//   same pass; the trailing update A22 -= L21 L21^T runs in 32 x 32 tiles
//   staged in shared memory.  Any Np (the last panel may be narrower than
//   32).  A non-positive pivot anywhere gives NaN outputs, as the plain
//   version's cholesky_ex failure does.
// Precision: float32 throughout, as the Pallas kernel.  A float64 inside
//   was tried: the chain then settled on near-noiseless walkers at which
//   the float32 ensemble fit failed for every member.  With a float32
//   factorization, a walker it cannot factor gets a -inf log-posterior, so
//   the chain stays where the float32 GP can be fitted.

#include "common.cuh"

#define LML_PANEL 32
#define LML_THREADS 256

__global__ void __launch_bounds__(LML_THREADS) cmoe_lml_fused_kernel(
    const float* __restrict__ us, const float* __restrict__ alpha,
    const float* __restrict__ noise, const float* __restrict__ y,
    float* kscr, float* yscr, float* __restrict__ quad_out,
    float* __restrict__ logdet_out, int d, int np_, int n_real, int kernel) {
  __shared__ float D[LML_PANEL][LML_PANEL + 1];
  __shared__ float zb[LML_PANEL];
  __shared__ float Li[LML_PANEL][LML_PANEL + 1];
  __shared__ float Lj[LML_PANEL][LML_PANEL + 1];

  const int w = blockIdx.x;
  const int tid = threadIdx.x;
  const float* u = us + (size_t)w * d * np_;
  const float* nz = noise + (size_t)w * np_;
  float* A = kscr + (size_t)w * np_ * np_;
  float* yv = yscr + (size_t)w * np_;
  const float a = alpha[w];

  // --- build the lower triangle of K ---------------------------------------
  const size_t nn = (size_t)np_ * np_;
  for (size_t idx = tid; idx < nn; idx += blockDim.x) {
    const int i = (int)(idx / np_);
    const int j = (int)(idx % np_);
    if (j > i) continue;
    float s = 0.0f;
    for (int dd = 0; dd < d; ++dd) {
      const float diff = u[(size_t)dd * np_ + i] - u[(size_t)dd * np_ + j];
      s += diff * diff;
    }
    float v = a * cmoe_unit_f0(s, kernel);
    if (i == j) v += nz[i];
    A[idx] = v;
  }
  for (int i = tid; i < np_; i += blockDim.x) yv[i] = y[(size_t)w * np_ + i];
  __syncthreads();

  float quad = 0.0f, logdet = 0.0f;   // carried by thread 0
  bool failed = false;

  for (int c0 = 0; c0 < np_; c0 += LML_PANEL) {
    const int pw = min(LML_PANEL, np_ - c0);

    // --- factor the diagonal block (warp 0, rows in registers) -------------
    if (tid < 32) {
      const int r = tid;
      float row[LML_PANEL];
#pragma unroll
      for (int c = 0; c < LML_PANEL; ++c) {
        float v = 0.0f;
        if (r < pw && c <= r) v = A[(size_t)(c0 + r) * np_ + c0 + c];
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
#pragma unroll
      for (int c = 0; c < LML_PANEL; ++c) D[r][c] = (c <= r) ? row[c] : 0.0f;
    }
    __syncthreads();

    // --- forward-substitute this block of y, masked quad/logdet ------------
    if (tid == 0) {
      for (int j = 0; j < pw; ++j) {
        float acc = yv[c0 + j];
        for (int k = 0; k < j; ++k) acc -= D[j][k] * zb[k];
        const float ljj = D[j][j];
        if (!(ljj > 0.0f)) failed = true;
        const float zj = acc / ljj;
        zb[j] = zj;
        if (c0 + j < n_real) {
          quad += zj * zj;
          logdet += logf(ljj);
        }
      }
    }
    __syncthreads();

    // --- panel below: L21 = A21 L11^-T, and y -= L21 z ----------------------
    const int r0 = c0 + pw;
    for (int i = r0 + tid; i < np_; i += blockDim.x) {
      float* ai = A + (size_t)i * np_ + c0;
      float x[LML_PANEL];
      float ydot = 0.0f;
#pragma unroll
      for (int j = 0; j < LML_PANEL; ++j) {
        x[j] = 0.0f;
        if (j < pw) {
          float acc = ai[j];
#pragma unroll
          for (int k = 0; k < j; ++k) acc -= D[j][k] * x[k];
          x[j] = acc / D[j][j];
          ai[j] = x[j];
          ydot += x[j] * zb[j];
        }
      }
      yv[i] -= ydot;
    }
    __syncthreads();

    // --- trailing update A22 -= L21 L21^T (lower tiles only) ----------------
    const int nt = (np_ - r0 + LML_PANEL - 1) / LML_PANEL;
    const int cc = tid & 31;
    for (int ti = 0; ti < nt; ++ti) {
      for (int tj = 0; tj <= ti; ++tj) {
        const int bi = r0 + ti * LML_PANEL;
        const int bj = r0 + tj * LML_PANEL;
        for (int e = tid; e < LML_PANEL * LML_PANEL; e += blockDim.x) {
          const int r = e / LML_PANEL, k = e % LML_PANEL;
          Li[r][k] = (bi + r < np_ && k < pw) ? A[(size_t)(bi + r) * np_ + c0 + k] : 0.0f;
          Lj[r][k] = (bj + r < np_ && k < pw) ? A[(size_t)(bj + r) * np_ + c0 + k] : 0.0f;
        }
        __syncthreads();
        for (int rr = tid >> 5; rr < LML_PANEL; rr += blockDim.x >> 5) {
          const int gi = bi + rr, gj = bj + cc;
          if (gi < np_ && gj < np_ && gj <= gi) {
            float acc = 0.0f;
#pragma unroll
            for (int k = 0; k < LML_PANEL; ++k) acc += Li[rr][k] * Lj[cc][k];
            A[(size_t)gi * np_ + gj] -= acc;
          }
        }
        __syncthreads();
      }
    }
  }

  if (tid == 0) {
    const float nan = __int_as_float(0x7fc00000);
    quad_out[w] = failed ? nan : quad;
    logdet_out[w] = failed ? nan : logdet;
  }
}

extern "C" int cmoe_lml_fused(const float* us, const float* alpha,
                              const float* noise, const float* y,
                              float* kscr, float* yscr, float* quad,
                              float* logdet, int W, int d, int np_,
                              int n_real, int kernel, void* stream) {
  cmoe_lml_fused_kernel<<<W, LML_THREADS, 0, (cudaStream_t)stream>>>(
      us, alpha, noise, y, kscr, yscr, quad, logdet, d, np_, n_real, kernel);
  return (int)cudaGetLastError();
}
