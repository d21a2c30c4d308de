// K1: the arrowhead Jacobi-PCG solve, one thread block per window.
//
// Replaces the TPU kernel smpltpu/ops/cg.py::arrow_pcg_pallas (_cg_kernel),
// which held one window's whole system in VMEM and ran every CG step in one
// program. For each window w it runs `iters` steps of Jacobi-preconditioned
// CG from 0 on the SPD arrowhead system
//
//     [ T  B ] [dp]   [-g_p]     T = block-tridiag(D_f, E_f),
//     [ Bt C ] [dw] = [-g_w]     E_f = off[f] * diag(tm)
//
// with D (F, P, P), B (F, P, nS), C (nS, nS), and the optional tolerance
// exit ||r||^2 <= rtol^2 ||r0||^2 on the unpreconditioned residual. Same
// recursion as the plain version in ops/cg.py (arrow_pcg_torch): the
// max(diag, 1e-20) preconditioner and the 1e-30 guards on alpha and beta.
//
// What bounds it on an H100: D is 20*76*76*4 B = 462 KB per stage-2 window
// and 2.3 MB for the stage-1 window, above the 227 KB of shared memory a
// block can hold, so every matvec re-reads D. The 67 stage-2 windows' D
// (31 MB) stay resident in the 50 MB L2 after the first step, so the
// matvec streams D from L2 at one SM's share of its bandwidth; the other
// cost is the latency of the block-wide reductions (two per step, plus a
// serial nS x nS product), which the design keeps to two barrier pairs.
//
// Design: every CG step runs inside the kernel (no per-step launch). The
// matvec is the column form u[f,a] = sum_b D[f,b,a] v[f,b] (D symmetric, as
// the TPU kernel also assumed), one thread per output element, so the
// threads of a warp read consecutive addresses of one row of D. The
// vectors x, r, d, q and the preconditioner stay in shared memory when
// 5*F*P floats fit there (F <= 151 at P = 76, so both stages), otherwise in
// global scratch the wrapper allocates. Each thread owns the same elements
// in every phase, so only the search direction d is read across threads.
// Later work: a thread-block cluster with distributed shared memory, or
// several blocks per stage-1 window, would keep D on chip and put more
// than one SM on the single stage-1 window.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxShapes = 16;
constexpr int kRed = kMaxShapes + 1;     // values per block reduction
// shared header: reduction slots, totals, scalars, shape-block vectors
constexpr int kHeader = 384;
static_assert(kWarps * kRed + kRed + 8 + 5 * kMaxShapes <= kHeader,
              "shared header too small");

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sum N per-thread values over the block into tot[0..N). Ends on a barrier,
// so every thread may read tot afterwards.
template <int N>
__device__ __forceinline__ void block_sum(float (&v)[N], float* red,
                                          float* tot) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < N; ++k) v[k] = warp_sum(v[k]);
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < N; ++k) red[warp * N + k] = v[k];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      float t = lane < kWarps ? red[lane * N + k] : 0.f;
      t = warp_sum(t);
      if (lane == 0) tot[k] = t;
    }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
arrow_pcg_kernel(const float* __restrict__ d_all,    // (W, F, P, P)
                 const float* __restrict__ off_all,  // (W, F-1)
                 const float* __restrict__ tm,       // (P,)
                 const float* __restrict__ b_all,    // (W, F, P, nS)
                 const float* __restrict__ c_all,    // (W, nS, nS)
                 const float* __restrict__ gp_all,   // (W, F, P)
                 const float* __restrict__ gw_all,   // (W, nS)
                 float* __restrict__ dp_all,         // (W, F, P)
                 float* __restrict__ dw_all,         // (W, nS)
                 float* scratch,                     // (W, 5, F*P) or unused
                 int F, int P, int nS, int iters, float rtol2,
                 int vec_in_smem) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const int w = blockIdx.x;
  const int n = F * P;
  const float* D = d_all + (size_t)w * n * P;
  const float* off = off_all + (size_t)w * (F - 1);
  const float* B = b_all + (size_t)w * n * nS;
  const float* C = c_all + (size_t)w * nS * nS;
  const float* gp = gp_all + (size_t)w * n;
  const float* gw = gw_all + (size_t)w * nS;

  float* red = smem;                        // kWarps * kRed
  float* tot = red + kWarps * kRed;         // kRed
  float* sc = tot + kRed;                   // [0] rho [1] alpha|beta [2] rr [3] tol2
  float* xw = sc + 8;                       // shape-block vectors, kMaxShapes each
  float* rw = xw + kMaxShapes;
  float* dw = rw + kMaxShapes;
  float* qw = dw + kMaxShapes;
  float* cinv = qw + kMaxShapes;
  float* vec = vec_in_smem ? smem + kHeader : scratch + (size_t)w * 5 * n;
  float* x = vec;
  float* r = vec + n;
  float* dd = vec + 2 * n;
  float* q = vec + 3 * n;
  float* dinv = vec + 4 * n;

  // x = 0, r = -g, z = M^-1 r, d = z; rho = r.z, rr = r.r
  float part[2] = {0.f, 0.f};
  for (int i = tid; i < n; i += kThreads) {
    const int f = i / P;
    const int a = i - f * P;
    const float di = 1.f / fmaxf(D[(size_t)f * P * P + (size_t)a * P + a], 1e-20f);
    const float ri = -gp[i];
    const float zi = di * ri;
    dinv[i] = di;
    x[i] = 0.f;
    r[i] = ri;
    dd[i] = zi;
    part[0] += ri * zi;
    part[1] += ri * ri;
  }
  if (tid < nS) {
    const float ci = 1.f / fmaxf(C[tid * nS + tid], 1e-20f);
    const float ri = -gw[tid];
    cinv[tid] = ci;
    xw[tid] = 0.f;
    rw[tid] = ri;
    dw[tid] = ci * ri;
  }
  block_sum<2>(part, red, tot);
  if (tid == 0) {
    float rho_w = 0.f, rr_w = 0.f;
    for (int s = 0; s < nS; ++s) {
      rho_w += rw[s] * (cinv[s] * rw[s]);
      rr_w += rw[s] * rw[s];
    }
    sc[0] = tot[0] + rho_w;
    sc[2] = tot[1] + rr_w;
    sc[3] = rtol2 * sc[2];
  }
  __syncthreads();

  for (int it = 0; it < iters; ++it) {
    if (rtol2 > 0.f && !(sc[2] > sc[3])) break;   // uniform over the block

    // q = A d, with the partial sums of B^T d_p and d_p . q_p
    float pw[kRed];
#pragma unroll
    for (int k = 0; k < kRed; ++k) pw[k] = 0.f;
    for (int i = tid; i < n; i += kThreads) {
      const int f = i / P;
      const int a = i - f * P;
      const float* dcol = D + (size_t)f * P * P + a;
      const float* v = dd + f * P;
      float u = 0.f;
#pragma unroll 4
      for (int b = 0; b < P; ++b) u = fmaf(dcol[(size_t)b * P], v[b], u);
      const float tma = tm[a];
      if (f + 1 < F) u += off[f] * (tma * dd[i + P]);
      if (f > 0) u += off[f - 1] * (tma * dd[i - P]);
      const float* bi = B + (size_t)i * nS;
      const float di = dd[i];
      float ub = 0.f;
#pragma unroll
      for (int s = 0; s < kMaxShapes; ++s) {
        if (s < nS) {
          const float bs = bi[s];
          ub = fmaf(bs, dw[s], ub);
          pw[s] = fmaf(bs, di, pw[s]);
        }
      }
      u += ub;
      q[i] = u;
      pw[kMaxShapes] = fmaf(di, u, pw[kMaxShapes]);
    }
    block_sum<kRed>(pw, red, tot);
    if (tid < 32) {
      float contrib = 0.f;
      if (tid < nS) {
        float cv = 0.f;
        for (int t = 0; t < nS; ++t) cv = fmaf(C[tid * nS + t], dw[t], cv);
        const float qs = tot[tid] + cv;
        qw[tid] = qs;
        contrib = dw[tid] * qs;
      }
      contrib = warp_sum(contrib);
      if (tid == 0) sc[1] = sc[0] / fmaxf(tot[kMaxShapes] + contrib, 1e-30f);
    }
    __syncthreads();

    // x += alpha d, r -= alpha q; rho_n = r.z, rr = r.r
    const float alpha = sc[1];
    part[0] = 0.f;
    part[1] = 0.f;
    for (int i = tid; i < n; i += kThreads) {
      x[i] = fmaf(alpha, dd[i], x[i]);
      const float ri = r[i] - alpha * q[i];
      r[i] = ri;
      part[0] += ri * (dinv[i] * ri);
      part[1] += ri * ri;
    }
    if (tid < nS) {
      xw[tid] = fmaf(alpha, dw[tid], xw[tid]);
      rw[tid] = rw[tid] - alpha * qw[tid];
    }
    block_sum<2>(part, red, tot);
    if (tid == 0) {
      float rho_w = 0.f, rr_w = 0.f;
      for (int s = 0; s < nS; ++s) {
        rho_w += rw[s] * (cinv[s] * rw[s]);
        rr_w += rw[s] * rw[s];
      }
      const float rho_n = tot[0] + rho_w;
      sc[1] = rho_n / fmaxf(sc[0], 1e-30f);
      sc[0] = rho_n;
      sc[2] = tot[1] + rr_w;
    }
    __syncthreads();

    // d = z + beta d
    const float beta = sc[1];
    for (int i = tid; i < n; i += kThreads) dd[i] = fmaf(beta, dd[i], dinv[i] * r[i]);
    if (tid < nS) dw[tid] = fmaf(beta, dw[tid], cinv[tid] * rw[tid]);
    __syncthreads();
  }

  float* dp = dp_all + (size_t)w * n;
  for (int i = tid; i < n; i += kThreads) dp[i] = x[i];
  if (tid < nS) dw_all[(size_t)w * nS + tid] = xw[tid];
}

size_t full_smem_bytes(int F, int P) {
  return (kHeader + 5 * (size_t)F * P) * sizeof(float);
}

int smem_optin() {
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return optin;
}

}  // namespace

// Floats of global scratch the launch needs: 0 when the vectors fit in
// shared memory.
extern "C" long long smpltpu_arrow_pcg_scratch_floats(int W, int F, int P) {
  if (full_smem_bytes(F, P) <= (size_t)smem_optin()) return 0;
  return 5LL * W * F * P;
}

// Launches K1 on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int smpltpu_arrow_pcg_f32(const float* d, const float* off,
                                     const float* tm, const float* b,
                                     const float* c, const float* gp,
                                     const float* gw, float* dp, float* dw,
                                     float* scratch, int W, int F, int P,
                                     int nS, int iters, float rtol2,
                                     void* stream) {
  if (W < 1 || F < 1 || P < 1 || nS < 1 || nS > kMaxShapes || iters < 0)
    return (int)cudaErrorInvalidValue;
  const size_t full = full_smem_bytes(F, P);
  const int in_smem = full <= (size_t)smem_optin();
  if (!in_smem && scratch == nullptr) return (int)cudaErrorInvalidValue;
  const size_t bytes = in_smem ? full : kHeader * sizeof(float);
  cudaFuncSetAttribute(arrow_pcg_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  arrow_pcg_kernel<<<W, kThreads, bytes, (cudaStream_t)stream>>>(
      d, off, tm, b, c, gp, gw, dp, dw, scratch, F, P, nS, iters, rtol2,
      in_smem);
  return (int)cudaGetLastError();
}
