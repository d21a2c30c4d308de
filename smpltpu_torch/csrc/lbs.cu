// K2: fused shape blendshapes + linear blend skinning, one thread per
// (frame b, vertex v).
//
// Replaces the TPU kernel smpltpu/ops/lbs.py::lbs_pallas (_lbs_kernel).
// For each frame b and vertex v:
//
//     v_sh      = v_template[v] + shapedirs[v] . beta_b
//     A_bv      = sum_j W[v, j] G_bj                  (3 x 4)
//     out[b,:,v] = A_bv [v_sh; 1]
//
// so the blended per-vertex transforms never reach device memory (the
// einsum form writes a (B, 3, 4, nV) intermediate, 12x the output).
//
// What bounds it on an H100: the output, 12 bytes per (b, v) written once,
// and the per-vertex model operands (3 + 3 nS + nJ floats, 228 B at SMPL
// width), read once per frame but only 1.6 MB in all, so they stay in L2
// across frames. Arithmetic is 12 nJ + 3 nS + 12 FMAs per (b, v), far below
// the FP32 rate at these bytes, so the kernel should run near the rate at
// which it can write its output and read the operands from L2.
//
// Design: the operands come coordinate-major ((3, nV), (nS, 3, nV),
// (nJ, nV), from ops/lbs.py::prepare_lbs_operands), so the threads of a
// warp read consecutive addresses; a block's frame transforms (nJ x 12
// floats) and shape coefficients sit in shared memory and are read as
// broadcasts. No lane padding: the TPU kernel's 128-lane vertex tiles and
// 32-joint padding have no counterpart here.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxJoints = 64;
constexpr int kMaxShapes = 16;

__global__ void __launch_bounds__(kThreads)
lbs_kernel(const float* __restrict__ shapes,  // (B, nS)
           const float* __restrict__ g,       // (B, nJ, 3, 4)
           const float* __restrict__ vt,      // (3, nV)
           const float* __restrict__ sd,      // (nS, 3, nV)
           const float* __restrict__ wt,      // (nJ, nV)
           float* __restrict__ out,           // (B, 3, nV)
           int nV, int nJ, int nS) {
  __shared__ float gs[kMaxJoints * 12];
  __shared__ float beta[kMaxShapes];
  const int b = blockIdx.y;
  for (int k = threadIdx.x; k < nJ * 12; k += kThreads)
    gs[k] = g[(size_t)b * nJ * 12 + k];
  if (threadIdx.x < nS) beta[threadIdx.x] = shapes[(size_t)b * nS + threadIdx.x];
  __syncthreads();

  const int v = blockIdx.x * kThreads + threadIdx.x;
  if (v >= nV) return;

  float p[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float acc = 0.f;
    for (int s = 0; s < nS; ++s)
      acc = fmaf(sd[((size_t)s * 3 + c) * nV + v], beta[s], acc);
    p[c] = vt[(size_t)c * nV + v] + acc;
  }

  float a[12];
#pragma unroll
  for (int k = 0; k < 12; ++k) a[k] = 0.f;
  for (int j = 0; j < nJ; ++j) {
    const float wj = wt[(size_t)j * nV + v];
#pragma unroll
    for (int k = 0; k < 12; ++k) a[k] = fmaf(wj, gs[j * 12 + k], a[k]);
  }

  float* o = out + (size_t)b * 3 * nV + v;
#pragma unroll
  for (int c = 0; c < 3; ++c)
    o[(size_t)c * nV] = a[4 * c] * p[0] + a[4 * c + 1] * p[1]
                        + a[4 * c + 2] * p[2] + a[4 * c + 3];
}

}  // namespace

// Launches K2 on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int smpltpu_lbs_f32(const float* shapes, const float* g,
                               const float* vt, const float* sd,
                               const float* wt, float* out, int B, int nV,
                               int nJ, int nS, void* stream) {
  if (B < 1 || B > 65535 || nV < 1 || nJ < 1 || nJ > kMaxJoints || nS < 0
      || nS > kMaxShapes)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((nV + kThreads - 1) / kThreads, B);
  lbs_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      shapes, g, vt, sd, wt, out, nV, nJ, nS);
  return (int)cudaGetLastError();
}
