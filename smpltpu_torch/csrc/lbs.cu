// K2: fused shape blendshapes + linear blend skinning, register-tiled: a
// thread owns two vertices and walks a tile of frames.
//
// Replaces the TPU kernel smpltpu/ops/lbs.py::lbs_pallas (_lbs_kernel),
// which takes its products at Precision.HIGHEST: so this one stays in FP32
// on the CUDA cores (no TF32, no tensor cores). For each frame b and
// vertex v:
//
//     v_sh      = v_template[v] + shapedirs[v] . beta_b
//     A_bv      = sum_j W[v, j] G_bj                  (3 x 4)
//     out[b,:,v] = A_bv [v_sh; 1]
//
// so the blended per-vertex transforms never reach device memory (the
// einsum form writes a (B, 3, 4, nV) intermediate, 12x the output).
//
// What bounds it on an H100: its FP32 operations. The bytes (12 per (b, v)
// out, 1.6 MB of model operands, the frames' transforms) are 9.9 MB per
// 100 frames, 3 us; the 12 nJ + 3 nS + 12 FMAs per (b, v) are 6.8 us at
// the FP32 rate. What holds a kernel above that bound is the road from
// shared memory to the registers, 128 bytes a clock on each SM: every
// FMA's transform entry comes down it. A thread per (b, v) that reads the
// 12 nJ entries one by one asks for one entry per FMA, four times what the
// road carries at the FMA rate, whether it asks in 4-byte or 16-byte
// loads (such a kernel takes 38 us per 100 frames, and re-reads the model
// operands from L2 for every frame).
//
// Design: a thread owns kVertsPerThread vertices and keeps their nJ
// weights, templates and 3 nS shape directions in registers (the <24, 10>
// instantiation unrolls every loop over them: 168 registers, no spill),
// so each transform row read from shared memory (16 bytes, broadcast)
// serves 4 FMAs for each of its vertices, twice the work per byte of the
// road; more vertices a thread would halve it again but do not fit the
// register file. The thread loops over the frames of its block's tile, so
// the model operands are read once per frame tile, not once per frame;
// the tile's transforms and shape coefficients are staged into shared
// memory once, before the loop. The launch picks the largest frame tile
// (at most kMaxFrameTile) that still gives the card two blocks per SM.
// SMPL-X's widths (nJ 55, nS 20: 10 shape and 10 expression directions)
// have an instantiation of their own, <55, 20> with one vertex a thread
// (118 operands in registers; two vertices would not fit). Other widths
// (nJ <= 64, nS <= 32) run the <0, 0> instantiation: one vertex a
// thread, operands from L1/L2, loops at run time. Every sum runs
// in joint order and shape order whatever the tiling, so a vertex's result
// does not depend on the frame tile or the instantiation's vertices a
// thread. It runs at 20 us per 100 frames, a third of the bound, still on
// the shared-memory road.
//
// Outputs stay coordinate-major (B, 3, nV), consecutive threads on
// consecutive vertices; the operands come coordinate-major too ((3, nV),
// (nS, 3, nV), (nJ, nV), from ops/lbs.py::prepare_lbs_operands). No lane
// padding: the TPU kernel's 128-lane vertex tiles and 32-joint padding
// have no counterpart here.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxJoints = 64;
constexpr int kMaxShapes = 32;
constexpr int kMaxFrameTile = 8;
constexpr int kVertsPerThread = 2;   // of the <24, 10> instantiation

// float4 slots of a frame's shape coefficients in shared memory: 4 (16
// floats) up to nS = 16, else enough for nS
__host__ __device__ constexpr int beta_slots4(int nS) {
  return nS <= 16 ? 4 : (nS + 3) / 4;
}

// a += wj * G_j, the joint's 3 x 4 transform as its three rows
__device__ __forceinline__ void blend(float (&a)[12], float wj, float4 r0,
                                      float4 r1, float4 r2) {
  const float4 r[3] = {r0, r1, r2};
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    a[4 * k] = fmaf(wj, r[k].x, a[4 * k]);
    a[4 * k + 1] = fmaf(wj, r[k].y, a[4 * k + 1]);
    a[4 * k + 2] = fmaf(wj, r[k].z, a[4 * k + 2]);
    a[4 * k + 3] = fmaf(wj, r[k].w, a[4 * k + 3]);
  }
}

// NJ, NS > 0: compile-time widths, operands in registers, VPT vertices a
// thread. NJ = NS = 0: the widths are nJ, nS at run time, one vertex.
template <int NJ, int NS, int VPT>
__global__ void __launch_bounds__(kThreads)
lbs_kernel(const float* __restrict__ shapes,  // (B, nS)
           const float* __restrict__ g,       // (B, nJ, 3, 4)
           const float* __restrict__ vt,      // (3, nV)
           const float* __restrict__ sd,      // (nS, 3, nV)
           const float* __restrict__ wt,      // (nJ, nV)
           float* __restrict__ out,           // (B, 3, nV)
           int B, int nV, int nJ_rt, int nS_rt, int frame_tile) {
  constexpr bool kFixed = NJ > 0;
  constexpr int kJ = kFixed ? NJ : 1;
  constexpr int kS = kFixed ? NS : 1;
  const int nJ = kFixed ? NJ : nJ_rt;
  const int nS = kFixed ? NS : nS_rt;
  extern __shared__ float4 smem[];
  // per frame of the tile: nJ x 3 float4 rows of G, then the betas
  const int g4 = nJ * 3;
  const int per_frame4 = g4 + beta_slots4(nS);

  const int b0 = blockIdx.y * frame_tile;
  const int nb = min(frame_tile, B - b0);
  {
    float* s = reinterpret_cast<float*>(smem);
    const int per_frame = per_frame4 * 4;
    for (int i = threadIdx.x; i < nb * per_frame; i += kThreads) {
      const int f = i / per_frame, k = i - f * per_frame;
      float val = 0.f;
      if (k < nJ * 12) val = g[((size_t)(b0 + f) * nJ) * 12 + k];
      else if (k - nJ * 12 < nS) val = shapes[(size_t)(b0 + f) * nS + k - nJ * 12];
      s[i] = val;
    }
  }
  __syncthreads();

  // this thread's vertices: a block's threads on consecutive ones; a vertex
  // past the end repeats the last, and is not stored
  int v[VPT];
  bool live[VPT];
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int vi = (blockIdx.x * VPT + i) * kThreads + threadIdx.x;
    live[i] = vi < nV;
    v[i] = live[i] ? vi : nV - 1;
  }
  if (!live[0]) return;

  float w[VPT][kJ], d[VPT][3 * kS], t[VPT][3];
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
#pragma unroll
    for (int c = 0; c < 3; ++c) t[i][c] = vt[(size_t)c * nV + v[i]];
    if constexpr (kFixed) {
#pragma unroll
      for (int j = 0; j < kJ; ++j) w[i][j] = wt[(size_t)j * nV + v[i]];
#pragma unroll
      for (int k = 0; k < 3 * kS; ++k) d[i][k] = sd[(size_t)k * nV + v[i]];
    }
  }

  for (int f = 0; f < nb; ++f) {
    const float4* gs = smem + (size_t)f * per_frame4;
    const float* beta = reinterpret_cast<const float*>(gs + g4);

    float p[VPT][3];
    if constexpr (kFixed) {
      float bt[(kS + 3) / 4 * 4];
#pragma unroll
      for (int q = 0; q < (kS + 3) / 4; ++q) {
        const float4 x = reinterpret_cast<const float4*>(beta)[q];
        bt[4 * q] = x.x; bt[4 * q + 1] = x.y; bt[4 * q + 2] = x.z; bt[4 * q + 3] = x.w;
      }
#pragma unroll
      for (int i = 0; i < VPT; ++i) {
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          float acc = 0.f;
#pragma unroll
          for (int s = 0; s < kS; ++s) acc = fmaf(d[i][s * 3 + c], bt[s], acc);
          p[i][c] = t[i][c] + acc;
        }
      }
    } else {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        float acc = 0.f;
        for (int s = 0; s < nS; ++s)
          acc = fmaf(sd[((size_t)s * 3 + c) * nV + v[0]], beta[s], acc);
        p[0][c] = t[0][c] + acc;
      }
    }

    float a[VPT][12];
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
#pragma unroll
      for (int k = 0; k < 12; ++k) a[i][k] = 0.f;
    }
    if constexpr (kFixed) {
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        // one read of the joint's transform serves all the thread's vertices
        const float4 r0 = gs[j * 3], r1 = gs[j * 3 + 1], r2 = gs[j * 3 + 2];
#pragma unroll
        for (int i = 0; i < VPT; ++i) blend(a[i], w[i][j], r0, r1, r2);
      }
    } else {
      for (int j = 0; j < nJ; ++j)
        blend(a[0], wt[(size_t)j * nV + v[0]], gs[j * 3], gs[j * 3 + 1],
              gs[j * 3 + 2]);
    }

#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      if (!live[i]) continue;
      float* o = out + (size_t)(b0 + f) * 3 * nV + v[i];
#pragma unroll
      for (int c = 0; c < 3; ++c)
        o[(size_t)c * nV] = a[i][4 * c] * p[i][0] + a[i][4 * c + 1] * p[i][1]
                            + a[i][4 * c + 2] * p[i][2] + a[i][4 * c + 3];
    }
  }
}

}  // namespace

// The card's SM count, asked of the runtime once for each device.
static int sm_count(int* sms) {
  constexpr int kDevices = 64;
  static int known[kDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < kDevices && known[dev] > 0) {
    *sms = known[dev];
    return 0;
  }
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && dev < kDevices) known[dev] = *sms;
  return (int)err;
}

// Launches K2 on `stream`; returns cudaGetLastError() (0 on success). A
// block walks the largest frame tile (at most kMaxFrameTile) that still
// gives the card two blocks per SM. `fixed_ok` 0 takes the run-time
// widths' instantiation whatever the widths (to measure it).
static int launch_lbs(const float* shapes, const float* g, const float* vt,
                      const float* sd, const float* wt, float* out, int B,
                      int nV, int nJ, int nS, void* stream, bool fixed_ok) {
  if (B < 1 || nV < 1 || nJ < 1 || nJ > kMaxJoints || nS < 0
      || nS > kMaxShapes)
    return (int)cudaErrorInvalidValue;
  const bool smpl = fixed_ok && nJ == 24 && nS == 10;
  const bool smplx = fixed_ok && nJ == 55 && nS == 20;
  const int vpt = smpl ? kVertsPerThread : 1;
  const int vblocks = (nV + kThreads * vpt - 1) / (kThreads * vpt);
  int sms = 0;
  const int err = sm_count(&sms);
  if (err != 0) return err;
  int frame_tile = kMaxFrameTile;
  while (frame_tile > 1
         && (long long)vblocks * ((B + frame_tile - 1) / frame_tile) < 2LL * sms)
    --frame_tile;
  const int tiles = (B + frame_tile - 1) / frame_tile;
  if (tiles > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid(vblocks, tiles);
  const size_t smem =
      (size_t)frame_tile * (nJ * 3 + beta_slots4(nS)) * sizeof(float4);
  cudaStream_t s = (cudaStream_t)stream;
  if (smpl)
    lbs_kernel<24, 10, kVertsPerThread><<<grid, kThreads, smem, s>>>(
        shapes, g, vt, sd, wt, out, B, nV, nJ, nS, frame_tile);
  else if (smplx)
    lbs_kernel<55, 20, 1><<<grid, kThreads, smem, s>>>(
        shapes, g, vt, sd, wt, out, B, nV, nJ, nS, frame_tile);
  else
    lbs_kernel<0, 0, 1><<<grid, kThreads, smem, s>>>(
        shapes, g, vt, sd, wt, out, B, nV, nJ, nS, frame_tile);
  return (int)cudaGetLastError();
}

extern "C" int smpltpu_lbs_f32(const float* shapes, const float* g,
                               const float* vt, const float* sd,
                               const float* wt, float* out, int B, int nV,
                               int nJ, int nS, void* stream) {
  return launch_lbs(shapes, g, vt, sd, wt, out, B, nV, nJ, nS, stream, true);
}

// The same launch on the run-time widths' instantiation, whatever the
// widths: the measurement of a compiled instantiation against it.
extern "C" int smpltpu_lbs_generic_f32(const float* shapes, const float* g,
                                       const float* vt, const float* sd,
                                       const float* wt, float* out, int B,
                                       int nV, int nJ, int nS, void* stream) {
  return launch_lbs(shapes, g, vt, sd, wt, out, B, nV, nJ, nS, stream, false);
}
