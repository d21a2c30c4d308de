// K3: the z-buffer mesh rasterizer, one warp per work item of at most
// `piece` pixels of one face's bounding box, atomicMin into an int32
// z-buffer; then a pass that turns the z-buffer into (gray, covered).
//
// Replaces the TPU kernel smpltpu/render/pallas_raster.py::rasterize_tiled
// (_raster_kernel). For each frame b and pixel (x, y), the z-buffer ends
// as the minimum int32 key (depth_q << 8 | gray) over the kept faces whose
// three edge functions at the pixel center (x + 0.5, y + 0.5) are all
// > -1e-12:
//
//     e_k = (px * A_k) + ((py * B_k) + C_k)
//
// each product and sum rounded on its own (__fmul_rn / __fadd_rn, which
// nvcc never contracts into an FMA), in the association of the TPU
// kernel's default edge_mode="rows" and of the plain version
// render/zbuffer.py::rasterize_torch, so the kernel is pixel-exact against
// it. The per-face data (coefficients in canonical winding, key, clipped
// bounding box) and the work split come from render/zbuffer.py. An int32
// atomic min is order-independent, so the result is deterministic.
//
// What bounds it on an H100: the bytes. Per 100-frame launch at 720x1280
// the outputs, gray and covered (1 byte each per pixel), are 184 MB; the
// per-face inputs are ~90 MB. The edge tests are 12 flops per bounding-box
// pixel (~0.7 M pixels per frame on the fitted bench video), ~0.85 GFLOP,
// 13 us at the FP32 rate, against ~82 us for the bytes. This simple design
// also writes the int32 z-buffer once (the fill, 369 MB) and reads it once
// in the resolve, so it moves about 3.7x the bytes of the bound; a
// tile-binned kernel that keeps the z-buffer in shared memory would not.
//
// Design: the TPU kernel's sort-binning, compacted worklist and static
// caps exist for the TPU's scatter cost and static shapes; here a face's
// pixels go straight to device memory with a fire-and-forget atomic min
// (red.global.min). Load balance: faces range from a few pixels to most of
// the frame, so the wrapper cuts every face's clipped bounding box into
// pieces of at most `piece` pixels and hands the inclusive prefix sum of
// the piece counts over all (frame, face) pairs; each warp takes an equal
// contiguous range of pieces, finds its first face by binary search and
// walks forward, its 32 lanes striding over the piece's pixels (adjacent
// lanes on adjacent pixels of a row, so the atomics coalesce). No face is
// truncated.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSentinel = 0x7FFFFFFF;
constexpr float kSlack = -1e-12f;

__device__ __forceinline__ float edge(float px, float py, float a, float b,
                                      float c) {
  return __fadd_rn(__fmul_rn(px, a), __fadd_rn(__fmul_rn(py, b), c));
}

__global__ void __launch_bounds__(kThreads)
raster_kernel(const int4* __restrict__ bbox,          // (B*F) x0, y0, bw, bh
              const float* __restrict__ coef,         // (B*F, 9)
              const int* __restrict__ key,            // (B*F)
              const long long* __restrict__ item_end, // (B*F) inclusive
              int n_items_faces, int F, int H, int W, int piece,
              int* __restrict__ zbuf) {               // (B, H, W)
  const int lane = threadIdx.x & 31;
  const long long warp = ((long long)blockIdx.x * kThreads + threadIdx.x) >> 5;
  const long long n_warps = ((long long)gridDim.x * kThreads) >> 5;
  const long long total = item_end[n_items_faces - 1];
  const long long per = (total + n_warps - 1) / n_warps;
  long long it = warp * per;
  const long long it_stop = it + per < total ? it + per : total;
  if (it >= it_stop) return;

  // the first face i with item_end[i] > it
  int lo = 0, hi = n_items_faces - 1;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (item_end[mid] > it) hi = mid; else lo = mid + 1;
  }
  int i = lo;
  long long first = i ? item_end[i - 1] : 0;

  for (; it < it_stop; ++it) {
    while (item_end[i] <= it) first = item_end[i++];
    const int4 bb = bbox[i];
    const int n = bb.z * bb.w;
    const int p0 = (int)(it - first) * piece;
    const int p1 = min(p0 + piece, n);
    const float* c = coef + (size_t)i * 9;
    const float a0 = c[0], b0 = c[1], c0 = c[2];
    const float a1 = c[3], b1 = c[4], c1 = c[5];
    const float a2 = c[6], b2 = c[7], c2 = c[8];
    const int k = key[i];
    int* zb = zbuf + (size_t)(i / F) * H * W;
    for (int p = p0 + lane; p < p1; p += 32) {
      const int dy = p / bb.z;
      const int x = bb.x + (p - dy * bb.z);
      const int y = bb.y + dy;
      const float px = (float)x + 0.5f;
      const float py = (float)y + 0.5f;
      if (edge(px, py, a0, b0, c0) > kSlack && edge(px, py, a1, b1, c1) > kSlack
          && edge(px, py, a2, b2, c2) > kSlack)
        atomicMin(zb + (size_t)y * W + x, k);
    }
  }
}

__device__ __forceinline__ unsigned char gray_of(int k) {
  return k != kSentinel ? (unsigned char)(k & 0xFF) : (unsigned char)0;
}

__device__ __forceinline__ unsigned char covered_of(int k) {
  return k != kSentinel ? (unsigned char)1 : (unsigned char)0;
}

// gray = key & 0xFF where covered (key != SENTINEL), else 0; four pixels a
// thread per step, then the tail.
__global__ void __launch_bounds__(kThreads)
resolve_kernel(const int* __restrict__ zbuf, unsigned char* __restrict__ gray,
               unsigned char* __restrict__ covered, long long n) {
  const long long stride = (long long)gridDim.x * kThreads;
  const long long first = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long n4 = n / 4;
  for (long long j = first; j < n4; j += stride) {
    const int4 z = reinterpret_cast<const int4*>(zbuf)[j];
    reinterpret_cast<uchar4*>(gray)[j] =
        make_uchar4(gray_of(z.x), gray_of(z.y), gray_of(z.z), gray_of(z.w));
    reinterpret_cast<uchar4*>(covered)[j] = make_uchar4(
        covered_of(z.x), covered_of(z.y), covered_of(z.z), covered_of(z.w));
  }
  for (long long j = 4 * n4 + first; j < n; j += stride) {
    gray[j] = gray_of(zbuf[j]);
    covered[j] = covered_of(zbuf[j]);
  }
}

}  // namespace

// Launches K3 on `stream`: the rasterizer into `zbuf` (which the caller
// filled with 0x7FFFFFFF), then the resolve into `gray` and `covered`
// (bytes, B*H*W each; the int32 and uint8 buffers 16- and 4-byte aligned).
// Returns cudaGetLastError() (0 on success).
extern "C" int smpltpu_raster_i32(const int* bbox, const float* coef,
                                  const int* key, const long long* item_end,
                                  int B, int F, int H, int W, int piece,
                                  int* zbuf, unsigned char* gray,
                                  unsigned char* covered, void* stream) {
  if (B < 1 || F < 1 || H < 1 || W < 1 || piece < 1 || piece > (1 << 20)
      || (long long)B * F > 0x7FFFFFFFLL || (long long)H * W > (1LL << 30)
      || H > (1 << 22) || W > (1 << 22))
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  raster_kernel<<<sms * 8, kThreads, 0, s>>>(
      reinterpret_cast<const int4*>(bbox), coef, key, item_end, B * F, F, H,
      W, piece, zbuf);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long n = (long long)B * H * W;
  const long long want = (n / 4 + kThreads - 1) / kThreads;
  const int blocks = (int)(want < sms * 32LL ? (want > 0 ? want : 1) : sms * 32LL);
  resolve_kernel<<<blocks, kThreads, 0, s>>>(zbuf, gray, covered, n);
  return (int)cudaGetLastError();
}
