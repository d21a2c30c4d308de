// K3: the z-buffer mesh rasterizer, tile-binned, with each tile's z-buffer
// in shared memory and the per-face setup done on the card.
//
// Replaces the TPU kernel smpltpu/render/pallas_raster.py::rasterize_tiled
// (_raster_kernel) and the per-face setup in front of it (_face_setup and
// the edge coefficients). For each frame b and pixel (x, y), the output is
// the minimum int32 key (depth_q << 8 | gray) over the kept faces whose
// three edge functions at the pixel center (x + 0.5, y + 0.5) are all
// > -1e-12:
//
//     e_k = (px * A_k) + ((py * B_k) + C_k)
//
// gray = key & 0xFF and covered = 1 where some face covers the pixel, else
// both 0. An integer minimum is order-independent, so the result does not
// depend on the order of the tiles' face lists and repeats bit for bit.
//
// What bounds it on an H100: the bytes. Per 100 frames at 720 x 1280 gray
// and covered are 184 MB; from a given FaceSetup the per-face inputs are
// ~90 MB more (82 us at 3.35 TB/s), from the vertices 8.5 MB (58 us). The
// edge tests are 12 flops for every pixel of every kept face's bounding
// box, ~13 us at the FP32 rate. A z-buffer in device memory (filled,
// hit by one global atomic per fragment, read back by a resolve pass)
// moves 3.7x those bytes, and a setup made of elementwise library calls
// moves the (B, F, 3, 3) gather and every intermediate through device
// memory some 90 times; so neither exists here.
//
// Design, three stages on one stream, scratch from the caller:
//
//  1. setup_kernel, a thread per (frame, face), in three steps, each only
//     for the faces that pass the one before (half a body's faces are
//     culled, and the correctly rounded quotients and roots are most of
//     the kernel's instructions). From the vertices, read straight through
//     `faces` with the vertices' strides (no (B, F, 3, 3) gather): the
//     z > 1e-6 test and the backface cull, and the depth, whose
//     quantization waits for the frame's far kept face (a block maximum,
//     then an atomicMax on the float's bits, which orders non-negative
//     floats); for a kept face the projection and the bounding box clipped
//     to the frame; for a face with a box the shade and gray and the nine
//     edge coefficients in canonical winding. From a given FaceSetup: the
//     box, the rest copied. A face with a box gets a 16-word record; the
//     block's records are packed (a ballot scan, one atomicAdd on the
//     frame's cursor for the block) and go out through shared memory in
//     one run of 16-byte stores, so that what the later stages read is
//     dense; `slot` maps a face to its record. Then the face is binned:
//     one whose box touches at most kSmallTiles screen tiles adds one to
//     each of those tiles' counts (one atomic for all the lanes of a warp
//     that name the same tile); any other face joins its frame's list of
//     big faces and adds one to the big count of every tile it touches.
//  2. scan_kernel, a block per frame: the exclusive prefix sum of the
//     frame's tile counts. fill_kernel, a thread per (frame, face): forms
//     key = depth_q << 8 | gray now that the frame's maximum is known, and
//     writes the record's slot into its tiles' lists, all of a face's
//     atomics under way before the first is waited for (a frame's lists
//     share kSmallTiles * F entries, which they cannot outgrow). Nothing
//     is capped and nothing truncated: a face over the whole frame is one
//     entry of the big list, which every tile it touches walks.
//  3. tile_kernel, a CTA per (frame, tile) of kTileW x kTileH pixels: the
//     tile's int32 z-buffer lives in shared memory. The tile's faces (its
//     own list, then those of the frame's big faces whose box meets it)
//     are staged kBatch at a time: slots, then the records, four threads
//     a face, so a face costs no round trip to L2 while it is drawn. The
//     batch's work is cut into items, one per row of a face's box inside
//     the tile and kSeg pixels of it, numbered by a prefix sum over the
//     batch; a thread takes an item (a binary search finds its face),
//     evaluates the three row terms once and walks its pixels, folding
//     the inside ones in by a shared-memory atomicMin. So the work
//     spreads over the CTA's threads by pixels, whatever the faces'
//     sizes: one face over the whole tile is 160 items. Then gray and
//     covered are written once, 4 pixels a thread. A tile with no face
//     (three of four on a body's frame) touches no face data and writes
//     zeros as 16-byte stores.
//
// Where the time goes (100 fitted frames, H100; chip_smoke.py phase 6
// render_profile): the tile kernel 0.27 ms, of which writing the images is
// 0.105 ms (what it takes when every tile is empty: 36 000 small CTAs
// reach 1.75 TB/s of stores, and a 720-byte image row shares its first
// and last 32-byte sector with its neighbours, so a tile's rows end in
// partial sectors that only merge in L2), the edge tests ~0.09, staging
// ~0.04, the atomics ~0.03, the items' search and clip ~0.02; setup 0.065
// ms (0.045 before binning and records: loads, the exact arithmetic, the
// scan) and fill 0.05 ms (0.02 the records' key and box, 0.02 the lists).
// Tried and dropped, each slower: a warp per face over a power-of-two
// patch of its box (idle lanes); three tiles a CTA (fewer CTAs, but a
// body's tiles sit together and serialize); clearing the empty tiles from
// fill_kernel (its stores do not merge in L2); the inside test as a bit
// mask first, atomics after; and, no faster on a body's frames though a
// third faster on empty ones, a row's first CTA writing the zeros of all
// the row's empty tiles: the drawn tiles set the time, not the stores.
//
// Exactness: the setup's every product, sum, quotient and root is a
// rounding intrinsic (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn,
// __fsqrt_rn; rintf for round-half-even), in the order of the float32
// operations of render/zbuffer.py::face_setup and face_bbox, and so is the
// edge test against rasterize_torch: nvcc never contracts an intrinsic
// into an FMA, while it would turn a * b + c written with operators into
// one, whose single rounding moves keys, coefficients and with them
// pixels on an edge. clamp propagates NaN as torch.clamp does (fmaxf
// alone would drop it), and a NaN corner empties the box as face_bbox's
// lo <= hi does. So key, coef and box are bit-equal to the plain setup,
// and the images to the plain rasterizer's in every pixel.
//
// Buffer reuse: `meta` holds, per frame, the maximum's bits and the big
// list's length, then per (frame, tile) the count, the big count and the
// list offset (and, per frame, the count of its records); the entry point
// zeroes all but the offsets on every call
// (cudaMemsetAsync on the stream). fill_kernel advances each tile's offset
// as it writes, so after it offset is the END of the tile's list and count
// its length. A record's key word holds gray between setup and fill, the
// key after; its depth word is read by fill alone. A frame's records fill
// the front of its F slots in an order that varies from run to run, and
// so do the lists; the images do not.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileW = 80;          // a multiple of 16: aligned 16-byte stores
constexpr int kTileH = 32;
constexpr int kStride = kTileW + 1;  // z-buffer row in shared memory: odd,
                                     // so rows at one x fall in distinct banks
constexpr int kSeg = 16;            // pixels of a row one thread walks
constexpr int kSmallTiles = 8;      // more tiles than this: a big face
constexpr int kBatch = 128;         // faces staged per round of a tile
// a face's record: 9 edge coefficients, the key (gray alone until the
// frame's far depth is known), the box x0, y0, w, h, the depth, a pad: 64
// bytes, two sectors, read by a tile as four 16-byte loads
constexpr int kRec = 16, kRecKey = 9, kRecBox = 10, kRecDepth = 14;
constexpr int kRecStride = kRec + 1;   // in shared memory: no bank conflicts
constexpr int kSentinel = 0x7FFFFFFF;
constexpr int kDepthLevels = (1 << 22) - 2;
constexpr float kSlack = -1e-12f;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float quo(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ float sum3(float a, float b, float c) {
  return add(add(a, b), c);
}
// torch.clamp: NaN goes through
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x != x ? x : fmaxf(x, lo);
}
__device__ __forceinline__ float clamp(float x, float lo, float hi) {
  return x != x ? x : fminf(fmaxf(x, lo), hi);
}

struct Args {
  // from the vertices (verts != nullptr) ...
  const float* verts;            // (B, nV, 3) with element strides sb, sv, sc
  long long sb, sv, sc;
  int nV;
  const int* faces;              // (F, 3)
  float fx, fy, cx, cy;
  // ... or from a FaceSetup
  const float* u;                // (B, F, 3)
  const float* v;                // (B, F, 3)
  const unsigned char* keep;     // (B, F)
  const float* coef;             // (B, F, 9)
  const int* key;                // (B, F)
  // what the tiles read: a record of kRec words (layout above) for every
  // face with a box, a frame's records packed at the front of its F slots
  int4* rec;                     // (B, F, kRec / 4)
  int* slot;                     // (B, F) the face's record, -1 if none
  // binning
  int* zmax_bits;                // (B)
  int* rec_len;                  // (B) records of the frame
  int* big_len;                  // (B)
  int* count;                    // (B, T) small faces of the tile
  int* big_here;                 // (B, T) big faces that touch the tile
  int* offset;                   // (B, T)
  int* list;                     // (B, kSmallTiles * F) records, by slot
  int* big;                      // (B, F) records of big faces, by slot
  int F, H, W, ntx, nty;
};

// One axis of face_bbox: the pixels [a, a + n) the corners' span touches,
// clipped to [0, size); n = 0 if none, or if a corner is NaN.
__device__ __forceinline__ void span(const float (&c)[3], int size, int& a,
                                     int& n) {
  const bool ok = !(c[0] != c[0] || c[1] != c[1] || c[2] != c[2]);
  const float lo = fminf(fminf(c[0], c[1]), c[2]);
  const float hi = fmaxf(fmaxf(c[0], c[1]), c[2]);
  const float fa = floorf(clamp(ok ? lo : 0.f, -1.f, (float)size));
  const float fb = floorf(clamp(ok ? hi : -1.f, -1.f, (float)size));
  a = max((int)fa, 0);
  const int b = min((int)fb, size - 1);
  n = max(b - a + 1, 0);
}

struct TileRange { int tx0, tx1, ty0, ty1; };

__device__ __forceinline__ TileRange tiles_of(const int4 bb) {
  return {bb.x / kTileW, (bb.x + bb.z - 1) / kTileW, bb.y / kTileH,
          (bb.y + bb.w - 1) / kTileH};
}

__device__ __forceinline__ bool is_small(const TileRange r) {
  return (r.tx1 - r.tx0 + 1) * (r.ty1 - r.ty0 + 1) <= kSmallTiles;
}

// counter[at] += 1 for every lane that is `valid`, one atomic for all the
// lanes of the warp that name the same place (faces next to each other in
// the mesh fall into the same tile). Every lane of the warp calls it.
// -> the lanes that named this lane's place (0 if not valid) and, in the
// first of them, the counter's old value; warp_inc_place turns the two
// into the lane's own old value.
struct Inc { unsigned peers; int first; };

__device__ __forceinline__ Inc warp_inc(int* counter, int at, bool valid) {
  const unsigned active = __ballot_sync(0xFFFFFFFFu, valid);
  Inc inc = {0u, 0};
  if (!valid) return inc;
  inc.peers = __match_any_sync(active, at);
  if ((threadIdx.x & 31) == __ffs(inc.peers) - 1)
    inc.first = atomicAdd(counter + at, __popc(inc.peers));
  return inc;
}

__device__ __forceinline__ int warp_inc_place(const Inc inc) {
  const int lane = threadIdx.x & 31;
  return __shfl_sync(inc.peers, inc.first, __ffs(inc.peers) - 1)
         + __popc(inc.peers & ((1u << lane) - 1));
}

// Walks a face's tiles row by row: next() gives the tile's index in the
// frame, then -1 once they are used up (at once, if the face has none).
struct TileWalk {
  TileRange r;
  int tx, ty;
  __device__ TileWalk(const TileRange range, bool has_tiles)
      : r(range), tx(range.tx0), ty(has_tiles ? range.ty0 : range.ty1 + 1) {}
  __device__ int next(int ntx) {
    if (ty > r.ty1) return -1;
    const int t = ty * ntx + tx;
    if (++tx > r.tx1) { tx = r.tx0; ++ty; }
    return t;
  }
};

template <bool kFromVerts>
__global__ void __launch_bounds__(kThreads) setup_kernel(const Args a) {
  const int f = blockIdx.x * kThreads + threadIdx.x;
  const int b = blockIdx.y;
  const int T = a.ntx * a.nty;
  float far_kept = 0.f;
  bool on = false;
  TileRange r = {};
  __shared__ int block_rec[kThreads * kRecStride];
  int* mine = block_rec + threadIdx.x * kRecStride;
  if (f < a.F) {
    // in three steps, each only for the faces that pass the one before
    // (half the faces of a body are culled, and the quotients and roots
    // below are most of this kernel's instructions): is the face kept;
    // its corners on the screen and its box; its record
    const size_t i = (size_t)b * a.F + f;
    float p[3][3], n[3], ctr[3], u[3], v[3];
    bool keep;
    if (kFromVerts) {
      bool valid = true;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const int vi = a.faces[f * 3 + k];
        if ((unsigned)vi >= (unsigned)a.nV) __trap();   // an index past the mesh
        const float* src = a.verts + b * a.sb + vi * a.sv;
#pragma unroll
        for (int c = 0; c < 3; ++c) p[k][c] = src[c * a.sc];
        valid = valid && p[k][2] > 1e-6f;
      }
      float e1[3], e2[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        e1[c] = sub(p[1][c], p[0][c]);
        e2[c] = sub(p[2][c], p[0][c]);
        // the mean of the corners as the reference lowers it: times f32(1/3)
        ctr[c] = mul(add(add(p[0][c], p[1][c]), p[2][c]), (float)(1.0 / 3.0));
      }
      n[0] = sub(mul(e1[1], e2[2]), mul(e1[2], e2[1]));
      n[1] = sub(mul(e1[2], e2[0]), mul(e1[0], e2[2]));
      n[2] = sub(mul(e1[0], e2[1]), mul(e1[1], e2[0]));
      keep = valid && n[2] < 0.f;
      far_kept = keep ? ctr[2] : 0.f;
    } else {
      keep = a.keep[i] != 0;
    }

    int4 bb = make_int4(0, 0, 0, 0);
    if (keep) {
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        if (kFromVerts) {
          const float z = p[k][2];
          const float zs = fabsf(z) < 1e-8f ? 1e-8f : z;
          u[k] = add(quo(mul(a.fx, p[k][0]), zs), a.cx);
          v[k] = add(quo(mul(a.fy, p[k][1]), zs), a.cy);
        } else {
          u[k] = a.u[i * 3 + k];
          v[k] = a.v[i * 3 + k];
        }
      }
      span(u, a.W, bb.x, bb.z);
      span(v, a.H, bb.y, bb.w);
      on = bb.z > 0 && bb.w > 0;
    }

    if (on) {
      if (kFromVerts) {
        const float n_len = clamp_min(
            __fsqrt_rn(sum3(mul(n[0], n[0]), mul(n[1], n[1]), mul(n[2], n[2]))),
            1e-30f);
        const float c_len = clamp_min(
            __fsqrt_rn(sum3(mul(ctr[0], ctr[0]), mul(ctr[1], ctr[1]),
                            mul(ctr[2], ctr[2]))), 1e-30f);
        const float shade = clamp(
            sum3(mul(quo(n[0], n_len), quo(-ctr[0], c_len)),
                 mul(quo(n[1], n_len), quo(-ctr[1], c_len)),
                 mul(quo(n[2], n_len), quo(-ctr[2], c_len))), 0.f, 1.f);
        mine[kRecKey] = (int)rintf(mul(220.f, shade));   // gray; fill makes the key
        mine[kRecDepth] = __float_as_int(ctr[2]);
        float coef[9];
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          const int j = (k + 1) % 3;
          const float dy = sub(v[j], v[k]), dx = sub(u[j], u[k]);
          coef[3 * k] = -dy;
          coef[3 * k + 1] = dx;
          coef[3 * k + 2] = sub(mul(dy, u[k]), mul(dx, v[k]));
        }
        const float area = sub(mul(sub(u[1], u[0]), sub(v[2], v[0])),
                               mul(sub(v[1], v[0]), sub(u[2], u[0])));
        const float sign = area < 0.f ? -1.f : 1.f;
#pragma unroll
        for (int k = 0; k < 9; ++k) mine[k] = __float_as_int(mul(coef[k], sign));
      } else {
#pragma unroll
        for (int k = 0; k < 9; ++k) mine[k] = __float_as_int(a.coef[i * 9 + k]);
        mine[kRecKey] = a.key[i];
        mine[kRecDepth] = 0;
      }
      mine[kRecBox] = bb.x;
      mine[kRecBox + 1] = bb.y;
      mine[kRecBox + 2] = bb.z;
      mine[kRecBox + 3] = bb.w;
      mine[kRec - 1] = 0;
    }
    r = tiles_of(bb);
  }

  // the block's faces with a box get consecutive records of the frame:
  // their rank in the block, behind a base taken from the frame's cursor
  __shared__ int warp_on[kWarps];
  __shared__ float warp_far[kWarps];
  __shared__ int block_base;
  __shared__ int thread_of[kThreads];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned on_lanes = __ballot_sync(0xFFFFFFFFu, on);
  if (kFromVerts) {
#pragma unroll
    for (int d = 16; d > 0; d >>= 1)
      far_kept = fmaxf(far_kept, __shfl_xor_sync(0xFFFFFFFFu, far_kept, d));
  }
  if (lane == 0) {
    warp_on[warp] = __popc(on_lanes);
    warp_far[warp] = far_kept;
  }
  __syncthreads();
  int rank = __popc(on_lanes & ((1u << lane) - 1)), n_on = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    if (w < warp) rank += warp_on[w];
    n_on += warp_on[w];
  }
  if (threadIdx.x == 0) {
    block_base = n_on ? atomicAdd(a.rec_len + b, n_on) : 0;
    if (kFromVerts) {
      // the frame's far kept face: kept depths are positive, so their
      // bits order as ints, and 0 stands for a frame with none
      for (int w = 1; w < kWarps; ++w) far_kept = fmaxf(far_kept, warp_far[w]);
      if (far_kept > 0.f) atomicMax(a.zmax_bits + b, __float_as_int(far_kept));
    }
  }
  if (on) thread_of[rank] = threadIdx.x;

  // binning, while thread 0's atomic is under way: a big face counts in
  // every tile it touches; the small faces' tiles go the warp's lanes in
  // step
  const bool big = on && !is_small(r);
  if (big) {
    for (int ty = r.ty0; ty <= r.ty1; ++ty)
      for (int tx = r.tx0; tx <= r.tx1; ++tx)
        atomicAdd(a.big_here + (size_t)b * T + ty * a.ntx + tx, 1);
  }
  TileWalk walk(r, on && !big);
  for (int k = 0; k < kSmallTiles; ++k) {
    const int t = walk.next(a.ntx);
    if (!__any_sync(0xFFFFFFFFu, t >= 0)) break;     // the warp's faces are done
    warp_inc(a.count + (size_t)b * T, t, t >= 0);
  }
  __syncthreads();
  const int slot = block_base + rank;
  if (f < a.F) a.slot[(size_t)b * a.F + f] = on ? slot : -1;
  if (big) a.big[(size_t)b * a.F + atomicAdd(a.big_len + b, 1)] = slot;

  // the block's records in one run of 16-byte stores
  int4* dst = a.rec + ((size_t)b * a.F + block_base) * (kRec / 4);
  for (int q = threadIdx.x; q < n_on * (kRec / 4); q += kThreads) {
    const int* src = block_rec + thread_of[q >> 2] * kRecStride + (q & 3) * 4;
    dst[q] = make_int4(src[0], src[1], src[2], src[3]);
  }
}

// offset[b, t] = sum of count[b, 0..t): one block per frame
__global__ void __launch_bounds__(kThreads)
scan_kernel(const int* __restrict__ count, int* __restrict__ offset, int T) {
  __shared__ int warp_sum[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t row = (size_t)blockIdx.x * T;
  int carry = 0;
  for (int base = 0; base < T; base += kThreads) {
    const int t = base + threadIdx.x;
    const int x = t < T ? count[row + t] : 0;
    int s = x;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xFFFFFFFFu, s, d);
      if (lane >= d) s += y;
    }
    if (lane == 31) warp_sum[warp] = s;
    __syncthreads();
    int before = 0, total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      if (w < warp) before += warp_sum[w];
      total += warp_sum[w];
    }
    if (t < T) offset[row + t] = carry + before + s - x;
    carry += total;
    __syncthreads();
  }
}

template <bool kFromVerts>
__global__ void __launch_bounds__(kThreads) fill_kernel(const Args a) {
  const int f = blockIdx.x * kThreads + threadIdx.x;
  const int b = blockIdx.y;
  const int T = a.ntx * a.nty;
  bool small = false;
  TileRange r = {};
  const int slot = f < a.F ? a.slot[(size_t)b * a.F + f] : -1;
  if (slot >= 0) {
    const size_t i = (size_t)b * a.F + slot;
    // the record's words 8..15: a coefficient, key, box, depth, pad
    const int4 lo = a.rec[i * 4 + 2], hi = a.rec[i * 4 + 3];
    if (kFromVerts) {
      const float zmax = add(__int_as_float(a.zmax_bits[b]), 1e-6f);
      const int depth_q = (int)clamp(
          mul(quo(__int_as_float(hi.z), zmax), (float)kDepthLevels), 0.f,
          (float)kDepthLevels);
      reinterpret_cast<int*>(a.rec)[i * kRec + kRecKey] = (depth_q << 8) | lo.y;
    }
    r = tiles_of(make_int4(lo.z, lo.w, hi.x, hi.y));
    small = is_small(r);
  }
  int* list = a.list + (size_t)b * kSmallTiles * a.F;
  // every tile's atomic is under way before the first is waited for
  Inc inc[kSmallTiles];
  TileWalk walk(r, small);
#pragma unroll
  for (int k = 0; k < kSmallTiles; ++k) {
    const int t = walk.next(a.ntx);
    inc[k] = warp_inc(a.offset + (size_t)b * T, t, t >= 0);
  }
#pragma unroll
  for (int k = 0; k < kSmallTiles; ++k)
    if (inc[k].peers) list[warp_inc_place(inc[k])] = slot;
}

// A staged face: its box clipped to the tile [X0, X1) x [Y0, Y1), and the
// number of work items it makes there, one per row and kSeg pixels of it.
struct Clip { int bx0, bx1, by0, rows, segs; };

__device__ __forceinline__ Clip clip_to_tile(const float4* __restrict__ rec,
                                             int X0, int Y0, int X1, int Y1) {
  const float4 r2 = rec[2], r3 = rec[3];
  const int x0 = __float_as_int(r2.z), y0 = __float_as_int(r2.w);
  Clip c;
  c.bx0 = max(x0, X0);
  c.bx1 = min(x0 + __float_as_int(r3.x), X1);
  c.by0 = max(y0, Y0);
  c.rows = max(min(y0 + __float_as_int(r3.y), Y1) - c.by0, 0);
  c.segs = max(c.bx1 - c.bx0 + kSeg - 1, 0) / kSeg;
  return c;
}

// What a CTA of tile_kernel keeps in shared memory.
struct TileSmem {
  int zb[kTileH * kStride];
  float4 rec[kBatch][4];
  int staged[kBatch];
  int item_end[kBatch];
  int warp_items[kBatch / 32];
  int n_staged;
};

// The tile [X0, X1) x [Y0, Y1) of frame b, which has n_small faces in its
// own list (ending at list_end) and, if big_here, some of the frame's big
// faces: its z-buffer in sm.zb, from SENTINEL to the minimum key of every
// pixel. Every thread of the CTA calls it.
__device__ __forceinline__ void draw_tile(const Args& a, TileSmem& sm, int b,
                                          int X0, int Y0, int X1, int Y1,
                                          int n_small, int list_end,
                                          bool big_here) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < kTileH * kStride; i += kThreads)
    sm.zb[i] = kSentinel;
  const int* small = a.list + (size_t)b * kSmallTiles * a.F + list_end - n_small;
  const int* big = a.big + (size_t)b * a.F;
  for (int pass = 0; pass < 2; ++pass) {
    // pass 0: the tile's own list; pass 1: the frame's big faces, those
    // of them that touch this tile
    const int n = pass == 0 ? n_small : big_here ? a.big_len[b] : 0;
    for (int base = 0; base < n; base += kBatch) {
      int nb = min(kBatch, n - base);
      if (pass == 0) {
        if (threadIdx.x < nb) sm.staged[threadIdx.x] = small[base + threadIdx.x];
      } else {
        if (threadIdx.x == 0) sm.n_staged = 0;
        __syncthreads();
        if (threadIdx.x < nb) {
          const int slot = big[base + threadIdx.x];
          const int4* r = a.rec + ((size_t)b * a.F + slot) * 4;
          const int4 lo = r[2], hi = r[3];
          if (lo.z < X1 && lo.z + hi.x > X0 && lo.w < Y1 && lo.w + hi.y > Y0)
            sm.staged[atomicAdd(&sm.n_staged, 1)] = slot;
        }
      }
      __syncthreads();
      if (pass == 1) nb = sm.n_staged;
      // the faces' records, four threads a face
      for (int q = threadIdx.x; q < nb * 4; q += kThreads)
        reinterpret_cast<int4*>(sm.rec)[q] =
            a.rec[((size_t)b * a.F + sm.staged[q >> 2]) * 4 + (q & 3)];
      __syncthreads();
      // the running total of the faces' work items
      if (threadIdx.x < kBatch) {
        int items = 0;
        if (threadIdx.x < nb) {
          const Clip c = clip_to_tile(sm.rec[threadIdx.x], X0, Y0, X1, Y1);
          items = c.rows * c.segs;
        }
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          const int y = __shfl_up_sync(0xFFFFFFFFu, items, d);
          if (lane >= d) items += y;
        }
        sm.item_end[threadIdx.x] = items;
        if (lane == 31) sm.warp_items[warp] = items;
      }
      __syncthreads();
      if (threadIdx.x < kBatch) {
        int before = 0;
        for (int w = 0; w < warp; ++w) before += sm.warp_items[w];
        sm.item_end[threadIdx.x] += before;
      }
      __syncthreads();
      // one thread per item: a row of a face, kSeg pixels of it
      const int total = sm.item_end[kBatch - 1];
      for (int it = threadIdx.x; it < total; it += kThreads) {
        int lo = 0, hi = nb - 1;          // the first face with item_end > it
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (sm.item_end[mid] > it) hi = mid; else lo = mid + 1;
        }
        const float4* face = sm.rec[lo];
        const Clip c = clip_to_tile(face, X0, Y0, X1, Y1);
        const int local = it - (lo ? sm.item_end[lo - 1] : 0);
        // local / segs without the integer division: exact, the values
        // are below a tile's kTileH * kTileW / kSeg items
        const int r = c.segs == 1 ? local
            : (int)(((float)local + 0.5f) * __frcp_rn((float)c.segs));
        const int xs = c.bx0 + (local - r * c.segs) * kSeg;
        const int xe = min(xs + kSeg, c.bx1);
        const float4 r0 = face[0], r1 = face[1], r2 = face[2];
        const float py = (float)(c.by0 + r) + 0.5f;
        float px = (float)xs + 0.5f;           // += 1 is exact below 2^23
        const float t0 = add(mul(py, r0.y), r0.z);
        const float t1 = add(mul(py, r1.x), r1.y);
        const float t2 = add(mul(py, r1.w), r2.x);
        const int key = __float_as_int(r2.y);
        int* row = sm.zb + (c.by0 + r - Y0) * kStride - X0;
#pragma unroll 4
        for (int x = xs; x < xe; ++x, px += 1.f) {
          if (add(mul(px, r0.x), t0) > kSlack && add(mul(px, r0.w), t1) > kSlack
              && add(mul(px, r1.z), t2) > kSlack)
            atomicMin(row + x, key);
        }
      }
      __syncthreads();
    }
  }
}

// A CTA per frame and tile.
__global__ void __launch_bounds__(kThreads, 8)
tile_kernel(const Args a, unsigned char* __restrict__ gray,
            unsigned char* __restrict__ covered, int vec) {
  __shared__ __align__(16) TileSmem sm;
  const int b = blockIdx.y;
  const int tx = blockIdx.x % a.ntx, ty = blockIdx.x / a.ntx;
  const int X0 = tx * kTileW, Y0 = ty * kTileH;
  const int X1 = min(X0 + kTileW, a.W), Y1 = min(Y0 + kTileH, a.H);
  const int rows = Y1 - Y0, cols = X1 - X0;
  const size_t t = (size_t)b * a.ntx * a.nty + blockIdx.x;
  const size_t row0 = (size_t)b * a.H + Y0;        // the tile's first image row
  const int n_small = a.count[t], big_here = a.big_here[t];
  const bool any = n_small + big_here > 0;         // the same in every thread
  if (any) draw_tile(a, sm, b, X0, Y0, X1, Y1, n_small, a.offset[t], big_here > 0);

  if (vec && !any) {
    // 16 zero bytes a store: W, and so cols, is a multiple of 16
    const int segs = cols / 16;
    for (int q = threadIdx.x; q < 2 * rows * segs; q += kThreads) {
      const int plane = q / (rows * segs), r = (q / segs) % rows, s = q % segs;
      unsigned char* dst = plane ? covered : gray;
      *reinterpret_cast<int4*>(dst + (row0 + r) * a.W + X0 + s * 16) =
          make_int4(0, 0, 0, 0);
    }
  } else if (vec) {
    // 4 pixels a thread
    const int segs = cols / 4;
    for (int q = threadIdx.x; q < rows * segs; q += kThreads) {
      const int r = q / segs, s = q - r * segs;
      const int* z = sm.zb + r * kStride + s * 4;
      const bool c0 = z[0] != kSentinel, c1 = z[1] != kSentinel,
                 c2 = z[2] != kSentinel, c3 = z[3] != kSentinel;
      const size_t o = (row0 + r) * a.W + X0 + s * 4;
      *reinterpret_cast<uchar4*>(gray + o) = make_uchar4(
          c0 ? z[0] & 0xFF : 0, c1 ? z[1] & 0xFF : 0, c2 ? z[2] & 0xFF : 0,
          c3 ? z[3] & 0xFF : 0);
      *reinterpret_cast<uchar4*>(covered + o) = make_uchar4(c0, c1, c2, c3);
    }
  } else {
    for (int q = threadIdx.x; q < rows * cols; q += kThreads) {
      const int r = q / cols, c = q - r * cols;
      const int z = any ? sm.zb[r * kStride + c] : kSentinel;
      const size_t o = (row0 + r) * a.W + X0 + c;
      gray[o] = z != kSentinel ? (unsigned char)(z & 0xFF) : (unsigned char)0;
      covered[o] = z != kSentinel;
    }
  }
}

// The three stages on `stream`. `meta` is (3 B + 3 B T) ints: the frames'
// maxima, record counts and big-list lengths and the tiles' two counts
// (zeroed here), then the tiles' offsets.
int launch(Args a, int B, int* meta, unsigned char* gray,
           unsigned char* covered, cudaStream_t s) {
  if (B < 1 || B > 65535 || a.F < 1 || a.H < 1 || a.W < 1 || a.H > (1 << 22)
      || a.W > (1 << 22) || (long long)a.H * a.W > (1LL << 30)
      || (long long)B * a.F > 0x7FFFFFFFLL / kSmallTiles)
    return (int)cudaErrorInvalidValue;
  a.ntx = (a.W + kTileW - 1) / kTileW;
  a.nty = (a.H + kTileH - 1) / kTileH;
  const long long T = (long long)a.ntx * a.nty;
  if (B * T > 0x3FFFFFFFLL) return (int)cudaErrorInvalidValue;
  a.zmax_bits = meta;
  a.rec_len = meta + B;
  a.big_len = meta + 2 * B;
  a.count = meta + 3 * B;
  a.big_here = a.count + B * T;
  a.offset = a.big_here + B * T;
  cudaError_t err = cudaMemsetAsync(meta, 0, sizeof(int) * (3 * B + 2 * B * T), s);
  if (err != cudaSuccess) return (int)err;
  const dim3 per_face((a.F + kThreads - 1) / kThreads, B);
  const bool from_verts = a.verts != nullptr;
  if (from_verts) setup_kernel<true><<<per_face, kThreads, 0, s>>>(a);
  else setup_kernel<false><<<per_face, kThreads, 0, s>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  scan_kernel<<<B, kThreads, 0, s>>>(a.count, a.offset, (int)T);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if (from_verts) fill_kernel<true><<<per_face, kThreads, 0, s>>>(a);
  else fill_kernel<false><<<per_face, kThreads, 0, s>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int vec = a.W % 16 == 0
      && ((uintptr_t)gray | (uintptr_t)covered) % 16 == 0;
  tile_kernel<<<dim3((unsigned)T, B), kThreads, 0, s>>>(a, gray, covered, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// K3 from a FaceSetup: u, v (B, F, 3), keep (B, F) bytes, coef (B, F, 9),
// key (B, F), all contiguous, into gray and covered (B, H, W bytes each).
// Scratch: rec (B, F, 16) ints, 16-byte aligned; slot (B, F) ints; meta
// (3 B + 3 B T) ints with T the tiles of a frame; list (B, 8 F) ints; big
// (B, F) ints.
// Returns the first CUDA error (0 on success).
extern "C" int smpltpu_raster_i32(const float* u, const float* v,
                                  const unsigned char* keep, const float* coef,
                                  const int* key, int B, int F, int H, int W,
                                  int* rec, int* slot, int* meta, int* list,
                                  int* big, unsigned char* gray,
                                  unsigned char* covered, void* stream) {
  Args a = {};
  a.u = u;
  a.v = v;
  a.keep = keep;
  a.coef = coef;
  a.key = key;
  a.rec = reinterpret_cast<int4*>(rec);
  a.slot = slot;
  a.list = list;
  a.big = big;
  a.F = F;
  a.H = H;
  a.W = W;
  return launch(a, B, meta, gray, covered, (cudaStream_t)stream);
}

// K3 from the vertices: verts (B, nV, 3) float32 with element strides
// sb, sv, sc, faces (F, 3) ints; scratch as above. After the call slot
// names the record of every face with a box, and the record holds its
// coefficients, key and box as the plain setup computes them.
extern "C" int smpltpu_raster_verts_f32(
    const float* verts, long long sb, long long sv, long long sc, int nV,
    const int* faces, float fx, float fy, float cx, float cy, int B, int F,
    int H, int W, int* rec, int* slot, int* meta, int* list, int* big,
    unsigned char* gray, unsigned char* covered, void* stream) {
  if (verts == nullptr || nV < 1) return (int)cudaErrorInvalidValue;
  Args a = {};
  a.verts = verts;
  a.sb = sb;
  a.sv = sv;
  a.sc = sc;
  a.nV = nV;
  a.faces = faces;
  a.fx = fx;
  a.fy = fy;
  a.cx = cx;
  a.cy = cy;
  a.rec = reinterpret_cast<int4*>(rec);
  a.slot = slot;
  a.list = list;
  a.big = big;
  a.F = F;
  a.H = H;
  a.W = W;
  return launch(a, B, meta, gray, covered, (cudaStream_t)stream);
}
