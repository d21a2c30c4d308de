// K5: the online LM trip's trust-region step, one CTA a problem.
//
// Replaces no TPU kernel: the JAX package leaves the step to XLA's
// Cholesky and triangular solves. On the H100 the eager step
// (solve/lm.py::chol_tr_step, four shifted factorizations, their solves
// and the secular update) ran as ~250 graph nodes a trip: four cuSOLVER
// factorizations (~24 us each), twelve triangular solves (~7 us each) and
// ~175 small elementwise kernels, some 0.45 of the trip's 0.66 ms.
//
// For each problem n, from its pinned h (P x P, only the lower triangle
// read, as cholesky_ex reads it), g (P) and radius, it computes what
// chol_tr_step computes, by the same method: diag_max = max(max diag h,
// 1), lam_floor = 30 eps diag_max, hi = |g| / radius + lam_floor, and up
// to newton_iters trips, each of which factors h + lam I (the whole factor
// NaN where a pivot is not positive, as solve/lm.py::_cholesky gives it,
// or where lam is not finite, as lam * eye then puts NaN off the
// diagonal), solves p = -(L L^T)^{-1} g and q = L^{-1} p, and applies the
// feasibility test, the bracket update and the Newton update of lam with
// its geometric-mean fallback. It skips what the eager loop throws away: a
// problem interior at the floor shift keeps its first iterate, so it stops
// there, and the last trip's q and lam are never read.
//
// What bounds it: latency. A problem is ~0.63 M multiply-adds over 4 trips
// (P^3 / 3 a factorization) and ~23 KB in, nanoseconds at the card's
// peaks; every column of a factorization waits for the one before, and
// every step of a triangular solve for the one before. Dependency floor:
// 4 x (76 column steps + 2 x 76 solve steps) at P = 76 (the solve for
// L^{-1} g rides in the factorization, below). So one CTA does a whole
// problem out of shared memory:
//   * h is staged once: its strict lower triangle into the working
//     array's (the first trip's) and, transposed, into its strict upper
//     triangle, its diagonal in a vector. Each later trip rebuilds the
//     lower triangle h + lam I from them;
//   * the working array has one more row, -g (a bordered matrix): its
//     factor's last row is z = L^{-1} (-g), so the forward solve for p
//     costs no steps of its own;
//   * the factorization is right-looking and blocked by kNB columns: one
//     warp factors a panel in registers (the pivot and the panel's L
//     values passed by warp shuffles, no barrier inside the panel), then
//     every warp updates the trailing lower triangle by the panel's rank
//     kNB product, a column a warp at a time; two CTA barriers a panel;
//   * the two triangular solves (L^T p = z, L q = p) are one warp's, the
//     vector in registers, each step's value passed by a shuffle, the
//     pivots' reciprocals kept from the factorization; unrolled, a block
//     of 32 steps at a time, with no test in a block that P does not cut.
// The row stride of the working array is odd, so a warp reading a column
// (its lanes on consecutive rows) meets no bank conflict. Every sum runs
// in a fixed order and nothing is atomic: the result is bitwise the same
// from launch to launch.
//
// Layouts: h (N, P, P), g (N, P), radius (N,), step (N, P), boundary (N,)
// one byte each (torch.bool). P <= kMaxP.

#include <cfloat>
#include <cmath>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxP = 96;                     // SMPL-X's whole-body frame: 94
constexpr int kNB = 8;                        // panel width
constexpr int kRowSlots = (kMaxP + 1 + 31) / 32;   // a lane's panel rows
constexpr int kVecSlots = (kMaxP + 31) / 32;       // a lane's vector entries
constexpr unsigned kFull = 0xffffffffu;

template <typename T> struct Eps;
template <> struct Eps<float> { static constexpr double value = FLT_EPSILON; };
template <> struct Eps<double> { static constexpr double value = DBL_EPSILON; };

__device__ __forceinline__ float t_sqrt(float v) { return sqrtf(v); }
__device__ __forceinline__ double t_sqrt(double v) { return sqrt(v); }

// torch.clamp(v, min=lo): NaN stays NaN
template <typename T>
__device__ __forceinline__ T clamp_min(T v, T lo) { return v < lo ? lo : v; }

// torch.amax's pair rule: NaN wins
template <typename T>
__device__ __forceinline__ T nan_max(T a, T b) {
  return isnan(a) ? a : (isnan(b) ? b : (a < b ? b : a));
}

// butterfly sums: every lane ends with the same bits (a + b == b + a)
template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

template <typename T>
__device__ __forceinline__ T warp_max(T v) {
  for (int o = 16; o > 0; o >>= 1) v = nan_max(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// One warp factors columns k0 .. k1 - 1 of rows k0 .. nrows - 1 (the
// border row the last): lane l holds rows k0 + l + 32 q. Column c's pivot
// is lane c's first row; L[k0 + cc][k0 + c] is lane cc's. Sets bad where a
// pivot is not positive; keeps each pivot's reciprocal in s_inv. The
// updates run unmasked: what they write above the diagonal block's
// diagonal is never read, nor stored.
template <typename T>
__device__ __forceinline__ void panel(T* m, int ld, int k0, int k1, int nrows,
                                      int lane, bool& bad, T* s_inv) {
  T v[kRowSlots][kNB];
#pragma unroll
  for (int q = 0; q < kRowSlots; ++q) {
    const int r = k0 + lane + 32 * q;
#pragma unroll
    for (int c = 0; c < kNB; ++c)
      v[q][c] = (r < nrows && k0 + c < k1 && k0 + c <= r) ? m[r * ld + k0 + c]
                                                          : T(0);
  }
#pragma unroll
  for (int c = 0; c < kNB; ++c) {
    if (k0 + c < k1) {
      const T d = __shfl_sync(kFull, v[0][c], c);
      bad = bad || !(d > T(0));
      const T s = t_sqrt(d);
      const T inv = T(1) / s;
#pragma unroll
      for (int q = 0; q < kRowSlots; ++q)
        v[q][c] = lane + 32 * q == c ? s : v[q][c] * inv;
#pragma unroll
      for (int cc = c + 1; cc < kNB; ++cc) {
        const T l = __shfl_sync(kFull, v[0][c], cc);
#pragma unroll
        for (int q = 0; q < kRowSlots; ++q) v[q][cc] -= v[q][c] * l;
      }
      if (lane == 0) s_inv[k0 + c] = inv;
    }
  }
#pragma unroll
  for (int q = 0; q < kRowSlots; ++q) {
    const int r = k0 + lane + 32 * q;
#pragma unroll
    for (int c = 0; c < kNB; ++c)
      if (r < nrows && k0 + c < k1 && k0 + c <= r) m[r * ld + k0 + c] = v[q][c];
  }
}

// Rows k1 .. nrows - 1, columns k1 .. p - 1 on or below the diagonal, less
// the full panel k0 .. k1 - 1's product; a column a warp at a time
template <typename T>
__device__ __forceinline__ void trailing(T* m, int ld, int k0, int k1, int p,
                                         int nrows, int warp, int lane) {
  for (int c = k1 + warp; c < p; c += kWarps) {
    T lc[kNB];
#pragma unroll
    for (int t = 0; t < kNB; ++t) lc[t] = m[c * ld + k0 + t];
    for (int r = c + lane; r < nrows; r += 32) {
      T* row = m + r * ld;
      T acc = row[c];
#pragma unroll
      for (int t = 0; t < kNB; ++t) acc -= row[k0 + t] * lc[t];
      row[c] = acc;
    }
  }
}

// One step of y <- L^{-T} y: entry j = 32 q + l solved, the entries
// before it updated by L's row j
template <int q, int l, typename T>
__device__ __forceinline__ void upper_step(const T* m, int ld, int lane,
                                           const T* s_inv, T (&y)[kVecSlots]) {
  const int j = 32 * q + l;
  const T xj = __shfl_sync(kFull, y[q], l) * s_inv[j];
  if (lane == l) y[q] = xj;
  const T* row = m + j * ld;                  // L^T's column j: L's row j
#pragma unroll
  for (int qq = 0; qq <= q; ++qq)
    if (lane + 32 * qq < j) y[qq] -= row[lane + 32 * qq] * xj;
}

// One step of y <- L^{-1} y: entry j solved, the entries after it updated
// by L's column j
template <int q, int l, typename T>
__device__ __forceinline__ void lower_step(const T* m, int ld, int p, int lane,
                                           const T* s_inv, T (&y)[kVecSlots]) {
  const int j = 32 * q + l;
  const T xj = __shfl_sync(kFull, y[q], l) * s_inv[j];
  if (lane == l) y[q] = xj;
#pragma unroll
  for (int qq = q; qq < kVecSlots; ++qq) {
    const int r = lane + 32 * qq;
    if (r > j && r < p) y[qq] -= m[r * ld + j] * xj;
  }
}

// The 32 steps of block q, last first; kCut: p cuts the block, so each
// step tests j < p, while a whole block runs straight through (its loads
// free to go ahead of the shuffles)
template <int q, int l, bool kCut, typename T>
__device__ __forceinline__ void upper_steps(const T* m, int ld, int p, int lane,
                                            const T* s_inv, T (&y)[kVecSlots]) {
  if (!kCut || 32 * q + l < p) upper_step<q, l>(m, ld, lane, s_inv, y);
  if constexpr (l > 0) upper_steps<q, l - 1, kCut>(m, ld, p, lane, s_inv, y);
}

template <int q, int l, bool kCut, typename T>
__device__ __forceinline__ void lower_steps(const T* m, int ld, int p, int lane,
                                            const T* s_inv, T (&y)[kVecSlots]) {
  if (!kCut || 32 * q + l < p) lower_step<q, l>(m, ld, p, lane, s_inv, y);
  if constexpr (l < 31) lower_steps<q, l + 1, kCut>(m, ld, p, lane, s_inv, y);
}

// y <- L^{-T} y, one warp, y[q] the entry lane + 32 q
template <int q = kVecSlots - 1, typename T>
__device__ __forceinline__ void solve_upper(const T* m, int ld, int p, int lane,
                                            const T* s_inv, T (&y)[kVecSlots]) {
  if (32 * q + 32 <= p) upper_steps<q, 31, false>(m, ld, p, lane, s_inv, y);
  else if (32 * q < p) upper_steps<q, 31, true>(m, ld, p, lane, s_inv, y);
  if constexpr (q > 0) solve_upper<q - 1>(m, ld, p, lane, s_inv, y);
}

// y <- L^{-1} y, one warp
template <int q = 0, typename T>
__device__ __forceinline__ void solve_lower(const T* m, int ld, int p, int lane,
                                            const T* s_inv, T (&y)[kVecSlots]) {
  if (32 * q + 32 <= p) lower_steps<q, 0, false>(m, ld, p, lane, s_inv, y);
  else if (32 * q < p) lower_steps<q, 0, true>(m, ld, p, lane, s_inv, y);
  if constexpr (q + 1 < kVecSlots) solve_lower<q + 1>(m, ld, p, lane, s_inv, y);
}

template <typename T>
struct Args {
  const T* h;
  const T* g;
  const T* radius;
  T* step;
  unsigned char* boundary;
  int p, iters;
};

template <typename T>
__global__ void __launch_bounds__(kThreads) tr_step_kernel(Args<T> a) {
  const int p = a.p, ld = p | 1, nrows = p + 1;
  const int prob = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  extern __shared__ __align__(16) unsigned char s_dyn[];
  T* m = reinterpret_cast<T*>(s_dyn);      // (p + 1, ld): L, below it -g
  __shared__ T s_hd[kMaxP], s_g[kMaxP], s_inv[kMaxP];
  __shared__ T s_lam;
  __shared__ int s_go;

  // 0. h's strict lower triangle into m's (the first trip's) and,
  //    transposed, into m's strict upper one (what later trips rebuild
  //    from); its diagonal; g. A row a warp, its columns by lanes; every
  //    load issued before the first store, so their latencies overlap
  const T* h = a.h + (size_t)prob * p * p;
  {
    constexpr int kRows = (kMaxP + kWarps - 1) / kWarps;
    T v[kRows][kVecSlots];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int q = 0; q < kVecSlots; ++q) {
        const int r = warp + kWarps * i, c = lane + 32 * q;
        v[i][q] = r < p && c <= r ? h[r * p + c] : T(0);
      }
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int q = 0; q < kVecSlots; ++q) {
        const int r = warp + kWarps * i, c = lane + 32 * q;
        if (r < p && c < r) {
          m[r * ld + c] = v[i][q];
          m[c * ld + r] = v[i][q];
        } else if (r < p && c == r) {
          s_hd[r] = v[i][q];
        }
      }
  }
  for (int t = tid; t < p; t += kThreads) s_g[t] = a.g[(size_t)prob * p + t];
  __syncthreads();

  // the secular carry lives in warp 0's registers, the same in every lane
  const T radius = a.radius[prob];
  T lam = 0, lo = 0, hi = 0;
  T x[kVecSlots];                          // the step: the last iterate
#pragma unroll
  for (int q = 0; q < kVecSlots; ++q) x[q] = T(0);
  bool interior = false;
  if (warp == 0) {
    T dm = s_hd[lane < p ? lane : 0], gg = 0;
    for (int t = lane; t < p; t += 32) {
      dm = nan_max(dm, s_hd[t]);
      gg += s_g[t] * s_g[t];
    }
    const T diag_max = clamp_min(warp_max(dm), T(1));
    const T lam_floor = T(30.0 * Eps<T>::value) * diag_max;
    hi = t_sqrt(warp_sum(gg)) / clamp_min(radius, T(1e-30)) + lam_floor;
    lam = lo = lam_floor;
    if (lane == 0) {
      s_lam = lam;
      s_go = a.iters > 0;
    }
  }
  __syncthreads();

  for (int it = 0; s_go; ++it) {
    // 1. m's lower triangle <- h + lam I (the first trip's strict lower
    //    triangle is staged), its last row <- -g; a row a warp
    const T lam_b = s_lam;
    for (int r = warp; r < nrows; r += kWarps)
      for (int c = lane; c < p && c <= r; c += 32) {
        if (r == p) m[r * ld + c] = -s_g[c];
        else if (c == r) m[r * ld + c] = s_hd[r] + lam_b;
        else if (it > 0) m[r * ld + c] = m[c * ld + r];
      }
    __syncthreads();

    // 2. the factorization, the border row's solve with it
    bool bad = !isfinite(lam_b);
    for (int k0 = 0; k0 < p; k0 += kNB) {
      const int k1 = min(k0 + kNB, p);
      if (warp == 0) panel(m, ld, k0, k1, nrows, lane, bad, s_inv);
      __syncthreads();
      if (k1 < p) {
        trailing(m, ld, k0, k1, p, nrows, warp, lane);
        __syncthreads();
      }
    }

    // 3. warp 0: p = L^{-T} z, and where another trip follows, q = L^{-1}
    //    p and the secular update of lam
    if (warp == 0) {
      const T nan = T(NAN);
      T y[kVecSlots];
#pragma unroll
      for (int q = 0; q < kVecSlots; ++q) {
        const int r = lane + 32 * q;
        y[q] = r < p ? (bad ? nan : m[p * ld + r]) : T(0);
      }
      if (!bad) solve_upper(m, ld, p, lane, s_inv, y);
      T pp = 0;
#pragma unroll
      for (int q = 0; q < kVecSlots; ++q) {
        x[q] = y[q];
        pp += y[q] * y[q];
      }
      const T pnorm = t_sqrt(warp_sum(pp));
      const bool feas = pnorm <= radius;
      bool go = false;
      if (it == 0 && feas) {
        interior = true;                  // the Gauss-Newton step, kept
      } else if (it + 1 < a.iters) {
        const T lo_i = feas ? lo : lam, hi_i = feas ? lam : hi;
        T qn2 = nan;
        if (!bad) {
          solve_lower(m, ld, p, lane, s_inv, y);
          T s = 0;
#pragma unroll
          for (int q = 0; q < kVecSlots; ++q) s += y[q] * y[q];
          qn2 = warp_sum(s);
        }
        qn2 = clamp_min(qn2, T(1e-30));
        T lam_i = lam + (pnorm * pnorm / qn2) * (pnorm - radius) / radius;
        if (lam_i <= lo_i || lam_i >= hi_i || !isfinite(lam_i))
          lam_i = t_sqrt(clamp_min(lo_i, T(1e-30)) * clamp_min(hi_i, T(1e-30)));
        lam = lam_i;
        lo = lo_i;
        hi = hi_i;
        go = true;
      }
      if (lane == 0) {
        s_lam = lam;
        s_go = go;
      }
    }
    __syncthreads();
  }

  if (warp == 0) {
#pragma unroll
    for (int q = 0; q < kVecSlots; ++q) {
      const int r = lane + 32 * q;
      if (r < p) a.step[(size_t)prob * p + r] = x[q];
    }
    if (lane == 0) a.boundary[prob] = interior ? 0 : 1;
  }
}

template <typename T>
int launch(const T* h, const T* g, const T* radius, T* step,
           unsigned char* boundary, int n, int p, int iters, void* stream) {
  if (n < 1 || p < 1 || p > kMaxP || iters < 0)
    return (int)cudaErrorInvalidValue;
  const int smem = (p + 1) * (p | 1) * (int)sizeof(T);
  // float64 at P = 94 needs ~71 KB, past the 48 KB a launch gets unasked;
  // asked at every launch, as the attribute is the current device's
  const cudaError_t e = cudaFuncSetAttribute(
      tr_step_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  Args<T> a{h, g, radius, step, boundary, p, iters};
  tr_step_kernel<T><<<n, kThreads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int smpltpu_tr_step_f32(const float* h, const float* g,
                                   const float* radius, float* step,
                                   unsigned char* boundary, int n, int p,
                                   int iters, void* stream) {
  return launch<float>(h, g, radius, step, boundary, n, p, iters, stream);
}

extern "C" int smpltpu_tr_step_f64(const double* h, const double* g,
                                   const double* radius, double* step,
                                   unsigned char* boundary, int n, int p,
                                   int iters, void* stream) {
  return launch<double>(h, g, radius, step, boundary, n, p, iters, stream);
}
