// K1: the arrowhead Jacobi-PCG solve, one thread-block cluster per window.
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
// What bounds it on an H100. Per CG step the work is one pass over D
// (23 104 B a frame at P = 76) and two reductions over the whole window
// whose results every later operation waits for. One window's D is 462 KB
// at stage 2 (F = 20) and 2.3 MB at stage 1 (F = 100), more than the
// 227 KB of shared memory of one SM, and stage 1 has a single window: one
// block per window would leave 131 SMs idle at stage 1 and stream D from
// L2 on every step. The matvec is a matrix-vector product (2 flops per
// float loaded), so wgmma does not help: what sets the pace is the bytes
// read from shared memory (7 frames of D a CTA, ~1300 cycles a step at
// 128 B a cycle) and the latency of the step's serial chain: 40 steps x 2
// cluster-wide exchanges is the dependency floor, whatever the bandwidth.
//
// Design. A window is spread over a cluster of `cluster` CTAs (up to 16,
// the non-portable maximum), each owning a contiguous range of frames
// (frames r*F/cluster up to (r+1)*F/cluster for rank r).
// - Load once: each CTA copies the D and B blocks of its first `n_res`
//   frames into shared memory with cp.async at the start; the 40 matvecs
//   then read shared memory. Frames past n_res (a window too large for its
//   cluster) stream D and B from L2 on each step in the same loop, in the
//   column form so that a warp's loads are coalesced: every F runs
//   through this one kernel.
// - The vectors x, r, d (two buffers), q and the preconditioner of the
//   CTA's rows live in shared memory, or in global scratch when they do
//   not fit (a window of hundreds of frames on a small cluster); a
//   template flag fixes which, so every load has a known address space.
// - Matvec: the row form of the symmetric D over shared memory, one row
//   per thread (544 threads: a CTA's 7 frames in one round), four
//   independent accumulators over 16-byte loads; a row stride of 76
//   floats puts 8 consecutive rows' float4 loads on distinct banks. P = 76
//   and nS = 10 are template constants for the fit's instantiation.
// - Cross-CTA traffic never waits on a cluster barrier inside the loop:
//   cooperative groups' cluster.sync() compiles to a GPU-scope fence and an
//   L1 invalidation, which cost more than the step's arithmetic. Each
//   exchange is st.async into every CTA's shared memory, completing bytes
//   of an mbarrier there, and a local wait on that mbarrier:
//   (1) B^T d (nS column sums, one warp each) and d.q, where
//       d.q = d_p.(q_p + B d_w) + d_w.C d_w needs no reduced value;
//   (2) r.z and r.r;
//   (3) the halo: each CTA sends its first and last frame of the new d to
//       its neighbours, which wait for it only in their edge rows.
//   Every CTA sums the ranks' partials in rank order from its own copy,
//   so alpha, beta and the rtol exit are bitwise identical in all CTAs
//   and from run to run (no float atomics).
// - Buffer reuse. A wait on an mbarrier only says that this CTA's data
//   has come in; other warps of the CTA may still be reading their own
//   buffers to send elsewhere. So each exchange has buffers (block
//   slots, gather slots) of its own, and a buffer is written again only
//   after a __syncthreads() that comes after every read of it in the
//   same threads; a remote CTA writes a gather or halo buffer again only
//   after it has this CTA's next exchange, which this CTA sends after
//   such a __syncthreads().
// - The shape block (nS <= 16: C d_w, the scalars) is computed
//   redundantly by every CTA.
// The launch plan (cluster size, resident frames, shared bytes, scratch)
// is computed in Python (ops/cg.py::k1_plan); the entry points here only
// check and launch it.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 544;   // 17 warps: a CTA's 7 frames of 76 rows in one round
constexpr int kWarps = kThreads / 32;
constexpr int kMaxShapes = 16;
constexpr int kMaxCluster = 16;
constexpr int kMaxP = 128;               // halo buffers hold one frame each
constexpr int kRed = kMaxShapes + 1;     // slots of the first reduction
// block-reduction slots: each warp's d.q and the nS column sums (the
// first reduction), then each warp's two values of the second, in slots
// of their own (see "Buffer reuse" above)
constexpr int kRedSlots = kWarps + kMaxShapes + 2 * kWarps;
// shared header, in floats: three mbarriers, block-reduction slots, the
// shape-block vectors, the gather buffers the cluster's CTAs write their
// partial sums into, C, and the two halo frames
constexpr int kHeader = 1280;
constexpr int kVecs = 6;                 // x, r, d0, d1, q, dinv
static_assert(8 + kRedSlots + 4 * kMaxShapes + kMaxCluster * (kRed + 2) +
                  kMaxShapes * kMaxShapes + 2 * kMaxP <= kHeader,
              "shared header too small");
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// Sum (a, b) over the warp (1 + 4 shuffles): lanes 0-15 end with a's
// total, lanes 16-31 with b's.
__device__ __forceinline__ float warp_reduce2(float a, float b) {
  const bool up = threadIdx.x & 16;
  float v = (up ? b : a) + __shfl_xor_sync(kFull, up ? a : b, 16);
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cluster_sync_all() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(1u));
}

// this CTA's one arrival on `bar` for the current phase, which then also
// waits for `bytes` of st.async data
__device__ __forceinline__ void mbar_expect(unsigned long long* bar,
                                            unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// Wait until the phase of `bar` with this parity has completed. Traps
// (a launch error, not a hang) if it has not after ~2^34 cycles.
__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  const unsigned a = smem_addr(bar);
  const long long t0 = clock64();
  unsigned done = 0;
  while (true) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(a), "r"(parity) : "memory");
    if (done) return;
    if (clock64() - t0 > (1ll << 34)) __trap();
  }
}

// Store v into the shared memory of cluster rank `rank` at the address
// `dst` has in this CTA; the store completes 4 bytes of the phase of
// `bar` (same address rule) in that CTA.
__device__ __forceinline__ void st_remote(const float* dst, float v,
                                          const unsigned long long* bar,
                                          int rank) {
  unsigned d, b;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(d) : "r"(smem_addr(dst)), "r"(rank));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(b) : "r"(smem_addr(bar)), "r"(rank));
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.u32 [%0], %1, "
      "[%2];\n" ::"r"(d), "r"(__float_as_uint(v)), "r"(b) : "memory");
}

// Value k of a gather buffer (value, rank: kMaxCluster slots, those of
// absent ranks 0) summed over the ranks in rank order: the same value in
// every thread of every CTA of the cluster. Four 16-byte loads.
__device__ __forceinline__ float gathered(const float* gather, int k) {
  const float4* g = reinterpret_cast<const float4*>(gather + k * kMaxCluster);
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < kMaxCluster / 4; ++j) {
    const float4 v = g[j];
    s = (((s + v.x) + v.y) + v.z) + v.w;
  }
  return s;
}

// Row form over shared memory: row . v, four independent accumulators,
// 16-byte loads.
template <int kP>
__device__ __forceinline__ float row_dot(const float* row, const float* v,
                                         int P, bool vec4) {
  float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
  int k = 0;
  if (vec4) {
    const float4* r4 = reinterpret_cast<const float4*>(row);
    const float4* v4 = reinterpret_cast<const float4*>(v);
    const int n4 = (kP > 0 ? kP : P) >> 2;
#pragma unroll 2
    for (int j = 0; j < n4; ++j) {
      const float4 m = r4[j];
      const float4 x = v4[j];
      a0 = fmaf(m.x, x.x, a0);
      a1 = fmaf(m.y, x.y, a1);
      a2 = fmaf(m.z, x.z, a2);
      a3 = fmaf(m.w, x.w, a3);
    }
    k = n4 << 2;
  }
  for (; k < P; ++k) a0 = fmaf(row[k], v[k], a0);
  return (a0 + a1) + (a2 + a3);
}

// Column form over global memory, for a frame streamed from L2: the
// threads of a warp hold consecutive columns, so each load is coalesced.
template <int kP>
__device__ __forceinline__ float col_dot(const float* __restrict__ col,
                                         const float* v, int P) {
  const int n = kP > 0 ? kP : P;
  float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
  int b = 0;
#pragma unroll 4
  for (; b + 3 < n; b += 4) {
    a0 = fmaf(__ldg(col + (size_t)b * n), v[b], a0);
    a1 = fmaf(__ldg(col + (size_t)(b + 1) * n), v[b + 1], a1);
    a2 = fmaf(__ldg(col + (size_t)(b + 2) * n), v[b + 2], a2);
    a3 = fmaf(__ldg(col + (size_t)(b + 3) * n), v[b + 3], a3);
  }
  for (; b < n; ++b) a0 = fmaf(__ldg(col + (size_t)b * n), v[b], a0);
  return (a0 + a1) + (a2 + a3);
}

__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         bool vec4) {
  const unsigned s = smem_addr(dst);
  if (vec4) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(src));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                 "l"(src));
  }
}

// kP, kNS > 0: P and nS fixed at compile time (the fit's 76 and 10), so
// the row and shape loops unroll; 0: taken from the arguments. kSmemVec:
// the vectors live in shared memory (else in global scratch), fixed at
// compile time so that their loads and stores are to a known space.
template <int kP, int kNS, bool kSmemVec>
__global__ void __launch_bounds__(kThreads, 1)
arrow_pcg_kernel(const float* __restrict__ d_all,    // (W, F, P, P)
                 const float* __restrict__ off_all,  // (W, F-1)
                 const float* __restrict__ tm,       // (P,)
                 const float* __restrict__ b_all,    // (W, F, P, nS)
                 const float* __restrict__ c_all,    // (W, nS, nS)
                 const float* __restrict__ gp_all,   // (W, F, P)
                 const float* __restrict__ gw_all,   // (W, nS)
                 float* __restrict__ dp_all,         // (W, F, P)
                 float* __restrict__ dw_all,         // (W, nS)
                 float* scratch,       // (W * cluster, 6, vec_len) or unused
                 int F, int P_arg, int nS_arg, int iters, float rtol2,
                 int n_res, int vec_len, int aligned) {
  extern __shared__ __align__(16) float smem[];
  const int P = kP > 0 ? kP : P_arg;
  const int nS = kNS > 0 ? kNS : nS_arg;
  cg::cluster_group cl = cg::this_cluster();
  const int cs = static_cast<int>(cl.num_blocks());
  const int rank = static_cast<int>(cl.block_rank());
  const int w = blockIdx.x / cs;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const bool vec4 = aligned && (P & 3) == 0;   // 16-byte rows of D

  // this CTA's frames [f0, f0 + nf)
  const int f0 = rank * F / cs;
  const int nf = (rank + 1) * F / cs - f0;
  const int nrows = nf * P;
  const int nres = min(n_res, nf);
  const bool has_prev = rank > 0;
  const bool has_next = rank + 1 < cs;
  const size_t pp = (size_t)P * P;
  const float* D = d_all + ((size_t)w * F + f0) * pp;
  const float* off = off_all + (size_t)w * (F - 1);
  const float* B = b_all + ((size_t)w * F + f0) * P * nS;
  const float* C = c_all + (size_t)w * nS * nS;
  const float* gp = gp_all + ((size_t)w * F + f0) * P;
  const float* gw = gw_all + (size_t)w * nS;

  unsigned long long* bars = reinterpret_cast<unsigned long long*>(smem);
  unsigned long long* bar_a = bars;         // the first reduction's gather
  unsigned long long* bar_b = bars + 1;     // the second's
  unsigned long long* bar_h = bars + 2;     // the halo frames
  float* gather_a = smem + 8;               // (kRed, kMaxCluster)
  float* gather_b = gather_a + kRed * kMaxCluster;   // (2, kMaxCluster)
  float* red = gather_b + 2 * kMaxCluster;  // kRedSlots
  float* red_b = red + kWarps + kMaxShapes; // the second reduction's
  float* xw = red + kRedSlots;              // shape-block vectors
  float* rw = xw + kMaxShapes;
  float* dw = rw + kMaxShapes;
  float* cinv = dw + kMaxShapes;
  float* cs_mat = cinv + kMaxShapes;        // nS * nS
  float* halo_prev = cs_mat + kMaxShapes * kMaxShapes;  // d of frame f0 - 1
  float* halo_next = halo_prev + kMaxP;     // d of frame f0 + nf
  float* vec = kSmemVec ? smem + kHeader
                        : scratch + (size_t)blockIdx.x * kVecs * vec_len;
  float* d_res = smem + kHeader + (kSmemVec ? kVecs * vec_len : 0);
  float* b_res = d_res + (size_t)n_res * pp;
  float* x = vec;
  float* r = vec + vec_len;
  float* dbuf = vec + 2 * vec_len;          // two buffers
  float* q = vec + 4 * vec_len;
  float* dinv = vec + 5 * vec_len;

  if (tid == 0) {
    mbar_init(bar_a);
    mbar_init(bar_b);
    mbar_init(bar_h);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  // load once: the resident frames' D and B blocks, in flight while the
  // vectors are set up
  {
    const size_t nd = (size_t)nres * pp;
    const size_t nb = (size_t)nres * P * nS;
    const int step = vec4 ? 4 : 1;
    for (size_t i = (size_t)tid * step; i < nd; i += (size_t)kThreads * step)
      cp_async(d_res + i, D + i, vec4);
    const bool b4 = vec4 && ((P * nS) & 3) == 0 &&
                    ((reinterpret_cast<size_t>(B) & 15) == 0);
    const int bstep = b4 ? 4 : 1;
    for (size_t i = (size_t)tid * bstep; i < nb;
         i += (size_t)kThreads * bstep)
      cp_async(b_res + i, B + i, b4);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  for (int i = tid; i < nS * nS; i += kThreads) cs_mat[i] = C[i];
  for (int i = tid; i < (kRed + 2) * kMaxCluster; i += kThreads)
    gather_a[i] = 0.f;                      // absent ranks' slots stay 0

  // x = 0, r = -g, d_old = 0 (so that d = z + 0 d_old at step 0); the
  // partial r.z and r.r, the shape block's counted once, by rank 0
  float part0 = 0.f, part1 = 0.f;
  for (int i = tid; i < nrows; i += kThreads) {
    const int f = i / P;
    const int a = i - f * P;
    const float di = 1.f / fmaxf(D[f * pp + (size_t)a * P + a], 1e-20f);
    const float ri = -gp[i];
    dinv[i] = di;
    x[i] = 0.f;
    r[i] = ri;
    dbuf[i] = 0.f;
    part0 += ri * (di * ri);
    part1 += ri * ri;
  }
  if (tid < nS) {
    const float ci = 1.f / fmaxf(C[tid * nS + tid], 1e-20f);
    const float ri = -gw[tid];
    cinv[tid] = ci;
    xw[tid] = 0.f;
    rw[tid] = ri;
    dw[tid] = 0.f;
    if (rank == 0) {
      part0 += ri * (ci * ri);
      part1 += ri * ri;
    }
  }
  // every CTA's barriers are initialised before any CTA writes to them
  cluster_sync_all();

  // The second reduction: (r.z, r.r) over the block, then written into
  // every CTA's gather_b; returns once this CTA holds all of the
  // cluster's, which then sum in rank order.
  auto reduce_b = [&](unsigned parity) {
    const float v = warp_reduce2(part0, part1);
    if ((lane & 15) == 0) red_b[warp * 2 + (lane >> 4)] = v;
    __syncthreads();
    if (tid < 2 * cs) {                     // value tid & 1 to rank tid / 2
      const int k = tid & 1;
      float t = 0.f;
#pragma unroll
      for (int j = 0; j < kWarps; ++j) t += red_b[j * 2 + k];
      if (tid == 0) mbar_expect(bar_b, cs * 2 * sizeof(float));
      st_remote(gather_b + k * kMaxCluster + rank, t, bar_b, tid >> 1);
    }
    mbar_wait(bar_b, parity);
  };
  reduce_b(0);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();                          // the resident blocks are in
  float rho = gathered(gather_b, 0);
  float rr = gathered(gather_b, 1);
  const float tol2 = rtol2 * rr;
  float beta = 0.f;
  const unsigned halo_bytes = (has_prev + has_next) * P * sizeof(float);

  for (int it = 0; it < iters; ++it) {
    if (rtol2 > 0.f && !(rr > tol2)) break;   // uniform over the cluster
    const float* dold = dbuf + (it & 1) * vec_len;
    float* dn = dbuf + ((it + 1) & 1) * vec_len;

    // d = z + beta d_old; the CTA's first and last frames of d go to the
    // neighbours' halo buffers
    if (tid == 0 && halo_bytes) mbar_expect(bar_h, halo_bytes);
    for (int i = tid; i < nrows; i += kThreads) {
      const float di = fmaf(beta, dold[i], dinv[i] * r[i]);
      dn[i] = di;
      if (has_prev && i < P) st_remote(halo_next + i, di, bar_h, rank - 1);
      if (has_next && i >= nrows - P)
        st_remote(halo_prev + (i - (nrows - P)), di, bar_h, rank + 1);
    }
    if (tid < nS) dw[tid] = fmaf(beta, dw[tid], cinv[tid] * rw[tid]);
    __syncthreads();

    // q = A d, with the partial sum of
    // d.q = d_p.(q_p + B d_w) + d_w.C d_w (= d_p.q_p + d_w.q_w)
    float pdq = 0.f;
    float cv = 0.f;                         // (C d_w)[tid], tid < nS
    if (tid < nS) {
#pragma unroll
      for (int t = 0; t < (kNS > 0 ? kNS : kMaxShapes); ++t)
        if (t < nS) cv = fmaf(cs_mat[tid * nS + t], dw[t], cv);
      if (rank == 0) pdq = dw[tid] * cv;
    }
    bool halo_in = halo_bytes == 0;
    for (int i = tid; i < nrows; i += kThreads) {
      const int f = i / P;
      const int a = i - f * P;
      const bool res = f < nres;
      float u = res ? row_dot<kP>(d_res + f * pp + (size_t)a * P, dn + f * P,
                                  P, vec4)
                    : col_dot<kP>(D + f * pp + a, dn + f * P, P);
      const float tma = tm[a];
      const int g = f0 + f;                 // the frame in the window
      const bool edge = (f == 0 && has_prev) || (f + 1 == nf && has_next);
      if (edge && !halo_in) {
        mbar_wait(bar_h, it & 1);
        halo_in = true;
      }
      if (g + 1 < F) {
        const float nxt = f + 1 < nf ? dn[i + P] : halo_next[a];
        u += off[g] * (tma * nxt);
      }
      if (g > 0) {
        const float prv = f > 0 ? dn[i - P] : halo_prev[a];
        u += off[g - 1] * (tma * prv);
      }
      const float di = dn[i];
      // B d_w into q; shared and global memory as separate paths, so
      // each load has its space
      auto shape_row = [&](const float* bi) {
        float ub = 0.f;
#pragma unroll
        for (int s = 0; s < kMaxShapes; ++s)
          if (s < nS) ub = fmaf(bi[s], dw[s], ub);
        return ub;
      };
      const float ub = res ? shape_row(b_res + (size_t)i * nS)
                           : shape_row(B + (size_t)i * nS);
      u += ub;
      q[i] = u;
      pdq = fmaf(di, u + ub, pdq);
    }
    // every thread sees this step's halo phase complete, so that the
    // parity of the next one is never mistaken for it
    if (!halo_in) mbar_wait(bar_h, it & 1);
    {
      const float dq = warp_sum(pdq);
      if (lane == 0) red[warp] = dq;
    }
    // B^T d_p over this CTA's rows: warp s sums column s, lanes striding
    // over the rows in a fixed order
    if (warp < nS) {
      float t0 = 0.f, t1 = 0.f;
      const int rows_res = nres * P;
      int i = lane;
      for (; i + 32 < rows_res; i += 64) {
        t0 = fmaf(b_res[(size_t)i * nS + warp], dn[i], t0);
        t1 = fmaf(b_res[(size_t)(i + 32) * nS + warp], dn[i + 32], t1);
      }
      for (; i < rows_res; i += 32)
        t0 = fmaf(b_res[(size_t)i * nS + warp], dn[i], t0);
      for (i = rows_res + lane; i < nrows; i += 32)
        t1 = fmaf(__ldg(B + (size_t)i * nS + warp), dn[i], t1);
      const float t = warp_sum(t0 + t1);
      if (lane == 0) red[kWarps + warp] = t;
    }
    __syncthreads();
    // value j of (B^T d_0 .. B^T d_{nS-1}, d.q) to rank tid / (nS + 1),
    // where it lands in slot (j or kMaxShapes, rank)
    if (tid < (nS + 1) * cs) {
      const int j = tid % (nS + 1);
      float t = 0.f;
      if (j < nS) {
        t = red[kWarps + j];
      } else {
#pragma unroll
        for (int k = 0; k < kWarps; ++k) t += red[k];
      }
      if (tid == 0) mbar_expect(bar_a, cs * (nS + 1) * sizeof(float));
      st_remote(gather_a + (j < nS ? j : kMaxShapes) * kMaxCluster + rank, t,
                bar_a, tid / (nS + 1));
    }
    mbar_wait(bar_a, it & 1);
    const float alpha = rho / fmaxf(gathered(gather_a, kMaxShapes), 1e-30f);

    // x += alpha d, r -= alpha q; rho_n = r.z, rr = r.r
    part0 = 0.f;
    part1 = 0.f;
    for (int i = tid; i < nrows; i += kThreads) {
      x[i] = fmaf(alpha, dn[i], x[i]);
      const float ri = r[i] - alpha * q[i];
      r[i] = ri;
      part0 += ri * (dinv[i] * ri);
      part1 += ri * ri;
    }
    if (tid < nS) {
      const float qs = gathered(gather_a, tid) + cv;   // q_w
      xw[tid] = fmaf(alpha, dw[tid], xw[tid]);
      const float ri = rw[tid] - alpha * qs;
      rw[tid] = ri;
      if (rank == 0) {
        part0 += ri * (cinv[tid] * ri);
        part1 += ri * ri;
      }
    }
    reduce_b((it + 1) & 1);
    const float rho_n = gathered(gather_b, 0);
    rr = gathered(gather_b, 1);
    beta = rho_n / fmaxf(rho, 1e-30f);
    rho = rho_n;
  }

  float* dp = dp_all + ((size_t)w * F + f0) * P;
  for (int i = tid; i < nrows; i += kThreads) dp[i] = x[i];
  if (rank == 0 && tid < nS) dw_all[(size_t)w * nS + tid] = xw[tid];
  // no CTA leaves while a store to its shared memory may be in flight
  cluster_sync_all();
}

// the instantiations: the fit's P = 76 with nS = 10, P = 76 with any nS,
// any P; and any P with the vectors in global scratch
constexpr int kFitP = 76;
constexpr int kFitShapes = 10;

template <typename Kernel>
cudaError_t set_attributes(Kernel kernel, int smem_optin) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_optin);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return e;
}

cudaLaunchConfig_t cluster_config(cudaLaunchAttribute* attr, int n_blocks,
                                  int cluster, int smem_bytes,
                                  cudaStream_t stream) {
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

// The device limits the launch plan needs, read once by the wrapper:
// out[0] the opt-in shared memory per block, out[1] the largest cluster
// size in {16, 8, 4, 2, 1} of which at least one cluster can be resident
// with that much shared memory per block. Also sets the kernels'
// attributes (dynamic shared memory up to the opt-in maximum,
// non-portable cluster sizes), once for every later launch. Returns a
// CUDA error code (0 on success).
extern "C" int smpltpu_arrow_pcg_limits(int* out) {
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess)
    e = set_attributes(arrow_pcg_kernel<kFitP, kFitShapes, true>, optin);
  if (e == cudaSuccess)
    e = set_attributes(arrow_pcg_kernel<kFitP, 0, true>, optin);
  if (e == cudaSuccess) e = set_attributes(arrow_pcg_kernel<0, 0, true>, optin);
  if (e == cudaSuccess)
    e = set_attributes(arrow_pcg_kernel<0, 0, false>, optin);
  if (e != cudaSuccess) return (int)e;
  int best = 0;
  for (int c = kMaxCluster; c >= 1 && best == 0; c /= 2) {
    cudaLaunchAttribute attr[1];
    cudaLaunchConfig_t cfg = cluster_config(attr, c, c, optin, 0);
    int n = 0;
    if (cudaOccupancyMaxActiveClusters(
            &n, arrow_pcg_kernel<kFitP, kFitShapes, true>, &cfg) ==
            cudaSuccess &&
        n > 0)
      best = c;
  }
  cudaGetLastError();   // a refused cluster size leaves no sticky error
  out[0] = optin;
  out[1] = best;
  return best > 0 ? 0 : (int)cudaErrorInvalidConfiguration;
}

// Launches K1 with the plan of ops/cg.py::k1_plan on `stream`: W clusters
// of `cluster` CTAs, `smem_bytes` of dynamic shared memory each. Returns
// cudaGetLastError() (0 on success); no sync, no allocation.
extern "C" int smpltpu_arrow_pcg_f32(const float* d, const float* off,
                                     const float* tm, const float* b,
                                     const float* c, const float* gp,
                                     const float* gw, float* dp, float* dw,
                                     float* scratch, int W, int F, int P,
                                     int nS, int iters, float rtol2,
                                     int cluster, int n_res, int vec_len,
                                     int vec_in_smem, int aligned,
                                     int smem_bytes, void* stream) {
  if (W < 1 || F < 1 || P < 1 || P > kMaxP || nS < 1 || nS > kMaxShapes ||
      iters < 0 || cluster < 1 || cluster > kMaxCluster || cluster > F ||
      n_res < 0 || vec_len < (F + cluster - 1) / cluster * P ||
      smem_bytes < 0 || (!vec_in_smem && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = cluster_config(attr, W * cluster, cluster,
                                          smem_bytes, (cudaStream_t)stream);
  auto kernel = &arrow_pcg_kernel<0, 0, false>;
  if (vec_in_smem)
    kernel = P != kFitP ? &arrow_pcg_kernel<0, 0, true>
             : nS == kFitShapes ? &arrow_pcg_kernel<kFitP, kFitShapes, true>
                                : &arrow_pcg_kernel<kFitP, 0, true>;
  cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, d, off, tm, b, c, gp, gw,
                                     dp, dw, scratch, F, P, nS, iters, rtol2,
                                     n_res, vec_len, aligned);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
