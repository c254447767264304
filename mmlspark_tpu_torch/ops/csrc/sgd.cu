// VowpalWabbit's minibatch SGD for Hopper (sm_90a), behind a plain C
// interface that mmlspark_tpu_torch/ops/sgd.py loads with ctypes.
//
// Replaces no Pallas kernel: the JAX package compiles the minibatch body of
// mmlspark_tpu/vw/learner.py::_shard_train (a lax.scan of sparse gathers and
// scatter-adds) with XLA. Here one launch of vw_pass runs a whole pass:
//
//   vw_pass   one CTA of up to 1,024 threads walks the nb minibatches in
//             order. A minibatch is the grad phase, __syncthreads(), the
//             apply phase, __syncthreads(): the barrier makes the CTA's
//             writes to w and g2 visible to the whole block, so minibatch
//             b + 1 gathers the weights that b wrote, with no atomics and
//             no grid barrier. (The minibatches form a chain of ~20k
//             gathers each; a grid-wide barrier costs more than that.)
//             From 256 rows a minibatch, one SM's gathers would set the
//             pace: a cluster of up to 8 CTAs on neighbouring SMs shares
//             the grad phase, each CTA's gradients go to CTA 0 in one bulk
//             copy (shared::cta -> shared::cluster, completing on CTA 0's
//             mbarrier), CTA 0 applies, and one cluster barrier a minibatch
//             orders its writes before the next gathers.
//   grad      <- learner.py:120-123. First every thread gathers weights for
//                its rows' slots in flat (row-major) order, so neighbouring
//                threads read neighbouring indices; then one thread a row:
//                margin = serial FMA chain over the row's K slots,
//                m = fma(w[i_k], v_k, m); dl = dloss(m, y) * weight;
//                g_k = fma(dl, v_k, (l2 * w[i_k]) * (v_k != 0)).
//   apply     <- learner.py:124-134: the runs of equal indices of the
//                minibatch (ops/sgd.py::sgd_plan). Adaptive: g2[i] += g*g
//                over the run in (row, k) order, then denom = sqrt(g2[i]) +
//                eps once, then w[i] += (-lr * g) / denom over the run in the
//                same order. Otherwise w[i] += (-step) * g, step from a table
//                built on the host (powf is not correctly rounded on the
//                card). A run shorter than the plan's long_run is one
//                thread's; a long run (the Constant slot's, one entry a row)
//                is one warp's: the lanes form the products and quotients of
//                128 entries at a time into shared memory, and every lane
//                runs the same serial __fadd_rn chain through them, the next
//                window's terms formed while the chain runs. Short runs go to
//                the warps on the other schedulers, so none takes issue slots
//                from a chain.
//   vw_margin <- learner.py:337-346: scoring, the same FMA chain a row, in
//             its own persistent kernel that gathers panels of rows into
//             shared memory (vw_margin_kernel, below).
//
// Shared memory. The minibatch's g lives in shared memory where it fits in
// the 227 KB a block may opt in to, then the plan's slices of the minibatch
// (order, run_start, run_index) where they fit in what is left
// (ops/sgd.py::pass_layout decides from the shapes, the cluster too). The
// slices of minibatch b are copied in by cp.async.bulk (TMA, completing on
// an mbarrier) while b's gradients are formed. One kernel instance per
// placement, so every load is LDS or LDG, none generic. The rows are read
// where they lie: staging them too cost more than it saved (PERF.md).
//
// Bits. XLA:CPU rounds at exactly these points and applies its scatter-adds
// serially in (row, k) order; every float operation here is an explicit
// round-to-nearest intrinsic, so nvcc contracts nothing, and each run's two
// chains start from the stored value and keep their order; only products
// and quotients are formed in parallel. So every launch gives the same bits,
// whatever the block size or placement, equal to the plain PyTorch version
// on the CPU and to the JAX package for the squared, quantile and hinge
// losses. Logistic and poisson call expf, which rounds differently from
// XLA's exp. Slots whose value is 0 (the padding) are in no run: for finite
// values they add exactly +-0 to g2 and w.
//
// Bound. A pass must read the rows' idx, val, y and weight once (8 K + 8
// bytes a row) and the plan once, and read and write each weight it touches
// with its AdaGrad sum: at V2's 100,352 rows x 17 slots ~21 MB, ~6 us at
// 3.35 TB/s. No design that keeps the bits beats the longest run's two
// dependent fadd chains: at batch 1,024 the Constant run is 2 x 1,024 fadds
// a minibatch, ~4 us at 4 cycles and ~2 GHz, ~0.4 ms a pass of 98
// minibatches. What sets the time on the card instead is the chain at about
// twice its floor, the gathers, and at small minibatches the memory round
// trips each one waits on (PERF.md).
//
// The stand-alone entries (vw_grad_step, vw_apply_step in ops/sgd.py) launch
// this same kernel on one minibatch with one phase: the grad phase copies its
// g out of shared memory at the end, the apply phase copies g in first.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kGrad = 1, kApply = 2;  // phases
// Long runs go to the first kLongWarps warps (two on each of the SM's four
// schedulers). Shared memory: two mbarriers at 0, then two windows of kWindow
// floats for each of those warps from kWindowOff, then what
// ops/sgd.py::pass_layout places (its SMEM_FIXED is kWindowOff + kLongWarps *
// 2 * kWindow * 4).
constexpr int kLongWarps = 8;
constexpr int kWindowOff = 16;
constexpr int kWindow = 128;

enum Loss { kLogistic = 0, kSquared = 1, kQuantile = 2, kHinge = 3, kPoisson = 4 };

__device__ __forceinline__ float dloss(int loss, float m, float y, float tau_hi,
                                       float tau_lo) {
  switch (loss) {
    case kLogistic: {
      // -y * sigmoid(-y * m), sigmoid(z) = 1 / (1 + exp(-z))
      const float z = __fmul_rn(-y, m);
      const float s = __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-z)));
      return __fmul_rn(-y, s);
    }
    case kSquared:
      return __fsub_rn(m, y);
    case kQuantile:
      return m >= y ? tau_hi : tau_lo;
    case kHinge:
      return __fmul_rn(y, m) < 1.0f ? -y : 0.0f;
    default:  // kPoisson: exp(clip(m, -30, 30)) - y
      return __fsub_rn(expf(fminf(fmaxf(m, -30.0f), 30.0f)), y);
  }
}

// -- asynchronous copies into shared memory ----------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void bulk_g2s(void* dst, const void* src, uint32_t bytes,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// A copy moves the 16-byte aligned window around its source: from src rounded
// down to src + bytes rounded up. The source lies in a PyTorch allocation,
// whose blocks are 512-byte aligned multiples of 512 bytes, so the window
// stays inside it; the data land shift_of(src) bytes into dst, which is
// 16-byte aligned with kSlack bytes of room past bytes.
constexpr uint32_t kSlack = 16;

__device__ __forceinline__ uint32_t shift_of(const void* src) {
  return static_cast<uint32_t>(reinterpret_cast<uintptr_t>(src) & 15u);
}

template <class T>
__device__ __forceinline__ T* landed(void* dst, const void* src) {
  return reinterpret_cast<T*>(static_cast<unsigned char*>(dst) + shift_of(src));
}

// Starts the copy of bytes from src (4-byte aligned) into dst as one bulk
// copy issued by thread 0, on the mbarrier. Returns whether it was armed
// (uniform across the block). The caller has passed a barrier since dst was
// last read, which orders those reads before the copy's writes.
__device__ bool stage_start(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  if (!bytes) return false;
  const uintptr_t lo = reinterpret_cast<uintptr_t>(src) & ~uintptr_t(15);
  const uintptr_t hi = (reinterpret_cast<uintptr_t>(src) + bytes + 15) & ~uintptr_t(15);
  if (threadIdx.x == 0) {
    mbar_expect(bar, static_cast<uint32_t>(hi - lo));
    bulk_g2s(dst, reinterpret_cast<const void*>(lo), static_cast<uint32_t>(hi - lo), bar);
  }
  return true;
}

// Waits for the copy of the last stage_start (each thread; a barrier after
// it lets every thread read it).
__device__ void stage_wait(bool armed, uint64_t* bar, uint32_t& parity) {
  if (armed) {
    mbar_wait(bar, parity);
    parity ^= 1u;
  }
}

// -- the pass kernel -----------------------------------------------------------

// Built with -DVW_PROFILE (tools/vw_torch_profile.py does), block 0 stamps
// the SM's clock at kProfMarks points of each of the first kProfMinibatches
// minibatches: 0 the top, 1 its grad phase begins (the plan's copies
// issued), 2 the gathers done (past the block barrier), 3 thread 0's rows
// done, 4 every block's gradients in (past the barrier), 5 thread 0's apply
// done (warp 0 holds the first long run), 6 the last thread's apply done
// (short runs), 7 the minibatch's end.
#ifdef VW_PROFILE
constexpr int kProfMinibatches = 4096, kProfMarks = 8;
__device__ long long vw_prof[kProfMinibatches][kProfMarks];
#define VW_MARK(b, slot, who)                                                   \
  if (blockIdx.x == 0 && (int)threadIdx.x == (who) && (b) < kProfMinibatches) { \
    long long t_;                                                               \
    asm volatile("mov.u64 %0, %%clock64;" : "=l"(t_)::"memory");                \
    vw_prof[b][slot] = t_;                                                      \
  }
#else
#define VW_MARK(b, slot, who)
#endif

struct PassArgs {
  const int32_t* idx;        // (nb * batch, k)
  const float* val;          // (nb * batch, k)
  const float* y;            // (nb * batch,)
  const float* wt;           // (nb * batch,)
  float* w;                  // (D,), updated in place
  float* g2;                 // (D,), updated in place
  float* g_global;           // batch * k: scratch, or the stand-alone g
  const int32_t* packed;     // plan: each minibatch's order, run_start and run_index
                             // slices back to back (ops/sgd.py::sgd_plan)
  const int32_t* meta;       // plan: (nb + 1) x 4 (16-byte rows): first run, first entry,
                             // first long run, start in packed
  const int32_t* long_runs;  // plan: the run ids of the long runs
  const float* steps;        // nb step sizes (non-adaptive)
  int nb, batch, k, loss;
  float tau_hi, tau_lo, neg_lr, l2, eps;
  int adaptive, phases, long_run;
  int g_off, plan_off;           // byte offsets in shared memory; -1 = not there
  int ctas;                      // the cluster's blocks (1: one block, no cluster)
};

// The plan of minibatch b as the apply phase reads it: run r in [r0, r1)
// spans order entries [rs(r), rs(r + 1)) (absolute offsets).
struct Plan {
  const int32_t* order;      // entry e at order[e - e_off]
  const int32_t* run_start;  // run r at run_start[r - r_off]
  const int32_t* run_index;  // run r at run_index[r - r_off]
  int e_off, r_off, r0, r1, l0, l1;
};

__device__ __forceinline__ int align16(int x) { return (x + 15) & ~15; }

// The grad phase of rows [r0, r1) of the minibatch, in two steps with a
// block barrier between. First every thread gathers weights for those rows'
// slots in flat order (row-major, so neighbouring threads read neighbouring
// indices), each load independent of the others, into g. Then one thread a
// row: the margin as the serial FMA chain over its slots (weights from g),
// the loss's derivative, and each slot's gradient, written over its weight.
// In a cluster the weights are read from L2 (ld.global.cg): block 0 writes
// them, and another SM's L1 may hold an older line.
template <bool kCluster>
__device__ __forceinline__ void grad_phase(const PassArgs& a, int b, int r0, int r1,
                                           const int32_t* idx, const float* val,
                                           const float* y, const float* wt, float* g) {
#pragma unroll 4
  for (int q = r0 * a.k + threadIdx.x; q < r1 * a.k; q += blockDim.x)
    g[q] = kCluster ? __ldcg(a.w + idx[q]) : a.w[idx[q]];
  __syncthreads();
  VW_MARK(b, 2, 0);
  for (int r = r0 + threadIdx.x; r < r1; r += blockDim.x) {
    const float* rv = val + (int64_t)r * a.k;
    float* rg = g + (int64_t)r * a.k;
    const float yr = y[r], wr = wt[r];
    float m = 0.0f;
#pragma unroll 4
    for (int j = 0; j < a.k; ++j) m = __fmaf_rn(rg[j], rv[j], m);
    const float dl = __fmul_rn(dloss(a.loss, m, yr, a.tau_hi, a.tau_lo), wr);
#pragma unroll 4
    for (int j = 0; j < a.k; ++j) {
      const float vj = rv[j];
      const float decay = __fmul_rn(__fmul_rn(a.l2, rg[j]), vj != 0.0f ? 1.0f : 0.0f);
      rg[j] = __fmaf_rn(dl, vj, decay);
    }
  }
}

// A short run on one thread: both chains walked serially by one thread.
__device__ __forceinline__ void apply_short(const PassArgs& a, const Plan& p, const float* g,
                                            float neg_step, int r, int s, int e) {
  const int32_t i = p.run_index[r - p.r_off];
  const int32_t* ord = p.order;
  const int eo = p.e_off;
  float wi = a.w[i];
  if (a.adaptive) {
    float acc = a.g2[i];
    for (int j = s; j < e; ++j) {
      const float gj = g[ord[j - eo]];
      acc = __fadd_rn(acc, __fmul_rn(gj, gj));
    }
    a.g2[i] = acc;
    const float denom = __fadd_rn(__fsqrt_rn(acc), a.eps);
    for (int j = s; j < e; ++j)
      wi = __fadd_rn(wi, __fdiv_rn(__fmul_rn(a.neg_lr, g[ord[j - eo]]), denom));
  } else {
    for (int j = s; j < e; ++j) wi = __fadd_rn(wi, __fmul_rn(neg_step, g[ord[j - eo]]));
  }
  a.w[i] = wi;
}

// acc += buf[0] + buf[1] + ... + buf[31], serially: the 32 values come in as
// eight 16-byte broadcasts from shared memory, so the adds wait on each other
// and on nothing else.
__device__ __forceinline__ float chain32(float acc, const float* buf) {
  const float4* b4 = reinterpret_cast<const float4*>(buf);
  float4 v[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) v[q] = b4[q];
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    acc = __fadd_rn(acc, v[q].x);
    acc = __fadd_rn(acc, v[q].y);
    acc = __fadd_rn(acc, v[q].z);
    acc = __fadd_rn(acc, v[q].w);
  }
  return acc;
}

// acc += x(s) + x(s + 1) + ... + x(e - 1), serially and in order, on one warp,
// kWindow terms at a time through two windows of shared memory (buf): while
// the chain runs through one window, the lanes form the next window's terms
// (their loads all in flight at once) in the same straight-line code, which
// the scheduler slots between the dependent adds; every lane keeps the same
// chain.
template <class Term>
__device__ __forceinline__ float warp_chain(float acc, int s, int e, float* buf, Term x) {
  constexpr int kPer = kWindow / kWarp;
  const int lane = threadIdx.x & (kWarp - 1);
  float t[kPer];
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const int j = s + q * kWarp + lane;
    t[q] = j < e ? x(j) : 0.0f;
  }
#pragma unroll
  for (int q = 0; q < kPer; ++q) buf[q * kWarp + lane] = t[q];
  __syncwarp();
  int cur = 0;
  for (int c = s; c < e; c += kWindow) {
    const float* now = buf + cur * kWindow;
    if (e - c >= kWindow) {
      const int cn = c + kWindow;
#pragma unroll
      for (int q = 0; q < kPer; ++q) {
        const int j = cn + q * kWarp + lane;
        t[q] = j < e ? x(j) : 0.0f;
      }
#pragma unroll
      for (int l = 0; l < kWindow; l += kWarp) acc = chain32(acc, now + l);
      float* next = buf + (cur ^ 1) * kWindow;
#pragma unroll
      for (int q = 0; q < kPer; ++q) next[q * kWarp + lane] = t[q];
    } else {  // the last window, partial
      int l = 0;
      for (; l + kWarp <= e - c; l += kWarp) acc = chain32(acc, now + l);
      for (; l < e - c; ++l) acc = __fadd_rn(acc, now[l]);
    }
    __syncwarp();
    cur ^= 1;
  }
  return acc;
}

// A long run on one warp: the products and quotients in parallel, the two
// chains serial and in order. buf: this warp's two windows of shared memory.
__device__ __forceinline__ void apply_long(const PassArgs& a, const Plan& p, const float* g,
                                           float neg_step, int r, float* buf) {
  const int lane = threadIdx.x & (kWarp - 1);
  const int s = p.run_start[r - p.r_off], e = p.run_start[r + 1 - p.r_off];
  const int32_t i = p.run_index[r - p.r_off];
  const int32_t* ord = p.order;
  const int eo = p.e_off;
  float wi = a.w[i];
  if (a.adaptive) {
    const float acc = warp_chain(a.g2[i], s, e, buf, [&](int j) {
      const float gj = g[ord[j - eo]];
      return __fmul_rn(gj, gj);
    });
    if (lane == 0) a.g2[i] = acc;
    const float denom = __fadd_rn(__fsqrt_rn(acc), a.eps);
    const float neg_lr = a.neg_lr;
    wi = warp_chain(wi, s, e, buf, [&](int j) {
      return __fdiv_rn(__fmul_rn(neg_lr, g[ord[j - eo]]), denom);
    });
  } else {
    wi = warp_chain(wi, s, e, buf, [&](int j) { return __fmul_rn(neg_step, g[ord[j - eo]]); });
  }
  if (lane == 0) a.w[i] = wi;
}

__device__ __forceinline__ void apply_phase(const PassArgs& a, const Plan& p, const float* g,
                                            int b, float* windows) {
  const float neg_step = a.adaptive ? 0.0f : -a.steps[b];
  const int warps = blockDim.x / kWarp, warp = threadIdx.x / kWarp;
  const int long_warps = min(kLongWarps, warps);
  if (warp < long_warps)
    for (int q = p.l0 + warp; q < p.l1; q += long_warps)
      apply_long(a, p, g, neg_step, a.long_runs[q], windows + warp * 2 * kWindow);
  // short runs: one thread each, on the warps that hold no long run; while
  // fewer than four warps hold one, not on the warps that share their
  // schedulers (warp % 4), so no other warp takes issue slots from a chain
  const int busy = min(p.l1 - p.l0, long_warps);
  const int quiet = busy < 4 && warps > 4 ? busy : 0;  // schedulers 0 .. quiet - 1
  int rank = warp - busy, count = warps - busy;          // this warp's place among them
  if (quiet) {
    rank = (warp >> 2) * (4 - quiet) + max((warp & 3) - quiet, 0);
    count = (warps >> 2) * (4 - quiet) + max((warps & 3) - quiet, 0);
  }
  if (count == 0) {  // every warp holds a long run: all take short runs after
    rank = warp;
    count = warps;
  } else if (quiet ? (warp & 3) < quiet : warp < busy) {
    return;
  }
  for (int r = p.r0 + rank * kWarp + (threadIdx.x & (kWarp - 1)); r < p.r1;
       r += count * kWarp) {
    const int s = p.run_start[r - p.r_off], e = p.run_start[r + 1 - p.r_off];
    if (e - s < a.long_run) apply_short(a, p, g, neg_step, r, s, e);
  }
}

__device__ __forceinline__ uint32_t cluster_addr(const void* local, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(out) : "r"(smem_addr(local)), "r"(rank));
  return out;
}

// One instance per placement (g, the plan slices in shared memory or not), so
// every load compiles to the instruction of its memory: LDS for shared
// memory, LDG for device memory, no generic loads.
// kCluster: a cluster of a.ctas blocks (g in shared memory), each forming
// the gradients of its share of the rows in its own g and copying them
// into block 0's g in one bulk copy that completes on block 0's second
// mbarrier; block 0 applies them, and one cluster barrier a minibatch
// orders its writes to w and g2 before the next gathers.
template <bool kGShared, bool kPlanShared, bool kCluster>
__global__ void __launch_bounds__(kMaxThreads, 1) vw_pass_kernel(const PassArgs a) {
  namespace cg = cooperative_groups;
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  uint64_t* gbar = bar + 1;  // block 0's: the other blocks' gradients have landed
  float* windows = reinterpret_cast<float*>(smem + kWindowOff);
  const int rows_k = a.batch * a.k;
  const int rank = kCluster ? (int)cg::this_cluster().block_rank() : 0;
  const bool grad = a.phases & kGrad, apply = (a.phases & kApply) && rank == 0;
  float* g = kGShared ? reinterpret_cast<float*>(smem + a.g_off) : a.g_global;
  // a block's share of the rows, a multiple of 4 so each share of g starts
  // and (but for the last) ends on a 16-byte boundary
  const int share = ((a.batch + a.ctas - 1) / a.ctas + 3) & ~3;
  const int row0 = min(a.batch, rank * share), row1 = min(a.batch, row0 + share);
  auto sync = [&] {
    if constexpr (kCluster)
      cg::this_cluster().sync();
    else
      __syncthreads();
  };
  // the plan's staging buffer: a minibatch's packed slices
  unsigned char* s_plan = smem + (kPlanShared ? a.plan_off : 0);
  if (threadIdx.x == 0) {
    mbar_init(bar);
    mbar_init(gbar);
  }
  sync();  // (in a cluster: every block has started before any copies into block 0)
  uint32_t parity = 0, gparity = 0;
  // the bytes block 0 receives from the others each minibatch (each share
  // rounded up to 16 bytes, inside g's 16-byte aligned room)
  const uint32_t remote = (uint32_t)align16(rows_k * 4) - (uint32_t)min(share, a.batch) * a.k * 4;

  if (!grad && kGShared && rank == 0) {  // the stand-alone apply: its g comes in first
    stage_wait(stage_start(g, a.g_global, (uint32_t)rows_k * 4, bar), bar, parity);
    __syncthreads();
  }
  // minibatch b's first run, entry and long run, and the next one's, read a
  // minibatch ahead so the staging of its plan slices waits on no load
  int4 m0 = make_int4(0, 0, 0, 0), m1 = m0;
  if (apply) {
    m0 = reinterpret_cast<const int4*>(a.meta)[0];
    m1 = reinterpret_cast<const int4*>(a.meta)[1];
  }

  for (int b = 0; b < a.nb; ++b) {
    VW_MARK(b, 0, 0);
    int4 m2 = m1;  // (first used at the bottom of the loop: its load waits there, if at all)
    if (apply && b + 2 <= a.nb) m2 = reinterpret_cast<const int4*>(a.meta)[b + 2];
    // this minibatch's plan, where it lies (one memory per instance, so its
    // loads compile to that memory's instruction)
    const int32_t* src = a.packed + m0.w;
    bool plan_armed = false;
    if (apply && kPlanShared)
      plan_armed = stage_start(s_plan, src, (uint32_t)(m1.w - m0.w) * 4, bar);
    const int32_t* slices = kPlanShared ? landed<const int32_t>(s_plan, src) : src;
    const int32_t* run_start = slices + (m1.y - m0.y);
    const Plan p{slices, run_start, run_start + (m1.x - m0.x + 1), m0.y, m0.x, m0.x, m1.x,
                 m0.z, m1.z};
    if (kCluster && rank == 0 && grad && threadIdx.x == 0) mbar_expect(gbar, remote);
    if (grad) {
      const int64_t r0 = (int64_t)b * a.batch;
      VW_MARK(b, 1, 0);
      grad_phase<kCluster>(a, b, row0, row1, a.idx + r0 * a.k, a.val + r0 * a.k, a.y + r0,
                           a.wt + r0, g);
    }
    VW_MARK(b, 3, 0);
    if (kCluster && grad) {
      if (rank == 0) {
        mbar_wait(gbar, gparity);
        gparity ^= 1u;
      } else if (row1 > row0) {
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // this thread's g
        __syncthreads();
        if (threadIdx.x == 0) {
          const uint32_t off = (uint32_t)row0 * a.k * 4;
          const uint32_t bytes = (uint32_t)align16((row1 - row0) * a.k * 4);
          asm volatile(
              "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes"
              " [%0], [%1], %2, [%3];"
              ::"r"(cluster_addr(reinterpret_cast<unsigned char*>(g) + off, 0)),
                "r"(smem_addr(reinterpret_cast<unsigned char*>(g) + off)), "r"(bytes),
                "r"(cluster_addr(gbar, 0))
              : "memory");
        }
      }
    }
    if (apply && kPlanShared) stage_wait(plan_armed, bar, parity);
    __syncthreads();
    VW_MARK(b, 4, 0);
    if (apply) {
      apply_phase(a, p, g, b, windows);
    } else if (kGShared && rank == 0 && !(a.phases & kApply)) {  // the stand-alone grad
      for (int j = threadIdx.x; j < rows_k; j += blockDim.x) a.g_global[j] = g[j];
    }
    VW_MARK(b, 5, 0);
    VW_MARK(b, 6, (int)blockDim.x - 1);
    sync();
    VW_MARK(b, 7, 0);
    m0 = m1;
    m1 = m2;
  }
}

using PassKernel = void (*)(PassArgs);

// -- the scoring kernel ------------------------------------------------------------

// Built with -DVW_PROFILE, block 0's thread 0 stamps the SM's clock at
// kMProfMarks points of each of its first kMProfPanels panels: 0 the top, 1
// its own gathered weights stored (their loads were issued a panel ahead),
// 2 every thread's stored (past the barrier), 3 the chains done (past the
// barrier).
#ifdef VW_PROFILE
constexpr int kMProfPanels = 4096, kMProfMarks = 4;
__device__ long long vw_mprof[kMProfPanels][kMProfMarks];
#define VW_MMARK(p, slot)                                              \
  if (blockIdx.x == 0 && threadIdx.x == 0 && (p) < kMProfPanels) {     \
    long long t_;                                                      \
    asm volatile("mov.u64 %0, %%clock64;" : "=l"(t_)::"memory");       \
    vw_mprof[p][slot] = t_;                                            \
  }
#else
#define VW_MMARK(p, slot)
#endif

constexpr int kMarginMaxThreads = 512;
constexpr int kMarginPer = 16;  // slots a thread brings in for each panel

struct MarginArgs {
  const int32_t* idx;  // (n, k)
  const float* val;    // (n, k)
  const float* w;      // (D,)
  float* out;          // (n,)
  int64_t n;
  int k;
  int64_t rows;        // rows a block: block b takes rows [b rows, (b + 1) rows)
  int panel_rows;      // R: rows a panel
  int chunk;           // C: slots a panel takes of each of its rows (a K chunk)
  int stride;          // R rounded up to odd: the rows of a slot in W and V in shared memory
  int direct;          // 1: each thread walks its own rows' slots (no panels)
};

// vw_margin <- learner.py:337-346. out[r] = m, m = fma(w[idx[r, j]],
// val[r, j], m) over j = 0 .. k - 1 from +0.0, serially.
//
// Persistent: block b takes a.rows consecutive rows. Where those hold no
// more than a panel's slots (a.direct: 20,000 x 17 on 132 SMs), each thread
// walks its own rows' slots where they lie, a row a thread: a DRAM
// round trip then the gathers', with nothing to overlap, so panels only add
// a barrier and a trip through shared memory. Else it walks them in panels
// of R rows x C slots, chunk after chunk of K, group of R rows after group
// (ops/sgd.py::margin_layout picks the path, R, C and the grid). A panel:
//   loads    thread t brings in the panel's slots t, t + T, ... (kMarginPer
//            of them, T threads; flat over R x C, slot fastest: neighbouring
//            threads read neighbouring slots of a row) from device memory
//            into registers, by ld.global.cg (L2 only, so the rows stream
//            past the L1 cache, which keeps the weights), one panel ahead:
//            while panel p is gathered and chained, panel p + 1's rows are
//            in flight;
//   gathers  the thread gathers w at its kMarginPer indices, all loads in
//            flight at once (index 0, the padding's, from a register), and
//            stores each weight and its value in shared memory as
//            W[slot][row], V[slot][row] (rows an odd number apart: no bank
//            conflicts);
//   chains   one thread a row (R <= T where K is chunked): the serial fma
//            chain over the panel's C slots of its row, reading W[j][r] and
//            V[j][r] with the lanes on neighbouring words, the next 8 slots'
//            loads in flight while 8 fmas run; the running
//            margin stays in the thread's register from chunk to chunk, so
//            the order, and the bits, are the one-row chain's.
// The rows' indices and values are read once, coalesced; the gathers hit
// the L1 and L2 caches (2^18 weights are 1 MB). Bound: each input read once
// (8 bytes a slot, 4 a weight touched) at the card's memory rate. What sets
// the time instead is the gathers: a warp's 32 loads of w touch up to 32 L1
// lines, each one a wavefront of the L1's pipe (PERF.md).
__global__ void __launch_bounds__(kMarginMaxThreads) vw_margin_kernel(const MarginArgs a) {
  extern __shared__ __align__(16) float msm[];
  const int R = a.panel_rows, C = a.chunk, T = blockDim.x, S = a.stride;
  float* W = msm;          // the weight of slot j, row r at W[j S + r]
  float* V = msm + C * S;  // its value at V[j S + r]
  const int64_t r_lo = (int64_t)blockIdx.x * a.rows;
  if (r_lo >= a.n) return;  // (the whole block)
  const int nrows = (int)(a.n - r_lo < a.rows ? a.n - r_lo : a.rows);
  if (a.direct) {  // a block of a few rows: a thread a row, its slots read where they lie
    for (int r = threadIdx.x; r < nrows; r += T) {
      const int32_t* ri = a.idx + (r_lo + r) * a.k;
      const float* rv = a.val + (r_lo + r) * a.k;
      float mm = 0.0f;
      for (int j = 0; j < a.k; ++j) mm = __fmaf_rn(__ldg(a.w + ri[j]), rv[j], mm);
      a.out[r_lo + r] = mm;
    }
    return;
  }
  const int groups = (nrows + R - 1) / R, chunks = (a.k + C - 1) / C;
  const int panels = groups * chunks;
  const float w0 = __ldg(a.w);  // index 0 (the padding's): one load, not one a slot

  // this thread's slots of a panel, as (row, slot) pairs (-1: none)
  int rj[kMarginPer];
  {
    int r = threadIdx.x / C;
    int j = threadIdx.x - r * C;
    const int dr = T / C, dj = T - dr * C;
#pragma unroll
    for (int i = 0; i < kMarginPer; ++i) {
      rj[i] = r < R ? (r << 16) | j : -1;  // (R < 2^15, C < 2^16)
      r += dr;
      j += dj;
      if (j >= C) {
        j -= C;
        ++r;
      }
    }
  }
  int32_t ix[kMarginPer];
  float vx[kMarginPer];
  // brings panel p's slots into ix and vx (indices 0 and values 0 where the
  // thread has no slot: the last group's missing rows, the last chunk's)
  auto load = [&](int p) {
    const int g = p / chunks, c = p - g * chunks;
    const int rg = min(R, nrows - g * R), cc = min(C, a.k - c * C);
    const int64_t base = (r_lo + (int64_t)g * R) * a.k + (int64_t)c * C;
    const int32_t* pi = a.idx + base;
    const float* pv = a.val + base;
#pragma unroll
    for (int i = 0; i < kMarginPer; ++i) {
      const bool ok = p < panels && rj[i] >= 0 && (rj[i] >> 16) < rg && (rj[i] & 0xffff) < cc;
      const int at = (rj[i] >> 16) * a.k + (rj[i] & 0xffff);  // (rows k < 2^31)
      ix[i] = ok ? __ldcg(pi + at) : 0;
      vx[i] = ok ? __ldcg(pv + at) : 0.0f;
    }
  };
  load(0);

  float m = 0.0f;  // this thread's row's running margin, carried from chunk to chunk
  for (int p = 0; p < panels; ++p) {
    VW_MMARK(p, 0);
    const int g = p / chunks, c = p - g * chunks;
    const int rg = min(R, nrows - g * R), cc = min(C, a.k - c * C);
    float ww[kMarginPer];
#pragma unroll
    for (int i = 0; i < kMarginPer; ++i) ww[i] = ix[i] ? __ldg(a.w + ix[i]) : w0;
#pragma unroll
    for (int i = 0; i < kMarginPer; ++i)
      if (rj[i] >= 0 && (rj[i] >> 16) < rg && (rj[i] & 0xffff) < cc)
        V[(rj[i] & 0xffff) * S + (rj[i] >> 16)] = vx[i];
    load(p + 1);
#pragma unroll
    for (int i = 0; i < kMarginPer; ++i)
      if (rj[i] >= 0 && (rj[i] >> 16) < rg && (rj[i] & 0xffff) < cc)
        W[(rj[i] & 0xffff) * S + (rj[i] >> 16)] = ww[i];
    VW_MMARK(p, 1);
    __syncthreads();
    VW_MMARK(p, 2);
    for (int r = threadIdx.x; r < rg; r += T) {
      float mm = c == 0 ? 0.0f : m;
      const float* wr = W + r;
      const float* vr = V + r;
      int j = 0;
      if (cc >= 8) {  // the next 8 slots' loads in flight while 8 fmas run
        float x[8], y[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          x[u] = wr[u * S];
          y[u] = vr[u * S];
        }
        for (j = 8; j + 8 <= cc; j += 8) {
          float xn[8], yn[8];
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            xn[u] = wr[(j + u) * S];
            yn[u] = vr[(j + u) * S];
          }
#pragma unroll
          for (int u = 0; u < 8; ++u) mm = __fmaf_rn(x[u], y[u], mm);
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            x[u] = xn[u];
            y[u] = yn[u];
          }
        }
#pragma unroll
        for (int u = 0; u < 8; ++u) mm = __fmaf_rn(x[u], y[u], mm);
      }
      for (; j < cc; ++j) mm = __fmaf_rn(wr[j * S], vr[j * S], mm);
      if (c == chunks - 1)
        a.out[r_lo + (int64_t)g * R + r] = mm;
      else
        m = mm;
    }
    __syncthreads();
    VW_MMARK(p, 3);
  }
}

}  // namespace

extern "C" {

// One launch: nb minibatches of `batch` rows, k slots each, `phases` of each
// (1 grad, 2 apply, 3 both). idx, val: (nb * batch, k); y, wt: (nb *
// batch,); w, g2 updated in place; g_global: batch * k floats (the scratch
// where g is not in shared memory; the stand-alone grad's output, the
// stand-alone apply's input). packed, meta, long_runs: the plan
// (ops/sgd.py::sgd_plan); steps: nb step sizes (null when adaptive).
// threads, the shared-memory offsets (-1 = not staged), ctas (the cluster's
// blocks) and smem_bytes come from ops/sgd.py::pass_layout. Returns the
// launch's CUDA error (0 = accepted).
int mmlspark_vw_pass(const int32_t* idx, const float* val, const float* y, const float* wt,
                     float* w, float* g2, float* g_global, const int32_t* packed,
                     const int32_t* meta, const int32_t* long_runs, const float* steps,
                     int nb, int batch, int k, int loss, float tau_hi, float tau_lo,
                     float neg_lr, float l2, float eps, int adaptive, int phases,
                     int long_run, int threads, int g_off, int plan_off, int ctas,
                     int smem_bytes, void* stream) {
  if (nb == 0) return 0;
  if (threads < kWarp || threads > kMaxThreads || threads % kWarp || ctas < 1 || ctas > 8 ||
      (ctas > 1 && g_off < 0))
    return (int)cudaErrorInvalidValue;
  // indexed by (g shared) * 2 + (plan shared), then the cluster's (g shared)
  static const PassKernel kernels[6] = {
      vw_pass_kernel<false, false, false>, vw_pass_kernel<false, true, false>,
      vw_pass_kernel<true, false, false>,  vw_pass_kernel<true, true, false>,
      vw_pass_kernel<true, false, true>,   vw_pass_kernel<true, true, true>};
  const int which = (ctas > 1 ? 4 : (g_off >= 0) * 2) + (plan_off >= 0);
  const PassKernel kernel = kernels[which];
  static int opted[6] = {};  // the dynamic shared memory each instance opted in to
  if (smem_bytes > opted[which]) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return (int)err;
    opted[which] = smem_bytes;
  }
  const PassArgs a{idx, val, y, wt, w, g2, g_global, packed, meta, long_runs, steps, nb,
                   batch, k, loss, tau_hi, tau_lo, neg_lr, l2, eps, adaptive, phases,
                   long_run, g_off, plan_off, ctas};
  if (ctas == 1) {
    kernel<<<1, threads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(a);
    return (int)cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ctas;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, a);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

#ifdef VW_PROFILE
// The SM cycles of n dependent __fadd_rn on one thread (the chain floor's
// unit), written to out[0].
__global__ void vw_fadd_cycles(float x, int n, long long* out) {
  float acc = x;
  long long t0, t1;
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(t0)::"memory");
  for (int j = 0; j < n; j += 8) {
#pragma unroll
    for (int u = 0; u < 8; ++u) acc = __fadd_rn(acc, x);
  }
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(t1)::"memory");
  out[0] = t1 - t0;
  out[1] = __float_as_int(acc);  // keeps the chain
}

int mmlspark_vw_fadd_cycles(int n, long long* out) {
  vw_fadd_cycles<<<1, 1>>>(1.0f, n, out);
  return (int)cudaDeviceSynchronize();
}

// Copies the clock stamps of the last pass (n minibatches x kProfMarks) to the host.
int mmlspark_vw_prof_read(long long* host, int n) {
  return (int)cudaMemcpyFromSymbol(host, vw_prof, sizeof(long long) * kProfMarks * n);
}

// The SM cycles of n dependent __fmaf_rn on one thread (the scoring chain's
// unit), written to out[0].
__global__ void vw_fma_cycles(float x, float y, int n, long long* out) {
  float acc = x;
  long long t0, t1;
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(t0)::"memory");
  for (int j = 0; j < n; j += 8) {
#pragma unroll
    for (int u = 0; u < 8; ++u) acc = __fmaf_rn(x, y, acc);
  }
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(t1)::"memory");
  out[0] = t1 - t0;
  out[1] = __float_as_int(acc);  // keeps the chain
}

int mmlspark_vw_fma_cycles(int n, long long* out) {
  vw_fma_cycles<<<1, 1>>>(1.0f, 0.5f, n, out);
  return (int)cudaDeviceSynchronize();
}

// Copies the clock stamps of the last scoring launch (block 0's first n
// panels x kMProfMarks) to the host.
int mmlspark_vw_mprof_read(long long* host, int n) {
  return (int)cudaMemcpyFromSymbol(host, vw_mprof, sizeof(long long) * kMProfMarks * n);
}
#endif

// out[r] = serial FMA chain of w[idx[r, j]] * val[r, j] over j < k, in one
// launch of `blocks` blocks of `threads`, each taking `rows` rows in panels
// of panel_rows rows x chunk slots, W and V `stride` floats a slot in
// shared memory (smem_bytes in all), or (direct) a thread a row; all from
// ops/sgd.py::margin_layout.
// Returns the launch's CUDA error (0 = accepted).
int mmlspark_vw_margin(const int32_t* idx, const float* val, const float* w, float* out,
                       long long n, int k, long long rows, int panel_rows, int chunk, int stride,
                       int direct, int threads, int blocks, int smem_bytes, void* stream) {
  if (n == 0 || k == 0) return 0;
  if (threads < kWarp || threads > kMarginMaxThreads || threads % kWarp || rows < 1 ||
      blocks < 1 || rows * (long long)k >= (1LL << 31) || (long long)blocks * rows < n ||
      (!direct && (panel_rows < 1 || panel_rows >= (1 << 15) || chunk < 1 || chunk > k ||
                   stride < panel_rows || stride % 2 == 0 ||
                   (long long)panel_rows * chunk > (long long)kMarginPer * threads ||
                   (chunk < k && panel_rows > threads) ||
                   smem_bytes < 2 * chunk * stride * 4)))
    return (int)cudaErrorInvalidValue;
  static int opted = 0;  // the dynamic shared memory the kernel opted in to
  if (smem_bytes > 48 * 1024 && smem_bytes > opted) {
    const cudaError_t err = cudaFuncSetAttribute(
        vw_margin_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return (int)err;
    opted = smem_bytes;
  }
  const MarginArgs a{idx, val, w, out, (int64_t)n, k, (int64_t)rows, panel_rows, chunk,
                     stride, direct};
  vw_margin_kernel<<<blocks, threads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
