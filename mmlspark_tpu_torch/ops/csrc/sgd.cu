// VowpalWabbit's minibatch SGD step for Hopper (sm_90a), behind a plain C
// interface that mmlspark_tpu_torch/ops/sgd.py loads with ctypes.
//
// Replaces no Pallas kernel: the JAX package compiles the minibatch body of
// mmlspark_tpu/vw/learner.py::_shard_train (a lax.scan of sparse gathers and
// scatter-adds) with XLA. Its three steps become three kernels:
//   vw_grad   <- learner.py:120-123: one thread per row of the minibatch.
//                margin = serial FMA chain over the row's K slots,
//                m = fma(w[i_k], v_k, m); dl = dloss(m, y) * weight;
//                g_k = fma(dl, v_k, (l2 * w[i_k]) * (v_k != 0)).
//   vw_apply  <- learner.py:124-134: one thread per run of equal indices in
//                the minibatch. Adaptive: g2[i] += g*g over the run in (row,
//                k) order, then denom = sqrt(g2[i]) + eps once, then
//                w[i] += (-lr * g) / denom over the run in the same order.
//                Otherwise w[i] += (-step) * g, step from a table built on the
//                host (powf is not correctly rounded on the card).
//   vw_margin <- learner.py:337-346: one thread per row, the same FMA chain.
//
// Bits. XLA:CPU rounds at exactly these points and applies its scatter-adds
// serially in (row, k) order; every float operation here is an explicit
// round-to-nearest intrinsic, so nvcc contracts nothing, and a run is walked
// serially from the stored value. One thread owns each index of a minibatch
// (the runs come from one stable sort per fit, ops/sgd.py::sgd_plan), so there
// are no atomics and every run gives the same bits, equal to the plain
// PyTorch version on the CPU and to the JAX package for the squared, quantile
// and hinge losses. Logistic and poisson call expf, which rounds differently
// from XLA's exp. Slots whose value is 0 (the padding) are not in any run:
// for finite values they add exactly +-0 to g2 and w.
//
// Bound. A pass reads the rows' idx, val, y and weight once (8 K + 8 bytes a
// row), gathers w twice and g2 once per slot in a run, writes g once and
// reads it once or twice; the weights it touches are small (~4 bytes x
// distinct indices). At 100,000 rows x 17 slots that is ~30 MB: ~9 us at
// 3.35 TB/s. The pass is bound instead by its 2 x nb dependent launches
// (~2-4 us each) and, inside vw_apply, by the longest run walked serially
// (the Constant slot: one entry per row of the minibatch).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

enum Loss { kLogistic = 0, kSquared = 1, kQuantile = 2, kHinge = 3, kPoisson = 4 };

__device__ __forceinline__ float margin_of(const int32_t* ri, const float* rv,
                                           const float* w, int k) {
  float m = 0.0f;
  for (int j = 0; j < k; ++j) m = __fmaf_rn(w[ri[j]], rv[j], m);
  return m;
}

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

__global__ void vw_grad(const int32_t* __restrict__ idx, const float* __restrict__ val,
                        const float* __restrict__ y, const float* __restrict__ wt,
                        const float* __restrict__ w, float* __restrict__ g, int batch,
                        int k, int loss, float tau_hi, float tau_lo, float l2) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= batch) return;
  const int32_t* ri = idx + (int64_t)r * k;
  const float* rv = val + (int64_t)r * k;
  const float m = margin_of(ri, rv, w, k);
  const float dl = __fmul_rn(dloss(loss, m, y[r], tau_hi, tau_lo), wt[r]);
  float* rg = g + (int64_t)r * k;
  for (int j = 0; j < k; ++j) {
    const float v = rv[j];
    const float decay = __fmul_rn(__fmul_rn(l2, w[ri[j]]), v != 0.0f ? 1.0f : 0.0f);
    rg[j] = __fmaf_rn(dl, v, decay);
  }
}

// runs [mb_runs[0], mb_runs[1]) of one minibatch; run r holds the sorted
// entries [run_start[r], run_start[r + 1]) of order, each a slot's position
// (row * k + slot) in the minibatch, in (row, slot) order.
__global__ void vw_apply(const int32_t* __restrict__ idx, const float* __restrict__ g,
                         const int32_t* __restrict__ order,
                         const int32_t* __restrict__ run_start,
                         const int32_t* __restrict__ mb_runs, float* __restrict__ w,
                         float* __restrict__ g2, const float* __restrict__ step,
                         float neg_lr, float eps, int adaptive) {
  const int r = mb_runs[0] + blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= mb_runs[1]) return;
  const int s = run_start[r], e = run_start[r + 1];
  const int32_t i = idx[order[s]];
  float wi = w[i];
  if (adaptive) {
    float acc = g2[i];
    for (int j = s; j < e; ++j) {
      const float gj = g[order[j]];
      acc = __fadd_rn(acc, __fmul_rn(gj, gj));
    }
    g2[i] = acc;
    const float denom = __fadd_rn(__fsqrt_rn(acc), eps);
    for (int j = s; j < e; ++j)
      wi = __fadd_rn(wi, __fdiv_rn(__fmul_rn(neg_lr, g[order[j]]), denom));
  } else {
    const float neg_step = -step[0];
    for (int j = s; j < e; ++j) wi = __fadd_rn(wi, __fmul_rn(neg_step, g[order[j]]));
  }
  w[i] = wi;
}

__global__ void vw_margin(const int32_t* __restrict__ idx, const float* __restrict__ val,
                          const float* __restrict__ w, float* __restrict__ out, int n,
                          int k) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  out[r] = margin_of(idx + (int64_t)r * k, val + (int64_t)r * k, w, k);
}

inline int blocks(int64_t n) { return (int)((n + kThreads - 1) / kThreads); }

}  // namespace

extern "C" {

// One minibatch of `batch` rows, k slots each: idx, val (batch, k); y, wt
// (batch,); w the weight table; g (batch, k) out. tau_hi = 1 - tau and tau_lo
// = -tau, rounded to f32 by the caller. Returns the launch's CUDA error.
int mmlspark_vw_grad(const int32_t* idx, const float* val, const float* y, const float* wt,
                     const float* w, float* g, int batch, int k, int loss, float tau_hi,
                     float tau_lo, float l2, void* stream) {
  vw_grad<<<blocks(batch), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      idx, val, y, wt, w, g, batch, k, loss, tau_hi, tau_lo, l2);
  return (int)cudaGetLastError();
}

// The runs [mb_runs[0], mb_runs[1]) of one minibatch (ops/sgd.py::sgd_plan),
// at most max_runs of them; idx and g are the minibatch's. step: its step size
// (non-adaptive; may be null when adaptive). w and g2 are updated in place.
int mmlspark_vw_apply(const int32_t* idx, const float* g, const int32_t* order,
                      const int32_t* run_start, const int32_t* mb_runs, float* w, float* g2,
                      const float* step, float neg_lr, float eps, int adaptive, int max_runs,
                      void* stream) {
  if (max_runs == 0) return 0;
  vw_apply<<<blocks(max_runs), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      idx, g, order, run_start, mb_runs, w, g2, step, neg_lr, eps, adaptive);
  return (int)cudaGetLastError();
}

// One pass over nb minibatches: per minibatch one vw_grad into gbuf (batch * k
// floats of scratch) and one vw_apply, enqueued on `stream`. idx, val: (nb *
// batch, k); y, wt: (nb * batch,); mb_runs: nb + 1 offsets of the pass's
// plan; steps: nb step sizes (may be null when adaptive). Returns the first
// CUDA error (0 = every launch accepted).
int mmlspark_vw_pass(const int32_t* idx, const float* val, const float* y,
                     const float* wt, float* w, float* g2, float* gbuf,
                     const int32_t* order, const int32_t* run_start,
                     const int32_t* mb_runs, const float* steps, int nb, int batch,
                     int k, int loss, float tau_hi, float tau_lo, float neg_lr,
                     float l2, float eps, int adaptive, int max_runs, void* stream) {
  const int64_t rows_k = (int64_t)batch * k;
  for (int b = 0; b < nb; ++b) {
    int err = mmlspark_vw_grad(idx + b * rows_k, val + b * rows_k, y + (int64_t)b * batch,
                               wt + (int64_t)b * batch, w, gbuf, batch, k, loss, tau_hi,
                               tau_lo, l2, stream);
    if (err != 0) return err;
    err = mmlspark_vw_apply(idx + b * rows_k, gbuf, order, run_start, mb_runs + b, w, g2,
                            steps == nullptr ? nullptr : steps + b, neg_lr, eps, adaptive,
                            max_runs, stream);
    if (err != 0) return err;
  }
  return 0;
}

// out[r] = serial FMA chain of w[idx[r, j]] * val[r, j] over j < k.
int mmlspark_vw_margin(const int32_t* idx, const float* val, const float* w, float* out,
                       int n, int k, void* stream) {
  if (n == 0) return 0;
  vw_margin<<<blocks(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(idx, val, w,
                                                                           out, n, k);
  return (int)cudaGetLastError();
}

}  // extern "C"
