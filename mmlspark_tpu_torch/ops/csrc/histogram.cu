// Gradient-histogram kernels for Hopper (sm_90a), behind a plain C interface
// that mmlspark_tpu_torch/ops/histogram.py loads with ctypes.
//
// Replaces the three Pallas TPU kernels of mmlspark_tpu/ops/histogram.py:
//   plane_hist       <- _hist_kernel (B1) and _hist_split_kernel (B2). The two
//                       compute the same plane; B2's hi*8+lo decomposition and
//                       both kernels' bf16 hi/lo stats split exist for the TPU's
//                       matrix unit, which Hopper's CUDA cores do not need.
//   multi_plane_hist <- _multi_kernel (B3), every slot (leaf) of one tree level
//                       in one pass over the rows; any slot count.
// Both are one kernel body: plane_hist is the one-slot case with a row mask.
//
// Function. plane: out[f*B + v, j] = sum_r [bins[r,f] == v] * stats[r,j] * mask[r].
// multi: out[s, f*B + v, j] = sum_r [slot[r] == s] [bins[r,f] == v] * stats[r,j].
// A bin outside [0, B) or a slot outside [0, S) contributes nowhere.
//
// Determinism: fixed-point sums. A pre-pass takes a_j = max |v[r,j]| over the
// contributing rows (v = stats * mask) and picks the largest power of two
// 2^k_j with n * a_j * 2^k_j < 2^62. Each row adds the int64
// q = round_half_even(v * 2^k_j) into int64 sums, which stay below 2^62, and
// integer addition makes the order of the atomics irrelevant: every run gives
// the same bits. The last pass converts each sum to double (round to nearest),
// scales it exactly by 2^-k_j and rounds it to f32. Integer weights (counts)
// stay exact; any other value is rounded by at most 2^-(k_j + 1) per row, that
// is a_j * 2^-(62 - ceil(log2 n)) at most: at n = 200,000, 2^-44 of the
// column's largest value, so a column can span 2^20 in magnitude before its
// smallest values are rounded more coarsely than f32 rounds them (2^-24 of
// themselves). A column whose max is
// NaN or inf comes out NaN throughout. ops/histogram.py's *_emulated
// functions repeat this arithmetic in PyTorch; the kernel equals them bitwise.
//
// Passes, one call: (1) memset of the int64 accumulator; (2) scan: max |v| per
// column and the list of contributing rows (mask != 0, or slot in range), in
// any order, since the sums do not depend on it; (3) hist: a block owns
// (feature group, kept-row chunk, slot group) and a private int64 histogram
// of fb features x sg slots x B bins in shared memory, most of the SM's. A
// warp packs 32 kept rows of its slot group into a batch, a row per lane, and
// walks 32 features in 32 steps, lane l on feature (step + l) % 32: the
// features lie innermost in shared memory, so the 32 atomics of a step hit 32
// different banks and never one cell, whatever the bins (a feature whose rows
// all share one bin costs no more than any other). Each lane reads its row's
// bins as two 16-byte loads. Two blocks of consecutive row chunks form a
// cluster and sum each other's cells through distributed shared memory, so
// the merge into the global accumulator takes one int64 atomic per nonzero
// cell and cluster. (4) convert to f32.
//
// Bound at the main-path shape (n = 200,000, d = 64, B = 256, uint8 bins): the
// function reads 12.8 MB of bins and 2.4 MB of stats and writes 0.2 MB, 4.6 us
// at 3.35 TB/s. This design is bound instead by atomic throughput: up to
// n * d * 6 shared-memory atomics (each int64 add is a 32-bit atomic on its low
// word, skipped when that word is 0 as for integer counts, and one on its high
// word, skipped when nothing carries into it), and the merge's global atomics,
// one per nonzero cell per cluster. Dropped rows cost only their mask or slot
// read in the scan: the hist pass walks the kept rows alone, and the number of
// row chunks follows their count.
//
// Launch geometry is chosen here, from (n, d, B, S) and the SM count: features
// per block, slot planes per block, row chunks and cluster size.
//
// The distributed form (B4: the JAX package's per-shard kernel + psum of the
// planes, _plane_histogram_shard_map and multi_plane_histogram(mesh=...)).
// The *_fixed entries take the scale from the caller instead of computing it:
// six int64 words on the device, k_0..k_2 and finite_0..finite_2, which the
// wrapper derives from an all-reduce MAX of the ranks' column maxima and the
// global row count. They skip pass (4) and leave the int64 sums in the first
// S * d * B * 3 words of the scratch. The wrapper all-reduces those sums and
// only then rounds to f32, so the plane of any number of ranks equals, bit for
// bit, the plane one call on all their rows gives: every row adds the same
// integer, and integer addition does not depend on the order or the rank.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;     // hist block
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 2;     // row chunks whose blocks merge through shared memory
constexpr int kSub = 2;            // 32-entry sub-tiles of the kept-row list a warp loads at once
constexpr int kScanThreads = 512;  // scan block
constexpr int kScanWarps = kScanThreads / 32;
constexpr int kSmemBytes = 232448 - 1024;  // dynamic shared memory a hist block may take
constexpr int kCellBytes = 3 * 8;          // (g, h, count) as int64
constexpr int kSumBits = 62;       // n * max|q| < 2^62: no int64 sum overflows
constexpr int kMinChunkRows = 256;  // least kept rows one row chunk takes
constexpr int kMaxChunks = 65535;   // grid.y limit
constexpr int kTooManyBins = -1;    // returned when one bin row of a feature overflows a block
constexpr unsigned kFull = 0xffffffffu;

// Two int64 words after the accumulator; the kept-row list follows them.
struct Header {
  unsigned maxbits[3];  // bits of max |v| per column (NaN bits sort above inf)
  unsigned kept;        // number of rows in the list
};

__host__ __device__ inline int ceil_log2(long long n) {  // least k with 2^k >= n
  int k = 0;
  while ((1LL << k) < n) ++k;
  return k;
}

// Words between one bin's cells and the next in a shared-memory plane of nf
// features: a multiple of 32 above 16 features, so that feature f lives in
// bank f % 32 whatever its bin and a warp's 32 lanes, on 32 features, never
// share a bank.
__host__ __device__ inline int lane_width(int nf) { return nf <= 16 ? nf : (nf + 31) / 32 * 32; }

// frexp's exponent: a < 2^e <= 2a for finite a > 0, and 0 for a == 0.
__device__ inline int frexp_exponent(float a) {
  const unsigned bits = __float_as_uint(a);
  const int e = static_cast<int>(bits >> 23);
  if (e > 0) return e - 126;
  const unsigned mant = bits & 0x7fffffu;
  return mant ? (32 - __clz(mant)) - 149 : 0;
}

struct Scales {
  double to_int[3];    // 2^k_j
  double to_float[3];  // 2^-k_j
  bool finite[3];
};

// k_j = kSumBits - ceil(log2 n) - e_j, with max|v_j| < 2^e_j.
// The scale the caller fixed: k_j in given[j], finite_j in given[3 + j].
__device__ inline Scales given_scales(const long long* given) {
  Scales s;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    s.finite[j] = given[3 + j] != 0;
    const int k = static_cast<int>(given[j]);
    s.to_int[j] = ldexp(1.0, k);
    s.to_float[j] = ldexp(1.0, -k);
  }
  return s;
}

__device__ inline Scales load_scales(const Header* hdr, int n) {
  Scales s;
  const int top = kSumBits - ceil_log2(n);
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const float a = __uint_as_float(hdr->maxbits[j]);
    s.finite[j] = isfinite(a);
    const int k = top - (s.finite[j] ? frexp_exponent(a) : 0);
    s.to_int[j] = ldexp(1.0, k);
    s.to_float[j] = ldexp(1.0, -k);
  }
  return s;
}

// round_half_even(stat * w * 2^k_j); the product with 2^k_j is exact in f64.
__device__ __forceinline__ long long to_fixed(float stat, float w, const Scales& sc, int j) {
  if (!sc.finite[j]) return 0;
  return __double2ll_rn(__dmul_rn(static_cast<double>(__fmul_rn(stat, w)), sc.to_int[j]));
}

// int64 adds into shared memory as native 32-bit atomics on a low and a high
// word (a 64-bit shared atomicAdd compiles to a compare-and-swap loop,
// ATOMS.CAST.SPIN.64). The thread whose low-word add wraps carries one into
// the high word, so the pair always holds the exact int64 sum. Either add is
// skipped when it would add 0: the low one for values the scale makes whole
// multiples of 2^32 (integer counts), the high one for small values.
__device__ __forceinline__ unsigned add_low(unsigned* lo_word, long long q) {
  const unsigned lo = static_cast<unsigned>(q);
  return lo ? atomicAdd(lo_word, lo) : 0u;
}

__device__ __forceinline__ void add_high(unsigned* hi_word, long long q, unsigned old) {
  const unsigned lo = static_cast<unsigned>(q);
  const unsigned up =
      static_cast<unsigned>(static_cast<unsigned long long>(q) >> 32) + (old + lo < old ? 1u : 0u);
  if (up) atomicAdd(hi_word, up);
}

// Pass 2: max |v| per column over the contributing rows, and their list.
// One atomic per block reserves the block's place in the list.
template <bool kMulti>
__global__ void __launch_bounds__(kScanThreads)
scan_rows_kernel(const float* __restrict__ stats, const float* __restrict__ mask,
                 const int32_t* __restrict__ slot, int n, int S, Header* hdr,
                 int32_t* __restrict__ rows) {
  __shared__ unsigned offset[kScanWarps];
  __shared__ unsigned wmax[3][kScanWarps];
  __shared__ unsigned block_base;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned m0 = 0, m1 = 0, m2 = 0;
  for (long long t0 = static_cast<long long>(blockIdx.x) * kScanThreads; t0 < n;
       t0 += static_cast<long long>(gridDim.x) * kScanThreads) {  // uniform per block
    const long long r = t0 + threadIdx.x;
    bool keep = false;
    if (r < n) {
      float w = 1.f;
      if (kMulti) {
        const int s = slot[r];
        keep = s >= 0 && s < S;
      } else {
        if (mask) w = mask[r];
        keep = w != 0.f;
      }
      // plane: every row (a NaN stat times mask 0 is NaN in the plain sum too)
      if (!kMulti || keep) {
        const float* st = stats + 3 * r;
        m0 = max(m0, __float_as_uint(fabsf(__fmul_rn(st[0], w))));
        m1 = max(m1, __float_as_uint(fabsf(__fmul_rn(st[1], w))));
        m2 = max(m2, __float_as_uint(fabsf(__fmul_rn(st[2], w))));
      }
    }
    const unsigned bits = __ballot_sync(kFull, keep);
    if (lane == 0) offset[warp] = __popc(bits);
    __syncthreads();
    if (threadIdx.x == 0) {
      unsigned total = 0;
      for (int w = 0; w < kScanWarps; ++w) {
        const unsigned c = offset[w];
        offset[w] = total;
        total += c;
      }
      block_base = total ? atomicAdd(&hdr->kept, total) : 0u;
    }
    __syncthreads();
    if (keep)
      rows[block_base + offset[warp] + __popc(bits & ((1u << lane) - 1u))] = static_cast<int32_t>(r);
    __syncthreads();  // offset and block_base are rewritten next round
  }
  m0 = __reduce_max_sync(kFull, m0);
  m1 = __reduce_max_sync(kFull, m1);
  m2 = __reduce_max_sync(kFull, m2);
  if (lane == 0) {
    wmax[0][warp] = m0;
    wmax[1][warp] = m1;
    wmax[2][warp] = m2;
  }
  __syncthreads();
  if (threadIdx.x < 3) {
    unsigned m = 0;
    for (int w = 0; w < kScanWarps; ++w) m = max(m, wmax[threadIdx.x][w]);
    if (m) atomicMax(&hdr->maxbits[threadIdx.x], m);
  }
}

// One batch of the hist pass: lane l holds a kept row (if valid), scales its
// stats (times its mask value, for plane_hist) to fixed point and adds them
// into every feature of the block, 32 features [h, h + cnt) at a time, one per
// step f. At step f lane l takes feature (f + l) % 32, so the 32 lanes always
// work on 32 different features: features lie innermost in shared memory (F
// words per bin, a multiple of 32 above 16 features), so they also sit in 32
// different banks, and no two lanes ever add into one cell at once.
template <typename BinT>
__device__ __forceinline__ void add_rows(const BinT* __restrict__ bins,
                                         const float* __restrict__ stats,
                                         const float* __restrict__ mask, const Scales& sc,
                                         unsigned* sh, bool valid, int row, int sl, int d,
                                         int f0, int nf, int F, int B, int plane, int cells,
                                         int ns, int lane) {
  long long q0 = 0, q1 = 0, q2 = 0;
  if (valid) {
    const float wt = mask ? mask[row] : 1.f;
    const float* st = stats + 3 * static_cast<size_t>(row);
    q0 = to_fixed(st[0], wt, sc, 0);
    q1 = to_fixed(st[1], wt, sc, 1);
    q2 = to_fixed(st[2], wt, sc, 2);
  }
  for (int h = 0; h < nf; h += 32) {  // uniform
    const int cnt = min(32, nf - h);
    const BinT* p = bins + static_cast<size_t>(row) * d + f0 + h;
    unsigned* base = sh + sl * plane + h;
    unsigned w[8];  // uint8 bins: the row's 32 bins, rotated left by `lane` bytes
    if constexpr (sizeof(BinT) == 1) {
      if (cnt == 32 && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
        const uint4 a = valid ? reinterpret_cast<const uint4*>(p)[0] : make_uint4(0, 0, 0, 0);
        const uint4 b = valid ? reinterpret_cast<const uint4*>(p)[1] : make_uint4(0, 0, 0, 0);
        w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
        w[4] = b.x; w[5] = b.y; w[6] = b.z; w[7] = b.w;
      } else {
#pragma unroll
        for (int k = 0; k < 8; ++k) w[k] = 0;
#pragma unroll
        for (int k = 0; k < 32; ++k)
          if (valid && k < cnt) w[k >> 2] |= static_cast<unsigned>(p[k]) << (8 * (k & 3));
      }
#pragma unroll
      for (int sh_w = 4; sh_w >= 1; sh_w >>= 1) {  // rotate words by lane / 4
        const bool on = (lane >> 2) & sh_w;
        unsigned t[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) t[k] = on ? w[(k + sh_w) & 7] : w[k];
#pragma unroll
        for (int k = 0; k < 8; ++k) w[k] = t[k];
      }
      {  // then bytes by lane % 4
        const unsigned by = 8 * (lane & 3);
        unsigned t[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) t[k] = __funnelshift_r(w[k], w[(k + 1) & 7], by);
#pragma unroll
        for (int k = 0; k < 8; ++k) w[k] = t[k];
      }
    }
#pragma unroll
    for (int f = 0; f < 32; ++f) {
      const int fr = (f + lane) & 31;
      long long v;
      if constexpr (sizeof(BinT) == 1) {
        v = (w[f >> 2] >> (8 * (f & 3))) & 0xffu;
      } else {
        v = (valid && fr < cnt) ? static_cast<long long>(p[fr]) : -1;
      }
      if (valid && fr < cnt && v >= 0 && v < B) {
        unsigned* c = base + static_cast<int>(v) * F + fr;
        const unsigned o0 = add_low(c, q0);
        const unsigned o1 = add_low(c + ns * plane, q1);
        const unsigned o2 = add_low(c + 2 * ns * plane, q2);
        add_high(c + cells, q0, o0);
        add_high(c + ns * plane + cells, q1, o1);
        add_high(c + 2 * ns * plane + cells, q2, o2);
      }
    }
  }
}

// Pass 3. grid: (feature groups of fb, row chunks, slot groups of sg).
// acc: [S][d * B][3] int64. Shared memory: the low words of every (stat j,
// slot, bin, feature) cell, features innermost, then their high words. A warp
// reads the kept-row list 32 * kSub entries at a time and packs the rows of
// its slot group into full batches of 32, one row per lane (pending rows wait
// in registers), so a sparse slot group costs list reads, not idle lanes.
template <typename BinT, bool kMulti>
__global__ void __launch_bounds__(kThreads)
hist_kernel(const BinT* __restrict__ bins, const float* __restrict__ stats,
            const float* __restrict__ mask, const int32_t* __restrict__ slot,
            const Header* __restrict__ hdr, const int32_t* __restrict__ rows,
            const long long* __restrict__ given, unsigned long long* __restrict__ acc, int n,
            int d, int B, int S, int fb, int sg) {
  extern __shared__ unsigned sh[];               // [2][3][ns][B][F]
  __shared__ unsigned char lane_of[kWarps][32];  // per warp: kept rank -> lane

  // chunks follow the kept rows: a sparse mask leaves most blocks idle
  cg::cluster_group cluster = cg::this_cluster();
  const int K = static_cast<int>(hdr->kept);
  const int chunks =
      min(static_cast<int>(gridDim.y), max(1, (K + kMinChunkRows - 1) / kMinChunkRows));
  const int per = (K + chunks - 1) / chunks;
  const int first = static_cast<int>(blockIdx.y - cluster.block_index().y);
  if (first * per >= K) return;  // the whole cluster is idle
  const int i_begin = static_cast<int>(blockIdx.y) * per;
  const int i_end = min(K, i_begin + per);  // empty for an idle block of a busy cluster

  const int f0 = blockIdx.x * fb, nf = min(fb, d - f0), F = lane_width(nf);
  const int s0 = blockIdx.z * sg, ns = kMulti ? min(sg, S - s0) : 1;
  const int plane = B * F;           // words of one (stat, slot)
  const int cells = 3 * ns * plane;  // int64 cells; high words at sh + cells
  for (int i = threadIdx.x; i < 2 * cells; i += kThreads) sh[i] = 0u;
  const Scales sc = given ? given_scales(given) : load_scales(hdr, n);
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  int pc = 0, p_row = 0, p_sl = 0;  // pending batch
  for (int t0 = i_begin + warp * 32 * kSub; t0 < i_end; t0 += kThreads * kSub) {
    int r[kSub], s[kSub];
    bool keep[kSub];
#pragma unroll
    for (int u = 0; u < kSub; ++u) {
      const int i = t0 + u * 32 + lane;
      keep[u] = i < i_end;
      r[u] = keep[u] ? rows[i] : 0;
    }
#pragma unroll
    for (int u = 0; u < kSub; ++u) {
      s[u] = 0;
      if (kMulti) {
        s[u] = keep[u] ? slot[r[u]] - s0 : -1;
        keep[u] = s[u] >= 0 && s[u] < ns;
      }
    }
#pragma unroll
    for (int u = 0; u < kSub; ++u) {
      const unsigned bits = __ballot_sync(kFull, keep[u]);
      const int kept = __popc(bits);
      if (keep[u]) lane_of[warp][__popc(bits & below)] = static_cast<unsigned char>(lane);
      __syncwarp();
      // lanes pc.. take the new rows of rank lane - pc
      const int rank = lane - pc;
      const int src = (rank >= 0 && rank < kept) ? lane_of[warp][rank] : lane;
      const int n_row = __shfl_sync(kFull, r[u], src), n_sl = __shfl_sync(kFull, s[u], src);
      if (rank >= 0 && rank < kept) {
        p_row = n_row;
        p_sl = n_sl;
      }
      if (pc + kept >= 32) {  // a full batch: add it, keep the overflow pending
        add_rows(bins, stats, mask, sc, sh, true, p_row, p_sl, d, f0, nf, F, B, plane, cells,
                 ns, lane);
        const int rem = pc + kept - 32;
        const int src2 = lane < rem ? lane_of[warp][32 - pc + lane] : lane;
        p_row = __shfl_sync(kFull, r[u], src2);
        p_sl = __shfl_sync(kFull, s[u], src2);
        pc = rem;
      } else {
        pc += kept;
      }
      __syncwarp();  // lane_of is rewritten for the next 32 entries
    }
  }
  if (pc > 0)
    add_rows(bins, stats, mask, sc, sh, lane < pc, p_row, p_sl, d, f0, nf, F, B, plane, cells,
             ns, lane);
  __syncthreads();

  // Merge: the blocks of a cluster hold the same cells for other rows. Each
  // sums its share of the cells over the cluster's shared memories and adds
  // the nonzero sums into the output: one global atomic per cell and cluster.
  cluster.sync();
  const int nb = static_cast<int>(cluster.num_blocks());
  const int share = (cells + nb - 1) / nb;
  const int c_begin = static_cast<int>(cluster.block_rank()) * share;
  const int c_end = min(cells, c_begin + share);
  for (int i = c_begin + threadIdx.x; i < c_end; i += kThreads) {
    unsigned long long v = 0ull;
    for (int q = 0; q < nb; ++q) {
      const unsigned* peer = cluster.map_shared_rank(sh, q);
      v += (static_cast<unsigned long long>(peer[i + cells]) << 32) | peer[i];
    }
    if (v == 0ull) continue;  // untouched (or summing to 0): nothing to add
    const int f = i % F, rest = i / F;
    const int b = rest % B, js = rest / B, sl = js % ns, j = js / ns;
    atomicAdd(acc + ((static_cast<size_t>(s0 + sl) * d + f0 + f) * B + b) * 3 + j, v);
  }
  cluster.sync();  // peers read this block's shared memory until here
}

// Pass 4: out = int64 sum * 2^-k_j, exact in f64 and rounded once to f32; NaN
// where the column's max was not finite.
__global__ void to_float_kernel(const long long* __restrict__ acc, const Header* __restrict__ hdr,
                                float* __restrict__ out, size_t m, int n) {
  const Scales sc = load_scales(hdr, n);
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < m;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const int j = static_cast<int>(i % 3);
    const double scale = j == 0 ? sc.to_float[0] : (j == 1 ? sc.to_float[1] : sc.to_float[2]);
    const bool fin = j == 0 ? sc.finite[0] : (j == 1 ? sc.finite[1] : sc.finite[2]);
    out[i] = fin ? __double2float_rn(__dmul_rn(__ll2double_rn(acc[i]), scale))
                 : __uint_as_float(0x7fc00000u);
  }
}

int grid_for(size_t work, int threads, int most) {
  const size_t want = (work + threads - 1) / threads;
  return static_cast<int>(want < static_cast<size_t>(most) ? (want > 0 ? want : 1) : most);
}

struct Geometry {
  int fb;        // features per block
  int sg;        // slot planes per block
  int nchunks;   // row chunks (grid.y), whole clusters
  int cluster;   // row chunks whose blocks merge through shared memory
  size_t smem;   // dynamic shared memory per block
};

size_t plane_bytes(int B, int nf) { return static_cast<size_t>(B) * lane_width(nf) * kCellBytes; }

// A block holds sg slot planes of B x lane_width(fb) int64 cells in shared
// memory. fb is d when d is 16 or less, else a multiple of 32 (a lane per
// feature, one bank each), or, where 32 features overflow the block, up to 16
// narrow ones. Row chunks: about one block per SM (a block takes most of an
// SM's shared memory), in clusters of kMaxCluster where there are enough; the
// kernel uses fewer when fewer rows are kept. False when one feature's bins
// alone overflow a block.
bool plan(int n, int d, int B, int S, int sms, Geometry* g) {
  int fb;
  if (d <= 16 && plane_bytes(B, d) <= kSmemBytes) {
    fb = d;
  } else if (plane_bytes(B, 32) <= kSmemBytes) {
    fb = 32 * min((d + 31) / 32, static_cast<int>(kSmemBytes / plane_bytes(B, 32)));
  } else {
    fb = min(min(d, 16), static_cast<int>(kSmemBytes / plane_bytes(B, 1)));
    if (fb < 1) return false;
  }
  g->fb = min(fb, d);
  g->sg = min(S, static_cast<int>(kSmemBytes / plane_bytes(B, g->fb)));
  g->smem = static_cast<size_t>(g->sg) * plane_bytes(B, g->fb);
  const int per_chunk = (d + g->fb - 1) / g->fb * ((S + g->sg - 1) / g->sg);
  const int by_rows = static_cast<int>((n + kMinChunkRows - 1LL) / kMinChunkRows);
  const int chunks = max(1, min(min(by_rows, max(1, sms / per_chunk)), kMaxChunks));
  g->cluster = chunks >= kMaxCluster ? kMaxCluster : 1;
  g->nchunks = chunks / g->cluster * g->cluster;
  return true;
}

// partial: int64 words, [S * d * B * 3 accumulator][2 header][ceil(n / 2) row list].
// given: null (the scale from this call's rows, then f32 into out) or the
// caller's scale (the int64 sums stay in partial; out is not written).
template <typename BinT, bool kMulti>
int launch(const void* bins, const float* stats, const float* mask, const int32_t* slot,
           const long long* given, long long* partial, float* out, int n, int d, int B,
           int S, int sms, cudaStream_t st) {
  Geometry g;
  if (!plan(n, d, B, S, sms, &g)) return kTooManyBins;
  const size_t m = static_cast<size_t>(S) * d * B * 3;
  Header* hdr = reinterpret_cast<Header*>(partial + m);
  int32_t* rows = reinterpret_cast<int32_t*>(partial + m + 2);

  cudaError_t err = cudaMemsetAsync(partial, 0, (m + 2) * sizeof(long long), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  scan_rows_kernel<kMulti><<<grid_for(n, kScanThreads, 1024), kScanThreads, 0, st>>>(
      stats, mask, slot, n, S, hdr, rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  err = cudaFuncSetAttribute(hist_kernel<BinT, kMulti>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(g.smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((d + g.fb - 1) / g.fb, g.nchunks, (S + g.sg - 1) / g.sg);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = g.smem;
  cfg.stream = st;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 1;
  attr.val.clusterDim.y = g.cluster;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, hist_kernel<BinT, kMulti>, static_cast<const BinT*>(bins),
                           stats, mask, slot, const_cast<const Header*>(hdr),
                           const_cast<const int32_t*>(rows), given,
                           reinterpret_cast<unsigned long long*>(partial), n, d, B, S, g.fb,
                           g.sg);
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err != cudaSuccess || given) return static_cast<int>(err);

  to_float_kernel<<<grid_for(m, 256, 4096), 256, 0, st>>>(partial, hdr, out, m, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// bin_kind: 0 = uint8 bins, 1 = int32 bins. mask may be null (all rows kept).
// partial holds d * B * 3 + 2 + ceil(n / 2) int64 words of scratch; out d * B * 3
// floats. sms: the device's SM count, which sizes the grid. Returns the first
// CUDA error (0 = launched), or kTooManyBins (-1) when B bins of one feature
// overflow a block's shared memory.
int mmlspark_plane_hist(const void* bins, int bin_kind, const float* stats,
                        const float* mask, long long* partial, float* out, int n, int d,
                        int B, int sms, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bin_kind == 0)
    return launch<uint8_t, false>(bins, stats, mask, nullptr, nullptr, partial, out, n, d, B, 1,
                                  sms, st);
  return launch<int32_t, false>(bins, stats, mask, nullptr, nullptr, partial, out, n, d, B, 1,
                                sms, st);
}

// partial holds S * d * B * 3 + 2 + ceil(n / 2) int64 words; out S * d * B * 3.
int mmlspark_multi_plane_hist(const void* bins, int bin_kind, const float* stats,
                              const int32_t* slot, long long* partial, float* out, int n,
                              int d, int B, int S, int sms, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bin_kind == 0)
    return launch<uint8_t, true>(bins, stats, nullptr, slot, nullptr, partial, out, n, d, B, S,
                                 sms, st);
  return launch<int32_t, true>(bins, stats, nullptr, slot, nullptr, partial, out, n, d, B, S,
                               sms, st);
}

// The distributed form of mmlspark_plane_hist: scale = six int64 words on the
// device (k_0..k_2, finite_0..finite_2). The int64 sums are left in the first
// d * B * 3 words of partial; nothing is converted to f32.
int mmlspark_plane_hist_fixed(const void* bins, int bin_kind, const float* stats,
                              const float* mask, const long long* scale, long long* partial,
                              int n, int d, int B, int sms, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bin_kind == 0)
    return launch<uint8_t, false>(bins, stats, mask, nullptr, scale, partial, nullptr, n, d, B,
                                  1, sms, st);
  return launch<int32_t, false>(bins, stats, mask, nullptr, scale, partial, nullptr, n, d, B, 1,
                                sms, st);
}

// The distributed form of mmlspark_multi_plane_hist: the int64 sums are left
// in the first S * d * B * 3 words of partial.
int mmlspark_multi_plane_hist_fixed(const void* bins, int bin_kind, const float* stats,
                                    const int32_t* slot, const long long* scale,
                                    long long* partial, int n, int d, int B, int S, int sms,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bin_kind == 0)
    return launch<uint8_t, true>(bins, stats, nullptr, slot, scale, partial, nullptr, n, d, B, S,
                                 sms, st);
  return launch<int32_t, true>(bins, stats, nullptr, slot, scale, partial, nullptr, n, d, B, S,
                               sms, st);
}

}  // extern "C"
