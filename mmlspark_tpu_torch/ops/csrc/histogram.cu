// Gradient-histogram kernels for Hopper (sm_90a), behind a plain C interface
// that mmlspark_tpu_torch/ops/histogram.py loads with ctypes.
//
// Replaces the three Pallas TPU kernels of mmlspark_tpu/ops/histogram.py:
//   plane_hist       <- _hist_kernel (B1) and _hist_split_kernel (B2). The two
//                       compute the same plane; B2's hi*8+lo decomposition and
//                       both kernels' bf16 hi/lo stats split exist for the TPU's
//                       matrix unit. Here CUDA cores accumulate in f32 directly.
//   multi_plane_hist <- _multi_kernel (B3), every slot (leaf) of one tree level
//                       in one pass over the rows; any slot count.
//
// Function. plane: out[f*B + v, j] = sum_r [bins[r,f] == v] * stats[r,j] * mask[r].
// multi: out[s, f*B + v, j] = sum_r [slot[r] == s] [bins[r,f] == v] * stats[r,j].
// A bin outside [0, B) or a slot outside [0, S) contributes nowhere. Sums are
// f32; counts (stats column 2 = 1 per row) are exact below 2^24 rows per cell.
//
// Determinism. No atomics. Stage 1: a block owns (a feature block, a row chunk
// [, a group of 16 slots]); each thread owns one (feature, bin) cell and scans
// the chunk's rows in order, adding the rows whose bin matches (the TPU's
// one-hot compare, as a per-thread scan). Every block writes a private partial
// plane. Stage 2 sums the chunk partials of each cell in chunk order. The chunk
// count depends on the shapes only, so the output is bitwise the same on every
// run. Rows whose mask is 0 (or whose slot lies outside the block's group) are
// skipped by the whole block at once: the branch is uniform.
//
// Bound at the main-path shape (n = 200,000 rows, d = 64, B = 256, uint8 bins):
// the function must read 12.8 MB of bins, 2.4 MB of stats and 0.8 MB of mask,
// and write 0.2 MB, about 16 MB: 4.8 us at 3.35 TB/s. It is memory-bound by
// that count. This design is not: each thread compares every row of its chunk,
// n * d * B compares per plane, so it is bound by issue rate, far above the byte
// bound. Shared-memory staging keeps the bins and stats reads at one global
// read per block and row; the per-cell work is what a later kernel (one-hot
// products on the tensor cores, or warp-aggregated private histograms) removes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;    // threads per block; one (feature, bin) cell each
constexpr int kRows = 512;       // rows staged in shared memory per step
constexpr int kMaxFB = 16;       // most features per block (B = 16)
constexpr int kSlotGroup = 16;   // slots one multi-plane block accumulates

template <typename BinT>
__device__ __forceinline__ int staged_bin(BinT b, int B) {
  const long long v = static_cast<long long>(b);
  return (v >= 0 && v < B) ? static_cast<int>(v) : -1;  // -1 matches no cell
}

// grid: (feature blocks, row chunks). partial: [chunk][d * B][3].
template <typename BinT>
__global__ void __launch_bounds__(kThreads)
plane_hist_kernel(const BinT* __restrict__ bins, const float* __restrict__ stats,
                  const float* __restrict__ mask, float* __restrict__ partial,
                  int n, int d, int B, int fb, int rows_per_chunk) {
  __shared__ float4 st_s[kRows];          // (g*m, h*m, c*m, m)
  __shared__ int bin_s[kMaxFB * kRows];   // feature-major: [fl][row]

  const int f0 = blockIdx.x * fb;
  const int nf = min(fb, d - f0);
  const int r_begin = blockIdx.y * rows_per_chunk;
  const int r_end = min(n, r_begin + rows_per_chunk);
  const int cells = nf * B;
  float* out = partial + static_cast<size_t>(blockIdx.y) * d * B * 3;

  for (int c0 = 0; c0 < cells; c0 += kThreads) {   // one pass when B <= 256
    const int c = c0 + threadIdx.x;
    const bool own = c < cells;
    const int fl = own ? c / B : 0;
    const int v = own ? c % B : -2;
    float ag = 0.f, ah = 0.f, ac = 0.f;
    for (int r0 = r_begin; r0 < r_end; r0 += kRows) {
      const int m = min(kRows, r_end - r0);
      __syncthreads();                    // the previous step's readers are done
      for (int i = threadIdx.x; i < m; i += kThreads) {
        const size_t r = static_cast<size_t>(r0 + i);
        const float w = mask ? mask[r] : 1.f;
        st_s[i] = make_float4(stats[3 * r] * w, stats[3 * r + 1] * w,
                              stats[3 * r + 2] * w, w);
      }
      for (int i = threadIdx.x; i < nf * m; i += kThreads) {
        const int f = i / m, rr = i - f * m;
        bin_s[f * kRows + rr] =
            staged_bin(bins[static_cast<size_t>(r0 + rr) * d + f0 + f], B);
      }
      __syncthreads();
      if (own) {
        const int* bs = bin_s + fl * kRows;
        for (int i = 0; i < m; ++i) {
          const float4 s = st_s[i];
          if (s.w == 0.f) continue;       // masked-out row: uniform skip
          if (bs[i] == v) { ag += s.x; ah += s.y; ac += s.z; }
        }
      }
    }
    if (own) {
      float* o = out + 3 * (static_cast<size_t>(f0 + fl) * B + v);
      o[0] = ag; o[1] = ah; o[2] = ac;
    }
  }
}

// grid: (feature blocks, row chunks, slot groups). partial: [chunk][S][d * B][3].
template <typename BinT>
__global__ void __launch_bounds__(kThreads)
multi_plane_hist_kernel(const BinT* __restrict__ bins, const float* __restrict__ stats,
                        const int32_t* __restrict__ slot, float* __restrict__ partial,
                        int n, int d, int B, int S, int fb, int rows_per_chunk) {
  __shared__ float4 st_s[kRows];          // (g, h, c, -)
  __shared__ int sl_s[kRows];             // slot - s0, or -1 outside this group
  __shared__ int bin_s[kMaxFB * kRows];

  const int f0 = blockIdx.x * fb;
  const int nf = min(fb, d - f0);
  const int r_begin = blockIdx.y * rows_per_chunk;
  const int r_end = min(n, r_begin + rows_per_chunk);
  const int s0 = blockIdx.z * kSlotGroup;
  const int ns = min(kSlotGroup, S - s0);
  const int cells = nf * B;
  const size_t plane = static_cast<size_t>(d) * B * 3;
  float* out = partial + static_cast<size_t>(blockIdx.y) * S * plane;

  for (int c0 = 0; c0 < cells; c0 += kThreads) {
    const int c = c0 + threadIdx.x;
    const bool own = c < cells;
    const int fl = own ? c / B : 0;
    const int v = own ? c % B : -2;
    float acc[kSlotGroup][3];
#pragma unroll
    for (int k = 0; k < kSlotGroup; ++k) acc[k][0] = acc[k][1] = acc[k][2] = 0.f;
    for (int r0 = r_begin; r0 < r_end; r0 += kRows) {
      const int m = min(kRows, r_end - r0);
      __syncthreads();
      for (int i = threadIdx.x; i < m; i += kThreads) {
        const size_t r = static_cast<size_t>(r0 + i);
        st_s[i] = make_float4(stats[3 * r], stats[3 * r + 1], stats[3 * r + 2], 0.f);
        const int s = slot[r] - s0;
        sl_s[i] = (s >= 0 && s < ns) ? s : -1;
      }
      for (int i = threadIdx.x; i < nf * m; i += kThreads) {
        const int f = i / m, rr = i - f * m;
        bin_s[f * kRows + rr] =
            staged_bin(bins[static_cast<size_t>(r0 + rr) * d + f0 + f], B);
      }
      __syncthreads();
      if (own) {
        const int* bs = bin_s + fl * kRows;
        for (int i = 0; i < m; ++i) {
          const int s = sl_s[i];
          if (s < 0) continue;            // row of another slot group: uniform skip
          if (bs[i] == v) {
            const float4 st = st_s[i];
#pragma unroll
            for (int k = 0; k < kSlotGroup; ++k) {
              if (s == k) { acc[k][0] += st.x; acc[k][1] += st.y; acc[k][2] += st.z; }
            }
          }
        }
      }
    }
    if (own) {
      const size_t cell = 3 * (static_cast<size_t>(f0 + fl) * B + v);
#pragma unroll
      for (int k = 0; k < kSlotGroup; ++k) {
        if (k < ns) {
          float* o = out + static_cast<size_t>(s0 + k) * plane + cell;
          o[0] = acc[k][0]; o[1] = acc[k][1]; o[2] = acc[k][2];
        }
      }
    }
  }
}

// Stage 2: out[i] = sum over chunks c, in order, of partial[c * m + i].
__global__ void sum_chunks_kernel(const float* __restrict__ partial,
                                  float* __restrict__ out, size_t m, int nchunks) {
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < m;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float acc = 0.f;
    for (int c = 0; c < nchunks; ++c) acc += partial[static_cast<size_t>(c) * m + i];
    out[i] = acc;
  }
}

void launch_sum(const float* partial, float* out, size_t m, int nchunks,
                cudaStream_t stream) {
  const size_t want = (m + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < 65535 ? (want > 0 ? want : 1) : 65535);
  sum_chunks_kernel<<<blocks, kThreads, 0, stream>>>(partial, out, m, nchunks);
}

}  // namespace

extern "C" {

// bin_kind: 0 = uint8 bins, 1 = int32 bins. mask may be null (all rows kept).
// partial holds nchunks * d * B * 3 floats, out d * B * 3. Returns
// cudaGetLastError() after both launches (0 = launched).
int mmlspark_plane_hist(const void* bins, int bin_kind, const float* stats,
                        const float* mask, float* partial, float* out, int n, int d,
                        int B, int fb, int nchunks, int rows_per_chunk,
                        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((d + fb - 1) / fb, nchunks);
  if (bin_kind == 0) {
    plane_hist_kernel<uint8_t><<<grid, kThreads, 0, st>>>(
        static_cast<const uint8_t*>(bins), stats, mask, partial, n, d, B, fb,
        rows_per_chunk);
  } else {
    plane_hist_kernel<int32_t><<<grid, kThreads, 0, st>>>(
        static_cast<const int32_t*>(bins), stats, mask, partial, n, d, B, fb,
        rows_per_chunk);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  launch_sum(partial, out, static_cast<size_t>(d) * B * 3, nchunks, st);
  return static_cast<int>(cudaGetLastError());
}

// partial holds nchunks * S * d * B * 3 floats, out S * d * B * 3.
int mmlspark_multi_plane_hist(const void* bins, int bin_kind, const float* stats,
                              const int32_t* slot, float* partial, float* out, int n,
                              int d, int B, int S, int fb, int nchunks,
                              int rows_per_chunk, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((d + fb - 1) / fb, nchunks, (S + kSlotGroup - 1) / kSlotGroup);
  if (bin_kind == 0) {
    multi_plane_hist_kernel<uint8_t><<<grid, kThreads, 0, st>>>(
        static_cast<const uint8_t*>(bins), stats, slot, partial, n, d, B, S, fb,
        rows_per_chunk);
  } else {
    multi_plane_hist_kernel<int32_t><<<grid, kThreads, 0, st>>>(
        static_cast<const int32_t*>(bins), stats, slot, partial, n, d, B, S, fb,
        rows_per_chunk);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  launch_sum(partial, out, static_cast<size_t>(S) * d * B * 3, nchunks, st);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
