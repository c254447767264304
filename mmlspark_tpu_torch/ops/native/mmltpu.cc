// Native host kernels for mmlspark_tpu_torch (a copy of the JAX package's
// mmlspark_tpu/ops/native/mmltpu.cc; the port builds its own).
//
// The reference ships its native engines as prebuilt JNI jars
// (build.sbt:32-39); this library is the equivalent host-side native layer
// for the TPU framework: hot host loops (hashing, CSV parsing, feature
// binning) that feed device programs. Built by ops/native_loader.py with
// g++ -O3.

#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <locale.h>
#include <string>
#include <thread>
#include <vector>

static inline uint32_t rotl32(uint32_t x, int8_t r) {
  return (x << r) | (x >> (32 - r));
}

static inline uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85ebca6b;
  h ^= h >> 13;
  h *= 0xc2b2ae35;
  h ^= h >> 16;
  return h;
}

// Canonical MurmurHash3_x86_32.
static uint32_t murmur3_32(const uint8_t* data, int32_t len, uint32_t seed) {
  const int nblocks = len / 4;
  uint32_t h1 = seed;
  const uint32_t c1 = 0xcc9e2d51;
  const uint32_t c2 = 0x1b873593;

  const uint32_t* blocks = (const uint32_t*)(data);
  for (int i = 0; i < nblocks; i++) {
    uint32_t k1;
    memcpy(&k1, blocks + i, 4);
    k1 *= c1;
    k1 = rotl32(k1, 15);
    k1 *= c2;
    h1 ^= k1;
    h1 = rotl32(h1, 13);
    h1 = h1 * 5 + 0xe6546b64;
  }

  const uint8_t* tail = data + nblocks * 4;
  uint32_t k1 = 0;
  switch (len & 3) {
    case 3: k1 ^= tail[2] << 16; [[fallthrough]];
    case 2: k1 ^= tail[1] << 8; [[fallthrough]];
    case 1:
      k1 ^= tail[0];
      k1 *= c1;
      k1 = rotl32(k1, 15);
      k1 *= c2;
      h1 ^= k1;
  }

  h1 ^= (uint32_t)len;
  return fmix32(h1);
}

static int n_threads_for(int64_t work) {
  unsigned hw = std::thread::hardware_concurrency();
  if (hw == 0) hw = 4;
  int64_t by_work = work / 16384;  // don't spawn threads for tiny jobs
  if (by_work < 1) by_work = 1;
  return (int)(by_work < (int64_t)hw ? by_work : (int64_t)hw);
}

extern "C" {

void mml_murmur3_batch(const char** strings, const int32_t* lengths,
                       int64_t n, uint32_t seed, uint32_t* out) {
  for (int64_t i = 0; i < n; i++) {
    out[i] = murmur3_32((const uint8_t*)strings[i], lengths[i], seed);
  }
}

// Feature binning (LightGBM BinMapper.transform hot loop): for each cell,
// out = 1 + (# edges < value), NaN -> 0 (missing bin). `edges` is the
// concatenation of per-feature ascending edge arrays; `edge_offsets` has
// d+1 entries delimiting them. Row-major x (n, d), threads split rows.
void mml_bin_features(const float* x, int64_t n, int64_t d,
                      const double* edges, const int64_t* edge_offsets,
                      uint8_t* out) {
  auto worker = [&](int64_t lo, int64_t hi) {
    for (int64_t r = lo; r < hi; r++) {
      const float* row = x + r * d;
      uint8_t* orow = out + r * d;
      for (int64_t f = 0; f < d; f++) {
        float v = row[f];
        if (std::isnan(v)) {
          orow[f] = 0;
          continue;
        }
        const double* e = edges + edge_offsets[f];
        int64_t m = edge_offsets[f + 1] - edge_offsets[f];
        // branchless-ish binary search: first index with e[idx] >= v
        int64_t lo_i = 0, hi_i = m;
        while (lo_i < hi_i) {
          int64_t mid = (lo_i + hi_i) >> 1;
          if (e[mid] < (double)v) lo_i = mid + 1; else hi_i = mid;
        }
        orow[f] = (uint8_t)(lo_i + 1);
      }
    }
  };
  int t = n_threads_for(n * d);
  if (t <= 1) {
    worker(0, n);
    return;
  }
  std::vector<std::thread> threads;
  int64_t chunk = (n + t - 1) / t;
  for (int i = 0; i < t; i++) {
    int64_t lo = i * chunk, hi = lo + chunk;
    if (lo >= n) break;
    if (hi > n) hi = n;
    threads.emplace_back(worker, lo, hi);
  }
  for (auto& th : threads) th.join();
}

// C-locale handle so float parsing ignores the process's LC_NUMERIC.
static locale_t c_locale() {
  static locale_t loc = newlocale(LC_ALL_MASK, "C", (locale_t)0);
  return loc;
}

// Parse one bounded field [fs, fe) as a double; whitespace-only or
// non-numeric -> NaN. Copies into a stack buffer (heap for over-long
// fields) so strtod can never walk past the field (newlines, next row)
// and long numeric literals parse exactly like the Python fallback.
// strtod accepted a prefix; the whole field must be consumed (bar
// trailing whitespace) or it's not a number — matches float() semantics.
static inline bool only_ws_after(const char* p) {
  while (*p == ' ' || *p == '\t' || *p == '\r') p++;
  return *p == '\0';
}

static double parse_field(const char* fs, const char* fe) {
  char buf[64];
  size_t flen = (size_t)(fe - fs);
  if (flen == 0) return NAN;
  char* fend = nullptr;
  if (flen < sizeof(buf)) {
    memcpy(buf, fs, flen);
    buf[flen] = '\0';
    double v = strtod_l(buf, &fend, c_locale());
    if (fend == buf || !only_ws_after(fend)) return NAN;
    return v;
  }
  std::string big(fs, flen);
  double v = strtod_l(big.c_str(), &fend, c_locale());
  if (fend == big.c_str() || !only_ws_after(fend)) return NAN;
  return v;
}

static inline bool is_ws(char ch) { return ch == ' ' || ch == '\t' || ch == '\r'; }

// Numeric CSV parse: comma-separated float rows, '\n' terminated. Empty or
// unparseable fields become NaN; whitespace-only lines are skipped (matching
// mml_csv_dims). Returns rows actually parsed; the caller sizes `out` as
// n_rows * n_cols from a prior mml_csv_dims call.
int64_t mml_parse_csv(const char* buf, int64_t len, int64_t n_cols,
                      double* out, int64_t max_rows) {
  int64_t row = 0;
  const char* p = buf;
  const char* end = buf + len;
  while (p < end && row < max_rows) {
    // skip whitespace-only lines
    const char* probe = p;
    while (probe < end && is_ws(*probe)) probe++;
    if (probe < end && *probe == '\n') {
      p = probe + 1;
      continue;
    }
    if (probe >= end) break;
    double* orow = out + row * n_cols;
    for (int64_t c = 0; c < n_cols; c++) {
      if (p >= end || *p == '\n') {
        orow[c] = NAN;  // short row: pad
        continue;
      }
      const char* fs = p;
      while (p < end && *p != ',' && *p != '\n') p++;
      const char* fe = p;
      while (fe > fs && is_ws(fe[-1])) fe--;  // trim trailing \r / spaces
      orow[c] = parse_field(fs, fe);
      if (p < end && *p == ',') p++;
    }
    // consume to end of line (extra fields beyond n_cols are dropped)
    while (p < end && *p != '\n') p++;
    if (p < end) p++;
    row++;
  }
  return row;
}

// Count rows (lines with non-whitespace content) and columns (commas in the
// first data line + 1).
void mml_csv_dims(const char* buf, int64_t len, int64_t* n_rows,
                  int64_t* n_cols) {
  int64_t rows = 0, cols = 1;
  bool first_line = true, line_has_data = false;
  for (int64_t i = 0; i < len; i++) {
    char ch = buf[i];
    if (ch == '\n') {
      if (line_has_data) {
        rows++;
        first_line = false;
      }
      line_has_data = false;
    } else if (!is_ws(ch)) {
      line_has_data = true;
      if (first_line && ch == ',') cols++;
    }
  }
  if (line_has_data) rows++;
  *n_rows = rows;
  *n_cols = cols;
}

}  // extern "C"
