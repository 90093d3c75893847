// Native host-side runtime: fast point-cloud file parsing and parallel batch
// assembly for the input pipeline.
//
// The reference delegates its host-side data work to torch DataLoader worker
// *processes* (Generation/model.py:211-212) and numpy text parsing
// (np.loadtxt of template/balls/*.xyz, model.py:159). Here the equivalents
// are C++ with a plain C ABI, bound via ctypes (no pybind11 in the image):
//
//   spgan_parse_xyz      mmap-free buffered float parser, ~20x np.loadtxt
//   spgan_assemble_batch multithreaded gather + per-item point shuffle
//                        (Fisher-Yates, per-thread xorshift RNG) — the
//                        H5DataLoader.__getitem__ hot loop (:111-113)
//                        without Python or pickle in the path.
//
// Built by sp_gan_tpu_torch/native/__init__.py on first use:
//   g++ -O3 -shared -fPIC -std=c++17 -o libspgan_native_<hash>.so spgan_native.cpp -lpthread
// into build/sp_gan_tpu_torch/ at the repository root.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------- xyz parse
// Parses whitespace-separated floats, `cols` leading columns per line, into
// out[max_rows * cols]. Returns rows parsed, or -1 on open failure.
int64_t spgan_parse_xyz(const char* path, float* out, int64_t max_rows,
                        int32_t cols) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  fseek(f, 0, SEEK_END);
  long size = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::vector<char> buf(size + 1);
  size_t got = fread(buf.data(), 1, size, f);
  fclose(f);
  buf[got] = '\0';

  const char* p = buf.data();
  const char* end = p + got;
  int64_t row = 0;
  while (p < end && row < max_rows) {
    // skip leading whitespace / newlines
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\r' || *p == '\n'))
      ++p;
    if (p >= end) break;
    int32_t c = 0;
    for (; c < cols; ++c) {
      char* next = nullptr;
      float v = strtof(p, &next);
      if (next == p) break;  // malformed
      out[row * cols + c] = v;
      p = next;
      while (p < end && (*p == ' ' || *p == '\t')) ++p;
    }
    if (c < cols) break;
    // skip rest of line (extra columns)
    while (p < end && *p != '\n') ++p;
    ++row;
  }
  return row;
}

// ---------------------------------------------------------------- batch asm
static inline uint64_t xorshift64(uint64_t* s) {
  uint64_t x = *s;
  x ^= x << 13;
  x ^= x >> 7;
  x ^= x << 17;
  return *s = x;
}

// Gather items data[idx[i]] -> out[i], shuffling point order per item.
// data: [n_items, n_points, 3] float32; idx: [bs]; out: [bs, n_points, 3].
void spgan_assemble_batch(const float* data, int64_t n_items,
                          int64_t n_points, const int64_t* idx, int64_t bs,
                          uint64_t seed, int32_t n_threads, float* out) {
  if (n_threads < 1) n_threads = 1;
  auto work = [&](int64_t lo, int64_t hi, uint64_t tseed) {
    std::vector<int32_t> perm(n_points);
    uint64_t rng = tseed ? tseed : 0x9E3779B97F4A7C15ull;
    for (int64_t i = lo; i < hi; ++i) {
      const float* src = data + idx[i] * n_points * 3;
      float* dst = out + i * n_points * 3;
      for (int64_t j = 0; j < n_points; ++j) perm[j] = (int32_t)j;
      for (int64_t j = n_points - 1; j > 0; --j) {  // Fisher-Yates
        int64_t r = (int64_t)(xorshift64(&rng) % (uint64_t)(j + 1));
        int32_t t = perm[j];
        perm[j] = perm[r];
        perm[r] = t;
      }
      for (int64_t j = 0; j < n_points; ++j) {
        const float* s = src + perm[j] * 3;
        dst[j * 3 + 0] = s[0];
        dst[j * 3 + 1] = s[1];
        dst[j * 3 + 2] = s[2];
      }
    }
  };
  if (n_threads == 1 || bs < 4) {
    work(0, bs, seed | 1);
    return;
  }
  std::vector<std::thread> threads;
  int64_t chunk = (bs + n_threads - 1) / n_threads;
  for (int32_t t = 0; t < n_threads; ++t) {
    int64_t lo = t * chunk, hi = lo + chunk < bs ? lo + chunk : bs;
    if (lo >= hi) break;
    threads.emplace_back(work, lo, hi, (seed + 0x632BE59BD9B4E019ull * (t + 1)) | 1);
  }
  for (auto& th : threads) th.join();
}

// ---------------------------------------------------------------- save xyz
// Writes rows of `cols` floats with 6 decimals; returns rows written.
int64_t spgan_save_xyz(const char* path, const float* data, int64_t rows,
                       int32_t cols) {
  FILE* f = fopen(path, "wb");
  if (!f) return -1;
  std::vector<char> buf(1 << 20);
  setvbuf(f, buf.data(), _IOFBF, buf.size());
  for (int64_t r = 0; r < rows; ++r) {
    for (int32_t c = 0; c < cols; ++c)
      fprintf(f, c + 1 == cols ? "%.6f" : "%.6f ", data[r * cols + c]);
    fputc('\n', f);
  }
  fclose(f);
  return rows;
}

}  // extern "C"
