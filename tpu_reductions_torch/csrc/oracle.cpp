// Native host oracle and payload filler of tpu_reductions_torch: the
// port's own copy of the JAX package's csrc/oracle.cpp, the same code, so
// both packages fill and verify the same payload for a seed. Kahan-
// compensated sums for reals (threaded for large payloads), a wrapping
// int32 sum, linear min/max scans, and the std::mt19937 filler.
//
// Built by g++ at first use into tpu_reductions_torch/_build/liboracle.so
// (tpu_reductions_torch/ops/_native.py) and loaded with ctypes
// (tpu_reductions_torch/ops/oracle.py). Every entry point is extern "C"
// with a flat pointer + length signature. No -ffast-math: nothing may
// reassociate the compensated sums.

#include <algorithm>
#include <cstdint>
#include <limits>
#include <random>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Kahan-compensated sums (the float/double oracle; reduction.cpp:214-227
// uses the same compensation so the oracle stays accurate at n = 2^24).
// ---------------------------------------------------------------------------

double oracle_kahan_sum_f32(const float* data, int64_t n) {
  double sum = 0.0, c = 0.0;
  for (int64_t i = 0; i < n; ++i) {
    double y = static_cast<double>(data[i]) - c;
    double t = sum + y;
    c = (t - sum) - y;
    sum = t;
  }
  return sum;
}

double oracle_kahan_sum_f64(const double* data, int64_t n) {
  double sum = 0.0, c = 0.0;
  for (int64_t i = 0; i < n; ++i) {
    double y = data[i] - c;
    double t = sum + y;
    c = (t - sum) - y;
    sum = t;
  }
  return sum;
}

// int32 sum with two's-complement wraparound, matching the device's int32
// accumulator (XLA int32 reduce wraps; so did the reference's int path,
// reduction.cpp:748,776-777). Unsigned arithmetic avoids UB.
int32_t oracle_sum_i32(const int32_t* data, int64_t n) {
  uint32_t acc = 0;
  for (int64_t i = 0; i < n; ++i) acc += static_cast<uint32_t>(data[i]);
  return static_cast<int32_t>(acc);
}

// ---------------------------------------------------------------------------
// Linear min/max scans (reduction.cpp:228-249 analog).
// ---------------------------------------------------------------------------

#define DEFINE_MINMAX(SUFFIX, T)                                     \
  T oracle_min_##SUFFIX(const T* data, int64_t n) {                  \
    T best = data[0];                                                \
    for (int64_t i = 1; i < n; ++i)                                  \
      if (data[i] < best) best = data[i];                            \
    return best;                                                     \
  }                                                                  \
  T oracle_max_##SUFFIX(const T* data, int64_t n) {                  \
    T best = data[0];                                                \
    for (int64_t i = 1; i < n; ++i)                                  \
      if (data[i] > best) best = data[i];                            \
    return best;                                                     \
  }

DEFINE_MINMAX(i32, int32_t)
DEFINE_MINMAX(f32, float)
DEFINE_MINMAX(f64, double)
#undef DEFINE_MINMAX

}  // extern "C" (templates below need C++ linkage)

// ---------------------------------------------------------------------------
// Threaded oracles — native threads put to the one real use they have
// here: large-payload host verification. (The reference vendored a
// pthreads wrapper, cutil multithreading, that the benchmark linked but
// never invoked — SURVEY.md §2.3.)
// ---------------------------------------------------------------------------

template <typename T>
static double kahan_chunk(const T* data, int64_t n) {
  double sum = 0.0, c = 0.0;
  for (int64_t i = 0; i < n; ++i) {
    double y = static_cast<double>(data[i]) - c;
    double t = sum + y;
    c = (t - sum) - y;
    sum = t;
  }
  return sum;
}

template <typename T>
static double kahan_sum_mt(const T* data, int64_t n, int nthreads) {
  if (nthreads < 2 || n < nthreads * 4096) return kahan_chunk(data, n);
  std::vector<double> partial(nthreads, 0.0);
  std::vector<std::thread> threads;
  const int64_t chunk = (n + nthreads - 1) / nthreads;
  for (int t = 0; t < nthreads; ++t) {
    const int64_t lo = t * chunk;
    const int64_t len = std::min<int64_t>(chunk, n - lo);
    if (len <= 0) break;
    threads.emplace_back(
        [&partial, data, lo, len, t] { partial[t] = kahan_chunk(data + lo, len); });
  }
  for (auto& th : threads) th.join();
  // combine the per-thread partials with one more compensated pass
  return kahan_chunk(partial.data(), static_cast<int64_t>(partial.size()));
}

extern "C" {

double oracle_kahan_sum_f32_mt(const float* data, int64_t n, int nthreads) {
  return kahan_sum_mt(data, n, nthreads);
}

double oracle_kahan_sum_f64_mt(const double* data, int64_t n, int nthreads) {
  return kahan_sum_mt(data, n, nthreads);
}

int oracle_hw_threads(void) {
  unsigned hc = std::thread::hardware_concurrency();
  return hc == 0 ? 1 : static_cast<int>(hc);
}

// ---------------------------------------------------------------------------
// MT19937 payload generation (externalfunctions.h analog, via std::mt19937).
// Fills the same masked-byte distributions the drivers use
// (reduction.cpp:698-705): ints in [0,255]; reals byte/RAND_MAX.
// ---------------------------------------------------------------------------

static std::mt19937 make_engine(uint32_t rank, uint32_t seed) {
  // Rank-offset seeding discipline (reduce.c:38-41 analog).
  std::seed_seq seq{0x1571u + rank + seed, 0x2662u, 0x3753u, 0x4844u};
  return std::mt19937(seq);
}

void oracle_fill_i32(int32_t* out, int64_t n, uint32_t rank, uint32_t seed) {
  std::mt19937 eng = make_engine(rank, seed);
  for (int64_t i = 0; i < n; ++i)
    out[i] = static_cast<int32_t>(eng() & 0xFFu);
}

void oracle_fill_f32(float* out, int64_t n, uint32_t rank, uint32_t seed) {
  std::mt19937 eng = make_engine(rank, seed);
  const float inv = 1.0f / 2147483647.0f;  // 1/RAND_MAX
  for (int64_t i = 0; i < n; ++i)
    out[i] = static_cast<float>(eng() & 0xFFu) * inv;
}

void oracle_fill_f64(double* out, int64_t n, uint32_t rank, uint32_t seed) {
  std::mt19937 eng = make_engine(rank, seed);
  const double inv = 1.0 / 2147483647.0;
  for (int64_t i = 0; i < n; ++i)
    out[i] = static_cast<double>(eng() & 0xFFu) * inv;
}

}  // extern "C"
