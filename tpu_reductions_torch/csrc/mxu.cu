// Hand-written Hopper (sm_90a) kernel k9 of the single-chip reduction
// benchmark, bound to Python with ctypes (tpu_reductions_torch/ops/_cuda.py).
//
// Replaces tpu_reductions/ops/pallas_reduce.py::mxu_call (:240-275,
// pallas_call :209): SUM over float dtypes on the matrix unit. Each TPU
// grid step takes the column sums of its (TM, 128) tile as a one-hot
// (8, TM) @ (TM, 128) product at Precision.HIGHEST and adds them into row 0
// of an (8, 128) accumulator; rows 1-7 stay exactly 0. Here the column sums
// come from warp-level tensor-core products, `mma.sync` with the data as
// the A operand (A[m][k] = element k of column m of a slab of K rows), an
// all-ones B and a zero C: D[m][n] = sum_k A[m][k], so every column of D
// carries the sums of the slab's columns. With the data in A, one product
// takes 16 columns (8 for f64) of K rows:
//   bf16  m16n8k16, bf16 inputs, f32 sums: ones x bf16 is exact.
//   f32   m16n8k8 TF32, each element split into three TF32 pieces
//         hi + mid + lo == x exactly (hi: x with the low 13 mantissa bits
//         cleared; mid: the same of x - hi; lo: the rest, at most 2 bits),
//         one product per piece. Plain TF32 would keep about 11 bits; the
//         split keeps all 24, as at HIGHEST precision.
//   f64   m8n8k4 DMMA, f64 sums.
// The tensor cores' f32 additions need not round to nearest (published
// measurements of earlier generations find truncation): fed a large
// running sum as C, they could drop the low bits of every small addend in
// one direction, a bias that would grow with the number of slabs. So each
// product starts from C = 0, where a slab of 11-bit pieces sums exactly
// unless their exponents spread by more than about 11, and the running
// column sums are added on the CUDA cores, which round to nearest.
//
// Layout. A warp takes a slab of K rows (16 bf16, 8 f32, 4 f64) x 128
// columns. Lane (g = lane / 4, t = lane % 4) loads 16 columns of each slab
// row its A fragment names (bf16: 2t, 2t+1, 2t+8, 2t+9; f32: t, t+4; f64:
// t) as 16-byte vectors: vector q of a row is the g-th 16 bytes of that
// row's q-th 128-byte run, so the 8 lanes of one t read 128 contiguous
// bytes with each load instruction and every 32-byte sector fetched is
// used whole. Lane column i (0..15) is then column (i / VEC) * 8 * VEC +
// g * VEC + i % VEC, VEC the elements of 16 bytes. Product j gives fragment
// row g the lane column j and, for bf16 and f32, row g + 8 the lane column
// 8 + j; D's c0 (and c2) of every lane (g, t) then hold those columns'
// sums, and lane (g, 0) keeps them: 16 running sums a lane, lane column i
// in c[i].
//
// Bound: reading every staged byte once, like k6; the tensor cores do one
// multiply-add per element (three for f32), far below their rate. What
// held the parent design back, and what this one does about it:
//   - its lanes read 16 contiguous columns each, so one load instruction
//     touched 32 sectors of 32 bytes and used half of each, and without L1
//     allocation the other half came from L2 again: the coalesced layout
//     above reads every sector whole;
//   - its warps walked the slabs grid-stride (at f32 2^24, 16384 slabs
//     over 2112 warps: 7 or 8 each). Now the warps take equal contiguous
//     runs of `run` slabs (only the last may be shorter), fixed by the
//     shape and the SM count (ops/kernel_reduce.plan_k9): one block of 16
//     warps per SM, one wave. While one warp is in its products the other
//     15 have their loads in flight (a slab is 4 KiB). Keeping the next
//     slab in registers as well was measured slower on an H100
//     (bench/passes.py --sweep): it needs 32 more registers a lane, and at
//     the 128 a thread that 16 warps allow, it spilled;
//   - data in A halves the products of bf16 and f32 (8 a slab, 24 for f32
//     pieces) and the running sums (16 a lane);
//   - a block's 16 warps add their column sums in warp order into one
//     (128,) partial per block; pass 2 spreads the partials' fold over
//     LANES / 16 blocks, 16 columns each (one block took 2.3 us on an
//     H100), and writes rows 1-7 as zeros.
// No float atomics: every add's order is fixed by the shape and the SM
// count, so a tensor gives the same bits on every call.

#include <cstdint>

#include "common.cuh"

namespace {

using namespace tr;

constexpr int WARPS = 16;
constexpr int MXU_THREADS = WARPS * 32;
constexpr int COLS = 16;          // columns of one lane, and its running sums
constexpr int FINISH_COLS = 16;   // columns of one pass-2 block
constexpr int FINISH_LINES = 16;  // threads that fold one column in pass 2

// One lane's part of one slab: eight 16-byte vectors.
struct Slab {
  uint4 v[8];
};

template <class T>
struct Mxu;

template <>
struct Mxu<__nv_bfloat16> {
  using Acc = float;
  static constexpr int K = 16;

  // v[2r + h]: row rows[r], columns 64h + 8g .. + 7.
  __device__ __forceinline__ static void load(const __nv_bfloat16* slab, int g, int t, Slab& s) {
    const int rows[4] = {2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9};
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const uint4* src = reinterpret_cast<const uint4*>(slab + rows[r] * LANES) + g;
      s.v[2 * r] = ld_stream(src);
      s.v[2 * r + 1] = ld_stream(src + 8);
    }
  }

  __device__ __forceinline__ static void fold(const Slab& s, Acc (&c)[COLS]) {
    constexpr uint32_t ONES = 0x3F803F80u;  // two bf16 1.0
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      // lane column j of row r: word j / 2 of v[2r], low half for even j;
      // lane column 8 + j: the same of v[2r + 1]. Pair rows 2t, 2t+1 and
      // 2t+8, 2t+9 of one column into one register, low half first.
      const uint32_t sel = (j & 1) ? 0x7632u : 0x5410u;
      const int w = j / 2;
      const uint32_t a0 = __byte_perm(word(s.v[0], w), word(s.v[2], w), sel);
      const uint32_t a1 = __byte_perm(word(s.v[1], w), word(s.v[3], w), sel);
      const uint32_t a2 = __byte_perm(word(s.v[4], w), word(s.v[6], w), sel);
      const uint32_t a3 = __byte_perm(word(s.v[5], w), word(s.v[7], w), sel);
      float d[4] = {0.f, 0.f, 0.f, 0.f};
      asm volatile(
          "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
          "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%8}, {%0,%1,%2,%3};\n"
          : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
          : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(ONES));
      c[j] += d[0];
      c[8 + j] += d[2];
    }
  }
};

__device__ __forceinline__ float tf32_trunc(float x) {
  return __uint_as_float(__float_as_uint(x) & 0xFFFFE000u);
}

// D's c0 and c2 of (a0..a3) x ones, from C = 0.
__device__ __forceinline__ float2 mma_tf32(float a0, float a1, float a2, float a3) {
  constexpr uint32_t ONE = 0x3F800000u;  // 1.0f, exact in TF32
  float d[4] = {0.f, 0.f, 0.f, 0.f};
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%8}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(__float_as_uint(a0)), "r"(__float_as_uint(a1)),
        "r"(__float_as_uint(a2)), "r"(__float_as_uint(a3)), "r"(ONE));
  return make_float2(d[0], d[2]);
}

template <>
struct Mxu<float> {
  using Acc = float;
  static constexpr int K = 8;

  // v[4r + q]: row t + 4r, columns 32q + 4g .. + 3.
  __device__ __forceinline__ static void load(const float* slab, int g, int t, Slab& s) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const uint4* src = reinterpret_cast<const uint4*>(slab + (t + 4 * r) * LANES) + g;
#pragma unroll
      for (int q = 0; q < 4; ++q) s.v[4 * r + q] = ld_stream(src + 8 * q);
    }
  }

  __device__ __forceinline__ static void fold(const Slab& s, Acc (&c)[COLS]) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      // A fragment: a0 (row g, k t), a1 (row g + 8, k t), a2 (row g, k t+4),
      // a3 (row g + 8, k t+4): lane columns j and 8 + j of rows t and t + 4
      const float x[4] = {__uint_as_float(word(s.v[j / 4], j % 4)),
                          __uint_as_float(word(s.v[2 + j / 4], j % 4)),
                          __uint_as_float(word(s.v[4 + j / 4], j % 4)),
                          __uint_as_float(word(s.v[6 + j / 4], j % 4))};
      float hi[4], mid[4], lo[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        hi[e] = tf32_trunc(x[e]);
        const float r = x[e] - hi[e];  // exact
        mid[e] = tf32_trunc(r);
        lo[e] = r - mid[e];            // exact, fits TF32
      }
      const float2 h = mma_tf32(hi[0], hi[1], hi[2], hi[3]);
      const float2 m = mma_tf32(mid[0], mid[1], mid[2], mid[3]);
      const float2 l = mma_tf32(lo[0], lo[1], lo[2], lo[3]);
      c[j] += h.x + (m.x + l.x);
      c[8 + j] += h.y + (m.y + l.y);
    }
  }
};

template <>
struct Mxu<double> {
  using Acc = double;
  static constexpr int K = 4;

  // v[q]: row t, columns 16q + 2g, + 1.
  __device__ __forceinline__ static void load(const double* slab, int g, int t, Slab& s) {
    const uint4* src = reinterpret_cast<const uint4*>(slab + t * LANES) + g;
#pragma unroll
    for (int q = 0; q < 8; ++q) s.v[q] = ld_stream(src + 8 * q);
  }

  __device__ __forceinline__ static void fold(const Slab& s, Acc (&c)[COLS]) {
    const double one = 1.0;
#pragma unroll
    for (int j = 0; j < COLS; ++j) {
      // A fragment: a0 (row g, k t), lane column j of row t
      const double a = lane(s.v[j / 2], j % 2, double());
      double d0 = 0.0, d1 = 0.0;
      asm volatile(
          "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 "
          "{%0,%1}, {%2}, {%3}, {%0,%1};\n"
          : "+d"(d0), "+d"(d1)
          : "d"(a), "d"(one));
      c[j] += d0;
    }
  }
};

// Pass 1: warp w of the grid folds slabs [w * run, min((w + 1) * run,
// slabs)) in order; block b's warps add their column sums in warp order
// into partials[b].
template <class T>
__global__ void __launch_bounds__(MXU_THREADS, 1)
mxu_columns(const T* __restrict__ in, typename Mxu<T>::Acc* __restrict__ partials,
            long long slabs, long long run) {
  using M = Mxu<T>;
  using Acc = typename M::Acc;
  constexpr long long SLAB = static_cast<long long>(M::K) * LANES;
  constexpr int VEC = 16 / sizeof(T);  // elements of one 16-byte vector
  __shared__ Acc part[WARPS][LANES];
  const int warp = threadIdx.x / 32, lane_id = threadIdx.x % 32;
  const int g = lane_id / 4, t = lane_id % 4;
  Acc c[COLS];
#pragma unroll
  for (int i = 0; i < COLS; ++i) c[i] = Acc(0);
  const long long first = (static_cast<long long>(blockIdx.x) * WARPS + warp) * run;
  const long long n = first < slabs ? (slabs - first < run ? slabs - first : run) : 0;
  const T* src = in + first * SLAB;
  for (long long i = 0; i < n; ++i) {
    Slab s;
    M::load(src + i * SLAB, g, t, s);
    M::fold(s, c);
  }
  if (t == 0) {
#pragma unroll
    for (int i = 0; i < COLS; ++i) part[warp][i / VEC * 8 * VEC + g * VEC + i % VEC] = c[i];
  }
  __syncthreads();
  if (threadIdx.x < LANES) {
    Acc sum = part[0][threadIdx.x];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) sum += part[w][threadIdx.x];
    partials[static_cast<long long>(blockIdx.x) * LANES + threadIdx.x] = sum;
  }
}

// Pass 2, LANES / FINISH_COLS blocks: block b folds columns 16b .. 16b + 15
// of the partials. Thread (q, c) adds column c of partials q, q + LINES, ...
// in order, then line 0 adds the LINES results in order into row 0 of out;
// the block also writes its columns of rows 1-7 as zeros.
template <class Acc>
__global__ void __launch_bounds__(FINISH_COLS * FINISH_LINES)
mxu_finish(const Acc* __restrict__ partials, Acc* __restrict__ out, int blocks) {
  __shared__ Acc line[FINISH_LINES][FINISH_COLS];
  const int c = threadIdx.x % FINISH_COLS, q = threadIdx.x / FINISH_COLS;
  const int col = blockIdx.x * FINISH_COLS + c;
  Acc sum = Acc(0);
#pragma unroll 8
  for (int b = q; b < blocks; b += FINISH_LINES) {
    sum += partials[static_cast<long long>(b) * LANES + col];
  }
  line[q][c] = sum;
  __syncthreads();
  if (q == 0) {
    Acc total = line[0][c];
#pragma unroll
    for (int k = 1; k < FINISH_LINES; ++k) total += line[k][c];
    out[col] = total;
  } else if (q < 8) {
    out[q * LANES + col] = Acc(0);
  }
}

template <class T>
cudaError_t k9(const void* in, void* partials, void* out, long long rows,
               long long run, int blocks, cudaStream_t stream) {
  using Acc = typename Mxu<T>::Acc;
  mxu_columns<T><<<blocks, MXU_THREADS, 0, stream>>>(
      static_cast<const T*>(in), static_cast<Acc*>(partials), rows / Mxu<T>::K, run);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  mxu_finish<Acc><<<LANES / FINISH_COLS, FINISH_COLS * FINISH_LINES, 0, stream>>>(
      static_cast<const Acc*>(partials), static_cast<Acc*>(out), blocks);
  return cudaGetLastError();
}

}  // namespace

// SUM only, float dtypes only; returns cudaGetLastError() after the
// launches (0 on success), or cudaErrorInvalidValue for another dtype or a
// run under one slab. rows must be a multiple of the slab (16 bf16, 8 f32,
// 4 f64) and `in` 16-byte aligned; `blocks` blocks of 16 warps cover the
// slabs in runs of `run`; partials is (blocks, 128) of the accumulator type.
extern "C" int tr_k9_reduce(const void* in, void* partials, void* out,
                            long long rows, long long run, int blocks,
                            int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (run < 1 || blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (dtype) {
    case tr::DT_FLOAT32:
      return static_cast<int>(k9<float>(in, partials, out, rows, run, blocks, s));
    case tr::DT_FLOAT64:
      return static_cast<int>(k9<double>(in, partials, out, rows, run, blocks, s));
    case tr::DT_BFLOAT16:
      return static_cast<int>(
          k9<__nv_bfloat16>(in, partials, out, rows, run, blocks, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
