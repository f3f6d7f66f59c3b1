// Hand-written Hopper (sm_90a) kernel k9 of the single-chip reduction
// benchmark, bound to Python with ctypes (tpu_reductions_torch/ops/_cuda.py).
//
// Replaces tpu_reductions/ops/pallas_reduce.py::mxu_call (:240-275,
// pallas_call :209): SUM over float dtypes on the matrix unit. Each TPU
// grid step takes the column sums of its (TM, 128) tile as a one-hot
// (8, TM) @ (TM, 128) product at Precision.HIGHEST and adds them into row 0
// of an (8, 128) accumulator; rows 1-7 stay exactly 0. Here the column sums
// come from warp-level tensor-core products, `mma.sync` with an all-ones A
// operand and a zero C: D[m][n] = sum_k B[k][n], so every row of D carries
// the column sums of the K rows (a slab) held in B.
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
// columns as 16 n-tiles of 8 columns. Lane (g = lane / 4, t = lane % 4)
// owns columns 16g .. 16g + 15, as column n = g of n-tiles j = 0..15, and
// the slab rows that the B fragment gives it (bf16: 2t, 2t+1, 2t+8, 2t+9;
// f32: t, t+4; f64: t). So a lane reads 16 contiguous elements of each of
// its rows with 16-byte loads, and the 8 lanes of one t read whole rows.
// The fragment's c0/c1 of lane (g, t) are columns n = 2t and 2t + 1 of
// n-tile j: data columns 32t + j and 32t + 16 + j. Which slab row lands in
// which k does not matter, since A is all ones.
//
// Warps walk the slabs grid-stride; a block's 8 warps add their column sums
// in warp order into one (128,) partial per block, and a second pass (one
// block, CUDA cores) adds the partials in block order into row 0 of the
// (8, 128) output and writes rows 1-7 as zeros.
//
// Bound: reading every staged byte once, like k6; the tensor cores do one
// multiply-add per element (three for f32), far below their rate.

#include <cstdint>

#include "common.cuh"

namespace {

using namespace tr;

constexpr int WARPS = 8;
constexpr int MXU_THREADS = WARPS * 32;
constexpr int NTILES = LANES / 8;  // 16 n-tiles of 8 columns

template <class T>
struct Mxu;

// Each slab() takes the slab's first row and adds the lane's two columns of
// each n-tile j (D's c0 and c1) into c[j][0] and c[j][1].
template <>
struct Mxu<__nv_bfloat16> {
  using Acc = float;
  static constexpr int K = 16;

  __device__ static void slab(const __nv_bfloat16* base, int g, int t,
                              Acc (&c)[NTILES][2]) {
    const int rows[4] = {2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9};
    uint32_t w[4][8];  // 16 bf16 of each row, two per word
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const uint4* src =
          reinterpret_cast<const uint4*>(base + rows[r] * LANES + 16 * g);
      const uint4 lo = src[0], hi = src[1];
      w[r][0] = lo.x, w[r][1] = lo.y, w[r][2] = lo.z, w[r][3] = lo.w;
      w[r][4] = hi.x, w[r][5] = hi.y, w[r][6] = hi.z, w[r][7] = hi.w;
    }
    constexpr uint32_t ONES = 0x3F803F80u;  // two bf16 1.0
#pragma unroll
    for (int j = 0; j < NTILES; ++j) {
      // column j of the lane's 16: the low half of word j/2 for even j,
      // the high half for odd j; pair the same column of two rows
      const uint32_t sel = (j & 1) ? 0x7632u : 0x5410u;
      const uint32_t b0 = __byte_perm(w[0][j / 2], w[1][j / 2], sel);
      const uint32_t b1 = __byte_perm(w[2][j / 2], w[3][j / 2], sel);
      float d[4] = {0.f, 0.f, 0.f, 0.f};
      asm volatile(
          "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
          "{%0,%1,%2,%3}, {%4,%4,%4,%4}, {%5,%6}, {%0,%1,%2,%3};\n"
          : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
          : "r"(ONES), "r"(b0), "r"(b1));
      c[j][0] += d[0];
      c[j][1] += d[1];
    }
  }
};

__device__ __forceinline__ float tf32_trunc(float x) {
  return __uint_as_float(__float_as_uint(x) & 0xFFFFE000u);
}

// D's c0 and c1 of ones x (b0, b1), from C = 0.
__device__ __forceinline__ float2 mma_tf32(float b0, float b1) {
  constexpr uint32_t ONE = 0x3F800000u;  // 1.0f, exact in TF32
  float d[4] = {0.f, 0.f, 0.f, 0.f};
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%4,%4,%4}, {%5,%6}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(ONE), "r"(__float_as_uint(b0)), "r"(__float_as_uint(b1)));
  return make_float2(d[0], d[1]);
}

template <>
struct Mxu<float> {
  using Acc = float;
  static constexpr int K = 8;

  __device__ static void slab(const float* base, int g, int t,
                              Acc (&c)[NTILES][2]) {
    float x[2][16];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float4* src =
          reinterpret_cast<const float4*>(base + (t + 4 * r) * LANES + 16 * g);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 v = src[q];
        x[r][4 * q] = v.x, x[r][4 * q + 1] = v.y;
        x[r][4 * q + 2] = v.z, x[r][4 * q + 3] = v.w;
      }
    }
#pragma unroll
    for (int j = 0; j < NTILES; ++j) {
      const float hi0 = tf32_trunc(x[0][j]), hi1 = tf32_trunc(x[1][j]);
      const float r0 = x[0][j] - hi0, r1 = x[1][j] - hi1;  // exact
      const float mid0 = tf32_trunc(r0), mid1 = tf32_trunc(r1);
      const float2 hi = mma_tf32(hi0, hi1);
      const float2 mid = mma_tf32(mid0, mid1);
      const float2 lo = mma_tf32(r0 - mid0, r1 - mid1);  // exact, fits TF32
      c[j][0] += hi.x + (mid.x + lo.x);
      c[j][1] += hi.y + (mid.y + lo.y);
    }
  }
};

template <>
struct Mxu<double> {
  using Acc = double;
  static constexpr int K = 4;

  __device__ static void slab(const double* base, int g, int t,
                              Acc (&c)[NTILES][2]) {
    double x[16];
    const double2* src =
        reinterpret_cast<const double2*>(base + t * LANES + 16 * g);
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const double2 v = src[q];
      x[2 * q] = v.x, x[2 * q + 1] = v.y;
    }
    const double one = 1.0;
#pragma unroll
    for (int j = 0; j < NTILES; ++j) {
      double d0 = 0.0, d1 = 0.0;
      asm volatile(
          "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 "
          "{%0,%1}, {%2}, {%3}, {%0,%1};\n"
          : "+d"(d0), "+d"(d1)
          : "d"(one), "d"(x[j]));
      c[j][0] += d0;
      c[j][1] += d1;
    }
  }
};

// Pass 1: block b's column sums of its warps' slabs into partials[b].
template <class T>
__global__ void __launch_bounds__(MXU_THREADS)
mxu_columns(const T* __restrict__ in, typename Mxu<T>::Acc* __restrict__ partials,
            long long slabs) {
  using M = Mxu<T>;
  using Acc = typename M::Acc;
  __shared__ Acc part[WARPS][LANES];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  Acc c[NTILES][2];
#pragma unroll
  for (int j = 0; j < NTILES; ++j) c[j][0] = c[j][1] = Acc(0);
  const long long stride = static_cast<long long>(gridDim.x) * WARPS;
  for (long long s = static_cast<long long>(blockIdx.x) * WARPS + warp;
       s < slabs; s += stride) {
    M::slab(in + s * M::K * LANES, g, t, c);
  }
  if (g == 0) {  // every row of D holds the same sums: take row 0's lanes
#pragma unroll
    for (int j = 0; j < NTILES; ++j) {
      part[warp][32 * t + j] = c[j][0];
      part[warp][32 * t + 16 + j] = c[j][1];
    }
  }
  __syncthreads();
  if (threadIdx.x < LANES) {
    Acc sum = part[0][threadIdx.x];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) sum += part[w][threadIdx.x];
    partials[static_cast<long long>(blockIdx.x) * LANES + threadIdx.x] = sum;
  }
}

// Pass 2, one block of THREADS: row 0 of out = the partials' column sums
// (8 interleaved row sets, added in order), rows 1-7 = 0.
template <class Acc>
__global__ void __launch_bounds__(THREADS)
mxu_finish(const Acc* __restrict__ partials, Acc* __restrict__ out, int blocks) {
  constexpr int SETS = THREADS / LANES;
  __shared__ Acc part[SETS][LANES];
  const int col = threadIdx.x % LANES, set = threadIdx.x / LANES;
  Acc sum = Acc(0);
  for (int b = set; b < blocks; b += SETS) sum += partials[b * LANES + col];
  part[set][col] = sum;
  __syncthreads();
  if (threadIdx.x < LANES) {
    Acc total = part[0][col];
#pragma unroll
    for (int s = 1; s < SETS; ++s) total += part[s][col];
    out[col] = total;
  } else if (threadIdx.x < 8 * LANES) {
    out[threadIdx.x] = Acc(0);
  }
}

template <class T>
cudaError_t k9(const void* in, void* partials, void* out, long long rows,
               int blocks, cudaStream_t stream) {
  using Acc = typename Mxu<T>::Acc;
  mxu_columns<T><<<blocks, MXU_THREADS, 0, stream>>>(
      static_cast<const T*>(in), static_cast<Acc*>(partials), rows / Mxu<T>::K);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  mxu_finish<Acc><<<1, THREADS, 0, stream>>>(static_cast<const Acc*>(partials),
                                             static_cast<Acc*>(out), blocks);
  return cudaGetLastError();
}

}  // namespace

// SUM only, float dtypes only; returns cudaGetLastError() after the
// launches (0 on success), or cudaErrorInvalidValue for another dtype.
// rows must be a multiple of the slab (16 bf16, 8 f32, 4 f64) and `in`
// 16-byte aligned; partials is (blocks, 128) of the accumulator type.
extern "C" int tr_k9_reduce(const void* in, void* partials, void* out,
                            long long rows, int blocks, int dtype,
                            void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case tr::DT_FLOAT32:
      return static_cast<int>(k9<float>(in, partials, out, rows, blocks, s));
    case tr::DT_FLOAT64:
      return static_cast<int>(k9<double>(in, partials, out, rows, blocks, s));
    case tr::DT_BFLOAT16:
      return static_cast<int>(k9<__nv_bfloat16>(in, partials, out, rows, blocks, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
