// Hand-written Hopper (sm_90a) kernels of the single-chip reduction
// benchmark, bound to Python with ctypes (tpu_reductions_torch/ops/_cuda.py).
//
// Replaces two TPU kernels of the JAX package:
//   k6  tpu_reductions/ops/pallas_reduce.py::single_pass_call
//       (pallas_call at :209 via _accumulator_call, kernel :182-201,
//       fold _tile_to_sublane :167-179);
//   k7  tpu_reductions/ops/pallas_reduce.py::two_pass_call
//       (kernel _two_pass_kernel :364-387), relaunched by _multipass_finish.
//
// Both read a staged (rows, 128) array, identity-padded so that rows is a
// multiple of SUB (8 rows; 16 for bf16), and fill accumulator slots that are
// defined independently of the launch geometry: slot (r, c) of a (SUB, 128)
// block is the combine, over the rows that block covers and that are
// congruent to r modulo SUB, of column c. k6 covers every row in one
// (SUB, 128) block; k7 block i covers rows [i*span, (i+1)*span). So the
// number of blocks is free, and int32 and MIN/MAX results equal the JAX
// kernels' accumulators element by element.
//
// Bound: each kernel reads every staged byte once and writes a few KiB, so
// both are bound by device-memory bytes (rows * 128 * itemsize over the
// card's bandwidth), never by arithmetic. What the design does about it:
// every thread owns fixed slots and walks SUB-row groups, so one warp load
// is 32 neighbouring elements of one row (coalesced); the row walk is
// unrolled so that several loads per thread are in flight; there is no
// shared memory, no atomic and no barrier. k6 launches two blocks per SM
// with a grid-stride walk, then one block folds their partials. k7 keeps the
// reference's shape (P blocks, each its own T*TM rows), so at the default
// P = 64 it occupies fewer than the H100's 132 SMs.

#include "common.cuh"

namespace {

using namespace tr;

// Block b folds the SUB-row groups that start at rows b*block_step,
// b*block_step + stride, ... below min(rows, b*block_step + block_rows)
// into (SUB, 128) block b of `out`. Thread t owns the elements
// t + s*THREADS of each group, which are slot (row, column) of the block.
template <int OP, class T, class O, int SUB>
__global__ void __launch_bounds__(THREADS)
fold_rows(const T* __restrict__ in, O* __restrict__ out, long long rows,
          long long block_step, long long block_rows, long long stride) {
  using R = decltype(widen(T()));
  constexpr int SLOTS = SUB * LANES / THREADS;  // 1, or 2 for bf16
  static_assert(SLOTS * THREADS == SUB * LANES, "a block owns whole slots");
  const long long first = static_cast<long long>(blockIdx.x) * block_step;
  const long long end = first + block_rows < rows ? first + block_rows : rows;
  R acc[SLOTS];
#pragma unroll
  for (int s = 0; s < SLOTS; ++s) acc[s] = identity<OP, R>();
#pragma unroll 4
  for (long long g = first; g < end; g += stride) {
    const T* group = in + g * LANES;
#pragma unroll
    for (int s = 0; s < SLOTS; ++s) {
      acc[s] = combine<OP>(acc[s], widen(group[threadIdx.x + s * THREADS]));
    }
  }
  O* dst = out + static_cast<long long>(blockIdx.x) * SUB * LANES;
#pragma unroll
  for (int s = 0; s < SLOTS; ++s) store(dst + threadIdx.x + s * THREADS, acc[s]);
}

// k6: pass 1 walks all rows grid-stride over `blocks` blocks into
// `partials` (blocks*SUB, 128); pass 2, one block, folds those partials
// into `out` (SUB, 128).
struct K6 {
  const void* in;
  void* partials;
  void* out;
  long long rows;
  int blocks;
  cudaStream_t stream;

  template <int OP, class T, class O, int SUB>
  cudaError_t run() const {
    const long long partial_rows = static_cast<long long>(blocks) * SUB;
    fold_rows<OP, T, O, SUB><<<blocks, THREADS, 0, stream>>>(
        static_cast<const T*>(in), static_cast<O*>(partials), rows, SUB, rows,
        partial_rows);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    fold_rows<OP, O, O, SUB><<<1, THREADS, 0, stream>>>(
        static_cast<const O*>(partials), static_cast<O*>(out), partial_rows, 0,
        partial_rows, SUB);
    return cudaGetLastError();
  }
};

// k7: block i folds its contiguous `span` rows into partial block i of
// `out` (blocks*SUB, 128).
struct K7 {
  const void* in;
  void* out;
  long long rows;
  long long span;
  int blocks;
  cudaStream_t stream;

  template <int OP, class T, class O, int SUB>
  cudaError_t run() const {
    fold_rows<OP, T, O, SUB><<<blocks, THREADS, 0, stream>>>(
        static_cast<const T*>(in), static_cast<O*>(out), rows, span, span, SUB);
    return cudaGetLastError();
  }
};

}  // namespace

// Each returns cudaGetLastError() after its launches: 0 on success.
extern "C" int tr_k6_reduce(const void* in, void* partials, void* out,
                            long long rows, int blocks, int op, int dtype,
                            void* stream) {
  const K6 launch{in, partials, out, rows, blocks,
                  static_cast<cudaStream_t>(stream)};
  return static_cast<int>(tr::by_op(op, dtype, launch));
}

extern "C" int tr_k7_reduce(const void* in, void* out, long long rows,
                            long long span, int blocks, int op, int dtype,
                            void* stream) {
  const K7 launch{in, out, rows, span, blocks, static_cast<cudaStream_t>(stream)};
  return static_cast<int>(tr::by_op(op, dtype, launch));
}
