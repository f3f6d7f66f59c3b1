// Hand-written Hopper (sm_90a) kernel dd of the f64 pair route, bound to
// Python with ctypes (tpu_reductions_torch/ops/_cuda.py).
//
// Replaces tpu_reductions/ops/dd_reduce.py::dd_pallas_call (:250-279,
// kernel _dd_kernel :220-247): a float64 payload staged as two 32-bit
// (rows, 128) planes is folded into a (TM, 128) pair accumulator. SUM folds
// float32 (hi, lo) double-double pairs with Knuth's two-sum and a
// renormalisation (dd_add); MIN/MAX select over int32 order-key pairs,
// compared lexicographically as signed ints, hi first (dd_select). Slot
// (r, c) of the accumulator is the fold, in tile order, of the staged rows
// congruent to r modulo TM of column c, starting from the first tile's pair
// rather than from an identity, as the TPU kernel does (:230-233).
//
// The TPU's sequential grid becomes a loop inside each thread, with k8's
// geometry (csrc/accumulate.cu): the slots are cut into slot groups of 8 x
// 128, one slot per thread of a 1024-thread block, and the tiles into
// `splits` interleaved sets. Block (g, s) folds slot group g over tiles
// s, s + splits, ... into (splits, TM, 128) partial planes (pass 1); pass
// 2 folds the partials over s, in split order, with the same combine. The
// wrapper picks `splits` from the shape alone.
//
// Order: MIN/MAX selections do not depend on it, so the kernel equals the
// plain version (ops/dd_reduce.dd_plain) bit for bit. For SUM, one split
// is dd_plain's order exactly; with more, pass 2 groups the additions
// otherwise, and each slot's hi + lo stays within 2 (d - 1) 4u^2 sum|x| of
// dd_plain's (u = 2^-24, d the tiles folded into the slot), the bound
// chip_smoke.py and the card tests hold it to.
//
// The error-free transformations must stay error-free. They are additions
// only, so FMA contraction cannot touch them, but reassociation and
// flush-to-zero could: every step is written with __fadd_rn/__fsub_rn,
// which nvcc never reassociates or contracts, and the library is built
// without --use_fast_math and with nvcc's default -ftz=false
// (ops/_cuda.NVCC_FLAGS must keep it so). The lo plane of small elements
// holds subnormal floats, and flushing them would change the sum.
//
// Bound: the kernel reads both planes once (8 bytes an element, as much as
// native f64) and writes the small partials; dd_add is about 11 float32
// additions an element, far under the card's rate, so it is bound by
// device-memory bytes. Plain coalesced loads into registers, the tile walk
// unrolled so that several loads per thread are in flight; no shared
// memory.

#include "common.cuh"

namespace {

using namespace tr;

constexpr int SUB = 8;  // rows of one slot group: 8 x 128 = THREADS slots

// s + err == a + b exactly (Knuth's two-sum).
__device__ __forceinline__ void two_sum(float a, float b, float& s, float& err) {
  s = __fadd_rn(a, b);
  const float bb = __fsub_rn(s, a);
  err = __fadd_rn(__fsub_rn(a, __fsub_rn(s, bb)), __fsub_rn(b, bb));
}

struct DdSum {
  using T = float;
  // (hi, lo) += (h2, l2), renormalised: dd_reduce._dd_add step for step.
  __device__ __forceinline__ static void combine(float& hi, float& lo, float h2,
                                                 float l2) {
    float s, e;
    two_sum(hi, h2, s, e);
    e = __fadd_rn(e, __fadd_rn(lo, l2));
    const float h = __fadd_rn(s, e);
    lo = __fsub_rn(e, __fsub_rn(h, s));
    hi = h;
  }
};

template <bool MINIMUM>
struct DdSelect {
  using T = int;
  // Lexicographic min or max of signed key pairs; a tie keeps (hi, lo).
  __device__ __forceinline__ static void combine(int& hi, int& lo, int h2, int l2) {
    const bool take2 = MINIMUM ? (h2 < hi || (h2 == hi && l2 < lo))
                               : (h2 > hi || (h2 == hi && l2 > lo));
    if (take2) {
      hi = h2;
      lo = l2;
    }
  }
};

// Block (g, s) folds slot group g of tiles s, s + splits, ... < tiles of
// the two planes into slot group g of (TM, 128) block s of the outputs.
// Every split holds at least one tile (splits <= tiles).
template <class Op>
__global__ void __launch_bounds__(THREADS)
fold_pairs(const typename Op::T* __restrict__ hi_in,
           const typename Op::T* __restrict__ lo_in, typename Op::T* __restrict__ hi_out,
           typename Op::T* __restrict__ lo_out, long long tiles, long long tm,
           long long splits) {
  static_assert(SUB * LANES == THREADS, "one slot per thread");
  using T = typename Op::T;
  const long long slot = static_cast<long long>(blockIdx.x) * SUB * LANES + threadIdx.x;
  const long long tile_elems = tm * LANES;
  const long long first = blockIdx.y;
  T hi = hi_in[first * tile_elems + slot];
  T lo = lo_in[first * tile_elems + slot];
#pragma unroll 4
  for (long long k = first + splits; k < tiles; k += splits) {
    Op::combine(hi, lo, hi_in[k * tile_elems + slot], lo_in[k * tile_elems + slot]);
  }
  hi_out[first * tile_elems + slot] = hi;
  lo_out[first * tile_elems + slot] = lo;
}

template <class Op>
cudaError_t run(const void* hi, const void* lo, void* part_hi, void* part_lo,
                void* out_hi, void* out_lo, long long tiles, long long tm, int splits,
                cudaStream_t stream) {
  using T = typename Op::T;
  if (tm % SUB != 0 || splits < 1 || splits > tiles) return cudaErrorInvalidValue;
  const unsigned groups = static_cast<unsigned>(tm / SUB);
  // pass 1 writes straight into the outputs when there is one split
  void* dst_hi = splits > 1 ? part_hi : out_hi;
  void* dst_lo = splits > 1 ? part_lo : out_lo;
  fold_pairs<Op><<<dim3(groups, static_cast<unsigned>(splits)), THREADS, 0, stream>>>(
      static_cast<const T*>(hi), static_cast<const T*>(lo), static_cast<T*>(dst_hi),
      static_cast<T*>(dst_lo), tiles, tm, splits);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  // pass 2: the partials are `splits` tiles, folded in order by one split
  fold_pairs<Op><<<dim3(groups, 1), THREADS, 0, stream>>>(
      static_cast<const T*>(part_hi), static_cast<const T*>(part_lo),
      static_cast<T*>(out_hi), static_cast<T*>(out_lo), splits, tm, 1);
  return cudaGetLastError();
}

}  // namespace

// Returns cudaGetLastError() after its launches: 0 on success. `op` is
// ops/_cuda.OP_CODES: SUM takes float32 planes, MIN and MAX int32 keys.
extern "C" int tr_dd_reduce(const void* hi, const void* lo, void* part_hi,
                            void* part_lo, void* out_hi, void* out_lo,
                            long long tiles, long long tm, int splits, int op,
                            void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (op) {
    case tr::OP_SUM:
      return run<DdSum>(hi, lo, part_hi, part_lo, out_hi, out_lo, tiles, tm, splits, s);
    case tr::OP_MIN:
      return run<DdSelect<true>>(hi, lo, part_hi, part_lo, out_hi, out_lo, tiles, tm,
                                 splits, s);
    case tr::OP_MAX:
      return run<DdSelect<false>>(hi, lo, part_hi, part_lo, out_hi, out_lo, tiles, tm,
                                  splits, s);
    default:
      return cudaErrorInvalidValue;
  }
}
