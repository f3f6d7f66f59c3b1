// Hand-written Hopper (sm_90a) kernel dd of the f64 pair route, with the
// pair finish on the card, bound to Python with ctypes
// (tpu_reductions_torch/ops/_cuda.py).
//
// Replaces tpu_reductions/ops/dd_reduce.py::dd_pallas_call (:250-279,
// kernel _dd_kernel :220-247) and, fused behind it, the halving tree that
// the JAX package's jitted core runs after it (device_finish_pairs
// :287-333, core :429-433). A float64 payload staged as two 32-bit
// (rows, 128) planes is folded into a (TM, 128) pair accumulator; SUM
// folds float32 (hi, lo) double-double pairs with Knuth's two-sum and a
// renormalisation (dd_add), MIN/MAX select over int32 order-key pairs,
// compared lexicographically as signed ints, hi first (dd_select). Slot
// (r, c) of the accumulator is the fold, in tile order, of the staged rows
// congruent to r modulo TM of column c, starting from the first tile's pair
// rather than from an identity, as the TPU kernel does (:230-233). Then the
// accumulator, flattened to S = TM * 128 pairs and padded to P = 2^L with
// the method's pad pair, folds to one scalar pair by the JAX tree: at each
// level index i combines with i + half, for i < half.
//
// Bound: the planes are read once (8 bytes an element, as much as native
// f64) and dd_add is about 11 float32 additions an element, far under the
// card's rate: bound by device-memory bytes. The design:
//   - Pass 1 (fold_tiles) reads both planes with 16-byte
//     ld.global.nc.L1::no_allocate loads. A CTA is one team of 256
//     threads over one 8 x 128 slot group; thread t owns the four
//     consecutive slots of 16-byte vector t of the group, in both planes,
//     so a warp load is 512 contiguous bytes. The CTAs of grid (TM / 8,
//     splits) fold the tiles s, s + splits, ... of their group in
//     increasing order, 8 tiles a step: 16 loads of 16 bytes a thread,
//     64 KiB a CTA in flight. ops/dd_reduce.plan_dd picks `splits` so
//     that the grid is about two CTAs per SM. Each CTA writes its partial
//     and takes an integer ticket of its group (atomicAdd after
//     __threadfence, no float atomics); the last CTA of the group folds
//     the group's `splits` partials in split order into the accumulator.
//     So the accumulator (dd_call) is one launch.
//   - Pass 2 (finish_pairs) runs the tree. After the top L - m levels of
//     the tree, index r < 2^m holds the halving tree of the indices
//     congruent to r modulo 2^m, so thread r of its 2^m / 256 CTAs loads
//     its J = 2^(L - m) leaves r + j 2^m of the accumulator (consecutive
//     threads read consecutive slots; slots past S are the pad pair),
//     folds them in registers and writes one pair. A ticket picks the last
//     CTA to finish, which folds the 2^m pairs the same way: in registers,
//     through shared memory down to 32, then with warp shuffles, and
//     writes the scalar pair. Pass 2 is a programmatic dependent launch of
//     pass 1 (Hopper's griddepcontrol): its CTAs are resident and waiting
//     when pass 1 ends, which saved about 1 us against a plain launch;
//     a third launch of one CTA for the last levels, instead of the
//     ticket, was slower still (PERF.md). bench/passes.py --sweep times
//     other geometries than the planner's.
//   - The tickets live in a buffer of the stream's own, which k8 shares
//     (ops/kernel_reduce._tickets, one per device and stream), zero when
//     a launch starts (last_to_finish, csrc/common.cuh): the
//     last CTA of each ticket sets it back to zero. Launches in one stream
//     run one after the other, and two streams never share a buffer.
//
// Order: MIN/MAX selections do not depend on it, so the accumulator equals
// the plain version (ops/dd_reduce.dd_plain) bit for bit. For SUM, one
// split is dd_plain's order exactly; with more, the splits fold in order
// after their tiles, and each slot's hi + lo stays within 2 (d - 1) 4u^2
// sum|x| of dd_plain's (u = 2^-24, d the tiles folded into the slot), the
// bound chip_smoke.py and the card tests hold it to. Which CTA is last
// changes nothing: it folds every split in order. The tree's order is the
// JAX tree's exactly, so the scalar pair equals device_finish_pairs of the
// kernel's own accumulator bit for bit (tests/test_torch_dd.py walks this
// schedule on the host).
//
// The error-free transformations must stay error-free. They are additions
// only, so FMA contraction cannot touch them, but reassociation and
// flush-to-zero could: every step is written with __fadd_rn/__fsub_rn,
// which nvcc never reassociates or contracts, and the library is built
// without --use_fast_math and with nvcc's default -ftz=false
// (ops/_cuda.NVCC_FLAGS must keep it so). The lo plane of small elements
// holds subnormal floats, and flushing them would change the sum.

#include "common.cuh"

namespace {

using namespace tr;

constexpr int SUB = 8;          // rows of one slot group: 8 x 128 slots
constexpr int VEC = 4;          // slots of one thread: one 16-byte vector
constexpr int UNROLL = 8;       // tiles a pass-1 step loads (16 x 16 B)
constexpr int SPLIT_BATCH = 8;  // partials the fold loads before combining
constexpr int MAX_LEAVES = 32;  // J: slots a pass-2 thread takes
constexpr int MAX_TAIL = 32;    // pairs a thread of the last CTA takes
constexpr int WARP = 32;
static_assert(SUB * LANES == VEC * TEAM, "a team covers a slot group");

// s + err == a + b exactly (Knuth's two-sum).
__device__ __forceinline__ void two_sum(float a, float b, float& s, float& err) {
  s = __fadd_rn(a, b);
  const float bb = __fsub_rn(s, a);
  err = __fadd_rn(__fsub_rn(a, __fsub_rn(s, bb)), __fsub_rn(b, bb));
}

struct DdSum {
  using T = float;
  // the pad pair (dd_reduce.pad_pair)
  __device__ static float pad() { return 0.0f; }
  // (hi, lo) += (h2, l2), renormalised: dd_reduce.dd_add step for step.
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
  __device__ static int pad() { return MINIMUM ? INT_MAX : INT_MIN; }
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

__device__ __forceinline__ unsigned bits_of(float v) { return __float_as_uint(v); }
__device__ __forceinline__ unsigned bits_of(int v) { return static_cast<unsigned>(v); }

template <class T>
__device__ __forceinline__ uint4 pack(const T (&v)[VEC]) {
  return make_uint4(bits_of(v[0]), bits_of(v[1]), bits_of(v[2]), bits_of(v[3]));
}

template <class T>
__device__ __forceinline__ void unpack(const uint4& h, const uint4& l, T (&hi)[VEC],
                                       T (&lo)[VEC]) {
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    hi[j] = lane(h, j, T());
    lo[j] = lane(l, j, T());
  }
}

// Fold the vectors of one tile into the thread's four slots.
template <class Op, class T>
__device__ __forceinline__ void fold_vec(T (&hi)[VEC], T (&lo)[VEC], const uint4& h,
                                         const uint4& l) {
#pragma unroll
  for (int j = 0; j < VEC; ++j) Op::combine(hi[j], lo[j], lane(h, j, T()), lane(l, j, T()));
}

// Pass 1: CTA (g, s) folds slot group g of tiles s, s + splits, ... <
// tiles, in increasing order (every split holds at least one tile:
// splits <= tiles). With one split it writes slot group g of the
// accumulator; with more, slot group g of partial s, and the last CTA of
// group g (tickets[g]) folds the group's partials, in split order, into
// the accumulator.
template <class Op>
__global__ void __launch_bounds__(TEAM, 2)
fold_tiles(const uint4* __restrict__ hi_in, const uint4* __restrict__ lo_in,
           uint4* part_hi, uint4* part_lo, uint4* __restrict__ acc_hi,
           uint4* __restrict__ acc_lo, long long tiles, long long tm, long long splits,
           unsigned* tickets) {
  using T = typename Op::T;
  const long long tile_vecs = tm * LANES / VEC;
  const long long off = static_cast<long long>(blockIdx.x) * TEAM + threadIdx.x;
  const long long first = blockIdx.y;
  // pass 2, a programmatic dependent launch, may now take its SMs; it
  // waits for this grid's completion before it reads anything
  asm volatile("griddepcontrol.launch_dependents;");
  T hi[VEC], lo[VEC];
  unpack(ld_stream(hi_in + first * tile_vecs + off),
         ld_stream(lo_in + first * tile_vecs + off), hi, lo);
  long long k = first + splits;
  for (; k + (UNROLL - 1) * splits < tiles; k += UNROLL * splits) {
    uint4 h[UNROLL], l[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      h[u] = ld_stream(hi_in + (k + u * splits) * tile_vecs + off);
      l[u] = ld_stream(lo_in + (k + u * splits) * tile_vecs + off);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) fold_vec<Op>(hi, lo, h[u], l[u]);
  }
  for (; k < tiles; k += splits) {
    fold_vec<Op>(hi, lo, ld_stream(hi_in + k * tile_vecs + off),
                 ld_stream(lo_in + k * tile_vecs + off));
  }
  if (splits == 1) {
    acc_hi[off] = pack(hi);
    acc_lo[off] = pack(lo);
    return;
  }
  part_hi[first * tile_vecs + off] = pack(hi);
  part_lo[first * tile_vecs + off] = pack(lo);
  if (!last_to_finish(tickets + blockIdx.x, static_cast<unsigned>(splits))) return;
  // the group's partials, SPLIT_BATCH at a time, from L2 (other CTAs wrote
  // them), each batch loaded before its combines
  unpack(__ldcg(part_hi + off), __ldcg(part_lo + off), hi, lo);
  for (long long s0 = 1; s0 < splits; s0 += SPLIT_BATCH) {
    uint4 h[SPLIT_BATCH], l[SPLIT_BATCH];
#pragma unroll
    for (int b = 0; b < SPLIT_BATCH; ++b) {
      if (s0 + b < splits) {
        h[b] = __ldcg(part_hi + (s0 + b) * tile_vecs + off);
        l[b] = __ldcg(part_lo + (s0 + b) * tile_vecs + off);
      }
    }
#pragma unroll
    for (int b = 0; b < SPLIT_BATCH; ++b) {
      if (s0 + b < splits) fold_vec<Op>(hi, lo, h[b], l[b]);
    }
  }
  acc_hi[off] = pack(hi);
  acc_lo[off] = pack(lo);
}

// The halving tree of the first `count` pairs of (h, l), count a power of
// two up to MAX: at each level, i combines with i + half. Each level is its
// own instance, so every index is a constant and the pairs stay in
// registers.
template <class Op, int HALF, int MAX, class T>
__device__ __forceinline__ void halve_from(T (&h)[MAX], T (&l)[MAX], int count) {
  if constexpr (HALF >= 1) {
    if (2 * HALF <= count) {
#pragma unroll
      for (int i = 0; i < HALF; ++i) Op::combine(h[i], l[i], h[i + HALF], l[i + HALF]);
    }
    halve_from<Op, HALF / 2>(h, l, count);
  }
}

template <class Op, int MAX, class T>
__device__ __forceinline__ void halve(T (&h)[MAX], T (&l)[MAX], int count) {
  halve_from<Op, MAX / 2>(h, l, count);
}

// The last levels: the `count` pairs (a multiple of TEAM, at most TEAM *
// MAX_TAIL) fold to the scalar pair. Thread t folds t + i TEAM in
// registers, the TEAM results fold in shared memory down to one warp's 32,
// and warp 0 folds those with shuffles; each step the JAX tree's.
template <class Op>
__device__ __forceinline__ void fold_tail(const typename Op::T* tree_hi,
                                          const typename Op::T* tree_lo, int count,
                                          typename Op::T* scalar) {
  using T = typename Op::T;
  __shared__ T sh[TEAM], sl[TEAM];
  const int t = threadIdx.x;
  const int per = count / TEAM;
  T h[MAX_TAIL], l[MAX_TAIL];
#pragma unroll
  for (int i = 0; i < MAX_TAIL; ++i) {
    if (i < per) {
      // L2 only: other CTAs wrote these pairs
      h[i] = __ldcg(tree_hi + t + i * TEAM);
      l[i] = __ldcg(tree_lo + t + i * TEAM);
    }
  }
  halve<Op>(h, l, per);
  sh[t] = h[0];
  sl[t] = l[0];
  __syncthreads();
  for (int half = TEAM / 2; half >= WARP; half /= 2) {
    if (t < half) {
      T a = sh[t], b = sl[t];
      Op::combine(a, b, sh[t + half], sl[t + half]);
      sh[t] = a;
      sl[t] = b;
    }
    __syncthreads();
  }
  if (t < WARP) {
    T a = sh[t], b = sl[t];
#pragma unroll
    for (int half = WARP / 2; half >= 1; half /= 2) {
      const T a2 = __shfl_down_sync(0xffffffffu, a, half);
      const T b2 = __shfl_down_sync(0xffffffffu, b, half);
      if (t < half) Op::combine(a, b, a2, b2);
    }
    if (t == 0) {
      scalar[0] = a;
      scalar[1] = b;
    }
  }
}

// Pass 2: thread r folds the accumulator's slots r + j residues (j <
// LEAVES; slots past `size` are the pad pair) in registers and writes
// pair r of the tree; the last CTA to finish (ticket) folds the tree to
// the scalar pair. LEAVES (J = P / 2^m) is a template argument, so the
// leaves stay in registers.
template <class Op, int LEAVES>
__global__ void __launch_bounds__(TEAM)
finish_pairs(const typename Op::T* acc_hi, const typename Op::T* acc_lo,
             typename Op::T* tree_hi, typename Op::T* tree_lo, typename Op::T* scalar,
             unsigned* ticket, int size, int residues) {
  using T = typename Op::T;
  const int r = blockIdx.x * TEAM + threadIdx.x;
  // pass 1's accumulator is complete and visible past this point
  asm volatile("griddepcontrol.wait;" ::: "memory");
  T h[LEAVES], l[LEAVES];
#pragma unroll
  for (int j = 0; j < LEAVES; ++j) {
    const int slot = r + j * residues;
    h[j] = Op::pad();
    l[j] = Op::pad();
    if (slot < size) {
      h[j] = acc_hi[slot];
      l[j] = acc_lo[slot];
    }
  }
  halve<Op>(h, l, LEAVES);
  tree_hi[r] = h[0];
  tree_lo[r] = l[0];
  if (!last_to_finish(ticket, gridDim.x)) return;
  fold_tail<Op>(tree_hi, tree_lo, residues, scalar);
}

// Pass 2's launch, as a programmatic dependent of pass 1.
template <class Op, int LEAVES>
cudaError_t launch_finish(const typename Op::T* acc, int size, typename Op::T* tree,
                          int residues, typename Op::T* scalar, unsigned* ticket,
                          cudaStream_t stream) {
  cudaLaunchAttribute attr[1] = {};
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(residues / TEAM));
  cfg.blockDim = dim3(TEAM);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, finish_pairs<Op, LEAVES>, acc, acc + size, tree,
                            tree + residues, scalar, ticket, size, residues);
}

// `out` holds the accumulator's two planes (2 S words), the scalar pair (2
// words, then 2 of padding), the split partials' two planes (2 splits S
// words, when splits > 1) and the tree's two planes (2 residues words);
// ops/dd_reduce._out_words sizes it. `tickets` holds TM / 8 + 1 words,
// zero: one per slot group, then pass 2's.
template <class Op>
cudaError_t run(const void* hi, const void* lo, void* out, unsigned* tickets,
                long long tiles, long long tm, int splits, int residues, int scalar,
                cudaStream_t stream) {
  using T = typename Op::T;
  const long long size = tm * LANES;
  long long padded = 1;
  while (padded < size) padded *= 2;
  if (tm % SUB != 0 || splits < 1 || splits > tiles || splits > 65535 || residues < TEAM ||
      residues % TEAM != 0 || residues > TEAM * MAX_TAIL || padded % residues != 0 ||
      padded / residues > MAX_LEAVES) {
    return cudaErrorInvalidValue;
  }
  T* acc = static_cast<T*>(out);
  T* pair = acc + 2 * size;
  T* part = pair + 4;
  T* tree = part + (splits > 1 ? 2 * splits * size : 0);
  const unsigned groups = static_cast<unsigned>(tm / SUB);
  fold_tiles<Op><<<dim3(groups, static_cast<unsigned>(splits)), TEAM, 0, stream>>>(
      static_cast<const uint4*>(hi), static_cast<const uint4*>(lo),
      reinterpret_cast<uint4*>(part), reinterpret_cast<uint4*>(part + splits * size),
      reinterpret_cast<uint4*>(acc), reinterpret_cast<uint4*>(acc + size), tiles, tm, splits,
      tickets);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !scalar) return err;
  unsigned* ticket = tickets + groups;
  const int s = static_cast<int>(size);
  switch (padded / residues) {
    case 1: err = launch_finish<Op, 1>(acc, s, tree, residues, pair, ticket, stream); break;
    case 2: err = launch_finish<Op, 2>(acc, s, tree, residues, pair, ticket, stream); break;
    case 4: err = launch_finish<Op, 4>(acc, s, tree, residues, pair, ticket, stream); break;
    case 8: err = launch_finish<Op, 8>(acc, s, tree, residues, pair, ticket, stream); break;
    case 16: err = launch_finish<Op, 16>(acc, s, tree, residues, pair, ticket, stream); break;
    default: err = launch_finish<Op, 32>(acc, s, tree, residues, pair, ticket, stream); break;
  }
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

// Returns the CUDA error of its launches: 0 on success. `op` is
// ops/_cuda.OP_CODES: SUM takes float32 planes, MIN and MAX int32 keys.
// `scalar` 0 launches pass 1 alone (the accumulator), 1 both passes.
extern "C" int tr_dd_reduce(const void* hi, const void* lo, void* out, void* tickets,
                            long long tiles, long long tm, int splits, int residues,
                            int scalar, int op, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned* t = static_cast<unsigned*>(tickets);
  switch (op) {
    case tr::OP_SUM:
      return run<DdSum>(hi, lo, out, t, tiles, tm, splits, residues, scalar, s);
    case tr::OP_MIN:
      return run<DdSelect<true>>(hi, lo, out, t, tiles, tm, splits, residues, scalar, s);
    case tr::OP_MAX:
      return run<DdSelect<false>>(hi, lo, out, t, tiles, tm, splits, residues, scalar, s);
    default:
      return cudaErrorInvalidValue;
  }
}
