// Hand-written Hopper (sm_90a) kernels k8 and k10 of the single-chip
// reduction benchmark, bound to Python with ctypes
// (tpu_reductions_torch/ops/_cuda.py).
//
// Replaces two TPU kernels of the JAX package, which compute one function:
//   k8   tpu_reductions/ops/pallas_reduce.py::elementwise_call (:227-237,
//        pallas_call :209): Mosaic's automatic pipeline brings each (TM, 128)
//        tile into VMEM and the kernel combines it elementwise into a
//        (TM, 128) accumulator, with no fold inside the step;
//   k10  pallas_reduce.py::stream_call (:338-361, kernel _stream_kernel
//        :283-335): the same accumulate, fed by a hand-rolled async-copy
//        pipeline `stream_buffers` chunks deep.
//
// The accumulator is defined by slots, not by the grid: slot (r, c) of the
// (TM, 128) accumulator is the combine, over the staged rows congruent to
// r modulo TM, of column c. A (TM, 128) accumulator is up to 2048 x 128
// slots (1 MiB of f32, 2 MiB of f64): no block's registers or shared memory
// hold it. So the slots are cut into slot groups of SUB rows x 128 columns
// (SUB = 8; 16 for bf16), and the tiles into `splits` interleaved sets.
// Block (g, s) folds slot group g over the tiles k = s, s + splits, ... in
// increasing k into (splits, TM, 128) partials, which are then folded over
// s, in order, from the identity: by the last block of each slot group
// (k8 up to the planner's split count) or by a second pass (k8 above it,
// and k10). The wrapper's planner (ops/kernel_reduce.plan_splits) picks
// `splits` from the shape and the SM count alone, and k8 and k10 take the
// same: they add in the same order and give bit-identical accumulators,
// and k10's depth and stage size and k8's unroll and choice of fold move
// loads and launches, never the order of the adds.
//
// Bound: each kernel reads every staged byte once and writes the
// (splits, TM, 128) partials and the accumulator: bound by device-memory
// bytes, never by arithmetic. What the designs do about it:
//   k8   16-byte ld.global.nc.L1::no_allocate loads, UNROLL tiles deep. A
//        block is one team of TEAM = 256 threads over one slot group;
//        thread t owns the 16-byte vectors t + j * TEAM of the group
//        (Layout: one vector for int32, f32 and bf16, two for f64), so a
//        warp load is 512 contiguous bytes. It issues the loads of UNROLL
//        of its tiles before it combines them, in increasing tile order,
//        then takes the rest one by one: at UNROLL 8 and the main path's
//        256 blocks (about two an SM) 64 KiB a SM are in flight. With
//        splits, each block writes its partial and takes its slot group's
//        integer ticket (last_to_finish: no float atomics); the last block
//        of the group folds the group's partials, in split order, from L2
//        into the accumulator, so k8 is one launch. Above the planner's
//        split count one block would fold too many partials alone, and
//        the second pass (fold_splits) folds them instead. The parent
//        design (1024-thread blocks of scalar loads, 4 deep, and always a
//        second pass) read at 67% of the memory rate (PERF.md).
//   k10  a warp-specialised ring of TMA bulk copies. A block is one
//        producer warp and CONSUMERS warps. One lane of the producer warp
//        alone issues the 1-D bulk copies (cp.async.bulk ...
//        mbarrier::complete_tx::bytes) of the block's SUB x 128 chunk of
//        each of its tiles into a ring of `depth` shared-memory stages; a
//        stage carries `chunks` consecutive chunks of the block's split
//        (8 KiB, several copies on one expect_tx), so each barrier round
//        trip moves 8 KiB. Each stage has a full barrier (completed by the
//        copies' bytes) and an empty barrier (one arrival per consumer
//        warp after it has read the stage); the producer waits on the
//        empty barrier before it refills the stage. No block-wide barrier
//        inside the loop: the parent design's __syncthreads() of all 1024
//        threads per 4 KiB chunk, with the refill behind the slowest warp,
//        bounded it at 59% of the memory rate. A consumer thread owns the
//        VEC slots of one 16-byte vector of the group (two for f64) and
//        reads shared memory 16 bytes at a time. Blocks are 288 threads, so
//        their number (groups x splits, about two per SM) is set by the
//        shape, not by the threads an SM holds; depth 4 keeps 32 KiB in
//        flight per block. The depth is a runtime argument, at most what
//        fits in the 227 KB of shared memory a block can use (the wrapper
//        refuses more). Measured on an H100 (bench/passes.py --sweep):
//        stages of one 4 KiB chunk lose 1.5 us at depth 4, and folding a
//        slot group's splits in one thread-block cluster over distributed
//        shared memory, instead of in the second pass, lost 0.6 us: the
//        cluster launch costs more than the pass and its launch gap.

#include <cstdint>

#include "common.cuh"

namespace {

using namespace tr;

// The most stages k10's ring may have: the size of its barrier arrays.
constexpr int MAX_STAGES = 64;
// k10's consumer warps (they cover one slot group: a team of TEAM
// threads) and its block: those and one producer warp.
constexpr int CONSUMERS = TEAM / 32;
constexpr int STREAM_THREADS = TEAM + 32;

// k8's partials the last block of a slot group loads before it combines
// them.
constexpr int SPLIT_BATCH = 8;

// The 32 bits of an accumulator value as it lies in memory.
__device__ __forceinline__ unsigned bits32(int v) { return static_cast<unsigned>(v); }
__device__ __forceinline__ unsigned bits32(float v) { return __float_as_uint(v); }

// One 16-byte word of accumulator values of type O, from the 16 /
// sizeof(O) register values v[0..] (store()'s conversion for bf16).
template <class O, class R>
__device__ __forceinline__ uint4 pack_word(const R* v) {
  if constexpr (std::is_same<O, double>::value) {
    return make_uint4(__double2loint(v[0]), __double2hiint(v[0]), __double2loint(v[1]),
                      __double2hiint(v[1]));
  } else if constexpr (std::is_same<O, __nv_bfloat16>::value) {
    unsigned w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      w[i] = __bfloat16_as_ushort(__float2bfloat16(v[2 * i])) |
             static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16(v[2 * i + 1]))) << 16;
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  } else {
    return make_uint4(bits32(v[0]), bits32(v[1]), bits32(v[2]), bits32(v[3]));
  }
}

// Where thread t keeps its slots of a slot group in a (TM, 128) block of
// O: the VEC slots of its vector j (Layout) are VEC consecutive O values,
// WORDS_PER 16-byte words from word (t + j * TEAM) * WORDS_PER of the
// group (two words for bf16 SUM's float accumulator, one otherwise).
template <class T, class O, int SUB>
struct Slots {
  using L = Layout<T, SUB>;
  static constexpr int PER = 16 / sizeof(O);    // O values in a word
  static constexpr int WORDS_PER = L::VEC / PER;
  static constexpr int WORDS = L::LOADS * WORDS_PER;
  static constexpr long long GROUP_WORDS = SUB * LANES / PER;
  static_assert(WORDS_PER * PER == L::VEC, "a vector's slots fill whole words");
  __device__ static long long word(int t, int w) {
    return static_cast<long long>(t + w / WORDS_PER * TEAM) * WORDS_PER + w % WORDS_PER;
  }
};

// Combine the thread's slots with a vector of the input (or of a
// partial): slot s takes element s % VEC of vector s / VEC.
template <int OP, class T, int SUB, class R>
__device__ __forceinline__ void fold_in(R (&acc)[Layout<T, SUB>::SLOTS],
                                        const uint4 (&v)[Layout<T, SUB>::LOADS]) {
  using L = Layout<T, SUB>;
#pragma unroll
  for (int s = 0; s < L::SLOTS; ++s) {
    acc[s] = combine<OP>(acc[s], lane(v[s / L::VEC], s % L::VEC, T()));
  }
}

// Write the thread's slots into the slot group that starts at word dst
// of a (TM, 128) block of O.
template <class T, class O, int SUB, class R>
__device__ __forceinline__ void put_slots(uint4* dst, const R (&acc)[Layout<T, SUB>::SLOTS]) {
  using S = Slots<T, O, SUB>;
#pragma unroll
  for (int w = 0; w < S::WORDS; ++w) {
    dst[S::word(threadIdx.x, w)] = pack_word<O>(acc + w * S::PER);
  }
}

// Issue the loads of UNROLL tiles k, k + splits, ... of the thread's
// vectors.
template <int UNROLL, int LOADS>
__device__ __forceinline__ void load_tiles(uint4 (&v)[UNROLL][LOADS], const uint4* in,
                                           long long k, long long splits,
                                           long long tile_vecs, long long off) {
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
#pragma unroll
    for (int j = 0; j < LOADS; ++j) {
      v[u][j] = ld_stream(in + (k + u * splits) * tile_vecs + off + j * TEAM);
    }
  }
}

// k8's pass: block (g, s), one team of TEAM threads, folds slot group g
// of tiles s, s + splits, ... < tiles, in increasing order: UNROLL tiles'
// loads issued, then combined in order, then the rest one at a time.
// With one split it writes slot group g of `out`; with more, slot group g
// of partial s, and with `fused` the last block of group g (tickets[g])
// folds the group's partials, in split order from the identity, into
// `out`. Without `fused` fold_splits does that in a second launch.
template <int OP, class T, class O, int SUB, int UNROLL>
__global__ void __launch_bounds__(TEAM)
fold_period(const uint4* __restrict__ in, uint4* out, uint4* partials, unsigned* tickets,
            long long tiles, long long tm, long long splits, int fused) {
  using R = decltype(widen(T()));
  using L = Layout<T, SUB>;
  using S = Slots<T, O, SUB>;
  const long long tile_vecs = tm * LANES / L::VEC;
  const long long off = static_cast<long long>(blockIdx.x) * L::GROUP + threadIdx.x;
  const long long split = blockIdx.y;
  R acc[L::SLOTS];
#pragma unroll
  for (int s = 0; s < L::SLOTS; ++s) acc[s] = identity<OP, R>();
  long long k = split;
  for (; k + (UNROLL - 1) * splits < tiles; k += UNROLL * splits) {
    uint4 v[UNROLL][L::LOADS];
    load_tiles(v, in, k, splits, tile_vecs, off);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) fold_in<OP, T, SUB>(acc, v[u]);
  }
  for (; k < tiles; k += splits) {
    uint4 v[L::LOADS];
#pragma unroll
    for (int j = 0; j < L::LOADS; ++j) v[j] = ld_stream(in + k * tile_vecs + off + j * TEAM);
    fold_in<OP, T, SUB>(acc, v);
  }
  const long long tile_words = tm * LANES / S::PER;
  const long long group = static_cast<long long>(blockIdx.x) * S::GROUP_WORDS;
  if (splits == 1) {
    put_slots<T, O, SUB>(out + group, acc);
    return;
  }
  put_slots<T, O, SUB>(partials + split * tile_words + group, acc);
  if (!fused || !last_to_finish(tickets + blockIdx.x, static_cast<unsigned>(splits))) return;
  // the group's partials, SPLIT_BATCH at a time, from L2 (other blocks
  // wrote them), each batch loaded before its combines
#pragma unroll
  for (int s = 0; s < L::SLOTS; ++s) acc[s] = identity<OP, R>();
  const uint4* part = partials + group;
  for (long long s0 = 0; s0 < splits; s0 += SPLIT_BATCH) {
    uint4 w[SPLIT_BATCH][S::WORDS];
#pragma unroll
    for (int b = 0; b < SPLIT_BATCH; ++b) {
      if (s0 + b < splits) {
#pragma unroll
        for (int i = 0; i < S::WORDS; ++i) {
          w[b][i] = __ldcg(part + (s0 + b) * tile_words + S::word(threadIdx.x, i));
        }
      }
    }
#pragma unroll
    for (int b = 0; b < SPLIT_BATCH; ++b) {
      if (s0 + b < splits) {
#pragma unroll
        for (int s = 0; s < L::SLOTS; ++s) {
          acc[s] = combine<OP>(acc[s], lane(w[b][s / S::PER], s % S::PER, O()));
        }
      }
    }
  }
  put_slots<T, O, SUB>(out + group, acc);
}

// The second pass of k10 and of k8 above its fused split count: block g
// of 1024 threads folds slot group g of the (splits, TM, 128) partials
// over the splits, in order, from the identity, into `out`.
template <int OP, class O, int SUB>
__global__ void __launch_bounds__(THREADS)
fold_splits(const O* __restrict__ in, O* __restrict__ out, long long tiles, long long tm,
            long long splits) {
  using R = decltype(widen(O()));
  constexpr int SLOTS = SUB * LANES / THREADS;  // 1, or 2 for bf16
  static_assert(SLOTS * THREADS == SUB * LANES, "a block owns whole slots");
  const long long group = static_cast<long long>(blockIdx.x) * SUB * LANES;
  const long long tile_elems = tm * LANES;
  R acc[SLOTS];
#pragma unroll
  for (int j = 0; j < SLOTS; ++j) acc[j] = identity<OP, R>();
#pragma unroll 4
  for (long long k = blockIdx.y; k < tiles; k += splits) {
    const O* chunk = in + k * tile_elems + group;
#pragma unroll
    for (int j = 0; j < SLOTS; ++j) {
      acc[j] = combine<OP>(acc[j], widen(chunk[threadIdx.x + j * THREADS]));
    }
  }
  O* dst = out + static_cast<long long>(blockIdx.y) * tile_elems + group;
#pragma unroll
  for (int j = 0; j < SLOTS; ++j) store(dst + threadIdx.x + j * THREADS, acc[j]);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

// Wait until the barrier's phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}

// Arrive on the stage's full barrier and arm it for `bytes` of copies.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// A bulk copy whose bytes complete the barrier's transaction count.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// k10's pass 1: as fold_period, with the block's chunk of each tile (SUB x
// 128 elements, contiguous) streamed through a ring of `depth` stages of
// `chunks` chunks each. Chunk i of the block is tile split + i * splits;
// stage q holds chunks [q * chunks, (q + 1) * chunks) in slot q % depth,
// and each consumer thread folds them in chunk order, so the order of the
// adds is k8's whatever the depth and the stage size.
template <int OP, class T, class O, int SUB>
__global__ void __launch_bounds__(STREAM_THREADS)
stream_period(const T* __restrict__ in, O* __restrict__ out, long long tiles,
              long long tm, long long splits, int depth, int chunks) {
  using R = decltype(widen(T()));
  using L = Layout<T, SUB>;
  constexpr int CHUNK = SUB * LANES;
  constexpr uint32_t BYTES = CHUNK * sizeof(T);
  static_assert(BYTES % 16 == 0, "bulk copies move multiples of 16 bytes");
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t full[MAX_STAGES];
  __shared__ __align__(8) uint64_t empty[MAX_STAGES];

  const long long group = static_cast<long long>(blockIdx.x) * CHUNK;
  const long long split = blockIdx.y;
  const long long tile_elems = tm * LANES;
  const long long count = split < tiles ? (tiles - 1 - split) / splits + 1 : 0;
  const long long stages = (count + chunks - 1) / chunks;
  const int warp = threadIdx.x / 32;

  if (threadIdx.x == 0) {
    for (int st = 0; st < depth; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();  // the only block barrier: the barriers exist

  if (warp == CONSUMERS) {
    // The producer: use u of a slot waits for the consumers' release of
    // use u - 1 (the empty barrier's phase of parity u - 1), then refills.
    if (threadIdx.x % 32 == 0) {
      int slot = 0;
      uint32_t lap = 0;
      for (long long q = 0; q < stages; ++q) {
        if (q >= depth) mbar_wait(&empty[slot], lap ^ 1u);
        const long long first = q * chunks;
        const int n = static_cast<int>(count - first < chunks ? count - first
                                                               : chunks);
        mbar_expect(&full[slot], n * BYTES);
        unsigned char* dst = smem + static_cast<size_t>(slot) * chunks * BYTES;
        for (int c = 0; c < n; ++c) {
          bulk_copy(dst + c * BYTES,
                    in + (split + (first + c) * splits) * tile_elems + group,
                    BYTES, &full[slot]);
        }
        if (++slot == depth) {
          slot = 0;
          lap ^= 1u;
        }
      }
    }
    return;
  }

  // The consumers: thread t of the team owns vectors t + k * TEAM of the
  // slot group.
  const int t = threadIdx.x;
  R acc[L::SLOTS];
#pragma unroll
  for (int s = 0; s < L::SLOTS; ++s) acc[s] = identity<OP, R>();
  int slot = 0;
  uint32_t lap = 0;
  for (long long q = 0; q < stages; ++q) {
    mbar_wait(&full[slot], lap);
    const long long first = q * chunks;
    const int n = static_cast<int>(count - first < chunks ? count - first : chunks);
    const uint4* stage =
        reinterpret_cast<const uint4*>(smem + static_cast<size_t>(slot) * chunks * BYTES);
    for (int c = 0; c < n; ++c) {
      uint4 v[L::LOADS];
#pragma unroll
      for (int k = 0; k < L::LOADS; ++k) v[k] = stage[c * L::GROUP + t + k * TEAM];
#pragma unroll
      for (int s = 0; s < L::SLOTS; ++s) {
        acc[s] = combine<OP>(acc[s], lane(v[s / L::VEC], s % L::VEC, T()));
      }
    }
    __syncwarp();  // the warp has read the stage
    if (threadIdx.x % 32 == 0) mbar_arrive(&empty[slot]);
    if (++slot == depth) {
      slot = 0;
      lap ^= 1u;
    }
  }
  O* dst = out + split * tile_elems + group;
#pragma unroll
  for (int s = 0; s < L::SLOTS; ++s) store(dst + L::slot(t, s), acc[s]);
}

// The second pass: fold the (splits, TM, 128) partials over splits.
template <int OP, class O, int SUB>
cudaError_t fold_partials(const void* partials, void* out, long long tm,
                          int splits, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>(tm / SUB), 1);
  fold_splits<OP, O, SUB><<<grid, THREADS, 0, stream>>>(
      static_cast<const O*>(partials), static_cast<O*>(out), splits, tm, 1);
  return cudaGetLastError();
}

// k8: pass 1 into `out` (one split), or into `partials` with the last
// block of each slot group folding them (`fused`), or into `partials`
// and then the second pass. `tickets` holds tm / SUB words, zero.
struct K8 {
  const void* in;
  void* partials;
  void* out;
  unsigned* tickets;
  long long tiles;
  long long tm;
  int splits;
  int unroll;
  int fused;
  cudaStream_t stream;

  template <int OP, class T, class O, int SUB, int UNROLL>
  cudaError_t launch() const {
    const dim3 grid(static_cast<unsigned>(tm / SUB), static_cast<unsigned>(splits));
    fold_period<OP, T, O, SUB, UNROLL><<<grid, TEAM, 0, stream>>>(
        static_cast<const uint4*>(in), static_cast<uint4*>(out),
        static_cast<uint4*>(partials), tickets, tiles, tm, splits, fused);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || splits == 1 || fused) return err;
    return fold_partials<OP, O, SUB>(partials, out, tm, splits, stream);
  }

  template <int OP, class T, class O, int SUB>
  cudaError_t run() const {
    if (tm % SUB != 0 || splits < 1 || splits > 65535) return cudaErrorInvalidValue;
    switch (unroll) {
      case 4:
        return launch<OP, T, O, SUB, 4>();
      case 8:
        return launch<OP, T, O, SUB, 8>();
      case 16:
        return launch<OP, T, O, SUB, 16>();
      default:
        return cudaErrorInvalidValue;
    }
  }
};

// k10: the streamed pass 1, then pass 2.
struct K10 {
  const void* in;
  void* partials;
  void* out;
  long long tiles;
  long long tm;
  int splits;
  int depth;
  int chunks;
  cudaStream_t stream;

  template <int OP, class T, class O, int SUB>
  cudaError_t run() const {
    const size_t smem = static_cast<size_t>(depth) * chunks * SUB * LANES * sizeof(T);
    if (depth < 1 || depth > MAX_STAGES || chunks < 1) return cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(
        stream_period<OP, T, O, SUB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    const dim3 grid(static_cast<unsigned>(tm / SUB), static_cast<unsigned>(splits));
    stream_period<OP, T, O, SUB><<<grid, STREAM_THREADS, smem, stream>>>(
        static_cast<const T*>(in), static_cast<O*>(splits > 1 ? partials : out),
        tiles, tm, splits, depth, chunks);
    err = cudaGetLastError();
    if (err != cudaSuccess || splits == 1) return err;
    return fold_partials<OP, O, SUB>(partials, out, tm, splits, stream);
  }
};

}  // namespace

// Each returns cudaGetLastError() after its launches: 0 on success.
// `unroll` is k8's UNROLL: 4, 8 or 16.
extern "C" int tr_k8_reduce(const void* in, void* partials, void* out,
                            void* tickets, long long tiles, long long tm,
                            int splits, int unroll, int fused, int op,
                            int dtype, void* stream) {
  const K8 launch{in,     partials, out,   static_cast<unsigned*>(tickets),
                  tiles,  tm,       splits, unroll,
                  fused,  static_cast<cudaStream_t>(stream)};
  return static_cast<int>(tr::by_op(op, dtype, launch));
}

extern "C" int tr_k10_reduce(const void* in, void* partials, void* out,
                             long long tiles, long long tm, int splits,
                             int depth, int chunks, int op, int dtype,
                             void* stream) {
  const K10 launch{in,    partials, out,    tiles,
                   tm,    splits,   depth,  chunks,
                   static_cast<cudaStream_t>(stream)};
  return static_cast<int>(tr::by_op(op, dtype, launch));
}
