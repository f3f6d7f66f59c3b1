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
// (SUB = 8; 16 for bf16), one slot (two for bf16) per thread of a
// 1024-thread block, and the tiles into `splits` interleaved sets. Block
// (g, s) folds slot group g over the tiles k = s, s + splits, ... into
// (splits, TM, 128) partials; a second pass folds the partials over s, in
// order. The wrapper picks `splits` so that all blocks are in flight at
// once (two per SM, one wave), from the shape alone: k8 and k10 take the
// same `splits`, so they add in the same order and give bit-identical
// accumulators, and k10's depth moves copies, never the order of the adds.
//
// Bound: each kernel reads every staged byte once and writes the
// (splits, TM, 128) partials and the accumulator: bound by device-memory
// bytes, never by arithmetic. What the designs do about it:
//   k8   plain coalesced loads into registers: a warp reads 32 neighbouring
//        elements of one row, and the tile walk is unrolled so that several
//        loads per thread are in flight. No shared memory.
//   k10  one thread of the block starts 1-D TMA bulk copies
//        (cp.async.bulk ... mbarrier::complete_tx::bytes) of the block's
//        SUB x 128 chunk of each tile into a ring of `depth` shared-memory
//        stages, one mbarrier per stage; every thread waits on the stage's
//        barrier, folds its slots from shared memory, and after a block
//        barrier the stage is refilled with the chunk `depth` tiles ahead.
//        The depth is a runtime argument, at most what fits in the 227 KB of
//        shared memory a block can use (the wrapper refuses more).

#include <cstdint>

#include "common.cuh"

namespace {

using namespace tr;

// The most stages k10's ring may have: the size of its static barrier array.
constexpr int MAX_STAGES = 64;

// Block (g, s) folds slot group g of tiles s, s + splits, ... < tiles of
// `in` into slot group g of (TM, 128) block s of `out`.
template <int OP, class T, class O, int SUB>
__global__ void __launch_bounds__(THREADS)
fold_period(const T* __restrict__ in, O* __restrict__ out, long long tiles,
            long long tm, long long splits) {
  using R = decltype(widen(T()));
  constexpr int SLOTS = SUB * LANES / THREADS;  // 1, or 2 for bf16
  static_assert(SLOTS * THREADS == SUB * LANES, "a block owns whole slots");
  const long long group = static_cast<long long>(blockIdx.x) * SUB * LANES;
  const long long tile_elems = tm * LANES;
  R acc[SLOTS];
#pragma unroll
  for (int j = 0; j < SLOTS; ++j) acc[j] = identity<OP, R>();
#pragma unroll 4
  for (long long k = blockIdx.y; k < tiles; k += splits) {
    const T* chunk = in + k * tile_elems + group;
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

// Arm the stage's barrier for `bytes` and start the bulk copy that will
// complete it.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// k10's pass 1: as fold_period, with the block's chunk of each tile (SUB x
// 128 elements, contiguous) streamed through a ring of `depth` stages.
template <int OP, class T, class O, int SUB>
__global__ void __launch_bounds__(THREADS)
stream_period(const T* __restrict__ in, O* __restrict__ out, long long tiles,
              long long tm, long long splits, int depth) {
  using R = decltype(widen(T()));
  constexpr int SLOTS = SUB * LANES / THREADS;
  constexpr int CHUNK = SUB * LANES;
  constexpr uint32_t BYTES = CHUNK * sizeof(T);
  static_assert(BYTES % 16 == 0, "bulk copies move multiples of 16 bytes");
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t full[MAX_STAGES];
  T* stages = reinterpret_cast<T*>(smem);

  const long long group = static_cast<long long>(blockIdx.x) * SUB * LANES;
  const long long split = blockIdx.y;
  const long long tile_elems = tm * LANES;
  const long long count = split < tiles ? (tiles - 1 - split) / splits + 1 : 0;

  // Chunk i of this block (tile split + i*splits) into stage `slot`. A
  // refill is started after the block barrier that follows every read of
  // the stage, as CUTLASS's TMA pipelines order it, with no proxy fence.
  auto load_chunk = [&](long long i, int slot) {
    bulk_load(stages + slot * CHUNK, in + (split + i * splits) * tile_elems + group,
              BYTES, &full[slot]);
  };

  if (threadIdx.x == 0) {
    for (int st = 0; st < depth; ++st) mbar_init(&full[st], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int i = 0; i < depth && i < count; ++i) load_chunk(i, i);
  }

  R acc[SLOTS];
#pragma unroll
  for (int j = 0; j < SLOTS; ++j) acc[j] = identity<OP, R>();
  // stage i % depth holds chunk i; its barrier completes once per lap of
  // the ring, so the parity to wait for flips at every lap
  int slot = 0;
  uint32_t parity = 0;
  for (long long i = 0; i < count; ++i) {
    mbar_wait(&full[slot], parity);
    const T* chunk = stages + slot * CHUNK;
#pragma unroll
    for (int j = 0; j < SLOTS; ++j) {
      acc[j] = combine<OP>(acc[j], widen(chunk[threadIdx.x + j * THREADS]));
    }
    __syncthreads();  // every thread has read the stage before its refill
    if (threadIdx.x == 0 && i + depth < count) load_chunk(i + depth, slot);
    if (++slot == depth) {
      slot = 0;
      parity ^= 1u;
    }
  }
  O* dst = out + split * tile_elems + group;
#pragma unroll
  for (int j = 0; j < SLOTS; ++j) store(dst + threadIdx.x + j * THREADS, acc[j]);
}

// Pass 2 of both kernels: fold the (splits, TM, 128) partials over splits.
template <int OP, class O, int SUB>
cudaError_t fold_partials(const void* partials, void* out, long long tm,
                          int splits, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>(tm / SUB), 1);
  fold_period<OP, O, O, SUB><<<grid, THREADS, 0, stream>>>(
      static_cast<const O*>(partials), static_cast<O*>(out), splits, tm, 1);
  return cudaGetLastError();
}

// k8: pass 1 into `partials` (or straight into `out` when splits == 1),
// then pass 2.
struct K8 {
  const void* in;
  void* partials;
  void* out;
  long long tiles;
  long long tm;
  int splits;
  cudaStream_t stream;

  template <int OP, class T, class O, int SUB>
  cudaError_t run() const {
    const dim3 grid(static_cast<unsigned>(tm / SUB), static_cast<unsigned>(splits));
    fold_period<OP, T, O, SUB><<<grid, THREADS, 0, stream>>>(
        static_cast<const T*>(in), static_cast<O*>(splits > 1 ? partials : out),
        tiles, tm, splits);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || splits == 1) return err;
    return fold_partials<OP, O, SUB>(partials, out, tm, splits, stream);
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
  cudaStream_t stream;

  template <int OP, class T, class O, int SUB>
  cudaError_t run() const {
    const size_t smem = static_cast<size_t>(depth) * SUB * LANES * sizeof(T);
    if (depth < 1 || depth > MAX_STAGES) return cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(
        stream_period<OP, T, O, SUB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    const dim3 grid(static_cast<unsigned>(tm / SUB), static_cast<unsigned>(splits));
    stream_period<OP, T, O, SUB><<<grid, THREADS, smem, stream>>>(
        static_cast<const T*>(in), static_cast<O*>(splits > 1 ? partials : out),
        tiles, tm, splits, depth);
    err = cudaGetLastError();
    if (err != cudaSuccess || splits == 1) return err;
    return fold_partials<OP, O, SUB>(partials, out, tm, splits, stream);
  }
};

}  // namespace

// Each returns cudaGetLastError() after its launches: 0 on success.
extern "C" int tr_k8_reduce(const void* in, void* partials, void* out,
                            long long tiles, long long tm, int splits, int op,
                            int dtype, void* stream) {
  const K8 launch{in, partials, out, tiles, tm, splits,
                  static_cast<cudaStream_t>(stream)};
  return static_cast<int>(tr::by_op(op, dtype, launch));
}

extern "C" int tr_k10_reduce(const void* in, void* partials, void* out,
                             long long tiles, long long tm, int splits,
                             int depth, int op, int dtype, void* stream) {
  const K10 launch{in, partials, out, tiles, tm, splits, depth,
                   static_cast<cudaStream_t>(stream)};
  return static_cast<int>(tr::by_op(op, dtype, launch));
}
