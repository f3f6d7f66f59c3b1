// Shared pieces of the hand-written Hopper (sm_90a) reduction kernels:
// the op and dtype codes of ops/_cuda.py, the register type of each element
// type, the op's identity and combine, and the dispatch from the runtime
// (op, dtype) codes to a template instance. Each csrc/*.cu includes this
// header and is built into its own library, which exports tr_error_string.
//
// int32 SUM adds in uint32_t: signed overflow is undefined in C++, and the
// result must wrap modulo 2^32 like the host oracle.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <climits>
#include <type_traits>

namespace tr {

constexpr int LANES = 128;
constexpr int THREADS = 1024;

// Codes shared with ops/_cuda.py.
enum OpCode { OP_SUM = 0, OP_MIN = 1, OP_MAX = 2 };
enum DtypeCode { DT_INT32 = 0, DT_FLOAT32 = 1, DT_FLOAT64 = 2, DT_BFLOAT16 = 3 };

// Register type of each element type: bf16 is widened to float, exactly.
__device__ __forceinline__ int widen(int v) { return v; }
__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ double widen(double v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void store(int* p, int v) { *p = v; }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(double* p, double v) { *p = v; }
// A bf16 MIN/MAX accumulator holds an input value or +-inf: exact in bf16.
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <int OP, class R>
__device__ __forceinline__ R identity() {
  if constexpr (OP == OP_SUM) {
    return R(0);
  } else if constexpr (std::is_same<R, int>::value) {
    return OP == OP_MIN ? INT_MAX : INT_MIN;
  } else if constexpr (std::is_same<R, float>::value) {
    return OP == OP_MIN ? CUDART_INF_F : -CUDART_INF_F;
  } else {
    return OP == OP_MIN ? CUDART_INF : -CUDART_INF;
  }
}

template <int OP, class R>
__device__ __forceinline__ R combine(R a, R b) {
  if constexpr (OP == OP_SUM) {
    if constexpr (std::is_same<R, int>::value) {
      return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
    } else {
      return a + b;
    }
  } else if constexpr (OP == OP_MIN) {
    return b < a ? b : a;
  } else {
    return a < b ? b : a;
  }
}

// What thread t of a team of TEAM threads owns in a SUB x 128 slot group
// of T: the VEC-element 16-byte vectors t + k * TEAM, k < LOADS.
constexpr int TEAM = 256;

template <class T, int SUB>
struct Layout {
  static constexpr int VEC = 16 / sizeof(T);
  static constexpr int LOADS = SUB * LANES / (VEC * TEAM);  // 1; 2 for f64
  static constexpr int SLOTS = LOADS * VEC;
  static constexpr long long GROUP = SUB * LANES / VEC;  // vectors of a group
  static_assert(LOADS * VEC * TEAM == SUB * LANES, "a team covers a group");
  // the slot (row * 128 + column) of a group that slot s of thread t is
  __device__ static int slot(int t, int s) {
    return (t + s / VEC * TEAM) * VEC + s % VEC;
  }
};

__device__ __forceinline__ unsigned word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// Element j of a 16-byte vector of the tag's type, widened to its register
// type (bf16: its 16 bits are the high half of its float, exactly).
__device__ __forceinline__ int lane(const uint4& v, int j, int) {
  return static_cast<int>(word(v, j));
}
__device__ __forceinline__ float lane(const uint4& v, int j, float) {
  return __uint_as_float(word(v, j));
}
__device__ __forceinline__ double lane(const uint4& v, int j, double) {
  return __hiloint2double(static_cast<int>(word(v, 2 * j + 1)),
                          static_cast<int>(word(v, 2 * j)));
}
__device__ __forceinline__ float lane(const uint4& v, int j, __nv_bfloat16) {
  const unsigned w = word(v, j / 2);
  return __uint_as_float(j % 2 ? w & 0xffff0000u : w << 16);
}

// A 16-byte load of data read once: not kept in L1, and with a hint that
// L2 fetch the whole 256-byte span around it from device memory.
__device__ __forceinline__ uint4 ld_stream(const uint4* p) {
  uint4 v;
  asm volatile(
      "ld.global.nc.L1::no_allocate.L2::256B.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

// Whether this block is the last of `total` to take the ticket; the last
// sets it back to zero. Every thread's writes before the call are visible
// to the last block after it. (k8 and dd: each block of a slot group
// takes the group's integer ticket; no float atomics.)
__device__ __forceinline__ bool last_to_finish(unsigned* ticket, unsigned total) {
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(ticket, 1u) == total - 1;
    if (last) *ticket = 0;
  }
  __syncthreads();
  if (last) __threadfence();
  return last;
}

// Calls launch.run<OP, T, O, SUB>(): T the element type, O the accumulator
// type, SUB the accumulator rows of one slot group (8; 16 for bf16). bf16
// SUM accumulates in float (the JAX package's accum_dtype); every other
// pair keeps its input type.
template <int OP, class L>
cudaError_t by_dtype(int dtype, const L& launch) {
  switch (dtype) {
    case DT_INT32:
      return launch.template run<OP, int, int, 8>();
    case DT_FLOAT32:
      return launch.template run<OP, float, float, 8>();
    case DT_FLOAT64:
      return launch.template run<OP, double, double, 8>();
    case DT_BFLOAT16:
      if constexpr (OP == OP_SUM) {
        return launch.template run<OP, __nv_bfloat16, float, 16>();
      } else {
        return launch.template run<OP, __nv_bfloat16, __nv_bfloat16, 16>();
      }
    default:
      return cudaErrorInvalidValue;
  }
}

template <class L>
cudaError_t by_op(int op, int dtype, const L& launch) {
  switch (op) {
    case OP_SUM:
      return by_dtype<OP_SUM>(dtype, launch);
    case OP_MIN:
      return by_dtype<OP_MIN>(dtype, launch);
    case OP_MAX:
      return by_dtype<OP_MAX>(dtype, launch);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace tr

// Defined here, not only declared: each library is built from exactly one
// source, so each gets one exported copy.
extern "C" const char* tr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
