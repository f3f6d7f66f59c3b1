// A kernel that does not return in time: the device form of the `stall`
// fault (tpu_reductions_torch/faults/inject.py, action "spin"), bound to
// Python with ctypes (tpu_reductions_torch/ops/_cuda.py, spin_wait).
//
// The counterpart of the JAX package's wedged process
// (tpu_reductions/faults/inject.py `stall`, tests/test_watchdog.py): on a
// local card, a kernel that hangs leaves the host blocked in the next
// torch.cuda.synchronize, which is what the watchdog's exit 4 is for. One
// thread spins until a deadline read from %globaltimer, the card's
// nanosecond clock, which runs at a fixed rate whatever the SM clock is.
// The kernel caps the spin at SPIN_CAP_NS itself, so the card frees itself
// even if the process that launched it cannot end; ops/_cuda.py caps the
// seconds it passes at the same value.
//
// It is no port of a TPU kernel and is never on a measured path: it
// launches only where TPU_REDUCTIONS_FAULTS names a point with the spin
// action, and its launches are counted apart from the six ported kernels.

#include "common.cuh"

namespace {

constexpr unsigned long long SPIN_CAP_NS = 30ull * 1000000000ull;

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__global__ void spin(unsigned long long ns) {
  const unsigned long long deadline =
      global_ns() + (ns < SPIN_CAP_NS ? ns : SPIN_CAP_NS);
  while (global_ns() < deadline) {
    __nanosleep(1000);
  }
}

}  // namespace

// tr_spin_wait(ns, stream): one one-thread kernel on `stream` that returns
// ns nanoseconds (at most SPIN_CAP_NS) after it starts. Returns
// cudaGetLastError() after the launch.
extern "C" int tr_spin_wait(long long ns, void* stream) {
  if (ns < 0) return static_cast<int>(cudaErrorInvalidValue);
  spin<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned long long>(ns));
  return static_cast<int>(cudaGetLastError());
}
