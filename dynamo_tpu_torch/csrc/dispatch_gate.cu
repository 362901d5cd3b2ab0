// The dispatch gate: a one-thread kernel that holds a CUDA stream until the
// host releases it. Hopper (sm_90a), plain C interface.
//
// Replaces no TPU kernel. It was added for the profiling plane's device
// timing (dynamo_tpu_torch/engine_torch/device_timer.py), the counterpart
// of the JAX engine's block_until_ready around a sampled dispatch
// (dynamo_tpu/engine_jax/engine.py _decode_step). An eager PyTorch forward
// is its own enqueue: the host issues thousands of kernels per decode step
// and takes longer to issue them than the card takes to run them, so an
// event pair around a dispatch times the host. The timer therefore cuts a
// sampled dispatch into segments (a model layer each) and puts this gate
// in front of each one. The gate spins until the host, having enqueued the
// whole segment behind it, writes the segment's ticket into flags[0]; an
// event recorded right after the gate and one after the segment then time
// the segment's kernels run back to back. A segment holds far fewer
// kernels than the stream's launch queue, so the host never blocks in a
// launch while a gate holds the stream.
//
// flags is pinned host memory (two int32), read by the card through its
// unified address: flags[0] is the host's release counter, compared with
// the ticket modulo 2^32; flags[1] is set to 1 if a gate gave up after
// timeout_ns (a host stalled inside a segment: the timer then discards the
// measurement), so a fault in the host never hangs the card.
//
// What bounds it: nothing of the card's rates. It reads four bytes over
// PCIe per poll and sleeps between polls; its time is the host's release
// latency (or, released already, one launch and one read).

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__global__ void dispatch_gate_wait_kernel(volatile unsigned int* flags, unsigned int ticket,
                                          unsigned long long timeout_ns) {
  const unsigned long long t0 = global_ns();
  while (static_cast<int>(flags[0] - ticket) < 0) {
    if (global_ns() - t0 > timeout_ns) {
      flags[1] = 1u;
      __threadfence_system();
      return;
    }
    __nanosleep(200);
  }
}

}  // namespace

extern "C" int dispatch_gate_wait_launch(void* flags, unsigned int ticket,
                                         unsigned long long timeout_ns, void* stream) {
  if (flags == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  dispatch_gate_wait_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<volatile unsigned int*>(flags), ticket, timeout_ns);
  return static_cast<int>(cudaGetLastError());
}
