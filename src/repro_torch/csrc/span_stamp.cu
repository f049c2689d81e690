// Span stamps for the port's span recorder (repro_torch/spans.py).
//
// One one-thread kernel, fl_span_stamp, writes the device's global timer
// (%globaltimer, nanoseconds) into one int64 slot of a buffer.  The
// recorder launches it at the start and the end of each span on the
// current stream, so inside a captured CUDA graph each stamp is one kernel
// node and reads the timer when the work queued before it has ended.  The
// kernel reads nothing, allocates nothing and does not synchronise.

#include <cstdint>

#include <cuda_runtime.h>

extern "C" __global__ void fl_span_stamp(long long* buf, int slot) {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  buf[slot] = static_cast<long long>(t);
}

// C entry point, loaded with ctypes.  buf is a device pointer to int64
// slots.  Returns cudaGetLastError() after the launch: non-zero means the
// launch was refused.
extern "C" int span_stamp(void* buf, int slot, void* stream) {
  fl_span_stamp<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<long long*>(buf), slot);
  return static_cast<int>(cudaGetLastError());
}
