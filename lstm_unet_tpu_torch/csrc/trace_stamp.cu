// Device stamps of the port's tracer (utils/trace.py).
//
// One thread reads the card's nanosecond clock (%globaltimer) when the
// stream reaches it, takes the next slot of a ring on the device and writes
// (tag, time) there. The ring's index lives on the device too, so a CUDA
// graph that holds stamps writes new slots at every replay, and nothing on
// the host reads the card until the recording is read out. A stamp past the
// ring's end writes nothing but still counts: the index minus the capacity
// is the overflow the read-out reports.
#include <cuda_runtime.h>
#include <stdint.h>

namespace lut {

__global__ void trace_stamp_kernel(unsigned long long* ring, unsigned long long* index,
                                   unsigned long long capacity, long long tag) {
  unsigned long long now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  unsigned long long slot = atomicAdd(index, 1ULL);
  if (slot < capacity) {
    ring[2 * slot] = static_cast<unsigned long long>(tag);
    ring[2 * slot + 1] = now;
  }
}

}  // namespace lut

extern "C" int lut_trace_stamp(void* ring, void* index, long long capacity, long long tag,
                               void* stream) {
  lut::trace_stamp_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned long long*>(ring), static_cast<unsigned long long*>(index),
      static_cast<unsigned long long>(capacity), tag);
  return (int)cudaGetLastError();
}
