// A phase boundary on a CUDA stream: one thread writes the device's global
// timer (%globaltimer, nanoseconds) into one int64 slot when the stream
// reaches the launch.
//
// The port's span system (src/repro_torch/utils/spans.py) marks the device
// phases of a round inside its CUDA graph with it. Under a stream capture a
// launch becomes an ordinary kernel node, so the graph keeps the launch
// path of a graph of kernels. Timing events recorded as external event
// nodes instead (about 96 a fused FedAIS round of 5 members, J 4) kept
// the host inside cudaGraphLaunch longer on an H100: 17.9 against 15.7 ms
// a pubmed round (medians of 10 seeds), with the device idle 14.7% of a
// traced window against 10.7% (a traced window of 19 rounds). After the
// stream has passed the stamps, the difference of two slots is the
// device time between the two boundaries. No TPU kernel corresponds to it.
#include <cuda_runtime.h>

namespace {

__global__ void stamp_kernel(unsigned long long* slot) {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  *slot = t;
}

}  // namespace

extern "C" {

// Writes the global timer into *slot on `stream`; does not synchronise.
// Returns cudaGetLastError().
int stamp_globaltimer(unsigned long long* slot, void* stream) {
  stamp_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(slot);
  return (int)cudaGetLastError();
}

const char* stamp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
