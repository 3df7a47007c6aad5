// Device phase stamps of the training step (mmnn_sts_torch/utils/tracing.py).
//
// It replaces no TPU kernel. The JAX package's fused epoch is one XLA
// program whose profile names its operations; a CUDA graph replay runs the
// step's kernels without the host ranges that would name its phases. So
// the step body marks the end of each phase with this kernel: one thread
// reads the device's global timer (ns) and writes it into
// stamps[slot[0] * width + mark]. The row comes from a device buffer, so a
// captured body writes a new row at each replay with no host work; a slot
// outside [0, rows) writes nothing, so no replay writes past the rows. One
// 8-byte read and one 8-byte write: its cost is the launch (a graph node,
// a few microseconds), and the stream's order puts it after the work of
// the phase it ends.

#include <cuda_runtime.h>

__global__ void span_stamp_kernel(const long long* __restrict__ slot,
                                  long long* __restrict__ stamps, int rows,
                                  int width, int mark) {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  const long long row = slot[0];
  if (row < 0 || row >= rows) return;
  stamps[row * width + mark] = static_cast<long long>(t);
}

// Launches on `stream` (PyTorch's current stream) on device `device`;
// returns the cudaError_t of the launch.
extern "C" int span_stamp_launch(const void* slot, void* stamps, int rows,
                                 int width, int mark, int device,
                                 void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  span_stamp_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(slot), static_cast<long long*>(stamps),
      rows, width, mark);
  return (int)cudaGetLastError();
}
