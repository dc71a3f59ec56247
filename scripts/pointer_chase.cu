// One thread chasing pointers through a permutation: the latency of one
// dependent global load on the card.  chip_smoke.py builds it (nvcc, plain
// C interface, ctypes) and times it at two chain lengths with CUDA events,
// so the launch cost cancels; the merge walks' latency bound is their
// dependent steps times this latency.  It is a measurement, not a kernel
// of the port: no wrapper calls it and no launch of it is counted.
#include <cuda_runtime.h>

__global__ void chase_kernel(const int* __restrict__ next, int steps,
                             int* __restrict__ out) {
  int j = 0;
  for (int s = 0; s < steps; ++s) j = __ldg(next + j);
  *out = j;
}

extern "C" int pointer_chase_launch(const void* next, int steps, void* out,
                                    void* stream) {
  chase_kernel<<<1, 1, 0, (cudaStream_t)stream>>>((const int*)next, steps,
                                                  (int*)out);
  return (int)cudaGetLastError();
}
