// latency_probe: the floor of a latency-bound search on this card, for the
// bsearch row of chip_smoke.py (phase 4).
//
// chase_kernel: one thread follows `hops` dependent loads through a random
// cycle, read through the read-only path as bsearch reads its index; with the
// cycle as large as the index, the time per hop is one load round trip from
// L2.  empty_kernel: one launch that does nothing, the least device time that
// torch.profiler shows for a kernel.
#include <cuda_runtime.h>

__global__ void chase_kernel(const long long* next, long long hops, long long* out) {
  long long p = 0;
  for (long long i = 0; i < hops; ++i) p = __ldg(next + p);
  *out = p;
}

__global__ void empty_kernel() {}

extern "C" int chase_launch(const void* next, long long hops, void* out, void* stream) {
  chase_kernel<<<1, 1, 0, (cudaStream_t)stream>>>((const long long*)next, hops,
                                                  (long long*)out);
  return (int)cudaGetLastError();
}

extern "C" int empty_launch(void* stream) {
  empty_kernel<<<1, 1, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
