// lcp_boundary: the SUFFIX-sigma reducer's inner loop, hand-written for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/lcp_boundary.py::lcp_boundary.
// For a lexicographically sorted int32 term matrix [N, L] it writes, per row,
// lcp[i] = the length of the common prefix with row i-1 (row 0 gets 0) and
// flags[i, l-1] = (lcp[i] < l) && terms[i, l-1] != 0.
//
// Design: one thread per row compares its row with the previous one straight
// from global memory (the previous row is the neighbouring thread's row, so it
// is served from L1/L2), and row 0 gets lcp 0 directly.  The TPU kernel's
// pre-shifted copy of the matrix with an INT_MIN sentinel is not needed.
//
// Bound on the H100 (3.35 TB/s): 4 * L bytes in, 4 + L bytes out per row:
// N * (5 * L + 4) / 3.35e12 s.
#include <cstdint>
#include <cuda_runtime.h>

__global__ void lcp_boundary_kernel(const int32_t* __restrict__ terms,
                                    long long n, int length,
                                    int32_t* __restrict__ lcp,
                                    bool* __restrict__ flags) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int32_t* cur = terms + i * length;
  int l = 0;
  if (i > 0) {
    const int32_t* prev = cur - length;
    while (l < length && cur[l] == prev[l]) ++l;
  }
  lcp[i] = l;
  bool* f = flags + i * length;
  for (int j = 0; j < length; ++j) f[j] = (l < j + 1) && (cur[j] != 0);
}

extern "C" int lcp_boundary_launch(const void* terms, long long n, int length,
                                   void* lcp, void* flags, void* stream) {
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  lcp_boundary_kernel<<<(unsigned int)blocks, threads, 0,
                        (cudaStream_t)stream>>>(
      (const int32_t*)terms, n, length, (int32_t*)lcp, (bool*)flags);
  return (int)cudaGetLastError();
}
