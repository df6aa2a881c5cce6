// merge_path: stable two-way merge of sorted key rows, hand-written for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/merge_path.py::merge_path.
// A [M, K] and B [N, K] are sorted lexicographically (uint32 values stored as
// int64, so signed order is the unsigned order); the output [M+N, K] is their
// merge with every A row before every equal B row, and the int64 values ride
// along.  The generational index merges (elder, newer) segments, sentinel
// tails included, through a pairing tree of these calls.
//
// Design: one thread per output row d runs the Merge Path diagonal search of
// the TPU kernel -- the smallest i in [max(0, d-N), min(d, M)] with
// A[i] > B[d-1-i] -- for exactly `steps` = search_steps(min(M, N) + 1) trips
// (a trip with lo >= hi changes nothing), then copies the winning row.  The
// TPU kernel keeps both runs in VMEM; here they stay in HBM and the upper
// levels of neighbouring threads' searches share rows in L1/L2.  A two-level
// design (one partition search per thread block, then a merge in shared
// memory) is later work.
//
// Bound on the H100 (3.35 TB/s): both runs' keys and values read once and the
// merged keys and values written once: 2 * (M + N) * (8 * K + 8) bytes.  The
// diagonal probes are dependent loads, so the kernel is bound by latency
// above that.
#include <cstdint>
#include <cuda_runtime.h>

__device__ __forceinline__ bool lex_gt(const long long* x, const long long* y,
                                       int k) {
  for (int c = 0; c < k; ++c) {
    long long a = x[c], b = y[c];
    if (a != b) return a > b;
  }
  return false;
}

__global__ void merge_path_kernel(const long long* __restrict__ a,
                                  const long long* __restrict__ b,
                                  const long long* __restrict__ av,
                                  const long long* __restrict__ bv, long long m,
                                  long long n, int k, int steps,
                                  long long* __restrict__ keys,
                                  long long* __restrict__ vals) {
  long long d = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (d >= m + n) return;
  long long lo = d - n > 0 ? d - n : 0;
  long long hi = d < m ? d : m;
  for (int s = 0; s < steps && lo < hi; ++s) {
    long long i = (lo + hi) >> 1;
    long long j = d - 1 - i;
    // G(i): the (i+1)-th A row does not belong in the first d outputs
    bool g = i >= m || j < 0 || lex_gt(a + i * k, b + j * k, k);
    if (g) {
      hi = i;
    } else {
      lo = i + 1;
    }
  }
  long long i = lo, j = d - lo;
  bool take_a = i < m && (j >= n || !lex_gt(a + i * k, b + j * k, k));
  const long long* src = take_a ? a + i * k : b + j * k;
  long long* dst = keys + d * k;
  for (int c = 0; c < k; ++c) dst[c] = src[c];
  vals[d] = take_a ? av[i] : bv[j];
}

extern "C" int merge_path_launch(const void* a, const void* b, const void* av,
                                 const void* bv, long long m, long long n,
                                 int k, int steps, void* keys, void* vals,
                                 void* stream) {
  const int threads = 256;
  long long blocks = (m + n + threads - 1) / threads;
  merge_path_kernel<<<(unsigned int)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const long long*)a, (const long long*)b, (const long long*)av,
      (const long long*)bv, m, n, k, steps, (long long*)keys, (long long*)vals);
  return (int)cudaGetLastError();
}
