// bsearch: the index query inner loop, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/bsearch.py::bsearch.  For
// each query (packed lanes, uint32 values stored as int64) it finds the lower
// bound (first row >= query) or, with upper, the upper bound (first row >
// query) among sorted index rows, within the query's own [lo, hi) bracket.
// The search runs exactly `steps` halving trips; a trip with lo >= hi changes
// nothing, so results equal the TPU kernel's branchless loop bit for bit.
//
// Design: one thread per query.  The probed row lanes[mid] is read from global
// memory; the upper levels of every search hit the same few rows, which stay
// in L2 (50 MB).  The TPU design pins the whole index in VMEM; an index of
// this slice's size does not fit in a block's 227 KB of shared memory.  The
// index lanes may be a strided view (row_stride elements between rows), so the
// point view's lanes are read in place out of the (length | lanes) keys.
//
// Bound on the H100 (3.35 TB/s): the query lanes, lo, hi and the output, plus
// every distinct index row the searches probe, each moved once.  The probes
// are dependent loads, so the kernel is latency-bound far above that bound.
#include <cstdint>
#include <cuda_runtime.h>

__global__ void bsearch_kernel(const long long* __restrict__ lanes,
                               long long row_stride, int n_l,
                               const long long* __restrict__ queries,
                               long long n_q, const int32_t* __restrict__ lo_in,
                               const int32_t* __restrict__ hi_in, int steps,
                               int upper, int32_t* __restrict__ pos) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_q) return;
  const long long* q = queries + i * n_l;
  int lo = lo_in[i];
  int hi = hi_in[i];
  for (int s = 0; s < steps && lo < hi; ++s) {
    int mid = (int)(((long long)lo + hi) >> 1);
    const long long* row = lanes + (long long)mid * row_stride;
    int cmp = 0;
    for (int j = 0; j < n_l; ++j) {
      long long a = row[j];
      long long b = q[j];
      if (a != b) {
        cmp = a < b ? -1 : 1;
        break;
      }
    }
    bool go_right = cmp < 0 || (upper && cmp == 0);
    if (go_right) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  pos[i] = lo;
}

extern "C" int bsearch_launch(const void* lanes, long long row_stride, int n_l,
                              const void* queries, long long n_q,
                              const void* lo, const void* hi, int steps,
                              int upper, void* pos, void* stream) {
  const int threads = 256;
  long long blocks = (n_q + threads - 1) / threads;
  bsearch_kernel<<<(unsigned int)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const long long*)lanes, row_stride, n_l, (const long long*)queries, n_q,
      (const int32_t*)lo, (const int32_t*)hi, steps, upper, (int32_t*)pos);
  return (int)cudaGetLastError();
}
