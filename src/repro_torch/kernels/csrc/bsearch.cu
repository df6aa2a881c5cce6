// bsearch: the index query inner loop, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/bsearch.py::bsearch.  For
// each query (packed lanes, uint32 values stored as int64) it finds the lower
// bound (first row >= query) or, with upper, the upper bound (first row >
// query) among sorted index rows, within the query's own [lo, hi) bracket,
// after exactly `steps` halving trips of mid = (lo + hi) >> 1.  A trip with
// lo >= hi changes nothing, so a `steps` too small for the bracket ends the
// search early exactly as the TPU kernel's branchless loop does.
//
// What bounds it on the H100.  The bytes are tiny (the queries, lo, hi, the
// output, and the distinct probed rows: about 1 us at 3.35 TB/s for 2^16
// lookups), and the TPU design pins the index in VMEM, which a 20 MB index
// cannot do in 227 KB of shared memory.  So the index is read from L2 (50 MB)
// and the kernel is bound by dependent load latency: each halving trip needs
// the row that the previous trip chose.  The first port compared lanes one at
// a time with an early exit, so one trip could cost n_l serial L2 round trips.
// Measured (chip_smoke.py): one dependent L2 load takes about 0.14 us; with
// the design below 2^14-query searches run at 2.8x the floor of their longest
// query's round trips plus an empty launch, 2^16-query ones at 4.2x.
//
// Design.
//  * One load per probe: the n_l lanes of a probed row are issued together
//    (a template on n_l = 1..4; n_l = 0 is the generic instance, which walks
//    the lanes in chunks of 4), and compared branch-free.  Where the row
//    stride is even, lane pairs are read with 16-byte loads: the point view's
//    rows start 8 bytes into a 32-byte (length | lanes) key row, so its three
//    lanes take one 8-byte and one 16-byte load.
//  * D = BSEARCH_LEVELS = 2 levels per round trip: each round loads the rows
//    of the next D levels of the halving loop's own decision tree (2^D - 1
//    mids, each computed as (lo + hi) >> 1 on its branch; empty brackets and
//    trips past `steps` load nothing), all in flight together, then walks the
//    D decisions in registers.  The mids are the loop's own, so the answer
//    equals the sequential search bit for bit; a query needs ceil(trips / D)
//    round trips.  Each level adds rows to load, up to (2^D - 1) / D per
//    trip.  On the H100 D = 1 is the faster at 2^16-query searches and D = 2
//    at 2^14-query ones, and D = 2 takes the least device time summed over
//    every launch of the main and streaming paths (scripts/bsearch_levels.py
//    builds this source at each D with -DBSEARCH_LEVELS=d and times them).
//  * The index, queries and brackets go through the read-only path (__ldg);
//    lo and hi are read as int32 or int64, as the caller holds them.
//  * Blocks of 64 threads spread 2^14-2^16 queries over all 132 SMs.
//  * Mids are clamped into [0, n_rows) for the load, as the plain version
//    clamps its gather; with 0 <= lo <= hi <= n_rows no clamp ever bites.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;
#ifndef BSEARCH_LEVELS
#define BSEARCH_LEVELS 2
#endif
constexpr int D = BSEARCH_LEVELS;
static_assert(D >= 1 && D <= 4, "BSEARCH_LEVELS outside [1, 4]");

struct Args {
  const long long* lanes;   // [n_rows, row_stride], first n_l lanes used
  long long row_stride;
  long long n_rows;
  int n_l;
  const long long* queries;  // [n_q, n_l]
  long long n_q;
  const void* lo;            // [n_q] int32 or int64
  const void* hi;
  int steps;
  int upper;
  int32_t* pos;              // [n_q]
};

__host__ __device__ constexpr int level_of(int node) {
  int level = 0;
  while ((node + 1) >> (level + 1)) ++level;
  return level;
}

// -1, 0 or 1: the first `n` of C lanes of a row against the query's; the
// first differing lane decides
template <int C>
__device__ __forceinline__ int compare(const long long (&row)[C],
                                       const long long (&q)[C], int n) {
  int c = 0;
#pragma unroll
  for (int j = C - 1; j >= 0; --j) {
    const int cj = (row[j] > q[j]) - (row[j] < q[j]);
    c = (j < n && cj != 0) ? cj : c;
  }
  return c;
}

// the C lanes of one row: 16-byte loads of lane pairs starting at lane
// `pair0` (0: rows 16-byte aligned; 1: rows 8 bytes past a 16-byte boundary),
// 8-byte loads for the rest; pair0 < 0: 8-byte loads only
template <int C>
__device__ __forceinline__ void load_row(const long long* row, int pair0,
                                         long long (&v)[C]) {
  if (pair0 < 0) {
#pragma unroll
    for (int j = 0; j < C; ++j) v[j] = __ldg(row + j);
    return;
  }
  if (pair0 == 0) {
#pragma unroll
    for (int j = 0; j + 1 < C; j += 2) {
      const longlong2 p = __ldg((const longlong2*)(row + j));
      v[j] = p.x;
      v[j + 1] = p.y;
    }
    if (C & 1) v[C - 1] = __ldg(row + C - 1);
  } else {
    v[0] = __ldg(row);
#pragma unroll
    for (int j = 1; j + 1 < C; j += 2) {
      const longlong2 p = __ldg((const longlong2*)(row + j));
      v[j] = p.x;
      v[j + 1] = p.y;
    }
    if (!(C & 1)) v[C - 1] = __ldg(row + C - 1);
  }
}

template <int NL, typename Idx>
__global__ void __launch_bounds__(kThreads) bsearch_kernel(Args a) {
  constexpr int kNodes = (1 << D) - 1;
  constexpr int C = NL > 0 ? NL : 4;
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= a.n_q) return;
  const int nl = NL > 0 ? NL : a.n_l;
  const long long* q = a.queries + i * nl;
  long long lo = (long long)__ldg((const Idx*)a.lo + i);
  long long hi = (long long)__ldg((const Idx*)a.hi + i);
  // with an even row stride every row has the alignment of the first
  const int pair0 = NL >= 2 && (a.row_stride & 1) == 0
                        ? (((uintptr_t)a.lanes & 15) == 0 ? 0 : 1) : -1;
  for (int s = 0; a.n_rows > 0 && s < a.steps && lo < hi; s += D) {
    // brackets of the next D levels of the decision tree, breadth first
    long long nlo[kNodes], nhi[kNodes];
    nlo[0] = lo;
    nhi[0] = hi;
#pragma unroll
    for (int k = 0; k < kNodes / 2; ++k) {
      const long long m = (nlo[k] + nhi[k]) >> 1;
      nlo[2 * k + 1] = nlo[k];
      nhi[2 * k + 1] = m;
      nlo[2 * k + 2] = m + 1;
      nhi[2 * k + 2] = nhi[k];
    }
    int cmp[kNodes];
#pragma unroll
    for (int k = 0; k < kNodes; ++k) cmp[k] = 0;
#pragma unroll
    for (int c0 = 0; c0 < nl; c0 += C) {
      long long qv[C];
#pragma unroll
      for (int j = 0; j < C; ++j) qv[j] = c0 + j < nl ? __ldg(q + c0 + j) : 0;
      long long rv[kNodes][C];
#pragma unroll
      for (int k = 0; k < kNodes; ++k) {      // every load before any compare
        const bool live = nlo[k] < nhi[k] && s + level_of(k) < a.steps;
        const long long m = (nlo[k] + nhi[k]) >> 1;
        const long long r = m < 0 ? 0 : (m < a.n_rows ? m : a.n_rows - 1);
        const long long* row = a.lanes + r * a.row_stride + c0;
        if constexpr (NL > 0) {
          if (live) {
            load_row<C>(row, pair0, rv[k]);
          } else {
#pragma unroll
            for (int j = 0; j < C; ++j) rv[k][j] = 0;
          }
        } else {
#pragma unroll
          for (int j = 0; j < C; ++j)
            rv[k][j] = (live && c0 + j < nl) ? __ldg(row + j) : 0;
        }
      }
#pragma unroll
      for (int k = 0; k < kNodes; ++k) {
        const int c = compare<C>(rv[k], qv, nl - c0);
        cmp[k] = cmp[k] != 0 ? cmp[k] : c;
      }
    }
    // walk the D decisions: the same trips as the sequential loop
    int k = 0;
#pragma unroll
    for (int level = 0; level < D; ++level) {
      if (s + level < a.steps && lo < hi) {
        const long long m = (lo + hi) >> 1;
        int c = 0;
#pragma unroll
        for (int t = 0; t < kNodes; ++t) c = t == k ? cmp[t] : c;
        const bool right = c < 0 || (a.upper && c == 0);
        lo = right ? m + 1 : lo;
        hi = right ? hi : m;
        k = 2 * k + (right ? 2 : 1);
      }
    }
  }
  a.pos[i] = (int32_t)lo;
}

template <int NL, typename Idx>
int launch(const Args& a, cudaStream_t stream) {
  const long long blocks = (a.n_q + kThreads - 1) / kThreads;
  bsearch_kernel<NL, Idx><<<(unsigned int)blocks, kThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename Idx>
int by_lanes(const Args& a, cudaStream_t stream) {
  switch (a.n_l) {
    case 1: return launch<1, Idx>(a, stream);
    case 2: return launch<2, Idx>(a, stream);
    case 3: return launch<3, Idx>(a, stream);
    case 4: return launch<4, Idx>(a, stream);
    default: return launch<0, Idx>(a, stream);
  }
}

template <typename Idx>
int load_all() {
  cudaFuncAttributes attr;
  int err = (int)cudaFuncGetAttributes(&attr, bsearch_kernel<0, Idx>);
  if (!err) err = (int)cudaFuncGetAttributes(&attr, bsearch_kernel<1, Idx>);
  if (!err) err = (int)cudaFuncGetAttributes(&attr, bsearch_kernel<2, Idx>);
  if (!err) err = (int)cudaFuncGetAttributes(&attr, bsearch_kernel<3, Idx>);
  if (!err) err = (int)cudaFuncGetAttributes(&attr, bsearch_kernel<4, Idx>);
  return err;
}

}  // namespace

// Load every instance now, so that no first launch waits for one.
extern "C" int bsearch_load() {
  const int err = load_all<int32_t>();
  return err ? err : load_all<long long>();
}

// index_bytes: 4 (int32 lo/hi) or 8 (int64)
extern "C" int bsearch_launch(const void* lanes, long long row_stride,
                              long long n_rows, int n_l, const void* queries,
                              long long n_q, const void* lo, const void* hi,
                              int index_bytes, int steps, int upper, void* pos,
                              void* stream) {
  const Args a{(const long long*)lanes, row_stride, n_rows, n_l,
               (const long long*)queries, n_q, lo, hi, steps, upper,
               (int32_t*)pos};
  if (index_bytes == 4) return by_lanes<int32_t>(a, (cudaStream_t)stream);
  if (index_bytes == 8) return by_lanes<long long>(a, (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}
