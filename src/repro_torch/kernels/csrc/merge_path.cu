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
// What bounds it on the H100.  Bytes: both runs' keys and values read once
// and the merged keys and values written once, 2 * (M + N) * (8 * K + 8)
// bytes as stored, half that as uint32 values; 0.0112 / 0.0056 ms at
// compact_all's merge ([374,656, 4] + [92,544, 4]) at 3.35 TB/s.  Above that,
// latency: the first port ran one thread per output row, each a Merge Path
// diagonal search of search_steps(min(M, N) + 1) = 18 dependent global
// probes, then copied its row with scalar stores at a 32-byte stride: 0.0391
// ms on the device, 0.044 ms a call (NVIDIA H100 80GB HBM3, 700 W,
// chip_smoke.py).
//
// Design: a two-level Merge Path through shared memory (K = 1-5, a template).
//  * Partition: a block owns kTile = 256 * 2 = 512 consecutive output
//    rows.  Two warps find the split points of the tile's two
//    diagonals d (the smallest i with A[i] > B[d-1-i]) together, 32 probes a
//    round trip: each round narrows the range 33-fold, so 4 round trips at
//    compact_all's 92,544-row run.
//  * Load: the tile's rows of A and of B (512 together) and their values go
//    into shared memory by 16-byte cp.async, all in flight at once.  Each
//    span keeps its global address mod 16 there, so any 8-byte aligned input
//    copies 16 bytes at a time (an odd word at either end alone).
//  * Merge: each thread finds the diagonal of its own 2 rows by a binary
//    search in shared memory and merges them serially, A first on ties, keeping only the input row of each output row (a row
//    staged whole through registers and shared memory instead cost more in
//    bank conflicts than the merge saved).
//  * Store: the merged tile in address order with 16-byte stores, each word
//    read from its input row in shared memory.
//  * Tiles of 512 rows beat 256 and 1,024 at compact_all's sizes (PERF.md).
// Measured at compact_all's merge: 0.0208 ms on the device against the first
// port's 0.0387-0.0388 (chip_smoke.py, parent and change in one call, same
// card); the rest is bank conflicts of the shared-memory search and merge,
// and latency: its phases (split, load, merge, store) run in turn.
// More key lanes take the generic instance: one thread per output row runs
// the diagonal search of the TPU kernel for exactly `steps` =
// search_steps(min(M, N) + 1) trips (a trip with lo >= hi changes nothing),
// then copies the winning row.
#include <cstdint>
#include <cuda_runtime.h>

#include "async_copy.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 2;                    // output rows a thread
constexpr int kTile = kThreads * kPer;     // output rows a block (K = 1-5)

struct Args {
  const long long* a;    // [m, k]
  const long long* b;    // [n, k]
  const long long* av;   // [m]
  const long long* bv;   // [n]
  long long m, n;
  int k, steps;
  long long* keys;       // [m + n, k]
  long long* vals;       // [m + n]
};

// x > y, lexicographically over the first k lanes
template <int K>
__device__ __forceinline__ bool row_gt(const long long* x, const long long* y,
                                       int k) {
  const int lanes = K > 0 ? K : k;
#pragma unroll
  for (int c = 0; c < lanes; ++c) {
    if (x[c] != y[c]) return x[c] > y[c];
  }
  return false;
}

// the same, both rows read through the read-only path
template <int K>
__device__ __forceinline__ bool row_gt_ldg(const long long* x, const long long* y) {
  long long xs[K], ys[K];
#pragma unroll
  for (int c = 0; c < K; ++c) {
    xs[c] = __ldg(x + c);
    ys[c] = __ldg(y + c);
  }
  return row_gt<K>(xs, ys, K);
}

// The Merge Path split of diagonal d, by one warp: the smallest i in
// [max(0, d - n), min(d, m)] with A[i] > B[d-1-i] (the range's top when there
// is none).  Each round the 32 lanes probe 32 points that cut [lo, hi) into
// 33 parts; the ballot's first true lane bounds the answer.  A width of 32 or
// less is probed whole, so the last round ends the search.
template <int K>
__device__ long long split_warp(const Args& a, long long d) {
  const int lane = threadIdx.x & 31;
  long long lo = d > a.n ? d - a.n : 0;
  long long hi = d < a.m ? d : a.m;
  while (lo < hi) {                        // uniform across the warp
    const long long w = hi - lo;           // lo <= p < hi; 32-bit division below 2^26
    const long long p = lo + (w < (1 << 26) ? (long long)((unsigned)w * (lane + 1) / 33u)
                                            : w * (lane + 1) / 33);
    const bool g = row_gt_ldg<K>(a.a + p * K, a.b + (d - 1 - p) * K);
    const unsigned ball = __ballot_sync(0xffffffffu, g);
    if (ball == 0u) {
      lo = __shfl_sync(0xffffffffu, p, 31) + 1;
    } else {
      const int f = __ffs(ball) - 1;
      const long long below = __shfl_sync(0xffffffffu, p, f > 0 ? f - 1 : 0);
      hi = __shfl_sync(0xffffffffu, p, f);
      if (f > 0) lo = below + 1;
    }
  }
  return lo;
}

// 0 or 1: the element offset of `p` from a 16-byte boundary
__device__ __forceinline__ int parity(const long long* p) {
  return (int)(((uintptr_t)p >> 3) & 1);
}

// cnt int64 words src -> dst by cp.async, where dst and src lie at the same
// offset from a 16-byte boundary, `head` words (0 or 1) before the next one:
// 16 bytes a copy, an odd word at either end alone.  Nothing waits, so a
// block has its whole tile in flight at once.
__device__ __forceinline__ void load_span(long long* dst, const long long* src,
                                          int cnt, int head) {
  head = cnt > 0 ? head : 0;
  const int pairs = (cnt - head) >> 1;
  for (int v = threadIdx.x; v < pairs; v += kThreads)
    cp_async16(dst + head + 2 * v, src + head + 2 * v);
  if (threadIdx.x == 0 && head) cp_async8(dst, src);
  if (threadIdx.x == kThreads - 1 && ((cnt - head) & 1))
    cp_async8(dst + cnt - 1, src + cnt - 1);
}

template <int K>
constexpr size_t smem_bytes() {
  // keys of A and B (each span may start one word in), their values, and
  // the input row of each output row
  return K == 0 ? 0
                : ((size_t)kTile * K + 4 + kTile + 4) * sizeof(long long) +
                      kTile * sizeof(int);
}

// K = 1-5: the tiled instance (23 KB of shared memory at K = 4); K = 0: the
// generic instance
template <int K>
__global__ void __launch_bounds__(kThreads) merge_path_kernel(Args a) {
  if constexpr (K == 0) {
    const long long d = (long long)blockIdx.x * kThreads + threadIdx.x;
    if (d >= a.m + a.n) return;
    const int k = a.k;
    long long lo = d - a.n > 0 ? d - a.n : 0;
    long long hi = d < a.m ? d : a.m;
    for (int s = 0; s < a.steps && lo < hi; ++s) {
      const long long i = (lo + hi) >> 1;
      const long long j = d - 1 - i;
      // the (i+1)-th A row does not belong in the first d outputs
      const bool g = i >= a.m || j < 0 || row_gt<0>(a.a + i * k, a.b + j * k, k);
      if (g) {
        hi = i;
      } else {
        lo = i + 1;
      }
    }
    const long long i = lo, j = d - lo;
    const bool take_a =
        i < a.m && (j >= a.n || !row_gt<0>(a.a + i * k, a.b + j * k, k));
    const long long* src = take_a ? a.a + i * k : a.b + j * k;
    long long* dst = a.keys + d * k;
    for (int c = 0; c < k; ++c) dst[c] = src[c];
    a.vals[d] = take_a ? a.av[i] : a.bv[j];
  } else {
    extern __shared__ __align__(16) long long smem[];
    __shared__ long long split[2];
    long long* skeys = smem;                        // [kTile * K + 4]
    long long* svals = smem + kTile * K + 4;        // [kTile + 4]
    int* from = (int*)(svals + kTile + 4);          // [kTile]: input row of each output row
    const long long total = a.m + a.n;
    const long long d0 = (long long)blockIdx.x * kTile;
    const long long d1 = d0 + kTile < total ? d0 + kTile : total;
    // 1. the tile's split points, one warp a diagonal
    const int warp = threadIdx.x >> 5;
    if (warp < 2) {
      const long long s = split_warp<K>(a, warp ? d1 : d0);
      if ((threadIdx.x & 31) == 0) split[warp] = s;
    }
    __syncthreads();
    const long long a0 = split[0], a1 = split[1];
    const long long b0 = d0 - a0;
    const int na = (int)(a1 - a0), nb = (int)(d1 - a1 - b0);
    // 2. A[a0:a1] and B[b0:b1] into shared memory, keys and values: input
    // row r < na is A's, r >= na B's
    const int ka = parity(a.a + a0 * K);
    const int kb = ((ka + na * K + 1) & ~1) + parity(a.b + b0 * K);
    const int va = parity(a.av + a0);
    const int vb = ((va + na + 1) & ~1) + parity(a.bv + b0);
    load_span(skeys + ka, a.a + a0 * K, na * K, ka);
    load_span(skeys + kb, a.b + b0 * K, nb * K, kb & 1);
    load_span(svals + va, a.av + a0, na, va);
    load_span(svals + vb, a.bv + b0, nb, vb & 1);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    // 3. each thread's kPer output rows: its diagonal by binary search, then
    // a serial merge, A first on ties; only the input row is kept
    const int dl = threadIdx.x * kPer;
    const int nt = na + nb;
    if (dl < nt) {
      int lo = dl > nb ? dl - nb : 0, hi = dl < na ? dl : na;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (row_gt<K>(skeys + ka + mid * K, skeys + kb + (dl - 1 - mid) * K, K)) {
          hi = mid;
        } else {
          lo = mid + 1;
        }
      }
      int i = lo, j = dl - lo;
#pragma unroll
      for (int r = 0; r < kPer && dl + r < nt; ++r) {
        const bool take_a =
            i < na && (j >= nb || !row_gt<K>(skeys + ka + i * K, skeys + kb + j * K, K));
        from[dl + r] = take_a ? i : na + j;
        i += take_a;
        j += !take_a;
      }
    }
    __syncthreads();
    // 4. the merged tile in address order, 16-byte stores (the outputs are
    // 16-byte aligned, and so is every tile's start): each word read from
    // its input row in shared memory
    auto key_at = [&](int e) {
      const int r = from[e / K];
      return skeys[(r < na ? ka + r * K : kb + (r - na) * K) + e % K];
    };
    auto val_at = [&](int e) {
      const int r = from[e];
      return svals[r < na ? va + r : vb + (r - na)];
    };
    longlong2* kout = (longlong2*)(a.keys + d0 * K);
    for (int v = threadIdx.x; 2 * v < nt * K; v += kThreads) {
      if (2 * v + 1 < nt * K) {
        kout[v] = make_longlong2(key_at(2 * v), key_at(2 * v + 1));
      } else {
        a.keys[d0 * K + 2 * v] = key_at(2 * v);
      }
    }
    longlong2* vout = (longlong2*)(a.vals + d0);
    for (int v = threadIdx.x; 2 * v < nt; v += kThreads) {
      if (2 * v + 1 < nt) {
        vout[v] = make_longlong2(val_at(2 * v), val_at(2 * v + 1));
      } else {
        a.vals[d0 + 2 * v] = val_at(2 * v);
      }
    }
  }
}

template <int K>
int launch_tiled(const Args& a, cudaStream_t stream) {
  const long long blocks = (a.m + a.n + kTile - 1) / kTile;
  merge_path_kernel<K><<<(unsigned int)blocks, kThreads, smem_bytes<K>(), stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Load every instance now, so that none waits inside a first launch.
extern "C" int merge_path_load() {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, merge_path_kernel<0>);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, merge_path_kernel<1>);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, merge_path_kernel<2>);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, merge_path_kernel<3>);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, merge_path_kernel<4>);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, merge_path_kernel<5>);
  return (int)err;
}

// a, b, av, bv: contiguous, 8-byte aligned; keys, vals: contiguous, 16-byte
// aligned; m, n >= 1
extern "C" int merge_path_launch(const void* a, const void* b, const void* av,
                                 const void* bv, long long m, long long n,
                                 int k, int steps, void* keys, void* vals,
                                 void* stream) {
  const Args args{(const long long*)a, (const long long*)b, (const long long*)av,
                  (const long long*)bv, m, n, k, steps, (long long*)keys,
                  (long long*)vals};
  cudaStream_t s = (cudaStream_t)stream;
  if (((uintptr_t)keys | (uintptr_t)vals) & 15) return (int)cudaErrorInvalidValue;
  switch (k) {
    case 1: return launch_tiled<1>(args, s);
    case 2: return launch_tiled<2>(args, s);
    case 3: return launch_tiled<3>(args, s);
    case 4: return launch_tiled<4>(args, s);
    case 5: return launch_tiled<5>(args, s);
    default: break;
  }
  if (k < 1) return (int)cudaErrorInvalidValue;
  const long long blocks = (m + n + kThreads - 1) / kThreads;
  merge_path_kernel<0><<<(unsigned int)blocks, kThreads, 0, s>>>(args);
  return (int)cudaGetLastError();
}
