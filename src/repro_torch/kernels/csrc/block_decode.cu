// block_decode: the compressed-index query inner loop, hand-written for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/block_decode.py::block_decode.
// For each query it decodes its candidate block (see front_code.cuh) and
// counts the block rows whose (row_len, terms) key sorts strictly below the
// query's (cnt_lt) and equal to it (cnt_eq).  The head binary search picked
// the block; block * block_size + the counts is the query's global
// lower/upper bound.
//
// Design: for block_size <= 32 a group of G lanes (G the next power of two
// >= max(block_size, 4); a block of 2 rows takes a group of 4 with two idle
// lanes) serves one query, lane r decoding row r of its block with
// the group scan, ballot and shuffle of front_code.cuh.  The group reads the
// query row with coalesced loads (lane i holds term i of a G-term window)
// and shuffles each term to every lane as its column comes up; each lane
// folds the lexicographic compare of its own row into the column loop, and
// __reduce_add_sync over the group's mask sums the lanes' lt and eq.  The
// group's first lane writes the two counters.  A query's loads wait on one
// another only as blk -> (block_base, lcp) -> payload, and for sigma <= 32 a
// lane issues all its payload loads before it uses any, where the first
// port's thread per query walked the block's rows one after another.  A
// larger block_size takes the generic instance: that thread-per-query walk.
//
// Bound on the H100 (3.35 TB/s): the query terms, length and block id read
// once, the two int32 counters written once, and the stream words of the
// distinct candidate blocks read once; the integer work is a few dozen
// operations per row.  At 2^16 queries that is about a microsecond, so the
// scattered loads of the candidate blocks (a few sectors each, one chain of
// three dependent loads per query) and a launch's own latency set the time.
#include <cstdint>
#include <cuda_runtime.h>

#include "front_code.cuh"

// Threads of a group-decode CTA: 8 warps.
constexpr int GROUP_THREADS = 256;

// G lanes a query; SMAX > 0: sigma <= SMAX, the row's terms and the query
// row held in registers; SMAX == 0: any sigma, a column's loads at a time
template <int G, int SMAX>
__global__ void __launch_bounds__(GROUP_THREADS)
block_decode_kernel(FrontCoded fc, const int32_t* __restrict__ sec_in,
                    const int32_t* __restrict__ blk, const int32_t* __restrict__ q_terms,
                    const int32_t* __restrict__ q_len, long long n_q,
                    int32_t* __restrict__ cnt_lt, int32_t* __restrict__ cnt_eq) {
  __shared__ int32_t sec[FC_MAX_SEC];
  for (int s = threadIdx.x; s <= fc.sigma; s += blockDim.x) sec[s] = sec_in[s];
  __syncthreads();
  // blockDim.x is a multiple of 32, so a group never straddles two warps;
  // lanes past the list stay in the loop for the warp's ballots and shuffles
  long long q = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / G;
  const int r = threadIdx.x & (G - 1);
  const int gbase = (threadIdx.x & 31) & ~(G - 1);
  const bool listed = q < n_q;
  const int b = listed ? __ldg(blk + q) : 0;
  const int qlen = listed ? __ldg(q_len + q) : 0;
  const bool live = listed && r < fc.block_size;
  const int32_t* qrow = q_terms + q * fc.sigma;
  GroupRow row = group_row<G>(fc, sec, b, live);
  bool t_lt = false, t_eq = true;
  // lexicographic terms compare: the first differing column decides
  auto compare = [&](int32_t cur, int32_t qt) {
    if (t_eq && cur != qt) {
      t_lt = cur < qt;
      t_eq = false;
    }
  };
  if constexpr (SMAX > 0) {
    // the query row in windows of G terms, lane r holding term w * G + r
    constexpr int NW = (SMAX + G - 1) / G;
    int32_t window[NW];
#pragma unroll
    for (int w = 0; w < NW; ++w)
      window[w] = listed && w * G + r < fc.sigma ? __ldg(qrow + w * G + r) : 0;
    uint32_t own[SMAX];
    group_fetch<SMAX>(fc, row, live, own);
#pragma unroll
    for (int j = 0; j < SMAX; ++j) {
      if (j < fc.sigma)
        compare((int32_t)group_pass(row, live, j, own[j]),
                __shfl_sync(0xFFFFFFFFu, window[j / G], gbase + j % G));
    }
  } else {
    int32_t window = 0;
    for (int j = 0; j < fc.sigma; ++j) {
      const int k = j & (G - 1);
      if (k == 0) window = listed && j + r < fc.sigma ? __ldg(qrow + j + r) : 0;
      compare((int32_t)group_term(fc, row, live, j),
              __shfl_sync(0xFFFFFFFFu, window, gbase + k));
    }
  }
  int lt = live && (row.row_len < qlen || (row.row_len == qlen && t_lt));
  int eq = live && row.row_len == qlen && t_eq;
  const unsigned gm = group_mask<G>();
  lt = __reduce_add_sync(gm, lt);
  eq = __reduce_add_sync(gm, eq);
  if (listed && r == 0) {
    cnt_lt[q] = lt;
    cnt_eq[q] = eq;
  }
}

// the generic instance (block_size > 32): one thread walks a query's block
template <int SMAX>
__global__ void block_decode_walk_kernel(FrontCoded fc, const int32_t* __restrict__ sec_in,
                                         const int32_t* __restrict__ blk,
                                         const int32_t* __restrict__ q_terms,
                                         const int32_t* __restrict__ q_len, long long n_q,
                                         int32_t* __restrict__ cnt_lt,
                                         int32_t* __restrict__ cnt_eq) {
  __shared__ int32_t sec[SMAX + 1];
  for (int s = threadIdx.x; s <= fc.sigma; s += blockDim.x) sec[s] = sec_in[s];
  __syncthreads();
  long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= n_q) return;
  int b = blk[q];
  int qlen = q_len[q];
  int32_t qt[SMAX];
  uint32_t cur[SMAX];
#pragma unroll
  for (int j = 0; j < SMAX; ++j) {
    qt[j] = j < fc.sigma ? q_terms[q * fc.sigma + j] : 0;
    cur[j] = 0;
  }
  uint32_t off = fc.block_base[b];
  int lt = 0, eq = 0;
  for (int r = 0; r < fc.block_size; ++r) {
    int row_len;
    off += decode_row<SMAX>(fc, sec, b * fc.block_size + r, off, cur, row_len);
    bool t_lt = false, t_eq = true;
#pragma unroll
    for (int j = 0; j < SMAX; ++j) {
      if (j < fc.sigma && t_eq && (int32_t)cur[j] != qt[j]) {
        t_lt = (int32_t)cur[j] < qt[j];
        t_eq = false;
      }
    }
    lt += (row_len < qlen) || (row_len == qlen && t_lt);
    eq += row_len == qlen && t_eq;
  }
  cnt_lt[q] = lt;
  cnt_eq[q] = eq;
}

struct DecodeArgs {
  const int32_t *sec, *blk, *q_terms, *q_len;
  long long n_q;
  int32_t *lt, *eq;
};

template <int G, int SMAX>
static int launch_held(FrontCoded fc, DecodeArgs a, cudaStream_t stream) {
  long long blocks = (a.n_q * G + GROUP_THREADS - 1) / GROUP_THREADS;
  block_decode_kernel<G, SMAX><<<(unsigned int)blocks, GROUP_THREADS, 0, stream>>>(
      fc, a.sec, a.blk, a.q_terms, a.q_len, a.n_q, a.lt, a.eq);
  return (int)cudaGetLastError();
}

template <int G>
static int launch_group(FrontCoded fc, DecodeArgs a, cudaStream_t stream) {
  if (fc.sigma <= 8) return launch_held<G, 8>(fc, a, stream);
  if (fc.sigma <= 32) return launch_held<G, 32>(fc, a, stream);
  return launch_held<G, 0>(fc, a, stream);
}

template <int SMAX>
static int launch_walk(FrontCoded fc, DecodeArgs a, cudaStream_t stream) {
  const int threads = 128;
  long long blocks = (a.n_q + threads - 1) / threads;
  block_decode_walk_kernel<SMAX><<<(unsigned int)blocks, threads, 0, stream>>>(
      fc, a.sec, a.blk, a.q_terms, a.q_len, a.n_q, a.lt, a.eq);
  return (int)cudaGetLastError();
}

// Loads every instance into the context now, when build.entries() loads the
// library.  Otherwise the first launch pays for it: the library's own
// (static) CUDA runtime starts up and CUDA loads the kernel lazily, which
// put 4-92 ms into the streaming path's first decode on the H100 (PERF.md).
template <int G>
static void load_group(cudaFuncAttributes* a) {
  cudaFuncGetAttributes(a, block_decode_kernel<G, 8>);
  cudaFuncGetAttributes(a, block_decode_kernel<G, 32>);
  cudaFuncGetAttributes(a, block_decode_kernel<G, 0>);
}

extern "C" int block_decode_load() {
  cudaFuncAttributes a;
  load_group<1>(&a);
  load_group<4>(&a);
  load_group<8>(&a);
  load_group<16>(&a);
  load_group<32>(&a);
  cudaFuncGetAttributes(&a, block_decode_walk_kernel<8>);
  cudaFuncGetAttributes(&a, block_decode_walk_kernel<32>);
  cudaFuncGetAttributes(&a, block_decode_walk_kernel<256>);
  return (int)cudaGetLastError();
}

extern "C" int block_decode_launch(const void* lcps, long long nw_lcp,
                                   const void* payload, long long nw_pay,
                                   const void* block_base, const void* sec,
                                   const void* blk, const void* q_terms,
                                   const void* q_len, long long n_q, int sigma,
                                   int term_bits, int lcp_width, int block_size,
                                   int len_off, void* lt, void* eq, void* stream) {
  if (sigma < 1 || sigma > FC_MAX_SEC - 1 || block_size < 1)
    return (int)cudaErrorInvalidValue;
  FrontCoded fc{(const uint32_t*)lcps, (int)nw_lcp, (const uint32_t*)payload,
                (int)nw_pay, (const uint32_t*)block_base, sigma, term_bits,
                lcp_width, block_size, len_off};
  DecodeArgs a{(const int32_t*)sec, (const int32_t*)blk, (const int32_t*)q_terms,
               (const int32_t*)q_len, n_q, (int32_t*)lt, (int32_t*)eq};
  cudaStream_t s = (cudaStream_t)stream;
  if (block_size <= 1) return launch_group<1>(fc, a, s);
  if (block_size <= 4) return launch_group<4>(fc, a, s);
  if (block_size <= 8) return launch_group<8>(fc, a, s);
  if (block_size <= 16) return launch_group<16>(fc, a, s);
  if (block_size <= 32) return launch_group<32>(fc, a, s);
  if (sigma <= 8) return launch_walk<8>(fc, a, s);
  if (sigma <= 32) return launch_walk<32>(fc, a, s);
  return launch_walk<256>(fc, a, s);
}
