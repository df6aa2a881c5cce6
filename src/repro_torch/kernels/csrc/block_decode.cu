// block_decode: the compressed-index query inner loop, hand-written for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/block_decode.py::block_decode.
// For each query it walks its candidate block's front-coding chain (see
// front_code.cuh) and counts the block rows whose (row_len, terms) key sorts
// strictly below the query's (cnt_lt) and equal to it (cnt_eq).  The head
// binary search picked the block; block * block_size + the counts is the
// query's global lower/upper bound.
//
// Design: one thread per query keeps the previous decoded row and the query's
// terms in registers (a template on the largest sigma unrolls the row loop),
// folds the lexicographic compare into the walk, and writes only the two
// counters.  The section starts sit in shared memory.  The TPU kernel holds
// the streams in VMEM; here the few words of each candidate block are read
// from HBM/L2.
//
// Bound on the H100 (3.35 TB/s): the query terms, length and block id read
// once, the two int32 counters written once, and the stream words of the
// distinct candidate blocks read once.  The reads of a block depend on each
// other through the chain, so the kernel is bound by latency well above that.
#include <cstdint>
#include <cuda_runtime.h>

#include "front_code.cuh"

template <int SMAX>
__global__ void block_decode_kernel(FrontCoded fc, const int32_t* __restrict__ sec_in,
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
  int32_t qt[SMAX], cur[SMAX];
#pragma unroll
  for (int j = 0; j < SMAX; ++j) {
    qt[j] = j < fc.sigma ? q_terms[q * fc.sigma + j] : 0;
    cur[j] = 0;
  }
  int off = (int32_t)fc.block_base[b];
  int lt = 0, eq = 0;
  for (int r = 0; r < fc.block_size; ++r) {
    int row_len;
    off += decode_row<SMAX>(fc, sec, b * fc.block_size + r, off, cur, row_len);
    // lexicographic terms compare: the first differing lane decides
    bool t_lt = false, t_eq = true;
#pragma unroll
    for (int j = 0; j < SMAX; ++j) {
      if (j < fc.sigma && t_eq && cur[j] != qt[j]) {
        t_lt = cur[j] < qt[j];
        t_eq = false;
      }
    }
    lt += (row_len < qlen) || (row_len == qlen && t_lt);
    eq += row_len == qlen && t_eq;
  }
  cnt_lt[q] = lt;
  cnt_eq[q] = eq;
}

template <int SMAX>
static int launch(FrontCoded fc, const void* sec, const void* blk,
                  const void* q_terms, const void* q_len, long long n_q,
                  void* lt, void* eq, cudaStream_t stream) {
  const int threads = 128;
  long long blocks = (n_q + threads - 1) / threads;
  block_decode_kernel<SMAX><<<(unsigned int)blocks, threads, 0, stream>>>(
      fc, (const int32_t*)sec, (const int32_t*)blk, (const int32_t*)q_terms,
      (const int32_t*)q_len, n_q, (int32_t*)lt, (int32_t*)eq);
  return (int)cudaGetLastError();
}

extern "C" int block_decode_launch(const void* lcps, long long nw_lcp,
                                   const void* payload, long long nw_pay,
                                   const void* block_base, const void* sec,
                                   const void* blk, const void* q_terms,
                                   const void* q_len, long long n_q, int sigma,
                                   int term_bits, int lcp_width, int block_size,
                                   int len_off, void* lt, void* eq, void* stream) {
  FrontCoded fc{(const uint32_t*)lcps, (int)nw_lcp, (const uint32_t*)payload,
                (int)nw_pay, (const uint32_t*)block_base, sigma, term_bits,
                lcp_width, block_size, len_off};
  cudaStream_t s = (cudaStream_t)stream;
  if (sigma <= 8) return launch<8>(fc, sec, blk, q_terms, q_len, n_q, lt, eq, s);
  if (sigma <= 32) return launch<32>(fc, sec, blk, q_terms, q_len, n_q, lt, eq, s);
  if (sigma <= 256) return launch<256>(fc, sec, blk, q_terms, q_len, n_q, lt, eq, s);
  return (int)cudaErrorInvalidValue;
}
