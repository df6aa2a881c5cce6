// block_expand: the compressed-merge decode, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/block_expand.py::block_expand.
// For each requested block id it walks the block's front-coding chain (see
// front_code.cuh) and writes the decoded term rows [B, block_size, sigma]
// int32.  decode_segment calls it a chunk of blocks at a time when a
// compaction takes a compressed rung as input.
//
// Design: one thread per requested block walks its block_size rows in order
// with the previous row in registers (a template on the largest sigma, so
// the row loop unrolls and the row stays out of local memory); the sigma+1
// section starts sit in shared memory.  The TPU kernel holds the whole
// streams in VMEM and decodes a tile of blocks in lockstep; here the streams
// stay in HBM/L2 and each thread reads its block's words, which neighbouring
// threads (neighbouring blocks) share.
//
// Bound on the H100 (3.35 TB/s): the stream words the requested blocks cover
// (lcp and payload bits, block_base) read once, plus the int32 output
// written once; the bit arithmetic is a few integer ops per term.
#include <cstdint>
#include <cuda_runtime.h>

#include "front_code.cuh"

template <int SMAX>
__global__ void block_expand_kernel(FrontCoded fc, const int32_t* __restrict__ sec_in,
                                    const int32_t* __restrict__ blk,
                                    long long n_blk, int32_t* __restrict__ out) {
  __shared__ int32_t sec[SMAX + 1];
  for (int s = threadIdx.x; s <= fc.sigma; s += blockDim.x) sec[s] = sec_in[s];
  __syncthreads();
  long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= n_blk) return;
  int b = blk[q];
  int off = (int32_t)fc.block_base[b];
  int32_t cur[SMAX];
#pragma unroll
  for (int j = 0; j < SMAX; ++j) cur[j] = 0;
  int32_t* o = out + q * (long long)fc.block_size * fc.sigma;
  for (int r = 0; r < fc.block_size; ++r) {
    int row_len;
    off += decode_row<SMAX>(fc, sec, b * fc.block_size + r, off, cur, row_len);
#pragma unroll
    for (int j = 0; j < SMAX; ++j) {
      if (j < fc.sigma) o[r * fc.sigma + j] = cur[j];
    }
  }
}

template <int SMAX>
static int launch(FrontCoded fc, const void* sec, const void* blk, long long n_blk,
                  void* out, cudaStream_t stream) {
  const int threads = 128;
  long long blocks = (n_blk + threads - 1) / threads;
  block_expand_kernel<SMAX><<<(unsigned int)blocks, threads, 0, stream>>>(
      fc, (const int32_t*)sec, (const int32_t*)blk, n_blk, (int32_t*)out);
  return (int)cudaGetLastError();
}

extern "C" int block_expand_launch(const void* lcps, long long nw_lcp,
                                   const void* payload, long long nw_pay,
                                   const void* block_base, const void* sec,
                                   const void* blk, long long n_blk, int sigma,
                                   int term_bits, int lcp_width, int block_size,
                                   int len_off, void* out, void* stream) {
  FrontCoded fc{(const uint32_t*)lcps, (int)nw_lcp, (const uint32_t*)payload,
                (int)nw_pay, (const uint32_t*)block_base, sigma, term_bits,
                lcp_width, block_size, len_off};
  cudaStream_t s = (cudaStream_t)stream;
  if (sigma <= 8) return launch<8>(fc, sec, blk, n_blk, out, s);
  if (sigma <= 32) return launch<32>(fc, sec, blk, n_blk, out, s);
  if (sigma <= 256) return launch<256>(fc, sec, blk, n_blk, out, s);
  return (int)cudaErrorInvalidValue;
}
