// Front-coded block walk shared by block_expand.cu and block_decode.cu.
//
// The compressed index (src/repro_torch/index/compress.py) cuts the sorted
// rows into blocks of block_size rows.  Each row is stored as its lcp with the
// previous row of the block (a lcp_width-bit value in the lcp stream) and its
// suffix terms (term_bits each, in the payload stream); block_base[b] is the
// payload position of block b's first stored term.  A row's length key comes
// from the sigma+1 section starts.  Streams are uint32 words, bit b of a
// stream in word b >> 5 at position b & 31; bit positions are uint32 and word
// fetches are clamped into the stream, as the plain version
// (kernels/bitpack.py::extract_bits) and repro's Pallas kernels clamp them.
#pragma once
#include <cstdint>

struct FrontCoded {
  const uint32_t* lcps;
  int nw_lcp;
  const uint32_t* payload;
  int nw_pay;
  const uint32_t* block_base;
  int sigma, term_bits, lcp_width, block_size, len_off;
};

// value `pos` of a `width`-bit stream: clamped two-word fetch
__device__ __forceinline__ uint32_t fetch_bits(const uint32_t* words, int nw,
                                               uint32_t pos, int width) {
  uint32_t bitp = pos * (uint32_t)width;
  int w_lo = (int)(bitp >> 5);
  if (w_lo > nw - 1) w_lo = nw - 1;
  int w_hi = w_lo + 1 < nw ? w_lo + 1 : nw - 1;
  uint32_t sh = bitp & 31u;
  uint32_t lo = __ldg(words + w_lo) >> sh;
  uint32_t hi = sh ? (__ldg(words + w_hi) << (32u - sh)) : 0u;
  uint32_t mask = width >= 32 ? 0xFFFFFFFFu : ((1u << width) - 1u);
  return (lo | hi) & mask;
}

// Decode row g into cur[] (which holds the previous row of the block, or
// zeros at the block head) and return the number of payload terms it stores;
// row_len gets the row's length key (sigma + 1 for sentinel rows).
// off = block_base[block] + the terms stored by the earlier rows of the block.
template <int SMAX>
__device__ __forceinline__ int decode_row(const FrontCoded& fc,
                                          const int32_t* sec, int g, int off,
                                          int32_t (&cur)[SMAX], int& row_len) {
  int lcp = (int)fetch_bits(fc.lcps, fc.nw_lcp, (uint32_t)g, fc.lcp_width);
  row_len = 0;
  for (int s = 0; s <= fc.sigma; ++s) row_len += g >= sec[s];
  int store_len = row_len - fc.len_off;
  store_len = store_len < 0 ? 0 : (store_len > fc.sigma ? fc.sigma : store_len);
  lcp = lcp < store_len ? lcp : store_len;
#pragma unroll
  for (int j = 0; j < SMAX; ++j) {
    if (j < fc.sigma && j >= lcp) {
      cur[j] = j < store_len
                   ? (int32_t)fetch_bits(fc.payload, fc.nw_pay,
                                         (uint32_t)(off + j - lcp), fc.term_bits)
                   : 0;
    }
  }
  return store_len - lcp;
}
