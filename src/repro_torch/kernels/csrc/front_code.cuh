// Front-coded block decode shared by block_expand.cu and block_decode.cu.
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
//
// Two decoders of the same rows:
//
// * The group decode (block_size <= 32; GroupRow, group_row, group_term):
//   a group of G lanes of one warp serves one block, G a power of two >=
//   block_size (the kernels take 1, 4, 8, 16 or 32), and lane r owns row r.
//   Each lane loads its lcp and computes its stored length; an exclusive
//   __shfl_up_sync scan of the stored counts, plus block_base[b], gives
//   every row's payload offset at once.  Column j of row r is the term that the last row r' <= r with
//   lcp[r'] <= j stored there (0 past its stored length, and 0 where no such
//   row exists: the zero row before the block head): one __ballot_sync over
//   the group finds r' (the highest set bit at or below r), lane r' fetched
//   that term, and __shfl_sync hands it over.  The loads of a row depend on
//   one another only as blk -> (block_base, lcp) -> payload: no walk.  For
//   sigma <= 32 a lane issues all its payload loads before it uses any, and
//   its row's terms stay in registers (group_fetch).
// * The serial walk (decode_row; any block_size): one thread steps through
//   its block's rows with the previous row in registers.  The kernels keep it
//   as the generic instance for block_size > 32.
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

// the section starts a kernel keeps in shared memory (sigma <= 256)
#define FC_MAX_SEC 257

// value `pos` of a `width`-bit stream: clamped two-word fetch
__device__ __forceinline__ uint32_t fetch_bits(const uint32_t* words, int nw,
                                               uint32_t pos, int width) {
  uint32_t bitp = pos * (uint32_t)width;
  int w_lo = (int)(bitp >> 5);
  if (w_lo > nw - 1) w_lo = nw - 1;
  int w_hi = w_lo + 1 < nw ? w_lo + 1 : nw - 1;
  uint32_t sh = bitp & 31u;
  uint32_t lo = __ldg(words + w_lo) >> sh;
  // the next word only for a value that straddles into it
  uint32_t hi = sh + (uint32_t)width > 32u ? (__ldg(words + w_hi) << (32u - sh)) : 0u;
  uint32_t mask = width >= 32 ? 0xFFFFFFFFu : ((1u << width) - 1u);
  return (lo | hi) & mask;
}

// the length key of global row g: the section starts at or below it
__device__ __forceinline__ int row_length(const int32_t* sec, int sigma, int g) {
  int row_len = 0;
  for (int s = 0; s <= sigma; ++s) row_len += g >= sec[s];
  return row_len;
}

// store_len (terms the row keeps, clamped to [0, sigma]) and its lcp, clamped
// to store_len as the encoder clamps it
__device__ __forceinline__ void row_shape(const FrontCoded& fc, int row_len,
                                          uint32_t lcp_raw, int& store_len,
                                          int& lcp) {
  store_len = row_len - fc.len_off;
  store_len = store_len < 0 ? 0 : (store_len > fc.sigma ? fc.sigma : store_len);
  lcp = (int)lcp_raw < store_len ? (int)lcp_raw : store_len;
}

// ------------------------------------------------------------ serial walk
// Decode row g into cur[] (which holds the previous row of the block, or
// zeros at the block head) and return the number of payload terms it stores;
// row_len gets the row's length key (sigma + 1 for sentinel rows).
// off = block_base[block] + the terms stored by the earlier rows of the block.
template <int SMAX>
__device__ __forceinline__ int decode_row(const FrontCoded& fc,
                                          const int32_t* sec, int g, uint32_t off,
                                          uint32_t (&cur)[SMAX], int& row_len) {
  row_len = row_length(sec, fc.sigma, g);
  int store_len, lcp;
  row_shape(fc, row_len, fetch_bits(fc.lcps, fc.nw_lcp, (uint32_t)g, fc.lcp_width),
            store_len, lcp);
#pragma unroll
  for (int j = 0; j < SMAX; ++j) {
    if (j < fc.sigma && j >= lcp) {
      cur[j] = j < store_len ? fetch_bits(fc.payload, fc.nw_pay,
                                          off + (uint32_t)(j - lcp), fc.term_bits)
                             : 0u;
    }
  }
  return store_len - lcp;
}

// ------------------------------------------------------------ group decode
// One lane's row of a group-decoded block.
struct GroupRow {
  int row_len, store_len, lcp;
  uint32_t off;      // payload position of the row's first stored term
  unsigned below;    // the group's lanes at or below this one (warp bits)
};

// Every lane of the warp calls this with the same G.  `b` is the lane's
// block (the same for the G lanes of a group); `live` is false for a lane
// past the block's rows or the request list, which then stores nothing and
// sets no ballot bit.
template <int G>
__device__ __forceinline__ GroupRow group_row(const FrontCoded& fc,
                                              const int32_t* sec, int b, bool live) {
  const int lane = threadIdx.x & 31;
  const int r = lane & (G - 1);
  GroupRow row;
  int stored = 0;
  row.row_len = row.store_len = row.lcp = 0;
  uint32_t base = 0;
  if (live) {
    int g = b * fc.block_size + r;
    base = __ldg(fc.block_base + b);
    row.row_len = row_length(sec, fc.sigma, g);
    row_shape(fc, row.row_len,
              fetch_bits(fc.lcps, fc.nw_lcp, (uint32_t)g, fc.lcp_width),
              row.store_len, row.lcp);
    stored = row.store_len - row.lcp;
  }
  // inclusive scan of the stored counts over the group, then exclusive
  int incl = stored;
#pragma unroll
  for (int d = 1; d < G; d <<= 1) {
    int v = __shfl_up_sync(0xFFFFFFFFu, incl, d, G);
    if (r >= d) incl += v;
  }
  row.off = base + (uint32_t)(incl - stored);
  const int gbase = lane & ~(G - 1);
  row.below = ((2u << lane) - 1u) & ~((1u << gbase) - 1u);   // 2u << 31 == 0
  return row;
}

// The terms the lane's row stores, columns [lcp, store_len), into own[] (0
// elsewhere), each one or two loads, every load issued before any is used.
// Every lane of the warp calls this.
template <int SMAX>
__device__ __forceinline__ void group_fetch(const FrontCoded& fc, const GroupRow& row,
                                            bool live, uint32_t (&own)[SMAX]) {
#pragma unroll
  for (int j = 0; j < SMAX; ++j) {
    own[j] = live && j >= row.lcp && j < row.store_len
                 ? fetch_bits(fc.payload, fc.nw_pay, row.off + (uint32_t)(j - row.lcp),
                              fc.term_bits)
                 : 0u;
  }
}

// Column j of the lane's row, given the term the lane stores there (`own`;
// every lane of the warp calls it, with the same j): the last row at or
// below this one whose lcp is at most j defines the column, and its term is
// handed over; with no such row the column is 0.
__device__ __forceinline__ uint32_t group_pass(const GroupRow& row, bool live, int j,
                                               uint32_t own) {
  unsigned m = __ballot_sync(0xFFFFFFFFu, live && row.lcp <= j) & row.below;
  int src = m ? 31 - __clz((int)m) : (int)(threadIdx.x & 31);
  uint32_t v = __shfl_sync(0xFFFFFFFFu, own, src);
  return m ? v : 0u;
}

// group_pass with the lane's own term fetched on the spot: for sigma past
// the register-held instances, one column's loads at a time
__device__ __forceinline__ uint32_t group_term(const FrontCoded& fc,
                                               const GroupRow& row, bool live,
                                               int j) {
  uint32_t own = live && row.lcp <= j && j < row.store_len
                     ? fetch_bits(fc.payload, fc.nw_pay,
                                  row.off + (uint32_t)(j - row.lcp), fc.term_bits)
                     : 0u;
  return group_pass(row, live, j, own);
}

// The G lanes of the group that holds this lane (for __reduce_add_sync).
template <int G>
__device__ __forceinline__ unsigned group_mask() {
  if constexpr (G == 32) {
    return 0xFFFFFFFFu;
  } else {
    const int gbase = (threadIdx.x & 31) & ~(G - 1);
    return ((1u << G) - 1u) << gbase;
  }
}
