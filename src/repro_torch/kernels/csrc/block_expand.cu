// block_expand: the compressed-merge decode, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/block_expand.py::block_expand.
// For each requested block id it decodes the block's front-coded rows (see
// front_code.cuh) and writes them either as int32 term rows
// [B, block_size, sigma] or, packed MSB-first into uint32-valued int64 lanes
// exactly as mapreduce/pack.py::pack_terms packs them, into a row-strided
// [n, n_lanes] destination (n <= B * block_size; rows at or past n are not
// written).  decode_segment calls it once per decoded rung with the lanes
// going straight into the segment's key matrix, so neither the int32 term
// tile nor a packing pass touches device memory.
//
// Design: for block_size <= 32 a group of G lanes (G the next power of two
// >= max(block_size, 4); a block of 2 rows takes a group of 4 with two idle
// lanes) decodes one block, lane r owning row r: a scan of the stored
// counts gives every row's payload offset, and a ballot and a shuffle per
// column hand each term from the row that stores it to the rows that inherit
// it (front_code.cuh).  No row waits on the row before it; a lane's loads
// wait only on its block's base and its own lcp, and for sigma <= 32 it
// issues all of them before it uses any.  The rows' values (terms, or lanes
// packed in registers) then leave through a per-warp shared tile in address
// order, so a warp's stores cover whole sectors instead of one 8-byte lane
// per row each.  A larger block_size takes the generic instance: one thread
// walks a block's rows in order (the first port's design), so every
// block_size that compress_index accepts decodes here.  The sigma+1 section
// starts sit in shared memory.
//
// Bound on the H100 (3.35 TB/s): the stream words the requested blocks cover
// (lcp and payload bits, block_base, the block ids) read once and the output
// written once; the bit arithmetic, ballots and shuffles are a few dozen
// integer operations per row, far below the 67 T/s scalar rate, so bytes
// bound it.  At the streaming path's launches (20-23 k blocks) that bound is
// about a microsecond, below a launch's own latency, so a decode launch
// costs a few microseconds on the device whatever its design.
#include <cstdint>
#include <cuda_runtime.h>

#include "front_code.cuh"

// Where a decoded row goes: int32 terms (bits == 0, per == 1; stride sigma)
// or packed lanes (bits > 0: per terms of `bits` bits to an int64 lane
// holding a uint32 value), row `row` at ptr + row * stride, for rows below
// n_rows.
struct RowOut {
  void* ptr;
  long long n_rows, stride;
  int bits, per;

  __device__ __forceinline__ void store(long long row, int i, uint32_t v) const {
    if (bits == 0)
      static_cast<int32_t*>(ptr)[row * stride + i] = (int32_t)v;
    else
      static_cast<long long*>(ptr)[row * stride + i] = (long long)v;
  }
};

// Turns one row's terms, column by column, into its output values: the
// terms themselves, or the lanes they pack into (MSB-first, the shifted
// terms added in uint32 arithmetic as pack_terms sums them).  emit(i, v)
// takes value i once it is complete.
struct RowPacker {
  uint32_t acc = 0;
  int slot = 0, n = 0;

  template <class Emit>
  __device__ __forceinline__ void put(const RowOut& o, int sigma, int j, uint32_t v,
                                      Emit emit) {
    acc += v << ((o.per - 1 - slot) * o.bits);
    if (++slot == o.per || j == sigma - 1) {
      emit(n++, acc);
      acc = 0;
      slot = 0;
    }
  }
};

// Threads of a group-decode CTA: 8 warps, the shared tiles sized for them.
constexpr int GROUP_THREADS = 256;

// G lanes a block; SMAX > 0: sigma <= SMAX, the row's values held in
// registers, then stored through a per-warp [32][SMAX + 1] shared tile in
// address order; SMAX == 0: any sigma, a column's loads and stores at a time
template <int G, int SMAX>
__global__ void __launch_bounds__(GROUP_THREADS)
block_expand_kernel(FrontCoded fc, const int32_t* __restrict__ sec_in,
                    const int32_t* __restrict__ blk, long long n_blk, RowOut out) {
  __shared__ int32_t sec[FC_MAX_SEC];
  for (int s = threadIdx.x; s <= fc.sigma; s += blockDim.x) sec[s] = sec_in[s];
  __syncthreads();
  // blockDim.x is a multiple of 32, so a group never straddles two warps;
  // lanes past the list stay in the loop for the warp's ballots and shuffles
  long long q = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / G;
  const int r = threadIdx.x & (G - 1);
  const bool listed = q < n_blk;
  const int b = listed ? __ldg(blk + q) : 0;
  const bool live = listed && r < fc.block_size;
  GroupRow row = group_row<G>(fc, sec, b, live);
  const long long out_row = q * fc.block_size + r;
  const bool store = live && out_row < out.n_rows;
  if constexpr (SMAX > 0) {
    constexpr int TILE = 32 * (SMAX + 1);
    __shared__ uint32_t tiles[(GROUP_THREADS / 32) * TILE];
    const int lane = threadIdx.x & 31;
    uint32_t own[SMAX];
    group_fetch<SMAX>(fc, row, live, own);
    // the row's output values into the warp's tile
    uint32_t* tile = tiles + (threadIdx.x >> 5) * TILE;
    uint32_t* mine = tile + lane * (SMAX + 1);
    RowPacker pack;
#pragma unroll
    for (int j = 0; j < SMAX; ++j) {
      if (j < fc.sigma)
        pack.put(out, fc.sigma, j, group_pass(row, live, j, own[j]),
                 [&](int i, uint32_t v) { mine[i] = v; });
    }
    const int n_vals = pack.n;
    __syncwarp();
    // out of the tile: element e of the warp's rows is row e / n_vals, value
    // e % n_vals, so consecutive lanes store to consecutive addresses of a
    // row and of the next one
    for (int e = lane; e < 32 * n_vals; e += 32) {   // n_vals trips on every lane
      const int src = e / n_vals, l = e - src * n_vals;
      const long long dst_row = __shfl_sync(0xFFFFFFFFu, out_row, src);
      if (__shfl_sync(0xFFFFFFFFu, (int)store, src))
        out.store(dst_row, l, tile[src * (SMAX + 1) + l]);
    }
  } else {
    RowPacker pack;
    for (int j = 0; j < fc.sigma; ++j)
      pack.put(out, fc.sigma, j, group_term(fc, row, live, j), [&](int i, uint32_t v) {
        if (store) out.store(out_row, i, v);
      });
  }
}

// the generic instance (block_size > 32): one thread walks a block
template <int SMAX>
__global__ void block_expand_walk_kernel(FrontCoded fc, const int32_t* __restrict__ sec_in,
                                         const int32_t* __restrict__ blk,
                                         long long n_blk, RowOut out) {
  __shared__ int32_t sec[SMAX + 1];
  for (int s = threadIdx.x; s <= fc.sigma; s += blockDim.x) sec[s] = sec_in[s];
  __syncthreads();
  long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= n_blk) return;
  int b = blk[q];
  uint32_t off = fc.block_base[b];
  uint32_t cur[SMAX];
#pragma unroll
  for (int j = 0; j < SMAX; ++j) cur[j] = 0;
  for (int r = 0; r < fc.block_size; ++r) {
    long long out_row = q * fc.block_size + r;
    if (out_row >= out.n_rows) break;
    int row_len;
    off += decode_row<SMAX>(fc, sec, b * fc.block_size + r, off, cur, row_len);
    RowPacker pack;
#pragma unroll
    for (int j = 0; j < SMAX; ++j) {
      if (j < fc.sigma)
        pack.put(out, fc.sigma, j, cur[j], [&](int i, uint32_t v) { out.store(out_row, i, v); });
    }
  }
}

template <int G, int SMAX>
static int launch_held(FrontCoded fc, const void* sec, const void* blk,
                       long long n_blk, RowOut out, cudaStream_t stream) {
  long long blocks = (n_blk * G + GROUP_THREADS - 1) / GROUP_THREADS;
  block_expand_kernel<G, SMAX><<<(unsigned int)blocks, GROUP_THREADS, 0, stream>>>(
      fc, (const int32_t*)sec, (const int32_t*)blk, n_blk, out);
  return (int)cudaGetLastError();
}

template <int G>
static int launch_group(FrontCoded fc, const void* sec, const void* blk,
                        long long n_blk, RowOut out, cudaStream_t stream) {
  if (fc.sigma <= 8) return launch_held<G, 8>(fc, sec, blk, n_blk, out, stream);
  if (fc.sigma <= 32) return launch_held<G, 32>(fc, sec, blk, n_blk, out, stream);
  return launch_held<G, 0>(fc, sec, blk, n_blk, out, stream);
}

template <int SMAX>
static int launch_walk(FrontCoded fc, const void* sec, const void* blk,
                       long long n_blk, RowOut out, cudaStream_t stream) {
  const int threads = 128;
  long long blocks = (n_blk + threads - 1) / threads;
  block_expand_walk_kernel<SMAX><<<(unsigned int)blocks, threads, 0, stream>>>(
      fc, (const int32_t*)sec, (const int32_t*)blk, n_blk, out);
  return (int)cudaGetLastError();
}

// Loads every instance into the context now, when build.entries() loads the
// library.  Otherwise the first launch pays for it: the library's own
// (static) CUDA runtime starts up and CUDA loads the kernel lazily, which
// put 4-92 ms into the streaming path's first decode on the H100 (PERF.md).
template <int G>
static void load_group(cudaFuncAttributes* a) {
  cudaFuncGetAttributes(a, block_expand_kernel<G, 8>);
  cudaFuncGetAttributes(a, block_expand_kernel<G, 32>);
  cudaFuncGetAttributes(a, block_expand_kernel<G, 0>);
}

extern "C" int block_expand_load() {
  cudaFuncAttributes a;
  load_group<1>(&a);
  load_group<4>(&a);
  load_group<8>(&a);
  load_group<16>(&a);
  load_group<32>(&a);
  cudaFuncGetAttributes(&a, block_expand_walk_kernel<8>);
  cudaFuncGetAttributes(&a, block_expand_walk_kernel<32>);
  cudaFuncGetAttributes(&a, block_expand_walk_kernel<256>);
  return (int)cudaGetLastError();
}

// out: int32 terms (pack_bits == 0, row_stride sigma) or int64 lanes of
// pack_bits-bit terms (row_stride in int64 elements); rows >= n_rows unwritten
extern "C" int block_expand_launch(const void* lcps, long long nw_lcp,
                                   const void* payload, long long nw_pay,
                                   const void* block_base, const void* sec,
                                   const void* blk, long long n_blk, int sigma,
                                   int term_bits, int lcp_width, int block_size,
                                   int len_off, void* out, long long n_rows,
                                   long long row_stride, int pack_bits,
                                   void* stream) {
  if (sigma < 1 || sigma > FC_MAX_SEC - 1 || block_size < 1 || pack_bits < 0 ||
      pack_bits > 32)
    return (int)cudaErrorInvalidValue;
  FrontCoded fc{(const uint32_t*)lcps, (int)nw_lcp, (const uint32_t*)payload,
                (int)nw_pay, (const uint32_t*)block_base, sigma, term_bits,
                lcp_width, block_size, len_off};
  int per = pack_bits ? (32 / pack_bits > 1 ? 32 / pack_bits : 1) : 1;
  RowOut o{out, n_rows, row_stride, pack_bits, per};
  cudaStream_t s = (cudaStream_t)stream;
  if (block_size <= 1) return launch_group<1>(fc, sec, blk, n_blk, o, s);
  if (block_size <= 4) return launch_group<4>(fc, sec, blk, n_blk, o, s);
  if (block_size <= 8) return launch_group<8>(fc, sec, blk, n_blk, o, s);
  if (block_size <= 16) return launch_group<16>(fc, sec, blk, n_blk, o, s);
  if (block_size <= 32) return launch_group<32>(fc, sec, blk, n_blk, o, s);
  if (sigma <= 8) return launch_walk<8>(fc, sec, blk, n_blk, o, s);
  if (sigma <= 32) return launch_walk<32>(fc, sec, blk, n_blk, o, s);
  return launch_walk<256>(fc, sec, blk, n_blk, o, s);
}
