// hash_combine: the sort-free map-side combiner, hand-written for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/hash_combine.py::hash_combine.
// Per block of `block` records, every row hashes its key lanes (the shuffle's
// fold hash) into one of 2 * block slots; the smallest row index of each slot
// wins it; every row whose key equals its winner's key gives the winner its
// weight (sums wrap mod 2^32); rows that lost the slot to another key keep
// theirs.  Row order never changes.  Keys and weights are uint32 values
// stored as int64 (the port's lane type); the output weight lane is int64 too,
// written through a row stride into `out`, which may be the weight column
// itself (the combiner then rewrites the job's records in place).
//
// What bounds it on the H100: bytes.  The table's bound counts the values
// once: N * (4 * K + 8) bytes as uint32, N * (8 * K + 16) as stored.  In place
// on the job's records [N, K + 1] int64 the card moves more: each 32-byte row
// (K = 3) is read, and its sector written back whole, 64 bytes a row, 0.40 ms
// at the streaming path's base batch (21,126,610 rows) at 3.35 TB/s.  The
// first port (one thread per row, scalar 8-byte loads at a 32-byte stride, the
// representative's key read a second time, a fresh [N] output that the stage
// then copied into the weight column) took 0.2955-0.2972 ms on the device for
// the kernel alone, plus that copy's second launch (NVIDIA H100 80GB HBM3,
// 700 W, chip_smoke.py).
//
// Design of the records instance (K = 1-4 key lanes, a template): keys and
// weight are the contiguous rows [N, K + 1] of suffix_sigma.make_records,
// their base 16-byte aligned.
//  * Persistent grid: each block walks tiles of kTile = 1024 rows, whole
//    combine blocks (block <= 1024 divides the tile), so the rule stays per
//    `block` rows from row 0.
//  * A tile is one flat byte span (24-byte rows at K = 2 too), copied into
//    shared memory with 16-byte cp.async, double-buffered: the next tile
//    loads while this one combines.
//  * The keys are narrowed to uint32 into a column-major shared array as the
//    rows are hashed; the min-index winner is a shared atomicMin, the key
//    compare with the representative reads that array (no second global
//    read), and the sum a shared atomicAdd mod 2^32.
//  * Write-back in place (out is the weight column): the tile's whole rows
//    are stored from shared memory with 16-byte stores in address order
//    (full sectors).  The weight word alone, stored while the tile's sectors
//    are still in L2, was built and measured slower: 0.5595-0.5617 ms
//    against 0.4750-0.4805 at the base batch (PERF.md).  A separate
//    `out` takes the weight words.
// Measured in place at the base batch: 0.4753-0.4810 ms on the device, and
// the combine stage 0.4800-0.4836 ms in one launch against the first port's
// 0.8040-0.8055 ms in two (NVIDIA H100 80GB HBM3, 700 W, parent and change
// in one call; chip_smoke.py prints the stage's line).
// Any other layout (strided views of separate tensors, K > 4, an unaligned
// base) takes the generic instance: one thread block per combine block, one
// thread per row, as the first port.  Rows past N are the TPU kernel's zero
// pad rows; they have a larger index than every real row of their block, so
// they never win a slot that a real row hashes into, and are not inserted.
#include <cstdint>
#include <cuda_runtime.h>

#include "async_copy.cuh"

namespace {

constexpr int kThreads = 256;                 // records instance
constexpr int kTile = 1024;                   // rows a tile: whole combine blocks
constexpr int kPer = kTile / kThreads;        // rows a thread

struct Args {
  const long long* keys;     // row i, lane c at keys[i * key_stride + c]
  long long key_stride;
  const long long* weights;  // weights[i * weight_stride]
  long long weight_stride;
  long long n;
  int n_keys;
  int block;                 // rows a combine block, a power of two <= 1024
  long long* out;            // out[i * out_stride]
  long long out_stride;
};

// one lane folded into the hash: h ^ (key + GOLDEN), as repro parses it
__device__ __forceinline__ uint32_t fold(uint32_t h, uint32_t key) {
  h = h ^ (key + 0x9E3779B9u);
  h *= 2654435761u;
  h ^= h >> 15;
  h *= 2246822519u;
  h ^= h >> 13;
  return h;
}

template <int K>
constexpr size_t smem_bytes() {
  return K == 0 ? 0
                : 2 * kTile * (K + 1) * sizeof(long long)   // two staged tiles
                      + (size_t)K * kTile * sizeof(uint32_t)  // narrowed keys
                      + 2 * kTile * sizeof(int32_t)           // slot winners
                      + kTile * sizeof(uint32_t);             // weight totals
}

// K = 1-4: the records instance; K = 0: the generic instance (blockDim.x =
// block threads, one combine block each)
template <int K>
__global__ void __launch_bounds__(K == 0 ? 1024 : kThreads)
    hash_combine_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  if constexpr (K == 0) {
    int32_t* winner = (int32_t*)smem;                      // [2 * block]
    uint32_t* totals = (uint32_t*)(winner + 2 * a.block);  // [block]
    const int i = threadIdx.x;
    const int block = a.block;
    for (int s = i; s < 2 * block; s += block) winner[s] = block;
    totals[i] = 0u;
    __syncthreads();

    const long long row = (long long)blockIdx.x * block + i;
    const bool real = row < a.n;
    const long long* k = a.keys + (real ? row : 0) * a.key_stride;
    uint32_t h = 0u;
    for (int c = 0; c < a.n_keys; ++c) h = fold(h, real ? (uint32_t)k[c] : 0u);
    const int slot = (int)(h & (uint32_t)(2 * block - 1));
    atomicMin(&winner[slot], i);
    __syncthreads();

    const int rep = winner[slot];
    const long long rep_row = (long long)blockIdx.x * block + rep;
    const bool rep_real = rep_row < a.n;
    const long long* rk = a.keys + (rep_real ? rep_row : 0) * a.key_stride;
    bool match = true;
    for (int c = 0; c < a.n_keys && match; ++c) {
      uint32_t x = real ? (uint32_t)k[c] : 0u;
      uint32_t y = rep_real ? (uint32_t)rk[c] : 0u;
      match = x == y;
    }
    const uint32_t w = real ? (uint32_t)a.weights[row * a.weight_stride] : 0u;
    if (match) atomicAdd(&totals[rep], w);
    __syncthreads();   // every weight is read before any is written (out may alias)
    if (real)
      a.out[row * a.out_stride] =
          (long long)(rep == i ? totals[i] : (match ? 0u : w));
  } else {
    constexpr int cols = K + 1;
    long long* tiles = (long long*)smem;                        // [2][kTile * cols]
    uint32_t* skey = (uint32_t*)(tiles + 2 * kTile * cols);     // [K][kTile]
    int32_t* winner = (int32_t*)(skey + K * kTile);             // [2 * kTile]
    uint32_t* totals = (uint32_t*)(winner + 2 * kTile);         // [kTile]
    const long long* rec = a.keys;                              // [n, cols]
    const long long n_tiles = (a.n + kTile - 1) / kTile;
    const uint32_t slot_mask = (uint32_t)(2 * a.block - 1);
    const bool rows_out = a.out == a.weights && a.out_stride == cols;

    // the tile's rows as one flat span of int64 words, 16 bytes a copy
    auto prefetch = [&](long long tile, long long* buf) {
      const long long t0 = tile * kTile;
      const int words = (int)((a.n - t0 < kTile ? a.n - t0 : kTile) * cols);
      const long long* src = rec + t0 * cols;
      for (int v = 2 * threadIdx.x; v < words; v += 2 * kThreads) {
        if (v + 1 < words) {
          cp_async16(buf + v, src + v);
        } else {
          cp_async8(buf + v, src + v);
        }
      }
    };

    long long tile = blockIdx.x;
    if (tile < n_tiles) prefetch(tile, tiles);
    cp_async_commit();
    for (int it = 0; tile < n_tiles; ++it, tile += gridDim.x) {
      long long* buf = tiles + (it & 1) * kTile * cols;
      if (tile + gridDim.x < n_tiles)
        prefetch(tile + gridDim.x, tiles + ((it + 1) & 1) * kTile * cols);
      cp_async_commit();
      for (int s = threadIdx.x; s < 2 * kTile; s += kThreads) winner[s] = a.block;
      for (int r = threadIdx.x; r < kTile; r += kThreads) totals[r] = 0u;
      cp_async_wait<1>();            // this tile's copies (the next may fly)
      __syncthreads();

      const long long t0 = tile * kTile;
      const int rows = (int)(a.n - t0 < kTile ? a.n - t0 : kTile);
      int slot[kPer];
      uint32_t w[kPer];
      // 1. hash each row out of the staged tile, narrowing its keys
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int r = threadIdx.x + j * kThreads;
        if (r < rows) {
          const long long* row = buf + r * cols;
          uint32_t h = 0u;
#pragma unroll
          for (int c = 0; c < K; ++c) {
            const uint32_t key = (uint32_t)row[c];
            skey[c * kTile + r] = key;
            h = fold(h, key);
          }
          w[j] = (uint32_t)row[K];
          const int first = r & ~(a.block - 1);        // its combine block's row 0
          slot[j] = 2 * first + (int)(h & slot_mask);  // that block's 2 * block slots
          atomicMin(&winner[slot[j]], r - first);
        }
      }
      __syncthreads();
      // 2. rows whose key equals their winner's give it their weight
      int rep[kPer];
      bool match[kPer];
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int r = threadIdx.x + j * kThreads;
        if (r < rows) {
          rep[j] = (r & ~(a.block - 1)) + winner[slot[j]];
          bool m = true;
#pragma unroll
          for (int c = 0; c < K; ++c) m &= skey[c * kTile + r] == skey[c * kTile + rep[j]];
          match[j] = m;
          if (m) atomicAdd(&totals[rep[j]], w[j]);
        }
      }
      __syncthreads();
      // 3. the combined weights
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int r = threadIdx.x + j * kThreads;
        if (r < rows) {
          const long long v =
              (long long)(rep[j] == r ? totals[r] : (match[j] ? 0u : w[j]));
          if (rows_out) {
            buf[r * cols + K] = v;
          } else {
            a.out[(t0 + r) * a.out_stride] = v;
          }
        }
      }
      if (rows_out) {        // the whole rows back, in address order
        __syncthreads();
        const int words = rows * cols;
        long long* dst = a.out - K + t0 * cols;          // the records' row t0
        for (int v = 2 * threadIdx.x; v < words; v += 2 * kThreads) {
          if (v + 1 < words) {
            *(longlong2*)(dst + v) = *(const longlong2*)(buf + v);
          } else {
            dst[v] = buf[v];
          }
        }
      }
      __syncthreads();       // buf, the winners and totals are reused
    }
    cp_async_wait<0>();
  }
}

// the records instances use more than 48 KB of shared memory, which a kernel
// must be granted, once on each device
template <int K>
int prepare() {
  static unsigned long long done = 0;   // a bit per device
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 64 && (done >> dev & 1ull)) return 0;
  cudaError_t err = cudaFuncSetAttribute(hash_combine_kernel<K>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem_bytes<K>());
  if (err == cudaSuccess && dev < 64) done |= 1ull << dev;
  return (int)err;
}

template <int K>
int launch_records(const Args& a, cudaStream_t stream) {
  int err = prepare<K>();
  if (err) return err;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, hash_combine_kernel<K>,
                                                kThreads, smem_bytes<K>());
  const long long n_tiles = (a.n + kTile - 1) / kTile;
  long long blocks = (long long)sms * (per_sm > 0 ? per_sm : 1);
  if (blocks > n_tiles) blocks = n_tiles;
  hash_combine_kernel<K><<<(unsigned int)blocks, kThreads, smem_bytes<K>(), stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Load every instance now and grant the records instances their shared
// memory, so that neither waits inside a first launch.
extern "C" int hash_combine_load() {
  int err = prepare<1>();
  if (!err) err = prepare<2>();
  if (!err) err = prepare<3>();
  if (!err) err = prepare<4>();
  cudaFuncAttributes attr;
  if (!err) err = (int)cudaFuncGetAttributes(&attr, hash_combine_kernel<0>);
  return err;
}

// records != 0: keys and weights are the rows [n, n_keys + 1] of one
// contiguous int64 matrix with a 16-byte aligned base, n_keys <= 4 (the
// records instance); else any strides (the generic instance).  out may alias
// the weights.
extern "C" int hash_combine_launch(const void* keys, long long key_stride,
                                   const void* weights, long long weight_stride,
                                   long long n, int n_keys, int block, void* out,
                                   long long out_stride, int records,
                                   void* stream) {
  if (block < 32 || block > 1024 || (block & (block - 1)) || n_keys < 1)
    return (int)cudaErrorInvalidValue;
  const Args a{(const long long*)keys, key_stride, (const long long*)weights,
               weight_stride, n, n_keys, block, (long long*)out, out_stride};
  cudaStream_t s = (cudaStream_t)stream;
  if (records) {
    if (n_keys > 4 || key_stride != n_keys + 1 || weight_stride != key_stride ||
        a.weights != a.keys + n_keys || ((uintptr_t)keys & 15))
      return (int)cudaErrorInvalidValue;
    switch (n_keys) {
      case 1: return launch_records<1>(a, s);
      case 2: return launch_records<2>(a, s);
      case 3: return launch_records<3>(a, s);
      default: return launch_records<4>(a, s);
    }
  }
  const long long blocks = (n + block - 1) / block;
  const size_t smem = (size_t)3 * block * sizeof(int32_t);
  hash_combine_kernel<0><<<(unsigned int)blocks, block, smem, s>>>(a);
  return (int)cudaGetLastError();
}
