// hash_combine: the sort-free map-side combiner, hand-written for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/hash_combine.py::hash_combine.
// Per block of `block` records, every row hashes its key lanes (the shuffle's
// fold hash) into one of n_slots slots; the smallest row index of each slot
// wins it; every row whose key equals its winner's key gives the winner its
// weight (sums wrap mod 2^32); rows that lost the slot to another key keep
// theirs.  Row order never changes.  Keys and weights are uint32 values
// stored as int64 (the port's lane type); the output weight lane is int64 too.
// Keys and weights are read through row strides, so the combiner reads the
// job's records [N, K + 1] in place: keys are the first K lanes of a row and
// the weight its last.
//
// Design: one thread block per record block, one thread per row.  The slot
// table (atomicMin of the row index) and the per-row weight totals (integer
// atomicAdd) live in shared memory, so the min-index winner of the TPU
// kernel's [B, S] one-hot planes is reproduced exactly without them.  Rows
// past N are the TPU kernel's zero pad rows: zero keys, zero weight, and a
// larger index than every real row of the block, so they never absorb a real
// row's weight.
//
// Bound on the H100 (3.35 TB/s): 8 bytes per key lane and 8 bytes of weight
// read, 8 bytes of weight written per row: N * (8 * K + 16) / 3.35e12 s as
// stored; half that, N * (4 * K + 8), for the uint32 values themselves.  The
// representative's key row is a second read, mostly from L1.
#include <cstdint>
#include <cuda_runtime.h>

__global__ void hash_combine_kernel(const long long* __restrict__ keys,
                                    long long key_stride,
                                    const long long* __restrict__ weights,
                                    long long weight_stride, long long n,
                                    int n_keys, int n_slots,
                                    long long* __restrict__ out) {
  extern __shared__ int32_t smem[];
  int32_t* winner = smem;                              // [n_slots]
  uint32_t* totals = (uint32_t*)(smem + n_slots);      // [blockDim.x]
  const int i = threadIdx.x;
  const int block = blockDim.x;
  for (int s = i; s < n_slots; s += block) winner[s] = block;
  totals[i] = 0u;
  __syncthreads();

  const long long row = (long long)blockIdx.x * block + i;
  const bool real = row < n;
  const long long* k = keys + (real ? row : 0) * key_stride;
  uint32_t h = 0u;
  for (int c = 0; c < n_keys; ++c) {
    uint32_t key = real ? (uint32_t)k[c] : 0u;
    h = h ^ (key + 0x9E3779B9u);          // h ^ (key + GOLDEN), as repro parses it
    h *= 2654435761u;
    h ^= h >> 15;
    h *= 2246822519u;
    h ^= h >> 13;
  }
  const int slot = (int)(h % (uint32_t)n_slots);
  atomicMin(&winner[slot], i);
  __syncthreads();

  const int rep = winner[slot];
  const long long rep_row = (long long)blockIdx.x * block + rep;
  const bool rep_real = rep_row < n;
  const long long* rk = keys + (rep_real ? rep_row : 0) * key_stride;
  bool match = true;
  for (int c = 0; c < n_keys && match; ++c) {
    uint32_t a = real ? (uint32_t)k[c] : 0u;
    uint32_t b = rep_real ? (uint32_t)rk[c] : 0u;
    match = a == b;
  }
  const uint32_t w = real ? (uint32_t)weights[row * weight_stride] : 0u;
  if (match) atomicAdd(&totals[rep], w);
  __syncthreads();
  if (real) out[row] = (long long)(rep == i ? totals[i] : (match ? 0u : w));
}

extern "C" int hash_combine_launch(const void* keys, long long key_stride,
                                   const void* weights, long long weight_stride,
                                   long long n, int n_keys, int n_slots,
                                   int block, void* out, void* stream) {
  long long blocks = (n + block - 1) / block;
  size_t smem = (size_t)(n_slots + block) * sizeof(int32_t);
  hash_combine_kernel<<<(unsigned int)blocks, block, smem, (cudaStream_t)stream>>>(
      (const long long*)keys, key_stride, (const long long*)weights,
      weight_stride, n, n_keys, n_slots, (long long*)out);
  return (int)cudaGetLastError();
}
