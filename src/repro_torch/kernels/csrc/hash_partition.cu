// hash_partition: the shuffle partitioner, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/hash_partition.py::hash_partition.  For each key (a
// uint32 value stored as int64) it computes the Knuth multiplicative hash with
// xorshift finalizer, the partition id hash % n_parts (invalid rows get
// n_parts), and the histogram of valid rows over the n_parts partitions.
//
// Design: a grid-stride pass.  Each block keeps an n_parts-bin histogram in
// shared memory (integer atomicAdd, exact), then adds its bins into the global
// histogram with one atomicAdd per non-empty bin.  This replaces the TPU
// kernel's per-block histogram rows and the caller's sum over them.  The
// caller zeroes the global histogram.
//
// Bound on the H100 (3.35 TB/s): 8 bytes of key plus 1 byte of validity in
// and 4 bytes of partition id out per row: N * 13 / 3.35e12 s.
#include <cstdint>
#include <cuda_runtime.h>

__global__ void hash_partition_kernel(const long long* __restrict__ keys,
                                      const uint8_t* __restrict__ valid,
                                      long long n, int n_parts,
                                      int32_t* __restrict__ part,
                                      int32_t* __restrict__ hist) {
  extern __shared__ int32_t bins[];
  for (int b = threadIdx.x; b < n_parts; b += blockDim.x) bins[b] = 0;
  __syncthreads();
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    uint32_t h = (uint32_t)keys[i] * 2654435761u;
    h ^= h >> 15;
    h *= 2246822519u;
    h ^= h >> 13;
    int p = n_parts;
    if (valid[i]) {
      p = (int)(h % (uint32_t)n_parts);
      atomicAdd(&bins[p], 1);
    }
    part[i] = p;
  }
  __syncthreads();
  for (int b = threadIdx.x; b < n_parts; b += blockDim.x) {
    if (bins[b] != 0) atomicAdd(&hist[b], bins[b]);
  }
}

// Load the kernel now, so that its first launch does not wait for it.
extern "C" int hash_partition_load() {
  cudaFuncAttributes attr;
  return (int)cudaFuncGetAttributes(&attr, hash_partition_kernel);
}

extern "C" int hash_partition_launch(const void* keys, const void* valid,
                                     long long n, int n_parts, void* part,
                                     void* hist, int max_blocks, void* stream) {
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > max_blocks) blocks = max_blocks;
  hash_partition_kernel<<<(unsigned int)blocks, threads,
                          n_parts * sizeof(int32_t), (cudaStream_t)stream>>>(
      (const long long*)keys, (const uint8_t*)valid, n, n_parts,
      (int32_t*)part, (int32_t*)hist);
  return (int)cudaGetLastError();
}
