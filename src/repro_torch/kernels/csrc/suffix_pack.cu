// suffix_pack: the SUFFIX-sigma map emit, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/suffix_pack.py::suffix_pack.
// For every position i of a PAD(0)-separated token stream it packs the
// sigma-token window tokens[i .. i+sigma), zeroed from the first PAD on,
// most-significant-first into n_lanes uint32 lanes (stored as int64, the
// port's lane type).  Exact uint32 arithmetic: each term is shifted and added
// mod 2^32, as the TPU kernel does.
//
// Design: one thread per position reads its window straight from global
// memory; neighbouring threads read neighbouring addresses, so the sigma
// loads of a warp are coalesced and mostly hit L1/L2.  Reads past N are PAD.
// The TPU kernel's next-block halo ref and its sigma <= block limit are not
// needed: any thread may read any address.
//
// Bound on the H100 (3.35 TB/s): 4 bytes in per position plus
// n_lanes x 8 bytes out, i.e. N * (4 + 8 * n_lanes) / 3.35e12 s; the
// arithmetic (a few integer ops per term) is far below the integer peak.
#include <cstdint>
#include <cuda_runtime.h>

__global__ void suffix_pack_kernel(const int32_t* __restrict__ tokens,
                                   long long n, int sigma, int bits, int per,
                                   int n_lanes, long long* __restrict__ out) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t alive = 1u;
  for (int lane = 0; lane < n_lanes; ++lane) {
    uint32_t acc = 0u;
    for (int slot = 0; slot < per; ++slot) {
      int j = lane * per + slot;
      if (j >= sigma) break;
      long long p = i + j;
      uint32_t tok = p < n ? (uint32_t)tokens[p] : 0u;
      alive &= (tok != 0u) ? 1u : 0u;
      acc += (tok * alive) << (bits * (per - 1 - slot));
    }
    out[i * n_lanes + lane] = (long long)acc;
  }
}

extern "C" int suffix_pack_launch(const void* tokens, long long n, int sigma,
                                  int bits, int per, int n_lanes, void* out,
                                  void* stream) {
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  suffix_pack_kernel<<<(unsigned int)blocks, threads, 0,
                       (cudaStream_t)stream>>>(
      (const int32_t*)tokens, n, sigma, bits, per, n_lanes, (long long*)out);
  return (int)cudaGetLastError();
}
