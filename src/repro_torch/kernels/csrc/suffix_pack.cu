// suffix_pack: the SUFFIX-sigma map emit, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/suffix_pack.py::suffix_pack.
// For every position i of a PAD(0)-separated token stream it packs the
// sigma-token window tokens[i .. i+sigma), zeroed from the first PAD on,
// most-significant-first into n_lanes uint32 lanes (stored as int64, the
// port's lane type).  Exact uint32 arithmetic: each term is shifted and added
// mod 2^32, as the TPU kernel does.
//
// What bounds it on the H100: bytes.  4 bytes in and 8 * n_lanes out per
// position (8 more with the weight column, and 4 in and 8 out more with the
// meta column), N * (4 + 8 * n_lanes) / 3.35e12 s as stored; the
// arithmetic (a few integer operations per term) is far below the integer
// peak.  The first port (one thread per position, straight from
// global memory) reached about 1.2 TB/s: each thread stored its n_lanes lanes
// at a stride of 8 * n_lanes bytes, so every warp-wide store touched n_lanes
// times the sectors it filled, each token was loaded sigma times, and 137,543
// one-shot blocks of 256 threads were launched at 2^25 terms.
//
// Design, for n_lanes = 1-4 (a template; every configuration of the repo's
// n-gram jobs packs into at most 4 lanes):
//  * Tiles with their halo: a block owns T = 1024 consecutive positions at a
//    time and loads the T + sigma - 1 tokens they need into shared memory
//    once, with 16-byte loads where the stream is aligned, PAD past N (the TPU
//    kernel's next-block halo ref, per tile).  sigma <= 32 * n_lanes, so the
//    halo has a fixed bound.
//  * Packing in registers: each thread packs its positions out of shared
//    memory.
//  * Coalesced stores: the [T, cols] output tile is staged in shared memory
//    and written in address order, consecutive threads on consecutive
//    addresses, with 16-byte stores where the output is aligned.
//  * Whole records: with `weight`, each row gains the map weight column (1 for
//    a real token, 0 for PAD), so the map emit writes its [N, n_lanes + 1]
//    records in one pass.  Written as lanes alone into the records' columns,
//    each 32-byte record would get 24 bytes, and such partial-sector stores
//    ran at 0.89 ms against 0.375 ms dense at 2^25 terms on the H100.
//  * Whole bucketed records: with `meta` (a per-position uint32 vector, the
//    time-series bucket id of SSVI-B), each row gains one more column after
//    the weight, read straight from global memory in the same pass, so the
//    map writes [N, n_lanes + 2] records as `repro`'s make_records lays them
//    out (lanes | weight | bucket), and no column is written apart.
//  * The staged tile lives in dynamic shared memory, sized by the record's
//    columns: at NL = 4 with the meta column it is 1024 x 6 x 8 B = 48 KiB
//    plus the tokens, over the 48 KiB a block may hold statically.
//  * Persistent grid: as many blocks as fit on the card walk the tiles in a
//    grid-stride loop.
// More lanes (n_lanes = 0 here, the generic instance) take any sigma: one
// thread per position reads its window through the read-only cache and
// stores its row from registers, so neither the halo nor the staged tile
// bounds sigma.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 1024;  // positions per tile (n_lanes 1-4)

struct Args {
  const int32_t* tokens;
  long long n;
  int sigma, bits, per, n_lanes;
  long long* out;            // [n, n_lanes + weight + (meta != null)], dense
  int weight;                // 1: column n_lanes gets the map weight (token != PAD)
  const int32_t* meta;       // null, or [n] uint32 words for column n_lanes + 1
};

// the int64 value of meta word i: its uint32 bit pattern, as repro's
// astype(uint32) gives it
__device__ __forceinline__ long long meta_at(const Args& a, long long i) {
  return (long long)(uint32_t)__ldg(a.meta + i);
}

// shared-memory bytes of a tile of NL lanes with `cols` columns: the staged
// output rows, then the tokens with their halo
template <int NL>
constexpr size_t tile_bytes(int cols) {
  return (size_t)kTile * cols * sizeof(long long) + (kTile + 32 * NL) * sizeof(int32_t);
}

// the packed window of position r, lane by lane, into row[0 .. nl); tok(j)
// reads token r + j
template <typename Tok>
__device__ __forceinline__ void pack_row(const Args& a, int nl, Tok tok,
                                         long long* row) {
  uint32_t alive = 1u;
  int j = 0;
#pragma unroll
  for (int lane = 0; lane < nl; ++lane) {
    uint32_t acc = 0u;
    for (int slot = 0; slot < a.per && j < a.sigma; ++slot, ++j) {
      const uint32_t t = (uint32_t)tok(j);
      alive &= t != 0u ? 1u : 0u;
      acc += (t * alive) << (a.bits * (a.per - 1 - slot));
    }
    row[lane] = (long long)acc;
  }
}

template <int NL>
__global__ void __launch_bounds__(kThreads) suffix_pack_kernel(Args a) {
  const int cols = a.n_lanes + a.weight + (a.meta != nullptr);
  if constexpr (NL == 0) {
    for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < a.n;
         i += (long long)gridDim.x * kThreads) {
      const auto tok = [&](int j) { return i + j < a.n ? __ldg(a.tokens + i + j) : 0; };
      long long* row = a.out + i * cols;
      pack_row(a, a.n_lanes, tok, row);
      if (a.weight) row[a.n_lanes] = tok(0) != 0 ? 1 : 0;
      if (a.meta) row[a.n_lanes + 1] = meta_at(a, i);
    }
  } else {
    // [kTile * cols] staged rows, then [kTile + 32 * NL] tokens; kTile * cols
    // * 8 is a multiple of 16, so the tokens keep 16-byte alignment
    extern __shared__ __align__(16) unsigned char smem[];
    long long* s_out = (long long*)smem;
    int32_t* s_tok = (int32_t*)(smem + (size_t)kTile * cols * sizeof(long long));
    const long long n_tiles = (a.n + kTile - 1) / kTile;
    const bool vec_in = ((uintptr_t)a.tokens & 15) == 0;
    // kTile * cols is even, so every tile starts as aligned as the output
    const bool vec_out = ((uintptr_t)a.out & 15) == 0;
    for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const long long t0 = tile * kTile;
      const int rows = (int)(a.n - t0 < kTile ? a.n - t0 : kTile);
      // 1. the tile's tokens and halo, PAD past n
      const int n_vec = (rows + a.sigma - 1 + 3) / 4;
      for (int v = threadIdx.x; v < n_vec; v += kThreads) {
        const long long g = t0 + 4 * v;
        int4 x;
        if (vec_in && g + 4 <= a.n) {
          x = __ldg((const int4*)(a.tokens + g));
        } else {
          x.x = g < a.n ? __ldg(a.tokens + g) : 0;
          x.y = g + 1 < a.n ? __ldg(a.tokens + g + 1) : 0;
          x.z = g + 2 < a.n ? __ldg(a.tokens + g + 2) : 0;
          x.w = g + 3 < a.n ? __ldg(a.tokens + g + 3) : 0;
        }
        *(int4*)(s_tok + 4 * v) = x;
      }
      __syncthreads();
      // 2. each position's window, packed into the staged tile
      for (int r = threadIdx.x; r < rows; r += kThreads) {
        pack_row(a, NL, [&](int j) { return s_tok[r + j]; }, s_out + r * cols);
        if (a.weight) s_out[r * cols + NL] = s_tok[r] != 0 ? 1 : 0;
        if (a.meta) s_out[r * cols + NL + 1] = meta_at(a, t0 + r);
      }
      __syncthreads();
      // 3. the tile in address order
      const int cnt = rows * cols;
      long long* dst = a.out + t0 * cols;
      if (vec_out) {
        for (int e = 2 * threadIdx.x; e < cnt; e += 2 * kThreads) {
          if (e + 1 < cnt) {
            *(longlong2*)(dst + e) = *(const longlong2*)(s_out + e);
          } else {
            dst[e] = s_out[e];
          }
        }
      } else {
        for (int e = threadIdx.x; e < cnt; e += kThreads) dst[e] = s_out[e];
      }
      __syncthreads();
    }
  }
}

template <int NL>
int launch(const Args& a, cudaStream_t stream) {
  const long long per_block = NL > 0 ? kTile : kThreads;
  const size_t smem = NL > 0 ? tile_bytes<NL>(a.n_lanes + a.weight + (a.meta != nullptr)) : 0;
  if (NL > 0) {
    // the widest tile (lanes | weight | meta) may exceed the 48 KiB default
    const cudaError_t attr = cudaFuncSetAttribute(
        suffix_pack_kernel<NL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)tile_bytes<NL>(NL + 2));
    if (attr != cudaSuccess) return (int)attr;
  }
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, suffix_pack_kernel<NL>,
                                                kThreads, smem);
  const long long needed = (a.n + per_block - 1) / per_block;
  long long blocks = (long long)sms * (per_sm > 0 ? per_sm : 1);
  if (blocks > needed) blocks = needed;
  suffix_pack_kernel<NL><<<(unsigned int)blocks, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Load every instance now, and grant the tiled ones their widest tile's
// shared memory, so that no first launch waits for either.
extern "C" int suffix_pack_load() {
  cudaFuncAttributes attr;
  int err = (int)cudaFuncGetAttributes(&attr, suffix_pack_kernel<0>);
  if (!err) err = (int)cudaFuncSetAttribute(suffix_pack_kernel<1>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)tile_bytes<1>(3));
  if (!err) err = (int)cudaFuncSetAttribute(suffix_pack_kernel<2>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)tile_bytes<2>(4));
  if (!err) err = (int)cudaFuncSetAttribute(suffix_pack_kernel<3>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)tile_bytes<3>(5));
  if (!err) err = (int)cudaFuncSetAttribute(suffix_pack_kernel<4>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)tile_bytes<4>(6));
  return err;
}

// out: [n, n_lanes + (weight != 0) + (meta != null)] int64, dense; meta
// (null, or [n] uint32 words) needs the weight column
extern "C" int suffix_pack_launch(const void* tokens, long long n, int sigma,
                                  int bits, int per, int n_lanes, void* out,
                                  int weight, const void* meta, void* stream) {
  if (sigma < 1 || per < 1 || n_lanes != (sigma + per - 1) / per ||
      (meta != nullptr && weight == 0))
    return (int)cudaErrorInvalidValue;
  const Args a{(const int32_t*)tokens, n, sigma, bits, per, n_lanes,
               (long long*)out, weight != 0, (const int32_t*)meta};
  cudaStream_t s = (cudaStream_t)stream;
  switch (n_lanes) {
    case 1: return launch<1>(a, s);
    case 2: return launch<2>(a, s);
    case 3: return launch<3>(a, s);
    case 4: return launch<4>(a, s);
    default: return launch<0>(a, s);
  }
}
