// lcp_boundary: the SUFFIX-sigma reducer's inner loop, hand-written for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/lcp_boundary.py::lcp_boundary.
// For a lexicographically sorted int32 term matrix [N, L] it writes, per row,
// lcp[i] = the length of the common prefix with row i-1 (row 0 gets 0, as
// repro's reference gives it) and flags[i, l-1] = (lcp[i] < l) && terms[i, l-1] != 0.
//
// What bounds it on the H100: bytes.  4 * L bytes in, 4 + L bytes out per row,
// N * (5 * L + 4) / 3.35e12 s; a few integer operations a term are far below
// the scalar peak.
//
// The first port ran one thread per row straight from global memory and
// stored its L flags one byte at a time, at a stride of L bytes.  At L = 40 a
// warp's 32 rows span 5,120 bytes of terms: each of its 40 loads touched 32
// sectors, and each of its 40 byte stores wrote parts of 32 sectors, about
// 1,280 partial sector writes for the 1,280 flag bytes that fill 40.  It ran
// at 7.68x its bound there (16.4731 ms against 2.1442 ms at [35,211,018, 40];
// at L = 5 the same warp spans 640 and 160 bytes: 1.14x).
//
// Design (the tiled instance, L = ops.LCP_MIN_TILED_LENGTH (6) to
// ops.LCP_MAX_TILED_LENGTH (3,072)):
//  * A block owns a tile of T consecutive rows, T chosen by the wrapper from
//    L (a multiple of 16, about 32 KiB of terms).  The tile's T * L terms and
//    the previous row's L (the halo; the first tile has none) are one
//    contiguous range, copied into shared memory by every thread's 16-byte
//    cp.async at the same offset mod 16 bytes as in global memory, so a
//    storage offset that breaks 16-byte alignment costs a scalar head and
//    tail of at most 3 words, never a refusal.  (One cp.async.bulk a tile,
//    completing on an mbarrier, ran 1-15 % slower at L = 6-40.)
//  * Term by term, 32 to a warp: consecutive lanes compare consecutive
//    terms with the term L before them (no bank is read twice at any L), and
//    two ballots store a (mismatch, nonzero) bit word pair for each 32 terms.
//  * A row a thread: its lcp is the distance from its first term to the
//    first mismatch bit at or after it (__ffs over at most ceil(L / 32) + 1
//    words).  The tile's lcp values go out as T coalesced int32 stores.
//  * Flags, 16 terms a thread: the bits at columns >= their row's lcp, AND
//    the nonzero bits, widened to 16 bytes and stored as one 16-byte store,
//    so a warp writes 512 contiguous bytes and every sector once.
//  * Offsets into the matrix are 64-bit (2^25 terms at sigma 100 is past
//    2^31 terms); offsets inside a tile are int.
// A first tiled version, which took each row's lcp by a shared atomicMin per
// row piece of each 32-term chunk and stepped (row, column) term by term in
// both passes, ran 3.1-3.3 ms at L = 40 and 0.43-0.47 ms at L = 5: the bit
// words leave one pass term by term and the rest a row or 16 terms a thread.
// Measured, NVIDIA H100 80GB HBM3, 700 W (PERF.md): 0.9539 ms at
// [35,211,018, 16] (bound 0.8829), 2.2864 at L = 40 (2.1442).
// Rows of 1-5 terms, longer rows and L = 0 take the generic instance, the
// first port's kernel: one thread a row.  At L <= 5 a warp's rows span at
// most 640 bytes of terms and 160 of flags, few enough sectors that it runs
// at 1.08-1.12x its bound (0.3280-0.3412 ms at [35,211,018, 5]), where the
// tile ran 0.3658 with cp.async and 0.3323-0.3330 with one bulk copy.
// ptxas (CUDA 12.8): 25 registers (tiled), no spills; see PERF.md.
#include <cstdint>
#include <cuda_runtime.h>

#include "async_copy.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

struct Args {
  const int32_t* terms;                // [n, length], 4-byte aligned
  long long n;
  int length, tile_rows;
  int32_t* lcp;                        // [n]
  uint8_t* flags;                      // [n, length], 16-byte aligned
};

// words of a tile's (mismatch, nonzero) bit pairs, a pair for each 32 terms,
// rounded up to 16 bytes
__host__ __device__ __forceinline__ int bit_words(int rows, int length) {
  return (2 * ((rows * length + 31) / 32) + 3) / 4 * 4;
}

// shared-memory bytes of a tile: the rows' lcp, the bit pairs, the halo row
// (rounded up to 16 bytes), 3 words of alignment slack, the tile's terms,
// and 32 words that the last chunk of 32 reads past them
size_t tile_bytes(int rows, int length) {
  return ((size_t)rows + bit_words(rows, length) + (length + 3) / 4 * 4 + 3 +
          (size_t)rows * length + 32) * sizeof(int32_t);
}

// (row, column) of a tile term, moved on by a step of dr rows and dc < L terms
__device__ __forceinline__ void advance(int& r, int& c, int dr, int dc, int length) {
  r += dr;
  c += dc;
  if (c >= length) {
    c -= length;
    ++r;
  }
}

// kTiled: a tile of rows a block (tile_rows > 0); else one thread a row
template <bool kTiled>
__global__ void __launch_bounds__(kThreads) lcp_boundary_kernel(Args a) {
  const int L = a.length;
  if constexpr (!kTiled) {
    const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
    if (i >= a.n) return;
    const int32_t* cur = a.terms + i * L;
    int l = 0;
    if (i > 0) {
      const int32_t* prev = cur - L;
      while (l < L && __ldg(cur + l) == __ldg(prev + l)) ++l;
    }
    a.lcp[i] = l;
    uint8_t* f = a.flags + i * L;
    for (int j = 0; j < L; ++j) f[j] = (l < j + 1) && (__ldg(cur + j) != 0);
  } else {
    extern __shared__ __align__(16) int32_t smem[];
    const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
    const int T = a.tile_rows;
    const long long row0 = (long long)blockIdx.x * T;
    const int rows = (int)(a.n - row0 < T ? a.n - row0 : T);
    const int cnt = rows * L;                             // the tile's terms
    const long long e0 = row0 * L;                        // its first, in the matrix
    // [T] lcp | [chunks] (mismatch, nonzero) word pairs | halo row | tile.
    // s_cur[e] is tile term e, s_cur[-L .. -1] the halo row; term w of the
    // matrix lands at the same offset mod 16 bytes as in global memory.
    int32_t* s_lcp = smem;
    unsigned* s_bits = (unsigned*)smem + T;
    int32_t* s_cur = smem + T + bit_words(T, L) + (L + 3) / 4 * 4 +
                     (int)(((uintptr_t)a.terms / sizeof(int32_t) + e0) & 3);

    // 1. the halo and the tile into shared memory: an aligned middle of
    // 16-byte chunks, a scalar head and tail of at most 3 words
    const long long g0 = row0 > 0 ? e0 - L : e0, g1 = e0 + cnt;
    long long a0 = g0 + ((4 - (int)(((uintptr_t)(a.terms + g0) >> 2) & 3)) & 3);
    if (a0 > g1) a0 = g1;
    const long long a1 = a0 + ((g1 - a0) & ~3ll);
    if (t < 3 && g0 + t < a0) s_cur[g0 + t - e0] = __ldg(a.terms + g0 + t);
    if (t >= 4 && t < 7 && a1 + (t - 4) < g1)
      s_cur[a1 + (t - 4) - e0] = __ldg(a.terms + a1 + (t - 4));
    const int n16 = (int)((a1 - a0) >> 2);               // 16-byte chunks
    int32_t* s_mid = s_cur + (a0 - e0);
    const int32_t* g_mid = a.terms + a0;
    for (int v = t; v < n16; v += kThreads) cp_async16(s_mid + 4 * v, g_mid + 4 * v);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    // 2. a term at a time, 32 to a warp: term e differs from term e - L (the
    // row before's, the halo's for the tile's first row) and is not PAD, as
    // two bit words a chunk of 32.  Past cnt the bits are never read.
    const int chunks = (cnt + 31) >> 5;
#pragma unroll 4
    for (int k = warp; k < chunks; k += kWarps) {
      const int e = 32 * k + lane;
      const int32_t cur = s_cur[e];
      const unsigned diff = __ballot_sync(0xffffffffu, cur != s_cur[e - L]);
      const unsigned nonzero = __ballot_sync(0xffffffffu, cur != 0);
      if (lane < 2) s_bits[2 * k + lane] = lane ? nonzero : diff;
    }
    __syncthreads();

    // 3. a row a thread: its lcp is the distance to its first mismatch bit
    // (row 0 of the matrix gets 0)
    for (int r = t; r < rows; r += kThreads) {
      int lcp = 0;
      if (row0 + r > 0) {
        const int first = r * L, end = first + L;
        int w = first >> 5, at = first;                  // `bits` bit 0 is term `at`
        unsigned bits = s_bits[2 * w] >> (first & 31);
        while (bits == 0u && (w + 1) * 32 < end) {
          ++w;
          at = 32 * w;
          bits = s_bits[2 * w];
        }
        lcp = bits ? at + __ffs(bits) - 1 - first : L;
        if (lcp > L) lcp = L;
      }
      s_lcp[r] = lcp;
      a.lcp[row0 + r] = lcp;
    }
    __syncthreads();

    // 4. the flags, 16 terms a thread: flag bits at columns >= their row's
    // lcp, AND the nonzero bits, widened to bytes and stored as 16 bytes, so
    // a warp writes 512 contiguous bytes.  (row, column) of the first term
    // steps on by 16 * kThreads terms a round.
    uint8_t* f = a.flags + e0;
    const int halves = (cnt + 15) >> 4;
    int r = 16 * t / L, c = 16 * t - r * L;
    const int dr = 16 * kThreads / L, dc = 16 * kThreads % L;
    for (int h = t; h < halves; h += kThreads) {
      const int e = 16 * h;
      const int count = cnt - e < 16 ? cnt - e : 16;
      unsigned bits = 0u;
      for (int pos = 0, rr = r, cc = c; pos < count; pos += L - cc, ++rr, cc = 0) {
        const int len = count - pos < L - cc ? count - pos : L - cc;   // row rr's terms here
        const int from = s_lcp[rr] > cc ? s_lcp[rr] - cc : 0;
        if (from < len) bits |= (1u << (pos + len)) - (1u << (pos + from));
      }
      bits &= s_bits[2 * (e >> 5) + 1] >> (e & 16);
      uint4 out;                                   // bit k -> byte k (0 or 1)
      out.x = ((bits & 15u) * 0x204081u) & 0x01010101u;
      out.y = ((bits >> 4 & 15u) * 0x204081u) & 0x01010101u;
      out.z = ((bits >> 8 & 15u) * 0x204081u) & 0x01010101u;
      out.w = ((bits >> 12 & 15u) * 0x204081u) & 0x01010101u;
      if (count == 16) {
        *(uint4*)(f + e) = out;
      } else {
        for (int k = 0; k < count; ++k) f[e + k] = (uint8_t)(bits >> k & 1u);
      }
      advance(r, c, dr, dc, L);
    }
  }
}

// the tiled instance may use more than the 48 KB of shared memory a kernel
// gets by default: grant it the card's opt-in limit, once on each device
int granted[64];

// the dynamic shared memory the tiled instance may use on this device
int prepare(int* limit) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 64 && granted[dev] > 0) {
    *limit = granted[dev];
    return 0;
  }
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(lcp_boundary_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (err != cudaSuccess) return (int)err;
  *limit = optin;
  if (dev < 64) granted[dev] = optin;
  return 0;
}

}  // namespace

// Load both instances now and grant the tiled one its shared memory, so that
// neither waits inside a first launch.
extern "C" int lcp_boundary_load() {
  int limit = 0;
  int err = prepare(&limit);
  cudaFuncAttributes attr;
  if (!err) err = (int)cudaFuncGetAttributes(&attr, lcp_boundary_kernel<false>);
  return err;
}

// tile_rows: rows a block stages (a multiple of 16), or 0 for one thread a
// row; terms 4-byte aligned, flags 16-byte aligned
extern "C" int lcp_boundary_launch(const void* terms, long long n, int length,
                                   int tile_rows, void* lcp, void* flags, void* stream) {
  if (n < 0 || length < 0 || tile_rows < 0 || tile_rows % 16 != 0 ||
      ((uintptr_t)terms & 3) != 0 || ((uintptr_t)flags & 15) != 0 ||
      (tile_rows > 0 && length == 0))
    return (int)cudaErrorInvalidValue;
  const Args a{(const int32_t*)terms, n, length, tile_rows, (int32_t*)lcp,
               (uint8_t*)flags};
  cudaStream_t s = (cudaStream_t)stream;
  if (n == 0) return 0;
  const long long rows = tile_rows > 0 ? tile_rows : kThreads;   // a block's
  const long long blocks = (n + rows - 1) / rows;
  if (blocks > 0x7fffffffll) return (int)cudaErrorInvalidValue;
  if (tile_rows == 0) {
    lcp_boundary_kernel<false><<<(unsigned int)blocks, kThreads, 0, s>>>(a);
    return (int)cudaGetLastError();
  }
  int limit = 0;
  const int err = prepare(&limit);
  if (err) return err;
  const size_t smem = tile_bytes(tile_rows, length);
  if (smem > (size_t)limit) return (int)cudaErrorInvalidValue;
  lcp_boundary_kernel<true><<<(unsigned int)blocks, kThreads, smem, s>>>(a);
  return (int)cudaGetLastError();
}
