// Kernel K9: the tile-local greedy parse of LZ77 match lengths, with
// one-step lazy deferral at token starts.
//
// Replaces the lax.scan of deflate_tpu/ops/lz77.py:292 greedy_parse (XLA
// code, no Pallas kernel), which the port first ran as a Python loop of
// `tile` steps of ~23 small torch kernels each.  Plain version:
// deflate_tpu_torch/ops/lz77.py::greedy_parse_plain; torch form of this
// design: lz77.py::greedy_parse_walk.
//
// What it computes, per block b and tile [base, base + tile) of its n
// positions: a walker starts at the tile's first position and, while
// pos < min(base + tile, blen[b]), takes ml = min(length[pos],
// base + tile - pos, blen[b] - pos); the position is a token start
// (mark = 1), a match of ml bytes when ml >= 3 and, with lazy, the next
// position's length under the same caps less one is not longer than ml
// (len_adj = ml, next start pos + ml), else a literal (len_adj = 0, next
// start pos + 1).  Every other position has mark 0 and len_adj 0.  The
// caps keep each tile's parse inside it, so tiles are independent.
//
// What bounds it here: 4 bytes read and 5 written a position (75.5 MB
// for 256 blocks of 32 KiB, 22.5 us at 3.35 TB/s), and the walk, which
// is serial inside a tile.  The next token start depends only on the
// current one, so a walker jumps from start to start and skips match
// bodies: its chain is one token a step, two shared-memory loads and a
// few integer operations long, at most `tile` steps (all literals).
// - A CTA owns up to 32 consecutive tiles of the flattened [B * n]
//   rows (16384 positions at most, ~32 KB of shared memory).  Its 256
//   threads stage their lengths with coalesced 16-byte loads, clamped to
//   [0, tile] as 16-bit halfwords: the clamp changes no decision (a
//   negative length is no match, one past the tile is capped by it).
//   A tile's row takes tile + 2 halfwords, an odd number of words, so
//   the walkers, who start in step, read different banks.
// - One thread a tile walks (lanes of warp 0).  At each token start it
//   overwrites the staged length with 0x8000 | len_adj; a match body is
//   never read again, and the lazy read of pos + 1 comes before any
//   write there.
// - All threads then turn the halfwords into len_adj (16-byte stores)
//   and mark (4-byte stores), both coalesced: a flagged halfword is a
//   token start, any other position is written as zeros.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MIN_MATCH = 3;
constexpr int CTA_POS = 16384;         // positions a CTA stages at most
constexpr int CTA_TILES = 32;          // tiles a CTA owns at most
constexpr unsigned FLAG = 0x8000u;     // token start, in a halfword

__device__ __forceinline__ unsigned staged(int x, int tile) {
  return (unsigned)min(max(x, 0), tile);
}

__device__ __forceinline__ int used(unsigned h) {
  return (h & FLAG) ? (int)(h & (FLAG - 1u)) : 0;
}

template <bool LAZY>
__global__ void __launch_bounds__(THREADS)
parse_tiles(const int* __restrict__ length, const int* __restrict__ blen,
            unsigned char* __restrict__ mark, int* __restrict__ len_adj,
            int ntiles, int nt, int tile, int per_cta) {
  extern __shared__ unsigned buf[];
  const int S = tile + 2;                        // halfwords a tile's row
  const int g0 = blockIdx.x * per_cta;
  const int ng = min(per_cta, ntiles - g0);
  const int qt = tile >> 2;                      // quads of positions a tile
  const int nq = ng * qt;
  const int64_t p0 = (int64_t)g0 * tile;

  const int4* src = reinterpret_cast<const int4*>(length + p0);
  for (int q = threadIdx.x; q < nq; q += THREADS) {
    const int4 x = src[q];
    const int k = q / qt;
    unsigned* w = buf + ((k * S + ((q - k * qt) << 2)) >> 1);
    w[0] = staged(x.x, tile) | (staged(x.y, tile) << 16);
    w[1] = staged(x.z, tile) | (staged(x.w, tile) << 16);
  }
  __syncthreads();

  if (threadIdx.x < ng) {
    const int k = threadIdx.x, g = g0 + k;
    const int b = g / nt;
    const long long room = (long long)blen[b] - (long long)(g - b * nt) * tile;
    const int e = room < tile ? (int)max(room, 0LL) : tile;
    unsigned short* L = reinterpret_cast<unsigned short*>(buf) + k * S;
    for (int t = 0; t < e;) {
      const int cap = e - t;
      const int ml = min((int)L[t], cap);
      bool use = ml >= MIN_MATCH;
      if (LAZY && use) use = min((int)L[t + 1], cap - 1) <= ml;
      L[t] = (unsigned short)(FLAG | (use ? ml : 0));
      t += use ? ml : 1;
    }
  }
  __syncthreads();

  int4* dl = reinterpret_cast<int4*>(len_adj + p0);
  unsigned* dm = reinterpret_cast<unsigned*>(mark + p0);
  for (int q = threadIdx.x; q < nq; q += THREADS) {
    const int k = q / qt;
    const unsigned* w = buf + ((k * S + ((q - k * qt) << 2)) >> 1);
    const unsigned a = w[0], c = w[1];
    dl[q] = make_int4(used(a & 0xFFFFu), used(a >> 16), used(c & 0xFFFFu),
                      used(c >> 16));
    dm[q] = ((a >> 15) & 1u) | (((a >> 31) & 1u) << 8) |
            (((c >> 15) & 1u) << 16) | (((c >> 31) & 1u) << 24);
  }
}

}  // namespace

// length, len_adj int32 [B, n] (16-byte aligned), mark uint8 [B, n]
// (4-byte aligned), blen int32 [B]; tile a multiple of 4 in [4, 16384]
// dividing n.  Launches on `stream`; returns cudaGetLastError().
extern "C" int dt_greedy_parse(const void* length, const void* blen,
                               void* mark, void* len_adj, int B, int n,
                               int tile, int lazy, void* stream) {
  if (B < 0 || n < 0 || tile < 4 || tile > CTA_POS || (tile & 3) ||
      n % tile)
    return (int)cudaErrorInvalidValue;
  if ((((uintptr_t)length | (uintptr_t)len_adj) & 15) || ((uintptr_t)mark & 3))
    return (int)cudaErrorMisalignedAddress;
  const int64_t ntiles = (int64_t)B * (n / tile);
  if (ntiles > INT_MAX) return (int)cudaErrorInvalidValue;
  if (ntiles == 0) return (int)cudaSuccess;
  const int per_cta = min(CTA_TILES, CTA_POS / tile);
  const unsigned grid = (unsigned)((ntiles + per_cta - 1) / per_cta);
  const size_t smem = (size_t)per_cta * (tile + 2) * sizeof(unsigned short);
  const cudaStream_t s = (cudaStream_t)stream;
  if (lazy)
    parse_tiles<true><<<grid, THREADS, smem, s>>>(
        (const int*)length, (const int*)blen, (unsigned char*)mark,
        (int*)len_adj, (int)ntiles, n / tile, tile, per_cta);
  else
    parse_tiles<false><<<grid, THREADS, smem, s>>>(
        (const int*)length, (const int*)blen, (unsigned char*)mark,
        (int*)len_adj, (int)ntiles, n / tile, tile, per_cta);
  return (int)cudaGetLastError();
}
