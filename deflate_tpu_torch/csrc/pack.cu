// Kernel K7: place variable-width packets at their bit offsets in each
// block's 32-bit words.
//
// Replaces deflate_tpu/ops/pallas_pack.py::_kernel (wrapper pack_blocks).
// Plain version: deflate_tpu_torch/ops/pack.py::pack_blocks_plain; torch
// form of this design: pack.py::pack_blocks_tiles.
//
// What it computes, per block b: for each of its counts[b] packets, the
// payload (lo = bits 0..31, hi = bits 32..63) shifted to bit off & 31 of
// word off >> 5 spans three words, and the block's outw words are the OR
// of all of them (words at or past outw are dropped).  Packets never
// share a bit, so the order of the ORs does not matter.
//
// Narrower contract than the plain version: over [0, counts[b]) the
// offsets are >= 0 and do not decrease (an exclusive sum of widths, as
// models/encoder._packet_post builds them and the JAX contract states).
// Lanes past counts[b] are never used.
//
// What bounds it here: bytes — 12 per live packet in and each row's
// words out — with ~15 integer operations a packet; and, since a tile
// is small, the chain of dependent loads it waits on.  The TPU kernel
// walked each block's packets one at a time on its scalar core, four
// blocks interleaved; none of that carries over.  Here a CTA owns a
// tile of TILE output words of one row, so a block with many packets no
// longer sets the launch's length, and tiles are launched tile index
// first (every row's tile 0, then tile 1, ...), so the live tiles start
// first and the cheap dead ones fill the tail:
// - A tile that starts past the row's last live word,
//   (off[count - 1] >> 5) + 2, is written as zeros with 16-byte stores;
//   it reads only the count and that offset, and touches no shared
//   memory.  About two thirds of phase D's output words are such zeros.
// - A live tile [W0, W1) needs the packets [p0, p1): p0 the lower bound
//   of 32 (W0 - 2) in the offsets (a packet that starts before word
//   W0 - 2 ends before W0), p1 that of 32 W1.  Both come from a 256-ary
//   search: every thread loads one of 256 evenly spaced offsets, a
//   __syncthreads_count brackets the bound to one gap, and a second
//   round counts inside the gap; two rounds of parallel loads instead
//   of 16 dependent ones.
// - A thread takes PER = 4 consecutive packets (one int4 load of each
//   of off, lo and hi, coalesced across the warp), skips zero payloads
//   (the header's piles of zero-width lanes at one offset), and merges
//   words the packets share in a three-word register window; a word
//   leaves the window, if nonzero and inside the tile, as one shared
//   atomicOr: about one atomic a distinct word, not three a packet.
// - The tile (4 KiB of shared memory) goes out with 16-byte stores.
// - Occupancy hides the chain: PER = 4 keeps a thread at 32 registers
//   and eight 256-thread CTAs on an SM (PER = 8 took 46 registers, five
//   CTAs).  Staging the packets into shared memory with cp.async and
//   dropping the second search round, to cut two loads from the chain,
//   measured 19% slower on the H100 (PERF.md, Findings).
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int TILE = 1024;       // output words a CTA owns
constexpr int THREADS = 256;
constexpr int PER = 4;           // consecutive packets a thread merges

__device__ __forceinline__ void flush(unsigned* buf, int w, unsigned v,
                                      int w0, int w1) {
  if (v && w >= w0 && w < w1) atomicOr(&buf[w - w0], v);
}

__global__ void __launch_bounds__(THREADS, 8)
pack_tiles(const int* __restrict__ counts, const int* __restrict__ off,
           const int* __restrict__ lo, const int* __restrict__ hi,
           int* __restrict__ out, int B, int npk, int outw) {
  __shared__ uint4 buf4[TILE / 4];
  unsigned* buf = reinterpret_cast<unsigned*>(buf4);
  const int tid = threadIdx.x;
  const int t = blockIdx.x / B, b = blockIdx.x - t * B;
  const int W0 = t * TILE, W1 = min(W0 + TILE, outw);
  const int nv = (W1 - W0) >> 2;                 // int4 of this tile
  const int64_t row = (int64_t)b * npk;
  const int* offb = off + row;
  int4* dst = reinterpret_cast<int4*>(out + (int64_t)b * outw + W0);

  int n = counts[b];
  n = n < 0 ? 0 : (n > npk ? npk : n);
  if (n == 0 || W0 > (offb[n - 1] >> 5) + 2) {   // dead tile
    for (int i = tid; i < nv; i += THREADS) dst[i] = make_int4(0, 0, 0, 0);
    return;
  }
  for (int i = tid; i < nv; i += THREADS) buf4[i] = make_uint4(0, 0, 0, 0);

  // lower bounds of t0 and t1 over offb[0, n): round 1 brackets each to
  // a gap between samples s apart, round 2 counts inside the gap
  const int t0 = 32 * (W0 - 2), t1 = 32 * W1;
  const int s = (n + THREADS - 1) / THREADS;
  const int k = tid * s;
  const int v = k < n ? offb[k] : INT_MAX;
  const int c0 = __syncthreads_count(v < t0);
  const int c1 = __syncthreads_count(v < t1);
  int p0 = c0 ? (c0 - 1) * s + 1 : 0, e0 = c0 ? min(c0 * s, n) : 0;
  int p1 = c1 ? (c1 - 1) * s + 1 : 0, e1 = c1 ? min(c1 * s, n) : 0;
  for (int g0 = p0, g1 = p1; g0 < e0 || g1 < e1;
       g0 += THREADS, g1 += THREADS) {
    const int j0 = g0 + tid, j1 = g1 + tid;
    p0 += __syncthreads_count(j0 < e0 && offb[j0] < t0);
    p1 += __syncthreads_count(j1 < e1 && offb[j1] < t1);
  }

  const int* lob = lo + row;
  const int* hib = hi + row;
  for (int g = (p0 & ~3) + tid * PER; g < p1; g += THREADS * PER) {
    int o[PER];
    unsigned l[PER], h[PER];
#pragma unroll
    for (int q = 0; q < PER; q += 4) {
      int4 x = make_int4(0, 0, 0, 0), y = x, z = x;
      if (g + q < p1) {       // g + q + 3 < npk: npk is a multiple of 4
        x = *reinterpret_cast<const int4*>(offb + g + q);
        y = *reinterpret_cast<const int4*>(lob + g + q);
        z = *reinterpret_cast<const int4*>(hib + g + q);
      }
      o[q] = x.x; o[q + 1] = x.y; o[q + 2] = x.z; o[q + 3] = x.w;
      l[q] = y.x; l[q + 1] = y.y; l[q + 2] = y.z; l[q + 3] = y.w;
      h[q] = z.x; h[q + 1] = z.y; h[q + 2] = z.z; h[q + 3] = z.w;
    }
    int cur = -1;                        // word of a0; a1, a2 follow it
    unsigned a0 = 0u, a1 = 0u, a2 = 0u;
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      const int j = g + q;
      if (j < p0 || j >= p1 || (l[q] | h[q]) == 0u) continue;
      const int w = o[q] >> 5;
      const unsigned r = (unsigned)o[q] & 31u;
      if (cur >= 0) {
        const int d = w - cur;
        if (d == 1) {
          flush(buf, cur, a0, W0, W1);
          a0 = a1; a1 = a2; a2 = 0u;
        } else if (d == 2) {
          flush(buf, cur, a0, W0, W1);
          flush(buf, cur + 1, a1, W0, W1);
          a0 = a2; a1 = 0u; a2 = 0u;
        } else if (d > 2) {
          flush(buf, cur, a0, W0, W1);
          flush(buf, cur + 1, a1, W0, W1);
          flush(buf, cur + 2, a2, W0, W1);
          a0 = 0u; a1 = 0u; a2 = 0u;
        }
      }
      cur = w;
      a0 |= l[q] << r;
      a1 |= r ? ((l[q] >> (32u - r)) | (h[q] << r)) : h[q];
      a2 |= r ? (h[q] >> (32u - r)) : 0u;
    }
    if (cur >= 0) {
      flush(buf, cur, a0, W0, W1);
      flush(buf, cur + 1, a1, W0, W1);
      flush(buf, cur + 2, a2, W0, W1);
    }
  }
  __syncthreads();
  for (int i = tid; i < nv; i += THREADS) {
    const uint4 x = buf4[i];
    dst[i] = make_int4((int)x.x, (int)x.y, (int)x.z, (int)x.w);
  }
}

}  // namespace

extern "C" int dt_pack_blocks(const void* counts, const void* off,
                              const void* lo, const void* hi, void* out,
                              int B, int npk, int outw, void* stream) {
  if (B < 0 || npk < 0 || outw < 0 || outw > INT_MAX / 32 - TILE ||
      (npk & 3) || (outw & 3))
    return (int)cudaErrorInvalidValue;
  if (((uintptr_t)off | (uintptr_t)lo | (uintptr_t)hi | (uintptr_t)out) & 15)
    return (int)cudaErrorMisalignedAddress;
  const int64_t grid = (int64_t)B * ((outw + TILE - 1) / TILE);
  if (grid > INT_MAX) return (int)cudaErrorInvalidValue;
  if (grid == 0) return (int)cudaSuccess;
  pack_tiles<<<(unsigned)grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)counts, (const int*)off, (const int*)lo, (const int*)hi,
      (int*)out, B, npk, outw);
  return (int)cudaGetLastError();
}
