// Kernel K10: the lag search of one hash-chain pass of the LZ77 match
// finder: for each position, the longest match against the K positions
// that precede it in its hash bucket, compared byte by byte.
//
// Replaces no Pallas kernel: the reference's lag compare is XLA code
// (deflate_tpu/ops/lz77.py:94 find_matches), which the port first ran
// as K torch passes a hash pass over the co-sorted window words, an
// int32 [W, B, n] tensor (1.07 GB at level 3's 32 words, 256 blocks):
// a `cat`, an xor, `!= 0`, `any`, `argmax` and a `gather` a lag, none of
// which stop at the first differing word.  Plain version:
// deflate_tpu_torch/ops/lz77.py::lag_search_plain.
//
// What it computes, per block b and sorted lane i of its n keys skey
// (sorted ascending; key = (hash << 15) | pos for a position where a
// match may start, (1 << 30) + pos otherwise, so invalid lanes sort
// last and every position appears once): with pos = key & 0x7FFF and
// cap = min(4W, blen[b] - pos, 258), for k = 1..K lag k counts when
// lane i-k exists, both lanes are valid and their hashes are equal; its
// length L is the number of equal leading bytes of the block at pos and
// at pos' = pos of lane i-k, bytes past n reading 0, capped at cap; a
// length-3 match farther than toofar3[b] counts as 0.  The best is the
// strictly longest (the smallest k on ties), dist = pos - pos'.  Both
// are written in position order, at pos; 0 where no lag counts.
//
// What bounds it here: the byte compares.  Its device-memory traffic is
// 13 bytes a position (the block's byte, the key, two int32 outputs:
// 109 MB for 256 blocks of 32 KiB, 33 us at 3.35 TB/s), but a pass asks
// for up to K x n x B (position, candidate) pairs of up to W words each.
// - A CTA owns LANES consecutive sorted lanes of one block.  It stages
//   the block's n bytes and W + 1 zero words after them (the padding of
//   the window words) and the keys of its lanes and the K lanes before
//   them in shared memory: 41 KB at n = 32768, K = 48, W = 32, so five
//   CTAs share an SM.  Every compare then reads shared memory.
// - A thread takes a sorted lane and walks its lags.  An unaligned word
//   is two aligned shared-memory words and a funnel shift; the walk
//   stops at the first differing word and counts its equal low bytes
//   with __ffs.  Neighbouring lanes of a warp mostly share a bucket, so
//   their walks are of similar length.
// - Three exits change no result: at the first predecessor of another
//   hash (keys sort by (hash, pos) and invalid lanes last, so no later
//   lag can count); once the best reaches cap (a later lag must be
//   strictly longer); and, before a compare, when the byte at offset
//   best differs (the lag cannot be longer than the best).
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int LANES = 2048;            // sorted lanes a CTA owns
constexpr int MIN_MATCH = 3;
constexpr int MAX_MATCH = 258;
constexpr int INVALID = 1 << 30;       // keys from here on start no match
constexpr int MAX_N = 32768;           // positions fit the key's 15 bits
constexpr size_t MAX_SMEM = 48 * 1024; // static launch limit, no opt-in

// the little-endian word of the staged bytes q .. q + 3
__device__ __forceinline__ unsigned word_at(const unsigned* s, int q) {
  const int a = q >> 2;
  return __funnelshift_r(s[a], s[a + 1], (q & 3) << 3);
}

__global__ void __launch_bounds__(THREADS)
lag_search(const unsigned* __restrict__ block, const int* __restrict__ skey,
           const int* __restrict__ blen, const int* __restrict__ toofar3,
           int* __restrict__ length, int* __restrict__ dist, int n, int K,
           int W, int chunks) {
  extern __shared__ unsigned smem[];
  const int nw = n >> 2;
  const int sw = nw + W + 1;                     // staged words of bytes
  unsigned* s = smem;
  int* keys = reinterpret_cast<int*>(smem + sw);
  const int b = blockIdx.x / chunks;
  const int c0 = (blockIdx.x - b * chunks) * LANES;
  const int c1 = min(c0 + LANES, n);
  const int k0 = max(c0 - K, 0);                 // first key staged

  const unsigned* src = block + (int64_t)b * nw;
  for (int j = threadIdx.x; j < sw; j += THREADS)
    s[j] = j < nw ? src[j] : 0u;
  const int* key = skey + (int64_t)b * n;
  for (int j = k0 + threadIdx.x; j < c1; j += THREADS) keys[j - k0] = key[j];
  __syncthreads();

  const unsigned char* bytes = reinterpret_cast<const unsigned char*>(s);
  const int bl = blen[b];
  const int far = toofar3[b];
  int* out_l = length + (int64_t)b * n;
  int* out_d = dist + (int64_t)b * n;
  for (int i = c0 + threadIdx.x; i < c1; i += THREADS) {
    const int ki = keys[i - k0];
    const int pos = ki & 0x7FFF;
    int best = 0, bd = 0;
    if (ki < INVALID) {
      const int h = ki >> 15;
      const int cap = min(min(4 * W, bl - pos), MAX_MATCH);
      const int kmax = min(K, i);
      for (int k = 1; k <= kmax; ++k) {
        const int kp = keys[i - k - k0];
        if ((kp >> 15) != h) break;
        const int pp = kp & 0x7FFF;
        if (best && bytes[pos + best] != bytes[pp + best]) continue;
        int L = cap;
        for (int j = 0; 4 * j < cap; ++j) {
          const unsigned x = word_at(s, pos + 4 * j) ^ word_at(s, pp + 4 * j);
          if (x) {
            L = min(4 * j + ((__ffs(x) - 1) >> 3), cap);
            break;
          }
        }
        const int d = pos - pp;
        if (L == MIN_MATCH && d > far) L = 0;
        if (L > best) {
          best = L;
          bd = d;
          if (best >= cap) break;
        }
      }
    }
    out_l[pos] = best;
    out_d[pos] = bd;
  }
}

}  // namespace

// block uint8 [B, n] (4-byte aligned), skey, length, dist int32 [B, n],
// blen, toofar3 int32 [B]; n a multiple of 4 up to 32768, K >= 0,
// W >= 1, the staged bytes and keys within 48 KB (n / 4 + W + 1 +
// min(n, 2048) + K words).  Launches on `stream`; returns
// cudaGetLastError().
extern "C" int dt_lag_search(const void* block, const void* skey,
                             const void* blen, const void* toofar3,
                             void* length, void* dist, int B, int n, int K,
                             int W, void* stream) {
  if (B < 0 || n < 0 || n > MAX_N || (n & 3) || K < 0 || W < 1)
    return (int)cudaErrorInvalidValue;
  if ((uintptr_t)block & 3) return (int)cudaErrorMisalignedAddress;
  if (B == 0 || n == 0) return (int)cudaSuccess;
  const int chunks = (n + LANES - 1) / LANES;
  if ((int64_t)B * chunks > INT_MAX) return (int)cudaErrorInvalidValue;
  const size_t smem = ((size_t)(n / 4) + W + 1 + min(n, LANES) + K) * 4;
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  lag_search<<<(unsigned)(B * chunks), THREADS, smem,
               (cudaStream_t)stream>>>(
      (const unsigned*)block, (const int*)skey, (const int*)blen,
      (const int*)toofar3, (int*)length, (int*)dist, n, K, W, chunks);
  return (int)cudaGetLastError();
}
