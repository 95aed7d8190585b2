// Kernels K11 and K12: the wavefront decode's stage E literal-value
// select and stage F's run merge with its compaction, each one launch.
//
// Replace no Pallas kernel: the reference runs both as XLA array code
// (deflate_tpu/ops/wave.py resolve_litval, merge_match_runs), which the
// port ran as torch launch chains: ~120 `where`s, 8 popcount rounds and
// select_bit32's 5 rounds for the select, 8 halving rounds of clones and
// masked writes, a prefix sum and a K3 route for the merge, ~300 tiny
// launches a wave_decode call.  Plain versions:
// deflate_tpu_torch/ops/wave.py::resolve_litval_plain and
// merge_match_runs_plain; each kernel equals its plain version on every
// input, not only on the records a valid stream gives.
//
// K11, dt_resolve_litval: per block b and lane i, with l = len[b, i] and
// j = r_rel[b, i], the literal membership words of code length l (all
// zero unless 1 <= l <= 15) are litmask[b, l, 0..7]; the lane picks the
// first word q whose running popcount passes j (q = 0 for j < 0) and
// writes 32 q + the index of bit j - (popcounts before q) of that word,
// by select_bit32's branchless descent; where no word is picked, word 0
// and rank 0 give 31.  Bound: 12 bytes a lane (two int32 reads, one
// write: 26 MB for a group of 64 blocks of 33,792 lanes, 8 us at 3.35
// TB/s); a CTA stages its block's 128 mask words in shared memory, so
// each thread reads its two words and writes one.
//
// K12, dt_merge_runs: records rec0 = opos | len3 << 16 and rec1 = dist,
// N a multiple of 256 a block.  Eight halving rounds w = 1, 2, .., 128
// pair the heads of aligned groups at a and a + w (a a multiple of 2w):
// with span = 1 at a record with rec0 >= 0, 0 elsewhere, the right head
// joins the left when span[a] == w, span[a + w] > 0, both dists are
// equal and positive and the right run starts where the left ends
// (opos + len3 + 3); the left head's len3 becomes the sum + 3 and the
// right head is emptied (rec0 -1, dist 0, span 0).  Then the records
// with rec0 >= 0 are compacted left in order, the rest of the row filled
// with -1 and 0, and their count written to nmatch[b].  Bound: 16 bytes
// a record (two int32 reads, two writes: 11.5 MB for 64 blocks of
// 11,264 records, 3.4 us at 3.35 TB/s).  The rounds only pair records
// inside aligned tiles of 256, so a CTA owns a block and walks it in
// chunks of four tiles: the rounds run in shared memory, a ballot and a
// warp scan rank the live records, and a running offset carries the
// compaction across chunks, so rounds, compaction and fill are one
// launch.  The next chunk's records are loaded while a chunk is merged.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int LIT_THREADS = 256;       // lanes a K11 CTA owns
constexpr int LENGTHS = 16;            // code lengths 0..15 of a mask
constexpr int MASK_WORDS = 8;          // 256 membership bits a length
constexpr int MERGE_THREADS = 1024;    // records a K12 chunk holds
constexpr int RUN_TILE = 256;          // the rounds' widest group
constexpr int ROUNDS = 8;              // w = 1 .. RUN_TILE / 2

// select_bit32 of ops/wave.py on int32, arithmetic shifts included: the
// index of the j-th set bit of m, in-range garbage past its popcount
__device__ __forceinline__ int select_bit32(int m, int j) {
  int idx = 0;
#pragma unroll
  for (int h = 16; h >= 1; h >>= 1) {
    const int low = m & ((1 << h) - 1);
    const int c = __popc(low);
    const int go = j >= c;
    j -= go * c;
    m = go ? (m >> h) : low;
    idx += go * h;
  }
  return idx;
}

__global__ void __launch_bounds__(LIT_THREADS)
resolve_litval(const int* __restrict__ len, const int* __restrict__ r_rel,
               const int* __restrict__ litmask, int* __restrict__ out,
               int n, int chunks) {
  __shared__ int mask[LENGTHS * MASK_WORDS];
  const int b = blockIdx.x / chunks;
  const int i = (blockIdx.x - b * chunks) * LIT_THREADS + threadIdx.x;
  if (threadIdx.x < LENGTHS * MASK_WORDS)
    mask[threadIdx.x] =
        litmask[(int64_t)b * LENGTHS * MASK_WORDS + threadIdx.x];
  __syncthreads();
  if (i >= n) return;
  const int64_t k = (int64_t)b * n + i;
  const int l = len[k];
  const int j = r_rel[k];
  const bool hit = l >= 1 && l < LENGTHS;
  const int* mw = mask + (hit ? l : 0) * MASK_WORDS;
  int acc = 0, word = 0, jrel = 0, wq = 0;
  bool found = false;
#pragma unroll
  for (int q = 0; q < MASK_WORDS; ++q) {
    const int w = hit ? mw[q] : 0;
    const int pc = __popc(w);
    const bool sel = !found && j < acc + pc;
    if (sel) {
      word = w;
      jrel = j - acc;
      wq = q;
    }
    found = found || sel;
    acc += pc;
  }
  out[k] = (wq << 5) + select_bit32(word, jrel);
}

__global__ void __launch_bounds__(MERGE_THREADS)
merge_runs(const int* __restrict__ rec0, const int* __restrict__ rec1,
           int* __restrict__ out0, int* __restrict__ out1,
           int* __restrict__ nmatch, int n) {
  __shared__ int L[MERGE_THREADS], Dd[MERGE_THREADS], S[MERGE_THREADS];
  __shared__ int warp_live[MERGE_THREADS / 32];
  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const int64_t row = (int64_t)blockIdx.x * n;
  // records past n (the last chunk may hold fewer than four tiles) are
  // empty; no group of a round reaches them, since n is a multiple of
  // RUN_TILE
  int l0 = t < n ? rec0[row + t] : -1;
  int d0 = t < n ? rec1[row + t] : 0;
  int offset = 0;
  for (int base = 0; base < n; base += MERGE_THREADS) {
    L[t] = l0;
    Dd[t] = d0;
    S[t] = l0 >= 0;
    const int nx = base + MERGE_THREADS + t;
    l0 = nx < n ? rec0[row + nx] : -1;
    d0 = nx < n ? rec1[row + nx] : 0;
    __syncthreads();
    for (int lvl = 0; lvl < ROUNDS; ++lvl) {
      const int w = 1 << lvl;
      if (t < (MERGE_THREADS >> (lvl + 1))) {
        const int a = t << (lvl + 1), c = a + w;
        const unsigned lef = L[a], rig = L[c];
        const int dl = Dd[a];
        const bool can = S[a] == w && S[c] > 0 && dl == Dd[c] && dl > 0 &&
                         (rig & 0xFFFFu) == (lef & 0xFFFFu) + (lef >> 16) + 3;
        if (can) {
          const unsigned mlen3 = (lef >> 16) + (rig >> 16) + 3;
          L[a] = (int)((lef & 0xFFFFu) | (mlen3 << 16));
          L[c] = -1;
          Dd[c] = 0;
          S[a] += S[c];
          S[c] = 0;
        }
      }
      __syncthreads();
    }
    const bool live = L[t] >= 0;
    const unsigned ballot = __ballot_sync(0xFFFFFFFFu, live);
    if (lane == 0) warp_live[warp] = __popc(ballot);
    __syncthreads();
    if (warp == 0) {                    // inclusive scan of the warps
      int v = warp_live[lane];
#pragma unroll
      for (int s = 1; s < 32; s <<= 1) {
        const int u = __shfl_up_sync(0xFFFFFFFFu, v, s);
        if (lane >= s) v += u;
      }
      warp_live[lane] = v;
    }
    __syncthreads();
    if (live) {
      const int at = offset + (warp ? warp_live[warp - 1] : 0) +
                     __popc(ballot & ((1u << lane) - 1));
      out0[row + at] = L[t];
      out1[row + at] = Dd[t];
    }
    offset += warp_live[MERGE_THREADS / 32 - 1];
    __syncthreads();                    // before the next chunk's stores
  }
  for (int i = offset + t; i < n; i += MERGE_THREADS) {
    out0[row + i] = -1;
    out1[row + i] = 0;
  }
  if (t == 0) nmatch[blockIdx.x] = offset;
}

}  // namespace

// len, r_rel, out int32 [B, n]; litmask int32 [B, 16, 8].  Launches on
// `stream`; returns cudaGetLastError().
extern "C" int dt_resolve_litval(const void* len, const void* r_rel,
                                 const void* litmask, void* out, int B,
                                 int n, void* stream) {
  if (B < 0 || n < 0) return (int)cudaErrorInvalidValue;
  if (B == 0 || n == 0) return (int)cudaSuccess;
  const int chunks = (n + LIT_THREADS - 1) / LIT_THREADS;
  if ((int64_t)B * chunks > INT_MAX) return (int)cudaErrorInvalidValue;
  resolve_litval<<<(unsigned)(B * chunks), LIT_THREADS, 0,
                   (cudaStream_t)stream>>>(
      (const int*)len, (const int*)r_rel, (const int*)litmask, (int*)out, n,
      chunks);
  return (int)cudaGetLastError();
}

// rec0, rec1, out0, out1 int32 [B, n], n a multiple of 256; nmatch int32
// [B].  Launches on `stream`; returns cudaGetLastError().
extern "C" int dt_merge_runs(const void* rec0, const void* rec1, void* out0,
                             void* out1, void* nmatch, int B, int n,
                             void* stream) {
  if (B < 0 || n < 0 || n % RUN_TILE) return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  merge_runs<<<(unsigned)B, MERGE_THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)rec0, (const int*)rec1, (int*)out0, (int*)out1,
      (int*)nmatch, n);
  return (int)cudaGetLastError();
}
