// Kernel K2: wavefront stages A+B and the within-chunk compaction, fused;
// and kernel K8, stage A alone (decode_positions_kernel, below).  Both
// decode through the per-block tables of stagea_core.cuh, which
// build_tables_kernel writes to a scratch row per block first.
//
// K2 replaces deflate_tpu/ops/wave_stagea.py::_kernel_ab (wrapper
// decode_mark_pallas).  Plain version: deflate_tpu_torch/ops/
// wave_stagea.py::decode_mark_plain (decode_positions + stop override +
// chunk_automaton + chunk_compact); torch form of this design:
// decode_mark_lut.
//
// What it computes, per block b and 64-bit body chunk w: starting at the
// chunk's hint phase, the chain of symbol starts inside the chunk; for
// each start the canonical litlen + distance decode (wave.decode_core,
// packed A0 / P1); the 9 per-chunk sums (marks, exit carry, emitted
// bytes, symbol / match / EOB / invalid counts); and the first CCAP=16
// symbols' A0/P1 in rank order.  Ranks >= 16 are dropped but still
// counted in sum_cnt, which the caller flags as a block error.  The
// stop bit (a synthetic EOB at exactly 64w + t == stop[b]) comes as its
// own pointer, or none.
//
// What bounds it here: the chain is serial, ~8-16 starts a chunk.  The
// TPU kernel decodes all 64 phases and runs a 64-step automaton; only
// the chain reached from the hint matters (its marks are exactly that
// chain, its sums count only marked positions, the compaction keeps only
// marked rows), so one thread per chunk walks it.  The thread holds the
// four window words a chunk can ever need (nw[2w .. 2w+3], as t < 64) in
// registers; a step is two funnel shifts, a shared-memory probe (a
// second for a match), a few ALU instructions and the next start — no
// device-memory load on the chain.  Warps still wait for their longest
// chain.  The compacted rows are written directly in rank order; rows
// past a chunk's count are written as 0.
#include "stagea_core.cuh"

namespace {

using namespace stagea;

constexpr int CCAP = 16;
constexpr int THREADS = 128;
constexpr int BUILD_THREADS = 128;
static_assert(TABLE_WORDS % BUILD_THREADS == 0, "one entry per thread");

// Per block b (blockIdx.y), entries blockIdx.x * 128 + threadIdx.x of
// its tables row: NL litlen entries, then NDT distance entries.
__global__ void __launch_bounds__(BUILD_THREADS)
    build_tables_kernel(const int* __restrict__ md_g,
                        int* __restrict__ tables, int maxl, int maxd) {
  __shared__ int md[MD_WORDS];
  const int b = blockIdx.y;
  for (int i = threadIdx.x; i < MD_WORDS; i += blockDim.x)
    md[i] = md_g[(int64_t)b * MD_WORDS + i];
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  int* row = tables + (int64_t)b * TABLE_WORDS;
  row[i] = i < NL ? lit_entry(i, md, maxl) : dist_entry(i - NL, md, maxd);
}

__global__ void __launch_bounds__(THREADS)
    decode_mark_kernel(const int* __restrict__ nwords,
                       const int* __restrict__ hints,
                       const int* __restrict__ md_g,
                       const int* __restrict__ stop_g,
                       const int* __restrict__ tables,
                       int* __restrict__ a0c, int* __restrict__ p1c,
                       int* __restrict__ sums, int W64, int maxl,
                       int maxd) {
  __shared__ __align__(16) int lut[TABLE_WORDS];
  __shared__ int md[MD_WORDS];
  const int b = blockIdx.y;
  stage_tables(tables + (int64_t)b * TABLE_WORDS, md_g + (int64_t)b * MD_WORDS,
               lut, md);
  __syncthreads();
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= W64) return;

  const int stop = stop_g ? stop_g[b] : -1;
  const int* nw = nwords + (int64_t)b * (2 * W64 + 4) + 2 * w;
  const unsigned x0 = nw[0], x1 = nw[1], x2 = nw[2], x3 = nw[3];
  const int h = hints[(int64_t)b * W64 + w];
  int Mlo = h < 32 ? (int)(1u << clampi(h, 0, 31)) : 0;
  int Mhi = (h >= 32 && h < 64) ? (int)(1u << (h - 32)) : 0;
  int Clo = 0, Chi = 0, se = 0, sc = 0, sm = 0, sb = 0, si = 0;
  const int64_t crow = (int64_t)b * CCAP * W64 + w;

  int t = h < 32 ? clampi(h, 0, 31) : (h < 64 ? h : 64);
  while (t < 64) {
    const bool up = t >= 32;
    const unsigned lo = up ? x1 : x0, mid = up ? x2 : x1,
                   hi = up ? x3 : x2;
    const unsigned PK = __funnelshift_r(lo, mid, t);   // shift t & 31
    const unsigned PKH = __funnelshift_r(mid, hi, t);
    int A0, P1;
    if (!decode_lut(PK, PKH, lut, A0, P1)) {
      const int2 r = decode_core((int)PK, (int)PKH, md, maxl, maxd);
      A0 = r.x;
      P1 = r.y;
    }
    if (64 * w + t == stop) A0 = 1 | (2 << 15);
    if (sc < CCAP) {
      a0c[crow + (int64_t)sc * W64] = A0;
      p1c[crow + (int64_t)sc * W64] = P1;
    }
    const int adv = A0 & 63;
    const int cls = (A0 >> 15) & 3;
    se += (A0 >> 6) & 511;
    sc += 1;
    sm += cls == 1;
    sb += cls == 2;
    si += cls == 3;
    if (cls >= 2) break;
    const int nt = t + adv;
    if (nt < 32) {
      Mlo |= (int)(1u << nt);
    } else if (nt < 64) {
      Mhi |= (int)(1u << (nt - 32));
    } else {
      if (nt < 96) Clo |= (int)(1u << (nt - 64));
      else Chi |= (int)(1u << (nt - 96));
      break;
    }
    t = nt;
  }
  // rows past the count, j in step with the warp's other lanes (one
  // coalesced store a row) rather than from each lane's own count
  for (int j = 0; j < CCAP; ++j) {
    if (j >= sc) {
      a0c[crow + (int64_t)j * W64] = 0;
      p1c[crow + (int64_t)j * W64] = 0;
    }
  }
  int* s = sums + (int64_t)b * 9 * W64 + w;
  const int vals[9] = {Mlo, Mhi, Clo, Chi, se, sc, sm, sb, si};
#pragma unroll
  for (int k = 0; k < 9; ++k) s[(int64_t)k * W64] = vals[k];
}

// Kernel K8: stage A alone — decode_core at every bit position.
//
// Replaces deflate_tpu/ops/wave_stagea.py::_kernel (wrapper
// decode_positions_pallas), the unfused route of the reference's
// wave_decode (DT_STAGEAB_PALLAS=0).  Plain version: deflate_tpu_torch/
// ops/wave.py::decode_positions at 15 compare rounds, as the reference's
// wrapper always runs; torch form of this design: decode_positions_lut.
//
// One thread per (block, chunk w): it loads the chunk's four window words
// once and runs over the 64 bit phases, building each peek with funnel
// shifts from registers and decoding it through the shared-memory tables;
// A0/P1 land at [b, t, w], so for each t neighbouring threads store
// neighbouring words.  A phase whose entry reads SLOW is kept in a 64-bit
// mask and decoded in full (decode_core) after the loop, so a warp pays
// for its lane with the most of them, not for every phase where any lane
// has one.  With ~15 instructions a position the 201 MB of stores of
// phase E, not the issue rate, should bound it.
__global__ void __launch_bounds__(THREADS)
    decode_positions_kernel(const int* __restrict__ nwords,
                            const int* __restrict__ md_g,
                            const int* __restrict__ tables,
                            int* __restrict__ a0, int* __restrict__ p1,
                            int W64) {
  __shared__ __align__(16) int lut[TABLE_WORDS];
  __shared__ int md[MD_WORDS];
  const int b = blockIdx.y;
  stage_tables(tables + (int64_t)b * TABLE_WORDS, md_g + (int64_t)b * MD_WORDS,
               lut, md);
  __syncthreads();
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= W64) return;
  const int* nw = nwords + (int64_t)b * (2 * W64 + 4) + 2 * w;
  const unsigned x0 = nw[0], x1 = nw[1], x2 = nw[2], x3 = nw[3];
  int* oa = a0 + (int64_t)b * 64 * W64 + w;
  int* op = p1 + (int64_t)b * 64 * W64 + w;
  unsigned long long slow = 0;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const unsigned lo = half ? x1 : x0, mid = half ? x2 : x1,
                   hi = half ? x3 : x2;
#pragma unroll 8
    for (int r = 0; r < 32; ++r) {
      const int t = 32 * half + r;
      const unsigned PK = __funnelshift_r(lo, mid, r);
      const unsigned PKH = __funnelshift_r(mid, hi, r);
      int A0, P1;
      if (decode_lut(PK, PKH, lut, A0, P1)) {
        oa[(int64_t)t * W64] = A0;
        op[(int64_t)t * W64] = P1;
      } else {
        slow |= 1ull << t;
      }
    }
  }
  while (slow) {
    const int t = __ffsll((long long)slow) - 1;
    slow &= slow - 1;
    const bool up = t >= 32;
    const unsigned lo = up ? x1 : x0, mid = up ? x2 : x1, hi = up ? x3 : x2;
    const unsigned PK = __funnelshift_r(lo, mid, t);   // shift t & 31
    const unsigned PKH = __funnelshift_r(mid, hi, t);
    const int2 v = decode_core((int)PK, (int)PKH, md, 15, 15);
    oa[(int64_t)t * W64] = v.x;
    op[(int64_t)t * W64] = v.y;
  }
}

cudaError_t build_tables(const void* md7, void* tables, int B, int maxl,
                         int maxd, cudaStream_t stream) {
  dim3 grid(TABLE_WORDS / BUILD_THREADS, B);
  build_tables_kernel<<<grid, BUILD_THREADS, 0, stream>>>(
      (const int*)md7, (int*)tables, maxl, maxd);
  return cudaGetLastError();
}

}  // namespace

// tables: scratch int32 [B, table_words], which must equal TABLE_WORDS
// (the Python wrapper's constant), 16-byte aligned.
extern "C" int dt_decode_positions(const void* nwords, const void* md7,
                                   void* tables, void* a0, void* p1, int B,
                                   int W64, int table_words, void* stream) {
  if (table_words != TABLE_WORDS) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = build_tables(md7, tables, B, 15, 15, s);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((W64 + THREADS - 1) / THREADS, B);
  decode_positions_kernel<<<grid, THREADS, 0, s>>>(
      (const int*)nwords, (const int*)md7, (const int*)tables, (int*)a0,
      (int*)p1, W64);
  return (int)cudaGetLastError();
}

// stop: int32 [B] or null (no stop bit).
extern "C" int dt_decode_mark(const void* nwords, const void* hints,
                              const void* md7, const void* stop,
                              void* tables, void* a0c, void* p1c,
                              void* sums, int B, int W64, int maxl,
                              int maxd, int table_words, void* stream) {
  if (table_words != TABLE_WORDS) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = build_tables(md7, tables, B, maxl, maxd, s);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((W64 + THREADS - 1) / THREADS, B);
  decode_mark_kernel<<<grid, THREADS, 0, s>>>(
      (const int*)nwords, (const int*)hints, (const int*)md7,
      (const int*)stop, (const int*)tables, (int*)a0c, (int*)p1c,
      (int*)sums, W64, maxl, maxd);
  return (int)cudaGetLastError();
}
