// Kernel K2: wavefront stages A+B and the within-chunk compaction, fused;
// and kernel K8, stage A alone (decode_positions_kernel, below), which
// shares decode_core.
//
// Replaces deflate_tpu/ops/wave_stagea.py::_kernel_ab (wrapper
// decode_mark_pallas).  Plain version: deflate_tpu_torch/ops/
// wave_stagea.py::decode_mark_plain (decode_positions + stop override +
// chunk_automaton + chunk_compact).
//
// What it computes, per block b and 64-bit body chunk w: starting at the
// chunk's hint phase, the chain of symbol starts inside the chunk; for
// each start the canonical litlen + distance decode (wave.decode_core,
// packed A0 / P1); the 9 per-chunk sums (marks, exit carry, emitted
// bytes, symbol / match / EOB / invalid counts); and the first CCAP=16
// symbols' A0/P1 in rank order.  Ranks >= 16 are dropped but still
// counted in sum_cnt, which the caller flags as a block error.
//
// What bounds it here: the TPU kernel decodes all 64 bit phases of every
// chunk (SIMD lanes are free there) and then runs a 64-step automaton to
// find which phases are real starts.  Only the starts reached from the
// hint matter: the automaton's marks are exactly that chain, its sums
// count only marked positions, and the compaction keeps only marked rows.
// So one thread per chunk walks the chain and decodes only at its
// ~8-16 starts, instead of 64 positions: ~2 decodes of ~150 integer ops
// per symbol, about 4-8x less arithmetic than the all-phase form, and
// the window words come from global memory (L1/L2-cached, 16 bytes per
// decode).  Divergence between chains of unequal length is the cost; a
// 256-block 8 MiB bucket is ~1M chunk-threads, so it is latency-bound.
// The compacted rows are written directly in rank order (no roll
// rounds); rows past a chunk's count are written as 0.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CCAP = 16;
constexpr int NKEYS = 8;   // l_lim l_first l_meta l_mask d_lim d_first d_mask stop
constexpr int THREADS = 128;

// XLA shift semantics: counts outside [0, 32) give 0
__device__ __forceinline__ int srl(int x, int n) {
  return (unsigned)n >= 32u ? 0 : (int)((unsigned)x >> n);
}
__device__ __forceinline__ int shl(int x, int n) {
  return (unsigned)n >= 32u ? 0 : (int)((unsigned)x << n);
}
__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// wave.select_bit32: branchless descent, in-range garbage past popcount
__device__ __forceinline__ int select_bit32(int m, int j) {
  int idx = 0;
  const int hs[5] = {16, 8, 4, 2, 1};
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    int h = hs[i];
    int low = m & ((1 << h) - 1);
    int c = __popc((unsigned)low);
    int go = j >= c;
    j -= go * c;
    m = go ? (m >> h) : low;
    idx += go * h;
  }
  return idx;
}

// wave._canon_decode for one position
__device__ __forceinline__ void canon(int pk, const int* lim,
                                      const int* first, int maxl,
                                      bool& found, int& len, int& rrel,
                                      int& lhit) {
  int c = 0, rsel = 0;
  found = false;
  lhit = 0;
  for (int l = 1; l <= maxl; ++l) {
    c = shl(c, 1) | (srl(pk, l - 1) & 1);
    if (!found && c < lim[l]) {
      rsel = c - (first[l] - (l << 10));
      lhit = l;
      found = true;
    }
  }
  len = srl(rsel, 10);
  rrel = rsel & 1023;
}

// wave.decode_core for one position
__device__ __forceinline__ void decode_core(int PK, int PKH, const int* md,
                                            int maxl, int maxd, int& A0,
                                            int& P1) {
  const int* l_lim = md;
  const int* l_first = md + 16;
  const int* l_meta = md + 32;
  const int* l_mask = md + 48;
  const int* d_lim = md + 64;
  const int* d_first = md + 80;
  const int* d_mask = md + 96;

  bool found;
  int len, r_rel, lh;
  canon(PK, l_lim, l_first, maxl, found, len, r_rel, lh);
  int metasel = found ? l_meta[lh] : 0;
  int masksel = found ? l_mask[lh] : 0;
  int nlit = metasel & 0x1FF;
  int has_eob = srl(metasel, 9) & 1;
  bool is_lit = found && r_rel < nlit;
  bool is_eob = found && has_eob > 0 && r_rel == nlit;
  bool is_m = found && !is_lit && !is_eob;

  int j_len = clampi(r_rel - nlit - has_eob, 0, 28);
  int li = select_bit32(masksel, j_len);
  int li4 = srl(li - 4, 2);
  int ebits = (li < 8 || li == 28) ? 0 : li4;
  int lbase = li < 8 ? 3 + li
                     : (li == 28 ? 258
                                 : 3 + shl(4 + (li & 3), clampi(li4, 0, 5)));
  int lextra = srl(PK, len) & (shl(1, ebits) - 1);
  int length = is_m ? lbase + lextra : 1;

  int adv1 = len + (is_m ? ebits : 0);
  int a1c = clampi(adv1, 1, 24);
  int pk2 = srl(PK, a1c) | shl(PKH, 32 - a1c);
  bool dfound;
  int dlen, dr_rel, dh_l;
  canon(pk2, d_lim, d_first, maxd, dfound, dlen, dr_rel, dh_l);
  int dmasksel = dfound ? d_mask[dh_l] : 0;
  int dsym = select_bit32(dmasksel, dr_rel);
  int dh = clampi(srl(dsym, 1) - 1, 0, 13);
  int debits = dsym < 4 ? 0 : dh;
  int dbase = dsym < 4 ? 1 + dsym : 1 + shl(2 + (dsym & 1), dh);
  int dextra = srl(pk2, clampi(dlen, 1, 28)) & (shl(1, debits) - 1);
  int dist = is_m ? dbase + dextra : 0;

  bool invalid = !found || (is_m && !dfound);
  int advance = clampi(is_m ? adv1 + dlen + debits : len, 1, 63);
  int emit = is_lit ? 1 : (is_m ? length : 0);
  int cls = invalid ? 3 : (is_eob ? 2 : (is_m ? 1 : 0));
  int X = is_m ? clampi(length - 3, 0, 255) : r_rel;
  A0 = advance | shl(emit, 6) | shl(cls, 15) | shl(X, 17) | shl(len, 26);
  P1 = dist;
}

__global__ void decode_mark_kernel(const int* __restrict__ nwords,
                                   const int* __restrict__ hints,
                                   const int* __restrict__ md_g,
                                   int* __restrict__ a0c,
                                   int* __restrict__ p1c,
                                   int* __restrict__ sums, int W64,
                                   int maxl, int maxd) {
  __shared__ int md[NKEYS * 16];
  const int b = blockIdx.y;
  for (int i = threadIdx.x; i < NKEYS * 16; i += blockDim.x)
    md[i] = md_g[(int64_t)b * NKEYS * 16 + i];
  __syncthreads();
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= W64) return;

  const int stop = md[7 * 16];
  const int* nw = nwords + (int64_t)b * (2 * W64 + 4);
  const int h = hints[(int64_t)b * W64 + w];
  int Mlo = h < 32 ? (int)(1u << clampi(h, 0, 31)) : 0;
  int Mhi = (h >= 32 && h < 64) ? (int)(1u << (h - 32)) : 0;
  int Clo = 0, Chi = 0, se = 0, sc = 0, sm = 0, sb = 0, si = 0;
  int64_t crow = (int64_t)b * CCAP * W64 + w;

  int t = h < 32 ? clampi(h, 0, 31) : (h < 64 ? h : 64);
  while (t < 64) {
    const int i = 2 * w + (t >> 5);
    const int r = t & 31;
    const int x0 = nw[i], x1 = nw[i + 1], x2 = nw[i + 2];
    const int PK = r ? (srl(x0, r) | shl(x1, 32 - r)) : x0;
    const int PKH = r ? (srl(x1, r) | shl(x2, 32 - r)) : x1;
    int A0, P1;
    decode_core(PK, PKH, md, maxl, maxd, A0, P1);
    if (64 * w + t == stop) A0 = 1 | (2 << 15);
    if (sc < CCAP) {
      a0c[crow + (int64_t)sc * W64] = A0;
      p1c[crow + (int64_t)sc * W64] = P1;
    }
    const int adv = A0 & 63;
    const int cls = srl(A0, 15) & 3;
    se += srl(A0, 6) & 511;
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
  for (int j = sc; j < CCAP; ++j) {
    a0c[crow + (int64_t)j * W64] = 0;
    p1c[crow + (int64_t)j * W64] = 0;
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
// wrapper always runs.
//
// One thread per (block, bit phase t, chunk w): the 64-bit peek at body
// bit 64w + t from the window words, as K2 builds it, then decode_core;
// A0/P1 land at [b, t, w].  Grid (chunk tiles, 64 phases, blocks):
// adjacent threads take adjacent chunks, so the stores are coalesced and
// the word loads are 8 bytes apart.  Bound by integer operations: every
// phase runs two 15-round canonical decodes (~300 operations) for 8 bytes
// written, where K2 decodes only the chain of real symbol starts.
__global__ void decode_positions_kernel(const int* __restrict__ nwords,
                                        const int* __restrict__ md_g,
                                        int* __restrict__ a0,
                                        int* __restrict__ p1, int W64) {
  __shared__ int md[7 * 16];
  const int b = blockIdx.z;
  const int t = blockIdx.y;
  for (int i = threadIdx.x; i < 7 * 16; i += blockDim.x)
    md[i] = md_g[(int64_t)b * 7 * 16 + i];
  __syncthreads();
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= W64) return;
  const int* nw = nwords + (int64_t)b * (2 * W64 + 4);
  const int i = 2 * w + (t >> 5);
  const int r = t & 31;
  const int x0 = nw[i], x1 = nw[i + 1], x2 = nw[i + 2];
  const int PK = r ? (srl(x0, r) | shl(x1, 32 - r)) : x0;
  const int PKH = r ? (srl(x1, r) | shl(x2, 32 - r)) : x1;
  int A0, P1;
  decode_core(PK, PKH, md, 15, 15, A0, P1);
  const int64_t o = ((int64_t)b * 64 + t) * W64 + w;
  a0[o] = A0;
  p1[o] = P1;
}

}  // namespace

extern "C" int dt_decode_positions(const void* nwords, const void* md7,
                                   void* a0, void* p1, int B, int W64,
                                   void* stream) {
  dim3 grid((W64 + THREADS - 1) / THREADS, 64, B);
  decode_positions_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)nwords, (const int*)md7, (int*)a0, (int*)p1, W64);
  return (int)cudaGetLastError();
}

extern "C" int dt_decode_mark(const void* nwords, const void* hints,
                              const void* md8, void* a0c, void* p1c,
                              void* sums, int B, int W64, int maxl,
                              int maxd, void* stream) {
  dim3 grid((W64 + THREADS - 1) / THREADS, B);
  decode_mark_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)nwords, (const int*)hints, (const int*)md8, (int*)a0c,
      (int*)p1c, (int*)sums, W64, maxl, maxd);
  return (int)cudaGetLastError();
}
