// LZ77 match fill of one 32 KiB row by one CTA, by pointer jumping in
// shared memory: the device code of kernel K4 (wave_fill.cu) and of the
// fill phase of kernel K6 (block_inflate.cu).  Torch form:
// deflate_tpu_torch/ops/wave_fill.py::fill_matches_jump.
//
// Records use pack_fill_recs' layout (ops/wave_fill.py), one int2 each:
// r0 = opos(15) | tiny<<15 | field(15)<<16 | short<<31, r1 = src.  A
// record writes n = min(len, ND - opos) bytes out[opos + k] =
// out[src + k % dist], dist = opos - src; records with dist <= 0 or
// src < 0 are skipped.
//
// Contract: the result equals the byte-sequential copy in record order
// (fill_matches_plain) for every row whose records do not overlap and
// come in order of opos — each output byte then comes from exactly one
// literal or one match, and every source byte is final before its
// record, as in every decoder plan.  Other rows get some fill and no
// fault: every source pointer is below its target, so chains end.
//
// Design.  Each byte of the row gets a 16-bit pointer (64 KiB of shared
// memory): a literal byte is its own chain's end, stored complemented
// (top bit set); byte k of a record points at src + k % dist, which lies
// before opos.  Records of up to SHORT bytes are written by one thread
// each (most records are 3-8 bytes); longer ones are listed and written
// by the whole CTA, so a 32 KiB run does not sit on one thread.  Then
// ptr[x] = ptr[ptr[x]] in place over the row until a round changes
// nothing (__syncthreads_or): any value read is an ancestor on x's
// chain, so after r rounds a pointer is 2^r hops along or at its end —
// at most 16 rounds; the periodic source (k % dist, not k - dist) keeps
// a long run one hop from its first period.  The gather takes each
// output word's 4 bytes from the literal row at the chain ends.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace fill {

constexpr int ND = 32768;                        // bytes per row
constexpr int OW = ND / 4;                       // words per row
constexpr int NM = 11264;                        // record slots per row
constexpr int SHORT = 64;                        // one thread's record
constexpr int LONG_CAP = ND / (SHORT + 1) + 1;   // longer, non-overlapping
constexpr unsigned DONE = 0x8000u;               // a complemented chain end

// Shared bytes fill_row needs besides the row: pointers, long-record list
// and its count.
constexpr int PTR_BYTES = 2 * ND;
constexpr int LONG_BYTES = LONG_CAP * 8 + 16;

// row: the literal bytes (shared, ND); ptr: shared [ND] halfwords;
// longs: shared [LONG_CAP] int2 plus one int; recs: the row's records in
// device memory (plain loads: K6 writes them in the same launch); nm:
// their count, clamped by the caller; out: the row's OW words in device
// memory.  Every thread of the CTA calls it.
__device__ void fill_row(const unsigned char* row, unsigned short* ptr,
                         int2* longs, const int2* recs, int nm, int* out) {
  const int T = blockDim.x, tid = threadIdx.x;
  unsigned* p32 = reinterpret_cast<unsigned*>(ptr);
  int* nlong = reinterpret_cast<int*>(longs + LONG_CAP);
  for (int i = tid; i < ND / 2; i += T)
    p32[i] = (~(2u * i) & 0xFFFFu) | ((~(2u * i + 1) & 0xFFFFu) << 16);
  if (tid == 0) *nlong = 0;
  __syncthreads();

  for (int m = tid; m < nm; m += T) {
    const int2 r = recs[m];
    const unsigned r0 = (unsigned)r.x;
    const int p = (int)(r0 & 0x7FFFu);
    const int fld = (int)((r0 >> 16) & 0x7FFFu);
    const int len = ((r0 >> 15) & 1u) ? 3 + (fld & 1) : fld + 3;
    const int src = r.y;
    const int n = min(len, ND - p);
    if (src < 0 || src >= p) continue;
    if (n > SHORT) {
      const int slot = atomicAdd(nlong, 1);
      if (slot < LONG_CAP) {
        longs[slot] = make_int2(p | (src << 16), n);
        continue;
      }
    }
    int s = src;
    for (int k = 0; k < n; ++k) {
      ptr[p + k] = (unsigned short)s;
      if (++s == p) s = src;
    }
  }
  __syncthreads();

  const int nl = min(*nlong, LONG_CAP);
  for (int i = 0; i < nl; ++i) {
    const int2 l = longs[i];
    const int p = l.x & 0xFFFF, src = (int)((unsigned)l.x >> 16);
    const int d = p - src, step = T % d;
    int j = tid % d;
    for (int k = tid; k < l.y; k += T) {
      ptr[p + k] = (unsigned short)(src + j);
      j += step;
      if (j >= d) j -= d;
    }
  }
  __syncthreads();

  for (;;) {
    bool live = false;
    for (int i = tid; i < ND / 2; i += T) {
      const unsigned w = p32[i];
      unsigned lo = w & 0xFFFFu, hi = w >> 16;
      if (!(lo & DONE)) {
        lo = ptr[lo];
        live |= !(lo & DONE);
      }
      if (!(hi & DONE)) {
        hi = ptr[hi];
        live |= !(hi & DONE);
      }
      const unsigned v = lo | (hi << 16);
      if (v != w) p32[i] = v;                 // only this thread writes i
    }
    if (!__syncthreads_or(live)) break;
  }

  for (int i = tid; i < OW; i += T) {
    const unsigned a = p32[2 * i], b = p32[2 * i + 1];
    out[i] = (int)((unsigned)row[(a & 0xFFFFu) ^ 0xFFFFu]
                   | ((unsigned)row[(a >> 16) ^ 0xFFFFu] << 8)
                   | ((unsigned)row[(b & 0xFFFFu) ^ 0xFFFFu] << 16)
                   | ((unsigned)row[(b >> 16) ^ 0xFFFFu] << 24));
  }
}

}  // namespace fill
