// The wavefront stage-A decode shared by kernels K2 and K8
// (csrc/wave_stagea.cu): wave.decode_core for one position, exact, and
// the per-block tables through which both kernels decode most positions
// with one shared-memory probe (two for a match).
//
// decode_core is the canonical decode by compare rounds: up to 15
// bit-serial rounds for the litlen code, two select_bit32 descents and
// 15 more rounds for the distance, ~300 integer instructions a position.
// A code found within its first KL bits (KD for a distance) is decided
// by those bits alone, and so is everything decode_core derives from it
// but the extra bits, which follow in the peek.  So each block gets a
// table with one entry per KL-bit peek and one per KD-bit distance peek,
// each built by running decode_core's own halves (lit_fields,
// dist_fields) on the index bits: the tables equal decode_core by
// construction.  A peek whose code is not found within the table's bits
// (a longer code) reads SLOW and runs decode_core.
//
// A peek whose code is found nowhere (an incomplete code, such as the
// one-code distance tree of a block that repeats one distance) is decided
// by the table's bits too where no longer peek can find a code
// (never_found), and gets decode_core's invalid result.
//
// Entries (the torch form is deflate_tpu_torch/ops/wave_stagea.py::
// build_tables, which the tests hold against decode_core):
//   litlen  SLOW (-1); >= 0: a literal, EOB or no code, decode_core's A0
//           itself (P1 = 0); else a match: bit 31 | len | extra bits << 4
//           | base length << 7, with 1 <= len <= 15.
//   dist    SLOW; else len (0..15) | extra-bit shift (clamp(len, 1, 28))
//           << 4 | extra bits << 8 | base << 12 | no code << 27.
//
// KL = 11: the litlen codes of this codec's dynamic blocks are at most
// 10 bits on the benchmark corpus (no peek of it reads a SLOW litlen
// entry), and 2^11 + 2^10 entries (12 KiB) let the sixteen 128-thread
// CTAs an SM can hold fit in its shared memory.  Any maxl <= 15 builds
// with min(KL, maxl) rounds and falls back with maxl rounds, so codes
// longer than maxl stay not found, as in decode_core.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace stagea {

constexpr int KL = 11;              // litlen table index bits
constexpr int KD = 10;              // distance table index bits
constexpr int NL = 1 << KL;
constexpr int NDT = 1 << KD;
constexpr int TABLE_WORDS = NL + NDT;
constexpr int SLOW = -1;
constexpr int MD_WORDS = 7 * 16;    // l_lim l_first l_meta l_mask d_lim
                                    // d_first d_mask, 16 lengths each

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

// wave.lit_fields: decode_core's litlen half
struct LitFields {
  bool found, is_lit, is_eob, is_m;
  int len, r_rel, ebits, lbase;
};

__device__ __forceinline__ LitFields lit_fields(int pk, const int* md,
                                                int maxl) {
  LitFields f;
  int lh;
  canon(pk, md, md + 16, maxl, f.found, f.len, f.r_rel, lh);
  const int metasel = f.found ? md[32 + lh] : 0;
  const int masksel = f.found ? md[48 + lh] : 0;
  const int nlit = metasel & 0x1FF;
  const int has_eob = srl(metasel, 9) & 1;
  f.is_lit = f.found && f.r_rel < nlit;
  f.is_eob = f.found && has_eob > 0 && f.r_rel == nlit;
  f.is_m = f.found && !f.is_lit && !f.is_eob;
  const int j_len = clampi(f.r_rel - nlit - has_eob, 0, 28);
  const int li = select_bit32(masksel, j_len);
  const int li4 = srl(li - 4, 2);
  f.ebits = (li < 8 || li == 28) ? 0 : li4;
  f.lbase = li < 8 ? 3 + li
                   : (li == 28 ? 258
                               : 3 + shl(4 + (li & 3), clampi(li4, 0, 5)));
  return f;
}

// wave.dist_fields: decode_core's distance half
struct DistFields {
  bool found;
  int dlen, debits, dbase;
};

__device__ __forceinline__ DistFields dist_fields(int pk2, const int* md,
                                                  int maxd) {
  DistFields f;
  int dr_rel, dh_l;
  canon(pk2, md + 64, md + 80, maxd, f.found, f.dlen, dr_rel, dh_l);
  const int dmasksel = f.found ? md[96 + dh_l] : 0;
  const int dsym = select_bit32(dmasksel, dr_rel);
  const int dh = clampi(srl(dsym, 1) - 1, 0, 13);
  f.debits = dsym < 4 ? 0 : dh;
  f.dbase = dsym < 4 ? 1 + dsym : 1 + shl(2 + (dsym & 1), dh);
  return f;
}

// wave.decode_core for one position: the exact decode, and the fallback
// of the table path.  Returns (A0, P1).
__device__ __noinline__ int2 decode_core(int PK, int PKH, const int* md,
                                         int maxl, int maxd) {
  const LitFields L = lit_fields(PK, md, maxl);
  const int lextra = srl(PK, L.len) & (shl(1, L.ebits) - 1);
  const int length = L.is_m ? L.lbase + lextra : 1;
  const int adv1 = L.len + (L.is_m ? L.ebits : 0);
  const int a1c = clampi(adv1, 1, 24);
  const int pk2 = srl(PK, a1c) | shl(PKH, 32 - a1c);
  const DistFields D = dist_fields(pk2, md, maxd);
  const int dextra = srl(pk2, clampi(D.dlen, 1, 28)) & (shl(1, D.debits) - 1);
  const int dist = L.is_m ? D.dbase + dextra : 0;

  const bool invalid = !L.found || (L.is_m && !D.found);
  const int advance = clampi(L.is_m ? adv1 + D.dlen + D.debits : L.len, 1,
                             63);
  const int emit = L.is_lit ? 1 : (L.is_m ? length : 0);
  const int cls = invalid ? 3 : (L.is_eob ? 2 : (L.is_m ? 1 : 0));
  const int X = L.is_m ? clampi(length - 3, 0, 255) : L.r_rel;
  return make_int2(
      advance | shl(emit, 6) | shl(cls, 15) | shl(X, 17) | shl(L.len, 26),
      dist);
}

// True where no peek that starts with the first `from` bits of pk finds a
// code in rounds from+1 .. to: the least c a round l can reach is
// c_from << (l - from), and canon hits only where c < lim[l].  (A code
// not found within the table's bits is then not found at all.)
__device__ __forceinline__ bool never_found(int pk, const int* lim, int from,
                                            int to) {
  int c = 0;
  for (int l = 1; l <= from; ++l) c = shl(c, 1) | (srl(pk, l - 1) & 1);
  for (int l = from + 1; l <= to; ++l)
    if (shl(c, l - from) < lim[l]) return false;
  return true;
}

// The table entry of litlen peek bits i, decoded with min(KL, maxl)
// rounds; a code not found there is SLOW unless it is found nowhere up
// to maxl rounds (decode_core's invalid A0, advance 1).
__device__ __forceinline__ int lit_entry(int i, const int* md, int maxl) {
  const int rounds = min(KL, maxl);
  const LitFields L = lit_fields(i, md, rounds);
  if (!L.found && !never_found(i, md, rounds, maxl)) return SLOW;
  if (!L.is_m) {
    // decode_core's A0 without a distance: advance = len
    const int cls = !L.found ? 3 : (L.is_eob ? 2 : 0);
    const int a0 = clampi(L.len, 1, 63) | shl(L.is_lit ? 1 : 0, 6) |
                   shl(cls, 15) | shl(L.r_rel, 17) | shl(L.len, 26);
    return a0 >= 0 ? a0 : SLOW;
  }
  if (L.len < 1 || L.len > 15) return SLOW;
  return (int)(0x80000000u | (unsigned)(L.len | (L.ebits << 4) |
                                        (L.lbase << 7)));
}

// The table entry of distance peek bits j, decoded with min(KD, maxd)
// rounds; a code not found there is SLOW unless it is found nowhere up
// to maxd rounds (decode_core's invalid match: dsym 31, 13 extra bits).
__device__ __forceinline__ int dist_entry(int j, const int* md, int maxd) {
  const int rounds = min(KD, maxd);
  const DistFields D = dist_fields(j, md, rounds);
  if (!D.found && !never_found(j, md + 64, rounds, maxd)) return SLOW;
  if (D.dlen < 0 || D.dlen > 15) return SLOW;
  return D.dlen | (clampi(D.dlen, 1, 28) << 4) | (D.debits << 8) |
         (D.dbase << 12) | (D.found ? 0 : 1 << 27);
}

// decode_core at peek PK (PKH: the next 32 bits) by one block's tables
// (shared memory: NL litlen entries, then NDT distance entries).  Returns
// false, with A0 / P1 unset, where an entry reads SLOW.
__device__ __forceinline__ bool decode_lut(unsigned PK, unsigned PKH,
                                           const int* lut, int& A0,
                                           int& P1) {
  const int e = lut[PK & (NL - 1)];
  if (e >= 0) {                       // literal or EOB
    A0 = e;
    P1 = 0;
    return true;
  }
  if (e == SLOW) return false;
  const int len = e & 15, eb = (e >> 4) & 7, lbase = (e >> 7) & 511;
  const int length = lbase + (int)((PK >> len) & ((1u << eb) - 1));
  const int adv1 = len + eb;          // 1..21
  const unsigned pk2 = __funnelshift_r(PK, PKH, adv1);
  const int d = lut[NL + (pk2 & (NDT - 1))];
  if (d == SLOW) return false;
  const int dlen = d & 15, dshift = (d >> 4) & 15, deb = (d >> 8) & 15;
  P1 = ((d >> 12) & 0x7FFF) + (int)((pk2 >> dshift) & ((1u << deb) - 1));
  A0 = (adv1 + dlen + deb) | (length << 6) | ((1 + 2 * (d >> 27)) << 15) |
       (min(length - 3, 255) << 17) | (len << 26);
  return true;
}

// Copy one block's tables and md rows from device memory into shared
// memory (the caller synchronises).  tables_row is 16-byte aligned.
__device__ __forceinline__ void stage_tables(const int* tables_row,
                                             const int* md_row, int* lut,
                                             int* md) {
  const int4* src = reinterpret_cast<const int4*>(tables_row);
  int4* dst = reinterpret_cast<int4*>(lut);
  for (int i = threadIdx.x; i < TABLE_WORDS / 4; i += blockDim.x)
    dst[i] = src[i];
  for (int i = threadIdx.x; i < MD_WORDS; i += blockDim.x) md[i] = md_row[i];
}

}  // namespace stagea
