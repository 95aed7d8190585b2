// Kernel K6: full inflate of self-contained DEFLATE blocks.
//
// Replaces deflate_tpu/ops/pallas_inflate.py::_kernel (wrappers
// _inflate_blocks_jit and inflate_blocks), which decoded K = 4 blocks per
// grid cell on the TPU scalar core, interleaving their dependent-load
// chains, with each block's 40 KiB input window DMA'd into SMEM.  Plain
// version: deflate_tpu_torch/ops/block_inflate.py::inflate_blocks_plain;
// the plain form of this design is inflate_blocks_records there.
//
// Contract per block b: the window starts at stream word start_w[b]; the
// block's BFINAL bit is bit0[b] bits into it; avail[b] bits of it may be
// read.  status[b] = (produced, err, end bit relative to the window), and
// out row b holds the produced bytes (zero past them).  Where err is set
// only err is meaningful.  The reference's fourth status word
// (iterations << 1 | live) profiled its K-chain interleaving; it is not
// part of this contract and is not produced here.  recs is a device
// scratch of NM int2 records per block (the wrapper allocates it).
//
// Error set (the reference's): reserved block type; stored LEN/NLEN
// mismatch, stored length > 32 KiB or past avail; HLIT > 286 or
// HDIST > 30; over-subscribed trees, incomplete trees except a single
// length-1 litlen/dist code, an empty CL code; a bad code-length repeat;
// no end-of-block code; invalid litlen/dist symbols; a distance before
// the block start; output past 32 KiB; any symbol past avail; more than
// MAX_ACTIONS loop steps (a literal pair, or <= 8 bytes of a match, per
// step).
//
// What bounds it here: one decode chain per block (table probe -> code
// length -> next probe), which nothing can split without hints.  The
// first version, thread 0 reading every step's bits with three device-
// memory loads and copying every match byte itself, took 119-137 ns a
// symbol.  On one thread the chain is latency and instruction count:
// each dependent ALU step costs ~5 cycles and a shared-memory probe ~30.
// Design: one CTA of 512 threads per block, two CTAs per SM (~106 KB of
// dynamic shared memory each), so all 256 blocks of a batch are
// resident at once:
//   (1) stage: the CTA zeroes the row, copies the block's 40 KiB input
//       window and the fixed-code tables into shared memory (coalesced);
//   (2) header: thread 0 reads the block type, the counts and the code
//       lengths; the CTA builds each canonical table (code-length, then
//       litlen and dist) in parallel, and from them fast tables (12
//       bits: one or two literals, or a length code; 10 bits: a
//       distance code), so most literal pairs and symbols take one
//       probe;
//   (3) decode: thread 0 runs the symbol loop over three window words
//       held in registers, the bits at the decode position one funnel
//       shift away and the next word loaded before it is needed; a
//       literal step issues the next step's probe before its own test
//       and has no branch but the loop's.  A literal goes into the row,
//       a match appends one record (pack_fill_recs' layout) to the
//       block's scratch in device memory, a store off the chain — no
//       byte is copied.  A block's matches never overlap and never reach
//       before it (dist > opos is an error), so they meet the fill's
//       contract.  The other warps wait at the barrier; stored payloads
//       are copied by the whole CTA;
//   (4) fill: the whole CTA resolves the copies with fill::fill_row
//       (fill_block.cuh), the device code of kernel K4, and writes the
//       row out.  The staged window is dead by then and shares its
//       shared memory with the fill's pointers; the tables share theirs
//       with the fill's long-record list.
#include "fill_block.cuh"

namespace {

constexpr int OUT_W = 8192;
constexpr int OUT_BYTES = OUT_W * 4;
constexpr int IN_W = 10240;            // input window words (40 KiB)
constexpr int LT_ROOT = 9;
constexpr int DT_ROOT = 6;
constexpr int LT_SIZE = 896;
constexpr int DT_SIZE = 704;
constexpr int TAB_SLOT = LT_SIZE + DT_SIZE;
constexpr int CL_SIZE = 128;
constexpr int LENS_W = 320;
constexpr int WORK_W = 288;
constexpr int C_CL_ORDER = 0;
constexpr int C_LITPAY = 32;
constexpr int C_DISTPAY = 320;
constexpr int CLS_LIT = 0, CLS_LEN = 1, CLS_EOB = 2, CLS_BAD = 3;
constexpr int INVALID = CLS_BAD << 17;
constexpr int D_INVALID = 15 << 5;
constexpr int MAX_ACTIONS = 65536;
constexpr int THREADS = 512;
constexpr int M_DONE = 0, M_HUFF = 1, M_DYN = 2, M_STORED = 3;
// per-block state words in shared memory
constexpr int S_MODE = 0, S_BP = 1, S_ERR = 2, S_SRC = 3, S_SLEN = 4,
              S_OPOS = 5, S_NM = 6, S_FLAG = 7, S_NLIT = 8, S_NDIST = 9;
constexpr int FAST_BITS = 12, DFAST_BITS = 10;   // fast table index bits

// shared memory: row | pointers (window and fast tables aliased) |
// tables (long-record list aliased) | per-block state
constexpr int TABLE_INTS = TAB_SLOT + CL_SIZE + LENS_W + 16 + 16 + WORK_W;
constexpr int TABLE_BYTES = TABLE_INTS * 4;
constexpr int ST_INTS = 10;
constexpr int SMEM = fill::ND + fill::PTR_BYTES + TABLE_BYTES + ST_INTS * 4;
static_assert(4 * (IN_W + (1 << FAST_BITS) + (1 << DFAST_BITS)
                   + (1 << LT_ROOT)) <= fill::PTR_BYTES,
              "window, fast tables and table scratch must fit the pointers");
static_assert(fill::LONG_BYTES <= TABLE_BYTES, "list must fit the tables");
static_assert(2 * SMEM + 2048 <= 228 * 1024, "two CTAs per SM");

// window word i; zero past the 40 KiB window (as the plain version reads)
__device__ __forceinline__ unsigned wword(const unsigned* win, int i) {
  return (unsigned)i < (unsigned)IN_W ? win[i] : 0u;
}

// 64 bits at window bit bp
__device__ __forceinline__ unsigned long long peek64(const unsigned* win,
                                                     int bp) {
  const int wi = bp >> 5;
  const unsigned sh = (unsigned)bp & 31u;
  const unsigned long long lo =
      (unsigned long long)wword(win, wi)
      | ((unsigned long long)wword(win, wi + 1) << 32);
  const unsigned long long hi = wword(win, wi + 2);
  return sh ? (lo >> sh) | (hi << (64 - sh)) : lo;
}

__device__ __forceinline__ int bits(const unsigned* win, int bp, int n) {
  return (int)(peek64(win, bp) & ((1ull << n) - 1));
}

// Two-level probe of the low bits of pk; returns the entry, sets nbits.
__device__ __forceinline__ int probe(const int* tab, unsigned long long pk,
                                     int root, int subcap, int* nb) {
  int e = tab[pk & ((1u << root) - 1)];
  if (e < 0) {
    int sb = (int)(((unsigned)e >> 16) & 31u);
    sb = sb < subcap ? sb : subcap;
    e = tab[(e & 0x3FF) + (int)((pk >> root) & ((1u << sb) - 1))];
    *nb = (e & 31) + root;
  } else {
    *nb = e & 31;
  }
  return e;
}

// The canonical two-level table of the code lens[0..nsyms), built by the
// whole CTA (every thread calls it).  It decodes every bit pattern as
// zlib's inflate_table layout, which the plain version builds, does (the
// root level, then one sub-table for each root prefix of longer codes,
// of 2^(longest code of the prefix - root) entries, in prefix order), and
// fails on the same codes: over-subscribed, incomplete other than a
// single length-1 litlen/dist code, or an empty CL code (a complete
// code's sub-tables always fit cap; the check stays for safety).  An
// entry is pay[sym] (sym << 8 without pay) | its bits past the level it
// sits on.  Returns true on an error.  Scratch, all shared: cnt and
// first [16], rev [nsyms], sub [1 << root], *flag.
__device__ bool build_table(const int* lens, int nsyms, int root, int* tab,
                            int cap, bool is_cl, const int* pay, int fill,
                            int* cnt, int* first, int* rev, int* sub,
                            int* flag) {
  const int T = blockDim.x, tid = threadIdx.x, nroot = 1 << root;
  if (tid < 16) cnt[tid] = 0;
  for (int i = tid; i < cap; i += T) tab[i] = fill;
  for (int i = tid; i < nroot; i += T) sub[i] = 0;
  __syncthreads();
  for (int i = tid; i < nsyms; i += T)
    if (lens[i]) atomicAdd(&cnt[lens[i]], 1);
  __syncthreads();
  if (tid == 0) {
    int left = 1, maxlen = 0, npresent = 0, bad = 0, code = 0;
    for (int l = 1; l < 16; ++l) {
      npresent += cnt[l];
      left = 2 * left - cnt[l];
      if (cnt[l] > 0) maxlen = l;
      if (left < 0) bad = 1;                     // over-subscribed
      code = (code + cnt[l - 1]) << 1;           // RFC 1951 3.2.2
      first[l] = code;
    }
    if (left != 0 && npresent > 0 && (is_cl || maxlen != 1)) bad = 1;
    if (is_cl && npresent == 0) bad = 1;
    *flag = bad;
  }
  __syncthreads();
  if (*flag) return true;
  // each symbol: its canonical code (rank among its length), bit-reversed
  // as the stream reads it; root entries, or the depth of its prefix
  for (int i = tid; i < nsyms; i += T) {
    const int l = lens[i];
    if (!l) continue;
    int r = 0;
    for (int j = 0; j < i; ++j) r += lens[j] == l;
    const int rv = (int)(__brev((unsigned)(first[l] + r)) >> (32 - l));
    rev[i] = rv;
    if (l <= root) {
      const int entry = (pay ? pay[i] : i << 8) | l;
      for (int hi = 0; hi < 1 << (root - l); ++hi) tab[rv + (hi << l)] = entry;
    } else {
      atomicMax(&sub[rv & (nroot - 1)], l - root);
    }
  }
  __syncthreads();
  if (tid < 32) {
    // sub-table offsets in prefix order: a warp scan over the prefixes
    const int per = nroot >> 5;
    int sz = 0;
    for (int j = 0; j < per; ++j) {
      const int d = sub[tid * per + j];
      sz += d ? 1 << d : 0;
    }
    int x = sz;
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, d);
      if (tid >= d) x += y;
    }
    int off = nroot + x - sz;
    for (int j = 0; j < per; ++j) {
      const int low = tid * per + j, d = sub[low];
      if (d) {
        tab[low] = (int)(0x80000000u | (unsigned)d << 16 | (unsigned)off);
        off += 1 << d;
      }
    }
    if (tid == 31 && off > cap) *flag = 1;
  }
  __syncthreads();
  if (*flag) return true;
  for (int i = tid; i < nsyms; i += T) {
    const int l = lens[i];
    if (l <= root) continue;
    const int rv = rev[i];
    const int link = tab[rv & (nroot - 1)];
    const int d = (link >> 16) & 31, off = link & 0x3FF;
    const int entry = (pay ? pay[i] : i << 8) | (l - root);
    for (int hi = 0; hi < 1 << (d - (l - root)); ++hi)
      tab[off + (rv >> root) + (hi << (l - root))] = entry;
  }
  __syncthreads();
  return false;
}

// Header, first part (thread 0): the block type; a stored block's
// length; a dynamic block's counts and code-length code lengths (into
// lens[0..19)).  Returns the mode: M_DONE (st[S_ERR] says whether that is
// an error), M_STORED, M_HUFF (a fixed block: its tables are staged) or
// M_DYN.  Sets st[S_BP] (the next bit, or past a stored payload), and
// st[S_SRC], st[S_SLEN] or st[S_NLIT], st[S_NDIST].
__device__ int parse_head(const unsigned* win, int bit0, int avail,
                          const int* statics, int* lens, int* st) {
  int bp = bit0 + 1;                               // past BFINAL
  const int btype = bits(win, bp, 2);
  bp += 2;
  st[S_ERR] = 1;
  st[S_BP] = bp;
  if (btype == 3) return M_DONE;
  if (btype == 0) {
    bp = (bp + 7) & ~7;
    const int slen = bits(win, bp, 16);
    const int nlen = bits(win, bp + 16, 16);
    bp += 32;
    st[S_BP] = bp;
    if ((slen ^ nlen) != 0xFFFF || bp + 8 * slen > avail
        || slen > OUT_BYTES)
      return M_DONE;
    st[S_ERR] = 0;
    st[S_BP] = bp + 8 * slen;
    st[S_SRC] = bp >> 3;
    st[S_SLEN] = slen;
    return slen ? M_STORED : M_DONE;
  }
  if (btype == 1) {
    st[S_ERR] = 0;
    return M_HUFF;
  }
  const int nlit = bits(win, bp, 5) + 257;
  const int ndist = bits(win, bp + 5, 5) + 1;
  const int ncl = bits(win, bp + 10, 4) + 4;
  bp += 14;
  st[S_BP] = bp;
  if (nlit > 286 || ndist > 30) return M_DONE;
  for (int t = 0; t < 19; ++t) lens[t] = 0;
  for (int t = 0; t < ncl; ++t) {
    lens[statics[TAB_SLOT + C_CL_ORDER + t]] = bits(win, bp, 3);
    bp += 3;
  }
  st[S_BP] = bp;
  st[S_NLIT] = nlit;
  st[S_NDIST] = ndist;
  return M_DYN;
}

// Header, second part (thread 0, once the CL table is built): the
// litlen and dist code lengths into lens[0..nlit + ndist).  Returns M_DYN,
// or M_DONE on an error; advances st[S_BP].
__device__ int read_lengths(const unsigned* win, int avail,
                            const int* cl_tab, int* lens, int* st) {
  int bp = st[S_BP];
  const int ntot = st[S_NLIT] + st[S_NDIST];
  int i = 0;
  while (i < ntot) {
    const int e = cl_tab[bits(win, bp, 7)];
    if (((e >> 17) & 3) != 0 || e < 0) return M_DONE;
    bp += e & 31;
    const int sym = (e >> 8) & 0x1FF;
    if (sym < 16) {
      lens[i++] = sym;
      continue;
    }
    int cnt_rep, val = 0;
    if (sym == 16) {
      cnt_rep = 3 + bits(win, bp, 2);
      bp += 2;
      if (i == 0) return M_DONE;
      val = lens[i - 1];
    } else if (sym == 17) {
      cnt_rep = 3 + bits(win, bp, 3);
      bp += 3;
    } else {
      cnt_rep = 11 + bits(win, bp, 7);
      bp += 7;
    }
    if (i + cnt_rep > ntot) return M_DONE;
    for (int t = 0; t < cnt_rep; ++t) lens[i + t] = val;
    i += cnt_rep;
  }
  st[S_BP] = bp;
  if (bp > avail || lens[256] == 0) return M_DONE;
  return M_DYN;
}

// Fast tables, built by the whole CTA from the two-level tables once the
// header is parsed, each entry unpacked for the loop:
//   fast[12 bits]: one or two literals whose codes fit the 12 bits,
//     negative: sign | count << 24 | second << 16 | first << 8 | bits;
//     a length code of <= 12 bits: base << 13 | extra << 10 | code bits
//     << 5 | (code + extra bits); else 0 (the two-level tables decide);
//   dfast[10 bits]: a valid distance code of <= 10 bits: base << 13 |
//     extra << 9 | code bits << 5 | (code + extra bits); else 0.
__device__ void build_fast(const int* lt, int* fast, int* dfast) {
  const int* dt = lt + LT_SIZE;
  for (int i = threadIdx.x; i < 1 << FAST_BITS; i += blockDim.x) {
    int nb;
    const int e = probe(lt, (unsigned)i, LT_ROOT, 6, &nb);
    const int cls = (e >> 17) & 3;
    int v = 0;
    if (e >= 0 && nb <= FAST_BITS && cls == CLS_LIT) {
      v = (int)(0x80000000u | 1u << 24 | ((e >> 8) & 0xFF) << 8 | nb);
      int nb2;
      const int f = probe(lt, (unsigned)i >> nb, LT_ROOT, 6, &nb2);
      if (f >= 0 && ((f >> 17) & 3) == CLS_LIT && nb + nb2 <= FAST_BITS)
        v = (int)(0x80000000u | 2u << 24 | ((f >> 8) & 0xFF) << 16
                  | ((e >> 8) & 0xFF) << 8 | (nb + nb2));
    } else if (e >= 0 && nb <= FAST_BITS && cls == CLS_LEN) {
      const int eb = (e >> 5) & 7;
      v = ((e >> 8) & 0x1FF) << 13 | eb << 10 | nb << 5 | (nb + eb);
    }
    fast[i] = v;
  }
  for (int i = threadIdx.x; i < 1 << DFAST_BITS; i += blockDim.x) {
    int nb;
    const int e = probe(dt, (unsigned)i, DT_ROOT, 9, &nb);
    const int deb = (e >> 5) & 15;
    dfast[i] = e >= 0 && nb <= DFAST_BITS && deb != 15
                   ? ((e >> 9) & 0x7FFF) << 13 | deb << 9 | nb << 5
                         | (nb + deb)
                   : 0;
  }
}

// The symbol loop: literals into ob, matches as records into recs.
// Returns err; advances *bp, sets *opos and *nm.
//
// Bits: w0, w1, w2 hold window words wbase/32 .. wbase/32 + 2 and
// bp - wbase < 32 at the top of the loop, so a funnel shift gives the
// 32 bits at bp, and those at any position up to 64 bits on, without a
// load: only the table probes sit on the chain, and each literal step
// issues the next step's probe before it knows that it is a literal.
// A fast probe decodes one or two literals, or a length code; the
// distance takes one more.  Long codes, the last symbols before avail
// or 32 KiB, the end of block and errors take the two-level tables, one
// step of inflate_blocks_plain's loop.  A step of the plain version
// emits at least one byte per step it counts (a match of n > 8 bytes
// counts 1 + (n - 1) / 8 steps) or ends the block, so its count cannot
// pass MAX_ACTIONS within 32 KiB, nor can this loop's, which counts the
// steps of that slow path alone: err does not depend on how literals
// are grouped.
__device__ int symbol_loop(const unsigned* win, const int* lt,
                           const int* fast, const int* dfast, int avail,
                           unsigned char* ob, int2* recs, int* bp_io,
                           int* opos_out, int* nm_out) {
  const int* dt = lt + LT_SIZE;
  int bp = *bp_io, opos = 0, steps = 0, err = 0, nm = 0;
  int wbase = bp & ~31;
  unsigned w0 = wword(win, wbase >> 5), w1 = wword(win, (wbase >> 5) + 1),
           w2 = wword(win, (wbase >> 5) + 2);
  const int avail_fast = avail - FAST_BITS;
  for (;;) {
    // word wbase/32 + 3, for advancing without waiting on a load; window
    // words past the 40 KiB are read from the fast tables behind them:
    // their bits are used only past avail, where every step fails
    unsigned w3 = win[(wbase >> 5) + 3];
    int o = bp - wbase;                                  // < 32
    int fe = fast[__funnelshift_r(w0, w1, o) & ((1u << FAST_BITS) - 1)];
    int lim = avail_fast - wbase;
    bool lit;
    do {
      // the next probe, as if fe were a literal step (harmless if not),
      // issued before the test; the step is predicated, without a
      // branch, so that the loop's one branch waits on the test, not on
      // the probe
      const int on = o + (fe & 31);                      // < 63
      const unsigned valn = on < 32 ? __funnelshift_r(w0, w1, on)
                                    : __funnelshift_r(w1, w2, on);
      const int fen = fast[valn & ((1u << FAST_BITS) - 1)];
      // far from avail and the row's end every fast literal entry fits
      lit = o <= lim && opos <= OUT_BYTES - 2 && fe < 0;
      // the second byte is junk after a single literal: the next literal
      // overwrites it, a match's bytes are not read from the row, and the
      // byte after the block's last is cleared at the end
      if (lit) ob[opos] = (unsigned char)(fe >> 8);
      if (lit) ob[opos + 1] = (unsigned char)(fe >> 16);
      opos += lit ? (fe >> 24) & 3 : 0;
      // a literal step is <= 12 bits: at most one word to advance
      const bool adv = lit && on >= 32;
      w0 = adv ? w1 : w0;
      w1 = adv ? w2 : w1;
      w2 = adv ? w3 : w2;
      wbase += adv ? 32 : 0;
      lim -= adv ? 32 : 0;
      if (adv) w3 = win[(wbase >> 5) + 3];
      o = lit ? on & 31 : o;
      fe = lit ? fen : fe;
    } while (lit);
    bp = wbase + o;
    const unsigned val = __funnelshift_r(w0, w1, o);     // 32 bits at bp
    int k, nb, eb, base;
    if (fe > 0) {                                        // a length code
      k = fe & 31;
      nb = (fe >> 5) & 31;
      eb = (fe >> 10) & 7;
      base = (fe >> 13) & 0x1FF;
    } else {
      // the slow path, one step of the plain version's loop
      if (steps >= MAX_ACTIONS) {
        err = 1;
        break;
      }
      steps++;
      const int e = probe(lt, val, LT_ROOT, 6, &nb);
      const int cls = (e >> 17) & 3;
      if (cls == CLS_LIT && e >= 0 && bp + nb <= avail
          && opos < OUT_BYTES) {
        // a literal, and the next symbol too when it is one
        ob[opos] = (unsigned char)((e >> 8) & 0xFF);
        int nb2;
        const int f = probe(lt, val >> nb, LT_ROOT, 6, &nb2);
        int used = nb;
        if (((f >> 17) & 3) == CLS_LIT && f >= 0 && bp + nb + nb2 <= avail
            && opos + 2 <= OUT_BYTES) {
          ob[opos + 1] = (unsigned char)((f >> 8) & 0xFF);
          used += nb2;
          opos++;
        }
        opos++;
        bp += used;                                      // <= 30 bits
        const bool adv = bp - wbase >= 32;
        w0 = adv ? w1 : w0;
        w1 = adv ? w2 : w1;
        w2 = adv ? w3 : w2;
        wbase += adv ? 32 : 0;
        continue;
      }
      if (e < 0 || cls == CLS_BAD || cls == CLS_LIT) {
        err = 1;
        break;
      }
      if (cls == CLS_EOB) {
        if (bp + nb > avail) err = 1;
        else bp += nb;
        break;
      }
      eb = (e >> 5) & 7;
      base = (e >> 8) & 0x1FF;
      k = nb + eb;
    }
    // a match: length code and extra bits (<= 20 of val), then the
    // distance from the 32 bits after them
    const unsigned w4 = win[(wbase >> 5) + 4];
    const int length = base + (int)((val >> nb) & ((1u << eb) - 1));
    const int o2 = o + k;                                // < 52
    const unsigned v2 = o2 < 32 ? __funnelshift_r(w0, w1, o2)
                                : __funnelshift_r(w1, w2, o2);
    int dnb, deb, dbase;
    const int de = dfast[v2 & ((1u << DFAST_BITS) - 1)];
    if (de) {
      dnb = (de >> 5) & 15;
      deb = (de >> 9) & 15;
      dbase = (de >> 13) & 0x7FFF;
    } else {
      const int e = probe(dt, v2, DT_ROOT, 9, &dnb);
      deb = (e >> 5) & 15;
      dbase = (e >> 9) & 0x7FFF;
      if (e < 0 || deb == 15) {
        err = 1;
        break;
      }
    }
    const int dist = dbase + (int)((v2 >> dnb) & ((1u << deb) - 1));
    const int bp3 = bp + k + dnb + deb;
    if (dist > opos || bp3 > avail || opos + length > OUT_BYTES) {
      err = 1;
      break;
    }
    // the record, in pack_fill_recs' layout (ops/wave_fill.py)
    const unsigned tiny = length <= 4 && dist >= 4;
    const unsigned shrt = length <= 8 && dist >= 8 && !tiny;
    const unsigned fld = tiny ? (unsigned)(length >= 4)
                              : (unsigned)(length - 3) & 0x7FFFu;
    recs[nm++] = make_int2(
        (int)((unsigned)opos | (tiny << 15) | (fld << 16) | (shrt << 31)),
        opos - dist);
    opos += length;
    bp = bp3;
    // a match is <= 48 bits: up to two words to advance
    const int sh = (bp - wbase) >> 5;
    w0 = sh == 0 ? w0 : (sh == 1 ? w1 : w2);
    w1 = sh == 0 ? w1 : (sh == 1 ? w2 : w3);
    w2 = sh == 0 ? w2 : (sh == 1 ? w3 : w4);
    wbase += sh << 5;
  }
  if (opos < OUT_BYTES) ob[opos] = 0;                  // see the literal loop
  *bp_io = bp;
  *opos_out = opos;
  *nm_out = nm;
  return err;
}

__global__ void __launch_bounds__(THREADS, 2)
inflate_kernel(const unsigned* __restrict__ words,
               const int* __restrict__ start_w, const int* __restrict__ bit0,
               const int* __restrict__ avail_a,
               const int* __restrict__ statics, int* __restrict__ out,
               int* __restrict__ status, int2* recs_all, int nw) {
  extern __shared__ int4 smem[];
  unsigned char* ob = reinterpret_cast<unsigned char*>(smem);
  unsigned short* ptr = reinterpret_cast<unsigned short*>(ob + fill::ND);
  unsigned* win = reinterpret_cast<unsigned*>(ptr);
  int* fast = reinterpret_cast<int*>(win + IN_W);
  int* dfast = fast + (1 << FAST_BITS);
  int* tabs = reinterpret_cast<int*>(ob + fill::ND + fill::PTR_BYTES);
  int* cl_tab = tabs + TAB_SLOT;
  int* lens = cl_tab + CL_SIZE;
  int* cnt = lens + LENS_W;
  int* offs = cnt + 16;
  int* work = offs + 16;
  int* st = tabs + TABLE_INTS;                         // S_* words
  int* sub = dfast + (1 << DFAST_BITS);                // table scratch
  int2* longs = reinterpret_cast<int2*>(tabs);
  const int b = blockIdx.x;
  const int start = start_w[b];
  const int avail = avail_a[b];
  int2* recs = recs_all + (int64_t)b * fill::NM;

  int4* ob4 = smem;
  for (int i = threadIdx.x; i < OUT_W / 4; i += blockDim.x)
    ob4[i] = make_int4(0, 0, 0, 0);
  for (int i = threadIdx.x; i < IN_W; i += blockDim.x)
    win[i] = start + i < nw ? words[start + i] : 0u;
  for (int i = threadIdx.x; i < TAB_SLOT; i += blockDim.x)
    tabs[i] = statics[i];
  __syncthreads();
  if (threadIdx.x == 0) {
    st[S_OPOS] = 0;
    st[S_NM] = 0;
    st[S_MODE] = parse_head(win, bit0[b], avail, statics, lens, st);
  }
  __syncthreads();
  if (st[S_MODE] == M_DYN) {
    // a dynamic block: the CL table, the code lengths, then the litlen
    // and dist tables, each table built by the whole CTA
    const bool bad = build_table(lens, 19, 7, cl_tab, CL_SIZE, true, nullptr,
                                 INVALID, cnt, offs, work, sub, st + S_FLAG);
    if (threadIdx.x == 0)
      st[S_MODE] = bad ? M_DONE : read_lengths(win, avail, cl_tab, lens, st);
    __syncthreads();
    if (st[S_MODE] == M_DYN) {
      const int nlit = st[S_NLIT], ndist = st[S_NDIST];
      bool bad2 = build_table(lens, nlit, LT_ROOT, tabs, LT_SIZE, false,
                              statics + TAB_SLOT + C_LITPAY, INVALID, cnt,
                              offs, work, sub, st + S_FLAG);
      if (!bad2)
        bad2 = build_table(lens + nlit, ndist, DT_ROOT, tabs + LT_SIZE,
                           DT_SIZE, false, statics + TAB_SLOT + C_DISTPAY,
                           D_INVALID, cnt, offs, work, sub, st + S_FLAG);
      if (threadIdx.x == 0) {
        st[S_MODE] = bad2 ? M_DONE : M_HUFF;
        st[S_ERR] = bad2;
      }
      __syncthreads();
    }
  }
  const int mode = st[S_MODE];
  if (mode == M_STORED) {
    const unsigned char* in = reinterpret_cast<const unsigned char*>(win)
                              + st[S_SRC];
    for (int i = threadIdx.x; i < st[S_SLEN]; i += blockDim.x) ob[i] = in[i];
    if (threadIdx.x == 0) st[S_OPOS] = st[S_SLEN];
  } else if (mode == M_HUFF) {
    build_fast(tabs, fast, dfast);
    __syncthreads();
    if (threadIdx.x == 0) {
      int bp = st[S_BP], opos, nm;
      st[S_ERR] = symbol_loop(win, tabs, fast, dfast, avail, ob, recs, &bp,
                              &opos, &nm);
      st[S_BP] = bp;
      st[S_OPOS] = opos;
      st[S_NM] = nm;
    }
  }
  __syncthreads();
  const int produced = st[S_OPOS], err = st[S_ERR], end = st[S_BP],
            nm = st[S_NM];
  fill::fill_row(ob, ptr, longs, recs, nm, out + (int64_t)b * OUT_W);
  if (threadIdx.x == 0) {
    status[3 * b + 0] = produced;
    status[3 * b + 1] = err;
    status[3 * b + 2] = end;
  }
}

}  // namespace

// recs: int32 scratch [B, 2 * NM] (8-byte aligned), allocated by the
// wrapper.
extern "C" int dt_inflate_blocks(const void* words, const void* start_w,
                                 const void* bit0, const void* avail,
                                 const void* statics, void* out,
                                 void* status, void* recs, int nw, int B,
                                 void* stream) {
  cudaError_t e = cudaFuncSetAttribute(
      inflate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e != cudaSuccess) return (int)e;
  inflate_kernel<<<B, THREADS, SMEM, (cudaStream_t)stream>>>(
      (const unsigned*)words, (const int*)start_w, (const int*)bit0,
      (const int*)avail, (const int*)statics, (int*)out, (int*)status,
      (int2*)recs, nw);
  return (int)cudaGetLastError();
}
