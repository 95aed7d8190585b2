// Kernel K6: full inflate of self-contained DEFLATE blocks.
//
// Replaces deflate_tpu/ops/pallas_inflate.py::_kernel (wrappers
// _inflate_blocks_jit and inflate_blocks), which decoded K = 4 blocks per
// grid cell on the TPU scalar core, interleaving their dependent-load
// chains, with each block's 40 KiB input window DMA'd into SMEM.  Plain
// version: deflate_tpu_torch/ops/block_inflate.py::inflate_blocks_plain.
//
// Contract per block b: the window starts at stream word start_w[b]; the
// block's BFINAL bit is bit0[b] bits into it; avail[b] bits of it may be
// read.  status[b] = (produced, err, end bit relative to the window), and
// out row b holds the produced bytes (zero past them).  Where err is set
// only err is meaningful.  The reference's fourth status word
// (iterations << 1 | live) profiled its K-chain interleaving; it is not
// part of this contract and is not produced here.
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
// Design.  One CTA of 32 threads per block, many blocks per launch (the
// whole batch is resident: ~42 KB of static shared memory per CTA).
// The block's 32 KiB of output, its two-level decode tables (root 9
// litlen, root 6 dist, zlib inflate_table layout; fixed blocks read the
// fixed tables from `statics` in device memory) and the code-length
// scratch live in shared memory.  Thread 0 parses the header, builds
// the tables and runs the symbol loop; the warp zeroes the row, copies
// stored payloads, and writes the row out, coalesced.
//
// What bounds it here: the symbol loop is one dependent chain per block
// (bit peek -> table probe -> next bit position), i.e. latency of L1 /
// shared-memory loads, not bandwidth (the whole 8 MiB batch moves in a
// few microseconds of HBM time).  Parallelism comes from blocks: every
// DEFLATE block is its own CTA, so the card runs ~2 blocks per SM side by
// side.  Splitting a block's symbol chain (the wavefront decoder's
// approach) is what the hinted path does instead.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int OUT_W = 8192;
constexpr int OUT_BYTES = OUT_W * 4;
constexpr int LT_ROOT = 9;
constexpr int DT_ROOT = 6;
constexpr int LT_SIZE = 896;
constexpr int DT_SIZE = 704;
constexpr int TAB_SLOT = LT_SIZE + DT_SIZE;
constexpr int CL_SIZE = 128;
constexpr int LENS_W = 320;
constexpr int C_CL_ORDER = 0;
constexpr int C_LITPAY = 32;
constexpr int C_DISTPAY = 320;
constexpr int CLS_LIT = 0, CLS_LEN = 1, CLS_EOB = 2, CLS_BAD = 3;
constexpr int INVALID = CLS_BAD << 17;
constexpr int D_INVALID = 15 << 5;
constexpr int MAX_ACTIONS = 65536;
constexpr int THREADS = 32;
constexpr int M_DONE = 0, M_HUFF = 1, M_STORED = 3;

struct Reader {
  const unsigned* w;   // stream words (zero-padded past the stream)
  int nw;              // word count
  int start;           // window start word
};

// 64 bits at window bit bp.  Reads are clamped into the padded words;
// only a malformed header reads that far, and it is flagged anyway.
__device__ __forceinline__ unsigned long long peek64(const Reader& r,
                                                     int bp) {
  int wi = r.start + (bp >> 5);
  if (wi > r.nw - 3) wi = r.nw - 3;
  const unsigned sh = (unsigned)bp & 31u;
  const unsigned long long lo =
      (unsigned long long)__ldg(r.w + wi)
      | ((unsigned long long)__ldg(r.w + wi + 1) << 32);
  const unsigned long long hi = __ldg(r.w + wi + 2);
  return sh ? (lo >> sh) | (hi << (64 - sh)) : lo;
}

__device__ __forceinline__ int bits(const Reader& r, int bp, int n) {
  return (int)(peek64(r, bp) & ((1ull << n) - 1));
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

// zlib-style canonical table build (pallas_inflate.py build_table /
// build_table_host).  Returns 1 on any error; the table is then unused.
__device__ int build_table(const int* lens, int nsyms, int root, int* tab,
                           int cap, bool is_cl, const int* pay, int fill,
                           int* cnt, int* offs, int* work) {
  for (int l = 0; l < 16; ++l) cnt[l] = 0;
  for (int i = 0; i < nsyms; ++i) cnt[lens[i]]++;
  const int npresent = nsyms - cnt[0];
  int left = 1, maxlen = 0;
  for (int l = 1; l < 16; ++l) {
    left = 2 * left - cnt[l];
    if (cnt[l] > 0) maxlen = l;
    if (left < 0) return 1;                      // over-subscribed
  }
  if (left != 0 && npresent > 0 && (is_cl || maxlen != 1)) return 1;
  if (is_cl && npresent == 0) return 1;
  for (int i = 0; i < cap; ++i) tab[i] = fill;
  int o = 0;
  for (int l = 1; l < 16; ++l) {
    offs[l] = o;
    o += cnt[l];
  }
  for (int i = 0; i < nsyms; ++i)
    if (lens[i]) work[offs[lens[i]]++] = i;
  unsigned huff = 0;
  int cur_low = -1, cur_off = 0, cur_bits = 0, next_sub = 1 << root;
  for (int si = 0; si < npresent; ++si) {
    const int sym = work[si];
    const int l = lens[sym];
    const int p = pay ? pay[sym] : sym << 8;
    if (l <= root) {
      const int entry = p | l;
      for (int hi = 0; hi < (1 << (root - l)); ++hi)
        tab[huff + (hi << l)] = entry;
    } else {
      const int low = (int)(huff & ((1u << root) - 1));
      if (low != cur_low) {
        int curr = l - root;
        int left2 = 1 << curr;
        while (curr + root < maxlen) {
          left2 -= cnt[curr + root];       // codes not yet placed
          if (left2 <= 0) break;
          curr++;
          left2 <<= 1;
        }
        if (next_sub + (1 << curr) > cap) return 1;
        tab[low] = (int)(0x80000000u | ((unsigned)curr << 16)
                         | (unsigned)next_sub);
        cur_low = low;
        cur_off = next_sub;
        cur_bits = curr;
        next_sub += 1 << curr;
      }
      const int entry = p | (l - root);
      const int idx0 = (int)(huff >> root);
      for (int hi = 0; hi < (1 << (cur_bits - (l - root))); ++hi)
        tab[cur_off + idx0 + (hi << (l - root))] = entry;
    }
    cnt[l]--;
    unsigned incr = 1u << (l - 1);
    while (huff & incr) incr >>= 1;
    huff = incr == 0 ? 0 : (huff & (incr - 1)) + incr;
  }
  return 0;
}

// Header parse and table build.  Returns the mode; sets bp (first symbol
// bit, or past a stored payload), err, and for stored blocks the payload
// byte (window-relative) and length.
__device__ int parse_header(const Reader& rd, int bit0, int avail,
                            const int* statics, int* tabs, int* cl_tab,
                            int* lens, int* cnt, int* offs, int* work,
                            int* bp_out, int* err_out, int* src_out,
                            int* slen_out) {
  int bp = bit0 + 1;                               // past BFINAL
  const int btype = bits(rd, bp, 2);
  bp += 2;
  *err_out = 1;
  *bp_out = bp;
  if (btype == 3) return M_DONE;
  if (btype == 0) {
    bp = (bp + 7) & ~7;
    const int slen = bits(rd, bp, 16);
    const int nlen = bits(rd, bp + 16, 16);
    bp += 32;
    *bp_out = bp;
    if ((slen ^ nlen) != 0xFFFF || bp + 8 * slen > avail
        || slen > OUT_BYTES)
      return M_DONE;
    *err_out = 0;
    *bp_out = bp + 8 * slen;
    *src_out = bp >> 3;
    *slen_out = slen;
    return slen ? M_STORED : M_DONE;
  }
  if (btype == 1) {
    *err_out = 0;
    return M_HUFF;
  }
  const int nlit = bits(rd, bp, 5) + 257;
  const int ndist = bits(rd, bp + 5, 5) + 1;
  const int ncl = bits(rd, bp + 10, 4) + 4;
  bp += 14;
  *bp_out = bp;
  if (nlit > 286 || ndist > 30) return M_DONE;
  for (int t = 0; t < 19; ++t) lens[t] = 0;
  for (int t = 0; t < ncl; ++t) {
    lens[statics[TAB_SLOT + C_CL_ORDER + t]] = bits(rd, bp, 3);
    bp += 3;
  }
  if (build_table(lens, 19, 7, cl_tab, CL_SIZE, true, nullptr, INVALID,
                  cnt, offs, work))
    return M_DONE;
  const int ntot = nlit + ndist;
  int i = 0;
  while (i < ntot) {
    const int e = cl_tab[bits(rd, bp, 7)];
    if (((e >> 17) & 3) != 0 || e < 0) return M_DONE;
    bp += e & 31;
    const int sym = (e >> 8) & 0x1FF;
    if (sym < 16) {
      lens[i++] = sym;
      continue;
    }
    int cnt_rep, val = 0;
    if (sym == 16) {
      cnt_rep = 3 + bits(rd, bp, 2);
      bp += 2;
      if (i == 0) return M_DONE;
      val = lens[i - 1];
    } else if (sym == 17) {
      cnt_rep = 3 + bits(rd, bp, 3);
      bp += 3;
    } else {
      cnt_rep = 11 + bits(rd, bp, 7);
      bp += 7;
    }
    if (i + cnt_rep > ntot) return M_DONE;
    for (int t = 0; t < cnt_rep; ++t) lens[i + t] = val;
    i += cnt_rep;
  }
  *bp_out = bp;
  if (bp > avail || lens[256] == 0) return M_DONE;
  if (build_table(lens, nlit, LT_ROOT, tabs, LT_SIZE, false,
                  statics + TAB_SLOT + C_LITPAY, INVALID, cnt, offs, work))
    return M_DONE;
  if (build_table(lens + nlit, ndist, DT_ROOT, tabs + LT_SIZE, DT_SIZE,
                  false, statics + TAB_SLOT + C_DISTPAY, D_INVALID, cnt,
                  offs, work))
    return M_DONE;
  *err_out = 0;
  return M_HUFF;
}

// The symbol loop: returns err; advances *bp, *opos.
__device__ int symbol_loop(const Reader& rd, const int* lt, int avail,
                           unsigned char* ob, int* bp_io, int* opos_io) {
  const int* dt = lt + LT_SIZE;
  int bp = *bp_io, opos = 0, steps = 0, err = 0;
  for (;;) {
    if (steps >= MAX_ACTIONS) {
      err = 1;
      break;
    }
    steps++;
    const unsigned long long pk = peek64(rd, bp);
    int nb;
    const int e = probe(lt, pk, LT_ROOT, 6, &nb);
    const int cls = (e >> 17) & 3;
    const int base = (e >> 8) & 0x1FF;
    if (cls == CLS_LIT && e >= 0 && bp + nb <= avail && opos < OUT_BYTES) {
      // a literal, and the next symbol too when it is one: one step
      ob[opos] = (unsigned char)base;
      int nb2;
      const int f = probe(lt, pk >> nb, LT_ROOT, 6, &nb2);
      if (((f >> 17) & 3) == CLS_LIT && f >= 0 && bp + nb + nb2 <= avail
          && opos + 2 <= OUT_BYTES) {
        ob[opos + 1] = (unsigned char)((f >> 8) & 0x1FF);
        bp += nb2;
        opos++;
      }
      bp += nb;
      opos++;
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
    const int eb = (e >> 5) & 7;
    const int length = base + (int)((pk >> nb) & ((1u << eb) - 1));
    const int k = nb + eb;
    int dnb;
    const int de = probe(dt, pk >> k, DT_ROOT, 9, &dnb);
    const int deb = (de >> 5) & 15;
    const int dist = ((de >> 9) & 0x7FFF)
                     + (int)((pk >> (k + dnb)) & ((1ull << deb) - 1));
    const int bp3 = bp + k + dnb + deb;
    if (de < 0 || deb == 15 || dist > opos || bp3 > avail
        || opos + length > OUT_BYTES) {
      err = 1;
      break;
    }
    steps += length > 8 ? (length - 1) / 8 : 0;    // <= 8 bytes a step
    if (steps > MAX_ACTIONS) {
      err = 1;
      break;
    }
    const unsigned char* src = ob + opos - dist;
    for (int j = 0; j < length; ++j) ob[opos + j] = src[j];
    opos += length;
    bp = bp3;
  }
  *bp_io = bp;
  *opos_io = opos;
  return err;
}

__global__ void inflate_kernel(const unsigned* __restrict__ words,
                               const int* __restrict__ start_w,
                               const int* __restrict__ bit0,
                               const int* __restrict__ avail_a,
                               const int* __restrict__ statics,
                               int* __restrict__ out,
                               int* __restrict__ status, int nw) {
  __shared__ int outw[OUT_W];
  __shared__ int tabs[TAB_SLOT];
  __shared__ int cl_tab[CL_SIZE];
  __shared__ int lens[LENS_W];
  __shared__ int cnt[16], offs[16];
  __shared__ int work[288];
  __shared__ int st[6];            // mode, bp, err, src byte, slen, opos
  unsigned char* ob = reinterpret_cast<unsigned char*>(outw);
  const int b = blockIdx.x;
  const Reader rd{words, nw, start_w[b]};
  const int avail = avail_a[b];

  for (int i = threadIdx.x; i < OUT_W; i += blockDim.x) outw[i] = 0;
  if (threadIdx.x == 0) {
    int bp, err, src = 0, slen = 0;
    st[0] = parse_header(rd, bit0[b], avail, statics, tabs, cl_tab, lens,
                         cnt, offs, work, &bp, &err, &src, &slen);
    st[1] = bp;
    st[2] = err;
    st[3] = src;
    st[4] = slen;
    st[5] = 0;
  }
  __syncthreads();
  const int mode = st[0];
  if (mode == M_STORED) {
    const unsigned char* in = reinterpret_cast<const unsigned char*>(words)
                              + 4 * (int64_t)rd.start + st[3];
    for (int i = threadIdx.x; i < st[4]; i += blockDim.x) ob[i] = in[i];
    if (threadIdx.x == 0) st[5] = st[4];
  } else if (mode == M_HUFF && threadIdx.x == 0) {
    // dynamic tables in shared memory; fixed ones from statics
    const bool fixed = bits(rd, bit0[b] + 1, 2) == 1;
    int bp = st[1], opos;
    st[2] = symbol_loop(rd, fixed ? statics : tabs, avail, ob, &bp, &opos);
    st[1] = bp;
    st[5] = opos;
  }
  __syncthreads();
  int* o = out + (int64_t)b * OUT_W;
  for (int i = threadIdx.x; i < OUT_W; i += blockDim.x) o[i] = outw[i];
  if (threadIdx.x == 0) {
    status[3 * b + 0] = st[5];
    status[3 * b + 1] = st[2];
    status[3 * b + 2] = st[1];
  }
}

}  // namespace

extern "C" int dt_inflate_blocks(const void* words, const void* start_w,
                                 const void* bit0, const void* avail,
                                 const void* statics, void* out,
                                 void* status, int nw, int B,
                                 void* stream) {
  inflate_kernel<<<B, THREADS, 0, (cudaStream_t)stream>>>(
      (const unsigned*)words, (const int*)start_w, (const int*)bit0,
      (const int*)avail, (const int*)statics, (int*)out, (int*)status, nw);
  return (int)cudaGetLastError();
}
