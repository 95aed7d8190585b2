// Host-side native INFLATE — the CPU fast path of the deflate_tpu_torch
// runtime, copied from deflate_tpu/native/inflate.cpp, so that the port
// builds it on its own (deflate_tpu_torch/native/__init__.py, g++ at
// first use).  The port's copy adds dt_skeleton_par, the skeleton walk in
// pieces on threads, and walks a block at a time in dt_skeleton for it.
//
// Reference analog: class inflate (inflate.hpp:26-409 of the reference
// library), whose hot loop probes a pointer-chasing trie once per input BIT
// (SURVEY.md quirk Q7).  This implementation is a from-scratch table-driven
// decoder: a 64-bit bit buffer and two-level canonical lookup tables
// (10-bit root), so a symbol decodes in one or two loads.  It is the host
// decoder of decompress(device=None) and, through dt_skeleton, the walk
// that plans a foreign stream's device decode.
//
// Exported C ABI (ctypes):
//   int dt_inflate(const uint8_t* in, size_t in_len,
//                  uint8_t* out, size_t out_cap, size_t* out_len);
//     returns 0 ok, negative error codes otherwise (see DT_E_*)
//   uint32_t dt_adler32(const uint8_t* p, size_t n);
//   void dt_stitch(...)  -- bit-level segment concatenation
//   int dt_skeleton(...), dt_skeleton_par(...)  -- the skeleton walk

#include <algorithm>
#include <atomic>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>

extern "C" {

enum {
  DT_OK = 0,
  DT_E_INPUT = -1,      // truncated / malformed stream
  DT_E_OUTPUT = -2,     // output capacity exceeded
  DT_E_CODE = -3,       // invalid Huffman code or code lengths
  DT_E_DIST = -4,       // distance past window / output start
  DT_E_BTYPE = -5,      // reserved block type 3
};

}  // extern "C"

namespace {

constexpr int kRootBits = 10;
constexpr int kMaxCodeLen = 15;

// Table entry: [sym:16][len:8][flags:8]; flag 1 = subtable pointer, where
// sym = subtable base index and len = extra index bits.
struct Entry {
  uint16_t sym;
  uint8_t len;
  uint8_t sub;
};

struct BitReader {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t buf = 0;
  int n = 0;  // valid bits in buf

  void refill() {
    while (n <= 56 && p < end) {
      buf |= uint64_t(*p++) << n;
      n += 8;
    }
  }
  // peek k bits (k <= 57 after refill); missing bits read as zero
  uint32_t peek(int k) const { return uint32_t(buf & ((1ull << k) - 1)); }
  void drop(int k) {
    buf >>= k;
    n -= k;
  }
  bool have(int k) {
    if (n < k) refill();
    return n >= k;
  }
  void align() {
    int k = n & 7;
    drop(k);
  }
  // absolute byte position consumed so far
  size_t bytes_consumed(const uint8_t* start) const {
    return size_t(p - start) - size_t(n >> 3);
  }
};

// Build a two-level decode table from code lengths.
// table must hold (1<<kRootBits) + 2048 entries (subtable worst case).
// Returns table size used, or -1 on oversubscription.
int build_table(const uint8_t* lens, int nsym, Entry* table, bool allow_empty) {
  int count[kMaxCodeLen + 1] = {0};
  for (int s = 0; s < nsym; s++) count[lens[s]]++;
  count[0] = 0;
  int total = 0;
  for (int l = 1; l <= kMaxCodeLen; l++) total += count[l];
  if (total == 0) {
    if (!allow_empty) return -1;
    for (int i = 0; i < (1 << kRootBits); i++) table[i] = {0, 0, 0};
    return 1 << kRootBits;
  }
  // Kraft check (oversubscription is fatal; incomplete codes allowed —
  // unused table slots get len 0 and decode as errors)
  long kraft = 0;
  for (int l = 1; l <= kMaxCodeLen; l++)
    kraft += long(count[l]) << (kMaxCodeLen - l);
  if (kraft > (1L << kMaxCodeLen)) return -1;

  // symbols sorted by (len, sym)
  int offs[kMaxCodeLen + 2] = {0};
  for (int l = 1; l <= kMaxCodeLen; l++) offs[l + 1] = offs[l] + count[l];
  uint16_t sorted[320];
  {
    int o[kMaxCodeLen + 1];
    memcpy(o, offs, sizeof(o));
    for (int s = 0; s < nsym; s++)
      if (lens[s]) sorted[o[lens[s]]++] = uint16_t(s);
  }

  for (int i = 0; i < (1 << kRootBits); i++) table[i] = {0, 0, 0};
  int next_sub = 1 << kRootBits;

  uint32_t code = 0;  // canonical code, MSB-first
  int si = 0;
  int sub_base = -1, sub_prefix = -1, sub_bits = 0;
  for (int l = 1; l <= kMaxCodeLen; l++) {
    for (int c = 0; c < count[l]; c++, si++, code++) {
      uint16_t sym = sorted[si];
      // bit-reverse the l-bit code for LSB-first indexing
      uint32_t rev = 0;
      for (int b = 0; b < l; b++) rev |= ((code >> b) & 1u) << (l - 1 - b);
      if (l <= kRootBits) {
        for (uint32_t i = rev; i < (1u << kRootBits); i += (1u << l))
          table[i] = {sym, uint8_t(l), 0};
      } else {
        uint32_t prefix = rev & ((1u << kRootBits) - 1);
        if (int(prefix) != sub_prefix) {
          // longest code sharing this prefix determines subtable size
          sub_prefix = int(prefix);
          // compute remaining max length for this prefix: scan ahead is
          // costly; use kMaxCodeLen - kRootBits (5 bits, 32 entries) flat
          sub_bits = kMaxCodeLen - kRootBits;
          sub_base = next_sub;
          next_sub += 1 << sub_bits;
          for (int i = 0; i < (1 << sub_bits); i++)
            table[sub_base + i] = {0, 0, 0};
          table[prefix] = {uint16_t(sub_base), uint8_t(sub_bits), 1};
        }
        uint32_t hi = rev >> kRootBits;  // remaining l - kRootBits bits
        for (uint32_t i = hi; i < (1u << sub_bits); i += (1u << (l - kRootBits)))
          table[sub_base + i] = {sym, uint8_t(l - kRootBits), 0};
      }
    }
    code <<= 1;
  }
  return next_sub;
}

const uint16_t kLenBase[29] = {3,  4,  5,  6,  7,  8,  9,  10, 11,  13,
                               15, 17, 19, 23, 27, 31, 35, 43, 51,  59,
                               67, 83, 99, 115, 131, 163, 195, 227, 258};
const uint8_t kLenExtra[29] = {0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2,
                               2, 3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 5, 5, 0};
const uint16_t kDistBase[30] = {1,    2,    3,    4,    5,    7,    9,   13,
                                17,   25,   33,   49,   65,   97,   129, 193,
                                257,  385,  513,  769,  1025, 1537, 2049,
                                3073, 4097, 6145, 8193, 12289, 16385, 24577};
const uint8_t kDistExtra[30] = {0, 0, 0,  0,  1,  1,  2,  2,  3,  3,
                                4, 4, 5,  5,  6,  6,  7,  7,  8,  8,
                                9, 9, 10, 10, 11, 11, 12, 12, 13, 13};
const uint8_t kClOrder[19] = {16, 17, 18, 0, 8, 7, 9, 6, 10, 5,
                              11, 4, 12, 3, 13, 2, 14, 1, 15};

constexpr int kTableSize = (1 << kRootBits) + 320 * 32;  // root + worst-case subtables

struct Tables {
  Entry lit[kTableSize];
  Entry dist[kTableSize];
};

// decode one symbol; returns -1 on error (bad code OR truncated input).
// Missing bits peek as zeros, but the replicated-root/subtable layout means
// the selected entry is determined by the low `len` bits only — so checking
// br.n >= consumed-bits before dropping rejects any symbol that would have
// used phantom zero bits (truncated streams error instead of zero-filling).
inline int decode_sym(BitReader& br, const Entry* tbl) {
  br.refill();
  Entry e = tbl[br.peek(kRootBits)];
  if (e.sub) {
    uint32_t idx = (br.peek(kRootBits + e.len) >> kRootBits);
    int root = kRootBits;
    e = tbl[e.sym + idx];
    if (!e.len) return -1;
    if (br.n < root + e.len) return -1;
    br.drop(root + e.len);
    return e.sym;
  }
  if (!e.len) return -1;
  if (br.n < e.len) return -1;
  br.drop(e.len);
  return e.sym;
}

int fixed_tables(Tables& t) {
  uint8_t ll[288], dl[30];
  for (int i = 0; i < 144; i++) ll[i] = 8;
  for (int i = 144; i < 256; i++) ll[i] = 9;
  for (int i = 256; i < 280; i++) ll[i] = 7;
  for (int i = 280; i < 288; i++) ll[i] = 8;
  for (int i = 0; i < 30; i++) dl[i] = 5;
  if (build_table(ll, 288, t.lit, false) < 0) return -1;
  if (build_table(dl, 30, t.dist, false) < 0) return -1;
  return 0;
}

int dynamic_tables(BitReader& br, Tables& t) {
  if (!br.have(14)) return DT_E_INPUT;
  int hlit = int(br.peek(5)) + 257;
  br.drop(5);
  int hdist = int(br.peek(5)) + 1;
  br.drop(5);
  int hclen = int(br.peek(4)) + 4;
  br.drop(4);
  if (hlit > 286 || hdist > 30) return DT_E_CODE;

  uint8_t cl_lens[19] = {0};
  for (int i = 0; i < hclen; i++) {
    if (!br.have(3)) return DT_E_INPUT;
    cl_lens[kClOrder[i]] = uint8_t(br.peek(3));
    br.drop(3);
  }
  Entry cl_tbl[kTableSize];
  if (build_table(cl_lens, 19, cl_tbl, false) < 0) return DT_E_CODE;

  uint8_t lens[320] = {0};
  int i = 0;
  while (i < hlit + hdist) {
    if (!br.have(7 + 7)) br.refill();
    int s = decode_sym(br, cl_tbl);
    if (s < 0) return DT_E_CODE;
    if (s < 16) {
      lens[i++] = uint8_t(s);
    } else if (s == 16) {
      if (i == 0) return DT_E_CODE;
      if (!br.have(2)) return DT_E_INPUT;
      int rep = 3 + int(br.peek(2));
      br.drop(2);
      if (i + rep > hlit + hdist) return DT_E_CODE;
      for (int r = 0; r < rep; r++, i++) lens[i] = lens[i - 1];
    } else if (s == 17) {
      if (!br.have(3)) return DT_E_INPUT;
      int rep = 3 + int(br.peek(3));
      br.drop(3);
      if (i + rep > hlit + hdist) return DT_E_CODE;
      i += rep;
    } else {
      if (!br.have(7)) return DT_E_INPUT;
      int rep = 11 + int(br.peek(7));
      br.drop(7);
      if (i + rep > hlit + hdist) return DT_E_CODE;
      i += rep;
    }
  }
  if (lens[256] == 0) return DT_E_CODE;
  if (build_table(lens, hlit, t.lit, false) < 0) return DT_E_CODE;
  if (build_table(lens + hlit, hdist, t.dist, true) < 0) return DT_E_CODE;
  return DT_OK;
}

}  // namespace

extern "C" {

uint32_t dt_adler32(const uint8_t* p, size_t n) {
  uint32_t s1 = 1, s2 = 0;
  while (n > 0) {
    size_t chunk = n > 5552 ? 5552 : n;  // max before 32-bit overflow
    for (size_t i = 0; i < chunk; i++) {
      s1 += p[i];
      s2 += s1;
    }
    s1 %= 65521;
    s2 %= 65521;
    p += chunk;
    n -= chunk;
  }
  return (s2 << 16) | s1;
}

int dt_inflate2(const uint8_t* in, size_t in_len, uint8_t* out,
                size_t out_cap, size_t* out_len, size_t* in_consumed) {
  BitReader br{in, in + in_len};
  size_t op = 0;
  static thread_local Tables tbl;

  for (;;) {
    if (!br.have(3)) return DT_E_INPUT;
    int bfinal = int(br.peek(1));
    br.drop(1);
    int btype = int(br.peek(2));
    br.drop(2);

    if (btype == 0) {
      br.align();
      if (!br.have(32)) return DT_E_INPUT;
      uint32_t len = br.peek(16);
      br.drop(16);
      uint32_t nlen = br.peek(16);
      br.drop(16);
      if ((len ^ nlen) != 0xFFFF) return DT_E_INPUT;
      if (op + len > out_cap) return DT_E_OUTPUT;
      // copy: drain bit buffer first (it holds whole bytes after align)
      uint32_t rem = len;
      while (rem && br.n >= 8) {
        out[op++] = uint8_t(br.peek(8));
        br.drop(8);
        rem--;
      }
      if (rem) {
        if (size_t(br.end - br.p) < rem) return DT_E_INPUT;
        memcpy(out + op, br.p, rem);
        br.p += rem;
        op += rem;
      }
    } else if (btype == 3) {
      return DT_E_BTYPE;
    } else {
      if (btype == 1) {
        if (fixed_tables(tbl) < 0) return DT_E_CODE;
      } else {
        int rc = dynamic_tables(br, tbl);
        if (rc != DT_OK) return rc;
      }
      for (;;) {
        if (br.n == 0 && br.p == br.end) return DT_E_INPUT;
        int s = decode_sym(br, tbl.lit);
        if (s < 0) return DT_E_CODE;
        if (s < 256) {
          if (op >= out_cap) return DT_E_OUTPUT;
          out[op++] = uint8_t(s);
        } else if (s == 256) {
          break;
        } else {
          if (s > 285) return DT_E_CODE;
          int li = s - 257;
          if (!br.have(kLenExtra[li])) return DT_E_INPUT;
          uint32_t length = kLenBase[li] + br.peek(kLenExtra[li]);
          br.drop(kLenExtra[li]);
          int d = decode_sym(br, tbl.dist);
          if (d < 0 || d > 29) return DT_E_CODE;
          if (!br.have(kDistExtra[d])) return DT_E_INPUT;
          uint32_t dist = kDistBase[d] + br.peek(kDistExtra[d]);
          br.drop(kDistExtra[d]);
          if (dist > op) return DT_E_DIST;
          if (op + length > out_cap) return DT_E_OUTPUT;
          const uint8_t* src = out + op - dist;
          if (dist >= length) {
            memcpy(out + op, src, length);
            op += length;
          } else {
            for (uint32_t j = 0; j < length; j++) out[op + j] = src[j];
            op += length;
          }
        }
      }
    }
    if (bfinal) {
      *out_len = op;
      // bytes consumed, counting a partially-read final byte as consumed
      // (the position where e.g. a gzip trailer or next member begins)
      if (in_consumed) *in_consumed = br.bytes_consumed(in);
      return DT_OK;
    }
  }
}

int dt_inflate(const uint8_t* in, size_t in_len, uint8_t* out, size_t out_cap,
               size_t* out_len) {
  return dt_inflate2(in, in_len, out, out_cap, out_len, nullptr);
}

// Batched block-header parse for the wavefront decoder's host prep
// (ops/wave.py parse_headers_host).  For each block whose BFINAL bit
// sits at bit_offsets[b], walks the header only (the sequential part:
// CL-code decode + repeat expansion, inflate.hpp:136-224 territory) and
// records the raw code lengths; the batch canonical-metadata math stays
// vectorized numpy on the Python side.
//
// Outputs, all length nblocks unless noted:
//   btype, data_start (absolute bit of first symbol / stored payload),
//   stored_len, err (parse failure), hlit, hdist,
//   lens [nblocks * 320] code lengths (litlen then dist, zero padded).
int dt_parse_headers(const uint8_t* in, size_t in_len,
                     const int64_t* bit_offsets, int64_t nblocks,
                     int64_t* btype, int64_t* data_start,
                     int64_t* stored_len, uint8_t* err,
                     int32_t* hlit_out, int32_t* hdist_out,
                     uint8_t* lens_out) {
  for (int64_t b = 0; b < nblocks; b++) {
    btype[b] = 0;
    data_start[b] = 0;
    stored_len[b] = 0;
    err[b] = 0;
    hlit_out[b] = 0;
    hdist_out[b] = 0;
    uint8_t* lens = lens_out + b * 320;
    memset(lens, 0, 320);

    int64_t off = bit_offsets[b];
    if (off < 0 || off > 8 * int64_t(in_len) - 3) {  // no overflow at INT64_MAX
      err[b] = 1;
      continue;
    }
    BitReader br{in + (off >> 3), in + in_len};
    br.refill();
    br.drop(int(off & 7));
    int64_t base_bit = off & ~int64_t(7);  // br consumed counts from here
    auto bitpos = [&]() {
      return base_bit + 8 * int64_t(br.p - (in + (off >> 3))) - br.n;
    };
    br.drop(1);  // BFINAL
    int bt = int(br.peek(2));
    br.drop(2);
    btype[b] = bt;
    if (bt == 3) {
      err[b] = 1;
      continue;
    }
    if (bt == 0) {
      br.align();
      if (!br.have(32)) {
        err[b] = 1;
        continue;
      }
      uint32_t len = br.peek(16);
      br.drop(16);
      uint32_t nlen = br.peek(16);
      br.drop(16);
      int64_t payload = bitpos();
      if ((len ^ nlen) != 0xFFFF ||
          size_t(payload + 8 * int64_t(len)) > 8 * in_len)
        err[b] = 1;
      stored_len[b] = len;
      data_start[b] = payload;
      continue;
    }
    if (bt == 1) {
      data_start[b] = bitpos();
      continue;  // fixed code lengths are implied; Python fills them
    }
    // dynamic header
    if (!br.have(14)) {
      err[b] = 1;
      continue;
    }
    int hlit = int(br.peek(5)) + 257;
    br.drop(5);
    int hdist = int(br.peek(5)) + 1;
    br.drop(5);
    int hclen = int(br.peek(4)) + 4;
    br.drop(4);
    uint8_t cl_lens[19] = {0};
    bool bad = false;
    for (int i = 0; i < hclen; i++) {
      if (!br.have(3)) {
        bad = true;
        break;
      }
      cl_lens[kClOrder[i]] = uint8_t(br.peek(3));
      br.drop(3);
    }
    static thread_local Entry cl_tbl[kTableSize];
    if (bad || build_table(cl_lens, 19, cl_tbl, false) < 0) {
      err[b] = 1;
      continue;
    }
    int i = 0;
    while (i < hlit + hdist) {
      int s = decode_sym(br, cl_tbl);
      if (s < 0) {
        bad = true;
        break;
      }
      if (s < 16) {
        lens[i++] = uint8_t(s);
      } else if (s == 16) {
        if (i == 0 || !br.have(2)) {
          bad = true;
          break;
        }
        int rep = 3 + int(br.peek(2));
        br.drop(2);
        if (i + rep > hlit + hdist) {
          bad = true;
          break;
        }
        for (int r = 0; r < rep; r++, i++) lens[i] = lens[i - 1];
      } else if (s == 17) {
        if (!br.have(3)) {
          bad = true;
          break;
        }
        int rep = 3 + int(br.peek(3));
        br.drop(3);
        if (i + rep > hlit + hdist) {
          bad = true;
          break;
        }
        i += rep;
      } else {
        if (!br.have(7)) {
          bad = true;
          break;
        }
        int rep = 11 + int(br.peek(7));
        br.drop(7);
        if (i + rep > hlit + hdist) {
          bad = true;
          break;
        }
        i += rep;
      }
    }
    if (bad || i != hlit + hdist || lens[256] == 0) {
      err[b] = 1;
      memset(lens, 0, 320);
      continue;
    }
    hlit_out[b] = hlit;
    hdist_out[b] = hdist;
    data_start[b] = bitpos();
  }
  return DT_OK;
}

// Bit-level concatenation of segments into a contiguous stream.
// seg_words: concatenated u32 word data; seg_offsets[i] = word offset of
// segment i; seg_bits[i] = bit length of segment i.  out must be zeroed,
// sized (sum(bits)+63)/32 words.
void dt_stitch(const uint32_t* seg_words, const uint64_t* seg_offsets,
               const uint64_t* seg_bits, size_t nseg, uint32_t* out) {
  uint64_t off = 0;
  for (size_t s = 0; s < nseg; s++) {
    const uint32_t* w = seg_words + seg_offsets[s];
    uint64_t nb = seg_bits[s];
    if (!nb) continue;
    uint64_t nwords = (nb + 31) / 32;
    uint64_t base = off >> 5;
    uint32_t sh = uint32_t(off & 31);
    if (sh == 0) {
      for (uint64_t i = 0; i < nwords; i++) out[base + i] |= w[i];
    } else {
      for (uint64_t i = 0; i < nwords; i++) {
        out[base + i] |= w[i] << sh;
        out[base + i + 1] |= w[i] >> (32 - sh);
      }
    }
    off += nb;
  }
}

}  // extern "C"

namespace {

// ====================== skeleton walk ======================================
// Decodes symbol LENGTHS only (no output materialization) of a raw DEFLATE
// stream, cutting it into VIRTUAL BLOCKS of <= 32768 output bytes at
// symbol boundaries and recording per virtual block the per-64-bit-chunk
// symbol entry phases ("decode hints").  This is what lets FOREIGN
// conforming streams (zlib/gzip/libdeflate output — reference analog
// inflate.hpp:277-322) ride the vectorized device decode path: virtual
// blocks all decode in parallel on the card; only this walk and the match
// fill are sequential.
//
// Every parent block starts a fresh virtual block, and a virtual block's
// row depends only on its parent block's bits: out_start is a prefix sum
// and the stream-wide distance check needs only each row's reach.  So a
// walk from any true block header gives, from there on, the rows the walk
// from bit 0 gives.  dt_skeleton walks from bit 0; dt_skeleton_par walks
// pieces of the stream on threads from headers it searches for, then
// stitches them in stream order (Rapidgzip's block finder and speculative
// decode, without a window to carry).

// Where a walk puts its virtual blocks.  TableSink writes the caller's
// table and checks each distance against the absolute output at once.
struct TableSink {
  static constexpr bool kAbsolute = true;
  int64_t* meta;
  uint8_t* hints;
  int64_t stride, max_vb;
  int64_t nvb = 0, out_abs = 0;

  // the next row's hints, all 0xFF; nullptr when the table is full
  uint8_t* open() {
    if (nvb >= max_vb) return nullptr;
    uint8_t* h = hints + nvb * stride;
    memset(h, 0xFF, size_t(stride));
    return h;
  }
  bool push(int64_t parent, int64_t start, int64_t out_len, int64_t flags,
            int64_t span, int64_t btype, int64_t /*reach*/) {
    if (nvb >= max_vb) return false;
    int64_t* m = meta + nvb * 8;
    m[0] = parent;
    m[1] = start;
    m[2] = out_len;
    m[3] = flags;
    m[4] = span;
    m[5] = out_abs;
    m[6] = btype;
    m[7] = 0;
    out_abs += out_len;
    nvb++;
    return true;
  }
};

// Hint bytes a row can have written: symbols start before its span's end,
// and a cut row's stop mark sits at the span itself.
inline int64_t hints_used(int64_t span, int64_t stride) {
  int64_t u = (span >> 6) + 1;
  return u < stride ? u : stride;
}

struct PieceVb {
  int64_t m[8];   // the row, m[5] the piece-local output offset
  int64_t reach;  // largest dist - (row output before the match), or 0
  int64_t hoff;   // the row's hints in PieceSink::hb
};

// A piece's rows with piece-local output offsets, each row's hints only as
// far as its span reaches, and each row's reach, which the stitch checks
// against the row's absolute offset.
struct PieceSink {
  static constexpr bool kAbsolute = false;
  int64_t stride = 0;
  std::vector<PieceVb> vbs;
  std::vector<uint8_t> hb;
  int64_t hend = 0, out_abs = 0;

  uint8_t* open() {
    if (int64_t(hb.size()) < hend + stride) hb.resize(size_t(2 * (hend + stride)));
    uint8_t* h = hb.data() + hend;
    memset(h, 0xFF, size_t(stride));
    return h;
  }
  bool push(int64_t parent, int64_t start, int64_t out_len, int64_t flags,
            int64_t span, int64_t btype, int64_t reach) {
    vbs.push_back({{parent, start, out_len, flags, span, out_abs, btype, 0},
                   reach, hend});
    hend += hints_used(span, stride);
    out_abs += out_len;
    return true;
  }
  struct Mark {
    size_t nvb;
    int64_t hend, out_abs;
  };
  Mark mark() const { return {vbs.size(), hend, out_abs}; }
  void rollback(const Mark& k) {
    vbs.resize(k.nvb);
    hend = k.hend;
    out_abs = k.out_abs;
  }
};

constexpr int DT_FAR = -100;  // internal: a piece's walk passed its limit

inline int64_t bitpos_of(const BitReader& br, const uint8_t* in) {
  return 8 * int64_t(br.p - in) - br.n;
}

// A reader positioned at bit `at` (< 8 * in_len) of the stream.
inline BitReader reader_at(const uint8_t* in, size_t in_len, int64_t at) {
  BitReader br{in + (at >> 3), in + in_len};
  br.refill();
  br.drop(int(at & 7));
  return br;
}

// Walks the parent block whose BFINAL bit is the reader's next bit into
// sk.  Returns DT_OK, a stream error, DT_E_OUTPUT (sk full or the hint
// window exceeded) or DT_FAR (a symbol starts past bit `far`).
template <class Sink>
int walk_block(BitReader& br, const uint8_t* in, size_t in_len, Tables& tbl,
               Sink& sk, int64_t hint_stride, int64_t far, bool* bfinal_out) {
  const int64_t span_cap = 64 * hint_stride - 64;
  auto bitpos = [&]() { return bitpos_of(br, in); };

  if (!br.have(3)) return DT_E_INPUT;
  int64_t parent = bitpos();
  *bfinal_out = br.peek(1) != 0;
  br.drop(1);
  int btype = int(br.peek(2));
  br.drop(2);

  if (btype == 3) return DT_E_BTYPE;
  if (btype == 0) {
    br.align();
    if (!br.have(32)) return DT_E_INPUT;
    uint32_t len = br.peek(16);
    br.drop(16);
    uint32_t nlen = br.peek(16);
    br.drop(16);
    if ((len ^ nlen) != 0xFFFF) return DT_E_INPUT;
    int64_t payload = bitpos();
    if (size_t(payload + 8 * int64_t(len)) > 8 * in_len) return DT_E_INPUT;
    uint32_t c = 0;
    do {  // len == 0 emits one empty vb so the stream stays indexed
      uint32_t take = len - c > 32768 ? 32768 : len - c;
      if (!sk.open() || !sk.push(parent, payload + 8 * int64_t(c), take,
                                 1 | 2, 8 * int64_t(take), 0, 0))
        return DT_E_OUTPUT;
      c += take;
    } while (c < len);
    // advance the reader past the payload (buffer holds whole bytes)
    uint32_t rem = len;
    while (rem && br.n >= 8) {
      br.drop(8);
      rem--;
    }
    br.p += rem;
    return DT_OK;
  }
  if (btype == 1) {
    if (fixed_tables(tbl) < 0) return DT_E_CODE;
  } else {
    int rc = dynamic_tables(br, tbl);
    if (rc != DT_OK) return rc;
  }
  int64_t vb_start = bitpos();
  int64_t vb_out = 0;
  int64_t vb_flags = 0;
  int64_t vb_reach = 0;
  uint8_t* h = sk.open();
  if (!h) return DT_E_OUTPUT;
  for (;;) {
    if (br.n == 0 && br.p == br.end) return DT_E_INPUT;
    int64_t sym_bit = bitpos();
    if (sym_bit > far) return DT_FAR;
    int s = decode_sym(br, tbl.lit);
    if (s < 0) return DT_E_CODE;
    int64_t emit, length = 0, dist = 0;
    if (s < 256) {
      emit = 1;
    } else if (s == 256) {
      emit = 0;
    } else {
      if (s > 285) return DT_E_CODE;
      int li = s - 257;
      if (!br.have(kLenExtra[li])) return DT_E_INPUT;
      length = kLenBase[li] + br.peek(kLenExtra[li]);
      br.drop(kLenExtra[li]);
      int d = decode_sym(br, tbl.dist);
      if (d < 0 || d > 29) return DT_E_CODE;
      if (!br.have(kDistExtra[d])) return DT_E_INPUT;
      dist = kDistBase[d] + br.peek(kDistExtra[d]);
      br.drop(kDistExtra[d]);
      emit = length;
    }
    if (s != 256 &&
        (vb_out + emit > 32768 || sym_bit - vb_start >= span_cap)) {
      // cut BEFORE this symbol: close the vb with a synthetic stop.
      // The stop position itself gets a hint entry — the wavefront
      // chain validation checks every chunk's carry-in against the
      // hints, and the stop mark is part of the old vb's chain.
      int64_t srel = sym_bit - vb_start;
      if (h[srel >> 6] == 0xFF) h[srel >> 6] = uint8_t(srel & 63);
      if (!sk.push(parent, vb_start, vb_out, vb_flags, srel, btype,
                   vb_reach))
        return DT_E_OUTPUT;
      h = sk.open();
      if (!h) return DT_E_OUTPUT;
      vb_start = sym_bit;
      vb_out = 0;
      vb_flags = 0;
      vb_reach = 0;
    }
    int64_t rel = sym_bit - vb_start;
    int64_t w = rel >> 6;
    if (w >= hint_stride) return DT_E_OUTPUT;
    if (h[w] == 0xFF) h[w] = uint8_t(rel & 63);
    if (s == 256)
      return sk.push(parent, vb_start, vb_out, vb_flags | 2,
                     bitpos() - vb_start, btype, vb_reach)
                 ? DT_OK
                 : DT_E_OUTPUT;
    if (s > 256) {
      if constexpr (Sink::kAbsolute) {
        if (dist > sk.out_abs + vb_out) return DT_E_DIST;
      } else if (dist - vb_out > vb_reach) {
        vb_reach = dist - vb_out;
      }
      if (dist > vb_out) vb_flags |= 4;  // reaches previous vb output
    }
    vb_out += emit;
  }
}

// ---- header search -------------------------------------------------------

static_assert(__BYTE_ORDER__ == __ORDER_LITTLE_ENDIAN__,
              "bits_at loads little-endian words");

// The stream's bits from bit b on, at least 57 of them (zeros past the end).
inline uint64_t bits_at(const uint8_t* in, size_t in_len, int64_t b) {
  size_t k = size_t(b >> 3);
  uint64_t w = 0;
  if (k + 8 <= in_len) {
    memcpy(&w, in + k, 8);
  } else {
    for (size_t j = 0; k + j < in_len; j++) w |= uint64_t(in[k + j]) << (8 * j);
  }
  return w >> (b & 7);
}

// Whether a dynamic-Huffman header with BFINAL 0 starts at bit b and reads
// as one the walk would accept: HLIT <= 286, HDIST <= 30, code lengths
// that decode to exactly HLIT + HDIST entries, a length for symbol 256,
// tables that build.  Stricter than the walk: the precode and the
// literal/length code must be complete, as encoders write them, which
// rejects nearly every false position.  A true header this misses costs
// only time: the stitch walks its block in order.
bool dynamic_candidate(const uint8_t* in, size_t in_len, int64_t b) {
  const int64_t nbits = 8 * int64_t(in_len);
  uint64_t w = bits_at(in, in_len, b);
  if ((w & 7) != 4) return false;  // BFINAL 0, BTYPE 2
  int hlit = int((w >> 3) & 31) + 257;
  int hdist = int((w >> 8) & 31) + 1;
  int hclen = int((w >> 13) & 15) + 4;
  if (hlit > 286 || hdist > 30) return false;
  int64_t pos = b + 17 + 3 * hclen;
  if (pos > nbits) return false;
  uint64_t v = bits_at(in, in_len, b + 17);  // 3 x 19 = 57 bits
  uint8_t cl[19] = {0};
  int kraft = 0;
  for (int i = 0; i < hclen; i++) {
    int l = int((v >> (3 * i)) & 7);
    cl[kClOrder[i]] = uint8_t(l);
    if (l && (kraft += 128 >> l) > 128) return false;
  }
  if (kraft != 128) return false;
  // complete 7-bit precode: every index decodes
  int count[8] = {0}, next[8] = {0};
  for (int s = 0; s < 19; s++) count[cl[s]]++;
  count[0] = 0;
  for (int l = 1, code = 0; l <= 7; l++) {
    code = (code + count[l - 1]) << 1;
    next[l] = code;
  }
  uint8_t tsym[128], tlen[128];
  for (int s = 0; s < 19; s++) {
    int l = cl[s];
    if (!l) continue;
    int code = next[l]++, rev = 0;
    for (int k = 0; k < l; k++) rev |= ((code >> k) & 1) << (l - 1 - k);
    for (int i = rev; i < 128; i += 1 << l) {
      tsym[i] = uint8_t(s);
      tlen[i] = uint8_t(l);
    }
  }
  uint8_t lens[320];
  const int n = hlit + hdist;
  for (int i = 0; i < n;) {
    uint64_t x = bits_at(in, in_len, pos);
    int s = tsym[x & 127], l = tlen[x & 127];
    if (s < 16) {
      lens[i++] = uint8_t(s);
    } else {
      int rep;
      uint8_t fill = 0;
      if (s == 16) {
        if (i == 0) return false;
        rep = 3 + int((x >> l) & 3);
        l += 2;
        fill = lens[i - 1];
      } else if (s == 17) {
        rep = 3 + int((x >> l) & 7);
        l += 3;
      } else {
        rep = 11 + int((x >> l) & 127);
        l += 7;
      }
      if (i + rep > n) return false;
      memset(lens + i, fill, size_t(rep));
      i += rep;
    }
    pos += l;
    if (pos > nbits) return false;
  }
  if (lens[256] == 0) return false;
  long lk = 0, dk = 0;
  for (int i = 0; i < hlit; i++)
    if (lens[i]) lk += 1L << (kMaxCodeLen - lens[i]);
  for (int i = hlit; i < n; i++)
    if (lens[i]) dk += 1L << (kMaxCodeLen - lens[i]);
  return lk == (1L << kMaxCodeLen) && dk <= (1L << kMaxCodeLen);
}

// Whether a stored header with BFINAL 0 starts at the byte-aligned bit b:
// LEN and NLEN complements, the payload inside the stream.
bool stored_candidate(const uint8_t* in, size_t in_len, int64_t b) {
  size_t k = size_t(b >> 3);
  if ((b & 7) || k + 5 > in_len || (in[k] & 7)) return false;
  uint32_t len = in[k + 1] | uint32_t(in[k + 2]) << 8;
  uint32_t nlen = in[k + 3] | uint32_t(in[k + 4]) << 8;
  return (len ^ nlen) == 0xFFFF && k + 5 + len <= in_len;
}

// The first bit in [from, to) where a block header may start, or -1.
int64_t find_header(const uint8_t* in, size_t in_len, int64_t from,
                    int64_t to) {
  const int64_t nbits = 8 * int64_t(in_len);
  if (to > nbits) to = nbits;
  for (int64_t k = from >> 3; 8 * k < to; k++) {
    if (8 * k >= from && stored_candidate(in, in_len, 8 * k)) return 8 * k;
    // bit j of m: BFINAL 0 and BTYPE 2 at bit 8k + j
    uint64_t w = bits_at(in, in_len, 8 * k);
    uint64_t m = ~w & ~(w >> 1) & (w >> 2) & 0xFF;
    for (; m; m &= m - 1) {
      int64_t b = 8 * k + __builtin_ctzll(m);
      if (b >= from && b < to && dynamic_candidate(in, in_len, b)) return b;
    }
  }
  return -1;
}

// ---- pieces and stitch ---------------------------------------------------

struct Piece {
  int64_t lo = 0, hi = 0;   // search [lo, hi); stop at a header >= hi
  int64_t far = 0;          // give up on a symbol past this bit
  int64_t end = -1;         // the header after the last whole block
  bool final = false;       // the last whole block was the final one
  std::vector<int64_t> starts;    // header bit of each whole block
  std::vector<size_t> first_vb;   // its first row in sk
  PieceSink sk;
};

// Walks whole blocks from the header at bit `at` into p until a header at
// or past p.hi, the final block, an error or p.far; keeps the whole blocks.
// Returns DT_OK at a clean stop, else what ended the walk.
int walk_piece(const uint8_t* in, size_t in_len, int64_t at, Piece& p,
               Tables& tbl) {
  p.starts.clear();
  p.first_vb.clear();
  p.sk.rollback({0, 0, 0});
  p.final = false;
  BitReader br = reader_at(in, in_len, at);
  for (;;) {
    int64_t h = bitpos_of(br, in);
    p.end = h;
    if (h >= p.hi) return DT_OK;
    if (h > p.far) return DT_FAR;
    PieceSink::Mark k = p.sk.mark();
    bool bfinal = false;
    int rc = walk_block(br, in, in_len, tbl, p.sk, p.sk.stride, p.far,
                        &bfinal);
    if (rc != DT_OK) {
      p.sk.rollback(k);
      return rc;
    }
    p.starts.push_back(h);
    p.first_vb.push_back(k.nvb);
    if (bfinal) {
      p.final = true;
      p.end = bitpos_of(br, in);
      return DT_OK;
    }
  }
}

constexpr int kTries = 8;  // candidates a piece walks from before giving up

// Piece 0 walks from bit 0.  Any other piece walks from the first
// candidate header in its range, and from the next one after a walk that
// fails, up to kTries times: a false candidate mostly fails within a block.
void run_piece(const uint8_t* in, size_t in_len, Piece& p, bool search,
               Tables& tbl) {
  if (!search) {
    walk_piece(in, in_len, p.lo, p, tbl);
    return;
  }
  int64_t from = p.lo;
  for (int t = 0; t < kTries; t++) {
    int64_t c = find_header(in, in_len, from, p.hi);
    if (c < 0) return;
    int rc = walk_piece(in, in_len, c, p, tbl);
    if (rc == DT_OK || rc == DT_FAR) return;
    from = c + 1;
  }
}

// Appends sk's rows from v0 on to the caller's table at their absolute
// output offsets; false if the table is full or a row reaches back past
// the stream's start (the sequential walk's DT_E_DIST).
bool append_rows(TableSink& o, const PieceSink& sk, size_t v0) {
  for (size_t v = v0; v < sk.vbs.size(); v++) {
    const PieceVb& x = sk.vbs[v];
    if (o.nvb >= o.max_vb || x.reach > o.out_abs) return false;
    int64_t* m = o.meta + o.nvb * 8;
    memcpy(m, x.m, sizeof(x.m));
    m[5] = o.out_abs;
    uint8_t* h = o.hints + o.nvb * o.stride;
    int64_t used = hints_used(x.m[4], o.stride);
    memcpy(h, sk.hb.data() + x.hoff, size_t(used));
    memset(h + used, 0xFF, size_t(o.stride - used));
    o.out_abs += x.m[2];
    o.nvb++;
  }
  return true;
}

// Walks the pieces on up to `threads` threads, then stitches them in
// stream order into the caller's table.  A piece is taken only from a
// block start that the verified walk (piece 0, then what was stitched)
// reached; between such starts the stitch walks blocks in order itself.
// Returns DT_OK with the plan written, else nonzero: the caller then
// runs the sequential walk, whose result stands.
int skeleton_pieces(const uint8_t* in, size_t in_len, int64_t np,
                    int64_t piece_bytes, int64_t threads, TableSink& o,
                    int64_t* stats) {
  std::vector<Piece> pieces(static_cast<size_t>(np));
  const int64_t slack = 8 * std::max<int64_t>(piece_bytes, 1 << 17);
  for (int64_t i = 0; i < np; i++) {
    Piece& p = pieces[size_t(i)];
    p.lo = 8 * i * piece_bytes;
    p.hi = i + 1 < np ? 8 * (i + 1) * piece_bytes : INT64_MAX;
    p.far = i + 1 < np ? p.hi + slack : INT64_MAX;
    p.sk.stride = o.stride;
  }
  std::atomic<int64_t> next{0};
  std::atomic<bool> failed{false};
  auto work = [&]() {
    try {
      std::unique_ptr<Tables> tbl(new Tables);
      for (int64_t i; (i = next.fetch_add(1)) < np;)
        run_piece(in, in_len, pieces[size_t(i)], i > 0, *tbl);
    } catch (...) {
      failed = true;
    }
  };
  std::vector<std::thread> pool;
  int64_t nt = std::min<int64_t>(std::min<int64_t>(threads, np), 256);
  for (int64_t t = 1; t < nt; t++) {
    try {
      pool.emplace_back(work);
    } catch (...) {
      break;  // fewer threads: the rest of the pieces go to those there
    }
  }
  work();
  for (std::thread& t : pool) t.join();
  if (failed) return DT_E_INPUT;

  std::unique_ptr<Tables> tbl(new Tables);
  PieceSink rw;
  rw.stride = o.stride;
  int64_t pos = 0, taken = 0, rewalked = 0;
  bool final = false;
  for (int64_t i = 0; i < np && !final; i++) {
    const Piece& p = pieces[size_t(i)];
    while (!final && pos < p.hi) {
      auto it = std::lower_bound(p.starts.begin(), p.starts.end(), pos);
      if (it != p.starts.end() && *it == pos) {
        size_t k = size_t(it - p.starts.begin());
        taken += i > 0 && k == 0;
        if (!append_rows(o, p.sk, p.first_vb[k])) return DT_E_OUTPUT;
        pos = p.end;
        final = p.final;
        continue;
      }
      rw.rollback({0, 0, 0});
      BitReader br = reader_at(in, in_len, pos);
      bool bfinal = false;
      int rc = walk_block(br, in, in_len, *tbl, rw, o.stride, INT64_MAX,
                          &bfinal);
      if (rc != DT_OK || !append_rows(o, rw, 0)) return rc ? rc : DT_E_OUTPUT;
      rewalked++;
      pos = bitpos_of(br, in);
      final = bfinal;
    }
  }
  stats[0] = np - 1;
  stats[1] = taken;
  stats[2] = rewalked;
  return final ? DT_OK : DT_E_INPUT;
}

}  // namespace

extern "C" {

// Skeleton walk for the wavefront decoder (ops/wave.py), from bit 0 on one
// thread.
//
// vb_meta layout per virtual block (8 int64s):
//   [0] parent header bit offset (the block's BFINAL bit)
//   [1] vb first-symbol bit, absolute (stored payload bit for btype 0)
//   [2] out_len (<= 32768)
//   [3] flags: 1 = stored | 2 = chain ends naturally (EOB inside vb)
//              | 4 = needs history (a match reaches before the vb start)
//   [4] span bits: vb start .. one past the last symbol.  For cut vbs
//       the synthetic stop position; for EOB vbs includes the EOB code.
//   [5] out_start: absolute output byte offset of the vb
//   [6] btype of the parent block
//   [7] reserved (0)
// hints: hint_stride bytes per vb; 0xFF = no symbol starts in the chunk.
//
// Returns DT_OK; DT_E_OUTPUT when max_vb or the hint window would be
// exceeded (caller retries bigger or falls back to the host decoder);
// else the stream error code.
int dt_skeleton(const uint8_t* in, size_t in_len, int64_t max_vb,
                int64_t hint_stride, int64_t* vb_meta, uint8_t* hints,
                int64_t* n_vb_out, int64_t* total_out) {
  BitReader br{in, in + in_len};
  static thread_local Tables tbl;
  TableSink sk{vb_meta, hints, hint_stride, max_vb};
  for (;;) {
    bool bfinal = false;
    int rc = walk_block(br, in, in_len, tbl, sk, hint_stride, INT64_MAX,
                        &bfinal);
    if (rc != DT_OK) return rc;
    if (bfinal) {
      *n_vb_out = sk.nvb;
      *total_out = sk.out_abs;
      return DT_OK;
    }
  }
}

// dt_skeleton's plan, byte for byte, walked in pieces of piece_bytes
// compressed bytes on up to `threads` threads.  With fewer than two
// pieces, or when the pieces' stitch meets an error, a full table or a
// failed allocation, it returns dt_skeleton's own result (so malformed
// streams fail with its code).  stats[0..2]: pieces walked from a
// searched header, those taken from that header, blocks the stitch
// walked again in order (all 0 when dt_skeleton alone ran).
int dt_skeleton_par(const uint8_t* in, size_t in_len, int64_t max_vb,
                    int64_t hint_stride, int64_t* vb_meta, uint8_t* hints,
                    int64_t* n_vb_out, int64_t* total_out, int64_t threads,
                    int64_t piece_bytes, int64_t* stats) {
  stats[0] = stats[1] = stats[2] = 0;
  int64_t np = piece_bytes > 0
                   ? (int64_t(in_len) + piece_bytes - 1) / piece_bytes
                   : 1;
  if (np >= 2 && threads >= 1) {
    int rc;
    try {
      TableSink o{vb_meta, hints, hint_stride, max_vb};
      rc = skeleton_pieces(in, in_len, np, piece_bytes, threads, o, stats);
      if (rc == DT_OK) {
        *n_vb_out = o.nvb;
        *total_out = o.out_abs;
        return DT_OK;
      }
    } catch (...) {
    }
    stats[0] = stats[1] = stats[2] = 0;
  }
  return dt_skeleton(in, in_len, max_vb, hint_stride, vb_meta, hints,
                     n_vb_out, total_out);
}

// Export this translation unit's RFC 1951 constants so the test suite can
// cross-check them against utils/tables.py and deflate.cpp's copies
// (three-way duplication drift guard, VERDICT r1/r2 leftover).
void dt_rfc_tables_inflate(int32_t* len_base, int32_t* len_extra,
                           int32_t* dist_base, int32_t* dist_extra,
                           int32_t* cl_order) {
  for (int i = 0; i < 29; i++) {
    len_base[i] = kLenBase[i];
    len_extra[i] = kLenExtra[i];
  }
  for (int i = 0; i < 30; i++) {
    dist_base[i] = kDistBase[i];
    dist_extra[i] = kDistExtra[i];
  }
  for (int i = 0; i < 19; i++) cl_order[i] = kClOrder[i];
}

}  // extern "C"
