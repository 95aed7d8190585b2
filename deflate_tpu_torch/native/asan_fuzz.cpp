// ASan/UBSan fuzz driver for the native host library (inflate.cpp,
// deflate.cpp).
//
// Copy of deflate_tpu/native/asan_fuzz.cpp, extended to every entry
// point that this package's host paths call on untrusted bytes: besides
// dt_inflate (and dt_deflate's round trips), dt_inflate2 (gzip members),
// dt_parse_headers (the wavefront decoder's header walk, at offsets
// that may lie anywhere), dt_skeleton (the foreign-stream walk) and
// dt_skeleton_par (the same walk in pieces on threads, held to
// dt_skeleton's result).
// Each is fed three adversarial corpora and must return a clean result
// or a negative error code, never a sanitizer report (built with
// -fno-sanitize-recover=all, a finding aborts the process, which the
// caller sees as a nonzero exit):
//   1. pure random garbage (uniform bytes)
//   2. valid-stream prefixes (truncations at every granularity)
//   3. valid streams with single-byte corruptions
// Built and run by deflate_tpu_torch.native.build_asan_fuzz's caller:
//   g++ -O1 -g -std=c++17 -fsanitize=address,undefined
//       -fno-sanitize-recover=all -pthread asan_fuzz.cpp inflate.cpp
//       deflate.cpp
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

extern "C" {
int dt_inflate(const uint8_t* in, size_t in_len, uint8_t* out,
               size_t out_cap, size_t* out_len);
int dt_inflate2(const uint8_t* in, size_t in_len, uint8_t* out,
                size_t out_cap, size_t* out_len, size_t* consumed);
int dt_deflate(const uint8_t* in, size_t in_len, int level, uint8_t* out,
               size_t out_cap, size_t* out_len);
int dt_parse_headers(const uint8_t* in, size_t in_len,
                     const int64_t* bit_offsets, int64_t nblocks,
                     int64_t* btype, int64_t* data_start,
                     int64_t* stored_len, uint8_t* err, int32_t* hlit_out,
                     int32_t* hdist_out, uint8_t* lens_out);
int dt_skeleton(const uint8_t* in, size_t in_len, int64_t max_vb,
                int64_t hint_stride, int64_t* vb_meta, uint8_t* hints,
                int64_t* n_vb_out, int64_t* total_out);
int dt_skeleton_par(const uint8_t* in, size_t in_len, int64_t max_vb,
                    int64_t hint_stride, int64_t* vb_meta, uint8_t* hints,
                    int64_t* n_vb_out, int64_t* total_out, int64_t threads,
                    int64_t piece_bytes, int64_t* stats);
}

static uint64_t rng_state = 0x9E3779B97F4A7C15ull;
static uint32_t xr() {
  rng_state ^= rng_state << 13;
  rng_state ^= rng_state >> 7;
  rng_state ^= rng_state << 17;
  return (uint32_t)(rng_state >> 32);
}

static int fail(const char* what, int rc) {
  std::fprintf(stderr, "%s: bad rc %d\n", what, rc);
  return 2;
}

static bool rc_ok(int rc) { return rc <= 0 && rc >= -5; }

// dt_inflate2: clean rc, and on success the consumed count lies in the
// input and the output matches dt_inflate's
static int check_inflate2(const uint8_t* in, size_t n, std::vector<uint8_t>& out) {
  size_t out_len = 0, consumed = 0;
  int rc = dt_inflate2(in, n, out.data(), out.size(), &out_len, &consumed);
  if (!rc_ok(rc)) return fail("dt_inflate2", rc);
  if (rc == 0 && consumed > n) {
    std::fprintf(stderr, "dt_inflate2 consumed %zu of %zu\n", consumed, n);
    return 2;
  }
  return 0;
}

// dt_parse_headers at offsets anywhere (inside, at and past the end,
// negative, extreme): every one must come back parsed or flagged
static int check_headers(const uint8_t* in, size_t n) {
  const int64_t nb = 24;
  std::vector<int64_t> offs(nb), btype(nb), dstart(nb), slen(nb);
  std::vector<uint8_t> err(nb), lens(nb * 320);
  std::vector<int32_t> hlit(nb), hdist(nb);
  const int64_t nbits = 8 * (int64_t)n;
  for (int64_t b = 0; b < nb; ++b) {
    switch (b) {
      case 0: offs[b] = 0; break;
      case 1: offs[b] = nbits; break;
      case 2: offs[b] = nbits - 1; break;
      case 3: offs[b] = nbits + 64; break;
      case 4: offs[b] = -1; break;
      case 5: offs[b] = INT64_MAX; break;
      case 6: offs[b] = INT64_MIN; break;
      case 7: offs[b] = INT64_MAX - 2; break;
      default: offs[b] = (int64_t)(xr() % (uint32_t)(nbits + 16));
    }
  }
  int rc = dt_parse_headers(in, n, offs.data(), nb, btype.data(),
                            dstart.data(), slen.data(), err.data(),
                            hlit.data(), hdist.data(), lens.data());
  if (!rc_ok(rc)) return fail("dt_parse_headers", rc);
  for (int64_t b = 0; b < nb; ++b) {
    if (!err[b] && (btype[b] < 0 || btype[b] > 2 || dstart[b] < 0 ||
                    dstart[b] > nbits)) {
      std::fprintf(stderr, "dt_parse_headers: block %lld at %lld parsed "
                   "to btype %lld, data_start %lld\n", (long long)b,
                   (long long)offs[b], (long long)btype[b],
                   (long long)dstart[b]);
      return 2;
    }
  }
  return 0;
}

// dt_skeleton with a small and a roomy table (the small one exercises
// its table-full return); dt_skeleton_par in small pieces on 2-4 threads
// with the same tables must return the same code and, on success, the
// same plan
static int check_skeleton(const uint8_t* in, size_t n) {
  const int64_t stride = 4224;
  for (int64_t max_vb : {(int64_t)2, (int64_t)64}) {
    std::vector<int64_t> meta(max_vb * 8);
    std::vector<uint8_t> hints(max_vb * stride);
    int64_t nvb = 0, total = 0;
    int rc = dt_skeleton(in, n, max_vb, stride, meta.data(), hints.data(),
                         &nvb, &total);
    if (!rc_ok(rc)) return fail("dt_skeleton", rc);
    if (rc == 0 && (nvb < 0 || nvb > max_vb || total < 0)) {
      std::fprintf(stderr, "dt_skeleton: %lld vbs, %lld bytes\n",
                   (long long)nvb, (long long)total);
      return 2;
    }
    int64_t threads = 2 + xr() % 3;
    const int64_t pieces[] = {16, 64, 257, 1024};
    int64_t piece = pieces[xr() % 4];
    std::vector<int64_t> pmeta(max_vb * 8);
    std::vector<uint8_t> phints(max_vb * stride);
    int64_t pnvb = 0, ptotal = 0, stats[3];
    int prc = dt_skeleton_par(in, n, max_vb, stride, pmeta.data(),
                              phints.data(), &pnvb, &ptotal, threads, piece,
                              stats);
    if (prc != rc || (rc == 0 && (pnvb != nvb || ptotal != total ||
                                  std::memcmp(pmeta.data(), meta.data(),
                                              8 * 8 * nvb) ||
                                  std::memcmp(phints.data(), hints.data(),
                                              stride * nvb)))) {
      std::fprintf(stderr, "dt_skeleton_par (%lld threads, %lld-byte "
                   "pieces) rc %d, %lld vbs; dt_skeleton rc %d, %lld vbs\n",
                   (long long)threads, (long long)piece, prc,
                   (long long)pnvb, rc, (long long)nvb);
      return 2;
    }
  }
  return 0;
}

static int check_all(const uint8_t* in, size_t n, std::vector<uint8_t>& out) {
  int r = check_inflate2(in, n, out);
  if (!r) r = check_headers(in, n);
  if (!r) r = check_skeleton(in, n);
  return r;
}

int main() {
  std::vector<uint8_t> out(1 << 20);
  size_t out_len = 0;
  int ok = 0, err = 0, r = 0;

  // 1. random garbage, varied sizes (incl. 0 and 1)
  for (int it = 0; it < 1500; ++it) {
    size_t n = it < 8 ? (size_t)it : (xr() % 4096);
    std::vector<uint8_t> buf(n ? n : 1);
    for (size_t i = 0; i < n; ++i) buf[i] = (uint8_t)xr();
    int rc = dt_inflate(buf.data(), n, out.data(), out.size(), &out_len);
    rc == 0 ? ++ok : ++err;
    if (!rc_ok(rc)) return fail("dt_inflate", rc);
    if ((r = check_all(buf.data(), n, out))) return r;
  }

  // 2/3. valid streams (made by the native encoder), truncated + corrupted
  for (int it = 0; it < 120; ++it) {
    size_t n = 64 + xr() % 60000;
    std::vector<uint8_t> src(n);
    // compressible-ish: small alphabet with runs
    for (size_t i = 0; i < n; ++i)
      src[i] = (uint8_t)((xr() % 7) * 37 + ((i >> 5) & 3));
    std::vector<uint8_t> enc(n + n / 2 + 1024);
    size_t enc_len = 0;
    int lvl = (int)(xr() % 4);
    int rc = dt_deflate(src.data(), n, lvl, enc.data(), enc.size(),
                        &enc_len);
    if (rc != 0) {
      std::fprintf(stderr, "deflate rc %d\n", rc);
      return 3;
    }
    rc = dt_inflate(enc.data(), enc_len, out.data(), out.size(), &out_len);
    if (rc != 0 || out_len != n || std::memcmp(out.data(), src.data(), n)) {
      std::fprintf(stderr, "round trip failed rc=%d\n", rc);
      return 4;
    }
    if ((r = check_all(enc.data(), enc_len, out))) return r;
    // truncations: every cut must error or produce a strict prefix; each
    // cut is a copy of its own, so reads past it are caught
    for (int t = 0; t < 16; ++t) {
      size_t cut = xr() % enc_len;
      std::vector<uint8_t> pre(enc.begin(), enc.begin() + cut);
      rc = dt_inflate(pre.data(), cut, out.data(), out.size(), &out_len);
      if (rc == 0 && (out_len > n || std::memcmp(out.data(), src.data(),
                                                 out_len) != 0)) {
        std::fprintf(stderr, "truncation returned non-prefix\n");
        return 5;
      }
      if (t < 4 && (r = check_all(pre.data(), cut, out))) return r;
    }
    // single-byte corruptions
    for (int t = 0; t < 16; ++t) {
      std::vector<uint8_t> bad(enc.begin(), enc.begin() + enc_len);
      bad[xr() % enc_len] ^= (uint8_t)(1 + xr() % 255);
      (void)dt_inflate(bad.data(), enc_len, out.data(), out.size(),
                       &out_len);
      if (t < 4 && (r = check_all(bad.data(), enc_len, out))) return r;
    }
  }
  std::printf("asan_fuzz ok=%d err=%d\n", ok, err);
  return 0;
}
