// Kernel K5: ordered LZ77 match fill with a 32 KiB cross-block history.
//
// Replaces deflate_tpu/ops/wave_fill.py::_kernel_seq (wrapper
// fill_matches_hist), which ran the virtual blocks of a foreign-stream
// plan in grid order on the TPU scalar core and slid an SMEM window
// [last 32 KiB of output | current block] left by each block's output
// size.  Plain version: deflate_tpu_torch/ops/wave_fill.py::
// fill_matches_hist_plain.
//
// Contract.  Rows are virtual blocks in stream order: litwords [B, 8192]
// int32 (literal bytes placed), recs [B, 2*NM] raw interleaved records
// (r0 = opos | len3 << 16, r1 = dist; len3 is 16 bits), nmatch [B],
// sizes [B] output bytes per row.  A record copies len3 + 3 bytes to
// row position opos from `dist` bytes back in the stream's output, which
// may lie in any earlier row (rows can be a few bytes long, so the
// history spans many rows).  Before the first output byte the history
// reads as zeros; a distance reaching before the 32 KiB window is
// clamped to its first byte, as the reference's max(p - dist, 0) is;
// bytes past a row's 32 KiB are dropped.  Out row b is valid up to
// sizes[b] bytes.
//
// Design.  Nothing carries between CTAs on this card, so ONE thread
// block runs all rows in order.  Its 64 KiB of dynamic shared memory is
// a byte ring: the current row occupies [base, base + 32 KiB) and the
// history the 32 KiB before it (mod 64 KiB), so no byte is ever moved to
// slide the window — base advances by sizes[g], which need not be a
// multiple of 4.  Per row: all 1024 threads place the literal row into
// the ring, warp 0 walks the records (32 at a time by one coalesced
// load, broadcast by shuffle; per record the lanes write 32 bytes per
// step by out[p + k] = out[src + k % d], whose sources all precede p, so
// a record's bytes do not depend on each other; records are ordered by
// __syncwarp), then all threads copy the row out.
//
// What bounds it here: the serial chain of records across the whole
// stream (a few thousand per row, one warp, shared-memory latency per
// record), not bandwidth: 64 KiB per row plus 8 B per record is a few
// microseconds of HBM time for the whole plan.  Overlapping the
// prefix of independent rows, or splitting the walk by history
// dependency, is later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ND = 32768;        // output bytes per row
constexpr int OW = ND / 4;       // output words per row
constexpr int NM = 11264;        // record slots per row
constexpr int RING = 2 * ND;     // history + current row, bytes
constexpr unsigned MASK = RING - 1;
constexpr int THREADS = 1024;

__global__ void fill_hist_kernel(const int* __restrict__ lit,
                                 const int* __restrict__ recs,
                                 const int* __restrict__ nmatch,
                                 const int* __restrict__ sizes,
                                 int* __restrict__ out, int B) {
  extern __shared__ int ring_words[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(ring_words);
  for (int i = threadIdx.x; i < RING / 4; i += blockDim.x) ring_words[i] = 0;
  unsigned base = 0;               // ring position of the row's byte 0
  __syncthreads();

  for (int g = 0; g < B; ++g) {
    const int* lg = lit + (int64_t)g * OW;
    for (int i = threadIdx.x; i < OW; i += blockDim.x) {
      const unsigned w = (unsigned)lg[i];
      const unsigned p = base + 4u * i;
      ring[p & MASK] = (unsigned char)w;
      ring[(p + 1) & MASK] = (unsigned char)(w >> 8);
      ring[(p + 2) & MASK] = (unsigned char)(w >> 16);
      ring[(p + 3) & MASK] = (unsigned char)(w >> 24);
    }
    __syncthreads();

    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      int nm = nmatch[g];
      nm = nm < 0 ? 0 : (nm > NM ? NM : nm);
      const int* rb = recs + (int64_t)g * 2 * NM;
      for (int b0 = 0; b0 < nm; b0 += 32) {
        const int m = b0 + lane;
        const int r0l = m < nm ? rb[2 * m] : 0;
        const int r1l = m < nm ? rb[2 * m + 1] : 0;
        const int cnt = nm - b0 < 32 ? nm - b0 : 32;
        for (int j = 0; j < cnt; ++j) {
          const unsigned r0 = (unsigned)__shfl_sync(0xffffffffu, r0l, j);
          const int dist = __shfl_sync(0xffffffffu, r1l, j);
          const int opos = (int)(r0 & 0xFFFFu);
          const int rem = (int)((r0 >> 16) & 0xFFFFu) + 3;
          // window coordinates: byte ND is the row's first byte
          const int p = ND + opos;
          const int src = p - dist > 0 ? p - dist : 0;
          const int d = p - src;
          const int n = rem < ND - opos ? rem : ND - opos;
          if (d > 0 && n > 0) {
            const unsigned wdst = base + (unsigned)opos;
            const unsigned wsrc = base - (unsigned)ND + (unsigned)src;
            for (int k = lane; k < n; k += 32)
              ring[(wdst + k) & MASK] = ring[(wsrc + (k < d ? k : k % d))
                                             & MASK];
          }
          __syncwarp();
        }
      }
    }
    __syncthreads();

    int* og = out + (int64_t)g * OW;
    for (int i = threadIdx.x; i < OW; i += blockDim.x) {
      const unsigned p = base + 4u * i;
      og[i] = (int)((unsigned)ring[p & MASK]
                    | ((unsigned)ring[(p + 1) & MASK] << 8)
                    | ((unsigned)ring[(p + 2) & MASK] << 16)
                    | ((unsigned)ring[(p + 3) & MASK] << 24));
    }
    int s = sizes[g];
    s = s < 0 ? 0 : (s > ND ? ND : s);
    base = (base + (unsigned)s) & MASK;
    __syncthreads();
  }
}

}  // namespace

extern "C" int dt_fill_matches_hist(const void* lit, const void* recs,
                                    const void* nmatch, const void* sizes,
                                    void* out, int B, void* stream) {
  cudaError_t e = cudaFuncSetAttribute(
      fill_hist_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, RING);
  if (e != cudaSuccess) return (int)e;
  fill_hist_kernel<<<1, THREADS, RING, (cudaStream_t)stream>>>(
      (const int*)lit, (const int*)recs, (const int*)nmatch,
      (const int*)sizes, (int*)out, B);
  return (int)cudaGetLastError();
}
