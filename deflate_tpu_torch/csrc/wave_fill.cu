// Kernel K4: LZ77 match fill of the wavefront decoder.
//
// Replaces deflate_tpu/ops/wave_fill.py::_kernel (wrapper fill_matches),
// which copied each block's matches on the TPU scalar core, one record
// at a time, through SMEM.  Plain version: deflate_tpu_torch/ops/
// wave_fill.py::fill_matches_plain.
//
// Records (pack_fill_recs layout, see wave_fill.py) are applied in order;
// record m copies `len` bytes to opos from src = r1, dist = opos - src.
// A byte-sequential copy with overlap equals the periodic extension
// out[opos + k] = out[src + k % dist], and every source byte lies before
// opos, i.e. was final before the record started.  So the bytes of one
// record have no dependencies among themselves: a warp writes 32 of them
// per step, for every distance (dist 1, 2, 3 are periodic fills by the
// same formula), and records are ordered by a __syncwarp.
//
// What bounds it here: the chain of records per block (~2-8 thousand,
// short on average), i.e. shared-memory latency and the per-record
// overhead, not bandwidth.  Design: one thread block per DEFLATE block;
// its 32 KiB of output lives in shared memory (loaded and stored by all
// 128 threads, coalesced); warp 0 walks the records, fetching 32 records
// at a time with one coalesced load and broadcasting each by shuffle.
// Blocks run in parallel across SMs.  No p0: records address the block's
// own output only; bytes past 32 KiB are dropped, records with
// dist <= 0 are skipped.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ND = 32768;       // output bytes per block
constexpr int OW = ND / 4;      // output words per block
constexpr int NM = 11264;       // record slots per block
constexpr int THREADS = 128;

__global__ void fill_kernel(const int* __restrict__ lit,
                            const int* __restrict__ recs,
                            const int* __restrict__ nmatch,
                            int* __restrict__ out) {
  __shared__ int words[OW];
  unsigned char* buf = reinterpret_cast<unsigned char*>(words);
  const int b = blockIdx.x;
  const int* litb = lit + (int64_t)b * OW;
  for (int i = threadIdx.x; i < OW; i += blockDim.x) words[i] = litb[i];
  __syncthreads();

  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    int nm = nmatch[b];
    nm = nm < 0 ? 0 : (nm > NM ? NM : nm);
    const int* rb = recs + (int64_t)b * 2 * NM;
    for (int base = 0; base < nm; base += 32) {
      const int m = base + lane;
      const int r0l = m < nm ? rb[2 * m] : 0;
      const int r1l = m < nm ? rb[2 * m + 1] : 0;
      const int cnt = nm - base < 32 ? nm - base : 32;
      for (int j = 0; j < cnt; ++j) {
        const int r0 = __shfl_sync(0xffffffffu, r0l, j);
        const int src = __shfl_sync(0xffffffffu, r1l, j);
        const int p = r0 & 0x7FFF;
        const int fld = (r0 >> 16) & 0x7FFF;
        const int rem = ((r0 >> 15) & 1) ? 3 + (fld & 1) : fld + 3;
        const int dist = p - src;
        if (dist > 0) {
          const int n = rem < ND - p ? rem : ND - p;
          for (int k = lane; k < n; k += 32)
            buf[p + k] = buf[src + (k < dist ? k : k % dist)];
        }
        __syncwarp();
      }
    }
  }
  __syncthreads();
  int* outb = out + (int64_t)b * OW;
  for (int i = threadIdx.x; i < OW; i += blockDim.x) outb[i] = words[i];
}

}  // namespace

extern "C" int dt_fill_matches(const void* lit, const void* recs,
                               const void* nmatch, void* out, int B,
                               void* stream) {
  fill_kernel<<<B, THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)lit, (const int*)recs, (const int*)nmatch, (int*)out);
  return (int)cudaGetLastError();
}
