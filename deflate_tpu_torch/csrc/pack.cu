// Kernel K7: place variable-width packets at their bit offsets in each
// block's 32-bit words.
//
// Replaces deflate_tpu/ops/pallas_pack.py::_kernel (wrapper pack_blocks).
// Plain version: deflate_tpu_torch/ops/pack.py::pack_blocks_plain.
//
// What it computes, per block b: for each of its counts[b] packets, the
// payload (lo = bits 0..31, hi = bits 32..47) shifted to bit off & 31 of
// word off >> 5 spans three words, and the block's OUTW words are the OR
// of all of them.  Packets never share a bit, so the order of the ORs
// does not matter.
//
// What bounds it here: bytes — 12 per packet in, 36 KiB per block out,
// and ~15 integer operations per packet.  The TPU kernel walked each
// block's packets one at a time on its scalar core, four blocks
// interleaved and sorted by count so their chains finish together; none
// of that carries over.  Here one CTA per block zeroes an OUTW-word
// buffer in shared memory (36 KiB), its threads stride over the packets
// (adjacent threads, adjacent packets: coalesced loads) and atomicOr the
// three words into shared memory, then the CTA writes the row out
// coalesced.  Neighbouring packets often share a word, so the shared
// atomics contend a little; lanes past counts[b] are never read.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int OUTW_MAX = 9 * 1024;
constexpr int THREADS = 512;

__global__ void pack_kernel(const int* __restrict__ counts,
                            const int* __restrict__ off,
                            const int* __restrict__ lo,
                            const int* __restrict__ hi,
                            int* __restrict__ out, int npk, int outw) {
  __shared__ unsigned int buf[OUTW_MAX];
  const int b = blockIdx.x;
  for (int i = threadIdx.x; i < outw; i += blockDim.x) buf[i] = 0u;
  __syncthreads();
  int n = counts[b];
  n = n < 0 ? 0 : (n > npk ? npk : n);
  const int64_t base = (int64_t)b * npk;
  const unsigned uw = (unsigned)outw;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const unsigned o = (unsigned)off[base + i];
    const unsigned l = (unsigned)lo[base + i];
    const unsigned h = (unsigned)hi[base + i];
    const unsigned w = o >> 5, r = o & 31u;
    const unsigned a = l << r;
    const unsigned m = r ? ((l >> (32u - r)) | (h << r)) : h;
    const unsigned c = r ? (h >> (32u - r)) : 0u;
    if (a && w < uw) atomicOr(&buf[w], a);
    if (m && w + 1u < uw) atomicOr(&buf[w + 1u], m);
    if (c && w + 2u < uw) atomicOr(&buf[w + 2u], c);
  }
  __syncthreads();
  int* row = out + (int64_t)b * outw;
  for (int i = threadIdx.x; i < outw; i += blockDim.x) row[i] = (int)buf[i];
}

}  // namespace

extern "C" int dt_pack_blocks(const void* counts, const void* off,
                              const void* lo, const void* hi, void* out,
                              int B, int npk, int outw, void* stream) {
  if (outw > OUTW_MAX || outw < 0 || npk < 0) return (int)cudaErrorInvalidValue;
  pack_kernel<<<B, THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)counts, (const int*)off, (const int*)lo, (const int*)hi,
      (int*)out, npk, outw);
  return (int)cudaGetLastError();
}
