// Kernel K4: LZ77 match fill of the wavefront decoder.
//
// Replaces deflate_tpu/ops/wave_fill.py::_kernel (wrapper fill_matches),
// which copied each block's matches on the TPU scalar core, one record
// at a time, through SMEM.  Plain version: deflate_tpu_torch/ops/
// wave_fill.py::fill_matches_plain; the torch form of this design is
// fill_matches_jump there.
//
// Contract (fill_block.cuh): litwords [B, 8192] int32 with the literal
// bytes placed, records [B, 2*NM] in pack_fill_recs' layout, nmatch [B]
// -> out [B, 8192].  The result equals fill_matches_plain for every row
// whose records do not overlap and come in order of opos, as every
// decoder plan's do; records with dist <= 0 are skipped and bytes past
// 32 KiB dropped.
//
// What bounds it here: the chain of records is serial only by data
// dependency (every source byte precedes its target), and the first
// version, one warp walking a row's 1-3 thousand records in order, was
// latency-bound at ~190 ns a record.  Design: one CTA of 1024 threads
// per row; the row (32 KiB) and a 16-bit pointer per byte (64 KiB) live
// in shared memory, so the whole problem of a row stays on its SM;
// fill_row (fill_block.cuh) resolves the copies by pointer jumping in at
// most 16 rounds.  Device memory sees one coalesced read of the row and
// its records and one coalesced write of the output.
#include "fill_block.cuh"

namespace {

constexpr int THREADS = 1024;
constexpr int SMEM = fill::ND + fill::PTR_BYTES + fill::LONG_BYTES;

__global__ void __launch_bounds__(THREADS)
fill_kernel(const int* __restrict__ lit, const int* __restrict__ recs,
            const int* __restrict__ nmatch, int* __restrict__ out) {
  extern __shared__ int4 smem[];
  unsigned char* row = reinterpret_cast<unsigned char*>(smem);
  unsigned short* ptr = reinterpret_cast<unsigned short*>(row + fill::ND);
  int2* longs = reinterpret_cast<int2*>(row + fill::ND + fill::PTR_BYTES);
  const int b = blockIdx.x;
  const int4* l4 = reinterpret_cast<const int4*>(lit + (int64_t)b * fill::OW);
  for (int i = threadIdx.x; i < fill::OW / 4; i += blockDim.x) smem[i] = l4[i];
  const int nm = min(max(nmatch[b], 0), fill::NM);
  fill::fill_row(row, ptr, longs,
                 reinterpret_cast<const int2*>(recs + (int64_t)b * 2 * fill::NM),
                 nm, out + (int64_t)b * fill::OW);
}

}  // namespace

// lit and out 16-byte aligned, recs 8-byte aligned (the wrapper checks).
extern "C" int dt_fill_matches(const void* lit, const void* recs,
                               const void* nmatch, void* out, int B,
                               void* stream) {
  cudaError_t e = cudaFuncSetAttribute(
      fill_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e != cudaSuccess) return (int)e;
  fill_kernel<<<B, THREADS, SMEM, (cudaStream_t)stream>>>(
      (const int*)lit, (const int*)recs, (const int*)nmatch, (int*)out);
  return (int)cudaGetLastError();
}
