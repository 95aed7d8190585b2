// Kernel K3: stable monotone routing as one direct scatter.
//
// Replaces deflate_tpu/ops/wave_route.py::_mk_kernel (wrapper
// route_pallas), which kept a block's payloads in VMEM and moved them by
// up to 16 log-shift rounds of rolls and selects.  Plain version:
// deflate_tpu_torch/ops/wave.py::route_monotone_left / _right.
//
// What bounds it here: memory.  Per slot it reads delta and P payloads
// and writes P payloads + dout once: (2P + 2) x 4 bytes per slot, a few
// tens of MB per decode bucket, i.e. tens of microseconds at HBM speed,
// against 2 x rounds full passes for the round form.  Design: one thread
// per slot; an occupied slot (0 <= delta < 2^rounds) writes its payloads
// to i - delta (left) or i + delta (right) when that slot is in range,
// and marks dout there 0.  The wrapper pre-fills payloads with 0 and dout
// with -1.  Monotone routes have distinct destinations, so no two threads
// write one slot.  Reads are coalesced; writes are coalesced wherever
// neighbouring slots share a displacement, which is the common case.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__global__ void route_kernel(const int* __restrict__ pays,
                             const int* __restrict__ delta,
                             int* __restrict__ out, int* __restrict__ dout,
                             int P, int B, int L, int rounds, int left) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int b = blockIdx.y;
  if (i >= L) return;
  const int64_t row = (int64_t)b * L;
  const int d = delta[row + i];
  if (d < 0 || (rounds < 31 && (d >> rounds) != 0)) return;
  const int j = left ? i - d : i + d;
  if (j < 0 || j >= L) return;
  for (int p = 0; p < P; ++p) {
    const int64_t base = ((int64_t)p * B + b) * L;
    out[base + j] = pays[base + i];
  }
  dout[row + j] = 0;
}

}  // namespace

extern "C" int dt_route(const void* pays, const void* delta, void* out,
                        void* dout, int P, int B, int L, int rounds,
                        int left, void* stream) {
  dim3 grid((L + THREADS - 1) / THREADS, B);
  route_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)pays, (const int*)delta, (int*)out, (int*)dout, P, B, L,
      rounds, left);
  return (int)cudaGetLastError();
}
