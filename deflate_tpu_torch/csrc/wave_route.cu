// Kernel K3: stable monotone routing, one tile of 1024 slots per CTA.
//
// Replaces deflate_tpu/ops/wave_route.py::_mk_kernel (wrapper
// route_pallas), which kept a block's payloads in VMEM and moved them by
// up to 16 log-shift rounds of rolls and selects.  Plain version:
// deflate_tpu_torch/ops/wave.py::route_monotone_left / _right.
//
// Contract: an element at slot i with 0 <= delta[i] < 2^rounds lands at
// i - delta[i] (left) or i + delta[i] (right) when that slot is in
// range; its payloads go there and dout there is 0.  Every other output
// slot holds payload 0 and dout -1.  Landed destinations strictly
// increase with i (the callers' routes are monotone).
//
// What bounds it here: memory on the device, and the host's enqueue of
// each call.  The least traffic is one read of delta and the P payloads
// and one write of the P outputs and dout, (2P + 2) x 4 bytes a slot.
// The first version scattered into outputs its wrapper had pre-filled
// with torch (stack, zeros, full, unbind: five device passes and more
// host time than the kernel took).  Here the wrapper makes one
// allocation and one C call.
//
// Design: no pre-fill, one launch pair per call.  Monotonicity makes
// ownership of the output a partition.  A first pass (one CTA per
// 1024-slot tile, 16-byte loads where the row is 16-byte aligned and L a
// multiple of 4) stores each tile's last landed destination (-1 if
// none).  In the main pass the CTA of tile t holds its deltas and
// payloads in registers (4-byte loads, neighbouring threads on
// neighbouring slots, so that the landed writes that follow are as
// coalesced as the loads) and reads its row's summaries: prev = the last
// destination of tiles before t, R = the row's last destination.  It
// clears (payload 0, dout -1)
//   A: output slots prev+1 .. its own last destination — where its own
//      elements land and no other tile's can, since destinations
//      increase;
//   B: the slots of its own index range above R.
// The A ranges of the non-empty tiles cover [0, R] and the B ranges
// (R, L), so each slot is cleared by one CTA; after a barrier that CTA
// writes its landed elements' payloads and dout 0 over its own clears.
// Clears are coalesced (16-byte stores for a whole B tile); landed
// writes are coalesced where neighbouring elements land side by side,
// as in every compaction.  A tile with nothing landing reads no
// payloads.  Landed slots are written twice (clear, then payload), by the
// same CTA.  Measured on an H100 over the level-2 decode's twelve calls
// (tools/route_split.py): this pair of kernels takes less device time than
// a single launch with one thread block cluster per row, which writes
// every slot once but runs 8 CTAs a row, and than a form that searched a
// sorted list of destinations for every owned slot.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int PER = 4;                  // slots per thread
constexpr int TILE = THREADS * PER;     // slots per CTA
constexpr int WARPS = THREADS / 32;
constexpr int MAXP = 3;

struct Args {
  const int* pay[MAXP];
  long long stride[MAXP];               // payload row strides, elements
  const int* delta;                     // [B, L] contiguous
  int* out[MAXP];                       // [B, L] contiguous
  int* dout;                            // [B, L] contiguous
  int* last;                            // [B, nt] scratch
  int P, L, nt, rounds, left;
};

__device__ __forceinline__ int dest_of(int d, int i, const Args& a) {
  if (d < 0 || (a.rounds < 31 && (d >> a.rounds) != 0)) return -1;
  const long long j = a.left ? (long long)i - d : (long long)i + d;
  return (j >= 0 && j < a.L) ? (int)j : -1;
}

__device__ __forceinline__ bool aligned16(const int* row, int L) {
  return (L & 3) == 0 && ((uintptr_t)row & 15) == 0;
}

// v[q] = row[i + q] for q < PER, `fill` past L
__device__ __forceinline__ void load4(const int* row, int i, int L, bool vec,
                                      int fill, int v[PER]) {
  if (vec) {
    if (i < L) {
      const int4 x = __ldg(reinterpret_cast<const int4*>(row + i));
      v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
    } else {
      for (int q = 0; q < PER; ++q) v[q] = fill;
    }
  } else {
    for (int q = 0; q < PER; ++q) v[q] = i + q < L ? __ldg(row + i + q) : fill;
  }
}

__device__ __forceinline__ int warp_max(int v) {
  for (int o = 16; o; o >>= 1) v = max(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// pass 1: each tile's last landed destination, -1 if none
__global__ void route_last_kernel(Args a) {
  __shared__ int wmax[WARPS];
  const int t = blockIdx.x % a.nt;
  const int b = blockIdx.x / a.nt;
  const int* drow = a.delta + (long long)b * a.L;
  const int i = t * TILE + PER * threadIdx.x;
  int dv[PER];
  load4(drow, i, a.L, aligned16(drow, a.L), -1, dv);
  int m = -1;
  for (int q = 0; q < PER; ++q) m = max(m, dest_of(dv[q], i + q, a));
  m = warp_max(m);
  if ((threadIdx.x & 31) == 0) wmax[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int k = 1; k < WARPS; ++k) m = max(m, wmax[k]);
    a.last[blockIdx.x] = m;                     // = b * nt + t
  }
}

__device__ __forceinline__ void clear_slot(const Args& a, long long row,
                                           int j) {
#pragma unroll
  for (int p = 0; p < MAXP; ++p)
    if (p < a.P) a.out[p][row + j] = 0;
  a.dout[row + j] = -1;
}

// pass 2: clear the slots this tile owns (file comment), then, after a
// barrier, write its landed slots' payloads over them
__global__ void route_tile_kernel(Args a) {
  __shared__ int s_red[2][WARPS];
  const int t = blockIdx.x % a.nt;
  const int b = blockIdx.x / a.nt;
  const int L = a.L;
  const int i0 = t * TILE;
  const long long row = (long long)b * L;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;

  // this tile's slots and payloads, in registers; thread x takes slots
  // i0 + q * THREADS + x, so loads and landed writes are coalesced
  const int* drow = a.delta + row;
  int dst[PER];
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    const int i = i0 + q * THREADS + threadIdx.x;
    dst[q] = i < L ? dest_of(__ldg(drow + i), i, a) : -1;
  }
  const int* lrow = a.last + (long long)b * a.nt;
  const int mine = lrow[t];                     // this tile's last, or -1
  int pv[MAXP][PER];
#pragma unroll
  for (int p = 0; p < MAXP; ++p) {
    if (p < a.P && mine >= 0) {
      const int* prow = a.pay[p] + (long long)b * a.stride[p];
#pragma unroll
      for (int q = 0; q < PER; ++q) {
        const int i = i0 + q * THREADS + threadIdx.x;
        pv[p][q] = i < L ? __ldg(prow + i) : 0;
      }
    }
  }

  // the row's summaries: prev (tiles before t) and R (all tiles)
  int prev = -1, rmax = -1;
  for (int k = threadIdx.x; k < a.nt; k += THREADS) {
    const int v = lrow[k];
    rmax = max(rmax, v);
    if (k < t) prev = max(prev, v);
  }
  prev = warp_max(prev);
  rmax = warp_max(rmax);
  if (lane == 0) { s_red[0][w] = prev; s_red[1][w] = rmax; }
  __syncthreads();
  prev = s_red[0][0];
  rmax = s_red[1][0];
#pragma unroll
  for (int k = 1; k < WARPS; ++k) {
    prev = max(prev, s_red[0][k]);
    rmax = max(rmax, s_red[1][k]);
  }

  // A: prev+1 .. this tile's last destination
  if (mine >= 0)
    for (int j = prev + 1 + threadIdx.x; j <= mine; j += THREADS)
      clear_slot(a, row, j);
  // B: this tile's own index range above the row's last destination
  const int blo = max(i0, rmax + 1), bhi = min(i0 + TILE, L);
  bool vec = blo == i0 && bhi == i0 + TILE && aligned16(a.dout + row, L);
#pragma unroll
  for (int p = 0; p < MAXP; ++p)
    if (p < a.P) vec = vec && aligned16(a.out[p] + row, L);
  if (vec) {
    const int4 z = make_int4(0, 0, 0, 0), m1 = make_int4(-1, -1, -1, -1);
    const int i = i0 + PER * threadIdx.x;
#pragma unroll
    for (int p = 0; p < MAXP; ++p)
      if (p < a.P) *reinterpret_cast<int4*>(a.out[p] + row + i) = z;
    *reinterpret_cast<int4*>(a.dout + row + i) = m1;
  } else {
    for (int j = blo + threadIdx.x; j < bhi; j += THREADS)
      clear_slot(a, row, j);
  }
  if (mine < 0) return;                         // nothing lands here
  __syncthreads();                              // clears before payloads

#pragma unroll
  for (int q = 0; q < PER; ++q) {
    const int j = dst[q];
    if (j < 0) continue;
#pragma unroll
    for (int p = 0; p < MAXP; ++p)
      if (p < a.P) a.out[p][row + j] = pv[p][q];
    a.dout[row + j] = 0;
  }
}

}  // namespace

extern "C" int dt_route(const void* pay0, const void* pay1, const void* pay2,
                        long long stride0, long long stride1,
                        long long stride2, const void* delta, void* out0,
                        void* out1, void* out2, void* dout, void* last, int P,
                        int B, int L, int rounds, int left, void* stream) {
  if (P < 1 || P > MAXP) return (int)cudaErrorInvalidValue;
  Args a;
  const void* pays[MAXP] = {pay0, pay1, pay2};
  void* outs[MAXP] = {out0, out1, out2};
  const long long strides[MAXP] = {stride0, stride1, stride2};
  for (int p = 0; p < MAXP; ++p) {
    a.pay[p] = (const int*)pays[p];
    a.stride[p] = strides[p];
    a.out[p] = (int*)outs[p];
  }
  a.delta = (const int*)delta;
  a.dout = (int*)dout;
  a.last = (int*)last;
  a.P = P;
  a.L = L;
  a.nt = (L + TILE - 1) / TILE;
  a.rounds = rounds;
  a.left = left;
  const unsigned grid = (unsigned)B * (unsigned)a.nt;
  route_last_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(a);
  route_tile_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
