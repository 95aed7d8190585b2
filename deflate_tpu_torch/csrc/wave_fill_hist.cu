// Kernel K5: ordered LZ77 match fill with a 32 KiB cross-row history,
// resolved by pointer jumping over the whole plan.
//
// Replaces deflate_tpu/ops/wave_fill.py::_kernel_seq (wrapper
// fill_matches_hist), which ran the virtual blocks of a foreign-stream
// plan in grid order on the TPU scalar core and slid an SMEM window
// [last 32 KiB of output | current block] left by each block's output
// size.  Plain version: deflate_tpu_torch/ops/wave_fill.py::
// fill_matches_hist_plain; the torch mirror of this design is
// fill_matches_hist_jump there.
//
// Contract.  Rows are virtual blocks in stream order: litwords [B, 8192]
// int32 (literal bytes placed), recs [B, 2*NM] raw interleaved records
// (r0 = opos | len3 << 16, r1 = dist; len3 is 16 bits), nmatch [B],
// sizes [B] output bytes per row.  In window coordinates a record at row
// byte opos has p = ND + opos and src = max(p - dist, 0), and writes
// n = min(len3 + 3, ND - opos) bytes out[p + k] = win[src + k % (p - src)]
// (skipped when p - src <= 0 or n <= 0).  Window bytes before the row
// are the stream's earlier valid bytes (each earlier row's first sizes
// bytes), zeros before the stream's first byte; the row's own bytes,
// its tail included, are its own.  Every entry of the output equals the
// serial plain version, tails past sizes[b] included.
//
// What bounds it here: the chain of records is serial only by data
// dependency — every source byte precedes its target — so the first
// version, one CTA walking 592,539 records in order, was latency-bound
// at ~198 ns a record on one SM.  Here each output byte of the padded
// plan [B, ND] (plus one ZERO sentinel, index B * ND, that reads 0)
// holds a pointer to the byte it copies:
//   (a) row starts: exclusive prefix of the clamped sizes (one CTA);
//   (b) every pointer starts as itself (its literal byte); one warp per
//       record writes, for each of its n bytes, the padded index of its
//       source: the same row at or past the row's window start, else the
//       earlier row that holds stream byte starts[b] - ND + w (binary
//       search over the row starts; zero-size rows are never found), or
//       ZERO before the stream.  Records of a row do not overlap, so
//       each pointer has one writer;
//   (c) pointer jumping, ptr[x] = ptr[ptr[x]], in place over all
//       positions and all SMs: any value read is an ancestor on x's
//       chain, so after k rounds every pointer is 2^k hops on or at its
//       chain's end.  A pointer found to end its chain is stored
//       complemented (negative) and skipped from then on.  The wrapper
//       launches a fixed ceil(log2(B * ND + 1)) rounds, each of which
//       returns at once when the round before changed nothing (a device
//       flag, so the host never waits); phase B's 509-byte repeats
//       (chains of ~4 k hops) settle in about 13;
//   (d) gather: each output word takes its 4 bytes from the literal rows
//       at the chain ends (0 at ZERO), coalesced.
// The traffic is a few passes over the 4-byte pointers (50 MB at 384
// rows, about the size of L2) and the random reads of the jumps.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ND = 32768;        // output bytes per row
constexpr int NM = 11264;        // record slots per row
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int SPLIT = 4;         // CTAs per row in the record pass
constexpr int MAX_ROUNDS = 64;   // flag words the wrapper allocates

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// (a) starts[b] = sum of clamped sizes before row b; starts[B] = total
__global__ void starts_kernel(const int* __restrict__ sizes,
                              int* __restrict__ starts, int B) {
  __shared__ int warp_sum[32];
  const int per = (B + blockDim.x - 1) / blockDim.x;
  const int lo = threadIdx.x * per, hi = min(lo + per, B);
  int s = 0;
  for (int i = lo; i < hi; ++i) s += clampi(sizes[i], 0, ND);
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  int x = s;                                    // inclusive warp scan
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sum[w] = x;
  __syncthreads();
  if (w == 0) {
    const int nw = blockDim.x >> 5;
    int v = lane < nw ? warp_sum[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += y;
    }
    warp_sum[lane] = v;
  }
  __syncthreads();
  int acc = x - s + (w ? warp_sum[w - 1] : 0);
  for (int i = lo; i < hi; ++i) {
    starts[i] = acc;
    acc += clampi(sizes[i], 0, ND);
  }
  if (threadIdx.x == blockDim.x - 1) starts[B] = acc;
}

// (b) every pointer to itself; N = B * ND is a multiple of 4
__global__ void init_kernel(int* __restrict__ ptr, int N) {
  const int stride = gridDim.x * blockDim.x;
  int4* p4 = reinterpret_cast<int4*>(ptr);
  for (int g = blockIdx.x * blockDim.x + threadIdx.x; g < N / 4;
       g += stride)
    p4[g] = make_int4(4 * g, 4 * g + 1, 4 * g + 2, 4 * g + 3);
  if (blockIdx.x == 0 && threadIdx.x == 0) ptr[N] = N;     // ZERO
}

// (b) each record's bytes point at their sources; one warp per record
__global__ void records_kernel(const int* __restrict__ recs,
                               const int* __restrict__ nmatch,
                               const int* __restrict__ starts,
                               int* __restrict__ ptr, int B) {
  const int b = blockIdx.x / SPLIT;
  const int lane = threadIdx.x & 31;
  const int wr = (blockIdx.x % SPLIT) * WARPS + (threadIdx.x >> 5);
  const int nm = clampi(nmatch[b], 0, NM);
  const int* rb = recs + (long long)b * 2 * NM;
  const int rs = starts[b];
  const int rowbase = b * ND;
  const int zero = B * ND;
  for (int m = wr; m < nm; m += SPLIT * WARPS) {
    const unsigned r0 = (unsigned)rb[2 * m];
    const int dist = rb[2 * m + 1];
    const int opos = (int)(r0 & 0xFFFFu);
    const int n = min((int)((r0 >> 16) & 0xFFFFu) + 3, ND - opos);
    const long long p = ND + opos;
    const long long srcl = p - (long long)dist;
    const int src = srcl > 0 ? (int)srcl : 0;
    const int d = (int)p - src;
    if (d <= 0 || n <= 0) continue;
    for (int k = lane; k < n; k += 32) {
      const int w = src + (k < d ? k : k % d);
      int s;
      if (w >= ND) {
        s = rowbase + (w - ND);                 // the row's own byte
      } else {
        const int t = rs - ND + w;              // stream byte before the row
        if (t < 0) {
          s = zero;
        } else {
          // the last row r < b with starts[r] <= t holds t (t < starts[b])
          int lo = 0, hi = b - 1;
          if (starts[hi] <= t) {
            lo = hi;
          } else {
            while (lo < hi) {
              const int mid = (lo + hi + 1) >> 1;
              if (starts[mid] <= t) lo = mid; else hi = mid - 1;
            }
          }
          s = lo * ND + (t - starts[lo]);
        }
      }
      ptr[rowbase + opos + k] = s;
    }
  }
}

// one jump for x whose pointer is v: the new value, or v if x is done
__device__ __forceinline__ int jump(const int* ptr, int x, int v) {
  if (v < 0 || v == x) return v;                // done, or a literal byte
  const int q = ptr[v];
  if (q < 0) return q;                          // v's chain end, complemented
  return q == v ? ~v : q;                       // v is a chain end
}

// (c) one round over all N positions (the ZERO sentinel never moves)
__global__ void jump_kernel(int* ptr, int* flags, int round, int N) {
  if (round > 0 && flags[round - 1] == 0) return;     // fixed point
  const int stride = gridDim.x * blockDim.x;
  bool changed = false;
  int4* p4 = reinterpret_cast<int4*>(ptr);
  for (int g = blockIdx.x * blockDim.x + threadIdx.x; g < N / 4;
       g += stride) {
    const int4 v = p4[g];
    const int4 u = make_int4(jump(ptr, 4 * g, v.x), jump(ptr, 4 * g + 1, v.y),
                             jump(ptr, 4 * g + 2, v.z),
                             jump(ptr, 4 * g + 3, v.w));
    if (u.x != v.x || u.y != v.y || u.z != v.z || u.w != v.w) {
      p4[g] = u;                                // only this thread writes g
      changed = true;
    }
  }
  if (__any_sync(0xffffffffu, changed) && (threadIdx.x & 31) == 0)
    flags[round] = 1;
}

__device__ __forceinline__ unsigned byte_at(const unsigned char* lit, int v,
                                            int zero) {
  const int t = v < 0 ? ~v : v;
  return t == zero ? 0u : (unsigned)lit[t];
}

// (d) out word g = the 4 bytes at the chain ends of positions 4g..4g+3
__global__ void gather_kernel(const int* __restrict__ ptr,
                              const int* __restrict__ lit,
                              int* __restrict__ out, int N) {
  const int stride = gridDim.x * blockDim.x;
  const unsigned char* lb = reinterpret_cast<const unsigned char*>(lit);
  const int4* p4 = reinterpret_cast<const int4*>(ptr);
  for (int g = blockIdx.x * blockDim.x + threadIdx.x; g < N / 4;
       g += stride) {
    const int4 v = p4[g];
    out[g] = (int)(byte_at(lb, v.x, N) | (byte_at(lb, v.y, N) << 8)
                   | (byte_at(lb, v.z, N) << 16)
                   | (byte_at(lb, v.w, N) << 24));
  }
}

}  // namespace

// ptr: int32 [B * ND + 1], starts: int32 [B + 1], flags: int32
// [MAX_ROUNDS] scratch, all allocated by the wrapper; B * ND < 2^31.
extern "C" int dt_fill_matches_hist(const void* lit, const void* recs,
                                    const void* nmatch, const void* sizes,
                                    void* out, void* ptr, void* starts,
                                    void* flags, int B, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const int N = B * ND;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  int rounds = 0;
  while (rounds < MAX_ROUNDS && (1LL << rounds) < (long long)N + 1) ++rounds;
  const int grid = sms * 8;
  e = cudaMemsetAsync(flags, 0, sizeof(int) * rounds, st);
  if (e != cudaSuccess) return (int)e;
  starts_kernel<<<1, 1024, 0, st>>>((const int*)sizes, (int*)starts, B);
  init_kernel<<<grid, THREADS, 0, st>>>((int*)ptr, N);
  records_kernel<<<B * SPLIT, THREADS, 0, st>>>(
      (const int*)recs, (const int*)nmatch, (const int*)starts, (int*)ptr, B);
  for (int r = 0; r < rounds; ++r)
    jump_kernel<<<grid, THREADS, 0, st>>>((int*)ptr, (int*)flags, r, N);
  gather_kernel<<<grid, THREADS, 0, st>>>((const int*)ptr, (const int*)lit,
                                          (int*)out, N);
  return (int)cudaGetLastError();
}
