// Kernel K1: batched Huffman depth builds by the two-queue merge.
//
// Replaces deflate_tpu/ops/pallas_tree.py::_kernel (wrapper depths_batch),
// which ran four interleaved trees per grid cell on the TPU scalar core.
// Plain version: deflate_tpu_torch/ops/huffman.py::_depths_two_queue.
//
// What bounds it here: the merge is a chain of ~2*nz dependent steps per
// tree (nz <= 286 used symbols), each a few shared-memory loads and
// compares - latency, not bandwidth or arithmetic (a tree is ~6 KB).
// Design: one thread block per tree.  All state (weights, the internal
// queue, parent links, depths) lives in shared memory; the block's
// threads initialise and write out in parallel, and one thread runs the
// two sequential chains (the merge, then the reverse-creation depth
// sweep).  Trees run concurrently across SMs, so a batch of 3 x 256 trees
// costs about one tree's chain.  Tie-break as the reference: on equal
// weights the leaf queue wins (huffman.py:188-251).
//
// Output per tree, int32 [1024]: [0, 512) depth of the i-th sorted leaf
// for i < nz, [512, 1024) depth of internal node k for k < nz - 1, zero
// elsewhere.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NMAX = 512;
constexpr int NW = 2 * NMAX;
constexpr int INF = 1 << 28;
constexpr int THREADS = 128;

__global__ void tree_depths_kernel(const int* __restrict__ lw_g,
                                   const int* __restrict__ nz_g,
                                   int* __restrict__ out_g, int n) {
  __shared__ int lw[NMAX + 1];
  __shared__ int iw[NMAX + 1];
  __shared__ int lpar[NMAX + 1];
  __shared__ int ipar[NMAX + 1];
  __shared__ int out[NW];

  const int t = blockIdx.x;
  const int nz = nz_g[t];
  for (int i = threadIdx.x; i < NMAX + 1; i += blockDim.x) {
    lw[i] = (i < n) ? lw_g[(int64_t)t * n + i] : INF;
    iw[i] = INF;
    lpar[i] = 0;
    ipar[i] = 0;
  }
  for (int i = threadIdx.x; i < NW; i += blockDim.x) out[i] = 0;
  __syncthreads();

  if (threadIdx.x == 0) {
    int li = 0, ii = 0;
    for (int k = 0; k < nz - 1; ++k) {
      int w1 = 0;
      for (int pick = 0; pick < 2; ++pick) {
        int wl = lw[li];
        int wi = iw[ii];
        bool take_leaf = wl <= wi;
        int w = take_leaf ? wl : wi;
        if (take_leaf) {
          lpar[li] = k;
          ++li;
        } else {
          ipar[ii] = k;
          ++ii;
        }
        if (pick == 0) w1 = w;
        else iw[k] = w1 + w;
      }
    }
    // internal depths in reverse creation order: parents come later
    const int nint = nz - 1;
    for (int kk = nint - 1; kk >= 0; --kk) {
      int par = ipar[kk] < NMAX - 1 ? ipar[kk] : NMAX - 1;
      out[NMAX + kk] = (kk == nint - 1) ? 0 : out[NMAX + par] + 1;
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < nz; i += blockDim.x) {
    int par = lpar[i] < NMAX - 1 ? lpar[i] : NMAX - 1;
    out[i] = out[NMAX + par] + 1;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < NW; i += blockDim.x)
    out_g[(int64_t)t * NW + i] = out[i];
}

}  // namespace

extern "C" int dt_tree_depths(const void* lw, const void* nz, void* out,
                              int T, int n, void* stream) {
  tree_depths_kernel<<<T, THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)lw, (const int*)nz, (int*)out, n);
  return (int)cudaGetLastError();
}
