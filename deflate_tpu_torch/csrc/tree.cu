// Kernel K1: batched Huffman depth builds by the two-queue merge.
//
// Replaces deflate_tpu/ops/pallas_tree.py::_kernel (wrapper depths_batch),
// which ran four interleaved trees per grid cell on the TPU scalar core.
// Plain version: deflate_tpu_torch/ops/huffman.py::_depths_two_queue;
// torch form of this design: deflate_tpu_torch/ops/tree.py::depths_jump.
//
// What bounds it here: one thread's instruction issue.  A tree is ~6 KB
// in and out, but its merge is a chain of nz - 1 dependent steps (nz <=
// 286 used symbols) on one thread, and a launch lasts as long as its
// longest chain.  Design:
//   - one warp a tree, TREES trees a block, shared memory sized by n; the
//     warps never wait for each other, and each has an SM sub-partition's
//     issue slot to itself;
//   - lane 0 runs the merge a step (two picks) at a time, with the first
//     two weights of each queue in registers.  The queues are sorted, so
//     a step needs no pick-by-pick compare: it takes
//     c = [l0 <= h1] + [l1 <= h0] leaves (ties go to the leaf) and
//     2 - c internal nodes, and makes a node of weight
//     min(l0, h0) + min(max(l0, h0), min(l1, h1)).  The step's four
//     refill loads are issued first and consumed by its last selects; a
//     new node goes straight into the register of its place in the
//     internal queue (the node just made is often the next head); no
//     branch splits the step, and one 8-byte store records the node's
//     weight and c;
//   - the parent links come afterwards, over the whole warp, from a scan
//     of the steps' c; the internal depths by pointer jumping (at most
//     JUMP_ROUNDS rounds, ending early once no pointer moves) instead of
//     a serial sweep in reverse creation order; each leaf reads its
//     parent's depth;
//   - the warp writes its tree's 1024 output words as int4 stores.
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
constexpr int TREES = 4;          // warps (trees) a block
constexpr int PAD = 8;            // INF entries past n: a step reads [i + 3]
constexpr int JUMP_ROUNDS = 9;    // 2^9 > nz - 2, the deepest internal node

// shared words a tree: internal nodes (weight, leaves its step took;
// n + PAD pairs), leaf weights (n + PAD, then the depths), leaf parents,
// internal parents (then the jump pointers), n each; rounded up to an
// even count, so every tree's pairs stay 8-byte aligned.
__host__ __device__ constexpr int tree_words(int n) {
  return (2 * (n + PAD) + (n + PAD) + 2 * n + 1) & ~1;
}

// PER: internal nodes a lane holds during the pointer jumping (32 * PER
// >= n - 1).
template <int PER>
__global__ void __launch_bounds__(TREES * 32)
tree_depths_kernel(const int* __restrict__ lw_g, const int* __restrict__ nz_g,
                   int* __restrict__ out_g, int T, int n) {
  extern __shared__ int2 smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int t = blockIdx.x * TREES + warp;
  if (t >= T) return;
  int2* node = smem + warp * (tree_words(n) / 2);
  int* lw = reinterpret_cast<int*>(node + n + PAD);
  int* lpar = lw + n + PAD;
  int* ipar = lpar + n;        // internal parents, then jump pointers
  int* dep = lw;               // jump distances, then internal depths
  const int nz = min(max(nz_g[t], 0), n);
  const int nint = nz - 1;     // internal nodes; the root is nint - 1

  for (int i = lane; i < n + PAD; i += 32) {
    lw[i] = i < n ? lw_g[(int64_t)t * n + i] : INF;
    node[i] = make_int2(INF, 0);
    if (i < n) lpar[i] = 0;
  }
  __syncwarp();

  if (lane == 0 && nint > 0) {
    // l0, l1: the leaf queue's head (at lp); h0, h1: the internal
    // queue's (at ip, INF where no node is made yet); kp: node k
    const int* lp = lw;
    const int2* ip = node;
    int2* kp = node;
    int2* const end = node + nint;
    int l0 = lp[0], l1 = lp[1];
    int h0 = INF, h1 = INF;
#pragma unroll 2
    for (; kp < end; ++kp) {
      const int L2 = lp[2], L3 = lp[3];
      const int I2 = ip[2].x, I3 = ip[3].x;
      const int c = (l0 <= h1) + (l1 <= h0);     // leaves this step takes
      const int w = min(l0, h0) + min(max(l0, h0), min(l1, h1));
      *kp = make_int2(w, c);
      lp += c;
      ip += 2 - c;
      const int nl0 = c == 0 ? l0 : (c == 1 ? l1 : L2);
      const int nl1 = c == 0 ? l1 : (c == 1 ? L2 : L3);
      const int nh0 = c == 2 ? h0 : (c == 1 ? h1 : I2);
      const int nh1 = c == 2 ? h1 : (c == 1 ? I2 : I3);
      l0 = nl0;
      l1 = nl1;
      h0 = kp == ip ? w : nh0;                   // node k heads the queue
      h1 = kp == ip + 1 ? w : nh1;               // or comes second
    }
  }
  __syncwarp();

  // parent links: step k takes leaves li_k .. and internal nodes
  // 2k - li_k .., where li_k is the sum of c over the steps before it
  {
    const int steps = max(nint, 0);
    const int per = (steps + 31) / 32;
    const int k0 = min(lane * per, steps);
    const int k1 = min(k0 + per, steps);
    int s = 0;
    for (int k = k0; k < k1; ++k) s += node[k].y;
    int incl = s;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += v;
    }
    int li = incl - s;
    for (int k = k0; k < k1; ++k) {
      const int c = node[k].y;
      const int ii = 2 * k - li;
      if (c > 0) lpar[li] = k;
      if (c > 1) lpar[li + 1] = k;
      if (c < 2) ipar[ii] = k;
      if (c < 1) ipar[ii + 1] = k;
      li += c;
    }
  }
  __syncwarp();

  // pointer jumping: node k points at an ancestor and holds its distance
  // to it; a pointer at the root (or past it) has stopped
  int anc[PER], dist[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int k = lane + 32 * j;
    if (k < nint) {
      const bool root = k == nint - 1;
      anc[j] = root ? k : min(ipar[k], NMAX - 1);
      dist[j] = root ? 0 : 1;
      ipar[k] = anc[j];
      dep[k] = dist[j];
    }
  }
  __syncwarp();
  for (int r = 0; r < JUMP_ROUNDS; ++r) {
    bool moved = false;
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int k = lane + 32 * j;
      if (k < nint && anc[j] < nint - 1) {
        const int a = anc[j];
        dist[j] += dep[a];
        anc[j] = ipar[a];
        moved = true;
      }
    }
    __syncwarp();              // every lane has read before any writes
    if (!__any_sync(0xffffffffu, moved)) break;
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int k = lane + 32 * j;
      if (k < nint) {
        ipar[k] = anc[j];
        dep[k] = dist[j];
      }
    }
    __syncwarp();
  }

  int4* out4 = reinterpret_cast<int4*>(out_g + (int64_t)t * NW);
  for (int q = lane; q < NW / 4; q += 32) {
    int v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = 4 * q + u;
      if (j < NMAX) {
        const int p = j < nz ? min(lpar[j], NMAX - 1) : 0;
        v[u] = j < nz ? (p < nint ? dep[p] : 0) + 1 : 0;
      } else {
        v[u] = j - NMAX < nint ? dep[j - NMAX] : 0;
      }
    }
    out4[q] = make_int4(v[0], v[1], v[2], v[3]);
  }
}

template <int PER>
int launch(const int* lw, const int* nz, int* out, int T, int n,
           cudaStream_t stream) {
  const size_t smem = (size_t)TREES * tree_words(n) * sizeof(int);
  tree_depths_kernel<PER><<<(T + TREES - 1) / TREES, TREES * 32, smem,
                            stream>>>(lw, nz, out, T, n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int dt_tree_depths(const void* lw, const void* nz, void* out,
                              int T, int n, void* stream) {
  if (T <= 0) return 0;
  if (n < 1 || n > NMAX) return (int)cudaErrorInvalidValue;
  const int* l = (const int*)lw;
  const int* z = (const int*)nz;
  int* o = (int*)out;
  cudaStream_t s = (cudaStream_t)stream;
  if (n <= 32) return launch<1>(l, z, o, T, n, s);
  if (n <= 64) return launch<2>(l, z, o, T, n, s);
  if (n <= 128) return launch<4>(l, z, o, T, n, s);
  if (n <= 288) return launch<9>(l, z, o, T, n, s);
  return launch<16>(l, z, o, T, n, s);
}
