// Radius graph of a batch of particle sets for NVIDIA Hopper (sm_90a).
//
// Replaces no Pallas kernel: gsdx builds its graph with XLA operators
// (gsdx/graph/edges.py `construct_edge_indices_batch`), and the port built
// it with ~35 aten operators a call, a full stable sort among them, once
// each push step of the MPPI rollout. Plain version:
// gsdx_torch/graph/edges.py `construct_edge_indices_batch_plain`. Built by
// nvcc into a shared library with a C interface and called through ctypes
// on PyTorch's current stream (gsdx_torch/kernels/edges.py).
//
// What it computes, the plain version's integers exactly: for receiver row
// i and sender column j of graph b, d = ((dx*dx) + (dy*dy)) + (dz*dz) with
// (dx, dy, dz) = s_i - s_j, each operation one `_rn` intrinsic, so that nvcc
// can neither contract nor reorder them (one rounding off flips d < t*t);
// d is 1e10 for a pair outside the mask or a tool-tool pair. The pair is
// adjacent where d < t*t (t*t rounded in f32). In an object row (i <
// n_obj), an object column also has to be among the row's k nearest object
// columns, the lower column first among equal distances, as the first k of
// a stable ascending sort take them (NaN after every number, NaNs equal).
// With connect_all, every object-tool pair inside the mask is added and
// tool-tool pairs and pairs outside the mask are dropped. The set pairs are
// numbered row-major; the first max_nR go to (recv, send) int32 slots, and
// every other slot up to `width` holds -1.
//
// What bounds it: a call is one launch of B blocks that each read N * 3
// floats and write 2 * width ints (at the rollout's shapes ~4 KB in and
// ~10 KB out a graph, well under a microsecond of the card's bandwidth).
// A graph's rows share one SM, so the row phase's instructions bound it,
// the top-k rounds most: 13-23 us at the rollout's shapes against ~1 us for
// an empty launch (PERF.md §6). Design:
//   * one block a graph, N <= 256; the positions in shared memory, the mask
//     and tool bits as 32-column words;
//   * a warp a receiver row (32 warps a block): lane l holds columns
//     l + 32 w in registers, w below the row's (N + 31) / 32 words, a
//     template argument; each row's adjacency leaves as 32-column ballots;
//   * the top-k is k rounds of a warp argmin over (distance key, column)
//     by two `redux.sync` minimums (the key, then the column among the
//     lanes holding it); the winner's lane marks it taken;
//   * `__popc` counts a row's pairs, a block scan of the counts gives each
//     row's first slot, and each row's lanes write their pairs at that slot
//     plus the set bits below them.

#include <cuda_runtime.h>

namespace {

constexpr int MAX_N = 256;
constexpr int WORDS = MAX_N / 32;  // 32-column words a row
constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_K = 32;
constexpr float BIG = 1e10f;  // gsdx's _BIG
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned NONE = 0xffffffffu;

struct Args {
  const float* states;         // (B, N, 3), graph b at states + b * state_stride
  long long state_stride;
  const unsigned char* mask;   // (B, N) bool
  const unsigned char* tool;   // (B, N) bool
  const float* thresh;         // thresh[b * thresh_stride]; null: thresh_value
  int thresh_stride;
  float thresh_value;
  int* recv;                   // (B, width)
  int* send;                   // (B, width)
  int N, n_obj, k, max_nR, width, connect_all;
};

// A distance as an ordered key: the bits of a non-negative float order as
// the float does; every NaN is one key above +inf.
__device__ __forceinline__ unsigned order_key(float v) {
  return v != v ? NONE : __float_as_uint(v);
}

// W: the 32-column words of a row, (N + 31) / 32
template <int W>
__global__ void __launch_bounds__(THREADS) edges_kernel(const Args a) {
  __shared__ float s_x[MAX_N], s_y[MAX_N], s_z[MAX_N];
  __shared__ unsigned s_mw[WORDS], s_tw[WORDS];  // mask and tool bits by word
  __shared__ unsigned s_bits[MAX_N][WORDS];
  __shared__ int s_off[MAX_N + 1];
  __shared__ int s_warp[WARPS];

  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int N = a.N;
  if (tid < MAX_N) {  // the first 8 warps load a particle a thread
    const bool in = tid < N;
    bool m = false, tl = false;
    if (in) {
      const float* p = a.states + static_cast<long long>(b) * a.state_stride + 3 * tid;
      s_x[tid] = p[0];
      s_y[tid] = p[1];
      s_z[tid] = p[2];
      m = a.mask[static_cast<long long>(b) * N + tid];
      tl = a.tool[static_cast<long long>(b) * N + tid];
    }
    const unsigned mw = __ballot_sync(FULL, m), tw = __ballot_sync(FULL, tl);
    if (lane == 0) {
      s_mw[warp] = mw;
      s_tw[warp] = tw;
    }
  }
  const float t = a.thresh ? a.thresh[static_cast<long long>(b) * a.thresh_stride]
                           : a.thresh_value;
  const float t2 = __fmul_rn(t, t);
  __syncthreads();

  // rows: the adjacency's words into s_bits, the row's count into s_off
  for (int i = warp; i < N; i += WARPS) {
    const float xi = s_x[i], yi = s_y[i], zi = s_z[i];
    const bool mi = (s_mw[i >> 5] >> (i & 31)) & 1u, ti = (s_tw[i >> 5] >> (i & 31)) & 1u;
    // pair[w]: the columns inside the mask with the row, no tool-tool pair
    unsigned pair[W], adj[W], key[W];
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const int j = min(w * 32 + lane, N - 1);
      pair[w] = mi ? s_mw[w] & ~(ti ? s_tw[w] : 0u) : 0u;
      const float dx = __fsub_rn(xi, s_x[j]);
      const float dy = __fsub_rn(yi, s_y[j]);
      const float dz = __fsub_rn(zi, s_z[j]);
      const float dist =
          __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
      const float d = (pair[w] >> lane) & 1u ? dist : BIG;
      adj[w] = __ballot_sync(FULL, w * 32 + lane < N && d < t2);
      key[w] = order_key(d);
    }
    unsigned taken = 0;  // bit w: this lane's column of word w is among the k nearest
    if (i < a.n_obj) {
      // k rounds of the warp's argmin over the untaken object columns
      for (int r = 0; r < a.k; ++r) {
        unsigned lk = NONE, lj = NONE;
#pragma unroll
        for (int w = 0; w < W; ++w) {
          const int j = w * 32 + lane;
          const bool free = j < a.n_obj && !((taken >> w) & 1u);
          if (free && (lj == NONE || key[w] < lk)) {
            lk = key[w];
            lj = static_cast<unsigned>(j);
          }
        }
        const unsigned mk = __reduce_min_sync(FULL, lk);
        const unsigned mj = __reduce_min_sync(FULL, lk == mk ? lj : NONE);
        if (static_cast<int>(mj & 31u) == lane) taken |= 1u << (mj >> 5);
      }
    }
    // the top-k in the object block, then connect_all, as the plain version
    int count = 0;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      if (i < a.n_obj) {
        const int objs = a.n_obj - w * 32;  // object columns of this word
        const unsigned obj_cols = objs >= 32 ? FULL : objs <= 0 ? 0u : (1u << objs) - 1u;
        adj[w] &= __ballot_sync(FULL, (taken >> w) & 1u) | ~obj_cols;
      }
      if (a.connect_all)
        adj[w] = (adj[w] | (ti ? s_mw[w] : 0u) | (mi ? s_tw[w] : 0u)) & pair[w];
      count += __popc(adj[w]);
      if (lane == w) s_bits[i][w] = adj[w];
    }
    if (lane == 0) s_off[i] = count;
  }
  __syncthreads();

  // an exclusive scan of the N row counts (N <= 256: the first 8 warps)
  int c = 0, incl = 0;
  if (tid < MAX_N) {
    c = tid < N ? s_off[tid] : 0;
    incl = c;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(FULL, incl, o);
      if (lane >= o) incl += v;
    }
    if (lane == 31) s_warp[warp] = incl;
  }
  __syncthreads();
  if (tid < MAX_N) {
    int before = 0;
    for (int w = 0; w < warp; ++w) before += s_warp[w];
    if (tid < N) s_off[tid] = before + incl - c;
    if (tid == N - 1) s_off[N] = before + incl;
  }
  __syncthreads();

  // packing: each row's pairs at its first slot, in column order
  int* recv = a.recv + static_cast<long long>(b) * a.width;
  int* send = a.send + static_cast<long long>(b) * a.width;
  const unsigned below = (1u << lane) - 1u;
  for (int i = warp; i < N; i += WARPS) {
    int slot = s_off[i];
    for (int w = 0; w < W && slot < a.max_nR; ++w) {
      const unsigned bits = s_bits[i][w];
      const int mine = slot + __popc(bits & below);
      if (((bits >> lane) & 1u) && mine < a.max_nR) {
        recv[mine] = i;
        send[mine] = w * 32 + lane;
      }
      slot += __popc(bits);
    }
  }
  const int used = min(s_off[N], a.max_nR);
  for (int s = used + tid; s < a.width; s += THREADS) {
    recv[s] = -1;
    send[s] = -1;
  }
}

}  // namespace

extern "C" {

const char* gsdx_edges_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// states (B, N, 3) f32 with graph stride state_stride (floats), mask and
// tool (B, N) bool, thresh (B,) f32 read at b * thresh_stride or null and
// thresh_value for every graph -> recv, send (B, width) int32. N 1-256,
// 0 <= k <= min(32, n_obj), n_obj <= N, 0 <= max_nR <= width. Returns a
// cudaError_t code: 0 when the launch was accepted. A refused launch leaves
// no error behind for the runtime's next launch check to report.
int gsdx_edges(const float* states, long long state_stride, const unsigned char* mask,
               const unsigned char* tool, const float* thresh, int thresh_stride,
               float thresh_value, int* recv, int* send, int B, int N, int n_obj, int k,
               int max_nR, int width, int connect_all, void* stream) {
  if (B == 0) return 0;
  if (B < 0 || N < 1 || N > MAX_N || n_obj < 0 || n_obj > N || k < 0 || k > MAX_K ||
      k > n_obj || max_nR < 0 || width < max_nR)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a = {};
  a.states = states;
  a.state_stride = state_stride;
  a.mask = mask;
  a.tool = tool;
  a.thresh = thresh;
  a.thresh_stride = thresh_stride;
  a.thresh_value = thresh_value;
  a.recv = recv;
  a.send = send;
  a.N = N;
  a.n_obj = n_obj;
  a.k = k;
  a.max_nR = max_nR;
  a.width = width;
  a.connect_all = connect_all;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((N + 31) / 32) {
    case 1: edges_kernel<1><<<B, THREADS, 0, s>>>(a); break;
    case 2: edges_kernel<2><<<B, THREADS, 0, s>>>(a); break;
    case 3: edges_kernel<3><<<B, THREADS, 0, s>>>(a); break;
    case 4: edges_kernel<4><<<B, THREADS, 0, s>>>(a); break;
    case 5: edges_kernel<5><<<B, THREADS, 0, s>>>(a); break;
    case 6: edges_kernel<6><<<B, THREADS, 0, s>>>(a); break;
    case 7: edges_kernel<7><<<B, THREADS, 0, s>>>(a); break;
    default: edges_kernel<8><<<B, THREADS, 0, s>>>(a); break;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
