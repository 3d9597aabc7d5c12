// Fused GNN dynamics forward for NVIDIA Hopper (sm_90a): the interaction
// network of the MPPI rollout, one push step for a chunk of samples. This
// file holds the node-input layers and the index-based edge kernels; every
// product of depth F runs on the bf16 tensor-core GEMM of gnn_gemm.cu.
//
// Replaces the Pallas TPU kernel `_gnn_kernel` (gsdx/kernels/gnn_forward.py,
// fused_gnn_forward). Plain version: gsdx_torch/kernels/gnn_forward.py
// gnn_forward_plain(operands="bf16"). Built by nvcc into a shared library
// with a C interface and called through ctypes on PyTorch's current stream;
// the wrapper `fused_gnn_forward` sequences the launches and owns every
// buffer.
//
// What bounds these kernels on this card: bytes. They do a few flops per
// element (the node-input layers have K <= 32; the edge kernels add and
// ReLU) over (B * E, F) and (B * n_pad, 2F) tensors. The whole forward is
// bound by the GEMM's operations and the bytes of its activations; see
// gnn_gemm.cu.
//
// Design. The TPU kernel keeps one sample's whole forward in VMEM: 5.8 MB
// of bf16 weights and (E, 512) f32 activations. A Hopper block has 227 KB of
// shared memory, so here the chunk's samples are batched instead: the node
// rows of all samples (B * n_pad) and their edge rows (B * E) form the M
// dimension of a few products against each shared weight matrix. The
// one-hot products of the TPU kernel become index operations: selecting
// rows by receiver/sender is a gather (-1 reads as zero) and Rr^T @ erel is
// a segment sum over the receivers. Outputs that only a product reads are
// stored bf16 (round to nearest even), halving their traffic.
//
//   * gnn_linear: the node-input layers over [state | attrs | action],
//     K <= 32 (11 at n_his 3: below wgmma's depth of 16, and a row stride
//     of 14 floats that TMA does not take). Y = act(X W + bias + R), X f32
//     (M, K) with a row stride, W bf16 (or f32, for the folded node-state
//     block) (K, N), f32 arithmetic on the CUDA cores; Y f32 or bf16.
//     A 128x128 shared-memory tile, 8-deep K steps, 256 threads each
//     holding an 8x8 register micro-tile.
//   * gnn_edge_first: relation-encoder layer 1 in node-side form,
//     h1[e] = relu(nr[recv] + ns[send] + |g[recv] - g[send]| w_g + b1),
//     stored bf16.
//   * gnn_segments: once a forward, per sample, a stable counting sort of
//     the non-empty slots by receiver: seg_off (B, n_pad + 1) the start of
//     each receiver's segment, seg_slot (B, E) the slots of each segment in
//     ascending order (-1 past the last). Slots may come in any order. One
//     block a sample: shared-memory counts, one warp's scan, then one warp
//     places the slots 32 at a time in slot order (`__match_any_sync`
//     ranks the lanes that share a receiver).
//   * gnn_message: agg[b, n] = sum over slots e with recv[b, e] = n of
//     relu(rel_pre[e] + ewr[b, n] + ews[b, send[e]]), summed in f32 in slot
//     order and stored bf16. The edge effect is read only by this sum, so
//     it never reaches device memory. Each node row walks only its own
//     segment: its warps read up to 32 of the segment's slots and their
//     senders at once, then keep MESSAGE_DEPTH slots' rows in flight before
//     adding them in order. No atomics, and the same bits on every run,
//     whatever order the slots come in. Bound by bytes: the f32 rel_pre
//     rows of the slots that reach an aggregation (read once, streamed
//     past L2's keep), ew and agg.
// Empty slots (-1) never reach an aggregation. Their rows of the relation
// encoder hold relu(b1)-derived values, as in the TPU kernel, and nothing
// reads them. An index outside [-1, n_pad) reads as an empty slot in every
// kernel, so no row is read out of bounds; gnn_edge_first can flag such
// slots in an error word that the caller reads once for many forwards.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;  // rows of a gnn_linear tile
constexpr int BN = 128;  // columns of a gnn_linear tile
constexpr int BK = 8;    // depth of one K step
constexpr int LINEAR_THREADS = 256;
constexpr int LINEAR_MAX_K = 32;  // the node-input layers; depth F is the GEMM's

__device__ __forceinline__ void add4(float4& v, float4 r) {
  v.x += r.x;
  v.y += r.y;
  v.z += r.z;
  v.w += r.w;
}

// Four f32 values rounded to bf16 (nearest even) in one 8-byte store.
__device__ __forceinline__ void store_bf16x4(__nv_bfloat16* dst, float a, float b,
                                             float c, float d) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(a, b), hi = __floats2bfloat162_rn(c, d);
  uint2 packed;
  packed.x = *reinterpret_cast<uint32_t*>(&lo);
  packed.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(dst) = packed;
}

__global__ void __launch_bounds__(LINEAR_THREADS)
gnn_linear_kernel(const float* __restrict__ X, int ldx,
                  const __nv_bfloat16* __restrict__ Wb,
                  const float* __restrict__ Wf, const float* __restrict__ bias,
                  const float* __restrict__ R, float* __restrict__ Y,
                  __nv_bfloat16* __restrict__ Yb, int M, int N, int K, int relu) {
  __shared__ __align__(16) float As[BK][BM];  // X tile, transposed
  __shared__ __align__(16) float Bs[BK][BN];  // W tile
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const long m0 = static_cast<long>(blockIdx.y) * BM;
  const int n0 = blockIdx.x * BN;
  const int xr = tid >> 1, xc = (tid & 1) * 4;   // X tile: row, 4 columns
  const int wr = tid >> 5, wc = (tid & 31) * 4;  // W tile: row, 4 columns

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    const long m = m0 + xr;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int k = k0 + xc + c;
      As[xc + c][xr] = (m < M && k < K) ? X[m * ldx + k] : 0.f;
    }
    const int kw = k0 + wr;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int n = n0 + wc + c;
      float v = 0.f;
      if (kw < K && n < N) {
        const long at = static_cast<long>(kw) * N + n;
        v = Wf ? Wf[at] : __bfloat162float(Wb[at]);
      }
      Bs[wr][wc + c] = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[kk][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  // four consecutive columns a store: a warp writes two rows of 64 columns
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long row = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (row >= M) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int col = n0 + half * 64 + tx * 4;
      if (col >= N) continue;  // N is a multiple of 4
      float4 v = make_float4(acc[i][4 * half], acc[i][4 * half + 1],
                             acc[i][4 * half + 2], acc[i][4 * half + 3]);
      if (bias) add4(v, *reinterpret_cast<const float4*>(&bias[col]));
      if (R) add4(v, *reinterpret_cast<const float4*>(&R[row * N + col]));
      if (relu) {
        v.x = fmaxf(v.x, 0.f);
        v.y = fmaxf(v.y, 0.f);
        v.z = fmaxf(v.z, 0.f);
        v.w = fmaxf(v.w, 0.f);
      }
      if (Y) *reinterpret_cast<float4*>(&Y[row * N + col]) = v;
      if (Yb) store_bf16x4(&Yb[row * N + col], v.x, v.y, v.z, v.w);
    }
  }
}

// One block per edge row, F / 4 threads of four columns each.
// nrs (B * n_pad, 2F): nr in columns [0, F), ns in [F, 2F). An index outside
// [-1, n_pad) reads as an empty slot, as the one-hot product reads it; where
// `errors` is given, such a slot ORs its bit into it: recv 1, send 2.
__global__ void gnn_edge_first_kernel(const float* __restrict__ nrs,
                                      const float* __restrict__ g,
                                      const int* __restrict__ recv,
                                      const int* __restrict__ send,
                                      const __nv_bfloat16* __restrict__ wg,
                                      const float* __restrict__ b1,
                                      __nv_bfloat16* __restrict__ h1,
                                      int* __restrict__ errors, int E, int n_pad, int F) {
  const long e = blockIdx.x;
  const long b = e / E;
  int r = recv[e], s = send[e];
  if (errors && threadIdx.x == 0) {
    const int bits = (r < -1 || r >= n_pad) | ((s < -1 || s >= n_pad) << 1);
    if (bits) atomicOr(errors, bits);
  }
  if (r >= n_pad) r = -1;
  if (s >= n_pad) s = -1;
  const int f = threadIdx.x * 4;
  const float gr = r >= 0 ? g[b * n_pad + r] : 0.f;
  const float gs = s >= 0 ? g[b * n_pad + s] : 0.f;
  const float gd = fabsf(gr - gs);
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f), c = a;
  if (r >= 0) a = *reinterpret_cast<const float4*>(&nrs[(b * n_pad + r) * 2 * F + f]);
  if (s >= 0) c = *reinterpret_cast<const float4*>(&nrs[(b * n_pad + s) * 2 * F + F + f]);
  const float o0 = fmaxf(a.x + c.x + gd * __bfloat162float(wg[f + 0]) + b1[f + 0], 0.f);
  const float o1 = fmaxf(a.y + c.y + gd * __bfloat162float(wg[f + 1]) + b1[f + 1], 0.f);
  const float o2 = fmaxf(a.z + c.z + gd * __bfloat162float(wg[f + 2]) + b1[f + 2], 0.f);
  const float o3 = fmaxf(a.w + c.w + gd * __bfloat162float(wg[f + 3]) + b1[f + 3], 0.f);
  store_bf16x4(&h1[e * F + f], o0, o1, o2, o3);
}

constexpr int SEGMENT_THREADS = 256;
constexpr int MAX_N_PAD = 1024;  // node rows of a sample the segment kernel takes
constexpr int MESSAGE_DEPTH = 4;  // slots whose rows a thread has in flight

// One block per sample. A slot whose receiver lies outside [0, n_pad) is
// empty.
__global__ void __launch_bounds__(SEGMENT_THREADS)
gnn_segments_kernel(const int* __restrict__ recv, int* __restrict__ seg_off,
                    int* __restrict__ seg_slot, int E, int n_pad) {
  __shared__ int count[MAX_N_PAD];
  __shared__ int cursor[MAX_N_PAD];
  __shared__ int total;
  const long b = blockIdx.x;
  const int* rr = recv + b * E;
  int* slots = seg_slot + b * E;
  int* off = seg_off + b * (n_pad + 1);
  const int tid = threadIdx.x, lane = tid % 32;
  for (int n = tid; n < n_pad; n += blockDim.x) count[n] = 0;
  __syncthreads();
  for (int e = tid; e < E; e += blockDim.x) {
    const int r = rr[e];
    if (r >= 0 && r < n_pad) atomicAdd(&count[r], 1);
  }
  __syncthreads();
  if (tid < 32) {  // exclusive scan: each lane a run of (n_pad / 32) receivers
    const int per = (n_pad + 31) / 32, lo = min(lane * per, n_pad), hi = min(lo + per, n_pad);
    int sum = 0;
    for (int n = lo; n < hi; ++n) sum += count[n];
    int incl = sum;
#pragma unroll
    for (int d = 1; d < 32; d *= 2) {
      const int v = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += v;
    }
    int run = incl - sum;
    for (int n = lo; n < hi; ++n) {
      cursor[n] = run;
      off[n] = run;
      run += count[n];
    }
    if (lane == 31) {
      off[n_pad] = incl;
      total = incl;
    }
    __syncwarp();
    // stable placement, 32 slots at a time in slot order: a lane's place is
    // its receiver's cursor plus the lower lanes with the same receiver,
    // and the highest of those lanes moves the cursor on
    for (int e0 = 0; e0 < E; e0 += 32) {
      const int e = e0 + lane;
      int r = e < E ? rr[e] : -1;
      if (r >= n_pad) r = -1;
      const unsigned peers = __match_any_sync(0xffffffffu, r);
      const int rank = __popc(peers & ((1u << lane) - 1));
      const int base = r >= 0 ? cursor[r] : 0;
      __syncwarp();
      if (r >= 0) {
        slots[base + rank] = e;
        if ((peers >> lane) == 1u) cursor[r] = base + rank + 1;
      }
      __syncwarp();
    }
  }
  __syncthreads();
  for (int p = total + tid; p < E; p += blockDim.x) slots[p] = -1;
}

// One block per node row, F / 4 threads (whole warps) of four columns each
// (two or four rows a block were slower). ew (B * n_pad, 2F): ewr in
// columns [0, F), ews in [F, 2F).
__global__ void gnn_message_kernel(const float* __restrict__ rel_pre,
                                   const float* __restrict__ ew,
                                   const int* __restrict__ seg_off,
                                   const int* __restrict__ seg_slot,
                                   const int* __restrict__ send,
                                   __nv_bfloat16* __restrict__ agg, int E, int n_pad,
                                   int F) {
  const long node = blockIdx.x;
  const long b = node / n_pad;
  const int n = static_cast<int>(node % n_pad);
  const int lane = threadIdx.x & 31;
  const int f = threadIdx.x * 4;
  const int* slots = seg_slot + b * E;
  const int* ss = send + b * E;
  const int beg = seg_off[b * (n_pad + 1) + n], end = seg_off[b * (n_pad + 1) + n + 1];
  // a receiver without messages reads no ewr row
  const float4 er = beg < end ? *reinterpret_cast<const float4*>(&ew[node * 2 * F + f])
                              : make_float4(0.f, 0.f, 0.f, 0.f);
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c0 = beg; c0 < end; c0 += 32) {
    const int cnt = min(32, end - c0);  // the same in every lane of the row
    const int my_slot = lane < cnt ? slots[c0 + lane] : 0;
    const int my_send = lane < cnt ? ss[my_slot] : -1;
    for (int i = 0; i < cnt; i += MESSAGE_DEPTH) {
      float4 rp[MESSAGE_DEPTH], es[MESSAGE_DEPTH];
#pragma unroll
      for (int k = 0; k < MESSAGE_DEPTH; ++k) {
        const int slot = __shfl_sync(0xffffffffu, my_slot, (i + k) & 31);
        const int s = __shfl_sync(0xffffffffu, my_send, (i + k) & 31);
        rp[k] = es[k] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (i + k < cnt) {
          rp[k] = __ldcs(reinterpret_cast<const float4*>(&rel_pre[(b * E + slot) * F + f]));
          if (s >= 0 && s < n_pad)  // a sender outside [0, n_pad) reads as empty
            es[k] = *reinterpret_cast<const float4*>(&ew[(b * n_pad + s) * 2 * F + F + f]);
        }
      }
#pragma unroll
      for (int k = 0; k < MESSAGE_DEPTH; ++k) {
        if (i + k < cnt) {
          acc.x += fmaxf(rp[k].x + er.x + es[k].x, 0.f);
          acc.y += fmaxf(rp[k].y + er.y + es[k].y, 0.f);
          acc.z += fmaxf(rp[k].z + er.z + es[k].z, 0.f);
          acc.w += fmaxf(rp[k].w + er.w + es[k].w, 0.f);
        }
      }
    }
  }
  store_bf16x4(&agg[node * F + f], acc.x, acc.y, acc.z, acc.w);
}

bool bad_width(int F) { return F <= 0 || F % 128 != 0 || F > 4096; }

}  // namespace

extern "C" {

const char* gsdx_gnn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Each returns a cudaError_t code: 0 when the launch was accepted.
// gnn_linear: W (K, N), bias (N) and R (M, N) or null, Y (M, N) f32 and Yb
// (M, N) bf16 each written unless null; rows of W, R and Y are contiguous.
int gsdx_gnn_linear(const float* X, int ldx, const void* W, int w_f32,
                    const float* bias, const float* R, float* Y, void* Yb, int M,
                    int N, int K, int relu, void* stream) {
  if (K > LINEAR_MAX_K || N % 4) return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0 || N == 0) return 0;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  const __nv_bfloat16* wb = w_f32 ? nullptr : static_cast<const __nv_bfloat16*>(W);
  const float* wf = w_f32 ? static_cast<const float*>(W) : nullptr;
  gnn_linear_kernel<<<grid, LINEAR_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      X, ldx, wb, wf, bias, R, Y, static_cast<__nv_bfloat16*>(Yb), M, N, K, relu);
  return static_cast<int>(cudaGetLastError());
}

// errors: one int32 word the out-of-range slots OR their bits into, or null.
int gsdx_gnn_edge_first(const float* nrs, const float* g, const int* recv,
                        const int* send, const void* wg, const float* b1,
                        void* h1, int* errors, int B, int E, int n_pad, int F,
                        void* stream) {
  if (bad_width(F)) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || E == 0) return 0;
  gnn_edge_first_kernel<<<static_cast<unsigned>(B) * E, F / 4, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      nrs, g, recv, send, static_cast<const __nv_bfloat16*>(wg), b1,
      static_cast<__nv_bfloat16*>(h1), errors, E, n_pad, F);
  return static_cast<int>(cudaGetLastError());
}

// seg_off (B, n_pad + 1) and seg_slot (B, E) int32 out; recv (B, E).
int gsdx_gnn_segments(const int* recv, int* seg_off, int* seg_slot, int B, int E,
                      int n_pad, void* stream) {
  if (n_pad <= 0 || n_pad > MAX_N_PAD || E < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  gnn_segments_kernel<<<B, SEGMENT_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      recv, seg_off, seg_slot, E, n_pad);
  return static_cast<int>(cudaGetLastError());
}

// agg (B * n_pad, F) bf16 from rel_pre (B * E, F) and ew (B * n_pad, 2F)
// f32, the segments of gsdx_gnn_segments and send (B, E).
int gsdx_gnn_message(const float* rel_pre, const float* ew, const int* seg_off,
                     const int* seg_slot, const int* send, void* agg, int B, int E,
                     int n_pad, int F, void* stream) {
  if (bad_width(F)) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  gnn_message_kernel<<<static_cast<unsigned>(B) * n_pad, F / 4, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      rel_pre, ew, seg_off, seg_slot, send, static_cast<__nv_bfloat16*>(agg), E, n_pad, F);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
