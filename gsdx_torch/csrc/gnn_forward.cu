// Fused GNN dynamics forward for NVIDIA Hopper (sm_90a): the interaction
// network of the MPPI rollout, one push step for a chunk of samples.
//
// Replaces the Pallas TPU kernel `_gnn_kernel` (gsdx/kernels/gnn_forward.py,
// fused_gnn_forward). Plain version: gsdx_torch/kernels/gnn_forward.py
// gnn_forward_plain. Built by nvcc into a shared library with a C interface
// and called through ctypes on PyTorch's current stream; the wrapper
// `fused_gnn_forward` sequences the launches and owns every buffer.
//
// What bounds it on this card: operations. One sample and push costs about
// 1.7 GFLOP at rope width (eleven 512x512 products over 128 node rows and
// 504 edge rows), against a few MB of weights and inputs, so the f32
// multiply-adds bound it, not the 3.35 TB/s of device memory.
//
// Design. The TPU kernel keeps one sample's whole forward in VMEM: 5.8 MB
// of bf16 weights and (E, 512) f32 activations. A Hopper block has 227 KB of
// shared memory, so here the chunk's samples are batched instead: the node
// rows of all samples (B * n_pad) and their edge rows (B * E) form the M
// dimension of a few products against each shared weight matrix, which
// gives enough blocks to fill 132 SMs and reads each weight tile once per
// 128 rows. The one-hot products of the TPU kernel become index
// operations: selecting rows by receiver/sender is a gather (-1 reads as
// zero) and Rr^T @ erel is a segment sum over the receivers.
//
//   * gnn_linear: Y = act(X W + bias + R1 + R2), X f32 (M, K) with a row
//     stride, W bf16 (or f32, for the folded node-state block) (K, N),
//     f32 accumulation. A 128x128 shared-memory tile, 8-deep K steps, 256
//     threads each holding an 8x8 register micro-tile. The epilogue fuses
//     the bias, up to two residuals and the ReLU.
//   * gnn_edge_first: relation-encoder layer 1 in node-side form,
//     h1[e] = relu(nr[recv] + ns[send] + |g[recv] - g[send]| w_g + b1).
//   * gnn_message: agg[b, n] = sum over slots e with recv[b, e] = n of
//     relu(rel_pre[e] + ewr[b, n] + ews[b, send[e]]). The edge effect is
//     read only by this sum, so it never reaches device memory. One block
//     per node row scans its sample's receivers 32 at a time with a warp
//     ballot and adds the matches in slot order: no atomics, and the same
//     result on every run, whatever order the slots come in.
//
// Empty slots (-1) never reach an aggregation. Their rows of the relation
// encoder hold relu(b1)-derived values, as in the TPU kernel, and nothing
// reads them. This version computes in f32 on the CUDA cores; bf16 tensor
// cores are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 128;  // rows of a gnn_linear tile
constexpr int BN = 128;  // columns of a gnn_linear tile
constexpr int BK = 8;    // depth of one K step
constexpr int LINEAR_THREADS = 256;

__global__ void __launch_bounds__(LINEAR_THREADS)
gnn_linear_kernel(const float* __restrict__ X, int ldx,
                  const __nv_bfloat16* __restrict__ Wb,
                  const float* __restrict__ Wf, int ldw,
                  const float* __restrict__ bias,
                  const float* __restrict__ R1, const float* __restrict__ R2,
                  int ldr, float* __restrict__ Y, int ldy, int M, int N, int K,
                  int relu) {
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
        const long at = static_cast<long>(kw) * ldw + n;
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

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long row = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (col >= N) continue;
      float v = acc[i][j];
      if (bias) v += bias[col];
      if (R1) v += R1[row * ldr + col];
      if (R2) v += R2[row * ldr + col];
      if (relu) v = fmaxf(v, 0.f);
      Y[row * ldy + col] = v;
    }
  }
}

// One block per edge row, F / 4 threads of four columns each.
// nrs (B * n_pad, 2F): nr in columns [0, F), ns in [F, 2F).
__global__ void gnn_edge_first_kernel(const float* __restrict__ nrs,
                                      const float* __restrict__ g,
                                      const int* __restrict__ recv,
                                      const int* __restrict__ send,
                                      const __nv_bfloat16* __restrict__ wg,
                                      const float* __restrict__ b1,
                                      float* __restrict__ h1, int E, int n_pad,
                                      int F) {
  const long e = blockIdx.x;
  const long b = e / E;
  const int r = recv[e], s = send[e];
  const int f = threadIdx.x * 4;
  const float gr = r >= 0 ? g[b * n_pad + r] : 0.f;
  const float gs = s >= 0 ? g[b * n_pad + s] : 0.f;
  const float gd = fabsf(gr - gs);
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f), c = a;
  if (r >= 0) a = *reinterpret_cast<const float4*>(&nrs[(b * n_pad + r) * 2 * F + f]);
  if (s >= 0) c = *reinterpret_cast<const float4*>(&nrs[(b * n_pad + s) * 2 * F + F + f]);
  float4 out;
  out.x = fmaxf(a.x + c.x + gd * __bfloat162float(wg[f + 0]) + b1[f + 0], 0.f);
  out.y = fmaxf(a.y + c.y + gd * __bfloat162float(wg[f + 1]) + b1[f + 1], 0.f);
  out.z = fmaxf(a.z + c.z + gd * __bfloat162float(wg[f + 2]) + b1[f + 2], 0.f);
  out.w = fmaxf(a.w + c.w + gd * __bfloat162float(wg[f + 3]) + b1[f + 3], 0.f);
  *reinterpret_cast<float4*>(&h1[e * F + f]) = out;
}

// One block per node row, F / 4 threads (whole warps) of four columns each.
// ew (B * n_pad, 2F): ewr in columns [0, F), ews in [F, 2F).
__global__ void gnn_message_kernel(const float* __restrict__ rel_pre,
                                   const float* __restrict__ ew,
                                   const int* __restrict__ recv,
                                   const int* __restrict__ send,
                                   float* __restrict__ agg, int E, int n_pad,
                                   int F) {
  const long node = blockIdx.x;
  const long b = node / n_pad;
  const int n = static_cast<int>(node % n_pad);
  const int lane = threadIdx.x & 31;
  const int f = threadIdx.x * 4;
  const int* rr = recv + b * E;
  const int* ss = send + b * E;
  const float4 er = *reinterpret_cast<const float4*>(&ew[node * 2 * F + f]);
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int e0 = 0; e0 < E; e0 += 32) {
    const int e = e0 + lane;
    const int rv = e < E ? rr[e] : -1;
    unsigned mask = __ballot_sync(0xffffffffu, rv == n);
    while (mask) {
      const int slot = e0 + __ffs(mask) - 1;
      mask &= mask - 1;
      const int s = ss[slot];
      const float4 rp = *reinterpret_cast<const float4*>(
          &rel_pre[(b * E + slot) * F + f]);
      float4 es = make_float4(0.f, 0.f, 0.f, 0.f);
      if (s >= 0) es = *reinterpret_cast<const float4*>(
          &ew[(b * n_pad + s) * 2 * F + F + f]);
      acc.x += fmaxf(rp.x + er.x + es.x, 0.f);
      acc.y += fmaxf(rp.y + er.y + es.y, 0.f);
      acc.z += fmaxf(rp.z + er.z + es.z, 0.f);
      acc.w += fmaxf(rp.w + er.w + es.w, 0.f);
    }
  }
  *reinterpret_cast<float4*>(&agg[node * F + f]) = acc;
}

bool bad_width(int F) { return F <= 0 || F % 128 != 0 || F > 4096; }

}  // namespace

extern "C" {

const char* gsdx_gnn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Each returns a cudaError_t code: 0 when the launch was accepted.
int gsdx_gnn_linear(const float* X, int ldx, const void* W, int w_f32, int ldw,
                    const float* bias, const float* R1, const float* R2,
                    int ldr, float* Y, int ldy, int M, int N, int K, int relu,
                    void* stream) {
  if (M == 0 || N == 0) return 0;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  const __nv_bfloat16* wb = w_f32 ? nullptr : static_cast<const __nv_bfloat16*>(W);
  const float* wf = w_f32 ? static_cast<const float*>(W) : nullptr;
  gnn_linear_kernel<<<grid, LINEAR_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      X, ldx, wb, wf, ldw, bias, R1, R2, ldr, Y, ldy, M, N, K, relu);
  return static_cast<int>(cudaGetLastError());
}

int gsdx_gnn_edge_first(const float* nrs, const float* g, const int* recv,
                        const int* send, const void* wg, const float* b1,
                        float* h1, int B, int E, int n_pad, int F,
                        void* stream) {
  if (bad_width(F)) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || E == 0) return 0;
  gnn_edge_first_kernel<<<static_cast<unsigned>(B) * E, F / 4, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      nrs, g, recv, send, static_cast<const __nv_bfloat16*>(wg), b1, h1, E,
      n_pad, F);
  return static_cast<int>(cudaGetLastError());
}

int gsdx_gnn_message(const float* rel_pre, const float* ew, const int* recv,
                     const int* send, float* agg, int B, int E, int n_pad,
                     int F, void* stream) {
  if (bad_width(F)) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  gnn_message_kernel<<<static_cast<unsigned>(B) * n_pad, F / 4, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      rel_pre, ew, recv, send, agg, E, n_pad, F);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
