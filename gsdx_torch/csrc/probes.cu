// The two probe kernels for NVIDIA Hopper (sm_90a).
//
// 1. `hot_loop_kernel<TRANSCEND, SUB>` replaces the Pallas TPU kernel
//    `_kernel` of benchmarks/probe_transcendental.py (built by its `build`):
//    the tile compositor's hot loop (kernel #1, composite.cu `fwd_kernel`)
//    stripped to its arithmetic, run with its three transcendentals
//    (TRANSCEND = true: exp(power), log1p(-alpha), exp(log T)) and with the
//    probe's polynomial stand-ins in their place (false: 1 + x + x^2/2 for
//    both exps, -a - a^2/2 for the log). The time between the two is what
//    the transcendentals cost.
// 2. `roll_kernel` replaces the Pallas TPU kernel `kern` of
//    benchmarks/probe_dynamic_roll.py: `pltpu.roll(x, shift, axis=1)` with
//    the shift read on the device (the TPU's scalar prefetch).
//
// Plain versions: gsdx_torch/kernels/probes.py `composite_hot_loop_plain`
// and `dynamic_roll_plain`. Built by nvcc into a shared library with a C
// interface and called through ctypes on PyTorch's current stream.
//
// What bounds the hot loop: the instructions it issues. Per tile it walks
// ceil(count / SUB) granules of SUB splats with no early stop, and every
// (splat, pixel) pair of them does the same dense work, as on the TPU: the
// falloff, the alpha rules, one log T step, 4 channel FMAs and the three
// transcendentals (or their stand-ins). A tile's 10 used feature rows are
// read once and its 5 x 2048 outputs written once (~9.4 MB at the probe's
// shape), far below the arithmetic at 3.35 TB/s. The bound
// (tools/transcendental_probe.py `function_bound_ms`) counts the operations
// a pair that the function needs, by pipe (FP32 128 lanes an SM, ALU 64,
// MUFU 16), from the probe's source; `chip_smoke.py` `hot_loop_pipes`
// counts this loop's SASS the same way, beside it, as a diagnostic.
//
// Design:
//   * the transcendentals are one MUFU instruction each: ex2.approx of the
//     power times log2 e, lg2.approx of 1 - alpha, and log T carried in base
//     2 (written out times ln 2). With libdevice's expf and log1pf the loop
//     issued three times the instructions a pair (their range reduction and
//     polynomials around the same three MUFU ops), so the probe no longer
//     mirrors kernel #1's libm code: it measures what MUFU-only
//     transcendentals cost;
//   * the falloff keeps kernel #1's op-by-op rounding (composite.cu
//     `falloff`); -0.5 is folded into the conic's a and c at the load, which
//     is exact (a power of two), so the power is bit-equal to the plain
//     version's barring overflow and subnormal products;
//   * the work is cut by pixels, never by splats: the polynomial stand-in of
//     exp(log T) is not multiplicative, so a tile's list split into segments
//     would not combine into the same function. A unit is one tile's 32
//     columns x PPT rows, one warp, a lane a column, so that a lane's pixels
//     share dy (py is the column / 10). Persistent blocks (SMs x
//     BLOCKS_A_SM) take units from a counter in the order of their tiles'
//     granules, most first; each block sorts the tiles itself, stably, so
//     that a unit names the same tile in every block. Tiles run 1
//     to 8 granules, and the fixed 4 blocks a tile of the first port left
//     most SMs idle while a few finished the heaviest tiles;
//   * a warp reads each splat's 10 rows straight from global memory, STEP
//     splats at a time in 16-byte loads, the same address in every lane (one
//     transaction, L1-cached): no staging, no barrier. A step's rows load
//     into registers during the previous step's arithmetic
//     (tools/hot_loop_ablation.py times the knobs). Slots past the count
//     take opacity 0, which drops their alpha as the plain version's mask.
//
// The roll moves 2 x 16 KB and is bound by the launch; a block reads the
// shift once, and a thread moves one element of a row.

#include <cuda_runtime.h>

namespace {

constexpr int FEAT_DIM = 16;
constexpr int TILE_H = 16;
constexpr int TILE_W = 128;
constexpr int P = TILE_H * TILE_W;  // pixels a tile
constexpr int N_ACCUM = 4;
constexpr int N_ROWS = 6 + N_ACCUM;  // mean x, y, conic a, b, c, opacity, 4 channels
constexpr float ALPHA_MIN = 1.0f / 255.0f;
constexpr float ALPHA_MAX = 0.99f;
constexpr float LOG2_E = 1.4426950408889634f;
constexpr float LN_2 = 0.6931471805599453f;
constexpr unsigned FULL = 0xffffffffu;
// a unit: one tile's 32 columns x PPT rows, one warp
constexpr int PPT = 4;  // pixels a lane: one column, PPT rows
constexpr int COL_GROUPS = TILE_W / 32;
constexpr int UNITS_A_TILE = COL_GROUPS * (TILE_H / PPT);
constexpr int STEP = 8;  // splats a step, 16-byte loads of each feature row
constexpr int WARPS = 4;  // a block
constexpr int BLOCKS_A_SM = 2;  // persistent blocks on each SM, at most
constexpr int MAX_T = 8192;  // tiles a launch: the sort's shared memory

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float lg2(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ int granules(int count, int K, int sub) {
  return (min(max(count, 0), K) + sub - 1) / sub;
}

// The feature rows of splats k0..k0+STEP-1.
__device__ __forceinline__ void load_step(float (&g)[N_ROWS][STEP], const float* __restrict__ tf,
                                          int K, int k0) {
#pragma unroll
  for (int r = 0; r < N_ROWS; ++r)
#pragma unroll
    for (int q = 0; q < STEP; q += 4)
      *reinterpret_cast<float4*>(g[r] + q) =
          __ldg(reinterpret_cast<const float4*>(tf + r * K + k0 + q));
}

// Splats k0..k0+STEP-1 (rows in `g`, the first `count` of the tile live)
// over a lane's PPT pixels. Log T is carried in base 2 with the
// transcendentals.
template <bool TRANSCEND>
__device__ __forceinline__ void run_step(const float (&g)[N_ROWS][STEP], int k0, int count,
                                         const float (&px)[PPT], float py, float (&lt)[PPT],
                                         float (&acc)[PPT][N_ACCUM]) {
#pragma unroll
  for (int b = 0; b < STEP; ++b) {
    const float mx = g[0][b], cb = g[3][b];
    const float ha = -0.5f * g[2][b], hc = -0.5f * g[4][b];  // exact
    const float op = k0 + b < count ? g[5][b] : 0.f;
    const float dy = __fsub_rn(py, g[1][b]);
    const float u = __fmul_rn(__fmul_rn(hc, dy), dy);  // -0.5 cc dy dy
#pragma unroll
    for (int j = 0; j < PPT; ++j) {
      const float dx = __fsub_rn(px[j], mx);
      const float s = __fadd_rn(__fmul_rn(__fmul_rn(ha, dx), dx), u);
      const float power = __fsub_rn(s, __fmul_rn(__fmul_rn(cb, dx), dy));
      float a, l, w;
      if constexpr (TRANSCEND) {
        a = fminf(ALPHA_MAX, __fmul_rn(op, ex2(__fmul_rn(power, LOG2_E))));
        const bool keep = power <= 0.f && a >= ALPHA_MIN;
        a = keep ? a : 0.f;
        l = keep ? lg2(__fsub_rn(1.f, a)) : 0.f;
        w = __fmul_rn(a, ex2(lt[j]));
      } else {
        a = fminf(ALPHA_MAX, op * (1.0f + power + 0.5f * power * power));
        a = (power <= 0.f && a >= ALPHA_MIN) ? a : 0.f;
        l = -a - 0.5f * a * a;
        w = a * (1.0f + lt[j] + 0.5f * lt[j] * lt[j]);
      }
#pragma unroll
      for (int c = 0; c < N_ACCUM; ++c) acc[j][c] = fmaf(g[6 + c][b], w, acc[j][c]);
      lt[j] += l;
    }
  }
}

// One unit: the pixels (row0 + j) * TILE_W + col, j < PPT, of the tile whose
// features start at `tf`, over its first `n` splats (whole granules), the
// first `count` live.
template <bool TRANSCEND>
__device__ __forceinline__ void hot_loop_unit(const float* __restrict__ tf, int count, int n,
                                              int K, int col, int row0,
                                              float* __restrict__ acc_o,
                                              float* __restrict__ lt_o) {
  float px[PPT], lt[PPT], acc[PPT][N_ACCUM];
#pragma unroll
  for (int j = 0; j < PPT; ++j) {
    px[j] = static_cast<float>((row0 + j) * TILE_W + col);
    lt[j] = 0.f;
#pragma unroll
    for (int c = 0; c < N_ACCUM; ++c) acc[j][c] = 0.f;
  }
  const float py = static_cast<float>(col) * 0.1f;

  // two steps a turn, each step's rows loaded during the other's arithmetic
  // (n is a multiple of 2 STEP)
  float ga[N_ROWS][STEP], gb[N_ROWS][STEP];
  if (n > 0) load_step(ga, tf, K, 0);
#pragma unroll 1
  for (int k0 = 0; k0 < n; k0 += 2 * STEP) {
    load_step(gb, tf, K, k0 + STEP);
    run_step<TRANSCEND>(ga, k0, count, px, py, lt, acc);
    if (k0 + 2 * STEP < n) load_step(ga, tf, K, k0 + 2 * STEP);
    run_step<TRANSCEND>(gb, k0 + STEP, count, px, py, lt, acc);
  }

#pragma unroll
  for (int j = 0; j < PPT; ++j) {
    const int p = (row0 + j) * TILE_W + col;
#pragma unroll
    for (int c = 0; c < N_ACCUM; ++c) acc_o[c * P + p] = acc[j][c];
    lt_o[p] = TRANSCEND ? lt[j] * LN_2 : lt[j];
  }
}

// Persistent: each warp takes units from `next_unit` (0 at the launch) until
// none is left. Units run in the order of their tiles' granules, most first,
// so that the last ones taken are the shortest.
template <bool TRANSCEND, int SUB>
__global__ void __launch_bounds__(WARPS * 32)
    hot_loop_kernel(const float* __restrict__ feats, const int* __restrict__ counts,
                    float* __restrict__ accum, float* __restrict__ logt, int T, int K,
                    int* __restrict__ next_unit) {
  extern __shared__ int order[];  // T tile ids, most granules first
  int* bucket = order + T;        // K / SUB + 1 counters, one a granule count
  const int tid = threadIdx.x, lane = tid & 31, nb = K / SUB + 1;
  for (int i = tid; i < nb; i += blockDim.x) bucket[i] = 0;
  __syncthreads();
  for (int t = tid; t < T; t += blockDim.x) atomicAdd(&bucket[granules(counts[t], K, SUB)], 1);
  __syncthreads();
  if (tid == 0) {  // bucket g starts after every tile with more granules
    int start = 0;
    for (int g = nb - 1; g >= 0; --g) {
      const int n = bucket[g];
      bucket[g] = start;
      start += n;
    }
  }
  __syncthreads();
  // a stable counting sort by one warp, 32 tiles a round, so that every
  // block holds the same order: a unit names the same tile in all of them
  if (tid < 32) {
    for (int t0 = 0; t0 < T; t0 += 32) {
      const int t = t0 + lane;
      const int g = t < T ? granules(counts[t], K, SUB) : -1;
      const unsigned peers = __match_any_sync(FULL, g);
      const int base = t < T ? bucket[g] : 0;
      __syncwarp();
      if (t < T) {
        order[base + __popc(peers & ((1u << lane) - 1))] = t;
        if (lane == __ffs(peers) - 1) bucket[g] = base + __popc(peers);
      }
      __syncwarp();
    }
  }
  __syncthreads();

  const int n_units = T * UNITS_A_TILE;
  for (;;) {
    int unit = 0;
    if (lane == 0) unit = atomicAdd(next_unit, 1);
    unit = __shfl_sync(FULL, unit, 0);
    if (unit >= n_units) break;
    const int t = order[unit / UNITS_A_TILE], r = unit % UNITS_A_TILE;
    const int count = min(max(counts[t], 0), K);
    hot_loop_unit<TRANSCEND>(feats + static_cast<size_t>(t) * FEAT_DIM * K, count,
                             granules(count, K, SUB) * SUB, K, (r % COL_GROUPS) * 32 + lane,
                             (r / COL_GROUPS) * PPT,
                             accum + static_cast<size_t>(t) * N_ACCUM * P,
                             logt + static_cast<size_t>(t) * P);
  }
}

__global__ void roll_kernel(const float* __restrict__ x, const int* __restrict__ shift,
                            float* __restrict__ out, int R, int W) {
  __shared__ int s_block;
  if (threadIdx.x == 0) {
    const int s = shift[0] % W;  // np.roll's rule: any integer shift, modulo the width
    s_block = s < 0 ? s + W : s;
  }
  __syncthreads();
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= W) return;
  const int d = c + s_block < W ? c + s_block : c + s_block - W;
  for (int r = blockIdx.y; r < R; r += gridDim.y) {
    const size_t row = static_cast<size_t>(r) * W;
    out[row + d] = x[row + c];
  }
}

// Does nothing: its device time is the floor of any launch on this path.
__global__ void empty_kernel() {}

template <bool TRANSCEND, int SUB>
cudaError_t launch_hot_loop(const float* feats, const int* counts, float* accum, float* logt,
                            int* next_unit, int T, int K, cudaStream_t s) {
  auto kernel = hot_loop_kernel<TRANSCEND, SUB>;
  const size_t smem = (T + K / SUB + 1) * sizeof(int);
  int dev = 0, sms = 0, resident = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, kernel, WARPS * 32, smem);
  if (err != cudaSuccess) return err;
  if (resident < 1) return cudaErrorLaunchOutOfResources;
  err = cudaMemsetAsync(next_unit, 0, sizeof(int), s);
  if (err != cudaSuccess) return err;
  kernel<<<sms * min(resident, BLOCKS_A_SM), WARPS * 32, smem, s>>>(feats, counts, accum, logt,
                                                                   T, K, next_unit);
  return cudaGetLastError();
}

template <bool TRANSCEND>
cudaError_t launch_hot_loop(const float* feats, const int* counts, float* accum, float* logt,
                            int* next_unit, int T, int K, int sub, cudaStream_t s) {
  switch (sub) {
    case 64:
      return launch_hot_loop<TRANSCEND, 64>(feats, counts, accum, logt, next_unit, T, K, s);
    case 128:
      return launch_hot_loop<TRANSCEND, 128>(feats, counts, accum, logt, next_unit, T, K, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

const char* gsdx_probes_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// feats (T, 16, K) f32 (16-byte aligned), counts (T,) i32 -> accum (T, 4,
// 2048), logt (T, 1, 2048) f32; next_unit (1,) i32 scratch. K a multiple of
// sub (64 or 128), T at most 8192. Returns a cudaError_t code: 0 when the
// launch was accepted.
int gsdx_probe_hot_loop(const float* feats, const int* counts, float* accum, float* logt,
                        int* next_unit, int T, int K, int sub, int transcend, void* stream) {
  if (T == 0) return 0;
  if (T < 0 || T > MAX_T || sub <= 0 || K % sub) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      transcend ? launch_hot_loop<true>(feats, counts, accum, logt, next_unit, T, K, sub, s)
                : launch_hot_loop<false>(feats, counts, accum, logt, next_unit, T, K, sub, s));
}

// out[r, (c + shift) mod W] = x[r, c] for x (R, W) f32, shift (1,) i32 on the
// device.
int gsdx_probe_roll(const float* x, const int* shift, float* out, int R, int W, void* stream) {
  if (R == 0 || W == 0) return 0;
  const dim3 grid((W + 255) / 256, min(R, 65535));
  roll_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(x, shift, out, R, W);
  return static_cast<int>(cudaGetLastError());
}

// One launch of a kernel that does nothing: the launch floor.
int gsdx_probe_empty(void* stream) {
  empty_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
