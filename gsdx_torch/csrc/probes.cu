// The two probe kernels for NVIDIA Hopper (sm_90a).
//
// 1. `hot_loop_kernel<TRANSCEND, SUB>` replaces the Pallas TPU kernel
//    `_kernel` of benchmarks/probe_transcendental.py (built by its `build`):
//    the tile compositor's hot loop (kernel #1, composite.cu `fwd_kernel`)
//    stripped to its arithmetic, run with its three transcendentals
//    (TRANSCEND = true: expf(power), log1pf(-alpha), expf(log T)) and with
//    the probe's polynomial stand-ins in their place (false: 1 + x + x^2/2
//    for both exps, -a - a^2/2 for the log; 2 mul + 2 add each). The time
//    between the two is what the transcendentals cost. The transcendentals
//    are those of composite.cu under the same nvcc flags (no fast math), so
//    the answer bears on kernel #1.
// 2. `roll_kernel` replaces the Pallas TPU kernel `kern` of
//    benchmarks/probe_dynamic_roll.py: `pltpu.roll(x, shift, axis=1)` with
//    the shift read on the device (the TPU's scalar prefetch).
//
// Plain versions: gsdx_torch/kernels/probes.py `composite_hot_loop_plain`
// and `dynamic_roll_plain`. Built by nvcc into a shared library with a C
// interface and called through ctypes on PyTorch's current stream.
//
// What bounds the hot loop: the operations. Per tile i it walks
// ceil(count_i / SUB) granules of SUB splats with no early stop, and every
// (splat, pixel) pair of them does the same dense work, as on the TPU: the
// falloff, the alpha rules, one log T step and 4 channel FMAs, plus three
// MUFU transcendentals (or 12 flops of stand-ins). A tile's 10 used feature
// rows of the processed prefix are read once and its 5 x 2048 outputs
// written once (~9.4 MB at the probe's shape), far below the arithmetic at
// 3.35 TB/s.
//
// Design: 4 blocks a tile, each thread owning PPT = 2 pixels with their 4
// accumulators and log T in registers. Each granule's 10 rows are staged in
// shared memory and read back as broadcasts. Each pixel adds its log T step
// in splat order, the same function as the TPU's per-granule triangular-
// matmul prefix sum (`_prefix_sum`) up to the order of the sum. SUB is a
// template argument, so the granule count and the staging index divide by a
// constant: a run-time integer division would add MUFU.RCP instructions to
// the polynomial variant, whose SASS must hold none.
//
// The roll moves 2 x 16 KB and is bound by launch latency at the probe's
// shape; one thread an element, coalesced reads and writes.

#include <cuda_runtime.h>

namespace {

constexpr int FEAT_DIM = 16;
constexpr int TILE_W = 128;
constexpr int P = 16 * TILE_W;  // pixels a tile
constexpr int N_ACCUM = 4;
constexpr int N_ROWS = 6 + N_ACCUM;  // mean x, y, conic a, b, c, opacity, 4 channels
constexpr int THREADS = 256;
constexpr int PPT = 2;  // pixels a thread
constexpr int BLOCKS_A_TILE = P / (THREADS * PPT);
constexpr float ALPHA_MIN = 1.0f / 255.0f;
constexpr float ALPHA_MAX = 0.99f;

template <bool TRANSCEND>
__device__ __forceinline__ float exp_or_poly(float x) {
  if constexpr (TRANSCEND) {
    return expf(x);
  } else {
    return 1.0f + x + 0.5f * x * x;
  }
}

// log1p(-a)
template <bool TRANSCEND>
__device__ __forceinline__ float log1m_or_poly(float a) {
  if constexpr (TRANSCEND) {
    return log1pf(-a);
  } else {
    return -a - 0.5f * a * a;
  }
}

template <bool TRANSCEND, int SUB>
__global__ void __launch_bounds__(THREADS)
    hot_loop_kernel(const float* __restrict__ feats, const int* __restrict__ counts,
                    float* __restrict__ accum, float* __restrict__ logt, int K) {
  __shared__ float g[N_ROWS][SUB];
  const int t = blockIdx.x;
  // counts beyond [0, K] are clamped to it, as the plain version does
  const int count = min(max(counts[t], 0), K);
  const float* tf = feats + static_cast<size_t>(t) * FEAT_DIM * K;
  const int p0 = blockIdx.y * THREADS * PPT + threadIdx.x;

  // the probe's own coordinates: px the flat pixel index, py its column / 10
  float px[PPT], py[PPT], lt[PPT], acc[PPT][N_ACCUM];
#pragma unroll
  for (int j = 0; j < PPT; ++j) {
    const int p = p0 + j * THREADS;
    px[j] = static_cast<float>(p);
    py[j] = static_cast<float>(p % TILE_W) * 0.1f;
    lt[j] = 0.f;
#pragma unroll
    for (int c = 0; c < N_ACCUM; ++c) acc[j][c] = 0.f;
  }

  const int granules = (count + SUB - 1) / SUB;
  for (int gi = 0; gi < granules; ++gi) {
    const int k0 = gi * SUB;
    __syncthreads();  // the previous granule's reads are done
    for (int i = threadIdx.x; i < N_ROWS * SUB; i += THREADS)
      g[i / SUB][i % SUB] = tf[(i / SUB) * K + k0 + i % SUB];
    __syncthreads();
#pragma unroll 4
    for (int s = 0; s < SUB; ++s) {
      const float mx = g[0][s], my = g[1][s];
      const float ca = g[2][s], cb = g[3][s], cc = g[4][s], op = g[5][s];
      const bool live = k0 + s < count;
#pragma unroll
      for (int j = 0; j < PPT; ++j) {
        const float dx = px[j] - mx;
        const float dy = py[j] - my;
        const float power = -0.5f * (ca * dx * dx + cc * dy * dy) - cb * dx * dy;
        float a = fminf(ALPHA_MAX, op * exp_or_poly<TRANSCEND>(power));
        a = (power <= 0.f && a >= ALPHA_MIN && live) ? a : 0.f;
        const float l = log1m_or_poly<TRANSCEND>(a);
        const float w = a * exp_or_poly<TRANSCEND>(lt[j]);
#pragma unroll
        for (int c = 0; c < N_ACCUM; ++c) acc[j][c] = fmaf(g[6 + c][s], w, acc[j][c]);
        lt[j] += l;
      }
    }
  }

#pragma unroll
  for (int j = 0; j < PPT; ++j) {
    const int p = p0 + j * THREADS;
#pragma unroll
    for (int c = 0; c < N_ACCUM; ++c)
      accum[(static_cast<size_t>(t) * N_ACCUM + c) * P + p] = acc[j][c];
    logt[static_cast<size_t>(t) * P + p] = lt[j];
  }
}

__global__ void roll_kernel(const float* __restrict__ x, const int* __restrict__ shift,
                            float* __restrict__ out, int R, int W) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= R * W) return;
  const int r = i / W, c = i - r * W;
  int s = shift[0] % W;  // np.roll's rule: any integer shift, modulo the width
  if (s < 0) s += W;
  const int d = c + s < W ? c + s : c + s - W;
  out[r * W + d] = x[i];
}

template <bool TRANSCEND>
cudaError_t launch_hot_loop(const float* feats, const int* counts, float* accum,
                            float* logt, int T, int K, int sub, cudaStream_t s) {
  const dim3 grid(T, BLOCKS_A_TILE);
  switch (sub) {
    case 64:
      hot_loop_kernel<TRANSCEND, 64><<<grid, THREADS, 0, s>>>(feats, counts, accum, logt, K);
      break;
    case 128:
      hot_loop_kernel<TRANSCEND, 128><<<grid, THREADS, 0, s>>>(feats, counts, accum, logt, K);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* gsdx_probes_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// feats (T, 16, K) f32, counts (T,) i32 -> accum (T, 4, 2048), logt (T, 1, 2048)
// f32. K a multiple of sub (64 or 128). Returns a cudaError_t code: 0 when
// the launch was accepted.
int gsdx_probe_hot_loop(const float* feats, const int* counts, float* accum, float* logt,
                        int T, int K, int sub, int transcend, void* stream) {
  if (T == 0) return 0;
  if (sub <= 0 || K % sub) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(transcend
                              ? launch_hot_loop<true>(feats, counts, accum, logt, T, K, sub, s)
                              : launch_hot_loop<false>(feats, counts, accum, logt, T, K, sub, s));
}

// out[r, (c + shift) mod W] = x[r, c] for x (R, W) f32, shift (1,) i32 on the
// device.
int gsdx_probe_roll(const float* x, const int* shift, float* out, int R, int W,
                    void* stream) {
  if (R == 0 || W == 0) return 0;
  const int n = R * W;
  roll_kernel<<<(n + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(x, shift, out,
                                                                            R, W);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
