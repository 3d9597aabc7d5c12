// bf16 tensor-core GEMM of the fused GNN forward for NVIDIA Hopper (sm_90a):
// every product of the interaction network whose depth K is the hidden
// width F (15 a forward: the relation and particle encoders' second and
// third layers, both propagators' encoder blocks, the 3 message rounds'
// receiver/sender and aggregate blocks, the motion head).
//
// Replaces the products of the Pallas TPU kernel `_gnn_kernel`
// (gsdx/kernels/gnn_forward.py, fused_gnn_forward), which are XLA DEFAULT
// precision dots: one bf16 pass with f32 accumulation. Plain version:
// gsdx_torch/kernels/gnn_forward.py gnn_gemm_plain. Built by nvcc into a
// shared library with a C interface and called through ctypes on
// PyTorch's current stream; the wrapper `gnn_gemm` owns every buffer.
//
//   Y = act(X @ Wt[:N]^T + bias + R1 + R2), X bf16 (M, K) row-major, Wt the
//   weight's K-major bf16 copy (round_up(N, 128), K), f32 accumulation; the
//   epilogue writes Y in f32, in bf16 (round to nearest even), or both.
//
// What bounds it on this card: both, nearly evenly. At the edge products of
// the rope chunk (M 63,000, N = K = 512) one call moves 64.5 MB of bf16 X
// and 64.5 MB of bf16 Y (0.039 ms at 3.35 TB/s) and does 33 GFLOP (0.033
// ms at 989 TFLOP/s); an f32 output or residual adds 0.02-0.04 ms of bytes.
// The weights (0.5 MB) stay in L2.
//
// Design, for each bound:
//   * operations: bf16 `wgmma.mma_async` m64n128k16 from shared memory, two
//     consumer warpgroups of 64 rows each on a 128x128 tile, the f32
//     accumulators in registers. Two blocks fit an SM (97 KB of shared
//     memory and 90 registers a thread each), so four warpgroups take turns
//     on the tensor cores and one block's epilogue overlaps the other's
//     products;
//   * bytes: TMA brings 128x64 tiles of X and Wt, 128B-swizzled, into a
//     3-stage ring guarded by mbarriers; one producer warp keeps the loads
//     in flight while the consumers multiply. Blocks walk N fastest, so the
//     blocks that share an X tile run together and X comes from device
//     memory about once. Activations are bf16 wherever only a product reads
//     them, which halves the traffic of the f32 intermediates;
//   * ragged M (63,000 edge rows): TMA fills rows past M with zeros and the
//     epilogue masks its stores. N = 8 (the motion head) reads a weight
//     copy padded to 128 rows.
// The epilogue adds the f32 bias and residuals, applies the ReLU and stores
// straight from the accumulator registers.
//
// What holds it below both bounds (tools/gnn_gemm_ablation.py): a K = 512
// tile is 8 stages of one 4-instruction wgmma group per warpgroup, so the
// waits and barriers between groups are a large share of a warpgroup's
// time; four warpgroups an SM hide them better than two, a deeper ring does
// not help, and the stores from registers add about a fifth.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;  // rows of a tile: two consumer warpgroups of 64
constexpr int BN = 128;  // columns of a tile: one m64n128k16 per warpgroup
constexpr int BK = 64;   // depth of a stage: 128 bytes of bf16, one swizzle row
constexpr int STAGES = 3;
constexpr int CONSUMERS = 2;
constexpr int THREADS = CONSUMERS * 128 + 32;  // + one producer warp
constexpr int TILE_A = BM * BK * 2;            // bytes
constexpr int TILE_B = BN * BK * 2;
constexpr int SMEM_BYTES = STAGES * (TILE_A + TILE_B) + 2 * STAGES * 8 + 1024;
constexpr int ENCODE_FAILED = 100001;  // error code of a refused tensor map

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

// Returns once the barrier's phase of this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// One tile of a 2-D tensor map into shared memory; completion counts
// against ``bar``'s expected bytes. c0 is the inner (K) coordinate.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major, 128B-swizzled tile whose
// rows are 128 bytes: 8-row groups 1024 bytes apart (the leading offset is
// unused in this layout). The tile base is 1024-byte aligned; a K step of
// 16 elements moves the start address 32 bytes within the swizzled row.
// The start address sits in the low bits in 16-byte units, so moving it is
// adding (bytes >> 4) to the descriptor.
__device__ __forceinline__ uint64_t smem_desc(const void* p) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | (uint64_t(1) << 16) |
         (uint64_t(1024 >> 4) << 32) | (uint64_t(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of the accumulators across
// the asynchronous products.
__device__ __forceinline__ void fence_accumulators(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (64x128, f32) += A (64x16, bf16) B (16x128, bf16), both from shared
// memory, both K-major.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),
        "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
        "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),
        "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]),
        "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]),
        "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__global__ void __launch_bounds__(THREADS, 2)
gnn_gemm_kernel(const __grid_constant__ CUtensorMap map_x,
                const __grid_constant__ CUtensorMap map_w,
                const float* __restrict__ bias, const float* __restrict__ R1,
                const float* __restrict__ R2, float* __restrict__ Yf,
                __nv_bfloat16* __restrict__ Yb, int M, int N, int K, int relu) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  __nv_bfloat16* sA = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sB = reinterpret_cast<__nv_bfloat16*>(smem + STAGES * TILE_A);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * (TILE_A + TILE_B));
  uint64_t* empty = full + STAGES;

  const int kt_count = K / BK;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == CONSUMERS) {  // the producer warp: one thread issues the loads
    if (threadIdx.x == CONSUMERS * 128) {
      for (int kt = 0; kt < kt_count; ++kt) {
        const int s = kt % STAGES;
        mbar_wait(&empty[s], ((kt / STAGES) & 1) ^ 1);
        mbar_expect_tx(&full[s], TILE_A + TILE_B);
        tma_load(sA + s * BM * BK, &map_x, &full[s], kt * BK, m0);
        tma_load(sB + s * BN * BK, &map_w, &full[s], kt * BK, n0);
      }
    }
    return;
  }

  float d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0.f;
  fence_accumulators(d);
  const uint64_t desc_a = smem_desc(sA + wg * 64 * BK), desc_b = smem_desc(sB);
  for (int kt = 0; kt < kt_count; ++kt) {
    const int s = kt % STAGES;
    mbar_wait(&full[s], (kt / STAGES) & 1);
    const uint64_t da = desc_a + (s * TILE_A >> 4), db = desc_b + (s * TILE_B >> 4);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_m64n128k16(d, da + (kk * 32 >> 4), db + (kk * 32 >> 4));
    wgmma_commit();
    // the previous stage's products are done: hand its buffers back
    wgmma_wait<1>();
    if (kt > 0 && threadIdx.x % 128 == 0) mbar_arrive(&empty[(kt - 1) % STAGES]);
  }
  wgmma_wait<0>();
  fence_accumulators(d);

  // accumulator layout of m64nNk16: warp w of the warpgroup holds rows
  // 16w + lane/4 (+8); d[4j .. 4j+3] are columns 8j + 2(lane%4) (+1) of
  // those two rows
  const int t = threadIdx.x % 128;
  const int row0 = m0 + wg * 64 + (t / 32) * 16 + (t % 32) / 4;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = n0 + 8 * j + 2 * (t % 4);
    if (col >= N) continue;  // N is a multiple of 8: col + 1 < N too
    float2 bb = make_float2(0.f, 0.f);
    if (bias) bb = *reinterpret_cast<const float2*>(&bias[col]);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      if (row >= M) continue;
      const long at = static_cast<long>(row) * N + col;
      float v0 = d[4 * j + 2 * h] + bb.x, v1 = d[4 * j + 2 * h + 1] + bb.y;
      if (R1) {
        const float2 r = *reinterpret_cast<const float2*>(&R1[at]);
        v0 += r.x;
        v1 += r.y;
      }
      if (R2) {
        const float2 r = *reinterpret_cast<const float2*>(&R2[at]);
        v0 += r.x;
        v1 += r.y;
      }
      if (relu) {
        v0 = fmaxf(v0, 0.f);
        v1 = fmaxf(v1, 0.f);
      }
      if (Yf) *reinterpret_cast<float2*>(&Yf[at]) = make_float2(v0, v1);
      if (Yb) *reinterpret_cast<__nv_bfloat162*>(&Yb[at]) = __floats2bfloat162_rn(v0, v1);
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, from the libcuda.so.1 that the CUDA runtime loaded.
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (!lib) lib = dlopen("libcuda.so.1", RTLD_NOW);
    if (lib) fn = reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

// A (rows, cols) row-major bf16 matrix read in (box_rows, BK) tiles.
bool bf16_map(CUtensorMap* map, const void* ptr, int rows, int cols, int box_rows) {
  const EncodeTiled encode = encoder();
  if (!encode) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {BK, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr),
                dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

extern "C" {

const char* gsdx_gnn_gemm_error_string(int err) {
  if (err == ENCODE_FAILED) return "cuTensorMapEncodeTiled refused the operands or is missing";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Y (M, N) = act(X (M, K) @ Wt[:N]^T + bias + R1 + R2); Wt holds
// round_up(N, 128) rows of K. bias (N), R1 and R2 (M, N) f32 or null; Yf
// (M, N) f32 and Yb (M, N) bf16 each written unless null. Rows of X, Wt,
// R1, R2 and Y are contiguous. Returns a cudaError_t code: 0 when the
// launch was accepted.
int gsdx_gnn_gemm(const void* X, const void* Wt, int M, int N, int K,
                  const float* bias, const float* R1, const float* R2, float* Yf,
                  void* Yb, int relu, void* stream) {
  if (K <= 0 || K % BK != 0 || N <= 0 || N % 8 != 0 || M < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0) return 0;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        gnn_gemm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  CUtensorMap map_x, map_w;
  const int n_tiles = (N + BN - 1) / BN;
  if (!bf16_map(&map_x, X, M, K, BM) || !bf16_map(&map_w, Wt, n_tiles * BN, K, BN))
    return ENCODE_FAILED;
  const dim3 grid(n_tiles, (M + BM - 1) / BM);
  gnn_gemm_kernel<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      map_x, map_w, bias, R1, R2, Yf, static_cast<__nv_bfloat16*>(Yb), M, N, K, relu);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
