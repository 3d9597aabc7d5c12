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
// What bounds it on this card: operations, then the epilogue's bytes. At
// the edge products of the rope chunk (M 63,000, N = K = 512) one call does
// 33 GFLOP (0.033 ms at 989 TFLOP/s) and moves 64.5 MB of bf16 X and 64.5 MB
// of bf16 Y (0.039 ms at 3.35 TB/s); an f32 output or residual adds
// 0.02-0.04 ms of bytes. The weights (0.5 MB) stay in L2.
//
// Design: a persistent, warp-specialised kernel.
//   * one block an SM (the grid is the SM count, or the tiles if fewer),
//     walking output tiles in M-major order with a stride of the grid, so
//     that the blocks running at once share their M blocks' X tiles in L2;
//   * one producer warpgroup (one thread issues the TMA loads) and two
//     consumer warpgroups, `setmaxnreg` 40 and 232; ptxas compiles every
//     path to the launch bound's 168 registers a thread;
//   * 128x256 tiles where N allows it: each consumer warpgroup multiplies
//     64 rows by `wgmma.mma_async` m64n256k16 into 128 f32 accumulators a
//     thread, which halves the shared-memory and L2 reads of X per flop
//     against 128x128 tiles. `gsdx_gnn_gemm` takes 128x128 tiles where N is
//     not a multiple of 256, where the last wave of wide tiles would idle
//     more SMs than narrow ones (`pick_bn`), and for residuals;
//   * one ring of 128x64 X and BNx64 Wt stages (TMA, 128B swizzle, 192 KB)
//     that runs on across tiles: the producer loads the next tile's stages
//     while the consumers run this tile's epilogue, and a consumer hands
//     each stage back as soon as its products are done;
//   * an epilogue staged through shared memory: each consumer adds the bias
//     and applies the ReLU in its registers, writes 64-row pieces (64 bf16
//     or 32 f32 columns, 128B-swizzled, two buffers of 8 KB taking turns)
//     and one thread stores each piece with a TMA bulk tensor store; bf16
//     and f32 outputs each have their own tensor map, and TMA clips the rows
//     past M and the columns past N. Launches with residuals (the rounds'
//     aggregate product) store from the registers instead, their R1 and R2
//     read half a chunk at a time;
//   * ragged M (63,000 edge rows): TMA fills rows past M with zeros. N = 8
//     (the motion head) reads a weight copy padded to 128 rows.
// The K sum runs in ascending K in 16-deep wgmma steps, as the 128x128
// kernel before it did, so every tile shape and epilogue gives the same
// bits. The knobs below select variants for tools/gnn_gemm_ablation.py,
// which builds this file with each changed and times them.
//
// What holds it above the bound (the ablation, NVIDIA H100): the main loop
// alone runs at ~760 TFLOP/s; the epilogue is not hidden under the next
// tile's products, since the ring holds only half a wide tile's stages.
// Ping-pong consumers (each its own 64-row tiles, one's epilogue under the
// other's products) read Wt once per 64 rows and were no faster, and
// sharing Wt over a cluster of 2 by TMA multicast gained nothing (L2 is
// not the limit): both were tried and removed. The epilogue is
// straight-line code run once a tile, so its length costs instruction-
// cache misses: every line of it counts.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

namespace {

// Variant knobs (tools/gnn_gemm_ablation.py rewrites these lines). Each
// selects code the shipped launches run: the register epilogue is the
// residual launches', and a block a tile changes only the grid.
constexpr int RING_BYTES = 192 * 1024;  // shared memory of the load ring
constexpr bool TMA_STORE = true;        // epilogue through shared memory and TMA
constexpr bool PERSISTENT = true;       // one block an SM; else one a tile
constexpr int FORCE_BN = 0;             // 0: `pick_bn`; 128 or 256: that width

constexpr int BK = 64;  // depth of a stage: 128 bytes of bf16, one swizzle row
constexpr int CONSUMERS = 2;
constexpr int THREADS = (CONSUMERS + 1) * 128;  // + one producer warpgroup
constexpr int BM = CONSUMERS * 64;              // rows of a tile
constexpr int TILE_A = BM * BK * 2;             // bytes
constexpr int PIECE = 64 * 128;                 // one staged output piece
constexpr int OUT_BYTES = CONSUMERS * 2 * PIECE;
// warps that hand a stage back: each consumer warp reading it
constexpr int EMPTY_ARRIVALS = CONSUMERS * 4;
constexpr int ENCODE_FAILED = 100001;  // error code of a refused tensor map
constexpr int SMEM_LIMIT = 232448;

template <int BN>
struct Tile {
  static constexpr int B = BN * BK * 2;  // bytes of a Wt stage
  static constexpr int STAGES = RING_BYTES / (TILE_A + B);
  static constexpr int RING = STAGES * (TILE_A + B);
  static constexpr int SMEM = RING + OUT_BYTES + 2 * STAGES * 8 + 1024;
  static_assert(STAGES >= 2 && SMEM <= SMEM_LIMIT, "ring does not fit");
};

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
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, unsigned parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
      "selp.u32 %0, 1, 0, P1;\n"
      "}\n"
      : "=r"(done)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return done;
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Returns once the barrier's phase of this parity has completed. A wait of
// more than 2 s traps: a launch that cannot finish fails instead of
// holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  if (mbar_try_wait(bar, parity)) return;
  const uint64_t t0 = global_ns();
  while (!mbar_try_wait(bar, parity))
    if (global_ns() - t0 > 2000000000ull) __trap();
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

// A shared-memory piece to global memory through a tensor map (c0 the
// column); rows and columns outside the map's extent are not written.
__device__ __forceinline__ void tma_store(const CUtensorMap* map, const void* src,
                                          int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// Until at most N of this thread's bulk stores still read shared memory.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 128;" ::"r"(id) : "memory");
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
template <int R>
__device__ __forceinline__ void fence_accumulators(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int BN>
__device__ __forceinline__ void wgmma(float (&d)[BN / 2], uint64_t da, uint64_t db);

// D (64x128, f32) += A (64x16, bf16) B (16x128, bf16), both from shared
// memory, both K-major.
template <>
__device__ __forceinline__ void wgmma<128>(float (&d)[64], uint64_t da, uint64_t db) {
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
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// D (64x256, f32) += A (64x16, bf16) B (16x256, bf16), both from shared
// memory, both K-major.
template <>
__device__ __forceinline__ void wgmma<256>(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]),
        "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]),
        "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]),
        "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]),
        "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

struct Epilogue {
  const float* bias;
  const float* R1;
  const float* R2;
  float* Yf;
  __nv_bfloat16* Yb;
  int M, N, relu;
};

// act(acc + bias) of a thread's two columns of one row (no residuals).
__device__ __forceinline__ float2 finish(float a0, float a1, float2 bb, int relu) {
  float v0 = a0 + bb.x, v1 = a1 + bb.y;
  if (relu) {
    v0 = fmaxf(v0, 0.f);
    v1 = fmaxf(v1, 0.f);
  }
  return make_float2(v0, v1);
}

// The bias of a thread's eight column pairs 8jj + 2(lane%4) of a 64-column
// chunk (zero past N or without a bias).
__device__ __forceinline__ void chunk_bias(float2 (&bb)[8], const Epilogue& ep, int cbase,
                                           int q) {
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
    const int col = cbase + 8 * jj + 2 * q;
    bb[jj] = ep.bias && col < ep.N ? __ldg(reinterpret_cast<const float2*>(&ep.bias[col]))
                                   : make_float2(0.f, 0.f);
  }
}

__device__ __forceinline__ void st_shared(uint32_t addr, float2 v) {
  asm volatile("st.shared.v2.f32 [%0], {%1, %2};" ::"r"(addr), "f"(v.x), "f"(v.y));
}
__device__ __forceinline__ void st_shared(uint32_t addr, __nv_bfloat162 v) {
  asm volatile("st.shared.b32 [%0], %1;" ::"r"(addr), "r"(*reinterpret_cast<uint32_t*>(&v)));
}

// accumulator layout of m64nNk16: warp w of the warpgroup holds rows
// 16w + lane/4 (+8); d[4j .. 4j+3] are columns 8j + 2(lane%4) (+1) of
// those two rows.

// The epilogue through shared memory, in 64-row pieces of 128 bytes a row
// (32 f32 or 64 bf16 columns), 128B-swizzled as the tensor maps expect:
// each thread finishes its values of a piece from the accumulators into
// one of ``out``'s two buffers, and one thread stores the piece with TMA.
// ``piece`` counts the pieces this warpgroup has staged, across tiles: a
// buffer is written again only once the store from it two pieces earlier
// has read it. With both outputs each value is finished twice. This code
// runs once a tile, straight through (the accumulators' indices must be
// constants), so it is kept short: it is read from the instruction cache
// on every tile, and a long epilogue costs more there than it computes.
template <int BN>
__device__ __forceinline__ void epilogue_tma(const float (&d)[BN / 2], int row0, int n0,
                                             const Epilogue& ep, const CUtensorMap* map_yf,
                                             const CUtensorMap* map_yb, uint8_t* out,
                                             int bar_id, int& piece) {
  const int t = threadIdx.x % 128, lane = t % 32, q = lane % 4, rr = lane / 4;
  const int r_local = (t / 32) * 16 + rr;  // and r_local + 8
  const uint32_t out_u32 = smem_u32(out) + r_local * 128;
  auto begin = [&]() -> uint32_t { return (piece & 1) * PIECE; };
  // the piece's writes reach the async proxy; the store issued one piece
  // earlier has read the other buffer (its thread waits before the
  // barrier), so the next piece may write there at once. (Four buffers,
  // a whole tile's bf16 pieces, gained nothing: the stores do not wait.)
  auto finish_piece = [&](const CUtensorMap* map, uint32_t buf, int col) {
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    if (t == 0) bulk_wait_read<0>();
    named_sync(bar_id);
    if (t == 0) tma_store(map, out + buf, col, row0);
    ++piece;
  };
#pragma unroll
  for (int k = 0; k < BN / 64; ++k) {
    const int cbase = n0 + 64 * k;
    if (cbase >= ep.N) break;
    float2 bb[8];
    chunk_bias(bb, ep, cbase, q);
    if (ep.Yf) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        if (cbase + 32 * hf >= ep.N) break;
        const uint32_t buf = begin();
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int j = 8 * k + 4 * hf + jj;
          const uint32_t at = out_u32 + buf + (((2 * jj + (q >> 1)) ^ rr) << 4) + 8 * (q & 1);
#pragma unroll
          for (int h = 0; h < 2; ++h)
            st_shared(at + h * 8 * 128, finish(d[4 * j + 2 * h], d[4 * j + 2 * h + 1],
                                               bb[4 * hf + jj], ep.relu));
        }
        finish_piece(map_yf, buf, cbase + 32 * hf);
      }
    }
    if (ep.Yb) {
      const uint32_t buf = begin();
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int j = 8 * k + jj;
        const uint32_t at = out_u32 + buf + ((jj ^ rr) << 4) + 4 * q;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float2 v = finish(d[4 * j + 2 * h], d[4 * j + 2 * h + 1], bb[jj], ep.relu);
          st_shared(at + h * 8 * 128, __floats2bfloat162_rn(v.x, v.y));
        }
      }
      finish_piece(map_yb, buf, cbase);
    }
  }
}

// The epilogue from the registers: each thread stores its float2 or bf16x2
// pieces, eight rows apart. With residuals, half a chunk's R1 and R2 values
// (16 float2) are loaded before any of them is added, so that their
// latencies overlap. (Keeping the next half's in flight as well, or the
// first half's through the main loop, spills and is slower.)
template <int BN, bool RES>
__device__ __forceinline__ void epilogue_registers(const float (&d)[BN / 2], int row0,
                                                   int n0, const Epilogue& ep) {
  const int t = threadIdx.x % 128, q = t % 4;
  const int rowa = row0 + (t / 32) * 16 + (t % 32) / 4;
#pragma unroll
  for (int k = 0; k < BN / 64; ++k) {
    const int cbase = n0 + 64 * k;
    if (cbase >= ep.N) break;
    float2 bb[8];
    chunk_bias(bb, ep, cbase, q);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float2 r1[4][2], r2[4][2];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = rowa + 8 * h, col = cbase + 8 * (4 * hh + jj) + 2 * q;
          const bool in = RES && row < ep.M && col < ep.N;
          const long at = static_cast<long>(row) * ep.N + col;
          r1[jj][h] = in && ep.R1 ? __ldg(reinterpret_cast<const float2*>(&ep.R1[at]))
                                  : make_float2(0.f, 0.f);
          r2[jj][h] = in && ep.R2 ? __ldg(reinterpret_cast<const float2*>(&ep.R2[at]))
                                  : make_float2(0.f, 0.f);
        }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j = 8 * k + 4 * hh + jj, col = cbase + 8 * (4 * hh + jj) + 2 * q;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = rowa + 8 * h;
          // the order the sum has always been taken: acc + bias + R1 + R2
          float v0 = d[4 * j + 2 * h] + bb[4 * hh + jj].x;
          float v1 = d[4 * j + 2 * h + 1] + bb[4 * hh + jj].y;
          if (RES && ep.R1) {
            v0 += r1[jj][h].x;
            v1 += r1[jj][h].y;
          }
          if (RES && ep.R2) {
            v0 += r2[jj][h].x;
            v1 += r2[jj][h].y;
          }
          if (ep.relu) {
            v0 = fmaxf(v0, 0.f);
            v1 = fmaxf(v1, 0.f);
          }
          if (row >= ep.M || col >= ep.N) continue;
          const long at = static_cast<long>(row) * ep.N + col;
          if (ep.Yf) *reinterpret_cast<float2*>(&ep.Yf[at]) = make_float2(v0, v1);
          if (ep.Yb)
            *reinterpret_cast<__nv_bfloat162*>(&ep.Yb[at]) = __floats2bfloat162_rn(v0, v1);
        }
      }
    }
  }
}

template <int BN, bool RES>
__device__ __forceinline__ void epilogue(const float (&d)[BN / 2], int row0, int n0,
                                         const Epilogue& ep, const CUtensorMap* map_yf,
                                         const CUtensorMap* map_yb, uint8_t* out, int bar_id,
                                         int& piece) {
  // one path a kernel, so that only its code is fetched. Residuals take the
  // stores from the registers: through shared memory each value would be
  // finished (and its residuals read) once for each output
  if (RES)
    epilogue_registers<BN, true>(d, row0, n0, ep);
  else if (TMA_STORE)
    epilogue_tma<BN>(d, row0, n0, ep, map_yf, map_yb, out, bar_id, piece);
  else
    epilogue_registers<BN, false>(d, row0, n0, ep);
}

// RES: the launch has residuals (R1 or R2), and BN is 128: their live
// values would make the 256-wide kernel spill.
template <int BN, bool RES>
__global__ void __launch_bounds__(THREADS, 1)
gnn_gemm_kernel(const __grid_constant__ CUtensorMap map_x,
                const __grid_constant__ CUtensorMap map_w,
                const __grid_constant__ CUtensorMap map_yf,
                const __grid_constant__ CUtensorMap map_yb, const Epilogue ep, int K,
                int m_blocks, int n_blocks) {
  using T = Tile<BN>;
  constexpr int STAGES = T::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* sA = smem;
  uint8_t* sB = smem + STAGES * TILE_A;
  uint8_t* sOut = smem + T::RING;
  uint64_t* full = reinterpret_cast<uint64_t*>(sOut + OUT_BYTES);
  uint64_t* empty = full + STAGES;

  const int kt_count = K / BK;
  const int n_tiles = m_blocks * n_blocks;  // walked M-major
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], EMPTY_ARRIVALS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == CONSUMERS) {  // the producer warpgroup: one thread issues the loads
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == CONSUMERS * 128) {
      int it = 0;  // stages loaded so far: the ring position
      for (int u = blockIdx.x; u < n_tiles; u += gridDim.x) {
        const int m0 = (u / n_blocks) * BM, n0 = (u % n_blocks) * BN;
        for (int kt = 0; kt < kt_count; ++kt, ++it) {
          const int s = it % STAGES;
          mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
          mbar_expect_tx(&full[s], TILE_A + T::B);
          tma_load(sA + s * TILE_A, &map_x, &full[s], kt * BK, m0);
          tma_load(sB + s * T::B, &map_w, &full[s], kt * BK, n0);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int c = wg, t = threadIdx.x % 128;
    uint8_t* out = sOut + c * 2 * PIECE;
    int piece = 0;
    const uint64_t desc_a = smem_desc(sA + c * 64 * BK * 2);  // this consumer's 64 rows
    const uint64_t desc_b = smem_desc(sB);
    int li = 0;  // this block's tiles so far
    for (int u = blockIdx.x; u < n_tiles; u += gridDim.x, ++li) {
      const int it = li * kt_count;  // ring position of the tile's first stage
      const int m0 = (u / n_blocks) * BM, n0 = (u % n_blocks) * BN;
      const int row0 = m0 + 64 * c;
      float d[BN / 2];
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) d[i] = 0.f;
      fence_accumulators(d);
      for (int kt = 0; kt < kt_count; ++kt) {
        const int s = (it + kt) % STAGES;
        mbar_wait(&full[s], ((it + kt) / STAGES) & 1);
        const uint64_t da = desc_a + (s * TILE_A >> 4), db = desc_b + (s * T::B >> 4);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          wgmma<BN>(d, da + (kk * 32 >> 4), db + (kk * 32 >> 4));
        wgmma_commit();
        // the previous stage's products are done: hand its buffers back
        wgmma_wait<1>();
        if (kt > 0 && t % 32 == 0) mbar_arrive(&empty[(it + kt - 1) % STAGES]);
      }
      wgmma_wait<0>();
      fence_accumulators(d);
      if (t % 32 == 0) mbar_arrive(&empty[(it + kt_count - 1) % STAGES]);
      if (!ep.Yf && !ep.Yb) continue;
      epilogue<BN, RES>(d, row0, n0, ep, &map_yf, &map_yb, out, 1 + c, piece);
    }
    // the stores read shared memory until they are done
    if (TMA_STORE && t == 0) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
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

// A (rows, cols) row-major matrix of 2- or 4-byte elements read or written
// in (box_rows, box_cols) tiles, 128B-swizzled (box_cols * elem = 128).
bool tile_map(CUtensorMap* map, const void* ptr, CUtensorMapDataType type, int elem,
              int rows, int cols, int box_rows, int box_cols) {
  const EncodeTiled encode = encoder();
  if (!encode) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * elem};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem_strides[2] = {1, 1};
  return encode(map, type, 2, const_cast<void*>(ptr), dims, strides, box, elem_strides,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// grid, tiles, BM, BN, stages, SMs, TMA store, persistent
constexpr int LAUNCH_FIELDS = 8;
int g_last_launch[LAUNCH_FIELDS] = {0};

int sm_count() {
  static int counts[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (!counts[dev]) cudaDeviceGetAttribute(&counts[dev], cudaDevAttrMultiProcessorCount, dev);
  return counts[dev];
}

// The tile width of a launch without residuals: 256 where N allows it,
// unless the last wave of wide tiles leaves more than one narrow tile's
// round of the SMs idle.
int pick_bn(int M, int N, int sms) {
  if (N % 256) return 128;
  if (FORCE_BN) return FORCE_BN;
  const long m_blocks = (M + BM - 1) / BM;
  const long rounds_wide = (m_blocks * (N / 256) + sms - 1) / sms;
  const long rounds_narrow = (m_blocks * (N / 128) + sms - 1) / sms;
  return 2 * rounds_wide <= rounds_narrow + 1 ? 256 : 128;
}

template <int BN, bool RES>
int launch(const void* X, const void* Wt, int M, int N, int K, const Epilogue& ep,
           int sms, cudaStream_t stream) {
  using T = Tile<BN>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        gnn_gemm_kernel<BN, RES>, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  CUtensorMap map_x, map_w, map_yf = {}, map_yb = {};
  const int w_rows = (N + 127) / 128 * 128;
  if (!tile_map(&map_x, X, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, M, K, BM, BK) ||
      !tile_map(&map_w, Wt, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, w_rows, K, BN, BK) ||
      (ep.Yf && !tile_map(&map_yf, ep.Yf, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, M, N, 64, 32)) ||
      (ep.Yb && !tile_map(&map_yb, ep.Yb, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, M, N, 64, 64)))
    return ENCODE_FAILED;
  const int m_blocks = (M + BM - 1) / BM, n_blocks = (N + BN - 1) / BN;
  const int tiles = m_blocks * n_blocks;
  const int grid = PERSISTENT && tiles > sms ? sms : tiles;
  gnn_gemm_kernel<BN, RES><<<grid, THREADS, T::SMEM, stream>>>(map_x, map_w, map_yf, map_yb,
                                                               ep, K, m_blocks, n_blocks);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rec[LAUNCH_FIELDS] = {grid, tiles, BM, BN, T::STAGES, sms, TMA_STORE, PERSISTENT};
  for (int i = 0; i < LAUNCH_FIELDS; ++i) g_last_launch[i] = rec[i];
  return 0;
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
  const int sms = sm_count();
  if (sms <= 0) return static_cast<int>(cudaErrorNoDevice);
  const Epilogue ep = {bias, R1, R2, Yf, static_cast<__nv_bfloat16*>(Yb), M, N, relu};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (R1 || R2) return launch<128, true>(X, Wt, M, N, K, ep, sms, s);
  return pick_bn(M, N, sms) == 256 ? launch<256, false>(X, Wt, M, N, K, ep, sms, s)
                                          : launch<128, false>(X, Wt, M, N, K, ep, sms, s);
}

// The last accepted launch: grid (blocks), output tiles, tile rows (BM)
// and columns (BN), ring stages, the device's SM count, and whether the
// epilogue stored by TMA and the grid was persistent (1 or 0).
int gsdx_gnn_gemm_last_launch(int* out) {
  for (int i = 0; i < LAUNCH_FIELDS; ++i) out[i] = g_last_launch[i];
  return 0;
}

}  // extern "C"
