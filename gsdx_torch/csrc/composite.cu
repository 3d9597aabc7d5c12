// Tile compositor kernels for NVIDIA Hopper (sm_90a), forward and backward.
//
// Replaces the Pallas TPU kernels `_fwd_kernel` (gsdx/kernels/composite.py,
// composite_tiles_pallas) and `_bwd_kernel` (composite_tiles_pallas_bwd).
// Plain versions: gsdx_torch/kernels/composite.py composite_tiles_torch and
// its autograd; the culling rule's plain version is `alpha_cut_box` there.
// Built by nvcc into a shared library with a C interface and called through
// ctypes on PyTorch's current stream.
//
// What bounds them on this card: neither is bound by memory. A tile's
// features (16 x K f32) and its pixel block are read once and its outputs
// written once, a few MB per call against 3.35 TB/s. The work is the
// (splat, pixel) pairs whose alpha passes the 1/255 cut: per pair a handful
// of FMAs, exp, log1p and a second exp (and in the backward a division and a
// warp reduction per splat). Two things kept the one-block-per-tile design
// far above that: the scenes put their splats in a few tiles, so a few SMs
// did all the work, and every (splat, pixel) pair of the processed prefix
// paid the falloff and an exp although most fall below the cut.
//
// Design:
//   * each tile is split over a thread-block cluster of C blocks
//     (CLUSTER_BY_TILE_H); block `rank` owns the tile's columns
//     [rank * 128 / C, (rank + 1) * 128 / C), all rows;
//   * each warp owns a (2 PPT) x PATCH_W pixel patch; a thread owns one
//     column and PPT consecutive rows of it (PPT_FWD, PPT_BWD), with its
//     accumulators and log T in registers;
//   * splats arrive in `sub`-wide granules staged in shared memory with
//     cp.async (loading the next granule during the current one measured no
//     faster, PERF.md). After a granule lands, the block computes every
//     splat's alpha-cut box once (`cut_box`), and each warp keeps, by
//     __ballot_sync, only the
//     splats whose box touches its patch. A skipped pair has alpha < 1/255
//     and contributes exactly zero in both passes, so the results do not
//     change;
//   * the tile-wide early stop keeps gsdx's granularity: after each granule
//     every block takes __syncthreads_or, the blocks exchange their flags
//     through distributed shared memory, and all stop after the same
//     granule; rank 0 writes nproc;
//   * with presort, the cluster ranks the columns by (depth, slot) with a
//     count over the K keys, each block a share of the keys, and writes
//     each rank into every block's permutation through distributed shared
//     memory;
//   * the backward walks exactly the forward's min(count, nproc * sub)
//     splats in reverse, rebuilding T_before from the final log T and the
//     per-pixel suffix of log(1 - alpha). A warp reduces a kept splat's
//     per-pixel terms with shuffles (`warp_sum16`) into its own row of
//     per-granule partials; the block sums its warps in a fixed order, and
//     the cluster sums its blocks in rank order through distributed shared
//     memory, each block writing its share of the granule's columns. No
//     atomics: every gradient element is written once, the same on every
//     run;
//   * `tile_ids` (optional) maps a row of the inputs to the global tile
//     whose pixels it covers, as gsdx's kernels read `tile_ids_ref` under
//     shard_map: it sets only the pixel origin (and with it each warp's
//     culling patch); features, counts and outputs stay indexed by the row.
//     A null pointer is the identity.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int FEAT_DIM = 16;
constexpr int TILE_W = 128;
// pixels a thread: one column, PPT rows; a warp's patch is PATCH_W columns
// by 32 / PATCH_W * PPT rows
constexpr int PPT_FWD = 2;
constexpr int PPT_BWD = 2;
constexpr int PATCH_W = 16;
constexpr int MAX_THREADS = 256;
// blocks a tile is split over, for tile_h 8, 16, 24, 32
constexpr int CLUSTER_BY_TILE_H[4] = {4, 8, 8, 8};
constexpr bool CULL = true;  // skip splats whose alpha-cut box misses a patch
constexpr float ALPHA_MIN = 1.0f / 255.0f;
constexpr float ALPHA_MAX = 0.99f;
constexpr float LOG_T_STOP = -9.210340371976182f;
constexpr float SORT_SENTINEL = 1e30f;
// alpha-cut box margins (kernels/composite.py alpha_cut_box is the same rule)
constexpr float LOG_255 = 5.541263545158426f;
constexpr float CUT_COND_SLACK = 1e-5f;  // x a*c/det: f32 rounding of power
constexpr float CUT_ABS_SLACK = 1e-4f;   // exp and the cut's own rounding
constexpr float CUT_REL_MARGIN = 1e-3f;
constexpr float CUT_PX_MARGIN = 1.0f;
constexpr unsigned FULL = 0xffffffffu;

template <int PPT>
__host__ __device__ constexpr int patch_h() { return 32 / PATCH_W * PPT; }
static_assert(8 % patch_h<PPT_FWD>() == 0 && 8 % patch_h<PPT_BWD>() == 0,
              "a warp's patch divides 8 rows: tile_h is a multiple of 8");

// The splat's exponent at (dx, dy) in the plain version's order and
// rounding (kernels/composite.py `_composite_batch`, gsdx's formula): each
// product and sum rounded on its own. nvcc contracts a plain expression into
// FMAs, whose power parts from the plain one by an ulp in about a quarter of
// the pairs, and an alpha within rounding of 1/255 then falls on the other
// side of the cut. The _rn intrinsics are never contracted, so every power,
// alpha and cut decision is bit-equal to the plain version's on the card
// (both take libdevice's expf).
__device__ __forceinline__ float falloff(float ca, float cb, float cc, float dx, float dy) {
  const float t = __fmul_rn(__fmul_rn(ca, dx), dx);
  const float u = __fmul_rn(__fmul_rn(cc, dy), dy);
  const float s = __fmul_rn(-0.5f, __fadd_rn(t, u));
  return __fsub_rn(s, __fmul_rn(__fmul_rn(cb, dx), dy));
}

// Bounding box (x0, x1, y0, y1) of {pixel : opacity * exp(power) >= 1/255},
// widened against f32 rounding. Opacity below the cut gives an empty box; a
// conic that is not positive definite an unbounded one; a NaN anywhere a NaN
// box, which `box_hits` never culls.
__device__ __forceinline__ float4 cut_box(float op, float mx, float my, float a,
                                          float b, float c) {
  const float inf = __int_as_float(0x7f800000);
  if (op < ALPHA_MIN) return make_float4(inf, -inf, inf, -inf);
  const float det = a * c - b * b;
  if (!(a > 0.f && det > 0.f)) return make_float4(-inf, inf, -inf, inf);
  float L = 2.f * (logf(op) + LOG_255);
  if (L < 0.f) L = 0.f;
  L = L * (1.f + CUT_COND_SLACK * (a * c / det)) + CUT_ABS_SLACK;
  const float hx = sqrtf(L * c / det) * (1.f + CUT_REL_MARGIN) + CUT_PX_MARGIN;
  const float hy = sqrtf(L * a / det) * (1.f + CUT_REL_MARGIN) + CUT_PX_MARGIN;
  return make_float4(mx - hx, mx + hx, my - hy, my + hy);
}

// Whether a box touches the patch of integer pixel coordinates
// [x0, x0 + PATCH_W - 1] x [y0, y0 + patch_h - 1]; a NaN box does.
template <int PPT>
__device__ __forceinline__ bool box_hits(float4 b, float x0, float y0) {
  return !(b.y < x0 || b.x > x0 + (PATCH_W - 1) || b.w < y0 ||
           b.z > y0 + (patch_h<PPT>() - 1));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool zero) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(d), "l"(src), "r"(zero ? 0 : 4) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Copy the granule of columns k0..k0+sub-1 (rows 0..nrow-1, through `perm`
// if given) into `buf`; rows past `count` get zero opacity. Ends with the
// block's barrier.
__device__ __forceinline__ void stage_granule(float* buf, const float* __restrict__ tf,
                                              const int* perm, int K, int k0, int sub,
                                              int nrow, int count) {
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int i = tid; i < nrow * sub; i += nt) {
    const int f = i / sub, s = i - f * sub;
    const int r = k0 + s;
    cp_async4(buf + i, tf + f * K + (perm ? perm[r] : r), f == 5 && r >= count);
  }
  cp_async_wait_all();
  __syncthreads();
}

// The boxes of a granule's first `ns` splats (rows `sub` apart).
__device__ __forceinline__ void compute_boxes(const float* g, float4* box, int sub, int ns) {
  for (int s = threadIdx.x; s < ns; s += blockDim.x)
    box[s] = cut_box(g[5 * sub + s], g[s], g[sub + s], g[2 * sub + s], g[3 * sub + s],
                     g[4 * sub + s]);
}

// Splats s0 + lane of a 32-splat word that this warp keeps: those below
// `ns` whose box touches the warp's patch.
template <int PPT>
__device__ __forceinline__ unsigned kept_splats(const float4* box, int s0, int ns,
                                                float x0, float y0) {
  const int s = s0 + (threadIdx.x & 31);
  bool keep = s < ns;
  if constexpr (CULL) keep = keep && box_hits<PPT>(box[s], x0, y0);
  return __ballot_sync(FULL, keep);
}

// One step of `warp_sum16`: lanes with `upper` keep values HALF..2 HALF-1
// and send 0..HALF-1 to the partner lane 2 HALF away, the others the
// reverse; value i then holds the pair's sum of what this lane keeps.
template <int HALF>
__device__ __forceinline__ void warp_sum_step(float (&v)[16], bool upper) {
#pragma unroll
  for (int i = 0; i < HALF; ++i) {
    const float keep = upper ? v[HALF + i] : v[i];
    const float send = upper ? v[i] : v[HALF + i];
    v[i] = keep + __shfl_xor_sync(FULL, send, 2 * HALF);
  }
}

// Sums each of 16 values over the warp with 16 shuffles, where a butterfly
// per value takes 80. Lane l returns the total of value l >> 1. The order
// of the sums is fixed, so the result is the same on every run.
__device__ __forceinline__ float warp_sum16(float (&v)[16]) {
  const int lane = threadIdx.x & 31;
  warp_sum_step<8>(v, lane & 16);
  warp_sum_step<4>(v, lane & 8);
  warp_sum_step<2>(v, lane & 4);
  warp_sum_step<1>(v, lane & 2);
  return v[0] + __shfl_xor_sync(FULL, v[0], 1);
}

// Where this thread's pixels lie: the warp's patch origin in image pixels,
// the thread's column and first row in the tile, and its pixel-centre
// coordinates. `tile` is the global tile id.
struct Pixels {
  float patch_x0, patch_y0, px, py0;
  int col, row0;
};

template <int PPT>
__device__ __forceinline__ Pixels thread_pixels(int tile, int rank, int C, int tiles_x,
                                                int tile_h) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int pcols = TILE_W / C / PATCH_W;  // patches across a block
  const int px0 = rank * (TILE_W / C) + (warp % pcols) * PATCH_W;
  const int py0 = (warp / pcols) * patch_h<PPT>();
  const int ox = (tile % tiles_x) * TILE_W, oy = (tile / tiles_x) * tile_h;
  Pixels p;
  p.col = px0 + lane % PATCH_W;
  p.row0 = py0 + (lane / PATCH_W) * PPT;
  p.patch_x0 = static_cast<float>(ox + px0);
  p.patch_y0 = static_cast<float>(oy + py0);
  p.px = static_cast<float>(ox + p.col);
  p.py0 = static_cast<float>(oy + p.row0);
  return p;
}

template <int NACC, int PPT>
__global__ void __launch_bounds__(MAX_THREADS, 1)
fwd_kernel(const float* __restrict__ feats, const int* __restrict__ counts,
           const int* __restrict__ tile_ids, float* __restrict__ accum_out,
           float* __restrict__ logt_out, int* __restrict__ nproc_out,
           float* __restrict__ rank_out,
           float* __restrict__ sorted_out, int K, int tiles_x, int tile_h,
           int sub, int presort, int early_stop) {
  constexpr int NROW = 6 + NACC;
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  extern __shared__ float4 smem4[];
  float4* box = smem4;                                   // sub
  float* gran = reinterpret_cast<float*>(box + sub);     // NROW x sub
  float* keys = gran + NROW * sub;                       // K
  int* perm = reinterpret_cast<int*>(keys + K);          // K
  int* flags = perm + K;                                 // 2

  const int tile = blockIdx.x / C, tid = threadIdx.x, nt = blockDim.x;
  const int P = tile_h * TILE_W;
  const int count = counts[tile];
  const float* tf = feats + static_cast<size_t>(tile) * FEAT_DIM * K;
  float* acc_o = accum_out + static_cast<size_t>(tile) * NACC * P;
  float* lt_o = logt_out + static_cast<size_t>(tile) * P;
  const Pixels pix =
      thread_pixels<PPT>(tile_ids ? tile_ids[tile] : tile, rank, C, tiles_x, tile_h);
  // this block's share of tile-wide work, spread over the cluster
  const int share0 = rank * nt + tid, share_step = C * nt;

  if (count <= 0) {  // the same in every block of the cluster: no barrier
#pragma unroll
    for (int j = 0; j < PPT; ++j) {
      const int p = (pix.row0 + j) * TILE_W + pix.col;
      lt_o[p] = 0.f;
#pragma unroll
      for (int c = 0; c < NACC; ++c) acc_o[c * P + p] = 0.f;
    }
    if (rank == 0 && tid == 0) nproc_out[tile] = 0;
    if (presort) {
      for (int i = share0; i < K; i += share_step)
        rank_out[static_cast<size_t>(tile) * K + i] = 0.f;
      float* so = sorted_out + static_cast<size_t>(tile) * FEAT_DIM * K;
      for (int i = share0; i < FEAT_DIM * K; i += share_step) so[i] = 0.f;
    }
    return;
  }

  if (presort) {
    // rank every column by (depth, slot); columns past `count` get the
    // sentinel key and rank count..K-1 in index order
    const float* depth_row = tf + (5 + NACC) * K;
    for (int k = tid; k < K; k += nt) {
      keys[k] = k < count ? depth_row[k] : SORT_SENTINEL;
      perm[k] = k;  // stays a valid index even for keys that never compare
    }
    cluster.sync();
    for (int k = share0; k < K; k += share_step) {
      const float kk = keys[k];
      int r = 0;
      for (int i = 0; i < K; ++i) {
        const float ki = keys[i];
        r += (ki < kk) || (ki == kk && i < k);
      }
      if (r < K)
        for (int d = 0; d < C; ++d) *cluster.map_shared_rank(perm + r, d) = k;
      rank_out[static_cast<size_t>(tile) * K + k] = static_cast<float>(r);
    }
    cluster.sync();
    float* so = sorted_out + static_cast<size_t>(tile) * FEAT_DIM * K;
    for (int i = share0; i < FEAT_DIM * K; i += share_step) {
      const int f = i / K, r = i - f * K;
      so[i] = tf[f * K + perm[r]];
    }
  }
  const int* gperm = presort ? perm : nullptr;

  float lt[PPT];
  float acc[PPT][NACC];
#pragma unroll
  for (int j = 0; j < PPT; ++j) {
    lt[j] = 0.f;
#pragma unroll
    for (int c = 0; c < NACC; ++c) acc[j][c] = 0.f;
  }

  const int nchunks = (count + sub - 1) / sub;
  const float* cur = gran;  // the staged granule
  int nproc = 0;
  for (int g = 0; g < nchunks; ++g) {
    const int k0 = g * sub;
    __syncthreads();  // the previous granule and its boxes are consumed
    stage_granule(gran, tf, gperm, K, k0, sub, NROW, count);
    const int ns = min(sub, count - k0);
    if constexpr (CULL) {
      compute_boxes(cur, box, sub, ns);
      __syncthreads();
    }
    for (int s0 = 0; s0 < ns; s0 += 32) {
      unsigned kept = kept_splats<PPT>(box, s0, ns, pix.patch_x0, pix.patch_y0);
      while (kept) {
        const int s = s0 + __ffs(kept) - 1;
        kept &= kept - 1;
        const float op = cur[5 * sub + s];
        if (op == 0.f) continue;
        const float mx = cur[s], my = cur[sub + s];
        const float ca = cur[2 * sub + s], cb = cur[3 * sub + s];
        const float cc = cur[4 * sub + s];
        float col[NACC];
#pragma unroll
        for (int c = 0; c < NACC; ++c) col[c] = cur[(6 + c) * sub + s];
        const float dx = pix.px - mx;
#pragma unroll
        for (int j = 0; j < PPT; ++j) {
          const float dy = pix.py0 + static_cast<float>(j) - my;
          const float power = falloff(ca, cb, cc, dx, dy);
          if (power > 0.f) continue;
          const float a = fminf(ALPHA_MAX, __fmul_rn(op, expf(power)));
          if (!(a >= ALPHA_MIN)) continue;
          const float w = a * expf(lt[j]);
#pragma unroll
          for (int c = 0; c < NACC; ++c) acc[j][c] = fmaf(w, col[c], acc[j][c]);
          lt[j] += log1pf(-a);
        }
      }
    }
    nproc = g + 1;
    if (early_stop) {
      int live = 0;
#pragma unroll
      for (int j = 0; j < PPT; ++j) live |= lt[j] >= LOG_T_STOP;
      live = __syncthreads_or(live);
      // every block stops after the same granule: OR of the blocks' flags,
      // double-buffered so that one cluster barrier a granule orders each
      // write before the reads of it and after the last ones
      if (tid == 0) flags[g & 1] = live;
      cluster.sync();
      live = 0;
      for (int d = 0; d < C; ++d) live |= *cluster.map_shared_rank(flags + (g & 1), d);
      if (!live) break;
    }
  }

#pragma unroll
  for (int j = 0; j < PPT; ++j) {
    const int p = (pix.row0 + j) * TILE_W + pix.col;
    lt_o[p] = lt[j];
#pragma unroll
    for (int c = 0; c < NACC; ++c) acc_o[c * P + p] = acc[j][c];
  }
  if (rank == 0 && tid == 0) nproc_out[tile] = nproc;
  cluster.sync();  // no block leaves while others read its flags
}

template <int NACC, int PPT>
__global__ void __launch_bounds__(MAX_THREADS, 1)
bwd_kernel(const float* __restrict__ feats, const int* __restrict__ counts,
           const int* __restrict__ tile_ids, const int* __restrict__ nproc_in,
           const float* __restrict__ logt_final,
           const float* __restrict__ g_accum, const float* __restrict__ g_logt,
           const float* __restrict__ rank_in, float* __restrict__ grad, int K,
           int tiles_x, int tile_h, int sub, int presort) {
  constexpr int NV = 6 + NACC;  // gradient rows that can be nonzero
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, nt = blockDim.x;
  const int nwarps = nt / 32, lane = tid & 31, warp = tid / 32;
  extern __shared__ float4 smem4[];
  float4* box = smem4;                                  // sub
  float* gran = reinterpret_cast<float*>(box + sub);    // NV x sub
  float* partial = gran + NV * sub;                     // nwarps x sub x NV
  float* bpart = partial + nwarps * sub * NV;           // 2 x sub x NV
  int* perm = reinterpret_cast<int*>(bpart + 2 * sub * NV);  // K

  const int tile = blockIdx.x / C;
  const int P = tile_h * TILE_W;
  const int count_eff = min(counts[tile], nproc_in[tile] * sub);
  const float* tf = feats + static_cast<size_t>(tile) * FEAT_DIM * K;
  float* go = grad + static_cast<size_t>(tile) * FEAT_DIM * K;
  const int share0 = rank * nt + tid, share_step = C * nt;

  if (count_eff <= 0) {  // the same in every block of the cluster
    for (int i = share0; i < FEAT_DIM * K; i += share_step) go[i] = 0.f;
    return;
  }
  for (int k = tid; k < K; k += nt) perm[k] = k;
  if (presort) {
    // sorted position -> input column, from the forward's rank
    __syncthreads();
    const float* rk = rank_in + static_cast<size_t>(tile) * K;
    for (int k = tid; k < K; k += nt) {
      const int r = static_cast<int>(rk[k]);
      if (r >= 0 && r < K) perm[r] = k;
    }
  }
  __syncthreads();

  const int ngran = (count_eff + sub - 1) / sub;
  const int kdone = ngran * sub;
  // rows no splat can touch, and sorted positions the walk never reaches
  for (int i = share0; i < FEAT_DIM * K; i += share_step) {
    const int f = i / K, r = i - f * K;
    if (f >= NV || r >= kdone) go[f * K + perm[r]] = 0.f;
  }

  const Pixels pix =
      thread_pixels<PPT>(tile_ids ? tile_ids[tile] : tile, rank, C, tiles_x, tile_h);
  float ltf[PPT], glt[PPT], s_after[PPT], b_after[PPT];
  float gacc[PPT][NACC];
#pragma unroll
  for (int j = 0; j < PPT; ++j) {
    const size_t p = static_cast<size_t>(tile) * P + (pix.row0 + j) * TILE_W + pix.col;
    ltf[j] = logt_final[p];
    glt[j] = g_logt[p];
    s_after[j] = 0.f;
    b_after[j] = 0.f;
#pragma unroll
    for (int c = 0; c < NACC; ++c)
      gacc[j][c] = g_accum[(static_cast<size_t>(tile) * NACC + c) * P +
                           (pix.row0 + j) * TILE_W + pix.col];
  }

  // granules in reverse: iteration `it` walks granule ngran - 1 - it
  const float* cur = gran;  // the staged granule
  float* pw = partial + warp * sub * NV;
  for (int it = 0; it < ngran; ++it) {
    const int k0 = (ngran - 1 - it) * sub;
    __syncthreads();  // the previous granule, its boxes and partials are consumed
    stage_granule(gran, tf, nullptr, K, k0, sub, NV, count_eff);
    for (int i = lane; i < sub * NV; i += 32) pw[i] = 0.f;
    if constexpr (CULL) compute_boxes(cur, box, sub, sub);
    __syncthreads();
    for (int s0 = (sub - 1) / 32 * 32; s0 >= 0; s0 -= 32) {
      unsigned kept = kept_splats<PPT>(box, s0, sub, pix.patch_x0, pix.patch_y0);
      while (kept) {
        const int b = 31 - __clz(kept);
        kept &= ~(1u << b);
        const int s = s0 + b;
        const float op = cur[5 * sub + s];
        float v[16];  // NV gradient terms, zero-padded for warp_sum16
#pragma unroll
        for (int q = 0; q < 16; ++q) v[q] = 0.f;
        int any = 0;
        if (op != 0.f) {
          const float mx = cur[s], my = cur[sub + s];
          const float ca = cur[2 * sub + s], cb = cur[3 * sub + s];
          const float cc = cur[4 * sub + s];
          float col[NACC];
#pragma unroll
          for (int c = 0; c < NACC; ++c) col[c] = cur[(6 + c) * sub + s];
          const float dx = pix.px - mx;
#pragma unroll
          for (int j = 0; j < PPT; ++j) {
            const float dy = pix.py0 + static_cast<float>(j) - my;
            const float power = falloff(ca, cb, cc, dx, dy);
            if (power > 0.f) continue;
            const float e = expf(power);
            const float pre = __fmul_rn(op, e);
            const float a = fminf(ALPHA_MAX, pre);
            if (!(a >= ALPHA_MIN)) continue;
            any = 1;
            const float l = log1pf(-a);
            const float tb = expf(ltf[j] - (s_after[j] + l));
            const float w = a * tb;
            float dldw = 0.f;
#pragma unroll
            for (int c = 0; c < NACC; ++c) dldw = fmaf(gacc[j][c], col[c], dldw);
            const float dalpha = tb * dldw - (b_after[j] + glt[j]) / (1.f - a);
            s_after[j] += l;
            b_after[j] = fmaf(w, dldw, b_after[j]);
#pragma unroll
            for (int c = 0; c < NACC; ++c) v[6 + c] = fmaf(w, gacc[j][c], v[6 + c]);
            if (pre <= ALPHA_MAX) {  // unclamped: alpha depends on opacity/power
              const float dpower = dalpha * pre;
              v[0] += dpower * (ca * dx + cb * dy);   // d mean_x
              v[1] += dpower * (cc * dy + cb * dx);   // d mean_y
              v[2] += dpower * (-0.5f * dx * dx);     // d conic_a
              v[3] += dpower * (-dx * dy);            // d conic_b
              v[4] += dpower * (-0.5f * dy * dy);     // d conic_c
              v[5] += dalpha * e;                     // d opacity
            }
          }
        }
        if (__any_sync(FULL, any)) {  // else the warp's partials stay zero
          const float x = warp_sum16(v);
          if (!(lane & 1) && (lane >> 1) < NV) pw[s * NV + (lane >> 1)] = x;
        }
      }
    }
    __syncthreads();
    // the block's sum over its warps, in warp order
    float* bp = bpart + (it & 1) * sub * NV;
    for (int i = tid; i < sub * NV; i += nt) {
      float x = 0.f;
      for (int w = 0; w < nwarps; ++w) x += partial[w * sub * NV + i];
      bp[i] = x;
    }
    // the cluster's sum over its blocks, in rank order, each block writing
    // its share of the granule; `bpart` is double-buffered so one barrier a
    // granule orders the writes and the reads
    cluster.sync();
    for (int i = share0; i < sub * NV; i += share_step) {
      float x = 0.f;
      for (int d = 0; d < C; ++d) x += *cluster.map_shared_rank(bp + i, d);
      const int s = i / NV, q = i - s * NV;
      go[q * K + perm[k0 + s]] = x;
    }
  }
  cluster.sync();  // no block leaves while others read its partials
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// Blocks a tile is split over and threads a block, for a tile height and
// pixels a thread.
bool launch_shape(int tile_h, int ppt, int* cluster, int* threads) {
  if (tile_h < 8 || tile_h > 32 || tile_h % 8) return false;
  const int C = CLUSTER_BY_TILE_H[tile_h / 8 - 1];
  if (C < 1 || TILE_W % (C * PATCH_W)) return false;
  *cluster = C;
  *threads = tile_h / (32 / PATCH_W * ppt) * (TILE_W / C / PATCH_W) * 32;
  return *threads <= MAX_THREADS;
}

// The last launch's cluster size, blocks and threads a block.
int g_last_launch[3] = {0, 0, 0};

// (kernel, threads, shared memory) triples that passed the occupancy check
struct Checked {
  const void* kernel;
  int threads;
  size_t smem;
  int cluster;
};
Checked g_checked[32];
int g_n_checked = 0;

template <typename Kernel, typename... Args>
cudaError_t try_launch(Kernel kernel, int T, int C, int nt, size_t smem, cudaStream_t s,
                       Args... args) {
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(T * C));
  cfg.blockDim = dim3(static_cast<unsigned>(nt));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(C);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // a cluster that cannot be resident (shared memory, threads) is refused,
  // never shrunk
  bool checked = false;
  for (int i = 0; i < g_n_checked && !checked; ++i)
    checked = g_checked[i].kernel == reinterpret_cast<const void*>(kernel) &&
              g_checked[i].threads == nt && g_checked[i].smem == smem &&
              g_checked[i].cluster == C;
  if (!checked) {
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    if (err != cudaSuccess) return err;
    if (clusters < 1) return cudaErrorLaunchOutOfResources;
    if (g_n_checked < 32)
      g_checked[g_n_checked++] = {reinterpret_cast<const void*>(kernel), nt, smem, C};
  }
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  g_last_launch[0] = C;
  g_last_launch[1] = T * C;
  g_last_launch[2] = nt;
  return cudaGetLastError();
}

// Launches T clusters of C blocks, or returns why not. A refused launch
// leaves no error behind for the runtime's next launch check to report.
template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, int T, int C, int nt, size_t smem, cudaStream_t s,
                   Args... args) {
  const cudaError_t err = try_launch(kernel, T, C, nt, smem, s, args...);
  if (err != cudaSuccess) cudaGetLastError();
  return err;
}

}  // namespace

extern "C" {

const char* gsdx_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Cluster size, blocks and threads a block of the last accepted launch.
int gsdx_composite_last_launch(int* out) {
  for (int i = 0; i < 3; ++i) out[i] = g_last_launch[i];
  return 0;
}

// Returns a cudaError_t code: 0 when the launch was accepted. `tile_ids`
// (T,) may be null: row t then covers tile t.
int gsdx_composite_fwd(const float* feats, const int* counts, const int* tile_ids,
                       float* accum, float* logt, int* nproc, float* rank,
                       float* sorted_feats,
                       int T, int K, int tiles_x, int tile_h, int tile_w,
                       int n_accum, int sub, int presort, int early_stop,
                       void* stream) {
  if (T == 0) return 0;
  int C, nt;
  if (tile_w != TILE_W || !launch_shape(tile_h, PPT_FWD, &C, &nt))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sub * sizeof(float4) +
                      ((6 + n_accum) * sub + K) * sizeof(float) +
                      (K + 2) * sizeof(int);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (n_accum) {
    case 4:
      err = launch(fwd_kernel<4, PPT_FWD>, T, C, nt, smem, s, feats, counts, tile_ids, accum,
                   logt, nproc, rank, sorted_feats, K, tiles_x, tile_h, sub, presort,
                   early_stop);
      break;
    case 7:
      err = launch(fwd_kernel<7, PPT_FWD>, T, C, nt, smem, s, feats, counts, tile_ids, accum,
                   logt, nproc, rank, sorted_feats, K, tiles_x, tile_h, sub, presort,
                   early_stop);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

int gsdx_composite_bwd(const float* feats, const int* counts, const int* tile_ids,
                       const int* nproc, const float* logt, const float* g_accum,
                       const float* g_logt,
                       const float* rank, float* grad, int T, int K, int tiles_x,
                       int tile_h, int tile_w, int n_accum, int sub, int presort,
                       void* stream) {
  if (T == 0) return 0;
  int C, nt;
  if (tile_w != TILE_W || !launch_shape(tile_h, PPT_BWD, &C, &nt))
    return static_cast<int>(cudaErrorInvalidValue);
  const int nv = 6 + n_accum;
  const size_t smem = sub * sizeof(float4) +
                      (nv * sub + (nt / 32) * sub * nv + 2 * sub * nv) *
                          sizeof(float) +
                      K * sizeof(int);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (n_accum) {
    case 4:
      err = launch(bwd_kernel<4, PPT_BWD>, T, C, nt, smem, s, feats, counts, tile_ids, nproc,
                   logt, g_accum, g_logt, rank, grad, K, tiles_x, tile_h, sub, presort);
      break;
    case 7:
      err = launch(bwd_kernel<7, PPT_BWD>, T, C, nt, smem, s, feats, counts, tile_ids, nproc,
                   logt, g_accum, g_logt, rank, grad, K, tiles_x, tile_h, sub, presort);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

}  // extern "C"
