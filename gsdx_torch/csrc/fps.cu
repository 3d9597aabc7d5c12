// Greedy farthest-point sampling for NVIDIA Hopper (sm_90a).
//
// Replaces gsdx/kernels/fps.py `farthest_point_sampling` (:24-54) and
// `fps_rad_idx` (:58-97). Those are no Pallas kernels but a `jax.jit`
// around a `lax.fori_loop`: one compiled program, so the greedy loop never
// returns to the host. Here the whole loop is one launch: a row of points
// (B rows at once) is held by one thread-block cluster for all n steps.
// Plain version: gsdx_torch/kernels/fps.py `farthest_point_sampling_batch_plain`
// and `fps_rad_idx_batch_plain`. Built by nvcc into a shared library with a
// C interface and called through ctypes on PyTorch's current stream.
//
// What it computes, exactly gsdx's function (its indices bit for bit):
// dist starts at 1e10 for a valid point and -1e10 for a masked one. Trip i
// writes idx[i] = farthest (and keep[i] = active in radius mode), takes the
// centroid c = points[farthest], folds acc = sum over the coordinates in
// order of fma(p - c, p - c, acc) into dist by fminf, and moves farthest to
// the FIRST index of the largest dist; in radius mode active &= max > r * r
// (r * r rounded in f32, as gsdx). The subtraction and the FMA are the `_rn`
// intrinsics, so that nvcc cannot contract or reorder them: grids tie often,
// and one rounding off moves an argmax. A masked point's dist stays -1e10
// without its mask being read again (min(-1e10, acc >= 0) is -1e10), so
// the mask is read once, when dist is set up.
//
// What bounds it: the n - 1 steps form a serial chain (each step needs the
// previous argmax), and a step's arithmetic is small (3D + 2 operations a
// point: up to 65,536 points a row), so neither the bytes (P * D * 4 read
// once) nor the operations bound it at the slice's shapes: the latency of a
// step does. `gsdx_fps_floor` runs this kernel with the same launch shape,
// steps, barriers and reductions over no points; its time is the floor
// chip_smoke.py measures beside the bytes and operations bounds.
//
// Design:
//   * one cluster of C blocks a row (C = 1 up to 8192 points, up to 8 for
//     65,536), at most 512 threads a block and PPT points a thread (a power
//     of two up to 16), chosen by `launch_shape` from P. A thread keeps its
//     points' coordinates and running distances in registers for the whole
//     loop; the block also copies its points to shared memory once, where
//     the winner's coordinates are read;
//   * a step's argmax compares (value, index), so ties go to the smaller
//     index in any order of reduction: a warp's butterfly of shuffles, then
//     every warp reduces the block's warp candidates from shared memory
//     (double-buffered by step parity, so one __syncthreads a step orders
//     both the writes and the next step's overwrite);
//   * in a cluster, each block publishes its candidate with its coordinates
//     in its own shared memory (again by parity), one barrier.cluster a step,
//     then every warp reads the C candidates through distributed shared
//     memory, one a lane, and takes the winner and its coordinates from the
//     owning lane by shuffle. Every thread of the cluster ends the step with
//     the same farthest index and centroid: no second barrier;
//   * no allocation, no host synchronisation: the wrapper allocates the
//     outputs, and the start indices and radii are read on the device.

#include <climits>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int MAX_THREADS = 512;
constexpr int MAX_PPT = 16;
constexpr int MAX_CLUSTER = 8;  // the portable cluster size
constexpr int BLOCK_POINTS = MAX_THREADS * MAX_PPT;
constexpr int MAX_P = MAX_CLUSTER * BLOCK_POINTS;  // 65,536
constexpr int MAX_D = 4;
constexpr float FPS_INF = 1e10f;  // gsdx's _INF
constexpr unsigned FULL = 0xffffffffu;

// A block's candidate of a step, as its cluster reads it.
struct __align__(16) Candidate {
  float v;
  int i;
  float pad[2];
  float c[MAX_D];
};

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

// (v, i) becomes (ov, oi) if that is larger, or as large with a smaller
// index: the first maximum whatever the order of the comparisons.
__device__ __forceinline__ void take_better(float& v, int& i, float ov, int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

// The best (v, i) of each aligned group of WIDTH lanes, in every lane of it.
template <int WIDTH>
__device__ __forceinline__ void warp_argmax(float& v, int& i) {
#pragma unroll
  for (int off = WIDTH / 2; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(FULL, v, off);
    const int oi = __shfl_xor_sync(FULL, i, off);
    take_better(v, i, ov, oi);
  }
}

struct Args {
  const float* points;          // (B, P, D)
  const long long* start;       // (B,); null: start_value for every row
  int start_value;
  const unsigned char* valid;   // (P,) (stride 0) or (B, P); null: all valid
  int valid_stride;
  const float* radius;          // (B,); null: radius_value for every row
  float radius_value;
  long long* idx;               // (B, n)
  bool* keep;                   // (B, n); null: no radius stop
  int P, n;
  int floor_only;               // the latency floor: no points, same steps
};

template <int D, int PPT>
__global__ void __launch_bounds__(MAX_THREADS, 1) fps_kernel(const Args a) {
  extern __shared__ float s_pts[];  // this block's points, (nt * PPT, D)
  __shared__ float s_val[2][32];
  __shared__ int s_idx[2][32];
  __shared__ Candidate s_cand[2];

  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.y;
  const int nt = blockDim.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, nw = nt >> 5;
  const int pb = nt * PPT;  // points a block
  const int base = rank * pb;
  const float* row = a.points + static_cast<size_t>(b) * a.P * D;
  const unsigned char* vrow = a.valid ? a.valid + static_cast<size_t>(b) * a.valid_stride
                                      : nullptr;

  // point base + k * nt + tid is the thread's k-th: increasing in k, so a
  // thread's strict comparisons keep its first maximum
  float x[PPT][D], dist[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int l = k * nt + tid, g = base + l;
    const bool in = g < a.P;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      x[k][d] = in ? row[g * D + d] : 0.f;
      s_pts[l * D + d] = x[k][d];
    }
    dist[k] = !in ? neg_inf() : (vrow && !vrow[g]) ? -FPS_INF : FPS_INF;
  }
  int far = a.start ? static_cast<int>(a.start[b]) : a.start_value;
  float c[D];
#pragma unroll
  for (int d = 0; d < D; ++d) c[d] = row[far * D + d];
  const bool radius_mode = a.keep != nullptr;
  float r2 = 0.f;
  if (radius_mode) {
    const float r = a.radius ? a.radius[b] : a.radius_value;
    r2 = __fmul_rn(r, r);
  }
  bool active = true;
  const bool writer = rank == 0 && tid == 0;
  long long* out_idx = a.idx + static_cast<size_t>(b) * a.n;
  bool* out_keep = radius_mode ? a.keep + static_cast<size_t>(b) * a.n : nullptr;
  __syncthreads();  // s_pts

  for (int i = 0;; ++i) {
    if (writer) {
      out_idx[i] = far;
      if (radius_mode) out_keep[i] = active;
    }
    if (i == a.n - 1) break;
    float bv = neg_inf();
    int bi = INT_MAX;
    if (a.floor_only) {
      bv = dist[0];
      bi = base + tid;
    } else {
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        float acc = 0.f;
#pragma unroll
        for (int d = 0; d < D; ++d) {
          const float t = __fsub_rn(x[k][d], c[d]);
          acc = __fmaf_rn(t, t, acc);
        }
        dist[k] = fminf(dist[k], acc);
        if (dist[k] > bv) {
          bv = dist[k];
          bi = base + k * nt + tid;
        }
      }
    }
    // the block's argmax: warps, then every warp over the warps' candidates
    warp_argmax<32>(bv, bi);
    const int par = i & 1;
    if (lane == 0) {
      s_val[par][warp] = bv;
      s_idx[par][warp] = bi;
    }
    __syncthreads();
    bv = lane < nw ? s_val[par][lane] : neg_inf();
    bi = lane < nw ? s_idx[par][lane] : INT_MAX;
    warp_argmax<32>(bv, bi);
    if (C == 1) {
      far = bi;
#pragma unroll
      for (int d = 0; d < D; ++d) c[d] = s_pts[far * D + d];
    } else {
      // the cluster's argmax: each block's candidate, read by every warp
      if (tid == 0) {
        Candidate& m = s_cand[par];
        m.v = bv;
        m.i = bi;
#pragma unroll
        for (int d = 0; d < D; ++d) m.c[d] = s_pts[(bi - base) * D + d];
      }
      cluster.sync();
      float v = neg_inf(), cc[D];
      int j = INT_MAX;
      if (lane < C) {
        const Candidate* m = cluster.map_shared_rank(&s_cand[par], lane);
        v = m->v;
        j = m->i;
#pragma unroll
        for (int d = 0; d < D; ++d) cc[d] = m->c[d];
      } else {
#pragma unroll
        for (int d = 0; d < D; ++d) cc[d] = 0.f;
      }
      warp_argmax<MAX_CLUSTER>(v, j);
      bv = __shfl_sync(FULL, v, 0);
      far = __shfl_sync(FULL, j, 0);
      const int owner = far / pb;
#pragma unroll
      for (int d = 0; d < D; ++d) c[d] = __shfl_sync(FULL, cc[d], owner);
    }
    if (radius_mode) active = active && bv > r2;
  }
  if (C > 1) cluster.sync();  // no block leaves while others read its candidates
}

// Blocks a row, points a thread and threads a block for P points.
bool launch_shape(int P, int* cluster, int* ppt, int* threads) {
  if (P < 1 || P > MAX_P) return false;
  const int C = (P + BLOCK_POINTS - 1) / BLOCK_POINTS;
  const int per_block = (P + C - 1) / C;
  int k = 1;
  while (k * MAX_THREADS < per_block) k *= 2;
  *cluster = C;
  *ppt = k;
  *threads = ((per_block + k - 1) / k + 31) / 32 * 32;
  return true;
}

// The last accepted launch's cluster size, blocks, threads a block and
// points a thread.
int g_last_launch[4] = {0, 0, 0, 0};

template <int D, int PPT>
cudaError_t launch_d(const Args& a, int B, int C, int nt, cudaStream_t s) {
  const size_t smem = static_cast<size_t>(nt) * PPT * D * sizeof(float);
  auto kernel = fps_kernel<D, PPT>;
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(C), static_cast<unsigned>(B));
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
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return err;
  g_last_launch[0] = C;
  g_last_launch[1] = C * B;
  g_last_launch[2] = nt;
  g_last_launch[3] = PPT;
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_ppt(const Args& a, int B, int C, int ppt, int nt, cudaStream_t s) {
  switch (ppt) {
    case 1: return launch_d<D, 1>(a, B, C, nt, s);
    case 2: return launch_d<D, 2>(a, B, C, nt, s);
    case 4: return launch_d<D, 4>(a, B, C, nt, s);
    case 8: return launch_d<D, 8>(a, B, C, nt, s);
    case 16: return launch_d<D, 16>(a, B, C, nt, s);
    default: return cudaErrorInvalidValue;
  }
}

// Launches the B rows, or returns why not. A refused launch leaves no error
// behind for the runtime's next launch check to report.
int launch(const Args& a, int B, int D, void* stream) {
  if (B == 0 || a.n == 0) return 0;
  int C, ppt, nt;
  if (B < 0 || B > 65535 || a.n < 0 || !launch_shape(a.P, &C, &ppt, &nt))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (D) {
    case 1: err = launch_ppt<1>(a, B, C, ppt, nt, s); break;
    case 2: err = launch_ppt<2>(a, B, C, ppt, nt, s); break;
    case 3: err = launch_ppt<3>(a, B, C, ppt, nt, s); break;
    case 4: err = launch_ppt<4>(a, B, C, ppt, nt, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) cudaGetLastError();
  return static_cast<int>(err);
}

Args make_args(const float* points, const long long* start, int start_value,
               const unsigned char* valid, int valid_stride, long long* idx, int P, int n) {
  Args a = {};
  a.points = points;
  a.start = start;
  a.start_value = start_value;
  a.valid = valid;
  a.valid_stride = valid_stride;
  a.idx = idx;
  a.P = P;
  a.n = n;
  return a;
}

}  // namespace

extern "C" {

const char* gsdx_fps_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Cluster size, blocks, threads a block and points a thread of the last
// accepted launch.
int gsdx_fps_last_launch(int* out) {
  for (int i = 0; i < 4; ++i) out[i] = g_last_launch[i];
  return 0;
}

// points (B, P, D) f32, D 1-4, P 1-65,536; start (B,) i64, or null and
// start_value for every row; valid (P,) or (B, P) bool (valid_stride 0 or
// P) or null -> idx (B, n) i64. Returns a cudaError_t code: 0 when the
// launch was accepted.
int gsdx_fps(const float* points, const long long* start, int start_value,
             const unsigned char* valid, int valid_stride, long long* idx, int B, int P, int D,
             int n, void* stream) {
  const Args a = make_args(points, start, start_value, valid, valid_stride, idx, P, n);
  return launch(a, B, D, stream);
}

// As gsdx_fps, with the radius stop: radius (B,) f32, or null and
// radius_value for every row -> also keep (B, n) bool.
int gsdx_fps_radius(const float* points, const long long* start, int start_value,
                    const unsigned char* valid, int valid_stride, const float* radius,
                    float radius_value, long long* idx, bool* keep, int B, int P, int D, int n,
                    void* stream) {
  Args a = make_args(points, start, start_value, valid, valid_stride, idx, P, n);
  a.radius = radius;
  a.radius_value = radius_value;
  a.keep = keep;
  return launch(a, B, D, stream);
}

// gsdx_fps's launch at the same shape, steps, barriers and reductions, with
// no distances computed: the latency floor of its serial chain. idx is
// written with meaningless indices.
int gsdx_fps_floor(const float* points, long long* idx, int B, int P, int D, int n,
                   void* stream) {
  Args a = make_args(points, nullptr, 0, nullptr, 0, idx, P, n);
  a.floor_only = 1;
  return launch(a, B, D, stream);
}

}  // extern "C"
