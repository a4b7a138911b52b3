// K10: the hyperparameter cotangents of the matrix-free Gram apply for
// Hopper (sm_90a).  For out = v K (K = var * g(r2), v (B, n)) and the
// cotangent G (B, n) of out, with w_ij = sum_b G[b, i] * v[b, j]:
//
//     c_var = sum_ij w_ij * g(r2_ij)
//     c_d   = sum_ij w_ij * h(r2_ij) * s2_ijd,        h = -2 g'(r2)
//
// s_ijd = (x_id - x_jd) / l_d, r2 = sum_d s2_ijd; the wrapper scales
// dL/dvar = c_var and dL/dl_d = var * c_d / l_d.  h shares g's exponential
// (and square root): rbf g; exponential = matern12 e^-r / r; matern32
// 3 e^(-sqrt3 r); matern52 (5/3)(1 + sqrt5 r) e^(-sqrt5 r).  A pair with
// r2 = 0 adds exactly 0 to every c_d (s2 = 0; matern12's h is taken as 0
// there, as the slab path's guarded sqrt gives).  No (n, n) or (chunk, n)
// buffer reaches device memory: distance, g, h, w and the d + 1 sums run in
// one pass.
//
// Replaces no TPU kernel: the JAX package leaves the gradient of its
// matrix-free Gram apply to XLA's autodiff.  The port's plain route rebuilt
// each (chunk, n) slab in the backward of a checkpointed block through ~10
// eager ops and their backwards (gp_grief_tpu_torch/models/gp_regression.py:
// make_gram_matvec; still the route of every input K9's predicate refuses).
//
// What bounds it: operations.  G, v and x are a few MB and stay in L2; each
// pair costs d differences and d FMAs of distance, the kernel function (one
// exponential, a square root for the Matern kinds), B FMAs of w, and d + 1
// accumulations, at FP32's 67 TFLOP/s (FP64 outside the tensor cores ~34).
// The design is K9's (gram_apply.cu), with the contraction turned around:
//
// * A block of 128 threads owns TR row points a thread (TR = 4, or 2 for
//   d > 4 and for double), their scaled coordinates and their G values for
//   a tile of BT right-hand sides (BT in {1, 4, 8, 16}; the wrapper cuts B
//   into tiles, blockIdx.y, and the sums add over tiles) in registers.
// * It walks its range of column tiles, JT = 64 points each: the tile's
//   scaled coordinates and v values, point-major, through a double-buffered
//   cp.async ring in shared memory, each column read as a broadcast.
// * The long sums (n^2 signed terms) never ride on one float32 running sum:
//   each thread sums a column tile's pairs in T, then folds that partial into
//   a double accumulator (one DADD a sum per tile); the block reduces its
//   threads' doubles by warp shuffles and then its warps in a fixed order,
//   and writes one partial a sum.
// * The column range is split over S blocks (blockIdx.z) by occupancy, as
//   K9's is (the row tiles alone fill under two waves at n = 40k); a second
//   small kernel adds every block's partials in a fixed order.  No atomics:
//   every call gives the same bits.
// * Full precision: expf / sqrtf and IEEE division, never the approximate
//   intrinsics or nvcc's fast-math flag.
//
// xs (n_pad, D): the scaled coordinates, zero-padded; gt and vt (ceil(B /
// BT), n_pad, BTP): G and v tile by tile, point-major, zero-padded (a zero
// G row or v column makes w = 0, so padded pairs add exactly 0).  part holds
// one double a sum a block; out the d + 1 sums (padded coordinates add 0).

#include <cuda_runtime.h>

#include <cstdint>

#include "device_helpers.cuh"
#include "device_scope.cuh"
#include "gram_common.cuh"

namespace {

constexpr int REDUCE_THREADS = 256;

// g(r2) and h(r2) = -2 g'(r2) of the kind, from one exponential.
template <int KIND, typename T>
__device__ __forceinline__ void kfun_grad(T r2, T& g, T& h) {
  if constexpr (KIND == RBF) {
    g = exp_(T(-0.5) * r2);
    h = g;
  } else {
    const T r = sqrt_(r2);
    if constexpr (KIND == MATERN12) {
      g = exp_(-r);
      h = r2 > T(0) ? g / r : T(0);
    } else if constexpr (KIND == MATERN32) {
      const T s = T(1.7320508075688772) * r;
      const T e = exp_(-s);
      g = (T(1) + s) * e;
      h = T(3) * e;
    } else {
      const T s = T(2.23606797749979) * r;
      const T e = exp_(-s);
      g = (T(1) + s + s * s * T(1.0 / 3.0)) * e;
      h = T(5.0 / 3.0) * (T(1) + s) * e;
    }
  }
}

template <typename T, int KIND, int D, int BT>
__global__ void __launch_bounds__(THREADS) gram_grad_kernel(const T* __restrict__ xs, const T* __restrict__ gt,
                                                            const T* __restrict__ vt, double* __restrict__ part,
                                                            int n_pad, int S) {
  constexpr int TR = rows_of(sizeof(T), D);
  constexpr int BTP = bt_pad(sizeof(T), BT);
  constexpr int NS = D + 1;  // sums: the variance's, then one a coordinate
  constexpr int XS = JT * D, VS = JT * BTP;  // elements of a stage
  constexpr int XC = XS * sizeof(T) / 16, VC = VS * sizeof(T) / 16;  // its 16-byte copies
  static_assert(XS * sizeof(T) % 16 == 0 && VS * sizeof(T) % 16 == 0, "stages are whole 16-byte copies");
  __shared__ __align__(16) T xs_s[2][XS];
  __shared__ __align__(16) T vs_s[2][VS];
  __shared__ double warp_sums[THREADS / 32][NS];

  const int tid = threadIdx.x;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * THREADS * TR + tid;
  const int tb = blockIdx.y, s = blockIdx.z;
  const int tiles = n_pad / JT;
  const int t0 = static_cast<int>(static_cast<int64_t>(tiles) * s / S);
  const int t1 = static_cast<int>(static_cast<int64_t>(tiles) * (s + 1) / S);
  const T* gg = gt + static_cast<int64_t>(tb) * n_pad * BTP;
  const T* vg = vt + static_cast<int64_t>(tb) * n_pad * BTP;

  T xi[TR][D], gi[TR][BT];
#pragma unroll
  for (int r = 0; r < TR; ++r) {
#pragma unroll
    for (int dd = 0; dd < D; ++dd) xi[r][dd] = xs[(row0 + r * THREADS) * D + dd];
#pragma unroll
    for (int b = 0; b < BT; ++b) gi[r][b] = gg[(row0 + r * THREADS) * BTP + b];
  }
  double acc[NS];
#pragma unroll
  for (int k = 0; k < NS; ++k) acc[k] = 0.0;

  auto stage = [&](int tile, int buf) {
    const char* xsrc = reinterpret_cast<const char*>(xs + static_cast<int64_t>(tile) * XS);
    const char* vsrc = reinterpret_cast<const char*>(vg + static_cast<int64_t>(tile) * VS);
    char* xdst = reinterpret_cast<char*>(xs_s[buf]);
    char* vdst = reinterpret_cast<char*>(vs_s[buf]);
    for (int c = tid; c < XC; c += THREADS) cp_async<16>(xdst + c * 16, xsrc + c * 16, 16);
    for (int c = tid; c < VC; c += THREADS) cp_async<16>(vdst + c * 16, vsrc + c * 16, 16);
    cp_async_commit();
  };

  if (t0 < t1) stage(t0, 0);
  for (int tile = t0; tile < t1; ++tile) {
    const int buf = (tile - t0) & 1;
    if (tile + 1 < t1) {
      stage(tile + 1, buf ^ 1);  // its buffer's last reads ended at the previous tile's barrier
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* xsb = xs_s[buf];
    const T* vsb = vs_s[buf];
    T sum[NS];  // this tile's partials, in T
#pragma unroll
    for (int k = 0; k < NS; ++k) sum[k] = T(0);
#pragma unroll 2
    for (int jj = 0; jj < JT; ++jj) {
      T xj[D], vj[BTP];
      load_smem<T, D>(xj, xsb + jj * D);
      load_smem<T, BTP>(vj, vsb + jj * BTP);
#pragma unroll
      for (int r = 0; r < TR; ++r) {
        T df[D], r2 = T(0);
#pragma unroll
        for (int dd = 0; dd < D; ++dd) {
          df[dd] = xi[r][dd] - xj[dd];
          r2 = fma_rn(df[dd], df[dd], r2);
        }
        T g, h;
        kfun_grad<KIND>(r2, g, h);
        T w = gi[r][0] * vj[0];
#pragma unroll
        for (int b = 1; b < BT; ++b) w = fma_rn(gi[r][b], vj[b], w);
        sum[0] = fma_rn(w, g, sum[0]);
        const T t = w * h;
#pragma unroll
        for (int dd = 0; dd < D; ++dd) sum[1 + dd] = fma_rn(t * df[dd], df[dd], sum[1 + dd]);
      }
    }
#pragma unroll
    for (int k = 0; k < NS; ++k) acc[k] += static_cast<double>(sum[k]);
    __syncthreads();  // the buffer is free for the copies of tile + 2
  }

  // The block's sums: each warp by shuffles (a fixed tree), then the warps in order.
  const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int k = 0; k < NS; ++k) {
    double a = acc[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) a += __shfl_down_sync(0xffffffffu, a, off);
    if (lane == 0) warp_sums[warp][k] = a;
  }
  __syncthreads();
  if (tid < NS) {
    double a = warp_sums[0][tid];
#pragma unroll
    for (int w = 1; w < THREADS / 32; ++w) a += warp_sums[w][tid];
    const int64_t blk = (static_cast<int64_t>(blockIdx.z) * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
    part[blk * NS + tid] = a;
  }
}

// Sum k of every block's partials (one block a sum): a strided pass, then a
// fixed tree in shared memory.
__global__ void __launch_bounds__(REDUCE_THREADS) gram_grad_reduce_kernel(const double* __restrict__ part,
                                                                          double* __restrict__ out, int64_t blocks,
                                                                          int NS) {
  __shared__ double buf[REDUCE_THREADS];
  const int k = blockIdx.x, tid = threadIdx.x;
  double a = 0.0;
  for (int64_t i = tid; i < blocks; i += REDUCE_THREADS) a += part[i * NS + k];
  buf[tid] = a;
  __syncthreads();
  for (int w = REDUCE_THREADS / 2; w > 0; w >>= 1) {
    if (tid < w) buf[tid] += buf[tid + w];
    __syncthreads();
  }
  if (tid == 0) out[k] = buf[0];
}

template <typename T>
using Kern = decltype(&gram_grad_kernel<T, RBF, 2, 1>);

template <typename T, int KIND, int D>
Kern<T> pick_tile(int bt) {
  switch (bt) {
    case 1: return gram_grad_kernel<T, KIND, D, 1>;
    case 4: return gram_grad_kernel<T, KIND, D, 4>;
    case 8: return gram_grad_kernel<T, KIND, D, 8>;
    case 16: return gram_grad_kernel<T, KIND, D, 16>;
    default: return nullptr;
  }
}

template <typename T, int KIND>
Kern<T> pick_dim(int d, int bt) {
  switch (d) {
    case 2: return pick_tile<T, KIND, 2>(bt);
    case 4: return pick_tile<T, KIND, 4>(bt);
    case 8: return pick_tile<T, KIND, 8>(bt);
    default: return nullptr;
  }
}

template <typename T>
Kern<T> pick(int kind, int d, int bt) {
  switch (kind) {
    case RBF: return pick_dim<T, RBF>(d, bt);
    case MATERN12: return pick_dim<T, MATERN12>(d, bt);
    case MATERN32: return pick_dim<T, MATERN32>(d, bt);
    case MATERN52: return pick_dim<T, MATERN52>(d, bt);
    default: return nullptr;
  }
}

template <typename T>
int occupancy(int kind, int D, int BT, int device) {
  const Kern<T> kern = pick<T>(kind, D, BT);
  if (kern == nullptr) return ERR_SHAPE;
  const DeviceScope scope(device);
  if (scope.err != cudaSuccess) return -static_cast<int>(scope.err);
  int blocks = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern, THREADS, 0);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

template <typename T>
int launch(const void* xs, const void* gt, const void* vt, void* part, void* out, int n_pad, int B, int D, int kind,
           int BT, int S, int device, void* stream) {
  const Kern<T> kern = pick<T>(kind, D, BT);
  if (kern == nullptr || B <= 0 || S < 1 || n_pad <= 0 || S > n_pad / JT || n_pad % ROW_PAD != 0) return ERR_SHAPE;
  const int64_t btiles = (B + BT - 1) / BT;
  if (btiles > 65535 || S > 65535) return ERR_SHAPE;
  const DeviceScope scope(device);
  if (scope.err != cudaSuccess) return static_cast<int>(scope.err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(n_pad / (THREADS * rows_of(sizeof(T), D))), static_cast<unsigned>(btiles),
                  static_cast<unsigned>(S));
  kern<<<grid, THREADS, 0, st>>>(static_cast<const T*>(xs), static_cast<const T*>(gt), static_cast<const T*>(vt),
                                 static_cast<double*>(part), n_pad, S);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t blocks = static_cast<int64_t>(grid.x) * grid.y * grid.z;
  gram_grad_reduce_kernel<<<D + 1, REDUCE_THREADS, 0, st>>>(static_cast<const double*>(part),
                                                            static_cast<double*>(out), blocks, D + 1);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points (loaded with ctypes).  The occupancy query returns
// the blocks of the (dtype, kind, D, BT) member one SM holds, or a negative
// value (-1: no such member; otherwise minus the cudaError_t).  The launch
// returns the launches' cudaError_t, or -1 for arguments the kernel does
// not take; part holds grid.x * grid.y * grid.z * (D + 1) doubles (the
// wrapper's plan), out D + 1.  kind: 0 rbf, 1 exponential / matern12,
// 2 matern32, 3 matern52.
extern "C" int gp_grief_gram_grad_occupancy(int f64, int kind, int D, int BT, int device) {
  return f64 ? occupancy<double>(kind, D, BT, device) : occupancy<float>(kind, D, BT, device);
}

extern "C" int gp_grief_gram_grad_f32(const void* xs, const void* gt, const void* vt, void* part, void* out,
                                      int n_pad, int B, int D, int kind, int BT, int S, int device, void* stream) {
  return launch<float>(xs, gt, vt, part, out, n_pad, B, D, kind, BT, S, device, stream);
}

extern "C" int gp_grief_gram_grad_f64(const void* xs, const void* gt, const void* vt, void* part, void* out,
                                      int n_pad, int B, int D, int kind, int BT, int S, int device, void* stream) {
  return launch<double>(xs, gt, vt, part, out, n_pad, B, D, kind, BT, S, device, stream);
}
