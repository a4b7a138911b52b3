// K9: the matrix-free Gram apply of the exact GP for Hopper (sm_90a):
//
//     out[b, i] = var * sum_j g(r2_ij) * v[b, j] + sig2 * v[b, i],
//     r2_ij     = sum_d ((x_id - x_jd) / l_d)^2
//
// for one stationary kernel g (rbf, exponential = matern12, matern32,
// matern52), v (B, n) batch-major as the solvers keep it.  No slab of K
// reaches device memory: distance, kernel function and contraction run in
// one pass.
//
// Replaces no TPU kernel: the JAX package leaves its matrix-free Gram apply
// (gp_grief_tpu/models/gp_regression.py:make_gram_matvec) to XLA.  The
// port's plain version built each (chunk, n) slab through a chain of eager
// ops and contracted it with a GEMM, several round trips through device
// memory for ~30 operations an entry (gp_grief_tpu_torch/models/
// gp_regression.py:_solver_slab, _contract; still the route of every
// CPU tensor and every input the route refuses).  The differentiated apply
// runs this kernel forward, with K10 (gram_grad.cu) in its backward.
//
// What bounds it: operations.  x (n, d) and v (B, n) are a few MB and stay
// in L2; each pair (i, j) costs d differences and FMAs, the kernel function
// (one exponential, and a square root for the Matern kinds) and B FMAs of
// contraction, at FP32's 67 TFLOP/s (for double, FP64 outside the tensor
// cores, about 34 TFLOP/s: half that).  At B = 9,
// n = 40,000, d = 2: 4.8e10 operations counted, 0.716 ms.  TMA and wgmma buy
// nothing here, so the design is register tiling on the FP32 pipes:
//
// * A block of 128 threads owns TR row points (TR = 4, or 2 for d > 4 and
//   for double) per thread, their scaled coordinates in registers, and a
//   tile of BT right-hand sides (BT in {1, 9, 16}; the wrapper cuts
//   B into tiles, blockIdx.y), with TR x BT accumulators in registers.
// * It walks its range of column tiles, JT = 64 points each: the tile's
//   scaled coordinates (JT x D) and its v values, point-major (JT x BTP,
//   BTP = BT padded to 16 bytes), come through a double-buffered cp.async
//   ring in shared memory.  Every thread of the block reads the same column
//   at a time, so the shared loads are broadcasts (one LDS.128 for four
//   values).
// * Distances are direct differences, zero-padded to D in {2, 4, 8}
//   coordinates (a zero coordinate adds exactly 0): the JAX package's exact
//   regime, with no cancellation, so identical points give r2 = 0 exactly.
// * Full precision: expf / sqrtf, never the approximate intrinsics or
//   nvcc's fast-math flag; FP32 FMA products.  "default" (FAST) rounds each
//   var * g(r2) and each v to bf16 first, the arithmetic of the slab path's
//   bf16-operand contraction.
// * Where the row tiles alone fill less than two waves of the card, the
//   column range is split over S blocks (blockIdx.z; the wrapper picks S
//   from the occupancy).  Each split writes its partial sums, and a second
//   small kernel adds the S partials in a fixed order and applies the
//   epilogue (var, + sig2 v): no atomics, so every call gives the same bits.
//   With S = 1 the main kernel applies the epilogue itself.
//
// xs (n_pad, D): the scaled coordinates, zero-padded; vt (ceil(B / BT),
// n_pad, BTP): v tile by tile, point-major, zero-padded (a zero v makes a
// padded column add exactly 0); n_pad a multiple of ROW_PAD.  var and sig2
// are device scalars (no host read).  Offsets are 64-bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "device_helpers.cuh"
#include "device_scope.cuh"
#include "gram_common.cuh"

namespace {

// Round to bf16 and back, as torch's .to(bfloat16).to(T) does: a double
// goes through float first.
__device__ __forceinline__ float round_bf16(float a) { return __bfloat162float(__float2bfloat16_rn(a)); }
__device__ __forceinline__ double round_bf16(double a) {
  return static_cast<double>(round_bf16(static_cast<float>(a)));
}

template <typename T, int KIND, int D, int BT, bool FAST>
__global__ void __launch_bounds__(THREADS) gram_apply_kernel(
    const T* __restrict__ xs, const T* __restrict__ vt, const T* __restrict__ v, const T* __restrict__ var_p,
    const T* __restrict__ sig_p, T* __restrict__ out, T* __restrict__ part, int n, int n_pad, int B, int S) {
  constexpr int TR = rows_of(sizeof(T), D);
  constexpr int BTP = bt_pad(sizeof(T), BT);
  constexpr int XS = JT * D, VS = JT * BTP;  // elements of a stage
  constexpr int XC = XS * sizeof(T) / 16, VC = VS * sizeof(T) / 16;  // its 16-byte copies
  static_assert(XS * sizeof(T) % 16 == 0 && VS * sizeof(T) % 16 == 0, "stages are whole 16-byte copies");
  __shared__ __align__(16) T xs_s[2][XS];
  __shared__ __align__(16) T vs_s[2][VS];

  const int tid = threadIdx.x;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * THREADS * TR + tid;
  const int tb = blockIdx.y, s = blockIdx.z;
  const int tiles = n_pad / JT;
  const int t0 = static_cast<int>(static_cast<int64_t>(tiles) * s / S);
  const int t1 = static_cast<int>(static_cast<int64_t>(tiles) * (s + 1) / S);
  const T* vg = vt + static_cast<int64_t>(tb) * n_pad * BTP;
  const T var = *var_p;

  T xi[TR][D];
#pragma unroll
  for (int r = 0; r < TR; ++r)
#pragma unroll
    for (int dd = 0; dd < D; ++dd) xi[r][dd] = xs[(row0 + r * THREADS) * D + dd];
  T acc[TR][BT];
#pragma unroll
  for (int r = 0; r < TR; ++r)
#pragma unroll
    for (int b = 0; b < BT; ++b) acc[r][b] = T(0);

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
#pragma unroll 2
    for (int jj = 0; jj < JT; ++jj) {
      T xj[D], vj[BTP];
      load_smem<T, D>(xj, xsb + jj * D);
      load_smem<T, BTP>(vj, vsb + jj * BTP);
#pragma unroll
      for (int r = 0; r < TR; ++r) {
        T r2 = T(0);
#pragma unroll
        for (int dd = 0; dd < D; ++dd) {
          const T df = xi[r][dd] - xj[dd];
          r2 = fma_rn(df, df, r2);
        }
        T k = kfun<KIND>(r2);
        if constexpr (FAST) k = round_bf16(var * k);
#pragma unroll
        for (int b = 0; b < BT; ++b) acc[r][b] = fma_rn(k, vj[b], acc[r][b]);
      }
    }
    __syncthreads();  // the buffer is free for the copies of tile + 2
  }

  const int b0 = tb * BT;
  if (S == 1) {
    const T scale = FAST ? T(1) : var, sig = *sig_p;
#pragma unroll
    for (int r = 0; r < TR; ++r) {
      const int64_t i = row0 + r * THREADS;
      if (i >= n) continue;
#pragma unroll
      for (int b = 0; b < BT; ++b) {
        if (b0 + b >= B) break;
        const int64_t o = static_cast<int64_t>(b0 + b) * n + i;
        out[o] = fma_rn(scale, acc[r][b], sig * v[o]);
      }
    }
  } else {
#pragma unroll
    for (int r = 0; r < TR; ++r) {
      const int64_t i = row0 + r * THREADS;
#pragma unroll
      for (int b = 0; b < BT; ++b) {
        if (b0 + b >= B) break;
        part[(static_cast<int64_t>(s) * B + b0 + b) * n_pad + i] = acc[r][b];
      }
    }
  }
}

// The S partials of each output, added in split order, then the epilogue.
template <typename T>
__global__ void __launch_bounds__(256) gram_reduce_kernel(const T* __restrict__ part, const T* __restrict__ v,
                                                          const T* __restrict__ var_p, const T* __restrict__ sig_p,
                                                          T* __restrict__ out, int n, int n_pad, int B, int S,
                                                          int fast) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= static_cast<int64_t>(B) * n) return;
  const int64_t b = e / n, i = e - b * n;
  T sum = part[b * n_pad + i];
  for (int s = 1; s < S; ++s) sum += part[(static_cast<int64_t>(s) * B + b) * n_pad + i];
  const T scale = fast ? T(1) : *var_p;
  out[e] = fma_rn(scale, sum, *sig_p * v[e]);
}

template <typename T>
using Kern = decltype(&gram_apply_kernel<T, RBF, 2, 1, false>);

template <typename T, int KIND, int D, int BT>
Kern<T> pick_fast(bool fast) {
  return fast ? gram_apply_kernel<T, KIND, D, BT, true> : gram_apply_kernel<T, KIND, D, BT, false>;
}

template <typename T, int KIND, int D>
Kern<T> pick_tile(int bt, bool fast) {
  switch (bt) {
    case 1: return pick_fast<T, KIND, D, 1>(fast);
    case 9: return pick_fast<T, KIND, D, 9>(fast);
    case 16: return pick_fast<T, KIND, D, 16>(fast);
    default: return nullptr;
  }
}

template <typename T, int KIND>
Kern<T> pick_dim(int d, int bt, bool fast) {
  switch (d) {
    case 2: return pick_tile<T, KIND, 2>(bt, fast);
    case 4: return pick_tile<T, KIND, 4>(bt, fast);
    case 8: return pick_tile<T, KIND, 8>(bt, fast);
    default: return nullptr;
  }
}

template <typename T>
Kern<T> pick(int kind, int d, int bt, bool fast) {
  switch (kind) {
    case RBF: return pick_dim<T, RBF>(d, bt, fast);
    case MATERN12: return pick_dim<T, MATERN12>(d, bt, fast);
    case MATERN32: return pick_dim<T, MATERN32>(d, bt, fast);
    case MATERN52: return pick_dim<T, MATERN52>(d, bt, fast);
    default: return nullptr;
  }
}

template <typename T>
int occupancy(int kind, int D, int BT, int fast, int device) {
  const Kern<T> kern = pick<T>(kind, D, BT, fast != 0);
  if (kern == nullptr) return ERR_SHAPE;
  const DeviceScope scope(device);
  if (scope.err != cudaSuccess) return -static_cast<int>(scope.err);
  int blocks = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern, THREADS, 0);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

template <typename T>
int launch(const void* xs, const void* vt, const void* v, const void* var, const void* sig, void* out, void* part,
           int n, int n_pad, int B, int D, int kind, int BT, int fast, int S, int device, void* stream) {
  if (B <= 0 || n <= 0) return 0;  // empty output: nothing to write
  const Kern<T> kern = pick<T>(kind, D, BT, fast != 0);
  if (kern == nullptr || S < 1 || S > n_pad / JT || n_pad % ROW_PAD != 0 || n > n_pad || (S > 1 && part == nullptr))
    return ERR_SHAPE;
  const int64_t btiles = (B + BT - 1) / BT;
  if (btiles > 65535 || S > 65535) return ERR_SHAPE;
  const DeviceScope scope(device);
  if (scope.err != cudaSuccess) return static_cast<int>(scope.err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(n_pad / (THREADS * rows_of(sizeof(T), D))), static_cast<unsigned>(btiles),
                  static_cast<unsigned>(S));
  kern<<<grid, THREADS, 0, st>>>(static_cast<const T*>(xs), static_cast<const T*>(vt), static_cast<const T*>(v),
                                 static_cast<const T*>(var), static_cast<const T*>(sig), static_cast<T*>(out),
                                 static_cast<T*>(part), n, n_pad, B, S);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || S == 1) return static_cast<int>(err);
  const int64_t total = static_cast<int64_t>(B) * n;
  const int64_t blocks = (total + 255) / 256;
  if (blocks > 0x7fffffffLL) return ERR_SHAPE;
  gram_reduce_kernel<T><<<static_cast<unsigned>(blocks), 256, 0, st>>>(
      static_cast<const T*>(part), static_cast<const T*>(v), static_cast<const T*>(var), static_cast<const T*>(sig),
      static_cast<T*>(out), n, n_pad, B, S, fast);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points (loaded with ctypes).  The occupancy query returns
// the blocks of the (dtype, kind, D, BT, fast) member one SM holds, or a
// negative value (-1: no such member; otherwise minus the cudaError_t).
// The apply returns the launches' cudaError_t, or -1 for arguments the
// kernel does not take.  kind: 0 rbf, 1 exponential / matern12,
// 2 matern32, 3 matern52.
extern "C" int gp_grief_gram_occupancy(int f64, int kind, int D, int BT, int fast, int device) {
  return f64 ? occupancy<double>(kind, D, BT, fast, device) : occupancy<float>(kind, D, BT, fast, device);
}

extern "C" int gp_grief_gram_apply_f32(const void* xs, const void* vt, const void* v, const void* var,
                                       const void* sig, void* out, void* part, int n, int n_pad, int B, int D,
                                       int kind, int BT, int fast, int S, int device, void* stream) {
  return launch<float>(xs, vt, v, var, sig, out, part, n, n_pad, B, D, kind, BT, fast, S, device, stream);
}

extern "C" int gp_grief_gram_apply_f64(const void* xs, const void* vt, const void* v, const void* var,
                                       const void* sig, void* out, void* part, int n, int n_pad, int B, int D,
                                       int kind, int BT, int fast, int S, int device, void* stream) {
  return launch<double>(xs, vt, v, var, sig, out, part, n, n_pad, B, D, kind, BT, fast, S, device, stream);
}
