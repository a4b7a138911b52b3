// What the two Gram kernels share (K9, gram_apply.cu; K10, gram_grad.cu):
// the block shape, the column tile, the row padding, the kernel function
// g(r2) of each kind, and the broadcast loads of a column from shared memory.
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
constexpr int JT = 64;         // columns a stage
constexpr int ROW_PAD = 512;   // n_pad's multiple: every row tile (128 x TR) and JT divide it
constexpr int ERR_SHAPE = -1;

enum Kind { RBF = 0, MATERN12 = 1, MATERN32 = 2, MATERN52 = 3 };

// Rows a thread owns: fewer where the coordinates or the type take more registers.
__host__ __device__ constexpr int rows_of(int size, int d) { return (size == 8 || d > 4) ? 2 : 4; }

// BT padded to whole 16-byte loads (one value stays one value).
__host__ __device__ constexpr int bt_pad(int size, int bt) {
  return bt == 1 ? 1 : (bt * size + 15) / 16 * 16 / size;
}

__device__ __forceinline__ float exp_(float a) { return expf(a); }
__device__ __forceinline__ double exp_(double a) { return exp(a); }
__device__ __forceinline__ float sqrt_(float a) { return sqrtf(a); }
__device__ __forceinline__ double sqrt_(double a) { return sqrt(a); }

// g(r2) of the kind, as gp_grief_tpu_torch/kernels/stationary.py:_from_r2
// (variance left out).  sqrt(0) = 0 exactly, so r = 0 needs no guard here.
template <int KIND, typename T>
__device__ __forceinline__ T kfun(T r2) {
  if constexpr (KIND == RBF) {
    return exp_(T(-0.5) * r2);
  } else {
    const T r = sqrt_(r2);
    if constexpr (KIND == MATERN12) {
      return exp_(-r);
    } else if constexpr (KIND == MATERN32) {
      const T s = T(1.7320508075688772) * r;
      return (T(1) + s) * exp_(-s);
    } else {
      const T s = T(2.23606797749979) * r;
      return (T(1) + s + s * s * T(1.0 / 3.0)) * exp_(-s);
    }
  }
}

template <typename T, int BYTES>
struct alignas(BYTES) Pack {
  T v[BYTES / sizeof(T)];
};

// N values from shared memory in the widest loads their alignment allows.
template <typename T, int N>
__device__ __forceinline__ void load_smem(T (&dst)[N], const T* src) {
  constexpr int W = (N * sizeof(T)) % 16 == 0 ? 16 : (N * sizeof(T)) % 8 == 0 ? 8 : static_cast<int>(sizeof(T));
  constexpr int P = W / static_cast<int>(sizeof(T));
#pragma unroll
  for (int q = 0; q < N / P; ++q) {
    const Pack<T, W> p = reinterpret_cast<const Pack<T, W>*>(src)[q];
#pragma unroll
    for (int e = 0; e < P; ++e) dst[q * P + e] = p.v[e];
  }
}

}  // namespace
