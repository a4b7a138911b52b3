// Fused GRIEF feature assembly for Hopper (sm_90a):
//
//     Phi[i, j] = prod_d  sum_k  B[d, i, k] * S[d, k, j]
//
// B (d, n, m) holds the per-dimension cross-covariances K_xU_d, S (d, m, p)
// the scaled eigenvector selections Q_d[:, idx_d] * lambda_d[idx_d]^(-1/2)
// (gp_grief_tpu_torch/kernels/grief.py:_phi_fused_operands).  Phi (n, p) is
// written once.
//
// Replaces the TPU kernel gp_grief_tpu/ops/pallas/phi_pallas.py:
// _phi_fused_primal.  It computes the same Phi but not with the Mosaic block
// schedule: the VMEM budget fallbacks and the lane/sublane divisibility rules
// of that kernel are TPU constraints and have no counterpart here.  Ragged n,
// m and p are masked inside the kernel; every shape is accepted.
//
// What bounds it: n*p*d*m fused multiply-adds (2*n*p*d*m flops) against
// n*d*m + d*m*p + n*p words moved.  At the kin40k shape (d=8, m=16, p=400)
// that is 256 flops for every word of Phi written, well above the card's
// FP32 balance point, so the kernel is bound by FP32 FMA issue and by the
// shared-memory reads that feed it, not by HBM.  The (n, p) accumulator never
// leaves registers: each thread keeps a TM x TN micro-tile of the running
// product and of the current dimension's dot, and writes the tile once.
//
// Numerics: plain FP32 (or FP64) FMAs, no TF32 tensor cores.  The JAX
// reference runs these dots at Precision.HIGHEST, so the kernel must reach
// full FP32 grade.
//
// Layout of one block: a BM x BN tile of Phi, 256 threads, each owning a
// 4 x 4 micro-tile strided by the thread grid (so shared-memory reads of S
// and the global stores of Phi are contiguous across a warp).  For each d the
// m-deep dot runs over BK-deep chunks of B and S staged in shared memory;
// chunk rows beyond m are zero-filled, which adds exact zeros.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BM = 64;                          // rows of Phi per block
constexpr int BN = 64;                          // columns of Phi per block
constexpr int BK = 16;                          // depth of one staged chunk
constexpr int TM = 4;                           // rows per thread
constexpr int TN = 4;                           // columns per thread
constexpr int THREADS_X = BN / TN;              // 16
constexpr int THREADS_Y = BM / TM;              // 16
constexpr int NTHREADS = THREADS_X * THREADS_Y; // 256

__device__ __forceinline__ float fma_rn(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double fma_rn(double a, double b, double c) { return __fma_rn(a, b, c); }

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
phi_fused_kernel(const T* __restrict__ B, const T* __restrict__ S, T* __restrict__ out,
                 int d, int n, int m, int p) {
  __shared__ T Bs[BK][BM + 1];  // B chunk stored k-major; +1 breaks bank conflicts on the transposing store
  __shared__ T Ss[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % THREADS_X;
  const int ty = tid / THREADS_X;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * BM;
  const int col0 = blockIdx.y * BN;

  T prod[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) prod[i][j] = T(1);

  for (int dd = 0; dd < d; ++dd) {
    const T* Bd = B + static_cast<int64_t>(dd) * n * m;
    const T* Sd = S + static_cast<int64_t>(dd) * m * p;

    T acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = T(0);

    for (int k0 = 0; k0 < m; k0 += BK) {
      // Stage B[dd, row0:row0+BM, k0:k0+BK] (rows are contiguous in m) and
      // S[dd, k0:k0+BK, col0:col0+BN], zero outside the array.
      for (int e = tid; e < BM * BK; e += NTHREADS) {
        const int r = e / BK;
        const int c = e % BK;
        const int64_t gr = row0 + r;
        const int gc = k0 + c;
        Bs[c][r] = (gr < n && gc < m) ? Bd[gr * m + gc] : T(0);
      }
      for (int e = tid; e < BK * BN; e += NTHREADS) {
        const int r = e / BN;
        const int c = e % BN;
        const int gr = k0 + r;
        const int gc = col0 + c;
        Ss[r][c] = (gr < m && gc < p) ? Sd[static_cast<int64_t>(gr) * p + gc] : T(0);
      }
      __syncthreads();

#pragma unroll
      for (int k = 0; k < BK; ++k) {
        T a[TM];
        T b[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) a[i] = Bs[k][ty + i * THREADS_Y];
#pragma unroll
        for (int j = 0; j < TN; ++j) b[j] = Ss[k][tx + j * THREADS_X];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fma_rn(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) prod[i][j] *= acc[i][j];
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int64_t r = row0 + ty + i * THREADS_Y;
    if (r >= n) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = col0 + tx + j * THREADS_X;
      if (c < p) out[r * p + c] = prod[i][j];
    }
  }
}

template <typename T>
int launch(const void* B, const void* S, void* out, int d, int n, int m, int p, void* stream) {
  if (n <= 0 || p <= 0) return 0;  // empty Phi: nothing to write
  const dim3 grid((n + BM - 1) / BM, (p + BN - 1) / BN);
  phi_fused_kernel<T><<<grid, NTHREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(B), static_cast<const T*>(S), static_cast<T*>(out), d, n, m, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points (loaded with ctypes).  Every pointer and the stream
// are passed as void*; the return value is the launch's cudaError_t.
extern "C" int gp_grief_phi_fused_f32(const void* B, const void* S, void* out,
                                      int d, int n, int m, int p, void* stream) {
  return launch<float>(B, S, out, d, n, m, p, stream);
}

extern "C" int gp_grief_phi_fused_f64(const void* B, const void* S, void* out,
                                      int d, int n, int m, int p, void* stream) {
  return launch<double>(B, S, out, d, n, m, p, stream);
}
