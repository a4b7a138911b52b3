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
// that is 256 flops for every word of Phi written, far above the card's
// balance point.  A kernel that keeps its bits (below) cannot use the tensor
// cores, so its floor is FP32 FMA issue on the CUDA cores (67 TFLOP/s: 0.046
// ms at kin40k, 0.157 ms at a uci2m chunk).  Measured on an H100 (PERF.md
// section 6): the FMA loop runs at about two thirds of that rate; the
// rest of the time goes to issuing the stage copies, the per-dimension
// product update and the first stage's latency.
//
// Numerics, kept bit for bit: each element's dot for dimension d is
// acc = fma(B[d, i, k], S[d, k, j], acc) over k = 0 .. m - 1 in order, from
// acc = 0, and Phi is 1 * dot_0 * dot_1 * ... in order of d.  Plain FP32 (or
// FP64) FMAs, no tensor cores: the JAX reference runs these dots at
// Precision.HIGHEST, and kin40k's training has a second mode that rounding
// changes can reach (ROADMAP Queue 3), so the order of every sum is part of
// the function.  (Earlier versions padded the depth to 16 with zero terms,
// fma(0, 0, acc) = acc: dropping them changes no bit, except the sign of a
// dot whose every product underflowed to -0.)
//
// Layout: a block computes a BM x 80 tile of Phi with 256 threads (16 x 16),
// each a TM x 5 micro-tile (TM = 8 in f32, 4 in f64): rows TM ty .. TM ty +
// TM - 1, columns tx + 16 j.  A tile width of 80 divides p = 400.  The depth
// runs in stages of up to KC = 16, one stage per (d, chunk) step (one per d
// at m <= 16).  Each stage is copied by cp.async into one of two
// shared-memory buffers, the next stage in flight while this one is summed,
// one barrier per stage: S's rows as they are, B's rows element by element to
// their transposed (k-major) places, so that each k step takes TM / 4
// 16-byte loads of B's column (shared by the 16 threads of a row) and 5 of
// S's row (consecutive across a row of threads) for 5 TM FMAs.  The k loop is
// unrolled whole at the stage's depth (a switch over 1..16), so the next k's
// loads overlap this k's FMAs and no padded depth is summed.  The current dot
// stays in registers; the running product over d lives in shared memory
// (registers for both spill), one slot per thread and element.  Two blocks
// share an SM.

#include <cuda_runtime.h>

#include <cstdint>

#include "device_helpers.cuh"
#include "device_scope.cuh"
#include "resident_grid.cuh"

namespace {

constexpr int TY = 16;                // thread rows
constexpr int TX = 16;                // thread columns
constexpr int NTHREADS = TY * TX;     // 256
constexpr int TN = 5;                 // columns per thread
constexpr int BN = TX * TN;           // 80 columns of Phi per block
constexpr int KC = 16;                // depth of one stage

template <typename T> struct Micro { static constexpr int TM = 8; };  // rows per thread
template <> struct Micro<double> { static constexpr int TM = 4; };

__device__ __forceinline__ void load4(const float* p, float* o) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  o[0] = t.x, o[1] = t.y, o[2] = t.z, o[3] = t.w;
}
__device__ __forceinline__ void load4(const double* p, double* o) {
  const double2 t0 = *reinterpret_cast<const double2*>(p);
  const double2 t1 = *reinterpret_cast<const double2*>(p + 2);
  o[0] = t0.x, o[1] = t0.y, o[2] = t1.x, o[3] = t1.y;
}

// acc[i][j] = fma(B[row i, k], S[k, column j], acc[i][j]) for k = 0 .. KK - 1
// of one stage (bt: the stage's transposed B at this thread's first row; ss:
// its S at this thread's first column).  KK is a compile-time depth, so the loop
// unrolls whole and the next k's loads overlap this k's FMAs.
template <typename T, int TM, int KK>
__device__ __forceinline__ void stage_sums(T (&acc)[TM][TN], const T* bt, const T* ss) {
  constexpr int BMP = TM * TY + 4;
#pragma unroll
  for (int kk = 0; kk < KK; ++kk) {
    T a[TM], b[TN];
#pragma unroll
    for (int i = 0; i < TM; i += 4) load4(bt + kk * BMP + i, a + i);
#pragma unroll
    for (int j = 0; j < TN; ++j) b[j] = ss[kk * BN + j * TX];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fma_rn(a[i], b[j], acc[i][j]);
  }
}

// stage_sums at the stage's depth kc (0 <= kc <= KC).
template <typename T, int TM, int KK = KC>
__device__ __forceinline__ void stage_sums_at(int kc, T (&acc)[TM][TN], const T* bt, const T* ss) {
  if constexpr (KK > 0) {
    if (kc < KK) {
      stage_sums_at<T, TM, KK - 1>(kc, acc, bt, ss);
      return;
    }
    stage_sums<T, TM, KK>(acc, bt, ss);
  }
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS, 2)
phi_fused_kernel(const T* __restrict__ B, const T* __restrict__ S, T* __restrict__ out,
                 int d, int n, int m, int p, bool vec) {
  constexpr int TM = Micro<T>::TM;
  constexpr int BM = TM * TY;
  constexpr int VEC = 16 / static_cast<int>(sizeof(T));  // elements per 16-byte copy
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int BMP = BM + 4;  // B stage row pitch: 16-byte rows
  T (*const Bt)[KC * BMP] = reinterpret_cast<T (*)[KC * BMP]>(smem_raw);  // B stages, transposed: depth kk, row r at kk * BMP + r
  T (*const Ss)[KC * BN] = reinterpret_cast<T (*)[KC * BN]>(Bt + 2);  // S stages: depth kk, column c at kk * BN + c
  T* const Ps = reinterpret_cast<T*>(Ss + 2);  // running products: element (i, j) of thread t at (i TN + j) NTHREADS + t

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int col_blocks = (p + BN - 1) / BN;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x / col_blocks) * BM;
  const int col0 = (blockIdx.x % col_blocks) * BN;
  const int chunks = m > 0 ? (m + KC - 1) / KC : 1;
  const int steps = d * chunks;

  // Step s: depth chunk s % chunks of dimension s / chunks.
  auto stage = [&](int s) {
    const int k0 = (s % chunks) * KC;
    const int kc = min(KC, m - k0);
    // B rows row0 .. row0 + BM, depth k0 .. k0 + kc, each element copied to
    // its transposed place: thread column kk = tid % 16 of rows tid / 16,
    // + 16, ...; consecutive threads read along a row.
    T* bt = Bt[s & 1];
    const T* Bd = B + static_cast<int64_t>(s / chunks) * n * m;
    const int kk = tid % KC;
    if (kk < kc) {
      for (int r = tid / KC; r < BM; r += NTHREADS / KC) {
        const int64_t gr = row0 + r;
        const bool in = gr < n;
        cp_async<sizeof(T)>(bt + kk * BMP + r, in ? Bd + gr * m + k0 + kk : Bd, in ? sizeof(T) : 0);
      }
    }
    // S rows k0 .. k0 + kc, columns col0 .. col0 + BN.
    T* ss = Ss[s & 1];
    const T* Sd = S + static_cast<int64_t>(s / chunks) * m * p;
    if (vec) {
      constexpr int PER_ROW = BN / VEC;
      for (int e = tid; e < kc * PER_ROW; e += NTHREADS) {
        const int r = e / PER_ROW;
        const int c = (e % PER_ROW) * VEC;
        const bool in = col0 + c < p;  // p is a multiple of VEC: the chunk is whole
        cp_async<16>(ss + r * BN + c, in ? Sd + static_cast<int64_t>(k0 + r) * p + col0 + c : Sd, in ? 16 : 0);
      }
    } else {
      for (int e = tid; e < kc * BN; e += NTHREADS) {
        const int r = e / BN;
        const int c = e % BN;
        const bool in = col0 + c < p;
        cp_async<sizeof(T)>(ss + r * BN + c, in ? Sd + static_cast<int64_t>(k0 + r) * p + col0 + c : Sd,
                            in ? sizeof(T) : 0);
      }
    }
    cp_async_commit();
  };

  T acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = T(0);
  T* const ps = Ps + tid;

  stage(0);
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<0>();
    __syncthreads();  // stage s is in; every thread is done with stage s - 1
    if (s + 1 < steps) stage(s + 1);  // in flight during this stage's sums
    const int chunk = s % chunks;
    const int kc = min(KC, m - chunk * KC);
    stage_sums_at<T, TM>(kc, acc, Bt[s & 1] + ty * TM, Ss[s & 1] + tx);
    if (chunk == chunks - 1 && s + 1 < steps) {  // dimension s / chunks is complete, not the last
      const bool first = s + 1 == chunks;         // the product so far is 1 * dot_0 = dot_0
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          T* q = ps + (i * TN + j) * NTHREADS;
          *q = first ? acc[i][j] : *q * acc[i][j];
          acc[i][j] = T(0);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int64_t r = row0 + ty * TM + i;
    if (r >= n) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = col0 + tx + j * TX;
      // The last dimension's dot times the product of the others (times 1 at d = 1).
      if (c < p) out[r * p + c] = steps == chunks ? acc[i][j] : ps[(i * TN + j) * NTHREADS] * acc[i][j];
    }
  }
}

template <typename T>
int launch(const void* B, const void* S, void* out, int d, int n, int m, int p, int vec, int device,
           void* stream) {
  if (n <= 0 || p <= 0) return 0;  // empty Phi: nothing to write
  const DeviceScope scope(device);
  if (scope.err != cudaSuccess) return static_cast<int>(scope.err);
  constexpr int BM = Micro<T>::TM * TY;
  const int64_t blocks = static_cast<int64_t>((n + BM - 1) / BM) * ((p + BN - 1) / BN);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  static LaunchCache cache;
  const cudaError_t err = allow_smem(phi_fused_kernel<T>, cache);
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int smem = static_cast<int>(sizeof(T)) * (2 * KC * (BM + 4) + 2 * KC * BN + Micro<T>::TM * TN * NTHREADS);
  phi_fused_kernel<T><<<static_cast<unsigned>(blocks), NTHREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(B), static_cast<const T*>(S), static_cast<T*>(out), d, n, m, p, vec != 0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points (loaded with ctypes).  `vec`: S's rows start on
// 16-byte boundaries (16-byte copies of S); `device` is the index of the card
// the tensors and the stream are on.
// The return value is the launch's cudaError_t.
extern "C" int gp_grief_phi_fused_f32(const void* B, const void* S, void* out, int d, int n, int m, int p,
                                      int vec, int device, void* stream) {
  return launch<float>(B, S, out, d, n, m, p, vec, device, stream);
}

extern "C" int gp_grief_phi_fused_f64(const void* B, const void* S, void* out, int d, int n, int m, int p,
                                      int vec, int device, void* stream) {
  return launch<double>(B, S, out, d, n, m, p, vec, device, stream);
}
