// SKI W^T W as a lattice stencil for Hopper (sm_90a):
//
//     out[b, c] = sum_{i < D}  A[i, c] * v[b, c + delta[i]],   0 <= c + delta[i] < M
//
// v (B, M) holds B lattice vectors, A (D, M) the coefficient tables of the
// D <= 3^d flat offsets delta (ascending; 81 at d = 4), built on the host
// from the interpolation weights (gp_grief_tpu_torch/ops/interp_stencil.py).
//
// Replaces the TPU kernel gp_grief_tpu/ops/interp_stencil.py:_apply_pallas
// (its pallas_call at :396).  That kernel DMA'd three windows of v per
// 8192-cell block, flushed its sum through the output every 8 terms (Mosaic's
// limits on VMEM and on how long values stay live), padded B to a multiple of
// 8 and cut it into slabs of 128 rows.  None of that applies on Hopper.
//
// Design: one thread per cell (blockIdx.x, threadIdx.x), slabs of up to
// R = 16 rows per block row (blockIdx.y).  The loop over the offsets reads
// each table entry A[i, c] once and applies it to all rows of the slab held
// in registers; reads of A[i, c] and v[b, c + delta] are coalesced across a
// warp.  v's reuse across the offsets (27 per leading-dimension group, a
// window of +-1057 cells at 32^4) is served by L1/L2.  Reads outside [0, M)
// are skipped, so no table entry ever multiplies an out-of-range value.  The
// sum runs in offset order, as the plain version's does.
//
// What bounds it: bytes.  The tables (D*M) are read once per slab, v and out
// once; 2*D*B*M flops are far below the FP32 balance point.  At 32^4 with
// B = 9 in f32: 340 + 38 + 38 MB, ~0.124 ms at 3.35 TB/s.

#include <cuda_runtime.h>

#include <cstdint>

#include "device_scope.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int R = 16;  // rows of v per block row

template <typename T>
__global__ void __launch_bounds__(THREADS) wtw_stencil_kernel(
    const T* __restrict__ v, const T* __restrict__ tables, const int64_t* __restrict__ deltas, int D,
    T* __restrict__ out, int B, int64_t M) {
  const int64_t c = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  if (c >= M) return;
  const int b0 = blockIdx.y * R;
  const int nb = min(R, B - b0);
  const T* vb = v + static_cast<int64_t>(b0) * M;
  T acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = T(0);
  for (int i = 0; i < D; ++i) {
    const int64_t s = c + deltas[i];
    if (s < 0 || s >= M) continue;
    const T a = tables[static_cast<int64_t>(i) * M + c];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r < nb) acc[r] += a * vb[static_cast<int64_t>(r) * M + s];
    }
  }
  T* ob = out + static_cast<int64_t>(b0) * M + c;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (r < nb) ob[static_cast<int64_t>(r) * M] = acc[r];
  }
}

template <typename T>
int launch(const void* v, const void* tables, const void* deltas, int D, void* out, int B, int64_t M,
           int device, void* stream) {
  if (B <= 0 || M <= 0) return 0;  // empty output: nothing to write
  const DeviceScope scope(device);
  if (scope.err != cudaSuccess) return static_cast<int>(scope.err);
  const int64_t blocks = (M + THREADS - 1) / THREADS;
  const int slabs = (B + R - 1) / R;
  if (blocks > 0x7fffffffLL || slabs > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(slabs));
  wtw_stencil_kernel<T><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(v), static_cast<const T*>(tables), static_cast<const int64_t*>(deltas), D,
      static_cast<T*>(out), B, M);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points (loaded with ctypes); `device` is the index of the
// card the tensors and the stream are on.  The return value is the launch's
// cudaError_t.
extern "C" int gp_grief_wtw_stencil_f32(const void* v, const void* tables, const void* deltas, int D,
                                        void* out, int B, long long M, int device, void* stream) {
  return launch<float>(v, tables, deltas, D, out, B, M, device, stream);
}

extern "C" int gp_grief_wtw_stencil_f64(const void* v, const void* tables, const void* deltas, int D,
                                        void* out, int B, long long M, int device, void* stream) {
  return launch<double>(v, tables, deltas, D, out, B, M, device, stream);
}
