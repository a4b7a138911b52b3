// SKI interpolation transpose W^T for Hopper (sm_90a):
//
//     out[b, c] = sum_{j = start[c]}^{end[c] - 1}  w[j] * u[b, src[j]]
//
// u holds B point-space vectors, handed over point-major as uT (n, B); out
// (B, M) is the lattice result, batch-major as the solvers keep it.  The
// (src, w, start, end) arrays are the cell-sorted corner-update stream of the
// model's interpolation plan (gp_grief_tpu_torch/ops/interp.py:InterpPlan),
// a CSR form of W^T with at most 2^d entries per point.
//
// Replaces the TPU kernel gp_grief_tpu/ops/interp.py:make_onehot_rmatvec
// (its pallas_call at :712).  The TPU has no fast gather, so that kernel
// turned each 1024-cell tile's gather into one-hot (R, C) matrices built by
// compares and an exact-f32 matrix-unit dot, plus an overflow scatter for
// cells with more than K contributions.  Hopper gathers from L2 well, so this
// is a deterministic segmented sum instead: no one-hot tiles, no overflow
// stream, no atomics.
//
// Design: one thread per lattice cell (blockIdx.x, threadIdx.x), slabs of up
// to R = 16 rows of u per block row (blockIdx.y), the row sums held in
// registers.  Each cell's short sum (the points whose cell has c as a
// corner) runs in stream order, so two launches give the same bits and the
// sums are short exact-f32-class sums, as the SLQ log-det needs.  u is read
// by gather through L2 (n = 100k, B = 9: 3.6 MB), point-major, so the B
// values one stream entry needs are adjacent (one or two 32-byte sectors,
// not B); out is written once, coalesced across the warp.  Offsets are
// 64-bit.
//
// What bounds it: bytes.  Each launch reads u (B*n), the stream (8 bytes per
// entry in f32), the pointers (2*M*4) and writes out (B*M); the 2*L*B flops
// are negligible (the wrapper's transpose of u adds 2*B*n).  At n = 100k,
// M = 32^4, B = 9 that is ~62 MB, ~19 us at 3.35 TB/s.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int R = 16;  // rows of u per block row

template <typename T>
__global__ void __launch_bounds__(THREADS) interp_wt_kernel(
    const T* __restrict__ uT, const int32_t* __restrict__ src, const T* __restrict__ w,
    const int32_t* __restrict__ start, const int32_t* __restrict__ end, T* __restrict__ out,
    int B, int64_t M) {
  const int64_t c = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  if (c >= M) return;
  const int b0 = blockIdx.y * R;
  const int nb = min(R, B - b0);
  T acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = T(0);
  const int32_t s = start[c], e = end[c];
  for (int32_t j = s; j < e; ++j) {
    const T* up = uT + static_cast<int64_t>(src[j]) * B + b0;
    const T wj = w[j];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r < nb) acc[r] += wj * up[r];
    }
  }
  T* ob = out + static_cast<int64_t>(b0) * M + c;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (r < nb) ob[static_cast<int64_t>(r) * M] = acc[r];
  }
}

template <typename T>
int launch(const void* uT, const void* src, const void* w, const void* start, const void* end, void* out,
           int B, int64_t M, void* stream) {
  if (B <= 0 || M <= 0) return 0;  // empty output: nothing to write
  const int64_t blocks = (M + THREADS - 1) / THREADS;
  const int slabs = (B + R - 1) / R;
  if (blocks > 0x7fffffffLL || slabs > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(slabs));
  interp_wt_kernel<T><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(uT), static_cast<const int32_t*>(src), static_cast<const T*>(w),
      static_cast<const int32_t*>(start), static_cast<const int32_t*>(end), static_cast<T*>(out), B, M);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points (loaded with ctypes); the return value is the
// launch's cudaError_t.
extern "C" int gp_grief_interp_wt_f32(const void* uT, const void* src, const void* w, const void* start,
                                      const void* end, void* out, int B, long long M, void* stream) {
  return launch<float>(uT, src, w, start, end, out, B, M, stream);
}

extern "C" int gp_grief_interp_wt_f64(const void* uT, const void* src, const void* w, const void* start,
                                      const void* end, void* out, int B, long long M, void* stream) {
  return launch<double>(uT, src, w, start, end, out, B, M, stream);
}
