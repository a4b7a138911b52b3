// SKI interpolation transpose W^T for Hopper (sm_90a):
//
//     out[b, c] = sum_{j = start[c]}^{end[c] - 1}  w[j] * u[b, src[j]]
//
// u holds B point-space vectors point-major, element (b, p) at u[p * B + b],
// so the rows one stream entry gathers are adjacent (one or two 32-byte
// sectors, not one a row); out (B, M) is the lattice result, batch-major as
// the solvers keep it.  The (src, w, start, end) arrays are the cell-sorted corner-update
// stream of the model's interpolation plan
// (gp_grief_tpu_torch/ops/interp.py:InterpPlan), a CSR form of W^T with at
// most 2^d entries per point, whose cells' segments follow one another
// (start[c + 1] == end[c]).
//
// Replaces the TPU kernel gp_grief_tpu/ops/interp.py:make_onehot_rmatvec
// (its pallas_call at :712).  The TPU has no fast gather, so that kernel
// turned each 1024-cell tile's gather into one-hot (R, C) matrices built by
// compares and an exact-f32 matrix-unit dot, plus an overflow scatter for
// cells with more than K contributions.  Hopper gathers from L2 well, so this
// is a deterministic segmented sum instead: no one-hot tiles, no overflow
// stream, no atomics on the output.
//
// Design: a block owns 256 consecutive cells and rows b0..b0+nb-1 of u
// (nb <= R), and so one contiguous range of the stream.  Where the stream
// holds at most DIRECT entries a cell (the data solver's 1.6 at n = 100k,
// M = 32^4), each thread walks its own segment from device memory, as the first
// version of this kernel did, with no shared memory to cost occupancy.  Denser streams are
// walked in chunks of CH entries (CH sized at launch to fill ~40 KB of
// shared memory).  For each chunk:
//   1. every thread takes entries tid, tid + 256, ... : coalesced loads of
//      src and w, and the gathers u[b, src[j]] for the slab's rows, GB entries
//      (GB * nb loads) in flight per thread, staged in shared memory.  The
//      gathers, the costly part, are spread evenly over the block whatever
//      the segments' lengths.
//   2. each thread sums its cell's part of the chunk from shared memory, in
//      stream order, acc = fma(w[j], u[b, src[j]], acc), carried in registers
//      across chunks: the same FMA chain, in the same order, as the first
//      version of this kernel (one thread walking each segment), so the
//      same bits.
//   3. a cell of more than LONG entries in all (clustered points) is instead
//      summed by a warp: lane-strided partial FMA chains over its part of the
//      chunk, a fixed xor-butterfly, added to the owner's registers.  Its
//      bits then differ from a serial sum, the same in every launch.  Without
//      it one thread would walk the whole segment (hundreds of entries) while
//      its block waits.
// out is written once, coalesced across the warp.  Offsets are 64-bit.
//
// What bounds it: bytes, and the gathers' L2 sectors.  Each launch reads u
// (B*n), the stream (8 bytes per entry in f32), the pointers (2*M*4) and
// writes out (B*M); the 2*L*B flops are negligible.  At n = 1M, M = 32^4,
// B = 1: 144 MB, 43 us at 3.35 TB/s; each of the 16M gathers touches one
// 32-byte sector of u (4 MB, L2-resident), served in part by L1 since a
// block's 256 cells share ~4 of each point's 16 corners.  At n = 100k, B = 9:
// ~62 MB, ~19 us, the output's 36 MB the largest part.

#include <cuda_runtime.h>

#include <cstdint>

#include "device_helpers.cuh"
#include "device_scope.cuh"

namespace {

constexpr int THREADS = 256;  // cells per block
constexpr int WARPS = THREADS / 32;
constexpr int LONG = 64;              // longer segments are summed by a warp
constexpr int DIRECT = 2;             // streams of at most this many entries a cell skip the staging
constexpr int SMEM_BUDGET = 40960;    // bytes of shared memory for a chunk
constexpr int ERR_SHAPE = -1;

// Shared-memory layout of one chunk of CH entries: w[CH], g[CH][ldg] (the
// gathered u values, ldg = nb rounded up to odd), then the long cells' slots:
// their chunk ranges (int2) and warp partials [slots][R].
template <typename T>
struct Chunk {
  int CH, ldg, slots;
  __host__ __device__ Chunk(int ch, int nb) : CH(ch), ldg(nb | 1), slots(ch / LONG + 2) {}
  __host__ __device__ static int ldg_of(int nb) { return nb | 1; }
  __host__ __device__ int64_t bytes(int R) const {
    return static_cast<int64_t>(CH) * (1 + ldg) * sizeof(T) + static_cast<int64_t>(slots) * R * sizeof(T) +
           static_cast<int64_t>(slots) * sizeof(int2) + 16;
  }
};

template <typename T, int R, int GB, bool STAGED>
__global__ void __launch_bounds__(THREADS) interp_wt_kernel(
    const T* __restrict__ u, const int32_t* __restrict__ src, const T* __restrict__ w,
    const int32_t* __restrict__ start, const int32_t* __restrict__ end, T* __restrict__ out, int B, int64_t M,
    int CH) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int b0 = blockIdx.y * R;
  const int nb = min(R, B - b0);
  const Chunk<T> ck(CH, nb);
  T* ws = reinterpret_cast<T*>(smem_raw);
  T* gs = ws + CH;
  T* part = gs + static_cast<int64_t>(CH) * ck.ldg;
  int2* list = reinterpret_cast<int2*>(part + ck.slots * R);
  int* nlong = reinterpret_cast<int*>(list + ck.slots);

  const int64_t c0 = static_cast<int64_t>(blockIdx.x) * THREADS;
  const int64_t c = c0 + tid;
  const int64_t clast = min(c0 + THREADS, M) - 1;
  const bool live = c < M;
  const int32_t s = live ? start[c] : 0, e = live ? end[c] : 0;
  const bool is_long = e - s > LONG;
  const int32_t s0 = start[c0], s1 = end[clast];
  const T* ub = u + b0;

  T acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = T(0);

  if (!STAGED) {
    // A sparse stream (at most DIRECT entries a cell on average): each thread
    // walks its own segment; neighbouring threads' segments are neighbouring
    // runs of the stream, so the reads stay coalesced, and staging would
    // cost more in barriers and occupancy than it saves.  The same FMA chain.
    for (int32_t j = s; j < e; ++j) {
      const T* up = ub + static_cast<int64_t>(src[j]) * B;
      const T wj = w[j];
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (r < nb) acc[r] = fma_rn(wj, up[r], acc[r]);
    }
  }

  for (int32_t k0 = s0; STAGED && k0 < s1; k0 += CH) {
    const int cnt = min(static_cast<int32_t>(CH), s1 - k0);
    if (tid == 0) *nlong = 0;
    // 1. Stage w and the gathered rows of u for entries k0 .. k0 + cnt - 1.
    for (int i0 = tid; i0 < cnt; i0 += GB * THREADS) {
      T wv[GB], gv[GB][R];
#pragma unroll
      for (int q = 0; q < GB; ++q) {
        const int i = i0 + q * THREADS;
        if (i < cnt) {
          const T* up = ub + static_cast<int64_t>(src[k0 + i]) * B;
          wv[q] = w[k0 + i];
#pragma unroll
          for (int r = 0; r < R; ++r)
            if (r < nb) gv[q][r] = up[r];
        }
      }
#pragma unroll
      for (int q = 0; q < GB; ++q) {
        const int i = i0 + q * THREADS;
        if (i < cnt) {
          ws[i] = wv[q];
#pragma unroll
          for (int r = 0; r < R; ++r)
            if (r < nb) gs[static_cast<int64_t>(i) * ck.ldg + r] = gv[q][r];
        }
      }
    }
    __syncthreads();

    // 2. Each cell's part of the chunk, in stream order.
    const int a = max(s, k0) - k0, b = min(e, k0 + cnt) - k0;
    int slot = -1;
    if (!is_long) {
      for (int i = a; i < b; ++i) {
        const T wi = ws[i];
        const T* gi = gs + static_cast<int64_t>(i) * ck.ldg;
#pragma unroll
        for (int r = 0; r < R; ++r)
          if (r < nb) acc[r] = fma_rn(wi, gi[r], acc[r]);
      }
    } else if (a < b) {
      slot = atomicAdd(nlong, 1);  // which slot does not change the sums
      list[slot] = make_int2(a, b);
    }
    __syncthreads();

    // 3. Long cells: one warp each, lane-strided partials and a butterfly.
    const int nl = *nlong;
    if (nl > 0) {
      for (int q = warp; q < nl; q += WARPS) {
        const int2 rg = list[q];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (r >= nb) break;
          T p = T(0);
          for (int i = rg.x + lane; i < rg.y; i += 32) p = fma_rn(ws[i], gs[static_cast<int64_t>(i) * ck.ldg + r], p);
#pragma unroll
          for (int off = 16; off > 0; off /= 2) p += __shfl_xor_sync(0xffffffffu, p, off);
          if (lane == 0) part[q * R + r] = p;
        }
      }
      __syncthreads();
      if (slot >= 0) {
#pragma unroll
        for (int r = 0; r < R; ++r)
          if (r < nb) acc[r] += part[slot * R + r];
      }
    }
    __syncthreads();  // the chunk's shared memory is free for the next one
  }

  if (live) {
    T* ob = out + static_cast<int64_t>(b0) * M + c;
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (r < nb) ob[static_cast<int64_t>(r) * M] = acc[r];
  }
}

// Entries per chunk: the most that fit SMEM_BUDGET, a multiple of THREADS.
template <typename T>
int chunk_entries(int nb, int R) {
  int CH = SMEM_BUDGET / ((1 + Chunk<T>::ldg_of(nb)) * static_cast<int>(sizeof(T))) / THREADS * THREADS;
  while (CH > THREADS && Chunk<T>(CH, nb).bytes(R) > SMEM_BUDGET) CH -= THREADS;
  return CH < THREADS ? THREADS : CH;
}

template <typename T, int R, int GB>
int launch_rows(const void* u, const void* src, const void* w, const void* start, const void* end, void* out, int B,
                int64_t M, int64_t L, cudaStream_t stream) {
  const int64_t blocks = (M + THREADS - 1) / THREADS;
  const int slabs = (B + R - 1) / R;
  if (blocks > 0x7fffffffLL || slabs > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int nb = B < R ? B : R;
  const bool staged = L > DIRECT * M;
  const int CH = chunk_entries<T>(nb, R);
  const int64_t smem = staged ? Chunk<T>(CH, nb).bytes(R) : 0;
  if (smem > 48 * 1024) return ERR_SHAPE;  // static limit: no attribute needed below it
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(slabs));
  auto kern = staged ? interp_wt_kernel<T, R, GB, true> : interp_wt_kernel<T, R, GB, false>;
  kern<<<grid, THREADS, static_cast<int>(smem), stream>>>(
      static_cast<const T*>(u), static_cast<const int32_t*>(src), static_cast<const T*>(w),
      static_cast<const int32_t*>(start), static_cast<const int32_t*>(end), static_cast<T*>(out), B, M, CH);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* u, const void* src, const void* w, const void* start, const void* end, void* out, int B,
           int64_t M, int64_t L, int device, void* stream) {
  if (B <= 0 || M <= 0) return 0;  // empty output: nothing to write
  const DeviceScope scope(device);
  if (scope.err != cudaSuccess) return static_cast<int>(scope.err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // One row: 8 entries' gathers in flight a thread; more rows: slabs of 16,
  // one entry's rows at a time (registers: three to four blocks an SM).
  return B == 1 ? launch_rows<T, 1, 8>(u, src, w, start, end, out, B, M, L, st)
                : launch_rows<T, 16, 1>(u, src, w, start, end, out, B, M, L, st);
}

}  // namespace

// Plain C entry points (loaded with ctypes): u point-major (n, B), the
// stream, out (B, M), the stream's length L, the
// device index of the tensors and the stream.  The return value is the launch's cudaError_t, or
// -1 for arguments the kernel does not take.
extern "C" int gp_grief_interp_wt_f32(const void* u, const void* src, const void* w, const void* start,
                                      const void* end, void* out, int B, long long M, long long L, int device,
                                      void* stream) {
  return launch<float>(u, src, w, start, end, out, B, M, L, device, stream);
}

extern "C" int gp_grief_interp_wt_f64(const void* u, const void* src, const void* w, const void* start,
                                      const void* end, void* out, int B, long long M, long long L, int device,
                                      void* stream) {
  return launch<double>(u, src, w, start, end, out, B, M, L, device, stream);
}
