// SKI W^T W as a lattice stencil for Hopper (sm_90a):
//
//     out[b, c] = sum_{i < D}  A[i, c] * v[b, c + delta[i]],   0 <= c + delta[i] < M
//
// v (B, M) holds B lattice vectors, A (D, M) the coefficient tables of the
// D <= 3^d flat offsets delta (ascending; 81 at d = 4), built on the host
// from the interpolation weights (gp_grief_tpu_torch/ops/interp_stencil.py).
//
// Replaces the TPU kernel gp_grief_tpu/ops/interp_stencil.py:_apply_pallas
// (its pallas_call at :396).  That kernel DMA'd one window of v per
// leading-dimension component of the offsets into VMEM for each 8192-cell
// block (_plan_windows), flushed its sum through the output every 8 terms and
// padded B to a multiple of 8 (Mosaic's limits).  The window idea carries
// over; the rest does not.
//
// What bounds it: bytes.  The tables (D*M) are read once per slab of rows,
// v and out once; 2*D*B*M flops are far below the FP32 balance point.  At
// 32^4 with B = 9 in f32: 340 + 38 + 38 MB, ~0.124 ms at 3.35 TB/s.  But v is
// read D times per cell and row: 3 GB at 32^4, B = 9, which L1/L2 serve no
// faster than ~5.7 TB/s.  Where those reads come from sets the time.
//
// Two members, one function, the same bits.  Each cell's sum runs over the
// offsets in ascending order, one fused multiply-add each (acc = fma(A, v,
// acc)); an offset whose c + delta lies outside [0, M) has A = 0 there and
// adds fma(0, 0, acc) = acc, so reading a zero in its place changes nothing.
// The host plan (ops/cuda/stencil.py:stencil_plan) picks the member:
//
// * The window member (wtw_window_kernel).  A persistent block takes work
//   items of C consecutive cells and a slab of up to R = 16 rows.  The offsets
//   fall into at most three groups, runs of ascending offsets that share their
//   leading-dimension component (the plan's groups; one group where the
//   lattice is small).  For each group the block stages, with cp.async, the
//   window of v the group's offsets reach, [c0 + base, c0 + base + width) of
//   every row of the slab, zero outside [0, M), into shared memory; the
//   next group's window (of this item or the next) is in flight in a second
//   buffer while this one is summed, where two fit; L2 keeps v (evict-last)
//   while the tables stream past it (evict-first).  Each thread owns CPT
//   cells strided by the block width, reads each table entry once
//   (coalesced, the next 9 offsets' entries in flight) and applies it to all
//   rows held in registers, reading v from shared memory.  The slab's row
//   count is a compile-time argument (a switch over 1..16), so the summing
//   loops carry no branch.  Taking the groups in order takes the offsets in
//   ascending order.  At 32^4, B = 9, f32: C = 1024 cells, 512 threads, two
//   113 KB windows; v's reads come to ~0.35 GB from L2 instead of 3 GB, and
//   the kernel takes 0.255 ms on an H100 (PERF.md section 6), about
//   twice its byte bound.
// * The cell member (wtw_cell_kernel): one thread a cell, R = 16 rows in
//   registers, v from L1/L2.  The plan sends it shapes whose window does not
//   fit shared memory even at C = 128 (e.g. 32^4 in f64 with 16 rows a slab).

#include <cuda_runtime.h>

#include <cstdint>

#include "device_helpers.cuh"
#include "device_scope.cuh"
#include "resident_grid.cuh"

namespace {

constexpr int R = 16;         // rows of v per slab, both members
constexpr int CELL_THREADS = 256;
constexpr int MAX_GROUPS = 3;

// ---------------------------------------------------------------------------
// The cell member.
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(CELL_THREADS) wtw_cell_kernel(
    const T* __restrict__ v, const T* __restrict__ tables, const int64_t* __restrict__ deltas, int D,
    T* __restrict__ out, int B, int64_t M) {
  const int64_t c = static_cast<int64_t>(blockIdx.x) * CELL_THREADS + threadIdx.x;
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
      if (r < nb) acc[r] = fma_rn(a, vb[static_cast<int64_t>(r) * M + s], acc[r]);
    }
  }
  T* ob = out + static_cast<int64_t>(b0) * M + c;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (r < nb) ob[static_cast<int64_t>(r) * M] = acc[r];
  }
}

// ---------------------------------------------------------------------------
// The window member.
// ---------------------------------------------------------------------------

struct Window {
  int groups;                  // 1..MAX_GROUPS
  int beg[MAX_GROUPS], end[MAX_GROUPS];  // each group's offsets [beg, end)
  int64_t base[MAX_GROUPS];    // window start, relative to the item's first cell
  int width[MAX_GROUPS];       // window length, elements
  int pitch;                   // shared-memory row length, elements
  int rows;                    // rows of v per slab (<= R)
  int buffers;                 // 1 or 2 windows in shared memory
  int copy;                    // bytes per cp.async: 16, or sizeof(T)
  int64_t tiles;               // ceil(M / C)
  int64_t work;                // tiles * slabs
};

// A table entry, read once: no L1 line, evict-first in L2.
__device__ __forceinline__ float load_once(const float* p, uint64_t pol) {
  float x;
  asm volatile("ld.global.L1::no_allocate.L2::cache_hint.f32 %0, [%1], %2;\n" : "=f"(x) : "l"(p), "l"(pol));
  return x;
}
__device__ __forceinline__ double load_once(const double* p, uint64_t pol) {
  double x;
  asm volatile("ld.global.L1::no_allocate.L2::cache_hint.f64 %0, [%1], %2;\n" : "=d"(x) : "l"(p), "l"(pol));
  return x;
}
__device__ __forceinline__ uint64_t evict_first_policy() {
  uint64_t pol;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(pol));
  return pol;
}
__device__ __forceinline__ uint64_t evict_last_policy() {
  uint64_t pol;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n" : "=l"(pol));
  return pol;
}

// Table entries loaded per chunk: U offsets at a time, the next chunk's in
// flight while this one is summed.
template <typename T> struct Ahead { static constexpr int U = 9; };
template <> struct Ahead<double> { static constexpr int U = 3; };

// w.field[g] for a group index g known only at run time, without indexing
// the parameter struct (which would copy it to local memory).
template <typename X>
__device__ __forceinline__ X pick(const X (&a)[MAX_GROUPS], int g) {
  return g == 0 ? a[0] : (g == 1 ? a[1] : a[2]);
}

// acc[r][k] = fma(a[u][k], v, acc[r][k]) for the U offsets of a chunk (their
// places in the window at loc), rows r < NB, cells tid + k NT (vw = window +
// tid).  NB is a compile-time count, so the loops have no branch inside.
template <typename T, int NT, int CPT, int U, int NB>
__device__ __forceinline__ void sum_rows(T (&acc)[R][CPT], const T (&a)[U][CPT], const T* vw, const int* loc,
                                         int cnt, int pitch) {
  if (cnt == U) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const T* p = vw + loc[u];
#pragma unroll
      for (int r = 0; r < NB; ++r)
#pragma unroll
        for (int k = 0; k < CPT; ++k) acc[r][k] = fma_rn(a[u][k], p[r * pitch + k * NT], acc[r][k]);
    }
    return;
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {  // a group's last, shorter chunk
    if (u >= cnt) break;
    const T* p = vw + loc[u];
#pragma unroll
    for (int r = 0; r < NB; ++r)
#pragma unroll
      for (int k = 0; k < CPT; ++k) acc[r][k] = fma_rn(a[u][k], p[r * pitch + k * NT], acc[r][k]);
  }
}

// sum_rows for the slab's nb rows (1 <= nb <= R).
template <typename T, int NT, int CPT, int U, int NB = R>
__device__ __forceinline__ void sum_slab(int nb, T (&acc)[R][CPT], const T (&a)[U][CPT], const T* vw,
                                         const int* loc, int cnt, int pitch) {
  if constexpr (NB > 1) {
    if (nb < NB) {
      sum_slab<T, NT, CPT, U, NB - 1>(nb, acc, a, vw, loc, cnt, pitch);
      return;
    }
  }
  sum_rows<T, NT, CPT, U, NB>(acc, a, vw, loc, cnt, pitch);
}

template <typename T, int NT, int CPT>
__global__ void __launch_bounds__(NT, 1) wtw_window_kernel(
    const T* __restrict__ v, const T* __restrict__ tables, const int64_t* __restrict__ deltas, int D,
    T* __restrict__ out, int B, int64_t M, const Window w) {
  constexpr int C = NT * CPT;
  constexpr int U = Ahead<T>::U;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const win = reinterpret_cast<T*>(smem_raw);
  const int buf_elems = w.rows * w.pitch;
  // After the windows: each offset's place in its group's window.
  int* const loc = reinterpret_cast<int*>(win + w.buffers * buf_elems);
  const int tid = threadIdx.x;
  const int G = w.groups;
  const int64_t items = blockIdx.x < w.work ? (w.work - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const int64_t steps = items * G;
  const int ch = w.copy / static_cast<int>(sizeof(T));  // elements per copy

  // v's windows evict-last (neighbouring items and groups read the same cells
  // again soon); table entries evict-first (each is read once).
  const uint64_t keep = evict_last_policy(), once = evict_first_policy();
  for (int i = tid; i < D; i += NT) {
    const int g = i < w.end[0] ? 0 : (i < w.end[1] ? 1 : 2);
    loc[i] = static_cast<int>(deltas[i] - pick(w.base, g));
  }

  // Step s: group s % G of this block's item s / G.
  auto item_of = [&](int64_t s) { return blockIdx.x + (s / G) * static_cast<int64_t>(gridDim.x); };
  auto stage = [&](int64_t s, T* dst) {
    const int64_t item = item_of(s);
    const int g = static_cast<int>(s % G);
    const int b0 = static_cast<int>(item / w.tiles) * w.rows;
    const int nb = min(w.rows, B - b0);
    const int64_t start = (item % w.tiles) * C + pick(w.base, g);
    const int width = pick(w.width, g);
    for (int r = 0; r < nb; ++r) {
      const T* src = v + static_cast<int64_t>(b0 + r) * M;
      T* d = dst + r * w.pitch;
      for (int j = tid * ch; j < width; j += NT * ch) {
        const int64_t gi = start + j;
        // start and M are multiples of ch: a chunk lies wholly inside or outside.
        const bool in = gi >= 0 && gi + ch <= M;
        if (w.copy == 16)
          cp_async<16>(d + j, in ? src + gi : src, in ? 16 : 0, keep);
        else
          cp_async<sizeof(T)>(d + j, in ? src + gi : src, in ? static_cast<int>(sizeof(T)) : 0, keep);
      }
    }
    cp_async_commit();
  };
  // Table entries of offsets i0 .. i0 + U (those of step s's group) at step
  // s's cells; zero past the group or the lattice.
  auto load = [&](int64_t s, int i0, T (&a)[U][CPT]) {
    const int64_t c0 = (item_of(s) % w.tiles) * C;
    const int end = pick(w.end, static_cast<int>(s % G));
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int k = 0; k < CPT; ++k) {
        const int64_t c = c0 + tid + k * NT;
        a[u][k] = (i0 + u < end && c < M) ? load_once(tables + static_cast<int64_t>(i0 + u) * M + c, once) : T(0);
      }
    }
  };

  T acc[R][CPT];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int k = 0; k < CPT; ++k) acc[r][k] = T(0);

  T next[U][CPT];
  if (steps > 0) {
    stage(0, win);
    load(0, w.beg[0], next);
  }
  for (int64_t s = 0; s < steps; ++s) {
    cp_async_wait<0>();
    __syncthreads();  // step s's window is in (and loc); every thread is done with step s - 1
    const T* cur = win;
    if (w.buffers == 2) {
      cur += (s & 1) * buf_elems;
      if (s + 1 < steps) stage(s + 1, win + ((s + 1) & 1) * buf_elems);
    }
    const int64_t item = item_of(s);
    const int g = static_cast<int>(s % G);
    const int gend = pick(w.end, g);
    const int b0 = static_cast<int>(item / w.tiles) * w.rows;
    const int nb = min(w.rows, B - b0);
    const int64_t c0 = (item % w.tiles) * C;

    for (int i0 = pick(w.beg, g); i0 < gend; i0 += U) {
      T a[U][CPT];
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int k = 0; k < CPT; ++k) a[u][k] = next[u][k];
      // The following chunk: the rest of this group, else the next step's first.
      if (i0 + U < gend) {
        load(s, i0 + U, next);
      } else if (s + 1 < steps) {
        load(s + 1, pick(w.beg, static_cast<int>((s + 1) % G)), next);
      }
      sum_slab<T, NT, CPT, U>(nb, acc, a, cur + tid, loc + i0, min(U, gend - i0), w.pitch);
    }

    if (g == G - 1) {  // the item's last group: its sums are complete
#pragma unroll
      for (int r = 0; r < R; ++r) {
#pragma unroll
        for (int k = 0; k < CPT; ++k) {
          const int64_t c = c0 + tid + k * NT;
          if (r < nb && c < M) __stcs(out + static_cast<int64_t>(b0 + r) * M + c, acc[r][k]);
          acc[r][k] = T(0);
        }
      }
    }
    if (w.buffers == 1) {
      __syncthreads();  // every thread is done with the one window
      if (s + 1 < steps) stage(s + 1, win);
    }
  }
}

// Host plan layout (ops/cuda/stencil.py:_c_plan): member (0 cell, 1 window),
// rows, cells, buffers, pitch, groups, then (beg, end, base, width) per group.
enum { P_MEMBER, P_ROWS, P_CELLS, P_BUFFERS, P_PITCH, P_GROUPS, P_GROUP0 };

template <typename T, int NT, int CPT>
int launch_window(const T* v, const T* tables, const int64_t* deltas, int D, T* out, int B, int64_t M,
                  const Window& w, cudaStream_t stream) {
  static LaunchCache cache;
  auto kern = wtw_window_kernel<T, NT, CPT>;
  const int smem = w.buffers * w.rows * w.pitch * static_cast<int>(sizeof(T)) + 4 * D;
  if (smem > SMEM_LIMIT) return static_cast<int>(cudaErrorInvalidValue);
  int grid = 0;
  const cudaError_t err = resident_grid(kern, cache, NT, smem, w.work, grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<grid, NT, smem, stream>>>(v, tables, deltas, D, out, B, M, w);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* v_, const void* tables_, const void* deltas_, int D, void* out_, int B, int64_t M,
           const long long* plan, int copy, int device, void* stream_) {
  if (B <= 0 || M <= 0) return 0;  // empty output: nothing to write
  const DeviceScope scope(device);
  if (scope.err != cudaSuccess) return static_cast<int>(scope.err);
  const T* v = static_cast<const T*>(v_);
  const T* tables = static_cast<const T*>(tables_);
  const int64_t* deltas = static_cast<const int64_t*>(deltas_);
  T* out = static_cast<T*>(out_);
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_);

  if (plan[P_MEMBER] == 0) {
    const int64_t blocks = (M + CELL_THREADS - 1) / CELL_THREADS;
    const int slabs = (B + R - 1) / R;
    if (blocks > 0x7fffffffLL || slabs > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
    const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(slabs));
    wtw_cell_kernel<T><<<grid, CELL_THREADS, 0, stream>>>(v, tables, deltas, D, out, B, M);
    return static_cast<int>(cudaGetLastError());
  }

  Window w{};
  w.rows = static_cast<int>(plan[P_ROWS]);
  const int cells = static_cast<int>(plan[P_CELLS]);
  w.buffers = static_cast<int>(plan[P_BUFFERS]);
  w.pitch = static_cast<int>(plan[P_PITCH]);
  w.groups = static_cast<int>(plan[P_GROUPS]);
  w.copy = copy;
  if (w.rows < 1 || w.rows > R || w.groups < 1 || w.groups > MAX_GROUPS || (w.buffers != 1 && w.buffers != 2) ||
      (copy != 16 && copy != static_cast<int>(sizeof(T))))
    return static_cast<int>(cudaErrorInvalidValue);
  for (int g = w.groups; g < MAX_GROUPS; ++g) w.end[g] = D;  // loc's group lookup
  for (int g = 0; g < w.groups; ++g) {
    const long long* p = plan + P_GROUP0 + 4 * g;
    w.beg[g] = static_cast<int>(p[0]);
    w.end[g] = static_cast<int>(p[1]);
    w.base[g] = p[2];
    w.width[g] = static_cast<int>(p[3]);
    if (w.beg[g] < 0 || w.end[g] > D || w.beg[g] >= w.end[g] || w.width[g] > w.pitch)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  w.tiles = (M + cells - 1) / cells;
  w.work = w.tiles * ((B + w.rows - 1) / w.rows);
  switch (cells) {
    case 1024: return launch_window<T, 512, 2>(v, tables, deltas, D, out, B, M, w, stream);
    case 512: return launch_window<T, 512, 1>(v, tables, deltas, D, out, B, M, w, stream);
    case 256: return launch_window<T, 256, 1>(v, tables, deltas, D, out, B, M, w, stream);
    case 128: return launch_window<T, 128, 1>(v, tables, deltas, D, out, B, M, w, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C entry points (loaded with ctypes); `plan` is the host plan above,
// `copy` the bytes of one cp.async of v, `device` the index of the card the
// tensors and the stream are on.  The return value is the launch's
// cudaError_t.
extern "C" int gp_grief_wtw_stencil_f32(const void* v, const void* tables, const void* deltas, int D,
                                        void* out, int B, long long M, const long long* plan, int copy,
                                        int device, void* stream) {
  return launch<float>(v, tables, deltas, D, out, B, M, plan, copy, device, stream);
}

extern "C" int gp_grief_wtw_stencil_f64(const void* v, const void* tables, const void* deltas, int D,
                                        void* out, int B, long long M, const long long* plan, int copy,
                                        int device, void* stream) {
  return launch<double>(v, tables, deltas, D, out, B, M, plan, copy, device, stream);
}
