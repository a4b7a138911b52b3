// Kronecker matvec passes for Hopper (sm_90a):
//
//     out = (K_i ⊗ ... ⊗ K_j) applied to axes i..j of x viewed as (pre, n_i..n_j, post)
//
// One launch contracts one group of adjacent lattice axes and moves the
// tensor through device memory once (one read, one write).  A chain of such
// passes computes (⊗_d K_d)·V for V (M, B), M = Π m_d; the pass plan lives in
// gp_grief_tpu_torch/ops/cuda/kron.py.
//
// Replaces the TPU kernels of gp_grief_tpu/ops/pallas/kron_pallas.py:
//   K2 (kron_matvec_slab):  _fused_mid_pair_pass :357, _mid_widened_pass :304,
//                           _mid2_fused_pass :457;
//   K3 (kron_matvec_fused): _tail_group_pass :695, _mid_group_pass :785.
// Their pass structure (lane width 128, K ⊗ I_G widening, an explicit
// 1024-wide K_{d-1} ⊗ K_d pair matrix, VMEM budgets, hi/lo bf16 splits)
// follows TPU rules and is not carried over.  Two members here:
//
// * kron_tile_kernel, for axes of at most 64 points: a block stages the
//   group's full extent (up to three axes) times a tile of P trailing
//   columns in shared memory, with the factors beside it, and contracts the
//   axes one after another in place.  Each thread takes whole fibres into
//   registers, so a fibre is read before any of its outputs is written.
//   At 32^5 the plan is two passes: axes (2,3,4) with P = 1 (a 32x32x33
//   f32 tile, 135 KB, contiguous in memory) and axes (0,1) with P = 32.
// * kron_wide_kernel, for one axis wider than 64 (the 512-wide factors of
//   the 8x512x512 lattice): a batched SIMT GEMM, 128x128x8 tiles, 8x8
//   outputs a thread, the next chunk prefetched into registers; C = X·Kᵀ
//   when the axis is last, C_p = K·X_p otherwise.
//
// What bounds it on an H100 SXM (3.35 TB/s, 67 TFLOP/s FP32 FMA):
//   32^5 (M = 33.5M, B = 1): 2·M·5·32 = 10.7 GFLOP against at least one read
//   and one write of 134 MB, 80 µs of memory, 160 µs of FP32 FMA issue.  The
//   two-pass plan moves 403 MB with bf16 storage between passes (120 µs).
//   The tile kernel keeps one block per SM at a 135 KB tile, so its loads,
//   FMAs and stores do not overlap (each thread keeps 8 loads in flight);
//   a bf16 tile, two blocks per SM or tensor-core (mma.sync bf16)
//   contractions are the next steps.
//   8x512x512 (M = 2.1M): 2·M·(8+512+512) = 4.33 GFLOP FP32, 65 µs, with
//   16.8 MB of traffic (5 µs, L2-resident): FMA-bound, so the 512-wide axes
//   go to the register-blocked GEMM, not to the tile kernel.
//
// Grades (template parameter FAST):
//   exact: FP32 FMA on the operands as given (the JAX reference's HIGHEST).
//   fast:  every operand (factor entries and the vector entering each
//          contraction) rounded to bf16, products accumulated in f32.  The
//          result of a pass may be stored as bf16 (out_bf16), which rounds it
//          exactly as the next contraction's operand rounding would.  The
//          vector may arrive as bf16 (the mixed16 CG state).
// Both grades use FMA on CUDA cores; the fast grade does not yet use the
// tensor cores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int SMEM_LIMIT = 232448;  // bytes a block can use on sm_90
constexpr int TILE_THREADS = 512;
constexpr int LOAD_BATCH = 8;  // tile kernel: global loads in flight per thread
constexpr int WIDE_THREADS = 256;
constexpr int WB = 128;  // wide kernel: output tile edge
constexpr int WK = 8;    // wide kernel: depth of one staged chunk
constexpr int WPAD = WB + 4;
constexpr int WLOADS = WB * WK / WIDE_THREADS;  // operand elements a thread stages per chunk

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <bool FAST> __device__ __forceinline__ float grade(float v) {
  return FAST ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

struct TileArgs {
  const float* K[3];
  int g;
  int n[3];
  int o[3];
  int npad[3];  // n rounded up to 4: factor rows in shared memory
  int64_t pre;
  int64_t post;
  int P;        // trailing columns per block (1: no column axis)
  int64_t ptiles;
  int stride[4];  // shared-memory strides of axes 0..g-1 and of the column axis
  int koff[3];    // float offset of each factor in shared memory
  // When every axis but the innermost shared-memory one has its input
  // (output) extent in shared memory, a staged tile is rows of row_stride
  // floats, and an element's offsets need one division instead of one per axis.
  bool in_rows, out_rows;
  int row_stride;
};

// Shared-memory offset, and global offset relative to the tile's first
// element, of element e of a tile staged in (group axes..., column) order;
// IN selects the input extents n (loads) or the output extents o (stores).
template <bool IN>
__device__ __forceinline__ int tile_offsets(const TileArgs& a, int e, int pv, int64_t& goff) {
  if (IN ? a.in_rows : a.out_rows) {
    const int len = a.P > 1 ? pv : (IN ? a.n[a.g - 1] : a.o[a.g - 1]);
    const int r = e / len, c = e - r * len;
    goff = a.P > 1 ? static_cast<int64_t>(r) * a.post + c : e;
    return r * a.row_stride + c;
  }
  int rest = e, s = 0, q = 0;
  if (a.P > 1) {
    q = rest % pv;
    rest /= pv;
  }
  goff = static_cast<int64_t>(rest) * a.post + q;
  for (int ax = a.g - 1; ax >= 0; --ax) {
    const int ext = IN ? a.n[ax] : a.o[ax];
    s += (rest % ext) * a.stride[ax];
    rest /= ext;
  }
  return s + q;
}

// One fibre of axis t: all other indices fixed.  Fibres are enumerated with
// the column index fastest, then the remaining axes from the last, so
// neighbouring threads touch neighbouring shared-memory words.
__device__ __forceinline__ int fibre_base(const TileArgs& a, const int* cur, int t, int f, int pv) {
  int base = 0;
  if (a.P > 1) {
    base = f % pv;
    f /= pv;
  }
  for (int ax = a.g - 1; ax >= 0; --ax) {
    if (ax == t) continue;
    base += (f % cur[ax]) * a.stride[ax];
    f /= cur[ax];
  }
  return base;
}

template <bool FAST, int MAXN, typename XT, typename OT>
__global__ void __launch_bounds__(TILE_THREADS)
kron_tile_kernel(const XT* __restrict__ x, OT* __restrict__ out, TileArgs a) {
  extern __shared__ __align__(16) float smem[];
  float* tile = smem;
  const int tid = threadIdx.x;

  for (int ax = 0; ax < a.g; ++ax) {
    const float* K = a.K[ax];
    float* Ks = smem + a.koff[ax];
    const int n = a.n[ax], np = a.npad[ax], cnt = a.o[ax] * np;
    for (int e = tid; e < cnt; e += TILE_THREADS) {
      const int r = e / np, c = e % np;
      Ks[e] = c < n ? grade<FAST>(K[static_cast<int64_t>(r) * n + c]) : 0.f;
    }
  }

  int64_t nin = 1, nout = 1;
  for (int ax = 0; ax < a.g; ++ax) {
    nin *= a.n[ax];
    nout *= a.o[ax];
  }

  for (int64_t blk = blockIdx.x; blk < a.pre * a.ptiles; blk += gridDim.x) {
    const int64_t p = blk / a.ptiles;
    const int64_t q0 = (blk % a.ptiles) * a.P;
    const int pv = static_cast<int>(min(static_cast<int64_t>(a.P), a.post - q0));

    // Stage x[p, :, :, :, q0:q0+pv] (column index fastest: contiguous runs).
    // LOAD_BATCH independent loads are in flight per thread before any is
    // stored: with one block of 16 warps per SM, one load at a time would
    // leave the memory system idle.
    const XT* xp = x + p * nin * a.post + q0;
    const int nload = static_cast<int>(nin) * pv;
    for (int e0 = tid; e0 < nload; e0 += LOAD_BATCH * TILE_THREADS) {
      float v[LOAD_BATCH];
      int dst[LOAD_BATCH];
#pragma unroll
      for (int u = 0; u < LOAD_BATCH; ++u) {
        const int e = e0 + u * TILE_THREADS;
        dst[u] = -1;
        if (e < nload) {
          int64_t goff;
          dst[u] = tile_offsets<true>(a, e, pv, goff);
          v[u] = to_f32(xp[goff]);
        }
      }
#pragma unroll
      for (int u = 0; u < LOAD_BATCH; ++u)
        if (dst[u] >= 0) tile[dst[u]] = v[u];
    }
    __syncthreads();

    // Contract the group's axes from the last to the first, in place.
    int cur[3] = {a.n[0], a.n[1], a.n[2]};
    for (int t = a.g - 1; t >= 0; --t) {
      int fib = pv;
      for (int ax = 0; ax < a.g; ++ax)
        if (ax != t) fib *= cur[ax];
      const int n = a.n[t], np = a.npad[t], no = a.o[t], st = a.stride[t];
      const float* Ks = smem + a.koff[t];
      for (int f0 = tid; f0 < fib; f0 += 2 * TILE_THREADS) {
        const int f1 = f0 + TILE_THREADS;
        const bool has1 = f1 < fib;
        const int b0 = fibre_base(a, cur, t, f0, pv);
        const int b1 = has1 ? fibre_base(a, cur, t, f1, pv) : b0;
        float r0[MAXN], r1[MAXN];
#pragma unroll
        for (int k = 0; k < MAXN; ++k) {
          r0[k] = k < n ? grade<FAST>(tile[b0 + k * st]) : 0.f;
          r1[k] = (k < n && has1) ? grade<FAST>(tile[b1 + k * st]) : 0.f;
        }
        for (int oi = 0; oi < no; ++oi) {
          const float4* Kr = reinterpret_cast<const float4*>(Ks + oi * np);
          float acc0 = 0.f, acc1 = 0.f;
#pragma unroll
          for (int k4 = 0; k4 < MAXN / 4; ++k4) {
            if (4 * k4 < np) {
              const float4 kv = Kr[k4];
              acc0 = __fmaf_rn(kv.x, r0[4 * k4 + 0], acc0);
              acc0 = __fmaf_rn(kv.y, r0[4 * k4 + 1], acc0);
              acc0 = __fmaf_rn(kv.z, r0[4 * k4 + 2], acc0);
              acc0 = __fmaf_rn(kv.w, r0[4 * k4 + 3], acc0);
              acc1 = __fmaf_rn(kv.x, r1[4 * k4 + 0], acc1);
              acc1 = __fmaf_rn(kv.y, r1[4 * k4 + 1], acc1);
              acc1 = __fmaf_rn(kv.z, r1[4 * k4 + 2], acc1);
              acc1 = __fmaf_rn(kv.w, r1[4 * k4 + 3], acc1);
            }
          }
          tile[b0 + oi * st] = acc0;
          if (has1) tile[b1 + oi * st] = acc1;
        }
      }
      cur[t] = no;
      __syncthreads();
    }

    // Write out[p, :, :, :, q0:q0+pv].
    OT* op = out + p * nout * a.post + q0;
    const int nstore = static_cast<int>(nout) * pv;
    for (int e = tid; e < nstore; e += TILE_THREADS) {
      int64_t goff;
      const int sidx = tile_offsets<false>(a, e, pv, goff);
      op[goff] = from_f32<OT>(tile[sidx]);
    }
    __syncthreads();
  }
}

// Batched C[b] (M x N) = A[b] (M x K) · B[b] (K x N), every operand addressed
// through its own strides; the unit-stride index of each operand is read
// fastest so global loads coalesce.
struct WideArgs {
  int M, N, K;
  int64_t batch;
  int64_t sAb, sAi, sAk;
  int64_t sBb, sBk, sBj;
  int64_t sCb, sCi, sCj;
};

template <bool FAST, typename AT, typename BT, typename OT>
__global__ void __launch_bounds__(WIDE_THREADS)
kron_wide_kernel(const AT* __restrict__ A, const BT* __restrict__ B, OT* __restrict__ C, WideArgs w) {
  __shared__ __align__(16) float As[WK][WPAD];
  __shared__ __align__(16) float Bs[WK][WPAD];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int64_t mt = (w.M + WB - 1) / WB, nt = (w.N + WB - 1) / WB;

  for (int64_t tile = blockIdx.x; tile < w.batch * mt * nt; tile += gridDim.x) {
    const int64_t b = tile / (mt * nt);
    const int i0 = static_cast<int>((tile / nt) % mt) * WB;
    const int j0 = static_cast<int>(tile % nt) * WB;
    const AT* Ab = A + b * w.sAb;
    const BT* Bb = B + b * w.sBb;

    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

    // The next chunk's operands are loaded into registers before the current
    // chunk's FMAs, so their latency hides behind the arithmetic.
    float ra[WLOADS], rb[WLOADS];
    auto fetch = [&](int k0) {
#pragma unroll
      for (int u = 0; u < WLOADS; ++u) {
        const int e = tid + u * WIDE_THREADS;
        int r, c;
        if (w.sAk == 1) { r = e / WK; c = e % WK; } else { c = e / WB; r = e % WB; }
        const int gi = i0 + r, gk = k0 + c;
        ra[u] = (gi < w.M && gk < w.K) ? grade<FAST>(to_f32(Ab[gi * w.sAi + gk * w.sAk])) : 0.f;
        if (w.sBj == 1) { c = e % WB; r = e / WB; } else { r = e % WK; c = e / WK; }
        const int gk2 = k0 + r, gj = j0 + c;
        rb[u] = (gk2 < w.K && gj < w.N) ? grade<FAST>(to_f32(Bb[gk2 * w.sBk + gj * w.sBj])) : 0.f;
      }
    };
    fetch(0);
    for (int k0 = 0; k0 < w.K; k0 += WK) {
#pragma unroll
      for (int u = 0; u < WLOADS; ++u) {
        const int e = tid + u * WIDE_THREADS;
        if (w.sAk == 1) As[e % WK][e / WK] = ra[u]; else As[e / WB][e % WB] = ra[u];
        if (w.sBj == 1) Bs[e / WB][e % WB] = rb[u]; else Bs[e % WK][e / WK] = rb[u];
      }
      __syncthreads();
      if (k0 + WK < w.K) fetch(k0 + WK);
#pragma unroll
      for (int kk = 0; kk < WK; ++kk) {
        const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
        const float4 a1 = *reinterpret_cast<const float4*>(&As[kk][ty * 4 + 64]);
        const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
        const float4 b1 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4 + 64]);
        const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = __fmaf_rn(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }

    OT* Cb = C + b * w.sCb;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int gi = i0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
      if (gi >= w.M) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int gj = j0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
        if (gj < w.N) Cb[gi * w.sCi + gj * w.sCj] = from_f32<OT>(acc[i][j]);
      }
    }
  }
}

int grid_size(int64_t work) {
  constexpr int64_t CAP = 1 << 20;  // blocks beyond this loop inside the kernel
  return static_cast<int>(work < CAP ? work : CAP);
}

template <bool FAST, int MAXN, typename XT, typename OT>
int launch_tile(const void* x, void* out, const TileArgs& a, int smem, cudaStream_t stream) {
  auto kern = kron_tile_kernel<FAST, MAXN, XT, OT>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<grid_size(a.pre * a.ptiles), TILE_THREADS, smem, stream>>>(
      static_cast<const XT*>(x), static_cast<OT*>(out), a);
  return static_cast<int>(cudaGetLastError());
}

template <bool FAST, typename XT, typename OT>
int tile_by_width(const void* x, void* out, const TileArgs& a, int smem, int maxn, cudaStream_t s) {
  return maxn <= 32 ? launch_tile<FAST, 32, XT, OT>(x, out, a, smem, s)
                    : launch_tile<FAST, 64, XT, OT>(x, out, a, smem, s);
}

template <bool FAST, typename AT, typename BT, typename OT>
int launch_wide(const void* A, const void* B, void* C, const WideArgs& w, cudaStream_t stream) {
  const int64_t tiles = w.batch * ((w.M + WB - 1) / WB) * ((w.N + WB - 1) / WB);
  kron_wide_kernel<FAST, AT, BT, OT><<<grid_size(tiles), WIDE_THREADS, 0, stream>>>(
      static_cast<const AT*>(A), static_cast<const BT*>(B), static_cast<OT*>(C), w);
  return static_cast<int>(cudaGetLastError());
}

// x is the A operand when the contracted axis is last (C = X·Kᵀ), else the
// B operand (C_p = K·X_p).
template <bool FAST, typename XT, typename OT>
int wide_by_role(const void* x, const void* K, void* out, const WideArgs& w, bool x_is_a, cudaStream_t s) {
  return x_is_a ? launch_wide<FAST, XT, float, OT>(x, K, out, w, s)
                : launch_wide<FAST, float, XT, OT>(K, x, out, w, s);
}

constexpr int ERR_SHAPE = -1;  // arguments the kernels do not take

}  // namespace

// Plain C entry points, loaded with ctypes.  Pointers and the stream are
// void*; the return value is the launch's cudaError_t, or ERR_SHAPE.
//
// Tile pass: contract g (1-3) adjacent axes of x (pre, n_0..n_{g-1}, post)
// with factors K_a (o_a, n_a), f32, row-major; every n_a <= 64.  P columns
// of post per block (P = 1 when post = 1).
extern "C" int gp_grief_kron_tile_pass(const void* x, void* out, const void* K0, const void* K1,
                                       const void* K2, int g, int n0, int n1, int n2, int o0, int o1,
                                       int o2, long long pre, long long post, int P, int fast,
                                       int x_bf16, int out_bf16, void* stream) {
  TileArgs a{};
  const void* Ks[3] = {K0, K1, K2};
  const int ns[3] = {n0, n1, n2}, os[3] = {o0, o1, o2};
  if (g < 1 || g > 3 || pre < 1 || post < 1 || P < 1 || P > post) return ERR_SHAPE;
  a.g = g;
  a.pre = pre;
  a.post = post;
  a.P = P;
  a.ptiles = (post + P - 1) / P;
  int maxn = 0;
  for (int ax = 0; ax < g; ++ax) {
    if (ns[ax] < 1 || ns[ax] > 64 || os[ax] < 1) return ERR_SHAPE;
    a.K[ax] = static_cast<const float*>(Ks[ax]);
    a.n[ax] = ns[ax];
    a.o[ax] = os[ax];
    a.npad[ax] = (ns[ax] + 3) / 4 * 4;
    maxn = ns[ax] > maxn ? ns[ax] : maxn;
  }
  for (int ax = g; ax < 3; ++ax) a.n[ax] = a.o[ax] = a.npad[ax] = 1;
  // Shared-memory extents max(n, o) per axis (+ the column axis), the
  // innermost one padded to an odd count so that fibres along it fall in
  // distinct banks.
  int ext[4];
  const int naxes = g + (P > 1 ? 1 : 0);
  for (int ax = 0; ax < g; ++ax) ext[ax] = ns[ax] > os[ax] ? ns[ax] : os[ax];
  if (P > 1) ext[g] = P;
  ext[naxes - 1] |= 1;
  int64_t s = 1;
  for (int ax = naxes - 1; ax >= 0; --ax) {
    a.stride[ax] = static_cast<int>(s);
    s *= ext[ax];
  }
  if (P == 1) a.stride[g] = 1;
  a.row_stride = naxes > 1 ? a.stride[naxes - 2] : static_cast<int>(s);
  a.in_rows = a.out_rows = true;
  for (int ax = 0; ax < naxes - 1 && ax < g; ++ax) {
    a.in_rows = a.in_rows && ext[ax] == ns[ax];
    a.out_rows = a.out_rows && ext[ax] == os[ax];
  }
  int64_t floats = (s + 3) / 4 * 4;  // factor rows are read as float4
  for (int ax = 0; ax < g; ++ax) {
    a.koff[ax] = static_cast<int>(floats);
    floats += static_cast<int64_t>(a.o[ax]) * a.npad[ax];
  }
  const int64_t smem = floats * 4;
  if (smem > SMEM_LIMIT) return ERR_SHAPE;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int sm = static_cast<int>(smem);
  if (!fast) {
    if (x_bf16 || out_bf16) return ERR_SHAPE;
    return tile_by_width<false, float, float>(x, out, a, sm, maxn, st);
  }
  if (x_bf16) {
    return out_bf16 ? tile_by_width<true, __nv_bfloat16, __nv_bfloat16>(x, out, a, sm, maxn, st)
                    : tile_by_width<true, __nv_bfloat16, float>(x, out, a, sm, maxn, st);
  }
  return out_bf16 ? tile_by_width<true, float, __nv_bfloat16>(x, out, a, sm, maxn, st)
                  : tile_by_width<true, float, float>(x, out, a, sm, maxn, st);
}

// Wide pass: contract one axis of x (pre, n, post) with K (o, n), f32.
extern "C" int gp_grief_kron_wide_pass(const void* x, void* out, const void* K, int n, int o,
                                       long long pre, long long post, int fast, int x_bf16,
                                       int out_bf16, void* stream) {
  if (n < 1 || o < 1 || pre < 1 || post < 1) return ERR_SHAPE;
  WideArgs w{};
  const bool x_is_a = post == 1;
  if (x_is_a) {  // C (pre x o) = X (pre x n) · Kᵀ
    if (pre > INT32_MAX) return ERR_SHAPE;
    w.M = static_cast<int>(pre); w.N = o; w.K = n; w.batch = 1;
    w.sAb = 0; w.sAi = n; w.sAk = 1;
    w.sBb = 0; w.sBk = 1; w.sBj = n;
    w.sCb = 0; w.sCi = o; w.sCj = 1;
  } else {  // C_p (o x post) = K (o x n) · X_p (n x post)
    if (post > INT32_MAX) return ERR_SHAPE;
    w.M = o; w.N = static_cast<int>(post); w.K = n; w.batch = pre;
    w.sAb = 0; w.sAi = n; w.sAk = 1;
    w.sBb = static_cast<int64_t>(n) * post; w.sBk = post; w.sBj = 1;
    w.sCb = static_cast<int64_t>(o) * post; w.sCi = post; w.sCj = 1;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!fast) {
    if (x_bf16 || out_bf16) return ERR_SHAPE;
    return wide_by_role<false, float, float>(x, K, out, w, x_is_a, st);
  }
  if (x_bf16) {
    return out_bf16 ? wide_by_role<true, __nv_bfloat16, __nv_bfloat16>(x, K, out, w, x_is_a, st)
                    : wide_by_role<true, __nv_bfloat16, float>(x, K, out, w, x_is_a, st);
  }
  return out_bf16 ? wide_by_role<true, float, __nv_bfloat16>(x, K, out, w, x_is_a, st)
                  : wide_by_role<true, float, float>(x, K, out, w, x_is_a, st);
}
