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
//   K3 (kron_matvec_fused): _tail_group_pass :695, _mid_group_pass :785;
//   K6 last_slab_pass :46; K7 _mid_axis_pass :108, _last_axis_pass :132;
//   K8 _tail3_pass :525, _tail2_pass :590.
// Their pass structure (lane width 128, K ⊗ I_G widening, an explicit
// 1024-wide K_{d-1} ⊗ K_d pair matrix, VMEM budgets, hi/lo bf16 splits)
// follows TPU rules and is not carried over.  Four members here.
//
// kron_exact_tile_kernel, the exact grade's tile member: groups of up to three
//   axes of at most 64 points (and at most 256 outputs).  A tile is P
//   trailing columns (or none: post = 1) and R rows of `pre`; its input is
//   `units`, each one device-memory row of the innermost axis (post = 1) or
//   that axis' n x P block, consecutive in memory.  Persistent blocks of 256
//   threads walk their tiles' units in chunks through a two-stage ring filled
//   by 16-byte cp.async (4-byte where rows are not 16-byte aligned,
//   zero-filled at ragged edges); the copies run one chunk ahead across
//   tiles, so the next tile's first chunk lands while this tile's middle and
//   outer axes are summed.  The innermost axis is contracted as its chunk is
//   read out of the ring, into T (the tile after that contraction, R x E_0
//   [x E_1] x inner, E = max(n, o)); a middle axis (g = 3) in place in T; the
//   outermost straight to device memory (g = 1: the innermost one is also
//   the outermost).  So a 32^3 tile (tail3_pass, K2's first pass at 32^5)
//   holds 128 KB of T, 12 KB of factors and two 36 KB stages, not a second
//   raw tile.  Every contraction is register-blocked: a task is four fibres
//   (four neighbouring columns, or four rows) x one 8-row slice of the
//   factor, kept transposed (K^T[k][o]) in shared memory, so each k reads one
//   float4 of x and two of K^T for 32 FMAs; the S slices of a fibre group are
//   neighbouring lanes of one warp (S a power of two), which all read the
//   group (__syncwarp) before any writes it back in place.  Task indices
//   decode once per task; the copies' by shifts and masks.  Landed rows are
//   an odd number of float4s apart, so the four-row reads fall in distinct
//   banks; the column reads of a quarter-warp are consecutive float4s.  Each
//   output is one __fmaf_rn chain over k = 0..n-1 in order, from 0 -- the
//   chain of the member this one replaced, so the exact grade keeps its bits
//   (tests/test_torch_kron_cuda.py's X3_DIGEST).  What bounds it: at 32^3 a
//   3-axis pass does 96 FMA per element against 8 bytes moved, 0.10 ms of
//   FP32 issue at 32^5 beside 0.08 ms of bytes; 2-axis passes meet both
//   floors at about 0.08 ms.  Measured on an H100 it runs at 2-3.4x the byte
//   bound with its FMA loop issuing on about half the cycles; neither loads,
//   stores, shared-memory reads nor occupancy move it (PERF.md), and half
//   the FFMAs in the SASS read two registers of one bank parity.
//   No atomics and no split sum: two launches give the same bits.
//
// kron_tile_kernel, the FP32 tile member of the fast grade, where the mma
//   member does not take the group (a lone innermost axis, more than 128
//   columns, a tile over shared memory).  A block stages the group's full
//   extent times P trailing columns, and R consecutive rows of `pre` when P
//   covers the whole trailing extent, in shared memory with the factors
//   beside it, and contracts the axes one after another in place, a thread
//   taking whole fibres into registers (two at a time); each output is one
//   FMA chain over k = 0..n-1 on bf16-rounded operands.
//
// kron_mma_tile_kernel, the fast grade's tile member (K2 at "default", and
//   the fast-grade tile passes of K3, K7 and K8).  The same groups as
//   kron_tile_kernel, staged in shared memory as bf16 -- the grade rounds
//   every contraction operand to bf16 anyway -- which halves the tile (32^5:
//   71 KB; two blocks an SM, at up to 128 registers a thread: a variant held
//   to 80 registers for three blocks spilled and ran ~10% slower).  Every
//   axis is zero-padded to a power of two of at least 16 (the m16/k16
//   fragment; indices by shifts and masks, no divisions), the columns
//   likewise, and 16-byte chunks are XOR-swizzled so that ldmatrix along any
//   axis is free of bank conflicts.  Each axis
//   contraction is a batched GEMM on bf16 mma.sync m16n8k16 with f32
//   accumulation: Y_a = K·X_a (X_a read by ldmatrix.trans) for a middle
//   axis, Y = X·Kᵀ for the innermost one; a warp reads all of its operand
//   columns before it writes them back, rounded to bf16 (the next
//   contraction's operand rounding), so the tile is contracted in place.
//   The pass's last contraction writes its f32 accumulators straight to
//   device memory (bf16 where the pass stores bf16): the result is not
//   rounded to bf16 in between.  Loads batch two 16-byte chunks a thread;
//   the overlap of loads with products comes from the other resident blocks
//   (cp.async cannot convert f32 to bf16, and an f32 landing buffer would
//   cost the occupancy it buys).  What bounds it: bytes (32^5: 33.5M
//   elements read and written per pass).
//
// kron_wide_kernel, for one axis wider than 64 points (K3's 512-wide axes,
//   K6, K7's wide axes): a batched GEMM on the tensor cores, C = X·Kᵀ when
//   the axis is last, C_p = K·X_p otherwise.  128 x {64, 128} output tiles
//   (64 when the output width is at most 64, so K6's 64 outputs compute no
//   zeros), 32-deep chunks in a ring of 3-6 shared-memory stages filled by
//   cp.async (16-byte copies where rows are 16-byte aligned, 4-byte copies
//   otherwise, zero-filled past the ragged M, N and K edges); each block
//   walks its tiles and their chunks as one sequence, so the next tile's
//   first chunks arrive while the current tile finishes.  At the exact grade,
//   C = X·Kᵀ keeps all of K in shared memory when it fits beside the ring
//   (K6's shapes): every block reads the same factor, and staging it per
//   tile cost as much L2 bandwidth as X's own stream.  Warp-level
//   mma.sync: the exact grade runs 3xTF32 (each operand split into
//   big = tf32(a) and small = tf32(a - big), big·big + big·small +
//   small·big accumulated in f32, float32 accuracy; passes deeper than 512
//   flush each chunk's partial sums into f32 sums), the fast grade bf16
//   m16n8k16 with f32 accumulation.  What bounds it: at 8x512x512 the
//   operations (2·M·512 per axis, 3x as TF32 products), at K6's shapes the
//   bytes.  wgmma is later work: its tf32 form needs both operands K-major
//   in shared memory, and X_p in the C_p = K·X_p role is N-major.
//
// Grades (template parameter FAST):
//   exact: float32 accuracy on the operands as given (the JAX reference's
//          HIGHEST): FP32 FMA chains in the exact tile member, 3xTF32 in
//          the wide one.  Two launches, and the tile passes before and after
//          the mma member was added and the exact member redesigned, give
//          the same bits.
//   fast:  every operand (factor entries and the vector entering each
//          contraction) rounded to bf16, products accumulated in f32.  The
//          result of a pass may be stored as bf16 (out_bf16), which rounds it
//          exactly as the next contraction's operand rounding would.  The
//          vector may arrive as bf16 (the mixed16 CG state).
// No atomics and no split of a sum across blocks: two launches give the same
// bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "device_helpers.cuh"
#include "device_scope.cuh"
#include "resident_grid.cuh"

namespace {

constexpr int SMEM_PER_SM = 233472;  // 228 KB an SM shares among its blocks
constexpr int SMEM_RESERVED = 1024;  // taken by the runtime for each resident block
// A block of at most this many bytes of shared memory leaves room for a second
// resident block on its SM.
constexpr int TWO_BLOCK_SMEM = SMEM_PER_SM / 2 - SMEM_RESERVED;
constexpr int TILE_MAX_THREADS = 512;  // R = 1 tiles over TWO_BLOCK_SMEM
constexpr int TILE_THREADS = 256;      // tiles that share their SM
constexpr int LOAD_BATCH = 16;  // tile kernel: global loads in flight per thread

constexpr int WIDE_THREADS = 256;  // 8 warps: 4 along M x 2 along N
constexpr int WBM = 128;           // wide kernel: output rows of a tile
constexpr int WBK = 32;            // depth of one staged chunk
constexpr int WMIN_STAGES = 3, WMAX_STAGES = 6;  // chunks in the shared-memory ring
// Exact-grade wide passes deeper than this flush their tensor-core
// accumulators into f32 sums every chunk (kron_wide_kernel's FLUSH), on
// 64-wide tiles whatever width the caller asks for (wide_by_role).
constexpr int FLUSH_DEPTH = 512;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
// The fast grade's operand rounding.
__device__ __forceinline__ float bf16_round(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }

// ---------------------------------------------------------------------------
// The tile member.
// ---------------------------------------------------------------------------

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
  int R;        // rows of pre per block (> 1 only when P == post)
  int stride[4];  // shared-memory strides of axes 0..g-1 and of the column axis
  int row_tile;   // shared-memory floats of one row of pre
  int koff[3];    // float offset of each factor in shared memory
  // When every axis but the innermost shared-memory one has its input
  // (output) extent in shared memory, a staged tile is rows of row_stride
  // floats, and an element's offsets follow from one running (row, column)
  // pair instead of one division per axis.
  bool in_rows, out_rows;
  int row_stride;
};

// Shared-memory offset, and global offset relative to the tile's first
// element, of element e of a tile staged in (row of pre, group axes...,
// column) order; IN selects the input extents n (loads) or the output
// extents o (stores), one division per axis.
template <bool IN>
__device__ __forceinline__ int tile_offsets(const TileArgs& a, int e, int pv, int64_t& goff) {
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
  return s + q + rest * a.row_tile;
}

// A running (row, column) position of element e, e advancing by `step`.
struct RowWalk {
  int r, c, dr, dc, len;
  __device__ RowWalk(int e, int step, int len_) : r(e / len_), c(e % len_), dr(step / len_), dc(step % len_), len(len_) {}
  __device__ __forceinline__ void next() {
    c += dc;
    r += dr;
    if (c >= len) {
      c -= len;
      ++r;
    }
  }
};

// Shared-memory offset, and global offset relative to the tile's first
// element, of element e: from the running (row, column) position w where
// the staged tile is rows, else by tile_offsets.
template <bool IN>
__device__ __forceinline__ int element_offsets(const TileArgs& a, const RowWalk& w, int e, int pv, int64_t& goff) {
  if (IN ? a.in_rows : a.out_rows) {
    goff = a.P > 1 ? static_cast<int64_t>(w.r) * a.post + w.c : static_cast<int64_t>(e) * a.post;
    return w.r * a.row_stride + w.c;
  }
  return tile_offsets<IN>(a, e, pv, goff);
}

// One fibre of axis t: all other indices fixed.  Fibres are enumerated with
// the column index fastest, then the remaining axes from the last, then the
// row of pre, so neighbouring threads touch neighbouring shared-memory words.
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
  return base + f * a.row_tile;
}

template <int MAXN, typename XT, typename OT>
__global__ void __launch_bounds__(TILE_MAX_THREADS)
kron_tile_kernel(const XT* __restrict__ x, OT* __restrict__ out, TileArgs a) {
  extern __shared__ __align__(16) float smem[];
  float* tile = smem;
  const int tid = threadIdx.x, nth = blockDim.x;

  for (int ax = 0; ax < a.g; ++ax) {
    const float* K = a.K[ax];
    float* Ks = smem + a.koff[ax];
    const int n = a.n[ax], np = a.npad[ax], cnt = a.o[ax] * np;
    for (int e = tid; e < cnt; e += nth) {
      const int r = e / np, c = e % np;
      Ks[e] = c < n ? bf16_round(K[static_cast<int64_t>(r) * n + c]) : 0.f;
    }
  }

  int nin = 1, nout = 1;
  for (int ax = 0; ax < a.g; ++ax) {
    nin *= a.n[ax];
    nout *= a.o[ax];
  }
  const int64_t batches = (a.pre + a.R - 1) / a.R;

  for (int64_t blk = blockIdx.x; blk < batches * a.ptiles; blk += gridDim.x) {
    const int64_t p0 = (blk / a.ptiles) * a.R;
    const int64_t q0 = (blk % a.ptiles) * a.P;
    const int pv = static_cast<int>(min(static_cast<int64_t>(a.P), a.post - q0));
    const int rv = static_cast<int>(min(static_cast<int64_t>(a.R), a.pre - p0));

    // Stage x[p0:p0+rv, :, :, :, q0:q0+pv] (column index fastest: contiguous
    // runs).  LOAD_BATCH independent loads are in flight per thread before
    // any is stored.
    const XT* xp = x + p0 * nin * a.post + q0;
    const int nload = rv * nin * pv;
    RowWalk win(tid, nth, a.P > 1 ? pv : a.n[a.g - 1]);
    for (int e0 = tid; e0 < nload; e0 += LOAD_BATCH * nth) {
      float v[LOAD_BATCH];
      int dst[LOAD_BATCH];
#pragma unroll
      for (int u = 0; u < LOAD_BATCH; ++u) {
        const int e = e0 + u * nth;
        dst[u] = -1;
        if (e < nload) {
          int64_t goff;
          dst[u] = element_offsets<true>(a, win, e, pv, goff);
          v[u] = to_f32(xp[goff]);
        }
        win.next();
      }
#pragma unroll
      for (int u = 0; u < LOAD_BATCH; ++u)
        if (dst[u] >= 0) tile[dst[u]] = v[u];
    }
    __syncthreads();

    // Contract the group's axes from the last to the first, in place.
    int cur[3] = {a.n[0], a.n[1], a.n[2]};
    for (int t = a.g - 1; t >= 0; --t) {
      int fib = rv * pv;
      for (int ax = 0; ax < a.g; ++ax)
        if (ax != t) fib *= cur[ax];
      const int n = a.n[t], np = a.npad[t], no = a.o[t], st = a.stride[t];
      const float* Ks = smem + a.koff[t];
      for (int f0 = tid; f0 < fib; f0 += 2 * nth) {
        const int f1 = f0 + nth;
        const bool has1 = f1 < fib;
        const int b0 = fibre_base(a, cur, t, f0, pv);
        const int b1 = has1 ? fibre_base(a, cur, t, f1, pv) : b0;
        float r0[MAXN], r1[MAXN];
#pragma unroll
        for (int k = 0; k < MAXN; ++k) {
          r0[k] = k < n ? bf16_round(tile[b0 + k * st]) : 0.f;
          r1[k] = (k < n && has1) ? bf16_round(tile[b1 + k * st]) : 0.f;
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

    // Write out[p0:p0+rv, :, :, :, q0:q0+pv].
    OT* op = out + p0 * nout * a.post + q0;
    const int nstore = rv * nout * pv;
    RowWalk wout(tid, nth, a.P > 1 ? pv : a.o[a.g - 1]);
    for (int e = tid; e < nstore; e += nth) {
      int64_t goff;
      const int sidx = element_offsets<false>(a, wout, e, pv, goff);
      op[goff] = from_f32<OT>(tile[sidx]);
      wout.next();
    }
    __syncthreads();
  }
}

template <int MAXN, typename XT, typename OT>
int launch_tile(const void* x, void* out, const TileArgs& a, int smem, cudaStream_t stream) {
  static LaunchCache cache;
  auto kern = kron_tile_kernel<MAXN, XT, OT>;
  const int threads = smem <= TWO_BLOCK_SMEM ? TILE_THREADS : TILE_MAX_THREADS;
  int grid = 0;
  const cudaError_t err = resident_grid(kern, cache, threads, smem, (a.pre + a.R - 1) / a.R * a.ptiles, grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<grid, threads, smem, stream>>>(static_cast<const XT*>(x), static_cast<OT*>(out), a);
  return static_cast<int>(cudaGetLastError());
}

template <typename XT, typename OT>
int tile_by_width(const void* x, void* out, const TileArgs& a, int smem, int maxn, cudaStream_t s) {
  return maxn <= 32 ? launch_tile<32, XT, OT>(x, out, a, smem, s) : launch_tile<64, XT, OT>(x, out, a, smem, s);
}

// ---------------------------------------------------------------------------
// The exact grade's tile member: the innermost axis contracted as its rows
// land, the middle one in place, the outermost one on its way out.
// ---------------------------------------------------------------------------

constexpr int EX_THREADS = 256;
constexpr int EX_FIB = 4;  // fibres a lane sums: four columns, or four rows, read as float4s
constexpr int EX_OUT = 8;  // outputs a lane sums: one 8-row slice of a factor

struct ExactArgs {
  const float* K[3];
  int g, n[3], o[3];
  int E0, E1;      // slots of axes 0 and 1 in T: max(n, o), room to contract in place
  int lgS[3];      // log2 of each factor's 8-row output slices
  int kld[3];      // row length of each transposed factor K^T (n x 8S) in shared memory
  int koff[3];     // float offsets of the K^T
  int64_t pre, post, ptiles, ntiles;
  int P, R;        // columns and rows of pre a tile takes
  bool rows;       // post == 1: the innermost axis is contiguous (a unit is one row of it)
  int nlast;       // n[g-1]
  int rpu;         // device-memory rows of a unit: 1 (rows) or n[g-1] (a unit is n[g-1] x P)
  int ls;          // floats between landed rows
  int nurow;       // units in one row of pre: prod n[0..g-2]
  int cu;          // units a chunk
  int chunks;      // chunks a tile
  int lgp;         // log2 of the copies one device-memory row takes, padded to a power of two
  bool copy16;     // 16-byte copies (else 4-byte)
  bool tight;      // columns, P not a multiple of 4: T packs a unit's o[g-1] x P outputs
  int inner;       // T floats of a unit's slot: o[g-1] x ls (columns), o[g-1] x P rounded to 4
                   // (tight), o[g-1] rounded to 4 (rows)
  int tstride0;    // T floats between slots of axis 0: E1 x inner (g = 3) or inner (g = 2)
  int t_off, ring_off, stage;  // float offsets of T and of the ring; floats of one stage
  bool same_units; // every E equals its n: a unit's slot in T is its index
};

// acc[f][j] = sum_k K^T[k][j] x_f[k]: one FMA chain per output, k = 0..n-1
// in order (the exact grade's chain).  Columns: fibre f at x + f, its
// element k at x + k * ks, so one float4 gives the four fibres' element k.
__device__ __forceinline__ void chains_cols(float (&acc)[EX_FIB][EX_OUT], const float* x, int ks, const float* kt,
                                            int kld, int n) {
#pragma unroll 4
  for (int k = 0; k < n; ++k) {
    const float4 xv = *reinterpret_cast<const float4*>(x + k * ks);
    const float4 k0 = *reinterpret_cast<const float4*>(kt + k * kld);
    const float4 k1 = *reinterpret_cast<const float4*>(kt + k * kld + 4);
    const float xs[EX_FIB] = {xv.x, xv.y, xv.z, xv.w};
    const float kv[EX_OUT] = {k0.x, k0.y, k0.z, k0.w, k1.x, k1.y, k1.z, k1.w};
#pragma unroll
    for (int f = 0; f < EX_FIB; ++f)
#pragma unroll
      for (int j = 0; j < EX_OUT; ++j) acc[f][j] = __fmaf_rn(kv[j], xs[f], acc[f][j]);
  }
}

// The same chains over rows: fibre f at x + f * fs, contiguous along k, so
// one float4 gives four of its elements.
__device__ __forceinline__ void chains_rows(float (&acc)[EX_FIB][EX_OUT], const float* x, int fs, const float* kt,
                                            int kld, int n) {
  int k = 0;
  for (; k + 4 <= n; k += 4) {
    float xr[EX_FIB][4];
#pragma unroll
    for (int f = 0; f < EX_FIB; ++f) {
      const float4 v = *reinterpret_cast<const float4*>(x + f * fs + k);
      xr[f][0] = v.x, xr[f][1] = v.y, xr[f][2] = v.z, xr[f][3] = v.w;
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float4 k0 = *reinterpret_cast<const float4*>(kt + (k + kk) * kld);
      const float4 k1 = *reinterpret_cast<const float4*>(kt + (k + kk) * kld + 4);
      const float kv[EX_OUT] = {k0.x, k0.y, k0.z, k0.w, k1.x, k1.y, k1.z, k1.w};
#pragma unroll
      for (int f = 0; f < EX_FIB; ++f)
#pragma unroll
        for (int j = 0; j < EX_OUT; ++j) acc[f][j] = __fmaf_rn(kv[j], xr[f][kk], acc[f][j]);
    }
  }
  for (; k < n; ++k) {
    const float4 k0 = *reinterpret_cast<const float4*>(kt + k * kld);
    const float4 k1 = *reinterpret_cast<const float4*>(kt + k * kld + 4);
    const float kv[EX_OUT] = {k0.x, k0.y, k0.z, k0.w, k1.x, k1.y, k1.z, k1.w};
#pragma unroll
    for (int f = 0; f < EX_FIB; ++f) {
      const float xv = x[f * fs + k];
#pragma unroll
      for (int j = 0; j < EX_OUT; ++j) acc[f][j] = __fmaf_rn(kv[j], xv, acc[f][j]);
    }
  }
}

__device__ __forceinline__ void zero(float (&acc)[EX_FIB][EX_OUT]) {
#pragma unroll
  for (int f = 0; f < EX_FIB; ++f)
#pragma unroll
    for (int j = 0; j < EX_OUT; ++j) acc[f][j] = 0.f;
}

// nv (<= 4) consecutive floats v0..v3 at p: one 16-byte store where it can.
__device__ __forceinline__ void store_run(float* p, float v0, float v1, float v2, float v3, int nv) {
  if (nv == 4 && reinterpret_cast<uintptr_t>(p) % 16 == 0) {
    *reinterpret_cast<float4*>(p) = make_float4(v0, v1, v2, v3);
  } else {
    p[0] = v0;
    if (nv > 1) p[1] = v1;
    if (nv > 2) p[2] = v2;
    if (nv > 3) p[3] = v3;
  }
}

// The slot in T of a tile's unit u, units enumerated (row of pre, i_0[, i_1])
// over the input extents, slots over the in-place extents E.
__device__ __forceinline__ int unit_slot(const ExactArgs& a, int u) {
  if (a.same_units) return u;
  if (a.g == 2) {
    const int r = u / a.n[0];
    return r * a.E0 + (u - r * a.n[0]);
  }
  const int q = u / a.n[1], i1 = u - q * a.n[1];
  const int r = q / a.n[0], i0 = q - r * a.n[0];
  return (r * a.E0 + i0) * a.E1 + i1;
}

// Contract the innermost axis of the landed units [u0, u0 + nu) of tile
// (p0, q0): into their slots of T, or (g == 1) straight to `out`.
__device__ __forceinline__ void exact_first(const ExactArgs& a, const float* st, float* T, const float* smem,
                                            float* out, int u0, int nu, int64_t p0, int64_t q0, int pv) {
  const int t = a.g - 1, lgS = a.lgS[t], S = 1 << lgS, no = a.o[t];
  const float* kt = smem + a.koff[t];
  float acc[EX_FIB][EX_OUT];
  if (a.rows) {
    // A lane sums four rows, NG apart, so the rows a quarter-warp reads at
    // once are neighbours (ls is an odd number of float4s: distinct banks).
    const int NG = (a.cu + 3) / 4;
    for (int it = threadIdx.x; it < (NG << lgS); it += EX_THREADS) {
      const int gi = it >> lgS, s = it & (S - 1);
      zero(acc);
      chains_rows(acc, st + gi * a.ls, NG * a.ls, kt + EX_OUT * s, a.kld[t], a.nlast);
#pragma unroll
      for (int f = 0; f < EX_FIB; ++f) {
        const int uc = gi + f * NG;
        if (uc >= nu) continue;
        float* dst;
        int nvalid;  // floats of the lane's slice that land (T's slot is rounded up to 4)
        if (a.g == 1) {
          dst = out + (p0 + u0 + uc) * no + EX_OUT * s;
          nvalid = no - EX_OUT * s;
        } else {
          dst = T + unit_slot(a, u0 + uc) * a.inner + EX_OUT * s;
          nvalid = a.inner - EX_OUT * s;
        }
        if (nvalid <= 0) continue;
        store_run(dst, acc[f][0], acc[f][1], acc[f][2], acc[f][3], nvalid < 4 ? nvalid : 4);
        if (nvalid > 4) store_run(dst + 4, acc[f][4], acc[f][5], acc[f][6], acc[f][7], nvalid < 8 ? nvalid - 4 : 4);
      }
    }
    return;
  }
  const int W = a.ls >> 2;  // four-column groups of a landed row
  for (int it = threadIdx.x; it < ((a.cu * W) << lgS); it += EX_THREADS) {
    const int grp = it >> lgS, s = it & (S - 1);
    const int uc = grp / W, cg = grp - uc * W;
    if (uc >= nu || 4 * cg >= pv) continue;
    zero(acc);
    chains_cols(acc, st + uc * a.rpu * a.ls + 4 * cg, a.ls, kt + EX_OUT * s, a.kld[t], a.nlast);
    if (a.g == 1) {
      float* dst = out + (p0 + u0 + uc) * no * a.post + q0 + 4 * cg;
      const int nv = pv - 4 * cg < 4 ? pv - 4 * cg : 4;
#pragma unroll
      for (int j = 0; j < EX_OUT; ++j)
        if (EX_OUT * s + j < no)
          store_run(dst + (EX_OUT * s + j) * a.post, acc[0][j], acc[1][j], acc[2][j], acc[3][j], nv);
    } else if (a.tight) {
      float* dst = T + unit_slot(a, u0 + uc) * a.inner + 4 * cg;
      const int nv = pv - 4 * cg < 4 ? pv - 4 * cg : 4;
#pragma unroll
      for (int j = 0; j < EX_OUT; ++j)
        if (EX_OUT * s + j < no)
#pragma unroll
          for (int f = 0; f < EX_FIB; ++f)
            if (f < nv) dst[(EX_OUT * s + j) * a.P + f] = acc[f][j];
    } else {
      float* dst = T + unit_slot(a, u0 + uc) * a.inner + 4 * cg;
#pragma unroll
      for (int j = 0; j < EX_OUT; ++j)
        if (EX_OUT * s + j < no)
          *reinterpret_cast<float4*>(dst + (EX_OUT * s + j) * a.ls) =
              make_float4(acc[0][j], acc[1][j], acc[2][j], acc[3][j]);
    }
  }
}

// g == 3: contract axis 1 of T in place.  The S lanes that share a fibre
// group are one warp's neighbours; they have all read it (__syncwarp)
// before any of them writes it.
__device__ __forceinline__ void exact_middle(const ExactArgs& a, float* T, const float* smem, int rv) {
  const int lgS = a.lgS[1], S = 1 << lgS, C = a.inner, W = C >> 2;
  const float* kt = smem + a.koff[1];
  const int items = (rv * a.E0 * W) << lgS, lane = threadIdx.x % 32;
  float acc[EX_FIB][EX_OUT];
  for (int it0 = threadIdx.x - lane; it0 < items; it0 += EX_THREADS) {  // warp-uniform trips
    const int it = it0 + lane;
    const int grp = it >> lgS, s = it & (S - 1);
    const int row = grp / W, cg = grp - row * W;  // row = (r, i_0)
    const bool on = it < items && row % a.E0 < a.n[0];
    float* x = T + row * a.E1 * C + 4 * cg;
    zero(acc);
    if (on) chains_cols(acc, x, C, kt + EX_OUT * s, a.kld[1], a.n[1]);
    __syncwarp();
    if (on) {
#pragma unroll
      for (int j = 0; j < EX_OUT; ++j)
        if (EX_OUT * s + j < a.o[1])
          *reinterpret_cast<float4*>(x + (EX_OUT * s + j) * C) = make_float4(acc[0][j], acc[1][j], acc[2][j], acc[3][j]);
    }
  }
}

// Where T's element c of a slot row of axis 0 goes in `out`, relative to
// out[p0 + r, o_0 = 0]; -1 for T's padding (tight layout).
__device__ __forceinline__ int64_t tight_offset(const ExactArgs& a, int c, int64_t q0, int pv) {
  const int olast = a.o[a.g - 1];
  int i1 = 0, rest = c;
  if (a.g == 3) {
    i1 = c / a.inner;
    rest = c - i1 * a.inner;
    if (i1 >= a.o[1]) return -1;
  }
  const int j = rest / a.P, col = rest - j * a.P;
  if (j >= olast || col >= pv) return -1;
  return static_cast<int64_t>(i1 * olast + j) * a.post + q0 + col;
}

// g >= 2: contract axis 0 of T into out[p0 + r, o_0, (o_1,) o_2 or columns].
__device__ __forceinline__ void exact_last(const ExactArgs& a, const float* T, const float* smem, float* out,
                                           int64_t p0, int64_t q0, int pv, int rv) {
  const int lgS = a.lgS[0], S = 1 << lgS, C = a.tstride0, W = C >> 2;
  const int olast = a.o[a.g - 1], nrest = (a.g == 3 ? a.o[1] : 1) * olast;
  const float* kt = smem + a.koff[0];
  float acc[EX_FIB][EX_OUT];
  for (int it = threadIdx.x; it < ((rv * W) << lgS); it += EX_THREADS) {
    const int grp = it >> lgS, s = it & (S - 1);
    const int r = grp / W, c = 4 * (grp - r * W);
    if (a.tight) {  // four fibres, each its own place in `out`
      int64_t off[EX_FIB];
      bool any = false;
#pragma unroll
      for (int f = 0; f < EX_FIB; ++f) {
        off[f] = tight_offset(a, c + f, q0, pv);
        any = any || off[f] >= 0;
      }
      if (!any) continue;
      zero(acc);
      chains_cols(acc, T + r * a.E0 * C + c, C, kt + EX_OUT * s, a.kld[0], a.n[0]);
      float* base = out + (p0 + r) * a.o[0] * nrest * a.post;
#pragma unroll
      for (int jo = 0; jo < EX_OUT; ++jo)
        if (EX_OUT * s + jo < a.o[0])
#pragma unroll
          for (int f = 0; f < EX_FIB; ++f)
            if (off[f] >= 0) base[static_cast<int64_t>(EX_OUT * s + jo) * nrest * a.post + off[f]] = acc[f][jo];
      continue;
    }
    int i1 = 0, rest = c;
    if (a.g == 3) {
      i1 = c / a.inner;
      rest = c - i1 * a.inner;
      if (i1 >= a.o[1]) continue;
    }
    int j = rest, col = 0, nv = olast - rest;
    if (!a.rows) {
      j = rest / a.ls;
      col = rest - j * a.ls;
      nv = pv - col;
    }
    if (nv <= 0) continue;
    nv = nv < 4 ? nv : 4;
    zero(acc);
    chains_cols(acc, T + r * a.E0 * C + c, C, kt + EX_OUT * s, a.kld[0], a.n[0]);
    float* dst = out + ((p0 + r) * a.o[0] * nrest + i1 * olast + j) * a.post + q0 + col;
#pragma unroll
    for (int jo = 0; jo < EX_OUT; ++jo)
      if (EX_OUT * s + jo < a.o[0])
        store_run(dst + static_cast<int64_t>(EX_OUT * s + jo) * nrest * a.post, acc[0][jo], acc[1][jo], acc[2][jo],
                  acc[3][jo], nv);
  }
}

__global__ void __launch_bounds__(EX_THREADS, 2)
kron_exact_tile_kernel(const float* __restrict__ x, float* __restrict__ out, ExactArgs a) {
  extern __shared__ __align__(16) float esmem[];
  float* T = esmem + a.t_off;
  float* ring = esmem + a.ring_off;
  const int tid = threadIdx.x;
  const int64_t gs = a.rows ? a.nlast : a.post;  // floats between device-memory rows

  // The chunk sequence: every chunk of every tile of this block, in order;
  // a chunk is cu units (cu * rpu device-memory rows, consecutive in memory
  // at stride gs), landed at stride ls.  The copies run up to two chunks
  // ahead of the sums, across tiles: a stage is refilled as soon as every
  // thread is past its last read, so the next tile's first two chunks land
  // while this tile's middle and outer axes are contracted.
  int64_t ld_tile = blockIdx.x, ld_row0 = 0, ld_q0 = 0;
  int ld_chunk = 0, ld_stage = 0, ld_pv = 0, ld_units = 0;
  const int mask = (1 << a.lgp) - 1;
  auto issue = [&]() {
    if (ld_tile < a.ntiles) {
      if (ld_chunk == 0) {
        const int64_t pt = ld_tile / a.ptiles;
        ld_q0 = (ld_tile - pt * a.ptiles) * a.P;
        ld_pv = static_cast<int>(min(static_cast<int64_t>(a.P), a.post - ld_q0));
        ld_units = static_cast<int>(min(static_cast<int64_t>(a.R), a.pre - pt * a.R)) * a.nurow;
        ld_row0 = pt * a.R * a.nurow * a.rpu;
      }
      const int u0 = ld_chunk * a.cu;
      const int nu = min(a.cu, ld_units - u0);
      const int nrow = (nu > 0 ? nu : 0) * a.rpu;
      const int Lv = a.rows ? a.nlast : ld_pv;
      float* dst = ring + ld_stage * a.stage;
      const float* src = x + (ld_row0 + static_cast<int64_t>(u0) * a.rpu) * gs + ld_q0;
      if (a.copy16) {
        for (int i = tid; i < (nrow << a.lgp); i += EX_THREADS) {
          const int r = i >> a.lgp, c = (i & mask) * 4;
          if (c < Lv) cp_async<16>(dst + r * a.ls + c, src + r * gs + c, 4 * min(4, Lv - c));
        }
      } else {
        for (int i = tid; i < (nrow << a.lgp); i += EX_THREADS) {
          const int r = i >> a.lgp, c = i & mask;
          if (c < Lv) cp_async<4>(dst + r * a.ls + c, src + r * gs + c, 4);
        }
      }
      if (++ld_chunk == a.chunks) {
        ld_chunk = 0;
        ld_tile += gridDim.x;
      }
    }
    cp_async_commit();
    ld_stage ^= 1;
  };
  issue();

  // The factors, transposed (K^T[k][o], rows padded with zeros to whole
  // 8-output slices): a lane's eight outputs at one k are two float4s.
  for (int ax = 0; ax < a.g; ++ax) {
    const float* K = a.K[ax];
    float* Kt = esmem + a.koff[ax];
    const int n = a.n[ax], no = a.o[ax], kld = a.kld[ax];
    for (int e = tid; e < n * kld; e += EX_THREADS) {
      const int k = e / kld, oo = e - k * kld;
      Kt[e] = oo < no ? K[static_cast<int64_t>(oo) * n + k] : 0.f;
    }
  }

  int stage = 0, ahead = 1;  // ahead: chunks issued and not yet summed (1 or 2)
  for (int64_t tile = blockIdx.x; tile < a.ntiles; tile += gridDim.x) {
    const int64_t pt = tile / a.ptiles, p0 = pt * a.R, q0 = (tile - pt * a.ptiles) * a.P;
    const int pv = static_cast<int>(min(static_cast<int64_t>(a.P), a.post - q0));
    const int rv = static_cast<int>(min(static_cast<int64_t>(a.R), a.pre - p0));
    const int units = rv * a.nurow;
    for (int c = 0; c < a.chunks; ++c) {
      if (ahead == 2)
        cp_async_wait<1>();
      else
        cp_async_wait<0>();
      __syncthreads();  // chunk c has landed; every thread is done with the other stage (and with T)
      if (ahead == 1) issue();  // into the other stage
      ahead = 1;
      const int u0 = c * a.cu;
      exact_first(a, ring + stage * a.stage, T, esmem, out, u0, min(a.cu, units - u0), p0, q0, pv);
      stage ^= 1;
    }
    if (a.g == 1) continue;
    __syncthreads();
    issue();  // into the stage just summed: two chunks in flight under the next contractions
    ahead = 2;
    if (a.g == 3) {
      exact_middle(a, T, esmem, rv);
      __syncthreads();
    }
    exact_last(a, T, esmem, out, p0, q0, pv, rv);
  }
  cp_async_wait<0>();
}

int launch_exact_tile(const void* x, void* out, const ExactArgs& a, int smem, cudaStream_t stream) {
  static LaunchCache cache;
  int grid = 0;
  const cudaError_t err = resident_grid(kron_exact_tile_kernel, cache, EX_THREADS, smem, a.ntiles, grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  kron_exact_tile_kernel<<<grid, EX_THREADS, smem, stream>>>(static_cast<const float*>(x), static_cast<float*>(out), a);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The wide member: batched C[b] (M x N) = A[b] (M x K) · B[b] (K x N) on the
// tensor cores.  A is K-contiguous (rows of lda); B is K-contiguous (BKM: the
// factor K, rows of ldb over N) or N-contiguous (X_p, rows of ldb over K); C
// is N-contiguous (rows of ldc).
// ---------------------------------------------------------------------------

struct WideArgs {
  int M, N, K;
  int64_t batch;
  int64_t lda, ldb, ldc;  // row strides, elements
  int64_t sAb, sBb, sCb;  // batch strides, elements
  int copyA, copyB;       // bytes per cp.async: 16 or 4; 0 = element-wise loads
  bool pairC;             // C's rows start at even elements: columns c, c + 1 as one store
};

// Columns c, c + 1 (c even) of a C row, as one 8-byte (f32) or 4-byte (bf16) store.
__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

template <typename T> __device__ __forceinline__ T zero_of();
template <> __device__ __forceinline__ float zero_of<float>() { return 0.f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero_of<__nv_bfloat16>() { return __float2bfloat16_rn(0.f); }

// Copy a rows x cols block (columns contiguous in memory and in shared
// memory) whose valid part is rows_valid x cols_valid; the rest is zero.
// `base` is any valid address of the operand, read by no copy of zero bytes.
template <typename T>
__device__ __forceinline__ void stage_block(T* dst, int ld_s, const T* src, int64_t ld_g, int rows, int cols,
                                            int rows_valid, int cols_valid, int copy, const T* base) {
  const int tid = threadIdx.x;
  if (copy == 0) {  // rows not 4-byte aligned (bf16 with an odd row length)
    for (int e = tid; e < rows * cols; e += WIDE_THREADS) {
      const int r = e / cols, c = e % cols;
      dst[r * ld_s + c] = (r < rows_valid && c < cols_valid) ? src[r * ld_g + c] : zero_of<T>();
    }
    return;
  }
  const int ch = copy / static_cast<int>(sizeof(T));  // elements per copy
  const int per_row = cols / ch;
  for (int i = tid; i < rows * per_row; i += WIDE_THREADS) {
    const int r = i / per_row, c = (i - r * per_row) * ch;
    int valid = r < rows_valid ? cols_valid - c : 0;
    valid = valid < 0 ? 0 : (valid > ch ? ch : valid);
    const T* from = valid ? src + r * ld_g + c : base;
    const int nbytes = valid * static_cast<int>(sizeof(T));
    if (copy == 16)
      cp_async<16>(dst + r * ld_s + c, from, nbytes);
    else
      cp_async<4>(dst + r * ld_s + c, from, nbytes);
  }
}

// Shared-memory row lengths (elements), padded so that every fragment load
// of a warp falls in distinct banks: K-contiguous operands are read as
// (row g, column t) words (tf32), (row g, columns 2t..2t+1) pairs (bf16
// from f32, one 8-byte load) or bf16x2 words; N-contiguous ones as
// (k t, column g) words (tf32) or (k 2t and 2t+1, column g) pairs.
template <bool FAST, typename T> constexpr int ld_kmajor(int depth) {
  return sizeof(T) == 4 ? depth + (FAST ? 8 : 4) : depth + 8;
}
template <bool FAST, typename T, int BN> constexpr int ld_nmajor() {
  return sizeof(T) == 4 ? BN + (FAST ? 4 : 8) : BN + 8;
}

// RES: the whole factor (the B of C = X·Kᵀ, exact grade) stays in shared
// memory after the ring, loaded once per block; the ring carries X alone.
// Every block reads the same factor, so re-staging it per tile costs as much
// L2 bandwidth as X's own stream at K6's shapes.
template <bool FAST, bool BKM, bool RES, int BN, typename AT, typename BT>
struct WideLayout {
  static constexpr int BK = RES ? 16 : WBK;  // depth of one staged chunk
  static constexpr int LDA = ld_kmajor<FAST, AT>(BK);
  static constexpr int LDB = BKM ? ld_kmajor<FAST, BT>(BK) : ld_nmajor<FAST, BT, BN>();
  static constexpr int A_BYTES = WBM * LDA * static_cast<int>(sizeof(AT));
  static constexpr int B_BYTES = RES ? 0 : (BKM ? BN : BK) * LDB * static_cast<int>(sizeof(BT));
  static constexpr int STAGE = A_BYTES + B_BYTES;
  // As many chunks in flight as two blocks an SM can hold (the reads, not
  // the products, bound K6's shapes), within WMIN_STAGES..WMAX_STAGES; with
  // a resident factor, four.
  static constexpr int STAGES = RES                                   ? 4
                                : TWO_BLOCK_SMEM / STAGE < WMIN_STAGES ? WMIN_STAGES
                                : TWO_BLOCK_SMEM / STAGE > WMAX_STAGES ? WMAX_STAGES
                                                                       : TWO_BLOCK_SMEM / STAGE;
  static constexpr int SMEM = STAGES * STAGE;  // + the resident factor
};

// Row length (floats) of a resident factor of depth K: a multiple of 32 plus
// 4, so that ldmatrix rows fall in distinct banks.
__host__ __device__ constexpr int resident_ld(int K) { return (K + 31) / 32 * 32 + 4; }

__device__ __forceinline__ uint32_t tf32_of(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}
// big = tf32(v), small = tf32(v - big): big + small carries v to ~2^-22.
__device__ __forceinline__ void split_tf32(float v, uint32_t& big, uint32_t& small) {
  big = tf32_of(v);
  small = tf32_of(v - __uint_as_float(big));
}
__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}
// Four 8x8 matrices of 16-bit elements (here 8 rows of four 32-bit words):
// lane l gives the row address of matrix l / 8, row l % 8, and gets word l % 4
// of row l / 4 of each matrix -- the (g, t) position of an mma fragment.
__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}
__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Two bf16 of a K-contiguous row at columns c, c+1 (c even), as one register.
__device__ __forceinline__ uint32_t kpair(const float* row, int c) {
  const float2 v = *reinterpret_cast<const float2*>(row + c);
  return bf16x2(v.x, v.y);
}
__device__ __forceinline__ uint32_t kpair(const __nv_bfloat16* row, int c) {
  return *reinterpret_cast<const uint32_t*>(row + c);
}

// FLUSH (exact grade, depth over FLUSH_DEPTH): each 32-deep chunk's products
// go to fresh accumulators, added to f32 sums after the chunk.  The tensor
// cores align and truncate every sum to the largest of its terms, so an
// accumulator carried across the whole depth loses precision in step with
// the depth (1.35e-5 at 1024, against the grade's 1e-5 limit); a chunk's
// partial stays small, and the f32 adds round to nearest.
template <bool FAST, bool BKM, bool RES, bool FLUSH, int BN, typename AT, typename BT, typename OT>
__global__ void __launch_bounds__(WIDE_THREADS, 2)
kron_wide_kernel(const AT* __restrict__ A, const BT* __restrict__ B, OT* __restrict__ C, WideArgs w) {
  using L = WideLayout<FAST, BKM, RES, BN, AT, BT>;
  constexpr int MT = WBM / 64, NT = BN / 16;  // m16 and n8 tiles of a warp's WBM/4 x BN/2 block
  extern __shared__ __align__(16) unsigned char wsmem[];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int wm0 = (warp % 4) * (WBM / 4), wn0 = (warp / 4) * (BN / 2);

  const int mt = (w.M + WBM - 1) / WBM, nt = (w.N + BN - 1) / BN;
  const int64_t tiles = w.batch * mt * nt;
  const int KT = (w.K + L::BK - 1) / L::BK;
  if (blockIdx.x >= tiles) return;
  const int64_t total = ((tiles - 1 - blockIdx.x) / gridDim.x + 1) * KT;

  // The loads run L::STAGES - 1 chunks ahead of the products, across tiles; a
  // tile's origin is decoded once, when its first chunk is issued.
  int64_t ld_tile = blockIdx.x;
  int ld_kt = 0, ld_stage = 0, ld_mv = 0, ld_nv = 0;
  const AT* ld_a = A;
  const BT* ld_b = B;
  auto issue = [&]() {
    if (ld_tile < tiles) {
      if (ld_kt == 0) {
        const int64_t b = ld_tile / (mt * nt);
        const int rem = static_cast<int>(ld_tile - b * (mt * nt));
        const int i0 = (rem / nt) * WBM, j0 = (rem % nt) * BN;
        ld_a = A + b * w.sAb + i0 * w.lda;
        ld_b = B + b * w.sBb + (BKM ? j0 * w.ldb : j0);
        ld_mv = w.M - i0;
        ld_nv = w.N - j0;
      }
      const int k0 = ld_kt * L::BK;
      AT* As = reinterpret_cast<AT*>(wsmem + ld_stage * L::STAGE);
      BT* Bs = reinterpret_cast<BT*>(wsmem + ld_stage * L::STAGE + L::A_BYTES);
      stage_block(As, L::LDA, ld_a + k0, w.lda, WBM, L::BK, ld_mv, w.K - k0, w.copyA, A);
      if constexpr (RES) {
      } else if constexpr (BKM) {
        stage_block(Bs, L::LDB, ld_b + k0, w.ldb, BN, L::BK, ld_nv, w.K - k0, w.copyB, B);
      } else {
        stage_block(Bs, L::LDB, ld_b + k0 * w.ldb, w.ldb, L::BK, BN, w.K - k0, ld_nv, w.copyB, B);
      }
      if (++ld_kt == KT) {
        ld_kt = 0;
        ld_tile += gridDim.x;
      }
    }
    cp_async_commit();
    ld_stage = ld_stage == L::STAGES - 1 ? 0 : ld_stage + 1;
  };
  // The resident factor (rows past N are never written out; columns past K
  // read zero) arrives with the first chunk's copies.
  BT* Bres = reinterpret_cast<BT*>(wsmem + L::SMEM);
  const int ldr = resident_ld(w.K);
  if constexpr (RES) stage_block(Bres, ldr, B, w.ldb, BN, ldr - 4, w.N, w.K, w.copyB, B);
#pragma unroll
  for (int s = 0; s < L::STAGES - 1; ++s) issue();

  float acc[MT][NT][4];
  float part[FLUSH ? MT : 1][FLUSH ? NT : 1][4];  // the chunk's products (FLUSH)
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        acc[i][j][q] = 0.f;
        if constexpr (FLUSH) part[i][j][q] = 0.f;
      }

  int64_t tile = blockIdx.x;
  int kt = 0, stage = 0;
  for (int64_t it = 0; it < total; ++it) {
    cp_async_wait<L::STAGES - 2>();
    __syncthreads();  // chunk `it` has landed, and every warp is done with chunk it - 1
    issue();
    const AT* As = reinterpret_cast<const AT*>(wsmem + stage * L::STAGE);
    const BT* Bs = reinterpret_cast<const BT*>(wsmem + stage * L::STAGE + L::A_BYTES);

    if constexpr (!FAST) {  // 3xTF32 on float operands, k8 steps
      const int q = lane / 8, rr = lane % 8;  // this lane's ldmatrix row address: matrix q, row rr
      // B's k8 steps: in this chunk's stage, or at depth kt·BK of the resident factor.
      const BT* Bk = RES ? Bres + kt * L::BK : Bs;
      const int ldb = RES ? ldr : L::LDB;
#pragma unroll
      for (int ks = 0; ks < L::BK; ks += 8) {
        if (kt * L::BK + ks >= w.K) break;  // the zero-filled end of the last chunk
        uint32_t abig[MT][4], asml[MT][4];
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          uint32_t raw[4];  // (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4) of the m16 x k8 tile
          ldsm_x4(raw, As + (wm0 + i * 16 + rr + 8 * (q & 1)) * L::LDA + ks + 4 * (q >> 1));
#pragma unroll
          for (int u = 0; u < 4; ++u) split_tf32(__uint_as_float(raw[u]), abig[i][u], asml[i][u]);
        }
#pragma unroll
        for (int j = 0; j < NT; j += 2) {  // two n8 tiles
          uint32_t raw[4];  // b0, b1 of tile j, then of tile j + 1
          if constexpr (BKM) {
            ldsm_x4(raw, Bk + (wn0 + (j + (q >> 1)) * 8 + rr) * ldb + ks + 4 * (q & 1));
          } else {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const BT* col = Bs + (ks + t) * L::LDB + wn0 + (j + h) * 8 + g;
              raw[2 * h] = __float_as_uint(col[0]);
              raw[2 * h + 1] = __float_as_uint(col[4 * L::LDB]);
            }
          }
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            uint32_t bbig[2], bsml[2];
            split_tf32(__uint_as_float(raw[2 * h]), bbig[0], bsml[0]);
            split_tf32(__uint_as_float(raw[2 * h + 1]), bbig[1], bsml[1]);
#pragma unroll
            for (int i = 0; i < MT; ++i) {
              float* c = FLUSH ? part[FLUSH ? i : 0][FLUSH ? j + h : 0] : acc[i][j + h];
              mma_tf32(c, asml[i], bbig);
              mma_tf32(c, abig[i], bsml);
              mma_tf32(c, abig[i], bbig);
            }
          }
        }
      }
      if constexpr (FLUSH) {
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              acc[i][j][q] += part[i][j][q];
              part[i][j][q] = 0.f;
            }
      }
    } else {  // bf16 m16n8k16
#pragma unroll
      for (int ks = 0; ks < L::BK; ks += 16) {
        if (kt * L::BK + ks >= w.K) break;
        uint32_t af[MT][4];
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          const AT* r0 = As + (wm0 + i * 16 + g) * L::LDA + ks;
          const AT* r1 = r0 + 8 * L::LDA;
          af[i][0] = kpair(r0, 2 * t);
          af[i][1] = kpair(r1, 2 * t);
          af[i][2] = kpair(r0, 2 * t + 8);
          af[i][3] = kpair(r1, 2 * t + 8);
        }
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int n = wn0 + j * 8 + g;
          uint32_t bf[2];
          if constexpr (BKM) {
            bf[0] = kpair(Bs + n * L::LDB + ks, 2 * t);
            bf[1] = kpair(Bs + n * L::LDB + ks, 2 * t + 8);
          } else {
            const BT* col = Bs + ks * L::LDB + n;
            bf[0] = bf16x2(to_f32(col[(2 * t) * L::LDB]), to_f32(col[(2 * t + 1) * L::LDB]));
            bf[1] = bf16x2(to_f32(col[(2 * t + 8) * L::LDB]), to_f32(col[(2 * t + 9) * L::LDB]));
          }
#pragma unroll
          for (int i = 0; i < MT; ++i) mma_bf16(acc[i][j], af[i], bf);
        }
      }
    }

    stage = stage == L::STAGES - 1 ? 0 : stage + 1;
    if (++kt == KT) {  // the tile's last chunk: write it out and start the next
      const int64_t b = tile / (mt * nt);
      const int rem = static_cast<int>(tile % (mt * nt));
      const int i0 = (rem / nt) * WBM, j0 = (rem % nt) * BN;
      OT* Cb = C + b * w.sCb;
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int c = j0 + wn0 + j * 8 + 2 * t;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = i0 + wm0 + i * 16 + g + 8 * h;
            if (r < w.M) {
              OT* p = Cb + r * w.ldc + c;
              if (w.pairC && c + 1 < w.N) {
                store_pair(p, acc[i][j][2 * h], acc[i][j][2 * h + 1]);
              } else {
                if (c < w.N) p[0] = from_f32<OT>(acc[i][j][2 * h]);
                if (c + 1 < w.N) p[1] = from_f32<OT>(acc[i][j][2 * h + 1]);
              }
            }
            acc[i][j][2 * h] = acc[i][j][2 * h + 1] = 0.f;
          }
        }
      kt = 0;
      tile += gridDim.x;
    }
  }
  cp_async_wait<0>();
}

// Bytes per cp.async for an operand at p with row stride ld and batch stride
// sb (elements of `size` bytes): 16 where every row starts 16-byte aligned,
// else 4 where every row starts 4-byte aligned, else 0.
int copy_bytes(const void* p, int64_t ld, int64_t sb, int size) {
  const auto aligned = [&](int64_t b) {
    return reinterpret_cast<uintptr_t>(p) % b == 0 && (ld * size) % b == 0 && (sb * size) % b == 0;
  };
  return aligned(16) ? 16 : (aligned(4) ? 4 : 0);
}

template <bool FAST, bool BKM, bool RES, int BN, typename AT, typename BT, typename OT>
int launch_wide(const void* A, const void* B, void* C, WideArgs w, cudaStream_t stream) {
  constexpr bool FLUSHES = !FAST && !RES && BN == 64;
  static LaunchCache cache, flush_cache;
  const bool flush = FLUSHES && w.K > FLUSH_DEPTH;
  auto kern = flush ? kron_wide_kernel<FAST, BKM, RES, FLUSHES, BN, AT, BT, OT>
                    : kron_wide_kernel<FAST, BKM, RES, false, BN, AT, BT, OT>;
  const int smem = WideLayout<FAST, BKM, RES, BN, AT, BT>::SMEM +
                   (RES ? BN * resident_ld(w.K) * static_cast<int>(sizeof(BT)) : 0);
  w.copyA = copy_bytes(A, w.lda, w.sAb, sizeof(AT));
  w.copyB = copy_bytes(B, w.ldb, w.sBb, sizeof(BT));
  w.pairC = reinterpret_cast<uintptr_t>(C) % (2 * sizeof(OT)) == 0 && w.ldc % 2 == 0 && w.sCb % 2 == 0;
  int grid = 0;
  const int64_t tiles = w.batch * ((w.M + WBM - 1) / WBM) * ((w.N + BN - 1) / BN);
  const cudaError_t err = resident_grid(kern, flush ? flush_cache : cache, WIDE_THREADS, smem, tiles, grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<grid, WIDE_THREADS, smem, stream>>>(static_cast<const AT*>(A), static_cast<const BT*>(B),
                                             static_cast<OT*>(C), w);
  return static_cast<int>(cudaGetLastError());
}

// x is the A operand when the contracted axis is last (C = X·Kᵀ, K read as a
// K-contiguous B), else the N-contiguous B operand (C_p = K·X_p).
template <bool FAST, typename XT, typename OT>
int wide_by_role(const void* x, const void* K, void* out, const WideArgs& w, bool x_is_a, int bn, cudaStream_t s) {
  if (!FAST && w.K > FLUSH_DEPTH) bn = 64;  // room for the per-chunk partial sums (FLUSH)
  if (x_is_a) {
    if constexpr (!FAST) {  // the factor resident where it fits beside the ring, two blocks an SM
      const auto fits = [&](int tile, int ring) {
        return w.N <= tile && w.K <= 1024 && tile * resident_ld(w.K) * 4 + ring <= TWO_BLOCK_SMEM;
      };
      if (bn == 64 && fits(64, WideLayout<false, true, true, 64, float, float>::SMEM))
        return launch_wide<false, true, true, 64, float, float, float>(x, K, out, w, s);
      if (bn == 128 && fits(128, WideLayout<false, true, true, 128, float, float>::SMEM))
        return launch_wide<false, true, true, 128, float, float, float>(x, K, out, w, s);
    }
    return bn == 64 ? launch_wide<FAST, true, false, 64, XT, float, OT>(x, K, out, w, s)
                    : launch_wide<FAST, true, false, 128, XT, float, OT>(x, K, out, w, s);
  }
  return bn == 64 ? launch_wide<FAST, false, false, 64, float, XT, OT>(K, x, out, w, s)
                  : launch_wide<FAST, false, false, 128, float, XT, OT>(K, x, out, w, s);
}

// ---------------------------------------------------------------------------
// The tensor-core tile member (fast grade): the tile member's groups of up
// to three axes, staged as bf16 and contracted by bf16 mma.sync.
// ---------------------------------------------------------------------------

constexpr int MMA_THREADS = 256;
constexpr int MMA_WARPS = MMA_THREADS / 32;
constexpr int MMA_LOAD_BATCH = 2;  // 16-byte chunks of the tile in flight per thread

struct MmaArgs {
  const float* K[3];
  int g;
  int n[3], o[3];
  int lgE[3];   // log2 of each axis' padded extent E = pow2(max(n, o, 16))
  int lgP;      // log2 of the padded column count Pp = pow2(max(P, 16)); 0 when P == 1
  int64_t pre, post;
  int P, R;
  int64_t ptiles;
  int lgrow;    // log2 of a row's padded elements, prod E * Pp
  int koff[3];  // element offset of each factor (E x E) after the R rows
};

// Physical element of tile element f: the 16-byte chunk f / 8 keeps its
// 128-byte line and XORs its place in it with its higher bits, folded three
// at a time.  Eight chunks at any power-of-two stride then fall in eight
// distinct bank groups, so every ldmatrix, every pair store and every staged
// chunk of a warp is free of bank conflicts whichever axis it walks.
__device__ __forceinline__ int swz(int f) {
  const int h = f >> 3;
  return (((h & ~7) | ((h ^ (h >> 3) ^ (h >> 6) ^ (h >> 9) ^ (h >> 12)) & 7)) << 3) | (f & 7);
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

__device__ __forceinline__ void store_bf16_pair(__nv_bfloat16* tile, int f, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(tile + swz(f)) = __floats2bfloat162_rn(a, b);
}

// Where the last contraction of a pass writes: out[p0 + r, o_0, .., o_{g-1},
// q0 + q] (`out` already at row p0) for tile element (r, o_0, c), c = (i_1,
// .., i_{g-1}[, q]) packed with the padded extents; elements in the padding
// are not written.
struct MmaOut {
  int64_t q0;
  int pv;
  int64_t row, ostride;  // elements between rows r and between outputs o_0
};

// The offset in `out`, from element (r, o_0 = 0), of tile column c, and how
// many of columns c, c + 1 (c even, in one innermost line) are outputs:
// 0 where c lies in the padding.  Decoded once per column, not per output.
__device__ __forceinline__ int64_t out_column(const MmaArgs& a, const MmaOut& mo, int c, int& nvalid) {
  int inner, valid, rest = c;
  if (a.P > 1) {
    inner = rest & ((1 << a.lgP) - 1);
    rest >>= a.lgP;
    valid = mo.pv;
  } else {
    inner = rest & ((1 << a.lgE[a.g - 1]) - 1);
    rest >>= a.lgE[a.g - 1];
    valid = a.o[a.g - 1];
  }
  nvalid = 0;
  // The axes between 0 and the innermost staged one, last to first
  // (unrolled: constant indices keep MmaArgs out of local memory).
  const int last = a.P > 1 ? a.g - 1 : a.g - 2;
  int64_t scale = 1, mid = 0;
#pragma unroll
  for (int ax = 2; ax >= 1; --ax) {
    if (ax > last) continue;
    const int i = rest & ((1 << a.lgE[ax]) - 1);
    rest >>= a.lgE[ax];
    if (i >= a.o[ax]) return 0;
    mid += i * scale;
    scale *= a.o[ax];
  }
  if (inner >= valid) return 0;
  nvalid = inner + 1 < valid ? 2 : 1;
  return a.P > 1 ? mid * a.post + mo.q0 + inner : mid * a.o[a.g - 1] + inner;
}

// Y_a (E x C) = K (E x E) · X_a (E x C) for a < A: the tile viewed as (A, E,
// C), C = 2^lgC contiguous; K the A operand, X_a the B operand (ldmatrix
// .trans).  A warp takes (a, NB columns) at a time and reads all of X_a's
// E rows of its columns before it writes them, so the product runs in place.
// FINAL: write to `out` instead of the tile.
template <int E, bool FINAL, typename OT>
__device__ __forceinline__ void contract_mid(__nv_bfloat16* tile, const __nv_bfloat16* Ks, int A, int lgC,
                                             OT* out, const MmaArgs& ar, const MmaOut& mo) {
  constexpr int LGE = E == 16 ? 4 : (E == 32 ? 5 : 6);
  constexpr int MT = E / 16;
  constexpr int NB = 1024 / E;  // columns a warp takes: 32 accumulators a thread
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;
  const int C = 1 << lgC;
  const int nbc = C < NB ? C : NB;
  const int nblk = C / nbc;
  for (int task = warp; task < A * nblk; task += MMA_WARPS) {
    const int a = task / nblk, cb = (task - a * nblk) * nbc;
    const int base = (a << LGE) << lgC;
    float acc[MT][NB / 8][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NB / 8; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;
#pragma unroll
    for (int ks = 0; ks < MT; ++ks) {
      uint32_t af[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i)
        ldsm_x4(af[i], Ks + swz(((i * 16 + (lane & 7) + 8 * ((lane >> 3) & 1)) << LGE) + ks * 16 + 8 * (lane >> 4)));
#pragma unroll
      for (int jj = 0; jj < NB / 16; ++jj) {
        if (jj * 16 >= nbc) break;
        uint32_t bf[4];
        ldsm_x4_trans(bf, tile + swz(base + ((ks * 16 + (lane & 7) + 8 * ((lane >> 3) & 1)) << lgC) + cb + jj * 16 +
                                      8 * (lane >> 4)));
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          mma_bf16(acc[i][2 * jj], af[i], bf);
          mma_bf16(acc[i][2 * jj + 1], af[i], bf + 2);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < NB / 8; ++j) {
      if (j * 8 >= nbc) break;
      const int c = cb + j * 8 + 2 * t;
      int nv = 0;
      const int64_t coff = FINAL ? out_column(ar, mo, c, nv) : 0;
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int o = i * 16 + g + 8 * h;
          const float v0 = acc[i][j][2 * h], v1 = acc[i][j][2 * h + 1];
          if constexpr (FINAL) {
            if (nv == 0 || o >= ar.o[0]) continue;
            OT* p = out + a * mo.row + o * mo.ostride + coff;
            if (nv == 2 && reinterpret_cast<uintptr_t>(p) % (2 * sizeof(OT)) == 0) {
              store_pair(p, v0, v1);
            } else {
              p[0] = from_f32<OT>(v0);
              if (nv == 2) p[1] = from_f32<OT>(v1);
            }
          } else {
            store_bf16_pair(tile, base + (o << lgC) + c, v0, v1);
          }
        }
    }
  }
}

// Y (A x E) = X (A x E) · Kᵀ: the contracted axis innermost (P == 1); X the
// A operand, K (rows o, k contiguous) the column-major B operand.  A warp
// takes 16·MB rows at a time, in place.
template <int E>
__device__ __forceinline__ void contract_last(__nv_bfloat16* tile, const __nv_bfloat16* Ks, int A) {
  constexpr int LGE = E == 16 ? 4 : (E == 32 ? 5 : 6);
  constexpr int KT = E / 16;
  constexpr int MB = 64 / E;  // m16 tiles a warp takes: 32 accumulators a thread
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;
  for (int m0 = warp * 16 * MB; m0 < A; m0 += MMA_WARPS * 16 * MB) {
    float acc[MB][E / 8][4];
#pragma unroll
    for (int i = 0; i < MB; ++i)
#pragma unroll
      for (int j = 0; j < E / 8; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KT; ++ks) {
      uint32_t af[MB][4];
#pragma unroll
      for (int i = 0; i < MB; ++i)
        if (m0 + i * 16 < A)
          ldsm_x4(af[i], tile + swz(((m0 + i * 16 + (lane & 7) + 8 * ((lane >> 3) & 1)) << LGE) + ks * 16 +
                                    8 * (lane >> 4)));
#pragma unroll
      for (int jj = 0; jj < E / 16; ++jj) {
        uint32_t bf[4];
        ldsm_x4(bf, Ks + swz(((jj * 16 + (lane & 7) + 8 * (lane >> 4)) << LGE) + ks * 16 + 8 * ((lane >> 3) & 1)));
#pragma unroll
        for (int i = 0; i < MB; ++i) {
          if (m0 + i * 16 >= A) break;
          mma_bf16(acc[i][2 * jj], af[i], bf);
          mma_bf16(acc[i][2 * jj + 1], af[i], bf + 2);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < MB; ++i) {
      if (m0 + i * 16 >= A) break;
#pragma unroll
      for (int j = 0; j < E / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          store_bf16_pair(tile, ((m0 + i * 16 + g + 8 * h) << LGE) + j * 8 + 2 * t, acc[i][j][2 * h],
                          acc[i][j][2 * h + 1]);
    }
  }
}

template <bool FINAL, typename OT>
__device__ __forceinline__ void contract_axis(__nv_bfloat16* tile, const __nv_bfloat16* Ks, int lgE, int A, int lgC,
                                              bool last, OT* out, const MmaArgs& ar, const MmaOut& mo) {
  if (last) {  // never the final contraction of a pass (the host keeps g == 1, P == 1 off this member)
    if (lgE == 4) contract_last<16>(tile, Ks, A);
    else if (lgE == 5) contract_last<32>(tile, Ks, A);
    else contract_last<64>(tile, Ks, A);
  } else {
    if (lgE == 4) contract_mid<16, FINAL>(tile, Ks, A, lgC, out, ar, mo);
    else if (lgE == 5) contract_mid<32, FINAL>(tile, Ks, A, lgC, out, ar, mo);
    else contract_mid<64, FINAL>(tile, Ks, A, lgC, out, ar, mo);
  }
}

__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 a = reinterpret_cast<const float4*>(p)[0], b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w, v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* v) {
  const uint4 a = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&a);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x, v[2 * i + 1] = f.y;
  }
}

template <typename XT, typename OT>
__global__ void __launch_bounds__(MMA_THREADS, 2)
kron_mma_tile_kernel(const XT* __restrict__ x, OT* __restrict__ out, MmaArgs a) {
  extern __shared__ __align__(16) unsigned char msmem[];
  __nv_bfloat16* tile = reinterpret_cast<__nv_bfloat16*>(msmem);
  const int tid = threadIdx.x;

  // The factors, rounded to bf16 (the grade's operand rounding), E x E with
  // zeros past (o, n): padded outputs come out zero, padded inputs add nothing.
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    if (ax >= a.g) continue;
    const int lgE = a.lgE[ax], E = 1 << lgE, n = a.n[ax], o = a.o[ax];
    for (int e = tid; e < E * E; e += MMA_THREADS) {
      const int r = e >> lgE, c = e & (E - 1);
      tile[a.koff[ax] + swz(e)] = __float2bfloat16_rn(r < o && c < n ? a.K[ax][static_cast<int64_t>(r) * n + c] : 0.f);
    }
  }

  // n and o of the unused axes are 1.
  const int nin = a.n[0] * a.n[1] * a.n[2], nout = a.o[0] * a.o[1] * a.o[2];
  // A staged line: the columns (P > 1) or the last axis (P == 1).
  const int lgline = a.P > 1 ? a.lgP : a.lgE[a.g - 1];
  const int nouter = a.P > 1 ? a.g : a.g - 1;  // axes decoded from a line's index
  const int64_t batches = (a.pre + a.R - 1) / a.R;
  const int chunks = (a.R << a.lgrow) >> 3;

  for (int64_t blk = blockIdx.x; blk < batches * a.ptiles; blk += gridDim.x) {
    const int64_t p0 = (blk / a.ptiles) * a.R;
    const int64_t q0 = (blk % a.ptiles) * a.P;
    const int pv = static_cast<int>(min(static_cast<int64_t>(a.P), a.post - q0));
    const int rv = static_cast<int>(min(static_cast<int64_t>(a.R), a.pre - p0));
    const int valid_inner = a.P > 1 ? pv : a.n[a.g - 1];
    const XT* xp = x + p0 * nin * a.post + q0;

    // Stage the padded tile, 8 elements (16 bytes of bf16) per chunk; pow2
    // extents make a chunk's indices shifts and masks.
    for (int c0 = tid; c0 < chunks; c0 += MMA_LOAD_BATCH * MMA_THREADS) {
      float v[MMA_LOAD_BATCH][8];
#pragma unroll
      for (int u = 0; u < MMA_LOAD_BATCH; ++u) {
        const int ch = c0 + u * MMA_THREADS;
#pragma unroll
        for (int i = 0; i < 8; ++i) v[u][i] = 0.f;
        if (ch >= chunks) continue;
        const int f = ch << 3;
        const int q8 = f & ((1 << lgline) - 1);
        int line = f >> lgline;
        bool ok = true;
        int64_t off = 0, scale = 1;  // the line's row of x, in lines of the input extents
#pragma unroll
        for (int ax = 2; ax >= 0; --ax) {
          if (ax >= nouter) continue;
          const int i = line & ((1 << a.lgE[ax]) - 1);
          line >>= a.lgE[ax];
          ok = ok && i < a.n[ax];
          off += i * scale;
          scale *= a.n[ax];
        }
        const int vc = valid_inner - q8;
        if (!ok || line >= rv || vc <= 0) continue;
        off += line * scale;
        const XT* p = a.P > 1 ? xp + off * a.post + q8 : xp + off * a.n[a.g - 1] + q8;
        if (vc >= 8 && reinterpret_cast<uintptr_t>(p) % 16 == 0) {
          load8(p, v[u]);
        } else {
#pragma unroll
          for (int i = 0; i < 8; ++i)
            if (i < vc) v[u][i] = to_f32(p[i]);
        }
      }
#pragma unroll
      for (int u = 0; u < MMA_LOAD_BATCH; ++u) {
        const int ch = c0 + u * MMA_THREADS;
        if (ch >= chunks) continue;
        uint4 w;
        w.x = bf16x2(v[u][0], v[u][1]), w.y = bf16x2(v[u][2], v[u][3]);
        w.z = bf16x2(v[u][4], v[u][5]), w.w = bf16x2(v[u][6], v[u][7]);
        *reinterpret_cast<uint4*>(tile + swz(ch << 3)) = w;
      }
    }
    __syncthreads();

    // Contract the group's axes from the last to the first, in place; the
    // first axis' products go to `out`.
    const MmaOut mo{q0, pv, static_cast<int64_t>(nout) * a.post, static_cast<int64_t>(nout / a.o[0]) * a.post};
    OT* op = out + p0 * nout * a.post;
#pragma unroll
    for (int t = 2; t >= 0; --t) {
      if (t >= a.g) continue;
      // lgE of the unused axes is 0: the sums over all three axes hold.
      const int lgA = (t > 0 ? a.lgE[0] : 0) + (t > 1 ? a.lgE[1] : 0);
      const int lgC = (a.P > 1 ? a.lgP : 0) + (t < 1 ? a.lgE[1] : 0) + (t < 2 ? a.lgE[2] : 0);
      const __nv_bfloat16* Ks = tile + a.koff[t];
      if (t == 0)
        contract_axis<true>(tile, Ks, a.lgE[t], rv << lgA, lgC, lgC == 0, op, a, mo);
      else
        contract_axis<false>(tile, Ks, a.lgE[t], rv << lgA, lgC, lgC == 0, op, a, mo);
      __syncthreads();
    }
  }
}

template <typename XT, typename OT>
int launch_mma_tile(const void* x, void* out, const MmaArgs& a, int smem, cudaStream_t stream) {
  static LaunchCache cache;
  auto kern = kron_mma_tile_kernel<XT, OT>;
  int grid = 0;
  const cudaError_t err = resident_grid(kern, cache, MMA_THREADS, smem, (a.pre + a.R - 1) / a.R * a.ptiles, grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<grid, MMA_THREADS, smem, stream>>>(static_cast<const XT*>(x), static_cast<OT*>(out), a);
  return static_cast<int>(cudaGetLastError());
}

int log2_pad16(int v) {  // log2 of max(16, the next power of two >= v)
  int l = 4;
  while ((1 << l) < v) ++l;
  return l;
}

constexpr int ERR_SHAPE = -1;  // arguments the kernels do not take

int log2_ceil(int v) {  // log2 of the next power of two >= v
  int l = 0;
  while ((1 << l) < v) ++l;
  return l;
}

// The exact member's layout for a tile pass: the shared-memory bytes (the
// transposed factors, T, two ring stages), or ERR_SHAPE.  ops/cuda/kron.py
// restates this arithmetic (_exact_tile_layout) to plan P and R.
int64_t exact_layout(ExactArgs& e, const int* ns, const int* os) {
  const int g = e.g;
  int64_t kfl = 0;
  for (int ax = 0; ax < g; ++ax) {
    if (ns[ax] < 1 || ns[ax] > 64 || os[ax] < 1 || os[ax] > 8 * 32) return ERR_SHAPE;
    e.n[ax] = ns[ax], e.o[ax] = os[ax];
    e.lgS[ax] = log2_ceil((os[ax] + EX_OUT - 1) / EX_OUT);
    e.kld[ax] = EX_OUT << e.lgS[ax];
    e.koff[ax] = static_cast<int>(kfl);
    kfl += static_cast<int64_t>(ns[ax]) * e.kld[ax];
  }
  for (int ax = g; ax < 3; ++ax) e.n[ax] = e.o[ax] = 1;
  e.rows = e.post == 1;
  e.nlast = ns[g - 1];
  e.rpu = e.rows ? 1 : e.nlast;
  // Rows: an odd number of float4s apart, so that the rows a quarter-warp
  // reads at once fall in distinct banks; columns: P rounded up to 4.
  e.ls = e.rows ? 4 * (((e.nlast + 3) / 4) | 1) : 4 * ((e.P + 3) / 4);
  e.nurow = g >= 2 ? ns[0] * (g == 3 ? ns[1] : 1) : 1;
  e.E0 = ns[0] > os[0] ? ns[0] : os[0];
  e.E1 = g == 3 ? (ns[1] > os[1] ? ns[1] : os[1]) : 1;
  const int olast = os[g - 1];
  e.tight = !e.rows && e.P % 4 != 0;
  e.inner = e.rows ? (olast + 3) / 4 * 4 : e.tight ? (olast * e.P + 3) / 4 * 4 : olast * e.ls;
  e.tstride0 = (g == 3 ? e.E1 : 1) * e.inner;
  e.same_units = (g < 2 || e.E0 == ns[0]) && (g < 3 || e.E1 == ns[1]);
  const int64_t tfl = g == 1 ? 0 : static_cast<int64_t>(e.R) * e.E0 * e.tstride0;
  // Units a chunk: enough first-axis tasks for every thread (a task: four
  // fibres x one 8-output slice), at most the tile's units; halved until
  // two stages fit beside the factors and T.  One tile is one chunk at g = 1.
  const int64_t units = static_cast<int64_t>(e.R) * e.nurow;
  const int lgS = e.lgS[g - 1];
  auto tasks = [&](int64_t cu) { return (e.rows ? (cu + 3) / 4 : cu * (e.ls / 4)) << lgS; };
  auto stage = [&](int64_t cu) { return (e.rows ? (cu + 3) / 4 * 4 : cu) * e.rpu * e.ls; };
  int64_t cu = 1;
  if (g == 1) {
    cu = e.R;
  } else {
    while (cu < units && tasks(cu) < EX_THREADS) cu *= 2;
    cu = cu < units ? cu : units;
    while (cu > 1 && 4 * (kfl + tfl + 2 * stage(cu)) > SMEM_LIMIT) cu /= 2;
  }
  const int64_t smem = 4 * (kfl + tfl + 2 * stage(cu));
  if (smem > SMEM_LIMIT) return ERR_SHAPE;
  e.cu = static_cast<int>(cu);
  e.chunks = static_cast<int>((units + cu - 1) / cu);
  e.stage = static_cast<int>(stage(cu));
  e.t_off = static_cast<int>(kfl);
  e.ring_off = static_cast<int>(kfl + tfl);
  return smem;
}

}  // namespace

// Plain C entry points, loaded with ctypes.  Pointers and the stream are
// void*; `device` is the index of the card the tensors and the stream are on.
// The return value is the launch's cudaError_t, or ERR_SHAPE.
//
// Tile pass: contract g (1-3) adjacent axes of x (pre, n_0..n_{g-1}, post)
// with factors K_a (o_a, n_a), f32, row-major; every n_a <= 64.  P columns
// of post and R rows of pre per block (R > 1 only when P == post).  The
// exact grade (fast = 0) runs the exact member (o_a <= 256; its shared
// memory is exact_layout's).  mma selects the tensor-core member (fast grade
// only; its shared memory is 2 * (R * prod E * Pp + sum E^2) bytes, E and Pp
// padded to powers of two of at least 16); otherwise the fast grade runs the
// FP32 member.  ops/cuda/kron.py plans all three with the same arithmetic.
extern "C" int gp_grief_kron_tile_pass(const void* x, void* out, const void* K0, const void* K1,
                                       const void* K2, int g, int n0, int n1, int n2, int o0, int o1,
                                       int o2, long long pre, long long post, int P, int R, int mma,
                                       int fast, int x_bf16, int out_bf16, int device, void* stream) {
  const DeviceScope scope(device);
  if (scope.err != cudaSuccess) return static_cast<int>(scope.err);
  const void* Ks[3] = {K0, K1, K2};
  const int ns[3] = {n0, n1, n2}, os[3] = {o0, o1, o2};
  if (g < 1 || g > 3 || pre < 1 || post < 1 || P < 1 || P > post) return ERR_SHAPE;
  if (R < 1 || (R > 1 && P != post)) return ERR_SHAPE;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mma) {  // the tensor-core member: fast grade; not a lone innermost axis
    if (!fast || (g == 1 && P == 1) || P > 128) return ERR_SHAPE;
    MmaArgs m{};
    m.g = g, m.pre = pre, m.post = post, m.P = P, m.R = R;
    m.ptiles = (post + P - 1) / P;
    m.lgP = P > 1 ? log2_pad16(P) : 0;
    int lgrow = m.lgP;
    for (int ax = 0; ax < g; ++ax) {
      if (ns[ax] < 1 || ns[ax] > 64 || os[ax] < 1 || os[ax] > 64) return ERR_SHAPE;
      m.K[ax] = static_cast<const float*>(Ks[ax]);
      m.n[ax] = ns[ax], m.o[ax] = os[ax];
      m.lgE[ax] = log2_pad16(ns[ax] > os[ax] ? ns[ax] : os[ax]);
      lgrow += m.lgE[ax];
    }
    for (int ax = g; ax < 3; ++ax) m.n[ax] = m.o[ax] = 1, m.lgE[ax] = 0;
    m.lgrow = lgrow;
    int64_t elems = static_cast<int64_t>(R) << lgrow;
    for (int ax = 0; ax < g; ++ax) {
      if (elems > SMEM_LIMIT) return ERR_SHAPE;
      m.koff[ax] = static_cast<int>(elems);
      elems += int64_t{1} << (2 * m.lgE[ax]);
    }
    if (2 * elems > SMEM_LIMIT) return ERR_SHAPE;
    const int smem = static_cast<int>(2 * elems);
    if (x_bf16) {
      return out_bf16 ? launch_mma_tile<__nv_bfloat16, __nv_bfloat16>(x, out, m, smem, st)
                      : launch_mma_tile<__nv_bfloat16, float>(x, out, m, smem, st);
    }
    return out_bf16 ? launch_mma_tile<float, __nv_bfloat16>(x, out, m, smem, st)
                    : launch_mma_tile<float, float>(x, out, m, smem, st);
  }
  if (!fast) {  // the exact member
    if (x_bf16 || out_bf16) return ERR_SHAPE;
    ExactArgs e{};
    e.g = g, e.pre = pre, e.post = post, e.P = P, e.R = R;
    e.ptiles = (post + P - 1) / P;
    e.ntiles = (pre + R - 1) / R * e.ptiles;
    for (int ax = 0; ax < g; ++ax) e.K[ax] = static_cast<const float*>(Ks[ax]);
    const int64_t smem = exact_layout(e, ns, os);
    if (smem < 0) return ERR_SHAPE;
    const int L = e.rows ? e.nlast : P;
    e.copy16 = reinterpret_cast<uintptr_t>(x) % 16 == 0 && L % 4 == 0 && (e.rows || post % 4 == 0);
    e.lgp = log2_ceil(e.copy16 ? (L + 3) / 4 : L);
    return launch_exact_tile(x, out, e, static_cast<int>(smem), st);
  }
  TileArgs a{};
  a.g = g;
  a.pre = pre;
  a.post = post;
  a.P = P;
  a.R = R;
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
  // distinct banks; R rows of that tile, one after another.
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
  if (s > SMEM_LIMIT) return ERR_SHAPE;
  a.row_tile = static_cast<int>(s);
  a.row_stride = naxes > 1 ? a.stride[naxes - 2] : static_cast<int>(s);
  a.in_rows = a.out_rows = true;
  for (int ax = 0; ax < naxes - 1 && ax < g; ++ax) {
    a.in_rows = a.in_rows && ext[ax] == ns[ax];
    a.out_rows = a.out_rows && ext[ax] == os[ax];
  }
  int64_t floats = (static_cast<int64_t>(R) * s + 3) / 4 * 4;  // factor rows are read as float4
  if (floats * 4 > SMEM_LIMIT) return ERR_SHAPE;
  for (int ax = 0; ax < g; ++ax) {
    a.koff[ax] = static_cast<int>(floats);
    floats += static_cast<int64_t>(a.o[ax]) * a.npad[ax];
  }
  const int64_t smem = floats * 4;
  if (smem > SMEM_LIMIT) return ERR_SHAPE;
  const int sm = static_cast<int>(smem);
  if (x_bf16) {
    return out_bf16 ? tile_by_width<__nv_bfloat16, __nv_bfloat16>(x, out, a, sm, maxn, st)
                    : tile_by_width<__nv_bfloat16, float>(x, out, a, sm, maxn, st);
  }
  return out_bf16 ? tile_by_width<float, __nv_bfloat16>(x, out, a, sm, maxn, st)
                  : tile_by_width<float, float>(x, out, a, sm, maxn, st);
}

// Wide pass: contract one axis of x (pre, n, post) with K (o, n), f32, in
// output tiles bn (64 or 128) wide.
extern "C" int gp_grief_kron_wide_pass(const void* x, void* out, const void* K, int n, int o,
                                       long long pre, long long post, int bn, int fast, int x_bf16,
                                       int out_bf16, int device, void* stream) {
  const DeviceScope scope(device);
  if (scope.err != cudaSuccess) return static_cast<int>(scope.err);
  if (n < 1 || o < 1 || pre < 1 || post < 1 || (bn != 64 && bn != 128)) return ERR_SHAPE;
  WideArgs w{};
  const bool x_is_a = post == 1;
  if (x_is_a) {  // C (pre x o) = X (pre x n) · Kᵀ
    if (pre > INT32_MAX) return ERR_SHAPE;
    w.M = static_cast<int>(pre); w.N = o; w.K = n; w.batch = 1;
    w.lda = n; w.ldb = n; w.ldc = o;
    w.sAb = w.sBb = w.sCb = 0;
  } else {  // C_p (o x post) = K (o x n) · X_p (n x post)
    if (post > INT32_MAX) return ERR_SHAPE;
    w.M = o; w.N = static_cast<int>(post); w.K = n; w.batch = pre;
    w.lda = n; w.ldb = post; w.ldc = post;
    w.sAb = 0;
    w.sBb = static_cast<int64_t>(n) * post;
    w.sCb = static_cast<int64_t>(o) * post;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!fast) {
    if (x_bf16 || out_bf16) return ERR_SHAPE;
    return wide_by_role<false, float, float>(x, K, out, w, x_is_a, bn, st);
  }
  if (x_bf16) {
    return out_bf16 ? wide_by_role<true, __nv_bfloat16, __nv_bfloat16>(x, K, out, w, x_is_a, bn, st)
                    : wide_by_role<true, __nv_bfloat16, float>(x, K, out, w, x_is_a, bn, st);
  }
  return out_bf16 ? wide_by_role<true, float, __nv_bfloat16>(x, K, out, w, x_is_a, bn, st)
                  : wide_by_role<true, float, float>(x, K, out, w, x_is_a, bn, st);
}
