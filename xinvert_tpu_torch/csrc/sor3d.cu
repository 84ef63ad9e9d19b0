// Red-black SOR sweeps of a 3-D stencil, hand-written for Hopper (sm_90a).
//
// Replaces both TPU kernels of the 3-D path (invert_omega, invert_3DOcean,
// inv_standard3D, inv_general3D):
//   - xinvert_tpu/ops/pallas_sor3d.py::_kernel (+ _extend_rows3d), the
//     VMEM-resident multi-sweep kernel for volumes that fit on the TPU core;
//   - xinvert_tpu/ops/pallas_sor3d_window.py::_kernel, the z-windowed kernel
//     for larger volumes, with its z<->y permuted layout for wide, flat
//     ocean volumes (extend_mode "win") and its norm for checked solves.
// VMEM residency, z windows, level chunks, batch groups and the permuted
// layout exist only to fit a TPU core's VMEM; on Hopper the two compute one
// function, so one kernel, sor3d_color_sweep, serves every 3-D shape.  B5's
// sharded-block variants (pad_row, has_ytop/has_ybot, parity_off, pad_col,
// clamp_w/clamp_e, pad_lo with goff_ref; B5s), which serve the multi-device
// executor, run in a kernel of their own, sor3d_block_sweep (its header is
// below the color sweep's); its plain version,
// ops/sor3d.py::sor3d_color_sweep_block_reference, defines the function it
// computes.
//
// One full sweep is two launches on the caller's stream:
//   sor3d_color_sweep   color 0 (red),   A -> B, with the extend flag when
//                       the y boundary is 'extend';
//   sor3d_color_sweep   color 1 (black), B -> A.
// A half-sweep reads only the pre-half-sweep state (ping-pong buffers), as
// the reference sweep computes every term from the old state.
//
// The extend pre-pass is folded into the red launch, as B4 runs
// _extend_rows3d inside its sweep loop and B5 its extend_mode pre-pass
// inside the kernel: with the flag set, every state value the half-sweep
// reads (its own cell's and each neighbour's, after the wrap) goes through
// the pre-pass's map.  On interior levels 1..nz-2 row 0 reads row 1 and row
// ny-1 reads row ny-2, and with non-periodic x those rows' two end columns
// read the nearest interior column; z-edge levels read as they are.  The
// launch writes every cell, the extended rows included, so the black
// half-sweep and the next sweep see the pre-pass's values there.  It
// computes the plain version's extend-then-half-sweep from the same values
// in the same order, so it stays bit-equal.  The map costs the few rows
// that need it: a flagged launch takes it only for rows within the offsets'
// y reach of rows 0 and ny-1, in a loop of their own, and the flag is a
// template argument, so unflagged launches carry no trace of it.
//
// Arithmetic, per cell and in this order, for every cell (not only cells of
// the active color, so NaN/Inf propagate through 0*(...) exactly as in the
// plain version):
//   acc = g;  for k: acc = acc + w_k * S_in[(l+dz_k) mod nz,
//                                           (j+dy_k) mod ny, (i+dx_k) mod nx]
//   sel = ((l + j + i) & 1) == color ? 1 : 0
//   r = (rel * sel) * fac        (rel = omega*relax; fac = 1 for SOR, the
//                                 half-sweep's Chebyshev factor for cheby)
//   S_out = s + r * (acc + w0 * s)
// All three axes wrap, as torch.roll does; only cells with r == 0 read the
// wrapped values.  Built with -fmad=false, every product and sum rounds on
// its own, as the plain PyTorch ops do, so the kernels are bit-for-bit equal
// to the plain version in float and double.
//
// Bound: HBM bytes.  A half-sweep reads K+4 volumes (S, w_k, w0, g, rel) and
// writes one, about 2*(K+5)*nz*ny*nx*itemsize bytes per full sweep, at a few
// flops per byte.  The kernel does little about that bound: no
// shared-memory tiling, no temporal blocking, no FMA contraction.  x is the
// fastest thread index, so every plane is read coalesced; the z and y
// neighbours of a block hit the L2 cache that the neighbouring blocks fill.
// __launch_bounds__(256, 8) keeps 8 blocks (2048 threads) on each SM, at 32
// registers, which the flagged launch reaches only by spilling a few bytes
// (measured faster than 40 registers at 6 blocks).

#include <cuda_runtime.h>
#include <stdint.h>

#define SOR3D_MAX_K 8
#define SWEEP_BX 32
#define SWEEP_BY 8
#define MAX_GRID_YZ 65535

struct Sor3dArgs {
  int B, nz, ny, nx, K, color;
  int periodic_x;          // x wraps (the extend map's corner clamps)
  int ry;                  // the offsets' reach in y, max |dy|
  int dz[SOR3D_MAX_K];
  int dy[SOR3D_MAX_K];
  int dx[SOR3D_MAX_K];
  // element strides: between weight volumes k, and between batch slices of
  // each volume (0 for a volume shared by the whole batch)
  long long w_kstride, w_bstride, w0_bstride, g_bstride, rel_bstride;
  // the block sweep's: the buffer (py, px), its global origin (oyb, oxb) =
  // owned origin minus the ghosts, the ghosts (gy, gx), the owned extents
  // (by, bx) and the launch grid's lead (sy, sx) before the owned region
  // (last in the struct: the color sweep, which reads none of them, finds
  // its fields at the same offsets)
  int py, px, oyb, oxb, gy, gx, by, bx, sy, sx;
};

__device__ __forceinline__ int wrap(int v, int n) {
  return v < 0 ? v + n : (v >= n ? v - n : v);
}

// The extend pre-pass's map (solver._apply_extend, 3-D branch) as a read:
// (l, j, i) -> the cell whose value the pre-pass leaves at (l, j, i).  On
// interior levels 1..nz-2 rows 0 and ny-1 take rows 1 and ny-2; when x is
// not periodic their end columns take the nearest interior column.  BLOCK
// (the block sweep's): (j, i) are buffer positions and the map reads their
// global (R, C), moving inside the buffer only.
template <bool BLOCK>
__device__ __forceinline__ void extend_src(int l, int& j, int& i,
                                           const Sor3dArgs& a) {
  if constexpr (!BLOCK) {
    const int jc = min(max(j, 1), a.ny - 2);
    const bool moved = jc != j && (unsigned)(l - 1) < (unsigned)(a.nz - 2);
    const int ic = min(max(i, 1), a.nx - 2);
    j = moved ? jc : j;
    i = (moved && !a.periodic_x) ? ic : i;
  } else {
    if ((unsigned)(l - 1) >= (unsigned)(a.nz - 2)) return;
    const int R = wrap(a.oyb + j, a.ny);
    if (R != 0 && R != a.ny - 1) return;
    const int nj = j + (R == 0 ? 1 : -1);
    int ni = i;
    if (!a.periodic_x) {
      const int C = wrap(a.oxb + i, a.nx);
      ni = i + (C == 0 ? 1 : (C == a.nx - 1 ? -1 : 0));
    }
    if ((unsigned)nj < (unsigned)a.py && (unsigned)ni < (unsigned)a.px) {
      j = nj;
      i = ni;
    }
  }
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// blockIdx.z walks the (batch slice, level) pairs in steps of gridDim.z,
// so B*nz may exceed the grid's z limit.  EXT: the extend flag.
template <typename T, bool EXT>
__global__ void __launch_bounds__(SWEEP_BX * SWEEP_BY, 8)
sor3d_color_sweep_kernel(const T* __restrict__ s_in, T* __restrict__ s_out,
                         const T* __restrict__ w, const T* __restrict__ w0,
                         const T* __restrict__ g, const T* __restrict__ rel,
                         T* __restrict__ partials, Sor3dArgs a, T fac) {
  const int i = blockIdx.x * SWEEP_BX + threadIdx.x;
  const int j = blockIdx.y * SWEEP_BY + threadIdx.y;
  const long long plane = (long long)a.ny * a.nx;
  const long long vol = plane * a.nz;
  const long long n_bz = (long long)a.B * a.nz;
  __shared__ T warp_sums[SWEEP_BX * SWEEP_BY / 32];
  for (long long bz = blockIdx.z; bz < n_bz; bz += gridDim.z) {
    const long long b = bz / a.nz;
    const int l = (int)(bz - b * a.nz);
    T out = T(0);
    if (i < a.nx && j < a.ny) {
      const long long idx = l * plane + (long long)j * a.nx + i;
      const T* sb = s_in + b * vol;
      const T* wb = w + b * a.w_bstride + idx;
      T s, acc = g[b * a.g_bstride + idx];
      // only rows within the y reach of rows 0 and ny-1 (directly or
      // through the y wrap) read a row the pre-pass writes: they alone
      // take the extend map, in a loop of their own
      if (EXT && (j <= a.ry || j >= a.ny - 1 - a.ry)) {
        int sj = j, si = i;
        extend_src<false>(l, sj, si, a);
        s = sb[l * plane + (long long)sj * a.nx + si];
        for (int k = 0; k < a.K; ++k) {
          const int ll = wrap(l + a.dz[k], a.nz);
          int jj = wrap(j + a.dy[k], a.ny);
          int ii = wrap(i + a.dx[k], a.nx);
          extend_src<false>(ll, jj, ii, a);
          acc = acc + wb[k * a.w_kstride] *
                          sb[ll * plane + (long long)jj * a.nx + ii];
        }
      } else {
        s = sb[idx];
        for (int k = 0; k < a.K; ++k) {
          const int ll = wrap(l + a.dz[k], a.nz);
          const int jj = wrap(j + a.dy[k], a.ny);
          const int ii = wrap(i + a.dx[k], a.nx);
          acc = acc + wb[k * a.w_kstride] *
                          sb[ll * plane + (long long)jj * a.nx + ii];
        }
      }
      const T sel = (((l + j + i) & 1) == a.color) ? T(1) : T(0);
      const T r = (rel[b * a.rel_bstride + idx] * sel) * fac;
      out = s + r * (acc + w0[b * a.w0_bstride + idx] * s);
      s_out[b * vol + idx] = out;
    }
    if (partials != nullptr) {
      // per-block sum of |S_out| over this level's tile (out-of-range
      // threads add 0), reduced in a fixed order: warp shuffles, then the 8
      // warp sums by thread 0
      const int tid = threadIdx.y * SWEEP_BX + threadIdx.x;
      T v = warp_sum(out < T(0) ? -out : out);
      if ((tid & 31) == 0) warp_sums[tid >> 5] = v;
      __syncthreads();
      if (tid == 0) {
        T t = warp_sums[0];
        for (int q = 1; q < SWEEP_BX * SWEEP_BY / 32; ++q) t = t + warp_sums[q];
        partials[bz * gridDim.x * gridDim.y + blockIdx.y * gridDim.x +
                 blockIdx.x] = t;
      }
      __syncthreads();  // warp_sums is reused by the next level
    }
  }
}

// ---------------------------------------------------------------------------
// B5s for Hopper: sor3d_block_sweep (the TPU kernel's block arguments,
// driven by xinvert_tpu/parallel/halo_window3d.py:205 _device_step3).
//
// One half-sweep of one block of a decomposition over (y, x), held with gy
// ghost rows and gx ghost columns on each side in a (B, nz, by + 2gy,
// bx + 2gx) buffer that a ring exchange filled (wrapping on every axis, as
// torch.roll does).  z is never split.  Every cell of the buffer is
// computed and written, ghosts included: the executor runs k sweeps (2k
// launches) between exchanges, and the ghosts carry the owned cells'
// dependence cone through them (g >= 2rk, plus 1 for the extend).
// Neighbour reads wrap inside the buffer, so cells near its edge read what
// their cone lets them, and an axis without ghosts (the whole axis) wraps
// as the whole-grid launch does.  A cell's global (R, C) is its buffer
// position plus the buffer's origin (oy - gy, ox - gx), wrapped: the parity
// is (l + R + C) & 1 (B5s's parity_off: a block may start on an odd row),
// and the extend map fires on global rows 0 and ny - 1 and clamps at
// global columns 0 and nx - 1 (has_ytop/has_ybot, clamp_w/clamp_e), moving
// a read one row (and column) inside the buffer, or not at all where that
// leaves the buffer.  The launch grid starts ceil(gy/8)*8 rows and
// ceil(gx/32)*32 columns before the owned region, so its 32 x 8 tiles are
// the owned region's, and the |S| partials sum the owned cells alone, in
// the block's (B*nz, ceil(by/8), ceil(bx/32)) layout with the color
// sweep's 32-lane shuffle and then 8-row order: the whole grid's cut at the
// block where the origin is a multiple of (8, 32).  The per-cell
// arithmetic is the color sweep's, in its order.  How a CTA gets through
// the tiles:
//   - A z-march: a CTA walks a chunk of zc levels of one tile.  The state
//     planes l-1, l, l+1 of the tile plus a ring sit in shared memory, so
//     each state value leaves L2 about once a half-sweep instead of once
//     per neighbour; the K+3 weight planes of a level (w_k, g, w0, rel)
//     stream into shared memory too, each read once, coalesced.  Both go
//     by cp.async, LOOKAHEAD levels ahead of the one computed, so the
//     loads stay in flight across the level's barrier without holding
//     registers.  The launcher takes zc from the occupancy it measures:
//     about three waves of CTAs, so the scheduler balances them.
//   - Wraps once per CTA, not per read: the ring's load offsets carry the
//     buffer wrap (tiles overhanging the buffer, rings crossing its edge)
//     and each thread takes the parity of its global (R, C) once; a level
//     then reads its neighbours from the ring at fixed offsets.
//   - Tile classes, chosen on the host (ops/sor3d.py::block_plan).  In the
//     flagged (extend) launch, the tile rows that hold a cell within the
//     offsets' y reach of global rows 0 or ny-1 are edge tiles: their
//     near rows (one warp each) read through the extend map, which moves a
//     read by at most one row and column, so the flagged launch stages a
//     two-cell ring and the map is index arithmetic on it.  Every other
//     tile is lean: no map.  The unflagged instantiation has neither the
//     map nor the wider ring.
// The ring reaches one cell past a neighbour, so the launch takes offsets
// in {-1, 0, 1}^3 (every 3-D family's).  Bound and arithmetic as for the
// color sweep.
// ---------------------------------------------------------------------------

#define TILE_N (SWEEP_BX * SWEEP_BY)
#define LOOKAHEAD 3            // levels in flight while one is computed
#define W_STAGES (LOOKAHEAD + 1)
#define RING_SLOTS (LOOKAHEAD + 3)
#define MAX_EDGE_BANDS 8
#define WAVES 3                // z chunks: about this many waves of CTAs
#define MIN_ZC 4               // and at least this many levels a CTA

struct BlockPlan {
  int zc;                        // levels a CTA walks
  int tiles_x;                   // tiles a row of the launch grid
  int tile_rows;                 // tile rows of the launch grid
  int edge_rows;                 // edge tile rows (flagged launch)
  int n_edge;                    // their [lo, hi) intervals, in order
  int edge_lo[MAX_EDGE_BANDS];   // [lo, hi), in launch-grid tile rows
  int edge_hi[MAX_EDGE_BANDS];
};

__device__ __forceinline__ int pos_mod(int v, int n) {
  v %= n;
  return v < 0 ? v + n : v;
}

template <typename T>
__device__ __forceinline__ void cp_async(T* smem, const T* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  if (sizeof(T) == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
                 "l"(gmem));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                 "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Shared memory of one CTA: RING_SLOTS ring planes (the flagged launch's
// edge tiles take a two-cell ring), W_STAGES stages of K+3 planes of
// TILE_N, the warp sums.
template <typename T, bool EXT>
__host__ __device__ constexpr int ring_n() {
  return (SWEEP_BX + (EXT ? 4 : 2)) * (SWEEP_BY + (EXT ? 4 : 2));
}

template <typename T, bool EXT>
static size_t block_sweep_smem(int K) {
  return ((size_t)RING_SLOTS * ring_n<T, EXT>() +
          (size_t)W_STAGES * (K + 3) * TILE_N + TILE_N / 32) *
         sizeof(T);
}

// The tile's |S| partial of one level, in the color sweep's order; the
// caller's next barrier guards warp_sums' reuse.
template <typename T>
__device__ __forceinline__ void tile_partial(T out, bool owned, int tid,
                                             T* warp_sums, T* dst) {
  T v = owned ? out : T(0);
  v = warp_sum(v < T(0) ? -v : v);
  if ((tid & 31) == 0) warp_sums[tid >> 5] = v;
  __syncthreads();
  if (tid == 0) {
    T t = warp_sums[0];
    for (int q = 1; q < TILE_N / 32; ++q) t = t + warp_sums[q];
    *dst = t;
  }
}

template <typename T>
struct NearReads {
  T s, acc;
};

// A near row's reads (edge tiles of the flagged launch): its own value and
// the neighbour sum from acc = g on, each read through the extend map
// (extend_src) moved onto the ring: a read that moves (one row, and
// column, inside the buffer) lands on the ring's neighbouring cell.  Out
// of line, so that the lean loop keeps its registers; the offsets come
// from shared memory (dzyx: dz, dy, dx of SOR3D_MAX_K each).
template <typename T, int RING_W>
__device__ __noinline__ NearReads<T> near_reads(
    const T* rlm, const T* rl0, const T* rlp, const T* ws, T acc,
    const int* dzyx, int K, int l, int j, int i, int nz, int py, int px,
    int ny, int nx, int oyb, int oxb, int periodic_x) {
  Sor3dArgs m;  // the fields extend_src reads
  m.nz = nz; m.py = py; m.px = px; m.ny = ny; m.nx = nx;
  m.oyb = oyb; m.oxb = oxb; m.periodic_x = periodic_x;
  int sj = j, si = i;
  extend_src<true>(l, sj, si, m);
  const T s = rl0[(sj - j) * RING_W + (si - i)];
  for (int k = 0; k < K; ++k) {
    const int dz = dzyx[k], dy = dzyx[SOR3D_MAX_K + k];
    const int dx = dzyx[2 * SOR3D_MAX_K + k];
    const int ll = wrap(l + dz, nz);
    const int jj = wrap(j + dy, py);
    const int ii = wrap(i + dx, px);
    int mj = jj, mi = ii;
    extend_src<true>(ll, mj, mi, m);
    acc = acc + ws[k * TILE_N] *
                    (dz < 0 ? rlm : dz > 0 ? rlp : rl0)[(dy + mj - jj) *
                                                             RING_W +
                                                         dx + mi - ii];
  }
  return {s, acc};
}

// Stage m of a CTA's z-march (nothing past its chunk's end z1): ring
// plane m + 1 (wrapped) into its ring slot, and level m's K+3 weight
// planes at this thread's cell into its stage; one cp.async group.
template <typename T, int RING_N>
__device__ __forceinline__ void block_stage(
    int m, int z1, const Sor3dArgs& a, int plane, int cell, bool in,
    bool has1, int o0, int o1, int tid, int nw, T* ring, T* wst,
    const T* sb, const T* wb, const T* gb, const T* w0b, const T* relb) {
  if (m < z1) {
    const T* pn = sb + (m + 1 == a.nz ? 0 : m + 1) * plane;
    T* rs = ring + ((m + 1) % RING_SLOTS) * RING_N;
    cp_async(rs + tid, pn + o0);
    if (has1) cp_async(rs + tid + TILE_N, pn + o1);
    if (in) {
      const int idx = m * plane + cell;
      T* ws = wst + (m % W_STAGES) * nw * TILE_N + tid;
      for (int k = 0; k < a.K; ++k)
        cp_async(ws + k * TILE_N, wb + idx + k * a.w_kstride);
      cp_async(ws + a.K * TILE_N, gb + idx);
      cp_async(ws + (a.K + 1) * TILE_N, w0b + idx);
      cp_async(ws + (a.K + 2) * TILE_N, relb + idx);
    }
  }
  cp_async_commit();
}

// One CTA's z-march: levels [z0, z1) of the tile whose first buffer row
// and column are (r0, c0), for every batch slice.  EDGE: an edge tile of
// the flagged launch (a two-cell ring; its near rows read through the
// extend map, out of line); else a lean tile (a one-cell ring, no map),
// the same code in both launches.
template <typename T, int RING_N, bool EDGE>
__device__ __forceinline__ void z_march(
    const T* __restrict__ s_in, T* __restrict__ s_out,
    const T* __restrict__ w, const T* __restrict__ w0,
    const T* __restrict__ g, const T* __restrict__ rel,
    T* __restrict__ partials, const Sor3dArgs& a, T fac, T* ring, T* wst,
    T* warp_sums, const int* dzyx, int r0, int c0, int z0, int z1, int pyb,
    int pxb) {
  constexpr int RW = EDGE ? 2 : 1;             // the ring's width
  constexpr int RING_W = SWEEP_BX + 2 * RW;
  const int nw = a.K + 3;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * SWEEP_BX + tx;
  const int j = r0 + ty, i = c0 + tx;
  const bool in = (unsigned)j < (unsigned)a.py && (unsigned)i < (unsigned)a.px;
  const bool owned = (unsigned)(j - a.gy) < (unsigned)a.by &&
                     (unsigned)(i - a.gx) < (unsigned)a.bx;
  const int nby = (a.by + SWEEP_BY - 1) / SWEEP_BY;
  const int nbx = (a.bx + SWEEP_BX - 1) / SWEEP_BX;
  const bool part_tile = partials != nullptr && (unsigned)pyb < (unsigned)nby &&
                         (unsigned)pxb < (unsigned)nbx;
  // a slice holds fewer than 2^31 cells (the launcher checks)
  const int plane = a.py * a.px;
  const long long vol = (long long)plane * a.nz;
  const int cell = j * a.px + i;
  // per CTA, once: the parity of the cell's global (R, C); in an edge
  // tile, whether its row is within the y reach of row 0 or ny - 1; the
  // ring cells this thread loads (tid, and tid + TILE_N while inside the
  // ring), wrapped into the buffer
  const int R = pos_mod(a.oyb + j, a.ny);
  const int par = (R + pos_mod(a.oxb + i, a.nx)) & 1;
  const bool near = EDGE && (R <= a.ry || R >= a.ny - 1 - a.ry);
  const bool has1 = tid + TILE_N < RING_W * (SWEEP_BY + 2 * RW);
  const int o0 = pos_mod(r0 - RW + tid / RING_W, a.py) * a.px +
                 pos_mod(c0 - RW + tid % RING_W, a.px);
  const int o1 =
      has1 ? pos_mod(r0 - RW + (tid + TILE_N) / RING_W, a.py) * a.px +
                 pos_mod(c0 - RW + (tid + TILE_N) % RING_W, a.px)
           : 0;
  const int center = (ty + RW) * RING_W + tx + RW;
  for (long long b = blockIdx.y; b < a.B; b += gridDim.y) {
    const T* sb = s_in + b * vol;
    T* ob = s_out + b * vol;
    const T* wb = w + b * a.w_bstride;
    const T* w0b = w0 + b * a.w0_bstride;
    const T* gb = g + b * a.g_bstride;
    const T* relb = rel + b * a.rel_bstride;
    T* pdst = part_tile ? partials + (b * a.nz * nby + pyb) * nbx + pxb
                        : nullptr;
#define STAGE(m)                                                            \
  block_stage<T, RING_N>(m, z1, a, plane, cell, in, has1, o0, o1, tid, nw,  \
                         ring, wst, sb, wb, gb, w0b, relb)
    {  // the prologue: planes z0 - 1 (wrapped) and z0, then the stages
      const T* pm = sb + (z0 == 0 ? a.nz - 1 : z0 - 1) * plane;
      const T* p0 = sb + z0 * plane;
      T* sm = ring + ((z0 + RING_SLOTS - 1) % RING_SLOTS) * RING_N;
      T* s0 = ring + (z0 % RING_SLOTS) * RING_N;
      cp_async(sm + tid, pm + o0);
      cp_async(s0 + tid, p0 + o0);
      if (has1) {
        cp_async(sm + tid + TILE_N, pm + o1);
        cp_async(s0 + tid + TILE_N, p0 + o1);
      }
      cp_async_commit();
#pragma unroll
      for (int m = 0; m < LOOKAHEAD; ++m) STAGE(z0 + m);
    }
    for (int l = z0; l < z1; ++l) {
      cp_async_wait<LOOKAHEAD - 1>();  // this thread's stage l has landed
      __syncthreads();  // everyone's has, and level l - 1 is done
      STAGE(l + LOOKAHEAD);  // into the buffers level l - 1 used
      T out = T(0);
      if (in) {
        const T* ws = wst + (l % W_STAGES) * nw * TILE_N + tid;
        // planes l - 1, l, l + 1 at this thread's cell
        const T* rlm =
            ring + ((l + RING_SLOTS - 1) % RING_SLOTS) * RING_N + center;
        const T* rl0 = ring + (l % RING_SLOTS) * RING_N + center;
        const T* rlp = ring + ((l + 1) % RING_SLOTS) * RING_N + center;
        T s, acc = ws[a.K * TILE_N];
        if (!near) {
          s = rl0[0];
#pragma unroll
          for (int k = 0; k < SOR3D_MAX_K; ++k)
            if (k < a.K)
              acc = acc + ws[k * TILE_N] *
                              (a.dz[k] < 0 ? rlm : a.dz[k] > 0 ? rlp : rl0)
                                  [a.dy[k] * RING_W + a.dx[k]];
        } else {
          const NearReads<T> v = near_reads<T, RING_W>(
              rlm, rl0, rlp, ws, acc, dzyx, a.K, l, j, i, a.nz, a.py, a.px,
              a.ny, a.nx, a.oyb, a.oxb, a.periodic_x);
          s = v.s;
          acc = v.acc;
        }
        const T sel = (((l + par) & 1) == a.color) ? T(1) : T(0);
        const T r = (ws[(a.K + 2) * TILE_N] * sel) * fac;
        out = s + r * (acc + ws[(a.K + 1) * TILE_N] * s);
        ob[l * plane + cell] = out;
      }
      if (part_tile)
        tile_partial(out, owned, tid, warp_sums,
                     pdst + (long long)l * nby * nbx);
    }
    cp_async_wait<0>();
    __syncthreads();  // the ring and the stages serve the next slice
#undef STAGE
  }
}

// blockIdx.x: (tile, z chunk), the edge tiles' first; blockIdx.y walks the
// batch slices in steps of gridDim.y.  Four CTAs an SM in float (64
// registers; shared memory allows four); in double shared memory allows
// two, so the registers may go to 128.
template <typename T, bool EXT>
__global__ void __launch_bounds__(TILE_N, sizeof(T) == 8 ? 2 : 4)
sor3d_block_sweep_kernel(const T* __restrict__ s_in, T* __restrict__ s_out,
                         const T* __restrict__ w, const T* __restrict__ w0,
                         const T* __restrict__ g, const T* __restrict__ rel,
                         T* __restrict__ partials, Sor3dArgs a, BlockPlan p,
                         T fac) {
  constexpr int RING_N = ring_n<T, EXT>();      // a ring slot's cells
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);
  T* wst = ring + RING_SLOTS * RING_N;
  T* warp_sums = wst + W_STAGES * (a.K + 3) * TILE_N;
  // which tile and chunk: the edge tiles' CTAs first (so that their
  // slower rows are not the launch's tail), then the lean tiles'; x
  // fastest, then the tile row, then the chunk
  const int nzc = (a.nz + p.zc - 1) / p.zc;
  const int edge_ctas = EXT ? p.edge_rows * p.tiles_x * nzc : 0;
  const bool edge = EXT && (int)blockIdx.x < edge_ctas;
  const int id = (int)blockIdx.x - (edge ? 0 : edge_ctas);
  const int rows = edge ? p.edge_rows : p.tile_rows - (EXT ? p.edge_rows : 0);
  const int col = id % p.tiles_x;
  int row = id / p.tiles_x % rows;
  const int z0 = id / p.tiles_x / rows * p.zc;
  const int z1 = min(z0 + p.zc, a.nz);
  if (EXT) {
    // the row-th edge row, or the row-th row outside the edge intervals
    // (the intervals are in order); constant indices keep p in registers
    bool found = false;
#pragma unroll
    for (int e = 0; e < MAX_EDGE_BANDS; ++e) {
      if (e < p.n_edge && !found) {
        const int n = p.edge_hi[e] - p.edge_lo[e];
        if (edge) {
          found = row < n;
          row = found ? p.edge_lo[e] + row : row - n;
        } else if (row >= p.edge_lo[e]) {
          row += n;
        }
      }
    }
  }
  // the tile's first buffer row and column (the grid starts (sy, sx)
  // before the owned region), and its place among the partials
  const int r0 = row * SWEEP_BY - (a.sy - a.gy);
  const int c0 = col * SWEEP_BX - (a.sx - a.gx);
  const int pyb = row - a.sy / SWEEP_BY;
  const int pxb = col - a.sx / SWEEP_BX;
  // near_reads takes the offsets from shared memory: indexing the launch
  // arguments' arrays by a run-time k would copy them to local memory for
  // every thread (the first level's barrier orders this)
  __shared__ int dzyx[3 * SOR3D_MAX_K];
  if (EXT && edge && threadIdx.x == 0 && threadIdx.y == 0) {
#pragma unroll
    for (int k = 0; k < SOR3D_MAX_K; ++k) {
      dzyx[k] = a.dz[k];
      dzyx[SOR3D_MAX_K + k] = a.dy[k];
      dzyx[2 * SOR3D_MAX_K + k] = a.dx[k];
    }
  }
  if (EXT && edge)
    z_march<T, RING_N, true>(s_in, s_out, w, w0, g, rel, partials, a, fac,
                             ring, wst, warp_sums, dzyx, r0, c0, z0, z1,
                             pyb, pxb);
  else
    z_march<T, RING_N, false>(s_in, s_out, w, w0, g, rel, partials, a, fac,
                              ring, wst, warp_sums, dzyx, r0, c0, z0, z1,
                              pyb, pxb);
}

// One axis of a block: owned [o, o + b) of the global n with g ghosts on
// each side; an axis without ghosts is the whole axis.
static bool block_axis_ok(int o, int b, int g, int n) {
  if (b < 1 || o < 0 || o + b > n || g < 0) return false;
  return g == 0 ? (o == 0 && b == n) : g < n;
}

template <typename T>
static int launch_color_sweep(const T* s_in, T* s_out, const T* w,
                              const T* w0, const T* g, const T* rel,
                              T* partials, int B, int nz, int ny, int nx,
                              int K, const int* dz, const int* dy,
                              const int* dx, long long w_kstride,
                              long long w_bstride, long long w0_bstride,
                              long long g_bstride, long long rel_bstride,
                              int color, int extend, int periodic_x,
                              double fac, void* stream) {
  if (K < 0 || K > SOR3D_MAX_K || B < 1 || nz < 1 || ny < 1 || nx < 1 ||
      (color != 0 && color != 1) || (extend && (nz < 3 || ny < 3 || nx < 3)))
    return (int)cudaErrorInvalidValue;
  const long long gx = (nx + SWEEP_BX - 1) / SWEEP_BX;
  const long long gy = (ny + SWEEP_BY - 1) / SWEEP_BY;
  if (gy > MAX_GRID_YZ) return (int)cudaErrorInvalidValue;
  Sor3dArgs a = {};
  a.B = B; a.nz = nz; a.ny = ny; a.nx = nx; a.K = K; a.color = color;
  a.periodic_x = periodic_x != 0;
  a.ry = 0;
  for (int k = 0; k < SOR3D_MAX_K; ++k) {
    a.dz[k] = k < K ? dz[k] : 0;
    a.dy[k] = k < K ? dy[k] : 0;
    a.dx[k] = k < K ? dx[k] : 0;
    const int r = a.dy[k] < 0 ? -a.dy[k] : a.dy[k];
    if (r > a.ry) a.ry = r;
  }
  a.w_kstride = w_kstride; a.w_bstride = w_bstride;
  a.w0_bstride = w0_bstride; a.g_bstride = g_bstride;
  a.rel_bstride = rel_bstride;
  const long long n_bz = (long long)B * nz;
  dim3 block(SWEEP_BX, SWEEP_BY, 1);
  dim3 grid((unsigned)gx, (unsigned)gy,
            (unsigned)(n_bz < MAX_GRID_YZ ? n_bz : MAX_GRID_YZ));
  cudaStream_t st = (cudaStream_t)stream;
  // the caller computed fac in T, so the conversion back is exact
  if (extend)
    sor3d_color_sweep_kernel<T, true><<<grid, block, 0, st>>>(
        s_in, s_out, w, w0, g, rel, partials, a, (T)fac);
  else
    sor3d_color_sweep_kernel<T, false><<<grid, block, 0, st>>>(
        s_in, s_out, w, w0, g, rel, partials, a, (T)fac);
  return (int)cudaGetLastError();
}

// The block sweep (sor3d_block_sweep): `blk` (oy, ox, by, bx, gy, gx), zc
// levels a CTA (<= 0: the launcher's choice), `edge` the n_edge [lo, hi)
// tile-row intervals of the flagged launch's edge tiles.
template <typename T>
static int launch_block_sweep(const T* s_in, T* s_out, const T* w,
                              const T* w0, const T* g, const T* rel,
                              T* partials, int B, int nz, int ny, int nx,
                              const int* blk, int K, const int* dz,
                              const int* dy, const int* dx,
                              long long w_kstride, long long w_bstride,
                              long long w0_bstride, long long g_bstride,
                              long long rel_bstride, int color, int extend,
                              int periodic_x, double fac, int zc,
                              const int* edge, int n_edge, void* stream) {
  if (K < 0 || K > SOR3D_MAX_K || B < 1 || nz < 1 || ny < 1 || nx < 1 ||
      (color != 0 && color != 1) || (extend && (nz < 3 || ny < 3 || nx < 3)) ||
      n_edge < 0 || n_edge > MAX_EDGE_BANDS)
    return (int)cudaErrorInvalidValue;
  if (!block_axis_ok(blk[0], blk[2], blk[4], ny) ||
      !block_axis_ok(blk[1], blk[3], blk[5], nx))
    return (int)cudaErrorInvalidValue;
  Sor3dArgs a;
  a.by = blk[2]; a.bx = blk[3]; a.gy = blk[4]; a.gx = blk[5];
  a.py = a.by + 2 * a.gy; a.px = a.bx + 2 * a.gx;
  a.oyb = blk[0] - a.gy; a.oxb = blk[1] - a.gx;
  a.sy = (a.gy + SWEEP_BY - 1) / SWEEP_BY * SWEEP_BY;
  a.sx = (a.gx + SWEEP_BX - 1) / SWEEP_BX * SWEEP_BX;
  if ((long long)a.py * a.px * nz >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const long long gx = (a.sx + a.bx + a.gx + SWEEP_BX - 1) / SWEEP_BX;
  const long long gy = (a.sy + a.by + a.gy + SWEEP_BY - 1) / SWEEP_BY;
  if (gy > MAX_GRID_YZ) return (int)cudaErrorInvalidValue;
  a.B = B; a.nz = nz; a.ny = ny; a.nx = nx; a.K = K; a.color = color;
  a.periodic_x = periodic_x != 0;
  a.ry = 0;
  for (int k = 0; k < SOR3D_MAX_K; ++k) {
    a.dz[k] = k < K ? dz[k] : 0;
    a.dy[k] = k < K ? dy[k] : 0;
    a.dx[k] = k < K ? dx[k] : 0;
    // the ring holds the neighbours one cell away
    if (a.dz[k] < -1 || a.dz[k] > 1 || a.dy[k] < -1 || a.dy[k] > 1 ||
        a.dx[k] < -1 || a.dx[k] > 1)
      return (int)cudaErrorInvalidValue;
    const int r = a.dy[k] < 0 ? -a.dy[k] : a.dy[k];
    if (r > a.ry) a.ry = r;
  }
  a.w_kstride = w_kstride; a.w_bstride = w_bstride;
  a.w0_bstride = w0_bstride; a.g_bstride = g_bstride;
  a.rel_bstride = rel_bstride;
  // the launch grid's tiles (header), each walked in chunks of
  // zc levels; zc <= 0: about WAVES waves of CTAs at the occupancy this
  // card gives the kernel (the scheduler then balances them), each CTA
  // walking at least MIN_ZC levels (its pipeline's fill is paid once a
  // chunk)
  BlockPlan p;
  p.tiles_x = (int)gx;
  p.tile_rows = (int)gy;
  p.n_edge = extend ? n_edge : 0;
  p.edge_rows = 0;
  for (int e = 0; e < MAX_EDGE_BANDS; ++e) {
    p.edge_lo[e] = e < p.n_edge ? edge[2 * e] : 0;
    p.edge_hi[e] = e < p.n_edge ? edge[2 * e + 1] : 0;
    if (e < p.n_edge) {
      if (p.edge_lo[e] < (e ? p.edge_hi[e - 1] : 0) ||
          p.edge_hi[e] <= p.edge_lo[e] || p.edge_hi[e] > p.tile_rows)
        return (int)cudaErrorInvalidValue;
      p.edge_rows += p.edge_hi[e] - p.edge_lo[e];
    }
  }
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev > 63)
    return (int)cudaErrorInvalidDevice;
  const size_t smem = extend ? block_sweep_smem<T, true>(K)
                             : block_sweep_smem<T, false>(K);
  const long long tiles = gx * gy;
  const int B_grid = B < MAX_GRID_YZ ? B : MAX_GRID_YZ;
  int per_sm = 0, sms = 0;
#define BLOCK_SWEEP_SETUP(E)                                                \
  do {                                                                      \
    static unsigned long long sized = 0; /* the most smem, once a card */   \
    if (!((sized >> dev) & 1ULL)) {                                         \
      const cudaError_t e = cudaFuncSetAttribute(                           \
          sor3d_block_sweep_kernel<T, E>,                                   \
          cudaFuncAttributeMaxDynamicSharedMemorySize,                      \
          (int)block_sweep_smem<T, E>(SOR3D_MAX_K));                        \
      if (e != cudaSuccess) return (int)e;                                  \
      sized |= 1ULL << dev;                                                 \
    }                                                                       \
    static int occ[64][SOR3D_MAX_K + 1]; /* CTAs an SM, a card and K */    \
    static int sm_count[64];                                                \
    if (zc <= 0 && occ[dev][K] == 0) {                                      \
      cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(        \
          &occ[dev][K], sor3d_block_sweep_kernel<T, E>, TILE_N, smem);      \
      if (e == cudaSuccess)                                                 \
        e = cudaDeviceGetAttribute(&sm_count[dev],                          \
                                   cudaDevAttrMultiProcessorCount, dev);    \
      if (e != cudaSuccess) return (int)e;                                  \
    }                                                                       \
    per_sm = occ[dev][K];                                                   \
    sms = sm_count[dev];                                                    \
  } while (0)
  if (extend) BLOCK_SWEEP_SETUP(true); else BLOCK_SWEEP_SETUP(false);
#undef BLOCK_SWEEP_SETUP
  if (zc <= 0) {
    const long long slots = (long long)(per_sm > 0 ? per_sm : 1) * sms;
    long long chunks = (WAVES * slots + tiles * B_grid / 2) / (tiles * B_grid);
    chunks = chunks < 1 ? 1 : (chunks > nz ? nz : chunks);
    zc = (int)((nz + chunks - 1) / chunks);
    zc = zc < MIN_ZC ? (nz < MIN_ZC ? nz : MIN_ZC) : zc;
  }
  p.zc = zc;
  const long long ctas = tiles * ((nz + zc - 1) / zc);
  if (ctas > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  dim3 block(SWEEP_BX, SWEEP_BY, 1);
  dim3 grid((unsigned)ctas, (unsigned)B_grid, 1);
  cudaStream_t st = (cudaStream_t)stream;
  if (extend)
    sor3d_block_sweep_kernel<T, true><<<grid, block, smem, st>>>(
        s_in, s_out, w, w0, g, rel, partials, a, p, (T)fac);
  else
    sor3d_block_sweep_kernel<T, false><<<grid, block, smem, st>>>(
        s_in, s_out, w, w0, g, rel, partials, a, p, (T)fac);
  return (int)cudaGetLastError();
}

extern "C" {

// Number of |S| partials a color sweep writes per batch slice (one a
// 32 x 8 block and level).
int sor3d_partials_per_slice(int nz, int ny, int nx) {
  return nz * ((nx + SWEEP_BX - 1) / SWEEP_BX) *
         ((ny + SWEEP_BY - 1) / SWEEP_BY);
}

int sor3d_color_sweep_f32(const float* s_in, float* s_out, const float* w,
                          const float* w0, const float* g, const float* rel,
                          float* partials, int B, int nz, int ny, int nx,
                          int K, const int* dz, const int* dy, const int* dx,
                          long long w_kstride, long long w_bstride,
                          long long w0_bstride, long long g_bstride,
                          long long rel_bstride, int color, int extend,
                          int periodic_x, double fac, void* stream) {
  return launch_color_sweep<float>(s_in, s_out, w, w0, g, rel, partials, B,
                                   nz, ny, nx, K, dz, dy, dx, w_kstride,
                                   w_bstride, w0_bstride, g_bstride,
                                   rel_bstride, color, extend, periodic_x,
                                   fac, stream);
}

int sor3d_color_sweep_f64(const double* s_in, double* s_out, const double* w,
                          const double* w0, const double* g,
                          const double* rel, double* partials, int B, int nz,
                          int ny, int nx, int K, const int* dz, const int* dy,
                          const int* dx, long long w_kstride,
                          long long w_bstride, long long w0_bstride,
                          long long g_bstride, long long rel_bstride,
                          int color, int extend, int periodic_x, double fac,
                          void* stream) {
  return launch_color_sweep<double>(s_in, s_out, w, w0, g, rel, partials, B,
                                    nz, ny, nx, K, dz, dy, dx, w_kstride,
                                    w_bstride, w0_bstride, g_bstride,
                                    rel_bstride, color, extend, periodic_x,
                                    fac, stream);
}

// B5s: one half-sweep of one ghost-padded block (the block sweep's
// header): the buffer is (B, nz, by + 2gy, bx + 2gx), (ny, nx) the whole
// grid, (oy, ox) the owned region's global origin; zc levels a CTA (<= 0:
// the launcher's choice) and the edge tile-row intervals.
int sor3d_block_sweep_f32(const float* s_in, float* s_out, const float* w,
                          const float* w0, const float* g, const float* rel,
                          float* partials, int B, int nz, int ny, int nx,
                          int oy, int ox, int by, int bx, int gy, int gx,
                          int K, const int* dz, const int* dy, const int* dx,
                          long long w_kstride, long long w_bstride,
                          long long w0_bstride, long long g_bstride,
                          long long rel_bstride, int color, int extend,
                          int periodic_x, double fac, int zc,
                          const int* edge, int n_edge, void* stream) {
  const int blk[6] = {oy, ox, by, bx, gy, gx};
  return launch_block_sweep<float>(s_in, s_out, w, w0, g, rel, partials, B,
                                   nz, ny, nx, blk, K, dz, dy, dx, w_kstride,
                                   w_bstride, w0_bstride, g_bstride,
                                   rel_bstride, color, extend, periodic_x,
                                   fac, zc, edge, n_edge, stream);
}

int sor3d_block_sweep_f64(const double* s_in, double* s_out, const double* w,
                          const double* w0, const double* g,
                          const double* rel, double* partials, int B, int nz,
                          int ny, int nx, int oy, int ox, int by, int bx,
                          int gy, int gx, int K, const int* dz, const int* dy,
                          const int* dx, long long w_kstride,
                          long long w_bstride, long long w0_bstride,
                          long long g_bstride, long long rel_bstride,
                          int color, int extend, int periodic_x, double fac,
                          int zc, const int* edge, int n_edge, void* stream) {
  const int blk[6] = {oy, ox, by, bx, gy, gx};
  return launch_block_sweep<double>(s_in, s_out, w, w0, g, rel, partials, B,
                                    nz, ny, nx, blk, K, dz, dy, dx,
                                    w_kstride, w_bstride, w0_bstride,
                                    g_bstride, rel_bstride, color, extend,
                                    periodic_x, fac, zc, edge, n_edge,
                                    stream);
}

}  // extern "C"
