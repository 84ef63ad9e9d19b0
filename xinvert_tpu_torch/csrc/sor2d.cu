// Red-black SOR sweeps of a 2-D stencil, hand-written for Hopper (sm_90a).
//
// Replaces the three TPU kernels of the 2-D paths:
//   - xinvert_tpu/ops/pallas_sor.py::_kernel (+ _extend_rows), the
//     VMEM-resident multi-sweep kernel for grids that fit on the TPU core;
//   - xinvert_tpu/ops/pallas_sor_window.py::_kernel (+ _extend_windowed),
//     the row-windowed kernel for larger grids, with its fused |S| partials
//     (with_norm) for checked solves and its per-half-sweep Chebyshev
//     factors (fac);
//   - xinvert_tpu/ops/pallas_sor_window.py::_kernel_inplace, B2's function
//     for radius-1 stencils without cross terms, updating one buffer in
//     place (the tiled kernel's in-place instantiations).
// On Hopper the VMEM split between the first two has no meaning, so one
// design serves every 2-D shape, in three kernels:
//   - sor2d_sweeps_resident (at the end of this file), where a whole slice
//     fits one SM and the stencil has radius 1 without cross terms: every
//     slice held in shared memory through a check window of sweeps a
//     launch;
//   - sor2d_sweeps_tiled, and sor2d_sweeps_tiled_inplace for B3's specs,
//     in every other case: k full sweeps per launch on a window held in
//     shared memory, the extend pre-pass folded in;
//   - sor2d_sweeps_block (B2s): the ping-pong tiled kernel on one
//     ghost-padded block of a decomposition, B2's sharded-block variants
//     (pad_lo, has_top/has_bot, pad_x, clamp_w/clamp_e, ext_bot) read from
//     global coordinates (the block mode, after the tiled kernel's header).
//
// Arithmetic, per cell and in this order, every term from the state before
// the half-sweep:
//   acc = g;  for k: acc = acc + w_k * S[(j+dy_k) mod ny, (i+dx_k) mod nx]
//   sel = ((j + i) & 1) == color ? 1 : 0
//   r = (rel * sel) * fac        (rel = omega*relax; fac = 1 for SOR, the
//                                 half-sweep's Chebyshev factor for cheby)
//   S' = s + r * (acc + w0 * s)
// The plain version (solver._half_sweep) computes it for every cell, so
// NaN/Inf propagate through 0*(...); a kernel that computes the active
// color alone says why it gives the same.  Built with -fmad=false, every
// product and sum rounds on its own, as the plain PyTorch ops do, so the
// kernels are bit-for-bit equal to the plain version in float and double.
//
// The fused |S| partials: one a 32 x 8 block of the grid and slice
// (sor2d_partials_per_slice), each summed in one order, the warp's shuffle
// tree over a row of 32 cells, then the 8 row sums in turn
// (ops/sor2d.py::block_partials replays it), so a checked solve's norms,
// and so its stops, do not depend on the kernel that ran.

#include <cuda_runtime.h>
#include <stdint.h>

#define SOR2D_MAX_K 16
#define SWEEP_BX 32
#define SWEEP_BY 8

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// s + ((rel * sel) * fac) * (acc + w0 * s): the update of the header from
// the neighbour sum acc = g + sum_k w_k * s_k.  Every kernel of this file
// ends a cell's update here, so their arithmetic is one and the same.
template <typename T>
__device__ __forceinline__ T relax_cell(T s, T acc, T w0, T rel, T sel,
                                        T fac) {
  const T r = (rel * sel) * fac;
  return s + r * (acc + w0 * s);
}

// ---------------------------------------------------------------------------
// The tiled kernels: k full sweeps per launch (B2's design on Hopper).
//
// A block owns a ty x tx tile of the grid and walks a group of batch slices.
// For each slice it loads a (ty + 2hy) x (tx + 2hx) window into shared
// memory, runs k sweeps on it (the extend pre-pass, red, black; every term
// from the pre-half-sweep state, as above) and writes back only its tile.
// Each half-sweep reads radius r cells away, so a cell's value after k
// sweeps depends on cells up to 2rk rows and columns away; the extend adds
// up to 2 more, once, where its copied rows sit between a tile and the edge
// of its window (e = 1, or 2 for the biharmonic's two rings).  With
// h >= 2rk + e the owned cells come out exact, whatever the cells near the
// window's edge hold.
//
// Windows are loaded with modular global indices on both axes, as the plain
// version rolls every axis: the top tile's window holds rows ny-hy..ny-1
// above row 0, exactly as torch.roll sees them, so the wrapped reads of the
// boundary lines (relax 0, but NaN passes through 0*x) match the plain
// version even on a state that holds a NaN.  A window wider than an axis
// holds some cells twice; each copy evolves alike and each owned cell is
// written once.  Parity is the global (j + i) & 1, whatever the tile origin.
//
// The extend pre-pass runs before red in every sweep, in the blocks whose
// window holds a row it writes (edge tiles only): every window cell whose
// global row is a written row takes its source cell's value (read all, sync,
// write), in solver._apply_extend's order; a source outside the window
// belongs to a cell outside the valid cone and is skipped.
//
// Registers hold the coefficients: each thread owns CPT window cells (cell
// c = tid + j * NT, row-major), with their w_k, w0, g and rel; where the
// plan's table says so (16 offsets, or 8 in float64) the w_k planes live in
// shared memory instead, so a window keeps its size.  A window of 4096
// cells in float32 (2048 with 8 offsets, and in float64) fills an SM's
// registers, so one block runs per SM.  A block walks a group of batch
// slices of its tile, and a plane the batch shares stays in registers from
// one slice to the next.  The state buffers are padded by r cells on every
// side so edge reads stay in the buffer (the pad is zero and never
// written).  The ping-pong kernel keeps two buffers and computes every
// window cell in each half-sweep (s + 0*(...) for the other color, as the
// plain version); the in-place kernel keeps one and computes the active
// color only, as B3 does (radius-1 stencils without cross terms, even
// periodic sizes: every neighbour of an active cell has the other color,
// and a non-periodic axis wraps only between its two boundary lines, which
// the sweep never updates).  Its inactive cells keep their value, which is
// what the plain version gives them wherever their update term is finite;
// on a state that already holds a NaN or an Inf the two may differ in which
// inactive cells turn NaN, and the norm is then non-finite on both paths,
// so the solve stops on overflow at the same check.
//
// The owned tile is written back in rows of 32 cells, with the fused |S|
// partials of its 32 x 8 blocks (header); tiles hold whole blocks (ty a
// multiple of 8, tx of 32, or one tile along the axis).
//
// Bound: device-memory bytes per launch, (K+4) planes read and one written
// per cell, over k sweeps.  What the design pays for that: the window
// overhead (window over tile area) and K+2 shared-memory accesses per cell
// and half-sweep.  Measured (NVIDIA H100 80GB HBM3, 700.00 W; chip_smoke.py
// phase 4): a launch costs a fixed part about twice its windows' bytes at
// the HBM rate plus a part per sweep, and the two do not overlap, since one
// block fills an SM.
// ---------------------------------------------------------------------------

// The block mode (B2s, sor2d_sweeps_block; xinvert_tpu/parallel/
// halo_window.py:292 _device_step drives B2 with its block arguments).  The
// state and the planes are one block of a decomposition, padded with gy
// ghost rows and gx ghost columns on each side that a ring exchange filled
// (wrapping on every axis, as torch.roll does); the tiles cover the owned
// by x bx cells only, and the launch writes those only, into the owned
// region of s_out's buffer.  What the TPU kernel encodes in pad_lo,
// has_top/has_bot, pad_x, clamp_w/clamp_e and ext_bot comes from global
// coordinates here: a window cell's global (R, C) is its buffer position
// plus the buffer's origin (oy - gy, ox - gx), wrapped, and the parity, the
// extend pre-pass and its corner clamps read (R, C) alone, so they fire at
// the true domain edges in whichever block holds them, ghosts included.
// Buffer and global coordinates part only where a window is loaded (the
// buffer row, the plane index) and where the owned tile is written back.
// With g >= h (the halo of k sweeps, extend included) every window lies in
// the buffer and the owned cells come out as the whole grid's, bit for bit.
// The |S| partials cover the owned cells in the block's own (by/8, bx/32)
// layout; from an origin on a multiple of (8, 32) that is the whole grid's
// layout cut at the block.  An axis with no ghosts is the whole axis
// (oy = 0, by = ny): its windows wrap inside the buffer.  The mode is a
// template flag (BLOCK), so the whole-grid instantiations carry none of
// its address arithmetic.

#define TILED_MAX_SWEEPS 8

// Mirrored field by field by ops/sor2d.py::_TiledParams (ctypes).
struct TiledParams {
  int B, ny, nx, K, nsweeps;
  int ty, tx, hy, hx, winy, winx, pad;  // tile, halo, window, pad ring
  int tiles_y, tiles_x, spb;            // spb: slices each block walks
  int extend, periodic_x, bih;
  int kmax, cpt, nt, inplace, wsmem;    // the instantiation
  // the block mode (sor2d_sweeps_block): the owned region's global origin
  // (oy, ox) and extent (by, bx), its ghost widths (gy, gx) and the buffer
  // (buf_y, buf_x) = (by + 2gy, bx + 2gx) the state and planes live in.
  // The whole grid is oy = ox = gy = gx = 0, (by, bx) = (buf_y, buf_x) =
  // (ny, nx), which sor2d_sweeps_tiled sets whatever it is given.
  int oy, ox, by, bx, gy, gx, buf_y, buf_x;
  int dy[SOR2D_MAX_K];
  int dx[SOR2D_MAX_K];
  long long w_kstride, w_bstride, w0_bstride, g_bstride, rel_bstride;
  double fac[2 * TILED_MAX_SWEEPS];     // per half-sweep; exact in T
};

struct TiledArgs {
  TiledParams p;
  int stride;                 // padded row stride of a shared buffer
  int soff[SOR2D_MAX_K];      // neighbour offsets in a shared buffer
};

__device__ __forceinline__ int pos_mod(int v, int n) {
  v %= n;
  return v < 0 ? v + n : v;
}

// Source of the extend pre-pass for global cell (R, C), as an offset
// (dr, dc); false when the pre-pass does not write the cell.
__device__ __forceinline__ bool extend_source(int R, int C, int ny, int nx,
                                              int periodic_x, int bih,
                                              int* dr, int* dc) {
  if (!bih) {
    if (R != 0 && R != ny - 1) return false;
    *dr = R == 0 ? 1 : -1;
    *dc = 0;
    if (!periodic_x) *dc = C == 0 ? 1 : (C == nx - 1 ? -1 : 0);
    return true;
  }
  // rows 0, 1 copy old row 1 and row 2; rows ny-2, ny-1 copy row ny-3; with
  // a non-periodic x the columns clamp to 2..nx-3
  if (R == 0) *dr = periodic_x ? 1 : 2;
  else if (R == 1) *dr = 1;
  else if (R == ny - 2) *dr = -1;
  else if (R == ny - 1) *dr = -2;
  else return false;
  *dc = periodic_x ? 0 : (C < 2 ? 2 - C : (C >= nx - 2 ? nx - 3 - C : 0));
  return true;
}

template <typename T, int KMAX, int CPT, int NT, bool INPLACE, bool WS,
          bool BLOCK>
__global__ void __launch_bounds__(NT, 1)
sor2d_sweeps_tiled_kernel(const T* __restrict__ s_in, T* __restrict__ s_out,
                          const T* __restrict__ w, const T* __restrict__ w0,
                          const T* __restrict__ g, const T* __restrict__ rel,
                          T* __restrict__ partials, const TiledArgs a) {
  // the weight planes in registers, or (WS) in shared memory after the
  // state buffers, as wsm[k * cells + c]
  constexpr int KR = WS ? 1 : KMAX;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const sm = reinterpret_cast<T*>(smem_raw);
  const TiledParams& p = a.p;
  const int tid = threadIdx.x;
  const int buf_cells = (p.winy + 2 * p.pad) * a.stride;
  const int cells = p.winy * p.winx;
  T* const wsm = sm + (INPLACE ? 1 : 2) * buf_cells;
  T* const rowsum = wsm + (WS ? p.K * cells : 0);   // 8 per 32 x 8 block
  // the tile's origin in the owned region, its window's global origin (not
  // wrapped: it may lie before row 0 or run past ny - 1)
  const int ty0 = blockIdx.y * p.ty, tx0 = blockIdx.x * p.tx;
  const int wy0 = (BLOCK ? p.oy : 0) + ty0 - p.hy;
  const int wx0 = (BLOCK ? p.ox : 0) + tx0 - p.hx;
  const long long plane = BLOCK ? (long long)p.buf_y * p.buf_x
                                : (long long)p.ny * p.nx;

  // the thread's cells: shared index, index in the buffer (the plane),
  // global parity.  A window cell at global (wy0 + l, wx0 + m) is the
  // global cell (R, C), wrapped on both axes; in the block mode it sits at
  // buffer row wy0 + l - (oy - gy), which the ghosts keep inside the
  // buffer (gy >= hy), or, on an axis without ghosts (the buffer is the
  // whole axis), at R itself.
  int sidx[CPT], gidx[CPT];
  unsigned live = 0u, par = 0u;
#pragma unroll
  for (int j = 0; j < CPT; ++j) {
    const int c = tid + j * NT;
    sidx[j] = 0;
    gidx[j] = 0;
    if (c < cells) {
      const int l = c / p.winx, m = c - l * p.winx;
      const int R = pos_mod(wy0 + l, p.ny), C = pos_mod(wx0 + m, p.nx);
      sidx[j] = (l + p.pad) * a.stride + m + p.pad;
      gidx[j] = BLOCK ? pos_mod(wy0 + l - p.oy + p.gy, p.buf_y) * p.buf_x +
                            pos_mod(wx0 + m - p.ox + p.gx, p.buf_x)
                      : R * p.nx + C;
      live |= 1u << j;
      par |= (unsigned)((R + C) & 1) << j;
    }
  }
  for (int e = tid; e < (INPLACE ? 1 : 2) * buf_cells; e += NT) sm[e] = T(0);
  // the pre-pass writes a row of this window (edge tiles only)
  const bool edge = p.extend && (wy0 <= 1 || wy0 + p.winy >= p.ny - 1);

  // the block walks slices [b_first, b_end) of its tile; a plane the batch
  // shares stays in registers (or wsm) from one slice to the next
  T cw[CPT][KR], cw0[CPT], cg[CPT], crel[CPT];
  const int b_first = blockIdx.z * p.spb;
  const int b_end = min(p.B, b_first + p.spb);
  for (int b = b_first; b < b_end; ++b) {
    const bool first = b == b_first;
    const bool lw = first || p.w_bstride, l0 = first || p.w0_bstride;
    const bool lg = first || p.g_bstride, lr = first || p.rel_bstride;
    __syncthreads();   // the buffers are free (zeroed, or written back)
    // every load of the slice first, then the stores to shared memory
    T sv0[CPT];
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      if (!((live >> j) & 1u)) continue;
      const long long q = gidx[j];
      if (!WS && lw) {
#pragma unroll
        for (int k = 0; k < KR; ++k)
          if (k < p.K) cw[j][k] = w[k * p.w_kstride + b * p.w_bstride + q];
      }
      if (l0) cw0[j] = w0[b * p.w0_bstride + q];
      if (lg) cg[j] = g[b * p.g_bstride + q];
      if (lr) crel[j] = rel[b * p.rel_bstride + q];
      sv0[j] = s_in[b * plane + q];
    }
    if (WS && lw) {
      for (int k = 0; k < p.K; ++k) {
        const T* wk = w + k * p.w_kstride + b * p.w_bstride;
#pragma unroll
        for (int j = 0; j < CPT; ++j)
          if ((live >> j) & 1u) wsm[k * cells + tid + j * NT] = wk[gidx[j]];
      }
    }
#pragma unroll
    for (int j = 0; j < CPT; ++j)
      if ((live >> j) & 1u) sm[sidx[j]] = sv0[j];
    __syncthreads();

    int cur = 0, nxt = INPLACE ? 0 : buf_cells;   // offsets of the buffers
    for (int s = 0; s < p.nsweeps; ++s) {
      if (edge) {
        T ev[CPT];
        unsigned emask = 0u;
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          if (!((live >> j) & 1u)) continue;
          // the cell's global (R, C): its plane index, or in the block
          // mode its window position
          const int c = tid + j * NT;
          int R, C;
          if (BLOCK) {
            R = pos_mod(wy0 + c / p.winx, p.ny);
            C = pos_mod(wx0 + c % p.winx, p.nx);
          } else {
            R = gidx[j] / p.nx;
            C = gidx[j] - R * p.nx;
          }
          int dr, dc;
          if (!extend_source(R, C, p.ny, p.nx, p.periodic_x, p.bih, &dr, &dc))
            continue;
          const int l = c / p.winx + dr, m = c % p.winx + dc;
          if (l < 0 || l >= p.winy || m < 0 || m >= p.winx) continue;
          ev[j] = sm[cur + sidx[j] + dr * a.stride + dc];
          emask |= 1u << j;
        }
        __syncthreads();
#pragma unroll
        for (int j = 0; j < CPT; ++j)
          if ((emask >> j) & 1u) sm[cur + sidx[j]] = ev[j];
        __syncthreads();
      }
#pragma unroll
      for (int color = 0; color < 2; ++color) {
        const T fac = (T)p.fac[2 * s + color];
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          if (!((live >> j) & 1u)) continue;
          const bool active = (int)((par >> j) & 1u) == color;
          if (INPLACE && !active) continue;
          const int si = cur + sidx[j];
          const T sv = sm[si];
          T acc = cg[j];
#pragma unroll
          for (int k = 0; k < KMAX; ++k)
            if (k < p.K)
              acc = acc + (WS ? wsm[k * cells + tid + j * NT] : cw[j][k])
                              * sm[si + a.soff[k]];
          sm[nxt + sidx[j]] = relax_cell(sv, acc, cw0[j], crel[j],
                                         active ? T(1) : T(0), fac);
        }
        __syncthreads();
        const int t = cur;
        cur = nxt;
        nxt = t;
      }
    }
    // write back the owned tile from buffer 0 (an even number of swaps),
    // one warp a row of 32 cells; with partials, the |S| sum of each 32 x 8
    // block of the grid the tile holds, in the header's order (the warp's
    // shuffle tree over a row, then the 8 row sums in turn)
    const int by = BLOCK ? p.by : p.ny, bx = BLOCK ? p.bx : p.nx;
    const int ry = min(p.ty, by - ty0), rx = min(p.tx, bx - tx0);
    const int nby = (ry + 7) / 8, nbx = (rx + 31) / 32;
    const int lane = tid & 31;
    for (int q = tid >> 5; q < nby * nbx * 8; q += NT / 32) {
      const int blk = q >> 3;
      const int i = (blk / nbx) * 8 + (q & 7);
      const int jx = (blk % nbx) * 32 + lane;
      T v = T(0);
      if (i < ry && jx < rx) {
        v = sm[(p.hy + i + p.pad) * a.stride + p.hx + jx + p.pad];
        s_out[b * plane +
              (BLOCK ? (long long)(p.gy + ty0 + i) * p.buf_x + p.gx
                     : (long long)(ty0 + i) * p.nx) + tx0 + jx] = v;
      }
      if (partials != nullptr) {
        v = warp_sum(v < T(0) ? -v : v);
        if (lane == 0) rowsum[q] = v;
      }
    }
    if (partials != nullptr) {
      __syncthreads();
      // the owned region's 32 x 8 blocks; a block whose origin is a multiple
      // of (8, 32) has the whole grid's blocks, in its own layout
      const int pby = (by + 7) / 8, pbx = (bx + 31) / 32;
      for (int blk = tid; blk < nby * nbx; blk += NT) {
        T t = rowsum[blk * 8];
        for (int r = 1; r < 8; ++r) t = t + rowsum[blk * 8 + r];
        partials[((long long)b * pby + ty0 / 8 + blk / nbx) * pbx +
                 tx0 / 32 + blk % nbx] = t;
      }
    }
  }
}

template <typename T, int KMAX, int CPT, int NT, bool INPLACE, bool WS,
          bool BLOCK>
static int launch_tiled_inst(const T* s_in, T* s_out, const T* w,
                             const T* w0, const T* g, const T* rel,
                             T* partials, const TiledArgs& a, dim3 grid,
                             size_t smem, cudaStream_t stream) {
  auto kern =
      sor2d_sweeps_tiled_kernel<T, KMAX, CPT, NT, INPLACE, WS, BLOCK>;
  // raise the instantiation's shared-memory limit only when a launch needs
  // more than before, on each device: set on every launch, it kept the host
  // from queueing launches ahead of the device (measured on the H100)
  static size_t granted[64] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || dev < 0 || dev >= 64)
    return (int)(err != cudaSuccess ? err : cudaErrorInvalidDevice);
  if (smem > granted[dev]) {
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    granted[dev] = smem;
  }
  kern<<<grid, NT, smem, stream>>>(s_in, s_out, w, w0, g, rel, partials, a);
  return (int)cudaGetLastError();
}

// One axis of a block (sor2d_sweeps_block): its owned rows [o, o + b) of
// the global n, g ghosts on each side, a buffer of b + 2g.  An axis without
// ghosts is the whole axis, and its windows wrap inside the buffer as the
// whole-grid kernel's do; one with ghosts must hold every window (g >= h).
static bool block_axis_ok(int o, int b, int g, int buf, int n, int h) {
  if (buf != b + 2 * g || b < 1 || o < 0 || o + b > n || g < 0) return false;
  return g == 0 ? (o == 0 && b == n) : (g >= h && g < n);
}

// Checks the parameters and launches the instantiation they name (the
// table in ops/sor2d.py::_CONFIGS); cudaErrorInvalidValue on anything else.
// Without `block` the launch covers the whole grid (sor2d_sweeps_tiled),
// whatever the block fields say.
template <typename T>
static int launch_tiled(const T* s_in, T* s_out, const T* w, const T* w0,
                        const T* g, const T* rel, T* partials,
                        const TiledParams* pp, void* stream, bool block) {
  TiledParams p = *pp;
  if (!block) {
    p.oy = p.ox = p.gy = p.gx = 0;
    p.by = p.buf_y = p.ny;
    p.bx = p.buf_x = p.nx;
  } else if (p.inplace || !block_axis_ok(p.oy, p.by, p.gy, p.buf_y, p.ny,
                                         p.hy) ||
             !block_axis_ok(p.ox, p.bx, p.gx, p.buf_x, p.nx, p.hx)) {
    return (int)cudaErrorInvalidValue;
  }
  if (p.K < 0 || p.K > p.kmax || p.B < 1 || p.ny < 1 || p.nx < 1 ||
      (long long)p.ny * p.nx >= (1LL << 31) ||
      (long long)p.buf_y * p.buf_x >= (1LL << 31) || p.nsweeps < 1 ||
      p.nsweeps > TILED_MAX_SWEEPS || p.ty < 1 || p.tx < 1 ||
      p.winy != p.ty + 2 * p.hy || p.winx != p.tx + 2 * p.hx ||
      p.winy * p.winx > p.nt * p.cpt || p.spb < 1 ||
      p.tiles_y != (p.by + p.ty - 1) / p.ty ||
      p.tiles_x != (p.bx + p.tx - 1) / p.tx ||
      (p.B + p.spb - 1) / p.spb > 65535 || p.tiles_y > 65535)
    return (int)cudaErrorInvalidValue;
  // the partials of 32 x 8 blocks need tiles that hold whole blocks, and a
  // block's partials are the whole grid's only from an origin on a block
  if (partials != nullptr && ((p.tiles_y > 1 && p.ty % 8) ||
                              (p.tiles_x > 1 && p.tx % 32) || p.oy % 8 ||
                              p.ox % 32))
    return (int)cudaErrorInvalidValue;
  // the halo must cover k sweeps' dependence cone (header)
  int r = 0;
  for (int k = 0; k < p.K; ++k) {
    r = max(r, abs(p.dy[k]));
    r = max(r, abs(p.dx[k]));
  }
  const int e = p.extend ? (p.bih ? 2 : 1) : 0;
  const int ex = p.periodic_x ? 0 : e;
  if (p.pad < r || p.hy < 2 * r * p.nsweeps + e ||
      p.hx < 2 * r * p.nsweeps + ex)
    return (int)cudaErrorInvalidValue;
  TiledArgs a;
  a.p = p;
  a.stride = p.winx + 2 * p.pad;
  for (int k = 0; k < SOR2D_MAX_K; ++k)
    a.soff[k] = k < p.K ? p.dy[k] * a.stride + p.dx[k] : 0;
  // the state buffers, the weight planes where they live in shared
  // memory, the row sums of the tile's 32 x 8 blocks
  const size_t smem =
      ((size_t)(p.inplace ? 1 : 2) * (p.winy + 2 * p.pad) * a.stride +
       (p.wsmem ? (size_t)p.K * p.winy * p.winx : 0) +
       (size_t)((p.ty + 7) / 8) * 8 * ((p.tx + 31) / 32)) * sizeof(T);
  dim3 grid(p.tiles_x, p.tiles_y, (p.B + p.spb - 1) / p.spb);
  cudaStream_t st = (cudaStream_t)stream;
  // the block mode takes the ping-pong kernel only (IP 0): an in-place
  // instantiation's block branch names its whole-grid twin, never taken
#define TILED_CASE(KM, CP, N, IP, WSM)                                      \
  if (p.kmax == KM && p.cpt == CP && p.nt == N && p.inplace == IP &&        \
      p.wsmem == WSM)                                                       \
    return block ? launch_tiled_inst<T, KM, CP, N, IP, WSM, !IP>(           \
                       s_in, s_out, w, w0, g, rel, partials, a, grid, smem, \
                       st)                                                  \
                 : launch_tiled_inst<T, KM, CP, N, IP, WSM, false>(         \
                       s_in, s_out, w, w0, g, rel, partials, a, grid, smem, \
                       st);
  if constexpr (sizeof(T) == 4) {
    TILED_CASE(4, 4, 1024, 0, 0)
    TILED_CASE(4, 4, 1024, 1, 0)
    TILED_CASE(8, 4, 512, 0, 0)
    TILED_CASE(16, 2, 1024, 0, 1)
  } else {
    TILED_CASE(4, 4, 512, 0, 0)
    TILED_CASE(4, 4, 512, 1, 0)
    TILED_CASE(8, 4, 512, 0, 1)
    TILED_CASE(16, 2, 512, 0, 1)
  }
#undef TILED_CASE
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// The resident kernel (sor2d_sweeps_resident): one whole batch slice held in
// shared memory for a whole check window of sweeps.
//
// Replaces no new TPU kernel.  It is B1/B2's counterpart (xinvert_tpu/ops/
// pallas_sor.py::_kernel, the VMEM-resident multi-sweep kernel, and
// pallas_sor_window.py::_kernel) for slices that fit one SM: there the tiled
// kernel's windows hold a few tiles of the slice each and recompute their
// halos (a 73x144 slice in 50x80 windows computes 6.9 cells per cell a
// sweep).  The wrapper takes it for radius-1 stencils without cross terms
// whose slice fits the instantiation (ops/sor2d.py::resident_plan); every
// other spec and shape runs the tiled kernels.
//
// A block walks slices b = blockIdx.x, + gridDim.x, ... (a grid of
// min(B, SMs) blocks: no block walks more than ceil(B / blocks) slices).
// For each it loads the slice once, runs the launch's sweeps (the extend
// pre-pass, red, black) in shared memory, and writes the slice back once,
// with the fused |S| partials of the tiled kernel: the same 32 x 8 blocks,
// summed in the same order, so a checked solve's norms, and so its stops,
// are the tiled kernel's bit for bit.  The state is read and written in
// place (one buffer): each block reads its slice whole before it writes it.
// Planes the batch shares are loaded once a block.
//
// Layout.  The slice lives in two color arrays: cell (j, i) of color
// a = (j + i) & 1 sits in array a at row j + 1 and column (i + 2) >> 1, row
// stride rs = ceil(nx / 2) + 2.  Every neighbour of a cell has the other
// color, so a half-sweep of color c reads array 1 - c alone, and the lanes
// of a warp, which own consecutive columns of a row, read consecutive words
// (no bank conflict).  Each array has a ring of ghosts: the formal rows -1
// and ny and columns -1 and nx, each holding the cell torch.roll wraps it to
// (row ny - 1, row 0, column nx - 1, column 0), so every neighbour read is a
// fixed offset from the cell: rs for (1, 0), and for (0, +-1) one that
// depends on the cell's column parity (dx > 0: par, dx < 0: par - 1).  A
// write of an edge cell writes its ghosts too.  The weights sit in shared
// memory in the same layout, the K <= 4 of a cell as one 16-byte vector
// (one load); w0, g and rel of a thread's cells in registers.  Thread t
// owns the pairs (j, 2q), (j, 2q + 1) of the slots
// e = t + s * NT, s < CPT, (j, q) = divmod(e, ceil(nx / 2)): one cell of
// each color, so every half-sweep gives each thread the same work.
//
// In place, and exact.  A half-sweep computes only the cells of its color
// and writes them in place: an active cell reads the other color alone, and
// a read across the wrap reads a ghost.  Where an odd size joins two cells
// of one color across the wrap and either may change (rel not 0 on the
// axis's boundary lines, or the exact mode below), the active cells' ghosts
// are written after a barrier, so every read sees the state before the
// half-sweep.  The plain
// version computes every cell: those of the other color take
// s + ((rel * 0) * fac) * (acc + w0 * s), which is s (up to the sign of a
// zero) unless rel, fac or the bracket is not finite, when it is NaN.  The
// block keeps that, in one of two modes the whole block takes for each
// half-sweep:
//   - fast, where no bracket can overflow: the planes are finite,
//     |w_k|, |w0| <= 2^40 and |g| <= 2^126 (double: 2^400, 2^1022), fac is
//     finite, and every cell of the state is at most 2^80 (2^600) in
//     magnitude, so every bracket is finite and the other color keeps its
//     value: only the active cells are computed.
//   - exact, otherwise: the threads first note which of their other-color
//     cells the plain version turns NaN, from the state before the
//     half-sweep, wait at a barrier, update the active cells, wait again,
//     and write those NaNs.
// The planes are tested as they load; the state's bound rides the barrier
// that ends each half-sweep (__syncthreads_or).  Nothing here is gated by a
// switch: on the specs it takes the kernel is the plain version bit for bit
// (torch.equal), NaN and Inf included.
//
// Bound: operations.  A point-sweep costs 2K + 4 = 12 operations (K = 4):
// 15.3 M points take 2.74 us a sweep at 67 TFLOP/s.  Device memory is read
// and written once a launch (a window of up to 64 sweeps), so its bytes are
// no longer the limit.  What a half-sweep costs the SM instead: per active
// cell K + 1 shared-memory reads of the state, a vector of the weights and
// one write (more for an edge cell's ghosts), conflict-free; some 60
// instructions; one barrier a half-sweep (two where the ghosts wait), which
// also carries the state's test, and one for the extend pre-pass; the last
// slot round of ceil(slots / NT).  The slots' codes and the planes w0, g,
// rel stay in registers (7 a slot), so a half-sweep keeps no value of its
// own there.
// ---------------------------------------------------------------------------

#define RESIDENT_MAX_SWEEPS 64
#define RESIDENT_MAX_K 4

// Mirrored field by field by ops/sor2d.py::_ResidentParams (ctypes).
struct ResidentParams {
  int B, ny, nx, K, nsweeps;
  int rs;                      // row stride of a color array
  int extend, periodic_x;
  int cpt, nt;                 // the instantiation
  int dy[SOR2D_MAX_K];
  int dx[SOR2D_MAX_K];
  long long w_kstride, w_bstride, w0_bstride, g_bstride, rel_bstride;
  double fac[2 * RESIDENT_MAX_SWEEPS];  // per half-sweep; exact in T
};

struct ResidentArgs {
  ResidentParams p;
  int hx, sa, wa;              // slots a row; cells of a color array, of a
                               // weight array (4 weights a cell)
  int wofs;                    // the weight arrays' offset (16-byte aligned)
  unsigned rs_inv;             // ceil(2^32 / rs): res_row
  int odd;                     // ny or nx odd: ghosts wait for a barrier
  int obase[RESIDENT_MAX_K];   // offset k: dy * rs + (dx < 0 ? -1 : 0)
  int omask[RESIDENT_MAX_K];   //   + (par & omask): -1 where dx != 0
};

// A slot's code: bits 0-15 the pair's index ix in a color array, bit 16
// its row's parity, bits 17-18 whether cell h = 0, 1 exists (2q + h < nx),
// bits 19-20 whether it is an edge cell (has ghosts), bit 21 whether the
// row is 0 or ny - 1 (the extend pre-pass writes it); -1: no slot.
#define RES_VALID 17
#define RES_EDGE 19
#define RES_EXTROW 21

__device__ __forceinline__ int res_ix(int j, int i, int rs) {
  return (j + 1) * rs + ((i + 2) >> 1);
}

// The row j and first column c2 of the pair at index ix: ix / rs by a
// multiply with rs_inv = ceil(2^32 / rs), exact for ix < 2^16.
__device__ __forceinline__ void res_row(int ix, int rs, unsigned rs_inv,
                                        int* j, int* c2) {
  *j = (int)__umulhi((unsigned)ix, rs_inv) - 1;
  *c2 = 2 * (ix - (*j + 1) * rs - 1);
}

template <typename T>
__device__ __forceinline__ T res_get(const T* st, int sa, int rs, int j,
                                     int i) {
  return st[((j + i) & 1) * sa + res_ix(j, i, rs)];
}

// Writes the ghosts of cell (j, i).
template <typename T>
__device__ __forceinline__ void res_ghosts(T* st, int sa, int rs, int ny,
                                           int nx, int j, int i, T v) {
  if (i == 0) st[((j + nx) & 1) * sa + res_ix(j, nx, rs)] = v;
  if (i == nx - 1) st[((j + 1) & 1) * sa + res_ix(j, -1, rs)] = v;
  if (j == 0) st[((ny + i) & 1) * sa + res_ix(ny, i, rs)] = v;
  if (j == ny - 1) st[((i + 1) & 1) * sa + res_ix(-1, i, rs)] = v;
}

// Writes cell (j, i) and its ghosts.
template <typename T>
__device__ __forceinline__ void res_put_edge(T* st, int sa, int rs, int ny,
                                             int nx, int j, int i, T v) {
  st[((j + i) & 1) * sa + res_ix(j, i, rs)] = v;
  res_ghosts(st, sa, rs, ny, nx, j, i, v);
}

template <typename T>
__device__ __forceinline__ T res_abs(T v) { return v < T(0) ? -v : v; }

// A cell's weights w_0..w_3, one 16-byte-aligned vector in shared memory
// (one 128-bit load in float, two in double).
template <typename T>
struct W4 {
  T v[RESIDENT_MAX_K];
};

template <typename T>
__device__ __forceinline__ W4<T> res_load_w4(const T* at) {
  W4<T> r;
  if constexpr (sizeof(T) == 4) {
    const float4 f = *reinterpret_cast<const float4*>(at);
    r.v[0] = f.x; r.v[1] = f.y; r.v[2] = f.z; r.v[3] = f.w;
  } else {
    const double2 a = reinterpret_cast<const double2*>(at)[0];
    const double2 b = reinterpret_cast<const double2*>(at)[1];
    r.v[0] = a.x; r.v[1] = a.y; r.v[2] = b.x; r.v[3] = b.y;
  }
  return r;
}

// acc = g + w_0 * s_0 + ... + w_{K-1} * s_{K-1} in k order, s_k read from
// nb (the other color's array at the cell's index) at offset
// obase[k] + (par & omask[k]); four offsets without a test of K each.
template <typename T>
__device__ __forceinline__ T res_neighbour_sum(T g, const W4<T>& w,
                                               const T* nb, int par, int K,
                                               const int* obase,
                                               const int* omask) {
  T acc = g;
  if (K == RESIDENT_MAX_K) {
#pragma unroll
    for (int k = 0; k < RESIDENT_MAX_K; ++k)
      acc = acc + w.v[k] * nb[obase[k] + (par & omask[k])];
  } else {
#pragma unroll
    for (int k = 0; k < RESIDENT_MAX_K; ++k)
      if (k < K) acc = acc + w.v[k] * nb[obase[k] + (par & omask[k])];
  }
  return acc;
}

template <typename T>
__device__ __forceinline__ void res_bounds(T* bw, T* bg, T* bs) {
  if constexpr (sizeof(T) == 4) {
    *bw = 0x1p40f; *bg = 0x1p126f; *bs = 0x1p80f;
  } else {
    *bw = 0x1p400; *bg = 0x1p1022; *bs = 0x1p600;
  }
}

template <typename T>
__device__ __forceinline__ T res_nan() {
  if constexpr (sizeof(T) == 4) return __int_as_float(0x7fffffff);
  else return __longlong_as_double(0x7fffffffffffffffLL);
}

template <typename T, int CPT, int NT>
__global__ void __launch_bounds__(NT, 1)
sor2d_sweeps_resident_kernel(T* s, const T* __restrict__ w,
                             const T* __restrict__ w0,
                             const T* __restrict__ g,
                             const T* __restrict__ rel,
                             T* __restrict__ partials,
                             const __grid_constant__ ResidentArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const st = reinterpret_cast<T*>(smem_raw);  // the two color arrays
  const ResidentParams& p = a.p;
  const int ny = p.ny, nx = p.nx, rs = p.rs, hx = a.hx, sa = a.sa,
            wa = a.wa;
  // the weights of the cell at index ix of color c: 4 at (c wa + ix - rs) 4
  T* const wsm = st + a.wofs;
  T* const rowsum = wsm + 8 * wa;
  const int tid = threadIdx.x;
  T bw, bg, bs;
  res_bounds(&bw, &bg, &bs);

  int code[CPT];
#pragma unroll
  for (int q = 0; q < CPT; ++q) {
    const int e = tid + q * NT;
    code[q] = -1;
    if (e < ny * hx) {
      const int j = e / hx, c2 = 2 * (e - j * hx);
      const bool erow = j == 0 || j == ny - 1;
      code[q] = res_ix(j, c2, rs) | (j & 1) << 16 | 1 << RES_VALID |
                (c2 + 1 < nx) << (RES_VALID + 1) |
                (erow || c2 == 0 || c2 == nx - 1) << RES_EDGE |
                (erow || c2 + 1 == nx - 1) << (RES_EDGE + 1) |
                erow << RES_EXTROW;
    }
  }
  T cw0[CPT][2], cg[CPT][2], crel[CPT][2];
  bool bad_w = false, bad_w0 = false, bad_g = false, bad_rel = false;
  bool live_wrap = false;   // a cell of an odd axis's wrap pair moves
  const long long plane = (long long)ny * nx;
  for (int b = blockIdx.x; b < p.B; b += gridDim.x) {
    const bool first = b == (int)blockIdx.x;
    const bool lw = first || p.w_bstride, l0 = first || p.w0_bstride;
    const bool lg = first || p.g_bstride, lr = first || p.rel_bstride;
    __syncthreads();   // the previous slice's write-back is done
    bool bad_s = false;
    bad_w &= !lw;
    bad_w0 &= !l0;
    bad_g &= !lg;
    bad_rel &= !lr;
    live_wrap &= !lr;
#pragma unroll
    for (int q = 0; q < CPT; ++q) {
      if (code[q] < 0) continue;
      const int ix = code[q] & 0xffff;
      int j, c2;
      res_row(ix, rs, a.rs_inv, &j, &c2);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = c2 + h;
        if (i >= nx) continue;
        const long long gi = (long long)j * nx + i;
        const int col = (j + h) & 1;
        const T v = s[b * plane + gi];
        bad_s |= !(res_abs(v) <= bs);
        res_put_edge(st, sa, rs, ny, nx, j, i, v);
        if (lw) {
          T* const wq = wsm + (col * wa + ix - rs) * RESIDENT_MAX_K;
          for (int k = 0; k < RESIDENT_MAX_K; ++k) {
            const T wv = k < p.K ? w[k * p.w_kstride + b * p.w_bstride + gi]
                                 : T(0);
            wq[k] = wv;
            bad_w |= !(res_abs(wv) <= bw);
          }
        }
        if (l0) {
          cw0[q][h] = w0[b * p.w0_bstride + gi];
          bad_w0 |= !(res_abs(cw0[q][h]) <= bw);
        }
        if (lg) {
          cg[q][h] = g[b * p.g_bstride + gi];
          bad_g |= !(res_abs(cg[q][h]) <= bg);
        }
        if (lr) {
          crel[q][h] = rel[b * p.rel_bstride + gi];
          bad_rel |= !isfinite(crel[q][h]);
          // both cells of a wrap pair of one color keep their value (rel 0)
          // in the fast mode: their ghosts need not wait
          live_wrap |= crel[q][h] != T(0) &&
                       (((nx & 1) && (i == 0 || i == nx - 1)) ||
                        ((ny & 1) && (j == 0 || j == ny - 1)));
        }
      }
    }
    const bool planes_bad =
        __syncthreads_or(bad_w || bad_w0 || bad_g || bad_rel);
    const bool wrap_moves = __syncthreads_or(live_wrap);
    bool state_bad = __syncthreads_or(bad_s);

    for (int sw = 0; sw < p.nsweeps; ++sw) {
      if (p.extend) {
        // rows 0 and ny - 1 take their sources' values (rows 1 and ny - 2),
        // in place: no source is a written cell
#pragma unroll
        for (int q = 0; q < CPT; ++q) {
          if (code[q] < 0 || !((code[q] >> RES_EXTROW) & 1)) continue;
          const int ix = code[q] & 0xffff;
          int j, c2;
          res_row(ix, rs, a.rs_inv, &j, &c2);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int i = c2 + h;
            if (i >= nx) continue;
            int dr, dc;
            if (!extend_source(j, i, ny, nx, p.periodic_x, 0, &dr, &dc))
              continue;
            res_put_edge(st, sa, rs, ny, nx, j, i,
                         res_get(st, sa, rs, j + dr, i + dc));
          }
        }
        __syncthreads();
      }
      // one color a turn of the loop, and the slots' codes made opaque to
      // the compiler at each turn: what it derives from them (indices,
      // parities, addresses) is recomputed there rather than hoisted out
      // of the sweeps into registers, which would spill
#pragma unroll 1
      for (int color = 0; color < 2; ++color) {
#pragma unroll
        for (int q = 0; q < CPT; ++q) asm volatile("" : "+r"(code[q]));
        const T fac = (T)p.fac[2 * sw + color];
        const bool exact = planes_bad || state_bad || !isfinite(fac);
        // the ghosts of this half-sweep's cells wait for a barrier where an
        // odd size joins cells of one color across the wrap and one of them
        // may change
        const bool defer = a.odd && (exact || wrap_moves);
        T* const own = st + color * sa;
        const T* const oth = st + (1 - color) * sa;
        const T* const wc = wsm + (color * wa - rs) * RESIDENT_MAX_K;
        unsigned turns_nan = 0u;   // exact: bit q, slot q's other cell
        if (exact) {
          // the other-color cells the plain version turns NaN: s + 0 * (a
          // bracket that is not finite), from the state before the writes
          const T* const wo = wsm + ((1 - color) * wa - rs) * RESIDENT_MAX_K;
#pragma unroll
          for (int q = 0; q < CPT; ++q) {
            if (code[q] < 0) continue;
            const int par = ((code[q] >> 16) ^ color ^ 1) & 1;
            if (!((code[q] >> (RES_VALID + par)) & 1)) continue;
            const int ix = code[q] & 0xffff;
            const T sv = oth[ix];
            const T acc = res_neighbour_sum(
                par ? cg[q][1] : cg[q][0],
                res_load_w4(wo + ix * RESIDENT_MAX_K), own + ix, par, p.K,
                a.obase, a.omask);
            const T out = relax_cell(sv, acc, par ? cw0[q][1] : cw0[q][0],
                                     par ? crel[q][1] : crel[q][0], T(0),
                                     fac);
            if (!(out == sv)) turns_nan |= 1u << q;
          }
          __syncthreads();
        }
        // the active cells, in place: they read the other color alone, and
        // a read across the wrap reads a ghost (which waits where defer)
        bool bad = turns_nan != 0u;
#pragma unroll
        for (int q = 0; q < CPT; ++q) {
          if (code[q] < 0) continue;
          const int par = ((code[q] >> 16) ^ color) & 1;
          if (!((code[q] >> (RES_VALID + par)) & 1)) continue;
          const int ix = code[q] & 0xffff;
          const T sv = own[ix];
          const T acc = res_neighbour_sum(
              par ? cg[q][1] : cg[q][0], res_load_w4(wc + ix * RESIDENT_MAX_K),
              oth + ix, par, p.K, a.obase, a.omask);
          const T nv = relax_cell(sv, acc, par ? cw0[q][1] : cw0[q][0],
                                  par ? crel[q][1] : crel[q][0], T(1), fac);
          bad |= !(res_abs(nv) <= bs);
          own[ix] = nv;
          if (!defer && ((code[q] >> (RES_EDGE + par)) & 1)) {
            int j, c2;
            res_row(ix, rs, a.rs_inv, &j, &c2);
            res_ghosts(st, sa, rs, ny, nx, j, c2 + par, nv);
          }
        }
        if (defer || exact) {
          __syncthreads();
#pragma unroll
          for (int q = 0; q < CPT; ++q) {
            if (code[q] < 0) continue;
            const int par = ((code[q] >> 16) ^ color) & 1;
            const bool ghosts = defer &&
                                ((code[q] >> (RES_VALID + par)) & 1) &&
                                ((code[q] >> (RES_EDGE + par)) & 1);
            const bool turns = (turns_nan >> q) & 1u;
            if (!ghosts && !turns) continue;
            const int ix = code[q] & 0xffff;
            int j, c2;
            res_row(ix, rs, a.rs_inv, &j, &c2);
            if (ghosts) res_ghosts(st, sa, rs, ny, nx, j, c2 + par, own[ix]);
            if (turns)
              res_put_edge(st, sa, rs, ny, nx, j, c2 + (par ^ 1),
                           res_nan<T>());
          }
        }
        state_bad = __syncthreads_or(bad);
      }
    }
    // write back the slice, one warp a row of 32 cells; with partials, the
    // |S| sum of each 32 x 8 block in the tiled kernel's order (the warp's
    // shuffle tree over a row, then the 8 row sums in turn)
    const int nby = (ny + 7) / 8, nbx = (nx + 31) / 32;
    const int lane = tid & 31;
    for (int q = tid >> 5; q < nby * nbx * 8; q += NT / 32) {
      const int blk = q >> 3;
      const int i = (blk / nbx) * 8 + (q & 7);
      const int jx = (blk % nbx) * 32 + lane;
      T v = T(0);
      if (i < ny && jx < nx) {
        v = res_get(st, sa, rs, i, jx);
        s[b * plane + (long long)i * nx + jx] = v;
      }
      if (partials != nullptr) {
        v = warp_sum(v < T(0) ? -v : v);
        if (lane == 0) rowsum[q] = v;
      }
    }
    if (partials != nullptr) {
      __syncthreads();
      for (int blk = tid; blk < nby * nbx; blk += NT) {
        T t = rowsum[blk * 8];
        for (int r = 1; r < 8; ++r) t = t + rowsum[blk * 8 + r];
        partials[(long long)b * nby * nbx + blk] = t;
      }
    }
  }
}

template <typename T, int CPT, int NT>
static int launch_resident_inst(T* s, const T* w, const T* w0, const T* g,
                                const T* rel, T* partials,
                                const ResidentArgs& a, int blocks,
                                size_t smem, cudaStream_t stream, int dev) {
  auto kern = sor2d_sweeps_resident_kernel<T, CPT, NT>;
  // raise the limit only when a launch needs more than before (as the
  // tiled kernels do)
  static size_t granted[64] = {0};
  if (smem > granted[dev]) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    granted[dev] = smem;
  }
  kern<<<blocks, NT, smem, stream>>>(s, w, w0, g, rel, partials, a);
  return (int)cudaGetLastError();
}

// Checks the parameters and launches the instantiation they name (the
// table in ops/sor2d.py::_RESIDENT_CONFIGS); cudaErrorInvalidValue on
// anything else.
template <typename T>
static int launch_resident(T* s, const T* w, const T* w0, const T* g,
                           const T* rel, T* partials,
                           const ResidentParams* pp, void* stream) {
  const ResidentParams& p = *pp;
  const int hx = (p.nx + 1) / 2;
  if (p.K < 0 || p.K > RESIDENT_MAX_K || p.B < 1 || p.ny < 3 || p.nx < 3 ||
      p.rs != hx + 2 || (long long)(p.ny + 2) * p.rs > 0xffff ||
      (long long)p.ny * hx > (long long)p.nt * p.cpt || p.nsweeps < 1 ||
      p.nsweeps > RESIDENT_MAX_SWEEPS)
    return (int)cudaErrorInvalidValue;
  ResidentArgs a;
  a.p = p;
  a.hx = hx;
  a.sa = (p.ny + 2) * p.rs;
  a.wa = p.ny * p.rs;
  a.wofs = (2 * a.sa + 3) & ~3;
  a.rs_inv = (unsigned)((0x100000000ULL + p.rs - 1) / p.rs);
  a.odd = (p.ny | p.nx) & 1;
  for (int k = 0; k < RESIDENT_MAX_K; ++k) {
    a.obase[k] = a.omask[k] = 0;
    if (k >= p.K) continue;
    // radius 1 without cross terms: every neighbour has the other color
    if (abs(p.dy[k]) + abs(p.dx[k]) != 1) return (int)cudaErrorInvalidValue;
    a.obase[k] = p.dy[k] * p.rs + (p.dx[k] < 0 ? -1 : 0);
    a.omask[k] = p.dx[k] != 0 ? -1 : 0;
  }
  const size_t smem =
      ((size_t)a.wofs + (size_t)8 * a.wa +
       (size_t)((p.ny + 7) / 8) * 8 * ((p.nx + 31) / 32)) * sizeof(T);
  static int sms[64] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || dev < 0 || dev >= 64)
    return (int)(err != cudaSuccess ? err : cudaErrorInvalidDevice);
  if (sms[dev] == 0) {
    err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount,
                                 dev);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = p.B < sms[dev] ? p.B : sms[dev];
  cudaStream_t st = (cudaStream_t)stream;
#define RESIDENT_CASE(CP, N)                                             \
  if (p.cpt == CP && p.nt == N)                                          \
    return launch_resident_inst<T, CP, N>(s, w, w0, g, rel, partials, a, \
                                          blocks, smem, st, dev);
  if constexpr (sizeof(T) == 4) {
    RESIDENT_CASE(6, 896)
  } else {
    RESIDENT_CASE(6, 512)
  }
#undef RESIDENT_CASE
  return (int)cudaErrorInvalidValue;
}

extern "C" {

int sor2d_sweeps_tiled_f32(const float* s_in, float* s_out, const float* w,
                           const float* w0, const float* g, const float* rel,
                           float* partials, const TiledParams* p,
                           void* stream) {
  return launch_tiled<float>(s_in, s_out, w, w0, g, rel, partials, p, stream,
                             false);
}

int sor2d_sweeps_tiled_f64(const double* s_in, double* s_out,
                           const double* w, const double* w0, const double* g,
                           const double* rel, double* partials,
                           const TiledParams* p, void* stream) {
  return launch_tiled<double>(s_in, s_out, w, w0, g, rel, partials, p,
                              stream, false);
}

// B2s: the ping-pong tiled kernel on one ghost-padded block (see the block
// mode below the tiled kernel's header).
int sor2d_sweeps_block_f32(const float* s_in, float* s_out, const float* w,
                           const float* w0, const float* g, const float* rel,
                           float* partials, const TiledParams* p,
                           void* stream) {
  return launch_tiled<float>(s_in, s_out, w, w0, g, rel, partials, p, stream,
                             true);
}

int sor2d_sweeps_block_f64(const double* s_in, double* s_out,
                           const double* w, const double* w0, const double* g,
                           const double* rel, double* partials,
                           const TiledParams* p, void* stream) {
  return launch_tiled<double>(s_in, s_out, w, w0, g, rel, partials, p,
                              stream, true);
}

// The resident kernel: every slice of the batch held whole in shared
// memory through the launch's sweeps, in place on s.
int sor2d_sweeps_resident_f32(float* s, const float* w, const float* w0,
                              const float* g, const float* rel,
                              float* partials, const ResidentParams* p,
                              void* stream) {
  return launch_resident<float>(s, w, w0, g, rel, partials, p, stream);
}

int sor2d_sweeps_resident_f64(double* s, const double* w, const double* w0,
                              const double* g, const double* rel,
                              double* partials, const ResidentParams* p,
                              void* stream) {
  return launch_resident<double>(s, w, w0, g, rel, partials, p, stream);
}

// Number of |S| partials a launch writes per batch slice (one a 32 x 8
// block).
int sor2d_partials_per_slice(int ny, int nx) {
  return ((nx + SWEEP_BX - 1) / SWEEP_BX) * ((ny + SWEEP_BY - 1) / SWEEP_BY);
}

}  // extern "C"
