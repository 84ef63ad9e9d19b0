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
// function, so one pair of kernels serves every 3-D shape.  B5's
// sharded-block variants (pad_row, has_ytop/has_ybot, parity_off, pad_col,
// clamp_w/clamp_e, pad_lo with goff_ref; B5s), which serve the multi-device
// executor, are the block mode of the color sweep (sor3d_color_sweep_block,
// at the end of this header).
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
// in the same order, so it stays bit-equal.  The first version's extra
// launch, sor3d_extend_rows (in place on A before the unflagged red
// launch), stays as the yardstick.  The map costs the few rows that need
// it: a flagged launch takes it only for rows within the offsets' y reach
// of rows 0 and ny-1, in a loop of their own, and the flag is a template
// argument, so unflagged launches carry no trace of it.
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
//
// The block mode (B5s, sor3d_color_sweep_block; the TPU kernel's block
// arguments, driven by xinvert_tpu/parallel/halo_window3d.py:205
// _device_step3): one half-sweep of one block of a decomposition over
// (y, x), held with gy ghost rows and gx ghost columns on each side in a
// (B, nz, by + 2gy, bx + 2gx) buffer that a ring exchange filled (wrapping
// on every axis, as torch.roll does).  z is never split.  Every cell of the
// buffer is computed and written, ghosts included: the executor runs k
// sweeps (2k launches) between exchanges, and the ghosts carry the owned
// cells' dependence cone through them (g >= 2rk, plus 1 for the extend).
// Neighbour reads wrap inside the buffer, so cells near its edge read what
// their cone lets them, and an axis without ghosts (the whole axis) wraps
// as the whole-grid launch does.  A cell's global (R, C) is its buffer
// position plus the buffer's origin (oy - gy, ox - gx), wrapped: the
// parity is (l + R + C) & 1 (B5s's parity_off: a block may start on an odd
// row), and the extend map fires on global rows 0 and ny - 1 and clamps at
// global columns 0 and nx - 1 (has_ytop/has_ybot, clamp_w/clamp_e), moving
// a read one row (and column) inside the buffer, or not at all where that
// leaves the buffer.  The launch grid starts ceil(gy/8)*8 rows and
// ceil(gx/32)*32 columns before the owned region, so its 32 x 8 blocks are
// the owned region's, and the |S| partials sum the owned cells alone, in
// the block's (nz, by/8, bx/32) layout: the whole grid's cut at the block
// where the origin is a multiple of (8, 32).  The whole-grid launch is
// the same kernel with its block code compiled out (a template flag).

#include <cuda_runtime.h>
#include <stdint.h>

#define SOR3D_MAX_K 8
#define SWEEP_BX 32
#define SWEEP_BY 8
#define EXTEND_BX 128
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
  // the block mode: the buffer (py, px), its global origin (oyb, oxb) =
  // owned origin minus the ghosts, the ghosts (gy, gx), the owned extents
  // (by, bx) and the launch grid's lead (sy, sx) before the owned region;
  // the whole grid is (py, px) = (by, bx) = (ny, nx) and zeros (last in
  // the struct: the whole-grid fields keep their offsets)
  int py, px, oyb, oxb, gy, gx, by, bx, sy, sx;
};

__device__ __forceinline__ int wrap(int v, int n) {
  return v < 0 ? v + n : (v >= n ? v - n : v);
}

// The extend pre-pass's map (sor3d_extend_rows_kernel below) as a read:
// (l, j, i) -> the cell whose value the pre-pass leaves at (l, j, i); in
// the block mode (j, i) are buffer positions and the map reads their
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
// so B*nz may exceed the grid's z limit.  EXT: the extend flag.  BLOCK: the
// block mode; (j, i) are then buffer positions, the grid starting (sy, sx)
// before the owned region.
template <typename T, bool EXT, bool BLOCK>
__global__ void __launch_bounds__(SWEEP_BX * SWEEP_BY, 8)
sor3d_color_sweep_kernel(const T* __restrict__ s_in, T* __restrict__ s_out,
                         const T* __restrict__ w, const T* __restrict__ w0,
                         const T* __restrict__ g, const T* __restrict__ rel,
                         T* __restrict__ partials, Sor3dArgs a, T fac) {
// the buffer's rows and columns: the whole grid's, or the block's
#define PY (BLOCK ? a.py : a.ny)
#define PX (BLOCK ? a.px : a.nx)
  const int i = blockIdx.x * SWEEP_BX + threadIdx.x -
                (BLOCK ? a.sx - a.gx : 0);
  const int j = blockIdx.y * SWEEP_BY + threadIdx.y -
                (BLOCK ? a.sy - a.gy : 0);
  const long long plane = (long long)PY * PX;
  const long long vol = plane * a.nz;
  const long long n_bz = (long long)a.B * a.nz;
  __shared__ T warp_sums[SWEEP_BX * SWEEP_BY / 32];
  for (long long bz = blockIdx.z; bz < n_bz; bz += gridDim.z) {
    const long long b = bz / a.nz;
    const int l = (int)(bz - b * a.nz);
    T out = T(0);
    if (BLOCK ? ((unsigned)j < (unsigned)PY && (unsigned)i < (unsigned)PX)
              : (i < a.nx && j < a.ny)) {
      // the cell's global row and column (wrapped)
      const int R = BLOCK ? wrap(a.oyb + j, a.ny) : j;
      const int C = BLOCK ? wrap(a.oxb + i, a.nx) : i;
      const long long idx = l * plane + (long long)j * PX + i;
      const T* sb = s_in + b * vol;
      const T* wb = w + b * a.w_bstride + idx;
      T s, acc = g[b * a.g_bstride + idx];
      // only rows within the y reach of rows 0 and ny-1 (directly or
      // through the y wrap) read a row the pre-pass writes: they alone
      // take the extend map, in a loop of their own
      if (EXT && (R <= a.ry || R >= a.ny - 1 - a.ry)) {
        int sj = j, si = i;
        extend_src<BLOCK>(l, sj, si, a);
        s = sb[l * plane + (long long)sj * PX + si];
        for (int k = 0; k < a.K; ++k) {
          const int ll = wrap(l + a.dz[k], a.nz);
          int jj = wrap(j + a.dy[k], PY);
          int ii = wrap(i + a.dx[k], PX);
          extend_src<BLOCK>(ll, jj, ii, a);
          acc = acc + wb[k * a.w_kstride] *
                          sb[ll * plane + (long long)jj * PX + ii];
        }
      } else {
        s = sb[idx];
        for (int k = 0; k < a.K; ++k) {
          const int ll = wrap(l + a.dz[k], a.nz);
          const int jj = wrap(j + a.dy[k], PY);
          const int ii = wrap(i + a.dx[k], PX);
          acc = acc + wb[k * a.w_kstride] *
                          sb[ll * plane + (long long)jj * PX + ii];
        }
      }
      const T sel = (((l + R + C) & 1) == a.color) ? T(1) : T(0);
      const T r = (rel[b * a.rel_bstride + idx] * sel) * fac;
      out = s + r * (acc + w0[b * a.w0_bstride + idx] * s);
      s_out[b * vol + idx] = out;
    }
    if (partials != nullptr) {
      // per-block sum of |S_out| over this level's tile (out-of-range
      // threads, and in the block mode ghost cells, add 0), reduced in a
      // fixed order: warp shuffles, then the 8 warp sums by thread 0
      const int tid = threadIdx.y * SWEEP_BX + threadIdx.x;
      T v = out;
      if (BLOCK && ((unsigned)(j - a.gy) >= (unsigned)a.by ||
                    (unsigned)(i - a.gx) >= (unsigned)a.bx))
        v = T(0);
      v = warp_sum(v < T(0) ? -v : v);
      if ((tid & 31) == 0) warp_sums[tid >> 5] = v;
      __syncthreads();
      if (tid == 0) {
        T t = warp_sums[0];
        for (int q = 1; q < SWEEP_BX * SWEEP_BY / 32; ++q) t = t + warp_sums[q];
        if (!BLOCK) {
          partials[bz * gridDim.x * gridDim.y + blockIdx.y * gridDim.x +
                   blockIdx.x] = t;
        } else {
          const int pyb = (int)blockIdx.y - a.sy / SWEEP_BY;
          const int pxb = (int)blockIdx.x - a.sx / SWEEP_BX;
          const int nby = (a.by + SWEEP_BY - 1) / SWEEP_BY;
          const int nbx = (a.bx + SWEEP_BX - 1) / SWEEP_BX;
          if ((unsigned)pyb < (unsigned)nby && (unsigned)pxb < (unsigned)nbx)
            partials[(bz * nby + pyb) * nbx + pxb] = t;
        }
      }
      __syncthreads();  // warp_sums is reused by the next level
    }
  }
#undef PY
#undef PX
}

// The extend pre-pass (xinvert_tpu/solver.py:_apply_extend, 3-D branch), in
// place: on interior levels 1..nz-2 rows 0 and ny-1 copy rows 1 and ny-2;
// when x is not periodic the four corners copy the nearest interior cell of
// that row (S[l,1,1], S[l,1,nx-2], S[l,ny-2,1], S[l,ny-2,nx-2]).  One thread
// per (column, interior level, batch slice).  Race-free: rows 0 and ny-1
// are written, rows 1 and ny-2 are read, and nobody writes those.
template <typename T>
__global__ void sor3d_extend_rows_kernel(T* __restrict__ S, int nz, int ny,
                                         int nx, int periodic_x) {
  const int i = blockIdx.x * EXTEND_BX + threadIdx.x;
  if (i >= nx) return;
  const long long l = blockIdx.y + 1;
  T* s = S + ((long long)blockIdx.z * nz + l) * ny * nx;
#define AT(r, c) s[(long long)(r) * nx + (c)]
  int c = i;
  if (!periodic_x) c = i == 0 ? 1 : (i == nx - 1 ? nx - 2 : i);
  AT(0, i) = AT(1, c);
  AT(ny - 1, i) = AT(ny - 2, c);
#undef AT
}

// One axis of a block: owned [o, o + b) of the global n with g ghosts on
// each side; an axis without ghosts is the whole axis.
static bool block_axis_ok(int o, int b, int g, int n) {
  if (b < 1 || o < 0 || o + b > n || g < 0) return false;
  return g == 0 ? (o == 0 && b == n) : g < n;
}

// `blk` (oy, ox, by, bx, gy, gx) selects the block mode; nullptr the whole
// grid.
template <typename T>
static int launch_color_sweep(const T* s_in, T* s_out, const T* w,
                              const T* w0, const T* g, const T* rel,
                              T* partials, int B, int nz, int ny, int nx,
                              int K, const int* dz, const int* dy,
                              const int* dx, long long w_kstride,
                              long long w_bstride, long long w0_bstride,
                              long long g_bstride, long long rel_bstride,
                              int color, int extend, int periodic_x,
                              double fac, void* stream,
                              const int* blk = nullptr) {
  if (K < 0 || K > SOR3D_MAX_K || B < 1 || nz < 1 || ny < 1 || nx < 1 ||
      (color != 0 && color != 1) || (extend && (nz < 3 || ny < 3 || nx < 3)))
    return (int)cudaErrorInvalidValue;
  Sor3dArgs a;
  a.py = a.by = ny; a.px = a.bx = nx;
  a.oyb = a.oxb = a.gy = a.gx = a.sy = a.sx = 0;
  if (blk != nullptr) {
    if (!block_axis_ok(blk[0], blk[2], blk[4], ny) ||
        !block_axis_ok(blk[1], blk[3], blk[5], nx))
      return (int)cudaErrorInvalidValue;
    a.by = blk[2]; a.bx = blk[3]; a.gy = blk[4]; a.gx = blk[5];
    a.py = a.by + 2 * a.gy; a.px = a.bx + 2 * a.gx;
    a.oyb = blk[0] - a.gy; a.oxb = blk[1] - a.gx;
    a.sy = (a.gy + SWEEP_BY - 1) / SWEEP_BY * SWEEP_BY;
    a.sx = (a.gx + SWEEP_BX - 1) / SWEEP_BX * SWEEP_BX;
    if ((long long)a.py * a.px * nz >= (1LL << 31))
      return (int)cudaErrorInvalidValue;
  }
  // the launch grid: the buffer, from (sy, sx) before the owned region
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
#define SWEEP3D(E, BL)                                                      \
  sor3d_color_sweep_kernel<T, E, BL><<<grid, block, 0, st>>>(               \
      s_in, s_out, w, w0, g, rel, partials, a, (T)fac)
  if (blk != nullptr) {
    if (extend) SWEEP3D(true, true); else SWEEP3D(false, true);
  } else {
    if (extend) SWEEP3D(true, false); else SWEEP3D(false, false);
  }
#undef SWEEP3D
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_extend_rows(T* S, int B, int nz, int ny, int nx,
                              int periodic_x, void* stream) {
  if (B < 1 || B > MAX_GRID_YZ || nz < 3 || nz - 2 > MAX_GRID_YZ || ny < 3 ||
      nx < 3)
    return (int)cudaErrorInvalidValue;
  dim3 grid((nx + EXTEND_BX - 1) / EXTEND_BX, nz - 2, B);
  sor3d_extend_rows_kernel<T><<<grid, EXTEND_BX, 0, (cudaStream_t)stream>>>(
      S, nz, ny, nx, periodic_x);
  return (int)cudaGetLastError();
}

extern "C" {

// Number of |S| partials a color sweep writes per batch slice.
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

// B5s: one half-sweep of one ghost-padded block (the block mode, header):
// the buffer is (B, nz, by + 2gy, bx + 2gx), (ny, nx) the whole grid,
// (oy, ox) the owned region's global origin.
int sor3d_color_sweep_block_f32(const float* s_in, float* s_out,
                                const float* w, const float* w0,
                                const float* g, const float* rel,
                                float* partials, int B, int nz, int ny,
                                int nx, int oy, int ox, int by, int bx,
                                int gy, int gx, int K, const int* dz,
                                const int* dy, const int* dx,
                                long long w_kstride, long long w_bstride,
                                long long w0_bstride, long long g_bstride,
                                long long rel_bstride, int color, int extend,
                                int periodic_x, double fac, void* stream) {
  const int blk[6] = {oy, ox, by, bx, gy, gx};
  return launch_color_sweep<float>(s_in, s_out, w, w0, g, rel, partials, B,
                                   nz, ny, nx, K, dz, dy, dx, w_kstride,
                                   w_bstride, w0_bstride, g_bstride,
                                   rel_bstride, color, extend, periodic_x,
                                   fac, stream, blk);
}

int sor3d_color_sweep_block_f64(const double* s_in, double* s_out,
                                const double* w, const double* w0,
                                const double* g, const double* rel,
                                double* partials, int B, int nz, int ny,
                                int nx, int oy, int ox, int by, int bx,
                                int gy, int gx, int K, const int* dz,
                                const int* dy, const int* dx,
                                long long w_kstride, long long w_bstride,
                                long long w0_bstride, long long g_bstride,
                                long long rel_bstride, int color, int extend,
                                int periodic_x, double fac, void* stream) {
  const int blk[6] = {oy, ox, by, bx, gy, gx};
  return launch_color_sweep<double>(s_in, s_out, w, w0, g, rel, partials, B,
                                    nz, ny, nx, K, dz, dy, dx, w_kstride,
                                    w_bstride, w0_bstride, g_bstride,
                                    rel_bstride, color, extend, periodic_x,
                                    fac, stream, blk);
}

int sor3d_extend_rows_f32(float* S, int B, int nz, int ny, int nx,
                          int periodic_x, void* stream) {
  return launch_extend_rows<float>(S, B, nz, ny, nx, periodic_x, stream);
}

int sor3d_extend_rows_f64(double* S, int B, int nz, int ny, int nx,
                          int periodic_x, void* stream) {
  return launch_extend_rows<double>(S, B, nz, ny, nx, periodic_x, stream);
}

}  // extern "C"
