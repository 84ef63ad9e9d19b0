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
// function, so one pair of kernels serves every 3-D shape.  Not ported
// here: B5's sharded-block variants (pad_row, pad_col, parity_off,
// clamp_w/e, pad_lo), which serve the multi-device executor.
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
};

__device__ __forceinline__ int wrap(int v, int n) {
  return v < 0 ? v + n : (v >= n ? v - n : v);
}

// The extend pre-pass's map (sor3d_extend_rows_kernel below) as a read:
// (l, j, i) -> the cell whose value the pre-pass leaves at (l, j, i).
__device__ __forceinline__ void extend_src(int l, int& j, int& i,
                                           const Sor3dArgs& a) {
  const int jc = min(max(j, 1), a.ny - 2);
  const bool moved = jc != j && (unsigned)(l - 1) < (unsigned)(a.nz - 2);
  const int ic = min(max(i, 1), a.nx - 2);
  j = moved ? jc : j;
  i = (moved && !a.periodic_x) ? ic : i;
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
        extend_src(l, sj, si, a);
        s = sb[l * plane + (long long)sj * a.nx + si];
        for (int k = 0; k < a.K; ++k) {
          const int ll = wrap(l + a.dz[k], a.nz);
          int jj = wrap(j + a.dy[k], a.ny);
          int ii = wrap(i + a.dx[k], a.nx);
          extend_src(ll, jj, ii, a);
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
      // threads add 0), reduced in a fixed order: warp shuffles, then the
      // 8 warp sums by thread 0
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
  const long long gy = (ny + SWEEP_BY - 1) / SWEEP_BY;
  if (gy > MAX_GRID_YZ) return (int)cudaErrorInvalidValue;
  Sor3dArgs a;
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
  dim3 grid((nx + SWEEP_BX - 1) / SWEEP_BX, (unsigned)gy,
            (unsigned)(n_bz < MAX_GRID_YZ ? n_bz : MAX_GRID_YZ));
  // the caller computed fac in T, so the conversion back is exact
  if (extend)
    sor3d_color_sweep_kernel<T, true><<<grid, block, 0,
                                        (cudaStream_t)stream>>>(
        s_in, s_out, w, w0, g, rel, partials, a, (T)fac);
  else
    sor3d_color_sweep_kernel<T, false><<<grid, block, 0,
                                         (cudaStream_t)stream>>>(
        s_in, s_out, w, w0, g, rel, partials, a, (T)fac);
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

int sor3d_extend_rows_f32(float* S, int B, int nz, int ny, int nx,
                          int periodic_x, void* stream) {
  return launch_extend_rows<float>(S, B, nz, ny, nx, periodic_x, stream);
}

int sor3d_extend_rows_f64(double* S, int B, int nz, int ny, int nx,
                          int periodic_x, void* stream) {
  return launch_extend_rows<double>(S, B, nz, ny, nx, periodic_x, stream);
}

}  // extern "C"
