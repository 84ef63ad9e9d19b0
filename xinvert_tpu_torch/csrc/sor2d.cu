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
//     place (sor2d_color_sweep_inplace below).
// On Hopper the VMEM split between the first two has no meaning, so one
// pair of kernels serves every 2-D shape.  Not ported here: B2's
// sharded-block variants (pad_x, clamp_w/e, ext_bot, pad_lo).
//
// One full sweep is three launches on the caller's stream:
//   sor2d_extend_rows   (when the y boundary is 'extend'), in place on A;
//   sor2d_color_sweep   color 0 (red),   A -> B;
//   sor2d_color_sweep   color 1 (black), B -> A.
// A half-sweep reads only the pre-half-sweep state (ping-pong buffers):
// cross and +-2 offsets read same-color neighbours, and the reference sweep
// computes every term from the old state, so an in-place update would race
// and differ.  The in-place variant replaces the two color launches where
// no neighbour shares the cell's color (see its kernel).
//
// Arithmetic, per cell and in this order, for every cell (not only cells of
// the active color, so NaN/Inf propagate through 0*(...) exactly as in the
// plain version):
//   acc = g;  for k: acc = acc + w_k * S_in[(j+dy_k) mod ny, (i+dx_k) mod nx]
//   sel = ((j + i) & 1) == color ? 1 : 0
//   r = (rel * sel) * fac        (rel = omega*relax; fac = 1 for SOR, the
//                                 half-sweep's Chebyshev factor for cheby)
//   S_out = s + r * (acc + w0 * s)
// Built with -fmad=false, every product and sum rounds on its own, as the
// plain PyTorch ops do, so the kernels are bit-for-bit equal to the plain
// version in float and double.
//
// Bound: HBM bytes.  A half-sweep reads K+4 planes (S, w_k, w0, g, rel) and
// writes one, about 2*(K+5)*ny*nx*itemsize bytes per full sweep, at a few
// flops per byte.  This first version does nothing about that bound: no
// shared-memory tiling, no temporal blocking over several sweeps, no FMA
// contraction.  Those are later work.  x is the fastest thread index, so
// every plane is read coalesced.

#include <cuda_runtime.h>
#include <stdint.h>

#define SOR2D_MAX_K 16
#define SWEEP_BX 32
#define SWEEP_BY 8
#define EXTEND_BX 128

struct Sor2dArgs {
  int B, ny, nx, K, color;
  int dy[SOR2D_MAX_K];
  int dx[SOR2D_MAX_K];
  // element strides: between weight planes k, and between batch slices of
  // each plane (0 for a plane shared by the whole batch)
  long long w_kstride, w_bstride, w0_bstride, g_bstride, rel_bstride;
};

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// The update of cell (j, i) of slice b from the state sb, in the order of
// the header: shared by both color-sweep kernels, so their arithmetic is
// one and the same.
template <typename T>
__device__ __forceinline__ T cell_update(const T* sb, const T* w, const T* w0,
                                         const T* g, const T* rel,
                                         const Sor2dArgs& a, long long b,
                                         int j, int i, T s, T sel, T fac) {
  const long long idx = (long long)j * a.nx + i;
  T acc = g[b * a.g_bstride + idx];
  const T* wb = w + b * a.w_bstride + idx;
  for (int k = 0; k < a.K; ++k) {
    int jj = j + a.dy[k];
    int ii = i + a.dx[k];
    jj = jj < 0 ? jj + a.ny : (jj >= a.ny ? jj - a.ny : jj);
    ii = ii < 0 ? ii + a.nx : (ii >= a.nx ? ii - a.nx : ii);
    acc = acc + wb[k * a.w_kstride] * sb[(long long)jj * a.nx + ii];
  }
  const T r = (rel[b * a.rel_bstride + idx] * sel) * fac;
  return s + r * (acc + w0[b * a.w0_bstride + idx] * s);
}

// Per-block sum of |out| (out-of-range threads add 0) into slot
// (b, blockIdx.y, blockIdx.x) of partials, reduced in a fixed order: warp
// shuffles, then the 8 warp sums by thread 0.  Every thread of the block
// calls it.
template <typename T>
__device__ __forceinline__ void block_partial(T out, T* partials,
                                              long long b) {
  __shared__ T warp_sums[SWEEP_BX * SWEEP_BY / 32];
  const int tid = threadIdx.y * SWEEP_BX + threadIdx.x;
  T v = warp_sum(out < T(0) ? -out : out);
  if ((tid & 31) == 0) warp_sums[tid >> 5] = v;
  __syncthreads();
  if (tid == 0) {
    T t = warp_sums[0];
    for (int q = 1; q < SWEEP_BX * SWEEP_BY / 32; ++q) t = t + warp_sums[q];
    partials[b * gridDim.x * gridDim.y + blockIdx.y * gridDim.x + blockIdx.x] = t;
  }
}

template <typename T>
__global__ void sor2d_color_sweep_kernel(const T* __restrict__ s_in,
                                         T* __restrict__ s_out,
                                         const T* __restrict__ w,
                                         const T* __restrict__ w0,
                                         const T* __restrict__ g,
                                         const T* __restrict__ rel,
                                         T* __restrict__ partials,
                                         Sor2dArgs a, T fac) {
  const int i = blockIdx.x * SWEEP_BX + threadIdx.x;
  const int j = blockIdx.y * SWEEP_BY + threadIdx.y;
  const long long b = blockIdx.z;
  const long long plane = (long long)a.ny * a.nx;
  T out = T(0);
  if (i < a.nx && j < a.ny) {
    const long long idx = (long long)j * a.nx + i;
    const T* sb = s_in + b * plane;
    const T sel = (((j + i) & 1) == a.color) ? T(1) : T(0);
    out = cell_update(sb, w, w0, g, rel, a, b, j, i, sb[idx], sel, fac);
    s_out[b * plane + idx] = out;
  }
  if (partials != nullptr) block_partial(out, partials, b);
}

// B3, in place: one half-sweep of `color` on the one buffer S.  Only cells
// of the active color are computed and written, with the arithmetic above
// (sel = 1); the others keep their value, which is what the plain version
// gives them (s + 0*(...) == s) wherever their update term is finite.  On a
// state that already holds a NaN or an Inf the two may differ in which
// inactive cells turn NaN; the norm is then non-finite on both paths and
// the solve stops on overflow at the same check.
//
// No race: the wrapper takes only radius-1 stencils without cross terms, so
// each neighbour of an active cell has the other color and nobody writes it
// in this launch.  The wrapped reads keep that when the wrap joins cells of
// opposite parity: an even nx when x is periodic, an even ny when y is.  A
// non-periodic axis wraps only between its two boundary lines, which the
// sweep never updates (relax = 0 there), so whichever value such a read
// sees is the same one.  S carries no __restrict__: it is read and written.
//
// Bound: HBM bytes, as the pair.  A checkerboard write still dirties every
// 32-byte sector and every plane is read in whole sectors, so the launch
// moves the pair's bytes (K+4 planes read, one written); what it saves is
// the second state buffer.  Measured (NVIDIA H100 80GB HBM3, 700.00 W;
// chip_smoke.py phase 4): at 2048x2048 float32 it takes 1.20x the pair's
// time per sweep (65.0 against 54.2 ms per 500), and the pair's time
// (0.0275 against 0.0273 ms per launch) at 12x330x720, whose 40 MB stay in
// the L2.  The suspect, not
// measured: every sector it writes is half-written, and one that leaves
// the L2 half-written costs the memory a read-modify-write.  Writing the
// unchanged cells back too would make the sectors whole.
template <typename T>
__global__ void sor2d_color_sweep_inplace_kernel(T* S,
                                                 const T* __restrict__ w,
                                                 const T* __restrict__ w0,
                                                 const T* __restrict__ g,
                                                 const T* __restrict__ rel,
                                                 T* __restrict__ partials,
                                                 Sor2dArgs a, T fac) {
  const int i = blockIdx.x * SWEEP_BX + threadIdx.x;
  const int j = blockIdx.y * SWEEP_BY + threadIdx.y;
  const long long b = blockIdx.z;
  T out = T(0);
  if (i < a.nx && j < a.ny) {
    const long long idx = (long long)j * a.nx + i;
    T* sb = S + b * (long long)a.ny * a.nx;
    out = sb[idx];
    if (((j + i) & 1) == a.color) {
      out = cell_update<T>(sb, w, w0, g, rel, a, b, j, i, out, T(1), fac);
      sb[idx] = out;
    }
  }
  if (partials != nullptr) block_partial(out, partials, b);
}

// The extend pre-pass (xinvert_tpu/solver.py:_apply_extend, 2-D branches),
// in place.  One thread per (column, batch slice) walks its column's rows in
// the reference's order.  Race-free: the rows written (0, 1, ny-2, ny-1) are
// never read by another column's thread — the corner clamps read rows 1,
// ny-2 (one ring) or 2, ny-3 (two rings), which nobody writes.
template <typename T>
__global__ void sor2d_extend_rows_kernel(T* __restrict__ S, int ny, int nx,
                                         int periodic_x, int bih) {
  const int i = blockIdx.x * EXTEND_BX + threadIdx.x;
  if (i >= nx) return;
  T* s = S + (long long)blockIdx.y * ny * nx;
#define AT(r, c) s[(long long)(r) * nx + (c)]
  if (!bih) {
    if (periodic_x || (i > 0 && i < nx - 1)) {
      AT(0, i) = AT(1, i);
      AT(ny - 1, i) = AT(ny - 2, i);
    } else if (i == 0) {
      AT(0, 0) = AT(1, 1);
      AT(ny - 1, 0) = AT(ny - 2, 1);
    } else {
      AT(0, nx - 1) = AT(1, nx - 2);
      AT(ny - 1, nx - 1) = AT(ny - 2, nx - 2);
    }
  } else if (periodic_x) {
    // sequential reference semantics: S[0]=old S[1]; S[1]=S[2];
    // S[-1]=S[-2]=S[-3]
    AT(0, i) = AT(1, i);
    AT(1, i) = AT(2, i);
    const T v = AT(ny - 3, i);
    AT(ny - 1, i) = v;
    AT(ny - 2, i) = v;
  } else {
    // two-ring rows copy row 2 / ny-3; the 2x2 corner blocks clamp to the
    // nearest interior column (2 / nx-3) of that row
    const int c = i < 2 ? 2 : (i >= nx - 2 ? nx - 3 : i);
    const T top = AT(2, c);
    AT(0, i) = top;
    AT(1, i) = top;
    const T bot = AT(ny - 3, c);
    AT(ny - 1, i) = bot;
    AT(ny - 2, i) = bot;
  }
#undef AT
}

// s_in == nullptr selects the in-place kernel, on s_out.
template <typename T>
static int launch_color_sweep(const T* s_in, T* s_out, const T* w,
                              const T* w0, const T* g, const T* rel,
                              T* partials, int B, int ny, int nx, int K,
                              const int* dy, const int* dx,
                              long long w_kstride, long long w_bstride,
                              long long w0_bstride, long long g_bstride,
                              long long rel_bstride, int color, double fac,
                              void* stream) {
  if (K < 0 || K > SOR2D_MAX_K || B < 1 || B > 65535 || ny < 1 || nx < 1)
    return (int)cudaErrorInvalidValue;
  Sor2dArgs a;
  a.B = B; a.ny = ny; a.nx = nx; a.K = K; a.color = color;
  for (int k = 0; k < SOR2D_MAX_K; ++k) {
    a.dy[k] = k < K ? dy[k] : 0;
    a.dx[k] = k < K ? dx[k] : 0;
  }
  a.w_kstride = w_kstride; a.w_bstride = w_bstride;
  a.w0_bstride = w0_bstride; a.g_bstride = g_bstride;
  a.rel_bstride = rel_bstride;
  dim3 block(SWEEP_BX, SWEEP_BY, 1);
  dim3 grid((nx + SWEEP_BX - 1) / SWEEP_BX, (ny + SWEEP_BY - 1) / SWEEP_BY, B);
  // the caller computed fac in T, so the conversion back is exact
  if (s_in == nullptr)
    sor2d_color_sweep_inplace_kernel<T><<<grid, block, 0,
                                          (cudaStream_t)stream>>>(
        s_out, w, w0, g, rel, partials, a, (T)fac);
  else
    sor2d_color_sweep_kernel<T><<<grid, block, 0, (cudaStream_t)stream>>>(
        s_in, s_out, w, w0, g, rel, partials, a, (T)fac);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_extend_rows(T* S, int B, int ny, int nx, int periodic_x,
                              int bih, void* stream) {
  if (B < 1 || B > 65535 || ny < (bih ? 5 : 3) || nx < (bih ? 5 : 3))
    return (int)cudaErrorInvalidValue;
  dim3 grid((nx + EXTEND_BX - 1) / EXTEND_BX, B, 1);
  sor2d_extend_rows_kernel<T><<<grid, EXTEND_BX, 0, (cudaStream_t)stream>>>(
      S, ny, nx, periodic_x, bih);
  return (int)cudaGetLastError();
}

extern "C" {

// Number of |S| partials a color sweep writes per batch slice.
int sor2d_partials_per_slice(int ny, int nx) {
  return ((nx + SWEEP_BX - 1) / SWEEP_BX) * ((ny + SWEEP_BY - 1) / SWEEP_BY);
}

int sor2d_color_sweep_f32(const float* s_in, float* s_out, const float* w,
                          const float* w0, const float* g, const float* rel,
                          float* partials, int B, int ny, int nx, int K,
                          const int* dy, const int* dx, long long w_kstride,
                          long long w_bstride, long long w0_bstride,
                          long long g_bstride, long long rel_bstride,
                          int color, double fac, void* stream) {
  return launch_color_sweep<float>(s_in, s_out, w, w0, g, rel, partials, B,
                                   ny, nx, K, dy, dx, w_kstride, w_bstride,
                                   w0_bstride, g_bstride, rel_bstride, color,
                                   fac, stream);
}

int sor2d_color_sweep_f64(const double* s_in, double* s_out, const double* w,
                          const double* w0, const double* g,
                          const double* rel, double* partials, int B, int ny,
                          int nx, int K, const int* dy, const int* dx,
                          long long w_kstride, long long w_bstride,
                          long long w0_bstride, long long g_bstride,
                          long long rel_bstride, int color, double fac,
                          void* stream) {
  return launch_color_sweep<double>(s_in, s_out, w, w0, g, rel, partials, B,
                                    ny, nx, K, dy, dx, w_kstride, w_bstride,
                                    w0_bstride, g_bstride, rel_bstride, color,
                                    fac, stream);
}

int sor2d_color_sweep_inplace_f32(float* S, const float* w, const float* w0,
                                  const float* g, const float* rel,
                                  float* partials, int B, int ny, int nx,
                                  int K, const int* dy, const int* dx,
                                  long long w_kstride, long long w_bstride,
                                  long long w0_bstride, long long g_bstride,
                                  long long rel_bstride, int color,
                                  double fac, void* stream) {
  return launch_color_sweep<float>(nullptr, S, w, w0, g, rel, partials, B,
                                   ny, nx, K, dy, dx, w_kstride, w_bstride,
                                   w0_bstride, g_bstride, rel_bstride, color,
                                   fac, stream);
}

int sor2d_color_sweep_inplace_f64(double* S, const double* w,
                                  const double* w0, const double* g,
                                  const double* rel, double* partials, int B,
                                  int ny, int nx, int K, const int* dy,
                                  const int* dx, long long w_kstride,
                                  long long w_bstride, long long w0_bstride,
                                  long long g_bstride, long long rel_bstride,
                                  int color, double fac, void* stream) {
  return launch_color_sweep<double>(nullptr, S, w, w0, g, rel, partials, B,
                                    ny, nx, K, dy, dx, w_kstride, w_bstride,
                                    w0_bstride, g_bstride, rel_bstride, color,
                                    fac, stream);
}

int sor2d_extend_rows_f32(float* S, int B, int ny, int nx, int periodic_x,
                          int bih, void* stream) {
  return launch_extend_rows<float>(S, B, ny, nx, periodic_x, bih, stream);
}

int sor2d_extend_rows_f64(double* S, int B, int ny, int nx, int periodic_x,
                          int bih, void* stream) {
  return launch_extend_rows<double>(S, B, ny, nx, periodic_x, bih, stream);
}

}  // extern "C"
