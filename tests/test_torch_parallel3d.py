# -*- coding: utf-8 -*-
"""The 3-D multi-device layer of the PyTorch port
(xinvert_tpu_torch/parallel/halo_window3d.py, the 3-D block kernel's plain
version ``sor3d_color_sweep_block_reference``) on the CPU, float64, small
sizes, inputs from a numpy seed:

- the plain block version: blocks cut with wrapped rings of the k-sweep
  cone, k sweeps (two half-sweeps each, the extend pre-pass folded into
  the red one), stitched: torch.equal to the meshless plain sweeps, with
  row blocks at odd origins (72 rows over 8 blocks of 9), x splits with
  the extend corner clamps, a batch of per-slice planes and NaN rows; its
  owned |S| partials equal to the whole grid's; and a block spanning the
  whole grid equal to the folded whole-grid half-sweep;
- the executor: ``solve_fixed_halo_window3d`` torch.equal to
  ``solve_fixed``, ``solve_halo_window3d`` with the meshless iters, and
  ``solve_fixed_halo_window3d`` against the JAX package's own executor on
  4 row blocks (Pallas in interpret mode on its virtual CPU devices)
  within rtol 1e-11;
- ``invert_omega`` with ``iParams['mesh']`` equal to the meshless call.

The CUDA block kernel runs only on the card (tests/test_torch_cuda.py).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
from jax.sharding import Mesh as JMesh  # noqa: E402

from xinvert_tpu.parallel.halo_window3d import (  # noqa: E402
    solve_fixed_halo_window3d as jax_fixed3d)
from xinvert_tpu.parallel.scaling import (  # noqa: E402
    _omega_problem3 as jax_omega3)
import xinvert_tpu_torch as xt  # noqa: E402
from xinvert_tpu_torch import parallel as tpar  # noqa: E402
from xinvert_tpu_torch import solver as tsolver  # noqa: E402
from xinvert_tpu_torch.models import api as tapi  # noqa: E402
from xinvert_tpu_torch.ops import sor2d, sor3d  # noqa: E402
from xinvert_tpu_torch.parallel import halo, mesh as tmesh  # noqa: E402
from xinvert_tpu_torch.stencil import StencilSpec, _interior_mask  # noqa: E402

CPU = torch.device("cpu")
O3 = ((1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1), (0, 0, -1))


def cpu_mesh(shape, names):
    arr = np.empty(int(np.prod(shape)), dtype=object)
    arr[:] = [CPU] * arr.size
    return tmesh.Mesh(arr.reshape(shape), names)


def rand3(core, bcs, batch=0, per_slice=False, seed=0):
    rng = np.random.default_rng(seed)
    shape = ((batch,) + core) if (batch and per_slice) else core
    active = np.broadcast_to(_interior_mask(core, bcs, False), shape).copy()
    active &= rng.random(shape) > 0.05
    w = rng.uniform(0.05, 0.25, (6,) + shape) * active
    w0 = np.where(active, -1.05 * w.sum(0), 0.0)
    relax = np.where(active, 1.0 / np.where(active, -w0, 1.0), 0.0)
    g = rng.normal(0.0, 1.0, ((batch,) if batch else ()) + core) * active
    spec = StencilSpec.from_arrays(w, w0, g, relax, active, O3, bcs, False,
                                   False, device="cpu", dtype=torch.float64)
    S0 = torch.as_tensor(rng.normal(0.0, 1e-3,
                                    ((batch,) if batch else ()) + core))
    return spec, S0


def _split(n, sizes):
    out, o = [], 0
    for b in sizes:
        out.append((o, b))
        o += b
    assert o == n
    return out


def _nan_equal(a, b):
    na, nb = torch.isnan(a), torch.isnan(b)
    return torch.equal(na, nb) and torch.equal(torch.where(na, 0.0, a),
                                               torch.where(nb, 0.0, b))


CASES = {
    # 72 rows over 8 blocks of 9: parity on odd origins; no extend
    "rows_odd_origins": ((5, 72, 40), ("fixed", "fixed", "periodic"), 0,
                         False, [9] * 8, [40], 9, 4),
    # x splits with the extend corner clamps, row blocks, NaN rows
    "x_extend_corners": ((6, 33, 70), ("fixed", "extend", "fixed"), 0,
                         False, [11, 11, 11], [35, 35], 5, 2),
    # a batch of per-slice planes, extend rows, short last blocks
    "batch": ((6, 40, 72), ("fixed", "extend", "periodic"), 2, True,
              [16, 24], [32, 32, 8], 7, 3),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_blocks_stitched_equal_meshless(case):
    core, bcs, batch, ps, ys, xs, n, k = CASES[case]
    spec, S0 = rand3(core, bcs, batch, ps, seed=len(case))
    S0[..., 1:-1, 0, :] = float("nan")       # the extend rows (overwritten)
    nz, ny, nx = core
    e = 1 if bcs[1] == "extend" else 0
    ex = e if bcs[2] != "periodic" else 0
    fac = [1.0 + 0.01 * i for i in range(2 * n)]
    for f, om in ((None, 1.3), (fac, 1.0)):
        S, done = S0.clone(), 0
        while done < n:
            m = min(k, n - done)
            new = torch.empty_like(S)
            parts = torch.zeros((max(batch, 1), nz, -(-ny // 8),
                                 -(-nx // 32)), dtype=S.dtype)
            for oy, by in _split(ny, ys):
                for ox, bx in _split(nx, xs):
                    g = (0 if by == ny else 2 * k + e,
                         0 if bx == nx else 2 * k + ex)
                    A = halo.padded_block(S, (oy, ox), (by, bx), g)
                    bspec = halo.padded_block_spec(spec, (oy, ox), (by, bx),
                                                   g)
                    sweep = sor3d.make_block_sweeper(bspec, A, om, (oy, ox),
                                                     (ny, nx), g, k)
                    A, part = sweep(
                        A, torch.empty_like(A), m,
                        None if f is None else f[2 * done:2 * (done + m)],
                        with_norm=True)
                    new[..., oy:oy + by, ox:ox + bx] = A[
                        ..., g[0]:g[0] + by, g[1]:g[1] + bx]
                    if oy % 8 == 0 and ox % 32 == 0:
                        parts[:, :, oy // 8:oy // 8 + part.shape[-2],
                              ox // 32:ox // 32 + part.shape[-1]] = part
            S, done = new, done + m
        ref = tsolver.sweeps(spec, S0, om, n, f)
        assert _nan_equal(S, ref), f is None
    aligned = all(o % 8 == 0 for o, _ in _split(ny, ys)) and all(
        o % 32 == 0 for o, _ in _split(nx, xs))
    if aligned:
        whole = sor2d.block_partials(ref).reshape(parts.shape)
        assert _nan_equal(parts, whole)


def test_whole_grid_block_is_the_folded_half_sweep():
    spec, S0 = rand3((5, 17, 23), ("fixed", "extend", "fixed"), 2, True,
                     seed=9)
    rel = sor3d.relax_plane(spec, 1.3)
    for color, ext in ((0, True), (1, False)):
        out = sor3d.sor3d_color_sweep_block(spec, S0, rel, color, (0, 0),
                                            (17, 23), (0, 0), 1.1, ext)
        ref = sor3d.sor3d_color_sweep_reference(spec, S0, rel, color, 1.1,
                                                ext)
        assert torch.equal(out, ref)


@pytest.mark.parametrize("shape,names", [((8,), ("y",)), ((2, 2), ("y", "x")),
                                         ((2, 1, 3), ("batch", "y", "x"))])
def test_executor_3d_equals_meshless(shape, names):
    spec, S0 = rand3((6, 72, 96), ("fixed", "extend", "fixed"), 2, True,
                     seed=4)
    mesh = cpu_mesh(shape, names)
    assert tpar.halo_window3d_applicable(spec, S0.shape, mesh)
    assert not tpar.halo_window_applicable(spec, S0.shape, mesh)
    ref = tsolver.solve_fixed(spec, S0, 1.3, 9)
    assert torch.equal(tpar.solve_fixed_halo_window3d(spec, S0, 1.3, 9,
                                                      mesh=mesh), ref)
    r0 = tsolver.solve(spec, S0, 1.3, tol=1e-3, max_iters=200,
                       check_every=4)
    r1 = tpar.solve_halo_window3d(spec, S0, 1.3, 1e-3, 200, check_every=4,
                                  mesh=mesh)
    assert torch.equal(r1.iters, r0.iters) and int(r0.iters.max()) < 200
    torch.testing.assert_close(r1.S, r0.S, rtol=1e-11, atol=1e-15)


def test_fixed_3d_matches_jax_executor():
    """JAX's solve_fixed_halo_window3d on 4 row blocks of 9 (odd origins,
    its parity_off variants) against the port's on a ('y',) mesh of 4, 4
    sweeps (one JAX step variant: its interpret-mode compile grows with
    each variant)."""
    js, jS = jax_omega3(12, 36, 32, np.float64)
    jS = jS + 1e-3
    jmesh = JMesh(np.array(jax.devices()[:4]).reshape(4), ("y",))
    ref = np.asarray(jax_fixed3d(js, jS, 1.2, 4, mesh=jmesh))
    spec = StencilSpec.from_arrays(
        np.asarray(js.w), np.asarray(js.w0), np.asarray(js.g),
        np.asarray(js.relax), np.asarray(js.active), js.offsets, js.bcs,
        js.bih, js.stop_on_zero_norm, device="cpu", dtype=torch.float64)
    out = tpar.solve_fixed_halo_window3d(
        spec, torch.as_tensor(np.array(jS)), 1.2, 4,
        mesh=cpu_mesh((4,), ("y",)))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-11,
                               atol=1e-11 * np.abs(ref).max())


def test_invert_omega_on_a_mesh():
    dtype = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        rng = np.random.default_rng(3)
        lev = np.linspace(100000.0, 20000.0, 9)
        lat = np.linspace(-60.0, 60.0, 24)
        lon = np.linspace(0.0, 355.0, 72)
        F = xt.Field(rng.normal(0.0, 1e-15, (9, 24, 72)),
                     ("LEV", "lat", "lon"),
                     {"LEV": lev, "lat": lat, "lon": lon})
        iP = {"BCs": ["fixed", "fixed", "periodic"], "mxLoop": 200,
              "tolerance": 1e-4, "checkEvery": 4, "printInfo": False}
        kw = dict(dims=["LEV", "lat", "lon"], mParams={"N2": 1e-4},
                  device="cpu")
        ref = xt.invert_omega(F, iParams=iP, **kw)
        it = tapi.LAST_SOLVE.iters.clone()
        out = xt.invert_omega(F, iParams=dict(iP, mesh=cpu_mesh(
            (2, 1), ("y", "x"))), **kw)
        assert torch.equal(tapi.LAST_SOLVE.iters, it) and int(it) < 200
        np.testing.assert_allclose(out.values, ref.values, rtol=1e-11,
                                   atol=1e-15)
    finally:
        torch.set_default_dtype(dtype)
