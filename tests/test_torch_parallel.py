# -*- coding: utf-8 -*-
"""The multi-device layer of the PyTorch port (xinvert_tpu_torch/parallel,
the 2-D block kernel's plain version) against xinvert_tpu's on the CPU, in
float64 at small sizes, inputs made from a numpy seed:

- meshes: ``make_grid_mesh``'s factors and ``problem_pspecs``'s axis
  tuples equal to the JAX package's; the block layout (aligned for checked
  solves, even for fixed counts) and its refusals;
- the plain block version (``sor2d_sweeps_block_reference``): blocks cut
  with wrapped ghost rings, swept, stitched, torch.equal to the meshless
  plain sweeps (y splits at odd origins, x splits with the extend corner
  clamps, the biharmonic on a row mesh, a batch, short last blocks, NaN in
  the wrapped boundary lines), and its |S| partials to the whole grid's;
- the block executor on local meshes of CPU devices: fixed counts
  torch.equal to ``solve_fixed`` (every fixed entry, k_sweeps included),
  checked solves with the meshless solve's iters (change, residual,
  cheby, a batch with frozen slices); against the JAX package's
  ``_solve_fixed_xla`` within rtol 1e-11;
- against the JAX package's own sharded executors (8 virtual CPU devices,
  Pallas in interpret mode, as its tests run them): ``solve_halo_window``
  on a 2x2 mesh under the residual rule, and ``invert_Poisson`` with
  ``iParams['mesh']`` on 2x2 meshes (the change rule, through the same
  executor), equal iters and overflow, fields within rtol 1e-11;
- the API: the mesh route, ``solve_refined(mesh=...)``, what stays
  unported (lexico and multigrid on a mesh, ROADMAP item 17);
- two gloo processes: ``solve_halo_window`` on a distributed mesh equal
  to the local mesh's, torch.equal (60 s limit);
- ``scaling_bench``'s schema and ``initialize_distributed`` in one process.

The CUDA block kernels run only on the card (tests/test_torch_cuda.py).
"""
import dataclasses
import socket

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh as JMesh  # noqa: E402

from __graft_entry__ import _poisson_problem as jax_poisson  # noqa: E402
import xinvert_tpu as xv  # noqa: E402
from xinvert_tpu import parallel as jpar  # noqa: E402
from xinvert_tpu.models import api as japi  # noqa: E402
from xinvert_tpu.parallel.halo_window import (  # noqa: E402
    solve_halo_window as jax_solve_halo_window)
from xinvert_tpu.solver import _solve_fixed_xla  # noqa: E402
import xinvert_tpu_torch as xt  # noqa: E402
from xinvert_tpu_torch import parallel as tpar  # noqa: E402
from xinvert_tpu_torch import solver as tsolver  # noqa: E402
from xinvert_tpu_torch.models import api as tapi  # noqa: E402
from xinvert_tpu_torch.ops import sor2d  # noqa: E402
from xinvert_tpu_torch.parallel import halo, mesh as tmesh  # noqa: E402
from xinvert_tpu_torch.stencil import StencilSpec, _interior_mask  # noqa: E402

CPU = torch.device("cpu")
P4 = ((1, 0), (-1, 0), (0, 1), (0, -1))
X8 = P4 + ((1, 1), (-1, -1), (1, -1), (-1, 1))
BIH = ((2, 0), (1, 0), (-1, 0), (-2, 0), (0, 2), (0, 1), (0, -1), (0, -2),
       (2, 2), (2, -2), (-2, 2), (-2, -2), (1, 1), (-1, 1), (1, -1), (-1, -1))
RTOL = 1e-11


def cpu_mesh(shape, names):
    arr = np.empty(int(np.prod(shape)), dtype=object)
    arr[:] = [CPU] * arr.size
    return tmesh.Mesh(arr.reshape(shape), names)


def jax_mesh(shape, names):
    n = int(np.prod(shape))
    return JMesh(np.array(jax.devices()[:n]).reshape(shape), names)


def port_spec(js, dtype=torch.float64):
    return StencilSpec.from_arrays(
        np.asarray(js.w), np.asarray(js.w0), np.asarray(js.g),
        np.asarray(js.relax), np.asarray(js.active), js.offsets, js.bcs,
        js.bih, js.stop_on_zero_norm, device="cpu", dtype=dtype)


def rand_spec(core, offs, bcs, bih=False, batch=0, per_slice=False, seed=0):
    """Random diagonally dominant planes (a few cells masked)."""
    rng = np.random.default_rng(seed)
    shape = ((batch,) + core) if (batch and per_slice) else core
    active = np.broadcast_to(_interior_mask(core, bcs, bih), shape).copy()
    active &= rng.random(shape) > 0.05
    w = rng.uniform(0.05, 0.25, (len(offs),) + shape) * active
    w0 = np.where(active, -1.05 * w.sum(0), 0.0)
    relax = np.where(active, 1.0 / np.where(active, -w0, 1.0), 0.0)
    g = rng.normal(0.0, 1.0, ((batch,) if batch else ()) + core) * active
    spec = StencilSpec.from_arrays(w, w0, g, relax, active, offs, bcs, bih,
                                   False, device="cpu", dtype=torch.float64)
    S0 = torch.as_tensor(rng.normal(0.0, 1e-3,
                                    ((batch,) if batch else ()) + core))
    return spec, S0


@pytest.fixture
def f64():
    dtype = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(dtype)


# ------------------------------------------------------------------ meshes

@pytest.mark.parametrize("n,batch", [(1, 1), (2, 1), (3, 1), (4, 1),
                                     (6, 2), (8, 1), (8, 2), (8, 4)])
def test_make_grid_mesh_factors_match_jax(n, batch):
    j = jpar.make_grid_mesh(n_devices=n, batch=batch)
    t = tpar.make_grid_mesh(batch=batch, devices=[CPU] * n)
    assert dict(t.shape) == dict(j.shape)
    assert t.axis_names == tuple(j.axis_names)
    assert not t.distributed
    with pytest.raises(ValueError):
        tpar.make_grid_mesh(batch=batch + 1 if n % (batch + 1) else 5,
                            devices=[CPU] * n)


@pytest.mark.parametrize("core,g_batch,bnd", [
    ((8, 12), (), 0), ((8, 12), (3,), 1), ((4, 8, 12), (2,), 1),
    ((12,), (), 0)])
def test_problem_pspecs_match_jax(core, g_batch, bnd):
    """Specs of each rank, the forcing (and state) batched or not; the
    planes' shapes alone decide the axis tuples."""
    from xinvert_tpu import stencil as jst
    nd = len(core)
    ones = np.ones(core)
    js = jst.StencilSpec(w=np.ones((2 * nd,) + core), w0=ones,
                         g=np.ones(g_batch + core), relax=ones,
                         active=ones.astype(bool),
                         offsets=tuple(((0,) * nd,) * (2 * nd)),
                         bcs=("fixed",) * nd)
    jspecs, js_s = jpar.problem_pspecs(js, bnd)
    tspecs, ts_s = tpar.problem_pspecs(port_spec(js), bnd)
    assert ts_s == tuple(js_s)
    for name in ("w", "w0", "g", "relax", "active"):
        assert getattr(tspecs, name) == tuple(getattr(jspecs, name)), name


def test_block_layout():
    assert tmesh.block_sizes(330, 2, 8) == [168, 162]
    assert tmesh.block_sizes(720, 2, 32) == [384, 336]
    assert tmesh.block_sizes(72, 8, 1) == [9] * 8
    assert tmesh.block_sizes(2048, 3, 8) == [688, 680, 680]
    assert tmesh.block_sizes(72, 4, 8) == [24, 16, 16, 16]
    assert tmesh.block_sizes(37, 4, 1) == [10, 9, 9, 9]
    with pytest.raises(ValueError):
        tmesh.block_sizes(60, 10, 8)       # a block would be empty
    spec, S0 = rand_spec((40, 64), P4, ("extend", "periodic"))
    dec = halo.Decomposition(spec, (3, 40, 64), cpu_mesh((1, 3, 1), (
        "batch", "y", "x")), checked=True)
    # rows 16, 16, 8: k comes down until the 8-row block is thicker than
    # its ring (extend: by > 2k + 1)
    assert dec.ys == [16, 16, 8] and dec.xs == [64]
    assert (dec.k, dec.gy, dec.gx) == (3, 7, 0)
    with pytest.raises(ValueError, match="thinner"):
        halo.Decomposition(spec, (34, 64),
                           cpu_mesh((5,), ("y",)), checked=True)
    with pytest.raises(ValueError, match="batch"):
        halo.Decomposition(spec, (3, 40, 64), cpu_mesh((2, 1), (
            "batch", "y")))
    assert not tpar.halo_window_applicable(spec, (40, 64),
                                           cpu_mesh((8,), ("y",)))
    assert tpar.halo_window_applicable(spec, (40, 64),
                                       cpu_mesh((2, 2), ("y", "x")))


def test_shard_problem_blocks():
    """Each block of a ('batch', 'y', 'x') mesh takes its batch slices, rows
    and columns of the state and of every plane (per-slice planes split
    with the batch, shared ones not)."""
    spec, S0 = rand_spec((40, 96), X8, ("extend", "fixed"), batch=4,
                         per_slice=True, seed=2)
    spec = dataclasses.replace(spec, w0=spec.w0[0])      # a shared plane
    S0 = S0.reshape(2, 2, 40, 96)
    blocks = tpar.shard_problem(spec, S0, cpu_mesh((2, 2, 2), (
        "batch", "y", "x")))
    assert len(blocks) == 8
    whole = torch.empty_like(S0).reshape(4, 40, 96)
    for b, bspec, bS in blocks:
        rows, cols = slice(b.oy, b.oy + b.by), slice(b.ox, b.ox + b.bx)
        whole[b.b0:b.b1, rows, cols] = bS
        assert torch.equal(bspec.w, spec.w[:, b.b0:b.b1, rows, cols])
        assert torch.equal(bspec.g, spec.g[b.b0:b.b1, rows, cols])
        assert torch.equal(bspec.w0, spec.w0[rows, cols])
    assert torch.equal(whole.reshape(S0.shape), S0)
    assert sorted({(b.oy, b.by) for b, _, _ in blocks}) == [(0, 24),
                                                            (24, 16)]


# ------------------------------------------------------ plain block version

def _stitched(spec, S, omega, n, k, ys, xs, fac=None):
    """n sweeps of S as blocks: every k sweeps each block (rows ys, cols xs
    as (origin, extent) lists) is cut with wrapped rings of the k-sweep
    cone, swept by the plain block version, and its owned cells stitched
    back; also the last step's partials, assembled in the grid's layout
    where the origins are aligned."""
    ny, nx = S.shape[-2:]
    r = sor2d._radius(spec)
    ey, ex = sor2d._extend_reach(spec)
    done, parts = 0, None
    while done < n:
        m = min(k, n - done)
        new = torch.empty_like(S)
        parts = torch.zeros(S.reshape(-1, ny, nx).shape[0], -(-ny // 8),
                            -(-nx // 32), dtype=S.dtype)
        for oy, by in ys:
            for ox, bx in xs:
                g = (0 if by == ny else 2 * r * k + ey,
                     0 if bx == nx else 2 * r * k + ex)
                P = halo.padded_block(S, (oy, ox), (by, bx), g)
                bspec = halo.padded_block_spec(spec, (oy, ox), (by, bx), g)
                f = None if fac is None else fac[2 * done:2 * (done + m)]
                own, part = sor2d.sor2d_sweeps_block_reference(
                    bspec, P, omega, m, (oy, ox), (ny, nx), g, f, True)
                new[..., oy:oy + by, ox:ox + bx] = own
                if oy % 8 == 0 and ox % 32 == 0:
                    parts[:, oy // 8:oy // 8 + part.shape[-2],
                          ox // 32:ox // 32 + part.shape[-1]] = part
        S = new
        done += m
    return S, parts


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


PLAIN_CASES = {
    # y splits at odd origins, (extend, periodic), x whole
    "y_odd_origins": ((45, 70), P4, ("extend", "periodic"), False, 0, False,
                      [13, 17, 15], [70], 9, 4),
    # x splits with the extend corner clamps (extend, fixed), cross terms
    "x_extend_corners": ((37, 96), X8, ("extend", "fixed"), False, 0, False,
                         [16, 21], [32, 32, 32], 7, 3),
    # the biharmonic on a row mesh, periodic and fixed x
    "bih_rows_periodic": ((33, 38), BIH, ("extend", "periodic"), True, 0,
                          False, [11, 11, 11], [38], 3, 1),
    "bih_rows_fixed": ((40, 30), BIH, ("extend", "fixed"), True, 2, True,
                       [16, 24], [30], 3, 1),
    # a batch with per-slice planes, short last blocks on both axes
    "batch_short_last": ((40, 72), X8, ("fixed", "periodic"), False, 3,
                         True, [16, 16, 8], [32, 32, 8], 5, 2),
}


@pytest.mark.parametrize("case", sorted(PLAIN_CASES))
def test_plain_blocks_stitched_equal_meshless(case):
    core, offs, bcs, bih, batch, ps, ys, xs, n, k = PLAIN_CASES[case]
    spec, S0 = rand_spec(core, offs, bcs, bih, batch, ps, seed=len(case))
    S0[..., 0, :] = float("nan")          # the wrapped boundary lines
    S0[..., -1, :] = float("nan")
    fac = [1.0 + 0.01 * i for i in range(2 * n)]
    for f, om in ((None, 1.3), (fac, 1.0)):
        out, parts = _stitched(spec, S0, om, n, k, _split(core[0], ys),
                               _split(core[1], xs), f)
        ref = tsolver.sweeps(spec, S0, om, n, f)
        assert _nan_equal(out, ref), f is None
    aligned = all(o % 8 == 0 for o, _ in _split(core[0], ys)) and all(
        o % 32 == 0 for o, _ in _split(core[1], xs))
    if aligned:
        assert _nan_equal(parts, sor2d.block_partials(ref))


def test_whole_grid_block_is_the_plain_sweeps():
    spec, S0 = rand_spec((37, 53), X8, ("extend", "fixed"), batch=2,
                         per_slice=True, seed=4)
    out = sor2d.sor2d_sweeps_block(spec, S0, 1.4, 5, (0, 0), (37, 53),
                                   (0, 0))
    assert torch.equal(out, tsolver.sweeps(spec, S0, 1.4, 5))
    with pytest.raises(ValueError, match="whole axis"):
        sor2d.sor2d_sweeps_block(spec, S0[..., :20, :], 1.4, 1, (3, 0),
                                 (37, 53), (0, 0))


# ------------------------------------------------------- the block executor

FIXED_MESHES = [((2, 2), ("y", "x")), ((4,), ("y",)), ((3,), ("x",)),
                ((2, 2, 1), ("batch", "y", "x")), ((1, 3, 2),
                                                   ("batch", "y", "x"))]


@pytest.mark.parametrize("shape,names", FIXED_MESHES)
def test_fixed_entries_equal_solve_fixed(shape, names):
    spec, S0 = rand_spec((45, 100), X8, ("extend", "fixed"), batch=2,
                         per_slice=True, seed=7)
    mesh = cpu_mesh(shape, names)
    ref = tsolver.solve_fixed(spec, S0, 1.4, 11)
    assert torch.equal(tpar.solve_fixed_halo_window(spec, S0, 1.4, 11,
                                                    mesh=mesh), ref)
    assert torch.equal(tpar.solve_fixed_sharded(spec, S0, 11, mesh=mesh,
                                                omega=1.4), ref)
    for k in (1, 3):
        assert torch.equal(tpar.solve_fixed_halo(spec, S0, 1.4, 11,
                                                 mesh=mesh, k_sweeps=k), ref)


def test_traffic_counter():
    """Bytes per sweep: each block receives 2 gx columns of its rows, then
    2 gy rows of its column-padded width, once every k sweeps."""
    spec, S0 = rand_spec((64, 96), P4, ("extend", "periodic"), seed=1)
    tpar.solve_fixed_halo(spec, S0, 1.4, 8, mesh=cpu_mesh((2, 3), (
        "y", "x")), k_sweeps=2)
    g = 2 * 2 + 1                                  # r 1, k 2, the extend
    gx = 2 * 2
    per_block = 2 * gx * 32 + 2 * g * (32 + 2 * gx)
    assert halo.last_traffic_bytes_per_iter() == 6 * per_block * 8 // 2


def test_traffic_counter_remainder_step():
    """A step of fewer than k sweeps (9 sweeps at k 2 end in a step of 1)
    reports its exchange over the sweeps it ran."""
    spec, S0 = rand_spec((64, 96), P4, ("extend", "periodic"), seed=1)
    tpar.solve_fixed_halo(spec, S0, 1.4, 9, mesh=cpu_mesh((2, 3), (
        "y", "x")), k_sweeps=2)
    g = 2 * 2 + 1
    gx = 2 * 2
    per_block = 2 * gx * 32 + 2 * g * (32 + 2 * gx)
    assert halo.last_traffic_bytes_per_iter() == 6 * per_block * 8


def test_fixed_matches_jax_solve_fixed_xla():
    js, jS0, grid = jax_poisson(batch=2, ny=48, nx=96, dtype=np.float64)
    ref = np.asarray(_solve_fixed_xla(js, jS0, grid.omega_opt, 13))
    out = tpar.solve_fixed_halo_window(
        port_spec(js), torch.as_tensor(np.asarray(jS0)), grid.omega_opt, 13,
        mesh=cpu_mesh((2, 2, 1), ("batch", "y", "x")))
    np.testing.assert_allclose(out.numpy(), ref, rtol=RTOL,
                               atol=RTOL * np.abs(ref).max())


@pytest.mark.parametrize("tol_type,scheme,tol,scale", [
    ("change", "sor", 1e-4, 0.0), ("residual", "sor", 1e-3, 0.5),
    ("change", "cheby", 1e-4, 0.0)])
def test_checked_equals_meshless(tol_type, scheme, tol, scale):
    """Batched, the slices stopping at different checks (the first ones
    frozen while the others sweep on): the meshless solve's iters, and its
    field (the same sweeps; the norms' last bits may differ on the CPU,
    where the meshless plain path sums with torch.sum)."""
    spec, S0 = rand_spec((48, 64), P4, ("extend", "periodic"), batch=3,
                         seed=3)
    spec = dataclasses.replace(spec, g=spec.g * torch.tensor(
        [1.0, scale, 2.0])[:, None, None])
    mesh = cpu_mesh((1, 2, 2), ("batch", "y", "x"))
    kw = dict(omega=1.5, tol=tol, max_iters=400, check_every=8,
              scheme=scheme, tol_type=tol_type)
    ref = tsolver.solve(spec, S0, **kw)
    out = tpar.solve_sharded(spec, S0, mesh, **kw)
    assert torch.equal(out.iters, ref.iters) and int(ref.iters.max()) < 400
    assert torch.equal(out.overflow, ref.overflow)
    torch.testing.assert_close(out.S, ref.S, rtol=RTOL, atol=1e-15)
    torch.testing.assert_close(out.rel_change, ref.rel_change, rtol=1e-9,
                               atol=0)


# --------------------------------------------- against JAX's sharded runs

def test_solve_halo_window_residual_matches_jax():
    js, jS0, grid = jax_poisson(batch=0, ny=128, nx=256, dtype=np.float64)
    jr = jax_solve_halo_window(js, jS0, grid.omega_opt, 0.3, 200,
                               check_every=2,
                               mesh=jax_mesh((2, 2), ("y", "x")),
                               tol_type="residual")
    tr = tpar.solve_halo_window(port_spec(js),
                                torch.zeros(128, 256, dtype=torch.float64),
                                grid.omega_opt, 0.3, 200, check_every=2,
                                mesh=cpu_mesh((2, 2), ("y", "x")),
                                tol_type="residual")
    assert int(tr.iters) == int(jr.iters) < 200
    assert bool(tr.overflow) == bool(jr.overflow)
    ref = np.asarray(jr.S)
    np.testing.assert_allclose(tr.S.numpy(), ref, rtol=RTOL,
                               atol=RTOL * np.abs(ref).max())


def _vor(pkg, ny, nx, nb):
    rng = np.random.default_rng(2)
    lat = np.linspace(-88.75, 88.75, ny)
    lon = np.linspace(0.0, 360.0 - 360.0 / nx, nx)
    v = (np.sin(3 * np.deg2rad(lon))[None, :]
         * np.cos(2 * np.deg2rad(lat))[:, None]
         + 0.1 * rng.standard_normal((nb, ny, nx)))
    v[:, ny // 3:ny // 2, nx // 4:nx // 2] = np.nan
    return pkg.Field(v * 1e-5, ("time", "lat", "lon"),
                     {"time": np.arange(nb), "lat": lat, "lon": lon})


def test_invert_Poisson_mesh_matches_jax(f64):
    """The change rule through the JAX package's windowed executor on a
    ('batch', 'y', 'x') = (1, 2, 2) mesh and through the port's block
    executor on the same axes."""
    iP = {"BCs": ["extend", "periodic"], "undef": np.nan, "mxLoop": 200,
          "tolerance": 3e-3, "checkEvery": 2, "printInfo": False}
    names = ("batch", "y", "x")
    sj = xv.invert_Poisson(_vor(xv, 128, 256, 1), dims=["lat", "lon"],
                           iParams=dict(iP, mesh=jax_mesh((1, 2, 2), names)))
    st = xt.invert_Poisson(_vor(xt, 128, 256, 1), dims=["lat", "lon"],
                           iParams=dict(iP, mesh=cpu_mesh((1, 2, 2), names)),
                           device="cpu")
    np.testing.assert_array_equal(tapi.LAST_SOLVE.iters.numpy(),
                                  np.asarray(japi.LAST_SOLVE.iters))
    np.testing.assert_array_equal(tapi.LAST_SOLVE.overflow.numpy(),
                                  np.asarray(japi.LAST_SOLVE.overflow))
    assert int(tapi.LAST_SOLVE.iters.max()) < 200
    ok = ~np.isnan(sj.values)
    np.testing.assert_array_equal(np.isnan(st.values), ~ok)
    np.testing.assert_allclose(st.values[ok], sj.values[ok], rtol=RTOL,
                               atol=RTOL * np.abs(sj.values[ok]).max())


# ------------------------------------------------------------------- API

def test_invert_mesh_routes_and_equals_meshless(f64):
    """Every route of ``_invert`` with a mesh (the 2-D executor, cheby and a
    partial ('x',) mesh through solve_sharded, the refined rounds) gives
    the meshless call's iters and field on the CPU."""
    f = _vor(xt, 40, 96, 2)
    base = {"BCs": ["extend", "periodic"], "undef": np.nan, "mxLoop": 300,
            "tolerance": 1e-5, "checkEvery": 8, "printInfo": False}
    for extra, mesh in (({}, cpu_mesh((2, 2), ("y", "batch"))),
                        ({"scheme": "cheby", "optArg": 1.5},
                         cpu_mesh((3,), ("x",))),
                        ({"tolType": "residual", "tolerance": 1e-2},
                         cpu_mesh((2, 1, 1), ("batch", "y", "x")))):
        iP = dict(base, **extra)
        ref = xt.invert_Poisson(f, dims=["lat", "lon"], iParams=iP,
                                device="cpu")
        it = tapi.LAST_SOLVE.iters.clone()
        out = xt.invert_Poisson(f, dims=["lat", "lon"],
                                iParams=dict(iP, mesh=mesh), device="cpu")
        assert torch.equal(tapi.LAST_SOLVE.iters, it), extra
        np.testing.assert_allclose(out.values, ref.values, rtol=RTOL,
                                   atol=1e-15)
    with pytest.raises(ValueError, match="batch"):
        xt.invert_Poisson(f, dims=["lat", "lon"], device="cpu",
                          iParams=dict(base, mesh=cpu_mesh((2,), ("z",))))


def test_refined_on_a_mesh(f64):
    """solve_refined(mesh=...): the meshless rounds, a certificate below
    tol (the inner solves on the blocks), the per-cell compensated
    residual of the blocks equal to the meshless one."""
    from xinvert_tpu_torch.ops.compensated import residual_compensated
    torch.set_default_dtype(torch.float32)
    spec, S0, grid = tpar.scaling._poisson_problem(32, 64, torch.float32,
                                                   CPU)
    mesh = cpu_mesh((2, 2), ("y", "x"))
    a = xt.solve_refined(spec, S0, grid.omega_opt, tol=1e-6, inner_tol=1e-2,
                         inner_iters=1000)
    b = xt.solve_refined(spec, S0, grid.omega_opt, tol=1e-6, inner_tol=1e-2,
                         inner_iters=1000, mesh=mesh)
    assert a.rounds == b.rounds >= 1
    assert float(b.rel_residual) <= 1e-6
    lo = torch.full_like(b.S_hi, 1e-9)
    assert torch.equal(halo.residual_compensated_blocks(spec, b.S_hi, lo,
                                                        mesh),
                       residual_compensated(spec, b.S_hi, lo))


def test_1d_specs_solve_whole_on_a_mesh():
    from xinvert_tpu_torch.stencil import standard_1d
    n = 60
    spec = standard_1d(torch.ones(n, dtype=torch.float64), 0.0,
                       torch.linspace(-1.0, 1.0, n, dtype=torch.float64),
                       torch.ones(n, dtype=torch.bool), (1.0,), ("fixed",))
    S0 = torch.zeros(n, dtype=torch.float64)
    ref = tsolver.solve(spec, S0, 1.5, tol=1e-8, max_iters=2000)
    out = tpar.solve_sharded(spec, S0, cpu_mesh((2,), ("x",)), 1.5,
                             tol=1e-8, max_iters=2000)
    assert torch.equal(out.S, ref.S) and torch.equal(out.iters, ref.iters)


def test_lexico_and_multigrid_on_a_mesh_raise(f64):
    f = _vor(xt, 24, 48, 1)
    iP = {"BCs": ["extend", "periodic"], "mxLoop": 10, "printInfo": False,
          "mesh": cpu_mesh((2,), ("y",))}
    with pytest.raises(NotImplementedError, match="item 17"):
        xt.invert_Poisson(f, dims=["lat", "lon"], device="cpu",
                          iParams=dict(iP, scheme="lexico"))
    with pytest.raises(NotImplementedError, match="item 17"):
        xt.invert_Poisson_mg(f, dims=["lat", "lon"], device="cpu",
                             iParams=iP)
    spec, S0 = rand_spec((16, 32), P4, ("extend", "periodic"))
    with pytest.raises(NotImplementedError, match="item 17"):
        tpar.solve_sharded(spec, S0, cpu_mesh((2,), ("y",)),
                           scheme="lexico")


# ------------------------------------------------------------ distributed

_GLOO_WORKER = """
import dataclasses, sys, numpy as np, torch
torch.set_num_threads(1)
import torch.distributed as dist
from xinvert_tpu_torch import parallel as tpar
rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
up = tpar.initialize_distributed("tcp://localhost:" + port, 2, rank)
spec, S0, grid = tpar.scaling._poisson_problem(40, 64, torch.float64,
                                               torch.device("cpu"))
r = tpar.solve_halo_window(spec, S0, grid.omega_opt, 1e-5, 200,
                           check_every=8, mesh=tpar.make_grid_mesh())
g2 = torch.stack([spec.g, 3.0 * spec.g])
rb = tpar.solve_sharded(dataclasses.replace(spec, g=g2),
                        torch.zeros((2,) + tuple(S0.shape),
                                    dtype=torch.float64),
                        tpar.make_grid_mesh(batch=2), grid.omega_opt,
                        tol=1e-4, max_iters=200, check_every=8,
                        scheme="cheby")
np.savez(out, up=up, S=r.S.numpy(), iters=r.iters.numpy(),
         rel=r.rel_change.numpy(), Sb=rb.S.numpy(), itb=rb.iters.numpy())
dist.destroy_process_group()
"""


def test_gloo_two_processes_equal_the_local_mesh(tmp_path):
    """Two processes under torch.distributed (gloo, CPU tensors) run
    solve_halo_window on the distributed mesh of their two ranks, and a
    batch of two through solve_sharded (cheby) on a ('batch'=2) mesh, one
    slice a rank; each returns the local mesh's fields, iters and
    rel_change, torch.equal.  Its own 60 s limit: the processes are
    awaited 55 s, then killed."""
    import os
    import subprocess
    import sys
    import time
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    outs = [str(tmp_path / f"rank{r}.npz") for r in range(2)]
    procs = [subprocess.Popen([sys.executable, "-c", _GLOO_WORKER, str(r),
                               str(port), outs[r]], env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT)
             for r in range(2)]
    deadline = time.monotonic() + 55
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    logs = [p.stdout.read().decode() for p in procs]
    assert all(p.returncode == 0 for p in procs), logs
    spec, S0, grid = tpar.scaling._poisson_problem(40, 64, torch.float64,
                                                   CPU)
    loc = tpar.solve_halo_window(spec, S0, grid.omega_opt, 1e-5, 200,
                                 check_every=8,
                                 mesh=cpu_mesh((1, 1, 2),
                                               ("batch", "y", "x")))
    locb = tpar.solve_sharded(
        dataclasses.replace(spec, g=torch.stack([spec.g, 3.0 * spec.g])),
        torch.zeros((2,) + tuple(S0.shape), dtype=torch.float64),
        cpu_mesh((2, 1, 1), ("batch", "y", "x")), grid.omega_opt, tol=1e-4,
        max_iters=200, check_every=8, scheme="cheby")
    for out in outs:
        got = np.load(out)
        assert bool(got["up"])
        assert torch.equal(torch.as_tensor(got["S"]), loc.S)
        assert torch.equal(torch.as_tensor(got["iters"]), loc.iters)
        assert torch.equal(torch.as_tensor(got["rel"]), loc.rel_change)
        assert torch.equal(torch.as_tensor(got["Sb"]), locb.S)
        assert torch.equal(torch.as_tensor(got["itb"]), locb.iters)


def test_single_process_helpers():
    assert tpar.initialize_distributed() is False
    m = tpar.make_hybrid_mesh(batch=2, devices=[CPU] * 4)
    assert dict(m.shape) == {"batch": 2, "y": 1, "x": 2}
    rows = tpar.scaling_bench(device_counts=[1, 2], base_ny=24, base_nx=48,
                              n_iters=4, devices=[CPU] * 2,
                              dtype=torch.float64)
    assert [r["devices"] for r in rows] == [1, 2]
    assert set(rows[0]) == {"devices", "mesh", "grid", "pts_per_s",
                            "pts_per_s_per_device", "efficiency",
                            "emulated"}
    assert rows[1]["emulated"] and rows[0]["efficiency"] == 1.0
    assert "emulation overhead" in tpar.format_scaling_table(rows)
