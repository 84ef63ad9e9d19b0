# -*- coding: utf-8 -*-
"""The sharded multigrid pyramid of the PyTorch port
(``xinvert_tpu_torch.parallel.solve_mg_sharded`` / ``shard_mg_levels``,
:mod:`xinvert_tpu_torch.parallel.pyramid`) against the JAX package's
``solve_mg_sharded`` on the same mesh shape (8 virtual CPU devices,
tests/conftest.py), float64 on the CPU, mirroring
tests/test_parallel.py's sharded multigrid tests:

- the 128x128 masked Poisson on 8 blocks ('y'=2, 'x'=4), 1e-9 max|S|;
- the batched 64x64 case, B = 4, on ('batch'=2, 'y'=2, 'x'=2), 1e-9, and
  the same pyramid unbatched and with B = 3 on that mesh (the 'batch'
  axis replicates what it does not divide);
- the 3-D semicoarsened 6x32x32 case on 4 blocks (z-lines), 1e-8;
- a 66x64 pyramid whose third level goes whole (its block origin is odd
  where it restricts), with full multigrid, 1e-9;
- an x-line pyramid (extend/periodic) on ('y'=2, 'x'=2), its lines along
  the split x axis gathered, 1e-9;

each with the JAX package's cycles, and torch.equal to the port's own
meshless ``solve_mg`` (every piece of the split V-cycle is elementwise, a
max, or the meshless code on the same values).  The pyramids are the JAX
package's, carried across with ``levels_from_arrays``.  Also the level
plan, the Krylov rescue and frozen batch members on blocks, lines per
block with the extend pre-pass, and two gloo processes on a distributed
mesh equal to the local mesh."""
import socket

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh as JMesh  # noqa: E402

from xinvert_tpu import mg as jmg  # noqa: E402
from xinvert_tpu.parallel import solve_mg_sharded as jax_solve_mg_sharded  # noqa: E402,E501
from xinvert_tpu_torch import mg as tmg  # noqa: E402
from xinvert_tpu_torch import parallel as tpar  # noqa: E402
from xinvert_tpu_torch.parallel import mesh as tmesh, pyramid  # noqa: E402

CPU = torch.device("cpu")
AXES = ("batch", "y", "x")


@pytest.fixture(scope="module", autouse=True)
def f64():
    dtype = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(dtype)


def cpu_mesh(shape):
    arr = np.empty(int(np.prod(shape)), dtype=object)
    arr[:] = [CPU] * arr.size
    return tmesh.Mesh(arr.reshape(shape), AXES)


def jax_mesh(shape):
    n = int(np.prod(shape))
    return JMesh(np.array(jax.devices()[:n]).reshape(shape), AXES)


def _planes(rng, shape):
    A = np.abs(rng.normal(1, .05, shape)) + 1.0
    C = np.abs(rng.normal(1, .05, shape)) + 1.0
    return A, C, rng.normal(0, 1, shape)


def masked_128():
    rng = np.random.default_rng(2)
    A, C, F = _planes(rng, (128, 128))
    Fdef = np.ones((128, 128), bool)
    Fdef[40:55, 30:90] = False
    pyr = jmg.build_pyramid_standard2d(A, 0.0, C, F, Fdef, (1.2e5, 1.0e5),
                                       ("fixed", "periodic"))
    return pyr, dict(tol=1e-8, max_cycles=40)


def batched_64():
    rng = np.random.default_rng(5)
    A, C, F = _planes(rng, (64, 64))
    pyr = jmg.build_pyramid_standard2d(A, 0.0, C, F, np.ones((64, 64), bool),
                                       (1.2e5, 1.0e5), ("fixed", "fixed"))
    g0 = np.stack([(0.5 + 0.5 * b) * np.asarray(pyr[0].spec.g)
                   for b in range(4)])
    return pyr, dict(S0=np.zeros((4, 64, 64)), g0=g0, tol=1e-8,
                     max_cycles=30)


def unbatched_64():
    pyr, _ = batched_64()
    return pyr, dict(tol=1e-8, max_cycles=30)


def batched3_64():
    pyr, kw = batched_64()
    return pyr, dict(kw, S0=kw["S0"][:3], g0=kw["g0"][:3])


def semicoarsened_3d():
    nz, ny, nx = 6, 32, 32
    rng = np.random.default_rng(7)
    A = np.full((nz, ny, nx), 1e-8)
    Bc = np.abs(rng.normal(1, .05, (nz, ny, nx))) + 1.0
    C = np.abs(rng.normal(1, .05, (nz, ny, nx))) + 1.0
    F = rng.normal(0, 1, (nz, ny, nx))
    pyr = jmg.build_pyramid_standard3d(A, Bc, C, F, np.ones((nz, ny, nx),
                                                            bool),
                                       (7e3, 1.2e5, 1.0e5),
                                       ("fixed", "fixed", "periodic"))
    return pyr, dict(tol=1e-7, max_cycles=40)


def odd_66():
    rng = np.random.default_rng(11)
    A, C, F = _planes(rng, (66, 64))
    pyr = jmg.build_pyramid_standard2d(A, 0.0, C, F, np.ones((66, 64), bool),
                                       (1.2e5, 1.0e5), ("fixed", "fixed"),
                                       min_size=5)
    return pyr, dict(tol=1e-8, max_cycles=40, fmg=True)


def xline_32x64():
    rng = np.random.default_rng(3)
    A, C, F = _planes(rng, (32, 64))
    Fdef = np.ones((32, 64), bool)
    Fdef[10:15, 20:35] = False
    pyr = jmg.build_pyramid_standard2d(A, 0.0, C, F, Fdef, (1.0e5, 2.0e4),
                                       ("extend", "periodic"))
    return pyr, dict(tol=1e-8, max_cycles=40)


# (pyramid maker, mesh shape, tolerance of max|S|, the port's plan: blocks per
# level, None a whole level, and the stamped smoother)
CASES = {
    "masked128_8blocks": (masked_128, (1, 2, 4), 1e-9,
                          [(2, 4)] * 4, "point"),
    "batched64_batch2": (batched_64, (2, 2, 2), 1e-9, [(2, 2)] * 3, "point"),
    # a 'batch' axis that does not divide the state's batch replicates it
    "unbatched64_batch2": (unbatched_64, (2, 2, 2), 1e-9, [(2, 2)] * 3,
                           "point"),
    "batched3_64_batch2": (batched3_64, (2, 2, 2), 1e-9, [(2, 2)] * 3,
                           "point"),
    "semicoarsened3d_4blocks": (semicoarsened_3d, (1, 2, 2), 1e-8,
                                [(2, 2)] * 2, "zline"),
    "odd66_whole_from_level2": (odd_66, (1, 2, 1), 1e-9,
                                [(2, 1), (2, 1), None, None], "point"),
    "xline_split_x": (xline_32x64, (1, 2, 2), 1e-9, [(2, 2)] * 2, "xline"),
}


def _t(x):
    return None if x is None else torch.as_tensor(np.asarray(x))


@pytest.mark.parametrize("case", sorted(CASES))
def test_solve_mg_sharded_matches_jax_and_meshless(case):
    build, shape, tol, plan, smoother = CASES[case]
    jpyr, kw = build()
    tpyr = tmg.levels_from_arrays(jpyr, dtype=torch.float64)
    assert tpyr[0].smoother == smoother
    mesh = cpu_mesh(shape)
    got = [None if p is None else (len(p[0]), len(p[1]))
           for p in pyramid.level_plan(tpyr, mesh)]
    assert got == plan

    jkw = {k: (jnp.asarray(v) if k in ("S0", "g0") else v)
           for k, v in kw.items()}
    Sj, kj, resj, convj = jax_solve_mg_sharded(jpyr, mesh=jax_mesh(shape),
                                               **jkw)
    tkw = {k: (_t(v) if k in ("S0", "g0") else v) for k, v in kw.items()}
    S, k, res, conv = tpar.solve_mg_sharded(tpyr, mesh=mesh, **tkw)
    assert conv and convj and res < kw["tol"]
    assert k == int(kj)
    Sj = np.asarray(Sj)
    scale = np.abs(Sj).max()
    np.testing.assert_allclose(S.numpy(), Sj, rtol=0, atol=tol * scale)

    Sm, km, resm, convm = tmg.solve_mg(tpyr, **tkw)
    assert (k, res, conv) == (km, resm, convm)
    assert torch.equal(S, Sm)


def _port_2d(seed, shape, bcs, deltas, Fdef=None, **kw):
    rng = np.random.default_rng(seed)
    A, C, F = _planes(rng, shape)
    if Fdef is None:
        Fdef = np.ones(shape, bool)
    return tmg.build_pyramid_standard2d(_t(A), 0.0, _t(C), _t(F), Fdef,
                                        deltas, bcs, **kw)


def test_lines_per_block_with_the_extend_prepass():
    """x-lines solved block by block on ('y'=4,) ('x' unsplit: the parity
    from each block's global row origin, the extend pre-pass on the blocks
    that hold the global end rows): torch.equal to the meshless solve."""
    Fdef = np.ones((48, 64), bool)
    Fdef[20:26, 10:30] = False
    pyr = _port_2d(4, (48, 64), ("extend", "periodic"), (1.0e5, 2.0e4),
                   Fdef)
    assert pyr[0].smoother == "xline"
    kw = dict(tol=1e-8, max_cycles=3)
    S, k, res, _ = tpar.solve_mg_sharded(pyr, mesh=cpu_mesh((1, 4, 1)),
                                         **kw)
    Sm, km, resm, _ = tmg.solve_mg(pyr, **kw)
    assert (k, res) == (km, resm) and torch.equal(S, Sm)


def test_3d_extend_point_and_zxline_per_block():
    """A 3-D (fixed, extend, periodic) pyramid with a polar x metric
    (z- then x-lines) and under the point smoother (the 3-D block sweep's
    plain version), on 2x2 blocks: torch.equal to the meshless solve."""
    nz, ny, nx = 3, 24, 32
    rng = np.random.default_rng(9)
    lat = np.deg2rad(np.linspace(-80, 80, ny))
    C = np.ones((nz, ny, nx)) / np.cos(lat)[None, :, None] ** 2
    Fdef = np.ones((nz, ny, nx), bool)
    Fdef[:, 8:11, 12:18] = False
    pyr = tmg.build_pyramid_standard3d(
        _t(np.full((nz, ny, nx), 1e-3)), _t(np.ones((nz, ny, nx))), _t(C),
        _t(rng.normal(0, 1, (nz, ny, nx))), Fdef, (1.0, 1.0, 1.0),
        ("fixed", "extend", "periodic"))
    assert pyr[0].smoother == "zxline"
    mesh = cpu_mesh((1, 2, 2))
    for smoother in ("zxline", "point"):
        kw = dict(tol=1e-7, max_cycles=2, smoother=smoother)
        S, k, res, _ = tpar.solve_mg_sharded(pyr, mesh=mesh, **kw)
        Sm, km, resm, _ = tmg.solve_mg(pyr, **kw)
        assert (k, res) == (km, resm) and torch.equal(S, Sm)


@pytest.mark.parametrize("accel", ["auto", "bicgstab"])
def test_krylov_rescue_on_blocks(accel):
    """An advective general-2D pyramid whose plain V-cycles stall: the
    BiCGStab rescue (or the Krylov solve alone) with the split V-cycle as
    its preconditioner, on the gathered field, equal to the meshless
    solve, as are the host syncs."""
    rng = np.random.default_rng(1)
    shape = (32, 48)
    pyr = tmg.build_pyramid_general2d(
        _t(np.ones(shape)), 0.0, _t(np.ones(shape)), 0.0, 30.0, -0.01,
        _t(rng.normal(0, 1, shape)), np.ones(shape, bool), (1.0, 1.0),
        ("fixed", "periodic"), min_size=8)
    kw = dict(tol=1e-8, max_cycles=10, accel=accel)
    tmg.HOST_SYNCS = 0
    S, k, res, conv = tpar.solve_mg_sharded(pyr, mesh=cpu_mesh((1, 2, 2)),
                                            **kw)
    syncs = tmg.HOST_SYNCS
    tmg.HOST_SYNCS = 0
    Sm, km, resm, convm = tmg.solve_mg(pyr, **kw)
    assert (k, res, conv, syncs) == (km, resm, convm, tmg.HOST_SYNCS)
    assert k > 10 if accel == "auto" else k >= 1
    assert torch.equal(S, Sm)


def test_frozen_members_on_blocks():
    """Batch members whose tests end at different cycles are frozen by
    restoring their owned cells: the meshless cycles and field."""
    pyr = _port_2d(6, (32, 32), ("fixed", "fixed"), (1.2e5, 1.0e5))
    rng = np.random.default_rng(8)
    g = pyr[0].spec.g
    g0 = torch.stack([g, 3.0 * g, g + 1e-3 * _t(rng.normal(0, 1, (32, 32)))
                      * pyr[0].spec.active, 0.0 * g])
    kw = dict(S0=torch.zeros(4, 32, 32), g0=g0, tol=1e-9, max_cycles=12)
    S, k, res, _ = tpar.solve_mg_sharded(pyr, mesh=cpu_mesh((2, 1, 2)),
                                         **kw)
    Sm, km, resm, _ = tmg.solve_mg(pyr, **kw)
    assert (k, res) == (km, resm) and torch.equal(S, Sm)


def test_level_plan():
    """Finest blocks in units of 2^j within 9/8 of an even split, origins
    halved level by level; a level goes whole where an origin would be odd
    where it restricts, or a block is thinner than its ghost ring, and
    every coarser level with it."""
    assert pyramid._finest_sizes(2048, 2, 8) == [1024, 1024]
    assert pyramid._finest_sizes(330, 2, 6) == [176, 154]
    assert pyramid._finest_sizes(720, 2, 6) == [384, 336]
    assert pyramid._finest_sizes(3, 4, 2) is None
    assert pyramid._sizes_at([176, 154], 165, 1, True) == [88, 77]
    assert pyramid._sizes_at([176, 154], 42, 3, True) == [22, 20]
    assert pyramid._sizes_at([176, 154], 21, 4, True) is None
    assert pyramid._sizes_at([176, 154], 21, 4, False) == [11, 10]
    thin = _port_2d(12, (64, 64), ("fixed", "periodic"), (1.0e5, 1.0e5),
                    min_size=4)
    mesh = cpu_mesh((1, 2, 4))
    plan = pyramid.level_plan(thin, mesh)
    # the fifth level's 4 columns over 4 blocks: thinner than the ring
    assert [p is None for p in plan] == [False] * 4 + [True]
    levels = tpar.shard_mg_levels(thin, mesh)
    assert [lv.split for lv in levels] == [p is not None for p in plan]
    assert all(lv.spec is t.spec and lv.mesh is mesh
               for lv, t in zip(levels, thin))
    assert levels[0].sizes == ((32, 32), (16, 16, 16, 16))
    # a placed pyramid: solve_mg_sharded on its mesh, mg.solve_mg whole
    S, k, _, _ = tpar.solve_mg_sharded(levels, tol=1e-6)
    Sm, km, _, _ = tmg.solve_mg(thin, tol=1e-6)
    assert k == km and torch.equal(S, Sm)
    assert torch.equal(tmg.solve_mg(levels, tol=1e-6)[0], Sm)
    # a mesh of one device, or every level whole: the meshless solve
    one = cpu_mesh((1, 1, 1))
    assert pyramid.level_plan(thin, one) == [None] * 5
    S, k, _, _ = tpar.solve_mg_sharded(thin, mesh=one, tol=1e-6)
    assert k == km and torch.equal(S, Sm)


# ------------------------------------------------------------ distributed

_GLOO_WORKER = """
import sys, numpy as np, torch
torch.set_num_threads(1)
torch.set_default_dtype(torch.float64)
import torch.distributed as dist
from xinvert_tpu_torch import mg, parallel as tpar
rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
up = tpar.initialize_distributed("tcp://localhost:" + port, 2, rank)
rng = np.random.default_rng(2)
A = torch.as_tensor(np.abs(rng.normal(1, .05, (64, 64))) + 1.0)
C = torch.as_tensor(np.abs(rng.normal(1, .05, (64, 64))) + 1.0)
F = torch.as_tensor(rng.normal(0, 1, (64, 64)))
Fdef = np.ones((64, 64), bool)
Fdef[20:28, 15:45] = False
pyr = mg.build_pyramid_standard2d(A, 0.0, C, F, Fdef, (1.2e5, 1.0e5),
                                  ("fixed", "periodic"))
S, k, res, conv = tpar.solve_mg_sharded(pyr, mesh=tpar.make_grid_mesh(),
                                        tol=1e-8, max_cycles=40, fmg=True)
np.savez(out, up=up, S=S.numpy(), k=k, res=res)
dist.destroy_process_group()
"""


def test_gloo_two_processes_equal_the_local_mesh(tmp_path):
    """Two processes under torch.distributed (gloo, CPU tensors) run
    solve_mg_sharded (full multigrid, a masked 64x64 Poisson) on the
    distributed mesh of their two ranks (('x'=2), make_grid_mesh's
    factoring): each returns the local mesh's field, cycles and residual,
    torch.equal.  Its own 60 s limit: the processes are awaited 55 s, then
    killed."""
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
    rng = np.random.default_rng(2)
    A, C, F = (_t(x) for x in _planes(rng, (64, 64)))
    Fdef = np.ones((64, 64), bool)
    Fdef[20:28, 15:45] = False
    pyr = tmg.build_pyramid_standard2d(A, 0.0, C, F, Fdef, (1.2e5, 1.0e5),
                                       ("fixed", "periodic"))
    S, k, res, _ = tpar.solve_mg_sharded(pyr, mesh=cpu_mesh((1, 1, 2)),
                                         tol=1e-8, max_cycles=40, fmg=True)
    for out in outs:
        got = np.load(out)
        assert bool(got["up"])
        assert torch.equal(torch.as_tensor(got["S"]), S)
        assert int(got["k"]) == k and float(got["res"]) == res
