# -*- coding: utf-8 -*-
"""The CUDA kernels of the PyTorch port (xinvert_tpu_torch/csrc/sor2d.cu and
csrc/sor3d.cu) on the card: bit-equal to their plain PyTorch versions (the
2-D route, the resident kernel and the tiled kernels with their in-place
twin, the 3-D color sweep with the extend pre-pass folded in, and the
Chebyshev factor argument included), counted, and refusing what they do not
take; the direct engine on the card against the CPU; solution trajectories
through the kernels frame by frame against the plain version; the
lexicographic executor and the 1-D entry points on the card against the
CPU; the error-free transformations exact on the card, refinement through
the kernels, streamed solves bit-equal to the resident solve, implicit
gradients through the kernels equal to the plain version's; the block
kernels (sor2d_sweeps_block, sor3d_block_sweep) bit-equal to their
plain versions and, on local meshes that repeat the card, to the meshless
sweeps and solves; batches over 65 535 slices through the main-path
kernels; the sharded multigrid pyramid (solve_mg_sharded) on local meshes
of the card, over several cards and under NCCL, equal to the meshless
solve; the copy and sync counters of a traced call; the API's steps on the
card bit-equal to its former numpy steps; the pinned staging of large
copies bit-equal to the plain copies, on its own and through the API.  Every test here needs an NVIDIA GPU (marker
``cuda``) and skips elsewhere.  This file imports no JAX, so it runs on a
machine without it:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import xinvert_tpu_torch as xt  # noqa: E402
from xinvert_tpu_torch.grid import Grid  # noqa: E402
from xinvert_tpu_torch.models import problems  # noqa: E402
from xinvert_tpu_torch.models.params import default_mParams  # noqa: E402
from xinvert_tpu_torch.ops import _driver, sor2d, sor3d  # noqa: E402
from xinvert_tpu_torch.stencil import StencilSpec  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda", 0)


def _main_2d():
    """Launches of the 2-D main path's kernels: the resident kernel and the
    two tiled kernels, of which the route takes one by spec, slice shape
    and dtype."""
    return (sor2d.RESIDENT_LAUNCHES + sor2d.TILED_LAUNCHES
            + sor2d.TILED_INPLACE_LAUNCHES)


def _poisson(dtype, device, batch=0, ny=45, nx=70,
             bcs=("extend", "periodic")):
    rng = np.random.default_rng(0)
    lat = np.linspace(-88.75, 88.75, ny)
    lon = np.linspace(0.0, 360.0 - 360.0 / nx, nx)
    shape = (batch, ny, nx) if batch else (ny, nx)
    vals = torch.as_tensor(rng.standard_normal(shape), dtype=dtype,
                           device=device)
    Fdef = np.ones((ny, nx), bool)
    Fdef[ny // 3:ny // 2, nx // 4:nx // 2] = False
    grid = Grid.make(("lat", "lon"), (lat, lon), "lat-lon", bcs=bcs)
    spec = problems.build_poisson(vals, torch.as_tensor(Fdef, device=device),
                                  grid, default_mParams)
    S0 = torch.as_tensor(rng.normal(0, 1e-3, shape), dtype=dtype,
                         device=device)
    return spec, S0


def _bih(dtype, device, bcs):
    rng = np.random.default_rng(1)
    offs = ((2, 0), (1, 0), (-1, 0), (-2, 0), (0, 2), (0, 1), (0, -1),
            (0, -2), (2, 2), (2, -2), (-2, 2), (-2, -2), (1, 1), (-1, 1),
            (1, -1), (-1, -1))
    ny, nx = 21, 26
    active = np.zeros((ny, nx), bool)
    active[2:-2, 2:-2] = True
    if bcs[-1] == "periodic":
        active[2:-2, :] = True
    w = rng.uniform(0.05, 0.25, (16, ny, nx)) * active
    w0 = np.where(active, -1.05 * w.sum(0), 0.0)
    relax = np.where(active, 1.0 / np.where(active, -w0, 1.0), 0.0)
    g = rng.normal(0, 1, (ny, nx)) * active
    spec = StencilSpec.from_arrays(w, w0, g, relax, active, offs, bcs, True,
                                   False, device=device, dtype=dtype)
    S0 = torch.as_tensor(rng.normal(0, 1e-3, (ny, nx)), dtype=dtype,
                         device=device)
    return spec, S0


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", ["poisson", "poisson_batch", "fixed",
                                  "bih_periodic", "bih_fixed"])
def test_kernel_bit_equal_to_plain(cuda, dtype, case):
    """The 2-D route (sor2d_sweeps: the resident kernel where its plan
    takes the slice, else the tiled kernel), 15 sweeps with the fused |S|
    sums, against the plain version: ceil(15 / k) launches of the route's
    kernel."""
    if case == "poisson":
        spec, S0 = _poisson(dtype, cuda)
    elif case == "poisson_batch":
        spec, S0 = _poisson(dtype, cuda, batch=3)
    elif case == "fixed":
        spec, S0 = _poisson(dtype, cuda, bcs=("fixed", "fixed"))
    else:
        spec, S0 = _bih(dtype, cuda, ("extend", case[4:]))
    before = S0.clone()
    core = tuple(S0.shape[-2:])
    plan = (sor2d.resident_plan(spec, core, dtype)
            or sor2d.tile_plan(spec, core, dtype))
    m0 = _main_2d()
    out_k, sumabs = sor2d.sor2d_sweeps(spec, S0, 1.3, 15, with_norm=True)
    out_p = sor2d.sor2d_sweeps_reference(spec, S0, 1.3, 15)
    torch.cuda.synchronize()
    assert _main_2d() == m0 + -(-15 // plan.k)
    assert torch.equal(out_k, out_p)
    assert torch.equal(S0, before)
    ref = out_p.double().abs().sum(dim=(-2, -1))
    rtol = 1e-5 if dtype == torch.float32 else 1e-12
    torch.testing.assert_close(sumabs.double(), ref, rtol=rtol, atol=0)


def _case2d(case, dtype, device):
    if case == "poisson":
        return _poisson(dtype, device)
    if case == "poisson_batch":
        return _poisson(dtype, device, batch=3)
    if case == "fixed":
        return _poisson(dtype, device, bcs=("fixed", "fixed"))
    if case == "stommel":
        return _stommel(dtype, device)
    return _bih(dtype, device, ("extend", case[4:]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", ["poisson", "poisson_batch", "fixed",
                                  "bih_periodic", "bih_fixed", "stommel"])
def test_tiled_bit_equal_to_plain(cuda, dtype, case):
    """Both tiled kernels, n not a multiple of k, with and without factors,
    and the fused |S| sums of the last launch."""
    spec, S0 = _case2d(case, dtype, cuda)
    core = tuple(S0.shape[-2:])
    before = S0.clone()
    kernels = [(sor2d.sor2d_sweeps_tiled, "TILED_LAUNCHES", False)]
    if sor2d.inplace_eligible(spec, core):
        kernels.append((sor2d.sor2d_sweeps_tiled_inplace,
                        "TILED_INPLACE_LAUNCHES", True))
    rng = np.random.default_rng(3)
    for fn, counter, inplace in kernels:
        k = sor2d.tile_plan(spec, core, dtype, inplace).k
        n = 2 * k + 1
        fac = [float(torch.tensor(f, dtype=dtype))
               for f in 1.0 + 0.4 * rng.random(2 * n)]
        for f, omega in ((None, 1.3), (fac, 1.0)):
            c0, m0 = getattr(sor2d, counter), _main_2d()
            out_k, sumabs = fn(spec, S0, omega, n, with_norm=True, fac=f)
            out_p = sor2d.sor2d_sweeps_reference(spec, S0, omega, n, f)
            torch.cuda.synchronize()
            assert getattr(sor2d, counter) == c0 + 3
            assert _main_2d() == m0 + 3
            assert torch.equal(out_k, out_p)
            assert torch.equal(fn(spec, S0, omega, 1, fac=None if f is None
                                  else f[:2]),
                               sor2d.sor2d_sweeps_reference(
                                   spec, S0, omega, 1,
                                   None if f is None else f[:2]))
            ref = out_p.double().abs().sum(dim=(-2, -1))
            rtol = 1e-5 if dtype == torch.float32 else 1e-12
            torch.testing.assert_close(sumabs.double(), ref, rtol=rtol,
                                       atol=0)
    assert torch.equal(S0, before)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", ["poisson_batch", "fixed", "bih_fixed"])
def test_tiled_at_odd_origins(cuda, monkeypatch, dtype, case):
    """Tiles of 7 x 9 cells (odd origins: the parity is global) through
    the ping-pong kernel, bit-equal to the plain version; the fused sums,
    which need whole 32 x 8 blocks per tile, are refused for them."""
    spec, S0 = _case2d(case, dtype, cuda)
    plan = sor2d.make_plan(spec, tuple(S0.shape[-2:]), dtype, False, 2, 7, 9)
    monkeypatch.setattr(sor2d, "tile_plan", lambda *a: plan)
    for n in (1, 5):
        out = sor2d.sor2d_sweeps_tiled(spec, S0, 1.3, n)
        assert torch.equal(out, sor2d.sor2d_sweeps_reference(spec, S0, 1.3,
                                                             n))
    with pytest.raises(RuntimeError, match="CUDA error"):
        sor2d.sor2d_sweeps_tiled(spec, S0, 1.3, 2, with_norm=True)


def _year(device, batch=1460):
    """The year cell's problem (benchmark/configs/poisson_ncep25.json):
    invert_Poisson's spec on the NCEP/NCAR R1 73 x 144 grid from pole to
    pole, BCs [extend, periodic], float32, ``batch`` forcings of
    sin(3 lon) cos(2 lat) plus noise with a continent-shaped block
    masked."""
    ny, nx = 73, 144
    lat = np.linspace(-90.0, 90.0, ny)
    lon = np.linspace(0.0, 357.5, nx)
    rng = np.random.default_rng(11)
    base = (np.sin(3 * np.deg2rad(lon))[None, :]
            * np.cos(2 * np.deg2rad(lat))[:, None])
    vals = (base + 0.1 * rng.standard_normal((batch, ny, nx))).astype(
        np.float32)
    Fdef = np.ones((ny, nx), bool)
    Fdef[ny // 3:ny // 2, nx // 4:nx // 2] = False
    grid = Grid.make(("lat", "lon"), (lat, lon), "lat-lon",
                     bcs=("extend", "periodic"))
    spec = problems.build_poisson(torch.as_tensor(vals, device=device),
                                  torch.as_tensor(Fdef, device=device), grid,
                                  default_mParams)
    S0 = torch.as_tensor(rng.normal(0, 1e9, (batch, ny, nx)),
                         dtype=torch.float32, device=device)
    return spec, S0


def _r1_spec(dtype, device, ny, nx, bcs, batch, per_slice, seed=0):
    """A random diagonally dominant radius-1 stencil without cross terms
    (relax 0 on the boundary lines of a non-periodic axis, a few cells
    masked); every plane one a slice where ``per_slice``, else only g."""
    rng = np.random.default_rng(seed)
    shape = (batch, ny, nx) if per_slice else (ny, nx)
    active = np.ones((ny, nx), bool)
    if bcs[0] != "periodic":
        active[[0, -1], :] = False
    if bcs[1] != "periodic":
        active[:, [0, -1]] = False
    active = np.broadcast_to(active, shape) & (rng.random(shape) > 0.05)
    w = rng.uniform(0.05, 0.25, (4,) + shape) * active
    w0 = np.where(active, -1.05 * w.sum(0), 0.0)
    relax = np.where(active, 1.0 / np.where(active, -w0, 1.0), 0.0)
    g = rng.normal(0, 1, (batch, ny, nx)) * active
    spec = StencilSpec.from_arrays(w, w0, g, relax, active,
                                   ((1, 0), (-1, 0), (0, 1), (0, -1)), bcs,
                                   device=device, dtype=dtype)
    S0 = torch.as_tensor(rng.normal(0, 1e-3, (batch, ny, nx)), dtype=dtype,
                         device=device)
    return spec, S0


def _resident_case(case, device):
    if case == "year":
        return _year(device)
    if case == "nan":
        spec, S0 = _year(device, batch=4)
        S0[2, 30, 50] = float("nan")
        S0[1, 0, 5] = float("inf")
        return spec, S0
    if case == "poisson_f64":
        return _poisson(torch.float64, device, batch=3)
    if case == "three_offsets":
        spec, S0 = _r1_spec(torch.float32, device, 41, 90,
                            ("extend", "periodic"), 3, False)
        return dataclasses.replace(spec, w=spec.w[:3].contiguous(),
                                   offsets=spec.offsets[:3]), S0
    bcs, dtype, ny, nx, batch, per_slice = {
        "extend_fixed_odd": (("extend", "fixed"), torch.float64, 37, 53, 3,
                             False),
        "fixed_periodic_odd": (("fixed", "periodic"), torch.float32, 45, 71,
                               2, True),
        "fixed_fixed": (("fixed", "fixed"), torch.float64, 40, 72, 3, True),
        "fixed_periodic": (("fixed", "periodic"), torch.float32, 33, 64, 5,
                           False)}[case]
    return _r1_spec(dtype, device, ny, nx, bcs, batch, per_slice)


def _nan_same(a, b):
    """Equal values, and NaN at the same cells."""
    return (torch.equal(torch.isnan(a), torch.isnan(b))
            and torch.equal(torch.nan_to_num(a), torch.nan_to_num(b)))


@pytest.mark.parametrize("case", ["year", "nan", "poisson_f64",
                                  "extend_fixed_odd", "fixed_periodic_odd",
                                  "fixed_fixed", "fixed_periodic",
                                  "three_offsets"])
def test_resident_bit_equal_to_plain_and_tiled(cuda, case):
    """The resident kernel against the plain version and the tiled kernel:
    the year cell's spec and mask at 1460 x 73 x 144 float32, odd shapes
    (an odd periodic x with live boundary columns: one color across the
    wrap), three offsets (K < 4), n
    of 1, 37 and 70 (two launches: 64 + 6), with and without Chebyshev
    factors, the fused |S| totals equal to the tiled kernel's, extend and
    fixed y, periodic and fixed x, planes shared and one a slice, and a
    state that holds a NaN and an Inf."""
    spec, S0 = _resident_case(case, cuda)
    dtype, core = S0.dtype, tuple(S0.shape[-2:])
    assert sor2d.resident_plan(spec, core, dtype) is not None
    before = S0.clone()
    rng = np.random.default_rng(3)
    for n in (1, 37, 70):
        fac = [float(torch.tensor(f, dtype=dtype))
               for f in 1.0 + 0.4 * rng.random(2 * n)]
        for f, omega in ((None, 1.3), (fac, 1.0)):
            r0 = sor2d.RESIDENT_LAUNCHES
            out_r, sum_r = sor2d.sor2d_sweeps_resident(
                spec, S0, omega, n, with_norm=True, fac=f)
            out_t, sum_t = sor2d.sor2d_sweeps_tiled(spec, S0, omega, n,
                                                    with_norm=True, fac=f)
            out_p = sor2d.sor2d_sweeps_reference(spec, S0, omega, n, f)
            torch.cuda.synchronize()
            assert sor2d.RESIDENT_LAUNCHES == r0 + -(-n // 64)
            assert _nan_same(out_r, out_p), (n, f is None)
            assert _nan_same(out_r, out_t), (n, f is None)
            assert _nan_same(sum_r, sum_t), (n, f is None)
            assert _nan_same(sor2d.sor2d_sweeps_resident(spec, S0, omega, n,
                                                         fac=f), out_r)
    assert _nan_same(S0, before)


def test_resident_checked_solve_equals_tiled(cuda, monkeypatch):
    """A checked solve of the year cell's spec (64 fields, tolerance 1e-6,
    32-sweep windows) through the resident kernel stops where the tiled
    kernel's does: iters, rel_change, overflow and the state, torch.equal,
    one launch a window."""
    spec, _ = _year(cuda, batch=64)
    S0 = torch.zeros(spec.g.shape, dtype=torch.float32, device=cuda)
    kw = dict(tol=1e-6, max_iters=5000, check_every=32)
    r0 = sor2d.RESIDENT_LAUNCHES
    res = xt.solve(spec, S0, **kw)
    windows = sor2d.RESIDENT_LAUNCHES - r0
    monkeypatch.setattr(sor2d, "sor2d_sweeps", sor2d.sor2d_sweeps_tiled)
    ref = xt.solve(spec, S0, **kw)
    assert windows == int(ref.iters.max()) // 32
    assert int(ref.iters.max()) < 5000 and not bool(ref.overflow.any())
    for f in ("iters", "rel_change", "overflow", "S"):
        assert torch.equal(getattr(res, f), getattr(ref, f)), f


@pytest.mark.parametrize("case", ["year", "2048"])
def test_2d_solve_launches_only_the_route_kernel(cuda, case):
    """A checked 2-D solve at the year cell's 73 x 144 launches the resident
    kernel alone; at 2048 x 2048, past its reach, the tiled kernel
    alone."""
    if case == "year":
        spec, _ = _year(cuda, batch=8)
        ran_only = "RESIDENT_LAUNCHES"
    else:
        spec, _ = _poisson(torch.float32, cuda, ny=2048, nx=2048)
        ran_only = "TILED_LAUNCHES"
    S0 = torch.zeros(spec.g.shape, dtype=torch.float32, device=cuda)
    names = ("RESIDENT_LAUNCHES", "TILED_LAUNCHES", "TILED_INPLACE_LAUNCHES",
             "BLOCK_LAUNCHES", "PLAIN_CALLS")
    before = {n: getattr(sor2d, n) for n in names}
    xt.solve(spec, S0, tol=1e-6, max_iters=256, check_every=32)
    ran = {n for n in names if getattr(sor2d, n) != before[n]}
    assert ran == {ran_only}


@pytest.mark.parametrize("switch", [False, True])
def test_2d_solve_launches_only_the_tiled_kernels(cuda, monkeypatch,
                                                  switch):
    """A slice past the resident kernel's reach (96 x 144: 6912 pairs of
    cells) runs the tiled kernels alone, the in-place one with the
    switch."""
    monkeypatch.setattr(sor2d, "INPLACE_KERNEL", switch)
    spec, _ = _stommel(torch.float32, cuda, ny=96, nx=144)
    assert sor2d.resident_plan(spec, (96, 144), torch.float32) is None
    S0 = torch.zeros(spec.g.shape, dtype=torch.float32, device=cuda)
    names = ("TILED_LAUNCHES", "TILED_INPLACE_LAUNCHES", "PLAIN_CALLS",
             "RESIDENT_LAUNCHES", "BLOCK_LAUNCHES")
    before = {n: getattr(sor2d, n) for n in names}
    xt.solve(spec, S0, omega=1.5, tol=1e-9, max_iters=200, check_every=8)
    ran = {n for n in names if getattr(sor2d, n) != before[n]}
    assert ran == {"TILED_INPLACE_LAUNCHES" if switch else "TILED_LAUNCHES"}


def test_tiled_cell_counters(cuda):
    """One tiled launch of a radius-2 stencil on 3 slices, then on 600
    (the shared planes' walk: several slices a block, staged), grows
    TILED_WINDOW_CELLS and TILED_CELLS by ``tiled_cells`` of its plan and
    TILED_STAGED_SLICES and TILED_SLICES by ``tiled_slices`` of its plan
    and walk; 32 sweeps through the resident route leave all four
    unchanged."""
    spec, S0 = _bih(torch.float32, cuda, ("extend", "periodic"))
    core = tuple(S0.shape[-2:])
    plan = sor2d.tile_plan(spec, core, torch.float32)
    assert plan.k == 1
    names = ("TILED_WINDOW_CELLS", "TILED_CELLS", "TILED_STAGED_SLICES",
             "TILED_SLICES")
    for B in (3, 600):
        S = S0.expand(B, *S0.shape).contiguous()
        lay = sor2d._layout(spec, S, sor2d.relax_plane(spec, 1.0))
        spb = sor2d._slices_per_block(lay, plan, S)
        assert (spb > 1) == (B == 600)
        before = [getattr(sor2d, n) for n in names]
        sor2d.sor2d_sweeps(spec, S, 1.0, 1)
        torch.cuda.synchronize()
        grown = (sor2d.tiled_cells(plan, B, core)
                 + sor2d.tiled_slices(plan, B, spb, core))
        assert [getattr(sor2d, n) - b for n, b in zip(names, before)] == \
            list(grown)
        assert (grown[2] > 0) == (B == 600)
    spec, S0 = _year(cuda, batch=8)
    assert sor2d.resident_plan(spec, tuple(S0.shape[-2:]),
                               S0.dtype) is not None
    before = [getattr(sor2d, n) for n in names] + [sor2d.RESIDENT_LAUNCHES]
    sor2d.sor2d_sweeps(spec, S0, 1.3, 32)
    torch.cuda.synchronize()
    assert [getattr(sor2d, n) for n in names] + [
        sor2d.RESIDENT_LAUNCHES] == before[:4] + [before[4] + 1]


@pytest.mark.parametrize("dtype,check_every", [(torch.float32, 1),
                                               (torch.float32, 32),
                                               (torch.float64, 1)])
@pytest.mark.parametrize("case", ["diverging", "nan_seed"])
def test_tiled_stops_like_the_plain_version(cuda, monkeypatch, dtype,
                                            check_every, case):
    """A diverging solve (omega 2.5) and a NaN seeded in the interior of
    the state, through both tiled kernels, against the same solve on the
    CPU (the plain version): the same check, the same overflow flag."""
    spec, _ = _poisson(dtype, cuda, batch=2, nx=72)
    S0 = torch.zeros(spec.g.shape, dtype=dtype, device=cuda)
    omega = 2.5 if case == "diverging" else 1.5
    if case == "nan_seed":
        S0[1, 20, 40] = float("nan")
    kw = dict(omega=omega, tol=1e-12, max_iters=3000,
              check_every=check_every)
    spec_cpu = dataclasses.replace(spec, **{
        f: getattr(spec, f).cpu() for f in ("w", "w0", "g", "relax",
                                            "active")})
    plain = xt.solve(spec_cpu, S0.cpu(), **kw)
    for switch in (False, True):
        monkeypatch.setattr(sor2d, "INPLACE_KERNEL", switch)
        res = xt.solve(spec, S0, **kw)
        for field in ("iters", "overflow"):
            assert torch.equal(getattr(res, field).cpu(),
                               getattr(plain, field)), (switch, field)
    assert bool(plain.overflow.any())


def _munk(dtype, device, batch=7, ny=45, nx=96):
    """build_stommelmunk on a random curl, pruned as solve prunes it (radius
    2, 8 offsets, the two-row extend; (extend, periodic)): one land mask,
    so w, w0 and relax are shared and g varies a slice, as in the decade
    cell; 16 x 64 tiles, 3 x 2 of them."""
    from xinvert_tpu_torch.stencil import prune_zero_offsets
    rng = np.random.default_rng(11)
    lat = np.linspace(-70.0, 80.0, ny)
    lon = np.linspace(0.0, 360.0 - 360.0 / nx, nx)
    grid = Grid.make(("lat", "lon"), (lat, lon), "lat-lon",
                     bcs=("extend", "periodic"))
    Fdef = np.ones((ny, nx), bool)
    Fdef[12:20, 30:45] = False
    vals = torch.as_tensor(rng.normal(0, 1e-7, (batch, ny, nx)),
                           dtype=dtype, device=device)
    spec = prune_zero_offsets(problems.build_stommelmunk(
        vals, torch.as_tensor(Fdef, device=device), grid,
        dict(default_mParams, R=2e-4, D=100, A4=5e3)))
    return spec, torch.as_tensor(rng.normal(0, 1e-3, (batch, ny, nx)),
                                 dtype=dtype, device=device)


def _staged_case(case, dtype, device):
    """(spec, S0, slices a block, kernel, counter) of a staged walk."""
    if case in ("munk", "munk_spb1"):
        # walks of 3, 3 and a short last one of 1; per-slice g
        spec, S0 = _munk(dtype, device)
        return (spec, S0, 3 if case == "munk" else 1,
                sor2d.sor2d_sweeps_tiled, "TILED_LAUNCHES")
    if case == "ws16":
        # 16 offsets (their planes in shared memory) over 5 states, every
        # plane shared, g too: walks of 2, 2 and 1
        spec, S1 = _bih(dtype, device, ("extend", "periodic"))
        gen = torch.Generator(device="cpu").manual_seed(5)
        S0 = (torch.randn((5,) + tuple(S1.shape), generator=gen,
                          dtype=torch.float64) * 1e-3).to(dtype).to(device)
        return spec, S0, 2, sor2d.sor2d_sweeps_tiled, "TILED_LAUNCHES"
    spec, S0 = _poisson(dtype, device, batch=5, nx=72)     # in place
    return (spec, S0, 2, sor2d.sor2d_sweeps_tiled_inplace,
            "TILED_INPLACE_LAUNCHES")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", ["munk", "munk_spb1", "ws16", "inplace"])
def test_staged_walk_bit_equal_to_plain(cuda, monkeypatch, dtype, case):
    """The ping-pong tiled kernel's pipelined slice walk (blocks walking
    ``spb`` slices, the next slice's windows staged while one sweeps): 2k +
    1 sweeps with and without factors, states torch.equal to the plain
    version and to the same launches at one slice a block, |S| totals
    torch.equal to those, and TILED_STAGED_SLICES grown by
    ``tiled_slices``; a walk of one slice a block, and the in-place twin's
    walk, stage nothing."""
    spec, S0, spb, fn, counter = _staged_case(case, dtype, cuda)
    core = tuple(S0.shape[-2:])
    B = S0.shape[0]
    plan = sor2d.tile_plan(spec, core, dtype,
                           fn is sor2d.sor2d_sweeps_tiled_inplace)
    n = 2 * plan.k + 1
    rng = np.random.default_rng(4)
    fac = [float(torch.tensor(f, dtype=dtype))
           for f in 1.0 + 0.4 * rng.random(2 * n)]
    staged = sor2d.tiled_slices(plan, B, spb, core)[0]
    assert (staged > 0) == (spb > 1 and case != "inplace")
    for f, omega in ((None, 1.3), (fac, 1.0)):
        runs = {}
        for walk in (spb, 1):
            monkeypatch.setattr(sor2d, "_slices_per_block",
                                lambda *a, walk=walk, **k: walk)
            c0, s0 = getattr(sor2d, counter), sor2d.TILED_STAGED_SLICES
            runs[walk] = fn(spec, S0, omega, n, with_norm=True, fac=f)
            torch.cuda.synchronize()
            assert getattr(sor2d, counter) == c0 + 3
            assert sor2d.TILED_STAGED_SLICES == s0 + (
                3 * staged if walk > 1 else 0)
        out_p = sor2d.sor2d_sweeps_reference(spec, S0, omega, n, f)
        assert torch.equal(runs[spb][0], out_p)
        assert torch.equal(runs[1][0], out_p)
        assert torch.equal(runs[spb][1], runs[1][1])
        ref = out_p.double().abs().sum(dim=(-2, -1))
        rtol = 1e-5 if dtype == torch.float32 else 1e-12
        torch.testing.assert_close(runs[spb][1].double(), ref, rtol=rtol,
                                   atol=0)


def test_kernel_refuses_a_stage_it_does_not_take(cuda, monkeypatch):
    """Only ping-pong plans of more than 4 offsets stage their walk: a
    launch that asks a radius-1 plan (4 offsets) to stage is refused."""
    spec, S0 = _poisson(torch.float32, cuda, batch=3)
    assert not sor2d.tile_plan(spec, tuple(S0.shape[-2:]),
                               torch.float32).stage
    monkeypatch.setattr(sor2d, "tiled_slices",
                        lambda plan, B, spb, core: (1, B))
    with pytest.raises(RuntimeError, match="CUDA error"):
        sor2d.sor2d_sweeps_tiled(spec, S0, 1.3, 1)


@pytest.mark.parametrize("check_every", [1, 32])
@pytest.mark.parametrize("case", ["diverging", "nan_seed"])
def test_staged_walk_stops_like_the_plain_version(cuda, monkeypatch,
                                                  check_every, case):
    """The Stommel-Munk batch (it diverges at omega 1 on this coarse grid),
    with a NaN seeded in slice 4, through the staged walk (3 slices a
    block), against the same solve on the CPU: the same check, the same
    overflow flag."""
    spec, S0 = _munk(torch.float32, cuda)
    if case == "nan_seed":
        S0[4, 20, 50] = float("nan")
    kw = dict(omega=1.0, tol=1e-12, max_iters=300, check_every=check_every)
    spec_cpu = dataclasses.replace(spec, **{
        f: getattr(spec, f).cpu() for f in ("w", "w0", "g", "relax",
                                            "active")})
    plain = xt.solve(spec_cpu, S0.cpu(), **kw)
    monkeypatch.setattr(sor2d, "_slices_per_block", lambda *a, **k: 3)
    s0 = sor2d.TILED_STAGED_SLICES
    res = xt.solve(spec, S0, **kw)
    assert sor2d.TILED_STAGED_SLICES > s0
    for field in ("iters", "overflow"):
        assert torch.equal(getattr(res, field).cpu(), getattr(plain, field))
    assert bool(plain.overflow.all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_block_walk_of_slices_bit_equal_to_plain(cuda, monkeypatch, dtype):
    """The block mode (B2s) walks unstaged: a batch of 3 ghost-padded
    blocks at 2 slices a block, torch.equal to its plain version, NaN
    boundary lines included, with the |S| partials."""
    spec, S0, origin, owned, g, k = _block_case2d("batch_nan", dtype, cuda)
    from xinvert_tpu_torch.parallel import halo
    shape = tuple(S0.shape[-2:])
    P = halo.padded_block(S0, origin, owned, g)
    bspec = halo.padded_block_spec(spec, origin, owned, g)
    monkeypatch.setattr(sor2d, "_slices_per_block", lambda *a, **k: 2)
    for n in (1, k):
        res = sor2d.sor2d_sweeps_block(bspec, P, 1.3, n, origin, shape, g,
                                       with_norm=True)
        ref = sor2d.sor2d_sweeps_block_reference(bspec, P, 1.3, n, origin,
                                                 shape, g, None, True)
        torch.cuda.synchronize()
        assert _nan_equal(res[0], ref[0]) and _nan_equal(res[1], ref[1])


def test_solve_on_card_matches_cpu(cuda):
    spec, _ = _poisson(torch.float64, cuda, batch=2)
    S0 = torch.zeros(spec.g.shape, dtype=torch.float64, device=cuda)
    spec_cpu = StencilSpec(**{f: getattr(spec, f).cpu() for f in
                              ("w", "w0", "g", "relax", "active")},
                           offsets=spec.offsets, bcs=spec.bcs)
    r_k = xt.solve(spec, S0, omega=1.8, tol=1e-6, max_iters=400,
                   check_every=4)
    r_c = xt.solve(spec_cpu, S0.cpu(), omega=1.8, tol=1e-6, max_iters=400,
                   check_every=4)
    assert torch.equal(r_k.iters.cpu(), r_c.iters)
    torch.testing.assert_close(r_k.S.cpu(), r_c.S, rtol=1e-10, atol=1e-12)


def test_kernels_refuse_what_they_do_not_take(cuda):
    spec, S0 = _poisson(torch.float32, cuda)
    with pytest.raises(ValueError, match="on"):
        xt.solve(spec, S0.cpu())                       # devices differ
    with pytest.raises(ValueError):
        sor2d.sor2d_sweeps(spec, S0.double(), 1.3, 2)  # dtypes differ
    # a 3-D spec of one level goes to the 3-D kernels, which need 3 levels
    spec3 = StencilSpec(w=spec.w[:, None], w0=spec.w0[None], g=spec.g[None],
                        relax=spec.relax[None], active=spec.active[None],
                        offsets=tuple((0,) + o for o in spec.offsets),
                        bcs=("fixed",) + spec.bcs)
    with pytest.raises(ValueError, match="3x3x3"):
        xt.solve_fixed(spec3, S0[None], 1.3, 2)
    spec1 = StencilSpec(w=spec.w[:2, 0], w0=spec.w0[0], g=spec.g[0],
                        relax=spec.relax[0], active=spec.active[0],
                        offsets=((1,), (-1,)), bcs=("fixed",))
    with pytest.raises(NotImplementedError):        # the 2-D kernels: 1-D
        sor2d.sor2d_sweeps(spec1, S0[0], 1.3, 2)
    # the engine routes 1-D specs to the plain sweeps (no kernel takes 1-D)
    from xinvert_tpu_torch import solver
    t0, p0 = sor2d.TILED_LAUNCHES, sor2d.PLAIN_CALLS
    out = xt.solve_fixed(spec1, S0[0], 1.3, 2)
    assert (sor2d.TILED_LAUNCHES, sor2d.PLAIN_CALLS) == (t0, p0)
    assert out.is_cuda and torch.equal(out,
                                       solver.sweeps(spec1, S0[0], 1.3, 2))


# ---------------------------------------------------------------- 3-D


def _grid3(nz, ny, nx, bcs):
    lev = np.linspace(100000.0, 10000.0, nz)
    lat = np.linspace(-70.0, 70.0, ny)
    lon = np.linspace(0.0, 360.0 - 360.0 / nx, nx)
    return Grid.make(("lev", "lat", "lon"), (lev, lat, lon), "lat-lon",
                     bcs=bcs)


def _omega3d(dtype, device, batch=3, shape=(7, 19, 24)):
    """build_omega: batched forcing, shared weights."""
    rng = np.random.default_rng(2)
    grid = _grid3(*shape, ("fixed", "fixed", "periodic"))
    vals = torch.as_tensor(rng.standard_normal((batch,) + shape) * 1e-15,
                           dtype=dtype, device=device)
    mp = dict(default_mParams, N2=np.linspace(1e-4, 3e-4, shape[0])[:, None,
                                                                    None])
    spec = problems.build_omega(vals, torch.ones(shape, dtype=torch.bool,
                                                 device=device), grid, mp)
    return spec, torch.as_tensor(rng.normal(0, 1e-3, (batch,) + shape),
                                 dtype=dtype, device=device)


def _ocean3d(dtype, device, shape=(6, 15, 20), bcs=("fixed", "extend",
                                                     "periodic")):
    """build_ocean3d (general_3d) with a land block."""
    rng = np.random.default_rng(3)
    grid = _grid3(*shape, bcs)
    Fdef = np.ones(shape, bool)
    Fdef[:, 5:9, 4:10] = False
    vals = torch.as_tensor(rng.normal(0.0, 1e-11, shape), dtype=dtype,
                           device=device)
    spec = problems.build_ocean3d(vals, torch.as_tensor(Fdef, device=device),
                                  grid, default_mParams)
    return spec, torch.as_tensor(rng.normal(0, 1e-3, shape), dtype=dtype,
                                 device=device)


def _random3d(dtype, device, shape, batch, bcs, seed=4):
    """Random diagonally dominant 6-offset planes, per slice when
    batched."""
    from xinvert_tpu_torch.stencil import _interior_mask
    rng = np.random.default_rng(seed)
    offs = ((1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1),
            (0, 0, -1))
    full = ((batch,) if batch else ()) + shape
    active = np.broadcast_to(_interior_mask(shape, bcs, False), full).copy()
    active &= rng.random(full) > 0.05
    w = rng.uniform(0.05, 0.25, (6,) + full) * active
    w0 = np.where(active, -1.05 * w.sum(0), 0.0)
    relax = np.where(active, 1.0 / np.where(active, -w0, 1.0), 0.0)
    g = rng.normal(0, 1, full) * active
    spec = StencilSpec.from_arrays(w, w0, g, relax, active, offs, bcs,
                                   device=device, dtype=dtype)
    return spec, torch.as_tensor(rng.normal(0, 1e-3, full), dtype=dtype,
                                 device=device)


def _case3d(case, dtype, device):
    if case == "omega_batch":
        return _omega3d(dtype, device)
    if case == "ocean":
        return _ocean3d(dtype, device)
    if case == "ocean_fixed_x":
        return _ocean3d(dtype, device, bcs=("fixed", "extend", "fixed"))
    if case == "per_slice":
        return _random3d(dtype, device, (9, 17, 23), 2,
                         ("fixed", "extend", "fixed"))
    if case == "many_slices":   # batch x levels past the grid's z limit
        return _random3d(dtype, device, (32, 4, 5), 2100,
                         ("fixed", "extend", "periodic"), seed=6)
    return _random3d(dtype, device, (5, 7, 9), 0, ("fixed", "extend",
                                                    "fixed"), seed=5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", ["omega_batch", "ocean", "ocean_fixed_x",
                                  "per_slice", "many_slices", "odd"])
def test_kernel3d_bit_equal_to_plain(cuda, dtype, case):
    """The folded sweeps (two launches a sweep) bit-equal to the plain
    version, with the fused |S| totals of the kernels' order; each launch
    alone, unflagged on the extended state and with the extend flag."""
    from xinvert_tpu_torch import solver
    spec, S0 = _case3d(case, dtype, cuda)
    before = S0.clone()
    l0 = sor3d.LAUNCHES
    out_k, sumabs = sor3d.sor3d_sweeps(spec, S0, 1.3, 15, with_norm=True)
    out_p = sor3d.sor3d_sweeps_reference(spec, S0, 1.3, 15)
    torch.cuda.synchronize()
    assert sor3d.LAUNCHES == l0 + 30
    assert torch.equal(out_k, out_p)
    assert torch.equal(S0, before)
    assert torch.equal(sumabs, _plain3d(spec, S0, 1.3, 15, True)[1])
    # each launch alone
    ext = solver._apply_extend(spec, S0)
    rel = sor3d.relax_plane(spec, 1.3)
    for color in (0, 1):
        assert torch.equal(
            sor3d.sor3d_color_sweep(spec, ext, rel, color),
            sor3d.sor3d_color_sweep_reference(spec, ext, rel, color))
        assert torch.equal(
            sor3d.sor3d_color_sweep(spec, S0, rel, color, extend=True),
            sor3d.sor3d_color_sweep_reference(spec, S0, rel, color,
                                              extend=True))


def _plain3d(spec, S, omega, n, with_norm=False, fac=None):
    """The plain 3-D sweeps with sor3d_sweeps' signature; with
    ``with_norm`` the per-slice |S| totals in the kernels' order (each
    level's 32 x 8 blocks as sor2d.block_partials sums them, then
    slice_totals), so that a solve run on them stops where the kernels'
    does."""
    out = sor3d.sor3d_sweeps_reference(spec, S, omega, n, fac)
    if not with_norm:
        return out
    batch = tuple(out.shape[:-3])
    part = sor2d.block_partials(out).reshape(math.prod(batch), -1)
    return out, _driver.slice_totals(part).reshape(batch)


def _nan_equal(a, b):
    """torch.equal, NaN matching NaN in place."""
    na, nb = torch.isnan(a), torch.isnan(b)
    return torch.equal(na, nb) and torch.equal(torch.where(na, 0.0, a),
                                               torch.where(nb, 0.0, b))


def _shared3d(dtype, device, shape, batch, bcs, seed=7):
    """Random 6-offset planes shared by a batch (batch stride 0), a
    batched forcing."""
    spec, _ = _random3d(dtype, device, shape, 0, bcs, seed=seed)
    rng = np.random.default_rng(seed + 1)
    g = torch.as_tensor(rng.normal(0, 1, (batch,) + shape), dtype=dtype,
                        device=device) * spec.active
    spec = dataclasses.replace(spec, g=g.contiguous())
    return spec, torch.as_tensor(rng.normal(0, 1e-3, (batch,) + shape),
                                 dtype=dtype, device=device)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("bcs", [("fixed", "extend", "periodic"),
                                 ("fixed", "extend", "fixed")])
@pytest.mark.parametrize("nz,batch,shared", [(3, 0, False), (3, 2, True),
                                             (6, 2, False), (6, 3, True)])
def test_folded_pair_bit_equal_nan_and_factors(cuda, dtype, bcs, nz, batch,
                                               shared):
    """The folded pair at nz 3 (one interior level) and 6, per-slice and
    shared (batch stride 0) planes, n in {1, 2, 37} at omega and with
    Chebyshev factors, the |S| partials, and NaN/Inf seeded in the
    boundary rows of the interior levels: torch.equal to the plain
    version, two launches a sweep."""
    shape = (nz, 11, 13)
    if shared:
        spec, S0 = _shared3d(dtype, cuda, shape, batch, bcs)
    else:
        spec, S0 = _random3d(dtype, cuda, shape, batch, bcs, seed=8 + nz)
    S0[..., 1:-1, 0, :] = float("nan")
    S0[..., 1:-1, -1, :] = float("inf")
    for n in (1, 2, 37):
        facs = [float(torch.tensor(1.0 + 0.45 * (1 - 0.9 ** k), dtype=dtype))
                for k in range(2 * n)]
        for om, fac in ((1.3, None), (1.0, facs)):
            l0 = sor3d.LAUNCHES
            out, sumabs = sor3d.sor3d_sweeps(spec, S0, om, n, with_norm=True,
                                             fac=fac)
            ref = sor3d.sor3d_sweeps_reference(spec, S0, om, n, fac)
            torch.cuda.synchronize()
            assert sor3d.LAUNCHES == l0 + 2 * n
            assert bool(torch.isfinite(ref).all())
            assert torch.equal(out, ref)
            tot = ref.double().abs().sum(dim=(-3, -2, -1))
            rtol = 1e-5 if dtype == torch.float32 else 1e-12
            torch.testing.assert_close(sumabs.double(), tot, rtol=rtol,
                                       atol=0)
    # NaN on the z-edge levels' rows too: it spreads alike
    S1 = S0.clone()
    S1[..., :, 0, :] = float("nan")
    out = sor3d.sor3d_sweeps(spec, S1, 1.3, 3)
    assert _nan_equal(out, sor3d.sor3d_sweeps_reference(spec, S1, 1.3, 3))


def test_solve3d_on_card_matches_cpu(cuda):
    """A checked 3-D solve on the card against the same call on the CPU,
    float64: the same sweeps, the stopping rule fed by the fused |S|
    partials instead of a sum on the CPU."""
    rng = np.random.default_rng(6)
    nz, ny, nx = 8, 20, 30
    lev = np.linspace(0.0, 2100.0, nz)
    lat = np.linspace(-60.0, 60.0, ny)
    lon = np.linspace(0.0, 360.0 - 360.0 / nx, nx)
    F = rng.normal(0.0, 1e-11, (nz, ny, nx))
    F[:, 8:12, 10:16] = np.nan
    f = xt.Field(F, ("LEV", "lat", "lon"), {"LEV": lev, "lat": lat,
                                             "lon": lon})
    iP = {"BCs": ["fixed", "extend", "periodic"], "tolerance": 1e-8,
          "mxLoop": 300, "printInfo": False}
    mP = {"N2": xt.Field(1e-5 * np.exp(-lev / 800.0) + 1e-7, ("LEV",),
                         {"LEV": lev})}
    dtype = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        from xinvert_tpu_torch.models import api
        l0 = sor3d.LAUNCHES
        w_k = xt.invert_3DOcean(f, dims=["LEV", "lat", "lon"], iParams=iP,
                                mParams=mP)
        r_k = api.LAST_SOLVE
        assert sor3d.LAUNCHES > l0 and r_k.S.is_cuda
        w_c = xt.invert_3DOcean(f, dims=["LEV", "lat", "lon"], iParams=iP,
                                mParams=mP, device="cpu")
        r_c = api.LAST_SOLVE
    finally:
        torch.set_default_dtype(dtype)
    assert torch.equal(r_k.iters.cpu(), r_c.iters)
    ocean = ~np.isnan(F)
    np.testing.assert_array_equal(np.isnan(w_k.values), ~ocean)
    np.testing.assert_allclose(w_k.values[ocean], w_c.values[ocean],
                               rtol=1e-10, atol=1e-12 * np.abs(
                                   w_c.values[ocean]).max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_folded_pair_on_the_entry_point(cuda, monkeypatch, dtype):
    """invert_3DOcean on the card sweeps through the folded pair alone (two
    launches a sweep) and gives the iters and the state of the same call
    with the plain sweeps on the card (their norms in the kernels'
    order)."""
    from xinvert_tpu_torch.models import api
    rng = np.random.default_rng(9)
    nz, ny, nx = 6, 20, 30
    lev = np.linspace(0.0, 750.0, nz)
    F = rng.normal(0.0, 1e-11, (nz, ny, nx))
    F[:, 8:12, 10:16] = np.nan
    f = xt.Field(F, ("LEV", "lat", "lon"), {
        "LEV": lev, "lat": np.linspace(-60.0, 60.0, ny),
        "lon": np.linspace(0.0, 348.0, nx)})
    kw = dict(dims=["LEV", "lat", "lon"], mParams={"N2": 1e-5},
              iParams={"BCs": ["fixed", "extend", "periodic"],
                       "tolerance": 1e-8, "mxLoop": 200, "checkEvery": 1,
                       "printInfo": False})
    default = torch.get_default_dtype()
    torch.set_default_dtype(dtype)
    try:
        l0 = sor3d.LAUNCHES
        xt.invert_3DOcean(f, **kw)
        r_f = api.LAST_SOLVE
        assert sor3d.LAUNCHES - l0 == 2 * int(r_f.iters)
        monkeypatch.setattr(sor3d, "sor3d_sweeps", _plain3d)
        l0 = sor3d.LAUNCHES
        xt.invert_3DOcean(f, **kw)
        r_p = api.LAST_SOLVE
        assert sor3d.LAUNCHES == l0 and r_p.S.is_cuda
    finally:
        torch.set_default_dtype(default)
    assert torch.equal(r_f.iters, r_p.iters)
    assert torch.equal(r_f.S, r_p.S)


@pytest.mark.parametrize("case", ["extend_periodic", "fixed_periodic",
                                  "symmetric", "masked"])
def test_direct_on_card_matches_cpu(cuda, case):
    """solve(scheme='direct') and the masked capacitance path on the card
    against the same call on the CPU, float64: the same engine in torch
    ops on two devices (cuFFT and the CPU FFT round differently), within
    1e-10 of max|S|."""
    from xinvert_tpu_torch.ops import direct
    ny, nx = 33, 64
    rng = np.random.default_rng(10)
    F = rng.normal(0.0, 1e-5, (2, ny, nx))
    bcs = {"extend_periodic": ("extend", "periodic"),
           "fixed_periodic": ("fixed", "periodic"),
           "symmetric": ("extend", "fixed"),
           "masked": ("extend", "periodic")}[case]
    holes = np.zeros((ny, nx), bool)
    if case == "masked":
        holes[10:14, 20:30] = True
        holes[20, 5] = True
    outs = []
    for dev in (cuda, torch.device("cpu")):
        grid = Grid.make(("lat", "lon"), (np.linspace(-80, 80, ny),
                                          np.linspace(0, 354.375, nx)),
                         "lat-lon", bcs=bcs)
        spec = problems.build_poisson(
            torch.as_tensor(F, device=dev),
            torch.ones((ny, nx), dtype=torch.bool, device=dev), grid,
            default_mParams)
        S0 = torch.zeros((2, ny, nx), dtype=torch.float64, device=dev)
        if case == "masked":
            outs.append(direct.solve_direct_masked(spec, holes, S0))
        else:
            res = xt.solve(spec, S0, scheme="direct")
            assert res.iters.tolist() == [1, 1]
            outs.append(res.S)
    card, cpu = outs
    assert card.is_cuda
    scale = float(cpu.abs().max())
    assert float((card.cpu() - cpu).abs().max()) <= 1e-10 * scale


def test_kernels3d_refuse_what_they_do_not_take(cuda):
    spec, S0 = _ocean3d(torch.float32, cuda)
    rel = sor3d.relax_plane(spec, 1.3)
    with pytest.raises(ValueError, match="on"):
        xt.solve(spec, S0.cpu())                            # devices differ
    with pytest.raises(ValueError):
        sor3d.sor3d_sweeps(spec, S0.double(), 1.3, 2)       # dtypes differ
    with pytest.raises(TypeError):
        sor3d.sor3d_sweeps(spec, S0.half(), 1.3, 2)         # no half kernel
    many = dataclasses.replace(
        spec, w=torch.cat([spec.w, spec.w[:3]]),
        offsets=spec.offsets + spec.offsets[:3])
    with pytest.raises(ValueError, match="at most"):        # K > MAX_K
        sor3d.sor3d_sweeps(many, S0, 1.3, 2)
    strided = dataclasses.replace(spec, w0=spec.w0.transpose(1, 2)
                                  .contiguous().transpose(1, 2))
    with pytest.raises(ValueError, match="contiguous"):     # bad strides
        sor3d.sor3d_sweeps(strided, S0, 1.3, 2)
    with pytest.raises(ValueError):                         # rel on the CPU
        sor3d.sor3d_color_sweep(spec, S0, rel.cpu(), 0)
    with pytest.raises(ValueError, match="color"):
        sor3d.sor3d_color_sweep(spec, S0, rel, 2)
    far = dataclasses.replace(spec, offsets=((9,) + spec.offsets[0][1:],)
                              + spec.offsets[1:])
    with pytest.raises(ValueError, match="does not fit"):   # offset >= nz
        sor3d.sor3d_sweeps(far, S0, 1.3, 2)


# ------------------------------------------- the in-place kernel and fac


def _stommel(dtype, device, ny=40, nx=72, batch=2):
    """build_stommel (general_2d, cross planes zero), pruned as solve prunes
    it: a radius-1 stencil without cross terms, NaN land block."""
    from xinvert_tpu_torch.stencil import prune_zero_offsets
    rng = np.random.default_rng(7)
    lat = np.linspace(-70.0, 80.0, ny)
    lon = np.linspace(0.0, 360.0 - 360.0 / nx, nx)
    grid = Grid.make(("lat", "lon"), (lat, lon), "lat-lon",
                     bcs=("extend", "periodic"))
    Fdef = np.ones((ny, nx), bool)
    Fdef[10:18, 20:31] = False
    vals = torch.as_tensor(rng.normal(0, 1e-7, (batch, ny, nx)),
                           dtype=dtype, device=device)
    spec = prune_zero_offsets(problems.build_stommel(
        vals, torch.as_tensor(Fdef, device=device), grid,
        dict(default_mParams, R=2e-3)))
    return spec, torch.as_tensor(rng.normal(0, 1e-3, (batch, ny, nx)),
                                 dtype=dtype, device=device)


def _inplace_case(case, dtype, device):
    if case == "poisson":
        return _poisson(dtype, device, nx=72)
    if case == "poisson_batch":
        return _poisson(dtype, device, batch=3, nx=72)
    if case == "fixed_odd":              # no periodic axis: odd sizes pass
        return _poisson(dtype, device, ny=21, nx=25, bcs=("fixed", "fixed"))
    if case == "per_slice":
        from xinvert_tpu_torch.stencil import _interior_mask
        rng = np.random.default_rng(8)
        offs = ((1, 0), (-1, 0), (0, 1), (0, -1))
        bcs = ("extend", "fixed")
        shape = (2, 17, 23)
        active = np.broadcast_to(_interior_mask(shape[1:], bcs, False),
                                 shape).copy()
        active &= rng.random(shape) > 0.05
        w = rng.uniform(0.05, 0.25, (4,) + shape) * active
        w0 = np.where(active, -1.05 * w.sum(0), 0.0)
        relax = np.where(active, 1.0 / np.where(active, -w0, 1.0), 0.0)
        g = rng.normal(0, 1, shape) * active
        spec = StencilSpec.from_arrays(w, w0, g, relax, active, offs, bcs,
                                       device=device, dtype=dtype)
        return spec, torch.as_tensor(rng.normal(0, 1e-3, shape), dtype=dtype,
                                     device=device)
    return _stommel(dtype, device)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", ["poisson", "poisson_batch", "fixed_odd",
                                  "per_slice", "stommel"])
def test_inplace_kernel_bit_equal_to_plain(cuda, dtype, case):
    """The in-place tiled kernel, 20 sweeps with and without partials and
    factors, against the plain version, and its fused |S| totals and
    states against the ping-pong kernel's."""
    spec, S0 = _inplace_case(case, dtype, cuda)
    core = tuple(S0.shape[-2:])
    assert sor2d.inplace_eligible(spec, core)
    before = S0.clone()
    launches = -(-20 // sor2d.tile_plan(spec, core, dtype, True).k)
    rng = np.random.default_rng(9)
    for fac in (None, list(1.0 + rng.random(40))):
        fac = None if fac is None else [float(torch.tensor(f, dtype=dtype))
                                        for f in fac]
        i0, m0 = sor2d.TILED_INPLACE_LAUNCHES, _main_2d()
        out_k = sor2d.sor2d_sweeps_tiled_inplace(spec, S0, 1.3, 20, fac=fac)
        out_n, sumabs = sor2d.sor2d_sweeps_tiled_inplace(
            spec, S0, 1.3, 20, with_norm=True, fac=fac)
        out_p = sor2d.sor2d_sweeps_reference(spec, S0, 1.3, 20, fac)
        torch.cuda.synchronize()
        assert sor2d.TILED_INPLACE_LAUNCHES == i0 + 2 * launches
        assert _main_2d() == m0 + 2 * launches
        assert torch.equal(out_k, out_p) and torch.equal(out_n, out_p)
        ref = out_p.double().abs().sum(dim=(-2, -1))
        rtol = 1e-5 if dtype == torch.float32 else 1e-12
        torch.testing.assert_close(sumabs.double(), ref, rtol=rtol, atol=0)
        out_t, sum_t = sor2d.sor2d_sweeps_tiled(spec, S0, 1.3, 20,
                                                with_norm=True, fac=fac)
        assert torch.equal(out_t, out_k) and torch.equal(sum_t, sumabs)
    assert torch.equal(S0, before)


def test_inplace_race_gate(cuda, monkeypatch):
    """An odd nx with periodic x joins two cells of one color across the
    wrap: the in-place wrapper refuses it, and the switched-on sweeps run
    the other kernels instead (counted); a spec with cross terms is
    refused too."""
    spec, S0 = _poisson(torch.float64, cuda, nx=71)
    assert not sor2d.inplace_eligible(spec, tuple(S0.shape))
    with pytest.raises(ValueError, match="even"):
        sor2d.sor2d_sweeps_tiled_inplace(spec, S0, 1.3, 2)
    monkeypatch.setattr(sor2d, "INPLACE_KERNEL", True)
    ti0 = sor2d.TILED_INPLACE_LAUNCHES
    m0 = _main_2d()
    out = sor2d.sor2d_sweeps(spec, S0, 1.3, 4)
    assert _main_2d() > m0 and sor2d.TILED_INPLACE_LAUNCHES == ti0
    assert torch.equal(out, sor2d.sor2d_sweeps_reference(spec, S0, 1.3, 4))
    t0 = sor2d.TILED_LAUNCHES
    out = sor2d.sor2d_sweeps_tiled(spec, S0, 1.3, 4)
    assert sor2d.TILED_LAUNCHES > t0
    assert torch.equal(out, sor2d.sor2d_sweeps_reference(spec, S0, 1.3, 4))
    cross, S1 = _poisson(torch.float64, cuda)
    cross = dataclasses.replace(cross, w=torch.cat([cross.w, cross.w[:1]]),
                                offsets=cross.offsets + ((1, 1),))
    with pytest.raises(ValueError, match="cross"):
        sor2d.sor2d_sweeps_tiled_inplace(cross, S1, 1.3, 2)


@pytest.mark.parametrize("dtype,check_every", [(torch.float32, 1),
                                               (torch.float32, 32),
                                               (torch.float64, 1)])
@pytest.mark.parametrize("case", ["diverging", "nan_seed"])
def test_inplace_stops_like_the_ping_pong(cuda, monkeypatch, dtype,
                                         check_every, case):
    """A diverging solve (omega 2.5) and a NaN seeded in the interior of
    the state: the in-place tiled kernel and the ping-pong one (each run by
    the solve with ``sor2d_sweeps`` set to it) stop at the same check with
    the same overflow flag."""
    spec, _ = _poisson(dtype, cuda, batch=2, nx=72)
    S0 = torch.zeros(spec.g.shape, dtype=dtype, device=cuda)
    omega = 2.5 if case == "diverging" else 1.5
    if case == "nan_seed":
        S0[1, 20, 40] = float("nan")
    res = {}
    for inplace in (False, True):
        monkeypatch.setattr(sor2d, "sor2d_sweeps",
                            sor2d.sor2d_sweeps_tiled_inplace if inplace
                            else sor2d.sor2d_sweeps_tiled)
        i0 = sor2d.TILED_INPLACE_LAUNCHES
        res[inplace] = xt.solve(spec, S0, omega=omega, tol=1e-12,
                                max_iters=3000, check_every=check_every)
        assert (sor2d.TILED_INPLACE_LAUNCHES > i0) == inplace
    for field in ("iters", "overflow"):
        assert torch.equal(getattr(res[True], field),
                           getattr(res[False], field)), field
    assert bool(res[True].overflow.any())


def test_color_sweep3d_takes_a_factor(cuda):
    """The fac argument of sor3d_color_sweep, alone (with and without the
    extend flag) and through 20 sweeps with factors, bit-equal to the plain
    versions."""
    for spec, S0 in (_ocean3d(torch.float32, cuda),
                     _omega3d(torch.float64, cuda)):
        rel = sor3d.relax_plane(spec, 1.0)
        for color in (0, 1):
            for ext in (False, True):
                assert torch.equal(
                    sor3d.sor3d_color_sweep(spec, S0, rel, color, 1.43, ext),
                    sor3d.sor3d_color_sweep_reference(spec, S0, rel, color,
                                                      1.43, ext))
        fac = [float(torch.tensor(1.0 + 0.02 * k, dtype=S0.dtype))
               for k in range(40)]
        out_k = sor3d.sor3d_sweeps(spec, S0, 1.0, 20, fac=fac)
        out_p = sor3d.sor3d_sweeps_reference(spec, S0, 1.0, 20, fac)
        assert torch.equal(out_k, out_p)


@pytest.mark.parametrize("switch", [False, True])
def test_cheby_solve_on_card_matches_cpu(cuda, monkeypatch, switch):
    monkeypatch.setattr(sor2d, "INPLACE_KERNEL", switch)
    spec, _ = _stommel(torch.float64, cuda)
    S0 = torch.zeros(spec.g.shape, dtype=torch.float64, device=cuda)
    spec_cpu = dataclasses.replace(spec, **{
        f: getattr(spec, f).cpu() for f in ("w", "w0", "g", "relax",
                                            "active")})
    kw = dict(omega=1.6, tol=1e-9, max_iters=500, check_every=4,
              scheme="cheby")
    i0, r0 = sor2d.TILED_INPLACE_LAUNCHES, sor2d.RESIDENT_LAUNCHES
    r_k = xt.solve(spec, S0, **kw)
    resident = sor2d.resident_plan(spec, tuple(S0.shape[-2:]),
                                   S0.dtype) is not None
    assert (sor2d.RESIDENT_LAUNCHES > r0) == resident
    assert (sor2d.TILED_INPLACE_LAUNCHES > i0) == (switch and not resident)
    r_c = xt.solve(spec_cpu, S0.cpu(), **kw)
    assert torch.equal(r_k.iters.cpu(), r_c.iters)
    torch.testing.assert_close(r_k.S.cpu(), r_c.S, rtol=1e-10, atol=1e-12)


# ------------------------------------------------------------- multigrid

def _mg_poisson(dtype, device, ny=129, nx=128, bcs=("extend", "periodic")):
    """A masked cartesian Poisson pyramid (point smoothing) on the card."""
    from xinvert_tpu_torch import mg
    rng = np.random.default_rng(0)
    A = torch.as_tensor(np.abs(rng.normal(1, .05, (ny, nx))) + 1.0,
                        dtype=dtype, device=device)
    F = torch.as_tensor(rng.normal(0, 1e-9, (ny, nx)), dtype=dtype,
                        device=device)
    Fdef = np.ones((ny, nx), bool)
    Fdef[ny // 3:ny // 2, nx // 4:nx // 2] = False
    return mg.build_pyramid_standard2d(A, 0.0, A, F, Fdef, (1.2e5, 1.0e5),
                                       bcs)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("inplace", [False, True])
def test_mg_smoothing_through_the_kernel(cuda, monkeypatch, dtype, inplace):
    """mg._smooth on every level of a pyramid, single and with a batched
    forcing (a g_override plane per member), through the tiled kernel:
    torch.equal to the plain version on the same CUDA tensors."""
    from xinvert_tpu_torch import mg
    monkeypatch.setattr(sor2d, "INPLACE_KERNEL", inplace)
    levels = _mg_poisson(dtype, cuda)
    assert len(levels) >= 3 and levels[0].smoother == "point"
    gen = torch.Generator(device="cpu").manual_seed(3)
    for lv in levels:
        shape = tuple(lv.spec.w0.shape)
        g3 = torch.randn((3,) + shape, generator=gen, dtype=torch.float64)
        batched = dataclasses.replace(lv, spec=mg._with_g(
            lv.spec, g3.to(dtype=dtype, device=cuda)))
        for level, batch in ((lv, ()), (batched, (3,))):
            S = (torch.randn(batch + shape, generator=gen,
                             dtype=torch.float64) * 1e-2).to(dtype).to(cuda)
            for n in (1, 2, 3, 60):
                t0 = _main_2d()
                p0 = sor2d.PLAIN_CALLS
                out = mg._smooth(level, S, n)
                ref = sor2d.sor2d_sweeps_reference(level.spec, S,
                                                   level.omega, n)
                assert _main_2d() > t0
                assert sor2d.PLAIN_CALLS == p0 + 1
                assert torch.equal(out, ref), (shape, batch, n)


def test_mg_solve_on_card_equals_plain_on_card(cuda, monkeypatch):
    """A 129x128 solve_mg (fmg, float32) through the kernel equals the same
    solve with the plain sweeps on the same card: the same cycles,
    bit-equal states."""
    from xinvert_tpu_torch import mg
    levels = _mg_poisson(torch.float32, cuda)
    t0 = sor2d.TILED_LAUNCHES
    S_k, k_k, r_k, ok_k = mg.solve_mg(levels, tol=1e-5, max_cycles=40,
                                      fmg=True)
    assert sor2d.TILED_LAUNCHES > t0
    monkeypatch.setattr(mg, "_select_kernel",
                        lambda spec, S: sor2d.sor2d_sweeps_reference)
    S_p, k_p, r_p, ok_p = mg.solve_mg(levels, tol=1e-5, max_cycles=40,
                                      fmg=True)
    assert (k_k, r_k, ok_k) == (k_p, r_p, ok_p) and ok_k
    assert torch.equal(S_k, S_p)


def test_invert_poisson_mg_defaults_to_the_card(cuda):
    """invert_Poisson_mg with no device argument smooths through the tiled
    kernel (no plain call) and agrees with a float64 CPU run."""
    rng = np.random.default_rng(2)
    ny, nx = 65, 128
    lat = np.linspace(-60.0, 60.0, ny)
    lon = np.linspace(0.0, 360.0 - 360.0 / nx, nx)
    vals = rng.standard_normal((2, ny, nx)) * 1e-5
    vals[:, 20:30, 40:60] = np.nan
    F = xt.Field(vals, ("time", "lat", "lon"),
                 {"time": np.arange(2.0), "lat": lat, "lon": lon})
    iP = {"BCs": ["extend", "periodic"], "undef": np.nan}
    t0, p0 = _main_2d(), sor2d.PLAIN_CALLS
    out = xt.invert_Poisson_mg(F, ["lat", "lon"], iParams=iP, tol=1e-6)
    assert _main_2d() > t0 and sor2d.PLAIN_CALLS == p0
    dtype = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        ref = xt.invert_Poisson_mg(F, ["lat", "lon"], iParams=iP, tol=1e-6,
                                   device="cpu")
    finally:
        torch.set_default_dtype(dtype)
    ok = ~np.isnan(ref.values)
    np.testing.assert_array_equal(np.isnan(out.values), ~ok)
    assert (np.abs(out.values[ok] - ref.values[ok]).max()
            <= 1e-4 * np.abs(ref.values[ok]).max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("scheme", ["sor", "cheby"])
def test_trajectory_frames_through_the_kernels(cuda, dtype, scheme):
    """solve_trajectory on the card: the tiled 2-D kernel (and the folded
    3-D pair) launch for every frame, and every frame is torch.equal to
    the same trajectory through the plain sweeps on the card."""
    from xinvert_tpu_torch import solver
    spec, S0 = _poisson(dtype, cuda, batch=2)
    omega = 1.7
    t0, p0 = _main_2d(), sor2d.PLAIN_CALLS
    frames = solver.solve_trajectory(spec, S0, omega, loop_per_frame=5,
                                     max_frames=6, scheme=scheme)
    assert _main_2d() - t0 >= 6 and sor2d.PLAIN_CALLS == p0
    rho2 = solver.rho2_from_omega(omega, dtype)
    S, m, w = S0, 0, rho2.dtype.type(1.0)
    for k in range(6):
        if scheme == "sor":
            S = solver.sweeps(spec, S, omega, 5)
        else:
            fac, m, w = solver._cheby_factors(m, w, rho2, 10)
            S = solver.sweeps(spec, S, 1.0, 5, fac)
        assert torch.equal(frames[k], S), k
    fixed = solver.solve_fixed if scheme == "sor" else \
        solver.solve_fixed_cheby
    assert torch.equal(frames[-1], fixed(spec, S0, omega, 30))

    spec3, S3 = _random3d(dtype, cuda, (6, 12, 20), 2,
                          ("fixed", "extend", "periodic"))
    l0 = sor3d.LAUNCHES
    frames3 = solver.solve_trajectory(spec3, S3, 1.4, loop_per_frame=2,
                                      max_frames=3, scheme=scheme)
    assert sor3d.LAUNCHES - l0 == 12
    S = S3
    rho2_3 = solver.rho2_from_omega(1.4, dtype)
    m, w = 0, rho2_3.dtype.type(1.0)
    for k in range(3):
        if scheme == "sor":
            S = solver.sweeps(spec3, S, 1.4, 2)
        else:
            fac, m, w = solver._cheby_factors(m, w, rho2_3, 4)
            S = solver.sweeps(spec3, S, 1.0, 2, fac)
        assert _nan_equal(frames3[k], S), k


def test_lexico_on_card_matches_cpu(cuda):
    """scheme="lexico" on the card, float64, against the same calls on the
    CPU: invert_Poisson (2-D rows, periodic x, two slices), invert_omega
    (3-D hyperplanes) and invert_GeoAdjustment (1-D): equal iters, S within
    1e-10 of max|S|, and no kernel launch."""
    rng = np.random.default_rng(9)
    lat = np.linspace(-80.0, 80.0, 25)
    lon = np.arange(48) * 7.5
    F2 = xt.Field(rng.standard_normal((2, 25, 48)) * 1e-5,
                  ("t", "lat", "lon"),
                  {"t": np.arange(2), "lat": lat, "lon": lon})
    lev = np.linspace(100000.0, 20000.0, 7)
    F3 = xt.Field(rng.standard_normal((7, 25, 48)) * 1e-16,
                  ("lev", "lat", "lon"), {"lev": lev, "lat": lat, "lon": lon})
    glat = np.linspace(-75.0, -25.0, 41)
    F1 = xt.Field(1500.0 + 20.0 * (glat > -50) + rng.standard_normal(
        (3, 41)), ("t", "lat"), {"t": np.arange(3), "lat": glat})
    calls = [
        lambda **kw: xt.invert_Poisson(
            F2, ["lat", "lon"], iParams={
                "BCs": ["fixed", "periodic"], "mxLoop": 300,
                "tolerance": 1e-6, "scheme": "lexico", "printInfo": False},
            **kw),
        lambda **kw: xt.invert_omega(
            F3, ["lev", "lat", "lon"], iParams={
                "BCs": ["fixed", "extend", "periodic"], "mxLoop": 40,
                "tolerance": 1e-5, "scheme": "lexico", "printInfo": False},
            **kw),
        lambda **kw: xt.invert_GeoAdjustment(
            F1, ["lat"], iParams={
                "BCs": ["extend"], "mxLoop": 3000, "tolerance": 1e-9,
                "optArg": 1.8, "scheme": "lexico", "printInfo": False},
            **kw)]
    from xinvert_tpu_torch.models import api
    dtype = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        for call in calls:
            n0 = (_main_2d(), sor3d.LAUNCHES, sor2d.PLAIN_CALLS,
                  sor3d.PLAIN_CALLS)
            out_k = call()
            r_k = api.LAST_SOLVE
            assert r_k.S.is_cuda
            assert n0 == (_main_2d(), sor3d.LAUNCHES,
                          sor2d.PLAIN_CALLS, sor3d.PLAIN_CALLS)
            out_c = call(device="cpu")
            assert torch.equal(r_k.iters.cpu(), api.LAST_SOLVE.iters)
            scale = np.abs(out_c.values).max()
            assert scale > 0
            np.testing.assert_allclose(out_k.values, out_c.values, rtol=0,
                                       atol=1e-10 * scale)
    finally:
        torch.set_default_dtype(dtype)


def _plain_sweeps(spec, S, omega, n, with_norm=False, fac=None):
    """The plain version with the kernel wrapper's signature: patched over
    ``sor2d.sor2d_sweeps`` it runs a solve's sweeps as torch ops on the
    card."""
    if with_norm:
        return sor2d.sor2d_sweeps_reference_norm(spec, S, omega, n, fac)
    return sor2d.sor2d_sweeps_reference(spec, S, omega, n, fac)


def test_eft_exact_on_the_card(cuda):
    """TwoSum / TwoProd on the card are error-free: s + e equals the
    float64 sum and product exactly (exponents spread over 1e+-8)."""
    from xinvert_tpu_torch.ops.compensated import two_prod, two_sum
    rng = np.random.default_rng(0)
    n = 1 << 20
    a, b = ((rng.normal(0, 1, n) * 10.0 ** rng.integers(-8, 9, n)).astype(
        np.float32) for _ in range(2))
    ta, tb = torch.from_numpy(a).to(cuda), torch.from_numpy(b).to(cuda)
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    for fn, exact in ((two_sum, a64 + b64), (two_prod, a64 * b64)):
        s, e = fn(ta, tb)
        assert np.array_equal(s.double().cpu().numpy()
                              + e.double().cpu().numpy(), exact), fn


@pytest.mark.parametrize("chunk", [1, 2])
def test_streamed_bit_equal_to_resident_on_the_card(cuda, chunk):
    """solve_streamed of a host spec on the card, chunk 1 and a padded
    chunk 2, equals the resident batched solve of the same spec on the card
    bit for bit (S, iters, rel_change, overflow), through the tiled kernel
    alone."""
    spec, _ = _poisson(torch.float32, "cpu", batch=5, ny=45, nx=70)
    rng = np.random.default_rng(4)
    spec = dataclasses.replace(spec, g=spec.g * torch.as_tensor(
        rng.uniform(0.5, 2.0, (5, 1, 1)), dtype=torch.float32))
    S0 = torch.zeros(spec.g.shape, dtype=torch.float32)
    kw = dict(omega=1.7, tol=1e-5, max_iters=600, check_every=8)
    dev = dataclasses.replace(spec, **{f: getattr(spec, f).to(cuda) for f in
                                       ("w", "w0", "g", "relax", "active")})
    ref = xt.solve(dev, S0.to(cuda), **kw)
    t0, p0 = _main_2d(), sor2d.PLAIN_CALLS
    got = xt.solve_streamed(spec, S0, chunk=chunk, **kw)
    assert _main_2d() > t0 and sor2d.PLAIN_CALLS == p0
    for f in ("S", "iters", "rel_change", "overflow"):
        assert getattr(got, f).device.type == "cpu"
        assert torch.equal(getattr(got, f), getattr(ref, f).cpu()), f


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_implicit_gradient_kernel_equals_plain_on_the_card(cuda, monkeypatch,
                                                           dtype):
    """The gradient of sum(c * S) in g and w through solve_implicit on the
    card (forward and adjoint through the tiled kernel, the extend fold)
    equals the same gradient through the plain sweeps on the card, bit for
    bit, at a fixed sweep count (tol 0: no stopping decision)."""
    spec, _ = _poisson(dtype, cuda, ny=45, nx=70)
    c = torch.as_tensor(np.random.default_rng(5).standard_normal(
        spec.g.shape), dtype=dtype, device=cuda)
    S0 = torch.zeros(spec.g.shape, dtype=dtype, device=cuda)

    def grads():
        g = spec.g.clone().requires_grad_()
        w = spec.w.clone().requires_grad_()
        S = xt.solve_implicit(dataclasses.replace(spec, g=g, w=w), S0,
                              omega=1.7, tol=0.0, max_iters=200,
                              check_every=200)
        torch.sum(c * S).backward()
        return S.detach(), g.grad, w.grad

    t0, p0 = _main_2d(), sor2d.PLAIN_CALLS
    kern = grads()
    assert _main_2d() > t0 and sor2d.PLAIN_CALLS == p0
    monkeypatch.setattr(sor2d, "sor2d_sweeps", _plain_sweeps)
    plain = grads()
    assert sor2d.PLAIN_CALLS > p0
    for a, b in zip(kern, plain):
        assert torch.equal(a, b)


def test_refined_on_the_card(cuda):
    """solve_refined on the card: round 0 and every correction through the
    tiled kernel (no plain call), the certificate below tol and within
    1e-3 of the float64 residual of the pair."""
    from xinvert_tpu_torch.solver import _residual_norm, _residual_scale
    lat = np.linspace(-88.75, 88.75, 96)
    lon = np.linspace(0.0, 360.0 - 360.0 / 192, 192)
    grid = Grid.make(("lat", "lon"), (lat, lon), "lat-lon",
                     bcs=("extend", "periodic"))
    vor = (np.sin(3 * np.deg2rad(lon))[None, :]
           * np.cos(2 * np.deg2rad(lat))[:, None] * 1e-5)
    spec = problems.build_poisson(
        torch.as_tensor(vor, dtype=torch.float32, device=cuda),
        torch.ones((96, 192), dtype=torch.bool, device=cuda), grid,
        default_mParams)
    t0, p0 = sor2d.TILED_LAUNCHES, sor2d.PLAIN_CALLS
    r = xt.solve_refined(spec, torch.zeros((96, 192), device=cuda,
                                           dtype=torch.float32),
                         omega=grid.omega_opt, tol=1e-9, max_rounds=5)
    assert sor2d.TILED_LAUNCHES > t0 and sor2d.PLAIN_CALLS == p0
    cert = float(r.rel_residual)
    assert cert <= 1e-9 and r.rounds >= 1
    s64 = dataclasses.replace(spec, **{f: getattr(spec, f).double() for f in
                                       ("w", "w0", "g", "relax")})
    truth = float(_residual_norm(s64, r.S_hi.double() + r.S_lo.double())
                  / _residual_scale(s64))
    assert abs(cert - truth) <= 1e-3 * truth


# ------------------------------------------- B2s, B5s and the local meshes

def _card_mesh(device, shape, names):
    from xinvert_tpu_torch.parallel.mesh import Mesh
    arr = np.empty(int(np.prod(shape)), dtype=object)
    arr[:] = [device] * arr.size
    return Mesh(arr.reshape(shape), names)


def _block_case2d(case, dtype, device):
    """(spec, S0, origin, owned, ghosts, k) of one block of a 2-D grid."""
    if case == "y_odd_origin":
        spec, S0 = _poisson(dtype, device)
        return spec, S0, (13, 0), (17, 70), (9, 0), 4
    if case == "x_extend_corners":
        spec, S0 = _poisson(dtype, device, bcs=("extend", "fixed"))
        return spec, S0, (8, 32), (16, 38), (9, 9), 4
    if case == "bih_rows":
        spec, S0 = _bih(dtype, device, ("extend", "periodic"))
        return spec, S0, (8, 0), (13, 26), (6, 0), 1
    spec, S0 = _poisson(dtype, device, batch=3)       # batch, NaN lines
    S0[..., 0, :] = float("nan")
    S0[..., -1, :] = float("nan")
    return spec, S0, (24, 0), (21, 70), (9, 0), 4


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", ["y_odd_origin", "x_extend_corners",
                                  "bih_rows", "batch_nan"])
def test_block2d_kernel_bit_equal_to_plain(cuda, dtype, case):
    """One launch of sor2d_sweeps_block (n in {1, k}, with and without
    factors) against its plain version: the owned cells, and the |S|
    partials where the origin is aligned; then 37 sweeps with factors
    through the executor on a 2x2 mesh of the card against the plain
    sweeps."""
    from xinvert_tpu_torch.parallel import halo
    spec, S0, origin, owned, g, k = _block_case2d(case, dtype, cuda)
    shape = tuple(S0.shape[-2:])
    P = halo.padded_block(S0, origin, owned, g)
    bspec = halo.padded_block_spec(spec, origin, owned, g)
    aligned = origin[0] % 8 == 0 and origin[1] % 32 == 0
    fac = [float(torch.tensor(1.0 + 0.01 * i, dtype=dtype))
           for i in range(74)]
    for n in sorted({1, k}):
        for f, om in ((None, 1.3), (fac[:2 * n], 1.0)):
            b0, p0 = sor2d.BLOCK_LAUNCHES, sor2d.PLAIN_CALLS
            res = sor2d.sor2d_sweeps_block(bspec, P, om, n, origin, shape, g,
                                           with_norm=aligned, fac=f)
            assert (sor2d.BLOCK_LAUNCHES, sor2d.PLAIN_CALLS) == (b0 + 1, p0)
            ref = sor2d.sor2d_sweeps_block_reference(
                bspec, P, om, n, origin, shape, g, f, aligned)
            torch.cuda.synchronize()
            if aligned:
                assert _nan_equal(res[1], ref[1])
                res, ref = res[0], ref[0]
            assert _nan_equal(res, ref)
    mesh = _card_mesh(cuda, (2, 2), ("y", "x"))
    ex = halo.BlockExecutor(spec, S0, mesh, 1.0, checked=False)
    ex.sweeps(37, fac)
    assert _nan_equal(ex.gather().reshape(S0.shape),
                      sor2d.sor2d_sweeps_reference(spec, S0, 1.0, 37, fac))


def _block_case3d(case, dtype, device):
    if case == "omega_odd_origin":
        spec, S0 = _omega3d(dtype, device, shape=(7, 36, 24))
        return spec, S0, (9, 0), (9, 24), (8, 0), 4
    if case == "ocean_x_corners":
        spec, S0 = _ocean3d(dtype, device, shape=(6, 24, 64),
                            bcs=("fixed", "extend", "fixed"))
        return spec, S0, (8, 32), (16, 32), (9, 9), 4
    spec, S0 = _random3d(dtype, device, (9, 17, 40), 2,
                         ("fixed", "extend", "periodic"), seed=8)
    S0[..., 1:-1, 0, :] = float("nan")
    S0[..., 1:-1, -1, :] = float("nan")
    return spec, S0, (0, 0), (8, 40), (9, 0), 4


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", ["omega_odd_origin", "ocean_x_corners",
                                  "per_slice_nan"])
def test_block3d_kernel_bit_equal_to_plain(cuda, dtype, case):
    """sor3d_color_sweep_block's red launch (the extend folded in) and
    black launch (with the owned |S| partials) against the plain version,
    every cell of the padded buffer, through the block sweep kernel; then 37
    sweeps through the executor on a 2x2 mesh of the card against the
    plain sweeps."""
    from xinvert_tpu_torch.parallel import halo
    spec, S0, origin, owned, g, k = _block_case3d(case, dtype, cuda)
    shape = tuple(S0.shape[-2:])
    P = halo.padded_block(S0, origin, owned, g)
    bspec = halo.padded_block_spec(spec, origin, owned, g)
    rel = sor3d.relax_plane(bspec, 1.3)
    for color, ext, norm in ((0, True, False), (1, False, True)):
        ref = sor3d.sor3d_color_sweep_block_reference(
            bspec, P, rel, color, origin, shape, g, 1.07, ext, norm)
        b0 = sor3d.BLOCK_LAUNCHES
        res = sor3d.sor3d_color_sweep_block(bspec, P, rel, color, origin,
                                            shape, g, 1.07, ext, norm)
        assert sor3d.BLOCK_LAUNCHES == b0 + 1
        torch.cuda.synchronize()
        if norm:
            assert _nan_equal(res[1], ref[1])
            res = res[0]
        assert _nan_equal(res, ref[0] if norm else ref)
    fac = [float(torch.tensor(1.0 + 0.01 * i, dtype=dtype))
           for i in range(74)]
    mesh = _card_mesh(cuda, (2, 2), ("y", "x"))
    ex = halo.BlockExecutor(spec, S0, mesh, 1.0, checked=False)
    ex.sweeps(37, fac)
    assert _nan_equal(ex.gather().reshape(S0.shape),
                      sor3d.sor3d_sweeps_reference(spec, S0, 1.0, 37, fac))


def test_mesh_solve_on_the_card_equals_meshless(cuda):
    """solve_halo_window on a 2x2 mesh over the card: the meshless solve's
    iters and state, torch.equal, through sor2d_sweeps_block alone."""
    from xinvert_tpu_torch.parallel import solve_halo_window
    spec, _ = _poisson(torch.float32, cuda, batch=2, ny=96, nx=160,
                       bcs=("fixed", "periodic"))
    S0 = torch.zeros(spec.g.shape, dtype=torch.float32, device=cuda)
    ref = xt.solve(spec, S0, 1.8, tol=1e-4, max_iters=3000, check_every=32)
    t0, b0, p0 = _main_2d(), sor2d.BLOCK_LAUNCHES, sor2d.PLAIN_CALLS
    out = solve_halo_window(spec, S0, 1.8, 1e-4, 3000, check_every=32,
                            mesh=_card_mesh(cuda, (2, 2), ("y", "x")))
    assert _main_2d() == t0 and sor2d.PLAIN_CALLS == p0
    assert sor2d.BLOCK_LAUNCHES > b0
    assert torch.equal(out.iters, ref.iters) and int(ref.iters.max()) < 3000
    assert torch.equal(out.S, ref.S)
    assert torch.equal(out.rel_change, ref.rel_change)


def test_mesh_over_several_cards_equals_meshless(cuda):
    """A local mesh whose blocks sit on different cards (``make_grid_mesh()``
    with no world: the visible CUDA devices, up to 4): each block's launches
    go to its own card.  solve_halo_window (a batch of 2) gives the
    meshless solve's iters and field on cuda:0, torch.equal; under the
    residual rule, solve_halo_window3d and solve_refined give the same
    mesh's result with every block on cuda:0; the fixed 3-D count equals
    solve_fixed, in float and double; all through the block kernels
    alone.  scaling_bench's
    default devices are those cards.  Needs two or more GPUs."""
    from xinvert_tpu_torch import parallel as tpar
    from xinvert_tpu_torch.parallel.scaling import _omega_problem3
    n = min(torch.cuda.device_count(), 4)
    if n < 2:
        pytest.skip("needs two or more GPUs")
    mesh = tpar.make_grid_mesh(n)
    devs = {d.index for d in mesh.devices.reshape(-1)}
    assert devs == set(range(n))
    one = _card_mesh(cuda, tuple(mesh.shape.values()), mesh.axis_names)
    spec, _ = _poisson(torch.float32, cuda, batch=2, ny=96, nx=160,
                       bcs=("fixed", "periodic"))
    S0 = torch.zeros(spec.g.shape, dtype=torch.float32, device=cuda)
    ref = xt.solve(spec, S0, 1.8, tol=1e-4, max_iters=3000, check_every=32)
    t0, b0 = _main_2d(), sor2d.BLOCK_LAUNCHES
    out = tpar.solve_halo_window(spec, S0, 1.8, 1e-4, 3000, check_every=32,
                                 mesh=mesh)
    assert torch.equal(out.iters, ref.iters) and int(ref.iters.max()) < 3000
    assert torch.equal(out.S, ref.S) and out.S.device == cuda
    res = [tpar.solve_halo_window(spec, S0, 1.8, 1e-2, 3000, check_every=32,
                                  mesh=m, tol_type="residual")
           for m in (mesh, one)]
    assert torch.equal(res[0].iters, res[1].iters)
    assert int(res[0].iters.max()) < 3000
    assert torch.equal(res[0].S, res[1].S)
    assert _main_2d() == t0 and sor2d.BLOCK_LAUNCHES > b0
    spec3, S3 = _omega_problem3(12, 72, 96, torch.float32, cuda)
    b3 = sor3d.BLOCK_LAUNCHES
    r3 = [tpar.solve_halo_window3d(spec3, S3 + 1e-3, 1.2, 5e-3, 400,
                                   check_every=16, mesh=m)
          for m in (mesh, one)]
    assert torch.equal(r3[0].iters, r3[1].iters) and int(r3[0].iters) < 400
    assert torch.equal(r3[0].S, r3[1].S)
    f3 = tpar.solve_fixed_halo_window3d(spec3, S3 + 1e-3, 1.2, 40, mesh=mesh)
    assert _nan_equal(f3, xt.solve_fixed(spec3, S3 + 1e-3, 1.2, 40))
    # in double the block sweep takes more than 48 KB of shared memory,
    # which each card must allow
    spec6, S6 = _omega_problem3(12, 72, 96, torch.float64, cuda)
    f6 = tpar.solve_fixed_halo_window3d(spec6, S6 + 1e-3, 1.2, 40, mesh=mesh)
    assert _nan_equal(f6, xt.solve_fixed(spec6, S6 + 1e-3, 1.2, 40))
    assert sor3d.BLOCK_LAUNCHES > b3
    lat = np.linspace(-88.75, 88.75, 96)
    lon = np.linspace(0.0, 360.0 - 360.0 / 192, 192)
    grid = Grid.make(("lat", "lon"), (lat, lon), "lat-lon",
                     bcs=("extend", "periodic"))
    vor = (np.sin(3 * np.deg2rad(lon))[None, :]
           * np.cos(2 * np.deg2rad(lat))[:, None] * 1e-5)
    specr = problems.build_poisson(
        torch.as_tensor(vor, dtype=torch.float32, device=cuda),
        torch.ones((96, 192), dtype=torch.bool, device=cuda), grid,
        default_mParams)
    rr = [xt.solve_refined(specr, torch.zeros((96, 192), device=cuda),
                           omega=grid.omega_opt, tol=1e-9, max_rounds=5,
                           mesh=m) for m in (mesh, one)]
    assert rr[0].rounds == rr[1].rounds
    assert float(rr[0].rel_residual) == float(rr[1].rel_residual) <= 1e-9
    assert torch.equal(rr[0].S_hi, rr[1].S_hi)
    assert torch.equal(rr[0].S_lo, rr[1].S_lo)
    rows = tpar.scaling_bench([1, n], 128, 128, n_iters=8,
                              executor="halo_window_xy",
                              dtype=torch.float32)
    assert [r["devices"] for r in rows] == [1, n]
    assert not any(r["emulated"] for r in rows)
    assert all(np.isfinite(r["pts_per_s"]) for r in rows)


_DIST_WORKER = """
import dataclasses, sys, numpy as np, torch
torch.set_num_threads(1)
import torch.distributed as dist
from xinvert_tpu_torch import parallel as tpar
from xinvert_tpu_torch.parallel.scaling import (_omega_problem3,
                                                _poisson_problem)
rank, world, port, out = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                          sys.argv[4])
dev = torch.device("cuda", rank) if torch.cuda.is_available() \\
    else torch.device("cpu")
if dev.type == "cuda":
    torch.cuda.set_device(dev)
up = tpar.initialize_distributed("tcp://localhost:" + port, world, rank)
mesh = tpar.make_grid_mesh()
spec, S0, grid = _poisson_problem(192, 320, torch.float32, dev)
spec = dataclasses.replace(spec, bcs=("fixed", "periodic"))
r2 = tpar.solve_halo_window(spec, S0, grid.omega_opt, 1e-5, 2000,
                            check_every=32, mesh=mesh)
spec3, S3 = _omega_problem3(12, 72, 96, torch.float32, dev)
r3 = tpar.solve_halo_window3d(spec3, S3 + 1e-3, 1.2, 5e-3, 400,
                              check_every=16, mesh=mesh)
np.savez(out, up=up, mesh=str(dict(mesh.shape)), S2=r2.S.cpu().numpy(),
         it2=r2.iters.cpu().numpy(), rel2=r2.rel_change.cpu().numpy(),
         S3=r3.S.cpu().numpy(), it3=r3.iters.cpu().numpy())
dist.destroy_process_group()
"""


def run_distributed(world, tmp_path, timeout=240, worker=None):
    """``world`` processes of ``worker`` (default _DIST_WORKER; one a GPU
    with NCCL where the machine has CUDA, else gloo on the CPU); their
    saved results."""
    worker = worker or _DIST_WORKER
    import os
    import socket
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
    outs = [str(tmp_path / f"rank{r}.npz") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, "-c", worker, str(r),
                               str(world), str(port), outs[r]], env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT)
             for r in range(world)]
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    logs = [p.stdout.read().decode()[-3000:] for p in procs]
    assert all(p.returncode == 0 for p in procs), logs
    return [np.load(o) for o in outs]


def test_nccl_mesh_equals_the_local_mesh(cuda, tmp_path):
    """One process a GPU under NCCL (up to 4), a distributed mesh over
    their ranks: solve_halo_window (192x320 masked Poisson, fixed y) and
    solve_halo_window3d (12x72x96) give every rank the local mesh's field
    and iters on one card, torch.equal, both stopping by their rule before
    the cap.  Needs two or more GPUs (NCCL refuses two ranks on one card);
    the same workers run under gloo on the CPU (``run_distributed``)."""
    from xinvert_tpu_torch import parallel as tpar
    from xinvert_tpu_torch.parallel.scaling import (_omega_problem3,
                                                    _poisson_problem)
    from xinvert_tpu_torch.ops import _build
    world = min(torch.cuda.device_count(), 4)
    if world < 2:
        pytest.skip("needs two or more GPUs")
    _build.build_all()              # once, before the workers load it
    got = run_distributed(world, tmp_path)
    mesh = tpar.make_grid_mesh(devices=[cuda] * world)
    spec, S0, grid = _poisson_problem(192, 320, torch.float32, cuda)
    spec = dataclasses.replace(spec, bcs=("fixed", "periodic"))
    r2 = tpar.solve_halo_window(spec, S0, grid.omega_opt, 1e-5, 2000,
                                check_every=32, mesh=mesh)
    spec3, S3 = _omega_problem3(12, 72, 96, torch.float32, cuda)
    r3 = tpar.solve_halo_window3d(spec3, S3 + 1e-3, 1.2, 5e-3, 400,
                                  check_every=16, mesh=mesh)
    assert int(r2.iters) < 2000 and int(r3.iters) < 400
    for g in got:
        assert bool(g["up"]) and str(g["mesh"]) == str(dict(mesh.shape))
        assert np.array_equal(g["S2"], r2.S.cpu().numpy())
        assert np.array_equal(g["it2"], r2.iters.cpu().numpy())
        assert np.array_equal(g["rel2"], r2.rel_change.cpu().numpy())
        assert np.array_equal(g["S3"], r3.S.cpu().numpy())
        assert np.array_equal(g["it3"], r3.iters.cpu().numpy())


# ------------------------------------------ fault 8: batches over 65 535

def _batch_spec2d(dtype, device, B, per_slice, seed=21):
    """A random diagonally dominant 5-point (extend, periodic) spec on 8x8
    slices: planes the batch shares, or one a slice."""
    rng = np.random.default_rng(seed)
    shape = (B, 8, 8) if per_slice else (8, 8)
    active = np.zeros(shape, bool)
    active[..., 1:-1, :] = True
    active &= rng.random(shape) > 0.05
    w = rng.uniform(0.05, 0.25, (4,) + shape) * active
    w0 = np.where(active, -1.05 * w.sum(0), 0.0)
    relax = np.where(active, 1.0 / np.where(active, -w0, 1.0), 0.0)
    g = rng.normal(0, 1, (B, 8, 8)) * active
    spec = StencilSpec.from_arrays(w, w0, g, relax, active,
                                   ((1, 0), (-1, 0), (0, 1), (0, -1)),
                                   ("extend", "periodic"), False, False,
                                   device=device, dtype=dtype)
    S0 = torch.as_tensor(rng.normal(0, 1e-3, (B, 8, 8)), dtype=dtype,
                         device=device)
    return spec, S0


def _slice_spec(spec, b, nd):
    """Slice b of a batched spec, as a batch of one."""
    def cut(p, stacked=0):
        if p.dim() - stacked == nd:
            return p
        return p.narrow(stacked, b, 1).contiguous()
    return dataclasses.replace(spec, w=cut(spec.w, 1), w0=cut(spec.w0),
                               g=cut(spec.g), relax=cut(spec.relax),
                               active=cut(spec.active))


@pytest.mark.parametrize("per_slice", [False, True])
def test_batch_over_65535_slices_2d(cuda, per_slice):
    """Fault 8: 65 536 slices of 8x8 through solve_fixed (the tiled
    kernel), planes shared or one a slice: torch.equal to the plain sweeps,
    and each slice's |S| total equal to the same slice's in a batch of
    one."""
    B = 65536
    spec, S0 = _batch_spec2d(torch.float32, cuda, B, per_slice)
    t0 = _main_2d()
    out = xt.solve_fixed(spec, S0, 1.3, 9)
    assert _main_2d() > t0
    assert torch.equal(out, sor2d.sor2d_sweeps_reference(spec, S0, 1.3, 9))
    t0 = sor2d.TILED_LAUNCHES
    assert torch.equal(sor2d.sor2d_sweeps_tiled(spec, S0, 1.3, 9), out)
    assert sor2d.TILED_LAUNCHES > t0
    got, tot = sor2d.sor2d_sweeps(spec, S0, 1.3, 9, with_norm=True)
    assert torch.equal(got, out) and tot.shape == (B,)
    for b in (0, 1, 65534, 65535):
        one, t1 = sor2d.sor2d_sweeps(_slice_spec(spec, b, 2), S0[b:b + 1],
                                     1.3, 9, with_norm=True)
        assert torch.equal(one[0], out[b]) and torch.equal(t1[0], tot[b])


def test_batch_over_65535_slices_3d(cuda):
    """Fault 8 in 3-D: 65 536 slices of 4x8x8 through sor3d_color_sweep
    (the extend folded into the red launch) and sor3d_sweeps:
    torch.equal to the plain versions, each slice's |S| total equal to a
    batch of one's."""
    B = 65536
    spec, _ = _random3d(torch.float32, cuda, (4, 8, 8), 0,
                        ("fixed", "extend", "periodic"))
    rng = np.random.default_rng(5)
    S0 = torch.as_tensor(rng.normal(0, 1e-3, (B, 4, 8, 8)),
                         dtype=torch.float32, device=cuda)
    rel = sor3d.relax_plane(spec, 1.2)
    l0 = sor3d.LAUNCHES
    red = sor3d.sor3d_color_sweep(spec, S0, rel, 0, extend=True)
    assert sor3d.LAUNCHES == l0 + 1
    assert torch.equal(red, sor3d.sor3d_color_sweep_reference(
        spec, S0, rel, 0, extend=True))
    out, tot = sor3d.sor3d_sweeps(spec, S0, 1.2, 3, with_norm=True)
    assert torch.equal(out, sor3d.sor3d_sweeps_reference(spec, S0, 1.2, 3))
    for b in (0, 65535):
        one, t1 = sor3d.sor3d_sweeps(spec, S0[b:b + 1], 1.2, 3,
                                     with_norm=True)
        assert torch.equal(one[0], out[b]) and torch.equal(t1[0], tot[b])


# --------------------------------------------- the sharded multigrid

def _mg_pyramids(dtype, device):
    """A masked fixed/periodic 256x256 point pyramid (every level split on
    2x2), a 66x64 one whose third level goes whole, and a 3-D 6x64x64
    one; the 3-D one solved under the point smoother (B5s)."""
    from xinvert_tpu_torch import mg
    rng = np.random.default_rng(2)

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    def two(shape, bcs, **kw):
        A = t(np.abs(rng.normal(1, .05, shape)) + 1.0)
        C = t(np.abs(rng.normal(1, .05, shape)) + 1.0)
        Fdef = np.ones(shape, bool)
        Fdef[shape[0] // 3:shape[0] // 2, shape[1] // 4:shape[1] // 2] = False
        return mg.build_pyramid_standard2d(A, 0.0, C,
                                           t(rng.normal(0, 1, shape)), Fdef,
                                           (1.2e5, 1.0e5), bcs, **kw)
    sh3 = (6, 64, 64)
    p3 = mg.build_pyramid_standard3d(
        t(np.full(sh3, 1e-8)), t(np.abs(rng.normal(1, .05, sh3)) + 1.0),
        t(np.abs(rng.normal(1, .05, sh3)) + 1.0), t(rng.normal(0, 1, sh3)),
        np.ones(sh3, bool), (7e3, 1.2e5, 1.0e5),
        ("fixed", "fixed", "periodic"))
    return [("256", two((256, 256), ("fixed", "periodic")),
             dict(tol=1e-5, max_cycles=40, fmg=True)),
            ("66", two((66, 64), ("fixed", "fixed"), min_size=5),
             dict(tol=1e-5, max_cycles=40)),
            ("3d", p3, dict(tol=1e-5, max_cycles=40, smoother="point"))]


def test_solve_mg_sharded_on_the_card_equals_meshless(cuda):
    """solve_mg_sharded on a 2x2 mesh over the card, float32: the meshless
    solve_mg's cycles, residual and field, torch.equal; the split levels
    through the block kernels alone (B2s, or B5s for the 3-D point
    smoother), the whole ones through the whole-grid kernels."""
    from xinvert_tpu_torch import mg, parallel as tpar
    from xinvert_tpu_torch.parallel import pyramid
    mesh = _card_mesh(cuda, (2, 2), ("y", "x"))
    for name, pyr, kw in _mg_pyramids(torch.float32, cuda):
        Sm, km, resm, convm = mg.solve_mg(pyr, **kw)
        whole = any(p is None for p in pyramid.level_plan(pyr, mesh))
        c0 = (_main_2d(), sor2d.BLOCK_LAUNCHES, sor3d.LAUNCHES,
              sor3d.BLOCK_LAUNCHES, sor2d.PLAIN_CALLS)
        S, k, res, conv = tpar.solve_mg_sharded(pyr, mesh=mesh, **kw)
        c1 = (_main_2d(), sor2d.BLOCK_LAUNCHES, sor3d.LAUNCHES,
              sor3d.BLOCK_LAUNCHES, sor2d.PLAIN_CALLS)
        d = [b - a for a, b in zip(c0, c1)]
        assert (k, res, conv) == (km, resm, convm) and conv, name
        assert torch.equal(S, Sm), name
        assert d[4] == 0
        if name == "3d":
            assert d[3] > 0 and d[0] == d[1] == 0 and d[2] == 0
        else:
            assert d[1] > 0 and (d[0] > 0) == whole and d[2] == d[3] == 0


def test_solve_mg_sharded_rescue_on_the_card(cuda):
    """The Krylov stage on a 2x2 mesh over the card, float32, with the
    split V-cycle as its preconditioner: an advective general-2D pyramid
    whose plain V-cycles end far above the tolerance ('auto': B2s in the
    rescue, which brings the residual down without reaching it) and the 3-D
    point pyramid under 'bicgstab' (B5s): the meshless cycles, residual and
    field, torch.equal."""
    from xinvert_tpu_torch import mg, parallel as tpar
    mesh = _card_mesh(cuda, (2, 2), ("y", "x"))
    rng = np.random.default_rng(1)
    shape = (128, 192)

    def t(a):
        return torch.as_tensor(a, dtype=torch.float32, device=cuda)
    adv = mg.build_pyramid_general2d(
        t(np.ones(shape)), 0.0, t(np.ones(shape)), 0.0, 3.0, -0.01,
        t(rng.normal(0, 1, shape)), np.ones(shape, bool), (1.0, 1.0),
        ("fixed", "periodic"), min_size=8)
    p3 = _mg_pyramids(torch.float32, cuda)[2][1]
    for name, pyr, kw in (
            ("advective", adv, dict(tol=1e-5, max_cycles=10,
                                    accel="auto")),
            ("3d", p3, dict(tol=1e-5, max_cycles=8, smoother="point",
                            accel="bicgstab"))):
        c0 = (sor2d.BLOCK_LAUNCHES, sor3d.BLOCK_LAUNCHES)
        S, k, res, conv = tpar.solve_mg_sharded(pyr, mesh=mesh, **kw)
        d = [sor2d.BLOCK_LAUNCHES - c0[0], sor3d.BLOCK_LAUNCHES - c0[1]]
        Sm, km, resm, convm = mg.solve_mg(pyr, **kw)
        assert (k, res, conv) == (km, resm, convm), name
        assert torch.equal(S, Sm), name
        assert k > kw["max_cycles"] if name == "advective" else k >= 2
        assert d[name == "3d"] > 0 and d[name != "3d"] == 0, name


def test_solve_mg_sharded_over_several_cards(cuda):
    """A local mesh with a block on each card (up to 4) and its twin with
    every block on cuda:0: solve_mg_sharded gives the meshless cycles and
    field, torch.equal, on cuda:0.  Needs two or more GPUs."""
    from xinvert_tpu_torch import mg, parallel as tpar
    n = min(torch.cuda.device_count(), 4)
    if n < 2:
        pytest.skip("needs two or more GPUs")
    mesh = tpar.make_grid_mesh(n)
    one = _card_mesh(cuda, tuple(mesh.shape.values()), mesh.axis_names)
    for name, pyr, kw in _mg_pyramids(torch.float32, cuda):
        Sm, km, _, _ = mg.solve_mg(pyr, **kw)
        for m in (mesh, one):
            S, k, _, conv = tpar.solve_mg_sharded(pyr, mesh=m, **kw)
            assert k == km and conv and S.device == cuda, name
            assert torch.equal(S, Sm), name


_DIST_MG_WORKER = """
import sys, numpy as np, torch
torch.set_num_threads(1)
import torch.distributed as dist
from xinvert_tpu_torch import mg, parallel as tpar
rank, world, port, out = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                          sys.argv[4])
dev = torch.device("cuda", rank) if torch.cuda.is_available() \\
    else torch.device("cpu")
if dev.type == "cuda":
    torch.cuda.set_device(dev)
up = tpar.initialize_distributed("tcp://localhost:" + port, world, rank)
rng = np.random.default_rng(2)
t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)
A = t(np.abs(rng.normal(1, .05, (256, 256))) + 1.0)
C = t(np.abs(rng.normal(1, .05, (256, 256))) + 1.0)
F = t(rng.normal(0, 1, (256, 256)))
Fdef = np.ones((256, 256), bool)
Fdef[85:128, 64:128] = False
pyr = mg.build_pyramid_standard2d(A, 0.0, C, F, Fdef, (1.2e5, 1.0e5),
                                  ("fixed", "periodic"))
S, k, res, conv = tpar.solve_mg_sharded(pyr, mesh=tpar.make_grid_mesh(),
                                        tol=1e-5, max_cycles=40, fmg=True)
np.savez(out, up=up, S=S.cpu().numpy(), k=k, res=res)
dist.destroy_process_group()
"""


def test_nccl_solve_mg_sharded_equals_meshless(cuda, tmp_path):
    """One process a GPU under NCCL (up to 4), a distributed mesh over
    their ranks: solve_mg_sharded (a masked 256x256 point pyramid, full
    multigrid) gives every rank the meshless solve's field, cycles and
    residual on one card, torch.equal.  Needs two or more GPUs."""
    from xinvert_tpu_torch import mg
    from xinvert_tpu_torch.ops import _build
    world = min(torch.cuda.device_count(), 4)
    if world < 2:
        pytest.skip("needs two or more GPUs")
    _build.build_all()
    got = run_distributed(world, tmp_path, worker=_DIST_MG_WORKER)
    rng = np.random.default_rng(2)

    def t(a):
        return torch.as_tensor(a, dtype=torch.float32, device=cuda)
    A = t(np.abs(rng.normal(1, .05, (256, 256))) + 1.0)
    C = t(np.abs(rng.normal(1, .05, (256, 256))) + 1.0)
    F = t(rng.normal(0, 1, (256, 256)))
    Fdef = np.ones((256, 256), bool)
    Fdef[85:128, 64:128] = False
    pyr = mg.build_pyramid_standard2d(A, 0.0, C, F, Fdef, (1.2e5, 1.0e5),
                                      ("fixed", "periodic"))
    S, k, res, conv = mg.solve_mg(pyr, tol=1e-5, max_cycles=40, fmg=True)
    assert conv
    for g in got:
        assert bool(g["up"]) and int(g["k"]) == k
        assert float(g["res"]) == res
        assert np.array_equal(g["S"], S.cpu().numpy())


@pytest.mark.parametrize("kind", ["poisson", "omega"])
def test_copies_and_syncs_counted_on_the_card(cuda, kind):
    """A traced float32 call on the card: the copy counters grow by the
    forcing up and the solution down, a plane each a field (the mask and
    the zero first guess are made on the card); one ``copy.*`` span a
    copy; no numpy pass over the batch (``api.HOST_PASSES``); the
    ``engine.sync`` spans equal the growth of ``solver.HOST_SYNCS``, one
    more than the ``engine.window`` spans."""
    from xinvert_tpu_torch import solver, telemetry
    from xinvert_tpu_torch.models import api
    batch = 3
    if kind == "poisson":
        core = (73, 144)
        lat = np.linspace(-90.0, 90.0, 73)
        lon = np.arange(144) * 2.5
        v = (np.cos(np.deg2rad(lat))[:, None] ** 2
             * np.sin(2 * np.deg2rad(lon))[None, :])[None] \
            * np.arange(1.0, batch + 1)[:, None, None] * 1e-5
        v[:, 20:30, 40:60] = np.nan
        dims, coords = ["lat", "lon"], {"lat": lat, "lon": lon}
        iP = {"BCs": ["extend", "periodic"], "undef": np.nan}
        entry, mP = xt.invert_Poisson, None
    else:
        core = (9, 24, 48)
        lev = np.linspace(100000.0, 10000.0, 9)
        lat = np.linspace(-86.25, 86.25, 24)
        lon = np.arange(48) * 7.5
        v = (np.sin(np.pi * (1e5 - lev) / 9e4)[:, None, None]
             * np.cos(np.deg2rad(lat))[None, :, None]
             * np.sin(4 * np.deg2rad(lon))[None, None, :])[None] \
            * np.arange(1.0, batch + 1)[:, None, None, None] * 1e-15
        dims = ["LEV", "lat", "lon"]
        coords = {"LEV": lev, "lat": lat, "lon": lon}
        iP = {"BCs": ["fixed", "fixed", "periodic"]}
        entry = xt.invert_omega
        mP = {"N2": xt.Field(np.full(9, 2e-5), ("LEV",), {"LEV": lev})}
    F = xt.Field(v.astype(np.float32), ["time"] + dims,
                 dict(coords, time=np.arange(batch)))
    iP.update(mxLoop=5000, tolerance=1e-6, printInfo=False)
    entry(F, dims=dims, iParams=iP, mParams=mP)          # warm
    h2d, d2h = telemetry.H2D_BYTES, telemetry.D2H_BYTES
    syncs, passes = solver.HOST_SYNCS, api.HOST_PASSES
    telemetry.drain()
    telemetry.enable()
    try:
        entry(F, dims=dims, iParams=iP, mParams=mP)
    finally:
        telemetry.disable()
    spans = telemetry.drain()
    names = [s[0] for s in spans]
    plane = batch * int(np.prod(core)) * 4
    assert telemetry.H2D_BYTES - h2d == plane
    assert telemetry.D2H_BYTES - d2h == plane
    assert (names.count("copy.h2d"), names.count("copy.d2h")) == (1, 1)
    assert api.HOST_PASSES == passes
    assert names.count("engine.sync") == solver.HOST_SYNCS - syncs \
        == names.count("engine.window") + 1
    assert int(api.LAST_SOLVE.iters.max()) < 5000


@pytest.mark.parametrize("kind", ["year", "omega", "direct_stream"])
def test_api_device_steps_equal_the_numpy_steps(cuda, kind):
    """On the year cell's shape (1460 x 73 x 144, its land block NaN), on
    a small omega batch with a NaN block, and on a streamed batch that
    ``scheme='direct'`` solves on the card by the capacitance route (the
    mask made on the host, the solution on the card), the fields of
    ``invert_*`` are bit for bit those of the same call through the numpy
    steps that the mask, the first guess and the fill ran as before they
    moved to the card (tests/api_numpy_steps.py)."""
    from api_numpy_steps import direct, numpy_steps, same_field, sor
    rng = np.random.default_rng(7)
    run = None
    if kind == "direct_stream":
        lat, lon = np.linspace(-80.0, 80.0, 65), np.arange(128) * 2.8125
        v = (np.sin(3 * np.deg2rad(lon))[None, :]
             * np.cos(2 * np.deg2rad(lat))[:, None])[None] \
            * rng.uniform(0.5, 1.5, (6, 1, 1)) * 1e-5
        v[:, 30:36, 50:70] = np.nan
        dims, coords = ["lat", "lon"], {"lat": lat, "lon": lon}
        iP = {"BCs": ["fixed", "periodic"], "scheme": "direct",
              "streamChunk": 4}
        entry, run, mP = xt.invert_Poisson, direct("poisson"), None
    elif kind == "year":
        lat, lon = np.linspace(-90.0, 90.0, 73), np.linspace(0.0, 357.5, 144)
        v = (np.sin(3 * np.deg2rad(lon))[None, :]
             * np.cos(2 * np.deg2rad(lat))[:, None])[None] \
            + 0.1 * rng.standard_normal((1460, 73, 144))
        v[:, 24:36, 36:72] = np.nan
        dims, coords = ["lat", "lon"], {"lat": lat, "lon": lon}
        iP = {"BCs": ["extend", "periodic"], "undef": np.nan}
        entry, key, mP = xt.invert_Poisson, "poisson", None
    else:
        lev = np.linspace(100000.0, 10000.0, 37)
        lat, lon = np.linspace(-87.5, 87.5, 72), np.arange(288) * 1.25
        v = (np.sin(np.pi * (1e5 - lev) / 9e4)[:, None, None]
             * np.cos(np.deg2rad(lat))[None, :, None]
             * np.sin(3 * np.deg2rad(lon))[None, None, :])[None] \
            * rng.uniform(0.5, 1.5, (4, 1, 1, 1)) * 1e-15
        v[:, 10:20, 30:40, 100:160] = np.nan
        dims = ["LEV", "lat", "lon"]
        coords = {"LEV": lev, "lat": lat, "lon": lon}
        iP = {"BCs": ["fixed", "fixed", "periodic"]}
        entry, key = xt.invert_omega, "omega"
        mP = {"N2": xt.Field(np.where(lev > 25000.0, 1.5e-5, 6e-5),
                             ("LEV",), {"LEV": lev})}
    F = xt.Field(v.astype(np.float32), ["time"] + dims,
                 dict(coords, time=np.arange(v.shape[0])))
    iP.update(mxLoop=5000 if kind == "year" else 500, tolerance=1e-6,
              printInfo=False)
    got = entry(F, dims=dims, iParams=iP, mParams=mP)
    want = numpy_steps(run or sor(key), F, dims, len(dims), mParams=mP,
                       iParams=iP, device=cuda)
    assert same_field(got, want)
    assert torch.equal(torch.from_numpy(got.values).view(torch.int32),
                       torch.from_numpy(want.values).view(torch.int32))


def _bits(t):
    """The bytes of tensor ``t``, for bit-for-bit comparison."""
    return t.contiguous().reshape(-1).view(torch.uint8)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.int64, torch.bool])
@pytest.mark.parametrize("size", ["chunk_less_one", "chunk", "chunk_plus_one",
                                  "two_and_a_half"])
def test_staged_copies_equal_the_plain_copies(cuda, dtype, size):
    """``to_device`` and ``to_host`` of a C-contiguous array one element
    under a chunk (plain), one chunk, one element over and 2.5 chunks
    (staged, tail included) give the plain copies' bytes; STAGED_BYTES
    grows by the array's bytes each way where it is staged."""
    from xinvert_tpu_torch import _staging, telemetry
    item = torch.empty(0, dtype=dtype).element_size()
    step = _staging.CHUNK // item
    n = {"chunk_less_one": step - 1, "chunk": step, "chunk_plus_one": step + 1,
         "two_and_a_half": 5 * step // 2}[size]
    a = torch.from_numpy(np.random.default_rng(n).standard_normal(n)
                         * 1e3).to(dtype).numpy()
    a = a.reshape(5, -1) if n % 5 == 0 else a
    staged = telemetry.STAGED_BYTES
    up = telemetry.to_device(a, cuda)
    want = torch.as_tensor(a, device=cuda)
    assert up.shape == want.shape and up.dtype == want.dtype
    assert torch.equal(_bits(up), _bits(want))
    down = telemetry.to_host(want)
    assert down.shape == want.shape and down.dtype == want.dtype
    assert torch.equal(_bits(down), _bits(want.cpu()))
    grew = telemetry.STAGED_BYTES - staged
    assert grew == (0 if size == "chunk_less_one" else 2 * a.nbytes)


def test_staged_downloads_are_arrays_of_their_own(cuda):
    """Two staged downloads in a row: the first is unchanged by the
    second, writeable, and aliases no staging buffer nor the card."""
    from xinvert_tpu_torch import _staging, telemetry
    n = 3 * _staging.CHUNK // 4 + 7
    x = torch.arange(n, dtype=torch.float32, device=cuda)
    first = telemetry.to_host(x).numpy()
    keep = first.copy()
    telemetry.to_host(-x).numpy()
    assert np.array_equal(first, keep)
    assert first.flags.writeable
    first[:] = 0
    assert np.array_equal(x.cpu().numpy(), keep)
    for bufs in _staging._BUFFERS.values():
        for b in bufs:
            assert not np.shares_memory(first, b.mem.numpy())


def test_staged_upload_reads_its_source_before_it_returns(cuda):
    """A source changed as soon as ``to_device`` returns, and a second
    upload through the same buffers, leave the first tensor as it was."""
    from xinvert_tpu_torch import _staging, telemetry
    n = 5 * _staging.CHUNK // 8 + 3
    a = np.arange(n, dtype=np.float64)
    want = a.copy()
    t = telemetry.to_device(a, cuda)
    a[:] = -1.0
    u = telemetry.to_device(a, cuda)
    torch.cuda.synchronize()
    assert np.array_equal(t.cpu().numpy(), want)
    assert bool(torch.all(u == -1.0))


@pytest.mark.parametrize("kind", ["poisson", "omega"])
def test_staged_entry_points_equal_the_plain_copies(cuda, monkeypatch, kind):
    """``invert_Poisson`` and ``invert_omega`` on a batch above one chunk
    (its NaN block filled with undef) return the same bits as with the
    staging threshold out of reach, and stage the forcing up and the
    answer down."""
    from xinvert_tpu_torch import _staging, telemetry
    rng = np.random.default_rng(11)
    if kind == "poisson":
        lat, lon = np.linspace(-90.0, 90.0, 73), np.arange(144) * 2.5
        v = (np.sin(3 * np.deg2rad(lon))[None, :]
             * np.cos(2 * np.deg2rad(lat))[:, None])[None] \
            * rng.uniform(0.5, 1.5, (420, 1, 1)) * 1e-5
        v[:, 24:36, 36:72] = np.nan
        dims, coords = ["lat", "lon"], {"lat": lat, "lon": lon}
        iP = {"BCs": ["extend", "periodic"], "undef": np.nan, "mxLoop": 300}
        entry, mP = xt.invert_Poisson, None
    else:
        lev = np.linspace(100000.0, 10000.0, 37)
        lat, lon = np.linspace(-87.5, 87.5, 72), np.arange(288) * 1.25
        v = (np.sin(np.pi * (1e5 - lev) / 9e4)[:, None, None]
             * np.cos(np.deg2rad(lat))[None, :, None]
             * np.sin(3 * np.deg2rad(lon))[None, None, :])[None] \
            * rng.uniform(0.5, 1.5, (7, 1, 1, 1)) * 1e-15
        v[:, 10:20, 30:40, 100:160] = np.nan
        dims = ["LEV", "lat", "lon"]
        coords = {"LEV": lev, "lat": lat, "lon": lon}
        iP = {"BCs": ["fixed", "fixed", "periodic"], "mxLoop": 100}
        entry = xt.invert_omega
        mP = {"N2": xt.Field(np.where(lev > 25000.0, 1.5e-5, 6e-5),
                             ("LEV",), {"LEV": lev})}
    F = xt.Field(v.astype(np.float32), ["time"] + dims,
                 dict(coords, time=np.arange(v.shape[0])))
    iP.update(tolerance=1e-6, printInfo=False)
    plane = v.size * 4
    assert plane > _staging.CHUNK
    staged = telemetry.STAGED_BYTES
    got = entry(F, dims=dims, iParams=iP, mParams=mP).values
    assert telemetry.STAGED_BYTES - staged == 2 * plane
    monkeypatch.setattr(_staging, "CHUNK", 1 << 62)
    want = entry(F, dims=dims, iParams=iP, mParams=mP).values
    assert telemetry.STAGED_BYTES - staged == 2 * plane
    assert got.dtype == want.dtype == np.float32
    assert np.isnan(got).any()
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
