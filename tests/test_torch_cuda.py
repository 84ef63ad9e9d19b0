# -*- coding: utf-8 -*-
"""The CUDA kernels of the PyTorch port (xinvert_tpu_torch/csrc/sor2d.cu and
csrc/sor3d.cu) on the card: bit-equal to their plain PyTorch versions (the
2-D tiled kernels, the first version's pair and in-place kernel, the 3-D
pair with the extend pre-pass folded in and its first version, and the
Chebyshev factor argument included), counted, and refusing what they do not
take; the direct engine on the card against the CPU; solution trajectories
through the kernels frame by frame against the plain version; the
lexicographic executor and the 1-D entry points on the card against the
CPU; the error-free transformations exact on the card, refinement through
the kernels, streamed solves bit-equal to the resident solve, implicit
gradients through the kernels equal to the plain version's; the block
kernels (sor2d_sweeps_block, sor3d_color_sweep_block) bit-equal to their
plain versions and, on local meshes that repeat the card, to the meshless
sweeps and solves.  Every test here needs an NVIDIA GPU (marker
``cuda``) and skips elsewhere.  This file imports no JAX, so it runs on a
machine without it:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import xinvert_tpu_torch as xt  # noqa: E402
from xinvert_tpu_torch.grid import Grid  # noqa: E402
from xinvert_tpu_torch.models import problems  # noqa: E402
from xinvert_tpu_torch.models.params import default_mParams  # noqa: E402
from xinvert_tpu_torch.ops import sor2d, sor3d  # noqa: E402
from xinvert_tpu_torch.stencil import StencilSpec  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda", 0)


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
    if case == "poisson":
        spec, S0 = _poisson(dtype, cuda)
    elif case == "poisson_batch":
        spec, S0 = _poisson(dtype, cuda, batch=3)
    elif case == "fixed":
        spec, S0 = _poisson(dtype, cuda, bcs=("fixed", "fixed"))
    else:
        spec, S0 = _bih(dtype, cuda, ("extend", case[4:]))
    before = S0.clone()
    l0 = sor2d.LAUNCHES
    out_k, sumabs = sor2d.sor2d_sweeps_pair(spec, S0, 1.3, 15,
                                            with_norm=True)
    out_p = sor2d.sor2d_sweeps_reference(spec, S0, 1.3, 15)
    torch.cuda.synchronize()
    assert sor2d.LAUNCHES == l0 + 30
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
            c0, l0 = getattr(sor2d, counter), sor2d.LAUNCHES
            out_k, sumabs = fn(spec, S0, omega, n, with_norm=True, fac=f)
            out_p = sor2d.sor2d_sweeps_reference(spec, S0, omega, n, f)
            torch.cuda.synchronize()
            assert getattr(sor2d, counter) == c0 + 3
            assert sor2d.LAUNCHES == l0
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
    monkeypatch.setattr(sor2d, "_FAMILY", sor2d._FAMILY._replace(
        tile_plan=lambda *a: plan))
    for n in (1, 5):
        out = sor2d.sor2d_sweeps_tiled(spec, S0, 1.3, n)
        assert torch.equal(out, sor2d.sor2d_sweeps_reference(spec, S0, 1.3,
                                                             n))
    with pytest.raises(RuntimeError, match="CUDA error"):
        sor2d.sor2d_sweeps_tiled(spec, S0, 1.3, 2, with_norm=True)


@pytest.mark.parametrize("switch", [False, True])
def test_2d_solve_launches_only_the_tiled_kernels(cuda, monkeypatch,
                                                  switch):
    monkeypatch.setattr(sor2d, "INPLACE_KERNEL", switch)
    spec, _ = _stommel(torch.float32, cuda)
    S0 = torch.zeros(spec.g.shape, dtype=torch.float32, device=cuda)
    names = ("TILED_LAUNCHES", "TILED_INPLACE_LAUNCHES", "LAUNCHES",
             "INPLACE_LAUNCHES", "EXTEND_LAUNCHES", "PLAIN_CALLS")
    before = {n: getattr(sor2d, n) for n in names}
    xt.solve(spec, S0, omega=1.5, tol=1e-9, max_iters=200, check_every=8)
    ran = {n for n in names if getattr(sor2d, n) != before[n]}
    assert ran == {"TILED_INPLACE_LAUNCHES" if switch else "TILED_LAUNCHES"}


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
    """The folded sweeps (two launches a sweep, no extend launch) and the
    first version's (sor3d_sweeps_pair: the extend launch too) bit-equal
    to the plain version; each kernel alone, the red color sweep with the
    extend flag too."""
    spec, S0 = _case3d(case, dtype, cuda)
    before = S0.clone()
    extend = spec.bcs[-2] == "extend"
    l0, e0 = sor3d.LAUNCHES, sor3d.EXTEND_LAUNCHES
    out_k, sumabs = sor3d.sor3d_sweeps(spec, S0, 1.3, 15, with_norm=True)
    out_p = sor3d.sor3d_sweeps_reference(spec, S0, 1.3, 15)
    torch.cuda.synchronize()
    assert sor3d.LAUNCHES == l0 + 30
    assert sor3d.EXTEND_LAUNCHES == e0
    assert torch.equal(out_k, out_p)
    assert torch.equal(S0, before)
    ref = out_p.double().abs().sum(dim=(-3, -2, -1))
    rtol = 1e-5 if dtype == torch.float32 else 1e-12
    torch.testing.assert_close(sumabs.double(), ref, rtol=rtol, atol=0)
    out_y = sor3d.sor3d_sweeps_pair(spec, S0, 1.3, 15)
    torch.cuda.synchronize()
    assert sor3d.LAUNCHES == l0 + 60
    assert sor3d.EXTEND_LAUNCHES == e0 + (15 if extend else 0)
    assert torch.equal(out_y, out_p)
    # each kernel alone
    ext_k = sor3d.sor3d_extend(spec, S0)
    assert torch.equal(ext_k, sor3d.sor3d_extend_reference(spec, S0))
    rel = sor3d.relax_plane(spec, 1.3)
    for color in (0, 1):
        assert torch.equal(
            sor3d.sor3d_color_sweep(spec, ext_k, rel, color),
            sor3d.sor3d_color_sweep_reference(spec, ext_k, rel, color))
        assert torch.equal(
            sor3d.sor3d_color_sweep(spec, S0, rel, color, extend=True),
            sor3d.sor3d_color_sweep_reference(spec, S0, rel, color,
                                              extend=True))


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
    version, with no extend launch."""
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
            e0 = sor3d.EXTEND_LAUNCHES
            out, sumabs = sor3d.sor3d_sweeps(spec, S0, om, n, with_norm=True,
                                             fac=fac)
            ref = sor3d.sor3d_sweeps_reference(spec, S0, om, n, fac)
            torch.cuda.synchronize()
            assert sor3d.EXTEND_LAUNCHES == e0
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
def test_folded_pair_on_the_entry_point(cuda, dtype):
    """invert_3DOcean on the card sweeps through the folded pair alone (two
    launches a sweep, no extend launch) and gives the iters and the state
    of the first version's three launches a sweep."""
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
    folded = sor3d.sor3d_sweeps
    try:
        l0, e0 = sor3d.LAUNCHES, sor3d.EXTEND_LAUNCHES
        xt.invert_3DOcean(f, **kw)
        r_f = api.LAST_SOLVE
        assert sor3d.EXTEND_LAUNCHES == e0
        assert sor3d.LAUNCHES - l0 == 2 * int(r_f.iters)
        sor3d.sor3d_sweeps = sor3d.sor3d_sweeps_pair
        xt.invert_3DOcean(f, **kw)
        r_y = api.LAST_SOLVE
        assert sor3d.EXTEND_LAUNCHES - e0 == int(r_y.iters)
    finally:
        sor3d.sor3d_sweeps = folded
        torch.set_default_dtype(default)
    assert torch.equal(r_f.iters, r_y.iters)
    assert torch.equal(r_f.S, r_y.S)


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
def test_inplace_kernel_bit_equal_to_plain(cuda, monkeypatch, dtype, case):
    spec, S0 = _inplace_case(case, dtype, cuda)
    assert sor2d.inplace_eligible(spec, tuple(S0.shape[-2:]))
    before = S0.clone()
    # each half-sweep alone, with and without a factor
    for fac in (1.0, 1.37):
        rel = sor2d.relax_plane(spec, 1.3)
        for color in (0, 1):
            assert torch.equal(
                sor2d.sor2d_color_sweep_inplace(spec, S0, rel, color, fac),
                sor2d.sor2d_color_sweep_inplace_reference(spec, S0, rel,
                                                          color, fac))
    # 20 sweeps through the switch, with and without partials and factors
    # (the first version's loop: three launches a sweep)
    monkeypatch.setattr(sor2d, "INPLACE_KERNEL", True)
    rng = np.random.default_rng(9)
    outs = []
    for fac in (None, list(1.0 + rng.random(40))):
        fac = None if fac is None else [float(torch.tensor(f, dtype=dtype))
                                        for f in fac]
        l0, i0 = sor2d.LAUNCHES, sor2d.INPLACE_LAUNCHES
        out_k = sor2d.sor2d_sweeps_pair(spec, S0, 1.3, 20, fac=fac)
        out_n, sumabs = sor2d.sor2d_sweeps_pair(spec, S0, 1.3, 20,
                                                with_norm=True, fac=fac)
        out_p = sor2d.sor2d_sweeps_reference(spec, S0, 1.3, 20, fac)
        torch.cuda.synchronize()
        assert (sor2d.LAUNCHES, sor2d.INPLACE_LAUNCHES) == (l0, i0 + 80)
        assert torch.equal(out_k, out_p) and torch.equal(out_n, out_p)
        ref = out_p.double().abs().sum(dim=(-2, -1))
        rtol = 1e-5 if dtype == torch.float32 else 1e-12
        torch.testing.assert_close(sumabs.double(), ref, rtol=rtol, atol=0)
        outs.append((fac, out_k))
    # the pair gives the same answers
    monkeypatch.setattr(sor2d, "INPLACE_KERNEL", False)
    for fac, out_k in outs:
        assert torch.equal(sor2d.sor2d_sweeps_pair(spec, S0, 1.3, 20,
                                                   fac=fac), out_k)
    assert torch.equal(S0, before)


def test_inplace_race_gate(cuda, monkeypatch):
    """An odd nx with periodic x joins two cells of one color across the
    wrap: the in-place wrappers refuse it, and the switched-on sweeps run
    the ping-pong kernels instead (counted)."""
    spec, S0 = _poisson(torch.float64, cuda, nx=71)
    rel = sor2d.relax_plane(spec, 1.3)
    assert not sor2d.inplace_eligible(spec, tuple(S0.shape))
    with pytest.raises(ValueError, match="even"):
        sor2d.sor2d_color_sweep_inplace(spec, S0, rel, 0)
    with pytest.raises(ValueError, match="even"):
        sor2d.sor2d_sweeps_tiled_inplace(spec, S0, 1.3, 2)
    monkeypatch.setattr(sor2d, "INPLACE_KERNEL", True)
    l0, i0 = sor2d.LAUNCHES, sor2d.INPLACE_LAUNCHES
    out = sor2d.sor2d_sweeps_pair(spec, S0, 1.3, 4)
    assert (sor2d.LAUNCHES, sor2d.INPLACE_LAUNCHES) == (l0 + 8, i0)
    assert torch.equal(out, sor2d.sor2d_sweeps_reference(spec, S0, 1.3, 4))
    t0, ti0 = sor2d.TILED_LAUNCHES, sor2d.TILED_INPLACE_LAUNCHES
    out = sor2d.sor2d_sweeps(spec, S0, 1.3, 4)
    assert sor2d.TILED_LAUNCHES > t0 and sor2d.TILED_INPLACE_LAUNCHES == ti0
    assert torch.equal(out, sor2d.sor2d_sweeps_reference(spec, S0, 1.3, 4))
    cross, S1 = _poisson(torch.float64, cuda)
    cross = dataclasses.replace(cross, w=torch.cat([cross.w, cross.w[:1]]),
                                offsets=cross.offsets + ((1, 1),))
    with pytest.raises(ValueError, match="cross"):
        sor2d.sor2d_color_sweep_inplace(cross, S1,
                                        sor2d.relax_plane(cross, 1.3), 0)


@pytest.mark.parametrize("dtype,check_every", [(torch.float32, 1),
                                               (torch.float32, 32),
                                               (torch.float64, 1)])
@pytest.mark.parametrize("case", ["diverging", "nan_seed"])
def test_inplace_stops_like_the_pair(cuda, monkeypatch, dtype, check_every,
                                     case):
    """A diverging solve (omega 2.5) and a NaN seeded in the interior of
    the state: the in-place kernel and the pair (the first version's loop,
    which the solve runs with ``sor2d_sweeps`` set to it) stop at the same
    check with the same overflow flag."""
    spec, _ = _poisson(dtype, cuda, batch=2, nx=72)
    S0 = torch.zeros(spec.g.shape, dtype=dtype, device=cuda)
    omega = 2.5 if case == "diverging" else 1.5
    if case == "nan_seed":
        S0[1, 20, 40] = float("nan")
    res = {}
    monkeypatch.setattr(sor2d, "sor2d_sweeps", sor2d.sor2d_sweeps_pair)
    for switch in (False, True):
        monkeypatch.setattr(sor2d, "INPLACE_KERNEL", switch)
        i0 = sor2d.INPLACE_LAUNCHES
        res[switch] = xt.solve(spec, S0, omega=omega, tol=1e-12,
                               max_iters=3000, check_every=check_every)
        assert (sor2d.INPLACE_LAUNCHES > i0) == switch
    for field in ("iters", "overflow"):
        assert torch.equal(getattr(res[True], field),
                           getattr(res[False], field)), field
    assert bool(res[True].overflow.any())


def test_pair_kernels_take_a_factor(cuda):
    """The fac argument of sor2d_color_sweep and sor3d_color_sweep, alone
    and through 20 sweeps with factors, bit-equal to the plain versions."""
    for mod, (spec, S0), p in (
            (sor2d, _bih(torch.float32, cuda, ("extend", "periodic")),
             "sor2d"),
            (sor2d, _poisson(torch.float64, cuda, batch=2), "sor2d"),
            (sor3d, _ocean3d(torch.float32, cuda), "sor3d"),
            (sor3d, _omega3d(torch.float64, cuda), "sor3d")):
        rel = mod.relax_plane(spec, 1.0)
        for color in (0, 1):
            assert torch.equal(
                getattr(mod, f"{p}_color_sweep")(spec, S0, rel, color, 1.43),
                getattr(mod, f"{p}_color_sweep_reference")(spec, S0, rel,
                                                           color, 1.43))
        fac = [float(torch.tensor(1.0 + 0.02 * k, dtype=S0.dtype))
               for k in range(40)]
        loop = "sweeps_pair" if p == "sor2d" else "sweeps"
        out_k = getattr(mod, f"{p}_{loop}")(spec, S0, 1.0, 20, fac=fac)
        out_p = getattr(mod, f"{p}_sweeps_reference")(spec, S0, 1.0, 20, fac)
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
    i0 = sor2d.TILED_INPLACE_LAUNCHES
    r_k = xt.solve(spec, S0, **kw)
    assert (sor2d.TILED_INPLACE_LAUNCHES > i0) == switch
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
                t0 = sor2d.TILED_LAUNCHES + sor2d.TILED_INPLACE_LAUNCHES
                p0 = sor2d.PLAIN_CALLS
                out = mg._smooth(level, S, n)
                ref = sor2d.sor2d_sweeps_reference(level.spec, S,
                                                   level.omega, n)
                assert (sor2d.TILED_LAUNCHES + sor2d.TILED_INPLACE_LAUNCHES
                        > t0)
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
    t0, p0 = sor2d.TILED_LAUNCHES, sor2d.PLAIN_CALLS
    out = xt.invert_Poisson_mg(F, ["lat", "lon"], iParams=iP, tol=1e-6)
    assert sor2d.TILED_LAUNCHES > t0 and sor2d.PLAIN_CALLS == p0
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
    t0, p0 = sor2d.TILED_LAUNCHES, sor2d.PLAIN_CALLS
    frames = solver.solve_trajectory(spec, S0, omega, loop_per_frame=5,
                                     max_frames=6, scheme=scheme)
    assert sor2d.TILED_LAUNCHES - t0 >= 6 and sor2d.PLAIN_CALLS == p0
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
            n0 = (sor2d.TILED_LAUNCHES, sor3d.LAUNCHES, sor2d.PLAIN_CALLS,
                  sor3d.PLAIN_CALLS)
            out_k = call()
            r_k = api.LAST_SOLVE
            assert r_k.S.is_cuda
            assert n0 == (sor2d.TILED_LAUNCHES, sor3d.LAUNCHES,
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
    t0, p0 = sor2d.TILED_LAUNCHES, sor2d.PLAIN_CALLS
    got = xt.solve_streamed(spec, S0, chunk=chunk, **kw)
    assert sor2d.TILED_LAUNCHES > t0 and sor2d.PLAIN_CALLS == p0
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

    t0, p0 = sor2d.TILED_LAUNCHES, sor2d.PLAIN_CALLS
    kern = grads()
    assert sor2d.TILED_LAUNCHES > t0 and sor2d.PLAIN_CALLS == p0
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
    every cell of the padded buffer, through the block sweep kernel and
    through its first version (the color sweep's block mode); then 37
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
        for fn, counter in ((sor3d.sor3d_color_sweep_block,
                             "BLOCK_LAUNCHES"),
                            (sor3d.sor3d_color_sweep_block_first,
                             "BLOCK_FIRST_LAUNCHES")):
            b0 = getattr(sor3d, counter)
            res = fn(bspec, P, rel, color, origin, shape, g, 1.07, ext, norm)
            assert getattr(sor3d, counter) == b0 + 1
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
    t0, b0, p0 = (sor2d.TILED_LAUNCHES, sor2d.BLOCK_LAUNCHES,
                  sor2d.PLAIN_CALLS)
    out = solve_halo_window(spec, S0, 1.8, 1e-4, 3000, check_every=32,
                            mesh=_card_mesh(cuda, (2, 2), ("y", "x")))
    assert sor2d.TILED_LAUNCHES == t0 and sor2d.PLAIN_CALLS == p0
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
    t0, b0 = sor2d.TILED_LAUNCHES, sor2d.BLOCK_LAUNCHES
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
    assert sor2d.TILED_LAUNCHES == t0 and sor2d.BLOCK_LAUNCHES > b0
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


def run_distributed(world, tmp_path, timeout=240):
    """``world`` processes of _DIST_WORKER (one a GPU with NCCL where the
    machine has CUDA, else gloo on the CPU); their saved results."""
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
    procs = [subprocess.Popen([sys.executable, "-c", _DIST_WORKER, str(r),
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
