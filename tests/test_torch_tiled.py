# -*- coding: utf-8 -*-
"""The tiling of the 2-D tiled kernels (xinvert_tpu_torch/csrc/sor2d.cu:
sor2d_sweeps_tiled, sor2d_sweeps_tiled_inplace) on the CPU, through
``ops/sor2d.sor2d_sweeps_tiled_emulated``, which replays a plan's windows
with torch ops (modular loads, k sweeps per window with the extend pre-pass
in the windows that hold its rows, global parity, owned write-back):

- bit-equal (float64, torch.equal) to the plain sweeps, ``solver.sweeps``,
  on 64x128, 37x53 and batched 3x40x72 grids (shared and per-slice planes),
  with the extend pre-pass and periodic or fixed x, cross terms, the
  biharmonic with periodic and fixed x, n in {1, k, 2k+1}, tiles at odd
  origins, with and without Chebyshev factors, and the fused |S| sums;
- against the TPU kernels they replace, in Pallas interpret mode: B2
  (``sor_sweeps_window``) at 64x128 and 128x128, and B3
  (``_kernel_inplace``) with periodic x (its corner clamp for a
  non-periodic x fails to trace, pallas_sor_window.py:469), within
  1e-12 * max|S| (XLA on the CPU may contract an FMA);
- the plan: every (spec, core) the tiled kernels take with the package's
  radii (1, and 2 for the biharmonic) gets one, its tiles cover each cell
  exactly once in whole 32 x 8 blocks, and its halo covers k sweeps
  (h >= 2 r k).

The CUDA kernels themselves run only on the card (tests/test_torch_cuda.py).
"""
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small tensors: one intra-op thread keeps the parallel test workers from
# oversubscribing the cores (spinning OpenMP threads stall the others)
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from hypothesis import given, settings, strategies as st  # noqa: E402

from xinvert_tpu import stencil as jst  # noqa: E402
from xinvert_tpu.ops import pallas_sor_window as win  # noqa: E402
from xinvert_tpu_torch import solver as tsolver  # noqa: E402
from xinvert_tpu_torch.ops import _build, sor2d  # noqa: E402
from xinvert_tpu_torch.stencil import StencilSpec, _interior_mask  # noqa: E402

P4 = ((1, 0), (-1, 0), (0, 1), (0, -1))
X8 = P4 + ((1, 1), (-1, -1), (1, -1), (-1, 1))
BIH = ((2, 0), (1, 0), (-1, 0), (-2, 0), (0, 2), (0, 1), (0, -1), (0, -2),
       (2, 2), (2, -2), (-2, 2), (-2, -2), (1, 1), (-1, 1), (1, -1), (-1, -1))


def _spec(core, offs, bcs, bih=False, batch=0, per_slice=False, seed=0,
          dtype=torch.float64):
    """Random diagonally dominant planes (a few cells masked); per-slice
    planes when ``per_slice``, else planes the batch shares."""
    rng = np.random.default_rng(seed)
    shape = ((batch,) + core) if (batch and per_slice) else core
    active = np.broadcast_to(_interior_mask(core, bcs, bih), shape).copy()
    active &= rng.random(shape) > 0.05
    w = rng.uniform(0.05, 0.25, (len(offs),) + shape) * active
    w0 = np.where(active, -1.05 * w.sum(0), 0.0)
    relax = np.where(active, 1.0 / np.where(active, -w0, 1.0), 0.0)
    g = rng.normal(0.0, 1.0, ((batch,) if batch else ()) + core) * active
    spec = StencilSpec.from_arrays(w, w0, g, relax, active, offs, bcs, bih,
                                   False, device="cpu", dtype=dtype)
    S0 = torch.as_tensor(rng.normal(0.0, 1e-3,
                                    ((batch,) if batch else ()) + core),
                         dtype=dtype)
    return spec, S0


# ----------------------------------------------- against the plain sweeps

_CASES = {
    "extend_periodic": ((64, 128), P4, ("extend", "periodic"), False, 0,
                        False),
    "extend_fixed_odd": ((37, 53), P4, ("extend", "fixed"), False, 0, False),
    "cross_fixed": ((37, 53), X8, ("extend", "fixed"), False, 0, False),
    "batch_shared": ((40, 72), P4, ("extend", "periodic"), False, 3, False),
    "batch_per_slice": ((40, 72), X8, ("fixed", "periodic"), False, 3,
                        True),
    "bih_periodic": ((33, 38), BIH, ("extend", "periodic"), True, 0, False),
    "bih_fixed": ((29, 31), BIH, ("extend", "fixed"), True, 2, True),
}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_emulation_bit_equal_to_plain(case):
    core, offs, bcs, bih, batch, per_slice = _CASES[case]
    spec, S0 = _spec(core, offs, bcs, bih, batch, per_slice,
                     seed=len(case))
    plan = sor2d.tile_plan(spec, core, torch.float64)
    assert plan.k >= 1
    k = plan.k
    # tiles at odd origins: 7 x 9 tiles, at most 2 sweeps per launch
    odd = sor2d.make_plan(spec, core, torch.float64, False, min(k, 2), 7, 9)
    rng = np.random.default_rng(1)
    for n in sorted({1, k, 2 * k + 1}):
        facs = [float(f) for f in 1.0 + 0.4 * rng.random(2 * n)]
        for fac, omega in ((None, 1.3), (facs, 1.0)):
            ref = tsolver.sweeps(spec, S0, omega, n, fac)
            for p in (plan, odd):
                out, sumabs = sor2d.sor2d_sweeps_tiled_emulated(
                    spec, S0, omega, n, with_norm=True, fac=fac, plan=p)
                assert torch.equal(out, ref), (n, fac is None, p)
                torch.testing.assert_close(
                    sumabs, ref.abs().sum(dim=(-2, -1)), rtol=1e-12, atol=0)


def test_emulation_nan_seeded_equal_to_plain():
    """The windows load wrapped rows as the plain version rolls them, so a
    NaN and an Inf on the boundary lines spread alike (the extend's reach
    in the halo matters here)."""
    spec, S0 = _spec((37, 53), P4, ("extend", "fixed"), seed=3)
    S0[36, 3] = float("nan")
    S0[0, 52] = float("inf")
    for ty, tx in ((7, 9), (11, 13)):
        p = sor2d.make_plan(spec, (37, 53), torch.float64, False, 4, ty, tx)
        ref = tsolver.sweeps(spec, S0, 1.3, 8)
        out = sor2d.sor2d_sweeps_tiled_emulated(spec, S0, 1.3, 8, plan=p)
        assert torch.equal(torch.isnan(out), torch.isnan(ref))
        assert torch.equal(torch.nan_to_num(out), torch.nan_to_num(ref))


@pytest.mark.parametrize("case", ["extend_periodic", "batch_shared"])
def test_inplace_emulation_equal_to_plain(case):
    core, offs, bcs, bih, batch, per_slice = _CASES[case]
    spec, S0 = _spec(core, offs, bcs, bih, batch, per_slice, seed=5)
    assert sor2d.inplace_eligible(spec, core)
    plan = sor2d.tile_plan(spec, core, torch.float64, inplace=True)
    assert plan.inplace and plan.smem < sor2d.tile_plan(
        spec, core, torch.float64).smem
    for n in (1, plan.k + 1):
        out = sor2d.sor2d_sweeps_tiled_emulated(spec, S0, 1.4, n,
                                                inplace=True)
        assert torch.equal(out, tsolver.sweeps(spec, S0, 1.4, n))


def test_cpu_sweeps_take_the_plain_version():
    """On CPU tensors the tiled wrappers run the plain version and launch
    nothing."""
    core, offs, bcs, bih, batch, per_slice = _CASES["batch_shared"]
    spec, S0 = _spec(core, offs, bcs, bih, batch, per_slice)
    before = S0.clone()
    counts = (sor2d.TILED_LAUNCHES, sor2d.TILED_INPLACE_LAUNCHES,
              sor2d.RESIDENT_LAUNCHES)
    p0 = sor2d.PLAIN_CALLS
    ref = tsolver.sweeps(spec, S0, 1.3, 5)
    for fn in (sor2d.sor2d_sweeps, sor2d.sor2d_sweeps_tiled,
               sor2d.sor2d_sweeps_tiled_inplace,
               sor2d.sor2d_sweeps_resident):
        out, sumabs = fn(spec, S0, 1.3, 5, with_norm=True)
        assert torch.equal(out, ref)
        assert torch.equal(sumabs, ref.abs().sum(dim=(-2, -1)))
    assert sor2d.PLAIN_CALLS == p0 + 4
    assert counts == (sor2d.TILED_LAUNCHES, sor2d.TILED_INPLACE_LAUNCHES,
                      sor2d.RESIDENT_LAUNCHES)
    assert torch.equal(S0, before)


# ------------------------------------------------- against B2 and B3


def _jax_standard(ny, nx, bcs, cross, seed):
    rng = np.random.default_rng(seed)
    A = np.abs(rng.normal(1.0, 0.1, (ny, nx))) + 0.5
    B = rng.normal(0.0, 0.05, (ny, nx)) if cross else np.zeros((ny, nx))
    C = np.abs(rng.normal(1.0, 0.1, (ny, nx))) + 0.5
    Fdef = np.ones((ny, nx), bool)
    Fdef[ny // 3:ny // 2, nx // 4:nx // 2] = False
    js = jst.standard_2d(jnp.asarray(A), jnp.asarray(B), jnp.asarray(C),
                         jnp.asarray(rng.normal(0.0, 1.0, (ny, nx))),
                         jnp.asarray(Fdef), (1.1e5, 1.0e5), bcs,
                         include_cross=cross)
    return js, rng.normal(0.0, 1e-3, (ny, nx))


def _port(js):
    return StencilSpec.from_arrays(
        np.asarray(js.w), np.asarray(js.w0), np.asarray(js.g),
        np.asarray(js.relax), np.asarray(js.active), js.offsets, js.bcs,
        js.bih, js.stop_on_zero_norm, device="cpu", dtype=torch.float64)


def _close(out_t, out_j):
    ref = np.asarray(out_j)
    got = out_t.numpy()
    assert got.shape == ref.shape
    scale = np.abs(ref).max()
    assert scale > 0
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12 * scale)


@pytest.mark.parametrize("ny,bcs,cross", [
    (64, ("extend", "periodic"), False),
    (64, ("extend", "fixed"), True),
    (128, ("fixed", "periodic"), False),
])
def test_emulation_matches_b2(ny, bcs, cross):
    js, S0 = _jax_standard(ny, 128, bcs, cross, seed=ny)
    ref = win.sor_sweeps_window(js, jnp.asarray(S0), 1.5, 10, interpret=True)
    _close(sor2d.sor2d_sweeps_tiled_emulated(_port(js), torch.as_tensor(S0),
                                             1.5, 10), ref)


def test_inplace_emulation_matches_b3(monkeypatch):
    """B3 (``_kernel_inplace``, switched on as in tests/test_torch_
    inplace.py, jit caches cleared around the patch) against the in-place
    plan's emulation, periodic x."""
    traced = []
    kern = win._kernel_inplace

    def counting(*args, **kw):
        traced.append(1)
        return kern(*args, **kw)
    jax.clear_caches()
    monkeypatch.setattr(win, "INPLACE_KERNEL", True)
    monkeypatch.setattr(win, "_kernel_inplace", counting)
    try:
        js, S0 = _jax_standard(64, 128, ("extend", "periodic"), False, 9)
        ref = win.sor_sweeps_window(js, jnp.asarray(S0), 1.5, 9,
                                    interpret=True)
    finally:
        jax.clear_caches()
    assert traced, "B3 was not traced"
    _close(sor2d.sor2d_sweeps_tiled_emulated(_port(js), torch.as_tensor(S0),
                                             1.5, 9, inplace=True), ref)


# ---------------------------------------------------------------- the plan


@st.composite
def _plan_cases(draw):
    K = draw(st.sampled_from([0, 1, 4, 5, 8, 12, 16]))
    r = draw(st.integers(1, 2))
    offs = tuple((draw(st.integers(-r, r)), draw(st.integers(-r, r)))
                 for _ in range(K))
    bih = draw(st.booleans())
    bcs = (draw(st.sampled_from(["extend", "fixed", "periodic"])),
           draw(st.sampled_from(["extend", "fixed", "periodic"])))
    nmin = 5 if bih else 3
    ny = draw(st.integers(max(nmin, 2 * r + 1), 400))
    nx = draw(st.integers(max(nmin, 2 * r + 1), 800))
    dtype = draw(st.sampled_from([torch.float32, torch.float64]))
    inplace = draw(st.booleans()) and K <= 4
    return offs, bih, bcs, (ny, nx), dtype, inplace


class _Spec:
    """The fields tile_plan reads."""
    def __init__(self, offsets, bih, bcs):
        self.offsets, self.bih, self.bcs = offsets, bih, bcs


@settings(max_examples=150, deadline=None, database=None)
@given(_plan_cases())
def test_every_spec_the_tiled_kernels_take_gets_a_plan(case):
    offs, bih, bcs, core, dtype, inplace = case
    spec = _Spec(offs, bih, bcs)
    plan = sor2d.tile_plan(spec, core, dtype, inplace)
    r = max((abs(o) for off in offs for o in off), default=0)
    ext = (2 if bih else 1) if bcs[0] == "extend" else 0
    assert 1 <= plan.k <= sor2d.MAX_TILED_SWEEPS
    assert plan.hy >= 2 * r * plan.k + ext
    assert plan.hx >= 2 * r * plan.k + (0 if bcs[1] == "periodic" else ext)
    assert plan.hy >= 2 * r * plan.k and plan.hx >= 2 * r * plan.k
    assert plan.winy * plan.winx <= plan.threads * plan.cpt
    assert plan.pad >= r and plan.smem <= 227 * 1024
    # whole 32 x 8 blocks, whose |S| sums the kernels add in one order
    # (block_partials)
    assert plan.ty % 8 == 0 or plan.ty >= core[0]
    assert plan.tx % 32 == 0 or plan.tx >= core[1]
    # the owned tiles cover each cell of the grid exactly once
    ty_n, tx_n = plan.tiles(core)
    count = np.zeros(core, int)
    for i in range(ty_n):
        for j in range(tx_n):
            count[i * plan.ty:(i + 1) * plan.ty,
                  j * plan.tx:(j + 1) * plan.tx] += 1
    assert (count == 1).all()
    assert ty_n <= 65535


def _instantiated(macro):
    """{itemsize: [row, ...]}: the arguments of every ``macro`` row of
    csrc/sor2d.cu, by the ``sizeof(T)`` branch that holds it."""
    with open(_build.SOURCES["sor2d"]) as fh:
        src = fh.read()
    src = src[src.index(f"#define {macro}("):]
    m = re.search(r"if constexpr \(sizeof\(T\) == 4\) \{(.*?)\} else "
                  r"\{(.*?)\}", src, re.S)
    return {size: [tuple(int(v) for v in row.split(","))
                   for row in re.findall(rf"{macro}\(([^)]*)\)", body)]
            for size, body in ((4, m.group(1)), (8, m.group(2)))}


@pytest.mark.parametrize("kernel", ["tiled", "resident"])
def test_instantiations_are_the_plan_tables(kernel):
    """The rows of ``TILED_CASE`` and ``RESIDENT_CASE`` in csrc/sor2d.cu are
    exactly the configurations ``_CONFIGS`` and ``_RESIDENT_CONFIGS`` can
    pick: none is built that no plan takes, none missing that one does."""
    if kernel == "tiled":
        rows = _instantiated("TILED_CASE")
        # TILED_CASE(kmax, cpt, threads, inplace, wsmem)
        table = {s: sorted((km, cpt, nt, int(ip), ws)
                           for (isz, km, ip), (nt, cpt, ws)
                           in sor2d._CONFIGS.items() if isz == s)
                 for s in (4, 8)}
    else:
        rows = _instantiated("RESIDENT_CASE")
        # RESIDENT_CASE(cpt, threads)
        table = {s: [(cpt, nt)] for s, (nt, cpt)
                 in sor2d._RESIDENT_CONFIGS.items()}
    assert {s: sorted(r) for s, r in rows.items()} == table


# ------------------------------------------------------ the resident route

_ROUTES = {
    # name: (core, offsets, bih, dtype, resident)
    "year_f32": ((73, 144), P4, False, torch.float32, True),
    "odd_f32": ((37, 53), P4, False, torch.float32, True),
    "small_f64": ((37, 53), P4, False, torch.float64, True),
    "three_offsets": ((73, 144), P4[:3], False, torch.float32, True),
    "2048": ((2048, 2048), P4, False, torch.float32, False),
    "era5": ((721, 1440), P4, False, torch.float32, False),
    "cross_terms": ((73, 144), X8, False, torch.float32, False),
    "biharmonic": ((73, 144), BIH, True, torch.float32, False),
    "year_f64": ((73, 144), P4, False, torch.float64, False),
    "rows_past_the_slots": ((75, 144), P4, False, torch.float32, False),
    "one_dimension": ((70,), ((1,), (-1,)), False, torch.float32, False),
}


@pytest.mark.parametrize("case", sorted(_ROUTES))
def test_resident_route_by_shape_spec_and_dtype(case):
    """resident_plan takes radius-1 stencils without cross terms whose
    slice fits the kernel (the year cell's 73 x 144 in float32) and
    refuses the rest, which the tiled kernels run: 2048 x 2048, ERA5's
    721 x 1440, cross terms, the biharmonic, a float64 year slice."""
    core, offs, bih, dtype, resident = _ROUTES[case]
    spec = _Spec(offs, bih, ("extend", "periodic"))
    plan = sor2d.resident_plan(spec, core, dtype)
    assert (plan is not None) == resident
    if plan is not None:
        itemsize = torch.empty((), dtype=dtype).element_size()
        assert (plan.threads, plan.cpt) == sor2d._RESIDENT_CONFIGS[itemsize]
        assert plan.k == sor2d.MAX_RESIDENT_SWEEPS >= 32


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_resident_footprint_against_the_shared_memory(dtype):
    """The footprint of csrc/sor2d.cu::launch_resident, worked out by hand
    for the year cell's slice, and the plan's limits: a slice fits exactly
    when its pairs fit the threads x slots and its bytes ``_SMEM_MAX``."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    slots, rs, smem = sor2d.resident_footprint((73, 144), itemsize)
    assert (slots, rs) == (73 * 72, 74)
    # two color arrays of 75 x 74 (11 100 cells, a multiple of 4), 4
    # weights a cell over two colors of 73 x 74, the row sums of 10 x 5
    # blocks of 32 x 8
    assert smem == (2 * 75 * 74 + 8 * 73 * 74 + 80 * 5) * itemsize
    assert (smem <= sor2d._SMEM_MAX) == (dtype == torch.float32)
    nt, cpt = sor2d._RESIDENT_CONFIGS[itemsize]
    spec = _Spec(P4, False, ("fixed", "fixed"))
    for ny in range(3, 200, 7):
        for nx in range(3, 300, 11):
            slots, _, smem = sor2d.resident_footprint((ny, nx), itemsize)
            fits = slots <= nt * cpt and smem <= sor2d._SMEM_MAX
            plan = sor2d.resident_plan(spec, (ny, nx), dtype)
            assert (plan is not None) == fits, (ny, nx)
            if plan is not None:
                assert plan.smem == smem <= sor2d._SMEM_MAX


_RESIDENT_EMU = {
    # name: (core, bcs, batch, per_slice, dtype, n, fac, nan, modes)
    "year": ((73, 144), ("extend", "periodic"), 2, False, torch.float32, 5,
             False, False, {"fast"}),
    "year_cheby": ((73, 144), ("extend", "periodic"), 2, False,
                   torch.float32, 33, True, False, {"fast"}),
    "odd_extend_fixed": ((37, 53), ("extend", "fixed"), 0, False,
                         torch.float64, 7, False, False, {"fast"}),
    # an odd periodic x with live boundary columns: one color on both
    # sides of the wrap, read through the ghosts
    "odd_periodic": ((37, 53), ("fixed", "periodic"), 2, True,
                     torch.float64, 6, False, False, {"fast"}),
    "two_launches": ((37, 54), ("fixed", "fixed"), 3, True, torch.float64,
                     66, True, False, {"fast"}),
    "nan_seeded": ((40, 72), ("extend", "periodic"), 3, False,
                   torch.float64, 9, False, True, {"exact"}),
}


@pytest.mark.parametrize("case", sorted(_RESIDENT_EMU))
def test_resident_emulation_bit_equal_to_plain(case):
    """The resident kernel's algorithm replayed with torch ops
    (``sor2d_sweeps_resident_emulated``: the color arrays and their ghost
    ring, the kernel's neighbour offsets, the fast and exact modes, the
    launches of 64 sweeps) is the plain sweeps bit for bit, NaN and all,
    and its |S| totals the tiled kernel's blocks in their order."""
    core, bcs, batch, per_slice, dtype, n, fac, nan, want = \
        _RESIDENT_EMU[case]
    spec, S0 = _spec(core, P4, bcs, False, batch, per_slice, seed=len(case),
                     dtype=dtype)
    if nan:
        S0[..., core[0] // 2, 3] = float("nan")
        S0[..., 0, 5] = float("inf")
    plan = sor2d.resident_plan(spec, core, dtype)
    if plan is None:     # float64 slices past the card's reach still replay
        _, rs, smem = sor2d.resident_footprint(core, S0.element_size())
        plan = sor2d.ResidentPlan(512, 6, rs, smem)
    omega, facs = 1.3, None
    if fac:
        rng = np.random.default_rng(1)
        facs = [float(torch.tensor(f, dtype=dtype))
                for f in 1.0 + 0.4 * rng.random(2 * n)]
        omega = 1.0
    modes = []
    out, sumabs = sor2d.sor2d_sweeps_resident_emulated(
        spec, S0, omega, n, with_norm=True, fac=facs, plan=plan, modes=modes)
    ref = tsolver.sweeps(spec, S0, omega, n, facs)
    assert torch.equal(torch.isnan(out), torch.isnan(ref))
    assert torch.equal(torch.nan_to_num(out), torch.nan_to_num(ref))
    B = max(batch, 1)
    tot = sor2d._driver.slice_totals(
        sor2d.block_partials(ref).reshape(B, -1)).reshape(S0.shape[:-2])
    assert torch.equal(torch.nan_to_num(sumabs, nan=-1.0),
                       torch.nan_to_num(tot, nan=-1.0))
    assert set(modes) == want
