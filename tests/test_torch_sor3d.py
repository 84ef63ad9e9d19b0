# -*- coding: utf-8 -*-
"""The module that holds the 3-D sweep kernels (xinvert_tpu_torch/ops/sor3d.py),
on the CPU: its plain versions against the two TPU kernels they stand for,
run in Pallas interpret mode on identical planes (StencilSpec.from_arrays):

- B4, ops/pallas_sor3d.py (sor_sweeps_pallas3d): BCs (fixed, extend,
  periodic), (fixed, extend, fixed) with the corner clamps and (fixed, fixed,
  periodic); unbatched and batched, shared and per-slice planes;
  standard_3d and general_3d;
- B5, ops/pallas_sor3d_window.py (sor_sweeps_window3d) in its direct
  z-windowed layout and in its z<->y permuted layout for wide, flat volumes
  (forced by shrinking the VMEM budget, as tests/test_pallas3d_window.py
  does), and its checked-solve norm (make_window3d_stepper(...).step_full).

float64; S within atol 1e-12 * max|S_jax| (XLA on the CPU may contract an
FMA, so exact equality is not asked for), sumabs at rtol 1e-12.  The red
launch with the extend pre-pass folded in is replayed by index on the CPU
(sor3d_color_sweep_emulated) and held torch.equal to the plain pre-pass
followed by the plain red half-sweep.  The CUDA kernels themselves run
only on the card (tests/test_torch_cuda.py)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small tensors: one intra-op thread keeps the parallel test workers from
# oversubscribing the cores (spinning OpenMP threads stall the others)
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from xinvert_tpu import stencil as jst  # noqa: E402
from xinvert_tpu.ops import pallas_sor3d_window as win3  # noqa: E402
from xinvert_tpu.ops.pallas_sor3d import sor_sweeps_pallas3d  # noqa: E402
from xinvert_tpu_torch import solver as tsolver  # noqa: E402
from xinvert_tpu_torch.ops import sor3d  # noqa: E402
from xinvert_tpu_torch.stencil import StencilSpec  # noqa: E402

DELTAS = (5e3, 1.1e5, 1.0e5)


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


def _mask(shape3):
    nz, ny, nx = shape3
    Fdef = np.ones(shape3, bool)
    Fdef[nz // 3:nz // 2 + 1, ny // 3:ny // 2, nx // 4:nx // 2] = False
    return Fdef


def _standard(shape3, bcs, batch=0, per_slice=False, seed=0):
    """standard_3d spec with a masked block; ``per_slice`` gives each batch
    slice its own mask, hence batched weight planes."""
    rng = np.random.default_rng(seed)
    A, B, C = (np.abs(rng.normal(1.0, 0.1, shape3)) + 0.5 for _ in range(3))
    shape = (batch,) + shape3 if batch else shape3
    F = rng.normal(0.0, 1.0, shape)
    Fdef = _mask(shape3)
    if per_slice:
        Fdef = np.broadcast_to(Fdef, shape).copy()
        Fdef[0, 1:3, 2:4, 1:5] = False
    js = jst.standard_3d(jnp.asarray(A), jnp.asarray(B), jnp.asarray(C),
                         jnp.asarray(F), jnp.asarray(Fdef), DELTAS, bcs)
    return js, rng.normal(0.0, 1e-3, shape)


def _general(shape3, bcs, seed=7):
    """general_3d spec (first-derivative terms fold into asymmetric
    neighbor weights) with a masked block."""
    rng = np.random.default_rng(seed)
    A, B, C = (np.abs(rng.normal(1.0, 0.1, shape3)) + 0.5 for _ in range(3))
    D, E, Fc = (rng.normal(0, 1e-6, shape3) for _ in range(3))
    G = -np.abs(rng.normal(1e-10, 1e-11, shape3))
    H = rng.normal(0, 1.0, shape3)
    js = jst.general_3d(*map(jnp.asarray, (A, B, C, D, E, Fc, G, H)),
                        jnp.asarray(_mask(shape3)), DELTAS, bcs)
    return js, rng.normal(0.0, 1e-3, shape3)


# ---------------------------------------------------------------- B4


@pytest.mark.parametrize("bcs,batch,per_slice", [
    (("fixed", "extend", "periodic"), 0, False),
    (("fixed", "extend", "fixed"), 0, False),
    (("fixed", "fixed", "periodic"), 0, False),
    (("fixed", "extend", "periodic"), 3, False),
    (("fixed", "extend", "fixed"), 2, True),
])
def test_plain_matches_b4(bcs, batch, per_slice):
    js, S0 = _standard((6, 10, 12), bcs, batch=batch, per_slice=per_slice)
    ts = _port(js)
    assert ts.w.dim() == (5 if per_slice else 4)
    ref = sor_sweeps_pallas3d(js, jnp.asarray(S0), 1.4, 20, interpret=True)
    _close(sor3d.sor3d_sweeps_reference(ts, torch.as_tensor(S0), 1.4, 20),
           ref)


def test_plain_matches_b4_general():
    js, S0 = _general((6, 10, 12), ("fixed", "extend", "periodic"))
    ref = sor_sweeps_pallas3d(js, jnp.asarray(S0), 1.3, 15, interpret=True)
    _close(sor3d.sor3d_sweeps_reference(_port(js), torch.as_tensor(S0), 1.3,
                                        15), ref)


# ---------------------------------------------------------------- B5


@pytest.mark.parametrize("bcs,batch", [
    (("fixed", "extend", "periodic"), 0),
    (("fixed", "extend", "fixed"), 0),
    (("fixed", "fixed", "periodic"), 2),
])
def test_plain_matches_b5(bcs, batch):
    js, S0 = _standard((24, 16, 20), bcs, batch=batch, seed=1)
    planned = win3.window3d_plan_any(js, S0.shape)
    assert planned is not None and planned[1] is False      # direct layout
    ref = win3.sor_sweeps_window3d(js, jnp.asarray(S0), 1.2, 10,
                                   interpret=True)
    _close(sor3d.sor3d_sweeps_reference(_port(js), torch.as_tensor(S0), 1.2,
                                        10), ref)


def _force_permuted(monkeypatch, js, shape):
    """Shrink the scoped-VMEM budget until the direct z-window plan fails
    but the z<->y permuted plan (wide-flat layout) still fits."""
    monkeypatch.setattr(win3, "_SCOPED_VMEM_KIB", 4096)
    assert win3.window3d_plan(js, shape) is None
    planned = win3.window3d_plan_any(js, shape)
    assert planned is not None and planned[1] is True


@pytest.mark.parametrize("family,bcs", [
    ("standard", ("fixed", "extend", "periodic")),
    ("standard", ("fixed", "extend", "fixed")),
    ("general", ("fixed", "extend", "periodic")),
])
def test_plain_matches_b5_permuted(family, bcs, monkeypatch):
    shape3 = (10, 128, 24)
    if family == "standard":
        js, S0 = _standard(shape3, bcs, seed=2)
    else:
        js, S0 = _general(shape3, bcs, seed=3)
    _force_permuted(monkeypatch, js, S0.shape)
    ref = win3.sor_sweeps_window3d(js, jnp.asarray(S0), 1.2, 12,
                                   interpret=True)
    _close(sor3d.sor3d_sweeps_reference(_port(js), torch.as_tensor(S0), 1.2,
                                        12), ref)


def test_plain_norm_matches_b5_stepper():
    js, S0 = _standard((24, 16, 20), ("fixed", "extend", "periodic"),
                       batch=2, seed=4)
    check = 7
    st = win3.make_window3d_stepper(js, jnp.asarray(S0), 1.3, check,
                                    interpret=True)
    s_j, sumabs_j = st[2](st[0](jnp.asarray(S0)))
    S_t, sumabs_t = sor3d.sor3d_sweeps_reference_norm(
        _port(js), torch.as_tensor(S0), 1.3, check)
    _close(S_t, st[1](s_j))
    np.testing.assert_allclose(sumabs_t.numpy(), np.asarray(sumabs_j),
                               rtol=1e-12)


# ---------------------------------------------------- wrappers on the CPU


def _cpu_case(batch=2):
    js, S0 = _standard((5, 7, 9), ("fixed", "extend", "fixed"), batch=batch,
                       seed=5)
    return _port(js), torch.as_tensor(S0)


def test_wrapper_takes_plain_path_on_cpu():
    ts, S0 = _cpu_case()
    before = S0.clone()
    l0, e0, p0 = sor3d.LAUNCHES, sor3d.EXTEND_LAUNCHES, sor3d.PLAIN_CALLS
    out = sor3d.sor3d_sweeps(ts, S0, 1.3, 5)
    out_n, sumabs = sor3d.sor3d_sweeps(ts, S0, 1.3, 5, with_norm=True)
    assert (sor3d.LAUNCHES, sor3d.EXTEND_LAUNCHES) == (l0, e0)
    assert sor3d.PLAIN_CALLS == p0 + 2
    assert torch.equal(out, sor3d.sor3d_sweeps_reference(ts, S0, 1.3, 5))
    assert torch.equal(out_n, out)
    assert torch.equal(sumabs, out.abs().sum(dim=(-3, -2, -1)))
    assert torch.equal(S0, before)          # the caller's tensor is untouched
    # the engine sends 3-D specs here
    assert torch.equal(tsolver.solve_fixed(ts, S0, 1.3, 5), out)


def test_per_kernel_plain_versions_compose_one_sweep():
    """extend, red, black through the per-kernel wrappers == one sweep."""
    ts, S0 = _cpu_case()
    rel = sor3d.relax_plane(ts, 1.3)
    S = sor3d.sor3d_extend(ts, S0)
    assert torch.equal(S, tsolver._apply_extend(ts, S0))
    # rows 0 and ny-1 change on interior levels only, never on z edges
    assert torch.equal(S[:, [0, -1]], S0[:, [0, -1]])
    assert torch.equal(S[:, 1:-1, 0, 1:-1], S0[:, 1:-1, 1, 1:-1])
    assert torch.equal(S[:, 1:-1, -1, 0], S0[:, 1:-1, -2, 1])
    S = sor3d.sor3d_color_sweep(ts, S, rel, 0)
    S = sor3d.sor3d_color_sweep(ts, S, rel, 1)
    assert torch.equal(S, sor3d.sor3d_sweeps_reference(ts, S0, 1.3, 1))
    assert torch.equal(S, tsolver.sweep(ts, S0, 1.3))


def test_wrapper_raises_off_cpu_without_cuda():
    """A tensor that is neither on the CPU nor on CUDA never falls back."""
    ts, S0 = _cpu_case(batch=0)
    meta = torch.empty(S0.shape, dtype=S0.dtype, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        sor3d.sor3d_sweeps(ts, meta, 1.3, 2)
    with pytest.raises(ValueError, match="CUDA"):
        sor3d.sor3d_extend(ts, meta)
    with pytest.raises(ValueError, match="meta"):
        tsolver.solve_fixed(ts, meta, 1.3, 2)


# -------------------------------------- the extend pre-pass folded in (CPU)


def _nan_equal(a, b):
    """torch.equal, NaN matching NaN in place."""
    na, nb = torch.isnan(a), torch.isnan(b)
    return torch.equal(na, nb) and torch.equal(torch.where(na, 0.0, a),
                                               torch.where(nb, 0.0, b))


@pytest.mark.parametrize("bcs", [("fixed", "extend", "periodic"),
                                 ("fixed", "extend", "fixed")])
@pytest.mark.parametrize("nz", [3, 6])
@pytest.mark.parametrize("batch,per_slice", [(0, False), (2, False),
                                             (2, True)])
def test_folded_red_replay_equals_extend_then_red(bcs, nz, batch, per_slice):
    """The folded red launch's reads replayed by index
    (sor3d_color_sweep_emulated: each value through extend_source after
    the wrap, the kernel's arithmetic in its order) against the plain
    extend pre-pass followed by the plain red half-sweep: torch.equal, at
    omega and with a Chebyshev factor; with the boundary rows NaN-seeded
    on interior levels (the pre-pass overwrites them, so the result is
    finite) and on every level (NaN spreads alike from the z edges)."""
    js, S0 = _standard((nz, 7, 9), bcs, batch=batch, per_slice=per_slice,
                       seed=10 + nz)
    ts = _port(js)
    S0 = torch.as_tensor(S0)
    rel = sor3d.relax_plane(ts, 1.3)
    for levels, finite in ((slice(1, -1), True), (slice(None), False)):
        S = S0.clone()
        S[..., levels, 0, :] = float("nan")
        S[..., levels, -1, :] = float("inf")
        for fac in (1.0, 1.37):
            replay = sor3d.sor3d_color_sweep_emulated(ts, S, rel, 0, fac)
            plain = sor3d.sor3d_color_sweep_reference(
                ts, sor3d.sor3d_extend_reference(ts, S), rel, 0, fac)
            assert bool(torch.isfinite(plain).all()) == finite
            assert _nan_equal(replay, plain)
            # the wrapper's plain path with the flag is the same function
            assert _nan_equal(sor3d.sor3d_color_sweep(ts, S, rel, 0, fac,
                                                      extend=True), plain)


def test_extend_source_is_the_prepass_map():
    """extend_source moves exactly the cells the pre-pass writes: rows 0
    and ny-1 of interior levels (their end columns clamped when x is not
    periodic), and no cell when y is not 'extend'."""
    core = (4, 5, 6)
    ts, _ = _cpu_case()
    S = torch.arange(float(np.prod(core))).reshape(core)
    for bcs in (("fixed", "extend", "periodic"), ("fixed", "extend", "fixed"),
                ("fixed", "fixed", "periodic")):
        spec = dataclasses.replace(ts, bcs=bcs)
        src = sor3d.extend_source(spec, core)
        assert torch.equal(S.flatten()[src], tsolver._apply_extend(spec, S))


def test_sweeps_pair_is_the_unfolded_yardstick_on_cpu():
    """sor3d_sweeps_pair (three launches a sweep on the card) and the
    folded sor3d_sweeps share one plain version on the CPU."""
    ts, S0 = _cpu_case()
    fac = [1.0 + 0.1 * k for k in range(6)]
    out = sor3d.sor3d_sweeps_pair(ts, S0, 1.0, 3, fac=fac)
    assert torch.equal(out, sor3d.sor3d_sweeps(ts, S0, 1.0, 3, fac=fac))
    assert torch.equal(out, sor3d.sor3d_sweeps_reference(ts, S0, 1.0, 3,
                                                         fac))
