# -*- coding: utf-8 -*-
"""The module that holds the 2-D sweep kernels (xinvert_tpu_torch/ops/sor2d.py),
on the CPU: its plain versions against the two TPU kernels they stand for,
run in Pallas interpret mode on identical planes (StencilSpec.from_arrays):

- B1, ops/pallas_sor.py (sor_sweeps_pallas): BCs, cross terms, the 16-offset
  biharmonic extend pre-pass, shared and per-slice planes;
- B2, ops/pallas_sor_window.py (sor_sweeps_window) at 64x128 and 128x128,
  and its fused |S| norm (make_window_stepper(...).step_full).

float64; S within atol 1e-12 * max|S_jax| (XLA on the CPU may contract an
FMA, so exact equality is not asked for), sumabs at rtol 1e-12.  The CUDA
kernels themselves run only on the card (tests/test_torch_cuda.py)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small tensors: one intra-op thread keeps the parallel test workers from
# oversubscribing the cores (spinning OpenMP threads stall the others)
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from xinvert_tpu import stencil as jst  # noqa: E402
from xinvert_tpu.ops import pallas_sor_window as win  # noqa: E402
from xinvert_tpu.ops.pallas_sor import sor_sweeps_pallas  # noqa: E402
from xinvert_tpu_torch import solver as tsolver  # noqa: E402
from xinvert_tpu_torch.ops import sor2d  # noqa: E402
from xinvert_tpu_torch.stencil import StencilSpec  # noqa: E402


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


def _standard(ny, nx, bcs, cross=False, batch=0, per_slice=False, seed=0):
    """standard_2d spec with a masked block; ``per_slice`` gives each batch
    slice its own mask, hence batched weight planes."""
    rng = np.random.default_rng(seed)
    A = np.abs(rng.normal(1.0, 0.1, (ny, nx))) + 0.5
    B = rng.normal(0.0, 0.05, (ny, nx)) if cross else np.zeros((ny, nx))
    C = np.abs(rng.normal(1.0, 0.1, (ny, nx))) + 0.5
    shape = (batch, ny, nx) if batch else (ny, nx)
    F = rng.normal(0.0, 1.0, shape)
    Fdef = np.ones((ny, nx), bool)
    Fdef[ny // 3:ny // 2, nx // 4:nx // 2] = False
    if per_slice:
        Fdef = np.broadcast_to(Fdef, shape).copy()
        Fdef[0, 2:4, 1:5] = False
    js = jst.standard_2d(jnp.asarray(A), jnp.asarray(B), jnp.asarray(C),
                         jnp.asarray(F), jnp.asarray(Fdef), (1.1e5, 1.0e5),
                         bcs, include_cross=cross)
    S0 = rng.normal(0.0, 1e-3, shape)
    return js, S0


def _bih(bcs, ny=16, nx=20, seed=5):
    """The full 16-offset biharmonic stencil (B and E nonzero)."""
    rng = np.random.default_rng(seed)
    shape = (ny, nx)
    A4 = np.full(shape, 5e3)
    zero = np.zeros(shape)
    D = np.full(shape, -1e-6)
    H = np.full(shape, -1.8e-11)
    J = rng.normal(0, 1e-7, shape)
    js = jst.general_2d_bih(
        jnp.asarray(A4), zero + 1e2, jnp.asarray(A4), jnp.asarray(D),
        zero + 1e-7, jnp.asarray(D), zero, jnp.asarray(H), zero,
        jnp.asarray(J), jnp.ones(shape, bool), (5e4, 5e4), bcs)
    return js, rng.normal(0.0, 1e-9, shape)


# ---------------------------------------------------------------- B1


@pytest.mark.parametrize("bcs,cross,batch,per_slice", [
    (("extend", "periodic"), False, 0, False),
    (("fixed", "fixed"), False, 0, False),
    (("extend", "fixed"), True, 0, False),
    (("fixed", "periodic"), True, 0, False),
    (("extend", "periodic"), False, 3, False),
    (("extend", "fixed"), False, 2, True),
])
def test_plain_matches_b1(bcs, cross, batch, per_slice):
    js, S0 = _standard(14, 18, bcs, cross=cross, batch=batch,
                       per_slice=per_slice)
    ts = _port(js)
    if per_slice:
        assert ts.w.dim() == 4
    ref = sor_sweeps_pallas(js, jnp.asarray(S0), 1.4, 25, interpret=True)
    _close(sor2d.sor2d_sweeps_reference(ts, torch.as_tensor(S0), 1.4, 25),
           ref)


@pytest.mark.parametrize("bcs", [("extend", "periodic"), ("extend", "fixed")])
def test_plain_matches_b1_biharmonic(bcs):
    js, S0 = _bih(bcs)
    ts = _port(js)
    assert len(ts.offsets) == 16 and ts.bih
    ref = sor_sweeps_pallas(js, jnp.asarray(S0), 1.0, 20, interpret=True)
    _close(sor2d.sor2d_sweeps_reference(ts, torch.as_tensor(S0), 1.0, 20),
           ref)


# ---------------------------------------------------------------- B2


@pytest.mark.parametrize("ny,bcs,cross", [
    (64, ("extend", "periodic"), False),
    (64, ("extend", "fixed"), True),
    (128, ("fixed", "fixed"), False),
])
def test_plain_matches_b2(ny, bcs, cross):
    js, S0 = _standard(ny, 128, bcs, cross=cross, seed=1)
    assert win.window_plan(js, S0.shape) is not None
    ref = win.sor_sweeps_window(js, jnp.asarray(S0), 1.5, 10, interpret=True)
    _close(sor2d.sor2d_sweeps_reference(_port(js), torch.as_tensor(S0), 1.5,
                                        10), ref)


def test_plain_norm_matches_b2_fused_norm():
    js, S0 = _standard(64, 128, ("extend", "periodic"), seed=2)
    check = 7
    st = win.make_window_stepper(js, jnp.asarray(S0), 1.5, check,
                                 interpret=True)
    s_j, sumabs_j = st.step_full(st.split(jnp.asarray(S0)))
    S_t, sumabs_t = sor2d.sor2d_sweeps_reference_norm(
        _port(js), torch.as_tensor(S0), 1.5, check)
    _close(S_t, st.join(s_j))
    np.testing.assert_allclose(float(sumabs_t), float(sumabs_j), rtol=1e-12)


# ---------------------------------------------------- wrappers on the CPU


def _cpu_case(batch=3):
    js, S0 = _standard(14, 18, ("extend", "fixed"), cross=True, batch=batch)
    return _port(js), torch.as_tensor(S0)


def test_wrapper_takes_plain_path_on_cpu():
    ts, S0 = _cpu_case()
    before = S0.clone()
    names = ("RESIDENT_LAUNCHES", "TILED_LAUNCHES", "TILED_INPLACE_LAUNCHES",
             "BLOCK_LAUNCHES")
    launches = [getattr(sor2d, k) for k in names]
    p0 = sor2d.PLAIN_CALLS
    out = sor2d.sor2d_sweeps(ts, S0, 1.3, 5)
    out_n, sumabs = sor2d.sor2d_sweeps(ts, S0, 1.3, 5, with_norm=True)
    assert [getattr(sor2d, k) for k in names] == launches
    assert sor2d.PLAIN_CALLS == p0 + 2
    assert torch.equal(out, sor2d.sor2d_sweeps_reference(ts, S0, 1.3, 5))
    assert torch.equal(out_n, out)
    assert torch.equal(sumabs, out.abs().sum(dim=(-2, -1)))
    assert torch.equal(S0, before)          # the caller's tensor is untouched


def test_wrapper_raises_off_cpu_without_cuda():
    """A tensor that is neither on the CPU nor on CUDA never falls back."""
    ts, S0 = _cpu_case(batch=0)
    meta = torch.empty(S0.shape, dtype=S0.dtype, device="meta")
    for sweeps in (sor2d.sor2d_sweeps, sor2d.sor2d_sweeps_tiled):
        with pytest.raises(ValueError, match="CUDA"):
            sweeps(ts, meta, 1.3, 2)
    with pytest.raises(ValueError, match="meta"):
        tsolver.solve_fixed(ts, meta, 1.3, 2)
