# -*- coding: utf-8 -*-
"""The in-place 2-D kernel's plain path (xinvert_tpu_torch/ops/sor2d.py,
``sor2d_sweeps_tiled_inplace`` and the sweeps that take it) against the TPU
kernel it stands for, ``xinvert_tpu/ops/pallas_sor_window.py::
_kernel_inplace`` (B3), run in Pallas interpret mode with the JAX package's
switch set on the module (``INPLACE_KERNEL``), on identical planes
(StencilSpec.from_arrays): plain and batched states, its fused |S| output
(``with_norm``) and its Chebyshev factors (``fac``).  float64; S within
1e-12 * max|S|, sumabs at rtol 1e-12.  Also the port's gate: the switch, the
radius-1 no-cross rule, and the race rule (an odd size along a periodic axis
is refused).  The CUDA kernel itself runs only on the card
(tests/test_torch_cuda.py)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small tensors: one intra-op thread keeps the parallel test workers from
# oversubscribing the cores (spinning OpenMP threads stall the others)
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from xinvert_tpu import stencil as jst  # noqa: E402
from xinvert_tpu.ops import pallas_sor_window as win  # noqa: E402
from xinvert_tpu_torch import solver as tsolver  # noqa: E402
from xinvert_tpu_torch.ops import sor2d  # noqa: E402
from xinvert_tpu_torch.stencil import StencilSpec  # noqa: E402


@pytest.fixture
def b3(monkeypatch):
    """The JAX package's in-place kernel switched on, with a count of the
    traces that reach ``_kernel_inplace``.  ``_window_chunk`` decides
    in-place at trace time and the switch is not in its cache key, so the
    jit caches are cleared around the patch."""
    traced = []
    kern = win._kernel_inplace

    def counting(*args, **kw):
        traced.append(kw.get("cheby"))
        return kern(*args, **kw)
    jax.clear_caches()
    monkeypatch.setattr(win, "INPLACE_KERNEL", True)
    monkeypatch.setattr(win, "_kernel_inplace", counting)
    yield traced
    jax.clear_caches()


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


def _spec(ny, nx, bcs, batch=0, seed=0):
    """standard_2d without cross terms (radius 1), masked block."""
    rng = np.random.default_rng(seed)
    A = np.abs(rng.normal(1.0, 0.1, (ny, nx))) + 0.5
    C = np.abs(rng.normal(1.0, 0.1, (ny, nx))) + 0.5
    shape = (batch, ny, nx) if batch else (ny, nx)
    Fdef = np.ones((ny, nx), bool)
    Fdef[ny // 3:ny // 2, nx // 4:nx // 2] = False
    js = jst.standard_2d(jnp.asarray(A), 0.0, jnp.asarray(C),
                         jnp.asarray(rng.normal(0.0, 1.0, shape)),
                         jnp.asarray(Fdef), (1.1e5, 1.0e5), bcs,
                         include_cross=False)
    return js, rng.normal(0.0, 1e-3, shape)


# x periodic throughout: B3's corner clamp for a non-periodic x rolls by
# -1, which Pallas refuses when it traces (pallas_sor_window.py:469); the
# port's kernel takes such specs and the card tests hold it there
@pytest.mark.parametrize("ny,nx,bcs,batch", [
    (64, 128, ("extend", "periodic"), 0),
    (64, 128, ("extend", "periodic"), 2),
    (128, 96, ("fixed", "periodic"), 0),
])
def test_plain_matches_b3(b3, ny, nx, bcs, batch):
    js, S0 = _spec(ny, nx, bcs, batch, seed=ny + batch)
    ts = _port(js)
    ref = win.sor_sweeps_window(js, jnp.asarray(S0), 1.5, 9, interpret=True)
    assert b3, "B3 was not traced"
    assert sor2d.inplace_eligible(ts, (ny, nx))
    _close(sor2d.sor2d_sweeps(ts, torch.as_tensor(S0), 1.5, 9), ref)


def test_plain_matches_b3_fused_norm(b3):
    js, S0 = _spec(64, 128, ("extend", "periodic"), batch=2, seed=3)
    check = 6
    st = win.make_window_stepper(js, jnp.asarray(S0), 1.6, check,
                                 interpret=True)
    s_j, sumabs_j = st.step_full(st.split(jnp.asarray(S0)))
    assert b3
    S_t, sumabs_t = sor2d.sor2d_sweeps(_port(js), torch.as_tensor(S0), 1.6,
                                       check, with_norm=True)
    _close(S_t, st.join(s_j))
    np.testing.assert_allclose(sumabs_t.numpy(), np.asarray(sumabs_j),
                               rtol=1e-12)


def test_plain_matches_b3_cheby_factors(b3):
    """B3 with its per-half-sweep Chebyshev factors (fac) against the plain
    sweeps fed the port's factor sequence; the recurrence state after the
    window matches too."""
    js, S0 = _spec(64, 128, ("extend", "periodic"), seed=4)
    check, omega = 8, 1.7
    st = win.make_window_cheby_stepper(js, jnp.asarray(S0), omega, check,
                                       interpret=True)
    m0, w0 = jnp.zeros((), jnp.int32), jnp.ones((), jnp.float64)
    s_j, m_j, w_j, sumabs_j = st.step_full(st.split(jnp.asarray(S0)), m0, w0)
    assert True in b3                           # traced with fac
    rho2 = tsolver.rho2_from_omega(omega, torch.float64)
    fac, m, w = tsolver._cheby_factors(0, np.float64(1.0), rho2, 2 * check)
    S_t, sumabs_t = sor2d.sor2d_sweeps(_port(js), torch.as_tensor(S0), 1.0,
                                       check, with_norm=True, fac=fac)
    _close(S_t, st.join(s_j))
    assert m == int(m_j) and w == float(w_j)
    np.testing.assert_allclose(float(sumabs_t), float(sumabs_j), rtol=1e-12)


@pytest.mark.parametrize("bcs,shape,cross,expect", [
    (("extend", "periodic"), (20, 24), False, True),
    (("extend", "periodic"), (21, 24), False, True),    # y not periodic
    (("extend", "periodic"), (20, 25), False, False),   # odd periodic nx
    (("periodic", "fixed"), (21, 24), False, False),    # odd periodic ny
    (("periodic", "periodic"), (20, 24), False, True),
    (("fixed", "fixed"), (21, 25), False, True),
    (("extend", "periodic"), (20, 24), True, False),    # cross terms
])
def test_inplace_gate(monkeypatch, bcs, shape, cross, expect):
    ny, nx = shape
    rng = np.random.default_rng(6)
    A = np.abs(rng.normal(1.0, 0.1, shape)) + 0.5
    B = rng.normal(0.0, 0.05, shape) if cross else 0.0
    js = jst.prune_zero_offsets(jst.standard_2d(
        jnp.asarray(A), B, jnp.asarray(A), jnp.asarray(rng.normal(0, 1, shape)),
        jnp.ones(shape, bool), (1.0, 1.0), bcs, include_cross=cross))
    ts = _port(js)
    assert sor2d.inplace_eligible(ts, shape) == expect
    for switch in (False, True):
        monkeypatch.setattr(sor2d, "INPLACE_KERNEL", switch)
        monkeypatch.setattr(win, "INPLACE_KERNEL", switch)
        assert sor2d._no_cross_r1(ts) == win._no_cross_r1(js)
        assert sor2d._use_inplace(ts, shape) == (switch and expect)


def test_biharmonic_is_not_inplace(monkeypatch):
    monkeypatch.setattr(sor2d, "INPLACE_KERNEL", True)
    monkeypatch.setattr(win, "INPLACE_KERNEL", True)
    shape = (16, 20)
    one = jnp.ones(shape)
    zero = jnp.zeros(shape)
    js = jst.prune_zero_offsets(jst.general_2d_bih(
        one * 5e3, zero, one * 5e3, one * -1e-6, zero, one * -1e-6, zero,
        one * -1e-11, zero, one * 1e-7, jnp.ones(shape, bool), (5e4, 5e4),
        ("extend", "periodic")))
    ts = _port(js)
    assert not sor2d._no_cross_r1(ts) and not win._no_cross_r1(js)
    assert not sor2d.inplace_eligible(ts, shape)
