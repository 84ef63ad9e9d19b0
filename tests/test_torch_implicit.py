# -*- coding: utf-8 -*-
"""Implicit gradients of the PyTorch port (ops/implicit.py,
``solve_implicit``, ``transpose_spec``) against xinvert_tpu's on the same
numpy inputs, float64 on the CPU: ``transpose_spec`` equal to the dense
transpose on the active set and to the JAX package's planes (2-D with
cross terms and a mask, 3-D, the biharmonic stencil); gradients equal to
``jax.vjp`` of the JAX ``solve_implicit`` within rtol 1e-9 for
(fixed, periodic) and for the (extend, periodic) fold, batched gradients
with ``_sum_to``'s shapes; the primal equal to ``solve``; the fixed-count
linearity identity."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from xinvert_tpu import stencil as jst  # noqa: E402
from xinvert_tpu.ops import implicit as jimp  # noqa: E402
import xinvert_tpu_torch as xt  # noqa: E402
from xinvert_tpu_torch.ops import implicit, sor2d  # noqa: E402
from xinvert_tpu_torch.stencil import StencilSpec  # noqa: E402

GRAD_RTOL = 1e-9


@pytest.fixture(autouse=True)
def f64():
    """The port builds its tensors in the default dtype: float64 here."""
    dtype = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(dtype)


SOLVE_KW = dict(tol=1e-14, max_iters=60000, check_every=16)


def _port(js):
    return StencilSpec.from_arrays(
        np.asarray(js.w), np.asarray(js.w0), np.asarray(js.g),
        np.asarray(js.relax), np.asarray(js.active), js.offsets, js.bcs,
        js.bih, js.stop_on_zero_norm, device="cpu", dtype=torch.float64)


def _prob(ny, nx, bcs, cross=True, seed=0, batch=0):
    rng = np.random.default_rng(seed)
    A = np.abs(rng.normal(1, .1, (ny, nx))) + .5
    C = np.abs(rng.normal(1, .1, (ny, nx))) + .5
    B = rng.normal(0, .1, (ny, nx)) if cross else 0.0
    F = rng.normal(0, 1, (batch, ny, nx) if batch else (ny, nx))
    Fdef = np.ones((ny, nx), bool)
    if not batch:
        Fdef[ny // 3:ny // 2, nx // 3:nx // 2] = False
    js = jst.standard_2d(jnp.asarray(A), jnp.asarray(B) if cross else 0.0,
                         jnp.asarray(C), jnp.asarray(F), jnp.asarray(Fdef),
                         (1.1, 1.0), bcs)
    return js, _port(js)


def _dense(sp, shape):
    """The dense operator of a spec (rows of inactive cells left empty)."""
    N = int(np.prod(shape))
    M = np.zeros((N, N))
    act = sp.active.numpy().ravel()
    w, w0 = sp.w.numpy(), sp.w0.numpy().ravel()
    for i in np.flatnonzero(act):
        idx = np.unravel_index(i, shape)
        M[i, i] += w0[i]
        for k, off in enumerate(sp.offsets):
            j = np.ravel_multi_index(
                tuple((a + o) % n for a, o, n in zip(idx, off, shape)), shape)
            M[i, j] += w[k][idx]
    return M, act


def _check_transpose(js, ts, shape):
    tT = implicit.transpose_spec(ts)
    M, act = _dense(ts, shape)
    MT, _ = _dense(tT, shape)
    sub = np.ix_(act, act)
    assert np.abs(M[sub].T - MT[sub]).max() == 0.0
    assert np.array_equal(tT.w.numpy(), np.asarray(jimp.transpose_spec(js).w))
    assert tT.w0 is ts.w0 and tT.offsets == ts.offsets


def test_transpose_spec_dense():
    """2-D with cross terms and a mask, and 3-D."""
    js, ts = _prob(12, 16, ("fixed", "periodic"))
    _check_transpose(js, ts, (12, 16))
    rng = np.random.default_rng(3)
    sh = (5, 6, 8)
    A = np.abs(rng.normal(1, .1, sh)) + .5
    js3 = jst.standard_3d(jnp.asarray(A), jnp.asarray(A + 1),
                          jnp.asarray(A + 2),
                          jnp.asarray(rng.normal(0, 1, sh)),
                          jnp.ones(sh, bool), (1.0, 1.1, 1.2),
                          ("fixed", "fixed", "periodic"))
    _check_transpose(js3, _port(js3), sh)


def test_transpose_spec_biharmonic_dense():
    """The radius-2 17-point biharmonic stencil transposes exactly (its
    offset set is closed under negation)."""
    ny, nx = 14, 18
    rng = np.random.default_rng(5)
    A4 = jnp.asarray(np.abs(rng.normal(5e3, 100, (ny, nx))))
    Z = jnp.zeros((ny, nx))
    Bc = jnp.asarray(rng.normal(0, 10, (ny, nx)))
    js = jst.general_2d_bih(
        A4, Bc, A4, jnp.asarray(rng.normal(0, 1, (ny, nx))), Bc * 1e-2,
        Z, Z, jnp.asarray(-np.abs(rng.normal(2e-11, 1e-12, (ny, nx)))),
        Z, jnp.asarray(rng.normal(0, 1, (ny, nx))),
        jnp.ones((ny, nx), bool), (5e4, 5e4), ("fixed", "fixed"))
    _check_transpose(js, _port(js), (ny, nx))


def _jax_grads(js, S0, cvec, kw):
    """jax.vjp of the JAX solve_implicit of sum(c * S) in (w, w0, g, S0)."""
    def f(w, w0, g, S0_):
        s = dataclasses.replace(js, w=w, w0=w0, g=g)
        return jimp.solve_implicit(s, S0_, **kw)
    S, vjp = jax.vjp(f, js.w, js.w0, js.g, jnp.asarray(S0))
    return np.asarray(S), [np.asarray(a) for a in vjp(jnp.asarray(cvec))]


def _port_grads(ts, S0, cvec, kw):
    leaves = [ts.w.clone().requires_grad_(), ts.w0.clone().requires_grad_(),
              ts.g.clone().requires_grad_(),
              torch.as_tensor(S0).clone().requires_grad_()]
    s = dataclasses.replace(ts, w=leaves[0], w0=leaves[1], g=leaves[2])
    S = xt.solve_implicit(s, leaves[3], **kw)
    torch.sum(S * torch.as_tensor(cvec)).backward()
    return S.detach().numpy(), [a.grad.numpy() for a in leaves]


def _assert_grads(tg, jg):
    for name, a, b in zip(("w", "w0", "g", "S0"), tg, jg):
        assert a.shape == b.shape, name
        scale = np.abs(b).max()
        assert np.abs(a - b).max() <= GRAD_RTOL * max(scale, 1e-300), \
            (name, np.abs(a - b).max(), scale)


@pytest.mark.parametrize("bcs,cross", [(("fixed", "periodic"), True),
                                       (("extend", "periodic"), False)])
def test_gradients_match_jax_vjp(bcs, cross):
    """Gradients in w, w0, g and the pinned S0 of sum(c * S) against
    jax.vjp of the JAX solve_implicit: (fixed, periodic) with cross terms,
    and the (extend, periodic) class through the extend fold."""
    ny, nx = 12, 16
    js, ts = _prob(ny, nx, bcs, cross=cross)
    rng = np.random.default_rng(1)
    S0 = rng.normal(0, 1, (ny, nx))
    cvec = rng.normal(0, 1, (ny, nx))
    Sj, jg = _jax_grads(js, S0, cvec, SOLVE_KW)
    St, tg = _port_grads(ts, S0, cvec, SOLVE_KW)
    assert np.abs(St - Sj).max() <= 1e-12 * np.abs(Sj).max()
    _assert_grads(tg, jg)


def test_extend_fold_and_refusal():
    """The fold moves the boundary weights onto the diagonal, leaves the
    boundary rows inert and the JAX package's planes; other extend specs
    raise NotImplementedError."""
    from xinvert_tpu.ops.pallas_sor_window import _fold_extend as jfold
    js, ts = _prob(12, 16, ("extend", "periodic"), cross=False)
    assert sor2d._extend_foldable(ts)
    f = sor2d._fold_extend(ts)
    fj = jfold(js)
    assert f.bcs == ("fixed", "periodic") == tuple(fj.bcs)
    for n in ("w", "w0", "relax"):
        assert np.array_equal(getattr(f, n).numpy(),
                              np.asarray(getattr(fj, n))), n
    _, te = _prob(12, 16, ("extend", "fixed"), cross=False)
    assert not sor2d._extend_foldable(te)
    with pytest.raises(NotImplementedError):
        xt.solve_implicit(te, torch.zeros(12, 16))


def test_batched_gradients():
    """A batched forcing with shared weight planes: the weight cotangent
    sums over the batch (_sum_to), the forcing cotangent stays per slice."""
    ny, nx, B = 10, 12, 3
    js, ts = _prob(ny, nx, ("fixed", "periodic"), cross=False, seed=6,
                   batch=B)
    rng = np.random.default_rng(6)
    S0 = np.zeros((B, ny, nx))
    cvec = rng.normal(0, 1, (B, ny, nx))
    _, jg = _jax_grads(js, S0, cvec, SOLVE_KW)
    _, tg = _port_grads(ts, S0, cvec, SOLVE_KW)
    assert tg[2].shape == (B, ny, nx) and tg[0].shape == tuple(ts.w.shape)
    _assert_grads(tg, jg)


@pytest.mark.parametrize("shape,target", [((3, 4), (4,)), ((3, 4), (1, 4)),
                                          ((2, 3, 4), (3, 1)),
                                          ((3, 4), (3, 4))])
def test_sum_to(shape, target):
    x = np.random.default_rng(2).normal(0, 1, shape)
    got = implicit._sum_to(torch.as_tensor(x), target).numpy()
    want = np.asarray(jimp._sum_to(jnp.asarray(x), target))
    assert got.shape == target and np.allclose(got, want, rtol=1e-15)


def test_forward_value_matches_solve():
    """The primal is the stock checked solve: the same state."""
    _, ts = _prob(24, 32, ("fixed", "periodic"))
    S0 = torch.zeros(24, 32)
    a = xt.solve(ts, S0, omega=1.5, tol=1e-12, max_iters=5000,
                 check_every=1).S
    b = xt.solve_implicit(ts, S0, omega=1.5, tol=1e-12, max_iters=5000,
                          check_every=1)
    assert torch.equal(a, b)


def test_fixed_count_linearity_identity():
    """At a fixed sweep count (tol 0 never stops the change rule) the
    truncated solve is affine in the forcing, so the unit-step response
    doubles with the step even far from convergence; at convergence it
    equals the implicit-diff pairing <g_bar, dg>, with no small-eps finite
    difference."""
    ny, nx = 12, 16
    _, ts = _prob(ny, nx, ("fixed", "periodic"))
    rng = np.random.default_rng(11)
    S0 = torch.zeros(ny, nx)
    cvec = torch.as_tensor(rng.normal(0, 1, (ny, nx)))
    dg = torch.where(ts.active, torch.as_tensor(rng.normal(0, 1, (ny, nx))),
                     0.0)

    def loss(g, iters):
        s = dataclasses.replace(ts, g=g)
        return torch.sum(xt.solve_implicit(s, S0, tol=0.0, max_iters=iters,
                                           check_every=iters) * cvec)

    r1 = float(loss(ts.g + dg, 40) - loss(ts.g, 40))
    r2 = float(loss(ts.g + 2.0 * dg, 40) - loss(ts.g, 40))
    assert abs(r2 - 2.0 * r1) <= 1e-10 * max(abs(r1), 1.0)

    g = ts.g.clone().requires_grad_()
    L = loss(g, 2000)
    L.backward()
    lin = float(loss(ts.g + dg, 2000)) - L.item()
    an = float(torch.sum(g.grad * dg))
    assert abs(lin - an) <= 1e-9 * max(abs(an), 1.0), (lin, an)
