# -*- coding: utf-8 -*-
"""The tridiagonal solves of the PyTorch port
(``xinvert_tpu_torch/ops/tridiag.py``) against the JAX package's
(``xinvert_tpu/ops/tridiag.py``) and against ``np.linalg.solve`` on the
dense system, float64 on the CPU: ``tridiag_solve``, ``trace``,
``traceCyclic`` and the log-depth ``tridiag_solve_pscan`` /
``tridiag_cyclic_pscan`` on diagonally dominant random lines, N in
{5, 33, 128}, batched bands with a stacked rhs.  Tolerance: rtol 1e-10
(the doubling scans combine in another order than JAX's associative scan,
so the two agree to roundoff, not bit for bit)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from xinvert_tpu.ops import tridiag as jtri  # noqa: E402
from xinvert_tpu_torch.ops import tridiag as ttri  # noqa: E402

RTOL = 1e-10
SIZES = [5, 33, 128]


def _lines(n, batch=(), seed=0):
    """Diagonally dominant bands (a, b, c) and a rhs d over ``batch``."""
    rng = np.random.default_rng(seed + n)
    a = rng.normal(0.0, 1.0, batch + (n - 1,))
    c = rng.normal(0.0, 1.0, batch + (n - 1,))
    b = 2.5 + np.abs(rng.normal(0.0, 1.0, batch + (n,)))
    d = rng.normal(0.0, 1.0, batch + (n,))
    return a, b, c, d


def _dense(a, b, c, a0=0.0, cn=0.0):
    n = b.shape[-1]
    M = np.diag(b) + np.diag(a, -1) + np.diag(c, 1)
    M[0, n - 1] += a0
    M[n - 1, 0] += cn
    return M


def _close(got, want):
    got = got.numpy() if torch.is_tensor(got) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=RTOL * np.abs(want).max())


@pytest.mark.parametrize("n", SIZES)
def test_sequential_solves(n):
    """tridiag_solve and trace: the JAX package's and the dense solve."""
    a, b, c, d = _lines(n)
    want = np.linalg.solve(_dense(a, b, c), d)
    for fn in ("tridiag_solve", "trace"):
        got = getattr(ttri, fn)(*map(torch.tensor, (a, b, c, d)))
        _close(got, want)
        _close(got, getattr(jtri, fn)(a, b, c, d))


@pytest.mark.parametrize("n", SIZES)
def test_trace_cyclic(n):
    a, b, c, d = _lines(n, seed=1)
    a0, cn = 0.7, -0.4
    want = np.linalg.solve(_dense(a, b, c, a0, cn), d)
    got = ttri.traceCyclic(*map(torch.tensor, (a, b, c, d)), a0, cn)
    _close(got, want)
    _close(got, jtri.traceCyclic(a, b, c, d, a0, cn))


def test_trace_rejects_bad_lengths():
    a, b, c, d = _lines(5)
    with pytest.raises(ValueError):
        ttri.trace(torch.tensor(a[:-1]), torch.tensor(b), torch.tensor(c),
                   torch.tensor(d))


@pytest.mark.parametrize("n", SIZES)
def test_pscan_batched_bands_stacked_rhs(n):
    """Bands batched over 4 lines, the rhs stacked 3 deep over them: the
    log-depth solve against the JAX package's and each line's dense
    solve."""
    a, b, c, _ = _lines(n, (4,), seed=2)
    d = np.random.default_rng(3).normal(0.0, 1.0, (3, 4, n))
    got = ttri.tridiag_solve_pscan(*map(torch.tensor, (a, b, c, d)))
    _close(got, jtri.tridiag_solve_pscan(a, b, c, d))
    want = np.stack([[np.linalg.solve(_dense(a[i], b[i], c[i]), d[s, i])
                      for i in range(4)] for s in range(3)])
    _close(got, want)


@pytest.mark.parametrize("n", SIZES)
def test_cyclic_pscan(n):
    """Per-line corner couplings, against the JAX package's and the dense
    cyclic solve; and a rhs with an extra leading batch axis (a batched
    state's lines over shared bands), against the solve line by line."""
    a, b, c, d = _lines(n, (4,), seed=4)
    rng = np.random.default_rng(5)
    a0, cn = rng.normal(0.0, 0.5, 4), rng.normal(0.0, 0.5, 4)
    got = ttri.tridiag_cyclic_pscan(*map(torch.tensor, (a, b, c, d, a0, cn)))
    _close(got, jtri.tridiag_cyclic_pscan(a, b, c, d, a0, cn))
    _close(got, np.stack([np.linalg.solve(_dense(a[i], b[i], c[i], a0[i],
                                                 cn[i]), d[i])
                          for i in range(4)]))
    d2 = rng.normal(0.0, 1.0, (2, 4, n))
    got2 = ttri.tridiag_cyclic_pscan(*map(torch.tensor,
                                          (a, b, c, d2, a0, cn)))
    for m in range(2):
        _close(got2[m], jtri.tridiag_cyclic_pscan(a, b, c, d2[m], a0, cn))
