# -*- coding: utf-8 -*-
"""The CUDA kernels of the PyTorch port (xinvert_tpu_torch/csrc/sor2d.cu) on
the card: bit-equal to their plain PyTorch versions, counted, and refusing
what they do not take.  Every test here needs an NVIDIA GPU (marker
``cuda``) and skips elsewhere.  This file imports no JAX, so it runs on a
machine without it:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import xinvert_tpu_torch as xt  # noqa: E402
from xinvert_tpu_torch.grid import Grid  # noqa: E402
from xinvert_tpu_torch.models import problems  # noqa: E402
from xinvert_tpu_torch.models.params import default_mParams  # noqa: E402
from xinvert_tpu_torch.ops import sor2d  # noqa: E402
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
    out_k, sumabs = sor2d.sor2d_sweeps(spec, S0, 1.3, 15, with_norm=True)
    out_p = sor2d.sor2d_sweeps_reference(spec, S0, 1.3, 15)
    torch.cuda.synchronize()
    assert sor2d.LAUNCHES == l0 + 30
    assert torch.equal(out_k, out_p)
    assert torch.equal(S0, before)
    ref = out_p.double().abs().sum(dim=(-2, -1))
    rtol = 1e-5 if dtype == torch.float32 else 1e-12
    torch.testing.assert_close(sumabs.double(), ref, rtol=rtol, atol=0)


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
    spec3 = StencilSpec(w=spec.w[:, None], w0=spec.w0[None], g=spec.g[None],
                        relax=spec.relax[None], active=spec.active[None],
                        offsets=tuple((0,) + o for o in spec.offsets),
                        bcs=("fixed",) + spec.bcs)
    with pytest.raises(NotImplementedError):
        xt.solve_fixed(spec3, S0[None], 1.3, 2)
