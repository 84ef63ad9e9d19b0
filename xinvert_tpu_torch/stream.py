# -*- coding: utf-8 -*-
"""Host-streaming batch executor: solve batches larger than device memory,
in PyTorch.

Counterpart of ``xinvert_tpu/stream.py``.  The batched path vectorises
every non-core dim into one device solve, which needs the whole batch
(forcing, coefficients and state) on the device at once.  Here the batch
stays in host memory and passes through the device in fixed-size chunks.

On the card the copies ride their own streams: a worker thread stages
chunk k+1 into pinned host buffers and copies it to the device on a side
``torch.cuda.Stream`` while chunk k's solve runs (its check windows hold
the main thread), so the copy engine moves it while the kernels sweep;
the results of chunk k go back on a third stream into pinned buffers
behind an event, which a second worker waits on before it copies them
out.  The compute stream waits on a chunk's copy event before the
solve reads it, and every tensor one stream made and another reads is
marked with ``record_stream``, so no chunk is read before its copy lands
or freed while a copy is pending.  With ``device="cpu"`` the same chunking
runs with plain copies.

Batch elements are independent in the solver (per-element convergence
flags and telemetry) and the kernels sum each slice's |S| partials in an
order set by the grid alone (``ops._driver.slice_totals``), so on the card
the chunked result is bit-identical to the resident batched solve of the
same spec.  On the CPU the plain version's ``torch.sum`` is
batch-invariant with one thread (with several, large grids may split a
lone slice's sum differently).  The last chunk is padded by repeating its
final slice, so every solve has the same shape.
"""
from __future__ import annotations

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from . import telemetry
from .solver import SolveResult, solve
from .stencil import StencilSpec

__all__ = ["solve_streamed"]


# spec data fields and the axis their (optional) batch dim occupies after
# flattening: w is (K, B?, *grid), the rest (B?, *grid)
_FIELDS = (("w", 1), ("w0", 0), ("g", 0), ("relax", 0), ("active", 0))


def _flat_np(a, lead, core):
    """Collapse a multi-dim batch to one axis (a view where it can be)."""
    if a.ndim > lead + core + 1:
        return a.reshape(a.shape[:lead] + (-1,) + a.shape[a.ndim - core:])
    return a


def _chunk_np(a, lead, core, B, b0, nb, pad_to):
    """The batch slice [b0:b0+nb] of ``a``, padded to ``pad_to`` slices by
    repeating its last one; None when ``a`` carries no batch (it is shared
    across chunks)."""
    if a.ndim <= lead + core or a.shape[lead] != B:
        return None
    part = a.narrow(lead, b0, nb)
    if nb < pad_to:
        last = a.narrow(lead, b0 + nb - 1, 1)
        reps = list(last.shape)
        reps[lead] = pad_to - nb
        part = torch.cat([part, last.expand(reps)], dim=lead)
    return part


def _host(a):
    """A host tensor of ``a`` (numpy arrays and CPU tensors stay in place)."""
    if torch.is_tensor(a):
        if a.device.type != "cpu":
            raise ValueError(f"solve_streamed takes host arrays; got a "
                             f"tensor on {a.device}")
        return a
    return torch.as_tensor(np.asarray(a))


def _resolve(device):
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: solve_streamed runs on the GPU by default; "
            "pass device='cpu' to run the plain PyTorch version on the CPU")
    return torch.device("cuda")


class _Mover:
    """Host <-> device transfers of one chunk shape.  On CUDA: pinned
    staging buffers, two per field (chunk k+1 is staged while chunk k's
    copy may still read the other), H2D on a side stream, D2H on another;
    on the CPU: plain copies.  The CUDA copies count their bytes in
    ``telemetry.H2D_BYTES`` / ``D2H_BYTES``; their ``copy.h2d`` /
    ``copy.d2h`` spans time the host's enqueue only (the staging into
    pinned memory included), not the copy, which runs on its stream."""

    def __init__(self, device):
        self.device = device
        self.cuda = device.type == "cuda"
        if self.cuda:
            self.compute = torch.cuda.current_stream(device)
            self.h2d = torch.cuda.Stream(device)
            self.d2h = torch.cuda.Stream(device)
        self._pinned = {}
        self._h2d_done = {}

    def _pin(self, key, like):
        buf = self._pinned.get(key)
        if buf is None:
            buf = torch.empty(like.shape, dtype=like.dtype, pin_memory=True)
            self._pinned[key] = buf
        return buf

    def put(self, slot, parts):
        """Send ``parts`` (name: host tensor) to the device; returns
        (name: device tensor, the copy's event or None)."""
        if not self.cuda:
            return {n: a.contiguous() for n, a in parts.items()}, None
        prev = self._h2d_done.get(slot)
        if prev is not None:
            prev.synchronize()          # this slot's last copy has landed
        staged = {}
        out = {}
        with telemetry.span("copy.h2d"):
            for n, a in parts.items():
                buf = self._pin((slot, n), a)
                buf.copy_(a)
                staged[n] = buf
            with torch.cuda.stream(self.h2d):
                for n, buf in staged.items():
                    out[n] = buf.to(self.device, non_blocking=True)
                ev = torch.cuda.Event()
                ev.record(self.h2d)
        telemetry.count_h2d(sum(b.numel() * b.element_size()
                                for b in staged.values()))
        self._h2d_done[slot] = ev
        return out, ev

    def use(self, tensors, ev):
        """Make the compute stream wait for a chunk's copy before it reads
        the chunk, and keep the chunk's memory until the compute stream is
        done with it."""
        if ev is None:
            return
        self.compute.wait_event(ev)
        for t in tensors:
            t.record_stream(self.compute)

    def get(self, slot, r):
        """Start copying a chunk's result back; returns a handle for
        :meth:`wait`."""
        leaves = (r.S, r.iters, r.rel_change, r.overflow)
        if not self.cuda:
            return leaves, None
        done = torch.cuda.Event()
        done.record(self.compute)
        outs = []
        with telemetry.span("copy.d2h"), torch.cuda.stream(self.d2h):
            self.d2h.wait_event(done)
            for i, t in enumerate(leaves):
                buf = self._pin(("out", slot, i), t)
                buf.copy_(t, non_blocking=True)
                t.record_stream(self.d2h)
                outs.append(buf)
            ev = torch.cuda.Event()
            ev.record(self.d2h)
        telemetry.count_d2h(sum(b.numel() * b.element_size() for b in outs))
        return tuple(outs), ev

    @staticmethod
    def wait(handle):
        leaves, ev = handle
        if ev is not None:
            ev.synchronize()
        return leaves


def solve_streamed(spec: StencilSpec, S0, omega=None, tol: float = 1e-8,
                   max_iters: int = 5000, *, chunk: int,
                   check_every: int = 1, scheme: str = "sor",
                   tol_type: str = "change", device=None) -> SolveResult:
    """Chunked out-of-core batched solve; bit-identical to :func:`solve`.

    ``spec`` tensors and ``S0`` live in host memory (CPU tensors or numpy
    arrays); batch dims follow the batched-solve contract (one leading batch
    axis after flattening, or broadcast/absent for shared fields).
    ``chunk`` is the number of batch slices on the device at a time: choose
    it so that about ``3 * chunk`` slices of state and coefficients fit
    device memory (two chunks in flight and one on its way back).
    ``device`` is the device the chunks are solved on: the CUDA card when
    None (raising without one), or ``"cpu"``.

    Returns a :class:`SolveResult` of host tensors with the input batch
    shape.
    """
    core = spec.ndim
    device = _resolve(device)
    S0 = _host(S0)
    fields = {n: _host(getattr(spec, n)) for n, _ in _FIELDS}
    grid = tuple(S0.shape[S0.ndim - core:])
    s_batch = tuple(S0.shape[:S0.ndim - core])
    # the solve's batch shape is the broadcast of the state's and every
    # spec field's batch dims, as in the resident batched path
    batch_shape = tuple(np.broadcast_shapes(
        s_batch, *(tuple(fields[n].shape[lead:fields[n].ndim - core])
                   for n, lead in _FIELDS)))
    B = int(np.prod(batch_shape, dtype=np.int64)) if batch_shape else 1
    chunk = int(chunk)
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")

    if B <= chunk:
        # fits in one resident chunk: the ordinary batched solve, the spec
        # untouched (no flattening)
        sp = dataclasses.replace(
            spec, **{n: telemetry.to_device(a, device)
                     for n, a in fields.items()})
        S0b = telemetry.to_device(S0.broadcast_to(batch_shape + grid), device)
        r = solve(sp, S0b, omega, tol=tol, max_iters=max_iters,
                  check_every=check_every, scheme=scheme, tol_type=tol_type)
        return SolveResult(S=telemetry.to_host(r.S),
                           iters=telemetry.to_host(r.iters),
                           rel_change=telemetry.to_host(r.rel_change),
                           overflow=telemetry.to_host(r.overflow))

    fields = {n: _flat_np(fields[n], lead, core) for n, lead in _FIELDS}
    if s_batch == batch_shape and batch_shape:
        S0 = S0.reshape((B,) + grid)
    elif s_batch not in ((), batch_shape):
        # a partly broadcast state: the full flat batch, once, on the host
        S0 = S0.broadcast_to(batch_shape + grid).reshape((B,) + grid)

    # shared (unbatched) fields go to the device once
    shared = {n: telemetry.to_device(fields[n], device) for n, lead in _FIELDS
              if _chunk_np(fields[n], lead, core, B, 0, 1, 1) is None}
    S0_shared = None
    if not s_batch:
        # unbatched initial state: one (chunk, *grid) copy on the device
        S0_shared = telemetry.to_device(S0, device).expand(
            (chunk,) + grid).contiguous()

    mover = _Mover(device)
    n_chunks = -(-B // chunk)

    def put_chunk(i):
        b0 = i * chunk
        nb = min(chunk, B - b0)
        host = {n: _chunk_np(fields[n], lead, core, B, b0, nb, chunk)
                for n, lead in _FIELDS if n not in shared}
        if S0_shared is None:
            host["S0"] = _chunk_np(S0, 0, core, B, b0, nb, chunk)
        dev, ev = mover.put(i % 2, host)
        return nb, dev, ev

    out_S = torch.empty((B,) + grid, dtype=S0.dtype)
    out_it = torch.empty((B,), dtype=torch.int32)
    out_rel = torch.empty((B,), dtype=S0.dtype)
    out_ovf = torch.empty((B,), dtype=torch.bool)

    def fetch(i, nb, handle):
        S, it, rel, ovf = mover.wait(handle)
        b0 = i * chunk
        out_S[b0:b0 + nb] = S[:nb]
        out_it[b0:b0 + nb] = it[:nb]
        out_rel[b0:b0 + nb] = rel[:nb]
        out_ovf[b0:b0 + nb] = ovf[:nb]

    # one worker stages chunk i+1 into pinned memory and issues its copy
    # while chunk i solves (the solve's check windows hold this thread);
    # the other copies chunk i-1's result out of its pinned buffers
    with ThreadPoolExecutor(max_workers=2) as pool:
        nxt = pool.submit(put_chunk, 0)
        fetches = {}
        for i in range(n_chunks):
            nb, dev, ev = nxt.result()
            if i + 1 < n_chunks:
                nxt = pool.submit(put_chunk, i + 1)
            mover.use(dev.values(), ev)
            parts = dict(shared)
            parts.update({n: dev[n] for n, _ in _FIELDS if n in dev})
            cspec = dataclasses.replace(spec, **parts)
            Sc = S0_shared if S0_shared is not None else dev["S0"]
            r = solve(cspec, Sc, omega, tol=tol, max_iters=max_iters,
                      check_every=check_every, scheme=scheme,
                      tol_type=tol_type)
            slot = i % 2
            if slot in fetches:            # its pinned buffers are free
                fetches.pop(slot).result()
            fetches[slot] = pool.submit(fetch, i, nb, mover.get(slot, r))
        for f in fetches.values():
            f.result()

    return SolveResult(
        S=out_S.reshape(batch_shape + grid),
        iters=out_it.reshape(batch_shape),
        rel_change=out_rel.reshape(batch_shape),
        overflow=out_ovf.reshape(batch_shape))
