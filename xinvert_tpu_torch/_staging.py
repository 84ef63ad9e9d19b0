# -*- coding: utf-8 -*-
"""Pinned staging for the whole-batch copies between the host and a CUDA
card, behind :func:`telemetry.to_device` and :func:`telemetry.to_host`.

A pageable copy of a large array crawls: CUDA moves it through a
staging buffer of its own, and a fresh pageable destination is first
touched on one thread.  Here a copy of at least :data:`CHUNK` bytes goes
through two pinned buffers of one chunk each, for each direction and
card, allocated on first use and reused by every later copy.  Chunk k's
DMA runs on the current stream while the host moves chunk k-1 between
its buffer and the caller's memory with torch's multithreaded ``copy_``;
each buffer keeps the event of the last copy through it.

A download lands in a new ``np.empty`` array and returns the tensor on
it: it owns its memory and aliases no buffer.  Writing a fresh array
first faults in its pages, one 4 KiB page at a time where the host gives
no huge pages, which costs more than the copy itself (a 380 MB answer on
such a host, eight cores: ~50-110 ms on eight threads, ~130 ms on one;
~10 ms once faulted in).
So a caller that knows the answer's shape before the solve can
:func:`reserve` its array: a worker thread faults it in while the card
solves, and the download writes to memory already there.

An upload has read its whole source when it returns; its last chunks
may still be in flight, ordered before whatever the current stream runs
next.  Smaller copies, sources that are not C-contiguous, dtypes numpy
lacks and tensors that record a gradient are not staged.
"""
from __future__ import annotations

import math
import mmap
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

#: bytes of one staging buffer, and the least copy that is staged
CHUNK = 16 << 20

#: the dtypes staged, with their numpy twins
_NUMPY = {torch.bool: np.bool_, torch.uint8: np.uint8, torch.int8: np.int8,
          torch.int16: np.int16, torch.int32: np.int32,
          torch.int64: np.int64, torch.float16: np.float16,
          torch.float32: np.float32, torch.float64: np.float64,
          torch.complex64: np.complex64, torch.complex128: np.complex128}
_NP_DTYPES = {np.dtype(n) for n in _NUMPY.values()}

_LOCK = threading.Lock()      # one staged copy at a time, from any thread
_BUFFERS = {}                 # (device index, "h2d" | "d2h") -> 2 _Buffer
_WORKER = []                  # the thread that faults reserved arrays in


class _Buffer:
    """One pinned chunk and the event of the last copy through it."""
    __slots__ = ("mem", "event")

    def __init__(self):
        self.mem = torch.empty(CHUNK, dtype=torch.uint8, pin_memory=True)
        self.event = None

    def wait(self):
        if self.event is not None:
            self.event.synchronize()

    def record(self, device):
        """Marks the copy just enqueued on ``device``'s current stream."""
        if self.event is None:
            self.event = torch.cuda.Event()
        self.event.record(torch.cuda.current_stream(device))


def _buffers(device, way):
    key = (device.index, way)
    if key not in _BUFFERS:
        _BUFFERS[key] = (_Buffer(), _Buffer())
    return _BUFFERS[key]


def plan(numel, itemsize):
    """(first element, elements) of each chunk of a copy of ``numel``
    elements of ``itemsize`` bytes: whole chunks and a shorter tail."""
    step = CHUNK // itemsize
    return [(s, min(step, numel - s)) for s in range(0, numel, step)]


def _eligible(t):
    return (t.dtype in _NUMPY and t.is_contiguous() and not t.requires_grad
            and t.numel() * t.element_size() >= CHUNK)


def source(a):
    """``a`` (a numpy array or a CPU tensor) as a CPU tensor on its own
    memory where its upload is staged, else None."""
    if isinstance(a, np.ndarray):
        if (a.dtype not in _NP_DTYPES or not a.flags.c_contiguous
                or a.nbytes < CHUNK):
            return None
        a = torch.from_numpy(a)
    elif not torch.is_tensor(a) or a.device.type != "cpu":
        return None
    return a if _eligible(a) else None


def takes(t):
    """Whether the download of tensor ``t`` is staged."""
    return t.device.type == "cuda" and _eligible(t)


def _touched(shape, dtype):
    a = np.empty(shape, dtype)
    a.reshape(-1).view(np.uint8)[::mmap.PAGESIZE] = 0   # a write a page
    return a


def reserve(shape, dtype):
    """A future of a new host array of ``shape`` and numpy ``dtype`` with
    its pages faulted in on a worker thread, for a staged download to
    land in (:func:`download`'s ``into``); None where such a download
    would not be staged."""
    dtype = np.dtype(dtype)
    shape = tuple(int(n) for n in shape)
    if dtype not in _NP_DTYPES or math.prod(shape) * dtype.itemsize < CHUNK:
        return None
    with _LOCK:
        if not _WORKER:
            _WORKER.append(ThreadPoolExecutor(
                1, thread_name_prefix="xinvert-staging"))
    return _WORKER[0].submit(_touched, shape, dtype)


def upload(src, device):
    """The CPU tensor ``src`` (from :func:`source`) as a new tensor on the
    CUDA ``device``."""
    dst = torch.empty(src.shape, dtype=src.dtype, device=device)
    s_flat, d_flat = src.view(-1), dst.view(-1)
    with _LOCK:
        bufs = _buffers(dst.device, "h2d")
        for k, (s, n) in enumerate(plan(src.numel(), src.element_size())):
            buf = bufs[k % 2]
            buf.wait()
            staged = buf.mem.view(src.dtype)[:n]
            staged.copy_(s_flat[s:s + n])
            d_flat[s:s + n].copy_(staged, non_blocking=True)
            buf.record(dst.device)
    return dst


def download(t, into=None):
    """The CUDA tensor ``t`` (one that :func:`takes`) as a CPU tensor on a
    new numpy array: ``into``'s (a :func:`reserve` future) where its shape
    and dtype are ``t``'s."""
    shape, dtype = tuple(t.shape), np.dtype(_NUMPY[t.dtype])
    dest = into.result() if into is not None else None
    if dest is None or dest.shape != shape or dest.dtype != dtype:
        dest = np.empty(shape, dtype)
    out = torch.from_numpy(dest)
    s_flat, d_flat = t.view(-1), out.view(-1)

    def drain(buf, staged, s, n):
        buf.wait()
        d_flat[s:s + n].copy_(staged)

    with _LOCK:
        bufs = _buffers(t.device, "d2h")
        pending = None
        for k, (s, n) in enumerate(plan(t.numel(), t.element_size())):
            buf = bufs[k % 2]
            staged = buf.mem.view(t.dtype)[:n]
            staged.copy_(s_flat[s:s + n], non_blocking=True)
            buf.record(t.device)
            if pending is not None:
                drain(*pending)
            pending = (buf, staged, s, n)
        drain(*pending)
    return out
