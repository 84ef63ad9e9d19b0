# -*- coding: utf-8 -*-
"""Host spans and host-device copy counters of the port.

Spans name where the host is in an ``invert_*`` call: the API
(``api.invert`` with its ``api.prepare``, ``api.init_state`` and
``api.finish`` pieces), the builder (``builders.build``), the engine
(``engine.solve``; ``engine.window``, the host enqueuing one check
window's sweeps and its stop test; ``engine.sync``, each host read of the
stop flags; ``engine.direct.unit`` and ``engine.direct.dense`` in the
masked direct solve) and the copies (``copy.h2d``, ``copy.d2h``).  With
tracing off (the default) :func:`span` returns one shared no-op context:
it reads no clock and allocates nothing.  :func:`enable` turns recording
on; :func:`drain` returns the recorded spans and clears them, as tuples
``(name, start_ns, end_ns, parent, call)``: ``parent`` is the index (in
the drained list) of the enclosing span or -1, ``call`` the index of the
root span, shared by every span of one call.  A span opened on a worker
thread (the streamed solve's copies) hangs under the root span open at
the time.

Times are ``time.time_ns()``, the Unix-epoch wall clock that
torch.profiler's raw events use, so the spans merge with a device trace.

:func:`to_device` and :func:`to_host` move a whole batch between the
host and a CUDA device.  A copy of at least ``_staging.CHUNK`` bytes
(16 MiB) from or to a C-contiguous array goes through reused pinned
buffers a chunk at a time, each chunk's DMA overlapped with the host's
copy of the one before (``_staging``); smaller copies (the mask, the
stop counts, a single map) and other sources take torch's plain copy.
The entry points reserve the answer's host array before the solve, so
that its pages are faulted in while the card works.  The ``copy.h2d`` /
``copy.d2h`` spans time the whole copy either way: a download until its
last byte is in the returned array, an upload until its source is read,
its last chunks then still in flight on the stream.

The copy counters are always on, module integers like the kernel launch
counters of ``ops.sor2d``: ``H2D_BYTES`` and ``D2H_BYTES`` grow by the
bytes that :func:`to_device`, :func:`to_host` and the streamed solve's
pinned copies move between the host and a CUDA device, ``STAGED_BYTES``
by those of them that went through the staging.  Copies that stay on one
side count nothing, so on the CPU all stay 0.
"""
from __future__ import annotations

import threading
import time

import torch

from . import _staging

#: bytes copied host -> CUDA device through this module's helpers
H2D_BYTES = 0
#: bytes copied CUDA device -> host through this module's helpers
D2H_BYTES = 0
#: bytes of those two that went through the pinned staging buffers
STAGED_BYTES = 0

_ON = False
_SPANS = []                   # [name, start_ns, end_ns, parent, call]
_LOCAL = threading.local()    # .open: this thread's stack of open indices
_ROOT = [-1]                  # the open root span, for worker threads
_LOCK = threading.Lock()      # worker threads record and count too


class _Null:
    """The span with tracing off."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _Null()


class _Span:
    __slots__ = ("name", "rec", "stack")

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        stack = getattr(_LOCAL, "open", None)
        if stack is None:
            stack = _LOCAL.open = []
        with _LOCK:
            parent = stack[-1] if stack else _ROOT[0]
            index = len(_SPANS)
            call = _SPANS[parent][4] if parent >= 0 else index
            self.rec = [self.name, 0, 0, parent, call]
            _SPANS.append(self.rec)
            if parent < 0:
                _ROOT[0] = index
        stack.append(index)
        self.stack = stack
        self.rec[1] = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.rec[2] = time.time_ns()
        index = self.stack.pop()
        if _ROOT[0] == index:
            _ROOT[0] = -1
        return False


def span(name):
    """A context manager that records ``name`` while tracing is on."""
    if not _ON:
        return _NULL
    return _Span(name)


def enable():
    """Start recording spans."""
    global _ON
    _ON = True


def disable():
    """Stop recording spans (those recorded stay until :func:`drain`)."""
    global _ON
    _ON = False


def drain():
    """The recorded spans, as ``(name, start_ns, end_ns, parent, call)``,
    in the order they opened; the record is cleared.  Call it outside any
    span."""
    out = [tuple(r) for r in _SPANS]
    _SPANS.clear()
    _ROOT[0] = -1
    return out


def to_device(a, device):
    """``a`` (a numpy array or a tensor) as a tensor on ``device``, as
    ``torch.as_tensor`` makes it; a copy from the host to a CUDA device
    adds its bytes to ``H2D_BYTES`` and records a ``copy.h2d`` span.  It
    is staged through pinned buffers where ``a`` is a C-contiguous array
    or CPU tensor of at least one chunk, and has then been read whole
    when this returns."""
    device = torch.device(device)
    if device.type != "cuda" or (torch.is_tensor(a)
                                 and a.device.type != "cpu"):
        return torch.as_tensor(a, device=device)
    with span("copy.h2d"):
        src = _staging.source(a)
        if src is None:
            t = torch.as_tensor(a, device=device)
        else:
            t = _staging.upload(src, device)
    count_h2d(t.numel() * t.element_size(), staged=src is not None)
    return t


def to_host(t, into=None):
    """``t`` on the host; a copy from a CUDA device adds its bytes to
    ``D2H_BYTES`` and records a ``copy.d2h`` span.  A contiguous tensor of
    at least one chunk is staged through pinned buffers into a new numpy
    array (``into``'s, a ``_staging.reserve`` future, where it fits), and
    comes back as the tensor on it."""
    if t.device.type != "cuda":
        return t
    with span("copy.d2h"):
        staged = _staging.takes(t)
        out = _staging.download(t, into) if staged else t.cpu()
    count_d2h(out.numel() * out.element_size(), staged=staged)
    return out


def count_h2d(nbytes, staged=False):
    """Adds ``nbytes`` copied from the host to a CUDA device (to
    ``STAGED_BYTES`` too where ``staged``)."""
    global H2D_BYTES, STAGED_BYTES
    with _LOCK:
        H2D_BYTES += int(nbytes)
        STAGED_BYTES += int(nbytes) if staged else 0


def count_d2h(nbytes, staged=False):
    """Adds ``nbytes`` copied from a CUDA device to the host (to
    ``STAGED_BYTES`` too where ``staged``)."""
    global D2H_BYTES, STAGED_BYTES
    with _LOCK:
        D2H_BYTES += int(nbytes)
        STAGED_BYTES += int(nbytes) if staged else 0
