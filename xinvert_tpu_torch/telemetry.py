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

The copy counters are always on, module integers like the kernel launch
counters of ``ops.sor2d``: ``H2D_BYTES`` and ``D2H_BYTES`` grow by the
bytes that :func:`to_device`, :func:`to_host` and the streamed solve's
pinned copies move between the host and a CUDA device.  Copies that stay
on one side count nothing, so on the CPU both stay 0.
"""
from __future__ import annotations

import threading
import time

import torch

#: bytes copied host -> CUDA device through this module's helpers
H2D_BYTES = 0
#: bytes copied CUDA device -> host through this module's helpers
D2H_BYTES = 0

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
    adds its bytes to ``H2D_BYTES`` and records a ``copy.h2d`` span."""
    device = torch.device(device)
    if device.type != "cuda" or (torch.is_tensor(a)
                                 and a.device.type != "cpu"):
        return torch.as_tensor(a, device=device)
    with span("copy.h2d"):
        t = torch.as_tensor(a, device=device)
    count_h2d(t.numel() * t.element_size())
    return t


def to_host(t):
    """``t`` on the host; a copy from a CUDA device adds its bytes to
    ``D2H_BYTES`` and records a ``copy.d2h`` span."""
    if t.device.type != "cuda":
        return t
    with span("copy.d2h"):
        out = t.cpu()
    count_d2h(out.numel() * out.element_size())
    return out


def count_h2d(nbytes):
    """Adds ``nbytes`` copied from the host to a CUDA device."""
    global H2D_BYTES
    with _LOCK:
        H2D_BYTES += int(nbytes)


def count_d2h(nbytes):
    """Adds ``nbytes`` copied from a CUDA device to the host."""
    global D2H_BYTES
    with _LOCK:
        D2H_BYTES += int(nbytes)
