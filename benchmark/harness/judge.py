# -*- coding: utf-8 -*-
"""Whether what the timed calls returned is correct.

Three numbers, each with a limit from the configuration's file:

- ``mask_mismatch``: over every call of the window, the cells whose
  definedness in the returned field differs from the forcing's (NaN where
  the forcing is defined, or a value where it is undefined), with every
  cell of a field of the wrong shape; limit 0.
- ``field_gap``: over a sample of the answers drawn from the seed, with
  the slowest field in it, the widest gap between a returned field and the
  plain reference's float64 state after the same number of sweeps, over the
  defined cells, as a share of the reference's largest |value|.  It covers
  the API's masking, the builders' coefficients and the kernels' sweeps.
- ``stop_change``: for the same answers, where a field stopped before
  mxLoop, the reference's float64 relative change of mean |S| over the
  ``check_window`` sweeps before the stop, as a multiple of the
  tolerance: the engine's stopping for each field.

A call that raised, or returned a field of the wrong shape or with a
non-finite value where the forcing is defined, is a failed call.

The reference's states come from the configuration's reference module
(``benchmark/reference/<config>.py``): its ``build`` gives the folded
problem, with the boundary pre-pass of its source
(``redblack.Problem.prepass``), and the relaxation factor is its constant
``RELAXATION`` where it sets one, else the grid's optimal factor
(``redblack.relaxation``).  The module also gives
``active``, ``coefficient_elements`` and ``FLOPS_PER_POINT_SWEEP`` for
the metric readers.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from benchmark.reference import redblack


@dataclasses.dataclass
class Answer:
    """One returned field: its pool call, its index there, its values and
    the sweeps the program reports for it."""
    pool: int
    index: int
    values: np.ndarray
    sweeps: int


def scan_calls(calls, pool_values):
    """(failed calls, mask_mismatch) over every call of the window."""
    failed = mismatch = 0
    for c in calls:
        want = pool_values[c.pool]
        if c.out is None:
            failed += 1
            mismatch += want.size
            continue
        got = np.asarray(c.out)
        if got.shape != want.shape:
            failed += 1
            mismatch += want.size
            continue
        m = int(np.count_nonzero(~np.isfinite(got) != np.isnan(want)))
        mismatch += m
        failed += m > 0
    return failed, mismatch


def sample(calls, fields_per_call, n, rng):
    """The answers to judge: ``n`` (pool call, field) pairs the window
    used, drawn with ``rng``, and the one with the most sweeps; every
    call's answer for each pair."""
    used = sorted({(c.pool, j) for c in calls if c.out is not None
                   for j in range(fields_per_call)})
    if not used:
        return []
    pick = {used[i] for i in rng.choice(len(used), min(n, len(used)),
                                        replace=False)}
    slowest = max(((int(c.sweeps[j]), (c.pool, j)) for c in calls
                   if c.out is not None for j in range(fields_per_call)))
    pick.add(slowest[1])
    out = []
    for c in calls:
        if c.out is None:
            continue
        for j in range(fields_per_call):
            if (c.pool, j) in pick:
                v = c.out if fields_per_call == 1 else c.out[j]
                out.append(Answer(c.pool, j, np.array(v, np.float64),
                                  int(c.sweeps[j])))
    return out


def field_values(pool_values, fields_per_call, pool, index):
    v = pool_values[pool]
    return v if fields_per_call == 1 else v[index]


def judge(cfg, reference, answers, pool_values, fields_per_call, device):
    """{number: value} for ``answers`` against the plain reference."""
    ip = cfg["iParams"]
    mx, tol, W = int(ip["mxLoop"]), float(ip["tolerance"]), \
        int(cfg["check_window"])
    keys = sorted({(a.pool, a.index) for a in answers})
    if not keys:
        return {"field_gap": float("inf"), "stop_change": float("inf")}
    slot = {k: i for i, k in enumerate(keys)}
    values = np.stack([field_values(pool_values, fields_per_call, *k)
                       for k in keys])
    wanted = [set() for _ in keys]
    for a in answers:
        n = min(max(a.sweeps, 0), mx)
        wanted[slot[(a.pool, a.index)]].update(
            x for x in (n, n - W) if x > 0)
    prob = reference.build(cfg, values, torch.float64, device)
    omega = redblack.relaxation(reference, values.shape[1:])
    states = redblack.states_at(prob, omega, [sorted(w) for w in wanted])
    gap = stop = 0.0
    for a in answers:
        f = slot[(a.pool, a.index)]
        defined = ~np.isnan(values[f])
        if a.sweeps < 1 or a.sweeps > mx or a.values.shape != defined.shape:
            return {"field_gap": float("inf"), "stop_change": float("inf")}
        ref = states[(f, a.sweeps)].numpy()
        scale = np.max(np.abs(ref[defined]))
        diff = np.abs(a.values[defined] - ref[defined])
        gap = max(gap, float(np.max(diff) / scale) if np.all(
            np.isfinite(diff)) else float("inf"))
        if a.sweeps < mx:
            before = a.sweeps - W
            m1 = float(np.mean(np.abs(ref)))
            m0 = (float(np.mean(np.abs(states[(f, before)].numpy())))
                  if before > 0 else 0.0)
            rel = abs(m1 - m0) / m0 if m0 > 0 else float("inf")
            stop = max(stop, rel / tol)
    return {"field_gap": gap, "stop_change": stop}


def verdict(numbers, limits):
    """(correct, [(name, value, limit)]): each number at most its limit."""
    rows = [(k, numbers[k], limits[k]) for k in limits]
    return all(v <= lim for _, v, lim in rows), rows
