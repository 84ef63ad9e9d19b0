# -*- coding: utf-8 -*-
"""CPU tests of the reader of ``wrappers.staged_slice_share``: the ratio
of the program's staged and total slice-window counters where it has
them, and None where it has none (a program from before the counters) or
ran no tiled launch, so that a run of such a program leaves the metric
out.

    python -m pytest benchmark/tests -q
"""
from __future__ import annotations

import sys
import types
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark.harness import cell as cells  # noqa: E402

NAME = "wrappers.staged_slice_share"
MODULE = "xinvert_tpu_torch.ops.sor2d"


@pytest.fixture
def reader():
    return cells._module("metrics", NAME)


def test_none_without_the_counters(reader, monkeypatch):
    """A sor2d module without TILED_STAGED_SLICES and TILED_SLICES (it has
    the cell counters), and no sor2d module at all: None."""
    monkeypatch.setitem(sys.modules, MODULE, types.SimpleNamespace(
        TILED_LAUNCHES=5, TILED_WINDOW_CELLS=10, TILED_CELLS=4))
    assert reader.read(None) is None
    monkeypatch.delitem(sys.modules, MODULE)
    assert reader.read(None) is None


def test_none_without_a_tiled_launch(reader, monkeypatch):
    monkeypatch.setitem(sys.modules, MODULE, types.SimpleNamespace(
        TILED_STAGED_SLICES=0, TILED_SLICES=0))
    assert reader.read(None) is None


@pytest.mark.parametrize("staged,share", [(118, 118 / 120), (0, 0.0)])
def test_ratio_of_the_counters(reader, monkeypatch, staged, share):
    """The decade cell's walk: 252 tiles, two groups of 60 of the 120
    slices, so 118 of every 120 slice windows are staged; a program whose
    launches stage nothing reads 0."""
    monkeypatch.setitem(sys.modules, MODULE, types.SimpleNamespace(
        TILED_STAGED_SLICES=3 * 252 * staged, TILED_SLICES=3 * 252 * 120))
    assert reader.read(None) == pytest.approx(share)
