# -*- coding: utf-8 -*-
"""CPU tests of the reader of ``wrappers.window_cells_per_cell``: the
ratio of the program's tiled cell counters where it has them, and None
where it has none (a program from before the counters) or ran no tiled
launch, so that a run of such a program leaves the metric out.

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

NAME = "wrappers.window_cells_per_cell"
MODULE = "xinvert_tpu_torch.ops.sor2d"


@pytest.fixture
def reader():
    return cells._module("metrics", NAME)


def test_none_without_the_counters(reader, monkeypatch):
    """A sor2d module without TILED_WINDOW_CELLS and TILED_CELLS, and no
    sor2d module at all: None."""
    monkeypatch.setitem(sys.modules, MODULE,
                        types.SimpleNamespace(TILED_LAUNCHES=5))
    assert reader.read(None) is None
    monkeypatch.delitem(sys.modules, MODULE)
    assert reader.read(None) is None


def test_none_without_a_tiled_launch(reader, monkeypatch):
    monkeypatch.setitem(sys.modules, MODULE, types.SimpleNamespace(
        TILED_WINDOW_CELLS=0, TILED_CELLS=0))
    assert reader.read(None) is None


def test_ratio_of_the_counters(reader, monkeypatch):
    """The decade cell's plan: 21 x 12 windows of 28 x 72 cells a 330 x
    720 slice."""
    monkeypatch.setitem(sys.modules, MODULE, types.SimpleNamespace(
        TILED_WINDOW_CELLS=3 * 120 * 21 * 12 * 28 * 72,
        TILED_CELLS=3 * 120 * 330 * 720))
    assert reader.read(None) == pytest.approx(21 * 12 * 28 * 72
                                              / (330 * 720))
