"""The benchmark's CPU tests: ``tinybench.bench()`` maps each cell a
metric lists to the tiny cell that reports it by the cell's traffic
(``tinybench.CELLS``). The code mix's cell is Mellum's, whose metrics no
tiny GPT-2 cell reports: every test's table maps it to ``tiny.code``,
the tiny Mellum cell of test_bench_family_mellum.py, for the length of
the test."""

import pytest

import tinybench


@pytest.fixture(autouse=True)
def code_cell(monkeypatch):
    monkeypatch.setitem(tinybench.CELLS, "code", "tiny.code")
