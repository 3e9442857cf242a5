"""Each cell's test data, one file a cell, named after it:
``cells/<cell>.py`` for the cell ``<cell>`` of ``BENCHMARK.json``. A new
cell brings its file, and no test file is edited. Each file holds

- ``FAULTS``: callables that take pytest's ``monkeypatch`` and each plant a
  fault in the timed path that has to read as not correct (at least one);
- ``CONTROLS``: the card controls beyond ``bf16``, which every cell keeps
  (names the cell's driver takes as ``--control``);
- ``SPAN_METRICS``: per-layer metrics that a tiny traced run has to report
  as finite and at least 0.

Files whose names start with ``_`` hold what several cells share. The files
are loaded by path, like ``metrics/<name>.py``; none is named ``test_*``,
so pytest does not collect them.
"""
from __future__ import annotations

import re
from pathlib import Path

from chipbench.run import load_module

HERE = Path(__file__).resolve().parent


def files() -> dict:
    """The cell files, by cell name."""
    return {p.name[:-3]: p for p in sorted(HERE.glob("*.py")) if not p.name.startswith("_")}


def loaded(names) -> dict:
    """The files of the cells ``names`` that have one, loaded, in the order
    of ``names``; a cell without a file is left out here and fails
    ``test_every_cell_has_its_faults``."""
    have = files()
    return {n: load_module(have[n], "chipbench_cell_" + re.sub(r"\W", "_", n)) for n in names
            if n in have}
