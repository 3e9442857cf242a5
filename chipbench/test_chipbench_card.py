"""On the card: each cell's control, the reference in the next lower
precision (bfloat16 for the configurations' float32) put in the program's
place, has to come out as not correct at the cell's own size, and so has the
reference with a planted fault (the controls beyond ``bf16`` that the cell's
``cells/<cell>.py`` names: half of each batch; each handshake's retrain left
out). Run on a machine with a CUDA card:

    python -m pytest -q -m chipbench_card chipbench/test_chipbench_card.py

Each case runs the cell for a short window on three seeds. Without a card
every case skips."""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chipbench import cells  # noqa: E402

CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
LOADED = cells.loaded(CELLS)
# every cell keeps its bf16 case, also one whose file is missing
CONTROLS = {c: ["bf16"] + getattr(LOADED.get(c), "CONTROLS", []) for c in CELLS}


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.chipbench_card
@pytest.mark.parametrize("cell,control", [(c, k) for c in CONTROLS for k in CONTROLS[c]])
def test_control_is_not_correct(card, cell, control):
    for seed in (2 ** 31 + 11, 2 ** 31 + 12, 2 ** 31 + 13):
        out = subprocess.run(
            [sys.executable, "chipbench/run.py", "--workload", cell, "--seed", str(seed),
             "--seconds", "3", "--control", control],
            cwd=ROOT, capture_output=True, text=True, timeout=600)
        assert out.returncode == 0, out.stderr[-2000:]
        line = json.loads(out.stdout.strip().splitlines()[-1])
        assert line["correct"] is False, (seed, line["checks"])
