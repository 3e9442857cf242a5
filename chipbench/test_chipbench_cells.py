"""Every cell end to end at a tiny size on the CPU: the generators, the
window, the readers and the reference, the result line's keys, and a
timed path broken underneath that has to read as not correct: each fault
that the cell's ``cells/<cell>.py`` plants."""
from __future__ import annotations

import io
import json
import subprocess
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

from chipbench import cells, run, tiny  # noqa: E402

CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
CELL_FILES = cells.loaded(CELLS)
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.fixture(autouse=True)
def _shared_worker(monkeypatch):
    """Other test files run in this process may have loaded JAX; the run's
    own check for it is held in a fresh process by
    ``test_a_run_loads_no_jax``."""
    monkeypatch.setattr(run, "forbidden_modules", lambda: [])


def run_cell(cell: str, seed: int = 2 ** 33 + 7, trace: int = 0) -> dict:
    out = io.StringIO()
    rc = run.run(["--workload", cell, "--seed", str(seed), "--seconds", "0.3", "--trace",
                  str(trace)], device="cpu", overrides=tiny.OVERRIDES, out=out)
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_with_the_contract_keys(cell, trace):
    line = run_cell(cell, trace=trace)
    want = KEYS + (["breakdown"] if trace else [])
    assert set(line) - {"checks"} == set(want)
    assert list(line)[-1] == "checks"
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
    else:
        assert "setup_s" in line["metrics"] and len(line["metrics"]) >= 2
    for name, c in line["checks"].items():
        assert set(c) == {"value", "limit"}, name


@pytest.mark.parametrize("cell,fault", [(c, f) for c, data in CELL_FILES.items()
                                        for f in data.FAULTS],
                         ids=lambda x: getattr(x, "__name__", x))
def test_a_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    line = run_cell(cell, seed=31)
    assert line["correct"] is False, line["checks"]


@pytest.mark.parametrize("control,correct", [("bf16", False), ("half_batch", False),
                                             ("unchanged_retrain", False), ("f64", True)])
def test_a_fed_control_reads_as_it_should(control, correct):
    """The fed cell's controls and its float64 witness, put in the program's
    place at a tiny size: each decides its own accepts and is held like the
    program; the controls read not correct, the witness correct."""
    out = io.StringIO()
    rc = run.run(["--workload", "fed.yago-dbpedia.handshake-ticks", "--seed", "77", "--seconds",
                  "0.3", "--control", control], device="cpu", overrides=tiny.OVERRIDES, out=out)
    assert rc == 0
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert line["correct"] is correct, line["checks"]


def test_every_cell_has_its_faults():
    """Every cell has ``cells/<cell>.py`` with at least one planted fault,
    and every such file names a cell of ``BENCHMARK.json``."""
    have = cells.files()
    assert set(have) <= set(CELLS), f"files of no cell: {sorted(set(have) - set(CELLS))}"
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for cell in CELLS:
        assert cell in have, f"{cell} has no cells/{cell}.py"
        data = CELL_FILES[cell]
        assert data.FAULTS and all(callable(f) for f in data.FAULTS), cell
        assert isinstance(data.CONTROLS, list) and "bf16" not in data.CONTROLS, cell
        metrics = {m["name"] for m in run.cell_metrics(bench, cell)}
        assert set(data.SPAN_METRICS) <= metrics, cell


def test_a_run_loads_no_jax():
    """A whole run in a fresh interpreter: it prints a result, so JAX and
    the JAX package were not loaded by the time the window closed."""
    code = (f"import sys; sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]\n"
            "from chipbench import run, tiny\n"
            f"sys.exit(run.run(['--workload', {CELLS[1]!r}, '--seed', '3', '--seconds', "
            "'0.2'], device='cpu', overrides=tiny.OVERRIDES))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"] is True


def test_no_card_means_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = io.StringIO()
    rc = run.run(["--workload", CELLS[0], "--seed", "1", "--seconds", "1"], out=out)
    assert rc != 0 and out.getvalue() == ""
