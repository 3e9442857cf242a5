"""Every cell end to end at a tiny size on the CPU: the generators, the
window, the readers and the reference, the result line's keys, and a
timed path broken underneath that has to read as not correct."""
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

from chipbench import run, tiny  # noqa: E402

CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
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


def _unchanged_step(monkeypatch):
    """Every epoch step returns the tables as they were."""
    from repro_torch.kge import engine

    for impl in list(engine._EPOCHS):
        monkeypatch.setitem(engine._EPOCHS, impl,
                            lambda params, spec, pos, neg, lr: torch.zeros(pos.shape[0]))


def _half_batch(monkeypatch):
    """Every step leaves out half of its batch and means over the rest."""
    from repro_torch.kge import engine

    for impl, real in list(engine._EPOCHS.items()):
        def half(params, spec, pos, neg, lr, real=real):
            b = max(1, pos.shape[1] // 2)
            return real(params, spec, pos[:, :b].contiguous(), neg[:, :b].contiguous(), lr)

        monkeypatch.setitem(engine._EPOCHS, impl, half)


def _altered_rank(monkeypatch):
    from repro_torch.kge import eval as kev

    real = kev.fused_ranks
    monkeypatch.setattr(kev, "fused_ranks", lambda *a, **kw: real(*a, **kw) + 1)


def _altered_scores(monkeypatch):
    from repro_torch.serving import engine

    real = engine.pairwise_scores

    def bent(q, table, **kw):
        s = real(q, table, **kw)
        return s + 0.5 * (torch.arange(s.shape[1], device=s.device) % 7)

    monkeypatch.setattr(engine, "pairwise_scores", bent)


def _unrefined(monkeypatch):
    """The handshake's synthesized rows leave the Procrustes refine out."""
    from repro_torch.core import tick_engine

    monkeypatch.setattr(tick_engine, "procrustes", lambda a, b: torch.eye(
        a.shape[1], dtype=a.dtype, device=a.device))


def _zeroed_retrain(monkeypatch):
    """Each handshake's retrain hands back zeroed entity rows, which score
    no better than chance, so the backtrack restores every host: a fault
    that hides behind a restore."""
    from repro_torch.core import tick_engine

    real = tick_engine._STAGES["strip"]

    def zeroed(s, spec):
        return {k: v * 0 if k == "out/ent" else v for k, v in real(s, spec).items()}

    monkeypatch.setitem(tick_engine._STAGES, "strip", zeroed)


FAULTS = {
    "train.transe-dbpedia.local-epochs": [_unchanged_step, _half_batch],
    "serve.transe-dbpedia.bulk-rank": [_altered_rank],
    "serve.transe-dbpedia.bulk-topk": [_altered_scores],
    "fed.yago-dbpedia.handshake-ticks": [_unchanged_step, _half_batch, _unrefined,
                                         _zeroed_retrain],
}


@pytest.mark.parametrize("cell,fault", [(c, f) for c in CELLS for f in FAULTS.get(c, [])],
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
    assert set(FAULTS) == set(CELLS)


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
