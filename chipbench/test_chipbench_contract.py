"""The benchmark's files against its contract, and that it is driven by
data: a new configuration, mix, metric and cell are new files and a new
entry, with no edit to any file that is there."""
from __future__ import annotations

import ast
import io
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def bench() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_top_level_keys_and_command():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert b["command"] == ["python3", "chipbench/run.py"]
    assert b["paths"] == ["chipbench"]
    assert 1 <= b["run_seconds"] <= 51
    cells = 24
    assert 2 + 14 * cells * (b["run_seconds"] + 60) + cells * 180 + 1200 <= 43200 + 14 * cells


def test_entries_have_exactly_their_keys_and_valid_names():
    b = bench()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("chipbench/")
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == c["reduced"]
    names = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        names.add(w["name"])
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                                                  "higher")
        assert set(m.get("workloads", [])) <= names
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in {e["name"] for e in b["end_to_end"]}
    all_names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
                 for x in b[k]]
    assert len(all_names) == len(set(all_names)) and all(NAME.match(n) for n in all_names)
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in bench()["workloads"]])
def test_each_cell_finds_its_files_by_name(cell):
    b = bench()
    w = {x["name"]: x for x in b["workloads"]}[cell]
    mix = json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text())
    assert (HERE / "configs" / f"{w['config']}.json").is_file()
    assert (HERE / "drivers" / f"{mix['driver']}.py").is_file()
    assert (HERE / "limits" / f"{cell}.json").is_file()
    sys.path.insert(0, str(ROOT))
    from chipbench import run

    metrics = run.cell_metrics(b, cell)
    assert metrics, "every cell reports a per-layer metric"
    for m in metrics:
        assert (HERE / "metrics" / f"{m['name']}.py").is_file()
    e2e = [m["name"] for m in run.cell_metrics_e2e(b, cell)]
    assert "setup_s" in e2e and len(e2e) >= 2


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted(p.relative_to(HERE).as_posix()
                                        for p in HERE.rglob("*.py")))
def test_no_module_imports_jax_or_the_jax_package(path):
    tops = {m.split(".")[0] for m in _imports(HERE / path)}
    assert not tops & FORBIDDEN, f"{path} imports {tops & FORBIDDEN}"
    if path.startswith("reference/"):
        assert "repro_torch" not in tops, f"{path} imports the port"


#: the new cell's test data: a fault of its own, planted in the epoch step
NEW_CELL_FILE = '''"""A cell added by a test, with a fault of its own."""


def _frozen_tables(monkeypatch):
    """Every epoch step runs at learning rate 0: the tables never move."""
    from repro_torch.kge import engine

    for impl, real in list(engine._EPOCHS.items()):
        monkeypatch.setitem(engine._EPOCHS, impl, lambda params, spec, pos, neg, lr, real=real:
                            real(params, spec, pos, neg, 0.0))


FAULTS = [_frozen_tables]
CONTROLS = ["half_batch"]
SPAN_METRICS = ["train.epochs_in_window"]
'''


def test_a_new_cell_is_new_files_and_an_entry(tmp_path, monkeypatch):
    """Copy the benchmark, add a configuration, a mix, a metric and a cell as
    new files and entries, its cell file with a planted fault included, and
    run the new cell at its size; then run the copy's own per-cell tests:
    they take the new cell at a tiny size (it runs correct, reports its
    metrics, and its fault reads not correct), and no file that was there is
    edited."""
    dst = tmp_path / "chipbench"
    shutil.copytree(HERE, dst, ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in dst.rglob("*") if p.is_file()}
    cfg = json.loads((dst / "configs" / "transe-dbpedia.json").read_text())
    cfg["name"], cfg["owners"] = "transe-other", {"Other": {"entities": 900, "relations": 9,
                                                          "triples": 1500}}
    (dst / "configs" / "transe-other.json").write_text(json.dumps(cfg))
    (dst / "traffic" / "other-epochs.json").write_text(json.dumps(
        {"driver": "epochs", "owner": "Other", "why": "a new mix"}))
    (dst / "limits" / "train.transe-other.other-epochs.json").write_text(json.dumps(
        {"loss_gap": 1e-3, "first_change_gap": 1e-3, "change3_gap": 1e-3}))
    (dst / "metrics" / "train.epochs_in_window.py").write_text(
        "def read(ctx):\n    return ctx.counters.get('epochs')\n")
    cell = "train.transe-other.other-epochs"
    (dst / "cells" / f"{cell}.py").write_text(NEW_CELL_FILE)
    b = bench()
    b["configs"].append({"name": "transe-other", "source": "a test", "reduced": [],
                         "file": "chipbench/configs/transe-other.json", "why": "a test"})
    b["workloads"].append({"name": cell, "config": "transe-other", "traffic": "other-epochs",
                           "chips": 1, "why": "a test"})
    b["end_to_end"][[m["name"] for m in b["end_to_end"]].index("train_triples_per_s")][
        "workloads"].append(cell)
    b["per_layer"].append({"name": "train.epochs_in_window", "unit": "epochs",
                           "better": "higher", "source": "program_counter", "layer": "test",
                           "moves": "train_triples_per_s", "workloads": [cell]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import importlib.util

    spec = importlib.util.spec_from_file_location("chipbench_copy_run", dst / "run.py")
    run = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(run)
    # other test files run in this process may have loaded JAX
    monkeypatch.setattr(run, "forbidden_modules", lambda: [])
    for trace, key in ((0, "train_triples_per_s"), (1, "train.epochs_in_window")):
        out = io.StringIO()
        rc = run.run(["--workload", cell, "--seed", "5", "--seconds", "0.2", "--trace",
                      str(trace)], device="cpu", bench_path=tmp_path / "BENCHMARK.json", out=out)
        line = json.loads(out.getvalue().strip().splitlines()[-1])
        assert rc == 0 and line["correct"] is True and key in line["metrics"]

    # the copy's own per-cell tests, in a process of their own whose root is
    # the copy, each picked by its node id (a renamed one is not found and
    # fails the run); without a card, the card's controls skip
    t = "chipbench/test_chipbench_"
    want = {f"{t}cells.py::test_cell_runs_correct_with_the_contract_keys[{cell}-0]",
            f"{t}cells.py::test_cell_runs_correct_with_the_contract_keys[{cell}-1]",
            f"{t}cells.py::test_a_broken_timed_path_is_not_correct[{cell}-_frozen_tables]",
            f"{t}cells.py::test_every_cell_has_its_faults",
            f"{t}spans.py::test_a_traced_run_reports_the_span_metrics[{cell}]",
            f"{t}contract.py::test_top_level_keys_and_command",
            f"{t}contract.py::test_entries_have_exactly_their_keys_and_valid_names",
            f"{t}contract.py::test_each_cell_finds_its_files_by_name[{cell}]",
            f"{t}contract.py::test_no_module_imports_jax_or_the_jax_package[cells/{cell}.py]"}
    cards = {f"{t}card.py::test_control_is_not_correct[{cell}-{k}]"
             for k in ("bf16", "half_batch")}
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "-v", "-p", "no:cacheprovider", "-p", "no:randomly",
         *sorted(want | cards)], cwd=tmp_path, capture_output=True, text=True, timeout=900,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"), CUDA_VISIBLE_DEVICES=""))
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-2000:]
    got = dict(re.findall(r"^(\S+::\S+) (PASSED|FAILED|SKIPPED|ERROR)", proc.stdout, re.M))
    assert got == {n: "SKIPPED" if n in cards else "PASSED" for n in want | cards}, got
    changed = [p for p, data in before.items() if p.read_bytes() != data]
    assert not changed
