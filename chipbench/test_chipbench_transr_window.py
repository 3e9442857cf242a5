"""The TransR serving cell's window holds the loop's drain: every request
sent lives inside it, so the device time a traced run reads (which runs on
through the drain) cannot outlast the window it is divided by."""
from __future__ import annotations

import json
import sys
from pathlib import Path
from types import SimpleNamespace

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

from chipbench import run, tiny  # noqa: E402

CELL = "serve.transr-dbpedia.bulk-rank"


def test_the_window_holds_every_request_sent_and_its_drain():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    args = SimpleNamespace(workload=CELL, seed=2 ** 31 + 11, trace=0)
    cell = run.build_cell(args, bench, torch.device("cpu"), tiny.OVERRIDES)
    driver = run.load_module(HERE / "drivers" / f"{cell.mix['driver']}.py",
                             "chipbench_driver_transr_window")
    st = driver.setup(cell)
    win = driver.window(st, 0.3)
    served = st.served
    assert served and all(q.state == "served" for q, _ in served)
    life = max(q.finished_at for q, _ in served) - min(q.submitted_at for q, _ in served)
    assert life <= win["window_s"]
    assert len(served) == win["attempted"] == win["counters"]["requests"]
    assert not st.tier.queue and not st.tier.inflight
    rows = sum(len(r) for _, r in served)
    assert win["counters"]["rows_dispatched"] == rows
    assert win["metrics"]["query_rows_per_s"] == rows / win["window_s"]
