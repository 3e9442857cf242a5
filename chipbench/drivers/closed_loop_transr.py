"""Link-prediction serving of TransR: the closed loop of ``closed_loop.py``
over a ``KGEServingTier`` that holds TransR tables.

The loop, the request sizes, the row pool and the sample that ``check``
holds against the reference are ``closed_loop``'s own functions. What
differs: the tables carry ``proj``, one d x d matrix per relation, drawn
from ``--seed`` on the card in set-up and again in ``check``; the launches
are the projected rank kernel's, one a batch, with its rows grouped by
relation (``g``, the batch's distinct relations); the reference is
``reference/transr.py``; and the window holds the loop's drain (``window``).
"""
from __future__ import annotations

import math
import time

import numpy as np
import torch

from chipbench import gen, trace
from chipbench.drivers import closed_loop as cl
from chipbench.reference import kge as ref_kge
from chipbench.reference import transr as ref

State = cl.State
free = cl.free


def window(st: State, seconds: float) -> dict:
    """The closed loop for ``seconds``, then its drain, both inside the
    window: a batch here is a few hundred milliseconds of device work, so the
    batches in flight when the clients stop would otherwise run past the
    window's end, in the traced device time but not in the window. Every
    request sent is counted, on the clock that ends when the device has
    finished the last of them."""
    stats0 = dict(st.tier.stats)
    st.launched.clear()
    t0 = time.perf_counter()
    _, _, _, sent, finished = cl._loop(st, seconds=seconds)
    if st.cell.device.type == "cuda":
        torch.cuda.synchronize(st.cell.device)
    window_s = time.perf_counter() - t0
    st.served = finished
    s = st.tier.stats
    served = [(q, rows) for q, rows in finished if q.state == "served"]
    lat = sorted(q.latency for q, _ in served)
    rows = sum(len(rows) for _, rows in served)
    p95 = lat[min(len(lat) - 1, math.ceil(0.95 * len(lat)) - 1)] if lat else float("nan")
    return {"window_s": window_s, "attempted": sent, "failed": len(finished) - len(served),
            "metrics": {"query_rows_per_s": rows / window_s, "query_p95_ms": 1e3 * p95},
            "counters": {"rows_dispatched": sum(len(rows) for _, rows in finished),
                         "batches": s["batches"] - stats0["batches"],
                         "padded_rows": s["padded_rows"] - stats0["padded_rows"],
                         "requests": len(finished)}}


def tables(device, seed: int, name: str, e: int, r: int, d: int) -> dict:
    """TransR tables: ``gen.tables``' ent and rel, and proj = I + 0.01
    U(±6/√d) per relation (the port's ``init_kge``), float32 on ``device``."""
    out = gen.tables(device, seed, name, e, r, d)
    g = gen.generator(device, seed, "proj", name)
    b = 6.0 / math.sqrt(d)
    proj = torch.rand((r, d, d), generator=g, device=g.device).mul_(2 * b).sub_(b).mul_(0.01)
    proj += torch.eye(d, device=proj.device)
    out["proj"] = proj
    return out


def setup(cell) -> State:
    # the program's TransR rank path: without it the tier ranks by index
    # expansion, which needs 84 GB at the 1,024-row bucket, so a program that
    # lacks it fails here at once
    from repro_torch.kernels.triple_score import projected_ranks  # noqa: F401
    from repro_torch.kge.models import KGEModel
    from repro_torch.serving import KGEServingTier

    st = State()
    st.cell = cell
    mix, cfg, dev = cell.mix, cell.cfg, cell.device
    phases = trace.Phases(dev)
    name = mix["owner"]
    sizes = dict(cfg["owners"][name], eval=cfg["eval_triples"])
    st.e, st.r, st.d = sizes["entities"], sizes["relations"], cfg["dim"]
    split = gen.owner_split(dev, cell.seed, name, sizes)
    st.known = split["train"]  # valid and test are drawn from train
    st.kind, st.k = mix["kind"], 0
    st.sizes = cl.request_sizes(mix, cell.seed, dev)
    st.pool = cl.row_pool(mix, cell.seed, dev, st.known, st.e, st.r)
    model = KGEModel(cfg["family"], st.e, st.r, st.d, norm_ord=cfg["norm_ord"])
    params = tables(dev, cell.seed, name, st.e, st.r, st.d)
    max_batch = int(mix["max_batch"])
    warm = [("rank", b) for b in cl._pow2_buckets(8, max_batch)]
    st.tier = KGEServingTier(params, model, st.known, device=dev, max_batch=max_batch,
                             warm_buckets=warm)
    del params
    phases.end("data and tier")
    st.next_req, st.pool_at = 0, 0
    st.launched = []
    if cell.trace:
        _record_launches(st)
    cl._loop(st, rounds=int(mix["warm_rounds"]))
    phases.end("warm-up round")
    st.served = []
    return st


def _record_launches(st: State) -> None:
    """Note each launch's padded rows, distinct relations and filter width:
    a span of the benchmark's own around the tier's launch, in traced runs
    only. A rank batch starts (h, r, ...) and ends with its filter; padded
    rows repeat row 0, so they add no relation."""
    tier = st.tier
    run = tier._run

    def traced_run(kind, host_in, ptab, device, kb):
        b = len(host_in[0])
        groups = len(np.unique(host_in[1]))
        st.launched.append((b, groups, host_in[-1].shape[1]))
        return run(kind, host_in, ptab, device, kb)

    tier._run = traced_run


def launches(st: State) -> dict:
    return {"projected_ranks": [{"b": b, "g": g, "e": st.e, "d": st.d, "f": f}
                                for b, g, f in st.launched]}


def check(st: State, control: str = "") -> list:
    """The sampled requests against the reference over the same tables and
    filter: the rows whose served rank lies outside the reference's near-tie
    band. ``control`` puts the reference in the program's place: ``bf16``
    computed in bfloat16, ``tf32`` with one TF32 product for its matmuls."""
    cell, dev = st.cell, st.cell.device
    name = cell.mix["owner"]
    tabs = tables(dev, cell.seed, name, st.e, st.r, st.d)
    known = ref_kge.KnownTails(st.known)
    low = {k: v.to(torch.bfloat16) for k, v in tabs.items()} if control == "bf16" else None
    sample = cl._sample(st)
    off = 0
    for q, rows in sample:
        h, r, t = rows[:, 0], rows[:, 1], rows[:, 2]
        if control == "bf16":
            got = ref.rank_bands(low["ent"], low["proj"], low["rel"], h, r, t, known)[0]
        elif control == "tf32":
            got = ref.rank_bands(tabs["ent"], tabs["proj"], tabs["rel"], h, r, t, known,
                                 allow_tf32=True)[0]
        else:
            got = q.result
        lo, hi = ref.rank_bands(tabs["ent"], tabs["proj"], tabs["rel"], h, r, t, known)
        off += int(((np.asarray(got) < lo) | (np.asarray(got) > hi)).sum())
    return [("rank_rows_off", off if sample else math.inf, cell.limits["rank_rows_off"])]
