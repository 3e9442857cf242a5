"""Link-prediction serving: a closed loop of clients over ``KGEServingTier``.

Each client keeps one request outstanding and sends its next as soon as
the last is served. Requests are filtered-rank (``submit_rank``) or top-k
(``submit_topk``) batches of rows; their sizes are one fixed, stratified
log-uniform set from ``rows_min`` to ``rows_max`` whose order the seed
shuffles, and their rows come from one pool in which half the rows are
known triples and half fresh ones. The tier's tables and filter are built
and its buckets warmed in set-up, and a warm-up round of the loop runs
before the window.

The window's rate is all query rows of the requests served in it over its
time; the latency is each such request's submit-to-result time on the
host clock (``QueryRequest.latency``), and its tail the 95th percentile
over all of them. ``check`` holds a sample of the served requests, the
longest among them, against the plain reference.
"""
from __future__ import annotations

import math
import time

import numpy as np
import torch

from chipbench import gen, trace
from chipbench.reference import kge as ref


class State:
    pass


def _pow2_buckets(lo: int, hi: int):
    out, b = [], 1 << max(0, (lo - 1).bit_length())
    while b < hi:
        out.append(b)
        b *= 2
    return out + [1 << (hi - 1).bit_length()]


def request_sizes(mix: dict, seed: int, device) -> np.ndarray:
    """The stratified log-uniform sizes, in the seed's order."""
    k = int(mix["size_strata"])
    lo, hi = mix["rows_min"], mix["rows_max"]
    u = (np.arange(k) + 0.5) / k
    sizes = np.rint(lo * (hi / lo) ** u).astype(np.int64)
    return sizes[gen.sample_rows(device, seed, "sizes", k, k)]


def row_pool(mix: dict, seed: int, device, known: np.ndarray, e: int, r: int) -> np.ndarray:
    """(pool, 3) query rows: ``known_share`` of them known triples, the rest
    fresh uniform triples, in the seed's order."""
    n = int(mix["pool_rows"])
    n_known = int(round(n * mix["known_share"]))
    rows = np.concatenate([known[gen.sample_rows(device, seed, "known", len(known), n_known)]
                           if n_known <= len(known) else
                           known[np.resize(gen.sample_rows(device, seed, "known", len(known),
                                                           len(known)), n_known)],
                           gen.triples(device, seed, "fresh", e, r, n - n_known)])
    return rows[gen.sample_rows(device, seed, "pool", n, n)]


def setup(cell) -> State:
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
    st.kind, st.k = mix["kind"], int(mix.get("k", 0))
    st.sizes = request_sizes(mix, cell.seed, dev)
    st.pool = row_pool(mix, cell.seed, dev, st.known, st.e, st.r)
    model = KGEModel(cfg["family"], st.e, st.r, st.d, norm_ord=cfg["norm_ord"])
    params = gen.tables(dev, cell.seed, name, st.e, st.r, st.d)
    max_batch = int(mix["max_batch"])
    buckets = _pow2_buckets(8, max_batch)
    warm = ([("rank", b) for b in buckets] if st.kind == "rank"
            else [("topk", b, st.k) for b in buckets])
    st.tier = KGEServingTier(params, model, st.known, device=dev, max_batch=max_batch,
                             warm_buckets=warm)
    del params
    phases.end("data and tier")
    st.next_req, st.pool_at = 0, 0
    st.launched = []
    if cell.trace:
        _record_launches(st)
    _loop(st, rounds=int(mix["warm_rounds"]))
    phases.end("warm-up round")
    st.served = []
    return st


def _record_launches(st: State) -> None:
    """Note each launch's padded rows and filter width: a span of the
    benchmark's own around the tier's launch, in traced runs only."""
    tier = st.tier
    run = tier._run

    def traced_run(kind, host_in, ptab, device, kb):
        st.launched.append((kind, len(host_in[0]), host_in[-1].shape[1]))
        return run(kind, host_in, ptab, device, kb)

    tier._run = traced_run


def _next_rows(st: State) -> np.ndarray:
    n = int(st.sizes[st.next_req % len(st.sizes)])
    st.next_req += 1
    idx = (st.pool_at + np.arange(n)) % len(st.pool)
    st.pool_at = (st.pool_at + n) % len(st.pool)
    return st.pool[idx]


def _submit(st: State):
    q = _next_rows(st)
    if st.kind == "rank":
        return st.tier.submit_rank(q[:, 0], q[:, 1], q[:, 2]), q
    return st.tier.submit_topk(q[:, 0], q[:, 1], k=st.k), q


def _loop(st: State, *, seconds: float = math.inf, rounds: int = 0):
    """Run the closed loop for ``seconds`` (or until each client has sent
    ``rounds`` requests), then drain. Returns (served within the window,
    window seconds, rows dispatched, requests submitted, everything served)."""
    tier = st.tier
    clients = int(st.cell.mix["clients"])
    t0 = time.perf_counter()
    end = t0 + seconds
    out = [_submit(st) for _ in range(clients)]
    sent = clients
    in_window, dispatched, finished = [], 0, []
    while any(o is not None for o in out):
        dispatched += tier.step()
        now = time.perf_counter()
        for c, o in enumerate(out):
            if o is None or not o[0].done:
                continue
            finished.append(o)
            if o[0].finished_at <= end:
                in_window.append(o)
            if now < end and (rounds == 0 or sent < rounds * clients):
                out[c] = _submit(st)
                sent += 1
            else:
                out[c] = None
        if now >= end and rounds == 0:
            break
    window_s = time.perf_counter() - t0
    tier.run_until_drained()
    finished += [o for o in out if o is not None]
    return in_window, window_s, dispatched, sent, finished


def window(st: State, seconds: float) -> dict:
    stats0 = dict(st.tier.stats)
    st.launched.clear()
    in_window, window_s, dispatched, sent, finished = _loop(st, seconds=seconds)
    st.served = finished
    s = st.tier.stats
    lat = sorted(q.latency for q, _ in in_window)
    rows = sum(len(rows) for _, rows in in_window)
    p95 = lat[min(len(lat) - 1, math.ceil(0.95 * len(lat)) - 1)] if lat else float("nan")
    failed = sum(q.state != "served" for q, _ in finished)
    return {"window_s": window_s, "attempted": sent, "failed": failed,
            "metrics": {"query_rows_per_s": rows / window_s, "query_p95_ms": 1e3 * p95},
            "counters": {"rows_dispatched": dispatched,
                         "batches": s["batches"] - stats0["batches"],
                         "padded_rows": s["padded_rows"] - stats0["padded_rows"],
                         "requests": len(in_window)}}


def launches(st: State) -> dict:
    kernel = "fused_ranks" if st.kind == "rank" else "pairwise_scores"
    # a top-k batch scans every entity chunk by chunk, one pairwise launch a
    # chunk; its least work is linear in the chunk, so it is counted whole
    return {kernel: [{"b": b, "e": st.e, "c": st.e, "d": st.d, "f": f, "mode": "l1"}
                     for _, b, f in st.launched]}


def free(st: State) -> None:
    st.tier = None


def _sample(st: State) -> list:
    """Served requests drawn from the seed up to ``check_rows`` rows, the
    longest served request first."""
    served = [o for o in st.served if o[0].state == "served"]
    if not served:
        return []
    longest = max(range(len(served)), key=lambda i: len(served[i][1]))
    order = gen.sample_rows(st.cell.device, st.cell.seed, "check", len(served), len(served))
    picked, rows = [longest], len(served[longest][1])
    for i in order:
        if rows >= int(st.cell.mix["check_rows"]):
            break
        if i != longest:
            picked.append(int(i))
            rows += len(served[i][1])
    return [served[i] for i in picked]


def check(st: State, control: str = "") -> list:
    """The sampled requests against the reference over the same tables and
    filter. Rank: the rows whose served rank lies outside the reference's
    near-tie band. Top-k: the widest gap of a served tail below the
    reference's best at its position. ``control="bf16"`` puts the reference
    computed in bfloat16 in the program's place."""
    cell, dev = st.cell, st.cell.device
    name = cell.mix["owner"]
    tabs = gen.tables(dev, cell.seed, name, st.e, st.r, st.d)
    known = ref.KnownTails(st.known)
    low = {k: v.to(torch.bfloat16) for k, v in tabs.items()} if control == "bf16" else None
    sample = _sample(st)
    lim = cell.limits
    if st.kind == "rank":
        off = 0
        for q, rows in sample:
            got = q.result if low is None else ref.rank_bands(low["ent"], low["rel"], rows[:, 0],
                                                               rows[:, 1], rows[:, 2], known)[0]
            lo, hi = ref.rank_bands(tabs["ent"], tabs["rel"], rows[:, 0], rows[:, 1],
                                    rows[:, 2], known)
            off += int(((np.asarray(got) < lo) | (np.asarray(got) > hi)).sum())
        return [("rank_rows_off", off if sample else math.inf, lim["rank_rows_off"])]
    gap = 0.0
    for q, rows in sample:
        best, scores = ref.topk(tabs["ent"], tabs["rel"], rows[:, 0], rows[:, 1], st.k, known)
        if low is None:
            ids, vals = q.result
        else:
            lb, ls = ref.topk(low["ent"], low["rel"], rows[:, 0], rows[:, 1], st.k, known)
            vals, ids = ls.topk(st.k, dim=1)
            ids, vals = ids.cpu().numpy(), vals.cpu().numpy()
        gap = max(gap, ref.topk_gap(ids, vals, best, scores))
        del scores
    return [("topk_gap", gap if sample else math.inf, lim["topk_gap"])]
