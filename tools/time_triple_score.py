#!/usr/bin/env python3
"""Time the two ``triple_score`` kernels (pairwise scores, fused ranks) on one
CUDA card at the KGE serving shapes.

    python3 tools/time_triple_score.py [--src DIR] [--out FILE] [--seed N] [--requests]

``--src`` is the ``src`` directory whose ``repro_torch`` is imported
(default: this checkout's), so the same script times another checkout's
kernels, such as a parent commit unpacked with ``git archive``, on the same
card in the same run: compare two versions only within one run. The timing
and checking code is ``chip_smoke.py::score_kernel_times`` (its phase 4).

Shapes: Dbpedia's E = 491,078 entities, d = 100 (the trainer's width),
random normal rows from ``--seed``; l1 at B = 64 and B = 8, dot at B = 64.
Fused ranks: one launch over the table, gold a random entity's score, filter
rows of the gold id and three random ids. Pairwise scores: the top-k path's
launches over chunks of ``CUDA_TOPK_CHUNK`` rows. ``--requests`` also times
64-row top-k (k = 20) and rank requests through ``KGECandidateRanker`` on
Dbpedia-sized TransE tables (R = 14,085, 1,373,644 uniform known triples):
host clock, median of 30, each ending with the answer on the host. ``--topk``
also times the fused top-k kernel (k = 16, l1) at B = 64 and at the tier's
2,048-row bucket beside the chunked scan it replaced
(``chip_smoke.py::topk_times``), where the checkout has it. Prints one
line per kernel and shape, the card's name and power limit, and, last, one
JSON object with every number; exits non-zero without a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import re
import statistics
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
E, D = 491_078, 100
SHAPES = (("l1 B=64", "l1", 64), ("l1 B=8", "l1", 8), ("dot B=64", "dot", 64))
R, KNOWN = 14_085, 1_373_644


def request_times(torch, np, seed, dev):
    """Host-clock ms of one 64-row top-k and one rank request (median of 30)."""
    from repro_torch import serving
    from repro_torch.kge import models

    rng = np.random.default_rng(seed)
    known = np.stack([rng.integers(0, E, KNOWN), rng.integers(0, R, KNOWN),
                      rng.integers(0, E, KNOWN)], axis=1).astype(np.int64)
    m = models.KGEModel("transe", E, R, D, norm_ord=1)
    ranker = serving.KGECandidateRanker(models.init_kge(seed, m, device=dev), m, known)
    q = known[:64]
    out = {}
    for name, fn in (("topk_k20_ms", lambda: ranker.topk_tails(q[:, 0], q[:, 1], k=20)),
                     ("rank_ms", lambda: ranker.rank_tails(q[:, 0], q[:, 1], q[:, 2]))):
        fn()
        times = []
        for _ in range(30):
            t0 = time.perf_counter()
            fn()
            times.append(1e3 * (time.perf_counter() - t0))
        out[name] = statistics.median(times)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(REPO / "src"))
    ap.add_argument("--out", default=None, help="also write the JSON object here")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--requests", action="store_true",
                    help="also time 64-row top-k and rank requests")
    ap.add_argument("--topk", action="store_true",
                    help="also time the fused top-k at B 64 and 2,048 beside the chunked scan")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("time_triple_score: no CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    from repro_torch.kernels.triple_score import ops
    from repro_torch.serving import engine

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = cs.card_line()
    cs.log(f"card: {card}; kernels from {Path(ops.__file__).resolve().parent}")
    for name, text in ops.build_kernels().items():
        regs = [int(n) for n in re.findall(r"Used (\d+) registers", text)]
        spills = [m for m in re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads", text)
                  if m != ("0", "0")]
        cs.log(f"build {name}: {len(regs)} kernels, {min(regs, default=0)}-"
               f"{max(regs, default=0)} registers, spills: {spills or 'none'}")

    res = {"card": card, "src": str(Path(args.src).resolve()), "shapes": {}}
    if args.requests:  # first, in a fresh process
        import numpy as np

        res["requests"] = request_times(torch, np, args.seed, dev)
        torch.cuda.empty_cache()
        cs.log(f"requests (B=64, host clock): top-k k=20 {res['requests']['topk_k20_ms']:.3f} ms, "
               f"rank {res['requests']['rank_ms']:.3f} ms; {card}")

    g = torch.Generator(device=dev).manual_seed(args.seed)
    b = max(rows for _, _, rows in SHAPES)
    table = torch.randn(E, D, device=dev, generator=g)
    q = torch.randn(b, D, device=dev, generator=g)
    t = torch.randint(0, E, (b,), device=dev, generator=g)
    filt = torch.randint(0, E, (b, 4), device=dev, generator=g, dtype=torch.int32)
    filt[:, 0] = t.int()
    for label, mode, rows in SHAPES:
        qs = q[:rows].contiguous()
        gold = ops.pairwise_scores_plain(qs, table, mode, block_e=16384)[
            torch.arange(rows, device=dev), t[:rows]]
        res["shapes"][label] = cs.score_kernel_times(
            torch, ops, qs, table, gold.contiguous(), filt[:rows].contiguous(), mode,
            engine.CUDA_TOPK_CHUNK, card)
    if args.topk and hasattr(ops, "pairwise_topk"):
        for rows in (64, cs.TIER_BUCKET):
            qt = torch.randn(rows, D, device=dev, generator=g)
            ft = torch.randint(-1, E, (rows, 4), device=dev, generator=g, dtype=torch.int32)
            res["shapes"][f"topk l1 B={rows}"] = cs.topk_times(
                torch, ops, engine, qt, table, ft, "l1", cs.TOPK_K, card, plain=rows <= 64)
    cs.log(card)
    line = json.dumps(res)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line)
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
