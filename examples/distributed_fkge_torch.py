"""The paper's peer-to-peer topology on the PyTorch port: each party is a
``torch.distributed`` process.

Two KG owners train their entity tables with the row-sharded KGE step
(every table's rows split over ``--world`` processes), then run the PPAT
exchange between two processes, the client (rank 0) and the host (rank 1):
per round only the generated rows and their gradients cross the pipe. The
host refines the synthesized rows with procrustes and scores CSLS
retrieval (the ``csls`` cosine kernel on the card).

  PYTHONPATH=src python examples/distributed_fkge_torch.py --device cpu   # the CPU
  PYTHONPATH=src python examples/distributed_fkge_torch.py                # cuda:0

On a machine with fewer cards than ranks the parties share them through
``gloo`` (the default); ``--backend nccl`` needs one card per rank.
"""
import argparse
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

import numpy as np
import torch

from repro_torch.core.alignment import csls_retrieval_acc, procrustes
from repro_torch.core.distributed import (
    exchange_party,
    init_distributed_ppat,
    run_parties,
    sharded_party,
)
from repro_torch.core.pate import laplace_noise
from repro_torch.core.ppat import PPATConfig
from repro_torch.kge.data import corrupt_triples, synthesize_universe
from repro_torch.kge.models import KGEModel, init_kge

#: fixed seeds of the two owners' tables
OWNER_SEEDS = {"A": 1, "B": 2}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="'cpu' for the CPU; by default rank r runs on cuda:(r %% cards)")
    ap.add_argument("--world", type=int, default=2, help="processes the tables are sharded over")
    ap.add_argument("--backend", default="gloo", choices=("gloo", "nccl"))
    ap.add_argument("--kge-steps", type=int, default=300)
    ap.add_argument("--rounds", type=int, default=120, help="PPAT exchange rounds")
    args = ap.parse_args(argv)
    dev = torch.device(args.device) if args.device else torch.device("cuda", 0)
    print(f"parties: backend {args.backend}, world {args.world} for the tables, 2 for the "
          f"exchange, on {args.device or 'cuda:(rank % cards)'}")

    kgs = synthesize_universe(
        seed=0, scale=1 / 400,
        kg_stats=[("A", 10, 90000, 300000), ("B", 8, 70000, 240000)],
        alignments=[("A", "B", 30000)],
    )
    a, b = kgs["A"], kgs["B"]
    ia, ib = a.aligned_with(b)
    print(f"A: {a.num_entities} ents; B: {b.num_entities} ents; aligned: {len(ia)}")

    with tempfile.TemporaryDirectory() as rdzv:
        def run(fn, world, *fn_args, tag):
            return run_parties(fn, world, *fn_args, backend=args.backend, device=args.device,
                               init_method=f"file://{os.path.join(rdzv, tag)}")

        # ---- sharded local KGE training (entity rows over the ranks) ----
        dim = 32
        rng = np.random.default_rng(0)
        tables = {}
        for name, kg in (("A", a), ("B", b)):
            # pad the entity table to a row count the ranks divide (padded
            # rows never appear in triples)
            e_pad = -(-kg.num_entities // args.world) * args.world
            model = KGEModel("transe", e_pad, kg.num_relations, dim, margin=2.0)
            params = init_kge(OWNER_SEEDS[name], model, device="cpu")
            pos = np.stack([kg.train[rng.integers(0, len(kg.train), 128)]
                            for _ in range(args.kge_steps)])
            neg = np.stack([corrupt_triples(rng, p, kg.num_entities) for p in pos])
            t0 = time.time()
            res = run(sharded_party, args.world, model, 0.3, params, pos, neg, tag=f"kge-{name}")
            moved = res[0]["traffic"]["bytes"] / args.kge_steps
            print(f"{name}: sharded KGE {args.kge_steps} steps over {args.world} ranks, "
                  f"loss={res[0]['losses'][-1]:.3f} ({time.time() - t0:.1f}s; rank 0 moved "
                  f"{moved:.0f} bytes a step, holds {res[0]['shard_bytes']} bytes)")
            tables[name] = res[0]["params"]

        # ---- PPAT between the two parties (client rank 0 <-> host rank 1) ----
        # the aligned rows each owner exports from its table
        x = tables["A"]["ent"][ia]
        y = tables["B"]["ent"][ib]
        cfg = PPATConfig(steps=args.rounds, seed=0)
        state = init_distributed_ppat(torch.Generator().manual_seed(0), dim, cfg)
        noise = laplace_noise(torch.Generator().manual_seed(1), (cfg.steps, 2, cfg.batch))
        xbs = np.stack([x[rng.integers(0, len(x), cfg.batch)] for _ in range(cfg.steps)])
        ybs = np.stack([y[rng.integers(0, len(y), cfg.batch)] for _ in range(cfg.steps)])
        t0 = time.time()
        client, host = run(exchange_party, 2, cfg, state, xbs, ybs, noise, tag="ppat")
    print(f"PPAT (two processes, pipe exchange): {cfg.steps} rounds in {time.time() - t0:.1f}s; "
          f"host gen_loss={host['history']['gen_loss'][-1]:.3f}")

    x_t, y_t = torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)
    synth = x_t @ torch.from_numpy(client["state"]["w"]).to(dev)
    r = procrustes(synth, y_t)  # host-local refinement
    acc = csls_retrieval_acc(synth @ r, y_t)
    print(f"CSLS retrieval of refined DP embeddings vs host: {acc * 100:.1f}%")
    sent = [p["traffic"] for p in (client, host)]
    print(f"pipe: {sum(t['tensors'] for t in sent) // cfg.steps} tensors, "
          f"{sum(t['bytes'] for t in sent) // cfg.steps} bytes a round "
          f"({' + '.join(f'{k} x{v}' for t in sent for k, v in t['shapes'].items())})")


if __name__ == "__main__":
    main()
