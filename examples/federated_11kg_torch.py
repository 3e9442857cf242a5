"""The paper's full experiment on the PyTorch port, scaled: 11 KGs matched
to Tab. 2's statistics with Tab. 3's alignments, mixed base models
(TransE/H/R/D as in Fig. 5), and asynchronous federation with handshake,
backtrack and broadcast through the batched tick engine.

``examples/federated_11kg.py`` on ``repro_torch``, with the same arguments.
Runs on the current CUDA card (each tick entry a replay of a captured CUDA
graph; the TransH/R/D retrains run eagerly beside them), or on the CPU with
``--device cpu``. ``--tick-impl reference`` runs the serial engine instead.

  PYTHONPATH=src python examples/federated_11kg_torch.py [--ticks 3] [--scale 400]
  PYTHONPATH=src python examples/federated_11kg_torch.py --device cpu
"""
import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core.federation import FederationScheduler  # noqa: E402
from repro_torch.core.ppat import PPATConfig  # noqa: E402
from repro_torch.kge.data import synthesize_universe  # noqa: E402

#: Fig. 5: each KG picks a translation-family base model, in turn
FAMILIES = ("transe", "transh", "transr", "transd")


def build(device=None, *, scale: float = 400.0, dim: int = 32, ppat_steps: int = 100,
          local_epochs: int = 100, update_epochs: int = 30, **kw) -> FederationScheduler:
    """The experiment's scheduler over the 11 KGs at 1/``scale`` of Tab. 2,
    on ``device``; ``kw`` goes to ``FederationScheduler`` (``tick_impl``,
    ``draws``, ...)."""
    kgs = synthesize_universe(seed=0, scale=1 / scale)
    families = {name: FAMILIES[i % len(FAMILIES)] for i, name in enumerate(kgs)}
    return FederationScheduler(
        kgs, families=families, dim=dim, ppat_cfg=PPATConfig(steps=ppat_steps, seed=0),
        local_epochs=local_epochs, update_epochs=update_epochs, seed=0, device=device, **kw)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ticks", type=int, default=3)
    ap.add_argument("--scale", type=float, default=400.0, help="1/scale of Tab. 2")
    ap.add_argument("--dim", type=int, default=32)
    ap.add_argument("--ppat-steps", type=int, default=100)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA card)")
    ap.add_argument("--tick-impl", default=None, choices=("batched", "reference"),
                    help="tick engine (default: batched)")
    args = ap.parse_args()

    t0 = time.time()
    fed = build(args.device, scale=args.scale, dim=args.dim, ppat_steps=args.ppat_steps,
                tick_impl=args.tick_impl)
    kgs = fed.kgs
    print(f"generated {len(kgs)} KGs in {time.time()-t0:.1f}s "
          f"({sum(len(k.triples) for k in kgs.values())} triples total) on {fed.device}")
    print("base models:", {n: tr.model.family for n, tr in fed.trainers.items()})

    init = fed.initial_training()
    print("\ninitial  :", {k: round(v, 3) for k, v in sorted(init.items())})
    final = fed.run(max_ticks=args.ticks)
    print("federated:", {k: round(v, 3) for k, v in sorted(final.items())})

    gains = {k: final[k] - init[k] for k in final}
    print("gains    :", {k: f"{v*100:+.1f}%" for k, v in sorted(gains.items())})
    n_acc = sum(1 for e in fed.events if e.kind == "ppat" and e.accepted)
    n_all = sum(1 for e in fed.events if e.kind == "ppat")
    st = fed._tick_engine.stats
    print(f"\n{n_all} handshakes, {n_acc} accepted, "
          f"{len([e for e in fed.events if e.kind == 'self-train'])} self-train rounds, "
          f"max ε̂ = {max(fed.epsilons, default=float('nan')):.2f}, "
          f"total {time.time()-t0:.0f}s")
    print(f"tick engine: {st['entries']} entries, {st['captured']} graphs captured, "
          f"{st['replays']} replays, {st['eager_segments']} eager segments")


if __name__ == "__main__":
    main()
