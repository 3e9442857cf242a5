"""Quickstart on the PyTorch port: federate two knowledge graphs with FKGE.

``examples/quickstart.py`` on ``repro_torch``: the same two synthetic KGs
sharing aligned entities, trained locally (TransE), then federated by the
scheduler (its batched tick engine) for three ticks, printing the triple-classification scores
before and after and the DP budget ε̂ of each handshake. Runs on the current
CUDA card, or on the CPU with ``--device cpu``.

  PYTHONPATH=src python examples/quickstart_torch.py              # the card
  PYTHONPATH=src python examples/quickstart_torch.py --device cpu
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core.federation import FederationScheduler  # noqa: E402
from repro_torch.core.ppat import PPATConfig  # noqa: E402
from repro_torch.kge.data import synthesize_universe  # noqa: E402

UNIVERSE = dict(
    seed=0,
    scale=1 / 400,
    kg_stats=[("Books", 12, 100000, 340000), ("Movies", 10, 80000, 270000)],
    alignments=[("Books", "Movies", 30000)],
)
DIM = 32


def build(device=None, *, ppat_steps=150, local_epochs=150, update_epochs=40,
          draws=None) -> FederationScheduler:
    """The quickstart's scheduler over its two KGs, on ``device``."""
    return FederationScheduler(
        synthesize_universe(**UNIVERSE),
        dim=DIM,
        ppat_cfg=PPATConfig(steps=ppat_steps, seed=0),
        local_epochs=local_epochs,
        update_epochs=update_epochs,
        seed=0,
        device=device,
        draws=draws,
    )


def report(fed: FederationScheduler, ticks: int = 3) -> None:
    """Train locally, federate for ``ticks`` ticks, and print what happened."""
    for name, kg in fed.kgs.items():
        print(f"{name}: {kg.num_entities} entities, {len(kg.triples)} triples")
    init = fed.initial_training()
    print("\nafter local training :", {k: round(v, 3) for k, v in init.items()})

    final = fed.run(max_ticks=ticks)
    print("after federation     :", {k: round(v, 3) for k, v in final.items()})

    for ev in fed.events:
        if ev.kind == "ppat":
            arrow = "✓ kept" if ev.accepted else "✗ backtracked"
            print(
                f"  PPAT({ev.client}→{ev.host}): {ev.score_before:.3f} → "
                f"{ev.score_after:.3f} {arrow}  (ε̂={ev.epsilon:.1f})"
            )
    print(f"\nprivacy: per-handshake ε̂ from the moments accountant above; "
          f"paper setting λ={fed.ppat_cfg.lam}, δ={fed.ppat_cfg.delta}")


def main(device=None, *, ticks: int = 3, **cut) -> FederationScheduler:
    """The quickstart on ``device``; ``cut`` may shorten ``build``'s
    schedule (``ppat_steps``, ``local_epochs``, ``update_epochs``)."""
    fed = build(device, **cut)
    report(fed, ticks)
    return fed


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA card)")
    main(ap.parse_args().device)
