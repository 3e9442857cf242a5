"""FKGE on the LM substrate, on the PyTorch port — the counterpart of
``examples/federated_lm_embeddings.py``.

Two parties train reduced LMs from different corpora over one vocabulary
(aligned token ids play the paper's aligned entities). They run PPAT over
the shared rows of their token-embedding tables; the host aggregates the
DP-synthesized rows, ``0.5 · (y + refined)``, retrains briefly, and keeps
the result if its eval loss did not rise, else backtracks to its model as
it was before the aggregation (the paper's rule). The technique of the paper, with the "KG embedding
table" become the "token embedding table".

  PYTHONPATH=src python examples/federated_lm_embeddings_torch.py          # on the CUDA card
  PYTHONPATH=src python examples/federated_lm_embeddings_torch.py --device cpu
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch.configs import TrainConfig, get_config, reduced  # noqa: E402
from repro_torch.core.alignment import procrustes  # noqa: E402
from repro_torch.core.ppat import PPATConfig, train_ppat  # noqa: E402
from repro_torch.data.pipeline import SyntheticTextDataset, make_batches  # noqa: E402
from repro_torch.kernels.dispatch import resolve_device  # noqa: E402
from repro_torch.launch.train import to_device  # noqa: E402
from repro_torch.train import init_train_state, lm_loss, make_train_step  # noqa: E402

BATCH, SEQ = 8, 64


def train_party(cfg, seed, steps, dev, batch=BATCH, seq=SEQ):
    """A party's model trained ``steps`` steps on its own corpus (seed)."""
    tcfg = TrainConfig(global_batch=batch, seq_len=seq, learning_rate=3e-3,
                       warmup_steps=5, total_steps=steps)
    state = init_train_state(torch.Generator(device=dev).manual_seed(seed), cfg, device=dev)
    step = make_train_step(cfg, tcfg)
    ds = SyntheticTextDataset(vocab_size=cfg.vocab_size, seed=seed)
    loss = None
    for b in make_batches(ds, batch=batch, seq_len=seq, steps=steps, seed=seed):
        state, m = step(state, to_device(b, cfg, dev))
        loss = float(m["loss"])
    return state, step, ds, loss


@torch.no_grad()
def eval_loss(cfg, model, ds, dev, seed=99, batches=5, batch=BATCH, seq=SEQ):
    total = 0.0
    for b in make_batches(ds, batch=batch, seq_len=seq, steps=batches, seed=seed):
        b = to_device(b, cfg, dev)
        total += float(lm_loss(model, cfg, b["tokens"], b["labels"])[0])
    return total / batches


@torch.no_grad()
def aggregate(table: torch.Tensor, idx: torch.Tensor, y: torch.Tensor,
              refined: torch.Tensor) -> None:
    """The host's KGEmb update of its aligned rows, in place:
    ``table[idx] = 0.5 · (y + refined)`` in the table's dtype."""
    table[idx] = (0.5 * (y + refined)).to(table.dtype)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--ppat-steps", type=int, default=150)
    ap.add_argument("--retrain-steps", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA card)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = reduced(get_config(args.arch)).replace(dtype="float32")
    print(f"arch family: {cfg.name} (reduced: {cfg.num_layers}L d={cfg.d_model}) on {dev}")

    # party A and party B: the same vocabulary (fully aligned ids), different data
    state_a, _, _, loss_a = train_party(cfg, 0, args.steps, dev)
    state_b, step_b, ds_b, loss_b = train_party(cfg, 1, args.steps, dev)
    print(f"local training: A loss={loss_a:.3f}  B loss={loss_b:.3f}")

    # aligned rows: the shared head of the vocabulary (the most frequent tokens)
    n_aligned = min(256, cfg.vocab_size)
    idx = torch.arange(n_aligned, device=dev)
    x = state_a.model.embed.weight[idx].detach().float()  # client: A
    y = state_b.model.embed.weight[idx].detach().float()  # host:   B
    client, host, hist = train_ppat(x, y, PPATConfig(steps=args.ppat_steps, seed=0))
    synth = client.generate(x)
    refined = synth @ procrustes(synth, y)  # host-local MUSE refinement (DP post-processing)
    print(f"PPAT done: ε̂={hist['epsilon']:.2f} (λ=0.05, δ=1e-5; only G(X) and ∂L/∂G(X) "
          "crossed the boundary)")

    table = state_b.model.embed.weight
    before = eval_loss(cfg, state_b.model, ds_b, dev)
    snapshot = {k: v.clone() for k, v in state_b.model.state_dict().items()}
    aggregate(table, idx, y, refined)
    # KGEmb-Update: brief local retraining after aggregation
    state = state_b
    for b in make_batches(ds_b, batch=BATCH, seq_len=SEQ, steps=args.retrain_steps, seed=42):
        state, _ = step_b(state, to_device(b, cfg, dev))
    after = eval_loss(cfg, state.model, ds_b, dev)
    kept = after <= before
    if not kept:
        state.model.load_state_dict(snapshot)
    verdict = "kept" if kept else "backtracked (paper's rule)"
    print(f"host eval loss: {before:.3f} → {after:.3f} → {verdict}")
    return {"loss_a": loss_a, "loss_b": loss_b, "epsilon": hist["epsilon"], "before": before,
            "after": after, "kept": kept, "x": x, "y": y, "synth": synth, "refined": refined,
            "idx": idx}


if __name__ == "__main__":
    main()
