"""End-to-end LM training entry point — the port of the JAX package's
``launch/train.py``, with the same flags plus ``--device``.

Builds the model from ``--arch`` (optionally the reduced variant) with
random weights from ``--seed``, the synthetic data pipeline, AdamW + the
cosine schedule, and writes the parameters at the end (``--checkpoint``) in
the reference's layout, which ``repro.checkpoint.load_checkpoint`` reads.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
      --steps 200 --batch 8 --seq-len 128                # on the current CUDA card
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b --reduced \\
      --device cpu

An encoder-decoder card (whisper) trains against seeded N(0, 1) frames
(B, ``encoder_seq``, d), a VLM card (internvl) behind seeded N(0, 1)
patches (B, ``num_patches``, d): the reference's stubs, drawn from
``np.random.default_rng(seed)`` and ``(seed + 1)`` and the same every step.
The batches are the reference's (``make_batches``), so both scripts see the
same tokens; the weights differ, since ``jax.random`` cannot be replayed
(carry them across with ``train.train_state_from_numpy``).
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, Iterator

import numpy as np
import torch

from repro_torch.checkpoint import save_lm
from repro_torch.configs import TrainConfig, get_config, reduced as make_reduced
from repro_torch.data.pipeline import SyntheticTextDataset, make_batches
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.models.layers import dtype_of
from repro_torch.train.step import init_train_state, make_train_step


def extras(cfg, batch: int, seed: int) -> Dict[str, np.ndarray]:
    """The stubbed frontends of ``cfg``: frames (encoder-decoder) from
    ``default_rng(seed)``, patches (VLM) from ``default_rng(seed + 1)``,
    N(0, 1) float32 — the reference's draws."""
    out = {}
    if cfg.encoder_layers:
        rng = np.random.default_rng(seed)
        out["frames"] = rng.normal(0, 1, (batch, cfg.encoder_seq, cfg.d_model))
    if cfg.num_patches:
        rng = np.random.default_rng(seed + 1)
        out["patches"] = rng.normal(0, 1, (batch, cfg.num_patches, cfg.d_model))
    return out


def batches(cfg, *, batch: int, seq_len: int, steps: int,
            seed: int) -> Iterator[Dict[str, np.ndarray]]:
    """The reference script's host batches: ``make_batches`` over
    ``SyntheticTextDataset(vocab_size, seed)``, with ``extras``."""
    ds = SyntheticTextDataset(vocab_size=cfg.vocab_size, seed=seed)
    for b in make_batches(ds, batch=batch, seq_len=seq_len, steps=steps):
        yield {**b, **extras(cfg, batch, seed)}


def to_device(batch: Dict[str, np.ndarray], cfg, dev: torch.device) -> Dict[str, torch.Tensor]:
    """Tokens and labels as int64, frames and patches in the model's dtype
    (cast from the float64 draws, as the reference's ``jnp.asarray(…, dtype)``)."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.asarray(v))
        if k in ("tokens", "labels"):
            out[k] = t.to(dev, torch.long)
        else:
            out[k] = t.to(dev, dtype_of(cfg))
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--reduced", action="store_true",
                    help="train the reduced smoke variant (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ce-chunk", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA card)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = make_reduced(cfg)
    cfg = cfg.replace(dtype=args.dtype)
    dev = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    tcfg = TrainConfig(
        global_batch=args.batch, seq_len=args.seq_len, microbatches=args.microbatches,
        ce_chunk=args.ce_chunk, learning_rate=args.lr,
        warmup_steps=max(1, args.steps // 20), total_steps=args.steps, seed=args.seed)
    print(f"arch={cfg.name} params≈{cfg.param_count() / 1e6:.1f}M "
          f"(active {cfg.active_param_count() / 1e6:.1f}M) dtype={cfg.dtype} device={dev}")

    state = init_train_state(torch.Generator(device=dev).manual_seed(args.seed), cfg,
                             device=dev)
    step = make_train_step(cfg, tcfg)
    t0 = time.perf_counter()
    losses, rates = [], []
    for i, b in enumerate(batches(cfg, batch=args.batch, seq_len=args.seq_len,
                                  steps=args.steps, seed=args.seed)):
        state, metrics = step(state, to_device(b, cfg, dev))
        losses.append(float(metrics["loss"]))
        if (i + 1) % args.log_every == 0:
            rates.append(args.batch * args.seq_len * args.log_every / (time.perf_counter() - t0))
            t0 = time.perf_counter()
            print(f"step {i + 1:5d} loss={losses[-1]:.4f} "
                  f"lr={float(metrics['lr']):.2e} tok/s={rates[-1]:,.0f}")
    print(f"final loss {losses[-1]:.4f} (first {losses[0]:.4f})")
    if args.checkpoint:
        save_lm(args.checkpoint, cfg, state.model,
                metadata={"arch": cfg.name, "steps": args.steps})
        print(f"saved {args.checkpoint}")
    return {"losses": losses, "tokens_per_s": rates, "state": state, "cfg": cfg}


if __name__ == "__main__":
    main()
