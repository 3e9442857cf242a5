"""End-to-end example on the PyTorch port: train a small dense LM for a few
hundred steps — the counterpart of ``examples/train_lm.py``, with its model.

The real qwen3-0.6b layer stack cut to the reference example's width (8
layers, d = 512, GQA 8/4, vocabulary 32,768: 48.2M parameters by
``param_count`` with the tied embeddings; the reference's docstring calls it
~100M), fp32, the synthetic corpus,
AdamW + cosine, ``ce_chunk=1024`` (the chunked CE takes over at sequences
longer than 1,024 tokens), and, with ``--checkpoint``, the parameters saved
in the reference's layout.

  PYTHONPATH=src python examples/train_lm_torch.py [--steps 300]        # on the CUDA card
  PYTHONPATH=src python examples/train_lm_torch.py --steps 4 --device cpu
"""
import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch.checkpoint import save_lm  # noqa: E402
from repro_torch.configs import TrainConfig, get_config  # noqa: E402
from repro_torch.data.pipeline import SyntheticTextDataset, make_batches  # noqa: E402
from repro_torch.kernels.dispatch import resolve_device  # noqa: E402
from repro_torch.launch.train import to_device  # noqa: E402
from repro_torch.train import init_train_state, make_train_step  # noqa: E402


def config():
    """The reference example's qwen3-family model."""
    return get_config("qwen3-0.6b").replace(
        num_layers=8, d_model=512, num_heads=8, num_kv_heads=4, head_dim=64,
        d_ff=2048, vocab_size=32768, dtype="float32")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--log-every", type=int, default=20)
    ap.add_argument("--checkpoint", default=None,
                    help="where to save the parameters (default: not saved)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA card)")
    args = ap.parse_args(argv)

    cfg = config()
    dev = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"model: {cfg.num_layers}L d={cfg.d_model} vocab={cfg.vocab_size} "
          f"→ {cfg.param_count() / 1e6:.1f}M params on {dev}")
    tcfg = TrainConfig(global_batch=args.batch, seq_len=args.seq_len, microbatches=1,
                       ce_chunk=1024, learning_rate=1e-3, warmup_steps=20,
                       total_steps=args.steps)
    state = init_train_state(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
    step = make_train_step(cfg, tcfg)
    ds = SyntheticTextDataset(vocab_size=cfg.vocab_size, seed=0)

    t0 = time.time()
    first = loss = None
    rates = []
    for i, batch in enumerate(make_batches(ds, batch=args.batch, seq_len=args.seq_len,
                                           steps=args.steps)):
        state, m = step(state, to_device(batch, cfg, dev))
        loss = float(m["loss"])
        first = first if first is not None else loss
        if (i + 1) % args.log_every == 0:
            rates.append(args.batch * args.seq_len * args.log_every / (time.time() - t0))
            t0 = time.time()
            print(f"step {i + 1:4d} loss={loss:.4f} lr={float(m['lr']):.2e} "
                  f"tok/s={rates[-1]:,.0f}")
    print(f"\nloss: {first:.3f} → {loss:.3f} over {args.steps} steps")
    if args.checkpoint:
        save_lm(args.checkpoint, cfg, state.model,
                metadata={"arch": "qwen3-100m", "steps": args.steps})
        print(f"checkpoint: {args.checkpoint}")
    return {"first": first, "last": loss, "tokens_per_s": rates}


if __name__ == "__main__":
    main()
