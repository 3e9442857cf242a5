"""Serving entry point: batched prefill + token-by-token decode — the port
of the JAX package's ``launch/serve.py``, with the same flags plus
``--device``.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \\
      --batch 4 --prompt-len 32 --gen 16            # on the current CUDA card
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b --reduced \\
      --device cpu

Every card serves here: an encoder-decoder card (whisper) gets zero frames
(B, ``encoder_seq``, d) and a VLM card (internvl) zero patches (B,
``num_patches``, d) in front of the prompt, as the JAX script passes them;
``generate`` takes seeded ones too.

The model runs at fp32 with random weights drawn from ``--seed``. Greedy
decoding (``--temperature 0``) gives the tokens the JAX package's
``launch/serve.py`` would from the same weights; sampling draws from a
``torch.Generator``, so it does not.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.configs import get_config, reduced as make_reduced
from repro_torch.data.pipeline import SyntheticTextDataset
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.models.model import init_params


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _pick(logits: torch.Tensor, temperature: float,
          generator: Optional[torch.Generator]) -> torch.Tensor:
    """(B, V) logits → (B, 1) next tokens: argmax, or a draw at ``temperature``."""
    if temperature > 0:
        probs = torch.softmax(logits.float() / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)
    return torch.argmax(logits, dim=-1, keepdim=True)


def generate(model, prompts: np.ndarray, gen: int, *, temperature: float = 0.0,
             generator: Optional[torch.Generator] = None,
             frames: Optional[torch.Tensor] = None,
             patches: Optional[torch.Tensor] = None) -> Tuple[np.ndarray, dict]:
    """Batched prefill of ``prompts`` (B, P) — against the encoder's output
    of ``frames``, behind ``patches`` — then ``gen − 1`` decode steps, offset
    by the patches → (tokens (B, gen), host-clock seconds of the prefill and
    the decode, each ended by a synchronise). ``frames`` and ``patches``
    default to zeros where the card takes them."""
    cfg = model.cfg
    dev = model.device
    b, p = prompts.shape
    if cfg.encoder_layers and frames is None:
        frames = torch.zeros(b, cfg.encoder_seq, cfg.d_model, device=dev)
    offset = 0
    if cfg.num_patches:
        if patches is None:
            patches = torch.zeros(b, cfg.num_patches, cfg.d_model, device=dev)
        offset = patches.shape[1]
    cache = model.init_cache(b, p + gen + offset)
    tokens = torch.as_tensor(prompts, device=dev, dtype=torch.long)
    _sync(dev)
    t0 = time.perf_counter()
    logits = model.prefill(tokens, cache, frames=frames, patches=patches)
    tok = _pick(logits[:, -1], temperature, generator)
    _sync(dev)
    t_prefill = time.perf_counter() - t0
    out = [tok]
    t0 = time.perf_counter()
    for i in range(gen - 1):
        logits = model.decode_step(tok, cache, offset + p + i)
        tok = _pick(logits[:, -1], temperature, generator)
        out.append(tok)
    generated = torch.cat(out, dim=1).cpu().numpy()
    _sync(dev)
    t_decode = time.perf_counter() - t0
    return generated, {"prefill_s": t_prefill, "decode_s": t_decode}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA card)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = make_reduced(cfg)
    cfg = cfg.replace(dtype="float32")
    dev = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False

    model = init_params(cfg, torch.Generator(device=dev).manual_seed(args.seed), device=dev)
    ds = SyntheticTextDataset(vocab_size=cfg.vocab_size, seed=args.seed)
    prompts = np.stack([ds.tokens(args.prompt_len, seed=s) for s in range(args.batch)])
    sampler = torch.Generator(device=dev).manual_seed(args.seed + 1)
    gen, t = generate(model, prompts, args.gen, temperature=args.temperature, generator=sampler)
    print(f"arch={cfg.name} batch={args.batch} prompt={args.prompt_len} gen={args.gen} "
          f"device={dev}")
    print(f"prefill {t['prefill_s'] * 1e3:.1f} ms; decode "
          f"{t['decode_s'] * 1e3 / max(1, args.gen - 1):.1f} ms/token")
    for i in range(min(2, args.batch)):
        print(f"  seq{i}: prompt={prompts[i][:8].tolist()}… generated={gen[i].tolist()}")


if __name__ == "__main__":
    main()
