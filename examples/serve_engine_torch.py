"""Serving example on the PyTorch port: the continuous-batching engine over a
reduced card.

Submits a burst of ragged-length requests into a small slot pool and drains
them, printing per-request latency — the counterpart of
``examples/serve_engine.py`` on ``repro_torch``. Any decoder card serves
(MoE and VLM included); the encoder-decoder card (whisper) serves through
``repro_torch.launch.serve`` instead.

  PYTHONPATH=src python examples/serve_engine_torch.py                 # on the CUDA card
  PYTHONPATH=src python examples/serve_engine_torch.py --arch mixtral-8x22b --device cpu
"""
import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.kernels.dispatch import resolve_device  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.serving import ServingEngine  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--slots", type=int, default=3)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA card)")
    args = ap.parse_args(argv)

    cfg = reduced(get_config(args.arch)).replace(dtype="float32")
    dev = resolve_device(args.device)
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    eng = ServingEngine(model, cfg, max_batch=args.slots, max_len=128, device=dev)

    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    for i in range(args.requests):
        prompt = rng.integers(0, cfg.vocab_size, 8 + 4 * (i % 3)).astype(np.int32)
        eng.submit(prompt, max_new_tokens=8 + (i % 2) * 4)
    done = eng.run_until_drained()
    wall = time.perf_counter() - t0

    print(f"arch={cfg.name} slots={args.slots} requests={args.requests} device={dev}")
    for r in sorted(done, key=lambda r: r.rid):
        lat = (r.finished_at - r.submitted_at) * 1e3
        print(f"  req{r.rid}: prompt={len(r.prompt):3d} gen={len(r.generated):3d} "
              f"latency={lat:7.1f} ms  tokens={r.generated[:6]}…")
    total_tokens = sum(len(r.generated) for r in done)
    print(f"drained {total_tokens} tokens in {wall:.2f}s "
          f"({total_tokens / wall:.1f} tok/s aggregate)")
    return done


if __name__ == "__main__":
    main()
