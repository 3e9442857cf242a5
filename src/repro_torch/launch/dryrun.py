"""Dry-run of every (arch × input shape × mesh) on a fake process group —
the port of the JAX package's ``launch/dryrun.py``, which lowers and
compiles each step on 512 placeholder host devices.

Here one process stands for rank 0 of a fake group of 256 (one pod,
(16, 16) ('data', 'model')) or 512 ranks (two pods): the ``"fake"``
backend sends nothing, and under ``FakeTensorMode`` every tensor is
shapes only, so nothing is allocated on any device. The step runs as
written, on DTensor arguments split by the spec rules
(``launch.workloads.make_workload``); attention's cores and the MoE's
all-to-all run on the rank's local shards. ``utils.collectives.RankAccounting``
counts what the rank runs: its collectives' bytes, its FLOPs, the bytes
its operators touch and its live-tensor peak; ``utils.roofline`` prices
them with H100 data-sheet rates.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-0.6b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--json out.json]
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
import traceback
from typing import Any, Dict

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.configs.base import INPUT_SHAPES
from repro_torch.configs.registry import ARCHS, get_config
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.workloads import make_workload, supported
from repro_torch.sharding import context as shard_ctx
from repro_torch.utils.collectives import RankAccounting, local_bytes
from repro_torch.utils.roofline import roofline_terms


@contextlib.contextmanager
def fake_group(world: int):
    """The default process group as rank 0 of a fake group of ``world``
    ranks, for the block's duration."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group already exists; the dry-run makes its own")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def dryrun_one(
    arch: str, shape_name: str, *, multi_pod: bool = False, verbose: bool = True
) -> Dict[str, Any]:
    cfg = get_config(arch)
    shape = next(s for s in INPUT_SHAPES if s.name == shape_name)
    ok, why = supported(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "status": "skipped", "why": why}

    with fake_group(512 if multi_pod else 256):
        mesh = make_production_mesh(multi_pod=multi_pod)  # outside FakeTensorMode: its
        n_chips = mesh.size()                             # rank table is real
        t0 = time.perf_counter()
        try:
            with FakeTensorMode():
                wl = make_workload(cfg, shape_name, mesh, multi_pod=multi_pod)
                arg_bytes = local_bytes(wl["args"])
                t_build = time.perf_counter() - t0
                t0 = time.perf_counter()
                grad = torch.enable_grad() if wl["kind"] == "train" else torch.no_grad()
                with grad, implicit_replication(), RankAccounting() as acc:
                    out = wl["fn"](*wl["args"])
                t_run = time.perf_counter() - t0
                out_bytes = local_bytes(out)
        finally:
            shard_ctx.set_mesh(None)

    res = {
        "arch": arch,
        "shape": shape_name,
        "kind": wl["kind"],
        "status": "ok",
        "chips": int(n_chips),
        "multi_pod": multi_pod,
        "build_s": round(t_build, 1),
        "run_s": round(t_run, 1),
        "memory": {
            "argument_bytes_per_device": arg_bytes,
            "output_bytes_per_device": out_bytes,
            "temp_bytes_per_device": acc.peak_new_bytes,
            "peak_bytes_per_device": arg_bytes + acc.peak_new_bytes,
        },
        "cost": {"flops": float(acc.flops), "bytes_accessed": float(acc.bytes_accessed)},
        "collectives": acc.collectives(),
    }
    res["roofline"] = roofline_terms(cfg, shape, res, chips=n_chips)
    if verbose:
        m = res["memory"]
        r = res["roofline"]
        print(
            f"[ok] {arch} × {shape_name} ({'2-pod' if multi_pod else '1-pod'}, "
            f"{n_chips} ranks) run={t_run:.1f}s "
            f"peak/rank={m['peak_bytes_per_device']/2**30:.2f}GiB "
            f"args/rank={m['argument_bytes_per_device']/2**30:.2f}GiB "
            f"compute={r['compute_s']:.2e}s memory={r['memory_s']:.2e}s "
            f"collective={r['collective_s']:.2e}s → {r['bottleneck']}"
        )
        sys.stdout.flush()
    return res


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--json", default=None)
    args = ap.parse_args()

    combos = []
    archs = sorted(ARCHS) if (args.all or not args.arch) else [args.arch]
    shapes = [s.name for s in INPUT_SHAPES] if (args.all or not args.shape) else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    for mp in meshes:
        for a in archs:
            for s in shapes:
                combos.append((a, s, mp))

    results = []
    for a, s, mp in combos:
        try:
            results.append(dryrun_one(a, s, multi_pod=mp))
        except Exception as e:  # a failure here is a bug in the system
            traceback.print_exc()
            results.append(
                {"arch": a, "shape": s, "multi_pod": mp, "status": "error",
                 "error": f"{type(e).__name__}: {e}"}
            )
        if results[-1]["status"] == "skipped":
            print(f"[skip] {a} × {s}: {results[-1]['why']}")

    n_ok = sum(r["status"] == "ok" for r in results)
    n_skip = sum(r["status"] == "skipped" for r in results)
    n_err = sum(r["status"] == "error" for r in results)
    print(f"\ndry-run: {n_ok} ok, {n_skip} skipped (documented), {n_err} errors")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=1)
        print(f"wrote {args.json}")
    if n_err:
        sys.exit(1)


if __name__ == "__main__":
    main()
