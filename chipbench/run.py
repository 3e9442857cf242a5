#!/usr/bin/env python3
"""Run one cell of ``BENCHMARK.json`` on the CUDA card of this machine.

    python3 chipbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The cell names a configuration
(``chipbench/configs/<config>.json``) and a traffic mix
(``chipbench/traffic/<mix>.json``); the mix names its driver
(``chipbench/drivers/<driver>.py``), and the cell's limits of ``correct`` are
``chipbench/limits/<cell>.json``. Set-up (``setup_s``: from the start of this
script to the first timed operation) builds and warms everything; the window
then runs for ``--seconds``; after it the program's state is freed and the
driver's plain reference decides ``correct``.

``--trace 0`` prints the cell's end-to-end metrics; ``--trace 1`` runs the
window under ``torch.profiler`` and prints the per-layer metrics, each read
by ``chipbench/metrics/<metric>.py``, with the device's busy time and the
breakdown. The last line of standard output is the result; the numbers
compared, each beside its limit, are the last lines of standard error and
the last key of the result. Without a CUDA card (or with fewer than the cell
asks for) it prints no result and exits 2; it exits 3 if JAX or the JAX
package was loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
#: top-level module names that must not be loaded: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _env() -> None:
    """Kernel caches at fixed paths inside the checkout (the port builds its
    CUDA libraries into ``build/kernels/`` there itself); no library loads
    JAX behind the port's back."""
    build = ROOT / "build"
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(build / "torch_extensions"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def cell_metrics(bench: dict, cell: str) -> list:
    """The cell's per-layer metrics: those whose ``workloads`` list it."""
    return [m for m in bench["per_layer"] if cell in m["workloads"]]


def cell_metrics_e2e(bench: dict, cell: str) -> list:
    """The cell's end-to-end metrics: those that list it or list no cell."""
    return [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", default="",
                    help="put a control in the program's place when deciding correct "
                         "(the driver's names, e.g. bf16); for the control tests only")
    return ap.parse_args(argv)


def build_cell(args, bench: dict, device, overrides=None):
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        raise SystemExit(f"unknown workload {args.workload!r}; cells: {sorted(cells)}")
    w = cells[args.workload]
    cfg = load_json(HERE / "configs" / f"{w['config']}.json")
    mix = load_json(HERE / "traffic" / f"{w['traffic']}.json")
    limits = load_json(HERE / "limits" / f"{w['name']}.json")
    if overrides:
        cfg = overrides.get("config", lambda c: c)(cfg)
        mix = overrides.get("traffic", lambda m: m)(mix)
    return SimpleNamespace(name=w["name"], chips=w["chips"], cfg=cfg, mix=mix, limits=limits,
                           seed=args.seed, device=device, trace=bool(args.trace))


def run(argv=None, *, device=None, overrides=None, bench_path=None, out=None) -> int:
    """The whole run. ``device``, ``overrides`` (callables over the config
    and the mix) and ``bench_path`` let the CPU tests drive it at a tiny
    size; the command line never sets them."""
    args = parse(argv)
    _env()
    import torch

    bench = load_json(Path(bench_path) if bench_path else ROOT / "BENCHMARK.json")
    chips = {w["name"]: w["chips"] for w in bench["workloads"]}.get(args.workload, 1)
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            n = torch.cuda.device_count() if torch.cuda.is_available() else 0
            print(f"chipbench: the cell needs {chips} CUDA card(s), this machine has {n}",
                  file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
    device = torch.device(device)
    cell = build_cell(args, bench, device, overrides)
    driver = load_module(HERE / "drivers" / f"{cell.mix['driver']}.py",
                         f"chipbench_driver_{cell.mix['driver']}")
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)

    st = driver.setup(cell)
    if cuda:
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - T_START

    prof = None
    if cell.trace:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU]
        prof = profile(activities=acts)
        prof.__enter__()
    win = driver.window(st, args.seconds)
    if cuda:
        torch.cuda.synchronize(device)
    if prof is not None:
        prof.__exit__(None, None, None)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0

    driver.free(st)
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    checks = driver.check(st, args.control) if args.control else driver.check(st)
    print(f"chipbench: the reference took {time.perf_counter() - t_check:.1f} s", file=sys.stderr)

    from chipbench import peaks as peaks_mod

    card = torch.cuda.get_device_name(device) if cuda else "cpu"
    limit = peaks_mod.power_limit() if cuda else "not read"
    dev = {"platform": "gpu" if cuda else "cpu", "kind": card, "count": cell.chips,
           "memory_peak_bytes": int(peak), "power_limit": limit}
    result = {"correct": None, "attempted": int(win["attempted"]), "failed": int(win["failed"])}
    metrics = {}
    if not cell.trace:
        for m in cell_metrics_e2e(bench, cell.name):
            value = setup_s if m["name"] == "setup_s" else win["metrics"].get(m["name"])
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        from chipbench import trace as tr

        ks = tr.kernels(prof) if cuda else []
        busy = tr.busy_union(ks)
        dev["busy_s"], dev["window_s"] = busy, win["window_s"]
        ctx = SimpleNamespace(kernels=ks, busy_s=busy, window_s=win["window_s"],
                              counters=win.get("counters", {}), launches=driver.launches(st),
                              peaks=peaks_mod.H100_SXM, card=card, cell=cell)
        for m in cell_metrics(bench, cell.name):
            reader = load_module(HERE / "metrics" / f"{m['name']}.py",
                                 "chipbench_metric_" + m["name"].replace(".", "_").replace("-", "_"))
            value = reader.read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        result["breakdown"] = tr.breakdown(ks)
        print(f"chipbench: per-layer shares on {card}, power limit {limit}", file=sys.stderr)

    found = forbidden_modules()
    if found:
        print(f"chipbench: loaded {found} (JAX or the JAX package); no result", file=sys.stderr)
        return 3
    correct = all(v <= lim for _, v, lim in checks)
    result["correct"] = bool(correct) and int(win["failed"]) == 0
    result["metrics"] = metrics
    result["device"] = dev
    result["checks"] = {n: {"value": float(v), "limit": float(lim)} for n, v, lim in checks}
    for n, v, lim in checks:
        print(f"check {n}: {float(v)!r} limit {float(lim)!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), file=out or sys.stdout, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(run())
