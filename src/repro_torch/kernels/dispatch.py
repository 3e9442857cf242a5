"""Device resolution and serving knobs.

There is no interpret flag and no rank-implementation knob: a kernel
wrapper launches its CUDA kernel for a CUDA tensor and takes its plain
PyTorch version for a CPU tensor, so the tensor's device decides.

``resolve_device`` is the one place an entry point turns ``device=None``
into a device: the current CUDA device when there is one, else an error —
a run never carries on quietly on the CPU. The serving knobs keep the JAX
package's environment variables (``REPRO_SERVE_IMPL``,
``REPRO_SERVE_REPLICAS``, ``REPRO_SERVE_FAULTS``), and the training step
keeps ``REPRO_TRAIN_IMPL`` (``resolve_train_impl``).

The federation knobs keep the JAX package's ``REPRO_TICK_*`` variables and
its rules: ``resolve_tick_impl`` picks the batched tick engine unless the
training step is the dense ``reference`` loop, ``resolve_tick_placement``
spreads entries over the owners' home devices when more than one CUDA
device is visible, ``resolve_tick_residency`` keeps results where they were
computed; the scheduling discipline, the fault layer and the adversary
resolve as in the JAX package. A bad value raises; nothing falls back
quietly.
"""
from __future__ import annotations

import os
from typing import List, Optional

import torch

_FALSY = ("0", "false", "no", "off")


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the current CUDA
    device. Raises when CUDA is asked for (explicitly or by default) and
    there is none. CUDA devices always come back with their index, so two
    resolved devices compare equal exactly when they are the same card."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run on the CPU"
            )
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but CUDA is not available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def cuda_devices() -> List[torch.device]:
    """Every visible CUDA device, indexed; raises when there is none."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError(
            "no CUDA device available; pass devices=[torch.device('cpu')] "
            "to serve from the CPU"
        )
    return [torch.device("cuda", i) for i in range(n)]


def _fault_spec(spec, env: str):
    """A fault layer's plan: an already-built object passes through, ``None``
    consults ``env``, and off-values resolve to ``None``."""
    if spec is not None and not isinstance(spec, str):
        return spec
    if spec is None:
        spec = os.environ.get(env, "").strip() or None
    if spec is None or spec.strip().lower() in _FALSY + ("", "none"):
        return None
    return spec


def resolve_serve_faults(spec=None):
    """The serving-tier fault-injection layer: ``None`` (off, the default)
    or a plan description the tier hands to ``ServeFaultPlan.parse``. An
    already-built plan passes through; ``None`` consults
    ``REPRO_SERVE_FAULTS``; off-values resolve to ``None``."""
    return _fault_spec(spec, "REPRO_SERVE_FAULTS")


def resolve_serve_impl(impl: Optional[str] = None) -> str:
    """``batched`` (the default: continuous batching into pow-2 padded
    query batches) or ``direct`` (one dispatch per request, the per-call
    baseline). ``REPRO_SERVE_IMPL`` overrides."""
    if impl is None:
        impl = os.environ.get("REPRO_SERVE_IMPL", "").strip().lower() or None
    if impl is None:
        impl = "batched"
    if impl not in ("batched", "direct"):
        raise ValueError(f"unknown serve impl {impl!r} (batched|direct)")
    return impl


def resolve_serve_replicas(n: Optional[int] = None) -> int:
    """How many table replicas the serving tier spreads over the cards.
    Explicit ``n`` wins, else ``REPRO_SERVE_REPLICAS``, else every visible
    CUDA device capped at 4 (at least 1). The tier clamps to the devices it
    was given, so over-asking is safe."""
    if n is None:
        raw = os.environ.get("REPRO_SERVE_REPLICAS", "").strip()
        n = int(raw) if raw else None
    if n is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        n = max(1, min(4, count))
    n = int(n)
    if n < 1:
        raise ValueError(f"serve replicas must be >= 1, got {n}")
    return n


#: families whose margin-SGD step the fused sparse_update kernel covers
SPARSE_KERNEL_FAMILIES = ("transe", "distmult")

#: the JAX package's names of the step implementations → the port's
TRAIN_IMPL_ALIASES = {"pallas": "fused", "xla": "sparse"}


def resolve_train_impl(impl: Optional[str] = None, family: str = "transe",
                       device=None) -> str:
    """Pick the training step implementation.

    ``fused`` (the JAX package's ``pallas``) — the fused sparse_update
    kernel: one launch per epoch on CUDA tables, its plain PyTorch version
    on CPU tables; TransE and DistMult only. ``sparse`` (JAX: ``xla``) —
    autograd over the gathered rows, every family. ``reference`` — the dense
    host-loop oracle. ``REPRO_TRAIN_IMPL`` overrides and takes either set of
    names. The default follows the device of the tables, as the JAX
    package's follows its backend (``pallas`` on a TPU, ``xla`` elsewhere):
    ``fused`` for TransE and DistMult on a CUDA ``device``, else ``sparse``.
    ``fused`` asked for a family it does not cover becomes ``sparse``, as in
    the JAX package."""
    if impl is None:
        impl = os.environ.get("REPRO_TRAIN_IMPL", "").strip().lower() or None
    if impl is None:
        on_card = device is not None and torch.device(device).type == "cuda"
        impl = "fused" if on_card and family in SPARSE_KERNEL_FAMILIES else "sparse"
    impl = TRAIN_IMPL_ALIASES.get(impl, impl)
    if impl not in ("fused", "sparse", "reference"):
        raise ValueError(f"unknown train impl {impl!r} "
                         "(fused|sparse|reference, or pallas|xla)")
    if impl == "fused" and family not in SPARSE_KERNEL_FAMILIES:
        impl = "sparse"  # the kernel does not cover this family's score math
    return impl


def resolve_tick_impl(impl: Optional[str] = None, family: str = "transe") -> str:
    """The federation tick engine: ``batched`` (``core.tick_engine``: every
    entry of a tick one program — on a CUDA device captured CUDA graphs,
    one per entry signature — with one host sync per tick) or ``reference``
    (the serial per-owner loop). ``REPRO_TICK_IMPL`` overrides; by default
    ``batched``, unless the training step resolves to the dense
    ``reference`` loop, which a tick program cannot hold."""
    if impl is None:
        impl = os.environ.get("REPRO_TICK_IMPL", "").strip().lower() or None
    if impl is None or impl == "auto":
        impl = "reference" if resolve_train_impl(None, family) == "reference" else "batched"
    if impl not in ("batched", "reference"):
        raise ValueError(f"unknown tick impl {impl!r} (batched|reference)")
    return impl


def resolve_tick_placement(placement: Optional[str] = None) -> str:
    """Where the batched engine runs a tick's entries: ``single`` (all on
    the scheduler's device) or ``sharded`` (each signature bucket over the
    owners' sticky home devices, ``core.distributed.OwnerPlacement``).
    ``auto`` (the default) is ``sharded`` exactly when more than one CUDA
    device is visible. ``REPRO_TICK_PLACEMENT`` overrides."""
    if placement is None:
        placement = os.environ.get("REPRO_TICK_PLACEMENT", "").strip().lower() or None
    if placement is None or placement == "auto":
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        placement = "sharded" if count > 1 else "single"
    if placement not in ("single", "sharded"):
        raise ValueError(f"unknown tick placement {placement!r} (auto|single|sharded)")
    return placement


def resolve_tick_residency(residency: Optional[str] = None) -> str:
    """What happens to a batched tick's results: ``resident`` (the default)
    leaves each owner's new tables on the device that computed them, its
    home under ``sharded``; ``normalize`` moves them back to the scheduler's
    device. ``REPRO_TICK_RESIDENCY`` overrides."""
    if residency is None:
        residency = os.environ.get("REPRO_TICK_RESIDENCY", "").strip().lower() or None
    if residency is None or residency == "auto":
        residency = "resident"
    if residency not in ("resident", "normalize"):
        raise ValueError(f"unknown tick residency {residency!r} (auto|resident|normalize)")
    return residency


def resolve_tick_sync(sync: Optional[str] = None) -> str:
    """The scheduling discipline: ``barrier`` (the default: lockstep ticks)
    or ``stream`` (dependency-level streaming passes with a bounded-staleness
    gate; ``streamed`` is an alias). ``REPRO_TICK_SYNC`` overrides."""
    if sync is None:
        sync = os.environ.get("REPRO_TICK_SYNC", "").strip().lower() or None
    if sync is None or sync == "auto":
        sync = "barrier"
    if sync == "streamed":
        sync = "stream"
    if sync not in ("barrier", "stream"):
        raise ValueError(f"unknown tick sync {sync!r} (auto|barrier|stream)")
    return sync


def resolve_tick_adversary(spec=None):
    """The federation adversarial-peer layer: ``None`` (off, the default) or
    an adversary description the scheduler hands to ``AdversaryPlan.parse``.
    An already-built ``AdversaryPlan``/``Adversary`` passes through; ``None``
    consults ``REPRO_TICK_ADVERSARY``; off-values resolve to ``None``."""
    return _fault_spec(spec, "REPRO_TICK_ADVERSARY")


def resolve_tick_faults(spec=None):
    """The federation fault-injection layer: ``None`` (off, the default) or
    a plan description the scheduler hands to ``FaultPlan.parse``. An
    already-built ``FaultPlan``/``FaultInjector`` passes through; ``None``
    consults ``REPRO_TICK_FAULTS``; off-values resolve to ``None``."""
    return _fault_spec(spec, "REPRO_TICK_FAULTS")
