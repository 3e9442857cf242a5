"""Device placement helpers: the serving subset of the JAX package's
``core/distributed.py``."""
from __future__ import annotations

from typing import List, Mapping, Optional, Sequence

import torch

from repro_torch.kernels.dispatch import cuda_devices


def replica_devices(home_slot: int, n: int,
                    devices: Optional[Sequence] = None) -> List[torch.device]:
    """The serving tier's replica ring for an owner homed at ``home_slot``:
    ``n`` consecutive devices starting at the home, wrapping, clamped to the
    number of devices (4 replicas on 2 cards yields 2). ``devices`` defaults
    to every visible CUDA device and raises when there is none. Replica 0
    is the home, where the owner's tables already sit, so a publish's first
    staging is zero-copy."""
    devices = tuple(
        torch.device(d) for d in (devices if devices is not None else cuda_devices())
    )
    if not devices:
        raise ValueError("replica_devices needs at least one device")
    if n < 1:
        raise ValueError(f"replica count must be >= 1, got {n}")
    n = min(int(n), len(devices))
    return [devices[(int(home_slot) + i) % len(devices)] for i in range(n)]


def committed_device(params: Mapping[str, torch.Tensor]) -> Optional[torch.device]:
    """The one device every tensor of ``params`` sits on, or ``None`` when
    they are spread over several (or there are none)."""
    devs = {t.device for t in params.values() if isinstance(t, torch.Tensor)}
    return devs.pop() if len(devs) == 1 else None
