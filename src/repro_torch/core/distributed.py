"""Device placement helpers: the serving subset and the owner-placement half
of the JAX package's ``core/distributed.py``.

``OwnerPlacement`` gives every federation owner a sticky home device, and
``chunk_extents`` cuts a signature bucket of equal-shaped tick entries into
chunks, as in the JAX package. The port has no SPMD program, so nothing is
stacked: where the JAX package assembles a chunk's operands along an owner
axis for ``shard_map`` (``assemble_group``/``disassemble_group``), a member
of a group here runs on its own device, ``devices[k]``, and its outputs stay
there. Nor are chunks padded with masked dummy entries: those cap the XLA
compiles per chunk extent, and a captured CUDA graph has no extent.

The two-party topology of ``examples/distributed_fkge.py`` lives in
``core/parties.py`` and is re-exported here: ``make_party_group`` (one
``torch.distributed`` process per party, rank 0 the client and rank 1 the
host; the caller names the backend, and a party on a card under ``gloo``
stages what it sends through pinned host memory), ``run_parties`` (spawned
ranks), ``init_distributed_ppat``, ``ppat_exchange_step`` (its pipe carries
only the round's two (B, d) tensors) and ``make_sharded_kge_step`` with
``shard_params``/``gather_params``. ``examples/distributed_fkge_torch.py``
runs them (``--device cpu`` on the CPU, no ``--device`` for the card).
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch

from repro_torch.core.parties import (  # noqa: F401
    PartyGroup,
    distributed_ppat_state_from_numpy,
    exchange_party,
    gather_params,
    init_distributed_ppat,
    make_party_group,
    make_sharded_kge_step,
    ppat_exchange_step,
    role_state,
    run_parties,
    shard_params,
    sharded_party,
)
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


class OwnerPlacement:
    """Sticky owner → device registry: an owner gets its home device
    (round-robin over ``devices``, in first-seen order) the first time it is
    looked up, and keeps it, whatever the later plans look like — so its
    tables and the tick engine's caches for it stay on one device across
    ticks. ``devices`` is any sequence of ``torch.device`` (repeats allowed:
    four slots on one CPU are four homes that share it)."""

    def __init__(self, devices: Sequence):
        self.devices: Tuple[torch.device, ...] = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("OwnerPlacement needs at least one device")
        self._slot: Dict[str, int] = {}
        #: the latest published version of each owner's tables on its home
        self._version: Dict[str, int] = {}

    def slot(self, owner: str) -> int:
        """The owner's sticky slot (an index into ``devices``)."""
        s = self._slot.get(owner)
        if s is None:
            s = len(self._slot) % len(self.devices)
            self._slot[owner] = s
        return s

    def device(self, owner: str) -> torch.device:
        return self.devices[self.slot(owner)]

    def note_version(self, owner: str, version: int) -> None:
        """Record that ``owner``'s home now holds its ``version``-th accepted
        publish (every accept path of the scheduler calls this)."""
        self._version[owner] = int(version)

    def version(self, owner: str) -> int:
        """The owner's latest published version on its home (0 before any
        accept)."""
        return self._version.get(owner, 0)

    def assignments(self) -> Dict[str, int]:
        return dict(self._slot)

    def restore_assignments(self, slots: Dict[str, int]) -> None:
        """Adopt checkpointed assignments, so a resumed run homes every owner
        where the interrupted one did (a resumed plan may look owners up in
        another order). Slots past this registry's devices wrap."""
        for owner, slot in slots.items():
            self._slot[owner] = int(slot) % len(self.devices)


def chunk_extents(n: int, n_devices: int) -> List[Tuple[int, int]]:
    """A signature bucket of ``n`` entries as ``(real, extent)`` chunks:
    full chunks of ``n_devices`` entries, then one remainder chunk whose
    extent is the next power of two, capped at ``n_devices`` — the JAX
    package's decomposition. The port runs the ``real`` members of a chunk
    on devices ``0 .. real - 1`` of it and pads nothing."""
    if n_devices < 1:
        raise ValueError("chunk_extents needs at least one device")
    out: List[Tuple[int, int]] = []
    pos = 0
    while n - pos >= n_devices:
        out.append((n_devices, n_devices))
        pos += n_devices
    r = n - pos
    if r:
        out.append((r, min(1 << (r - 1).bit_length(), n_devices)))
    return out
