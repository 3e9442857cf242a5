"""Per-rank accounting of a step: collective bytes, FLOPs, bytes accessed
and the live-tensor peak — the port's counterpart of the JAX package's
``utils/hlo.py``, which reads the first three out of XLA's compiled HLO.

The port has no compiled program to read, so ``RankAccounting`` (a
``TorchDispatchMode``) watches the operators one rank runs. DTensor
operators are let through to DTensor, so the mode sees what each rank runs
on its own shard: the local products, and the functional collectives
(``_c10d_functional.*``) that DTensor's redistributions, ``local_map``'s
bodies and the MoE's all-to-all issue. Under ``FakeTensorMode`` over a fake
process group nothing is allocated and nothing is sent, so a full-size step
of 256 or 512 ranks can be accounted in one process.

* **Collectives**: the reference's dict — ``all-gather``, ``all-reduce``,
  ``reduce-scatter``, ``all-to-all``, ``collective-permute``, ``total``
  and ``count`` — in bytes per rank, each collective counted by the bytes
  of its result, as the reference sums HLO result shapes. A collective in a
  Python loop is counted on every trip, so these are already the
  reference's ``loop_aware_collective_bytes``.
* **FLOPs**: ``torch.utils.flop_counter``'s formulas (the ones
  ``FlopCounterMode`` uses) over the rank's local operators.
* **Bytes accessed**: each operator's tensor arguments and results, once
  each.
* **Peak**: the most bytes held at once by storages the step created, found
  by weak references to each new storage; ``peak_bytes`` adds the bytes of
  the arguments (``argument_bytes``), which live throughout.
"""
from __future__ import annotations

import weakref
from typing import Any, Dict, Iterable

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry
from torch.utils.weak import WeakIdKeyDictionary

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

#: functional-collective operator name → the reference's HLO op kind
_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}


#: the ``ShardingPropagator`` method that runs an operator on fake tensors
_PROPAGATE = "_propagate_tensor_meta_non_cached"


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def local_bytes(tree: Any) -> int:
    """Bytes one rank holds of ``tree``'s tensors (a module's parameters and
    buffers included): a DTensor's local shard, a plain tensor whole (a
    storage shared by several views once)."""
    seen, total = set(), 0
    leaves = []
    for leaf in tree_flatten(tree)[0]:
        if isinstance(leaf, torch.nn.Module):
            leaves += [*leaf.parameters(), *leaf.buffers()]
        else:
            leaves.append(leaf)
    for leaf in leaves:
        if not isinstance(leaf, torch.Tensor):
            continue
        if isinstance(leaf, DTensor):
            leaf = leaf.to_local()
        st = leaf.untyped_storage()
        if id(st) not in seen:
            seen.add(id(st))
            total += st.nbytes()
    return total


class RankAccounting(TorchDispatchMode):
    """``with RankAccounting(fake_mode) as acc: step(...)``, then
    ``acc.collectives()``, ``acc.flops``, ``acc.bytes_accessed`` and
    ``acc.peak_new_bytes``. DTensor works out an operator's output shape
    by running it on global-shaped fake tensors; those operators are not
    the rank's, and the mode is paused while they run."""

    def __init__(self):
        super().__init__()
        self._paused = 0
        self.coll: Dict[str, int] = {k: 0 for k in COLLECTIVES}
        self.count = 0
        self.flops = 0
        self.bytes_accessed = 0
        self.live = 0
        self.peak_new_bytes = 0
        self._storages = WeakIdKeyDictionary()

    def _release(self, n: int) -> None:
        self.live -= n

    def _track(self, out: Iterable) -> None:
        for t in out:
            st = t.untyped_storage()
            if st in self._storages:
                continue
            n = st.nbytes()
            self._storages[st] = n
            self.live += n
            weakref.finalize(st, self._release, n)  # fires when the storage is freed
        self.peak_new_bytes = max(self.peak_new_bytes, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # DTensor unwraps; its local operators come back here
        out = func(*args, **kwargs)
        if func is torch.ops._c10d_functional.wait_tensor.default:
            return out  # the result of a collective already counted
        if self._paused:
            return out  # DTensor's shape propagation
        ins = [a for a in tree_flatten((args, kwargs))[0] if isinstance(a, torch.Tensor)]
        outs = [o for o in tree_flatten(out)[0] if isinstance(o, torch.Tensor)]
        self.bytes_accessed += sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += int(flop_registry[packet](*args, **kwargs, out_val=out))
        if func.namespace == "_c10d_functional":
            kind = _KINDS.get(packet.__name__)
            if kind is not None:
                self.coll[kind] += sum(_nbytes(t) for t in outs)
                self.count += 1
        # a result that shares an argument's storage (a view, an in-place
        # op) allocates nothing
        held = {id(t.untyped_storage()) for t in ins}
        self._track([t for t in outs if id(t.untyped_storage()) not in held])
        return out

    def __enter__(self):
        # every DTensor shares one propagator; its shape propagation runs here
        prop = type(DTensor._op_dispatcher.sharding_propagator)
        run = getattr(prop, _PROPAGATE, None)
        if run is None:
            raise RuntimeError(f"this torch's DTensor has no {_PROPAGATE}; the accounting "
                               "cannot tell its shape propagation from the rank's operators")

        def paused(prop_self, *a, **kw):
            self._paused += 1
            try:
                return run(prop_self, *a, **kw)
            finally:
                self._paused -= 1

        self._restore = (prop, run)
        setattr(prop, _PROPAGATE, paused)
        return super().__enter__()

    def __exit__(self, *exc):
        prop, run = self._restore
        setattr(prop, _PROPAGATE, run)
        return super().__exit__(*exc)

    def collectives(self) -> Dict[str, int]:
        """The reference's ``collective_bytes`` dict, bytes per rank."""
        out = {k: v for k, v in self.coll.items() if v}
        out["total"] = sum(self.coll.values())
        out["count"] = self.count
        return out
