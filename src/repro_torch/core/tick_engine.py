"""Batched federation tick engine: a tick's entries as programs, one per
entry signature, with one host sync per tick — the counterpart of the JAX
package's ``core/tick_engine.py`` and the default engine of
``FederationScheduler`` (``tick_impl="batched"``).

At tick start the scheduler plans one entry per Ready owner (a handshake or
a self-train). The engine runs each entry's whole pipeline as one program,
``entry_graph``:

    PPAT (all adversarial rounds) → synthesize → procrustes refine → robust
    rows → KGEmb update → virtual extension → bucket-padded retrain → strip
    → backtrack scoring (accuracy scores or Hit@10 rank counts)

with the same functions the serial path (``tick_impl="reference"``) calls,
on the same shapes, so the batched tick takes the serial tick's decisions
and gives its tables bit for bit. The host keeps the protocol: draws,
faults, the adversary's tampering, accept/reject, broadcast and ε
accounting, applied in plan order exactly as the serial loop applies them.

**One captured CUDA graph per entry signature.** A signature is the static
``EntrySpec`` plus the device, keys, shapes and dtypes of the entry's input
tensors (``entry_signature``); the learning rate is part of the spec, since
the kernels take it as a host float. On a CUDA device an entry program is a
short list of segments. A segment that holds no host sync is a
``torch.cuda.CUDAGraph``, captured once per signature on the program's own
stream: the first entry of a signature runs eagerly (its result, and the
warm-up the capture needs), the graph is captured after it, and every later
entry copies its inputs into the graph's static buffers and replays it. Two
segments always run eagerly, on the same stream: the 100 × 100 SVD of the
procrustes refine (``torch.linalg.svd`` reads its status back to the host),
and, for families the fused epoch kernel does not cover (TransH/R/D,
RotatE, ComplEx), the autograd retrain step (``torch.unique`` syncs). The
engine counts captured graphs, replays and eager segments (``stats``). A
capture that fails raises ``GraphCaptureError``; nothing is run eagerly in
its place. Kernel launches are counted in Python (``LAUNCHES``/``STEPS``
of the kernel wrappers), which a replay does not reach: each replay adds
the launches its graph captured. Graphs are module-global with process
lifetime, as the JAX package's compiled programs are: schedulers over the
same universe share them. ``clear_tick_programs`` frees them.

Entries of one signature share their graph, so they replay one after the
other on its stream; entries of different signatures run on different
streams at once. The host issues every entry's segments in waves (segment k
of every entry, then segment k + 1), so an eager SVD waits only for the
work before it on its own stream, and synchronises once at the end of the
tick (once per level under ``tick_sync="stream"``). On the CPU the same
``entry_graph`` runs eagerly, and the program cache still counts one
program per signature, so dedup can be pinned there.

**Time.** Every entry of a batched tick gets the whole tick's time as its
``FederationEvent.seconds`` (plus its injected straggle): the entries run
together, and the host cannot tell their shares apart without a sync of
its own. While a profiler session records spans (``utils.tracing``) the
engine times its stages (``tick.prepare``, ``tick.materialize``,
``tick.issue`` with a ``tick.segment`` child per entry and segment,
``tick.sync``, ``tick.post`` with a ``tick.entry`` child per entry), and
on a card puts a pair of timing events on the entry's stream around each
segment. After the tick's own sync each ``tick.segment`` span holds the
milliseconds between its pair and each ``tick.entry`` span their sum over
its segments (``stream_ms``): the entry's time on its stream, not its
device time alone. The first event of a pair completes as soon as the
stream reaches it, so the sum also counts the host's launch time inside a
segment (under the profiler each graph replay blocks the host for tens of
milliseconds) and the time the entry's kernels wait behind the other
stream's.

**Placement** (``kernels.dispatch.resolve_tick_placement``). ``single`` runs
every entry on the scheduler's device. ``sharded`` groups entries by
signature, orders each group by its owners' sticky home slots
(``core.distributed.OwnerPlacement``), cuts it with ``chunk_extents`` and
runs member k of a chunk on ``placement.devices[k]`` (a lone entry on its
owner's home). Results stay on the device that computed them
(``residency="resident"``) or move to the scheduler's device
(``"normalize"``). Per-owner immutable inputs (aligned index sets, virtual
structure, padded triple stores, scoring inputs) are cached per pair or
owner and uploaded once per device (``resident_transfers`` counts uploads).

**Failures.** A fault that kills an entry before any draw (crash, drop, a
corrupt view caught by the receiver's screen) draws nothing, so the other
entries take the draws the serial loop would give them. An uninjected
exception while an entry runs isolates that entry (an ``"error"`` event).
A failure that surfaces only when a stream is synchronised re-runs that
stream's entries one at a time, so one bad entry does not sink the others
that share its graph. The straggler deadline holds against the tick's
measured time plus the entry's injected delay.
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.aggregation import robust_rows, virtual_structure
from repro_torch.core.alignment import procrustes
from repro_torch.core.ppat import PPAT_BUCKET, PPATConfig, PPATDraws, _pad_rows, ppat_entry_graph
from repro_torch.core.privacy import MomentsAccountant
from repro_torch.kge.engine import (
    ENT_BUCKET,
    bucket,
    draw_epoch,
    pad_tables,
    pad_triples,
    resolve_renorm,
    shape_spec,
    strip_tables,
    train_scan_graph,
)
from repro_torch.kge.eval import side_counts_graph
from repro_torch.kge.models import KGEModel, score_triples, virtual_pad_rows
from repro_torch.utils import tracing

Tensors = Dict[str, torch.Tensor]


class GraphCaptureError(RuntimeError):
    """A tick-entry segment that should capture as a CUDA graph did not."""


# ---------------------------------------------------------------------------
# per-entry static spec + the entry's pipeline
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class EntrySpec:
    """Static (hashable) parameters of one tick-plan entry. With the input
    tensors' keys, shapes and dtypes it determines the entry's program."""

    kind: str                  # "ppat" | "self-train"
    model: KGEModel            # the host's model (logical counts)
    epochs: int
    batch: int
    train_impl: str            # "fused" | "sparse"
    renorm: str                # entity-norm schedule, resolved at plan time
    lr: float                  # a host float in the kernels: part of the signature
    cfg: Optional[PPATConfig]  # handshakes only
    aggregation: str
    refine: bool               # procrustes refinement of the DP release
    score: str                 # "accuracy" | "hit10" | "none" (scored on the host)
    lp_batch: int = 128        # Hit@10 chunk (``link_prediction``'s batch)
    block_e: int = 512
    #: Byzantine robust acceptance over the synthesized rows (handshakes)
    robust: str = "none"
    #: whether the entry returns the cosine-shift statistic
    cos: bool = False


def _sub(s: Tensors, prefix: str) -> Tensors:
    n = len(prefix)
    return {k[n:]: v for k, v in s.items() if k.startswith(prefix)}


def _nest(flat: Tensors) -> Dict:
    out: Dict = {}
    for path, v in flat.items():
        node = out
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return out


def _flat(tree: Dict, prefix: str) -> Tensors:
    out: Tensors = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _extend_params(p: Tensors, model: KGEModel, v_ent, v_rel) -> Tensors:
    """``KGETrainer.extend_tables`` on a dict: virtual rows appended, the
    family's inert pad rows from ``virtual_pad_rows``."""
    p = dict(p)
    p["ent"] = torch.cat([p["ent"], v_ent])
    p["rel"] = torch.cat([p["rel"], v_rel])
    for k, pad in virtual_pad_rows(p, model.dim, v_ent.shape[0], v_rel.shape[0]).items():
        p[k] = torch.cat([p[k], pad])
    return p


def _stage_ppat(s: Tensors, spec: EntrySpec) -> Tensors:
    """Gather the aligned rows (the client's from its frozen view), pad them
    to ``PPAT_BUCKET`` and run the handshake from its given init and draws;
    synthesize G(X) on the padded rows."""
    x = s["client_ent"][s["idx_c"]]
    y = s["params/ent"][s["idx_h"]]
    if "rel_c" in s:
        x = torch.cat([x, s["client_rel"][s["rel_c"]]])
        y = torch.cat([y, s["params/rel"][s["rel_h"]]])
    n = x.shape[0]
    x, y = _pad_rows(x, PPAT_BUCKET), _pad_rows(y, PPAT_BUCKET)
    draws = PPATDraws(s["ppat/idx"], s["ppat/ridx"], s["ppat/noise"])
    _, w, _, n0s, n1s = ppat_entry_graph(x, y, n, n, spec.cfg, init=_nest(_sub(s, "init/")),
                                         draws=draws)
    return {"w": w, "synth": x @ w, "y_pad": y, "n0s": n0s, "n1s": n1s}


def _stage_procrustes(s: Tensors, spec: EntrySpec) -> Tensors:
    return {"refine": procrustes(s["synth"], s["y_pad"])}


def _stage_update(s: Tensors, spec: EntrySpec) -> Tensors:
    """Refine, robust rows, the KGEmb update of the aligned rows, the
    virtual extension, and the bucket-padded tables for the retrain."""
    synth, refine = s["synth"], s.get("refine")
    if refine is not None:
        synth = synth @ refine
    n_ent = s["idx_c"].shape[0]
    out: Tensors = {}
    if spec.robust != "none" or spec.cos:
        synth, mean_cos = robust_rows(s["y_pad"], synth, n_ent, mode=spec.robust,
                                      want_cos=spec.cos)
        if spec.cos:
            out["mean_cos"] = mean_cos
    p = _sub(s, "params/")
    ent = p["ent"].clone()
    new = synth[:n_ent]
    if spec.aggregation == "average":
        new = 0.5 * (ent[s["idx_h"]] + new)
    ent[s["idx_h"]] = new
    p["ent"] = ent
    if "rel_c" in s:
        rel = p["rel"].clone()
        new = synth[n_ent:n_ent + s["rel_c"].shape[0]]
        if spec.aggregation == "average":
            new = 0.5 * (rel[s["rel_h"]] + new)
        rel[s["rel_h"]] = new
        p["rel"] = rel
    counts = spec.model
    if "neigh" in s:  # virtual extension: G(N(X)) in the host's space
        w = s["w"]

        def gen(e):
            return e @ w if refine is None else (e @ w) @ refine

        v_ent = gen(s["client_ent"][s["neigh"]])
        v_rel = gen(s["client_rel"][s["rels"]])
        p = _extend_params(p, spec.model, v_ent, v_rel)
        counts = dataclasses.replace(
            counts, num_entities=counts.num_entities + v_ent.shape[0],
            num_relations=counts.num_relations + v_rel.shape[0])
    padded, _, _ = pad_tables(p, counts)
    out.update(_flat(padded, "padded/"))
    return out


def _stage_pad(s: Tensors, spec: EntrySpec) -> Tensors:
    padded, _, _ = pad_tables(_sub(s, "params/"), spec.model)
    return _flat(padded, "padded/")


def _stage_train(s: Tensors, spec: EntrySpec) -> Tensors:
    """The retrain on the padded tables from the entry's per-epoch draws
    (updated in place, as the serial path's working copy is)."""
    draws = [tuple(s[f"train/{e}/{k}"] for k in ("perm", "corrupt_head", "rand_ent"))
             for e in range(spec.epochs)]
    # the corruption bound is only read when drawing; the draws are given
    padded, losses = train_scan_graph(
        _sub(s, "padded/"), s["triples"], spec.lr, 0, spec=shape_spec(spec.model),
        epochs=spec.epochs, batch=spec.batch, impl=spec.train_impl, renorm=spec.renorm,
        draws=draws)
    return {**_flat(padded, "padded/"), "losses": losses}


def _stage_strip(s: Tensors, spec: EntrySpec) -> Tensors:
    """Bucket padding and virtual rows off: the host's logical tables."""
    return _flat(strip_tables(_sub(s, "padded/"), spec.model), "out/")


def _stage_score(s: Tensors, spec: EntrySpec) -> Tensors:
    p, model = _sub(s, "out/"), spec.model
    if spec.score == "accuracy":
        va, vn = s["va"], s["va_neg"]
        return {"score/pos": score_triples(p, model, va[:, 0], va[:, 1], va[:, 2]),
                "score/neg": score_triples(p, model, vn[:, 0], vn[:, 1], vn[:, 2])}
    test, ft, fh = s["test"], s["filt_t"], s["filt_h"]
    out: Tensors = {}
    for ci, i in enumerate(range(0, test.shape[0], spec.lp_batch)):
        j = i + spec.lp_batch
        c = test[i:j]
        for side, filt in (("tail", ft[i:j]), ("head", fh[i:j])):
            out[f"score/{ci}/{side}"] = side_counts_graph(
                p, model, c[:, 0], c[:, 1], c[:, 2], filt, side=side, block_e=spec.block_e)
    return out


_STAGES: Dict[str, Callable[[Tensors, EntrySpec], Tensors]] = {
    "ppat": _stage_ppat, "procrustes": _stage_procrustes, "update": _stage_update,
    "pad": _stage_pad, "train": _stage_train, "strip": _stage_strip, "score": _stage_score,
}
#: what each stage reads (a key, or every key under a ``prefix/``)
_READS = {
    "ppat": ("params/ent", "params/rel", "client_ent", "client_rel", "idx_c", "idx_h",
             "rel_c", "rel_h", "init/", "ppat/"),
    "procrustes": ("synth", "y_pad"),
    "update": ("params/", "synth", "refine", "y_pad", "w", "idx_c", "idx_h", "rel_c",
               "rel_h", "client_ent", "client_rel", "neigh", "rels"),
    "pad": ("params/",),
    "train": ("padded/", "triples", "train/"),
    "strip": ("padded/",),
    "score": ("out/", "va", "va_neg", "test", "filt_t", "filt_h"),
}
#: what an entry hands back to the host
_FINAL = ("out/", "losses", "score/", "mean_cos", "n0s", "n1s")


def _matches(key: str, names: Sequence[str]) -> bool:
    return any(key.startswith(n) if n.endswith("/") else key == n for n in names)


def entry_stages(spec: EntrySpec) -> List[str]:
    stages = (["ppat"] + (["procrustes"] if spec.refine else []) + ["update"]
              if spec.kind == "ppat" else ["pad"])
    stages += ["train", "strip"]
    if spec.score != "none":
        stages.append("score")
    return stages


def _graphable(stage: str, spec: EntrySpec) -> bool:
    """Whether a stage can sit in a captured graph: everything but the SVD
    and the autograd retrain, which read back to the host."""
    return stage != "procrustes" and not (stage == "train" and spec.train_impl != "fused")


def entry_segments(spec: EntrySpec) -> List[Tuple[Tuple[str, ...], bool]]:
    """The entry's stages cut into ``(stages, graphable)`` segments: runs of
    graphable stages between the ones that must run eagerly."""
    segs: List[Tuple[List[str], bool]] = []
    for st in entry_stages(spec):
        g = _graphable(st, spec)
        if segs and segs[-1][1] and g:
            segs[-1][0].append(st)
        else:
            segs.append(([st], g))
    return [(tuple(st), g) for st, g in segs]


def _run_stages(stages: Sequence[str], spec: EntrySpec, inp: Tensors) -> Tensors:
    """Run ``stages`` on ``inp``; returns every key they wrote, final values."""
    s = dict(inp)
    written: Tensors = {}
    for name in stages:
        out = _STAGES[name](s, spec)
        s.update(out)
        written.update(out)
    return written


def entry_graph(inp: Tensors, spec: EntrySpec) -> Tensors:
    """One plan entry's whole pipeline on plain tensors: ``inp`` holds the
    host's tables (``params/<k>``), for a handshake the client's frozen
    ``client_ent`` (and ``client_rel``), the aligned index sets, the PPAT
    init (``init/...``) and draws (``ppat/idx|ridx|noise``), the per-epoch
    training draws (``train/<e>/perm|corrupt_head|rand_ent``), the padded
    triple store and the scoring inputs. Returns the new tables
    (``out/<k>``), the epoch losses, the scores (``score/...``), the vote
    counts of a handshake and its mean cosine when the screen is armed."""
    state = dict(inp)
    for stages, _ in entry_segments(spec):
        state.update(_run_stages(stages, spec, state))
    return {k: v for k, v in state.items() if _matches(k, _FINAL)}


# ---------------------------------------------------------------------------
# programs: one per entry signature (and device), segments captured on CUDA
# ---------------------------------------------------------------------------
def _counters() -> List[Dict[str, int]]:
    from repro_torch.kernels.sparse_update import ops as sparse_ops
    from repro_torch.kernels.triple_score import ops as score_ops

    return [score_ops.LAUNCHES, sparse_ops.LAUNCHES, sparse_ops.STEPS]


def _count_state() -> List[Dict[str, int]]:
    return [dict(c) for c in _counters()]


def _add_counts(delta: List[Dict[str, int]], sign: int = 1) -> None:
    for c, d in zip(_counters(), delta):
        for k, v in d.items():
            c[k] += sign * v


class _Segment:
    """One segment of a program: its stages, and on a CUDA device for a
    graphable segment the captured graph with its static buffers and the
    kernel launches one replay makes."""

    def __init__(self, stages: Tuple[str, ...], graphable: bool, later: Tuple[str, ...]):
        self.stages, self.graphable = stages, graphable
        #: what the later segments read: kept, with the entry's results
        self.keep = later + _FINAL
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.static_in: Tensors = {}
        self.static_out: Tensors = {}
        self.launches: List[Dict[str, int]] = []
        self.pool_bytes = 0
        self.static_bytes = 0

    def inputs(self, state: Tensors) -> Tensors:
        names = tuple(n for st in self.stages for n in _READS[st])
        return {k: v for k, v in state.items() if _matches(k, names)}

    def outputs(self, written: Tensors) -> Tensors:
        return {k: v for k, v in written.items() if _matches(k, self.keep)}


class _Program:
    """An entry signature's program on one device: its segments, and on a
    CUDA device the stream its entries run on."""

    def __init__(self, spec: EntrySpec, device: torch.device):
        self.spec, self.device = spec, device
        segs = entry_segments(spec)
        self.segments: List[_Segment] = []
        for k, (stages, graphable) in enumerate(segs):
            later = tuple(n for st, _ in segs[k + 1:] for s in st for n in _READS[s])
            self.segments.append(_Segment(stages, graphable, later))
        self.stream = torch.cuda.Stream(device) if device.type == "cuda" else None


#: programs by (entry signature, device), with process lifetime like the JAX
#: package's compiled programs: schedulers over one universe share them
_PROGRAMS: Dict[Tuple, _Program] = {}


def entry_signature(spec: EntrySpec, inp: Tensors, device=None) -> Tuple:
    """The dedup key: the spec plus the inputs' keys, shapes and dtypes (and
    the device, when given). Equal signatures share one program."""
    return (spec, None if device is None else str(device),
            tuple(sorted((k, tuple(v.shape), str(v.dtype)) for k, v in inp.items())))


def tick_program_cache_size() -> int:
    """Programs built so far (one per entry signature and device): steady
    ticks add none, and N equal-shaped owners share one per signature."""
    return len(_PROGRAMS)


def tick_graph_stats() -> Dict[str, int]:
    """Captured graphs over every program, their private pools' bytes and
    their static input buffers' bytes."""
    segs = [s for p in _PROGRAMS.values() for s in p.segments if s.graph is not None]
    return {"graphs": len(segs), "pool_bytes": sum(s.pool_bytes for s in segs),
            "static_bytes": sum(s.static_bytes for s in segs)}


def clear_tick_programs() -> None:
    """Drop every program and its graphs (and their memory)."""
    _PROGRAMS.clear()


def _program(spec: EntrySpec, inp: Tensors, device: torch.device) -> _Program:
    key = entry_signature(spec, inp, device)
    prog = _PROGRAMS.get(key)
    if prog is None:
        prog = _PROGRAMS[key] = _Program(spec, device)
    return prog


def _capture(seg: _Segment, spec: EntrySpec, inp: Tensors, prog: _Program) -> None:
    """Capture ``seg`` on the program's stream into a CUDA graph over static
    copies of ``inp``; the launches it records are what each replay adds."""
    dev, stream = prog.device, prog.stream
    with torch.cuda.stream(stream):
        static_in = {k: v.clone() for k, v in inp.items()}
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved(dev)
    before = _count_state()
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph, stream=stream):
            static_out = seg.outputs(_run_stages(seg.stages, spec, static_in))
    except Exception as ex:
        _add_counts([{k: v - b[k] for k, v in c.items()}
                     for c, b in zip(_count_state(), before)], -1)
        raise GraphCaptureError(
            f"tick entry segment {'+'.join(seg.stages)} ({spec.kind}, {spec.model.family}) "
            f"did not capture as a CUDA graph on {dev}: {ex}") from ex
    seg.launches = [{k: v - b[k] for k, v in c.items()}
                    for c, b in zip(_count_state(), before)]
    _add_counts(seg.launches, -1)  # captured, not launched
    seg.graph, seg.static_in, seg.static_out = graph, static_in, static_out
    seg.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
    seg.static_bytes = sum(t.numel() * t.element_size() for t in static_in.values())


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------
class _Run:
    """One entry's execution: its program, its inputs and its state."""

    def __init__(self, i: int, prog: _Program, inputs: Tensors):
        self.i, self.prog, self.inputs = i, prog, inputs
        self.state: Tensors = dict(inputs)
        self.err: Optional[Exception] = None
        #: (tick.segment span, start event, end event) of each timed segment
        self.timed: List[Tuple] = []

    def stream_ms(self) -> Optional[float]:
        """The milliseconds between each timed segment's events (read after
        the stream's sync), each also set on its segment's span."""
        if not self.timed:
            return None
        total = 0.0
        for sp, ev0, ev1 in self.timed:
            ms = ev0.elapsed_time(ev1)
            sp.set(stream_ms=ms)
            total += ms
        return total


def default_placement_devices(device: torch.device) -> List[torch.device]:
    """The owner homes ``sharded`` places over: every visible CUDA device
    when the scheduler is on one, else its own device."""
    if device.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [device]


class TickEngine:
    """Runs a scheduler's tick plan as signature-deduped entry programs
    (captured CUDA graphs on a card), optionally placed over the owners'
    home devices, with one host sync per tick. Holds the cross-tick caches
    of immutable per-pair and per-owner inputs, uploaded once per device."""

    def __init__(self, sched):
        from repro_torch.core.distributed import OwnerPlacement

        self.sched = sched
        self._pair: Dict[Tuple[str, str], Dict] = {}
        self._own: Dict[str, Dict] = {}
        self._score: Dict[str, Dict] = {}
        self._misc: Dict[str, Dict] = {}
        #: sticky owner → home device (see ``core.distributed.OwnerPlacement``)
        self.placement = OwnerPlacement(default_placement_devices(sched.device))
        #: cache uploads to a device: flat across steady-state ticks
        self.resident_transfers = 0
        #: cumulative counts: entries run, graphs captured, graph replays,
        #: eager segments on a CUDA device; ``last`` holds the last tick's
        self.stats = {"entries": 0, "captured": 0, "replays": 0, "eager_segments": 0}
        self.last = dict(self.stats)

    # ------------------------------------------------------------- caches
    def _resident_on(self, info: Dict, device: torch.device) -> Tensors:
        ondev = info.setdefault("_ondev", {})
        key = str(device)
        got = ondev.get(key)
        if got is None:
            got = {k: v.to(device) for k, v in info["arrays"].items()}
            ondev[key] = got
            self.resident_transfers += 1
        return got

    def _pair_info(self, client: str, host: str) -> Dict:
        """Everything immutable about a (client, host) handshake: the aligned
        index sets, the virtual structure, the rows the receiver screens, the
        extended triple store padded as the serial retrain pads it, and the
        counts its training draws are made for."""
        key = (client, host)
        info = self._pair.get(key)
        if info is not None:
            return info
        sched = self.sched
        idx_c, idx_h = sched.registry.entities(client, host)
        rel = sched.registry.relations(client, host)
        host_tr = sched.trainers[host]
        e_log, r_log = host_tr.model.num_entities, host_tr.model.num_relations
        arrays: Tensors = {"idx_c": torch.as_tensor(np.asarray(idx_c, np.int64)),
                           "idx_h": torch.as_tensor(np.asarray(idx_h, np.int64))}
        if rel is not None and len(rel[0]):
            arrays["rel_c"] = torch.as_tensor(np.asarray(rel[0], np.int64))
            arrays["rel_h"] = torch.as_tensor(np.asarray(rel[1], np.int64))
        screen_idx = np.asarray(idx_c, np.int64)
        tr = sched.kgs[host].train
        n_virt = 0
        if sched.use_virtual:
            vs = virtual_structure(sched.kgs[client], idx_c, idx_h, e_log, r_log)
            if vs is not None:
                neigh, rels, extra = vs
                n_virt = len(neigh)
                arrays["neigh"] = torch.as_tensor(np.asarray(neigh, np.int64))
                arrays["rels"] = torch.as_tensor(np.asarray(rels, np.int64))
                screen_idx = np.concatenate([screen_idx, np.asarray(neigh, np.int64)])
                if len(extra):
                    tr = np.concatenate([tr, np.asarray(extra, np.int32)])
        info = {"screen_idx": screen_idx, "arrays": arrays,
                "num_entities": e_log + n_virt}
        info.update(self._store(arrays, tr, host_tr.batch_size, e_log + n_virt))
        self._pair[key] = info
        return info

    @staticmethod
    def _store(arrays: Tensors, tr: np.ndarray, batch_size: int, n_ent: int) -> Dict:
        """Pad the triple store as the trainer does; its batch, size and
        batch count, and the renorm schedule the serial retrain resolves."""
        b = min(batch_size, len(tr))
        arrays["triples"] = pad_triples(torch.as_tensor(np.asarray(tr, np.int64)), b)
        n_pad = arrays["triples"].shape[0]
        return {"batch": b, "n_pad": n_pad, "nb": n_pad // b,
                "renorm": resolve_renorm(n_pad, bucket(n_ent, ENT_BUCKET))}

    def _own_info(self, name: str) -> Dict:
        """A self-train's immutable inputs: the owner's padded store."""
        info = self._own.get(name)
        if info is None:
            tr = self.sched.trainers[name]
            arrays: Tensors = {}
            info = {"arrays": arrays, "num_entities": tr.model.num_entities}
            info.update(self._store(arrays, self.sched.kgs[name].train, tr.batch_size,
                                    tr.model.num_entities))
            self._own[name] = info
        return info

    def _misc_info(self, name: str) -> Dict:
        """Per-owner scalars that are constant across ticks (the learning
        rate), keyed on their value, so a ``trainer.lr`` changed between
        runs is honoured (it is part of the entry's signature)."""
        lr = self.sched.trainers[name].lr
        info = self._misc.get(name)
        if info is None or info["version"] != (lr,):
            info = self._misc[name] = {"version": (lr,), "lr": float(lr)}
        return info

    def _score_info(self, name: str) -> Dict:
        """The owner's backtrack inputs, rebuilt when the metric or the
        scoring universe (``_score_universe``) changes."""
        metric = self._metric_kind()
        version = self.sched._score_universe(name)
        info = self._score.get(name)
        if info is not None and info["metric"] == metric and info["version"] == version:
            return info
        arrays: Tensors = {}
        info = {"metric": metric, "version": version, "arrays": arrays}
        if metric == "accuracy":
            va, va_neg = self.sched._accuracy_inputs(name)
            arrays["va"] = torch.as_tensor(np.asarray(va, np.int64))
            arrays["va_neg"] = torch.as_tensor(np.asarray(va_neg, np.int64))
        elif metric == "hit10":
            test, filt_t, filt_h = self.sched._hit10_inputs(name)
            arrays["test"] = torch.as_tensor(np.asarray(test, np.int64))
            arrays["filt_t"] = torch.as_tensor(np.asarray(filt_t, np.int32))
            arrays["filt_h"] = torch.as_tensor(np.asarray(filt_h, np.int32))
            info["ntest"] = len(test)
        self._score[name] = info
        return info

    def _metric_kind(self) -> str:
        """``accuracy``/``hit10`` for the scheduler's own score functions
        (scored in the program), ``none`` for a custom ``score_fn`` (scored
        on the host on the candidate tables)."""
        sched = self.sched
        fn = getattr(sched.score_fn, "__func__", None)
        if fn is type(sched)._valid_accuracy:
            return "accuracy"
        if fn is type(sched)._valid_hit10:
            return "hit10"
        return "none"

    # ---------------------------------------------------------- execution
    def _train_draws(self, name: str, epochs: int, info: Dict) -> List:
        """An entry's training draws from the scheduler's draw source, else
        from the owner's engine generator — what the serial retrain draws."""
        sched = self.sched
        n_pad, nb, b, n_ent = info["n_pad"], info["nb"], info["batch"], info["num_entities"]
        if sched._draws is not None:
            return sched._draws.train(name, epochs, n_pad, nb, b, n_ent)
        gen = sched.trainers[name].consume_engine_key()
        return [draw_epoch(gen, n_pad, nb, b, n_ent) for _ in range(epochs)]

    def _segment(self, run: _Run, k: int) -> None:
        """Run segment ``k`` of an entry. On the CPU the whole entry is one
        eager ``entry_graph`` call (at ``k == 0``). On a CUDA device an
        eager segment runs on the program's stream, and a graphable one is
        captured at its signature's first entry (which runs eagerly first)
        and replayed after."""
        prog = run.prog
        spec = prog.spec
        if prog.stream is None:
            if k == 0:
                run.state.update(entry_graph(run.state, spec))
            return
        seg = prog.segments[k]
        inp = seg.inputs(run.state)
        with torch.cuda.stream(prog.stream):
            if seg.graph is None:
                out = seg.outputs(_run_stages(seg.stages, spec, inp))
            else:
                for key, t in inp.items():
                    seg.static_in[key].copy_(t)
                seg.graph.replay()
                out = {key: t.clone() for key, t in seg.static_out.items()}
        if seg.graph is not None:
            _add_counts(seg.launches)
            self.last["replays"] += 1
        elif seg.graphable:
            _capture(seg, spec, inp, prog)
            self.last["captured"] += 1
        else:
            self.last["eager_segments"] += 1
        run.state.update(out)

    def _issue(self, run: _Run, k: int) -> None:
        """Segment ``k`` of an entry in a ``tick.segment`` span; while it
        records on a card, between two timing events on the entry's stream."""
        with tracing.span("tick.segment") as sp:
            stream = run.prog.stream
            if sp:
                sp.set(entry=run.i, graph=run.prog.segments[k].graphable)
            if not sp or stream is None:
                self._segment(run, k)
                return
            ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            ev0.record(stream)
            self._segment(run, k)
            ev1.record(stream)
            run.timed.append((sp, ev0, ev1))

    def _dispatch(self, runs: List[_Run]) -> None:
        """Issue every run's segments in waves, then block once per stream.
        A stream whose synchronisation fails re-runs its entries one at a
        time, so the failure is pinned on the entry that made it."""
        with tracing.span("tick.issue"):
            for run in runs:
                if run.prog.stream is not None:
                    run.prog.stream.wait_stream(torch.cuda.current_stream(run.prog.device))
            depth = max((len(r.prog.segments) for r in runs), default=0)
            for k in range(depth):
                for run in runs:
                    if run.err is None and k < len(run.prog.segments):
                        try:
                            self._issue(run, k)
                        except GraphCaptureError:
                            raise
                        except Exception as ex:  # noqa: BLE001 — isolate, don't abort
                            run.err = ex
        with tracing.span("tick.sync"):
            groups: Dict[int, List[_Run]] = {}
            for run in runs:
                if run.prog.stream is not None:
                    groups.setdefault(id(run.prog.stream), []).append(run)
            for group in groups.values():
                try:
                    group[0].prog.stream.synchronize()
                except Exception:  # noqa: BLE001 — re-run the group one by one
                    for run in group:
                        run.state, run.err, run.timed = dict(run.inputs), None, []
                        try:
                            for k in range(len(run.prog.segments)):
                                self._issue(run, k)
                            run.prog.stream.synchronize()
                        except GraphCaptureError:
                            raise
                        except Exception as ex:  # noqa: BLE001
                            run.err = ex
            for run in runs:  # results are read on the default stream from here
                if run.prog.stream is not None and run.err is None:
                    cur = torch.cuda.current_stream(run.prog.device)
                    for key, t in run.state.items():
                        if _matches(key, _FINAL):
                            t.record_stream(cur)

    def _devices(self, specs, protos, owners, placement: str) -> List[Optional[torch.device]]:
        """Each entry's device: the scheduler's under ``single``; under
        ``sharded`` signature groups in home-slot order, cut by
        ``chunk_extents``, member k of a chunk on ``placement.devices[k]``
        and a lone entry on its owner's home."""
        from repro_torch.core.distributed import chunk_extents

        n = len(specs)
        devs: List[Optional[torch.device]] = [None] * n
        if placement == "single":
            for i in range(n):
                if specs[i] is not None:
                    devs[i] = self.sched.device
            return devs
        buckets: Dict[Tuple, List[int]] = {}
        for i, (spec, proto) in enumerate(zip(specs, protos)):
            if spec is not None:
                buckets.setdefault(entry_signature(spec, proto), []).append(i)
        pl = self.placement
        for idxs in buckets.values():
            idxs = sorted(idxs, key=lambda i: (pl.slot(owners[i]), owners[i]))
            pos = 0
            for real, _ in chunk_extents(len(idxs), len(pl.devices)):
                chunk = idxs[pos:pos + real]
                pos += real
                if real == 1:
                    devs[chunk[0]] = pl.device(owners[chunk[0]])
                    continue
                for k, i in enumerate(chunk):
                    devs[i] = pl.devices[k]
        return devs

    def execute(self, entries: List, tick: int, *, placement: Optional[str] = None,
                residency: Optional[str] = None, faults=None, adversary=None,
                deadline: Optional[float] = None) -> List:
        """Run one planned tick (or one streamed level) batched; returns its
        ``FederationEvent``s in plan order, with the protocol's side effects
        (accept or restore, snapshot, broadcast, ε, the failure ledger)
        applied in plan order as the serial loop applies them.

        Per entry, before anything runs: the frozen view, the adversary's
        tamper, the fault's corruption and the receiver's screen, then the
        PPAT draws and the training draws, in plan order — an entry that a
        crash, a drop or a caught corrupt view kills draws nothing."""
        from repro_torch.core.faults import CorruptEmbeddingError
        from repro_torch.core.federation import FederationEvent, NodeState
        from repro_torch.kernels.dispatch import (
            resolve_tick_placement,
            resolve_tick_residency,
            resolve_train_impl,
        )
        from repro_torch.kge.eval import _metrics, best_threshold_accuracy

        sched = self.sched
        placement = resolve_tick_placement(
            placement if placement is not None else sched.tick_placement)
        residency = resolve_tick_residency(
            residency if residency is not None else sched.tick_residency)
        t0 = time.perf_counter()
        self.last = {k: 0 for k in self.stats}
        n = len(entries)
        specs: List[Optional[EntrySpec]] = [None] * n
        protos: List[Optional[Tensors]] = [None] * n
        owners = [e.host for e in entries]
        entry_faults: List = [None] * n
        entry_attacks: List = [None] * n
        #: fault kinds of entries isolated before they ran, applied in order
        pre_failed: List[Optional[str]] = [None] * n
        metric = self._metric_kind()
        with tracing.span("tick.prepare"):
            for i, e in enumerate(entries):
                tr = sched.trainers[e.host]
                fault = faults.draw(tick, e.host, e.client) if faults is not None else None
                atk = (adversary.draw(tick, e.host, e.client)
                       if adversary is not None and e.kind == "ppat" else None)
                entry_faults[i], entry_attacks[i] = fault, atk
                view = e.client_view
                if e.kind == "ppat":
                    pair = self._pair_info(e.client, e.host)
                    if view is None:
                        view = dict(sched.trainers[e.client].params)
                    if atk is not None:
                        # every planned view is tampered, even one whose entry
                        # then dies, so the replay cache advances as in the
                        # serial loop
                        view = adversary.tamper_view(view, atk, tick, e.host, e.client,
                                                     rows=pair["screen_idx"])
                if fault is not None and fault.kind in ("crash", "drop"):
                    pre_failed[i] = fault.kind
                    continue
                if e.kind == "ppat":
                    if fault is not None and fault.kind == "corrupt":
                        view = faults.corrupt_view(view, fault, tick, e.host)
                    if faults is not None:
                        try:
                            sched.screen_incoming(e.host, e.client, view, bound=faults.norm_bound)
                        except CorruptEmbeddingError:
                            pre_failed[i] = "corrupt"
                            continue
                if sched.state[e.host] is not NodeState.QUARANTINED:
                    # a mid-tick quarantine (blamed as an earlier entry's
                    # client) survives its already-planned entry
                    sched.state[e.host] = NodeState.BUSY
                dev_of_tables = tr.params["ent"].device
                impl = resolve_train_impl(None, tr.model.family, dev_of_tables)
                inp: Tensors = _flat(dict(tr.params), "params/")
                if e.kind == "ppat":
                    info = pair
                    init, draws = (e.ppat_draws if e.ppat_draws is not None
                                   else sched._draw_ppat(e.host, e.client))
                    inp.update(_flat(init, "init/"))
                    inp.update({"ppat/idx": draws.idx, "ppat/ridx": draws.ridx,
                                "ppat/noise": draws.noise, "client_ent": view["ent"]})
                    if "rel_c" in pair["arrays"] or "neigh" in pair["arrays"]:
                        inp["client_rel"] = view["rel"]
                else:
                    info = self._own_info(e.host)
                for ep, d in enumerate(self._train_draws(e.host, sched.update_epochs, info)):
                    for name, t in zip(("perm", "corrupt_head", "rand_ent"), d):
                        inp[f"train/{ep}/{name}"] = (
                            t if torch.is_tensor(t) else torch.from_numpy(np.array(t)))
                inp["_res"] = info  # resident arrays, resolved per device below
                if metric != "none":
                    inp["_score"] = self._score_info(e.host)
                specs[i] = EntrySpec(
                    kind=e.kind, model=tr.model, epochs=sched.update_epochs, batch=info["batch"],
                    train_impl=impl, renorm=info["renorm"], lr=self._misc_info(e.host)["lr"],
                    cfg=sched.ppat_cfg if e.kind == "ppat" else None,
                    aggregation=sched.aggregation, refine=sched.procrustes_refine, score=metric,
                    robust=sched.robust_agg if e.kind == "ppat" else "none",
                    cos=e.kind == "ppat" and sched.cos_screen is not None)
                protos[i] = inp

        runs: List[_Run] = []
        errs: List[Optional[Exception]] = [None] * n
        with tracing.span("tick.materialize"):
            shapes = [None if p is None else self._shape_view(p) for p in protos]
            devs = self._devices(specs, shapes, owners, placement)
            for i in range(n):
                if specs[i] is None:
                    continue
                try:
                    inputs = self._materialize(protos[i], devs[i])
                    run = _Run(i, _program(specs[i], inputs, devs[i]), inputs)
                except Exception as ex:  # noqa: BLE001 — isolate, don't abort
                    errs[i] = ex
                    continue
                runs.append(run)
        try:
            self._dispatch(runs)
        except GraphCaptureError:
            for i in range(n):
                if specs[i] is not None and sched.state[entries[i].host] is NodeState.BUSY:
                    sched.state[entries[i].host] = NodeState.READY
            raise
        with tracing.span("tick.post"):
            outs: List[Optional[Tensors]] = [None] * n
            for run in runs:
                if run.err is not None:
                    errs[run.i] = run.err
                else:
                    outs[run.i] = {k: v for k, v in run.state.items() if _matches(k, _FINAL)}
            self.last["entries"] = len(runs)
            for k, v in self.last.items():
                self.stats[k] += v
            seconds = time.perf_counter() - t0
            timed = {run.i: run for run in runs} if tracing.recording() else {}

            events = []
            for i, e in enumerate(entries):
                client = e.client if e.kind == "ppat" else None
                with tracing.span("tick.entry") as sp:
                    if sp:
                        sp.set(entry=i, host=e.host, client=client,
                               stream_ms=timed[i].stream_ms() if i in timed else None)
                    if pre_failed[i] is not None or outs[i] is None:
                        # isolated before it ran, or an uninjected exception
                        # while it ran ("error", blamed on the host like a crash)
                        sched._entry_failed(e.host, client, pre_failed[i] or "error")
                        events.append(sched.events[-1])
                        if sp:
                            sp.set(accepted=False, fault=sched.events[-1].fault)
                        continue
                    spec, out = specs[i], outs[i]
                    tr = sched.trainers[e.host]
                    params = _sub(out, "out/")
                    if residency == "normalize":
                        params = {k: v.to(sched.device) for k, v in params.items()}
                    epsilon = float("nan")
                    if e.kind == "ppat":
                        acct = MomentsAccountant(sched.ppat_cfg.lam, sched.ppat_cfg.delta)
                        acct.update(out["n0s"].cpu().numpy().ravel(),
                                    out["n1s"].cpu().numpy().ravel())
                        epsilon = acct.epsilon()
                        sched.epsilons.append(epsilon)
                        sched.accountant.merge(acct)  # federation-lifetime ε
                    before = sched.best_score[e.host]
                    if spec.score == "accuracy":
                        _, after = best_threshold_accuracy(out["score/pos"].cpu().numpy(),
                                                           out["score/neg"].cpu().numpy(),
                                                           max_candidates=256)
                    elif spec.score == "hit10":
                        ntest = self._score_info(e.host)["ntest"]
                        ranks = np.empty(2 * ntest, dtype=np.int64)
                        for ci, i0 in enumerate(range(0, ntest, spec.lp_batch)):
                            ct = out[f"score/{ci}/tail"].cpu().numpy()
                            ch = out[f"score/{ci}/head"].cpu().numpy()
                            ranks[2 * i0: 2 * (i0 + len(ct)): 2] = ct + 1
                            ranks[2 * i0 + 1: 2 * (i0 + len(ct)): 2] = ch + 1
                        after = _metrics(ranks)["hit@10"]
                    else:  # a custom score_fn scores the candidate tables on the host
                        tr.params = dict(params)
                        after = sched.score_fn(e.host)
                    fault = entry_faults[i]
                    elapsed = seconds + (fault.delay if fault is not None
                                         and fault.kind == "straggle" else 0.0)
                    straggled = deadline is not None and elapsed > deadline
                    mean_cos = float(out["mean_cos"]) if "mean_cos" in out else None
                    poisoned = (mean_cos is not None and not straggled
                                and mean_cos < sched._cos_tau(e.client))
                    accepted = after > before and not straggled and not poisoned
                    if accepted:  # Backtrack (Alg. 1 l. 17)
                        tr.params = dict(params)
                        sched.best_score[e.host] = after
                        sched.best_snapshot[e.host] = tr.snapshot()
                    else:
                        tr.restore(sched.best_snapshot[e.host])
                    if sched.state[e.host] is NodeState.BUSY:
                        sched.state[e.host] = NodeState.READY
                    atk = entry_attacks[i]
                    fault_kind = "straggle" if straggled else ("poison" if poisoned else None)
                    ev = FederationEvent(tick, e.host, client, e.kind, before, after, accepted,
                                         epsilon=epsilon, seconds=elapsed, fault=fault_kind,
                                         attack=atk.kind if atk is not None else None)
                    sched.events.append(ev)
                    events.append(ev)
                    if accepted:
                        sched.broadcast(e.host)
                        if e.kind == "ppat":
                            sched._rep_recover(e.host, e.client)
                        sched._notify_accept(e.host)
                    if fault_kind is not None:
                        sched._entry_failed(e.host, client, fault_kind, emit=False)
                    else:
                        sched._note_entry_ok(e.host, client)
                    if sp:
                        sp.set(accepted=accepted, fault=fault_kind)
        return events

    @staticmethod
    def _shape_view(proto: Tensors) -> Tensors:
        """An entry's inputs with the cached arrays in, on whatever device:
        what its device-free signature is computed from."""
        inp = {k: v for k, v in proto.items() if not k.startswith("_")}
        for key in ("_res", "_score"):
            if key in proto:
                inp.update(proto[key]["arrays"])
        return inp

    def _materialize(self, proto: Tensors, device: torch.device) -> Tensors:
        """An entry's inputs on ``device``: the per-tick tensors (tables,
        the client view, the draws) moved there, the cached arrays from
        their per-device copies."""
        inp = {k: v.to(device) for k, v in proto.items() if not k.startswith("_")}
        for key in ("_res", "_score"):
            if key in proto:
                inp.update(self._resident_on(proto[key], device))
        return inp
