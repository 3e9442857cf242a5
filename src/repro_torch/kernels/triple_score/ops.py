"""Public wrappers of the triple_score kernels.

``pairwise_scores`` — (B, d) × (E, d) → (B, E) scores (csrc/pairwise_scores.cu).
``fused_ranks`` — filtered rank counts ``out[i] = Σ_e 1[score(q_i, e) > gold_i]``
over entities not listed in ``filt[i]``, without materializing (B, E)
(csrc/fused_ranks.cu). The count is taken over every entity, and then each
distinct filtered id that beats gold is subtracted once; the plain version
takes the same two steps, on the same scores.
``pairwise_topk`` — the k best (score, id) of each query over the entities
not listed in ``filt[i]``, selected inside the scoring kernel, so (B, E)
never exists either (csrc/pairwise_topk.cu); bit-equal to ``topk_scan``
over ``pairwise_scores``. All three share the tile math of
csrc/tile_score.cuh.
``projected_ranks`` — TransR's filtered rank counts: the rows of a batch
grouped by relation, each group's entity table projected through its
relation's matrix and scored in the same launch, so neither (B, E) nor a
projected (E, d) table exists (csrc/projected_ranks.cu).

For a CUDA tensor a wrapper launches its kernel or raises; for a CPU tensor
it takes the plain PyTorch version beside it (``*_plain``), which repeats
the tile math blockwise. ``LAUNCHES`` counts kernel launches per wrapper, so
a run can show that its main path went through the kernels.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels._nvcc import SPLIT_TF32, CudaLibrary, build_all
from repro_torch.kernels._tf32 import matmul_tf32

#: score tile modes: L1/L2 Minkowski (negated distance), plain dot product,
#: or complex-L1 ("cl1": rows are [re | im] halves, per-component modulus —
#: the RotatE distance)
SCORE_MODES = ("l1", "l2", "dot", "cl1")
_MODE_IDS = {"l1": 0, "l2": 1, "dot": 2, "cl1": 3}

_CSRC = Path(__file__).resolve().parent / "csrc"
_HEADERS = (_CSRC / "tile_score.cuh", SPLIT_TF32)
PAIRWISE_LIB = CudaLibrary("triple_score_pairwise", _CSRC / "pairwise_scores.cu", _HEADERS)
FUSED_RANKS_LIB = CudaLibrary("triple_score_fused_ranks", _CSRC / "fused_ranks.cu", _HEADERS)
TOPK_LIB = CudaLibrary("triple_score_topk", _CSRC / "pairwise_topk.cu", _HEADERS)
PROJECTED_LIB = CudaLibrary("triple_score_projected_ranks", _CSRC / "projected_ranks.cu",
                            _HEADERS)
LIBRARIES = (PAIRWISE_LIB, FUSED_RANKS_LIB, TOPK_LIB, PROJECTED_LIB)

#: kernel launches per wrapper since the last ``reset_launches`` (a
#: ``pairwise_topk`` launch is its scoring kernel and its merge)
LAUNCHES: Dict[str, int] = {"pairwise_scores": 0, "fused_ranks": 0, "pairwise_topk": 0,
                            "projected_ranks": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def build_kernels() -> Dict[str, str]:
    """Build the kernel libraries (one ``nvcc`` process each, started
    together) and return the compiler logs."""
    return build_all(LIBRARIES)


_VP, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "triple_score_pairwise": [_VP, _VP, _VP, _I, _I, _I, _I, _I, _VP],
    "triple_score_fused_ranks": [_VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _I, _I, _VP],
    "triple_score_topk": [_VP] * 6 + [_I] * 8 + [_VP],
    "triple_score_topk_blocks": [_I] * 7 + [ctypes.POINTER(_I)],
    "triple_score_topk_cap": [_I, _I, _I],
    "triple_score_projected_ranks": [_VP] * 12 + [_I] * 6 + [_VP],
}


def _entry(lib: CudaLibrary, name: str):
    cdll = lib.load()
    fn = getattr(cdll, name)
    if fn.argtypes is None:
        fn.argtypes = _SIGNATURES[name]
        fn.restype = ctypes.c_int
        cdll.triple_score_error_string.argtypes = [ctypes.c_int]
        cdll.triple_score_error_string.restype = ctypes.c_char_p
    return fn, cdll


def _check_rc(rc: int, cdll, what: str) -> None:
    if rc != 0:
        msg = cdll.triple_score_error_string(rc).decode()
        raise RuntimeError(f"{what} kernel launch failed: {msg} (cudaError {rc})")


def _resolve_mode(ord_: int, mode: Optional[str]) -> str:
    mode = mode or ("l2" if ord_ == 2 else "l1")
    if mode not in SCORE_MODES:
        raise ValueError(f"unknown score mode {mode!r} {SCORE_MODES}")
    return mode


def _kernel_inputs(what: str, mode: str, strict: bool = False, **tensors) -> torch.device:
    """Device of the inputs; raises on what the kernels do not take. The
    dtypes and the layout are checked on a CUDA device, and with ``strict``
    on the CPU too."""
    devs = {t.device for t in tensors.values()}
    if len(devs) != 1:
        raise ValueError(f"{what}: inputs on different devices {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {dev}")
    q, ent = tensors["q"], tensors["ent"]
    if q.dim() != 2 or ent.dim() != 2 or q.shape[1] != ent.shape[1]:
        raise ValueError(f"{what}: expected q (B, d) and ent (E, d), got "
                         f"{tuple(q.shape)} and {tuple(ent.shape)}")
    if mode == "cl1" and q.shape[1] % 2:
        raise ValueError(f"{what}: cl1 rows need an even width, got {q.shape[1]}")
    if dev.type == "cuda" or strict:
        for name, t in tensors.items():
            want = torch.int32 if name == "filt" else torch.float32
            if t.dtype != want:
                raise TypeError(f"{what}: {name} must be {want}, got {t.dtype}")
            if not t.is_contiguous():
                raise ValueError(f"{what}: {name} must be contiguous")
    return dev


# ----------------------------------------------------------- plain versions
def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root, as the kernels' ``sqrtf`` and
    XLA's give it. PyTorch's vectorized CPU ``sqrt`` is off by one ulp for
    some inputs, and differently so than its scalar path, which would make a
    query's gathered gold score and its tile score of a tying entity
    disagree. The float64 root rounded once to float32 is exact."""
    return torch.sqrt(x.double()).to(torch.float32)


def tile_scores_plain(q: torch.Tensor, e: torch.Tensor, mode: str) -> torch.Tensor:
    """(Bq, d) × (Be, d) → (Bq, Be) scores, higher = better: the JAX
    package's ``_tile_scores`` (l2 through the clamped expansion)."""
    if mode == "dot":
        return q @ e.T
    if mode == "l2":
        qq = (q * q).sum(1)[:, None]
        ee = (e * e).sum(1)[None, :]
        d2 = torch.clamp(qq - 2.0 * (q @ e.T) + ee, min=0.0)
        return -sqrt_rn(d2 + 1e-12)
    if mode == "cl1":
        h = q.shape[1] // 2
        dr = q[:, None, :h] - e[None, :, :h]
        di = q[:, None, h:] - e[None, :, h:]
        return -sqrt_rn(dr * dr + di * di + 1e-12).sum(-1)
    return -(q[:, None, :] - e[None, :, :]).abs().sum(-1)


def pairwise_scores_plain(q: torch.Tensor, ent: torch.Tensor, mode: str,
                          block_e: int = 2048) -> torch.Tensor:
    """Plain version of the pairwise kernel, ``block_e`` entities at a time
    so the (B, block_e, d) broadcast stays bounded."""
    q = q.float()
    e = ent.shape[0]
    out = torch.empty(q.shape[0], e, dtype=torch.float32, device=q.device)
    for c0 in range(0, e, block_e):
        c1 = min(c0 + block_e, e)
        out[:, c0:c1] = tile_scores_plain(q, ent[c0:c1].float(), mode)
    return out


def exclusion_mask(filt: torch.Tensor, c0: int, c1: int) -> torch.Tensor:
    """(B, c1−c0) bool: True where entity ``c0 + col`` is listed in the
    query's filter row (pad −1 never matches). One scatter, O(B·F), no host
    sync: ids outside [c0, c1) land in a spill column that is dropped."""
    b, w = filt.shape[0], c1 - c0
    rel = filt.long() - c0
    rel = torch.where((rel >= 0) & (rel < w), rel, torch.full_like(rel, w))
    mask = torch.zeros(b, w + 1, dtype=torch.bool, device=filt.device)
    mask.scatter_(1, rel, True)
    return mask[:, :w]


def ordered_keys(vals: torch.Tensor) -> torch.Tensor:
    """(B, n) float32 → (B, n) int64 keys, unique per row, ordered by score
    descending and then by slot ascending: ``torch.topk`` of the keys is the
    stable ``lax.top_k`` of the scores."""
    v = (vals + 0.0).contiguous()  # -0.0 → +0.0: they tie as floats
    bits = v.view(torch.int32).long()
    ordered = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    pos = torch.arange(vals.shape[1], dtype=torch.int64, device=vals.device)
    return ordered * (1 << 32) + ((1 << 32) - 1 - pos)


def topk_scan(score_block: Callable[[int, int], torch.Tensor], b: int, e: int,
              filt: torch.Tensor, *, k: int, chunk: int,
              device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blockwise top-k: carry (vals, ids) of width ``min(k, e)``, fold in one
    entity chunk at a time. ``score_block(c0, c1) → (B, c1−c0)`` scores;
    filtered ids score ``-inf``.

    Tie order matches ``lax.top_k`` over the JAX package's ``[carried,
    block]`` concatenation: among equal scores the earlier slot wins, so ties
    go to the lower entity id and the initial ``(-inf, -1)`` slots win ties
    among ``-inf``. ``torch.topk`` promises nothing about ties, so the merge
    ranks ``ordered_keys``, which makes the order total and the result the
    same for any chunk size."""
    kk = min(k, e)
    vals = torch.full((b, kk), float("-inf"), dtype=torch.float32, device=device)
    ids = torch.full((b, kk), -1, dtype=torch.int32, device=device)
    for c0 in range(0, e, chunk):
        c1 = min(c0 + chunk, e)
        s = score_block(c0, c1).masked_fill(exclusion_mask(filt, c0, c1), float("-inf"))
        cb = torch.arange(c0, c1, dtype=torch.int32, device=device)
        allv = torch.cat([vals, s], 1)
        alli = torch.cat([ids, cb[None].expand(b, -1)], 1)
        _, sel = torch.topk(ordered_keys(allv), kk, dim=1)
        vals, ids = allv.gather(1, sel), alli.gather(1, sel)
    return vals, ids


def pairwise_topk_plain(q: torch.Tensor, ent: torch.Tensor, filt: torch.Tensor, k: int,
                        mode: str, block_e: int = 2048) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the fused top-k kernel: ``topk_scan`` over
    ``block_e``-entity blocks of ``tile_scores_plain``."""
    q = q.float()
    return topk_scan(lambda c0, c1: tile_scores_plain(q, ent[c0:c1].float(), mode),
                     q.shape[0], ent.shape[0], filt, k=k, chunk=block_e, device=q.device)


def distinct_filter(filt: torch.Tensor, num_entities: int) -> torch.Tensor:
    """(B, F) int64: each row sorted, with −1 in place of a pad, an id
    outside ``[0, num_entities)`` and every repeat of an id, so that each
    id in range that the row lists stands in it once."""
    f = filt.long()
    f = torch.where((f >= 0) & (f < num_entities), f, torch.full_like(f, -1))
    f, _ = f.sort(1)
    repeat = torch.zeros_like(f, dtype=torch.bool)
    repeat[:, 1:] = f[:, 1:] == f[:, :-1]
    return torch.where(repeat, torch.full_like(f, -1), f)


def fused_ranks_plain(q: torch.Tensor, ent: torch.Tensor, gold: torch.Tensor,
                      filt: torch.Tensor, mode: str, block_e: int = 2048) -> torch.Tensor:
    """Plain version of the fused-rank kernel, streamed over ``block_e``-entity
    blocks (the JAX package's ``lax.scan`` twin), in the kernel's two steps:
    count every entity that beats gold, then subtract each distinct filtered
    id that does, read from the same block's scores."""
    q = q.float()
    g = gold.float()[:, None]
    e = ent.shape[0]
    ids = distinct_filter(filt, e)
    counts = torch.zeros(q.shape[0], dtype=torch.int32, device=q.device)
    for c0 in range(0, e, block_e):
        c1 = min(c0 + block_e, e)
        beats = tile_scores_plain(q, ent[c0:c1].float(), mode) > g
        counts += beats.sum(1, dtype=torch.int32)
        rel = ids - c0
        here = (rel >= 0) & (rel < c1 - c0)
        filtered = beats.gather(1, torch.where(here, rel, torch.zeros_like(rel))) & here
        counts -= filtered.sum(1, dtype=torch.int32)
    return counts


def relation_groups(r: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The rows of a batch grouped by relation, on ``r``'s device and
    without a host sync: ``(order, offsets)``, int32, where ``order`` (B,)
    lists the rows by relation (a stable sort, so request order within a
    group) and ``offsets`` (B + 1,) holds each group's first position in it,
    then B from the first empty group on."""
    b = r.shape[0]
    rs, order = torch.sort(r.long(), stable=True)
    new = torch.ones(b, dtype=torch.bool, device=r.device)
    new[1:] = rs[1:] != rs[:-1]
    gid = torch.cumsum(new, 0) - 1
    offsets = torch.full((b + 1,), b, dtype=torch.int64, device=r.device)
    offsets.scatter_reduce_(0, gid, torch.arange(b, device=r.device), reduce="amin")
    return order.int(), offsets.int()


def relation_groups_host(r: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """``relation_groups`` on the host, from a numpy array of relation ids."""
    r = np.asarray(r).reshape(-1)
    b = len(r)
    order = np.argsort(r, kind="stable")
    rs = r[order]
    starts = np.flatnonzero(np.r_[True, rs[1:] != rs[:-1]]) if b else np.zeros(0, np.int64)
    offsets = np.full(b + 1, b, np.int32)
    offsets[:len(starts)] = starts
    return order.astype(np.int32), offsets


def projected_ranks_plain(ent: torch.Tensor, proj: torch.Tensor, rel: torch.Tensor,
                          fixed: torch.Tensor, gold: torch.Tensor, r: torch.Tensor,
                          filt: torch.Tensor, order: torch.Tensor, offsets: torch.Tensor,
                          side: str, block_e: int = 2048) -> torch.Tensor:
    """Plain version of the projected-rank kernel, group by group and
    ``block_e`` entities at a time: each group's queries ``fixed·M_r ± r``,
    its gold scores and every entity block projected by split-TF32 products
    (``_tf32.matmul_tf32``, the kernel's scheme), then the rows that beat
    gold and are not listed in the filter counted."""
    sign = 1.0 if side == "tail" else -1.0
    e = ent.shape[0]
    counts = torch.zeros(fixed.shape[0], dtype=torch.int32, device=ent.device)
    offs = offsets.tolist()
    for g in range(len(offs) - 1):
        p0, p1 = offs[g], offs[g + 1]
        if p0 >= p1:
            break
        rows = order[p0:p1].long()
        rid = int(r[rows[0]])
        m = proj[rid].float()
        q = matmul_tf32(ent[fixed[rows].long()], m) + sign * rel[rid].float()
        g_s = -(q - matmul_tf32(ent[gold[rows].long()], m)).abs().sum(1)
        f = filt[rows]
        got = torch.zeros(len(rows), dtype=torch.int32, device=ent.device)
        for c0 in range(0, e, block_e):
            c1 = min(c0 + block_e, e)
            s = -(q[:, None, :] - matmul_tf32(ent[c0:c1], m)[None]).abs().sum(-1)
            got += ((s > g_s[:, None]) & ~exclusion_mask(f, c0, c1)).sum(1, dtype=torch.int32)
        counts[rows] = got
    return counts


# -------------------------------------------------------------- wrappers
def pairwise_scores(q: torch.Tensor, ent: torch.Tensor, *, ord_: int = 1,
                    mode: Optional[str] = None, block_e: int = 2048) -> torch.Tensor:
    """(B, d) × (E, d) → (B, E) float32 scores. ``mode`` (l1|l2|dot|cl1)
    wins over ``ord_``. ``block_e`` sizes the plain version's blocks."""
    mode = _resolve_mode(ord_, mode)
    dev = _kernel_inputs("pairwise_scores", mode, q=q, ent=ent)
    if dev.type == "cpu":
        return pairwise_scores_plain(q, ent, mode, block_e)
    b, d = q.shape
    e = ent.shape[0]
    out = torch.empty(b, e, dtype=torch.float32, device=dev)
    if b == 0 or e == 0:
        return out
    fn, cdll = _entry(PAIRWISE_LIB, "triple_score_pairwise")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(q.data_ptr(), ent.data_ptr(), out.data_ptr(), b, e, d,
                _MODE_IDS[mode], dev.index, stream)
    _check_rc(rc, cdll, "pairwise_scores")
    LAUNCHES["pairwise_scores"] += 1
    return out


def fused_ranks(q: torch.Tensor, ent: torch.Tensor, gold: torch.Tensor,
                filt: torch.Tensor, *, mode: str = "l1",
                block_e: int = 2048) -> torch.Tensor:
    """Streaming filtered rank counts (B,) int32; filtered rank =
    ``fused_ranks(...) + 1``. ``gold`` is (B,), ``filt`` (B, F) int32 with
    pad −1; the gold id should sit in its own filter row, which makes the
    count invariant to fp noise between the gathered gold score and the
    tile's score of the same entity. ``block_e`` sizes the plain version's
    blocks; the kernel picks its own tiles."""
    mode = _resolve_mode(1, mode)
    dev = _kernel_inputs("fused_ranks", mode, q=q, ent=ent, gold=gold, filt=filt)
    b = q.shape[0]
    if gold.shape != (b,) or filt.dim() != 2 or filt.shape[0] != b:
        raise ValueError(f"fused_ranks: expected gold ({b},) and filt ({b}, F), got "
                         f"{tuple(gold.shape)} and {tuple(filt.shape)}")
    if dev.type == "cpu":
        return fused_ranks_plain(q, ent, gold, filt, mode, block_e)
    e, d = ent.shape
    out = torch.zeros(b, dtype=torch.int32, device=dev)
    if b == 0 or e == 0:
        return out
    if filt.shape[1] == 0:
        filt = torch.full((b, 1), -1, dtype=torch.int32, device=dev)
    fn, cdll = _entry(FUSED_RANKS_LIB, "triple_score_fused_ranks")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(q.data_ptr(), ent.data_ptr(), gold.data_ptr(), filt.data_ptr(),
                out.data_ptr(), b, e, d, filt.shape[1], _MODE_IDS[mode], dev.index,
                stream)
    _check_rc(rc, cdll, "fused_ranks")
    LAUNCHES["fused_ranks"] += 1
    return out


_TOPK_CAPS: Dict[Tuple[int, int, str], int] = {}


def pairwise_topk_cap(d: int, mode: str, device: torch.device) -> int:
    """The largest k the fused top-k kernel takes at row width ``d`` on a
    CUDA device: what a query tile of 8 rows holds in shared memory."""
    key = (device.index, d, mode)
    if key not in _TOPK_CAPS:
        fn, _ = _entry(TOPK_LIB, "triple_score_topk_cap")
        _TOPK_CAPS[key] = fn(d, _MODE_IDS[mode], device.index)
    return _TOPK_CAPS[key]


def pairwise_topk(q: torch.Tensor, ent: torch.Tensor, filt: torch.Tensor, *, k: int,
                  mode: str = "l1", block_e: int = 2048) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k of each query's scores over the entities its filter row does
    not list (``filt`` (B, F) int32, pad −1): ``(vals, ids)``, (B, min(k, E))
    float32 and int32, best first, ties to the lower id, places no such
    entity fills ``(-inf, -1)``: bit for bit ``topk_scan`` over
    ``pairwise_scores``. On a CUDA device one launch of the fused kernel and
    one of its merge; k above ``pairwise_topk_cap`` is refused (the scan
    takes it). ``block_e`` sizes the plain version's blocks."""
    mode = _resolve_mode(1, mode)
    dev = _kernel_inputs("pairwise_topk", mode, strict=True, q=q, ent=ent, filt=filt)
    b = q.shape[0]
    if filt.dim() != 2 or filt.shape[0] != b:
        raise ValueError(f"pairwise_topk: expected filt ({b}, F), got {tuple(filt.shape)}")
    if k < 1:
        raise ValueError(f"pairwise_topk: k must be at least 1, got {k}")
    if dev.type == "cpu":
        return pairwise_topk_plain(q, ent, filt, k, mode, block_e)
    e, d = ent.shape
    kb = min(int(k), e)
    vals = torch.empty(b, kb, dtype=torch.float32, device=dev)
    ids = torch.empty(b, kb, dtype=torch.int32, device=dev)
    if b == 0 or kb == 0:
        return vals, ids
    cap = pairwise_topk_cap(d, mode, dev)
    if kb > cap:
        raise ValueError(f"pairwise_topk: k {kb} is above the kernel's {cap} at d {d}; "
                         f"the blockwise scan takes it")
    if filt.shape[1] == 0:
        filt = torch.full((b, 1), -1, dtype=torch.int32, device=dev)
    blocks, cdll = _entry(TOPK_LIB, "triple_score_topk_blocks")
    fn, _ = _entry(TOPK_LIB, "triple_score_topk")
    nblk = ctypes.c_int(0)
    f = filt.shape[1]
    with torch.cuda.device(dev):
        rc = blocks(b, e, d, f, kb, _MODE_IDS[mode], dev.index, ctypes.byref(nblk))
        _check_rc(rc, cdll, "pairwise_topk")
        part = torch.empty(b, nblk.value, kb, dtype=torch.int64, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(q.data_ptr(), ent.data_ptr(), filt.data_ptr(), part.data_ptr(),
                vals.data_ptr(), ids.data_ptr(), b, e, d, f, kb, nblk.value,
                _MODE_IDS[mode], dev.index, stream)
    _check_rc(rc, cdll, "pairwise_topk")
    LAUNCHES["pairwise_topk"] += 1
    return vals, ids


#: the widest row the projected-rank kernel takes (its padded width)
PROJECTED_MAX_DIM = 104
#: floats of scratch a projected-rank launch takes a row: the query and the
#: gold entity projected at the padded width, and the gold score
PROJECTED_SCRATCH_PER_ROW = 2 * PROJECTED_MAX_DIM + 1


def projected_ranks(ent: torch.Tensor, proj: torch.Tensor, rel: torch.Tensor,
                    fixed: torch.Tensor, gold: torch.Tensor, r: torch.Tensor,
                    filt: torch.Tensor, *, side: str = "tail",
                    groups: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                    block_e: int = 2048) -> torch.Tensor:
    """TransR's filtered rank counts (B,) int32: for each row, the entities
    ``e`` not listed in its ``filt`` row (int32 (B, F), pad −1) whose score
    ``−‖q − e·M_r‖₁`` beats the gold score ``−‖q − g·M_r‖₁``, where
    ``q = fixed·M_r + r`` and ``g = gold`` on the ``tail`` side (fixed the
    head), ``q = fixed·M_r − r`` and ``g = gold`` the head on the ``head``
    side (fixed the tail). ``fixed``, ``gold`` and ``r`` are (B,) ids in
    request order; ``groups`` is ``relation_groups(r)`` (computed here when
    not given, without a host sync), and the counts come back in request
    order. On a CUDA device one launch of the kernel, which takes d ≤ 104;
    on the CPU the plain version, with ``block_e``-entity blocks."""
    if side not in ("tail", "head"):
        raise ValueError(f"projected_ranks: side must be 'tail' or 'head', got {side!r}")
    dev = _kernel_inputs("projected_ranks", "l1", q=rel, ent=ent, proj=proj)
    b = fixed.shape[0]
    e, d = ent.shape
    if proj.shape != (rel.shape[0], d, d):
        raise ValueError(f"projected_ranks: expected proj ({rel.shape[0]}, {d}, {d}), got "
                         f"{tuple(proj.shape)}")
    if gold.shape != (b,) or r.shape != (b,) or filt.dim() != 2 or filt.shape[0] != b:
        raise ValueError(f"projected_ranks: expected gold and r ({b},) and filt ({b}, F), got "
                         f"{tuple(gold.shape)}, {tuple(r.shape)} and {tuple(filt.shape)}")
    order, offsets = groups if groups is not None else relation_groups(r)
    if order.shape != (b,) or offsets.shape != (b + 1,):
        raise ValueError(f"projected_ranks: expected order ({b},) and offsets ({b + 1},), got "
                         f"{tuple(order.shape)} and {tuple(offsets.shape)}")
    if dev.type == "cpu":
        return projected_ranks_plain(ent, proj, rel, fixed, gold, r, filt, order, offsets,
                                     side, block_e)
    if d > PROJECTED_MAX_DIM:
        raise ValueError(f"projected_ranks: the kernel takes d <= {PROJECTED_MAX_DIM}, got {d}")
    if filt.dtype != torch.int32 or not filt.is_contiguous():
        raise TypeError("projected_ranks: filt must be contiguous int32")
    buf = torch.zeros(b + 2, dtype=torch.int32, device=dev)
    out, counters = buf[:b], buf[b:]
    if b == 0 or e == 0:
        return out
    if filt.shape[1] == 0:
        filt = torch.full((b, 1), -1, dtype=torch.int32, device=dev)
    ids = [x.to(device=dev, dtype=torch.int32).contiguous() for x in (fixed, gold, r, order,
                                                                      offsets)]
    scratch = torch.empty(b * PROJECTED_SCRATCH_PER_ROW, dtype=torch.float32, device=dev)
    fn, cdll = _entry(PROJECTED_LIB, "triple_score_projected_ranks")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(ent.data_ptr(), proj.data_ptr(), rel.data_ptr(), ids[0].data_ptr(),
                ids[1].data_ptr(), ids[2].data_ptr(), filt.data_ptr(), ids[3].data_ptr(),
                ids[4].data_ptr(), scratch.data_ptr(), counters.data_ptr(), out.data_ptr(),
                b, e, d, filt.shape[1], 0 if side == "tail" else 1, dev.index, stream)
    _check_rc(rc, cdll, "projected_ranks")
    LAUNCHES["projected_ranks"] += 1
    return out
