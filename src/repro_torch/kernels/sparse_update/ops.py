"""Public wrapper of the fused sparse SGD step (csrc/sparse_step.cu).

``fused_sparse_step`` applies one margin-ranking SGD step for TransE l1/l2
or DistMult to the {ent, rel} tables, touching only the rows the minibatch
names, and updates them **in place** (the JAX kernel aliases them in and out
for the same reason). Duplicate rows within a batch compose into one update.

For CUDA tensors it launches the kernel or raises; for CPU tensors it takes
``sparse_step_plain``, the same math in plain PyTorch. ``LAUNCHES`` counts
kernel launches, so a run can show its main path went through the kernel.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict, Tuple

import torch

from repro_torch.kernels._nvcc import CudaLibrary, build_all
from repro_torch.kernels.triple_score.ops import sqrt_rn

#: score modes of the decomposable hot path: TransE l1 / l2, DistMult
SPARSE_MODES = ("l1", "l2", "dot")
_MODE_IDS = {"l1": 0, "l2": 1, "dot": 2}

_CSRC = Path(__file__).resolve().parent / "csrc"
STEP_LIB = CudaLibrary("sparse_update_step", _CSRC / "sparse_step.cu")
LIBRARIES = (STEP_LIB,)

#: kernel launches (one per step) since the last ``reset_launches``
LAUNCHES: Dict[str, int] = {"sparse_sgd_step": 0}

_VP, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_SIGNATURE = [_VP] * 8 + [_I, _LL, _LL, _I, _F, _F, _I, _I, _VP]

#: the scatter launch stages 6B int32 ids and 8 warps' d-float accumulators
#: in shared memory, at most what a Hopper block may opt in to
_SMEM_LIMIT = 232_448


def _scatter_smem(b: int, d: int) -> int:
    return 4 * 6 * b + 4 * 8 * d


#: per-(device, stream, B, d) gradient scratch: (4B, d), (2B, d), hinges (B,).
#: Steps on one stream run in order, so one scratch serves all of them.
_SCRATCH: Dict[tuple, Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def build_kernels() -> Dict[str, str]:
    """Build the step's kernel library and return the compiler log."""
    return build_all(LIBRARIES)


def _entry():
    cdll = STEP_LIB.load()
    fn = cdll.sparse_update_step
    if fn.argtypes is None:
        fn.argtypes = _SIGNATURE
        fn.restype = ctypes.c_int
        cdll.sparse_update_error_string.argtypes = [ctypes.c_int]
        cdll.sparse_update_error_string.restype = ctypes.c_char_p
    return fn, cdll


def _check_inputs(ent, rel, pos, neg) -> torch.device:
    """Device of the inputs; raises on what the kernel does not take."""
    named = {"ent": ent, "rel": rel, "pos": pos, "neg": neg}
    devs = {t.device for t in named.values()}
    if len(devs) != 1:
        raise ValueError(f"fused_sparse_step: inputs on different devices "
                         f"{sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_sparse_step: unsupported device {dev}")
    if ent.dim() != 2 or rel.dim() != 2 or ent.shape[1] != rel.shape[1]:
        raise ValueError(f"fused_sparse_step: expected ent (E, d) and rel (R, d), got "
                         f"{tuple(ent.shape)} and {tuple(rel.shape)}")
    if pos.dim() != 2 or pos.shape[1] != 3 or neg.shape != pos.shape or pos.shape[0] == 0:
        raise ValueError(f"fused_sparse_step: expected pos and neg (B, 3) with B >= 1, got "
                         f"{tuple(pos.shape)} and {tuple(neg.shape)}")
    if dev.type == "cuda":
        b, d = pos.shape[0], ent.shape[1]
        if _scatter_smem(b, d) > _SMEM_LIMIT:
            raise ValueError(f"fused_sparse_step: B={b}, d={d} needs "
                             f"{_scatter_smem(b, d)} bytes of shared memory, over "
                             f"{_SMEM_LIMIT}")
        if max(ent.shape[0], rel.shape[0]) >= 2 ** 31:
            raise ValueError("fused_sparse_step: tables of 2**31 rows or more")
        for name, t in named.items():
            want = torch.int64 if name in ("pos", "neg") else torch.float32
            if t.dtype != want:
                raise TypeError(f"fused_sparse_step: {name} must be {want}, got {t.dtype}")
            if not t.is_contiguous():
                raise ValueError(f"fused_sparse_step: {name} must be contiguous")
    return dev


# ----------------------------------------------------------- plain version
def _margin_grads_plain(he, re, te, nhe, nre, nte, *, mode: str, margin: float):
    """(loss, entity occurrence grads (4B, d) [h | t | nh | nt], relation
    occurrence grads (2B, d) [r | nr]) of the margin ranking loss, with
    JAX's conventions: relu'(0) = 0, sign(0) = 0, L2 = sqrt(Σx² + 1e-12)."""
    b = he.shape[0]
    if mode == "dot":
        sp = (he * re * te).sum(-1)
        sn = (nhe * nre * nte).sum(-1)
    else:
        dp = he + re - te
        dn = nhe + nre - nte
        if mode == "l1":
            sp, sn = -dp.abs().sum(-1), -dn.abs().sum(-1)
            gp, gn = torch.sign(dp), torch.sign(dn)
        else:
            np_ = sqrt_rn((dp * dp).sum(-1) + 1e-12)
            nn_ = sqrt_rn((dn * dn).sum(-1) + 1e-12)
            sp, sn = -np_, -nn_
            gp, gn = dp / np_[:, None], dn / nn_[:, None]
    act = margin - sp + sn
    loss = torch.clamp(act, min=0.0).mean()
    # dL/dsp_i = −a_i, dL/dsn_i = +a_i with a_i = 1[act_i > 0]/B
    a = (act > 0).float()[:, None] / b
    if mode == "dot":
        g_e = (-a * (re * te), -a * (he * re), a * (nre * nte), a * (nhe * nre))
        g_r = (-a * (he * te), a * (nhe * nte))
    else:
        # sp = −‖he + re − te‖ ⇒ ∂sp/∂he = −g, ∂sp/∂te = +g, ∂sp/∂re = −g
        g_e = (a * gp, -a * gp, -a * gn, a * gn)
        g_r = (a * gp, -a * gn)
    return loss, torch.cat(g_e), torch.cat(g_r)


def _segment_update_(table: torch.Tensor, occ: torch.Tensor, g_occ: torch.Tensor,
                     lr: float) -> None:
    """Sum the occurrence gradients per unique row (in occurrence order) and
    write ``row -= lr·g`` once per row, in place."""
    rows, inv = torch.unique(occ, return_inverse=True)
    g = torch.zeros(len(rows), table.shape[1], dtype=table.dtype, device=table.device)
    g.index_add_(0, inv, g_occ)
    table[rows] = table[rows] - lr * g


def sparse_step_plain(ent, rel, pos, neg, lr: float, *, mode: str = "l1",
                      margin: float = 4.0) -> torch.Tensor:
    """The plain PyTorch version of the kernel: analytic gradients, then a
    segment-sum, then an in-place update of ``ent`` and ``rel``. Every row
    is gathered before any is written. Returns the loss (0-dim)."""
    he, re, te = ent[pos[:, 0]], rel[pos[:, 1]], ent[pos[:, 2]]
    nhe, nre, nte = ent[neg[:, 0]], rel[neg[:, 1]], ent[neg[:, 2]]
    loss, g_e, g_r = _margin_grads_plain(he, re, te, nhe, nre, nte, mode=mode,
                                         margin=margin)
    e_occ = torch.cat([pos[:, 0], pos[:, 2], neg[:, 0], neg[:, 2]])
    r_occ = torch.cat([pos[:, 1], neg[:, 1]])
    _segment_update_(ent, e_occ, g_e, lr)
    _segment_update_(rel, r_occ, g_r, lr)
    return loss


# ------------------------------------------------------------------ wrapper
def _scratch(dev: torch.device, stream: int, b: int, d: int):
    key = (dev, stream, b, d)
    got = _SCRATCH.get(key)
    if got is None:
        got = (torch.empty(4 * b, d, dtype=torch.float32, device=dev),
               torch.empty(2 * b, d, dtype=torch.float32, device=dev),
               torch.empty(b, dtype=torch.float32, device=dev))
        _SCRATCH[key] = got
    return got


def fused_sparse_step(ent: torch.Tensor, rel: torch.Tensor, pos: torch.Tensor,
                      neg: torch.Tensor, lr: float, *, mode: str = "l1",
                      margin: float = 4.0):
    """One fused gather→score→scatter SGD step → (ent, rel, loss): the same
    two tables, updated in place, and the minibatch loss (0-dim, on their
    device; reading it is the caller's choice of a sync).

    ``ent`` (E, d) and ``rel`` (R, d) float32; ``pos`` and ``neg`` (B, 3)
    int64 ids, which must lie in range (on the card an id out of range
    trips a device-side assert). ``lr`` and ``margin`` are floats, rounded
    to float32 as the JAX package rounds them. On the card the batch must
    fit the kernel's shared memory, 24·B + 32·d bytes ≤ 227 KB (B ≤ 9,552
    at d = 100)."""
    if mode not in SPARSE_MODES:
        raise ValueError(f"unknown sparse mode {mode!r} {SPARSE_MODES}")
    dev = _check_inputs(ent, rel, pos, neg)
    lr = float(lr)
    if dev.type == "cpu":
        return ent, rel, sparse_step_plain(ent, rel, pos, neg, lr, mode=mode, margin=margin)
    b, d = pos.shape[0], ent.shape[1]
    loss = torch.empty((), dtype=torch.float32, device=dev)
    fn, cdll = _entry()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        g_e, g_r, hinge = _scratch(dev, stream, b, d)
        rc = fn(ent.data_ptr(), rel.data_ptr(), pos.data_ptr(), neg.data_ptr(),
                g_e.data_ptr(), g_r.data_ptr(), hinge.data_ptr(), loss.data_ptr(),
                b, ent.shape[0], rel.shape[0], d, lr, float(margin), _MODE_IDS[mode],
                dev.index, stream)
    if rc != 0:
        msg = cdll.sparse_update_error_string(rc).decode()
        raise RuntimeError(f"sparse_sgd_step kernel launch failed: {msg} (cudaError {rc})")
    LAUNCHES["sparse_sgd_step"] += 1
    return ent, rel, loss
