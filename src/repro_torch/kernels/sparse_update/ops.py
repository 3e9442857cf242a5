"""Public wrappers of the fused sparse SGD kernel (csrc/sparse_step.cu).

``fused_sparse_epoch`` applies ``nb`` consecutive margin-ranking SGD steps
for TransE l1/l2 or DistMult to the {ent, rel} tables over pre-built
``(nb, B, 3)`` batches -- the JAX package's ``lax.scan`` of its Pallas step
-- touching only the rows each minibatch names, and updates them **in
place** (the JAX kernel aliases them in and out for the same reason).
Duplicate rows within a batch compose into one update; step i + 1 sees the
rows step i wrote. ``fused_sparse_step`` is the ``nb = 1`` case.

For CUDA tensors they launch the kernel (one launch for the whole epoch) or
raise; for CPU tensors they take ``sparse_epoch_plain`` / ``sparse_step_plain``,
the same math in plain PyTorch. ``LAUNCHES`` counts kernel launches and
``STEPS`` the steps they ran, so a run can show its main path went through
the kernel.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict

import torch

from repro_torch.kernels._nvcc import CudaLibrary, build_all
from repro_torch.kernels.triple_score.ops import sqrt_rn

#: score modes of the decomposable hot path: TransE l1 / l2, DistMult
SPARSE_MODES = ("l1", "l2", "dot")
_MODE_IDS = {"l1": 0, "l2": 1, "dot": 2}

_CSRC = Path(__file__).resolve().parent / "csrc"
STEP_LIB = CudaLibrary("sparse_update_step", _CSRC / "sparse_step.cu")
LIBRARIES = (STEP_LIB,)

#: kernel launches (one per epoch, or per lone step) since the last ``reset_launches``
LAUNCHES: Dict[str, int] = {"sparse_sgd_step": 0}
#: SGD steps those launches ran
STEPS: Dict[str, int] = {"sparse_sgd_step": 0}

#: blocks of the one thread-block cluster an epoch runs on (the kernel's
#: ``CLUSTER``): 16, which needs the non-portable opt-in (the kernel makes
#: it), measured faster than the portable 8 on the H100 (PERF.md)
CLUSTER_BLOCKS = 16
#: the shared memory a Hopper block may opt in to
_SMEM_LIMIT = 232_448

_VP, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_SIGNATURE = [_VP] * 5 + [_I, _I, _LL, _LL, _I, _F, _F, _I, _I, _VP]


def smem_bytes(b: int, d: int) -> int:
    """Shared memory of one block of the cluster (the kernel's
    ``smem_bytes``): the next step's ids (int64), the block's gradient rows
    and the rows it gathered, its hinges, and for every occurrence its id,
    where it sits in a step's ids and its place among the rows."""
    rpb = -(-b // CLUSTER_BLOCKS)
    return 20 * 6 * b + 4 * 12 * rpb * d + 4 * rpb


def check_batch(b: int, d: int) -> None:
    """Raises unless a batch of ``b`` rows of width ``d`` fits the
    cluster's shared memory."""
    if smem_bytes(b, d) > _SMEM_LIMIT:
        raise ValueError(f"fused_sparse_epoch: B={b}, d={d} needs {smem_bytes(b, d)} bytes "
                         f"of shared memory per block, over {_SMEM_LIMIT}")


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
        STEPS[k] = 0


def build_kernels() -> Dict[str, str]:
    """Build the step's kernel library and return the compiler log."""
    return build_all(LIBRARIES)


def _entry():
    cdll = STEP_LIB.load()
    fn = cdll.sparse_update_epoch
    if fn.argtypes is None:
        fn.argtypes = _SIGNATURE
        fn.restype = ctypes.c_int
        cdll.sparse_update_error_string.argtypes = [ctypes.c_int]
        cdll.sparse_update_error_string.restype = ctypes.c_char_p
    return fn, cdll


def _check_inputs(ent, rel, pos, neg, what: str) -> torch.device:
    """Device of the inputs; raises on what the kernel does not take.
    ``pos`` and ``neg`` are (nb, B, 3)."""
    named = {"ent": ent, "rel": rel, "pos": pos, "neg": neg}
    devs = {t.device for t in named.values()}
    if len(devs) != 1:
        raise ValueError(f"{what}: inputs on different devices {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {dev}")
    if ent.dim() != 2 or rel.dim() != 2 or ent.shape[1] != rel.shape[1]:
        raise ValueError(f"{what}: expected ent (E, d) and rel (R, d), got "
                         f"{tuple(ent.shape)} and {tuple(rel.shape)}")
    if dev.type == "cuda":
        if max(ent.shape[0], rel.shape[0]) >= 2 ** 31:
            raise ValueError(f"{what}: tables of 2**31 rows or more")
        for name, t in named.items():
            want = torch.int64 if name in ("pos", "neg") else torch.float32
            if t.dtype != want:
                raise TypeError(f"{what}: {name} must be {want}, got {t.dtype}")
            if not t.is_contiguous():
                raise ValueError(f"{what}: {name} must be contiguous")
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


def sparse_epoch_plain(ent, rel, pos, neg, lr: float, *, mode: str = "l1",
                       margin: float = 4.0) -> torch.Tensor:
    """The plain version of an epoch: ``sparse_step_plain`` over each of the
    ``nb`` batches of ``pos`` and ``neg`` (nb, B, 3) in turn, in place.
    Returns the step losses (nb,)."""
    return torch.stack([sparse_step_plain(ent, rel, pos[i], neg[i], lr, mode=mode,
                                          margin=margin) for i in range(pos.shape[0])])


# ------------------------------------------------------------------ wrappers
def fused_sparse_epoch(ent: torch.Tensor, rel: torch.Tensor, pos: torch.Tensor,
                       neg: torch.Tensor, lr: float, *, mode: str = "l1",
                       margin: float = 4.0) -> torch.Tensor:
    """``nb`` fused gather→score→scatter SGD steps in one launch → the step
    losses (nb,), on the tables' device (reading them is the caller's choice
    of a sync). ``ent`` and ``rel`` are updated in place.

    ``ent`` (E, d) and ``rel`` (R, d) float32; ``pos`` and ``neg`` (nb, B, 3)
    int64 ids, which must lie in range (on the card an id out of range
    trips a device-side assert). ``lr`` and ``margin`` are floats, rounded
    to float32 as the JAX package rounds them. On the card the epoch runs on
    one cluster of ``CLUSTER_BLOCKS`` blocks, and the batch must fit its
    shared memory: 48·d·⌈B/16⌉ + 120·B bytes per block ≤ 227 KB, so
    B ≤ 544 at d = 100 (the trainer takes 100). Past that the wrapper
    raises."""
    if mode not in SPARSE_MODES:
        raise ValueError(f"unknown sparse mode {mode!r} {SPARSE_MODES}")
    if pos.dim() != 3 or pos.shape[2] != 3 or neg.shape != pos.shape or 0 in pos.shape[:2]:
        raise ValueError(f"fused_sparse_epoch: expected pos and neg (nb, B, 3) with nb, B >= 1,"
                         f" got {tuple(pos.shape)} and {tuple(neg.shape)}")
    dev = _check_inputs(ent, rel, pos, neg, "fused_sparse_epoch")
    lr = float(lr)
    if dev.type == "cpu":
        return sparse_epoch_plain(ent, rel, pos, neg, lr, mode=mode, margin=margin)
    nb, b = pos.shape[:2]
    d = ent.shape[1]
    check_batch(b, d)
    losses = torch.empty(nb, dtype=torch.float32, device=dev)
    fn, cdll = _entry()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(ent.data_ptr(), rel.data_ptr(), pos.data_ptr(), neg.data_ptr(),
                losses.data_ptr(), nb, b, ent.shape[0], rel.shape[0], d, lr, float(margin),
                _MODE_IDS[mode], dev.index, stream)
    if rc != 0:
        msg = cdll.sparse_update_error_string(rc).decode()
        raise RuntimeError(f"sparse_sgd_step kernel launch failed: {msg} (cudaError {rc})")
    LAUNCHES["sparse_sgd_step"] += 1
    STEPS["sparse_sgd_step"] += nb
    return losses


def fused_sparse_step(ent: torch.Tensor, rel: torch.Tensor, pos: torch.Tensor,
                      neg: torch.Tensor, lr: float, *, mode: str = "l1",
                      margin: float = 4.0):
    """One fused step → (ent, rel, loss): the same two tables, updated in
    place, and the minibatch loss (0-dim, on their device). ``pos`` and
    ``neg`` are (B, 3); on the card this is ``fused_sparse_epoch`` with
    nb = 1, one launch, and the same limits on B."""
    if mode not in SPARSE_MODES:
        raise ValueError(f"unknown sparse mode {mode!r} {SPARSE_MODES}")
    if pos.dim() != 2 or pos.shape[1] != 3 or neg.shape != pos.shape or pos.shape[0] == 0:
        raise ValueError(f"fused_sparse_step: expected pos and neg (B, 3) with B >= 1, got "
                         f"{tuple(pos.shape)} and {tuple(neg.shape)}")
    if pos.device.type == "cpu":
        _check_inputs(ent, rel, pos, neg, "fused_sparse_step")
        return ent, rel, sparse_step_plain(ent, rel, pos, neg, float(lr), mode=mode,
                                           margin=margin)
    losses = fused_sparse_epoch(ent, rel, pos[None], neg[None], lr, mode=mode, margin=margin)
    return ent, rel, losses[0]
