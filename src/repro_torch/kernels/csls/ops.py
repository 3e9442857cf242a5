"""Public wrappers of the CSLS cosine kernel (csrc/cosine_matrix.cu).

``cosine_matrix`` — (n, d) × (m, d) → (n, m) cosine similarities, the rows'
L2 normalisation fused into the tile. ``csls_matrix`` adds the top-k means,
``2·cos − r_A − r_B``, in PyTorch around it, as the JAX package's wrapper
does in XLA around its Pallas kernel.

For a CUDA tensor ``cosine_matrix`` launches the kernel or raises; for a CPU
tensor it takes ``cosine_matrix_plain``, the same arithmetic in plain
PyTorch. ``LAUNCHES`` counts kernel launches, so a run can show its main
path went through the kernel.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict

import torch

from repro_torch.kernels._nvcc import SPLIT_TF32, CudaLibrary, build_all
from repro_torch.kernels.triple_score.ops import sqrt_rn

_CSRC = Path(__file__).resolve().parent / "csrc"
COSINE_LIB = CudaLibrary("csls_cosine", _CSRC / "cosine_matrix.cu", (SPLIT_TF32,))
LIBRARIES = (COSINE_LIB,)

#: kernel launches since the last ``reset_launches``
LAUNCHES: Dict[str, int] = {"cosine_matrix": 0}

#: a block of the kernel owns 128 rows of ``a``; its grid holds at most 65,535 of them
_MAX_ROWS = 65_535 * 128

_VP, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURE = [_VP, _VP, _VP, _I, _I, _I, _I, _VP]


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def build_kernels() -> Dict[str, str]:
    """Build the cosine kernel's library and return the compiler log."""
    return build_all(LIBRARIES)


def _entry():
    cdll = COSINE_LIB.load()
    fn = cdll.csls_cosine_matrix
    if fn.argtypes is None:
        fn.argtypes = _SIGNATURE
        fn.restype = ctypes.c_int
        cdll.csls_error_string.argtypes = [ctypes.c_int]
        cdll.csls_error_string.restype = ctypes.c_char_p
    return fn, cdll


def _check_inputs(a: torch.Tensor, b: torch.Tensor) -> torch.device:
    """Device of the inputs; raises on what the kernel does not take."""
    if a.device != b.device:
        raise ValueError(f"cosine_matrix: inputs on different devices {a.device}, {b.device}")
    dev = a.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"cosine_matrix: unsupported device {dev}")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[1]:
        raise ValueError(f"cosine_matrix: expected a (n, d) and b (m, d), got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if dev.type == "cuda":
        for name, t in (("a", a), ("b", b)):
            if t.dtype != torch.float32:
                raise TypeError(f"cosine_matrix: {name} must be torch.float32, got {t.dtype}")
            if not t.is_contiguous():
                raise ValueError(f"cosine_matrix: {name} must be contiguous")
        if a.shape[0] > _MAX_ROWS:
            raise ValueError(f"cosine_matrix: {a.shape[0]} rows of a are more than one "
                             f"launch takes ({_MAX_ROWS}); split them")
    return dev


# ----------------------------------------------------------- plain version
def _inv_norms(x: torch.Tensor) -> torch.Tensor:
    """``1 / sqrt_rn(Σx² + 1e-18)`` per row (0 rows give 1e9, so a zero
    row's cosines are exactly 0)."""
    return 1.0 / sqrt_rn((x * x).sum(1) + 1e-18)


def cosine_matrix_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version of the kernel: raw dot products scaled by both rows'
    inverse norms, ``dot · inv_a · inv_b``."""
    a, b = a.float(), b.float()
    return (a @ b.T) * _inv_norms(a)[:, None] * _inv_norms(b)[None, :]


# -------------------------------------------------------------- wrappers
def cosine_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(n, d) × (m, d) → (n, m) float32 cosines. On the card ``a`` and ``b``
    are contiguous float32 and ``n`` ≤ 8,388,480 (split larger sets)."""
    dev = _check_inputs(a, b)
    if dev.type == "cpu":
        return cosine_matrix_plain(a, b)
    n, d = a.shape
    m = b.shape[0]
    out = torch.empty(n, m, dtype=torch.float32, device=dev)
    if n == 0 or m == 0:
        return out
    fn, cdll = _entry()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), n, m, d, dev.index, stream)
    if rc != 0:
        msg = cdll.csls_error_string(rc).decode()
        raise RuntimeError(f"cosine_matrix kernel launch failed: {msg} (cudaError {rc})")
    LAUNCHES["cosine_matrix"] += 1
    return out


def topk_means(sim: torch.Tensor, k: int):
    """(r_A (n,), r_B (m,)): each row's and each column's mean of its top
    ``min(k, ·)`` similarities — the CSLS neighbourhood terms."""
    kk = min(k, sim.shape[1])
    kk2 = min(k, sim.shape[0])
    r_a = torch.topk(sim, kk, dim=1).values.mean(1)
    r_b = torch.topk(sim, kk2, dim=0).values.mean(0)
    return r_a, r_b


def csls_matrix(a: torch.Tensor, b: torch.Tensor, *, k: int = 10) -> torch.Tensor:
    """CSLS(a_i, b_j) = 2·cos − r_A − r_B, cosine tiles through the kernel."""
    sim = cosine_matrix(a, b)
    r_a, r_b = topk_means(sim, k)
    return 2 * sim - r_a[:, None] - r_b[None, :]
