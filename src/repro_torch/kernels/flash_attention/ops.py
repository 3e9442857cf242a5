"""Public wrapper of the flash-attention kernel (csrc/flash_attention.cu).

``flash_attention(q, k, v, causal=, window=)`` takes the JAX package's
layout — q (B, H, S, Dh), k/v (B, KV, T, Dh) — as any strided views whose
last dimension is contiguous: the model's projections are (B, S, H, Dh), and
their ``transpose(1, 2)`` goes to the kernel without a copy. The output has
q's strides (``torch.empty_like``), so the caller's transpose back is free.

The wrapper is one operator, ``repro_torch::flash_attention``: for a CUDA
tensor it launches the kernel or raises; for a CPU tensor it takes the
plain version (``ref.attention_ref``); under ``FakeTensorMode`` (the
dry-run) it allocates the kernel's output, no (S, T) scores, and
``torch.utils.flop_counter`` counts its FLOPs. ``LAUNCHES`` counts kernel
launches, so a run can show its main path went through the kernel.

Gradients: the operator's backward (``_backward``) recomputes the plain
version under ``torch.enable_grad()`` and returns its
``torch.autograd.grad``: the gradient the JAX package takes through its jnp
attention, which has no backward kernel either.

The JAX package's LM path never reaches its Pallas kernel (its
``models/attention.py`` computes dense jnp softmax attention, or an XLA scan
above 8,192 tokens); the Pallas kernel computes the same function, and the
tests hold this port's kernel path against both.
"""
from __future__ import annotations

import ctypes
import math
from pathlib import Path
from typing import Dict

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels._nvcc import SPLIT_TF32, CudaLibrary
from repro_torch.kernels.flash_attention.ref import attention_ref

_CSRC = Path(__file__).resolve().parent / "csrc"
FLASH_LIB = CudaLibrary("flash_attention", _CSRC / "flash_attention.cu", (SPLIT_TF32,))
LIBRARIES = (FLASH_LIB,)

#: kernel launches since the last ``reset_launches``
LAUNCHES: Dict[str, int] = {"flash_attention": 0}

#: head dims the kernel is instantiated for (112: kimi-k2-1t)
HEAD_DIMS = (32, 64, 112, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_VP, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURE = ([_VP] * 4 + [_I] * 6 + [_LL] * 12
              + [_I, _I, ctypes.c_float, _I, _I, _VP])


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _entry():
    cdll = FLASH_LIB.load()
    fn = cdll.flash_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = _SIGNATURE
        fn.restype = ctypes.c_int
        cdll.flash_attention_error_string.argtypes = [ctypes.c_int]
        cdll.flash_attention_error_string.restype = ctypes.c_char_p
    return fn, cdll


def _check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.device:
    """Device of the inputs; raises on what the kernel does not take."""
    if not (q.device == k.device == v.device):
        raise ValueError(f"flash_attention: inputs on different devices "
                         f"{q.device}, {k.device}, {v.device}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: expected q (B, H, S, Dh) and k, v (B, KV, T, Dh), "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, h, _, dh = q.shape
    if k.shape[0] != b or k.shape[3] != dh or k.shape[1] == 0 or h % k.shape[1]:
        raise ValueError(f"flash_attention: k/v {tuple(k.shape)} do not fit q {tuple(q.shape)} "
                         "(same B and Dh, H a multiple of KV)")
    dev = q.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention: unsupported device {dev}")
    if dev.type == "cuda":
        if q.dtype not in _DTYPE_CODES or not (q.dtype == k.dtype == v.dtype):
            raise TypeError(f"flash_attention: q, k, v must all be float32 or bfloat16, got "
                            f"{q.dtype}, {k.dtype}, {v.dtype}")
        if dh not in HEAD_DIMS:
            raise ValueError(f"flash_attention: head dim {dh} not supported by the kernel "
                             f"({HEAD_DIMS})")
        for name, t in (("q", q), ("k", k), ("v", v)):
            if t.stride(3) != 1:
                raise ValueError(f"flash_attention: {name}'s last dimension must be contiguous")
        if b > 65_535 or h > 65_535:
            raise ValueError(f"flash_attention: B={b}, H={h} exceed the kernel's grid")
    return dev


def _outer_strides(x: torch.Tensor):
    """x's (b, h, s) strides, 0 where the dimension has one element (its
    stride is never used there)."""
    return [st if n > 1 else 0 for n, st in zip(x.shape[:3], x.stride()[:3])]


def _aligned(x: torch.Tensor) -> bool:
    """Whether the kernel's 16-byte copies can read ``x`` in place: its
    pointer and (b, h, s) strides in bytes are multiples of 16. Views that
    are not (an odd offset or stride) are copied first; the model's
    projections always are."""
    size = x.element_size()
    return x.data_ptr() % 16 == 0 and all(st * size % 16 == 0 for st in _outer_strides(x))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
                    window: int = 0) -> torch.Tensor:
    """q: (B, H, S, Dh); k/v: (B, KV, T, Dh), H % KV == 0 → (B, H, S, Dh) in
    q's dtype (fp32 math). Causal masks ``k > q``, a window ``q − k ≥
    window``; any S and T (no block divisibility). On the card Dh is one of
    ``HEAD_DIMS`` and the dtype float32 or bfloat16; under grad the output
    carries the plain version's gradient."""
    _check_inputs(q, k, v)
    return _flash(q, k, v, causal, window)


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=(), device_types="cuda")
def _flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
           window: int) -> torch.Tensor:
    """The kernel on the card; the CPU's and the fake forms are below."""
    return _launch(q, k, v, causal, window)


@_flash.register_kernel("cpu")
def _(q, k, v, causal, window):
    return attention_ref(q, k, v, causal=causal, window=window)


@_flash.register_fake
def _(q, k, v, causal, window):
    return torch.empty_like(q)


def _setup(ctx, inputs, output):
    q, k, v, ctx.causal, ctx.window = inputs
    ctx.save_for_backward(q, k, v)


def _backward(ctx, grad_out):
    """The plain version's gradient: the attention recomputed under grad."""
    q, k, v = (t.detach().requires_grad_() for t in ctx.saved_tensors)
    with torch.enable_grad():
        out = attention_ref(q, k, v, causal=ctx.causal, window=ctx.window)
    return (*torch.autograd.grad(out, (q, k, v), grad_out), None, None)


# looked up when called, so that a caller can wrap ``_backward`` (the smoke times it)
_flash.register_autograd(lambda ctx, grad_out: _backward(ctx, grad_out), setup_context=_setup)


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def _flash_flops(q_shape, k_shape, v_shape, *args, out_shape=None, **kwargs) -> int:
    """QKᵀ and PV over every (query, key) pair: 4·B·H·S·T·Dh."""
    b, h, s, dh = q_shape
    return 4 * b * h * s * k_shape[2] * dh


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
            window: int) -> torch.Tensor:
    """One launch of the kernel on checked CUDA inputs."""
    dev = q.device
    b, h, s, dh = q.shape
    kv, t = k.shape[1], k.shape[2]
    q, k, v = (x if _aligned(x) else x.clone(memory_format=torch.contiguous_format)
               for x in (q, k, v))
    out = torch.empty_like(q)
    if out.stride(3) != 1 or not _aligned(out):
        out = torch.empty(q.shape, dtype=q.dtype, device=dev)
    if b == 0 or s == 0:
        return out
    fn, cdll = _entry()
    strides = [st for x in (q, k, v, out) for st in _outer_strides(x)]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h, kv, s, t, dh,
                *strides, int(causal), int(window), 1.0 / math.sqrt(dh),
                _DTYPE_CODES[q.dtype], dev.index, stream)
    if rc != 0:
        msg = cdll.flash_attention_error_string(rc).decode()
        raise RuntimeError(f"flash_attention kernel launch failed: {msg} (cudaError {rc})")
    LAUNCHES["flash_attention"] += 1
    return out
