"""Public wrappers of the Mamba2 SSD chunk kernel (csrc/ssd_chunks.cu).

``ssd_chunks(x, dt, a, bm, cm)`` is the intra-chunk part, in the layout of
the JAX package's ``ssd_chunks_fwd``: x (B, H, NC, Q, P), dt (B, H, NC, Q),
a (H,) or (H, 1), B/C (B, NC, Q, N) with one group → ``(y_intra (B, H, NC,
Q, P), chunk_state (B, H, NC, P, N), exp(cum) (B, H, NC, Q))``, all fp32.
The kernel reads its inputs through their strides, so the (B, S, H, P)
activations of the model go to it as views, without a copy.

``ssd_chunk_kernel_apply(x, dt, a, bm, cm, chunk=, state=)`` is the whole
SSD over a (B, S, H, P) sequence, as the JAX package's wrapper of the same
name: the chunk kernel, then the inter-chunk recurrence
``S_c = exp(cum_c[-1]) · S_{c−1} + chunk_state_c`` as a short loop over
chunks (the JAX wrapper's ``lax.scan`` outside the kernel) and
``y = y_intra + C · S_enter · exp(cum)`` → ``(y (B, S, H, P), final_state
(B, H, P, N))``.

``ssd_chunks`` is one operator, ``repro_torch::ssd_chunks``: for CUDA
tensors it launches the kernel or raises; for CPU tensors it takes
``ssd_chunks_plain``, the same arithmetic in plain PyTorch; under
``FakeTensorMode`` (the dry-run) it allocates the kernel's outputs, without
the plain version's per-position loop, and ``torch.utils.flop_counter``
counts its FLOPs. Its backward recomputes ``ssd_chunks_plain`` and returns
its ``torch.autograd.grad`` (under fake tensors, the shape-only operator
``repro_torch::ssd_chunks_backward``):
the gradient the JAX package takes through its jnp ``ssd``, which has no
backward kernel either. A block of the kernel serves one chunk of ``head_group`` heads and
forms C·Bᵀ once for them. Both take the in-chunk cumulative sum of
``dt · a`` in one fixed sequential order: at the full card ``cum`` reaches
about −10³ within a chunk, where a different summation order moves
``exp(cum_s − cum_t)`` by about 1e-3 relative near the diagonal.
``LAUNCHES`` counts kernel launches.

The JAX package's LM path never reaches its Pallas kernel (its
``models/ssm.py`` calls the jnp ``ssd``); the Pallas kernel computes the
same function, and the tests hold this port's kernel path against both.
"""
from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels._nvcc import SPLIT_TF32, CudaLibrary

_CSRC = Path(__file__).resolve().parent / "csrc"
SSD_LIB = CudaLibrary("ssd_chunks", _CSRC / "ssd_chunks.cu", (SPLIT_TF32,))
LIBRARIES = (SSD_LIB,)

#: kernel launches since the last ``reset_launches``
LAUNCHES: Dict[str, int] = {"ssd_chunks": 0}

#: head dims P the kernel is instantiated for; the longest chunk it takes
HEAD_DIMS = (16, 32, 64, 128)
MAX_CHUNK = 4096

_VP, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURE = [_VP] * 8 + [_I] * 7 + [_LL] * 22 + [_I, _VP]

#: shared memory a Hopper block may opt in to; the kernel's tile layout
#: (``Layout`` in csrc/ssd_chunks.cu): 64-row tiles, an S band of 256
#: columns, C/B chunks of 32, a 128-column state pass
_SMEM_LIMIT = 232_448
_TS, _LDS, _LDK, _LDB = 64, 256 + 4, 32 + 4, 128 + 8
_THREADS = 256


def smem_bytes(p: int, g: int, q: int) -> int:
    """Shared memory of one block for head dim ``p``, ``g`` heads and chunk
    ``q`` (the kernel's ``smem_floats``): the larger of the y phase (the S
    band, two C/B chunks of two buffers, two x tiles) and the state phase
    (two x and two B tiles), then cum and dt of each head and one decay row."""
    xt = _TS * (p + 8)
    y_phase = _TS * _LDS + 4 * _TS * _LDK + 2 * xt
    state_phase = 2 * xt + 2 * _TS * _LDB
    return 4 * (max(y_phase, state_phase) + (2 * g + 1) * q)


@functools.lru_cache(maxsize=None)
def head_group(b: int, h: int, nc: int, q: int, p: int, n: int, sms: int) -> int:
    """Heads per block: the G that finishes the grid (ceil(H / G), NC, B) of
    one-block-per-SM launches soonest on ``sms`` SMs. A wave costs G heads'
    products plus the C·Bᵀ band the block forms once for them (``s_cost``
    heads' worth); ties go to the smaller G. G is capped by shared memory
    (cum and dt of G heads) and the block's 256 threads (one per head sums
    cum). Cached: the LM path asks once per layer and request."""
    head = q * q / 2 * p + q * p * n          # W·x over the triangle, and the state
    s_cost = (q * q / 2 * n) / head            # C·Bᵀ over the triangle
    best, best_cost = 1, math.inf
    for g in range(1, min(h, _THREADS) + 1):
        if smem_bytes(p, g, q) > _SMEM_LIMIT:
            break
        waves = -(-(-(-h // g) * nc * b) // sms)
        cost = waves * (g + s_cost)
        if cost < best_cost:
            best, best_cost = g, cost
    return best


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _entry():
    cdll = SSD_LIB.load()
    fn = cdll.ssd_chunks_fwd
    if fn.argtypes is None:
        fn.argtypes = _SIGNATURE
        fn.restype = ctypes.c_int
        cdll.ssd_chunks_error_string.argtypes = [ctypes.c_int]
        cdll.ssd_chunks_error_string.restype = ctypes.c_char_p
    return fn, cdll


def _check_inputs(x, dt, a, bm, cm) -> torch.device:
    """Device of the inputs; raises on what the kernel does not take."""
    dev = x.device
    if not all(t.device == dev for t in (dt, a, bm, cm)):
        raise ValueError("ssd_chunks: inputs on different devices")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"ssd_chunks: unsupported device {dev}")
    if x.dim() != 5 or dt.dim() != 4 or bm.dim() != 4 or cm.shape != bm.shape:
        raise ValueError(f"ssd_chunks: expected x (B, H, NC, Q, P), dt (B, H, NC, Q), "
                         f"B/C (B, NC, Q, N); got {tuple(x.shape)}, {tuple(dt.shape)}, "
                         f"{tuple(bm.shape)}, {tuple(cm.shape)}")
    b, h, nc, q, p = x.shape
    if tuple(dt.shape) != (b, h, nc, q) or tuple(bm.shape[:3]) != (b, nc, q) \
            or a.numel() != h:
        raise ValueError(f"ssd_chunks: shapes do not agree: x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, a {tuple(a.shape)}, B/C {tuple(bm.shape)}")
    if dev.type == "cuda":
        for name, t in (("x", x), ("dt", dt), ("a", a), ("B", bm), ("C", cm)):
            if t.dtype != torch.float32:
                raise TypeError(f"ssd_chunks: {name} must be torch.float32, got {t.dtype}")
        for name, t in (("x", x), ("B", bm), ("C", cm)):
            if t.stride(-1) != 1:
                raise ValueError(f"ssd_chunks: {name}'s last dimension must be contiguous")
        if p not in HEAD_DIMS:
            raise ValueError(f"ssd_chunks: head dim P={p} not supported by the kernel "
                             f"({HEAD_DIMS})")
        if q > MAX_CHUNK:
            raise ValueError(f"ssd_chunks: chunk {q} longer than the kernel takes ({MAX_CHUNK})")
        if b > 65_535 or nc > 65_535:
            raise ValueError(f"ssd_chunks: B={b}, NC={nc} exceed the kernel's grid")
    return dev


# ----------------------------------------------------------- plain version
def sequential_cumsum(da: torch.Tensor) -> torch.Tensor:
    """Inclusive cumulative sum over the last axis, added left to right:
    ``cum[0] = da[0]``, ``cum[i] = cum[i−1] + da[i]`` — the kernel's order."""
    out = torch.empty_like(da)
    run = da[..., 0]
    out[..., 0] = run
    for i in range(1, da.shape[-1]):
        run = run + da[..., i]
        out[..., i] = run
    return out


def ssd_chunks_plain(x, dt, a, bm, cm):
    """Plain version of the kernel: the (Q, Q) decay-masked form per chunk,
    materialized. Same layout and outputs as ``ssd_chunks``."""
    x, dt, bm, cm = x.float(), dt.float(), bm.float(), cm.float()
    q = x.shape[3]
    cum = sequential_cumsum(dt * a.float().reshape(1, -1, 1, 1))        # (B,H,NC,Q)
    causal = torch.ones(q, q, dtype=torch.bool, device=x.device).tril()
    diff = torch.where(causal, cum[..., :, None] - cum[..., None, :], 0.0)
    decay = torch.where(causal, torch.exp(diff), 0.0)                  # exp only for t <= s
    scores = torch.einsum("bcsn,bctn->bcst", cm, bm)[:, None]          # (B,1,NC,Q,Q)
    w = scores * decay * dt[..., None, :]
    y = w @ x
    decay_end = torch.exp(cum[..., -1:] - cum) * dt
    state = (x * decay_end[..., None]).transpose(-1, -2) @ bm[:, None]  # (B,H,NC,P,N)
    return y, state, torch.exp(cum)


# -------------------------------------------------------------- wrappers
def _aligned_rows(t: torch.Tensor) -> bool:
    """Whether every row of ``t`` (its last, contiguous dimension) starts on
    16 bytes and can be read in whole 16-byte pieces."""
    return (t.data_ptr() % 16 == 0 and t.shape[-1] % 4 == 0
            and all(st % 4 == 0 for st in t.stride()[:-1]))


def _for_copies(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when the kernel's 16-byte copies can read its rows, else
    a contiguous copy whose rows are zero-padded to a multiple of 4."""
    if _aligned_rows(t):
        return t
    n = t.shape[-1]
    out = t.new_zeros(*t.shape[:-1], -(-n // 4) * 4)
    out[..., :n] = t
    return out


def ssd_chunks(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, bm: torch.Tensor,
               cm: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Intra-chunk SSD: (y_intra, chunk_state, exp(cum)); see the module
    docstring for the layout. On the card all inputs are float32, the last
    dimension of x, B and C contiguous, P one of ``HEAD_DIMS``; views whose
    rows the kernel's 16-byte copies cannot read are copied first. A block
    serves ``head_group``'s choice of heads."""
    _check_inputs(x, dt, a, bm, cm)
    return _ssd(x, dt, a, bm, cm)


@torch.library.custom_op("repro_torch::ssd_chunks", mutates_args=(), device_types="cuda")
def _ssd(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, bm: torch.Tensor,
         cm: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernel on the card; the CPU's and the fake forms are below."""
    return _launch(x, dt, a, bm, cm)


@_ssd.register_kernel("cpu")
def _(x, dt, a, bm, cm):
    return ssd_chunks_plain(x, dt, a, bm, cm)


@_ssd.register_fake
def _(x, dt, a, bm, cm):
    b, h, nc, q, p = x.shape
    f32 = dict(dtype=torch.float32)
    return (x.new_empty((b, h, nc, q, p), **f32), x.new_empty((b, h, nc, p, bm.shape[-1]), **f32),
            x.new_empty((b, h, nc, q), **f32))


@torch.library.custom_op("repro_torch::ssd_chunks_backward", mutates_args=())
def _ssd_backward(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, bm: torch.Tensor,
                  cm: torch.Tensor, gy: torch.Tensor, gs: torch.Tensor, gd: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
                             torch.Tensor]:
    """The gradient's shape-only form: under fake tensors (the dry-run) it
    gives the gradients' shapes and FLOPs without the plain version's
    per-position loop. Real tensors take ``_backward``'s plain gradient."""
    raise RuntimeError("ssd_chunks_backward is shape-only: real tensors take _backward")


@_ssd_backward.register_fake
def _(x, dt, a, bm, cm, gy, gs, gd):
    return tuple(torch.empty_like(t) for t in (x, dt, a, bm, cm))


def _setup(ctx, inputs, output):
    ctx.save_for_backward(*inputs)
    ctx.out_shapes = [o.shape for o in output]


def _backward(ctx, gy, gs, gd):
    """The plain version's gradient, recomputed under grad (autograd does not
    run inside an operator, so not as one)."""
    saved = ctx.saved_tensors
    grads = [g if g is not None else saved[0].new_zeros(shape, dtype=torch.float32)
             for g, shape in zip((gy, gs, gd), ctx.out_shapes)]
    if isinstance(saved[0], FakeTensor):
        return _ssd_backward(*saved, *grads)
    ins = [t.detach().requires_grad_() for t in saved]
    with torch.enable_grad():
        outs = ssd_chunks_plain(*ins)
    return torch.autograd.grad(outs, ins, grads)


_ssd.register_autograd(_backward, setup_context=_setup)


def _ssd_flops(x_shape, bm_shape) -> int:
    """C·Bᵀ per chunk (2·B·NC·Q²·N), its product with x (2·B·H·NC·Q²·P)
    and the chunk states (2·B·H·NC·Q·P·N)."""
    b, h, nc, q, p = x_shape
    n = bm_shape[-1]
    return 2 * b * nc * q * q * n + 2 * b * h * nc * q * q * p + 2 * b * h * nc * q * p * n


@register_flop_formula(torch.ops.repro_torch.ssd_chunks)
def _(x_shape, dt_shape, a_shape, bm_shape, cm_shape, *args, out_shape=None, **kwargs) -> int:
    return _ssd_flops(x_shape, bm_shape)


@register_flop_formula(torch.ops.repro_torch.ssd_chunks_backward)
def _(x_shape, dt_shape, a_shape, bm_shape, *args, out_shape=None, **kwargs) -> int:
    return 2 * _ssd_flops(x_shape, bm_shape)  # each product's two transposes


def _launch(x, dt, a, bm, cm):
    """One launch of the kernel on checked CUDA inputs."""
    dev = x.device
    b, h, nc, q, p = x.shape
    n = bm.shape[-1]
    # outputs in the (B, S, H, ·) order of the activations, seen as the Pallas layout
    y = torch.empty(b, nc, q, h, p, dtype=torch.float32, device=dev).permute(0, 3, 1, 2, 4)
    state = torch.empty(b, h, nc, p, n, dtype=torch.float32, device=dev)
    decay = torch.empty(b, nc, q, h, dtype=torch.float32, device=dev).permute(0, 3, 1, 2)
    if b * h * nc == 0:
        return y, state, decay
    group = head_group(b, h, nc, q, p, n, _sm_count(dev.index))
    x, bm, cm = _for_copies(x), _for_copies(bm), _for_copies(cm)
    a = a.reshape(h).contiguous()
    strides = [*x.stride()[:4], *dt.stride(), *bm.stride()[:3], *cm.stride()[:3],
               *y.stride()[:4], *decay.stride()]
    fn, cdll = _entry()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(x.data_ptr(), dt.data_ptr(), a.data_ptr(), bm.data_ptr(), cm.data_ptr(),
                y.data_ptr(), state.data_ptr(), decay.data_ptr(), b, h, nc, q, p, n, group,
                *strides, dev.index, stream)
    if rc != 0:
        msg = cdll.ssd_chunks_error_string(rc).decode()
        raise RuntimeError(f"ssd_chunks kernel launch failed: {msg} (cudaError {rc})")
    LAUNCHES["ssd_chunks"] += 1
    return y, state, decay


def ssd_chunk_kernel_apply(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                           bm: torch.Tensor, cm: torch.Tensor, *, chunk: int = 256,
                           state: Optional[torch.Tensor] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The whole SSD: x (B, S, H, P), dt (B, S, H), a (H,), B/C (B, S, 1, N),
    optional initial state (B, H, P, N) → (y (B, S, H, P) fp32, final state
    (B, H, P, N)). S must be a multiple of ``min(chunk, S)``."""
    b, s, h, p = x.shape
    g, n = bm.shape[2], bm.shape[3]
    if g != 1:
        raise NotImplementedError(f"the SSD kernel takes one group (n_groups=1), got {g}")
    q = min(chunk, s)
    if q == 0 or s % q:
        raise ValueError(f"sequence {s} is not a multiple of the chunk {q}")
    nc = s // q
    xg = x.reshape(b, nc, q, h, p).permute(0, 3, 1, 2, 4)   # (B,H,NC,Q,P), a view
    dtg = dt.reshape(b, nc, q, h).permute(0, 3, 1, 2)        # (B,H,NC,Q)
    bg = bm.reshape(b, nc, q, n)
    cg = cm.reshape(b, nc, q, n)
    y_intra, chunk_states, decay_in = ssd_chunks(xg, dtg, a, bg, cg)

    # inter-chunk recurrence, emitting the state entering each chunk
    total_decay = decay_in[..., -1]                          # (B,H,NC)
    run = (state.float() if state is not None
           else torch.zeros(b, h, p, n, dtype=torch.float32, device=x.device))
    entering = []
    for c in range(nc):
        entering.append(run)
        run = run * total_decay[:, :, c, None, None] + chunk_states[:, :, c]
    ent = torch.stack(entering, dim=2)                       # (B,H,NC,P,N)
    y_inter = torch.einsum("bcqn,bhcpn->bhcqp", cg.float(), ent)
    y = y_intra + y_inter * decay_in[..., None]
    return y.permute(0, 2, 3, 1, 4).reshape(b, s, h, p), run
