"""A plain PyTorch emulation of the split-TF32 ("3xTF32") products that the
cosine, flash-attention and projected-rank kernels run on the tensor cores
(``include/split_tf32.cuh``), so the scheme's accuracy can be checked where
there is no card. The tests use it, and the projected-rank kernel's plain
version (``triple_score.ops.projected_ranks_plain``) projects with it.

``tf32_rna`` is ``cvt.rna.tf32.f32``: add 0x1000 to the bit pattern, then
clear the low 13 bits (round to nearest, ties away from zero, to a 10-bit
mantissa). ``split`` forms ``hi = tf32_rna(x)`` from x clamped to the
largest float whose rounding stays finite, as the kernels do, and
``lo = tf32_rna(x − hi)``. ``matmul_tf32`` multiplies with three TF32
products (or one, ``terms=1``) in 8-wide k-steps, the shape of one
``mma.m16n8k8``: each step's exact partial products are summed, rounded to
fp32 and added to an fp32 accumulator.
"""
from __future__ import annotations

import torch

#: 0x7F7FEFFF, the largest float that ``tf32_rna`` does not round to infinity
HI_CLAMP = torch.tensor(0x7F7FEFFF, dtype=torch.int32).view(torch.float32).item()


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (kept as float32), as ``cvt.rna.tf32.f32``."""
    u = x.float().contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    r = (u + 0x1000) & 0xFFFFE000
    r = torch.where(r >= 2 ** 31, r - 2 ** 32, r)
    return r.to(torch.int32).view(torch.float32)


def split(x: torch.Tensor):
    """(hi, lo), both TF32, with hi + lo = x to 2^-22 of |x|."""
    x = x.float()
    hi = tf32_rna(x.clamp(-HI_CLAMP, HI_CLAMP))
    return hi, tf32_rna(x - hi)


def matmul_tf32(a: torch.Tensor, b: torch.Tensor, *, terms: int = 3) -> torch.Tensor:
    """a (..., n, k) @ b (..., k, m) in fp32 through TF32 products: ``terms``
    3 is lo·hi + hi·lo + hi·hi (the kernels' order), 1 is hi·hi alone."""
    ah, al = split(a)
    bh, bl = split(b)
    pairs = ((al, bh), (ah, bl), (ah, bh)) if terms == 3 else ((ah, bh),)
    acc = torch.zeros(*a.shape[:-1], b.shape[-1], dtype=torch.float32, device=a.device)
    for k0 in range(0, a.shape[-1], 8):
        for x, y in pairs:
            step = x[..., k0:k0 + 8].double() @ y[..., k0:k0 + 8, :].double()
            acc = acc + step.float()
    return acc
