"""PyTorch/CUDA port of the FKGE system.

The package mirrors the JAX package's layout (``kge/``, ``core/``,
``serving/``, ``kernels/``, ``configs/``, ``data/``, ``models/``,
``launch/``) so each module's counterpart is easy to find.
Plain tensor code is PyTorch; every kernel that the JAX package wrote in
Pallas for the TPU is a CUDA C++ kernel for Hopper (``sm_90a``), built from
the sources under ``kernels/*/csrc`` at first use on a CUDA tensor.

Entry points run on the GPU unless the caller passes ``device="cpu"``; with
no CUDA device and no explicit CPU request they raise
(``kernels.dispatch.resolve_device``). On CPU tensors every kernel wrapper
takes its plain PyTorch version, which is what the CPU tests exercise.

Ported so far: ``serving.KGEServingTier`` answers filtered-rank and top-k
queries through the two ``triple_score`` kernels; ``kge.KGETrainer`` trains
locally through the ``sparse_update`` kernel, and ``kge.link_prediction`` /
``kge.triple_classification_accuracy`` score the trained tables; ``core``
runs the PPAT handshake (``train_ppat`` with PATE votes and the moments
accountant), its CSLS quality metric through the ``csls`` cosine kernel,
and the KGEmb update with the virtual extension; ``serving.ServingEngine``
serves decoder-only LM cards (``models.CausalLM``: qwen3-0.6b, mamba2-2.7b
and the other dense cards) with prefill attention through the
``flash_attention`` kernel and the Mamba2 SSD through the ``ssd_scan``
kernel — the JAX package's LM path computes both functions in jnp and never
calls its Pallas kernels, so the port adds no feature the JAX package lacks.
"""
from repro_torch.core import (  # noqa: F401
    AlignmentRegistry,
    MomentsAccountant,
    PPATClient,
    PPATConfig,
    PPATHost,
    csls,
    kgemb_update,
    pate_vote,
    teacher_votes,
    train_ppat,
    virtual_extension,
)
