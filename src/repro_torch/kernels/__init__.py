# Hand-written CUDA kernels for Hopper (sm_90a), one package per kernel
# family, each with: csrc/ (the CUDA sources), ops.py (the wrappers: the
# kernel for CUDA tensors, the plain PyTorch version for CPU tensors, launch
# counters) and ref.py (materializing oracles the tests assert against).
# _nvcc.py builds each source into a shared library with a plain C interface
# and loads it with ctypes; dispatch.py resolves devices and serving knobs.
#
#   triple_score  — pairwise (B, E) scores and the filtered fused-rank count
#   sparse_update — the fused margin-SGD step, in place on {ent, rel}
#   csls          — the cosine matrix behind CSLS, rows normalised in the tile
#   flash_attention — blocked online-softmax attention (causal, window, GQA)
#                     for the LM's prefill
#   ssd_scan        — the Mamba2 SSD intra-chunk product and chunk states
