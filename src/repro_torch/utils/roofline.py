"""Roofline terms from dry-run results, with NVIDIA H100 SXM data-sheet
rates — the port of the JAX package's ``utils/roofline.py``, whose
constants are a TPU v5e's.

    compute_s    = FLOPs / (chips × peak FLOP/s)
    memory_s     = HBM bytes / (chips × HBM bytes/s)
    collective_s = collective bytes per rank / link bytes/s

Two variants are reported:

* **raw** — the FLOPs the dry-run counted on one rank
  (``torch.utils.flop_counter``'s formulas over the rank's own operators)
  and the rank's live-tensor peak standing in for HBM traffic.
* **corrected** — FLOPs and HBM bytes from the analytic per-architecture
  cost model below (6·N·D-style, plus the attention and SSD quadratic
  terms), copied from the reference as it is, and the collective bytes the
  dry-run counted. The port's count already includes every trip of every
  loop (the layers and microbatches are Python loops), which is what the
  reference's loop-aware HLO walk reconstructs.

The bottleneck verdict uses the corrected terms. MODEL_FLOPS = 6·N·D
(dense) or 6·N_active·D (MoE); useful-FLOPs ratio = MODEL_FLOPS /
corrected executed FLOPs.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

# NVIDIA H100 SXM5 data sheet (dense, without sparsity; at the 700 W limit)
PEAK_FLOPS = 989e12   # BF16 tensor-core FLOP/s
HBM_BW = 3.35e12      # HBM3 bytes/s
# Links (NVIDIA DGX H100 data sheet): NVLink 4 gives each GPU 450 GB/s a
# direction inside its 8-GPU node; between nodes each GPU has one 400 Gb/s
# ConnectX-7 InfiniBand port, 50 GB/s. A 16-wide mesh axis spans two nodes,
# so its collectives run at the InfiniBand rate.
NVLINK_BW = 450e9
IB_BW = 50e9
NVLINK_DOMAIN = 8     # GPUs per NVLink node


class PeakRates(NamedTuple):
    """A card's data-sheet rates: HBM bytes/s, fp32 FLOP/s outside the
    tensor cores, dense TF32 and dense BF16 FLOP/s on the tensor cores."""
    bytes: float
    fp32: float
    tf32: float
    bf16: float


def peak_rates(name: str) -> PeakRates:
    """The data-sheet rates of the card ``name`` (as ``nvidia-smi`` or
    ``torch.cuda.get_device_name`` give it): H100 SXM unless it says PCIe
    or H200."""
    if "PCIe" in name or "PCIE" in name:
        return PeakRates(2.0e12, 51.2e12, 378e12, 756e12)
    if "H200" in name:
        return PeakRates(4.8e12, 67e12, 495e12, 989e12)
    return PeakRates(HBM_BW, 67e12, 495e12, PEAK_FLOPS)


def link_bandwidth(ranks: int) -> float:
    """Bytes/s of the slowest link a group of ``ranks`` GPUs crosses."""
    return NVLINK_BW if ranks <= NVLINK_DOMAIN else IB_BW


def model_flops(cfg, shape) -> float:
    """6·N·D with N = active params, D = tokens processed by the step."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch  # one token per sequence


def _attn_flops_fwd(cfg, b: int, s: int, cache: int = 0) -> float:
    """Score+context matmul FLOPs for ALL attention layers, forward, global."""
    n_attn = sum(cfg.is_attn_layer(i) for i in range(cfg.num_layers))
    h, dh = cfg.num_heads, cfg.head_dim
    if cache:  # decode: one query against the cache
        eff = min(cache, cfg.sliding_window) if cfg.sliding_window else cache
        per_layer = 4.0 * b * eff * h * dh
    else:
        eff = min(s, cfg.sliding_window) if cfg.sliding_window else s
        per_layer = 2.0 * b * s * eff * h * dh  # causal ≈ half of 4·B·S·eff
    total = n_attn * per_layer
    if cfg.encoder_layers and not cache:
        se = cfg.encoder_seq
        total += cfg.encoder_layers * 4.0 * b * se * se * h * dh  # bidirectional
        total += cfg.num_layers * 4.0 * b * s * se * h * dh  # cross-attn
    return total


def _ssd_flops_fwd(cfg, b: int, s: int) -> float:
    if not cfg.ssm.enabled:
        return 0.0
    n_ssm = sum(
        (not cfg.is_attn_layer(i)) for i in range(cfg.num_layers)
    ) if cfg.arch_type in ("ssm", "hybrid") else 0
    if not n_ssm:
        return 0.0
    q = cfg.ssm.chunk_size
    h = cfg.ssm.num_heads(cfg.d_model)
    p = cfg.ssm.head_dim
    n = cfg.ssm.d_state
    # per chunk: scores 2Q²N + y 2Q²PH + state 2QPNH ; chunks = S/Q
    per_tok = 2.0 * q * n + 2.0 * q * p * h + 2.0 * p * n * h
    return n_ssm * b * s * per_tok


def analytic_cost(cfg, shape) -> Tuple[float, float]:
    """→ (executed FLOPs, HBM bytes) for the whole step, global (all chips)."""
    b, s = shape.global_batch, shape.seq_len
    p_active = cfg.active_param_count()
    p_total = cfg.param_count()
    v_d = cfg.padded_vocab * cfg.d_model
    n_eff = p_active - (0 if cfg.tie_embeddings else v_d)  # input gather ≉ matmul
    dt_bytes = 2  # bf16 params/activations

    if shape.kind == "train":
        tokens = b * s
        fwd = 2.0 * n_eff * tokens + _attn_flops_fwd(cfg, b, s) + _ssd_flops_fwd(cfg, b, s)
        mult = 3.0 + (1.0 if cfg.remat else 0.0)  # fwd + 2×bwd (+ remat refwd)
        flops = fwd * mult
        # HBM: weights re-read every microbatch for fwd/bwd/remat; moments;
        # activation residual traffic ~12·d bytes/token/layer each direction.
        m = 16  # default microbatches (launch/workloads.default_train_config)
        traffic_params = p_total * dt_bytes * m * mult
        opt = p_total * (4 + 4 + 4 + 2) * 2.0  # mu,nu,grad read+write, param rw
        act = tokens * cfg.d_model * cfg.num_layers * 12 * dt_bytes
        return flops, traffic_params + opt + act
    if shape.kind == "prefill":
        tokens = b * s
        flops = 2.0 * n_eff * tokens + _attn_flops_fwd(cfg, b, s) + _ssd_flops_fwd(cfg, b, s)
        cache_bytes = _cache_bytes(cfg, b, s, dt_bytes)
        act = tokens * cfg.d_model * cfg.num_layers * 8 * dt_bytes
        return flops, p_total * dt_bytes + cache_bytes + act
    # decode: one token, cache length = shape.seq_len
    flops = 2.0 * n_eff * b + _attn_flops_fwd(cfg, b, 1, cache=s)
    cache_bytes = _cache_bytes(cfg, b, s, dt_bytes)
    return flops, p_total * dt_bytes + cache_bytes


def _cache_bytes(cfg, b: int, s: int, dt_bytes: int) -> float:
    n_attn = sum(cfg.is_attn_layer(i) for i in range(cfg.num_layers))
    kv = 2.0 * b * s * cfg.num_kv_heads * cfg.head_dim * dt_bytes * n_attn
    ssm = 0.0
    if cfg.ssm.enabled and cfg.arch_type in ("ssm", "hybrid"):
        n_ssm = cfg.num_layers - n_attn
        h = cfg.ssm.num_heads(cfg.d_model)
        ssm = b * h * cfg.ssm.head_dim * cfg.ssm.d_state * 4.0 * n_ssm
    return kv + ssm


def roofline_terms(cfg, shape, dryrun_result: Dict[str, Any], *, chips: int) -> Dict[str, Any]:
    """The raw and corrected terms of one dry-run result (its ``cost``,
    ``memory`` and ``collectives``), on ``chips`` H100s whose collectives
    cross the links ``link_bandwidth(chips)`` gives."""
    cost = dryrun_result["cost"]
    coll = dryrun_result["collectives"]
    link = link_bandwidth(chips)
    raw = {
        "compute_s_raw": cost["flops"] / PEAK_FLOPS,
        "memory_s_raw": cost["bytes_accessed"] / HBM_BW,
        "collective_s_raw": coll.get("total", 0) / link,
    }
    # corrected (analytic flops/bytes are GLOBAL → divide by chips)
    flops_g, hbm_g = analytic_cost(cfg, shape)
    terms = {
        "compute_s": flops_g / chips / PEAK_FLOPS,
        "memory_s": hbm_g / chips / HBM_BW,
        "collective_s": coll.get("total", 0) / link,
    }
    bottleneck = max(terms, key=terms.get).replace("_s", "")
    mf = model_flops(cfg, shape)
    return {
        **terms,
        **raw,
        "bottleneck": bottleneck,
        "model_flops": mf,
        "executed_flops": flops_g,
        "useful_flops_ratio": mf / flops_g if flops_g else 0.0,
        "hbm_bytes": hbm_g,
        "link_bytes_per_s": link,
    }
