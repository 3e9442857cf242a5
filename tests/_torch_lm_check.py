"""Shared checks for the LM serving tests of the PyTorch port (no JAX here,
so the card's tests can use it): a batch-1 greedy reference run that keeps
its logits, and the near-tie rule for comparing greedy token streams."""
import numpy as np
import torch


def batch1_greedy(model, prompt, n: int, *, device=None, offset: int = 0, **inputs):
    """Greedy tokens of ``prompt`` alone through ``prefill`` + ``decode_step``
    → (tokens (n,), the fp32 logits each token was picked from (n, V)).
    ``inputs`` (``frames=``, ``patches=``, batch 1) go to the prefill, and
    decode positions start ``offset`` past the prompt."""
    dev = device or model.device
    cache = model.init_cache(1, offset + len(prompt) + n)
    logits = model.prefill(torch.as_tensor(np.asarray(prompt)[None], device=dev).long(), cache,
                           **inputs)
    toks, rows = [], []
    for i in range(n):
        row = logits[0, -1]
        tok = int(torch.argmax(row))
        toks.append(tok)
        rows.append(row.float().cpu().numpy())
        if i + 1 < n:
            logits = model.decode_step(torch.tensor([[tok]], device=dev), cache,
                                       offset + len(prompt) + i)
    return np.array(toks), np.stack(rows)


def assert_tokens_match(got, want, want_logits, tol: float) -> int:
    """Greedy streams ``got`` and ``want`` agree up to near-ties: equal up to
    their first difference, where the reference's logits of the two tokens
    lie within ``tol`` (after it the prefixes differ and nothing more is
    compared). Returns 1 if they differ at a near-tie, else 0."""
    got, want = np.asarray(got), np.asarray(want)
    assert len(got) == len(want), (len(got), len(want))
    diff = np.nonzero(got != want)[0]
    if len(diff) == 0:
        return 0
    i = int(diff[0])
    gap = abs(float(want_logits[i][got[i]]) - float(want_logits[i][want[i]]))
    assert gap <= tol, f"token {i}: {got[i]} vs {want[i]}, logit gap {gap} > {tol}"
    return 1


def attention_f64(q, k, v, *, causal: bool, window: int = 0):
    """Masked softmax attention evaluated in float64 — the truth that the
    fp32 kernel and the fp32 plain version are both held to where the
    scores are large (~50, qk-norm off), since there fp32 itself (one
    rounding of each score, amplified by exp) moves the output by ~1e-5.
    q (B, H, S, Dh), k/v (B, KV, T, Dh) → (B, H, S, Dh) float64."""
    import math

    from repro_torch.kernels.flash_attention.ref import attention_mask

    b, h, s, dh = q.shape
    kv, t = k.shape[1], k.shape[2]
    qg = q.double().reshape(b, kv, h // kv, s, dh)
    scores = torch.einsum("bkgsd,bktd->bkgst", qg, k.double()) / math.sqrt(dh)
    mask = attention_mask(s, t, causal=causal, window=window, device=q.device)
    probs = torch.softmax(scores.masked_fill(~mask, -1e30), dim=-1)
    probs = probs.masked_fill(~mask.any(1)[:, None], 0.0)
    return torch.einsum("bkgst,bktd->bkgsd", probs, v.double()).reshape(b, h, s, dh)
