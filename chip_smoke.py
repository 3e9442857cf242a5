#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU: builds the kernels, holds
each against its plain PyTorch version, serves filtered-rank and top-k
traffic at full width through ``repro_torch.serving.KGEServingTier``, trains
one full-width epoch through ``repro_torch.kge.trainer.KGETrainer`` and
scores it, runs one full-width PPAT handshake with its KGEmb update,
retrain and backtrack through ``repro_torch.core``, serves qwen3-0.6b and
mamba2-2.7b at full width through ``repro_torch.serving.ServingEngine``,
times the kernels, runs two ticks of the federation scheduler over Yago
and Dbpedia with a serving tier attached, drives a poisoning storm
against the Byzantine defenses over the same owners, cut by a checkpoint
and resumed, and holds the batched tick engine (captured CUDA graphs)
against the serial one at that width, over the paper's eleven owners and
on the 11-KG example's universe, runs the paper's two-party topology
(the PPAT exchange between two processes, the row-sharded KGE step) at
full width, serves the MoE, encoder-decoder and VLM cards (mixtral-8x22b,
whisper-medium, internvl2-26b at full width; jamba and kimi reduced), and
trains qwen3-0.6b at its published width and depth through
``repro_torch.train`` with the flash kernel in every attention forward,
dry-runs two cards on a fake 256-rank mesh, and runs kimi's expert-parallel
MoE over gloo ranks sharing the card.

    python3 chip_smoke.py            # one CUDA card; about ten minutes on an H100

Phases (every failed check ends the run with a non-zero exit):

1. the card (``nvidia-smi``: name, power limit), then the seven kernel
   libraries (``triple_score``: pairwise scores, fused ranks and the fused
   top-k;
   ``sparse_update``: the SGD step; ``csls``: the cosine matrix;
   ``flash_attention``; ``ssd_scan``: the SSD chunks) built from
   the ``csrc`` directories under
   ``src/repro_torch/kernels``, one ``nvcc`` each, all started together,
   with each library's registers and spills (``-Xptxas -v``) and its
   tensor-core instructions (HMMA, HGMMA) counted in ``cuobjdump -sass``
   (the SSD library must have some);
2. kernel vs plain version on the card, for the four score modes through the
   families that use them (TransE l1 and l2, DistMult dot, ComplEx dot over
   its 2d-wide table, RotatE cl1), E = 50,000, d = 100, with a ragged B and E
   and filter widths 1 and 33. Pairwise scores agree within atol 1e-4 /
   rtol 1e-5; rank counts differ only by near-ties (entities whose plain
   score lies within 1e-5·(1+|gold|) of gold); the fused top-k (k 16) is
   bit-equal to the blockwise scan over the pairwise kernel's scores, and
   its scores agree with its plain version within atol 1e-4 / rtol 1e-5,
   its ids but at near-ties;
3. the main path: TransE L1, dim 100 (the trainer's default width) at the
   paper's largest KG, Dbpedia (E = 491,078, R = 14,085, 1,373,644 known
   triples drawn uniformly from ``--seed``), served by ``KGEServingTier`` on
   ``cuda:0``: rank and top-k waves with a table publish between them. The
   launch counters are zeroed just before the tier is built and read just
   after the drain; sampled batches are then re-checked against the plain
   versions on the card;
4. timings at the serving batch (B = 64, l1), then at B = 8 and in dot
   mode on the same rows: first each kernel's whole output at the timed
   shapes (every top-k chunk, the ragged last one included) is held against
   its plain version with the rules of phase 2; then kernel, plain version
   and the library yardstick (``torch.cdist`` / ``q @ ent.T`` with TF32
   off, timed only), each the median of CUDA-event-timed runs, beside the
   least time the card could take (bytes over the memory rate, or the
   mode's fp32 instructions over the fp32 pipe's instruction rate:
   ``score_ops``); then the host-clock time of one 64-row rank and top-k
   request, a ``torch.profiler`` window over one top-k request (host time
   by operator), and a trace of the tier draining a burst: device time by
   kernel and the device's idle share. The fused top-k (k 16, the tier's
   bucket for k 10) is held bit for bit against the chunked scan it
   replaced and timed beside it, at B = 64 and at the tier's 2,048-row
   bucket, against the bound of its scoring;
5. the sparse SGD kernel against its plain version on the card, for l1, l2
   and dot, at the training shape (E = 491,078, R = 14,085, d = 100,
   B = 100) and a ragged one (B = 37, d = 33), on batches built to break a
   wrong step (a hub row, ids 0 and E−1, rows shared by pos and neg): whole
   tables after one step (atol 1e-6, loss rtol 1e-6) and after one launch of
   64 steps against the plain step loop (atol 1e-5, losses rtol 1e-5), two
   kernel runs of the 64 steps bit-equal; and 64 steps on a 12-row table,
   where every step re-reads rows the step before wrote (atol 1e-5);
6. the training path: TransE L1, d = 100, lr 0.5, batch 100, margin 4, on
   the Dbpedia-sized store of phase 3 as the training split (valid and test
   are 2,000 triples each sampled from it). ``KGETrainer`` on ``cuda:0``
   trains one epoch (13,737 batches cycle-padded to 16,384); the counters
   are zeroed just before and must read one launch of 16,384 steps after,
   the epoch loss must be finite and the padding rows zero. Filtered link prediction
   (``max_test`` 2,000, one chunk held against the plain rank count) and
   triple classification run before and after. The trained tables are
   published to the tier, trained one more step in place, and the published
   version must still answer as before;
7. timings of the epoch kernel at the training shape (device time of one
   launch over a whole epoch, per epoch and per step, on its cluster of 16
   blocks; the plain step loop over the same epoch; the bound per epoch
   and per step) and a ``torch.profiler`` trace of one training epoch of
   the engine: the device's idle share;
8. the cosine kernel against its plain version on the card: (n, m, d) =
   (1000, 777, 100) and (129, 4097, 33) with a zero row on each side (atol
   1e-5, zero rows exactly 0), ``csls_matrix`` around it (atol 4e-5), and
   the blockwise CSLS retrieval argmax against the whole plain CSLS matrix
   at n = m = 8,192 (equal up to near-ties, 1e-5);
9. the handshake path at full width: client Yago (E = 286,389, R = 37,
   1,824,322 uniform triples from ``--seed``, untrained tables), host the
   trained Dbpedia-sized trainer of phase 6, 123,853 aligned entities drawn
   from ``--seed`` (Yago–Dbpedia, the paper's largest pair), the host's
   aligned rows set to the client's turned by a seeded orthogonal Q plus
   0.01·N(0, 1). ``PPATConfig()`` (200 rounds, B = 32, 4 teachers, hidden
   128), d = 100, average aggregation, procrustes refinement, virtual
   extension (≤ 2,000 neighbours), one retrain epoch, backtrack by the
   scheduler's default accuracy score (Hit@10 beside it), accept or
   restore. Launch counters are zeroed just before and read just after;
   checks: ε finite and equal to the accountant over the returned vote
   counts, the cosine, step and rank kernels all launched (the cosine
   kernel 124 times: two retrievals, two passes of 31 blocks), CSLS retrieval
   < 0.01 with W = I and ≥ 0.9 after PPAT + procrustes, padding rows zero,
   table shapes restored, tables bit-equal to the snapshot (reject) or the
   retrained ones (accept), a version published before answering as
   before; then 16 PPAT rounds on the card and on the CPU from the same
   draws: equal vote counts, W within 1e-4;
10. timings: the cosine kernel at one retrieval block (4,096 × 123,853,
   d = 100; its output held against the plain version first), plain and
   library (``F.normalize(a) @ F.normalize(b).T``, TF32 off) times with the
   bound as split TF32 (three TF32 products on the tensor cores: the least
   time for an fp32-accurate product) beside the fp32-pipe bound; the whole
   retrieval on the host clock with its launches; and a
   ``torch.profiler`` trace of a second handshake: device time by kernel and
   the device's idle share.
11. flash attention against its plain version (dense masked softmax) at
   qwen3-0.6b's prefill (B = 1, S = 2,048, H = 16, KV = 8, Dh = 128,
   causal), at ragged S = 333, a window of 64, non-causal, GQA 4:1, Dh 64 and
   32, kimi-k2-1t's heads (H = 64, KV = 8, Dh 112, S = 1,024), bf16, and
   at the shapes phase 19 adds: whisper-medium's cross-attention (S = 2,048
   queries over T = 1,500 frames, non-causal), mixtral-8x22b past its
   4,096-token window at S = 6,144, internvl2-26b's 256 + 2,048 rows
   (atol = rtol = 1e-5 at fp32; at bf16, where both round the
   same fp32 result, one bf16 ulp: rtol = 2**-7, atol = 1e-5); the SSD chunk
   kernel against its plain version at mamba2-2.7b's prefill (S = 2,048,
   H = 80, P = 64, N = 128, Q = 256) with ``Mamba2Mixer``'s A and dt laws
   (all three outputs, and the whole SSD with and without an initial state,
   each within 1e-5 of the plain output's largest magnitude);
12. LM serving at full width, fp32, random weights from ``--seed``:
   qwen3-0.6b (28 layers, 0.596 B parameters) through
   ``ServingEngine(max_batch=8, max_len=4096)``, 16 requests with
   ``SyntheticTextDataset`` prompts of 128-2,048 tokens (the first no
   multiple of 64), 32 new tokens each; mamba2-2.7b (64 layers, 2.70 B)
   with 4 slots, 8 requests of 256-2,048 tokens (the first no multiple of
   the 256-token chunk). The kernel's counter is zeroed just before the
   engine and must read requests x layers after; every request is answered,
   its tokens equal a batch-1 ``prefill`` + ``decode_step`` run of its prompt
   alone, and its first token the plain-kernel prefill's, up to near-ties
   (logits within 1e-3), with max|dlogit| reported;
13. per card, a ``launch/serve.py``-style batched run (batch 4, prompt
   2,048, 32 tokens): prefill tokens/s and decode ms per token; and a
   ``torch.profiler`` trace of a burst of one request per slot: the
   device's idle share;
14. timings of both kernels at the shapes of phase 11's first cases
   (kernel, plain, and for attention the library yardstick
   ``F.scaled_dot_product_attention(is_causal=True, enable_gqa=True)``,
   timed only) with their bounds (split TF32 beside fp32 pipes), and of
   both at the serve script's batch 4 x 2,048 (outputs held against the
   plain versions first);
15. the federation at full width: ``FederationScheduler`` on ``cuda:0`` over
   Dbpedia (phase 6's store) and Yago (phase 9's, with valid and test
   sampled the same way) with phase 9's 123,853 aligned entities as an
   explicit registry; d = 100, TransE, the scheduler's defaults (margin 2,
   batch 100, ``PPATConfig()``, average aggregation, procrustes, virtual
   extension), Hit@10 backtrack over 200 valid triples, one epoch of
   initial training and one retrain epoch. ``KGEServingTier.for_owner``
   serves Dbpedia; two ticks with a wave of 32 rank and 4 top-k requests
   drained between them and after. Checks: events in plan order, every
   decision ``after > before``, tables bit-equal to the best snapshot after
   each tick, each handshake's epsilon finite and equal to its accountant,
   the lifetime epsilon at least each, tier versions 1 + Dbpedia's accepts,
   every request served, and the counters (zeroed just before the phase)
   of the epoch and rank kernels equal to what the plan implies: one
   launch per epoch, two per 128 scored triples. The round's host clock
   with each stage's share (each stage call synchronised), and a
   ``torch.profiler`` window (device activity only) of the first tick, the
   one whose plan is handshakes: the device's idle share.
   Then the scheduler at a small universe (three owners at scale 1/500,
   d = 16, 12 PPAT rounds, two ticks) on the card and on the CPU under
   ``REPRO_TRAIN_IMPL=fused`` from the same CPU draws: equal events,
   bit-equal epsilon, tables within 1e-5.
16. a poisoning storm at full width: phase 15's universe and scheduler
   (no tier) under the JAX package's resume-test storm
   (``tick_adversary="drift=0.4,replay=0.6,seed=2,strength=0.9,frac=0.5"``)
   with ``robust_agg="median"`` and ``cos_screen=0.3``. One tick, then
   checks: each handshake's attack is the plan's draw, the replay cache is
   filled, every tampered row is finite within ``evade * bound`` and the
   frozen view untouched, each verdict is ``poison`` exactly when its mean
   cosine is below its threshold, and a poison decays the client's
   reputation (each mean cosine and threshold printed, captured by the
   stage clock). ``save_scheduler`` under ``build/``, two more ticks; a
   fresh scheduler restores the checkpoint and runs the same two: events
   equal in every field but ``seconds`` and ``sim_finish``, ledgers,
   queues and lifetime epsilon equal, every table bit-equal. The epoch and
   rank launches (counters zeroed before the phase) equal what the plan
   implies. The host clock of tamper, ``robust_rows``, save and restore,
   the checkpoint's bytes (the file is deleted), ``robust_rows`` alone at
   123,904 x 100 in each mode, and the storm at phase 15's small universe,
   barrier and streamed (staleness bound 0), on the card and on the CPU
   from the same draws (equal events with attack, fault and level, equal
   reputation, bit-equal epsilon, tables within 1e-5), the card's
   checkpoint restored into a CPU scheduler for one more tick.
   Phases 15 and 16 pin ``tick_impl="reference"`` (the serial engine).
17. the batched tick engine (``core/tick_engine.py``). a. Phase 15's
   universe and scheduler through the serial engine, the batched engine
   (each signature's first entry runs eagerly, then its graphs are
   captured) and the batched engine again in a second scheduler (every
   entry a replay), two ticks each, taken in turn from the same draws:
   after every tick the events in every field but ``seconds``, epsilon and
   every table bit-equal across the three, and each engine's epoch and
   rank launches (replays counted) equal to the plan's. Per engine the
   ticks' host clock, graphs captured, replays and eager segments; the
   graphs' pool and static-input bytes; a ``torch.profiler`` window of the
   replaying scheduler's first tick (device busy as the union of kernel
   intervals, the streams overlap: the idle share, device time by kernel).
   Then phase 16's storm for one tick on the batched engine: events,
   verdicts and reputation equal phase 16's serial tick. b. The eleven
   owners of Tab. 2 at their entity, relation and triple counts (uniform
   triples, ``make_kg``), Tab. 3's nineteen alignments drawn uniformly,
   TransE d = 100, ``MESH_ROUNDS`` PPAT rounds, one initial epoch, one tick
   through the same three engines: equal events, bit-equal epsilon and
   tables, launches as planned, the programs and graphs against the
   entries. c. ``examples/federated_11kg_torch.py``'s universe (scale
   1/400, TransE/H/R/D) cut to ``EXAMPLE_CUT`` with a Hit@10 backtrack,
   two ticks: batched on the card against serial on the CPU from the same
   draws and start tables (events equal, epsilon bit-equal, tables within
   1e-5), then ``tick_placement="sharded"`` over ``OwnerPlacement((cuda:0,
   cpu))`` against the single run (events equal, tables within 1e-5).
18. the two-party topology (``core/parties.py``), two ranks spawned by
   ``run_parties`` over ``gloo``, both on ``cuda:0``. a. The exchange at
   phase 9's width: 123,853 aligned rows at d = 100, Y a planted rotation
   of X plus 0.01 noise, each party building its own side from ``--seed``,
   ``PPATConfig()``'s 200 rounds: the client's W, the host's
   discriminators, every round's vote counts and epsilon bit-equal to the
   in-process stepwise handshake (``PPATClient``, ``PPATHost.step``) on the
   same draws; the pipe carried exactly 2 tensors of 32 x 100 fp32 a
   round. Median ms a round both ways, the pipe's ms (on the client, from
   the send to the gradient back); procrustes and CSLS retrieval over the
   aligned rows equal to the in-process run's, the cosine launches
   counted. b. The sharded step at Dbpedia's size (TransE L1, E = 491,078,
   R = 14,085, d = 100, ``make_kg``'s triples, margin 2, lr 0.3, batch
   128), 300 steps at world 2, then at world 1 from the same draws: the
   gathered tables within 1e-5, every loss finite; median ms a step,
   bytes a step and a rank's shard bytes.
19. the remaining LM cards, fp32, random weights from ``--seed``, each
   freed before the next with its peak device memory printed. The only cut
   is depth: mixtral-8x22b and internvl2-26b at their published widths with
   ``LM_CARD_LAYERS`` = 2 layers; whisper-medium whole (24 + 24 layers).
   a. mixtral: ``ServingEngine(max_batch=4, max_len=8192)``, 8 requests of
   512-6,144 tokens (one past the 4,096 window, the first no multiple of
   64), 16 new tokens, checked as in phase 12 with the flash counter at
   requests x 2; the dropped assignments of the longest prefill per layer;
   a ``launch/serve.py``-style batch 4 x 2,048 with 32 new tokens (prefill
   tokens/s, decode ms per token, first tokens against the plain-kernel
   prefill); a ``torch.profiler`` window over one such prefill (idle share,
   device time by kernel) and the MoE's sections (routing, dispatch, expert
   GEMMs, combine) between CUDA events over another. b. whisper:
   ``ServingEngine`` refuses it; the serve-style batch 4 x 2,048 over seeded
   N(0, 1) frames (4, 1,500, 1,024): flash launched 72 times in the prefill
   (24 encoder, 24 self-attention, 24 cross-attention layers), sequences 0
   and 3 against their batch-1 runs, first tokens against the plain-kernel
   prefill, a device-only profile of a serve run. c. internvl: the engine
   as in a (8 requests of 128-2,048 tokens, ``max_len`` 4,096, the
   reference's patch-less prefill; a slot per request, since a recycled
   VLM slot attends its previous request's rows), and the serve-style run
   behind seeded patches (4, 256, 6,144), flash twice per prefill. d.
   reduced jamba (Mamba2 + attention + MoE) and kimi (a shared expert)
   through the engine, the flash and SSD counters at what the layers imply.
20. LM training, fp32, TF32 off. a. qwen3-0.6b as published (28 layers,
   0.596 B parameters, the card's remat), random weights from ``--seed``,
   ``TRAIN_PLAN`` (global batch 8 x 2,048 tokens in 2 strided
   microbatches, ``ce_chunk`` 512, AdamW at lr 1e-3, cosine over 8 steps
   with 2 of warmup), ``SyntheticTextDataset`` batches, 8 steps. Step 1 is
   held against the same step under ``plain_kernels()`` (the loss within
   ``TRAIN_LOSS_RTOL``, the global gradient norm within
   ``TRAIN_NORM_RTOL``, the parameters after the update within
   ``TRAIN_RMS_LR`` lr root-mean-square and ``TRAIN_MAX_LR`` lr at most);
   every loss finite; the loss of step 1's batch after step 8 below its
   step-1 value; flash launched 8 x 28 layers x 2 microbatches x 2
   (the forward and remat's recompute; the backward runs the plain
   version). Step s (median of steps 2-8), tokens/s, the model and executed
   FLOPs a token with their formulas, MFU against the fp32 peak (the TF32
   one beside it), peak memory, and a device-only ``torch.profiler``
   window of one step (idle share; the flash forward, the GEMMs and the
   rest by kernel name; the plain attention backward between CUDA events
   around each flash backward, ``_backward``). d. Its parameters saved under
   ``build/`` in the reference's layout (``checkpoint.save_lm``) and
   restored into a fresh model bit for bit: save and restore s and bytes;
   the file is deleted. b. mixtral (the MoE aux), whisper (frames),
   internvl (patches), mamba2 and jamba (the SSD) reduced, 3 steps each on
   the card and on the CPU from the same weights and batches: losses
   within ``TRAIN_CARD_LOSS_RTOL``, the parameters after step 1 as in a,
   the flash and SSD launches as the layers imply. c.
   ``examples/federated_lm_embeddings_torch.py`` at its defaults (losses
   and epsilon finite, the verdict) and ``examples/train_lm_torch.py
   --steps 20`` (its tokens/s).
21. sharding. a. ``launch.dryrun.dryrun_one`` for qwen3-0.6b and
   kimi-k2-1t-a32b x decode_32k on a fake 256-rank (16, 16) mesh (shapes
   only, nothing allocated): status, per-rank peak and argument bytes, the
   roofline terms. b. kimi's MoE layer at published width (d 7,168, 384
   experts top-8, d_ff 2,048, a shared expert, route groups 4), bf16, over
   ``EP_RANKS`` = 8 gloo ranks sharing the card (48 experts and 512 tokens
   each: the node-limited branch): at the card's capacity factor 1.25 the
   drops, ms a call, the share in gloo and the bytes handed to it; at
   ``EP_NO_DROP_CF`` forward and backward of ``sum(y²)``, nothing dropped,
   against the one-process gather path on the same routing
   (``MoE.node_limited``): outputs, the router's and shared expert's
   gradients (the ranks' shares summed) and every expert's gradient norm
   and ``EP_SAMPLES`` sampled elements, within ``EP_TOL`` of the largest
   value. c. kimi cut to one layer over ``CARD_RANKS`` = 4 such ranks with
   the mesh set (96 experts each, the MoE's plain all-to-all branch, flash
   at Dh 112): each rank's logits for 1 x 1,024 tokens against the
   one-process forward on the same weights, flash launched once per rank.

A kernel's ``ms`` is one call between CUDA events on an idle stream, the
host's launch included (``time_ms``); ``device_ms`` beside it is its device
time: calls queued behind a device-side sleep, between events
(``time_device_ms``). The sparse SGD kernel is the exception: an epoch
launch lasts tens of ms, and its ``ms`` is the device time of one (as
``device_ms``); ``call_ms`` is one lone step between events.

The line before the last is ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``. Without CUDA, or run from a directory
that lacks the port's sources, it exits non-zero and prints no result.
``--rehearse`` runs phases 3, 6, 9, 12, 13 and 15-21 at a tiny size (the
LM cards reduced) on the CPU with the plain versions (no kernels, no
timings) and also exits non-zero.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
SRC = REPO / "src"

#: Dbpedia's size in the paper's Table 2 (``kge/data.py::PAPER_KG_STATS``)
DBPEDIA = dict(entities=491_078, relations=14_085, triples=1_373_644)
DIM = 100            # ``kge/trainer.py``'s default embedding width
SERVE_BATCH = 64     # the tier's ``max_batch``: the fullest batch it launches
RANK_REQUESTS = 300  # rank requests over the two waves of phase 3
TOPK_REQUESTS = 40   # top-k requests over the two waves of phase 3
CHECK_EVERY = 10     # re-check every n-th served request against the plain versions
ITERS = 20           # timed runs per measurement
DEVICE_CALLS = 5     # calls queued per device-time run (``time_device_ms``)
DEVICE_RUNS = 10     # device-time runs per measurement

#: (family, norm_ord) for each score mode of phase 2
MODE_FAMILIES = {"l1": ("transe", 1), "l2": ("transe", 2), "dot": ("distmult", 1),
                 "dot2d": ("complex", 1), "cl1": ("rotate", 1)}
#: TPU kernels these replace (the ``pl.pallas_call`` of each)
REPLACES = {
    "pairwise_scores": "src/repro/kernels/triple_score/triple_score.py:83",
    "fused_ranks": "src/repro/kernels/triple_score/triple_score.py:157",
    "sparse_sgd_step": "src/repro/kernels/sparse_update/sparse_update.py:179",
    "cosine_matrix": "src/repro/kernels/csls/csls.py:39",
    "flash_attention": "src/repro/kernels/flash_attention/flash_attention.py:107",
    "ssd_chunks": "src/repro/kernels/ssd_scan/ssd_scan.py:70",
    "pairwise_topk": "src/repro/kernels/triple_score/triple_score.py:83, with the top-k "
                     "merge of src/repro/serving/engine.py",
}
KERNELS = ("pairwise_scores", "fused_ranks", "sparse_sgd_step", "cosine_matrix",
           "flash_attention", "ssd_chunks", "pairwise_topk")
SOURCES = {
    "pairwise_scores": "src/repro_torch/kernels/triple_score/csrc/pairwise_scores.cu",
    "fused_ranks": "src/repro_torch/kernels/triple_score/csrc/fused_ranks.cu",
    "sparse_sgd_step": "src/repro_torch/kernels/sparse_update/csrc/sparse_step.cu",
    "cosine_matrix": "src/repro_torch/kernels/csls/csrc/cosine_matrix.cu",
    "flash_attention": "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
    "ssd_chunks": "src/repro_torch/kernels/ssd_scan/csrc/ssd_chunks.cu",
    "pairwise_topk": "src/repro_torch/kernels/triple_score/csrc/pairwise_topk.cu",
}
TRAIN_BATCH = 100    # ``KGETrainer``'s default batch
TRAIN_LR = 0.5       # ``KGETrainer``'s default learning rate
MAX_TEST = 2_000     # link prediction's default test slice
STEP_TRAJECTORY = 64  # consecutive steps held against the plain version
TOPK_K = 16          # the tier's top-k bucket for the benchmark's k = 10
TIER_BUCKET = 2048   # the benchmark tier's largest batch bucket
#: Yago's size in the paper's Table 2, and the Yago–Dbpedia alignment, the
#: largest pair of Table 3 (``kge/data.py::PAPER_KG_STATS``, ``PAPER_ALIGNMENTS``)
YAGO = dict(entities=286_389, relations=37, triples=1_824_322)
ALIGNED = 123_853
RETRIEVAL_BLOCK = 4096   # ``core/alignment.py``'s rows per cosine launch
CHECK_RETRIEVAL = 8192   # n = m of the blockwise-vs-full retrieval check
PPAT_CHECK_ROUNDS = 16   # PPAT rounds held card vs CPU
#: flash-attention checks (B, H, KV, S, Dh, causal, window, dtype): qwen3-0.6b's
#: prefill at 2,048 tokens, then ragged S, a window, non-causal, GQA 4:1, bf16,
#: kimi-k2-1t's heads (Dh 112)
FLASH_CHECKS = [(1, 16, 8, 2048, 128, True, 0, "fp32"), (2, 16, 8, 333, 128, True, 0, "fp32"),
                (1, 4, 4, 333, 64, False, 64, "fp32"), (1, 16, 4, 1000, 64, True, 0, "fp32"),
                (1, 8, 2, 500, 32, True, 64, "fp32"), (1, 16, 8, 2048, 128, True, 0, "bf16"),
                (2, 16, 4, 333, 64, True, 64, "bf16"),
                (1, 64, 8, 1024, 112, True, 0, "fp32"), (1, 64, 8, 1024, 112, True, 0, "bf16")]
#: checks with T != S or past a window (B, H, KV, S, T, Dh, causal, window, dtype):
#: whisper-medium's cross-attention over 1,500 frames, mixtral-8x22b past its
#: 4,096-token window, internvl2-26b's patch-shifted length (256 + 2,048)
FLASH_LONG_CHECKS = [(1, 16, 16, 2048, 1500, 64, False, 0, "fp32"),
                     (1, 16, 16, 2048, 1500, 64, False, 0, "bf16"),
                     (1, 48, 8, 6144, 6144, 128, True, 4096, "fp32"),
                     (1, 48, 8, 2304, 2304, 128, True, 0, "fp32")]
#: one bf16 ulp relative to the value (2**-8 to 2**-7 of it): kernel and plain
#: version round the same fp32 result to bf16, so they differ by at most this
BF16_ULP = 2.0 ** -7
FLASH_SHAPE = (1, 2048, 16, 8, 128)        # B, S, H, KV, Dh: qwen3-0.6b's prefill
SSD_SHAPE = (1, 2048, 80, 64, 128, 256)    # B, S, H, P, N, Q: mamba2-2.7b's prefill
#: LM serving plans: (slots, requests, shortest and longest prompt, max_len, new tokens)
LM_PLANS = {"qwen3-0.6b": (8, 16, 128, 2048, 4096, 32),
            "mamba2-2.7b": (4, 8, 256, 2048, 4096, 32)}
LM_REHEARSE_PLAN = (2, 4, 8, 90, 256, 6)
#: phase 19: mixtral-8x22b and internvl2-26b at their published widths, cut
#: to this many layers (whisper-medium runs whole), and their engine plans
LM_CARD_LAYERS = 2
MIXTRAL_PLAN = (4, 8, 512, 6144, 8192, 16)
INTERNVL_PLAN = (8, 8, 128, 2048, 4096, 16)   # a fresh slot per request
LM_CARD_REHEARSE_PLAN = (2, 4, 8, 90, 256, 6)   # 19d (reduced jamba, kimi) and rehearsals
WHISPER_PROMPT = 2048    # tokens per sequence of whisper's batch-4 serve run
SERVE_GEN = 32           # tokens per sequence of the ``launch/serve.py`` run
SERVE_BATCH_LM = 4       # sequences per ``launch/serve.py`` batch
LM_TIE_TOL = 1e-3        # near-tie rule for greedy tokens: logits within this
FED_TICKS = 2            # scheduler ticks of phase 15
FED_MAX_TEST = 200       # the scheduler's ``score_max_test``: valid triples per Hit@10
FED_WAVE = (32, 4)       # rank and top-k requests per wave between the ticks
FED_SMALL_OWNERS = ("Dbpedia", "Yago", "Geonames")  # card-vs-CPU universe
FED_SMALL_DIM = 16
FED_SMALL_ROUNDS = 12
FED_TABLE_ATOL = 1e-5    # phase 5's bound for 64 steps
#: phase 16's storm: the reference's resume test (``tests/test_adversary.py``)
STORM_SPEC = "drift=0.4,replay=0.6,seed=2,strength=0.9,frac=0.5"
STORM_COS = 0.3          # its ``cos_screen``, with ``robust_agg="median"``
STORM_CUT = 1            # ticks before the checkpoint
STORM_RESUMED = 2        # ticks after it, uninterrupted and resumed
MESH_ROUNDS = 50         # PPAT rounds of phase 17b's eleven owners (cut from 200)
EXAMPLE_SCALE = 400      # phase 17c: ``examples/federated_11kg_torch.py``'s default scale
#: phase 17c's cut of the example's schedule (its defaults: 100 PPAT rounds,
#: 100 local and 30 update epochs)
EXAMPLE_CUT = dict(dim=32, ppat_steps=12, local_epochs=2, update_epochs=1)
#: phase 18: one card, so both ranks share it over gloo
PARTY_BACKEND = "gloo"
#: phase 18b: ``examples/distributed_fkge_torch.py``'s sharded step
SHARDED = dict(batch=128, lr=0.3, margin=2.0, steps=300)


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def log(*parts) -> None:
    print(*parts, flush=True)


# ------------------------------------------------------------------ the card
def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def peak_rates(name: str):
    """(bytes/s, fp32 FLOP/s outside the tensor cores, dense TF32 FLOP/s on
    the tensor cores) of the card ``name``: NVIDIA's data sheets, as
    ``repro_torch.utils.roofline.peak_rates`` keeps them."""
    from repro_torch.utils.roofline import peak_rates as rates

    return rates(name)[:3]


def split_tf32_bounds(flops, nbytes, card):
    """Least times for an fp32 product of ``flops`` that moves ``nbytes``:
    as split TF32 (three TF32 products on the tensor cores, fp32 accuracy),
    which is the least, and on the fp32 pipes. Returns the kernel-line keys
    (``bound_ms``, ``bound_by``: the split-TF32 bound) and ``bound_fp32_ms``."""
    mem_rate, fp32_rate, tf32_rate = peak_rates(card)
    t_bytes, t_ops = nbytes / mem_rate, 3 * flops / tf32_rate
    return dict(bound_ms=1e3 * max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bound_fp32_ms=1e3 * max(t_bytes, flops / fp32_rate))


def tensor_core_ops(path):
    """Counts of tensor-core instructions (HMMA: mma.sync; HGMMA: wgmma) in
    the SASS of a built library, by ``cuobjdump -sass``; None without it."""
    from repro_torch.kernels import _nvcc

    tool = Path(_nvcc.find_nvcc()).parent / "cuobjdump"
    if not tool.exists():
        return None
    sass = subprocess.run([str(tool), "-sass", str(path)], capture_output=True, text=True,
                          timeout=120).stdout
    counts = {}
    for op in ("HMMA", "HGMMA"):
        counts[op] = sum(1 for ln in sass.splitlines() if f" {op}." in ln)
    return counts


# --------------------------------------------------------------- near ties
def near_tie_count(plain_scores, gold):
    """Entities whose plain score lies within 1e-5·(1+|gold|) of gold."""
    g = gold[:, None]
    return ((plain_scores - g).abs() <= 1e-5 * (1 + g.abs())).sum(1)


def check_ranks(torch, counts, plain_counts, plain_scores, gold, what):
    diff = (counts.long() - plain_counts.long()).abs()
    near = near_tie_count(plain_scores, gold)
    check(bool((diff <= near).all()), f"{what}: rank counts differ beyond near-ties "
          f"(max diff {int(diff.max())})")
    return int((diff > 0).sum()), int(diff.max()) if diff.numel() else 0


def check_topk(torch, vals, ids, plain_vals, plain_ids, what):
    """A fused top-k against its plain version: scores within atol 1e-4 /
    rtol 1e-5, ids equal but where the two scores at the place lie within
    1e-5·(1+|s|). Returns the largest score error and the rows that differ."""
    torch.testing.assert_close(vals, plain_vals, atol=1e-4, rtol=1e-5,
                               msg=lambda m: f"{what}: top-k scores: {m}")
    gap = torch.where(torch.isfinite(plain_vals), (vals - plain_vals).abs(),
                      torch.zeros_like(vals))
    differ = ids != plain_ids
    check(bool((gap[differ] <= 1e-5 * (1 + plain_vals[differ].abs())).all()),
          f"{what}: top-k ids differ beyond near-ties")
    return float(gap.max()) if gap.numel() else 0.0, int(differ.any(1).sum())


# ------------------------------------------------------------ phase 2
def kernel_vs_plain(torch, ops, models, dev, seed, e_full):
    """Each kernel against its plain version on the card, every mode."""
    worst = {"pairwise_scores": 0.0, "fused_ranks": 0, "pairwise_topk": 0.0}
    cases = [(64, e_full, 1), (61, e_full - 37, 33)]
    for label, (family, norm_ord) in MODE_FAMILIES.items():
        for b, e, f in cases:
            m = models.KGEModel(family, e, 64, DIM, norm_ord=norm_ord)
            params = models.init_kge(seed, m, device=dev)
            g = torch.Generator(device=dev).manual_seed(seed + b)
            h = torch.randint(0, e, (b,), device=dev, generator=g)
            r = torch.randint(0, 64, (b,), device=dev, generator=g)
            t = torch.randint(0, e, (b,), device=dev, generator=g)
            q, table, mode = models.lp_query_tails(params, m, h, r)
            q = q.contiguous()
            table = table.contiguous()
            gold = models.lp_gold_scores(q, table, t, mode)
            filt = torch.randint(-1, e, (b, f), device=dev, generator=g, dtype=torch.int32)
            filt[:, 0] = t.int()
            s = ops.pairwise_scores(q, table, mode=mode)
            p = ops.pairwise_scores_plain(q, table, mode, block_e=4096)
            torch.cuda.synchronize()
            err = float((s - p).abs().max())
            torch.testing.assert_close(s, p, atol=1e-4, rtol=1e-5)
            c = ops.fused_ranks(q, table, gold, filt, mode=mode)
            cp = ops.fused_ranks_plain(q, table, gold, filt, mode, block_e=4096)
            torch.cuda.synchronize()
            ndiff, dmax = check_ranks(torch, c, cp, p, gold, f"{label} B={b} E={e} F={f}")
            vals, ids = ops.pairwise_topk(q, table, filt, k=TOPK_K, mode=mode)
            sv, si = ops.topk_scan(lambda c0, c1: s[:, c0:c1], b, e, filt, k=TOPK_K,
                                   chunk=4096, device=dev)
            check(torch.equal(vals, sv) and torch.equal(ids, si),
                  f"{label} B={b} E={e}: the fused top-k is not the scan's over its scores")
            terr, tdiff = check_topk(torch, vals, ids, *ops.pairwise_topk_plain(
                q, table, filt, TOPK_K, mode, block_e=4096), f"{label} B={b} E={e} F={f}")
            worst["pairwise_scores"] = max(worst["pairwise_scores"], err)
            worst["fused_ranks"] = max(worst["fused_ranks"], dmax)
            worst["pairwise_topk"] = max(worst["pairwise_topk"], terr)
            log(f"check {label:5s} ({family}, mode {mode}, width {table.shape[1]}) "
                f"B={b} E={e} F={f}: pairwise max|err|={err:.3g} ok; "
                f"rank counts differ on {ndiff}/{b} queries, all within near-ties; top-k "
                f"bit-equal to the scan, max|err|={terr:.3g}, ids differ on {tdiff}/{b} "
                f"rows, all at near-ties")
    return worst


# ------------------------------------------------------------ phase 3
def draw_known(np, seed, e, r, n):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, e, n), rng.integers(0, r, n), rng.integers(0, e, n)],
                    axis=1).astype(np.int64)


def serve(torch, np, models, serving, ops, dev, args, sizes):
    """The main path: a tier over Dbpedia-sized TransE tables answers rank
    and top-k waves with a publish between them."""
    e, r, n_known = sizes
    m = models.KGEModel("transe", e, r, DIM, norm_ord=1)
    t0 = time.perf_counter()
    known = draw_known(np, args.seed, e, r, n_known)
    v0 = models.init_kge(args.seed, m, device=dev)
    v1 = models.init_kge(args.seed + 1, m, device=dev)
    setup_s = time.perf_counter() - t0
    rng = np.random.default_rng(args.seed + 7)

    ops.reset_launches()
    t0 = time.perf_counter()
    tier = serving.KGEServingTier(v0, m, known, device=dev, max_batch=SERVE_BATCH,
                                  warm_buckets=[("rank", SERVE_BATCH),
                                                ("topk", SERVE_BATCH, 20)])
    build_s = time.perf_counter() - t0
    log(f"serve: E={e} R={r} known={n_known} d={DIM} transe/l1 on {dev}; "
        f"tables drawn in {setup_s:.2f}s, tier built in {build_s:.2f}s "
        f"(filter width {tier.filters.width}, rank filter width {tier.filters.width + 1})")

    waves = []
    t_serve = time.perf_counter()
    for wave in range(2):
        reqs = []
        n_rank, n_topk = RANK_REQUESTS // 2, TOPK_REQUESTS // 2
        kinds = ["rank"] * n_rank + ["topk"] * n_topk
        rng.shuffle(kinds)
        for kind in kinds:
            n = int(rng.integers(1, 17))
            if rng.random() < 0.5:
                q = known[rng.integers(0, len(known), n)]
            else:
                q = draw_known(np, int(rng.integers(1 << 30)), e, r, n)
            if kind == "rank":
                reqs.append((kind, q, tier.submit_rank(q[:, 0], q[:, 1], q[:, 2])))
            else:
                k = int(rng.choice([1, 10, 20]))
                reqs.append((kind, q, tier.submit_topk(q[:, 0], q[:, 1], k=k)))
        tier.run_until_drained()
        waves.append(reqs)
        if wave == 0:
            tier.publish(v1)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    serve_s = time.perf_counter() - t_serve
    launches = dict(ops.LAUNCHES)

    s = tier.stats
    check(s["served"] == s["submitted"] and s["failed"] == 0 and s["shed"] == 0,
          f"served != submitted: {s}")
    for wave, reqs in enumerate(waves):
        check(all(req.version == wave for _, _, req in reqs),
              f"wave {wave} served on the wrong table version")
    lat = sorted(req.latency for reqs in waves for _, _, req in reqs)
    rows = sum(len(q) for reqs in waves for _, q, _ in reqs)
    nreq = sum(len(reqs) for reqs in waves)
    res = {
        "requests": nreq, "rows": rows, "batches": s["batches"], "seconds": serve_s,
        "qps_requests": nreq / serve_s, "qps_rows": rows / serve_s,
        "p50_ms": 1e3 * lat[len(lat) // 2], "p99_ms": 1e3 * lat[min(len(lat) - 1,
                                                                   int(0.99 * len(lat)))],
        "stats": dict(s), "launches": launches, "rank_filter_width": tier.filters.width + 1,
    }
    log(f"serve: {nreq} requests ({rows} query rows) in {s['batches']} batches over two "
        f"versions in {serve_s:.3f}s: {res['qps_requests']:.1f} req/s, "
        f"{res['qps_rows']:.1f} rows/s, p50 {res['p50_ms']:.2f} ms, p99 {res['p99_ms']:.2f} ms")
    log(f"serve: launches during the main path {launches}; stats {s}")
    return tier, m, (v0, v1), waves, res


def recheck_served(torch, np, models, ops, tier, m, versions, waves, dev):
    """Sampled served requests against the plain versions on the same card."""
    n_rank = n_topk = n_diff = 0
    err = 0.0
    for wave, reqs in enumerate(waves):
        params = versions[wave]
        for i, (kind, q, req) in enumerate(reqs):
            if i % CHECK_EVERY:
                continue
            h = torch.as_tensor(q[:, 0], device=dev)
            r = torch.as_tensor(q[:, 1], device=dev)
            qv, table, mode = models.lp_query_tails(params, m, h, r)
            plain = ops.pairwise_scores_plain(qv, table, mode, block_e=16384)
            if kind == "rank":
                t = torch.as_tensor(q[:, 2], device=dev)
                gold = models.lp_gold_scores(qv, table, t, mode)
                filt = torch.as_tensor(tier.filters.rows_for(q[:, 0], q[:, 1]), device=dev)
                filt = torch.cat([t.int()[:, None], filt], 1)
                cp = ops.fused_ranks_plain(qv, table, gold, filt, mode, block_e=16384)
                got = torch.as_tensor(req.result - 1, device=dev)
                nd, _ = check_ranks(torch, got, cp, plain, gold, f"served rank request {i}")
                n_diff += nd
                n_rank += 1
            else:
                k = req.k
                filt = torch.as_tensor(tier.filters.rows_for(q[:, 0], q[:, 1]), device=dev)
                masked = plain.masked_fill(ops.exclusion_mask(filt, 0, plain.shape[1]),
                                           float("-inf"))
                vals, order = torch.sort(masked, dim=1, descending=True, stable=True)
                pv, pi = vals[:, :k].cpu().numpy(), order[:, :k].cpu().numpy()
                ids, sv = req.result
                err = max(err, float(np.abs(sv - pv).max()))
                check(np.allclose(sv, pv, rtol=0, atol=1e-4), f"top-k request {i}: scores")
                differ = ids != pi
                if differ.any():
                    got_plain = masked.gather(1, torch.as_tensor(
                        np.where(ids < 0, 0, ids), device=dev).long()).cpu().numpy()
                    check(bool(np.all(np.abs(got_plain[differ] - pv[differ])
                                      <= 1e-5 * (1 + np.abs(pv[differ])))),
                          f"top-k request {i}: ids differ beyond near-ties")
                    n_diff += int(differ.any(1).sum())
                n_topk += 1
    log(f"recheck: {n_rank} rank and {n_topk} top-k requests against the plain versions: "
        f"ok ({n_diff} rows differ only at near-ties; top-k max|err| {err:.3g})")
    return err


# ------------------------------------------------------------ phase 4
def time_ms(torch, fn, iters, warmup=3):
    """Median milliseconds of ``fn`` over ``iters`` runs, each between two
    CUDA events on the current stream. On an idle stream the events also
    bracket the host's time to launch: a call's time, not the device's."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def score_ops(mode, b, e, d):
    """(fp32 instructions, square roots) of a (B, E) score matrix in ``mode``:
    l1 two instructions per element (a subtract, then an add with the |.|
    modifier); dot one FMA per element; l2 one FMA per element, the norms
    (E·d + B·d FMAs) and a root per score; cl1 six per complex pair (two
    subtracts, a multiply, an FMA, the 1e-12, the sum) and a root per pair."""
    if mode == "l1":
        return 2 * b * e * d, 0
    if mode == "dot":
        return b * e * d, 0
    if mode == "l2":
        return b * e * d + e * d + b * d, b * e
    return 6 * b * e * (d // 2), b * e * (d // 2)


def score_bound(mode, b, e, d, nbytes, card):
    """Least time of a triple_score kernel: the bytes at the memory rate,
    or its fp32 instructions at the fp32 pipe's instruction rate (half the
    FMA FLOP rate: 33.5 T/s on an H100 SXM) and its roots at the
    special-function rate (an eighth of that), whichever is longer."""
    mem_rate, fp32_rate, _ = peak_rates(card)
    instr, roots = score_ops(mode, b, e, d)
    t_bytes = nbytes / mem_rate
    t_ops = max(instr / (fp32_rate / 2), roots / (fp32_rate / 16))
    return dict(bound_ms=1e3 * max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=nbytes, instructions=instr, roots=roots)


def score_kernel_times(torch, ops, q, table, gold, filt, mode, chunk, card):
    """Both triple_score kernels at one batch: each output at exactly the
    timed shapes (every top-k chunk, the ragged last one included) held
    against its plain version with the rules of phase 2, then kernel, plain
    version and library yardstick timed beside the bound. ``ops`` is a
    ``triple_score.ops`` module (``tools/time_triple_score.py`` passes
    another checkout's)."""
    b, d = q.shape
    e = table.shape[0]
    f = filt.shape[1]
    chunks = [(c0, min(c0 + chunk, e)) for c0 in range(0, e, chunk)]
    out = {}

    def pairwise():
        return [ops.pairwise_scores(q, table[c0:c1], mode=mode) for c0, c1 in chunks]

    def pairwise_plain():
        return [ops.pairwise_scores_plain(q, table[c0:c1], mode, block_e=16384)
                for c0, c1 in chunks]

    def fused():
        return ops.fused_ranks(q, table, gold, filt, mode=mode)

    def fused_plain():
        return ops.fused_ranks_plain(q, table, gold, filt, mode, block_e=16384)

    kernel_chunks, plain_chunks = pairwise(), pairwise_plain()
    pair_err = 0.0
    for (c0, c1), got, want in zip(chunks, kernel_chunks, plain_chunks):
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-5,
                                   msg=lambda m: f"pairwise chunk [{c0}, {c1}): {m}")
        pair_err = max(pair_err, float((got - want).abs().max()))
    plain_scores = torch.cat(plain_chunks, 1)
    del kernel_chunks, plain_chunks
    ndiff, rank_err = check_ranks(torch, fused(), fused_plain(), plain_scores, gold,
                                  f"fused ranks {mode} B={b} E={e} F={f}")
    del plain_scores
    log(f"check at the timed shapes ({mode}, B={b}): pairwise over {len(chunks)} chunks "
        f"(last {chunks[-1][1] - chunks[-1][0]} rows) max|err|={pair_err:.3g} ok; rank "
        f"counts differ on {ndiff}/{b} queries, all within near-ties")

    # fused ranks: one launch over the whole table per batch
    out["fused_ranks"] = dict(
        ms=time_ms(torch, fused, ITERS),
        device_ms=time_device_ms(torch, fused, DEVICE_CALLS, DEVICE_RUNS),
        plain_ms=time_ms(torch, fused_plain, max(3, ITERS // 4)), library_ms=None,
        **score_bound(mode, b, e, d, 4 * (b * d + e * d + b + b * f + b), card),
        shape=f"B={b} E={e} d={d} F={f} mode={mode}", launches_per_batch=1,
        max_abs_err=rank_err,
    )

    # pairwise scores: the top-k path's launches over one batch, chunk by chunk
    def library():
        for c0, c1 in chunks:
            if mode == "dot":
                q @ table[c0:c1].T
            else:
                torch.cdist(q, table[c0:c1], p=1 if mode == "l1" else 2)

    out["pairwise_scores"] = dict(
        ms=time_ms(torch, pairwise, ITERS),
        device_ms=time_device_ms(torch, pairwise, DEVICE_CALLS, DEVICE_RUNS),
        plain_ms=time_ms(torch, pairwise_plain, max(3, ITERS // 4)),
        library_ms=time_ms(torch, library, ITERS),
        **score_bound(mode, b, e, d, 4 * (b * d + e * d + b * e), card),
        shape=f"B={b} E={e} d={d} mode={mode}, {len(chunks)} launches of <= {chunk} rows",
        launches_per_batch=len(chunks), max_abs_err=pair_err,
    )
    for name in ("fused_ranks", "pairwise_scores"):
        x = out[name]
        lib = "n/a" if x["library_ms"] is None else f"{x['library_ms']:.4f}"
        log(f"time {name} [{x['shape']}]: kernel {x['ms']:.4f} ms ({x['device_ms']:.4f} ms "
            f"device time), plain {x['plain_ms']:.4f} ms, library {lib} ms, bound "
            f"{x['bound_ms']:.4f} ms ({x['bound_by']}: {x['bytes']:.4g} B, "
            f"{x['instructions']:.4g} fp32 instructions), {100 * x['bound_ms'] / x['ms']:.1f}% "
            f"of bound ({100 * x['bound_ms'] / x['device_ms']:.1f}% by device time); {card}")
    return out


def topk_times(torch, ops, engine, q, table, filt, mode, k, card, *, plain=True):
    """The fused top-k kernel at one batch: its output held bit for bit
    against the chunked scan over the pairwise kernel (the path it replaced:
    ``CUDA_TOPK_CHUNK``-row launches, masks, keys and ``torch.topk``) and,
    with ``plain``, against its plain version; then kernel, scan and plain
    version timed beside the least time of the scoring."""
    b, d = q.shape
    e = table.shape[0]

    def fused():
        return ops.pairwise_topk(q, table, filt, k=k, mode=mode)

    def scan():
        return ops.topk_scan(lambda c0, c1: ops.pairwise_scores(q, table[c0:c1], mode=mode),
                             b, e, filt, k=k, chunk=engine.CUDA_TOPK_CHUNK, device=q.device)

    def fused_plain():
        return ops.pairwise_topk_plain(q, table, filt, k, mode, block_e=4096)

    (fv, fi), (sv, si) = fused(), scan()
    check(torch.equal(fv, sv) and torch.equal(fi, si),
          f"fused top-k {mode} B={b}: not bit-equal to the chunked scan")
    err = check_topk(torch, fv, fi, *fused_plain(), f"fused top-k {mode} B={b}")[0] \
        if plain else 0.0
    del fv, fi, sv, si
    x = dict(
        ms=time_ms(torch, fused, ITERS),
        device_ms=time_device_ms(torch, fused, DEVICE_CALLS, DEVICE_RUNS),
        plain_ms=time_ms(torch, fused_plain, 3) if plain else None, library_ms=None,
        scan_ms=time_ms(torch, scan, max(3, ITERS // 4)),
        **score_bound(mode, b, e, d, 4 * (b * d + e * d + b * filt.shape[1]) + 8 * b * k,
                      card),
        shape=f"B={b} E={e} d={d} F={filt.shape[1]} k={k} mode={mode}",
        launches_per_batch=2, max_abs_err=err,
    )
    plain_s = "not timed" if x["plain_ms"] is None else f"{x['plain_ms']:.4f} ms"
    log(f"time pairwise_topk [{x['shape']}]: kernel {x['ms']:.4f} ms ({x['device_ms']:.4f} "
        f"ms device time), chunked scan {x['scan_ms']:.4f} ms, plain {plain_s}, bound "
        f"{x['bound_ms']:.4f} ms ({x['bound_by']}: {x['instructions']:.4g} fp32 "
        f"instructions), {100 * x['bound_ms'] / x['device_ms']:.1f}% of bound by device "
        f"time; {card}")
    return x


#: batches timed beside the serving batch: (label, mode, rows)
SCORE_SHAPES = (("l1 B=8", "l1", 8), ("dot B=64", "dot", SERVE_BATCH))


def timings(torch, models, ops, engine, m, params, known_filters, dev, card):
    """Kernel, plain and library times at the serving batch (B = 64, the
    model's mode), then at B = 8 and in dot mode on the same rows."""
    e = params["ent"].shape[0]
    b = SERVE_BATCH
    g = torch.Generator(device=dev).manual_seed(5)
    h = torch.randint(0, e, (b,), device=dev, generator=g)
    r = torch.randint(0, m.num_relations, (b,), device=dev, generator=g)
    t = torch.randint(0, e, (b,), device=dev, generator=g)
    q, table, mode = models.lp_query_tails(params, m, h, r)
    q = q.contiguous()
    filt = torch.as_tensor(known_filters.rows_for(h.cpu().numpy(), r.cpu().numpy()), device=dev)
    filt = torch.cat([t.int()[:, None], filt], 1).contiguous()
    out = score_kernel_times(torch, ops, q, table, models.lp_gold_scores(q, table, t, mode),
                             filt, mode, engine.CUDA_TOPK_CHUNK, card)
    out["shapes"] = {}
    for label, mode_, rows in SCORE_SHAPES:
        qs = q[:rows].contiguous()
        gold = models.lp_gold_scores(qs, table, t[:rows], mode_)
        out["shapes"][label] = score_kernel_times(torch, ops, qs, table, gold,
                                                  filt[:rows].contiguous(), mode_,
                                                  engine.CUDA_TOPK_CHUNK, card)
    # the fused top-k at the serving batch and at the tier's 2,048-row bucket
    known_filt = torch.as_tensor(known_filters.rows_for(h.cpu().numpy(), r.cpu().numpy()),
                                 device=dev)
    out["pairwise_topk"] = topk_times(torch, ops, engine, q, table, known_filt, mode, TOPK_K,
                                      card)
    h2 = torch.randint(0, e, (TIER_BUCKET,), device=dev, generator=g)
    r2 = torch.randint(0, m.num_relations, (TIER_BUCKET,), device=dev, generator=g)
    q2, _, _ = models.lp_query_tails(params, m, h2, r2)
    filt2 = torch.as_tensor(known_filters.rows_for(h2.cpu().numpy(), r2.cpu().numpy()),
                            device=dev)
    out["shapes"][f"topk B={TIER_BUCKET}"] = {"pairwise_topk": topk_times(
        torch, ops, engine, q2.contiguous(), table, filt2, mode, TOPK_K, card, plain=False)}
    return out


def request_times(torch, np, serving, m, params, filters, card):
    """Host-clock time of one 64-row rank request and one 64-row top-k
    request through a ``KGECandidateRanker`` (query build, launches, merges
    and the copy of the answer to the host): the median of ``ITERS``."""
    ranker = serving.KGECandidateRanker(params, m, filters=filters)
    q = draw_known(np, 11, m.num_entities, m.num_relations, SERVE_BATCH)
    out = {}
    for name, fn in (("rank_ms", lambda: ranker.rank_tails(q[:, 0], q[:, 1], q[:, 2])),
                     ("topk_k20_ms", lambda: ranker.topk_tails(q[:, 0], q[:, 1], k=20))):
        fn()
        times = []
        for _ in range(ITERS):
            t0 = time.perf_counter()
            fn()
            times.append(1e3 * (time.perf_counter() - t0))
        out[name] = statistics.median(times)
    log(f"time requests (B={SERVE_BATCH}, ranker, host clock): rank {out['rank_ms']:.3f} ms, "
        f"top-k k=20 {out['topk_k20_ms']:.3f} ms; {card}")
    out["topk_host_split"] = topk_host_split(
        torch, lambda: ranker.topk_tails(q[:, 0], q[:, 1], k=20), card)
    return out


def topk_host_split(torch, request, card):
    """Where the host's time of one top-k request goes: a ``torch.profiler``
    window over one request, operators by self CPU time (device time beside),
    and the window's host-clock total."""
    from torch.profiler import ProfilerActivity, profile

    request()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        request()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    rows = sorted(prof.key_averages(), key=lambda a: -a.self_cpu_time_total)
    cpu_ms = sum(a.self_cpu_time_total for a in rows) / 1e3
    top = [(a.key[:60], a.count, a.self_cpu_time_total / 1e3,
            getattr(a, "self_device_time_total", getattr(a, "self_cuda_time_total", 0)) / 1e3)
           for a in rows[:12]]
    log(f"top-k host split (one 64-row request under the profiler): {wall_ms:.3f} ms host "
        f"clock, {cpu_ms:.3f} ms self CPU time in operators; {card}")
    for name, count, cpu, devt in top:
        log(f"top-k host split:   {cpu:8.3f} ms CPU {devt:8.3f} ms device  x{count:<4d} {name}")
    return {"wall_ms": wall_ms, "cpu_ms": cpu_ms, "top": top}


def device_us_by_name(prof):
    """Device microseconds by kernel name over a finished torch.profiler
    window, summed from the raw trace: ``prof.events()`` first builds a
    Python tree of every event, seconds for a window of many operators."""
    from torch.autograd import DeviceType

    out = {}
    for evt in prof.profiler.kineto_results.events():
        if evt.device_type() == DeviceType.CUDA and not getattr(
                evt, "is_hidden_event", lambda: False)():
            out[evt.name()] = out.get(evt.name(), 0.0) + evt.duration_ns() / 1e3
    return out


def profile_serving(torch, np, tier, m, seed, card):
    """Device time by kernel and the device's idle share while the tier
    drains a mixed burst (torch.profiler, CUDA activity)."""
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(seed + 99)
    for i in range(48):
        q = draw_known(np, int(rng.integers(1 << 30)), m.num_entities, m.num_relations,
                       int(rng.integers(1, 17)))
        if i % 6:
            tier.submit_rank(q[:, 0], q[:, 1], q[:, 2])
        else:
            tier.submit_topk(q[:, 0], q[:, 1], k=10)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tier.run_until_drained()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    by_name = device_us_by_name(prof)
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    res = {"wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
           "idle_share": None if busy == 0 else 1 - busy / wall_us,
           "top": [(name[:90], us / 1e3) for name, us in top]}
    if busy == 0:
        log("profile: the profiler saw no device activity; idle share not measured")
    else:
        log(f"profile: burst of 48 requests drained in {res['wall_ms']:.2f} ms, device busy "
            f"{res['device_busy_ms']:.2f} ms, idle share {res['idle_share']:.3f}; {card}")
        for name, ms in res["top"]:
            log(f"profile:   {ms:9.3f} ms  {100 * ms * 1e3 / busy:5.1f}%  {name}")
    return res


# ------------------------------------------------------------ phase 5
def hard_batch(torch, np, rng, e, r, b, dev):
    """(pos, neg) int64 (b, 3) on ``dev``: a hub entity in most occurrences,
    ids 0 and e−1 present, and rows shared by pos and neg."""
    pos = np.stack([rng.integers(0, e, b), rng.integers(0, r, b), rng.integers(0, e, b)], 1)
    neg = pos.copy()
    side = rng.random(b) < 0.5
    rand = rng.integers(0, e, b)
    neg[side, 0] = rand[side]
    neg[~side, 2] = rand[~side]
    hub = int(rng.integers(1, e - 1))
    pos[: (2 * b) // 3, 0] = hub
    neg[: b // 3, 2] = hub
    pos[-1, 2] = 0
    neg[-1, 0] = e - 1
    neg[1, 0] = pos[2, 2]
    return (torch.as_tensor(pos.astype(np.int64), device=dev),
            torch.as_tensor(neg.astype(np.int64), device=dev))


def max_err(a, b):
    return float((a - b).abs().max())


def step_vs_plain(torch, np, models, sops, dev, seed, e, r):
    """The sparse SGD kernel against its plain version on the card, every
    mode: one step (an epoch of one batch), then one launch of 64 steps
    against the plain step loop, twice for the kernel (bit-equal), and on a
    12-row table where every step re-reads rows the step before wrote."""
    worst = 0.0
    rng = np.random.default_rng(seed + 5)
    for b, d in ((TRAIN_BATCH, DIM), (37, 33)):
        start = models.init_kge(seed + d, models.KGEModel("transe", e, r, d), device=dev)
        batches = [hard_batch(torch, np, rng, e, r, b, dev) for _ in range(STEP_TRAJECTORY)]
        pos = torch.stack([p for p, _ in batches])
        neg = torch.stack([n for _, n in batches])
        for mode in sops.SPARSE_MODES:
            ke, kr, pe, pr = (start[k].clone() for k in ("ent", "rel", "ent", "rel"))
            kl = sops.fused_sparse_step(ke, kr, *batches[0], TRAIN_LR, mode=mode)[2]
            pl = sops.sparse_step_plain(pe, pr, *batches[0], TRAIN_LR, mode=mode)
            torch.cuda.synchronize()
            err1 = max(max_err(ke, pe), max_err(kr, pr))
            torch.testing.assert_close(ke, pe, atol=1e-6, rtol=0, msg=lambda m: f"{mode}: {m}")
            torch.testing.assert_close(kr, pr, atol=1e-6, rtol=0, msg=lambda m: f"{mode}: {m}")
            torch.testing.assert_close(kl, pl, atol=0, rtol=1e-6, msg=lambda m: f"{mode}: {m}")
            runs = []
            for _ in range(2):
                ke, kr = start["ent"].clone(), start["rel"].clone()
                before = sops.LAUNCHES["sparse_sgd_step"]
                losses = sops.fused_sparse_epoch(ke, kr, pos, neg, TRAIN_LR, mode=mode)
                check(sops.LAUNCHES["sparse_sgd_step"] == before + 1,
                      f"{STEP_TRAJECTORY} steps took more than one launch")
                runs.append((ke, kr, losses))
            pe, pr = start["ent"].clone(), start["rel"].clone()
            plosses = sops.sparse_epoch_plain(pe, pr, pos, neg, TRAIN_LR, mode=mode)
            torch.cuda.synchronize()
            check(all(torch.equal(x, y) for x, y in zip(*runs)),
                  f"sparse epoch {mode} B={b} d={d}: two kernel runs of {STEP_TRAJECTORY} "
                  f"steps differ")
            err64 = max(max_err(runs[0][0], pe), max_err(runs[0][1], pr))
            torch.testing.assert_close(runs[0][0], pe, atol=1e-5, rtol=0)
            torch.testing.assert_close(runs[0][1], pr, atol=1e-5, rtol=0)
            torch.testing.assert_close(runs[0][2], plosses, atol=0, rtol=1e-5)
            worst = max(worst, err1, err64)
            log(f"check sparse step {mode:3s} E={e} R={r} B={b} d={d}: one step max|err|="
                f"{err1:.3g}, loss {float(kl):.6f} vs {float(pl):.6f}; {STEP_TRAJECTORY} steps "
                f"in one launch max|err|={err64:.3g}; reruns bit-equal")
            del runs, ke, kr, pe, pr
        del start, pos, neg, batches
    # a 12-row table: every step reads rows that other SMs wrote the step before
    for mode in sops.SPARSE_MODES:
        te = torch.as_tensor(rng.normal(0, 0.3, (12, 33)).astype("float32"), device=dev)
        tr = torch.as_tensor(rng.normal(0, 0.3, (3, 33)).astype("float32"), device=dev)
        batches = [hard_batch(torch, np, rng, 12, 3, 8, dev) for _ in range(STEP_TRAJECTORY)]
        pos = torch.stack([p for p, _ in batches])
        neg = torch.stack([n for _, n in batches])
        pe, pr = te.clone(), tr.clone()
        kl = sops.fused_sparse_epoch(te, tr, pos, neg, 0.1, mode=mode)
        pl = sops.sparse_epoch_plain(pe, pr, pos, neg, 0.1, mode=mode)
        torch.cuda.synchronize()
        err = max(max_err(te, pe), max_err(tr, pr))
        torch.testing.assert_close(te, pe, atol=1e-5, rtol=0)
        torch.testing.assert_close(tr, pr, atol=1e-5, rtol=0)
        torch.testing.assert_close(kl, pl, atol=1e-6, rtol=1e-5)
        worst = max(worst, err)
        log(f"check sparse epoch {mode:3s} on a 12-row table, {STEP_TRAJECTORY} steps in one "
            f"launch: max|err|={err:.3g} (atol 1e-5) ok")
    return worst


# ------------------------------------------------------------ phase 6
def make_kg(np, seed, e, r, known, name="dbpedia-uniform"):
    """The training KG: the known store as the training split, valid and
    test ``MAX_TEST`` triples each sampled from it."""
    from repro_torch.kge.data import KG

    rng = np.random.default_rng(seed + 13)
    kg = KG(name, e, r, known, np.arange(e))
    kg.train = known
    n = min(MAX_TEST, len(known))
    kg.valid = known[rng.choice(len(known), n, replace=False)]
    kg.test = known[rng.choice(len(known), n, replace=False)]
    return kg


def train_path(torch, np, models, ops, sops, tier, dev, args, known, sizes):
    """The training path: one epoch through ``KGETrainer``, scored before
    and after, then published and trained on past the publish."""
    from repro_torch.kge import engine
    from repro_torch.kge import eval as keval
    from repro_torch.kge.trainer import KGETrainer

    e, r = sizes
    kg = make_kg(np, args.seed, e, r, known)
    t0 = time.perf_counter()
    trainer = KGETrainer(kg, "transe", dim=DIM, lr=TRAIN_LR, batch_size=TRAIN_BATCH,
                         margin=4.0, seed=args.seed, device=dev)
    pre = keval.build_score_inputs(kg, max_test=MAX_TEST)
    setup_s = time.perf_counter() - t0
    before = {"link_prediction": keval.link_prediction(trainer.params, trainer.model, kg,
                                                       precomputed=pre),
              "triple_classification": keval.triple_classification_accuracy(
                  trainer.params, trainer.model, kg, seed=args.seed)}

    padded = {}
    strip = engine.strip_tables

    def keep_padded(params, model):  # the padded tables, to read their padding rows
        padded.update(params)
        return strip(params, model)

    engine.strip_tables = keep_padded
    nb = 1 << (-(-len(kg.train) // TRAIN_BATCH) - 1).bit_length()
    try:
        sops.reset_launches()
        ops.reset_launches()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        loss = trainer.train_epochs(1)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        epoch_s = time.perf_counter() - t0
        launches = {**sops.LAUNCHES, **ops.LAUNCHES}
        steps = dict(sops.STEPS)
    finally:
        engine.strip_tables = strip
    if dev.type == "cuda":
        check(launches["sparse_sgd_step"] == 1 and steps["sparse_sgd_step"] == nb,
              f"the epoch launched the step kernel {launches['sparse_sgd_step']} times for "
              f"{steps['sparse_sgd_step']} steps, not once for {nb}")
    check(bool(np.isfinite(loss)), f"epoch loss {loss} is not finite")
    for k, v in padded.items():
        n = e if k in engine.ENT_KEYS else r
        check(not bool(v[n:].any()), f"padding rows of {k} moved")
    res = {"epoch_s": epoch_s, "steps": nb, "steps_per_s": nb / epoch_s, "loss": loss,
           "n_pad": nb * TRAIN_BATCH, "e_pad": padded["ent"].shape[0],
           "renorm": engine.resolve_renorm(nb * TRAIN_BATCH, padded["ent"].shape[0]),
           "launches": launches, "steps_run": steps, "setup_s": setup_s}
    del padded
    log(f"train: E={e} R={r} train={len(kg.train)} transe/l1 d={DIM} lr={TRAIN_LR} "
        f"B={TRAIN_BATCH} on {dev}: one epoch of {nb} steps (N_pad={res['n_pad']}, "
        f"e_pad={res['e_pad']}, renorm {res['renorm']}) in {epoch_s:.3f}s host clock, "
        f"{res['steps_per_s']:.1f} steps/s, loss {loss:.6f}; launches {launches}")

    ops.reset_launches()
    after = {"link_prediction": keval.link_prediction(trainer.params, trainer.model, kg,
                                                      precomputed=pre),
             "triple_classification": keval.triple_classification_accuracy(
                 trainer.params, trainer.model, kg, seed=args.seed)}
    res["eval_launches"] = dict(ops.LAUNCHES)
    if dev.type == "cuda":
        check(ops.LAUNCHES["fused_ranks"] > 0, "link prediction never launched fused_ranks")
    for when, x in (("before", before), ("after", after)):
        lp = x["link_prediction"]
        check(all(np.isfinite(v) for v in lp.values()), f"link prediction {when}: {lp}")
        log(f"eval {when} the epoch: filtered Hit@10 {lp['hit@10']:.4f}, Hit@1 "
            f"{lp['hit@1']:.4f}, mean rank {lp['mean_rank']:.1f} over {2 * len(pre[0])} "
            f"ranks; triple classification {x['triple_classification']:.4f}")
    res["before"], res["after"] = before, after

    # one chunk of the trained tables' ranks against the plain count
    test, filt_t, _ = pre
    ch = torch.as_tensor(test[:128].astype(np.int64), device=dev)
    q, table, mode = models.lp_query_tails(trainer.params, trainer.model, ch[:, 0], ch[:, 1])
    q = q.contiguous()
    gold = models.lp_gold_scores(q, table, ch[:, 2], mode)
    filt = torch.as_tensor(filt_t[:128], device=dev)
    plain = ops.pairwise_scores_plain(q, table, mode, block_e=16384)
    ndiff, _ = check_ranks(torch, ops.fused_ranks(q, table, gold, filt, mode=mode),
                           ops.fused_ranks_plain(q, table, gold, filt, mode, block_e=16384),
                           plain, gold, "trained tables, tail ranks of 128 test triples")
    del plain
    log(f"check trained tables: tail rank counts of 128 test triples differ from the plain "
        f"count on {ndiff}/128, all within near-ties")

    # publish, train one more step in place, and the published version holds
    tv = tier.publish(trainer.params)
    qt = kg.test[:16]
    first = tier.submit_rank(qt[:, 0], qt[:, 1], qt[:, 2])
    tier.run_until_drained()
    heads = torch.as_tensor(qt[:, 0].astype(np.int64), device=dev)
    rows_before = trainer.params["ent"][heads].clone()
    rng = np.random.default_rng(args.seed + 17)
    pos = torch.as_tensor(kg.test[:TRAIN_BATCH].astype(np.int64), device=dev)
    neg = pos.clone()
    neg[:, 2] = torch.as_tensor(rng.integers(0, e, len(neg)), device=dev)
    sops.fused_sparse_step(trainer.params["ent"], trainer.params["rel"], pos, neg, TRAIN_LR)
    again = tier.submit_rank(qt[:, 0], qt[:, 1], qt[:, 2])
    tier.run_until_drained()
    check(not torch.equal(trainer.params["ent"][heads], rows_before),
          "the step after the publish did not move the trainer's rows")
    check(first.version == again.version == tv.version and first.state == again.state
          == "served", f"published version not served: {first.version}, {again.version}")
    check(np.array_equal(first.result, again.result) and bool(torch.equal(
        tv.params["ent"][heads], rows_before)),
          "the published version changed when its source tables were trained")
    log(f"publish: version {tv.version} answered 16 rank requests identically before and "
        f"after a step trained the source tables in place")
    return trainer, res


# ------------------------------------------------------------ phase 7
def time_device_ms(torch, fn, per_run, runs):
    """Median device milliseconds of one ``fn`` call: ``per_run`` calls
    queued behind a device-side sleep, so the events bracket device
    execution back to back and not the host's enqueue rate."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        torch.cuda._sleep(100_000_000)  # ~50 ms at 2 GHz: the host enqueues meanwhile
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(per_run):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / per_run)
    return statistics.median(times)


def epoch_inputs(torch, engine, trainer, seed):
    """Padded copies of the trainer's tables and one epoch's (nb, B, 3)
    batches over its padded training store, drawn as the engine draws them."""
    params, _, _ = engine.pad_tables(trainer.params, trainer.model)
    dev = params["ent"].device
    tri = engine.pad_triples(torch.as_tensor(trainer.kg.train.astype("int64"), device=dev),
                             TRAIN_BATCH)
    nb = tri.shape[0] // TRAIN_BATCH
    gen = torch.Generator(device=dev).manual_seed(seed)
    drawn = engine.draw_epoch(gen, tri.shape[0], nb, TRAIN_BATCH, trainer.model.num_entities)
    return params, engine.epoch_batches(tri, drawn, TRAIN_BATCH)


def step_timings(torch, np, sops, engine, trainer, dev, card):
    """The epoch kernel at the training shape: device time of one launch over
    a whole epoch, one lone step between events
    (host launch included), the plain step loop over the same epoch, and the
    bound per epoch and per step."""
    mem_rate, _, _ = peak_rates(card)
    params, (pos, neg) = epoch_inputs(torch, engine, trainer, 3)
    ent, rel = params["ent"], params["rel"]
    e, d = ent.shape
    r = rel.shape[0]
    nb = pos.shape[0]

    def epoch():
        return sops.fused_sparse_epoch(ent, rel, pos, neg, TRAIN_LR)

    def step():
        return sops.fused_sparse_step(ent, rel, pos[0], neg[0], TRAIN_LR)

    # least bytes: in each step every unique row read once and written once,
    # the step's ids read, its loss written
    def unique_per_step(occ):
        srt = occ.sort(dim=1).values
        return (srt[:, 1:] != srt[:, :-1]).sum(1) + 1

    ue = unique_per_step(torch.cat([pos[..., 0], pos[..., 2], neg[..., 0], neg[..., 2]], 1))
    ur = unique_per_step(torch.cat([pos[..., 1], neg[..., 1]], 1))
    nbytes = int(2 * 4 * d * int((ue + ur).sum())) + 8 * 6 * TRAIN_BATCH * nb + 4 * nb
    runs = max(3, ITERS // 2)
    out = dict(
        ms=time_device_ms(torch, epoch, 1, runs),
        call_ms=time_ms(torch, step, ITERS),
        library_ms=None, bound_ms=1e3 * nbytes / mem_rate, bound_by="bytes", bytes=nbytes,
        steps=nb, unique_rows_per_step=(float(ue.float().mean()), float(ur.float().mean())),
        shape=f"E={e} R={r} d={d} B={TRAIN_BATCH} steps={nb} mode=l1",
    )
    # the plain version over the same epoch, once: a Python loop of ~1 ms steps
    torch.cuda.synchronize()
    a_, b_ = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a_.record()
    sops.sparse_epoch_plain(ent, rel, pos, neg, TRAIN_LR)
    b_.record()
    b_.synchronize()
    out["plain_ms"] = a_.elapsed_time(b_)
    out["device_ms"] = out["ms"]
    for k in ("ms", "plain_ms", "bound_ms"):
        out[k.replace("ms", "ms_per_step")] = out[k] / nb
    log(f"time sparse_sgd_step [{out['shape']}; {out['unique_rows_per_step'][0]:.1f} + "
        f"{out['unique_rows_per_step'][1]:.1f} unique rows a step]: kernel {out['ms']:.4f} ms "
        f"device time per epoch launch ({1e3 * out['ms_per_step']:.3f} us a step, a cluster of "
        f"{sops.CLUSTER_BLOCKS} blocks), one lone "
        f"step {out['call_ms']:.4f} ms between events, plain {out['plain_ms']:.1f} ms per epoch "
        f"({out['plain_ms_per_step']:.4f} ms a "
        f"step), library none, bound {out['bound_ms']:.4f} ms per epoch "
        f"({1e3 * out['bound_ms_per_step']:.5f} us a step; bytes: {nbytes}), "
        f"{100 * out['bound_ms'] / out['ms']:.2f}% of bound; {card}")
    del params, pos, neg
    return out


def profile_training(torch, engine, trainer, card):
    """Device busy time and idle share over one training epoch of the
    engine (``train_epochs_device`` on copies of the trainer's tables: the
    padding, the draws, the batches, one epoch-kernel launch, the norm
    projection, the strip), under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    dev = trainer.params["ent"].device
    tri = torch.as_tensor(trainer.kg.train.astype("int64"), device=dev)

    def one_epoch(seed):
        gen = torch.Generator(device=dev).manual_seed(seed)
        return engine.train_epochs_device(trainer.params, trainer.model, tri, epochs=1,
                                          batch_size=TRAIN_BATCH, lr=TRAIN_LR, impl="fused",
                                          generator=gen)

    one_epoch(1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, losses = one_epoch(2)
        float(losses[-1])
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    by_name = device_us_by_name(prof)
    busy = sum(by_name.values())
    res = {"epochs": 1, "wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
           "idle_share": None if busy == 0 else 1 - busy / wall_us,
           "top": [(k[:90], v / 1e3) for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])]}
    if busy == 0:
        log("profile train: the profiler saw no device activity; idle share not measured")
    else:
        log(f"profile train: one epoch in {res['wall_ms']:.2f} ms, device busy "
            f"{res['device_busy_ms']:.3f} ms, idle share {res['idle_share']:.3f}; {card}")
        for name, ms in res["top"][:6]:
            log(f"profile train:   {ms:9.3f} ms  {100 * ms * 1e3 / busy:5.1f}%  {name}")
    return res


# ------------------------------------------------------------ phase 8
def cosine_vs_plain(torch, ck, al, dev, seed):
    """The cosine kernel against its plain version on the card: ragged
    shapes with a zero row on each side, CSLS around it, and the blockwise
    retrieval argmax against the whole plain CSLS matrix."""
    worst = 0.0
    g = torch.Generator(device=dev).manual_seed(seed + 8)
    for n, m, d in ((1000, 777, 100), (129, 4097, 33)):
        a = torch.randn(n, d, device=dev, generator=g)
        b = torch.randn(m, d, device=dev, generator=g)
        a[n // 2] = 0.0
        b[m - 1] = 0.0
        got, want = ck.cosine_matrix(a, b), ck.cosine_matrix_plain(a, b)
        torch.cuda.synchronize()
        err = max_err(got, want)
        torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
        check(not bool(got[n // 2].any()) and not bool(got[:, m - 1].any()),
              f"cosine ({n}, {m}, {d}): a zero row's cosines are not exactly 0")
        r_a, r_b = ck.topk_means(want, 10)
        s = ck.csls_matrix(a, b)
        s_err = max_err(s, 2 * want - r_a[:, None] - r_b[None, :])
        # 2·cos (2e-5) plus two top-k means (1e-5 each)
        check(s_err <= 4e-5, f"csls_matrix ({n}, {m}, {d}) max|err| {s_err} > 4e-5")
        worst = max(worst, err)
        log(f"check cosine ({n}, {m}, d={d}) with zero rows: max|err|={err:.3g} (atol 1e-5) "
            f"ok; csls_matrix max|err|={s_err:.3g} (atol 4e-5) ok")
    n = CHECK_RETRIEVAL
    x = torch.randn(n, DIM, device=dev, generator=g)
    q, _ = torch.linalg.qr(torch.randn(DIM, DIM, device=dev, generator=g))
    a = (x @ q).contiguous()
    # noise 2.5 puts about half the rows' CSLS argmax off the diagonal
    y = (a + 2.5 * torch.randn(n, DIM, device=dev, generator=g)).contiguous()
    got = al.csls_argmax(a, y, block=RETRIEVAL_BLOCK)
    plain = ck.cosine_matrix_plain(a, y)
    r_a, r_b = ck.topk_means(plain, 10)
    full = 2 * plain - r_a[:, None] - r_b[None, :]
    want = full.argmax(1)
    rows = torch.arange(n, device=dev)
    differ = got != want
    gap = (full[rows, got] - full[rows, want]).abs()
    check(bool((gap[differ] <= 1e-5).all()), "blockwise CSLS argmax differs from the full "
          f"plain matrix beyond near-ties (max gap {float(gap.max()):.3g})")
    acc_block = float((got == rows).double().mean())
    acc_full = float((want == rows).double().mean())
    log(f"check blockwise CSLS retrieval n = m = {n}, d={DIM}, blocks of {RETRIEVAL_BLOCK}: "
        f"{int(differ.sum())} argmaxes differ from the full plain matrix, all near-ties; "
        f"accuracy {acc_block:.6f} vs {acc_full:.6f}")
    return worst


# ------------------------------------------------------------ phase 9
def make_client_kg(np, seed, e, r, n):
    """The client KG: Yago-sized, ``n`` uniform triples as its training
    split (the handshake reads only its aligned rows and their neighbours)."""
    from repro_torch.kge.data import KG

    tri = draw_known(np, seed + 21, e, r, n)
    kg = KG("yago-uniform", e, r, tri, np.arange(e))
    kg.train, kg.valid, kg.test = tri, tri[:0], tri[:0]
    return kg


def backtrack_scores(torch, np, models, keval, trainer, pre):
    """(accuracy, filtered Hit@10) of the host: the scheduler's default
    backtrack score — best-threshold accuracy on the valid split against
    fixed 1:1 negatives (``default_rng(0)``, 256 candidate thresholds) —
    and filtered Hit@10 over ``pre`` through ``fused_ranks``."""
    from repro_torch.kge.data import corrupt_triples

    dev = trainer.params["ent"].device
    va = trainer.kg.valid
    neg = corrupt_triples(np.random.default_rng(0), va, trainer.model.num_entities)

    def s(t):
        t = torch.as_tensor(t.astype(np.int64), device=dev)
        return models.score_triples(trainer.params, trainer.model, t[:, 0], t[:, 1],
                                    t[:, 2]).cpu().numpy()

    acc = keval.best_threshold_accuracy(s(va), s(neg), max_candidates=256)[1]
    lp = keval.link_prediction(trainer.params, trainer.model, trainer.kg, precomputed=pre)
    return acc, lp["hit@10"]


def federate(torch, np, host, client, client_kg, idx_c, idx_h, cfg, gen, scores):
    """One handshake in the order of the JAX package's ``federate_once``,
    through the port's public functions: PPAT, generate and procrustes on
    the padded aligned set, KGEmb update (average), virtual extension,
    one retrain epoch, strip, backtrack score, accept or restore. Host-clock
    seconds per stage, each ended by a synchronise."""
    from repro_torch.core.aggregation import kgemb_update, virtual_extension
    from repro_torch.core.alignment import csls_retrieval_acc, procrustes
    from repro_torch.core.ppat import PPAT_BUCKET, _pad_rows, train_ppat

    dev = host.params["ent"].device
    secs = {}
    t0 = [time.perf_counter()]

    def lap(name):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        now = time.perf_counter()
        secs[name] = now - t0[0]
        t0[0] = now

    before = scores(host)
    snap = host.snapshot()
    x = client.get_entity_embeddings(idx_c)
    y = host.get_entity_embeddings(idx_h)
    n = x.shape[0]
    lap("score_before")
    acc_identity = csls_retrieval_acc(x, y)
    lap("csls_identity")
    ppat_client, ppat_host, hist = train_ppat(x, y, cfg, generator=gen)
    lap("ppat")
    synth = ppat_client.generate(_pad_rows(x, PPAT_BUCKET))
    refine = procrustes(synth, _pad_rows(y, PPAT_BUCKET))
    synth = synth @ refine
    pad_zero = not bool(synth[n:].any())
    lap("generate_procrustes")
    acc_refined = csls_retrieval_acc(synth[:n], y)
    lap("csls_refined")
    kgemb_update(host, idx_h, synth[:n], mode="average")
    lap("kgemb_update")
    ve = virtual_extension(host, client, client_kg, idx_c, idx_h,
                           lambda e: ppat_client.generate(e) @ refine)
    extended = (host.params["ent"].shape[0], host.params["rel"].shape[0])
    lap("virtual_extension")
    loss = host.train_epochs(1)
    lap("retrain")
    host.strip_virtual()
    after = scores(host)
    lap("score_after")
    accepted = after[0] > before[0]
    retrained = host.snapshot()
    if not accepted:
        host.restore(snap)
    lap("backtrack")
    return dict(before=before, after=after, accepted=accepted, acc_identity=acc_identity,
                acc_refined=acc_refined, hist=hist, ppat_host=ppat_host, pad_zero=pad_zero,
                extended=extended, virtual=(ve.n_virtual_ent, ve.n_virtual_rel) if ve else None,
                loss=loss, secs=secs, snapshot=snap, retrained=retrained, x=x, y=y,
                synth=synth[:n])


def handshake_path(torch, np, models, ops, sops, ck, tier, host, dev, args, sizes):
    """The handshake at full width: a Yago-sized client against the trained
    Dbpedia-sized host of phase 6 over 123,853 aligned entities."""
    from repro_torch.core.alignment import AlignmentRegistry
    from repro_torch.core.ppat import PPATConfig
    from repro_torch.core.privacy import MomentsAccountant
    from repro_torch.kge import eval as keval
    from repro_torch.kge.trainer import KGETrainer

    e_c, r_c, n_c, n_al = sizes
    t0 = time.perf_counter()
    client_kg = make_client_kg(np, args.seed, e_c, r_c, n_c)
    client = KGETrainer(client_kg, "transe", dim=DIM, seed=args.seed + 1, device=dev)
    rng = np.random.default_rng(args.seed + 23)
    reg = AlignmentRegistry()
    reg.add_entities("yago", "dbpedia",
                     np.sort(rng.choice(e_c, n_al, replace=False)),
                     rng.choice(host.model.num_entities, n_al, replace=False))
    idx_c, idx_h = reg.entities("yago", "dbpedia")
    # plant the translation: the host's aligned rows are the client's rows
    # turned by a seeded random orthogonal Q, plus 0.01·N(0, 1)
    g = torch.Generator(device=dev).manual_seed(args.seed + 29)
    q, _ = torch.linalg.qr(torch.randn(DIM, DIM, device=dev, generator=g))
    xs = client.get_entity_embeddings(idx_c)
    host.set_entity_embeddings(idx_h, xs @ q + 0.01 * torch.randn(xs.shape, device=dev,
                                                                   generator=g))
    pre = keval.build_score_inputs(host.kg, max_test=MAX_TEST)
    shapes = {k: tuple(v.shape) for k, v in host.params.items()}
    setup_s = time.perf_counter() - t0

    # a version published before the handshake must answer as before after it
    tv = tier.publish(host.params)
    qt = host.kg.test[:16]
    first = tier.submit_rank(qt[:, 0], qt[:, 1], qt[:, 2])
    tier.run_until_drained()

    cfg = PPATConfig()
    gen = torch.Generator(device=dev).manual_seed(args.seed + 31)

    def scores(tr):
        return backtrack_scores(torch, np, models, keval, tr, pre)

    for reset in (ops.reset_launches, sops.reset_launches, ck.reset_launches):
        reset()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    res = federate(torch, np, host, client, client_kg, idx_c, idx_h, cfg, gen, scores)
    wall_s = time.perf_counter() - t0
    launches = {**ops.LAUNCHES, **sops.LAUNCHES, **ck.LAUNCHES}

    hist = res["hist"]
    eps = hist["epsilon"]
    acct = MomentsAccountant(cfg.lam, cfg.delta)
    acct.update(hist["n0"].ravel(), hist["n1"].ravel())
    check(np.isfinite(eps) and eps > 0, f"epsilon {eps} is not finite and positive")
    check(acct.epsilon() == eps and hist["n0"].shape == (cfg.steps, cfg.batch),
          f"epsilon {eps} != the accountant recomputed from n0/n1 ({acct.epsilon()})")
    if dev.type == "cuda":
        for name in ("cosine_matrix", "sparse_sgd_step", "fused_ranks"):
            check(launches[name] > 0, f"the handshake never launched {name}")
        # two CSLS retrievals (W = I, then refined), two passes of blocks each
        want = 4 * -(-n_al // RETRIEVAL_BLOCK)
        check(launches["cosine_matrix"] == want, f"the handshake launched the cosine kernel "
              f"{launches['cosine_matrix']} times, not {want}")
    check(res["acc_identity"] < 0.01, f"CSLS retrieval with W = I reads {res['acc_identity']}")
    check(res["acc_refined"] >= 0.9,
          f"CSLS retrieval after PPAT + procrustes reads {res['acc_refined']} < 0.9")
    check(res["pad_zero"], "the PPAT_BUCKET padding rows did not stay zero through generate")
    check({k: tuple(v.shape) for k, v in host.params.items()} == shapes,
          "the tables did not return to their pre-extension shapes")
    want = res["retrained"] if res["accepted"] else res["snapshot"]
    check(all(torch.equal(host.params[k], want[k]) for k in want),
          "after the backtrack the tables are not the " +
          ("retrained ones" if res["accepted"] else "snapshot, bit for bit"))
    again = tier.submit_rank(qt[:, 0], qt[:, 1], qt[:, 2])
    tier.run_until_drained()
    check(first.version == again.version == tv.version and again.state == "served"
          and np.array_equal(first.result, again.result),
          "the version published before the handshake answered differently after it")

    secs = res["secs"]
    out = {"setup_s": setup_s, "wall_s": wall_s, "launches": launches, "epsilon": eps,
           "max_alpha": hist["max_alpha"], "accepted": res["accepted"],
           "before": res["before"], "after": res["after"],
           "acc_identity": res["acc_identity"], "acc_refined": res["acc_refined"],
           "extended": res["extended"], "virtual": res["virtual"], "loss": res["loss"],
           "stage_s": secs, "gen_loss_last": hist["gen_loss"][-1],
           "vote_mean": float(hist["n1"].mean() / cfg.num_teachers)}
    log(f"handshake: client E={e_c} R={r_c} triples={n_c} (untrained), host E="
        f"{host.model.num_entities} R={host.model.num_relations} (phase 6), {n_al} aligned, "
        f"d={DIM}, PPAT {cfg.steps} rounds B={cfg.batch} T={cfg.num_teachers} "
        f"hidden={cfg.hidden} on {dev}; set-up {setup_s:.2f}s")
    log(f"handshake: epsilon {eps:.6f} (= the accountant over the returned n0/n1), CSLS "
        f"retrieval {res['acc_identity']:.6f} with W = I, {res['acc_refined']:.6f} after "
        f"PPAT + procrustes; virtual rows {res['virtual']} (tables {res['extended']}), "
        f"retrain loss {res['loss']:.6f}")
    log(f"handshake: backtrack accuracy {res['before'][0]:.6f} -> {res['after'][0]:.6f}, "
        f"Hit@10 {res['before'][1]:.6f} -> {res['after'][1]:.6f}: "
        f"{'accepted' if res['accepted'] else 'restored'}; tables bit-equal to the "
        f"{'retrained' if res['accepted'] else 'snapshot'} ones; published version "
        f"{tv.version} answered identically; launches {launches}")
    log("handshake stages (host clock, s): " + ", ".join(f"{k} {v:.4f}" for k, v in
                                                         secs.items()) + f"; total {wall_s:.3f}")
    return res, out, cfg, (client, client_kg, idx_c, idx_h, scores)


def ppat_card_vs_cpu(torch, tp, x, y, dev, seed):
    """``PPAT_CHECK_ROUNDS`` rounds of ``ppat_scan_graph`` on the card and on
    the CPU from the same init and the same injected draws."""
    cfg = tp.PPATConfig(steps=PPAT_CHECK_ROUNDS)
    g = torch.Generator().manual_seed(seed + 37)
    d, n = x.shape[1], x.shape[0]
    init = tp._init_host_params(g, d, cfg)
    draws = tp.draw_ppat(g, cfg, n, n)
    out = {}
    for where, xx, yy in (("cpu", x.cpu(), y.cpu()), ("cuda", x, y)):
        hp = {k: {name: v.to(xx.device) for name, v in p.items()} for k, p in init.items()}
        w = torch.eye(d, device=xx.device)
        _, w, _, _, n0, n1 = tp.ppat_scan_graph(hp, w, torch.zeros_like(w), xx, yy, n, n, cfg,
                                                draws=draws)
        out[where] = (w.cpu(), n0.cpu(), n1.cpu())
    votes_equal = torch.equal(out["cpu"][1], out["cuda"][1]) and \
        torch.equal(out["cpu"][2], out["cuda"][2])
    w_err = max_err(out["cuda"][0], out["cpu"][0])
    check(votes_equal, f"{PPAT_CHECK_ROUNDS} PPAT rounds: vote counts differ card vs CPU")
    check(w_err <= 1e-4, f"{PPAT_CHECK_ROUNDS} PPAT rounds: W differs by {w_err} > 1e-4")
    log(f"check PPAT {PPAT_CHECK_ROUNDS} rounds on {dev} vs the CPU, same draws (n={n}, "
        f"d={d}): n0/n1 equal, W max|err|={w_err:.3g} (atol 1e-4)")
    return w_err


# ------------------------------------------------------------ phase 10
def csls_timings(torch, ck, al, x, y, card):
    """The cosine kernel at one retrieval block: its output held against
    the plain version, then kernel, plain and library times with the bound;
    and the whole two-pass retrieval on the host clock."""
    import torch.nn.functional as F

    a, b = x[:RETRIEVAL_BLOCK].contiguous(), y.contiguous()
    n, d = a.shape
    m = b.shape[0]
    got, want = ck.cosine_matrix(a, b), ck.cosine_matrix_plain(a, b)
    torch.cuda.synchronize()
    err = max_err(got, want)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    del got, want
    log(f"check cosine at the timed shape ({n}, {m}, d={d}): max|err|={err:.3g} ok")
    flops = 2 * n * m * d
    nbytes = 4 * (n * d + m * d + n * m)
    out = dict(
        ms=time_ms(torch, lambda: ck.cosine_matrix(a, b), ITERS),
        device_ms=time_device_ms(torch, lambda: ck.cosine_matrix(a, b), DEVICE_CALLS,
                                 DEVICE_RUNS),
        plain_ms=time_ms(torch, lambda: ck.cosine_matrix_plain(a, b), max(3, ITERS // 4)),
        library_ms=time_ms(torch, lambda: F.normalize(a, dim=1) @ F.normalize(b, dim=1).T,
                           ITERS),
        **split_tf32_bounds(flops, nbytes, card),
        flops=flops, bytes=nbytes, max_abs_err=err,
        shape=f"n={n} m={m} d={d}",
    )
    out["tflops"] = flops / out["ms"] / 1e9
    log(f"time cosine_matrix [{out['shape']}]: kernel {out['ms']:.4f} ms "
        f"({out['tflops']:.2f} TFLOP/s; {out['device_ms']:.4f} ms device time), "
        f"plain {out['plain_ms']:.4f} ms, library "
        f"(F.normalize @ .T, TF32 off) {out['library_ms']:.4f} ms, bound "
        f"{out['bound_ms']:.4f} ms split TF32 ({out['bound_by']}: {flops:.3g} FLOP x 3, "
        f"{nbytes:.3g} B), {100 * out['bound_ms'] / out['ms']:.1f}% of it; fp32-pipe bound "
        f"{out['bound_fp32_ms']:.4f} ms; {card}")
    runs = []
    for _ in range(3):
        ck.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        acc = al.csls_retrieval_acc(x, y)
        runs.append(time.perf_counter() - t0)
    out["retrieval_s"] = statistics.median(runs)
    out["retrieval_launches"] = ck.LAUNCHES["cosine_matrix"]
    out["retrieval_acc"] = acc
    log(f"time CSLS retrieval over {x.shape[0]} x {y.shape[0]} (two passes, blocks of "
        f"{RETRIEVAL_BLOCK}): {out['retrieval_s']:.4f} s host clock (median of 3), "
        f"{out['retrieval_launches']} cosine launches, accuracy {acc:.6f}; {card}")
    return out


def profile_handshake(torch, np, host, ctx, cfg, seed, card):
    """Device time by kernel and the device's idle share over a second,
    whole handshake from the host's current tables (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    client, client_kg, idx_c, idx_h, scores = ctx
    gen = torch.Generator(device=host.params["ent"].device).manual_seed(seed + 41)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = federate(torch, np, host, client, client_kg, idx_c, idx_h, cfg, gen,
                       scores)
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    by_name = device_us_by_name(prof)
    busy = sum(by_name.values())
    out = {"wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
           "idle_share": None if busy == 0 else 1 - busy / wall_us,
           "stage_s": res["secs"],
           "top": [(k[:90], v / 1e3) for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])
                   [:12]]}
    if busy == 0:
        log("profile handshake: the profiler saw no device activity; idle share not measured")
    else:
        log(f"profile handshake: {out['wall_ms']:.1f} ms wall (profiled), device busy "
            f"{out['device_busy_ms']:.1f} ms, idle share {out['idle_share']:.3f}; {card}")
        log("profile handshake stages (host clock, s): " + ", ".join(
            f"{k} {v:.4f}" for k, v in res["secs"].items()))
        for name, ms in out["top"]:
            log(f"profile handshake:   {ms:10.3f} ms  {100 * ms * 1e3 / busy:5.1f}%  {name}")
    return out


# ------------------------------------------------------------ phases 11-14
@contextlib.contextmanager
def plain_kernels():
    """Route the LM's two kernel wrappers to their plain versions (for the
    checks that hold a kernel path against its plain path on the card)."""
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.ssd_scan import ops as sops_

    saved = fops.flash_attention, sops_.ssd_chunks
    before = dict(fops.LAUNCHES), dict(sops_.LAUNCHES)
    fops.flash_attention = fops.attention_ref
    sops_.ssd_chunks = sops_.ssd_chunks_plain
    try:
        yield
        check((dict(fops.LAUNCHES), dict(sops_.LAUNCHES)) == before,
              "a kernel launched inside plain_kernels(): the plain path did not run")
    finally:
        fops.flash_attention, sops_.ssd_chunks = saved


def rel_err(got, want):
    """max|got − want| over max|want|."""
    return float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30)


def ssd_inputs(torch, g, dev, b, s, h, p, n):
    """SSD inputs with ``Mamba2Mixer``'s laws: A = −(1..H); dt = softplus(
    N(0, 1) + softplus⁻¹(dt_init)), log dt_init uniform on [log 1e-3, log 0.1]."""
    import math

    x = torch.randn(b, s, h, p, device=dev, generator=g)
    u = torch.rand(h, device=dev, generator=g)
    dt_init = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
    dt = torch.nn.functional.softplus(torch.randn(b, s, h, device=dev, generator=g)
                                      + torch.log(torch.expm1(dt_init)))
    a = -torch.arange(1, h + 1, device=dev, dtype=torch.float32)
    bm = torch.randn(b, s, 1, n, device=dev, generator=g)
    cm = torch.randn(b, s, 1, n, device=dev, generator=g)
    s0 = torch.randn(b, h, p, n, device=dev, generator=g)
    return x, dt, a, bm, cm, s0


def chunk_views(x, dt, bm, cm, chunk):
    b, s, h, p = x.shape
    n = bm.shape[-1]
    nc = s // chunk
    return (x.reshape(b, nc, chunk, h, p).permute(0, 3, 1, 2, 4),
            dt.reshape(b, nc, chunk, h).permute(0, 3, 1, 2),
            bm.reshape(b, nc, chunk, n), cm.reshape(b, nc, chunk, n))


def lm_kernels_vs_plain(torch, fa, ks, dev, seed):
    """Phase 11: flash attention and the SSD chunk kernel against their plain
    versions on the card at the main path's shapes and at ragged ones."""
    worst = {"flash_attention": 0.0, "ssd_chunks": 0.0}
    g = torch.Generator(device=dev).manual_seed(seed + 51)
    cases = [c[:4] + (c[3],) + c[4:] for c in FLASH_CHECKS] + FLASH_LONG_CHECKS
    for b, h, kv, s, t, dh, causal, window, dname in cases:
        dtype = torch.float32 if dname == "fp32" else torch.bfloat16
        q = torch.randn(b, s, h, dh, device=dev, generator=g).to(dtype).transpose(1, 2)
        k = torch.randn(b, t, kv, dh, device=dev, generator=g).to(dtype).transpose(1, 2)
        v = torch.randn(b, t, kv, dh, device=dev, generator=g).to(dtype).transpose(1, 2)
        got = fa.flash_attention(q, k, v, causal=causal, window=window)
        want = fa.attention_ref(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        atol, rtol = (1e-5, 1e-5) if dtype == torch.float32 else (1e-5, BF16_ULP)
        err = max_err(got.float(), want.float())
        torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)
        if dtype == torch.float32:
            worst["flash_attention"] = max(worst["flash_attention"], err)
        del q, k, v, got, want
        log(f"check flash_attention B={b} H={h} KV={kv} S={s} T={t} Dh={dh} causal={causal} "
            f"window={window} {dname}: max|err|={err:.3g} (atol {atol}, rtol {rtol:.3g}) ok")
    b, s, h, p, n, q = SSD_SHAPE
    x, dt, a, bm, cm, s0 = ssd_inputs(torch, g, dev, b, s, h, p, n)
    views = chunk_views(x, dt, bm, cm, q)
    got = ks.ssd_chunks(views[0], views[1], a, views[2], views[3])
    want = ks.ssd_chunks_plain(views[0], views[1], a, views[2], views[3])
    torch.cuda.synchronize()
    for name, gt, wt in zip(("y_intra", "chunk_state", "decay"), got, want):
        rel = rel_err(gt, wt)
        check(rel <= 1e-5, f"ssd_chunks {name}: max|err| / max|plain| = {rel:.3g} > 1e-5")
        worst["ssd_chunks"] = max(worst["ssd_chunks"], max_err(gt, wt))
        log(f"check ssd_chunks {name} S={s} H={h} P={p} N={n} Q={q}: max|err|="
            f"{max_err(gt, wt):.3g}, {rel:.3g} of max|plain| {float(wt.abs().max()):.4g} "
            f"(tol 1e-5 of it) ok")
    cum = ks.ops.sequential_cumsum(views[1] * a.reshape(1, -1, 1, 1))
    log(f"ssd inputs: cum reaches {float(cum.min()):.1f} within a chunk (A = -1..-{h})")
    for state in (None, s0):
        y, fin = ks.ssd_chunk_kernel_apply(x, dt, a, bm, cm, chunk=q, state=state)
        with plain_kernels():
            yp, fp = ks.ssd_chunk_kernel_apply(x, dt, a, bm, cm, chunk=q, state=state)
        torch.cuda.synchronize()
        ry, rf = rel_err(y, yp), rel_err(fin, fp)
        check(ry <= 1e-5 and rf <= 1e-5, f"ssd apply (state {state is not None}): "
              f"y {ry:.3g}, final state {rf:.3g} of max|plain| > 1e-5")
        log(f"check ssd_chunk_kernel_apply {'with' if state is not None else 'without'} an "
            f"initial state: y {ry:.3g}, final state {rf:.3g} of max|plain| (tol 1e-5) ok")
    return worst


def lm_prompts(np, ds, rng, n, lo, hi, multiple):
    """``n`` prompts from ``ds`` with lengths drawn from [lo, hi]; the first
    is made no multiple of ``multiple``."""
    lens = rng.integers(lo, hi + 1, n)
    if lens[0] % multiple == 0:
        lens[0] -= 1
    return [ds.tokens(int(m), seed=1000 + i) for i, m in enumerate(lens)]


def batch1_greedy(torch, model, prompt, n, offset=0, **inputs):
    """Greedy tokens of one prompt alone through ``prefill`` (``inputs``:
    its frames or patches) + ``decode_step`` (positions ``offset`` past the
    prompt), with the logits each was picked from (on the host)."""
    dev = model.device
    cache = model.init_cache(1, offset + len(prompt) + n)
    logits = model.prefill(torch.as_tensor(prompt[None], device=dev).long(), cache, **inputs)
    toks, rows = [], []
    for i in range(n):
        row = logits[0, -1]
        toks.append(int(torch.argmax(row)))
        rows.append(row)
        if i + 1 < n:
            logits = model.decode_step(torch.tensor([[toks[-1]]], device=dev), cache,
                                       offset + len(prompt) + i)
    return toks, torch.stack(rows).cpu()


def near_tie_match(got, want, logits, tol):
    """Equal up to the first difference, where the reference logits of the
    two tokens lie within ``tol``; → 1 if they differ there, else 0."""
    for i, (a, b) in enumerate(zip(got, want)):
        if a != b:
            gap = abs(float(logits[i, a]) - float(logits[i, b]))
            check(gap <= tol, f"token {i}: {a} vs {b}, logit gap {gap:.3g} > {tol}")
            return 1
    check(len(got) == len(want), f"{len(got)} tokens, not {len(want)}")
    return 0


def profile_window(torch, fn, cpu=True):
    """(wall ms, device busy ms, idle share, top kernels) of ``fn`` under
    torch.profiler; ``cpu=False`` traces the device only, which keeps the
    profiler's own host cost off a window of many small operators."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA] if cpu else [ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    by_name = device_us_by_name(prof)
    busy = sum(by_name.values())
    return {"wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
            "idle_share": None if busy == 0 else 1 - busy / wall_us,
            "top": [(k[:90], v / 1e3) for k, v in sorted(by_name.items(),
                                                         key=lambda kv: -kv[1])[:8]]}


def lm_serve(torch, np, arch, dev, args, card, counter, plan):
    """Phases 12-13 for one card: ``ServingEngine`` at full width over ragged
    prompts, every request held against a batch-1 run and its first token
    against the plain-kernel prefill; a ``launch/serve.py``-style batched
    run; a profiled burst."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.data import SyntheticTextDataset
    from repro_torch.launch import serve as lserve
    from repro_torch.models import init_params
    from repro_torch.serving import ServingEngine

    cfg = get_config(arch)
    if args.rehearse:
        cfg = reduced(cfg)
    cfg = cfg.replace(dtype="float32")
    slots, n_req, lo, hi, max_len, new = plan
    kernel_lib, kernel = counter
    t0 = time.perf_counter()
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(args.seed), device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    ds = SyntheticTextDataset(vocab_size=cfg.vocab_size, seed=args.seed)
    rng = np.random.default_rng(args.seed + 61)
    multiple = cfg.ssm.chunk_size if cfg.ssm.enabled else 64
    prompts = lm_prompts(np, ds, rng, n_req, lo, hi, multiple)
    log(f"lm {arch}: {cfg.num_layers} layers, d={cfg.d_model}, {n_params / 1e9:.3f} B "
        f"parameters at fp32 on {dev} (drawn in {init_s:.2f}s); {n_req} requests, prompts "
        f"{sorted(len(p) for p in prompts)}, {new} new tokens each, {slots} slots, "
        f"max_len {max_len}")

    eng = ServingEngine(model, cfg, max_batch=slots, max_len=max_len, device=dev)
    kernel_lib.reset_launches()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for p in prompts:
        eng.submit(p, max_new_tokens=new)
    done = eng.run_until_drained()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = kernel_lib.LAUNCHES[kernel]
    check(len(done) == n_req and all(r.done and len(r.generated) == new for r in done),
          f"lm {arch}: served {len(done)} of {n_req} submitted")
    if dev.type == "cuda":
        check(launches == n_req * cfg.num_layers,
              f"lm {arch}: {kernel} launched {launches} times, not {n_req} x {cfg.num_layers}")
    lat = sorted(r.finished_at - r.submitted_at for r in done)
    res = {"arch": arch, "params": n_params, "requests": n_req, "served": len(done),
           "prompt_lens": [len(p) for p in prompts], "new_tokens": new, "slots": slots,
           "wall_s": wall_s, "launches": {kernel: launches},
           "generated_tokens_per_s": n_req * new / wall_s,
           "p50_ms": 1e3 * lat[len(lat) // 2],
           "p99_ms": 1e3 * lat[min(len(lat) - 1, int(0.99 * len(lat)))]}
    log(f"lm {arch}: served {len(done)}/{n_req} in {wall_s:.3f}s host clock, "
        f"{res['generated_tokens_per_s']:.1f} generated tokens/s, latency p50 "
        f"{res['p50_ms']:.1f} ms p99 {res['p99_ms']:.1f} ms; {kernel} launches {launches}; "
        f"{card}")

    diverged, first_err, prefill_s = 0, 0.0, []
    for r in sorted(done, key=lambda r: r.rid):
        prompt = prompts[r.rid]
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks, logits = batch1_greedy(torch, model, prompt, new)
        diverged += near_tie_match(r.generated, toks, logits, LM_TIE_TOL)
        with plain_kernels():
            plain = model.prefill(torch.as_tensor(prompt[None], device=dev).long(),
                                  model.init_cache(1, len(prompt) + 1))[0, -1].cpu()
        first_err = max(first_err, float((plain - logits[0]).abs().max()))
        near_tie_match([toks[0]], [int(torch.argmax(plain))], plain[None], LM_TIE_TOL)
    check(first_err <= LM_TIE_TOL, f"lm {arch}: kernel prefill logits differ from the "
          f"plain prefill's by {first_err:.3g} > {LM_TIE_TOL}")
    res.update(batch1_diverged_at_near_tie=diverged, first_token_max_dlogit=first_err)
    log(f"check lm {arch}: every request's {new} tokens equal its batch-1 prefill + "
        f"decode_step run ({diverged} differ only after a near-tie, tol {LM_TIE_TOL}); first "
        f"tokens equal the plain-kernel prefill's, max|dlogit| {first_err:.3g}")

    # a launch/serve.py-style batched run: batch 4, prompt 2048 (rehearsal: 64)
    plen = 2048 if not args.rehearse else 64
    batch = np.stack([ds.tokens(plen, seed=s) for s in range(SERVE_BATCH_LM)])
    lserve.generate(model, batch[:, :16], 2)  # warm-up: cuBLAS handles, allocator
    kernel_lib.reset_launches()
    gen_tokens, t = lserve.generate(model, batch, SERVE_GEN)
    res["serve_batch"] = {"batch": SERVE_BATCH_LM, "prompt": plen, "gen": SERVE_GEN,
                          "prefill_s": t["prefill_s"], "decode_s": t["decode_s"],
                          "prefill_tokens_per_s": SERVE_BATCH_LM * plen / t["prefill_s"],
                          "decode_ms_per_token": 1e3 * t["decode_s"] / (SERVE_GEN - 1),
                          "launches": {kernel: kernel_lib.LAUNCHES[kernel]}}
    check(gen_tokens.shape == (4, SERVE_GEN) and bool((gen_tokens >= 0).all()
                                                      and (gen_tokens < cfg.padded_vocab).all()),
          f"lm {arch}: launch.serve gave tokens of shape {gen_tokens.shape}")
    sb = res["serve_batch"]
    log(f"lm {arch} launch.serve: batch 4 x prompt {plen}: prefill {1e3 * sb['prefill_s']:.1f} "
        f"ms ({sb['prefill_tokens_per_s']:.0f} tokens/s), decode {sb['decode_ms_per_token']:.2f} "
        f"ms per token (batch 4, {SERVE_GEN} tokens); {kernel} launches {sb['launches'][kernel]}; "
        f"{card}")

    if dev.type == "cuda":  # a profiled burst: one request per slot
        def burst():
            e = ServingEngine(model, cfg, max_batch=slots, max_len=max_len, device=dev)
            for p in prompts[:slots]:
                e.submit(p, max_new_tokens=new)
            e.run_until_drained()

        prof = profile_window(torch, burst)
        res["profile"] = prof
        if prof["idle_share"] is None:
            log(f"profile lm {arch}: the profiler saw no device activity; idle share not "
                f"measured")
        else:
            log(f"profile lm {arch}: burst of {slots} requests x {new} tokens in "
                f"{prof['wall_ms']:.1f} ms, device busy {prof['device_busy_ms']:.1f} ms, idle "
                f"share {prof['idle_share']:.3f}; {card}")
            for name, ms in prof["top"]:
                log(f"profile lm {arch}:   {ms:9.3f} ms  "
                    f"{100 * ms / prof['device_busy_ms']:5.1f}%  {name}")
    del eng, model
    return res


def lm_timings(torch, fa, ks, dev, card):
    """Phase 14: kernel, plain and library times at the main path's shapes,
    with the bound."""
    import torch.nn.functional as F

    mem_rate, fp32_rate, _ = peak_rates(card)
    out = {}
    g = torch.Generator(device=dev).manual_seed(71)
    b, s, h, kv, dh = FLASH_SHAPE
    q = torch.randn(b, s, h, dh, device=dev, generator=g).transpose(1, 2)
    k = torch.randn(b, s, kv, dh, device=dev, generator=g).transpose(1, 2)
    v = torch.randn(b, s, kv, dh, device=dev, generator=g).transpose(1, 2)
    got, want = fa.flash_attention(q, k, v), fa.attention_ref(q, k, v)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    err = max_err(got, want)
    del got, want
    for name, batch in (("flash_attention", b), ("flash_attention_b4", SERVE_BATCH_LM)):
        if batch != b:  # the serve script's batch: its output held against the plain one first
            q, k, v = (torch.randn(batch, s, heads, dh, device=dev, generator=g).transpose(1, 2)
                       for heads in (h, kv, kv))
            got, want = fa.flash_attention(q, k, v), fa.attention_ref(q, k, v)
            torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
            err = max(err, max_err(got, want))
            del got, want
        pairs = h * s * (s + 1) // 2            # visible (query, key) pairs, causal
        flops = 4 * dh * pairs * batch          # q.k and p.v, two FLOP per multiply-add
        nbytes = 4 * (2 * batch * h * s * dh + 2 * batch * kv * s * dh)
        qc, kc, vc = (t.contiguous() for t in (q, k, v))

        def sdpa():
            return F.scaled_dot_product_attention(qc, kc, vc, is_causal=True, enable_gqa=True)

        out[name] = dict(
            ms=time_ms(torch, lambda: fa.flash_attention(q, k, v), ITERS),
            device_ms=time_device_ms(torch, lambda: fa.flash_attention(q, k, v), DEVICE_CALLS,
                                     DEVICE_RUNS),
            plain_ms=time_ms(torch, lambda: fa.attention_ref(q, k, v), ITERS),
            library_ms=time_ms(torch, sdpa, ITERS),
            **split_tf32_bounds(flops, nbytes, card),
            flops=flops, bytes=nbytes, max_abs_err=err,
            shape=f"B={batch} S={s} H={h} KV={kv} Dh={dh} causal fp32")
        del qc, kc, vc
    _, s, h, p, n, qn = SSD_SHAPE
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    err = 0.0
    for name, b in (("ssd_chunks", SSD_SHAPE[0]), ("ssd_chunks_b4", SERVE_BATCH_LM)):
        x, dt, a, bm, cm, _ = ssd_inputs(torch, g, dev, b, s, h, p, n)
        views = chunk_views(x, dt, bm, cm, qn)
        args_ = (views[0], views[1], a, views[2], views[3])
        for gt, wt in zip(ks.ssd_chunks(*args_), ks.ssd_chunks_plain(*args_)):
            check(rel_err(gt, wt) <= 1e-5, f"{name}: {rel_err(gt, wt):.3g} of max|plain|")
            err = max(err, max_err(gt, wt))
        nc = s // qn
        tri = qn * (qn + 1) // 2
        group = ks.ops.head_group(b, h, nc, qn, p, n, sms)
        # the least work: C.B^T once per chunk (one group), the triangle only
        flops = 2 * b * nc * (tri * n + h * (tri * p + qn * p * n))
        # this design: C.B^T once per head group
        design_flops = flops + 2 * b * nc * (-(-h // group) - 1) * tri * n
        nbytes = 4 * (b * s * h * p + b * s * h + h + 2 * b * s * n       # x, dt, a, B, C
                      + b * s * h * p + b * h * nc * p * n + b * s * h)    # y, states, decay
        out[name] = dict(
            ms=time_ms(torch, lambda: ks.ssd_chunks(*args_), ITERS),
            device_ms=time_device_ms(torch, lambda: ks.ssd_chunks(*args_), DEVICE_CALLS,
                                     DEVICE_RUNS),
            plain_ms=time_ms(torch, lambda: ks.ssd_chunks_plain(*args_), max(3, ITERS // 4)),
            library_ms=None, **split_tf32_bounds(flops, nbytes, card),
            flops=flops, design_flops=design_flops, heads_per_block=group, bytes=nbytes,
            max_abs_err=err, shape=f"B={b} S={s} H={h} P={p} N={n} Q={qn} fp32")
        del x, dt, a, bm, cm, views, args_
    for name in ("flash_attention", "flash_attention_b4", "ssd_chunks", "ssd_chunks_b4"):
        x_ = out[name]
        lib = "n/a" if x_["library_ms"] is None else f"{x_['library_ms']:.4f}"
        kind = "split TF32, FLOP x 3" if "bound_fp32_ms" in x_ else "fp32"
        fp32 = (f"; fp32-pipe bound {x_['bound_fp32_ms']:.4f} ms" if "bound_fp32_ms" in x_
                else "")
        log(f"time {name} [{x_['shape']}]: kernel {x_['ms']:.4f} ms "
            f"({x_['device_ms']:.4f} ms device time), plain "
            f"{x_['plain_ms']:.4f} ms, library {lib} ms, bound {x_['bound_ms']:.4f} ms "
            f"({kind}; {x_['bound_by']}: {x_['flops']:.3g} FLOP, {x_['bytes']:.3g} B), "
            f"{100 * x_['bound_ms'] / x_['ms']:.1f}% of bound{fp32}"
            + (f"; this design {x_['design_flops']:.3g} FLOP with {x_['heads_per_block']} "
               f"heads a block" if "design_flops" in x_ else "") + f"; {card}")
    return out


# ------------------------------------------------------------ phase 19
def lm_card(torch, arch, dev, args, layers=None):
    """(cfg, model, parameters) of ``arch`` at fp32 with random weights from
    ``--seed``: the published widths, cut to ``layers`` layers if given
    (reduced on a rehearsal)."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import init_params

    cfg = get_config(arch)
    if args.rehearse:
        cfg = reduced(cfg)
    elif layers:
        cfg = cfg.replace(num_layers=layers)
    cfg = cfg.replace(dtype="float32")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(args.seed), device=dev)
    sync(torch, dev)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"lm {arch}: {cfg.num_layers} layers"
        + (f" + {cfg.encoder_layers} encoder layers" if cfg.encoder_layers else "")
        + f", d={cfg.d_model}, {n_params / 1e9:.3f} B parameters at fp32 on {dev} (drawn in "
        f"{time.perf_counter() - t0:.2f}s)")
    return cfg, model, n_params


def layer_counts(cfg):
    """(attention layers, SSM layers) of a card's decoder."""
    from repro_torch.models.blocks import layer_kinds

    kinds = layer_kinds(cfg)
    return sum(k.mixer == "attn" for k in kinds), sum(k.mixer == "ssm" for k in kinds)


def moe_drops(torch, model, tokens):
    """Dropped assignments of each MoE layer in one prefill of ``tokens``:
    [(dropped, assignments, capacity)], read through ``details=True``."""
    drops, wrapped = [], []
    for layer in model.layers:
        if layer.moe is None:
            continue
        orig = layer.moe.forward

        def forward(x, *, groups="joint", details=False, orig=orig):
            y, aux, info = orig(x, groups=groups, details=True)
            drops.append((int((~info["keep"]).sum()), info["keep"].numel(), info["capacity"]))
            return (y, aux, info) if details else (y, aux)

        layer.moe.forward = forward
        wrapped.append(layer.moe)
    try:
        model.prefill(tokens, model.init_cache(tokens.shape[0], tokens.shape[1]))
    finally:
        for moe in wrapped:
            del moe.forward
    return drops


MOE_SECTIONS = ("_route", "_dispatch", "_experts", "_combine", "_shared")


def moe_section_ms(torch, model, fn):
    """Device ms of each MoE section (routing, dispatch, expert GEMMs,
    combine, shared experts) over all MoE layers in one call of ``fn``,
    between CUDA events around each section's call (no synchronisation
    inside the run), and the whole call's ms between events."""
    events, wrapped = {name: [] for name in MOE_SECTIONS}, []
    for layer in model.layers:
        if layer.moe is None:
            continue
        for name in MOE_SECTIONS:
            orig = getattr(layer.moe, name)

            def section(*a, orig=orig, name=name):
                e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                e0.record()
                out = orig(*a)
                e1.record()
                events[name].append((e0, e1))
                return out

            setattr(layer.moe, name, section)
        wrapped.append(layer.moe)
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    try:
        t0.record()
        fn()
        t1.record()
        torch.cuda.synchronize()
    finally:
        for moe in wrapped:
            for name in MOE_SECTIONS:
                delattr(moe, name)
    out = {name.strip("_"): sum(a.elapsed_time(b) for a, b in evs)
           for name, evs in events.items()}
    out["call"] = t0.elapsed_time(t1)
    return out


def card_engine(torch, np, fa, ks, cfg, model, dev, args, card, plan, name):
    """``ServingEngine`` over ragged prompts: every request answered, its
    tokens a batch-1 ``prefill`` + ``decode_step`` run's (a VLM's offset by
    its patches, as the engine decodes it) and its first token the
    plain-kernel prefill's, up to near-ties; the flash and SSD counters,
    zeroed just before, at one launch per request and attention (SSM)
    layer."""
    from repro_torch.data import SyntheticTextDataset
    from repro_torch.serving import ServingEngine

    slots, n_req, lo, hi, max_len, new = plan
    ds = SyntheticTextDataset(vocab_size=cfg.vocab_size, seed=args.seed)
    rng = np.random.default_rng(args.seed + 67)
    prompts = lm_prompts(np, ds, rng, n_req, lo, hi,
                         cfg.ssm.chunk_size if cfg.ssm.enabled else 64)
    if cfg.sliding_window and max(len(p) for p in prompts) <= cfg.sliding_window:
        prompts[-1] = ds.tokens(hi, seed=1000 + n_req - 1)   # one past the window
    n_attn, n_ssm = layer_counts(cfg)
    log(f"lm {name} engine: {n_req} requests, prompts {sorted(len(p) for p in prompts)}, "
        f"{new} new tokens each, {slots} slots, max_len {max_len}")
    eng = ServingEngine(model, cfg, max_batch=slots, max_len=max_len, device=dev)
    fa.reset_launches()
    ks.reset_launches()
    sync(torch, dev)
    t0 = time.perf_counter()
    for p in prompts:
        eng.submit(p, max_new_tokens=new)
    done = eng.run_until_drained()
    sync(torch, dev)
    wall_s = time.perf_counter() - t0
    launches = {"flash_attention": fa.LAUNCHES["flash_attention"],
                "ssd_chunks": ks.LAUNCHES["ssd_chunks"]}
    check(len(done) == n_req and all(r.done and len(r.generated) == new for r in done),
          f"lm {name}: served {len(done)} of {n_req} submitted")
    if dev.type == "cuda":
        want = {"flash_attention": n_req * n_attn, "ssd_chunks": n_req * n_ssm}
        check(launches == want, f"lm {name}: launches {launches}, planned {want}")
    diverged, first_err = 0, 0.0
    for r in sorted(done, key=lambda r: r.rid):
        prompt = prompts[r.rid]
        toks, logits = batch1_greedy(torch, model, prompt, new, offset=cfg.num_patches)
        diverged += near_tie_match(r.generated, toks, logits, LM_TIE_TOL)
        with plain_kernels():
            plain = model.prefill(torch.as_tensor(prompt[None], device=dev).long(),
                                  model.init_cache(1, len(prompt)))[0, -1].cpu()
        first_err = max(first_err, float((plain - logits[0]).abs().max()))
        near_tie_match([toks[0]], [int(torch.argmax(plain))], plain[None], LM_TIE_TOL)
    check(first_err <= LM_TIE_TOL, f"lm {name}: kernel prefill logits differ from the plain "
          f"prefill's by {first_err:.3g} > {LM_TIE_TOL}")
    lat = sorted(r.finished_at - r.submitted_at for r in done)
    res = {"requests": n_req, "served": len(done), "slots": slots, "new_tokens": new,
           "prompt_lens": [len(p) for p in prompts], "wall_s": wall_s, "launches": launches,
           "generated_tokens_per_s": n_req * new / wall_s, "p50_ms": 1e3 * lat[len(lat) // 2],
           "batch1_diverged_at_near_tie": diverged, "first_token_max_dlogit": first_err}
    log(f"check lm {name} engine: {len(done)}/{n_req} served in {wall_s:.3f}s host clock "
        f"({res['generated_tokens_per_s']:.1f} generated tokens/s, p50 {res['p50_ms']:.1f} ms); "
        f"launches {launches}; every request's tokens equal its batch-1 run ({diverged} differ "
        f"only after a near-tie, tol {LM_TIE_TOL}), first tokens the plain-kernel prefill's, "
        f"max|dlogit| {first_err:.3g}; {card}")
    del eng
    return res, prompts


def card_serve(torch, np, fa, cfg, model, dev, args, card, name, plen, inputs):
    """A ``launch/serve.py``-style batched run (batch 4, ``SERVE_GEN`` new
    tokens, ``inputs``: seeded frames or patches): prefill tokens/s, decode
    ms per token, the flash launches of the run (all in its prefill); its
    first tokens held against the plain-kernel prefill, up to near-ties."""
    from repro_torch.data import SyntheticTextDataset
    from repro_torch.launch import serve as lserve

    ds = SyntheticTextDataset(vocab_size=cfg.vocab_size, seed=args.seed)
    batch = np.stack([ds.tokens(plen, seed=s) for s in range(SERVE_BATCH_LM)])
    lserve.generate(model, batch[:, :16], 2, **inputs)   # warm-up: cuBLAS handles, allocator
    fa.reset_launches()
    gen_tokens, t = lserve.generate(model, batch, SERVE_GEN, **inputs)
    launches = fa.LAUNCHES["flash_attention"]
    check(gen_tokens.shape == (SERVE_BATCH_LM, SERVE_GEN)
          and bool((gen_tokens >= 0).all() and (gen_tokens < cfg.padded_vocab).all()),
          f"lm {name}: launch.serve gave tokens of shape {gen_tokens.shape}")
    tokens = torch.as_tensor(batch, device=dev).long()
    rows = plen + (inputs["patches"].shape[1] if "patches" in inputs else 0)
    kernel = model.prefill(tokens, model.init_cache(SERVE_BATCH_LM, rows), **inputs)[:, -1].cpu()
    with plain_kernels():
        plain = model.prefill(tokens, model.init_cache(SERVE_BATCH_LM, rows), **inputs)[:, -1]
    plain = plain.cpu()
    err = float((kernel - plain).abs().max())
    check(err <= LM_TIE_TOL, f"lm {name}: batched kernel prefill logits differ from the plain "
          f"prefill's by {err:.3g} > {LM_TIE_TOL}")
    for b in range(SERVE_BATCH_LM):
        near_tie_match([int(gen_tokens[b, 0])], [int(torch.argmax(plain[b]))], plain[b][None],
                       LM_TIE_TOL)
    res = {"batch": SERVE_BATCH_LM, "prompt": plen, "gen": SERVE_GEN,
           "prefill_s": t["prefill_s"], "decode_s": t["decode_s"],
           "prefill_tokens_per_s": SERVE_BATCH_LM * plen / t["prefill_s"],
           "decode_ms_per_token": 1e3 * t["decode_s"] / (SERVE_GEN - 1),
           "launches": {"flash_attention": launches}, "first_token_max_dlogit": err}
    log(f"lm {name} launch.serve: batch {SERVE_BATCH_LM} x prompt {plen}: prefill "
        f"{1e3 * t['prefill_s']:.1f} ms ({res['prefill_tokens_per_s']:.0f} tokens/s), decode "
        f"{res['decode_ms_per_token']:.2f} ms per token ({SERVE_GEN} tokens); flash launches "
        f"{launches}; first tokens the plain-kernel prefill's, max|dlogit| {err:.3g}; {card}")
    return res, tokens, gen_tokens


def check_flash(dev, serve_res, want, name):
    """On the card: the batched serve run's prefill launched flash ``want``
    times (its decode steps launch none)."""
    got = serve_res["launches"]["flash_attention"]
    if dev.type == "cuda":
        check(got == want, f"lm {name}: batched prefill launched flash {got} times, not {want}")


def log_profile(name, prof, card):
    if prof["idle_share"] is None:
        log(f"profile lm {name}: the profiler saw no device activity; idle share not measured")
        return
    log(f"profile lm {name}: {prof['wall_ms']:.1f} ms, device busy "
        f"{prof['device_busy_ms']:.1f} ms, idle share {prof['idle_share']:.3f}; {card}")
    for kname, ms in prof["top"]:
        log(f"profile lm {name}:   {ms:9.3f} ms  {100 * ms / prof['device_busy_ms']:5.1f}%  "
            f"{kname}")


def peak_gb(torch, dev):
    return torch.cuda.max_memory_allocated(dev) / 1e9 if dev.type == "cuda" else None


def lm_cards(torch, np, fa, ks, dev, args, card):
    """Phase 19: the LM cards of the MoE, encoder-decoder and patch-prefix
    slice. mixtral-8x22b and internvl2-26b at their published widths cut to
    ``LM_CARD_LAYERS`` layers, whisper-medium whole, jamba and kimi reduced;
    each model freed before the next."""
    from repro_torch.launch import serve as lserve
    from repro_torch.serving import ServingEngine

    out, launches = {}, {"flash_attention": 0, "ssd_chunks": 0}

    def add(counts):
        for k, v in counts.items():
            launches[k] += v

    # 19a. mixtral-8x22b: the engine, drops of the longest prefill, the serve
    # script, a profiled prefill with the MoE's sections
    cfg, model, n_params = lm_card(torch, "mixtral-8x22b", dev, args, LM_CARD_LAYERS)
    plan = LM_CARD_REHEARSE_PLAN if args.rehearse else MIXTRAL_PLAN
    res, prompts = card_engine(torch, np, fa, ks, cfg, model, dev, args, card, plan, "mixtral")
    add(res["launches"])
    longest = max(prompts, key=len)
    drops = moe_drops(torch, model, torch.as_tensor(longest[None], device=dev).long())
    res["longest_prefill_drops"] = drops
    log(f"lm mixtral: prefill of the longest prompt ({len(longest)} tokens): dropped "
        "assignments per MoE layer " + ", ".join(f"{d} of {n} (capacity {c})"
                                                 for d, n, c in drops))
    res["serve_batch"], tokens, _ = card_serve(torch, np, fa, cfg, model, dev, args, card,
                                               "mixtral", 64 if args.rehearse else 2048, {})
    check_flash(dev, res["serve_batch"], cfg.num_layers, "mixtral")
    add(res["serve_batch"]["launches"])
    if dev.type == "cuda":
        cache = model.init_cache(tokens.shape[0], tokens.shape[1])
        prof = profile_window(torch, lambda: model.prefill(tokens, cache))
        sections = moe_section_ms(
            torch, model, lambda: model.prefill(tokens, model.init_cache(*tokens.shape)))
        moe_ms = sum(v for k, v in sections.items() if k != "call")
        res.update(profile_prefill=prof, moe_sections_ms=sections,
                   moe_share=moe_ms / sections["call"],
                   moe_gemm_share=sections["experts"] / max(moe_ms, 1e-9))
        log_profile("mixtral prefill (batch 4 x 2048)", prof, card)
        log(f"lm mixtral prefill MoE sections (CUDA events, ms over {cfg.num_layers} layers): "
            + ", ".join(f"{k} {v:.3f}" for k, v in sections.items())
            + f"; the MoE {100 * res['moe_share']:.1f}% of the prefill, of it expert GEMMs "
            f"{100 * res['moe_gemm_share']:.1f}%, routing + dispatch + combine "
            f"{100 * (sections['route'] + sections['dispatch'] + sections['combine']) / moe_ms:.1f}%"
            f"; {card}")
    res.update(params=n_params, layers=cfg.num_layers, peak_gb=peak_gb(torch, dev))
    log(f"lm mixtral: peak device memory {res['peak_gb']} GB")
    out["mixtral-8x22b"] = res
    del model, tokens
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # 19b. whisper-medium whole: the serve script over seeded frames
    cfg, model, n_params = lm_card(torch, "whisper-medium", dev, args)
    try:
        ServingEngine(model, cfg, max_batch=1, max_len=16, device=dev)
        raise SmokeFailure("lm whisper: ServingEngine took the encoder-decoder card")
    except NotImplementedError:
        log("check lm whisper: ServingEngine refuses the encoder-decoder card, as the "
            "reference's does")
    g = torch.Generator(device=dev).manual_seed(args.seed + 73)
    frames = torch.randn(SERVE_BATCH_LM, cfg.encoder_seq, cfg.d_model, device=dev, generator=g)
    plen = 64 if args.rehearse else WHISPER_PROMPT
    res = {}
    res["serve_batch"], tokens, gen_tokens = card_serve(torch, np, fa, cfg, model, dev, args,
                                                        card, "whisper", plen, {"frames": frames})
    # one launch per encoder layer, per self-attention and per cross-attention
    check_flash(dev, res["serve_batch"], cfg.encoder_layers + 2 * cfg.num_layers, "whisper")
    add(res["serve_batch"]["launches"])
    diverged = 0
    for b in (0, SERVE_BATCH_LM - 1):
        toks, logits = batch1_greedy(torch, model, tokens[b].cpu().numpy(), SERVE_GEN,
                                     frames=frames[b:b + 1])
        diverged += near_tie_match(list(gen_tokens[b]), toks, logits, LM_TIE_TOL)
    res["batch1_diverged_at_near_tie"] = diverged
    log(f"check lm whisper: sequences 0 and {SERVE_BATCH_LM - 1} of the batched run equal their "
        f"batch-1 runs over their own frames ({diverged} differ only after a near-tie)")
    if dev.type == "cuda":
        res["profile_serve"] = profile_window(
            torch, lambda: lserve.generate(model, tokens.cpu().numpy(), 8, frames=frames),
            cpu=False)
        log_profile("whisper serve (batch 4, 8 tokens)", res["profile_serve"], card)
    res.update(params=n_params, peak_gb=peak_gb(torch, dev))
    log(f"lm whisper: peak device memory {res['peak_gb']} GB")
    out["whisper-medium"] = res
    del model, frames, tokens
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # 19c. internvl2-26b: the engine (the reference's patch-less prefill), the
    # serve script over seeded patches
    cfg, model, n_params = lm_card(torch, "internvl2-26b", dev, args, LM_CARD_LAYERS)
    plan = LM_CARD_REHEARSE_PLAN if args.rehearse else INTERNVL_PLAN
    plan = (plan[1],) + plan[1:]   # a fresh slot per request (ROADMAP, reference caveats)
    res, _ = card_engine(torch, np, fa, ks, cfg, model, dev, args, card, plan, "internvl")
    add(res["launches"])
    patches = torch.randn(SERVE_BATCH_LM, cfg.num_patches, cfg.d_model, device=dev,
                          generator=torch.Generator(device=dev).manual_seed(args.seed + 79))
    res["serve_batch"], _, _ = card_serve(torch, np, fa, cfg, model, dev, args, card,
                                          "internvl", 64 if args.rehearse else 2048,
                                          {"patches": patches})
    check_flash(dev, res["serve_batch"], cfg.num_layers, "internvl")
    add(res["serve_batch"]["launches"])
    res.update(params=n_params, layers=cfg.num_layers, peak_gb=peak_gb(torch, dev))
    log(f"lm internvl: peak device memory {res['peak_gb']} GB")
    out["internvl2-26b"] = res
    del model, patches
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # 19d. jamba (Mamba2 + attention + MoE) and kimi (shared expert), reduced
    for arch in ("jamba-1.5-large-398b", "kimi-k2-1t-a32b"):
        args_r = argparse.Namespace(**{**vars(args), "rehearse": True})
        cfg, model, _ = lm_card(torch, arch, dev, args_r)
        res, _ = card_engine(torch, np, fa, ks, cfg, model, dev, args, card,
                             LM_CARD_REHEARSE_PLAN, arch.split("-")[0])
        add(res["launches"])
        out[arch] = res
        del model
    out["launches"] = launches
    return out


# ------------------------------------------------------------ phase 15
class StageClock:
    """Host-clock seconds of each stage of a federation round, each call
    ended (and begun) by a synchronise: wraps the functions that
    ``core/federation.py`` calls for each stage, and restores them on exit."""

    def __init__(self, torch, fed_mod, sched, dev):
        self.torch, self.fed_mod, self.sched, self.dev = torch, fed_mod, sched, dev
        self.secs, self.calls, self.ppat = {}, {}, []
        self._in_plan = False
        self._saved = []

    def _sync(self):
        if self.dev.type == "cuda":
            self.torch.cuda.synchronize(self.dev)

    def _timed(self, stage, fn, keep=None):
        def wrapper(*a, **kw):
            self._sync()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            self._sync()
            name = stage() if callable(stage) else stage
            self.secs[name] = self.secs.get(name, 0.0) + time.perf_counter() - t0
            self.calls[name] = self.calls.get(name, 0) + 1
            if keep is not None:
                keep.append(out)
            return out
        return wrapper

    def _patch(self, owner, attr, wrapper):
        self._saved.append((owner, attr, owner.__dict__.get(attr, None), attr in owner.__dict__))
        setattr(owner, attr, wrapper)

    def __enter__(self):
        m, tr = self.fed_mod, self.fed_mod.KGETrainer
        self._patch(m, "train_ppat", self._timed("ppat", m.train_ppat, keep=self.ppat))
        self._patch(m, "procrustes", self._timed("procrustes_update", m.procrustes))
        self._patch(m, "kgemb_update", self._timed("procrustes_update", m.kgemb_update))
        self._patch(m, "virtual_extension", self._timed("virtual_extension",
                                                        m.virtual_extension))
        self._patch(tr, "train_epochs", self._timed("retrain", tr.train_epochs))
        self._patch(tr, "snapshot", self._timed(
            lambda: "plan_view_copies" if self._in_plan else "accept_or_restore", tr.snapshot))
        self._patch(tr, "restore", self._timed("accept_or_restore", tr.restore))
        self._patch(self.sched, "score_fn", self._timed("backtrack_score", self.sched.score_fn))
        plan = self.sched.plan_tick

        def plan_tick(**kw):
            self._in_plan = True
            try:
                return plan(**kw)
            finally:
                self._in_plan = False
        self._patch(self.sched, "plan_tick", plan_tick)
        return self

    def __exit__(self, *exc):
        for owner, attr, old, had in reversed(self._saved):
            if had:
                setattr(owner, attr, old)
            else:
                delattr(owner, attr)
        return False


def fed_wave(tier, kg, rng, n_rank, n_topk):
    """One wave of rank and top-k requests of 1-16 rows, drained."""
    reqs = []
    for kind in ["rank"] * n_rank + ["topk"] * n_topk:
        q = kg.train[rng.integers(0, len(kg.train), int(rng.integers(1, 17)))]
        if kind == "rank":
            reqs.append(tier.submit_rank(q[:, 0], q[:, 1], q[:, 2]))
        else:
            reqs.append(tier.submit_topk(q[:, 0], q[:, 1], k=10))
    tier.run_until_drained()
    return reqs


def fed_universe(np, registry_cls, args, sizes):
    """Phase 15's owners: Dbpedia (phase 6's store), Yago (phase 9's), and
    phase 9's alignment as an explicit registry."""
    (e_d, r_d, n_d), (e_y, r_y, n_y), n_al = sizes
    kgs = {"Dbpedia": make_kg(np, args.seed, e_d, r_d, draw_known(np, args.seed, e_d, r_d, n_d)),
           "Yago": make_kg(np, args.seed + 21, e_y, r_y,
                           draw_known(np, args.seed + 21, e_y, r_y, n_y), "yago-uniform")}
    rng = np.random.default_rng(args.seed + 23)  # phase 9's alignment
    reg = registry_cls()
    reg.add_entities("Yago", "Dbpedia", np.sort(rng.choice(e_y, n_al, replace=False)),
                     rng.choice(e_d, n_al, replace=False))
    return kgs, reg


def federation_path(torch, np, ops, sops, serving, dev, args, card, sizes):
    """Phase 15: Alg. 1 through ``FederationScheduler`` over Yago and
    Dbpedia at full width, with a serving tier attached to Dbpedia. Returns
    the results and the universe ``(kgs, registry)``."""
    from repro_torch.core import federation as fed_mod
    from repro_torch.core.alignment import AlignmentRegistry
    from repro_torch.core.privacy import MomentsAccountant

    (e_d, r_d, n_d), (e_y, r_y, n_y), n_al = sizes
    t0 = time.perf_counter()
    kgs, reg = fed_universe(np, AlignmentRegistry, args, sizes)
    sched = fed_mod.FederationScheduler(
        kgs, dim=DIM, registry=reg, score_metric="hit10", score_max_test=FED_MAX_TEST,
        update_epochs=1, seed=args.seed, device=dev, tick_impl="reference")
    setup_s = time.perf_counter() - t0
    counters = (ops.LAUNCHES, sops.LAUNCHES)
    fed_launches = {}

    def federate(fn):
        """``fn()`` with the kernels it launches added to ``fed_launches``."""
        before = {k: v for c in counters for k, v in c.items()}
        out = fn()
        for c in counters:
            for k, v in c.items():
                fed_launches[k] = fed_launches.get(k, 0) + v - before[k]
        return out

    ops.reset_launches()
    sops.reset_launches()
    t0 = time.perf_counter()
    init = federate(lambda: sched.initial_training(1))
    init_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    tier = serving.KGEServingTier.for_owner(sched, "Dbpedia", device=dev,
                                            max_batch=SERVE_BATCH)
    tier_s = time.perf_counter() - t0
    check(tier.version == 1, f"the attached tier starts at version {tier.version}, not 1")

    plans, reqs, ticks, prof = [], [], [], None
    plan_tick = sched.plan_tick

    def recorded_plan(**kw):
        plan = plan_tick(**kw)
        plans.append([(e.host, e.kind, e.client) for e in plan])
        return plan

    sched.plan_tick = recorded_plan
    wave_rng = np.random.default_rng(args.seed + 43)
    def one_tick():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        federate(lambda: sched.run(max_ticks=1))
        ticks.append(time.perf_counter() - t0)

    with StageClock(torch, fed_mod, sched, dev) as clock:
        for tick in range(FED_TICKS):
            if tick:
                reqs += fed_wave(tier, kgs["Dbpedia"], wave_rng, *FED_WAVE)
            if tick == 0 and dev.type == "cuda":  # the first tick: its plan is handshakes
                prof = profile_window(torch, one_tick, cpu=False)
            else:
                one_tick()
            for n, tr in sched.trainers.items():
                snap = sched.best_snapshot[n]
                check(all(torch.equal(tr.params[k], snap[k]) for k in snap),
                      f"tick {sched._tick}: {n}'s tables are not its best snapshot, bit for bit")
        reqs += fed_wave(tier, kgs["Dbpedia"], wave_rng, *FED_WAVE)
    sched.plan_tick = plan_tick

    events = [ev for ev in sched.events if ev.kind != "init"]
    by_tick = [[(ev.host, ev.kind, ev.client) for ev in events if ev.tick == t]
               for t in range(1, sched._tick + 1)]
    check(by_tick == plans, f"events {by_tick} are not in plan order {plans}")
    check(all(ev.fault is None and ev.accepted == (ev.score_after > ev.score_before)
              for ev in events), "a decision is not after > before")
    handshakes = [ev for ev in events if ev.kind == "ppat"]
    check(len(clock.ppat) == len(handshakes), "a handshake without its PPAT run")
    for ev, (_, ppat_host, hist) in zip(handshakes, clock.ppat):
        acct = MomentsAccountant(sched.ppat_cfg.lam, sched.ppat_cfg.delta)
        acct.update(hist["n0"].ravel(), hist["n1"].ravel())
        check(np.isfinite(ev.epsilon) and ev.epsilon == ppat_host.accountant.epsilon()
              == acct.epsilon(), f"handshake {ev.client}->{ev.host}: epsilon {ev.epsilon} is "
              f"not finite and equal to its accountant ({acct.epsilon()})")
    life = sched.accountant.epsilon()
    check(all(life >= ev.epsilon for ev in handshakes),
          f"lifetime epsilon {life} below a handshake's")
    accepts = sum(ev.accepted for ev in events if ev.host == "Dbpedia")
    check(tier.version == 1 + accepts and tier.stats["publish_errors"] == 0,
          f"tier version {tier.version} != 1 + Dbpedia's {accepts} accepts")
    s = tier.stats
    check(s["served"] == s["submitted"] == len(reqs) and all(r.state == "served" for r in reqs),
          f"requests not all served: {s}")
    # the plan's launches: one epoch-kernel launch per train_epochs epoch and
    # two rank launches (tail, head) per 128-triple chunk of each Hit@10 score
    n_train = len(sched.trainers) + len(events)
    per_score = 2 * -(-FED_MAX_TEST // 128)
    want = {"sparse_sgd_step": n_train, "fused_ranks": per_score * n_train, "pairwise_scores": 0}
    if dev.type == "cuda":
        check({k: fed_launches.get(k, 0) for k in want} == want,
              f"the federation launched {fed_launches}, the plan implies {want}")
    tier_launches = {k: v for c in counters for k, v in c.items()}
    tier_launches = {k: v - fed_launches.get(k, 0) for k, v in tier_launches.items()}
    if dev.type == "cuda":
        check(tier_launches["fused_ranks"] > 0 and tier_launches["pairwise_topk"] > 0,
              f"the tier's requests launched {tier_launches}")
    round_s = sum(ticks)
    stages = dict(clock.secs)
    stages["other"] = round_s - sum(v for k, v in stages.items())
    out = {"setup_s": setup_s, "init_s": init_s, "tier_build_s": tier_s, "tick_s": ticks,
           "round_s": round_s, "stage_s": stages, "stage_calls": clock.calls,
           "events": [(ev.tick, ev.host, ev.client, ev.kind, ev.accepted, ev.score_before,
                       ev.score_after, ev.epsilon, ev.seconds) for ev in events],
           "init_scores": init, "lifetime_epsilon": life, "tier_versions": tier.version,
           "requests": len(reqs), "launches": {k: fed_launches.get(k, 0) + tier_launches[k]
                                               for k in tier_launches},
           "federation_launches": fed_launches, "tier_launches": tier_launches,
           "profile": prof}
    log(f"federation: Dbpedia E={e_d} R={r_d} triples={n_d}, Yago E={e_y} R={r_y} "
        f"triples={n_y}, {n_al} aligned, d={DIM}, transe, PPAT {sched.ppat_cfg.steps} rounds, "
        f"Hit@10 backtrack over {FED_MAX_TEST} valid triples, on {dev}; set-up {setup_s:.2f}s, "
        f"initial training (1 epoch each) {init_s:.2f}s {init}, tier built {tier_s:.2f}s")
    for ev in events:
        log(f"federation: tick {ev.tick} {ev.kind} {ev.client}->{ev.host}: Hit@10 "
            f"{ev.score_before:.4f} -> {ev.score_after:.4f} "
            f"{'accepted' if ev.accepted else 'restored'}, epsilon {ev.epsilon:.6f}, "
            f"{ev.seconds:.3f}s")
    log(f"federation: {len(events)} entries in {FED_TICKS} ticks, {round_s:.3f}s host clock "
        f"(ticks {', '.join(f'{t:.3f}' for t in ticks)}); lifetime epsilon {life:.6f}; tier "
        f"version {tier.version}, {len(reqs)} requests served; launches: federation "
        f"{fed_launches} (= the plan's {want}), tier {tier_launches}")
    log("federation stages (host clock, s): " + ", ".join(
        f"{k} {v:.4f}" for k, v in stages.items()) + f"; {card}")
    if prof is not None:
        log(f"profile federation tick 1: {prof['wall_ms']:.1f} ms wall (profiled), device busy "
            f"{prof['device_busy_ms']:.1f} ms, idle share "
            + ("not measured" if prof["idle_share"] is None else f"{prof['idle_share']:.3f}")
            + f"; {card}")
        for name, ms in prof["top"]:
            log(f"profile federation tick 1:   {ms:10.3f} ms  {name}")
    return out, (kgs, reg)


def fed_card_vs_cpu(torch, np, dev, seed):
    """The scheduler at a small universe on the card and on the CPU, both
    under ``REPRO_TRAIN_IMPL=fused``, each from its own ``GeneratorDraws``
    with the same seed (the same CPU draws in the same order): equal
    events, bit-equal epsilon, tables within ``FED_TABLE_ATOL``."""
    import os

    from repro_torch.core.federation import FederationScheduler, GeneratorDraws
    from repro_torch.core.ppat import PPATConfig
    from repro_torch.kge.data import synthesize_universe
    from repro_torch.serving import KGEServingTier

    uni = synthesize_universe(seed=1, scale=1 / 500)
    kgs = {n: uni[n] for n in FED_SMALL_OWNERS}
    cfg = PPATConfig(steps=FED_SMALL_ROUNDS, seed=seed)
    runs = []
    old = os.environ.get("REPRO_TRAIN_IMPL")
    os.environ["REPRO_TRAIN_IMPL"] = "fused"
    try:
        for where in (dev, torch.device("cpu")):
            s = FederationScheduler(kgs, dim=FED_SMALL_DIM, ppat_cfg=cfg, local_epochs=2,
                                    update_epochs=1, seed=seed, device=where,
                                    draws=GeneratorDraws(seed + 47, cfg, FED_SMALL_DIM),
                                    tick_impl="reference")
            start = torch.Generator().manual_seed(seed + 53)
            for tr in s.trainers.values():  # the same start tables on both
                tr.params = {k: (torch.rand(v.shape, generator=start) - 0.5).to(where)
                             for k, v in tr.params.items()}
            s.initial_training()
            tier = KGEServingTier.for_owner(s, FED_SMALL_OWNERS[0], device=where)
            s.run(max_ticks=2)
            runs.append((s, tier.version))
    finally:
        if old is None:
            del os.environ["REPRO_TRAIN_IMPL"]
        else:
            os.environ["REPRO_TRAIN_IMPL"] = old
    (a, version), (b, _) = runs
    accepts = sum(e.accepted for e in a.events if e.host == FED_SMALL_OWNERS[0]
                  and e.kind != "init")
    check(accepts > 0 and version == 1 + accepts,
          f"small federation: tier version {version} for {accepts} accepts (want some)")
    keys = ("tick", "host", "client", "kind", "accepted", "fault", "owner_clock", "view_version")
    ev_a = [tuple(getattr(e, k) for k in keys) for e in a.events]
    ev_b = [tuple(getattr(e, k) for k in keys) for e in b.events]
    check(ev_a == ev_b, f"card and CPU schedulers differ: {ev_a} vs {ev_b}")
    check([repr(e.epsilon) for e in a.events] == [repr(e.epsilon) for e in b.events]
          and a.accountant.epsilon() == b.accountant.epsilon(),
          "epsilon differs card vs CPU")
    err = max(max_err(a.trainers[n].params[k].cpu(), b.trainers[n].params[k])
              for n in kgs for k in a.trainers[n].params)
    check(err <= FED_TABLE_ATOL, f"tables differ card vs CPU by {err} > {FED_TABLE_ATOL}")
    log(f"check federation on {dev} vs the CPU ({', '.join(FED_SMALL_OWNERS)} at scale 1/500, "
        f"d={FED_SMALL_DIM}, {FED_SMALL_ROUNDS} PPAT rounds, 2 ticks, fused step, the same "
        f"draws): {len(ev_a)} events equal ({accepts} accepts by {FED_SMALL_OWNERS[0]}, its "
        f"tier at version {version}), epsilon bit-equal, tables max|err|={err:.3g} "
        f"(atol {FED_TABLE_ATOL})")
    return err


# ------------------------------------------------------------ phase 16
class StormClock(StageClock):
    """Phase 15's stage clock plus the robustness stages: the adversary's
    tamper and ``robust_rows``, each call synchronised. Records each
    handshake's cosine threshold (``_cos_tau`` of its client as the
    handshake starts) and mean cosine (``robust_rows``' second output), and
    each tamper's input view, a copy of its ``ent`` taken before the
    tamper, its rows and its output."""

    def __init__(self, torch, fed_mod, sched, dev):
        super().__init__(torch, fed_mod, sched, dev)
        self.verdicts, self.tampers = [], []

    def __enter__(self):
        super().__enter__()
        m, sched = self.fed_mod, self.sched
        robust = self._timed("robust_rows", m.robust_rows)

        def robust_rows(*a, **kw):
            out = robust(*a, **kw)
            self.verdicts[-1]["mean_cos"] = float(out[1])
            return out
        self._patch(m, "robust_rows", robust_rows)
        federate = sched.federate_once

        def federate_once(host, client, **kw):
            self.verdicts.append({"host": host, "client": client,
                                  "tau": sched._cos_tau(client), "mean_cos": None})
            return federate(host, client, **kw)
        self._patch(sched, "federate_once", federate_once)
        adv = sched._adversary_for(None)
        tamper = self._timed("tamper", adv.tamper_view)

        def tamper_view(view, attack, tick, host, client, *, rows):
            before = view["ent"].clone()
            out = tamper(view, attack, tick, host, client, rows=rows)
            self.tampers.append((view, before, attack, rows, out))
            return out
        self._patch(adv, "tamper_view", tamper_view)
        return self


def storm_events(evs):
    """Every field of each event but ``seconds`` and ``sim_finish``."""
    keys = ("tick", "host", "client", "kind", "accepted", "fault", "attack", "level",
            "owner_clock", "view_version", "score_before", "score_after")
    return [tuple(getattr(e, k) for k in keys) + (repr(e.epsilon),) for e in evs]


def check_tampers(torch, tampers, bound):
    """No tamper wrote into the view it was given (its ``ent`` equals the
    copy taken before); each drift or sybil tamper changed at least one row,
    only rows the host reads, and every changed row is finite with norm at
    most ``evade * bound``."""
    n_rows = 0
    for view, before, attack, rows, out in tampers:
        check(torch.equal(view["ent"], before), f"a {attack.kind} tamper wrote into the "
              "frozen view")
        if attack.kind == "replay":
            continue
        changed = (out["ent"] != before).any(1).nonzero().ravel()
        check(changed.numel() > 0, f"a {attack.kind} tamper changed no row")
        read = torch.as_tensor(rows, device=changed.device)
        check(bool(torch.isin(changed, read).all()), "a tamper changed a row the host never reads")
        new = out["ent"][changed]
        cap = attack.evade * bound
        check(bool(torch.isfinite(new).all())
              and float(torch.linalg.vector_norm(new, dim=1).max()) <= cap * (1 + 1e-6),
              f"a tampered row is not finite or exceeds {cap}")
        n_rows += int(changed.numel())
    return n_rows


def check_verdicts(events, verdicts):
    """Pairs each handshake that reached the cosine gate (fault ``None`` or
    ``poison``) with its verdict and checks the rule: ``poison`` iff its
    mean cosine is below its client's τ. Returns the pairs."""
    hs = [e for e in events if e.kind == "ppat" and e.fault in (None, "poison")]
    check(len(verdicts) == len(hs), f"{len(verdicts)} verdicts for {len(hs)} handshakes")
    for e, v in zip(hs, verdicts):
        check((v["host"], v["client"]) == (e.host, e.client) and v["mean_cos"] is not None,
              f"verdict {v} is not handshake {e.client}->{e.host}'s")
        check((e.fault == "poison") == (v["mean_cos"] < v["tau"]),
              f"{e.client}->{e.host}: fault {e.fault} with mean_cos {v['mean_cos']} and "
              f"tau {v['tau']}")
    return list(zip(hs, verdicts))


def storm_path(torch, np, ops, sops, dev, args, card, universe):
    """Phase 16: the reference's resume-test storm with the median and
    cosine defenses over phase 15's universe at full width, cut by a
    checkpoint after one tick and resumed in a fresh scheduler."""
    from repro_torch.checkpoint import restore_scheduler, save_scheduler
    from repro_torch.core import federation as fed_mod
    from repro_torch.core.adversary import AdversaryPlan

    kgs, reg = universe
    plan = AdversaryPlan.parse(STORM_SPEC)

    def make():
        return fed_mod.FederationScheduler(
            kgs, dim=DIM, registry=reg, score_metric="hit10", score_max_test=FED_MAX_TEST,
            update_epochs=1, seed=args.seed, device=dev, tick_adversary=STORM_SPEC,
            robust_agg="median", cos_screen=STORM_COS, tick_impl="reference")

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    path = REPO / "build" / "storm_checkpoint.npz"
    ops.reset_launches()
    sops.reset_launches()
    s1 = make()
    t0 = time.perf_counter()
    s1.initial_training(1)
    init_s = time.perf_counter() - t0
    rep_before = dict(s1._reputation)
    with StormClock(torch, fed_mod, s1, dev) as clock:
        t0 = time.perf_counter()
        s1.run(max_ticks=STORM_CUT)
        sync()
        tick1_s = time.perf_counter() - t0
    cut = s1._tick
    first = [e for e in s1.events if e.kind != "init"]
    hs = [e for e in first if e.kind == "ppat"]
    check(bool(hs), "the storm's first tick planned no handshake")
    for e in hs:
        drawn = plan.draw(e.tick, e.host, e.client)
        check(e.attack == (drawn.kind if drawn else None),
              f"{e.client}->{e.host}: attack {e.attack}, the plan draws {drawn}")
    check(bool(s1._adversary._stale), "the replay cache is empty after the first tick")
    tampered = check_tampers(torch, clock.tampers, plan.bound)
    check(all(e.fault in (None, "poison") for e in hs),
          f"a tick-1 handshake failed otherwise: {[e.fault for e in hs]}")
    want_rep = dict(rep_before)
    for e, v in check_verdicts(hs, clock.verdicts):
        if e.fault == "poison":
            want_rep[e.client] = want_rep.get(e.client, 1.0) * s1.rep_decay
        elif e.accepted:
            for p in (e.host, e.client):
                if p in want_rep:
                    want_rep[p] += s1.rep_recover
                    if want_rep[p] >= 1.0:
                        del want_rep[p]
    check(s1._reputation == want_rep,
          f"reputation {s1._reputation} after the verdicts, want {want_rep} (poison decays "
          "the client's)")
    rep_cut = dict(s1._reputation)
    sync()
    t0 = time.perf_counter()
    save_scheduler(str(path), s1)
    save_s = time.perf_counter() - t0
    ckpt_bytes = path.stat().st_size
    t0 = time.perf_counter()
    s1.run(max_ticks=STORM_RESUMED)
    sync()
    tail_s = time.perf_counter() - t0

    s2 = make()
    t0 = time.perf_counter()
    restore_scheduler(str(path), s2)
    sync()
    restore_s = time.perf_counter() - t0
    path.unlink()
    t0 = time.perf_counter()
    s2.run(max_ticks=STORM_RESUMED)
    sync()
    resumed_s = time.perf_counter() - t0
    launches = {k: v for c in (ops.LAUNCHES, sops.LAUNCHES) for k, v in c.items()}

    tail = [e for e in s1.events if e.tick > cut]
    check(storm_events(tail) == storm_events(s2.events),
          f"the resumed run's events differ from the uninterrupted run's: "
          f"{storm_events(tail)} vs {storm_events(s2.events)}")
    for ledger in ("_reputation", "_retries", "_deferred", "_quarantine_until",
                   "_peer_failures", "_owner_clock", "_view_version", "best_score", "epsilons"):
        check(getattr(s1, ledger) == getattr(s2, ledger), f"{ledger} differs after the resume")
    check({n: list(q) for n, q in s1.queue.items()} == {n: list(q) for n, q in s2.queue.items()},
          "the queues differ after the resume")
    check(s1.accountant.epsilon() == s2.accountant.epsilon(), "lifetime epsilon differs")
    for n in s1.trainers:
        for k, v in s1.trainers[n].params.items():
            check(torch.equal(v, s2.trainers[n].params[k]),
                  f"{n}.{k} is not bit-equal after the resume")
    events = first + tail + [e for e in s2.events]
    trained = len(s1.trainers) + len(first) + len(tail) + len(s2.events)
    want = {"sparse_sgd_step": trained, "fused_ranks": 2 * -(-FED_MAX_TEST // 128) * trained,
            "pairwise_scores": 0}
    if dev.type == "cuda":
        check({k: launches.get(k, 0) for k in want} == want,
              f"the storm launched {launches}, the plan implies {want}")
    stages = dict(clock.secs)
    stages["other"] = tick1_s - sum(stages.values())
    out = {"init_s": init_s, "tick1_s": tick1_s, "tail_s": tail_s, "resumed_s": resumed_s,
           "save_s": save_s, "restore_s": restore_s, "checkpoint_bytes": ckpt_bytes,
           "stage_s": stages, "stage_calls": clock.calls, "tampered_rows": tampered,
           "verdicts": clock.verdicts, "reputation_at_cut": rep_cut,
           "reputation": dict(s1._reputation),
           "events": storm_events(events), "first_events": storm_events(first),
           "launches": launches,
           "replay_cache": sorted(s1._adversary.stale_arrays())}
    log(f"storm: {STORM_SPEC}, robust_agg median, cos_screen {STORM_COS}, on {dev}; initial "
        f"training {init_s:.2f}s; tick {cut} {tick1_s:.3f}s ({tampered} rows tampered, replay "
        f"cache {out['replay_cache']})")
    for e, v in zip(hs, clock.verdicts):
        log(f"storm: tick {e.tick} {e.client}->{e.host} attack {e.attack}: mean_cos "
            f"{v['mean_cos']:.6f} tau {v['tau']:.6f} -> "
            f"{e.fault or ('accepted' if e.accepted else 'restored')}")
    log(f"storm: reputation after tick {cut} {rep_cut}, after tick {s1._tick} "
        f"{s1._reputation}")
    log(f"storm: checkpoint {ckpt_bytes} bytes, saved {save_s:.3f}s, restored {restore_s:.3f}s; "
        f"uninterrupted ticks {cut + 1}-{s1._tick} {tail_s:.3f}s, resumed {resumed_s:.3f}s: "
        f"{len(tail)} events equal, tables bit-equal; launches {launches} (= the plan's {want})")
    for e in tail:
        log(f"storm: tick {e.tick} {e.kind} {e.client}->{e.host} attack {e.attack}: "
            f"{e.fault or ('accepted' if e.accepted else 'restored')}")
    log("storm stages (host clock, s): " + ", ".join(
        f"{k} {v:.4f}" for k, v in stages.items()) + f"; {card}")
    return out


def robust_rows_timings(torch, dev, seed, card):
    """``robust_rows`` alone at the handshake's padded shape (123,904 x
    100, 123,853 true rows) in each mode, with the mean cosine."""
    from repro_torch.core.aggregation import ROBUST_AGG_MODES, robust_rows
    from repro_torch.core.ppat import PPAT_BUCKET

    rows = -(-ALIGNED // PPAT_BUCKET) * PPAT_BUCKET
    g = torch.Generator(device=dev).manual_seed(seed + 61)
    cur = torch.randn(rows, DIM, generator=g, device=dev)
    synth = cur + 0.1 * torch.randn(rows, DIM, generator=g, device=dev)
    out = {}
    for mode in ROBUST_AGG_MODES:
        out[mode] = time_ms(torch, lambda: robust_rows(cur, synth, ALIGNED, mode=mode,
                                                       want_cos=True), ITERS)
    log(f"robust_rows at {rows} x {DIM} ({ALIGNED} true rows), want_cos, ms per call: "
        + ", ".join(f"{m} {v:.4f}" for m, v in out.items()) + f"; {card}")
    return out


def storm_card_vs_cpu(torch, np, dev, seed, tmp_dir):
    """Phase 16 at phase 15's small universe: the storm with the defenses,
    barrier and streamed (bound 0), on ``dev`` and on the CPU under
    ``REPRO_TRAIN_IMPL=fused`` from two ``GeneratorDraws`` of one seed;
    then a checkpoint of the ``dev`` run restored into a CPU scheduler with
    the same draw source runs one more tick. The ``dev`` run's tampers and
    verdicts are checked as at full width. Last, an honest release of the
    host's own rows must pass the cosine gate."""
    import os

    from repro_torch.checkpoint import restore_scheduler, save_scheduler
    from repro_torch.core import federation as fed_mod
    from repro_torch.core.adversary import AdversaryPlan
    from repro_torch.core.federation import FederationScheduler, GeneratorDraws
    from repro_torch.core.ppat import PPATConfig
    from repro_torch.kge.data import synthesize_universe

    uni = synthesize_universe(seed=1, scale=1 / 500)
    kgs = {n: uni[n] for n in FED_SMALL_OWNERS}
    cfg = PPATConfig(steps=FED_SMALL_ROUNDS, seed=seed)
    cpu = torch.device("cpu")
    keys = ("tick", "host", "client", "kind", "accepted", "fault", "attack", "level",
            "owner_clock", "view_version")

    def make(where, sync):
        s = FederationScheduler(kgs, dim=FED_SMALL_DIM, ppat_cfg=cfg, local_epochs=2,
                                update_epochs=1, seed=seed, device=where,
                                draws=GeneratorDraws(seed + 47, cfg, FED_SMALL_DIM),
                                tick_adversary=STORM_SPEC, robust_agg="median",
                                cos_screen=STORM_COS, tick_sync=sync, staleness_bound=0,
                                tick_impl="reference")
        start = torch.Generator().manual_seed(seed + 53)
        for tr in s.trainers.values():  # the same start tables on both
            tr.params = {k: (torch.rand(v.shape, generator=start) - 0.5).to(where)
                         for k, v in tr.params.items()}
        return s

    def evs(s, after=0):
        return [tuple(getattr(e, k) for k in keys) for e in s.events if e.tick > after]

    out = {}
    old = os.environ.get("REPRO_TRAIN_IMPL")
    os.environ["REPRO_TRAIN_IMPL"] = "fused"
    try:
        for sync in ("barrier", "stream"):
            a, b = make(dev, sync), make(cpu, sync)
            a.initial_training()
            with StormClock(torch, fed_mod, a, dev) as clock:
                a.run(max_ticks=2)
            b.initial_training()
            b.run(max_ticks=2)
            check(evs(a) == evs(b), f"{sync}: card and CPU storms differ: {evs(a)} vs {evs(b)}")
            tampered = check_tampers(torch, clock.tampers, AdversaryPlan.parse(STORM_SPEC).bound)
            check_verdicts(a.events, clock.verdicts)
            check(a._reputation == b._reputation, f"{sync}: reputation differs card vs CPU")
            check([repr(e.epsilon) for e in a.events] == [repr(e.epsilon) for e in b.events]
                  and a.accountant.epsilon() == b.accountant.epsilon(),
                  f"{sync}: epsilon differs card vs CPU")
            err = max(max_err(a.trainers[n].params[k].cpu(), b.trainers[n].params[k])
                      for n in kgs for k in a.trainers[n].params)
            check(err <= FED_TABLE_ATOL, f"{sync}: tables differ card vs CPU by {err}")
            path = str(Path(tmp_dir) / f"storm_small_{sync}.npz")
            save_scheduler(path, a)
            cut = a._tick
            a.run(max_ticks=1)
            c = make(cpu, sync)
            restore_scheduler(path, c)
            os.remove(path)
            c.run(max_ticks=1)
            check(evs(c) == evs(a, cut),
                  f"{sync}: the CPU resume of the card's checkpoint differs: {evs(c)} vs "
                  f"{evs(a, cut)}")
            faults = sorted({e.fault for e in a.events if e.fault})
            attacks = sorted({e.attack for e in a.events if e.attack})
            out[sync] = {"events": len(a.events), "table_err": err, "faults": faults,
                         "attacks": attacks, "reputation": dict(a._reputation),
                         "resumed_events": len(evs(c)), "tampered_rows": tampered,
                         "verdicts": clock.verdicts}
            log(f"check storm {sync} on {dev} vs the CPU ({', '.join(FED_SMALL_OWNERS)} at scale "
                f"1/500, d={FED_SMALL_DIM}, {FED_SMALL_ROUNDS} PPAT rounds, 2 ticks, the same "
                f"draws): {len(a.events)} events equal (attacks {attacks}, faults {faults}, "
                f"levels {sorted({e.level for e in a.events})}), reputation {a._reputation}, "
                f"epsilon bit-equal, tables max|err|={err:.3g}; the card's checkpoint resumed "
                f"on the CPU: tick {cut + 1}'s {len(evs(c))} events equal; {tampered} rows "
                f"tampered; {len(clock.verdicts)} verdicts by the rule, mean_cos "
                + ", ".join(f"{v['mean_cos']:.4f}" for v in clock.verdicts))
        # the gate against an honest release it must pass: the client's
        # aligned rows are the host's own, so its synthesized rows point
        # along them
        h = make(dev, "barrier")
        h.initial_training()
        host, client = FED_SMALL_OWNERS[0], FED_SMALL_OWNERS[1]
        idx_c, idx_h = (torch.as_tensor(i, device=dev) for i in h.registry.entities(client, host))
        h.trainers[client].params["ent"][idx_c] = h.trainers[host].params["ent"][idx_h]
        with StormClock(torch, fed_mod, h, dev) as clock:
            e = h.federate_once(host, client)
        v = clock.verdicts[0]
        check(e.fault is None and v["mean_cos"] >= v["tau"],
              f"an honest {client}->{host} release with the host's own rows: fault {e.fault}, "
              f"mean_cos {v['mean_cos']} against tau {v['tau']}")
        out["honest"] = {"mean_cos": v["mean_cos"], "tau": v["tau"], "accepted": e.accepted}
        log(f"check storm gate on {dev}: an honest {client}->{host} release of the host's own "
            f"rows passes, mean_cos {v['mean_cos']:.4f} >= tau {v['tau']:.4f} "
            f"({'accepted' if e.accepted else 'restored'} by the backtrack)")
    finally:
        if old is None:
            del os.environ["REPRO_TRAIN_IMPL"]
        else:
            os.environ["REPRO_TRAIN_IMPL"] = old
    return out


# ------------------------------------------------------------ phase 17
def busy_union_us(prof):
    """Device-busy microseconds of a torch.profiler window as the union of
    its kernels' intervals: kernels on several streams overlap, so their
    summed durations can exceed the window."""
    from torch.autograd import DeviceType

    spans = sorted((evt.start_ns(), evt.start_ns() + evt.duration_ns())
                   for evt in prof.profiler.kineto_results.events()
                   if evt.device_type() == DeviceType.CUDA
                   and not getattr(evt, "is_hidden_event", lambda: False)())
    busy, end = 0, None
    for a, b in spans:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy / 1e3


def profile_tick(torch, fn):
    """``profile_window`` of one tick with the device's busy time taken as
    the union of its kernels (streams overlap) and the stream count."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    by_name = device_us_by_name(prof)
    busy = busy_union_us(prof)
    return {"wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
            "kernel_sum_ms": sum(by_name.values()) / 1e3,
            "idle_share": None if busy == 0 else 1 - busy / wall_us,
            "top": [(k[:90], v / 1e3) for k, v in sorted(by_name.items(),
                                                         key=lambda kv: -kv[1])[:8]]}


def table_diff(torch, a, b):
    """(bit-equal, max |a - b|) over every table of two schedulers."""
    same, err = True, 0.0
    for n in a.trainers:
        for k, v in a.trainers[n].params.items():
            w = b.trainers[n].params[k].to(v.device)
            if not torch.equal(v, w):
                same = False
                err = max(err, max_err(v.cpu(), w.cpu()))
    return same, err


def warm_caches(sched):
    """Fill the tick engine's host-side caches (each pair's aligned sets,
    virtual structure and padded store, each owner's store and scoring
    inputs) the way a scheduler's first handshake ticks fill them."""
    eng = sched._tick_engine
    for host in sched.trainers:
        eng._own_info(host)
        eng._score_info(host)
        for client in sched.registry.partners(host):
            eng._pair_info(client, host)


def run_engines(torch, ops, sops, dev, make, ticks, names, profile=None):
    """Each of ``names`` (engine name → tick_impl) gets its scheduler from
    ``make``, one initial epoch, then ``ticks`` ticks, the schedulers taking
    each tick in turn so that a later batched one replays what an earlier
    one captured. ``profile`` names the steady-state engine: its caches are
    warmed before its first tick (``warm_caches``, timed apart), and that
    tick runs under the profiler (its host clock is the profiled window's).
    After every tick all must equal the first: events (every field but
    ``seconds``), epsilon bit for bit, every table bit for bit. Returns each
    engine's scheduler, per-tick host clock, launches, tick engine counts
    and the profile."""
    res = {}
    for name, impl in names.items():
        s = make(impl)
        s.initial_training(1)
        res[name] = {"sched": s, "tick_s": [], "launches": {}, "engine": []}
        if name == profile:
            t0 = time.perf_counter()
            warm_caches(s)
            res[name]["warm_s"] = time.perf_counter() - t0
    prof = None
    for t in range(ticks):
        for name in names:
            r = res[name]
            s = r["sched"]
            ops.reset_launches()
            sops.reset_launches()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            if name == profile and t == 0 and dev.type == "cuda":
                prof = profile_tick(torch, lambda: s.run(max_ticks=1))
                r["tick_s"].append(prof["wall_ms"] / 1e3)
            else:
                s.run(max_ticks=1)
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                r["tick_s"].append(time.perf_counter() - t0)
            for c in (ops.LAUNCHES, sops.LAUNCHES):
                for k, v in c.items():
                    r["launches"][k] = r["launches"].get(k, 0) + v
            r["engine"].append(dict(s._tick_engine.last) if s.tick_impl == "batched" else None)
        first = next(iter(names))
        base = res[first]["sched"]
        for name in list(names)[1:]:
            s = res[name]["sched"]
            check(storm_events(s.events) == storm_events(base.events),
                  f"tick {t + 1}: {name}'s events differ from {first}'s: "
                  f"{storm_events(s.events)} vs {storm_events(base.events)}")
            check(s.epsilons == base.epsilons, f"tick {t + 1}: {name}'s epsilons differ")
            same, err = table_diff(torch, base, s)
            check(same, f"tick {t + 1}: {name}'s tables differ from {first}'s by {err}")
    return res, prof


def engine_line(name, r):
    eng = [e for e in r["engine"] if e is not None]
    tot = {k: sum(e[k] for e in eng) for k in ("entries", "captured", "replays",
                                                "eager_segments")} if eng else None
    warm = f" (caches warmed first, {r['warm_s']:.3f} s)" if "warm_s" in r else ""
    return (f"{name}: ticks {', '.join(f'{t:.3f}' for t in r['tick_s'])} s host clock{warm}"
            + ("" if tot is None else f"; {tot['entries']} entries, {tot['captured']} graphs "
               f"captured, {tot['replays']} replays, {tot['eager_segments']} eager segments"))


def plan_launches(sched, entries):
    """The launches a plan implies: one epoch-kernel launch per retrain
    epoch and two rank launches per 128-triple chunk of each Hit@10 score."""
    per = {n: 2 * -(-min(len(sched.kgs[n].valid), sched.score_max_test) // 128)
           for n in sched.trainers}
    return {"sparse_sgd_step": len(entries) * sched.update_epochs,
            "fused_ranks": sum(per[e.host] for e in entries), "pairwise_scores": 0}


def engines_full_width(torch, np, ops, sops, dev, args, card, universe, storm_first):
    """Phase 17a: phase 15's universe and scheduler through the serial
    engine, the batched engine (capturing) and the batched engine again
    (replaying), two ticks each from the same draws; then phase 16's storm
    for one tick on the batched engine against phase 16's serial tick."""
    from repro_torch.core import federation as fed_mod
    from repro_torch.core import tick_engine

    kgs, reg = universe
    tick_engine.clear_tick_programs()

    def make(impl, **kw):
        return fed_mod.FederationScheduler(
            kgs, dim=DIM, registry=reg, score_metric="hit10", score_max_test=FED_MAX_TEST,
            update_epochs=1, seed=args.seed, device=dev, tick_impl=impl, **kw)

    names = {"serial": "reference", "batched-capture": "batched", "batched-replay": "batched"}
    res, prof = run_engines(torch, ops, sops, dev, make, FED_TICKS, names,
                            profile="batched-replay")
    graphs = tick_engine.tick_graph_stats()
    programs = tick_engine.tick_program_cache_size()
    entries = [e for e in res["serial"]["sched"].events if e.kind != "init"]
    want = plan_launches(res["serial"]["sched"], entries)
    launches = {}
    for name, r in res.items():
        got = {k: r["launches"].get(k, 0) for k in want}
        if dev.type == "cuda":
            check(got == want, f"{name} launched {got}, the plan implies {want}")
        for k, v in r["launches"].items():
            launches[k] = launches.get(k, 0) + v
    rep = res["batched-replay"]
    check(dev.type != "cuda" or (sum(e["captured"] for e in rep["engine"]) == 0
                                 and sum(e["replays"] for e in rep["engine"]) > 0),
          f"the second batched scheduler captured graphs: {rep['engine']}")
    for r in res.values():
        r["sched"] = None
    # the storm, one tick on the batched engine, against phase 16's serial tick
    ops.reset_launches()
    sops.reset_launches()
    s = make("batched", tick_adversary=STORM_SPEC, robust_agg="median", cos_screen=STORM_COS)
    s.initial_training(1)
    rep_before = dict(s._reputation)
    t0 = time.perf_counter()
    s.run(max_ticks=STORM_CUT)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    storm_s = time.perf_counter() - t0
    storm_ev = [e for e in s.events if e.kind != "init"]
    check(storm_events(storm_ev) == storm_first["events"],
          f"the batched storm tick differs from the serial one: {storm_events(storm_ev)} vs "
          f"{storm_first['events']}")
    check(s._reputation == storm_first["reputation"],
          f"reputation {s._reputation} after the batched storm tick, the serial run's "
          f"{storm_first['reputation']}")
    for k, v in {**ops.LAUNCHES, **sops.LAUNCHES}.items():
        launches[k] = launches.get(k, 0) + v
    out = {"tick_s": {n: r["tick_s"] for n, r in res.items()},
           "warm_s": {n: r.get("warm_s") for n, r in res.items()},
           "engine": {n: r["engine"] for n, r in res.items()},
           "launches_per_engine": {n: r["launches"] for n, r in res.items()},
           "plan_launches": want, "programs": programs, "graphs": graphs, "profile": prof,
           "storm_tick_s": storm_s, "storm_events": storm_events(storm_ev),
           "storm_reputation": dict(s._reputation), "launches": launches}
    log(f"tick engines at full width (phase 15's universe, {FED_TICKS} ticks, the same "
        f"draws): events equal, epsilon bit-equal and tables bit-equal after every tick "
        f"across serial, batched capturing and batched replaying; launches per engine "
        f"{want} (= the plan's); {programs} programs, {graphs['graphs']} graphs, pools "
        f"{graphs['pool_bytes']} bytes, static inputs {graphs['static_bytes']} bytes")
    for name, r in res.items():
        log("tick engines " + engine_line(name, r) + f"; {card}")
    if prof is not None:
        log(f"profile batched-replay tick 1: {prof['wall_ms']:.1f} ms wall (profiled), device "
            f"busy {prof['device_busy_ms']:.1f} ms (union; kernels sum "
            f"{prof['kernel_sum_ms']:.1f} ms), idle share "
            + ("not measured" if prof["idle_share"] is None else f"{prof['idle_share']:.3f}")
            + f"; {card}")
        for name, ms in prof["top"]:
            log(f"profile batched-replay tick 1:   {ms:10.3f} ms  {name}")
    log(f"tick engines: the storm's tick {STORM_CUT} on the batched engine {storm_s:.3f}s: "
        f"{len(storm_ev)} events, faults {[e.fault for e in storm_ev]}, reputation "
        f"{s._reputation} (rep before {rep_before}) equal to phase 16's serial tick")
    tick_engine.clear_tick_programs()
    return out


def mesh_universe(np, args, scale=1.0):
    """Phase 17b's owners: the eleven KGs of Tab. 2 at their entity,
    relation and triple counts (times ``scale``), uniform triples, and Tab.
    3's nineteen alignments drawn uniformly on each side."""
    from repro_torch.core.alignment import AlignmentRegistry
    from repro_torch.kge.data import PAPER_ALIGNMENTS, PAPER_KG_STATS

    kgs = {}
    for i, (name, r, e, n) in enumerate(PAPER_KG_STATS):
        e, n = max(64, int(e * scale)), max(256, int(n * scale))
        seed = args.seed + 100 + i
        kgs[name] = make_kg(np, seed, e, r, draw_known(np, seed, e, r, n), name)
    rng = np.random.default_rng(args.seed + 61)
    reg = AlignmentRegistry()
    for a, b, n_al in PAPER_ALIGNMENTS:
        n_al = min(max(2, int(n_al * scale)), kgs[a].num_entities, kgs[b].num_entities)
        reg.add_entities(a, b, np.sort(rng.choice(kgs[a].num_entities, n_al, replace=False)),
                         rng.choice(kgs[b].num_entities, n_al, replace=False))
    return kgs, reg


def engines_eleven_owners(torch, np, ops, sops, dev, args, card, scale=1.0):
    """Phase 17b: the eleven Tab. 2 owners, one tick through the serial
    engine and twice through the batched one (capturing, then replaying)
    from the same draws."""
    from repro_torch.core import federation as fed_mod
    from repro_torch.core import tick_engine
    from repro_torch.core.ppat import PPATConfig

    t0 = time.perf_counter()
    kgs, reg = mesh_universe(np, args, scale)
    built_s = time.perf_counter() - t0
    tick_engine.clear_tick_programs()

    def make(impl):
        return fed_mod.FederationScheduler(
            kgs, dim=DIM, registry=reg, score_metric="hit10", score_max_test=FED_MAX_TEST,
            update_epochs=1, seed=args.seed, device=dev, tick_impl=impl,
            ppat_cfg=PPATConfig(steps=MESH_ROUNDS, seed=args.seed))

    names = {"serial": "reference", "batched-capture": "batched", "batched-replay": "batched"}
    res, prof = run_engines(torch, ops, sops, dev, make, 1, names, profile="batched-replay")
    sched = res["serial"]["sched"]
    entries = [e for e in sched.events if e.kind != "init"]
    want = plan_launches(sched, entries)
    launches = {}
    for name, r in res.items():
        got = {k: r["launches"].get(k, 0) for k in want}
        if dev.type == "cuda":
            check(got == want, f"eleven owners: {name} launched {got}, the plan implies {want}")
        for k, v in r["launches"].items():
            launches[k] = launches.get(k, 0) + v
    graphs = tick_engine.tick_graph_stats()
    programs = tick_engine.tick_program_cache_size()
    n_ent = sum(kg.num_entities for kg in kgs.values())
    table_bytes = sum(v.numel() * v.element_size() for tr in sched.trainers.values()
                      for v in tr.params.values())
    out = {"owners": len(kgs), "entities": n_ent, "table_bytes": table_bytes,
           "built_s": built_s, "entries": len(entries),
           "kinds": [(e.host, e.kind, e.client) for e in entries], "programs": programs,
           "graphs": graphs, "tick_s": {n: r["tick_s"] for n, r in res.items()},
           "warm_s": {n: r.get("warm_s") for n, r in res.items()},
           "engine": {n: r["engine"] for n, r in res.items()}, "profile": prof,
           "plan_launches": want, "launches": launches}
    for r in res.values():
        r["sched"] = None
    log(f"eleven owners (Tab. 2 counts{'' if scale == 1.0 else f' x {scale}'}, {n_ent} "
        f"entities, {table_bytes} bytes of tables, Tab. 3's alignments, "
        f"d={DIM}, {MESH_ROUNDS} PPAT rounds; built in {built_s:.2f}s): one tick of "
        f"{len(entries)} entries, events equal, epsilon and tables bit-equal across serial, "
        f"batched capturing and batched replaying; {programs} programs, {graphs['graphs']} "
        f"graphs for {len(entries)} entries, pools {graphs['pool_bytes']} bytes, static inputs "
        f"{graphs['static_bytes']} bytes; launches per engine {want} (= the plan's)")
    for name, r in res.items():
        log("eleven owners " + engine_line(name, r) + f"; {card}")
    if prof is not None:
        log(f"profile eleven owners batched-replay tick: {prof['wall_ms']:.1f} ms wall, device "
            f"busy {prof['device_busy_ms']:.1f} ms (union; kernels sum "
            f"{prof['kernel_sum_ms']:.1f} ms), idle share "
            + ("not measured" if prof["idle_share"] is None else f"{prof['idle_share']:.3f}")
            + f"; {card}")
    tick_engine.clear_tick_programs()
    return out


def first_divergence(a, b):
    """``None`` when two schedulers' events agree in every field of
    ``storm_events`` but the scores; else ``(event a, event b, reason)`` for
    the first entry they decide differently, which must have a reason the
    devices explain: a near-tie (both backtrack scores within one scoring
    triple of the other run's: 1/n of Hit@10 over n triples), or a
    refined handshake whose aligned set has fewer rows than the width, where
    the procrustes product is rank-deficient and its polar factor not
    unique (cuSOLVER and LAPACK complete its null space differently). Later
    events follow the other decision and are not compared."""
    keys = ("tick", "host", "client", "kind", "accepted", "fault", "attack", "level",
            "owner_clock", "view_version")
    for x, y in zip(a.events, b.events):
        if [getattr(x, k) for k in keys] == [getattr(y, k) for k in keys]:
            continue
        check([getattr(x, k) for k in keys if k != "accepted"]
              == [getattr(y, k) for k in keys if k != "accepted"],
              f"the runs part at {x} vs {y}")
        n = min(len(a.kgs[x.host].valid), a.score_max_test)
        dim = a.trainers[x.host].model.dim
        if abs(x.score_after - y.score_after) <= 1 / n \
                and abs(x.score_before - y.score_before) <= 1 / n:
            return x, y, "near-tie"
        if x.kind == "ppat" and a.procrustes_refine \
                and a.registry.num_aligned(x.client, x.host) < dim:
            return x, y, (f"rank-deficient procrustes "
                          f"({a.registry.num_aligned(x.client, x.host)} aligned < d = {dim})")
        check(False, f"the runs part at {x} vs {y}, neither a near-tie nor a rank-deficient "
              "procrustes")
    check(len(a.events) == len(b.events), "the runs have different event counts")
    return None


def engines_example(torch, np, dev, args, scale=EXAMPLE_SCALE):
    """Phase 17c: ``examples/federated_11kg_torch.py``'s universe (mixed
    TransE/H/R/D), cut to ``EXAMPLE_CUT``, Hit@10 backtrack, two ticks from
    the same draws and start tables, under ``REPRO_TRAIN_IMPL=fused``:

    - the batched engine against the serial engine, both on ``dev``:
      events, epsilon and tables bit-equal;
    - against the serial engine on the CPU: epsilon bit-equal while the
      runs agree, tables within ``FED_TABLE_ATOL`` when they never part,
      and they may part only where the devices explain it
      (``first_divergence``): at this scale most of Tab. 3's alignments
      have a few rows, fewer than d, and there the procrustes refine is not
      unique;
    - ``tick_placement="sharded"`` over ``OwnerPlacement((dev, cpu))``
      against the single run, held the same way (the owners homed on the
      CPU compute there).

    The CPU runs on one thread: TransR's autograd step is not bit-stable
    run to run on several (the einsum's backward splits its sums)."""
    import importlib.util
    import os

    from repro_torch.core.distributed import OwnerPlacement
    from repro_torch.core.federation import GeneratorDraws
    from repro_torch.core.ppat import PPATConfig

    spec = importlib.util.spec_from_file_location(
        "federated_11kg_torch", REPO / "examples" / "federated_11kg_torch.py")
    ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex)
    cpu = torch.device("cpu")
    cut = dict(EXAMPLE_CUT, scale=scale)
    cfg = PPATConfig(steps=cut["ppat_steps"], seed=0)
    old = os.environ.get("REPRO_TRAIN_IMPL")
    os.environ["REPRO_TRAIN_IMPL"] = "fused"
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    runs, secs = {}, {}
    try:
        start = None
        for name, where, impl, placement in (("cpu-serial", cpu, "reference", None),
                                             ("serial", dev, "reference", None),
                                             ("batched", dev, "batched", "single"),
                                             ("sharded", dev, "batched", "sharded")):
            s = ex.build(where, tick_impl=impl, tick_placement=placement,
                         draws=GeneratorDraws(args.seed + 71, cfg, cut["dim"]),
                         score_metric="hit10", **cut)
            if start is None:
                start = {n: dict(tr.params) for n, tr in s.trainers.items()}
            for n, tr in s.trainers.items():  # the same start tables on every run
                tr.params = {k: v.to(where) for k, v in start[n].items()}
            if name == "sharded":
                s._tick_engine.placement = OwnerPlacement([dev, cpu])
            t0 = time.perf_counter()
            s.initial_training()
            s.run(max_ticks=2)
            secs[name] = time.perf_counter() - t0
            runs[name] = s
    finally:
        torch.set_num_threads(threads)
        if old is None:
            del os.environ["REPRO_TRAIN_IMPL"]
        else:
            os.environ["REPRO_TRAIN_IMPL"] = old
    a, ser, cpu_run, sh = runs["batched"], runs["serial"], runs["cpu-serial"], runs["sharded"]
    check(storm_events(a.events) == storm_events(ser.events),
          f"the example: batched and serial on {dev} differ: {storm_events(a.events)} vs "
          f"{storm_events(ser.events)}")
    same, err_dev = table_diff(torch, a, ser)
    check(same and a.epsilons == ser.epsilons,
          f"the example: batched and serial tables on {dev} differ by {err_dev}")
    out = {"families": {n: tr.model.family for n, tr in a.trainers.items()},
           "events": len(a.events), "seconds": secs, "engine": a._tick_engine.stats,
           "sharded_engine": sh._tick_engine.stats,
           "homes": sh._tick_engine.placement.assignments(),
           "on_cpu": sorted(n for n, tr in sh.trainers.items()
                            if tr.params["ent"].device.type == "cpu"),
           "accepted": sum(e.accepted for e in a.events if e.kind != "init")}
    for key, other in (("cpu", cpu_run), ("sharded", sh)):
        tie = first_divergence(a, other)
        agree = a.events[:a.events.index(tie[0])] if tie is not None else a.events
        check([repr(e.epsilon) for e in agree]
              == [repr(e.epsilon) for e in other.events[:len(agree)]],
              f"the example: epsilon differs from the {key} run before they part")
        err = table_diff(torch, a, other)[1] if tie is None else None
        check(err is None or err <= FED_TABLE_ATOL,
              f"the example: tables differ from the {key} run by {err}")
        out[key] = {"diverged_at": None if tie is None else
                    [(e.tick, e.host, e.client, e.accepted, e.score_before, e.score_after)
                     for e in tie[:2]] + [tie[2]],
                    "events_before": len(agree), "table_err": err}
    fams = sorted(set(out["families"].values()))
    log(f"the example (scale 1/{scale:g}, families {fams}, cut {EXAMPLE_CUT}, Hit@10, 2 "
        f"ticks): batched on {dev} equals serial on {dev} bit for bit ({len(a.events)} events, "
        f"{out['accepted']} accepts; batched counts {a._tick_engine.stats}); against serial on "
        f"the CPU: " + ("events equal, tables max|err|="
                        f"{out['cpu']['table_err']:.3g}" if out["cpu"]["diverged_at"] is None
                        else f"{out['cpu']['events_before']} events equal, then parted at "
                        f"{out['cpu']['diverged_at']}")
        + f"; sharded over ({dev}, cpu), homes {out['homes']}, tables left on the CPU "
        f"{out['on_cpu']}: " + ("events equal, tables max|err|="
                                f"{out['sharded']['table_err']:.3g}"
                                if out["sharded"]["diverged_at"] is None
                                else f"{out['sharded']['events_before']} events equal, then "
                                f"parted at {out['sharded']['diverged_at']}")
        + f"; host clock {', '.join(f'{k} {v:.2f}s' for k, v in secs.items())}")
    return out


# ------------------------------------------------------------ phase 18
def party_side(torch, dev, seed, n, rank):
    """Phase 18a's aligned rows, planted as phase 9 plants them: the
    client's X (rank 0) uniform in ±6/√d like a fresh KGE table's rows, the
    host's Y (rank 1) = X·Q + 0.01·N(0, 1) with Q a seeded random
    orthogonal matrix. Each party builds only its own side from the seed
    (the host rebuilds X to plant Y); nothing but the pipe moves between
    them."""
    g = torch.Generator().manual_seed(seed + 41)
    x = ((torch.rand((n, DIM), generator=g) * 2 - 1) * (6.0 / DIM ** 0.5)).to(dev)
    if rank == 0:
        return x
    q, _ = torch.linalg.qr(torch.randn(DIM, DIM, generator=g))
    return x @ q.to(dev) + 0.01 * torch.randn((n, DIM), generator=g).to(dev)


def party_ids(np, cfg, n, rank):
    """Every round's batch ids of one party, from the numpy stream its
    in-process counterpart samples (``PPATClient``: ``cfg.seed + 29``,
    ``PPATHost``: ``cfg.seed + 17``)."""
    rng = np.random.default_rng(cfg.seed + (29 if rank == 0 else 17))
    return np.stack([rng.integers(0, n, cfg.batch) for _ in range(cfg.steps)])


def party_draws(torch, dev, seed, cfg):
    """The exchange's start state (every role's, as ``init_distributed_ppat``
    makes it) and the host's vote noise (steps, 2, B)."""
    from repro_torch.core.distributed import init_distributed_ppat
    from repro_torch.core.pate import laplace_noise

    state = init_distributed_ppat(torch.Generator(device=dev).manual_seed(seed + 31), DIM, cfg)
    noise = laplace_noise(torch.Generator(device=dev).manual_seed(seed + 43),
                          (cfg.steps, 2, cfg.batch))
    return state, noise


def sync(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def sharded_batches(np, seed, sizes, steps):
    """Phase 18b's global batches (steps, B, 3): positives from the
    Dbpedia-sized store of ``make_kg`` (phase 6's), negatives by
    ``corrupt_triples``, both from one numpy stream."""
    from repro_torch.kge.data import corrupt_triples

    e, r, n = sizes
    kg = make_kg(np, seed, e, r, draw_known(np, seed, e, r, n))
    rng = np.random.default_rng(seed + 53)
    pos = np.stack([kg.train[rng.integers(0, len(kg.train), SHARDED["batch"])]
                    for _ in range(steps)])
    return pos, np.stack([corrupt_triples(rng, p, e) for p in pos])


def sharded_run(torch, group, model, seed, pos, neg):
    """``len(pos)`` sharded steps on this rank from the seeded tables (each
    rank keeps its shard of them), each step timed between synchronises
    with the share spent in the group's calls (staging copies and waiting
    for the peer included); then the gathered tables."""
    from repro_torch.core import distributed as pd
    from repro_torch.kge.models import init_kge

    dev = group.device
    shard = pd.shard_params(init_kge(seed + 47, model, device=dev), group)
    step = pd.make_sharded_kge_step(group, model, lr=SHARDED["lr"])
    before = group.traffic.snapshot()
    ms, comm_ms, losses = [], [], []
    for s in range(len(pos)):
        sync(torch, dev)
        t0, c0 = time.perf_counter(), group.traffic.seconds
        shard, loss = step(shard, pos[s], neg[s])
        sync(torch, dev)
        ms.append((time.perf_counter() - t0) * 1e3)
        comm_ms.append((group.traffic.seconds - c0) * 1e3)
        losses.append(loss)
    after = group.traffic.snapshot()
    return {"ms": ms, "comm_ms": comm_ms, "losses": torch.stack(losses).cpu().numpy(),
            "tensors": after["tensors"] - before["tensors"],
            "bytes": after["bytes"] - before["bytes"],
            "shard_bytes": sum(t.numel() * t.element_size() for t in shard.values()),
            "params": pd.gather_params(shard, group)}


def party_ranks(group, seed, sizes):
    """Phase 18 on one of two ranks (``run_parties``): a. the exchange's
    rounds, each timed between synchronises, with the pipe's share (on the
    client: from the send to the gradient back); b. the sharded step at
    world 2, then on rank 0 the same function at world 1 (a group of one
    party) from the same draws, and the largest difference between the
    gathered tables."""
    import numpy as np
    import torch

    from repro_torch.core import distributed as pd
    from repro_torch.core.ppat import PPATConfig
    from repro_torch.kge.models import KGEModel

    torch.backends.cuda.matmul.allow_tf32 = False
    dev, rank = group.device, group.rank
    n, rounds, kg_sizes, kge_steps = sizes
    cfg = PPATConfig(steps=rounds)
    batches = party_side(torch, dev, seed, n, rank)[
        torch.as_tensor(party_ids(np, cfg, n, rank), device=dev)]
    state, noise = party_draws(torch, dev, seed, cfg)
    state = pd.role_state(state, rank)
    step = pd.ppat_exchange_step(group, cfg)
    hist = {"n0": [], "n1": [], "gen_loss": []}
    round_ms, pipe_ms = [], []
    for s in range(cfg.steps):
        sync(torch, dev)
        t0, w0 = time.perf_counter(), group.traffic.seconds
        state, metrics, votes = step(state, batches[s], noise[s] if rank == 1 else None)
        sync(torch, dev)
        round_ms.append((time.perf_counter() - t0) * 1e3)
        pipe_ms.append((group.traffic.seconds - w0) * 1e3)
        if votes is not None:
            hist["n0"].append(votes[0])
            hist["n1"].append(votes[1])
            hist["gen_loss"].append(metrics["gen_loss"])
    out = {"exchange": {"state": state, "traffic": group.traffic.snapshot(),
                        "round_ms": round_ms, "pipe_ms": pipe_ms,
                        **({k: torch.stack(v) for k, v in hist.items()} if rank == 1 else {})}}
    del batches

    e, r, _ = kg_sizes
    model = KGEModel("transe", e, r, DIM, margin=SHARDED["margin"])
    pos, neg = sharded_batches(np, seed, kg_sizes, kge_steps)
    res = sharded_run(torch, group, model, seed, pos, neg)
    tables = res.pop("params")
    out["sharded"] = res
    if rank == 0:
        solo = sharded_run(torch, pd.make_party_group(0, 1, backend=group.backend, device=dev),
                           model, seed, pos, neg)
        out["sharded_err"] = max(float((tables[k] - solo["params"][k]).abs().max())
                                 for k in ("ent", "rel"))
        del solo["params"]
        out["sharded_world1"] = solo
    return out


def exchange_in_process(torch, np, dev, seed, cfg, n):
    """The same rounds in this process through ``PPATClient`` and
    ``PPATHost.step`` (the stepwise handshake) from the same draws, each
    round timed between synchronises; the per-round vote counts the host's
    accountant took."""
    from repro_torch.core.parties import HOST_KEYS
    from repro_torch.core.ppat import PPATClient, PPATHost

    x, y = party_side(torch, dev, seed, n, 0), party_side(torch, dev, seed, n, 1)
    state, noise = party_draws(torch, dev, seed, cfg)
    client = PPATClient(DIM, x, cfg)
    host = PPATHost(None, DIM, y, cfg, params={k: state[k] for k in HOST_KEYS})
    votes = []
    update = host.accountant.update
    host.accountant.update = lambda n0, n1: (votes.append((n0, n1)), update(n0, n1))
    ms = []
    for s in range(cfg.steps):
        sync(torch, dev)
        t0 = time.perf_counter()
        xb, adv = client.sample_batch()
        grad, _ = host.step(adv, noise[s])
        client.apply_grad(xb, grad)
        sync(torch, dev)
        ms.append((time.perf_counter() - t0) * 1e3)
    return x, y, client, host, votes, ms


def retrieval(torch, al, x, y, w):
    """The host's refinement and score: procrustes of the synthesized rows
    onto Y, then CSLS retrieval accuracy (the cosine kernel on a card)."""
    synth = x @ w
    return al.csls_retrieval_acc(synth @ al.procrustes(synth, y), y)


def parties_path(torch, np, ck, al, dev, args, sizes):
    """Phase 18: the two-party topology of ``examples/distributed_fkge_torch.py``
    at full width, two ranks over ``gloo`` on ``dev`` (both on one card)."""
    from repro_torch.core.distributed import run_parties
    from repro_torch.core.parties import HOST_KEYS
    from repro_torch.core.ppat import PPATConfig
    from repro_torch.core.privacy import MomentsAccountant

    n, rounds, kg_sizes, kge_steps = sizes
    cfg = PPATConfig(steps=rounds)
    t0 = time.perf_counter()
    x, y, client, host, votes, local_ms = exchange_in_process(torch, np, dev, args.seed, cfg, n)
    in_process_s = time.perf_counter() - t0
    log(f"parties: backend {PARTY_BACKEND}, 2 ranks on {dev} (one card: the pipe stages through "
        f"pinned host memory)")
    (build_dir := REPO / "build").mkdir(exist_ok=True)
    rdzv = build_dir / f"parties-rdzv-{time.time_ns()}"
    t0 = time.perf_counter()
    try:
        ranks = run_parties(party_ranks, 2, args.seed, sizes, backend=PARTY_BACKEND,
                            init_method=f"file://{rdzv}", device=dev if dev.type == "cpu" else None)
    finally:
        rdzv.unlink(missing_ok=True)
    spawn_s = time.perf_counter() - t0
    c, h = ranks[0]["exchange"], ranks[1]["exchange"]

    # a. the exchange against the in-process handshake, bit for bit
    check(np.array_equal(c["state"]["w"], client.w.cpu().numpy())
          and np.array_equal(c["state"]["w_vel"], client.vel.cpu().numpy()),
          "phase 18a: the client's W differs from the in-process handshake's")
    for k in HOST_KEYS:
        for leaf, v in host.params[k].items():
            check(np.array_equal(h["state"][k][leaf], v.cpu().numpy()),
                  f"phase 18a: the host's {k}.{leaf} differs from the in-process handshake's")
    check(np.array_equal(h["n0"], np.stack([v[0] for v in votes]))
          and np.array_equal(h["n1"], np.stack([v[1] for v in votes])),
          "phase 18a: the per-round vote counts differ from the in-process handshake's")
    acct = MomentsAccountant(cfg.lam, cfg.delta)
    for n0, n1 in zip(h["n0"], h["n1"]):
        acct.update(n0, n1)
    eps = acct.epsilon()
    check(eps == host.accountant.epsilon() and np.isfinite(eps) and eps > 0,
          f"phase 18a: epsilon {eps} != the in-process {host.accountant.epsilon()}")
    shape = f"float32[{cfg.batch}, {DIM}]"
    for side in (c, h):
        t = side["traffic"]
        check(t["shapes"] == {shape: cfg.steps} and t["tensors"] == cfg.steps,
              f"phase 18a: a party sent {t['shapes']}, not {cfg.steps} x {shape}")
    pipe_bytes = (c["traffic"]["bytes"] + h["traffic"]["bytes"]) / cfg.steps
    check(pipe_bytes == 2 * cfg.batch * DIM * 4, f"phase 18a: {pipe_bytes} bytes a round")
    ck.reset_launches()
    acc = retrieval(torch, al, x, y, torch.as_tensor(c["state"]["w"], device=dev))
    launches = dict(ck.LAUNCHES)
    acc_local = retrieval(torch, al, x, y, client.w)
    check(acc == acc_local, f"phase 18a: CSLS retrieval {acc} != the in-process {acc_local}")
    if dev.type == "cuda":
        want = 2 * -(-n // RETRIEVAL_BLOCK)
        check(launches["cosine_matrix"] == want,
              f"phase 18a: the retrieval launched the cosine kernel {launches['cosine_matrix']} "
              f"times, not {want}")
    del x, y, client, host

    # b. the sharded step: world 2 against world 1
    b2, b1 = ranks[0]["sharded"], ranks[0]["sharded_world1"]
    err = ranks[0]["sharded_err"]
    check(err <= FED_TABLE_ATOL, f"phase 18b: world 2 differs from world 1 by {err} after "
          f"{kge_steps} steps")
    for name, res in (("rank 0", b2), ("rank 1", ranks[1]["sharded"]), ("world 1", b1)):
        check(bool(np.isfinite(res["losses"]).all()), f"phase 18b: a loss of {name} is not finite")
    check(b2["bytes"] == ranks[1]["sharded"]["bytes"], "phase 18b: the ranks moved different bytes")
    med = statistics.median
    out = {"launches": launches, "epsilon": eps, "acc": acc, "in_process_s": in_process_s,
           "spawn_s": spawn_s,
           "round_ms": {"in_process": med(local_ms), "client": med(c["round_ms"]),
                        "host": med(h["round_ms"])},
           "pipe_ms": med(c["pipe_ms"]), "pipe_bytes_per_round": pipe_bytes,
           "pipe_tensors": c["traffic"]["tensors"] + h["traffic"]["tensors"],
           "step_ms": {"world2": med(b2["ms"]), "world1": med(b1["ms"]),
                       "world2_comm": med(b2["comm_ms"])},
           "step_bytes": b2["bytes"] / kge_steps, "step_tensors": b2["tensors"] / kge_steps,
           "shard_bytes": b2["shard_bytes"], "world1_bytes": b1["shard_bytes"],
           "table_err": err, "loss": {"world2": float(b2["losses"][-1]),
                                      "world1": float(b1["losses"][-1])}}
    log(f"parties 18a: exchange at n={n} d={DIM}, {cfg.steps} rounds B={cfg.batch}: client W, "
        f"host discriminators, every round's n0/n1 and epsilon {eps:.6f} bit-equal to the "
        f"in-process handshake; the pipe carried {out['pipe_tensors']} tensors ({shape}), "
        f"{pipe_bytes:.0f} B a round; median ms a round: in process "
        f"{out['round_ms']['in_process']:.3f}, client {out['round_ms']['client']:.3f}, host "
        f"{out['round_ms']['host']:.3f}, pipe (send to gradient back) {out['pipe_ms']:.3f}; "
        f"CSLS retrieval after procrustes {acc:.6f} (= in process), cosine launches {launches}")
    log(f"parties 18b: sharded TransE L1 E={kg_sizes[0]} R={kg_sizes[1]} d={DIM}, "
        f"{kge_steps} steps of B={SHARDED['batch']}: world 2 within {err:.3g} of world 1 "
        f"(atol {FED_TABLE_ATOL}); losses finite, last {out['loss']['world2']:.6f} (world 1 "
        f"{out['loss']['world1']:.6f}); median ms a step: world 2 {out['step_ms']['world2']:.3f} "
        f"({out['step_ms']['world2_comm']:.3f} of it in the group's calls), world 1 "
        f"{out['step_ms']['world1']:.3f}; {out['step_bytes']:.0f} B and "
        f"{out['step_tensors']:.0f} tensors a step per rank; a rank's shard "
        f"{out['shard_bytes']} B (world 1: {out['world1_bytes']} B); spawn to results "
        f"{spawn_s:.1f}s")
    return out


# ------------------------------------------------------------------- main
# ------------------------------------------------------------ phase 20
#: 20a's configuration: qwen3-0.6b as published (28 layers, remat on), fp32
TRAIN_ARCH = "qwen3-0.6b"
TRAIN_PLAN = dict(global_batch=8, seq_len=2048, microbatches=2, ce_chunk=512,
                  learning_rate=1e-3, warmup_steps=2, total_steps=8)
TRAIN_REHEARSE_PLAN = dict(global_batch=4, seq_len=64, microbatches=2, ce_chunk=16,
                           learning_rate=1e-3, warmup_steps=2, total_steps=8)
#: 20b: reduced cards, card against CPU, ``TRAIN_CARD_STEPS`` steps each
TRAIN_CARDS = ("mixtral-8x22b", "whisper-medium", "internvl2-26b", "mamba2-2.7b",
               "jamba-1.5-large-398b")
TRAIN_CARD_PLAN = dict(global_batch=4, seq_len=64, microbatches=2, ce_chunk=32,
                       learning_rate=1e-3, warmup_steps=1, total_steps=3)
TRAIN_CARD_STEPS = 3
#: a step with the kernels against one with the plain versions: the loss
#: within this relative difference, the global gradient norm within
#: ``TRAIN_NORM_RTOL``; the parameters after the update, in units of lr:
#: the root-mean-square difference within ``TRAIN_RMS_LR`` and every element
#: within ``TRAIN_MAX_LR`` (Adam's first step moves an element by lr · g /
#: (|g| + eps), at most lr, plus the decay; where |g| is near eps the two
#: paths' last bits of g can move it anywhere within that, so the maximum
#: is bounded by the step itself and the mean square carries the check)
TRAIN_LOSS_RTOL = 1e-5
TRAIN_NORM_RTOL = 1e-4
TRAIN_RMS_LR = 1e-3
TRAIN_MAX_LR = 2.0
TRAIN_CARD_LOSS_RTOL = 1e-4   # 20b: losses of a reduced card, card against CPU


def train_flops_per_token(cfg, seq):
    """(model FLOPs per token, FLOPs per token the step executes, the
    formulas) of a dense attention card trained at sequence ``seq``: N_mm
    the layers' matrix-product parameters, N_un the unembedding's, A the
    causal attention forward per layer and token (QKᵀ and PV over (S + 1)/2
    keys on average: 2·(S + 1)·H·Dh). Model: 6·(L·N_mm + N_un) + 3·L·A.
    Executed adds remat's second forward of every layer (2·L·N_mm + L·A),
    the plain attention forward the backward recomputes (L·A) and the
    chunked CE's second unembedding (2·N_un)."""
    d, L = cfg.d_model, cfg.num_layers
    n_mm = d * (cfg.q_dim + 2 * cfg.kv_dim) + cfg.q_dim * d + 3 * d * cfg.d_ff
    n_un = cfg.padded_vocab * d
    attn = 2 * (seq + 1) * cfg.num_heads * cfg.head_dim
    model = 6 * (L * n_mm + n_un) + 3 * L * attn
    executed = model + 2 * L * n_mm + 2 * L * attn + 2 * n_un
    text = (f"model = 6*(L*N_mm + N_un) + 3*L*A, executed = model + 2*L*N_mm + 2*L*A + 2*N_un; "
            f"L={L}, N_mm={n_mm:,} (d*(q_dim+2*kv_dim) + q_dim*d + 3*d*d_ff), N_un={n_un:,} "
            f"(V_pad*d, tied), A={attn:,} (2*(S+1)*H*Dh, S={seq})")
    return model, executed, text


def update_diff_lr(torch, a, b, lr):
    """(root-mean-square, max) of the difference of two parameter sets over
    all their elements, in units of ``lr``."""
    sq, n, worst = 0.0, 0, 0.0
    for k, p in a.items():
        d = (p.detach().float() - b[k].detach().float())
        sq += float(torch.sum(d * d))
        n += d.numel()
        worst = max(worst, float(d.abs().max()))
    return (sq / n) ** 0.5 / lr, worst / lr


class BackwardClock:
    """CUDA events around every flash backward (``_backward``: the plain
    attention recomputed and differentiated): their summed device time over
    a window, with no synchronise inside it."""

    def __init__(self, torch, fops):
        self.torch, self.fops, self.pairs = torch, fops, []

    def __enter__(self):
        fn = self.fops._backward
        torch = self.torch

        def timed(ctx, grad_out):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            out = fn(ctx, grad_out)
            b.record()
            self.pairs.append((a, b))
            return out

        self._saved = fn
        self.fops._backward = timed
        return self

    def __exit__(self, *exc):
        self.fops._backward = self._saved

    def ms(self):
        self.torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.pairs)


def kernel_shares(by_name):
    """Device ms of a window's kernels by kind: the flash forward (the
    kernel ``fa::attn_kernel``), GEMMs (cuBLAS and CUTLASS names, those of
    the plain attention backward included), copies, the rest."""
    out = {"flash_forward": 0.0, "gemm": 0.0, "memcpy": 0.0, "other": 0.0}
    for name, us in by_name.items():
        low = name.lower()
        kind = ("flash_forward" if "attn_kernel" in low
                else "gemm" if any(t in low for t in ("gemm", "cutlass", "cublas"))
                else "memcpy" if "memcpy" in low else "other")
        out[kind] += us / 1e3
    return out


def profile_train_step(torch, fops, fn):
    """One training step under a device-only ``torch.profiler`` window, with
    ``BackwardClock`` inside it: (wall ms, busy ms, idle share, ms by kind,
    the plain attention backward's ms, the top kernels)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with BackwardClock(torch, fops) as clock, profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    by_name = device_us_by_name(prof)
    busy = sum(by_name.values()) / 1e3
    return {"wall_ms": wall_ms, "device_busy_ms": busy,
            "idle_share": None if busy == 0 else 1 - busy / wall_ms,
            "by_kind_ms": kernel_shares(by_name), "attention_backward_ms": clock.ms(),
            "top": [(k[:90], v / 1e3) for k, v in sorted(by_name.items(),
                                                         key=lambda kv: -kv[1])[:8]]}


def train_state_copy(torch, train, state, dev):
    """A second ``TrainState`` with ``state``'s parameters and moments (the
    plain-kernel step's)."""
    from repro_torch.models import CausalLM

    model = CausalLM(state.model.cfg, device=dev)
    model.load_state_dict(state.model.state_dict())
    opt = state.opt._replace(mu={k: v.to(dev, copy=True) for k, v in state.opt.mu.items()},
                             nu={k: v.to(dev, copy=True) for k, v in state.opt.nu.items()})
    return train.TrainState(model, opt)


def lm_train(torch, np, fa, ks, dev, args, card):
    """Phase 20a and 20d: qwen3-0.6b trained at its published width and
    depth, a step held against the plain-kernel step, timed and profiled;
    its checkpoint saved and restored."""
    from repro_torch import train
    from repro_torch.checkpoint import load_lm, save_lm
    from repro_torch.configs import TrainConfig, get_config, reduced
    from repro_torch.launch.train import batches, to_device
    from repro_torch.models import CausalLM
    from repro_torch.optim import global_norm

    cuda = dev.type == "cuda"
    cfg = get_config(TRAIN_ARCH)
    cfg = (reduced(cfg) if args.rehearse else cfg).replace(dtype="float32")
    check(cfg.remat, f"{cfg.name}: the card trains with remat")
    plan = TRAIN_REHEARSE_PLAN if args.rehearse else TRAIN_PLAN
    tcfg = TrainConfig(**plan)
    steps, mb = tcfg.total_steps, tcfg.microbatches
    tokens_per_step = tcfg.global_batch * tcfg.seq_len
    attn_layers, _ = layer_counts(cfg)
    # the design's flash launches a step: every attention layer, every
    # microbatch, twice (the forward, and remat's recompute in the backward);
    # the backward itself runs the plain version
    flash_per_step = attn_layers * mb * 2
    if cuda:
        torch.cuda.synchronize(dev)   # the context exists before its statistics are reset
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    state = train.init_train_state(torch.Generator(device=dev).manual_seed(args.seed), cfg,
                                   device=dev)
    data = [to_device(b, cfg, dev) for b in batches(cfg, batch=tcfg.global_batch,
                                                    seq_len=tcfg.seq_len, steps=steps,
                                                    seed=args.seed)]
    sync(torch, dev)
    n_params = sum(p.numel() for p in state.model.parameters())
    log(f"train {cfg.name}: {cfg.num_layers} layers, d={cfg.d_model}, {n_params / 1e9:.3f} B "
        f"parameters at fp32, remat {cfg.remat_policy}, {steps} steps of {tcfg.global_batch} x "
        f"{tcfg.seq_len} tokens in {mb} microbatches, ce_chunk {tcfg.ce_chunk} (set up in "
        f"{time.perf_counter() - t0:.2f}s)")

    # step 1 with the kernels, against the same step under plain_kernels()
    grad_fn = train.make_grad_fn(cfg, tcfg)
    plain_state = train_state_copy(torch, train, state, dev)
    start = fa.LAUNCHES["flash_attention"]
    sync(torch, dev)
    t0 = time.perf_counter()
    loss_k, metrics_k, grads = grad_fn(state.model, data[0])
    norm_k = float(global_norm(grads.values()))
    state, lr = train.apply_update(state, grads, tcfg)
    sync(torch, dev)
    step_s = [time.perf_counter() - t0]
    del grads
    with plain_kernels():
        loss_p, _, grads = grad_fn(plain_state.model, data[0])
        norm_p = float(global_norm(grads.values()))
        plain_state, _ = train.apply_update(plain_state, grads, tcfg)
    del grads
    lr = float(lr)
    loss_k, loss_p = float(loss_k), float(loss_p)
    rms, worst = update_diff_lr(torch, dict(state.model.named_parameters()),
                                dict(plain_state.model.named_parameters()), lr)
    del plain_state
    if cuda:
        torch.cuda.empty_cache()
    loss_rel, norm_rel = abs(loss_k - loss_p) / abs(loss_p), abs(norm_k - norm_p) / norm_p
    check(loss_rel <= TRAIN_LOSS_RTOL, f"train: the kernels' step-1 loss {loss_k} differs from "
          f"the plain step's {loss_p} by {loss_rel:.3g} > {TRAIN_LOSS_RTOL}")
    check(norm_rel <= TRAIN_NORM_RTOL, f"train: gradient norm {norm_k} vs plain {norm_p}: "
          f"{norm_rel:.3g} > {TRAIN_NORM_RTOL}")
    check(rms <= TRAIN_RMS_LR and worst <= TRAIN_MAX_LR,
          f"train: parameters after step 1 differ from the plain step's by rms {rms:.3g} lr "
          f"(tol {TRAIN_RMS_LR}), max {worst:.3g} lr (tol {TRAIN_MAX_LR})")
    log(f"check train step 1, kernels against plain_kernels(): loss {loss_k:.6f} vs "
        f"{loss_p:.6f} ({loss_rel:.3g}, tol {TRAIN_LOSS_RTOL}), gradient norm {norm_k:.6f} vs "
        f"{norm_p:.6f} ({norm_rel:.3g}, tol {TRAIN_NORM_RTOL}), parameters after the update: "
        f"rms {rms:.3g} lr (tol {TRAIN_RMS_LR}), max {worst:.3g} lr (tol {TRAIN_MAX_LR}) ok")

    step = train.make_train_step(cfg, tcfg)
    losses = [loss_k]
    for i in range(1, steps):
        sync(torch, dev)
        t0 = time.perf_counter()
        state, m = step(state, data[i])
        losses.append(float(m["loss"]))   # reads the loss: the step has finished
        sync(torch, dev)
        step_s.append(time.perf_counter() - t0)
    flash = fa.LAUNCHES["flash_attention"] - start
    check(all(np.isfinite(losses)), f"train: a loss is not finite: {losses}")
    if cuda:
        check(flash == steps * flash_per_step,
              f"train: flash launched {flash} times over {steps} steps, not {steps} x "
              f"{attn_layers} layers x {mb} microbatches x 2 (forward, remat) = "
              f"{steps * flash_per_step}")
    with torch.no_grad():
        after = sum(float(train.lm_loss(state.model, cfg, data[0]["tokens"][j::mb],
                                        data[0]["labels"][j::mb], ce_chunk=tcfg.ce_chunk)[0])
                    for j in range(mb)) / mb
    check(after < losses[0], f"train: the loss of step 1's batch did not fall: {losses[0]:.4f} "
          f"at step 1, {after:.4f} after step {steps}")
    log(f"check train: losses {', '.join(f'{x:.4f}' for x in losses)} all finite; step 1's batch "
        f"{losses[0]:.4f} -> {after:.4f} after {steps} steps; flash launches {flash} = {steps} "
        f"steps x {attn_layers} layers x {mb} microbatches x 2 (forward, remat recompute) ok")
    res = {"arch": cfg.name, "params": n_params, "plan": plan, "losses": losses,
           "loss_after_on_batch_1": after, "step1_vs_plain": {
               "loss": [loss_k, loss_p], "grad_norm": [norm_k, norm_p],
               "param_rms_lr": rms, "param_max_lr": worst},
           }
    if cuda:
        med = statistics.median(step_s[1:])
        model_f, exec_f, formula = train_flops_per_token(cfg, tcfg.seq_len)
        _, fp32_rate, tf32_rate = peak_rates(card)
        res.update(step_s=step_s, step_s_median=med, tokens_per_s=tokens_per_step / med,
                   model_flops_per_token=model_f, executed_flops_per_token=exec_f,
                   mfu_fp32=model_f * tokens_per_step / med / fp32_rate,
                   mfu_tf32=model_f * tokens_per_step / med / tf32_rate,
                   executed_tflops=exec_f * tokens_per_step / med / 1e12,
                   peak_gb=peak_gb(torch, dev))
        log(f"time train {cfg.name}: step {med:.3f} s (median of steps 2-{steps}; step 1 "
            f"{step_s[0]:.3f} s), {res['tokens_per_s']:,.0f} tokens/s; {card}")
        log(f"time train FLOPs: {formula}")
        log(f"time train: {model_f / 1e9:.3f} GFLOP a token (model), {exec_f / 1e9:.3f} executed; "
            f"{res['executed_tflops']:.1f} TFLOP/s executed; MFU {100 * res['mfu_fp32']:.1f}% of "
            f"the fp32 peak {fp32_rate / 1e12:.0f} TFLOP/s ({100 * res['mfu_tf32']:.2f}% of the "
            f"TF32 peak {tf32_rate / 1e12:.0f}); peak memory {res['peak_gb']:.2f} GB; {card}")
        prof = profile_train_step(torch, fa.ops, lambda: step(state, data[0]))
        res["profile_step"] = prof
        kinds = prof["by_kind_ms"]
        busy = prof["device_busy_ms"]
        log(f"profile train step: {prof['wall_ms']:.1f} ms, device busy {busy:.1f} ms, idle "
            f"share {prof['idle_share']:.3f}; flash forward {kinds['flash_forward']:.1f} ms "
            f"({100 * kinds['flash_forward'] / busy:.1f}%), plain attention backward "
            f"{prof['attention_backward_ms']:.1f} ms ({100 * prof['attention_backward_ms'] / busy:.1f}%"
            f", CUDA events around each backward), GEMMs {kinds['gemm']:.1f} ms "
            f"({100 * kinds['gemm'] / busy:.1f}%, the backward's included), copies "
            f"{kinds['memcpy']:.1f} ms, other kernels {kinds['other']:.1f} ms; {card}")
        for kname, ms in prof["top"]:
            log(f"profile train step:   {ms:9.3f} ms  {100 * ms / busy:5.1f}%  {kname}")

    # 20d. the checkpoint in the reference's layout, restored bit for bit
    path = REPO / "build" / "lm_train_checkpoint.npz"
    sync(torch, dev)
    t0 = time.perf_counter()
    save_lm(str(path), cfg, state.model, metadata={"arch": cfg.name, "steps": steps})
    save_s = time.perf_counter() - t0
    nbytes = path.stat().st_size
    fresh = CausalLM(cfg, device=dev)
    t0 = time.perf_counter()
    meta = load_lm(str(path), cfg, fresh)
    sync(torch, dev)
    restore_s = time.perf_counter() - t0
    path.unlink()
    want = state.model.state_dict()
    check(meta == {"arch": cfg.name, "steps": steps}, f"checkpoint metadata {meta}")
    for k, v in fresh.state_dict().items():
        check(v.dtype == want[k].dtype and bool(torch.equal(v, want[k])),
              f"checkpoint: {k} did not round-trip bit for bit")
    res["checkpoint"] = {"bytes": nbytes, "save_s": save_s, "restore_s": restore_s}
    log(f"check train checkpoint: {nbytes / 1e9:.3f} GB in the reference's layout saved in "
        f"{save_s:.2f}s, restored into a fresh model in {restore_s:.2f}s, every parameter "
        f"bit-equal ok; {card}")
    # every launch of 20a: the steps, the evaluation, the profiled step
    res["launches"] = {"flash_attention": fa.LAUNCHES["flash_attention"] - start,
                       "ssd_chunks": 0}
    del state, fresh, want, data
    return res


def train_cards(torch, np, fa, ks, dev, args, card):
    """Phase 20b: reduced cards trained on the card and on the CPU from the
    same weights and batches."""
    from repro_torch import train
    from repro_torch.configs import TrainConfig, get_config, reduced
    from repro_torch.launch.train import batches, to_device

    out, launches = {}, {"flash_attention": 0, "ssd_chunks": 0}
    tcfg = TrainConfig(**TRAIN_CARD_PLAN)
    for arch in TRAIN_CARDS:
        cfg = reduced(get_config(arch)).replace(dtype="float32")
        cpu = train.init_train_state(torch.Generator().manual_seed(args.seed), cfg, device="cpu")
        on = train_state_copy(torch, train, cpu, dev)
        step = train.make_train_step(cfg, tcfg)
        attn, ssm = layer_counts(cfg)
        attn += cfg.encoder_layers + (attn if cfg.encoder_layers else 0)   # encoder, cross
        res = {"losses": [], "cpu_losses": []}
        for i, b in enumerate(batches(cfg, batch=tcfg.global_batch, seq_len=tcfg.seq_len,
                                      steps=TRAIN_CARD_STEPS, seed=args.seed)):
            before = {k: fa.LAUNCHES[k] if k in fa.LAUNCHES else ks.LAUNCHES[k]
                      for k in launches}
            on, m = step(on, to_device(b, cfg, dev))
            cpu, mc = step(cpu, to_device(b, cfg, torch.device("cpu")))
            got = {"flash_attention": fa.LAUNCHES["flash_attention"] - before["flash_attention"],
                   "ssd_chunks": ks.LAUNCHES["ssd_chunks"] - before["ssd_chunks"]}
            for k in launches:
                launches[k] += got[k]
            if dev.type == "cuda":
                want = {"flash_attention": 2 * tcfg.microbatches * attn,
                        "ssd_chunks": 2 * tcfg.microbatches * ssm}
                check(got == want, f"train {arch}: launches {got} in step {i + 1}, not {want}")
            loss, ref = float(m["loss"]), float(mc["loss"])
            check(np.isfinite(loss) and abs(loss - ref) <= TRAIN_CARD_LOSS_RTOL * abs(ref),
                  f"train {arch} step {i + 1}: loss {loss} on {dev}, {ref} on the CPU")
            res["losses"].append(loss)
            res["cpu_losses"].append(ref)
            if i == 0:
                lr = float(m["lr"])
                rms, worst = update_diff_lr(
                    torch, {k: v.cpu() for k, v in on.model.state_dict().items()},
                    cpu.model.state_dict(), lr)
                check(rms <= TRAIN_RMS_LR and worst <= TRAIN_MAX_LR,
                      f"train {arch}: parameters after step 1 differ from the CPU's by rms "
                      f"{rms:.3g} lr, max {worst:.3g} lr")
                res["param_rms_lr"], res["param_max_lr"] = rms, worst
        out[arch] = res
        log(f"check train {arch} (reduced) on {dev} vs CPU: losses "
            + ", ".join(f"{a:.5f}/{b:.5f}" for a, b in zip(res["losses"], res["cpu_losses"]))
            + f" (rtol {TRAIN_CARD_LOSS_RTOL}); parameters after step 1 rms "
            f"{res['param_rms_lr']:.3g} lr, max {res['param_max_lr']:.3g} lr; flash {2 * attn} and "
            f"SSD {2 * ssm} launches a microbatch ok")
        del cpu, on
    out["launches"] = launches
    return out


def run_example(name, argv):
    """``main(argv)`` of ``examples/<name>.py``, imported from the checkout."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, REPO / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.main(argv)


def train_examples(torch, np, fa, ks, dev, args, card):
    """Phase 20c: the two training examples on the device."""
    out = {}
    before = fa.LAUNCHES["flash_attention"]
    t0 = time.perf_counter()
    cut = ["--steps", "4", "--ppat-steps", "10", "--retrain-steps", "2"] if args.rehearse else []
    fed = run_example("federated_lm_embeddings_torch", ["--device", str(dev)] + cut)
    sync(torch, dev)
    fed_s = time.perf_counter() - t0
    check(all(np.isfinite([fed["loss_a"], fed["loss_b"], fed["before"], fed["after"]]))
          and np.isfinite(fed["epsilon"]), f"federated LM example: {fed}")
    out["federated_lm"] = {k: fed[k] for k in ("loss_a", "loss_b", "epsilon", "before", "after",
                                               "kept")}
    out["federated_lm"]["seconds"] = fed_s
    log(f"check example federated_lm_embeddings_torch: losses A {fed['loss_a']:.4f}, B "
        f"{fed['loss_b']:.4f}, epsilon {fed['epsilon']:.3f}, host eval {fed['before']:.4f} -> "
        f"{fed['after']:.4f}, {'kept' if fed['kept'] else 'backtracked'}, in {fed_s:.1f}s ok")
    steps = "4" if args.rehearse else "20"
    t0 = time.perf_counter()
    lm = run_example("train_lm_torch", ["--device", str(dev), "--steps", steps, "--log-every",
                                        "2" if args.rehearse else "10"]
                     + (["--batch", "2", "--seq-len", "32"] if args.rehearse else []))
    sync(torch, dev)
    check(np.isfinite(lm["last"]), f"train_lm example: loss {lm['last']}")
    out["train_lm"] = dict(lm, seconds=time.perf_counter() - t0)
    log(f"time example train_lm_torch --steps {steps}: tokens/s "
        + ", ".join(f"{r:,.0f}" for r in lm["tokens_per_s"])
        + f" (per {'2' if args.rehearse else '10'} steps, the first with the warm-up); loss "
        f"{lm['first']:.4f} -> {lm['last']:.4f}; {card}")
    out["launches"] = {"flash_attention": fa.LAUNCHES["flash_attention"] - before,
                       "ssd_chunks": 0}
    return out


def lm_training(torch, np, fa, ks, dev, args, card):
    """Phase 20: LM training (20a and 20d, then 20b, then 20c); every model
    is freed before it returns."""
    fa.reset_launches()
    ks.reset_launches()
    t0 = time.perf_counter()
    out = {"qwen3": lm_train(torch, np, fa, ks, dev, args, card)}
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out["cards"] = train_cards(torch, np, fa, ks, dev, args, card)
    out["examples"] = train_examples(torch, np, fa, ks, dev, args, card)
    out["launches"] = {k: out["qwen3"]["launches"][k] + out["cards"]["launches"][k]
                       + out["examples"]["launches"][k] for k in ("flash_attention", "ssd_chunks")}
    if dev.type == "cuda":
        check(out["launches"]["flash_attention"] == fa.LAUNCHES["flash_attention"]
              and out["launches"]["ssd_chunks"] == ks.LAUNCHES["ssd_chunks"],
              f"phase 20's launches {out['launches']} do not add up to the counters "
              f"{fa.LAUNCHES}, {ks.LAUNCHES}")
        torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t0
    log(f"lm training: phase 20 took {out['phase_s']:.1f}s")
    return out


# ------------------------------------------------------------ phase 21
KIMI = "kimi-k2-1t-a32b"
#: 21a: pairs dry-run on the fake 256-rank production mesh
DRYRUN_PAIRS = (("qwen3-0.6b", "decode_32k"), (KIMI, "decode_32k"))
EP_RANKS = 8        # 21b: expert-parallel ranks on one card, 48 of kimi's 384 experts each
EP_TOKENS = 512     # 21b: tokens per rank
CARD_RANKS = 4      # 21c: ranks of the 1-layer kimi, 96 experts each
CARD_TOKENS = 1024  # 21c: one sequence per rank
#: capacity factors at which nothing drops (checked): 21b's ranks, 21c's
#: ranks (plain branch), and 21c's one-process gather path (every expert's
#: slots sized over all 4,096 tokens)
EP_NO_DROP_CF = 2.0
CARD_NO_DROP_CF = 3.0
CARD_REFERENCE_CF = 8.0
#: 21b/c: bf16 tolerance, relative to the largest |value| compared: the two
#: paths round the same products to bf16 at different points
EP_TOL = 2.0 ** -6
EP_SAMPLES = 4096   # 21b: sampled elements of each expert-gradient block
#: 21b: the gradients taken one backward pass at a time, so no rank (and not
#: the one-process reference) ever holds every expert's gradient at once
EP_GRAD_PASSES = (("router", "shared_gate", "shared_up", "shared_down", "w_down"),
                  ("w_up",), ("w_gate",))


def fill_normal(torch, t, gen, scale):
    """``t`` ← N(0, 1)·scale from ``gen``, drawn in fp32 a few rows at a
    time (a bf16 table never has a whole fp32 twin)."""
    flat = t.view(t.shape[0], -1)
    step = max(1, (1 << 24) // flat.shape[1])
    for i in range(0, flat.shape[0], step):
        rows = flat[i:i + step]
        rows.copy_(torch.randn(rows.shape, generator=gen, device=t.device) * scale)
    return t


def fill_experts(torch, moe, seed, lo, hi):
    """Experts ``lo..hi`` of the layer into ``moe``'s (hi − lo)-expert
    tensors, each expert from its own seed, so any split of the experts
    over ranks draws the same numbers; the router and shared expert (whole
    on every rank) from theirs."""
    d, f = moe.cfg.d_model, moe.cfg.moe.d_ff
    with torch.no_grad():
        for j, name in enumerate(("w_gate", "w_up", "w_down")):
            w = getattr(moe, name)
            for e in range(lo, hi):
                g = torch.Generator(device=w.device).manual_seed(seed * 100_003 + e * 3 + j)
                fill_normal(torch, w[e - lo], g, (f if name == "w_down" else d) ** -0.5)
        g = torch.Generator(device=moe.router.device).manual_seed(seed + 1)
        fill_normal(torch, moe.router, g, d ** -0.5)
        for name in ("shared_gate", "shared_up", "shared_down"):
            fill_normal(torch, getattr(moe, name), g, (f if name == "shared_down" else d) ** -0.5)


def ep_layer(torch, cfg, dev, lo, hi):
    """Kimi's MoE layer holding experts ``lo..hi`` (the whole router and
    shared expert), in bf16 on ``dev``, allocated once."""
    from repro_torch.models.moe import MoE

    with torch.device("meta"):
        moe = MoE(cfg, dtype=torch.bfloat16)
    for name in ("w_gate", "w_up", "w_down"):
        w = getattr(moe, name)
        setattr(moe, name, torch.nn.Parameter(torch.empty((hi - lo,) + w.shape[1:],
                                                          device="meta", dtype=w.dtype)))
    return moe.to_empty(device=dev)


def ep_tokens(torch, cfg, dev, seed, n):
    g = torch.Generator(device=dev).manual_seed(seed + 3)
    return torch.randn((n, 1, cfg.d_model), generator=g, device=dev).to(torch.bfloat16)


def ep_sample_index(torch, shape, seed):
    g = torch.Generator().manual_seed(seed + 5)
    return torch.randint(0, int(torch.tensor(shape).prod()), (EP_SAMPLES,), generator=g)


def ep_rank(group, seed, cfg):
    """Phase 21b on one of ``EP_RANKS`` ranks (``run_parties``, gloo,
    every rank on the same card): the layer's forward timed at the card's
    capacity factor (drops, ms a call, the share in gloo, bytes handed to
    gloo), then forward and backward of ``sum(y²)`` at ``EP_NO_DROP_CF``:
    this rank's outputs, its share of the router's and shared expert's
    gradients, and each local expert's gradient norms and sampled
    elements."""
    import dataclasses

    import torch

    from repro_torch.core.parties import Traffic
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.moe import apply_moe_alltoall

    dev, r = group.device, group.rank
    mesh = make_host_mesh(EP_RANKS, 1, device_type=dev.type)
    e_local = cfg.moe.num_experts // EP_RANKS
    moe = ep_layer(torch, cfg, dev, r * e_local, (r + 1) * e_local)
    fill_experts(torch, moe, seed, r * e_local, (r + 1) * e_local)
    x = ep_tokens(torch, cfg, dev, seed, EP_RANKS * EP_TOKENS)[r * EP_TOKENS:(r + 1) * EP_TOKENS]
    params = moe.params()
    out = {}
    traffic, stats = Traffic(), {}
    with torch.no_grad():
        apply_moe_alltoall(params, x, cfg, mesh)  # warm-up
        ms = []
        for _ in range(3):
            sync(torch, dev)
            t0 = time.perf_counter()
            apply_moe_alltoall(params, x, cfg, mesh, traffic=traffic, stats=stats)
            sync(torch, dev)
            ms.append((time.perf_counter() - t0) * 1e3)
    out["drops"] = stats
    out["ms"] = ms
    out["gloo_share"] = traffic.seconds * 1e3 / sum(ms)
    out["bytes_per_call"] = traffic.bytes / len(ms)
    free_cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=EP_NO_DROP_CF))
    stats = {}
    y, _ = apply_moe_alltoall(params, x, free_cfg, mesh, stats=stats)
    out["no_drop"] = stats
    out["y"] = y.detach().float()
    out["experts"], out["shared"] = {}, {}
    loss = (y.float() ** 2).sum()
    for i, names in enumerate(EP_GRAD_PASSES):
        grads = torch.autograd.grad(loss, [params[k] for k in names],
                                    retain_graph=i + 1 < len(EP_GRAD_PASSES))
        for k, g in zip(names, grads):
            sample = g.flatten()[ep_sample_index(torch, g.shape, seed).to(dev)].float()
            if k == "router":
                out["router"] = g
            elif k.startswith("shared"):
                out["shared"][k] = sample
            else:
                out["experts"][k] = {"norm": expert_norms(torch, g), "sample": sample}
        # ``g`` too: the loop's last gradient (1.3 GiB for an expert matrix)
        # must not live on into the next pass
        del grads, g
    out["peak_bytes"] = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    return out


def expert_norms(torch, g):
    """Each expert's gradient norm in fp32, (E,), a few experts at a time
    (no fp32 copy of the whole bf16 gradient)."""
    return torch.cat([c.float().flatten(1).norm(dim=1) for c in g.split(8)])


def max_rel(a, b):
    """max |a − b| over max |b|."""
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


def ep_reference(torch, cfg, dev, seed, ranks):
    """21b's one-process check: the whole layer (all 384 experts, bf16) on
    every rank's tokens through ``MoE.node_limited`` at a capacity where
    nothing drops; its output and the gradients of ``sum(y²)`` against the
    ranks'."""
    from repro_torch.models.moe import restrict_to_groups, route

    moe = ep_layer(torch, cfg, dev, 0, cfg.moe.num_experts)
    fill_experts(torch, moe, seed, 0, cfg.moe.num_experts)
    x = ep_tokens(torch, cfg, dev, seed, EP_RANKS * EP_TOKENS)
    with torch.no_grad():
        probs = torch.softmax(x.reshape(-1, cfg.d_model).float() @ moe.router, dim=-1)
        _, idx = route(restrict_to_groups(probs, EP_RANKS, cfg.moe.route_groups)[0],
                       cfg.moe.experts_per_token)
        cap = -(-int(torch.bincount(idx.flatten()).max()) // 8) * 8
    y, keep = moe.node_limited(x, EP_RANKS, cap)
    check(bool(keep.all()), "phase 21b: the one-process reference dropped an assignment")
    params = moe.params()
    loss = (y.float() ** 2).sum()
    yf = y.detach().float().reshape(EP_RANKS, EP_TOKENS, 1, -1)
    err = {"y": max(max_rel(torch.as_tensor(r["y"], device=dev), yf[i])
                    for i, r in enumerate(ranks))}
    e_local = cfg.moe.num_experts // EP_RANKS
    for p_i, names in enumerate(EP_GRAD_PASSES):
        grads = torch.autograd.grad(loss, [params[k] for k in names],
                                    retain_graph=p_i + 1 < len(EP_GRAD_PASSES))
        for k, g in zip(names, grads):
            top = max(float(g.max()), -float(g.min()))   # no |g| copy of 11 GB
            if k == "router":
                got = sum(torch.as_tensor(r["router"], device=dev) for r in ranks)
                err[k] = float((got - g).abs().max()) / top
            elif k.startswith("shared"):
                idx = ep_sample_index(torch, g.shape, seed).to(dev)
                got = sum(torch.as_tensor(r["shared"][k], device=dev) for r in ranks)
                err[k] = float((got - g.flatten()[idx].float()).abs().max()) / top
            else:
                norms = expert_norms(torch, g)
                idx = ep_sample_index(torch, (e_local,) + tuple(g.shape[1:]), seed).to(dev)
                err[k] = err[f"{k}_norm"] = 0.0
                for i, r in enumerate(ranks):
                    want = g[i * e_local:(i + 1) * e_local].flatten()[idx].float()
                    got = torch.as_tensor(r["experts"][k]["sample"], device=dev)
                    err[k] = max(err[k], float((got - want).abs().max()) / top)
                    err[f"{k}_norm"] = max(err[f"{k}_norm"], max_rel(
                        torch.as_tensor(r["experts"][k]["norm"], device=dev),
                        norms[i * e_local:(i + 1) * e_local]))
            del g
        del grads
    del moe, params, y, loss
    return err, cap


def card_model(torch, cfg, dev, seed, lo, hi):
    """Kimi cut to ``cfg``'s one layer, bf16 on ``dev``, holding experts
    ``lo..hi``; every other tensor whole, from its own seed (the same on
    every rank), norms at one."""
    from repro_torch.models.model import CausalLM

    with torch.device("meta"):
        model = CausalLM(cfg, device="meta")
    moe = model.layers[0].moe
    for name in ("w_gate", "w_up", "w_down"):
        w = getattr(moe, name)
        setattr(moe, name, torch.nn.Parameter(torch.empty((hi - lo,) + w.shape[1:],
                                                          device="meta", dtype=w.dtype)))
    model = model.to_empty(device=dev)
    with torch.no_grad():
        fill_experts(torch, moe, seed, lo, hi)
        for i, (name, p) in enumerate(model.named_parameters()):
            if ".moe." in name:
                continue
            if name.endswith("scale"):
                p.fill_(1.0)
            else:
                g = torch.Generator(device=dev).manual_seed(seed * 7_919 + i)
                fill_normal(torch, p, g, 0.02 if p.shape[0] == cfg.padded_vocab
                            else p.shape[-1] ** -0.5)
    return model


def card_tokens(torch, cfg, seed, n):
    g = torch.Generator().manual_seed(seed + 7)
    return torch.randint(0, cfg.vocab_size, (n, CARD_TOKENS), generator=g)


def card_rank(group, seed, cfg):
    """Phase 21c on one of ``CARD_RANKS`` ranks: the 1-layer kimi with this
    rank's experts and the mesh set, one forward of this rank's sequence
    (``CausalLM.forward``: the MoE's all-to-all form, flash for the
    attention); its logits and flash launches."""
    import torch

    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.sharding import context as shard_ctx

    dev, r = group.device, group.rank
    shard_ctx.set_mesh(make_host_mesh(CARD_RANKS, 1, device_type=dev.type))
    e_local = cfg.moe.num_experts // CARD_RANKS
    model = card_model(torch, cfg, dev, seed, r * e_local, (r + 1) * e_local)
    tokens = card_tokens(torch, cfg, seed, CARD_RANKS)[r:r + 1].to(dev)
    flash_ops.reset_launches()
    with torch.no_grad():
        logits = model(tokens)
    sync(torch, dev)
    # sent back as bf16 bits (half of fp32's 671 MB a rank through the pipe)
    return {"logits": logits.to(torch.bfloat16).view(torch.int16),
            "flash": flash_ops.LAUNCHES["flash_attention"],
            "peak_bytes": torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0}


def ep_rehearse_config():
    """Phase 21's rehearsal layer: kimi reduced, 32 experts top-4, route
    groups 4 (grouped over 21b's 8 ranks, plain over 21c's 4), bf16."""
    import dataclasses

    from repro_torch.configs import get_config, reduced

    cfg = reduced(get_config(KIMI))
    return cfg.replace(dtype="bfloat16", moe=dataclasses.replace(
        cfg.moe, num_experts=32, experts_per_token=4, d_ff=64, route_groups=4))


def sharding_path(torch, np, fa, dev, args, card, sizes):
    """Phase 21: a. the dry-run of ``DRYRUN_PAIRS`` on the fake 256-rank
    mesh; b. kimi's MoE layer over ``EP_RANKS`` gloo ranks on ``dev``
    against the one-process gather path; c. kimi cut to one layer over
    ``CARD_RANKS`` ranks, the mesh set, against the one-process forward.
    ``sizes`` is (the card, the layer's config for b and c)."""
    import dataclasses

    from repro_torch.core.distributed import run_parties
    from repro_torch.launch.dryrun import dryrun_one

    cfg = sizes
    out = {"dryrun": {}}
    for arch, shape in DRYRUN_PAIRS if dev.type == "cuda" else DRYRUN_PAIRS[:1]:
        t0 = time.perf_counter()
        r = dryrun_one(arch, shape, verbose=False)
        check(r["status"] == "ok" and r["chips"] == 256, f"phase 21a: {arch} x {shape}: {r}")
        m, rf = r["memory"], r["roofline"]
        out["dryrun"][f"{arch}/{shape}"] = dict(r, seconds=time.perf_counter() - t0)
        log(f"sharding 21a: dry-run {arch} x {shape} on a fake 256-rank (16, 16) mesh: "
            f"{r['status']}, peak {m['peak_bytes_per_device']} B and arguments "
            f"{m['argument_bytes_per_device']} B per rank; roofline (H100 data sheet) compute "
            f"{rf['compute_s']:.3e}s memory {rf['memory_s']:.3e}s collective "
            f"{rf['collective_s']:.3e}s -> {rf['bottleneck']}; collectives "
            f"{r['collectives']}; {time.perf_counter() - t0:.1f}s")

    (build_dir := REPO / "build").mkdir(exist_ok=True)
    device = dev if dev.type == "cpu" else None

    def spawn(fn, world, layer_cfg):
        if dev.type == "cuda":  # the ranks share the card: what this process left goes first
            gc.collect()
            torch.cuda.empty_cache()
            log(f"sharding: before {world} ranks this process holds "
                f"{torch.cuda.memory_allocated(dev)} B allocated, "
                f"{torch.cuda.memory_reserved(dev)} B reserved on the card")
        rdzv = build_dir / f"sharding-rdzv-{time.time_ns()}"
        try:
            return run_parties(fn, world, args.seed, layer_cfg, backend="gloo",
                               init_method=f"file://{rdzv}", device=device, timeout=600)
        finally:
            rdzv.unlink(missing_ok=True)

    # b. the expert-parallel layer
    t0 = time.perf_counter()
    ranks = spawn(ep_rank, EP_RANKS, cfg)
    ranks_s = time.perf_counter() - t0
    for r in ranks:
        check(r["no_drop"]["dropped1"] == r["no_drop"]["dropped2"] == 0,
              f"phase 21b: a rank dropped at capacity factor {EP_NO_DROP_CF}: {r['no_drop']}")
    err, cap = ep_reference(torch, cfg, dev, args.seed, ranks)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    for k, v in err.items():
        check(v <= EP_TOL, f"phase 21b: {k} differs from the one-process gather path by {v} "
              f"of its largest value (tolerance {EP_TOL})")
    e_local = cfg.moe.num_experts // EP_RANKS
    payload = EP_TOKENS * cfg.moe.route_groups * (cfg.d_model + e_local) * 2
    med = statistics.median
    out["ep"] = {"ranks_s": ranks_s, "err": err, "reference_cap": cap,
                 "ms": [med(r["ms"]) for r in ranks],
                 "gloo_share": [r["gloo_share"] for r in ranks],
                 "bytes_per_call": [r["bytes_per_call"] for r in ranks],
                 "payload_bytes_per_direction": payload,
                 "drops": [r["drops"] for r in ranks],
                 "peak_bytes": [r["peak_bytes"] for r in ranks]}
    log(f"sharding 21b: kimi's MoE layer (d {cfg.d_model}, {cfg.moe.num_experts} experts top-"
        f"{cfg.moe.experts_per_token}, d_ff {cfg.moe.d_ff}, a shared expert, route groups "
        f"{cfg.moe.route_groups}, bf16) over {EP_RANKS} gloo ranks on {dev}, {e_local} experts "
        f"and {EP_TOKENS} tokens each: at capacity factor {EP_NO_DROP_CF} nothing dropped and "
        f"the output and gradients match the one-process gather path (cap {cap}) within "
        f"{EP_TOL:.4f} of the largest value: {json.dumps(err)}; at the card's factor "
        f"{cfg.moe.capacity_factor}: drops per rank (stage 1, stage 2) "
        f"{[(r['drops']['dropped1'], r['drops']['dropped2']) for r in ranks]}, ms a call "
        f"{[round(v, 3) for v in out['ep']['ms']]}, share in gloo "
        f"{[round(v, 3) for v in out['ep']['gloo_share']]}, bytes handed to gloo a call "
        f"{out['ep']['bytes_per_call'][0]:.0f} (two exchanges) against T_l*G*(d+E_l)*2 = "
        f"{payload} a direction; peak allocated a rank {out['ep']['peak_bytes']} B; ranks "
        f"{ranks_s:.1f}s")
    del ranks

    # c. one layer of kimi, the mesh set
    card_cfg = cfg.replace(num_layers=1, moe=dataclasses.replace(
        cfg.moe, capacity_factor=CARD_NO_DROP_CF))
    t0 = time.perf_counter()
    ranks = spawn(card_rank, CARD_RANKS, card_cfg)
    ranks_s = time.perf_counter() - t0
    if dev.type == "cuda":
        for r in ranks:
            check(r["flash"] == 1, f"phase 21c: a rank launched flash {r['flash']} times, not 1")
    card_cfg = card_cfg.replace(moe=dataclasses.replace(
        cfg.moe, capacity_factor=CARD_REFERENCE_CF))
    model = card_model(torch, card_cfg, dev, args.seed, 0, cfg.moe.num_experts)
    tokens = card_tokens(torch, card_cfg, args.seed, CARD_RANKS).to(dev)
    seen = {}
    hook = model.layers[0].moe.register_forward_hook(
        lambda mod, inp, outp: seen.update(x=inp[0]))
    with torch.no_grad():
        want = model(tokens)
        hook.remove()
        _, _, info = model.layers[0].moe(seen["x"], details=True)
    check(bool(info["keep"].all()), "phase 21c: the one-process forward dropped an assignment")
    err = max(max_rel(torch.as_tensor(r["logits"], device=dev).view(torch.bfloat16)[0].float(),
                      want[i]) for i, r in enumerate(ranks))
    check(err <= EP_TOL, f"phase 21c: the ranks' logits differ from the one-process forward by "
          f"{err} of the largest (tolerance {EP_TOL})")
    out["card"] = {"ranks_s": ranks_s, "logits_err": err, "flash": [r["flash"] for r in ranks],
                   "peak_bytes": [r["peak_bytes"] for r in ranks]}
    log(f"sharding 21c: {KIMI} at published width cut to 1 layer, bf16, over {CARD_RANKS} gloo "
        f"ranks on {dev} ({cfg.moe.num_experts // CARD_RANKS} experts each, the mesh set: the "
        f"MoE's plain all-to-all branch): each rank's logits for 1 x {CARD_TOKENS} tokens "
        f"within {err:.3g} of the largest of the one-process gather forward (tolerance "
        f"{EP_TOL:.4f}); flash launches per rank {out['card']['flash']}; peak allocated a rank "
        f"{out['card']['peak_bytes']} B; ranks {ranks_s:.1f}s")
    del model, want
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out["launches"] = {"flash_attention": sum(out["card"]["flash"])}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=str(REPO / "build" / "chip_smoke.json"),
                    help="where to write the full results as JSON")
    ap.add_argument("--rehearse", action="store_true",
                    help="run the main paths at a tiny size on the CPU (plain versions "
                         "only) and exit non-zero: a check of the script, not of the card")
    args = ap.parse_args(argv)

    if not (SRC / "repro_torch" / "kernels" / "triple_score" / "csrc").is_dir():
        print(f"chip_smoke: the port's sources are not beside this script ({SRC})",
              file=sys.stderr)
        return 2
    import numpy as np
    import torch

    if not args.rehearse and not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke needs a CUDA card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.core import alignment as al
    from repro_torch.core import ppat as tp
    from repro_torch.kernels import _nvcc
    from repro_torch.kernels.csls import ops as ck
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ks
    from repro_torch.kernels.sparse_update import ops as sops
    from repro_torch.kernels.triple_score import ops
    from repro_torch.kge import engine as kge_engine
    from repro_torch.kge import models
    from repro_torch import serving
    from repro_torch.serving import engine

    if args.rehearse:
        dev = torch.device("cpu")
        sizes = (4_000, 50, 12_000)
        tier, m, versions, waves, res = serve(torch, np, models, serving, ops, dev, args, sizes)
        recheck_served(torch, np, models, ops, tier, m, versions, waves, dev)
        known = draw_known(np, args.seed, *sizes)
        trainer, _ = train_path(torch, np, models, ops, sops, tier, dev, args, known, sizes[:2])
        handshake_path(torch, np, models, ops, sops, ck, tier, trainer, dev, args,
                       (3_000, YAGO["relations"], 12_000, 1_000))
        for arch, counter in (("qwen3-0.6b", (fa, "flash_attention")),
                              ("mamba2-2.7b", (ks, "ssd_chunks"))):
            lm_serve(torch, np, arch, dev, args, "cpu", counter, LM_REHEARSE_PLAN)
        _, universe = federation_path(
            torch, np, ops, sops, serving, dev, args, "cpu",
            ((4_000, 50, 12_000), (3_000, YAGO["relations"], 12_000), 1_000))
        storm = storm_path(torch, np, ops, sops, dev, args, "cpu", universe)
        storm_card_vs_cpu(torch, np, dev, args.seed, REPO / "build")
        engines_full_width(torch, np, ops, sops, dev, args, "cpu", universe,
                           {"events": storm["first_events"],
                            "reputation": storm["reputation_at_cut"]})
        engines_eleven_owners(torch, np, ops, sops, dev, args, "cpu", scale=0.002)
        engines_example(torch, np, dev, args, scale=4000)
        parties_path(torch, np, ck, al, dev, args, (1_000, 20, (4_000, 50, 12_000), 30))
        lm_cards(torch, np, fa, ks, dev, args, "cpu")
        lm_training(torch, np, fa, ks, dev, args, "cpu")
        sharding_path(torch, np, fa, dev, args, "cpu", ep_rehearse_config())
        print("chip_smoke: rehearsal on the CPU passed; no card, so no result", file=sys.stderr)
        return 3

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    libraries = (ops.LIBRARIES + sops.LIBRARIES + ck.LIBRARIES + fa.ops.LIBRARIES
                 + ks.ops.LIBRARIES)
    build_logs = _nvcc.build_all(libraries)
    build_s = time.perf_counter() - t0
    log(f"build: {len(libraries)} kernel libraries in {build_s:.2f}s")
    sass = {}
    for lib in libraries:
        regs = [ln.strip() for ln in build_logs[lib.name].splitlines()
                if "Used" in ln and "registers" in ln or "spill" in ln and "bytes spill" in ln
                and not ln.strip().startswith("0 bytes")]
        log(f"build {lib.name}: " + (" | ".join(regs) if regs else f"already built ({lib.path})"))
        sass[lib.name] = tensor_core_ops(lib.path)
        log(f"sass {lib.name}: tensor-core instructions {sass[lib.name]}")
    ssd_tc = sass[ks.ops.SSD_LIB.name]
    check(bool(ssd_tc) and ssd_tc["HMMA"] + ssd_tc["HGMMA"] > 0,
          f"the SSD chunk library has no tensor-core instruction: {ssd_tc}")

    worst = kernel_vs_plain(torch, ops, models, dev, args.seed, 50_000)
    tier, m, versions, waves, res = serve(
        torch, np, models, serving, ops, dev, args,
        (DBPEDIA["entities"], DBPEDIA["relations"], DBPEDIA["triples"]))
    for name in ("pairwise_topk", "fused_ranks"):
        check(res["launches"][name] > 0, f"the main path never launched {name}")
    topk_err = recheck_served(torch, np, models, ops, tier, m, versions, waves, dev)
    times = timings(torch, models, ops, engine, m, versions[1], tier.filters, dev, card)
    times["requests"] = request_times(torch, np, serving, m, versions[1], tier.filters, card)
    times["profile"] = profile_serving(torch, np, tier, m, args.seed, card)

    e, r = DBPEDIA["entities"], DBPEDIA["relations"]
    worst["sparse_sgd_step"] = step_vs_plain(torch, np, models, sops, dev, args.seed, e, r)
    known = draw_known(np, args.seed, e, r, DBPEDIA["triples"])
    trainer, train = train_path(torch, np, models, ops, sops, tier, dev, args, known, (e, r))
    times["sparse_sgd_step"] = step_timings(torch, np, sops, kge_engine, trainer, dev, card)
    times["profile_train"] = profile_training(torch, kge_engine, trainer, card)

    worst["cosine_matrix"] = cosine_vs_plain(torch, ck, al, dev, args.seed)
    hs_res, hs, ppat_cfg, ctx = handshake_path(
        torch, np, models, ops, sops, ck, tier, trainer, dev, args,
        (YAGO["entities"], YAGO["relations"], YAGO["triples"], ALIGNED))
    hs["ppat_card_vs_cpu_w_err"] = ppat_card_vs_cpu(torch, tp, hs_res["x"], hs_res["y"], dev,
                                                    args.seed)
    times["cosine_matrix"] = csls_timings(torch, ck, al, hs_res["synth"], hs_res["y"], card)
    del hs_res
    times["profile_handshake"] = profile_handshake(torch, np, trainer, ctx, ppat_cfg, args.seed,
                                                   card)
    del ctx, tier, trainer, versions, waves
    torch.cuda.empty_cache()

    worst.update(lm_kernels_vs_plain(torch, fa, ks, dev, args.seed))
    lm = {}
    for arch, counter in (("qwen3-0.6b", (fa, "flash_attention")),
                          ("mamba2-2.7b", (ks, "ssd_chunks"))):
        lm[arch] = lm_serve(torch, np, arch, dev, args, card, counter, LM_PLANS[arch])
        torch.cuda.empty_cache()
    times.update(lm_timings(torch, fa, ks, dev, card))

    t0 = time.perf_counter()
    fed, universe = federation_path(
        torch, np, ops, sops, serving, dev, args, card,
        ((DBPEDIA["entities"], DBPEDIA["relations"], DBPEDIA["triples"]),
         (YAGO["entities"], YAGO["relations"], YAGO["triples"]), ALIGNED))
    fed["card_vs_cpu_table_err"] = fed_card_vs_cpu(torch, np, dev, args.seed)
    fed["phase_s"] = time.perf_counter() - t0
    log(f"federation: phase 15 took {fed['phase_s']:.1f}s")
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    storm = storm_path(torch, np, ops, sops, dev, args, card, universe)
    torch.cuda.empty_cache()
    storm["robust_rows_ms"] = robust_rows_timings(torch, dev, args.seed, card)
    storm["card_vs_cpu"] = storm_card_vs_cpu(torch, np, dev, args.seed, REPO / "build")
    storm["phase_s"] = time.perf_counter() - t0
    log(f"storm: phase 16 took {storm['phase_s']:.1f}s")
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    engines = {"full_width": engines_full_width(
        torch, np, ops, sops, dev, args, card, universe,
        {"events": storm["first_events"], "reputation": storm["reputation_at_cut"]})}
    del universe
    torch.cuda.empty_cache()
    engines["eleven_owners"] = engines_eleven_owners(torch, np, ops, sops, dev, args, card)
    torch.cuda.empty_cache()
    engines["example"] = engines_example(torch, np, dev, args)
    engines["phase_s"] = time.perf_counter() - t0
    log(f"tick engines: phase 17 took {engines['phase_s']:.1f}s")
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    two_parties = parties_path(torch, np, ck, al, dev, args,
                               (ALIGNED, tp.PPATConfig().steps,
                                (DBPEDIA["entities"], DBPEDIA["relations"], DBPEDIA["triples"]),
                                SHARDED["steps"]))
    two_parties["phase_s"] = time.perf_counter() - t0
    log(f"parties: phase 18 took {two_parties['phase_s']:.1f}s")
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    cards = lm_cards(torch, np, fa, ks, dev, args, card)
    cards["phase_s"] = time.perf_counter() - t0
    log(f"lm cards: phase 19 took {cards['phase_s']:.1f}s")
    torch.cuda.empty_cache()

    training = lm_training(torch, np, fa, ks, dev, args, card)

    t0 = time.perf_counter()
    from repro_torch.configs import get_config

    sharding = sharding_path(torch, np, fa, dev, args, card, get_config(KIMI))
    sharding["phase_s"] = time.perf_counter() - t0
    log(f"sharding: phase 21 took {sharding['phase_s']:.1f}s")

    # each kernel's launches over the main paths that run it: serving (phase
    # 3), training (phase 6), the handshake (phase 9), LM serving (phase 12),
    # the federation with its attached tier (phase 15), the storm (phase 16)
    # the tick engines at full width and over the eleven owners (phase 17,
    # replays counted), the two parties' retrieval (phase 18), the
    # remaining LM cards (phase 19), LM training (phase 20) and the ranks of
    # the 1-layer kimi (phase 21)
    lm_launches = {name: lm["qwen3-0.6b"]["launches"].get(name, 0)
                   + lm["mamba2-2.7b"]["launches"].get(name, 0) + cards["launches"][name]
                   + training["launches"][name] + sharding["launches"].get(name, 0)
                   for name in ("flash_attention", "ssd_chunks")}
    launches = {name: res["launches"].get(name, 0) + train["launches"].get(name, 0)
                + hs["launches"].get(name, 0) + lm_launches.get(name, 0)
                + fed["launches"].get(name, 0) + storm["launches"].get(name, 0)
                + engines["full_width"]["launches"].get(name, 0)
                + engines["eleven_owners"]["launches"].get(name, 0)
                + two_parties["launches"].get(name, 0)
                for name in KERNELS}
    for name in ("flash_attention", "ssd_chunks"):
        check(launches[name] > 0, f"the LM serving path never launched {name}")

    kernels = []
    for name in KERNELS:
        x = times[name]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name], "replaces": REPLACES[name],
            "launches": launches[name],
            "max_abs_err": max(worst[name], x.get("max_abs_err", 0),
                               topk_err if name == "pairwise_scores" else 0),
            "ms": x["ms"], "device_ms": x["device_ms"], "plain_ms": x["plain_ms"],
            "bound_ms": x["bound_ms"],
            "bound_by": x["bound_by"], "library_ms": x["library_ms"],
        })
    result = {"card": card, "build_s": build_s, "sass": sass, "check_max_abs_err": worst,
              "serve": res,
              "train": train, "handshake": hs, "lm": lm, "federation": fed, "storm": storm,
              "tick_engines": engines, "parties": two_parties, "lm_cards": cards,
              "lm_training": training, "sharding": sharding,
              "timings": times,
              "kernels": kernels,
              "seconds": time.perf_counter() - t_start}
    try:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1, default=str))
    except OSError as ex:
        log(f"could not write {args.out}: {ex}")
    log(f"total {result['seconds']:.1f}s")
    log(card)  # the card's name and power limit, as nvidia-smi gives them
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as ex:
        print(f"chip_smoke: FAILED: {ex}", file=sys.stderr)
        sys.exit(1)
