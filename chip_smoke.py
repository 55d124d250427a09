#!/usr/bin/env python3
"""Build and drive the PyTorch / CUDA port (``src/repro_torch``) on one card.

Run from the root of a checkout on a machine with an NVIDIA H100 and the
CUDA toolkit:

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:

1. device  — the card's name, count, and ``nvidia-smi`` name / power limit;
2. build   — nvcc builds the three CUDA kernel libraries from
             ``kernels/csrc`` in parallel and prints ptxas's registers and
             spills per instantiation (no forward instantiation, and not
             the f32 and bf16 D=64, D=80 and D=256 backward kernels,
             granite's, hubert-xlarge's and the hybrid's training paths',
             may spill; the D=128 ones, deepseek-moe-16b's, spill and are
             printed) and the count of tensor-core instructions (HMMA /
             HGMMA in ``cuobjdump -sass``) of every forward instantiation
             and of those six backward ones, which must not be 0;
3. kernels — each CUDA kernel against its plain-torch version on the same
             inputs, f32 and bf16: the forward and decode at granite-3-2b's
             prefill / decode shapes, the fused backward kernel at its
             training shape (B 4, 32/8 heads, S 2048, D 64, causal), plus
             window, segments, dropout, ragged, q-suffix, head-dim-128 /
             GQA-5 and bf16-ACC cases, and against the naive oracle (autograd
             of it for the backward) on a small input; the backward twice on
             the same inputs (dK, dV bit-equal, dQ within tolerance: its
             atomic adds run in another order); the paged decode at
             page sizes 4, 16 and 32, groups 4 and 5, ragged lengths with 0,
             a 1e6-poisoned trash page past each allocation and out of the
             window, 1 and 3 splits and 256 chunk-prefill token rows, and
             bit for bit against the contiguous kernel on the gathered pages;
             the gated paged decode (one shard of a sharded pool, raw
             partials) at the same cases with about half the table entries
             foreign and their pages 1e6, and two shards' partials (local
             pools, tables remapped to local ids, local trash pages 1e6)
             merged against the ungated kernel on the whole pool; both
             also at a packed chunk row of 256 token rows over three tables
             and padding (query tiles with mixed tables, ``row_tokens``
             256) at D 64, D 32 and D 128 with a GQA group of 5, and each
             case's launch geometry printed (clusters at the decode shape,
             which must put a block on every SM); and every kernel at
             recurrentgemma-2b's geometry (10/1 heads, D 256): the forward
             at B 2, S 3072, causal, window 2048 and with ragged segments,
             the contiguous decode over a ring of 2048 slots (kv_len with
             0), the paged and the gated decode at page 16, window 2048
             (out-of-window pages reclaimed to the 1e6 trash page) and at
             256 chunk token rows; and the backward at recurrentgemma-2b's
             training geometry (B 1, 10/1 heads, D 256, S 3072, causal,
             window 2048) in f32 and bf16, with bf16-ACC, dropout 0.1 and
             segments; and every kernel at the MoE family's shapes (D 128):
             deepseek-moe-16b's 16/16 heads (a GQA group of 1) in the
             forward at prefill (B 4, S 512) and training (B 2, S 2048,
             dropout 0.1), the backward at training (f32, bf16, bf16-ACC),
             the contiguous decode over 544 slots, the paged and gated decode
             at page 16 (decode rows, 256 chunk rows, a mixed chunk row), and
             dbrx-132b's 48/8 heads (a group of 6) in the forward (B 2, S
             256) and the decode over 272 slots; and rows 1 and 2-3 at
             hubert-xlarge's training geometry (B 8, 16/16 heads, S 1024, D
             80, non-causal) in f32 and bf16, with dropout 0.1, segments
             and bf16-ACC (row 1 also with q a ragged suffix of a longer
             kv), and against the naive oracle (autograd of it for the
             backward) at D 80 non-causal; the non-causal path at
             granite's training geometry (D 64); and llava-next-34b's 56/8
             heads (a GQA group of 7, D 128) in the forward (B 4, S 1024),
             the backward (B 1, S 2048), the contiguous decode over 1056
             slots (kv_len with 0) and the paged decode at page 16 (decode
             rows, a 256-row chunk), each case's launch geometry printed;
             and row 4's shard-partials mode (``flash_decode_partials``,
             one shard of a sequence-sharded cache) at recurrentgemma-2b's
             10/1 heads, D 256: each half of a 2048-slot ring with rows at
             kv_len 0, 1, inside and full, f32 and bf16, 1 and 4 splits,
             the state against its plain version (empty rows exact) and
             the halves merged against the contiguous kernel on the ring;
4. serve   — (a) the contiguous serving path (``launch/serve.py``:
             ``make_serve_steps`` + ``greedy_generate``) on granite-3-2b at
             full width and depth (40 layers, f32, random weights from a
             seed), batch 8, prompt 512, 32 generated tokens, once with
             ``impl="kernel"`` and once with ``impl="torch"`` fed the kernel
             run's tokens; the launch counters must read 40 ``flash_fwd`` and
             40 × 31 ``flash_decode`` launches; (b) the paged path
             (``serving.ServingEngine``, page 16, 8 slots) at full width and
             5 of the 40 layers (``PAGED_LAYERS``) on 16 seeded requests in four modes (eager; lazy on half the
             pool, which must preempt; shared 256-token system prompt with
             256-token chunked prefill; speculation k 4 on motif prompts),
             each with ``impl="kernel"`` and ``impl="torch"``: every request
             completes, ``flash_fwd`` launches 10 × prefill calls and the
             paged kernel 10 × (decode + chunk + verify calls), and the
             tokens equal the torch run's up to a printed near-tie; (c) after
             phase 4d the distributed paged engine (``ServingEngine(mesh=)``):
             two ranks on the one card with gloo (NCCL refuses two ranks
             on a device; ``--dist-ranks``, ``--dist-backend`` change
             that), recurrentgemma-2b at full width and
             3 of its 26 layers in 4d's three paged modes, ``poison_reclaimed`` in each
             (every rank keeps every recurrent state row, on its half of
             the channels, and its half of the weights and of the pools;
             out-of-window pages of the sharded pool
             reclaimed; eager with ``autotune``: rank 0's plan for one
             shard's launch, broadcast): every request completes, tokens
             equal on both ranks and to 4d's kernel run up to a printed
             near-tie, the gated kernel launched 1 × (decode + chunk calls)
             at D 256 and a GQA group of 10 on each rank, every launch at
             the mode's split count (the plan in eager, else 1), each
             rank's peak memory printed;
4d. hybrid — recurrentgemma-2b (26 layers: 18 RG-LRU, 8 local
             attention; d_model 2560, 10/1 heads, head dim 256, window 2048,
             vocab 256000) at full width and depth, f32, random weights from
             seed 0: (a) the contiguous path, batch 4, prompt 3072 (past the
             window: prefill masks, the ring rolls), 32 generated, the
             kernel run at ``launch/serve.py --autotune``'s split count
             (16 on the H100), every decode launch at it, vs the torch impl
             at one split (greedy tokens identical, logits within 1e-3 of
             max|logit|, counters 8 ``flash_fwd`` and 8 x 31
             ``flash_decode``); (b) the paged engine (page 16, 8 slots) at
             3 of the 26 layers (1 attention) on
             12 seeded requests of 1024-3072 prompt and 16-48 new tokens in
             three modes: eager with window reclaim, lazy on half the pool
             with preemption forced by a seeded storm plan and
             ``poison_reclaimed``, chunked prefill of 512: tokens equal to
             the torch impl's up to a printed near-tie, counters 1 x calls;
             prefix sharing and speculation refused; peak memory;
4e. moe    — deepseek-moe-16b (d_model 2048, 16/16 heads, head dim 128,
             64 experts top 6 and 2 shared, capacity factor 1.25, groups of
             256, vocab 102400) at full width and 7 of its 28 layers
             (``MOE_SERVE_LAYERS``), f32,
             random weights from seed 0, one set of params for both impls
             and both caches: (a) the contiguous path, batch 4, prompt 512,
             32 generated, kernel vs torch impl fed the kernel run's
             tokens, counters 14 ``flash_fwd`` and 14 x 31 ``flash_decode``;
             (b) the paged engine on 8 of (b)'s seeded requests in its four
             modes (the lazy one with a storm-forced preemption); (c)
             dbrx-132b (48/8 heads, D 128, 16 experts top 4) at full width
             and 2 layers, batch 2, prompt 256, 16 generated, counters 2 and
             2 x 15. Both impls' expert choices are recorded a layer
             (``models/moe_routes.RouteRecorder`` wraps ``models/moe.py``'s
             top-k; the model has no flag for it): at most ``MOE_FLIP_TOL`` of them may
             differ, the flips are printed with their rows, and the logits
             of the rows routed alike in every layer (capacity included)
             are held to ``LOGIT_REL_TOL``; an engine's tokens may differ
             from the first flipped call on. Prints ``moe_dropped`` at
             prefill, prefill ms, decode tokens/s, a step's time beside the
             bound of reading the weights once, peak memory;
4f. plan   — the split-KV planner (``perf/autotune.py``'s H100 record) at
             each decode geometry the serving paths launch
             (``perf/decode_split.py``: granite-3-2b contiguous and paged,
             recurrentgemma-2b contiguous, paged and gated one shard of
             two, deepseek-moe-16b paged, dbrx-132b contiguous): the plan
             must be a valid candidate; at every candidate split the
             record's cluster and resident clusters must be the launch's
             and the kernel must agree with its plain version (``TOL``
             f32, ``LSE_TOL`` for the gated state's lse); every candidate
             split's device time (cold L2) is printed beside the prediction
             and the plan's share of the best (not gated); then
             ``ServingEngine(autotune=True)`` serves phase 4b's eager
             requests: its paged-kernel launches at the planned split,
             tokens equal to 4b's up to a printed near-tie (one JSON line
             ``{"planner": ...}`` before the kernels' line);
4g. ssm    — falcon-mamba-7b (the ssm family: 64 mixer-only Mamba-1
             blocks, no attention layer, so no kernel of the port; d_model
             4096, d_inner 8192, ssm_state 16, conv 4, dt_rank 256, vocab
             65024; 7.27 B params) at full width and ``MAMBA_LAYERS`` (16)
             of its 64 layers, f32, random
             weights from seed 0: (a) the contiguous path, batch 4, prompt
             1024, 32 generated, every decode step's logits held to one
             full forward (the chunked scan) over prompt and generated
             tokens at ``LOGIT_REL_TOL``, the step-equals-scan identity;
             (b) the paged engine (page 16, 8 slots) on 8 seeded requests
             of 256-1024 prompt tokens (multiples of 256, the scan's chunk)
             and 32 new ones in three modes: eager; lazy on half the pool
             with preemption forced by a seeded storm plan and
             ``poison_reclaimed``; chunked prefill of 256: every request's
             tokens equal to (a)'s single-sequence greedy run of its prompt
             up to a printed near-tie; prefix sharing, speculation and
             ``autotune`` refused. Prints prefill ms, decode ms a step
             beside the bound of reading the weights and state rows once,
             engine tokens/s a mode, peak memory and one profiled decode
             step (busy and idle share, top kernels);
4h. vlm    — llava-next-34b (d_model 7168, 56/8 heads, head dim 128,
             d_ff 20480, vocab 64000, ``frontend_proj`` [1024, 7168]) at
             full width and ``VLM_LAYERS`` of its 60 layers, f32, random
             weights from seed 0, one set of params for both caches: (a)
             the contiguous path, batch 4, prompt 1024, 32 generated, once
             prefilled from tokens and once from patch embeddings
             (``embeds`` [4, 1024, 1024], the vision path), decoding by
             tokens; kernel impl, then torch impl fed the kernel run's
             tokens: counters 24 ``flash_fwd`` and 24 x 31
             ``flash_decode``, logits within ``LOGIT_REL_TOL``, every token
             the torch run picks otherwise a near-tie of the kernel run;
             (b) the paged engine (page 16, 8 slots) on 8 seeded requests
             of 256-1024 prompt tokens and 32 new in two modes (eager,
             chunks of 256) as phase 4b's; prints prefill ms, ms a decode
             step beside the bound of reading the weights and the cache
             once, tokens/s and peak memory;
4i. mesh serve — serving over the sharding rules (``launch/serve.py
             --mesh``: ``ShardPlan.serving``, weights tensor-parallel over
             ``model``, each rank drawing only its shard) on four gloo ranks
             sharing the card, every prefill under the prefill rules' ``seq``
             (a rank's S / model residual rows): (a) granite-3-2b at full
             width and 2 layers, contiguous on (data 2, model 2), batch 8 x
             512 + 32; (b) recurrentgemma-2b at full width and 3 layers
             (rec, rec, attn), contiguous on (model 2), batch 4 x 3072 + 16,
             its one kv head on ``kv_cache_seq`` (1024 of the ring's 2048
             slots a rank, decode through row 4's shard partials merged over
             ``model``); (d) the same on (model 4), the four ranks one mesh:
             its 10 heads do not divide 4, so the prefill runs under
             ``seq_full`` (768 query rows a rank, every head, against the
             gathered K/V, which fill the ring) and decode reads the ring
             sharded four ways (512 slots a rank); each against one card's
             run of the same weights and prompts ((d) sharing (b)'s): tokens
             equal up to a printed near-tie, the first logits within 2e-5
             of max|logit| beside the cuBLASLt floor, rows 1 and 4's
             launches a rank, the residual and query rows the prefill ran;
             (e) llava-next-34b (an FSDP config) at full width and
             ``MESH_FSDP_LAYERS`` layer, contiguous on (data 2, model 2),
             batch 2 x 512 + 8, its weights held as JAX's prefill rules lay
             them out (every embed dim over data, the rest over model, 28
             of the 56 heads a rank: G 7) and gathered at each use: tokens,
             first logits and launches as (a), each rank's weight bytes
             and one decode step's collectives by kind equal to the dry
             run's of the same cell (``launch/dryrun.trace_step`` on meta,
             in this process);
             (c) phase 4b's granite paged engine (5
             layers) on (data 2, model 2), weights sharded, first probing
             the backend's CUDA all_reduce and a page copy across shards,
             in two modes: eager, and a 256-token shared prefix with
             256-token chunks (prefix pages shared, chunk rows over the
             pool's shards): tokens equal on every rank and to 4b's
             kernel run of the mode up to a printed near-tie, the gated
             kernel launched 5 x (decode + chunk + verify calls) on each
             rank; every arm prints prefill (warm, and the process's
             first) and decode times, tokens/s a rank, the collectives' host seconds, the
             peak memory a rank, beside the card's name and power limit;
5. train   — the port's training path on granite-3-2b at full width and
             depth (f32, remat, dropout 0.1, batch 4 × 2048 from
             ``make_batch``): (a) one loss-and-grad pass with
             ``impl="kernel"`` against one with ``impl="torch"`` on the same
             params and batch, the counters reading 80 / 40 launches of
             ``flash_fwd`` / ``flash_bwd`` (forward plus recompute) and 0
             for the torch impl; (b) 4 steps of ``make_train_step`` with the
             counters reset before and read after, then one step under
             ``torch.profiler`` (device time by kernel group, busy share);
             (c) the ``Trainer`` at SMOKE size: 2 steps, a preemption, a
             resume for 2 more;
5b. hybrid — recurrentgemma-2b's training at full width and depth (f32,
             remat, dropout 0.1, batch 1 × 3072 from ``make_batch``, past
             the 2048 window; AdamW without its f32 master copy, which
             with f32 params is the same update and leaves the state in
             80 GB): (a) as 5a, with three attention leaves and one RG-LRU
             leaf, the counters reading 16 / 8 (8 attention layers, D 256);
             (b) as 5b: step time, tokens/s and peak memory, then a
             profiled step;
5c. moe    — deepseek-moe-16b's training at full width and 4 layers (f32,
             remat, dropout 0.1, batch 2 × 2048 from ``make_batch``, AdamW
             without master): (a) as 5a, the torch pass routed as the
             kernel pass was (its own flips counted, at most
             ``MOE_FLIP_TOL``), leaves wq, the router, wi and lm_head,
             counters 8 / 4; (b) 4 steps with ``moe_aux`` and
             ``moe_dropped`` each, step time, tokens/s, peak memory, then a
             profiled step;
5d. ssm    — falcon-mamba-7b's training at full width and 8 of its 64
             layers (f32, remat, batch 1 × 2048 from ``make_batch``, AdamW
             without master): 4 steps, step time, tokens/s and peak memory,
             then a profiled step; and one full-width Mamba layer (batch 1,
             S 512) whose output and input and weight gradients from the
             chunked scan are held to the sequential ``_ssm_step`` loop's
             (``MAMBA_GRAD_TOL`` of each leaf's max);
5e. enc    — hubert-xlarge's training at full size (48 layers, d_model
             1280, 16/16 heads, head dim 80, non-causal, GELU MLP, vocab
             504; f32, remat, dropout 0.1, batch 8 x 1024 frames of
             ``embeds`` from ``make_batch``, AdamW without master): as 5a
             with the attention leaves, the MLP's ``wi`` and
             ``frontend_proj``, counters 96 / 48 a pass; 4 steps, step
             time, tokens/s, peak memory, a profiled step;
5f. vlm    — llava-next-34b's training at full width and 4 layers (batch 1
             x 2048 of patch embeddings, otherwise as 5e), counters 8 / 4;
5g. mesh   — granite-3-2b trained over a mesh at full width and 2 of its 40
             layers (``MESH_TRAIN_LAYERS``, or ``--mesh-layers``; ``--only-5g``
             builds the kernels and runs this phase alone; f32, remat, dropout 0.1, batch
             4 x 2048, AdamW without master): the single-device reference
             from ``init_params(0, vocab_pad_to=2)`` (6 steps, and the
             step-0 gradients, also with cuBLASLt's GEMMs to show the f32
             noise of another order of sums); 4 gloo ranks sharing the card
             on ``--mesh 2x2`` (data 2, model 2: 16 q and 4 kv heads a rank)
             through the ``Trainer`` for 3 steps and a checkpoint, after a
             probe of ``all_gather_into_tensor`` / ``reduce_scatter_tensor``
             on CUDA tensors (values checked) and ``quantize_psum`` over
             the 4 ranks; an elastic resume on ``--mesh 2`` (2 ranks) to
             step 6, with no checkpoint at its end: the step-0 loss (1e-5) and every gathered gradient
             leaf (2e-5 of its max) against the reference, the loss
             trajectory (1e-4), each rank's launches of rows 1-3 (counters
             reset just before the Trainer; 2 x layers x steps forward, 1 x
             backward), its step times, collectives (calls, bytes, host
             seconds; a step's), peak memory; then rows 1-3 on the shard
             of rank (data 1, model 1) with its ``batch_offset`` /
             ``head_offset``: o, lse, dK, dV bit for bit against the full
             call's slice at the training shape with dropout, dQ within
             its atomics' rounding;
5h. mesh families — recurrentgemma-2b (3 layers: rec, rec, attn; batch
             2 x 3072, past the window), deepseek-moe-16b (2 layers, 2 x
             2048) and falcon-mamba-7b (2 layers, 2 x 2048) at full width,
             f32, remat, dropout 0.1, AdamW without master, each trained on
             4 gloo ranks sharing the card (data 2, model 2; one launch for
             the three): rank 0's single-device run of the same state
             first (the step-0 gradients, also with cuBLASLt's GEMMs, and
             ``MESH_FAMILY_STEPS`` steps), then every rank's step-0
             gradients (the MoE replaying rank 0's routes, each rank its
             groups) against it shard by shard, then ``MESH_FAMILY_STEPS``
             steps with the counters reset just before them: the step-0
             loss (1e-5), every gradient leaf (2e-5 of its max) beside the
             cuBLASLt floor, the MoE's routing flips (1e-3), the losses
             (1e-4), each rank's launches of rows 1-3, step times,
             collectives, peak memory; then rows 1-3 on the shards of the
             ranks at data index 1 at rg's (5/1 heads a rank, G 5, D 256,
             window 2048) and deepseek's (8/8 heads a rank, D 128) training
             shapes with their offsets (``mesh_offsets_check``); 5g's and
             5h's ranks run under ``seq`` (1024 or 1536 residual rows a
             rank, printed);
5i. mesh ctx — context parallelism in training: recurrentgemma-2b as 5h
             trains it (3 layers, 2 x 3072, full width, f32, remat,
             dropout 0.1) on 4 gloo ranks sharing the card over (model 4)
             (``--only-5i`` builds the kernels and runs this phase alone):
             the 10 q heads do not divide 4, so attention runs under
             ``seq_full``, every head on a rank's 768 query rows against
             the whole sequence's K/V cut to the rows' end; its ranks run
             in 5h's launch on 5h's rank-0 reference of rg (the same state
             and batch): the step-0 loss (1e-5),
             every gradient leaf (2e-5 of its max) beside the cuBLASLt
             floor, 2 steps' losses (1e-4), each rank's launches of rows
             1-3 and the query rows each launch saw, its residual rows,
             step times, collectives and peak memory; then rows 1-3 on the
             four query shards at that shape against the full call (o and
             lse bit for bit, dQ within its atomics' rounding, the shards'
             dK/dV summed within ``BWD_TOL``) and the last shard's times
             beside SDPA with the lower-right causal window as a mask (two
             more rows in phase 6);
6. times   — each kernel at its path's shapes beside its plain version, one
             PyTorch library call computing the same function
             (``scaled_dot_product_attention`` forward, or its whole
             backward for the fused backward kernel, in f32 and in bf16 at
             the training shape; on the contiguous equivalent for the
             paged decode, gather excluded; aten's memory-efficient attention
             with its log-sum-exp on the owned rows for the gated kernel: a
             yardstick the port never calls) and its bound at the tensor-core
             peak of its dtype (beside the bound without tensor cores),
             printed as one JSON line; the forward's row also carries,
             from ``perf/fwd_times.py``, its device time alone
             (``torch.profiler``), events time, SDPA's time in the same
             dtype and the bounds (TF32 and 3xTF32 for f32) at the
             prefill and training shapes in f32 and bf16 and at the
             training shape with dropout 0.1 (``times_by_case``); the
             decode kernels' rows also carry
             ``device_ms`` (the kernel alone, cold L2) and ``host_us`` (a
             wrapper call) from ``perf/decode_times.py``, at the decode
             shape and (``<shape>_shape_``) at the chunk, at decode with 32
             and 64 slots and at verify (8 slots of 5 token rows); three
             more rows hold rows 1, 4 and 5 at recurrentgemma-2b's prefill,
             decode and paged decode (and 512-token chunk) shapes, and one
             rows 2-3 at its training shape (B 1, S 3072, f32 and bf16),
             with SDPA given the window as a mask; five more hold rows 1-5
             at deepseek-moe-16b's shapes (16/16 heads, D 128) in f32 and
             bf16 (``bf16_``): the prefill (B 4, S 512) and training (B 2,
             S 2048, dropout 0.1) forward, the backward at training, the
             decode (B 4, 544 slots) and the paged decode (8 slots), the
             forward and decode also at dbrx-132b's (``dbrx_shape_``); and
             row 6 at recurrentgemma-2b's engine decode, one shard of two
             (8 slots, D 256, G 10, window 2048, page 16), with its device
             and host time and rank 0's launches of phase 4c, and row 4's
             shard-partials mode at phase 4i(b)'s decode (one shard of two
             of the 2048-slot ring, B 4, D 256, G 10) with rank 0's
             launches there; six more hold
             rows 1 and 2-3 at hubert-xlarge's training shape (B 8, 16/16
             heads, S 1024, D 80, non-causal, dropout 0.1; SDPA with
             ``is_causal`` False) and rows 1 (``train_shape_``: B 1, S 2048,
             dropout 0.1), 2-3, 4 and 5 at llava-next-34b's prefill (B 4,
             56/8 heads, S 1024), training, decode (B 4, 1040 of 1056
             slots) and paged decode (8 slots, kv_len 256-1056) shapes, in
             f32 and bf16 (``bf16_``).

After each phase a ``[clock]`` line gives the seconds since phase 1 began
and the phase's own. Autotuned plans persist in ``build/autotune.json``
(``REPRO_TORCH_AUTOTUNE_CACHE``; an entry of another card or record is a
miss). The last line is ``{"ok": true, "device": {...}}``. Without a CUDA device,
or outside a checkout, it exits non-zero before printing any result.

``python3 chip_smoke.py --dist-ranks 4 --dist-backend nccl`` on a machine
with four cards gives phases 4c and 4i a card a rank and NCCL; every other
phase runs on ``cuda:0`` as without the flags.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# The card's published peaks live in src/repro_torch/perf/roofline.py (H100
# SXM, NVIDIA data sheet, dense): device memory 3.35 TB/s (HBM_BYTES_PER_S);
# tensor cores 495 TFLOP/s TF32 (the f32 rows: an f32 product on tensor
# cores goes through TF32) and 989 TFLOP/s bf16 (PEAK_FLOPS); 67 TFLOP/s
# float32 without tensor cores (PEAK_FLOPS_NO_TENSOR_CORES), kept beside each
# bound as ``bound_ms_no_tensor_cores``. main() binds the three names once
# the checkout's src/ is on the path.
HBM_BYTES_PER_S = PEAK_FLOPS = PEAK_FLOPS_NO_TENSOR_CORES = None

# kernel vs plain version on the same inputs (module docstrings of
# kernels/flash_fwd.py and kernels/decode.py): both compute in f32 and fold
# the same tiles, so they differ only in the order of f32 sums.
TOL = {
    # the JAX suite's f32 attention tolerance (tests/test_kernel_fwd.py)
    "float32": 2e-5,
    # two bf16 ulps at |o| <= 1: both sides round P and o to bf16, and a
    # probability that lands on the other side of a rounding boundary moves
    # o by about one ulp
    "bfloat16": 2.0 ** -6,
}
LSE_TOL = 1e-4       # f32 lse ~ log(Skv) + max score ~ 10: ten f32 ulps there
# serving path kernel vs torch impl: 40 layers of f32 with differently
# ordered sums (kernel tiles vs cuBLAS / chunked torch) move logits by ~1e-6
# relative; 1e-3 of the largest logit leaves room for that and still catches
# a kernel that is wrong anywhere on the path
LOGIT_REL_TOL = 1e-3
# backward kernel vs plain version, relative to max(1, max|plain|): f32 the
# JAX suite's gradient tolerance (dK and dV sum over up to 2048 q rows and a
# group of 4 in another order); bf16 inputs or bf16-ACC two bf16 ulps (P~,
# dS, the tile products and the outputs are rounded to bf16 on both sides)
BWD_TOL = {"float32": 5e-5, "bfloat16": 2.0 ** -6}
# training pass kernel vs torch impl on one state and batch (40 layers of
# f32 with sums in another order): loss relative, global grad norm relative,
# and selected leaves relative to each leaf's max
TRAIN_TOL = {"loss": 1e-5, "grad_norm": 1e-4, "leaf": 1e-3}
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 2048, 4
TRAIN_LEAVES = ("blocks.0.mixer.wq", "blocks.0.mixer.wk", "blocks.0.mixer.wv",
                "lm_head")
# phase 5b, recurrentgemma-2b: batch 1 x 3072 (past the 2048 window); the
# leaves of its first attention layer (layer 2) and of its first RG-LRU
HYBRID_BATCH, HYBRID_SEQ = 1, 3072
HYBRID_LEAVES = ("blocks.2.mixer.wq", "blocks.2.mixer.wk", "blocks.2.mixer.wv",
                 "blocks.0.mixer.w_rec")
# phase 5c, deepseek-moe-16b at full width and 4 layers: batch 2 x 2048
MOE_TRAIN_LAYERS, MOE_TRAIN_BATCH, MOE_TRAIN_SEQ = 4, 2, 2048
# granite-3-2b's paged phases (4b, its ranks in 4c, 4f's autotuned engine)
# at full width and 5 of its 40 layers: these three share one reference,
# so they are cut together, first to 20 (with phase 4c's hybrid and phase
# 4f the run had passed 860 s on a slow host), then to 10 (phase 5g took
# the run past 1000 s), then to 5 (phase 5h took it to 987 s; PERF.md)
PAGED_LAYERS = 5
MOE_LEAVES = ("blocks.0.mixer.wq", "blocks.0.mlp.router", "blocks.0.mlp.wi",
              "lm_head")
# phase 4g, falcon-mamba-7b at full width and MAMBA_LAYERS of its 64 layers
# (at 64 layers, 80 s of the run, the run with phases 4h, 5e and 5f reached
# 991.5 s: cut to 32, as granite's paged phases were; to 16 for phase 5h;
# PERF.md §4): contiguous
# batch 4 x (1024 + 32); the paged engine on 8 requests of 256-1024 prompt
# tokens, 32 new each. Every scan length is a multiple of the 256-token
# chunk (a length that is not is scanned as one chunk: 1 GiB an operand
# for a 2048-token row at this width)
MAMBA_LAYERS = 16
MAMBA_BATCH, MAMBA_PROMPT, MAMBA_GEN, MAMBA_REQUESTS = 4, 1024, 32, 8
MAMBA_MODES = {
    # name: (engine kwargs beyond page 16 and 8 slots, prefill row length
    # (a multiple of 256), half the pool)
    "eager": ({}, MAMBA_PROMPT, False),
    # a preempted row re-prefills prompt + generated (up to 1055 tokens)
    "lazy": ({"lazy": True, "poison_reclaimed": True,
              "fault_plan": dict(seed=3, horizon=40, events_per_kind=3,
                                 kinds=("storm",))},
             1280, True),
    "chunk_256": ({"prefill_chunk": 256}, 256, False),
}
# phase 5d, falcon-mamba-7b at full width and 8 layers: batch 1 x 2048; the
# scan-vs-step check of one layer at batch 1 x 512 holds the output and
# every gradient leaf to the JAX suite's f32 gradient tolerance of the
# leaf's max
MAMBA_TRAIN_LAYERS, MAMBA_TRAIN_BATCH, MAMBA_TRAIN_SEQ = 8, 1, 2048
MAMBA_CHECK_SEQ, MAMBA_GRAD_TOL = 512, 5e-5
# phase 4h, llava-next-34b at full width and VLM_LAYERS of its 60 layers (f32:
# 57 GB of weights at 24 layers, its depth before phase 5h; the 60-layer f32
# model, ~138 GB, does not fit one card): contiguous batch 4 x (1024 + 32), by tokens and from patch
# embeddings; the paged engine on 8 requests of 256-1024 prompt tokens, 32
# new each, eager and in chunks of 256
VLM_LAYERS, VLM_BATCH, VLM_PROMPT, VLM_GEN, VLM_REQUESTS = 12, 4, 1024, 32, 8
VLM_MODES = {
    # name: (engine kwargs beyond page 16 and 8 slots, prefill row length)
    "eager": ({}, VLM_PROMPT),
    "chunk_256": ({"prefill_chunk": 256}, 256),
}
# phase 5f, llava-next-34b at full width and 4 layers: batch 1 x 2048 of
# patch embeddings
VLM_TRAIN_LAYERS = 4
ENC_LEAVES = ("blocks.0.mixer.wq", "blocks.0.mixer.wk", "blocks.0.mixer.wv",
              "blocks.0.mlp.wi", "frontend_proj", "lm_head")
VLM_LEAVES = ("blocks.0.mixer.wq", "blocks.0.mixer.wk", "blocks.0.mlp.wi",
              "frontend_proj", "lm_head")
# the training phases: arch → (tag, batch, seq, leaves checked, AdamW's f32
# master copy, layers (None: the config's))
TRAIN_SETUPS = {
    "granite_3_2b": ("[train]", TRAIN_BATCH, TRAIN_SEQ, TRAIN_LEAVES, True,
                     None),
    # 3.55 B f32 params, grads, m and v are 56.8 GB; a master copy of f32
    # params (the same update) would add 14.2 GB
    "recurrentgemma_2b": ("[hybrid train]", HYBRID_BATCH, HYBRID_SEQ,
                          HYBRID_LEAVES, False, None),
    "deepseek_moe_16b": ("[moe train]", MOE_TRAIN_BATCH, MOE_TRAIN_SEQ,
                         MOE_LEAVES, False, MOE_TRAIN_LAYERS),
    # phase 5e, hubert-xlarge at full size (0.95 B params): batch 8 x 1024
    # frames of embeddings, attention non-causal at head dim 80
    "hubert_xlarge": ("[enc train]", 8, 1024, ENC_LEAVES, False, None),
    "llava_next_34b": ("[vlm train]", 1, 2048, VLM_LEAVES, False,
                       VLM_TRAIN_LAYERS),                               # 5f
}


# phase 5g, training over a mesh: granite-3-2b at full width and
# MESH_TRAIN_LAYERS of its 40 layers, batch 4 x 2048, f32, dropout 0.1,
# AdamW without a master copy: the single-device reference (vocab padded to
# the model axis, 49156), then 4 gloo ranks sharing the card on (data 2,
# model 2) for MESH_STEPS steps and a checkpoint, then 2 ranks on (model 2)
# resuming it to step MESH_RESUME_STEPS. The first step's loss 1e-5
# relative, every gathered gradient leaf MESH_LEAF_TOL of its max |g|, the
# trajectory 1e-4 (the CPU suite's, tests/test_torch_mesh_train.py)
MESH_TRAIN_LAYERS, MESH_BATCH, MESH_SEQ = 2, 4, 2048
MESH_SHAPE, MESH_RESUME_SHAPE = {"data": 2, "model": 2}, {"model": 2}
MESH_STEPS, MESH_RESUME_STEPS = 3, 6
MESH_LEAF_TOL, MESH_TRAJ_TOL = 2e-5, 1e-4
# phase 5h, the hybrid, MoE and ssm families trained over a mesh: each at
# full width and reduced depth, f32, remat, dropout 0.1, AdamW without a
# master copy, on 4 gloo ranks sharing the card (MESH_SHAPE), the three in
# one run_ranks launch: arch -> (layers, batch, seq). recurrentgemma-2b's
# 3 layers are rec, rec, attn and its rows run past the 2048 window; each
# rank of 4 holds ~0.8 B params of rg and of deepseek (the vocab over
# model, the experts 32 a rank), 12.5-12.8 GB with grads, m and v
MESH_FAMILIES = {"recurrentgemma_2b": (3, 2, 3072),
                 "deepseek_moe_16b": (2, 2, 2048),
                 "falcon_mamba_7b": (2, 2, 2048)}
MESH_FAMILY_STEPS = 2
# phase 5i, context parallelism in training: recurrentgemma-2b as phase 5h
# trains it (MESH_FAMILIES: 3 layers, 2 x 3072, f32, remat, dropout 0.1) on
# 4 gloo ranks sharing the card over (model 4): its 10 q heads do not
# divide 4, so the rules' seq_full splits attention's query rows, 768 a
# rank, every head a rank against the whole sequence's K/V
MESH_CTX_SHAPE = {"model": 4}
MESH_CTX_ARCH = "recurrentgemma_2b"
# rows 1-3 on the shards of data index 1 at each family's training shape:
# (b, hq, hkv, s, d, window, batch rows)
MESH_FAMILY_SHARDS = {
    # 5 q heads a rank over the one replicated kv head: G 5, D 256
    "recurrentgemma_2b": (2, 10, 1, 3072, 256, 2048, (1, 2)),
    # 8 q and 8 kv heads a rank: G 1, D 128
    "deepseek_moe_16b": (2, 16, 16, 2048, 128, None, (1, 2)),
}

# phase 4i, serving over the sharding rules (launch/serve.py --mesh): 4 gloo
# ranks sharing the card. arch -> (layers, batch, prompt, new tokens, mesh):
# granite-3-2b at full width and 2 layers (the depth where phase 5g's mesh
# clears the f32 gate), contiguous on (data 2, model 2); recurrentgemma-2b
# at full width and 3 layers (rec, rec, attn), 4 x 3072 past its 2048-slot
# ring, on (model 2), each data row's two ranks a mesh of their own: its one
# kv head takes kv_cache_seq, 1024 slots a rank. Then phase 4b's granite
# paged engine (PAGED_LAYERS) on (data 2, model 2) in MESH_PAGED_MODES, its
# weights sharded (phase 4c's granite arm, folded in here)
# (d) recurrentgemma-2b as (b) on (model 4), the four ranks one mesh: its 10
# heads do not divide 4, so the prefill runs under seq_full (768 query rows
# a rank) and decode reads the ring sharded four ways, 512 slots a rank.
# arm -> (arch, layers, batch, prompt, new tokens, mesh)
MESH_SERVE_SHAPE = {"data": 2, "model": 2}
# (e) llava-next-34b, an FSDP config, at full width and MESH_FSDP_LAYERS
# layer on (data 2, model 2): the weights under the prefill rules, every
# embed dim over data (1.48 GB a rank of the 5.93 GB model), gathered at
# each use; its bytes and a decode step's collectives held to the dry run
MESH_FSDP_LAYERS = 1
MESH_FSDP_ARM = "llava_next_34b fsdp"
MESH_SERVE = {"granite_3_2b": ("granite_3_2b", 2, 8, 512, 32, MESH_SERVE_SHAPE),
              "recurrentgemma_2b": ("recurrentgemma_2b", 3, 4, 3072, 16,
                                    {"model": 2}),
              "recurrentgemma_2b model 4": ("recurrentgemma_2b", 3, 4, 3072,
                                            16, {"model": 4}),
              MESH_FSDP_ARM: ("llava_next_34b", MESH_FSDP_LAYERS, 2, 512, 8,
                              MESH_SERVE_SHAPE)}
# the first step's logits of a mesh against one card, of max|logit|: the
# kernels' f32 tolerance
MESH_SERVE_LOGIT_TOL = 2e-5


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0 or not out.stdout.strip():
        fail(f"nvidia-smi failed ({out.returncode}): {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def main(argv=None) -> None:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dist-ranks", type=int, default=DIST_RANKS,
                    help="ranks of phase 4c (rank r on cuda:(r %% cards))")
    ap.add_argument("--dist-backend", default="gloo", choices=("gloo", "nccl"),
                    help="phase 4c's backend: gloo for ranks sharing a card, "
                         "nccl for a card a rank")
    ap.add_argument("--mesh-layers", type=int, default=MESH_TRAIN_LAYERS,
                    help="granite's depth in phase 5g")
    ap.add_argument("--only-5g", action="store_true",
                    help="build the kernels, run phase 5g alone and print no "
                         "result line")
    ap.add_argument("--only-5i", action="store_true",
                    help="build the kernels, run phase 5i alone and print no "
                         "result line")
    ap.add_argument("--only-4i", action="store_true",
                    help="build the kernels, run row 4's shard-partials "
                         "checks, phase 4b (its reference) and phase 4i, and "
                         "print no result line")
    args = ap.parse_args(argv)
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        fail("src/repro_torch not found next to chip_smoke.py: run it from "
             "the root of a checkout")
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    global HBM_BYTES_PER_S, PEAK_FLOPS, PEAK_FLOPS_NO_TENSOR_CORES
    from repro_torch.perf.roofline import HBM_BW as HBM_BYTES_PER_S
    from repro_torch.perf.roofline import (PEAK_FLOPS,
                                           PEAK_FLOPS_NO_TENSOR_CORES)

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a card")

    # autotuned plans persist inside the checkout (ranks inherit this)
    from repro_torch.perf.autotune import CACHE_ENV
    os.environ[CACHE_ENV] = str(ROOT / "build" / "autotune.json")
    t_start = time.perf_counter()

    def clock(phase: str) -> None:
        now = time.perf_counter() - t_start
        print(f"[clock] {phase} done at {now:.1f} s ({now - clock.last:.1f} s)",
              flush=True)
        clock.last = now
    clock.last = 0.0

    # ---------------- phase 1: device ----------------
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = nvidia_smi_line()
    print(f"[device] {name}; count {count}; torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    print(smi, flush=True)
    # f32 products in full f32: the plain versions and the model's
    # projections must not drop to TF32 (about three decimal digits)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("[device] torch.backends.cuda.matmul.allow_tf32 = False, "
          "torch.backends.cudnn.allow_tf32 = False")

    from repro_torch.kernels import _build
    from repro_torch.kernels import decode as kdecode
    from repro_torch.kernels import flash_bwd as kbwd
    from repro_torch.kernels import flash_fwd as kfwd

    # ---------------- phase 2: build ----------------
    t0 = time.perf_counter()
    _build.build(_build.KERNELS)
    print(f"[build] nvcc {' '.join(_build.NVCC_FLAGS)}: "
          f"{time.perf_counter() - t0:.1f} s")
    build_report(_build)
    clock("phase 2 (build)")
    if args.only_5g:
        mesh_train_phase(torch, kfwd, kbwd, smi, args.mesh_layers)
        clock(f"phase 5g at {args.mesh_layers} layers, alone")
        return
    if args.only_5i:
        mesh_ctx_phase(torch, kfwd, kbwd, smi)
        clock("phase 5i, alone")
        return
    if args.only_4i:
        errs = shard_partials_kernel_phase(torch, kdecode)
        _, paged_tokens = paged_serve_phase(torch, kfwd, kdecode)
        clock("phase 4b")
        mesh_serve = mesh_serve_phase(torch, paged_tokens, args.dist_backend, smi)
        clock("phase 4i")
        shard_partials_times_phase(torch, kdecode, mesh_serve, errs)
        return

    # ---------------- phase 3: kernels vs plain versions ----------------
    errs = kernel_phase(torch, kfwd, kdecode)
    errs.update(paged_kernel_phase(torch, kdecode))
    errs.update(gated_kernel_phase(torch, kdecode))
    errs.update(shard_partials_kernel_phase(torch, kdecode))
    errs.update(bwd_kernel_phase(torch, kfwd, kbwd))
    clock("phase 3 (kernels vs plain versions)")

    # ---------------- phase 4: the serving paths ----------------
    launches = serve_phase(torch, kfwd, kdecode)
    paged_launches, paged_tokens = paged_serve_phase(torch, kfwd, kdecode)
    clock("phases 4 and 4b (granite-3-2b contiguous and paged)")

    # ---------------- phase 4d: the hybrid recurrentgemma-2b ----------------
    torch.cuda.reset_peak_memory_stats()
    hybrid_launches = serve_phase(torch, kfwd, kdecode, "recurrentgemma_2b",
                                  batch=4, prompt_len=3072, gen_len=32,
                                  tag="hybrid", autotune=True)
    hybrid_paged, hybrid_tokens = hybrid_paged_phase(torch, kfwd, kdecode)
    print(f"[hybrid] peak max_memory_allocated over phase 4d "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    clock("phase 4d (recurrentgemma-2b contiguous and paged)")
    # phase 4c for the hybrid: its paged engine over the ranks
    hybrid_dist = dist_serve_phase(torch, hybrid_tokens, args.dist_ranks,
                                   args.dist_backend)
    clock("phase 4c (recurrentgemma-2b over the ranks)")

    # ---------------- phase 4e: the MoE family ----------------
    moe_serve = moe_serve_phase(torch, kfwd, kdecode)
    clock("phase 4e (the MoE family)")

    # ---------------- phase 4f: the decode planner ----------------
    plans = planner_phase(torch, kfwd, kdecode, paged_tokens)
    clock("phase 4f (the decode planner)")

    # ---------------- phase 4g: the ssm family ----------------
    mamba_serve_phase(torch)
    clock("phase 4g (falcon-mamba-7b contiguous and paged)")

    # ---------------- phase 4h: the vlm family ----------------
    vlm_serve = vlm_serve_phase(torch, kfwd, kdecode)
    clock("phase 4h (llava-next-34b contiguous and paged)")

    # ---------------- phase 4i: serving over the sharding rules ----------------
    mesh_serve = mesh_serve_phase(torch, paged_tokens, args.dist_backend, smi)
    clock("phase 4i (serving over the sharding rules)")

    # ---------------- phase 5: the training path ----------------
    train_launches = train_phase(torch, kfwd, kbwd)
    hybrid_train = train_phase(torch, kfwd, kbwd, "recurrentgemma_2b")
    moe_train = train_phase(torch, kfwd, kbwd, "deepseek_moe_16b")      # 5c
    clock("phase 5 (training)")
    mamba_train_phase(torch)                                            # 5d
    clock("phase 5d (falcon-mamba-7b training)")
    enc_train = train_phase(torch, kfwd, kbwd, "hubert_xlarge")         # 5e
    clock("phase 5e (hubert-xlarge training)")
    vlm_train = train_phase(torch, kfwd, kbwd, "llava_next_34b")        # 5f
    clock("phase 5f (llava-next-34b training)")
    mesh_train = mesh_train_phase(torch, kfwd, kbwd, smi, args.mesh_layers)  # 5g
    clock("phase 5g (granite-3-2b over a mesh)")
    mesh_families, ctx_group = mesh_families_phase(torch, kfwd, kbwd, smi)  # 5h
    clock("phase 5h (the hybrid, MoE and ssm families over a mesh, and 5i's "
          "ranks)")
    mesh_ctx = mesh_ctx_phase(torch, kfwd, kbwd, smi, ctx_group)        # 5i
    clock("phase 5i (context parallelism in training)")

    # ---------------- phase 6: times ----------------
    rows = times_phase(torch, kfwd, kdecode, launches, errs)
    rows.append(bwd_times_phase(torch, kfwd, kbwd, train_launches, rows[0]))
    fwd_times_phase(rows[0])
    rows.append(paged_times_phase(torch, kdecode, paged_launches, errs))
    rows.append(gated_times_phase(torch, kdecode, mesh_serve["paged"], errs))
    device_times_phase(rows)
    rows.append(hybrid_gated_times_phase(torch, kdecode, hybrid_dist))
    rows.append(shard_partials_times_phase(torch, kdecode, mesh_serve, errs))
    rows[0]["launches_by_path"]["paged_serve"] = paged_launches["flash_fwd"]
    rows += hybrid_times_phase(torch, kfwd, kdecode, hybrid_launches,
                               hybrid_paged, hybrid_train, errs)
    rows.append(hybrid_bwd_times_phase(torch, kfwd, kbwd, hybrid_train))
    rows += moe_times_phase(torch, kfwd, kbwd, kdecode, moe_serve, moe_train)
    rows += frontend_times_phase(torch, kfwd, kbwd, kdecode, vlm_serve,
                                 enc_train, vlm_train)
    rows += mesh_ctx["rows"]
    for row in rows:           # phase 4i's launches a rank of rows 1 and 4
        if row["name"] in ("flash_fwd", "flash_decode"):
            row.setdefault("launches_by_path", {})["mesh_serve_by_rank"] = \
                mesh_serve["by_rank"][row["name"]]
    for row in rows:           # the forward's and the backward's granite rows
        if row["name"] in ("flash_fwd", "flash_bwd"):
            row.setdefault("launches_by_path", {})["mesh_train_by_rank"] = [
                r[row["name"]] for r in mesh_train]
            row["launches_by_path"]["mesh_families_by_rank"] = {
                arch: [r[row["name"]] for r in group]
                for arch, group in mesh_families.items() if group[0][row["name"]]}
            row["launches_by_path"]["mesh_ctx_by_rank"] = [
                r[row["name"]] for r in mesh_ctx["ranks"]]
    clock("phase 6 (times)")
    print(json.dumps({"planner": plans}))
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))


def bounds(flops: float, nbytes: float, dtype: str = "float32") -> dict:
    """The least time the card could take for ``flops`` operations on
    ``nbytes`` bytes: the larger of bytes over the memory rate and operations
    over the tensor-core peak of ``dtype`` (``bound_ms``), and the same at
    the f32 rate without tensor cores (``bound_ms_no_tensor_cores``)."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_tc = flops / PEAK_FLOPS[dtype]
    t_cc = flops / PEAK_FLOPS_NO_TENSOR_CORES
    return {"bound_ms": max(t_tc, t_bytes) * 1e3,
            "bound_by": "operations" if t_tc > t_bytes else "bytes",
            "bound_ms_no_tensor_cores": max(t_cc, t_bytes) * 1e3}


# the backward instantiations of the training paths that must not spill:
# granite (D 64), hubert-xlarge (D 80) and recurrentgemma-2b (D 256)
BWD_TRAIN = ("flash_bwd_kernel<f32, D64>", "flash_bwd_kernel<bf16, D64>",
             "flash_bwd_kernel<f32, D80>", "flash_bwd_kernel<bf16, D80>",
             "flash_bwd_kernel<f32, D256>", "flash_bwd_kernel<bf16, D256>")


def build_report(_build) -> None:
    """ptxas's registers and spills per kernel instantiation, and the
    tensor-core instructions of the forward and backward kernels; fails if
    a forward instantiation or an f32 or bf16 D=64, D=80 or D=256 backward
    kernel (the training paths') spills or has none."""
    import re
    for kname in _build.KERNELS:
        report = _build.ptxas_report.get(kname)
        if report is None:
            print(f"[build] {kname}: (already built)")
            continue
        entry, spills = None, ""
        for line in report.splitlines():
            if "Compiling entry" in line:
                m = re.search(r"\d+([a-z_]+_kernel)I(f|13__nv_bfloat16)Li(\d+)E"
                              r"(?:Lb([01]))?", line)
                entry = (f"{m.group(1)}<{'f32' if m.group(2) == 'f' else 'bf16'}, "
                         f"D{m.group(3)}{', acc bf16' if m.group(4) == '1' else ''}"
                         f"{', paged' if 'PagedCache' in line else ''}"
                         f"{', query tiles' if 'ELb1EEEvNS_12Decode' in line else ''}>"
                         if m else line.split("'")[1][:60])
                continue
            if "spill" in line:
                spills = line.strip()
                n = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                              spills)
                if ((entry in BWD_TRAIN or str(entry).startswith("fwd_kernel"))
                        and (n is None or n.groups() != ("0", "0"))):
                    fail(f"{kname} {entry} spills: {spills}")
                continue
            if "registers" in line:
                regs = line.split(":", 1)[-1].strip()
                print(f"[build] {kname} {entry}: {regs}; {spills}")
    mma = tensor_core_instructions(_build, "flash_bwd")
    fwd = tensor_core_instructions(_build, "flash_fwd")
    want = [*BWD_TRAIN,
            *(f"fwd_kernel<{t}, D{d}{acc}>" for t in ("f32", "bf16")
              for d in (16, 32, 64, 80, 128, 256) for acc in ("", ", acc bf16"))]
    for entry in want:
        n = mma.get(entry, fwd.get(entry, 0))
        print(f"[build] {entry}: {n} tensor-core instructions (HMMA / HGMMA in "
              f"cuobjdump -sass)")
        if not n:
            fail(f"{entry} has no tensor-core instruction")
    sys.stdout.flush()


def tensor_core_instructions(_build, kname: str) -> dict:
    """{"flash_bwd_kernel<f32, D64>": count, ...}: HMMA and HGMMA lines per
    kernel instantiation in ``cuobjdump -sass`` of library ``kname``."""
    import re
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    lib = _build.build([kname])[kname]
    out = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                         text=True, timeout=300)
    if out.returncode != 0:
        fail(f"cuobjdump -sass failed ({out.returncode}): {out.stderr[:500]}")
    counts = {}
    for part in out.stdout.split("Function : ")[1:]:
        m = re.match(r"\S*?\d+([a-z_]+_kernel)I(f|13__nv_bfloat16)Li(\d+)ELb([01])E", part)
        if m:
            name = (f"{m.group(1)}<{'f32' if m.group(2) == 'f' else 'bf16'}, "
                    f"D{m.group(3)}{', acc bf16' if m.group(4) == '1' else ''}>")
            counts[name] = sum("HMMA" in ln or "HGMMA" in ln
                               for ln in part.splitlines())
    return counts


def _rand(torch, gen, shape, dtype):
    return torch.randn(shape, generator=gen, device="cuda",
                       dtype=torch.float32).to(dtype)


def _fwd_inputs(torch, gen, b, hq, hkv, sq, skv, d, dtype):
    return (_rand(torch, gen, (b, hq, sq, d), dtype),
            _rand(torch, gen, (b, hkv, skv, d), dtype),
            _rand(torch, gen, (b, hkv, skv, d), dtype))


def _segments(torch, b, skv):
    """Four packed sequences per row of unequal length, then padding (-1)."""
    seg = torch.full((b, skv), -1, dtype=torch.int32, device="cuda")
    bounds = [0, skv // 5, skv // 2, 3 * skv // 4, skv - skv // 16]
    for i in range(4):
        seg[:, bounds[i]:bounds[i + 1]] = i
    return seg


def _maxerr(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def kernel_phase(torch, kfwd, kdecode):
    """Every case in f32 and bf16; returns {case: max |kernel - plain|}."""
    from repro_torch.kernels import ops, ref

    print("[kernels] tolerances, kernel vs plain version on the same inputs: "
          f"f32 {TOL['float32']:.0e} (the JAX suite's f32 attention "
          "tolerance; both sides compute in f32 over the same tiles and "
          f"differ only in the order of sums); bf16 {TOL['bfloat16']:.2e} "
          "(two bf16 ulps at |o| <= 1: both sides round P and o to bf16); "
          f"lse {LSE_TOL:.0e} (ten f32 ulps at lse ~ 10)")
    gen = torch.Generator(device="cuda").manual_seed(1234)
    fwd_cases = [
        # name, b, hq, hkv, sq, skv, d, extra kwargs
        ("prefill_s512", 8, 32, 8, 512, 512, 64, dict(causal=True)),
        ("prefill_s2048", 8, 32, 8, 2048, 2048, 64, dict(causal=True)),
        ("window_128", 8, 32, 8, 512, 512, 64, dict(causal=True, window=128)),
        ("segments", 8, 32, 8, 512, 512, 64, dict(causal=True, segments=True)),
        ("dropout_0.1", 8, 32, 8, 512, 512, 64,
         dict(causal=True, dropout_rate=0.1, dropout_seed=-7)),
        ("ragged_500", 8, 32, 8, 500, 500, 64, dict(causal=True)),
        ("q_suffix_200_of_500", 8, 32, 8, 200, 500, 64, dict(causal=True)),
        ("d128_gqa5", 8, 40, 8, 512, 512, 128, dict(causal=True)),
        # recurrentgemma-2b's attention (10/1 heads, D 256, window 2048): a
        # prefill past the window, whole tiles behind every row's window
        ("rg_s3072_window2048", 2, 10, 1, 3072, 3072, 256,
         dict(causal=True, window=2048)),
        ("rg_segments_ragged_1000", 2, 10, 1, 1000, 1000, 256,
         dict(causal=True, window=2048, segments=True)),
        # the MoE family at D 128: deepseek-moe-16b's 16/16 heads at prefill
        # and in training, dbrx-132b's 48/8 heads at prefill
        ("moe_prefill_g1_d128", 4, 16, 16, 512, 512, 128, dict(causal=True)),
        ("moe_train_g1_d128_dropout_0.1", 2, 16, 16, 2048, 2048, 128,
         dict(causal=True, dropout_rate=0.1, dropout_seed=-9)),
        ("dbrx_prefill_g6_d128", 2, 48, 8, 256, 256, 128, dict(causal=True)),
        # hubert-xlarge's training geometry (16/16 heads, D 80, non-causal),
        # with dropout 0.1, segments and q a ragged suffix of a longer kv
        ("hubert_train_d80", 8, 16, 16, 1024, 1024, 80, {}),
        ("hubert_d80_dropout_0.1", 8, 16, 16, 1024, 1024, 80,
         dict(dropout_rate=0.1, dropout_seed=-13)),
        ("hubert_d80_segments", 8, 16, 16, 1024, 1024, 80, dict(segments=True)),
        ("hubert_d80_q_suffix_300_of_1000", 8, 16, 16, 300, 1000, 80, {}),
        # the non-causal path apart from the head dim: granite's training
        # geometry without the causal mask
        ("granite_train_non_causal_d64", 4, 32, 8, 2048, 2048, 64, {}),
        # llava-next-34b's prefill: 56/8 heads, a GQA group of 7, D 128
        ("llava_prefill_g7_d128", 4, 56, 8, 1024, 1024, 128, dict(causal=True)),
    ]
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[-1]
        for name, b, hq, hkv, sq, skv, d, kw in fwd_cases:
            kw = dict(kw)
            q, k, v = _fwd_inputs(torch, gen, b, hq, hkv, sq, skv, d, dtype)
            if kw.pop("segments", False):
                kw["segment_ids"] = _segments(torch, b, skv)
            o, lse = kfwd.flash_fwd(q, k, v, **kw)
            torch.cuda.synchronize()
            o_ref, lse_ref = kfwd.flash_fwd_torch(q, k, v, **kw)
            e, el = _maxerr(o, o_ref), _maxerr(lse, lse_ref)
            if dtype == torch.float32 and name.startswith(("hubert", "llava")):
                print(f"[kernels] flash_fwd {name}: {-(-sq // 64)} q tiles x {hq} "
                      f"heads x {b} = {-(-sq // 64) * hq * b} blocks of 4 warps, "
                      f"{-(-skv // 64)} kv tiles of 64 rows")
            ok = e <= TOL[dn] and el <= LSE_TOL and bool(torch.isfinite(o).all())
            print(f"[kernels] flash_fwd {name} {dn}: max|o - plain| {e:.3e} "
                  f"(tol {TOL[dn]:.1e}), max|lse - plain| {el:.3e} "
                  f"(tol {LSE_TOL:.0e}) {'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                fail(f"flash_fwd {name} {dn} disagrees with its plain version")
            if "segment_ids" in kw and float(o[:, :, -(skv // 16):].abs().max()) != 0.0:
                fail("flash_fwd: padding rows (segment id -1) are not zero")
            errs[f"flash_fwd/{name}/{dn}"] = e
            del q, k, v, o, lse, o_ref, lse_ref

        kv_len = torch.tensor([4096, 4000, 2500, 1, 0, 1000, 129, 3333],
                              dtype=torch.int32, device="cuda")
        for name, hq, d, window in (("ragged", 32, 64, None),
                                    ("window_1000", 32, 64, 1000),
                                    ("d128_gqa5", 40, 128, None)):
            q = _rand(torch, gen, (8, hq, d), dtype)
            k = _rand(torch, gen, (8, 8, 4096, d), dtype)
            v = _rand(torch, gen, (8, 8, 4096, d), dtype)
            for ns in (1, 4):
                o = kdecode.flash_decode(q, k, v, kv_len=kv_len, window=window,
                                         num_splits=ns)
                torch.cuda.synchronize()
                o_ref = kdecode.flash_decode_torch(q, k, v, kv_len=kv_len,
                                                   window=window, num_splits=ns)
                e = _maxerr(o, o_ref)
                ok = e <= TOL[dn] and float(o[4].abs().max()) == 0.0
                print(f"[kernels] flash_decode {name} splits={ns} {dn}: "
                      f"max|o - plain| {e:.3e} (tol {TOL[dn]:.1e}), "
                      f"kv_len=0 row zero: {float(o[4].abs().max()) == 0.0} "
                      f"{'ok' if ok else 'FAIL'}", flush=True)
                if not ok:
                    fail(f"flash_decode {name} splits={ns} {dn} disagrees "
                         f"with its plain version")
                errs[f"flash_decode/{name}/ns{ns}/{dn}"] = e
            del q, k, v, o, o_ref

        # recurrentgemma-2b's decode: a ring of 2048 slots, 10/1 heads, D 256
        kv_len = torch.tensor([2048, 0, 700, 2047], dtype=torch.int32,
                              device="cuda")
        q = _rand(torch, gen, (4, 10, 256), dtype)
        k = _rand(torch, gen, (4, 1, 2048, 256), dtype)
        v = _rand(torch, gen, (4, 1, 2048, 256), dtype)
        for ns in (1, 3):
            o = kdecode.flash_decode(q, k, v, kv_len=kv_len, num_splits=ns)
            torch.cuda.synchronize()
            e = _maxerr(o, kdecode.flash_decode_torch(q, k, v, kv_len=kv_len,
                                                      num_splits=ns))
            ok = e <= TOL[dn] and float(o[1].abs().max()) == 0.0
            print(f"[kernels] flash_decode rg_ring2048_g10_d256 splits={ns} "
                  f"{dn}: max|o - plain| {e:.3e} (tol {TOL[dn]:.1e}), kv_len=0 "
                  f"row zero: {float(o[1].abs().max()) == 0.0} "
                  f"{'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                fail(f"flash_decode rg_ring2048_g10_d256 splits={ns} {dn} "
                     f"disagrees with its plain version")
            errs[f"flash_decode/rg_ring2048_g10_d256/ns{ns}/{dn}"] = e
        del q, k, v, o

        # the MoE family's decode at D 128: deepseek-moe-16b's 16/16 heads
        # over 544 slots, dbrx-132b's 48/8 over 272; llava-next-34b's 56/8
        # (a GQA group of 7) over 1056 (kv_len with 0)
        for name, hq, hkv, lens in (("moe_g1_d128_544", 16, 16, [528, 0, 544, 301]),
                                    ("dbrx_g6_d128_272", 48, 8, [264, 0]),
                                    ("llava_g7_d128_1056", 56, 8, [1056, 0, 700, 1055])):
            b, cap = len(lens), max(lens)
            kv_len = torch.tensor(lens, dtype=torch.int32, device="cuda")
            q = _rand(torch, gen, (b, hq, 128), dtype)
            k = _rand(torch, gen, (b, hkv, cap, 128), dtype)
            v = _rand(torch, gen, (b, hkv, cap, 128), dtype)
            for ns in (1, 3):
                if dtype == torch.float32 and name.startswith("llava"):
                    _geometry_line(torch, kdecode, f"flash_decode {name}", b, hq,
                                   hkv, cap, ns, 1, 128)
                o = kdecode.flash_decode(q, k, v, kv_len=kv_len, num_splits=ns)
                torch.cuda.synchronize()
                e = _maxerr(o, kdecode.flash_decode_torch(q, k, v, kv_len=kv_len,
                                                          num_splits=ns))
                ok = e <= TOL[dn] and float(o[1].abs().max()) == 0.0
                print(f"[kernels] flash_decode {name} splits={ns} {dn}: max|o - "
                      f"plain| {e:.3e} (tol {TOL[dn]:.1e}), kv_len=0 row zero: "
                      f"{float(o[1].abs().max()) == 0.0} {'ok' if ok else 'FAIL'}",
                      flush=True)
                if not ok:
                    fail(f"flash_decode {name} splits={ns} {dn} disagrees with "
                         f"its plain version")
                errs[f"flash_decode/{name}/ns{ns}/{dn}"] = e
            del q, k, v, o

    # both kernels against the independent naive oracle, small f32 inputs
    q, k, v = _fwd_inputs(torch, gen, 2, 8, 2, 100, 300, 64, torch.float32)
    seg = _segments(torch, 2, 300)
    o, _ = kfwd.flash_fwd(q, k, v, causal=True, window=90, segment_ids=seg,
                          dropout_rate=0.2, dropout_seed=5)
    o_ref = ref.naive_mha(q, k, v, causal=True, window=90, segment_ids=seg,
                          dropout_rate=0.2, dropout_seed=5)
    e = _maxerr(o, o_ref)
    qd = q[:, :, 0].contiguous()
    kvl = torch.tensor([300, 77], dtype=torch.int32, device="cuda")
    od = kdecode.flash_decode(qd, k, v, kv_len=kvl, num_splits=3)
    ed = _maxerr(od, ops.decode_reference(qd, k, v, kv_len=kvl))
    # hubert's head dim, non-causal, dropout, a q suffix
    q, k, v = _fwd_inputs(torch, gen, 2, 4, 4, 100, 300, 80, torch.float32)
    o, _ = kfwd.flash_fwd(q, k, v, dropout_rate=0.1, dropout_seed=5)
    e80 = _maxerr(o, ref.naive_mha(q, k, v, dropout_rate=0.1, dropout_seed=5))
    print(f"[kernels] vs naive oracle (f32): flash_fwd {e:.3e}, "
          f"flash_decode {ed:.3e}, flash_fwd at D 80 non-causal {e80:.3e} "
          f"(tol {TOL['float32']:.0e})")
    if max(e, ed, e80) > TOL["float32"]:
        fail("a kernel disagrees with the naive oracle")
    torch.cuda.empty_cache()
    return errs


def _paged_case(torch, gen, kv_len, hq, hkv, d, ps, t, dtype, window=None):
    """q [B,Hq,D] and a pool whose rows own exactly the pages their kv_len
    (and, with a window, the window) reaches; every other table entry is the
    trash page 0, filled with 1e6 as the engine's poison hook fills it."""
    b = kv_len.shape[0]
    n_pages = 1 + b * t
    q = _rand(torch, gen, (b, hq, d), dtype)
    kp = _rand(torch, gen, (hkv, n_pages, ps, d), dtype)
    vp = _rand(torch, gen, (hkv, n_pages, ps, d), dtype)
    kp[:, 0], vp[:, 0] = 1e6, 1e6
    perm = torch.randperm(n_pages - 1, generator=gen, device="cuda") + 1
    bt = perm.view(b, t).to(torch.int32)
    block = torch.arange(t, device="cuda")[None, :]
    owned = block < (kv_len[:, None] + ps - 1) // ps
    if window is not None:      # reclaimed: every position out of the window
        owned &= (block + 1) * ps - 1 > kv_len[:, None] - 1 - window
    bt = torch.where(owned, bt, 0).to(torch.int32).contiguous()
    return q, kp, vp, bt


# a packed chunk row of granite's chunk width: spans (history, new tokens)
# of three sequences, each its own table, then padding rows (the trash
# table, kv_len 0), as ``serving/engine.py`` packs a chunk
CHUNK_MIXED = ([(300, 120), (0, 64), (180, 60)], 12)


def _token_rows_case(torch, gen, hq, hkv, d, ps, t, dtype, spans, pads):
    """q, a pool and the token rows' tables and kv_len for ``spans`` and
    ``pads`` (``CHUNK_MIXED``); the trash page 0 holds 1e6."""
    n_pages = 1 + len(spans) * t
    kp = _rand(torch, gen, (hkv, n_pages, ps, d), dtype)
    vp = _rand(torch, gen, (hkv, n_pages, ps, d), dtype)
    kp[:, 0], vp[:, 0] = 1e6, 1e6
    perm = torch.randperm(n_pages - 1, generator=gen, device="cuda") + 1
    tables, lens = [], []
    for i, (h, n) in enumerate(spans):
        table = perm[i * t:(i + 1) * t].to(torch.int32)
        table[-(-(h + n) // ps):] = 0                  # past the allocation
        tables += [table] * n
        lens += list(range(h + 1, h + n + 1))
    tables += [torch.zeros_like(tables[0])] * pads
    lens += [0] * pads
    q = _rand(torch, gen, (len(lens), hq, d), dtype)
    return (q, kp, vp, torch.stack(tables).contiguous(),
            torch.tensor(lens, dtype=torch.int32, device="cuda"))


def _geometry_line(torch, kdecode, name, rows, hq, hkv, skv, ns, row_tokens, d):
    """Print a launch's geometry (f32, paged); at granite's engine decode
    shape (8 rows of 8 kv heads, D 64) fail unless it puts a block on every
    SM in clusters, all resident at once. Elsewhere the waves are printed
    (llava's 8 rows of 8 kv heads at D 128 take more than one, PERF.md)."""
    geo = kdecode.launch_geometry(rows, hq, hkv, skv, ns, row_tokens=row_tokens,
                                  head_dim=d)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clusters = geo["blocks"] // geo["cluster"]
    print(f"[kernels] {name} splits={ns}: {rows} rows (row_tokens {row_tokens}) -> "
          f"{geo['rows_per_block']} a block, {clusters} clusters of {geo['cluster']} ({geo['blocks']} "
          f"blocks on {sms} SMs; the card holds {geo['resident_clusters']} such "
          f"clusters at once: {-(-clusters // geo['resident_clusters'])} "
          f"wave(s))", flush=True)
    if d == 64 and rows * hkv == 64 and ns == 1 and (
            geo["cluster"] < 2 or geo["blocks"] < sms
            or geo["resident_clusters"] < clusters):
        fail(f"{name}: the decode shape leaves SMs without a block ({geo})")
    return geo


def paged_kernel_phase(torch, kdecode):
    """The paged decode kernel against its plain version, f32 and bf16, and
    bit for bit against the contiguous kernel on the gathered pages; each
    case's launch geometry (clusters at the decode shape, query tiles for
    token rows)."""
    gen = torch.Generator(device="cuda").manual_seed(2024)
    cases = [
        # name, kv_len, hq, hkv, d, page size, table width, window
        ("ps16_g4", [576, 0, 528, 1, 300, 129, 555, 17], 32, 8, 64, 16, 37, None),
        ("ps4_g5_d128", [592, 40, 0, 333], 40, 8, 128, 4, 148, None),
        ("ps32_g4_window", [600, 0, 256, 31, 500, 64, 449, 2], 32, 8, 64, 32, 19, 100),
        ("chunk_256_rows", [0] * 16 + list(range(301, 541)), 32, 8, 64, 16, 37, None),
        ("chunk_mixed_tables", None, 32, 8, 64, 16, 37, None),
        ("chunk_mixed_d32", None, 32, 8, 32, 16, 37, None),
        ("chunk_mixed_g5_d128", None, 40, 8, 128, 16, 37, None),
        # recurrentgemma-2b: 10/1 heads, D 256, page 16, window 2048; decode
        # rows whose out-of-window pages are reclaimed (trash, 1e6), and a
        # chunk of 256 token rows of one table (query tiles of 6 rows)
        ("rg_ps16_g10_d256_window", [3120, 0, 2049, 1040, 17, 2600, 3000, 2048],
         10, 1, 256, 16, 196, 2048),
        ("chunk_256_rows_rg_window", [0] * 16 + list(range(2801, 3041)),
         10, 1, 256, 16, 196, 2048),
        # deepseek-moe-16b: 16/16 heads, D 128, the engine's page 16 and 37
        # pages a sequence; decode rows, a 256-row chunk, a mixed chunk row
        ("moe_ps16_g1_d128", [576, 0, 128, 333, 512, 17, 449, 200], 16, 16, 128,
         16, 37, None),
        ("chunk_256_rows_g1_d128", [0] * 16 + list(range(301, 541)), 16, 16,
         128, 16, 37, None),
        ("chunk_mixed_g1_d128", None, 16, 16, 128, 16, 37, None),
        # llava-next-34b: 56/8 heads (a GQA group of 7), D 128, page 16 and
        # 67 pages a sequence (1024 + 32 tokens); decode rows, a 256-row chunk
        ("llava_ps16_g7_d128", [1056, 0, 256, 777, 1024, 17, 500, 900], 56, 8,
         128, 16, 67, None),
        ("chunk_256_rows_g7_d128", [0] * 16 + list(range(801, 1041)), 56, 8,
         128, 16, 67, None),
    ]
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[-1]
        for name, lens, hq, hkv, d, ps, t, window in cases:
            if lens is None:                 # spans of three tables, padding
                q, kp, vp, bt, kv_len = _token_rows_case(
                    torch, gen, hq, hkv, d, ps, t, dtype, *CHUNK_MIXED)
                lens = kv_len.tolist()
            else:
                kv_len = torch.tensor(lens, dtype=torch.int32, device="cuda")
                # a chunk's rows share the last row's table: nothing reclaimed
                q, kp, vp, bt = _paged_case(
                    torch, gen, kv_len, hq, hkv, d, ps, t, dtype,
                    None if name.startswith("chunk") else window)
            if name.startswith("chunk_256_rows"):     # every token row reads one table
                bt = bt[-1:].expand(len(lens), t).contiguous()
            # a chunk's rows are the token rows of one batch row
            rt = len(lens) if name.startswith("chunk") else 1
            kc, vc = kdecode.gather_pages(kp, bt), kdecode.gather_pages(vp, bt)
            zero = kv_len == 0
            for ns in (1, 3):
                if dtype == torch.float32:
                    _geometry_line(torch, kdecode, f"flash_paged_decode {name}",
                                   len(lens), hq, hkv, t * ps, ns, rt, d)
                o = kdecode.flash_paged_decode(q, kp, vp, bt, kv_len, window=window,
                                               num_splits=ns, row_tokens=rt)
                torch.cuda.synchronize()
                o_ref = kdecode.flash_paged_decode_torch(
                    q, kp, vp, bt, kv_len=kv_len, window=window, num_splits=ns)
                o_contig = kdecode.flash_decode(q, kc, vc, kv_len=kv_len,
                                                window=window, num_splits=ns,
                                                row_tokens=rt)
                e, ec = _maxerr(o, o_ref), _maxerr(o, o_contig)
                zero_ok = float(o[zero].abs().max()) == 0.0 if bool(zero.any()) else True
                ok = (e <= TOL[dn] and ec == 0.0 and zero_ok
                      and bool(torch.isfinite(o).all()))
                print(f"[kernels] flash_paged_decode {name} splits={ns} {dn}: "
                      f"max|o - plain| {e:.3e} (tol {TOL[dn]:.1e}), max|o - "
                      f"contiguous kernel on gathered pages| {ec:.1e} (must be "
                      f"0), kv_len=0 rows zero: {zero_ok}, trash page 1e6 "
                      f"{'ok' if ok else 'FAIL'}", flush=True)
                if not ok:
                    fail(f"flash_paged_decode {name} splits={ns} {dn} disagrees "
                         f"with its plain version or the contiguous kernel")
                errs[f"flash_paged_decode/{name}/ns{ns}/{dn}"] = e
            del q, kp, vp, bt, kc, vc
    torch.cuda.empty_cache()
    return errs


def _sharded_case(torch, gen, kv_len, hq, hkv, d, ps, t, dtype, window=None):
    """q and a pool of two shards of ``n_local`` pages (trash pages 0 and
    n_local) whose rows own the pages their kv_len (and window) reach, the
    other entries naming the trash page 0; every trash page holds 1e6."""
    b = kv_len.shape[0]
    n_local = 1 + -(-b * t // 2)
    q = _rand(torch, gen, (b, hq, d), dtype)
    kp = _rand(torch, gen, (hkv, 2 * n_local, ps, d), dtype)
    vp = _rand(torch, gen, (hkv, 2 * n_local, ps, d), dtype)
    for pool in (kp, vp):
        pool[:, 0], pool[:, n_local] = 1e6, 1e6
    usable = torch.tensor([p for p in range(2 * n_local) if p % n_local],
                          device="cuda")
    perm = torch.randperm(usable.numel(), generator=gen, device="cuda")[:b * t]
    bt = usable[perm].view(b, t)
    block = torch.arange(t, device="cuda")[None, :]
    owned = block < (kv_len[:, None] + ps - 1) // ps
    if window is not None:      # reclaimed: every position out of the window
        owned &= (block + 1) * ps - 1 > kv_len[:, None] - 1 - window
    bt = torch.where(owned, bt, 0).to(torch.int32).contiguous()
    return q, kp, vp, bt, n_local


def _state_out(torch, acc, m, l):
    """A partial state's normalised output and log-sum-exp."""
    l_safe = torch.where(l == 0, torch.ones_like(l), l)
    return acc / l_safe[..., None], m + torch.log(l_safe)


def gated_kernel_phase(torch, kdecode):
    """The gated paged kernel (one shard of a page-sharded pool) against its
    plain version, f32 and bf16: (a) a random half of the table entries
    not owned, their pages and the trash page filled with 1e6; (b) the pool
    cut into two shards (local pools, tables remapped to local ids, local
    trash pages 1e6), the shards' partials merged against the ungated paged
    kernel on the whole pool."""
    from repro_torch.core import online_softmax as osm
    from repro_torch.distributed.paged import _local_ids

    gen = torch.Generator(device="cuda").manual_seed(2025)
    cases = [
        # name, kv_len, hq, hkv, d, page size, table width, window
        ("ps16_g4", [576, 0, 528, 1, 300, 129, 555, 17], 32, 8, 64, 16, 37, None),
        ("ps4_g5_d128", [592, 40, 0, 333], 40, 8, 128, 4, 148, None),
        ("ps32_g4_window", [600, 0, 256, 31, 500, 64, 449, 2], 32, 8, 64, 32, 19, 100),
        ("chunk_256_rows", [0] * 16 + list(range(301, 541)), 32, 8, 64, 16, 37, None),
        ("chunk_mixed_tables", None, 32, 8, 64, 16, 37, None),
        ("chunk_mixed_d32", None, 32, 8, 32, 16, 37, None),
        ("chunk_mixed_g5_d128", None, 40, 8, 128, 16, 37, None),
        # recurrentgemma-2b: 10/1 heads, D 256, page 16, window 2048; decode
        # rows whose out-of-window pages are reclaimed (trash, 1e6), and a
        # chunk of 256 token rows of one table (query tiles of 6 rows)
        ("rg_ps16_g10_d256_window", [3120, 0, 2049, 1040, 17, 2600, 3000, 2048],
         10, 1, 256, 16, 196, 2048),
        ("chunk_256_rows_rg_window", [0] * 16 + list(range(2801, 3041)),
         10, 1, 256, 16, 196, 2048),
        # deepseek-moe-16b: 16/16 heads, D 128, the engine's page 16 and 37
        # pages a sequence; decode rows, a 256-row chunk, a mixed chunk row
        ("moe_ps16_g1_d128", [576, 0, 128, 333, 512, 17, 449, 200], 16, 16, 128,
         16, 37, None),
        ("chunk_256_rows_g1_d128", [0] * 16 + list(range(301, 541)), 16, 16,
         128, 16, 37, None),
        ("chunk_mixed_g1_d128", None, 16, 16, 128, 16, 37, None),
    ]
    errs, worst = {}, {"gate": 0.0, "lse": 0.0, "shards": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[-1]
        for name, lens, hq, hkv, d, ps, t, window in cases:
            if lens is None:                 # spans of three tables, padding
                q, kp, vp, bt, kv_len = _token_rows_case(
                    torch, gen, hq, hkv, d, ps, t, dtype, *CHUNK_MIXED)
                lens, n_local = kv_len.tolist(), kp.shape[1] // 2
            else:
                kv_len = torch.tensor(lens, dtype=torch.int32, device="cuda")
                q, kp, vp, bt, n_local = _sharded_case(
                    torch, gen, kv_len, hq, hkv, d, ps, t, dtype,
                    None if name.startswith("chunk") else window)
            if name.startswith("chunk_256_rows"):     # every token row reads one table
                bt = bt[-1:].expand(len(lens), t).contiguous()
            b = len(lens)
            rt = b if name.startswith("chunk") else 1     # one batch row's tokens
            for ns in (1, 3):
                if dtype == torch.float32:
                    _geometry_line(torch, kdecode,
                                   f"flash_paged_decode_partials {name}", b, hq,
                                   hkv, t * ps, ns, rt, d)
                # (a) the gate alone, on the whole pool
                valid = (torch.rand((b, t), generator=gen, device="cuda") < 0.5
                         ).to(torch.int32)
                if name.startswith("chunk_256_rows"):  # one table: one ownership
                    valid = valid[-1:].expand(b, t).contiguous()
                elif name.startswith("chunk_mixed"):   # ownership by page id
                    valid = (bt % 2).to(torch.int32).contiguous()
                kpa, vpa = kp.clone(), vp.clone()
                foreign = bt[valid == 0].long()
                kpa[:, foreign], vpa[:, foreign] = 1e6, 1e6
                part = kdecode.flash_paged_decode_partials(
                    q, kpa, vpa, bt, kv_len, block_valid=valid, window=window,
                    num_splits=ns, row_tokens=rt)
                torch.cuda.synchronize()
                ref = kdecode.flash_paged_decode_partials_torch(
                    q, kpa, vpa, bt, kv_len=kv_len, block_valid=valid,
                    window=window, num_splits=ns)
                (o, lse), (o_ref, lse_ref) = (_state_out(torch, *part),
                                              _state_out(torch, *ref))
                read = ref[2] > 0                       # rows that read something
                e = _maxerr(o, o_ref)
                el = _maxerr(lse[read], lse_ref[read]) if bool(read.any()) else 0.0
                empty_ok = (float(part[0][~read].abs().max()) == 0.0
                            and bool((part[1][~read] == -1e30).all())
                            ) if bool((~read).any()) else True
                ok_a = (e <= TOL[dn] and el <= LSE_TOL and empty_ok
                        and bool(torch.isfinite(o).all()))
                del kpa, vpa
                # (b) two shards merged against the ungated kernel, whole pool
                whole = kdecode.flash_paged_decode(q, kp, vp, bt, kv_len,
                                                   window=window, num_splits=ns,
                                                   row_tokens=rt)
                states = []
                for shard in range(2):
                    lo = shard * n_local
                    bt_l, valid_l = _local_ids(bt, n_local, shard)
                    acc, m, l = kdecode.flash_paged_decode_partials(
                        q, kp[:, lo:lo + n_local].contiguous(),
                        vp[:, lo:lo + n_local].contiguous(), bt_l.contiguous(),
                        kv_len, block_valid=valid_l.contiguous(),
                        window=window, num_splits=ns, row_tokens=rt)
                    states.append(osm.SoftmaxState(m=m, l=l, acc=acc))
                merged, _ = osm.finalize(osm.merge(*states), out_dtype=dtype)
                torch.cuda.synchronize()
                es = _maxerr(merged, whole)
                ok = ok_a and es <= TOL[dn]
                worst["gate"] = max(worst["gate"], e / TOL[dn])
                worst["lse"] = max(worst["lse"], el)
                worst["shards"] = max(worst["shards"], es / TOL[dn])
                print(f"[kernels] flash_paged_decode_partials {name} splits={ns} "
                      f"{dn}: ~half the entries foreign (1e6): max|o - plain| "
                      f"{e:.3e} (tol {TOL[dn]:.1e}), max|lse - plain| {el:.3e} "
                      f"(tol {LSE_TOL:.0e}), empty rows exact: {empty_ok}; two "
                      f"shards merged vs the paged kernel on the whole pool "
                      f"{es:.3e} (tol {TOL[dn]:.1e}) {'ok' if ok else 'FAIL'}",
                      flush=True)
                if not ok:
                    fail(f"flash_paged_decode_partials {name} splits={ns} {dn} "
                         f"disagrees with its plain version or the paged kernel")
                errs[f"flash_paged_decode_partials/{name}/ns{ns}/{dn}"] = e
                errs[f"flash_paged_decode_partials/shards/{name}/ns{ns}/{dn}"] = es
            del q, kp, vp, bt
    print(f"[kernels] flash_paged_decode_partials worst: gate {worst['gate']:.3f} "
          f"x tol, lse {worst['lse']:.3e}, two shards {worst['shards']:.3f} x tol")
    torch.cuda.empty_cache()
    return errs


def shard_partials_kernel_phase(torch, kdecode):
    """Row 4's shard-partials mode (``flash_decode_partials``: one shard of
    a contiguous cache whose sequence is split over ranks, the decode of
    ``kv_cache_seq``) against its plain version at recurrentgemma-2b's
    geometry (10/1 heads, D 256): each half of a 2048-slot ring (1024 slots
    a rank on ``model`` 2), rows holding none, one, some and all of a
    shard's slots (kv_len 0, 1, inside, full), f32 and bf16, 1 and 4
    splits: the normalised state and its log-sum-exp, empty rows exact
    (acc 0, m NEG_INF, l 0), and the two shards merged against the
    contiguous kernel over the whole ring."""
    from repro_torch.core import online_softmax as osm

    gen = torch.Generator(device="cuda").manual_seed(2026)
    b, hq, hkv, d, ring = 4, 10, 1, 256, 2048
    half = ring // 2
    lens = [0, 1, 1500, 2048]      # each row's valid slots of the ring
    errs, worst = {}, 0.0
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[-1]
        q = _rand(torch, gen, (b, hq, d), dtype)
        k = _rand(torch, gen, (b, hkv, ring, d), dtype)
        v = _rand(torch, gen, (b, hkv, ring, d), dtype)
        kv_len = torch.tensor(lens, dtype=torch.int32, device="cuda")
        for ns in (1, 4):
            states, ok, e_max, el_max = [], True, 0.0, 0.0
            for r in range(2):
                n = (kv_len - r * half).clamp(0, half).to(torch.int32)
                ks = k[:, :, r * half:(r + 1) * half].contiguous()
                vs = v[:, :, r * half:(r + 1) * half].contiguous()
                part = kdecode.flash_decode_partials(q, ks, vs, kv_len=n,
                                                     num_splits=ns)
                torch.cuda.synchronize()
                ref = kdecode.flash_decode_partials_torch(q, ks, vs, kv_len=n,
                                                          num_splits=ns)
                (o, lse), (o_ref, lse_ref) = (_state_out(torch, *part),
                                              _state_out(torch, *ref))
                read = n > 0
                e = _maxerr(o, o_ref)
                el = _maxerr(lse[read], lse_ref[read])
                empty = (float(part[0][~read].abs().max()) == 0.0
                         and float(part[2][~read].abs().max()) == 0.0
                         and bool((part[1][~read] == -1e30).all()))
                ok = ok and e <= TOL[dn] and el <= LSE_TOL and empty
                e_max, el_max = max(e_max, e), max(el_max, el)
                states.append(osm.SoftmaxState(m=part[1], l=part[2],
                                               acc=part[0]))
            merged, _ = osm.finalize(osm.merge(*states), out_dtype=dtype)
            whole = kdecode.flash_decode(q, k, v, kv_len=kv_len, num_splits=ns)
            torch.cuda.synchronize()
            es = _maxerr(merged, whole)
            ok = ok and es <= TOL[dn]
            worst = max(worst, e_max / TOL[dn], es / TOL[dn])
            print(f"[kernels] flash_decode_partials rg shard of 1024 slots "
                  f"splits={ns} {dn}: kv_len a shard {lens} split at {half}: "
                  f"max|o - plain| {e_max:.3e} (tol {TOL[dn]:.1e}), max|lse - "
                  f"plain| {el_max:.3e} (tol {LSE_TOL:.0e}), empty rows exact; "
                  f"two shards merged vs the contiguous kernel on the whole "
                  f"ring {es:.3e} {'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                fail(f"flash_decode_partials splits={ns} {dn} disagrees with "
                     f"its plain version or the contiguous kernel")
            errs[f"flash_decode_partials/rg_shard/ns{ns}/{dn}"] = e_max
            errs[f"flash_decode_partials/shards/rg/ns{ns}/{dn}"] = es
        del q, k, v
    print(f"[kernels] flash_decode_partials worst {worst:.3f} x tol")
    torch.cuda.empty_cache()
    return errs


def bwd_kernel_phase(torch, kfwd, kbwd):
    """The fused backward kernel against its plain version, f32 and bf16,
    at the training shape and the edge cases, and against itself on a second
    launch (dK, dV bit-equal; dQ, summed by atomic adds in another order,
    within the tolerance); then against autograd of the naive oracle.
    Returns {case: max |kernel - plain| / max(1, max|plain|)}."""
    from repro_torch.kernels import ref

    print(f"[kernels] backward tolerances, kernel vs plain version, relative "
          f"to max(1, max|plain|): f32 {BWD_TOL['float32']:.0e} (the JAX "
          f"suite's gradient tolerance; dK and dV sum over up to 2048 q rows "
          f"and a group of 1, 4 or 10 in another order); bf16 inputs or bf16-ACC "
          f"{BWD_TOL['bfloat16']:.2e} (two bf16 ulps)")
    gen = torch.Generator(device="cuda").manual_seed(4321)
    bf16 = torch.bfloat16
    cases = [
        # name, b, hq, hkv, sq, skv, d, extra kwargs
        ("train_s2048", 4, 32, 8, 2048, 2048, 64, dict(causal=True)),
        ("window_128", 4, 32, 8, 512, 512, 64, dict(causal=True, window=128)),
        ("segments", 4, 32, 8, 512, 512, 64, dict(causal=True, segments=True)),
        ("dropout_0.1", 4, 32, 8, 512, 512, 64,
         dict(causal=True, dropout_rate=0.1, dropout_seed=-7)),
        ("ragged_500", 4, 32, 8, 500, 500, 64, dict(causal=True)),
        ("q_suffix_200_of_500", 4, 32, 8, 200, 500, 64, dict(causal=True)),
        ("d128_gqa5", 4, 40, 8, 512, 512, 128, dict(causal=True)),
        ("bf16_acc", 4, 32, 8, 512, 512, 64, dict(causal=True, acc_dtype=bf16)),
        # recurrentgemma-2b's training geometry: 32-row kv blocks, four
        # warps on each 16 rows, 10 q heads a block
        ("rg_s3072", 1, 10, 1, 3072, 3072, 256, dict(causal=True, window=2048)),
        ("rg_dropout_0.1", 1, 10, 1, 3072, 3072, 256,
         dict(causal=True, window=2048, dropout_rate=0.1, dropout_seed=-3)),
        ("rg_segments", 1, 10, 1, 3072, 3072, 256,
         dict(causal=True, window=2048, segments=True)),
        ("rg_bf16_acc", 1, 10, 1, 3072, 3072, 256,
         dict(causal=True, window=2048, acc_dtype=bf16)),
        # deepseek-moe-16b's training geometry: 16/16 heads, D 128
        ("moe_train_g1_d128_dropout_0.1", 2, 16, 16, 2048, 2048, 128,
         dict(causal=True, dropout_rate=0.1, dropout_seed=-11)),
        ("moe_g1_d128_bf16_acc", 2, 16, 16, 2048, 2048, 128,
         dict(causal=True, acc_dtype=bf16)),
        # hubert-xlarge's training geometry: 16/16 heads, D 80, non-causal
        ("hubert_train_d80", 8, 16, 16, 1024, 1024, 80, {}),
        ("hubert_d80_dropout_0.1", 8, 16, 16, 1024, 1024, 80,
         dict(dropout_rate=0.1, dropout_seed=-13)),
        ("hubert_d80_segments", 8, 16, 16, 1024, 1024, 80, dict(segments=True)),
        ("hubert_d80_bf16_acc", 8, 16, 16, 1024, 1024, 80, dict(acc_dtype=bf16)),
        # the non-causal path at granite's training geometry
        ("granite_train_non_causal_d64", 4, 32, 8, 2048, 2048, 64, {}),
        # llava-next-34b's training geometry: 56/8 heads, D 128, B 1 x 2048
        ("llava_train_g7_d128", 1, 56, 8, 2048, 2048, 128, dict(causal=True)),
    ]
    errs = {}
    for dtype in (torch.float32, bf16):
        dn = str(dtype).split(".")[-1]
        for name, b, hq, hkv, sq, skv, d, kw in cases:
            kw = dict(kw)
            q, k, v = _fwd_inputs(torch, gen, b, hq, hkv, sq, skv, d, dtype)
            do = _rand(torch, gen, (b, hq, sq, d), dtype)
            if kw.pop("segments", False):
                kw["segment_ids"] = _segments(torch, b, skv)
            tn = "bfloat16" if bf16 in (dtype, kw.get("acc_dtype")) else "float32"
            o, lse = kfwd.flash_fwd(q, k, v, **kw)
            if "acc_dtype" in kw:            # bf16-ACC forward against its plain version
                o_ref, _ = kfwd.flash_fwd_torch(q, k, v, **kw)
                e = _maxerr(o, o_ref)
                print(f"[kernels] flash_fwd {name} {dn}: max|o - plain| {e:.3e} "
                      f"(tol {TOL['bfloat16']:.2e}) {'ok' if e <= TOL['bfloat16'] else 'FAIL'}")
                if e > TOL["bfloat16"]:
                    fail(f"flash_fwd {name} {dn} disagrees with its plain version")
                errs[f"flash_fwd/{name}/{dn}"] = e
                del o_ref
            grads = kbwd.flash_bwd(q, k, v, o, lse, do, **kw)
            again = kbwd.flash_bwd(q, k, v, o, lse, do, **kw)
            torch.cuda.synchronize()
            plain = kbwd.flash_bwd_torch(q, k, v, lse, do, kbwd.row_delta(o, do),
                                         **kw)
            worst, parts = 0.0, []
            for gname, g, gp in zip(("dq", "dk", "dv"), grads, plain):
                rel = _maxerr(g, gp) / max(1.0, float(gp.float().abs().max()))
                worst = max(worst, rel)
                parts.append(f"{gname} {rel:.3e}")
                if not bool(torch.isfinite(g).all()):
                    fail(f"flash_bwd {name} {dn}: {gname} is not finite")
            ok = worst <= BWD_TOL[tn]
            print(f"[kernels] flash_bwd {name} {dn}: max|g - plain| / max(1, "
                  f"max|plain|): {', '.join(parts)} (tol {BWD_TOL[tn]:.1e}) "
                  f"{'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                fail(f"flash_bwd {name} {dn} disagrees with its plain version")
            rerun = _maxerr(grads[0], again[0]) / max(1.0, float(plain[0].float().abs().max()))
            same_kv = torch.equal(grads[1], again[1]) and torch.equal(grads[2], again[2])
            print(f"[kernels] flash_bwd {name} {dn} launched twice: dk, dv "
                  f"{'bit-equal' if same_kv else 'DIFFER'}; dq {rerun:.3e} relative "
                  f"(atomic adds in another order; tol {BWD_TOL[tn]:.1e})")
            if not same_kv or rerun > BWD_TOL[tn]:
                fail(f"flash_bwd {name} {dn} is not reproducible on a second launch")
            if "segment_ids" in kw:
                pad = skv // 16
                if max(float(grads[0][:, :, -pad:].abs().max()),
                       float(grads[1][:, :, -pad:].abs().max()),
                       float(grads[2][:, :, -pad:].abs().max())) != 0.0:
                    fail("flash_bwd: padding tokens (segment id -1) get a gradient")
            errs[f"flash_bwd/{name}/{dn}"] = worst
            del q, k, v, do, o, lse, grads, again, plain

    # the backward kernel against autograd of the naive oracle, small f32
    q, k, v = _fwd_inputs(torch, gen, 2, 8, 2, 100, 300, 64, torch.float32)
    do = _rand(torch, gen, (2, 8, 100, 64), torch.float32)
    kw = dict(causal=True, window=90, segment_ids=_segments(torch, 2, 300),
              dropout_rate=0.2, dropout_seed=5)
    o, lse = kfwd.flash_fwd(q, k, v, **kw)
    grads = kbwd.flash_bwd(q, k, v, o, lse, do, **kw)
    xs = [x.clone().requires_grad_() for x in (q, k, v)]
    ref.naive_mha(*xs, **kw).backward(do)
    worst = max(_maxerr(g, x.grad) / max(1.0, float(x.grad.abs().max()))
                for g, x in zip(grads, xs))
    # hubert's head dim, non-causal, dropout, a q suffix
    q, k, v = _fwd_inputs(torch, gen, 2, 4, 4, 100, 300, 80, torch.float32)
    do = _rand(torch, gen, (2, 4, 100, 80), torch.float32)
    kw = dict(dropout_rate=0.1, dropout_seed=5)
    o, lse = kfwd.flash_fwd(q, k, v, **kw)
    grads = kbwd.flash_bwd(q, k, v, o, lse, do, **kw)
    xs = [x.clone().requires_grad_() for x in (q, k, v)]
    ref.naive_mha(*xs, **kw).backward(do)
    worst80 = max(_maxerr(g, x.grad) / max(1.0, float(x.grad.abs().max()))
                  for g, x in zip(grads, xs))
    print(f"[kernels] flash_bwd vs autograd of the naive oracle (f32, window, "
          f"segments, dropout, q suffix): {worst:.3e}; at D 80 non-causal "
          f"(dropout, q suffix): {worst80:.3e} (tol {BWD_TOL['float32']:.0e})")
    if max(worst, worst80) > BWD_TOL["float32"]:
        fail("the backward kernel disagrees with autograd of the naive oracle")
    torch.cuda.empty_cache()
    return errs


def serve_phase(torch, kfwd, kdecode, arch="granite_3_2b", batch=8,
                prompt_len=512, gen_len=32, tag="serve", autotune=False):
    """An arch at full width and depth through the port's contiguous serving
    path (granite-3-2b; phase 4d: recurrentgemma-2b, batch 4, prompt 3072
    past its 2048-token window, so prefill masks and the ring rolls).
    ``autotune``: the kernel run takes ``launch/serve.py --autotune``'s
    split count, every decode launch must take it, and the torch impl it is
    held to runs one split."""
    from repro_torch import configs
    from repro_torch.launch.serve import autotuned_plan, greedy_generate
    from repro_torch.models import lm
    from repro_torch.runtime.steps import make_serve_steps

    cfg = dataclasses.replace(configs.get_config(arch),
                              dtype=torch.float32)   # as launch/serve.py forces
    n_attn = lm.block_kinds(cfg).count("attn")
    t0 = time.perf_counter()
    params = lm.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    print(f"[{tag}] {cfg.name}: {cfg.num_layers} layers ({n_attn} attention), "
          f"d_model {cfg.d_model}, heads {cfg.num_heads}/{cfg.num_kv_heads}, "
          f"head_dim {cfg.head_dim}, window {cfg.attn_window}, vocab "
          f"{cfg.vocab_size}; {n_params / 1e9:.2f} B params f32 "
          f"(random, seed 0) in {time.perf_counter() - t0:.1f} s")
    g = torch.Generator(device="cuda").manual_seed(0)
    prompt = torch.randint(0, cfg.vocab_size, (batch, prompt_len), generator=g,
                           device="cuda")

    def steps(impl, num_splits=1):
        return make_serve_steps(cfg, impl=impl, max_len=prompt_len + gen_len,
                                batch=batch, num_splits=num_splits,
                                torch_chunk=prompt_len, device="cuda")

    splits = 1
    if autotune:
        plan = autotuned_plan(cfg, batch, prompt_len + gen_len, "cuda")
        splits = plan.num_splits
        print(f"[{tag}] --autotune's plan: {splits} split(s) ({plan.source}, "
              f"predicted {plan.time_s * 1e6:.2f} us a layer)", flush=True)
    launched, launch = [], kdecode._launch

    def spy(q, k, v, kv_len, window, scale, num_splits, row_tokens):
        launched.append(num_splits)
        return launch(q, k, v, kv_len, window, scale, num_splits, row_tokens)

    torch.cuda.reset_peak_memory_stats()
    kfwd.launches = kdecode.launches = 0
    kdecode._launch = spy
    try:
        run_k = greedy_generate(steps("kernel", splits), params, prompt,
                                gen_len, cfg.vocab_size)
    finally:
        kdecode._launch = launch
    launches = {"flash_fwd": kfwd.launches, "flash_decode": kdecode.launches}
    peak = torch.cuda.max_memory_allocated()
    want = {"flash_fwd": n_attn, "flash_decode": n_attn * (gen_len - 1)}
    print(f"[{tag}] impl=kernel: prefill {batch}x{prompt_len} "
          f"{run_k.prefill_s * 1e3:.1f} ms; decode {gen_len - 1} steps "
          f"{run_k.decode_s * 1e3:.1f} ms "
          f"({(gen_len - 1) * batch / run_k.decode_s:.1f} tok/s); "
          f"max_memory_allocated {peak / 2**30:.2f} GiB")
    print(f"[{tag}] launch counters {launches} (expected {want}); decode "
          f"launches at splits {sorted(set(launched))} (expected [{splits}])",
          flush=True)
    if launches != want:
        fail(f"{arch}: the serving path did not go through the kernels: "
             f"{launches}")
    if set(launched) != {splits}:
        fail(f"{arch}: decode launched at splits {sorted(set(launched))}, "
             f"planned {splits}")

    print(f"[{tag}] tolerance kernel vs torch impl: max |d logit| <= "
          f"{LOGIT_REL_TOL:.0e} x max|logit| ({cfg.num_layers} layers of f32 "
          f"with sums in another order move logits ~1e-6 relative; a wrong "
          f"kernel moves them by far more)")
    run_t = greedy_generate(steps("torch"), params, prompt, gen_len,
                            cfg.vocab_size, feed=run_k.tokens)
    if {"flash_fwd": kfwd.launches, "flash_decode": kdecode.launches} != want:
        fail("impl='torch' launched a CUDA kernel")
    worst = 0.0
    for step, (lk, lt) in enumerate(zip(run_k.logits, run_t.logits)):
        if lk.shape != (batch, cfg.vocab_size) or \
                not bool(torch.isfinite(lk).all()):
            fail(f"step {step}: logits of shape {tuple(lk.shape)} or not finite")
        rel = _maxerr(lk, lt) / float(lt.abs().max())
        worst = max(worst, rel)
        if rel > LOGIT_REL_TOL:
            fail(f"step {step}: kernel vs torch logits differ by {rel:.3e} "
                 f"of max|logit| (tol {LOGIT_REL_TOL:.0e})")
    match = float((run_k.tokens == run_t.tokens).float().mean())
    print(f"[{tag}] impl=torch (fed the kernel run's tokens): prefill "
          f"{run_t.prefill_s * 1e3:.1f} ms; decode {run_t.decode_s * 1e3:.1f} ms")
    print(f"[{tag}] kernel vs torch logits over prefill + {gen_len - 1} steps: "
          f"max |d| / max|logit| {worst:.3e} (tol {LOGIT_REL_TOL:.0e}); "
          f"greedy token match {match:.4f}", flush=True)
    if tag == "hybrid" and match != 1.0:
        fail(f"{arch}: kernel and torch greedy tokens differ ({match:.4f})")
    del params, run_k, run_t
    torch.cuda.empty_cache()
    return launches


PAGED_REQUESTS, PAGED_PROMPT, PAGED_GEN = 16, 512, 64
PAGED_MODES = {
    # name: engine kwargs (beyond page 16, 8 slots, prefill rows of 512)
    "eager": {},
    "lazy": {"lazy": True},
    "prefix_chunk": {"share_prefix": True, "prefill_chunk": 256},
    "speculate_4": {"speculate_k": 4},
}


class StepRecorder:
    """Wraps an engine's four step callables: counts their calls and keeps,
    for every generated token (request id, index in its generation), the
    top-2 logit margin and max |logit| of the row that produced it and the
    index of the call that did; with ``routes`` (an MoE arch's routes are
    being recorded), for every call also its kind, its input tokens and the
    request id of each token row (-1 for padding and idle rows). The engine
    is not changed; the wrappers read its scheduler to name rows."""

    def __init__(self, torch, eng, vocab, routes=False):
        self.torch, self.eng, self.vocab, self.routes = torch, eng, vocab, routes
        self.calls = dict.fromkeys(("prefill", "decode", "chunk", "verify"), 0)
        self.margin, self.call_of, self.inputs, self.rids = {}, {}, [], []
        for attr, kind in (("prefill_fn", "prefill"), ("decode_fn", "decode"),
                           ("chunk_prefill_fn", "chunk"), ("verify_fn", "verify")):
            setattr(eng, attr, self._wrap(getattr(eng, attr), kind))

    def _wrap(self, fn, kind):
        def step(params, *args):
            keys = getattr(self, "_" + kind)(*args)   # before the engine appends
            if self.routes:
                self.inputs.append((kind, args[0].cpu()))
                self.rids.append(self._token_rids(kind, args))
            logits, caches = fn(params, *args)
            self.calls[kind] += 1
            self._record(logits, keys)
            return logits, caches
        return step

    def _token_rids(self, kind, args):
        """The request id of each token row of a call, flattened as the
        model flattens its tokens (row-major), -1 for padding."""
        active = self.eng.scheduler.active
        if kind in ("prefill", "chunk"):      # the tokens' decode slots
            slots = (args[4] if kind == "prefill" else args[5]).reshape(-1)
            return [active[s].request.rid if s >= 0 else -1
                    for s in slots.cpu().tolist()]
        rows, width = (args[0].shape[0], 1) if kind == "decode" else args[0].shape
        return [active[s].request.rid if s in active and not active[s].prefilling
                else -1 for s in range(rows) for _ in range(width)]

    def _key(self, slot, ahead=0):
        seq = self.eng.scheduler.active[int(slot)]
        return seq.request.rid, len(seq.all_generated) + ahead

    def _prefill(self, tokens, seg, pos, dest, slots, caches):
        # the step's logits: one row a prompt, in the row's order
        seg, slots = seg[0].cpu().numpy(), slots[0].cpu().numpy()
        return [(self._key(slots[int((seg == i).nonzero()[0][-1])]), (i,))
                for i in range(int(seg.max()) + 1)]

    def _chunk(self, tokens, pos, dest, ttab, kvl, slots, local, caches):
        # the step's logits: one row a span, in the row's order
        from repro_torch.models.lm import span_ends
        ends = span_ends(slots)[0].nonzero()[:, 0].tolist()
        pos, slots = pos[0].cpu().numpy(), slots[0].cpu().numpy()
        return [(self._key(slots[idx]), (j,)) for j, idx in enumerate(ends)
                if pos[idx] + 1 ==
                self.eng.scheduler.active[int(slots[idx])].request.prompt_len]

    def _decode(self, tok, caches, bt, kvl):
        return [(self._key(slot), (slot,))
                for slot, seq in self.eng.scheduler.active.items()
                if not seq.prefilling]

    def _verify(self, tok, pos, dest, ttab, kvl, caches):
        live = (kvl > 0).sum(dim=1).cpu().numpy()
        return [(self._key(slot, j), (slot, j))
                for slot, seq in self.eng.scheduler.active.items()
                if not seq.prefilling for j in range(int(live[slot]))]

    def _record(self, logits, keys):
        if not keys:
            return
        rows = self.torch.stack([logits[ix][:self.vocab] for _, ix in keys]).float()
        top = rows.topk(2, dim=-1).values
        margin = (top[:, 0] - top[:, 1]).cpu().tolist()
        peak = rows.abs().amax(dim=-1).cpu().tolist()
        for (key, _), m, p in zip(keys, margin, peak):
            self.margin[key] = (m, p)
            self.call_of[key] = sum(self.calls.values()) - 1


def _paged_requests(np, vocab, mode, max_prompt, n=PAGED_REQUESTS):
    """``n`` seeded requests, prompts 128-512 tokens and 16-64 generated;
    prefix_chunk opens each with one 256-token system prompt (cut to the
    pool's reach, as launch/serve.py cuts it); speculate_4 tiles an 8-token
    motif, as launch/serve.py builds its --speculate prompts."""
    rs = np.random.RandomState(0)
    system = (rs.randint(0, vocab, size=256) if mode == "prefix_chunk"
              else np.zeros(0, np.int64))
    reqs = []
    for _ in range(n):
        plen = int(rs.randint(PAGED_PROMPT // 4, PAGED_PROMPT + 1))
        gen = int(rs.randint(PAGED_GEN // 4, PAGED_GEN + 1))
        if mode == "speculate_4":
            tail = np.tile(rs.randint(0, vocab, size=8), -(-plen // 8))[:plen]
        else:
            tail = rs.randint(0, vocab, size=plen)
        reqs.append((np.concatenate([system, tail])[:max_prompt], gen))
    return reqs


def granite_paged_config(torch):
    """granite-3-2b at full width, ``PAGED_LAYERS`` layers, f32."""
    from repro_torch import configs
    return dataclasses.replace(configs.get_config("granite_3_2b"),
                               num_layers=PAGED_LAYERS, dtype=torch.float32)


def paged_serve_phase(torch, kfwd, kdecode):
    """granite-3-2b, full width and ``PAGED_LAYERS`` layers, through the
    port's paged serving engine in four modes, kernel impl against torch
    impl. Returns the launch counts of the kernel runs, and their tokens and
    top-2 margins by mode."""
    import numpy as np

    from repro_torch.models import lm

    cfg = granite_paged_config(torch)
    params = lm.init_params(cfg, seed=0, device="cuda")
    modes = _paged_modes(np, cfg, PAGED_REQUESTS, PAGED_MODES, "paged")
    counts, tokens, _ = _engine_modes(torch, kfwd, kdecode, cfg, params, modes,
                                      "paged", PAGED_PROMPT)
    del params
    torch.cuda.empty_cache()
    return counts, tokens


def _paged_modes(np, cfg, n_requests, mode_kw, tag):
    """Phase 4b's pools and requests for ``_engine_modes``: page 16, 8
    slots, 37 pages a sequence, the whole pool (297 pages) or half of it in
    a lazy mode; ``n_requests`` of ``_paged_requests``; ``mode_kw`` the
    engine kwargs by mode."""
    from repro_torch.serving import PagedCacheConfig

    ps, slots = 16, 8
    budget = PAGED_PROMPT + PAGED_GEN
    pages_per_seq = -(-budget // ps) + 1                       # 37
    full_pool = 1 + slots * pages_per_seq                      # 297
    print(f"[{tag}] {cfg.name}, {cfg.num_layers} layers f32 (random, seed 0): "
          f"page {ps}, {slots} slots, {pages_per_seq} pages a sequence, pool "
          f"{full_pool} pages ({(full_pool - 1) // 2 + 1} in lazy mode); "
          f"{n_requests} requests, prompts {PAGED_PROMPT // 4}-{PAGED_PROMPT} "
          f"tokens, {PAGED_GEN // 4}-{PAGED_GEN} generated; near-tie tolerance: "
          f"top-2 margin <= {LOGIT_REL_TOL:.0e} x max|logit|", flush=True)
    modes = {}
    for mode, kw in mode_kw.items():
        lazy = kw.get("lazy", False)
        pcfg = PagedCacheConfig(
            page_size=ps, max_batch=slots, max_pages_per_seq=pages_per_seq,
            num_pages=(full_pool - 1) // 2 + 1 if lazy else full_pool)
        # lazy: a preempted row re-prefills prompt + generated, so a row
        # holds a full budget (launch/serve.py's rule)
        modes[mode] = (pcfg, budget if lazy else PAGED_PROMPT, kw,
                       _paged_requests(np, cfg.vocab_size, mode,
                                       pcfg.max_seq_len - PAGED_GEN - 1,
                                       n_requests))
    return modes


def _engine_route_flips(cfg, rec_k, rec_t, routes_k, routes_t, tag, mode):
    """The kernel and torch runs of one engine mode, compared call by call
    while their step calls took the same tokens: the routing choices of
    the torch run that the kernel run did not make (at most
    ``MOE_FLIP_TOL`` of the decisions), printed with the requests of the
    tokens routed otherwise. Returns the first step call with a flip, or
    None."""
    from repro_torch.models.moe_routes import route_diff

    n_layers = cfg.num_layers
    aligned = 0
    for (kind_k, tok_k), (kind_t, tok_t) in zip(rec_k.inputs, rec_t.inputs):
        if kind_k != kind_t or not tok_k.equal(tok_t):
            break
        aligned += 1
    flips = decisions = 0
    first, where = None, []
    for c in range(aligned):
        for layer in range(n_layers):
            a, b = routes_t.calls[c * n_layers + layer], routes_k.calls[c * n_layers + layer]
            f, changed = route_diff(cfg.moe, a, b)
            flips += f
            decisions += a.numel()
            if bool(changed.any()):
                first = c if first is None else first
                rids = sorted({rec_k.rids[c][j] for j in
                               changed.nonzero()[:, 0].tolist()})
                where.append(f"call {c} ({rec_k.inputs[c][0]}) layer {layer}: "
                             f"requests {rids}")
    print(f"[{tag}] {mode}: routing, torch vs kernel impl over {aligned} step "
          f"calls with equal tokens (of {len(rec_k.inputs)} / "
          f"{len(rec_t.inputs)}): {flips} of {decisions} choices flipped "
          f"({flips / max(decisions, 1):.2e}, tol {MOE_FLIP_TOL:.0e})"
          + "".join(f"; {w}" for w in where[:12]), flush=True)
    if flips > MOE_FLIP_TOL * decisions:
        fail(f"{tag} {mode}: {flips} of {decisions} routing choices flipped")
    return first


def _engine_modes(torch, kfwd, kdecode, cfg, params, modes, tag, torch_chunk):
    """Each mode of ``modes`` ({name: (pool config, prefill row length,
    engine kwargs, requests)}) through ``ServingEngine`` with impl kernel,
    then torch: every request completes, ``flash_fwd`` launches (attention
    layers) x prefill calls and the paged kernel (attention layers) x
    (decode + chunk + verify calls), the torch impl none, a lazy mode
    preempts, and the tokens are equal up to a printed near-tie. For an
    MoE arch the routes of both runs are recorded (``RouteRecorder``), the
    flips held to ``MOE_FLIP_TOL`` and printed, and tokens may also differ
    from the call of the first flip on. Returns the kernel runs' launch
    counts, their (outputs, top-2 margins) and their engine stats by
    mode."""
    import contextlib

    import numpy as np

    from repro_torch.models import lm
    from repro_torch.models.moe_routes import RouteRecorder
    from repro_torch.serving import ServingEngine

    n = lm.block_kinds(cfg).count("attn")
    counts = {"flash_fwd": 0, "flash_paged_decode": 0, "by_mode": {}}
    tokens, kernel_stats = {}, {}
    for mode, (pcfg, prefill_len, kw, reqs) in modes.items():
        runs = {}
        for impl in ("kernel", "torch"):
            eng = ServingEngine(cfg, pcfg, params, impl=impl, device="cuda",
                                prefill_len=prefill_len, torch_chunk=torch_chunk,
                                **kw)
            routes = RouteRecorder() if cfg.moe is not None else None
            rec = StepRecorder(torch, eng, cfg.vocab_size, routes is not None)
            torch.cuda.reset_peak_memory_stats()
            kfwd.launches = kdecode.launches = kdecode.launches_paged = 0
            with routes or contextlib.nullcontext():
                out, stats = eng.run([(t, g) for t, g in reqs])
            torch.cuda.synchronize()
            got = {"flash_fwd": kfwd.launches, "flash_decode": kdecode.launches,
                   "flash_paged_decode": kdecode.launches_paged}
            c = rec.calls
            print(f"[{tag}] {mode} impl={impl}: {stats['generated_tokens']:.0f} "
                  f"tokens in {stats['wall_s']:.3f} s = "
                  f"{stats['tokens_per_s']:.1f} tokens/s; "
                  f"{stats['decode_steps']:.0f} decode steps; calls prefill "
                  f"{c['prefill']} / decode {c['decode']} / chunk {c['chunk']} "
                  f"/ verify {c['verify']}; preemptions "
                  f"{stats['preemptions']:.0f}; page utilization "
                  f"{stats['mean_utilization']:.3f}, pool fraction "
                  f"{stats['mean_pool_fraction']:.3f}; pages reclaimed "
                  f"{stats['pages_reclaimed']:.0f}; state releases "
                  f"{stats['state_releases']:.0f}; prefill tokens "
                  f"{stats['prefill_tokens']:.0f} ({stats['prefill_tokens_skipped']:.0f} "
                  f"skipped), cow {stats['cow_copies']:.0f}, drafted "
                  f"{stats['drafted_tokens']:.0f} / accepted "
                  f"{stats['accepted_tokens']:.0f}; max_memory_allocated "
                  f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
                  f"launches {got}", flush=True)
            if stats["outcomes"]["completed"] != len(reqs):
                fail(f"{tag} {mode} {impl}: outcomes {stats['outcomes']}")
            if impl == "kernel":
                want = {"flash_fwd": n * c["prefill"], "flash_decode": 0,
                        "flash_paged_decode": n * (c["decode"] + c["chunk"]
                                                   + c["verify"])}
                if got != want or want["flash_paged_decode"] == 0:
                    fail(f"{tag} {mode}: the path did not go through the "
                         f"kernels: {got}, expected {want}")
                counts["flash_fwd"] += got["flash_fwd"]
                counts["flash_paged_decode"] += got["flash_paged_decode"]
                counts["by_mode"][mode] = got["flash_paged_decode"]
                kernel_stats[mode] = stats
            elif any(got.values()):
                fail(f"{tag} {mode}: impl='torch' launched a CUDA kernel: {got}")
            runs[impl] = (out, rec, routes)
            rec.eng = eng = None      # the pool goes with the engine
        if kw.get("lazy") and stats["preemptions"] == 0:
            fail(f"{tag} {mode}: the lazy mode preempted no row")
        out_k, rec_k, routes_k = runs["kernel"]
        out_t, rec_t, routes_t = runs["torch"]
        tokens[mode] = (out_k, rec_k.margin)
        first_flip = (None if routes_k is None else _engine_route_flips(
            cfg, rec_k, rec_t, routes_k, routes_t, tag, mode))
        same, ties = 0, []
        for rid, toks in out_k.items():
            diff = np.nonzero(toks != out_t[rid])[0]
            if diff.size == 0:
                same += 1
                continue
            i = int(diff[0])
            margin, peak = rec_k.margin[(rid, i)]
            ties.append(f"request {rid} token {i}: kernel {toks[i]} vs torch "
                        f"{out_t[rid][i]}, margin {margin:.3e} of max|logit| "
                        f"{peak:.3e}")
            if first_flip is not None and first_flip <= rec_k.call_of[(rid, i)]:
                ties[-1] += f", after the routing flip of call {first_flip}"
            elif margin > LOGIT_REL_TOL * peak:
                fail(f"{tag} {mode}: {ties[-1]}: not a near-tie")
        print(f"[{tag}] {mode}: kernel vs torch tokens identical for {same} of "
              f"{len(out_k)} requests"
              + ("".join(f"; near-tie {t}" for t in ties)), flush=True)
    return counts, tokens, kernel_stats


# phase 4d: recurrentgemma-2b, 12 seeded requests of 1024-3072 prompt and
# 16-48 new tokens on page 16 and 8 slots (the pool of a sequence: 196 pages)
HYBRID_REQUESTS, HYBRID_PROMPT, HYBRID_GEN = 12, 3072, 48
# its paged phases (4d's engine, 4c's ranks, which share 4d's reference) at
# full width and 3 of its 26 layers (rec, rec, attn): at 26 they took
# 272 s of the run, which phase 5g took past 1000 s, so 7 (2 attention);
# then 4, when 4c's ranks began to shard the weights over model and to pay
# for its tensor-parallel prefill in gloo collectives; then 3, to pay for
# phase 4i's second paged mode (PERF.md)
HYBRID_PAGED_LAYERS = 3
HYBRID_MODES = {
    # name: (engine kwargs beyond page 16 and 8 slots, prefill row length,
    # half the pool); window reclaim is on in every mode (the arch has a
    # window), poisoned under the lazy mode
    "eager": ({}, HYBRID_PROMPT, False),
    # preemption forced by a seeded storm plan (serving/faults.py: the
    # youngest rows preempted at three steps): these prompts are long beside
    # their generations, so growth on half the pool never runs dry
    "lazy": ({"lazy": True, "poison_reclaimed": True,
              "fault_plan": dict(seed=3, horizon=40, events_per_kind=3,
                                 kinds=("storm",))},
             HYBRID_PROMPT + HYBRID_GEN, True),
    "chunk_512": ({"prefill_chunk": 512}, 512, False),
}


def _hybrid_requests(np, vocab):
    """12 seeded requests: prompts 1024-3072 tokens, 16-48 generated."""
    rs = np.random.RandomState(1)
    return [(rs.randint(0, vocab, size=int(rs.randint(HYBRID_PROMPT // 3,
                                                       HYBRID_PROMPT + 1))),
             int(rs.randint(HYBRID_GEN // 3, HYBRID_GEN + 1)))
            for _ in range(HYBRID_REQUESTS)]


def hybrid_pool(lazy: bool):
    """Phase 4d's page pool: page 16, 8 slots, 196 pages a sequence; the
    whole pool holds every slot's budget, the lazy one half of it."""
    from repro_torch.serving import PagedCacheConfig

    ps, slots = 16, 8
    pages_per_seq = -(-(HYBRID_PROMPT + HYBRID_GEN) // ps) + 1       # 196
    full = 1 + slots * pages_per_seq                                 # 1569
    return PagedCacheConfig(page_size=ps, max_batch=slots,
                            max_pages_per_seq=pages_per_seq,
                            num_pages=(full - 1) // 2 + 1 if lazy else full)


def hybrid_paged_config(torch):
    """recurrentgemma-2b at full width, ``HYBRID_PAGED_LAYERS`` layers, f32."""
    from repro_torch import configs
    return dataclasses.replace(configs.get_config("recurrentgemma_2b"),
                               num_layers=HYBRID_PAGED_LAYERS,
                               dtype=torch.float32)


def hybrid_paged_phase(torch, kfwd, kdecode):
    """recurrentgemma-2b at full width and ``HYBRID_PAGED_LAYERS`` layers
    through the paged engine in ``HYBRID_MODES`` (``_engine_modes``: kernel
    impl against torch impl, launch counters attention layers x calls,
    tokens equal up to a near-tie); eager must reclaim out-of-window pages;
    prefix sharing and speculation are refused. Returns the kernel runs'
    launch counts, and their tokens and top-2 margins by mode (for phase
    4c)."""
    import numpy as np

    from repro_torch.models import lm
    from repro_torch.serving import FaultPlan, ServingEngine

    cfg = hybrid_paged_config(torch)
    params = lm.init_params(cfg, seed=0, device="cuda")
    reqs = _hybrid_requests(np, cfg.vocab_size)
    for kw in ({"share_prefix": True}, {"speculate_k": 4}):
        try:
            ServingEngine(cfg, hybrid_pool(False), params, device="cuda", **kw)
        except ValueError as e:
            print(f"[hybrid] {kw} refused: {e}")
        else:
            fail(f"recurrentgemma-2b: the engine accepted {kw}")
    pcfg = hybrid_pool(False)
    print(f"[hybrid] paged: page {pcfg.page_size}, {pcfg.max_batch} slots, "
          f"{pcfg.max_pages_per_seq} pages a sequence, pool {pcfg.num_pages} "
          f"pages ({hybrid_pool(True).num_pages} in lazy mode); "
          f"{len(reqs)} requests, prompts {min(len(t) for t, _ in reqs)}-"
          f"{max(len(t) for t, _ in reqs)} tokens, "
          f"{min(g for _, g in reqs)}-{max(g for _, g in reqs)} generated",
          flush=True)
    modes = {}
    for mode, (kw, prefill_len, lazy) in HYBRID_MODES.items():
        kw = dict(kw)
        if "fault_plan" in kw:
            kw["fault_plan"] = FaultPlan(**kw["fault_plan"])
        modes[mode] = (hybrid_pool(lazy), prefill_len, kw, reqs)
    counts, tokens, stats = _engine_modes(torch, kfwd, kdecode, cfg, params,
                                          modes, "hybrid", 512)
    if stats["eager"]["pages_reclaimed"] == 0:
        fail("hybrid eager: no page left the 2048-token window")
    del params
    torch.cuda.empty_cache()
    return counts, tokens


# phase 4e: deepseek-moe-16b at full width and MOE_SERVE_LAYERS of its 28
# layers (contiguous batch 4 x (512 + 32); the paged engine on 8 of phase
# 4b's requests in its four modes, the lazy one with a storm-forced
# preemption) and dbrx-132b at full width and 2 layers (contiguous batch 2 x
# (256 + 16)); cut from 28 layers to 14 when phase 5g went to 2 layers and
# the run passed 1000 s, to 7 when phase 5h took it to 987 s (PERF.md)
MOE_SERVE_LAYERS = 7
MOE_BATCH, MOE_PROMPT, MOE_GEN, MOE_REQUESTS = 4, 512, 32, 8
DBRX_LAYERS, DBRX_BATCH, DBRX_PROMPT, DBRX_GEN = 2, 2, 256, 16
MOE_PAGED_MODES = dict(PAGED_MODES, lazy={
    "lazy": True, "fault_plan": dict(seed=3, horizon=40, events_per_kind=3,
                                     kinds=("storm",))})
# kernel and torch impl differ by ~1e-6 in attention outputs, enough to
# swap a token's k-th and (k+1)-th expert where they nearly tie: at most
# this fraction of the routing choices may flip
MOE_FLIP_TOL = 1e-3


def moe_serve_phase(torch, kfwd, kdecode):
    """Phase 4e: deepseek-moe-16b at full width and ``MOE_SERVE_LAYERS``
    layers (f32, random weights from seed 0) on the contiguous path and
    through the paged engine on one set of params, then dbrx-132b at full
    width and 2 layers on the contiguous path. Returns the kernel runs' launch counts
    by path."""
    import numpy as np

    from repro_torch import configs
    from repro_torch.serving import FaultPlan

    cfg = dataclasses.replace(configs.get_config("deepseek_moe_16b"),
                              num_layers=MOE_SERVE_LAYERS, dtype=torch.float32)
    torch.cuda.reset_peak_memory_stats()
    params = _moe_params(torch, cfg, "moe")
    contiguous = _moe_contiguous(torch, kfwd, kdecode, cfg, params, MOE_BATCH,
                                 MOE_PROMPT, MOE_GEN, "moe")
    modes = _paged_modes(np, cfg, MOE_REQUESTS, MOE_PAGED_MODES, "moe paged")
    pcfg, prefill_len, kw, reqs = modes["lazy"]
    modes["lazy"] = (pcfg, prefill_len,
                     dict(kw, fault_plan=FaultPlan(**kw["fault_plan"])), reqs)
    paged, _, _ = _engine_modes(torch, kfwd, kdecode, cfg, params, modes,
                                "moe paged", MOE_PROMPT)
    del params
    torch.cuda.empty_cache()

    dcfg = dataclasses.replace(configs.get_config("dbrx_132b"),
                               num_layers=DBRX_LAYERS, dtype=torch.float32)
    params = _moe_params(torch, dcfg, "dbrx")
    dbrx = _moe_contiguous(torch, kfwd, kdecode, dcfg, params, DBRX_BATCH,
                           DBRX_PROMPT, DBRX_GEN, "dbrx")
    del params
    torch.cuda.empty_cache()
    return {"serve": contiguous, "paged": paged, "dbrx": dbrx}


def _moe_params(torch, cfg, tag):
    from repro_torch.models import lm

    t0 = time.perf_counter()
    params = lm.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    m = cfg.moe
    n_params = sum(p.numel() for p in params.parameters())
    print(f"[{tag}] {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"heads {cfg.num_heads}/{cfg.num_kv_heads}, head_dim {cfg.head_dim}, "
          f"vocab {cfg.vocab_size}; {m.num_experts} experts top {m.top_k} "
          f"(d_ff {m.d_ff_expert}, {m.num_shared_experts} shared), capacity "
          f"factor {m.capacity_factor}, groups of {m.group_size}; "
          f"{n_params / 1e9:.3f} B params f32 = {4 * n_params / 2**30:.2f} GiB "
          f"(random, seed 0) in {time.perf_counter() - t0:.1f} s", flush=True)
    return params


def _moe_contiguous(torch, kfwd, kdecode, cfg, params, batch, prompt_len,
                    gen_len, tag):
    """An MoE arch through the contiguous serving path, kernel impl, then
    torch impl fed the kernel run's tokens, both runs' routes recorded:
    launch counters (one forward launch a layer, one decode launch a layer
    a step), routing flips at most ``MOE_FLIP_TOL`` of the choices, printed
    with their rows; the logits of every (row, step) whose tokens were
    routed alike in every layer up to then (capacity groups included)
    within ``LOGIT_REL_TOL`` of max|logit|. Prints prefill ms, decode
    tokens/s and ms a step beside the bound of reading every weight once,
    ``moe_dropped`` at prefill and peak memory. Returns the launch counts."""
    from repro_torch.launch.serve import greedy_generate
    from repro_torch.models.moe_routes import (RouteRecorder, dropped_fraction,
                                               route_diff)
    from repro_torch.runtime.steps import make_serve_steps

    n_layers = cfg.num_layers
    g = torch.Generator(device="cuda").manual_seed(0)
    prompt = torch.randint(0, cfg.vocab_size, (batch, prompt_len), generator=g,
                           device="cuda")

    def steps(impl):
        return make_serve_steps(cfg, impl=impl, max_len=prompt_len + gen_len,
                                batch=batch, torch_chunk=prompt_len,
                                device="cuda")

    torch.cuda.reset_peak_memory_stats()
    kfwd.launches = kdecode.launches = 0
    with RouteRecorder() as routes_k:
        run_k = greedy_generate(steps("kernel"), params, prompt, gen_len,
                                cfg.vocab_size)
    launches = {"flash_fwd": kfwd.launches, "flash_decode": kdecode.launches}
    peak = torch.cuda.max_memory_allocated()
    want = {"flash_fwd": n_layers, "flash_decode": n_layers * (gen_len - 1)}
    expert_bytes = sum(4 * (b.mlp.wi.numel() + b.mlp.wo.numel())
                       for b in params.blocks)
    weight_bytes = sum(4 * p.numel() for n, p in params.named_parameters()
                       if n != "embed")
    step_ms = run_k.decode_s * 1e3 / (gen_len - 1)
    print(f"[{tag}] impl=kernel: prefill {batch}x{prompt_len} "
          f"{run_k.prefill_s * 1e3:.1f} ms; decode {gen_len - 1} steps "
          f"{run_k.decode_s * 1e3:.1f} ms = {step_ms:.2f} ms a step "
          f"({(gen_len - 1) * batch / run_k.decode_s:.1f} tok/s); bound a step "
          f"{expert_bytes / HBM_BYTES_PER_S * 1e3:.2f} ms for the expert "
          f"weights ({expert_bytes / 1e9:.1f} GB: capacity 8 fills every "
          f"expert), {weight_bytes / HBM_BYTES_PER_S * 1e3:.2f} ms for every "
          f"weight but the embedding; moe_dropped at prefill "
          f"{dropped_fraction(cfg.moe, routes_k.calls[:n_layers]):.6f}; "
          f"max_memory_allocated {peak / 2**30:.2f} GiB")
    print(f"[{tag}] launch counters {launches} (expected {want})", flush=True)
    if launches != want:
        fail(f"{cfg.name}: the serving path did not go through the kernels: "
             f"{launches}")

    with RouteRecorder() as routes_t:
        run_t = greedy_generate(steps("torch"), params, prompt, gen_len,
                                cfg.vocab_size, feed=run_k.tokens)
    if {"flash_fwd": kfwd.launches, "flash_decode": kdecode.launches} != want:
        fail("impl='torch' launched a CUDA kernel")
    # a row's tokens routed otherwise at some step taint it from that step on
    # (its cache carries them)
    flips = decisions = 0
    tainted, where = [gen_len] * batch, []
    for c, (a, b) in enumerate(zip(routes_t.calls, routes_k.calls)):
        step, layer = divmod(c, n_layers)
        f, changed = route_diff(cfg.moe, a, b)
        flips += f
        decisions += a.numel()
        per_row = prompt_len if step == 0 else 1
        for row in sorted({j // per_row for j in changed.nonzero()[:, 0].tolist()}):
            tainted[row] = min(tainted[row], step)
            where.append(f"row {row} step {step} layer {layer}")
    print(f"[{tag}] routing, torch vs kernel impl: {flips} of {decisions} "
          f"choices flipped ({flips / decisions:.2e}, tol {MOE_FLIP_TOL:.0e}); "
          f"tokens routed otherwise at: {', '.join(where[:16]) or 'none'}",
          flush=True)
    if flips > MOE_FLIP_TOL * decisions:
        fail(f"{cfg.name}: {flips} of {decisions} routing choices flipped")
    worst, held = 0.0, 0
    for step, (lk, lt) in enumerate(zip(run_k.logits, run_t.logits)):
        if lk.shape != (batch, cfg.vocab_size) or \
                not bool(torch.isfinite(lk).all()):
            fail(f"{cfg.name} step {step}: logits of shape {tuple(lk.shape)} "
                 f"or not finite")
        rows = [r for r in range(batch) if tainted[r] > step]
        held += len(rows)
        if rows:
            rel = _maxerr(lk[rows], lt[rows]) / float(lt.abs().max())
            worst = max(worst, rel)
            if rel > LOGIT_REL_TOL:
                fail(f"{cfg.name} step {step}: kernel vs torch logits of rows "
                     f"{rows} differ by {rel:.3e} of max|logit|")
    match = float((run_k.tokens == run_t.tokens).float().mean())
    print(f"[{tag}] impl=torch (fed the kernel run's tokens): prefill "
          f"{run_t.prefill_s * 1e3:.1f} ms; decode {run_t.decode_s * 1e3:.1f} ms")
    print(f"[{tag}] kernel vs torch logits over prefill + {gen_len - 1} steps, "
          f"{held} of {batch * gen_len} (row, step) pairs routed alike: max |d| "
          f"/ max|logit| {worst:.3e} (tol {LOGIT_REL_TOL:.0e}); greedy token "
          f"match {match:.4f}", flush=True)
    # the kernel run's prefill above was the first on the card at these
    # shapes; once more, warm, then decode steps with and without the MoE
    # metrics, timed before the one under the profiler
    arts = steps("kernel")
    caches = arts.cache_init_fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, caches = arts.prefill_fn(params, prompt, caches)
    torch.cuda.synchronize()
    print(f"[{tag}] impl=kernel prefill again, warm: "
          f"{(time.perf_counter() - t0) * 1e3:.1f} ms", flush=True)
    _moe_metrics_share(torch, lambda: arts.decode_fn(
        params, run_k.tokens[:, 0], caches, prompt_len), tag)
    profile_step(torch, lambda: float(arts.decode_fn(
        params, run_k.tokens[:, 0], caches, prompt_len)[0].abs().max()),
        f"[{tag}] decode", "max|logit|")
    return launches


def _moe_metrics_share(torch, step, tag, calls=5, turns=3) -> None:
    """A serving step's time as it runs (``lm.forward`` with caches skips
    the MoE metrics, which the steps drop) and with ``moe.apply_moe`` made
    to compute them, in turns; prints the medians and the difference."""
    import statistics

    from repro_torch.models import moe

    apply_moe = moe.apply_moe
    times = {False: [], True: []}
    for on in (False, True) * turns:
        moe.apply_moe = (lambda *a, **kw: apply_moe(*a, **dict(kw, metrics=True))
                         ) if on else apply_moe
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                step()
            torch.cuda.synchronize()
        finally:
            moe.apply_moe = apply_moe
        times[on].append((time.perf_counter() - t0) * 1e3 / calls)
    off, on = statistics.median(times[False]), statistics.median(times[True])
    print(f"[{tag}] decode step without / with the MoE metrics ({turns} turns "
          f"of {calls} steps, medians): {off:.3f} / {on:.3f} ms, the metrics "
          f"{on - off:.3f} ms ({(on - off) / on * 100:.1f} %)", flush=True)


DIST_RANKS = 2
# phase 4i(c)'s modes of phase 4b on the sharded engine: eager, and the
# shared prefix with 256-token chunks (prefix pages shared across requests,
# chunk rows over the pool's shards)
MESH_PAGED_MODES = ("eager", "prefix_chunk")


def _dist_pool(lazy: bool, n_shards: int, ps: int = 16, slots: int = 8):
    """Phase 4b's pool with one trash page a shard: the same usable pages
    (296, or 148 lazy), so the scheduler takes the same decisions."""
    pages_per_seq = -(-(PAGED_PROMPT + PAGED_GEN) // ps) + 1
    usable = slots * pages_per_seq // (2 if lazy else 1)
    return pages_per_seq, n_shards + usable


def _record_copies(eng, pairs):
    """Keep the engine's copy-on-write (src, dst) pairs in ``pairs`` as its
    scheduler hands them out."""
    drain = eng.scheduler.tables.drain_copies

    def spy():
        got = drain()
        pairs.extend(got)
        return got

    eng.scheduler.tables.drain_copies = spy


def _collectives_probe(mesh, device) -> str:
    """gloo's (or NCCL's) all_reduce on CUDA tensors, MAX and SUM, the
    cross-shard page copy (copy-on-write) on the card, and the merge's two
    collectives alone at granite's decode shape: a line for the parent."""
    import torch
    import torch.distributed as dist

    from repro_torch.distributed import paged as dpaged

    # gloo's all_reduce on CUDA tensors, MAX and SUM, and the cross-shard
    # page copy (copy-on-write) on the card
    x = torch.full((4,), float(mesh.rank + 1), device=device)
    mx, sm = x.clone(), x.clone()
    dist.all_reduce(mx, op=dist.ReduceOp.MAX, group=mesh.group)
    dist.all_reduce(sm, op=dist.ReduceOp.SUM, group=mesh.group)
    n = mesh.size
    if not (bool((mx == n).all()) and bool((sm == n * (n + 1) / 2).all())):
        raise RuntimeError(f"{dist.get_backend(mesh.group)} all_reduce on CUDA "
                           f"tensors is wrong: MAX {mx.tolist()}, SUM {sm.tolist()}")
    base = torch.arange(24, dtype=torch.float32, device=device).view(1, 2, 3, 4)
    pool = base + 100 * mesh.rank           # two pages a shard: 2r and 2r + 1
    last = 2 * n - 1                        # swap page 1 (rank 0) and the last
    dpaged.copy_pages_sharded([pool], [1, last], [last, 1], mesh)
    peer = {0: n - 1, n - 1: 0}.get(mesh.rank, mesh.rank)
    if n < 2 or not torch.equal(pool[:, 0], base[:, 0] + 100 * mesh.rank) \
            or not torch.equal(pool[:, 1], base[:, 1] + 100 * peer):
        raise RuntimeError("copy_pages_sharded across shards is wrong on the card")
    # the merge's two collectives alone, at the decode step's shape, on an
    # idle stream: what a layer pays for the merge without waiting for work
    m = torch.zeros((8, 32), device=device)
    buf = torch.zeros((8, 32, 65), device=device)
    for i in range(110):
        if i == 10:
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=mesh.group)
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=mesh.group)
    torch.cuda.synchronize(device)
    merge_ms = (time.perf_counter() - t0) / 100 * 1e3
    probe = (f"all_reduce MAX/SUM on {device} ok, cross-shard page copy ok; "
             f"the merge's two collectives alone (m [8, 32], [acc | l] "
             f"[8, 32, 65] f32, idle stream): {merge_ms:.3f} ms a merge")
    return probe


def _dist_modes(np, cfg, n_shards: int) -> dict:
    """The sharded paged engine's modes for ``cfg``: {mode: (pool config,
    prefill row, engine kwargs, requests)}. granite-3-2b (phase 4i(c)):
    ``MESH_PAGED_MODES`` of phase 4b on its pool with one trash page a
    shard; recurrentgemma-2b (phase 4c): phase 4d's ``HYBRID_MODES`` on its
    pool so sharded, ``poison_reclaimed`` in each, ``autotune`` in eager."""
    from repro_torch.serving import FaultPlan, PagedCacheConfig

    modes = {}
    if cfg.name == "granite-3-2b":
        for mode in MESH_PAGED_MODES:
            kw = PAGED_MODES[mode]
            lazy = kw.get("lazy", False)
            pages_per_seq, num_pages = _dist_pool(lazy, n_shards)
            pcfg = PagedCacheConfig(page_size=16, max_batch=8,
                                    max_pages_per_seq=pages_per_seq,
                                    num_pages=num_pages, num_shards=n_shards)
            modes[mode] = (pcfg, PAGED_PROMPT + PAGED_GEN if lazy else PAGED_PROMPT,
                           kw, _paged_requests(np, cfg.vocab_size, mode,
                                               pcfg.max_seq_len - PAGED_GEN - 1))
        return modes
    reqs = _hybrid_requests(np, cfg.vocab_size)
    for mode, (kw, prefill_len, lazy) in HYBRID_MODES.items():
        # eager takes the planner's split count (rank 0's, broadcast)
        kw = dict(kw, poison_reclaimed=True, autotune=mode == "eager")
        if "fault_plan" in kw:
            kw["fault_plan"] = FaultPlan(**kw["fault_plan"])
        one = hybrid_pool(lazy)
        pcfg = dataclasses.replace(one, num_pages=n_shards + one.usable_pages,
                                   num_shards=n_shards)
        modes[mode] = (pcfg, prefill_len, kw, reqs)
    return modes


def _merges(tracing, t0):
    """The cross-shard decode merges since ``t0``: their count and the host
    seconds of their ``dist.merge`` spans (inside their collectives)."""
    spans = tracing.spans("dist.merge", t0=t0)
    return {"merge_calls": len(spans),
            "merge_s": sum(s.t1 - s.t0 for s in spans)}


def _dist_rank(mesh, device):
    """One rank of phase 4c: serve recurrentgemma-2b on this rank's shard of
    the weights and of the pool in each of its ``_dist_modes``. Returns per
    mode what the parent checks."""
    import numpy as np
    import torch

    from repro_torch.kernels import decode as kdecode
    from repro_torch.kernels import flash_fwd as kfwd
    from repro_torch.models import lm
    from repro_torch.runtime import tracing
    from repro_torch.runtime.steps import init_serve_params, serving_plan
    from repro_torch.serving import ServingEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    results = {}
    cfg = hybrid_paged_config(torch)
    # this rank's shard of the weights under the serving rules, drawn leaf
    # by leaf
    params = init_serve_params(cfg, serving_plan(cfg, mesh, paged=True),
                               seed=0, device=device)
    results["num_layers"] = lm.block_kinds(cfg).count("attn")
    launch = kdecode._launch_paged_valid
    for mode, (pcfg, prefill_len, kw, reqs) in _dist_modes(
            np, cfg, mesh.size).items():
        eng = ServingEngine(cfg, pcfg, params, impl="kernel", device=device,
                            mesh=mesh, prefill_len=prefill_len,
                            torch_chunk=512, **kw)
        rec = StepRecorder(torch, eng, cfg.vocab_size)
        pairs, splits = [], set()
        _record_copies(eng, pairs)

        def spy(*a):                        # a[8]: the launch's num_splits
            splits.add(a[8])
            return launch(*a)

        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        kfwd.launches = kdecode.launches = 0
        kdecode.launches_paged = kdecode.launches_paged_valid = 0
        t_merges = tracing.clock()
        kdecode._launch_paged_valid = spy
        try:
            out, stats = eng.run([(t, g) for t, g in reqs])
        finally:
            kdecode._launch_paged_valid = launch
        torch.cuda.synchronize(device)
        n_local = pcfg.num_pages // mesh.size
        results[mode] = {
            "num_splits": eng.num_splits, "launched_splits": sorted(splits),
            "autotune": kw.get("autotune", False),
            "decode_shape": eng.decode_shape(),
            "out": out, "stats": stats, "calls": dict(rec.calls),
            "margin": rec.margin, "pool": (pcfg.num_pages, n_local),
            "launches": {"flash_fwd": kfwd.launches,
                         "flash_decode": kdecode.launches,
                         "flash_paged_decode": kdecode.launches_paged,
                         "flash_paged_decode_partials": kdecode.launches_paged_valid},
            **_merges(tracing, t_merges),
            "cow_pairs": len(pairs),
            "cow_across": sum(s // n_local != d // n_local for s, d in pairs),
            "peak_gib": torch.cuda.max_memory_allocated(device) / 2**30}
        del eng
        torch.cuda.empty_cache()
    return results


def dist_serve_phase(torch, paged_tokens, n_ranks: int, backend: str):
    """recurrentgemma-2b at full width through the port's distributed paged
    engine: ``n_ranks`` ranks (by default two sharing the card, gloo), each
    holding 1/n of every layer's page pool, its shard of the weights under
    the serving rules and every recurrent state row on its share of the
    channels, in three modes (``_dist_modes``). Tokens equal on every rank
    and equal to phase 4d's single-device kernel run (or a printed
    near-tie); every request completes;
    the gated kernel launched (attention layers) × (decode + chunk + verify
    calls) on each rank, the ungated one never. Returns rank 0's gated
    launches by mode."""
    import numpy as np

    from repro_torch.launch.mesh import rank_device, run_ranks
    from repro_torch.perf import autotune

    arch, tag, modes = "recurrentgemma_2b", "[dist hybrid]", tuple(HYBRID_MODES)
    devices = [str(rank_device(r, "cuda")) for r in range(n_ranks)]
    how = ("gloo through host memory on one card, not NVLink; NCCL refuses "
           "two ranks on one card" if backend == "gloo" else
           f"{backend}, a card a rank")
    print(f"{tag} {n_ranks} ranks on {', '.join(devices)} ({how}), each with "
          f"its shard of {arch} f32 (random, seed 0; tensor parallel over "
          f"model) and 1/{n_ranks} of every layer's page "
          f"pool, every recurrent state row; modes "
          f"{', '.join(modes)}", flush=True)
    t0 = time.perf_counter()
    ranks = run_ranks(_dist_rank, n_ranks, backend=backend,
                      device_type="cuda", timeout_s=900)
    print(f"{tag} {ranks[0].get('probe', 'no probe')}; ranks done in "
          f"{time.perf_counter() - t0:.1f} s (spawn, weights, three modes)")
    n_layers = ranks[0]["num_layers"]
    launches = {"total": 0, "by_mode": {}}
    for mode in modes:
        r0 = ranks[0][mode]
        ref_out, ref_margin = paged_tokens[mode]
        for rank, res in enumerate(ranks):
            res = res[mode]
            st, c, got = res["stats"], res["calls"], res["launches"]
            steps = c["decode"] + c["chunk"] + c["verify"]
            want = {"flash_fwd": n_layers * c["prefill"], "flash_decode": 0,
                    "flash_paged_decode": 0,
                    "flash_paged_decode_partials": n_layers * steps}
            per_step = res["merge_s"] / max(st["decode_steps"], 1)
            print(f"{tag} {mode} rank {rank}: {st['generated_tokens']:.0f} "
                  f"tokens in {st['wall_s']:.3f} s = {st['tokens_per_s']:.1f} "
                  f"tokens/s; {st['decode_steps']:.0f} decode steps; calls "
                  f"prefill {c['prefill']} / decode {c['decode']} / chunk "
                  f"{c['chunk']} / verify {c['verify']}; preemptions "
                  f"{st['preemptions']:.0f}; pages reclaimed "
                  f"{st['pages_reclaimed']:.0f}; state releases "
                  f"{st['state_releases']:.0f}; pool {res['pool'][0]} pages "
                  f"({res['pool'][1]} a shard); cow {res['cow_pairs']} "
                  f"({res['cow_across']} across shards); max_memory_allocated "
                  f"{res['peak_gib']:.2f} GiB; merges {res['merge_calls']}, host "
                  f"time in their collectives {res['merge_s']:.3f} s = "
                  f"{per_step * 1e3:.2f} ms a step ({how}); launches {got} "
                  f"at splits {res['launched_splits']}"
                  + (f" (autotuned for {res['decode_shape'].key()})"
                     if res["autotune"] else ""), flush=True)
            if got != want or steps == 0:
                fail(f"{tag} {mode} rank {rank}: the path did not go through "
                     f"the gated kernel: {got}, expected {want}")
            planned = (autotune.plan_decode(res["decode_shape"]).num_splits
                       if res["autotune"] else 1)
            if res["num_splits"] != planned or \
                    res["launched_splits"] != [planned]:
                fail(f"{tag} {mode} rank {rank}: split count "
                     f"{res['num_splits']}, launched at "
                     f"{res['launched_splits']}, planned {planned}")
            if st["outcomes"]["completed"] != len(ref_out):
                fail(f"{tag} {mode} rank {rank}: outcomes {st['outcomes']}")
            if set(res["out"]) != set(r0["out"]) or any(
                    not np.array_equal(res["out"][k], r0["out"][k]) for k in r0["out"]):
                fail(f"{tag} {mode}: rank {rank}'s tokens differ from rank 0's")
        if mode == "lazy" and r0["stats"]["preemptions"] == 0:
            fail(f"{tag} lazy: no row was preempted")
        if mode == "chunk_512" and r0["calls"]["chunk"] == 0:
            fail(f"{tag} {mode}: no chunked prefill ran")
        if r0["stats"]["pages_reclaimed"] == 0:
            fail(f"{tag} {mode}: no page of the sharded pool left the window")
        same, ties = _near_ties(np, r0["out"], ref_out, ref_margin,
                                f"{tag} {mode}", "sharded")
        print(f"{tag} {mode}: tokens equal on every rank; equal to the "
              f"single-device kernel engine for {same} of {len(ref_out)} "
              f"requests" + "".join(f"; near-tie {t}" for t in ties), flush=True)
        n = r0["launches"]["flash_paged_decode_partials"]
        launches["by_mode"][mode] = n
        launches["total"] += n
    return launches


def _near_ties(np, out, ref_out, ref_margin, where: str, label: str):
    """``(requests equal, near-ties)`` of ``out`` against a single-device
    kernel run's tokens ``ref_out``: a request's tokens may differ only
    from a token whose top-2 margin in the reference run was within
    ``LOGIT_REL_TOL`` of its max|logit|, else it fails."""
    same, ties = 0, []
    for rid, toks in ref_out.items():
        diff = np.nonzero(out[rid] != toks)[0]
        if diff.size == 0:
            same += 1
            continue
        i = int(diff[0])
        margin, peak = ref_margin[(rid, i)]
        ties.append(f"request {rid} token {i}: {label} {out[rid][i]} vs one "
                    f"device {toks[i]}, margin {margin:.3e} of max|logit| "
                    f"{peak:.3e}")
        if margin > LOGIT_REL_TOL * peak:
            fail(f"{where}: {ties[-1]}: not a near-tie")
    return same, ties


def _mesh_serve_arm(torch, mesh, device, arm):
    """One rank's share of phase 4i's contiguous arm ``arm``
    (``MESH_SERVE``): its shard of the weights (drawn leaf by leaf), the
    prefill and the greedy decode steps, timed apart, with the collectives'
    host seconds, the launches of rows 1 and 4, the rows the prefill ran
    (residual and query) and the peak memory. Returns numpy and floats (no
    tensors)."""
    from repro_torch.distributed import collectives as C
    from repro_torch.kernels import decode as kdecode
    from repro_torch.kernels import flash_fwd as kfwd
    from repro_torch.runtime import tracing
    from repro_torch.runtime.steps import make_serve_steps

    _, layers, batch, prompt_len, gen_len, _ = MESH_SERVE[arm]
    cfg = _mesh_serve_cfg(torch, arm)
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    arts = make_serve_steps(cfg, max_len=prompt_len + gen_len, batch=batch,
                            torch_chunk=prompt_len, device=device, mesh=mesh)
    params = arts.init_fn(0)
    prompt = _mesh_serve_prompt(torch, cfg, batch, prompt_len)
    # the process's first prefill (its cuBLAS handles, allocator and
    # kernels' first loads on a host shared by the ranks), then a warm one,
    # whose collectives, caches and launches the arm keeps
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    arts.prefill_fn(params, prompt, arts.cache_init_fn())
    torch.cuda.synchronize(device)
    first_s = time.perf_counter() - t0
    caches = arts.cache_init_fn()
    shards = next((c.get("shards", 1) for c in caches if "k" in c), 1)
    slots = next(c["k"].shape[2] for c in caches if "k" in c)
    kfwd.launches = kdecode.launches = kdecode.launches_partials = 0
    C.stats.update(calls=0, bytes=0, seconds=0.0)
    t_merges = tracing.clock()
    torch.cuda.synchronize(device)
    arts.plan.rows_log = []
    t0 = time.perf_counter()
    logits, caches = arts.prefill_fn(params, prompt, caches)
    torch.cuda.synchronize(device)
    prefill_s = time.perf_counter() - t0
    rows = _logged_rows(arts.plan)
    prefill_coll = (C.stats["seconds"], C.stats["bytes"])
    first = logits.float().cpu().numpy()
    toks = [logits[:, :cfg.vocab_size].argmax(-1)]
    launches_prefill = kfwd.launches
    C.stats.update(calls=0, bytes=0, seconds=0.0)
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    decode_log = None
    for i in range(gen_len - 1):
        C.log = [] if i == 0 else None     # the first decode step's calls
        logits, caches = arts.decode_fn(params, toks[-1], caches, prompt_len + i)
        if i == 0:
            decode_log = C.log
        toks.append(logits[:, :cfg.vocab_size].argmax(-1))
    C.log = None
    torch.cuda.synchronize(device)
    decode_s = time.perf_counter() - t0
    return {"tokens": torch.stack(toks, 1).cpu().numpy(), "first": first,
            "first_prefill_s": first_s, "prefill_s": prefill_s,
            "decode_s": decode_s,
            "prefill_coll_s": prefill_coll[0], "prefill_coll_bytes": prefill_coll[1],
            "decode_coll_s": C.stats["seconds"],   # the merges' included
            "decode_coll_bytes": C.stats["bytes"],
            "merges": _merges(tracing, t_merges)["merge_calls"],
            "launches": {"flash_fwd": launches_prefill,
                         "flash_decode": kdecode.launches,
                         "flash_decode_partials": kdecode.launches_partials},
            "kv_seq": arts.plan.kv_seq, "shards": shards, "slots": slots,
            "rows": rows,
            "wq": tuple(next(p.shape for n, p in params.named_parameters()
                             if n.endswith("mixer.wq"))),
            "params": sum(p.numel() for p in params.parameters()),
            "held": sum(p.numel() * p.element_size() for p in params.parameters()),
            "sharded_embed": len(arts.plan.sharded_embed()),
            "decode_log": decode_log,
            "peak_gib": torch.cuda.max_memory_allocated(device) / 2**30}


def _mesh_serve_cfg(torch, arm):
    from repro_torch import configs
    arch, layers = MESH_SERVE[arm][:2]
    return dataclasses.replace(configs.get_config(arch), num_layers=layers,
                               dtype=torch.float32)


def _mesh_serve_prompt(torch, cfg, batch, prompt_len):
    g = torch.Generator(device="cuda").manual_seed(41)
    return torch.randint(0, cfg.vocab_size, (batch, prompt_len), generator=g,
                         device="cuda")


def _mesh_serve_rank(pool, device, shape):
    """One rank of phase 4i: the collectives probe on its ``model`` axis,
    granite's contiguous arm on the whole mesh, recurrentgemma-2b's on its
    data row's ``model`` axis (the ranks of data row 0; the others wait)
    and on the four ranks as one ``model`` axis (arm (d)), llava-next-34b's
    FSDP arm (e) on the whole mesh, then granite's paged engine in
    ``MESH_PAGED_MODES`` on the whole mesh."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.distributed import collectives as C
    from repro_torch.distributed.mesh import (PoolMesh, as_train_mesh,
                                              join_train_mesh)
    from repro_torch.kernels import decode as kdecode
    from repro_torch.kernels import flash_fwd as kfwd
    from repro_torch.runtime import tracing
    from repro_torch.runtime.steps import init_serve_params, serving_plan
    from repro_torch.serving import ServingEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = join_train_mesh(shape)
    out = {"coords": dict(mesh.coords),
           "probe": _collectives_probe(mesh.pool, device)}
    out["granite_3_2b"] = _mesh_serve_arm(torch, mesh, device, "granite_3_2b")
    torch.cuda.empty_cache()
    if mesh.coords["data"] == 0:
        out["recurrentgemma_2b"] = _mesh_serve_arm(
            torch, as_train_mesh(mesh.pool), device, "recurrentgemma_2b")
        torch.cuda.empty_cache()
    dist.barrier()
    world = as_train_mesh(PoolMesh(group=mesh.group(tuple(mesh.shape)),
                                   rank=mesh.rank, size=mesh.world))
    out["recurrentgemma_2b model 4"] = _mesh_serve_arm(
        torch, world, device, "recurrentgemma_2b model 4")
    torch.cuda.empty_cache()
    dist.barrier()
    out[MESH_FSDP_ARM] = _mesh_serve_arm(torch, mesh, device, MESH_FSDP_ARM)
    torch.cuda.empty_cache()
    dist.barrier()
    # granite's paged engine in MESH_PAGED_MODES, phase 4b's requests, on
    # this rank's shard of the weights and of the pool
    cfg = granite_paged_config(torch)
    params = init_serve_params(cfg, serving_plan(cfg, mesh, paged=True),
                               seed=0, device=device)
    out["paged"] = {}
    for mode, (pcfg, prefill_len, kw, reqs) in _dist_modes(
            np, cfg, mesh.size("model")).items():
        eng = ServingEngine(cfg, pcfg, params, impl="kernel", device=device,
                            mesh=mesh, prefill_len=prefill_len,
                            torch_chunk=512, **kw)
        rec = StepRecorder(torch, eng, cfg.vocab_size)
        pairs = []
        _record_copies(eng, pairs)
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        kfwd.launches = kdecode.launches = 0
        kdecode.launches_paged = kdecode.launches_paged_valid = 0
        t_merges = tracing.clock()
        C.stats.update(calls=0, bytes=0, seconds=0.0)
        res, stats = eng.run([(t, g) for t, g in reqs])
        torch.cuda.synchronize(device)
        n_local = pcfg.num_pages // mesh.size("model")
        out["paged"][mode] = {
            "out": res, "stats": stats, "calls": dict(rec.calls),
            "pool": (pcfg.num_pages, n_local),
            "wq": tuple(eng.params.blocks[0].mixer.wq.shape),
            "launches": {"flash_fwd": kfwd.launches,
                         "flash_decode": kdecode.launches,
                         "flash_paged_decode": kdecode.launches_paged,
                         "flash_paged_decode_partials": kdecode.launches_paged_valid},
            "merges": _merges(tracing, t_merges)["merge_calls"],
            "coll_s": C.stats["seconds"],   # the merges' included
            "coll_bytes": C.stats["bytes"], "cow_pairs": len(pairs),
            "cow_across": sum(s // n_local != d // n_local for s, d in pairs),
            "peak_gib": torch.cuda.max_memory_allocated(device) / 2**30}
        del eng
        torch.cuda.empty_cache()
    return out


def _mesh_fsdp_dry_check(torch, arm, rank, r, smi):
    """Arm (e)'s rank ``rank`` against the dry run of its cell on meta
    (``launch/dryrun.trace_step`` of the decode step, this process): the
    weight bytes it holds and one decode step's collectives by kind must
    be equal, and some weight must be held over data."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.distributed.mesh import dry_train_mesh
    from repro_torch.launch import dryrun
    from repro_torch.models import lm
    from repro_torch.perf.collective_analysis import collective_stats

    _, _, batch, prompt_len, gen_len, shape = MESH_SERVE[arm]
    cfg = _mesh_serve_cfg(torch, arm)
    t0 = time.perf_counter()
    dry = dryrun.trace_step(cfg, ShapeConfig(arm, prompt_len + gen_len, batch,
                                             "decode"),
                            dry_train_mesh(shape, rank))
    trace_s = time.perf_counter() - t0
    got, want = collective_stats(r["decode_log"]), collective_stats(dry["log"])
    whole = sum(p.numel() * p.element_size() for p in
                lm.LM(cfg, lm.padded_vocab(cfg, shape["model"]),
                      device="meta").parameters())
    print(f"[mesh serve] {arm} rank {rank}: weights held {r['held'] / 1e9:.4f} "
          f"GB ({r['held']} B; the dry run {dry['held']['params']} B, traced "
          f"on meta in {trace_s:.2f} s; the whole model {whole / 1e9:.4f} GB), "
          f"{r['sharded_embed']} leaf kinds with embed over data; one decode "
          f"step's collectives {got.count_by_kind}, ring bytes "
          f"{ {k: round(v) for k, v in got.bytes_by_kind.items()} } (the dry "
          f"run's {want.count_by_kind}, "
          f"{ {k: round(v) for k, v in want.bytes_by_kind.items()} }) ({smi})",
          flush=True)
    if r["held"] != dry["held"]["params"]:
        fail(f"[mesh serve] {arm} rank {rank}: holds {r['held']} B of weights, "
             f"the dry run {dry['held']['params']} B")
    if (got.count_by_kind, got.bytes_by_kind) != (want.count_by_kind,
                                                  want.bytes_by_kind):
        fail(f"[mesh serve] {arm} rank {rank}: a decode step's collectives "
             f"{got.count_by_kind} {got.bytes_by_kind}, the dry run's "
             f"{want.count_by_kind} {want.bytes_by_kind}")
    if not r["sharded_embed"] or not r["held"] < whole / 2:
        fail(f"[mesh serve] {arm} rank {rank}: no weight held over data")


def _mesh_serve_reference(torch, arm):
    """One card's run of phase 4i's contiguous arm ``arm``: tokens, the
    first logits, each generated token's top-2 margin and max|logit|, the
    same prefill with cuBLASLt's GEMMs (the f32 floor of another order of
    sums), and the times."""
    from repro_torch.launch.serve import greedy_generate
    from repro_torch.runtime.steps import make_serve_steps

    _, _, batch, prompt_len, gen_len, _ = MESH_SERVE[arm]
    cfg = _mesh_serve_cfg(torch, arm)
    arts = make_serve_steps(cfg, max_len=prompt_len + gen_len, batch=batch,
                            torch_chunk=prompt_len, device="cuda")
    params = arts.init_fn(0)
    prompt = _mesh_serve_prompt(torch, cfg, batch, prompt_len)
    res = greedy_generate(arts, params, prompt, gen_len, cfg.vocab_size)
    margin = {}
    for step, logits in enumerate(res.logits):
        rows = logits[:, :cfg.vocab_size].float()
        top = rows.topk(2, dim=-1).values
        for b, (m, p) in enumerate(zip((top[:, 0] - top[:, 1]).tolist(),
                                       rows.abs().amax(-1).tolist())):
            margin[(b, step)] = (m, p)
    first = res.logits[0].float()
    torch.backends.cuda.preferred_blas_library("cublaslt")
    try:
        lt, _ = arts.prefill_fn(params, prompt, arts.cache_init_fn())
    finally:
        torch.backends.cuda.preferred_blas_library("cublas")
    floor = float((lt.float() - first).abs().max() / first.abs().max())
    out = {"tokens": res.tokens.cpu().numpy(), "first": first.cpu().numpy(),
           "margin": margin, "floor": floor, "prefill_s": res.prefill_s,
           "decode_s": res.decode_s}
    del params, arts, res, lt, first
    torch.cuda.empty_cache()
    return out


def mesh_serve_phase(torch, paged_tokens, backend: str, smi: str):
    """Phase 4i: serving over the sharding rules (``launch/serve.py --mesh``:
    ``make_serve_steps(mesh=)`` and ``ServingEngine(mesh=)`` under
    ``ShardPlan.serving``) on four ranks sharing the card (gloo through
    host memory; with ``--dist-backend nccl`` a card a rank). (a)
    granite-3-2b contiguous on (data 2, model 2), (b) recurrentgemma-2b
    contiguous on (model 2), its ring sequence-sharded (``kv_cache_seq``),
    (d) the same on (model 4) under ``seq_full``, (e) llava-next-34b's
    FSDP weights on (data 2, model 2), its bytes and a decode step's
    collectives held to the dry run's,
    each against one card's run of the same weights and prompts: tokens
    equal (or a printed near-tie), the first logits ``MESH_SERVE_LOGIT_TOL``
    of max|logit| beside the cuBLASLt floor; (c) phase 4b's granite paged
    engine in ``MESH_PAGED_MODES`` on (data 2, model 2) with its weights
    sharded: tokens equal to phase 4b's kernel engine (or a near-tie) on
    every rank, the
    gated kernel launched (attention layers) × (decode + chunk + verify
    calls). Each arm prints prefill and decode times, tokens/s a rank, the
    collectives' host seconds, the peak memory and rows 1 and 4's launches
    a rank, beside the card's name and power limit. Returns the launches
    for phase 6."""
    import numpy as np

    from repro_torch.launch.mesh import rank_device, run_ranks

    refs, by_run = {}, {}
    for arm, (arch, *run, _) in MESH_SERVE.items():
        if tuple(run) in by_run:      # (d) serves (b)'s model and prompts
            refs[arm] = refs[by_run[tuple(run)]]
            continue
        by_run[tuple(run)] = arm
        t0 = time.perf_counter()
        refs[arm] = _mesh_serve_reference(torch, arm)
        print(f"[mesh serve] {arch} on one card: prefill "
              f"{refs[arm]['prefill_s'] * 1e3:.1f} ms, decode "
              f"{refs[arm]['decode_s'] * 1e3:.1f} ms; cuBLASLt floor of the "
              f"first logits {refs[arm]['floor']:.3e} of max|logit| "
              f"({time.perf_counter() - t0:.1f} s) ({smi})", flush=True)
    size = int(np.prod(list(MESH_SERVE_SHAPE.values())))
    devices = [str(rank_device(r, "cuda")) for r in range(size)]
    t0 = time.perf_counter()
    ranks = run_ranks(_mesh_serve_rank, size, (MESH_SERVE_SHAPE,),
                      backend=backend, device_type="cuda", timeout_s=900)
    print(f"[mesh serve] {size} ranks on {', '.join(devices)} ({backend}) over "
          f"{MESH_SERVE_SHAPE}: {ranks[0]['probe']}; ranks done in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    by_rank = {"flash_fwd": [], "flash_decode": []}
    partials = 0
    for arm, (arch, layers, batch, prompt_len, gen_len, shape) in MESH_SERVE.items():
        ref = refs[arm]
        cfg = _mesh_serve_cfg(torch, arm)
        tp = shape["model"]
        ctx = cfg.num_heads % tp != 0 and cfg.ctx_parallel_attn
        n_attn = sum(k == "attn" for k in
                     (cfg.block_pattern * layers)[:layers])
        steps = gen_len - 1
        for rank, res in enumerate(ranks):
            if arm not in res:
                continue
            r = res[arm]
            dp = shape.get("data", 1)
            got = r["launches"]
            seq = bool(r["kv_seq"])
            want = {"flash_fwd": n_attn,
                    "flash_decode": 0 if seq else n_attn * steps,
                    "flash_decode_partials": n_attn * steps if seq else 0}
            v = cfg.vocab_size       # the mesh pads the vocab to model
            err = float(np.abs(r["first"][:, :v] - ref["first"][:, :v]).max()
                        / np.abs(ref["first"][:, :v]).max())
            print(f"[mesh serve] {arch} ({layers} layers, full width) rank "
                  f"{rank} {res['coords']} on {shape}: prefill residual rows "
                  f"{r['rows']['residual']}, query rows {r['rows']['query']} "
                  f"of {prompt_len} ({'seq_full' if ctx else 'seq'}); prefill {batch}x"
                  f"{prompt_len} {r['prefill_s'] * 1e3:.1f} ms warm, the "
                  f"process's first {r['first_prefill_s'] * 1e3:.1f} ms (one "
                  f"card {ref['prefill_s'] * 1e3:.1f}), decode "
                  f"{r['decode_s'] / steps * 1e3:.2f} ms a step (one card "
                  f"{ref['decode_s'] / steps * 1e3:.2f}), "
                  f"{batch // dp * steps / r['decode_s']:.1f} tokens/s a rank "
                  f"({batch * steps / r['decode_s']:.1f} the mesh); "
                  f"collectives' host time: prefill {r['prefill_coll_s']:.3f} s "
                  f"({r['prefill_coll_bytes'] / 2**20:.1f} MiB), decode "
                  f"{r['decode_coll_s'] / steps * 1e3:.2f} ms a step "
                  f"({r['merges']} merges); {r['params'] / 1e9:.3f} B params a "
                  f"rank, wq {r['wq']}; cache {r['slots']} slots a rank "
                  f"({'kv_cache_seq, ' + str(r['shards']) + ' shards' if seq else 'kv heads split'}); "
                  f"max_memory_allocated {r['peak_gib']:.2f} GiB; launches "
                  f"{got}; first logits {err:.3e} of max|logit| (tol "
                  f"{MESH_SERVE_LOGIT_TOL:.0e}, floor {ref['floor']:.3e}) "
                  f"({smi})", flush=True)
            if got != want:
                fail(f"[mesh serve] {arm} rank {rank}: launches {got}, "
                     f"expected {want}")
            if arch == "recurrentgemma_2b" and not (seq and r["shards"] == tp):
                fail(f"[mesh serve] {arm}: decode not on kv_cache_seq over "
                     f"{tp} shards")
            want_rows = {"residual": [prompt_len // tp],
                         "query": [prompt_len // tp if ctx else prompt_len]}
            if r["rows"] != want_rows:
                fail(f"[mesh serve] {arm} rank {rank}: the prefill ran rows "
                     f"{r['rows']}, not {want_rows}")
            if err > MESH_SERVE_LOGIT_TOL or not np.isfinite(r["first"][:, :v]).all():
                fail(f"[mesh serve] {arch} rank {rank}: first logits {err:.3e} "
                     f"of max|logit|")
            diff = np.argwhere(r["tokens"] != ref["tokens"])
            if diff.size:
                b, i = map(int, diff[np.lexsort((diff[:, 0], diff[:, 1]))][0])
                m, p = ref["margin"][(b, i)]
                print(f"[mesh serve] {arch} rank {rank}: row {b} token {i}: "
                      f"mesh {r['tokens'][b, i]} vs one card "
                      f"{ref['tokens'][b, i]}, margin {m:.3e} of max|logit| "
                      f"{p:.3e}", flush=True)
                if m > LOGIT_REL_TOL * p:
                    fail(f"[mesh serve] {arm} rank {rank}: tokens differ from "
                         f"one card's, not at a near-tie")
            if arm == MESH_FSDP_ARM:
                _mesh_fsdp_dry_check(torch, arm, rank, r, smi)
            for name in by_rank:
                by_rank[name].append({"arch": arm, "rank": rank,
                                      "launches": got[name]})
            if rank == 0 and seq and tp == 2:
                partials = got["flash_decode_partials"]
        print(f"[mesh serve] {arm}: tokens of every rank equal to one card's "
              f"(or a printed near-tie)", flush=True)
    # (c) the paged engine, each mode against phase 4b's kernel run of it
    n_layers = PAGED_LAYERS
    paged = {"total": 0, "by_mode": {}}
    for mode in MESH_PAGED_MODES:
        ref_out, ref_margin = paged_tokens[mode]
        r0 = ranks[0]["paged"][mode]
        for rank, res in enumerate(ranks):
            p = res["paged"][mode]
            st, c, got = p["stats"], p["calls"], p["launches"]
            steps = c["decode"] + c["chunk"] + c["verify"]
            want = {"flash_fwd": n_layers * c["prefill"], "flash_decode": 0,
                    "flash_paged_decode": 0,
                    "flash_paged_decode_partials": n_layers * steps}
            print(f"[mesh serve] granite-3-2b paged ({n_layers} layers) {mode} "
                  f"rank {rank} {res['coords']}: {st['generated_tokens']:.0f} "
                  f"tokens in {st['wall_s']:.3f} s = {st['tokens_per_s']:.1f} "
                  f"tokens/s a rank; {st['decode_steps']:.0f} decode steps; "
                  f"calls prefill {c['prefill']} / decode {c['decode']} / chunk "
                  f"{c['chunk']} / verify {c['verify']}; wq {p['wq']}; pool "
                  f"{p['pool'][0]} pages ({p['pool'][1]} a shard); prefill "
                  f"tokens {st['prefill_tokens']:.0f} "
                  f"({st['prefill_tokens_skipped']:.0f} skipped by the shared "
                  f"prefix); cow {p['cow_pairs']} ({p['cow_across']} across "
                  f"shards); "
                  f"collectives' host time {p['coll_s']:.3f} s = "
                  f"{p['coll_s'] / max(st['decode_steps'], 1) * 1e3:.2f} ms a "
                  f"step ({p['coll_bytes'] / 2**20:.1f} MiB, {p['merges']} "
                  f"merges); max_memory_allocated {p['peak_gib']:.2f} GiB; "
                  f"launches {got} ({smi})", flush=True)
            if got != want or steps == 0:
                fail(f"[mesh serve] paged {mode} rank {rank}: the path did not "
                     f"go through the gated kernel: {got}, expected {want}")
            if st["outcomes"]["completed"] != len(ref_out):
                fail(f"[mesh serve] paged {mode} rank {rank}: outcomes "
                     f"{st['outcomes']}")
            if set(p["out"]) != set(r0["out"]) or any(
                    not np.array_equal(p["out"][k], r0["out"][k]) for k in r0["out"]):
                fail(f"[mesh serve] paged {mode}: rank {rank}'s tokens differ "
                     f"from rank 0's")
            by_rank["flash_fwd"].append({"arch": f"granite_3_2b paged {mode}",
                                         "rank": rank,
                                         "launches": got["flash_fwd"]})
        if mode == "prefix_chunk" and (
                r0["calls"]["chunk"] == 0 or
                r0["stats"]["prefill_tokens_skipped"] == 0):
            fail("[mesh serve] paged prefix_chunk: no chunked prefill ran, "
                 "or no request's prefix was shared")
        same, ties = _near_ties(np, r0["out"], ref_out, ref_margin,
                                f"[mesh serve] paged {mode}", "mesh")
        print(f"[mesh serve] granite-3-2b paged {mode}: tokens equal on every "
              f"rank; equal to phase 4b's kernel engine for {same} of "
              f"{len(ref_out)} requests" + "".join(f"; near-tie {t}" for t in ties),
              flush=True)
        n = r0["launches"]["flash_paged_decode_partials"]
        paged["by_mode"][mode] = n
        paged["total"] += n
    return {"by_rank": by_rank, "partials": partials, "paged": paged}


def planner_phase(torch, kfwd, kdecode, paged_tokens):
    """Phase 4f: the split-KV planner (``perf/autotune.py``, its H100
    record) against the card. For each decode geometry the serving paths
    launch (``perf/decode_split.GEOMETRIES``: granite-3-2b's contiguous and
    paged decodes, recurrentgemma-2b's contiguous, paged and gated
    one-shard-of-two decodes, deepseek-moe-16b's paged and dbrx-132b's
    contiguous decode, every row at its full reach, f32): the plan must be
    one of its candidates and a split ``split_layout`` keeps; at every
    candidate split the record's cluster and resident clusters must be the
    launch's (``launch_geometry``), and the kernel's output must agree with
    its plain version at that split (``TOL``); then every candidate split's
    device time (cold L2, ``decode_times``' method) is measured and the
    plan's time printed as a share of the best (not gated). Last,
    ``ServingEngine(autotune=True)`` serves phase 4b's eager requests on
    granite-3-2b at phase 4b's size: its split count must be the plan of its
    geometry, every paged-kernel launch of its decode steps must take it,
    and its tokens must equal phase 4b's kernel run up to a printed
    near-tie. Returns the measurements by geometry."""
    import numpy as np

    from repro_torch.models import lm
    from repro_torch.perf import autotune, decode_split
    from repro_torch.serving import ServingEngine

    hw = autotune.H100
    print(f"[plan] the H100 record: {hw.capacity} SMs, stream {hw.stream_bw:.4e} "
          f"B/s a block, {hw.tile_s * 1e6:.3f} us a tile, c0 {hw.c0 * 1e6:.3f} "
          f"us, c1 {hw.c1 * 1e6:.3f} us; resident clusters {hw.resident}",
          flush=True)
    out = {}
    for name, g in decode_split.GEOMETRIES.items():
        s = g.shape
        plan = autotune.plan_decode(s)
        cands = autotune.candidate_plans(s)
        skv = g.pages * s.page_size if g.pages else s.kv_len
        if (plan.num_splits, plan.block_kv) not in cands or \
                kdecode.split_layout(s.kv_len, plan.num_splits)[1] != plan.num_splits:
            fail(f"planner {name}: {plan} is not a valid candidate of {cands}")
        geos = {}
        for ns, _ in cands:
            geo = kdecode.launch_geometry(s.batch, g.hq, s.hkv, skv, ns,
                                          head_dim=s.head_dim,
                                          dtype=torch.float32,
                                          paged=g.kernel != "contig")
            c = autotune.split_cluster(s, ns)
            held = hw.resident_clusters(s.head_dim, s.dtype_bytes, c)
            if (c, held) != (geo["cluster"], geo["resident_clusters"]):
                fail(f"planner {name} at {ns} split(s): the record models "
                     f"clusters of {c}, {held} resident; the card launches "
                     f"{geo}")
            geos[ns] = geo
        errs = decode_split.check(name, [ns for ns, _ in cands])
        bad = {ns: e for ns, e in errs.items()
               if not (e[0] <= TOL["float32"] and e[1] <= LSE_TOL)}
        if bad:
            fail(f"planner {name}: the kernel disagrees with its plain version "
                 f"at splits {bad} (tol {TOL['float32']:.0e}, lse "
                 f"{LSE_TOL:.0e})")
        timed = decode_split.sweep(name)
        meas = {ns: timed(ns, bk) * 1e6 for ns, bk in cands}
        best = min(meas, key=meas.get)
        pred = {ns: autotune.predict_time(s, ns, bk) * 1e6 for ns, bk in cands}
        geo = geos[plan.num_splits]
        out[name] = {"shape": dataclasses.asdict(s), "hq": g.hq,
                     "kernel": g.kernel, "plan": plan.num_splits,
                     "predicted_us": pred, "measured_us": meas, "best": best,
                     "plan_share": meas[best] / meas[plan.num_splits],
                     "max_abs_err": errs, "geometry": geo}
        print(f"[plan] {name} ({g.kernel}, {s.key()}): plan {plan.num_splits} "
              f"split(s), predicted {plan.time_s * 1e6:.2f} us; launch "
              f"{geo['blocks']} blocks in clusters of {geo['cluster']}, "
              f"{geo['resident_clusters']} clusters resident (the record's, "
              f"at every candidate split); f32 max|o - plain| (and |lse - "
              f"plain| of the gated state) by split "
              + ", ".join(f"{ns}: {e[0]:.2e}" + (f"/{e[1]:.2e}" if e[1] else "")
                          for ns, e in errs.items())
              + f" (tol {TOL['float32']:.0e}, lse {LSE_TOL:.0e}); measured us "
              f"(device, cold L2) "
              + ", ".join(f"{ns}: {t:.2f}" for ns, t in meas.items())
              + f"; predicted us " + ", ".join(f"{ns}: {t:.2f}"
                                               for ns, t in pred.items())
              + f"; best {best} split(s) {meas[best]:.2f} us; the plan at "
              f"{out[name]['plan_share']:.3f} of the best's speed", flush=True)

    # the autotuned engine on granite-3-2b's eager mode (phase 4b's pool)
    cfg = granite_paged_config(torch)
    params = lm.init_params(cfg, seed=0, device="cuda")
    pcfg, prefill_len, _, reqs = _paged_modes(np, cfg, PAGED_REQUESTS,
                                              {"eager": {}}, "plan")["eager"]
    launched = []
    launch = kdecode._launch_paged

    def spy(q, kp, vp, bt, kv_len, window, scale, num_splits, row_tokens):
        launched.append(num_splits)
        return launch(q, kp, vp, bt, kv_len, window, scale, num_splits,
                      row_tokens)

    try:
        eng = ServingEngine(cfg, pcfg, params, impl="kernel", device="cuda",
                            prefill_len=prefill_len, torch_chunk=PAGED_PROMPT,
                            autotune=True)
        want = autotune.plan_decode(eng.decode_shape())
        kdecode._launch_paged = spy
        res, stats = eng.run([(t, n) for t, n in reqs])
        torch.cuda.synchronize()
    finally:
        kdecode._launch_paged = launch
    key = eng.decode_shape().key()
    entry = json.loads(autotune.AutotuneCache.default_path().read_text())[key]
    print(f"[plan] ServingEngine(autotune=True), granite-3-2b eager: "
          f"num_splits {eng.num_splits} (the plan of its geometry: "
          f"{want.num_splits}); {len(launched)} paged-kernel launches at "
          f"splits {sorted(set(launched))}; {stats['tokens_per_s']:.1f} "
          f"tokens/s; persisted {entry}", flush=True)
    if eng.num_splits != want.num_splits or set(launched) != {want.num_splits}:
        fail(f"planner: the autotuned engine launched at {set(launched)}, "
             f"planned {want.num_splits}")
    if stats["outcomes"]["completed"] != len(reqs):
        fail(f"planner: the autotuned engine's outcomes {stats['outcomes']}")
    ref_out, ref_margin = paged_tokens["eager"]
    same, ties = _near_ties(np, res, ref_out, ref_margin, "[plan] autotuned",
                            "autotuned")
    print(f"[plan] autotuned engine vs phase 4b's eager kernel run: tokens "
          f"equal for {same} of {len(ref_out)} requests"
          + "".join(f"; near-tie {t}" for t in ties), flush=True)
    del eng, params
    torch.cuda.empty_cache()
    return out


def train_phase(torch, kfwd, kbwd, arch="granite_3_2b"):
    """An arch at full width through the port's training path
    (``TRAIN_SETUPS``): granite-3-2b (phase 5: batch 4 x 2048, AdamW with
    its master copy, then the SMOKE ``Trainer``), recurrentgemma-2b (phase
    5b: batch 1 x 3072, AdamW without it) or deepseek-moe-16b at 4 layers
    (phase 5c: batch 2 x 2048, AdamW without it; the torch pass of (a)
    routed as the kernel pass was, the flips counted; ``moe_aux`` and
    ``moe_dropped`` a step). Returns the launch counts of the
    ``make_train_step`` run."""
    import tempfile

    from repro_torch import configs
    from repro_torch.data import DataConfig, make_batch
    from repro_torch.models import lm
    from repro_torch.models.layers import Ctx
    from repro_torch.models.moe_routes import RouteRecorder
    from repro_torch.optim import AdamWConfig, global_norm
    from repro_torch.runtime.steps import make_train_step, place_batch, step_seed
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    tag, n_batch, n_seq, leaves, master, n_layers = TRAIN_SETUPS[arch]
    cfg = dataclasses.replace(configs.get_config(arch),
                              dtype=torch.float32, dropout_rate=0.1, remat=True)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=n_layers)
    arts = make_train_step(cfg, opt=AdamWConfig(lr=1e-4, keep_master=master),
                           impl="kernel", total_steps=TRAIN_STEPS, warmup_steps=1,
                           torch_chunk=256, device="cuda")
    t0 = time.perf_counter()
    params, opt = arts.init_fn(0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    print(f"{tag} {cfg.name}: {cfg.num_layers} layers "
          f"({lm.block_kinds(cfg).count('attn')} attention), d_model {cfg.d_model}, "
          f"heads {cfg.num_heads}/{cfg.num_kv_heads}, head dim {cfg.head_dim}, "
          f"window {cfg.attn_window}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}; "
          f"{n_params / 1e9:.3f} B params f32 + AdamW m, v"
          f"{', master' if master else ''} (random, seed 0) in "
          f"{time.perf_counter() - t0:.1f} s; remat {cfg.remat}, dropout "
          f"{cfg.dropout_rate}; batch {n_batch} x {n_seq} tokens from make_batch",
          flush=True)
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=n_seq,
                    global_batch=n_batch, seed=0, frontend=cfg.frontend)
    batch = place_batch(make_batch(dc, 0), "cuda")

    # (a) one loss-and-grad pass per impl on the same params and batch; an
    # MoE arch's torch pass routes as the kernel pass did, so the two differ
    # by the attention kernels' sums only (a flipped choice would move its
    # token's expert gradients far more)
    routes = {}

    def loss_and_grads(impl):
        ctx = Ctx(impl=impl, deterministic=False, seed=step_seed(0),
                  torch_chunk=256)
        kfwd.launches = kbwd.launches_bwd = 0
        t0 = time.perf_counter()
        with RouteRecorder(routes.get("kernel")) as rec:
            loss = lm.loss_fn(cfg, params, batch, ctx)[0]
            loss.backward()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        routes[impl] = rec.calls
        if rec.decisions:
            print(f"{tag} (a) impl={impl} routed as the kernel pass: {rec.flips} "
                  f"of {rec.decisions} choices would have flipped "
                  f"({rec.flips / rec.decisions:.2e}, tol {MOE_FLIP_TOL:.0e})")
            if rec.flips > MOE_FLIP_TOL * rec.decisions:
                fail(f"{arch} training pass: {rec.flips} routing choices flipped")
        counts = (kfwd.launches, kbwd.launches_bwd)
        named = dict(params.named_parameters())
        # a frontend arch's embedding is not reached from embeds: no grad
        out = (float(loss.detach()),
               float(global_norm(p.grad for p in params.parameters()
                                 if p.grad is not None)),
               {n: named[n].grad.clone() for n in leaves}, counts, dt)
        params.zero_grad(set_to_none=True)
        return out

    n = lm.block_kinds(cfg).count("attn")
    lk, gk, leaves_k, ck, dtk = loss_and_grads("kernel")
    print(f"{tag} (a) impl=kernel: loss {lk:.6f}, grad norm {gk:.6f}, "
          f"{dtk:.2f} s; launches flash_fwd / flash_bwd {ck} (expected "
          f"{(2 * n, n)}: forward plus remat recompute)", flush=True)
    if ck != (2 * n, n):
        fail(f"the training pass did not go through the kernels: {ck}")
    lt, gt, leaves_t, ct, dtt = loss_and_grads("torch")
    print(f"{tag} (a) impl=torch (chunk 256): loss {lt:.6f}, grad norm "
          f"{gt:.6f}, {dtt:.2f} s; launches {ct}", flush=True)
    if ct != (0, 0):
        fail("impl='torch' launched a CUDA kernel")
    checks = [("loss", abs(lk - lt) / abs(lt), TRAIN_TOL["loss"]),
              ("grad norm", abs(gk - gt) / gt, TRAIN_TOL["grad_norm"])]
    for name in leaves:
        a, b = leaves_k[name], leaves_t[name]
        checks.append((f"grad {name}", _maxerr(a, b) / float(b.abs().max()),
                       TRAIN_TOL["leaf"]))
    for what, err, tol in checks:
        print(f"{tag} (a) kernel vs torch {what}: {err:.3e} (tol {tol:.0e}) "
              f"{'ok' if err <= tol else 'FAIL'}")
        if not err <= tol:
            fail(f"{arch} training pass kernel vs torch: {what} differs by {err:.3e}")
    del leaves_k, leaves_t

    # (b) the train step, as a user calls it, counters reset just before
    torch.cuda.reset_peak_memory_stats()
    kfwd.launches = kbwd.launches_bwd = 0
    times = []
    for step in range(TRAIN_STEPS):
        b = place_batch(make_batch(dc, step), "cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = arts.step_fn(params, opt, b, step)
        loss = float(m["loss"])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        moe_metrics = (f"moe_aux {float(m['moe_aux']):.6f}, moe_dropped "
                       f"{float(m['moe_dropped']):.6f}, " if "moe_aux" in m else "")
        print(f"{tag} (b) step {step}: loss {loss:.6f}, grad norm "
              f"{float(m['grad_norm']):.4f}, {moe_metrics}lr reported "
              f"{m['lr']:.2e} (the update applies AdamWConfig.lr, as the JAX "
              f"step does), {times[-1]:.3f} s", flush=True)
        if not math.isfinite(loss):
            fail(f"training step {step}: loss {loss}")
    counts = {"flash_fwd": kfwd.launches, "flash_bwd": kbwd.launches_bwd}
    want = {"flash_fwd": 2 * n * TRAIN_STEPS, "flash_bwd": n * TRAIN_STEPS}
    peak = torch.cuda.max_memory_allocated()
    warm = times[1:]
    tok_s = n_batch * n_seq * len(warm) / sum(warm)
    print(f"{tag} (b) {TRAIN_STEPS} steps of make_train_step(impl='kernel'): "
          f"step times {[round(t, 4) for t in times]} s; steps 1-{TRAIN_STEPS - 1} "
          f"mean {sum(warm) / len(warm):.4f} s = {tok_s:.1f} tokens/s; "
          f"max_memory_allocated {peak / 2**30:.2f} GiB")
    print(f"{tag} (b) launch counters {counts} (expected {want})", flush=True)
    if counts != want:
        fail(f"the {arch} training steps did not go through the kernels: {counts}")
    profile_step(torch, lambda: float(arts.step_fn(params, opt, place_batch(
        make_batch(dc, TRAIN_STEPS), "cuda"), TRAIN_STEPS)[2]["loss"]), tag)
    del params, opt, arts, batch
    torch.cuda.empty_cache()
    if arch != "granite_3_2b":
        return counts

    # (c) the Trainer at SMOKE size: 2 steps, a preemption, 2 more on resume
    scfg = dataclasses.replace(configs.smoke_config("granite_3_2b"),
                               dtype=torch.float32, dropout_rate=0.1)
    sdc = DataConfig(vocab_size=scfg.vocab_size, seq_len=128, global_batch=4,
                     seed=1, pack=True)

    def trainer(path):
        a = make_train_step(scfg, opt=AdamWConfig(lr=1e-3), impl="kernel",
                            device="cuda")
        return Trainer(arts=a, data_cfg=sdc, tcfg=TrainerConfig(
            ckpt_dir=path, ckpt_every=100, log_every=1000))

    with tempfile.TemporaryDirectory() as tmp:
        straight = trainer(f"{tmp}/a")
        r0 = straight.run(4)
        t1 = trainer(f"{tmp}/b")
        t1.hooks["pre_step"] = lambda s: t1.request_preemption() if s == 1 else None
        r1 = t1.run(4)
        t2 = trainer(f"{tmp}/b")
        r2 = t2.run(4)
    resumed = [m["loss"] for m in t1.metrics_log + t2.metrics_log]
    ref_losses = [m["loss"] for m in straight.metrics_log]
    worst = max(abs(a - b) / abs(b) for a, b in zip(resumed, ref_losses))
    # the reference pins train(N) == train(k) + resume + train(k..N) to 1e-6
    # in every parameter (tests/test_fault_tolerance.py); printed, not gated
    param_diff = max(_maxerr(a.detach(), b.detach()) for a, b in zip(
        r0["params"].parameters(), r2["params"].parameters()))
    ok = (r1["preempted"] and r1["stop_step"] == 2 and r2["stop_step"] == 4
          and len(resumed) == 4 and worst <= TRAIN_TOL["loss"])
    print(f"[train] (c) Trainer at SMOKE size on the card: preempted at step "
          f"{r1['stop_step']}, resumed to {r2['stop_step']}; losses {resumed} vs "
          f"straight {ref_losses}: max rel diff {worst:.3e}; max |param(straight) "
          f"- param(resumed)| {param_diff:.3e} (the reference's bound 1e-6) "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail("the trainer's preempt / resume run went wrong")
    return counts


def _mesh_cfg(torch, layers, arch="granite_3_2b"):
    from repro_torch import configs
    return dataclasses.replace(configs.get_config(arch),
                               num_layers=layers, dtype=torch.float32,
                               dropout_rate=0.1, remat=True)


def _mesh_opt():
    from repro_torch.optim import AdamWConfig
    return AdamWConfig(lr=1e-4, keep_master=False)


def _mesh_arts(torch, cfg, mesh, device, total_steps=MESH_RESUME_STEPS):
    from repro_torch.runtime.steps import make_train_step
    return make_train_step(cfg, mesh=mesh, opt=_mesh_opt(), impl="kernel",
                           total_steps=total_steps, warmup_steps=1,
                           torch_chunk=256, device=device)


def _mesh_data(cfg, batch=MESH_BATCH, seq=MESH_SEQ):
    from repro_torch.data import DataConfig
    return DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                      global_batch=batch, seed=0)


def _mesh_probe(torch, mesh, device) -> str:
    """all_gather_into_tensor and reduce_scatter_tensor on CUDA tensors
    under the ranks' backend, values checked (the collectives' gather and
    reduce-scatter), and ``quantize_psum`` over every rank."""
    from repro_torch.distributed import collectives as C
    from repro_torch.distributed import compression

    axes = tuple(mesh.shape)
    n = mesh.world
    x = torch.arange(6, dtype=torch.float32, device=device).view(2, 3) + 10 * mesh.rank
    full = C.gather_nograd(x, 0, mesh, axes)
    want = torch.cat([torch.arange(6, dtype=torch.float32, device=device).view(2, 3)
                      + 10 * r for r in range(n)])
    part = C.reduce_scatter_nograd(want, 0, mesh, axes)
    if not (torch.equal(full, want) and torch.equal(part, n * want[2 * mesh.rank:
                                                                  2 * mesh.rank + 2])):
        raise RuntimeError("all_gather_into_tensor / reduce_scatter_tensor on "
                           f"CUDA tensors gave wrong values on rank {mesh.rank}")
    gen = torch.Generator(device=device).manual_seed(100 + mesh.rank)
    g = torch.randn((64, 64), generator=gen, device=device) * 0.01
    exact = C.all_reduce_(g.clone(), mesh, axes) / n
    mean, err = compression.quantize_psum(g, None, torch.zeros_like(g))
    acc = mean.clone()
    for _ in range(19):
        mean_i, err = compression.quantize_psum(g, None, err)
        acc += mean_i
    one = float((mean - exact).abs().max())
    avg = float((acc / 20 - exact).abs().max())
    if not (one < 5e-4 and avg < one and bool(torch.isfinite(mean).all())):
        raise RuntimeError(f"quantize_psum on CUDA tensors: one step {one:.3e}, "
                           f"20 error-fed steps {avg:.3e}")
    return (f"all_gather_into_tensor / reduce_scatter_tensor on {device} values "
            f"ok; quantize_psum over {n} ranks: one step {one:.3e} from the "
            f"exact mean, the mean of 20 error-fed steps {avg:.3e}")


def _mesh_rank(pool, device, shape, ckpt_dir, grad_dir, steps, layers):
    """One rank of phase 5g on ``shape`` at ``layers`` layers: with
    ``grad_dir``, the collectives probe and the first step's loss and
    gradients (gathered, rank 0 saves them there as .npy by leaf), then the
    Trainer up to ``steps``, ending with a checkpoint; without, the Trainer
    from ``ckpt_dir``'s checkpoint up to ``steps``, writing none (nothing
    reads it). Launch counters reset to 0 just before the Trainer."""
    import numpy as np
    import torch

    from repro_torch.data import make_batch
    from repro_torch.distributed import collectives as C
    from repro_torch.distributed.mesh import join_train_mesh
    from repro_torch.kernels import flash_bwd as kbwd
    from repro_torch.kernels import flash_fwd as kfwd
    from repro_torch.runtime.steps import place_batch
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    mesh = join_train_mesh(shape)
    cfg = _mesh_cfg(torch, layers)
    arts = _mesh_arts(torch, cfg, mesh, device)
    dc = _mesh_data(cfg)
    plan = arts.plan
    out = {"rank": mesh.rank, "coords": mesh.coords, "hq_local": plan.hq_local,
           "head_offset": plan.head_offset,
           "kv_local": (cfg.num_kv_heads // mesh.size("model") if plan.kv
                        else cfg.num_kv_heads)}
    if grad_dir is not None:
        out["probe"] = _mesh_probe(torch, mesh, device)
        t0 = time.perf_counter()
        params, opt = arts.init_fn(0)
        batch = place_batch(make_batch(dc, 0), device, arts.shardings["batch"])
        plan.rows_log = []
        loss, _, grads = arts.grad_fn(params, batch, 0)
        out["rows"] = _logged_rows(plan)
        out["loss0"] = float(loss)
        for n, g in grads.items():
            full = arts.shardings["params"][n].gather(g)
            if mesh.rank == 0:
                np.save(os.path.join(grad_dir, n + ".npy"), full.cpu().numpy())
            del full
        out["check_s"] = time.perf_counter() - t0
        del params, opt, grads, batch
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    marks = []
    tr = Trainer(arts=arts, data_cfg=dc, batch_shardings=arts.shardings["batch"],
                 tcfg=TrainerConfig(ckpt_dir=ckpt_dir, ckpt_every=1000,
                                    log_every=1000,
                                    final_ckpt=grad_dir is not None),
                 hooks={"pre_step": lambda s: marks.append(dict(C.stats))})
    C.stats.update(calls=0, bytes=0, seconds=0.0)
    kfwd.launches = kbwd.launches_bwd = 0
    t0 = time.perf_counter()
    res = tr.run(steps)
    torch.cuda.synchronize(device)
    out.update(
        wall=time.perf_counter() - t0, start_s=time.perf_counter() - t_start,
        flash_fwd=kfwd.launches,
        flash_bwd=kbwd.launches_bwd, stop=res["stop_step"],
        losses=[(m["step"], m["loss"]) for m in tr.metrics_log],
        step_s=[m["dt"] for m in tr.metrics_log],
        step_bytes=[b["bytes"] - a["bytes"] for a, b in zip(marks, marks[1:])],
        step_coll_s=[b["seconds"] - a["seconds"] for a, b in zip(marks, marks[1:])],
        coll=dict(C.stats), peak_gib=torch.cuda.max_memory_allocated(device) / 2**30)
    return out


def _leaf_errs(torch, got, want):
    """{leaf: max |got - want| / max |want|} over ``want``'s leaves."""
    return {n: float((got[n] - w).abs().max() / w.abs().max().clamp_min(1e-30))
            for n, w in want.items()}


def _worst(errs, k=3):
    return ", ".join(f"{n} {e:.3e}" for n, e in
                     sorted(errs.items(), key=lambda kv: -kv[1])[:k])


def mesh_train_phase(torch, kfwd, kbwd, smi, layers=MESH_TRAIN_LAYERS):
    """Phase 5g: granite-3-2b at full width and ``layers`` layers
    trained over a mesh of gloo ranks sharing the card (``MESH_SHAPE`` for
    ``MESH_STEPS`` steps and a checkpoint, then an elastic resume on
    ``MESH_RESUME_SHAPE`` to ``MESH_RESUME_STEPS``), held against the
    single-device run of the same state: the step-0 loss, every gathered
    gradient leaf (and, to read the gap, the single-device gradients with
    cuBLASLt's GEMMs, which differ from cuBLAS's only in the order of their
    sums), the loss trajectory; then the kernels' batch
    and head offsets bit for bit at the training shape. Returns each rank's
    launch counts of the 2x2 run."""
    import tempfile

    import numpy as np

    from repro_torch.data import make_batch
    from repro_torch.distributed.sharding import vocab_pad_for
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.models import lm
    from repro_torch.optim import adamw_init
    from repro_torch.runtime.steps import place_batch

    tag = "[mesh train]"
    cfg = _mesh_cfg(torch, layers)
    dc = _mesh_data(cfg)
    pad = vocab_pad_for(type("M", (), {"shape": MESH_SHAPE}))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    arts = _mesh_arts(torch, cfg, None, "cuda")
    params = lm.init_params(cfg, seed=0, device="cuda", vocab_pad_to=pad)
    opt = adamw_init(params, _mesh_opt())
    n_params = sum(p.numel() for p in params.parameters())
    print(f"{tag} {cfg.name}: {cfg.num_layers} of 40 layers at full width "
          f"(heads {cfg.num_heads}/{cfg.num_kv_heads}, D {cfg.head_dim}, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab_size} padded to "
          f"{lm.padded_vocab(cfg, pad)}), {n_params / 1e9:.3f} B params f32, "
          f"dropout {cfg.dropout_rate}, remat; batch {MESH_BATCH} x {MESH_SEQ}; "
          f"AdamW without a master copy", flush=True)
    b0 = place_batch(make_batch(dc, 0), "cuda")
    loss0, _, grads = arts.grad_fn(params, b0, 0)
    loss0 = float(loss0)
    ref = {n: g.cpu() for n, g in grads.items()}
    del grads
    # the same step with cuBLASLt's GEMMs: its sums in another order
    torch.backends.cuda.preferred_blas_library("cublaslt")
    _, _, grads = arts.grad_fn(params, b0, 0)
    torch.backends.cuda.preferred_blas_library("cublas")
    floor = _leaf_errs(torch, {n: g.cpu() for n, g in grads.items()}, ref)
    del grads
    ref_losses, ref_dt = [], []
    for step in range(MESH_RESUME_STEPS):
        b = place_batch(make_batch(dc, step), "cuda")
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        params, opt, m = arts.step_fn(params, opt, b, step)
        ref_losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        ref_dt.append(time.perf_counter() - t1)
    ref_peak = torch.cuda.max_memory_allocated() / 2**30
    del params, opt, arts, b, m, b0
    torch.cuda.empty_cache()
    print(f"{tag} single-device reference: loss {loss0:.6f} at step 0; "
          f"{MESH_RESUME_STEPS} steps, losses "
          f"{[round(x, 6) for x in ref_losses]}, step times "
          f"{[round(x, 4) for x in ref_dt]} s, max_memory_allocated "
          f"{ref_peak:.2f} GiB ({smi}); {time.perf_counter() - t0:.1f} s",
          flush=True)
    print(f"{tag} single device, cuBLASLt's GEMMs against cuBLAS's (the same "
          f"step, its sums in another order): worst leaves {_worst(floor)}",
          flush=True)

    with tempfile.TemporaryDirectory() as tmp:
        grad_dir, ckpt_dir = os.path.join(tmp, "grads"), os.path.join(tmp, "ckpt")
        os.makedirs(grad_dir)
        t1 = time.perf_counter()
        ranks = run_ranks(_mesh_rank, 4, (MESH_SHAPE, ckpt_dir, grad_dir,
                                          MESH_STEPS, layers),
                          backend="gloo", device_type="cuda", timeout_s=900)
        t_2x2 = time.perf_counter() - t1
        t1 = time.perf_counter()
        resumed = run_ranks(_mesh_rank, 2, (MESH_RESUME_SHAPE, ckpt_dir, None,
                                            MESH_RESUME_STEPS, layers),
                            backend="gloo", device_type="cuda", timeout_s=900)
        t_resume = time.perf_counter() - t1
        got = {n: torch.from_numpy(np.load(os.path.join(grad_dir, n + ".npy")))
               for n in ref}
    r0 = ranks[0]
    print(f"{tag} {r0['probe']}", flush=True)
    print(f"{tag} --mesh 2x2 (4 gloo ranks on one card, through host memory): "
          f"{t_2x2:.1f} s (spawn, init, the step-0 gradients, {MESH_STEPS} "
          f"steps, the checkpoint); --mesh 2 resume (2 ranks) to step "
          f"{MESH_RESUME_STEPS}: {t_resume:.1f} s", flush=True)
    n_attn = cfg.num_layers
    for label, group, n_steps in (("2x2", ranks, MESH_STEPS),
                                  ("2 (resumed)", resumed,
                                   MESH_RESUME_STEPS - MESH_STEPS)):
        for r in group:
            want = {"flash_fwd": 2 * n_attn * n_steps, "flash_bwd": n_attn * n_steps}
            got_l = {"flash_fwd": r["flash_fwd"], "flash_bwd": r["flash_bwd"]}
            per = [f"{b / 2**30:.3f}" for b in r["step_bytes"]]
            rows = (f"residual rows {r['rows']['residual']} of {MESH_SEQ}, "
                    f"query rows {r['rows']['query']}; " if "rows" in r else "")
            print(f"{tag} --mesh {label} rank {r['rank']} {r['coords']}: q heads "
                  f"{r['hq_local']} from {r['head_offset']}, kv heads "
                  f"{r['kv_local']}; {rows}launches {got_l} (expected {want}); losses "
                  f"{[round(l, 6) for _, l in r['losses']]}; step times "
                  f"{[round(x, 4) for x in r['step_s']]} s; Trainer.run "
                  f"{r['wall']:.1f} s of the rank's {r['start_s']:.1f} s"
                  + (f" (step-0 gradients {r['check_s']:.1f} s)" if "check_s" in r else "")
                  + f"; collectives {r['coll']['calls']} calls, "
                  f"{r['coll']['bytes'] / 2**30:.3f} GiB, {r['coll']['seconds']:.3f} "
                  f"host s (the checkpoint's gathers included); a step {per} GiB "
                  f"in {[round(x, 3) for x in r['step_coll_s']]} host s; "
                  f"max_memory_allocated {r['peak_gib']:.2f} GiB ({smi})", flush=True)
            if got_l != want:
                fail(f"the mesh training path did not go through the kernels on "
                     f"rank {r['rank']}: {got_l}, expected {want}")
            if "rows" in r and r["rows"]["residual"] != [MESH_SEQ // 2]:
                fail(f"rank {r['rank']}: residual rows {r['rows']['residual']}, "
                     f"not seq over model 2's {MESH_SEQ // 2}")
            if any(not math.isfinite(l) for _, l in r["losses"]):
                fail(f"rank {r['rank']}: loss {r['losses']}")
            if r["losses"] != group[0]["losses"]:
                fail(f"rank {r['rank']}'s losses differ from rank 0's")
    errs = _leaf_errs(torch, got, ref)
    print(f"{tag} mesh against the whole batch's gradients: worst leaves "
          f"{_worst(errs)}", flush=True)
    losses = dict(r0["losses"])
    losses.update(dict(resumed[0]["losses"]))
    if sorted(losses) != list(range(MESH_RESUME_STEPS)) or \
            resumed[0]["stop"] != MESH_RESUME_STEPS:
        fail(f"the resumed run stopped at {resumed[0]['stop']}: steps {sorted(losses)}")
    traj = max(abs(losses[s] - ref_losses[s]) / abs(ref_losses[s])
               for s in range(MESH_RESUME_STEPS))
    worst = max(errs.items(), key=lambda kv: kv[1])
    checks = [("step-0 loss", abs(r0["loss0"] - loss0) / abs(loss0), 1e-5),
              (f"gathered gradient leaves ({len(errs)}, worst {worst[0]})",
               worst[1], MESH_LEAF_TOL),
              (f"loss trajectory over {MESH_RESUME_STEPS} steps", traj,
               MESH_TRAJ_TOL)]
    for what, err, tol in checks:
        print(f"{tag} mesh vs single device {what}: {err:.3e} (tol {tol:.0e}) "
              f"{'ok' if err <= tol else 'FAIL'}", flush=True)
        if not err <= tol:
            fail(f"training over the mesh: {what} differs by {err:.3e}")
    mesh_offsets_check(torch, kfwd, kbwd, tag)
    return ranks


def _family(torch, arch, mesh, device):
    """Phase 5h's (config, data, step artifacts) of ``arch``."""
    layers, batch, seq = MESH_FAMILIES[arch]
    cfg = _mesh_cfg(torch, layers, arch)
    return (cfg, _mesh_data(cfg, batch, seq),
            _mesh_arts(torch, cfg, mesh, device, MESH_FAMILY_STEPS))


def _family_reference(torch, arch, path):
    """Phase 5h's single-device run of ``arch`` (rank 0 alone on the card):
    the step-0 loss and gradients of ``init_params(0, vocab_pad_to=2)``,
    saved as .npy by leaf under ``path`` (the MoE's routes too, for the
    mesh to replay); the same gradients with cuBLASLt's GEMMs against
    them (the f32 floor of another order of sums); then
    ``MESH_FAMILY_STEPS`` steps."""
    import numpy as np

    from repro_torch.data import make_batch
    from repro_torch.models import lm, moe_routes
    from repro_torch.optim import adamw_init
    from repro_torch.runtime.steps import place_batch

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg, dc, arts = _family(torch, arch, None, "cuda")
    params = lm.init_params(cfg, seed=0, device="cuda", vocab_pad_to=2)
    b0 = place_batch(make_batch(dc, 0), "cuda")
    with moe_routes.RouteRecorder() as rec:
        loss0, _, grads = arts.grad_fn(params, b0, 0)
    os.makedirs(path)
    for n, g in grads.items():
        np.save(os.path.join(path, n + ".npy"), g.cpu().numpy())
    if cfg.moe is not None:
        torch.save([c.cpu() for c in rec.calls], os.path.join(path, "routes.pt"))
    torch.backends.cuda.preferred_blas_library("cublaslt")
    with moe_routes.RouteRecorder(replay=rec.calls):
        _, _, lt = arts.grad_fn(params, b0, 0)
    torch.backends.cuda.preferred_blas_library("cublas")
    floor = {n: float((lt[n] - g).abs().max() / g.abs().max().clamp_min(1e-30))
             for n, g in grads.items()}
    del grads, lt, b0
    opt = adamw_init(params, _mesh_opt())
    losses, dts = [], []
    for step in range(MESH_FAMILY_STEPS):
        b = place_batch(make_batch(dc, step), "cuda")
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        params, opt, m = arts.step_fn(params, opt, b, step)
        losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        dts.append(time.perf_counter() - t1)
    out = {"loss0": float(loss0), "floor": floor, "losses": losses, "step_s": dts,
           "n_params": sum(p.numel() for p in params.parameters()),
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
           "seconds": time.perf_counter() - t0}
    del params, opt, arts, b, m
    torch.cuda.empty_cache()
    return out


def _family_mesh(torch, mesh, device, arch, path):
    """Phase 5h on this rank: ``arch``'s state drawn leaf by leaf
    (``init_fn(0)``), the step-0 gradients (the MoE replaying the
    single-device routes, each rank its share) against the reference's
    leaves under ``path``, shard by shard: (max |diff|, max |ref|) a leaf;
    then, counters reset just before them, ``MESH_FAMILY_STEPS`` steps."""
    import numpy as np

    from repro_torch.data import make_batch
    from repro_torch.distributed import collectives as C
    from repro_torch.kernels import flash_bwd as kbwd
    from repro_torch.kernels import flash_fwd as kfwd
    from repro_torch.models import moe_routes
    from repro_torch.runtime.steps import place_batch

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats(device)
    cfg, dc, arts = _family(torch, arch, mesh, device)
    plan = arts.plan
    params, opt = arts.init_fn(0)
    sh = arts.shardings["batch"]
    rec = moe_routes.RouteRecorder()
    if cfg.moe is not None:
        routes = torch.load(os.path.join(path, "routes.pt"))
        rec = moe_routes.RouteRecorder(
            replay=[r.to(device) for r in routes],
            part=(mesh.index(plan.batch), plan.batch_ranks))
    plan.rows_log = []
    with rec:
        loss0, _, grads = arts.grad_fn(params, place_batch(make_batch(dc, 0),
                                                           device, sh), 0)
    rows = _logged_rows(plan)
    errs = {}
    for n, g in grads.items():
        full = np.load(os.path.join(path, n + ".npy"), mmap_mode="r")
        want = torch.from_numpy(np.ascontiguousarray(
            arts.shardings["params"][n].shard(full))).to(device)
        errs[n] = (float((g - want).abs().max()), float(want.abs().max()))
        del want
    del grads
    torch.cuda.empty_cache()
    check_s = time.perf_counter() - t0
    kfwd.launches = kbwd.launches_bwd = 0
    C.stats.update(calls=0, bytes=0, seconds=0.0)
    q_rows, restore = _spy_query_rows(kfwd, kbwd)
    losses, dts, step_bytes, step_coll = [], [], [], []
    for step in range(MESH_FAMILY_STEPS):
        mark = dict(C.stats)
        b = place_batch(make_batch(dc, step), device, sh)
        torch.cuda.synchronize(device)
        t1 = time.perf_counter()
        params, opt, m = arts.step_fn(params, opt, b, step)
        losses.append(float(m["loss"]))
        torch.cuda.synchronize(device)
        dts.append(time.perf_counter() - t1)
        step_bytes.append(C.stats["bytes"] - mark["bytes"])
        step_coll.append(C.stats["seconds"] - mark["seconds"])
    restore()
    out = {"rank": mesh.rank, "coords": mesh.coords, "hq_local": plan.hq_local,
           "head_offset": plan.head_offset, "kv_heads": plan.kv,
           "experts": (plan.experts_local, plan.expert_offset),
           "loss0": float(loss0), "errs": errs, "flips": rec.flips,
           "decisions": rec.decisions, "losses": losses, "step_s": dts,
           "step_bytes": step_bytes, "step_coll_s": step_coll,
           "flash_fwd": kfwd.launches, "flash_bwd": kbwd.launches_bwd,
           "q_rows": q_rows, "rows": rows, "coll": dict(C.stats),
           "peak_gib": torch.cuda.max_memory_allocated(device) / 2**30,
           "check_s": check_s, "seconds": time.perf_counter() - t0}
    del params, opt, arts, b, m
    torch.cuda.empty_cache()
    return out


def _logged_rows(plan):
    """The rows a rank ran (``plan.rows_log``, then off): its residual
    stream's between blocks and attention's query rows, each sorted."""
    rows = {what: sorted({n for w, n in plan.rows_log if w == what})
            for what in ("residual", "query")}
    plan.rows_log = None
    return rows


def _spy_query_rows(kfwd, kbwd):
    """Record the query rows of every launch of rows 1-3 (the wrappers
    still count each): ({"flash_fwd": [...], "flash_bwd": [...]}, a
    function that puts the wrappers' launchers back)."""
    seen = {"flash_fwd": [], "flash_bwd": []}
    fwd, bwd = kfwd._launch, kbwd.launch_bwd

    def launch(q, *a, **kw):
        seen["flash_fwd"].append(int(q.shape[2]))
        return fwd(q, *a, **kw)

    def launch_bwd(q, *a, **kw):
        seen["flash_bwd"].append(int(q.shape[2]))
        return bwd(q, *a, **kw)

    kfwd._launch, kbwd.launch_bwd = launch, launch_bwd

    def restore():
        kfwd._launch, kbwd.launch_bwd = fwd, bwd
    return seen, restore


def _family_rank(pool, device, tmp, only_ctx=False):
    """One rank of phases 5h and 5i: for each of ``MESH_FAMILIES``, rank
    0's single-device reference while the others wait, then this rank's
    part of the mesh (``MESH_SHAPE``) and, for ``MESH_CTX_ARCH``, of the
    mesh ``MESH_CTX_SHAPE`` on the same reference (phase 5i, ``"ctx"``).
    ``only_ctx``: phase 5i alone."""
    import shutil

    import torch
    import torch.distributed as dist

    from repro_torch.distributed.mesh import join_train_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    mesh = join_train_mesh(MESH_SHAPE)
    ctx_mesh = join_train_mesh(MESH_CTX_SHAPE)    # the world's group
    out = {"start_s": time.perf_counter() - t0}
    for arch in (MESH_CTX_ARCH,) if only_ctx else MESH_FAMILIES:
        path = os.path.join(tmp, arch)
        ref = _family_reference(torch, arch, path) if mesh.rank == 0 else None
        dist.barrier()
        if not only_ctx:
            out[arch] = _family_mesh(torch, mesh, device, arch, path)
            out[arch]["ref"] = ref
        if arch == MESH_CTX_ARCH:
            out["ctx"] = _family_mesh(torch, ctx_mesh, device, arch, path)
            out["ctx"]["ref"] = ref
        dist.barrier()
        if mesh.rank == 0:
            shutil.rmtree(path)
    return out


def mesh_families_phase(torch, kfwd, kbwd, smi):
    """Phase 5h: recurrentgemma-2b, deepseek-moe-16b and falcon-mamba-7b
    at full width and ``MESH_FAMILIES``' depth, each trained over 4 gloo
    ranks sharing the card (data 2 x model 2; one ``run_ranks`` launch for
    the three), held against the single-device run of the same state and
    batch: the step-0 loss (1e-5), every gradient leaf (``MESH_LEAF_TOL`` of
    its max; its shards against the single-device leaf's, max over the
    ranks: the gathered leaf's error), beside the cuBLASLt floor; the MoE's
    routing choices of the replayed step-0 pass (``MOE_FLIP_TOL``); then
    ``MESH_FAMILY_STEPS`` steps with counters reset just before them: each
    rank's launches of rows 1-3 (2 x attention layers x steps forward, 1 x
    backward), equal losses on every rank within ``MESH_TRAJ_TOL`` of the
    single-device steps', step times, collectives, peak memory; then rows
    1-3 on a rank's shard at rg's and deepseek's per-rank shapes. The same
    launch runs phase 5i's ranks on rg's reference. Returns (each family's
    ranks, phase 5i's ranks)."""
    import tempfile

    from repro_torch.launch.mesh import run_ranks
    from repro_torch.models import lm

    tag = "[mesh families]"
    torch.cuda.empty_cache()
    print(f"{tag} 4 gloo ranks on the card (data 2 x model 2), the parent "
          f"holding {torch.cuda.memory_allocated() / 2**30:.2f} GiB", flush=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        ranks = run_ranks(_family_rank, 4, (tmp,), backend="gloo",
                          device_type="cuda", timeout_s=900)
    ctx_group = [r.pop("ctx") for r in ranks]
    wall = time.perf_counter() - t0
    starts = ", ".join(f"{r['start_s']:.1f}" for r in ranks)
    print(f"{tag} one launch of 4 ranks (phase 5i's ranks in it): {wall:.1f} s "
          f"(joining the meshes "
          f"{starts} s a rank)", flush=True)
    out = {}
    for arch, (layers, batch, seq) in MESH_FAMILIES.items():
        cfg = _mesh_cfg(torch, layers, arch)
        group = [r[arch] for r in ranks]
        ref = group[0]["ref"]
        n_attn = lm.block_kinds(cfg).count("attn")
        want = {"flash_fwd": 2 * n_attn * MESH_FAMILY_STEPS,
                "flash_bwd": n_attn * MESH_FAMILY_STEPS}
        print(f"{tag} {cfg.name} ({cfg.family}): {layers} layers "
              f"({', '.join(lm.block_kinds(cfg))}) at full width, batch "
              f"{batch} x {seq}; single device: {ref['n_params'] / 1e9:.3f} B "
              f"params, loss {ref['loss0']:.6f} at step 0, step times "
              f"{[round(x, 4) for x in ref['step_s']]} s, losses "
              f"{[round(x, 6) for x in ref['losses']]}, max_memory_allocated "
              f"{ref['peak_gib']:.2f} GiB, {ref['seconds']:.1f} s ({smi})",
              flush=True)
        for r in group:
            got_l = {"flash_fwd": r["flash_fwd"], "flash_bwd": r["flash_bwd"]}
            per = [f"{b / 2**30:.3f}" for b in r["step_bytes"]]
            print(f"{tag} {cfg.name} rank {r['rank']} {r['coords']}: q heads "
                  f"{r['hq_local']} from {r['head_offset']} (kv heads split: "
                  f"{r['kv_heads']}), experts {r['experts'][0]} from "
                  f"{r['experts'][1]}; residual rows {r['rows']['residual']} "
                  f"of {seq}, query rows {r['rows']['query']} (seq over model "
                  f"2); launches {got_l} (expected {want}); "
                  f"losses {[round(x, 6) for x in r['losses']]}; step times "
                  f"{[round(x, 4) for x in r['step_s']]} s; collectives a step "
                  f"{per} GiB in {[round(x, 3) for x in r['step_coll_s']]} host "
                  f"s; max_memory_allocated {r['peak_gib']:.2f} GiB; the check "
                  f"{r['check_s']:.1f} s of the rank's {r['seconds']:.1f} s "
                  f"({smi})", flush=True)
            if got_l != want:
                fail(f"{cfg.name} over the mesh did not go through the kernels "
                     f"on rank {r['rank']}: {got_l}, expected {want}")
            if r["rows"]["residual"] != [seq // MESH_SHAPE["model"]]:
                fail(f"{cfg.name} rank {r['rank']}: residual rows "
                     f"{r['rows']['residual']}, not seq's {seq // 2}")
            if any(not math.isfinite(x) for x in r["losses"]):
                fail(f"{cfg.name} rank {r['rank']}: losses {r['losses']}")
            if r["losses"] != group[0]["losses"]:
                fail(f"{cfg.name} rank {r['rank']}'s losses differ from rank 0's")
        errs = {n: max(r["errs"][n][0] for r in group)
                / max(max(r["errs"][n][1] for r in group), 1e-30)
                for n in group[0]["errs"]}
        worst = max(errs.items(), key=lambda kv: kv[1])
        print(f"{tag} {cfg.name} mesh against one device: worst leaves "
              f"{_worst(errs)}; single device, cuBLASLt's GEMMs against "
              f"cuBLAS's (the same step, its sums in another order): worst "
              f"leaves {_worst(ref['floor'])}; at the mesh's worst leaf "
              f"{ref['floor'][worst[0]]:.3e}", flush=True)
        traj = max(abs(a - b) / abs(b) for a, b in zip(group[0]["losses"],
                                                     ref["losses"]))
        checks = [("step-0 loss", abs(group[0]["loss0"] - ref["loss0"])
                   / abs(ref["loss0"]), 1e-5),
                  (f"gradient leaves ({len(errs)}, worst {worst[0]})",
                   worst[1], MESH_LEAF_TOL),
                  (f"losses over {MESH_FAMILY_STEPS} steps", traj, MESH_TRAJ_TOL)]
        if cfg.moe is not None:
            flips = sum(r["flips"] for r in group)
            decisions = sum(r["decisions"] for r in group)
            checks.append((f"routing choices of the replayed pass ({flips} of "
                           f"{decisions})", flips / decisions, MOE_FLIP_TOL))
        for what, err, tol in checks:
            print(f"{tag} {cfg.name} mesh vs single device {what}: {err:.3e} "
                  f"(tol {tol:.0e}) {'ok' if err <= tol else 'FAIL'}", flush=True)
            if not err <= tol:
                fail(f"{cfg.name} over the mesh: {what} differs by {err:.3e}")
        out[arch] = group
    for arch, (b, hq, hkv, s, d, window, rows) in MESH_FAMILY_SHARDS.items():
        mesh_offsets_check(torch, kfwd, kbwd, f"{tag} {arch}", b, hq, hkv, s, d,
                           window, rows)
    return out, ctx_group


def mesh_ctx_phase(torch, kfwd, kbwd, smi, group=None):
    """Phase 5i: context parallelism in training. ``MESH_CTX_ARCH``
    (recurrentgemma-2b, 3 layers: rec, rec, attn; batch 2 x 3072, past the
    window; full width, f32, remat, dropout 0.1, AdamW without master) on 4
    gloo ranks sharing the card over ``MESH_CTX_SHAPE`` (model 4): its 10
    q heads do not divide 4, so attention runs under ``seq_full``, every
    head on a rank's 768 query rows against the whole sequence's K/V, and
    the residual stream under ``seq`` (768 rows a rank). Rank 0's
    single-device run of the same state first (phase 5h's reference: its
    ranks run 5i in the same launch, ``group`` their results; without it
    this phase launches the ranks for 5i alone); then every rank's step-0
    gradients against it leaf by leaf, and
    ``MESH_FAMILY_STEPS`` steps with the counters reset just before them:
    the step-0 loss (1e-5), every gradient leaf (``MESH_LEAF_TOL`` of its
    max) beside the cuBLASLt floor, the losses (``MESH_TRAJ_TOL``), each
    rank's launches of rows 1-3 and the query rows each launch saw, its
    residual rows, step times, collectives (calls, bytes, host seconds) and
    peak memory. Then rows 1-3 on the query shards at that shape
    (``ctx_shard_check``). Returns {"ranks", "rows": the query shard's
    kernel rows for phase 6}."""
    import tempfile

    from repro_torch.launch.mesh import run_ranks
    from repro_torch.models import lm

    tag = "[mesh ctx]"
    arch = MESH_CTX_ARCH
    layers, batch, seq = MESH_FAMILIES[arch]
    m = MESH_CTX_SHAPE["model"]
    cfg = _mesh_cfg(torch, layers, arch)
    print(f"{tag} {cfg.name}: 4 gloo ranks on the card over {MESH_CTX_SHAPE} "
          f"({cfg.num_heads} q heads over {cfg.num_kv_heads} kv head: "
          f"seq_full)" + ("" if group is None else ", in phase 5h's launch"),
          flush=True)
    if group is None:
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            group = [r["ctx"] for r in run_ranks(
                _family_rank, 4, (tmp, True), backend="gloo",
                device_type="cuda", timeout_s=900)]
        print(f"{tag} one launch of 4 ranks: {time.perf_counter() - t0:.1f} s",
              flush=True)
    ref = group[0]["ref"]
    n_attn = lm.block_kinds(cfg).count("attn")
    want = {"flash_fwd": 2 * n_attn * MESH_FAMILY_STEPS,
            "flash_bwd": n_attn * MESH_FAMILY_STEPS}
    print(f"{tag} {cfg.name} ({layers} layers: {', '.join(lm.block_kinds(cfg))}; "
          f"batch {batch} x {seq}) single device: {ref['n_params'] / 1e9:.3f} B "
          f"params, loss {ref['loss0']:.6f} at step 0, step times "
          f"{[round(x, 4) for x in ref['step_s']]} s, losses "
          f"{[round(x, 6) for x in ref['losses']]}, max_memory_allocated "
          f"{ref['peak_gib']:.2f} GiB, {ref['seconds']:.1f} s ({smi})", flush=True)
    rows_a_rank = seq // m
    for r in group:
        got_l = {"flash_fwd": r["flash_fwd"], "flash_bwd": r["flash_bwd"]}
        c = r["coll"]
        print(f"{tag} rank {r['rank']} {r['coords']}: q heads {r['hq_local']} "
              f"(every head: heads split {r['hq_local'] != cfg.num_heads}); "
              f"residual rows {r['rows']['residual']}, query rows "
              f"{r['rows']['query']} of {seq}; launches {got_l} (expected "
              f"{want}), query rows a launch: forward "
              f"{sorted(set(r['q_rows']['flash_fwd']))}, backward "
              f"{sorted(set(r['q_rows']['flash_bwd']))}; losses "
              f"{[round(x, 6) for x in r['losses']]}; step times "
              f"{[round(x, 4) for x in r['step_s']]} s; collectives "
              f"{c['calls']} calls, {c['bytes'] / 2**30:.3f} GiB, "
              f"{c['seconds']:.3f} host s over the {MESH_FAMILY_STEPS} steps "
              f"(a step {[round(b / 2**30, 3) for b in r['step_bytes']]} GiB in "
              f"{[round(x, 3) for x in r['step_coll_s']]} host s); "
              f"max_memory_allocated {r['peak_gib']:.2f} GiB; the check "
              f"{r['check_s']:.1f} s of the rank's {r['seconds']:.1f} s ({smi})",
              flush=True)
        if got_l != want:
            fail(f"{tag} rank {r['rank']}: the path did not go through the "
                 f"kernels: {got_l}, expected {want}")
        if (r["rows"] != {"residual": [rows_a_rank], "query": [rows_a_rank]}
                or set(r["q_rows"]["flash_fwd"]) != {rows_a_rank}
                or set(r["q_rows"]["flash_bwd"]) != {rows_a_rank}):
            fail(f"{tag} rank {r['rank']}: rows {r['rows']}, launches' query "
                 f"rows {r['q_rows']}, not {rows_a_rank} a rank")
        if any(not math.isfinite(x) for x in r["losses"]):
            fail(f"{tag} rank {r['rank']}: losses {r['losses']}")
        if r["losses"] != group[0]["losses"]:
            fail(f"{tag} rank {r['rank']}'s losses differ from rank 0's")
    errs = {n: max(r["errs"][n][0] for r in group)
            / max(max(r["errs"][n][1] for r in group), 1e-30)
            for n in group[0]["errs"]}
    worst = max(errs.items(), key=lambda kv: kv[1])
    print(f"{tag} mesh against one device: worst leaves {_worst(errs)}; single "
          f"device, cuBLASLt's GEMMs against cuBLAS's: worst leaves "
          f"{_worst(ref['floor'])}; at the mesh's worst leaf "
          f"{ref['floor'][worst[0]]:.3e}", flush=True)
    traj = max(abs(a - b) / abs(b) for a, b in zip(group[0]["losses"],
                                                 ref["losses"]))
    for what, err, tol in [
            ("step-0 loss", abs(group[0]["loss0"] - ref["loss0"])
             / abs(ref["loss0"]), 1e-5),
            (f"gradient leaves ({len(errs)}, worst {worst[0]})", worst[1],
             MESH_LEAF_TOL),
            (f"losses over {MESH_FAMILY_STEPS} steps", traj, MESH_TRAJ_TOL)]:
        print(f"{tag} mesh vs single device {what}: {err:.3e} (tol {tol:.0e}) "
              f"{'ok' if err <= tol else 'FAIL'}", flush=True)
        if not err <= tol:
            fail(f"{tag} {cfg.name} over the mesh: {what} differs by {err:.3e}")
    rows = ctx_shard_check(torch, kfwd, kbwd, tag, batch, seq, m,
                           [r["flash_fwd"] for r in group],
                           [r["flash_bwd"] for r in group])
    return {"ranks": group, "rows": rows}


def ctx_shard_check(torch, kfwd, kbwd, tag, b, s, m, fwd_launches,
                    bwd_launches):
    """Rows 1-3 on the query shards of phase 5i (B ``b``, 10/1 heads, S
    ``s``, D 256, causal, window 2048, dropout 0.1, f32; shard r its rows
    ``[r·s/m, (r+1)·s/m)`` against K/V cut to its last row): the last
    shard's o and lse bit for bit against the full call's rows, every
    shard's dQ within its atomics' rounding (``BWD_TOL``), the shards'
    dK/dV summed against the full call's (``BWD_TOL`` of max |dK|, |dV|:
    each shard's kv rows are summed apart); then the last shard's times
    (the heaviest: every row reads the whole window) beside its plain
    version, SDPA with the lower-right causal window as an explicit mask
    (``is_causal`` would align it top-left when Sq < Skv) and dropout 0.1,
    and the bound over the shard's (q, k) pairs. Returns two kernel rows
    (forward, backward) with the launches of phase 5i's ranks."""
    import torch.nn.functional as F

    hq, hkv, d, w = 10, 1, 256, 2048
    gen = torch.Generator(device="cuda").manual_seed(23)
    q, k, v = _fwd_inputs(torch, gen, b, hq, hkv, s, s, d, torch.float32)
    do = _rand(torch, gen, (b, hq, s, d), torch.float32)
    kw = dict(causal=True, window=w, dropout_rate=0.1, dropout_seed=-4242)
    o, lse = kfwd.flash_fwd(q, k, v, **kw)
    dq, dk, dv = kbwd.flash_bwd(q, k, v, o, lse, do, **kw)
    n = s // m
    dk_sum, dv_sum = torch.zeros_like(dk), torch.zeros_like(dv)
    dq_err, bits = 0.0, []
    for r in range(m):
        a, e = r * n, (r + 1) * n
        qs, dos = q[:, :, a:e].contiguous(), do[:, :, a:e].contiguous()
        ks, vs = k[:, :, :e].contiguous(), v[:, :, :e].contiguous()
        os_, lses = kfwd.flash_fwd(qs, ks, vs, **kw)
        bits.append(torch.equal(os_, o[:, :, a:e]) and torch.equal(lses, lse[:, :, a:e]))
        dqs, dks, dvs = kbwd.flash_bwd(qs, ks, vs, os_, lses, dos, **kw)
        dq_err = max(dq_err, _maxerr(dqs, dq[:, :, a:e])
                     / max(1.0, float(dq.abs().max())))
        dk_sum[:, :, :e] += dks
        dv_sum[:, :, :e] += dvs
    kv_err = max(_maxerr(got, want) / max(1.0, float(want.abs().max()))
                 for got, want in ((dk_sum, dk), (dv_sum, dv)))
    print(f"{tag} rows 1-3 on the {m} query shards (B {b}, {hq}/{hkv} heads, "
          f"{n} of {s} rows a shard, D {d}, window {w}, dropout 0.1, f32) "
          f"against the full call: o, lse "
          f"{'bit for bit' if all(bits) else 'DIFFER ' + str(bits)}; dQ "
          f"{dq_err:.3e} (tol {BWD_TOL['float32']:.0e}, atomic adds); dK, dV of "
          f"the shards summed {kv_err:.3e} (tol {BWD_TOL['float32']:.0e})",
          flush=True)
    if not (all(bits) and dq_err <= BWD_TOL["float32"]
            and kv_err <= BWD_TOL["float32"]):
        fail(f"{tag} rows 1-3 on query shards do not give the full call's rows")
    del dq, dk, dv, dk_sum, dv_sum, o, lse
    # the last shard's times: rows [s - n, s) against every key, the
    # lower-right causal window as SDPA's mask
    a = s - n
    qs, dos = q[:, :, a:].contiguous(), do[:, :, a:].contiguous()
    pos_q = torch.arange(a, s, device="cuda")[:, None]
    pos_k = torch.arange(s, device="cuda")[None, :]
    mask = (pos_k <= pos_q) & (pos_k > pos_q - w)
    pairs = int(mask.sum())
    os_, lses = kfwd.flash_fwd(qs, k, v, **kw)
    po, plse = kfwd.flash_fwd_torch(qs, k, v, **kw)
    fwd_err = _maxerr(os_, po)
    _hold("flash_fwd on the last query shard", torch.float32, fwd_err,
          TOL["float32"], tag)
    _hold("flash_fwd's lse on the last query shard", torch.float32,
          _maxerr(lses, plse), LSE_TOL, tag)
    delta = kbwd.row_delta(os_, dos)
    bkw = dict(kw, scale=d ** -0.5)
    got = kbwd.launch_bwd(qs, k, v, lses, dos, delta, **bkw)
    plain = kbwd.flash_bwd_torch(qs, k, v, lses, dos, delta, **bkw)
    bwd_err = max(_maxerr(g, gp) for g, gp in zip(got, plain))
    _hold("flash_bwd on the last query shard, relative to max(1, max|plain|),",
          torch.float32, max(_maxerr(g, gp) / max(1.0, float(gp.abs().max()))
                             for g, gp in zip(got, plain)),
          BWD_TOL["float32"], tag)
    del plain, got
    el = q.element_size()
    shape = (f"B {b}, {hq}/{hkv} heads, query rows {a}-{s} of {s} (the last of "
             f"{m} shards), D {d}, causal, window {w}, dropout 0.1, f32")
    src = "src/repro_torch/kernels/csrc/"
    fwd_row = {"name": "flash_fwd (recurrentgemma-2b query shard, seq_full)",
               "route": "cuda", "source": src + "flash_fwd.cu",
               "replaces": "src/repro/kernels/flash_fwd.py:46",
               "launches": fwd_launches[-1], "launches_by_rank": fwd_launches,
               "shape": shape, "max_abs_err": fwd_err,
               "ms": time_ms(torch, lambda: kfwd.flash_fwd(qs, k, v, **kw), 10),
               "plain_ms": time_ms(torch, lambda: kfwd.flash_fwd_torch(
                   qs, k, v, **kw), 2, warmup=1),
               **bounds(4 * b * hq * d * pairs,
                        el * (2 * b * hq * n * d + 2 * b * hkv * s * d)
                        + 4 * b * hq * n),
               "library_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(
                   qs, k, v, attn_mask=mask, dropout_p=0.1, enable_gqa=True), 10),
               "library_note": "sdpa with the lower-right causal window as a "
                               "boolean mask [rows, S], dropout 0.1, GQA by "
                               "enable_gqa"}
    qg, kg, vg = (x.clone().requires_grad_() for x in (qs, k, v))
    out = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask,
                                         dropout_p=0.1, enable_gqa=True)
    lib_ms = time_ms(torch, lambda: torch.autograd.grad(
        out, (qg, kg, vg), dos, retain_graph=True), 5)
    del qg, kg, vg, out
    bwd_flops = 10 * d * b * hq * pairs
    bwd_row = {"name": "flash_bwd (recurrentgemma-2b query shard, seq_full)",
               "route": "cuda", "source": src + "flash_bwd.cu",
               "replaces": "src/repro/kernels/flash_bwd.py:98, "
                           "src/repro/kernels/flash_bwd.py:164",
               "launches": bwd_launches[-1], "launches_by_rank": bwd_launches,
               "shape": shape, "max_abs_err": bwd_err,
               "ms": time_ms(torch, lambda: kbwd.launch_bwd(
                   qs, k, v, lses, dos, delta, **bkw), 10),
               "plain_ms": time_ms(torch, lambda: kbwd.flash_bwd_torch(
                   qs, k, v, lses, dos, delta, **bkw), 1, warmup=1),
               **bounds(bwd_flops, el * (3 * b * hq * n * d + 4 * b * hkv * s * d)
                        + 4 * 2 * b * hq * n),
               "bound_ms_3xtf32": 3 * bwd_flops / PEAK_FLOPS["float32"] * 1e3,
               "library_ms": lib_ms,
               "library_note": "sdpa backward (dq, dk, dv) with the lower-right "
                               "causal window as a boolean mask, dropout 0.1"}
    for row in (fwd_row, bwd_row):
        print(f"[times] {row['name']} ({shape}): kernel {row['ms']:.4f} ms, plain "
              f"{row['plain_ms']:.4f} ms, sdpa with the lower-right mask "
              f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
              f"({row['bound_by']}; {pairs} (q, k) pairs a head), max_abs_err "
              f"{row['max_abs_err']:.3e}; launches a rank in phase 5i "
              f"{row['launches_by_rank']}", flush=True)
    del q, k, v, do, qs, dos, os_, lses, po, plse, delta, mask
    torch.cuda.empty_cache()
    return [fwd_row, bwd_row]


def mesh_offsets_check(torch, kfwd, kbwd, tag, b=MESH_BATCH, hq=32, hkv=8,
                       s=MESH_SEQ, d=64, window=None, rows=(2, 4)):
    """Rows 1-3 at a training shape (f32, causal, dropout 0.1; granite's by
    default: B 4, 32/8 heads, S 2048, D 64) on the shards of the 2x2 mesh's
    ranks at data index 1 (batch ``rows``), one a model rank: its q heads
    and the kv heads they read, with its offsets. o, lse and dQ are each
    shard's slice of the full call's (o, lse bit for bit, dQ within the f32
    rounding of its atomic adds, ``BWD_TOL``); dK and dV summed over the
    shards (as the mesh sums them over model) are the full call's, bit for
    bit where each kv head is one shard's, within ``BWD_TOL`` where a
    replicated kv head serves q heads of both; and model rank 1's shard
    against the plain versions with the same offsets (``TOL``,
    ``LSE_TOL``, ``BWD_TOL``)."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    q, k, v = _fwd_inputs(torch, gen, b, hq, hkv, s, s, d, torch.float32)
    do = _rand(torch, gen, (b, hq, s, d), torch.float32)
    kw = dict(causal=True, window=window, dropout_rate=0.1,
              dropout_seed=-1234567)
    o, lse = kfwd.flash_fwd(q, k, v, **kw)
    dq, dk, dv = kbwd.flash_bwd(q, k, v, o, lse, do, **kw)
    b0, b1 = rows
    group, hl = hq // hkv, hq // 2
    dk_sum = torch.zeros_like(dk[b0:b1])
    dv_sum = torch.zeros_like(dv[b0:b1])
    bits, dq_err, other = True, 0.0, True
    for h0 in (0, hl):
        k0, k1 = h0 // group, (h0 + hl - 1) // group + 1
        sl, kl = (slice(b0, b1), slice(h0, h0 + hl)), (slice(b0, b1), slice(k0, k1))
        qs, dos = q[sl].contiguous(), do[sl].contiguous()
        ks, vs = k[kl].contiguous(), v[kl].contiguous()
        off = dict(batch_offset=b0, head_offset=h0)
        os_, lses = kfwd.flash_fwd(qs, ks, vs, **kw, **off)
        dqs, dks, dvs = kbwd.flash_bwd(qs, ks, vs, os_, lses, dos, **kw, **off)
        dk_sum[:, k0:k1] += dks
        dv_sum[:, k0:k1] += dvs
        dq_err = max(dq_err, _maxerr(dqs, dq[sl]) / max(1.0, float(dq.abs().max())))
        bits = bits and torch.equal(os_, o[sl]) and torch.equal(lses, lse[sl])
        other = other and not torch.equal(kfwd.flash_fwd(qs, ks, vs, **kw)[0], o[sl])
    shared = hl % group != 0 or hkv < 2       # a kv head read by both shards
    kv_err = max(_maxerr(a, w) / max(1.0, float(w.abs().max()))
                 for a, w in ((dk_sum, dk[b0:b1]), (dv_sum, dv[b0:b1])))
    kv_ok = (kv_err <= BWD_TOL["float32"] if shared else
             torch.equal(dk_sum, dk[b0:b1]) and torch.equal(dv_sum, dv[b0:b1]))
    po, plse = kfwd.flash_fwd_torch(qs, ks, vs, **kw, **off)
    plain = kbwd.flash_bwd_torch(qs, ks, vs, lses, dos, kbwd.row_delta(os_, dos),
                                 **kw, **off)
    p_err = [_maxerr(os_, po), _maxerr(lses, plse)] + [
        _maxerr(g, gp) / max(1.0, float(gp.abs().max()))
        for g, gp in zip((dqs, dks, dvs), plain)]
    p_tol = [TOL["float32"], LSE_TOL] + [BWD_TOL["float32"]] * 3
    print(f"{tag} offsets (batch {b0}, heads 0 and {hl}; B {b1 - b0}, {hl}/"
          f"{k1 - k0} heads a shard, G {hl // (k1 - k0)}, S {s}, D {d}, window "
          f"{window}) on the card: o, lse {'bit for bit' if bits else 'DIFFER'}; "
          f"dQ {dq_err:.3e} (tol {BWD_TOL['float32']:.0e}, atomic adds); dK, dV "
          f"summed over the shards "
          + (f"{kv_err:.3e} (tol {BWD_TOL['float32']:.0e}, a kv head both "
             f"shards read)" if shared else
             ('bit for bit' if kv_ok else 'DIFFER'))
          + f"; without the offsets the shards' o {'differs' if other else 'is EQUAL'}"
          f"; model rank 1's shard against the plain versions with the offsets "
          f"o, lse, dQ, dK, dV {', '.join(f'{e:.3e}' for e in p_err)}", flush=True)
    if not (bits and kv_ok and other and dq_err <= BWD_TOL["float32"]):
        fail("the kernels' batch / head offsets do not give the full call's masks")
    if not all(e <= t for e, t in zip(p_err, p_tol)):
        fail(f"rows 1-3 on a mesh shard disagree with their plain versions: "
             f"{p_err}")


def _top2(logits, vocab: int):
    """(top-2 margins, max |logit|) of each row of ``logits [B, Vpad]``."""
    rows = logits[:, :vocab].float()
    top = rows.topk(2, dim=-1).values
    return (top[:, 0] - top[:, 1]).tolist(), rows.abs().amax(dim=-1).tolist()


def mamba_pool(lazy: bool):
    """Phase 4g's page pool: page 16, 8 slots, 67 pages a sequence; the
    whole pool holds every slot's budget, the lazy one half of it. No layer
    reads a page (the arch has no attention layer); the scheduler's page
    lifecycle runs all the same."""
    from repro_torch.serving import PagedCacheConfig

    ps, slots = 16, 8
    pages_per_seq = -(-(MAMBA_PROMPT + MAMBA_GEN) // ps) + 1         # 67
    full = 1 + slots * pages_per_seq                                 # 537
    return PagedCacheConfig(page_size=ps, max_batch=slots,
                            max_pages_per_seq=pages_per_seq,
                            num_pages=(full - 1) // 2 + 1 if lazy else full)


def mamba_serve_phase(torch):
    """Phase 4g: falcon-mamba-7b at full width and ``MAMBA_LAYERS`` layers.
    (a) The contiguous
    path at batch 4 x (1024 + 32): every step's logits held to one full
    forward over prompt and fed tokens (padded to a multiple of the scan's
    256-token chunk; the scan is causal, so the padding moves no earlier
    position), at ``LOGIT_REL_TOL`` of max|logit|; a profiled decode step.
    (b) The paged engine in ``MAMBA_MODES`` on ``MAMBA_REQUESTS`` seeded
    requests against each prompt's single-sequence greedy run on the
    contiguous path, tokens equal up to a printed near-tie; the engine's
    refusals."""
    import numpy as np

    from repro_torch import configs
    from repro_torch.launch.serve import greedy_generate
    from repro_torch.models import lm
    from repro_torch.models.layers import Ctx
    from repro_torch.runtime.steps import make_serve_steps
    from repro_torch.serving import FaultPlan, ServingEngine

    tag = "[ssm]"
    cfg = dataclasses.replace(configs.get_config("falcon_mamba_7b"),
                              num_layers=MAMBA_LAYERS,
                              dtype=torch.float32)   # as launch/serve.py forces
    mc = cfg.mamba
    if lm.block_kinds(cfg) != ["ssm"] * cfg.num_layers:
        fail(f"falcon-mamba-7b: block kinds {set(lm.block_kinds(cfg))}")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    print(f"{tag} {cfg.name}: {cfg.num_layers} mixer-only Mamba layers (no "
          f"attention layer, no kernel of the port), d_model {cfg.d_model}, "
          f"d_inner {mc.d_inner}, ssm_state {mc.ssm_state}, conv "
          f"{mc.conv_kernel}, dt_rank {mc.dt_rank}, vocab {cfg.vocab_size}; "
          f"{n_params / 1e9:.3f} B params f32 (random, seed 0) in "
          f"{time.perf_counter() - t0:.1f} s; every scan length a multiple "
          f"of the 256-token chunk", flush=True)

    # (a) the contiguous path, then the step-equals-scan identity
    b, s, g = MAMBA_BATCH, MAMBA_PROMPT, MAMBA_GEN

    def steps(batch, prompt_len):
        return make_serve_steps(cfg, impl="kernel", max_len=prompt_len + g,
                                batch=batch, device="cuda")

    gen = torch.Generator(device="cuda").manual_seed(0)
    prompt = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                           device="cuda")
    arts = steps(b, s)
    run = greedy_generate(arts, params, prompt, g, cfg.vocab_size)
    state_bytes = 4 * cfg.num_layers * b * (mc.d_inner * mc.ssm_state
                                            + (mc.conv_kernel - 1) * mc.d_inner)
    # a decode step reads every weight and state row once and writes the
    # state rows and the logits once
    step_bytes = 4 * n_params + 2 * state_bytes + 4 * b * cfg.vocab_size
    bound_ms = step_bytes / HBM_BYTES_PER_S * 1e3
    step_ms = run.decode_s / (g - 1) * 1e3
    print(f"{tag} (a) contiguous: prefill {b}x{s} {run.prefill_s * 1e3:.1f} "
          f"ms; decode {g - 1} steps {run.decode_s * 1e3:.1f} ms = "
          f"{step_ms:.2f} ms a step ({(g - 1) * b / run.decode_s:.1f} "
          f"tokens/s) against the bound of moving {step_bytes / 1e9:.2f} GB "
          f"a step at {HBM_BYTES_PER_S / 1e12:.2f} TB/s, {bound_ms:.2f} ms "
          f"({step_ms / bound_ms:.2f}x); max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    fed = torch.cat([prompt, run.tokens[:, :g - 1]], dim=1)
    width = -(-fed.shape[1] // 256) * 256
    tokens = torch.cat([fed, fed.new_zeros((b, width - fed.shape[1]))], dim=1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.inference_mode():
        full = lm.forward(cfg, params, Ctx(impl="kernel"), tokens=tokens)[0]
    torch.cuda.synchronize()
    worst = 0.0
    for j, lk in enumerate(run.logits):
        ref = full[:, s - 1 + j, :cfg.vocab_size]
        if lk.shape != (b, cfg.vocab_size) or not bool(torch.isfinite(lk).all()):
            fail(f"falcon-mamba-7b step {j}: logits of shape "
                 f"{tuple(lk.shape)} or not finite")
        rel = _maxerr(lk[:, :cfg.vocab_size], ref) / float(ref.abs().max())
        worst = max(worst, rel)
        if rel > LOGIT_REL_TOL:
            fail(f"falcon-mamba-7b step {j}: the decode step's logits differ "
                 f"from the full forward's by {rel:.3e} of max|logit| (tol "
                 f"{LOGIT_REL_TOL:.0e})")
    print(f"{tag} (a) step = scan: prefill + {g - 1} decode steps against one "
          f"full forward over {b}x{width} tokens ({fed.shape[1]} fed, padded "
          f"to the chunk; {time.perf_counter() - t0:.2f} s): max |d| / "
          f"max|logit| {worst:.3e} (tol {LOGIT_REL_TOL:.0e})", flush=True)
    del full
    caches = arts.cache_init_fn()
    tok = run.tokens[:, 0]
    arts.decode_fn(params, tok, caches, s)
    profile_step(torch, lambda: float(arts.decode_fn(params, tok, caches, s)[0]
                                      .abs().max()), tag, "max|logit|")
    del caches, run, arts
    torch.cuda.empty_cache()

    # (b) the paged engine against each prompt's single-sequence greedy run
    rs = np.random.RandomState(2)
    reqs = [(rs.randint(0, cfg.vocab_size, size=256 * int(rs.randint(1, 5))),
             g) for _ in range(MAMBA_REQUESTS)]
    ref_out, ref_margin = {}, {}
    t0 = time.perf_counter()
    for rid, (toks, _) in enumerate(reqs):
        one = greedy_generate(steps(1, len(toks)), params,
                              torch.as_tensor(toks, device="cuda")[None], g,
                              cfg.vocab_size)
        ref_out[rid] = one.tokens[0].cpu().numpy()
        for j, lk in enumerate(one.logits):
            (m,), (p,) = _top2(lk, cfg.vocab_size)
            ref_margin[(rid, j)] = (m, p)
    pool = mamba_pool(False)
    print(f"{tag} (b) {len(reqs)} requests, prompts "
          f"{[len(t) for t, _ in reqs]} tokens, {g} generated each; their "
          f"single-sequence greedy runs on the contiguous path in "
          f"{time.perf_counter() - t0:.1f} s; page {pool.page_size}, "
          f"{pool.max_batch} slots, pool {pool.num_pages} pages "
          f"({mamba_pool(True).num_pages} lazy); near-tie tolerance: top-2 "
          f"margin <= {LOGIT_REL_TOL:.0e} x max|logit|", flush=True)
    for kw in ({"share_prefix": True}, {"speculate_k": 4}, {"autotune": True}):
        try:
            ServingEngine(cfg, pool, params, device="cuda", **kw)
        except ValueError as e:
            print(f"{tag} (b) {kw} refused: {e}")
        else:
            fail(f"falcon-mamba-7b: the engine accepted {kw}")
    for mode, (kw, prefill_len, lazy) in MAMBA_MODES.items():
        kw = dict(kw)
        if "fault_plan" in kw:
            kw["fault_plan"] = FaultPlan(**kw["fault_plan"])
        eng = ServingEngine(cfg, mamba_pool(lazy), params, impl="kernel",
                            device="cuda", prefill_len=prefill_len, **kw)
        if eng._pools():
            fail("falcon-mamba-7b: the engine holds a page pool")
        torch.cuda.reset_peak_memory_stats()
        out, stats = eng.run(list(reqs))
        torch.cuda.synchronize()
        print(f"{tag} (b) {mode}: {stats['generated_tokens']:.0f} tokens in "
              f"{stats['wall_s']:.3f} s = {stats['tokens_per_s']:.1f} "
              f"tokens/s; {stats['decode_steps']:.0f} decode steps; "
              f"preemptions {stats['preemptions']:.0f}; state releases "
              f"{stats['state_releases']:.0f}; prefill tokens "
              f"{stats['prefill_tokens']:.0f}; max_memory_allocated "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
              flush=True)
        if stats["outcomes"]["completed"] != len(reqs):
            fail(f"falcon-mamba-7b {mode}: outcomes {stats['outcomes']}")
        if lazy and stats["preemptions"] == 0:
            fail(f"falcon-mamba-7b {mode}: the lazy mode preempted no row")
        if stats["state_releases"] != len(reqs) + stats["preemptions"]:
            fail(f"falcon-mamba-7b {mode}: {stats['state_releases']} state "
                 f"releases for {len(reqs)} requests and "
                 f"{stats['preemptions']} preemptions")
        same, ties = _near_ties(np, out, ref_out, ref_margin,
                                f"falcon-mamba-7b {mode}", "engine")
        print(f"{tag} (b) {mode}: tokens equal to the single-sequence runs "
              f"for {same} of {len(reqs)} requests"
              + "".join(f"; near-tie {t}" for t in ties), flush=True)
        del eng
    print(f"{tag} peak max_memory_allocated of the last mode "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    del params
    torch.cuda.empty_cache()


def mamba_train_phase(torch):
    """Phase 5d: falcon-mamba-7b's training at full width and
    ``MAMBA_TRAIN_LAYERS`` layers (4 steps, a profiled one), then one
    full-width Mamba layer's output and input and weight gradients from the
    chunked scan against the sequential step loop (``_ssm_steps``, swapped
    in for ``_ssm_scan``), each within ``MAMBA_GRAD_TOL`` of the leaf's
    max."""
    from repro_torch import configs
    from repro_torch.data import DataConfig, make_batch
    from repro_torch.models import mamba
    from repro_torch.models.layers import Ctx
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime.steps import make_train_step, place_batch

    tag = "[ssm train]"
    cfg = dataclasses.replace(configs.get_config("falcon_mamba_7b"),
                              dtype=torch.float32, remat=True,
                              num_layers=MAMBA_TRAIN_LAYERS)
    n_batch, n_seq = MAMBA_TRAIN_BATCH, MAMBA_TRAIN_SEQ
    arts = make_train_step(cfg, opt=AdamWConfig(lr=1e-4, keep_master=False),
                           impl="kernel", total_steps=TRAIN_STEPS,
                           warmup_steps=1, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, opt = arts.init_fn(0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    print(f"{tag} {cfg.name}: {cfg.num_layers} of 64 layers at full width; "
          f"{n_params / 1e9:.3f} B params f32 + AdamW m, v (random, seed 0) "
          f"in {time.perf_counter() - t0:.1f} s; remat {cfg.remat}; batch "
          f"{n_batch} x {n_seq} tokens from make_batch (scan chunks of 256)",
          flush=True)
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=n_seq,
                    global_batch=n_batch, seed=0)
    times = []
    for step in range(TRAIN_STEPS):
        batch = place_batch(make_batch(dc, step), "cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = arts.step_fn(params, opt, batch, step)
        loss = float(m["loss"])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        print(f"{tag} step {step}: loss {loss:.6f}, grad norm "
              f"{float(m['grad_norm']):.4f}, {times[-1]:.3f} s", flush=True)
        if not math.isfinite(loss):
            fail(f"falcon-mamba-7b training step {step}: loss {loss}")
    warm = times[1:]
    print(f"{tag} {TRAIN_STEPS} steps of make_train_step: step times "
          f"{[round(t, 4) for t in times]} s; steps 1-{TRAIN_STEPS - 1} mean "
          f"{sum(warm) / len(warm):.4f} s = "
          f"{n_batch * n_seq * len(warm) / sum(warm):.1f} tokens/s; "
          f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.2f}"
          f" GiB", flush=True)
    profile_step(torch, lambda: float(arts.step_fn(params, opt, place_batch(
        make_batch(dc, TRAIN_STEPS), "cuda"), TRAIN_STEPS)[2]["loss"]), tag)
    del params, opt, arts, batch
    torch.cuda.empty_cache()

    # one full-width layer: the chunked scan against the step loop
    gen = torch.Generator(device="cuda").manual_seed(1)
    layer = mamba.init_mamba(gen, cfg, torch.float32)
    x = torch.randn((1, MAMBA_CHECK_SEQ, cfg.d_model), generator=gen,
                    device="cuda")
    w = torch.randn(x.shape, generator=gen, device="cuda")

    def pass_with(scan):
        mamba._ssm_scan = scan
        xg = x.clone().requires_grad_()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = mamba.apply_mamba(layer, xg, Ctx(impl="kernel"), cfg)[0]
        (out * w).sum().backward()
        torch.cuda.synchronize()
        grads = {n: q.grad for n, q in layer.named_parameters()}
        grads["x"] = xg.grad
        layer.zero_grad(set_to_none=True)
        return out.detach(), grads, time.perf_counter() - t0

    chunked = mamba._ssm_scan
    try:
        out_c, g_c, t_c = pass_with(chunked)
        out_s, g_s, t_s = pass_with(mamba._ssm_steps)
    finally:
        mamba._ssm_scan = chunked
    checks = [("output", _maxerr(out_c, out_s) / float(out_s.abs().max()))]
    checks += [(f"grad {n}", _maxerr(g_c[n], g) / float(g.abs().max()))
               for n, g in g_s.items()]
    print(f"{tag} one layer at batch 1 x {MAMBA_CHECK_SEQ} (two scan chunks): "
          f"chunked scan {t_c:.3f} s, step loop {t_s:.3f} s (forward and "
          f"backward); relative to each leaf's max (tol "
          f"{MAMBA_GRAD_TOL:.0e}): "
          + ", ".join(f"{n} {e:.3e}" for n, e in checks), flush=True)
    for what, err in checks:
        if not err <= MAMBA_GRAD_TOL:
            fail(f"falcon-mamba-7b layer, chunked scan vs step loop: {what} "
                 f"differs by {err:.3e} of its max")
    del layer, out_c, out_s, g_c, g_s
    torch.cuda.empty_cache()


def vlm_serve_phase(torch, kfwd, kdecode):
    """Phase 4h: llava-next-34b (the vlm family) at full width and
    ``VLM_LAYERS`` layers, f32, random weights from seed 0, one set of
    params for both caches. (a) The contiguous path at batch 4 x (1024 +
    32), prefilled from a token prompt and then from patch embeddings
    (``embeds`` [4, 1024, 1024] from ``make_batch``, the vision path),
    decoding by tokens: kernel impl, then torch impl fed the kernel run's
    tokens; counters one ``flash_fwd`` a layer and one ``flash_decode`` a
    layer a step; logits within ``LOGIT_REL_TOL``; where the torch run's
    token differs, the kernel run's top-2 margin must be a near-tie. (b) The
    paged engine on ``VLM_REQUESTS`` seeded requests in ``VLM_MODES``
    (``_engine_modes``). Prints prefill ms, ms a decode step beside the
    bound of reading the weights and the cache once, tokens/s, peak memory.
    Returns the kernel runs' launch counts by path."""
    import numpy as np

    from repro_torch import configs
    from repro_torch.data import DataConfig, make_batch
    from repro_torch.launch.serve import greedy_generate
    from repro_torch.models import lm
    from repro_torch.runtime.steps import make_serve_steps
    from repro_torch.serving import PagedCacheConfig

    tag = "[vlm]"
    cfg = dataclasses.replace(configs.get_config("llava_next_34b"),
                              num_layers=VLM_LAYERS, dtype=torch.float32)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    print(f"{tag} {cfg.name}: {cfg.num_layers} of 60 layers at full width, "
          f"d_model {cfg.d_model}, heads {cfg.num_heads}/{cfg.num_kv_heads} (a "
          f"GQA group of {cfg.num_heads // cfg.num_kv_heads}), head_dim "
          f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, frontend_proj "
          f"[{lm.FRONTEND_DIM}, {cfg.d_model}]; {n_params / 1e9:.3f} B params f32 "
          f"= {4 * n_params / 1e9:.2f} GB (random, seed 0) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    b, s, g, n = VLM_BATCH, VLM_PROMPT, VLM_GEN, cfg.num_layers
    gen = torch.Generator(device="cuda").manual_seed(0)
    prompt = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                           device="cuda")
    embeds = torch.as_tensor(make_batch(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=s, global_batch=b, seed=0,
        frontend=cfg.frontend), 0)["embeds"], device="cuda")
    # a decode step reads every weight but the embedding and frontend_proj,
    # and the K/V cache at the middle step's length, once
    weight_bytes = 4 * sum(p.numel() for name, p in params.named_parameters()
                           if name not in ("embed", "frontend_proj"))
    kv_bytes = 4 * n * b * 2 * cfg.num_kv_heads * cfg.head_dim * (s + g // 2)
    bound_ms = (weight_bytes + kv_bytes) / HBM_BYTES_PER_S * 1e3

    def steps(impl):
        return make_serve_steps(cfg, impl=impl, max_len=s + g, batch=b,
                                torch_chunk=s, device="cuda")

    counts = {"flash_fwd": 0, "flash_decode": 0}
    want = {"flash_fwd": n, "flash_decode": n * (g - 1)}
    total = torch.cuda.get_device_properties(0).total_memory
    for source, (pr, em) in (("tokens", (prompt, None)),
                             ("embeds", (None, embeds))):
        kfwd.launches = kdecode.launches = 0
        run_k = greedy_generate(steps("kernel"), params, pr, g, cfg.vocab_size,
                                embeds=em)
        got = {"flash_fwd": kfwd.launches, "flash_decode": kdecode.launches}
        peak = torch.cuda.max_memory_allocated()
        step_ms = run_k.decode_s * 1e3 / (g - 1)
        print(f"{tag} (a) from {source}, impl=kernel: prefill {b}x{s} "
              f"{run_k.prefill_s * 1e3:.1f} ms; decode {g - 1} steps "
              f"{run_k.decode_s * 1e3:.1f} ms = {step_ms:.2f} ms a step "
              f"({(g - 1) * b / run_k.decode_s:.1f} tokens/s) against the bound "
              f"of reading {(weight_bytes + kv_bytes) / 1e9:.2f} GB a step (the "
              f"weights but embed and frontend_proj, and the cache at "
              f"{s + g // 2} slots) at {HBM_BYTES_PER_S / 1e12:.2f} TB/s, "
              f"{bound_ms:.2f} ms ({step_ms / bound_ms:.2f}x); "
              f"max_memory_allocated {peak / 2**30:.2f} GiB of "
              f"{total / 2**30:.2f}", flush=True)
        print(f"{tag} (a) from {source}: launch counters {got} (expected "
              f"{want})", flush=True)
        if got != want:
            fail(f"llava-next-34b from {source}: the serving path did not go "
                 f"through the kernels: {got}")
        for key in counts:
            counts[key] += got[key]
        run_t = greedy_generate(steps("torch"), params, pr, g, cfg.vocab_size,
                                embeds=em, feed=run_k.tokens)
        if {"flash_fwd": kfwd.launches, "flash_decode": kdecode.launches} != want:
            fail("impl='torch' launched a CUDA kernel")
        worst, ties = 0.0, []
        for j, (lk, lt) in enumerate(zip(run_k.logits, run_t.logits)):
            if lk.shape != (b, cfg.vocab_size) or \
                    not bool(torch.isfinite(lk).all()):
                fail(f"llava-next-34b step {j}: logits of shape "
                     f"{tuple(lk.shape)} or not finite")
            rel = _maxerr(lk, lt) / float(lt.abs().max())
            worst = max(worst, rel)
            if rel > LOGIT_REL_TOL:
                fail(f"llava-next-34b from {source} step {j}: kernel vs torch "
                     f"logits differ by {rel:.3e} of max|logit|")
            rows = (run_k.tokens[:, j] != run_t.tokens[:, j]).nonzero()[:, 0]
            if rows.numel():
                margin, top = _top2(lk, cfg.vocab_size)
                for r in rows.tolist():
                    ties.append(f"row {r} step {j}: kernel "
                                f"{int(run_k.tokens[r, j])} vs torch "
                                f"{int(run_t.tokens[r, j])}, margin "
                                f"{margin[r]:.3e} of max|logit| {top[r]:.3e}")
                    if margin[r] > LOGIT_REL_TOL * top[r]:
                        fail(f"llava-next-34b from {source}: {ties[-1]}: not a "
                             f"near-tie")
        print(f"{tag} (a) from {source}, impl=torch (fed the kernel run's "
              f"tokens): prefill {run_t.prefill_s * 1e3:.1f} ms, decode "
              f"{run_t.decode_s * 1e3:.1f} ms; kernel vs torch logits over "
              f"prefill + {g - 1} steps: max |d| / max|logit| {worst:.3e} (tol "
              f"{LOGIT_REL_TOL:.0e}); greedy tokens equal for "
              f"{b * g - len(ties)} of {b * g} (row, step) pairs"
              + "".join(f"; near-tie {t}" for t in ties), flush=True)
        del run_k, run_t
    del embeds
    torch.cuda.empty_cache()

    # (b) the paged engine
    ps, slots = 16, 8
    pages_per_seq = -(-(s + g) // ps) + 1                            # 67
    pcfg = PagedCacheConfig(page_size=ps, max_batch=slots,
                            max_pages_per_seq=pages_per_seq,
                            num_pages=1 + slots * pages_per_seq)
    rs = np.random.RandomState(3)
    reqs = [(rs.randint(0, cfg.vocab_size, size=int(rs.randint(s // 4, s + 1))),
             g) for _ in range(VLM_REQUESTS)]
    print(f"{tag} (b) paged: page {ps}, {slots} slots, {pages_per_seq} pages a "
          f"sequence, pool {pcfg.num_pages} pages; {len(reqs)} requests, prompts "
          f"{[len(t) for t, _ in reqs]} tokens, {g} generated each; near-tie "
          f"tolerance: top-2 margin <= {LOGIT_REL_TOL:.0e} x max|logit|",
          flush=True)
    modes = {mode: (pcfg, prefill_len, kw, reqs)
             for mode, (kw, prefill_len) in VLM_MODES.items()}
    paged, _, _ = _engine_modes(torch, kfwd, kdecode, cfg, params, modes,
                                "vlm paged", s)
    print(f"{tag} peak max_memory_allocated over phase 4h "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    del params
    torch.cuda.empty_cache()
    return {"serve": counts, "paged": paged}


def profile_step(torch, step, tag="[train]", what="loss") -> None:
    """One more step (training, or a decode step) under ``torch.profiler``:
    device time by kernel group (the port's attention kernels, cuBLAS
    GEMMs, the rest) and the device's busy share of the step's wall time.
    ``step()`` returns a number of its output (``what``: the loss); the
    step's own errors and a non-finite number fail the run. A profiler that
    fails or records no device time is reported as not measured."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    try:
        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        prof.start()
    except Exception as e:   # the profiler is a probe here, not a check
        print(f"{tag} profile: not measured ({type(e).__name__}: {e})")
        prof = None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss = step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if not math.isfinite(loss):
        fail(f"the profiled step: {what} {loss}")
    print(f"{tag} profiled step: {what} {loss:.6f}")
    if prof is None:
        return
    try:
        prof.stop()
        averages = prof.key_averages()
    except Exception as e:
        print(f"{tag} profile: not measured ({type(e).__name__}: {e})")
        return
    groups, names = {"attention kernels": 0.0, "GEMMs": 0.0, "other": 0.0}, []
    for e in averages:
        if e.device_type != DeviceType.CUDA:   # kernels only: ops would count twice
            continue
        us = e.self_device_time_total
        name = e.key
        g = ("attention kernels" if any(k in name for k in
                                        ("fwd_kernel", "bwd_kernel",
                                         "decode_kernel"))
             else "GEMMs" if "gemm" in name.lower() else "other")
        groups[g] += us / 1e6
        names.append((us / 1e6, name))
    busy = sum(groups.values())
    if busy == 0.0:
        print(f"{tag} profile: not measured (no device time recorded)")
        return
    parts = ", ".join(f"{g} {t:.4f} s ({100 * t / wall:.1f} %)" for g, t in groups.items())
    print(f"{tag} profile of one step (torch.profiler, wall {wall:.4f} s under "
          f"the profiler): device time {parts}; device busy {busy:.4f} s = "
          f"{100 * busy / wall:.1f} % of the step, idle {100 * (1 - busy / wall):.1f} %")
    for t, name in sorted(names, reverse=True)[:8]:
        print(f"{tag} profile top kernel: {t:.4f} s {name[:110]}")
    sys.stdout.flush()


def time_ms(torch, fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls, from
    CUDA events around the run, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def times_phase(torch, kfwd, kdecode, launches, errs):
    """Kernel, plain version, library call and bound at the serving path's
    shapes (f32, as the path runs): prefill attention of one layer (B 8,
    32/8 heads, 512 tokens, D 64, causal) and one decode step's attention
    (cache of 544 slots, 528 of them filled: the middle of the 31 steps)."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(99)
    f32 = torch.float32
    b, hq, hkv, s, d = 8, 32, 8, 512, 64
    q, k, v = _fwd_inputs(torch, gen, b, hq, hkv, s, s, d, f32)
    o, _ = kfwd.flash_fwd(q, k, v, causal=True)
    o_ref, _ = kfwd.flash_fwd_torch(q, k, v, causal=True)
    fwd_err = _maxerr(o, o_ref)
    pairs = s * (s + 1) // 2                    # causal (q, k) pairs per head
    flops = 4 * b * hq * d * pairs              # QK^T and PV, 2 flops per FMA
    nbytes = 4 * (2 * b * hq * s * d + 2 * b * hkv * s * d + b * hq * s)
    fwd = {
        "name": "flash_fwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_fwd.cu",
        "replaces": "src/repro/kernels/flash_fwd.py:46",
        "launches": launches["flash_fwd"], "max_abs_err": fwd_err,
        "ms": time_ms(torch, lambda: kfwd.flash_fwd(q, k, v, causal=True), 20),
        "plain_ms": time_ms(torch, lambda: kfwd.flash_fwd_torch(q, k, v, causal=True), 5),
        **bounds(flops, nbytes),
        "library_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True), 20),
    }
    del q, k, v, o, o_ref

    cap, n = 544, 528
    q = _rand(torch, gen, (b, hq, d), f32)
    kc = _rand(torch, gen, (b, hkv, cap, d), f32)
    vc = _rand(torch, gen, (b, hkv, cap, d), f32)
    kv_len = torch.full((b,), n, dtype=torch.int32, device="cuda")
    o = kdecode.flash_decode(q, kc, vc, kv_len=kv_len)
    dec_err = _maxerr(o, kdecode.flash_decode_torch(q, kc, vc, kv_len=kv_len))
    flops = 4 * b * hq * d * n
    nbytes = 4 * (2 * b * hq * d + 2 * b * hkv * n * d) + 4 * b
    ks, vs = kc[:, :, :n], vc[:, :, :n]
    dec = {
        "name": "flash_decode", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_decode.cu",
        "replaces": "src/repro/kernels/decode.py:131",
        "launches": launches["flash_decode"], "max_abs_err": dec_err,
        "ms": time_ms(torch, lambda: kdecode.flash_decode(q, kc, vc, kv_len=kv_len), 50),
        "plain_ms": time_ms(torch, lambda: kdecode.flash_decode_torch(
            q, kc, vc, kv_len=kv_len), 10),
        **bounds(flops, nbytes),
        "library_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(
            q[:, :, None], ks, vs, enable_gqa=True), 50),
    }
    for row in (fwd, dec):
        print(f"[times] {row['name']}: kernel {row['ms']:.4f} ms, plain "
              f"{row['plain_ms']:.4f} ms, sdpa {row['library_ms']:.4f} ms, "
              f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}; TF32 tensor "
              f"cores {PEAK_FLOPS['float32'] / 1e12:.0f} TFLOP/s, "
              f"{HBM_BYTES_PER_S / 1e12} TB/s), without tensor cores "
              f"{row['bound_ms_no_tensor_cores']:.4f} ms "
              f"({PEAK_FLOPS_NO_TENSOR_CORES / 1e12:.0f} TFLOP/s f32)")
    worst = max(errs.values())
    print(f"[times] worst kernel-vs-plain error over the kernel phase {worst:.3e}")
    return [fwd, dec]


def bwd_times_phase(torch, kfwd, kbwd, train_launches, fwd_row):
    """The fused backward kernel at the training path's attention shape (B 4,
    32/8 heads, S 2048, D 64, causal) in f32, as the path runs, and in bf16,
    beside its plain version (f32), the whole backward of
    ``scaled_dot_product_attention`` (dq, dk and dv: the same work) in the
    same dtype and call, its bounds, and max |dQ(run 1) - dQ(run 2)| of two
    launches on the same inputs (dQ's atomic adds run in another order);
    adds the forward kernel's time at that shape and its training launches
    to ``fwd_row``. Returns the kernel's row."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(7)
    b, hq, hkv, s, d = TRAIN_BATCH, 32, 8, TRAIN_SEQ, 64
    pairs = s * (s + 1) // 2                  # causal (q, k) pairs per head
    flops = 10 * d * b * hq * pairs           # S, dP, dV, dK, dQ: 2 D each
    row = {"name": "flash_bwd", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/flash_bwd.cu",
           "replaces": "src/repro/kernels/flash_bwd.py:98, "
                       "src/repro/kernels/flash_bwd.py:164",
           "launches": train_launches["flash_bwd"]}
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[-1]
        q, k, v = _fwd_inputs(torch, gen, b, hq, hkv, s, s, d, dtype)
        do = _rand(torch, gen, (b, hq, s, d), dtype)
        o, lse = kfwd.flash_fwd(q, k, v, causal=True)
        delta = kbwd.row_delta(o, do)
        kw = dict(causal=True, scale=d ** -0.5)
        el = q.element_size()
        q_bytes, kv_bytes = el * b * hq * s * d, el * b * hkv * s * d
        rows_bytes = 4 * 2 * b * hq * s       # lse and delta
        if dtype == torch.float32:            # the forward at the training shape
            o_ref, _ = kfwd.flash_fwd_torch(q, k, v, causal=True)
            fb = bounds(4 * b * hq * d * pairs,
                        2 * q_bytes + 2 * kv_bytes + rows_bytes // 2)
            fwd_row.update({
                "launches_by_path": {"serve": fwd_row["launches"],
                                     "train": train_launches["flash_fwd"]},
                "train_shape_max_abs_err": _maxerr(o, o_ref),
                "train_shape_ms": time_ms(torch, lambda: kfwd.flash_fwd(
                    q, k, v, causal=True), 10),
                "train_shape_plain_ms": time_ms(torch, lambda: kfwd.flash_fwd_torch(
                    q, k, v, causal=True), 2, warmup=1),
                "train_shape_bound_ms": fb["bound_ms"],
                "train_shape_bound_ms_no_tensor_cores": fb["bound_ms_no_tensor_cores"],
                "train_shape_library_ms": time_ms(
                    torch, lambda: F.scaled_dot_product_attention(
                        q, k, v, is_causal=True, enable_gqa=True), 10),
            })
            del o_ref
            print(f"[times] flash_fwd at the training shape (B {b}, {hq}/{hkv} "
                  f"heads, S {s}, D {d}, causal, f32): kernel "
                  f"{fwd_row['train_shape_ms']:.4f} ms, plain "
                  f"{fwd_row['train_shape_plain_ms']:.4f} ms, sdpa "
                  f"{fwd_row['train_shape_library_ms']:.4f} ms, bound "
                  f"{fb['bound_ms']:.4f} ms (TF32 tensor cores), "
                  f"{fb['bound_ms_no_tensor_cores']:.4f} ms without", flush=True)

        qg, kg, vg = (x.clone().requires_grad_() for x in (q, k, v))
        out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True, enable_gqa=True)
        lib_ms = time_ms(torch, lambda: torch.autograd.grad(
            out, (qg, kg, vg), do, retain_graph=True), 10)
        del qg, kg, vg, out

        call = lambda: kbwd.launch_bwd(q, k, v, lse, do, delta, **kw)  # noqa: E731
        got, again = call(), call()
        rerun = _maxerr(got[0], again[0])
        bd = bounds(flops, 3 * q_bytes + 4 * kv_bytes + rows_bytes, dn)
        part = {"ms": time_ms(torch, call, 10), "library_ms": lib_ms, **bd,
                "dq_rerun_max_abs_diff": rerun}
        if dtype == torch.float32:
            plain = kbwd.flash_bwd_torch(q, k, v, lse, do, delta, **kw)
            part["max_abs_err"] = max(_maxerr(g, gp) for g, gp in zip(got, plain))
            part["plain_ms"] = time_ms(
                torch, lambda: kbwd.flash_bwd_torch(q, k, v, lse, do, delta, **kw),
                2, warmup=1)
            part["bound_ms_3xtf32"] = 3 * flops / PEAK_FLOPS["float32"] * 1e3
            row.update(part)
            del plain
        else:
            row.update({f"bf16_{key}": val for key, val in part.items()})
        print(f"[times] flash_bwd at the training shape (B {b}, {hq}/{hkv} heads, "
              f"S {s}, D {d}, causal, {dn}): kernel {part['ms']:.4f} ms"
              + (f", plain {part['plain_ms']:.4f} ms" if "plain_ms" in part else "")
              + f", sdpa backward (dq, dk and dv together) {lib_ms:.4f} ms, bound "
              f"{bd['bound_ms']:.4f} ms ({bd['bound_by']}; {dn} tensor cores)"
              + (f", 3xTF32 {part['bound_ms_3xtf32']:.4f} ms" if "bound_ms_3xtf32" in part
                 else "")
              + f", without tensor cores {bd['bound_ms_no_tensor_cores']:.4f} ms; "
              f"{flops / part['ms'] / 1e9:.1f} TFLOP/s; max|dq(run 1) - dq(run 2)| "
              f"{rerun:.3e}", flush=True)
        del q, k, v, do, o, lse, delta, got, again
    torch.cuda.empty_cache()
    return row


def hybrid_bwd_times_phase(torch, kfwd, kbwd, train_launches):
    """Rows 2-3 at recurrentgemma-2b's training shape (B 1, 10/1 heads, S
    3072, D 256, causal, window 2048) in f32, as its path runs, and in
    bf16: the kernel (CUDA events around ``launch_bwd``), its plain version
    (f32), the whole backward of ``scaled_dot_product_attention`` with the
    window as a boolean mask in the same dtype, and the bound over the
    (q, k) pairs inside the window. Returns the row."""
    import torch.nn.functional as F

    from repro_torch.perf import fwd_times

    gen = torch.Generator(device="cuda").manual_seed(19)
    b, hq, hkv, s, d, w = HYBRID_BATCH, 10, 1, HYBRID_SEQ, 256, 2048
    flops = 10 * d * b * hq * fwd_times.causal_pairs(s, w)
    mask = fwd_times.sdpa_mask(s, w)
    row = {"name": "flash_bwd (recurrentgemma-2b training)", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/flash_bwd.cu",
           "replaces": "src/repro/kernels/flash_bwd.py:98, "
                       "src/repro/kernels/flash_bwd.py:164",
           "launches": train_launches["flash_bwd"],
           "shape": f"B {b}, {hq}/{hkv} heads, S {s}, D {d}, causal, window {w}",
           "library_note": "sdpa backward (dq, dk, dv) with the window as a "
                           "boolean mask, GQA by enable_gqa"}
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[-1]
        q, k, v = _fwd_inputs(torch, gen, b, hq, hkv, s, s, d, dtype)
        do = _rand(torch, gen, (b, hq, s, d), dtype)
        o, lse = kfwd.flash_fwd(q, k, v, causal=True, window=w)
        delta = kbwd.row_delta(o, do)
        kw = dict(causal=True, window=w, scale=d ** -0.5)
        el = q.element_size()
        nbytes = (3 * el * b * hq * s * d + 4 * el * b * hkv * s * d
                  + 4 * 2 * b * hq * s)
        qg, kg, vg = (x.clone().requires_grad_() for x in (q, k, v))
        out = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask,
                                             enable_gqa=True)
        lib_ms = time_ms(torch, lambda: torch.autograd.grad(
            out, (qg, kg, vg), do, retain_graph=True), 5)
        del qg, kg, vg, out
        call = lambda: kbwd.launch_bwd(q, k, v, lse, do, delta, **kw)  # noqa: E731
        got, again = call(), call()
        bd = bounds(flops, nbytes, dn)
        part = {"ms": time_ms(torch, call, 10), "library_ms": lib_ms, **bd,
                "dq_rerun_max_abs_diff": _maxerr(got[0], again[0])}
        if dtype == torch.float32:
            plain = kbwd.flash_bwd_torch(q, k, v, lse, do, delta, **kw)
            part["max_abs_err"] = max(_maxerr(g, gp) for g, gp in zip(got, plain))
            part["plain_ms"] = time_ms(
                torch, lambda: kbwd.flash_bwd_torch(q, k, v, lse, do, delta, **kw),
                1, warmup=1)
            part["bound_ms_3xtf32"] = 3 * flops / PEAK_FLOPS["float32"] * 1e3
            row.update(part)
            del plain
        else:
            row.update({f"bf16_{key}": val for key, val in part.items()})
        print(f"[times] flash_bwd at recurrentgemma-2b's training shape ({row['shape']}, "
              f"{dn}): kernel {part['ms']:.4f} ms"
              + (f", plain {part['plain_ms']:.4f} ms" if "plain_ms" in part else "")
              + f", sdpa backward with the window as a mask {lib_ms:.4f} ms, bound "
              f"{bd['bound_ms']:.4f} ms ({bd['bound_by']}; {flops:.4e} flops, "
              f"{dn} tensor cores)"
              + (f", 3xTF32 {part['bound_ms_3xtf32']:.4f} ms" if "bound_ms_3xtf32" in part
                 else "")
              + f"; {flops / part['ms'] / 1e9:.1f} TFLOP/s; launches {row['launches']}; "
              f"max|dq(run 1) - dq(run 2)| {part['dq_rerun_max_abs_diff']:.3e}",
              flush=True)
        del q, k, v, do, o, lse, delta, got, again
    torch.cuda.empty_cache()
    return row


def fwd_times_phase(row) -> None:
    """The forward kernel's row gains ``times_by_case`` from
    ``perf/fwd_times.py`` (the kernel alone under ``torch.profiler``, events
    around calls, SDPA in the same dtype and with the same dropout rate, the
    bounds) at the prefill and training shapes in f32 and bf16 and at the
    training shape with dropout 0.1, and the 3xTF32 bounds of its f32
    shapes."""
    from repro_torch.kernels import _build
    from repro_torch.perf import fwd_times

    fn = fwd_times.library_fn(_build.build(["flash_fwd"])["flash_fwd"])
    res = fwd_times.measure({"kernel": fn}, [c for c in fwd_times.CASES
                                             if not c.startswith("hybrid")])
    row["bound_ms_3xtf32"] = res["prefill_f32"]["bound_ms_3xtf32"]
    row["train_shape_bound_ms_3xtf32"] = res["train_f32"]["bound_ms_3xtf32"]
    row["times_by_case"] = {}
    for case, r in res.items():
        row["times_by_case"][case] = {**r.pop("kernel"), **r}
        t = row["times_by_case"][case]
        print(f"[times] flash_fwd {case}: device {t['device_ms']:.5f} ms "
              f"({t['device_ms_method']}), events {t['ms']:.5f} ms, sdpa "
              f"{t['library_ms']:.5f} ms, bound {t['bound_ms']:.5f} ms "
              f"({t['bound_by']})" + (f", 3xTF32 {t['bound_ms_3xtf32']:.5f} ms"
                                      if "bound_ms_3xtf32" in t else ""), flush=True)


def paged_times_phase(torch, kdecode, paged_launches, errs):
    """The paged decode kernel at the engine's decode shape (B 8, 32/8
    heads, D 64, page 16, T 37, kv_len 528-576), at a 256-token chunk's
    shape (256 token rows reading one table up to positions 301-556) and at
    a verify launch's (8 slots of 5 token rows, a table a slot), f32,
    beside its plain version, SDPA on the contiguous equivalent (ragged
    lengths as a boolean mask; the page gather excluded) and its bound: the
    K/V rows the rows read (each distinct row once), q and o, the tables."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(77)
    f32 = torch.float32
    hq, hkv, d, ps, t = 32, 8, 64, 16, 37
    slot_len = torch.randint(528, 577, (8,), generator=gen, device="cuda",
                             dtype=torch.int32)
    shapes = {
        "decode": slot_len,
        "chunk": torch.arange(301, 557, device="cuda", dtype=torch.int32),
        # a verify step: each slot's current token and 4 drafts
        "verify": (slot_len[:, None] + torch.arange(
            1, 6, device="cuda", dtype=torch.int32)).view(-1),
    }
    out = {}
    for shape, kv_len in shapes.items():
        q, kp, vp, bt = _paged_case(torch, gen, kv_len, hq, hkv, d, ps, t, f32)
        if shape == "chunk":
            bt = bt[-1:].expand(kv_len.shape[0], t).contiguous()
        elif shape == "verify":      # a slot's 5 rows share its last row's table
            bt = bt[4::5].repeat_interleave(5, dim=0).contiguous()
        b = kv_len.shape[0]
        # the token rows of one batch row: a chunk's all, a verify slot's 5
        rt = {"decode": 1, "chunk": b, "verify": 5}[shape]
        o = kdecode.flash_paged_decode(q, kp, vp, bt, kv_len, row_tokens=rt)
        err = _maxerr(o, kdecode.flash_paged_decode_torch(q, kp, vp, bt,
                                                          kv_len=kv_len))
        pos = torch.arange(t * ps, device="cuda")
        read = pos[None, :] < kv_len[:, None]                       # [B, S]
        slots = (bt.long()[:, pos // ps] * ps + pos % ps)[read]
        rows = int(torch.unique(slots).numel())                     # distinct K/V rows
        nbytes = 4 * (2 * rows * hkv * d + 2 * b * hq * d) + 4 * (b * t + b)
        flops = 4 * hq * d * int(kv_len.sum())
        kc, vc = kdecode.gather_pages(kp, bt), kdecode.gather_pages(vp, bt)
        mask = read[:, None, None, :]
        iters = 20 if shape == "chunk" else 50
        out[shape] = {
            "max_abs_err": err,
            "ms": time_ms(torch, lambda: kdecode.flash_paged_decode(
                q, kp, vp, bt, kv_len, row_tokens=rt), iters),
            "plain_ms": time_ms(torch, lambda: kdecode.flash_paged_decode_torch(
                q, kp, vp, bt, kv_len=kv_len), 5),
            **bounds(flops, nbytes),
            "library_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(
                q[:, :, None], kc, vc, attn_mask=mask, enable_gqa=True), iters),
        }
        print(f"[times] flash_paged_decode at the {shape} shape (B {b}, {hq}/{hkv} "
              f"heads, D {d}, page {ps}, T {t}, kv_len {int(kv_len.min())}-"
              f"{int(kv_len.max())}, {rows} distinct K/V rows, f32): kernel "
              f"{out[shape]['ms']:.5f} ms, plain {out[shape]['plain_ms']:.4f} ms, "
              f"sdpa on the contiguous equivalent (gather excluded) "
              f"{out[shape]['library_ms']:.5f} ms, bound "
              f"{out[shape]['bound_ms']:.5f} ms ({out[shape]['bound_by']}; "
              f"without tensor cores {out[shape]['bound_ms_no_tensor_cores']:.5f} ms)")
        del q, kp, vp, bt, kc, vc, o
    row = {"name": "flash_paged_decode", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/flash_decode.cu",
           "replaces": "src/repro/kernels/decode.py:136",
           "launches": paged_launches["flash_paged_decode"], **out["decode"],
           "launches_by_path": {"paged_serve": paged_launches["by_mode"]},
           "library_note": "sdpa on the gathered contiguous cache, gather excluded"}
    for shape in ("chunk", "verify"):
        row.update({f"{shape}_shape_{k}": v for k, v in out[shape].items()})
    worst = max(v for k, v in errs.items() if k.startswith("flash_paged_decode/"))
    print(f"[times] worst paged kernel-vs-plain error over the kernel phase {worst:.3e}")
    torch.cuda.empty_cache()
    return row


def gated_times_phase(torch, kdecode, dist_launches, errs):
    """The gated paged kernel for one shard of two, at the distributed
    engine's decode shape (B 8, 32/8 heads, D 64, page 16, T 37, kv_len
    528-576) and chunk shape (256 token rows reading one table up to
    positions 301-556), f32, beside its plain version, its bound (the K/V
    rows this shard owns, each once; q, the partial outputs, the tables)
    and, as the library yardstick, aten's memory-efficient attention with
    its log-sum-exp (the same state, normalised) on the owned rows, gathered
    and head-expanded outside the timing."""
    from repro_torch.distributed.paged import _local_ids

    gen = torch.Generator(device="cuda").manual_seed(78)
    f32 = torch.float32
    hq, hkv, d, ps, t = 32, 8, 64, 16, 37
    shapes = {
        "decode": torch.randint(528, 577, (8,), generator=gen, device="cuda",
                                dtype=torch.int32),
        "chunk": torch.arange(301, 557, device="cuda", dtype=torch.int32),
    }
    out = {}
    for shape, kv_len in shapes.items():
        b = kv_len.shape[0]
        # the chunk's rows share one table, built for its longest row
        table_len = kv_len if shape == "decode" else kv_len[-1:]
        q, kp, vp, bt, n_local = _sharded_case(torch, gen, table_len, hq, hkv,
                                               d, ps, t, f32)
        if shape == "chunk":
            q = _rand(torch, gen, (b, hq, d), f32)
            bt = bt.expand(b, t).contiguous()
        bt_l, valid = (x.contiguous() for x in _local_ids(bt, n_local, 0))
        kl = kp[:, :n_local].contiguous()
        vl = vp[:, :n_local].contiguous()
        del kp, vp
        rt = b if shape == "chunk" else 1                    # one batch row's tokens
        call = lambda: kdecode.flash_paged_decode_partials(      # noqa: E731
            q, kl, vl, bt_l, kv_len, block_valid=valid, row_tokens=rt)
        part = call()
        ref = kdecode.flash_paged_decode_partials_torch(
            q, kl, vl, bt_l, kv_len=kv_len, block_valid=valid)
        err = _maxerr(_state_out(torch, *part)[0], _state_out(torch, *ref)[0])
        pos = torch.arange(t * ps, device="cuda")
        read = (pos[None, :] < kv_len[:, None]) & (valid[:, pos // ps] != 0)
        slots = (bt_l.long()[:, pos // ps] * ps + pos % ps)[read]
        rows = int(torch.unique(slots).numel())              # owned K/V rows
        nbytes = (4 * (2 * rows * hkv * d + b * hq * d)      # K/V rows, q
                  + 4 * (b * hq * d + 2 * b * hq)            # acc, m, l
                  + 4 * (2 * b * t + b))                     # tables, kv_len
        flops = 4 * hq * d * int(read.sum())
        iters = 50 if shape == "decode" else 20
        row = {
            "max_abs_err": err,
            "ms": time_ms(torch, call, iters),
            "plain_ms": time_ms(torch, lambda: kdecode.flash_paged_decode_partials_torch(
                q, kl, vl, bt_l, kv_len=kv_len, block_valid=valid), 5),
            **bounds(flops, nbytes),
            "library_ms": None,
        }
        try:   # the yardstick: (o, lse) over the owned rows, gather excluded
            kc = kdecode.gather_pages(kl, bt_l).repeat_interleave(hq // hkv, dim=1)
            vc = kdecode.gather_pages(vl, bt_l).repeat_interleave(hq // hkv, dim=1)
            bias = torch.zeros((b, hq, 1, t * ps), device="cuda", dtype=f32)
            bias.masked_fill_(~read[:, None, None, :], float("-inf"))
            q4 = q[:, :, None].contiguous()
            eff = torch.ops.aten._scaled_dot_product_efficient_attention
            eff(q4, kc, vc, bias, True)
            row["library_ms"] = time_ms(torch, lambda: eff(q4, kc, vc, bias, True),
                                        iters)
            del kc, vc, bias
        except (RuntimeError, NotImplementedError) as e:
            row["library_note"] = f"none: {type(e).__name__}: {str(e)[:200]}"
        out[shape] = row
        lib = (f"{row['library_ms']:.5f} ms" if row["library_ms"] is not None
               else row["library_note"])
        print(f"[times] flash_paged_decode_partials at the {shape} shape, one "
              f"shard of two (B {b}, {hq}/{hkv} heads, D {d}, page {ps}, T {t}, "
              f"kv_len {int(kv_len.min())}-{int(kv_len.max())}, {rows} owned "
              f"K/V rows, f32): kernel {row['ms']:.5f} ms, plain "
              f"{row['plain_ms']:.4f} ms, efficient attention with lse on the "
              f"owned rows (gather excluded) {lib}, bound {row['bound_ms']:.5f} "
              f"ms ({row['bound_by']}; without tensor cores "
              f"{row['bound_ms_no_tensor_cores']:.5f} ms)", flush=True)
        del q, kl, vl, bt, bt_l, valid
    result = {"name": "flash_paged_decode_partials", "route": "cuda",
              "source": "src/repro_torch/kernels/csrc/flash_decode.cu",
              "replaces": "src/repro/kernels/decode.py:144",
              "launches": dist_launches["total"], **out["decode"],
              "launches_by_path": {"mesh_paged_serve_rank0": dist_launches["by_mode"]},
              "library_call": "aten._scaled_dot_product_efficient_attention "
                              "(compute_log_sumexp) on the owned rows"}
    result.update({f"chunk_shape_{k}": v for k, v in out["chunk"].items()})
    worst = max(v for k, v in errs.items()
                if k.startswith("flash_paged_decode_partials/"))
    print(f"[times] worst gated kernel-vs-plain error over the kernel phase "
          f"(gate and two-shard checks, f32 and bf16) {worst:.3e}")
    torch.cuda.empty_cache()
    return result


def shard_partials_times_phase(torch, kdecode, mesh_serve, errs):
    """Row 4's shard-partials mode at phase 4i(b)'s decode: one shard of two
    of recurrentgemma-2b's full 2048-slot ring (B 4, 10/1 heads, D 256, 1024
    slots, all valid, f32), beside its plain version, its bound (the
    shard's K/V rows, q, the partial state, kv_len, each once) and, as the
    library yardstick, aten's memory-efficient attention with its
    log-sum-exp (the same state, normalised) on the shard's rows,
    head-expanded outside the timing. Its launches: rank 0's in phase 4i."""
    gen = torch.Generator(device="cuda").manual_seed(84)
    f32 = torch.float32
    b, hq, hkv, d, s = 4, 10, 1, 256, 1024
    q = _rand(torch, gen, (b, hq, d), f32)
    k = _rand(torch, gen, (b, hkv, s, d), f32)
    v = _rand(torch, gen, (b, hkv, s, d), f32)
    kv_len = torch.full((b,), s, dtype=torch.int32, device="cuda")
    call = lambda: kdecode.flash_decode_partials(q, k, v, kv_len=kv_len)  # noqa: E731
    plain = lambda: kdecode.flash_decode_partials_torch(  # noqa: E731
        q, k, v, kv_len=kv_len)
    err = _maxerr(_state_out(torch, *call())[0], _state_out(torch, *plain())[0])
    if err > TOL["float32"]:
        fail(f"flash_decode_partials at phase 4i's shape: {err:.3e}")
    nbytes = 4 * (2 * b * hkv * s * d + b * hq * d      # K/V rows, q
                  + b * hq * d + 2 * b * hq + b)        # acc, m, l, kv_len
    row = {"name": "flash_decode_partials", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/flash_decode.cu",
           "replaces": "src/repro/kernels/decode.py:131",
           "launches": mesh_serve["partials"],
           "launches_by_path": {"mesh_serve_rank0_recurrentgemma_2b":
                                mesh_serve["partials"]},
           "max_abs_err": err, "ms": time_ms(torch, call, 50),
           "plain_ms": time_ms(torch, plain, 5),
           **bounds(4 * hq * d * b * s, nbytes),
           "library_ms": None,
           "library_call": "aten._scaled_dot_product_efficient_attention "
                           "(compute_log_sumexp) on the shard's rows",
           "shape": "B 4, 10/1 heads, D 256, one shard of two of a 2048-slot "
                    "ring (1024 slots, all valid), f32"}
    try:
        kc = k.repeat_interleave(hq // hkv, dim=1)
        vc = v.repeat_interleave(hq // hkv, dim=1)
        q4 = q[:, :, None].contiguous()
        eff = torch.ops.aten._scaled_dot_product_efficient_attention
        eff(q4, kc, vc, None, True)
        row["library_ms"] = time_ms(torch, lambda: eff(q4, kc, vc, None, True), 50)
    except (RuntimeError, NotImplementedError) as e:
        row["library_note"] = f"none: {type(e).__name__}: {str(e)[:200]}"
    lib = (f"{row['library_ms']:.5f} ms" if row["library_ms"] is not None
           else row["library_note"])
    worst = max(v for k_, v in errs.items()
                if k_.startswith("flash_decode_partials/"))
    print(f"[times] flash_decode_partials at phase 4i(b)'s decode ({row['shape']}): "
          f"kernel {row['ms']:.5f} ms, plain {row['plain_ms']:.4f} ms, efficient "
          f"attention with lse {lib}, bound {row['bound_ms']:.5f} ms "
          f"({row['bound_by']}); launches rank 0 {row['launches']}; worst "
          f"kernel-vs-plain error over the kernel phase {worst:.3e}", flush=True)
    del q, k, v
    torch.cuda.empty_cache()
    return row


def hybrid_gated_times_phase(torch, kdecode, dist_launches):
    """Row 6 at recurrentgemma-2b's geometry (10/1 heads, D 256, page 16, T
    196, window 2048, f32): the gated kernel for one shard of two at the
    hybrid engine's decode of 8 slots (kv_len 1040-3120, a random half of
    the pages owned, foreign entries on the local trash page), beside its
    plain version, its bound (the owned K/V rows inside kv_len and the
    window, each once; q, the partial state, the tables), aten's
    memory-efficient attention with its log-sum-exp on the owned rows in
    the window (gathered and head-expanded outside the timing), its device
    time alone with the cache cold and its host time a call
    (``perf/decode_times.py``). Its launches: rank 0's in phase 4c."""
    from repro_torch.perf import decode_times

    gen = torch.Generator(device="cuda").manual_seed(21)
    hq, hkv, d, ps, t = decode_times.HYBRID
    w = decode_times.HYBRID_WINDOW
    kv_len = decode_times.hybrid_shapes(gen)["decode"][0]
    b = kv_len.shape[0]
    q, kp, vp, tables, valids = decode_times.paged_inputs(
        kv_len, copies=decode_times._copies(4 * hkv * d * w * b), seed=11,
        gated=True, geometry=decode_times.HYBRID)
    bt, valid = tables[0], valids[0]
    call = lambda: kdecode.flash_paged_decode_partials(      # noqa: E731
        q, kp, vp, bt, kv_len, block_valid=valid, window=w)
    plain = lambda: kdecode.flash_paged_decode_partials_torch(  # noqa: E731
        q, kp, vp, bt, kv_len=kv_len, block_valid=valid, window=w)
    err = _maxerr(_state_out(torch, *call())[0], _state_out(torch, *plain())[0])
    if err > TOL["float32"]:
        fail(f"rg gated kernel vs plain at the engine's decode shape: {err:.3e}")
    pos = torch.arange(t * ps, device="cuda")
    read = ((pos[None, :] < kv_len[:, None])
            & (pos[None, :] > kv_len[:, None] - 1 - w)
            & (valid[:, pos // ps] != 0))
    slots = (bt.long()[:, pos // ps] * ps + pos % ps)[read]
    rows = int(torch.unique(slots).numel())                  # owned K/V rows
    nbytes = (4 * (2 * rows * hkv * d + b * hq * d)          # K/V rows, q
              + 4 * (b * hq * d + 2 * b * hq)                # acc, m, l
              + 4 * (2 * b * t + b))                         # tables, kv_len
    dev = decode_times._case(
        [lambda bt=bt, va=va: kdecode.flash_paged_decode_partials(
            q, kp, vp, bt, kv_len, block_valid=va, window=w)
         for bt, va in zip(tables, valids)], 50,
        [(q, kv_len, bt, va) for bt, va in zip(tables, valids)])
    row = {"name": "flash_paged_decode_partials (recurrentgemma-2b, one shard "
                   "of two)", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/flash_decode.cu",
           "replaces": "src/repro/kernels/decode.py:144",
           "launches": dist_launches["total"],
           "launches_by_path": {"dist_hybrid_paged_serve_rank0":
                                dist_launches["by_mode"]},
           "max_abs_err": err, "ms": dev["ms"],
           "plain_ms": time_ms(torch, plain, 3, warmup=1),
           **bounds(4 * hq * d * int(read.sum()), nbytes),
           "library_ms": None,
           "device_ms": dev["device_ms"],
           "device_ms_method": dev["device_ms_method"],
           "device_ms_copies": dev["device_ms_copies"],
           "host_us": dev["host_us"],
           "library_call": "aten._scaled_dot_product_efficient_attention "
                           "(compute_log_sumexp) on the owned rows in the window",
           "shape": f"8 slots, 10/1 heads, D 256, page 16, T 196, kv_len "
                    f"{int(kv_len.min())}-{int(kv_len.max())}, window 2048, one "
                    f"shard of two ({rows} owned K/V rows read), f32"}
    try:   # the yardstick: (o, lse) over the owned rows, gather excluded
        kc = kdecode.gather_pages(kp, bt).repeat_interleave(hq // hkv, dim=1)
        vc = kdecode.gather_pages(vp, bt).repeat_interleave(hq // hkv, dim=1)
        bias = torch.zeros((b, hq, 1, t * ps), device="cuda")
        bias.masked_fill_(~read[:, None, None, :], float("-inf"))
        q4 = q[:, :, None].contiguous()
        eff = torch.ops.aten._scaled_dot_product_efficient_attention
        eff(q4, kc, vc, bias, True)
        row["library_ms"] = time_ms(torch, lambda: eff(q4, kc, vc, bias, True),
                                    50)
        del kc, vc, bias
    except (RuntimeError, NotImplementedError) as e:
        row["library_note"] = f"none: {type(e).__name__}: {str(e)[:200]}"
    lib = (f"{row['library_ms']:.5f} ms" if row["library_ms"] is not None
           else row["library_note"])
    print(f"[times] {row['name']} ({row['shape']}): kernel {row['ms']:.5f} ms "
          f"(device {row['device_ms']:.5f} ms, {row['device_ms_method']}, cold "
          f"L2; host {row['host_us']:.2f} us a call), plain "
          f"{row['plain_ms']:.4f} ms, efficient attention with lse {lib}, bound "
          f"{row['bound_ms']:.5f} ms ({row['bound_by']}); launches a rank "
          f"{row['launches']}; max|kernel - plain| {err:.3e}", flush=True)
    del q, kp, vp, tables, valids
    torch.cuda.empty_cache()
    return row


def hybrid_times_phase(torch, kfwd, kdecode, launches, paged_launches,
                       train_launches, errs):
    """Rows 1, 4 and 5 at recurrentgemma-2b's shapes (f32, 10/1 heads, D
    256, window 2048): its prefill attention (B 4, S 3072, causal), its
    contiguous decode over a full 2048-slot ring (B 4) and its paged decode
    (8 slots, kv_len 1040-3120, page 16, T 196) and 512-token chunk, each
    beside its plain version, SDPA with the window as a boolean mask (GQA
    expanded by ``enable_gqa``; the paged rows on the gathered cache, the
    gather excluded), its bound and its device time alone
    (``perf/fwd_times.py``, ``perf/decode_times.py``)."""
    import torch.nn.functional as F

    from repro_torch.kernels import _build
    from repro_torch.perf import decode_times, fwd_times

    gen = torch.Generator(device="cuda").manual_seed(18)
    f32 = torch.float32
    hq, hkv, d, w = 10, 1, 256, 2048
    src = "src/repro_torch/kernels/csrc/"
    worst = max(v for k, v in errs.items() if "/rg" in k or "_rg_" in k)
    print(f"[times] recurrentgemma-2b: worst kernel-vs-plain error over its "
          f"phase-3 cases {worst:.3e}")

    # row 1: the prefill attention of one layer
    b, s = 4, 3072
    q, k, v = _fwd_inputs(torch, gen, b, hq, hkv, s, s, d, f32)
    o, _ = kfwd.flash_fwd(q, k, v, causal=True, window=w)
    fwd_err = _maxerr(o, kfwd.flash_fwd_torch(q, k, v, causal=True, window=w)[0])
    mask = fwd_times.sdpa_mask(s, w)
    fn = fwd_times.library_fn(_build.build(["flash_fwd"])["flash_fwd"])
    dev = fwd_times.measure({"kernel": fn}, ("hybrid_prefill_f32",))
    fwd = {
        "name": "flash_fwd (recurrentgemma-2b prefill)", "route": "cuda",
        "source": src + "flash_fwd.cu",
        "replaces": "src/repro/kernels/flash_fwd.py:46",
        "launches": launches["flash_fwd"] + paged_launches["flash_fwd"],
        "launches_by_path": {"hybrid_serve": launches["flash_fwd"],
                             "hybrid_paged_serve": paged_launches["flash_fwd"],
                             "hybrid_train": train_launches["flash_fwd"]},
        "max_abs_err": fwd_err,
        "ms": time_ms(torch, lambda: kfwd.flash_fwd(q, k, v, causal=True,
                                                    window=w), 10),
        "plain_ms": time_ms(torch, lambda: kfwd.flash_fwd_torch(
            q, k, v, causal=True, window=w), 2, warmup=1),
        **bounds(4 * b * hq * d * fwd_times.causal_pairs(s, w),
                 4 * (2 * b * hq * s * d + 2 * b * hkv * s * d + b * hq * s)),
        "bound_ms_3xtf32": dev["hybrid_prefill_f32"]["bound_ms_3xtf32"],
        "library_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, enable_gqa=True), 10),
        "device_ms": dev["hybrid_prefill_f32"]["kernel"]["device_ms"],
        "device_ms_method": dev["hybrid_prefill_f32"]["kernel"]["device_ms_method"],
        "shape": "B 4, 10/1 heads, S 3072, D 256, causal, window 2048, f32",
    }
    del q, k, v, o

    # row 4: one decode step's attention over the full ring
    q = _rand(torch, gen, (b, hq, d), f32)
    kc, vc = (_rand(torch, gen, (b, hkv, w, d), f32) for _ in range(2))
    kv_len = torch.full((b,), w, dtype=torch.int32, device="cuda")
    o = kdecode.flash_decode(q, kc, vc, kv_len=kv_len)
    hyb = decode_times.measure_hybrid()
    dec = {
        "name": "flash_decode (recurrentgemma-2b decode)", "route": "cuda",
        "source": src + "flash_decode.cu",
        "replaces": "src/repro/kernels/decode.py:131",
        "launches": launches["flash_decode"],
        "max_abs_err": _maxerr(o, kdecode.flash_decode_torch(q, kc, vc,
                                                             kv_len=kv_len)),
        "ms": time_ms(torch, lambda: kdecode.flash_decode(q, kc, vc,
                                                          kv_len=kv_len), 50),
        "plain_ms": time_ms(torch, lambda: kdecode.flash_decode_torch(
            q, kc, vc, kv_len=kv_len), 10),
        **bounds(4 * b * hq * d * w,
                 4 * (2 * b * hq * d + 2 * b * hkv * w * d) + 4 * b),
        "library_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(
            q[:, :, None], kc, vc, enable_gqa=True), 50),
        "shape": "B 4, 10/1 heads, a full ring of 2048 slots, D 256, f32",
    }
    del q, kc, vc, o

    # row 5: the engine's decode of 8 slots and a 512-token chunk
    shapes = decode_times.hybrid_shapes(gen)
    pag = {"name": "flash_paged_decode (recurrentgemma-2b)", "route": "cuda",
           "source": src + "flash_decode.cu",
           "replaces": "src/repro/kernels/decode.py:136",
           "launches": paged_launches["flash_paged_decode"],
           "launches_by_path": {"hybrid_paged_serve": paged_launches["by_mode"]},
           "shape": "8 slots, 10/1 heads, D 256, page 16, T 196, kv_len "
                    "1040-3120, window 2048, f32; chunk_shape_: 512 token "
                    "rows of one table, kv_len 2561-3072",
           "library_note": "sdpa on the gathered contiguous cache with the "
                           "window as a mask, gather excluded"}
    for shape, (kv_len, per_table, rt) in shapes.items():
        q, kp, vp, bt, _ = decode_times.paged_inputs(
            kv_len, rows_per_table=per_table, seed=5, geometry=decode_times.HYBRID)
        bt = bt[0]
        o = kdecode.flash_paged_decode(q, kp, vp, bt, kv_len, window=w,
                                       row_tokens=rt)
        err = _maxerr(o, kdecode.flash_paged_decode_torch(
            q, kp, vp, bt, kv_len=kv_len, window=w))
        kc, vc = kdecode.gather_pages(kp, bt), kdecode.gather_pages(vp, bt)
        pos = torch.arange(kc.shape[2], device="cuda")
        allowed = ((pos[None, :] < kv_len[:, None])
                   & (pos[None, :] > kv_len[:, None] - 1 - w))[:, None, None, :]
        r = {"max_abs_err": err,
             "ms": time_ms(torch, lambda: kdecode.flash_paged_decode(
                 q, kp, vp, bt, kv_len, window=w, row_tokens=rt), 30),
             "plain_ms": time_ms(torch, lambda: kdecode.flash_paged_decode_torch(
                 q, kp, vp, bt, kv_len=kv_len, window=w), 3, warmup=1),
             **bounds(4 * hq * d * int(kv_len.clamp(max=w).sum()),
                      decode_times.paged_bytes(kv_len, per_table,
                                               decode_times.HYBRID, w)),
             "library_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(
                 q[:, :, None], kc, vc, attn_mask=allowed, enable_gqa=True), 30),
             "device_ms": hyb["flash_paged_decode"][shape]["device_ms"],
             "device_ms_method": hyb["flash_paged_decode"][shape]["device_ms_method"],
             "host_us": hyb["flash_paged_decode"][shape]["host_us"]}
        pag.update(r if shape == "decode" else
                   {f"{shape}_shape_{key}": val for key, val in r.items()})
        del q, kp, vp, bt, kc, vc, o
    for key in ("device_ms", "device_ms_method", "host_us"):
        dec[key] = hyb["flash_decode"]["decode"][key]
    for row in (fwd, dec, pag):
        print(f"[times] {row['name']}: kernel {row['ms']:.5f} ms (device "
              f"{row['device_ms']:.5f} ms, {row['device_ms_method']}), plain "
              f"{row['plain_ms']:.4f} ms, sdpa {row['library_ms']:.5f} ms, bound "
              f"{row['bound_ms']:.5f} ms ({row['bound_by']}); launches "
              f"{row['launches']}; max|kernel - plain| {row['max_abs_err']:.3e}",
              flush=True)
    print(f"[times] flash_paged_decode (recurrentgemma-2b) at the 512-token "
          f"chunk: kernel {pag['chunk_shape_ms']:.5f} ms (device "
          f"{pag['chunk_shape_device_ms']:.5f}), plain "
          f"{pag['chunk_shape_plain_ms']:.4f} ms, sdpa "
          f"{pag['chunk_shape_library_ms']:.5f} ms, bound "
          f"{pag['chunk_shape_bound_ms']:.5f} ms", flush=True)
    torch.cuda.empty_cache()
    return [fwd, dec, pag]


def _dn(dtype) -> str:
    return str(dtype).split(".")[-1]


def _hold(what, dtype, err, tol, where):
    if not err <= tol:
        fail(f"{what} {_dn(dtype)} at {where}: {err:.3e} from its plain version "
             f"(tol {tol:.1e})")


def fwd_time_case(torch, kfwd, gen, b, hq, hkv, s, d, dtype, causal=True,
                  dropout=0.0, where=""):
    """Row 1 on seeded inputs at one shape (q all of kv): held to its plain
    version (``TOL``), then the kernel's and the plain version's times, SDPA's
    in the same dtype with the same mask and dropout rate, and the bounds."""
    import torch.nn.functional as F

    q, k, v = _fwd_inputs(torch, gen, b, hq, hkv, s, s, d, dtype)
    kw = dict(causal=causal, dropout_rate=dropout, dropout_seed=3)
    pairs = s * (s + 1) // 2 if causal else s * s
    err = _maxerr(kfwd.flash_fwd(q, k, v, **kw)[0],
                  kfwd.flash_fwd_torch(q, k, v, **kw)[0])
    _hold(f"flash_fwd B {b}, {hq}/{hkv} heads, S {s}, D {d}", dtype, err,
          TOL[_dn(dtype)], where)
    return {"max_abs_err": err,
            "ms": time_ms(torch, lambda: kfwd.flash_fwd(q, k, v, **kw), 10),
            "plain_ms": time_ms(torch, lambda: kfwd.flash_fwd_torch(
                q, k, v, **kw), 2, warmup=1),
            **bounds(4 * b * hq * d * pairs,
                     q.element_size() * (2 * b * hq * s * d + 2 * b * hkv * s * d)
                     + 4 * b * hq * s, _dn(dtype)),
            "library_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=causal, dropout_p=dropout, enable_gqa=True), 10)}


def bwd_time_case(torch, kfwd, kbwd, gen, b, hq, hkv, s, d, dtype, causal=True,
                  dropout=0.0, where=""):
    """Rows 2-3 on seeded inputs at one shape: the kernel (CUDA events around
    ``launch_bwd``) launched twice (dK, dV bit-equal), held to its plain
    version (``BWD_TOL`` relative to max(1, max|plain|)), SDPA's whole
    backward in the same dtype, the bounds; f32 also the plain version's
    time and the 3xTF32 bound."""
    import torch.nn.functional as F

    q, k, v = _fwd_inputs(torch, gen, b, hq, hkv, s, s, d, dtype)
    do = _rand(torch, gen, (b, hq, s, d), dtype)
    kw = dict(causal=causal, dropout_rate=dropout, dropout_seed=3)
    o, lse = kfwd.flash_fwd(q, k, v, **kw)
    delta = kbwd.row_delta(o, do)
    el = q.element_size()
    qg, kg, vg = (x.clone().requires_grad_() for x in (q, k, v))
    out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=causal,
                                         dropout_p=dropout, enable_gqa=True)
    lib_ms = time_ms(torch, lambda: torch.autograd.grad(
        out, (qg, kg, vg), do, retain_graph=True), 10)
    del qg, kg, vg, out
    call = lambda: kbwd.launch_bwd(q, k, v, lse, do, delta,  # noqa: E731
                                   scale=d ** -0.5, **kw)
    got, again = call(), call()
    if not (torch.equal(got[1], again[1]) and torch.equal(got[2], again[2])):
        fail(f"flash_bwd {_dn(dtype)} at {where}: dK, dV differ on a second launch")
    flops = 10 * d * b * hq * (s * (s + 1) // 2 if causal else s * s)
    r = {"ms": time_ms(torch, call, 10), "library_ms": lib_ms,
         **bounds(flops, el * (3 * b * hq * s * d + 4 * b * hkv * s * d)
                  + 4 * 2 * b * hq * s, _dn(dtype)),
         "dq_rerun_max_abs_diff": _maxerr(got[0], again[0])}
    plain = kbwd.flash_bwd_torch(q, k, v, lse, do, delta, scale=d ** -0.5, **kw)
    r["max_abs_err"] = max(_maxerr(g, gp) for g, gp in zip(got, plain))
    _hold(f"flash_bwd B {b}, {hq}/{hkv} heads, S {s}, D {d}, relative to max(1, "
          f"max|plain|),", dtype,
          max(_maxerr(g, gp) / max(1.0, float(gp.float().abs().max()))
              for g, gp in zip(got, plain)), BWD_TOL[_dn(dtype)], where)
    del plain
    if dtype == torch.float32:
        r["plain_ms"] = time_ms(torch, lambda: kbwd.flash_bwd_torch(
            q, k, v, lse, do, delta, scale=d ** -0.5, **kw), 2, warmup=1)
        r["bound_ms_3xtf32"] = 3 * flops / PEAK_FLOPS["float32"] * 1e3
    return r


def decode_time_case(torch, kdecode, gen, b, hq, hkv, d, cap, n, dtype,
                     where=""):
    """Row 4 at ``n`` of ``cap`` slots on every row: held to its plain
    version, times, SDPA on the filled slots, the bound."""
    import torch.nn.functional as F

    q = _rand(torch, gen, (b, hq, d), dtype)
    kc, vc = (_rand(torch, gen, (b, hkv, cap, d), dtype) for _ in range(2))
    kv_len = torch.full((b,), n, dtype=torch.int32, device="cuda")
    ks, vs = kc[:, :, :n], vc[:, :, :n]
    err = _maxerr(kdecode.flash_decode(q, kc, vc, kv_len=kv_len),
                  kdecode.flash_decode_torch(q, kc, vc, kv_len=kv_len))
    _hold(f"flash_decode B {b}, {hq}/{hkv} heads, {n} of {cap} slots", dtype,
          err, TOL[_dn(dtype)], where)
    return {"max_abs_err": err,
            "ms": time_ms(torch, lambda: kdecode.flash_decode(
                q, kc, vc, kv_len=kv_len), 50),
            "plain_ms": time_ms(torch, lambda: kdecode.flash_decode_torch(
                q, kc, vc, kv_len=kv_len), 10),
            **bounds(4 * b * hq * d * n, q.element_size() * (
                2 * b * hq * d + 2 * b * hkv * n * d) + 4 * b, _dn(dtype)),
            "library_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(
                q[:, :, None], ks, vs, enable_gqa=True), 50)}


def paged_time_case(torch, kdecode, gen, hq, hkv, d, t, lens, dtype, where=""):
    """Row 5 at an engine's decode: 8 slots, page 16, tables of ``t`` pages,
    kv_len drawn from ``lens`` (low, high); held to its plain version, times,
    SDPA on the gathered cache with kv_len as a mask (gather excluded), the
    bound over each slot's distinct K/V rows."""
    import torch.nn.functional as F

    from repro_torch.perf import decode_times

    kv_len = torch.randint(*lens, (8,), generator=gen, device="cuda",
                           dtype=torch.int32)
    q, kp, vp, bt, _ = decode_times.paged_inputs(kv_len, seed=5,
                                                 geometry=(hq, hkv, d, 16, t))
    q, kp, vp, bt = q.to(dtype), kp.to(dtype), vp.to(dtype), bt[0]
    kc, vc = kdecode.gather_pages(kp, bt), kdecode.gather_pages(vp, bt)
    allowed = (torch.arange(kc.shape[2], device="cuda")[None, :]
               < kv_len[:, None])[:, None, None, :]
    n = int(kv_len.sum())
    err = _maxerr(kdecode.flash_paged_decode(q, kp, vp, bt, kv_len, row_tokens=1),
                  kdecode.flash_paged_decode_torch(q, kp, vp, bt, kv_len=kv_len))
    _hold("flash_paged_decode", dtype, err, TOL[_dn(dtype)], where)
    return {"max_abs_err": err,
            "ms": time_ms(torch, lambda: kdecode.flash_paged_decode(
                q, kp, vp, bt, kv_len, row_tokens=1), 50),
            "plain_ms": time_ms(torch, lambda: kdecode.flash_paged_decode_torch(
                q, kp, vp, bt, kv_len=kv_len), 5, warmup=1),
            **bounds(4 * hq * d * n, q.element_size() * (2 * hkv * d * n
                                                          + 2 * 8 * hq * d)
                     + 4 * 8 * (t + 1), _dn(dtype)),
            "library_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(
                q[:, :, None], kc, vc, attn_mask=allowed, enable_gqa=True), 50)}


def moe_times_phase(torch, kfwd, kbwd, kdecode, serve, train):
    """Phase 6 at deepseek-moe-16b's attention geometry (16/16 heads, D 128,
    a GQA group of 1), f32 as its paths run and bf16, each kernel beside its
    plain version (f32 for the backward), one PyTorch library call and its
    bound at the dtype's tensor-core peak: row 1 at prefill (B 4, S 512,
    causal; ``dbrx_shape_``: dbrx-132b's B 2, 48/8 heads, S 256) and at
    training (B 2, S 2048, causal, dropout 0.1), rows 2-3 at training, row
    4 at decode (B 4, 528 of 544 slots; ``dbrx_shape_``: B 2, 264 of 272)
    and row 5 at the paged engine's decode (8 slots, page 16, T 37, kv_len
    128-576). Every kernel is held to its plain version on the inputs it
    is timed on (``TOL``, the backward ``BWD_TOL``), as in phase 3.
    Returns the five rows."""
    gen = torch.Generator(device="cuda").manual_seed(20)
    hq, hkv, d = 16, 16, 128
    src = "src/repro_torch/kernels/csrc/"
    dtypes = ((torch.float32, ""), (torch.bfloat16, "bf16_"))
    where = "the MoE shape"

    def fwd_case(b, hq, hkv, s, dtype, dropout=0.0):
        return fwd_time_case(torch, kfwd, gen, b, hq, hkv, s, d, dtype,
                             dropout=dropout, where=where)

    def bwd_case(b, s, dtype, dropout):
        return bwd_time_case(torch, kfwd, kbwd, gen, b, hq, hkv, s, d, dtype,
                             dropout=dropout, where=where)

    def decode_case(b, hq, hkv, cap, n, dtype):
        return decode_time_case(torch, kdecode, gen, b, hq, hkv, d, cap, n,
                                dtype, where)

    def paged_case(dtype):
        return paged_time_case(torch, kdecode, gen, hq, hkv, d, 37, (128, 577),
                               dtype, where)

    fwd_src = {"route": "cuda", "source": src + "flash_fwd.cu",
               "replaces": "src/repro/kernels/flash_fwd.py:46"}
    prefill = {"name": "flash_fwd (deepseek-moe-16b prefill)", **fwd_src,
               "launches": (serve["serve"]["flash_fwd"] + serve["paged"]["flash_fwd"]
                            + serve["dbrx"]["flash_fwd"]),
               "launches_by_path": {"moe_serve": serve["serve"]["flash_fwd"],
                                    "moe_paged_serve": serve["paged"]["flash_fwd"],
                                    "dbrx_serve": serve["dbrx"]["flash_fwd"]},
               "shape": "B 4, 16/16 heads, S 512, D 128, causal; dbrx_shape_: "
                        "B 2, 48/8 heads, S 256, D 128, causal (f32)"}
    training = {"name": "flash_fwd (deepseek-moe-16b training)", **fwd_src,
                "launches": train["flash_fwd"],
                "launches_by_path": {"moe_train": train["flash_fwd"]},
                "shape": "B 2, 16/16 heads, S 2048, D 128, causal, dropout 0.1"}
    bwd = {"name": "flash_bwd (deepseek-moe-16b training)", "route": "cuda",
           "source": src + "flash_bwd.cu",
           "replaces": "src/repro/kernels/flash_bwd.py:98, "
                       "src/repro/kernels/flash_bwd.py:164",
           "launches": train["flash_bwd"],
           "shape": "B 2, 16/16 heads, S 2048, D 128, causal, dropout 0.1",
           "library_note": "sdpa backward (dq, dk, dv) with dropout_p 0.1"}
    dec = {"name": "flash_decode (deepseek-moe-16b decode)", "route": "cuda",
           "source": src + "flash_decode.cu",
           "replaces": "src/repro/kernels/decode.py:131",
           "launches": serve["serve"]["flash_decode"] + serve["dbrx"]["flash_decode"],
           "launches_by_path": {"moe_serve": serve["serve"]["flash_decode"],
                                "dbrx_serve": serve["dbrx"]["flash_decode"]},
           "shape": "B 4, 16/16 heads, 528 of 544 slots, D 128; dbrx_shape_: "
                    "B 2, 48/8 heads, 264 of 272 slots (f32)"}
    pag = {"name": "flash_paged_decode (deepseek-moe-16b)", "route": "cuda",
           "source": src + "flash_decode.cu",
           "replaces": "src/repro/kernels/decode.py:136",
           "launches": serve["paged"]["flash_paged_decode"],
           "launches_by_path": {"moe_paged_serve": serve["paged"]["by_mode"]},
           "shape": "8 slots, 16/16 heads, D 128, page 16, T 37, kv_len 128-576",
           "library_note": "sdpa on the gathered contiguous cache with kv_len "
                           "as a mask, gather excluded"}
    for dtype, pre in dtypes:
        for row, r in ((prefill, fwd_case(4, hq, hkv, 512, dtype)),
                       (training, fwd_case(2, hq, hkv, 2048, dtype, 0.1)),
                       (bwd, bwd_case(2, 2048, dtype, 0.1)),
                       (dec, decode_case(4, hq, hkv, 544, 528, dtype)),
                       (pag, paged_case(dtype))):
            row.update({pre + key: val for key, val in r.items()})
    prefill.update({"dbrx_shape_" + key: val for key, val in
                    fwd_case(2, 48, 8, 256, torch.float32).items()})
    dec.update({"dbrx_shape_" + key: val for key, val in
                decode_case(2, 48, 8, 272, 264, torch.float32).items()})
    for row in (prefill, training, bwd, dec, pag):
        for pre, dn in (("", "f32"), ("bf16_", "bf16")):
            print(f"[times] {row['name']} {dn}: kernel {row[pre + 'ms']:.5f} ms"
                  + (f", plain {row[pre + 'plain_ms']:.4f} ms"
                     if pre + "plain_ms" in row else "")
                  + f", library {row[pre + 'library_ms']:.5f} ms, bound "
                  f"{row[pre + 'bound_ms']:.5f} ms ({row[pre + 'bound_by']})"
                  + (f", max|kernel - plain| {row[pre + 'max_abs_err']:.3e}"
                     if pre + "max_abs_err" in row else "")
                  + f"; launches {row['launches']}", flush=True)
    for row in (prefill, dec):
        print(f"[times] {row['name']} at dbrx-132b's shape: kernel "
              f"{row['dbrx_shape_ms']:.5f} ms, plain {row['dbrx_shape_plain_ms']:.4f} "
              f"ms, library {row['dbrx_shape_library_ms']:.5f} ms, bound "
              f"{row['dbrx_shape_bound_ms']:.5f} ms", flush=True)
    torch.cuda.empty_cache()
    return [prefill, training, bwd, dec, pag]


def frontend_times_phase(torch, kfwd, kbwd, kdecode, vlm_serve, enc_train,
                         vlm_train):
    """Phase 6 at the frontend families' shapes, f32 as their paths run and
    bf16 (``bf16_``), each kernel beside its plain version (f32 for the
    backward), one PyTorch library call and its bound at the dtype's
    tensor-core peak: rows 1 and 2-3 at hubert-xlarge's training shape (B
    8, 16/16 heads, S 1024, D 80, non-causal, dropout 0.1), row 1 at
    llava-next-34b's prefill (B 4, 56/8 heads, S 1024, D 128, causal;
    ``train_shape_``: B 1, S 2048, dropout 0.1), rows 2-3 at its training
    shape, row 4 at its decode (B 4, 1040 of 1056 slots) and row 5 at its
    paged engine's decode (8 slots, page 16, T 67, kv_len 256-1056). Every
    kernel is held to its plain version on the inputs it is timed on.
    Returns the six rows."""
    gen = torch.Generator(device="cuda").manual_seed(23)
    src = "src/repro_torch/kernels/csrc/"
    where = "the frontend shapes"

    def fwd_case(b, hq, hkv, s, d, dtype, causal, dropout):
        return fwd_time_case(torch, kfwd, gen, b, hq, hkv, s, d, dtype, causal,
                             dropout, where)

    def bwd_case(b, hq, hkv, s, d, dtype, causal, dropout):
        return bwd_time_case(torch, kfwd, kbwd, gen, b, hq, hkv, s, d, dtype,
                             causal, dropout, where)

    def decode_case(dtype):
        return decode_time_case(torch, kdecode, gen, 4, 56, 8, 128, 1056, 1040,
                                dtype, where)

    def paged_case(dtype):
        return paged_time_case(torch, kdecode, gen, 56, 8, 128, 67, (256, 1057),
                               dtype, where)

    fwd_src = {"route": "cuda", "source": src + "flash_fwd.cu",
               "replaces": "src/repro/kernels/flash_fwd.py:46"}
    bwd_src = {"route": "cuda", "source": src + "flash_bwd.cu",
               "replaces": "src/repro/kernels/flash_bwd.py:98, "
                           "src/repro/kernels/flash_bwd.py:164"}
    serve, paged = vlm_serve["serve"], vlm_serve["paged"]
    enc_fwd = {"name": "flash_fwd (hubert-xlarge training)", **fwd_src,
               "launches": enc_train["flash_fwd"],
               "shape": "B 8, 16/16 heads, S 1024, D 80, non-causal, dropout 0.1",
               "library_note": "sdpa, is_causal False, dropout_p 0.1"}
    enc_bwd = {"name": "flash_bwd (hubert-xlarge training)", **bwd_src,
               "launches": enc_train["flash_bwd"], "shape": enc_fwd["shape"],
               "library_note": "sdpa backward (dq, dk, dv), is_causal False, "
                               "dropout_p 0.1"}
    vlm_fwd = {"name": "flash_fwd (llava-next-34b prefill)", **fwd_src,
               "launches": (serve["flash_fwd"] + paged["flash_fwd"]
                            + vlm_train["flash_fwd"]),
               "launches_by_path": {"vlm_serve": serve["flash_fwd"],
                                    "vlm_paged_serve": paged["flash_fwd"],
                                    "vlm_train": vlm_train["flash_fwd"]},
               "shape": "B 4, 56/8 heads, S 1024, D 128, causal; train_shape_: "
                        "B 1, S 2048, causal, dropout 0.1"}
    vlm_bwd = {"name": "flash_bwd (llava-next-34b training)", **bwd_src,
               "launches": vlm_train["flash_bwd"],
               "shape": "B 1, 56/8 heads, S 2048, D 128, causal, dropout 0.1",
               "library_note": "sdpa backward (dq, dk, dv), GQA by enable_gqa, "
                               "dropout_p 0.1"}
    vlm_dec = {"name": "flash_decode (llava-next-34b decode)", "route": "cuda",
               "source": src + "flash_decode.cu",
               "replaces": "src/repro/kernels/decode.py:131",
               "launches": serve["flash_decode"],
               "shape": "B 4, 56/8 heads, 1040 of 1056 slots, D 128"}
    vlm_pag = {"name": "flash_paged_decode (llava-next-34b)", "route": "cuda",
               "source": src + "flash_decode.cu",
               "replaces": "src/repro/kernels/decode.py:136",
               "launches": paged["flash_paged_decode"],
               "launches_by_path": {"vlm_paged_serve": paged["by_mode"]},
               "shape": "8 slots, 56/8 heads, D 128, page 16, T 67, kv_len 256-1056",
               "library_note": "sdpa on the gathered contiguous cache with kv_len "
                               "as a mask, gather excluded"}
    rows = (enc_fwd, enc_bwd, vlm_fwd, vlm_bwd, vlm_dec, vlm_pag)
    for dtype, pre in ((torch.float32, ""), (torch.bfloat16, "bf16_")):
        for row, r in (
                (enc_fwd, fwd_case(8, 16, 16, 1024, 80, dtype, False, 0.1)),
                (enc_bwd, bwd_case(8, 16, 16, 1024, 80, dtype, False, 0.1)),
                (vlm_fwd, fwd_case(4, 56, 8, 1024, 128, dtype, True, 0.0)),
                (vlm_bwd, bwd_case(1, 56, 8, 2048, 128, dtype, True, 0.1)),
                (vlm_dec, decode_case(dtype)),
                (vlm_pag, paged_case(dtype))):
            row.update({pre + key: val for key, val in r.items()})
        vlm_fwd.update({pre + "train_shape_" + key: val for key, val in
                        fwd_case(1, 56, 8, 2048, 128, dtype, True, 0.1).items()})
    for row in rows:
        for pre, name in (("", "f32"), ("bf16_", "bf16"),
                          *((("train_shape_", "f32 at training"),
                             ("bf16_train_shape_", "bf16 at training"))
                            if row is vlm_fwd else ())):
            print(f"[times] {row['name']} {name}: kernel {row[pre + 'ms']:.5f} ms"
                  + (f", plain {row[pre + 'plain_ms']:.4f} ms"
                     if pre + "plain_ms" in row else "")
                  + f", library {row[pre + 'library_ms']:.5f} ms "
                  f"({row[pre + 'ms'] / row[pre + 'library_ms']:.2f}x), bound "
                  f"{row[pre + 'bound_ms']:.5f} ms ({row[pre + 'bound_by']})"
                  + (f", 3xTF32 {row[pre + 'bound_ms_3xtf32']:.5f} ms"
                     if pre + "bound_ms_3xtf32" in row else "")
                  + f", max|kernel - plain| {row[pre + 'max_abs_err']:.3e}; "
                  f"launches {row['launches']}", flush=True)
    torch.cuda.empty_cache()
    return list(rows)


def device_times_phase(rows) -> None:
    """Rows 4-6 gain the kernel's device time alone and the wrapper's host
    time (``perf/decode_times.py``): ``device_ms`` from ``torch.profiler``
    (or a CUDA graph) over launches rotating over cache copies whose bytes
    exceed the L2 (cold, as each layer of the engine finds its pages), and
    ``host_us`` a wrapper call; ``<shape>_shape_`` the same at the other
    shapes (chunk, decode with 32 and 64 slots, verify), and row 5 the
    bound of the shapes phase 6 does not time itself."""
    from repro_torch.perf import decode_times

    by_name = {row["name"]: row for row in rows}
    for name, shapes in decode_times.measure().items():
        for shape, r in shapes.items():
            prefix = "" if shape == "decode" else f"{shape}_shape_"
            for key in ("device_ms", "device_ms_method", "device_ms_copies",
                        "host_us"):
                by_name[name][prefix + key] = r[key]
            if "bound_ms" in r and prefix + "bound_ms" not in by_name[name]:
                by_name[name][prefix + "bound_ms"] = r["bound_ms"]
            print(f"[times] {name} at the {shape} shape: device "
                  f"{r['device_ms']:.5f} ms ({r['device_ms_method']}, cold L2: "
                  f"{r['device_ms_copies']} cache copies), host "
                  f"{r['host_us']:.2f} us a wrapper call"
                  + (f", bound {r['bound_ms']:.5f} ms" if "bound_ms" in r else ""),
                  flush=True)


if __name__ == "__main__":
    main()
