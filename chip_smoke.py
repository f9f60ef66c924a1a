#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printed as it ends with its seconds; any failed check exits
non-zero:

  1. environment: torch, the card, ``nvidia-smi`` name and power limit;
  2. build: compile ``csrc/semiring_spmv.cu`` and
     ``csrc/engine_receive.cu`` with nvcc, print ptxas' registers, shared
     memory and spills per kernel;
  3. the kernels against their plain PyTorch version on the same inputs —
     every (semiring, dtype) of the sweep and the tensor-core
     ``plus_times`` at 1/3/8 random-dst blocks (the scalar kernel's
     unsorted path), the all-padding block, the max clamp, the RMAT 2^18
     pull stream of the main path and the ``asymp_pagerank`` (RMAT 2^14)
     stream of the oracle (the sorted path); idempotent semirings exactly,
     ``plus_times`` (both forms) within rtol/atol 1e-5 (their sum orders
     differ), and two launches of each ``plus_times`` form on the RMAT
     2^18 stream bitwise equal — then each form's device time there beside
     the plain version's, one ``scatter_reduce_`` call's and its bound
     (the tensor-core form weighted and unweighted at RMAT 2^18 and
     unweighted at RMAT 2^14, the shape phase 6 launches, each with the
     (k-step, M tile) pairs it issues);
  4. the main path at full size: ``asymp_cc_large`` (RMAT 2^18, 8 shards)
     to convergence on the prioritized engine, the kernel-backed BSP
     baseline, and the dense pagerank oracle (the kernel's plus_times
     form); engine labels must equal BSP labels, the SpMV kernel's
     launches must equal the BSP rounds and the pagerank iterations, and
     the receive kernel's (``csrc/engine_receive.cu``) the engine's ticks;
     then a profiled BSP run and a profiled window of engine ticks (device
     time by op, busy share); then the receive kernel on the next tick's
     own receive (its pre-receive planes and the exchange's views) and at
     the benchmark's shape (``[8, 8, 255,000]`` views, about 9 k live
     slots, every idempotent form): bitwise its plain version, its device
     time beside the plain version's, one ``scatter_reduce_`` call's and
     its bound (the id scan and the state planes' copies);
  5. the ``benchmarks/bench_speed.py --smoke`` configs (RMAT 2^12): the
     fixpoints against the union-find and labelprop oracles, and the
     tick/message counts beside the JAX package's committed baselines;
     one receive launch a tick;
  6. push-mode pagerank at ``asymp_pagerank`` (RMAT 2^14, degree 16) to
     convergence, held to ``tests/test_pagerank.py``'s verdict against the
     kernel-backed dense oracle (80 iterations, absorb), then one
     tensor-core pull step on the oracle's contribution vector against the
     scalar form's;
  7. faults (paper §5.5), ``FaultPlan(0.5, start_tick=4, every=6)``:
     ``asymp_cc_large`` by replay — labels equal the fault-free labels,
     4 failures, one receive launch a tick — and ``asymp_pagerank`` by
     global checkpoint restore — no replay, the verdict of phase 6;
  8. ``wire``: ``asymp_cc_wire`` (RMAT 2^14, int16 labels and ids) to
     convergence, its labels equal to the raw-wire ``asymp_cc_small``
     run's; the codec's int16/int8 encode and decode of ints and of
     up/down-rounded floats on the card bitwise equal to the same calls on
     the CPU; the wire bytes a tick, raw and int16;
  9. ``crowded_main`` (paper §5.4), this slice's path at full width:
     ``asymp_cc_large`` under ``latency_profile="stragglers"``, half the
     shards crowded (link delay 2, budget / 4; what ``graph_mine --config
     asymp_cc_large --slowdown 0.5 --link-delay 2 --intensity 4`` runs) to
     convergence: labels equal phase 4's, the delay ring drained, one
     receive launch a tick; ticks,
     messages, the degradation against phase 4's ticks, wall time, peak
     memory; then a profiled window of crowded ticks and one of async
     ticks on the same graph and profile;
 10. ``crowded_smoke``, ``benchmarks/bench_crowded.py --smoke`` on the card
     (RMAT 2^12 SSSP, 8 shards): healthy and crowded tick counts of the
     priority, FIFO and async schedulers equal the JAX package's
     baselines, the §5.4 gates hold, every fixpoint equals the healthy
     one, one receive launch a tick of the six runs, and the healthy
     distances equal the kernel-backed ``min_plus`` pull iterated from
     the program's initial values to its fixpoint;
 11. ``crowded_faults``: ``asymp_cc_crowded`` (RMAT 2^14), sync and async,
     under kills plus slowdowns: labels equal the fault-free labels, 4
     failures, messages replayed;
 12. ``elastic``: ``asymp_cc_large`` ticked 600 steps on 8 shards, saved
     and restored through ``ft.checkpoint.CheckpointManager``, re-split
     onto 4 shards (``ft.elastic.repartition_state``; the 4-shard graph
     assembled from the 8-shard edge list) and converged: labels equal
     phase 4's, and no more vertices active than the old cut plus those
     active before;
 13. ``serve_main``, the serving plane at full width: what ``graph_serve
     --config asymp_cc_large --programs cc,sssp --store <tmp> --queries 256
     --deltas 4`` runs, through the classes: CC and SSSP converged and
     published, 256 queries in 16 slots, 4 one-edge deltas streamed
     through ``begin_delta`` -> ``step(2)`` -> ``commit`` with a query batch
     between steps (``bench_load``'s closed loop): 0 torn reads, 0
     rejections, lag at most 1; after the last commit CC equals the
     kernel-backed BSP and SSSP the ``min_plus`` pull's fixpoint on the
     patched graph, each kernel's launches equal their rounds, and each
     round's partials equal the plain version's;
 14. ``serve_smoke``: the ``bench_serve --smoke`` and ``bench_load --smoke``
     scenarios, their counts equal to ``benchmarks/baselines/
     BENCH_{serve,load}.json`` (pagerank's delta held to the push_eps
     ball, its counts beside the baseline's);
 15. ``serve_rank``: ``asymp_pagerank`` served with CC, 2 one-edge deltas,
     each commit held to the pagerank verdict against the kernel-backed
     dense oracle on the patched graph;
 16. ``dist_nccl``: ``asymp_cc_wire`` on one shard as a 1-rank NCCL group
     (NCCL takes one rank per card), int16 labels and ids crossing the
     collective as bytes: bitwise the local tick every tick, to quiescence;
 17. ``dist_main``, multi-rank execution at full width: ``asymp_cc_large``
     (RMAT 2^18) as 8 ranks of one gloo group sharing the card (gloo
     stages the CUDA tensors through the host), each rank mapping its rows
     of the graph built in phase 4 from ``.npy`` files: every tick's
     global ``TickStats`` equal phase 4's, 1,246 ticks and 19,678,958
     messages, the labels phase 4's; ms a tick, the collective's ms, each
     rank's peak memory.  Eight processes time-slicing one card measure
     contention and host staging, not scaling;
 18. ``dist_crowded`` and ``dist_async``: ``asymp_cc_crowded`` on the 8
     ranks under the crowded and the async dist ticks, rank 0 holding
     every tick's gathered state (ring and clock included) and counters
     bitwise to the local tick's; the ring drained, the labels phase 11's
     fault-free labels;
 19. ``dist_rank``: ``asymp_pagerank`` on the 8 ranks for a window of
     ticks, the mass balance within 1e-5 every 100 (the verdict too if it
     converges in the window; not bitwise: the card's scatter-add is
     atomic);
 20. ``lm_serve``, the dense LM at full width: qwen3-4b (``LM_LAYERS``
     of its 36 layers, bf16 weights from a seeded generator on the
     card) served as ``python -m repro_torch.launch.serve --arch qwen3-4b
     --no-reduced`` runs it (6 requests of 16 tokens, 2 slots, 12 new
     tokens each): each request equal to the card's ``generate`` of its
     prompt alone, and teacher-forced against a full forward (a difference
     only at a bf16 near tie, gap < 0.15; 75% the argmax); every logit
     finite; prefill ms at 16 and 4,096 tokens and decode ms a step at 2
     slots (median of 5, synchronised) beside their bounds, the served
     tokens a second, weight bytes and peak memory; one layer's attention
     at 4,096 tokens (the flash path) held to the dense path; the reduced
     qwen3-4b on the card held to the same weights on the CPU.  It
     launches no SpMV kernel (checked): its products are cuBLAS's;
 21. ``lm_train``, the dense LM trained at full width: qwen3-4b
     (``LM_LAYERS`` layers, remat "full", AdamW) as ``python -m repro_torch.launch.train --arch
     qwen3-4b`` runs it (batch 8, seq 128, lr 3e-4 warmed up over 1 of 10
     steps): every loss and grad norm finite and the mean loss of the last
     3 steps below the first step's; ms a step and tokens a second beside
     the step's bound, one profiled step (device busy share, device time
     by op) and the peak memory; then 2 steps at 1 x 4,096 tokens (the
     flash forward and its autograd backward, counted), one layer's flash
     gradients at 4,096 tokens held to dense attention's, the 8-layer
     reduced model trained 2 steps on the card and on the CPU from the
     same weights (loss, grad norm, params), and a checkpoint round trip
     (bitwise, and the next step's loss).  It launches no SpMV kernel;
 22. ``lm_moe_serve``, the MoE family served at full width: phi3.5-moe
     (d 4096, 32/8 x 128 GQA, 16 experts top-2, d_ff 6400;
     ``MOE_SERVE_LAYERS`` of its 32 layers, a scan stack of [L, E, D, F]
     expert leaves, bf16 weights from a seeded generator on the card) under the serve
     launcher's defaults (6 requests of 16 tokens, 2 slots, 12 new
     tokens): every logit finite; the layer-0 MoE output of a 2-row decode
     step and of a 4,096-token prefill held to the plain per-token fp32
     MoE with the same selections and the host's replay of the keep mask;
     each request's first token teacher-forced against a full forward (a
     prefill groups the prompt as the full forward does); reported, not
     gated: the requests equal to ``generate`` alone and the later tokens'
     argmax share (decode buckets each step's tokens alone, a full forward
     the whole sequence: capacity drops differ by the reference's
     semantics, ROADMAP §3), the dropped pairs a decode step, prefill ms at
     16 and 4,096 tokens and decode ms beside their bounds, peak memory and
     busy share; the reduced phi3.5 on the card against the CPU;
 23. ``lm_moe_train``: phi3.5-moe at 4 of 32 layers (5,463,867,392
     parameters) trained as ``python -m repro_torch.launch.train --arch
     phi3.5-moe-42b-a6.6b --layers 4`` runs it (AdamW, remat "full", batch
     8 x seq 128, 10 steps): every loss, aux and grad norm finite, the
     mean loss of the last 3 below the first; ms a step, tokens a second,
     a profiled step, peak; then a checkpoint round trip of the 8-layer
     reduced config (the stacked expert leaves), bitwise and the next loss
     equal;
 24. ``moe_a2a``: one phi3.5-moe layer at full width expert-parallel on 4
     gloo ranks sharing the card, 4 x 512 tokens, on data 1 x model 4 and
     data 2 x model 2 (the FSDP gather): each rank's output block held to
     the plain per-token reference with the keep mask of the host's replay
     of the routing (sender and receiver drops), the global aux to one
     process's; the backward of ``sum(y * ct) + aux`` through the
     all-to-alls and the gather (each rank its share), every gradient held
     to the plain reference's (one process, the same picks and keep mask);
     the collectives' ms and bytes a rank, the backward's ms;
 25. ``lm_ssm_serve``, mamba2-780m (d 1536, SSD layers) and hymba-1.5b
     (d 1600, hybrid layers: attention 25/5 x 64 beside 50 SSD heads, a
     1,024-token window but in layers 0, L/2 and L-1) at full width, depth
     cut to ``SSM_LAYERS`` (12 of 48, 8 of 32), served as ``python -m repro_torch.launch.serve --arch <arch>
     --no-reduced`` serves them (6 requests of 16 tokens, 2 slots, 12 new),
     in bf16 and timed, then the same weights in fp32: each request against
     ``generate`` of its prompt alone (equal, or the first difference a
     near tie) and the recurrent decode's logits along it against a full
     forward's (the chunked scan), within 1e-3 of max|logit| in fp32 (in
     bf16 the two round in other places and drift apart with depth, in the
     reference too, so bf16 is reported: ROADMAP.md §3); prefill ms at
     16 and 4,096 tokens and decode ms a step beside their bounds, tokens
     a second, peak memory, busy share; the 4,096-token
     prefill (hymba: blocked windows, 3 flash layers, rings from then
     on) with layer 0's chunked scan held to the fp32 sequential recurrence
     on its inputs, then 8 decode steps from its cache, their logits
     against a full forward's (fp32 held, bf16 reported); the reduced
     configs on the card against the CPU;
 26. ``lm_ssm_train``: both at that depth trained as ``python -m
     repro_torch.launch.train --arch <arch>`` trains them (10 steps):
     every loss and grad norm finite, the mean of the last 3 below the
     first; ms a step, tokens a second, a profiled step, peak; 2 steps at
     1 x 4,096 (hymba: the blocked window's backward past the window,
     counted); a checkpoint round trip of the reduced config;
 27. ``ssd_seq_parallel``: one mamba2 layer's SSD at full width on 4 gloo
     ranks sharing the card, 1 x 4,096 tokens (1,024 a rank, 8 chunks):
     each rank's output and the input gradients against one process's
     ``ssd_chunked`` over the whole sequence; the call's ms and the bytes
     a rank gathers;
 28. ``lm_mla_serve``, deepseek-v3 at full width (d 7168, MLA with a
     packed compressed cache, 256 experts top-8 and a shared one), depth
     cut to ``MLA_SERVE_LAYERS`` (3 dense, 2 MoE; 54.6 GB), served with the
     serve launcher's defaults: first tokens teacher-forced (gated), the
     requests equal to ``generate`` alone, later tokens' argmax share and
     dropped pairs a decode step (reported); the first MoE layer of a
     decode step and a 4,096-token prefill against the plain MoE; prefill
     and decode ms beside their bounds, busy share, peak; MLA layer 0's
     absorbed decode against its materialised train path and its flash
     path against dense at 4,096; the reduced config on the card against
     the CPU;
 29. ``lm_mla_train``: deepseek-v3 at ``MLA_TRAIN_LAYERS`` (3 dense, 1 MoE)
     plus the MTP head, Adafactor, 10 steps at 8 x 128 at the launcher's lr
     (finite, reported) and at ``MLA_TRAIN_LR`` (finite, the mean of the
     last 3 below the first); ms a step beside the bound, a profiled step,
     the memory reckoning and peak; 2 steps at 1 x 4,096 (the flash
     backward with q/k 192 and v 128 wide, counted); a checkpoint round
     trip of the 8-layer reduced config;
 30. ``lm_encdec_serve``: whisper-medium at full width and depth (24 + 24
     layers, 1,500 frames): ``generate`` with features, every served token
     against a teacher-forced ``decode_stack`` (near-tie rule); encoder,
     prefill and decode ms beside their bounds; the reduced config on the
     card against the CPU;
 31. ``lm_encdec_train``: whisper-medium trained as ``python -m
     repro_torch.launch.train --arch whisper-medium`` trains it (8 x 128,
     1,500 frames a row, 10 steps): finite, falling losses; ms a step
     beside the bound, peak; a checkpoint round trip of the reduced config;
 32. ``dryrun``, the dry run and the roofline (``launch/dryrun.py``,
     ``roofline/``): ``lower_cell`` for every arch at ``decode_32k`` and
     for qwen3-4b at ``train_4k`` on the 16 x 16 mesh (one shape an arch:
     the whole grid takes minutes of host time, the ``train_4k`` row
     alone over a minute, and ``python -m repro_torch.launch.dryrun
     --all`` runs it) and the ``asymp_cc_prod`` and
     ``asymp_cc_crowded_prod`` tick cells, into a fresh directory, one line
     a cell (status, argument GB a rank, the compute, memory and
     collective terms on the card's peaks, the dominant term, the useful
     ratio), any ``FAIL`` failing the run; rank 0's block of qwen3-4b's
     ``train_4k`` state and batch allocated on the card, the rise of
     ``memory_allocated`` equal to the record's ``argument_bytes`` with each
     leaf rounded up to the allocator's 512 B; one layer of each family
     (dense, MoE, SSM, hybrid, MLA dense and MoE, whisper's decoder layer)
     at full width timed with CUDA events, fwd+bwd at 8 x 128 and a decode
     step with 2 slots, beside its probe's compute and memory terms and the
     measured-over-bound ratio;
 33. ``{"kernels": [...]}``, then the card's nvidia-smi line, then the last
     line ``{"ok": true, "device": {...}}``.

SpMV launch counts are set to 0 before each path (4, 6, 7, 9, 10, 12, 13, 15,
20-32) and read after it.  The LM and dry-run phases (20-32) launch no
SpMV kernel (checked): they reach no ``pl.pallas_call`` in the reference.  The
multi-rank phases launch no SpMV kernel; each rank's engine tick launches
the receive kernel in its own process (not counted here).  Their labels
are held to phase 4's, which equal the kernel-backed BSP's.  The ranks are one pool of spawned processes for all
the gloo phases; a rank that fails ends the run with a non-zero exit.

It imports nothing of JAX or of the JAX package ``repro``.
"""
from __future__ import annotations

import copy
import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_FP32_OPS_PER_S = 67e12  # non-tensor float32; int32 compares taken alike
H100_BF16_TENSOR_OPS_PER_S = 989e12  # dense bf16 tensor cores
SLEEP_CYCLES_PER_S = 1.98e9  # the H100 SXM's top SM clock: a sleep of this
# many cycles lasts at least one second
SWEEP = [("min", "int32"), ("min", "float32"), ("min_plus", "float32"),
         ("max", "int32"), ("max", "float32"), ("max_min", "float32"),
         ("or", "int32"), ("plus_times", "float32")]
# bench_speed smoke counts in benchmarks/baselines/BENCH_speed.json
SMOKE_BASELINE = {"cc": (120, 129164), "labelprop": (121, 129566)}
PAGERANK_ITERS = 5
PROFILE_WARM_TICKS, PROFILE_TICKS = 100, 20
# the benchmark's receive (portbench's g500-wcc cells): 8 shards of 65,536
# vertices, the exchange's [8, 8, 255,000] views, about 9 k live slots
RECEIVE_SHAPE, RECEIVE_VS, RECEIVE_LIVE = (8, 8, 255_000), 65_536, 5.5e-4
# the JAX package's seeded, fault-free asymp_pagerank run (CPU): ticks and
# messages.  The card's float scatter-add is atomic, so its counts may move
JAX_PAGERANK = (7202, 98730925)
ORACLE_ITERS = 80
PUSH_EPS = 1e-5
# benchmarks/bench_crowded.py: the two policies, the two conditions, and
# the smoke counts of benchmarks/baselines/BENCH_crowded.json as (healthy,
# crowded) ticks
FIFO = dict(priority="disabled", straggler_demote=0)
PRIORITY = dict(priority="log", straggler_demote=8)
HEALTHY = dict(profile="uniform", link_delay=0)
CROWDED = dict(profile="stragglers", slow_fraction=0.5, link_delay=2,
               intensity=4)
CROWDED_BASELINE = {"priority": (172, 201), "fifo": (270, 297),
                    "async": (172, 148)}
# graph_mine --slowdown 0.5 --link-delay 2 --intensity 4
SLOWDOWN = dict(latency_profile="stragglers", slow_fraction=0.5,
                link_delay=2, slow_intensity=4)
CROWDED_WARM_TICKS, ASYNC_WARM_TICKS = 100, 20
# elastic: asymp_cc_large ticked on 8 shards for 600 of its 1,246 ticks,
# then re-split onto 4
ELASTIC_TICKS, ELASTIC_SHARDS = 600, 4
# graph_serve --queries 256 --deltas 4 with its 16 slots
SERVE_QUERIES, SERVE_SLOTS, SERVE_DELTAS = 256, 16, 4
# the smoke counts of benchmarks/baselines/BENCH_serve.json (delta1_cc:
# reactivated % of V, lag ticks, scratch ticks, exact) and BENCH_load.json
SERVE_CC_BASELINE = (0.024, 15, 154, 1)
SERVE_PR_BASELINE = {"reactivated": 36, "lag_ticks": 391}
LOAD_BASELINE = {"torn": 0, "rejected": 0, "lag_max": 1, "lag_final": 0,
                 "deltas": 3, "served": 384}
PPR_BASELINE = {"hits": 2, "misses": 2, "invalidations": 2}
# the multi-rank phases: 8 gloo ranks sharing the card; the main path's
# ticks and messages at asymp_cc_large, which dist_main must reproduce
DIST_RANKS, DIST_TIMEOUT_S, DIST_A2A_REPS = 8, 600, 20
MAIN_PATH_COUNTS = (1246, 19678958)
DIST_LOCKSTEP_TICKS, DIST_RANK_TICKS = 20000, 1000
# lm_serve: qwen3-4b at full width (LM_LAYERS deep), served as launch/serve's
# defaults run it (6 requests of 16 tokens, 2 slots, 12 new tokens each);
# one prefill of LM_LONG tokens takes the flash path (> 2048).  LM_GAP is
# tests/test_serve.py's bf16 near tie; LM_FLASH_TOL is the CPU test's
# flash-against-dense tolerance and LM_CARD_TOL its 2-layer logits
# tolerance against the JAX package (tests/test_torch_lm.py), both of
# max|out|
LM_ARCH, LM_REQUESTS, LM_SLOTS, LM_PROMPT, LM_MAX_NEW = "qwen3-4b", 6, 2, 16, 12
# the earlier LM phases run at a cut depth, so the whole script stays
# inside its time limit with the MLA and encoder-decoder phases (at full
# depth the phases took 1,155 s on one H100 host): qwen3-4b LM_LAYERS
# of 36 layers served and trained, phi3.5 MOE_SERVE_LAYERS of 32 served
# (still a scan stack), mamba2 and hymba SSM_LAYERS of 48 and 32
LM_LAYERS = 12
LM_LONG, LM_REPS, LM_GAP = 4096, 5, 0.15
LM_FLASH_TOL, LM_CARD_TOL = 2.4e-2, 5.0e-2
# lm_train: qwen3-4b at full width (LM_LAYERS deep) trained as launch/train's
# defaults run it (batch 8, seq 128, lr 3e-4, cosine warm-up over steps //
# 10); then 2 steps at 1 x LM_LONG tokens (the flash path).  The optimizer
# and clip move LM_TRAIN_OPT_BYTES a parameter.  LM_FLASH_GRAD_TOL is the
# CPU test's flash-against-dense gradient tolerance (tests/test_torch_
# train.py), of max|grad|; LM_TRAIN_CARD_TOL holds the loss and grad norm of
# the 8-layer reduced model on the card to the CPU's (relative);
# LM_TRAIN_CKPT_TOL the loss after a restore to the uninterrupted run's
LM_TRAIN_STEPS, LM_TRAIN_BATCH, LM_TRAIN_SEQ, LM_TRAIN_LR = 10, 8, 128, 3e-4
LM_TRAIN_OPT_BYTES = 28
LM_FLASH_GRAD_TOL, LM_TRAIN_CARD_TOL, LM_TRAIN_CKPT_TOL = 3.2e-2, 1.0e-2, 1e-4
# the MoE phases: phi3.5-moe at full width (d 4096, 16 experts top-2, d_ff
# 6400), depth cut to fit the card and the time limit: MOE_SERVE_LAYERS
# served (a scan stack, 21.3 GB of weights), MOE_TRAIN_LAYERS trained
# (AdamW, ~68 GB).  One MoE
# layer runs expert-parallel on MOE_RANKS gloo ranks sharing the card,
# MOE_BATCH x MOE_SEQ tokens, on each of MOE_MESHES.  MOE_PLAIN_TOL holds
# a bf16 MoE output to the plain per-token fp32 one (of max|y|; a CPU
# sweep at d 512-1024 gave 3.5e-3-5.3e-3); MOE_AUX_TOL the mesh's aux to
# one process's (relative; a routing flip at a near tie moves it ~1e-5);
# MOE_CARD_SHARE the share of the reduced model's positions within
# LM_CARD_TOL on the card against the CPU (tests/test_torch_moe.py's
# rule: the rest are routing flips)
MOE_ARCH, MOE_SERVE_LAYERS, MOE_TRAIN_LAYERS = "phi3.5-moe-42b-a6.6b", 8, 4
MOE_RANKS, MOE_BATCH, MOE_SEQ, MOE_REPS, MOE_SEED = 4, 4, 512, 5, 20
MOE_MESHES = ({"data": 1, "model": 4}, {"data": 2, "model": 2})
MOE_PLAIN_TOL, MOE_AUX_TOL, MOE_CARD_SHARE = 2.0e-2, 1e-4, 0.75
# the backward of the expert-parallel layer against the plain reference's,
# of each max|grad| (this phase on the CPU at d 512, d_ff 1024, 16 experts:
# at most 1.3e-2, w_gate's)
MOE_GRAD_TOL = 4.0e-2
# the SSM and hybrid phases: mamba2-780m and hymba-1.5b at full width and
# depth (nothing cut), served as launch/serve's defaults then a prefill of
# LM_LONG tokens (hymba: past its 1,024-token window) and SSM_DECODE steps
# from its cache; trained as launch/train's defaults, then 2 steps at 1 x
# LM_LONG.  SSM_SCAN_TOL holds the chunked scan (bf16 x, B, C as the model
# forms them; its output bf16) to the fp32 sequential recurrence on the same
# inputs, of max|y| (tools/ssm_numerics.py: ssd_seq_inputs' draws at both
# archs' widths, 512 tokens, seeds 0-2 on the CPU, at most 4.7e-3);
# SSM_HYBRID_LAYERS is the reduced hymba's depth on the card against the
# CPU (layer 1 windowed).
# One mamba2 layer's SSD runs sequence-parallel on SSM_SEQ_RANKS gloo ranks
# sharing the card, 1 x SSM_SEQ_LEN tokens, held to one process's
# ssd_chunked within SSM_SEQ_TOL of max|y| and of each max|grad| (this
# phase on the CPU: y bitwise, the bf16 gradients within 2.3e-3; the last
# bit of a bf16 element near max|grad| is 3.9e-3-7.8e-3 of it)
SSM_ARCHS, SSM_DECODE, SSM_HYBRID_LAYERS = ("mamba2-780m", "hymba-1.5b"), 8, 4
SSM_LAYERS = {"mamba2-780m": 12, "hymba-1.5b": 8}
SSM_SCAN_TOL, SSM_SEQ_TOL = 1.9e-2, 1.6e-2
# SSM_DECODE_TOL holds the fp32 recurrent decode's logits (teacher-forced
# along a served sequence) to one fp32 full forward's, the chunked scan, of
# max|logit| (tools/ssm_numerics.py: the reduced configs at full depth on
# the CPU, 48 and 32 layers, 2.6e-5 and 3.6e-6).  In bf16 the two paths
# round in other places and drift apart with depth: the reference's own
# decode is 0.265 (mamba2) and 0.092 (hymba) of max|logit| from its
# forward there, the port's 0.277 and 0.122, so the bf16 run is reported
# and the fp32 run is held
SSM_DECODE_TOL = 1.0e-3
SSM_SEQ_RANKS, SSM_SEQ_LEN, SSM_SEQ_REPS, SSM_SEQ_SEED = 4, 4096, 5, 40
# MLA and MTP: deepseek-v3 at full width, depth cut to fit the card (61
# layers are 671 B parameters; one MoE layer's experts 22.55 GB of bf16):
# MLA_SERVE_LAYERS served (3 dense, 2 MoE: 54.6 GB of weights), MLA_TRAIN_
# LAYERS trained with the MTP head (3 dense, 1 MoE: 31.6 GB of weights,
# the same of gradients; Adafactor's moments are factored).  MLA_ABSORB_
# TOL holds layer 0's absorbed decode to its materialised train path at
# the same positions, of max|y| (one full-width MLA layer on the CPU, 8
# decode steps past 16 tokens, seeds 0-2: at most 5.4e-3).  LM_ADAFACTOR_
# BYTES is the clip's and Adafactor's traffic a parameter: the norm's read
# of the bf16 gradient, the clip's read and write, Adafactor's three
# reads of it (moments, the update's RMS, the update), the parameter's
# read and write
MLA_ARCH, MLA_SERVE_LAYERS, MLA_TRAIN_LAYERS = "deepseek-v3-671b", 5, 4
MLA_ABSORB_TOL, LM_ADAFACTOR_BYTES = 2.2e-2, 16
# the train launcher's lr 3e-4 does not train deepseek at full width under
# Adafactor (the reference's init: experts at 1/sqrt(256); ROADMAP §3):
# the card's losses rose from 17.24 within 10 steps at 3e-4 and 3e-5, and
# fell at 1e-5 (to 12.0-12.4) and 3e-6 (to 16.3-16.5).  lm_mla_train
# reports the 3e-4 run and holds the MLA_TRAIN_LR run to a falling loss
MLA_TRAIN_LR = 1e-5
# the encoder-decoder: whisper-medium at full width and depth (24 + 24
# layers, 1,500 frames; nothing cut), served with LM_SLOTS rows of
# LM_PROMPT tokens and LM_MAX_NEW new, trained as launch/train's defaults
ENCDEC_ARCH = "whisper-medium"


class SmokeFailure(Exception):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def say(phase: str, **kw) -> None:
    print(f"[chip_smoke] {phase}: " + json.dumps(kw, default=str), flush=True)


def cuda_ms(torch, fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``reps`` launches (CUDA events).

    A sleep kernel holds the stream for twice the host's measured time to
    enqueue ``reps`` calls, so the launches run back to back and the time
    is the device's, not the host's launch rate (a kernel of a few
    microseconds is faster than its Python wrapper)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2 * host_s * SLEEP_CYCLES_PER_S))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_abs_err(torch, a, b) -> float:
    a, b = a.double(), b.double()
    same = (a == b) | (torch.isnan(a) & torch.isnan(b))
    return float(torch.where(same, 0.0, (a - b).abs()).max()) if a.numel() \
        else 0.0


def spmv_inputs(np, torch, rng, n, dtype, dst=None):
    if dtype == "int32":
        vals = rng.integers(0, 10_000, n).astype(np.int32)
    else:
        vals = rng.uniform(0.0, 10.0, n).astype(np.float32)
    if dst is None:
        dst = rng.integers(-1, 128, n).astype(np.int32)
    w = rng.uniform(0.1, 1.0, n).astype(np.float32)
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda()  # noqa: E731
    return put(vals), put(dst), put(w)


def device_profile(torch, fn) -> dict:
    """Run ``fn`` once under the profiler: wall time, device busy time and
    share, and the ten ops with the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def device_us(row):
        return getattr(row, "self_device_time_total",
                       getattr(row, "self_cuda_time_total", 0.0))

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    # kernel rows sum to the device's busy time; op rows (aten::*) carry
    # the same time again, attributed to the op that launched it
    rows = prof.key_averages()
    on_card = [r for r in rows if r.device_type == DeviceType.CUDA]
    by_op = sorted((r for r in rows if r.device_type != DeviceType.CUDA),
                   key=device_us, reverse=True)
    busy_us = sum(device_us(r) for r in on_card)
    return {"window_s": window_s, "device_busy_s": busy_us / 1e6,
            "device_busy_share": (busy_us / 1e6 / window_s if busy_us
                                  else "not measured"),
            "top_ops_device_ms": [(r.key, device_us(r) / 1e3, r.count)
                                  for r in by_op[:10]]}


def ptxas_summary(report: str, semirings) -> dict:
    """nvcc's ``-Xptxas -v`` report as {kernel form: registers, shared
    memory and spill bytes}."""
    import re
    out, name = {}, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            mangled = m.group(1)
            t = re.search(r"spmv_partials_kernelILi(\d)E([if])E", mangled)
            name = (f"{semirings[int(t.group(1))]}/"
                    f"{'int32' if t.group(2) == 'i' else 'float32'}" if t
                    else "plus_times_mxu/float32" if "mma" in mangled
                    else mangled)
            out[name] = {}
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            out[name].update(spill_stores=int(m.group(1)),
                             spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?", line)
        if m and name:
            out[name].update(registers=int(m.group(1)),
                             smem_bytes=int(m.group(2) or 0))
    return out


def bound_of(semiring, n, n_blocks, weighted, tile_steps=None):
    """Least time for one call: each input the function reads once (min,
    max and or ignore the weights), the output written once, against one
    combine and one reduce per edge (the tensor-core form: the bf16
    products these inputs need, one m16n8k16 of 2 x 16 x 8 x 16 FLOP per
    (k-step, M tile) pair in ``tile_steps``)."""
    reads_w = weighted and semiring in ("min_plus", "max_min", "plus_times")
    nbytes = n * (4 + 4 + (4 if reads_w else 0)) + n_blocks * 128 * 4
    if tile_steps is not None:
        t_ops = tile_steps * 2 * 16 * 8 * 16 / H100_BF16_TENSOR_OPS_PER_S * 1e3
    else:
        ops = n * (1 if semiring in ("min", "max", "or") else 2)
        t_ops = ops / H100_FP32_OPS_PER_S * 1e3
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), nbytes


def receive_views(torch, form, dev, seed: int):
    """``(old, active, cursor, recv_vals, recv_ids)`` at the benchmark's
    receive shape, the buffers as the local exchange hands them over:
    ``[P, Pn, cap]`` slices of ``[P, Pn, cap + 1]`` send buffers, seen
    transposed as ``[Pn, P, cap]`` views (not copies)."""
    name, dtype = form
    gen = torch.Generator(device=dev).manual_seed(seed)
    (p, r, c), vs = RECEIVE_SHAPE, RECEIVE_VS

    def draw(shape):  # ties are common; floats negative too
        if name == "or":
            return torch.randint(0, 2, shape, generator=gen, device=dev,
                                 dtype=torch.int32)
        x = torch.randint(-1000, 1000, shape, generator=gen, device=dev)
        return x.to(torch.int32) if dtype == "int32" else x.float() / 4

    ids = torch.full((r, p, c + 1), -1, dtype=torch.int32, device=dev)
    hit = torch.rand((r, p, c), generator=gen, device=dev) < RECEIVE_LIVE
    ids[..., :c] = torch.where(hit, torch.randint(
        0, vs, (r, p, c), generator=gen, device=dev, dtype=torch.int32), -1)
    vals = draw((r, p, c + 1))
    return (draw((p, vs)), torch.rand((p, vs), generator=gen, device=dev)
            < 0.2, torch.randint(0, 9, (p, vs), generator=gen, device=dev,
                                 dtype=torch.int32),
            vals[..., :c].transpose(0, 1), ids[..., :c].transpose(0, 1))


def receive_form(torch, RK, agg, case, where: str) -> dict:
    """The receive kernel on one case: launched once and bitwise its plain
    version (values, active, cursor, accepted), then its device time beside
    the plain version's, one ``scatter_reduce_`` call's over precomputed
    padded indices (the library yardstick) and its bound: every slot's id
    read once, and the three state planes copied (read and written: 4 + 1
    + 4 bytes a vertex each way)."""
    old, active, cursor, rv, ri = case
    n_p, vs = old.shape
    launches = RK.deliver.launches
    got = RK.deliver(agg, *case)
    want = RK.deliver_ref(agg, *case)
    torch.cuda.synchronize()
    check(RK.deliver.launches == launches + 1,
          f"the receive kernel did not launch once ({where})")
    for g, w, field in zip(got, want, ("values", "active", "cursor",
                                       "accepted")):
        check(torch.equal(g, w), f"the receive kernel's {field} differs "
                                 f"from its plain version ({where})")
    ms = cuda_ms(torch, lambda: RK.deliver(agg, *case), 50)
    plain_ms = cuda_ms(torch, lambda: RK.deliver_ref(agg, *case), 5)
    ids = ri.reshape(n_p, -1)
    idx = torch.where(ids >= 0, ids, vs).to(torch.int64)
    vals = rv.reshape(n_p, -1)
    buf = torch.cat([old, old[:, :1]], dim=1)
    reduce = {"min": "amin", "max": "amax", "or": "amax"}[agg.name]
    library_ms = cuda_ms(torch, lambda: buf.scatter_reduce_(
        1, idx, vals, reduce=reduce, include_self=True), 5)
    check(torch.equal(buf[:, :vs], got[0]),
          f"the receive's library yardstick disagrees ({where})")
    nbytes = ri.numel() * 4 + old.numel() * 2 * (4 + 1 + 4)
    bound_ms = nbytes / H100_BYTES_PER_S * 1e3
    return {"where": where, "aggregator": agg.name,
            "dtype": str(old.dtype).replace("torch.", ""),
            "shape": list(ri.shape), "strides": list(ri.stride()),
            "vertices_a_shard": vs, "live_slots": int((ri >= 0).sum()),
            "accepted": int(got[3].sum()), "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": "bytes", "bytes": nbytes,
            "ms_over_bound": ms / bound_ms}


def receive_phase(torch, E, RK, AGG, sess, dev) -> list:
    """The receive kernel at the main path's own receive (one tick of the
    ``asymp_cc_large`` session ``sess``: its pre-receive planes and the
    exchange's views, as the engine passed them) and at the benchmark's
    shape for every idempotent form; the main path's form first."""
    seen = []
    receive = E._phase2_receive

    def capture(prog, *args):
        seen.append((prog.aggregator, *args))
        return receive(prog, *args)

    E._phase2_receive = capture
    try:
        sess.step()
    finally:
        E._phase2_receive = receive
    check(len(seen) == 1, f"one tick delivered {len(seen)} times")
    tick = sess.totals["ticks"] - 1
    forms = [receive_form(torch, RK, seen[0][0], seen[0][1:],
                          f"{sess.cfg.name} tick {tick}")]
    del seen
    for i, form in enumerate((("min", "int32"), ("min", "float32"),
                              ("max", "int32"), ("max", "float32"),
                              ("or", "int32"))):
        forms.append(receive_form(
            torch, RK, AGG[form[0]], receive_views(torch, form, dev, 28 + i),
            f"the benchmark's shape, {form[0]}/{form[1]}"))
    return forms


def pagerank_verdict(torch, np, M, state, totals, g, oracle, where):
    """``tests/test_pagerank.py::_verdict``: L1 of ranks/n to the oracle
    below 1e-3, mass balance within 1e-5, no latched push, residuals at or
    below push_eps.  Returns (l1, mass)."""
    n = g.num_real_vertices
    check(totals["converged"], f"{where}: pagerank did not converge")
    ranks = state.values.reshape(-1)[:n].double()
    l1 = float((ranks / n - oracle.double()).abs().sum())
    mass = M.mass_balance(state, g)
    check(bool(torch.isfinite(ranks).all()) and l1 < 1e-3,
          f"{where}: L1 to the oracle {l1}")
    check(abs(mass - 1.0) < 1e-5, f"{where}: mass balance {mass}")
    check(bool((state.aux[:, 1] == 0).all()), f"{where}: a push is latched")
    check(bool((state.aux[:, 0].reshape(-1)[:n] <= PUSH_EPS).all()),
          f"{where}: a residual is above push_eps")
    return l1, mass


def window_profile(torch, sess, warm: int) -> dict:
    """``warm`` ticks of a session, then a profiled window of
    ``PROFILE_TICKS`` more: ms a tick and device time by op."""
    for _ in range(warm):
        sess.step()
    torch.cuda.synchronize()

    def ticks():
        for _ in range(PROFILE_TICKS):
            sess.step()

    prof = device_profile(torch, ticks)
    return dict(ticks=f"{warm}..{warm + PROFILE_TICKS}",
                ms_per_tick=prof["window_s"] / PROFILE_TICKS * 1e3,
                pending=sess._pending, **prof)


def wire_phase(np, torch, E, G, X, get_graph_config, dev) -> None:
    """``asymp_cc_wire`` against ``asymp_cc_small`` (one graph, int16 and
    raw wire) and the codec on the card against the CPU."""
    cfg_w = get_graph_config("asymp_cc_wire")
    cfg_raw = get_graph_config("asymp_cc_small")
    g = G.build_sharded_graph(cfg_w)
    n = g.num_real_vertices
    runs = []
    for cfg in (cfg_raw, cfg_w):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sess = E.EngineSession(cfg, graph=g, device=dev)
        tot = sess.tick_until_quiescent()
        torch.cuda.synchronize()
        runs.append((sess.state.values.reshape(-1)[:n], tot,
                     time.perf_counter() - t0,
                     E.wire_codec(sess.prog, sess.ep)))
    (raw_l, raw_t, raw_s, raw_c), (w_l, w_t, w_s, w_c) = runs
    # the codec on the card against the same calls on the CPU
    rng = np.random.default_rng(5)
    ints = rng.integers(-1, 40_000, (8, 8, 512)).astype(np.int32)
    ints[0, 0, :8] = 2 ** 31 - 1
    flt = rng.uniform(-100, 100, (8, 8, 512)).astype(np.float32)
    flt[0, 0, ::5], flt[1, 1] = np.inf, np.inf
    flt[2, 2] = 0.0
    cases = 0
    for mode in ("int16", "int8"):
        for kind, data, ident, direction in (
                ("int32", ints, 2 ** 31 - 1, "up"),
                ("float32", flt, float("inf"), "up"),
                ("float32", flt, 0.0, "down")):
            codec = X.make_wire_codec(
                num_shards=8, capacity=512, vs=20_000, requested=mode,
                value_kind=kind, identity=ident, max_int_value=50_000,
                quantize_direction=direction, idempotent=True)
            host = torch.from_numpy(data)
            outs = []
            for x in (host, host.to(dev)):
                payload, scales = codec.encode(x)
                outs.append([payload, scales, codec.decode(payload, scales)])
            for a, b in zip(*outs):
                check(a is None and b is None or torch.equal(a, b.cpu()),
                      f"wire codec {mode}/{kind}/{direction}: the card "
                      f"differs from the CPU")
            cases += 1
    say("wire", config="asymp_cc_wire", compression=w_c.compression,
        compress_ids=w_c.compress_ids, ticks=w_t["ticks"],
        messages=w_t["sent"], raw_ticks=raw_t["ticks"],
        raw_messages=raw_t["sent"], propagation_s=w_s, raw_propagation_s=raw_s,
        wire_bytes_per_tick=w_c.wire_bytes_per_tick(),
        raw_wire_bytes_per_tick=raw_c.wire_bytes_per_tick(),
        labels_equal_raw=torch.equal(w_l, raw_l), codec_cases_bitwise=cases)
    check(w_c.compression == "int16" and w_c.compress_ids,
          f"asymp_cc_wire gated to {w_c.compression}")
    check(w_t["converged"] and torch.equal(w_l, raw_l),
          "asymp_cc_wire: labels differ from asymp_cc_small's")


def crowd_sssp_config(GraphConfig):
    """``bench_crowded``'s ``_scenario_cfg``: RMAT 2^12 SSSP on 8 shards."""
    return GraphConfig(name="crowd-sssp", algorithm="sssp",
                       num_vertices=1 << 12, avg_degree=16, generator="rmat",
                       num_shards=8, enforce_fraction=1.0, edge_budget=512,
                       weighted=True, **PRIORITY)


def crowded_smoke_phase(np, torch, E, K, L, R, RK, ops, cfg, g, pg,
                        get_program, dev) -> tuple:
    """``bench_crowded --smoke``'s scenario (``cfg``, its graph ``g`` and
    pulled stream ``pg``), counts and gates; the SSSP fixpoint against the
    kernel-backed ``min_plus`` pull, each round's kernel partials held
    bitwise against the plain version on that round's inputs.  Returns the
    pull's launches and the receive kernel's (one a tick of the six
    runs)."""
    n = g.num_real_vertices
    res, healthy = {}, None
    rx0 = RK.deliver.launches
    for name, c in (("priority", cfg),
                    ("fifo", dataclasses.replace(cfg, **FIFO)),
                    ("async", dataclasses.replace(cfg, schedule="async"))):
        for cond, lat_kw in (("healthy", HEALTHY), ("crowded", CROWDED)):
            lat = L.make_latency_model(num_shards=c.num_shards,
                                       seed=c.latency_seed, **lat_kw)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st, tot = E.run_to_convergence(c, graph=g, latency=lat,
                                           device=dev)
            torch.cuda.synchronize()
            dist = st.values.reshape(-1)[:n]
            healthy = dist if healthy is None else healthy
            check(tot["converged"] and tot["pending"] == 0,
                  f"crowded smoke {name}/{cond} did not converge")
            check(torch.equal(dist, healthy),
                  f"crowded smoke {name}/{cond}: fixpoint differs")
            res[name, cond] = (tot["ticks"], tot["sent"],
                               time.perf_counter() - t0)
    receives = RK.deliver.launches - rx0
    ratio = {k: res[k, "crowded"][0] / res[k, "healthy"][0]
             for k in CROWDED_BASELINE}
    # the healthy distances against the min_plus pull to its fixpoint
    pg = pg.to(dev)
    K.reset_launch_counts()
    v, inputs = min_plus_fixpoint(torch, ops, get_program(cfg), pg, n, dev)
    torch.cuda.synchronize()
    pull_launches = dict(K.spmv_partials.launches_by_form)
    rounds = len(inputs)
    # the pull's own kernel inputs, round by round (these launches are not
    # the path's: the counts were read above)
    pull_err = max(hold_against_plain(torch, K, R, pg, vin, "min_plus",
                                      "a pull round of the crowded smoke")
                   for vin in inputs)
    say("crowded_smoke", config=cfg.name,
        ticks={f"{k}/{c}": res[k, c][0] for k, c in res},
        messages={f"{k}/{c}": res[k, c][1] for k, c in res},
        seconds={f"{k}/{c}": res[k, c][2] for k, c in res},
        baseline_ticks=CROWDED_BASELINE, degradation=ratio,
        min_plus_pull_rounds=rounds, min_plus_pull_max_abs_err=pull_err,
        pull_equals_engine=torch.equal(v, healthy),
        kernel_launches=pull_launches, receive_launches=receives)
    for k, want in CROWDED_BASELINE.items():
        check((res[k, "healthy"][0], res[k, "crowded"][0]) == want,
              f"crowded smoke {k}: ticks {res[k, 'healthy'][0]}/"
              f"{res[k, 'crowded'][0]} != the baseline's {want}")
    check(ratio["priority"] < 2.0
          and res["priority", "crowded"][0] < res["fifo", "crowded"][0]
          and res["priority", "crowded"][1] < res["fifo", "crowded"][1]
          and ratio["async"] <= ratio["priority"],
          f"crowded smoke gates fail: {ratio}")
    check(torch.equal(v, healthy),
          "the SSSP fixpoint differs from the kernel-backed min_plus pull")
    check(pull_launches.get("min_plus/float32", 0) == rounds,
          f"min_plus launches {pull_launches} != {rounds} pull rounds")
    ticks = sum(t for t, _, _ in res.values())
    check(receives == ticks,
          f"crowded smoke: receive launches {receives} != ticks {ticks}")
    return pull_launches, receives


def crowded_faults_phase(torch, E, F, G, get_graph_config, dev):
    """``asymp_cc_crowded`` under kills plus slowdowns, sync and async.
    Returns the graph and each schedule's fault-free labels (numpy)."""
    plan = dict(fail_fraction=0.5, start_tick=4, every=6, slow_fraction=0.5,
                slow_delay=3, slow_intensity=4)
    cfg = get_graph_config("asymp_cc_crowded")
    g = G.build_sharded_graph(cfg)
    n = g.num_real_vertices
    fault_free = {}
    for schedule in ("sync", "async"):
        c = dataclasses.replace(cfg, schedule=schedule)
        base, bt = E.run_to_convergence(c, graph=g, device=dev)
        fault_free[schedule] = base.values.reshape(-1)[:n].cpu().numpy()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, tot = E.run_to_convergence(c, graph=g, device=dev,
                                       fault_plan=F.FaultPlan(**plan))
        torch.cuda.synchronize()
        same = torch.equal(st.values.reshape(-1)[:n],
                           base.values.reshape(-1)[:n])
        say("crowded_faults", config="asymp_cc_crowded", schedule=schedule,
            plan=plan,
            ticks=tot["ticks"], fault_free_ticks=bt["ticks"],
            failures=tot["failures"], replayed_messages=tot["replayed"],
            messages=tot["sent"], propagation_s=time.perf_counter() - t0,
            labels_equal_fault_free=same)
        check(tot["converged"] and bt["converged"] and same,
              f"crowded faults ({schedule}): labels differ from the "
              f"fault-free labels")
        check(tot["failures"] == 4 and tot["replayed"] > 0,
              f"crowded faults ({schedule}): {tot['failures']} failures, "
              f"{tot['replayed']} replayed")
    return g, fault_free


def hold_against_plain(torch, K, R, pg, vin, semiring, where) -> float:
    """One pull round's kernel inputs (``vin`` gathered along ``pg``'s
    stream) through the kernel and its plain version: bitwise equal, as
    idempotent reduces are exact.  Returns the max abs error (0)."""
    ident = K._identity(semiring, vin.dtype)
    n = vin.shape[0]
    vpad = torch.cat([vin, vin.new_full((pg.num_vertices - n,), ident)])
    src = pg.edge_src.long()
    vals = torch.where(src >= 0, vpad[src.clamp(min=0)],
                       vin.new_full((), ident))
    w = pg.weights if semiring == "min_plus" else None
    kp = K.spmv_partials(vals, pg.edge_dst_local, w, semiring=semiring)
    rp = R.spmv_partials_ref(vals, pg.edge_dst_local, w, semiring=semiring)
    err = max_abs_err(torch, kp, rp)
    check(torch.equal(kp, rp), f"{semiring} differs from its plain version "
                               f"({where}): max abs err {err}")
    return err


def min_plus_fixpoint(torch, ops, prog, pg, n, dev):
    """The ``min_plus`` pull iterated from the program's initial values to
    its fixpoint: (distances, each round's input values)."""
    gids = torch.arange(n, dtype=torch.int32, device=dev)
    v, _ = prog.init(gids, torch.ones(n, dtype=torch.bool, device=dev))
    inputs = []
    while True:
        inputs.append(v)
        nxt = ops.frontier_pull_step(v, pg, semiring="min_plus")
        if torch.equal(nxt, v):
            return v, inputs
        v = nxt


def pct(xs, q):
    """The q-th percentile of a list (nearest rank)."""
    xs = sorted(xs)
    return xs[min(len(xs) - 1, max(0, -(-len(xs) * q // 100) - 1))] \
        if xs else None


class Loop:
    """What one closed serving loop measured."""

    def __init__(self):
        self.batch_s, self.batch_sizes, self.deltas = [], [], []
        self.torn = self.rejected = self.committed = 0

    @property
    def served(self) -> int:
        return sum(self.batch_sizes)


def closed_loop(np, SG, srv, qs, rng, iters, per_batch, deltas, *,
                kinds=("component_of",), until_done=False):
    """``benchmarks/bench_load.py::_closed_loop`` on the port: each
    iteration submits a batch of seeded queries, answers it through one
    pinned reader, probes every served program over the whole graph for
    a torn read (the probe must equal SOME committed epoch bitwise), then
    begins a 1-edge delta or advances the one in flight by 2 shadow ticks
    and commits it when done.  ``kinds`` cycle through the batch (one kind
    draws the JAX bench's numbers exactly); ``until_done`` stops after the
    last commit and one more batch instead of running ``iters``."""
    from repro_torch.serve.engine import QueueFullError
    n = srv.graph.num_real_vertices
    ids = np.arange(n)
    names = sorted({SG.KIND_PROGRAM[k] for k in kinds})

    def snapshot():
        with srv.reader() as view:
            return [srv.lookup(name, ids, view=view).copy()
                    for name in names]

    committed = [snapshot()]
    out, txn, rid, rec = Loop(), None, 0, None

    def commit():
        t0 = time.perf_counter()
        stats = txn.commit()
        rec.update(commit_and_publish_s=time.perf_counter() - t0,
                   **{f"{k}_{field}": getattr(v, field)
                      for k, v in stats.items()
                      for field in ("reactivated", "ticks")})
        out.deltas.append(rec)
        committed.append(snapshot())
        out.committed += 1

    def batch():
        nonlocal rid
        served_before = qs.served
        for _ in range(per_batch):
            try:
                qs.submit(SG.GraphQuery(rid, kinds[rid % len(kinds)],
                                        int(rng.integers(n))))
            except QueueFullError:
                out.rejected += 1
            rid += 1
        t0 = time.perf_counter()
        qs.step()
        out.batch_s.append(time.perf_counter() - t0)
        out.batch_sizes.append(qs.served - served_before)
        probe = snapshot()
        if not any(all(np.array_equal(a, b) for a, b in zip(probe, snap))
                   for snap in committed):
            out.torn += 1

    it = 0
    while (it < iters if not until_done
           else out.committed < deltas or txn is not None):
        batch()
        if txn is None and out.committed < deltas:
            u, v = int(rng.integers(n)), int(rng.integers(n))
            t0 = time.perf_counter()
            txn = srv.begin_delta(insertions=[(u, v)])
            rec = {"edge": [u, v], "apply_edge_delta_s": txn.patch_s,
                   "begin_s": time.perf_counter() - t0}
        elif txn is not None:
            txn.step(2)
            if txn.done:
                commit()
                txn = None
        it += 1
    if txn is not None:  # drain: finish the transaction and the queue
        txn.run()
        commit()
    if until_done:  # one batch on the last epoch: the lag falls to 0
        batch()
    while len(qs.queue):
        served_before = qs.served
        t0 = time.perf_counter()
        qs.step()
        out.batch_s.append(time.perf_counter() - t0)
        out.batch_sizes.append(qs.served - served_before)
    return out


def elastic_phase(np, torch, E, G, CK, EL, K, cfg, graph, labels, dev):
    """``asymp_cc_large`` ticked on 8 shards, checkpointed to disk and
    restored, re-split onto 4 shards (a graph assembled from the 8-shard
    edge list) and converged there: the labels of phase 4."""
    n = graph.num_real_vertices
    K.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sess = E.EngineSession(cfg, graph=graph, device=dev)
    for _ in range(ELASTIC_TICKS):
        sess.step()
    active_before = int(sess.state.active.sum())
    torch.cuda.synchronize()
    before_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        mgr = CK.CheckpointManager(d, keep=1)
        mgr.save(ELASTIC_TICKS, sess.state, metadata={"shards": 8})
        tree, meta = mgr.restore(device=dev)
    state = E.EngineState(**tree)
    ckpt_s = time.perf_counter() - t0
    check(meta["shards"] == 8 and all(
        torch.equal(getattr(state, f), getattr(sess.state, f))
        for f in ("values", "active", "cursor", "tick")),
        "elastic: the restored checkpoint differs from the saved state")
    del sess
    t0 = time.perf_counter()
    edges = G.edge_list(graph)
    g4 = G._assemble_csr(n, ELASTIC_SHARDS, edges[:, 0], edges[:, 1], None)
    del edges
    assemble_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    s4 = EL.repartition_state(state, graph, g4)
    torch.cuda.synchronize()
    repartition_s = time.perf_counter() - t0
    reactivated = int(s4.active.sum())
    cut = graph.boundary.copy()
    cut[np.arange(graph.num_shards), np.arange(graph.num_shards)] = False
    n_cut = int(cut.any(axis=1).sum())
    del cut
    t0 = time.perf_counter()
    sess4 = E.EngineSession(dataclasses.replace(cfg, num_shards=ELASTIC_SHARDS),
                            graph=g4, device=dev)
    sess4.replace_state(s4)
    tot = sess4.tick_until_quiescent()
    torch.cuda.synchronize()
    after_s = time.perf_counter() - t0
    same = torch.equal(sess4.state.values.reshape(-1)[:n], labels)
    launches = dict(K.spmv_partials.launches_by_form)
    say("elastic", config=cfg.name, shards=f"8 -> {ELASTIC_SHARDS}",
        ticks_before=ELASTIC_TICKS, active_before=active_before,
        cut_vertices=n_cut, reactivated_after_resize=reactivated,
        ticks_after_resize=tot["ticks"], converged=tot["converged"],
        labels_equal_main_path=same, seconds_before=before_s,
        checkpoint_save_restore_s=ckpt_s, assemble_csr_s=assemble_s,
        repartition_s=repartition_s, seconds_after=after_s,
        es_4_shards=g4.es, max_memory_allocated=(
            torch.cuda.max_memory_allocated()), kernel_launches=launches)
    check(tot["converged"] and same,
          "elastic: labels after the 8 -> 4 resize differ from phase 4's")
    check(reactivated <= n_cut + active_before,
          f"elastic: {reactivated} active after the resize > {n_cut} cut "
          f"+ {active_before} active before")
    return launches


def serve_main_phase(np, torch, E, G, K, R, SG, ops, cfg_large, graph, dev):
    """What ``graph_serve --config asymp_cc_large --programs cc,sssp
    --store <tmp> --queries 256 --deltas 4`` runs, through the classes,
    with the deltas streamed as ``bench_load``'s closed loop does; then
    the served fixpoints against the kernel-backed BSP labels and
    ``min_plus`` pull on the patched graph."""
    cfg = dataclasses.replace(cfg_large, weighted=True)  # SSSP's weights
    n = graph.num_real_vertices
    t0 = time.perf_counter()
    edges = G.edge_list(graph)  # the builder's draw, edge by edge
    w = np.random.default_rng(cfg.seed + 7).uniform(
        0.1, 1.0, size=len(edges)).astype(np.float32)
    gw = G._assemble_csr(n, graph.num_shards, edges[:, 0], edges[:, 1], w)
    del edges, w
    weighted_graph_s = time.perf_counter() - t0
    K.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as store:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        srv = SG.GraphServer(cfg, programs=("cc", "sssp"), store_dir=store,
                             graph=gw, device=dev)
        totals = srv.converge()
        torch.cuda.synchronize()
        converge_s = time.perf_counter() - t0
        check(all(t["converged"] for t in totals.values()),
              f"serve_main: not converged {totals.keys()}")
        t_serve = time.perf_counter()
        rng = np.random.default_rng(0)
        qs = SG.QueryServer(srv, num_slots=SERVE_SLOTS)
        kinds = ("component_of", "distance")
        asked = []
        for rid in range(SERVE_QUERIES):
            asked.append(int(rng.integers(n)))
            qs.submit(SG.GraphQuery(rid, kinds[rid % 2], asked[-1]))
        first = []
        while len(qs.queue):
            t0 = time.perf_counter()
            qs.step()
            first.append(time.perf_counter() - t0)
        want = {k: srv.sessions[p].state.values.reshape(-1)[:n].cpu().numpy()
                for k, p in (("component_of", "cc"), ("distance", "sssp"))}
        check(all(qs.done[rid] == want[kinds[rid % 2]][v]
                  for rid, v in enumerate(asked)),
              "serve_main: an answer differs from the converged fixpoint")
        loop = closed_loop(np, SG, srv, qs, rng, 0, SERVE_SLOTS,
                           SERVE_DELTAS, kinds=kinds, until_done=True)
        stats = qs.stats()
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t_serve
        peak = torch.cuda.max_memory_allocated()
        # the served fixpoints against the kernels on the patched graph
        t0 = time.perf_counter()
        pg = ops.build_pulled_graph(srv.graph).to(dev)
        pulled_s = time.perf_counter() - t0
        bsp_labels, bsp = ops.bsp_connected_components(srv.graph, device=dev,
                                                       pulled=pg)
        sssp = srv.sessions["sssp"]
        dist, inputs = min_plus_fixpoint(torch, ops, sssp.prog, pg, n, dev)
        rounds = len(inputs)
        torch.cuda.synchronize()
        launches = dict(K.spmv_partials.launches_by_form)
        cc_ok = torch.equal(srv.sessions["cc"].state.values.reshape(-1)[:n],
                            bsp_labels)
        sssp_ok = torch.equal(sssp.state.values.reshape(-1)[:n], dist)
        # each kernel at this path's shapes against its plain version: the
        # BSP round at the fixpoint labels, every round of the pull
        errs = [hold_against_plain(torch, K, R, pg, bsp_labels, "min",
                                   "serve_main BSP")] + [
            hold_against_plain(torch, K, R, pg, vin, "min_plus",
                               "a serve_main pull round") for vin in inputs]
        epoch = srv.epoch
        del srv, gw, pg
    first_ms = [s * 1e3 for s in first]
    loop_ms = [s * 1e3 for s in loop.batch_s]
    say("serve_main", config=cfg.name, programs=["cc", "sssp"],
        weighted_graph_s=weighted_graph_s, converge_s=converge_s,
        converge_ticks={k: t["ticks"] for k, t in totals.items()},
        queries=SERVE_QUERIES, slots=SERVE_SLOTS, query_batches=len(first),
        batch_ms_p50=pct(first_ms, 50), batch_ms_p99=pct(first_ms, 99),
        queries_per_s=SERVE_QUERIES / sum(first),
        deltas=loop.deltas, loop_batches=len(loop.batch_s),
        loop_served=loop.served, loop_batch_ms_p50=pct(loop_ms, 50),
        loop_batch_ms_p99=pct(loop_ms, 99),
        loop_queries_per_s=loop.served / sum(loop.batch_s),
        torn=loop.torn, rejected=stats["rejected"],
        freshness_lag_max=stats["freshness_lag_max"],
        freshness_lag_last=stats["freshness_lag_last"], epoch=epoch,
        serve_s=serve_s, build_pulled_graph_s=pulled_s,
        bsp_rounds=bsp["rounds"], min_plus_rounds=rounds,
        cc_equals_bsp=cc_ok, sssp_equals_min_plus=sssp_ok,
        kernel_max_abs_err=max(errs), max_memory_allocated=peak,
        kernel_launches=launches)
    check(loop.torn == 0 and stats["rejected"] == 0
          and stats["freshness_lag_max"] <= 1
          and loop.committed == SERVE_DELTAS,
          f"serve_main: torn {loop.torn}, rejected {stats['rejected']}, "
          f"lag {stats['freshness_lag_max']}, {loop.committed} deltas")
    check(cc_ok, "serve_main: CC labels differ from BSP on the patched graph")
    check(sssp_ok, "serve_main: SSSP distances differ from the min_plus "
                   "fixpoint on the patched graph")
    check(launches.get("min/int32", 0) == bsp["rounds"]
          and launches.get("min_plus/float32", 0) == rounds,
          f"serve_main launches {launches} != rounds {bsp['rounds']}, "
          f"{rounds}")
    return launches


def serve_cfg(GraphConfig, log2n, **kw):
    """``bench_serve``/``bench_load``'s ``_serve_cfg`` / ``_load_cfg``."""
    base = dict(name=f"rmat{log2n}", algorithm="cc",
                num_vertices=1 << log2n, avg_degree=16, generator="rmat",
                num_shards=8, priority="log", enforce_fraction=0.1)
    base.update(kw)
    return GraphConfig(**base)


def serve_smoke_phase(np, torch, E, SG, GraphConfig, dev) -> None:
    """``bench_serve --smoke`` and ``bench_load --smoke`` on the card, held
    to the counts of ``benchmarks/baselines/BENCH_{serve,load}.json``."""
    out = {}
    # bench_serve: a 1-edge delta on RMAT 2^13 CC against a scratch run
    rng = np.random.default_rng(11)
    srv = SG.GraphServer(serve_cfg(GraphConfig, 13), programs=("cc",),
                         device=dev)
    srv.converge()
    n = srv.graph.num_real_vertices
    t0 = time.perf_counter()
    st = srv.apply_delta(insertions=[(int(rng.integers(n)),
                                      int(rng.integers(n)))])["cc"]
    delta_s = time.perf_counter() - t0
    sess = srv.sessions["cc"]
    scratch = E.EngineSession(sess.cfg, graph=srv.graph, prog=sess.prog,
                              device=dev)
    scratch.tick_until_quiescent()
    out["delta1_cc"] = dict(
        reactivated=st.reactivated,
        reactivated_pct=round(100 * st.reactivated / n, 3),
        lag_ticks=st.ticks, scratch_ticks=scratch.totals["ticks"],
        exact=int(torch.equal(sess.state.values, scratch.state.values)),
        delta_s=delta_s)
    # bench_serve: pagerank on RMAT 2^11, held to the push_eps ball
    cfg_pr = serve_cfg(GraphConfig, 11, algorithm="pagerank",
                       enforce_fraction=1.0, max_ticks=60000)
    srv_pr = SG.GraphServer(cfg_pr, programs=("pagerank",), device=dev)
    srv_pr.converge()
    n = srv_pr.graph.num_real_vertices
    t0 = time.perf_counter()
    st = srv_pr.apply_delta(insertions=[(int(rng.integers(n)),
                                         int(rng.integers(n)))])["pagerank"]
    delta_s = time.perf_counter() - t0
    sess = srv_pr.sessions["pagerank"]
    scratch = E.EngineSession(sess.cfg, graph=srv_pr.graph, prog=sess.prog,
                              device=dev)
    scratch.tick_until_quiescent()
    tol = n * sess.prog.push_eps / (1.0 - 0.85)
    gap = float((sess.state.values - scratch.state.values).abs().max())
    out["delta1_pagerank"] = dict(
        reactivated=st.reactivated, lag_ticks=st.ticks, gap=gap, tol=tol,
        baseline=SERVE_PR_BASELINE, delta_s=delta_s)
    # bench_load: the closed loop with 3 deltas, then the PPR cache
    rng = np.random.default_rng(17)
    with tempfile.TemporaryDirectory() as d:
        srv = SG.GraphServer(serve_cfg(GraphConfig, 13), programs=("cc",),
                             store_dir=d, device=dev)
        srv.converge()
        qs = SG.QueryServer(srv, num_slots=32, max_queue=256)
        t0 = time.perf_counter()
        loop = closed_loop(np, SG, srv, qs, rng, 24, 16, LOAD_BASELINE[
            "deltas"])
        wall = time.perf_counter() - t0
        out["load"] = dict(torn=loop.torn, rejected=loop.rejected,
                           lag_max=qs.lag_max, lag_final=qs.lag_last,
                           deltas=loop.committed, served=loop.served,
                           wall_s=wall, queries_per_s=loop.served / wall)
        del srv, qs
    cfg_ppr = serve_cfg(GraphConfig, 10, enforce_fraction=1.0,
                        max_ticks=60000)
    srv = SG.GraphServer(cfg_ppr, programs=("cc",), ppr_cache=8, device=dev)
    srv.converge()
    n = srv.graph.num_real_vertices
    hot = [int(rng.integers(n)) for _ in range(2)]
    t0 = time.perf_counter()
    for v in hot:
        srv.top_k_near(v, k=8)
    build_s = time.perf_counter() - t0
    srv.apply_delta(insertions=[(hot[0], int(rng.integers(n)))])
    t0 = time.perf_counter()
    for v in hot:
        srv.top_k_near(v, k=8)
    repair_s = time.perf_counter() - t0
    cs = srv.ppr_cache.stats()
    out["ppr_cache"] = dict(hits=cs["hits"], misses=cs["misses"],
                            invalidations=cs["invalidations"],
                            build_s=build_s, repair_s=repair_s)
    say("serve_smoke", baselines={"delta1_cc": SERVE_CC_BASELINE,
                                  "load": LOAD_BASELINE,
                                  "ppr_cache": PPR_BASELINE}, **out)
    cc = out["delta1_cc"]
    check((cc["reactivated_pct"], cc["lag_ticks"], cc["scratch_ticks"],
           cc["exact"]) == SERVE_CC_BASELINE,
          f"serve smoke delta1_cc {cc} != the baseline {SERVE_CC_BASELINE}")
    check(gap <= tol, f"serve smoke pagerank: gap {gap} > tol {tol}")
    got = {k: out["load"][k] for k in LOAD_BASELINE}
    check(got == LOAD_BASELINE,
          f"load smoke {got} != the baseline {LOAD_BASELINE}")
    got = {k: out["ppr_cache"][k] for k in PPR_BASELINE}
    check(got == PPR_BASELINE,
          f"PPR cache {got} != the baseline {PPR_BASELINE}")


def serve_rank_phase(np, torch, K, M, SG, ops, cfg_pr, g_pr, dev):
    """``asymp_pagerank`` served with ``programs=("cc", "pagerank")``, 2
    one-edge deltas; after each commit the served ranks pass the pagerank
    verdict against the kernel-backed dense oracle on the patched
    graph."""
    K.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    srv = SG.GraphServer(cfg_pr, programs=("cc", "pagerank"), graph=g_pr,
                         device=dev)
    totals = srv.converge()
    torch.cuda.synchronize()
    converge_s = time.perf_counter() - t0
    rng = np.random.default_rng(3)
    n = g_pr.num_real_vertices
    rows = []
    for _ in range(2):
        ins = [(int(rng.integers(n)), int(rng.integers(n)))]
        t0 = time.perf_counter()
        stats = srv.apply_delta(insertions=ins)
        torch.cuda.synchronize()
        delta_s = time.perf_counter() - t0
        oracle = ops.pagerank(srv.graph, damping=cfg_pr.damping,
                              iters=ORACLE_ITERS, dangling="absorb",
                              device=dev)
        sess = srv.sessions["pagerank"]
        l1, mass = pagerank_verdict(torch, np, M, sess.state,
                                    sess.totals_snapshot(), srv.graph,
                                    oracle, "serve_rank after a delta")
        rows.append({"edge": ins[0], "delta_s": delta_s, "l1_to_oracle": l1,
                     "mass_balance": mass,
                     **{f"{k}_{f}": getattr(v, f) for k, v in stats.items()
                        for f in ("reactivated", "ticks")}})
    launches = dict(K.spmv_partials.launches_by_form)
    say("serve_rank", config=cfg_pr.name, programs=["cc", "pagerank"],
        converge_ticks={k: t["ticks"] for k, t in totals.items()},
        converge_s=converge_s, deltas=rows,
        max_memory_allocated=torch.cuda.max_memory_allocated(),
        kernel_launches=launches)
    check(launches.get("plus_times/float32", 0) == 2 * ORACLE_ITERS,
          f"serve_rank launches {launches} != {2 * ORACLE_ITERS}")
    return launches


# ---------------------------------------------------------------------
# Multi-rank phases.  The jobs run on the ranks of one RankPool of spawned
# processes (module-level functions: a spawned rank finds them by name);
# the phases run in the parent and hold the ranks' results to the local
# tick's.
# ---------------------------------------------------------------------
def save_graph(np, graph, d: str) -> str:
    """The graph's device arrays (int32 ``row_ptr``, ``col_idx`` with -1
    padding) as ``.npy`` files in ``d``, for the ranks to memory-map their
    own rows of: the graph is built once, in the parent, and never
    pickled."""
    os.makedirs(d, exist_ok=True)
    np.save(os.path.join(d, "row_ptr.npy"), graph.row_ptr.astype(np.int32))
    np.save(os.path.join(d, "col_idx.npy"),
            np.where(graph.col_idx < 0, -1, graph.col_idx).astype(np.int32))
    return d


def load_graph(np, E, MS, d: str, rank, dev):
    """A rank's rows of a saved graph on ``dev`` (``rank=None``: every
    row)."""
    g = E.ShardGraph(*(np.load(os.path.join(d, f), mmap_mode="r")
                       for f in ("row_ptr.npy", "col_idx.npy")), None)
    return MS.to_device(g if rank is None else MS.rank_rows(g, rank), dev)


def host_state(state) -> dict:
    """An engine state's fields as numpy arrays (the start state the
    ranks are handed)."""
    return {k: None if v is None else v.cpu().numpy()
            for k, v in state._asdict().items()}


def _sync(torch, dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _peak(torch, dev):
    return (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else "not measured")


def rank_plain_job(ctx, cfg, ep, gdir, start, max_ticks, every, reps):
    """``make_dist_tick`` from ``start`` until the global frontier is empty
    or ``max_ticks``: every tick's global counters; every ``every`` ticks
    (0: only at the end) the state gathered to every rank; the wall time
    a tick; the collective alone (one ``exchange_dist`` of this tick's
    send buffers, ``reps`` times) and the rank's peak device memory."""
    import numpy as np
    import torch

    from repro_torch.core import engine as E
    from repro_torch.core.programs import get_program
    from repro_torch.dist import exchange as X
    from repro_torch.launch import mesh as MS
    dev, rank = ctx.device, ctx.rank
    prog = get_program(cfg)
    g = load_graph(np, E, MS, gdir, rank, dev)
    state = MS.to_device(MS.rank_rows(E.EngineState(**start), rank), dev)
    tick = E.make_dist_tick(prog, ep, ctx.group, prog.weighted)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    log, snaps = [], []

    def snapshot():
        whole = MS.gather_rows(state, ctx.group)
        if rank == 0:
            snaps.append(host_state(whole))

    _sync(torch, dev)
    t0 = time.perf_counter()
    for t in range(max_ticks):
        state, st = tick(state, g)
        log.append(torch.stack(list(st)).tolist())  # one host read a tick
        if every and (t + 1) % every == 0:
            snapshot()
        if log[-1][0] == 0:
            break
    _sync(torch, dev)
    run_s = time.perf_counter() - t0
    snapshot()
    # the collective alone, at this tick's shapes and wire format
    codec = E.wire_codec(prog, ep)
    sv = torch.full((ep.num_shards, ep.route_capacity), prog.identity,
                    dtype=prog.tdtype, device=dev)
    si = torch.full(sv.shape, -1, dtype=torch.int32, device=dev)
    X.exchange_dist(codec, sv, si, ctx.group)
    _sync(torch, dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        X.exchange_dist(codec, sv, si, ctx.group)
    _sync(torch, dev)
    a2a_ms = (time.perf_counter() - t0) / reps * 1e3
    return {"rank": rank, "ticks": len(log), "run_s": run_s,
            "ms_per_tick": run_s / len(log) * 1e3, "collective_ms": a2a_ms,
            "max_memory_allocated": _peak(torch, dev),
            "log": log if rank == 0 else None,
            "snapshots": snaps if rank == 0 else None}


def rank_lockstep_job(ctx, cfg, ep, gdir, start, schedule, max_ticks):
    """The crowded (``schedule="sync"``) or async dist tick under
    ``cfg``'s latency model, what ``EngineSession`` would feed it, with
    rank 0 stepping the local tick on the whole graph beside it: every
    tick the state is gathered to every rank and rank 0 holds it bitwise
    to the local state (the ring in the dist layout), the counters too.
    Returns rank 0's ticks, pending at the end and final labels."""
    import dataclasses as dc

    import numpy as np
    import torch

    from repro_torch.core import engine as E
    from repro_torch.core.programs import get_program
    from repro_torch.dist import exchange as X
    from repro_torch.dist import latency as L
    from repro_torch.launch import mesh as MS
    dev, rank, P = ctx.device, ctx.rank, ep.num_shards
    prog = get_program(cfg)
    lat = L.from_config(cfg)
    def put(a):
        return torch.as_tensor(np.asarray(a, np.int32), device=dev)

    delays = put(np.minimum(lat.delays, lat.max_delay))
    throttle = put(lat.throttle)
    is_async = schedule == "async"
    if is_async:
        inter = L.make_interleaving(P, rates=lat.throttle,
                                    seed=cfg.async_seed,
                                    jitter=cfg.async_jitter)
        ring_delay = E.async_ring_delay(lat.max_delay, inter.stall_bound(1))
        r_all = max(int(np.asarray(lat.throttle).max(initial=1)), 1)
        window = put(np.minimum(lat.throttle, r_all) * ep.degree_window)
        if r_all > 1:
            ep = dc.replace(ep, degree_window=ep.degree_window * r_all,
                            route_capacity=ep.route_capacity * r_all)
        dtick = E.make_async_dist_tick(prog, ep, ctx.group, prog.weighted)
        ltick = E.make_async_tick(prog, ep, prog.weighted)
    else:
        ring_delay = int(lat.max_delay)
        dtick = E.make_crowded_dist_tick(prog, ep, ctx.group, prog.weighted)
        ltick = E.make_crowded_tick(prog, ep, prog.weighted)

    def fresh(core, senders):
        """``core`` with an empty ring (``senders``: 0 = a rank's dist
        layout, P = local), demotion plane and clock."""
        ring = X.init_delay_ring(ring_delay, senders, P, ep.route_capacity,
                                 prog.identity, prog.tdtype, dev)
        demote = torch.zeros(core.values.shape, dtype=torch.bool,
                             device=dev)
        clock = torch.zeros(core.values.shape[0], dtype=torch.int32,
                            device=dev)
        return (E.AsyncState(core, ring, demote, clock) if is_async
                else E.CrowdedState(core, ring, demote))

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    core = MS.to_device(E.EngineState(**start), dev)
    dstate = fresh(MS.rank_rows(core, rank), 0)
    g = load_graph(np, E, MS, gdir, rank, dev)
    if rank == 0:
        lstate, g_all = fresh(core, P), load_graph(np, E, MS, gdir, None, dev)
    for t in range(max_ticks):
        if is_async:
            fire = torch.as_tensor(inter.fire_mask(t, rates=lat.throttle),
                                   device=dev)
            dstate, ds = dtick(dstate, g, delays, fire, window)
            dstats = list(ds.base) + [ds.pending, ds.shard_active,
                                      ds.shard_pending, ds.clock]
        else:
            dstate, ds, pending = dtick(dstate, g, delays, throttle)
            dstats = list(ds) + [pending]
        whole = MS.gather_rows(dstate, ctx.group)
        if rank == 0:
            if is_async:
                lstate, ls, _ = ltick(lstate, g_all, delays, fire, window)
                lstats = list(ls.base) + [ls.pending, ls.shard_active,
                                          ls.shard_pending, ls.clock]
            else:
                lstate, ls, _ = ltick(lstate, g_all, delays, throttle)
                lstats = list(ls.base) + [ls.pending]
            # the dist ring is [P senders, L1, ...], the local [L1, P, ...]
            pairs = [(a, b) for a, b in zip(E._leaves(whole.core),
                                            E._leaves(lstate.core))]
            pairs += [(a, b.transpose(0, 1)) for a, b in
                      zip(whole.ring, lstate.ring)]
            pairs += [(whole.demote, lstate.demote)]
            pairs += [(whole.clock, lstate.clock)] if is_async else []
            pairs += list(zip(dstats, lstats))
            bad = [k for k, (a, b) in enumerate(pairs)
                   if a.shape != b.shape or not torch.equal(a, b)]
            if bad:
                raise AssertionError(f"{schedule} dist tick {t}: fields "
                                     f"{bad} differ from the local tick's")
        if is_async:
            done = not bool((ds.shard_active + ds.shard_pending).any())
        else:
            done = int(ds.active) == 0 and int(pending) == 0
        if done:
            break
    in_flight = int(X.ring_pending(whole.ring))
    return {"rank": rank, "ticks": t + 1, "in_flight": in_flight,
            "clock": whole.clock.tolist() if is_async else None,
            "labels": whole.core.values.cpu().numpy() if rank == 0
            else None, "max_memory_allocated": _peak(torch, dev)}


def dist_nccl_phase(torch, E, G, MS, get_graph_config, get_program, dev,
                    d: str) -> dict:
    """``asymp_cc_wire`` on one shard as a 1-rank NCCL group (NCCL takes
    one rank per card), int16 labels and ids crossing the collective as
    bytes, stepped beside the local tick: bitwise every tick, to
    quiescence."""
    import torch.distributed as tdist
    cfg = dataclasses.replace(get_graph_config("asymp_cc_wire"),
                              num_shards=1)
    g = G.build_sharded_graph(cfg)
    prog = get_program(cfg)
    ep = E.default_params(cfg, g, prog)
    codec = E.wire_codec(prog, ep)
    check(codec.compression == "int16" and codec.compress_ids,
          f"dist_nccl: the wire is {codec.compression}, not int16")
    group, _ = MS.make_worker_group(0, 1, backend="nccl", device=dev,
                                    init_method=f"file://{d}/nccl_store",
                                    timeout_s=DIST_TIMEOUT_S)
    try:
        dg = E.to_device_graph(g, dev)
        ltick = E.make_local_tick(prog, ep, prog.weighted)
        dtick = E.make_dist_tick(prog, ep, group, prog.weighted)
        local = mine = E.init_state(prog, g, dev)
        _sync(torch, dev)
        t0 = time.perf_counter()
        sent = 0
        for t in range(cfg.max_ticks):
            local, ls, _ = ltick(local, dg)
            mine, ms = dtick(mine, dg)
            same = all(torch.equal(a, b) for a, b in zip(
                E._leaves(local) + list(ls), E._leaves(mine) + list(ms)))
            check(same, f"dist_nccl: tick {t} differs from the local tick")
            sent += int(ms.sent)
            if int(ms.active) == 0:
                break
        _sync(torch, dev)
        wall_s = time.perf_counter() - t0
    finally:
        tdist.destroy_process_group()
    out = dict(config=cfg.name, shards=1, backend="nccl",
               wire=codec.compression, compress_ids=codec.compress_ids,
               ticks=t + 1, messages=sent, bitwise_every_tick=True,
               lockstep_s=wall_s,
               wire_bytes_per_tick=codec.wire_bytes_per_tick())
    say("dist_nccl", **out)
    return out


def dist_main_phase(np, pool, E, get_program, cfg, graph, gdir, main_log,
                    labels) -> dict:
    """This slice's path at full width: ``cfg`` on the pool's ranks, one
    shard each, from ``init_state``: every tick's global counters equal
    the local run's (``main_log``), the labels too."""
    prog = get_program(cfg)
    ep = E.default_params(cfg, graph, prog)
    start = host_state(E.init_state(prog, graph, "cpu"))
    t0 = time.perf_counter()
    res = pool.run(rank_plain_job, cfg, ep, gdir, start, cfg.max_ticks, 0,
                   DIST_A2A_REPS, timeout_s=DIST_TIMEOUT_S)
    wall_s = time.perf_counter() - t0
    log = res[0]["log"]
    want = [[e["active"], e["sent"], e["accepted"], e["fetched"]]
            for e in main_log]
    n = graph.num_real_vertices
    got = res[0]["snapshots"][-1]["values"].reshape(-1)[:n]
    out = dict(
        config=cfg.name, ranks=pool.world_size, backend="gloo",
        ticks=len(log), messages=sum(r[1] for r in log),
        main_path_ticks=len(want), main_path_messages=sum(r[1] for r in want),
        per_tick_stats_equal_main_path=log == want,
        labels_equal_main_path=bool(np.array_equal(got, labels)),
        wall_s=wall_s, propagation_s=max(r["run_s"] for r in res),
        ms_per_tick=max(r["ms_per_tick"] for r in res),
        collective_ms_per_tick=[r["collective_ms"] for r in res],
        wire_bytes_per_tick=E.wire_codec(prog, ep).wire_bytes_per_tick(),
        route_capacity=ep.route_capacity,
        max_memory_allocated=[r["max_memory_allocated"] for r in res])
    say("dist_main", **out)
    check(out["per_tick_stats_equal_main_path"],
          "dist_main: the global TickStats differ from the local tick's")
    check(out["labels_equal_main_path"],
          "dist_main: labels differ from the main path's")
    check((out["ticks"], out["messages"]) == MAIN_PATH_COUNTS,
          f"dist_main: {out['ticks']} ticks, {out['messages']} messages != "
          f"{MAIN_PATH_COUNTS}")
    return out


def dist_crowded_phase(np, pool, E, get_program, cfg, graph, gdir,
                       fault_free) -> dict:
    """``cfg`` (crowded) under the crowded and the async dist ticks on the
    pool's ranks, rank 0 holding every tick bitwise to the local tick;
    at the end the ring is drained and the labels equal the fault-free
    run's (``fault_free[schedule]``)."""
    prog = get_program(cfg)
    ep = E.default_params(cfg, graph, prog)
    start = host_state(E.init_state(prog, graph, "cpu"))
    n = graph.num_real_vertices
    out = {}
    for schedule in ("sync", "async"):
        c = dataclasses.replace(cfg, schedule=schedule)
        t0 = time.perf_counter()
        res = pool.run(rank_lockstep_job, c, ep, gdir, start, schedule,
                       DIST_LOCKSTEP_TICKS, timeout_s=DIST_TIMEOUT_S)
        r0 = res[0]
        same = bool(np.array_equal(r0["labels"].reshape(-1)[:n],
                                   fault_free[schedule]))
        name = "dist_crowded" if schedule == "sync" else "dist_async"
        out[name] = dict(config=cfg.name, schedule=schedule,
                         ranks=pool.world_size, backend="gloo",
                         ticks=r0["ticks"], bitwise_every_tick=True,
                         ring_in_flight=r0["in_flight"], clock=r0["clock"],
                         labels_equal_fault_free=same,
                         wall_s=time.perf_counter() - t0,
                         max_memory_allocated=[r["max_memory_allocated"]
                                               for r in res])
        say(name, **out[name])
        check(r0["ticks"] < DIST_LOCKSTEP_TICKS,
              f"{name}: not quiescent in {DIST_LOCKSTEP_TICKS} ticks")
        check(r0["in_flight"] == 0 and same,
              f"{name}: {r0['in_flight']} messages in flight, labels equal "
              f"the fault-free labels: {same}")
    return out


def dist_rank_phase(np, torch, pool, E, M, get_program, cfg, graph, gdir,
                    oracle) -> dict:
    """Pagerank on the pool's ranks for a window of ``DIST_RANK_TICKS``
    ticks, the state gathered every 100: the mass balance within 1e-5 at
    each; if the run converges in the window, the pagerank verdict."""
    prog = get_program(cfg)
    ep = E.default_params(cfg, graph, prog)
    start = host_state(E.init_state(prog, graph, "cpu"))
    t0 = time.perf_counter()
    res = pool.run(rank_plain_job, cfg, ep, gdir, start, DIST_RANK_TICKS,
                   100, DIST_A2A_REPS, timeout_s=DIST_TIMEOUT_S)
    wall_s = time.perf_counter() - t0
    log = res[0]["log"]
    states = [E.EngineState(**{k: None if v is None else torch.from_numpy(v)
                               for k, v in s.items()})
              for s in res[0]["snapshots"]]
    masses = [M.mass_balance(s, graph) for s in states]
    converged = log[-1][0] == 0
    out = dict(config=cfg.name, ranks=pool.world_size, backend="gloo",
               ticks=len(log), messages=sum(r[1] for r in log),
               converged=converged, jax_cpu_ticks=JAX_PAGERANK[0],
               mass_balance_every_100=masses, wall_s=wall_s,
               ms_per_tick=max(r["ms_per_tick"] for r in res),
               collective_ms_per_tick=[r["collective_ms"] for r in res],
               max_memory_allocated=[r["max_memory_allocated"]
                                     for r in res])
    if converged:
        out["l1_to_oracle"], out["final_mass"] = pagerank_verdict(
            torch, np, M, states[-1], {"converged": True}, graph,
            oracle.cpu(), "dist_rank")
    say("dist_rank", **out)
    check(len(log) >= min(DIST_RANK_TICKS, 1000) or converged,
          f"dist_rank: {len(log)} ticks")
    check(all(abs(m - 1.0) < 1e-5 for m in masses),
          f"dist_rank: mass balance {masses}")
    return out


def lm_bounds(cfg, tokens: int, weight_bytes: int, kv_bytes: int) -> dict:
    """The least time of a forward over ``tokens`` new tokens: the weights
    (and the KV cache it reads) over the memory rate, or its bf16 products
    over the tensor cores' peak, whichever is larger.  The products are
    2 x tokens x the matmul weights (the tied head counted once: the
    lookup is no product) plus causal attention's QK^T and PV, 2 x 2 x
    layers x heads x head_dim x tokens x (tokens + 1) / 2 at least."""
    d, hd, L = cfg.d_model, cfg.head_dim, cfg.num_layers
    per_layer = (d * hd * (2 * cfg.num_heads + 2 * cfg.num_kv_heads)
                 + (3 if cfg.gated_mlp else 2) * d * cfg.d_ff)
    matmul = 2 * tokens * (L * per_layer + cfg.vocab_size * d)
    attn = 2 * 2 * L * cfg.num_heads * hd * tokens * (tokens + 1) // 2
    bytes_ms = (weight_bytes + kv_bytes) / H100_BYTES_PER_S * 1e3
    ops_ms = (matmul + attn) / H100_BF16_TENSOR_OPS_PER_S * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes_ms": bytes_ms, "ops_ms": ops_ms, "tflop": (matmul + attn)
            / 1e12}


def median_ms(torch, dev, fn, reps: int = LM_REPS) -> float:
    """Median host time of ``reps`` synchronised calls, after one warm-up."""
    fn()
    times = []
    for _ in range(reps):
        _sync(torch, dev)
        t0 = time.perf_counter()
        fn()
        _sync(torch, dev)
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[len(times) // 2]


def lm_near_tie(np, logits_fn, prompt, a, b, where: str) -> bool:
    """``a`` and ``b`` decode ``prompt``: equal, or at their first
    difference the full forward on the common prefix puts the two tokens
    within ``LM_GAP`` (a bf16 near tie).  True when equal."""
    diff = np.flatnonzero(a != b)
    if diff.size == 0:
        return True
    i = int(diff[0])
    last = logits_fn(np.concatenate([prompt, a[:i]])[None])[0]
    gap = abs(float(last[a[i]]) - float(last[b[i]]))
    check(gap < LM_GAP, f"{where}: token {i} differs ({a[i]} vs {b[i]}) "
                        f"with a logit gap of {gap}")
    return False


def lm_teacher_forced(np, logits_fn, prompt, got, where: str) -> int:
    """``tests/test_serve.py``'s rule on one request: every served token
    is the full forward's argmax on the served prefix or within ``LM_GAP``
    of it; returns how many are the argmax."""
    matches = 0
    for t in range(len(got)):
        last = logits_fn(np.concatenate([prompt, got[:t]])[None])[0]
        best = int(last.argmax())
        if best == int(got[t]):
            matches += 1
        else:
            gap = float(last[best] - last[got[t]])
            check(gap < LM_GAP, f"{where}: token {t} is {got[t]}, the "
                                f"argmax {best} is {gap} above it")
    return matches


def lm_serve_phase(np, torch, T, TA, LY, SE, cfg, dev, long_len: int,
                   cpu_cfg=None) -> dict:
    """The dense LM served on ``dev`` at ``cfg``: what ``python -m
    repro_torch.launch.serve --arch <cfg> --no-reduced`` runs (6 requests
    of 16 tokens, 2 slots, 12 new tokens each), each request held to
    ``generate`` of its prompt alone and teacher-forced against a full
    forward; then the prefill and decode times beside their bounds, one
    prefill of ``long_len`` tokens through the flash path with one layer's
    attention held to the dense path, and ``cpu_cfg`` on the card against
    the same weights on the CPU."""
    _sync(torch, dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    model = T.init_lm(cfg, seed=0, device=dev)
    _sync(torch, dev)
    init_s = time.perf_counter() - t0
    params = list(model.parameters())
    weight_bytes = sum(p.numel() * p.element_size() for p in params)
    n_matrix = sum(p.numel() for p in params if p.dtype == torch.bfloat16)
    check(n_matrix == cfg.param_count(),
          f"lm_serve: {n_matrix} bf16 parameters, param_count() "
          f"{cfg.param_count()}")

    def last_logits(tokens):
        """The full forward's logits at the last position (fp32, host)."""
        logits = T.forward(model, cfg, torch.as_tensor(tokens, device=dev))[0]
        last = logits[:, -1].float()
        check(bool(torch.isfinite(logits).all()), "lm_serve: a logit is "
                                                  "not finite")
        return last.cpu().numpy()

    # ---- the slot server: launch/serve's defaults ----
    rng = np.random.default_rng(0)
    s_max = LM_PROMPT + LM_MAX_NEW + 8
    reqs = [SE.Request(rid, rng.integers(0, cfg.vocab_size, LM_PROMPT)
                       .astype(np.int32), LM_MAX_NEW)
            for rid in range(LM_REQUESTS)]
    warm = SE.SlotServer(model, cfg, num_slots=LM_SLOTS, s_max=s_max)
    warm.submit(reqs[0])
    warm.run()
    server = SE.SlotServer(model, cfg, num_slots=LM_SLOTS, s_max=s_max)
    for r in reqs:
        server.submit(r)
    _sync(torch, dev)
    t0 = time.perf_counter()
    done = server.run()
    _sync(torch, dev)
    serve_s = time.perf_counter() - t0
    served = sum(len(v) for v in done.values())
    check(sorted(done) == list(range(LM_REQUESTS))
          and all(len(v) == LM_MAX_NEW for v in done.values()),
          f"lm_serve: served {({k: len(v) for k, v in done.items()})}")
    equal, argmax = 0, 0
    for r in reqs:
        alone = SE.generate(model, cfg, r.prompt[None], LM_MAX_NEW)[0]
        equal += lm_near_tie(np, last_logits, r.prompt, alone[LM_PROMPT:],
                             done[r.rid], f"lm_serve request {r.rid}")
        argmax += lm_teacher_forced(np, last_logits, r.prompt, done[r.rid],
                                    f"lm_serve request {r.rid}")
    check(argmax >= 0.75 * served, f"lm_serve: {argmax} of {served} served "
                                   f"tokens are the full forward's argmax")

    # ---- step times beside their bounds ----
    prefill = SE.make_prefill_step(cfg)
    decode = SE.make_decode_step(cfg)
    kv_row = 2 * cfg.num_layers * cfg.num_kv_heads * cfg.head_dim * 2

    def prefill_ms(n):
        toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, n)),
                               device=dev)

        def run():
            caches = T.init_cache(cfg, 1, n, dev)
            logits, _ = prefill(model, {"tokens": toks}, caches)
            check(bool(torch.isfinite(logits).all()),
                  f"lm_serve: prefill {n} logits not finite")
        return median_ms(torch, dev, run), lm_bounds(cfg, n, weight_bytes,
                                                     n * kv_row)

    short_ms, short_bound = prefill_ms(LM_PROMPT)
    long_ms, long_bound = prefill_ms(long_len)
    caches = SE._slot_positions(T.init_cache(cfg, LM_SLOTS, s_max, dev),
                                LM_SLOTS)
    for slot, r in enumerate(reqs[:LM_SLOTS]):
        one = T.init_cache(cfg, 1, s_max, dev)
        _, one = prefill(model, {"tokens": torch.as_tensor(
            r.prompt[None], device=dev)}, one)
        SE._write_slot(caches, one, slot)
    tok = torch.zeros((LM_SLOTS, 1), dtype=torch.int64, device=dev)
    state = {"caches": caches}

    def step():
        logits, state["caches"] = decode(model, tok, state["caches"])
        return logits

    decode_ms = median_ms(torch, dev, step)
    check(bool(torch.isfinite(step()).all()), "lm_serve: decode logits not "
                                              "finite")
    decode_bound = lm_bounds(cfg, LM_SLOTS, weight_bytes,
                             LM_SLOTS * s_max * kv_row)
    peak = _peak(torch, dev)
    # the device's busy share: a window of decode steps, one long prefill
    profiles = {}
    if dev.type == "cuda":
        profiles["decode_x3"] = device_profile(
            torch, lambda: [step() for _ in range(3)])
        long_toks = torch.as_tensor(
            rng.integers(0, cfg.vocab_size, (1, long_len)), device=dev)
        profiles[f"prefill_{long_len}"] = device_profile(
            torch, lambda: prefill(model, {"tokens": long_toks},
                                   T.init_cache(cfg, 1, long_len, dev)))

    # ---- one layer's attention at long_len: flash against dense ----
    x = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, long_len)),
                        device=dev)
    blk = model.stacks[0][0]
    h = LY.rms_norm(T.embed_tokens(model, cfg, x), blk.norm1, cfg.norm_eps)
    positions = torch.arange(long_len, device=dev)[None]
    check(long_len > TA.FLASH_THRESHOLD, "lm_serve: the long prefill does "
                                         "not take the flash path")
    flash, _ = TA.attention_layer(blk.attn, cfg, h, positions)
    threshold, TA.FLASH_THRESHOLD = TA.FLASH_THRESHOLD, long_len
    try:
        dense, _ = TA.attention_layer(blk.attn, cfg, h, positions)
    finally:
        TA.FLASH_THRESHOLD = threshold
    flash_err = float((flash.float() - dense.float()).abs().max()
                      / dense.float().abs().max())
    check(flash_err <= LM_FLASH_TOL, f"lm_serve: flash attention at "
                                     f"{long_len} tokens is {flash_err} of "
                                     f"max|out| from the dense path")
    del model, server, warm, caches, state
    out = dict(arch=cfg.name, layers=cfg.num_layers,
               parameters=cfg.param_count(), weight_bytes=weight_bytes,
               init_s=init_s, requests=LM_REQUESTS, slots=LM_SLOTS,
               prompt=LM_PROMPT, max_new=LM_MAX_NEW, served_tokens=served,
               serve_s=serve_s, tokens_per_s=served / serve_s,
               equal_to_generate_alone=equal, argmax_share=argmax / served,
               prefill_ms={LM_PROMPT: short_ms, long_len: long_ms},
               prefill_bound={LM_PROMPT: short_bound, long_len: long_bound},
               decode_ms=decode_ms, decode_bound=decode_bound,
               profiles=profiles or "not measured",
               max_memory_allocated=peak, flash_vs_dense=flash_err,
               flash_tol=LM_FLASH_TOL)

    # ---- the reduced config on the card against the CPU ----
    if cpu_cfg is not None:
        host = T.init_lm(cpu_cfg, seed=0, device="cpu")
        card = copy.deepcopy(host).to(dev)
        toks = rng.integers(0, cpu_cfg.vocab_size, (2, LM_PROMPT))
        lc = T.forward(host, cpu_cfg, torch.as_tensor(toks))[0].float()
        lg = T.forward(card, cpu_cfg, torch.as_tensor(toks, device=dev)
                       )[0].float().cpu()
        out["card_vs_cpu"] = float((lg - lc).abs().max() / lc.abs().max())
        out["card_vs_cpu_tol"] = LM_CARD_TOL
        check(out["card_vs_cpu"] <= LM_CARD_TOL,
              f"lm_serve: {cpu_cfg.name} on the card is "
              f"{out['card_vs_cpu']} of max|logit| from the CPU")
    say("lm_serve", **out)
    return out


def lm_train_bound(cfg, tokens: int, seq: int, param_bytes: int) -> dict:
    """The least time of one training step over ``tokens`` tokens in
    sequences of ``seq``: its bf16 products over the tensor cores' peak,
    then the clip and the optimizer's bytes over the memory rate (they
    wait for the last gradient, so the two add).  Products: 8 x
    parameters x tokens (forward 2, backward 4, the full remat's second
    forward 2, the chunked loss's recomputed head inside it) plus causal
    attention's QK^T and PV at least, 2 x 2 x layers x heads x head_dim x
    seq x (seq + 1) / 2 a sequence, four times (forward, recompute,
    backward 2x).  Bytes: ``param_bytes`` a parameter (the norm's read of
    the bf16 gradient, the clip's read and write, AdamW's reads of g, m,
    v, p and writes of m, v, p)."""
    n = cfg.param_count()
    attn = 4 * 2 * 2 * cfg.num_layers * cfg.num_heads * cfg.head_dim * (
        seq * (seq + 1) // 2) * (tokens // seq)
    flop = 8 * n * tokens + attn
    ops_ms = flop / H100_BF16_TENSOR_OPS_PER_S * 1e3
    bytes_ms = param_bytes * n / H100_BYTES_PER_S * 1e3
    return {"bound_ms": ops_ms + bytes_ms, "ops_ms": ops_ms,
            "bytes_ms": bytes_ms, "tflop": flop / 1e12,
            "optimizer_gb": param_bytes * n / 1e9}


def _train_steps(torch, TR, state, step_fn, batches, dev):
    """Run ``step_fn`` over ``batches``: (state, losses, grad norms,
    synchronised ms a step)."""
    losses, gnorms, ms = [], [], []
    for b in batches:
        _sync(torch, dev)
        t0 = time.perf_counter()
        state, m = step_fn(state, b)
        losses.append(float(m["loss"]))
        _sync(torch, dev)
        ms.append((time.perf_counter() - t0) * 1e3)
        gnorms.append(float(m["grad_norm"]))
    return state, losses, gnorms, ms


def _copied(CK, tree):
    """A training-state tree with every tensor copied (``from_checkpoint``
    moves tensors, and a move to their own device is no copy)."""
    return CK._map_leaves(lambda t: t.clone(), tree)


def _max_diff(torch, a: dict, b: dict) -> float:
    return max(float((x.float() - b[k].float().to(x.device)).abs().max())
               for k, x in a.items())


def lm_train_phase(np, torch, T, TA, TR, OPT, DP, CK, cfg, dev,
                   long_len: int, small_cfg) -> dict:
    """The dense LM trained on ``dev`` at ``cfg`` (``python -m
    repro_torch.launch.train --arch <cfg>``'s defaults: batch 8, seq 128,
    lr 3e-4 with a cosine warm-up over steps // 10, AdamW, the config's
    remat), then one step at 1 x ``long_len`` tokens (the flash path and
    its autograd backward), one layer's flash gradients against dense
    attention's at ``long_len``, ``small_cfg`` trained on the card and on
    the CPU from the same weights, and a checkpoint round trip."""
    out = {"arch": cfg.name, "layers": cfg.num_layers, "remat": cfg.remat,
           "optimizer": cfg.optimizer, "parameters": cfg.param_count()}
    # ---- (a) the launcher's defaults at full width ----
    _sync(torch, dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    state = TR.init_state(cfg, seed=0, device=dev)
    _sync(torch, dev)
    out["init_s"] = time.perf_counter() - t0
    schedule = OPT.cosine_schedule(LM_TRAIN_LR,
                                   warmup=max(LM_TRAIN_STEPS // 10, 1),
                                   total=LM_TRAIN_STEPS)
    step_fn = TR.make_train_step(cfg, schedule=schedule)
    pipe = DP.DataPipeline(DP.SyntheticSource(cfg.vocab_size, LM_TRAIN_SEQ),
                           LM_TRAIN_BATCH)
    state, losses, gnorms, ms = _train_steps(
        torch, TR, state, step_fn,
        [pipe.next_batch() for _ in range(LM_TRAIN_STEPS)], dev)
    check(all(np.isfinite(losses)) and all(np.isfinite(gnorms)),
          f"lm_train: loss {losses} grad norm {gnorms}")
    check(np.mean(losses[-3:]) < losses[0],
          f"lm_train: the mean loss of the last 3 steps {losses[-3:]} is not "
          f"below the first step's {losses[0]}")
    tokens = LM_TRAIN_BATCH * LM_TRAIN_SEQ
    steady = sorted(ms[1:])[len(ms[1:]) // 2]
    out.update(batch=LM_TRAIN_BATCH, seq=LM_TRAIN_SEQ, steps=LM_TRAIN_STEPS,
               losses=losses, grad_norms=gnorms, step_ms=ms,
               step_ms_median=steady, tokens_per_s=tokens / steady * 1e3,
               bound=lm_train_bound(cfg, tokens, LM_TRAIN_SEQ,
                                    LM_TRAIN_OPT_BYTES))
    if dev.type == "cuda":
        held = {"state": state}

        def profiled():
            held["state"], m = step_fn(held["state"], pipe.next_batch())
            return m
        out["profile"] = device_profile(torch, profiled)
        state = held.pop("state")
    out["max_memory_allocated"] = _peak(torch, dev)
    say("lm_train_main", **out)

    # ---- (b) one step at 1 x long_len: flash forward, autograd backward --
    check(long_len > TA.FLASH_THRESHOLD, "lm_train: the long step does not "
                                         "take the flash path")
    calls = {"n": 0}
    bwd = TA._flash_bwd

    def counted(*a):
        calls["n"] += 1
        return bwd(*a)
    TA._flash_bwd = counted
    try:
        long_pipe = DP.DataPipeline(DP.SyntheticSource(cfg.vocab_size,
                                                       long_len), 1)
        state, l_losses, l_gn, l_ms = _train_steps(
            torch, TR, state, step_fn,
            [long_pipe.next_batch() for _ in range(2)], dev)
    finally:
        TA._flash_bwd = bwd
    check(all(np.isfinite(l_losses)) and all(np.isfinite(l_gn)),
          f"lm_train: at {long_len} tokens loss {l_losses} grad norm {l_gn}")
    check(calls["n"] == 2 * cfg.num_layers,
          f"lm_train: the flash backward ran {calls['n']} times in 2 steps "
          f"of {cfg.num_layers} layers")
    long = dict(tokens=long_len, losses=l_losses, grad_norms=l_gn,
                step_ms=l_ms, flash_backward_calls=calls["n"],
                bound=lm_train_bound(cfg, long_len, long_len,
                                     LM_TRAIN_OPT_BYTES),
                max_memory_allocated=_peak(torch, dev))
    say("lm_train_long", **long)
    out["long"] = long
    del state, step_fn

    # ---- (c) one layer's flash gradients against dense attention ----
    rng = np.random.default_rng(0)
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim

    def leaf(h):
        return torch.from_numpy(rng.standard_normal((1, long_len, h, hd))
                                ).to(dev, torch.bfloat16).requires_grad_()
    q, k, v = leaf(hq), leaf(hkv), leaf(hkv)
    dout = torch.from_numpy(rng.standard_normal((1, long_len, hq, hd))
                            ).to(dev, torch.bfloat16)
    flash = torch.autograd.grad(TA.flash_attention(q, k, v), (q, k, v), dout)
    causal = torch.tril(torch.ones(long_len, long_len, dtype=torch.bool,
                                   device=dev))
    dense = torch.autograd.grad(
        TA.dense_attention(q, k, v, causal[None, None, None]), (q, k, v),
        dout)
    errs = {n: float((a.float() - b.float()).abs().max()
                     / b.float().abs().max())
            for n, a, b in zip(("dq", "dk", "dv"), flash, dense)}
    check(max(errs.values()) <= LM_FLASH_GRAD_TOL,
          f"lm_train: flash gradients at {long_len} tokens {errs} of max|grad| "
          f"from dense attention's")
    out["flash_grads_vs_dense"] = errs
    say("lm_train_flash_grads", tokens=long_len, heads=(hq, hkv, hd),
        rel_err=errs, tol=LM_FLASH_GRAD_TOL)
    del q, k, v, dout, flash, dense, causal

    # ---- (d) the small config on the card against the CPU ----
    fixed = TR.make_train_step(small_cfg)  # a constant lr: every step moves
    small = DP.DataPipeline(DP.SyntheticSource(small_cfg.vocab_size, 32), 4)
    batches = [small.next_batch() for _ in range(2)]
    host = TR.init_state(small_cfg, seed=0, device="cpu")
    card = TR.from_checkpoint(small_cfg, _copied(CK, TR.to_checkpoint(host)),
                              dev)
    host, h_loss, h_gn, _ = _train_steps(torch, TR, host, fixed, batches,
                                         torch.device("cpu"))
    card, c_loss, c_gn, _ = _train_steps(torch, TR, card, fixed, batches, dev)
    hp = {k: p.detach() for k, p in T.param_dict(host.params).items()}
    cp = {k: p.detach() for k, p in T.param_dict(card.params).items()}
    ulp = max(float(p.float().abs().max()) for p in hp.values()) * 2.0 ** -8
    bound = 4 * 3e-4 * len(batches) + ulp  # a sign flip of u, each step
    d = dict(loss_rel=max(abs(a - b) / abs(a) for a, b in zip(h_loss, c_loss)),
             grad_norm_rel=max(abs(a - b) / a for a, b in zip(h_gn, c_gn)),
             params_max_abs=_max_diff(torch, cp, hp), params_bound=bound,
             moments_max_abs=_max_diff(torch, card.opt_state.m,
                                       host.opt_state.m),
             tol=LM_TRAIN_CARD_TOL)
    check(d["loss_rel"] <= LM_TRAIN_CARD_TOL
          and d["grad_norm_rel"] <= LM_TRAIN_CARD_TOL
          and d["params_max_abs"] <= bound,
          f"lm_train: {small_cfg.name} on the card against the CPU: {d}")
    out["card_vs_cpu"] = d
    say("lm_train_card_vs_cpu", arch=small_cfg.name,
        layers=small_cfg.num_layers, losses=[h_loss, c_loss], **d)

    # ---- (e) a checkpoint round trip on the card ----
    state = TR.from_checkpoint(small_cfg, _copied(CK, TR.to_checkpoint(host)),
                               dev)
    with tempfile.TemporaryDirectory() as ck_dir:
        cm = CK.CheckpointManager(ck_dir)
        cm.save(int(state.step), TR.to_checkpoint(state),
                metadata={"pipeline": small.snapshot()}, blocking=False)
        cm.wait()
        tree, meta = cm.restore(device=dev)
    back = TR.from_checkpoint(small_cfg, tree, dev)
    saved, got = TR.to_checkpoint(state), TR.to_checkpoint(back)
    same = all(torch.equal(a, b) and a.dtype == b.dtype for a, b in zip(
        CK._flatten_with_paths(saved).values(),
        CK._flatten_with_paths(got).values()))
    check(same and meta["pipeline"] == small.snapshot(),
          "lm_train: the restored state is not bitwise the saved one")
    nxt = [small.next_batch()]
    _, a_loss, _, _ = _train_steps(torch, TR, state, fixed, nxt, dev)
    _, b_loss, _, _ = _train_steps(torch, TR, back, fixed, nxt, dev)
    rel = abs(a_loss[0] - b_loss[0]) / abs(a_loss[0])
    check(rel <= LM_TRAIN_CKPT_TOL, f"lm_train: the step after the restore "
                                    f"gives loss {b_loss}, uninterrupted "
                                    f"{a_loss}")
    out["checkpoint"] = dict(bitwise=same, step=int(back.step),
                             loss=a_loss[0], restored_loss=b_loss[0],
                             rel=rel, tol=LM_TRAIN_CKPT_TOL)
    say("lm_train_checkpoint", **out["checkpoint"])
    return out


# ======================================================================
# The MoE family (phi3.5-moe at full width; no SpMV kernel on any of it)
# ======================================================================
def moe_keep(np, sel, C: int):
    """The reference's bucket rule replayed on the host: a (token, slot)
    pair of one group ``sel`` [T, k] is kept when fewer than ``C``
    earlier pairs, in (token, slot) order, picked its expert."""
    flat = sel.reshape(-1)
    keep = np.zeros(flat.size, bool)
    seen = {}
    for i, e in enumerate(flat.tolist()):
        keep[i] = seen.get(e, 0) < C
        seen[e] = seen.get(e, 0) + 1
    return keep.reshape(sel.shape)


def moe_plain(torch, p: dict, x, gate, sel, keep):
    """The plain per-token fp32 MoE: y_t = sum_j keep_tj * gate_tj *
    expert_{sel_tj}(x_t), each expert's gated MLP (silu) in fp32 on the
    bf16 weights upcast, plus the shared expert's when ``p`` has one; x
    [T, D], gate/sel/keep [T, k]."""
    xf = x.float()
    y = torch.zeros_like(xf)
    keep = torch.as_tensor(keep, device=x.device)
    for e in range(p["w_in"].shape[0]):
        t_i, j_i = torch.nonzero((sel == e) & keep, as_tuple=True)
        if t_i.numel() == 0:
            continue
        xe = xf[t_i]
        h = xe @ p["w_in"][e].float()
        g = xe @ p["w_gate"][e].float()
        out = (g * torch.sigmoid(g) * h) @ p["w_out"][e].float()
        y.index_add_(0, t_i, out * gate[t_i, j_i, None])
    if "shared_w_in" in p:
        hs = xf @ p["shared_w_in"].float()
        gs = xf @ p["shared_w_gate"].float()
        y = y + (gs * torch.sigmoid(gs) * hs) @ p["shared_w_out"].float()
    return y


class MoeTap:
    """Wraps ``models/moe.py::apply_moe`` while active: counts each call's
    dropped pairs (on the device; read once at the end) and keeps the
    first call's parameters, input and output (layer 0).  The library is
    untouched: the transformer calls ``moe.apply_moe`` through the
    module, as ``lm_train`` wraps the flash backward."""

    def __init__(self, torch, MOE):
        self.torch, self.MOE = torch, MOE
        self.calls, self.drops, self.first = [], [], None

    def __enter__(self):
        torch, MOE, apply = self.torch, self.MOE, self.MOE.apply_moe

        def tapped(p, cfg, x):
            G, Tg = MOE.groups_of(x)
            _, _, sel = MOE.route(p, cfg, x.reshape(G, Tg, -1))
            self.drops.append((MOE._pair_ranks(sel, cfg.num_experts)
                               >= MOE.capacity(cfg, Tg)).sum())
            self.calls.append(tuple(x.shape))
            y, aux = apply(p, cfg, x)
            if self.first is None:
                self.first = ({k: v.detach() for k, v in p.items()},
                              x.detach(), y.detach())
            return y, aux
        self._apply = apply
        MOE.apply_moe = tapped
        return self

    def __exit__(self, *exc):
        self.MOE.apply_moe = self._apply

    def dropped(self, decode_only: bool = False) -> int:
        """Pairs dropped over the calls (``decode_only``: the calls of one
        token a row)."""
        picked = [n for n, s in zip(self.drops, self.calls)
                  if s[1] == 1 or not decode_only]
        return int(self.torch.stack(picked).sum()) if picked else 0


def moe_layer_vs_plain(np, torch, MOE, cfg, tap, where: str) -> dict:
    """The layer-0 MoE call ``tap`` kept, against ``moe_plain`` with the
    same selections and the host replay of the keep mask."""
    p, x, y = tap.first
    G, Tg = MOE.groups_of(x)
    D = x.shape[-1]
    _, gate, sel = MOE.route(p, cfg, x.reshape(G, Tg, D))
    C = MOE.capacity(cfg, Tg)
    keep = np.concatenate([moe_keep(np, s, C) for s in sel.cpu().numpy()])
    k = cfg.experts_per_token
    ref = moe_plain(torch, p, x.reshape(-1, D), gate.reshape(-1, k),
                    sel.reshape(-1, k), keep)
    err = float((y.reshape(-1, D).float() - ref).abs().max()
                / ref.abs().max())
    check(err <= MOE_PLAIN_TOL, f"{where}: layer 0's MoE output is {err} of "
                                f"max|y| from the plain per-token reference")
    return {"tokens": int(x.shape[0] * x.shape[1]), "groups": G,
            "capacity": C, "dropped_pairs": int((~keep).sum()),
            "rel_err": err, "tol": MOE_PLAIN_TOL}


def moe_bounds(cfg, tokens: int, weight_bytes: int, kv_bytes: int,
               buffer_rows: int) -> dict:
    """``lm_bounds`` for an MoE forward: the expert products run on the
    whole ``[E, C]`` buffer (``buffer_rows`` = G * E * C rows a layer,
    empty slots included), 3 x 2 x D x F each; the router, attention and
    the head as a dense forward's."""
    d, hd, L = cfg.d_model, cfg.head_dim, cfg.num_layers
    attn_w = d * hd * (2 * cfg.num_heads + 2 * cfg.num_kv_heads)
    experts = 3 * 2 * buffer_rows * d * cfg.d_ff * L
    proj = 2 * tokens * (L * (attn_w + d * cfg.num_experts)
                         + cfg.vocab_size * d)
    attn = 2 * 2 * L * cfg.num_heads * hd * tokens * (tokens + 1) // 2
    bytes_ms = (weight_bytes + kv_bytes) / H100_BYTES_PER_S * 1e3
    ops_ms = (experts + proj + attn) / H100_BF16_TENSOR_OPS_PER_S * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes_ms": bytes_ms, "ops_ms": ops_ms,
            "tflop": {"experts": experts / 1e12, "projections": proj / 1e12,
                      "attention": attn / 1e12}}


def lm_moe_serve_phase(np, torch, T, MOE, SE, cfg, dev, long_len: int,
                       cpu_cfg) -> dict:
    """phi3.5-moe (16 of 32 layers, a scan stack) served on ``dev`` as
    ``python -m repro_torch.launch.serve --arch phi3.5-moe-42b-a6.6b
    --no-reduced`` serves it, at that depth: the launcher's defaults,
    each request's tokens against ``generate`` of its prompt alone and a
    full forward (counted, gated on the first token only: see the
    module docstring), the decode step and a ``long_len`` prefill held
    against the plain per-token MoE at layer 0, times beside their
    bounds, and the reduced config on the card against the CPU."""
    _sync(torch, dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    model = T.init_lm(cfg, seed=0, device=dev)
    _sync(torch, dev)
    init_s = time.perf_counter() - t0
    params = list(model.parameters())
    weight_bytes = sum(p.numel() * p.element_size() for p in params)
    n_matrix = sum(p.numel() for p in params if p.dtype == torch.bfloat16)
    check(n_matrix == cfg.param_count(),
          f"lm_moe_serve: {n_matrix} bf16 parameters, param_count() "
          f"{cfg.param_count()}")
    check(T.build_plan(cfg).stacks[0].scan and tuple(
        model.stacks[0].moe["w_in"].shape) == (cfg.num_layers,
                                              cfg.num_experts, cfg.d_model,
                                              cfg.d_ff),
          "lm_moe_serve: the MoE stack is not the [L, E, D, F] layout")

    def last_logits(tokens):
        logits = T.forward(model, cfg, torch.as_tensor(tokens, device=dev))[0]
        check(bool(torch.isfinite(logits).all()),
              "lm_moe_serve: a logit is not finite")
        return logits[:, -1].float().cpu().numpy()

    # ---- the slot server: launch/serve's defaults ----
    rng = np.random.default_rng(0)
    s_max = LM_PROMPT + LM_MAX_NEW + 8
    reqs = [SE.Request(rid, rng.integers(0, cfg.vocab_size, LM_PROMPT)
                       .astype(np.int32), LM_MAX_NEW)
            for rid in range(LM_REQUESTS)]
    warm = SE.SlotServer(model, cfg, num_slots=LM_SLOTS, s_max=s_max)
    warm.submit(reqs[0])
    warm.run()
    server = SE.SlotServer(model, cfg, num_slots=LM_SLOTS, s_max=s_max)
    for r in reqs:
        server.submit(r)
    _sync(torch, dev)
    t0 = time.perf_counter()
    done = server.run()
    _sync(torch, dev)
    serve_s = time.perf_counter() - t0
    served = sum(len(v) for v in done.values())
    check(sorted(done) == list(range(LM_REQUESTS))
          and all(len(v) == LM_MAX_NEW for v in done.values()),
          f"lm_moe_serve: served {({k: len(v) for k, v in done.items()})}")
    # the same traffic again, counting each MoE call's dropped pairs
    counted = SE.SlotServer(model, cfg, num_slots=LM_SLOTS, s_max=s_max)
    for r in reqs:
        counted.submit(r)
    with MoeTap(torch, MOE) as tap:
        again = counted.run()
    decode_steps = sum(1 for s in tap.calls if s[1] == 1) // cfg.num_layers
    decode_drops = tap.dropped(decode_only=True)
    same_twice = all(np.array_equal(again[k], v) for k, v in done.items())
    equal, argmax, first = 0, 0, 0
    for r in reqs:
        alone = SE.generate(model, cfg, r.prompt[None], LM_MAX_NEW)[0]
        equal += bool(np.array_equal(alone[LM_PROMPT:], done[r.rid]))
        # the first token comes from a prefill, which groups the prompt as
        # a full forward does: the teacher-forced rule holds for it
        first += lm_teacher_forced(np, last_logits, r.prompt,
                                   alone[LM_PROMPT:LM_PROMPT + 1],
                                   f"lm_moe_serve request {r.rid}")
        for t in range(1, LM_MAX_NEW):
            last = last_logits(alone[None, :LM_PROMPT + t])[0]
            argmax += int(last.argmax()) == int(alone[LM_PROMPT + t])
    check(first >= 0.75 * LM_REQUESTS, f"lm_moe_serve: {first} of "
          f"{LM_REQUESTS} first tokens are the full forward's argmax")

    # ---- step times beside their bounds ----
    prefill = SE.make_prefill_step(cfg)
    decode = SE.make_decode_step(cfg)
    kv_row = 2 * cfg.num_layers * cfg.num_kv_heads * cfg.head_dim * 2
    E, k = cfg.num_experts, cfg.experts_per_token

    def prefill_ms(n):
        toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, n)),
                               device=dev)

        def run():
            caches = T.init_cache(cfg, 1, n, dev)
            logits, _ = prefill(model, {"tokens": toks}, caches)
            check(bool(torch.isfinite(logits).all()),
                  f"lm_moe_serve: prefill {n} logits not finite")
        rows = E * MOE.capacity(cfg, n)
        return median_ms(torch, dev, run), moe_bounds(
            cfg, n, weight_bytes, n * kv_row, rows), toks

    short_ms, short_bound, _ = prefill_ms(LM_PROMPT)
    long_ms, long_bound, long_toks = prefill_ms(long_len)
    with MoeTap(torch, MOE) as tap:
        prefill(model, {"tokens": long_toks}, T.init_cache(cfg, 1, long_len,
                                                           dev))
    long_check = moe_layer_vs_plain(np, torch, MOE, cfg, tap,
                                    f"lm_moe_serve prefill {long_len}")
    long_check["dropped_pairs_all_layers"] = tap.dropped()
    caches = SE._slot_positions(T.init_cache(cfg, LM_SLOTS, s_max, dev),
                                LM_SLOTS)
    for slot, r in enumerate(reqs[:LM_SLOTS]):
        one = T.init_cache(cfg, 1, s_max, dev)
        _, one = prefill(model, {"tokens": torch.as_tensor(
            r.prompt[None], device=dev)}, one)
        SE._write_slot(caches, one, slot)
    tok = torch.as_tensor(rng.integers(0, cfg.vocab_size, (LM_SLOTS, 1)),
                          device=dev)
    state = {"caches": caches}

    def step():
        logits, state["caches"] = decode(model, tok, state["caches"])
        return logits

    decode_ms = median_ms(torch, dev, step)
    with MoeTap(torch, MOE) as tap:
        check(bool(torch.isfinite(step()).all()),
              "lm_moe_serve: decode logits not finite")
    decode_check = moe_layer_vs_plain(np, torch, MOE, cfg, tap,
                                      "lm_moe_serve decode")
    decode_check["dropped_pairs_all_layers"] = tap.dropped()
    decode_bound = moe_bounds(cfg, LM_SLOTS, weight_bytes,
                              LM_SLOTS * s_max * kv_row,
                              E * MOE.capacity(cfg, LM_SLOTS))
    peak = _peak(torch, dev)
    profiles = {"decode_x3": device_profile(
        torch, lambda: [step() for _ in range(3)]),
        f"prefill_{long_len}": device_profile(
        torch, lambda: prefill(model, {"tokens": long_toks},
                               T.init_cache(cfg, 1, long_len, dev)))}
    out = dict(arch=cfg.name, layers=cfg.num_layers,
               parameters=cfg.param_count(), weight_bytes=weight_bytes,
               init_s=init_s, requests=LM_REQUESTS, slots=LM_SLOTS,
               prompt=LM_PROMPT, max_new=LM_MAX_NEW, served_tokens=served,
               serve_s=serve_s, tokens_per_s=served / serve_s,
               same_tokens_served_twice=same_twice,
               decode_steps=decode_steps, decode_dropped_pairs=decode_drops,
               dropped_pairs_per_decode_step=decode_drops / decode_steps,
               equal_to_generate_alone=equal,
               first_token_argmax=first,
               later_tokens_argmax_share=argmax / (LM_REQUESTS
                                                   * (LM_MAX_NEW - 1)),
               prefill_ms={LM_PROMPT: short_ms, long_len: long_ms},
               prefill_bound={LM_PROMPT: short_bound, long_len: long_bound},
               decode_ms=decode_ms, decode_bound=decode_bound,
               layer0_vs_plain={"decode": decode_check,
                                f"prefill_{long_len}": long_check},
               profiles=profiles, max_memory_allocated=peak)
    del model, server, warm, counted, caches, state, long_toks
    _sync(torch, dev)
    torch.cuda.empty_cache()

    # ---- the reduced config on the card against the CPU ----
    host = T.init_lm(cpu_cfg, seed=0, device="cpu")
    card = copy.deepcopy(host).to(dev)
    toks = rng.integers(0, cpu_cfg.vocab_size, (2, LM_PROMPT))
    lc = T.forward(host, cpu_cfg, torch.as_tensor(toks))[0].float()
    lg = T.forward(card, cpu_cfg, torch.as_tensor(toks, device=dev)
                   )[0].float().cpu()
    per = (lg - lc).abs().amax(-1) / lc.abs().max()
    share = float((per <= LM_CARD_TOL).float().mean())
    out["card_vs_cpu"] = {"share_within": share, "tol": LM_CARD_TOL,
                          "min_share": MOE_CARD_SHARE,
                          "max_rel": float(per.max())}
    check(share >= MOE_CARD_SHARE and float(per.max()) <= 1.0,
          f"lm_moe_serve: {cpu_cfg.name} on the card against the CPU: "
          f"{out['card_vs_cpu']}")
    say("lm_moe_serve", **out)
    return out


def lm_moe_train_phase(np, torch, T, TR, OPT, DP, CK, cfg, dev,
                       small_cfg) -> dict:
    """phi3.5-moe (4 of 32 layers) trained on ``dev`` as ``python -m
    repro_torch.launch.train --arch phi3.5-moe-42b-a6.6b --layers 4``
    runs it (AdamW, remat "full", batch 8 x seq 128, lr 3e-4 warmed up
    over 1 of 10 steps), then a checkpoint round trip of ``small_cfg``
    (the reduced config at 8 layers: the stacked ``[L, E, D, F]``
    leaves) on the card."""
    out = {"arch": cfg.name, "layers": cfg.num_layers, "remat": cfg.remat,
           "optimizer": cfg.optimizer, "parameters": cfg.param_count()}
    _sync(torch, dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    state = TR.init_state(cfg, seed=0, device=dev)
    _sync(torch, dev)
    out["init_s"] = time.perf_counter() - t0
    schedule = OPT.cosine_schedule(LM_TRAIN_LR,
                                   warmup=max(LM_TRAIN_STEPS // 10, 1),
                                   total=LM_TRAIN_STEPS)
    step_fn = TR.make_train_step(cfg, schedule=schedule)
    pipe = DP.DataPipeline(DP.SyntheticSource(cfg.vocab_size, LM_TRAIN_SEQ),
                           LM_TRAIN_BATCH)
    losses, auxes, gnorms, ms = [], [], [], []
    for _ in range(LM_TRAIN_STEPS):
        _sync(torch, dev)
        t0 = time.perf_counter()
        state, m = step_fn(state, pipe.next_batch())
        losses.append(float(m["loss"]))
        _sync(torch, dev)
        ms.append((time.perf_counter() - t0) * 1e3)
        auxes.append(float(m["aux"]))
        gnorms.append(float(m["grad_norm"]))
    check(all(np.isfinite(losses + auxes + gnorms)),
          f"lm_moe_train: loss {losses} aux {auxes} grad norm {gnorms}")
    check(np.mean(losses[-3:]) < losses[0],
          f"lm_moe_train: the mean loss of the last 3 steps {losses[-3:]} is "
          f"not below the first step's {losses[0]}")
    tokens = LM_TRAIN_BATCH * LM_TRAIN_SEQ
    steady = sorted(ms[1:])[len(ms[1:]) // 2]
    # computed parameters a token: all but the experts, plus k experts
    active = cfg.active_param_count()
    products = 8 * active * tokens
    ops_ms = products / H100_BF16_TENSOR_OPS_PER_S * 1e3
    bytes_ms = LM_TRAIN_OPT_BYTES * cfg.param_count() / H100_BYTES_PER_S * 1e3
    out.update(batch=LM_TRAIN_BATCH, seq=LM_TRAIN_SEQ, steps=LM_TRAIN_STEPS,
               losses=losses, auxes=auxes, grad_norms=gnorms, step_ms=ms,
               step_ms_median=steady, tokens_per_s=tokens / steady * 1e3,
               bound={"bound_ms": ops_ms + bytes_ms, "ops_ms": ops_ms,
                      "bytes_ms": bytes_ms, "tflop": products / 1e12,
                      "active_parameters": active})
    held = {"state": state}

    def profiled():
        held["state"], m = step_fn(held["state"], pipe.next_batch())
        return m
    out["profile"] = device_profile(torch, profiled)
    out["max_memory_allocated"] = _peak(torch, dev)
    del state, held, step_fn
    _sync(torch, dev)
    torch.cuda.empty_cache()

    # ---- a checkpoint round trip of the stacked layout ----
    out["checkpoint"] = checkpoint_round_trip(torch, TR, DP, CK, small_cfg,
                                              dev, "lm_moe_train")
    say("lm_moe_train", **out)
    return out


def checkpoint_round_trip(torch, TR, DP, CK, small_cfg, dev,
                          where: str, features=None) -> dict:
    """``small_cfg`` trained one step on the card, its state saved by
    ``CheckpointManager`` (on a background thread) and restored: bitwise
    the saved state, and the next step's loss equal to the uninterrupted
    run's.  ``features(step, rows)`` gives an encoder-decoder's frames."""
    fixed = TR.make_train_step(small_cfg)
    small = DP.DataPipeline(DP.SyntheticSource(small_cfg.vocab_size, 32), 4)

    def batch(i):
        b = small.next_batch()
        if features is not None:
            b["features"] = features(i, 4)
        return b
    state = TR.init_state(small_cfg, seed=0, device=dev)
    state, _ = fixed(state, batch(0))
    with tempfile.TemporaryDirectory() as ck_dir:
        cm = CK.CheckpointManager(ck_dir)
        cm.save(int(state.step), TR.to_checkpoint(state),
                metadata={"pipeline": small.snapshot()}, blocking=False)
        cm.wait()
        tree, meta = cm.restore(device=dev)
    back = TR.from_checkpoint(small_cfg, tree, dev)
    saved, got = TR.to_checkpoint(state), TR.to_checkpoint(back)
    same = all((a is None and b is None) or (torch.equal(a, b)
                                             and a.dtype == b.dtype)
               for a, b in zip(CK._flatten_with_paths(saved).values(),
                               CK._flatten_with_paths(got).values()))
    check(same and meta["pipeline"] == small.snapshot(),
          f"{where}: the restored state is not bitwise the saved one")
    nxt = batch(1)
    _, a = fixed(state, nxt)
    _, b = fixed(back, nxt)
    check(float(a["loss"]) == float(b["loss"]),
          f"{where}: the step after the restore gives loss "
          f"{float(b['loss'])}, uninterrupted {float(a['loss'])}")
    return dict(arch=small_cfg.name, layers=small_cfg.num_layers,
                bitwise=same, loss=float(a["loss"]),
                restored_loss=float(b["loss"]))


# ---- expert parallelism: one MoE layer on 4 gloo ranks sharing the card
def moe_layer_weights(torch, cfg, experts, dev) -> dict:
    """Layer weights of phi3.5-moe from ``MOE_SEED``: the router whole and
    ``experts`` (a range) of ``w_in``/``w_gate``/``w_out``, each expert
    drawn from its own generator, so a rank draws only its experts and
    the parent the same values."""
    from repro_torch.models.layers import mk
    gen = torch.Generator(device=dev).manual_seed(MOE_SEED)
    scale = 1.0 / cfg.num_experts ** 0.5  # init_moe's (mk's fan-in is E)
    p = {"router": mk(gen, (cfg.d_model, cfg.num_experts), scale=0.02,
                      device=dev)}
    ws = {"w_in": [], "w_gate": [], "w_out": []}
    for e in experts:
        g = torch.Generator(device=dev).manual_seed(MOE_SEED + 1 + e)
        for name, shape in (("w_in", (cfg.d_model, cfg.d_ff)),
                            ("w_gate", (cfg.d_model, cfg.d_ff)),
                            ("w_out", (cfg.d_ff, cfg.d_model))):
            ws[name].append(mk(g, shape, scale=scale, device=dev))
    p.update({k: torch.stack(v) for k, v in ws.items()})
    return p


def moe_tokens(torch, cfg, dev):
    gen = torch.Generator(device=dev).manual_seed(MOE_SEED - 1)
    return torch.randn((MOE_BATCH, MOE_SEQ, cfg.d_model), generator=gen,
                       device=dev).to(torch.bfloat16)


def moe_cotangent(torch, cfg, dev):
    """The output's cotangent of the backward check (fp32)."""
    gen = torch.Generator(device=dev).manual_seed(MOE_SEED - 2)
    return torch.randn((MOE_BATCH, MOE_SEQ, cfg.d_model), generator=gen,
                       device=dev)


def rank_moe_job(ctx, cfg, shape: dict, reps: int):
    """One MoE layer of ``cfg`` (phi3.5-moe at full width) on this rank of
    a ``shape`` mesh: its experts' slices drawn here, its block of the
    tokens; ``apply_moe`` under the mesh and the backward of this rank's
    share of ``sum(y * ct) + aux`` (through the all-to-alls and the FSDP
    gather), then ``reps`` timed forward calls with the collectives timed
    apart.  Returns the output block, the aux, the block's selections and
    gates, the gradients of its weight slices and of its tokens, and the
    times and bytes."""
    import torch

    from repro_torch.dist import exchange as X
    from repro_torch.dist.sharding import Mesh, use_mesh_rules
    from repro_torch.models import moe as MOE
    from repro_torch.models import moe_a2a as A2A
    dev = ctx.device
    mesh = Mesh.build(shape, ctx.rank)
    E_loc = cfg.num_experts // shape["model"]
    m = mesh.coords["model"]
    full = moe_layer_weights(torch, cfg, range(m * E_loc, (m + 1) * E_loc),
                             dev)
    fsdp = A2A.fsdp_axes(mesh, cfg, cfg.d_model)
    p = {"router": full["router"]}
    for name in ("w_in", "w_gate", "w_out"):  # this rank's w_spec block
        w = full[name]
        if fsdp:
            n = w.shape[1] // mesh.shape["data"]
            w = w[:, mesh.coords["data"] * n:(mesh.coords["data"] + 1) * n]
        p[name] = w.contiguous()
    del full
    p = {k: v.requires_grad_() for k, v in p.items()}
    x = A2A.rank_block(moe_tokens(torch, cfg, dev), mesh).clone()
    x.requires_grad_()
    ct = A2A.rank_block(moe_cotangent(torch, cfg, dev), mesh)
    coll = {"ms": 0.0, "bytes": 0}
    originals = (X.all_to_all, X.all_gather)

    def timed(fn):
        def run(t, group, *a, **kw):
            _sync(torch, dev)
            t0 = time.perf_counter()
            out = fn(t, group, *a, **kw)
            _sync(torch, dev)
            coll["ms"] += (time.perf_counter() - t0) * 1e3
            if X.group_size(group) > 1:  # a 1-rank gather moves nothing
                coll["bytes"] += t.numel() * t.element_size()
            return out
        return run
    with use_mesh_rules(mesh):
        y, aux = MOE.apply_moe(p, cfg, x)
        share = math.prod(shape.values())
        _sync(torch, dev)
        t0 = time.perf_counter()
        (torch.sum(y.float() * ct) + aux / share).backward()
        _sync(torch, dev)
        backward_ms = (time.perf_counter() - t0) * 1e3
        G, Tg = MOE.groups_of(x)
        with torch.no_grad():
            _, gate, sel = MOE.route(p, cfg, x.reshape(G, Tg, -1))
        X.all_to_all, X.all_gather = (timed(f) for f in originals)
        try:
            call_ms = []
            for _ in range(reps):
                coll["ms"], coll["bytes"] = 0.0, 0
                _sync(torch, dev)
                t0 = time.perf_counter()
                with torch.no_grad():
                    MOE.apply_moe(p, cfg, x)
                _sync(torch, dev)
                call_ms.append((time.perf_counter() - t0) * 1e3)
        finally:
            X.all_to_all, X.all_gather = originals
    return {"rank": ctx.rank, "coords": mesh.coords,
            "y": y.detach().float().cpu(), "aux": float(aux.detach()),
            "grads": {k: v.grad.float().cpu() for k, v in p.items()},
            "x_grad": x.grad.float().cpu(), "backward_ms": backward_ms,
            "sel": sel.reshape(-1, 2).cpu(), "gate": gate.reshape(-1, 2).cpu(),
            "call_ms": sorted(call_ms)[len(call_ms) // 2],
            "collective_ms": coll["ms"], "collective_bytes": coll["bytes"],
            "weight_bytes": sum(v.numel() * v.element_size()
                                for v in p.values()),
            "max_memory_allocated": _peak(torch, dev)}


def moe_grad_reference(torch, MOE, A2A, SH, cfg, full, x, ct, shape, ranks,
                       keeps) -> dict:
    """The gradients of ``sum(y * ct) + aux`` through the plain per-token
    fp32 MoE, one process: each rank's block routed as the rank routed it
    (the same block shape, so the same selections; checked) with the keep
    mask of the host's replay, the aux over every token.  Returns the
    gradients of x and of each leaf."""
    leaves = {k: v.detach().clone().requires_grad_() for k, v in full.items()}
    xg = x.detach().clone().requires_grad_()
    k = cfg.experts_per_token
    loss = 0.0
    for r, keep in zip(ranks, keeps):
        mesh = SH.Mesh(shape, r["rank"])
        xb = A2A.rank_block(xg, mesh)
        G, Tg = MOE.groups_of(xb)
        _, gate, sel = MOE.route(leaves, cfg, xb.reshape(G, Tg, -1))
        check(torch.equal(sel.reshape(-1, k).cpu(), r["sel"].long()),
              "moe_a2a: the reference's selections are not the rank's")
        y = moe_plain(torch, leaves, xb.reshape(-1, cfg.d_model),
                      gate.reshape(-1, k), sel.reshape(-1, k), keep)
        loss = loss + torch.sum(y * A2A.rank_block(ct, mesh).reshape(y.shape))
    G, Tg = MOE.groups_of(xg)
    probs, _, sel_all = MOE.route(leaves, cfg, xg.reshape(G, Tg, -1))
    (loss + MOE.aux_loss(cfg, probs, sel_all)).backward()
    out = {k: v.grad for k, v in leaves.items()}
    out["x"] = xg.grad
    return out


def moe_placed_grads(torch, A2A, SH, cfg, shape, got, like: dict) -> dict:
    """The ranks' gradients as global tensors: a rank's expert slices and
    token block placed (``w_spec``/``x_spec``), the router's summed."""
    out = {k: torch.zeros(v.shape, dtype=torch.float32) for k, v in
           like.items()}
    for r in got:
        mesh = SH.Mesh(shape, r["rank"])
        fsdp = A2A.fsdp_axes(mesh, cfg, cfg.d_model)
        A2A.rank_block(out["x"], mesh)[...] = r["x_grad"]
        for k, g in r["grads"].items():
            if k == "router":
                out[k] += g
                continue
            e0 = mesh.coords["model"] * g.shape[0]
            d0 = (mesh.index(fsdp) if fsdp else 0) * g.shape[1]
            out[k][e0:e0 + g.shape[0], d0:d0 + g.shape[1]] = g
    return out


def a2a_keep(np, sels: list, tp: int, E: int, cap: int):
    """The reference's all-to-all routing replayed on the host for the
    ranks of one model row (``sels``: each rank's [T_l, k] selections, by
    model coordinate): a pair is kept when it fits its destination's
    ``cap`` at the sender and its expert's ``C_loc`` at the receiver.
    Returns each rank's keep mask and the two drop counts."""
    E_loc = E // tp
    C_loc = max(int(np.ceil(tp * cap / E_loc)), 8)
    received = [[] for _ in range(tp)]  # per owner: (source, pair) in order
    sent = [np.zeros(s.shape, bool) for s in sels]
    for src in range(tp):
        count = np.zeros(tp, int)
        for i, e in enumerate(sels[src].reshape(-1).tolist()):
            o = e // E_loc
            if count[o] < cap:
                sent[src].reshape(-1)[i] = True
                received[o].append((src, i, count[o]))
            count[o] += 1
    keep = [np.zeros(s.shape, bool) for s in sels]
    for o in range(tp):
        seen = np.zeros(E_loc, int)
        # slot order at the receiver: by source, then by the sender's slot
        for src, i, _ in sorted(received[o], key=lambda r: (r[0], r[2])):
            e = sels[src].reshape(-1)[i] % E_loc
            keep[src].reshape(-1)[i] = seen[e] < C_loc
            seen[e] += 1
    sender = sum(int((~s).sum()) for s in sent)
    receiver = sum(int((s & ~k).sum()) for s, k in zip(sent, keep))
    return keep, sender, receiver


def moe_a2a_phase(np, torch, MS, SH, MOE, A2A, cfg, dev, dist_dir) -> dict:
    """One MoE layer of phi3.5-moe at full width, expert-parallel on 4
    gloo ranks sharing the card: data 1 x model 4 (4 experts a rank) and
    data 2 x model 2 (FSDP: the experts' dim 1 gathered over the data
    axis).  Each rank's output against the plain per-token reference
    with the keep mask the host replay of the routing gives, and the
    global aux against the single-process value on the same tokens."""
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    full = moe_layer_weights(torch, cfg, range(cfg.num_experts), dev)
    x = moe_tokens(torch, cfg, dev)
    ct = moe_cotangent(torch, cfg, dev)
    G, Tg = MOE.groups_of(x)
    probs, _, sel1 = MOE.route(full, cfg, x.reshape(G, Tg, -1))
    aux1 = float(MOE.aux_loss(cfg, probs, sel1))
    out = {"tokens": [MOE_BATCH, MOE_SEQ], "single_process_aux": aux1}
    with MS.RankPool(MOE_RANKS, backend="gloo", device=dev,
                     init_method=f"file://{dist_dir}/moe_store",
                     timeout_s=DIST_TIMEOUT_S) as pool:
        for shape in MOE_MESHES:
            got = pool.run(rank_moe_job, cfg, shape, MOE_REPS)
            tp = shape["model"]
            rows = {}
            for r in got:
                rows.setdefault(r["coords"]["data"], {})[
                    r["coords"]["model"]] = r
            worst, sender, receiver = 0.0, 0, 0
            ordered, all_keeps = [], []
            for row in rows.values():
                ranks = [row[m] for m in range(tp)]
                T_l = ranks[0]["sel"].shape[0]
                cap = max(int(np.ceil(cfg.capacity_factor * T_l
                                      * cfg.experts_per_token / tp)), 8)
                keeps, s_d, r_d = a2a_keep(
                    np, [r["sel"].numpy() for r in ranks], tp,
                    cfg.num_experts, cap)
                sender += s_d
                receiver += r_d
                ordered += ranks
                all_keeps += keeps
                for r, keep in zip(ranks, keeps):
                    xb = A2A.rank_block(x, SH.Mesh(shape, r["rank"]))
                    ref = moe_plain(torch, full, xb.reshape(-1, cfg.d_model),
                                    r["gate"].to(dev), r["sel"].to(dev),
                                    keep)
                    err = float((r["y"].to(dev).reshape(ref.shape) - ref)
                                .abs().max() / ref.abs().max())
                    worst = max(worst, err)
            auxes = {r["aux"] for r in got}
            aux_rel = abs(next(iter(auxes)) - aux1) / aux1
            name = "x".join(f"{a}{n}" for a, n in shape.items())
            want = moe_grad_reference(torch, MOE, A2A, SH, cfg, full, x, ct,
                                      shape, ordered, all_keeps)
            placed = moe_placed_grads(torch, A2A, SH, cfg, shape, got, want)
            grad_err = {k: float((placed[k] - w.float().cpu()).abs().max()
                                 / w.float().abs().max())
                        for k, w in want.items()}
            del want, placed
            check(max(grad_err.values()) <= MOE_GRAD_TOL,
                  f"moe_a2a {name}: gradients {grad_err} of max|grad| from "
                  f"the plain reference's")
            res = {"mesh": shape, "experts_a_rank": cfg.num_experts // tp,
                   "rel_err": worst, "tol": MOE_PLAIN_TOL,
                   "sender_drops": sender, "receiver_drops": receiver,
                   "aux": next(iter(auxes)), "aux_rel": aux_rel,
                   "grad_rel_err": grad_err, "grad_tol": MOE_GRAD_TOL,
                   "backward_ms": [r["backward_ms"] for r in got],
                   "call_ms": [r["call_ms"] for r in got],
                   "collective_ms": [r["collective_ms"] for r in got],
                   "collective_bytes": [r["collective_bytes"] for r in got],
                   "weight_bytes": [r["weight_bytes"] for r in got],
                   "max_memory_allocated": [r["max_memory_allocated"]
                                            for r in got]}
            check(worst <= MOE_PLAIN_TOL, f"moe_a2a {name}: a rank's output "
                                          f"is {worst} of max|y| from the "
                                          f"plain reference")
            check(len(auxes) == 1 and aux_rel <= MOE_AUX_TOL,
                  f"moe_a2a {name}: aux {auxes} against {aux1}")
            out[name] = res
    say("moe_a2a", **out)
    return out


# ======================================================================
# The SSM and hybrid families (mamba2-780m and hymba-1.5b at full width and
# depth; no SpMV kernel on either)
# ======================================================================
def _pairs(start: int, new: int, window: int) -> int:
    """The causal (query, key) pairs of ``new`` queries at positions
    ``start``, ``start + 1``, ..., each attending to at most ``window``
    keys (0: every key before it)."""
    return sum(min(p + 1, window) if window else p + 1
               for p in range(start, start + new))


def ssm_products(cfg, windows, rows: int, new: int, start: int) -> int:
    """The products beyond the matrices' of ``rows`` sequences of ``new``
    tokens after ``start`` cached ones: the SSD's (the chunked scan's
    diagonal blocks, chunk states and off-diagonal term for a prompt, the
    recurrent update and read-out for one token) and a hybrid layer's
    attention scores and values over each query's keys (its window's)."""
    H, N, P = cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim
    if new > 1:
        Q = min(cfg.ssm_chunk, new)
        ssd = 2 * Q * N + 2 * H * Q * P + 4 * H * N * P
    else:
        ssd = 4 * H * N * P
    ops = cfg.num_layers * rows * new * ssd
    if cfg.num_heads:
        ops += sum(2 * 2 * cfg.num_heads * cfg.head_dim * rows
                   * _pairs(start, new, w) for w in windows)
    return ops


def ssm_cache_bytes(cfg, windows, rows: int, positions: int,
                    step: bool) -> int:
    """The cache bytes a forward moves: the SSD states (fp32; read and
    written by a decode step, written by a prefill) and the K/V of
    ``positions`` (a window layer's at most its window) read by a decode
    step or written by a prefill."""
    state = (cfg.num_layers * rows * cfg.ssm_heads * cfg.ssm_state
             * cfg.ssm_head_dim * 4)
    kv = sum(rows * (min(positions, w) if w else positions)
             * cfg.num_kv_heads * cfg.head_dim * 2 * 2 for w in windows
             ) if cfg.num_heads else 0
    return state * (2 if step else 1) + kv


def ssm_bounds(cfg, windows, n_matrix: int, rows: int, new: int, start: int,
               weight_bytes: int, cache_bytes: int) -> dict:
    """The least time of a forward: every weight byte and the cache bytes
    over the memory rate, or 2 x tokens x the bf16 matrix elements (the
    tied embedding counted once, as the head's product) plus
    ``ssm_products`` over the tensor cores' peak, whichever is larger."""
    ops = 2 * rows * new * n_matrix + ssm_products(cfg, windows, rows, new,
                                                   start)
    bytes_ms = (weight_bytes + cache_bytes) / H100_BYTES_PER_S * 1e3
    ops_ms = ops / H100_BF16_TENSOR_OPS_PER_S * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes_ms": bytes_ms, "ops_ms": ops_ms, "tflop": ops / 1e12}


def ssm_recurrence(torch, xs, dt, a, B, C):
    """The plain SSD in fp32, one position at a time: ``state = state *
    exp(dt a) + B (x) dt x``, ``y = C . state``; xs [b,S,H,P], dt [b,S,H],
    B, C [b,S,N] -> y [b,S,H,P] fp32."""
    f = torch.float32
    xs, dt, B, C = xs.to(f), dt.to(f), B.to(f), C.to(f)
    state = xs.new_zeros((xs.shape[0], xs.shape[2], B.shape[-1],
                          xs.shape[3]))
    ys = []
    for t in range(xs.shape[1]):
        state = (state * torch.exp(dt[:, t] * a)[..., None, None]
                 + torch.einsum("bn,bh,bhp->bhnp", B[:, t], dt[:, t],
                                xs[:, t]))
        ys.append(torch.einsum("bn,bhnp->bhp", C[:, t], state))
    return torch.stack(ys, dim=1)


class CallTap:
    """Counts the calls of ``module.name`` while active, and keeps the
    first call's arguments and result (the library is untouched: its
    callers reach the function through the module)."""

    def __init__(self, module, name: str):
        self.module, self.name = module, name
        self.calls, self.first = 0, None

    def __enter__(self):
        fn = getattr(self.module, self.name)

        def tapped(*args, **kw):
            out = fn(*args, **kw)
            if self.first is None:
                self.first = (args, kw, out)
            self.calls += 1
            return out
        self._fn = fn
        setattr(self.module, self.name, tapped)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self._fn)


def ssm_decode_vs_forward(np, torch, T, SE, model, cfg, prompt,
                          got) -> dict:
    """The greedy decode of ``prompt`` alone, as ``generate`` runs it (a
    prefill in a cache of ``len(prompt) + len(got)`` positions, then one
    decode step a token, batch 1), teacher-forced along ``got``, and one
    full forward over the same tokens.  Its logits are ``generate``'s
    while ``got`` is their argmax, so ``generate`` alone gives ``got`` up
    to the first position whose argmax differs, and that argmax there.
    Returns the largest difference of the two paths' logits of
    max|logit|, the first position where ``generate`` alone differs
    (None: equal) with the decode's gap there, and how many tokens of
    ``got`` are each path's argmax."""
    dev = model.embed.device
    row = np.concatenate([prompt, got[:-1]])
    fwd = T.forward(model, cfg, torch.as_tensor(row[None], device=dev)
                    )[0][0, len(prompt) - 1:].float()
    caches = T.init_cache(cfg, 1, len(prompt) + len(got), dev)
    logits, caches = SE.make_prefill_step(cfg)(
        model, {"tokens": torch.as_tensor(prompt[None], device=dev)}, caches)
    dec = [logits[0, -1]]
    decode = SE.make_decode_step(cfg)
    for tok in got[:-1]:
        logits, caches = decode(model, torch.tensor(
            [[int(tok)]], device=dev), caches)
        dec.append(logits[0, -1])
    dec = torch.stack(dec).float()
    check(bool(torch.isfinite(dec).all() and torch.isfinite(fwd).all()),
          "a logit of the decode or the full forward is not finite")
    got_t = torch.as_tensor(np.asarray(got), device=dev)
    best = dec.argmax(-1)
    diff = torch.nonzero(best != got_t).flatten().tolist()
    first = diff[0] if diff else None
    gap = (float(dec[first, best[first]] - dec[first, got_t[first]])
           if diff else 0.0)
    return {"rel_err": float((dec - fwd).abs().max() / fwd.abs().max()),
            "first_difference": first, "gap": gap,
            "decode_argmax": int((best == got_t).sum()),
            "forward_argmax": int((fwd.argmax(-1) == got_t).sum())}


class Fp32Caches:
    """While active, ``transformer.init_cache`` gives fp32 caches (the
    port's, as the reference's, hold K/V and conv rows in bf16), so an
    fp32 copy of a model serves in fp32 end to end.  The library is
    untouched: the serving engine reaches ``init_cache`` through the
    module."""

    def __init__(self, torch, T):
        self.torch, self.T = torch, T

    def __enter__(self):
        torch, init = self.torch, self.T.init_cache

        def fp32(tree):
            if torch.is_tensor(tree):
                return tree.float() if tree.dtype == torch.bfloat16 else tree
            if tree is None:
                return None
            if hasattr(tree, "_fields"):
                return type(tree)(*(fp32(t) for t in tree))
            return tuple(fp32(t) for t in tree)
        self._init = init
        self.T.init_cache = lambda *a, **kw: fp32(init(*a, **kw))
        return self

    def __exit__(self, *exc):
        self.T.init_cache = self._init


def ssm_served(np, torch, T, SE, model, cfg, reqs, s_max: int, where: str,
               gate_tol=None) -> dict:
    """The launcher's slot server on ``reqs``, then each request against
    ``generate`` of its prompt alone and its decode's logits against a
    full forward's (``ssm_decode_vs_forward``).  With ``gate_tol``: each
    request equal to ``generate`` alone or a near tie at the first
    difference, and the logits within ``gate_tol`` of max|logit|; else
    reported."""
    server = SE.SlotServer(model, cfg, num_slots=LM_SLOTS, s_max=s_max)
    for r in reqs:
        server.submit(r)
    dev = model.embed.device
    _sync(torch, dev)
    t0 = time.perf_counter()
    done = server.run()
    _sync(torch, dev)
    serve_s = time.perf_counter() - t0
    check(sorted(done) == [r.rid for r in reqs]
          and all(len(done[r.rid]) == r.max_new for r in reqs),
          f"{where}: served {({k: len(v) for k, v in done.items()})}")
    steps = [ssm_decode_vs_forward(np, torch, T, SE, model, cfg, r.prompt,
                                   done[r.rid]) for r in reqs]
    gaps = [st["gap"] for st in steps if st["first_difference"] is not None]
    worst = max(st["rel_err"] for st in steps)
    if gate_tol is not None:
        check(all(g < LM_GAP for g in gaps),
              f"{where}: served tokens differ from generate alone with "
              f"logit gaps {gaps}")
        check(worst <= gate_tol, f"{where}: the decode's logits are {worst} "
                                 f"of max|logit| from the full forward's")
    served = sum(len(v) for v in done.values())
    return {"served_tokens": served, "serve_s": serve_s,
            "tokens_per_s": served / serve_s,
            "equal_to_generate_alone": len(steps) - len(gaps),
            "first_difference_gaps": gaps,
            "decode_vs_forward_max": worst, "decode_vs_forward": steps}


def lm_ssm_serve_phase(np, torch, T, TA, SSM, SE, cfg, dev, long_len: int,
                       cpu_cfg) -> dict:
    """An SSM or hybrid LM at full width served on ``dev`` as
    ``python -m repro_torch.launch.serve --arch <cfg> --no-reduced`` serves
    it (6 requests of 16 tokens, 2 slots, 12 new), timed; the prefill and
    decode times beside their bounds; a prefill of ``long_len`` tokens
    (hymba: blocked windows, flash in the global layers, rings from then
    on) whose layer-0 SSD is held to the fp32 recurrence, then
    ``SSM_DECODE`` steps from its cache.  In bf16 the recurrent decode is
    not the full forward's arithmetic and drifts from it with depth (so
    does the reference's: see ``SSM_DECODE_TOL``), so the bf16 run's requests
    against ``generate`` alone and its decode against a full forward are
    reported; the same weights in fp32 (fp32 caches) are then served again
    and held: each request equal to ``generate`` alone or a near tie, the
    decode's logits (the served ones, and past the long prefill) within
    ``SSM_DECODE_TOL`` of a full forward's.  ``cpu_cfg`` on the card
    against the CPU."""
    where = f"lm_ssm_serve {cfg.name}"
    sections, t_sec = {}, time.perf_counter()

    def section(name):
        nonlocal t_sec
        sections[name] = time.perf_counter() - t_sec
        t_sec = time.perf_counter()
    _sync(torch, dev)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    model = T.init_lm(cfg, seed=0, device=dev)
    _sync(torch, dev)
    init_s = time.perf_counter() - t0
    params = list(model.parameters())
    weight_bytes = sum(p.numel() * p.element_size() for p in params)
    n_matrix = sum(p.numel() for p in params if p.dtype == torch.bfloat16)
    plan = T.build_plan(cfg).stacks[0]
    windows = plan.windows
    check(plan.kind in ("ssm", "hybrid") and plan.n == cfg.num_layers,
          f"{where}: plan {plan}")

    # ---- the slot server: launch/serve's defaults, bf16 ----
    rng = np.random.default_rng(0)
    s_max = LM_PROMPT + LM_MAX_NEW + 8
    reqs = [SE.Request(rid, rng.integers(0, cfg.vocab_size, LM_PROMPT)
                       .astype(np.int32), LM_MAX_NEW)
            for rid in range(LM_REQUESTS)]
    warm = SE.SlotServer(model, cfg, num_slots=LM_SLOTS, s_max=s_max)
    warm.submit(reqs[0])
    warm.run()
    del warm
    bf16 = ssm_served(np, torch, T, SE, model, cfg, reqs, s_max, where)
    section("serve_bf16")

    # ---- step times beside their bounds ----
    prefill = SE.make_prefill_step(cfg)
    decode = SE.make_decode_step(cfg)

    def prefill_ms(n):
        toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, n)),
                               device=dev)

        def run():
            logits, _ = prefill(model, {"tokens": toks},
                                T.init_cache(cfg, 1, n, dev))
            check(bool(torch.isfinite(logits).all()),
                  f"{where}: prefill {n} logits not finite")
        return median_ms(torch, dev, run), ssm_bounds(
            cfg, windows, n_matrix, 1, n, 0, weight_bytes,
            ssm_cache_bytes(cfg, windows, 1, n, False))

    short_ms, short_bound = prefill_ms(LM_PROMPT)
    long_ms, long_bound = prefill_ms(long_len)
    caches = SE._slot_positions(T.init_cache(cfg, LM_SLOTS, s_max, dev),
                                LM_SLOTS)
    for slot, r in enumerate(reqs[:LM_SLOTS]):
        one = T.init_cache(cfg, 1, s_max, dev)
        _, one = prefill(model, {"tokens": torch.as_tensor(
            r.prompt[None], device=dev)}, one)
        SE._write_slot(caches, one, slot)
    tok = torch.zeros((LM_SLOTS, 1), dtype=torch.int64, device=dev)
    state = {"caches": caches}

    def step():
        logits, state["caches"] = decode(model, tok, state["caches"])
        return logits

    decode_ms = median_ms(torch, dev, step)
    check(bool(torch.isfinite(step()).all()), f"{where}: decode logits not "
                                              f"finite")
    decode_bound = ssm_bounds(cfg, windows, n_matrix, LM_SLOTS, 1, LM_PROMPT,
                              weight_bytes, ssm_cache_bytes(
                                  cfg, windows, LM_SLOTS, s_max, True))
    peak = _peak(torch, dev)
    profiles = {}
    if dev.type == "cuda":  # one step: the profiler's own cost grows with
        # the ops it records (~10,000 a step here)
        profiles["decode_x1"] = device_profile(torch, step)
        long_toks = torch.as_tensor(
            rng.integers(0, cfg.vocab_size, (1, long_len)), device=dev)
        profiles[f"prefill_{long_len}"] = device_profile(
            torch, lambda: prefill(model, {"tokens": long_toks},
                                   T.init_cache(cfg, 1, long_len, dev)))
    del caches, state
    section("times_and_profiles")

    # ---- the long prefill: its paths, layer 0's scan, decode past it ----
    prompt = rng.integers(0, cfg.vocab_size, long_len)
    with CallTap(SSM, "ssd_chunked") as scan, \
            CallTap(TA, "swa_attention_blocked") as swa, \
            CallTap(TA, "flash_attention") as flash:
        logits, caches = prefill(model, {"tokens": torch.as_tensor(
            prompt[None], device=dev)}, T.init_cache(
                cfg, 1, long_len + SSM_DECODE, dev))
    n_swa = sum(1 for w in windows if w and long_len > w)
    n_flash = sum(1 for w in windows if not w) if cfg.num_heads and \
        long_len > TA.FLASH_THRESHOLD else 0
    check(scan.calls == cfg.num_layers and swa.calls == n_swa
          and flash.calls == n_flash,
          f"{where}: the long prefill ran {scan.calls} scans, {swa.calls} "
          f"blocked windows, {flash.calls} flash (want {cfg.num_layers}, "
          f"{n_swa}, {n_flash})")
    (xs, dt, a, B, C, chunk), _, (y_scan, _) = scan.first
    y_ref = ssm_recurrence(torch, xs, dt, a, B, C)
    scan_err = float((y_scan.float() - y_ref).abs().max()
                     / y_ref.abs().max())
    check(scan_err <= SSM_SCAN_TOL, f"{where}: layer 0's chunked scan at "
                                    f"{long_len} tokens is {scan_err} of "
                                    f"max|y| from the fp32 recurrence")
    del xs, dt, B, C, y_scan, y_ref, scan
    got = []
    nxt = torch.argmax(logits[:, -1], dim=-1)[:, None]
    for _ in range(SSM_DECODE):
        got.append(int(nxt[0, 0]))
        logits, caches = decode(model, nxt, caches)
        check(bool(torch.isfinite(logits).all()), f"{where}: a decode step "
                                                  f"past the prefill is "
                                                  f"not finite")
        nxt = torch.argmax(logits[:, -1], dim=-1)[:, None]
    del caches
    got = np.asarray(got)
    past_bf16 = ssm_decode_vs_forward(np, torch, T, SE, model, cfg, prompt,
                                      got)
    section("long_prefill_bf16")

    # ---- the same weights in fp32: the serving checks held ----
    model.float()
    with Fp32Caches(torch, T):
        fp32 = ssm_served(np, torch, T, SE, model, cfg, reqs, s_max,
                          f"{where} (fp32)", gate_tol=SSM_DECODE_TOL)
        past = ssm_decode_vs_forward(np, torch, T, SE, model, cfg, prompt,
                                     got)
    check(past["rel_err"] <= SSM_DECODE_TOL,
          f"{where} (fp32): the decode past {long_len} tokens is "
          f"{past['rel_err']} of max|logit| from the full forward")
    section("fp32_checks")
    out = dict(arch=cfg.name, layers=cfg.num_layers, kind=plan.kind,
               windows=sorted(set(windows)), matrix_elements=n_matrix,
               weight_bytes=weight_bytes, init_s=init_s,
               requests=LM_REQUESTS, slots=LM_SLOTS, prompt=LM_PROMPT,
               max_new=LM_MAX_NEW, bf16=bf16, fp32=fp32,
               decode_tol=SSM_DECODE_TOL,
               prefill_ms={LM_PROMPT: short_ms, long_len: long_ms},
               prefill_bound={LM_PROMPT: short_bound, long_len: long_bound},
               decode_ms=decode_ms, decode_bound=decode_bound,
               long_prefill={"scans": cfg.num_layers, "blocked_windows": n_swa,
                             "flash": n_flash, "scan_vs_recurrence": scan_err,
                             "scan_tol": SSM_SCAN_TOL,
                             "decode_steps": SSM_DECODE,
                             "decode_vs_forward_bf16": past_bf16,
                             "decode_vs_forward_fp32": past},
               profiles=profiles or "not measured",
               max_memory_allocated=peak)
    del model
    _sync(torch, dev)

    # ---- the reduced config on the card against the CPU ----
    host = T.init_lm(cpu_cfg, seed=0, device="cpu")
    card = copy.deepcopy(host).to(dev)
    toks = rng.integers(0, cpu_cfg.vocab_size, (2, 40))
    lc = T.forward(host, cpu_cfg, torch.as_tensor(toks))[0].float()
    lg = T.forward(card, cpu_cfg, torch.as_tensor(toks, device=dev)
                   )[0].float().cpu()
    out["card_vs_cpu"] = float((lg - lc).abs().max() / lc.abs().max())
    out["card_vs_cpu_tol"] = LM_CARD_TOL
    check(out["card_vs_cpu"] <= LM_CARD_TOL,
          f"{where}: {cpu_cfg.name} on the card is {out['card_vs_cpu']} of "
          f"max|logit| from the CPU")
    section("card_vs_cpu")
    out["section_s"] = sections
    say("lm_ssm_serve", **out)
    return out


def ssm_small_cfg(cfg, ssm_layers: int):
    """The reduced config held on the card against the CPU or checkpointed:
    mamba2 at ``ssm_layers`` (8: the stacked [L, ...] leaves), hymba at
    ``SSM_HYBRID_LAYERS`` (layer 1 windowed between global ones)."""
    small = cfg.reduced()
    layers = SSM_HYBRID_LAYERS if cfg.num_heads else ssm_layers
    return dataclasses.replace(small, num_layers=layers)


def lm_ssm_train_phase(np, torch, T, TA, TR, OPT, DP, CK, cfg, dev,
                       long_len: int, small_cfg) -> dict:
    """An SSM or hybrid LM at full width trained on ``dev`` as
    ``python -m repro_torch.launch.train --arch <cfg>`` trains it (batch
    8, seq 128, lr 3e-4 warmed up over 1 of 10 steps; the config's AdamW,
    remat "full", tied embeddings), then 2 steps at 1 x ``long_len`` (the
    SSD's and, for hymba, the blocked window's backward past the window),
    and a checkpoint round trip of ``small_cfg``."""
    where = f"lm_ssm_train {cfg.name}"
    out = {"arch": cfg.name, "layers": cfg.num_layers, "remat": cfg.remat,
           "optimizer": cfg.optimizer}
    _sync(torch, dev)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    state = TR.init_state(cfg, seed=0, device=dev)
    _sync(torch, dev)
    out["init_s"] = time.perf_counter() - t0
    params = list(state.params.parameters())
    n_params = sum(p.numel() for p in params)
    n_matrix = sum(p.numel() for p in params if p.dtype == torch.bfloat16)
    windows = T.build_plan(cfg).stacks[0].windows
    schedule = OPT.cosine_schedule(LM_TRAIN_LR,
                                   warmup=max(LM_TRAIN_STEPS // 10, 1),
                                   total=LM_TRAIN_STEPS)
    step_fn = TR.make_train_step(cfg, schedule=schedule)
    pipe = DP.DataPipeline(DP.SyntheticSource(cfg.vocab_size, LM_TRAIN_SEQ),
                           LM_TRAIN_BATCH)
    state, losses, gnorms, ms = _train_steps(
        torch, TR, state, step_fn,
        [pipe.next_batch() for _ in range(LM_TRAIN_STEPS)], dev)
    check(all(np.isfinite(losses)) and all(np.isfinite(gnorms)),
          f"{where}: loss {losses} grad norm {gnorms}")
    check(np.mean(losses[-3:]) < losses[0],
          f"{where}: the mean loss of the last 3 steps {losses[-3:]} is not "
          f"below the first step's {losses[0]}")

    def bound(rows, seq):
        ops = 8 * n_matrix * rows * seq + 4 * ssm_products(
            cfg, windows, rows, seq, 0)
        ops_ms = ops / H100_BF16_TENSOR_OPS_PER_S * 1e3
        bytes_ms = LM_TRAIN_OPT_BYTES * n_params / H100_BYTES_PER_S * 1e3
        return {"bound_ms": ops_ms + bytes_ms, "ops_ms": ops_ms,
                "bytes_ms": bytes_ms, "tflop": ops / 1e12}
    tokens = LM_TRAIN_BATCH * LM_TRAIN_SEQ
    steady = sorted(ms[1:])[len(ms[1:]) // 2]
    out.update(parameters=n_params, matrix_elements=n_matrix,
               batch=LM_TRAIN_BATCH, seq=LM_TRAIN_SEQ, steps=LM_TRAIN_STEPS,
               losses=losses, grad_norms=gnorms, step_ms=ms,
               step_ms_median=steady, tokens_per_s=tokens / steady * 1e3,
               bound=bound(LM_TRAIN_BATCH, LM_TRAIN_SEQ))
    if dev.type == "cuda":
        held = {"state": state}

        def profiled():
            held["state"], m = step_fn(held["state"], pipe.next_batch())
            return m
        out["profile"] = device_profile(torch, profiled)
        state = held.pop("state")
    out["max_memory_allocated"] = _peak(torch, dev)

    # ---- 2 steps at 1 x long_len ----
    long_pipe = DP.DataPipeline(DP.SyntheticSource(cfg.vocab_size, long_len),
                                1)
    with CallTap(TA, "swa_attention_blocked") as swa:
        state, l_losses, l_gn, l_ms = _train_steps(
            torch, TR, state, step_fn,
            [long_pipe.next_batch() for _ in range(2)], dev)
    check(all(np.isfinite(l_losses)) and all(np.isfinite(l_gn)),
          f"{where}: at {long_len} tokens loss {l_losses} grad norm {l_gn}")
    n_swa = sum(1 for w in windows if w and long_len > w)
    # remat "full" runs each block's forward again in the backward
    check(swa.calls == 2 * 2 * n_swa, f"{where}: {swa.calls} blocked "
                                      f"window calls in 2 steps, want "
                                      f"{4 * n_swa}")
    out["long"] = dict(tokens=long_len, losses=l_losses, grad_norms=l_gn,
                       step_ms=l_ms, blocked_window_calls=swa.calls,
                       bound=bound(1, long_len),
                       max_memory_allocated=_peak(torch, dev))
    del state, step_fn
    _sync(torch, dev)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out["checkpoint"] = checkpoint_round_trip(torch, TR, DP, CK, small_cfg,
                                              dev, where)
    say("lm_ssm_train", **out)
    return out


def ssd_seq_inputs(torch, SSM, cfg, dev) -> tuple:
    """One mamba2 layer's SSD inputs at full width, 1 x SSM_SEQ_LEN, from
    ``SSM_SEQ_SEED``: x, B, C bf16 as the conv gives them, dt a softplus
    of N(-3, 1) (about 0.005-0.3, mamba2's init range), a = -A with A in
    [1, 16] (its init range), and the output's cotangent (fp32)."""
    gen = torch.Generator(device=dev).manual_seed(SSM_SEQ_SEED)
    S, H, N, P = SSM_SEQ_LEN, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim

    def draw(*shape):
        return torch.randn(shape, generator=gen, device=dev)
    xs = draw(1, S, H, P).to(torch.bfloat16)
    dt = SSM.softplus(draw(1, S, H) - 3.0)
    a = -(1.0 + 15.0 * torch.rand((H,), generator=gen, device=dev))
    B = draw(1, S, N).to(torch.bfloat16)
    C = draw(1, S, N).to(torch.bfloat16)
    return (xs, dt, a, B, C), draw(1, S, H, P)


def rank_ssd_job(ctx, cfg, reps: int) -> dict:
    """The SSD of one mamba2 layer on this rank of a 1 x SSM_SEQ_RANKS
    mesh: its block of the sequence (``moe_a2a.rank_block``), the
    sequence-parallel call and the backward of its share of ``sum(y *
    ct)``, then ``reps`` timed forward calls with the all-gather's bytes
    counted.  Returns its y block, the gradients, the times and bytes."""
    import torch

    from repro_torch.dist import exchange as X
    from repro_torch.dist.sharding import Mesh
    from repro_torch.models import moe_a2a as A2A
    from repro_torch.models import ssm as SSM
    dev = ctx.device
    mesh = Mesh.build({"data": 1, "model": SSM_SEQ_RANKS}, ctx.rank)
    args, ct = ssd_seq_inputs(torch, SSM, cfg, dev)
    local = [(t if t.ndim == 1 else A2A.rank_block(t, mesh)).clone()
             .requires_grad_() for t in args]
    y = SSM._ssd_seq_parallel_call(*local, cfg.ssm_chunk, mesh)
    torch.sum(y.float() * A2A.rank_block(ct, mesh)).backward()
    gathered = {"bytes": 0}
    original = X.all_gather

    def counted(t, group, *a, **kw):
        out = original(t, group, *a, **kw)
        gathered["bytes"] += out.numel() * out.element_size()
        return out
    X.all_gather = counted
    try:
        call_ms = []
        for _ in range(reps):
            gathered["bytes"] = 0
            _sync(torch, dev)
            t0 = time.perf_counter()
            with torch.no_grad():
                SSM._ssd_seq_parallel_call(*local, cfg.ssm_chunk, mesh)
            _sync(torch, dev)
            call_ms.append((time.perf_counter() - t0) * 1e3)
    finally:
        X.all_gather = original
    return {"rank": ctx.rank, "y": y.detach().float().cpu(),
            "grads": [t.grad.float().cpu() for t in local],
            "call_ms": sorted(call_ms)[len(call_ms) // 2],
            "gathered_bytes": gathered["bytes"],
            "max_memory_allocated": _peak(torch, dev)}


def ssd_seq_parallel_phase(np, torch, MS, SH, A2A, SSM, cfg, dev,
                           dist_dir) -> dict:
    """One mamba2 layer's SSD at full width (48 heads of 64, state 128,
    chunk 128) sequence-parallel on SSM_SEQ_RANKS gloo ranks sharing the
    card (1,024 tokens, 8 chunks a rank): each rank's y block and the
    gradients of x, dt, B, C (placed) and a (summed over the ranks)
    against one process's ``ssd_chunked`` over the whole sequence."""
    args, ct = ssd_seq_inputs(torch, SSM, cfg, dev)
    full = [t.clone().requires_grad_() for t in args]
    _sync(torch, dev)
    t0 = time.perf_counter()
    y, _ = SSM.ssd_chunked(*full, cfg.ssm_chunk)
    _sync(torch, dev)
    one_ms = (time.perf_counter() - t0) * 1e3
    torch.sum(y.float() * ct).backward()
    with MS.RankPool(SSM_SEQ_RANKS, backend="gloo", device=dev,
                     init_method=f"file://{dist_dir}/ssd_store",
                     timeout_s=DIST_TIMEOUT_S) as pool:
        got = pool.run(rank_ssd_job, cfg, SSM_SEQ_REPS)
    shape = {"data": 1, "model": SSM_SEQ_RANKS}
    y_ranks = torch.zeros(y.shape)
    grads = [torch.zeros(t.shape) for t in args]
    for r in got:
        mesh = SH.Mesh(shape, r["rank"])
        A2A.rank_block(y_ranks, mesh)[...] = r["y"]
        for g, rg in zip(grads, r["grads"]):
            if g.ndim == 1:
                g += rg
            else:
                A2A.rank_block(g, mesh)[...] = rg

    def rel(a, b):
        return float((a.float().cpu() - b).abs().max() / a.float().abs().max())
    errs = {"y": rel(y.detach(), y_ranks)}
    errs.update({n: rel(t.grad, g) for n, t, g in zip(
        ("x", "dt", "a", "B", "C"), full, grads)})
    check(max(errs.values()) <= SSM_SEQ_TOL,
          f"ssd_seq_parallel: {errs} of max|y| and max|grad| from one "
          f"process's scan")
    out = {"arch": cfg.name, "tokens": SSM_SEQ_LEN, "ranks": SSM_SEQ_RANKS,
           "chunks_a_rank": SSM_SEQ_LEN // SSM_SEQ_RANKS // cfg.ssm_chunk,
           "rel_err": errs, "tol": SSM_SEQ_TOL, "one_process_ms": one_ms,
           "call_ms": [r["call_ms"] for r in got],
           "gathered_bytes_a_rank": [r["gathered_bytes"] for r in got],
           "max_memory_allocated": [r["max_memory_allocated"] for r in got]}
    say("ssd_seq_parallel", **out)
    return out


# ---- MLA and MTP (deepseek-v3) and the encoder-decoder (whisper) ----
def mla_bounds(cfg, tokens: int, pairs: int, weight_bytes: int,
               kv_bytes: int, buffer_rows: int) -> dict:
    """The least time of a deepseek forward over ``tokens`` new tokens
    that attend to ``pairs`` (query, key) pairs a layer and head: the
    weights it reads (and the compressed cache) over the memory rate, or
    its bf16 products over the tensor cores' peak, whichever is larger.
    Products: each layer's MLA projections (q down and up, kv down, k up
    and v up, out) a token; the dense layers' gated MLP; the MoE layers'
    router, shared expert and the experts on the whole ``[E, C]`` buffer
    (``buffer_rows`` rows a layer, empty slots included: what the three
    ``bmm`` compute); QK^T over 192 and PV over 128 a pair and head; the
    head."""
    d, H, L = cfg.d_model, cfg.num_heads, cfg.num_layers
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    r, ql = cfg.kv_lora_rank, cfg.q_lora_rank
    mla = (d * ql + ql * H * (dn + dr) + d * (r + dr) + r * H * (dn + dv)
           + H * dv * d)
    k_dense = cfg.first_k_dense
    ffn = (k_dense * 3 * d * cfg.dense_d_ff
           + (L - k_dense) * (d * cfg.num_experts
                              + 3 * d * cfg.d_ff * cfg.num_shared_experts))
    proj = 2 * tokens * (L * mla + ffn + cfg.vocab_size * d)
    experts = 3 * 2 * buffer_rows * d * cfg.d_ff * (L - k_dense)
    attn = 2 * L * H * (dn + dr + dv) * pairs
    bytes_ms = (weight_bytes + kv_bytes) / H100_BYTES_PER_S * 1e3
    ops_ms = (proj + experts + attn) / H100_BF16_TENSOR_OPS_PER_S * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes_ms": bytes_ms, "ops_ms": ops_ms,
            "tflop": {"projections": proj / 1e12, "experts": experts / 1e12,
                      "attention": attn / 1e12}}


def mtp_leaf_correction(cfg) -> int:
    """The reference's ``param_count`` counts the MTP block's MLP at
    ``d_ff``; its leaves are ``dense_d_ff`` wide."""
    return cfg.mtp_depth * 3 * cfg.d_model * (cfg.dense_d_ff - cfg.d_ff)


def lm_mla_serve_phase(np, torch, T, TA, LY, MOE, SE, cfg, dev,
                       long_len: int, cpu_cfg) -> dict:
    """deepseek-v3 at full width (``cfg``: depth cut to 3 dense and 2 MoE
    layers, the MTP head built but not read) served on ``dev`` with the
    serve launcher's defaults: each request's first token teacher-forced
    against a full forward (gated), its tokens against ``generate`` alone
    and the later tokens' argmax share (reported: decode buckets each
    step's tokens alone, ROADMAP §3), the dropped pairs a decode step;
    the first MoE layer's output (a 2-row decode step, a ``long_len``
    prefill) against the plain per-token fp32 MoE with the same picks and
    keep mask; prefill and decode ms beside their bounds; MLA layer 0's
    absorbed decode against its materialised train path at the same
    positions, and its flash path against dense at ``long_len``; the
    reduced config on the card against the CPU."""
    where = "lm_mla_serve"
    _sync(torch, dev)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    model = T.init_lm(cfg, seed=0, device=dev)
    _sync(torch, dev)
    init_s = time.perf_counter() - t0
    params = list(model.parameters())
    weight_bytes = sum(p.numel() * p.element_size() for p in params)
    mtp_bytes = sum(p.numel() * p.element_size()
                    for p in model.mtp.parameters())
    n_matrix = sum(p.numel() for p in params if p.dtype == torch.bfloat16)
    check(n_matrix == cfg.param_count() + mtp_leaf_correction(cfg),
          f"{where}: {n_matrix} bf16 parameters, param_count() "
          f"{cfg.param_count()}")
    plan = T.build_plan(cfg).stacks
    check([(s.kind, s.n) for s in plan] == [
        ("dense", cfg.first_k_dense), ("moe", cfg.num_layers
                                       - cfg.first_k_dense)]
          and tuple(model.stacks[1][0].moe["w_in"].shape)
          == (cfg.num_experts, cfg.d_model, cfg.d_ff),
          f"{where}: the plan is {plan}")

    def last_logits(tokens):
        logits = T.forward(model, cfg, torch.as_tensor(tokens, device=dev))[0]
        check(bool(torch.isfinite(logits).all()),
              f"{where}: a logit is not finite")
        return logits[:, -1].float().cpu().numpy()

    # ---- the slot server: launch/serve's defaults ----
    rng = np.random.default_rng(0)
    s_max = LM_PROMPT + LM_MAX_NEW + 8
    reqs = [SE.Request(rid, rng.integers(0, cfg.vocab_size, LM_PROMPT)
                       .astype(np.int32), LM_MAX_NEW)
            for rid in range(LM_REQUESTS)]
    warm = SE.SlotServer(model, cfg, num_slots=LM_SLOTS, s_max=s_max)
    warm.submit(reqs[0])
    warm.run()
    server = SE.SlotServer(model, cfg, num_slots=LM_SLOTS, s_max=s_max)
    check(server.caches[0][0].kv.v is None
          and server.caches[0][0].kv.pos.shape == (LM_SLOTS,),
          f"{where}: the slot cache is not the packed per-slot one")
    for r in reqs:
        server.submit(r)
    _sync(torch, dev)
    t0 = time.perf_counter()
    done = server.run()
    _sync(torch, dev)
    serve_s = time.perf_counter() - t0
    served = sum(len(v) for v in done.values())
    check(sorted(done) == list(range(LM_REQUESTS))
          and all(len(v) == LM_MAX_NEW for v in done.values()),
          f"{where}: served {({k: len(v) for k, v in done.items()})}")
    counted = SE.SlotServer(model, cfg, num_slots=LM_SLOTS, s_max=s_max)
    for r in reqs:
        counted.submit(r)
    with MoeTap(torch, MOE) as tap:
        again = counted.run()
    n_moe = cfg.num_layers - cfg.first_k_dense
    decode_steps = sum(1 for s in tap.calls if s[1] == 1) // n_moe
    decode_drops = tap.dropped(decode_only=True)
    same_twice = all(np.array_equal(again[k], v) for k, v in done.items())
    equal, argmax, first = 0, 0, 0
    for r in reqs:
        alone = SE.generate(model, cfg, r.prompt[None], LM_MAX_NEW)[0]
        equal += bool(np.array_equal(alone[LM_PROMPT:], done[r.rid]))
        first += lm_teacher_forced(np, last_logits, r.prompt,
                                   alone[LM_PROMPT:LM_PROMPT + 1],
                                   f"{where} request {r.rid}")
        for t in range(1, LM_MAX_NEW):
            last = last_logits(alone[None, :LM_PROMPT + t])[0]
            argmax += int(last.argmax()) == int(alone[LM_PROMPT + t])
    check(first >= 0.75 * LM_REQUESTS, f"{where}: {first} of "
          f"{LM_REQUESTS} first tokens are the full forward's argmax")

    # ---- step times beside their bounds ----
    prefill = SE.make_prefill_step(cfg)
    decode = SE.make_decode_step(cfg)
    serve_bytes = weight_bytes - mtp_bytes  # serving never reads MTP
    kv_row = cfg.num_layers * (cfg.kv_lora_rank + cfg.qk_rope_head_dim) * 2
    E = cfg.num_experts

    def prefill_ms(n):
        toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, n)),
                               device=dev)

        def run():
            logits, _ = prefill(model, {"tokens": toks},
                                T.init_cache(cfg, 1, n, dev))
            check(bool(torch.isfinite(logits).all()),
                  f"{where}: prefill {n} logits not finite")
        return median_ms(torch, dev, run), mla_bounds(
            cfg, n, n * (n + 1) // 2, serve_bytes, n * kv_row,
            E * MOE.capacity(cfg, n)), toks

    short_ms, short_bound, _ = prefill_ms(LM_PROMPT)
    long_ms, long_bound, long_toks = prefill_ms(long_len)
    with MoeTap(torch, MOE) as tap:
        prefill(model, {"tokens": long_toks}, T.init_cache(cfg, 1, long_len,
                                                           dev))
    long_check = moe_layer_vs_plain(np, torch, MOE, cfg, tap,
                                    f"{where} prefill {long_len}")
    long_check["dropped_pairs_all_layers"] = tap.dropped()
    caches = SE._slot_positions(T.init_cache(cfg, LM_SLOTS, s_max, dev),
                                LM_SLOTS)
    for slot, r in enumerate(reqs[:LM_SLOTS]):
        one = T.init_cache(cfg, 1, s_max, dev)
        _, one = prefill(model, {"tokens": torch.as_tensor(
            r.prompt[None], device=dev)}, one)
        SE._write_slot(caches, one, slot)
    tok = torch.as_tensor(rng.integers(0, cfg.vocab_size, (LM_SLOTS, 1)),
                          device=dev)
    state = {"caches": caches}

    def step():
        logits, state["caches"] = decode(model, tok, state["caches"])
        return logits

    decode_ms = median_ms(torch, dev, step)
    with MoeTap(torch, MOE) as tap:
        check(bool(torch.isfinite(step()).all()),
              f"{where}: decode logits not finite")
    decode_check = moe_layer_vs_plain(np, torch, MOE, cfg, tap,
                                      f"{where} decode")
    reach = int(state["caches"][0][0].kv.pos.max())
    decode_bound = mla_bounds(cfg, LM_SLOTS, LM_SLOTS * reach, serve_bytes,
                              LM_SLOTS * s_max * kv_row,
                              E * MOE.capacity(cfg, LM_SLOTS))
    profiles = {}
    if dev.type == "cuda":
        profiles = {"decode_x3": device_profile(
            torch, lambda: [step() for _ in range(3)]),
            f"prefill_{long_len}": device_profile(
            torch, lambda: prefill(model, {"tokens": long_toks},
                                   T.init_cache(cfg, 1, long_len, dev)))}
    peak = _peak(torch, dev)

    # ---- MLA layer 0 alone: absorbed decode, flash against dense ----
    blk = model.stacks[0][0]
    attn = {k: v.detach().clone() for k, v in blk.attn.items()}
    seq = torch.as_tensor(np.concatenate([reqs[0].prompt, done[0]])[None],
                          device=dev)
    h = LY.rms_norm(T.embed_tokens(model, cfg, seq), blk.norm1,
                    cfg.norm_eps)
    h_long = LY.rms_norm(T.embed_tokens(model, cfg, long_toks), blk.norm1,
                         cfg.norm_eps)
    del model, server, warm, counted, caches, state, blk
    _sync(torch, dev)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    S = seq.shape[1]
    pos = torch.arange(S, device=dev)[None]
    with torch.no_grad():
        full, _ = TA.attention_layer(attn, cfg, h, pos)
        c = TA.init_kv_cache(cfg, 1, S, dev)
        _, c = TA.attention_layer(attn, cfg, h[:, :LM_PROMPT],
                                  pos[:, :LM_PROMPT], cache=c,
                                  mode="prefill")
        steps = []
        for t in range(LM_PROMPT, S):
            o, c = TA.attention_layer(attn, cfg, h[:, t:t + 1],
                                      pos[:, t:t + 1], cache=c,
                                      mode="decode")
            steps.append(o)
        absorbed = torch.cat(steps, dim=1).float()
        ref = full[:, LM_PROMPT:].float()
        absorb_err = float((absorbed - ref).abs().max() / ref.abs().max())
        check(absorb_err <= MLA_ABSORB_TOL,
              f"{where}: layer 0's absorbed decode is {absorb_err} of "
              f"max|y| from its materialised train path")
        lpos = torch.arange(long_len, device=dev)[None]
        check(long_len > TA.FLASH_THRESHOLD, f"{where}: the long prefill "
                                             "does not take the flash path")
        flash, _ = TA.attention_layer(attn, cfg, h_long, lpos)
        threshold, TA.FLASH_THRESHOLD = TA.FLASH_THRESHOLD, long_len
        try:
            dense, _ = TA.attention_layer(attn, cfg, h_long, lpos)
        finally:
            TA.FLASH_THRESHOLD = threshold
        flash_err = float((flash.float() - dense.float()).abs().max()
                          / dense.float().abs().max())
    check(flash_err <= LM_FLASH_TOL, f"{where}: flash MLA at {long_len} "
                                     f"tokens is {flash_err} of max|out| "
                                     f"from the dense path")
    del attn, h, h_long, full, dense, flash, long_toks
    _sync(torch, dev)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out = dict(arch=cfg.name, layers=cfg.num_layers,
               first_k_dense=cfg.first_k_dense, mtp_depth=cfg.mtp_depth,
               bf16_parameters=n_matrix, weight_bytes=weight_bytes,
               mtp_bytes=mtp_bytes, init_s=init_s, requests=LM_REQUESTS,
               slots=LM_SLOTS, prompt=LM_PROMPT, max_new=LM_MAX_NEW,
               served_tokens=served, serve_s=serve_s,
               tokens_per_s=served / serve_s,
               same_tokens_served_twice=same_twice,
               decode_steps=decode_steps, decode_dropped_pairs=decode_drops,
               dropped_pairs_per_decode_step=decode_drops / decode_steps,
               equal_to_generate_alone=equal, first_token_argmax=first,
               later_tokens_argmax_share=argmax / (LM_REQUESTS
                                                   * (LM_MAX_NEW - 1)),
               prefill_ms={LM_PROMPT: short_ms, long_len: long_ms},
               prefill_bound={LM_PROMPT: short_bound, long_len: long_bound},
               decode_ms=decode_ms, decode_bound=decode_bound,
               first_moe_layer_vs_plain={"decode": decode_check,
                                         f"prefill_{long_len}": long_check},
               absorbed_vs_materialised=absorb_err,
               absorbed_tol=MLA_ABSORB_TOL, flash_vs_dense=flash_err,
               flash_tol=LM_FLASH_TOL, profiles=profiles or "not measured",
               max_memory_allocated=peak)

    # ---- the reduced config on the card against the CPU ----
    host = T.init_lm(cpu_cfg, seed=0, device="cpu")
    card = copy.deepcopy(host).to(dev)
    toks = rng.integers(0, cpu_cfg.vocab_size, (2, LM_PROMPT))
    lc = T.forward(host, cpu_cfg, torch.as_tensor(toks))[0].float()
    lg = T.forward(card, cpu_cfg, torch.as_tensor(toks, device=dev)
                   )[0].float().cpu()
    per = (lg - lc).abs().amax(-1) / lc.abs().max()
    share = float((per <= LM_CARD_TOL).float().mean())
    out["card_vs_cpu"] = {"share_within": share, "tol": LM_CARD_TOL,
                          "min_share": MOE_CARD_SHARE,
                          "max_rel": float(per.max())}
    check(share >= MOE_CARD_SHARE and float(per.max()) <= 1.0,
          f"{where}: {cpu_cfg.name} on the card against the CPU: "
          f"{out['card_vs_cpu']}")
    say(where, **out)
    return out


def _mla_train_run(np, torch, TR, OPT, DP, cfg, dev, lr: float):
    """``LM_TRAIN_STEPS`` steps of ``cfg`` from seed 0 at ``lr`` (warmed up
    over 1 of them, cosine after): (state, step_fn, pipe, losses, mtp
    terms, auxes, grad norms, ms a step)."""
    state = TR.init_state(cfg, seed=0, device=dev)
    schedule = OPT.cosine_schedule(lr, warmup=max(LM_TRAIN_STEPS // 10, 1),
                                   total=LM_TRAIN_STEPS)
    step_fn = TR.make_train_step(cfg, schedule=schedule)
    pipe = DP.DataPipeline(DP.SyntheticSource(cfg.vocab_size, LM_TRAIN_SEQ),
                           LM_TRAIN_BATCH)
    losses, mtps, auxes, gnorms, ms = [], [], [], [], []
    for _ in range(LM_TRAIN_STEPS):
        _sync(torch, dev)
        t0 = time.perf_counter()
        state, m = step_fn(state, pipe.next_batch())
        losses.append(float(m["loss"]))
        _sync(torch, dev)
        ms.append((time.perf_counter() - t0) * 1e3)
        mtps.append(float(m["mtp"]))
        auxes.append(float(m["aux"]))
        gnorms.append(float(m["grad_norm"]))
    return state, step_fn, pipe, losses, mtps, auxes, gnorms, ms


def lm_mla_train_phase(np, torch, T, TA, TR, OPT, DP, CK, cfg, dev,
                       long_len: int, small_cfg) -> dict:
    """deepseek-v3 at full width (``cfg``: 3 dense and 1 MoE layer plus
    the MTP head) trained on ``dev`` as ``python -m
    repro_torch.launch.train --arch deepseek-v3-671b --layers 4`` trains
    it (the config's Adafactor, remat "full", batch 8 x seq 128, warmed
    up over 1 of 10 steps): at the launcher's lr ``LM_TRAIN_LR`` (every
    loss finite, reported: the recipe is unstable at this width, in both
    packages, ROADMAP §3), then from the same weights at ``MLA_TRAIN_LR``
    (``--lr``; every loss, ``mtp`` and grad norm finite, the mean loss of
    the last 3 below the first), 2 steps at 1 x ``long_len`` (the flash
    backward with q and k 192 wide, v 128, counted), and a checkpoint
    round trip of ``small_cfg``."""
    where = "lm_mla_train"
    out = {"arch": cfg.name, "layers": cfg.num_layers,
           "first_k_dense": cfg.first_k_dense, "mtp_depth": cfg.mtp_depth,
           "remat": cfg.remat, "optimizer": cfg.optimizer}
    _sync(torch, dev)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    state, _, _, losses, mtps, auxes, gnorms, _ = _mla_train_run(
        np, torch, TR, OPT, DP, cfg, dev, LM_TRAIN_LR)
    check(all(np.isfinite(losses + mtps + auxes + gnorms)),
          f"{where} at lr {LM_TRAIN_LR}: loss {losses} mtp {mtps} aux "
          f"{auxes} grad norm {gnorms}")
    out["launcher_lr"] = {"lr": LM_TRAIN_LR, "losses": losses, "mtp": mtps,
                          "grad_norms": gnorms,
                          "last_3_below_first": bool(
                              np.mean(losses[-3:]) < losses[0])}
    del state
    _sync(torch, dev)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    state, step_fn, pipe, losses, mtps, auxes, gnorms, ms = _mla_train_run(
        np, torch, TR, OPT, DP, cfg, dev, MLA_TRAIN_LR)
    out["runs_s"] = time.perf_counter() - t0
    params = list(state.params.parameters())
    n_params = sum(p.numel() for p in params)
    weight_bytes = sum(p.numel() * p.element_size() for p in params)
    moments = sum(t.numel() * t.element_size()
                  for f in ("vr", "vc", "v")
                  for t in getattr(state.opt_state, f).values())
    # the reckoning: bf16 weights, bf16 gradients (the step's), the
    # factored moments, one piece's fp32 temporaries
    out["reckoning_bytes"] = {
        "weights": weight_bytes, "gradients": weight_bytes,
        "moments": moments, "optimizer_piece_fp32": 4 * 4 * OPT.PIECE}
    out["lr"] = MLA_TRAIN_LR
    check(all(np.isfinite(losses + mtps + auxes + gnorms)),
          f"{where}: loss {losses} mtp {mtps} aux {auxes} grad norm {gnorms}")
    check(np.mean(losses[-3:]) < losses[0],
          f"{where}: the mean loss of the last 3 steps is not below the "
          f"first step's: loss {losses} mtp {mtps} grad norm {gnorms}")
    n_mla = cfg.num_layers + cfg.mtp_depth
    moe_layers = cfg.num_layers - cfg.first_k_dense
    idle = moe_layers * (cfg.num_experts - cfg.experts_per_token
                         ) * 3 * cfg.d_model * cfg.d_ff
    active = sum(p.numel() for p in params if p.dtype == torch.bfloat16
                 ) - idle

    def bound(rows, seq):
        """8 x the active bf16 parameters x tokens (forward, backward 2x,
        remat's second forward) plus causal MLA attention (QK^T over 192,
        PV over 128) four times, then ``LM_ADAFACTOR_BYTES`` a parameter
        of clip and Adafactor traffic."""
        attn = 4 * 2 * n_mla * cfg.num_heads * (
            cfg.qk_nope_head_dim + cfg.qk_rope_head_dim + cfg.v_head_dim
        ) * rows * seq * (seq + 1) // 2
        ops = 8 * active * rows * seq + attn
        ops_ms = ops / H100_BF16_TENSOR_OPS_PER_S * 1e3
        bytes_ms = LM_ADAFACTOR_BYTES * n_params / H100_BYTES_PER_S * 1e3
        return {"bound_ms": ops_ms + bytes_ms, "ops_ms": ops_ms,
                "bytes_ms": bytes_ms, "tflop": ops / 1e12,
                "active_parameters": active}
    tokens = LM_TRAIN_BATCH * LM_TRAIN_SEQ
    steady = sorted(ms[1:])[len(ms[1:]) // 2]
    out.update(parameters=n_params, batch=LM_TRAIN_BATCH, seq=LM_TRAIN_SEQ,
               steps=LM_TRAIN_STEPS, losses=losses, mtp=mtps, auxes=auxes,
               grad_norms=gnorms, step_ms=ms, step_ms_median=steady,
               tokens_per_s=tokens / steady * 1e3,
               bound=bound(LM_TRAIN_BATCH, LM_TRAIN_SEQ))
    if dev.type == "cuda":
        held = {"state": state}

        def profiled():
            held["state"], m = step_fn(held["state"], pipe.next_batch())
            return m
        out["profile"] = device_profile(torch, profiled)
        state = held.pop("state")
    out["max_memory_allocated"] = _peak(torch, dev)

    # ---- 2 steps at 1 x long_len: the flash backward, dv != hd ----
    long_pipe = DP.DataPipeline(DP.SyntheticSource(cfg.vocab_size, long_len),
                                1)
    with CallTap(TA, "_flash_bwd") as fb:
        state, l_losses, l_gn, l_ms = _train_steps(
            torch, TR, state, step_fn,
            [long_pipe.next_batch() for _ in range(2)], dev)
    check(all(np.isfinite(l_losses)) and all(np.isfinite(l_gn)),
          f"{where}: at {long_len} tokens loss {l_losses} grad norm {l_gn}")
    check(fb.calls == 2 * n_mla, f"{where}: {fb.calls} flash backward "
                                 f"calls in 2 steps, want {2 * n_mla}")
    # _flash_bwd(causal, q_offset, chunk, (q, k, v, out, lse), dout)
    q, _, v = fb.first[0][3][:3]
    q_shape = tuple(q.shape)
    check(q_shape[-1] == cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
          and v.shape[-1] == cfg.v_head_dim,
          f"{where}: the flash backward saw q {q_shape}")
    out["long"] = dict(tokens=long_len, losses=l_losses, grad_norms=l_gn,
                       step_ms=l_ms, flash_backward_calls=fb.calls,
                       bound=bound(1, long_len),
                       max_memory_allocated=_peak(torch, dev))
    del state, step_fn
    _sync(torch, dev)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out["checkpoint"] = checkpoint_round_trip(torch, TR, DP, CK, small_cfg,
                                              dev, where)
    say(where, **out)
    return out


def encdec_bounds(cfg, rows: int, enc: bool, dec_tokens: int, pairs: int,
                  weight_bytes: int, cache_bytes: int) -> dict:
    """The least time of whisper's ``rows`` encoder passes (``enc``) and
    decoder over ``dec_tokens`` tokens a row attending to ``pairs`` self
    pairs a layer and head: its weights and the caches it reads over the
    memory rate, or its bf16 products over the tensor cores' peak.
    Products: the encoder's 4 d^2 + 2 d F a frame and layer and its full
    S_e^2 attention; the decoder's self and cross projections (the cross
    K/V over the frames when ``enc``), its MLP, cross attention over the
    frames and the tied head."""
    d, F, L, Le = cfg.d_model, cfg.d_ff, cfg.num_layers, cfg.enc_layers
    Se, hd, H = cfg.enc_seq, cfg.head_dim, cfg.num_heads
    ops = 0
    if enc:
        ops += 2 * rows * Se * Le * (4 * d * d + 2 * d * F)
        ops += 2 * 2 * rows * Le * H * hd * Se * Se
        ops += 2 * rows * Se * L * 2 * d * d  # cross K/V
    t = rows * dec_tokens
    ops += 2 * t * (L * (6 * d * d + 2 * d * F) + cfg.vocab_size * d)
    ops += 2 * 2 * rows * L * H * hd * (pairs + dec_tokens * Se)
    bytes_ms = (weight_bytes + cache_bytes) / H100_BYTES_PER_S * 1e3
    ops_ms = ops / H100_BF16_TENSOR_OPS_PER_S * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes_ms": bytes_ms, "ops_ms": ops_ms, "tflop": ops / 1e12}


def encdec_features(torch, cfg, rows: int, seed: int, dev):
    """Frame features [rows, enc_seq, d] bf16 from a seeded generator (the
    stub frontend's output)."""
    gen = torch.Generator(device=dev if dev.type == "cuda" else "cpu")
    gen.manual_seed(seed)
    return torch.randn((rows, cfg.enc_seq, cfg.d_model), generator=gen,
                       device=dev).to(torch.bfloat16)


def lm_encdec_serve_phase(np, torch, ED, SE, cfg, dev, cpu_cfg) -> dict:
    """whisper-medium at full width and depth (24 + 24 layers) served on
    ``dev``: ``generate`` with features [2, enc_seq, d] and prompts of
    ``LM_PROMPT`` tokens, ``LM_MAX_NEW`` new: every served token the
    teacher-forced ``decode_stack``'s argmax over the whole sequence or
    within ``LM_GAP`` of it (>= 75% the argmax); the encoder, prefill and
    decode ms beside their bounds; the reduced config on the card against
    the CPU."""
    where = "lm_encdec_serve"
    _sync(torch, dev)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    model = ED.init_encdec(cfg, seed=0, device=dev)
    _sync(torch, dev)
    init_s = time.perf_counter() - t0
    params = list(model.parameters())
    weight_bytes = sum(p.numel() * p.element_size() for p in params)
    rows = LM_SLOTS
    rng = np.random.default_rng(0)
    feats = encdec_features(torch, cfg, rows, 0, dev)
    prompt = rng.integers(0, cfg.vocab_size, (rows, LM_PROMPT)
                          ).astype(np.int32)
    SE.generate(model, cfg, prompt, 2, features=feats)  # warm-up
    _sync(torch, dev)
    t0 = time.perf_counter()
    out_tok = SE.generate(model, cfg, prompt, LM_MAX_NEW, features=feats)
    _sync(torch, dev)
    gen_s = time.perf_counter() - t0
    check(out_tok.shape == (rows, LM_PROMPT + LM_MAX_NEW),
          f"{where}: generate gave {out_tok.shape}")
    with torch.no_grad():
        enc = ED.encode(model, cfg, feats, mode="prefill")
        seq = torch.as_tensor(out_tok[:, :-1], device=dev)
        n = seq.shape[1]
        logits = ED.decode_stack(
            model, cfg, seq, torch.arange(n, device=dev)[None].expand(rows, n),
            enc, None, "prefill")[0].float()
    check(bool(torch.isfinite(logits).all()), f"{where}: a teacher-forced "
                                              "logit is not finite")
    logits = logits[:, LM_PROMPT - 1:].cpu().numpy()
    argmax = 0
    for r in range(rows):
        for t in range(LM_MAX_NEW):
            got = int(out_tok[r, LM_PROMPT + t])
            best = int(logits[r, t].argmax())
            if got == best:
                argmax += 1
            else:
                gap = float(logits[r, t, best] - logits[r, t, got])
                check(gap < LM_GAP, f"{where}: row {r} token {t} is {got}, "
                                    f"the argmax {best} is {gap} above it")
    check(argmax >= 0.75 * rows * LM_MAX_NEW,
          f"{where}: {argmax} served tokens are the argmax")

    # ---- times beside their bounds ----
    s_max = LM_PROMPT + LM_MAX_NEW
    prefill = SE.make_prefill_step(cfg)
    decode = SE.make_decode_step(cfg)
    toks = torch.as_tensor(prompt, device=dev)
    enc_bytes = sum(p.numel() * p.element_size()
                    for p in model.encoder.parameters())
    cross_bytes = 2 * cfg.num_layers * rows * cfg.enc_seq * cfg.d_model * 2
    encoder_ms = median_ms(torch, dev, lambda: ED.encode(
        model, cfg, feats, mode="prefill"))
    holder = {}

    def run_prefill():
        holder["caches"] = prefill(model, {"tokens": toks, "features": feats},
                                   ED.init_dec_cache(cfg, rows, s_max, dev))[1]
    prefill_ms = median_ms(torch, dev, run_prefill)
    tok = torch.as_tensor(out_tok[:, LM_PROMPT:LM_PROMPT + 1], device=dev)

    def step():
        logits, holder["caches"] = decode(model, tok, holder["caches"])
        return logits
    run_prefill()  # then 1 + reps steps fit the cache's LM_MAX_NEW
    decode_ms = median_ms(torch, dev, step, reps=LM_MAX_NEW - 2)
    self_kv = 2 * cfg.num_layers * rows * s_max * cfg.d_model * 2
    dec_bytes = weight_bytes - enc_bytes - model.dec_pos.numel() * 2
    bounds = {
        "encoder": encdec_bounds(cfg, rows, True, 0, 0, enc_bytes, 0),
        "prefill": encdec_bounds(cfg, rows, True, LM_PROMPT,
                                 LM_PROMPT * (LM_PROMPT + 1) // 2,
                                 weight_bytes - model.dec_pos.numel() * 2,
                                 cross_bytes),
        "decode": encdec_bounds(cfg, rows, False, 1, s_max, dec_bytes,
                                cross_bytes + self_kv)}
    profiles = {}
    if dev.type == "cuda":  # (the prefill leaves a fresh cache to decode)
        profiles["prefill"] = device_profile(torch, run_prefill)
        profiles["decode_x3"] = device_profile(
            torch, lambda: [step() for _ in range(3)])
    out = dict(arch=cfg.name, enc_layers=cfg.enc_layers,
               dec_layers=cfg.num_layers, enc_seq=cfg.enc_seq,
               weight_bytes=weight_bytes, init_s=init_s, rows=rows,
               prompt=LM_PROMPT, max_new=LM_MAX_NEW, generate_s=gen_s,
               tokens_per_s=rows * LM_MAX_NEW / gen_s,
               argmax_share=argmax / (rows * LM_MAX_NEW),
               encoder_ms=encoder_ms, prefill_ms=prefill_ms,
               decode_ms=decode_ms, bounds=bounds,
               profiles=profiles or "not measured",
               max_memory_allocated=_peak(torch, dev))
    del model, holder, enc, feats
    _sync(torch, dev)
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # ---- the reduced config on the card against the CPU ----
    host = ED.init_encdec(cpu_cfg, seed=0, device="cpu")
    card = copy.deepcopy(host).to(dev)
    f = encdec_features(torch, cpu_cfg, 2, 1, torch.device("cpu"))
    t = torch.as_tensor(rng.integers(0, cpu_cfg.vocab_size, (2, LM_PROMPT)))
    pos = torch.arange(LM_PROMPT)[None].expand(2, LM_PROMPT)
    with torch.no_grad():
        lc = ED.decode_stack(host, cpu_cfg, t, pos,
                             ED.encode(host, cpu_cfg, f), None,
                             "prefill")[0].float()
        lg = ED.decode_stack(card, cpu_cfg, t.to(dev), pos.to(dev),
                             ED.encode(card, cpu_cfg, f.to(dev)), None,
                             "prefill")[0].float().cpu()
    out["card_vs_cpu"] = float((lg - lc).abs().max() / lc.abs().max())
    out["card_vs_cpu_tol"] = LM_CARD_TOL
    check(out["card_vs_cpu"] <= LM_CARD_TOL,
          f"{where}: {cpu_cfg.name} on the card is {out['card_vs_cpu']} of "
          f"max|logit| from the CPU")
    say(where, **out)
    return out


def lm_encdec_train_phase(np, torch, TR, OPT, DP, CK, TRL, cfg, dev,
                          small_cfg) -> dict:
    """whisper-medium at full width and depth trained on ``dev`` as
    ``python -m repro_torch.launch.train --arch whisper-medium`` trains
    it (AdamW, remat "full" a layer, batch 8 x seq 128, each step's
    1,500 frame features from ``launch.train.step_features``, lr 3e-4
    warmed up over 1 of 10 steps), then a checkpoint round trip of
    ``small_cfg``."""
    where = "lm_encdec_train"
    out = {"arch": cfg.name, "enc_layers": cfg.enc_layers,
           "dec_layers": cfg.num_layers, "remat": cfg.remat,
           "optimizer": cfg.optimizer}
    _sync(torch, dev)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    state = TR.init_state(cfg, seed=0, device=dev)
    _sync(torch, dev)
    out["init_s"] = time.perf_counter() - t0
    n_params = sum(p.numel() for p in state.params.parameters())
    schedule = OPT.cosine_schedule(LM_TRAIN_LR,
                                   warmup=max(LM_TRAIN_STEPS // 10, 1),
                                   total=LM_TRAIN_STEPS)
    step_fn = TR.make_train_step(cfg, schedule=schedule)
    pipe = DP.DataPipeline(DP.SyntheticSource(cfg.vocab_size, LM_TRAIN_SEQ),
                           LM_TRAIN_BATCH)

    def batch(i):
        b = pipe.next_batch()
        b["features"] = TRL.step_features(cfg, i, LM_TRAIN_BATCH, dev)
        return b
    state, losses, gnorms, ms = _train_steps(
        torch, TR, state, step_fn, [batch(i) for i in range(LM_TRAIN_STEPS)],
        dev)
    check(all(np.isfinite(losses)) and all(np.isfinite(gnorms)),
          f"{where}: loss {losses} grad norm {gnorms}")
    check(np.mean(losses[-3:]) < losses[0],
          f"{where}: the mean loss of the last 3 steps {losses[-3:]} is not "
          f"below the first step's {losses[0]}")
    fwd = encdec_bounds(cfg, LM_TRAIN_BATCH, True, LM_TRAIN_SEQ,
                        LM_TRAIN_SEQ * (LM_TRAIN_SEQ + 1) // 2, 0, 0)
    ops_ms = 4 * fwd["ops_ms"]  # forward, backward 2x, remat's forward
    bytes_ms = LM_TRAIN_OPT_BYTES * n_params / H100_BYTES_PER_S * 1e3
    steady = sorted(ms[1:])[len(ms[1:]) // 2]
    out.update(parameters=n_params, batch=LM_TRAIN_BATCH, seq=LM_TRAIN_SEQ,
               frames=cfg.enc_seq, steps=LM_TRAIN_STEPS, losses=losses,
               grad_norms=gnorms, step_ms=ms, step_ms_median=steady,
               tokens_per_s=LM_TRAIN_BATCH * LM_TRAIN_SEQ / steady * 1e3,
               bound={"bound_ms": ops_ms + bytes_ms, "ops_ms": ops_ms,
                      "bytes_ms": bytes_ms, "tflop": 4 * fwd["tflop"]})
    if dev.type == "cuda":
        held = {"state": state}

        def profiled():
            held["state"], m = step_fn(held["state"],
                                       batch(LM_TRAIN_STEPS))
            return m
        out["profile"] = device_profile(torch, profiled)
        state = held.pop("state")
    out["max_memory_allocated"] = _peak(torch, dev)
    del state, step_fn
    _sync(torch, dev)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out["checkpoint"] = checkpoint_round_trip(
        torch, TR, DP, CK, small_cfg, dev, where,
        features=lambda i, rows: TRL.step_features(small_cfg, i, rows, dev))
    say(where, **out)
    return out


# dryrun: the grid runs one shape per arch (``DRYRUN_SHAPE``: every shape
# of every arch takes minutes of host time, the train row alone over a
# minute, and the CLI's --all runs them all),
# the cell of the per-rank bytes, then the engine tick's two production
# cells
DRYRUN_SHAPE = "decode_32k"
DRYRUN_GRAPHS = ("asymp_cc_prod", "asymp_cc_crowded_prod")
# the per-rank bytes: rank 0's block of this cell's inputs on the card
DRYRUN_BYTES_CELL = ("qwen3-4b", "train_4k")
ALLOC_GRANULE = 512  # the caching allocator rounds each block up to this
# one layer a family on the card beside its probe: (family, arch, kind);
# kind None is whisper's decoder layer (self + cross attention)
DRYRUN_LAYERS = (("dense", "qwen3-4b", "dense"),
                 ("moe", "phi3.5-moe-42b-a6.6b", "moe"),
                 ("ssm", "mamba2-780m", "ssm"),
                 ("hybrid", "hymba-1.5b", "hybrid"),
                 ("mla_dense", "deepseek-v3-671b", "dense"),
                 ("mla_moe", "deepseek-v3-671b", "moe"),
                 ("whisper_dec", "whisper-medium", None))
DRYRUN_TRAIN = (8, 128)  # the LM phases' train batch x seq
DRYRUN_DECODE = (2, 512)  # 2 slots, a cache of 512 positions


def dryrun_grid(DR, list_archs, out_dir: str) -> list:
    """``lower_cell`` for every arch at ``DRYRUN_SHAPE`` and for
    ``DRYRUN_BYTES_CELL`` on the 16 x 16 mesh (records into the fresh
    ``out_dir``, so no cached record stands in for a run), and the two
    engine-tick cells; one line a cell, any ``FAIL`` fails the phase."""
    cells = [(a, DRYRUN_SHAPE) for a in list_archs()] + [DRYRUN_BYTES_CELL]
    records = DR.run_cells(cells, False, out_dir)
    records += [DR.lower_graph_cell(g, False) for g in DRYRUN_GRAPHS]
    for r in records:
        check(r["status"] in ("ok", "skip(full-attn)"),
              f"dryrun {r['arch']} {r['shape']}: {r['status']}")
        rf = r.get("roofline", {})
        say("dryrun_cell", arch=r["arch"], shape=r["shape"],
            status=r["status"],
            argument_gb_a_rank=r.get("memory", {}).get("argument_bytes", 0)
            / 1e9,
            compute_ms=None if rf.get("compute_s") is None
            else rf["compute_s"] * 1e3,
            memory_ms=None if rf.get("memory_s") is None
            else rf["memory_s"] * 1e3,
            collective_ms=None if rf.get("collective_s") is None
            else rf["collective_s"] * 1e3,
            dominant=rf.get("dominant"),
            useful_ratio=r.get("useful_flops_ratio"),
            lower_s=r.get("lower_s"), probe_s=r.get("probe_s"))
    return records


def dryrun_bytes_on_card(torch, DR, get_config, SHAPES, dev,
                         records: list) -> dict:
    """Rank 0's block of every input of ``DRYRUN_BYTES_CELL`` allocated on
    the card: the rise of ``memory_allocated`` equals the blocks' bytes,
    each rounded up to ``ALLOC_GRANULE``, and their sum is the record's
    ``argument_bytes``."""
    arch, shape_name = DRYRUN_BYTES_CELL
    cfg, shape = get_config(arch), SHAPES[shape_name]
    mesh = DR.make_production_mesh()
    ci = DR.cell_inputs(cfg, shape, mesh, DR.rules_for(cfg, mesh))
    want = sum(DR.rank_bytes(t, sh) for t, sh in ci.trees)
    rec = next(r for r in records
               if (r["arch"], r["shape"]) == DRYRUN_BYTES_CELL)
    check(want == rec["memory"]["argument_bytes"],
          f"dryrun bytes: {want} != the record's "
          f"{rec['memory']['argument_bytes']}")
    # expandable segments split a cached segment for every request, so
    # each block is its request rounded to the granule (a fixed segment
    # keeps a remainder of 1 MB or less inside the block it hands out)
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    torch.cuda.memory._set_allocator_settings("expandable_segments:True")
    try:
        before = torch.cuda.memory_allocated(dev)
        blocks = DR.rank_blocks(ci.trees, dev)
        rise = torch.cuda.memory_allocated(dev) - before
    finally:
        torch.cuda.memory._set_allocator_settings("expandable_segments:False")
    nbytes = [t.numel() * t.element_size() for t in blocks]
    granular = sum(-(-n // ALLOC_GRANULE) * ALLOC_GRANULE for n in nbytes)
    check(sum(nbytes) == want, f"dryrun bytes: blocks {sum(nbytes)} != "
          f"{want}")
    check(rise == granular, f"dryrun bytes: memory_allocated rose {rise}, "
          f"the blocks rounded to {ALLOC_GRANULE} B are {granular}")
    state = DR.rank_bytes(*ci.trees[ci.donated])
    out = {"cell": f"{arch} {shape_name}", "leaves": len(blocks),
           "argument_bytes": want, "state_bytes": state,
           "allocated_rise": rise}
    del blocks
    return out


def dryrun_layer(torch, T, ED, PR, RA, cfg, kind, dev) -> list:
    """One layer of ``kind`` (``None``: whisper's decoder layer) at full
    width on the card, fwd+bwd at ``DRYRUN_TRAIN`` and a decode step at
    ``DRYRUN_DECODE`` (CUDA events, the mean of 5), each beside the same
    call's count on meta (``roofline/probes.py``) on the card's peaks."""
    B, S = DRYRUN_TRAIN
    Bd, Sd = DRYRUN_DECODE
    D = cfg.d_model
    window = cfg.sliding_window if kind == "hybrid" else 0
    d_ff = (cfg.dense_d_ff or cfg.d_ff) if kind == "dense" else cfg.d_ff
    gen = torch.Generator(device=dev)
    if kind is None:
        pl = ED._init_dec_layer(gen.manual_seed(0), cfg, dev)
        params = [t for d in pl.values()
                  for t in (d.values() if isinstance(d, dict) else (d,))]
        enc = torch.randn((B, cfg.enc_seq, D), generator=gen, device=dev,
                          dtype=torch.bfloat16)

        def train_call(x):
            out, _ = ED._dec_layer(pl, cfg, x, positions, enc, None, "train")
            return out.float().sum()

        probe = PR._probe_dec_layer_train(cfg, B, S)
        hd = cfg.head_dim
        kv = T.attn_mod.init_kv_cache(cfg, Bd, Sd, dev)
        cross = torch.zeros((Bd, cfg.enc_seq, cfg.num_kv_heads, hd),
                            dtype=torch.bfloat16, device=dev)
        cache = ED.DecLayerCache(kv, cross, cross.clone())

        def decode_call(x):
            return ED._dec_layer(pl, cfg, x, dpos, None, cache, "decode")

        meta = ED.DecLayerCache(
            T.attn_mod.init_kv_cache(cfg, Bd, Sd, "meta"),
            cross.to("meta"), cross.to("meta"))
        with torch.no_grad(), PR.CostMode() as m:
            ED._dec_layer({k: ({kk: vv.to("meta") for kk, vv in v.items()}
                               if isinstance(v, dict) else v.to("meta"))
                           for k, v in pl.items()}, cfg,
                          torch.empty((Bd, 1, D), dtype=torch.bfloat16,
                                      device="meta"),
                          torch.zeros((Bd, 1), dtype=torch.long,
                                      device="meta"), None, meta, "decode")
        dprobe = m.cost()
    else:
        blk = T.init_block(cfg, kind, d_ff, seed=0, device=dev)
        params = list(blk.parameters())

        def train_call(x):
            out, _, aux = T.apply_block(blk, cfg, x, positions, "train",
                                        T.LayerCache(None, None), window)
            return out.float().sum() + aux

        probe = PR.probe_train_layer(cfg, B, S, kind, window, d_ff)
        cache = T.init_layer_cache(cfg, kind, Bd, Sd, window, dev)

        def decode_call(x):
            return T.apply_block(blk, cfg, x, dpos, "decode", cache, window)

        dprobe = PR.probe_serve_layer(cfg, Bd, Sd, kind, window, d_ff, 1)
    for t in params:
        t.requires_grad_(True)
    positions = torch.arange(S, device=dev)[None].expand(B, S)
    dpos = torch.zeros((Bd, 1), dtype=torch.long, device=dev)
    x = torch.randn((B, S, D), generator=gen, device=dev,
                    dtype=torch.bfloat16).requires_grad_(True)
    xd = torch.randn((Bd, 1, D), generator=gen, device=dev,
                     dtype=torch.bfloat16)

    def train_step():
        for t in params + [x]:
            t.grad = None
        train_call(x).backward()

    def decode_step():
        with torch.no_grad():
            decode_call(xd)

    out = []
    for mode, fn, c in (("train", train_step, probe),
                        ("decode", decode_step, dprobe)):
        ms = cuda_ms(torch, fn, reps=5)
        roof = RA.analyze({"flops": c["flops"], "bytes": c["bytes"],
                           "collectives": None})
        bound = max(roof.compute_s, roof.memory_s) * 1e3
        out.append({"mode": mode, "ms": ms,
                    "compute_ms": roof.compute_s * 1e3,
                    "memory_ms": roof.memory_s * 1e3, "bound_ms": bound,
                    "measured_over_bound": ms / bound,
                    "product_share": c["product_flops"] / c["flops"]})
    del params, x
    return out


def dryrun_phase(torch, T, ED, DR, PR, RA, get_config, list_archs, SHAPES,
                 dev) -> dict:
    """Phase ``dryrun``: the grid, the per-rank bytes on the card, one
    layer a family timed beside its probe."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as out_dir:
        records = dryrun_grid(DR, list_archs, out_dir)
    grid_s = time.perf_counter() - t0
    say("dryrun_bytes", **dryrun_bytes_on_card(torch, DR, get_config,
                                               SHAPES, dev, records))
    t0 = time.perf_counter()
    for family, arch, kind in DRYRUN_LAYERS:
        cfg = get_config(arch)
        for row in dryrun_layer(torch, T, ED, PR, RA, cfg, kind, dev):
            check(row["ms"] > 0 and row["bound_ms"] > 0,
                  f"dryrun layer {family}: {row}")
            say("dryrun_layer", family=family, arch=arch, **row)
        torch.cuda.empty_cache()
    return {"grid_s": grid_s, "layers_s": time.perf_counter() - t0}


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("[chip_smoke] FAIL: torch.cuda.is_available() is False: "
              "this script runs the port on a CUDA card", flush=True)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    try:
        from repro_torch.configs import (SHAPES, get_config,
                                         get_graph_config, list_archs)
        from repro_torch.configs.base import GraphConfig
        from repro_torch.core import engine as E
        from repro_torch.core import faults as F
        from repro_torch.core import graph as G
        from repro_torch.core import merger as M
        from repro_torch.core.programs import get_program
        from repro_torch.core.semiring import AGGREGATORS
        from repro_torch.dist import exchange as X
        from repro_torch.dist import latency as L
        from repro_torch.dist import sharding as SH
        from repro_torch.ft import checkpoint as CK
        from repro_torch.ft import elastic as EL
        from repro_torch.kernels import _build, ops
        from repro_torch.kernels import receive as RK
        from repro_torch.kernels import ref as R
        from repro_torch.kernels import semiring_spmv as K
        from repro_torch.launch import dryrun as DR
        from repro_torch.launch import mesh as MS
        from repro_torch.launch import train as TRL
        from repro_torch.models import attention as TA
        from repro_torch.models import encdec as ED
        from repro_torch.models import layers as LY
        from repro_torch.models import moe as MOE
        from repro_torch.models import moe_a2a as A2A
        from repro_torch.models import ssm as SSM
        from repro_torch.models import transformer as T
        from repro_torch.roofline import analysis as RA
        from repro_torch.roofline import probes as PR
        from repro_torch.serve import engine as SE
        from repro_torch.serve import graph as SG
        from repro_torch.data import pipeline as DP
        from repro_torch.train import optimizer as OPT
        from repro_torch.train import trainer as TR
    except ImportError as e:
        print(f"[chip_smoke] FAIL: the port is not beside this script "
              f"({e})", flush=True)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    phase_s = {}
    t_phase = time.perf_counter()
    # ---- 1. environment ----
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0].strip()
    kind = torch.cuda.get_device_name(0)
    say("environment", torch=torch.__version__, cuda=torch.version.cuda,
        device=kind, count=torch.cuda.device_count(), nvidia_smi=smi)

    # ---- 2. build ----
    built = _build.build("semiring_spmv")
    _build.load("semiring_spmv")
    say("build", seconds=round(built["seconds"], 3), cached=built["cached"],
        library=os.path.relpath(built["path"], ROOT))
    say("ptxas", kernels=ptxas_summary(built["report"], K.SEMIRINGS))
    built_rx = _build.build("engine_receive")
    _build.load("engine_receive")
    say("build_receive", seconds=round(built_rx["seconds"], 3),
        cached=built_rx["cached"],
        library=os.path.relpath(built_rx["path"], ROOT),
        ptxas=ptxas_summary(built_rx["report"], K.SEMIRINGS))

    phase_s["environment_and_build"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()
    # ---- 3. kernel vs plain version ----
    rng = np.random.default_rng(0)
    worst = {"idempotent": 0.0, "plus_times": 0.0, "plus_times_mxu": 0.0}

    def compare(semiring, kp, rp, where, mxu=False):
        err = max_abs_err(torch, kp, rp)
        fam = ("plus_times_mxu" if mxu else "plus_times"
               if semiring == "plus_times" else "idempotent")
        worst[fam] = max(worst[fam], err)
        if semiring == "plus_times":
            check(torch.allclose(kp, rp, rtol=1e-5, atol=1e-5),
                  f"plus_times differs from its plain version ({where}): "
                  f"max abs err {err}")
        else:
            check(torch.equal(kp, rp), f"{semiring} differs from its plain "
                                       f"version ({where}): max abs err {err}")

    worst_mxu = {"vs_scalar": 0.0}
    n_small = 0
    for semiring, dtype in SWEEP + [("plus_times_mxu", "float32")]:
        mxu = semiring == "plus_times_mxu"
        semiring = "plus_times" if mxu else semiring
        for n_blocks in (1, 3, 8):
            for weighted in (True, False):
                v, d, w = spmv_inputs(np, torch, rng, n_blocks * 512, dtype)
                w = w if weighted else None
                kp = K.spmv_partials(v, d, w, semiring=semiring, use_mxu=mxu)
                rp = R.spmv_partials_ref(v, d, w, semiring=semiring)
                torch.cuda.synchronize()
                compare(semiring, kp, rp, f"{dtype}, {n_blocks} blocks"
                        f"{', tensor cores' if mxu else ''}", mxu)
                if mxu:
                    worst_mxu["vs_scalar"] = max(
                        worst_mxu["vs_scalar"], max_abs_err(
                            torch, kp, K.spmv_partials(v, d, w,
                                                       semiring=semiring)))
                n_small += 1
    pad_v = torch.zeros(512, device=dev)
    pad_d = torch.full((512,), -1, dtype=torch.int32, device=dev)
    check(bool(torch.isinf(K.spmv_partials(pad_v, pad_d, None,
                                           semiring="min")).all()),
          "all-padding block is not the min identity")
    check(torch.equal(K.spmv_partials(pad_v + 1.0, pad_d, None,
                                      semiring="plus_times", use_mxu=True),
                      torch.zeros((1, 128), device=dev)),
          "all-padding block is not 0 in the tensor-core form")
    clamp_v = torch.full((512,), -5.0, device=dev)
    clamp_d = torch.zeros(512, dtype=torch.int32, device=dev)
    kc = K.spmv_partials(clamp_v, clamp_d, None, semiring="max")
    check(torch.equal(kc, R.spmv_partials_ref(clamp_v, clamp_d, None,
                                              semiring="max"))
          and float(kc[0, 0]) == 0.0, "max does not clamp at the identity")
    say("kernel_sweep", cases=n_small + 3, worst_abs_err=worst,
        tensor_core_worst_abs_err_vs_scalar=worst_mxu["vs_scalar"])

    cfg_large = get_graph_config("asymp_cc_large")
    t0 = time.perf_counter()
    graph = G.build_sharded_graph(cfg_large)
    build_graph_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pg = ops.build_pulled_graph(graph)
    build_pulled_s = time.perf_counter() - t0
    n_edges, n_blocks = len(pg.edge_src), pg.n_blocks
    say("host_build", config=cfg_large.name, vertices=graph.num_vertices,
        directed_edges=graph.num_edges, edges_on_largest_shard=graph.es,
        pulled_edges=n_edges, blocks=n_blocks,
        build_sharded_graph_s=round(build_graph_s, 3),
        build_pulled_graph_s=round(build_pulled_s, 3))
    # the pagerank phase's graph; its stream is the one the oracle pulls
    cfg_pr = get_graph_config("asymp_pagerank")
    g_pr = G.build_sharded_graph(cfg_pr)
    pg_pr = ops.build_pulled_graph(g_pr)
    # the crowded smoke's SSSP graph; its stream is the one min_plus pulls
    cfg_sssp = crowd_sssp_config(GraphConfig)
    g_sssp = G.build_sharded_graph(cfg_sssp)
    pg_sssp = ops.build_pulled_graph(g_sssp)
    streams = {"RMAT 2^18": pg.edge_dst_local,
               "RMAT 2^14": pg_pr.edge_dst_local,
               "RMAT 2^12": pg_sssp.edge_dst_local}

    forms = []
    # the main path's forms first: BSP's min on int32 labels and the
    # oracle's plus_times, both without weights; then the weighted sweep,
    # the tensor-core plus_times, the oracle's form on its 2^14 stream, and
    # the tensor-core form unweighted on both streams (2^14: phase 6's),
    # and the crowded smoke's weighted min_plus on its 2^12 stream
    for semiring, dtype, weighted, mxu, stream in [
            ("min", "int32", False, False, "RMAT 2^18"),
            ("plus_times", "float32", False, False, "RMAT 2^18")] + [
            (s, d, True, False, "RMAT 2^18") for s, d in SWEEP] + [
            ("plus_times", "float32", True, True, "RMAT 2^18"),
            ("plus_times", "float32", False, False, "RMAT 2^14"),
            ("plus_times", "float32", False, True, "RMAT 2^18"),
            ("plus_times", "float32", False, True, "RMAT 2^14"),
            ("min_plus", "float32", True, False, "RMAT 2^12")]:
        dst_s = streams[stream]
        n_e, n_b = len(dst_s), len(dst_s) // 512
        v, d, w = spmv_inputs(np, torch, rng, n_e, dtype, dst=dst_s)
        w = w if weighted else None
        kp = K.spmv_partials(v, d, w, semiring=semiring, use_mxu=mxu)
        rp = R.spmv_partials_ref(v, d, w, semiring=semiring)
        torch.cuda.synchronize()
        where = f"{dtype}, {stream} stream{', tensor cores' if mxu else ''}"
        compare(semiring, kp, rp, where, mxu)
        err = max_abs_err(torch, kp, rp)
        vs_scalar = (max_abs_err(torch, kp, K.spmv_partials(
            v, d, w, semiring=semiring)) if mxu else None)
        repeatable = None
        if semiring == "plus_times" and stream == "RMAT 2^18":
            repeatable = torch.equal(kp, K.spmv_partials(
                v, d, w, semiring=semiring, use_mxu=mxu))
            check(repeatable, f"two launches of plus_times ({where}) differ")
        ms = cuda_ms(torch, lambda: K.spmv_partials(
            v, d, w, semiring=semiring, use_mxu=mxu), 20)
        plain_ms = cuda_ms(torch, lambda: R.spmv_partials_ref(
            v, d, w, semiring=semiring), 5)
        # the library yardstick: one scatter_reduce_ over precomputed
        # (block*TILE + dst) segments and combined values
        agg = K.for_semiring(semiring)
        ident = K._identity(semiring, v.dtype)
        cand = K._combine(semiring, v, (w if w is not None
                                        else torch.ones_like(v)).to(v.dtype))
        block = torch.arange(n_e, device=dev) // 512
        seg = torch.where(d >= 0, block * 128 + d.long(), n_b * 128)
        reduce = {"min": "amin", "max": "amax", "or": "amax",
                  "sum": "sum"}[agg.name]
        lib_out = torch.full((n_b * 128 + 1,), ident, dtype=v.dtype,
                             device=dev)
        library_ms = cuda_ms(torch, lambda: lib_out.scatter_reduce_(
            0, seg, cand, reduce=reduce, include_self=True), 5)
        check(torch.equal(lib_out[:-1].view(n_b, 128), kp)
              or semiring == "plus_times", f"library yardstick disagrees "
                                           f"({semiring})")
        tile_steps = K.mma_tile_steps(d) if mxu else None
        bound_ms, bound_by, nbytes = bound_of(semiring, n_e, n_b, weighted,
                                              tile_steps)
        form = {"semiring": semiring, "dtype": dtype, "weights": weighted,
                "tensor_cores": mxu, "stream": stream,
                "mma_tile_steps": tile_steps,
                "max_abs_err_vs_scalar": vs_scalar,
                "bitwise_repeatable": repeatable,
                "blocks": n_b, "max_abs_err": err, "ms": ms,
                "plain_ms": plain_ms, "library_ms": library_ms,
                "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes}
        forms.append(form)
        say("kernel_at_main_shape", **form)
        del v, d, w, kp, rp, cand, seg, lib_out, block
    phase_s["kernels"] = time.perf_counter() - t_phase

    # ---- 4. main path at full size ----
    t_phase = time.perf_counter()
    pg_dev = pg.to(dev)  # the RMAT 2^18 stream, uploaded once for BSP and
    K.reset_launch_counts()  # the pagerank oracle
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    receives = {}  # the receive kernel's launches, path by path
    rx0 = RK.deliver.launches
    t0 = time.perf_counter()
    state, totals = E.run_to_convergence(cfg_large, graph=graph, device=dev,
                                         collect_log=True)
    torch.cuda.synchronize()
    prop_s = time.perf_counter() - t0
    receives["main_path"] = RK.deliver.launches - rx0
    t0 = time.perf_counter()
    bsp_labels, bsp = ops.bsp_connected_components(graph, device=dev,
                                                   pulled=pg_dev)
    torch.cuda.synchronize()
    bsp_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ranks = ops.pagerank(graph, iters=PAGERANK_ITERS, device=dev,
                         pulled=pg_dev)
    torch.cuda.synchronize()
    pagerank_s = time.perf_counter() - t0
    launches = dict(K.spmv_partials.launches_by_form)
    peak = torch.cuda.max_memory_allocated()
    labels = state.values.reshape(-1)[: graph.num_real_vertices]
    say("main_path", config=cfg_large.name, ticks=totals["ticks"],
        messages=totals["sent"], fetched=totals["fetched"],
        converged=totals["converged"], bsp_rounds=bsp["rounds"],
        bsp_messages=bsp["messages"], propagation_s=prop_s, bsp_s=bsp_s,
        pagerank_iters=PAGERANK_ITERS, pagerank_s=pagerank_s,
        kernel_launches=launches, receive_launches=receives["main_path"],
        max_memory_allocated=peak,
        components=int(torch.unique(labels).numel()))
    check(totals["converged"], "the engine did not converge")
    check(torch.equal(labels, bsp_labels), "engine labels != BSP labels")
    check(launches.get("min/int32", 0) == bsp["rounds"],
          f"kernel launches {launches} != BSP rounds {bsp['rounds']}")
    check(launches.get("plus_times/float32", 0) == PAGERANK_ITERS,
          f"plus_times launches {launches} != {PAGERANK_ITERS}")
    check(receives["main_path"] == totals["ticks"],
          f"receive launches {receives['main_path']} != ticks "
          f"{totals['ticks']}")
    check(bool(torch.isfinite(ranks).all())
          and abs(float(ranks.sum()) - 1.0) < 1e-3,
          f"pagerank mass {float(ranks.sum())} is not 1")
    cc_ticks = totals["ticks"]
    main_log, labels_host = totals["log"], labels.cpu().numpy()
    del state, bsp_labels, ranks

    # ---- 4b. where a BSP run's and an engine tick's time goes (profiled
    # after the launch counts were read) ----
    say("bsp_profile", **device_profile(torch, lambda: (
        ops.bsp_connected_components(graph, device=dev, pulled=pg_dev))))
    del pg_dev
    sess = E.EngineSession(cfg_large, graph=graph, device=dev)
    for _ in range(PROFILE_WARM_TICKS):
        sess.step()
    torch.cuda.synchronize()

    def ticks():
        for _ in range(PROFILE_TICKS):
            sess.step()

    tick_profile = device_profile(torch, ticks)
    phase_s["main_path"] = time.perf_counter() - t_phase
    say("engine_tick_profile", ticks=f"{PROFILE_WARM_TICKS}.."
        f"{PROFILE_WARM_TICKS + PROFILE_TICKS}", **tick_profile)

    # ---- 4c. the receive kernel at the main path's own receive and at
    # the benchmark's shape ----
    t_phase = time.perf_counter()
    rx_forms = receive_phase(torch, E, RK, AGGREGATORS, sess, dev)
    for form in rx_forms:
        say("receive_kernel", **form)
    del sess
    phase_s["receive"] = time.perf_counter() - t_phase

    # ---- 5. bench_speed smoke configs against the oracles ----
    t_phase = time.perf_counter()
    cfg = GraphConfig(name="smoke", algorithm="cc", num_vertices=1 << 12,
                      avg_degree=16, generator="rmat", num_shards=8,
                      priority="log", enforce_fraction=0.1)
    g = G.build_sharded_graph(cfg)
    comp = G.cc_oracle(g.num_real_vertices, G.edge_list(g))
    bsp_out, _ = ops.bsp_connected_components(g, device=dev)
    check(np.array_equal(bsp_out.cpu().numpy(), comp),
          "smoke: BSP labels != union-find oracle")
    expect = {"cc": comp,
              "labelprop": G.labelprop_oracle(g.num_real_vertices, comp=comp)}
    for alg, (ticks0, msgs0) in SMOKE_BASELINE.items():
        c = dataclasses.replace(cfg, algorithm=alg, name=f"smoke-{alg}")
        rx0 = RK.deliver.launches
        st, tot = E.run_to_convergence(c, graph=g, device=dev)
        rx = RK.deliver.launches - rx0
        receives[f"bench_speed_smoke {alg}"] = rx
        lab = st.values.reshape(-1)[: g.num_real_vertices].cpu().numpy()
        check(tot["converged"] and np.array_equal(lab, expect[alg]),
              f"smoke: {alg} fixpoint wrong")
        check(rx == tot["ticks"],
              f"smoke: {alg} receive launches {rx} != ticks {tot['ticks']}")
        say("bench_speed_smoke", program=alg, ticks=tot["ticks"],
            messages=tot["sent"], baseline_ticks=ticks0,
            baseline_messages=msgs0, receive_launches=rx,
            counts_match=(tot["ticks"], tot["sent"]) == (ticks0, msgs0))
    phase_s["bench_speed_smoke"] = time.perf_counter() - t_phase

    # ---- 6. push-mode pagerank at asymp_pagerank ----
    t_phase = time.perf_counter()
    pg_pr = pg_pr.to(dev)
    K.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    rx0 = RK.deliver.launches
    t0 = time.perf_counter()
    st_pr, tot_pr = E.run_to_convergence(cfg_pr, graph=g_pr, device=dev)
    torch.cuda.synchronize()
    pr_s = time.perf_counter() - t0
    check(RK.deliver.launches == rx0,
          "push-mode pagerank launched the receive kernel")
    pr_peak = torch.cuda.max_memory_allocated()
    oracle = ops.pagerank(g_pr, damping=cfg_pr.damping, iters=ORACLE_ITERS,
                          dangling="absorb", device=dev, pulled=pg_pr)
    # one tensor-core pull step on the oracle's contribution vector
    n_real = g_pr.num_real_vertices
    deg = torch.as_tensor(g_pr.degrees().reshape(-1)[:n_real],
                          dtype=torch.float32, device=dev)
    contrib = oracle / torch.clamp(deg, min=1.0)
    pulled_mxu = ops.frontier_pull_step(contrib, pg_pr, semiring="plus_times",
                                        use_mxu=True)
    torch.cuda.synchronize()
    pr_launches = dict(K.spmv_partials.launches_by_form)
    pulled_scalar = ops.frontier_pull_step(contrib, pg_pr,
                                           semiring="plus_times")
    l1, mass = pagerank_verdict(torch, np, M, st_pr, tot_pr, g_pr, oracle,
                                "asymp_pagerank")
    mxu_err = max_abs_err(torch, pulled_mxu, pulled_scalar)
    say("pagerank", config=cfg_pr.name, ticks=tot_pr["ticks"],
        messages=tot_pr["sent"], jax_cpu_ticks=JAX_PAGERANK[0],
        jax_cpu_messages=JAX_PAGERANK[1], propagation_s=pr_s,
        ms_per_tick=pr_s / tot_pr["ticks"] * 1e3, l1_to_oracle=l1,
        mass_balance=mass, max_memory_allocated=pr_peak,
        mxu_pull_step_max_abs_err_vs_scalar=mxu_err,
        kernel_launches=pr_launches)
    check(torch.allclose(pulled_mxu, pulled_scalar, rtol=1e-5, atol=1e-5),
          f"tensor-core pull step differs from the scalar one by {mxu_err}")
    check(pr_launches.get("plus_times/float32", 0) == ORACLE_ITERS
          and pr_launches.get("plus_times_mxu/float32", 0) == 1,
          f"pagerank path launches {pr_launches}")
    phase_s["pagerank"] = time.perf_counter() - t_phase

    # ---- 7. faults (§5.5): replay (CC) and checkpoint restore (pagerank) --
    t_phase = time.perf_counter()
    plan = dict(fail_fraction=0.5, start_tick=4, every=6)  # graph_mine's
    K.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    rx0 = RK.deliver.launches
    t0 = time.perf_counter()
    st_f, tot_f = E.run_to_convergence(cfg_large, graph=graph, device=dev,
                                       fault_plan=F.FaultPlan(**plan))
    torch.cuda.synchronize()
    cc_fault_s = time.perf_counter() - t0
    receives["faults_replay"] = RK.deliver.launches - rx0
    cc_fault_peak = torch.cuda.max_memory_allocated()
    same = torch.equal(st_f.values.reshape(-1)[: graph.num_real_vertices],
                       labels)
    say("faults_replay", config=cfg_large.name, plan=plan,
        ticks=tot_f["ticks"], fault_free_ticks=cc_ticks,
        tick_overhead=tot_f["ticks"] / cc_ticks - 1.0,
        propagation_s=cc_fault_s, fault_free_propagation_s=prop_s,
        wall_time_ratio=cc_fault_s / prop_s, failures=tot_f["failures"],
        replayed_messages=tot_f["replayed"], messages=tot_f["sent"],
        labels_equal_fault_free=same, max_memory_allocated=cc_fault_peak,
        receive_launches=receives["faults_replay"])
    check(tot_f["converged"] and same,
          "CC under failures: labels differ from the fault-free labels")
    check(tot_f["failures"] == 4 and tot_f["replayed"] > 0,
          f"CC under failures: {tot_f['failures']} failures, "
          f"{tot_f['replayed']} replayed")
    check(receives["faults_replay"] == tot_f["ticks"],
          f"CC under failures: receive launches {receives['faults_replay']}"
          f" != ticks {tot_f['ticks']}")
    del st_f
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st_pf, tot_pf = E.run_to_convergence(cfg_pr, graph=g_pr, device=dev,
                                         fault_plan=F.FaultPlan(**plan))
    torch.cuda.synchronize()
    pr_fault_s = time.perf_counter() - t0
    l1_f, mass_f = pagerank_verdict(torch, np, M, st_pf, tot_pf, g_pr, oracle,
                                    "asymp_pagerank under failures")
    fault_launches = dict(K.spmv_partials.launches_by_form)
    say("faults_checkpoint", config=cfg_pr.name, plan=plan,
        ticks=tot_pf["ticks"], fault_free_ticks=tot_pr["ticks"],
        tick_overhead=tot_pf["ticks"] / tot_pr["ticks"] - 1.0,
        propagation_s=pr_fault_s, wall_time_ratio=pr_fault_s / pr_s,
        failures=tot_pf["failures"], replayed_messages=tot_pf["replayed"],
        l1_to_oracle=l1_f, mass_balance=mass_f,
        kernel_launches=fault_launches)
    check(tot_pf["failures"] > 0 and tot_pf["replayed"] == 0,
          f"pagerank under failures: {tot_pf['failures']} failures, "
          f"{tot_pf['replayed']} replayed")
    phase_s["faults"] = time.perf_counter() - t_phase

    # ---- 8. the int16 wire ----
    t_phase = time.perf_counter()
    wire_phase(np, torch, E, G, X, get_graph_config, dev)
    phase_s["wire"] = time.perf_counter() - t_phase

    # ---- 9. crowded cluster at full width (§5.4) ----
    t_phase = time.perf_counter()
    cfg_crowd = dataclasses.replace(cfg_large, **SLOWDOWN)
    K.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    rx0 = RK.deliver.launches
    t0 = time.perf_counter()
    sess = E.EngineSession(cfg_crowd, graph=graph, device=dev)
    tot_c = sess.tick_until_quiescent()
    torch.cuda.synchronize()
    crowd_s = time.perf_counter() - t0
    receives["crowded_main"] = RK.deliver.launches - rx0
    crowd_launches = dict(K.spmv_partials.launches_by_form)
    in_flight = int(X.ring_pending(sess.ring))
    same = torch.equal(sess.state.values.reshape(-1)[
        : graph.num_real_vertices], labels)
    say("crowded_main", config=cfg_crowd.name, slowdown=SLOWDOWN,
        latency=sess.latency.describe(), ticks=tot_c["ticks"],
        messages=tot_c["sent"], fault_free_ticks=cc_ticks,
        degradation=tot_c["ticks"] / cc_ticks, propagation_s=crowd_s,
        fault_free_propagation_s=prop_s, wall_time_ratio=crowd_s / prop_s,
        ms_per_tick=crowd_s / tot_c["ticks"] * 1e3,
        pending=tot_c["pending"], ring_in_flight=in_flight,
        labels_equal_main_path=same, converged=tot_c["converged"],
        max_memory_allocated=torch.cuda.max_memory_allocated(),
        kernel_launches=crowd_launches,
        receive_launches=receives["crowded_main"])
    check(receives["crowded_main"] == tot_c["ticks"],
          f"crowded asymp_cc_large: receive launches "
          f"{receives['crowded_main']} != ticks {tot_c['ticks']}")
    check(tot_c["converged"] and same,
          "crowded asymp_cc_large: labels differ from the main path's")
    check(tot_c["pending"] == 0 and in_flight == 0,
          f"crowded asymp_cc_large: {in_flight} messages left in the ring")
    del sess
    say("crowded_tick_profile", **window_profile(
        torch, E.EngineSession(cfg_crowd, graph=graph, device=dev),
        CROWDED_WARM_TICKS))
    say("async_tick_profile", schedule="async", **window_profile(
        torch, E.EngineSession(cfg_crowd, graph=graph, device=dev,
                               schedule="async"), ASYNC_WARM_TICKS))
    phase_s["crowded_main"] = time.perf_counter() - t_phase

    # ---- 10. bench_crowded --smoke on the card ----
    t_phase = time.perf_counter()
    smoke_launches, receives["crowded_smoke"] = crowded_smoke_phase(
        np, torch, E, K, L, R, RK, ops, cfg_sssp, g_sssp, pg_sssp,
        get_program, dev)
    phase_s["crowded_smoke"] = time.perf_counter() - t_phase

    # ---- 11. kills and slowdowns on the crowded config, sync and async ----
    t_phase = time.perf_counter()
    g_crowd, crowd_labels = crowded_faults_phase(torch, E, F, G,
                                                 get_graph_config, dev)
    phase_s["crowded_faults"] = time.perf_counter() - t_phase

    # ---- 12. elastic resize 8 -> 4 shards at full width ----
    t_phase = time.perf_counter()
    elastic_launches = elastic_phase(np, torch, E, G, CK, EL, K, cfg_large,
                                     graph, labels, dev)
    del labels
    phase_s["elastic"] = time.perf_counter() - t_phase

    # ---- 13. the serving plane at full width ----
    t_phase = time.perf_counter()
    serve_launches = serve_main_phase(np, torch, E, G, K, R, SG, ops,
                                      cfg_large, graph, dev)
    phase_s["serve_main"] = time.perf_counter() - t_phase

    # ---- 14. bench_serve --smoke and bench_load --smoke on the card ----
    t_phase = time.perf_counter()
    serve_smoke_phase(np, torch, E, SG, GraphConfig, dev)
    phase_s["serve_smoke"] = time.perf_counter() - t_phase

    # ---- 15. pagerank served under deltas, held to its verdict ----
    t_phase = time.perf_counter()
    rank_launches = serve_rank_phase(np, torch, K, M, SG, ops, cfg_pr, g_pr,
                                     dev)
    phase_s["serve_rank"] = time.perf_counter() - t_phase

    # ---- 16-19. multi-rank execution: 8 gloo ranks share the card, one
    # pool for every phase (torch and CUDA start once, while dist_nccl
    # runs here); each rank maps its rows of the graphs built above ----
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as dist_dir, MS.RankPool(
            DIST_RANKS, backend="gloo",
            init_method=f"file://{dist_dir}/store",
            timeout_s=DIST_TIMEOUT_S) as pool:
        dist_nccl_phase(torch, E, G, MS, get_graph_config, get_program, dev,
                        dist_dir)
        phase_s["dist_nccl"] = time.perf_counter() - t_phase
        t_phase = time.perf_counter()
        gdir = save_graph(np, graph, os.path.join(dist_dir, "large"))
        dist_main_phase(np, pool, E, get_program, cfg_large, graph, gdir,
                        main_log, labels_host)
        phase_s["dist_main"] = time.perf_counter() - t_phase
        t_phase = time.perf_counter()
        gdir = save_graph(np, g_crowd, os.path.join(dist_dir, "crowded"))
        dist_crowded_phase(np, pool, E, get_program,
                           get_graph_config("asymp_cc_crowded"), g_crowd,
                           gdir, crowd_labels)
        phase_s["dist_crowded_async"] = time.perf_counter() - t_phase
        t_phase = time.perf_counter()
        gdir = save_graph(np, g_pr, os.path.join(dist_dir, "pagerank"))
        dist_rank_phase(np, torch, pool, E, M, get_program, cfg_pr, g_pr,
                        gdir, oracle)
        phase_s["dist_rank"] = time.perf_counter() - t_phase

    # ---- 20. the dense LM served at full width (no SpMV kernel on it) ----
    t_phase = time.perf_counter()
    K.reset_launch_counts()
    lm_cfg = dataclasses.replace(get_config(LM_ARCH), num_layers=LM_LAYERS)
    lm_serve_phase(np, torch, T, TA, LY, SE, lm_cfg, dev, LM_LONG,
                   cpu_cfg=get_config(LM_ARCH).reduced())
    check(not any(K.spmv_partials.launches_by_form.values()),
          "lm_serve launched an SpMV kernel")
    phase_s["lm_serve"] = time.perf_counter() - t_phase

    # ---- 21. the dense LM trained at full width (no SpMV kernel on it) ----
    t_phase = time.perf_counter()
    K.reset_launch_counts()
    lm_train_phase(np, torch, T, TA, TR, OPT, DP, CK, lm_cfg,
                   dev, LM_LONG, dataclasses.replace(
                       get_config(LM_ARCH).reduced(), num_layers=8))
    check(not any(K.spmv_partials.launches_by_form.values()),
          "lm_train launched an SpMV kernel")
    phase_s["lm_train"] = time.perf_counter() - t_phase

    # ---- 22-24. the MoE family at full width (no SpMV kernel on it) ----
    moe_cfg = get_config(MOE_ARCH)
    t_phase = time.perf_counter()
    K.reset_launch_counts()
    lm_moe_serve_phase(np, torch, T, MOE, SE, dataclasses.replace(
        moe_cfg, num_layers=MOE_SERVE_LAYERS), dev, LM_LONG,
        moe_cfg.reduced())
    check(not any(K.spmv_partials.launches_by_form.values()),
          "lm_moe_serve launched an SpMV kernel")
    phase_s["lm_moe_serve"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()
    lm_moe_train_phase(np, torch, T, TR, OPT, DP, CK, dataclasses.replace(
        moe_cfg, num_layers=MOE_TRAIN_LAYERS), dev, dataclasses.replace(
        moe_cfg.reduced(), num_layers=8))
    check(not any(K.spmv_partials.launches_by_form.values()),
          "lm_moe_train launched an SpMV kernel")
    phase_s["lm_moe_train"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as moe_dir:
        moe_a2a_phase(np, torch, MS, SH, MOE, A2A, moe_cfg, dev, moe_dir)
    check(not any(K.spmv_partials.launches_by_form.values()),
          "moe_a2a launched an SpMV kernel")
    phase_s["moe_a2a"] = time.perf_counter() - t_phase

    # ---- 25-27. the SSM and hybrid families at full width, depth cut to
    # SSM_LAYERS (no SpMV kernel on them) ----
    def ssm_cfg(arch):
        return dataclasses.replace(get_config(arch),
                                   num_layers=SSM_LAYERS[arch])
    for arch in SSM_ARCHS:
        t_phase = time.perf_counter()
        K.reset_launch_counts()
        lm_ssm_serve_phase(np, torch, T, TA, SSM, SE, ssm_cfg(arch), dev,
                           LM_LONG, ssm_small_cfg(get_config(arch), 2))
        check(not any(K.spmv_partials.launches_by_form.values()),
              f"lm_ssm_serve {arch} launched an SpMV kernel")
        phase_s[f"lm_ssm_serve {arch}"] = time.perf_counter() - t_phase
    for arch in SSM_ARCHS:
        t_phase = time.perf_counter()
        K.reset_launch_counts()
        lm_ssm_train_phase(np, torch, T, TA, TR, OPT, DP, CK,
                           ssm_cfg(arch), dev, LM_LONG,
                           ssm_small_cfg(get_config(arch), 8))
        check(not any(K.spmv_partials.launches_by_form.values()),
              f"lm_ssm_train {arch} launched an SpMV kernel")
        phase_s[f"lm_ssm_train {arch}"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()
    K.reset_launch_counts()
    with tempfile.TemporaryDirectory() as ssd_dir:
        ssd_seq_parallel_phase(np, torch, MS, SH, A2A, SSM,
                               get_config("mamba2-780m"), dev, ssd_dir)
    check(not any(K.spmv_partials.launches_by_form.values()),
          "ssd_seq_parallel launched an SpMV kernel")
    phase_s["ssd_seq_parallel"] = time.perf_counter() - t_phase

    # ---- 28-31. MLA and MTP (deepseek-v3), the encoder-decoder (whisper)
    # at full width (no SpMV kernel on them) ----
    mla_cfg = get_config(MLA_ARCH)
    lm_phases = (
        ("lm_mla_serve", lambda: lm_mla_serve_phase(
            np, torch, T, TA, LY, MOE, SE, dataclasses.replace(
                mla_cfg, num_layers=MLA_SERVE_LAYERS), dev, LM_LONG,
            mla_cfg.reduced())),
        ("lm_mla_train", lambda: lm_mla_train_phase(
            np, torch, T, TA, TR, OPT, DP, CK, dataclasses.replace(
                mla_cfg, num_layers=MLA_TRAIN_LAYERS), dev, LM_LONG,
            dataclasses.replace(mla_cfg.reduced(), num_layers=8))),
        ("lm_encdec_serve", lambda: lm_encdec_serve_phase(
            np, torch, ED, SE, get_config(ENCDEC_ARCH), dev,
            get_config(ENCDEC_ARCH).reduced())),
        ("lm_encdec_train", lambda: lm_encdec_train_phase(
            np, torch, TR, OPT, DP, CK, TRL, get_config(ENCDEC_ARCH), dev,
            get_config(ENCDEC_ARCH).reduced())))
    for name, run in lm_phases:
        t_phase = time.perf_counter()
        K.reset_launch_counts()
        run()
        check(not any(K.spmv_partials.launches_by_form.values()),
              f"{name} launched an SpMV kernel")
        phase_s[name] = time.perf_counter() - t_phase

    # ---- 32. the dry run and the roofline (no SpMV kernel) ----
    t_phase = time.perf_counter()
    K.reset_launch_counts()
    say("dryrun", **dryrun_phase(torch, T, ED, DR, PR, RA, get_config,
                                 list_archs, SHAPES, dev))
    check(not any(K.spmv_partials.launches_by_form.values()),
          "dryrun launched an SpMV kernel")
    phase_s["dryrun"] = time.perf_counter() - t_phase
    say("phase_seconds", **phase_s)

    # ---- 33. kernels line, card, last line ----
    src = "src/repro_torch/csrc/semiring_spmv.cu"
    replaces = "src/repro/kernels/semiring_spmv.py:71"

    # SpMV launches on the script's paths: the main path, pagerank, faults,
    # the crowded main path and the elastic resize (none: the engine tick
    # launches only the receive kernel, counted below), the crowded smoke's
    # min_plus pull, and the serving plane's checks (serve_main: BSP and
    # the min_plus pull on the patched graph; serve_rank: the pagerank
    # oracle after each delta)
    paths = (launches, pr_launches, fault_launches, crowd_launches,
             smoke_launches, elastic_launches, serve_launches, rank_launches)

    by_form = {k: sum(path.get(k, 0) for path in paths)
               for k in sorted({k for path in paths for k in path})}

    def entry(name, form, keys, err):
        return {"name": name, "route": "cuda", "source": src,
                "replaces": replaces,
                "launches": sum(by_form[k] for k in keys),
                "max_abs_err": err, "ms": form["ms"],
                "plain_ms": form["plain_ms"], "bound_ms": form["bound_ms"],
                "bound_by": form["bound_by"],
                "library_ms": form["library_ms"],
                "launches_by_form": {k: by_form[k] for k in keys}}

    idem = entry("spmv_partials[min,max,min_plus,max_min,or] "
                 "(BSP path and serve_main: min/int32; crowded smoke and "
                 "serve_main: min_plus/float32)",
                 forms[0], [k for k in by_form
                            if not k.startswith("plus_times")],
                 worst["idempotent"])
    idem["forms"] = [f for f in forms[1:] if f["semiring"] != "plus_times"]
    pt = entry("spmv_partials[plus_times] (pagerank oracle; serve_rank)",
               forms[1],
               [k for k in by_form if k == "plus_times/float32"],
               worst["plus_times"])
    pt["forms"] = [f for f in forms[2:] if f["semiring"] == "plus_times"
                   and not f["tensor_cores"]]
    mxu_form = next(f for f in forms if f["tensor_cores"])
    mxu = entry("spmv_partials[plus_times, use_mxu=True] (tensor cores; "
                "pagerank pull step)", mxu_form,
                [k for k in by_form if k == "plus_times_mxu/float32"],
                worst["plus_times_mxu"])
    mxu["replaces"] = "src/repro/kernels/semiring_spmv.py:80"
    mxu["forms"] = [f for f in forms if f["tensor_cores"]
                    and f is not mxu_form]
    # the receive kernel: one launch a tick on every engine path counted
    # above (main path, bench_speed smoke, faults, crowded main and smoke);
    # its forms at the main path's own receive, then the benchmark's shape
    rx = {"name": "engine_receive[min,max,or x int32,float32] (the engine "
                  "tick's receive: main path, bench_speed smoke, faults, "
                  "crowded main and smoke)",
          "route": "cuda", "source": "src/repro_torch/csrc/engine_receive.cu",
          "replaces": "none (src/repro/core/engine.py::_phase2_receive is "
                      "an XLA scatter)",
          "launches": sum(receives.values()), "max_abs_err": 0.0,
          **{k: rx_forms[0][k] for k in ("ms", "plain_ms", "bound_ms",
                                         "bound_by", "library_ms")},
          "launches_by_path": receives, "forms": rx_forms}
    print(json.dumps({"kernels": [idem, pt, mxu, rx]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"[chip_smoke] FAIL: {e}", flush=True)
        sys.exit(1)
