#!/usr/bin/env python3
"""Drive the PyTorch port of DreamShard once on one NVIDIA GPU.

    python3 chip_smoke.py [--out summary.json] [--artifact calibration.npz]

Phases, each of which fails the run (non-zero exit) on any error:

1. device: the card's name and power limit, as ``nvidia-smi`` reports them;
2. build: K1 (``src/repro_torch/csrc/embedding_bag.cu``, its forward and
   its backward), K2 (``src/repro_torch/csrc/flash_attention.cu``), K2-bwd
   (``src/repro_torch/csrc/flash_attention_bwd.cu``), K3
   (``src/repro_torch/csrc/selective_scan.cu``, with K3-bwd) and K4
   (``src/repro_torch/csrc/wkv6.cu``, with K4-bwd) with nvcc for sm_90a into
   ``build/kernels/``, one nvcc per source, started together; ptxas must
   report no spill in any bf16 (tensor-core) K2 or K2-bwd instance;
3. K1's forward against its plain PyTorch version on the card, bit for
   bit: the reference's test sweep (rows x dim x pool x {f32, bf16}),
   padding at arbitrary positions with a zero, a signed-zero and a non-zero
   row 0 at P in {1, 31, 32, 33, 199}, the all-padding case, and arenas of
   more than 2^31 elements (64-bit row offsets);
3b. K1's backward against its plain version (the ``index_add_`` loop): bit
   for bit on integer-valued gradients, and on normal ones within twice the
   plain version's own error against a float64 ``index_add_`` plus 1e-6;
   bit for bit against the plain replay of its own order; two launches
   bit-equal; its plan on the card equal to ``backward_plan`` array for
   array; no host sync inside a call (``set_sync_debug_mode("error")``);
   runs longer than the chunk, all-padding bags, bf16 ``grad_out`` and a
   gradient of more than 2^31 elements (4 radix passes);
4. the main path: place the paper's DLRM-50 (4) test tasks with an
   untrained DreamShard agent (seed 0, 16 candidates) through
   ``as_placer().place_many`` on ``cuda``, run the baseline placers, then
   measure DreamShard's and the experts' placements of two tasks with
   ``measure_placement`` (batch 65536, each table's own pooling, rows
   capped at 2^20) -- one K1 forward and one K1 backward per device and
   repeat;
5. the yardstick: K1's forward, its plain version and ``F.embedding_bag``,
   then K1's backward, its plain version and the backward of
   ``F.embedding_bag``, timed at the largest main-path device shape, beside
   the memory bound; the backward's stages (the plan on the card, pass 1,
   the write pass) each by its own CUDA events, beside ``backward_plan``'s
   torch time and the scratch bytes; it fails unless K1's forward beats
   ``F.embedding_bag``;
6. K2 against its plain PyTorch version on the card -- bf16 through the
   tensor-core kernel, float32 through the CUDA-core one: S x hd x dtype x
   window x GQA group, non-causal attention over ragged key lengths, and
   (after phase 7) layer 0's real q/k/v of the served model at 8192 tokens
   and window 4096: bf16 by bf16 ulps (``attention_ulp_err``, as phase
   13's), float32 to a limit below a typical output;
6c. K2-bwd (the attention backward: FA2's, from K2's output and row
   log-sum-exp) against its plain version's float64 run on the card at
   hymba's head shape (hd 64, 25 over 5 heads, window 1024, 2 x 4096),
   musicgen's (hd 64, group 1), granite's (hd 128, 48 over 1 head),
   non-causal attention over ragged keys (with and without a window), hd
   32 and hd 256: bf16 (tensor cores) within 1e-2 max |err| / max |ref|
   and 1e-2 relative rms (13 (c)'s limits: P and dS are rounded to bf16
   for their products, the output is bf16), float32 (CUDA cores) within
   1e-4 and 1e-5 (float32 sums of up to 4096 terms); each case twice
   with the same bits, and K2's output bit-equal with and without its
   lse store;
7. the LM path: serve h2o-danube-1.8b at full width (24 layers, bf16,
   seeded weights) through ``repro_torch.launch.serve.serve``: 2 prompts
   of 8192 tokens, one warm-up prefill, a timed prefill and 15 greedy
   decode steps -- 24 K2 launches per prefill -- then a torch.profiler
   window over one prefill and over 4 decode steps;
7c. the same path at full width with 2 layers in float32, on the card (K2)
   and on the CPU (plain): logits and greedy tokens must agree;
9. the yardstick: K2 (bf16, tensor cores), its plain version and
   ``F.scaled_dot_product_attention`` timed at the main-path layer shape,
   beside the operations bound; K2's float32 (CUDA-core) kernel is timed
   on the same values on a line of its own;
8. (after phase 9) Algorithm 1 on measured costs: ``KernelOracle(batch_size=
   65536, max_rows=2^20)`` calibrates on the card (K1's forward and
   backward over the kernel grid, the fused and the sharded sweeps; the
   artifact saved, reloaded and held to price the same placements bit for
   bit), then ``DreamShard`` trains on DLRM-50 (4) (16 training tasks, the
   paper's budget: 10 iterations of 10 collects, 300 cost steps, 10 RL
   steps of 10 episodes) against it; the trained agent, the untrained one
   and random place the 20 test tasks, and the trained agent must cost
   least by the card's ``MeasuredOracle``; test task 0's trained
   placement is timed live with K1 (``measure_placement``, at each
   table's own pooling and at 4) beside the oracle's estimate; one cost
   stage of 50 fused steps from the same weights, ring and slots must
   give the same losses on the card and on the CPU
   within 1e-4 relative; and torch.profiler counts the device ops of a
   cost step and of a REINFORCE step and their busy share;
8b. (after phase 8) Table 1's DLRM-50 (4) row on the card
   (``benchmarks/table1_main.py:36-52``): (a) the RNN baseline
   (``core/rnn_policy.RNNPlacer``) trains on the card against phase 8's
   ``KernelOracle`` with the reference's matched budget, 50 updates of 10
   episodes, and must consume exactly 500 oracle rows; (b) random, the
   four experts, ``expert_best``, the RNN, DreamShard (16 candidates) and
   DreamShard refined by lns (phase 11's configuration) place the 20 test
   and the 16 train tasks, every placement legal, each mean priced by
   ``MeasuredOracle`` with the speedups over random and over the best
   baseline and ``beats_all`` (printed, not checked); (c) the RNN's and
   ``expert_best``'s placements of test task 0 timed live with K1
   (``measure_placement``) beside phase 8's trained one, and K1 and its
   backward held to plain at each of their devices' shapes and indices
   (a placement equal to one already timed on that task is timed once);
   (d) one RNN update from the same converted weights, task and noise
   on the card and on the CPU: the same episodes, gradients within 1e-4,
   and the same greedy placements of the 20 test tasks;
10. (after phase 8b) the DLRM training step over DreamShard's placement:
   (a) ``make_sharded_lookup`` over NCCL at one rank (NCCL takes one rank
   a card) bit-equal to ``lookup_unsharded`` on the card, forward and
   arena gradient; (b) DLRM at ``configs/dlrm.FULL``'s widths over test
   task 0's 50 tables (rows capped at 2^20), batch 65536, float32, the
   four shards' arenas on this one card through ``lookup_unsharded`` (K1
   forward and backward per shard and step), row-wise Adagrad on the
   arenas and Adam on the dense nets: 1 warm-up and 2 timed steps for
   phase 8's trained placement and its random one, on the same batches
   (``DLRMBatchStream`` through ``Prefetcher``, made once); first, on the
   trained placement's first batch, K1 forward and backward per shard at
   the step's own indices, arenas and upstream gradient against their
   plain versions (forward bit for bit; backward bit for bit to its
   plain replay and by phase 3b's float64 rule, its plan equal to
   ``backward_plan``; its ms and scratch bytes per shard); median step ms
   (CUDA events, indices on the card to updated parameters: the sum of the
   shards, not the slowest device's time), host seconds a batch, peak
   memory, arena bytes, K1 launches, losses (finite; printed beside the
   labels' entropy, the least mean loss any model reaches on them) and
   the placement's ``MeasuredOracle`` cost; torch.profiler over one step;
   (c) SMOKE's widths, 3 steps on the card and on the CPU from the same
   weights and batches: logits, losses and parameters within 1e-5
   relative.
11. (after phase 10) search and the sharding placer over phase 8's
   trained agent, its ``KernelOracle`` and its ``MeasuredOracle``: (a)
   b9's paper regime on the 20 DLRM-50 (4) test tasks -- the agent's
   placements (16 candidates) refined through ``DreamShardPlacer(agent,
   refiner=SearchPlacer(measured, ...))`` by lns, evolution and beam+lns
   at 256 oracle rows a task and by lns at 50 ms a task; every refined
   cost at most its seed's; test task 0's seed and best refined placement
   timed live with K1 (``measure_placement``) beside the oracle, and K1
   and its backward held to plain at each of their devices' shapes and
   indices (as phase 10 holds them per shard); (b)
   b13's construction on the same tasks (the largest table inflated to
   2.5 x one device's memory): every whole-table baseline placer illegal
   on every task, ``ShardingPlacer`` legal on every task and
   ``refine_sharded`` (lns, 192 rows) never worse, priced by
   ``MeasuredOracle.evaluate_sharded`` (``KernelOracle`` agreeing); (c)
   oversized task 0's column-sharded plan at batch 65536 (rows capped at
   2^20), its arenas split by columns from a whole-table plan's:
   ``lookup_unsharded`` + ``combine_shard_outputs`` bit-equal to the
   whole-table lookup, each shard's K1 output bit-equal to plain on its
   arena and rows, and from one upstream gradient K1's backward per
   shard bit-equal to its plain replay and every slot held to its table's
   float64 gradient columns by phase 3b's rule (plain's float32 sum on
   the host, in a fixed order, capped at its largest error over 10 runs
   in the order of CUDA's atomics: ``table_grad_refs``).
12. (after phase 11) placement serving over phase 8's trained agent (16
   candidates, decoding on the card) and its ``KernelOracle``: (a) b11's
   paper regime (12 jobs x 50 tables, 4 devices, 1500 requests + 8 tail
   jobs, drift 0.8) through ``PlacementService`` under the ``drift``,
   ``never`` and ``always`` policies, beside the cold leg
   (``session.place`` on the first 50 requests): every request served
   with a legal placement from the cache or a decode, no decode raised, hit
   rate >= 0.5 in each leg, warm-hit p50 >= 20x under cold p50, and a
   zero-drift replay bit-equal to ``place_many``; (b) b12's paper regime
   at 8 devices under its committed faults (device 1 lost at request 750
   and back at 1200, oracle errors at 400 and 900, 50 ms decode spikes at
   300 and 1350 against a 25 ms deadline) on b12's virtual clock: every
   request a legal placement or a typed error, no exception out of
   ``submit``, no decode raised, no fallback that a deadline skip does
   not explain, recovery moving <= 0.25 of a scratch rebuild's bytes, and
   the service saved at request 1000 and restored into a fresh one
   serving the rest of the trace as the uninterrupted one does; (c) the
   hottest b11 job's first decode and last drift re-placement, and one
   evacuated b12 entry before the loss and after its failover, timed
   live with K1 (``measure_placement``) beside the oracle's price, and K1
   and its backward held to plain at each device's shapes and indices of
   each of these four placements.
13. (after phase 12) the LM train path (``launch/steps.make_train_step``,
   AdamW, chunked cross-entropy; K2 on the forward, K2-bwd on the
   attention backward): (a) h2o-danube-1.8b at full width and
   depth (24 layers, 1831201280 bf16 params, seeded as in phase 7), no
   remat, batch 2 x 4096 tokens (train_4k's sequence, its batch cut from
   256): 1 warm-up and 1 step timed by CUDA events, tokens/s, finite
   losses, peak memory, 24 K2 and 24 K2-bwd launches a step, then
   torch.profiler over one step (kernel ms, idle share, the shares of K2,
   of K2-bwd and of cuBLAS) and the attention backward alone on layer 0,
   then K2-bwd's yardstick on layer 0's q/k/v: the kernel, its plain
   version and SDPA's backward, beside the bound (10 hd FLOPs a pair and
   query head at the bf16 peak);
   (b) the same path at 2 layers in float32 on the card (K2) and on the
   CPU (plain): one step's loss (1e-5 relative), every gradient leaf
   (1e-4 of its largest) and the params after it (1e-6 where the gradient
   decides Adam's step, 2 lr elsewhere); (c) layer 0's real q/k/v of (a)'s
   first step (both rows): K2's training forward against plain by bf16
   ulps (``attention_ulp_err``: 2 ulps of |ref| + 2^-8 sum p|v|/l, rms
   1e-2; a mask one key wide must fail it, a scale 1% off is read), the
   op's dq/dk/dv (bf16 and float32, through K2-bwd) against a float64
   autograd of plain's arithmetic, and K2-bwd on the whole of both rows
   as phase 6c holds it; (d) qwen2.5-14b (QKV biases), phi4-mini-3.8b
   (tied embeddings) and granite-34b (one KV head) at full width cut to 2
   layers, bf16: K2 against plain by the same rule on layer 0's q/k/v of
   the train batch (2 x 1024, hd 128: groups 5, 3 and 48), one train step
   (finite loss) and one serve (a 2 x 1024-token prefill and 8 greedy
   decode steps).
14. (after phase 13) the MoE path (``models/layers.moe_apply``: the
   reference's block-local sort-based routing, the expert GEMMs as
   batched matmuls, the combine as ordered gathers and adds): (a)
   olmoe-1b-7b at full width and depth (16 layers, 64 experts, top-8,
   seeded bf16) served through ``launch.serve.serve``: 2 x 8192-token
   prompts and 16 tokens (prefill ms, decode ms a token, peak), then each
   layer's dropped-slot share on one more prefill; (b) the same weights
   trained by ``make_train_step`` (AdamW lr 3e-4, weight decay 0.1,
   ``moe_aux_weight`` 0.01, remat) on 2 x 4096 tokens: 1 warm-up and 1
   steps timed by CUDA events, tokens/s, peak, losses and load-balance
   losses, then torch.profiler over one step (the shares of the expert
   GEMMs, dispatch and combine, routing, K2-bwd and
   AdamW's foreach kernels; the idle share); (c) dbrx-132b at full width
   cut to 2 layers: a serve (2 x 1024 + 8 tokens) and a train step (2 x
   1024), peak; (d) K2 against plain by phase 13's ``attention_ulp_err``
   on layer 0's q/k/v of (a)'s prompts (8192), (b)'s batch (4096; 16
   heads, group 1) and (c)'s (48 / 8 heads, group 6); (e) olmoe and
   dbrx at SMOKE in float32 on the card and on the CPU: ``moe_apply``'s
   routes equal, output and load-balance loss within 1e-5, a train
   step's loss (1e-5) and gradients (1e-4), greedy decode tokens equal;
   and two card runs of bf16 ``moe_apply`` at olmoe's width bit-equal.
   Each leg prints its seconds.
15. (after phase 14) the hybrid SSM and RWKV path (``models/ssm``: the
   selective scan K3 and the WKV-6 scan K4): (a) hymba-1.5b at full width
   and depth (32 layers, seeded bf16) served through
   ``launch.serve.serve``: 2 x 8192-token prompts and 16 tokens (prefill
   ms, decode ms a token, tokens/s, peak, wall), K2 launched 32 times a
   prefill and K3 32 times a prefill and a decode step, no other kernel,
   the parameter tree equal to ``LM.param_layout``'s, then phase 7b's
   profile (each kernel class's share); (b) rwkv6-1.6b (24 layers) the
   same way, K4 24 times a prefill and a decode step; (c) K3
   and K4 on layer 0's real inputs of those prompts against their plain
   versions and a float64 run of the plain loop (phase 3b's rule; K3's
   bf16 y within one bf16 ulp of plain's), and K2 on hymba's layer 0 by
   ``attention_ulp_err`` (head dim 64, 25 query over 5 KV heads, window
   1024); K3's hT and float32 y and K4's sT equal plain's bit for bit;
   (d) both archs at SMOKE, seeded, float32, on the card and on the CPU:
   logits within 1e-4, 8 greedy tokens equal; (e) K3's and K4's medians
   of 10 after 2 warm-ups and their plain versions' one after 1 at the
   served shapes, beside the bound (K3's with its exponentials at the
   SFU's rate), each kernel's time at the decode shape (S 1), its
   registers and its resident warps an SM; it fails if a kernel takes
   half of the serial design's time or more (that design's prefill and
   decode times are printed beside (a)'s and (b)'s, not checked).  Each
   leg prints its seconds.
16. (after phase 15) training the hybrid SSM and RWKV blocks (K3's and
   K4's forward saving the state at every chunk's start; their backward
   kernels K3-bwd and K4-bwd recomputing each chunk from it and walking
   it back): (a) hymba-1.5b at full width and depth (32 layers,
   1641579200 seeded bf16 params) trained by ``make_train_step`` (AdamW,
   lr 3e-4, weight decay 0.1, no remat, as danube) on 2 x
   4096 tokens (train_4k's sequence, its batch cut from 256): 1 warm-up
   and 1 step timed by CUDA events, tokens/s, finite losses, every leaf
   moved (but the bf16 ones that rounding holds: norms at 1), the peak, K2, K3 and K3-bwd launched as many times a step as
   the path needs them and no other kernel, then torch.profiler over one
   step (``[ssm train profile]``: K3, K3-bwd, K2, K2-bwd,
   cuBLAS, AdamW, elementwise); (b) rwkv6-1.6b (24 layers, 1678264320
   params) the same way with K4 and K4-bwd; (c) K3-bwd and K4-bwd on
   layer 0's real train inputs (the forward's own arguments) and a
   seeded dy against the plain backward and its float64 run by phase
   3b's rule, every gradient, on the bf16 inputs and their float32
   values, each run twice with the same bits; (d) both archs at SMOKE,
   seeded, float32: one ``make_grad_fn`` step on the card and on the CPU
   (plain autograd), the loss within 1e-5 and every gradient leaf within
   1e-4 of its largest; (e) K3-bwd's and K4-bwd's medians of 10 after 2
   warm-ups at the train shapes beside the bound (the bytes, the float32
   operations, K3-bwd's exponentials at the SFU's rate), their registers,
   resident warps and spills, and the plain backward's time of (c).
   Each leg prints its seconds.
17. (after phase 16) the VLM and audio frontends (stub patch or frame
   embeddings, seeded on the host, in front of the token embeddings):
   (a) musicgen-large at full width and depth (48 layers, 2424506368
   seeded bf16 params, gelu, 32 heads of 64) served through
   ``launch.serve.serve``: 2 prompts of 256 frame embeddings + 7936
   tokens and 16 greedy tokens, the cache position counting the frames,
   then torch.profiler over one more prefill; the same weights trained
   by ``make_train_step`` (AdamW, lr 3e-4, weight decay 0.1, no remat) on
   ``LMBatchStream``'s batches of 2 x 4096 positions (256 frames, their
   labels masked, + 3840 tokens): 1 warm-up and 1 step timed by CUDA
   events, finite losses, the peak, then torch.profiler over one step;
   (b) llava-next-34b at full width and depth (60 layers, 34388917248
   seeded bf16 params) served the same way, 2 prompts of 2304 patch
   embeddings + 1792 tokens and 8 tokens, and at full width cut to 2
   layers trained the same way (2304 + 1792 positions, 1 warm-up and 1
   timed step); (c) K2 against plain by phase 13's
   ``attention_ulp_err`` on layer 0's real q/k/v of each served prompt
   (musicgen: hd 64, group 1; llava: hd 128, group 7); (d) both archs at
   SMOKE, seeded, float32, on the card (K2) and on the CPU (plain), the
   same embeds: prefill and decode logits within 1e-4, 8 greedy tokens
   equal, a ``make_grad_fn`` step's loss (1e-5) and gradients (1e-4).
   Every serve and train time prints ``mfu``.  Each leg prints its
   seconds.

18. (after phase 17) the LM under sharding rules (``production_rules()``:
   batch on ``data``, heads and channels on ``model``, FSDP on) on a 1 x 1
   ``(data, model)`` ``DeviceMesh`` over NCCL at one rank, the
   parameters DTensors placed by ``LM.param_specs`` and the kernels run
   on each rank's local shards: (a) hymba-1.5b at ``resolve(16)`` (32
   query heads, 7 of them padded and read through ``kv_map``; vocab
   32016) at full width and depth served through ``make_prefill_step`` /
   ``make_decode_step``: 2 x 8192-token prompts and 3 greedy steps, the
   cache placed by ``LM.cache_specs``, K2 and K3 launched as the path
   needs them and no other kernel; the same weights with ``NO_SHARDING``:
   logits and tokens bit-equal; (b) hymba-1.5b at ``resolve(16)``, 2
   layers, one ``make_grad_fn`` step on 2 x 4096 tokens under the rules
   against ``NO_SHARDING``: the loss and every gradient leaf bit-equal
   but the embedding's (the reference's one-hot matmul), held within as
   many bf16 steps at its largest entry as the batch's most repeated
   token's count;
   then ``make_train_step`` (AdamW) under the rules, 1 warm-up and 2
   timed steps (K2, K3, K3-bwd); (c) rwkv6-1.6b at 2 layers served as
   (a) (K4), bit-equal; (d) K2 on (a)'s layer 0 q/k/v at the padded-head
   shape by phase 13's ``attention_ulp_err``, K3 and K4 by phase 15's
   checks and K3-bwd by phase 16's, on the arguments the rules handed
   them; (e) olmoe-1b-7b at ``resolve(16)``, full width and depth (16
   layers, 64 experts top-8, the experts split over ``model``), served as
   (a): every MoE layer's rows through the all-to-all over the one-rank
   model group (a real NCCL ``all_to_all_single``, counted), K2 on the
   local heads, the dropped-slot share by layer; logits and tokens
   bit-equal to ``NO_SHARDING``'s; (f) olmoe-1b-7b at 2 layers trained
   as (b): the loss and the load-balance loss bit-equal, every gradient
   leaf within 2 bf16 steps at its largest entry (K2).  Each leg prints
   its seconds, peaks, times and ``mfu``.
19. (after phase 18, which destroys its process group) the dry-run held
   to the card (``launch/dryrun``): a process group of torch's ``fake``
   backend with one rank, a 1 x 1 mesh on it, and 18's legs (e), (f) and
   (b) traced on fake CUDA tensors as 18 runs them (``TraceMode``: every
   local op counted once, the kernels' stand-ins, nothing allocated or
   launched).  For each leg the predicted peak (18's bytes at the leg's
   start plus the trace's peak of live bytes) must lie within 0.85-1.15x
   of 18's ``max_memory_allocated``, the counted FLOPs of a prefill, a
   decode step and a train step must reach ``model_flops`` less the
   embedding's share where the call gathers it, (e) must trace as many
   ``all_to_all_single`` as 18 counted, and no kernel's launch counter
   may move; it prints ``compute_s`` and ``memory_s`` beside the measured
   ms and the traced collectives by op.

Every LM line (phases 7, 13-18) prints ``mfu``, the model FLOP
utilisation: ``launch/roofline.model_flops`` at the smoke's own batch and
sequence over the measured time at the card's bf16 peak
(``roofline.PEAK_FLOPS``, where this script takes its peaks from).

It prints each phase's seconds, the kernel line (one JSON object with a
``kernels`` list; each kernel's launches summed over the paths it serves,
each path's counted from zero) and then, as its last line, ``{"ok": true,
"device": {...}}``.  Without a CUDA device it exits 1 and prints no
result.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# the card's peaks have one home, the port's roofline module
from repro_torch.launch.roofline import HBM_BW, PEAK_FLOPS  # noqa: E402

HBM_BYTES_PER_S = HBM_BW         # H100 SXM device memory
F32_FLOP_PER_S = 67e12           # H100 SXM float32 outside the tensor cores
SFU_EXP_PER_S = 16 * 132 * 1.98e9  # H100 SXM MUFU.EX2: 16 a clock an SM
BF16_FLOP_PER_S = PEAK_FLOPS     # H100 SXM bf16 tensor cores, dense
BATCH = 65536                    # the paper's DLRM batch
MAX_ROWS = 2 ** 20
N_MEASURED_TASKS = 2
SIM2REAL_TASKS = 1               # phase 8: trained placements timed live
ARCH = "h2o-danube-1.8b"
SERVE_BATCH = 2                  # two prompts of two windows each
SERVE_PROMPT = 8192
SERVE_TOKENS = 16
TRAIN_TASKS = 16                 # the table1_main quick regime
CROSS_STEPS = 50
PROFILE_COST_STEPS = 30          # phase 8's profile of the training stages
PROFILE_RL_STEPS = 2
DLRM_STEPS = 3                   # phase 10: 1 warm-up + 2 timed steps
DLRM_WARMUP = 1
K1_BWD_KERNELS = ("compact_kernel", "radix_hist_kernel", "radix_scan_kernel",
                  "radix_scatter_kernel", "runs_kernel", "chunks_kernel",
                  "pass1_kernel", "zero_rows_kernel", "long_runs_kernel")


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def allclose_err(out, ref, tol: float) -> float:
    """Max |out - ref|; raises unless |out - ref| <= tol + tol * |ref|."""
    diff = (out - ref).abs()
    check(bool((diff <= tol + tol * ref.abs()).all()),
          f"max |err| {float(diff.max())} over tolerance {tol}")
    return float(diff.max()) if diff.numel() else 0.0


def attention_err(out, ref, *, max_abs: float, rel_rms: float) -> dict:
    """An attention output's errors against plain, in float32; raises
    unless max |out - ref| <= max_abs and ||out - ref|| / ||ref|| <=
    rel_rms.  ``mean_abs_ref`` comes back with them, so a limit can be read
    against a typical output: one as large as the output would let a wrong
    mask through."""
    ref = ref.float()
    diff = out.float() - ref
    worst = int(diff.abs().argmax())
    err = {"max_abs_err": float(diff.abs().max()),
           "rel_rms_err": float(diff.norm() / ref.norm()),
           "mean_abs_ref": float(ref.abs().mean()),
           # the query row of the largest error, and |ref| there
           "worst_row": worst // (diff.shape[-1] * diff.shape[-2])
           % diff.shape[1],
           "worst_abs_ref": float(ref.reshape(-1)[worst].abs()),
           "limits": [max_abs, rel_rms]}
    check(err["max_abs_err"] <= max_abs and err["rel_rms_err"] <= rel_rms,
          f"attention against plain: {err}")
    return err


def bf16_ulp(torch, x):
    """One bfloat16 ulp at |x| (8 significant bits): 2^(e - 8) where |x| =
    f * 2^e, f in [0.5, 1); 0 where x is 0."""
    _, e = torch.frexp(x.float().abs())
    return torch.where(x == 0, 0.0, torch.ldexp(torch.ones_like(x.float()),
                                                e - 8))


K2_BF16_ULPS = 2                 # phases 6b, 13 (c), (d): K2's bf16 vs plain
K2_BF16_REL_RMS = 1e-2


def attention_ulp_err(torch, out, ref, abs_ref, *, ulps: float,
                      rel_rms: float, enforce: bool = True) -> dict:
    """A bf16 attention output's errors against plain's (a bf16 value too),
    elementwise by K2's error model: raises unless every

        |out - ref| <= ulps x one bf16 ulp of |ref| + 2^-8 x abs_ref

    and ||out - ref|| / ||ref|| <= rel_rms.  ``abs_ref`` is plain's output
    with |v| for v, sum_j p_j |v_j| / l: K2 rounds P to bf16 (2^-9
    relative) before its P.V product, which moves an output by at most
    2^-9 of that sum, and each side's rounding to bf16 by half an ulp.
    ``share`` is the largest |out - ref| over its limit (the check is share
    <= 1); ``max_ulps`` the largest |out - ref| in ulps of |ref| where |ref|
    >= mean |ref|.  With ``enforce=False`` it only reads (a faulty
    control)."""
    ref = ref.float()
    diff = (out.float() - ref).abs()
    ulp = bf16_ulp(torch, ref)
    ratio = diff / (ulps * ulp + 2.0 ** -8 * abs_ref.float())
    big = ref.abs() >= ref.abs().mean()
    worst = int(ratio.argmax())
    err = {"max_abs_err": float(diff.max()),
           "share": float(ratio.max()),
           "max_ulps": float((diff / ulp.clamp_min(1e-30))[big].max()),
           "rel_rms_err": float(diff.norm() / ref.norm()),
           "mean_abs_ref": float(ref.abs().mean()),
           "worst_row": worst // (diff.shape[-1] * diff.shape[-2])
           % diff.shape[1],
           "worst_abs_ref": float(ref.reshape(-1)[worst].abs()),
           "worst_abs_err": float(diff.reshape(-1)[worst]),
           "limits": [ulps, rel_rms]}
    if enforce:
        check(err["share"] <= 1 and err["rel_rms_err"] <= rel_rms,
              f"attention against plain (bf16 ulps): {err}")
    return err


def _ulp_line(err: dict) -> str:
    return (f"max |err| / limit {err['share']:.3g} (limit 1: "
            f"{err['limits'][0]:g} ulps of |ref| + 2^-8 sum p|v|/l; at query "
            f"row {err['worst_row']}, |err| {err['worst_abs_err']:.3g}, |ref| "
            f"{err['worst_abs_ref']:.3g}), max |err| {err['max_abs_err']:.3g},"
            f" {err['max_ulps']:.3g} ulps where |ref| >= mean |ref| "
            f"{err['mean_abs_ref']:.3g}; rms err / rms ref "
            f"{err['rel_rms_err']:.3g} (limit {err['limits'][1]:.3g})")


def _err_line(err: dict) -> str:
    return (f"max |err| {err['max_abs_err']:.3g} (limit "
            f"{err['limits'][0]:.3g}; at query row {err['worst_row']}, "
            f"|ref| {err['worst_abs_ref']:.3g}), rms err / rms ref "
            f"{err['rel_rms_err']:.3g} (limit {err['limits'][1]:.3g}), "
            f"mean |ref| {err['mean_abs_ref']:.3g}")


def phase_device() -> str:
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(line.splitlines()[0] if line else "nvidia-smi: no output")
    check(bool(line), "nvidia-smi printed nothing")
    return line.splitlines()[0]


def ptxas_functions(build_log: str) -> list:
    """(function, spill line, registers line) of each kernel that
    ``ptxas -v`` reports in a build log."""
    lines = build_log.splitlines()
    out = []
    for i, ln in enumerate(lines):
        if "Function properties for" in ln and i + 2 < len(lines):
            name = ln.split("Function properties for")[-1].strip()
            out.append((name, lines[i + 1].strip(),
                        lines[i + 2].split("ptxas info    :")[-1].strip()))
    return out


def kernel_label(mangled: str) -> str:
    """A kernel instance's name with its template arguments, e.g.
    ``flash_fwd_tc_kernel<80>`` or ``segment_sum_kernel<F32, 1>``."""
    m = re.search(r"\d([a-z][a-z_]*_kernel)I(.*?)EE", mangled)
    if m is None:
        return mangled[:72]
    args = re.findall(r"Li(\d+)|(F32|Bf16)Chunk|Lb([01])", m[2])
    return f"{m[1]}<{', '.join(''.join(a) for a in args)}>"


def _report_build(library, secs: float, no_spill: str | None) -> None:
    """Print a built library's ptxas lines; with ``no_spill``, fail if
    ptxas reports a spill in a function whose name holds it."""
    log(f"[build] {os.path.relpath(library.path(), ROOT)} in {secs:.2f} s")
    funcs = ptxas_functions(library.build_log)
    for name, spill, regs in funcs:
        log(f"[build] {kernel_label(name)}: {spill}; {regs}")
    if no_spill is not None:
        mine = [f for f in funcs if no_spill in f[0]]
        check(bool(mine), f"ptxas reported no {no_spill} instance")
        for name, spill, _ in mine:
            check("0 bytes spill stores, 0 bytes spill loads" in spill,
                  f"{name} spills: {spill}")


def phase_build(builds) -> dict:
    """Build the libraries together, one nvcc each; ``builds`` maps a
    name to ``(library, no_spill)``.  Returns each build's seconds."""

    def timed(library):
        t0 = time.perf_counter()
        library.build()
        return time.perf_counter() - t0

    with ThreadPoolExecutor(len(builds)) as pool:
        futures = {name: pool.submit(timed, lib)
                   for name, (lib, _) in builds.items()}
        secs = {name: f.result() for name, f in futures.items()}
    for name, (lib, no_spill) in builds.items():
        _report_build(lib, secs[name], no_spill)
    return secs


def check_idle(counters, busy, where: str) -> None:
    """Fail if a kernel other than those in ``busy`` launched on a path
    (every count was set to 0 at the path's start)."""
    idle = {type(c).__name__: c.launches for c in counters
            if all(c is not b for b in busy)}
    check(not any(idle.values()), f"{where}: other kernels launched: "
          f"{idle}")


def bits_equal(torch, out, ref) -> bool:
    """Same dtype, shape and bits (+0 and -0 differ here); float32 or a
    2-byte float."""
    view = torch.int16 if out.element_size() == 2 else torch.int32
    return out.dtype == ref.dtype and out.shape == ref.shape and torch.equal(
        out.contiguous().view(view), ref.contiguous().view(view))


# every LM train path, each of which must launch K2-bwd
LM_TRAIN_PATHS = ("lm train", "lm train cuda vs cpu", "dense configs",
                  "moe train", "dbrx", "moe cuda vs cpu", "hybrid train",
                  "ssm train cuda vs cpu", "frontend train musicgen-large",
                  "frontend train llava-next-34b", "frontend cuda vs cpu",
                  "sharded train", "sharded olmoe train")


def k2_bwd_record(summary: dict, path: str, n: int) -> None:
    """Add K2-bwd's ``n`` launches to ``path``'s count in
    ``summary["k2_bwd_paths"]`` (the kernels line reads it); fail if it is
    0: every LM train path runs the attention backward through the
    kernel."""
    check(n > 0, f"{path}: K2-bwd launched {n} times")
    paths = summary.setdefault("k2_bwd_paths", {})
    paths[path] = paths.get(path, 0) + n


def _row0(torch, arena, kind: str) -> None:
    """Row 0 as a case needs it: random (left as drawn), +0, -0, or +0
    and -0 mixed."""
    if kind == "+0":
        arena[0] = 0.0
    elif kind == "-0":
        arena[0] = -0.0
    elif kind == "mixed":
        arena[0] = 0.0
        arena[0, ::3] = -0.0


def phase_kernel_checks(torch, np, K, plain) -> int:
    """K1's forward against the plain version on the card, bit for bit;
    returns the number of cases."""
    cases = 0

    def exact(arena, idx, what):
        nonlocal cases
        out = K.embedding_bag_cuda(arena, idx)
        ref = plain(arena, idx)
        torch.cuda.synchronize()
        check(bits_equal(torch, out, ref), f"K1 != plain bit for bit: {what}"
              f", max |err| {float((out - ref).abs().max()):.3g}")
        cases += 1

    for rows in (8, 100, 1000):
        for dim in (128, 256):
            for pool in (1, 4, 16):
                for dtype in (torch.float32, torch.bfloat16):
                    rng = np.random.default_rng(rows * dim + pool)
                    arena = torch.as_tensor(
                        rng.normal(size=(rows, dim)), dtype=torch.float32,
                        device="cuda").to(dtype)
                    idx = torch.as_tensor(
                        rng.integers(0, rows, (12, pool)), dtype=torch.int32,
                        device="cuda")
                    exact(arena, idx, f"sweep {rows} {dim} {pool} {dtype}")
    # padding (index 0) at arbitrary positions, over a row 0 of each kind;
    # the first bags are all padding, padded in front, and padded behind
    for pool in (1, 31, 32, 33, 199):
        for dim in (128, 384):
            for dtype in (torch.float32, torch.bfloat16):
                for kind in ("random", "+0", "-0", "mixed"):
                    rng = np.random.default_rng(7 * pool + dim)
                    arena = torch.as_tensor(
                        rng.normal(size=(500, dim)), dtype=torch.float32,
                        device="cuda").to(dtype)
                    _row0(torch, arena, kind)
                    idx = rng.integers(1, 500, (300, pool))
                    idx[rng.random(idx.shape) < 0.7] = 0
                    idx[0] = 0
                    idx[1, :pool // 2] = 0
                    idx[2, pool // 2:] = 0
                    exact(arena, torch.as_tensor(idx, dtype=torch.int32,
                                                 device="cuda"),
                          f"padding P={pool} D={dim} {dtype} row 0 {kind}")
    arena = torch.randn((50, 128), device="cuda")
    arena[0] = 0.0
    out = K.embedding_bag_cuda(arena, torch.zeros((4, 8), dtype=torch.int32,
                                                  device="cuda"))
    torch.cuda.synchronize()
    check(bool((out == 0).all()), "all-padding bags must sum to zero")
    cases += 1
    # arenas past 2^31 elements: row * D overflows 32 bits there
    n_rows = 2 ** 24 + 2 ** 20
    gen = torch.Generator(device="cuda").manual_seed(0)
    for dtype in (torch.float32, torch.bfloat16):
        arena = torch.randn((n_rows, 128), generator=gen, device="cuda",
                            dtype=torch.float32).to(dtype)
        arena[0] = 0
        idx = torch.randint(n_rows - 2 ** 21, n_rows, (8192, 8),
                            generator=gen, device="cuda", dtype=torch.int32)
        idx[:, -1] = 0
        exact(arena, idx, f"{dtype} arena of {arena.numel()} elements")
        log(f"[kernel] {dtype} arena of {arena.numel()} elements "
            f"({arena.numel() * arena.element_size() / 2**30:.2f} GiB): ok")
        del arena, idx
    torch.cuda.empty_cache()
    log(f"[kernel] K1 == plain bit for bit on {cases} cases")
    return cases


def grad_f64(torch, arena_shape, idx, grad_out):
    """The arena's gradient by a float64 ``index_add_``: the reference
    both the kernel and the plain version are held to."""
    g = torch.zeros(tuple(arena_shape), dtype=torch.float64,
                    device=grad_out.device)
    src = grad_out.double()
    for j in range(idx.shape[1]):
        g.index_add_(0, idx[:, j], src)
    g[0] = 0.0
    return g


def grad_errs(torch, out, plain_out, ref64) -> tuple:
    """(kernel's, plain's) max |err| against float64; raises unless the
    kernel's is at most twice the plain version's plus 1e-6."""
    err = float(out.double().sub_(ref64).abs_().max())
    plain_err = float(plain_out.double().sub_(ref64).abs_().max())
    check(err <= 2 * plain_err + 1e-6, f"K1 backward max |err| {err:.3g} "
          f"against float64 over 2 x plain's {plain_err:.3g} + 1e-6")
    return err, plain_err


def plan_equal(torch, K, shape, idx) -> bool:
    """The backward's plan built on the card equals ``backward_plan``'s,
    array for array."""
    got = K.embedding_bag_grad_cuda.plan(shape, idx).to_backward_plan()
    ref = K.backward_plan(idx, K.CHUNK)
    return all(a.shape == b.shape and torch.equal(a.long(), b.long())
               for a, b in zip(got, ref))


def grad_no_sync(torch, K, shape, idx, g):
    """K1's backward under ``set_sync_debug_mode("error")``: a host sync
    inside it raises."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        return K.embedding_bag_grad_cuda(shape, idx, g)
    finally:
        torch.cuda.set_sync_debug_mode("default")


def phase_grad_checks(torch, np, K, grad_plain, replay) -> dict:
    """K1's backward against the plain version (and float64) on the card;
    returns the worst errors."""
    worst = {"max_abs_err_vs_plain": 0.0, "err_vs_f64": 0.0,
             "plain_err_vs_f64": 0.0, "cases": 0}
    # (rows, dim, bags, pool, hot share, padding share): a hot row makes a
    # run longer than the chunk, or past chunk^2 (chunks of sqrt(L) slots)
    for R, D, N, P, hot, pad in ((1000, 128, 512, 8, 0.0, 0.3),
                                 (1000, 384, 4096, 33, 0.5, 0.5),
                                 (300, 128, 20000, 40, 0.9, 0.2),
                                 (70000, 128, 2048, 199, 0.3, 0.9)):
        for dtype in (torch.float32, torch.bfloat16):
            rng = np.random.default_rng(R + N + P)
            idx = rng.integers(1, R, (N, P))
            idx[rng.random(idx.shape) < hot] = 1 + rng.integers(0, 3)
            idx[rng.random(idx.shape) < pad] = 0
            idx[:3] = 0                            # all-padding bags
            idx = torch.as_tensor(idx, dtype=torch.int32, device="cuda")
            shape = (R, D)
            for integer in (True, False):
                g = (torch.as_tensor(rng.integers(-2, 3, (N, shape[1])))
                     if integer else torch.as_tensor(
                         rng.normal(size=(N, shape[1]))))
                g = g.to(device="cuda", dtype=torch.float32).to(dtype)
                out = grad_no_sync(torch, K, shape, idx, g)
                again = K.embedding_bag_grad_cuda(shape, idx, g)
                ref = grad_plain(shape, idx, g)
                again_plain = replay(shape, idx, g)
                torch.cuda.synchronize()
                what = f"R={R} N={N} P={P} {dtype} integer={integer}"
                check(bits_equal(torch, out, again),
                      f"two backward launches differ: {what}")
                check(bits_equal(torch, out, again_plain),
                      f"backward != its plain replay: {what}")
                check(not bool(out[0].any()), f"row 0 not zero: {what}")
                check(plan_equal(torch, K, shape, idx),
                      f"the plan on the card != backward_plan: {what}")
                if integer:
                    check(bits_equal(torch, out, ref),
                          f"backward != plain on integers: {what}")
                else:
                    err, plain_err = grad_errs(
                        torch, out, ref, grad_f64(torch, shape, idx, g))
                    worst["err_vs_f64"] = max(worst["err_vs_f64"], err)
                    worst["plain_err_vs_f64"] = max(
                        worst["plain_err_vs_f64"], plain_err)
                worst["max_abs_err_vs_plain"] = max(
                    worst["max_abs_err_vs_plain"],
                    float((out - ref).abs().max()))
                worst["cases"] += 1
    # a gradient past 2^31 elements: row * D overflows 32 bits there
    n_rows = 2 ** 24 + 2 ** 20
    gen = torch.Generator(device="cuda").manual_seed(3)
    idx = torch.randint(n_rows - 2 ** 21, n_rows, (8192, 8), generator=gen,
                        device="cuda", dtype=torch.int32)
    idx[:, -1] = 0
    g = torch.randint(-2, 3, (8192, 128), generator=gen, device="cuda").float()
    out = grad_no_sync(torch, K, (n_rows, 128), idx, g)
    check(bits_equal(torch, out, grad_plain((n_rows, 128), idx, g)),
          "backward != plain on a gradient past 2^31 elements")
    check(plan_equal(torch, K, (n_rows, 128), idx),
          "the plan on the card != backward_plan past 2^31 elements")
    worst["cases"] += 1
    del out
    torch.cuda.empty_cache()
    log(f"[kernel] K1 backward on {worst['cases']} cases: no host sync, its "
        "plan on the card equal to backward_plan, bit-equal to its "
        "plain replay and across launches, to plain on integer gradients; "
        f"max |err| against float64 {worst['err_vs_f64']:.3g} (plain's "
        f"{worst['plain_err_vs_f64']:.3g}), against plain "
        f"{worst['max_abs_err_vs_plain']:.3g}")
    return worst


def phase_main_path(torch, np, K, counters, summary: dict):
    from repro_torch import telemetry as tele
    from repro_torch.api import (SimOracle, make_baseline_placers,
                                 measure_placements)
    from repro_torch.core.trainer import DreamShard, DreamShardConfig
    from repro_torch.data.synthetic import make_dlrm_pool
    from repro_torch.data.tasks import make_benchmark_suite
    from repro_torch.profiling.microbench import measure_placement

    pool = make_dlrm_pool(seed=0)
    train, test = make_benchmark_suite(pool, n_tables=50, n_devices=4,
                                       n_tasks=20)
    oracle = SimOracle(seed=0)
    tele.reset()
    tele.enable()
    for c in counters:                         # counts of this path only
        c.launches = 0

    agent = DreamShard(train, oracle, DreamShardConfig(seed=0),
                       device="cuda")
    placer = agent.as_placer(n_candidates=16)
    decode = {}
    for run in ("cold", "warm"):
        tele.reset()
        t0 = time.perf_counter()
        placements = placer.place_many(test)
        wall = (time.perf_counter() - t0) * 1e3
        spans = [ev for ev in tele.get_tracer().snapshot_events()
                 if ev[0] == "session.decode"]
        for _name, _ts, dur_us, *_rest, args in spans:
            log(f"[decode] {run}: bucket m_pad={args['m_pad']} "
                f"D={args['n_devices']} tasks={args['tasks']} "
                f"b_pad={args['b_pad']}: {dur_us / 1e3:.2f} ms")
        decode[run] = {"place_many_ms": wall,
                       "bucket_ms": [ev[2] / 1e3 for ev in spans]}
        log(f"[decode] {run}: place_many of {len(test)} tasks {wall:.2f} ms")
    summary["decode"] = decode
    for task, p in zip(test, placements):
        check(p.assignment.shape == (task.n_tables,), "assignment shape")
        check(bool(((p.assignment >= 0) & (p.assignment < 4)).all()),
              "device ids in range")
        check(math.isfinite(p.est_cost_ms), "finite estimated cost")
    # the session equals per-task Algorithm 2, and the card's greedy decode
    # equals the CPU's from the same seed
    cpu_agent = DreamShard(train, oracle, DreamShardConfig(seed=0),
                           device="cpu")
    for task, p in zip(test[:N_MEASURED_TASKS], placements):
        a, est = agent.place_detailed(task.raw_features, task.n_devices)
        check(bool((a == p.assignment).all()), "session == per-task place")
        g_cuda, e_cuda = agent.place_detailed(task.raw_features,
                                              task.n_devices, 1)
        g_cpu, e_cpu = cpu_agent.place_detailed(task.raw_features,
                                                task.n_devices, 1)
        check(bool((g_cuda == g_cpu).all()), "greedy decode cuda == cpu")
        check(abs(e_cuda - e_cpu) <= 1e-4 * abs(e_cpu), "estimate cuda~cpu")
    log("[decode] session == per-task place; greedy cuda == cpu")

    sim_costs = {"dreamshard": measure_placements(oracle, test, placements)}
    by_strategy = {"dreamshard": placements}
    for name, bp in make_baseline_placers(oracle).items():
        by_strategy[name] = bp.place_many(test)
        sim_costs[name] = measure_placements(oracle, test, by_strategy[name])
    for name, c in sim_costs.items():
        check(bool(np.isfinite(c).all()), f"{name}: finite simulated costs")
        log(f"[sim] {name:11s} mean simulated cost over {len(test)} tasks "
            f"{float(np.mean(c)):.3f} ms (2080Ti-fitted model)")
    summary["sim_mean_ms"] = {k: float(np.mean(v))
                              for k, v in sim_costs.items()}

    measured = []
    shapes = []
    for ti, task in enumerate(test[:N_MEASURED_TASKS]):
        for name in ("dreamshard", "size", "dim", "lookup", "size_lookup"):
            a = by_strategy[name][ti].assignment
            t0 = time.perf_counter()
            res = measure_placement(task.raw_features, a, task.n_devices,
                                    batch_size=BATCH, pooling=None,
                                    max_rows=MAX_ROWS, device="cuda")
            wall = time.perf_counter() - t0
            sim = oracle.evaluate(task.raw_features, a, task.n_devices)
            counts = np.bincount(a, minlength=task.n_devices)
            for d in range(task.n_devices):
                used = counts[d] > 0
                check(bool(np.isfinite(res.fwd_comp[d])
                           and np.isfinite(res.bwd_comp[d])), "finite ms")
                check((res.fwd_comp[d] > 0) == used
                      and (res.bwd_comp[d] > 0) == used,
                      "positive times exactly on used devices")
            log(f"[measure] task {ti} {name:11s} tables/dev "
                f"{counts.tolist()} fwd ms "
                f"{np.round(res.fwd_comp, 3).tolist()} bwd ms "
                f"{np.round(res.bwd_comp, 3).tolist()} overall "
                f"{res.overall:.3f} ms | simulated {sim.overall:.3f} ms "
                f"| wall {wall:.1f} s")
            measured.append({
                "task": ti, "strategy": name,
                "tables_per_device": counts.tolist(),
                "fwd_ms": res.fwd_comp.tolist(),
                "bwd_ms": res.bwd_comp.tolist(),
                "overall_ms": res.overall, "sim_overall_ms": sim.overall})
            shapes += [task.raw_features[a == d]
                       for d in range(task.n_devices) if counts[d]]
    launches = K.embedding_bag_cuda.launches
    bwd_launches = K.embedding_bag_grad_cuda.launches
    check_idle(counters, (K.embedding_bag_cuda, K.embedding_bag_grad_cuda),
               "the main path")
    tele.disable()
    summary["measured"] = measured
    check(launches > 0, "the main path launched K1 no time")
    check(bwd_launches > 0, "the main path launched K1's backward no time")
    slowest = [max(m["bwd_ms"]) for m in measured]
    summary["slowest_device_bwd_ms"] = slowest
    log(f"[main] slowest device's bwd ms per measured placement: "
        f"{min(slowest):.3f} to {max(slowest):.3f}")
    log(f"[main] K1 launches on the main path: {launches} forward, "
        f"{bwd_launches} backward")
    return launches, bwd_launches, shapes


def phase_yardstick(torch, np, K, plain, shapes, summary: dict) -> tuple:
    """K1's forward, plain and F.embedding_bag at the largest main-path
    device; returns the kernel's row and the inputs, for the backward."""
    from repro_torch.core import features as FEAT
    from repro_torch.profiling.microbench import (device_tables,
                                                  make_fused_inputs,
                                                  median_time_ms)
    sub = max(shapes, key=lambda s: float(
        device_tables(s, MAX_ROWS, None)[1].max() * len(s)))
    rows, pools = device_tables(sub, MAX_ROWS, None)
    arena, idx, _ = make_fused_inputs(sub[:, FEAT.DIM], rows, BATCH, pools,
                                      seed=0, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    arena.normal_(generator=gen)
    arena[0] = 0.0
    n, p = idx.shape
    dim = arena.shape[1]
    with torch.no_grad():
        out = K.embedding_bag_cuda(arena, idx)
        ref = plain(arena, idx)
        torch.cuda.synchronize()
        check(bits_equal(torch, out, ref), "K1 != plain at the yardstick")
        err = float((out - ref).abs().max())
        del out, ref
        ms = median_time_ms(K.embedding_bag_cuda, (arena, idx), warmup=2,
                            repeats=10)
        plain_ms = median_time_ms(plain, (arena, idx), warmup=1, repeats=3)
        lib = torch.nn.functional.embedding_bag
        lib_out = lib(idx, arena, mode="sum")
        allclose_err(lib_out, plain(arena, idx), 1e-4)
        del lib_out
        library_ms = median_time_ms(lambda i, w: lib(i, w, mode="sum"),
                                    (idx, arena), warmup=2, repeats=10)
        seen = torch.zeros(arena.shape[0], dtype=torch.bool, device="cuda")
        seen[idx.reshape(-1).long()] = True
        distinct = int(seen.sum())
        slots = int((idx != 0).sum())
        del seen
    nbytes = (distinct * dim * arena.element_size() + idx.numel() * 4
              + n * dim * 4)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = slots * dim / F32_FLOP_PER_S * 1e3
    row = {"name": "embedding_bag", "route": "cuda",
           "source": "src/repro_torch/csrc/embedding_bag.cu",
           "replaces": "src/repro/kernels/embedding_bag/kernel.py:50",
           "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": max(bytes_ms, ops_ms),
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
           "library_ms": library_ms}
    summary["yardstick"] = {
        "tables": int(len(sub)), "arena_rows": int(arena.shape[0]),
        "bags": int(n), "pool": int(p), "dim": int(dim),
        "distinct_rows": distinct, "nonpadding_slots": slots,
        "bytes": int(nbytes), "bytes_ms": bytes_ms, "ops_ms": ops_ms,
        "bound_share": row["bound_ms"] / ms, **row}
    log(f"[yardstick] {len(sub)} tables, arena {arena.shape[0]} x {dim} f32, "
        f"idx {n} x {p}, {distinct} distinct rows, {slots} non-padding "
        f"slots: K1 {ms:.3f} ms ({row['bound_ms'] / ms:.1%} of the bound), "
        f"plain {plain_ms:.3f} ms, F.embedding_bag {library_ms:.3f} ms, "
        f"bound {row['bound_ms']:.3f} ms ({row['bound_by']}); bit-equal to "
        "plain")
    check(ms < library_ms, f"K1 {ms:.3f} ms is not faster than "
          f"F.embedding_bag {library_ms:.3f} ms")
    return row, (arena, idx, slots)


def phase_grad_yardstick(torch, K, grad_plain, inputs,
                         summary: dict) -> dict:
    """K1's backward, plain and F.embedding_bag's backward on the forward's
    yardstick inputs, beside the memory bound."""
    from repro_torch.profiling.microbench import median_time_ms
    arena, idx, slots = inputs
    shape = tuple(arena.shape)
    n, dim = idx.shape[0], shape[1]
    gen = torch.Generator(device="cuda").manual_seed(4)
    g = torch.randn((n, dim), generator=gen, device="cuda")
    ones = torch.randint(-1, 2, (n, dim), generator=gen,
                         device="cuda").float()
    with torch.no_grad():
        # integer-valued: every sum is exact, so the kernel equals plain
        out = K.embedding_bag_grad_cuda(shape, idx, ones)
        check(bits_equal(torch, out, grad_plain(shape, idx, ones)),
              "K1 backward != plain on integers at the yardstick")
        out = K.embedding_bag_grad_cuda(shape, idx, g)
        check(bits_equal(torch, out, K.embedding_bag_grad_cuda(shape, idx,
                                                               g)),
              "two K1 backward launches differ at the yardstick")
        ref = grad_plain(shape, idx, g)
        err_vs_plain = float((out - ref).abs().max())
        err, plain_err = grad_errs(torch, out, ref,
                                   grad_f64(torch, shape, idx, g))
        del out
        torch.cuda.empty_cache()
        check(plan_equal(torch, K, shape, idx),
              "the plan on the card != backward_plan at the yardstick")
        grad_no_sync(torch, K, shape, idx, g)
        torch.cuda.empty_cache()
        ms = median_time_ms(K.embedding_bag_grad_cuda, (shape, idx, g),
                            warmup=2, repeats=10)
        # its stages, each by its own events: the plan, pass 1 and the
        # write pass, on one plan and one set of partials
        kern = K.embedding_bag_grad_cuda
        plan = kern.plan(shape, idx)
        grad = torch.empty(shape, dtype=torch.float32, device="cuda")
        partials = kern.pass1(grad, plan, g)
        stage_ms = {
            "plan": median_time_ms(lambda i: kern.plan(shape, i), (idx,),
                                   warmup=2, repeats=10),
            "pass1": median_time_ms(lambda x: kern.pass1(grad, plan, x),
                                    (g,), warmup=2, repeats=10),
            "write": median_time_ms(
                lambda x: kern.write(grad, plan, partials), (g,),
                warmup=2, repeats=10)}
        live = dict(zip(("slots", "runs", "chunks", "partials"),
                        plan.counts.tolist()))
        sizes = plan.sizes
        scratch = K.scratch_bytes(sizes, dim)
        del plan, partials, grad
        torch.cuda.empty_cache()
        torch_plan_ms = median_time_ms(lambda i: K.backward_plan(i, K.CHUNK),
                                       (idx,), warmup=2, repeats=10)
        plain_ms = median_time_ms(grad_plain, (shape, idx, g), warmup=1,
                                  repeats=3)
    weight = arena.requires_grad_()
    lib_out = torch.nn.functional.embedding_bag(idx, weight, mode="sum",
                                                padding_idx=0)

    def lib_grad(grad):
        return torch.autograd.grad(lib_out, weight, grad,
                                   retain_graph=True)[0]
    lib_err = float((lib_grad(g) - ref).abs().max())
    scale = float(ref.abs().max())
    check(lib_err <= 1e-3 * scale, f"F.embedding_bag's backward differs "
          f"from plain by {lib_err:.3g} (max |ref| {scale:.3g})")
    del ref
    torch.cuda.empty_cache()
    library_ms = median_time_ms(lib_grad, (g,), warmup=1, repeats=3)
    del lib_out, weight, arena
    nbytes = (shape[0] * dim * 4 + idx.numel() * 4
              + g.numel() * g.element_size())
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = slots * dim / F32_FLOP_PER_S * 1e3
    row = {"name": "embedding_bag_grad", "route": "cuda",
           "source": "src/repro_torch/csrc/embedding_bag.cu",
           "replaces": "src/repro/kernels/embedding_bag/ref.py:15",
           "max_abs_err": err_vs_plain, "max_abs_err_vs_f64": err,
           "plain_max_abs_err_vs_f64": plain_err, "ms": ms,
           "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
           "library_ms": library_ms}
    summary["grad_yardstick"] = {
        "bytes": int(nbytes), "bytes_ms": bytes_ms, "ops_ms": ops_ms,
        "bound_share": row["bound_ms"] / ms, "stage_ms": stage_ms,
        "backward_plan_ms": torch_plan_ms, "live": live,
        "radix_passes": sizes.passes, "scratch_bytes": scratch,
        "library_err_vs_plain": lib_err, **row}
    log(f"[yardstick] K1 backward, grad ({n}, {dim}) f32 into ({shape[0]}, "
        f"{dim}): {ms:.3f} ms (plan included; {row['bound_ms'] / ms:.1%} of "
        f"the bound), plain {plain_ms:.3f} ms, F.embedding_bag backward "
        f"{library_ms:.3f} ms, bound {row['bound_ms']:.3f} ms "
        f"({row['bound_by']})")
    log(f"[yardstick] K1 backward's stages, each by its own events: the "
        f"plan on the card {stage_ms['plan']:.3f} ms ({sizes.passes} radix "
        f"passes), pass 1 {stage_ms['pass1']:.3f} ms, the write pass "
        f"{stage_ms['write']:.3f} ms; backward_plan in torch "
        f"{torch_plan_ms:.3f} ms; live {live}; scratch {scratch} bytes "
        f"beside the {shape[0] * dim * 4}-byte gradient; no host sync, the "
        "plan equal to backward_plan")
    log(f"[yardstick] K1 backward max |err| against float64 {err:.3g} "
        f"(plain's {plain_err:.3g}; limit 2 x plain's + 1e-6), against plain "
        f"{err_vs_plain:.3g}; bit-equal to plain on integers and across "
        "launches")
    del idx, g, ones
    torch.cuda.empty_cache()
    return row


def _qkv(torch, np, seed, B, S, T, Hq, Hkv, hd, dtype):
    rng = np.random.default_rng(seed)

    def mk(*shape):
        return torch.as_tensor(rng.normal(size=shape) * 0.5,
                               dtype=torch.float32, device="cuda").to(dtype)
    return mk(B, S, Hq, hd), mk(B, T, Hkv, hd), mk(B, T, Hkv, hd)


def phase_k2_checks(torch, np, FA, plain) -> float:
    """K2 against the plain version on the card; returns the max error."""
    worst = worst_rel = 0.0
    cases = 0
    tols = ((torch.float32, 2e-4), (torch.bfloat16, 3e-2))
    rel_rms = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
    for S in (65, 100, 128, 129, 384, 1000):
        for hd in FA.HEAD_DIMS:
            for dtype, tol in tols:
                for window in (None, 64):
                    for group in (1, 4):
                        q, k, v = _qkv(torch, np, S + hd, 2, S, S, 2 * group,
                                       2, hd, dtype)
                        out = FA.flash_attention_cuda(q, k, v, window=window)
                        ref = plain(q, k, v, window=window)
                        torch.cuda.synchronize()
                        worst = max(worst, allclose_err(out.float(),
                                                        ref.float(), tol))
                        worst_rel = max(worst_rel, attention_err(
                            out, ref, max_abs=math.inf,
                            rel_rms=rel_rms[dtype])["rel_rms_err"])
                        cases += 1
    # non-causal over key lengths that are no tile multiple: masked by T
    for T in (77, 1000):
        for hd in FA.HEAD_DIMS:
            for dtype, tol in tols:
                q, k, v = _qkv(torch, np, T + hd, 1, 300, T, 4, 2, hd, dtype)
                out = FA.flash_attention_cuda(q, k, v, causal=False)
                ref = plain(q, k, v, causal=False)
                torch.cuda.synchronize()
                worst = max(worst, allclose_err(out.float(), ref.float(),
                                                tol))
                worst_rel = max(worst_rel, attention_err(
                    out, ref, max_abs=math.inf,
                    rel_rms=rel_rms[dtype])["rel_rms_err"])
                cases += 1
    log(f"[k2] K2 == plain on {cases} cases, max |err| {worst:.3g}, "
        f"max rms err / rms ref {worst_rel:.3g}")
    return worst


def phase_k2_layer0(torch, FA, plain, res, summary: dict) -> float:
    """K2 on layer 0's real q/k/v of the served model (2 KV groups of 4
    query heads) at the main path's length and window, against the plain
    version: in bf16 as served (by ``attention_ulp_err``), and in float32
    on the same values."""
    from repro_torch.models import layers as L
    from repro_torch.models.transformer import map_params
    cfg = res.cfg
    lp = map_params(lambda t: t[0], res.params["layers"])
    B, S = res.prompts.shape
    hd, G = cfg.head_dim, cfg.n_heads // cfg.n_kv_heads
    with torch.no_grad():
        h = L.rms_norm(res.params["embed"][res.prompts.long()], lp["ln1"],
                       cfg.norm_eps)
        pos = torch.arange(S, device="cuda")[None, :]
        q = (h @ lp["wq"]).reshape(B, S, cfg.n_heads, hd)[:, :, :2 * G]
        k = (h @ lp["wk"]).reshape(B, S, cfg.n_kv_heads, hd)[:, :, :2]
        v = (h @ lp["wv"]).reshape(B, S, cfg.n_kv_heads, hd)[:, :, :2]
        q = L.apply_rope(q.contiguous(), pos, cfg.rope_theta)
        k = L.apply_rope(k.contiguous(), pos, cfg.rope_theta)
        v = v.contiguous()
        errs = {}
        for name in ("bfloat16", "float32"):
            dt = getattr(torch, name)
            args = (q.to(dt), k.to(dt), v.to(dt))
            out = FA.flash_attention_cuda(*args, window=cfg.sliding_window)
            ref = plain(*args, window=cfg.sliding_window)
            torch.cuda.synchronize()
            if name == "bfloat16":          # by bf16 ulps, as phase 13's
                errs[name] = attention_ulp_err(
                    torch, out, ref, plain(args[0], args[1], args[2].abs(),
                                           window=cfg.sliding_window),
                    ulps=K2_BF16_ULPS, rel_rms=K2_BF16_REL_RMS)
                line = _ulp_line(errs[name])
            else:
                errs[name] = attention_err(out, ref, max_abs=2e-4,
                                           rel_rms=1e-4)
                line = _err_line(errs[name])
            log(f"[k2] layer 0 of {cfg.name}: q {tuple(q.shape)}, k "
                f"{tuple(k.shape)}, window {cfg.sliding_window}, {name}: "
                f"K2 == plain, {line}")
            del out, ref
    summary["k2_layer0"] = errs
    torch.cuda.empty_cache()
    return errs["bfloat16"]["max_abs_err"]


# phase 6c: K2-bwd against its plain version; (name, B, S, T, Hq, Hkv, hd,
# causal, window).  The danube layer is 13 (c)'s, on its real q/k/v.
K2_BWD_CASES = (
    ("hymba", 2, 4096, 4096, 25, 5, 64, True, 1024),
    ("musicgen", 2, 2048, 2048, 32, 32, 64, True, None),
    ("granite", 1, 2048, 2048, 48, 1, 128, True, None),
    ("non-causal, ragged keys", 2, 300, 1000, 8, 2, 80, False, None),
    ("non-causal, ragged keys, window 40", 1, 130, 99, 4, 4, 80, False, 40),
    ("hd 32", 2, 1000, 1000, 8, 4, 32, True, None),
    ("hd 256", 1, 1000, 1000, 8, 2, 256, True, 300))
# (max |err| / max |ref|, rms err / rms ref) against plain's float64 run:
# bf16 rounds P and dS for their products and the gradients once; float32
# adds up to 4096 terms a sum in float32
K2_BWD_LIMITS = {"bfloat16": (1e-2, 1e-2), "float32": (1e-4, 1e-5)}


def k2_bwd_case(torch, FA, q, k, v, dout, *, causal: bool, window,
                what: str) -> dict:
    """K2-bwd on ``q, k, v`` (bf16 or float32) and ``dout`` from K2's own
    forward (whose output must not change by storing lse), twice (the
    same bits), against ``attention_bwd_plain``'s float64 run from a
    float64 forward by ``K2_BWD_LIMITS``, and against plain on the same
    inputs (read, not checked).  Launches here are put back."""
    from repro_torch.kernels.flash_attention.ref import (
        attention_bwd_plain, attention_plain)
    name = str(q.dtype).split(".")[-1]
    n0 = (FA.flash_attention_cuda.launches,
          FA.flash_attention_bwd_cuda.launches)
    kw = {"causal": causal, "window": window}
    bare = FA.flash_attention_cuda(q, k, v, **kw)
    out, lse = FA.flash_attention_cuda(q, k, v, lse=True, **kw)
    check(bits_equal(torch, out, bare), f"{what} {name}: K2's output "
          "changes when it stores lse")
    del bare
    grads = FA.flash_attention_bwd_cuda(q, k, v, out, dout, lse, **kw)
    again = FA.flash_attention_bwd_cuda(q, k, v, out, dout, lse, **kw)
    torch.cuda.synchronize()
    same = all(bits_equal(torch, a, b) for a, b in zip(grads, again))
    check(same, f"{what} {name}: two K2-bwd calls differ")
    del again
    FA.flash_attention_cuda.launches, FA.flash_attention_bwd_cuda.launches = n0
    plain = attention_bwd_plain(q, k, v, out, dout, lse, q_chunk=512, **kw)
    q64, k64, v64 = (t.double() for t in (q, k, v))
    o64, l64 = attention_plain(q64, k64, v64, lse=True, **kw)
    ref = attention_bwd_plain(q64, k64, v64, o64, dout.double(), l64,
                              q_chunk=512, **kw)
    del o64, l64, q64, k64, v64
    max_rel, rel_rms = K2_BWD_LIMITS[name]
    err = {"bits_twice": same, "max_abs_vs_plain": 0.0}
    for g_name, g, p, r in zip(("dq", "dk", "dv"), grads, plain, ref):
        d = g.double() - r
        e = {"max_rel_err": float(d.abs().max() / r.abs().max()),
             "rel_rms_err": float(d.norm() / r.norm()),
             "max_abs_vs_plain": float((g.float() - p.float()).abs().max())}
        check(e["max_rel_err"] <= max_rel and e["rel_rms_err"] <= rel_rms,
              f"{what} {name} {g_name} against float64: {e}")
        err[g_name] = e
        err["max_abs_vs_plain"] = max(err["max_abs_vs_plain"],
                                      e["max_abs_vs_plain"])
    log(f"[k2-bwd] {what}: q {tuple(q.shape)}, k {tuple(k.shape)}, causal "
        f"{causal}, window {window}, {name}: K2-bwd against plain's float64 "
        "run, max |err| / max |ref| (limit "
        f"{max_rel:g}) / rms err / rms ref (limit {rel_rms:g}): "
        + ", ".join(f"{g} {err[g]['max_rel_err']:.3g} / "
                    f"{err[g]['rel_rms_err']:.3g}" for g in ("dq", "dk",
                                                            "dv"))
        + f"; max |K2-bwd - plain| {err['max_abs_vs_plain']:.3g}; the same "
        "bits twice; K2's output the same bits with lse stored")
    del grads, plain, ref
    return err


def phase_k2_bwd_checks(torch, np, FA) -> dict:
    """6c: K2-bwd on ``K2_BWD_CASES``, bf16 and float32, by
    ``k2_bwd_case``."""
    out = {}
    for i, (name, B, S, T, Hq, Hkv, hd, causal, window) in enumerate(
            K2_BWD_CASES):
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = _qkv(torch, np, 100 + i, B, S, T, Hq, Hkv, hd, dtype)
            gen = torch.Generator(device="cuda").manual_seed(i)
            dout = torch.randn(q.shape, generator=gen, device="cuda").to(
                dtype)
            out[f"{name} {str(dtype).split('.')[-1]}"] = k2_bwd_case(
                torch, FA, q, k, v, dout, causal=causal, window=window,
                what=name)
            del q, k, v, dout
            torch.cuda.empty_cache()
    return out


def lm_mfu(cfg, kind: str, batch: int, seq: int, ms: float) -> float:
    """Model FLOP utilisation of one measured LM call, by the port's
    roofline (``launch/roofline.mfu``): ``model_flops`` at the smoke's own
    ``batch`` and ``seq`` (the positions a row; a decode step is one a
    row) over ``ms`` at the card's bf16 peak."""
    from repro_torch.configs.shapes import InputShape
    from repro_torch.launch.roofline import mfu
    return mfu(cfg, InputShape(f"smoke_{kind}", seq, batch, kind),
               ms / 1e3)


def serve_mfu(res) -> dict:
    """``lm_mfu`` of a ``ServeResult``'s timed prefill and decode step."""
    B = res.prompts.shape[0]
    S = res.prompts.shape[1] + (0 if res.embeds is None
                                else res.embeds.shape[1])
    return {"prefill": lm_mfu(res.cfg, "prefill", B, S, res.prefill_ms),
            "decode": lm_mfu(res.cfg, "decode", B, S,
                             res.decode_ms_per_token)}


def phase_serve(torch, counters, FA, summary: dict):
    """The LM path: danube at full width, served through the entry point."""
    from repro_torch.launch.serve import serve
    from repro_torch.models.transformer import tree_leaves
    for c in counters:                         # counts of this path only
        c.launches = 0
    t0 = time.perf_counter()
    res = serve(ARCH, batch=SERVE_BATCH, prompt_len=SERVE_PROMPT,
                tokens=SERVE_TOKENS, size="full", device="cuda")
    wall = time.perf_counter() - t0
    launches = FA.flash_attention_cuda.launches
    cfg = res.cfg
    check(launches == 2 * cfg.n_layers,
          f"K2 launched {launches} times in 2 prefills of {cfg.n_layers} "
          "layers")
    check_idle(counters, (FA.flash_attention_cuda,), "the LM serve path")
    check(bool(torch.isfinite(res.last_logits.float()).all()),
          "finite logits")
    check(res.tokens.shape == (SERVE_BATCH, SERVE_TOKENS), "token shape")
    check(bool(((res.tokens >= 0) & (res.tokens < cfg.vocab_padded)).all()),
          "token ids in range")
    check(res.pos == SERVE_PROMPT + SERVE_TOKENS - 1, "cache position")
    n_params = sum(t.numel() for t in tree_leaves(res.params))
    mfu = serve_mfu(res)
    summary["serve"] = {
        "arch": cfg.name, "layers": cfg.n_layers, "params": n_params,
        "batch": SERVE_BATCH, "prompt": SERVE_PROMPT,
        "tokens": SERVE_TOKENS, "prefill_ms": res.prefill_ms,
        "decode_ms_per_token": res.decode_ms_per_token,
        "decode_tokens_per_s": res.decode_tokens_per_s,
        "peak_memory_bytes": res.peak_memory_bytes, "wall_s": wall,
        "k2_launches": launches, "mfu": mfu}
    log(f"[serve] {cfg.name}: {cfg.n_layers} layers, {n_params} params, "
        f"bf16; batch {SERVE_BATCH} x {SERVE_PROMPT} tokens")
    log(f"[serve] prefill {res.prefill_ms:.1f} ms (mfu "
        f"{mfu['prefill']:.3f}); decode {res.decode_ms_per_token:.2f} "
        f"ms/token (mfu {mfu['decode']:.5f}), "
        f"{res.decode_tokens_per_s:.1f} tokens/s; peak memory "
        f"{res.peak_memory_bytes / 2**30:.2f} GiB; wall {wall:.1f} s")
    log(f"[serve] request 0: {res.tokens[0, :12].tolist()} ...")
    log(f"[main] K2 launches on the LM path: {launches} "
        f"({launches // 2} per prefill)")
    return res, launches


def phase_profile(torch, res, summary: dict, key: str = "profile",
                  decode_window: bool = True) -> dict:
    """Where the LM path's time goes: torch.profiler over one prefill and
    (with ``decode_window``) over 4 decode steps of the served model
    (weights from phase 7, or 15's, or 17's with their frontend embeds),
    with each kernel class's share of the kernels' time.  The busy share
    is the kernels' summed device time over the window's wall time (one
    stream); the profiler slows the host, so the idle share it gives is
    an upper bound.  It records the device's activity only: no host event
    is read, and the host's take seconds to gather at this depth."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch import steps as ST
    model = ST.build_model(res.cfg, device="cuda")
    frames = 0 if res.embeds is None else res.embeds.shape[1]
    prefill = ST.make_prefill_step(
        model, capacity=frames + res.prompts.shape[1] + 4)
    decode = ST.make_decode_step(model)
    state = {}

    def run_prefill():
        state["logits"], state["cache"] = prefill(
            res.params, {"tokens": res.prompts, "embeds": res.embeds})

    def run_decode():
        tok = state["logits"][:, -1].argmax(-1, keepdim=True)
        for _ in range(4):
            logits, state["cache"] = decode(res.params, state["cache"],
                                            {"tokens": tok})
            tok = logits[:, -1].argmax(-1, keepdim=True)

    out = {}
    windows = [("prefill", run_prefill)]
    if decode_window:
        windows.append(("decode x4", run_decode))
    for name, fn in windows:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        # kernel rows only: an op's row repeats its kernels' device time
        rows = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                       for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA),
                      key=lambda r: -r[1])
        busy = sum(r[1] for r in rows)
        shares = {}
        for k, ms, _ in rows:
            cls = _kernel_class(k)
            shares[cls] = shares.get(cls, 0.0) + ms / busy
        out[name] = {"wall_ms": wall_ms, "device_busy_ms": busy,
                     "idle_share": 1 - busy / wall_ms if busy else None,
                     "class_shares": shares,
                     "top": [{"name": k[:80], "ms": ms, "calls": n}
                             for k, ms, n in rows[:8]]}
        split = ", ".join(f"{c} {v:.3f}" for c, v in shares.items())
        log(f"[profile] {res.cfg.name} {name}: wall {wall_ms:.1f} ms under "
            f"the profiler, kernels {busy:.1f} ms"
            + (f" (idle share <= {1 - busy / wall_ms:.3f}); shares of the "
               f"kernels {split}" if busy
               else " (no device time recorded: not measured)"))
        for k, ms, n in rows[:8]:
            log(f"[profile]   {ms:9.3f} ms {n:5d}x {k[:80]}")
    summary[key] = out
    return out


def phase_cross_device(torch, np, summary: dict) -> float:
    """Full width, 2 layers, float32: the card (K2) against the CPU."""
    from repro_torch.configs import get_full
    from repro_torch.models.transformer import LM, map_params
    cfg = dataclasses.replace(get_full(ARCH), n_layers=2).resolve(1)
    gpu = LM(cfg, dtype=torch.float32, device="cuda")
    cpu = LM(cfg, dtype=torch.float32, device="cpu")
    params = gpu.init_params(0)
    cparams = map_params(torch.Tensor.cpu, params)
    prompt = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab, (1, 1024)), dtype=torch.int32)
    logits, cache = gpu.prefill(params, prompt.cuda(), capacity=1024 + 4)
    clogits, ccache = cpu.prefill(cparams, prompt, capacity=1024 + 4)
    worst = allclose_err(logits.cpu(), clogits, 1e-3)
    tok = logits[:, -1].argmax(-1, keepdim=True)
    ctok = clogits[:, -1].argmax(-1, keepdim=True)
    for _ in range(4):
        check(bool((tok.cpu() == ctok).all()), "greedy tokens cuda == cpu")
        logits, cache = gpu.decode_step(params, cache, tok)
        clogits, ccache = cpu.decode_step(cparams, ccache, ctok)
        worst = max(worst, allclose_err(logits.cpu(), clogits, 1e-3))
        tok = logits[:, -1].argmax(-1, keepdim=True)
        ctok = clogits[:, -1].argmax(-1, keepdim=True)
    check(bool((tok.cpu() == ctok).all()), "greedy tokens cuda == cpu")
    summary["cross_device_max_abs_err"] = worst
    log(f"[cross] {cfg.name} at 2 layers, float32, 1 x 1024 prompt + 4 "
        f"decode steps: cuda (K2) == cpu (plain), max |err| {worst:.3g}, "
        "same greedy tokens")
    return worst


def phase_k2_yardstick(torch, FA, plain, summary: dict) -> dict:
    """K2, plain and SDPA at the main-path layer shape, beside the bound."""
    from repro_torch.kernels.flash_attention.ref import attention_mask
    from repro_torch.profiling.microbench import median_time_ms
    cfg = summary["serve"]
    B, S, Hq, Hkv, hd, W = SERVE_BATCH, SERVE_PROMPT, 32, 8, 80, 4096
    gen = torch.Generator(device="cuda").manual_seed(2)

    def mk(*shape):
        return (torch.randn(shape, generator=gen, device="cuda")
                * 0.5).to(torch.bfloat16)
    q, k, v = mk(B, S, Hq, hd), mk(B, S, Hkv, hd), mk(B, S, Hkv, hd)
    scale = 1.0 / math.sqrt(hd)
    mask = attention_mask(S, S, causal=True, window=W, device="cuda")
    pairs = int(mask.sum())

    def k2(a, b, c):
        return FA.flash_attention_cuda(a, b, c, window=W, scale=scale)

    def pl(a, b, c):
        return plain(a, b, c, window=W, scale=scale)

    def sdpa(a, b, c):
        return torch.nn.functional.scaled_dot_product_attention(
            a.transpose(1, 2), b.transpose(1, 2), c.transpose(1, 2),
            attn_mask=mask, scale=scale, enable_gqa=True).transpose(1, 2)

    with torch.no_grad():
        out = k2(q, k, v)
        ref = pl(q, k, v)
        torch.cuda.synchronize()
        check_err = attention_err(out, ref, max_abs=4e-3, rel_rms=1e-2)
        err = check_err["max_abs_err"]
        lib_out = sdpa(q, k, v)
        torch.cuda.synchronize()
        allclose_err(lib_out.float(), ref.float(), 3e-2)
        lib_err = attention_err(lib_out, ref, max_abs=math.inf, rel_rms=5e-2)
        del out, ref, lib_out
        torch.cuda.empty_cache()
        ms = median_time_ms(k2, (q, k, v), warmup=2, repeats=10)
        plain_ms = median_time_ms(pl, (q, k, v), warmup=1, repeats=3)
        torch.cuda.empty_cache()
        library_ms = median_time_ms(sdpa, (q, k, v), warmup=2, repeats=10)
        # the float32 kernel on the same values, as the cross-device path
        # runs it
        f32 = tuple(t.float() for t in (q, k, v))
        f32_ms = median_time_ms(k2, f32, warmup=1, repeats=5)
        del f32
    flops = 4 * hd * pairs * B * Hq
    nbytes = 2 * (q.numel() + k.numel() + v.numel() + q.numel())
    ops_ms = flops / BF16_FLOP_PER_S * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ms = max(ops_ms, bytes_ms)
    f32_bound_ms = max(flops / F32_FLOP_PER_S,
                       2 * nbytes / HBM_BYTES_PER_S) * 1e3
    row = {"name": "flash_attention", "route": "cuda",
           "source": "src/repro_torch/csrc/flash_attention.cu",
           "replaces": "src/repro/kernels/flash_attention/kernel.py:80",
           "design": "wgmma (bf16 tensor cores, cp.async K/V ring)",
           "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": bound_ms,
           "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
           "library_ms": library_ms}
    tflops = flops / (ms * 1e-3) / 1e12
    summary["k2_yardstick"] = {
        "shape": [B, S, Hq, Hkv, hd], "window": W, "dtype": "bfloat16",
        "unmasked_pairs_per_head": pairs, "flops": flops, "bytes": nbytes,
        "ops_ms": ops_ms, "bytes_ms": bytes_ms, "check": check_err,
        "sdpa_check": lib_err, "tflops": tflops,
        "bound_share": bound_ms / ms, "per_prefill_ms": ms * cfg["layers"],
        "float32_cuda_cores": {
            "ms": f32_ms, "tflops": flops / (f32_ms * 1e-3) / 1e12,
            "bound_ms": f32_bound_ms, "bound_share": f32_bound_ms / f32_ms},
        **row}
    log(f"[k2-yardstick] q ({B}, {S}, {Hq}, {hd}), k/v ({B}, {S}, {Hkv}, "
        f"{hd}) bf16, causal, window {W}, {pairs} pairs per head: K2 "
        f"(wgmma) {ms:.3f} ms ({tflops:.1f} TFLOP/s, {bound_ms / ms:.1%} "
        f"of the bound), plain {plain_ms:.3f} ms, SDPA {library_ms:.3f} ms,"
        f" bound {bound_ms:.3f} ms ({row['bound_by']})")
    log(f"[k2-yardstick] K2 float32 (CUDA cores) on the same values: "
        f"{f32_ms:.3f} ms ({flops / (f32_ms * 1e-3) / 1e12:.1f} TFLOP/s, "
        f"{f32_bound_ms / f32_ms:.1%} of its bound {f32_bound_ms:.3f} ms at "
        f"the float32 peak)")
    log(f"[k2-yardstick] K2 == plain: {_err_line(check_err)}")
    log(f"[k2-yardstick] SDPA == plain: {_err_line(lib_err)}")
    check(ms < library_ms, f"K2 {ms:.3f} ms is not faster than SDPA "
          f"{library_ms:.3f} ms")
    del q, k, v, mask
    torch.cuda.empty_cache()
    return row


def _stage_seconds(tele) -> dict:
    """Each iteration's wall seconds of the trainer's three stages, from
    its ``train.*`` spans: ``{iteration: {stage: s}}``."""
    out: dict = {}
    for name, _ts, dur_us, *_rest, args in tele.get_tracer().snapshot_events():
        if name.startswith("train."):
            out.setdefault(args["iteration"], {})[name[6:]] = dur_us / 1e6
    return out


def train_and_place(oracle, measured, train, test, seed: int,
                    device: str | None) -> dict:
    """Train DreamShard (``seed``, the paper's budget) against ``oracle``
    and place ``test`` with the trained agent, the untrained agent of the
    same seed and random (16 decode candidates each), priced by
    ``measured``.  Phase 8 runs it once on the card; ``tools/train_margin.py``
    runs it for several seeds against a saved calibration artifact."""
    import numpy as np
    import torch
    from repro_torch.api import RandomPlacer, measure_placements
    from repro_torch.core.trainer import DreamShard, DreamShardConfig

    agent = DreamShard(train, oracle, DreamShardConfig(seed=seed),
                       device=device)
    evals0 = oracle.num_evaluations
    t0 = time.perf_counter()
    history = agent.train()
    if agent.device.type == "cuda":
        torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    train_evals = oracle.num_evaluations - evals0
    untrained = DreamShard(train, oracle, DreamShardConfig(seed=seed),
                           device=device)
    placements = {
        "trained": agent.as_placer(n_candidates=16).place_many(test),
        "untrained": untrained.as_placer(n_candidates=16).place_many(test),
        "random": RandomPlacer(measured, seed=0).place_many(test)}
    costs = {k: measure_placements(measured, test, v)
             for k, v in placements.items()}
    mean = {k: float(np.mean(v)) for k, v in costs.items()}
    margin = {k: mean[k] / mean["trained"] - 1 for k in ("untrained",
                                                           "random")}
    return {"agent": agent, "untrained": untrained, "history": history,
            "train_s": train_s, "train_evals": train_evals,
            "placements": placements, "costs": costs, "mean": mean,
            "margin": margin}


def phase_train(torch, np, K, counters, summary: dict, artifact: str | None):
    """Algorithm 1 on measured costs: calibrate K1 on the card through
    ``KernelOracle``, train DreamShard on DLRM-50 (4) against it, place the
    test tasks with the trained agent, the untrained one and random, and
    measure test task 0's trained placement live with K1."""
    import tempfile
    from repro_torch import telemetry as tele
    from repro_torch.api import KernelOracle, MeasuredOracle
    from repro_torch.data.synthetic import make_dlrm_pool
    from repro_torch.data.tasks import make_benchmark_suite
    from repro_torch.profiling.calibration import CalibrationTable
    from repro_torch.profiling.microbench import measure_placement

    pool = make_dlrm_pool(seed=0)
    train, _ = make_benchmark_suite(pool, n_tables=50, n_devices=4,
                                    n_tasks=TRAIN_TASKS)
    _, test = make_benchmark_suite(pool, n_tables=50, n_devices=4,
                                   n_tasks=20)
    for c in counters:                         # counts of this path only
        c.launches = 0
    tele.reset()
    tele.enable()

    # 1. calibrate K1's forward and backward on the card
    oracle = KernelOracle(batch_size=BATCH, max_rows=MAX_ROWS, device="cuda")
    t0 = time.perf_counter()
    measured = oracle.measured()
    torch.cuda.synchronize()
    calib_s = time.perf_counter() - t0
    table = measured.table
    calib = {"fwd": K.embedding_bag_cuda.launches,
             "bwd": K.embedding_bag_grad_cuda.launches}
    check(calib["fwd"] > 0 and calib["bwd"] > 0,
          f"the calibration launched K1 {calib}")
    check(table.fingerprint["device_kind"] == torch.cuda.get_device_name(0),
          "the artifact names the card")
    grid = {k: getattr(table, k).astype(int).tolist()
            for k in ("dims", "rows", "batches", "poolings")}
    log(f"[calibrate] grid {grid}; {table.fwd_ms.size} kernel points, "
        f"{len(table.fusion_sweep['k'])} fused, "
        f"{len(table.shard_sweep['frac'])} sharded; {calib_s:.1f} s")
    log(f"[calibrate] K1 launches in the sweeps: {calib['fwd']} forward, "
        f"{calib['bwd']} backward")
    log(f"[calibrate] fwd ms per grid point "
        f"{np.round(table.fwd_ms.reshape(-1), 4).tolist()}; bwd ms "
        f"{np.round(table.bwd_ms.reshape(-1), 4).tolist()}")
    for name in ("fusion_fwd", "fusion_bwd", "shard_fwd", "shard_bwd"):
        log(f"[calibrate] {name}: {getattr(table, name).summary()}")
    # the artifact round trip prices the same placements bit for bit
    rng = np.random.default_rng(0)
    probe = [(t, rng.integers(0, t.n_devices, (8, t.n_tables)))
             for t in test[:4]]
    with tempfile.TemporaryDirectory() as tmp:
        reloaded = MeasuredOracle(CalibrationTable.load(table.save(
            os.path.join(tmp, "calibration.npz"))), batch_size=BATCH)
        for t, a in probe:
            for x, y in zip(measured.evaluate_many(t.raw_features, a, 4),
                            reloaded.evaluate_many(t.raw_features, a, 4)):
                check(x.overall == y.overall and np.array_equal(
                    x.cost_features, y.cost_features),
                    "the reloaded artifact prices differently")
    log("[calibrate] saved and reloaded: same prices bit for bit")
    if artifact:
        table.save(artifact)
        log(f"[calibrate] artifact written to {artifact}")

    # 2. Algorithm 1 against the card's measured costs, and 3. Algorithm 2
    # with the trained agent, the untrained one and random
    tele.reset()
    out = train_and_place(oracle, measured, train, test, 0, "cuda")
    agent, untrained, history = out["agent"], out["untrained"], out["history"]
    train_s, placements = out["train_s"], out["placements"]
    costs, mean, margin = out["costs"], out["mean"], out["margin"]
    stages = _stage_seconds(tele)
    for h in history:
        it = h["iteration"]
        check(math.isfinite(h["cost_loss"])
              and math.isfinite(h["mean_est_reward"]), "finite training")
        log(f"[train] iter {it}: cost loss {h['cost_loss']:.5f}, est reward "
            f"{h['mean_est_reward']:.4f} ms, collect "
            f"{stages[it]['collect']:.3f} s, cost update "
            f"{stages[it]['cost_update']:.3f} s, rl update "
            f"{stages[it]['rl_update']:.3f} s, dispatches {h['dispatches']}")
    log(f"[train] {len(history)} iterations in {train_s:.1f} s, "
        f"{agent.num_dispatches} dispatches, {out['train_evals']} oracle "
        f"rows in training ({agent.oracle.num_evaluations} on the oracle "
        "with the calibration's probe and the placements' pricing)")
    check(len(agent.buffer) == agent.cfg.n_iterations * agent.cfg.n_collect,
          "every collected placement was measured")

    for k, v in mean.items():
        check(bool(np.isfinite(costs[k]).all()), f"{k}: finite costs")
        log(f"[place] {k:9s} mean MeasuredOracle cost over {len(test)} test "
            f"tasks {v:.4f} ms")
    log(f"[place] trained beats untrained by {margin['untrained']:.2%}, "
        f"random by {margin['random']:.2%}")
    check(mean["trained"] < mean["untrained"] and
          mean["trained"] < mean["random"],
          f"the trained agent does not beat the untrained one and random: "
          f"{mean}")

    # 4. sim-to-real: live K1 timing of the trained placements
    live = []
    for ti, task in enumerate(test[:SIM2REAL_TASKS]):
        a = placements["trained"][ti].assignment
        est = measured.evaluate(task.raw_features, a, task.n_devices)
        for pooling in (None, 4):
            res = measure_placement(task.raw_features, a, task.n_devices,
                                    batch_size=BATCH, pooling=pooling,
                                    max_rows=MAX_ROWS, device="cuda")
            rel = est.overall / res.overall - 1
            check(math.isfinite(res.overall), "finite live cost")
            live.append({"task": ti, "pooling": pooling,
                         "live_ms": res.overall, "oracle_ms": est.overall,
                         "rel_err": rel,
                         "live_fwd_ms": res.fwd_comp.tolist(),
                         "live_bwd_ms": res.bwd_comp.tolist(),
                         "oracle_fwd_ms": est.fwd_comp.tolist(),
                         "oracle_bwd_ms": est.bwd_comp.tolist()})
            log(f"[sim2real] task {ti} pooling "
                f"{'own' if pooling is None else pooling}: live "
                f"{res.overall:.4f} ms (fwd "
                f"{np.round(res.fwd_comp, 3).tolist()}, bwd "
                f"{np.round(res.bwd_comp, 3).tolist()}), MeasuredOracle "
                f"{est.overall:.4f} ms (fwd "
                f"{np.round(est.fwd_comp, 3).tolist()}, bwd "
                f"{np.round(est.bwd_comp, 3).tolist()}): error {rel:+.2%}")
    launches = {"fwd": K.embedding_bag_cuda.launches,
                "bwd": K.embedding_bag_grad_cuda.launches}
    check_idle(counters, (K.embedding_bag_cuda, K.embedding_bag_grad_cuda),
               "the training path")
    tele.disable()
    log(f"[train] K1 launches on the training path: {launches['fwd']} "
        f"forward, {launches['bwd']} backward ({calib['fwd']} and "
        f"{calib['bwd']} in the calibration)")

    # 5. one cost stage on the card and on the CPU from the same state
    cross = cost_stage_cross_device(torch, np, agent, untrained)
    # 6. what a step of each stage asks of the card
    stage_profile = profile_stages(torch, agent)
    summary["train"] = {
        "calibration_s": calib_s, "grid": grid,
        "calibration_launches": calib,
        "fusion_fwd": table.fusion_fwd.to_dict(),
        "fusion_bwd": table.fusion_bwd.to_dict(),
        "shard_fwd": table.shard_fwd.to_dict(),
        "shard_bwd": table.shard_bwd.to_dict(),
        "kernel_fwd_ms": table.fwd_ms.reshape(-1).tolist(),
        "kernel_bwd_ms": table.bwd_ms.reshape(-1).tolist(),
        "train_s": train_s, "history": history, "stages_s": stages,
        "num_dispatches": agent.num_dispatches,
        "mean_cost_ms": mean, "margin": margin, "sim2real": live,
        "launches": launches, "stage_profile": stage_profile,
        "cost_stage_cross_device": cross}
    # test task 0 and its trained and random placements, for phase 10
    task0 = {"task": test[0], "oracle": measured,
             "placements": {k: placements[k][0].assignment
                            for k in ("trained", "random")}}
    # the trained agent and its oracles, for phase 11
    ctx = {"agent": agent, "oracle": oracle, "measured": measured,
           "train": train, "test": test, "train_evals": out["train_evals"]}
    return launches, task0, ctx


def profile_stages(torch, agent) -> dict:
    """What one step of each training stage asks of the card: the trained
    agent runs PROFILE_COST_STEPS more Eq.-1 steps and PROFILE_RL_STEPS
    more REINFORCE steps under torch.profiler.  A step's device ops are
    the kernel, copy and memset records of the window over its steps; the
    busy share is their summed device time over the window's wall time
    (the profiler slows the host, so the idle share is an upper bound).
    ``num_dispatches`` counts the reference's jitted calls, one a stage,
    so it cannot see these launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    out = {}
    for name, fn, steps in (
            ("cost_update", agent.update_cost, PROFILE_COST_STEPS),
            ("rl_update", agent.update_policy, PROFILE_RL_STEPS)):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn(steps)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        rows = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA]
        ops = sum(e.count for e in rows)
        busy = sum(e.self_device_time_total for e in rows) / 1e3
        out[name] = {"steps": steps, "wall_ms": wall_ms,
                     "device_ops_per_step": ops / steps,
                     "device_busy_ms": busy,
                     "idle_share": 1 - busy / wall_ms if busy else None}
        log(f"[train profile] {name}: {steps} steps, wall {wall_ms:.1f} ms "
            f"under the profiler, {ops / steps:.0f} device ops a step, "
            f"kernels {busy:.1f} ms"
            + (f" (idle share <= {1 - busy / wall_ms:.3f})" if busy
               else " (no device time recorded: not measured)"))
    return out


def cost_stage_cross_device(torch, np, agent, untrained) -> dict:
    """The trainer's first cost stage, 50 fused steps, on the card and on
    the CPU (float32, TF32 off) from the same state: the agent's initial
    weights (``untrained``, the same seed), a fresh Adam with the
    trainer's schedule, the trained run's ring and one set of host-drawn
    slots.  The losses must agree within 1e-4 relative.  (A fresh Adam
    from the trained weights instead kicks the loss up ~100x in its first
    step, and float32 alone then strays from float64 by ~4e-4.)"""
    from repro_torch.core import networks as N
    from repro_torch.core import replay as RB
    from repro_torch.optim import adam, linear_decay
    ring = agent._ring
    rng = np.random.default_rng(1)
    size = ring.size
    b = min(agent.cfg.n_batch, size)
    idx = np.zeros((CROSS_STEPS, agent.cfg.n_batch), np.int32)
    w = np.zeros((CROSS_STEPS, agent.cfg.n_batch), np.float32)
    for t in range(CROSS_STEPS):
        idx[t, :b] = ring.slots(rng.integers(size, size=b))
        w[t, :b] = 1.0
    weights = N.params_to_jax(untrained.cost_net)
    cfg = agent.cfg
    out = {}
    for dev in ("cuda", "cpu"):
        net = N.params_from_jax(weights).to(dev)
        opt = adam(linear_decay(cfg.lr, cfg.n_iterations * cfg.n_cost))
        buf = {k: v.to(dev) for k, v in ring.data.items()}
        _, _, losses = RB.make_fused_cost_update(opt)(
            net, opt.init(list(net.parameters())), buf, idx, w)
        out[dev] = (losses.cpu().numpy(),
                    [p.detach().cpu().numpy() for p in net.parameters()])
    (lg, pg), (lc, pc) = out["cuda"], out["cpu"]
    rel = float(np.max(np.abs(lg - lc) / np.abs(lc)))
    prel = max(float(np.max(np.abs(a - c)) / np.max(np.abs(c)))
               for a, c in zip(pg, pc))
    log(f"[cross] first cost stage, {CROSS_STEPS} fused steps from the "
        f"initial weights over the trained ring ({size} samples): losses "
        f"cuda vs cpu max rel "
        f"err {rel:.3g} (limit 1e-4), params max err / max |param| "
        f"{prel:.3g}; loss {lc[0]:.5f} -> {lc[-1]:.5f}")
    check(rel <= 1e-4, f"cost stage cuda vs cpu: {rel:.3g} > 1e-4")
    return {"steps": CROSS_STEPS, "loss_max_rel_err": rel,
            "param_max_rel_err": prel, "first_loss": float(lc[0]),
            "last_loss": float(lc[-1])}


# phase 8b: Table 1's DLRM-50 (4) row (``benchmarks/table1_main.py:36-52``)
RNN_EPISODES = 10                # table1_main's RNN: 10 episodes an update
TABLE1_LIVE_TASKS = 1            # test tasks whose leading placements run live


def train_rnn(oracle, train, seed: int, device: str | None) -> dict:
    """The RNN baseline (``seed``) trained against ``oracle`` on the
    reference's matched hardware budget (``benchmarks/common.py:67-76``:
    ``n_iterations * n_collect // 2`` updates of 10 episodes, all
    measured).  Returns the placer, its seconds and the oracle rows it
    consumed."""
    import torch
    from repro_torch.core.rnn_policy import RNNPlacer, RNNPolicyConfig
    from repro_torch.core.trainer import DreamShardConfig
    budget = DreamShardConfig()
    rnn = RNNPlacer(train, oracle, RNNPolicyConfig(
        n_updates=budget.n_iterations * budget.n_collect // 2,
        n_episode=RNN_EPISODES, seed=seed), device=device)
    evals0 = oracle.num_evaluations
    t0 = time.perf_counter()
    rnn.train()
    if rnn.device.type == "cuda":
        torch.cuda.synchronize()
    return {"rnn": rnn, "train_s": time.perf_counter() - t0,
            "rows": oracle.num_evaluations - evals0}


def table1_row(np, measured, agent, rnn, tasks) -> dict:
    """Every Table 1 strategy on ``tasks``, priced by ``measured`` as
    ``table1_main.py`` scores a split: random, the four experts,
    ``expert_best``, the RNN, DreamShard (16 candidates) and DreamShard
    refined by lns (phase 11's configuration); each placement must be
    legal.  Returns the placements, the mean costs, the speedups and on
    how many tasks the RNN placed as random and as each expert."""
    from repro_torch.api import (DreamShardPlacer, SearchConfig,
                                 SearchPlacer, legal_batch,
                                 make_baseline_placers, measure_placements)
    from repro_torch.core.baselines import EXPERT_STRATEGIES
    placers = make_baseline_placers(measured, include_portfolio=True)
    placers["rnn"] = rnn.as_placer()
    placers["dreamshard"] = agent.as_placer(n_candidates=16)
    placers["dreamshard+lns"] = DreamShardPlacer(
        agent, n_candidates=16, refiner=SearchPlacer(
            measured, agent=agent, config=SearchConfig(
                strategy="lns", seed=0, budget_ms=None,
                max_evals=SEARCH_MAX_EVALS)))
    placements, mean = {}, {}
    for name, placer in placers.items():
        placements[name] = placer.place_many(tasks)
        for t, p in zip(tasks, placements[name]):
            check(bool(legal_batch(measured, t.raw_features,
                                   p.assignment[None], t.n_devices)[0]),
                  f"table 1: {name}'s placement is illegal")
        costs = measure_placements(measured, tasks, placements[name])
        check(bool(np.isfinite(costs).all()), f"table 1: {name} finite")
        mean[name] = float(costs.mean())
    best = min(v for k, v in mean.items() if not k.startswith("dreamshard"))
    ds = mean["dreamshard"]
    rnn_as = {k: sum(np.array_equal(p.assignment, q.assignment)
                     for p, q in zip(placements["rnn"], placements[k]))
              for k in ("random", *EXPERT_STRATEGIES)}
    return {"placements": placements, "mean": mean, "rnn_as": rnn_as,
            "speedup_vs_random": mean["random"] / ds - 1,
            "speedup_vs_best_baseline": best / ds - 1,
            "search_gain": ds / mean["dreamshard+lns"] - 1,
            "beats_all": ds <= best * 1.001}


def rnn_cross_device(torch, np, rnn, test) -> dict:
    """One RNN update's gradient from the trained weights, converted, on
    the card and on the CPU over the same task and host-drawn noise
    (actions and rewards equal, each parameter's gradient within 1e-4 of
    its largest entry; the logit shifts, ``cost_mlp`` and the head's bias,
    whose gradient is zero but for rounding, within 1e-4 of the
    gradient's largest entry), and the greedy placements of the test
    tasks equal."""
    from repro_torch.core.rnn_policy import (LOGIT_SHIFT_PARAMS, RNNPlacer,
                                             rnn_params_from_jax,
                                             rnn_params_to_jax)
    from repro_torch.core.rollout import gumbel_noise
    weights = rnn_params_to_jax(rnn.net)
    task = rnn.tasks[0]
    noise = gumbel_noise((task.n_tables, rnn.cfg.n_episode, task.n_devices),
                         torch.Generator().manual_seed(1), "cpu")
    out = {}
    for dev in ("cuda", "cpu"):
        placer = RNNPlacer(rnn.tasks, rnn.oracle, rnn.cfg, device=dev)
        placer.net = rnn_params_from_jax(weights).to(dev)
        actions, rewards, grads = placer.gradient(task, noise.to(dev))
        out[dev] = (actions.cpu(), rewards, [g.cpu() for g in grads],
                    [placer.place(t.raw_features, t.n_devices)
                     for t in test])
    (a_g, r_g, g_g, p_g), (a_c, r_c, g_c, p_c) = out["cuda"], out["cpu"]
    check(torch.equal(a_g, a_c) and np.array_equal(r_g, r_c),
          "rnn cross-device: the sampled episodes differ")
    scale = max(float(g.abs().max()) for g in g_c)
    rel, shift = 0.0, 0.0
    for (name, _), x, y in zip(rnn.net.named_parameters(), g_g, g_c):
        err = float((x - y).abs().max())
        if name in LOGIT_SHIFT_PARAMS:
            shift = max(shift, err / scale)
        else:
            rel = max(rel, err / float(y.abs().max()))
    same = sum(np.array_equal(x, y) for x, y in zip(p_g, p_c))
    log(f"[table1 cross] one RNN update cuda vs cpu: gradient max rel err "
        f"{rel:.3g} (limit 1e-4), logit shifts {shift:.3g} of the largest "
        f"entry (limit 1e-4); greedy placements equal on "
        f"{same}/{len(test)} test tasks")
    check(rel <= 1e-4, f"rnn gradient cuda vs cpu: {rel:.3g} > 1e-4")
    check(shift <= 1e-4, f"rnn logit-shift gradient cuda vs cpu: {shift:.3g}")
    check(same == len(test), "rnn greedy placements differ cuda vs cpu")
    return {"grad_max_rel_err": rel, "shift_grad_err": shift,
            "equal_placements": same}


def phase_table1(torch, np, K, counters, ctx, summary: dict) -> dict:
    """Table 1's DLRM-50 (4) row on the card over phase 8's oracles and
    trained agent: (a) the RNN baseline trained on the card against
    ``KernelOracle`` with the matched budget, (b) every strategy priced by
    ``MeasuredOracle`` on the test and train tasks, (c) the RNN's and
    ``expert_best``'s placements of test task 0 timed live with K1
    and K1 held to plain at each of their devices, (d) the RNN's update
    and greedy placements on the card against the CPU.  Returns K1's
    launches on this path, counted from zero."""
    from repro_torch.profiling.microbench import measure_placement
    agent, oracle, measured = ctx["agent"], ctx["oracle"], ctx["measured"]
    train, test = ctx["train"], ctx["test"]
    for c in counters:                         # counts of this path only
        c.launches = 0
    # (a) the RNN on the card
    out = train_rnn(oracle, train, 0, "cuda")
    rnn = out["rnn"]
    check(next(rnn.net.parameters()).is_cuda, "the RNN trains on the card")
    want = rnn.cfg.n_updates * rnn.cfg.n_episode
    log(f"[table1] RNN: {rnn.cfg.n_updates} updates of {rnn.cfg.n_episode} "
        f"episodes in {out['train_s']:.1f} s "
        f"({out['train_s'] / rnn.cfg.n_updates:.3f} s an update), "
        f"{out['rows']} oracle rows (DreamShard's training: "
        f"{ctx['train_evals']})")
    check(out["rows"] == want, f"the RNN consumed {out['rows']} oracle rows, "
          f"not {want}")
    # (b) every strategy on both splits
    rows = {}
    for split, tasks in (("test", test), ("train", train)):
        t0 = time.perf_counter()
        row = table1_row(np, measured, agent, rnn, tasks)
        rows[split] = row
        log(f"[table1] DLRM-50 (4) {split} ({len(tasks)} tasks, "
            f"{time.perf_counter() - t0:.1f} s): " + ", ".join(
                f"{k} {v:.4f}" for k, v in row["mean"].items()) + " ms")
        log(f"[table1] {split}: speedup vs random "
            f"{row['speedup_vs_random']:+.2%}, vs the best baseline "
            f"{row['speedup_vs_best_baseline']:+.2%}, lns gain "
            f"{row['search_gain']:+.2%}, beats_all {row['beats_all']} "
            "(printed, not checked); the RNN's placement is "
            + ", ".join(f"{k}'s on {v}" for k, v in row["rnn_as"].items())
            + f" of {len(tasks)} tasks")
    # (c) the leading placements live with K1: each distinct placement of
    # a task once (the RNN's greedy decode often is expert_best's)
    live, checks, timed = [], {}, {}
    for ti, task in enumerate(test[:TABLE1_LIVE_TASKS]):
        for name in ("rnn", "expert_best"):
            a = rows["test"]["placements"][name][ti].assignment
            label = f"task {ti} {name}"
            key = (ti, np.asarray(a, np.int64).tobytes())
            same = timed.get(key)
            if same is not None:
                live.append({**same, "placement": label,
                             "same_as": same["placement"]})
                checks[label] = checks[same["placement"]]
                log(f"[table1 live] {label}: the same placement as "
                    f"{same['placement']}, whose live timing and K1 checks "
                    "stand for it")
                continue
            est = measured.evaluate(task.raw_features, a, task.n_devices)
            res = measure_placement(task.raw_features, a, task.n_devices,
                                    batch_size=BATCH, pooling=None,
                                    max_rows=MAX_ROWS, device="cuda")
            check(math.isfinite(res.overall), "finite live cost")
            checks[label] = placement_kernel_checks(
                torch, K, task, a, label=f"the table 1 placement '{label}'")
            live.append({"placement": label, "live_ms": res.overall,
                         "oracle_ms": est.overall,
                         "rel_err": est.overall / res.overall - 1,
                         "live_fwd_ms": res.fwd_comp.tolist(),
                         "live_bwd_ms": res.bwd_comp.tolist(),
                         "kernel_checks": checks[label]})
            timed[key] = live[-1]
            log(f"[table1 live] {label}: live {res.overall:.4f} ms (fwd "
                f"{np.round(res.fwd_comp, 3).tolist()}, bwd "
                f"{np.round(res.bwd_comp, 3).tolist()}), MeasuredOracle "
                f"{est.overall:.4f} ms; K1 at each device's shapes: forward "
                "bit-equal to plain, backward bit-equal to its replay, its "
                "plan to backward_plan, max |err| against float64 "
                "(plain's) " + ", ".join(
                    f"{c['bwd_err_vs_f64']:.3g} "
                    f"({c['plain_bwd_err_vs_f64']:.3g})"
                    for c in checks[label]))
    for r in summary["train"]["sim2real"]:
        if r["task"] < TABLE1_LIVE_TASKS and r["pooling"] is None:
            log(f"[table1 live] task {r['task']} dreamshard (phase 8): live "
                f"{r['live_ms']:.4f} ms, MeasuredOracle "
                f"{r['oracle_ms']:.4f} ms")
    launches = {"fwd": K.embedding_bag_cuda.launches,
                "bwd": K.embedding_bag_grad_cuda.launches}
    check(launches["fwd"] > 0 and launches["bwd"] > 0,
          f"the table 1 path launched K1 {launches}")
    check_idle(counters, (K.embedding_bag_cuda, K.embedding_bag_grad_cuda),
               "the table 1 path")
    log(f"[table1] K1 launches on the table 1 path: {launches['fwd']} "
        f"forward, {launches['bwd']} backward (live timing of "
        f"{len(timed)} distinct placements of {len(live)})")
    # (d) the RNN on the card against the CPU
    cross = rnn_cross_device(torch, np, rnn, test)
    summary["table1"] = {
        "rnn_train_s": out["train_s"], "rnn_rows": out["rows"],
        "dreamshard_rows": ctx["train_evals"],
        **{split: {k: v for k, v in row.items() if k != "placements"}
           for split, row in rows.items()},
        "live": live, "launches": launches, "cross_device": cross}
    return launches


def dlrm_nccl_check(torch, np) -> dict:
    """(a) ``make_sharded_lookup`` over NCCL at one rank (NCCL takes one
    rank a card) against ``lookup_unsharded`` on the card, bit for bit:
    forward and arena gradient.  8 tables of <= 2^16 rows on one shard,
    batch 4096."""
    import tempfile
    import torch.distributed as dist
    from repro_torch.data.pipeline import DLRMBatchStream
    from repro_torch.embedding import sharded as E
    from repro_torch.launch.train_dlrm import smoke_tables
    raw, plan = smoke_tables(1, 2 ** 16)
    gen = torch.Generator(device="cuda").manual_seed(0)
    (arena,) = E.init_arenas(plan, generator=gen, device="cuda")
    batch = DLRMBatchStream(raw, 4096, seed=0).batch_at(0)
    gidx = E.group_indices(plan, torch.from_numpy(batch["indices"]).cuda())
    w = torch.randn((4096, plan.k_max, plan.dim), generator=gen,
                    device="cuda")
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                                rank=0, world_size=1)
        try:
            lookup = E.make_sharded_lookup(plan, model_group=dist.group.WORLD)
            leaf = arena.clone().requires_grad_()
            out = lookup([leaf], plan.base_rows, gidx)
            out.backward(w)
            torch.cuda.synchronize()
            backend = dist.get_backend()
        finally:
            dist.destroy_process_group()
    ref_leaf = arena.clone().requires_grad_()
    ref = E.lookup_unsharded([ref_leaf], plan.base_rows, gidx, plan)
    ref.backward(w)
    check(backend == "nccl", f"the process group runs {backend}")
    check(bits_equal(torch, out, ref), "sharded lookup over NCCL: forward")
    check(bits_equal(torch, leaf.grad, ref_leaf.grad),
          "sharded lookup over NCCL: arena gradient")
    log(f"[dlrm nccl] make_sharded_lookup over {backend} at 1 rank "
        f"(8 tables, {int(plan.shard_rows[0])} rows, batch 4096): forward "
        f"{tuple(out.shape)} and arena gradient bit-equal to "
        "lookup_unsharded")
    return {"backend": backend, "rows": int(plan.shard_rows[0]),
            "bit_equal": True}


def dlrm_profile(torch, train, inputs) -> dict:
    """One training step under torch.profiler: device time by kernel name
    and the idle share of the window (an upper bound: the profiler slows
    the host)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        train(*inputs)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = sorted((e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA),
                  key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in rows) / 1e3
    by_kernel = [{"name": re.sub(r"void |at::native::|\(anonymous "
                                 r"namespace\)::", "", e.key)[:100],
                  "ms": e.self_device_time_total / 1e3, "count": e.count}
                 for e in rows]
    k1_fwd = sum(r["ms"] for r in by_kernel if "bag_kernel" in r["name"])
    k1_bwd = sum(r["ms"] for r in by_kernel
                 if r["name"].split("(")[0].split("<")[0] in K1_BWD_KERNELS)
    out = {"wall_ms": wall_ms, "device_busy_ms": busy,
           "device_ops": sum(e.count for e in rows),
           "idle_share": 1 - busy / wall_ms if busy else None,
           "k1_fwd_ms": k1_fwd, "k1_bwd_ms": k1_bwd,
           "by_kernel": by_kernel}
    log(f"[dlrm profile] one step (trained placement): wall {wall_ms:.2f} "
        f"ms under the profiler, kernels {busy:.2f} ms, "
        f"{out['device_ops']} device ops, "
        + (f"idle share <= {out['idle_share']:.3f}; " if busy else
           "no device time recorded (not measured); ")
        + f"K1 forward {k1_fwd:.2f} ms, K1 backward's kernels "
        f"{k1_bwd:.2f} ms; by kernel: "
        + "; ".join(f"{t['name']} {t['ms']:.2f} ms x{t['count']}"
                    for t in by_kernel[:12]))
    return out


def k1_case_check(torch, K, arena, rows, g, what: str) -> dict:
    """K1 and its backward on one arena, its ``(N, P)`` rows and an
    upstream gradient ``(N, D)``, against plain: the forward bit for bit;
    the backward keeps row 0 zero, equals its plain replay bit for bit
    (its order, any scale), its plan on the card equals ``backward_plan``
    and its max |err| against float64 is within 2x plain's + 1e-6 (the
    rule of phase 3b).  Returns both errors and the gradient's max
    |value|."""
    from repro_torch.kernels.embedding_bag.ref import (
        embedding_bag_grad_plain, embedding_bag_grad_replay,
        embedding_bag_plain)
    fwd_equal = bits_equal(torch, K.embedding_bag_cuda(arena, rows),
                           embedding_bag_plain(arena, rows))
    shape = tuple(arena.shape)
    got = K.embedding_bag_grad_cuda(shape, rows, g)
    replay_equal = bits_equal(torch, got, embedding_bag_grad_replay(
        shape, rows, g))
    plain = embedding_bag_grad_plain(shape, rows, g)
    torch.cuda.synchronize()
    check(fwd_equal, f"K1 != plain: {what}")
    check(not bool(got[0].any()), f"K1 backward row 0 not zero: {what}")
    check(replay_equal, f"K1 backward != its plain replay: {what}")
    check(plan_equal(torch, K, shape, rows),
          f"the plan on the card != backward_plan: {what}")
    ref64 = grad_f64(torch, shape, rows, g)
    err, plain_err = grad_errs(torch, got, plain, ref64)
    return {"fwd_bit_equal": True, "bwd_replay_bit_equal": True,
            "grad_max_abs": float(ref64.abs().max()),
            "bwd_err_vs_f64": err, "plain_bwd_err_vs_f64": plain_err}


def dlrm_kernel_checks(torch, K, model, plan, inputs) -> dict:
    """K1 and its backward at the full-width step's own shapes, shard by
    shard (``k1_case_check``): the step's rebased ``(B*K, P)`` indices,
    its arenas and the upstream gradient the step's loss sends each
    shard's lookup.  The launches made here are taken back off the counts,
    so those count the training path alone."""
    from repro_torch.embedding import sharded as E
    from repro_torch.models.dlrm import DLRM
    from repro_torch.profiling.microbench import median_time_ms
    counts = (K.embedding_bag_cuda.launches,
              K.embedding_bag_grad_cuda.launches)
    gidx, dense, labels = inputs
    held = {}

    def capture(arenas, bases, g):
        held["out"] = E.lookup_unsharded(
            [a.detach() for a in arenas], bases, g, plan).requires_grad_()
        return held["out"]

    (upstream,) = torch.autograd.grad(
        DLRM.loss(model(dense, gidx, capture), labels), held["out"])
    del held
    kk, shards = plan.k_max, []
    for s, arena in enumerate(model.arenas):
        arena = arena.detach()
        rows = E.shard_rows_of(plan.base_rows[s],
                               gidx[:, s * kk:(s + 1) * kk])
        g = upstream[:, s * kk:(s + 1) * kk].reshape(rows.shape[0], -1)
        g = g.contiguous()
        shape = tuple(arena.shape)
        errs = k1_case_check(torch, K, arena, rows, g, f"the DLRM step's "
                             f"shard {s} ({shape} arena, "
                             f"{tuple(rows.shape)} indices)")
        bwd_ms = median_time_ms(K.embedding_bag_grad_cuda, (shape, rows, g),
                                warmup=1, repeats=5)
        scratch = K.scratch_bytes(K.embedding_bag_grad_cuda.sizes(
            shape, rows), shape[1])
        live = int((rows > 0).sum())
        hot = int(torch.bincount(rows[rows > 0].long()).max()) if live else 0
        shards.append({"rows": shape[0], "bags": int(rows.shape[0]),
                       "pool": int(rows.shape[1]), "live_slots": live,
                       "hottest_row_slots": hot, "bwd_ms": bwd_ms,
                       "scratch_bytes": scratch, **errs})
        del rows, g
        torch.cuda.empty_cache()
    K.embedding_bag_cuda.launches, K.embedding_bag_grad_cuda.launches = counts
    log("[dlrm kernels] K1 at the step's shapes (trained placement, batch "
        "0), per shard: forward bit-equal to plain, backward bit-equal to "
        "its plain replay and its plan on the card to backward_plan; "
        "backward ms (median of 5, CUDA events) and scratch bytes; backward "
        "max |err| against float64 (plain's; limit 2x plain's + 1e-6) beside "
        "the gradient's max |value|: " + "; ".join(
            f"{r['rows']} rows, {r['bags']} x {r['pool']} bags, "
            f"{r['live_slots']} live slots, hottest row {r['hottest_row_slots']}"
            f": {r['bwd_ms']:.3f} ms, scratch {r['scratch_bytes']}, "
            f"{r['bwd_err_vs_f64']:.3g} ({r['plain_bwd_err_vs_f64']:.3g}) "
            f"of {r['grad_max_abs']:.3g}" for r in shards))
    return {"shards": shards}


def dlrm_full_width(torch, np, K, counters, task0, summary) -> dict:
    """(b) DLRM at FULL's widths over test task 0's 50 tables (rows capped
    at 2^20), batch 65536, float32, every shard's arena on this card
    through ``lookup_unsharded``: K1 against plain at the step's shapes
    (``dlrm_kernel_checks``), then 1 warm-up and 2 timed steps for the
    trained placement and for the random one, on the same batches.
    Returns the K1 launches of these steps (and of the profiled one)."""
    from repro_torch.configs import dlrm as CD
    from repro_torch.core import features as FEAT
    from repro_torch.data.pipeline import DLRMBatchStream, Prefetcher
    from repro_torch.embedding.plan import build_plan
    from repro_torch.launch import train_dlrm as TD
    from repro_torch.models.dlrm import DLRM
    task, oracle = task0["task"], task0["oracle"]
    raw = task.raw_features.copy()
    raw[:, FEAT.HASH_SIZE] = np.minimum(raw[:, FEAT.HASH_SIZE], MAX_ROWS)
    cfg = dataclasses.replace(CD.FULL, n_tables=raw.shape[0])
    t0 = time.perf_counter()
    prefetch = Prefetcher(DLRMBatchStream(raw, BATCH, seed=0))
    try:
        batches = [prefetch.next() for _ in range(DLRM_STEPS)]
    finally:
        prefetch.close()
    host_s = (time.perf_counter() - t0) / DLRM_STEPS
    log(f"[dlrm] {DLRM_STEPS} batches of {BATCH} over {raw.shape[0]} tables "
        f"({int(raw[:, FEAT.HASH_SIZE].sum())} rows) from DLRMBatchStream "
        f"through Prefetcher: {host_s:.3f} s of host time a batch")
    # the labels are Bernoulli draws independent of the features: no
    # model's mean BCE goes below their entropy at the batches' click rate
    rate = float(np.mean([b["labels"].mean() for b in batches]))
    floor = -(rate * np.log(rate) + (1 - rate) * np.log1p(-rate))
    for c in counters:                         # counts of this path only
        c.launches = 0
    out = {"host_s_per_batch": host_s, "loss_floor": floor,
           "placements": {}}
    steps_run = 0
    for name, assignment in task0["placements"].items():
        plan = build_plan(raw, assignment, task.n_devices)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        before = (K.embedding_bag_cuda.launches,
                  K.embedding_bag_grad_cuda.launches)
        model = DLRM(cfg, plan, seed=0, device="cuda")
        if name == "trained":
            out["kernel_checks"] = dlrm_kernel_checks(
                torch, K, model, plan, TD.to_device(batches[0], plan,
                                                    "cuda"))
            torch.cuda.reset_peak_memory_stats()
        train = TD.make_trainer(model, plan)
        arena_bytes = sum(a.numel() * a.element_size() for a in model.arenas)
        ms, losses = [], []
        for batch in batches:
            inputs = TD.to_device(batch, plan, "cuda")
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            loss = train(*inputs)
            end.record()
            end.synchronize()
            ms.append(start.elapsed_time(end))
            losses.append(float(loss))
        steps_run += len(batches)
        peak = torch.cuda.max_memory_allocated()
        launches = (K.embedding_bag_cuda.launches - before[0],
                    K.embedding_bag_grad_cuda.launches - before[1])
        cost = float(oracle.evaluate(task.raw_features, assignment,
                                     task.n_devices).overall)
        timed = ms[DLRM_WARMUP:]
        row = {"tables_per_shard": np.bincount(
                   assignment, minlength=task.n_devices).tolist(),
               "shard_rows": plan.shard_rows.tolist(),
               "step_ms": ms, "median_step_ms": float(np.median(timed)),
               "peak_bytes": peak, "arena_bytes": arena_bytes,
               "k1_launches": launches, "losses": losses,
               "measured_oracle_ms": cost}
        out["placements"][name] = row
        log(f"[dlrm] {name}: tables/shard {row['tables_per_shard']}, shard "
            f"rows {row['shard_rows']}, arenas {arena_bytes} bytes; median "
            f"step {row['median_step_ms']:.3f} ms over {len(timed)} timed "
            f"steps (CUDA events, indices on the card to updated "
            f"parameters; all 4 shards on this one card, so a step sums "
            f"the shards: not the slowest device's time), steps "
            f"{np.round(ms, 3).tolist()} ms; peak "
            f"{peak} bytes (max_memory_allocated); K1 launches "
            f"{launches[0]} forward, {launches[1]} backward over "
            f"{len(batches)} steps; losses {np.round(losses, 5).tolist()} "
            f"(floor {floor:.5f}); MeasuredOracle cost {cost:.4f} ms; host "
            f"{host_s:.3f} s a batch")
        check(bool(np.isfinite(losses).all()), f"{name}: non-finite loss")
        used = int((np.bincount(assignment,
                                minlength=task.n_devices) > 0).sum())
        check(launches == (task.n_devices * len(batches),
                           used * len(batches)),
              f"{name}: K1 launches {launches}, expected "
              f"{task.n_devices} forward and {used} backward a step")
        if name == "trained":
            out["profile"] = dlrm_profile(torch, train, TD.to_device(
                batches[0], plan, "cuda"))
            steps_run += 1
        del model, train, inputs
    out["launches"] = {"fwd": K.embedding_bag_cuda.launches,
                       "bwd": K.embedding_bag_grad_cuda.launches}
    check_idle(counters, (K.embedding_bag_cuda, K.embedding_bag_grad_cuda),
               "the DLRM training path")
    out["steps"] = steps_run
    return out


def dlrm_cross_device(torch, np) -> dict:
    """(c) SMOKE's widths over 8 tables on 4 shards, batch 64: 3 training
    steps from the same weights and batches on the card (K1) and on the
    CPU (plain).  Logits, losses and every parameter must agree within
    1e-5 relative (max |err| over max |cpu value|)."""
    from repro_torch.configs import dlrm as CD
    from repro_torch.data.pipeline import DLRMBatchStream
    from repro_torch.launch import train_dlrm as TD
    from repro_torch.models.dlrm import DLRM
    raw, plan = TD.smoke_tables(4, 500)
    stream = DLRMBatchStream(raw, CD.SMOKE_BATCH, n_dense=4, seed=0)
    batches = [stream.batch_at(i) for i in range(3)]
    weights = DLRM(CD.SMOKE, plan, seed=0, device="cpu").state_dict()
    res = {}
    for dev in ("cuda", "cpu"):
        model = DLRM(CD.SMOKE, plan, device=dev)
        model.load_state_dict(weights)
        gidx, dense, _ = TD.to_device(batches[0], plan, dev)
        with torch.no_grad():
            logits = model(dense, gidx, TD.unsharded_lookup(plan))
        train = TD.make_trainer(model, plan)
        losses = [float(train(*TD.to_device(b, plan, dev))) for b in batches]
        res[dev] = (logits.cpu(), np.asarray(losses),
                    {k: v.cpu() for k, v in model.state_dict().items()})

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    (lg, sg, pg), (lc, sc, pc) = res["cuda"], res["cpu"]
    errs = {"logits": rel(lg, lc),
            "loss": float(np.max(np.abs(sg - sc) / np.abs(sc))),
            "params": max(rel(pg[k], pc[k]) for k in pc)}
    log(f"[dlrm cross] SMOKE, 3 steps cuda (K1) vs cpu (plain): logits "
        f"{errs['logits']:.3g}, losses {errs['loss']:.3g}, parameters "
        f"{errs['params']:.3g} max relative error (limit 1e-5); losses "
        f"{np.round(sc, 5).tolist()}")
    for what, e in errs.items():
        check(e <= 1e-5, f"DLRM cuda vs cpu: {what} {e:.3g} > 1e-5")
    return errs


def phase_dlrm(torch, np, K, counters, task0, summary: dict) -> dict:
    """The DLRM training step over DreamShard's placement: (a) the sharded
    lookup over NCCL, (b) the full-width step, (c) card against CPU.
    Returns K1's launches in (b)."""
    nccl = dlrm_nccl_check(torch, np)
    torch.cuda.empty_cache()
    full = dlrm_full_width(torch, np, K, counters, task0, summary)
    torch.cuda.empty_cache()
    cross = dlrm_cross_device(torch, np)
    summary["dlrm"] = {"nccl": nccl, "full_width": full, "cross": cross}
    log(f"[dlrm] K1 launches on the DLRM training path: "
        f"{full['launches']['fwd']} forward, {full['launches']['bwd']} "
        f"backward over {full['steps']} steps")
    return full["launches"]


SEARCH_MAX_EVALS = 256           # phase 11 (a): rows a task, lns/evolution/beam
SEARCH_BUDGET_MS = 50.0          # b9's headline budget a task
SHARD_REFINE_EVALS = 192         # phase 11 (b): b13's paper-regime refine rows
OVERSIZE_SCALE = 2.5             # b13's largest table over one device's memory


def _search_spend(np, placements, seeds) -> dict:
    """Mean oracle rows and hardware evaluations a refined placement
    spent, from its provenance (``SearchPlacer.refine`` adds its scorer's
    ``evals - 1`` to ``candidates`` and ``hardware_evals`` to
    ``oracle_evals``)."""
    evals = [p.candidates - s.candidates + 1 for p, s in zip(placements,
                                                             seeds)]
    hw = [p.oracle_evals - s.oracle_evals for p, s in zip(placements, seeds)]
    return {"evals": float(np.mean(evals)), "hardware_evals": float(
        np.mean(hw))}


def placement_kernel_checks(torch, K, task, assignment,
                            label: str = "a search placement") -> list:
    """K1 and its backward at the shapes ``measure_placement`` gives them
    for one placement (batch 65536, each table's own pooling, rows capped
    at 2^20): each used device's arena shape and its very indices
    (``placement_inputs``), with a normal arena (row 0 zero) and a normal
    upstream gradient in place of the zeros and ones it times, held by
    ``k1_case_check``; ``label`` names the placement in a failure.  The
    launches made here are taken back off the counts."""
    from repro_torch.profiling.microbench import placement_inputs
    counts = (K.embedding_bag_cuda.launches,
              K.embedding_bag_grad_cuda.launches)
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = []
    for d, _, shape, idx in placement_inputs(
            task.raw_features, assignment, task.n_devices, batch_size=BATCH,
            pooling=None, max_rows=MAX_ROWS):
        arena = torch.randn(shape, generator=gen, device="cuda")
        arena[0] = 0.0
        idx = torch.as_tensor(idx, device="cuda")
        g = torch.randn((idx.shape[0], shape[1]), generator=gen,
                        device="cuda")
        out.append({"device": d, "rows": shape[0],
                    "bags": int(idx.shape[0]), "pool": int(idx.shape[1]),
                    **k1_case_check(torch, K, arena, idx, g, f"device {d} "
                                    f"of {label} ({shape} arena, "
                                    f"{tuple(idx.shape)} indices)")})
        del arena, idx, g
        torch.cuda.empty_cache()
    K.embedding_bag_cuda.launches, K.embedding_bag_grad_cuda.launches = counts
    return out


def search_refine(torch, np, K, ctx) -> dict:
    """(a) b9's paper regime on DLRM-50 (4) over the 20 test tasks: the
    trained agent's placements refined by ``DreamShardPlacer(agent,
    refiner=SearchPlacer(measured, ...))`` for lns, evolution and beam+lns
    at a fixed row budget and lns at b9's 50 ms a task; every refined
    cost at most its seed's by the card's ``MeasuredOracle``; then test
    task 0's seed and its best refined placement timed live with K1, and
    K1 held to plain at each of their devices' shapes."""
    from repro_torch.api import (DreamShardPlacer, SearchConfig,
                                 SearchPlacer, measure_placements)
    from repro_torch.profiling.microbench import measure_placement
    agent, measured, test = ctx["agent"], ctx["measured"], ctx["test"]
    seeds = agent.as_placer(n_candidates=16).place_many(test)
    seed_costs = measure_placements(measured, test, seeds)
    rows = {}
    best = (float(seed_costs[0]), seeds[0], "seed")
    for name, kw in (("lns", {"max_evals": SEARCH_MAX_EVALS}),
                     ("evolution", {"max_evals": SEARCH_MAX_EVALS}),
                     ("beam+lns", {"max_evals": SEARCH_MAX_EVALS}),
                     ("lns@50ms", {"budget_ms": SEARCH_BUDGET_MS})):
        cfg = SearchConfig(strategy=name.split("@")[0], seed=0,
                           **{"budget_ms": None, **kw})
        placer = DreamShardPlacer(agent, n_candidates=16, refiner=SearchPlacer(
            measured, config=cfg, agent=agent))
        t0 = time.perf_counter()
        refined = placer.place_many(test)
        host_ms = (time.perf_counter() - t0) * 1e3 / len(test)
        costs = measure_placements(measured, test, refined)
        check(bool(np.array_equal(costs, [p.est_cost_ms for p in refined])),
              f"search {name}: the refined estimate is not the oracle's")
        worse = np.flatnonzero(costs > seed_costs)
        check(worse.size == 0, f"search {name}: refined costs more than its "
              f"seed on tasks {worse.tolist()}")
        for p, s in zip(refined, seeds):
            check(p.strategy == placer.session.refiner.name
                  and p.n_devices == s.n_devices,
                  f"search {name}: provenance {p.strategy}")
        row = {"placer": placer.name, "mean_seed_ms": float(seed_costs.mean()),
               "mean_refined_ms": float(costs.mean()),
               "gain": float(seed_costs.mean() / costs.mean() - 1),
               "improved_tasks": int((costs < seed_costs).sum()),
               "host_ms_per_task": host_ms,
               **_search_spend(np, refined, seeds)}
        rows[name] = row
        log(f"[search] {placer.name}: mean MeasuredOracle cost over "
            f"{len(test)} tasks {row['mean_seed_ms']:.4f} -> "
            f"{row['mean_refined_ms']:.4f} ms ({row['gain']:+.2%}; "
            f"{row['improved_tasks']} tasks improved, none worse); "
            f"evals {row['evals']:.1f}, hardware_evals "
            f"{row['hardware_evals']:.1f} a task; host "
            f"{host_ms:.2f} ms a task (decode included)")
        if costs[0] < best[0]:
            best = (float(costs[0]), refined[0], name)
    # live K1 timing of test task 0's seed and its best refined placement
    task, live = test[0], []
    for label, p in (("seed", seeds[0]), (f"best refined ({best[2]})",
                                          best[1])):
        est = measured.evaluate(task.raw_features, p.assignment,
                                task.n_devices)
        res = measure_placement(task.raw_features, p.assignment,
                                task.n_devices, batch_size=BATCH,
                                pooling=None, max_rows=MAX_ROWS,
                                device="cuda")
        check(math.isfinite(res.overall), "finite live cost")
        checks = placement_kernel_checks(torch, K, task, p.assignment)
        live.append({"placement": label, "live_ms": res.overall,
                     "oracle_ms": est.overall,
                     "live_fwd_ms": res.fwd_comp.tolist(),
                     "live_bwd_ms": res.bwd_comp.tolist(),
                     "kernel_checks": checks})
        log(f"[search live] task 0 {label}: live {res.overall:.4f} ms (fwd "
            f"{np.round(res.fwd_comp, 3).tolist()}, bwd "
            f"{np.round(res.bwd_comp, 3).tolist()}), MeasuredOracle "
            f"{est.overall:.4f} ms; K1 at each device's shapes: forward "
            "bit-equal to plain, backward bit-equal to its replay, its plan "
            "to backward_plan, max |err| against float64 (plain's) " +
            ", ".join(f"{c['bwd_err_vs_f64']:.3g} "
                      f"({c['plain_bwd_err_vs_f64']:.3g})" for c in checks))
    return {"strategies": rows, "live": live}


def oversized_tasks(np, test, capacity_gb: float) -> list:
    """b13's construction: each task with its largest table inflated to
    ``OVERSIZE_SCALE`` x one device's memory, illegal for every
    whole-table placement."""
    from repro_torch.core import features as FEAT
    from repro_torch.data.tasks import Task
    out = []
    for t in test:
        raw = np.array(t.raw_features, dtype=np.float64)
        raw[int(np.argmax(raw[:, FEAT.TABLE_SIZE_GB])),
            FEAT.TABLE_SIZE_GB] = OVERSIZE_SCALE * capacity_gb
        out.append(Task.of(raw, t.n_devices, name=t.name + "-over"))
    return out


def sharding_oversized(np, ctx) -> dict:
    """(b) b13's construction on the 20 DLRM-50 (4) test tasks: every
    whole-table baseline placer is illegal on every task,
    ``ShardingPlacer`` is legal on every task, and ``refine_sharded`` is
    never worse than its seed, all priced by the card's
    ``MeasuredOracle.evaluate_sharded`` (``KernelOracle`` gives the same
    prices and verdicts)."""
    from repro_torch.api import (ShardingPlacer, legal_batch, legal_sharded,
                                 make_baseline_placers, measure_placements,
                                 SearchConfig, refine_sharded)
    measured, kernel_oracle = ctx["measured"], ctx["oracle"]
    tasks = oversized_tasks(np, ctx["test"], measured.mem_capacity_gb)
    baselines = make_baseline_placers(measured, include_portfolio=True)
    for name, placer in baselines.items():
        for t, p in zip(tasks, placer.place_many(tasks)):
            check(not bool(legal_batch(measured, t.raw_features,
                                       p.assignment[None], t.n_devices)[0]),
                  f"sharding: whole-table {name} is legal on {t.name}")
    sharder = ShardingPlacer(measured)
    cfg = SearchConfig(strategy="lns", budget_ms=None,
                       max_evals=SHARD_REFINE_EVALS, seed=0)
    placed, refined, host_s = [], [], [0.0, 0.0]
    for t in tasks:
        t0 = time.perf_counter()
        p = sharder.place(t)
        t1 = time.perf_counter()
        r = refine_sharded(measured, t, p, cfg)
        host_s[0] += t1 - t0
        host_s[1] += time.perf_counter() - t1
        for q, what in ((p, "ShardingPlacer"), (r, "refine_sharded")):
            a = q.shard_assignment[None]
            legal = legal_sharded(measured, t.raw_features, q.sharding, a,
                                  t.n_devices)
            check(q.is_sharded and bool(legal[0]),
                  f"sharding: {what} is not legal on {t.name}")
            check(bool(np.array_equal(legal, kernel_oracle.legal_sharded(
                t.raw_features, q.sharding, a, t.n_devices))),
                "sharding: KernelOracle.legal_sharded disagrees")
            kres = kernel_oracle.evaluate_sharded(t.raw_features, q.sharding,
                                                  a, t.n_devices)[0]
            check(kres.overall == q.est_cost_ms, "sharding: KernelOracle "
                  "prices the placement differently")
        check(r.est_cost_ms <= p.est_cost_ms,
              f"sharding: refine_sharded is worse on {t.name}: "
              f"{r.est_cost_ms} > {p.est_cost_ms}")
        placed.append(p)
        refined.append(r)
    seed_ms = measure_placements(measured, tasks, placed)
    ref_ms = measure_placements(measured, tasks, refined)
    check(bool(np.array_equal(seed_ms, [p.est_cost_ms for p in placed])) and
          bool(np.array_equal(ref_ms, [p.est_cost_ms for p in refined])),
          "sharding: measure_placements disagrees with the placers")
    out = {"tasks": len(tasks), "capacity_gb": measured.mem_capacity_gb,
           "whole_table_placers": sorted(baselines),
           "mean_shards": float(np.mean([p.n_shards for p in placed])),
           "mean_refined_shards": float(np.mean([p.n_shards
                                                 for p in refined])),
           "max_k": int(max(p.sharding.shard_counts.max() for p in placed)),
           "mean_sharded_ms": float(seed_ms.mean()),
           "mean_refined_ms": float(ref_ms.mean()),
           "improved_tasks": int((ref_ms < seed_ms).sum()),
           "host_ms_per_task": [s * 1e3 / len(tasks) for s in host_s]}
    log(f"[sharding] {len(tasks)} oversized DLRM-50 (4) tasks (largest "
        f"table {OVERSIZE_SCALE} x {measured.mem_capacity_gb} GB): all "
        f"{len(baselines)} whole-table placers illegal on every task; "
        f"ShardingPlacer legal on all, {out['mean_shards']:.2f} shards a "
        f"task (K up to {out['max_k']}), mean MeasuredOracle cost "
        f"{out['mean_sharded_ms']:.4f} ms; refine_sharded (lns, "
        f"{SHARD_REFINE_EVALS} rows) {out['mean_refined_ms']:.4f} ms, "
        f"{out['mean_refined_shards']:.2f} shards, {out['improved_tasks']} "
        f"tasks improved, none worse; host {out['host_ms_per_task'][0]:.2f}"
        f" + {out['host_ms_per_task'][1]:.2f} ms a task")
    return {"summary": out, "task": tasks[0], "placement": placed[0]}


def split_arenas(torch, whole_plan, whole, plan, raw):
    """The column-sharded plan's arenas filled from the whole-table plan's
    arenas of the same weights: each slot's rows take its owner's rows,
    columns ``[col_start, col_end)`` into lanes ``[0, width)``; the other
    lanes and row 0 stay zero."""
    from repro_torch.core import features as FEAT
    rows = raw[:, FEAT.HASH_SIZE].astype(int)
    where = {}                                  # table -> (shard, base row)
    for s, g in enumerate(whole_plan.groups):
        for j, t in enumerate(g):
            where[int(t)] = (s, int(whole_plan.base_rows[s, j]))
    out = []
    for s, g in enumerate(plan.groups):
        arena = torch.zeros((int(plan.shard_rows[s]), plan.dim),
                            device=whole[0].device)
        for j, i in enumerate(g):
            t = int(plan.slot_table[s, j])
            c0, c1 = (int(c) for c in plan.slot_cols[s, j])
            ws, wb = where[t]
            b = int(plan.base_rows[s, j])
            arena[b:b + rows[t], :c1 - c0] = whole[ws][wb:wb + rows[t], c0:c1]
        out.append(arena)
    return out


def table_grad_refs(torch, idx_t, g_t, n_rows: int):
    """(float64 gradient, plain's float32 error) of one table's ``n_rows``
    rows from its ``(B, P)`` indices (-1 padding) and its columns of the
    upstream gradient ``(B, w)``, for the rule that holds K1's backward to
    twice plain's error + 1e-6.  Plain is the slot-by-slot float32
    ``index_add_``; its error is taken in one fixed order, on the host
    (each row's adds in slot order, then batch order, the same every
    run), so that the limit does not move with the order of CUDA's
    atomics, and capped at the largest that 10 runs of it on the card
    give in the atomics' order (the rule before), so that it is never
    looser than that rule over those runs."""
    dev = g_t.device

    def index_sum(dtype, idx, g):
        out = torch.zeros((n_rows + 1, g.shape[1]), dtype=dtype,
                          device=g.device)
        for j in range(idx.shape[1]):
            rows = torch.where(idx[:, j] >= 0, idx[:, j], n_rows).long()
            out.index_add_(0, rows, g.to(dtype))
        return out[:n_rows]

    ref64 = index_sum(torch.float64, idx_t, g_t)

    def plain_err(idx, g):
        plain = index_sum(torch.float32, idx, g).to(dev, torch.float64)
        return float((plain - ref64).abs().max())

    atomics = max(plain_err(idx_t, g_t) for _ in range(10))
    return ref64, min(plain_err(idx_t.cpu(), g_t.cpu()), atomics)


def sharded_lookup(torch, np, K, counters, shard_ctx) -> dict:
    """(c) The column-sharded lookup at full batch: oversized test task 0's
    ``ShardingPlacer`` placement (rows capped at 2^20), its plan from
    ``build_plan(sharding=)``, arenas split by columns from a whole-table
    plan's arenas of the same weights, batch 65536 at each table's own
    pooling.  ``lookup_unsharded`` + ``combine_shard_outputs`` (K1 forward
    per shard) must equal the whole-table plan's lookup bit for bit, and
    each shard's K1 output its plain version on the same arena and rebased
    rows; from one upstream gradient, K1's backward per shard must equal
    its plain replay bit for bit, keep row 0 and the lanes past each slot's width
    zero, and hold every slot to its table's float64 gradient columns by
    phase 3b's rule (the split tables' whole-table gradient columns too).
    The whole-table reference runs first and only its output and the split
    tables' gradient rows are kept."""
    from repro_torch.core import features as FEAT
    from repro_torch.data.pipeline import DLRMBatchStream
    from repro_torch.embedding import sharded as E
    from repro_torch.embedding.plan import build_plan
    from repro_torch.kernels.embedding_bag.ref import (
        embedding_bag_grad_replay, embedding_bag_plain)
    task, placement = shard_ctx["task"], shard_ctx["placement"]
    spec = placement.sharding
    raw = task.raw_features.copy()
    raw[:, FEAT.HASH_SIZE] = np.minimum(raw[:, FEAT.HASH_SIZE], MAX_ROWS)
    rows = raw[:, FEAT.HASH_SIZE].astype(int)
    dims = raw[:, FEAT.DIM].astype(int)
    split = np.flatnonzero(spec.shard_counts > 1)
    t0 = time.perf_counter()
    idx = torch.from_numpy(DLRMBatchStream(raw, BATCH, seed=0).batch_at(0)[
        "indices"]).cuda()
    host_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(0)
    whole_plan = build_plan(raw, placement.assignment, task.n_devices)
    plan = build_plan(raw, placement.shard_assignment, task.n_devices,
                      sharding=spec)
    whole = [a.requires_grad_() for a in E.init_arenas(
        whole_plan, generator=gen, device="cuda")]
    upstream = torch.randn((BATCH, raw.shape[0], plan.dim), generator=gen,
                           device="cuda")
    # the whole-table reference: keep its output and the split tables'
    # gradient rows only
    gidx = E.group_indices(whole_plan, idx)
    out_w = E.combine_shard_outputs(whole_plan, E.lookup_unsharded(
        whole, whole_plan.base_rows, gidx, whole_plan))
    grads_w = torch.autograd.grad(out_w, whole, upstream)
    out_w = out_w.detach()
    kept = {}
    for s, g in enumerate(whole_plan.groups):
        for j, t in enumerate(g):
            if int(t) in split:
                b = int(whole_plan.base_rows[s, j])
                kept[int(t)] = grads_w[s][b:b + rows[t], :dims[t]].clone()
    del grads_w, gidx
    arenas = [a.requires_grad_() for a in split_arenas(
        torch, whole_plan, [a.detach() for a in whole], plan, raw)]
    del whole
    torch.cuda.empty_cache()
    # the column-sharded lookup: the phase's path, counted from zero
    gidx = E.group_indices(plan, idx)
    for c in counters:
        c.launches = 0
    grouped = E.lookup_unsharded(arenas, plan.base_rows, gidx, plan)
    out = E.combine_shard_outputs(plan, grouped)
    *grads, g_grouped = torch.autograd.grad(out, [*arenas, grouped],
                                            upstream)
    torch.cuda.synchronize()
    launches = {"fwd": K.embedding_bag_cuda.launches,
                "bwd": K.embedding_bag_grad_cuda.launches}
    check_idle(counters, (K.embedding_bag_cuda, K.embedding_bag_grad_cuda),
               "the sharded lookup")
    check(launches == {"fwd": plan.n_shards, "bwd": plan.n_shards},
          f"sharded lookup: K1 launches {launches}, expected one forward "
          f"and one backward for each of the {plan.n_shards} shards")
    out = out.detach()
    lanes = torch.as_tensor(np.arange(plan.dim)[None, :] < dims[:, None],
                            device="cuda")                 # (M, D)
    check(bits_equal(torch, out[:, lanes], out_w[:, lanes]),
          "sharded lookup: the column-sharded forward != the whole-table "
          "plan's")
    check(not bool(out[:, ~lanes].any()),
          "sharded lookup: lanes past a table's dim are not zero")
    del out, out_w
    grouped = grouped.detach()
    kk, shards, slots = plan.k_max, [], []
    for s, g in enumerate(plan.groups):
        if not len(g):
            continue
        grad = grads[s]
        shape = tuple(grad.shape)
        rows_s = E.shard_rows_of(plan.base_rows[s], gidx[:, s * kk:(s + 1) * kk])
        fwd = grouped[:, s * kk:(s + 1) * kk].reshape(rows_s.shape[0], -1)
        check(bits_equal(torch, fwd, embedding_bag_plain(
            arenas[s].detach(), rows_s)),
            f"sharded lookup: shard {s}'s K1 forward != plain")
        g_s = g_grouped[:, s * kk:(s + 1) * kk].reshape(rows_s.shape[0], -1)
        replay = embedding_bag_grad_replay(shape, rows_s, g_s.contiguous())
        check(bits_equal(torch, grad, replay),
              f"sharded lookup: shard {s}'s K1 backward != its plain replay")
        check(not bool(grad[0].any()), f"shard {s}: row 0 not zero")
        del fwd, replay, rows_s, g_s
        width = int(spec.widths[g].max())
        check(not bool(grad[:, width:].any()),
              f"shard {s}: gradient past the widest slot's lanes")
        for j, i in enumerate(g):
            t = int(plan.slot_table[s, j])
            c0, c1 = (int(c) for c in plan.slot_cols[s, j])
            b = int(plan.base_rows[s, j])
            ref64, plain_err = table_grad_refs(
                torch, idx[:, t], upstream[:, t, c0:c1].contiguous(),
                int(rows[t]))
            got = grad[b:b + rows[t], :c1 - c0]
            err = float((got.double() - ref64).abs().max())
            row = {"shard": s, "table": t, "cols": [c0, c1], "err": err,
                   "plain_err": plain_err}
            check(err <= 2 * plain_err + 1e-6, f"sharded lookup: shard {s} "
                  f"table {t} cols {c0}:{c1} max |err| {err:.3g} against "
                  f"float64 over 2 x plain's {plain_err:.3g} + 1e-6")
            if t in kept:
                whole_cols = kept[t][:, c0:c1]
                row["whole_err"] = float((whole_cols.double() - ref64)
                                         .abs().max())
                row["vs_whole"] = float((got - whole_cols).abs().max())
                check(row["whole_err"] <= 2 * plain_err + 1e-6,
                      f"whole-table table {t}: max |err| "
                      f"{row['whole_err']:.3g} over 2 x {plain_err:.3g}")
            slots.append(row)
            del ref64
        shards.append({"shard": s, "rows": shape[0], "slots": len(g)})
    peak = torch.cuda.max_memory_allocated()
    split_rows = [r for r in slots if "whole_err" in r]
    out = {"spec_k": spec.shard_counts.tolist(), "n_shards": spec.n_shards,
           "split_tables": split.tolist(), "shards": shards,
           "launches": launches, "peak_bytes": peak, "host_s": host_s,
           "max_err": max(r["err"] for r in slots),
           "max_plain_err": max(r["plain_err"] for r in slots),
           "split_slots": split_rows}
    log(f"[sharded lookup] oversized task 0: {spec.n_shards} column shards "
        f"of {raw.shape[0]} tables (K {spec.shard_counts[split].tolist()} "
        f"for tables {split.tolist()}), shard rows "
        f"{plan.shard_rows.tolist()}, batch {BATCH} ({host_s:.1f} s of host "
        f"time for its indices): forward bit-equal to the whole-table "
        f"plan's, K1 per shard bit-equal to plain; K1 backward per shard bit-equal to its plain replay, row "
        f"0 and the lanes past each slot zero; {len(slots)} slots held to "
        f"their float64 gradient columns, max |err| {out['max_err']:.3g} "
        f"(plain's up to {out['max_plain_err']:.3g}); the split tables' "
        "slots against the whole-table gradient: " + "; ".join(
            f"table {r['table']} cols {r['cols']}: {r['err']:.3g} (whole "
            f"{r['whole_err']:.3g}, max |shard - whole| {r['vs_whole']:.3g})"
            for r in split_rows)
        + f"; K1 launches {launches['fwd']} forward, {launches['bwd']} "
        f"backward; peak {peak} bytes (max_memory_allocated)")
    return out


def phase_search_shard(torch, np, K, counters, ctx, summary: dict) -> dict:
    """Search and the sharding placer on the card: (a) search-refined
    placements and their live K1 timing, (b) oversized tasks placed by
    column sharding, (c) the column-sharded lookup at full batch.  Returns
    K1's launches on the search path ((a) and (b)) and on the sharded
    lookup ((c)), each counted from zero."""
    for c in counters:                         # counts of this path only
        c.launches = 0
    search = search_refine(torch, np, K, ctx)
    shard = sharding_oversized(np, ctx)
    search_launches = {"fwd": K.embedding_bag_cuda.launches,
                       "bwd": K.embedding_bag_grad_cuda.launches}
    check(search_launches["fwd"] > 0 and search_launches["bwd"] > 0,
          f"the search path launched K1 {search_launches}")
    check_idle(counters, (K.embedding_bag_cuda, K.embedding_bag_grad_cuda),
               "the search path")
    torch.cuda.empty_cache()
    lookup = sharded_lookup(torch, np, K, counters, shard)
    torch.cuda.empty_cache()
    summary["search_shard"] = {"search": search, "sharding": shard["summary"],
                               "sharded_lookup": lookup,
                               "search_launches": search_launches}
    log(f"[search] K1 launches on the search path: {search_launches['fwd']} "
        f"forward, {search_launches['bwd']} backward (live timing of 2 "
        "placements)")
    return {"search": search_launches, "sharded lookup": lookup["launches"]}

# phase 12: b11's and b12's paper regimes (``benchmarks/b11_serve.py:68-75``,
# ``benchmarks/b12_resilience.py:83-95``), the same trace at 4 and 8 devices
SERVE_TRAFFIC = dict(n_jobs=12, n_tables=50, n_requests=1500, drift=0.8,
                     zipf=1.0, tail_jobs=8, seed=0)
SERVE_ADMISSION = dict(max_wait_ms=2.0, max_batch=8, ewma_alpha=0.3,
                       replace_max_evals=96, replace_budget_ms=None, seed=0)
SERVE_THRESHOLD = 0.05           # max per-table TV distance (b11 "drift")
SERVE_MS_PER_GB = 25.0           # migration term and b11's accounting charge
SERVE_COLD_REQUESTS = 50         # b11's cold leg, cut to the trace's first 50
MIN_HIT_RATE = 0.5               # b11's limits
HIT_SPEEDUP_P50 = 20.0
MAX_RECOVERY_RATIO = 0.25        # b12's limit
FAULTS = dict(loss_device=1, loss_at=750, recover_at=1200,
              oracle_error_at=(400, 900), oracle_error_count=2,
              spike_at=(300, 1350), spike_ms=50.0, checkpoint_at=1000,
              deadline_ms=25.0, failover_max_evals=96)


class VirtualClock:
    """b12's time source: one 1 ms quantum a request, so admission (and
    with it every drift trigger) replays bit for bit."""

    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t

    def tick(self) -> None:
        self.t += 1e-3


def _quantiles(np, ms: list) -> dict:
    if not ms:
        return {"p50_ms": None, "p99_ms": None}
    return {"p50_ms": float(np.percentile(ms, 50)),
            "p99_ms": float(np.percentile(ms, 99))}


def _ms(v) -> str:
    return "none" if v is None else f"{v:.4f}"


def _span_ms(tele) -> dict:
    """{span name: [ms, ...]} of the spans recorded since the last reset."""
    out: dict = {}
    for name, _ts, dur_us, *_rest in tele.get_tracer().snapshot_events():
        out.setdefault(name, []).append(dur_us / 1e3)
    return out


def _serve_config(policy: str, **extra):
    """b11's ``_serve_cfg``: ``drift`` (threshold 0.05, 25 ms/GB),
    ``never`` (no re-placement), ``always`` (any movement, free moves)."""
    from repro_torch.serve import ServeConfig
    threshold = {"drift": SERVE_THRESHOLD, "never": None,
                 "always": 0.0}[policy]
    return ServeConfig(drift_threshold=threshold,
                       migration_ms_per_gb=(0.0 if policy == "always"
                                            else SERVE_MS_PER_GB),
                       **SERVE_ADMISSION, **extra)


def serve_cold_leg(np, agent, trace) -> dict:
    """b11's no-service strawman: ``session.place`` on each of the trace's
    first ``SERVE_COLD_REQUESTS`` requests (every one costs a full decode
    of the same shape), the session warmed first."""
    from repro_torch.api import PlacementSession
    from repro_torch.data.tasks import Task
    session = PlacementSession(agent)
    session.place(Task.of(trace[0].raw_features, trace[0].n_devices))
    ms = []
    t0 = time.perf_counter()
    for r in trace[:SERVE_COLD_REQUESTS]:
        t = time.perf_counter()
        session.place(Task.of(r.raw_features, r.n_devices))
        ms.append((time.perf_counter() - t) * 1e3)
    return {**_quantiles(np, ms), "requests": len(ms),
            "wall_s": time.perf_counter() - t0}


def serve_leg(np, tele, agent, oracle, trace, policy: str) -> dict:
    """One b11 leg on the card: the trace through ``PlacementService``
    (the agent decodes on the card, the oracle is phase 8's
    ``KernelOracle``).  Every request must be served from the cache or a
    decode (a healthy leg explains no fallback), with a legal placement;
    no decode may raise.  Returns the leg's row, its results and its
    service."""
    from repro_torch.serve import PlacementService
    tele.reset()
    tele.enable()
    svc = PlacementService(agent, oracle=oracle, config=_serve_config(policy))
    done = []
    t0 = time.perf_counter()
    for i, r in enumerate(trace):
        done += svc.submit(r.raw_features, r.n_devices, tag=i)
    done += svc.flush()
    wall = time.perf_counter() - t0
    spans = _span_ms(tele)
    tele.disable()
    stats = svc.stats()
    check(sorted(r.tag for r in done) == list(range(len(trace))),
          f"serve {policy}: {len(done)} results for {len(trace)} requests")
    check(stats["decode_errors"] == 0,
          f"serve {policy}: {stats['decode_errors']} decodes raised")
    sources = {}
    placements = [None] * len(trace)
    hit_ms, decode_ms, all_ms = [], [], []
    for res in done:
        sources[res.source] = sources.get(res.source, 0) + 1
        placements[res.tag] = res.placement
        all_ms.append(res.latency_ms)
        if res.source == "cache":
            if not res.replaced:
                hit_ms.append(res.latency_ms)
        else:
            decode_ms.append(res.latency_ms)
    check(set(sources) <= {"cache", "decode"} and stats["repairs"] == 0
          and not any(stats["fallbacks"].values()),
          f"serve {policy}: a healthy leg served {sources}, fallbacks "
          f"{stats['fallbacks']}")
    check(stats["hit_rate"] >= MIN_HIT_RATE,
          f"serve {policy}: hit rate {stats['hit_rate']:.4f}")
    request_ms = []
    for r, p in zip(trace, placements):
        check(oracle.legal(r.raw_features, p.assignment, r.n_devices),
              f"serve {policy}: an illegal placement was served")
        request_ms.append(oracle.evaluate(r.raw_features, p.assignment,
                                          r.n_devices).overall)
    request_sum = float(np.sum(request_ms))
    migration_ms = SERVE_MS_PER_GB * stats["bytes_moved_gb"]
    row = {"policy": policy, "hit_rate": stats["hit_rate"],
           "hits": stats["hits"], "coalesced": stats["coalesced"],
           "decode_batches": stats["decode_batches"],
           "decoded_tasks": stats["decoded_tasks"],
           "replace_events": stats["replace_events"],
           "migrations": stats["migrations"],
           "bytes_moved_gb": stats["bytes_moved_gb"],
           "hit": _quantiles(np, hit_ms), "decode": _quantiles(np, decode_ms),
           "overall": _quantiles(np, all_ms), "wall_s": wall,
           "requests_per_s": len(trace) / wall,
           "request_cost_sum_ms": request_sum,
           "migration_charge_ms": migration_ms,
           "end_to_end_cost_ms": request_sum + migration_ms,
           "time_split_ms": {
               "serve.flush": float(sum(spans.get("serve.flush", []))),
               "session.decode": float(sum(spans.get("session.decode", []))),
               "serve.replace": float(sum(spans.get("serve.replace", []))),
               "pure hits": float(sum(hit_ms))},
           "spans": {k: len(spans.get(k, [])) for k in (
               "serve.flush", "session.decode", "serve.replace")},
           "sources": sources}
    return {"row": row, "done": done, "service": svc}


def serve_determinism(np, agent, pool) -> dict:
    """b11's determinism: a zero-drift trace (4 requests a job) through the
    service returns bitwise ``PlacementSession.place_many``'s
    assignments, on the card."""
    from repro_torch.api import PlacementSession
    from repro_torch.data.tasks import Task
    from repro_torch.data.traffic import TrafficConfig, make_trace
    from repro_torch.serve import PlacementService
    cfg = TrafficConfig(n_jobs=SERVE_TRAFFIC["n_jobs"],
                        n_tables=SERVE_TRAFFIC["n_tables"], n_devices=4,
                        n_requests=4 * SERVE_TRAFFIC["n_jobs"], drift=0.0,
                        zipf=SERVE_TRAFFIC["zipf"], seed=SERVE_TRAFFIC["seed"])
    trace = make_trace(pool, cfg)
    svc = PlacementService(agent, config=_serve_config("drift"))
    done = []
    for i, r in enumerate(trace):
        done += svc.submit(r.raw_features, r.n_devices, tag=i)
    done += svc.flush()
    served = {res.tag: res.placement for res in done}
    first = {}
    for i, r in enumerate(trace):
        first.setdefault(r.job, i)
    jobs = sorted(first)
    reference = PlacementSession(agent).place_many(
        [Task.of(trace[first[j]].raw_features, 4) for j in jobs])
    identical = all(np.array_equal(served[first[j]].assignment,
                                   ref.assignment)
                    for j, ref in zip(jobs, reference))
    identical = identical and all(
        np.array_equal(served[i].assignment,
                       served[first[r.job]].assignment)
        for i, r in enumerate(trace))
    return {"requests": len(trace), "replaces": svc.replace_events,
            "decode_errors": svc.decode_errors,
            "zero_drift_identical": bool(identical
                                         and svc.replace_events == 0)}


def serve_b11(np, tele, ctx, pool) -> dict:
    """(a) b11's paper regime on the card: the cold leg, the three drift
    policies, the zero-drift determinism; and the hottest job's first
    decoded and last drift-refined placements, for (c)."""
    from repro_torch.data.traffic import TrafficConfig, make_trace
    agent, oracle = ctx["agent"], ctx["oracle"]
    trace = make_trace(pool, TrafficConfig(n_devices=4, **SERVE_TRAFFIC))
    cold = serve_cold_leg(np, agent, trace)
    log(f"[serve b11] {len(trace)} requests (12 jobs x 50 tables, 4 "
        f"devices, drift 0.8, 8 tail jobs); cold session.place on "
        f"{cold['requests']}: p50 {cold['p50_ms']:.4f} ms, p99 "
        f"{cold['p99_ms']:.4f} ms, {cold['wall_s']:.2f} s")
    legs, runs = {}, {}
    for policy in ("drift", "never", "always"):
        runs[policy] = serve_leg(np, tele, agent, oracle, trace, policy)
        row = legs[policy] = runs[policy]["row"]
        split = row["time_split_ms"]
        q = {k: " ".join(f"{p} {_ms(row[k][p + '_ms'])}"
                         for p in ("p50", "p99"))
             for k in ("hit", "decode", "overall")}
        log(f"[serve b11] {policy}: hit rate {row['hit_rate']:.4f} "
            f"({row['coalesced']} coalesced, {row['decode_batches']} "
            f"flushes, {row['decoded_tasks']} decoded); pure hit {q['hit']} "
            f"ms; decode {q['decode']} ms; overall {q['overall']} ms; "
            f"{row['replace_events']} "
            f"re-placements, {row['migrations']} migrations, "
            f"{row['bytes_moved_gb']:.4f} GB moved; "
            f"{row['requests_per_s']:.1f} requests/s; end-to-end cost "
            f"{row['end_to_end_cost_ms']:.2f} ms (requests "
            f"{row['request_cost_sum_ms']:.2f} + migration "
            f"{row['migration_charge_ms']:.2f})")
        log(f"[serve b11] {policy} time split of {row['wall_s']:.2f} s: "
            f"serve.flush {split['serve.flush']:.1f} ms "
            f"({row['spans']['serve.flush']} spans; session.decode "
            f"{split['session.decode']:.1f}), serve.replace "
            f"{split['serve.replace']:.1f} ms "
            f"({row['spans']['serve.replace']}), pure hits "
            f"{split['pure hits']:.1f} ms")
    determinism = serve_determinism(np, agent, pool)
    check(determinism["decode_errors"] == 0, "determinism: a decode raised")
    check(determinism["zero_drift_identical"],
          "a zero-drift replay is not place_many's, bit for bit")
    hit_p50 = legs["drift"]["hit"]["p50_ms"]
    speedup = cold["p50_ms"] / hit_p50
    check(speedup >= HIT_SPEEDUP_P50,
          f"warm hits p50 only {speedup:.1f}x under cold place")
    beats = (legs["drift"]["end_to_end_cost_ms"]
             < legs["never"]["end_to_end_cost_ms"]
             and legs["drift"]["bytes_moved_gb"]
             < legs["always"]["bytes_moved_gb"])
    log(f"[serve b11] zero-drift replay bit-equal to place_many "
        f"({determinism['requests']} requests); warm-hit p50 "
        f"{speedup:.1f}x under cold; drift beats never on end-to-end cost "
        f"while moving fewer bytes than always: {beats} (printed, not "
        "checked)")
    # the hottest job's first decode and last drift re-placement, for (c)
    counts = np.bincount([r.job for r in trace])
    hot = int(np.argmax(counts))
    mine = [res for res in runs["drift"]["done"]
            if trace[res.tag].job == hot]
    first = next(res for res in mine if res.source == "decode")
    refined = [res for res in mine if res.replaced]
    check(bool(refined), f"the hottest job {hot} was never re-placed")
    last = refined[-1]
    picks = [("b11 hottest job: first decode", trace[first.tag].raw_features,
              first.placement.assignment, 4),
             ("b11 hottest job: last drift re-placement",
              trace[last.tag].raw_features, last.placement.assignment, 4)]
    log(f"[serve b11] hottest job {hot}: {int(counts[hot])} requests, "
        f"{len(refined)} re-placements; its first decode at request "
        f"{first.tag}, its last re-placement at request {last.tag} "
        f"({int((first.placement.assignment != last.placement.assignment).sum())}"
        " tables moved between them)")
    return {"summary": {"cold": cold, "legs": legs,
                        "determinism": determinism,
                        "hit_speedup_p50": speedup,
                        "drift_beats_never_moving_less": beats,
                        "hot_job": hot},
            "picks": picks}


def _fault_schedule():
    from repro_torch.serve import FaultEvent, FaultSchedule
    f = FAULTS
    events = [FaultEvent(at=f["loss_at"], kind="device_loss",
                         device=f["loss_device"]),
              FaultEvent(at=f["recover_at"], kind="device_recovery",
                         device=f["loss_device"])]
    events += [FaultEvent(at=at, kind="oracle_error",
                          count=f["oracle_error_count"])
               for at in f["oracle_error_at"]]
    events += [FaultEvent(at=at, kind="decode_spike", spike_ms=f["spike_ms"])
               for at in f["spike_at"]]
    return FaultSchedule(tuple(events))


def _scratch_rebuild_gb(np, svc, lost: int, capacity_gb: float) -> dict:
    """b12's comparator: the cached placements that touch the lost device
    rebuilt from scratch (greedy size balance over the survivors), bytes
    counted against the incumbent each replaces."""
    from repro_torch.core import features as F
    from repro_torch.core.baselines import expert_place
    scratch_gb, total_gb, affected = 0.0, 0.0, 0
    for _, e in svc.cache.items():
        a = e.placement.assignment
        if not (a == lost).any() or e.raw is None:
            continue
        affected += 1
        survivors = np.array([d for d in range(e.placement.n_devices)
                              if d != lost])
        sizes = e.raw[:, F.TABLE_SIZE_GB]
        rebuilt = survivors[expert_place(e.raw, survivors.size, capacity_gb,
                                         "size")]
        scratch_gb += float(((rebuilt != a) * sizes).sum())
        total_gb += float(sizes.sum())
    return {"affected_entries": affected, "scratch_bytes_gb": scratch_gb,
            "affected_total_gb": total_gb}


def _same_result(np, a, b) -> bool:
    return (a.tag == b.tag and a.source == b.source
            and a.degraded == b.degraded
            and (a.error.code if a.error else None)
            == (b.error.code if b.error else None)
            and (a.placement is None) == (b.placement is None)
            and (a.placement is None or np.array_equal(
                a.placement.assignment, b.placement.assignment)))


def serve_b12(np, tele, ctx, pool) -> dict:
    """(b) b12's paper regime on the card: the trace at 8 devices under the
    committed fault schedule, on b12's virtual clock; saved at request
    1000 and restored into a fresh service, both finishing the trace.
    Fails on an exception out of ``submit``/``flush``, a request without
    a legal placement or a typed error, a decode that raised, a fallback
    its flush's deadline skip does not explain, a placement on the lost
    device while the outage lasts (by the submit that served it, as b12
    counts it), recovery moving more than 0.25 of the scratch rebuild's
    bytes, or a restored service that serves otherwise.
    Returns the summary and one evacuated entry's placements for (c)."""
    import tempfile
    from repro_torch.data.traffic import TrafficConfig, make_trace
    from repro_torch.serve import FaultInjector, PlacementService
    f = FAULTS
    agent, oracle = ctx["agent"], ctx["oracle"]
    trace = make_trace(pool, TrafficConfig(n_devices=8, **SERVE_TRAFFIC))
    cfg = _serve_config("drift", failover_max_evals=f["failover_max_evals"],
                        decode_deadline_ms=f["deadline_ms"],
                        oracle_retries=2)
    clock = VirtualClock()
    tele.reset()
    tele.enable()
    svc = PlacementService(agent, oracle=oracle, config=cfg, clock=clock,
                           faults=FaultInjector(_fault_schedule()))
    restored, done, rdone, cut = None, [], [], None
    uncaught, unexplained = [], []
    before, evacuated, scratch, recovery_ms = {}, [], None, None
    completed_at = {}              # tag -> index of the submit that served it

    def submit(service, r, i, sink):
        try:
            sink += service.submit(r.raw_features, r.n_devices, tag=i)
        except Exception as e:          # b12 counts these; one fails the run
            uncaught.append(f"request {i}: {type(e).__name__}: {e}")

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        for i, r in enumerate(trace):
            if i == f["checkpoint_at"]:
                path = os.path.join(tmp, "serve_state")
                svc.save(path)
                restored = PlacementService.restore(
                    path, agent=agent, oracle=oracle, config=cfg,
                    clock=clock, faults=FaultInjector(_fault_schedule()))
                cut = len(done)
            clock.tick()
            if i == f["loss_at"]:
                scratch = _scratch_rebuild_gb(np, svc, f["loss_device"],
                                              oracle.mem_capacity_gb)
                before = {k: (e.placement, e.raw)
                          for k, e in svc.cache.items()}
                t_loss = time.perf_counter()
            skips, n0 = svc.deadline_skips, len(done)
            submit(svc, r, i, done)
            completed_at.update((res.tag, i) for res in done[n0:])
            if i == f["loss_at"]:
                recovery_ms = (time.perf_counter() - t_loss) * 1e3
                evacuated = [(e.requests, before[k], e.placement)
                             for k, e in svc.cache.items()
                             if k in before and (before[k][0].assignment
                                                 == f["loss_device"]).any()]
            explained = svc.deadline_skips > skips
            unexplained += [res.tag for res in done[n0:]
                            if res.source == "fallback" and not explained]
            if restored is not None:
                submit(restored, r, i, rdone)
        skips, n0 = svc.deadline_skips, len(done)
        done += svc.flush()
        completed_at.update((res.tag, len(trace)) for res in done[n0:])
        unexplained += [res.tag for res in done[n0:]
                        if res.source == "fallback"
                        and svc.deadline_skips == skips]
        rdone += restored.flush()
    wall = time.perf_counter() - t0
    failover_ms = _span_ms(tele).get("serve.failover", [])  # host clock
    tele.disable()
    stats = svc.stats()
    check(not uncaught, f"serve b12: exceptions out of submit: {uncaught}")
    by_source, illegal, on_lost = {}, 0, 0
    for res in done:
        by_source[res.source] = by_source.get(res.source, 0) + 1
        if res.placement is not None:
            r = trace[res.tag]
            illegal += not oracle.legal(r.raw_features,
                                        res.placement.assignment, 8)
            if f["loss_at"] <= completed_at[res.tag] < f["recover_at"] and \
                    (res.placement.assignment == f["loss_device"]).any():
                on_lost += 1
    served = sum(1 for r in done
                 if r.placement is not None or r.error is not None)
    check(sorted(r.tag for r in done) == list(range(len(trace)))
          and served == len(trace),
          f"serve b12: {served} of {len(trace)} requests served")
    check(illegal == 0, f"serve b12: {illegal} illegal placements")
    check(on_lost == 0, f"serve b12: {on_lost} placements on the lost "
          "device during the outage")
    check(stats["decode_errors"] == 0,
          f"serve b12: {stats['decode_errors']} decodes raised")
    check(not unexplained and stats["deadline_skips"] <= len(f["spike_at"]),
          f"serve b12: fallbacks no deadline skip explains: {unexplained}; "
          f"{stats['deadline_skips']} skips")
    recovery_gb = stats["failover_bytes_gb"]
    ratio = recovery_gb / scratch["scratch_bytes_gb"]
    check(ratio <= MAX_RECOVERY_RATIO,
          f"serve b12: recovery moved {ratio:.4f} of the scratch bytes")
    check(len(rdone) == len(done) - cut and all(
        _same_result(np, a, b) for a, b in zip(done[cut:], rdone)),
        "serve b12: the restored service serves otherwise than the "
        "uninterrupted one")
    # the most requested evacuated entry: its placement just before the
    # loss and its failover placement, for (c)
    check(bool(evacuated), "serve b12: no cached entry was evacuated")
    _, (p_before, raw), p_after = max(evacuated, key=lambda m: m[0])
    check(not (p_after.assignment == f["loss_device"]).any(),
          "serve b12: the failover placement uses the lost device")
    picks = [("b12 evacuated entry: before the loss", raw,
              p_before.assignment, 8),
             ("b12 evacuated entry: failover on 7 survivors", raw,
              p_after.assignment, 8)]
    summary = {
        "requests": len(trace), "served_fraction": served / len(trace),
        "uncaught": len(uncaught), "by_source": by_source,
        "illegal_placements": illegal, "outage_on_lost": on_lost,
        "recovery": {**scratch, "recovery_bytes_gb": recovery_gb,
                     "recovery_ratio": ratio,
                     "recovery_latency_ms": recovery_ms},
        "evacuations": stats["evacuations"],
        "evacuation_failures": stats["evacuation_failures"],
        "failover_bytes_gb": stats["failover_bytes_gb"],
        "failover_span_ms": failover_ms,
        "fallbacks": stats["fallbacks"], "repairs": stats["repairs"],
        "deadline_skips": stats["deadline_skips"],
        "retries": stats["retries"],
        "retry_exhausted": stats["retry_exhausted"],
        "typed_errors": stats["typed_errors"],
        "replace_events": stats["replace_events"],
        "wall_s": wall, "checkpoint_at": f["checkpoint_at"],
        "restored_results": len(rdone), "warm_restart_identical": True}
    log(f"[serve b12] {len(trace)} requests at 8 devices, device "
        f"{f['loss_device']} lost at {f['loss_at']} and back at "
        f"{f['recover_at']}: served {served}/{len(trace)} ({by_source}), "
        f"no exception; {stats['evacuations']} evacuations "
        f"({stats['evacuation_failures']} failed), failover "
        f"{recovery_gb:.4f} GB against a scratch rebuild's "
        f"{scratch['scratch_bytes_gb']:.4f} GB (ratio {ratio:.4f}, limit "
        f"{MAX_RECOVERY_RATIO}); serve.failover span "
        f"{[round(v, 3) for v in failover_ms]} ms; the loss's submit "
        f"{recovery_ms:.2f} ms")
    log(f"[serve b12] fallbacks {stats['fallbacks']} (deadline skips "
        f"{stats['deadline_skips']}), repairs {stats['repairs']}, retries "
        f"{stats['retries']} ({stats['retry_exhausted']} exhausted), typed "
        f"errors {stats['typed_errors']}, decode errors 0, "
        f"{stats['replace_events']} re-placements; {wall:.2f} s for both "
        f"services; restored at request {f['checkpoint_at']}: "
        f"{len(rdone)} results, each the uninterrupted service's")
    return {"summary": summary, "picks": picks}


def serve_live(np, ctx, picks) -> list:
    """(c) the served placements timed live with K1 (``measure_placement``
    at batch 65536, each table's own pooling, rows capped at 2^20) beside
    the oracle's price against the request's true features."""
    from repro_torch.profiling.microbench import measure_placement
    oracle = ctx["oracle"]
    out = []
    for label, raw, a, n_devices in picks:
        est = oracle.evaluate(raw, a, n_devices)
        res = measure_placement(raw, a, n_devices, batch_size=BATCH,
                                pooling=None, max_rows=MAX_ROWS,
                                device="cuda")
        check(math.isfinite(res.overall), "finite live cost")
        rel = est.overall / res.overall - 1
        out.append({"placement": label, "n_devices": n_devices,
                    "assignment": np.asarray(a).tolist(),
                    "live_ms": res.overall, "oracle_ms": est.overall,
                    "rel_err": rel, "live_fwd_ms": res.fwd_comp.tolist(),
                    "live_bwd_ms": res.bwd_comp.tolist()})
        log(f"[serve live] {label}: live {res.overall:.4f} ms (fwd "
            f"{np.round(res.fwd_comp, 3).tolist()}, bwd "
            f"{np.round(res.bwd_comp, 3).tolist()}), KernelOracle "
            f"{est.overall:.4f} ms: error {rel:+.2%}")
    return out


def phase_serving(torch, np, K, counters, ctx, summary: dict) -> dict:
    """Placement serving on the card over phase 8's trained agent and its
    ``KernelOracle``: (a) b11's paper regime, (b) b12's under faults with
    a warm restart, (c) four served placements timed live with K1, and K1
    held to plain at each of their devices' shapes and indices.  Returns
    K1's launches on the serving path, counted from zero."""
    from repro_torch import telemetry as tele
    from repro_torch.data.synthetic import make_dlrm_pool
    from repro_torch.data.tasks import Task
    check(ctx["agent"].device.type == "cuda", "the agent decodes on the card")
    pool = make_dlrm_pool(seed=0)
    for c in counters:                         # counts of this path only
        c.launches = 0
    b11 = serve_b11(np, tele, ctx, pool)
    b12 = serve_b12(np, tele, ctx, pool)
    live = serve_live(np, ctx, b11["picks"] + b12["picks"])
    launches = {"fwd": K.embedding_bag_cuda.launches,
                "bwd": K.embedding_bag_grad_cuda.launches}
    check(launches["fwd"] > 0 and launches["bwd"] > 0,
          f"the serving path launched K1 {launches}")
    check_idle(counters, (K.embedding_bag_cuda, K.embedding_bag_grad_cuda),
               "the placement serving path")
    checks = {}
    for label, raw, a, n_devices in b11["picks"] + b12["picks"]:
        checks[label] = placement_kernel_checks(
            torch, K, Task.of(raw, n_devices), a,
            label=f"the served placement '{label}'")
        log(f"[serve live] K1 at each device's shapes of {label}: forward "
            "bit-equal to plain, backward bit-equal to its replay, its plan "
            "to backward_plan, max |err| against float64 (plain's) " +
            ", ".join(f"{c['bwd_err_vs_f64']:.3g} "
                      f"({c['plain_bwd_err_vs_f64']:.3g})"
                      for c in checks[label]))
    log(f"[serve] K1 launches on the serving path: {launches['fwd']} "
        f"forward, {launches['bwd']} backward (live timing of 4 served "
        "placements)")
    summary["placement_serving"] = {
        "b11": b11["summary"], "b12": b12["summary"], "live": live,
        "kernel_checks": checks, "launches": launches}
    return launches


# phase 13: the LM train path (``launch/steps.make_train_step``)

TRAIN_BATCH = 2                  # train_4k's sequence; its batch cut 256 -> 2
TRAIN_SEQ = 4096
TRAIN_TIMED = 1                  # after 1 warm-up step
CROSS_TRAIN_SEQ = 1024           # 13 (b): 2 layers, float32, cuda vs cpu
GRAD_CHECK_SEQ = 1024            # 13 (c): plain's float64 autograd
DENSE_ARCHS = ("qwen2.5-14b", "phi4-mini-3.8b", "granite-34b")
DENSE_LAYERS = 2                 # 13 (d): full width, cut to 2 layers
DENSE_SEQ = 1024
DENSE_DECODE = 8


def _lm_batch(torch, np, vocab: int, B: int, S: int, device, seed: int = 0):
    """The launcher's batch: tokens and labels from ``default_rng(seed)``,
    a mask of ones."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab, (B, S))
    labels = rng.integers(0, vocab, (B, S))
    return {"tokens": torch.as_tensor(tokens, dtype=torch.int32,
                                      device=device),
            "labels": torch.as_tensor(labels, dtype=torch.int32,
                                      device=device),
            "loss_mask": torch.ones((B, S), dtype=torch.float32,
                                    device=device)}


def _layer0_qkv(torch, cfg, params, tokens, embeds=None):
    """Layer 0's q (rope'd), k (rope'd) and v of ``tokens`` (after a
    frontend arch's ``embeds``), as the train step's forward computes them
    (QKV biases added before RoPE)."""
    from repro_torch.models import layers as L
    from repro_torch.models.transformer import map_params
    lp = map_params(lambda t: t[0], params["layers"])
    hd = cfg.head_dim
    with torch.no_grad():
        x = params["embed"][tokens.long()]
        if embeds is not None:
            x = torch.cat([embeds.to(x.dtype), x], dim=1)
        B, S = x.shape[:2]
        h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
        del x
        pos = torch.arange(S, device=tokens.device)[None, :]
        q, k, v = h @ lp["wq"], h @ lp["wk"], h @ lp["wv"]
        if cfg.qkv_bias:
            q, k, v = q + lp["bq"], k + lp["bk"], v + lp["bv"]
        q = q.reshape(B, S, cfg.n_heads_padded, hd)
        k = k.reshape(B, S, cfg.n_kv_heads, hd)
        v = v.reshape(B, S, cfg.n_kv_heads, hd)
        return (L.apply_rope(q, pos, cfg.rope_theta),
                L.apply_rope(k, pos, cfg.rope_theta), v.contiguous())


def _kernel_class(name: str) -> str:
    low = name.lower()
    if "flash_fwd" in low:
        return "K2"
    if "flash_bwd" in low or "bwd_delta" in low:
        return "K2-bwd"
    if "selective_scan_bwd" in low:
        return "K3-bwd"
    if "wkv6_bwd" in low:
        return "K4-bwd"
    if "selective_scan" in low:
        return "K3"
    if "wkv6" in low:
        return "K4"
    if any(s in low for s in ("gemm", "nvjet", "xmma", "cutlass")):
        return "cuBLAS"
    return "other"


def _under(e, pred) -> bool:
    """Whether a profiler event has an ancestor (on the host) that ``pred``
    holds for."""
    e = e.cpu_parent
    while e is not None:
        if pred(e):
            return True
        e = e.cpu_parent
    return False


def train_profile(torch, step, params, state, batch, spans=None,
                  classify=_kernel_class, tag: str = "lm train profile",
                  host: bool = True) -> dict:
    """torch.profiler over one train step: kernel ms, idle share, and the
    shares of each kernel class (``classify``: K2, K2-bwd (the attention
    backward, its three kernels by name), cuBLAS's GEMMs, ...).  ``spans``
    maps more names to ``(pred, outside)``: the device time of the
    outermost host events that ``pred`` holds for and that no event
    ``outside`` holds for encloses.  With ``host=False`` only the device's
    activity is recorded (a deep step's host events take tens of seconds
    to gather), so ``spans`` are not read.  The profiler slows the host,
    so the idle share is an upper bound.  Log lines start with
    ``[tag]``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    check(host or not spans, "spans need the host's events")
    torch.cuda.synchronize()
    activities = ([ProfilerActivity.CPU, ProfilerActivity.CUDA] if host
                  else [ProfilerActivity.CUDA])
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        step(params, state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # a ``record_function`` range shows on the device too: not a kernel
    ranges = {"moe.dispatch_combine", "moe.route"}
    rows = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.key not in ranges), key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    by_class: dict = {}
    for name, ms, _ in rows:
        cls = classify(name)
        by_class[cls] = by_class.get(cls, 0.0) + ms

    more = {}
    for name, (pred, outside) in (spans or {}).items():
        more[name] = sum(
            e.device_time_total for e in prof.events()
            if e.device_type == DeviceType.CPU and pred(e)
            and not _under(e, pred)
            and not (outside and (outside(e) or _under(e, outside)))) / 1e3
    ms = {**by_class, **more}
    from repro_torch.profiling.microbench import kernel_name
    out = {"wall_ms": wall_ms, "kernel_ms": busy,
           "idle_share": 1 - busy / wall_ms if busy else None,
           "ms": ms,
           "share": {k: v / busy for k, v in ms.items()} if busy else None,
           "top": [{"name": k[:80], "ms": ms, "calls": n}
                   for k, ms, n in rows[:10]],
           "ms_a_launch": {kernel_name(k): ms / n for k, ms, n in rows if n}}
    if busy:
        classes = sorted(by_class, key=lambda k: -by_class[k])
        log(f"[{tag}] wall {wall_ms:.1f} ms under the profiler, kernels "
            f"{busy:.1f} ms (idle share <= {out['idle_share']:.3f}); "
            + ", ".join(f"{k} {by_class[k]:.1f} ms ({out['share'][k]:.3f})"
                        for k in classes)
            + ("" if host else "; the device's activity only") + "".join(
                f"; {k} {v:.1f} ms ({out['share'][k]:.3f})"
                for k, v in more.items()))
    else:
        log(f"[{tag}] no device time recorded: not measured")
    for k, ms, n in rows[:10]:
        log(f"[{tag}]   {ms:9.3f} ms {n:5d}x {k[:80]}")
    return out


def attention_backward_ms(torch, FA, q, k, v, window, chunks) -> float:
    """CUDA-event ms of the op's backward (K2-bwd) on one layer's q/k/v at
    the train shape, median of 3 after a warm-up.  Its launches are put
    back."""
    from repro_torch.kernels.flash_attention import ops
    n0 = (FA.flash_attention_cuda.launches,
          FA.flash_attention_bwd_cuda.launches)
    qs, ks, vs = (t.detach().requires_grad_(True) for t in (q, k, v))
    out = ops.flash_attention(qs, ks, vs, window=window, q_chunk=chunks,
                              kv_chunk=chunks)
    dout = torch.randn_like(out)
    times = []
    for i in range(4):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        torch.autograd.grad(out, (qs, ks, vs), dout, retain_graph=True)
        t1.record()
        t1.synchronize()
        if i:
            times.append(t0.elapsed_time(t1))
    FA.flash_attention_cuda.launches, FA.flash_attention_bwd_cuda.launches = n0
    return sorted(times)[1]


def lm_train_full(torch, np, FA, counters, summary: dict) -> tuple:
    """13 (a): danube at full width and depth, bf16, AdamW, no remat (as
    the reference's launcher trains), batch 2 x 4096."""
    from repro_torch.configs import get_full
    from repro_torch.launch import steps as ST
    from repro_torch.models.transformer import tree_leaves
    cfg = get_full(ARCH).resolve(1)
    torch.cuda.reset_peak_memory_stats()
    model = ST.build_model(cfg, remat=False, device="cuda")
    params = model.init_params(0)
    n_params = sum(t.numel() for t in tree_leaves(params))
    check(n_params == 1831201280, f"danube has {n_params} params")
    opt, step = ST.make_train_step(model)
    state = opt.init(tree_leaves(params))
    batches = [_lm_batch(torch, np, cfg.vocab, TRAIN_BATCH, TRAIN_SEQ,
                         "cuda", seed=i) for i in range(1 + TRAIN_TIMED)]
    qkv = _layer0_qkv(torch, cfg, params, batches[0]["tokens"])
    for c in counters:                         # counts of this path only
        c.launches = 0
    losses, times = [], []
    for i, batch in enumerate(batches):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        params, state, metrics = step(params, state, batch)
        t1.record()
        t1.synchronize()
        losses.append(float(metrics["loss"]))
        if i:
            times.append(t0.elapsed_time(t1))
    launches = FA.flash_attention_cuda.launches
    n_steps = len(batches)
    check(launches == cfg.n_layers * n_steps,
          f"K2 launched {launches} times in {n_steps} steps of "
          f"{cfg.n_layers} layers")
    check(FA.flash_attention_bwd_cuda.launches == cfg.n_layers * n_steps,
          f"K2-bwd launched {FA.flash_attention_bwd_cuda.launches} times in "
          f"{n_steps} steps of {cfg.n_layers} layers")
    k2_bwd_record(summary, "lm train", FA.flash_attention_bwd_cuda.launches)
    check_idle(counters, (FA.flash_attention_cuda,
                          FA.flash_attention_bwd_cuda), "the LM train path")
    check(all(math.isfinite(x) for x in losses), f"losses {losses}")
    peak = torch.cuda.max_memory_allocated()
    step_ms = sorted(times)[len(times) // 2]
    tokens = TRAIN_BATCH * TRAIN_SEQ
    out = {"arch": cfg.name, "layers": cfg.n_layers, "params": n_params,
           "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "remat": False,
           "q_chunk": model.q_chunk, "kv_chunk": model.kv_chunk,
           "step_ms": times, "median_step_ms": step_ms,
           "tokens_per_s": tokens / (step_ms / 1e3), "losses": losses,
           "peak_memory_bytes": peak,
           "k2_launches_per_step": launches // n_steps,
           "mfu": lm_mfu(cfg, "train", TRAIN_BATCH, TRAIN_SEQ, step_ms)}
    log(f"[lm train] {cfg.name}: {cfg.n_layers} layers, {n_params} params, "
        f"bf16, AdamW, no remat; batch {TRAIN_BATCH} x {TRAIN_SEQ} tokens; "
        f"chunks {model.q_chunk}/{model.kv_chunk}")
    log(f"[lm train] step ms {[round(t, 2) for t in times]} (median "
        f"{step_ms:.2f}, mfu {out['mfu']:.3f}, 1 warm-up step before), "
        f"{out['tokens_per_s']:.0f} "
        f"tokens/s; losses {[round(x, 4) for x in losses]}; peak memory "
        f"{peak / 1e9:.2f} GB; K2 and K2-bwd launches {launches // n_steps} "
        "a step")
    for c in counters:
        c.launches = 0
    out["profile"] = train_profile(torch, step, params, state, batches[0])
    check(FA.flash_attention_cuda.launches == cfg.n_layers
          and FA.flash_attention_bwd_cuda.launches == cfg.n_layers,
          "K2 and K2-bwd launches in the profiled step")
    launches += FA.flash_attention_cuda.launches
    k2_bwd_record(summary, "lm train", FA.flash_attention_bwd_cuda.launches)
    del state, batches
    torch.cuda.empty_cache()
    bwd_ms = attention_backward_ms(torch, FA, *qkv, cfg.sliding_window,
                                   model.q_chunk)
    out["attention_backward_ms_per_layer"] = bwd_ms
    out["attention_backward_share"] = bwd_ms * cfg.n_layers / step_ms
    log(f"[lm train] the attention backward (K2-bwd) alone (layer 0's "
        f"q/k/v, CUDA events, with the op's autograd): {bwd_ms:.2f} ms a "
        f"layer, {bwd_ms * cfg.n_layers:.1f} ms a step, "
        f"{out['attention_backward_share']:.3f} of the median step")
    del params
    torch.cuda.empty_cache()
    summary["lm_train"] = out
    return launches, qkv


def _max_rel(torch, a, b) -> float:
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def lm_train_cross_device(torch, np, FA, counters, summary: dict) -> int:
    """13 (b): one train step at full width, 2 layers, float32, on the card
    (K2's float32 kernel forward) and on the CPU (plain): the loss, every
    gradient leaf and the params after the step."""
    from repro_torch.configs import get_full
    from repro_torch.launch import steps as ST
    from repro_torch.models.transformer import map_params, tree_leaves
    cfg = dataclasses.replace(get_full(ARCH), n_layers=2).resolve(1)
    lr = 3e-4
    gpu = ST.build_model(cfg, remat=False, dtype=torch.float32,
                         device="cuda")
    cpu = ST.build_model(cfg, remat=False, dtype=torch.float32,
                         device="cpu")
    params = gpu.init_params(0)
    # a copy of its own: the card's step updates ``params`` in place
    cparams = map_params(lambda t: t.cpu().clone(), params)
    batch = _lm_batch(torch, np, cfg.vocab, 1, CROSS_TRAIN_SEQ, "cuda")
    cbatch = {k: v.cpu() for k, v in batch.items()}
    for c in counters:                         # counts of this path only
        c.launches = 0
    g, loss, _ = ST.make_grad_fn(gpu)(params, batch)
    opt, step = ST.make_train_step(gpu, lr=lr)
    step(params, opt.init(tree_leaves(params)), batch)
    launches = FA.flash_attention_cuda.launches
    check(launches == 2 * cfg.n_layers, f"K2 launched {launches} times")
    check(FA.flash_attention_bwd_cuda.launches == 2 * cfg.n_layers,
          f"K2-bwd launched {FA.flash_attention_bwd_cuda.launches} times")
    k2_bwd_record(summary, "lm train cuda vs cpu",
                  FA.flash_attention_bwd_cuda.launches)
    cg, closs, _ = ST.make_grad_fn(cpu)(cparams, cbatch)
    copt, cstep = ST.make_train_step(cpu, lr=lr)
    cstep(cparams, copt.init(tree_leaves(cparams)), cbatch)
    loss_err = abs(float(loss) - float(closs)) / abs(float(closs))
    check(loss_err <= 1e-5, f"loss cuda {float(loss)} cpu {float(closs)}")
    grad_err = max(_max_rel(torch, a.cpu(), b) for a, b in zip(g, cg))
    check(grad_err <= 1e-4, f"gradients cuda vs cpu: {grad_err}")
    # Adam's first step is lr * g / (|g| + eps): where the gradient decides
    # it (|g| >= 1e-2 of its leaf's largest) the params agree within 1e-6;
    # elsewhere summation order may flip a sign, so within 2 lr
    param_err = decided_err = 0.0
    for p, cp, cg_ in zip(tree_leaves(params), tree_leaves(cparams), cg):
        diff = (p.cpu() - cp).abs()
        param_err = max(param_err, float(diff.max()))
        d = cg_.abs() >= 1e-2 * cg_.abs().max()
        if bool(d.any()):
            decided_err = max(decided_err, float(diff[d].max()))
    check(param_err <= 2 * lr, f"params cuda vs cpu {param_err}")
    check(decided_err <= 1e-6, f"decided params cuda vs cpu {decided_err}")
    out = {"arch": cfg.name, "layers": cfg.n_layers, "seq": CROSS_TRAIN_SEQ,
           "loss": [float(loss), float(closs)], "loss_rel_err": loss_err,
           "grad_max_rel_err": grad_err, "param_max_abs_err": param_err,
           "decided_param_max_abs_err": decided_err, "k2_launches": launches}
    log(f"[lm train cross] {cfg.name} at 2 layers, float32, 1 x "
        f"{CROSS_TRAIN_SEQ} tokens, one AdamW step: cuda (K2) == cpu "
        f"(plain): loss {float(loss):.6f} / {float(closs):.6f} (rel err "
        f"{loss_err:.3g}, limit 1e-5), gradients max |err| / max |g| "
        f"{grad_err:.3g} (limit 1e-4), params max |err| {param_err:.3g} "
        f"(limit 2 lr = {2 * lr:g}), where |g| >= 1e-2 max |g| "
        f"{decided_err:.3g} (limit 1e-6)")
    summary["lm_train_cross_device"] = out
    del params, cparams, g, cg
    torch.cuda.empty_cache()
    return launches


def attention_dense(torch, q, k, v, window, dtype, reach: int = 0):
    """``attention_plain``'s arithmetic in ``dtype`` (causal, grouped KV
    heads), query i seeing keys up to i + ``reach`` (0: the true mask; 1:
    a faulty control): (B, S, Hq, hd) -> (B, S, Hq, hd) in ``dtype``."""
    from repro_torch.kernels.flash_attention.ref import NEG_INF
    S, hd, G = q.shape[1], q.shape[3], q.shape[2] // k.shape[2]
    qp = torch.arange(S, device=q.device)[:, None]
    kp = torch.arange(k.shape[1], device=q.device)[None, :]
    mask = qp + reach >= kp
    if window is not None:
        mask &= (qp - kp) < window
    qt = q.to(dtype).transpose(1, 2)
    kt = k.to(dtype).repeat_interleave(G, dim=2).transpose(1, 2)
    vt = v.to(dtype).repeat_interleave(G, dim=2).transpose(1, 2)
    s = torch.where(mask, qt @ kt.transpose(-1, -2) / math.sqrt(hd), NEG_INF)
    return (torch.softmax(s, dim=-1) @ vt).transpose(1, 2)


def k2_train_forward_check(torch, FA, plain, q, k, v, window, what: str,
                           controls: bool = False) -> dict:
    """K2's bf16 forward on a train path's real q/k/v against plain, by
    ``attention_ulp_err``.  With ``controls``, two faulty stand-ins for K2
    are read by the same rule: the mask one key too wide (must fail it) and
    the scale 1% off.  Launches here are not counted: the count is put
    back."""
    n0 = FA.flash_attention_cuda.launches
    out = FA.flash_attention_cuda(q, k, v, window=window)
    FA.flash_attention_cuda.launches = n0
    ref = plain(q, k, v, window=window)
    abs_ref = plain(q, k, v.abs(), window=window)
    torch.cuda.synchronize()
    err = attention_ulp_err(torch, out, ref, abs_ref, ulps=K2_BF16_ULPS,
                            rel_rms=K2_BF16_REL_RMS)
    log(f"[lm train k2] {what}: q {tuple(q.shape)}, k {tuple(k.shape)}, "
        f"window {window}, bf16: K2 == plain, {_ulp_line(err)}")
    del out
    if controls:
        # a mask fault must fail the rule; a scale 1% off is read beside it
        # (the smallest fault of the two)
        scale = 1.01 / math.sqrt(q.shape[-1])
        for name, bad, must_fail in (
                ("mask one key wide",
                 lambda: attention_dense(torch, q, k, v, window,
                                         torch.float32, reach=1).to(q.dtype),
                 True),
                ("scale x 1.01",
                 lambda: plain(q, k, v, window=window, scale=scale), False)):
            c = attention_ulp_err(torch, bad(), ref, abs_ref,
                                  ulps=K2_BF16_ULPS,
                                  rel_rms=K2_BF16_REL_RMS, enforce=False)
            c["fails"] = c["share"] > 1 or c["rel_rms_err"] > K2_BF16_REL_RMS
            check(c["fails"] or not must_fail,
                  f"the check passes a faulty control ({name}): {c}")
            err[f"control: {name}"] = c
            log(f"[lm train k2]   faulty control ({name}), by the same "
                f"rule: {'fails' if c['fails'] else 'passes'}, "
                f"{_ulp_line(c)}")
    del ref, abs_ref
    return err


def k2_bwd_yardstick(torch, FA, qkv, window, summary: dict) -> dict:
    """K2-bwd, its plain version and SDPA's backward (the yardstick, never
    on the path) on 13 (a)'s layer 0 q/k/v (bf16, causal, ``window``)
    and a seeded dout, beside the bound: 10 hd FLOPs a (query, key) pair
    and query head at the bf16 peak, against the bytes (q, k, v, out,
    dout and lse read once, dq, dk, dv written once).  Its row of the
    kernels line goes to ``summary["k2_bwd_row"]``."""
    from repro_torch.kernels.flash_attention.ops import attended_pairs
    from repro_torch.kernels.flash_attention.ref import (
        attention_bwd_plain, attention_mask)
    from repro_torch.profiling.microbench import median_time_ms
    q, k, v = qkv
    B, S, Hq, hd = q.shape
    G = Hq // k.shape[2]
    n0 = (FA.flash_attention_cuda.launches,
          FA.flash_attention_bwd_cuda.launches)
    out, lse = FA.flash_attention_cuda(q, k, v, window=window, lse=True)
    gen = torch.Generator(device="cuda").manual_seed(6)
    dout = torch.randn(q.shape, generator=gen, device="cuda").to(q.dtype)

    def kernel(*args):
        return FA.flash_attention_bwd_cuda(*args, window=window)

    def pl(*args):
        return attention_bwd_plain(*args, window=window, q_chunk=1024)

    args = (q, k, v, out, dout, lse)
    err = max(float((a.float() - b.float()).abs().max())
              for a, b in zip(kernel(*args), pl(*args)))
    ms = median_time_ms(kernel, args, warmup=2, repeats=10)
    plain_ms = median_time_ms(pl, args, warmup=1, repeats=3)
    torch.cuda.empty_cache()
    # SDPA's backward on the same values, its KV heads expanded (its
    # flash route takes no GQA); causal alone where the window covers S
    causal_only = window is None or window >= S
    mask = None if causal_only else attention_mask(
        S, S, causal=True, window=window, device="cuda")
    qe, ke, ve = (t.transpose(1, 2).detach().requires_grad_(True) for t in (
        q, k.repeat_interleave(G, dim=2), v.repeat_interleave(G, dim=2)))
    o = torch.nn.functional.scaled_dot_product_attention(
        qe, ke, ve, attn_mask=mask, is_causal=causal_only)
    do = dout.transpose(1, 2)

    def sdpa_bwd(g):
        return torch.autograd.grad(o, (qe, ke, ve), g, retain_graph=True)
    library_ms = median_time_ms(sdpa_bwd, (do,), warmup=2, repeats=10)
    del o, qe, ke, ve, do, mask
    FA.flash_attention_cuda.launches, FA.flash_attention_bwd_cuda.launches = n0
    pairs = attended_pairs(S, S, causal=True, window=window)
    flops = 10 * hd * pairs * B * Hq
    nbytes = 4 * (q.numel() + k.numel()) * q.element_size() + lse.numel() * 4
    ops_ms = flops / BF16_FLOP_PER_S * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ms = max(ops_ms, bytes_ms)
    row = {"name": "flash_attention_bwd", "route": "cuda",
           "source": "src/repro_torch/csrc/flash_attention_bwd.cu",
           "replaces": "src/repro/models/layers.py:46 (JAX's autodiff of "
                       "flash_attention's blockwise lax.scan; no Pallas "
                       "kernel)",
           "design": "mma.sync m16n8k16 (bf16 tensor cores), dK/dV and dQ "
                     "kernels, cp.async two-stage tiles",
           "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": bound_ms,
           "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
           "library_ms": library_ms}
    summary["k2_bwd_row"] = row
    summary["k2_bwd_yardstick"] = {
        "shape": [B, S, Hq, k.shape[2], hd], "window": window,
        "dtype": "bfloat16", "pairs_per_head": pairs, "flops": flops,
        "bytes": nbytes, "ops_ms": ops_ms, "bytes_ms": bytes_ms,
        "tflops": flops / (ms * 1e-3) / 1e12, "bound_share": bound_ms / ms,
        "sdpa_masked": not causal_only, **row}
    log(f"[k2-bwd yardstick] danube's layer 0 (13 (a)): q {tuple(q.shape)}, "
        f"k/v {tuple(k.shape)} bf16, causal, window {window}, {pairs} pairs "
        f"per head: K2-bwd {ms:.3f} ms ({flops / (ms * 1e-3) / 1e12:.1f} "
        f"TFLOP/s, {bound_ms / ms:.1%} of the bound), plain {plain_ms:.2f} "
        f"ms, SDPA's backward {library_ms:.3f} ms (KV heads expanded"
        f"{', causal' if causal_only else ', masked'}), bound "
        f"{bound_ms:.3f} ms ({row['bound_by']}); max |K2-bwd - plain| "
        f"{err:.3g}")
    del out, lse, dout
    torch.cuda.empty_cache()
    return row


def lm_train_kernel_checks(torch, FA, plain, qkv, window, chunk,
                           summary: dict) -> dict:
    """13 (c): K2's training forward on layer 0's real q/k/v of 13 (a)'s
    first step (the whole batch, 2 x 4096 tokens) against plain, with two
    faulty controls; K2-bwd on the same q/k/v by ``k2_bwd_case`` (bf16 and
    float32); and the op's dq/dk/dv (the first 1024 queries of both rows,
    bf16 and float32, through K2-bwd) against a float64 autograd of
    ``attention_plain``.  Launches here are not counted."""
    from repro_torch.kernels.flash_attention import ops
    q, k, v = qkv
    errs = {"forward": k2_train_forward_check(
        torch, FA, plain, q, k, v, window, "layer 0 of the train batch",
        controls=True)}
    gen = torch.Generator(device="cuda").manual_seed(4)
    dout = torch.randn(q.shape, generator=gen, device="cuda")
    for dt in (torch.bfloat16, torch.float32):
        errs[f"k2_bwd {str(dt).split('.')[-1]}"] = k2_bwd_case(
            torch, FA, q.to(dt), k.to(dt), v.to(dt), dout.to(dt),
            causal=True, window=window, what="danube layer 0 (13 (a)'s "
            "first batch)")
        torch.cuda.empty_cache()
    del dout
    S = GRAD_CHECK_SEQ
    gen = torch.Generator(device="cuda").manual_seed(3)
    q, k, v = (t[:, :S].contiguous() for t in (q, k, v))
    dout = torch.randn(q.shape, generator=gen, device="cuda")
    q64, k64, v64 = (t.double().requires_grad_(True) for t in (q, k, v))
    ref = torch.autograd.grad(
        attention_dense(torch, q64, k64, v64, window, torch.float64),
        (q64, k64, v64), dout.double())
    n0 = (FA.flash_attention_cuda.launches,
          FA.flash_attention_bwd_cuda.launches)
    for name, (max_rel, rel_rms) in K2_BWD_LIMITS.items():
        dt = getattr(torch, name)
        args = [t.to(dt).requires_grad_(True) for t in (q, k, v)]
        out = ops.flash_attention(*args, window=window, q_chunk=chunk,
                                  kv_chunk=chunk)
        grads = torch.autograd.grad(out, args, dout.to(dt))
        for g_name, g, r in zip(("dq", "dk", "dv"), grads, ref):
            r = r.float()
            err = {"max_abs_err": float((g.float() - r).abs().max()),
                   "max_abs_ref": float(r.abs().max()),
                   "rel_rms_err": float((g.float() - r).norm() / r.norm())}
            err["max_rel_err"] = err["max_abs_err"] / err["max_abs_ref"]
            check(err["max_rel_err"] <= max_rel
                  and err["rel_rms_err"] <= rel_rms,
                  f"{name} {g_name} against float64: {err}")
            errs[f"{name} {g_name}"] = err
            log(f"[lm train k2] {name} {g_name} ({q.shape[0]} x {S} tokens) "
                f"against a float64 autograd of plain: max |err| "
                f"{err['max_abs_err']:.3g} / max |ref| "
                f"{err['max_abs_ref']:.3g} = {err['max_rel_err']:.3g} "
                f"(limit {max_rel:g}), rms err / rms ref "
                f"{err['rel_rms_err']:.3g} (limit {rel_rms:g})")
    FA.flash_attention_cuda.launches, FA.flash_attention_bwd_cuda.launches = n0
    summary["lm_train_kernel_checks"] = errs
    torch.cuda.empty_cache()
    return errs


def timed_serve(torch, model, params, step_in: dict, n_tokens: int,
                capacity: int) -> dict:
    """One prefill and ``n_tokens - 1`` greedy decode steps through the
    launch steps, each part timed by CUDA events (with whatever first
    launches it makes).  Returns the greedy tokens (B, n_tokens) on the
    host, the last logits and the ms."""
    from repro_torch.launch import steps as ST
    prefill = ST.make_prefill_step(model, capacity=capacity)
    decode = ST.make_decode_step(model)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ev[0].record()
    logits, cache = prefill(params, step_in)
    tok = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)
    ev[1].record()
    toks = [tok]
    for _ in range(n_tokens - 1):
        logits, cache = decode(params, cache, {"tokens": tok})
        tok = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)
        toks.append(tok)
    ev[2].record()
    ev[2].synchronize()
    del cache
    return {"tokens": torch.cat(toks, 1).cpu(), "logits": logits,
            "prefill_ms": ev[0].elapsed_time(ev[1]),
            "decode_ms_per_token": (ev[1].elapsed_time(ev[2])
                                    / max(n_tokens - 1, 1))}


def lm_dense_configs(torch, np, FA, plain, counters, summary: dict) -> int:
    """13 (d): qwen2.5-14b, phi4-mini-3.8b and granite-34b at full width
    cut to 2 layers, bf16, seeded: one train step (2 x 1024 tokens) and
    one serve (a 2 x 1024-token prefill and 8 greedy decode steps), K2 at
    head_dim 128; K2's output on layer 0's q/k/v of the train batch (QKV
    biases added, granite's one KV head) held to plain."""
    from repro_torch.configs import get_full
    from repro_torch.launch import steps as ST
    from repro_torch.models.transformer import tree_leaves
    for c in counters:                         # counts of this path only
        c.launches = 0
    out = {}
    for arch in DENSE_ARCHS:
        cfg = dataclasses.replace(get_full(arch),
                                  n_layers=DENSE_LAYERS).resolve(1)
        check(cfg.head_dim == 128, f"{arch} head_dim {cfg.head_dim}")
        n0 = FA.flash_attention_cuda.launches
        b0 = FA.flash_attention_bwd_cuda.launches
        torch.cuda.reset_peak_memory_stats()
        model = ST.build_model(cfg, remat=False, device="cuda")
        params = model.init_params(0)
        n_params = sum(t.numel() for t in tree_leaves(params))
        opt, step = ST.make_train_step(model)
        state = opt.init(tree_leaves(params))
        batch = _lm_batch(torch, np, cfg.vocab, 2, DENSE_SEQ, "cuda")
        k2_err = k2_train_forward_check(
            torch, FA, plain, *_layer0_qkv(torch, cfg, params,
                                           batch["tokens"]),
            cfg.sliding_window, f"{arch} layer 0 of the train batch")
        t0 = time.perf_counter()
        params, state, metrics = step(params, state, batch)
        loss = float(metrics["loss"])
        train_s = time.perf_counter() - t0
        check(math.isfinite(loss), f"{arch} loss {loss}")
        del state
        served = timed_serve(torch, model, params,
                             {"tokens": batch["tokens"]}, DENSE_DECODE,
                             DENSE_SEQ + DENSE_DECODE)
        toks, logits = served["tokens"], served["logits"]
        mfu = {"train": lm_mfu(cfg, "train", 2, DENSE_SEQ, train_s * 1e3),
               "prefill": lm_mfu(cfg, "prefill", 2, DENSE_SEQ,
                                 served["prefill_ms"]),
               "decode": lm_mfu(cfg, "decode", 2, DENSE_SEQ,
                                served["decode_ms_per_token"])}
        check(bool(torch.isfinite(logits.float()).all()),
              f"{arch} finite logits")
        check(bool(((toks >= 0) & (toks < cfg.vocab_padded)).all()),
              f"{arch} token ids in range")
        k2 = FA.flash_attention_cuda.launches - n0
        check(k2 == 2 * cfg.n_layers, f"{arch}: K2 launched {k2} times")
        check(FA.flash_attention_bwd_cuda.launches - b0 == cfg.n_layers,
              f"{arch}: K2-bwd launched "
              f"{FA.flash_attention_bwd_cuda.launches - b0} times")
        out[arch] = {"params": n_params, "loss": loss, "train_s": train_s,
                     "prefill_ms": served["prefill_ms"],
                     "decode_ms_per_token": served["decode_ms_per_token"],
                     "mfu": mfu, "tokens": toks.tolist(), "k2_launches": k2,
                     "k2_vs_plain": k2_err,
                     "peak_memory_bytes": torch.cuda.max_memory_allocated(),
                     "kv_heads": cfg.n_kv_heads,
                     "qkv_bias": cfg.qkv_bias,
                     "tie_embeddings": cfg.tie_embeddings}
        log(f"[lm dense] {arch} at {cfg.n_layers} layers, {n_params} params "
            f"(qkv_bias {cfg.qkv_bias}, tied {cfg.tie_embeddings}, "
            f"{cfg.n_heads} q / {cfg.n_kv_heads} kv heads, hd "
            f"{cfg.head_dim}): train step loss {loss:.4f} ({train_s:.2f} s "
            f"with its first launches, host clock: mfu {mfu['train']:.3f}); "
            f"prefill {served['prefill_ms']:.1f} ms (mfu "
            f"{mfu['prefill']:.3f}), decode "
            f"{served['decode_ms_per_token']:.2f} ms/token (mfu "
            f"{mfu['decode']:.5f}), greedy tokens "
            f"{toks[0].tolist()}; K2 {k2} launches; peak "
            f"{out[arch]['peak_memory_bytes'] / 1e9:.2f} GB")
        del params, logits, batch, served
        torch.cuda.empty_cache()
    launches = FA.flash_attention_cuda.launches
    k2_bwd_record(summary, "dense configs",
                  FA.flash_attention_bwd_cuda.launches)
    check_idle(counters, (FA.flash_attention_cuda,
                          FA.flash_attention_bwd_cuda), "the dense configs")
    summary["lm_dense"] = out
    return launches


def phase_lm_train(torch, np, FA, plain, counters, summary: dict) -> dict:
    """The LM train path; returns K2's launches by path."""
    launches = {}
    from repro_torch.configs import get_full
    window = get_full(ARCH).sliding_window
    launches["lm train"], qkv = lm_train_full(torch, np, FA, counters,
                                              summary)
    k2_bwd_yardstick(torch, FA, qkv, window, summary)
    launches["lm train cuda vs cpu"] = lm_train_cross_device(
        torch, np, FA, counters, summary)
    lm_train_kernel_checks(torch, FA, plain, qkv, window, 1024, summary)
    del qkv
    launches["dense configs"] = lm_dense_configs(torch, np, FA, plain,
                                                 counters, summary)
    return launches


# phase 14: the MoE path (``models/layers.moe_apply`` in the LM)

MOE_ARCH = "olmoe-1b-7b"
MOE_SERVE_PROMPT = 8192          # 14 (a): as phase 7 serves danube
MOE_TRAIN_BATCH = 2              # 14 (b): train_4k's sequence, batch 2
MOE_TRAIN_SEQ = 4096
DBRX_LAYERS = 2                  # 14 (c): full width, cut to 2 layers
MOE_CROSS_SEQ = 64               # 14 (e): SMOKE, float32, cuda vs cpu
MOE_CROSS_DECODE = 8


class _RouteRecorder:
    """While active, each ``moe_route`` call's dropped-slot share is kept
    (one float per call: a host sync, so only around untimed work)."""

    def __enter__(self):
        from repro_torch.models import layers as L
        self.L, self.route, self.shares = L, L.moe_route, []

        def record(*args, **kw):
            r = self.route(*args, **kw)
            self.shares.append(r.dropped_share())
            return r
        L.moe_route = record
        return self

    def __exit__(self, *exc):
        self.L.moe_route = self.route


class _MoESpans:
    """While active, the MoE's dispatch and combine (``_gather_rows``,
    ``_ordered_sum``) and its routing run under ``record_function``
    ranges that ``train_profile`` reads."""

    def __enter__(self):
        from torch.profiler import record_function
        from repro_torch.models import layers as L
        self.L = L
        self.saved = {n: getattr(L, n) for n in
                      ("_gather_rows", "_ordered_sum", "moe_route")}

        def ranged(name, fn):
            def run(*args, **kw):
                with record_function(name):
                    return fn(*args, **kw)
            return run
        L._gather_rows = ranged("moe.dispatch_combine",
                                self.saved["_gather_rows"])
        L._ordered_sum = ranged("moe.dispatch_combine",
                                self.saved["_ordered_sum"])
        L.moe_route = ranged("moe.route", self.saved["moe_route"])
        return self

    def __exit__(self, *exc):
        for n, fn in self.saved.items():
            setattr(self.L, n, fn)


MOE_PROFILE_SPANS = {
    # bmm is the experts' (attention projections are mm; the attention
    # backward is K2-bwd's own kernels)
    "expert GEMMs": (lambda e: e.name == "aten::bmm", None),
    "dispatch and combine": (lambda e: e.name == "moe.dispatch_combine",
                             None),
    "routing": (lambda e: e.name == "moe.route", None)}


def moe_serve(torch, FA, counters, summary: dict):
    """14 (a): olmoe-1b-7b at full width and depth (16 layers, seeded bf16)
    served through the entry point: 2 x 8192-token prompts, 16 tokens;
    then each layer's dropped-slot share on one more, untimed prefill."""
    from repro_torch.launch import steps as ST
    from repro_torch.launch.serve import serve
    from repro_torch.models.transformer import tree_leaves
    for c in counters:                         # counts of this path only
        c.launches = 0
    t0 = time.perf_counter()
    res = serve(MOE_ARCH, batch=2, prompt_len=MOE_SERVE_PROMPT,
                tokens=SERVE_TOKENS, size="full", device="cuda")
    wall = time.perf_counter() - t0
    launches = FA.flash_attention_cuda.launches
    cfg = res.cfg
    check(launches == 2 * cfg.n_layers,
          f"K2 launched {launches} times in 2 prefills of {cfg.n_layers} "
          "layers")
    check_idle(counters, (FA.flash_attention_cuda,), "the MoE path")
    check(bool(torch.isfinite(res.last_logits.float()).all()),
          "finite logits")
    check(res.tokens.shape == (2, SERVE_TOKENS), "token shape")
    check(bool(((res.tokens >= 0) & (res.tokens < cfg.vocab_padded)).all()),
          "token ids in range")
    check(res.pos == MOE_SERVE_PROMPT + SERVE_TOKENS - 1, "cache position")
    n_params = sum(t.numel() for t in tree_leaves(res.params))
    norms = (2 * cfg.n_layers + 1) * cfg.d_model
    check(n_params == cfg.param_count() + norms,
          f"{cfg.name} has {n_params} params")
    with _RouteRecorder() as rec, torch.no_grad():
        ST.build_model(cfg, device="cuda").prefill(res.params, res.prompts)
    FA.flash_attention_cuda.launches = launches
    check(len(rec.shares) == cfg.n_layers, f"{len(rec.shares)} routes")
    mfu = serve_mfu(res)
    out = {"arch": cfg.name, "layers": cfg.n_layers, "params": n_params,
           "batch": 2, "prompt": MOE_SERVE_PROMPT, "tokens": SERVE_TOKENS,
           "prefill_ms": res.prefill_ms,
           "decode_ms_per_token": res.decode_ms_per_token,
           "decode_tokens_per_s": res.decode_tokens_per_s,
           "peak_memory_bytes": res.peak_memory_bytes, "wall_s": wall,
           "k2_launches": launches, "dropped_share_by_layer": rec.shares,
           "mfu": mfu}
    log(f"[moe serve] {cfg.name}: {cfg.n_layers} layers, {n_params} params "
        f"({cfg.moe.n_experts} experts, top-{cfg.moe.top_k}, capacity "
        f"factor {cfg.moe.capacity_factor}), bf16; batch 2 x "
        f"{MOE_SERVE_PROMPT} tokens")
    log(f"[moe serve] prefill {res.prefill_ms:.1f} ms (mfu "
        f"{mfu['prefill']:.3f}, active params); decode "
        f"{res.decode_ms_per_token:.2f} ms/token (mfu {mfu['decode']:.5f}), "
        f"{res.decode_tokens_per_s:.1f} tokens/s; peak "
        f"{res.peak_memory_bytes / 1e9:.2f} GB; K2 {launches} launches; "
        f"wall {wall:.1f} s; request 0: {res.tokens[0, :12].tolist()} ...")
    moe = cfg.moe
    cap = math.ceil(moe.capacity_factor * MOE_SERVE_PROMPT * moe.top_k
                    / moe.n_experts)
    log(f"[moe serve] dropped-slot share by layer (capacity {cap} slots an "
        f"expert and prompt): {[round(x, 4) for x in rec.shares]}")
    summary["moe_serve"] = out
    return launches, res


def moe_train(torch, np, FA, counters, params, summary: dict) -> tuple:
    """14 (b): olmoe-1b-7b at full width and depth, bf16, remat, AdamW (lr
    3e-4, weight decay 0.1, ``moe_aux_weight`` 0.01) from the served
    weights: batch 2 x 4096, 1 warm-up and 1 timed step, then one under
    torch.profiler."""
    from repro_torch.configs import get_full
    from repro_torch.launch import steps as ST
    from repro_torch.models.transformer import tree_leaves
    cfg = get_full(MOE_ARCH).resolve(1)
    torch.cuda.reset_peak_memory_stats()
    model = ST.build_model(cfg, remat=True, device="cuda")
    opt, step = ST.make_train_step(model, lr=3e-4, weight_decay=0.1,
                                   moe_aux_weight=0.01)
    state = opt.init(tree_leaves(params))
    batches = [_lm_batch(torch, np, cfg.vocab, MOE_TRAIN_BATCH,
                         MOE_TRAIN_SEQ, "cuda", seed=i)
               for i in range(1 + TRAIN_TIMED)]
    qkv = _layer0_qkv(torch, cfg, params, batches[0]["tokens"])
    for c in counters:                         # counts of this path only
        c.launches = 0
    losses, auxs, times = [], [], []
    for i, batch in enumerate(batches):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        params, state, metrics = step(params, state, batch)
        t1.record()
        t1.synchronize()
        losses.append(float(metrics["loss"]))
        auxs.append(float(metrics["moe_aux"]))
        if i:
            times.append(t0.elapsed_time(t1))
    launches = FA.flash_attention_cuda.launches
    n_steps = len(batches)
    per_step = 2 * cfg.n_layers        # remat runs each forward twice
    check(launches == per_step * n_steps,
          f"K2 launched {launches} times in {n_steps} steps")
    check(FA.flash_attention_bwd_cuda.launches == cfg.n_layers * n_steps,
          f"K2-bwd launched {FA.flash_attention_bwd_cuda.launches} times in "
          f"{n_steps} steps")
    k2_bwd_record(summary, "moe train", FA.flash_attention_bwd_cuda.launches)
    check_idle(counters, (FA.flash_attention_cuda,
                          FA.flash_attention_bwd_cuda), "the MoE path")
    check(all(math.isfinite(x) for x in losses + auxs),
          f"losses {losses}, aux {auxs}")
    peak = torch.cuda.max_memory_allocated()
    total = torch.cuda.get_device_properties(0).total_memory
    step_ms = sorted(times)[len(times) // 2]
    tokens = MOE_TRAIN_BATCH * MOE_TRAIN_SEQ
    out = {"arch": cfg.name, "layers": cfg.n_layers,
           "batch": MOE_TRAIN_BATCH, "seq": MOE_TRAIN_SEQ, "remat": True,
           "step_ms": times, "median_step_ms": step_ms,
           "tokens_per_s": tokens / (step_ms / 1e3), "losses": losses,
           "moe_aux": auxs, "peak_memory_bytes": peak,
           "free_at_peak_bytes": total - peak,
           "k2_launches_per_step": launches // n_steps,
           "mfu": lm_mfu(cfg, "train", MOE_TRAIN_BATCH, MOE_TRAIN_SEQ,
                         step_ms)}
    log(f"[moe train] {cfg.name}: {cfg.n_layers} layers, bf16, remat, "
        f"AdamW (lr 3e-4, wd 0.1, moe_aux_weight 0.01); batch "
        f"{MOE_TRAIN_BATCH} x {MOE_TRAIN_SEQ} tokens")
    log(f"[moe train] step ms {[round(t, 2) for t in times]} (median "
        f"{step_ms:.2f}, mfu {out['mfu']:.3f} on active params, 1 warm-up "
        f"step before), {out['tokens_per_s']:.0f} "
        f"tokens/s; losses {[round(x, 4) for x in losses]}; moe_aux "
        f"{[round(x, 4) for x in auxs]}; peak {peak / 1e9:.2f} GB of "
        f"{total / 1e9:.2f} GB; K2 {launches // n_steps} launches a step (the "
        f"forward and remat's recompute)")
    if total - peak < 4e9:
        log(f"[moe train] the peak leaves {(total - peak) / 1e9:.2f} GB "
            f"free, under 4 GB: cut the batch to 1 x {MOE_TRAIN_SEQ}")
    for c in counters:
        c.launches = 0
    with _MoESpans():
        out["profile"] = train_profile(torch, step, params, state,
                                       batches[0], spans=MOE_PROFILE_SPANS)
    check(FA.flash_attention_cuda.launches == per_step,
          "K2 launches in the profiled step")
    launches += FA.flash_attention_cuda.launches
    # the step's two halves by CUDA events: the gradients, then AdamW
    grad_fn = ST.make_grad_fn(model, moe_aux_weight=0.01)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ev[0].record()
    grads, _, _ = grad_fn(params, batches[1])
    ev[1].record()
    state = opt.apply(grads, state, tree_leaves(params))
    ev[2].record()
    ev[2].synchronize()
    out["grad_ms"] = ev[0].elapsed_time(ev[1])
    out["adamw_ms"] = ev[1].elapsed_time(ev[2])
    log(f"[moe train] one more step by CUDA events: gradients "
        f"{out['grad_ms']:.1f} ms, AdamW {out['adamw_ms']:.1f} ms "
        f"({out['adamw_ms'] / step_ms:.3f} of the median step)")
    launches += FA.flash_attention_cuda.launches - per_step
    # the profiled step's and this one's
    k2_bwd_record(summary, "moe train", FA.flash_attention_bwd_cuda.launches)
    del state, batches, grads
    torch.cuda.empty_cache()
    summary["moe_train"] = out
    return launches, qkv


def moe_dbrx(torch, np, FA, plain, counters, summary: dict) -> int:
    """14 (c): dbrx-132b at full width cut to 2 layers, bf16, seeded: one
    serve (a 2 x 1024-token prefill and 8 greedy decode steps), K2 on
    layer 0's q/k/v of the train batch held to plain (48 / 8 heads), and
    one train step (2 x 1024, AdamW, no remat)."""
    from repro_torch.configs import get_full
    from repro_torch.launch import steps as ST
    from repro_torch.models.transformer import tree_leaves
    for c in counters:                         # counts of this path only
        c.launches = 0
    cfg = dataclasses.replace(get_full("dbrx-132b"),
                              n_layers=DBRX_LAYERS).resolve(1)
    torch.cuda.reset_peak_memory_stats()
    model = ST.build_model(cfg, remat=False, device="cuda")
    params = model.init_params(0)
    n_params = sum(t.numel() for t in tree_leaves(params))
    batch = _lm_batch(torch, np, cfg.vocab, 2, DENSE_SEQ, "cuda")
    t0 = time.perf_counter()
    served = timed_serve(torch, model, params, {"tokens": batch["tokens"]},
                         DENSE_DECODE, DENSE_SEQ + DENSE_DECODE)
    toks, logits = served["tokens"], served["logits"]
    serve_s = time.perf_counter() - t0
    check(bool(torch.isfinite(logits.float()).all()), "dbrx finite logits")
    check(bool(((toks >= 0) & (toks < cfg.vocab_padded)).all()),
          "dbrx token ids in range")
    del logits
    k2_err = k2_train_forward_check(
        torch, FA, plain, *_layer0_qkv(torch, cfg, params, batch["tokens"]),
        None, "dbrx-132b layer 0 of the train batch")
    opt, step = ST.make_train_step(model, lr=3e-4, weight_decay=0.1,
                                   moe_aux_weight=0.01)
    state = opt.init(tree_leaves(params))
    t0 = time.perf_counter()
    params, state, metrics = step(params, state, batch)
    loss, aux = float(metrics["loss"]), float(metrics["moe_aux"])
    train_s = time.perf_counter() - t0
    check(math.isfinite(loss) and math.isfinite(aux),
          f"dbrx loss {loss}, aux {aux}")
    launches = FA.flash_attention_cuda.launches
    check(launches == 2 * cfg.n_layers, f"dbrx: K2 launched {launches}")
    k2_bwd_record(summary, "dbrx", FA.flash_attention_bwd_cuda.launches)
    check_idle(counters, (FA.flash_attention_cuda,
                          FA.flash_attention_bwd_cuda), "the MoE path")
    peak = torch.cuda.max_memory_allocated()
    mfu = {"train": lm_mfu(cfg, "train", 2, DENSE_SEQ, train_s * 1e3),
           "prefill": lm_mfu(cfg, "prefill", 2, DENSE_SEQ,
                             served["prefill_ms"]),
           "decode": lm_mfu(cfg, "decode", 2, DENSE_SEQ,
                            served["decode_ms_per_token"])}
    out = {"params": n_params, "layers": cfg.n_layers, "loss": loss,
           "moe_aux": aux, "train_s": train_s, "serve_s": serve_s,
           "prefill_ms": served["prefill_ms"],
           "decode_ms_per_token": served["decode_ms_per_token"], "mfu": mfu,
           "tokens": toks.tolist(), "k2_launches": launches,
           "k2_vs_plain": k2_err, "peak_memory_bytes": peak}
    log(f"[moe dbrx] dbrx-132b at {cfg.n_layers} layers, {n_params} params "
        f"({cfg.moe.n_experts} experts, top-{cfg.moe.top_k}; "
        f"{cfg.n_heads} q / {cfg.n_kv_heads} kv heads, hd {cfg.head_dim}): "
        f"serve {serve_s:.2f} s (prefill {served['prefill_ms']:.1f} ms, "
        f"mfu {mfu['prefill']:.3f}; decode "
        f"{served['decode_ms_per_token']:.2f} ms/token, mfu "
        f"{mfu['decode']:.5f}; active params), greedy tokens "
        f"{toks[0].tolist()}; train step loss {loss:.4f}, moe_aux "
        f"{aux:.4f} ({train_s:.2f} s with its first launches, host clock: "
        f"mfu {mfu['train']:.3f}); K2 {launches} launches; peak "
        f"{peak / 1e9:.2f} GB")
    del params, state, batch
    torch.cuda.empty_cache()
    summary["moe_dbrx"] = out
    return launches


def moe_cross_device(torch, np, FA, counters, summary: dict) -> int:
    """14 (e): olmoe-1b-7b and dbrx-132b at SMOKE, float32, on the card and
    on the CPU from the same weights: ``moe_apply`` on layer 0's experts
    (the same routes and dropped slots; output and load-balance loss within
    1e-5 of their largest), one train step's loss (1e-5 relative) and
    gradients (1e-4 of each leaf's largest), and 8 greedy decode tokens
    after a 2 x 64 prefill (equal); then two card runs of bf16
    ``moe_apply`` at olmoe's width (output and input gradient) bit-equal."""
    from repro_torch.configs import get_smoke
    from repro_torch.launch import steps as ST
    from repro_torch.models import layers as L
    from repro_torch.models.transformer import map_params
    for c in counters:                         # counts of this path only
        c.launches = 0
    out = {}
    for arch in ("olmoe-1b-7b", "dbrx-132b"):
        cfg = get_smoke(arch).resolve(1)
        moe = cfg.moe
        kw = dict(n_experts=moe.n_experts, top_k=moe.top_k,
                  capacity_factor=moe.capacity_factor)
        models = [ST.build_model(cfg, remat=False, q_chunk=32, kv_chunk=32,
                                 dtype=torch.float32, device=dev)
                  for dev in ("cuda", "cpu")]
        params = models[0].init_params(0)
        both = [params, map_params(lambda t: t.cpu().clone(), params)]
        gen = torch.Generator().manual_seed(5)
        x = torch.randn((2, MOE_CROSS_SEQ, cfg.d_model), generator=gen)
        batch = _lm_batch(torch, np, cfg.vocab, 2, MOE_CROSS_SEQ, "cpu")
        runs = []
        for model, p in zip(models, both):
            dev = model.device
            lp = map_params(lambda t: t[0], p["layers"])["moe"]
            xd = x.to(dev)
            r = L.moe_route(xd, lp["router"], **kw)
            y, aux = L.moe_apply(lp, xd, act=cfg.act, **kw)
            b = {k: v.to(dev) for k, v in batch.items()}
            g, loss, _ = ST.make_grad_fn(model)(p, b)
            logits, cache = model.prefill(p, b["tokens"],
                                          capacity=MOE_CROSS_SEQ
                                          + MOE_CROSS_DECODE)
            tok = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)
            toks = [tok]
            for _ in range(MOE_CROSS_DECODE - 1):
                logits, cache = model.decode_step(p, cache, tok)
                tok = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)
                toks.append(tok)
            runs.append({"route": [t.cpu() for t in (r.top_e, r.tok_buf,
                                                     r.slot)],
                         "y": y.cpu(), "aux": float(aux),
                         "loss": float(loss), "g": [t.cpu() for t in g],
                         "tokens": torch.cat(toks, 1).cpu()})
        gpu, cpu = runs
        same_route = all(torch.equal(a, b) for a, b in zip(gpu["route"],
                                                            cpu["route"]))
        check(same_route, f"{arch}: routes differ between cuda and cpu")
        y_err = _max_rel(torch, gpu["y"], cpu["y"])
        aux_err = abs(gpu["aux"] - cpu["aux"]) / abs(cpu["aux"])
        loss_err = abs(gpu["loss"] - cpu["loss"]) / abs(cpu["loss"])
        grad_err = max(_max_rel(torch, a, b)
                       for a, b in zip(gpu["g"], cpu["g"]))
        check(y_err <= 1e-5 and aux_err <= 1e-5,
              f"{arch}: moe_apply cuda vs cpu {y_err}, aux {aux_err}")
        check(loss_err <= 1e-5 and grad_err <= 1e-4,
              f"{arch}: train step cuda vs cpu loss {loss_err}, "
              f"gradients {grad_err}")
        check(torch.equal(gpu["tokens"], cpu["tokens"]),
              f"{arch}: greedy tokens {gpu['tokens'].tolist()} vs "
              f"{cpu['tokens'].tolist()}")
        out[arch] = {"moe_rel_err": y_err, "aux_rel_err": aux_err,
                     "loss_rel_err": loss_err, "grad_max_rel_err": grad_err,
                     "tokens": gpu["tokens"].tolist()}
        log(f"[moe cross] {arch} SMOKE, float32: cuda == cpu: routes equal "
            f"(top_e, tok_buf, slots), moe_apply max |err| / max |y| "
            f"{y_err:.3g} and aux {aux_err:.3g} (limits 1e-5); train step "
            f"loss {loss_err:.3g} (1e-5), gradients {grad_err:.3g} (1e-4); "
            f"greedy tokens equal {gpu['tokens'][0].tolist()}")
    launches = FA.flash_attention_cuda.launches
    check(launches == 2 * 2 * 2, f"K2 launched {launches} times")
    k2_bwd_record(summary, "moe cuda vs cpu",
                  FA.flash_attention_bwd_cuda.launches)
    # determinism: the ordered combine and its transpose, at olmoe's width
    from repro_torch.configs import get_full
    cfg = get_full(MOE_ARCH)
    gen = torch.Generator(device="cuda").manual_seed(7)
    D, Fd, E = cfg.d_model, cfg.d_ff, cfg.moe.n_experts
    p = {"router": torch.randn((D, E), generator=gen, device="cuda") * 0.02,
         **{k: (torch.randn(s, generator=gen, device="cuda") * 0.02).to(
             torch.bfloat16) for k, s in (("wg", (E, D, Fd)),
                                          ("wu", (E, D, Fd)),
                                          ("wo", (E, Fd, D)))}}
    x0 = torch.randn((1, MOE_TRAIN_SEQ, D), generator=gen,
                     device="cuda").to(torch.bfloat16)
    bits = []
    for _ in range(2):
        x = x0.clone().requires_grad_(True)
        y, _ = L.moe_apply(p, x, n_experts=E, top_k=cfg.moe.top_k,
                           capacity_factor=cfg.moe.capacity_factor,
                           act=cfg.act)
        (gx,) = torch.autograd.grad(y.float().square().sum(), x)
        bits.append((y.detach().view(torch.int16), gx.view(torch.int16)))
    det = (torch.equal(bits[0][0], bits[1][0])
           and torch.equal(bits[0][1], bits[1][1]))
    check(det, "two card runs of the bf16 combine differ")
    out["bf16_combine_bit_equal"] = det
    log(f"[moe cross] bf16 moe_apply at olmoe's width (1 x {MOE_TRAIN_SEQ} "
        f"tokens, {E} experts, top-{cfg.moe.top_k}): two card runs "
        f"bit-equal, output and input gradient")
    summary["moe_cross_device"] = out
    return launches


def phase_moe(torch, np, FA, plain, counters, summary: dict) -> dict:
    """The MoE path; returns K2's launches by path.  Each leg prints its
    seconds."""
    launches, legs = {}, {}
    t0 = time.perf_counter()
    launches["moe serve"], res = moe_serve(torch, FA, counters, summary)
    legs["a serve"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    checks = {"served prompts": k2_train_forward_check(
        torch, FA, plain, *_layer0_qkv(torch, res.cfg, res.params,
                                       res.prompts), None,
        "olmoe-1b-7b layer 0 of the served prompts")}
    torch.cuda.empty_cache()
    legs["d K2 checks"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    launches["moe train"], qkv = moe_train(torch, np, FA, counters,
                                           res.params, summary)
    del res
    legs["b train"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    checks["train batch"] = k2_train_forward_check(
        torch, FA, plain, *qkv, None, "olmoe-1b-7b layer 0 of the train "
        "batch")
    summary["moe_k2_checks"] = checks
    del qkv
    torch.cuda.empty_cache()
    legs["d K2 checks"] += time.perf_counter() - t0
    t0 = time.perf_counter()
    launches["moe dbrx"] = moe_dbrx(torch, np, FA, plain, counters, summary)
    legs["c dbrx"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    launches["moe cuda vs cpu"] = moe_cross_device(torch, np, FA, counters,
                                                   summary)
    legs["e cuda vs cpu"] = time.perf_counter() - t0
    for name, secs in legs.items():
        log(f"[moe] leg {name}: {secs:.1f} s")
    summary["moe_legs_s"] = legs
    return launches


SSM_SERVE_PROMPT = 8192          # 15 (a), (b): as phases 7 and 14 serve
SCAN_PLAIN_REPEATS = 1           # 15 (e): the plain loops, 1 after 1 warm-up
SSM_CROSS_SEQ = 80               # 15 (d): SMOKE, float32, past hymba's window
SSM_CROSS_DECODE = 8


class _FirstCall:
    """While active, keeps the arguments of the first call of
    ``module.name`` (``args``, ``kwargs``; the call itself still runs)."""

    def __init__(self, module, name: str):
        self.module, self.name = module, name
        self.args = self.kwargs = None

    def __enter__(self):
        self.fn = getattr(self.module, self.name)

        def record(*args, **kwargs):
            if self.args is None:
                self.args, self.kwargs = args, kwargs
            return self.fn(*args, **kwargs)
        setattr(self.module, self.name, record)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)


def _f64_errs(out, plain_out, ref64) -> dict:
    """Phase 3b's rule: the kernel's largest error against float64 at most
    twice plain float32's plus 1e-6."""
    e_k = float((out.double() - ref64).abs().max())
    e_p = float((plain_out.double() - ref64).abs().max())
    return {"kernel": e_k, "plain": e_p, "limit": 2 * e_p + 1e-6,
            "share": e_k / (2 * e_p + 1e-6)}


# The serial scans' prefill (2 x 8192) and decode ms a token, the range
# of four smokes on an NVIDIA H100 80GB HBM3 at 700 W: one thread a
# channel (K3) and one 64-thread block a head (K4).  Printed beside this
# run's for comparison, not checked: another card's clock or the host's
# load moves them.
SSM_SERIAL_DESIGN = {"hymba-1.5b": {"prefill_ms": (394.5, 400.9),
                                    "decode_ms_per_token": (80.94, 83.40)},
                     "rwkv6-1.6b": {"prefill_ms": (320.9, 325.0),
                                    "decode_ms_per_token": (25.66, 29.69)}}
# K3's and K4's times at the yardstick with the serial scans on that card;
# a kernel that takes half of it or more has fallen back to that design
SSM_SERIAL_MS = {"selective_scan": 3.274, "wkv6": 5.164}
# K3-bwd's and K4-bwd's times (both launches) at the train shape in their
# first design (2 blocks an SM with the walk's products in shared memory;
# a head over 2 blocks, one an SM) on that card; a backward that takes
# 3/4 of it or more has gone back to that design
SSM_GRAD_FIRST_MS = {"selective_scan_bwd": 4.05, "wkv6_bwd": 3.96}


def ssm_serve(torch, FA, SS, WK, counters, arch: str, summary: dict):
    """15 (a), (b): ``arch`` at full width and depth (seeded bf16) served
    through the entry point: 2 x 8192-token prompts, 16 tokens; then
    layer 0's real scan inputs, kept from one more untimed prefill, and
    torch.profiler over a prefill and 4 decode steps (phase 7b's)."""
    from repro_torch.kernels.selective_scan import ops as scan_ops
    from repro_torch.kernels.wkv6 import ops as wkv_ops
    from repro_torch.launch import steps as ST
    from repro_torch.launch.serve import serve
    from repro_torch.models.transformer import tree_leaves
    for c in counters:                         # counts of this path only
        c.launches = 0
    t0 = time.perf_counter()
    res = serve(arch, batch=2, prompt_len=SSM_SERVE_PROMPT,
                tokens=SERVE_TOKENS, size="full", device="cuda")
    wall = time.perf_counter() - t0
    cfg = res.cfg
    n = cfg.n_layers
    hybrid = cfg.block == "hybrid"
    scan = SS.selective_scan_cuda if hybrid else WK.wkv6_cuda
    # a warm-up and a timed prefill, then SERVE_TOKENS - 1 decode steps
    expect = {id(scan): n * (2 + SERVE_TOKENS - 1)}
    if hybrid:
        expect[id(FA.flash_attention_cuda)] = 2 * n
    launches = {type(c).__name__: c.launches for c in counters}
    for c in counters:
        want = expect.get(id(c), 0)
        check(c.launches == want, f"{cfg.name}: {type(c).__name__} "
              f"launched {c.launches} times, not {want}")
    check(bool(torch.isfinite(res.last_logits.float()).all()),
          f"{cfg.name}: finite logits")
    check(res.tokens.shape == (2, SERVE_TOKENS), "token shape")
    check(bool(((res.tokens >= 0) & (res.tokens < cfg.vocab_padded)).all()),
          "token ids in range")
    check(res.pos == SSM_SERVE_PROMPT + SERVE_TOKENS - 1, "cache position")
    # the tree against param_layout, which tests/test_torch_lm_ssm.py
    # holds to the reference's jax.eval_shape at full width
    model = ST.build_model(cfg, device="cuda")
    layout = [(tuple(s.shape), s.dtype)
              for s in tree_leaves(model.param_layout())]
    got = [(tuple(t.shape), t.dtype) for t in tree_leaves(res.params)]
    check(got == layout, f"{cfg.name}: the tree is not param_layout's")
    n_params = sum(t.numel() for t in tree_leaves(res.params))
    with torch.no_grad(), _FirstCall(
            scan_ops if hybrid else wkv_ops,
            "selective_scan" if hybrid else "wkv6") as rec:
        model.prefill(res.params, res.prompts)
    del model
    phase_profile(torch, res, summary, key=f"ssm_profile {cfg.name}")
    for c in counters:
        c.launches = launches[type(c).__name__]
    mfu = serve_mfu(res)
    out = {"arch": cfg.name, "layers": n, "params": n_params,
           "param_count_approx": cfg.param_count(), "batch": 2,
           "prompt": SSM_SERVE_PROMPT, "tokens": SERVE_TOKENS,
           "prefill_ms": res.prefill_ms,
           "decode_ms_per_token": res.decode_ms_per_token,
           "decode_tokens_per_s": res.decode_tokens_per_s,
           "peak_memory_bytes": res.peak_memory_bytes, "wall_s": wall,
           "launches": launches, "mfu": mfu}
    log(f"[ssm serve] {cfg.name}: {n} layers, {n_params} params "
        f"(param_count() {cfg.param_count()}, approximate), bf16; batch 2 x "
        f"{SSM_SERVE_PROMPT} tokens")
    serial = SSM_SERIAL_DESIGN[cfg.name]
    log(f"[ssm serve] {cfg.name}: prefill {res.prefill_ms:.1f} ms (mfu "
        f"{mfu['prefill']:.3f}); decode {res.decode_ms_per_token:.2f} "
        f"ms/token (mfu {mfu['decode']:.5f}), "
        f"{res.decode_tokens_per_s:.1f} tokens/s; peak "
        f"{res.peak_memory_bytes / 1e9:.2f} GB; wall {wall:.1f} s; launches "
        f"{launches}; request 0: {res.tokens[0, :12].tolist()} ...")
    log(f"[ssm serve] {cfg.name}: the serial scans' prefill "
        f"{serial['prefill_ms'][0]}-{serial['prefill_ms'][1]} ms, decode "
        f"{serial['decode_ms_per_token'][0]}-"
        f"{serial['decode_ms_per_token'][1]} ms/token (H100 80GB HBM3, "
        "700 W)")
    out["serial_design"] = serial
    summary.setdefault("ssm_serve", {})[cfg.name] = out
    return res, rec.args, launches


def k3_checks(torch, SS, args) -> dict:
    """15 (c): K3 on layer 0's real inputs at the served shape against
    plain and a float64 run of the plain loop: float32 x by phase 3b's
    rule (y and hT); the served bf16 x: y within one bf16 ulp of plain's,
    hT by the same rule.  hT (both) and float32 y equal plain's bit for
    bit.  Launches here are put back."""
    from repro_torch.kernels.selective_scan.ref import selective_scan_plain
    x, rest = args[0], args[1:]
    n0 = SS.selective_scan_cuda.launches
    out = {"shape": list(x.shape), "state_dim": int(rest[3].shape[1])}
    with torch.no_grad():
        y64, h64 = selective_scan_plain(x.double(),
                                        *(t.double() for t in rest))
        # plain on bf16 x is plain on its float32 values, y rounded once
        yp32, hp = selective_scan_plain(x.float(), *rest)
        for name, xin in (("float32", x.float()), ("bfloat16", x)):
            y, hT = SS.selective_scan_cuda(xin, *rest)
            yp = yp32.to(xin.dtype)
            torch.cuda.synchronize()
            e = {"hT": _f64_errs(hT, hp, h64),
                 "max_abs_vs_plain": float((y.float() - yp.float()).abs()
                                           .max()),
                 "hT_bits_equal": bits_equal(torch, hT, hp)}
            check(e["hT_bits_equal"], f"K3 {name} hT differs from plain's "
                  "bits")
            if name == "float32":
                e["y"] = _f64_errs(y, yp, y64)
                e["y_bits_equal"] = bits_equal(torch, y, yp)
                check(e["y_bits_equal"], "K3 float32 y differs from plain's "
                      "bits")
            else:
                lim = torch.maximum(bf16_ulp(torch, y), bf16_ulp(torch, yp))
                d = (y.float() - yp.float()).abs()
                e["y_ulps"] = float((d / lim.clamp(min=1e-38)).max())
                check(e["y_ulps"] <= 1, f"K3 bf16 y {e['y_ulps']} ulps "
                      "from plain's")
            for k in ("y", "hT"):
                if k in e:
                    check(e[k]["share"] <= 1, f"K3 {name} {k}: {e[k]}")
            out[name] = e
            del y, hT, yp
    SS.selective_scan_cuda.launches = n0
    f, b = out["float32"], out["bfloat16"]
    log(f"[ssm k3] layer 0 of the served prompts, x {tuple(x.shape)}: "
        f"float32 y max |err| vs float64 {f['y']['kernel']:.3g} (limit "
        f"{f['y']['limit']:.3g}: plain {f['y']['plain']:.3g}), hT "
        f"{f['hT']['kernel']:.3g} (limit {f['hT']['limit']:.3g}); bf16 y "
        f"within {b['y_ulps']:.3g} ulp of plain's, hT {b['hT']['kernel']:.3g}"
        f" (limit {b['hT']['limit']:.3g}); hT (both) and float32 y equal "
        "plain's bit for bit")
    return out


def k4_checks(torch, WK, args) -> dict:
    """15 (c): K4 on layer 0's real inputs at the served shape against
    plain and a float64 run of the plain loop, by phase 3b's rule (y and
    sT), on the served bf16 r, k, v and on their float32 values; sT
    equals plain's bit for bit.  Launches here are put back."""
    from repro_torch.kernels.wkv6.ref import wkv6_plain
    r, k, v, w, u, s0 = args
    u = u.float()
    n0 = WK.wkv6_cuda.launches
    out = {"shape": list(r.shape)}
    with torch.no_grad():
        y64, s64 = wkv6_plain(*(t.double() for t in (r, k, v, w, u, s0)))
        for name, dt in (("float32", torch.float32),
                         ("bfloat16", torch.bfloat16)):
            rkv = [t.to(dt) for t in (r, k, v)]
            y, sT = WK.wkv6_cuda(*rkv, w, u, s0)
            yp, sp = wkv6_plain(*rkv, w, u, s0)
            torch.cuda.synchronize()
            e = {"y": _f64_errs(y, yp, y64), "sT": _f64_errs(sT, sp, s64),
                 "max_abs_vs_plain": float((y - yp).abs().max()),
                 "sT_bits_equal": bits_equal(torch, sT, sp)}
            check(e["sT_bits_equal"], f"K4 {name} sT differs from plain's "
                  "bits")
            for key in ("y", "sT"):
                check(e[key]["share"] <= 1, f"K4 {name} {key}: {e[key]}")
            out[name] = e
            del y, sT, yp, sp
    WK.wkv6_cuda.launches = n0
    for name in ("float32", "bfloat16"):
        e = out[name]
        log(f"[ssm k4] layer 0 of the served prompts, r {tuple(r.shape)}, "
            f"{name} r/k/v: y max |err| vs float64 {e['y']['kernel']:.3g} "
            f"(limit {e['y']['limit']:.3g}: plain {e['y']['plain']:.3g}), sT "
            f"{e['sT']['kernel']:.3g} (limit {e['sT']['limit']:.3g}), equal "
            "to plain's bit for bit")
    return out


def scan_yardstick(torch, kernel, plain, args, decode_args, occupancy, *,
                   name: str, source: str, replaces: str, nbytes: int,
                   ops: int, exps: int, err: float, summary: dict) -> dict:
    """15 (e): a scan kernel's median of 10 after 2 warm-ups at the served
    shape and at the decode shape (``decode_args``: S 1), its plain
    version's median of 3 after 1, the bound (the largest of the bytes,
    the float32 operations and the exponentials at the SFU's rate), its
    registers and resident warps an SM (``occupancy``).  Fails if the
    kernel takes half of the serial design's time or more."""
    from repro_torch.profiling.microbench import median_time_ms
    n0 = kernel.launches
    with torch.no_grad():
        ms = median_time_ms(kernel, args, warmup=2, repeats=10)
        decode_ms = median_time_ms(kernel, decode_args, warmup=2, repeats=10)
        plain_ms = median_time_ms(plain, args, warmup=1,
                                  repeats=SCAN_PLAIN_REPEATS)
    kernel.launches = n0
    terms = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
             "float32 operations": ops / F32_FLOP_PER_S * 1e3,
             "exp (SFU)": exps / SFU_EXP_PER_S * 1e3}
    term = max(terms, key=terms.get)
    row = {"name": name, "route": "cuda", "source": source,
           "replaces": replaces, "max_abs_err": err, "ms": ms,
           "plain_ms": plain_ms, "bound_ms": terms[term],
           "bound_by": "bytes" if term == "bytes" else "operations",
           "bound_term": term, "library_ms": None, "decode_ms": decode_ms,
           "registers": occupancy["registers"],
           "warps_per_sm": occupancy["warps_per_sm"]}
    summary.setdefault("ssm_yardstick", {})[name] = {
        "bytes": nbytes, "ops": ops, "exps": exps, "bound_terms_ms": terms,
        "bound_share": row["bound_ms"] / ms, "occupancy": occupancy,
        "serial_design_ms": SSM_SERIAL_MS[name], **row}
    log(f"[ssm yardstick] {name}: {ms:.3f} ms ({row['bound_ms'] / ms:.1%} of "
        f"the bound {row['bound_ms']:.3f} ms, {term}: {nbytes / 1e9:.3f} GB "
        f"{terms['bytes']:.3f} ms, {ops / 1e9:.2f} G float32 ops "
        f"{terms['float32 operations']:.3f} ms, {exps / 1e9:.3f} G exp "
        f"{terms['exp (SFU)']:.3f} ms); the serial design "
        f"{SSM_SERIAL_MS[name]} ms; decode shape {decode_ms:.4f} ms; plain "
        f"{plain_ms:.1f} ms; {occupancy['registers']} registers, "
        f"{occupancy['warps_per_sm']} warps an SM; no single PyTorch call "
        "computes it (library: none)")
    check(ms < SSM_SERIAL_MS[name] / 2, f"{name}: {ms:.3f} ms is not below "
          f"half of the serial design's {SSM_SERIAL_MS[name]} ms")
    return row


def ssm_cross_device(torch, np, counters, summary: dict) -> dict:
    """15 (d): hymba-1.5b and rwkv6-1.6b at SMOKE, seeded, float32, on the
    card (K2, K3, K4) and on the CPU (plain): a 2 x 80-token prefill and 8
    greedy tokens; every logit within 1e-4, the tokens equal."""
    from repro_torch.configs import get_smoke
    from repro_torch.launch import steps as ST
    from repro_torch.models.transformer import map_params
    for c in counters:                         # counts of this path only
        c.launches = 0
    out = {}
    for arch in ("hymba-1.5b", "rwkv6-1.6b"):
        cfg = get_smoke(arch).resolve(1)
        prompt = torch.as_tensor(np.random.default_rng(0).integers(
            0, cfg.vocab, (2, SSM_CROSS_SEQ)), dtype=torch.int32)
        runs, params = [], None
        for dev in ("cuda", "cpu"):
            model = ST.build_model(cfg, dtype=torch.float32, device=dev)
            params = model.init_params(0) if params is None else map_params(
                lambda t: t.cpu().clone(), params)
            logits, cache = model.prefill(
                params, prompt.to(dev),
                capacity=SSM_CROSS_SEQ + SSM_CROSS_DECODE)
            tok = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)
            lgs, toks = [logits.cpu()], [tok.cpu()]
            for _ in range(SSM_CROSS_DECODE - 1):
                logits, cache = model.decode_step(params, cache, tok)
                tok = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)
                lgs.append(logits.cpu())
                toks.append(tok.cpu())
            runs.append((lgs, torch.cat(toks, 1)))
        (lg, tg), (lc, tc) = runs
        err = max(float((a - b).abs().max()) for a, b in zip(lg, lc))
        check(err <= 1e-4, f"{arch}: logits cuda vs cpu {err}")
        check(torch.equal(tg, tc), f"{arch}: greedy tokens {tg.tolist()} vs "
              f"{tc.tolist()}")
        out[arch] = {"logits_max_abs_err": err, "tokens": tg.tolist()}
        log(f"[ssm cross] {arch} SMOKE, float32, 2 x {SSM_CROSS_SEQ} + "
            f"{SSM_CROSS_DECODE} tokens: cuda == cpu, logits max |err| "
            f"{err:.3g} (limit 1e-4), greedy tokens equal "
            f"{tg[0].tolist()}")
    launches = {type(c).__name__: c.launches for c in counters}
    summary["ssm_cross_device"] = out
    return launches


def _decode_shape(args, n_seq: int) -> tuple:
    """A scan's arguments cut to the last step (S 1): the first ``n_seq``
    run along time."""
    return tuple(a[:, -1:].contiguous() for a in args[:n_seq]) + tuple(
        args[n_seq:])


def phase_ssm(torch, np, FA, SS, WK, plain, counters, summary: dict) -> dict:
    """The hybrid SSM and RWKV path.  Returns each kernel's launches by
    path (``"k2"``, ``"k3"``, ``"k4"``) and K3's and K4's rows.  Each leg
    prints its seconds."""
    from repro_torch.kernels.selective_scan.ref import selective_scan_plain
    from repro_torch.kernels.wkv6.ref import wkv6_plain
    legs = dict.fromkeys(("a hymba serve", "b rwkv serve", "c kernel checks",
                          "d cuda vs cpu", "e yardsticks"), 0.0)
    names = {k: type(c).__name__ for k, c in (
        ("k2", FA.flash_attention_cuda), ("k3", SS.selective_scan_cuda),
        ("k4", WK.wkv6_cuda))}
    paths = {"k2": {}, "k3": {}, "k4": {}}
    rows, checks = {}, {}

    t0 = time.perf_counter()
    res, args, launches = ssm_serve(torch, FA, SS, WK, counters,
                                    "hymba-1.5b", summary)
    paths["k2"]["hybrid serve"] = launches[names["k2"]]
    paths["k3"]["hybrid serve"] = launches[names["k3"]]
    legs["a hymba serve"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    cfg = res.cfg
    checks["k3"] = k3_checks(torch, SS, args)
    checks["k2"] = k2_train_forward_check(
        torch, FA, plain, *_layer0_qkv(torch, cfg, res.params, res.prompts),
        cfg.sliding_window, "hymba-1.5b layer 0 of the served prompts")
    legs["c kernel checks"] += time.perf_counter() - t0
    t0 = time.perf_counter()
    x, dt, Bc, Cc, A, h0 = args
    B, S, Di = x.shape
    N = A.shape[1]
    rows["k3"] = scan_yardstick(
        torch, SS.selective_scan_cuda, selective_scan_plain, args,
        _decode_shape(args, 4), SS.selective_scan_cuda.occupancy(x.dtype, N),
        name="selective_scan", source="src/repro_torch/csrc/selective_scan.cu",
        replaces="src/repro/models/ssm.py:39 (_ssm_recurrence's lax.scan "
                 "at :55; no Pallas kernel)",
        nbytes=(2 * x.numel() * x.element_size() + dt.numel() * 4
                + (Bc.numel() + Cc.numel() + A.numel() + 2 * h0.numel()) * 4),
        ops=B * S * Di * (7 * N + 1), exps=B * S * Di * N,
        err=checks["k3"]["float32"]["max_abs_vs_plain"], summary=summary)
    del res, args, x, dt, Bc, Cc, A, h0
    torch.cuda.empty_cache()
    legs["e yardsticks"] += time.perf_counter() - t0

    t0 = time.perf_counter()
    res, args, launches = ssm_serve(torch, FA, SS, WK, counters,
                                    "rwkv6-1.6b", summary)
    paths["k4"]["rwkv serve"] = launches[names["k4"]]
    legs["b rwkv serve"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    checks["k4"] = k4_checks(torch, WK, args)
    legs["c kernel checks"] += time.perf_counter() - t0
    t0 = time.perf_counter()
    r, k, v, w, u, s0 = args
    B, S, H, hd = r.shape
    k4_args = (r, k, v, w, u.float(), s0)
    rows["k4"] = scan_yardstick(
        torch, WK.wkv6_cuda, wkv6_plain, k4_args, _decode_shape(k4_args, 4),
        WK.wkv6_cuda.occupancy(r.dtype), name="wkv6",
        source="src/repro_torch/csrc/wkv6.cu",
        replaces="src/repro/models/ssm.py:123 (rwkv_time_mix's lax.scan at "
                 ":151; no Pallas kernel)",
        nbytes=(3 * r.numel() * r.element_size() + w.numel() * 4
                + r.numel() * 4 + u.numel() * 4 + 2 * s0.numel() * 4),
        ops=B * S * H * hd * hd * 7, exps=0,
        err=checks["k4"]["float32"]["max_abs_vs_plain"], summary=summary)
    del res, args, k4_args, r, k, v, w, u, s0
    torch.cuda.empty_cache()
    legs["e yardsticks"] += time.perf_counter() - t0

    t0 = time.perf_counter()
    launches = ssm_cross_device(torch, np, counters, summary)
    for key in paths:
        paths[key]["ssm cuda vs cpu"] = launches[names[key]]
    legs["d cuda vs cpu"] = time.perf_counter() - t0
    summary["ssm_kernel_checks"] = checks
    for name, secs in legs.items():
        log(f"[ssm] leg {name}: {secs:.1f} s")
    summary["ssm_legs_s"] = legs
    return {"paths": paths, "rows": rows}


SSM_TRAIN_BATCH = 2              # 16 (a), (b): train_4k's sequence, its
SSM_TRAIN_SEQ = 4096             # batch cut from 256 to 2
SSM_TRAIN_TIMED = 1              # after 1 warm-up step
SSM_TRAIN_PARAMS = {"hymba-1.5b": 1641579200, "rwkv6-1.6b": 1678264320}


def _ssm_kernel_class(name: str) -> str:
    """The train profile's classes: K2, K3, K3-bwd, K4, K4-bwd, cuBLAS,
    AdamW's foreach kernels, and the rest (elementwise and reductions)."""
    if "multi_tensor_apply" in name or "foreach" in name.lower():
        return "AdamW"
    cls = _kernel_class(name)
    return "elementwise" if cls == "other" else cls


def _leaf_names(tree: dict, prefix: str = "") -> list:
    """Dotted names of a parameter tree's leaves in ``tree_leaves`` order
    (keys sorted)."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        out += (_leaf_names(v, f"{prefix}{k}.") if isinstance(v, dict)
                else [prefix + k])
    return out


def _bf16_held(torch, params: dict, lr: float) -> list:
    """Names of the bf16 leaves that an early AdamW step cannot move: half
    a bf16 ulp at their smallest |entry| is over 10 lr (Adam's first
    steps move an entry by about lr), as for norm weights at 1."""
    from repro_torch.models.transformer import tree_leaves
    out = []
    for name, t in zip(_leaf_names(params), tree_leaves(params)):
        if t.dtype == torch.bfloat16:
            low = float(t.float().abs().min())
            if low > 0 and 2.0 ** (math.floor(math.log2(low)) - 8) > 10 * lr:
                out.append(name)
    return out


def ssm_train(torch, np, FA, SS, WK, counters, arch: str,
              summary: dict) -> tuple:
    """16 (a), (b): ``arch`` at full width and depth (seeded bf16) trained
    by ``make_train_step`` (AdamW, lr 3e-4, weight decay 0.1, no remat) on
    2 x 4096
    tokens: 1 warm-up and 1 step timed by CUDA events; finite losses,
    every leaf moved but those bf16 rounding holds (``_bf16_held``), the
    launches of each kernel; then torch.profiler
    over one more step.  Returns (launches by kernel, layer 0's scan
    arguments of the first batch, kept from an untimed no-grad forward
    before the steps)."""
    from repro_torch.configs import get_full
    from repro_torch.kernels.selective_scan import ops as scan_ops
    from repro_torch.kernels.wkv6 import ops as wkv_ops
    from repro_torch.launch import steps as ST
    from repro_torch.models.transformer import tree_leaves
    cfg = get_full(arch).resolve(1)
    hybrid = cfg.block == "hybrid"
    remat = False                  # as danube: both steps fit (PERF.md)
    n = cfg.n_layers
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = ST.build_model(cfg, remat=remat, device="cuda")
    params = model.init_params(0)
    leaves = tree_leaves(params)
    n_params = sum(t.numel() for t in leaves)
    check(n_params == SSM_TRAIN_PARAMS[arch],
          f"{arch} has {n_params} params")
    opt, step = ST.make_train_step(model, lr=3e-4, weight_decay=0.1)
    state = opt.init(leaves)
    batches = [_lm_batch(torch, np, cfg.vocab, SSM_TRAIN_BATCH,
                         SSM_TRAIN_SEQ, "cuda", seed=i)
               for i in range(1 + SSM_TRAIN_TIMED)]
    with torch.no_grad(), _FirstCall(
            scan_ops if hybrid else wkv_ops,
            "selective_scan" if hybrid else "wkv6") as rec:
        model.forward_loss(params, batches[0]["tokens"],
                           batches[0]["labels"])
    before = [t.to("cpu", copy=True) for t in leaves]
    held = _bf16_held(torch, params, 3e-4)
    scan, grad = ((SS.selective_scan_cuda, SS.selective_scan_grad_cuda)
                  if hybrid else (WK.wkv6_cuda, WK.wkv6_grad_cuda))
    fwd_per_step = n * (2 if remat else 1)  # remat re-runs each layer
    expect = {id(scan): fwd_per_step, id(grad): n}
    if hybrid:
        expect[id(FA.flash_attention_cuda)] = fwd_per_step
        expect[id(FA.flash_attention_bwd_cuda)] = n
    for c in counters:                         # counts of this path only
        c.launches = 0
    losses, times = [], []
    for i, batch in enumerate(batches):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        params, state, metrics = step(params, state, batch)
        t1.record()
        t1.synchronize()
        losses.append(float(metrics["loss"]))
        if i:
            times.append(t0.elapsed_time(t1))
    n_steps = len(batches)
    launches = {type(c).__name__: c.launches for c in counters}
    for c in counters:
        want = expect.get(id(c), 0) * n_steps
        check(c.launches == want, f"{arch} train: {type(c).__name__} "
              f"launched {c.launches} times in {n_steps} steps, not {want}")
    check(all(math.isfinite(x) for x in losses), f"losses {losses}")
    peak = torch.cuda.max_memory_allocated()
    total = torch.cuda.get_device_properties(0).total_memory
    still = [name for name, a, b in zip(_leaf_names(params), before, leaves)
             if torch.equal(a, b.cpu())]
    del before
    moved = len(leaves) - len(still)
    stuck = sorted(set(still) - set(held))
    check(not stuck, f"{arch}: leaves {stuck} did not move")
    step_ms = sorted(times)[len(times) // 2]
    tokens = SSM_TRAIN_BATCH * SSM_TRAIN_SEQ
    out = {"arch": arch, "layers": n, "params": n_params,
           "batch": SSM_TRAIN_BATCH, "seq": SSM_TRAIN_SEQ, "remat": remat,
           "step_ms": times, "median_step_ms": step_ms,
           "tokens_per_s": tokens / (step_ms / 1e3), "losses": losses,
           "peak_memory_bytes": peak, "free_at_peak_bytes": total - peak,
           "leaves_moved": moved, "leaves_held_by_bf16": still,
           "launches": launches,
           "mfu": lm_mfu(cfg, "train", SSM_TRAIN_BATCH, SSM_TRAIN_SEQ,
                         step_ms)}
    log(f"[ssm train] {arch}: {n} layers, {n_params} params, bf16, AdamW "
        f"(lr 3e-4, wd 0.1), {'remat' if remat else 'no remat'}; batch "
        f"{SSM_TRAIN_BATCH} x {SSM_TRAIN_SEQ} tokens")
    log(f"[ssm train] {arch}: step ms {[round(t, 2) for t in times]} "
        f"(median {step_ms:.2f}, mfu {out['mfu']:.3f}, 1 warm-up step "
        "before), "
        f"{out['tokens_per_s']:.0f} tokens/s; losses "
        f"{[round(x, 4) for x in losses]}; peak {peak / 1e9:.2f} GB of "
        f"{total / 1e9:.2f} GB; {moved} of {len(leaves)} leaves moved, the "
        f"rest held by bf16 rounding ({', '.join(still) or 'none'}); "
        "launches a step "
        + ", ".join(f"{type(c).__name__} {expect[id(c)]}" for c in counters
                    if id(c) in expect))
    for c in counters:
        c.launches = 0
    out["profile"] = train_profile(torch, step, params, state, batches[0],
                                   classify=_ssm_kernel_class,
                                   tag=f"ssm train profile {arch}")
    for c in counters:
        want = expect.get(id(c), 0)
        check(c.launches == want, f"{arch} profiled step: "
              f"{type(c).__name__} launched {c.launches} times, not {want}")
        launches[type(c).__name__] += c.launches
    del state, batches, params, leaves, model
    torch.cuda.empty_cache()
    summary.setdefault("ssm_train", {})[arch] = out
    return launches, rec.args


def _grad_checks(torch, names, kernel_runs, plain, ref64, what: str) -> dict:
    """Phase 3b's float64 rule on every gradient of each run in
    ``kernel_runs`` ({name: (run, run again, plain's gradients in the
    run's dtypes)}), and the two runs' bits equal."""
    out = {}
    for name, (a, b, p) in kernel_runs.items():
        e = {g: _f64_errs(k, pp, r)
             for g, k, pp, r in zip(names, a, p, ref64)}
        e["max_abs_vs_plain"] = max(float((k.double() - pp.double()).abs()
                                          .max()) for k, pp in zip(a, p))
        e["same_bits_twice"] = all(bits_equal(torch, x, y)
                                   for x, y in zip(a, b))
        check(e["same_bits_twice"], f"{what} {name}: two runs differ")
        for g in names:
            check(e[g]["share"] <= 1, f"{what} {name} {g}: {e[g]}")
        out[name] = e
        log(f"[ssm grad] {what}, {name} inputs: max |err| vs float64 "
            + ", ".join(f"{g} {e[g]['kernel']:.3g} (limit "
                        f"{e[g]['limit']:.3g})" for g in names)
            + "; two runs bit-equal")
    return out


def _timed(torch, fn, *args):
    """(fn(*args), its CUDA-event ms), one run."""
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    res = fn(*args)
    t1.record()
    t1.synchronize()
    return res, t0.elapsed_time(t1)


def k3_grad_checks(torch, SS, args) -> dict:
    """16 (c): K3-bwd on layer 0's real train inputs (the forward's own
    arguments) and a seeded dy of bf16 values, dhT None as training
    passes it, on the bf16 x and on its float32 values, against the plain
    backward (float32, timed) and its float64 run; each kernel run twice.
    Launches here are put back."""
    from repro_torch.kernels.selective_scan.ref import selective_scan_bwd_plain
    x, dt, Bc, Cc, A, h0 = args
    n0 = (SS.selective_scan_cuda.launches,
          SS.selective_scan_grad_cuda.launches)
    g = torch.Generator(device="cuda").manual_seed(0)
    dy = torch.randn(x.shape, generator=g, device="cuda").to(x.dtype)
    runs = {}
    with torch.no_grad():
        plain, plain_ms = _timed(torch, selective_scan_bwd_plain, x.float(),
                                 dt, Bc, Cc, A, h0, dy.float())
        ref64 = selective_scan_bwd_plain(
            *(t.double() for t in args), dy.double())
        for name, xin in (("float32", x.float()), ("bfloat16", x)):
            dyin = dy.to(xin.dtype)
            _, _, hs = SS.selective_scan_cuda(xin, dt, Bc, Cc, A, h0,
                                              save_states=True)
            a = SS.selective_scan_grad_cuda(xin, dt, Bc, Cc, A, hs, dyin)
            b = SS.selective_scan_grad_cuda(xin, dt, Bc, Cc, A, hs, dyin)
            runs[name] = (a, b, (plain[0].to(xin.dtype),) + plain[1:])
        torch.cuda.synchronize()
    out = _grad_checks(torch, ("dx", "ddt", "dB", "dC", "dA", "dh0"), runs,
                       plain, ref64, f"K3-bwd, x {tuple(x.shape)}")
    out["plain_ms"] = plain_ms
    SS.selective_scan_cuda.launches, SS.selective_scan_grad_cuda.launches = n0
    return out


def k4_grad_checks(torch, WK, args) -> dict:
    """16 (c): K4-bwd as ``k3_grad_checks`` holds K3-bwd: layer 0's real
    train inputs, a seeded float32 dy, dsT None; the bf16 r, k, v and
    their float32 values."""
    from repro_torch.kernels.wkv6.ref import wkv6_bwd_plain
    r, k, v, w, u, s0 = args
    u = u.float()
    n0 = (WK.wkv6_cuda.launches, WK.wkv6_grad_cuda.launches)
    g = torch.Generator(device="cuda").manual_seed(0)
    dy = torch.randn(r.shape, generator=g, device="cuda")
    runs = {}
    with torch.no_grad():
        plain, plain_ms = _timed(torch, wkv6_bwd_plain, r.float(), k.float(),
                                 v.float(), w, u, s0, dy)
        ref64 = wkv6_bwd_plain(*(t.double() for t in (r, k, v, w, u, s0)),
                               dy.double())
        for name, dt in (("float32", torch.float32),
                         ("bfloat16", torch.bfloat16)):
            rkv = [t.to(dt) for t in (r, k, v)]
            _, _, hs = WK.wkv6_cuda(*rkv, w, u, s0, save_states=True)
            a = WK.wkv6_grad_cuda(*rkv, w, u, hs, dy)
            b = WK.wkv6_grad_cuda(*rkv, w, u, hs, dy)
            runs[name] = (a, b, tuple(p.to(dt) for p in plain[:3])
                          + plain[3:])
        torch.cuda.synchronize()
    out = _grad_checks(torch, ("dr", "dk", "dv", "dw", "du", "ds0"), runs,
                       plain, ref64, f"K4-bwd, r {tuple(r.shape)}")
    out["plain_ms"] = plain_ms
    WK.wkv6_cuda.launches, WK.wkv6_grad_cuda.launches = n0
    return out


def ssm_train_cross_device(torch, np, counters, summary: dict) -> dict:
    """16 (d): hymba-1.5b and rwkv6-1.6b at SMOKE, seeded, float32: one
    ``make_grad_fn`` step on the card (K2, K3 / K4 and their backward)
    and on the CPU (plain autograd) on 2 x 80 tokens: the loss within
    1e-5 relative, every gradient leaf within 1e-4 of its largest
    entry."""
    from repro_torch.configs import get_smoke
    from repro_torch.launch import steps as ST
    from repro_torch.models.transformer import map_params
    for c in counters:                         # counts of this path only
        c.launches = 0
    out = {}
    for arch in ("hymba-1.5b", "rwkv6-1.6b"):
        cfg = get_smoke(arch).resolve(1)
        gpu = ST.build_model(cfg, remat=False, dtype=torch.float32,
                             device="cuda")
        cpu = ST.build_model(cfg, remat=False, dtype=torch.float32,
                             device="cpu")
        params = gpu.init_params(0)
        cparams = map_params(lambda t: t.cpu().clone(), params)
        batch = _lm_batch(torch, np, cfg.vocab, 2, SSM_CROSS_SEQ, "cuda")
        g, loss, _ = ST.make_grad_fn(gpu)(params, batch)
        cg, closs, _ = ST.make_grad_fn(cpu)(
            cparams, {k: v.cpu() for k, v in batch.items()})
        loss_err = abs(float(loss) - float(closs)) / abs(float(closs))
        grad_err = max(_max_rel(torch, a.cpu(), b) for a, b in zip(g, cg))
        check(loss_err <= 1e-5, f"{arch}: loss cuda {float(loss)} cpu "
              f"{float(closs)}")
        check(grad_err <= 1e-4, f"{arch}: gradients cuda vs cpu {grad_err}")
        out[arch] = {"loss": [float(loss), float(closs)],
                     "loss_rel_err": loss_err, "grad_max_rel_err": grad_err}
        log(f"[ssm train cross] {arch} SMOKE, float32, 2 x {SSM_CROSS_SEQ} "
            f"tokens: cuda == cpu, loss rel err {loss_err:.3g} (limit "
            f"1e-5), gradients max |err| / max |g| {grad_err:.3g} (limit "
            "1e-4)")
    launches = {type(c).__name__: c.launches for c in counters}
    summary["ssm_train_cross_device"] = out
    return launches


def _spills(library, needle: str) -> str:
    """ptxas's spill line for the kernel instance whose name holds
    ``needle``."""
    for name, spill, _ in ptxas_functions(library.build_log):
        if needle in name:
            return spill
    return "not reported"


def scan_grad_yardstick(torch, kernel, args, occupancy, *, name: str,
                        source: str, replaces: str, spills: str,
                        nbytes: int, ops: int, exps: int, err: float,
                        plain_ms: float, train_launch_ms: dict,
                        summary: dict) -> dict:
    """16 (e): a backward kernel's median of 10 after 2 warm-ups at the
    train shape (its two launches, as the caller sees them) beside the
    bound (the largest of the bytes, the float32 operations and the
    exponentials at the SFU's rate); the main and the finish kernel apart
    (device ms a launch in the profiled train step, ``train_launch_ms``);
    its cluster size, resident clusters and waves, registers, resident
    warps, shared memory and spills; the plain backward's time from (c).
    Fails if it takes 3/4 of its first design's time or more."""
    from repro_torch.profiling.microbench import median_time_ms
    n0 = kernel.launches
    with torch.no_grad():
        ms = median_time_ms(kernel, args, warmup=2, repeats=10)
    kernel.launches = n0
    main_ms = train_launch_ms.get(f"{name}_kernel")
    finish_ms = train_launch_ms.get(f"{name}_finish_kernel")
    apart = ("main + finish kernel a launch in the profiled train step "
             + (f"{main_ms:.3f} + {finish_ms:.3f} ms"
                if main_ms is not None and finish_ms is not None
                else "not measured"))
    terms = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
             "float32 operations": ops / F32_FLOP_PER_S * 1e3,
             "exp (SFU)": exps / SFU_EXP_PER_S * 1e3}
    term = max(terms, key=terms.get)
    row = {"name": name, "route": "cuda", "source": source,
           "replaces": replaces, "max_abs_err": err, "ms": ms,
           "plain_ms": plain_ms, "bound_ms": terms[term],
           "bound_by": "bytes" if term == "bytes" else "operations",
           "bound_term": term, "library_ms": None,
           "main_ms": main_ms, "finish_ms": finish_ms,
           "cluster_size": occupancy["cluster_size"],
           "active_clusters": occupancy["active_clusters"],
           "waves": occupancy["waves"],
           "registers": occupancy["registers"],
           "warps_per_sm": occupancy["warps_per_sm"],
           "smem_bytes": occupancy["smem_bytes"], "spills": spills,
           "first_design_ms": SSM_GRAD_FIRST_MS[name]}
    summary.setdefault("ssm_grad_yardstick", {})[name] = {
        "bytes": nbytes, "ops": ops, "exps": exps, "bound_terms_ms": terms,
        "bound_share": row["bound_ms"] / ms, "occupancy": occupancy, **row}
    log(f"[ssm grad yardstick] {name}: {ms:.3f} ms ({row['bound_ms'] / ms:.1%}"
        f" of the bound {row['bound_ms']:.3f} ms, {term}: {nbytes / 1e9:.3f} "
        f"GB {terms['bytes']:.3f} ms, {ops / 1e9:.2f} G float32 ops "
        f"{terms['float32 operations']:.3f} ms, {exps / 1e9:.3f} G exp "
        f"{terms['exp (SFU)']:.3f} ms); {apart}; first design "
        f"{SSM_GRAD_FIRST_MS[name]} ms; plain backward {plain_ms:.1f} ms "
        f"(one run); clusters of {occupancy['cluster_size']}, "
        f"{occupancy['active_clusters']} resident, "
        f"{occupancy['clusters']} in the grid ({occupancy['waves']:.2f} "
        f"waves); {occupancy['registers']} registers, "
        f"{occupancy['warps_per_sm']} warps an SM, "
        f"{occupancy['smem_bytes']} bytes of shared memory a block, {spills};"
        " no single PyTorch call computes it (library: none)")
    check(ms < 0.75 * SSM_GRAD_FIRST_MS[name],
          f"{name}: {ms:.3f} ms is not below 3/4 of the first design's "
          f"{SSM_GRAD_FIRST_MS[name]} ms")
    return row


def phase_ssm_train(torch, np, FA, SS, WK, counters, summary: dict) -> dict:
    """Training the hybrid SSM and RWKV blocks.  Returns each kernel's
    launches by path (``"k2"``, ``"k3"``, ``"k3_bwd"``, ``"k4"``,
    ``"k4_bwd"``) and K3-bwd's and K4-bwd's rows.  Each leg prints its
    seconds."""
    legs = dict.fromkeys(("a hymba train", "b rwkv train",
                          "c kernel checks", "d cuda vs cpu",
                          "e yardsticks"), 0.0)
    names = {k: type(c).__name__ for k, c in (
        ("k2", FA.flash_attention_cuda), ("k3", SS.selective_scan_cuda),
        ("k3_bwd", SS.selective_scan_grad_cuda), ("k4", WK.wkv6_cuda),
        ("k4_bwd", WK.wkv6_grad_cuda))}
    paths = {k: {} for k in names}
    rows, checks = {}, {}

    t0 = time.perf_counter()
    launches, args = ssm_train(torch, np, FA, SS, WK, counters,
                               "hymba-1.5b", summary)
    for key in ("k2", "k3", "k3_bwd"):
        paths[key]["hybrid train"] = launches[names[key]]
    k2_bwd_record(summary, "hybrid train",
                  launches[type(FA.flash_attention_bwd_cuda).__name__])
    legs["a hymba train"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    checks["k3_bwd"] = k3_grad_checks(torch, SS, args)
    legs["c kernel checks"] += time.perf_counter() - t0
    t0 = time.perf_counter()
    x, dt, Bc, Cc, A, h0 = args
    B, S, Di = x.shape
    N = A.shape[1]
    with torch.no_grad():
        _, _, hs = SS.selective_scan_cuda(*args, save_states=True)
    SS.selective_scan_cuda.launches -= 1
    dy = torch.randn_like(x.float()).to(x.dtype)
    n_el = B * S * Di
    rows["k3_bwd"] = scan_grad_yardstick(
        torch, SS.selective_scan_grad_cuda, (x, dt, Bc, Cc, A, hs, dy),
        SS.selective_scan_grad_cuda.occupancy(x.dtype, N, shape=x.shape),
        name="selective_scan_bwd",
        source="src/repro_torch/csrc/selective_scan.cu",
        replaces="src/repro/models/ssm.py:55 (JAX's autodiff transpose of "
                 "_ssm_recurrence's lax.scan; no Pallas kernel)",
        spills=_spills(SS.LIBRARY, "selective_scan_bwd_kernelI13__nv_"
                                   f"bfloat16Li{N}E"),
        # read x, dy (bf16), dt, the saved states, B, C, A; write dx
        # (bf16), ddt, dB, dC, dA, dh0
        nbytes=(n_el * (2 * x.element_size() + 4 + x.element_size() + 4)
                + hs.numel() * 4 + 4 * (Bc.numel() + Cc.numel()) * 2
                + 4 * A.numel() * 2 + 4 * h0.numel()),
        # 18 a (b, t, d, n): 3 to recompute h, 11 on the walk back, the
        # sums over n (du, z A) and over channels (g u, dy h)
        ops=18 * n_el * N, exps=n_el * N,
        err=checks["k3_bwd"]["float32"]["max_abs_vs_plain"],
        plain_ms=checks["k3_bwd"]["plain_ms"],
        train_launch_ms=summary["ssm_train"]["hymba-1.5b"]["profile"][
            "ms_a_launch"], summary=summary)
    del args, x, dt, Bc, Cc, A, h0, hs, dy
    torch.cuda.empty_cache()
    legs["e yardsticks"] += time.perf_counter() - t0

    t0 = time.perf_counter()
    launches, args = ssm_train(torch, np, FA, SS, WK, counters,
                               "rwkv6-1.6b", summary)
    for key in ("k4", "k4_bwd"):
        paths[key]["rwkv train"] = launches[names[key]]
    legs["b rwkv train"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    checks["k4_bwd"] = k4_grad_checks(torch, WK, args)
    legs["c kernel checks"] += time.perf_counter() - t0
    t0 = time.perf_counter()
    r, k, v, w, u, s0 = args
    u = u.float()
    B, S, H, hd = r.shape
    with torch.no_grad():
        _, _, hs = WK.wkv6_cuda(r, k, v, w, u, s0, save_states=True)
    WK.wkv6_cuda.launches -= 1
    dy = torch.randn(r.shape, device="cuda")
    n_el = B * S * H * hd
    rows["k4_bwd"] = scan_grad_yardstick(
        torch, WK.wkv6_grad_cuda, (r, k, v, w, u, hs, dy),
        WK.wkv6_grad_cuda.occupancy(r.dtype, shape=r.shape),
        name="wkv6_bwd",
        source="src/repro_torch/csrc/wkv6.cu",
        replaces="src/repro/models/ssm.py:151 (JAX's autodiff transpose of "
                 "rwkv_time_mix's lax.scan; no Pallas kernel)",
        spills=_spills(WK.LIBRARY, "wkv6_bwd_kernelI13__nv_bfloat16E"),
        # read r, k, v (bf16), w, dy, the saved states, u; write dr, dk,
        # dv (bf16), dw, du, ds0
        nbytes=(n_el * (3 * r.element_size() + 8 + 3 * r.element_size()
                        + 4) + hs.numel() * 4 + 2 * u.numel() * 4
                + s0.numel() * 4),
        # 14 a state element and step: 3 to recompute s, then dy s, G s,
        # G v, G k each a product and a sum, and G's update (3)
        ops=14 * n_el * hd, exps=0,
        err=checks["k4_bwd"]["float32"]["max_abs_vs_plain"],
        plain_ms=checks["k4_bwd"]["plain_ms"],
        train_launch_ms=summary["ssm_train"]["rwkv6-1.6b"]["profile"][
            "ms_a_launch"], summary=summary)
    del args, r, k, v, w, u, s0, hs, dy
    torch.cuda.empty_cache()
    legs["e yardsticks"] += time.perf_counter() - t0

    t0 = time.perf_counter()
    launches = ssm_train_cross_device(torch, np, counters, summary)
    for key in paths:
        paths[key]["ssm train cuda vs cpu"] = launches[names[key]]
    k2_bwd_record(summary, "ssm train cuda vs cpu",
                  launches[type(FA.flash_attention_bwd_cuda).__name__])
    legs["d cuda vs cpu"] = time.perf_counter() - t0
    summary["ssm_grad_checks"] = checks
    for name, secs in legs.items():
        log(f"[ssm train] leg {name}: {secs:.1f} s")
    summary["ssm_train_legs_s"] = legs
    return {"paths": paths, "rows": rows}


# phase 17: the VLM and audio frontends (stub embeddings before the tokens)

AUDIO_ARCH = "musicgen-large"
VLM_ARCH = "llava-next-34b"
AUDIO_SERVE_PROMPT = 8192        # 17 (a): danube's shape, 256 frames + 7936
VLM_SERVE_BATCH = 2              # 17 (b): 2304 patch embeddings + 1792
VLM_SERVE_PROMPT = 4096          # tokens a prompt, 8 tokens decoded
VLM_SERVE_TOKENS = 8
FRONTEND_TRAIN_BATCH = 2         # train_4k's sequence, its batch cut from
FRONTEND_TRAIN_SEQ = 4096        # 256 to 2 (frames included)
AUDIO_TRAIN_TIMED = 1            # after 1 warm-up step
VLM_TRAIN_LAYERS = 2             # 17 (b): 60 layers cut to 2, as dbrx-132b
VLM_TRAIN_TIMED = 1              # after 1 warm-up step
FRONTEND_CROSS_TOKENS = 48       # 17 (d): SMOKE, float32, 16 frames + 48
FRONTEND_CROSS_DECODE = 8


def _n_params_check(cfg, params) -> int:
    """The tree's size: ``param_count()`` (exact for these archs) plus the
    norms (ln1, ln2 a layer and the final one)."""
    from repro_torch.models.transformer import tree_leaves
    n = sum(t.numel() for t in tree_leaves(params))
    want = cfg.param_count() + (2 * cfg.n_layers + 1) * cfg.d_model
    check(n == want, f"{cfg.name} has {n} params, not {want}")
    return n


def frontend_serve(torch, FA, counters, arch: str, batch: int,
                   prompt_len: int, n_tokens: int, summary: dict):
    """17 (a), (b): ``arch`` at full width and depth (seeded bf16) served
    through ``launch.serve.serve``: ``batch`` prompts of ``prompt_len``
    positions (``n_frontend_tokens`` seeded stub embeddings, then tokens)
    and ``n_tokens`` greedy tokens; then torch.profiler over one more
    prefill (kernel ms by class, idle share).  Returns the result and K2's
    launches (the warm-up, timed and profiled prefills)."""
    from repro_torch.launch.serve import serve
    for c in counters:                         # counts of this path only
        c.launches = 0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    res = serve(arch, batch=batch, prompt_len=prompt_len, tokens=n_tokens,
                size="full", device="cuda")
    wall = time.perf_counter() - t0
    cfg = res.cfg
    nf = cfg.n_frontend_tokens
    launches = FA.flash_attention_cuda.launches
    check(launches == 2 * cfg.n_layers,
          f"{cfg.name}: K2 launched {launches} times in 2 prefills of "
          f"{cfg.n_layers} layers")
    check_idle(counters, (FA.flash_attention_cuda,),
               f"the {cfg.name} serve path")
    check(res.embeds is not None and tuple(res.embeds.shape) == (
        batch, nf, cfg.d_model) and res.embeds.dtype == torch.bfloat16,
          f"{cfg.name}: stub embeds {getattr(res.embeds, 'shape', None)}")
    check(tuple(res.prompts.shape) == (batch, prompt_len - nf),
          f"{cfg.name}: prompt tokens {tuple(res.prompts.shape)}")
    check(bool(torch.isfinite(res.last_logits.float()).all()),
          f"{cfg.name}: finite logits")
    check(res.tokens.shape == (batch, n_tokens), "token shape")
    check(bool(((res.tokens >= 0) & (res.tokens < cfg.vocab_padded)).all()),
          "token ids in range")
    check(res.pos == prompt_len + n_tokens - 1,
          f"{cfg.name}: cache position {res.pos} does not count the frames")
    n_params = _n_params_check(cfg, res.params)
    mfu = serve_mfu(res)
    total = torch.cuda.get_device_properties(0).total_memory
    out = {"arch": cfg.name, "layers": cfg.n_layers, "params": n_params,
           "batch": batch, "prompt": prompt_len, "frames": nf,
           "tokens": n_tokens, "prefill_ms": res.prefill_ms,
           "decode_ms_per_token": res.decode_ms_per_token,
           "decode_tokens_per_s": res.decode_tokens_per_s,
           "peak_memory_bytes": res.peak_memory_bytes,
           "free_at_peak_bytes": total - res.peak_memory_bytes,
           "wall_s": wall, "mfu": mfu}
    log(f"[frontend serve] {cfg.name} ({cfg.frontend}): {cfg.n_layers} "
        f"layers, {n_params} params, bf16; batch {batch} x {prompt_len} "
        f"positions ({nf} stub embeddings + {prompt_len - nf} tokens), "
        f"{n_tokens} tokens")
    log(f"[frontend serve] {cfg.name}: prefill {res.prefill_ms:.1f} ms (mfu "
        f"{mfu['prefill']:.3f}); decode {res.decode_ms_per_token:.2f} "
        f"ms/token (mfu {mfu['decode']:.5f}), "
        f"{res.decode_tokens_per_s:.1f} tokens/s; peak "
        f"{res.peak_memory_bytes / 1e9:.2f} GB of {total / 1e9:.2f} GB; K2 "
        f"{launches} launches; wall {wall:.1f} s; request 0: "
        f"{res.tokens[0, :8].tolist()} ...")
    n0 = FA.flash_attention_cuda.launches
    out["profile"] = phase_profile(torch, res, summary,
                                   key=f"frontend_profile {cfg.name}",
                                   decode_window=False)
    profiled = FA.flash_attention_cuda.launches - n0
    check(profiled == cfg.n_layers, f"{cfg.name}: K2 launched {profiled} "
          "times in the profiled prefill")
    check_idle(counters, (FA.flash_attention_cuda,),
               f"the {cfg.name} serve path")
    summary.setdefault("frontend_serve", {})[cfg.name] = out
    torch.cuda.empty_cache()
    return res, launches + profiled


def _frontend_batch(torch, stream, step: int, dtype) -> dict:
    """``LMBatchStream``'s batch ``step`` on the card, the embeds in the
    model's dtype."""
    b = stream.batch_at(step)
    out = {k: torch.as_tensor(v, device="cuda") for k, v in b.items()}
    if "embeds" in out:
        out["embeds"] = out["embeds"].to(dtype)
    return out


def frontend_train(torch, FA, counters, cfg, params, n_timed: int,
                   summary: dict) -> int:
    """17 (a), (b): ``cfg`` (bf16, ``params`` or seeded ones) trained by
    ``make_train_step`` (AdamW, lr 3e-4, weight decay 0.1, no remat) on
    ``LMBatchStream``'s batches of 2 x 4096 positions (the frames' labels
    masked): 1 warm-up and ``n_timed`` steps timed by CUDA events, then
    torch.profiler over one more.  Returns K2's launches."""
    from repro_torch.data.pipeline import LMBatchStream
    from repro_torch.launch import steps as ST
    from repro_torch.models.transformer import tree_leaves
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = ST.build_model(cfg, remat=False, device="cuda")
    if params is None:
        params = model.init_params(0)
    n_params = _n_params_check(cfg, params)
    opt, step = ST.make_train_step(model, lr=3e-4, weight_decay=0.1)
    state = opt.init(tree_leaves(params))
    nf = cfg.n_frontend_tokens
    stream = LMBatchStream(cfg.vocab, FRONTEND_TRAIN_BATCH,
                           FRONTEND_TRAIN_SEQ, n_frontend_tokens=nf,
                           d_model=cfg.d_model, seed=0)
    batches = [_frontend_batch(torch, stream, i, model.dtype)
               for i in range(1 + n_timed)]
    check(tuple(batches[0]["embeds"].shape) == (
        FRONTEND_TRAIN_BATCH, nf, cfg.d_model)
          and tuple(batches[0]["tokens"].shape) == (
        FRONTEND_TRAIN_BATCH, FRONTEND_TRAIN_SEQ - nf), "the batch's shape")
    qkv = _layer0_qkv(torch, cfg, params, batches[0]["tokens"],
                      batches[0]["embeds"])
    for c in counters:                         # counts of this path only
        c.launches = 0
    losses, times = [], []
    for i, batch in enumerate(batches):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        params, state, metrics = step(params, state, batch)
        t1.record()
        t1.synchronize()
        losses.append(float(metrics["loss"]))
        if i:
            times.append(t0.elapsed_time(t1))
    launches = FA.flash_attention_cuda.launches
    n_steps = len(batches)
    check(launches == cfg.n_layers * n_steps,
          f"{cfg.name}: K2 launched {launches} times in {n_steps} steps of "
          f"{cfg.n_layers} layers")
    check(FA.flash_attention_bwd_cuda.launches == cfg.n_layers * n_steps,
          f"{cfg.name}: K2-bwd launched {FA.flash_attention_bwd_cuda.launches}"
          f" times in {n_steps} steps")
    k2_bwd_record(summary, f"frontend train {cfg.name}",
                  FA.flash_attention_bwd_cuda.launches)
    check_idle(counters, (FA.flash_attention_cuda,
                          FA.flash_attention_bwd_cuda),
               f"the {cfg.name} train path")
    check(all(math.isfinite(x) for x in losses), f"losses {losses}")
    peak = torch.cuda.max_memory_allocated()
    total = torch.cuda.get_device_properties(0).total_memory
    step_ms = sorted(times)[len(times) // 2]
    mfu = lm_mfu(cfg, "train", FRONTEND_TRAIN_BATCH, FRONTEND_TRAIN_SEQ,
                 step_ms)
    out = {"arch": cfg.name, "layers": cfg.n_layers, "params": n_params,
           "batch": FRONTEND_TRAIN_BATCH, "seq": FRONTEND_TRAIN_SEQ,
           "frames": nf, "remat": False, "step_ms": times,
           "median_step_ms": step_ms,
           "tokens_per_s": FRONTEND_TRAIN_BATCH * FRONTEND_TRAIN_SEQ
           / (step_ms / 1e3), "mfu": mfu, "losses": losses,
           "peak_memory_bytes": peak, "free_at_peak_bytes": total - peak,
           "k2_launches_per_step": launches // n_steps}
    log(f"[frontend train] {cfg.name}: {cfg.n_layers} layers, {n_params} "
        f"params, bf16, AdamW (lr 3e-4, wd 0.1), no remat; batch "
        f"{FRONTEND_TRAIN_BATCH} x {FRONTEND_TRAIN_SEQ} positions ({nf} "
        "stub embeddings, labels masked there, then tokens: LMBatchStream)")
    log(f"[frontend train] {cfg.name}: step ms "
        f"{[round(t, 2) for t in times]} (median {step_ms:.2f}, mfu "
        f"{mfu:.3f}, 1 warm-up step before), {out['tokens_per_s']:.0f} "
        f"positions/s; losses {[round(x, 4) for x in losses]}; peak "
        f"{peak / 1e9:.2f} GB of {total / 1e9:.2f} GB; K2 "
        f"{launches // n_steps} launches a step")
    for c in counters:
        c.launches = 0
    out["profile"] = train_profile(torch, step, params, state, batches[0],
                                   tag=f"frontend train profile {cfg.name}",
                                   host=False)
    check(FA.flash_attention_cuda.launches == cfg.n_layers
          and FA.flash_attention_bwd_cuda.launches == cfg.n_layers,
          f"{cfg.name}: K2 and K2-bwd launches in the profiled step")
    launches += FA.flash_attention_cuda.launches
    k2_bwd_record(summary, f"frontend train {cfg.name}",
                  FA.flash_attention_bwd_cuda.launches)
    del state, batches, params
    torch.cuda.empty_cache()
    # the attention backward (K2-bwd) alone, by CUDA events on layer 0's
    # q/k/v; its launches are not counted
    bwd_ms = attention_backward_ms(torch, FA, *qkv, cfg.sliding_window,
                                   model.q_chunk)
    out["attention_backward_ms_per_layer"] = bwd_ms
    out["attention_backward_share"] = bwd_ms * cfg.n_layers / step_ms
    log(f"[frontend train] {cfg.name}: the attention backward alone (layer "
        f"0's q/k/v, CUDA events): {bwd_ms:.2f} ms a layer, "
        f"{bwd_ms * cfg.n_layers:.1f} ms a step, "
        f"{out['attention_backward_share']:.3f} of the median step")
    del qkv, model
    torch.cuda.empty_cache()
    summary.setdefault("frontend_train", {})[cfg.name] = out
    return launches


def frontend_cross_device(torch, np, FA, counters, summary: dict) -> int:
    """17 (d): llava-next-34b and musicgen-large at SMOKE, seeded, float32,
    on the card (K2) and on the CPU (plain), given the same seeded embeds
    (16 frames) and 48 tokens: the prefill logits and those of 7 greedy
    decode steps within 1e-4, the tokens equal, and one ``make_grad_fn``
    step's loss (1e-5 relative) and gradients (1e-4 of each leaf's
    largest), the labels over the whole stream and the frames masked."""
    from repro_torch.configs import get_smoke
    from repro_torch.launch import steps as ST
    from repro_torch.models.transformer import map_params
    for c in counters:                         # counts of this path only
        c.launches = 0
    out = {}
    for arch in (VLM_ARCH, AUDIO_ARCH):
        cfg = get_smoke(arch).resolve(1)
        nf, S = cfg.n_frontend_tokens, FRONTEND_CROSS_TOKENS
        rng = np.random.default_rng(0)
        host = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab, (2, S)),
                                          dtype=torch.int32),
                "embeds": torch.as_tensor(
                    rng.normal(0, 0.02, (2, nf, cfg.d_model)),
                    dtype=torch.float32),
                "labels": torch.as_tensor(
                    rng.integers(0, cfg.vocab, (2, nf + S)),
                    dtype=torch.int32),
                "loss_mask": torch.cat([torch.zeros((2, nf)),
                                        torch.ones((2, S))], dim=1)}
        runs, params = [], None
        for dev in ("cuda", "cpu"):
            model = ST.build_model(cfg, remat=False, dtype=torch.float32,
                                   device=dev)
            params = model.init_params(0) if params is None else map_params(
                lambda t: t.cpu().clone(), params)
            b = {k: v.to(dev) for k, v in host.items()}
            logits, cache = model.prefill(
                params, b["tokens"], b["embeds"],
                capacity=nf + S + FRONTEND_CROSS_DECODE)
            check(cache["pos"] == nf + S, f"{arch}: cache position")
            tok = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)
            lgs, toks = [logits.cpu()], [tok.cpu()]
            for _ in range(FRONTEND_CROSS_DECODE - 1):
                logits, cache = model.decode_step(params, cache, tok)
                tok = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)
                lgs.append(logits.cpu())
                toks.append(tok.cpu())
            g, loss, _ = ST.make_grad_fn(model)(params, b)
            runs.append({"logits": lgs, "tokens": torch.cat(toks, 1),
                         "loss": float(loss), "g": [t.cpu() for t in g]})
        gpu, cpu = runs
        err = max(float((a - c).abs().max())
                  for a, c in zip(gpu["logits"], cpu["logits"]))
        loss_err = abs(gpu["loss"] - cpu["loss"]) / abs(cpu["loss"])
        grad_err = max(_max_rel(torch, a, c)
                       for a, c in zip(gpu["g"], cpu["g"]))
        check(err <= 1e-4, f"{arch}: logits cuda vs cpu {err}")
        check(torch.equal(gpu["tokens"], cpu["tokens"]),
              f"{arch}: greedy tokens {gpu['tokens'].tolist()} vs "
              f"{cpu['tokens'].tolist()}")
        check(loss_err <= 1e-5 and grad_err <= 1e-4,
              f"{arch}: loss cuda vs cpu {loss_err}, gradients {grad_err}")
        out[arch] = {"logits_max_abs_err": err, "loss_rel_err": loss_err,
                     "grad_max_rel_err": grad_err,
                     "tokens": gpu["tokens"].tolist()}
        log(f"[frontend cross] {arch} SMOKE, float32, 2 x ({nf} stub "
            f"embeddings + {S} tokens) + {FRONTEND_CROSS_DECODE} tokens: "
            f"cuda (K2) == cpu (plain): prefill and decode logits max |err| "
            f"{err:.3g} (limit 1e-4), greedy tokens equal "
            f"{gpu['tokens'][0].tolist()}; a make_grad_fn step's loss rel "
            f"err {loss_err:.3g} (limit 1e-5), gradients max |err| / max |g| "
            f"{grad_err:.3g} (limit 1e-4)")
    launches = FA.flash_attention_cuda.launches
    check(launches == 2 * 2 * 2, f"K2 launched {launches} times (a prefill "
          "and a forward of 2 layers an arch)")
    k2_bwd_record(summary, "frontend cuda vs cpu",
                  FA.flash_attention_bwd_cuda.launches)
    check_idle(counters, (FA.flash_attention_cuda,
                          FA.flash_attention_bwd_cuda),
               "the frontends' cuda vs cpu")
    summary["frontend_cross_device"] = out
    return launches


def phase_frontends(torch, np, FA, plain, counters, summary: dict) -> dict:
    """The VLM and audio frontends.  Returns K2's launches by path.  Each
    leg prints its seconds."""
    from repro_torch.configs import get_full
    legs = dict.fromkeys(("a musicgen serve", "a musicgen train",
                          "b llava serve", "b llava train",
                          "c K2 checks", "d cuda vs cpu"), 0.0)
    paths, checks = {}, {}

    t0 = time.perf_counter()
    res, paths["frontend serve musicgen"] = frontend_serve(
        torch, FA, counters, AUDIO_ARCH, 2, AUDIO_SERVE_PROMPT,
        SERVE_TOKENS, summary)
    legs["a musicgen serve"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    checks[AUDIO_ARCH] = k2_train_forward_check(
        torch, FA, plain, *_layer0_qkv(torch, res.cfg, res.params,
                                       res.prompts, res.embeds),
        res.cfg.sliding_window, "musicgen-large layer 0 of the served "
        "prompts (hd 64, group 1)")
    torch.cuda.empty_cache()
    legs["c K2 checks"] += time.perf_counter() - t0
    t0 = time.perf_counter()
    cfg, params = res.cfg, res.params
    del res
    paths["frontend train musicgen"] = frontend_train(
        torch, FA, counters, cfg, params, AUDIO_TRAIN_TIMED, summary)
    del params
    legs["a musicgen train"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    res, paths["frontend serve llava"] = frontend_serve(
        torch, FA, counters, VLM_ARCH, VLM_SERVE_BATCH, VLM_SERVE_PROMPT,
        VLM_SERVE_TOKENS, summary)
    legs["b llava serve"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    qkv = _layer0_qkv(torch, res.cfg, res.params, res.prompts, res.embeds)
    window = res.cfg.sliding_window
    del res                       # the plain check needs the weights' room
    torch.cuda.empty_cache()
    checks[VLM_ARCH] = k2_train_forward_check(
        torch, FA, plain, *qkv, window, "llava-next-34b layer 0 of the "
        "served prompts (hd 128, group 7)")
    del qkv
    torch.cuda.empty_cache()
    legs["c K2 checks"] += time.perf_counter() - t0
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_full(VLM_ARCH),
                              n_layers=VLM_TRAIN_LAYERS).resolve(1)
    paths["frontend train llava"] = frontend_train(
        torch, FA, counters, cfg, None, VLM_TRAIN_TIMED, summary)
    legs["b llava train"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    paths["frontend cuda vs cpu"] = frontend_cross_device(
        torch, np, FA, counters, summary)
    legs["d cuda vs cpu"] = time.perf_counter() - t0
    summary["frontend_k2_checks"] = checks
    for name, secs in legs.items():
        log(f"[frontend] leg {name}: {secs:.1f} s")
    summary["frontend_legs_s"] = legs
    return paths


SHARD_TP = 16                    # 18: the dry-run's resolve(16)
SHARD_SERVE_PROMPT = 8192        # 18 (a), (c), (e): phase 15's serve shape
SHARD_DECODE = 3                 # 18 (a), (c), (e): greedy steps after a
                                 # prefill (the first one untimed:
                                 # DTensor's first propagation of the
                                 # decode's shapes)
SHARD_LAYERS = 2                 # 18 (b), (c), (f): full width, 2 layers
SHARD_TRAIN_BATCH = 2            # 18 (b): phase 16's batch
SHARD_TRAIN_SEQ = 4096
SHARD_TRAIN_TIMED = 2            # 18 (b), (f): after 1 warm-up step
SHARD_MOE_GRAD_STEPS = 2         # 18 (f): every leaf, bf16 steps at its top
SHARD_DEVICE = "cuda"
SHARD_BACKEND = "nccl"           # NCCL takes one rank a card


def _full(t):
    """A DTensor's whole value (on a one-rank mesh its local tensor)."""
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def _shard_cfg(arch: str, n_layers: int | None):
    from repro_torch.configs import get_full
    cfg = get_full(arch)
    if n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    return cfg.resolve(SHARD_TP)


def _events(torch):
    return (torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))


class _CallCounter:
    """While active, counts the calls of ``module.name`` (the call itself
    still runs; unlike ``_FirstCall`` it keeps no argument alive, which
    would raise the peak it is read beside)."""

    def __init__(self, module, name: str):
        self.module, self.name, self.calls = module, name, 0

    def __enter__(self):
        self.fn = getattr(self.module, self.name)

        def count(*args, **kwargs):
            self.calls += 1
            return self.fn(*args, **kwargs)
        setattr(self.module, self.name, count)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)


def shard_serve(torch, np, FA, SS, WK, counters, mesh, rules, arch: str,
                n_layers: int | None, summary: dict) -> dict:
    """18 (a), (c), (e): ``arch`` at ``resolve(16)`` (full width;
    ``n_layers`` cuts its depth) under ``rules`` on ``mesh``, served
    through ``make_prefill_step`` / ``make_decode_step``: an untimed
    prefill, a timed one of 2 x ``SHARD_SERVE_PROMPT`` tokens and
    ``SHARD_DECODE`` greedy steps (the median of all but the first),
    every count from zero, the cache placed by ``cache_specs``; then the
    same weights and prompts with ``NO_SHARDING`` (not counted).  Logits
    and greedy tokens bit-equal: a one-rank mesh runs the same local ops.
    With experts, every MoE layer of every call sends its rows to the
    experts and back by two ``all_to_all_single`` over the model group,
    counted, and the untimed prefill records each layer's dropped-slot
    share.  Returns the launches under the rules and layer 0's kernel
    arguments of the first prefill."""
    import contextlib
    import torch.distributed as dist
    from repro_torch.kernels.selective_scan import ops as scan_ops
    from repro_torch.kernels.wkv6 import ops as wkv_ops
    from repro_torch.launch import steps as ST
    from repro_torch.models import layers as L
    from repro_torch.models.sharding import placements
    from repro_torch.models.transformer import map_params
    cfg = _shard_cfg(arch, n_layers)
    n, B, P, T = cfg.n_layers, 2, SHARD_SERVE_PROMPT, SHARD_DECODE
    attn = cfg.block in ("attn", "hybrid")
    scan_mod, scan_name, scan_kernel = {
        "hybrid": (scan_ops, "selective_scan", SS.selective_scan_cuda),
        "rwkv": (wkv_ops, "wkv6", WK.wkv6_cuda)}.get(cfg.block,
                                                    (None, None, None))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()     # what the leg starts with
    plain = ST.build_model(cfg, device=SHARD_DEVICE)
    model = ST.build_model(cfg, rules=rules, device=SHARD_DEVICE)
    params = plain.init_params(0)
    sharded = model.shard_params(map_params(lambda t: t, params), mesh)
    rng = np.random.default_rng(0)
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab, (B, P)),
                              dtype=torch.int32, device=SHARD_DEVICE)
    k2 = _FirstCall(L, "flash_attention")
    scan = (_FirstCall(scan_mod, scan_name) if scan_mod
            else contextlib.nullcontext())
    routes = _RouteRecorder() if cfg.moe else contextlib.nullcontext()

    def serve(m, p, warm: bool):
        prefill = ST.make_prefill_step(m, capacity=P + T)
        decode = ST.make_decode_step(m)
        if warm:
            with k2, scan, routes:
                prefill(p, {"tokens": prompts})
        t0, t1 = _events(torch)
        t0.record()
        logits, cache = prefill(p, {"tokens": prompts})
        t1.record()
        t1.synchronize()
        outs = [_full(logits)]
        tok = outs[0][:, -1].argmax(-1, keepdim=True).to(torch.int32)
        toks, step_ms = [tok], []
        for _ in range(T):
            s0, s1 = _events(torch)
            s0.record()
            logits, cache = decode(p, cache, {"tokens": tok})
            s1.record()
            s1.synchronize()
            step_ms.append(s0.elapsed_time(s1))
            outs.append(_full(logits))
            tok = outs[-1][:, -1].argmax(-1, keepdim=True).to(torch.int32)
            toks.append(tok)
        return outs, torch.cat(toks, 1), t0.elapsed_time(t1), step_ms, cache

    for c in counters:                         # counts of this path only
        c.launches = 0
    t_wall = time.perf_counter()
    with _CallCounter(dist, "all_to_all_single") as a2a:
        outs, toks, prefill_ms, step_ms, cache = serve(model, sharded, True)
    wall = time.perf_counter() - t_wall
    peak = torch.cuda.max_memory_allocated()
    launches = {type(c).__name__: c.launches for c in counters}
    specs = model.cache_specs()["layers"]
    for name, t in cache["layers"].items():
        check(tuple(t.placements) == placements(mesh, specs[name]),
              f"{cfg.name}: cache {name} placed {t.placements}")
    del cache
    # two prefills (the warm-up and the timed one) and T decode steps
    expect = {id(scan_kernel): n * (2 + T)} if scan_kernel else {}
    if attn:
        expect[id(FA.flash_attention_cuda)] = 2 * n
    for c in counters:
        want = expect.get(id(c), 0)
        check(c.launches == want, f"{cfg.name} under the rules: "
              f"{type(c).__name__} launched {c.launches} times, not {want}")
    # to the experts and back, each MoE layer of each call
    want = 2 * n * (2 + T) if cfg.moe else 0
    check(a2a.calls == want, f"{cfg.name} under the rules: "
          f"{a2a.calls} all_to_all_single over the model group, not {want}")
    if cfg.moe:
        check(len(routes.shares) == n, f"{len(routes.shares)} routes")
    ref, ref_toks, plain_ms, plain_step_ms, _ = serve(plain, params, False)
    for c in counters:
        c.launches = launches[type(c).__name__]
    equal = [bits_equal(torch, a, b) for a, b in zip(outs, ref)]
    check(all(equal), f"{cfg.name}: logits under the rules differ from "
          f"NO_SHARDING's bits (the prefill, then each step: {equal})")
    check(bool(torch.equal(toks, ref_toks)), f"{cfg.name}: greedy tokens")
    check(all(bool(torch.isfinite(o.float()).all()) for o in outs),
          f"{cfg.name}: finite logits")
    check(outs[0].shape == (B, 1, cfg.vocab_padded), "logits shape")
    decode_ms = sorted(step_ms[1:])[(T - 1) // 2]
    out = {"arch": cfg.name, "tp": SHARD_TP, "layers": n, "batch": B,
           "prompt": P, "decode_steps": T,
           "n_heads_padded": cfg.n_heads_padded,
           "vocab_padded": cfg.vocab_padded, "prefill_ms": prefill_ms,
           "decode_ms": step_ms, "decode_ms_median": decode_ms,
           "no_sharding_prefill_ms": plain_ms,
           "no_sharding_decode_ms": plain_step_ms,
           "peak_memory_bytes": peak, "base_memory_bytes": base,
           "wall_s": wall, "launches": launches,
           "all_to_all_calls": a2a.calls,
           "mfu": {"prefill": lm_mfu(cfg, "prefill", B, P, prefill_ms),
                   "decode": lm_mfu(cfg, "decode", B, P, decode_ms)},
           "logits_bit_equal": all(equal)}
    experts = ""
    if cfg.moe:
        out["dropped_share_by_layer"] = routes.shares
        experts = (f"{cfg.moe.n_experts} experts top-{cfg.moe.top_k} over "
                   f"the model axis, {a2a.calls} all_to_all_single; ")
    log(f"[shard serve] {cfg.name} at resolve({SHARD_TP}): {n} layers, "
        f"{cfg.n_heads_padded} query heads ({cfg.n_heads} real), vocab "
        f"{cfg.vocab_padded}; {experts}rules on a 1 x 1 (data, model) "
        f"mesh: prefill 2 x {P} {prefill_ms:.1f} ms (mfu "
        f"{out['mfu']['prefill']:.3f}; NO_SHARDING {plain_ms:.1f} ms), "
        f"decode {decode_ms:.2f} ms/token "
        f"(mfu {out['mfu']['decode']:.5f}; NO_SHARDING "
        f"{sorted(plain_step_ms[1:])[(T - 1) // 2]:.2f}); peak "
        f"{peak / 1e9:.2f} GB; "
        f"wall {wall:.1f} s; launches {launches}; the logits and {T + 1} "
        "greedy tokens bit-equal to NO_SHARDING's")
    if cfg.moe:
        log(f"[shard serve] {cfg.name} dropped-slot share by layer under "
            f"the rules: {[round(x, 4) for x in routes.shares]}")
    summary.setdefault("shard_serve", {})[cfg.name] = out
    return {"launches": launches, "scan": scan.args if scan_mod else None,
            "k2": (k2.args + (k2.kwargs["window"],)) if attn else None}


def _bf16_steps(torch, out, ref) -> float:
    """``max |out - ref|`` in bf16 steps at ``ref``'s largest entry (inf
    where ``ref`` is 0 and ``out`` is not)."""
    out, ref = out.float(), ref.float()
    err, top = float((out - ref).abs().max()), float(ref.abs().max())
    if top == 0.0:
        return 0.0 if err == 0.0 else math.inf
    return err / 2.0 ** (math.floor(math.log2(top)) - 7)


def shard_train(torch, np, FA, SS, WK, counters, mesh, rules, arch: str,
                summary: dict) -> dict:
    """18 (b), (f): ``arch`` at ``resolve(16)``, full width cut to 2
    layers, bf16, no remat: one ``make_grad_fn`` step under ``rules`` on
    phase 16's batch (2 x 4096) against ``NO_SHARDING`` on the same
    weights, the loss, the load-balance loss and every gradient leaf; then
    ``make_train_step`` (AdamW, lr 3e-4, weight decay 0.1) under the
    rules, 1 warm-up and ``SHARD_TRAIN_TIMED`` steps by CUDA events.

    The loss (and with experts the load-balance loss) must be bit-equal.
    Under the rules the embedding is the reference's one-hot matmul, whose
    backward sums each table row's upstream rows in float32 and rounds
    once, where the gather's backward accumulates them in the table's bf16
    (each add rounded, at the scale of a partial sum, so a row's
    difference is no ulp count of its own value where its terms cancel).
    hymba: every leaf but the embedding's bit-equal, the embedding's
    within as many bf16 steps at its largest entry as the batch repeats
    its most repeated token.  olmoe: every leaf within
    ``SHARD_MOE_GRAD_STEPS`` bf16 steps at its largest entry.  Returns the
    launches under the rules and layer 0's K3 arguments of the first
    step (hymba)."""
    import contextlib
    from repro_torch.kernels.selective_scan import ops as scan_ops
    from repro_torch.launch import steps as ST
    from repro_torch.models.transformer import map_params, tree_leaves
    cfg = _shard_cfg(arch, SHARD_LAYERS)
    n, hybrid = cfg.n_layers, cfg.block == "hybrid"
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()     # what the leg starts with
    plain = ST.build_model(cfg, remat=False, device=SHARD_DEVICE)
    model = ST.build_model(cfg, rules=rules, remat=False,
                           device=SHARD_DEVICE)
    params = plain.init_params(0)
    sharded = model.shard_params(map_params(torch.clone, params), mesh)
    batches = [_lm_batch(torch, np, cfg.vocab, SHARD_TRAIN_BATCH,
                         SHARD_TRAIN_SEQ, SHARD_DEVICE, seed=i)
               for i in range(1 + SHARD_TRAIN_TIMED)]
    expect = {id(FA.flash_attention_cuda): n,
              id(FA.flash_attention_bwd_cuda): n}
    if hybrid:
        expect.update({id(SS.selective_scan_cuda): n,
                       id(SS.selective_scan_grad_cuda): n})
    for c in counters:                         # counts of this path only
        c.launches = 0
    rec = (_FirstCall(scan_ops, "selective_scan") if hybrid
           else contextlib.nullcontext())
    with rec:
        grads, loss, aux = ST.make_grad_fn(model)(sharded, batches[0])
    torch.cuda.synchronize()
    launches = {type(c).__name__: c.launches for c in counters}
    for c in counters:
        want = expect.get(id(c), 0)
        check(c.launches == want, f"{cfg.name} gradient under the rules: "
              f"{type(c).__name__} launched {c.launches} times, not {want}")
    ref_grads, ref_loss, ref_aux = ST.make_grad_fn(plain)(params, batches[0])
    for c in counters:
        c.launches = launches[type(c).__name__]
    names = _leaf_names(params)
    steps = {name: _bf16_steps(torch, _full(g), r)
             for name, g, r in zip(names, grads, ref_grads)}
    same = [name for name, g, r in zip(names, grads, ref_grads)
            if bits_equal(torch, _full(g), r)]
    check(bits_equal(torch, loss, ref_loss), f"{cfg.name}: loss under the "
          f"rules {float(loss)} against NO_SHARDING's {float(ref_loss)}")
    if cfg.moe:
        check(bits_equal(torch, aux, ref_aux), f"{cfg.name}: load-balance "
              f"loss under the rules {float(aux)} against NO_SHARDING's "
              f"{float(ref_aux)}")
    repeats = int(torch.bincount(batches[0]["tokens"].flatten().long()).max())
    if hybrid:
        check(set(names) - set(same) <= {"embed"}, "gradients under the "
              f"rules differ from NO_SHARDING's bits: "
              f"{sorted(set(names) - set(same))}")
        limits = {"embed": float(repeats)}
    else:
        limits = dict.fromkeys(names, float(SHARD_MOE_GRAD_STEPS))
    over = {k: steps[k] for k in limits if steps[k] > limits[k]}
    check(not over, f"{cfg.name}: gradient leaves under the rules over "
          f"their limits in bf16 steps at their largest entry: {over} "
          f"(limits {limits})")
    del grads, ref_grads, plain, params

    opt, step = ST.make_train_step(model, lr=3e-4, weight_decay=0.1)
    state = opt.init(tree_leaves(sharded))
    losses, times = [], []
    for i, batch in enumerate(batches):
        t0, t1 = _events(torch)
        t0.record()
        sharded, state, metrics = step(sharded, state, batch)
        t1.record()
        t1.synchronize()
        losses.append(float(metrics["loss"]))
        if i:
            times.append(t0.elapsed_time(t1))
    n_steps = 1 + len(batches)
    for c in counters:
        want = expect.get(id(c), 0) * n_steps
        check(c.launches == want, f"{cfg.name} train under the rules: "
              f"{type(c).__name__} launched {c.launches} times in "
              f"{n_steps} gradients, not {want}")
        launches[type(c).__name__] = c.launches
    check(all(math.isfinite(x) for x in losses), f"losses {losses}")
    peak = torch.cuda.max_memory_allocated()
    step_ms = sorted(times)[len(times) // 2]
    out = {"arch": cfg.name, "tp": SHARD_TP, "layers": n,
           "batch": SHARD_TRAIN_BATCH, "seq": SHARD_TRAIN_SEQ,
           "loss": float(loss), "no_sharding_loss": float(ref_loss),
           "loss_bit_equal": True, "grad_leaves_bit_equal": same,
           "grad_bf16_steps": steps, "grad_steps_limits": limits,
           "step_ms": times, "median_step_ms": step_ms, "losses": losses,
           "tokens_per_s": SHARD_TRAIN_BATCH * SHARD_TRAIN_SEQ
           / (step_ms / 1e3), "peak_memory_bytes": peak,
           "base_memory_bytes": base, "launches": launches,
           "mfu": lm_mfu(cfg, "train", SHARD_TRAIN_BATCH, SHARD_TRAIN_SEQ,
                         step_ms)}
    held = (f"the embedding's within {steps['embed']:.3g} bf16 steps at its "
            f"largest entry (limit {repeats}, the most repeated token's "
            "count)" if hybrid else
            f"every leaf within {max(steps.values()):.3g} bf16 steps at its "
            f"largest entry (limit {SHARD_MOE_GRAD_STEPS}; the largest "
            f"{max(steps, key=steps.get)})")
    if cfg.moe:
        out.update(aux=float(aux), no_sharding_aux=float(ref_aux),
                   aux_bit_equal=True)
        held += f"; load-balance loss {float(aux):.6f} bit-equal"
    log(f"[shard train] {cfg.name} at resolve({SHARD_TP}), {n} layers, "
        f"bf16, under the rules: loss {float(loss):.6f} bit-equal to "
        f"NO_SHARDING's; {len(same)} of {len(names)} gradient leaves "
        f"bit-equal, {held}; AdamW steps "
        f"{[round(t, 2) for t in times]} ms "
        f"(median {step_ms:.2f}, mfu {out['mfu']:.3f}, 1 warm-up before), "
        f"losses {[round(x, 4) for x in losses]}; peak {peak / 1e9:.2f} GB; "
        f"launches {launches}")
    summary.setdefault("shard_train", {})[cfg.name] = out
    return {"launches": launches, "scan": rec.args if hybrid else None}


def phase_sharded(torch, np, FA, SS, WK, plain, counters,
                  summary: dict) -> dict:
    """18: the LM under sharding rules (``production_rules()``: batch on
    ``data``, heads, channels and experts on ``model``, FSDP on) on a 1 x
    1 ``DeviceMesh`` over NCCL at one rank.  Returns each kernel's
    launches under the rules by path (``"k2"``, ``"k3"``, ``"k3_bwd"``,
    ``"k4"``).  Each leg prints its seconds."""
    import tempfile
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh, production_rules
    legs = dict.fromkeys(("a hymba serve", "b hymba train", "c rwkv serve",
                          "d kernel checks", "e olmoe serve",
                          "f olmoe train"), 0.0)
    names = {k: type(c).__name__ for k, c in (
        ("k2", FA.flash_attention_cuda), ("k3", SS.selective_scan_cuda),
        ("k3_bwd", SS.selective_scan_grad_cuda), ("k4", WK.wkv6_cuda))}
    paths = {k: {} for k in names}
    checks = {}
    rules = production_rules()
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(SHARD_BACKEND,
                                init_method=f"file://{tmp}/store", rank=0,
                                world_size=1)
        try:
            mesh = make_mesh((1, 1), ("data", "model"), device=SHARD_DEVICE)
            t0 = time.perf_counter()
            res = shard_serve(torch, np, FA, SS, WK, counters, mesh, rules,
                              "hymba-1.5b", None, summary)
            for k in ("k2", "k3"):
                paths[k]["sharded serve"] = res["launches"][names[k]]
            legs["a hymba serve"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            checks["k2"] = k2_train_forward_check(
                torch, FA, plain, *res["k2"], "hymba-1.5b at resolve(16) "
                "under the rules, layer 0 of the served prompts (32 heads "
                "over KV expanded through kv_map)")
            checks["k3"] = k3_checks(torch, SS, res["scan"])
            del res
            torch.cuda.empty_cache()
            legs["d kernel checks"] += time.perf_counter() - t0

            t0 = time.perf_counter()
            res = shard_train(torch, np, FA, SS, WK, counters, mesh, rules,
                              "hymba-1.5b", summary)
            for k in ("k2", "k3", "k3_bwd"):
                paths[k]["sharded train"] = res["launches"][names[k]]
            k2_bwd_record(summary, "sharded train", res["launches"][
                type(FA.flash_attention_bwd_cuda).__name__])
            legs["b hymba train"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            checks["k3_bwd"] = k3_grad_checks(torch, SS, res["scan"])
            del res
            torch.cuda.empty_cache()
            legs["d kernel checks"] += time.perf_counter() - t0

            t0 = time.perf_counter()
            res = shard_serve(torch, np, FA, SS, WK, counters, mesh, rules,
                              "rwkv6-1.6b", SHARD_LAYERS, summary)
            paths["k4"]["sharded serve"] = res["launches"][names["k4"]]
            legs["c rwkv serve"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            checks["k4"] = k4_checks(torch, WK, res["scan"])
            del res
            torch.cuda.empty_cache()
            legs["d kernel checks"] += time.perf_counter() - t0

            t0 = time.perf_counter()
            res = shard_serve(torch, np, FA, SS, WK, counters, mesh, rules,
                              "olmoe-1b-7b", None, summary)
            paths["k2"]["sharded olmoe serve"] = res["launches"][names["k2"]]
            del res
            torch.cuda.empty_cache()
            legs["e olmoe serve"] = time.perf_counter() - t0

            t0 = time.perf_counter()
            res = shard_train(torch, np, FA, SS, WK, counters, mesh, rules,
                              "olmoe-1b-7b", summary)
            paths["k2"]["sharded olmoe train"] = res["launches"][names["k2"]]
            k2_bwd_record(summary, "sharded olmoe train", res["launches"][
                type(FA.flash_attention_bwd_cuda).__name__])
            del res
            torch.cuda.empty_cache()
            legs["f olmoe train"] = time.perf_counter() - t0
            backend = dist.get_backend()
        finally:
            dist.destroy_process_group()
    check(backend == SHARD_BACKEND, f"the process group runs {backend}")
    summary["shard_kernel_checks"] = checks
    log("[shard] launches under the rules: " + ", ".join(
        f"{names[k]} {sum(v.values())} ({v})" for k, v in paths.items()))
    for name, secs in legs.items():
        log(f"[shard] leg {name}: {secs:.1f} s")
    summary["shard_legs_s"] = legs
    return paths


DRY_LEGS = (("e olmoe serve", "olmoe-1b-7b", "serve"),
            ("f olmoe train", "olmoe-1b-7b", "train"),
            ("b hymba train", "hymba-1.5b", "train"))
DRY_PEAK_BAND = (0.85, 1.15)     # 19: predicted peak over phase 18's


def _fake_layout(torch, model, device):
    """``model``'s parameters by ``param_layout`` as fake tensors (under a
    ``TraceMode``): what ``init_params`` leaves allocated."""
    from repro_torch.models.transformer import map_params
    return map_params(lambda spec: torch.empty(spec.shape, dtype=spec.dtype,
                                               device=device),
                      model.param_layout())


class _DryCounts:
    """A leg's collectives by op over every traced call, and each named
    call's own counts."""

    def __init__(self, mode):
        self.mode, self.collectives, self.calls = mode, {}, {}

    def start(self):
        self.mode.reset()

    def stop(self, name: str | None = None):
        m = self.mode
        for op, n in m.collectives.items():
            self.collectives[op] = self.collectives.get(op, 0) + n
        if name and name not in self.calls:
            self.calls[name] = {"flops": m.flops, "bytes": m.bytes,
                                "wire": dict(m.wire),
                                "collectives": dict(m.collectives)}


def dry_serve(torch, mode, mesh, rules, arch: str):
    """19 (e): phase 18 (e)'s serve leg traced as it runs: the plain
    model's weights and their sharded copy, the prompts, a warm-up
    prefill (layer 0's attention arguments kept, as 18 keeps them), the
    timed prefill and ``SHARD_DECODE`` greedy steps.  Returns (cfg, the
    peak of live bytes, the counts)."""
    from repro_torch.launch import steps as ST
    from repro_torch.models import layers as L
    from repro_torch.models.transformer import map_params
    cfg = _shard_cfg(arch, None)
    B, P, T = 2, SHARD_SERVE_PROMPT, SHARD_DECODE
    counts = _DryCounts(mode)
    with mode, mode.local_only():
        mode.reset_peak()
        plain = ST.build_model(cfg, device=SHARD_DEVICE)
        model = ST.build_model(cfg, rules=rules, device=SHARD_DEVICE)
        params = _fake_layout(torch, plain, SHARD_DEVICE)
        sharded = model.shard_params(map_params(lambda t: t, params), mesh)
        prompts = torch.empty((B, P), dtype=torch.int32, device=SHARD_DEVICE)
        prefill = ST.make_prefill_step(model, capacity=P + T)
        decode = ST.make_decode_step(model)
        k2 = _FirstCall(L, "flash_attention")
        counts.start()
        with k2:
            prefill(sharded, {"tokens": prompts})
        counts.stop()
        counts.start()
        logits, cache = prefill(sharded, {"tokens": prompts})
        counts.stop("prefill")
        outs = [_full(logits)]
        tok = outs[0][:, -1].argmax(-1, keepdim=True).to(torch.int32)
        for _ in range(T):
            counts.start()
            logits, cache = decode(sharded, cache, {"tokens": tok})
            counts.stop("decode")
            outs.append(_full(logits))
            tok = outs[-1][:, -1].argmax(-1, keepdim=True).to(torch.int32)
        peak = mode.peak
        del outs, cache, logits, sharded, params, k2
    return cfg, peak, counts


def dry_train(torch, mode, mesh, rules, arch: str):
    """19 (f), (b): phase 18's train leg traced as it runs: the plain
    weights and their sharded clone, the batches, the gradient under the
    rules (layer 0's scan arguments kept on hymba, as 18 keeps them) and
    with ``NO_SHARDING``, each leaf pair widened to float32 as 18's
    comparison does, then AdamW's state and 1 + ``SHARD_TRAIN_TIMED``
    steps.  Returns (cfg, the peak of live bytes, the counts; ``train``
    is the first timed step's)."""
    import contextlib
    from repro_torch.kernels.selective_scan import ops as scan_ops
    from repro_torch.launch import steps as ST
    from repro_torch.models.transformer import map_params, tree_leaves
    cfg = _shard_cfg(arch, SHARD_LAYERS)
    B, S = SHARD_TRAIN_BATCH, SHARD_TRAIN_SEQ
    counts = _DryCounts(mode)
    with mode, mode.local_only():
        mode.reset_peak()
        plain = ST.build_model(cfg, remat=False, device=SHARD_DEVICE)
        model = ST.build_model(cfg, rules=rules, remat=False,
                               device=SHARD_DEVICE)
        params = _fake_layout(torch, plain, SHARD_DEVICE)
        sharded = model.shard_params(map_params(torch.clone, params), mesh)
        batches = [{"tokens": torch.empty((B, S), dtype=torch.int32,
                                          device=SHARD_DEVICE),
                    "labels": torch.empty((B, S), dtype=torch.int32,
                                          device=SHARD_DEVICE),
                    "loss_mask": torch.empty((B, S), device=SHARD_DEVICE)}
                   for _ in range(1 + SHARD_TRAIN_TIMED)]
        rec = (_FirstCall(scan_ops, "selective_scan")
               if cfg.block == "hybrid" else contextlib.nullcontext())
        counts.start()
        with rec:
            grads, _, _ = ST.make_grad_fn(model)(sharded, batches[0])
        ref_grads, _, _ = ST.make_grad_fn(plain)(params, batches[0])
        counts.stop()
        for g, r in zip(grads, ref_grads):
            (_full(g).float() - r.float()).abs()
        del grads, ref_grads, plain, params
        opt, step = ST.make_train_step(model, lr=3e-4, weight_decay=0.1)
        state = opt.init(tree_leaves(sharded))
        for i, batch in enumerate(batches):
            counts.start()
            sharded, state, _ = step(sharded, state, batch)
            counts.stop("train" if i == 1 else None)
        peak = mode.peak
        del sharded, state, batches, rec
    return cfg, peak, counts


def _embedding_rule(cfg, kind: str, B: int, S: int) -> float:
    """``model_flops`` of one call less the embedding's share where the
    call takes the embedding by a gather (prefill, decode), the rule of
    ``tests/test_torch_dryrun.py``."""
    from repro_torch.configs.shapes import InputShape
    from repro_torch.launch.roofline import model_flops
    want = model_flops(cfg, InputShape(f"smoke_{kind}", S, B, kind))
    if kind != "train":
        emb = cfg.vocab * cfg.d_model * (1 if cfg.tie_embeddings else 2)
        want -= 2.0 * emb * B * (S if kind == "prefill" else 1)
    return want


def phase_dryrun(torch, np, counters, summary: dict) -> dict:
    """19: the dry-run held to the card.  After phase 18 has destroyed its
    process group, a process group of torch's ``fake`` backend with one
    rank, a 1 x 1 ``(data, model)`` mesh on it, and ``production_rules()``
    trace phase 18's legs (e), (f) and (b) as ``launch/dryrun`` traces a
    step (``TraceMode``: fake CUDA tensors, the kernels' stand-ins).  For
    each leg it prints the predicted and the measured peak (phase 18's
    bytes at the leg's start plus the trace's peak of live bytes, against
    its ``max_memory_allocated``), the counted FLOPs of one call against
    ``model_flops``, ``compute_s`` and ``memory_s`` against the measured
    ms, and the traced collectives by op.  Fails unless the predicted peak
    lies within ``DRY_PEAK_BAND`` of the measured one, every call's FLOPs
    reach ``model_flops`` by the CPU test's embedding rule, (e) traces as
    many ``all_to_all_single`` as phase 18 counted, and no kernel's launch
    counter moved during a trace."""
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_mesh, production_rules
    from repro_torch.launch.roofline import HBM_BW, PEAK_FLOPS
    rules = production_rules()
    before = {type(c).__name__: c.launches for c in counters}
    legs, out = {}, {}
    with D.fake_world(1):
        mesh = make_mesh((1, 1), ("data", "model"), device=SHARD_DEVICE)
        for leg, arch, kind in DRY_LEGS:
            t0 = time.perf_counter()
            mode = D.TraceMode()
            trace = dry_serve if kind == "serve" else dry_train
            cfg, peak, counts = trace(torch, mode, mesh, rules, arch)
            moved = {type(c).__name__: c.launches - before[type(c).__name__]
                     for c in counters}
            check(not any(moved.values()), f"19 {leg}: kernels launched "
                  f"during a trace: {moved}")
            got = summary["shard_serve" if kind == "serve"
                          else "shard_train"][cfg.name]
            predicted = got["base_memory_bytes"] + peak
            ratio = predicted / got["peak_memory_bytes"]
            rec = {"arch": cfg.name, "predicted_peak_bytes": predicted,
                   "traced_peak_bytes": peak,
                   "measured_peak_bytes": got["peak_memory_bytes"],
                   "peak_ratio": ratio, "collectives": counts.collectives,
                   "calls": {}}
            if kind == "serve":
                B, P = got["batch"], got["prompt"]
                measured = {"prefill": ("prefill", B, P, got["prefill_ms"]),
                            "decode": ("decode", B, P,
                                       got["decode_ms_median"])}
            else:
                measured = {"train": ("train", got["batch"], got["seq"],
                                      got["median_step_ms"])}
            failed = []
            for call, (k, B, S, ms) in measured.items():
                c = counts.calls[call]
                want = _embedding_rule(cfg, k, B, S)
                if c["flops"] < want:
                    failed.append(f"{call} counts {c['flops']:.4g} FLOPs, "
                                  f"under model_flops' {want:.4g}")
                rec["calls"][call] = {
                    **c, "model_flops_less_embedding": want,
                    "compute_ms": c["flops"] / PEAK_FLOPS * 1e3,
                    "memory_ms": c["bytes"] / HBM_BW * 1e3,
                    "measured_ms": ms}
            if kind == "serve":
                a2a = counts.collectives.get("alltoall_base_", 0)
                if a2a != got["all_to_all_calls"]:
                    failed.append(f"{a2a} all_to_all_single traced, phase "
                                  f"18 counted {got['all_to_all_calls']}")
            if not DRY_PEAK_BAND[0] <= ratio <= DRY_PEAK_BAND[1]:
                failed.append(f"the predicted peak is {ratio:.3f} of the "
                              f"measured (limits {DRY_PEAK_BAND})")
            legs[leg] = time.perf_counter() - t0
            calls = "; ".join(
                f"{call}: {c['flops']:.4g} FLOPs (model_flops less the "
                f"embedding {c['model_flops_less_embedding']:.4g}), compute "
                f"{c['compute_ms']:.2f} ms, memory {c['memory_ms']:.2f} ms, "
                f"measured {c['measured_ms']:.2f} ms"
                for call, c in rec["calls"].items())
            base = got["base_memory_bytes"]
            log(f"[dryrun] {leg} {cfg.name}: peak predicted "
                f"{predicted / 1e9:.3f} GB (18's {base / 1e9:.3f} at the "
                f"leg's start + traced {peak / 1e9:.3f}), measured "
                f"{got['peak_memory_bytes'] / 1e9:.3f} GB (ratio {ratio:.3f});"
                f" {calls}; traced collectives {counts.collectives}; "
                f"{legs[leg]:.1f} s")
            check(not failed, f"19 {leg}: " + "; ".join(failed))
            out[leg] = rec
            del mode
    summary["dryrun"] = out
    for name, secs in legs.items():
        log(f"[dryrun] leg {name}: {secs:.1f} s")
    return out


def run(name: str, fn, *args, phases: dict):
    t0 = time.perf_counter()
    out = fn(*args)
    phases[name] = time.perf_counter() - t0
    log(f"[phase] {name}: {phases[name]:.1f} s")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="write a JSON summary of the run here")
    ap.add_argument("--artifact", help="also write phase 8's calibration "
                    "artifact (.npz) here")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    import numpy as np

    from repro_torch.kernels.embedding_bag import kernel as K
    from repro_torch.kernels.embedding_bag.ref import (
        embedding_bag_grad_plain, embedding_bag_grad_replay,
        embedding_bag_plain)
    from repro_torch.kernels.flash_attention import kernel as FA
    from repro_torch.kernels.flash_attention.ref import attention_plain
    from repro_torch.kernels.selective_scan import kernel as SS
    from repro_torch.kernels.wkv6 import kernel as WK

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    counters = (K.embedding_bag_cuda, K.embedding_bag_grad_cuda,
                FA.flash_attention_cuda, FA.flash_attention_bwd_cuda,
                SS.selective_scan_cuda, SS.selective_scan_grad_cuda,
                WK.wkv6_cuda, WK.wkv6_grad_cuda)
    phases: dict = {}
    summary: dict = {"torch": torch.__version__, "cuda": torch.version.cuda,
                     "phase_s": phases}
    summary["nvidia_smi"] = run("1 device", phase_device, phases=phases)
    summary["build_s"] = run(
        "2 build K1, K2, K2-bwd, K3 and K4", phase_build,
        {"K1": (K.LIBRARY, None),
         "K2": (FA.LIBRARY, "flash_fwd_tc_kernel"),
         "K2-bwd": (FA.BWD_LIBRARY, "_tc_kernel"),
         "K3": (SS.LIBRARY, None), "K4": (WK.LIBRARY, None)}, phases=phases)
    summary["kernel_check_cases"] = run(
        "3 K1 checks", phase_kernel_checks, torch, np, K,
        embedding_bag_plain, phases=phases)
    summary["grad_check"] = run(
        "3b K1 backward checks", phase_grad_checks, torch, np, K,
        embedding_bag_grad_plain, embedding_bag_grad_replay, phases=phases)
    k1_launches, bwd_launches, shapes = run(
        "4 DreamShard main path", phase_main_path, torch, np, K, counters,
        summary, phases=phases)
    k1_row, inputs = run("5 K1 yardstick", phase_yardstick, torch, np, K,
                         embedding_bag_plain, shapes, summary, phases=phases)
    bwd_row = run("5b K1 backward yardstick", phase_grad_yardstick, torch, K,
                  embedding_bag_grad_plain, inputs, summary, phases=phases)
    del inputs
    torch.cuda.empty_cache()
    summary["k2_check_max_abs_err"] = run(
        "6 K2 checks", phase_k2_checks, torch, np, FA, attention_plain,
        phases=phases)
    summary["k2_bwd_checks"] = run(
        "6c K2-bwd checks", phase_k2_bwd_checks, torch, np, FA,
        phases=phases)
    res, k2_launches = run("7 LM serve path", phase_serve, torch, counters,
                           FA, summary, phases=phases)
    summary["k2_layer0_max_abs_err"] = run(
        "6b K2 on layer 0", phase_k2_layer0, torch, FA, attention_plain, res,
        summary, phases=phases)
    run("7b LM profile", phase_profile, torch, res, summary, phases=phases)
    del res
    torch.cuda.empty_cache()
    run("7c LM cuda vs cpu", phase_cross_device, torch, np, summary,
        phases=phases)
    k2_row = run("9 K2 yardstick", phase_k2_yardstick, torch, FA,
                 attention_plain, summary, phases=phases)
    torch.cuda.empty_cache()
    train_launches, task0, ctx = run(
        "8 train on measured costs", phase_train, torch, np, K, counters,
        summary, args.artifact, phases=phases)
    torch.cuda.empty_cache()
    table1_launches = run("8b Table 1 on the card", phase_table1, torch, np,
                          K, counters, ctx, summary, phases=phases)
    torch.cuda.empty_cache()
    dlrm_launches = run("10 DLRM training step", phase_dlrm, torch, np, K,
                        counters, task0, summary, phases=phases)
    torch.cuda.empty_cache()
    shard_launches = run("11 search and sharding", phase_search_shard, torch,
                         np, K, counters, ctx, summary, phases=phases)
    torch.cuda.empty_cache()
    shard_launches["placement serving"] = run(
        "12 placement serving", phase_serving, torch, np, K, counters, ctx,
        summary, phases=phases)
    del ctx, task0
    torch.cuda.empty_cache()
    lm_launches = run("13 LM train path", phase_lm_train, torch, np, FA,
                      attention_plain, counters, summary, phases=phases)
    torch.cuda.empty_cache()
    lm_launches.update(run("14 MoE path", phase_moe, torch, np, FA,
                           attention_plain, counters, summary,
                           phases=phases))
    torch.cuda.empty_cache()
    ssm = run("15 hybrid SSM and RWKV path", phase_ssm, torch, np, FA, SS, WK,
              attention_plain, counters, summary, phases=phases)
    lm_launches.update(ssm["paths"]["k2"])
    torch.cuda.empty_cache()
    train = run("16 hybrid SSM and RWKV training", phase_ssm_train, torch,
                np, FA, SS, WK, counters, summary, phases=phases)
    lm_launches.update(train["paths"]["k2"])
    for key in ("k3", "k4"):
        ssm["paths"][key].update(train["paths"][key])
    ssm["rows"].update(train["rows"])
    ssm["paths"].update({k: train["paths"][k] for k in ("k3_bwd", "k4_bwd")})
    torch.cuda.empty_cache()
    lm_launches.update(run("17 VLM and audio frontends", phase_frontends,
                           torch, np, FA, attention_plain, counters, summary,
                           phases=phases))
    torch.cuda.empty_cache()
    shard = run("18 sharding rules", phase_sharded, torch, np, FA, SS, WK,
                attention_plain, counters, summary, phases=phases)
    lm_launches.update(shard.pop("k2"))
    torch.cuda.empty_cache()
    run("19 the dry-run held to the card", phase_dryrun, torch, np,
        counters, summary, phases=phases)
    for key, by_path in shard.items():
        ssm["paths"][key].update(by_path)
    check(sorted(summary["k2_bwd_paths"]) == sorted(LM_TRAIN_PATHS),
          f"K2-bwd's paths {sorted(summary['k2_bwd_paths'])}, not "
          f"{LM_TRAIN_PATHS}")
    # each kernel's launches on each path it serves, summed
    k1_paths = {"place and measure": k1_launches,
                "train": train_launches["fwd"],
                "table 1": table1_launches["fwd"],
                "dlrm train": dlrm_launches["fwd"],
                **{k: v["fwd"] for k, v in shard_launches.items()}}
    bwd_paths = {"place and measure": bwd_launches,
                 "train": train_launches["bwd"],
                 "table 1": table1_launches["bwd"],
                 "dlrm train": dlrm_launches["bwd"],
                 **{k: v["bwd"] for k, v in shard_launches.items()}}
    rows = [{**k1_row, "launches": sum(k1_paths.values()),
             "launches_by_path": k1_paths},
            {**bwd_row, "launches": sum(bwd_paths.values()),
             "launches_by_path": bwd_paths},
            {**k2_row, "launches": k2_launches + sum(lm_launches.values()),
             "launches_by_path": {"serve": k2_launches, **lm_launches}},
            {**summary["k2_bwd_row"],
             "launches": sum(summary["k2_bwd_paths"].values()),
             "launches_by_path": summary["k2_bwd_paths"]},
            *({**ssm["rows"][key],
               "launches": sum(ssm["paths"][key].values()),
               "launches_by_path": ssm["paths"][key]}
              for key in ("k3", "k4", "k3_bwd", "k4_bwd"))]
    summary["kernels"] = rows
    summary["seconds"] = time.perf_counter() - t_start
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(summary, fh, indent=1)
    log(f"[done] {summary['seconds']:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
