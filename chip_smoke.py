#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`paddle_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):

1. environment: the card's name and power limit, and the build of every
   kernel from the sources in this checkout (one nvcc per source, all
   started together);
2. kernels: each kernel against its plain PyTorch version on the card,
   with its time beside the plain version's, one PyTorch library
   call's and the card's bound: K1-fwd at the serving path's shapes,
   K1-fwd with its LSE output and K1-bwd (at bf16 and f16 two launches,
   dq computing delta in its prologue from the output, then dkv; the
   external-delta dq launch and the standalone delta launch beside them)
   at the training phases' own shapes (BERT-base 256 x 128 and
   32 x 512, full; GPT-2-small 8 x 1024, causal) and at batch 32 and 1
   of the same models, all bf16, plus f32 and f16 at one shape each,
   head_dim 128 (causal) and a ragged T at f16; K1-fwd with its LSE
   alone at phase 17's no-mesh call (8 x 4096, timed), at head_dim 128,
   on the views of one fused [B, T, 3, N, H] projection and at a ragged
   T; K1-bwd at that call's T 4096, held at batch 1 and timed at batch 8
   beside SDPA's backward; every output is held per element against the
   plain version's, at a limit relative to its own RMS (`ELEM_TOL`;
   K1-bwd's ragged f16 gradients and K2's f16 causal case at
   `ATTN_F16_TOL`). bf16 and f16 run
   the Hopper kernels (wgmma, TMA), f32 the FMA ones;
3. slice: GPT-2-small (random weights from a seed) served at bf16 by
   DecodeEngine behind the HTTP Server, which warms the engine's phase
   grid before it binds (every prefill bucket run once, each decode
   slot count's step captured as a CUDA graph); /v1/healthz 200
   "serving", /v1/load and /v1/models checked; 8 concurrent streamed
   /v1/generate requests whose prompts fill every prefill bucket up to
   1024, then the same 8 again; every decode step a graph replay; the
   kernels' launch counts are read around the first round alone;
4. profile: the slice's requests straight into a fresh engine never
   warmed (every decode step eager), twice, then under torch.profiler
   (device busy share, largest kernels); then the same into a warmed
   engine (warmup seconds, the graphs' memory, the decode step's host
   and device time at 4 and 8 slots, eager against replay), whose
   tokens must equal the unwarmed engine's;
5. greedy: a 2-layer, full-width f32 engine's greedy tokens against the
   step-by-step full forward on the card;
6. train-parity: one `make_train_step` step of a 2-layer, full-width
   BERT at f32 (TF32 off) on the card (kernels) and on the CPU (plain
   versions) from the same params and batch: loss, every gradient and
   the updated params;
7. train: BERT-base under mixed_bf16 with dropout on, at 256 x 128 and
   32 x 512 (3 warm-up and 20 timed steps each): step time, samples/s,
   MFU, a finite and falling loss, kernel launches per step, and one
   step under torch.profiler (device idle share);
8. gpt-train: GPT-2-small `lm_loss` under mixed_bf16 at 8 x 1024
   (2 warm-up and 10 timed steps): the causal backward kernel;
9. nmt-parity: a 2 + 2-layer Transformer at Transformer-big's widths,
   f32 (TF32 off), 4 x 128 with ragged source and target lengths:
   `nmt_loss`, every gradient and one Adam step on the card (K1 and the
   padding-masked K2) against the CPU (plain versions), and
   `beam_search`'s tokens and scores;
10. nmt-train: Transformer-big (`TransformerConfig.big()`, 6 + 6 layers)
   as bench.py's bench_transformer_big runs its first rung: 128 pairs of
   128 x 128 tokens from `make_batch`, Adam(1e-4), f32 params with bf16
   compute (3 warm-up and 20 timed steps): K2 fwd, dkv and dq 12 times
   a step (encoder self- and cross-attention), each on its Hopper kernel
   in the traced step (K2-bwd's device ms reported), K1 6 times;
11. nmt-beam: Transformer-big `beam_search` under inference_mode, 8
   sources of 128 tokens with ragged lengths, beam 4, 32 steps;
12. bert-padded: BERT-base at 32 x 512 with an attention_mask (lengths
   uniform in [256, 512]) under mixed_bf16: every layer's attention on
   K2's Hopper kernels, forward and backward (checked in the traced
   step, K2-bwd's device ms reported);
13. bottleneck: the fused bottleneck slice at ResNet-50's widths (M
   50176, C 1024 -> 256 -> 1024, f32, TF32 off), matmul_stats (K4) ->
   fold_bn -> bn_act_matmul (K5), against the unfused plain composition,
   values and gradients: K5's path;
14. resnet-parity: full-width ResNet-50 at f64 activations, 4 x 64 x 64,
   `fused_1x1`: on the card fused (K4, K6) against unfused (cuDNN), at
   the JAX package's limits for that comparison; the card against the
   CPU (plain versions), loss, BN updates, gradients and one
   SGD-momentum step;
15. resnet-train: ResNet-50 as bench.py's bench_resnet50 runs its first
   rung (bs 256 at 224 x 224, NHWC, bf16 activations, f32 params,
   SGD(0.1, momentum 0.9), 3 warm-up and 20 timed steps), unfused, then
   `fused_1x1` with K4 and K6 16 times a step each;
16. ring-parity: an in-process sp=4 ring on the card (four virtual
   ranks, what one card can show of the sp axis) at f32, TF32 off:
   ring_splash (K3 blocks) against its plain version and against
   single-device K1, causal ring_attention against K1 causal, out and
   gradients; then one step of a 2-layer, full-width BERT-base at
   2 x 1024 under MeshConfig(sp=4) against no mesh (K1) on the card and
   against the CPU: loss, every gradient and one AdamW step;
17. bert-long-sp: BERT-base at T 4096 as bench.py's bench_bert_long
   builds it (`BertConfig(max_len=4096, dropout=0.0)`), mixed_bf16,
   under MeshConfig(sp=4) on the in-process ring at the first rung of
   [8, 4, 2, 1] that fits (2 warm-up and 10 timed steps, K3 192 times
   a step), then the same step with no mesh (K1 at T 4096);
18. head-dim-gate: two mixed_bf16 train steps of `BertConfig.tiny()`
   (head dim 16) on the card, every attention call on mha's "xla"
   route, no attention kernel launched;
19. resilience: BERT-base's widths at 4 layers (depth cut to keep the
   checkpoints' writes short), 256 x 128 (dropout off,
   mixed_bf16, AdamW) through `train_loop` with a CheckpointManager
   (save_every 2, keep_last_n 2): 6 steps uninterrupted, twice (their
   difference is the limit below: 0 when the card repeats a run bit for
   bit); the same run stopped by PADDLE_TPU_FAULT_SPEC step=3:preempt
   with a committed step-3 checkpoint, then restored into a fresh
   template and finished; a child process of this script killed by
   step=3:crash (CRASH_EXIT_CODE), resumed here from its step-2
   checkpoint; both resumed runs' losses and final params against the
   uninterrupted run's within that limit; then one step each with no
   recompute and under recompute policy None, "nothing", "dots" and
   "dots_no_batch" from the same state and batch: the loss and every
   gradient against no recompute's within that step's own repeat
   difference, K1-fwd (LSE) one launch a layer without recompute and two
   under every policy (dq, dkv and the delta folds one), no `delta_kernel` in
   a traced step, each step's ms and peak memory printed;
20. fluid: the fluid Program path (Program, op registry with its generic
   gradient, Executor) on `CUDAPlace(0)`, no kernel of its own: (a)
   bench.py's LeNet rung (`lenet_rung_program`, batch 256 at 1 x 28 x 28
   from numpy seed 0, Adam 2e-3): startup, then 1 + 80 `exe.run` steps
   (samples/s, ms a step, the loss halved), `cache_stats()` (main one
   miss, then hits), `run_chained` for 40 steps with `unroll=False` and
   by default (ms a step), its last loss equal bit for bit to 40
   sequential steps from the same scope copy (cuDNN deterministic for
   that check), and one step under torch.profiler (idle share, kernel
   launches, the largest kernels); (b) the same program on the card and
   on the CPU from the same numpy params (`scope_from_numpy`), f32 with
   TF32 off, 3 Adam steps, each from the CPU's state: the loss, every
   parameter gradient and the updated params (`FLUID_TOL`); (c) the
   book LeNet (`models/lenet.build_program`) 30 steps of 64 on the JAX
   package's synthetic mnist (the loss falls, the accuracy rises) and
   fit_a_line (`fc` 13 -> 1, SGD 0.01) 4 epochs of 32 on its synthetic
   uci_housing (the loss falls);
21. kv_reuse: KV reuse on the serving path. (a) f32, TF32 off, a 2-layer
   GPT at GPT-2-small's widths (seed 1; blocks of 16, 256 blocks, slots
   (4,)): a shared 40-token prefix with suffixes of 5, 2 and 30 tokens,
   prompts of 3, 300 and 1019 tokens (numpy seed 7), 16 new tokens
   each, through `prefill_chunk=64`, the same with `prefix_cache=True`
   cold then warm, a self-draft at `spec_k=2`, a 1-layer draft (seed 2)
   at `spec_k=3` and spec-only (bucketed prefills) at `spec_k=2`: every
   stream equal to a bucketed engine's, the self-draft accepting every
   proposal (its last rounds near max_len demoted to plain decode), the
   warm wave hitting the prefix cache, every refcount drained, and one
   forced share copied on write (the stream unchanged, the original
   block's rows bit for bit, the pools not rebound); (b) GPT-2-small at
   bf16 (512 blocks of 16, slots (4, 8)) with a 2-layer draft of the
   same widths (seed 2) behind the HTTP Server: `prefill_chunk=256`,
   `prefix_cache=True`, `spec_k=3` ("reuse"), then `spec_k=3` with
   bucketed prefills on K1-fwd ("spec_only"), each serving 8 requests
   that share a 512-token prefix (suffixes of 8-200 tokens, 32 new
   tokens) in a cold and a warm wave: tokens/s, TTFT, prefix hits,
   the accept rate, every captured phase (chunk, draft_chunk, decode,
   draft_decode, verify) a graph replay after `warmup()`, the spec
   round's host and device ms at 4 and 8 slots, the idle share of a
   profiled round, and the share of streams equal to a bucketed bf16
   engine's with the first divergent position (measured, not held);
22. gpt-moe: GPT mixture-of-experts (Switch top-1 routing with capacity)
   through the GPipe pipeline under MeshConfig(pp=2, ep=2) on the
   in-process rings (four virtual ranks on the card). (a) f32, TF32
   off, a 2-layer GPT at GPT-2-small's widths with 8 experts, 4 x 128,
   2 microbatches: the card (K1) against the CPU (plain versions), the
   routing first (every token's expert), then the loss, every gradient
   and one AdamW step; and the card's pp+ep step against its
   microbatches run one by one with no mesh; (b) the full model
   (`GPTConfig(n_experts=8)`, GPT-2-small's widths with Switch-Base-8's
   experts, ~521M params), mixed_bf16, AdamW, 8 x 1024, 4 microbatches:
   2 warm-up and 10 timed steps (K1 48 times a step), the dispatch and
   combine einsums' device ms in a profiled step, the share of tokens
   dropped at capacity by layer; then the same model with no mesh;
23. infer: VGG-16 and ResNet-50 inference through `vgg.apply` and
   `resnet.apply(train=False)`. (a) `ops.int8.int8_matmul` (on
   `torch._int_mm`) against the plain product, exactly, at every
   distinct product shape of both models' int8 forwards at batch 1 (the
   zero-padded K 27 and 147 among them) and at an M below 17, with the
   weight operand row- and column-major (each layout's ms; a layout
   `_int_mm` refuses is reported); (b) tools/infer_bench.py's six
   configurations at 224^2 with random weights from a seed: VGG16 bf16
   at batch 1 and 64, ResNet-50 bf16 at 1 and 128, and with int8 conv
   weights VGG16 at 64 and ResNet-50 at 128: ms a call (CUDA events
   around 30 calls after warm-up), one profiled call's device busy ms
   and idle share; at int8 the int8 products' and im2col's share of the
   call, the products' TOP/s against 1,979, and the logits against bf16
   over 32 images (max abs and relative delta, top-1 agreement; the
   relative delta under test_slim's 0.15);
24. predict: bench.py's LeNet rung trained 80 steps on the card, saved
   with `save_inference_model`, and served by one `Server` per
   precision (f32, bf16, int8 calibrated on synthetic_mnist; buckets
   1-64, all 7 warmed before the bind): /v1/healthz and /v1/models,
   then 256 POST /v1/predict requests of 1-8 rows from 16 client
   threads; each precision's replies against a CPU Predictor's at that
   precision on the same rows and the same served dir within
   `PREDICT_TOL`, bf16's and int8's against the f32 replies (top-1
   agreement at least `PREDICT_TOP1_MIN`, the relative delta under
   test_slim's 0.15) and `accuracy_delta`, batches per bucket, pad
   rows, p50/p99 latency (nearest rank), requests/s and rows/s; each
   Predictor's signature cache holds only the 7 bucket signatures
   afterwards;
25. dp-tp: data and tensor parallelism on in-process rings (the JAX
   package's graft paths 1-4; every mesh's virtual ranks on the one
   card, so no byte moves between ranks). (a) BERT-base at f32 (TF32
   off, dropout off): 256 x 128 under MeshConfig(dp=2) and (dp=2,
   tp=2), 128 x 256 under (dp=2, tp=2, sp=2), each the loss and every
   gradient against no mesh at phase 6's limits, `mha` on
   "splash_shardmap" (K1 once per (dp, tp) rank) or "ring_splash" (K3
   per block); then each mesh's timed steps under mixed_bf16; a padded
   attention call under tp=2 (K2 once per tp rank) against no mesh;
   (b) ResNet-50 at 256 x 224^2, f32, unfused, one SGD step at dp=4
   (sync BN) against no mesh: the loss within 1e-3 relative, the BN
   running stats it writes; then timed steps at bf16 activations;
   (c) GPT-2-small at 8 x 1024 in 4 microbatches under pp=2 tp=2 dp=2:
   the pipelined loss within 5e-2 + 1e-3 |ref| of no mesh, then timed
   steps; (d) phase 22's configurations under pp=2 ep=2 dp=2: the
   2-layer f32 gate card against CPU, then the full GPT-MoE timed;
26. fleet: the multi-tenant serving front and the fleet tier at
   GPT-2-small's full width (prefill buckets 32-128, slots 4 and 8,
   `FLEET_POLICY`: tiers high, normal and low, tenants a and b weighted
   3:1, a low tenant with a quota, a queue of `FLEET_QUEUE`). (a) A
   burst of 38 concurrent streams from five tenants over HTTP, on the
   async loop and on the sync loop (prefill_chunk 64), at f32: every
   503 is the typed shed of the low tier with Retry-After (a queued
   victim's open stream ends with its shed in-band), no gold, a or b
   request is shed (they never outnumber the queue), a "capped"
   tenant's request is a quota shed, and every served stream equals a
   no-policy engine's tokens; then the burst at bf16: the same gates of
   sheds and service, its TTFT by tier and tokens/s printed with the
   count of each tier (one burst: a gate, not a measure of the tiers'
   latency). No burst's attention takes another route than K1-fwd, and
   the async loop's bursts launch it (the sync loop's chunked prefill
   is plain torch, as the JAX package's chunk step is plain XLA). (b)
   The bf16 engine's Server holds two LeNet slots (f32 and bf16, phase
   24's rung saved after 20, 40 and 80 steps): routing
   by "model" and /v1/models; `hot_swap` of each slot, then a
   `ModelRegistry` publish adopted by the watcher, each under predict
   traffic from 8 threads with a stream beside it: no failed request,
   replies before a swap equal the old dir's CPU Predictor's and after
   it the new dir's (`PREDICT_TOL`), the adopted version in /v1/models,
   a digest mismatch and a tampered blob refused; each swap's swap_s.
   (c) A RouterServer over that server and a second one (its engine
   warmed before any request is routed: no CUDA graph is captured
   while a scheduler serves): 12 streams, then predict traffic,
   through the router, p2c picks on both, a typed shed passed through unchanged with no
   retry, one replica stopped in a predict burst with no failed
   request, and a stream that had delivered no token resubmitted on the
   survivor (a second router that still ranks the stopped replica
   first). (d) A ReplicaSupervisor of two `python -m
   paddle_tpu_torch.serving.replica --decode-tiny 0` processes on the
   card, found through a FileRendezvous by `Router(rdzv_dir=...)`:
   SIGKILL respawns the slot, an Autoscaler on the router's load
   scales out once under a backlog of 48 streams and in after its
   cooldown, SIGTERM drains a replica to rc 0 unreplaced;
   spawn-to-ready and respawn seconds. On one card every replica
   shares the chip: no fleet scaling is measured.
27. observability: GPT-2-small bf16 beside the LeNet predict slot
   behind one Server, with SLOs and the time-series recorder; a round
   inside a POST /v1/profile window (`phase_observability`);
28. fluid-dp: the fluid path's data parallelism, f32 with TF32 off, on
   bench.py's LeNet rung at batch 256 split over 4 in-process ranks of
   the card (`FLUID_DP_RANKS`; the ranks share the card, so this is the
   split's own cost, not a scaling): (a)
   `CompiledProgram.with_data_parallel(places=[CUDAPlace(0)] * 4)`, 3
   Adam steps against the one-rank `Executor.run` from a copy of the
   same scope (`FLUID_TOL`, `fluid_adam_slack`), each rank's feed 64
   rows; (b) the `GradAllReduce(nranks=4)`-transpiled program under
   `SPMDRunner`, the same gates, one `c_allreduce_sum` a trainable param
   a step; (c) the fleet facade with `DistributedStrategy(
   data_parallel_degree=4, use_graph_collectives=True)` and LocalSGD at
   k_steps 2, 20 steps: the loss falls; (d) step ms at 1 rank and at 4
   (CompiledProgram and SPMDRunner), one traced step of each (idle
   share), the `spmd` and `sharded` telemetry rows and perfwatch's
   "spmd" sample;
30. fluid-trainer: the fluid trainer's front end, f32 with TF32 off and
   cuDNN deterministic (`phase_fluid_trainer`): (a) the book's
   VGG-16-BN at batch 128 fed by `DataLoader.from_generator(
   use_double_buffer=True)` on `CUDAPlace(0)` (the DevicePrefetcher)
   through `run_stream` windows of 8 and `exe.train_from_dataset`, 24
   steps: losses and state equal to per-step `Executor.run` bit for
   bit, at PADDLE_TPU_STREAM_WINDOW=1 too, and a preemption at step 13
   equal to 13 per-step runs; step ms both ways, traced idle shares,
   the prefetch's blocked seconds; (b) the LeNet rung at batch 256
   under each of the 17 optimizer op types and ModelAverage, EMA,
   Lookahead, GradientMerge(k=4) and Recompute, 5 steps each from the
   CPU's state: loss and gradients against the CPU's (`FLUID_TOL`),
   the optimizer ops' results against the same ops run on the CPU from
   the card's gradients (`OPT_TOL`); dpsgd at sigma 0 is clipped SGD;
   (c) tools/ctr_bench.py's CTR program at 100,000 x 16, batch 512,
   Zipf ids: sparse equal to dense bit for bit (sgd, momentum, adagrad,
   adam), lazy Adam's touched rows equal to dense and the rest
   unchanged, step ms sparse and dense; (d) `amp.decorate` on
   VGG-16-BN (mixed_bf16: the loss falls; f16: the loss scale on the
   card and the CPU); (e) the fleet's use_amp, recompute,
   gradient_merge_k=2, use_dgc and lamb on the LeNet rung at 2 ranks
   against one (`_fluid_dp_parity`; amp at `AMP_DP_TOL`), and DGC with
   an axis under SPMDRunner against the ranks' `sparse_allreduce`;
31. dygraph: eager mode (`paddle_tpu_torch.dygraph`) at ResNet-50's full
   width, f32 with TF32 off (`phase_dygraph`): `dygraph_resnet`, the
   network of PaddlePaddle/models' dygraph/resnet/train.py from
   `dygraph.nn` layers only (102 classes), Momentum 0.9 under
   PiecewiseDecay with L2Decay(1e-4), in DataParallel at one rank. (a)
   5 steps at batch 32 x 224^2 on one batch (lr 0.0125, train.py's 0.1
   for 8 x 32 scaled to one card): every loss finite and the fifth
   below the first, `memory_allocated` after step 5 within 1% of step
   2's (no graph kept alive); the median step ms, a profiled step's
   idle share, the peak memory; (b) the network at batch 2 for 2 steps
   on the card and on the CPU from one state_dict (the CPU resynced to
   the card's state before step 2): loss, every gradient, the updated
   parameters and running statistics (`DYGRAPH_TOL`); (c)
   `TracedLayer.trace` in eval() at batch 32, its program on
   `Executor(CUDAPlace(0))` against the eager forward, and its
   `save_inference_model` dir reloaded with `io.load_inference_model`
   against the traced run; (d) `save_dygraph` / `load_dygraph` bit for
   bit; (e) every layer of the zoo, forward and backward, card against
   CPU (`DYGRAPH_ZOO_TOL`), NCE by its properties; (f) Dropout's input
   gradient equal to its forward's mask times its scale; (g)
   `contrib.utils.memory_usage`'s band for the traced program beside
   its run's `max_memory_allocated`, and `summary`'s FLOPs beside (a)'s
   step ms (printed, not gated). No Pallas kernel lies on this path;
35. tools: the serving operator's tools (`paddle_tpu_torch/tools/`) on
   the card (`phase_tools`), at torch's default TF32 flags (the
   replicas' environment). (a) `warmstart bake-decode` and `inspect` as
   processes at tiny; then `bake_decode(cfg=GPTConfig())` here at
   GPT-2-small's width for serve_bench token mode's grid, its
   `--prefill-chunk` grid and its `--spec-k` grid: an engine of the same
   seed adopts every phase (time to healthy cold and warm printed), one
   of seed 1 adopts none and emits the `warmstart` reject; (b)
   serve_bench token mode at GPT-2-small with (a)'s artifact: no error,
   warm tokens equal to cold, every phase adopted, no eager decode step
   in the warm replay, K1-fwd launched (its launches join the kernels
   line); tokens/s, the speedup, TTFT and p99 printed, not gated; (c)
   prefix-share at GPT-2-small: equal streams, prefix hits, accept rate
   >= 0.99; (d) tenants mode, with a profile capture beside it: every
   shed on bronze, no gold failure, no failure across the hot swap,
   every bucket adopted; (e) fleet mode, 2 replicas up to 3, at the
   smoke's traffic: no failed request across the kill and the
   scale-in, the respawn and a scale-out from the artifact, the
   generate trace one tree across processes, `slo_alert` fires and
   clears; (f) `warmstart bake` of the
   MLP by the CLI, its artifact adopted whole here, and `autoscale`
   booting one replica that answers one predict through its router.
   (a)'s and (f)'s processes run beside (a), (c) and (d); (b) runs
   after them. (g) `obsdump` by file path renders every dump of
   (a)-(f), each with rows;

Phase 2 also holds K2 (forward, dkv, dq) per element against its plain
versions at those paths' shapes (Transformer-big's encoder and cross
attention, the beam search's 32 x 128, padded BERT-base 32 x 512),
causal with full biases at f32 and f16, a ragged pair, the bias
gradient at f32 and bf16 and head_dim 128 with 300 keys (bf16 and f16
on the Hopper kernels, f32 on the FMA ones); and K4, K5 and K6 (the fused matmul+BN
kernels) at one ResNet-50 bs-256 shape of each stage group (bf16, timed
beside cuBLAS's bare product), at f32, f16 and f64, at a ragged (1000, 72, 40),
with the ReLU off and at (1000, 70, 36), whose K and N TMA cannot read
in place (the padded route); and K3 (the ring's block, K1-fwd with its LSE
at scale 1 on a pre-scaled q) at phase 17's block (8 x 1024 x 12 heads,
bf16), at f32 and at f16, and at phase 25's per-rank block (64 x 128 x
6 heads, bf16, timed). K1's training cases include phase 25's per-rank
blocks of BERT-base 256 x 128 at dp=2 (128 x 128 x 12) and at dp=2
tp=2 (128 x 128 x 6), timed.

The kernels' launch counts are set to 0 just before each path's run and
read just after (phases 3, 21, 26 and 35 (b), (c) for serving, phases 7, 8, 10, 12, 15, 17,
22 (b) and 25's timed runs for training, phase 11 for beam search, phase 13 for the
bottleneck, phase 19's first uninterrupted `train_loop` run).
The last line is {"ok": true, "device": {...}}; the line before it
lists every kernel with its numbers, and the one before that each
phase's wall seconds. Exits non-zero without a CUDA
device, and when the package is not beside this script.
"""

from __future__ import annotations

import collections
import faulthandler
import json
import math
import os
import statistics
import subprocess
import sys
import threading
import time
import types
import urllib.error
import urllib.request

import numpy as np

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
WATCHDOG_S = 1080              # under the run's 1200 s limit
F32_FLOPS_PER_S = 67e12        # H100 SXM f32 outside the tensor cores


def bf16_flops_per_s():
    """The card's dense bf16 peak from the port's device-peak table,
    the denominator of the live paddle_tpu_mfu gauge too (989e12 on an
    H100 SXM)."""
    import torch

    from paddle_tpu_torch.observability import device_peaks

    return device_peaks.lookup(torch.cuda.get_device_name(0)).flops


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def time_ms(fn, reps=30):
    """Median over `reps` warm calls, each timed with CUDA events."""
    import torch

    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(nbytes, flops, peak):
    """Least time for `nbytes` of memory traffic and `flops` operations
    at `peak` FLOP/s: (ms, "bytes" or "operations")."""
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return max(by_bytes, by_ops) * 1e3, \
        "bytes" if by_bytes >= by_ops else "operations"


def attention_bound_ms(q, k, causal=True, products=2, tensors=4,
                       row_floats=0):
    """Least time for attention work on these inputs: `tensors` tensors
    of q's size read or written once, plus `row_floats` f32 rows of
    [B, N, T] (LSE, delta), over the memory rate, against `products`
    matrix products of 2 * pairs * H per (batch, head) over the peak
    rate of q's dtype, pairs being the (query, key) pairs the mask
    leaves. The forward is 2 products over q, k, v and o; the backward
    5 products over q, k, v, o, dO, dq, dk and dv."""
    import torch

    B, T, N, H = q.shape
    Tk = k.shape[1]
    pairs = sum(min(t + 1, Tk) for t in range(T)) if causal else T * Tk
    nbytes = tensors * q.numel() * q.element_size() + row_floats * B * N * T * 4
    flops = products * 2 * B * N * H * pairs
    peak = F32_FLOPS_PER_S if q.dtype == torch.float32 \
        else bf16_flops_per_s()
    return bound_ms(nbytes, flops, peak)


def card():
    """The card's name and power limit, as nvidia-smi reports them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    return smi.stdout.strip().splitlines()[0]


def phase_environment():
    import torch

    from paddle_tpu_torch.kernels import _build

    print(card())
    t0 = time.perf_counter()
    took = _build.build()
    print(json.dumps({"phase": "environment",
                      "device": torch.cuda.get_device_name(0),
                      "torch": torch.__version__,
                      "cuda": torch.version.cuda,
                      "build_s": round(time.perf_counter() - t0, 3),
                      "built": sorted(took)}))


def _serving_kernel_row():
    import torch
    import torch.nn.functional as F

    from paddle_tpu_torch.kernels import flash_attention as fa

    B, N, H = 1, 12, 64
    scale = 1.0 / H ** 0.5
    gen = torch.Generator(device="cuda").manual_seed(0)
    checks = []
    timing = None
    for dtype, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-4)):
        for T in (8, 100, 128, 1024):
            # q/k/v as the serving path hands them over: strided views
            # of one fused qkv projection
            qkv = torch.randn(B, T, 3 * N * H, generator=gen,
                              device="cuda").to(dtype)
            q, k, v = (t.view(B, T, N, H)
                       for t in qkv.split(N * H, dim=-1))
            out = fa.flash_attention(q, k, v, scale, causal=True)
            torch.cuda.synchronize()
            ref = fa.flash_attention_ref(q, k, v, scale, causal=True)
            err = (out.float() - ref.float()).abs().max().item()
            dname = str(dtype).replace("torch.", "")
            elem = held(out, ref, dname)
            checks.append({"dtype": dname, "T": T, "max_abs_err": err,
                           "tol": tol, "held": elem})
            check(err <= tol, f"flash_attention T={T} {dtype}: max abs "
                              f"err {err} > {tol}")
            check(elem["ratio"] <= 1.0, f"flash_attention T={T} {dtype}: "
                                        f"per element {elem}")
            if dtype == torch.bfloat16 and T == 1024:
                qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
                bound, bound_by = attention_bound_ms(q, k)
                timing = {
                    "shape": [B, T, N, H], "dtype": "bfloat16",
                    "kernel_ms": time_ms(
                        lambda: fa.flash_attention(q, k, v, scale)),
                    "plain_ms": time_ms(
                        lambda: fa.flash_attention_ref(q, k, v, scale)),
                    "library_ms": time_ms(
                        lambda: F.scaled_dot_product_attention(
                            qt, kt, vt, is_causal=True, scale=scale)),
                    "bound_ms": bound, "bound_by": bound_by}
    # the serving path runs bf16: its error is the worst bf16 check
    timing["max_abs_err"] = max(c["max_abs_err"] for c in checks
                                if c["dtype"] == "bfloat16")
    return {"name": "flash_attention_fwd",
            "replaces": "K1 attention.py:_splash_mha (causal fwd)",
            "tol": 2e-2, "checks": checks, **timing}


# Limits of a kernel's result against its plain version, per element:
# |got - want| <= rtol |want| + atol rms(want). rtol is one rounding
# step of the dtype (both round the same f32 sums to it, so a sum taken
# in another order may move one rounding). atol, a share of the
# tensor's own RMS, covers a rounding of P or dS to the dtype that falls
# the other way after f32 sums in another order: one step of a large dS
# times a q or k element, landing on a dq or dk element of any size.
# The largest such reading on an H100 was 1.07e-2 of RMS at bf16,
# 1.9e-4 at f16 and 2.8e-6 at f32 (PERF.md); the limits are 2-5 times
# those. Each gradient is held to its own scale, so a result wrong on
# some rows fails, however large the largest value is.
ELEM_TOL = {"bfloat16": (2 ** -7, 2e-2), "float16": (2 ** -10, 1e-3),
            "float32": (1e-5, 1e-5), "float64": (1e-12, 1e-12)}
# The f16 attention limit, where ELEM_TOL's f16 atol lies below the
# plain version's own f32 noise: K1-bwd's f16 gradients at the ragged
# f16 case below and in tests/test_torch_cuda.py's Hopper backward cases,
# and K2's f16 causal case (its output and gradients). On the tensor
# cores S (and dP) are summed in another order than the plain version's
# f32 GEMM, so a rounding of P or dS to f16 falls the other way here and
# there. An f64 evaluation of the same arithmetic, P and dS rounded to
# f16, reads up to 1.09 (K1-bwd) and 1.38 (K2's causal case) of
# ELEM_TOL's f16 limit against the f32 plain version
# (`kernels/probe_sm90.py` on the card, "k1_bwd_f16_floor" and
# "k2_seeds"; tests/test_torch_hopper_numerics.py on the CPU; PERF.md): at those shapes 1e-3 lies below that noise. Every other f16
# case stays under ELEM_TOL. This limit is about twice the largest
# kernel reading, as bf16's atol is to its own, and it still fails an
# evaluation that rounds P and dS to bf16 at f16 inputs, on every output
# (the probe's "bf16_*" readings; the tests assert it).
ATTN_F16_TOL = (2 ** -10, 3e-3)

# K1 at the training path's shapes: (label, B, T, N, H, causal, dtype
# name, timed, the gradients' limit), q, k and v the strided views of
# one fused qkv projection. The first three are the main path's own
# calls (phase 7's BERT-base at 256 x 128 and 32 x 512, phase 8's
# GPT-2-small at 8 x 1024), then BERT-base and GPT-2-small at batch 32
# and 1 (causal T 1024 at B 1), then f32 and f16 at one shape each, 16
# heads of 128 (causal) and a ragged T at f16, and last the main path's
# GPT-MoE microbatch (phase 22: 2 x 1024, pp=2 with 4 microbatches),
# drawn after the others so that they keep their inputs, then phase
# 25's per-rank blocks of BERT-base 256 x 128 under dp=2 and under
# dp=2 tp=2 (GPT's per-rank block under dp=2 in the pipeline is
# "gpt1") and of Transformer-big's causal decoder self-attention at
# 128 x 128 under dp=2 tp=2 ("nmt_dp2tp2"). The gradients are held
# under ELEM_TOL, or under the limit the case names.
TRAIN_KERNEL_CASES = (
    ("bert", 256, 128, 12, 64, False, "bfloat16", True, None),
    ("bert512", 32, 512, 12, 64, False, "bfloat16", True, None),
    ("gpt", 8, 1024, 12, 64, True, "bfloat16", True, None),
    ("bert32", 32, 128, 12, 64, False, "bfloat16", True, None),
    ("gpt1", 1, 1024, 12, 64, True, "bfloat16", True, None),
    ("f32", 2, 256, 12, 64, True, "float32", False, None),
    ("f16", 4, 128, 12, 64, False, "float16", False, None),
    ("h128", 2, 1024, 16, 128, True, "bfloat16", False, None),
    ("ragged_f16", 2, 300, 12, 64, False, "float16", False, ATTN_F16_TOL),
    ("gpt_moe_mb", 2, 1024, 12, 64, True, "bfloat16", True, None),
    ("bert_dp2", 128, 128, 12, 64, False, "bfloat16", True, None),
    ("bert_dp2tp2", 128, 128, 6, 64, False, "bfloat16", True, None),
    ("nmt_dp2tp2", 64, 128, 8, 64, True, "bfloat16", True, None))


def held(got, want, dname, tol=None):
    """`got` against `want` under ELEM_TOL[dname] (or `tol`, an (rtol,
    atol) pair): the max abs error,
    the reference's RMS (its typical value) and largest value, `ratio`
    (the worst element's error over its limit; at most 1 passes) and
    `atol_rms` (the least atol, in RMS, that would pass at this
    rtol)."""
    import torch

    rtol, atol = tol or ELEM_TOL[dname]
    want = want.float()
    err = (got.float() - want).abs()
    rms = want.square().mean().sqrt().clamp(min=torch.finfo().tiny)
    return {"max_abs_err": err.max().item(), "rms": rms.item(),
            "max_ref": want.abs().max().item(),
            "ratio": (err / (rtol * want.abs() + atol * rms)).max().item(),
            "atol_rms": ((err - rtol * want.abs()).clamp(min=0).max()
                         / rms).item()}


def _sdpa_bwd_ms(q, k, v, do, causal, scale, reps=30):
    """The backward of F.scaled_dot_product_attention at the same shape,
    timed through torch.autograd.grad: the library yardstick."""
    import torch
    import torch.nn.functional as F

    qt, kt, vt = (t.detach().transpose(1, 2).requires_grad_()
                  for t in (q, k, v))
    out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                         scale=scale)
    dot = do.transpose(1, 2)
    return time_ms(lambda: torch.autograd.grad(out, (qt, kt, vt), dot,
                                               retain_graph=True), reps)


def _training_kernel_case(fa, B, T, causal, dname, gen, N=12, H=64,
                          grad_tol=None):
    """One case: K1-fwd with LSE and K1-bwd's launches against their
    plain versions: dq given the output (at bf16 and f16 its kernel
    computes delta in its prologue), dkv from that delta, the
    external-delta dq launch given the same delta (bit for bit the
    folded one's dq: "equal_to_folded") and the standalone delta launch;
    and the whole backward (from the plain forward's residuals) against
    its plain version; the gradients under `grad_tol` where given, else
    ELEM_TOL, each delta under f32's."""
    import torch

    scale = 1.0 / H ** 0.5
    dtype = getattr(torch, dname)
    qkv = torch.randn(B, T, 3 * N * H, generator=gen,
                      device="cuda").to(dtype)
    q, k, v = (t.view(B, T, N, H) for t in qkv.split(N * H, dim=-1))
    do = torch.randn(B, T, N, H, generator=gen, device="cuda").to(dtype)
    out, lse = fa.flash_attention_with_lse(q, k, v, scale, causal)
    dq, delta = fa.flash_attention_bwd_dq(q, k, v, do, lse, None, scale,
                                          causal, o=out)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, scale,
                                        causal)
    dq_external = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, scale,
                                            causal)
    standalone = fa.attention_delta(out, do)
    torch.cuda.synchronize()
    ref_out, ref_lse = fa.flash_attention_ref(q, k, v, scale, causal,
                                              with_lse=True)
    # each launch's plain version from the kernels' own residuals
    ref = dict(zip(("dq", "dk", "dv"), fa.flash_attention_bwd_ref(
        q, k, v, out, lse, do, scale, causal)))
    ref_delta = fa.attention_delta_ref(out, do)
    errs = {"out": held(out, ref_out, dname),
            "delta": held(delta, ref_delta, "float32"),
            "delta_standalone": held(standalone, ref_delta, "float32"),
            "dq": held(dq, ref["dq"], dname, grad_tol),
            "dq_external": {**held(dq_external, ref["dq"], dname, grad_tol),
                            "equal_to_folded": torch.equal(dq_external, dq)},
            "dk": held(dk, ref["dk"], dname, grad_tol),
            "dv": held(dv, ref["dv"], dname, grad_tol)}
    whole = fa.flash_attention_bwd(q, k, v, ref_out, ref_lse, do, scale,
                                   causal)
    whole_ref = fa.flash_attention_bwd_ref(q, k, v, ref_out, ref_lse, do,
                                           scale, causal)
    for name, a, b in zip(("bwd_dq", "bwd_dk", "bwd_dv"), whole, whole_ref):
        errs[name] = held(a, b, dname, grad_tol)
    lse_err = (lse - ref_lse).abs().max().item()
    return (q, k, v, do, out, lse, delta, scale), errs, lse_err


def failed_checks(prefix, errs):
    """The readings of `errs` ({name: held(...)}) that fail: a ratio over
    1, or an external-delta result that is not the folded one's bit for
    bit."""
    return [f"{prefix} {name}: {e}" for name, e in errs.items()
            if not e["ratio"] <= 1.0 or e.get("equal_to_folded") is False]


def _training_kernel_timings(fa, case, causal):
    """ms, plain_ms, library_ms and the bound of K1-fwd-LSE, the whole
    K1-bwd (two launches; the three-launch form with the standalone delta
    beside it) and its dkv and dq launches and the delta pass folded into
    dq, at one case's inputs."""
    import torch.nn.functional as F

    q, k, v, do, out, lse, delta, scale = case
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    B, T, N, _ = q.shape
    t = {"fwd_lse": {
        "ms": time_ms(lambda: fa.flash_attention_with_lse(
            q, k, v, scale, causal)),
        "plain_ms": time_ms(lambda: fa.flash_attention_ref(
            q, k, v, scale, causal, with_lse=True)),
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, scale=scale)),
        "bound": attention_bound_ms(q, k, causal, 2, 4, 1)}}
    # the whole backward (dq with the delta pass, then dkv) is no kernel
    # row of its own: its launches are the dq and dkv rows'
    t["bwd_whole"] = {
        "ms": time_ms(lambda: fa.flash_attention_bwd(
            q, k, v, out, lse, do, scale, causal)),
        "three_launch_ms": time_ms(lambda: _k1_bwd_three_launches(
            fa, q, k, v, out, lse, do, scale, causal)),
        "plain_ms": time_ms(lambda: fa.flash_attention_bwd_ref(
            q, k, v, out, lse, do, scale, causal)),
        "library_ms": _sdpa_bwd_ms(q, k, v, do, causal, scale),
        "bound": attention_bound_ms(q, k, causal, 5, 8, 2)}
    dq_ms = time_ms(lambda: fa.flash_attention_bwd_dq(
        q, k, v, do, lse, None, scale, causal, o=out))
    dq_external_ms = time_ms(lambda: fa.flash_attention_bwd_dq(
        q, k, v, do, lse, delta, scale, causal))
    # the delta pass folded into dq: the folded launch's time less the
    # external-delta launch's, against one read of o and the delta rows'
    # write (dq reads dO anyway)
    t["delta"] = {
        "ms": dq_ms - dq_external_ms,
        "standalone_ms": time_ms(lambda: fa.attention_delta(out, do)),
        "plain_ms": time_ms(lambda: fa.attention_delta_ref(out, do)),
        "library_ms": None,
        "bound": bound_ms(out.numel() * out.element_size() + B * N * T * 4,
                          2 * out.numel(), F32_FLOPS_PER_S)}
    t["dkv"] = {
        "ms": time_ms(lambda: fa.flash_attention_bwd_dkv(
            q, k, v, do, lse, delta, scale, causal)),
        "plain_ms": time_ms(lambda: fa.flash_attention_bwd_dkv_ref(
            q, k, v, do, lse, delta, scale, causal)),
        "library_ms": None,
        "bound": attention_bound_ms(q, k, causal, 4, 6, 2)}
    # dq as the main path runs it, folding the delta pass in: q, k, v,
    # dO and o read, dq written, lse read and delta written
    t["dq"] = {
        "ms": dq_ms, "external_ms": dq_external_ms,
        "plain_ms": time_ms(lambda: fa.flash_attention_bwd_dq_ref(
            q, k, v, do, lse, None, scale, causal, o=out)),
        "library_ms": None,
        "bound": attention_bound_ms(q, k, causal, 3, 6, 2)}
    return t


def _k1_bwd_three_launches(fa, q, k, v, out, lse, do, scale, causal):
    """K1-bwd as it ran before the fold: the standalone delta launch, then
    dkv and the external-delta dq."""
    delta = fa.attention_delta(out, do)
    return (fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, scale,
                                      causal),
            *fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, scale,
                                        causal))


def _training_kernel_rows():
    """K1-fwd with LSE and K1-bwd's launches against their plain versions
    at every case, and their times at the bf16 cases. Returns the kernel
    rows, every case's readings and the failed checks."""
    import torch

    from paddle_tpu_torch.kernels import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(1)
    checks, timings, failed = [], {}, []
    for (label, B, T, N, H, causal, dname, timed,
         grad_tol) in TRAIN_KERNEL_CASES:
        case, errs, lse_err = _training_kernel_case(fa, B, T, causal, dname,
                                                    gen, N, H, grad_tol)
        checks.append({"case": label, "shape": [B, T, N, H],
                       "causal": causal, "dtype": dname,
                       "tol": ELEM_TOL[dname],
                       "grad_tol": grad_tol or ELEM_TOL[dname],
                       "lse_max_abs_err": lse_err, "held": errs})
        failed += failed_checks(f"K1 {label}", errs)
        if not lse_err <= 1e-4:
            failed.append(f"K1 {label} lse: max abs error {lse_err} > 1e-4")
        if timed:
            timings[label] = {"shape": [B, T, N, H], "causal": causal,
                              **_training_kernel_timings(fa, case, causal)}
        del case
    # the training path runs bf16: a row's error is its worst bf16 one
    bf16 = [c for c in checks if c["dtype"] == "bfloat16"]

    def worst(*names):
        return max(c["held"][n]["max_abs_err"] for c in bf16 for n in names)

    rows = []
    for name, key, err, replaces in (
            ("flash_attention_fwd_lse", "fwd_lse", worst("out"),
             "K1 attention.py:_splash_mha fwd with LSE (under grad)"),
            (DELTA, "delta", worst("delta"),
             "K1-bwd splash vjp di = rowsum(o*do), folded into the dq "
             "kernels at bf16 and f16"),
            ("flash_attention_bwd_dkv", "dkv", worst("dk", "dv"),
             "K1-bwd splash dkv kernel"),
            ("flash_attention_bwd_dq", "dq", worst("dq"),
             "K1-bwd splash dq kernel")):
        rows.append({"name": name, "replaces": replaces, "max_abs_err": err,
                     "timings": {label: t[key]
                                 for label, t in timings.items()}})
    whole = {label: t["bwd_whole"] for label, t in timings.items()}
    return rows, checks, whole, failed


# K1-fwd with its LSE beyond the training cases, forward only (the plain
# backward at T 4096 would take tens of GB): (label, B, T, N, H, causal,
# dtype, layout). "long" is phase 17's no-mesh call (BERT-base at
# 8 x 4096), timed; then H 128, the strided views of one fused
# [B, T, 3, N, H] projection, and a ragged T at f16.
K1_FWD_CASES = (("long", 8, 4096, 12, 64, False, "bfloat16", "plain"),
                ("h128", 2, 1024, 16, 128, True, "bfloat16", "plain"),
                ("fused3", 4, 512, 12, 64, False, "bfloat16", "fused"),
                ("ragged_f16", 2, 300, 12, 64, True, "float16", "fused"))


def _k1_fwd_rows():
    """K1-fwd with its LSE at K1_FWD_CASES against its plain version, per
    element under ELEM_TOL and the LSE within 1e-4; times at "long"."""
    import torch
    import torch.nn.functional as F

    from paddle_tpu_torch.kernels import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(6)
    checks, failed, timing = [], [], None
    for label, B, T, N, H, causal, dname, layout in K1_FWD_CASES:
        dtype = getattr(torch, dname)
        if layout == "fused":
            qkv = torch.randn(B, T, 3, N, H, generator=gen,
                              device="cuda").to(dtype)
            q, k, v = qkv.unbind(2)
        else:
            q, k, v = (torch.randn(B, T, N, H, generator=gen, device="cuda")
                       .to(dtype) for _ in range(3))
        scale = 1.0 / H ** 0.5
        out, lse = fa.flash_attention_with_lse(q, k, v, scale, causal)
        torch.cuda.synchronize()
        ref_out, ref_lse = fa.flash_attention_ref(q, k, v, scale, causal,
                                                  with_lse=True)
        err = held(out, ref_out, dname)
        lse_err = (lse - ref_lse).abs().max().item()
        del ref_out, ref_lse
        checks.append({"case": label, "shape": [B, T, N, H], "causal": causal,
                       "dtype": dname, "layout": layout,
                       "tol": ELEM_TOL[dname], "lse_max_abs_err": lse_err,
                       "held": {"out": err}})
        if not err["ratio"] <= 1.0:
            failed.append(f"K1 {label} out: {err}")
        if not lse_err <= 1e-4:
            failed.append(f"K1 {label} lse: max abs error {lse_err} > 1e-4")
        if label == "long":
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            bound, bound_by = attention_bound_ms(q, k, causal, 2, 4, 1)
            timing = {
                "shape": [B, T, N, H], "dtype": dname,
                "ms": time_ms(lambda: fa.flash_attention_with_lse(
                    q, k, v, scale, causal), reps=10),
                "plain_ms": time_ms(lambda: fa.flash_attention_ref(
                    q, k, v, scale, causal, with_lse=True), reps=3),
                "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=causal, scale=scale), reps=10),
                "bound_ms": bound, "bound_by": bound_by}
        del q, k, v, out, lse
        torch.cuda.empty_cache()
    return {"checks": checks, "long": timing}, failed


# K1-bwd at phase 17's no-mesh call (BERT-base at 8 x 4096, bf16, full
# mask): held at batch 1 (the plain backward at batch 8 takes tens of
# GB), timed at batch 8 beside SDPA's backward
K1_BWD_LONG = (8, 4096, 12, 64)


def _k1_bwd_long():
    """K1-bwd's launches at T 4096 against their plain versions at B 1
    (per element under ELEM_TOL), then the whole backward (two launches,
    and the three-launch form) and its dkv and dq launches (dq folding
    the delta pass in, and given delta) timed at B 8 beside SDPA's
    backward."""
    import torch

    from paddle_tpu_torch.kernels import flash_attention as fa

    B, T, N, H = K1_BWD_LONG
    gen = torch.Generator(device="cuda").manual_seed(7)
    failed = []
    case, errs, lse_err = _training_kernel_case(fa, 1, T, False, "bfloat16",
                                                gen, N, H)
    del case
    torch.cuda.empty_cache()
    failed += failed_checks("K1 long", errs)
    if not lse_err <= 1e-4:
        failed.append(f"K1 long lse: max abs error {lse_err} > 1e-4")
    scale = 1.0 / H ** 0.5
    q, k, v, do = (torch.randn(B, T, N, H, generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(4))
    out, lse = fa.flash_attention_with_lse(q, k, v, scale, False)
    _, delta = fa.flash_attention_bwd_dq(q, k, v, do, lse, None, scale,
                                         False, o=out)
    timing = {
        "shape": [B, T, N, H], "dtype": "bfloat16",
        "ms": time_ms(lambda: fa.flash_attention_bwd(
            q, k, v, out, lse, do, scale, False), reps=10),
        "three_launch_ms": time_ms(lambda: _k1_bwd_three_launches(
            fa, q, k, v, out, lse, do, scale, False), reps=10),
        "dkv_ms": time_ms(lambda: fa.flash_attention_bwd_dkv(
            q, k, v, do, lse, delta, scale, False), reps=10),
        "dq_ms": time_ms(lambda: fa.flash_attention_bwd_dq(
            q, k, v, do, lse, None, scale, False, o=out), reps=10),
        "dq_external_ms": time_ms(lambda: fa.flash_attention_bwd_dq(
            q, k, v, do, lse, delta, scale, False), reps=10),
        "library_ms": _sdpa_bwd_ms(q, k, v, do, False, scale, reps=10),
        "bound": attention_bound_ms(q, k, False, 5, 8, 2)}
    del q, k, v, do, out, lse, delta
    torch.cuda.empty_cache()
    return {"checks": {"shape": [1, T, N, H], "lse_max_abs_err": lse_err,
                       "held": errs}, "timing": timing}, failed


# K2 at the main paths' shapes: (label, B, Tq, Tk, N, H, causal, dtype,
# bias, limit). "nmt" is Transformer-big's encoder self- and
# cross-attention (key padding from make_batch's src_len), "beam" the
# beam search's cross-attention (8 sources x 4 beams, 32 target positions
# against 128 source keys), "bert512" padded BERT-base (lengths uniform
# in [256, 512], BERT's bf16 fill of -3e4); then causal with a full
# [B, N, T, T] bias at f32 and f16, a ragged pair, the bias gradient at
# f32, head_dim 128 with 300 keys, the bias gradient at bf16 (the
# Hopper dq writes it), and last phase 25's per-rank block of the
# "nmt" calls under dp=2 tp=2 ("nmt_dp2tp2"). The first three and the
# last are timed. Outputs and gradients are held under ELEM_TOL, or under the
# limit the case names (ROADMAP F4: K2's f16 causal case).
K2_KERNEL_CASES = (
    ("nmt", 128, 128, 128, 16, 64, False, "bfloat16", "src_len", None),
    ("beam", 32, 32, 128, 16, 64, False, "bfloat16", "src_len", None),
    ("bert512", 32, 512, 512, 12, 64, False, "bfloat16", "bert", None),
    ("causal_f32", 2, 256, 256, 12, 64, True, "float32", "full", None),
    ("causal_f16", 4, 128, 128, 12, 64, True, "float16", "full",
     ATTN_F16_TOL),
    ("ragged", 2, 100, 164, 12, 64, False, "bfloat16", "src_len", None),
    ("dbias", 2, 128, 128, 4, 64, False, "float32", "full", None),
    ("h128_ragged", 4, 256, 300, 8, 128, False, "bfloat16", "src_len",
     None),
    ("dbias_bf16", 2, 128, 128, 4, 64, False, "bfloat16", "full", None),
    ("nmt_dp2tp2", 64, 128, 128, 8, 64, False, "bfloat16", "src_len",
     None))
K2_TIMED = ("nmt", "beam", "bert512", "nmt_dp2tp2")
# the per-rank shape whose times the kernels line carries beside each
# attention kernel's main one: Transformer-big under dp=2 tp=2
PER_RANK_SHAPE = "nmt_dp2tp2"
# traced steps a K2 phase may take to see every K2 launch (`_train_run`)
TRACE_TRIES = 3
# each K2 launch's kernels by the name the profiler shows: the Hopper one
# (bf16, f16) and the FMA one (f32)
K2_ROUTES = {
    "flash_attention_bias_fwd": {"sm90": "flash_bias_fwd_sm90_kernel",
                                 "fma": "flash_bias_fwd_kernel"},
    "flash_attention_bias_bwd_dkv": {"sm90": "flash_bias_bwd_dkv_sm90_kernel",
                                     "fma": "flash_bias_bwd_dkv_kernel"},
    "flash_attention_bias_bwd_dq": {"sm90": "flash_bias_bwd_dq_sm90_kernel",
                                    "fma": "flash_bias_bwd_dq_kernel"}}


def k2_bound_ms(q, k, bias, causal, products, q_tensors, k_tensors, rows,
                extra_bytes=0):
    """Least time for K2 work on these inputs: `q_tensors` tensors of
    q's size and `k_tensors` of k's read or written once, the bias as
    the kernel reads it (its own elements, not the broadcast), `rows`
    f32 rows of [B, N, Tq] (l, m, delta) and `extra_bytes`, over the
    memory rate, against `products` matrix products of 2 * pairs * H
    per (batch, head) over the peak rate of q's dtype."""
    import torch

    B, Tq, N, H = q.shape
    Tk = k.shape[1]
    pairs = sum(min(t + 1, Tk) for t in range(Tq)) if causal else Tq * Tk
    nbytes = ((q_tensors * q.numel() + k_tensors * k.numel()) *
              q.element_size() + bias.numel() * 4 + rows * B * N * Tq * 4 +
              extra_bytes)
    flops = products * 2 * B * N * H * pairs
    peak = F32_FLOPS_PER_S if q.dtype == torch.float32 \
        else bf16_flops_per_s()
    return bound_ms(nbytes, flops, peak)


def _k2_inputs(B, Tq, Tk, N, dname, kind, gen, H=64):
    """q, k, v, do [B, T, N, H] and the bias: a [B, 1, 1, Tk] key mask
    (-1e9 past make_batch-style lengths, or BERT's -3e4 past lengths in
    [256, 512]) or a full [B, N, Tq, Tk] f32 bias."""
    import torch

    from paddle_tpu_torch.models import transformer

    dtype = getattr(torch, dname)
    q, k, v = (torch.randn(B, t, N, H, generator=gen, device="cuda")
               .to(dtype) for t in (Tq, Tk, Tk))
    do = torch.randn(B, Tq, N, H, generator=gen, device="cuda").to(dtype)
    if kind == "full":
        return q, k, v, do, torch.randn(B, N, Tq, Tk, generator=gen,
                                        device="cuda")
    if kind == "bert":
        lens, fill = torch.randint(256, 513, (B,), generator=gen,
                                   device="cuda"), -3e4
    else:   # the beam search repeats each source's length per beam
        beams = 4 if B == 32 and Tq == 32 else 1
        cfg = transformer.TransformerConfig(src_vocab=8, tgt_vocab=8)
        lens = transformer.make_batch(gen, cfg, B // beams, src_T=Tk,
                                      tgt_T=Tq)["src_len"] \
            .repeat_interleave(beams)
        fill = -1e9
    keep = torch.arange(Tk, device="cuda")[None] < lens[:, None]
    return q, k, v, do, torch.where(keep, 0.0, fill)[:, None, None, :]


def _k2_timings(fa, fb, case):
    """ms, plain_ms, library_ms and the bound of K2-fwd, its dkv and dq
    launches (dq folding the delta pass in; given delta beside it) and
    the whole backward (two launches: dq, then dkv; the three-launch form
    with the standalone delta beside it) at one case."""
    import torch
    import torch.nn.functional as F

    q, k, v, do, bias, out, l, m, delta, scale = case
    args = (q, k, v, bias, do, l, m, delta, scale, False)
    qt, kt, vt = (t.detach().transpose(1, 2) for t in (q, k, v))
    # SDPA adds its mask after the scale, K2 its bias before
    amask = (bias * scale).to(q.dtype)

    def folded_dq():
        return fb.flash_attention_bias_bwd_dq(q, k, v, bias, do, l, m, None,
                                              scale, False, o=out)

    def whole():
        dq, d = folded_dq()
        return dq, fb.flash_attention_bias_bwd_dkv(q, k, v, bias, do, l, m, d,
                                                   scale, False)

    def whole_three():
        d = fa.attention_delta(out, do)
        a = (q, k, v, bias, do, l, m, d, scale, False)
        return fb.flash_attention_bias_bwd_dq(*a), \
            fb.flash_attention_bias_bwd_dkv(*a)

    def whole_ref():
        dq, d = fb.flash_attention_bias_bwd_dq_ref(q, k, v, bias, do, l, m,
                                                   None, scale, False, o=out)
        return dq, fb.flash_attention_bias_bwd_dkv_ref(q, k, v, bias, do, l,
                                                       m, d, scale, False)

    qg, kg, vg = (t.clone().requires_grad_() for t in (qt, kt, vt))
    sdpa_out = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=amask,
                                              scale=scale)
    dot = do.transpose(1, 2)
    return {
        "fwd": {"ms": time_ms(lambda: fb.flash_attention_bias_fwd(
                    q, k, v, bias, scale)),
                "plain_ms": time_ms(lambda: fb.flash_attention_bias_ref(
                    q, k, v, bias, scale)),
                "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=amask, scale=scale)),
                "bound": k2_bound_ms(q, k, bias, False, 2, 2, 2, 2)},
        "dkv": {"ms": time_ms(lambda: fb.flash_attention_bias_bwd_dkv(*args)),
                "plain_ms": time_ms(
                    lambda: fb.flash_attention_bias_bwd_dkv_ref(*args)),
                "library_ms": None,
                "bound": k2_bound_ms(q, k, bias, False, 4, 2, 4, 3)},
        # dq as the main path runs it, folding the delta pass in: q, dO
        # and o read and dq written, k and v read, l and m read and
        # delta written
        "dq": {"ms": time_ms(folded_dq),
               "external_ms": time_ms(
                   lambda: fb.flash_attention_bias_bwd_dq(*args)),
               "plain_ms": time_ms(
                   lambda: fb.flash_attention_bias_bwd_dq_ref(
                       q, k, v, bias, do, l, m, None, scale, False, o=out)),
               "library_ms": None,
               "bound": k2_bound_ms(q, k, bias, False, 3, 4, 2, 3)},
        "bwd_whole": {
            "ms": time_ms(whole), "three_launch_ms": time_ms(whole_three),
            "plain_ms": time_ms(whole_ref),
            "library_ms": time_ms(lambda: torch.autograd.grad(
                sdpa_out, (qg, kg, vg), dot, retain_graph=True)),
            "bound": k2_bound_ms(q, k, bias, False, 5, 4, 4, 2)}}


def k2_case(B, Tq, Tk, N, H, causal, dname, kind, gen, tol=None,
            with_dbias=False, scale=0.125):
    """One K2 case: K2-fwd and K2-bwd's launches (dq with the bias
    gradient when asked) against their plain versions, per element under
    ELEM_TOL (or `tol`; the bias gradient under f32's): dq given the
    output (at bf16 and f16 its kernel computes delta in its prologue),
    dkv from that delta, the external-delta dq launch given the same
    delta (bit for bit the folded one's dq and dbias:
    "equal_to_folded"), each delta (folded, and the standalone launch)
    under f32's; l and m as the same f32 sums in another order. Returns
    the inputs and outputs (q, k, v, do, bias, out, l, m, delta, scale),
    the readings by output and {l_rel_err, m_max_abs_err}."""
    import torch

    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import flash_attention_bias as fb

    q, k, v, do, bias = _k2_inputs(B, Tq, Tk, N, dname, kind, gen, H)
    out, l, m = fb.flash_attention_bias_fwd(q, k, v, bias, scale, causal)
    *dq, delta = fb.flash_attention_bias_bwd_dq(
        q, k, v, bias, do, l, m, None, scale, causal, with_dbias=with_dbias,
        o=out)
    args = (q, k, v, bias, do, l, m, delta, scale, causal)
    dk, dv = fb.flash_attention_bias_bwd_dkv(*args)
    external = fb.flash_attention_bias_bwd_dq(*args, with_dbias=with_dbias)
    external = external if with_dbias else (external,)
    standalone = fa.attention_delta(out, do)
    torch.cuda.synchronize()
    ref_out, ref_l, ref_m = fb.flash_attention_bias_ref(
        q, k, v, bias, scale, causal)
    ref_dk, ref_dv = fb.flash_attention_bias_bwd_dkv_ref(*args)
    ref_dq = fb.flash_attention_bias_bwd_dq_ref(*args, with_dbias=with_dbias)
    ref_dq = ref_dq if with_dbias else (ref_dq,)
    ref_delta = fa.attention_delta_ref(out, do)
    errs = {"out": held(out, ref_out, dname, tol),
            "delta": held(delta, ref_delta, "float32"),
            "delta_standalone": held(standalone, ref_delta, "float32"),
            "dk": held(dk, ref_dk, dname, tol),
            "dv": held(dv, ref_dv, dname, tol),
            "dq": held(dq[0], ref_dq[0], dname, tol),
            "dq_external": {**held(external[0], ref_dq[0], dname, tol),
                            "equal_to_folded": all(
                                torch.equal(a, b)
                                for a, b in zip(external, dq))}}
    if with_dbias:
        errs["dbias"] = held(dq[1], ref_dq[1], "float32")
    # l and m: the same f32 sums and maxima in another order
    lm = {"l_rel_err": ((l - ref_l).abs() / ref_l).max().item(),
          "m_max_abs_err": (m - ref_m).abs().max().item()}
    return (q, k, v, do, bias, out, l, m, delta, scale), errs, lm


def _k2_kernel_rows():
    """K2-fwd and K2-bwd's dkv and dq launches against their plain
    versions at every case (`k2_case`), and their times at the timed
    cases. Returns the kernel rows, every case's readings, the whole
    backward's times and the failed checks."""
    import torch

    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import flash_attention_bias as fb

    gen = torch.Generator(device="cuda").manual_seed(5)
    checks, timings, failed = [], {}, []
    for label, B, Tq, Tk, N, H, causal, dname, kind, tol in K2_KERNEL_CASES:
        case, errs, lm = k2_case(B, Tq, Tk, N, H, causal, dname, kind, gen,
                                 tol, with_dbias=label.startswith("dbias"))
        checks.append({"case": label, "shape": [B, Tq, Tk, N, H],
                       "causal": causal, "dtype": dname, "bias": kind,
                       "tol": tol or ELEM_TOL[dname], **lm, "held": errs})
        failed += failed_checks(f"K2 {label}", errs)
        if not (lm["l_rel_err"] <= 1e-5 and lm["m_max_abs_err"] <= 1e-4):
            failed.append(f"K2 {label} l/m: {lm}")
        if label in K2_TIMED:
            timings[label] = {"shape": [B, Tq, Tk, N, H],
                              **_k2_timings(fa, fb, case)}
    bf16 = [c for c in checks if c["dtype"] == "bfloat16"]

    def worst(*names):
        return max(c["held"][n]["max_abs_err"] for c in bf16 for n in names)

    rows = []
    for name, key, err, replaces in (
            ("flash_attention_bias_fwd", "fwd", worst("out"),
             "K2 attention.py:_pallas_mha flash_attention fwd"),
            ("flash_attention_bias_bwd_dkv", "dkv", worst("dk", "dv"),
             "K2 flash_attention _flash_attention_bwd_dkv"),
            ("flash_attention_bias_bwd_dq", "dq", worst("dq"),
             "K2 flash_attention _flash_attention_bwd_dq")):
        rows.append({"name": name, "replaces": replaces, "max_abs_err": err,
                     "kernels": K2_ROUTES[name],
                     "timings": {label: t[key]
                                 for label, t in timings.items()}})
    whole = {label: t["bwd_whole"] for label, t in timings.items()}
    return rows, checks, whole, failed


# K3 (the ring's block, `splash_block_with_lse`): (label, B, T, dtype).
# "ring" is phase 17's block, BERT-base at T 4096 over an sp=4 ring
# (1024 queries against 1024 keys, bf16, q pre-scaled); then one f32
# and one f16 shape. The first is timed.
# K3: (label, B, T, N, dtype); "ring" is phase 17's block (timed),
# "dp2tp2sp2" phase 25's per-rank block (BERT-base 128 x 256 under
# dp=2 tp=2 sp=2: [128 / 2, 256 / 2, 12 / 2, 64]).
K3_KERNEL_CASES = (("ring", 8, 1024, 12, "bfloat16"),
                   ("f32", 2, 512, 12, "float32"),
                   ("f16", 4, 1024, 12, "float16"),
                   ("dp2tp2sp2", 64, 128, 6, "bfloat16"))


def _k3_kernel_row():
    """K3 against its plain version per element (`ELEM_TOL`) at every
    case, its LSE within 1e-4, and its times at the ring's block."""
    import torch
    import torch.nn.functional as F

    from paddle_tpu_torch.kernels import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(17)
    checks, failed, timing = [], [], None
    for label, B, T, N, dname in K3_KERNEL_CASES:
        dtype = getattr(torch, dname)
        q, k, v = (torch.randn(B, T, N, 64, generator=gen, device="cuda")
                   .to(dtype) for _ in range(3))
        q = q * torch.tensor(0.125, dtype=dtype)   # pre-scaled, as the ring
        out, lse = fa.splash_block_with_lse(q, k, v)
        torch.cuda.synchronize()
        ref_out, ref_lse = fa.splash_block_with_lse_ref(q, k, v)
        err = held(out, ref_out, dname)
        lse_err = (lse - ref_lse).abs().max().item()
        checks.append({"case": label, "shape": [B, T, N, 64],
                       "dtype": dname, "tol": ELEM_TOL[dname],
                       "lse_max_abs_err": lse_err, "held": {"out": err}})
        if not err["ratio"] <= 1.0:
            failed.append(f"K3 {label} out: {err}")
        if not lse_err <= 1e-4:
            failed.append(f"K3 {label} lse: max abs error {lse_err} > 1e-4")
        if label in ("ring", "dp2tp2sp2"):
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            bound, bound_by = attention_bound_ms(q, k, False, 2, 4, 1)
            timed = {
                "shape": [B, T, N, 64], "dtype": dname,
                "ms": time_ms(lambda: fa.splash_block_with_lse(q, k, v)),
                "plain_ms": time_ms(
                    lambda: fa.splash_block_with_lse_ref(q, k, v)),
                "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, scale=1.0)),
                "bound_ms": bound, "bound_by": bound_by,
                "max_abs_err": err["max_abs_err"]}
            if label == "ring":
                timing = timed
            else:
                checks[-1]["timed"] = timed
    return {"name": "splash_block_with_lse",
            "replaces": "K3 attention.py:_splash_block_with_lse (ring block)",
            "checks": checks, **timing}, failed


# K4-K6 (the fused matmul+BN kernels): (kernel, label, M, K, N, dtype,
# relu). K4 is conv1 and K6 conv3 of a ResNet-50 bottleneck at bs 256,
# 224 x 224 (M = B*H*W), one shape of each stage group g0-g3; K5 is
# phase 13's second product (M 50176, C 256 -> 1024) and runs at K6's
# shapes too. Then f32, f16 and f64 at one shape, a ragged shape at
# every dtype, the ReLU off, and a shape whose K and N are not multiples
# of 8 ("unaligned": TMA cannot read it in place, so it takes the padded
# route, `fused_dense_bn.kernel_route`). The bf16 main-path shapes are
# timed.
FDB_GROUPS = {"k4": ((802816, 256, 64), (200704, 512, 128),
                     (50176, 1024, 256), (12544, 2048, 512)),
              "k6": ((802816, 64, 256), (200704, 128, 512),
                     (50176, 256, 1024), (12544, 512, 2048))}
FDB_GROUPS["k5"] = FDB_GROUPS["k6"]
FDB_KERNEL_CASES = tuple(
    [(k, f"g{i}", *shape, "bfloat16", True)
     for k in ("k4", "k5", "k6") for i, shape in enumerate(FDB_GROUPS[k])] +
    [(k, dt, 12544, 256, 256, dt, True) for k in ("k4", "k5", "k6")
     for dt in ("float32", "float16", "float64")] +
    [(k, f"ragged_{dt}", 1000, 72, 40, dt, True) for k in ("k4", "k5", "k6")
     for dt in ("bfloat16", "float32", "float16", "float64")] +
    [(k, "norelu", 12544, 256, 256, "bfloat16", False) for k in ("k5", "k6")] +
    [(k, "ragged_norelu", 1000, 72, 40, "bfloat16", False)
     for k in ("k5", "k6")] +
    [(k, "unaligned", 1000, 70, 36, "bfloat16", True)
     for k in ("k4", "k5", "k6")])
# the row of the kernels line: the mid stage's shape (g2), K5 at phase
# 13's product
FDB_LINE_SHAPE = "g2"
FDB_NAMES = {"k4": "matmul_stats_fwd", "k5": "bn_act_matmul_fwd",
             "k6": "bn_act_matmul_stats_fwd"}
FDB_REPLACES = {"k4": "paddle_tpu/ops/pallas/fused_dense_bn.py:80",
                "k5": "paddle_tpu/ops/pallas/fused_dense_bn.py:152",
                "k6": "paddle_tpu/ops/pallas/fused_dense_bn.py:254"}
# mean and var against the scale of the summed values, E[y^2]: the
# kernel sums the same accumulator in another order, which moves a sum
# of M terms by a few steps of that scale whatever the mean's own size
STATS_TOL = {"float32": 1e-5, "float64": 1e-12}


def fdb_bound_ms(M, K, N, dtype, prologue, stats):
    """Least time for one K4-K6 call: x, w and y read or written once,
    scale and shift (f32 or f64 [K]) and the partial sums ([M / BM, N],
    two rows of the accumulator's dtype) over the memory rate, against
    the product's 2 M K N operations over the dtype's peak (the
    prologue's 3 M K are not counted)."""
    import torch

    from paddle_tpu_torch.kernels import fused_dense_bn as fdb

    es = torch.tensor([], dtype=dtype).element_size()
    acc = 8 if dtype == torch.float64 else 4
    nbytes = (M * K + K * N + M * N) * es
    if prologue:
        nbytes += 2 * K * acc
    if stats:
        nbytes += 2 * -(-M // fdb.block_m(dtype)) * N * acc
    peak = bf16_flops_per_s() if dtype in (torch.bfloat16, torch.float16) \
        else F32_FLOPS_PER_S
    return bound_ms(nbytes, 2 * M * K * N, peak)


def _fdb_case(fdb, kernel, M, K, N, dname, relu, gen):
    """Inputs of one case and its readings: y per element under
    ELEM_TOL, mean and var under STATS_TOL."""
    import torch

    dtype = getattr(torch, dname)
    acc = torch.float64 if dtype == torch.float64 else torch.float32
    x = torch.randn(M, K, generator=gen, device="cuda").to(dtype)
    w = (torch.randn(K, N, generator=gen, device="cuda") / K ** 0.5) \
        .to(dtype)
    args = (x, w)
    if kernel != "k4":
        scale = torch.rand(K, generator=gen, device="cuda", dtype=acc) + 0.5
        shift = torch.randn(K, generator=gen, device="cuda", dtype=acc) * 0.5
        args = (x, scale, shift, w)
    kw = {} if kernel == "k4" else {"relu": relu}
    fn = getattr(fdb, FDB_NAMES[kernel])
    ref = {"k4": fdb.mm_stats_ref, "k5": fdb.bn_mm_ref,
           "k6": fdb.bn_mm_stats_ref}[kernel]
    got = fn(*args, **kw)
    torch.cuda.synchronize()
    want = ref(*args, **kw)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    errs = {"y": held(got[0], want[0], dname)}
    if len(got) == 3:
        tol = STATS_TOL["float64" if dtype == torch.float64 else "float32"]
        mean, var = want[1].double(), want[2].double()
        ey2 = var + mean * mean
        errs["mean_ratio"] = ((got[1].double() - mean).abs() /
                              (tol * (mean.abs() + ey2.sqrt()))).max().item()
        errs["var_ratio"] = ((got[2].double() - var).abs() /
                             (tol * (var.abs() + ey2))).max().item()
    return (fn, ref, args, kw), errs


def _fdb_kernel_rows():
    """K4, K5 and K6 against their plain versions at every case, and
    their times at the timed ones. Returns the kernel rows, every case's
    readings and the failed checks."""
    import torch

    from paddle_tpu_torch.kernels import fused_dense_bn as fdb

    gen = torch.Generator(device="cuda").manual_seed(12)
    checks, timings, failed = [], {"k4": {}, "k5": {}, "k6": {}}, []
    for kernel, label, M, K, N, dname, relu in FDB_KERNEL_CASES:
        (fn, ref, args, kw), errs = _fdb_case(fdb, kernel, M, K, N, dname,
                                              relu, gen)
        x, w = args[0], args[-1]
        checks.append({"kernel": kernel, "case": label, "shape": [M, K, N],
                       "dtype": dname, "relu": relu, "tol": ELEM_TOL[dname],
                       "route": fdb.kernel_route(K, N, x.dtype, x.data_ptr(),
                                                 w.data_ptr()),
                       "held": errs})
        ratios = [errs["y"]["ratio"]] + [errs[k] for k in
                                         ("mean_ratio", "var_ratio")
                                         if k in errs]
        if not all(r <= 1.0 for r in ratios):
            failed.append(f"{kernel} {label}: {errs}")
        if dname == "bfloat16" and label.startswith("g"):
            bound = fdb_bound_ms(M, K, N, x.dtype, kernel != "k4",
                                 kernel != "k5")
            timings[kernel][label] = {
                "shape": [M, K, N], "ms": time_ms(lambda: fn(*args, **kw)),
                "plain_ms": time_ms(lambda: ref(*args, **kw)),
                # cuBLAS's bf16 product alone: no one PyTorch call
                # computes the fused function, and the product is its floor
                "library_ms": time_ms(lambda: torch.matmul(x, w)),
                "bound": bound}
        del args, x, w
    check(all(c["route"] == "padded" for c in checks
              if c["case"] == "unaligned"),
          "K4-K6: a shape TMA cannot read did not take the padded route")
    rows = []
    for kernel in ("k4", "k5", "k6"):
        bf16 = [c for c in checks if c["kernel"] == kernel and
                c["dtype"] == "bfloat16"]
        rows.append({"name": FDB_NAMES[kernel], "kernel": kernel.upper(),
                     "replaces": FDB_REPLACES[kernel],
                     "max_abs_err": max(c["held"]["y"]["max_abs_err"]
                                        for c in bf16),
                     "library": "torch.matmul (cuBLAS product only)",
                     "timings": timings[kernel]})
    return rows, checks, failed


def phase_kernels():
    serving = _serving_kernel_row()
    training, checks, whole, failed = _training_kernel_rows()
    k2_rows, k2_checks, k2_whole, k2_failed = _k2_kernel_rows()
    k3_row, k3_failed = _k3_kernel_row()
    k1_fwd, k1_fwd_failed = _k1_fwd_rows()
    k1_bwd_long, k1_bwd_long_failed = _k1_bwd_long()
    t0 = time.perf_counter()
    fdb_rows, fdb_checks, fdb_failed = _fdb_kernel_rows()
    print(json.dumps({"phase": "kernels",
                      "kernels": [serving] + training + k2_rows + [k3_row] +
                      fdb_rows,
                      "bwd_whole": whole, "training_checks": checks,
                      "k1_fwd": k1_fwd, "k1_bwd_long": k1_bwd_long,
                      "k2_bwd_whole": k2_whole, "k2_checks": k2_checks,
                      "fdb_checks": fdb_checks,
                      "fdb_s": time.perf_counter() - t0}))
    failed += (k2_failed + k3_failed + k1_fwd_failed + k1_bwd_long_failed +
               fdb_failed)
    check(not failed, "kernel against its plain version: " +
          "; ".join(failed))
    return serving, training, k2_rows, k3_row, fdb_rows


def _generate(port, ids, max_new, out, tenant=None, model=None):
    """One streamed /v1/generate, for `tenant` and `model` where given;
    fills `out` with the token lines, the done record and the
    client-side time to the first token, or with a refusal's status,
    body and Retry-After."""
    payload = {"ids": [int(i) for i in ids], "max_new_tokens": max_new}
    if tenant is not None:
        payload["tenant"] = tenant
    if model is not None:
        payload["model"] = model
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/generate",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    toks, done = [], None
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            for line in r:
                if not line.strip():
                    continue
                rec = json.loads(line)
                if "token" in rec:
                    if not toks:
                        out["ttft_s"] = time.perf_counter() - t0
                    toks.append(rec["token"])
                else:
                    done = rec
    except urllib.error.HTTPError as e:
        out.update(code=e.code, body=json.loads(e.read()),
                   retry_after=e.headers.get("Retry-After"))
    except Exception as e:  # reported and checked by the caller
        out["error"] = f"{type(e).__name__}: {e}"
    out["tokens"], out["done"] = toks, done


def _http_round(port, prompts, max_new, tenants=None, model=None):
    """Every prompt as one concurrent streamed /v1/generate (prompt i
    for `tenants[i]` where given): each request's `_generate` record,
    and the round's wall seconds."""
    tenants = tenants or [None] * len(prompts)
    results = [{} for _ in prompts]
    threads = [threading.Thread(target=_generate, daemon=True,
                                args=(port, p, max_new, out, t, model))
               for p, t, out in zip(prompts, tenants, results)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    return results, time.perf_counter() - t0


def _round_summary(results, secs):
    """Tokens, tokens/s and client TTFT p50/max of one `_http_round`."""
    ttft = sorted(out["ttft_s"] * 1e3 for out in results)
    n_tok = sum(len(out["tokens"]) for out in results)
    return {"tokens": n_tok, "wall_s": secs, "tokens_per_s": n_tok / secs,
            "ttft_p50_ms": statistics.median(ttft), "ttft_max_ms": ttft[-1]}


SLICE_LENGTHS = (5, 17, 60, 130, 300, 513, 900, 1000)
SLICE_NEW_TOKENS = 24


def _slice_setup():
    """GPT-2-small (seeded random weights) in a bf16 engine, and the
    slice's prompts: one per prefill bucket from 8 to 1024."""
    import torch

    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.serving import DecodeConfig, DecodeEngine

    cfg = gpt.GPTConfig()                       # GPT-2-small, bf16
    params, _ = gpt.init(torch.Generator(device="cuda").manual_seed(0),
                         cfg, device="cuda")
    engine = DecodeEngine(params, cfg, DecodeConfig(
        block_size=16, num_blocks=512, decode_slots=(4, 8)), device="cuda")
    rs = np.random.RandomState(0)
    prompts = [rs.randint(0, cfg.vocab_size, size=n) for n in SLICE_LENGTHS]
    return cfg, engine, prompts


def phase_slice():
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.ops import attention as attn
    from paddle_tpu_torch.serving import Server, ServingConfig

    cfg, engine, prompts = _slice_setup()
    lengths, max_new = list(SLICE_LENGTHS), SLICE_NEW_TOKENS
    server = Server(ServingConfig(), decode=engine)
    t0 = time.perf_counter()
    port = server.start(0)                      # warms, then binds
    start_s = time.perf_counter() - t0
    try:
        ops = _serving_routes(port, engine)

        fa.flash_attention.launches = 0
        attn.GATE_COUNTS.clear()
        results, wall = _http_round(port, prompts, max_new)
        launches = fa.flash_attention.launches
        gates = dict(attn.GATE_COUNTS)
        # the same requests again: every shape is now warm in-process
        repeat, repeat_wall = _http_round(port, prompts, max_new)
        status = engine.status()
    finally:
        server.stop()
    for n, out in zip(lengths + lengths, results + repeat):
        check("error" not in out, f"prompt {n}: {out.get('error')}")
        toks = out["tokens"]
        check(len(toks) == max_new, f"prompt {n}: {len(toks)} tokens")
        check(all(0 <= t < cfg.vocab_size for t in toks),
              f"prompt {n}: token out of range")
        check(out["done"] and out["done"].get("done")
              and out["done"].get("finish_reason") == "length",
              f"prompt {n}: done record {out['done']}")
    check(launches >= cfg.layers * len(lengths),
          f"{launches} kernel launches < {cfg.layers} x {len(lengths)}")
    check(gates.get("plain", 0) == 0, f"plain attention ran: {gates}")
    steps = status["decode_steps"]
    check(steps["eager"] == 0 and steps["replayed"] > 0,
          f"slice: decode steps of the warmed engine {steps}")

    row = {"phase": "slice", "model": "GPT-2-small (GPTConfig())",
           "precision": "bf16", "requests": len(lengths),
           "prompt_lengths": lengths, **_round_summary(results, wall),
           "repeat": _round_summary(repeat, repeat_wall),
           "launches": {"flash_attention_fwd": launches},
           "gate_counts": gates,
           "preempted": status["requests"]["preempted"],
           "start_s": start_s, "decode_steps": steps, "routes": ops}
    print(json.dumps(row))
    return launches


def _get_json(port, path):
    """(status, JSON body, headers) of one GET on the serving port."""
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=60) as r:
            return r.status, json.loads(r.read()), r.headers
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), e.headers


def _serving_routes(port, engine):
    """The warmed server's operations surface: /v1/healthz 200
    "serving", /v1/load and /v1/models with the JAX server's keys, each
    reply with its request id and traceparent."""
    code, health, hdrs = _get_json(port, "/v1/healthz")
    check(code == 200 and health.get("state") == "serving",
          f"/v1/healthz: {code} {health}")
    check(len(hdrs.get("X-Request-Id", "")) == 32 and
          hdrs.get("traceparent", "").startswith("00-"),
          f"/v1/healthz headers: {dict(hdrs)}")
    code, load, _ = _get_json(port, "/v1/load")
    check(code == 200 and set(load) == {"load", "inflight", "queue_depth",
                                        "state", "models"}
          and load["state"] == "serving" and load["models"] == ["default"],
          f"/v1/load: {code} {load}")
    t0 = time.perf_counter()
    code, models, _ = _get_json(port, "/v1/models")
    models_s = time.perf_counter() - t0
    rows = models.get("models") or [{}]
    check(code == 200 and len(rows) == 1 and rows[0].get("id") == "default"
          and rows[0].get("decode", {}).get("warmed") is True
          and len(rows[0]["decode"].get("digest", "")) == 64,
          f"/v1/models: {code} {models}")
    status = engine.status()
    check(status["warmed"] and status["analysis"]["errors"] == 0,
          f"engine status: {status}")
    return {"healthz": health, "load": load, "models": rows,
            "models_s": models_s, "analysis": status["analysis"]}


def _fdb_kernel(name):
    """"k4", "k5" or "k6" for a fused matmul+BN kernel's profiler name
    (its template flags: prologue, stats), else None."""
    if "fused_mm_bn" not in name:
        return None
    flags = ("true, true", "true, false", "false, true")
    mangled = ("Lb1ELb1E", "Lb1ELb0E", "Lb0ELb1E")
    for kern, f, m in zip(("k6", "k5", "k4"), flags, mangled):
        if f in name or m in name:
            return kern
    return None


def _device_time(prof, wall_s):
    """From a torch.profiler run over `wall_s` seconds: the device's
    busy time (the union of its kernel intervals), idle share, K1's,
    K2's and K4-K6's kernel time by kernel and the ten largest kernels
    by name."""
    from torch.autograd import DeviceType

    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        spans.append((e.time_range.start, e.time_range.end))
        tot = by_name.setdefault(e.name, [0, 0.0])
        tot[0] += 1
        tot[1] += (e.time_range.end - e.time_range.start) / 1e3
    busy_us, last = 0.0, None
    for a, b in sorted(spans):          # union of the device intervals
        if last is None or a > last:
            busy_us += b - a
            last = b
        elif b > last:
            busy_us += b - last
            last = b
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
    busy_ms = busy_us / 1e3 if spans else None
    # the FMA kernels (f32) and the Hopper ones (bf16, f16): device ms,
    # and K2's launches, by kernel
    k1, k2 = ({kern: sum(t[1] for n, t in by_name.items() if kern in n)
               for kern in kerns} for kerns in (
        ("flash_fwd_kernel", "flash_fwd_sm90_kernel", "delta_kernel",
         "flash_bwd_dkv_kernel", "flash_bwd_dq_kernel",
         "flash_bwd_dkv_sm90_kernel", "flash_bwd_dq_sm90_kernel"),
        [kern for r in K2_ROUTES.values() for kern in r.values()]))
    k2_n = {kern: sum(t[0] for n, t in by_name.items() if kern in n)
            for kern in k2}
    delta_n = sum(t[0] for n, t in by_name.items() if "delta_kernel" in n)
    fdb = {"k4": 0.0, "k5": 0.0, "k6": 0.0}
    for n, t in by_name.items():
        kern = _fdb_kernel(n)
        if kern:
            fdb[kern] += t[1]
    return {"device_events": len(spans), "device_busy_ms": busy_ms,
            "device_idle_share": (1 - busy_ms / (wall_s * 1e3))
            if spans else None,
            "flash_attention_ms": k1["flash_fwd_kernel"] +
            k1["flash_fwd_sm90_kernel"],
            "k1_kernel_ms": k1, "k2_kernel_ms": k2, "k2_kernel_launches": k2_n,
            "delta_kernel_records": delta_n,
            "k4_k6_kernel_ms": fdb,
            "top_kernels": [{"name": n[:90], "count": c, "ms": ms}
                            for n, (c, ms) in top]}


def _decode_step_times(engine, reps=20):
    """The decode step at each slot count of a warmed engine, eager
    against its graph's replay, on all-zero inputs (every write lands in
    the null block; the step gathers every slot's full table either
    way): the host's time to issue one step, and the time between CUDA
    events around it. A replay issues its kernels back to back, so its
    event time is the step's device time; the eager step's span also
    holds the host's gaps."""
    import torch

    out = {}
    with torch.inference_mode():
        for S in engine.decode_slots:
            inputs = engine._phase_buffers(("decode", S))
            row = {}
            for kind, fn in (
                    ("eager", lambda: engine._phase_call("decode", inputs)),
                    ("replay", engine._graphs[("decode", S)].graph.replay)):
                for _ in range(3):
                    fn()
                host, device = [], []
                for _ in range(reps):
                    torch.cuda.synchronize()
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    t0 = time.perf_counter()
                    fn()
                    host.append((time.perf_counter() - t0) * 1e3)
                    end.record()
                    end.synchronize()
                    device.append(start.elapsed_time(end))
                row[kind] = {"host_ms": statistics.median(host),
                             "event_ms": statistics.median(device)}
            out[f"S{S}"] = row
    return out


def _graph_pool_bytes(pool):
    """Bytes of the caching allocator's segments in the graphs' private
    pool (torch.cuda.memory_snapshot), or None when the snapshot does
    not name segment pools."""
    import torch

    segs = torch.cuda.memory_snapshot()
    if not segs or "segment_pool_id" not in segs[0]:
        return None
    return sum(seg["total_size"] for seg in segs
               if tuple(seg["segment_pool_id"]) == tuple(pool))


def phase_profile():
    """The slice's requests straight into fresh engines (no HTTP, in a
    process whose kernels phase 3 already loaded): first one never
    warmed (every decode step eager), then one warmed (every decode
    step a CUDA graph replay). Each takes two rounds timed on the host
    clock, then one under torch.profiler for the device's busy time and
    its largest kernels; the two engines' tokens must be equal
    (ROADMAP item 2's gate). The warmed engine also reports its
    warmup's seconds, the graphs' memory and the decode step's host
    and device time at each slot count."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch import profiler

    rows, tokens, extra = {}, {}, {}
    for label in ("eager", "graphs"):
        _, engine, prompts = _slice_setup()
        got = []

        def run_round():
            t0 = time.perf_counter()
            handles = [engine.submit(p, max_new_tokens=SLICE_NEW_TOKENS)
                       for p in prompts]
            toks = [h.result(timeout_s=600) for h in handles]
            wall = time.perf_counter() - t0
            check(all(len(t) == SLICE_NEW_TOKENS for t in toks),
                  "profile round: short generation")
            got.append(toks)
            ttft = sorted(h.info["ttft_s"] * 1e3 for h in handles)
            n = sum(len(t) for t in toks)
            return {"wall_s": wall, "tokens_per_s": n / wall,
                    "ttft_p50_ms": statistics.median(ttft),
                    "ttft_max_ms": ttft[-1]}

        try:
            if label == "graphs":
                torch.cuda.synchronize()
                reserved = torch.cuda.memory_stats()[
                    "reserved_bytes.all.current"]
                t0 = time.perf_counter()
                ready = engine.warmup()
                extra["warmup_s"] = time.perf_counter() - t0
                check(ready == len(engine.prefill_buckets) +
                      len(engine.decode_slots), f"warmup: {ready} phases")
                extra["warmup_reserved_bytes"] = torch.cuda.memory_stats()[
                    "reserved_bytes.all.current"] - reserved
                extra["graph_pool_bytes"] = _graph_pool_bytes(
                    engine._graph_pool)
                extra["decode_step"] = _decode_step_times(engine)
            first = run_round()
            second = run_round()
            # the engine's thread may still be in a step: start and stop
            # the trace between steps (ROADMAP F12)
            prof = profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA])
            with profiler.between_steps():
                prof.start()
            try:
                profiled = run_round()
            finally:
                with profiler.between_steps():
                    prof.stop()
            steps = engine.status()["decode_steps"]
        finally:
            engine.stop()
        profiled.update(_device_time(prof, profiled["wall_s"]))
        rows[label] = {"first": first, "second": second,
                       "profiled": profiled, "decode_steps": steps}
        tokens[label] = got
        del engine, prof
        torch.cuda.empty_cache()
    check(rows["eager"]["decode_steps"]["replayed"] == 0 and
          rows["graphs"]["decode_steps"]["eager"] == 0 and
          rows["graphs"]["decode_steps"]["replayed"] > 0,
          f"profile: decode steps {rows['eager']['decode_steps']} (eager), "
          f"{rows['graphs']['decode_steps']} (graphs)")
    check(tokens["graphs"] == tokens["eager"],
          "profile: the warmed engine's tokens differ from the unwarmed "
          "engine's")
    print(json.dumps({"phase": "profile", "requests": len(SLICE_LENGTHS),
                      "tokens_equal": True, **rows, **extra}))


def phase_greedy():
    import torch

    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.serving import DecodeConfig, DecodeEngine

    cfg = gpt.GPTConfig(layers=2, dtype="float32")
    params, _ = gpt.init(torch.Generator(device="cuda").manual_seed(1), cfg,
                         device="cuda")
    engine = DecodeEngine(params, cfg, DecodeConfig(
        block_size=16, num_blocks=256, decode_slots=(4,), precision="f32"),
        device="cuda")
    rs = np.random.RandomState(1)
    prompts = [list(rs.randint(0, cfg.vocab_size, size=n)) for n in (7, 40)]
    max_new = 16
    try:
        handles = [engine.submit(p, max_new_tokens=max_new) for p in prompts]
        got = [h.result(timeout_s=600) for h in handles]
    finally:
        engine.stop()
    report = []
    with torch.inference_mode():
        for prompt, toks in zip(prompts, got):
            check(len(toks) == max_new, f"greedy: {len(toks)} tokens")
            seq = [int(t) for t in prompt]
            equal, margin_at_split = 0, None
            for tok in toks:
                logits = gpt.apply(params, cfg, torch.tensor(
                    [seq], device="cuda"))[0, -1].double()
                want = int(logits.argmax())
                if want != tok:
                    top2 = torch.topk(logits, 2).values
                    margin_at_split = float(top2[0] - top2[1])
                    # only a near-tie may flip; later tokens then follow
                    # different prefixes and are not compared
                    check(margin_at_split < 1e-4,
                          f"greedy token {equal} differs ({tok} vs {want}) "
                          f"at top-2 margin {margin_at_split}")
                    break
                equal += 1
                seq.append(want)
            report.append({"prompt_len": len(prompt), "equal": equal,
                           "margin_at_split": margin_at_split})
    print(json.dumps({"phase": "greedy", "model": "GPTConfig(layers=2), f32",
                      "tokens_per_prompt": max_new, "prompts": report}))


LR = 1e-4


def _adamw(params):
    """The counterpart of optax.adamw(1e-4), bench.py's optimizer: b1
    0.9, b2 0.999, eps 1e-8, weight decay 1e-4 on every param."""
    import torch

    return torch.optim.AdamW(params, lr=LR, weight_decay=1e-4)


K1_TRAIN = ("flash_attention_fwd_lse", "flash_attention_bwd_dkv",
            "flash_attention_bwd_dq")
K2_NAMES = ("flash_attention_bias_fwd", "flash_attention_bias_bwd_dkv",
            "flash_attention_bias_bwd_dq")
# the standalone delta launch, and the dq launches of K1 and K2 that
# folded the delta pass into their prologue (bf16 and f16)
DELTA = "flash_attention_bwd_delta"
K1_FOLD = "flash_attention_bwd_dq.delta_folds"
K2_FOLD = "flash_attention_bias_bwd_dq.delta_folds"


def k1_per_step(layers):
    """K1's launches a bf16 training step of `layers` attention layers:
    the forward with its LSE, and dq, folding the delta pass in, then
    dkv."""
    return {**dict.fromkeys(K1_TRAIN, layers), K1_FOLD: layers}


def _kernel_counts(reset=False):
    """Every kernel wrapper's launch count and the dq wrappers' delta
    folds, set to 0 first with reset."""
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import flash_attention_bias as fb
    from paddle_tpu_torch.kernels import fused_dense_bn as fdb

    fns = {name: getattr(fdb, name) for name in FDB_NAMES.values()}
    fns.update({"flash_attention_fwd": fa.flash_attention,
           "flash_attention_fwd_lse": fa.flash_attention_with_lse,
           "splash_block_with_lse": fa.splash_block_with_lse,
           DELTA: fa.attention_delta,
           "flash_attention_bwd_dkv": fa.flash_attention_bwd_dkv,
           "flash_attention_bwd_dq": fa.flash_attention_bwd_dq,
           "flash_attention_bias_fwd": fb.flash_attention_bias_fwd,
           "flash_attention_bias_bwd_dkv": fb.flash_attention_bias_bwd_dkv,
           "flash_attention_bias_bwd_dq": fb.flash_attention_bias_bwd_dq})
    folds = {K1_FOLD: fa.flash_attention_bwd_dq,
             K2_FOLD: fb.flash_attention_bias_bwd_dq}
    if reset:
        for fn in fns.values():
            fn.launches = 0
        for fn in folds.values():
            fn.delta_folds = 0
    return {**{name: fn.launches for name, fn in fns.items()},
            **{name: fn.delta_folds for name, fn in folds.items()}}


def phase_train_parity():
    """One f32 train step of a 2-layer, full-width BERT on the card and
    on the CPU from the same params and batch, at `_hold_train_step`'s
    tolerances (the card's loss, gradients and updated params against
    the CPU's)."""
    import torch

    from paddle_tpu_torch.models import bert

    cfg = bert.BertConfig(layers=2, dtype="float32")
    params, _ = bert.init(torch.Generator().manual_seed(2), cfg,
                          device="cpu")
    batch = bert.make_batch(np.random.RandomState(2), cfg, 4, seq_len=128,
                            device="cpu")

    def loss_fn(p, b, g):
        return bert.pretrain_loss(p, cfg, b, rng=g, deterministic=True)

    cuda = _one_train_step(loss_fn, params, batch, "cuda")
    cpu = _one_train_step(loss_fn, params, batch, "cpu")
    kc = cuda["counts"]
    # f32: K1's FMA dq takes delta from the standalone launch
    want = {**dict.fromkeys(K1_TRAIN, cfg.layers), DELTA: cfg.layers}
    check(all(n == want.get(name, 0) for name, n in kc.items()),
          f"train-parity: the CUDA step ran {kc} launches")
    print(json.dumps({"phase": "train-parity",
                      "model": "BertConfig(layers=2), f32, 4 x 128",
                      **_hold_train_step("train-parity", cuda, cpu, params),
                      "launches": kc}))


def _one_train_step(loss_fn, params, batch, dev):
    """On `dev`: the loss and every gradient at `params`, then one
    AdamW `make_train_step` step (f32) from them, with the kernels'
    launches over that step."""
    import torch

    from paddle_tpu_torch.parallel.train import make_train_step

    p = {k: v.to(dev).requires_grad_() for k, v in params.items()}
    b = {k: v.to(dev) for k, v in batch.items()}
    loss = loss_fn(p, b, None)
    grads = torch.autograd.grad(loss, list(p.values()), allow_unused=True)
    grads = {k: (torch.zeros_like(v) if g is None else g).cpu()
             for (k, v), g in zip(p.items(), grads)}
    _kernel_counts(reset=True)
    init, step = make_train_step(loss_fn, _adamw, device=dev,
                                 precision="f32")
    state, step_loss = step(init(params), b, 0)
    return {"loss": loss.item(), "grads": grads,
            "params": {k: v.detach().cpu() for k, v in state.params.items()},
            "step_loss": step_loss.item(), "counts": _kernel_counts()}


def _hold_train_step(label, got, want, params):
    """`got` against `want` (two `_one_train_step` results) at f32:
    loss within 1e-5 relative; each gradient within 2e-4 of its tensor's
    largest `want` value plus 1e-7 (f32 sums in other orders through two
    layers; the floor is for the key biases, whose exact gradient is 0,
    since a shift of every key adds a constant to a row's logits, and
    whose computed one is rounding noise of about 1e-9 on both sides);
    the updated params: every update within 2 lr of `want`'s (AdamW's
    first step moves each element by about lr times the sign of its
    gradient, so a gradient near zero may move the other way), and at
    most 0.1% of the elements more than 1e-6 apart."""
    slc, slp = got["step_loss"], want["step_loss"]
    check(abs(slc - slp) <= 1e-5 * abs(slp),
          f"{label} step loss {slc} vs {slp}")
    held_grads = _hold_loss_grads(label, got, want)
    upd_err, n_far, n_all = 0.0, 0, 0
    for k, p0 in params.items():
        d = ((got["params"][k] - p0) - (want["params"][k] - p0)).abs()
        upd_err = max(upd_err, d.max().item())
        n_far += int((d > 1e-6).sum())
        n_all += d.numel()
    check(upd_err <= 2 * LR and n_far <= 1e-3 * n_all,
          f"{label} params: max update difference {upd_err}, "
          f"{n_far} of {n_all} elements more than 1e-6 apart")
    return {**held_grads,
            "param_update_max_abs_err": upd_err,
            "param_elements_apart": n_far, "param_elements": n_all}


def _hold_loss_grads(label, got, want):
    """`got`'s loss and gradients against `want`'s at
    `_hold_train_step`'s f32 limits: loss within 1e-5 relative, each
    gradient within 2e-4 of its tensor's largest `want` value plus
    1e-7."""
    lc, lp = got["loss"], want["loss"]
    check(abs(lc - lp) <= 1e-5 * abs(lp), f"{label} loss {lc} vs {lp}")
    gc, gp = got["grads"], want["grads"]
    grad_err = sorted((((gc[k] - gp[k]).abs().max() /
                        (2e-4 * gp[k].abs().max() + 1e-7)).item(), k,
                       gp[k].abs().max().item()) for k in gp)[::-1]
    check(grad_err[0][0] <= 1.0,
          f"{label} grads: worst (error / tolerance, name, largest "
          f"reference value) {grad_err[:3]}")
    return {"loss_got": lc, "loss_want": lp,
            "grad_err_over_tol_worst3": grad_err[:3]}


def _profiled_step(run):
    """`run()` (one step, in place) twice under torch.profiler (device
    activity only, one cycle): the first absorbs the tracer's start-up,
    the second is recorded. `_device_time` of the second, with its wall
    ms."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CUDA], acc_events=True,
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
            prof.step()
    profiled = _device_time(prof, wall_s)
    profiled["wall_ms"] = wall_s * 1e3
    return profiled


def _train_run(label, loss_fn, params, batch, flops_per_sample, warmup,
               steps, per_step, optimizer=None, precision="mixed_bf16",
               has_aux=False, trace_ok=None, after=None, mesh=None,
               param_axes=None, rules=None):
    """`warmup` + `steps` steps on one fixed batch (AdamW and mixed_bf16
    unless given; `has_aux` for a loss_fn that also returns state
    updates); the kernels' counts are set to 0 just before the
    timed steps and read just after, and each must equal `per_step`
    ({name: launches a step}, 0 for every kernel it does not name)
    times the steps; then one step is traced under torch.profiler for
    the device's busy time against that step's wall time. With
    `trace_ok` (a check of the traced step's summary that raises on a
    wrong kernel and returns False on a short count), a trace it
    returns False on is taken again, up to TRACE_TRIES times: the
    profiler can drop a kernel's record (one K2-fwd record of 12 once
    on an H100), while the counts above are the wrappers' own. Where
    `per_step` names no standalone delta launch (the bf16 paths, whose
    dq kernels fold the delta pass in), a traced step that shows a
    `delta_kernel` record fails. `after(step, state, batch)`, run last,
    returns more entries for the row. `mesh`, `param_axes` and `rules`
    go to make_train_step (in-process rings on the card)."""
    import torch

    from paddle_tpu_torch.parallel.train import make_train_step

    init, step = make_train_step(loss_fn, optimizer or _adamw,
                                 device="cuda", precision=precision,
                                 has_aux=has_aux, mesh=mesh,
                                 param_axes=param_axes, rules=rules)
    state = init(params)
    del params
    n = next(iter(batch.values())).shape[0]
    losses = []
    for i in range(warmup):
        state, loss = step(state, batch, i)
        losses.append(loss.item())
    torch.cuda.synchronize()
    counts = _kernel_counts(reset=True)
    times = []
    for i in range(steps):
        t0 = time.perf_counter()
        state, loss = step(state, batch, warmup + i)
        losses.append(loss.item())      # also waits for the step
        times.append((time.perf_counter() - t0) * 1e3)
    counts = _kernel_counts()
    traces, seeds = [], iter(range(warmup + steps, 10 ** 9))
    while True:
        profiled = _profiled_step(
            lambda: step(state, batch, next(seeds))[1].item())
        traces.append(profiled)
        if (trace_ok is None or trace_ok(profiled)
                or len(traces) == TRACE_TRIES):
            break
    check(trace_ok is None or trace_ok(profiled),
          f"{label}: {len(traces)} traced steps each short of a kernel: "
          f"{[t['k2_kernel_launches'] for t in traces]}")
    check(per_step.get(DELTA, 0) or
          not any(t["delta_kernel_records"] for t in traces),
          f"{label}: a traced step ran the standalone delta_kernel: "
          f"{[t['delta_kernel_records'] for t in traces]}")
    ms = statistics.median(times)
    samples_s = n / (ms / 1e3)
    row = {"run": label, "batch": n, "warmup": warmup, "steps": steps,
           "step_ms_median": ms, "step_ms_min": min(times),
           "step_ms_max": max(times), "samples_per_s": samples_s,
           "flops_per_sample": flops_per_sample,
           "mfu": flops_per_sample * samples_s / bf16_flops_per_s(),
           "loss_first": losses[0], "loss_last": losses[-1],
           "losses": losses, "launches": counts,
           "launches_per_step": {k: v / steps for k, v in counts.items()},
           "loss_scale": state.loss_scale, "precision": precision,
           "max_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
           "profiled_step": profiled, "traces": len(traces),
           "k2_launches_per_trace": [t["k2_kernel_launches"]
                                     for t in traces]}
    check(all(np.isfinite(losses)), f"{label}: nonfinite loss {losses}")
    check(losses[-1] < losses[0],
          f"{label}: loss did not fall ({losses[0]} -> {losses[-1]})")
    for name, n in counts.items():
        want = per_step.get(name, 0)
        check(n == want * steps,
              f"{label}: {name} launched {n} times in {steps} steps, not "
              f"{want} a step")
    if after is not None:
        row.update(after(step, state, batch))
    del state
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return row


def phase_train():
    """BERT-base pretraining (bench.py bench_bert's model and optimizer,
    dropout on as there) under mixed_bf16, at the first rung of its
    ladder (256 x 128) and at 32 x 512."""
    import torch

    from paddle_tpu_torch.models import bert

    cfg = bert.BertConfig.base()

    def loss_fn(p, b, g):
        return bert.pretrain_loss(p, cfg, b, rng=g, deterministic=False)

    rows, counts = [], {}
    for B, T in ((256, 128), (32, 512)):
        params, _ = bert.init(torch.Generator(device="cuda").manual_seed(0),
                              cfg, device="cuda")
        batch = bert.make_batch(torch.Generator(device="cuda").manual_seed(1),
                                cfg, B, seq_len=T)
        P = batch["masked_positions"].shape[1]
        row = _train_run(f"bert-base {B}x{T}", loss_fn, params, batch,
                         cfg.train_flops_per_seq(T, P), 3, 20,
                         k1_per_step(cfg.layers))
        row["masked_per_seq"] = P
        rows.append(row)
        for k, v in row["launches"].items():
            counts[k] = counts.get(k, 0) + v
    print(json.dumps({"phase": "train", "model": "BERT-base "
                      "(BertConfig.base()), mixed_bf16, dropout 0.1",
                      "optimizer": "AdamW lr 1e-4 wd 1e-4",
                      "runs": rows}))
    return counts, rows[1]


def gpt_train_flops_per_seq(cfg, T):
    """Training FLOPs per sequence of the dense GPT: 3x forward; forward
    = 2*T*(per-layer matmul params + tied vocab head) + the causal
    attention products (QK^T and PV over T(T+1)/2 pairs)."""
    H, L = cfg.hidden, cfg.layers
    matmul = L * (4 * H * H + 2 * H * cfg.mlp_dim) + H * cfg.vocab_size
    fwd = 2 * T * matmul + L * 4 * H * T * (T + 1) / 2
    return 3 * fwd


def phase_gpt_train():
    """GPT-2-small `lm_loss` under mixed_bf16 at 8 x 1024: the causal
    backward kernel on a real path."""
    import torch

    from paddle_tpu_torch.models import gpt

    cfg = gpt.GPTConfig()
    params, _ = gpt.init(torch.Generator(device="cuda").manual_seed(3), cfg,
                         device="cuda")
    batch = gpt.make_batch(torch.Generator(device="cuda").manual_seed(4),
                           cfg, 8)

    def loss_fn(p, b, g):
        return gpt.lm_loss(p, cfg, b, rng=g)

    row = _train_run("gpt-2-small 8x1024", loss_fn, params, batch,
                     gpt_train_flops_per_seq(cfg, cfg.max_len), 2, 10,
                     k1_per_step(cfg.layers))
    print(json.dumps({"phase": "gpt-train", "model": "GPT-2-small "
                      "(GPTConfig()), mixed_bf16", "run": row}))
    return row["launches"]


def _adam(params):
    """The counterpart of optax.adam(1e-4), bench.py's Transformer
    optimizer: b1 0.9, b2 0.999, eps 1e-8, no weight decay."""
    import torch

    return torch.optim.Adam(params, lr=LR)


# per training step of Transformer-big: K2 in the 6 encoder self- and 6
# cross-attention calls, K1 in the 6 causal decoder self-attention
# calls; the delta pass of all 18 backwards folded into their dq
# kernels at bf16, K1's standalone delta launch at f32
def nmt_per_step(cfg):
    k2 = cfg.enc_layers + cfg.dec_layers
    n = {**dict.fromkeys(K2_NAMES, k2),
         **dict.fromkeys(K1_TRAIN, cfg.dec_layers)}
    if cfg.dtype == "float32":
        return {**n, DELTA: k2 + cfg.dec_layers}
    return {**n, K1_FOLD: cfg.dec_layers, K2_FOLD: k2}


def _k2_trace_ok(label, per_step):
    """A `trace_ok` for `_train_run`: in a traced step, each K2 launch of
    `per_step` ({name: launches a step}) never ran on its FMA kernel
    (raises), and ran on its Hopper kernel that many times (else False:
    the profiler may have dropped a record)."""
    def ok(profiled):
        n = profiled["k2_kernel_launches"]
        check(not any(n[kern["fma"]] for kern in K2_ROUTES.values()),
              f"{label}: the traced step ran a K2 FMA kernel: {n}")
        return all(n[kern["sm90"]] == per_step.get(name, 0)
                   for name, kern in K2_ROUTES.items())
    return ok


def _k2_bwd_ms(row):
    """K2-bwd's device ms (dkv, dq) in `row`'s traced step."""
    ms = row["profiled_step"]["k2_kernel_ms"]
    return {"dkv": ms[K2_ROUTES["flash_attention_bias_bwd_dkv"]["sm90"]],
            "dq": ms[K2_ROUTES["flash_attention_bias_bwd_dq"]["sm90"]]}


def phase_nmt_parity():
    """A 2 + 2-layer Transformer at Transformer-big's widths, f32 (TF32
    off), on the card (K1 and K2) and on the CPU (plain versions) from
    the same params and a ragged batch: the loss within 1e-5 relative,
    each gradient within 2e-4 of its tensor's largest CPU value plus
    1e-7 (phase 6's rule: f32 sums in other orders through four
    layers), and one Adam step's params within 2 lr (Adam's first step
    moves each element by about lr times the sign of its gradient, so a
    gradient near zero may move the other way). Then `beam_search` on 2
    sources, beam 4, 16 steps: the same tokens, scores within 1e-5
    relative, from the step's starting params."""
    import torch

    from paddle_tpu_torch.models import transformer
    from paddle_tpu_torch.parallel.train import make_train_step

    cfg = transformer.TransformerConfig.big()
    cfg.enc_layers = cfg.dec_layers = 2
    cfg.dtype = "float32"
    params, _ = transformer.init(torch.Generator().manual_seed(6), cfg,
                                 device="cpu")
    batch = transformer.make_batch(np.random.RandomState(6), cfg, 4, 128,
                                   128, device="cpu")

    def loss_fn(p, b, g):
        return transformer.nmt_loss(p, cfg, b, rng=g)

    result = {}
    for dev in ("cuda", "cpu"):
        p = {k: v.to(dev).requires_grad_() for k, v in params.items()}
        b = {k: v.to(dev) for k, v in batch.items()}
        loss = loss_fn(p, b, None)
        grads = torch.autograd.grad(loss, list(p.values()),
                                    allow_unused=True)
        grads = {k: (torch.zeros_like(v) if g is None else g).cpu()
                 for (k, v), g in zip(p.items(), grads)}
        _kernel_counts(reset=True)
        init, step = make_train_step(loss_fn, _adam, device=dev,
                                     precision="f32")
        state, step_loss = step(init(params), b, 0)
        counts = _kernel_counts()
        with torch.inference_mode():     # from the shared params
            toks, scores = transformer.beam_search(
                p, cfg, b["src_ids"][:2], b["src_len"][:2], beam_size=4,
                max_len=16)
        result[dev] = (loss.item(), grads,
                       {k: v.detach().cpu() for k, v in state.params.items()},
                       counts, toks.cpu(), scores.cpu())
    (lc, gc, pc, kc, tc, sc), (lp, gp, pp, _, tp, sp) = \
        result["cuda"], result["cpu"]
    want = nmt_per_step(cfg)
    check(all(kc[name] == want.get(name, 0) for name in kc),
          f"nmt-parity: the CUDA step ran {kc} launches, not {want}")
    check(abs(lc - lp) <= 1e-5 * abs(lp), f"nmt-parity loss {lc} vs {lp}")
    grad_err = sorted((((gc[k] - gp[k]).abs().max() /
                        (2e-4 * gp[k].abs().max() + 1e-7)).item(), k,
                       gp[k].abs().max().item()) for k in gp)[::-1]
    check(grad_err[0][0] <= 1.0,
          f"nmt-parity grads: worst (error / tolerance, name, largest CPU "
          f"value) {grad_err[:3]}")
    upd_err, n_far, n_all = 0.0, 0, 0
    for k, p0 in params.items():
        d = ((pc[k] - p0) - (pp[k] - p0)).abs()
        upd_err = max(upd_err, d.max().item())
        n_far += int((d > 1e-6).sum())
        n_all += d.numel()
    check(upd_err <= 2 * LR, f"nmt-parity params: max update difference "
                             f"{upd_err}")
    check(torch.equal(tc, tp), f"nmt-parity beam tokens differ: {tc} vs {tp}")
    score_err = ((sc - sp).abs() / sp.abs()).max().item()
    check(score_err <= 1e-5, f"nmt-parity beam scores: {sc} vs {sp}")
    print(json.dumps({"phase": "nmt-parity",
                      "model": "TransformerConfig.big() widths, 2 + 2 "
                               "layers, f32, 4 x (128, 128)",
                      "src_len": batch["src_len"].tolist(),
                      "tgt_len": batch["tgt_len"].tolist(),
                      "loss_cuda": lc, "loss_cpu": lp,
                      "grad_err_over_tol_worst3": grad_err[:3],
                      "param_update_max_abs_err": upd_err,
                      "param_elements_apart": n_far, "param_elements": n_all,
                      "beam_scores_cuda": sc.tolist(),
                      "beam_score_max_rel_err": score_err,
                      "launches": kc}))


def phase_nmt_train():
    """Transformer-big (bench.py bench_transformer_big's model, optimizer
    and first rung: 128 pairs of 128 x 128 tokens, Adam(1e-4), policy
    f32 with bf16 compute) on one `make_batch` batch."""
    import torch

    from paddle_tpu_torch.models import transformer

    cfg = transformer.TransformerConfig.big()
    params, _ = transformer.init(
        torch.Generator(device="cuda").manual_seed(7), cfg, device="cuda")
    batch = transformer.make_batch(
        torch.Generator(device="cuda").manual_seed(8), cfg, 128, 128, 128)

    def loss_fn(p, b, g):
        return transformer.nmt_loss(p, cfg, b, rng=g)

    n_params = sum(v.numel() for v in params.values())
    per_step = nmt_per_step(cfg)
    row = _train_run("transformer-big 128x(128,128)", loss_fn, params, batch,
                     cfg.train_flops_per_seq(128, 128), 3, 20, per_step,
                     optimizer=_adam, precision="f32",
                     trace_ok=_k2_trace_ok("nmt-train", per_step))
    row["k2_bwd_device_ms"] = _k2_bwd_ms(row)
    print(json.dumps({"phase": "nmt-train",
                      "model": "Transformer-big (TransformerConfig.big()), "
                               "f32 params, bf16 compute",
                      "optimizer": "Adam lr 1e-4", "params": n_params,
                      "src_len_mean": batch["src_len"].float().mean().item(),
                      "tgt_len_mean": batch["tgt_len"].float().mean().item(),
                      "run": row}))
    return row["launches"]


def phase_nmt_beam():
    """Transformer-big `beam_search` under inference_mode: 8 sources of
    128 tokens with ragged lengths, beam 4, 32 steps, run twice (the
    launch counts are read around the first)."""
    import torch

    from paddle_tpu_torch.models import transformer

    cfg = transformer.TransformerConfig.big()
    params, _ = transformer.init(
        torch.Generator(device="cuda").manual_seed(9), cfg, device="cuda")
    batch = transformer.make_batch(
        torch.Generator(device="cuda").manual_seed(10), cfg, 8, 128, 32)
    K, L = 4, 32
    walls = []
    with torch.inference_mode():
        for i in range(2):
            if i == 0:
                _kernel_counts(reset=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            toks, scores = transformer.beam_search(
                params, cfg, batch["src_ids"], batch["src_len"],
                beam_size=K, max_len=L)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            if i == 0:
                counts = _kernel_counts()
    want = {"flash_attention_bias_fwd": cfg.enc_layers + cfg.dec_layers * L,
            "flash_attention_fwd": cfg.dec_layers * L}
    check(all(n == want.get(name, 0) for name, n in counts.items()),
          f"nmt-beam: launches {counts}, not {want}")
    check(toks.shape == (8, K, L), f"nmt-beam: tokens {tuple(toks.shape)}")
    check(bool(((toks >= 0) & (toks < cfg.tgt_vocab)).all()),
          "nmt-beam: token out of range")
    check(bool(torch.isfinite(scores).all()) and
          bool((scores[:, :-1] >= scores[:, 1:]).all()),
          f"nmt-beam: scores not finite and sorted: {scores}")
    print(json.dumps({"phase": "nmt-beam",
                      "model": "Transformer-big, bf16 compute",
                      "sources": 8, "beam": K, "max_len": L,
                      "src_len": batch["src_len"].tolist(),
                      "wall_ms": walls, "best_scores": scores[:, 0].tolist(),
                      "launches": counts}))
    return counts


def phase_bert_padded(unpadded):
    """BERT-base at 32 x 512 with an attention_mask (lengths uniform in
    [256, 512] from a seed) under mixed_bf16, dropout on, as phase 7's
    unpadded 32 x 512 (`unpadded`, its run row)."""
    import torch

    from paddle_tpu_torch.models import bert

    cfg = bert.BertConfig.base()
    B, T = 32, 512

    def loss_fn(p, b, g):
        return bert.pretrain_loss(p, cfg, b, rng=g, deterministic=False)

    params, _ = bert.init(torch.Generator(device="cuda").manual_seed(0), cfg,
                          device="cuda")
    batch = bert.make_batch(torch.Generator(device="cuda").manual_seed(1),
                            cfg, B, seq_len=T)
    lens = torch.randint(256, T + 1, (B,), device="cuda",
                         generator=torch.Generator(device="cuda")
                         .manual_seed(11))
    batch["attention_mask"] = (torch.arange(T, device="cuda")[None]
                               < lens[:, None]).long()
    P = batch["masked_positions"].shape[1]
    per_step = {**dict.fromkeys(K2_NAMES, cfg.layers), K2_FOLD: cfg.layers}
    row = _train_run(f"bert-base {B}x{T} padded", loss_fn, params, batch,
                     cfg.train_flops_per_seq(T, P), 3, 20, per_step,
                     trace_ok=_k2_trace_ok("bert-padded", per_step))
    row["mean_length"] = lens.float().mean().item()
    row["k2_bwd_device_ms"] = _k2_bwd_ms(row)
    print(json.dumps({"phase": "bert-padded", "model": "BERT-base, "
                      "mixed_bf16, dropout 0.1, attention_mask",
                      "run": row,
                      "unpadded_step_ms_median": unpadded["step_ms_median"]}))
    return row["launches"]


def phase_bottleneck():
    """The fused bottleneck slice at ResNet-50's g2 widths, f32 (TF32
    off): matmul_stats (K4) -> fold_bn -> bn_act_matmul (K5), against
    the plain unfused composition (x @ w1, one-pass BN, ReLU, @ w2),
    values within 2e-4 and the gradients of all five inputs within 2e-3
    (|got - want| <= tol (1 + |want|), the limits of the JAX package's
    tests/test_fused_dense_bn.py). K5's main path: its launch count is
    read around the fused forward."""
    import torch

    from paddle_tpu_torch.kernels import fused_dense_bn as fdb

    t0 = time.perf_counter()
    M, C1, C2, C3 = 50176, 1024, 256, 1024
    gen = torch.Generator(device="cuda").manual_seed(13)
    ins = [torch.randn(M, C1, generator=gen, device="cuda"),
           torch.randn(C1, C2, generator=gen, device="cuda") * 0.1,
           torch.rand(C2, generator=gen, device="cuda") + 0.5,
           torch.randn(C2, generator=gen, device="cuda") * 0.1,
           torch.randn(C2, C3, generator=gen, device="cuda") * 0.1]
    ct = torch.randn(M, C3, generator=gen, device="cuda")

    def fused(x, w1, gamma, beta, w2):
        y, mean, var = fdb.matmul_stats(x, w1)
        scale, shift = fdb.fold_bn(mean, var, gamma, beta)
        return fdb.bn_act_matmul(y, scale, shift, w2, relu=True)

    def unfused(x, w1, gamma, beta, w2):
        y = x @ w1
        mean = y.mean(0)
        var = torch.clamp_min((y * y).mean(0) - mean * mean, 0.0)
        yn = (y - mean) * torch.rsqrt(var + 1e-5) * gamma + beta
        return torch.relu(yn) @ w2

    out = {}
    for name, fn in (("fused", fused), ("unfused", unfused)):
        leaves = [t.clone().requires_grad_() for t in ins]
        counts = _kernel_counts(reset=True)
        y = fn(*leaves)
        torch.cuda.synchronize()
        counts = _kernel_counts()
        grads = torch.autograd.grad((y * ct).sum(), leaves)
        out[name] = (y.detach(), [g.detach() for g in grads], counts)
    (yf, gf, kc), (yu, gu, _) = out["fused"], out["unfused"]
    check(kc["matmul_stats_fwd"] == 1 and kc["bn_act_matmul_fwd"] == 1 and
          sum(kc.values()) == 2, f"bottleneck: the fused forward ran {kc}")

    def ratio(a, b, tol):
        return ((a - b).abs() / (tol * (1 + b.abs()))).max().item()

    val = ratio(yf, yu, 2e-4)
    grad = [ratio(a, b, 2e-3) for a, b in zip(gf, gu)]
    check(val <= 1.0 and max(grad) <= 1.0,
          f"bottleneck: values {val}, gradients {grad} of their limits")
    with torch.no_grad():
        times = {"fused_fwd_ms": time_ms(lambda: fused(*ins), reps=10),
                 "unfused_fwd_ms": time_ms(lambda: unfused(*ins), reps=10)}
    print(json.dumps({"phase": "bottleneck",
                      "shape": {"M": M, "C": [C1, C2, C3]}, "dtype": "float32",
                      "launches": kc, "value_ratio": val,
                      "grad_ratios": grad, **times,
                      "seconds": time.perf_counter() - t0}))
    return kc


def _sgd(params):
    """The counterpart of optax.sgd(0.1, momentum=0.9), bench.py
    bench_resnet50's optimizer: both set the first trace to g, then
    g + 0.9 trace."""
    import torch

    return torch.optim.SGD(params, lr=0.1, momentum=0.9)


def _resnet_grads(params, cfg, batch, dev):
    """(loss, {name: BN update}, {name: grad}, launches) of one forward
    and backward of `resnet.loss_fn` on `dev`, on the CPU."""
    import torch

    from paddle_tpu_torch.models import resnet

    p = {k: v.to(dev).requires_grad_() for k, v in params.items()}
    b = {k: v.to(dev) for k, v in batch.items()}
    _kernel_counts(reset=True)
    loss, upd = resnet.loss_fn(p, cfg, b, data_format="NHWC")
    counts = _kernel_counts()
    grads = torch.autograd.grad(loss, list(p.values()), allow_unused=True)
    return (loss.item(), {k: v.detach().cpu() for k, v in upd.items()},
            {k: (torch.zeros_like(v) if g is None else g).cpu()
             for (k, v), g in zip(p.items(), grads)}, counts)


def phase_resnet_parity():
    """Full-width ResNet-50 (1000 classes) at f64 activations, 4 images of
    64 x 64 (the spatial size cut for the CPU's sake; widths and depth
    full), `fused_1x1` on. Two gates:

    - on the card, fused (K4, K6) against unfused (cuDNN convs), the JAX
      package's own limits for that comparison
      (test_resnet_fused_1x1_matches_unfused): loss within 1e-9
      relative, every BN update within rtol 1e-8 (atol 1e-10), every
      gradient within rtol 1e-6 (atol 1e-8);
    - the card's fused run against the CPU's (plain versions): BN
      updates within rtol 1e-8 (f64 end to end); the loss within 1e-6
      relative and each gradient within 1e-5 of its tensor's largest
      value, because the head and the log-softmax compute in f32 by
      design and cuBLAS and the CPU sum them in other orders (the same
      limits tests/test_torch_resnet.py sets against the JAX package,
      which measured 1.0e-7 and 2.0e-6 there); and one SGD(0.1,
      momentum 0.9) step through make_train_step: each trainable param
      within 1e-4 of its largest update plus one f32 step of its
      largest value, the BN statistics it writes within 1e-6 relative
      (f64 updates stored in f32)."""
    import dataclasses

    import torch

    from paddle_tpu_torch.convert import params_from_numpy
    from paddle_tpu_torch.models import resnet
    from paddle_tpu_torch.parallel.train import make_train_step

    t0 = time.perf_counter()
    cfg = dataclasses.replace(resnet.ResNetConfig.resnet50(),
                              dtype="float64", fused_1x1=True)
    params, _ = resnet.init(torch.Generator().manual_seed(14), cfg,
                            device="cpu")
    batch = resnet.make_batch(np.random.RandomState(14), cfg, 4, hw=64,
                              data_format="NHWC", device="cpu")
    card = _resnet_grads(params, cfg, batch, "cuda")
    unfused = _resnet_grads(params, dataclasses.replace(cfg, fused_1x1=False),
                            batch, "cuda")
    cpu = _resnet_grads(params, cfg, batch, "cpu")
    want = {"matmul_stats_fwd": 16, "bn_act_matmul_stats_fwd": 16}
    check(all(n == want.get(k, 0) for k, n in card[3].items()),
          f"resnet-parity: the fused forward ran {card[3]}")
    check(all(n == 0 for n in unfused[3].values()),
          f"resnet-parity: the unfused forward ran {unfused[3]}")

    def upd_ratio(a, b):
        return max(((a[k] - b[k]).abs() / (1e-8 * b[k].abs() + 1e-10))
                   .max().item() for k in b)

    def tight_grad_ratio(a, b):
        return max(((a[k].double() - b[k].double()).abs() /
                    (1e-6 * b[k].double().abs() + 1e-8)).max().item()
                   for k in b)

    def grad_ratio(a, b):
        worst = (0.0, None)
        for k in b:
            scale = b[k].double().abs().max().item()
            if scale:
                worst = max(worst, ((a[k].double() - b[k].double()).abs()
                                    .max().item() / (1e-5 * scale), k),
                            key=lambda t: t[0])
        return worst

    r = {"fused_vs_unfused": {
            "loss_rel": abs(card[0] - unfused[0]) / abs(unfused[0]),
            "upd_ratio": upd_ratio(card[1], unfused[1]),
            "grad_ratio": tight_grad_ratio(card[2], unfused[2])},
         "card_vs_cpu": {
            "loss_rel": abs(card[0] - cpu[0]) / abs(cpu[0]),
            "upd_ratio": upd_ratio(card[1], cpu[1]),
            "grad_ratio": grad_ratio(card[2], cpu[2])}}
    fu, cc = r["fused_vs_unfused"], r["card_vs_cpu"]
    check(fu["loss_rel"] <= 1e-9 and fu["upd_ratio"] <= 1.0 and
          fu["grad_ratio"] <= 1.0, f"resnet-parity fused vs unfused: {fu}")
    check(cc["loss_rel"] <= 1e-6 and cc["upd_ratio"] <= 1.0 and
          cc["grad_ratio"][0] <= 1.0, f"resnet-parity card vs cpu: {cc}")

    stepped = {}
    for dev in ("cuda", "cpu"):
        init, step = make_train_step(
            lambda p, b, g: resnet.loss_fn(p, cfg, b, g, data_format="NHWC"),
            _sgd, device=dev, has_aux=True)
        state, loss = step(init(params), batch, 0)
        stepped[dev] = (loss.item(), {k: v.detach().cpu()
                                      for k, v in state.params.items()})
    worst, worst_bn = (0.0, None), (0.0, None)
    for k, p0 in params.items():
        a, b = stepped["cuda"][1][k].double(), stepped["cpu"][1][k].double()
        err = (a - b).abs().max().item()
        if k.endswith((".mean", ".var")):
            worst_bn = max(worst_bn, (((a - b).abs() / (1e-6 * b.abs() +
                                                       1e-10)).max().item(),
                                      k), key=lambda t: t[0])
            continue
        lim = 1e-4 * (b - p0.double()).abs().max().item() + \
            float(np.spacing(np.float32(b.abs().max().item())))
        worst = max(worst, (err / lim, k), key=lambda t: t[0])
    r["sgd_step"] = {"loss_cuda": stepped["cuda"][0],
                     "loss_cpu": stepped["cpu"][0], "param_ratio": worst,
                     "bn_state_ratio": worst_bn}
    check(worst[0] <= 1.0 and worst_bn[0] <= 1.0,
          f"resnet-parity SGD step: {r['sgd_step']}")
    print(json.dumps({"phase": "resnet-parity",
                      "model": "ResNetConfig.resnet50(), f64 activations, "
                               "fused_1x1, 4 x 64 x 64",
                      "loss_cuda": card[0], "loss_cuda_unfused": unfused[0],
                      "loss_cpu": cpu[0], "launches": card[3], **r,
                      "seconds": time.perf_counter() - t0}))


def _resnet_grad_agreement(B=32, hw=224):
    """Cosine similarity of ResNet-50's whole gradient (and of its worst
    tensor) at bs `B`, fused and unfused, f32 and bf16 activations,
    against the unfused f32 gradient, from one set of params and one
    batch: how far the bf16 runs' steps follow the f32 direction, for
    each path. Reported, not gated (phase 14 gates the fused path)."""
    import dataclasses

    import torch

    from paddle_tpu_torch.models import resnet

    base = resnet.ResNetConfig.resnet50()
    params, _ = resnet.init(torch.Generator(device="cuda").manual_seed(0),
                            base, device="cuda")
    batch = resnet.make_batch(torch.Generator(device="cuda").manual_seed(1),
                              base, B, hw=hw, data_format="NHWC")
    grads = {}
    for fused in (False, True):
        for dt in ("float32", "bfloat16"):
            cfg = dataclasses.replace(base, fused_1x1=fused, dtype=dt)
            p = {k: v.clone().requires_grad_() for k, v in params.items()}
            loss, _ = resnet.loss_fn(p, cfg, batch, data_format="NHWC")
            g = torch.autograd.grad(loss, list(p.values()), allow_unused=True)
            grads[(fused, dt)] = (loss.item(), {k: x.double() for k, x in
                                                zip(p, g) if x is not None})
    ref = grads[(False, "float32")][1]
    out = {}
    for (fused, dt), (loss, g) in grads.items():
        whole = torch.cat([g[k].flatten() for k in ref]), \
            torch.cat([ref[k].flatten() for k in ref])
        worst = min(((g[k].flatten() @ ref[k].flatten()) /
                     (g[k].norm() * ref[k].norm())).item() for k in ref)
        out[f"{'fused' if fused else 'unfused'} {dt}"] = {
            "loss": loss, "cos_whole": ((whole[0] @ whole[1]) /
                                        (whole[0].norm() * whole[1].norm()))
            .item(), "cos_worst_tensor": worst}
    return {"batch": B, "hw": hw, "against": "unfused float32", **out}


def phase_resnet_train():
    """ResNet-50 as bench.py bench_resnet50 runs its first rung: bs 256 at
    224 x 224, NHWC, bf16 activations, f32 params (policy f32),
    SGD(0.1, momentum 0.9), 3 warm-up and 20 timed steps, first unfused
    (cuDNN convs), then with `fused_1x1` (K4 and K6 16 times a step).
    Before them, the first step's gradient of each path at f32 and bf16
    against the unfused f32 one (`_resnet_grad_agreement`)."""
    import dataclasses

    import torch

    from paddle_tpu_torch.models import resnet

    t0 = time.perf_counter()
    agreement = _resnet_grad_agreement()
    runs, counts = [], {}
    B, hw = 256, 224
    for fused in (False, True):
        cfg = dataclasses.replace(resnet.ResNetConfig.resnet50(),
                                  fused_1x1=fused)
        params, _ = resnet.init(torch.Generator(device="cuda").manual_seed(0),
                                cfg, device="cuda")
        batch = resnet.make_batch(torch.Generator(device="cuda").manual_seed(1),
                                  cfg, B, hw=hw, data_format="NHWC")

        def loss_fn(p, b, g, cfg=cfg):
            return resnet.loss_fn(p, cfg, b, g, data_format="NHWC")

        per_step = {"matmul_stats_fwd": 16, "bn_act_matmul_stats_fwd": 16} \
            if fused else {}
        row = _train_run(f"resnet-50 {B}x{hw}^2 " +
                         ("fused_1x1" if fused else "unfused"), loss_fn,
                         params, batch, cfg.flops_per_image(hw), 3, 20,
                         per_step, optimizer=_sgd, precision="f32",
                         has_aux=True)
        del params, batch
        runs.append(row)
        for k, v in row["launches"].items():
            counts[k] = counts.get(k, 0) + v
    print(json.dumps({"phase": "resnet-train",
                      "model": "ResNet-50 (ResNetConfig.resnet50()), bf16 "
                               "activations, f32 params, NHWC",
                      "optimizer": "SGD lr 0.1 momentum 0.9",
                      "first_losses": {r["run"]: r["loss_first"]
                                       for r in runs},
                      "grad_agreement": agreement,
                      "runs": runs, "seconds": time.perf_counter() - t0}))
    return counts


SP = 4   # the ring of phases 16 and 17: MeshConfig(sp=4) on one card


def _sp_mesh():
    """An in-process sp=4 ring: four virtual ranks on the card, run in
    turn by this process (what one card can show of the sp axis)."""
    import torch

    from paddle_tpu_torch.parallel.mesh import MeshConfig, make_mesh

    return make_mesh(MeshConfig(sp=SP), devices=[torch.device("cuda", 0)] * SP)


# Causal ring_attention's gradients against K1's, per element: f32
# with ten times ELEM_TOL's atol. In the rows with few keys the exact dq
# is near 0 and ds = p (dp - delta) cancels, and the two sides round the
# logits at different points (q k^T, then the scale, as the JAX
# package's _block_attn; K1 scales q first), so their f32 noise there
# differs: measured 1.27e-5 of the RMS on an H100 at 2 x 2048 x 12 heads.
CAUSAL_RING_TOL = (1e-5, 1e-4)


def _ring_op_parity(mesh):
    """f32 on the card: ring_splash (K3 blocks) against its plain
    version (K3's plain version in every block) and against
    single-device K1, out and the q/k/v gradients; causal
    ring_attention against K1 causal. Every element under
    ELEM_TOL["float32"] (the same f32 attention, summed in other
    orders), causal ring_attention's gradients under CAUSAL_RING_TOL."""
    import torch

    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.ops import ring_attention as ra

    B, T, N, H = 2, 2048, 12, 64
    scale = 1.0 / H ** 0.5
    gen = torch.Generator(device="cuda").manual_seed(16)
    q, k, v, ct = (torch.randn(B, T, N, H, generator=gen, device="cuda")
                   for _ in range(4))

    def run(fn):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out = fn(*leaves)
        return [out.detach()] + list(torch.autograd.grad((out * ct).sum(),
                                                         leaves))

    before = fa.splash_block_with_lse.launches
    ring = run(lambda a, b, c: ra.ring_splash(a, b, c, mesh, scale=scale))
    launches = fa.splash_block_with_lse.launches - before
    check(launches == SP * SP,
          f"ring-parity: ring_splash launched K3 {launches} times, not "
          f"{SP * SP}")
    refs = {
        "ring_splash_vs_plain_ring": (ring, run(
            lambda a, b, c: ra.ring_splash_ref(a, b, c, mesh, scale=scale))),
        "ring_splash_vs_k1": (ring, run(
            lambda a, b, c: fa.flash_attention(a, b, c, scale, False))),
        "causal_ring_attention_vs_k1": (run(
            lambda a, b, c: ra.ring_attention(a, b, c, mesh, causal=True,
                                              scale=scale)),
            run(lambda a, b, c: fa.flash_attention(a, b, c, scale, True)))}
    report, failed = {}, []
    for label, (got, want) in refs.items():
        grad_tol = CAUSAL_RING_TOL if label.startswith("causal") else None
        report[label] = {name: held(a, b, "float32",
                                    None if name == "out" else grad_tol)
                         for name, a, b in zip(("out", "dq", "dk", "dv"),
                                               got, want)}
        failed += [f"{label} {n}: {e}" for n, e in report[label].items()
                   if not e["ratio"] <= 1.0]
    check(not failed, "ring-parity: " + "; ".join(failed))
    return {"shape": [B, T, N, H], "k3_launches": launches, **report}


def phase_ring_parity():
    """The sp=4 in-process ring on the card at f32 (TF32 off): the op
    level (`_ring_op_parity`), then one step of a 2-layer, full-width
    BERT-base at 2 x 1024 under MeshConfig(sp=4) (every attention on
    ring_splash, K3 blocks) against the same step with no mesh on the
    card (K1) and on the CPU (plain versions): loss, every gradient and
    one AdamW step, at `_hold_train_step`'s tolerances."""
    import torch

    from paddle_tpu_torch.models import bert
    from paddle_tpu_torch.ops import attention as attn
    from paddle_tpu_torch.parallel.mesh import mesh_guard

    t0 = time.perf_counter()
    mesh = _sp_mesh()
    ops = _ring_op_parity(mesh)
    cfg = bert.BertConfig(layers=2, max_len=1024, dtype="float32")
    params, _ = bert.init(torch.Generator().manual_seed(16), cfg,
                          device="cpu")
    batch = bert.make_batch(np.random.RandomState(16), cfg, 2, seq_len=1024,
                            device="cpu")

    def loss_fn(p, b, g):
        return bert.pretrain_loss(p, cfg, b, rng=g, deterministic=True)

    attn.GATE_COUNTS.clear()
    with mesh_guard(mesh):
        sp = _one_train_step(loss_fn, params, batch, "cuda")
    gates = dict(attn.GATE_COUNTS)
    k3 = sp["counts"]["splash_block_with_lse"]
    # the model runs twice under the mesh (the grad call, then the step,
    # whose launches are counted): one ring call a layer, S blocks on
    # each of S ranks
    check(gates == {"ring_splash": 2 * cfg.layers} and
          k3 == cfg.layers * SP * SP and
          all(n == 0 for name, n in sp["counts"].items()
              if name != "splash_block_with_lse"),
          f"ring-parity: gates {gates}, launches of the step {sp['counts']}")
    k1 = _one_train_step(loss_fn, params, batch, "cuda")
    cpu = _one_train_step(loss_fn, params, batch, "cpu")
    print(json.dumps({
        "phase": "ring-parity", "ring": f"in-process sp={SP} on one card",
        "ops": ops,
        "model": "BertConfig(layers=2, max_len=1024), f32, 2 x 1024",
        "gate_counts": gates, "k3_launches_step": k3,
        "sp_vs_k1": _hold_train_step("ring-parity sp vs K1", sp, k1, params),
        "sp_vs_cpu": _hold_train_step("ring-parity sp vs CPU", sp, cpu,
                                      params),
        "seconds": time.perf_counter() - t0}))


def phase_bert_long_sp():
    """BERT-base at T 4096 as bench.py's bench_bert_long builds it
    (`BertConfig(max_len=4096, dropout=0.0)`, deterministic, AdamW),
    under mixed_bf16: first under MeshConfig(sp=4) on the in-process
    ring (every layer's attention on ring_splash, K3 16 times a call),
    at the first rung of bench_bert_long's ladder [8, 4, 2, 1] that
    fits, 2 warm-up and 10 timed steps; then the same step with no mesh
    (K1 at T 4096) on the same params and batch, so the ring's cost on
    one card is a number."""
    import torch

    from paddle_tpu_torch.models import bert
    from paddle_tpu_torch.parallel.mesh import mesh_guard

    t0 = time.perf_counter()
    T = 4096
    cfg = bert.BertConfig(max_len=T, dropout=0.0)
    mesh = _sp_mesh()

    def loss_fn(p, b, g):
        return bert.pretrain_loss(p, cfg, b, rng=g, deterministic=True)

    def setup(B):
        params, _ = bert.init(torch.Generator(device="cuda").manual_seed(0),
                              cfg, device="cuda")
        batch = bert.make_batch(torch.Generator(device="cuda").manual_seed(1),
                                cfg, B, seq_len=T)
        return params, batch, cfg.train_flops_per_seq(
            T, batch["masked_positions"].shape[1])

    torch.cuda.reset_peak_memory_stats()
    did_not_fit, sp_row = [], None
    for B in (8, 4, 2, 1):
        params, batch, flops = setup(B)
        try:
            with mesh_guard(mesh):
                sp_row = _train_run(
                    f"bert-base {B}x{T} sp={SP}", loss_fn, params, batch,
                    flops, 2, 10,
                    {"splash_block_with_lse": cfg.layers * SP * SP})
        except torch.cuda.OutOfMemoryError:
            did_not_fit.append(B)
        del params, batch
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        if sp_row is not None:
            break
    check(sp_row is not None, "bert-long-sp: no rung of [8, 4, 2, 1] fit")
    params, batch, flops = setup(B)
    k1_row = _train_run(f"bert-base {B}x{T} no mesh", loss_fn, params,
                        batch, flops, 2, 10, k1_per_step(cfg.layers))
    del params, batch
    print(json.dumps({
        "phase": "bert-long-sp",
        "model": f"BERT-base (BertConfig(max_len={T}, dropout=0.0)), "
                 f"mixed_bf16, deterministic",
        "optimizer": "AdamW lr 1e-4 wd 1e-4",
        "ring": f"in-process sp={SP} on one card", "batch": B,
        "rungs_that_did_not_fit": did_not_fit,
        "k3_launches_per_step": sp_row["launches_per_step"][
            "splash_block_with_lse"],
        "ring_cost_ms": sp_row["step_ms_median"] - k1_row["step_ms_median"],
        "runs": [sp_row, k1_row], "seconds": time.perf_counter() - t0}))
    return sp_row["launches"]


def phase_head_dim_gate():
    """BertConfig.tiny() (head dim 16, which the kernels do not take):
    one mixed_bf16 train step on the card, every attention call on
    mha's "xla" route (the JAX package's `_xla_mha` for hd % 64 != 0),
    decided by shape before any launch; no K1 or K2 kernel runs."""
    import torch

    from paddle_tpu_torch.models import bert
    from paddle_tpu_torch.ops import attention as ta
    from paddle_tpu_torch.parallel.train import make_train_step

    cfg = bert.BertConfig.tiny()
    params, _ = bert.init(torch.Generator(device="cuda").manual_seed(0), cfg,
                          device="cuda")
    batch = bert.make_batch(torch.Generator(device="cuda").manual_seed(1),
                            cfg, 8, seq_len=64)
    init, step = make_train_step(
        lambda p, b, g: bert.pretrain_loss(p, cfg, b, rng=g,
                                           deterministic=True),
        _adamw, device="cuda", precision="mixed_bf16")
    state = init(params)
    xla = ta.GATE_COUNTS["xla"]
    _kernel_counts(reset=True)
    losses = []
    for i in range(2):
        state, loss = step(state, batch, i)
        losses.append(loss.item())
    counts, routed = _kernel_counts(), ta.GATE_COUNTS["xla"] - xla
    check(all(np.isfinite(losses)), f"head-dim-gate: loss {losses}")
    check(routed == 2 * cfg.layers,
          f"head-dim-gate: {routed} calls on the xla route, not "
          f"{2 * cfg.layers}")
    check(not any(counts.values()),
          f"head-dim-gate: kernels launched {counts}")
    print(json.dumps({"phase": "head-dim-gate",
                      "model": "BertConfig.tiny() (head dim 16), mixed_bf16",
                      "batch": [8, 64], "losses": losses,
                      "xla_calls": routed, "launches": counts}))


# phase 19: BERT-base's widths at phase 7's first shape through
# train_loop, at RESILIENCE_LAYERS layers: the checkpoints' writes are
# most of the phase, and their size goes with the depth
RESILIENCE_STEPS = 6
RESILIENCE_LAYERS = 4
RESILIENCE_B, RESILIENCE_T = 256, 128
# one step each: no recompute, then recompute under each policy
RECOMPUTE_RUNS = ("none", None, "nothing", "dots", "dots_no_batch")
# the crashing run of phase 19(c): this script's run in a child process
CRASH_CHILD = ("import sys, chip_smoke; "
               "sys.exit(chip_smoke.resilience_child(sys.argv[1]))")


def _resilience_model():
    """BERT-base's widths at RESILIENCE_LAYERS layers (params from seed
    0) with dropout off: its layers, params, batch_fn(step) (256 x 128
    batches from numpy seed 1000 + step, None from RESILIENCE_STEPS on)
    and loss_fn."""
    import torch

    from paddle_tpu_torch.models import bert

    cfg = bert.BertConfig(layers=RESILIENCE_LAYERS)
    params, _ = bert.init(torch.Generator(device="cuda").manual_seed(0),
                          cfg, device="cuda")

    def batch_fn(step):
        if step >= RESILIENCE_STEPS:
            return None
        return bert.make_batch(np.random.RandomState(1000 + step), cfg,
                               RESILIENCE_B, seq_len=RESILIENCE_T,
                               device="cuda")

    def loss_fn(p, b, g):
        return bert.pretrain_loss(p, cfg, b, rng=g, deterministic=True)

    return cfg.layers, params, batch_fn, loss_fn


def _resilience_loop(root, params, batch_fn, loss_fn, resume=False):
    """`train_loop` under mixed_bf16 and AdamW with a CheckpointManager
    at `root` (save_every 2, keep_last_n 2), from `params` or, with
    `resume`, from the newest committed checkpoint restored into a fresh
    `init_state` template."""
    from paddle_tpu_torch.parallel.train import make_train_step, train_loop
    from paddle_tpu_torch.resilience import CheckpointManager

    init, step = make_train_step(loss_fn, _adamw, device="cuda",
                                 precision="mixed_bf16")
    mgr = CheckpointManager(root, keep_last_n=2)
    state = init(params)
    if resume:
        state = mgr.restore_latest(state)
        check(state is not None, f"no committed checkpoint under {root}")
    state, losses, stop = train_loop(step, state, batch_fn, rng=0,
                                     manager=mgr, save_every=2)
    return state, losses, stop, mgr


def resilience_child(root):
    """Phase 19(c)'s crashing run, in a process of its own: the same
    loop from the start under PADDLE_TPU_FAULT_SPEC (its parent sets
    step=3:crash, which exits with CRASH_EXIT_CODE at step 3)."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _resilience_loop(root, *_resilience_model()[1:])
    return 0


def _run_diff(a, b, steps):
    """The largest |difference| of two runs' losses at `steps` and of
    their final params; a run is (losses, params)."""
    return (max(abs(a[0][s] - b[0][s]) for s in steps),
            max((a[1][k].detach() - b[1][k].detach()).abs().max().item()
                for k in a[1]))


def _grad_recorder(params):
    """An optimizer that keeps the step's gradients and moves nothing,
    so every step of phase 19(d) starts from the same params."""
    import torch

    class GradRecorder(torch.optim.Optimizer):
        def __init__(self, ps):
            super().__init__(ps, {})
            self.grads = None

        @torch.no_grad()
        def step(self, closure=None):
            self.grads = [p.grad.clone() for g in self.param_groups
                          for p in g["params"]]

    return GradRecorder(params)


def _recompute_runs(layers, params, batch, loss_fn):
    """Phase 19(d): one step under each of RECOMPUTE_RUNS from the same
    state and batch, after one warm-up step. Each step's loss and
    gradients are held to the no-recompute step's within the difference
    between that step and its own warm-up (0 when the card repeats a
    step bit for bit); K1's launches a step are counted and a step is
    traced for the standalone delta kernel."""
    import torch

    from paddle_tpu_torch.parallel.train import TrainStrategy, make_train_step

    rows, ref, limit = [], None, None
    for policy in RECOMPUTE_RUNS:
        strategy = TrainStrategy() if policy == "none" else \
            TrainStrategy(recompute=True, recompute_policy=policy)
        init, step = make_train_step(loss_fn, _grad_recorder, device="cuda",
                                     precision="mixed_bf16",
                                     strategy=strategy)
        state = init(params)
        warm_loss = step(state, batch, 0)[1].item()
        warm_grads = state.opt_state.grads
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _kernel_counts(reset=True)
        t0 = time.perf_counter()
        loss = step(state, batch, 0)[1].item()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        counts = _kernel_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        grads = state.opt_state.grads
        if policy == "none":
            ref = (loss, grads)
            limit = (abs(loss - warm_loss),
                     max((a - b).abs().max().item()
                         for a, b in zip(grads, warm_grads)))
        del warm_grads
        err = (abs(loss - ref[0]),
               max((a - b).abs().max().item() for a, b in zip(grads, ref[1])))
        traced = _profiled_step(lambda: step(state, batch, 0)[1].item())
        want = k1_per_step(layers)
        if policy != "none":   # the recomputed forward runs K1-fwd again
            want["flash_attention_fwd_lse"] = 2 * layers
        rows.append({"recompute": policy, "loss": loss, "step_ms": ms,
                     "max_memory_gb": peak_gb, "launches": counts,
                     "loss_err": err[0], "grad_max_abs_err": err[1],
                     "device_busy_ms": traced["device_busy_ms"],
                     "delta_kernel_records": traced["delta_kernel_records"]})
        check(all(n == want.get(name, 0) for name, n in counts.items()),
              f"resilience (d) {policy}: launches {counts}, want {want}")
        check(err[0] <= limit[0] and err[1] <= limit[1],
              f"resilience (d) {policy}: loss and gradients {err} from no "
              f"recompute's, beyond its own repeat {limit}")
        check(traced["delta_kernel_records"] == 0,
              f"resilience (d) {policy}: a traced step ran delta_kernel")
        del state, grads
        torch.cuda.empty_cache()
    return rows, limit


def phase_resilience():
    """BERT-base's widths at RESILIENCE_LAYERS layers, 256 x 128
    (dropout off, mixed_bf16, AdamW) through `train_loop` with a
    CheckpointManager:
    (a) 6 steps uninterrupted, twice (the second gives the limit the
    resumed runs are held to: 0 when the card repeats the run bit for
    bit); (b) from the same params under PADDLE_TPU_FAULT_SPEC
    step=3:preempt, which stops with "preempted" and a committed step-3
    checkpoint, then a fresh template restored by restore_latest
    finishes the run; (c) a child process of this script under
    step=3:crash dies with CRASH_EXIT_CODE, and this process resumes
    from its step-2 checkpoint; (b) and (c) against (a): the losses of
    the steps they ran and the final params; (d) the recompute policies
    (`_recompute_runs`). Deletes its checkpoint directories."""
    import os
    import shutil
    import tempfile

    import torch

    from paddle_tpu_torch.observability import events
    from paddle_tpu_torch.resilience import CRASH_EXIT_CODE, faults, preemption

    t0 = time.perf_counter()
    layers, params, batch_fn, loss_fn = _resilience_model()
    steps = range(RESILIENCE_STEPS)
    root = tempfile.mkdtemp(prefix="chip_smoke_resilience_")
    try:
        runs, counts = [], None
        for i in range(2):
            if i == 0:
                _kernel_counts(reset=True)
            state, losses, stop, mgr = _resilience_loop(
                os.path.join(root, f"a{i}"), params, batch_fn, loss_fn)
            if i == 0:
                counts = _kernel_counts()
            check(stop == "completed" and state.step == RESILIENCE_STEPS
                  and mgr.committed_steps() == [4, 6],
                  f"resilience (a): stop {stop}, step {state.step}, "
                  f"committed {mgr.committed_steps()}")
            check(all(np.isfinite(list(losses.values()))),
                  f"resilience (a): losses {losses}")
            runs.append((losses, {k: v.detach().clone()
                                  for k, v in state.params.items()}))
            del state
        want = k1_per_step(layers)
        check(all(n == want.get(k, 0) * RESILIENCE_STEPS
                  for k, n in counts.items()),
              f"resilience (a): launches {counts} in {RESILIENCE_STEPS} "
              f"steps")
        repeat = _run_diff(runs[0], runs[1], steps)

        os.environ[faults.SPEC_ENV] = "step=3:preempt"
        try:
            state, losses, stop, mgr = _resilience_loop(
                os.path.join(root, "b"), params, batch_fn, loss_fn)
        finally:
            del os.environ[faults.SPEC_ENV]
            faults.reset()
            preemption.reset()
        committed = mgr.committed_steps()
        ckpt_gb = sum(os.path.getsize(os.path.join(d, f))
                      for d, _, fs in os.walk(mgr.step_dir(3))
                      for f in fs) / 1e9
        check(stop == "preempted" and state.step == 3 and 3 in committed,
              f"resilience (b): stop {stop} at step {state.step}, "
              f"committed {committed}")
        del state
        state, losses, stop, _ = _resilience_loop(
            os.path.join(root, "b"), params, batch_fn, loss_fn, resume=True)
        check(stop == "completed" and sorted(losses) == [3, 4, 5],
              f"resilience (b) resumed: stop {stop}, steps {sorted(losses)}")
        preempt = _run_diff(runs[0], (losses, state.params), range(3, 6))
        del state

        child = subprocess.run(
            [sys.executable, "-c", CRASH_CHILD, os.path.join(root, "c")],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            env=dict(os.environ, **{faults.SPEC_ENV: "step=3:crash"}),
            capture_output=True, text=True, timeout=600)
        check(child.returncode == CRASH_EXIT_CODE,
              f"resilience (c): the child exited {child.returncode}, not "
              f"{CRASH_EXIT_CODE}: {child.stderr[-2000:]}")
        state, losses, stop, _ = _resilience_loop(
            os.path.join(root, "c"), params, batch_fn, loss_fn, resume=True)
        check(stop == "completed" and sorted(losses) == [2, 3, 4, 5],
              f"resilience (c) resumed: stop {stop}, steps {sorted(losses)}")
        crash = _run_diff(runs[0], (losses, state.params), range(2, 6))
        a_losses = [runs[0][0][s] for s in steps]
        del state, runs
        io_s = {"save_s": [e["seconds"] for e in events.recent(
                    kind="checkpoint") if e.get("site") == "manager_save"],
                "restore_s": [e["seconds"] for e in events.recent(
                    kind="restore") if e.get("ok")]}
        for label, got in (("(b)", preempt), ("(c)", crash)):
            check(got[0] <= repeat[0] and got[1] <= repeat[1],
                  f"resilience {label}: the resumed run differs from the "
                  f"uninterrupted one by {got} (losses, params), beyond "
                  f"the repeat's {repeat}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    recompute, recompute_limit = _recompute_runs(layers, params,
                                                 batch_fn(0), loss_fn)
    print(json.dumps({
        "phase": "resilience", "card": card(),
        "model": f"BertConfig(layers={layers}), mixed_bf16, dropout off",
        "optimizer": "AdamW lr 1e-4 wd 1e-4",
        "batch": [RESILIENCE_B, RESILIENCE_T], "steps": RESILIENCE_STEPS,
        "checkpoints": "save_every 2, keep_last_n 2",
        "crash_child": f"the full model ({layers} layers), as the parent",
        "repeat_loss_max_abs_diff": repeat[0],
        "repeat_param_max_abs_diff": repeat[1],
        "preempt_resume_diff": preempt, "crash_resume_diff": crash,
        "checkpoint_gb": ckpt_gb, **io_s,
        "losses": a_losses,
        "launches": counts, "recompute_repeat_limit": recompute_limit,
        "recompute": recompute,
        "seconds": time.perf_counter() - t0}))
    return counts


FLUID_B = 256          # bench.py's LeNet rung: batch, steps, chained
FLUID_STEPS = 80
FLUID_CHAIN = 40
# phase 20 (b), the card against the CPU at f32 with TF32 off: the loss
# relative, a gradient against its tensor's largest value, a param
# against max(1, its largest value) beyond `fluid_adam_slack`
FLUID_TOL = {"loss": 1e-5, "grad": 1e-5, "param": 1e-5}


def lenet_rung_program(pt):
    """bench.py's `_build_lenet_program` (its LeNet rung), built with
    the fluid package `pt`: (main, startup, loss)."""
    main, startup = pt.Program(), pt.Program()
    with pt.framework.unique_name.guard(), pt.program_guard(main, startup):
        x = pt.layers.data(name="x", shape=[1, 28, 28], dtype="float32")
        y = pt.layers.data(name="y", shape=[1], dtype="int64")
        c = pt.layers.conv2d(x, num_filters=6, filter_size=5, act="relu")
        c = pt.layers.pool2d(c, pool_size=2, pool_stride=2)
        c = pt.layers.conv2d(c, num_filters=16, filter_size=5, act="relu")
        c = pt.layers.pool2d(c, pool_size=2, pool_stride=2)
        h = pt.layers.fc(c, size=120, act="relu")
        h = pt.layers.fc(h, size=84, act="relu")
        logits = pt.layers.fc(h, size=10)
        loss = pt.layers.mean(
            pt.layers.softmax_with_cross_entropy(logits, y))
        pt.optimizer.Adam(learning_rate=2e-3).minimize(loss)
    return main, startup, loss


# The Paddle book's image classifier (book/test_image_classification.py,
# `vgg_bn_drop`) on CIFAR-10 shapes: each block's conv widths and
# batch-norm drop rates
VGG_BLOCKS = ((64, (0.3, 0.0)), (128, (0.4, 0.0)), (256, (0.4, 0.4, 0.0)),
              (512, (0.4, 0.4, 0.0)), (512, (0.4, 0.4, 0.0)))


def vgg_bn_program(pt, drop=1.0, width=1):
    """The book's VGG-16-BN classifier built with the fluid package `pt`:
    five `nets.img_conv_group` blocks (3 x 3 convs with batch norm, ReLU
    and the block's drop rates, max pool 2/2), dropout 0.5, fc 512,
    batch_norm(relu), dropout 0.5, fc 512, fc 10 softmax,
    `cross_entropy`, `mean`, `accuracy`, Adam 1e-3; input [3, 32, 32]
    f32, int64 labels. `drop` scales every drop rate (0 where two
    packages must give the same numbers: their dropout streams differ)
    and `width` divides every width but the classes'. The `for_test`
    clone is taken before the optimizer, as the book takes it:
    (main, startup, test_program, loss, acc)."""
    main, startup = pt.Program(), pt.Program()
    with pt.framework.unique_name.guard(), pt.program_guard(main, startup):
        img = pt.layers.data(name="img", shape=[3, 32, 32], dtype="float32")
        label = pt.layers.data(name="label", shape=[1], dtype="int64")
        net = img
        for filters, drops in VGG_BLOCKS:
            net = pt.nets.img_conv_group(
                input=net, pool_size=2, pool_stride=2,
                conv_num_filter=[filters // width] * len(drops),
                conv_filter_size=3, conv_act="relu",
                conv_with_batchnorm=True,
                conv_batchnorm_drop_rate=[d * drop for d in drops],
                pool_type="max")
        net = pt.layers.dropout(x=net, dropout_prob=0.5 * drop)
        net = pt.layers.fc(input=net, size=512 // width, act=None)
        net = pt.layers.batch_norm(input=net, act="relu")
        net = pt.layers.dropout(x=net, dropout_prob=0.5 * drop)
        net = pt.layers.fc(input=net, size=512 // width, act=None)
        predict = pt.layers.fc(input=net, size=10, act="softmax")
        loss = pt.layers.mean(pt.layers.cross_entropy(input=predict,
                                                      label=label))
        acc = pt.layers.accuracy(input=predict, label=label)
        test_program = main.clone(for_test=True)
        pt.optimizer.Adam(learning_rate=1e-3).minimize(loss)
    return main, startup, test_program, loss, acc


def bn_stat_names(main):
    """The running mean and variance of every batch_norm op of `main`."""
    return [op.outputs[slot][0] for op in main.desc.block(0).ops
            if op.type == "batch_norm" for slot in ("MeanOut", "VarianceOut")]


def vgg_grad_errors(main, params, got, want):
    """The largest differences of two steps' gradients (`got`, `want`:
    one array a name of `params`) against the step's largest gradient,
    in two classes. "grad": the params no batch norm's statistics stand
    between and the loss (those the forward ops after the last
    batch_norm read, and its Scale and Bias). "grad_under_bn": the
    rest. The JAX package's batch norm takes a one-pass f32 variance,
    whose gradient carries a per-channel term set by rounding, so the
    second class moves with the order of the reductions (ROADMAP F13);
    a ReLU at its kink moves one element's term in either."""
    ops = [op for op in main.desc.block(0).ops
           if not op.type.endswith("_grad")
           and op.type not in ("adam", "rmsprop")]
    last = max(i for i, op in enumerate(ops) if op.type == "batch_norm")
    above = {n for op in ops[last + 1:] for n in op.input_names()}
    above.update(ops[last].inputs["Scale"] + ops[last].inputs["Bias"])
    scale = max(float(np.abs(b).max()) for b in want)
    out = {"grad": (0.0, None), "grad_under_bn": (0.0, None)}
    for n, a, b in zip(params, got, want):
        err = float(np.abs(np.asarray(a, np.float64) - b).max())
        key = "grad" if n in above else "grad_under_bn"
        out[key] = max(out[key], (err / scale, n), key=lambda t: t[0])
    return {**{k: v[0] for k, v in out.items()},
            "worst_params": {k: v[1] for k, v in out.items()}}


# The book's embedding programs (tests/test_book.py): word2vec on
# (word, next word) pairs, the recommender's cos_sim towers, the
# imikolov N-gram model under hierarchical sigmoid; each (main, startup,
# loss), built with the fluid package `pt`
W2V_V, W2V_E = 100, 16
REC_USERS, REC_MOVIES, REC_N = 30, 40, 128
IMIKOLOV_VOCAB, IMIKOLOV_N = 2073, 5


def word2vec_program(pt):
    main, startup = pt.Program(), pt.Program()
    with pt.framework.unique_name.guard(), pt.program_guard(main, startup):
        w = pt.layers.data(name="w", shape=[1], dtype="int64")
        ctx = pt.layers.data(name="ctx", shape=[1], dtype="int64")
        emb = pt.layers.embedding(input=w, size=[W2V_V, W2V_E])
        emb = pt.layers.reshape(emb, shape=[-1, W2V_E])
        logits = pt.layers.fc(input=emb, size=W2V_V)
        loss = pt.layers.mean(pt.layers.softmax_with_cross_entropy(
            logits=logits, label=ctx))
        pt.optimizer.Adam(0.02).minimize(loss)
    return main, startup, loss


def recommender_program(pt):
    main, startup = pt.Program(), pt.Program()
    with pt.framework.unique_name.guard(), pt.program_guard(main, startup):
        u = pt.layers.data(name="u", shape=[1], dtype="int64")
        m = pt.layers.data(name="m", shape=[1], dtype="int64")
        r = pt.layers.data(name="r", shape=[1], dtype="float32")
        uemb = pt.layers.reshape(pt.layers.embedding(
            u, size=[REC_USERS, 16]), [-1, 16])
        memb = pt.layers.reshape(pt.layers.embedding(
            m, size=[REC_MOVIES, 16]), [-1, 16])
        utower = pt.layers.fc(uemb, size=16, act="tanh")
        mtower = pt.layers.fc(memb, size=16, act="tanh")
        pred = pt.layers.scale(pt.layers.cos_sim(utower, mtower), scale=5.0)
        loss = pt.layers.mean(pt.layers.square_error_cost(input=pred,
                                                          label=r))
        pt.optimizer.Adam(learning_rate=0.01).minimize(loss)
    return main, startup, loss


def hsigmoid_program(pt):
    n = IMIKOLOV_N
    main, startup = pt.Program(), pt.Program()
    with pt.framework.unique_name.guard(), pt.program_guard(main, startup):
        words = pt.layers.data(name="w", shape=[n - 1], dtype="int64")
        target = pt.layers.data(name="t", shape=[1], dtype="int64")
        emb = pt.layers.embedding(words, size=[IMIKOLOV_VOCAB, 32])
        feat = pt.layers.reshape(emb, [-1, (n - 1) * 32])
        hidden = pt.layers.fc(feat, size=64, act="relu")
        loss = pt.layers.mean(pt.layers.hsigmoid(hidden, target,
                                                 num_classes=IMIKOLOV_VOCAB))
        pt.optimizer.Adam(learning_rate=0.02).minimize(loss)
    return main, startup, loss


def book_embedding_feeds():
    """The three programs' feeds as tests/test_book.py makes them:
    {name: (feed, steps, the share of the first loss the last must be
    under)}."""
    rng = np.random.RandomState(0)
    w = rng.randint(0, W2V_V, (256, 1)).astype("int64")
    rng = np.random.RandomState(13)
    usr = rng.randint(0, REC_USERS, (REC_N, 1)).astype("int64")
    mov = rng.randint(0, REC_MOVIES, (REC_N, 1)).astype("int64")
    score = (rng.randn(REC_USERS, 4)[usr[:, 0]] *
             rng.randn(REC_MOVIES, 4)[mov[:, 0]]).sum(1)
    rating = (2.5 + 2.5 * np.tanh(score)).astype("float32")[:, None]
    grams = synthetic_imikolov(256)
    return {"word2vec": ({"w": w, "ctx": (w + 1) % W2V_V}, 40, 0.5),
            "recommender": ({"u": usr, "m": mov, "r": rating}, 60, 0.5),
            "hsigmoid": ({"w": grams[:, :-1], "t": grams[:, -1:]}, 40, 0.7)}


BOOK_EMBEDDING = {"word2vec": word2vec_program,
                  "recommender": recommender_program,
                  "hsigmoid": hsigmoid_program}


# The book's sequence programs in their padded form, as the JAX
# package's tests write them (fc(..., num_flatten_dims=2) on [N, T, D],
# the lengths fed as their own [N] input): understand_sentiment's
# stacked_lstm_net, label_semantic_roles' db_lstm with its CRF, and
# machine_translation's GRU encoder-decoder with a beam-search step
# program. Each function takes the fluid package `pt` and returns a dict
# of its programs and the variables a run fetches; the widths default
# to the book's (the dictionaries' sizes to the JAX package's synthetic
# readers', `dataset/imdb.py` and `dataset/conll05.py`: the book's own
# dictionaries are not in the repository).
SENT_VOCAB, SENT_EMB, SENT_HID, SENT_STACKED = 5147, 128, 512, 3
SENT_B, SENT_T, SENT_LR = 128, 100, 0.002
SRL_WORDS, SRL_VERBS, SRL_LABELS, SRL_MARKS = 1000, 50, 9, 2
SRL_WORD_DIM, SRL_MARK_DIM, SRL_HID, SRL_DEPTH = 32, 5, 512, 8
SRL_B, SRL_T, SRL_CRF_LR = 10, 29, 1e-3
SRL_CHUNK_TYPES = 4            # ceil((SRL_LABELS - 1) / 2), IOB
SRL_CTX = ("word", "ctx_n2", "ctx_n1", "ctx_0", "ctx_p1", "ctx_p2")
MT_VOCAB, MT_WORD, MT_HID, MT_BEAM, MT_LEN, MT_B = 30000, 16, 32, 2, 8, 2
MT_BOS, MT_END, MT_LR = 1, 0, 0.01


def sentiment_program(pt, emb=SENT_EMB, hid=SENT_HID, stacked=SENT_STACKED,
                      T=SENT_T, vocab=SENT_VOCAB):
    """understand_sentiment's stacked_lstm_net: embedding, fc and
    dynamic_lstm (H = hid / 4), then `stacked - 1` more fc([fc, lstm])
    and dynamic_lstm pairs, is_reverse on the even ones; max
    sequence_pool of the last fc and lstm, a 2-class softmax fc,
    cross_entropy, Adagrad."""
    main, startup = pt.Program(), pt.Program()
    with pt.framework.unique_name.guard(), pt.program_guard(main, startup):
        words = pt.layers.data(name="words", shape=[T], dtype="int64")
        ln = pt.layers.data(name="ln", shape=[], dtype="int64")
        label = pt.layers.data(name="label", shape=[1], dtype="int64")
        e = pt.layers.embedding(words, size=[vocab, emb], is_sparse=True)
        fc1 = pt.layers.fc(e, size=hid, num_flatten_dims=2)
        lstm1, _ = pt.layers.dynamic_lstm(fc1, size=hid)
        inputs = [fc1, lstm1]
        for i in range(2, stacked + 1):
            fc = pt.layers.fc(inputs, size=hid, num_flatten_dims=2)
            lstm, _ = pt.layers.dynamic_lstm(fc, size=hid,
                                             is_reverse=(i % 2) == 0)
            inputs = [fc, lstm]
        fc_last = pt.layers.sequence_pool(inputs[0], "max", length=ln)
        lstm_last = pt.layers.sequence_pool(inputs[1], "max", length=ln)
        pred = pt.layers.fc([fc_last, lstm_last], size=2, act="softmax")
        loss = pt.layers.mean(pt.layers.cross_entropy(pred, label))
        acc = pt.layers.accuracy(pred, label)
        test = main.clone(for_test=True)
        pt.optimizer.Adagrad(learning_rate=SENT_LR).minimize(loss)
    return {"main": main, "startup": startup, "test": test, "loss": loss,
            "fetch": {"acc": acc, "pred": pred}}


def srl_program(pt, word_dim=SRL_WORD_DIM, mark_dim=SRL_MARK_DIM,
                hid=SRL_HID, depth=SRL_DEPTH, T=SRL_T):
    """label_semantic_roles' db_lstm: eight embeddings (six context
    words on the frozen `emb`, the verb, the mark), a tanh fc each,
    summed; `depth` dynamic_lstms (H = hid / 4) with the book's relu
    candidate and sigmoid gate and cell activations (which both packages
    drop, ROADMAP F21), alternating is_reverse; a 2-fc emission to the
    labels; linear_chain_crf on `crfw` (its lr 1e-3), SGD 0.01 under
    exponential_decay; crf_decoding and chunk_eval (IOB)."""
    main, startup = pt.Program(), pt.Program()
    with pt.framework.unique_name.guard(), pt.program_guard(main, startup):
        ctx = [pt.layers.data(name=n, shape=[T], dtype="int64")
               for n in SRL_CTX]
        verb = pt.layers.data(name="verb", shape=[T], dtype="int64")
        mark = pt.layers.data(name="mark", shape=[T], dtype="int64")
        target = pt.layers.data(name="target", shape=[T], dtype="int64")
        ln = pt.layers.data(name="ln", shape=[], dtype="int64")
        embs = [pt.layers.embedding(
            x, size=[SRL_WORDS, word_dim],
            param_attr=pt.ParamAttr(name="emb", trainable=False))
            for x in ctx]
        embs.append(pt.layers.embedding(verb, size=[SRL_VERBS, word_dim],
                                        param_attr=pt.ParamAttr(name="vemb")))
        embs.append(pt.layers.embedding(mark, size=[SRL_MARKS, mark_dim]))

        def fc(x, size):
            return pt.layers.fc(x, size=size, act="tanh", num_flatten_dims=2)

        def lstm(x, reverse):
            return pt.layers.dynamic_lstm(
                x, size=hid, candidate_activation="relu",
                gate_activation="sigmoid", cell_activation="sigmoid",
                is_reverse=reverse)[0]

        hidden = pt.layers.sum([fc(e, hid) for e in embs])
        tmp = [hidden, lstm(hidden, False)]
        for i in range(1, depth):
            mix = pt.layers.sum([fc(tmp[0], hid), fc(tmp[1], hid)])
            tmp = [mix, lstm(mix, (i % 2) == 1)]
        feature = pt.layers.sum([fc(tmp[0], SRL_LABELS),
                                  fc(tmp[1], SRL_LABELS)])
        cost = pt.layers.linear_chain_crf(
            feature, target, length=ln,
            param_attr=pt.ParamAttr(name="crfw", learning_rate=SRL_CRF_LR))
        loss = pt.layers.mean(cost)
        decode = pt.layers.crf_decoding(
            feature, param_attr=pt.ParamAttr(name="crfw"), length=ln)
        chunk = pt.layers.chunk_eval(decode, target, "IOB", SRL_CHUNK_TYPES,
                                     seq_length=ln)
        test = main.clone(for_test=True)
        pt.optimizer.SGD(learning_rate=pt.layers.exponential_decay(
            learning_rate=0.01, decay_steps=100000, decay_rate=0.5,
            staircase=True)).minimize(loss)
    return {"main": main, "startup": startup, "test": test, "loss": loss,
            "fetch": {"decode": decode, "emission": feature,
                      "precision": chunk[0], "recall": chunk[1],
                      "f1": chunk[2], "num_correct": chunk[5]}}


def _mt_gru(pt, x, h0=None, side="enc"):
    return pt.layers.gru(x, MT_HID, h0=h0,
                         param_attr=pt.ParamAttr(name=side + "g"),
                         bias_attr=pt.ParamAttr(name=side + "b"))


def _mt_embedding(pt, x, name, vocab, word):
    return pt.layers.embedding(x, size=[vocab, word],
                               param_attr=pt.ParamAttr(name=name))


def mt_programs(pt, vocab=MT_VOCAB, word=MT_WORD, K=MT_BEAM, T=MT_LEN):
    """machine_translation as tests/test_beam_search.py's decode loop
    builds it: "main" trains a GRU encoder-decoder (the decoder starts
    from the encoder's last state) on shifted targets, Adam; "encoder"
    gives that state; "test" is one decode step for every beam (the
    decoder GRU one step from `h`, softmax, `beam_search` on raw
    probabilities); "decode" assembles the steps with
    `beam_search_decode` and backtracks them with `gather_tree`."""
    main, startup = pt.Program(), pt.Program()
    with pt.framework.unique_name.guard(), pt.program_guard(main, startup):
        s = pt.layers.data(name="s", shape=[T], dtype="int64")
        ti = pt.layers.data(name="ti", shape=[T], dtype="int64")
        to = pt.layers.data(name="to", shape=[T], dtype="int64")
        _, enc = _mt_gru(pt, _mt_embedding(pt, s, "semb", vocab, word))
        dec, _ = _mt_gru(pt, _mt_embedding(pt, ti, "temb", vocab, word),
                         h0=enc, side="dec")
        logits = pt.layers.fc(dec, size=vocab, num_flatten_dims=2,
                              param_attr=pt.ParamAttr(name="proj_w"),
                              bias_attr=pt.ParamAttr(name="proj_b"))
        loss = pt.layers.mean(pt.layers.softmax_with_cross_entropy(
            logits, pt.layers.unsqueeze(to, axes=[2])))
        pt.optimizer.Adam(learning_rate=MT_LR).minimize(loss)
    encoder = pt.Program()
    with pt.framework.unique_name.guard(), \
            pt.program_guard(encoder, pt.Program()):
        s = pt.layers.data(name="s", shape=[T], dtype="int64")
        _, enc_state = _mt_gru(pt, _mt_embedding(pt, s, "semb", vocab, word))
    step = pt.Program()
    with pt.framework.unique_name.guard(), \
            pt.program_guard(step, pt.Program()):
        h_in = pt.layers.data(name="h", shape=[K, MT_HID], dtype="float32")
        pid = pt.layers.data(name="pid", shape=[K], dtype="int64")
        psc = pt.layers.data(name="psc", shape=[K], dtype="float32")
        pemb = _mt_embedding(pt, pt.layers.unsqueeze(pid, axes=[2]), "temb",
                             vocab, word)
        pemb = pt.layers.reshape(pemb, [-1, 1, word])
        dec2, h_out = _mt_gru(pt, pemb, h0=pt.layers.reshape(h_in,
                                                             [-1, MT_HID]),
                              side="dec")
        logits2 = pt.layers.fc(pt.layers.reshape(dec2, [-1, MT_HID]),
                               size=vocab,
                               param_attr=pt.ParamAttr(name="proj_w"),
                               bias_attr=pt.ParamAttr(name="proj_b"))
        probs = pt.layers.reshape(pt.layers.softmax(logits2), [-1, K, vocab])
        sel, sc, par = pt.layers.beam_search(
            pid, psc, None, probs, beam_size=K, end_id=MT_END,
            is_accumulated=False, return_parent_idx=True)
        h_new = pt.layers.reshape(h_out, [-1, K, MT_HID])
    decode = pt.Program()
    with pt.framework.unique_name.guard(), \
            pt.program_guard(decode, pt.Program()):
        ids, parents, scores = (pt.layers.data(
            name=n, shape=[-1, -1, K], dtype=dt, append_batch_size=False)
            for n, dt in (("ids", "int64"), ("parents", "int64"),
                          ("scores", "float32")))
        sent, sent_sc = pt.layers.beam_search_decode(ids, scores, parents,
                                                     K, MT_END)
        tree = pt.layers.gather_tree(ids, parents)
    return {"main": main, "startup": startup, "test": step, "loss": loss,
            "encoder": encoder, "decode": decode,
            "fetch": {"enc": enc_state, "sel": sel, "sc": sc, "par": par,
                      "h_new": h_new, "probs": probs, "sent": sent,
                      "sent_sc": sent_sc, "tree": tree}}


BOOK_SEQUENCE = {"sentiment": sentiment_program, "srl": srl_program,
                 "translation": mt_programs}


def sentiment_feed(rng, n=SENT_B, T=SENT_T, vocab=SENT_VOCAB):
    """A padded batch drawn as `dataset/imdb.py`'s reader draws it:
    label U{0, 1}, length U{10..T-1}, tokens normal around a
    class-dependent centre, clipped to the dictionary."""
    words = np.zeros((n, T), "int64")
    ln = np.zeros((n,), "int64")
    label = np.zeros((n, 1), "int64")
    for i in range(n):
        label[i] = rng.randint(0, 2)
        ln[i] = rng.randint(min(10, T - 1), T)
        centre = vocab // 4 if label[i] == 0 else 3 * vocab // 4
        words[i, :ln[i]] = np.clip(rng.normal(centre, vocab // 8, ln[i]),
                                   0, vocab - 1).astype("int64")
    return {"words": words, "ln": ln, "label": label}


def srl_feed(rng, n=SRL_B, T=SRL_T):
    """A padded batch drawn as `dataset/conll05.py`'s reader draws it:
    length U{5..T}, words, the predicate's position and its window,
    the verb, the mark, and labels (word + distance to the predicate)
    mod 9."""
    feed = {k: np.zeros((n, T), "int64")
            for k in SRL_CTX + ("verb", "mark", "target")}
    feed["ln"] = np.zeros((n,), "int64")
    for i in range(n):
        length = rng.randint(min(5, T), T + 1)
        words = rng.randint(0, SRL_WORDS, length)
        pred = rng.randint(0, length)
        feed["ln"][i] = length
        feed["word"][i, :length] = words
        for name, off in zip(SRL_CTX[1:], (-2, -1, 0, 1, 2)):
            feed[name][i, :length] = words[np.clip(pred + off, 0, length - 1)]
        feed["verb"][i, :length] = words[pred] % SRL_VERBS
        feed["mark"][i, :length] = np.arange(length) == pred
        feed["target"][i, :length] = (words + np.abs(np.arange(length) - pred)
                                      ) % SRL_LABELS
    return feed


def mt_feed(rng, n=MT_B, T=MT_LEN, vocab=MT_VOCAB):
    """A copy task: target = source, fed shifted after <s>."""
    src = rng.randint(2, vocab, (n, T)).astype("int64")
    ti = np.concatenate([np.full((n, 1), MT_BOS, "int64"), src[:, :-1]], 1)
    return {"s": src, "ti": ti, "to": src.copy()}


def crf_path_score(emission, transition, path, length):
    """The score of one tag path under a CRF (float64): start, emissions
    and transitions up to `length`, end."""
    e = np.asarray(emission, np.float64)
    tr = np.asarray(transition, np.float64)
    p = np.asarray(path)[:length]
    if length == 0:
        return 0.0
    return float(tr[0, p[0]] + e[np.arange(length), p].sum() +
                 tr[2 + p[:-1], p[1:]].sum() + tr[1, p[-1]])


def mt_decode(exe, prog, scope, src):
    """The beam decode of `src` [B, T]: the encoder's state, then
    MT_LEN steps of the step program (only beam 0 live at first; the
    decoder state regrouped by parent between steps), then the decode
    program. Returns {"sent": sentence ids [B, K, MT_LEN], "sent_sc":
    their scores, "tree": the gather_tree trellis, "steps": each step's
    selected ids [MT_LEN, B, K], "cands": each step's candidate scores
    [B, K, V], accumulated in float64, "step_ms": each step's wall
    ms}."""
    f = prog["fetch"]
    b, K = src.shape[0], MT_BEAM
    enc = np.asarray(exe.run(prog["encoder"], feed={"s": src},
                             fetch_list=[f["enc"]], scope=scope)[0])
    pre_ids = np.full((b, K), MT_BOS, "int64")
    pre_sc = np.zeros((b, K), "float32")
    pre_sc[:, 1:] = -1e9
    h = np.tile(enc[:, None, :], (1, K, 1)).astype("float32")
    ids, pars, scs, cands, ms = [], [], [], [], []
    for _ in range(MT_LEN):
        t0 = time.perf_counter()
        sel, sc, par, h_new, probs = (np.asarray(v) for v in exe.run(
            prog["test"], feed={"h": h, "pid": pre_ids, "psc": pre_sc},
            fetch_list=[f["sel"], f["sc"], f["par"], f["h_new"],
                        f["probs"]], scope=scope))
        ms.append((time.perf_counter() - t0) * 1e3)
        cands.append(pre_sc[:, :, None].astype(np.float64) +
                     np.log(np.maximum(probs.astype(np.float64), 1e-20)))
        h = np.take_along_axis(h_new, par[:, :, None], 1)
        pre_ids, pre_sc = sel, sc
        ids.append(sel)
        pars.append(par)
        scs.append(sc)
    sent, sent_sc, tree = (np.asarray(v) for v in exe.run(
        prog["decode"], feed={"ids": np.stack(ids), "parents": np.stack(pars),
                              "scores": np.stack(scs)},
        fetch_list=[f["sent"], f["sent_sc"], f["tree"]], scope=scope))
    return {"sent": sent, "sent_sc": sent_sc, "tree": tree,
            "steps": np.stack(ids), "cands": cands, "step_ms": ms}


def lenet_rung_logits(main):
    """The name of the rung's logits: the Logits input of its
    softmax_with_cross_entropy op."""
    return next(op.inputs["Logits"][0] for op in main.desc.block(0).ops
                if op.type == "softmax_with_cross_entropy")


def fluid_adam_slack(lr, g_a, g_b):
    """How far a gradient difference can move one Adam step (beta1 0.9,
    beta2 0.999, eps 1e-8, steps 1-3): |d update / d g| <= 2 lr / (|g| +
    eps / sqrt(1 - beta2)) (tests/test_torch_fluid_program.py)."""
    return 2 * lr * np.abs(g_a - g_b) / (np.abs(g_b) + 1e-8 / np.sqrt(1e-3))


def synthetic_mnist(n, seed=0):
    """The JAX package's synthetic mnist (`dataset/mnist.py`): class k a
    thresholded stripe pattern at angle k * 18 degrees plus noise, in
    [-1, 1]: (images [n, 1, 28, 28] f32, labels [n, 1] int64)."""
    rng = np.random.RandomState(seed)
    ys = rng.randint(0, 10, size=n)
    yy, xx = np.mgrid[0:28, 0:28]
    xs = np.zeros((n, 784), np.float32)
    for i, k in enumerate(ys):
        angle = k * np.pi / 10.0
        stripe = np.sin((xx * np.cos(angle) + yy * np.sin(angle)) * 0.7 + k)
        img = (stripe > 0.3).astype(np.float32) + rng.normal(0, 0.15, (28, 28))
        xs[i] = np.clip(img, 0, 1).reshape(-1) * 2.0 - 1.0
    return xs.reshape(n, 1, 28, 28), ys.astype(np.int64).reshape(n, 1)


def synthetic_housing(n=404, seed=0):
    """The JAX package's synthetic uci_housing (`dataset/uci_housing.py`):
    y = x W + 3 + noise over 13 normal features: (x [n, 13], y [n, 1])."""
    w = np.random.RandomState(7).normal(0, 1, size=(13,)).astype(np.float32)
    rng = np.random.RandomState(seed)
    x = rng.normal(0, 1, size=(n, 13)).astype(np.float32)
    y = x @ w + 3.0 + rng.normal(0, 0.1, size=n).astype(np.float32)
    return x, y.astype(np.float32).reshape(n, 1)


def synthetic_imikolov(n, gram_n=IMIKOLOV_N):
    """The first `n` N-grams of the JAX package's synthetic imikolov
    train reader (`dataset/imikolov.py`): 500 Markov sentences, next word
    (2 w + U{0..4}) mod 2073, seed 0: an int64 [n, gram_n] array."""
    rng = np.random.RandomState(0)
    out = []
    for _ in range(500):
        length = rng.randint(gram_n + 1, 30)
        sent = [int(rng.randint(0, IMIKOLOV_VOCAB))]
        for _ in range(length - 1):
            sent.append((2 * sent[-1] + rng.randint(0, 5)) % IMIKOLOV_VOCAB)
        for i in range(len(sent) - gram_n + 1):
            out.append(sent[i:i + gram_n])
            if len(out) == n:
                return np.array(out, "int64")
    return np.array(out, "int64")


def _scope_copy(pt, scope):
    """A new scope holding a clone of each of `scope`'s variables."""
    import torch

    out = pt.Scope()
    for n in scope.local_var_names():
        v = scope.find_var(n)
        out.set_var(n, v.clone() if isinstance(v, torch.Tensor) else v)
    return out


def _fluid_rung(pt, feed):
    """Phase 20 (a): bench.py's LeNet rung on the card."""
    import torch

    main, startup, loss = lenet_rung_program(pt)
    exe = pt.Executor(pt.CUDAPlace(0))
    scope = pt.Scope()
    exe.run(startup, scope=scope)

    def step(s=scope):
        return float(exe.run(main, feed=feed, fetch_list=[loss],
                             scope=s)[0][0])

    losses = [step()]
    t0 = time.perf_counter()
    losses += [step() for _ in range(FLUID_STEPS)]
    dt = time.perf_counter() - t0
    cache = exe.cache_stats()
    check(cache == {"hits": FLUID_STEPS, "misses": 2, "entries": 2},
          f"fluid: main must miss once, then hit: {cache}")
    check(all(np.isfinite(losses)) and losses[-1] < 0.5 * losses[0],
          f"fluid: the rung's loss did not halve: {losses[0]} -> "
          f"{losses[-1]}")

    # run_chained against sequential steps from the same scope copy,
    # bit for bit: the same kernels in the same order (cuDNN
    # deterministic, so its convolution backward picks no atomics)
    torch.backends.cudnn.deterministic = True
    try:
        a, b = _scope_copy(pt, scope), _scope_copy(pt, scope)
        chained = exe.run_chained(main, feed=feed, fetch_list=[loss],
                                  n_steps=FLUID_CHAIN, scope=a)[0]
        seq = [step(b) for _ in range(FLUID_CHAIN)]
    finally:
        torch.backends.cudnn.deterministic = False
    check(chained.shape == (FLUID_CHAIN, 1) and
          float(chained[-1, 0]) == seq[-1],
          f"fluid: run_chained's last loss {float(chained[-1, 0])} != "
          f"sequential {seq[-1]}")

    def chained_ms(**kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = exe.run_chained(main, feed=feed, fetch_list=[loss],
                              n_steps=FLUID_CHAIN, scope=scope, **kw)[0]
        return (time.perf_counter() - t0) * 1e3 / FLUID_CHAIN, \
            float(out[-1, 0])

    rolled_ms, _ = chained_ms(unroll=False)
    auto_ms, last = chained_ms()
    check(np.isfinite(last), "fluid: run_chained's loss is not finite")
    traced = _profiled_step(lambda: exe.run(main, feed=feed,
                                            fetch_list=[loss], scope=scope))
    grad_ops = sum(op.type.endswith("_grad") for op in main.desc.block(0).ops)
    return {"samples_per_s": FLUID_B * FLUID_STEPS / dt,
            "step_ms": dt * 1e3 / FLUID_STEPS,
            "loss_first": losses[0], "loss_last": losses[-1],
            "cache": cache, "chained_ms_unroll_false": rolled_ms,
            "chained_ms_default": auto_ms, "chained_last_loss": last,
            "chained_equals_sequential": True,
            "ops_a_step": len(main.desc.block(0).ops),
            "grad_ops_replaying_their_forward": grad_ops,
            "traced_step": {k: traced[k] for k in (
                "wall_ms", "device_busy_ms", "device_idle_share",
                "device_events")},
            "top_kernels": traced["top_kernels"][:6]}


def _fluid_parity(pt, feed):
    """Phase 20 (b): the rung on the card against the CPU, 3 Adam steps
    from the same numpy params, each step from the CPU's state."""
    from paddle_tpu_torch.convert import scope_from_numpy

    main, startup, loss = lenet_rung_program(pt)
    cuda, cpu = pt.CUDAPlace(0), pt.CPUPlace()
    exe_c, exe_h = pt.Executor(cuda), pt.Executor(cpu)
    s0 = pt.Scope()
    exe_c.run(startup, scope=s0)
    pers = [v.name for v in startup.list_vars() if v.persistable]
    params = [p.name for p in main.all_parameters()]
    grads = [n + "@GRAD" for n in params]
    sc, sh = pt.Scope(), scope_from_numpy(
        pt.Scope(), {n: s0.get(n) for n in pers}, cpu)
    worst = {"loss": 0.0, "grad": 0.0, "param": 0.0}
    for step in range(3):
        scope_from_numpy(sc, {n: sh.get(n) for n in pers}, cuda)
        got = exe_c.run(main, feed=feed, fetch_list=[loss] + grads, scope=sc)
        want = exe_h.run(main, feed=feed, fetch_list=[loss] + grads,
                         scope=sh)
        worst["loss"] = max(worst["loss"], float(
            abs(got[0][0] - want[0][0]) / abs(want[0][0])))
        for n, a, b in zip(params, got[1:], want[1:]):
            worst["grad"] = max(worst["grad"], float(
                np.abs(a - b).max() / np.abs(b).max()))
            w = sh.get(n)
            err = np.abs(sc.get(n) - w) - fluid_adam_slack(2e-3, a, b)
            worst["param"] = max(worst["param"], float(
                err.max() / max(1.0, np.abs(w).max())))
    for key, lim in FLUID_TOL.items():
        check(worst[key] <= lim, f"fluid (b): the card's {key} differs "
              f"from the CPU's by {worst[key]} (limit {lim})")
    return worst


def _fluid_book(pt):
    """Phase 20 (c): the book LeNet and fit_a_line train on the card."""
    from paddle_tpu_torch.models import lenet

    exe = pt.Executor(pt.CUDAPlace(0))
    with pt.framework.unique_name.guard():
        main, startup, _, loss, acc = lenet.build_program(pt, lr=0.01)
    scope = pt.Scope()
    exe.run(startup, scope=scope)
    img, label = synthetic_mnist(30 * 64)
    out = [exe.run(main, feed={"img": img[i:i + 64],
                               "label": label[i:i + 64]},
                   fetch_list=[loss, acc], scope=scope)
           for i in range(0, 30 * 64, 64)]
    losses = [float(l[0]) for l, _ in out]
    accs = [float(a[0]) for _, a in out]
    check(losses[-1] < losses[0] and np.mean(accs[-5:]) > np.mean(accs[:5]),
          f"fluid (c): the book LeNet did not train: loss {losses[0]} -> "
          f"{losses[-1]}, accuracy {accs[:5]} -> {accs[-5:]}")

    main, startup = pt.Program(), pt.Program()
    with pt.framework.unique_name.guard(), pt.program_guard(main, startup):
        x = pt.layers.data(name="x", shape=[13], dtype="float32")
        y = pt.layers.data(name="y", shape=[1], dtype="float32")
        pred = pt.layers.fc(input=x, size=1)
        line_loss = pt.layers.mean(pt.layers.square_error_cost(
            input=pred, label=y))
        pt.optimizer.SGD(learning_rate=0.01).minimize(line_loss)
    scope = pt.Scope()
    exe.run(startup, scope=scope)
    xs, ys = synthetic_housing()
    line = [float(exe.run(main, feed={"x": xs[i:i + 32], "y": ys[i:i + 32]},
                          fetch_list=[line_loss], scope=scope)[0][0])
            for _ in range(4) for i in range(0, 384, 32)]
    check(line[-1] < line[0], f"fluid (c): fit_a_line did not converge: "
          f"{line[0]} -> {line[-1]}")
    return {"book_lenet_loss": [losses[0], losses[-1]],
            "book_lenet_accuracy_first5_last5": [float(np.mean(accs[:5])),
                                                 float(np.mean(accs[-5:]))],
            "fit_a_line_loss": [line[0], line[-1]], "fit_a_line_steps":
            len(line)}


def phase_fluid():
    import paddle_tpu_torch as pt

    t0 = time.perf_counter()
    rng = np.random.RandomState(0)
    feed = {"x": rng.rand(FLUID_B, 1, 28, 28).astype("float32"),
            "y": rng.randint(0, 10, (FLUID_B, 1)).astype("int64")}
    rung = _fluid_rung(pt, feed)
    parity = _fluid_parity(pt, feed)
    book = _fluid_book(pt)
    print(json.dumps({
        "phase": "fluid", "card": card(),
        "program": "bench.py _build_lenet_program, batch 256, Adam 2e-3",
        **rung, "card_vs_cpu_worst": parity, "card_vs_cpu_limits": FLUID_TOL,
        **book, "seconds": time.perf_counter() - t0}))


# Phase 21: KV reuse on the serving path. (a) holds every reuse engine's
# f32 streams equal to a bucketed engine's (TF32 off); (b) serves
# GPT-2-small at bf16 with a 2-layer draft through the HTTP Server.
KV_EXACT_NEW = 16
KV_WAVE_NEW = 32
KV_SHARED = 512           # the waves' shared prefix: 32 full blocks of 16
KV_SUFFIXES = (8, 35, 62, 90, 117, 145, 172, 200)


def _kv_exact_prompts(vocab):
    """A shared 40-token prefix with suffixes of 5, 2 and 30 tokens, then
    3, 300 and 1019 tokens: the last leaves 5 tokens under max_len 1024,
    so a spec round near max_len - 1 demotes to the plain path."""
    rs = np.random.RandomState(7)
    shared = rs.randint(0, vocab, size=40).tolist()
    return ([shared + rs.randint(0, vocab, size=n).tolist()
             for n in (5, 2, 30)] +
            [rs.randint(0, vocab, size=n).tolist() for n in (3, 300, 1019)])


def _kv_streams(engine, prompts, max_new):
    handles = [engine.submit(p, max_new_tokens=max_new) for p in prompts]
    return [[int(t) for t in h.result(timeout_s=600)] for h in handles]


def _first_divergence(got, want):
    """Per stream: None when equal, else the first position that
    differs."""
    out = []
    for g, w in zip(got, want):
        if g == w:
            out.append(None)
        else:
            out.append(next((i for i, (a, b) in enumerate(zip(g, w))
                             if a != b), min(len(g), len(w))))
    return out


def _kv_eager_after_warmup(label, status):
    runs = status["phase_runs"]
    check(all(v["eager"] == 0 for v in runs.values()),
          f"kv_reuse {label}: a phase ran eagerly after warmup(): {runs}")
    return {k: v["replayed"] for k, v in runs.items()}


def _kv_exact():
    """(a) f32, TF32 off: GPT-2-small's widths at 2 layers, blocks of 16,
    256 blocks, slots (4,). Each reuse engine's streams against the
    bucketed engine's; the self-draft accepts every proposal; the warm
    wave hits the prefix cache; every refcount drains; a forced share
    copies on write."""
    import torch

    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.serving import DecodeConfig, DecodeEngine

    cfg = gpt.GPTConfig(layers=2, dtype="float32")
    params, _ = gpt.init(torch.Generator(device="cuda").manual_seed(1), cfg,
                         device="cuda")
    dcfg = gpt.GPTConfig(layers=1, dtype="float32")
    dparams, _ = gpt.init(torch.Generator(device="cuda").manual_seed(2),
                          dcfg, device="cuda")
    base = dict(block_size=16, num_blocks=256, decode_slots=(4,),
                precision="f32")

    def engine(draft=None, **kw):
        eng = DecodeEngine(params, cfg, DecodeConfig(**base, **kw), draft,
                           device="cuda")
        eng.warmup()
        return eng

    prompts = _kv_exact_prompts(cfg.vocab_size)
    eng = engine()
    try:
        want = _kv_streams(eng, prompts, KV_EXACT_NEW)
    finally:
        eng.stop()
    rows = {}
    for label, kw, draft in (
            ("chunk", dict(prefill_chunk=64), None),
            ("prefix", dict(prefill_chunk=64, prefix_cache=True), None),
            ("self_draft", dict(prefill_chunk=64, prefix_cache=True,
                                spec_k=2), (params, cfg)),
            ("real_draft", dict(prefill_chunk=64, spec_k=3),
             (dparams, dcfg)),
            ("spec_only", dict(spec_k=2), (dparams, dcfg))):
        eng = engine(draft, **kw)
        try:
            waves = [_kv_streams(eng, prompts, KV_EXACT_NEW)]
            if label == "prefix":
                hits_cold = eng.status()["kv"]["prefix_hits_total"]
                waves.append(_kv_streams(eng, prompts, KV_EXACT_NEW))
            st = eng.status()
        finally:
            eng.stop()
        for i, got in enumerate(waves):
            check(got == want, f"kv_reuse {label} wave {i}: streams differ "
                  f"from the bucketed engine's at "
                  f"{_first_divergence(got, want)}")
        check(st["kv"]["blocks_used"] == 0,
              f"kv_reuse {label}: blocks_used {st['kv']['blocks_used']}")
        row = {"replayed": _kv_eager_after_warmup(label, st)}
        if draft is not None:
            row["accept_rate"] = st["kv_reuse"]["spec_accept_rate"]
        if label == "self_draft":
            check(row["accept_rate"] == 1.0,
                  f"kv_reuse self-draft accept rate {row['accept_rate']}")
            # the 1019-token prompt's last round ran the plain path
            check(row["replayed"]["decode"] > 0,
                  f"kv_reuse self-draft: no demoted round: {row}")
        if label == "prefix":
            row["hits_cold"] = hits_cold
            row["hits_warm"] = st["kv"]["prefix_hits_total"] - hits_cold
            check(row["hits_warm"] > 0, f"kv_reuse prefix: {row}")
        rows[label] = row
    rows["cow"] = _kv_forced_cow(engine(prefill_chunk=64, prefix_cache=True),
                                 prompts[1], want[1])
    return rows


def _kv_forced_cow(eng, prompt, want):
    """A forced share of the block the first decode write lands in: the
    write copies the block first (in place, in the pools the graphs
    hold), the stream is unchanged, and the original block's rows are
    bit for bit what they were."""
    state = {}
    pump = eng._pump_chunk

    def pump_then_share():
        pump()
        for r in eng._active:
            if not state and r.pos == len(r.prompt):
                blk = r.blocks[r.pos // eng.kv_cfg.block_size]
                eng._alloc.incref(blk)
                kp, vp = eng._pools
                state.update(blk=blk, k=kp[:, blk].clone(),
                             v=vp[:, blk].clone(), ptr=kp.data_ptr())

    eng._pump_chunk = pump_then_share
    try:
        got = _kv_streams(eng, [prompt], KV_EXACT_NEW)[0]
        kp, vp = eng._pools
        blk = state["blk"]
        intact = bool((kp[:, blk] == state["k"]).all() and
                      (vp[:, blk] == state["v"]).all())
        row = {"cow_total": eng._alloc.cow_total, "block_intact": intact,
               "pools_in_place": kp.data_ptr() == state["ptr"],
               "stream_equal": got == want}
        eng._alloc.free([blk])
        check(all(row.values()) and row["cow_total"] >= 1,
              f"kv_reuse forced COW: {row}")
        return row
    finally:
        eng.stop()


def _kv_wave_prompts(vocab):
    """8 prompts: one 512-token prefix with distinct suffixes."""
    rs = np.random.RandomState(21)
    shared = rs.randint(0, vocab, size=KV_SHARED)
    return [np.concatenate([shared, rs.randint(0, vocab, size=n)])
            for n in KV_SUFFIXES]


def _spec_round_times(engine, reps=20):
    """One speculation round's device work (k draft steps and the
    verification, every one a graph replay) at each slot count of a
    warmed, idle engine, on all-zero inputs: the host's time to issue
    it, the time between CUDA events around it, and the wall time to
    its tokens on the host."""
    import torch

    out = {}
    mb = engine.kv_cfg.max_blocks_per_seq
    with torch.inference_mode():
        for S in engine.decode_slots:
            zeros = (np.zeros((S,), np.int32), np.zeros((S,), np.int32),
                     np.zeros((S, mb), np.int32))
            for _ in range(3):
                engine._spec_launch(S, *zeros).cpu()
            host, event, wall = [], [], []
            for _ in range(reps):
                torch.cuda.synchronize()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                t0 = time.perf_counter()
                both = engine._spec_launch(S, *zeros)
                host.append((time.perf_counter() - t0) * 1e3)
                end.record()
                both.cpu()
                wall.append((time.perf_counter() - t0) * 1e3)
                event.append(start.elapsed_time(end))
            out[f"S{S}"] = {"host_ms": statistics.median(host),
                            "event_ms": statistics.median(event),
                            "wall_ms": statistics.median(wall)}
    return out


def _phase_replay_times(engine, reps=20):
    """Each captured phase of a warmed, idle engine replayed alone on
    all-zero inputs (every write lands in the null block): the host's
    time to issue the replay and the time between CUDA events around
    it, which is the phase's device time."""
    import torch

    out = {}
    with torch.inference_mode():
        for (kind, n), g in sorted(engine._graphs.items()):
            for t in g.inputs:
                t.zero_()
            for _ in range(3):
                g.graph.replay()
            host, event = [], []
            for _ in range(reps):
                torch.cuda.synchronize()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                t0 = time.perf_counter()
                g.graph.replay()
                host.append((time.perf_counter() - t0) * 1e3)
                end.record()
                end.synchronize()
                event.append(start.elapsed_time(end))
            out[f"{kind}@{n}"] = {"host_ms": statistics.median(host),
                                  "event_ms": statistics.median(event)}
    return out


def _kv_full(label, engine, prompts, want):
    """(b) one configuration behind the HTTP Server: a cold and a warm
    wave of the 8 prompts, then one round under torch.profiler; each
    request done with its tokens, the warm wave's prefix hits, the
    refcounts drained, every captured phase a replay after warmup."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.serving import Server, ServingConfig

    server = Server(ServingConfig(), decode=engine)
    t0 = time.perf_counter()
    port = server.start(0)                      # warms, then binds
    row = {"start_s": time.perf_counter() - t0, "waves": {}}
    try:
        check(engine.status()["warmed"], f"kv_reuse {label}: not warmed")
        fa.flash_attention.launches = 0
        for wave in ("cold", "warm"):
            kv0 = engine.status()["kv"]
            results, wall = _http_round(port, prompts, KV_WAVE_NEW)
            st = engine.status()
            for n, out in zip(KV_SUFFIXES, results):
                check("error" not in out and
                      len(out["tokens"]) == KV_WAVE_NEW and out["done"] and
                      out["done"].get("finish_reason") == "length",
                      f"kv_reuse {label} {wave} suffix {n}: {out}")
            got = [out["tokens"] for out in results]
            div = _first_divergence(got, want)
            row["waves"][wave] = {
                **_round_summary(results, wall),
                **{k: st["kv"].get(k, 0) - kv0.get(k, 0)
                   for k in ("prefix_hits_total", "blocks_reused_total")},
                "accept_rate": st["kv_reuse"]["spec_accept_rate"],
                "equal_to_bucketed": sum(d is None for d in div) / len(div),
                "first_divergence": div}
        row["flash_attention_fwd"] = fa.flash_attention.launches
        row["replayed"] = _kv_eager_after_warmup(label, st)
        row["spec_round"] = _spec_round_times(engine)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            _kv_streams(engine, prompts, KV_WAVE_NEW)
            wall = time.perf_counter() - t0
        row["profiled"] = {"wall_s": wall, **{
            k: v for k, v in _device_time(prof, wall).items()
            if k in ("device_events", "device_busy_ms", "device_idle_share",
                     "top_kernels")}}
        st = engine.status()
        row["phase_replay"] = _phase_replay_times(engine)
    finally:
        server.stop()
    check(st["kv"]["blocks_used"] == 0,
          f"kv_reuse {label}: blocks_used {st['kv']['blocks_used']}")
    row["kv"] = {k: st["kv"].get(k) for k in (
        "blocks_cached", "prefix_hits_total", "blocks_reused_total",
        "evictions_total", "cow_total")}
    row["spec"] = st["kv_reuse"]
    return row


def phase_kv_reuse():
    """KV reuse on the serving path: (a) f32 exactness, (b) GPT-2-small
    at bf16 through the HTTP Server with a prefix-sharing load, reuse
    (chunk 256, prefix cache, spec_k 3) and spec-only (bucketed
    prefills on K1-fwd, spec_k 3). Returns the spec-only engine's
    K1-fwd launches, read around its two waves."""
    import torch

    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.serving import DecodeConfig, DecodeEngine

    t0 = time.perf_counter()
    exact = _kv_exact()
    cfg = gpt.GPTConfig()                       # GPT-2-small, bf16
    params, _ = gpt.init(torch.Generator(device="cuda").manual_seed(0), cfg,
                         device="cuda")
    dcfg = gpt.GPTConfig(layers=2)
    dparams, _ = gpt.init(torch.Generator(device="cuda").manual_seed(2),
                          dcfg, device="cuda")
    base = dict(block_size=16, num_blocks=512, decode_slots=(4, 8))
    prompts = _kv_wave_prompts(cfg.vocab_size)
    eng = DecodeEngine(params, cfg, DecodeConfig(**base), device="cuda")
    eng.warmup()
    try:
        want = _kv_streams(eng, prompts, KV_WAVE_NEW)
    finally:
        eng.stop()
    full = {}
    for label, kw in (("reuse", dict(prefill_chunk=256, prefix_cache=True,
                                     spec_k=3)),
                      ("spec_only", dict(spec_k=3))):
        eng = DecodeEngine(params, cfg, DecodeConfig(**base, **kw),
                           (dparams, dcfg), device="cuda")
        full[label] = _kv_full(label, eng, prompts, want)
        del eng
        torch.cuda.empty_cache()
    check(full["reuse"]["waves"]["warm"]["prefix_hits_total"] > 0,
          f"kv_reuse: no prefix hit in the warm wave: {full['reuse']}")
    launches = full["spec_only"]["flash_attention_fwd"]
    check(launches >= cfg.layers * len(prompts) * 2,
          f"kv_reuse spec-only: {launches} K1-fwd launches")
    print(json.dumps({
        "phase": "kv_reuse", "card": card(),
        "exact": {"model": "GPTConfig(layers=2), f32, TF32 off",
                  "draft": "GPTConfig(layers=1) seed 2", **exact},
        "model": "GPT-2-small (GPTConfig()), bf16, 512 blocks of 16, "
                 "slots (4, 8); draft GPTConfig(layers=2) seed 2",
        "prompts": {"shared": KV_SHARED, "suffixes": list(KV_SUFFIXES),
                    "new_tokens": KV_WAVE_NEW},
        **full, "seconds": time.perf_counter() - t0}))
    return launches


# phase 22: GPT-MoE under MeshConfig(pp=2, ep=2) on the in-process rings
MOE_MESH = {"pp": 2, "ep": 2}
MOE_EXPERTS = 8
MOE_MICRO = 4


def _moe_mesh(dev, dp=1):
    """MeshConfig(pp=2, ep=2, dp=dp): a pp ring and an ep ring of two
    virtual ranks each (and a dp ring), 4 * dp in all, on `dev` (what
    one card can show of them)."""
    import torch

    from paddle_tpu_torch.parallel.mesh import MeshConfig, make_mesh

    return make_mesh(MeshConfig(dp=dp, **MOE_MESH),
                     devices=[torch.device(dev)] * (4 * dp))


class _RoutingTap:
    """While active, wraps `models/gpt.py::_moe_mlp` to record each
    call's layer (by the address of its slice of `router`, the stacked
    "blk.router" the model runs on), each token's expert, the smallest
    top-2 gap of the router probabilities and the tokens dropped at
    capacity, from the router product as `_moe_mlp` computes it (the
    same ops on the same inputs). Each call syncs the device: keep it
    out of timed steps."""

    def __init__(self, router):
        self.layer = {router[l].data_ptr(): l
                      for l in range(router.shape[0])}
        self.calls = []

    def __enter__(self):
        import torch

        from paddle_tpu_torch.models import gpt

        self._orig = orig = gpt._moe_mlp

        def moe(lp, x, cfg):
            with torch.no_grad():
                G, E = x.shape[0] * x.shape[1], cfg.n_experts
                probs = torch.softmax((x.reshape(G, -1) @ lp[
                    "blk.router"].to(x.dtype)).float(), -1)
                top2 = probs.topk(2, -1).values
                idx = probs.argmax(-1)
                C = max(1, int(cfg.capacity_factor * G / E))
                dropped = (torch.bincount(idx, minlength=E) - C).clamp(
                    min=0).sum()
                self.calls.append({
                    "layer": self.layer[lp["blk.router"].data_ptr()],
                    "idx": idx.cpu(), "tokens": G, "capacity": C,
                    "gap": (top2[:, 0] - top2[:, 1]).min().item(),
                    "dropped": int(dropped)})
            return orig(lp, x, cfg)

        gpt._moe_mlp = moe
        return self

    def __exit__(self, *exc):
        from paddle_tpu_torch.models import gpt

        gpt._moe_mlp = self._orig


def _dropped_share(calls, layers):
    """The share of each layer's tokens dropped at capacity, from
    `_RoutingTap.calls`."""
    return [sum(c["dropped"] for c in calls if c["layer"] == l) /
            sum(c["tokens"] for c in calls if c["layer"] == l)
            for l in range(layers)]


def _moe_routes(params, cfg, batch, dev, n_micro, dp=1):
    """The routing of one forward of `gpt.lm_loss` on `dev` under the
    MoE mesh (`_RoutingTap.calls`, in call order)."""
    import torch

    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.parallel.mesh import mesh_guard

    p = {k: v.to(dev) for k, v in params.items()}
    with torch.no_grad(), mesh_guard(_moe_mesh(dev, dp)), \
            _RoutingTap(p["blk.router"]) as tap:
        gpt.lm_loss(p, cfg, {k: v.to(dev) for k, v in batch.items()},
                    n_microbatches=n_micro)
    return tap.calls


def _moe_parity(dp=1):
    """Phase 22 (a): a 2-layer GPT at GPT-2-small's widths with 8
    experts, f32 (TF32 off), 4 x 128 tokens, 2 microbatches under
    MeshConfig(pp=2, ep=2, dp=dp): the card (K1's f32 kernels) against
    the CPU (plain versions) from the same params and batch, the routing
    first (every token's expert in every layer and microbatch equal),
    then the loss, every gradient and one AdamW step at
    `_hold_train_step`'s limits (phase 16's); then, with dp 1, the
    card's pp+ep step against the mean of the microbatches' losses run
    one by one with no mesh on the card (under dp a stage's capacity is
    a dp shard's, which the loop does not split)."""
    import torch

    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.parallel.mesh import mesh_guard

    cfg = gpt.GPTConfig(layers=2, n_experts=MOE_EXPERTS, dtype="float32")
    params, _ = gpt.init(torch.Generator().manual_seed(22), cfg,
                         device="cpu")
    B, T, n_micro = 4, 128, 2
    batch = {"ids": torch.from_numpy(np.random.RandomState(22).randint(
        0, cfg.vocab_size, (B, T + 1)))}
    routes = {dev: _moe_routes(params, cfg, batch, dev, n_micro, dp)
              for dev in ("cuda", "cpu")}
    flips = sum(int((a["idx"] != b["idx"]).sum())
                for a, b in zip(routes["cuda"], routes["cpu"]))
    gap = min(c["gap"] for c in routes["cpu"])
    check(len(routes["cuda"]) == len(routes["cpu"]) ==
          cfg.layers * n_micro * dp and [c["layer"] for c in routes["cuda"]] ==
          [c["layer"] for c in routes["cpu"]] and flips == 0,
          f"gpt-moe parity: {flips} tokens routed otherwise on the card "
          f"(smallest top-2 gap {gap})")

    def loss_fn(p, b, g):
        return gpt.lm_loss(p, cfg, b, rng=g, n_microbatches=n_micro)

    def loop_fn(p, b, g):
        m = B // n_micro
        return sum(gpt.lm_loss(p, cfg, {"ids": b["ids"][i * m:(i + 1) * m]})
                   for i in range(n_micro)) / n_micro

    runs = {}
    for dev in ("cuda", "cpu"):
        with mesh_guard(_moe_mesh(dev, dp)):
            runs[dev] = _one_train_step(loss_fn, params, batch, dev)
    kc = runs["cuda"]["counts"]
    # f32: K1's FMA dq takes delta from the standalone launch
    calls = cfg.layers * n_micro * dp
    want = {**dict.fromkeys(K1_TRAIN, calls), DELTA: calls}
    check(all(n == want.get(name, 0) for name, n in kc.items()),
          f"gpt-moe parity: the CUDA step ran {kc} launches")
    out = {
        "model": f"GPTConfig(layers=2, n_experts={MOE_EXPERTS}), f32, "
                 f"{B} x {T}, n_microbatches={n_micro}",
        "mesh": {**MOE_MESH, "dp": dp}, "routed_tokens": B * T * cfg.layers,
        "routing_flips": flips, "smallest_top2_gap": gap,
        "capacity": routes["cpu"][0]["capacity"],
        "dropped_share_cpu": _dropped_share(routes["cpu"], cfg.layers),
        "launches": kc,
        "card_vs_cpu": _hold_train_step("gpt-moe card vs CPU", runs["cuda"],
                                        runs["cpu"], params)}
    if dp == 1:
        runs["loop"] = _one_train_step(loop_fn, params, batch, "cuda")
        out["pp_ep_vs_microbatch_loop"] = _hold_train_step(
            "gpt-moe pp+ep vs loop", runs["cuda"], runs["loop"], params)
    return out


def _moe_einsum_ms(step, state, batch, ec):
    """One step under torch.profiler (CPU and CUDA, input shapes): the
    device ms and count of the matmuls with a dimension of E x C, which
    only the dispatch and combine einsums have (forward and backward),
    and the step's device ms in all."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        step(state, batch, 10 ** 6)[1].item()
        torch.cuda.synchronize()
    ms, n, total = 0.0, 0, 0.0
    for e in prof.key_averages(group_by_input_shape=True):
        if e.key in ("aten::mm", "aten::bmm") and \
                any(ec in (s or []) for s in e.input_shapes):
            ms += e.device_time_total / 1e3
            n += e.count
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            total += (e.time_range.end - e.time_range.start) / 1e3
    return {"dispatch_combine_device_ms": ms if n else None,
            "dispatch_combine_matmuls": n,
            "profiled_kernels_device_ms": total}


def _moe_train(cfg, params, batch, n_micro, dp=1, warmup=2, steps=10,
               details=True):
    """Phase 22 (b): `_train_run` of `cfg` under the MoE mesh (with
    `dp`) with `n_micro` microbatches (with no mesh when 0); after the
    timed steps, with `details`, the dispatch and combine einsums'
    device ms in one profiled step and the share of each layer's tokens
    dropped at capacity in one forward of the trained params."""
    import contextlib

    import torch

    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.parallel.mesh import mesh_guard

    B, T = batch["ids"].shape[0], batch["ids"].shape[1] - 1
    G = B * T // max(n_micro, 1) // dp
    C = max(1, int(cfg.capacity_factor * G / cfg.n_experts))

    def guard():
        return mesh_guard(_moe_mesh("cuda", dp)) if n_micro else \
            contextlib.nullcontext()

    def loss_fn(p, b, g):
        return gpt.lm_loss(p, cfg, b, rng=g, n_microbatches=n_micro)

    def after(step, state, batch):
        out = _moe_einsum_ms(step, state, batch, cfg.n_experts * C)
        with torch.no_grad(), _RoutingTap(state.params["blk.router"]) as tap:
            gpt.lm_loss(state.params, cfg, batch, n_microbatches=n_micro)
        out.update(capacity=C, tokens_per_call=G,
                   dropped_share_by_layer=_dropped_share(tap.calls,
                                                         cfg.layers))
        return out

    label = (f"gpt-moe {B}x{T} pp=2 ep=2" + (f" dp={dp}" if dp > 1 else "")
             + f" n_micro={n_micro}" if n_micro else f"gpt-moe {B}x{T} no mesh")
    with guard():
        return _train_run(label, loss_fn, params, batch,
                          cfg.train_flops_per_token(T) * T, warmup, steps,
                          k1_per_step(cfg.layers * max(n_micro, 1) * dp),
                          after=after if details else None)


def phase_gpt_moe():
    """Phase 22: GPT mixture-of-experts through the GPipe pipeline on
    the pp and ep axes of the in-process mesh. (a) `_moe_parity`; (b)
    the full configuration: GPT-2-small's widths (`GPTConfig()`) with 8
    experts on every layer (Switch-Base-8's setting), capacity factor
    1.25, mixed_bf16, AdamW(1e-4, wd 1e-4), 8 x 1024 tokens, 4
    microbatches under MeshConfig(pp=2, ep=2): 2 warm-up and 10 timed
    steps (step ms, samples/s, MFU from `train_flops_per_token`, which
    leaves out the router and the dispatch and combine einsums; a
    finite, falling loss; K1 48 times a step; peak memory; a traced
    step's idle share and largest kernels; the dispatch and combine
    einsums' device ms; the share of tokens dropped at capacity by
    layer), then the same model with no mesh and n_microbatches=0."""
    import torch

    from paddle_tpu_torch.models import gpt

    t0 = time.perf_counter()
    parity = _moe_parity()
    cfg = gpt.GPTConfig(n_experts=MOE_EXPERTS)
    rows, launches = [], collections.Counter()
    for n_micro in (MOE_MICRO, 0):
        params, _ = gpt.init(torch.Generator(device="cuda").manual_seed(5),
                             cfg, device="cuda")
        batch = gpt.make_batch(torch.Generator(device="cuda").manual_seed(6),
                               cfg, 8)
        if not rows:
            n_params = sum(v.numel() for v in params.values())
        rows.append(_moe_train(cfg, params, batch, n_micro))
        launches.update(rows[-1]["launches"])
        del params, batch
        torch.cuda.empty_cache()
    print(json.dumps({
        "phase": "gpt-moe", "card": card(), "parity": parity,
        "model": f"GPTConfig(n_experts={MOE_EXPERTS}) (GPT-2-small widths, "
                 f"Switch-Base-8's experts), capacity_factor "
                 f"{cfg.capacity_factor}, mixed_bf16",
        "params": n_params, "optimizer": "AdamW lr 1e-4 wd 1e-4",
        "mesh": "in-process MeshConfig(pp=2, ep=2) on one card",
        "mfu_formula": "GPTConfig.train_flops_per_token: router, dispatch "
                       "and combine einsums left out",
        "pipeline_ms_over_no_mesh": rows[0]["step_ms_median"] /
        rows[1]["step_ms_median"],
        "runs": rows, "seconds": time.perf_counter() - t0}))
    return launches


# Phase 25: data and tensor parallelism on in-process rings (the JAX
# package's graft paths 1-4). Each mesh runs its virtual ranks on the
# one card, so no byte moves between ranks: the phase proves the split
# computations against no mesh and times them, and claims nothing about
# communication or scaling.
DPTP_BERT = ((dict(dp=2), 256, 128), (dict(dp=2, tp=2), 256, 128),
             (dict(dp=2, tp=2, sp=2), 128, 256))
# ResNet-50 at f32: the dp=4 step-0 loss against no mesh within
# `__graft_entry__.py`'s 1e-3 relative; each BN running statistic the
# step writes within rtol |want| + atol max|want| of its tensor. f32
# sums over a channel's 0.8-3.2M elements, grouped by rank, move every
# later layer's input by f32 noise: 1.18e-5 relative plus 1.2e-6 of the
# tensor's largest value at the worst element (g3.b2.bn2.mean) in the
# first run on an H100; the limit is ten times that. The phase also
# reads unsynced statistics (rank 0's, from its quarter of the batch)
# at this limit, and fails unless they miss it.
DPTP_RESNET_TOL = {"loss": 1e-3, "bn": (1e-4, 1e-5)}


def _mesh(dev="cuda", **axes):
    import torch

    from paddle_tpu_torch.parallel.mesh import MeshConfig, make_mesh

    n = math.prod(axes.values())
    return make_mesh(MeshConfig(**{"dp": 1, **axes}),
                     devices=[torch.device(dev)] * n)


def _loss_grads(loss_fn, params, batch, mesh=None, rules=None):
    """The loss and every gradient at `params` on the card, under
    `mesh` (and `rules`) when given."""
    import contextlib

    import torch

    from paddle_tpu_torch.parallel.mesh import mesh_guard
    from paddle_tpu_torch.parallel.sharding import with_rules

    p = {k: v.detach().requires_grad_() for k, v in params.items()}
    with mesh_guard(mesh) if mesh is not None else contextlib.nullcontext(), \
            with_rules(rules) if rules is not None \
            else contextlib.nullcontext():
        loss = loss_fn(p, batch, None)
        if isinstance(loss, tuple):
            loss = loss[0]
        grads = torch.autograd.grad(loss, list(p.values()),
                                    allow_unused=True)
    return {"loss": loss.item(),
            "grads": {k: torch.zeros_like(v) if g is None else g
                      for (k, v), g in zip(p.items(), grads)}}


def _dptp_bert():
    """(a) BERT-base, graft path 1. f32 (TF32 off), dropout off: at
    256 x 128 under dp=2 and dp=2 tp=2, and at 128 x 256 under dp=2 tp=2
    sp=2 (T / sp a multiple of 128, so the ring takes K3 blocks; eight
    virtual ranks), the loss and every gradient against the same params
    and batch with no mesh, at phase 6's f32 limits; `mha` counted on
    "splash_shardmap" (dp/tp) or "ring_splash" (sp). Then each mesh's
    timed steps under mixed_bf16 (AdamW), K1 once per (dp, tp) rank and
    layer, K3 once per block. A padded call under tp=2 runs K2 once per
    tp rank on its heads: held against the no-mesh K2 call."""
    import torch

    from paddle_tpu_torch.models import bert
    from paddle_tpu_torch.ops import attention as attn
    from paddle_tpu_torch.parallel.mesh import mesh_guard

    out = {"parity": [], "runs": []}
    refs = {}
    cfg32 = bert.BertConfig(dtype="float32", dropout=0.0)
    params, axes = bert.init(torch.Generator(device="cuda").manual_seed(25),
                             cfg32, device="cuda")

    def loss32(p, b, g):
        return bert.pretrain_loss(p, cfg32, b, rng=g, deterministic=True)

    for mesh_axes, B, T in DPTP_BERT:
        batch = bert.make_batch(torch.Generator(device="cuda").manual_seed(
            T), cfg32, B, seq_len=T)
        if (B, T) not in refs:
            refs[(B, T)] = _loss_grads(loss32, params, batch)
        attn.GATE_COUNTS.clear()
        got = _loss_grads(loss32, params, batch, _mesh(**mesh_axes))
        gates = dict(attn.GATE_COUNTS)
        route = "ring_splash" if "sp" in mesh_axes else "splash_shardmap"
        check(gates == {route: cfg32.layers},
              f"dp-tp bert {mesh_axes}: mha routes {gates}")
        out["parity"].append({
            "mesh": mesh_axes, "batch": [B, T], "gates": gates,
            **_hold_loss_grads(f"dp-tp bert {mesh_axes}", got,
                               refs[(B, T)])})
        del got
    del refs, params
    torch.cuda.empty_cache()
    cfg = bert.BertConfig.base()
    cfg.dropout = 0.0

    def loss_fn(p, b, g):
        return bert.pretrain_loss(p, cfg, b, rng=g, deterministic=True)

    for mesh_axes, B, T in DPTP_BERT:
        params, axes = bert.init(torch.Generator(device="cuda").manual_seed(
            0), cfg, device="cuda")
        batch = bert.make_batch(torch.Generator(device="cuda").manual_seed(
            1), cfg, B, seq_len=T)
        ranks = mesh_axes.get("dp", 1) * mesh_axes.get("tp", 1)
        sp = mesh_axes.get("sp", 1)
        per_step = {"splash_block_with_lse": cfg.layers * ranks * sp * sp} \
            if sp > 1 else k1_per_step(cfg.layers * ranks)
        attn.GATE_COUNTS.clear()
        row = _train_run(f"bert-base {B}x{T} {mesh_axes}", loss_fn, params,
                         batch, cfg.train_flops_per_seq(
                             T, batch["masked_positions"].shape[1]),
                         2, 6, per_step, mesh=_mesh(**mesh_axes),
                         param_axes=axes)
        row["gates"] = dict(attn.GATE_COUNTS)
        check(row["gates"].get("ring_splash" if sp > 1
                               else "splash_shardmap", 0) > 0,
              f"dp-tp bert {mesh_axes}: mha routes {row['gates']}")
        out["runs"].append(row)
        del params, batch
        torch.cuda.empty_cache()
    # K2 per tp rank: a padded BERT-base attention call under tp=2
    gen = torch.Generator(device="cuda").manual_seed(26)
    q, k, v = (torch.randn(32, 512, 12, 64, generator=gen, device="cuda")
               .bfloat16() for _ in range(3))
    lens = torch.randint(256, 513, (32,), generator=gen, device="cuda")
    mask = torch.where(torch.arange(512, device="cuda")[None] < lens[:, None],
                       0.0, -3e4)[:, None, None, :]
    want = attn.mha(q, k, v, mask=mask)
    with mesh_guard(_mesh(tp=2)):
        got = attn.mha(q, k, v, mask=mask)
    out["k2_per_tp_rank"] = held(got, want, "bfloat16")
    check(out["k2_per_tp_rank"]["ratio"] <= 1.0,
          f"dp-tp K2 per tp rank: {out['k2_per_tp_rank']}")
    return out


def _dptp_resnet():
    """(b) ResNet-50, graft path 4 (BASELINE's config 5): 256 x 224^2,
    NHWC, f32 activations (TF32 off), unfused on both sides, one
    SGD(0.1, momentum 0.9) step at dp=4 (sync BN: each rank's sums
    all-reduced) against no mesh: the step-0 loss within 1e-3 relative
    (`__graft_entry__.py`'s bound), the BN running means and variances
    it writes within `DPTP_RESNET_TOL`'s 1e-4 relative plus 1e-5 of
    each tensor's largest value (f32 sums over 3.2M elements a channel,
    taken in another order and grouped by rank). Unsynced BN (rank 0's
    statistics: the no-mesh forward on the batch's first quarter) must
    miss that limit, so the gate tells the two apart. Then timed steps
    at dp=4 under bench.py's rung (bf16 activations, f32 params)."""
    import dataclasses

    import torch

    from paddle_tpu_torch.models import resnet
    from paddle_tpu_torch.parallel.train import make_train_step

    B, hw = 256, 224
    cfg32 = dataclasses.replace(resnet.ResNetConfig.resnet50(),
                                dtype="float32")
    stepped = {}
    for label, mesh in (("no mesh", None), ("dp=4", _mesh(dp=4))):
        params, axes = resnet.init(
            torch.Generator(device="cuda").manual_seed(0), cfg32,
            device="cuda")
        batch = resnet.make_batch(torch.Generator(device="cuda").manual_seed(
            1), cfg32, B, hw=hw, data_format="NHWC")
        init, step = make_train_step(
            lambda p, b, g: resnet.loss_fn(p, cfg32, b, g,
                                           data_format="NHWC"),
            _sgd, device="cuda", has_aux=True, mesh=mesh, param_axes=axes)
        state, loss = step(init(params), batch, 0)
        stepped[label] = (loss.item(), {
            k: v.detach().clone() for k, v in state.params.items()
            if k.endswith((".mean", ".var"))})
        if mesh is None:
            with torch.no_grad():
                _, aux = resnet.loss_fn(
                    params, cfg32, {k: v[:B // 4] for k, v in batch.items()},
                    None, data_format="NHWC")
            unsynced = {k: v.clone() for k, v in aux.items()
                        if k.endswith((".mean", ".var"))}
            del aux
        del params, batch, state, init, step
        torch.cuda.empty_cache()
    (l0, bn0), (l1, bn1) = stepped["no mesh"], stepped["dp=4"]
    rtol, atol = DPTP_RESNET_TOL["bn"]

    def worst(got):
        return max((((got[k] - bn0[k]).abs() /
                     (rtol * bn0[k].abs() + atol * bn0[k].abs().max()))
                    .max().item(), k) for k in bn0)

    parity = {"loss_no_mesh": l0, "loss_dp4": l1,
              "loss_rel": abs(l1 - l0) / abs(l0),
              "bn_err_over_tol_worst": worst(bn1),
              "bn_unsynced_over_tol_worst": worst(unsynced)}
    check(parity["loss_rel"] <= DPTP_RESNET_TOL["loss"]
          and parity["bn_err_over_tol_worst"][0] <= 1.0
          and parity["bn_unsynced_over_tol_worst"][0] > 1.0,
          f"dp-tp resnet sync BN: {parity}")
    print(json.dumps({"phase": "dp-tp", "part": "resnet-parity", **parity}))
    del stepped, bn0, bn1, unsynced
    torch.cuda.empty_cache()
    cfg = resnet.ResNetConfig.resnet50()
    params, axes = resnet.init(torch.Generator(device="cuda").manual_seed(0),
                               cfg, device="cuda")
    batch = resnet.make_batch(torch.Generator(device="cuda").manual_seed(1),
                              cfg, B, hw=hw, data_format="NHWC")
    row = _train_run(f"resnet-50 {B}x{hw}^2 dp=4", lambda p, b, g:
                     resnet.loss_fn(p, cfg, b, g, data_format="NHWC"),
                     params, batch, cfg.flops_per_image(hw), 2, 6, {},
                     optimizer=_sgd, precision="f32", has_aux=True,
                     mesh=_mesh(dp=4), param_axes=axes)
    del params, batch
    torch.cuda.empty_cache()
    return {"parity": parity, "run": row}


def _dptp_gpt():
    """(c) GPT-2-small dense, graft path 3: 8 x 1024 in 4 microbatches
    under pp=2 tp=2 dp=2 (each microbatch's 2 rows split over dp, each
    stage's denses split over tp): the pipelined loss (bf16 activations,
    f32 params) against `lm_loss` with no mesh, within the graft path's
    5e-2 + 1e-3 |ref|; then timed steps under mixed_bf16, K1 once per
    (pp, dp) stage call and layer (96 a step)."""
    import torch

    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.parallel.mesh import mesh_guard

    cfg = gpt.GPTConfig()
    n_micro, mesh_axes = 4, dict(pp=2, tp=2, dp=2)
    params, axes = gpt.init(torch.Generator(device="cuda").manual_seed(3),
                            cfg, device="cuda")
    batch = gpt.make_batch(torch.Generator(device="cuda").manual_seed(4),
                           cfg, 8)
    with torch.no_grad():
        ref = gpt.lm_loss(params, cfg, batch).item()
        with mesh_guard(_mesh(**mesh_axes)):
            got = gpt.lm_loss(params, cfg, batch,
                              n_microbatches=n_micro).item()
    check(abs(ref - got) < 5e-2 + 1e-3 * abs(ref),
          f"dp-tp gpt pp-tp-dp loss {got} vs no mesh {ref}")

    def loss_fn(p, b, g):
        return gpt.lm_loss(p, cfg, b, rng=g, n_microbatches=n_micro)

    row = _train_run(f"gpt-2-small 8x1024 {mesh_axes} n_micro={n_micro}",
                     loss_fn, params, batch,
                     gpt_train_flops_per_seq(cfg, 1024), 2, 6,
                     k1_per_step(cfg.layers * n_micro * mesh_axes["dp"]),
                     mesh=_mesh(**mesh_axes), param_axes=axes)
    del params, batch
    torch.cuda.empty_cache()
    return {"loss_pipelined": got, "loss_no_mesh": ref,
            "abs_diff": abs(ref - got), "run": row}


def _dptp_moe():
    """(d) GPT-MoE, graft path 2: phase 22's configurations at pp=2 ep=2
    dp=2: (a)'s 2-layer f32 gate, the card against the CPU (routing,
    loss, every gradient, one AdamW step); then the full model at
    8 x 1024 in 4 microbatches (a stage's capacity from a microbatch's
    dp shard: 1024 tokens), 1 warm-up and 4 timed steps (phase 22 (b)
    reports the einsums and the dropped tokens)."""
    import torch

    from paddle_tpu_torch.models import gpt

    parity = _moe_parity(dp=2)
    cfg = gpt.GPTConfig(n_experts=MOE_EXPERTS)
    params, _ = gpt.init(torch.Generator(device="cuda").manual_seed(5),
                         cfg, device="cuda")
    batch = gpt.make_batch(torch.Generator(device="cuda").manual_seed(6),
                           cfg, 8)
    row = _moe_train(cfg, params, batch, MOE_MICRO, dp=2, warmup=1, steps=4,
                     details=False)
    del params, batch
    torch.cuda.empty_cache()
    return {"parity": parity, "run": row}


# Transformer-big under dp and tp: phase_nmt_train's batch (128 pairs of
# 128 x 128 tokens, make_batch's ragged lengths); each mesh's f32 step
# (TF32 off) against no mesh at phase 9's f32 limits
# (`_hold_loss_grads`: loss 1e-5 relative, each gradient 2e-4 of its
# largest value plus 1e-7), then timed mixed_bf16 steps. The beam search
# (4 sources, beam 4, 16 steps) at f32 under dp=2 tp=2: the tokens of no
# mesh, the scores within 1e-5 relative.
DPTP_MESHES = (dict(dp=2), dict(tp=2), dict(dp=2, tp=2))
DPTP_BEAM = (4, 4, 16)
# ResNet-50's head under tp: 64 images of 224^2 at f32, the loss within
# DPTP_RESNET_TOL["loss"] of no mesh, the head's gradients within phase
# 14's f32 limit, 1e-5 of each tensor's largest value, against the run
# whose head is whole and whose BN sums are the same: no mesh for tp=2,
# dp=2 for dp=2 tp=2. Against no mesh, dp=2 tp=2's head gradients
# carry sync BN's f32 sums in another order through 50 layers (6.3e-5
# of the largest in the first run on an H100; reported, not gated).
DPTP_RESNET_TP_B = 64
DPTP_HEAD_GRAD_TOL = 1e-5
# VGG-16 (224^2, 1000 classes) and LeNet (MNIST) batches
DPTP_VGG_B = 32
DPTP_LENET_B = 256


def _dptp_transformer():
    """(e) Transformer-big at full width (6 + 6 layers, hidden 1024, 16
    heads, mlp 4096, vocab 32000) under dp=2, tp=2 and dp=2 tp=2 (see
    DPTP_MESHES): the f32 loss and every gradient against no mesh, `mha`
    counted on "splash_shardmap" (the decoder's causal self-attention:
    K1 once per (dp, tp) rank) and "flash_bias_cuda" (the padded
    encoder self- and cross-attention: K2 once per rank on its rows and
    heads), the beam search under dp=2 tp=2 against no mesh, then each
    mesh's timed steps under mixed_bf16 with Adam, K1 and K2 launched
    `nmt_per_step` times the mesh's dp x tp ranks a step."""
    import torch

    from paddle_tpu_torch.models import transformer
    from paddle_tpu_torch.ops import attention as attn
    from paddle_tpu_torch.parallel.mesh import mesh_guard

    out = {"parity": [], "runs": []}
    cfg32 = transformer.TransformerConfig.big()
    cfg32.dtype = "float32"
    params, _ = transformer.init(
        torch.Generator(device="cuda").manual_seed(7), cfg32, device="cuda")
    batch = transformer.make_batch(
        torch.Generator(device="cuda").manual_seed(8), cfg32, 128, 128, 128)

    def loss32(p, b, g):
        return transformer.nmt_loss(p, cfg32, b, rng=g)

    ref = _loss_grads(loss32, params, batch)
    gates_want = {"splash_shardmap": cfg32.dec_layers,
                  "flash_bias_cuda": cfg32.enc_layers + cfg32.dec_layers}
    for mesh_axes in DPTP_MESHES:
        attn.GATE_COUNTS.clear()
        got = _loss_grads(loss32, params, batch, _mesh(**mesh_axes))
        gates = dict(attn.GATE_COUNTS)
        check(gates == gates_want,
              f"dp-tp transformer {mesh_axes}: mha routes {gates}")
        out["parity"].append({
            "mesh": mesh_axes, "gates": gates,
            **_hold_loss_grads(f"dp-tp transformer {mesh_axes}", got, ref)})
        del got
    del ref
    torch.cuda.empty_cache()
    n_src, beam, steps = DPTP_BEAM
    src, sl = batch["src_ids"][:n_src], batch["src_len"][:n_src]
    with torch.inference_mode():
        want_t, want_s = transformer.beam_search(
            params, cfg32, src, sl, beam_size=beam, max_len=steps)
        with mesh_guard(_mesh(dp=2, tp=2)):
            got_t, got_s = transformer.beam_search(
                params, cfg32, src, sl, beam_size=beam, max_len=steps)
    score_err = ((got_s - want_s).abs() / want_s.abs()).max().item()
    check(torch.equal(got_t, want_t) and score_err <= 1e-5,
          f"dp-tp transformer beam under dp=2 tp=2: tokens equal "
          f"{torch.equal(got_t, want_t)}, score error {score_err}")
    out["beam"] = {"sources": n_src, "beam": beam, "max_len": steps,
                   "mesh": {"dp": 2, "tp": 2}, "tokens_equal": True,
                   "score_max_rel_err": score_err}
    del params, batch
    torch.cuda.empty_cache()
    cfg = transformer.TransformerConfig.big()

    def loss_fn(p, b, g):
        return transformer.nmt_loss(p, cfg, b, rng=g)

    for mesh_axes in DPTP_MESHES:
        params, axes = transformer.init(
            torch.Generator(device="cuda").manual_seed(7), cfg,
            device="cuda")
        batch = transformer.make_batch(
            torch.Generator(device="cuda").manual_seed(8), cfg, 128, 128,
            128)
        ranks = mesh_axes.get("dp", 1) * mesh_axes.get("tp", 1)
        per_step = {k: v * ranks for k, v in nmt_per_step(cfg).items()}
        label = f"transformer-big 128x(128,128) {mesh_axes}"
        attn.GATE_COUNTS.clear()
        row = _train_run(label, loss_fn, params, batch,
                         cfg.train_flops_per_seq(128, 128), 2, 5, per_step,
                         optimizer=_adam, trace_ok=_k2_trace_ok(label,
                                                                per_step),
                         mesh=_mesh(**mesh_axes), param_axes=axes)
        row["gates"] = dict(attn.GATE_COUNTS)
        check(row["gates"].get("splash_shardmap", 0) > 0,
              f"dp-tp transformer {mesh_axes}: mha routes {row['gates']}")
        out["runs"].append(row)
        del params, batch
        torch.cuda.empty_cache()
    return out


def _dptp_resnet_tp():
    """(f) ResNet-50's head under tp: DPTP_RESNET_TP_B images of 224^2,
    NHWC, f32 (TF32 off), under tp=2 and dp=2 tp=2 (sync BN): the loss
    within DPTP_RESNET_TOL["loss"] of no mesh, the head's weight and
    bias gradients within DPTP_HEAD_GRAD_TOL of each tensor's largest
    value against the same mesh with the head whole (no mesh for tp=2,
    dp=2 for dp=2 tp=2), and against no mesh reported."""
    import dataclasses

    import torch

    from paddle_tpu_torch.models import resnet

    cfg32 = dataclasses.replace(resnet.ResNetConfig.resnet50(),
                                dtype="float32")
    params, _ = resnet.init(torch.Generator(device="cuda").manual_seed(0),
                            cfg32, device="cuda")
    batch = resnet.make_batch(torch.Generator(device="cuda").manual_seed(1),
                              cfg32, DPTP_RESNET_TP_B, hw=224,
                              data_format="NHWC")

    def loss32(p, b, g):
        return resnet.loss_fn(p, cfg32, b, g, data_format="NHWC")

    def head(mesh_axes=None):
        got = _loss_grads(loss32, params, batch,
                          _mesh(**mesh_axes) if mesh_axes else None)
        return got["loss"], {k: got["grads"][k] for k in ("head.w", "head.b")}

    def ratio(got, want):
        return max(((got[k] - g).abs().max() /
                    (DPTP_HEAD_GRAD_TOL * g.abs().max())).item()
                   for k, g in want.items())

    ref = head()
    out = {"batch": DPTP_RESNET_TP_B, "parity": []}
    for mesh_axes, whole in ((dict(tp=2), None), (dict(dp=2, tp=2),
                                                  dict(dp=2))):
        loss, grads = head(mesh_axes)
        want = head(whole) if whole else ref
        row = {"mesh": mesh_axes, "loss_got": loss, "loss_want": ref[0],
               "loss_rel": abs(loss - ref[0]) / abs(ref[0]),
               "head_grad_against": whole or "no mesh",
               "head_grad_err_over_tol": ratio(grads, want[1]),
               "head_grad_err_over_tol_no_mesh": ratio(grads, ref[1])}
        check(row["loss_rel"] <= DPTP_RESNET_TOL["loss"]
              and row["head_grad_err_over_tol"] <= 1.0,
              f"dp-tp resnet head under {mesh_axes}: {row}")
        out["parity"].append(row)
    del params, batch
    torch.cuda.empty_cache()
    return out


def vgg_train_flops_per_image(cfg):
    """Training FLOPs of one image through VGG: 3x forward; forward = 2
    x the convs' multiply-adds at each block's resolution (SAME 3x3) and
    the fc layers'."""
    from paddle_tpu_torch.models import vgg

    hw, cin, macs = cfg.image_hw, 3, 0
    for n_convs, cout in vgg.BLOCKS:
        cout = cfg.channels(cout)
        for _ in range(n_convs):
            macs += hw * hw * 9 * cin * cout
            cin = cout
        hw //= 2
    fc = max(64, int(4096 * cfg.width_mult))
    macs += cin * hw * hw * fc + fc * fc + fc * cfg.n_classes
    return 3 * 2 * macs


def _vgg_loss(cfg):
    """VGG's mean softmax cross-entropy (the model has none of its own):
    the global batch's mean under dp."""
    import torch

    from paddle_tpu_torch.models import vgg
    from paddle_tpu_torch.models.common import dp_mean

    def loss_fn(p, b, g):
        logp = torch.log_softmax(vgg.apply(p, cfg, b["img"]).float(), -1)
        return -dp_mean(logp.gather(1, b["label"][:, None]))
    return loss_fn


def _dptp_vgg():
    """(g) VGG-16 at 224^2 (phase 23's `VGGConfig.vgg16()`): under dp=2
    with the default rules `make_train_step` refuses its params (fc2.w
    ("mlp", "mlp") would map "tp" onto both dims, ROADMAP F14); under
    dp=2 tp=2 with "mlp" mapped to None (fc1 and fc2 whole, the head
    column-parallel over the classes), the f32 loss and every gradient
    against no mesh at `_hold_loss_grads`' limits, then timed bf16
    steps (mixed_bf16, AdamW)."""
    import dataclasses

    import torch

    from paddle_tpu_torch.models import vgg
    from paddle_tpu_torch.parallel.sharding import DEFAULT_RULES
    from paddle_tpu_torch.parallel.train import make_train_step

    cfg = vgg.VGGConfig.vgg16()
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params, axes = vgg.init(torch.Generator(device="cuda").manual_seed(23),
                            cfg32, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(24)
    batch = {"img": torch.randn(DPTP_VGG_B, 3, 224, 224, generator=gen,
                                device="cuda"),
             "label": torch.randint(0, cfg.n_classes, (DPTP_VGG_B,),
                                    generator=gen, device="cuda")}
    refused = None
    try:
        make_train_step(_vgg_loss(cfg32), _adamw, device="cuda",
                        mesh=_mesh(dp=2), param_axes=axes)
    except ValueError as e:
        refused = str(e)
    check(refused is not None and "'tp'" in refused and "fc2.w" in refused,
          f"dp-tp vgg: make_train_step under dp=2 and the default rules "
          f"did not refuse fc2.w: {refused}")
    rules = DEFAULT_RULES.updated(mlp=None)
    mesh_axes = dict(dp=2, tp=2)
    ref = _loss_grads(_vgg_loss(cfg32), params, batch)
    got = _loss_grads(_vgg_loss(cfg32), params, batch, _mesh(**mesh_axes),
                      rules)
    parity = {"mesh": mesh_axes, "rules": "mlp -> None",
              **_hold_loss_grads(f"dp-tp vgg {mesh_axes}", got, ref)}
    del ref, got
    torch.cuda.empty_cache()
    row = _train_run(f"vgg-16 {DPTP_VGG_B}x224^2 {mesh_axes} mlp whole",
                     _vgg_loss(cfg), params, batch,
                     vgg_train_flops_per_image(cfg), 2, 3, {},
                     mesh=_mesh(**mesh_axes), param_axes=axes, rules=rules)
    del params, batch
    torch.cuda.empty_cache()
    return {"refused_default_rules": refused, "parity": parity,
            "runs": [row]}


def _dptp_lenet():
    """(h) LeNet (MNIST shapes, DPTP_LENET_B images) under dp=2 tp=2:
    fc1 column-parallel over its 500 outputs, fc2 whole, the loss the
    global batch's mean; the f32 loss and every gradient against no
    mesh at `_hold_loss_grads`' limits."""
    import torch

    from paddle_tpu_torch.models import lenet

    params, _ = lenet.init(torch.Generator(device="cuda").manual_seed(25),
                           device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(26)
    batch = {"img": torch.randn(DPTP_LENET_B, 1, 28, 28, generator=gen,
                                device="cuda"),
             "label": torch.randint(0, 10, (DPTP_LENET_B,), generator=gen,
                                    device="cuda")}

    def loss_fn(p, b, g):
        return lenet.loss_fn(p, b)

    ref = _loss_grads(loss_fn, params, batch)
    got = _loss_grads(loss_fn, params, batch, _mesh(dp=2, tp=2))
    return {"batch": DPTP_LENET_B, "parity": {
        "mesh": {"dp": 2, "tp": 2},
        **_hold_loss_grads("dp-tp lenet dp=2 tp=2", got, ref)}}


def _part_runs(part):
    return part.get("runs") or ([part["run"]] if "run" in part else [])


def phase_dp_tp():
    """Phase 25: graft paths 1-4 on in-process dp/tp rings (see
    `_dptp_bert`, `_dptp_resnet`, `_dptp_gpt`, `_dptp_moe`), then the
    models the JAX package also trains under a mesh: Transformer-big,
    ResNet-50's head under tp, VGG-16 and LeNet (`_dptp_transformer`,
    `_dptp_resnet_tp`, `_dptp_vgg`, `_dptp_lenet`)."""
    t0 = time.perf_counter()
    out, counts = {}, collections.Counter()
    for name, part in (("bert", _dptp_bert), ("resnet", _dptp_resnet),
                       ("gpt", _dptp_gpt), ("gpt_moe", _dptp_moe),
                       ("transformer", _dptp_transformer),
                       ("resnet_tp", _dptp_resnet_tp), ("vgg", _dptp_vgg),
                       ("lenet", _dptp_lenet)):
        t1 = time.perf_counter()
        out[name] = part()
        out[name]["seconds"] = time.perf_counter() - t1
        for row in _part_runs(out[name]):
            counts.update(row["launches"])
        print(json.dumps({"phase": "dp-tp", "part": name, **out[name]}))
    print(json.dumps({
        "phase": "dp-tp", "card": card(),
        "note": "every mesh's ranks run on this one card: no byte moves "
                "between ranks",
        "step_ms": {row["run"]: row["step_ms_median"]
                    for part in out.values() for row in _part_runs(part)},
        "seconds": time.perf_counter() - t0}))
    return counts


# Phase 23: inference at the reference's published configurations
# (tools/infer_bench.py's six: VGG16 and ResNet-50 at 224^2, bf16 at two
# batches each, int8 conv weights at the larger), through the models'
# apply entry points. INT8_REL_DELTA is tests/test_slim.py's limit on
# int8 against float logits, relative to the largest |logit|.
INFER_CONFIGS = (("vgg16", 1, "bf16"), ("vgg16", 64, "bf16"),
                 ("resnet50", 1, "bf16"), ("resnet50", 128, "bf16"),
                 ("vgg16", 64, "int8"), ("resnet50", 128, "int8"))
INFER_REPS = 30
INT8_PROBE = 32
INT8_REL_DELTA = 0.15
INT8_TOPS = 1979e12          # H100 SXM dense int8 tensor cores


def _infer_models(dev):
    """{name: (apply(params, img), bf16 params, int8 params)}: random
    weights from a seed, the floating ones cast to bf16 once (as a
    server casts them at load), conv weights quantized per output
    channel for int8 (their f32 scales kept)."""
    import torch

    from paddle_tpu_torch.models import resnet, vgg
    from paddle_tpu_torch.models.common import quantize_conv_weights_int8

    def bf16(params):
        return {k: v.to(torch.bfloat16) if v.is_floating_point() and
                not k.endswith("@scale") else v for k, v in params.items()}

    out = {}
    vcfg = vgg.VGGConfig.vgg16()
    rcfg = resnet.ResNetConfig.resnet50()
    for name, mod, cfg, seed in (("vgg16", vgg, vcfg, 0),
                                 ("resnet50", resnet, rcfg, 1)):
        params, _ = mod.init(torch.Generator(device=dev).manual_seed(seed),
                             cfg, device=dev)
        q = quantize_conv_weights_int8(params)
        fn = (lambda p, x, c=cfg: vgg.apply(p, c, x)) if name == "vgg16" \
            else (lambda p, x, c=cfg: resnet.apply(p, c, x, train=False)[0])
        out[name] = (fn, bf16(params), bf16(q))
        del params, q
    return out


class _Int8Tap:
    """Wraps ops.int8's product and im2col while active: records each
    product's (M, K, N) and, with `timed`, CUDA events around each
    product and each im2col."""

    def __init__(self, timed=False):
        self.timed = timed
        self.shapes, self.events = [], {"product": [], "im2col": []}

    def __enter__(self):
        import torch

        from paddle_tpu_torch.ops import int8

        self.mod = int8
        self.orig = (int8._product, int8.im2col_nhwc)
        prod, im2col = self.orig

        def timed(kind, fn):
            def run(*a, **kw):
                if not self.timed:
                    return fn(*a, **kw)
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                out = fn(*a, **kw)
                e1.record()
                self.events[kind].append((e0, e1))
                return out
            return run

        def product(a, bp, n):
            self.shapes.append((int(a.shape[0]), int(a.shape[1]), int(n)))
            return timed("product", prod)(a, bp, n)

        int8._product = product
        int8.im2col_nhwc = timed("im2col", im2col)
        return self

    def __exit__(self, *exc):
        self.mod._product, self.mod.im2col_nhwc = self.orig

    def ms(self, kind):
        return sum(a.elapsed_time(b) for a, b in self.events[kind])


def _int8_exact(shapes, dev):
    """Phase 23 (a): int8_matmul against the plain product (f64 on the
    card, exact at these sums) at each shape; the weight operand as the
    port lays it out (column-major) and row-major, the ms of each, and
    the first refusal of each layout."""
    import torch

    from paddle_tpu_torch.ops import int8

    g = torch.Generator(device=dev).manual_seed(23)
    rows, refused = [], {}
    for M, K, N in shapes:
        a = torch.randint(-127, 128, (M, K), generator=g, device=dev,
                          dtype=torch.int8)
        b = torch.randint(-127, 128, (K, N), generator=g, device=dev,
                          dtype=torch.int8)
        want = (a.double() @ b.double()).to(torch.int32)
        got = int8.int8_matmul(a, b)
        check(torch.equal(got, want),
              f"infer (a): int8_matmul at {(M, K, N)} differs from the "
              f"plain product")
        row = {"M": M, "K": K, "N": N}
        col = int8.gemm_operand(b)
        for layout, bp in (("row", col.contiguous()), ("col", col)):
            try:
                ok = torch.equal(int8._product(a, bp, N), want)
                row[layout + "_ms"] = time_ms(
                    lambda: int8._product(a, bp, N), reps=10)
            except RuntimeError as e:
                refused.setdefault(layout, str(e).splitlines()[0][:160])
                ok = None
            row[layout + "_exact"] = ok
            check(ok is not False, f"infer (a): {layout}-major weight "
                  f"inexact at {(M, K, N)}")
        row["tops"] = 2 * M * K * N / (row["col_ms"] * 1e-3) / 1e12
        rows.append(row)
        del a, b, want, got
    check("col" not in refused,
          f"infer (a): _int_mm refused the column-major weight: {refused}")
    return rows, refused


def _infer_config(name, bs, prec, models, dev):
    """Phase 23 (b): one configuration's ms a call (CUDA events around
    INFER_REPS back-to-back calls after warm-up), one profiled call's
    device busy time and idle share, and, at int8, the int8 products'
    and im2col's share of the call, the products' TOP/s and the logits
    against bf16 over INT8_PROBE images."""
    import torch

    fn, p_bf16, p_int8 = models[name]
    params = p_int8 if prec == "int8" else p_bf16
    g = torch.Generator(device=dev).manual_seed(2)
    img = torch.randn((bs, 3, 224, 224), generator=g, device=dev)
    out = {"model": name, "batch": bs, "precision": prec}
    with torch.inference_mode():
        logits = fn(params, img)
        check(logits.shape == (bs, 1000) and logits.dtype == torch.float32
              and bool(torch.isfinite(logits).all()),
              f"infer (b): {name} {prec} bs {bs} logits "
              f"{tuple(logits.shape)} {logits.dtype} not finite f32")
        del logits
        for _ in range(3):
            fn(params, img)
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(INFER_REPS):
            fn(params, img)
        e1.record()
        e1.synchronize()
        out["ms"] = e0.elapsed_time(e1) / INFER_REPS
        traced = _profiled_step(lambda: fn(params, img))
        out.update({k: traced[k] for k in (
            "wall_ms", "device_busy_ms", "device_idle_share",
            "device_events")})
        out["top_kernels"] = traced["top_kernels"][:5]
        out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        if prec == "int8":
            with _Int8Tap(timed=True) as tap:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn(params, img)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
            prod_ms, col_ms = tap.ms("product"), tap.ms("im2col")
            ops = sum(2 * m * k * n for m, k, n in tap.shapes)
            out.update({
                "int8_products": len(tap.shapes),
                "int8_product_ms": prod_ms, "im2col_ms": col_ms,
                "int8_product_share": prod_ms / out["ms"],
                "im2col_share": col_ms / out["ms"],
                "int8_product_tops": ops / (prod_ms * 1e-3) / 1e12,
                "int8_product_share_of_peak":
                    ops / (prod_ms * 1e-3) / INT8_TOPS,
                "tapped_call_wall_ms": wall})
            probe = img[:INT8_PROBE]
            fp = fn(p_bf16, probe).float()
            qt = fn(params, probe).float()
            d = (fp - qt).abs().max().item()
            out.update({
                "int8_vs_bf16_max_abs_logit_delta": d,
                "int8_vs_bf16_rel_logit_delta": d / fp.abs().max().item(),
                "int8_vs_bf16_top1_agreement":
                    (fp.argmax(-1) == qt.argmax(-1)).float().mean().item()})
            check(out["int8_vs_bf16_rel_logit_delta"] < INT8_REL_DELTA,
                  f"infer (b): {name} int8 logits {d} from bf16, "
                  f"{out['int8_vs_bf16_rel_logit_delta']} of the largest "
                  f"(limit {INT8_REL_DELTA})")
    return out


def phase_infer():
    import torch

    t0 = time.perf_counter()
    dev = torch.device("cuda")
    models = _infer_models(dev)
    # (a) every distinct product shape of both models at batch 1, taken
    # from int8 forwards, plus an M below _int_mm's 17
    shapes = set()
    with torch.inference_mode(), _Int8Tap() as tap:
        for name in ("vgg16", "resnet50"):
            models[name][0](models[name][2],
                            torch.zeros((1, 3, 224, 224), device=dev))
    shapes = sorted(set(tap.shapes) | {(5, 27, 64)})
    check(any(k == 27 for _, k, _ in shapes) and
          any(k == 147 for _, k, _ in shapes),
          f"infer (a): the padded K 27 and 147 shapes are missing: {shapes}")
    exact, refused = _int8_exact(shapes, dev)
    configs = []
    for name, bs, prec in INFER_CONFIGS:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        configs.append(_infer_config(name, bs, prec, models, dev))
    print(json.dumps({
        "phase": "infer", "card": card(),
        "int8_matmul_exact_shapes": len(exact),
        "int8_matmul": exact, "int_mm_refused": refused,
        "configs": configs,
        "reference_v100_fp16_ms (BASELINE.md, a V100's)": {
            "vgg16 bs1": 3.32, "vgg16 bs64": 60.23,
            "resnet50 bs1": 6.13, "resnet50 bs128": 64.52},
        "seconds": time.perf_counter() - t0}))
    del models
    torch.cuda.empty_cache()


# Phase 24: the LeNet rung behind POST /v1/predict. PREDICT_TOL holds each
# precision's replies on the card against a CPU Predictor's at the same
# precision, on the same rows and the same served dir (TF32 off),
# relative to the largest |logit| of the reply: f32 and int8 as
# tests/test_torch_predict.py holds the packages' f32 and int8 replies
# (int8: an activation on a rounding boundary may move one int8 step).
# bf16's worst reply within 4 bf16 steps (2**-8): cuDNN's bf16 convs at
# the small buckets round some values otherwise than the CPU's (1.62
# steps read on an H100), and every reply's mean gap, relative to its
# largest |logit|, within PREDICT_BF16_MEAN, a tenth of a step: a
# missed cast moves the mean by bf16's own move from f32 (printed as
# `mean_vs_f32`). PREDICT_TOP1_MIN is the least top-1 agreement of
# bf16's and int8's replies with f32's.
PREDICT_REQUESTS = 256
PREDICT_THREADS = 16
PREDICT_TOL = {"f32": 1e-5, "bf16": 4 * 2.0 ** -8, "int8": 1e-3}
PREDICT_BF16_MEAN = 0.1 * 2.0 ** -8
PREDICT_TOP1_MIN = 0.99


def _predict_round(port, requests):
    """`requests` (a list of row arrays) over POST /v1/predict from
    PREDICT_THREADS client threads: (replies in order, latencies s,
    wall s)."""
    replies, lat = [None] * len(requests), [None] * len(requests)
    nxt = iter(range(len(requests)))
    lock = threading.Lock()

    def worker():
        while True:
            with lock:
                i = next(nxt, None)
            if i is None:
                return
            body = json.dumps({"feeds": {"x": requests[i].tolist()}})
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/v1/predict", data=body.encode(),
                headers={"Content-Type": "application/json"})
            t = time.perf_counter()
            with urllib.request.urlopen(req, timeout=120) as r:
                replies[i] = json.loads(r.read())
            lat[i] = time.perf_counter() - t

    threads = [threading.Thread(target=worker)
               for _ in range(PREDICT_THREADS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return replies, lat, time.perf_counter() - t0


def _lenet_saved(pt, root, saves=(FLUID_STEPS,), place=None):
    """Phase 24's model: the LeNet rung trained with Adam on `place`
    (the card unless given), saved as an inference model fetching the
    logits after each step count of `saves` (dirs whose replies
    differ): the dirs and the losses."""
    main, startup, loss = lenet_rung_program(pt)
    exe = pt.Executor(pt.CUDAPlace(0) if place is None else place)
    scope = pt.Scope()
    x, y = synthetic_mnist(FLUID_B, seed=24)
    dirs, losses = [], []
    with pt.scope_guard(scope):
        exe.run(startup)
        for step in range(1, max(saves) + 1):
            losses.append(float(exe.run(main, feed={"x": x, "y": y},
                                        fetch_list=[loss])[0][0]))
            if step in saves:
                dirs.append(os.path.join(root, f"lenet{step}"))
                pt.io.save_inference_model(dirs[-1], ["x"],
                                           [lenet_rung_logits(main)], exe,
                                           main_program=main)
    check(np.isfinite(losses).all() and losses[-1] < losses[0],
          f"lenet: the rung did not train: {losses[0]} -> {losses[-1]}")
    return dirs, losses


def _serve_precision(model_dir, precision, requests, calibration):
    from paddle_tpu_torch.serving import Server, ServingConfig
    from paddle_tpu_torch.serving import engine as eng_mod

    kw = {} if precision == "f32" else {"calibration": calibration,
                                        "accuracy_check_batches": 4}
    srv = Server(ServingConfig(model_dir, precision=precision, **kw))
    port = srv.start(0)
    try:
        pred = srv.engine._pred
        check(srv.engine.warmed and len(pred.signatures()) == 7 and
              all(pred._cache.values()),
              f"predict {precision}: warmup readied "
              f"{len(pred.signatures())} buckets, not 7")
        code, health, _ = _get_json(port, "/v1/healthz")
        check(code == 200 and health["state"] == "serving",
              f"predict {precision}: healthz {code} {health}")
        _, models, _ = _get_json(port, "/v1/models")
        row = models["models"][0]
        check(row["kind"] == "predict" and row["warmed"] and
              row["buckets"] == [1, 2, 4, 8, 16, 32, 64],
              f"predict {precision}: /v1/models {models}")
        before = {b: eng_mod.BATCHES.value(bucket=str(b))
                  for b in srv.engine.policy.buckets}
        pad0 = eng_mod.PAD_ROWS.value()
        replies, lat, wall = _predict_round(port, requests)
        status = _get_json(port, "/v1/status")[1]
        batches = {str(b): eng_mod.BATCHES.value(bucket=str(b)) - n
                   for b, n in before.items()}
        sigs = pred.signatures()
        check(len(sigs) == 7 and {s[0][1][0] for s in sigs} ==
              {1, 2, 4, 8, 16, 32, 64},
              f"predict {precision}: off-bucket signatures {sigs}")
        rows = sum(len(r) for r in requests)
        lat_ms = sorted(x * 1e3 for x in lat)
        # nearest rank over every request of the round
        out = {"precision": precision, "requests": len(requests),
               "rows": rows, "requests_per_s": len(requests) / wall,
               "rows_per_s": rows / wall,
               "p50_ms": lat_ms[math.ceil(0.50 * len(lat_ms)) - 1],
               "p99_ms": lat_ms[math.ceil(0.99 * len(lat_ms)) - 1],
               "batches_per_bucket": batches,
               "pad_rows": eng_mod.PAD_ROWS.value() - pad0,
               "accuracy_delta": status["accuracy_delta"],
               "requests_outcomes": status["requests"],
               "signatures": len(sigs)}
        check(status["requests"]["ok"] == len(requests),
              f"predict {precision}: outcomes {status['requests']}")
        return out, [np.asarray(r["outputs"][next(iter(r["outputs"]))],
                                np.float32) for r in replies], \
            srv.engine._served_dir
    finally:
        srv.stop()


def phase_predict():
    import tempfile

    import paddle_tpu_torch as pt
    from paddle_tpu_torch.inference import (AnalysisConfig,
                                            create_paddle_predictor)

    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="chip_smoke_predict_")
    (model_dir,), losses = _lenet_saved(pt, root)
    rs = np.random.RandomState(24)
    pool, _ = synthetic_mnist(2048, seed=25)
    sizes = rs.randint(1, 9, PREDICT_REQUESTS)
    starts = rs.randint(0, len(pool) - 8, PREDICT_REQUESTS)
    requests = [pool[s:s + n] for s, n in zip(starts, sizes)]
    cal_x = synthetic_mnist(64, seed=26)[0]
    calibration = [{"x": cal_x[i:i + 16]} for i in range(0, 64, 16)]
    results, outs = {}, {}

    def gap(got, want):
        """(max, mean) of |got - want| over the largest |want|."""
        d = np.abs(got - want) / np.abs(want).max()
        return float(d.max()), float(d.mean())

    for precision in ("f32", "bf16", "int8"):
        results[precision], outs[precision], served = _serve_precision(
            model_dir, precision, requests, calibration)
        # the replies against a CPU Predictor's at this precision on the
        # same rows and the dir the server served (int8: its sibling)
        cfg = AnalysisConfig(served)
        cfg.disable_gpu()
        if precision == "bf16":
            cfg.set_precision("bf16")
        cpu = create_paddle_predictor(cfg)
        gaps = []
        for rows, got in zip(requests, outs[precision]):
            want = next(iter(cpu.predict(x=rows).values()))
            check(got.shape == want.shape, f"predict {precision}: reply "
                  f"{got.shape} for {want.shape}")
            gaps.append(gap(got, want))
        worst = max(g[0] for g in gaps)
        mean = float(np.mean([g[1] for g in gaps]))
        results[precision].update({"vs_cpu_worst": worst,
                                   "vs_cpu_mean": mean})
        check(worst <= PREDICT_TOL[precision], f"predict {precision}: the "
              f"card's replies differ from the CPU's by {worst} (limit "
              f"{PREDICT_TOL[precision]})")
        check(precision != "bf16" or mean <= PREDICT_BF16_MEAN,
              f"predict bf16: the mean gap to the CPU's replies {mean} "
              f"(limit {PREDICT_BF16_MEAN})")
    for precision in ("bf16", "int8"):
        agree = float(np.mean(np.concatenate([
            a.argmax(-1) == b.argmax(-1) for a, b in
            zip(outs[precision], outs["f32"])])))
        vs_f32 = [gap(a, b) for a, b in zip(outs[precision], outs["f32"])]
        rel = max(g[0] for g in vs_f32)
        results[precision].update({
            "top1_agreement_with_f32": agree, "rel_delta_vs_f32": rel,
            "mean_vs_f32": float(np.mean([g[1] for g in vs_f32]))})
        delta = results[precision]["accuracy_delta"]
        check(delta is not None and np.isfinite(delta["max_abs"]),
              f"predict {precision}: no accuracy_delta")
        check(agree >= PREDICT_TOP1_MIN and rel < INT8_REL_DELTA,
              f"predict {precision}: top-1 agreement with f32 {agree} "
              f"(least {PREDICT_TOP1_MIN}), relative delta {rel} (limit "
              f"{INT8_REL_DELTA})")
    print(json.dumps({
        "phase": "predict", "card": card(),
        "model": "bench.py's LeNet rung, trained on the card, saved",
        "train_loss": [losses[0], losses[-1]],
        "vs_cpu_limit": PREDICT_TOL, "bf16_mean_limit": PREDICT_BF16_MEAN,
        "top1_min": PREDICT_TOP1_MIN,
        "servers": results, "seconds": time.perf_counter() - t0}))
    import shutil

    shutil.rmtree(root, ignore_errors=True)


# phase 26: the multi-tenant serving front and the fleet tier
# three tiers; two normal tenants sharing their tier 3:1, a high one, a
# low one with a quota of 2; an unknown tenant lands on "low"; "capped"
# may hold nothing (its every request is a quota shed)
FLEET_POLICY = {"tiers": ["high", "normal", "low"], "default_tier": "low",
                "tenants": {"gold": {"tier": "high"},
                            "a": {"tier": "normal", "weight": 3},
                            "b": {"tier": "normal", "weight": 1},
                            "bulk": {"tier": "low", "max_inflight": 2},
                            "capped": {"tier": "low", "max_inflight": 0}}}
# the burst: 6 gold, a and b requests, no more than the queue holds, so
# every queue shed must land on the low tier (7 entries, at most 6 of
# them not low); 6 bulk against its quota of 2; 26 anon
FLEET_QUEUE = 6
FLEET_BURST = (("gold", 2), ("a", 2), ("b", 2), ("bulk", 6), ("anon", 26))
FLEET_LOW = ("bulk", "anon")
FLEET_NEW = 24
FLEET_BUCKETS = (32, 64, 128)
FLEET_CHUNK = 64
FLEET_SLOTS = (4, 8)
FLEET_PREDICT_THREADS = 8


def _fleet_burst(vocab):
    """(tenant, prompt) of every burst request, shuffled from a seed."""
    rs = np.random.RandomState(26)
    tenants = [t for t, n in FLEET_BURST for _ in range(n)]
    lengths = rs.randint(5, 120, len(tenants))
    prompts = [rs.randint(0, vocab, size=n).tolist() for n in lengths]
    return [(tenants[i], prompts[i]) for i in rs.permutation(len(tenants))]


def _post_json(port, path, payload, timeout=600):
    """(status, JSON body, headers) of one POST on a serving port."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read()), r.headers
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), e.headers


def _shed_ok(label, tenant, out, kinds=("queue", "quota")):
    """A typed shed 503: the body's keys, its tier, kind and tenant, and
    Retry-After."""
    body = out.get("body") or {}
    tier = "low" if tenant in FLEET_LOW or tenant not in \
        FLEET_POLICY["tenants"] else FLEET_POLICY["tenants"][tenant]["tier"]
    check(out.get("code") == 503 and set(body) == {
        "error", "shed", "kind", "tenant", "retry_after_s"}
        and body["shed"] == tier and body["kind"] in kinds
        and out.get("retry_after") == "1",
        f"{label}: a 503 that is not the typed shed: {out}")
    return body


def _burst_gates(label, reqs, results, max_new, want=None,
                 need_shed=True):
    """Phase 26 (a)'s gates over one burst; returns its summary."""
    sheds = collections.Counter()
    served = collections.Counter()
    for (tenant, _), out in zip(reqs, results):
        check("error" not in out, f"{label} {tenant}: {out.get('error')}")
        if "code" in out:
            # every shed lands on the low tier: gold, a and b never
            # exceed the queue, so a low request is always present
            check(tenant in FLEET_LOW,
                  f"{label}: a {tenant} request was shed: {out}")
            body = _shed_ok(label, tenant, out)
            check(body["tenant"] == tenant and (
                body["kind"] == "queue" or tenant == "bulk"),
                f"{label}: shed body {body} for {tenant}")
            sheds[(body["shed"], body["kind"])] += 1
            continue
        err = (out["done"] or {}).get("error")
        if err is not None:
            # a queued request displaced by a later arrival: its stream
            # was open already, so its shed travels in-band
            check(tenant in FLEET_LOW and not out["tokens"] and
                  err.startswith("ShedError") and
                  "shed tier 'low'" in err,
                  f"{label}: {tenant} ended with {out['done']}")
            sheds[("low", "queued")] += 1
            continue
        check(len(out["tokens"]) == max_new and out["done"] and
              out["done"].get("finish_reason") == "length",
              f"{label} {tenant}: {len(out['tokens'])} tokens, done "
              f"{out['done']}")
        served[tenant] += 1
    # bulk's quota sheds depend on how many of its requests overlap; the
    # quota shed is held by each server's "capped" request
    check(not need_shed or sheds[("low", "queue")] > 0,
          f"{label}: the burst shed {dict(sheds)}: want a queue shed")
    for tenant, _ in FLEET_BURST:
        if tenant not in FLEET_LOW:
            check(served[tenant] == dict(FLEET_BURST)[tenant],
                  f"{label}: {tenant} served {served[tenant]}")
    exact = None
    if want is not None:
        # f32 streams are exact: a served request's tokens are the
        # no-policy engine's for its prompt
        ok = [i for i, out in enumerate(results) if "code" not in out
              and not (out["done"] or {}).get("error")]
        bad = [i for i in ok if results[i]["tokens"] != want[i]]
        check(not bad, f"{label}: tokens differ from the no-policy "
              f"engine's at requests {bad}")
        exact = len(ok)
    return {"served": dict(served),
            "sheds": {f"{t}/{k}": n for (t, k), n in sorted(sheds.items())},
            "exact_streams": exact}


def _fleet_round(label, port, reqs, model=None, chunked=False):
    """The burst `reqs` ((tenant, prompt) each) over HTTP with the K1-fwd
    count and the gate counts set to 0 just before it and read just
    after: the results, the wall seconds, the launches and the gate
    counts. Fails if an attention call took another route than K1-fwd
    ("flash_cuda"), and unless K1-fwd ran. With `chunked` (the sync
    loop's prefill_chunk) every prompt runs `apply_prefill_chunk`,
    plain torch as the JAX package's chunk step is plain XLA: no kernel
    is launched there."""
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.ops import attention as attn

    fa.flash_attention.launches = 0
    attn.GATE_COUNTS.clear()
    results, wall = _http_round(port, [p for _, p in reqs], FLEET_NEW,
                                tenants=[t for t, _ in reqs], model=model)
    launches = fa.flash_attention.launches
    gates = dict(attn.GATE_COUNTS)
    check(set(gates) <= {"flash_cuda"},
          f"{label}: attention off K1-fwd: {gates}")
    check(chunked or launches > 0, f"{label}: {launches} K1-fwd launches")
    return results, wall, launches, gates


def _gpt2_params():
    import torch

    from paddle_tpu_torch.models import gpt

    cfg = gpt.GPTConfig()                       # GPT-2-small
    params, _ = gpt.init(torch.Generator(device="cuda").manual_seed(0),
                         cfg)
    return params, cfg


def _fleet_engine(params, cfg, precision, qos=True, **kw):
    """A GPT-2-small engine of phase 26: with FLEET_POLICY and the
    burst's small queue, or (qos=False) with neither."""
    from paddle_tpu_torch.serving import DecodeConfig, DecodeEngine

    return DecodeEngine(params, cfg, DecodeConfig(
        block_size=16, num_blocks=512, decode_slots=FLEET_SLOTS,
        prefill_buckets=FLEET_BUCKETS, precision=precision,
        max_queue=FLEET_QUEUE if qos else 64,
        qos=FLEET_POLICY if qos else None, **kw))


def _fleet_decode_qos(params, cfg):
    """Phase 26 (a) at f32: the burst over HTTP on the async loop and on
    the sync loop (prefill_chunk), each stream against the no-policy
    engine's. Returns the results and the bursts' K1-fwd launches."""
    import torch

    from paddle_tpu_torch.serving import Server, ServingConfig

    reqs = _fleet_burst(cfg.vocab_size)
    ref = _fleet_engine(params, cfg, "f32", qos=False)
    ref.warmup()
    try:
        want = _kv_streams(ref, [p for _, p in reqs], FLEET_NEW)
    finally:
        ref.stop()
    out, counted = {}, 0
    for label, kw in (("async", {}),
                      ("sync", {"prefill_chunk": FLEET_CHUNK})):
        eng = _fleet_engine(params, cfg, "f32", **kw)
        srv = Server(ServingConfig(), decode=eng)
        port = srv.start(0)
        try:
            results, wall, launches, gates = _fleet_round(
                f"fleet {label}", port, reqs, chunked=label == "sync")
            code, quota, hdrs = _post_json(port, "/v1/generate", {
                "ids": reqs[0][1], "tenant": "capped", "stream": False})
            status = eng.status()
        finally:
            srv.stop()
        check(eng._sync == (label == "sync"), f"fleet {label}: the loop")
        body = _shed_ok(f"fleet {label} quota", "capped", {
            "code": code, "body": quota,
            "retry_after": hdrs.get("Retry-After")}, kinds=("quota",))
        out[label] = {**_burst_gates(f"fleet {label}", reqs, results,
                                     FLEET_NEW, want),
                      "wall_s": wall, "quota_shed": body,
                      "served_shares": status["qos"]["served_shares"],
                      "requests": status["requests"],
                      "launches": {"flash_attention_fwd": launches},
                      "gate_counts": gates}
        check(set(out[label]["served_shares"]) >= {"gold", "a", "b"},
              f"fleet {label}: served shares {out[label]['served_shares']}")
        counted += launches
        del eng, srv
        torch.cuda.empty_cache()
    return out, counted


def _tier_ttft(reqs, results):
    """Client TTFT p50 and p99 (nearest rank, ms) by tier over the
    served requests."""
    by = collections.defaultdict(list)
    for (tenant, _), out in zip(reqs, results):
        if "ttft_s" in out:
            tier = "low" if tenant in FLEET_LOW else \
                FLEET_POLICY["tenants"][tenant]["tier"]
            by[tier].append(out["ttft_s"] * 1e3)
    return {tier: {"n": len(v),
                   "p50_ms": sorted(v)[math.ceil(0.50 * len(v)) - 1],
                   "p99_ms": sorted(v)[math.ceil(0.99 * len(v)) - 1]}
            for tier, v in sorted(by.items())}


def _cpu_predictor(d, precision="f32"):
    from paddle_tpu_torch.inference import (AnalysisConfig,
                                            create_paddle_predictor)

    cfg = AnalysisConfig(d)
    cfg.disable_gpu()
    if precision != "f32":
        cfg.set_precision(precision)
    return create_paddle_predictor(cfg)


def _predict_traffic(port, model, tenant, stop, log, seed):
    """Predict requests for one slot until `stop` is set: (t_start,
    t_end, rows, status, reply) each."""
    rs = np.random.RandomState(seed)
    pool = synthetic_mnist(256, seed=seed)[0]
    while not stop.is_set():
        n = int(rs.randint(1, 9))
        i = int(rs.randint(0, len(pool) - 8))
        rows = pool[i:i + n]
        t0 = time.monotonic()
        code, reply, _ = _post_json(port, "/v1/predict", {
            "feeds": {"x": rows.tolist()}, "model": model,
            "tenant": tenant}, timeout=120)
        log.append((t0, time.monotonic(), rows, code, reply))


def _replies_held(label, entries, wants, tol):
    """Every reply is a 200 and equals (at `tol`, relative to the
    largest |reply|) the reply of one of the `wants` CPU predictors;
    returns the worst gap."""
    worst = 0.0
    for _, _, rows, code, reply in entries:
        check(code == 200, f"{label}: predict {code} {reply}")
        got = np.asarray(next(iter(reply["outputs"].values())), np.float32)
        gaps = []
        for w in wants:
            want = next(iter(w.predict(x=rows).values()))
            gaps.append(float(np.abs(got - want).max() / np.abs(want).max()))
        check(min(gaps) <= tol, f"{label}: replies differ by {gaps} "
              f"(limit {tol})")
        worst = max(worst, min(gaps))
    return worst


def _swap_under_traffic(port, label, swap, old_dir, new_dir, tol,
                        precision):
    """`swap()` while predict traffic for slot `label` runs: replies
    before it against the old dir's CPU Predictor, after it against the
    new dir's, in between against either."""
    stop, log = threading.Event(), []
    workers = [threading.Thread(target=_predict_traffic, daemon=True,
                                args=(port, label, "a", stop, log, s))
               for s in range(FLEET_PREDICT_THREADS)]
    for w in workers:
        w.start()
    deadline = time.monotonic() + 60
    while len(log) < 40 and time.monotonic() < deadline:
        time.sleep(0.01)
    t0 = time.monotonic()
    record = swap()
    t1 = time.monotonic()
    n = len(log)
    while len(log) < n + 40 and time.monotonic() < deadline + 60:
        time.sleep(0.01)
    stop.set()
    for w in workers:
        w.join(timeout=120)
    old = _cpu_predictor(old_dir, precision)
    new = _cpu_predictor(new_dir, precision)
    before = [e for e in log if e[1] < t0]
    after = [e for e in log if e[0] > t1]
    during = [e for e in log if e[1] >= t0 and e[0] <= t1]
    check(before and after, f"swap {label}: {len(before)} replies before, "
          f"{len(after)} after")
    failed = sum(1 for e in log if e[3] != 200)
    check(failed == 0, f"swap {label}: {failed} failed requests")
    return {"requests": len(log), "before": len(before),
            "during": len(during), "after": len(after), "failed": failed,
            "worst_before": _replies_held(f"swap {label} before", before,
                                          [old], tol),
            "worst_after": _replies_held(f"swap {label} after", after,
                                         [new], tol),
            "worst_during": _replies_held(f"swap {label} during", during,
                                          [old, new], tol),
            "record": record}


def _fleet_slots_and_swap(params, cfg, root):
    """Phase 26 (a)'s bf16 burst and (b): one Server with two
    LeNet slots (f32, bf16) and the GPT-2-small bf16 engine; hot_swap
    and a registry publish under predict traffic. Returns the server,
    still running, the registry's LeNet dir, the results and the bf16
    burst's K1-fwd launches."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.serving import (Engine, ModelRegistry,
                                          RegistryError, Server,
                                          ServingConfig)
    from paddle_tpu_torch.observability import events

    (d_old, d_new, d_reg), _ = _lenet_saved(pt, root, (20, 40, 80))
    eng = _fleet_engine(params, cfg, "bf16")
    srv = Server(ServingConfig(d_old, model_id="lenet", qos=FLEET_POLICY),
                 models={"lenet_bf16": ServingConfig(d_old,
                                                     precision="bf16")},
                 decode={"gpt2": eng})
    port = srv.start(0)
    out = {}
    # (a)'s bf16 burst on the async loop, all its streams started
    # together: a gate of sheds and service by tier; its TTFT and
    # tokens/s are one burst's (2 high-tier requests), not a measure of
    # the tiers' latency
    reqs = _fleet_burst(cfg.vocab_size)
    results, wall, launches, gates = _fleet_round("fleet bf16", port, reqs,
                                                  model="gpt2")
    timed = _burst_gates("fleet bf16", reqs, results, FLEET_NEW,
                         need_shed=False)
    n_tok = sum(len(o["tokens"]) for o in results if "code" not in o)
    out["bf16"] = {**timed, "wall_s": wall, "tokens": n_tok,
                   "tokens_per_s": n_tok / wall,
                   "ttft_by_tier": _tier_ttft(reqs, results),
                   "launches": {"flash_attention_fwd": launches},
                   "gate_counts": gates,
                   "served_shares": eng.status()["qos"]["served_shares"]}
    # (b) predict slots: routing by "model", the rows of /v1/models
    _, models, _ = _get_json(port, "/v1/models")
    rows = {r["id"]: r for r in models["models"]}
    check(set(rows) == {"lenet", "lenet_bf16", "gpt2"} and
          rows["lenet"]["kind"] == "predict" and
          rows["lenet_bf16"]["kind"] == "predict" and
          rows["gpt2"]["kind"] == "decode",
          f"fleet: /v1/models {models}")
    code, body, _ = _post_json(port, "/v1/predict", {
        "feeds": {"x": synthetic_mnist(2, seed=3)[0].tolist()},
        "model": "nope"})
    check(code == 404, f"fleet: unknown model {code} {body}")
    events.clear()
    # hot swap of each slot under traffic, the decode engine beside them
    gen = {}
    gthread = threading.Thread(target=_generate, daemon=True,
                               args=(port, reqs[0][1], 64, gen, "gold",
                                     "gpt2"))
    gthread.start()
    out["swap_f32"] = _swap_under_traffic(
        port, "lenet", lambda: srv.hot_swap("lenet", model_dir=d_new),
        d_old, d_new, PREDICT_TOL["f32"], "f32")
    out["swap_bf16"] = _swap_under_traffic(
        port, "lenet_bf16",
        lambda: srv.hot_swap("lenet_bf16", model_dir=d_new),
        d_old, d_new, PREDICT_TOL["bf16"], "bf16")
    gthread.join(timeout=300)
    check(len(gen.get("tokens", [])) == 64, f"fleet: the generation beside "
          f"the swaps: {gen}")
    # the registry: a published artifact of the third dir, adopted by
    # the watcher under traffic
    reg = ModelRegistry(os.path.join(root, "registry"))
    art = os.path.join(root, "lenet_reg.warm.json")
    warm = Engine(ServingConfig(d_reg))
    warm.warmup()
    check(warm.export_warmstart(art) == 7, "fleet: warmstart entries")
    del warm
    # an artifact baked from another program is refused
    with open(art) as f:
        other = json.load(f)
    other["model_digest"] = "0" * 64
    bad = os.path.join(root, "other.warm.json")
    with open(bad, "w") as f:
        json.dump(other, f)
    try:
        reg.publish("lenet", bad, model_dir=d_reg)
        check(False, "fleet: a digest mismatch was published")
    except RegistryError:
        pass
    srv.attach_registry(reg, model_ids=["lenet"], poll_s=0.05)

    def publish():
        entry = reg.publish("lenet", art, model_dir=d_reg)
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            row = {r["id"]: r for r in srv.models()}["lenet"]
            if row["version"] == entry["version"]:
                return entry
            time.sleep(0.01)
        check(False, "fleet: the watcher did not adopt the publish")

    out["swap_registry"] = _swap_under_traffic(
        port, "lenet", publish, d_new, d_reg, PREDICT_TOL["f32"],
        "f32")
    _, models, _ = _get_json(port, "/v1/models")
    row = {r["id"]: r for r in models["models"]}["lenet"]
    check(row["version"] == 1 and row["warmstart_adopted"] == 7 and
          row["digest"] == Engine._digest_model_file(d_reg),
          f"fleet: /v1/models after the registry swap: {row}")
    # a tampered blob is refused: the version stays, the watcher lives
    e2 = reg.publish("lenet", art, model_dir=d_reg)
    with open(e2["path"], "ab") as f:
        f.write(b" ")
    deadline = time.monotonic() + 60
    while not events.recent(50, kind="model_swap_failed") and \
            time.monotonic() < deadline:
        time.sleep(0.01)
    failed = events.recent(50, kind="model_swap_failed")
    check(failed and "digest check" in failed[-1]["error"] and
          {r["id"]: r for r in srv.models()}["lenet"]["version"] == 1,
          f"fleet: a tampered blob: {failed}")
    out["swaps"] = [{k: e[k] for k in ("model", "version", "swap_s",
                                       "warmstart_adopted")}
                    for e in events.recent(50, kind="model_swap")]
    check(len(out["swaps"]) == 3, f"fleet: swaps {out['swaps']}")
    return srv, d_reg, out, launches


def _fleet_router(params, cfg, srv_a, d_reg):
    """Phase 26 (c): a RouterServer over the (b) server and a second one,
    each with its GPT-2-small bf16 engine; both are warm before any
    request is routed (no capture runs beside a serving engine).
    Returns the results and the routed streams' K1-fwd launches."""
    from paddle_tpu_torch.serving import (Router, RouterServer, Server,
                                          ServingConfig)
    from paddle_tpu_torch.serving import router as router_mod

    srv_b = Server(ServingConfig(d_reg, model_id="lenet", qos=FLEET_POLICY),
                   decode={"gpt2": _fleet_engine(params, cfg, "bf16")})
    eps = [f"127.0.0.1:{srv_a.port()}", f"127.0.0.1:{srv_b.start(0)}"]
    router = Router(eps, poll_interval_s=0.25, retries=2,
                    breaker_reset_s=1.0, request_timeout_s=300)
    probe = Router(eps, retries=2, request_timeout_s=300)
    front = RouterServer(router)
    fport = front.start(0)
    out = {}
    try:
        router.poll_once()
        probe.poll_once()
        check(router.healthy_endpoints() == sorted(eps),
              f"fleet router: healthy {router.healthy_endpoints()}")
        # 12 streams of gold, a and b (the burst's low tier as gold): no
        # more than one replica's slots and queue hold, so none is shed
        # wherever p2c sends it
        reqs = [("gold" if t in FLEET_LOW else t, p)
                for t, p in _fleet_burst(cfg.vocab_size)[:12]]
        gens, gwall, launches, _ = _fleet_round("fleet router", fport, reqs,
                                                model="gpt2")
        for (t, _), o in zip(reqs, gens):
            check("error" not in o and "code" not in o and
                  len(o["tokens"]) == FLEET_NEW,
                  f"fleet router: generate {t}: {o}")
        # then predict traffic, from FLEET_PREDICT_THREADS clients
        pool = synthetic_mnist(256, seed=27)[0]
        stop, log = threading.Event(), []
        workers = [threading.Thread(target=_predict_traffic, daemon=True,
                                    args=(fport, "lenet", "a", stop, log,
                                          s))
                   for s in range(FLEET_PREDICT_THREADS)]
        t0 = time.perf_counter()
        for w in workers:
            w.start()
        # a typed shed reaches the client unchanged, with no failover
        sheds0 = router_mod.FLEET_SHEDS.value(tier="low")
        retries0 = dict(router.status()["retries"])
        for path, payload in (
                ("/v1/predict", {"feeds": {"x": pool[:2].tolist()},
                                 "model": "lenet", "tenant": "capped"}),
                ("/v1/generate", {"ids": reqs[0][1], "tenant": "capped",
                                  "model": "gpt2", "stream": False})):
            code, body, hdrs = _post_json(fport, path, payload)
            _shed_ok(f"fleet router {path}", "capped", {
                "code": code, "body": body,
                "retry_after": hdrs.get("Retry-After")}, kinds=("quota",))
        check(router_mod.FLEET_SHEDS.value(tier="low") - sheds0 == 2 and
              router.status()["retries"] == retries0,
              f"fleet router: sheds {router.status()}")
        # stop one replica in the middle of the predict burst
        n = len(log)
        while len(log) < n + 40:
            time.sleep(0.01)
        picks = {r["endpoint"]: r["picks"]
                 for r in router.status()["replicas"]}
        check(all(n > 0 for n in picks.values()),
              f"fleet router: p2c picked {picks}")
        srv_a.stop()
        t_stop = time.monotonic()
        while not [e for e in log if e[0] > t_stop + 0.5] and \
                time.monotonic() < t_stop + 60:
            time.sleep(0.01)
        # the probe router still ranks the stopped replica first (equal
        # cached loads): its stream, with no token delivered, is
        # resubmitted on the survivor
        toks = [r["token"] for r in probe.generate(
            reqs[1][1], max_new_tokens=FLEET_NEW, model="gpt2")
            if "token" in r]
        check(len(toks) == FLEET_NEW and
              probe.status()["retries"].get("stream_restart") == 1,
              f"fleet router: the probe stream {probe.status()}")
        stop.set()
        for w in workers:
            w.join(timeout=120)
        wall = time.perf_counter() - t0
        failed = [e for e in log if e[3] != 200]
        check(not failed, f"fleet router: {len(failed)} predict failures: "
              f"{failed[:2]}")
        worst = _replies_held("fleet router", log,
                              [_cpu_predictor(d_reg)], PREDICT_TOL["f32"])
        st = router.status()
        out = {"predict_requests": len(log),
               "predict_requests_per_s": len(log) / wall,
               "predict_worst_vs_cpu": worst,
               "generate": len(gens), "generate_wall_s": gwall,
               "picks": picks, "retries": st["retries"],
               "requests": st["requests"],
               "probe_retries": probe.status()["retries"],
               "healthy_after_stop": router.healthy_endpoints()}
    finally:
        front.stop()
        probe.stop()
        srv_a.stop()
        srv_b.stop()
    return out, launches


def _fleet_supervisor(root):
    """Phase 26 (d): a ReplicaSupervisor of `--decode-tiny 0` replica
    processes, discovered through the rendezvous; SIGKILL, SIGTERM and
    the autoscaler on the router's load signal."""
    from paddle_tpu_torch.distributed.launch_serve import (ReplicaSpec,
                                                           ReplicaSupervisor)
    from paddle_tpu_torch.serving import Autoscaler, Router

    rdzv = os.path.join(root, "rdzv")
    spec = ReplicaSpec("", drain_timeout_s=10.0,
                       extra_args=["--decode-tiny", "0",
                                   "--heartbeat-s", "0.2"])
    sup = ReplicaSupervisor(spec, rdzv, replicas=2, max_respawns=2,
                            backoff_s=0.1, log_dir=os.path.join(root, "logs"))
    router = Router(rdzv_dir=rdzv, poll_interval_s=0.1,
                    request_timeout_s=300)

    def wait_healthy(n, what, timeout=180):
        t0 = time.monotonic()
        while time.monotonic() - t0 < timeout:
            router.poll_once()
            if len(router.healthy_endpoints()) == n:
                return time.monotonic() - t0
            time.sleep(0.05)
        check(False, f"fleet supervisor: {what}: healthy "
              f"{router.healthy_endpoints()}, slots {sup.slot_info()}")

    out = {}
    try:
        sup.start()
        out["spawn_to_ready_s"] = wait_healthy(2, "spawn")
        toks = [r["token"] for r in router.generate([1, 2, 3],
                                                    max_new_tokens=8)
                if "token" in r]
        check(len(toks) == 8, f"fleet supervisor: generate {toks}")
        killed = sup.kill_slot(0)
        t0 = time.monotonic()
        log0 = os.path.join(root, "logs", "replica.0.log")

        def readies():
            with open(log0) as f:
                return sum(1 for line in f if '"ready": true' in line)

        while readies() < 2 and time.monotonic() - t0 < 180:
            time.sleep(0.02)
        # kill to the respawned replica's ready line
        out["respawn_s"] = time.monotonic() - t0
        wait_healthy(2, "respawn")
        check(killed in router.endpoints() and
              sup.slot_info()[0]["respawns"] == 1,
              f"fleet supervisor: respawn {sup.slot_info()}")
        # the autoscaler: a sustained backlog scales out once; the
        # cooldown over and the load gone, it scales in
        scaler = Autoscaler(router, sup, min_replicas=2, max_replicas=3,
                            high_load=4.0, low_load=0.5, breach_polls=3,
                            clear_polls=3, out_cooldown_s=1.0,
                            in_cooldown_s=2.0)
        backlog = [{} for _ in range(48)]
        threads = [threading.Thread(
            target=lambda o: o.update(toks=[
                r["token"] for r in router.generate(
                    [5, 6, 7, 8], max_new_tokens=48) if "token" in r]),
            args=(o,), daemon=True) for o in backlog]
        for t in threads:
            t.start()
        actions = []
        t0 = time.monotonic()
        while "out" not in actions and time.monotonic() - t0 < 60:
            router.poll_once()
            actions.append(scaler.tick())
            time.sleep(0.05)
        check("out" in actions, f"fleet autoscaler: no scale-out: "
              f"{actions}")
        for t in threads:
            t.join(timeout=300)
        check(all(len(o.get("toks", [])) == 48 for o in backlog),
              "fleet autoscaler: the backlog's generations")
        out["scale_out_to_ready_s"] = wait_healthy(3, "scale-out")
        t0 = time.monotonic()
        while "in" not in actions and time.monotonic() - t0 < 60:
            router.poll_once()
            actions.append(scaler.tick())
            time.sleep(0.1)
        check("in" in actions and actions.count("out") == 1 and
              sup.replica_count() == 2,
              f"fleet autoscaler: {actions}, {sup.slot_info()}")
        out["autoscale_actions"] = [a for a in actions if a]
        # SIGTERM: the replica leaves, drains and exits 0, unreplaced
        slot = sup.slot_info()[1]
        sup.scale_in(endpoint=slot["endpoint"])
        t0 = time.monotonic()
        while sup.slot_info()[1]["alive"] and time.monotonic() - t0 < 60:
            time.sleep(0.05)
        info = sup.slot_info()[1]
        check(not info["alive"] and info["retired"] and
              info["launches"] == 1 and
              sup._slots[1].proc.returncode == 0,
              f"fleet supervisor: SIGTERM {info}")
        time.sleep(0.5)
        check(sup.slot_info()[1]["launches"] == 1,
              "fleet supervisor: a drained replica was respawned")
        out["slots"] = sup.slot_info()
    finally:
        router.stop()
        sup.stop(grace_s=30.0)
    check(all(not s["alive"] for s in sup.slot_info()),
          "fleet supervisor: a replica outlived stop()")
    return out


def phase_fleet():
    """Phase 26: the multi-tenant serving front and the fleet tier at
    GPT-2-small's full width. Returns the K1-fwd launches of its bf16
    servers."""
    import shutil
    import tempfile

    import torch

    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="chip_smoke_fleet_")
    params, cfg = _gpt2_params()
    parts = {}
    out = {}
    out["decode_qos_f32"], launches = _fleet_decode_qos(params, cfg)
    torch.cuda.empty_cache()
    parts["a_f32"] = time.perf_counter() - t0
    srv, d_reg, out["slots"], bf16 = _fleet_slots_and_swap(params, cfg,
                                                          root)
    parts["a_bf16_b"] = time.perf_counter() - t0 - sum(parts.values())
    out["router"], routed = _fleet_router(params, cfg, srv, d_reg)
    launches += bf16 + routed
    del srv
    torch.cuda.empty_cache()
    parts["c"] = time.perf_counter() - t0 - sum(parts.values())
    out["supervisor"] = _fleet_supervisor(root)
    parts["d"] = time.perf_counter() - t0 - sum(parts.values())
    print(json.dumps({
        "phase": "fleet", "card": card(),
        "model": "GPT-2-small (GPTConfig()), seed 0; LeNet rung saved "
                 "after 20, 40 and 80 Adam steps on the card",
        "policy": FLEET_POLICY, "max_queue": FLEET_QUEUE,
        "burst": dict(FLEET_BURST), "new_tokens": FLEET_NEW,
        "prefill_buckets": list(FLEET_BUCKETS), "prefill_chunk": FLEET_CHUNK,
        "decode_slots": list(FLEET_SLOTS),
        "captures": "every engine is warmed before any request reaches "
                    "its process's servers",
        **out, "launches": {"flash_attention_fwd": launches},
        "part_seconds": parts, "seconds": time.perf_counter() - t0}))
    shutil.rmtree(root, ignore_errors=True)
    return launches



# phase 27: observability on the serving path
OBS_LENGTHS = SLICE_LENGTHS + (9, 42, 200, 640)   # 12 streams, 5-1000
OBS_NEW = 24
OBS_PREDICTS = 150
OBS_CAPTURE_S = 2.0
OBS_TRIES = 3                  # CUPTI may drop records: retry the window
OBS_SLO = {"slos": [
    {"name": "predict-availability", "type": "availability",
     "target": 0.999,
     "errors": {"metric": "paddle_tpu_serving_requests_total",
                "labels": {"outcome": "error"}},
     "total": {"metric": "paddle_tpu_serving_requests_total"}},
    # 5.0 s is a bucket edge of the latency histogram, so a request
    # under it counts wholly good
    {"name": "predict-latency", "type": "latency", "target": 0.99,
     "metric": "paddle_tpu_serving_request_seconds", "threshold_s": 5.0}]}
K1_FWD_SM90 = "flash_fwd_sm90_kernel"
SAMPLED = "00-{:032x}-{:016x}-01"


def _obs_trace_id(rnd, i):
    return 0x27000 + 100 * rnd + i


def _obs_generate(port, ids, out, rnd, i):
    """One streamed /v1/generate for model "gpt" under a sampled trace
    (round `rnd`, stream `i`; its decode.* spans enter the span store):
    `out` gets the tokens."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/generate",
        data=json.dumps({"ids": [int(t) for t in ids], "model": "gpt",
                         "max_new_tokens": OBS_NEW}).encode(),
        headers={"Content-Type": "application/json",
                 "traceparent": SAMPLED.format(_obs_trace_id(rnd, i),
                                               0x27 + i)})
    toks = []
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            for line in r:
                if line.strip():
                    rec = json.loads(line)
                    if "token" in rec:
                        toks.append(rec["token"])
    except Exception as e:  # reported and checked by the caller
        out["error"] = f"{type(e).__name__}: {e}"
    out["tokens"] = toks


def _obs_round(port, prompts, predicts, rnd, during=None):
    """Round `rnd`: the 12 streams and the predict requests at once;
    `during()` runs on this thread while they do. Returns (wall s of
    the streams, `during`'s result)."""
    gens = [{} for _ in prompts]
    threads = [threading.Thread(target=_obs_generate, daemon=True,
                                args=(port, p, out, rnd, i))
               for i, (p, out) in enumerate(zip(prompts, gens))]
    box = {}
    pred = threading.Thread(target=lambda: box.update(
        zip(("replies", "lat", "wall"), _predict_round(port, predicts))),
        daemon=True)
    t0 = time.perf_counter()
    for t in threads + [pred]:
        t.start()
    got = during() if during is not None else None
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    pred.join(timeout=600)
    check(all("error" not in g and len(g["tokens"]) == OBS_NEW
              for g in gens), f"observability: short streams {gens}")
    check(len(box.get("replies") or ()) == len(predicts) and
          all(r is not None for r in box["replies"]),
          "observability: predict requests failed")
    return wall, got


def _obs_trace(path, rnd, n):
    """(K1-fwd Hopper kernel records, kernel records, decode.* spans of
    round `rnd`'s `n` streams) of a merged capture trace."""
    with open(path) as f:
        evs = json.load(f)["traceEvents"]
    kernels = [e for e in evs if e.get("cat") == "kernel"]
    ids = {f"{_obs_trace_id(rnd, i):032x}" for i in range(n)}
    return (sum(1 for e in kernels if K1_FWD_SM90 in e.get("name", "")),
            len(kernels),
            sum(1 for e in evs if e.get("cat") == "decode" and
                str(e.get("name", "")).startswith("decode.") and
                (e.get("args") or {}).get("trace_id") in ids))


def _obs_capture(port, prompts, predicts, rnd):
    """Traffic round `rnd` started inside a POST /v1/profile window of
    OBS_CAPTURE_S, a second POST in the window answering 409. Returns
    the capture's reply, the streams' wall s and the K1-fwd launches
    between the window's start and its close."""
    from paddle_tpu_torch import profiler
    from paddle_tpu_torch.kernels import flash_attention as fa

    box = {}
    cap = threading.Thread(target=lambda: box.update(zip(
        ("code", "body", "hdrs"), _post_json(
            port, "/v1/profile", {"seconds": OBS_CAPTURE_S}))),
        daemon=True)
    cap.start()
    deadline = time.monotonic() + 30
    while profiler._prof is None and time.monotonic() < deadline:
        time.sleep(0.005)
    check(profiler._prof is not None, "observability: no capture started")
    k0 = fa.flash_attention.launches

    def in_window():
        """The second POST, then the K1-fwd launches until the window
        closes (the capture drops its trace handle there)."""
        busy = _post_json(port, "/v1/profile", {"seconds": 0.1})[0]
        while profiler._prof is not None and time.monotonic() < closes_by:
            time.sleep(0.002)
        return busy, fa.flash_attention.launches - k0

    closes_by = time.monotonic() + OBS_CAPTURE_S + 30
    wall, (busy, launches) = _obs_round(port, prompts, predicts, rnd,
                                        in_window)
    cap.join(timeout=300)
    check(busy == 409, f"observability: a second capture answered {busy}")
    check(box.get("code") == 200, f"observability: /v1/profile {box}")
    return box["body"], wall, launches


def _obs_memory(port, eng):
    """Gate (b): the /v1/status memory block against the engine's
    tensors, its graph pool and the allocator."""
    import torch

    from paddle_tpu_torch.observability import memwatch

    torch.cuda.synchronize()
    memwatch.sweep(force=True)      # status_block() reads it (1 s limit)
    mem = _get_json(port, "/v1/status")[1]["memory"]
    allocated = torch.cuda.memory_allocated()

    def nbytes(ts):
        return sum(t.untyped_storage().nbytes() for t in
                   {t.untyped_storage().data_ptr(): t for t in ts}.values())

    kv, params = nbytes(eng._pools), nbytes(eng.params.values())
    pool = _graph_pool_bytes(eng._graph_pool)
    owners = mem["owners"]
    held = sum(v for k, v in owners.items()
               if k != "other" and not k.startswith("prefix_cache"))
    check(owners.get("kv_pool[gpt]") == kv and
          owners.get("params[gpt]") == params,
          f"observability: owner rows {owners}, engine kv {kv} params "
          f"{params}")
    check(mem["executable_bytes"] == pool and pool > 0,
          f"observability: executable bytes {mem['executable_bytes']}, "
          f"graph pool {pool}")
    check(held <= mem["total_bytes"] <= allocated,
          f"observability: total {mem['total_bytes']} against owners "
          f"{held} and allocated {allocated}")
    return {"owners": owners, "total_bytes": mem["total_bytes"],
            "executable_bytes": mem["executable_bytes"],
            "allocated_bytes": allocated, "watermark_bytes":
            mem["watermark_bytes"]}


def phase_observability():
    """Phase 27: GPT-2-small bf16 (model "gpt", model_tag "gpt") beside
    the LeNet predict slot behind one Server, with SLOs and the TS
    recorder on: a traffic round without a capture, then one inside a
    POST /v1/profile window (retried up to OBS_TRIES times when the
    trace lacks K1-fwd's kernel records); gates (a) the profile, (b) the
    memory block, (c) /v1/slo and the TS dir, (d) /metrics. Returns the
    K1-fwd launches of its rounds."""
    import shutil
    import tempfile

    import torch

    import paddle_tpu_torch as pt
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.observability import (aggregate, httpd,
                                                perfwatch, telemetry,
                                                timeseries, tracing)
    from paddle_tpu_torch.serving import (DecodeConfig, DecodeEngine,
                                          Server, ServingConfig)
    from paddle_tpu_torch.serving import engine as eng_mod

    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="chip_smoke_obs_")
    ts_dir = os.path.join(root, "ts")
    env = {"PADDLE_TPU_TS_DIR": ts_dir, "PADDLE_TPU_TS_INTERVAL_S": "0.5",
           "PADDLE_TPU_SLO_INTERVAL_S": "0.5",
           "PADDLE_TPU_PROFILE_DIR": os.path.join(root, "profiles")}
    saved_env = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    (model_dir,), _ = _lenet_saved(pt, root, saves=(20,))
    params, cfg = _gpt2_params()
    eng = DecodeEngine(params, cfg, DecodeConfig(
        block_size=16, num_blocks=512, decode_slots=(4, 8),
        model_tag="gpt"), device="cuda")
    rs = np.random.RandomState(27)
    prompts = [rs.randint(0, cfg.vocab_size, size=n) for n in OBS_LENGTHS]
    pool, _ = synthetic_mnist(1024, seed=27)
    sizes = rs.randint(1, 9, OBS_PREDICTS)
    starts = rs.randint(0, len(pool) - 8, OBS_PREDICTS)
    predicts = [pool[a:a + n] for a, n in zip(starts, sizes)]
    perfwatch.reset()
    tracing.clear_spans()            # the capture exports this phase's
    srv = Server(ServingConfig(model_dir, model_id="lenet",
                               slo_spec=OBS_SLO), decode={"gpt": eng})
    port = srv.start(0)
    mport = httpd.start_http_server(0)
    out = {}
    try:
        steps0 = telemetry.EXEC_STEPS.value(mode="infer")
        batches0 = sum(eng_mod.BATCHES.value(bucket=str(b))
                       for b in srv.engine.policy.buckets)
        k0 = fa.flash_attention.launches
        wall, _ = _obs_round(port, prompts, predicts, 0)
        plain = [OBS_NEW * len(prompts) / wall]
        tries = []
        for rnd in range(1, OBS_TRIES + 1):
            reply, wall, n = _obs_capture(port, prompts, predicts, rnd)
            k1, kernels, spans = _obs_trace(reply["trace"], rnd,
                                            len(prompts))
            tries.append({"k1_fwd_records": k1, "kernel_records": kernels,
                          "decode_spans": spans,
                          "k1_fwd_launches_in_window": n,
                          "tokens_per_s": OBS_NEW * len(prompts) / wall})
            if k1 > 0 and spans > 0 and n > 0:
                break
        out["captures"] = tries
        check(k1 > 0 and spans > 0 and n > 0,
              f"observability (a): no try of {OBS_TRIES} traced K1-fwd's "
              f"kernel and the decode spans in its window: {tries}")
        # the same round once more without a capture: the profiler's
        # cost is the captured round's tokens/s against both plain ones
        wall, _ = _obs_round(port, prompts, predicts, OBS_TRIES + 1)
        plain.append(OBS_NEW * len(prompts) / wall)
        launches = fa.flash_attention.launches - k0
        out["plain_tokens_per_s"] = plain
        with open(reply["perf"]) as f:
            perf = json.load(f)
        kind = torch.cuda.get_device_name(0)
        for phase in ("prefill", "decode"):
            st = perf["perfwatch"].get(phase, {})
            check(st.get("device_kind") == kind and 0 < st["mfu"] < 1 and
                  st["tokens_per_sec_per_chip"] > 0,
                  f"observability (a): perf.json {phase} {st}")
        check(set(perf["memory"]["owners"]) >= {"kv_pool[gpt]",
                                                "params[gpt]"},
              f"observability (a): perf.json memory {perf['memory']}")
        out["perfwatch"] = perf["perfwatch"]
        out["captured_tokens_per_s"] = tries[-1]["tokens_per_s"]
        out["memory"] = _obs_memory(port, eng)
        code, slo_rows, _ = _get_json(mport, "/v1/slo")
        rows = slo_rows.get("slos", [])
        check(code == 200 and sorted(r["name"] for r in rows) ==
              ["predict-availability", "predict-latency"] and
              all(w["burn_short"] == 0 and w["burn_long"] == 0
                  for r in rows for w in r["windows"]),
              f"observability (c): /v1/slo {code} {slo_rows}")
        with urllib.request.urlopen(f"http://127.0.0.1:{mport}/metrics",
                                    timeout=60) as r:
            prom = r.read().decode()
        check('paddle_tpu_mfu{kind="decode"}' in prom and
              'paddle_tpu_hbm_bytes{owner="kv_pool[gpt]"}' in prom,
              "observability (d): /metrics lacks the MFU or the KV row")
        steps = telemetry.EXEC_STEPS.value(mode="infer") - steps0
        batches = sum(eng_mod.BATCHES.value(bucket=str(b))
                      for b in srv.engine.policy.buckets) - batches0
        check(steps >= batches > 0, f"observability (d): {steps} executor "
              f"steps for {batches} predict batches")
        out.update(executor_steps=steps, predict_batches=batches)
    finally:
        httpd.stop_http_server()
        srv.stop()
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        # the recorder's final sample. The LeNet's training steps started
        # it (the executor's telemetry starts it once the env names a
        # dir), so the Server found it running and left it to its starter
        timeseries.stop_recorder()
    served = (len(tries) + 2) * OBS_PREDICTS
    increase = aggregate.TSStore(aggregate.read_ts_dir(ts_dir)).increase(
        "paddle_tpu_serving_requests_total", 1e9)
    check(increase == served, f"observability (c): the TS dir's increase "
          f"{increase} for {served} predict requests")
    out["ts_increase"] = increase
    print(json.dumps({
        "phase": "observability", "card": card(),
        "model": "GPT-2-small (GPTConfig()), seed 0, bf16, model_tag gpt; "
                 "LeNet rung saved after 20 Adam steps on the card",
        "streams": len(prompts), "new_tokens": OBS_NEW,
        "predicts_per_round": OBS_PREDICTS, "capture_s": OBS_CAPTURE_S,
        "slo": OBS_SLO, **out,
        "profiler_cost": 1 - out["captured_tokens_per_s"] /
        statistics.mean(out["plain_tokens_per_s"]),
        "launches": {"flash_attention_fwd": launches},
        "seconds": time.perf_counter() - t0}))
    del eng, srv
    torch.cuda.empty_cache()
    shutil.rmtree(root, ignore_errors=True)
    return launches


# Phase 28: the fluid path's data parallelism on the card, f32 with TF32
# off: bench.py's LeNet rung at FLUID_B split over FLUID_DP_RANKS
# in-process ranks (the ranks share the card, so this measures the
# split's own cost, not a scaling).
FLUID_DP_RANKS = 4
FLUID_DP_TIMED = 10
FLUID_DP_FLEET_STEPS = 20
# (e) rule (d): a program of ops that only the gather rule takes, at
# batch x width f32 on 2 and 4 ranks against one rank: the loss and
# every gradient within GATHER_TOL of each tensor's largest value
GATHER_B, GATHER_W = 256, 1024
GATHER_RANKS = (2, 4)
GATHER_TOL = 1e-6
GATHER_OPS = ("softmax", "transpose2", "concat", "kron", "top_k_v2",
              "kldiv_loss")


def gather_rule_program(pt, B=GATHER_B, W=GATHER_W):
    """x [B, W] through three fcs (64, 4 and 64 wide), then GATHER_OPS
    across the batch: a softmax over dim 0, its transpose and its
    concat with h along dim 0, kron of the 4-wide fc with a [2, 2]
    param, top_k_v2 over dim 0 and a reducing kldiv_loss; the loss sums
    the mean squares of an fc to one column of each (the softmax over
    dim 0 sees h squared: it would not see h's bias, a shift of each
    column), the top-k's mean and the KL term. SGD 0.1. Returns (main,
    startup, loss)."""
    main, startup = pt.Program(), pt.Program()
    main.random_seed = startup.random_seed = 28
    L = pt.layers
    with pt.framework.unique_name.guard(), pt.program_guard(main, startup):
        blk = main.global_block()
        x = L.data(name="x", shape=[B, W], dtype="float32",
                   append_batch_size=False)
        h = L.fc(x, size=64)
        p = L.softmax(L.square(h), axis=0)
        t = L.transpose(p, perm=[1, 0])
        c = L.concat([p, h], axis=0)
        kron = blk.create_var(name="kron_out", dtype="float32")
        blk.append_op(type="kron", inputs={
            "X": [L.fc(x, size=4)],
            "Y": [L.create_parameter([2, 2], "float32", name="kron_w")]},
            outputs={"Out": [kron]})
        top = blk.create_var(name="top_out", dtype="float32")
        blk.append_op(type="top_k_v2", inputs={"X": [h]},
                      outputs={"Out": [top], "Indices": [blk.create_var(
                          name="top_idx", dtype="int64")]},
                      attrs={"k": 8, "axis": 0})
        kl = L.kldiv_loss(L.log_softmax(h), L.softmax(L.fc(x, size=64)),
                          reduction="mean")
        loss = L.mean(top)
        for v in (t, c, kron):
            loss = L.elementwise_add(loss, L.mean(L.square(L.fc(v, 1))))
        loss = L.elementwise_add(loss, kl)
        pt.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return main, startup, loss


def _fluid_gather(pt, exe, place):
    """(e) `gather_rule_program` through CompiledProgram on each of
    GATHER_RANKS against one rank from the same state: the loss and
    every gradient within GATHER_TOL of each tensor's largest value,
    every op of GATHER_OPS taken by rule (d); then each's step ms."""
    from paddle_tpu_torch.core import lockstep

    main, startup, loss = gather_rule_program(pt)
    # kldiv_loss's target takes no gradient: its fc's params have none
    params = [p.name for p in main.all_parameters()
              if main.global_block().has_var(p.name + "@GRAD")]
    fetch = [loss] + [n + "@GRAD" for n in params]
    rng = np.random.RandomState(28)
    feed = {"x": rng.standard_normal((GATHER_B, GATHER_W))
            .astype("float32")}
    scope = pt.Scope()
    exe.run(startup, scope=scope)
    want = exe.run(main, feed=feed, fetch_list=fetch,
                   scope=_scope_copy(pt, scope))
    one_scope = _scope_copy(pt, scope)
    out = {"batch": GATHER_B, "width": GATHER_W, "limit": GATHER_TOL,
           "step_ms": {"one_rank": _fluid_dp_ms(lambda: exe.run(
               main, feed=feed, fetch_list=[loss], scope=one_scope))}}
    real = lockstep.Lockstep._gather
    for n in GATHER_RANKS:
        prog = pt.CompiledProgram(main).with_data_parallel(
            loss_name=loss.name, places=[place] * n)
        gathered = []

        def spy(self, op, envs, block, first_grad):
            gathered.append(op.type)
            return real(self, op, envs, block, first_grad)

        lockstep.Lockstep._gather = spy
        try:
            got = exe.run(prog, feed=feed, fetch_list=fetch,
                          scope=_scope_copy(pt, scope))
        finally:
            lockstep.Lockstep._gather = real
        worst = max(float(np.abs(a - b).max() / np.abs(b).max())
                    for a, b in zip(got, want))
        missed = sorted(set(GATHER_OPS) - set(gathered))
        check(worst <= GATHER_TOL and not missed,
              f"fluid dp (e) on {n} ranks: worst error {worst} of the "
              f"largest value (limit {GATHER_TOL}); not gathered {missed}")
        out[f"{n}_ranks"] = {"worst": worst, "gathered": sorted(
            set(gathered))}
        split_scope = _scope_copy(pt, scope)
        out["step_ms"][f"compiled_{n}_ranks"] = _fluid_dp_ms(
            lambda: exe.run(prog, feed=feed, fetch_list=[loss],
                            scope=split_scope))
    return out


def _fluid_dp_parity(pt, label, run_split, feed, main, startup, loss,
                     limits=FLUID_TOL):
    """3 Adam steps of `run_split(scope, fetch_list)` against the one-rank
    `Executor.run` from a copy of the same scope, each step from the
    one-rank state: the loss, every parameter gradient and the updated
    params within `limits` (beyond `fluid_adam_slack` for a param)."""
    exe = pt.Executor(pt.CUDAPlace(0))
    one = pt.Scope()
    exe.run(startup, scope=one)
    params = [p.name for p in main.all_parameters()]
    grads = [n + "@GRAD" for n in params]
    worst = {"loss": 0.0, "grad": 0.0, "param": 0.0}
    for _ in range(3):
        split = _scope_copy(pt, one)
        got = run_split(split, [loss] + grads)
        want = exe.run(main, feed=feed, fetch_list=[loss] + grads, scope=one)
        worst["loss"] = max(worst["loss"], float(
            abs(got[0][0] - want[0][0]) / abs(want[0][0])))
        for n, a, b in zip(params, got[1:], want[1:]):
            # an SPMD fetch joins the ranks' copies of a replicated grad
            a = a[:b.shape[0]]
            worst["grad"] = max(worst["grad"], float(
                np.abs(a - b).max() / np.abs(b).max()))
            w = one.get(n)
            err = np.abs(split.get(n) - w) - fluid_adam_slack(2e-3, a, b)
            worst["param"] = max(worst["param"], float(
                err.max() / max(1.0, np.abs(w).max())))
    for key, lim in limits.items():
        check(worst[key] <= lim, f"fluid dp ({label}): the split step's "
              f"{key} differs from one rank's by {worst[key]} (limit {lim})")
    return worst


def _fluid_dp_ms(run, steps=FLUID_DP_TIMED):
    import torch

    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        out = run()
    float(out[0][0])                    # the last loss read back
    return (time.perf_counter() - t0) * 1e3 / steps


def phase_fluid_dp():
    """Phase 28: (a) CompiledProgram.with_data_parallel on 4 in-process
    ranks of the card, (b) the GradAllReduce-transpiled program under
    SPMDRunner, each against one rank; (c) the fleet facade with
    LocalSGD(k_steps=2); (e) rule (d), the gather, on 2 and 4 ranks
    against one (`_fluid_gather`); (d) step ms at 1 and 4 ranks, one
    traced step's idle share, the spmd telemetry and perfwatch rows."""
    import torch

    import paddle_tpu_torch as pt
    from paddle_tpu_torch import parallel as par
    from paddle_tpu_torch.observability import perfwatch, telemetry
    from paddle_tpu_torch.parallel.collective import GradAllReduce
    from paddle_tpu_torch.parallel.fleet import Fleet

    t0 = time.perf_counter()
    rng = np.random.RandomState(0)
    feed = {"x": rng.rand(FLUID_B, 1, 28, 28).astype("float32"),
            "y": rng.randint(0, 10, (FLUID_B, 1)).astype("int64")}
    cuda = pt.CUDAPlace(0)
    exe = pt.Executor(cuda)
    mesh = par.make_mesh(par.MeshConfig(dp=FLUID_DP_RANKS),
                         devices=[cuda.torch_device()] * FLUID_DP_RANKS)
    sharded0 = telemetry.EXEC_STEPS.value(mode="sharded")
    spmd0 = telemetry.SPMD_STEPS.value(axis="dp")
    out = {}

    # (a) CompiledProgram on 4 ranks
    main, startup, loss = lenet_rung_program(pt)
    prog = pt.CompiledProgram(main).with_data_parallel(
        loss_name=loss.name, places=[cuda] * FLUID_DP_RANKS)
    out["compiled_vs_one_rank_worst"] = _fluid_dp_parity(
        pt, "a", lambda s, f: exe.run(prog, feed=feed, fetch_list=f,
                                      scope=s), feed, main, startup, loss)
    step = next(iter(prog._cache.values()))
    check(step.ring.size == FLUID_DP_RANKS and
          step.rank_feed_shapes["x"] == (FLUID_B // FLUID_DP_RANKS, 1, 28,
                                         28),
          f"fluid dp (a): ranks {step.ring.size}, per-rank feed "
          f"{step.rank_feed_shapes}")
    out["rank_feed_shapes"] = step.rank_feed_shapes

    # (b) GradAllReduce under SPMDRunner
    gmain, gstart, gloss = lenet_rung_program(pt)
    n_params = len(gmain.all_parameters())
    with pt.framework.unique_name.guard(), pt.program_guard(gmain, gstart):
        GradAllReduce(nranks=FLUID_DP_RANKS).transpile(gmain, gstart)
    runner = par.SPMDRunner(gmain, mesh)
    # against the untranspiled program: a plain Executor has no ranks
    # for the c_allreduce_sums
    out["spmd_vs_one_rank_worst"] = _fluid_dp_parity(
        pt, "b", lambda s, f: runner.run(exe, feed=feed, fetch_list=f,
                                         scope=s), feed, main, startup, loss)
    rstep = next(iter(runner._cache.values()))
    launches = rstep.launches["c_allreduce_sum"] / 3
    check(launches == n_params, f"fluid dp (b): {launches} c_allreduce_sum "
          f"a step for {n_params} trainable params")
    out["c_allreduce_sum_a_step"] = launches

    # (c) the fleet facade, LocalSGD every 2 steps
    fl = Fleet()
    fl.init(par.UserDefinedRoleMaker(current_id=0, worker_num=1))
    strategy = par.DistributedStrategy(
        data_parallel_degree=FLUID_DP_RANKS, use_graph_collectives=True,
        use_local_sgd=True, local_sgd_steps=2)
    # the rung's builder, unchanged, on `pt` with its Adam minimizing
    # through the fleet's distributed optimizer
    fpt = types.SimpleNamespace(**vars(pt))
    fpt.optimizer = types.SimpleNamespace(
        Adam=lambda **kw: fl.distributed_optimizer(pt.optimizer.Adam(**kw),
                                                   strategy))
    fmain, fstart, floss = lenet_rung_program(fpt)
    check(sum(op.type == "cond" for op in fmain.desc.block(0).ops) == 1,
          "fluid dp (c): LocalSGD(k_steps=2) emitted no cond gate")
    fparams = [p.name for p in fmain.all_parameters()]
    frunner = par.SPMDRunner(fmain, fl.mesh())        # its ranks on cuda
    fscope = pt.Scope()
    exe.run(fstart, scope=fscope)
    flosses, diverged = [], []
    for i in range(FLUID_DP_FLEET_STEPS):
        flosses.append(float(frunner.run(exe, feed=feed, fetch_list=[floss],
                                         scope=fscope)[0][0]))
        # the params the ranks hold apart after this step: all of them
        # after a local step (odd), none after an averaging one (even)
        ranked = frunner._ranked.get(fscope, {})
        diverged.append(sum(n in ranked for n in fparams))
    check(diverged == [len(fparams), 0] * (FLUID_DP_FLEET_STEPS // 2),
          f"fluid dp (c): params held apart by the ranks after each step "
          f"{diverged}, not all after odd steps and none after even ones")
    check(all(np.isfinite(flosses)) and
          np.mean(flosses[-3:]) < flosses[0],
          f"fluid dp (c): the fleet's LocalSGD loss did not fall: "
          f"{flosses[0]} -> {flosses[-3:]}")
    fstep = next(iter(frunner._cache.values()))
    want = len(fparams) * (FLUID_DP_FLEET_STEPS // 2)
    check(fstep.launches["c_allreduce_sum"] == want,
          f"fluid dp (c): {fstep.launches['c_allreduce_sum']} "
          f"c_allreduce_sum in {FLUID_DP_FLEET_STEPS} steps, not {want} "
          f"(every param on every second step)")
    out["fleet_local_sgd"] = {
        "loss_first": flosses[0], "loss_last": flosses[-1],
        "steps": FLUID_DP_FLEET_STEPS, "params_apart": diverged,
        "c_allreduce_sum": fstep.launches["c_allreduce_sum"]}

    # (e) rule (d): the ops no cheaper rule takes, gathered
    out["gather_rule"] = _fluid_gather(pt, exe, cuda)

    # (d) step ms: one rank, CompiledProgram and SPMDRunner at 4 ranks
    scope = pt.Scope()
    exe.run(startup, scope=scope)
    s1, s4, sg = (_scope_copy(pt, scope) for _ in range(3))
    one = lambda: exe.run(main, feed=feed, fetch_list=[loss],  # noqa: E731
                          scope=s1)
    split = lambda: exe.run(prog, feed=feed, fetch_list=[loss],  # noqa: E731
                            scope=s4)
    spmd = lambda: runner.run(exe, feed=feed,  # noqa: E731
                              fetch_list=[gloss], scope=sg)
    out["step_ms"] = {"one_rank": _fluid_dp_ms(one),
                      "compiled_4_ranks": _fluid_dp_ms(split),
                      "spmd_4_ranks": _fluid_dp_ms(spmd)}
    out["traced_step"] = {}
    for name, run in (("one_rank", one), ("compiled_4_ranks", split),
                      ("spmd_4_ranks", spmd)):
        traced = _profiled_step(run)
        out["traced_step"][name] = {k: traced[k] for k in (
            "wall_ms", "device_busy_ms", "device_idle_share",
            "device_events")}
    sharded = telemetry.EXEC_STEPS.value(mode="sharded") - sharded0
    spmd_steps = telemetry.SPMD_STEPS.value(axis="dp") - spmd0
    coll = telemetry.SPMD_COLLECTIVES.value(axis="dp", op="c_allreduce_sum")
    watch = perfwatch.snapshot().get("spmd", {})
    check(sharded > 0 and spmd_steps > 0 and coll > 0 and
          watch.get("device_kind") == torch.cuda.get_device_name(0) and
          watch.get("steps", 0) > 0,
          f"fluid dp (d): telemetry rows sharded {sharded}, spmd "
          f"{spmd_steps}, collectives {coll}, perfwatch {watch}")
    out["telemetry"] = {"executor_steps_sharded": sharded,
                        "spmd_steps": spmd_steps,
                        "spmd_collectives_c_allreduce_sum": coll,
                        "perfwatch_spmd": watch}
    print(json.dumps({
        "phase": "fluid_dp", "card": card(),
        "program": "bench.py _build_lenet_program, batch 256, Adam 2e-3, "
                   f"{FLUID_DP_RANKS} in-process ranks on one card",
        **out, "limits": FLUID_TOL, "seconds": time.perf_counter() - t0}))


# Phase 29: the fluid op library's core on the card, f32 with cuDNN's
# TF32 off for the whole phase: the book's VGG-16-BN at full width
# (batch 128 of CIFAR-10 shapes) on one rank and on 2 in-process ranks
# with sync batch norm, and the book's three embedding programs.
VGG_B = 128
VGG_STEPS = 20
VGG_DP_RANKS = 2
VGG_TIMED = 5
# the card against the CPU (and 2 ranks against one) at f32: the loss
# relative; the gradients in `vgg_grad_errors`' two classes, against the
# step's largest; the running stats against their largest values. The
# JAX package's own one-device and 8-device steps differ by up to 2.5e-2
# of the step's largest gradient under a batch norm (channels / 8,
# batch 32; ROADMAP F13); on the card the ReLUs after the last batch
# norm, at their kinks, moved its bias gradient by up to 4.3e-3 of it
VGG_TOL = {"loss": 1e-5, "grad": 1e-2, "grad_under_bn": 5e-2,
           "stats": 1e-5}


def synthetic_cifar(n, seed=0):
    """CIFAR-10 shapes with a learnable signal: class k adds a fixed
    random pattern k to N(0, 1) noise: (images [n, 3, 32, 32] f32,
    labels [n, 1] int64)."""
    patterns = np.random.RandomState(99).standard_normal((10, 3, 32, 32))
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, 10, n)
    img = rng.standard_normal((n, 3, 32, 32)) + patterns[labels]
    return img.astype("float32"), labels.astype("int64").reshape(n, 1)


def _vgg_worst(main, got, want, params, stats, s_got, s_want):
    """The largest relative differences of a VGG step: loss, gradients
    (`vgg_grad_errors`) and running stats."""
    return {
        "loss": float(abs(got[0][0] - want[0][0]) / abs(want[0][0])),
        **vgg_grad_errors(main, params, got[2:], want[2:]),
        "stats": max(float(np.abs(s_got.get(n) - s_want.get(n)).max() /
                           np.abs(s_want.get(n)).max()) for n in stats)}


def _vgg_gate(label, worst):
    for key, lim in VGG_TOL.items():
        check(worst[key] <= lim, f"fluid book ({label}): {key} differs by "
              f"{worst[key]} (limit {lim}): {worst}")


def _vgg_one_rank(pt, exe):
    """Phase 29 (a): the card's first step against the CPU's from one
    scope (drop rates 0), then 20 steps at the book's drop rates, the
    for_test clone once."""
    from paddle_tpu_torch.convert import scope_from_numpy

    cuda, cpu = pt.CUDAPlace(0), pt.CPUPlace()
    main, startup, _, loss, acc = vgg_bn_program(pt, drop=0.0)
    params = [p.name for p in main.all_parameters() if p.trainable]
    stats = bn_stat_names(main)
    fetch = [loss, acc] + [n + "@GRAD" for n in params]
    s0 = pt.Scope()
    exe.run(startup, scope=s0)
    init = {v.name: s0.get(v.name) for v in startup.list_vars()
            if v.persistable}
    img, label = synthetic_cifar(VGG_B, seed=1)
    feed = {"img": img, "label": label}
    sc = scope_from_numpy(pt.Scope(), init, cuda)
    sh = scope_from_numpy(pt.Scope(), init, cpu)
    got = exe.run(main, feed=feed, fetch_list=fetch, scope=sc)
    want = pt.Executor(cpu).run(main, feed=feed, fetch_list=fetch, scope=sh)
    worst = _vgg_worst(main, got, want, params, stats, sc, sh)
    _vgg_gate("a, card vs CPU", worst)

    main, startup, test_prog, loss, acc = vgg_bn_program(pt)
    scope = pt.Scope()
    exe.run(startup, scope=scope)
    img, label = synthetic_cifar(VGG_B * VGG_STEPS, seed=2)
    losses, ms = [], []
    for i in range(VGG_STEPS):
        b = slice(i * VGG_B, (i + 1) * VGG_B)
        t0 = time.perf_counter()
        out = exe.run(main, feed={"img": img[b], "label": label[b]},
                      fetch_list=[loss], scope=scope)
        losses.append(float(out[0][0]))        # read back: the step's end
        ms.append((time.perf_counter() - t0) * 1e3)
    check(all(np.isfinite(losses)) and
          np.mean(losses[-5:]) < np.mean(losses[:5]),
          f"fluid book (a): VGG-16-BN's loss did not fall: {losses}")
    traced = _profiled_step(lambda: exe.run(
        main, feed={"img": img[:VGG_B], "label": label[:VGG_B]},
        fetch_list=[loss], scope=scope))
    before = {n: scope.get(n) for n in bn_stat_names(main)}
    predict = next(op.inputs["X"][0] for op in test_prog.desc.block(0).ops
                   if op.type == "cross_entropy")
    probs = exe.run(test_prog, feed={"img": img[:VGG_B],
                                     "label": label[:VGG_B]},
                    fetch_list=[predict], scope=scope)[0]
    check(probs.shape == (VGG_B, 10) and np.isfinite(probs).all() and
          np.allclose(probs.sum(1), 1.0, atol=1e-4),
          f"fluid book (a): the for_test clone's predictions {probs.shape}")
    moved = [n for n, v in before.items()
             if not np.array_equal(scope.get(n), v)]
    check(not moved, f"fluid book (a): the for_test clone moved {moved}")
    return {"card_vs_cpu_worst": worst, "losses": losses,
            "step_ms_median": statistics.median(ms[2:]),
            "step_ms": ms, "ops_a_step": len(main.desc.block(0).ops),
            "for_test_ops": len(test_prog.desc.block(0).ops),
            "traced_step": {k: traced[k] for k in (
                "wall_ms", "device_busy_ms", "device_idle_share",
                "device_events")},
            "top_kernels": traced["top_kernels"][:6]}


def _vgg_two_ranks(pt, exe):
    """Phase 29 (b): the drop-0 program under with_data_parallel on 2
    in-process ranks against one rank's whole-batch step, 2 steps each
    from the one rank's state; the ranks' running stats one tensor."""
    from paddle_tpu_torch.core import lockstep

    cuda = pt.CUDAPlace(0)
    main, startup, _, loss, acc = vgg_bn_program(pt, drop=0.0)
    params = [p.name for p in main.all_parameters() if p.trainable]
    stats = bn_stat_names(main)
    fetch = [loss, acc] + [n + "@GRAD" for n in params]
    prog = pt.CompiledProgram(main).with_data_parallel(
        loss_name=loss.name, places=[cuda] * VGG_DP_RANKS)
    one = pt.Scope()
    exe.run(startup, scope=one)
    img, label = synthetic_cifar(VGG_B, seed=3)
    feed = {"img": img, "label": label}
    seen, run_ranks = [], lockstep.RankStep.run_ranks

    def spy(self, envs, seeds, device):
        out = run_ranks(self, envs, seeds, device)
        seen.append(out)
        return out

    worst, steps = dict.fromkeys(VGG_TOL, 0.0), []
    lockstep.RankStep.run_ranks = spy
    try:
        for _ in range(2):
            split = _scope_copy(pt, one)
            got = exe.run(prog, feed=feed, fetch_list=fetch, scope=split)
            want = exe.run(main, feed=feed, fetch_list=fetch, scope=one)
            steps.append(_vgg_worst(main, got, want, params, stats, split,
                                    one))
            worst = {k: max(worst[k], steps[-1][k]) for k in VGG_TOL}
    finally:
        lockstep.RankStep.run_ranks = run_ranks
    _vgg_gate("b, 2 ranks vs one", worst)
    envs, split_names = seen[-1]
    shared = all(n not in split_names and envs[1][n] is envs[0][n]
                 for n in stats)
    check(len(envs) == VGG_DP_RANKS and shared,
          "fluid book (b): the ranks hold different running stats")
    scope = _scope_copy(pt, one)
    ms = []
    for _ in range(VGG_TIMED):
        t0 = time.perf_counter()
        float(exe.run(prog, feed=feed, fetch_list=[loss], scope=scope)[0][0])
        ms.append((time.perf_counter() - t0) * 1e3)
    return {"two_ranks_vs_one_worst": worst, "two_ranks_vs_one": steps,
            "two_ranks_share_bn_stats": shared,
            "two_ranks_step_ms": ms}


def _book_embedding(pt, exe):
    """Phase 29 (c): the book's three embedding programs train on the
    card as tests/test_book.py requires of the JAX package."""
    out = {}
    feeds = book_embedding_feeds()
    for name, build in BOOK_EMBEDDING.items():
        main, startup, loss = build(pt)
        feed, steps, share = feeds[name]
        scope = pt.Scope()
        exe.run(startup, scope=scope)
        losses = [float(exe.run(main, feed=feed, fetch_list=[loss],
                                scope=scope)[0].reshape(()))
                  for _ in range(steps)]
        check(losses[-1] < losses[0] * share,
              f"fluid book (c): {name}'s loss {losses[0]} -> {losses[-1]} "
              f"(must fall under {share} of the first)")
        out[name] = {"loss_first": losses[0], "loss_last": losses[-1],
                     "steps": steps,
                     "ops_a_step": len(main.desc.block(0).ops)}
    return out


def phase_fluid_book():
    """Phase 29: (a) VGG-16-BN on one rank, (b) on 2 ranks with sync
    batch norm, (c) the book's embedding programs."""
    import torch

    import paddle_tpu_torch as pt

    t0 = time.perf_counter()
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        exe = pt.Executor(pt.CUDAPlace(0))
        one = _vgg_one_rank(pt, exe)
        two = _vgg_two_ranks(pt, exe)
        book = _book_embedding(pt, exe)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags
    print(json.dumps({
        "phase": "fluid_book", "card": card(),
        "program": "book vgg_bn_drop (VGG-16-BN), CIFAR-10 shapes, batch "
                   f"{VGG_B}, Adam 1e-3, f32, TF32 off",
        **one, **two, "book_embedding": book, "limits": VGG_TOL,
        "seconds": time.perf_counter() - t0}))
    torch.cuda.empty_cache()


# Phase 30: the fluid trainer's front end on the card, f32 with TF32 off
# and cuDNN held to its deterministic algorithms (so that one step run
# twice gives the same bits): (a) the book's VGG-16-BN fed by a
# DataLoader through DevicePrefetcher into `train_from_dataset`'s
# `run_stream` windows, against per-step `Executor.run`; (b) every
# optimizer op on bench.py's LeNet rung; (c) SelectedRows gradients of
# a CTR table; (d) `amp.decorate` on VGG-16-BN; (e) the fleet's
# optimizer rewrites on 2 in-process ranks.
TRAINER_STEPS = 24
TRAINER_WINDOW = 8
TRAINER_PREEMPT_AT = 13    # a request inside the second window (8-15)
OPT_STEPS = 5
# (b) each step's optimizer ops on the card against the same ops run on
# the CPU from the same state and the card's gradients: every written
# persistable within OPT_TOL of max(1, its largest value); the loss and
# gradients against the CPU's step at FLUID_TOL
OPT_TOL = 1e-5
CTR_V, CTR_D, CTR_B = 100000, 16, 512    # BENCH_CTR.json's downpour_ctr
CTR_STEPS = 6
CTR_ZIPF = 1.3
AMP_STEPS = 16
AMP_SCALE_STEPS = 3
AMP_F16_SCALE = 8.0
# (e) under use_amp (mixed_bf16) the ranks' weight gradients are bf16
# products over their own rows, summed: the loss and the updated params
# within two bf16 ulps (2**-7) of the largest value, the gradients
# within four (a CPU run at batch 32 read 7.7e-3 of the largest)
AMP_DP_TOL = {"loss": 2.0 ** -7, "grad": 2.0 ** -6, "param": 2.0 ** -7}


def _persist_state(scope, main):
    """{name: host array} of every persistable of `main` in `scope`,
    with the scope's RNG state."""
    from paddle_tpu_torch.core.executor import RNG_STATE_VAR

    out = {v.name: scope.get(v.name) for v in main.list_vars()
           if v.persistable and scope.find_var(v.name) is not None}
    out[RNG_STATE_VAR] = scope.find_var(RNG_STATE_VAR)
    return out


def _state_equal(label, got, want):
    """`got` equals `want` bit for bit, name by name."""
    check(got.keys() == want.keys(),
          f"fluid trainer ({label}): state names differ: "
          f"{sorted(set(got) ^ set(want))}")
    bad = [n for n in want if not np.array_equal(got[n], want[n])]
    check(not bad, f"fluid trainer ({label}): {len(bad)} of {len(want)} "
          f"states differ from per-step run's, e.g. {bad[:4]}")


def _vgg_loader(pt, main, batches, cuda):
    """A DataLoader over `batches` with the double buffer to the card."""
    loader = pt.DataLoader.from_generator(
        feed_list=[main.global_block().var("img"),
                   main.global_block().var("label")],
        capacity=TRAINER_WINDOW, use_double_buffer=True)
    loader.set_batch_generator(
        lambda: iter([(f["img"], f["label"]) for f in batches]),
        places=cuda)
    return loader


def _trainer_stream(pt, exe):
    """Phase 30 (a)."""
    import torch

    from paddle_tpu_torch.convert import scope_from_numpy
    from paddle_tpu_torch.observability import telemetry
    from paddle_tpu_torch.resilience import preemption

    cuda = pt.CUDAPlace(0)
    main, startup, _, loss, _ = vgg_bn_program(pt)
    main.random_seed = 7        # the dropout masks' stream
    s0 = pt.Scope()
    exe.run(startup, scope=s0)
    init = {v.name: s0.get(v.name) for v in startup.list_vars()
            if v.persistable}
    img, label = synthetic_cifar(VGG_B * TRAINER_STEPS, seed=3)
    batches = [{"img": img[i * VGG_B:(i + 1) * VGG_B],
                "label": label[i * VGG_B:(i + 1) * VGG_B]}
               for i in range(TRAINER_STEPS)]
    fresh = lambda: scope_from_numpy(pt.Scope(), init, cuda)  # noqa: E731

    # the reference: one Executor.run a step, each loss read back; its
    # time from step 2 on (the first prepares the step and cuDNN)
    ref = fresh()
    ref_losses, at_stop = [], None
    for i, f in enumerate(batches):
        if i == 1:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        ref_losses.append(exe.run(main, feed=f, fetch_list=[loss],
                                  scope=ref)[0])
        if i + 1 == TRAINER_PREEMPT_AT:
            at_stop = _persist_state(ref, main)
    per_step_ms = (time.perf_counter() - t0) * 1e3 / (TRAINER_STEPS - 1)
    want = _persist_state(ref, main)

    # run_stream over the loader: the fetched losses too
    blocked0 = telemetry.HOST_BLOCKED_SECONDS.value(site="prefetch:device")
    items0 = telemetry.PREFETCH_ITEMS.value(stage="device")
    s1 = fresh()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    handles = list(exe.run_stream(main, _vgg_loader(pt, main, batches, cuda),
                                  fetch_list=[loss], window=TRAINER_WINDOW,
                                  scope=s1))
    losses = np.concatenate([h.result()[0].reshape(-1) for h in handles])
    stream_ms = (time.perf_counter() - t0) * 1e3 / TRAINER_STEPS
    blocked = telemetry.HOST_BLOCKED_SECONDS.value(
        site="prefetch:device") - blocked0
    check([h.n_steps for h in handles] == [TRAINER_WINDOW] * (
        TRAINER_STEPS // TRAINER_WINDOW),
        f"fluid trainer (a): windows {[h.n_steps for h in handles]}")
    check(np.array_equal(losses, np.concatenate(ref_losses).reshape(-1)),
          f"fluid trainer (a): streamed losses {losses[:4]} differ from "
          f"per-step {ref_losses[:4]}")
    _state_equal("a, run_stream", _persist_state(s1, main), want)
    check(telemetry.PREFETCH_ITEMS.value(stage="device") - items0
          == TRAINER_STEPS, "fluid trainer (a): the device prefetch stage "
          "did not pass every batch")

    # train_from_dataset at the default window, then at window 1
    out = {}
    for window in (str(TRAINER_WINDOW), "1"):
        os.environ["PADDLE_TPU_STREAM_WINDOW"] = window
        try:
            s = fresh()
            exe.train_from_dataset(main, _vgg_loader(pt, main, batches,
                                                     cuda),
                                   fetch_list=[loss], scope=s)
        finally:
            del os.environ["PADDLE_TPU_STREAM_WINDOW"]
        _state_equal(f"a, train_from_dataset window {window}",
                     _persist_state(s, main), want)
        out[f"window_{window}"] = "equal"

    # a preemption requested as step TRAINER_PREEMPT_AT's batch arrives:
    # the window is cut there and flushed
    def preempting():
        for i, f in enumerate(_vgg_loader(pt, main, batches, cuda)()):
            if i == TRAINER_PREEMPT_AT:
                preemption.request_stop("phase 30")
            yield f

    src = preempting()
    s = fresh()
    try:
        exe.train_from_dataset(main, src, fetch_list=[loss], scope=s)
    finally:
        src.close()             # joins the loader's threads
        preemption.reset()
    _state_equal("a, preempted", _persist_state(s, main), at_stop)

    # one window streamed and the same 8 steps run one by one, traced
    win = batches[:TRAINER_WINDOW]
    sa, sb = fresh(), fresh()
    traced_stream = _profiled_step(lambda: [h.result() for h in exe.run_stream(
        main, _vgg_loader(pt, main, win, cuda), fetch_list=[loss],
        window=TRAINER_WINDOW, scope=sa)])
    traced_steps = _profiled_step(lambda: [exe.run(
        main, feed=f, fetch_list=[loss], scope=sb) for f in win])
    keys = ("wall_ms", "device_busy_ms", "device_idle_share",
            "device_events")
    return {"steps": TRAINER_STEPS, "window": TRAINER_WINDOW,
            "losses_first_last": [float(losses[0]), float(losses[-1])],
            "stream_step_ms": stream_ms, "per_step_ms": per_step_ms,
            "prefetch_device_blocked_s": blocked,
            "train_from_dataset": out,
            "preempted_at_step": TRAINER_PREEMPT_AT,
            "traced_window_streamed": {k: traced_stream[k] for k in keys},
            "traced_window_per_step": {k: traced_steps[k] for k in keys}}


def _opt_maker(pt, name):
    """A factory of the optimizer `name` for bench.py's LeNet rung,
    whose `lenet_rung_program` calls `optimizer.Adam(learning_rate=...)`:
    (make, holder), `holder` filled with a ModelAverage or EMA at
    minimize.
    adamw, proximal_gd, proximal_adagrad and average_accumulates have
    no optimizer class in the JAX package: a minimal Optimizer subclass
    appends each op."""
    o = pt.optimizer
    holder = {}

    class _OpOpt(o.Optimizer):
        def __init__(self, op, lr, accs=(), attrs=None):
            super().__init__(lr)
            self._op, self._accs, self._attrs = op, accs, attrs or {}

        def _create_accumulators(self, block, parameters):
            for p in parameters:
                for slot, name, fill, shape in self._accs:
                    self._add_accumulator(name, p, fill_value=fill,
                                          shape=shape)

        def _append_optimize_op(self, block, pg):
            p, g = pg
            ins = {"Param": p, "Grad": g,
                   "LearningRate": self._create_param_lr(pg)}
            outs = {"ParamOut": p}
            for slot, name, _, _ in self._accs:
                ins[slot] = outs[slot + "Out"] = self._get_accumulator(
                    name, p)
            return block.append_op(type=self._op, inputs=ins, outputs=outs,
                                   attrs=self._attrs)

    class _Averaged:
        """SGD, then `average_accumulates` on each param (the
        reference's ModelAverage op)."""

        def minimize(self, loss):
            from paddle_tpu_torch.core.framework import (OpRole,
                                                         op_role_guard)

            ops, pg = o.SGD(0.01).minimize(loss)
            acc = o.Optimizer(0.0)
            block = loss.block.program.global_block()
            with op_role_guard(OpRole.Optimize):
                for p, _ in pg:
                    v = {k: acc._add_accumulator(k, p) for k in
                         ("sum_1", "sum_2", "sum_3")}
                    v.update({k: acc._add_accumulator(k, p, dtype="int64",
                                                      shape=[1])
                              for k in ("num_accumulates",
                                        "old_num_accumulates",
                                        "num_updates")})
                    block.append_op(
                        type="average_accumulates",
                        inputs={"param": p, **{f"in_{k}": x
                                               for k, x in v.items()}},
                        outputs={f"out_{k}": x for k, x in v.items()},
                        attrs={"average_window": 0.15,
                               "min_average_window": 2,
                               "max_average_window": 4})
            return ops, pg

    class _With:
        """`inner`, then a ModelAverage or EMA built on its program."""

        def __init__(self, inner, extra):
            self.inner, self.extra = inner, extra

        def minimize(self, loss):
            out = self.inner.minimize(loss)
            holder["extra"] = self.extra()
            return out

    adam_accs = (("Moment1", "moment1", 0.0, None),
                 ("Moment2", "moment2", 0.0, None),
                 ("Beta1Pow", "beta1_pow_acc", 0.9, [1]),
                 ("Beta2Pow", "beta2_pow_acc", 0.999, [1]))

    def ema():
        e = o.ExponentialMovingAverage(decay=0.9)
        e.update()
        return e

    table = {
        "sgd": lambda: o.SGD(0.01),
        "momentum": lambda: o.Momentum(0.01, momentum=0.9),
        "lars_momentum": lambda: o.LarsMomentum(0.01, momentum=0.9),
        "adam": lambda: o.Adam(2e-3),
        "adamw": lambda: _OpOpt("adamw", 2e-3, adam_accs,
                                {"beta1": 0.9, "beta2": 0.999,
                                 "epsilon": 1e-8, "coeff": 0.01}),
        "adamax": lambda: o.Adamax(2e-3),
        "adagrad": lambda: o.Adagrad(0.01),
        "decayed_adagrad": lambda: o.DecayedAdagrad(0.01),
        "adadelta": lambda: o.Adadelta(1.0),
        "rmsprop": lambda: o.RMSProp(1e-3, momentum=0.9, centered=True),
        "ftrl": lambda: o.Ftrl(0.01, l1=1e-4, l2=1e-4),
        "lamb": lambda: o.Lamb(2e-3),
        "dpsgd": lambda: o.Dpsgd(0.01, clip=1.0, batch_size=1.0, sigma=0.0),
        "dgc_momentum": lambda: o.DGCMomentumOptimizer(0.01, momentum=0.9,
                                                       sparsity=[0.99]),
        "proximal_gd": lambda: _OpOpt("proximal_gd", 0.01, (),
                                      {"l1": 1e-4, "l2": 1e-4}),
        "proximal_adagrad": lambda: _OpOpt(
            "proximal_adagrad", 0.01, (("Moment", "moment", 0.1, None),),
            {"l1": 1e-4, "l2": 1e-4}),
        "average_accumulates": lambda: _Averaged(),
        "ModelAverage": lambda: _With(o.SGD(0.01), lambda: o.ModelAverage(
            0.15, min_average_window=2, max_average_window=4)),
        "ExponentialMovingAverage": lambda: _With(o.SGD(0.01), ema),
        "Lookahead": lambda: o.LookaheadOptimizer(o.SGD(0.01), alpha=0.5,
                                                  k=2),
        "GradientMerge": lambda: o.GradientMergeOptimizer(o.SGD(0.01),
                                                          k_steps=4),
        "Recompute": lambda: o.RecomputeOptimizer(o.Adam(2e-3)),
    }
    make = table[name]
    return (lambda **kw: make()), holder


def _optimize_section(main):
    """The ops of block 0 in the optimizer's role, in order."""
    from paddle_tpu_torch.core.framework import OpRole

    return [op for op in main.desc.block(0).ops
            if int(op.attrs.get(OpRole.AttrName, 0)) & OpRole.Optimize]


def _replay_on_cpu(main, ops, state, grads):
    """`ops` run by the CPU's kernels from `state` and the card's
    gradients `grads`: the env after them."""
    import torch

    from paddle_tpu_torch.core import lowering

    desc = main.desc
    cpu = torch.device("cpu")
    env = {n: torch.from_numpy(np.array(v)) for n, v in state.items()
           if isinstance(v, np.ndarray)}
    env.update({n: torch.from_numpy(np.array(v)) for n, v in grads.items()})

    def sub(idx, sub_env, ctx):
        return lowering.lower_block(desc, idx, sub_env, rng_key=0,
                                    device=cpu)

    with torch.no_grad():
        for op in ops:
            lowering.run_op(op, env, desc, 0, sub, 0, False, cpu)
    return env


def _trainer_optimizer(pt, exe, name, feed):
    """Phase 30 (b) for one optimizer: OPT_STEPS steps on the card and on
    the CPU, each from the CPU's state."""
    import torch

    from paddle_tpu_torch.convert import scope_from_numpy

    cuda, cpu = pt.CUDAPlace(0), pt.CPUPlace()
    make, holder = _opt_maker(pt, name)
    fpt = types.SimpleNamespace(**vars(pt))
    fpt.optimizer = types.SimpleNamespace(Adam=make)
    main, startup, loss = lenet_rung_program(fpt)
    params = [p.name for p in main.all_parameters()]
    grads = [n + "@GRAD" for n in params]
    section = _optimize_section(main)
    persistables = sorted(v.name for v in main.list_vars() if v.persistable)
    cpu_exe = pt.Executor(cpu)
    host = pt.Scope()
    cpu_exe.run(startup, scope=host)
    worst = {"loss": 0.0, "grad": 0.0, "update": 0.0}
    moved = []
    card = None
    for _ in range(OPT_STEPS):
        before = {n: host.get(n) for n in host.local_var_names()
                  if isinstance(host.find_var(n), torch.Tensor)}
        card = scope_from_numpy(pt.Scope(), before, cuda)
        got = exe.run(main, feed=feed, fetch_list=[loss] + grads,
                      scope=card)
        want = cpu_exe.run(main, feed=feed, fetch_list=[loss] + grads,
                           scope=host)
        worst["loss"] = max(worst["loss"], float(
            abs(got[0][0] - want[0][0]) / abs(want[0][0])))
        for a, b in zip(got[1:], want[1:]):
            worst["grad"] = max(worst["grad"], float(
                np.abs(a - b).max() / np.abs(b).max()))
        env = _replay_on_cpu(main, section, before,
                             dict(zip(grads, got[1:])))
        for n in persistables:
            w = env[n].numpy()
            err = float(np.abs(card.get(n).astype(np.float64) - w).max())
            worst["update"] = max(worst["update"],
                                  err / max(1.0, float(np.abs(w).max())))
        moved.append(not np.array_equal(card.get(params[0]),
                                        before[params[0]]))
    limits = {"loss": FLUID_TOL["loss"], "grad": FLUID_TOL["grad"],
              "update": OPT_TOL}
    for key, lim in limits.items():
        check(worst[key] <= lim, f"fluid trainer (b) {name}: {key} "
              f"differs by {worst[key]} (limit {lim})")
    out = {"op_types": sorted({op.type for op in section}),
           "worst": worst}
    if name == "GradientMerge":
        check(moved == [False, False, False, True, False],
              f"fluid trainer (b): GradientMerge(k=4) moved the params "
              f"at steps {moved}")
        out["params_moved"] = moved
    if name == "dpsgd":
        # sigma 0: SGD on the gradient clipped to norm 1, per tensor
        last = {n: card.get(n) for n in params}
        for n, g in zip(params, got[1:]):
            g = g.astype(np.float64)
            step = 0.01 * g / max(1.0, float(np.sqrt((g * g).sum())))
            err = np.abs(last[n] - (before[n] - step)).max()
            check(err <= 1e-6 * max(1.0, float(np.abs(last[n]).max())),
                  f"fluid trainer (b): dpsgd at sigma 0 is not clipped "
                  f"SGD on {n} ({err})")
        out["clipped_sgd"] = "equal"
    if name in ("ModelAverage", "ExponentialMovingAverage"):
        out["apply_restore"] = _apply_restore(pt, exe, main, startup, card,
                                              holder["extra"], params)
    return out


def _apply_restore(pt, exe, main, startup, scope, extra, params):
    """ModelAverage or EMA on the card: inside `apply` the params are
    the averages; after it, the params bit for bit."""
    from paddle_tpu_torch.optimizer import ModelAverage

    before = {n: scope.get(n) for n in params}
    with pt.scope_guard(scope), pt.program_guard(main, startup):
        with extra.apply(exe):
            inside = {n: scope.get(n) for n in params}
            if isinstance(extra, ModelAverage):
                cnt = max(float(scope.get(extra._cnt_var.name)[0]), 1.0)
                for n in params:
                    avg = scope.get(extra._sum_vars[n].name) / cnt
                    check(np.allclose(inside[n], avg, rtol=1e-6, atol=0),
                          f"fluid trainer (b): ModelAverage.apply's {n} "
                          f"is not the average")
        restored = all(np.array_equal(scope.get(n), before[n])
                       for n in params)
    check(restored, "fluid trainer (b): apply did not restore the params")
    check(any(not np.array_equal(inside[n], before[n]) for n in params),
          "fluid trainer (b): apply swapped in the params unchanged")
    return "restored"


def ctr_program(pt, opt, is_sparse):
    """tools/ctr_bench.py's downpour CTR program made local: the id slot
    (float, as the native datafeed gives it) cast to int64, an
    `embedding` of CTR_V x CTR_D with `is_sparse`, fc(1, sigmoid), the
    mean log loss, and the optimizer `opt` (sgd, momentum, adagrad,
    adam or adam_lazy): (main, startup, loss, table name)."""
    main, startup = pt.Program(), pt.Program()
    main.random_seed = startup.random_seed = 3
    with pt.framework.unique_name.guard(), pt.program_guard(main, startup):
        w = pt.layers.data(name="wf", shape=[1], dtype="float32")
        label = pt.layers.data(name="label", shape=[1], dtype="float32")
        ids64 = pt.layers.cast(w, "int64")
        emb = pt.layers.embedding(ids64, (CTR_V, CTR_D),
                                  is_sparse=is_sparse)
        emb = pt.layers.reshape(emb, shape=[-1, CTR_D])
        pred = pt.layers.fc(input=emb, size=1, act="sigmoid")
        loss = pt.layers.mean(pt.layers.log_loss(pred, label))
        o = pt.optimizer
        {"sgd": lambda: o.SGD(0.1),
         "momentum": lambda: o.Momentum(0.1, momentum=0.9),
         "adagrad": lambda: o.Adagrad(0.1),
         "adam": lambda: o.Adam(0.01),
         "adam_lazy": lambda: o.Adam(0.01, lazy_mode=True)}[opt]() \
            .minimize(loss)
    table = [p.name for p in main.all_parameters()
             if tuple(p.shape) == (CTR_V, CTR_D)][0]
    return main, startup, loss, table


def ctr_feeds(steps, seed=0):
    """Zipf-like ids (heavy repeats within a batch) and their clicks
    (id % 3 == 0, as tools/ctr_bench.py labels them)."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(steps):
        ids = (rng.zipf(CTR_ZIPF, (CTR_B, 1)) - 1) % CTR_V
        out.append({"wf": ids.astype("float32"),
                    "label": (ids % 3 == 0).astype("float32")})
    return out


def _trainer_sparse(pt, exe):
    """Phase 30 (c)."""
    import torch

    from paddle_tpu_torch.convert import scope_from_numpy

    cuda = pt.CUDAPlace(0)
    feeds = ctr_feeds(CTR_STEPS)
    out = {"repeats_in_a_batch": int(CTR_B - len(np.unique(feeds[0]["wf"])))}

    def run(opt, is_sparse):
        main, startup, loss, table = ctr_program(pt, opt, is_sparse)
        scope = pt.Scope()
        exe.run(startup, scope=scope)
        ms = []
        for f in feeds:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            exe.run(main, feed=f, fetch_list=[loss], scope=scope)
            ms.append((time.perf_counter() - t0) * 1e3)
        return main, scope, table, statistics.median(ms[1:])

    for opt in ("sgd", "momentum", "adagrad", "adam"):
        dmain, dense, table, dense_ms = run(opt, False)
        smain, sparse, _, sparse_ms = run(opt, True)
        a, b = _persist_state(sparse, smain), _persist_state(dense, dmain)
        _state_equal(f"c, {opt} sparse vs dense", a, b)
        out[opt] = {"sparse_step_ms": sparse_ms, "dense_step_ms": dense_ms,
                    "table": "equal bit for bit"}
    # lazy Adam: each step from the dense run's state, the touched rows
    # equal the dense step's and the others keep params and moments
    main, startup, loss, table = ctr_program(pt, "adam_lazy", True)
    dmain, dstart, dloss, _ = ctr_program(pt, "adam", False)
    dense = pt.Scope()
    exe.run(dstart, scope=dense)
    tables = [table] + [v.name for v in main.list_vars() if v.persistable
                        and v.name.startswith(table + "_moment")]
    ms = []
    for f in feeds:
        before = _persist_state(dense, dmain)
        lazy = scope_from_numpy(pt.Scope(), {
            k: v for k, v in before.items() if isinstance(v, np.ndarray)},
            cuda)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        exe.run(main, feed=f, fetch_list=[loss], scope=lazy)
        ms.append((time.perf_counter() - t0) * 1e3)
        exe.run(dmain, feed=f, fetch_list=[dloss], scope=dense)
        rows = np.unique(f["wf"].astype("int64"))
        other = np.setdiff1d(np.arange(CTR_V), rows)
        for n in tables:
            got, step = lazy.get(n), dense.get(n)
            check(np.array_equal(got[rows], step[rows]),
                  f"fluid trainer (c): lazy adam's touched rows of {n} "
                  f"differ from the dense step's")
            check(np.array_equal(got[other], before[n][other]),
                  f"fluid trainer (c): lazy adam moved untouched rows "
                  f"of {n}")
    out["adam_lazy"] = {"sparse_step_ms": statistics.median(ms[1:]),
                        "touched_rows": "equal to dense",
                        "untouched_rows": "unchanged"}
    return out


def _amp_vgg(pt, width=1, **kw):
    """VGG-16-BN (`vgg_bn_program`) with its Adam decorated by
    `amp.decorate(**kw)`: (main, startup, loss, the decorated
    optimizer)."""
    holder = {}

    def adam(**a):
        holder["opt"] = pt.amp.decorate(pt.optimizer.Adam(**a), **kw)
        return holder["opt"]

    fpt = types.SimpleNamespace(**vars(pt))
    fpt.optimizer = types.SimpleNamespace(Adam=adam)
    main, startup, _, loss, _ = vgg_bn_program(fpt, width=width)
    return main, startup, loss, holder["opt"]


def _trainer_amp(pt, exe):
    """Phase 30 (d): amp.decorate (mixed_bf16) on VGG-16-BN trains; the
    f16 decoration's loss scale, read each step, on the card and on the
    CPU (the JAX package's fluid decorator keeps a static scale: no op
    of its program updates it)."""
    main, startup, loss, _ = _amp_vgg(pt)
    check(main._attrs.get("precision") == "mixed_bf16",
          f"fluid trainer (d): decorate pinned {main._attrs}")
    scope = pt.Scope()
    exe.run(startup, scope=scope)
    img, label = synthetic_cifar(VGG_B * AMP_STEPS, seed=4)
    losses = []
    for i in range(AMP_STEPS):
        b = slice(i * VGG_B, (i + 1) * VGG_B)
        losses.append(float(exe.run(main, feed={"img": img[b],
                                                "label": label[b]},
                                    fetch_list=[loss], scope=scope)[0][0]))
    check(all(np.isfinite(losses)) and
          np.mean(losses[-4:]) < np.mean(losses[:4]),
          f"fluid trainer (d): amp VGG-16-BN's loss did not fall: {losses}")
    traj = {}
    # the CPU's run at width / 8 and batch 8: an f16 VGG step at full
    # width takes minutes on the CPU, and the scale is the program's
    for where, width, n in (("card", 1, VGG_B), ("cpu", 8, 8)):
        main, startup, loss, opt = _amp_vgg(
            pt, width, use_bf16=False, init_loss_scaling=AMP_F16_SCALE)
        scale = opt.get_loss_scaling().name
        ex = exe if where == "card" else pt.Executor(pt.CPUPlace())
        s = pt.Scope()
        ex.run(startup, scope=s)
        traj[where] = []
        for i in range(AMP_SCALE_STEPS):
            ex.run(main, feed={"img": img[i * n:(i + 1) * n],
                               "label": label[i * n:(i + 1) * n]},
                   fetch_list=[loss], scope=s)
            traj[where].append(float(s.get(scale)[0]))
    check(traj["card"] == traj["cpu"],
          f"fluid trainer (d): loss scales {traj}")
    return {"policy": "mixed_bf16", "losses_first_last": [losses[0],
                                                           losses[-1]],
            "loss_mean_first4_last4": [float(np.mean(losses[:4])),
                                       float(np.mean(losses[-4:]))],
            "f16_loss_scale": traj}


def _trainer_fleet(pt, exe, feed):
    """Phase 30 (e): each optimizer rewrite of DistributedStrategy on
    bench.py's LeNet rung under with_data_parallel at 2 ranks against
    one rank; DGC with an axis under SPMDRunner against each rank's
    compression summed by the ring's sparse_allreduce."""
    from paddle_tpu_torch import parallel as par
    from paddle_tpu_torch.parallel.fleet import Fleet

    cuda = pt.CUDAPlace(0)
    out = {}
    for knob in ("use_amp", "recompute", "gradient_merge_k", "use_dgc",
                 "lamb"):
        fl = Fleet()
        fl.init(par.UserDefinedRoleMaker(current_id=0, worker_num=1))
        st = par.DistributedStrategy(
            **{knob: 2 if knob == "gradient_merge_k" else True})
        fpt = types.SimpleNamespace(**vars(pt))
        inner = (lambda **kw: pt.optimizer.DGCMomentumOptimizer(
            0.01, momentum=0.9, sparsity=[0.99])) if knob == "use_dgc" \
            else pt.optimizer.Adam
        fpt.optimizer = types.SimpleNamespace(
            Adam=lambda **kw: fl.distributed_optimizer(inner(**kw), st))
        main, startup, loss = lenet_rung_program(fpt)
        prog = pt.CompiledProgram(main).with_data_parallel(
            loss_name=loss.name, places=[cuda] * 2)
        out[knob] = _fluid_dp_parity(
            pt, f"30 (e) {knob}", lambda s, f: exe.run(
                prog, feed=feed, fetch_list=f, scope=s),
            feed, main, startup, loss,
            limits=AMP_DP_TOL if knob == "use_amp" else FLUID_TOL)
    out["dgc_spmd"] = _dgc_spmd(pt, exe, feed)
    return out


def _dgc_spmd(pt, exe, feed):
    """DGCMomentum with axis "dp" under SPMDRunner on 2 ranks, one step,
    against each rank's gradient (its half of the batch, one rank)
    compressed and summed by the ring's `sparse_allreduce` by hand."""
    import torch

    from paddle_tpu_torch import parallel as par
    from paddle_tpu_torch.convert import scope_from_numpy
    from paddle_tpu_torch.ops.collective import sparse_allreduce

    cuda = pt.CUDAPlace(0)

    def build(axis):
        fpt = types.SimpleNamespace(**vars(pt))
        fpt.optimizer = types.SimpleNamespace(
            Adam=lambda **kw: pt.optimizer.DGCMomentumOptimizer(
                0.01, momentum=0.9, sparsity=[0.99], axis_name=axis))
        return lenet_rung_program(fpt)

    main, startup, loss = build("dp")
    params = [p.name for p in main.all_parameters()]
    s0 = pt.Scope()
    exe.run(startup, scope=s0)
    init = {n: s0.get(n) for n in s0.local_var_names()
            if isinstance(s0.find_var(n), torch.Tensor)}
    mesh = par.make_mesh(par.MeshConfig(dp=2),
                         devices=[cuda.torch_device()] * 2)
    runner = par.SPMDRunner(main, mesh, axis="dp")
    s = scope_from_numpy(pt.Scope(), init, cuda)
    runner.run(exe, feed=feed, fetch_list=[loss], scope=s)
    # by hand: each half's gradient on one rank (no axis)
    plain, _, ploss = build(None)
    half = FLUID_B // 2
    g = []
    for r in range(2):
        sc = scope_from_numpy(pt.Scope(), init, cuda)
        g.append(exe.run(plain, feed={k: v[r * half:(r + 1) * half]
                                      for k, v in feed.items()},
                         fetch_list=[n + "@GRAD" for n in params],
                         scope=sc))
    worst = 0.0
    ratio = 1.0 - 0.99          # the optimizer's sparsity_ratio
    for i, n in enumerate(params):
        sparse = []
        for r in range(2):
            # U and V start at 0: the compressed value is the gradient's
            v = torch.from_numpy(g[r][i]).to(cuda.torch_device())
            flat = v.abs().reshape(-1)
            k = max(1, int(flat.numel() * ratio))
            thresh = torch.topk(flat, k).values[-1]
            sparse.append(torch.where(v.abs() >= thresh, v,
                                      torch.zeros_like(v)).reshape(-1))
        red = sparse_allreduce(sparse, k).reshape(g[0][i].shape)
        want = init[n] - 0.01 * red.cpu().numpy()
        err = float(np.abs(s.get(n) - want).max())
        worst = max(worst, err / max(1.0, float(np.abs(want).max())))
    check(worst <= OPT_TOL, f"fluid trainer (e): DGC under SPMDRunner "
          f"differs from the ranks' sparse_allreduce by {worst}")
    return {"worst": worst, "ranks": 2}


def phase_fluid_trainer():
    """Phase 30: the fluid trainer's front end ((a)-(e) above)."""
    import torch

    import paddle_tpu_torch as pt

    t0 = time.perf_counter()
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.backends.cudnn.deterministic)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out, secs = {}, {}
    try:
        exe = pt.Executor(pt.CUDAPlace(0))
        torch.backends.cudnn.deterministic = True
        t = time.perf_counter()
        out["a_streamed_trainer"] = _trainer_stream(pt, exe)
        secs["a"] = time.perf_counter() - t
        rng = np.random.RandomState(0)
        feed = {"x": rng.rand(FLUID_B, 1, 28, 28).astype("float32"),
                "y": rng.randint(0, 10, (FLUID_B, 1)).astype("int64")}
        t = time.perf_counter()
        out["b_optimizers"] = {
            name: _trainer_optimizer(pt, exe, name, feed)
            for name in ("sgd", "momentum", "lars_momentum", "adam",
                         "adamw", "adamax", "adagrad", "decayed_adagrad",
                         "adadelta", "rmsprop", "ftrl", "lamb", "dpsgd",
                         "dgc_momentum", "proximal_gd", "proximal_adagrad",
                         "average_accumulates", "ModelAverage",
                         "ExponentialMovingAverage", "Lookahead",
                         "GradientMerge", "Recompute")}
        types_run = set().union(*(v["op_types"]
                                  for v in out["b_optimizers"].values()))
        missing = set(OPTIMIZER_OPS) - types_run
        check(not missing, f"fluid trainer (b): no run reached {missing}")
        secs["b"] = time.perf_counter() - t
        t = time.perf_counter()
        out["c_sparse_ctr"] = _trainer_sparse(pt, exe)
        secs["c"] = time.perf_counter() - t
        t = time.perf_counter()
        out["d_amp"] = _trainer_amp(pt, exe)
        secs["d"] = time.perf_counter() - t
        t = time.perf_counter()
        out["e_fleet"] = _trainer_fleet(pt, exe, feed)
        secs["e"] = time.perf_counter() - t
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32,
         torch.backends.cudnn.deterministic) = flags
    print(json.dumps({
        "phase": "fluid_trainer", "card": card(),
        "programs": "book vgg_bn_drop (VGG-16-BN) batch 128 f32 with TF32 "
                    "off; bench.py's LeNet rung batch 256; the CTR program "
                    f"{CTR_V} x {CTR_D} batch {CTR_B}",
        **out, "limits": {"fluid": FLUID_TOL, "optimizer_update": OPT_TOL,
                          "amp_dp": AMP_DP_TOL},
        "part_seconds": secs, "seconds": time.perf_counter() - t0}))
    torch.cuda.empty_cache()


# the optimizer op types of the JAX package's ops/optimizer_ops.py
OPTIMIZER_OPS = ("sgd", "momentum", "lars_momentum", "adam", "adamw",
                 "adamax", "adagrad", "decayed_adagrad", "adadelta",
                 "rmsprop", "ftrl", "lamb", "dpsgd", "dgc_momentum",
                 "proximal_gd", "proximal_adagrad", "average_accumulates")


DYGRAPH_CLASSES = 102      # the flowers dataset of dygraph/resnet/train.py
DYGRAPH_DEPTH = (3, 4, 6, 3)          # ResNet-50
DYGRAPH_FILTERS = (64, 128, 256, 512)


def dygraph_resnet(pt, width=1, class_dim=DYGRAPH_CLASSES):
    """ResNet-50 as PaddlePaddle/models' dygraph/resnet/train.py builds
    it, from `pt.dygraph` layers only (`pt` either package): ConvBNLayer
    (Conv2D without bias, BatchNorm with the activation), bottleneck
    blocks added with `add_sublayer`, a global average pool and a
    softmax Linear head of `class_dim`. `width` divides every channel
    count (1 is ResNet-50 itself)."""
    dy = pt.dygraph

    class ConvBN(dy.Layer):
        def __init__(self, cin, cout, k, stride=1, act=None):
            super().__init__()
            self._conv = dy.Conv2D(cin, cout, k, stride=stride,
                                   padding=(k - 1) // 2, bias_attr=False)
            self._batch_norm = dy.BatchNorm(cout, act=act)

        def forward(self, x):
            return self._batch_norm(self._conv(x))

    class Bottleneck(dy.Layer):
        def __init__(self, cin, filters, stride, shortcut):
            super().__init__()
            self.conv0 = ConvBN(cin, filters, 1, act="relu")
            self.conv1 = ConvBN(filters, filters, 3, stride=stride,
                                act="relu")
            self.conv2 = ConvBN(filters, filters * 4, 1)
            if not shortcut:
                self.short = ConvBN(cin, filters * 4, 1, stride=stride)
            self.shortcut = shortcut
            self.cout = filters * 4

        def forward(self, x):
            y = self.conv2(self.conv1(self.conv0(x)))
            short = x if self.shortcut else self.short(x)
            return pt.layers.elementwise_add(x=short, y=y, act="relu")

    class ResNet(dy.Layer):
        def __init__(self):
            super().__init__()
            filters = [f // width for f in DYGRAPH_FILTERS]
            self.conv = ConvBN(3, 64 // width, 7, stride=2, act="relu")
            self.pool2d_max = dy.Pool2D(pool_size=3, pool_stride=2,
                                        pool_padding=1, pool_type="max")
            self.blocks = []
            cin = 64 // width
            for b, depth in enumerate(DYGRAPH_DEPTH):
                for i in range(depth):
                    blk = self.add_sublayer(f"bb_{b}_{i}", Bottleneck(
                        cin, filters[b], 2 if i == 0 and b != 0 else 1,
                        shortcut=i > 0))
                    self.blocks.append(blk)
                    cin = blk.cout
            self.pool2d_avg = dy.Pool2D(pool_size=7, pool_type="avg",
                                        global_pooling=True)
            self.feat = cin
            stdv = 1.0 / math.sqrt(cin * 1.0)
            self.out = dy.Linear(cin, class_dim, act="softmax",
                                 param_attr=pt.ParamAttr(
                                     initializer=pt.initializer.Uniform(
                                         -stdv, stdv)))

        def forward(self, x):
            y = self.pool2d_max(self.conv(x))
            for blk in self.blocks:
                y = blk(y)
            y = pt.layers.reshape(self.pool2d_avg(y), shape=[-1, self.feat])
            return self.out(y)

    return ResNet()


def dygraph_optimizer(pt, boundaries=(30, 60, 90), base_lr=0.1):
    """train.py's optimizer_setting: Momentum 0.9 under a piecewise decay
    of the learning rate (here the dygraph PiecewiseDecay, by step),
    with L2Decay(1e-4)."""
    values = [base_lr * 0.1 ** i for i in range(len(boundaries) + 1)]
    return pt.optimizer.Momentum(
        learning_rate=pt.dygraph.PiecewiseDecay(list(boundaries), values),
        momentum=0.9, regularization=pt.regularizer.L2Decay(1e-4))


def dygraph_step(pt, model, opt, img, label, grads=None):
    """One train.py step: softmax cross entropy's mean through
    DataParallel's scale_loss, backward, apply_collective_grads,
    minimize (the caller clears the gradients). `grads`, a dict, takes
    each parameter's gradient (host numpy) before the update. Returns
    the loss VarBase."""
    out = model(pt.dygraph.to_variable(img))
    loss = pt.layers.mean(pt.layers.cross_entropy(
        input=out, label=pt.dygraph.to_variable(label)))
    loss = model.scale_loss(loss)
    loss.backward()
    model.apply_collective_grads()
    if grads is not None:
        grads.update({k: p.gradient for k, p in model.named_parameters()
                      if p.gradient is not None})
    opt.minimize(loss, parameter_list=model.parameters())
    return loss


DYGRAPH_B = 32             # train.py's batch
DYGRAPH_HW = 224
DYGRAPH_STEPS = 5
DYGRAPH_PARITY_B = 2
# train.py's base lr 0.1 is for 8 cards of 32 images (256 a step); one
# card's 32 takes it scaled linearly. At 0.1 one batch's loss rises
# from the second step (4.9 -> 17.7 in 5 steps on the H100; on the CPU
# at 8 x 96^2 too), at 0.0125 it falls.
DYGRAPH_LR = 0.1 * DYGRAPH_B / 256
# (b)'s limits, card against CPU, each of its largest value (the loss
# relative). The gradients' is phase 29's under a batch norm (`VGG_TOL`,
# F13): at batch 2 the norms' one-pass f32 variance moves every
# gradient beneath them. Read on the H100 (NVIDIA H100 80GB HBM3, 700
# W): loss 2.1e-6, gradients 2.8e-2, parameters 1.0e-3, running stats
# 1.3e-5 (first step; the second's are smaller).
DYGRAPH_TOL = {"loss": 1e-5, "grad": 5e-2, "param": 5e-3, "stat": 1e-4}
# (e)'s classes, as tests/test_torch_fluid_ops.py's TOL; under a batch
# norm, of the largest gradient
DYGRAPH_ZOO_TOL = {"ew": (1e-5, 1e-6), "mm": (1e-4, 1e-4), "bn": 1e-3}
_TREE_EDGES = [[[1, 2], [1, 3], [2, 4], [2, 5], [0, 0]],
               [[1, 2], [2, 3], [2, 4], [0, 0], [0, 0]]]
# (e): every layer of the zoo (JAX package dygraph/__init__.py and
# TreeConv): name, a function making the layer, input shapes (or the
# specials "ids:V", "edges", "len"), class ("bn": under a batch norm)
DYGRAPH_ZOO = (
    ("Conv2D", lambda nn: nn.Conv2D(3, 8, 3, padding=1, act="tanh"),
     [(4, 3, 16, 16)], "mm"),
    ("Conv3D", lambda nn: nn.Conv3D(2, 3, 2, padding=1), [(2, 2, 6, 6, 6)],
     "mm"),
    ("Conv2DTranspose", lambda nn: nn.Conv2DTranspose(3, 4, 3, stride=2,
                                                      padding=1),
     [(2, 3, 8, 8)], "mm"),
    ("Conv3DTranspose", lambda nn: nn.Conv3DTranspose(2, 3, 2, stride=2),
     [(1, 2, 4, 4, 4)], "mm"),
    ("Linear", lambda nn: nn.Linear(64, 32, act="sigmoid"), [(8, 64)], "mm"),
    ("FC", lambda nn: nn.FC("fc", 32, input_dim=64), [(8, 64)], "mm"),
    ("BatchNorm", lambda nn: nn.BatchNorm(8, act="relu"), [(8, 8, 7, 7)],
     "bn"),
    ("Embedding", lambda nn: nn.Embedding(size=[100, 16], padding_idx=2),
     ["ids:100"], "ew"),
    ("LayerNorm", lambda nn: nn.LayerNorm(32), [(4, 6, 32)], "mm"),
    ("GRUUnit", lambda nn: nn.GRUUnit(48), [(4, 48), (4, 16)], "ew"),
    ("Pool2D", lambda nn: nn.Pool2D(pool_size=3, pool_stride=2,
                                    pool_padding=1), [(2, 4, 9, 9)], "ew"),
    ("Dropout_eval", lambda nn: nn.Dropout(p=0.3), [(8, 64)], "ew"),
    ("PRelu", lambda nn: nn.PRelu(mode="channel", channel=4),
     [(2, 4, 6, 6)], "ew"),
    ("BilinearTensorProduct", lambda nn: nn.BilinearTensorProduct(
        16, 12, 8), [(8, 16), (8, 12)], "mm"),
    ("SequenceConv", lambda nn: nn.SequenceConv(16, 24, filter_size=3),
     [(4, 20, 16), "len"], "mm"),
    ("RowConv", lambda nn: nn.RowConv(16, future_context_size=3),
     [(4, 20, 16)], "mm"),
    ("GroupNorm", lambda nn: nn.GroupNorm(8, groups=4), [(2, 8, 6, 6)],
     "mm"),
    ("SpectralNorm", lambda nn: nn.SpectralNorm([16, 12], power_iters=3),
     [(16, 12)], "mm"),
    ("TreeConv", lambda nn: nn.TreeConv(6, 4, num_filters=2, max_depth=2),
     [(2, 5, 6), "edges"], "mm"),
)


def _dygraph_zoo_inputs(shapes, rng):
    out = []
    for s in shapes:
        if s == "edges":
            out.append(np.array(_TREE_EDGES, "int64"))
        elif s == "len":
            out.append(np.array([20, 13, 7, 1], "int64"))
        elif isinstance(s, str):
            out.append(rng.randint(0, int(s.split(":")[1]), (6, 9)).astype(
                "int64"))
        else:
            out.append(rng.standard_normal(s).astype("float32"))
    return out


def _dygraph_zoo_run(pt, place, build, arrays, cot, name, state=None):
    """One layer's forward and the backward of sum(out * cot) on
    `place`: (out, input grads, param grads, state after, state before)."""
    with pt.dygraph.guard(place):
        layer = build(pt.dygraph.nn)
        if state is not None:
            layer.set_dict(state)
        before = layer.state_dict()
        if name.endswith("_eval"):
            layer.eval()
        try:
            xs = [pt.dygraph.to_variable(a) for a in arrays]
            out = layer(*xs)
            if isinstance(out, tuple):
                out = out[0]
            c = pt.dygraph.to_variable(cot(out.shape))
            c.stop_gradient = True
            pt.layers.reduce_sum(pt.layers.elementwise_mul(out, c)).backward()
        finally:
            layer.train()
        return (out.numpy(), [x.gradient for x in xs],
                {k: p.gradient for k, p in layer.named_parameters()},
                layer.state_dict(), before)


def _zoo_err(got, want, cls, big=None):
    """The worst error as the class's limit reads it (1.0 at the limit);
    None when both are None."""
    if want is None:
        check(got is None, "a gradient on one side only")
        return 0.0
    got, want = np.asarray(got, "float64"), np.asarray(want, "float64")
    check(got.shape == want.shape, f"shapes {got.shape} {want.shape}")
    if not np.issubdtype(want.dtype, np.floating):
        return float(np.abs(got - want).max() > 0) * 1e9
    if cls == "bn":
        return float(np.abs(got - want).max() / (DYGRAPH_ZOO_TOL["bn"] * big))
    rtol, atol = DYGRAPH_ZOO_TOL[cls]
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    lim = atol * scale + rtol * np.abs(want)
    return float((np.abs(got - want) / lim).max()) if want.size else 0.0


def dygraph_zoo(pt, dev, ref):
    """(e): every layer of the zoo on `dev` against `ref` from the same
    weights and inputs: forward, input and parameter gradients, state
    after, each as its worst error over its limit (must be <= 1); NCE,
    random, by its properties: a finite positive cost, the weight
    gradient only on the forward's sampled rows."""
    worst = {}
    for name, build, shapes, cls in DYGRAPH_ZOO:
        rng = np.random.RandomState(sum(map(ord, name)))
        arrays = _dygraph_zoo_inputs(shapes, rng)
        cots = {}

        def cot(shape):
            if shape not in cots:
                cots[shape] = rng.standard_normal(shape).astype("float32")
            return cots[shape]

        want = _dygraph_zoo_run(pt, ref, build, arrays, cot, name)
        got = _dygraph_zoo_run(pt, dev, build, arrays, cot, name,
                               state=want[4])
        grads = list(zip(got[1], want[1])) + [
            (got[2][k], want[2][k]) for k in want[2]]
        big = max([float(np.abs(w).max()) for _, w in grads
                   if w is not None] or [1.0])
        errs = [_zoo_err(got[0], want[0], "mm" if cls == "bn" else cls)]
        errs += [_zoo_err(g, w, cls, big) for g, w in grads]
        errs += [_zoo_err(got[3][k], want[3][k], "mm") for k in want[3]]
        worst[name] = max(errs)
        check(worst[name] <= 1.0,
              f"dygraph (e): {name} on the card against the CPU at "
              f"{worst[name]:.3g} of its limit")
    with pt.dygraph.guard(dev):
        nce = pt.dygraph.NCE(1000, 64, num_neg_samples=8)
        x = pt.dygraph.to_variable(
            np.random.RandomState(3).standard_normal((16, 64)).astype(
                "float32"))
        lab = pt.dygraph.to_variable(
            np.random.RandomState(4).randint(0, 1000, (16, 1)))
        outs = pt.dygraph.base.get_tracer().trace_op(
            "nce", {"Input": [x], "Label": [lab], "Weight": [nce.weight],
                    "Bias": [nce.bias]},
            {"Cost": [None], "SampleLogits": [None], "SampleLabels": [None]},
            nce._attrs)
        cost = outs["Cost"][0]
        pt.layers.reduce_sum(cost).backward()
        c = cost.numpy()
        rows = set(np.nonzero(np.abs(nce.weight.gradient).sum(1))[0])
        samples = set(outs["SampleLabels"][0].numpy().flat)
        check(cost.shape == (16, 1) and np.isfinite(c).all() and
              (c > 0).all() and rows and rows <= samples,
              "dygraph (e): NCE's cost or its gradient's rows")
    worst["NCE_rows"] = len(rows)
    return worst


def dygraph_dropout(pt, dev):
    """(f): Dropout(0.5)'s input gradient equals its forward's mask times
    its scale, exactly, under both implementations."""
    X = np.ones((64, 1024), "float32")
    kept = {}
    for impl, scale in (("downgrade_in_infer", 1.0),
                        ("upscale_in_train", 2.0)):
        with pt.dygraph.guard(dev):
            x = pt.dygraph.to_variable(X)
            out = pt.dygraph.Dropout(p=0.5, dropout_implementation=impl)(x)
            pt.layers.reduce_sum(out).backward()
            o, g = out.numpy(), x.gradient
        mask = o != 0
        check(np.array_equal(o, np.where(mask, scale, 0.0)) and
              np.array_equal(g, np.where(mask, scale, 0.0)),
              f"dygraph (f): {impl}'s gradient is not its forward's mask")
        kept[impl] = float(mask.mean())
        check(0.45 < kept[impl] < 0.55, f"dygraph (f): kept {kept}")
    return kept


def _dygraph_worst(got, want):
    """(loss, grads, state) of two runs: each compared quantity's worst
    difference, as DYGRAPH_TOL reads it."""
    (tl, tg, ts), (jl, jg, js) = got, want
    params = [k for k in js if not k.endswith(("_mean", "_variance"))]
    stats = [k for k in js if k.endswith(("_mean", "_variance"))]
    check(sorted(tg) == sorted(jg) and sorted(ts) == sorted(js),
          "dygraph (b): the two runs' names differ")

    def worst(keys, a, b):
        big = max(float(np.abs(b[k]).max()) for k in keys)
        return max(float(np.abs(a[k] - b[k]).max()) for k in keys) / big

    return {"loss": abs(tl - jl) / abs(jl), "grad": worst(list(jg), tg, jg),
            "param": worst(params, ts, js), "stat": worst(stats, ts, js)}


def dygraph_parity(pt, dev, ref):
    """(b): the network at batch 2, 2 steps on `dev` and on `ref` from
    one state_dict; before the second step `ref` takes `dev`'s weights,
    statistics and velocities (a step is chaotic). The loss,
    every parameter gradient, the updated parameters and the running
    statistics, each against DYGRAPH_TOL."""
    rng = np.random.RandomState(7)
    imgs = rng.rand(2, DYGRAPH_PARITY_B, 3, DYGRAPH_HW, DYGRAPH_HW).astype(
        "float32")
    labels = rng.randint(0, DYGRAPH_CLASSES,
                         (2, DYGRAPH_PARITY_B, 1)).astype("int64")
    runs = {}
    for name, place in (("dev", dev), ("ref", ref)):
        with pt.dygraph.guard(place):
            runs[name] = (pt.dygraph.DataParallel(dygraph_resnet(pt)),
                          dygraph_optimizer(pt, base_lr=DYGRAPH_LR))
    state = runs["dev"][0].state_dict()
    worst = []
    for step in range(2):
        res = {}
        for name, place in (("dev", dev), ("ref", ref)):
            model, opt = runs[name]
            with pt.dygraph.guard(place):
                if step == 0 or name == "ref":
                    model.set_dict(state)
                grads = {}
                loss = dygraph_step(pt, model, opt, imgs[step], labels[step],
                                    grads)
                model.clear_gradients()
                res[name] = (float(loss.numpy().reshape(())), grads,
                             model.state_dict())
        w = _dygraph_worst(res["dev"], res["ref"])
        worst.append(w)
        for k, lim in DYGRAPH_TOL.items():
            check(w[k] <= lim, f"dygraph (b) step {step}: {k} {w[k]:.3g} "
                               f"over {lim} (all: {w})")
        state = res["dev"][2]
        dev_opt, ref_opt = runs["dev"][1], runs["ref"][1]
        ref_params = dict(runs["ref"][0].named_parameters())
        with pt.dygraph.guard(ref):
            for k, p in runs["dev"][0].named_parameters():
                if p in dev_opt._eager_state:
                    ref_opt._eager_state[ref_params[k]]["v"] = \
                        dev_opt._eager_state[p]["v"].to(
                            ref_params[k].device).clone()
    return {"worst": worst, "losses": [res["dev"][0], res["ref"][0]]}


def dygraph_traced(pt, model, img, root, exe_place):
    """(c): TracedLayer.trace of `model` in eval() on `img`; the traced
    program's run against the eager forward, and the saved and reloaded
    model's run against the traced run. Returns the numbers and the
    traced layer."""
    import torch

    cuda = isinstance(exe_place, pt.CUDAPlace)
    model.eval()
    try:
        x = pt.dygraph.to_variable(img)
        with pt.dygraph.no_grad():
            eager, traced = pt.dygraph.TracedLayer.trace(model, [x])
        if cuda:
            # the traced program's run alone: the trace itself holds
            # every op's output until it has built the program
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        ran = traced([x])[0].numpy()
        run_peak = torch.cuda.max_memory_allocated() if cuda else None
    finally:
        model.train()
    want = eager.numpy()
    big = float(np.abs(want).max())
    err = float(np.abs(ran - want).max()) / big
    check(err <= DYGRAPH_ZOO_TOL["mm"][1],
          f"dygraph (c): the traced program at {err:.3g} of the eager forward")
    d = os.path.join(root, "traced")
    traced.save_inference_model(d)
    exe = pt.Executor(exe_place)
    with pt.scope_guard(pt.Scope()):
        prog, feeds, fetches = pt.io.load_inference_model(d, exe)
        with torch.no_grad():
            loaded = np.asarray(exe.run(prog, feed={feeds[0]: img},
                                        fetch_list=fetches)[0])
    lerr = float(np.abs(loaded - ran).max()) / big
    check(lerr <= 1e-6, f"dygraph (c): the reloaded model at {lerr:.3g}")
    ops = [op.type for op in traced.program.global_block().desc.ops]
    return {"traced_vs_eager": err, "loaded_vs_traced": lerr,
            "loaded_bit_equal": bool(np.array_equal(loaded, ran)),
            "ops": len(ops), "op_types": sorted(set(ops)),
            "run_max_memory_allocated_bytes": run_peak,
            "allocated_before_the_run_bytes": base if cuda else None}, traced


def dygraph_checkpoint(pt, model, root):
    """(d): save_dygraph / load_dygraph of `model`'s state, bit for bit,
    and set back into the model."""
    path = os.path.join(root, "ckpt", "resnet50")
    want = model.state_dict()
    pt.dygraph.save_dygraph(want, path)
    got, _ = pt.dygraph.load_dygraph(path)
    model.set_dict(got)
    after = model.state_dict()
    check(sorted(got) == sorted(want) and all(
        np.array_equal(got[k], want[k]) and np.array_equal(after[k], want[k])
        for k in want), "dygraph (d): the round trip is not bit for bit")
    return {"tensors": len(want),
            "bytes": os.path.getsize(path + ".pdparams.npz")}


def phase_dygraph():
    """Phase 31: dygraph (eager mode) at ResNet-50's full width ((a)-(g)
    above)."""
    import contextlib
    import io
    import tempfile

    import torch

    import paddle_tpu_torch as pt
    from paddle_tpu_torch.contrib import memory_usage, summary

    t0 = time.perf_counter()
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda, cpu = pt.CUDAPlace(0), pt.CPUPlace()
    out, secs = {}, {}
    try:
        # (a) five steps at batch 32 on one batch
        t = time.perf_counter()
        rng = np.random.RandomState(31)
        img = rng.rand(DYGRAPH_B, 3, DYGRAPH_HW, DYGRAPH_HW).astype(
            "float32")
        label = rng.randint(0, DYGRAPH_CLASSES, (DYGRAPH_B, 1)).astype(
            "int64")
        with pt.dygraph.guard(cuda):
            model = pt.dygraph.DataParallel(dygraph_resnet(pt))
            opt = dygraph_optimizer(pt, base_lr=DYGRAPH_LR)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            losses, ms, mem = [], [], []
            for _ in range(DYGRAPH_STEPS):
                s0 = time.perf_counter()
                loss = dygraph_step(pt, model, opt, img, label)
                model.clear_gradients()
                losses.append(float(loss.numpy().reshape(())))
                ms.append((time.perf_counter() - s0) * 1e3)
                mem.append(torch.cuda.memory_allocated())
            peak = torch.cuda.max_memory_allocated()
            check(all(np.isfinite(losses)) and losses[-1] < losses[0],
                  f"dygraph (a): the loss did not fall: {losses}")
            drift = abs(mem[4] - mem[1]) / mem[1]
            check(drift <= 0.01, f"dygraph (a): memory after step 5 "
                                 f"{mem[4]} against step 2's {mem[1]}")

            def step():
                dygraph_step(pt, model, opt, img, label)
                model.clear_gradients()

            traced_step = _profiled_step(step)
            sched = opt._learning_rate
            out["a_train"] = {
                "losses": losses, "step_ms": ms,
                "step_ms_median": statistics.median(ms[1:]),
                "memory_allocated_bytes": mem, "memory_drift": drift,
                "peak_bytes": peak, "lr_steps": sched.step_num,
                "traced_step": {k: traced_step[k] for k in (
                    "wall_ms", "device_busy_ms", "device_idle_share",
                    "device_events")},
                "top_kernels": traced_step["top_kernels"][:6]}
            secs["a"] = time.perf_counter() - t
            with tempfile.TemporaryDirectory() as root:
                # (c) the traced network at batch 32, (g) its numbers
                t = time.perf_counter()
                out["c_traced"], traced = dygraph_traced(pt, model, img,
                                                         root, cuda)
                lower, upper, unit = memory_usage(traced.program, DYGRAPH_B)
                with contextlib.redirect_stdout(io.StringIO()):
                    params, flops = summary(traced.program, DYGRAPH_B)
                scale = {"GB": 1 << 30, "MB": 1 << 20, "KB": 1 << 10,
                         "B": 1}[unit]
                out["g_contrib"] = {
                    "memory_usage_band_bytes": [lower * scale,
                                                upper * scale],
                    "traced_run_max_memory_allocated_bytes":
                        out["c_traced"]["run_max_memory_allocated_bytes"],
                    "allocated_before_the_run_bytes":
                        out["c_traced"]["allocated_before_the_run_bytes"],
                    "summary_params": params, "summary_flops": flops,
                    "a_step_ms_median": out["a_train"]["step_ms_median"],
                    # a train step is about 3 forwards' FLOPs
                    "train_tflop_s_at_3x_forward":
                        3 * flops / out["a_train"]["step_ms_median"] / 1e9}
                del traced
                secs["c_g"] = time.perf_counter() - t
                # (d) a checkpoint round trip
                t = time.perf_counter()
                out["d_checkpoint"] = dygraph_checkpoint(pt, model, root)
                secs["d"] = time.perf_counter() - t
        del model, opt, loss
        torch.cuda.empty_cache()
        # (b) the card against the CPU at batch 2
        t = time.perf_counter()
        out["b_parity"] = dygraph_parity(pt, cuda, cpu)
        secs["b"] = time.perf_counter() - t
        # (e) the zoo, (f) dropout's gradient
        t = time.perf_counter()
        out["e_zoo"] = dygraph_zoo(pt, cuda, cpu)
        out["f_dropout_kept"] = dygraph_dropout(pt, cuda)
        secs["e_f"] = time.perf_counter() - t
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags
    print(json.dumps({
        "phase": "dygraph", "card": card(),
        "model": f"dygraph ResNet-50 (models' dygraph/resnet/train.py), "
                 f"{DYGRAPH_CLASSES} classes, {DYGRAPH_B} x 3 x "
                 f"{DYGRAPH_HW}^2, f32 with TF32 off",
        **out, "limits": {"parity": DYGRAPH_TOL, "zoo": DYGRAPH_ZOO_TOL},
        "part_seconds": secs, "seconds": time.perf_counter() - t0}))
    torch.cuda.empty_cache()


# Phase 32: the book's sequence programs (BOOK_SEQUENCE) on the card
# through the fluid path, f32 with TF32 off: (a) understand_sentiment's
# stacked_lstm_net at full width, batch 128 x T 100, Adagrad; (b)
# label_semantic_roles' db_lstm at the book's widths with its CRF,
# batch 10; (c) machine_translation's GRU encoder-decoder at the book's
# widths, then its beam decode. Each trains on one batch; its first
# step is held against the port's CPU step from the same state, and
# (b)'s and (c)'s decodes against the CPU's. No kernel of the table
# runs here: these ops reach no Pallas kernel in the JAX package.
SEQ_STEPS = 5
SEQ_TOL = {"loss": 1e-4, "grad": 1e-3, "tie": 1e-5, "beam_score": 1e-5}
SEQ_SEED = 32


def _seq_grad_parity(pt, prog, feed, scope, exe):
    """One step on the card from `scope`'s state against the port's CPU
    step from a copy of it: (card fetches, loss relative error, the
    worst gradient's error over the step's largest, its parameter)."""
    main = prog["main"]
    params = [p.name for p in main.all_parameters() if p.trainable]
    fetch = [prog["loss"].name] + [p + "@GRAD" for p in params]
    cpu = _seq_cpu_scope(pt, prog, scope)
    got = [_fetched(v) for v in exe.run(main, feed=feed, fetch_list=fetch,
                                        scope=scope)]
    want = [_fetched(v) for v in pt.Executor(pt.CPUPlace()).run(
        main, feed=feed, fetch_list=fetch, scope=cpu)]
    loss_rel = abs(float(got[0].reshape(())) - float(want[0].reshape(()))) \
        / abs(float(want[0].reshape(())))
    scale = max(float(np.abs(w).max()) for w in want[1:])
    worst = max((float(np.abs(g.astype(np.float64) - w).max()) / scale, p)
                for p, g, w in zip(params, got[1:], want[1:]))
    check(loss_rel <= SEQ_TOL["loss"] and worst[0] <= SEQ_TOL["grad"],
          f"fluid sequence: the card's step against the CPU's: loss "
          f"{loss_rel}, gradient {worst}")
    return float(got[0].reshape(())), {
        "loss_rel": loss_rel, "grad_rel": worst[0], "worst_param": worst[1],
        "params": len(params)}


def _fetched(v):
    """A fetched value as an array (a sparse gradient, a SelectedRows,
    comes back in a 0-d object array)."""
    if isinstance(v, np.ndarray) and v.dtype == object:
        v = v.item()
    return np.asarray(v.to_dense().cpu() if hasattr(v, "to_dense") else v)


def _seq_train(pt, prog, feed, exe, label):
    """Startup, a first step held against the CPU, SEQ_STEPS - 1 more on
    the same batch (the loss finite and falling), one traced step, and
    the peak memory. Returns (scope, the program's row)."""
    import torch

    scope = pt.Scope()
    exe.run(prog["startup"], scope=scope)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    first, parity = _seq_grad_parity(pt, prog, feed, scope, exe)
    torch.cuda.synchronize()
    losses, ms = [first], [(time.perf_counter() - t0) * 1e3]
    for _ in range(SEQ_STEPS - 1):
        t0 = time.perf_counter()
        out = exe.run(prog["main"], feed=feed, fetch_list=[prog["loss"]],
                      scope=scope)
        losses.append(float(np.asarray(out[0]).reshape(())))
        ms.append((time.perf_counter() - t0) * 1e3)
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"fluid sequence ({label}): the loss did not fall: {losses}")
    traced = _profiled_step(lambda: exe.run(
        prog["main"], feed=feed, fetch_list=[prog["loss"]], scope=scope))
    row = {"losses": losses, "step_ms": ms,
           "step_ms_median": statistics.median(ms[1:]),
           "parity": parity, "peak_bytes": torch.cuda.max_memory_allocated(),
           "traced_step": {k: traced[k] for k in (
               "wall_ms", "device_busy_ms", "device_idle_share",
               "device_events")},
           "ops_a_step": len(prog["main"].desc.block(0).ops)}
    return scope, row


def _seq_cpu_scope(pt, prog, scope):
    """A CPU scope holding a copy of `scope`'s persistables."""
    from paddle_tpu_torch.convert import scope_from_numpy

    pers = [v.name for v in prog["startup"].list_vars() if v.persistable]
    return scope_from_numpy(pt.Scope(), {n: scope.get(n) for n in pers},
                            pt.CPUPlace())


def _srl_decode(pt, prog, feed, scope, exe):
    """(b)'s test program (crf_decoding, chunk_eval) on the card and on
    the CPU from the trained state: the paths equal, except a row whose
    two paths score within SEQ_TOL["tie"] (relative) of each other under
    the CPU's emission and transition."""
    f = prog["fetch"]
    keys = ("decode", "emission", "num_correct", "f1")
    got = exe.run(prog["test"], feed=feed, fetch_list=[f[k] for k in keys],
                  scope=scope)
    cpu = _seq_cpu_scope(pt, prog, scope)
    want = pt.Executor(pt.CPUPlace()).run(
        prog["test"], feed=feed, fetch_list=[f[k] for k in keys], scope=cpu)
    trans = cpu.get("crfw")
    ties, worst = 0, 0.0
    for i in range(feed["ln"].shape[0]):
        if np.array_equal(got[0][i], want[0][i]):
            continue
        n = int(feed["ln"][i])
        best = crf_path_score(want[1][i], trans, want[0][i], n)
        other = crf_path_score(want[1][i], trans, got[0][i], n)
        gap = abs(best - other) / max(1.0, abs(best))
        check(gap <= SEQ_TOL["tie"],
              f"fluid sequence (b): row {i}'s path differs from the CPU's "
              f"with a score gap of {gap}")
        ties += 1
        worst = max(worst, gap)
    return {"rows": int(feed["ln"].shape[0]), "rows_tied": ties,
            "worst_tie_gap": worst,
            "num_correct_chunks": [int(np.asarray(got[2]).reshape(())),
                                   int(np.asarray(want[2]).reshape(()))],
            "f1": [float(np.asarray(got[3]).reshape(())),
                   float(np.asarray(want[3]).reshape(()))]}


def _mt_tied(cands, k):
    """Whether a step's candidates (float64 [K, V] of one sentence) have
    two of their best k + 1 within SEQ_TOL["tie"] (relative)."""
    top = np.sort(cands.reshape(-1))[::-1][:k + 1]
    gaps = np.abs(np.diff(top)) / np.maximum(1.0, np.abs(top[1:]))
    return bool((gaps <= SEQ_TOL["tie"]).any())


def _mt_beams(pt, prog, src, scope, exe):
    """(c)'s decode on the card and on the CPU from the trained state:
    every sentence's steps, sentences and gather_tree trellis equal and
    its scores within SEQ_TOL["beam_score"], except a sentence whose
    CPU candidates tie at the first step where the two differ."""
    got = mt_decode(exe, prog, scope, src)
    want = mt_decode(pt.Executor(pt.CPUPlace()),
                     prog, _seq_cpu_scope(pt, prog, scope), src)
    tied, worst = [], 0.0
    for b in range(src.shape[0]):
        diff = [s for s in range(MT_LEN) if not np.array_equal(
            got["steps"][s, b], want["steps"][s, b])]
        if diff:
            check(_mt_tied(want["cands"][diff[0]][b], MT_BEAM),
                  f"fluid sequence (c): sentence {b} leaves the CPU's beams "
                  f"at step {diff[0]} with no tie there")
            tied.append(b)
            continue
        check(np.array_equal(got["sent"][b], want["sent"][b]) and
              np.array_equal(got["tree"][:, b], want["tree"][:, b]),
              f"fluid sequence (c): sentence {b}'s decode differs from the "
              f"CPU's on equal steps")
        err = float(np.abs(got["sent_sc"][b] - want["sent_sc"][b]).max() /
                    np.abs(want["sent_sc"][b]).max())
        check(err <= SEQ_TOL["beam_score"],
              f"fluid sequence (c): sentence {b}'s scores {err} from the CPU's")
        worst = max(worst, err)
    return {"sentences": int(src.shape[0]), "sentences_tied": tied,
            "worst_score_rel": worst, "sent_ids": got["sent"].tolist(),
            "sent_scores": got["sent_sc"].tolist(),
            "decode_step_ms": got["step_ms"],
            "decode_step_ms_median": statistics.median(got["step_ms"][1:])}


def phase_fluid_sequence():
    """Phase 32: the book's sequence programs ((a)-(c) above)."""
    import torch

    import paddle_tpu_torch as pt

    t0 = time.perf_counter()
    before = _kernel_counts()
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    exe = pt.Executor(pt.CUDAPlace(0))
    out, secs = {}, {}
    try:
        t = time.perf_counter()
        prog = sentiment_program(pt)
        feed = sentiment_feed(np.random.RandomState(SEQ_SEED))
        _, out["a_sentiment"] = _seq_train(pt, prog, feed, exe, "a")
        secs["a"] = time.perf_counter() - t
        torch.cuda.empty_cache()

        t = time.perf_counter()
        prog = srl_program(pt)
        feed = srl_feed(np.random.RandomState(SEQ_SEED))
        scope, out["b_srl"] = _seq_train(pt, prog, feed, exe, "b")
        out["b_srl"]["decode"] = _srl_decode(pt, prog, feed, scope, exe)
        secs["b"] = time.perf_counter() - t

        t = time.perf_counter()
        prog = mt_programs(pt)
        feed = mt_feed(np.random.RandomState(SEQ_SEED))
        scope, out["c_translation"] = _seq_train(pt, prog, feed, exe, "c")
        out["c_translation"]["beams"] = _mt_beams(pt, prog, feed["s"],
                                                  scope, exe)
        secs["c"] = time.perf_counter() - t
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags
    check(_kernel_counts() == before,
          "fluid sequence: a kernel of the table launched in phase 32")
    print(json.dumps({
        "phase": "fluid_sequence", "card": card(),
        "programs": "book understand_sentiment stacked_lstm_net (dict "
                    f"{SENT_VOCAB}, emb {SENT_EMB}, hid {SENT_HID}, "
                    f"{SENT_STACKED} lstms, batch {SENT_B} x T {SENT_T}, "
                    f"Adagrad {SENT_LR}); label_semantic_roles db_lstm "
                    f"(word_dim {SRL_WORD_DIM}, mark_dim {SRL_MARK_DIM}, "
                    f"hidden {SRL_HID}, depth {SRL_DEPTH}, batch {SRL_B}, "
                    f"T {SRL_T}; dictionaries and lengths of the JAX "
                    "package's synthetic conll05 reader, the book's CoNLL-05 "
                    "dictionaries not being in the repository); "
                    f"machine_translation (dict {MT_VOCAB}, word_dim "
                    f"{MT_WORD}, hidden {MT_HID}, beam {MT_BEAM}, max_length "
                    f"{MT_LEN}, batch {MT_B}); f32, TF32 off",
        **out, "limits": SEQ_TOL, "part_seconds": secs,
        "seconds": time.perf_counter() - t0}))
    torch.cuda.empty_cache()


# Phase 33: the compression toolkit (`slim/`) and the fake-quant and misc
# op types on the card, f32 with TF32 off: (a) quantization-aware
# training of the book's VGG-16-BN at full width (the card's first QAT
# step against the CPU's, 20 steps, the freeze pass, a Predictor on the
# frozen model), (b) the Compressor on the book's LeNet (sensitivity
# pruning then QAT, a distillation schedule, the bf16 transpiler on the
# frozen model), (c) a CTC ladder at an OCR-like size, (d) every new op
# type once against the port's CPU op. No kernel of the table runs
# here: the JAX package's slim/, quant and misc ops reach no Pallas
# kernel.
SLIM_QAT_STEPS = 20
# (a): a QAT step is chaotic across devices: an activation within f32
# noise of a rounding boundary flips one quantum, the flip moves the
# next batch norm's statistics, and the next layer's inputs then differ
# by far more than noise (measured on the H100: 6.7% of the quantized
# activations flipped by the last layer, the loss 1.6e-3 apart). So the
# card's step is held against the CPU's with every activation fake-quant
# output forced to the card's own (`forced_qat_program`): each fake op
# still runs on its device's input and updates its state, and the rest
# is f32 arithmetic held at VGG_TOL (loss, the gradients' F13 split,
# running stats); the quant state vars (scale, state, accum) relative,
# at the running stats' limit: an accum is a running statistic of its
# activation's abs-max, which carries the activation's own f32 noise
# (2.0e-6 on the H100, where the state's a-priori 1e-6 missed);
# the fake ops' own outputs by the share of grid indices that differ
# (each flip one quantum); each frozen weight against the value its
# fake-quant op gave: the pass rounds w / (amax / 127) where the op
# rounds w / amax * 127 (ROADMAP F24, the JAX package's), so a weight on
# a rounding boundary moves one quantum, held by the share of such
# weights, and the rest an ulp apart; the frozen program's
# probabilities against the QAT test program's with its activation
# fake-quant ops taken out (3.3e-5 and 1.1e-4 in two runs on the H100,
# with 7 and 12 weights a quantum apart: the card's weight gradients
# sum in a varying order, so the trained weights and their boundary
# cases vary from run to run; freezing bakes the
# weights' grid into them and drops the
# activations' quantization, by the JAX package's design; against the
# whole QAT program they move by up to 0.288 at VGG-16-BN's 16 quantized
# layers on the H100, where tests/test_slim.py:184 holds a 2-layer MLP
# at rtol = atol = 0.1: recorded, with the top-1 agreement); a frozen
# weight times 127 / its channel's scale off an integer; the frozen
# program on the card against the CPU's (probabilities, absolute)
SLIM_TOL = {"state": VGG_TOL["stats"], "flip_share": 1e-3,
            "baked_flip_share": 1e-3, "frozen_weights": 1e-3, "grid": 1e-4,
            "frozen_cpu": 1e-5}
LENET_B = 64
# Adam 1e-3: at models/lenet's default 0.01 the card's initial draw
# (its generator's numbers, not the CPU's) left every ReLU dead within
# 10 steps, the loss at ln 10
LENET_LR = 1e-3
LENET_EPOCH_STEPS = 30
LENET_EPOCHS = 4
LENET_EVAL_B = 512
LENET_TEACHER_STEPS = 30
# tests/test_slim.py:279-291's schedule, as a dict (the card has no
# PyYAML): sensitivity pruning at epoch 1, QAT at epoch 2, 4 epochs
LENET_PRUNE_DROP = 0.1
LENET_PRUNE_RATIOS = (0.3, 0.5, 0.7)
LENET_ZERO_SHARE = 0.2
LENET_EVAL_SLACK = 0.15
# bf16 logits, card against CPU: steps of bf16 (8 bits of mantissa) at
# the largest logit
BF16_STEPS = 2
# (c): batch 32, 64 frames, 95 characters and the blank, labels of 4-24
# tokens, frames 48-64; Adam 0.05 for 100 steps
CTC_B, CTC_T, CTC_C = 32, 64, 96
CTC_LABELS = (4, 24)
CTC_FRAMES = (48, 64)
CTC_STEPS = 100
CTC_LR = 0.05
# warpctc card against CPU: loss relative; WarpCTCGrad against its
# largest value, an infeasible row's at 5e-3 (its log-alphas sit near
# optax's -1e5 stand-in for log 0, where f32's step is 0.0078)
CTC_TOL = {"loss": 1e-5, "grad": 1e-5, "grad_infeasible": 5e-3,
           "tie": 1e-5}
# (d): card against CPU by class: exact, elementwise and losses, products
SWEEP_TOL = {"exact": (0.0, 0.0), "ew": (1e-5, 1e-6), "mm": (1e-4, 1e-4)}


def _peak_reset():
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()


def _peak():
    import torch

    return torch.cuda.max_memory_allocated()


def quant_state_names(main):
    return sorted(n for n in main.global_block().desc.vars
                  if n.endswith((".quant_in_scale", ".quant_state",
                                 ".quant_accum")))


def _act_quant_ops(main):
    return [op for op in main.desc.block(0).ops
            if op.type == "fake_quantize_dequantize_moving_average_abs_max"]


def quant_flips(ops, got, want, s_got, s_want):
    """The outputs of the activation fake-quant `ops` of one step on two
    devices (`got`, `want`: one array an op, each scope holding the
    scales that step used): (elements whose grid index differs, all
    elements, the largest index difference)."""
    flips = total = worst = 0
    for op, g, w in zip(ops, got, want):
        scale = op.outputs["OutScale"][0]
        kg = np.rint(g.astype(np.float64) * 127 / s_got.get(scale)[0])
        kw = np.rint(w.astype(np.float64) * 127 / s_want.get(scale)[0])
        d = np.abs(kg - kw)
        flips += int((d > 0).sum())
        total += d.size
        worst = max(worst, int(d.max()))
    return flips, total, worst


def forced_qat_program(main):
    """A clone of the QAT program `main` whose activation fake-quant ops
    write `<out>.computed` in place of `<out>`, which the convs and muls
    still read and the caller feeds. Each fake op still runs and updates
    its state."""
    import copy

    prog = main.clone()
    block = prog.desc.block(0)
    for op in _act_quant_ops(prog):
        out = op.outputs["Out"][0]
        var = copy.deepcopy(block.vars[out])
        var.name = out + ".computed"
        block.vars[var.name] = var
        op.outputs["Out"] = [var.name]
    prog._rebuild_from_desc()
    return prog


def qat_vgg_parity(pt, place, cpu, width=1, batch=VGG_B):
    """(a)'s gate: the QAT program's first step on `place` against the
    CPU's from one scope (drop 0), the activation fake-quant outputs
    forced to `place`'s own. Returns (program pieces, the scope on
    `place` after that step, the row)."""
    from paddle_tpu_torch.convert import scope_from_numpy
    from paddle_tpu_torch.slim import QuantizationTransformPass

    main, startup, test_prog, loss, acc = vgg_bn_program(pt, drop=0.0,
                                                         width=width)
    # taken before the pass: a program rebuilt from its desc marks every
    # parameter trainable, the running stats too
    params = [p.name for p in main.all_parameters() if p.trainable]
    QuantizationTransformPass().apply(main, startup)
    QuantizationTransformPass().apply(test_prog)
    stats = bn_stat_names(main)
    ops = _act_quant_ops(main)
    acts = [op.outputs["Out"][0] for op in ops]
    forced = forced_qat_program(main)
    fetch = [loss.name, acc.name] + [n + "@GRAD" for n in params] + \
        [a + ".computed" for a in acts]
    exe, exe_cpu = pt.Executor(place), pt.Executor(cpu)
    s0 = pt.Scope()
    exe_cpu.run(startup, scope=s0)
    init = {v.name: s0.get(v.name) for v in startup.list_vars()
            if v.persistable}
    img, label = synthetic_cifar(batch, seed=33)
    feed = {"img": img, "label": label}
    own = exe.run(main, feed=feed, fetch_list=acts,
                  scope=scope_from_numpy(pt.Scope(), init, place))
    feed.update(zip(acts, own))
    sc = scope_from_numpy(pt.Scope(), init, place)
    sh = scope_from_numpy(pt.Scope(), init, cpu)
    got = exe.run(forced, feed=feed, fetch_list=fetch, scope=sc)
    want = exe_cpu.run(forced, feed=feed, fetch_list=fetch, scope=sh)
    k = 2 + len(params)
    worst = _vgg_worst(main, got[:k], want[:k], params, stats, sc, sh)
    states = quant_state_names(main)
    worst["state"] = max(float(np.abs(sc.get(n) - sh.get(n)).max() /
                               np.abs(sh.get(n)).max()) for n in states)
    flips, total, biggest = quant_flips(ops, got[k:], want[k:], sc, sh)
    worst["flip_share"] = flips / total
    for key, lim in list(VGG_TOL.items()) + [
            ("state", SLIM_TOL["state"]),
            ("flip_share", SLIM_TOL["flip_share"])]:
        check(worst[key] <= lim, f"slim (a): the QAT step's {key} differs "
              f"by {worst[key]} (limit {lim}): {worst}")
    check(biggest <= 1, f"slim (a): a fake-quant output moved by {biggest} "
          "quanta")
    prog = {"main": main, "startup": startup, "test": test_prog,
            "loss": loss, "params": params, "states": states}
    return prog, sc, {"card_vs_cpu_worst": worst, "quant_ops": sum(
        op.type.startswith("fake_") for op in main.desc.block(0).ops),
        "state_vars": len(states), "flips": flips,
        "quantized_elements": total,
        # the forced step's own fake-quant outputs against the unforced
        # step's on the same card and inputs
        "forced_equals_own": all(np.array_equal(g, o)
                                 for g, o in zip(got[k:], own))}


def without_activation_quant(program):
    """A clone of a QAT program with its activation fake-quant ops taken
    out, their consumers reading the ops' inputs: the weights' grid
    only."""
    prog = program.clone(for_test=program._is_test)
    block = prog.desc.block(0)
    drop = {op.outputs["Out"][0]: op.inputs["X"][0]
            for op in _act_quant_ops(prog)}
    block.ops = [op for op in block.ops
                 if op.type != "fake_quantize_dequantize_moving_average_"
                 "abs_max"]
    for op in block.ops:
        for slot, names in op.inputs.items():
            op.inputs[slot] = [drop.get(n, n) for n in names]
    prog._rebuild_from_desc()
    return prog


def qat_vgg_freeze(pt, prog, scope, place, cpu, root, batch=VGG_B):
    """(a)'s freeze: the QAT test program's probabilities, whole and
    with its activation quantization taken out, then
    QuantizationFreezePass on it: no fake op left, every frozen weight on
    its channel's int8 grid, the frozen probabilities within
    SLIM_TOL["frozen_weights"] of the weights-only QAT ones (the whole
    QAT program's recorded) and within SLIM_TOL["frozen_cpu"] of the
    CPU's from the same scope; then the model saved and served by a
    Predictor on `place`, whose replies equal the executor's."""
    from paddle_tpu_torch.convert import scope_from_numpy
    from paddle_tpu_torch.core.executor import scope_guard
    from paddle_tpu_torch.inference import (AnalysisConfig,
                                            create_paddle_predictor)
    from paddle_tpu_torch.slim import QuantizationFreezePass

    test = prog["test"]
    exe = pt.Executor(place)
    predict = next(op.inputs["X"][0] for op in test.desc.block(0).ops
                   if op.type == "cross_entropy")
    img, label = synthetic_cifar(batch, seed=34)
    feed = {"img": img, "label": label}
    qat = exe.run(test, feed=feed, fetch_list=[predict], scope=scope)[0]
    axes = {op.inputs["X"][0]: int(op.attrs.get("quant_axis", 0))
            for op in test.desc.block(0).ops
            if op.type == "fake_channel_wise_quantize_dequantize_abs_max"}
    qat_w, *faked = exe.run(without_activation_quant(test), feed=feed,
                            fetch_list=[predict] + [w + ".quantized"
                                                    for w in axes],
                            scope=scope)
    before = {w: scope.get(w) for w in axes}
    frozen = QuantizationFreezePass().apply(test, scope)
    left = [op.type for op in frozen.desc.block(0).ops
            if op.type.startswith("fake_")]
    check(not left, f"slim (a): the frozen program keeps {left}")
    grid, flips, total, moved = 0.0, 0, 0, 0
    for (w, axis), fake in zip(axes.items(), faked):
        red = tuple(i for i in range(before[w].ndim) if i != axis)
        sc = np.abs(before[w]).max(axis=red, keepdims=True) / 127.0
        q = scope.get(w).astype(np.float64) / sc
        grid = max(grid, float(np.abs(q - np.rint(q)).max()))
        d = np.rint(np.abs(q - fake.astype(np.float64) / sc))
        flips += int((d > 0).sum())
        total += d.size
        moved = max(moved, int(d.max()))
    baked = flips / total
    out = exe.run(frozen, feed=feed, fetch_list=[predict], scope=scope)[0]
    freeze_err = float(np.abs(out - qat_w).max())
    check(freeze_err <= SLIM_TOL["frozen_weights"] and
          grid <= SLIM_TOL["grid"] and moved <= 1 and
          baked <= SLIM_TOL["baked_flip_share"],
          f"slim (a): frozen against the weights-only QAT program "
          f"{freeze_err}, grid {grid}, baked weights off the fake op's "
          f"grid index: {flips} of {total}, by up to {moved}")
    pers = {v.name: scope.get(v.name) for v in frozen.list_vars()
            if v.persistable and scope.find_var(v.name) is not None}
    cpu_scope = scope_from_numpy(pt.Scope(), pers, cpu)
    ref = pt.Executor(cpu).run(frozen, feed=feed, fetch_list=[predict],
                               scope=cpu_scope)[0]
    cpu_err = float(np.abs(out - ref).max())
    check(cpu_err <= SLIM_TOL["frozen_cpu"],
          f"slim (a): the frozen program on the card against the CPU: "
          f"{cpu_err}")
    d = os.path.join(root, "vgg_frozen")
    with scope_guard(scope):
        pt.io.save_inference_model(d, ["img"], [predict], exe,
                                   main_program=frozen)
    cfg = AnalysisConfig(d)
    if place.torch_device().type == "cpu":
        cfg.disable_gpu()
    reply = create_paddle_predictor(cfg).predict(img=img)[predict]
    check(np.array_equal(reply, out),
          f"slim (a): the Predictor's replies differ from the executor's "
          f"by {float(np.abs(reply - out).max())}")
    return {"frozen_vs_weights_only_qat_max_abs": freeze_err,
            "frozen_vs_qat_max_abs": float(np.abs(out - qat).max()),
            "frozen_vs_qat_mean_abs": float(np.abs(out - qat).mean()),
            "frozen_vs_qat_top1_agreement": float(
                (out.argmax(1) == qat.argmax(1)).mean()),
            "top1_accuracy": {name: float((p.argmax(1) == label[:, 0]).mean())
                              for name, p in (("qat", qat), ("weights_only",
                                                              qat_w),
                                              ("frozen", out))},
            "grid_worst": grid, "baked_flips": flips,
            "baked_flip_share": baked,
            "frozen_card_vs_cpu": cpu_err, "frozen_weights": len(axes),
            "frozen_ops": len(frozen.desc.block(0).ops)}


def slim_qat_vgg(pt, root):
    """Phase 33 (a) on the card."""
    import torch

    cuda, cpu = pt.CUDAPlace(0), pt.CPUPlace()
    _peak_reset()
    prog, scope, row = qat_vgg_parity(pt, cuda, cpu)
    exe = pt.Executor(cuda)
    img, label = synthetic_cifar(VGG_B * SLIM_QAT_STEPS, seed=35)
    losses, ms = [], []
    for i in range(SLIM_QAT_STEPS):
        b = slice(i * VGG_B, (i + 1) * VGG_B)
        t0 = time.perf_counter()
        out = exe.run(prog["main"], feed={"img": img[b], "label": label[b]},
                      fetch_list=[prog["loss"]], scope=scope)
        losses.append(float(out[0][0]))
        ms.append((time.perf_counter() - t0) * 1e3)
    check(all(np.isfinite(losses)) and
          np.mean(losses[-5:]) < np.mean(losses[:5]),
          f"slim (a): the QAT loss did not fall: {losses}")
    traced = _profiled_step(lambda: exe.run(
        prog["main"], feed={"img": img[:VGG_B], "label": label[:VGG_B]},
        fetch_list=[prog["loss"]], scope=scope))
    row.update({"losses": losses, "step_ms": ms,
                "step_ms_median": statistics.median(ms[2:]),
                "traced_step": {k: traced[k] for k in (
                    "wall_ms", "device_busy_ms", "device_idle_share",
                    "device_events")},
                "top_kernels": traced["top_kernels"][:5],
                "peak_bytes": _peak()})
    row.update(qat_vgg_freeze(pt, prog, scope, cuda, cpu, root))
    torch.cuda.empty_cache()
    return row


def _lenet_logits(main):
    return next(op.inputs["Logits"][0] for op in main.desc.block(0).ops
                if op.type == "softmax_with_cross_entropy")


def _lenet(pt, seed):
    from paddle_tpu_torch.models import lenet

    with pt.framework.unique_name.guard():
        main, startup, _, loss, acc = lenet.build_program(pt, lr=LENET_LR)
    main.random_seed = startup.random_seed = seed
    return main, startup, loss, acc


def lenet_compress(pt, place, steps=LENET_EPOCH_STEPS, epochs=LENET_EPOCHS,
                   batch=LENET_B, eval_b=LENET_EVAL_B):
    """(b)'s Compressor run: the book's LeNet (Adam LENET_LR) under the
    prune-then-QAT schedule, eval its accuracy on a held-out batch (the
    last above 0.4, as tests/test_slim.py holds it).
    Returns (main, scope, the row)."""
    from paddle_tpu_torch.slim.core import Compressor

    main, startup, loss, acc = _lenet(pt, seed=33)
    x, y = synthetic_mnist(batch * steps, seed=33)
    ex, ey = synthetic_mnist(eval_b, seed=34)
    params = [p.name for p in main.all_parameters()
              if p.name.endswith(".w_0")]

    def train_reader():
        for i in range(steps):
            b = slice(i * batch, (i + 1) * batch)
            yield {"img": x[b], "label": y[b]}

    def eval_func(program, executor, scope):
        return float(executor.run(program, feed={"img": ex, "label": ey},
                                  fetch_list=[acc], scope=scope)[0][0])

    config = {"strategies": {
        "prune": {"class": "SensitivePruneStrategy", "start_epoch": 1,
                  "max_metric_drop": LENET_PRUNE_DROP,
                  "sensitivity_ratios": list(LENET_PRUNE_RATIOS),
                  "pruned_params": params},
        "quant": {"class": "QuantizationStrategy", "start_epoch": 2}},
        "compressor": {"epoch": epochs}}
    scope = pt.Scope()
    t0 = time.perf_counter()
    comp = Compressor(place, scope, main, startup,
                      train_reader=train_reader, train_fetch_list=[loss],
                      eval_func=eval_func).config(config)
    ctx = comp.run()
    seconds = time.perf_counter() - t0
    fakes = sum(op.type.startswith("fake_") for op in main.desc.block(0).ops)
    zeros = sum(int((scope.get(n) == 0).sum()) for n in params)
    total = sum(scope.get(n).size for n in params)
    hist = ctx.eval_history
    check(fakes > 0 and zeros > LENET_ZERO_SHARE * total and
          hist[-1] >= max(hist) - LENET_EVAL_SLACK and hist[-1] > 0.4,
          f"slim (b): fake ops {fakes}, zero weights {zeros} of {total}, "
          f"evals {hist}")
    return main, scope, {"run_s": seconds, "eval_history": hist,
                         "chosen_ratios": comp.strategies[0].chosen,
                         "zero_share": zeros / total, "fake_ops": fakes,
                         "steps": steps * epochs}


def lenet_distill(pt, place, steps=LENET_EPOCH_STEPS // 3,
                  teacher_steps=LENET_TEACHER_STEPS, batch=LENET_B,
                  eval_b=LENET_EVAL_B):
    """(b)'s distillation schedule (tests/test_slim.py:446): a LeNet
    teacher trained `teacher_steps` steps, spliced frozen into a LeNet
    student's program with a soft-label loss, active for epochs 1-2 of
    4; the student's eval loss must fall."""
    from paddle_tpu_torch.slim import distillation
    from paddle_tpu_torch.slim.core import Compressor, _strip_training_ops

    x, y = synthetic_mnist(batch * max(steps, teacher_steps), seed=36)
    ex, ey = synthetic_mnist(eval_b, seed=37)
    t_main, t_start, t_loss, _ = _lenet(pt, seed=21)
    scope = pt.Scope()
    exe = pt.Executor(place)
    exe.run(t_start, scope=scope)
    for i in range(teacher_steps):
        b = slice(i * batch, (i + 1) * batch)
        exe.run(t_main, feed={"img": x[b], "label": y[b]},
                fetch_list=[t_loss], scope=scope)
    t_infer = _strip_training_ops(t_main)
    s_main, s_start, s_loss, _ = _lenet(pt, seed=22)
    distill = s_main.clone()
    rename = distillation.merge(t_infer, distill,
                                data_names=["img", "label"])
    distillation.init_teacher_scope(scope, rename)
    with pt.program_guard(distill, s_start):
        soft = distillation.soft_label_loss(
            distill.global_block().var(rename[_lenet_logits(t_main)]),
            distill.global_block().var(_lenet_logits(s_main)))
        pt.optimizer.Adam(learning_rate=LENET_LR).minimize(
            soft, parameter_list=[p for p in distill.all_parameters()
                                  if not p.name.startswith("teacher_")])

    def train_reader():
        for i in range(steps):
            b = slice(i * batch, (i + 1) * batch)
            yield {"img": x[b], "label": y[b]}

    def eval_func(program, executor, scope_):
        return -float(executor.run(program, feed={"img": ex, "label": ey},
                                   fetch_list=[s_loss],
                                   scope=scope_)[0].reshape(()))

    t0 = time.perf_counter()
    comp = Compressor(place, scope, s_main, s_start,
                      train_reader=train_reader, train_fetch_list=[s_loss],
                      eval_func=eval_func, distill_program=distill).config({
                          "strategies": {"distill": {
                              "class": "DistillationStrategy",
                              "start_epoch": 1, "end_epoch": 2}},
                          "compressor": {"epoch": 4}})
    ctx = comp.run()
    hist = [-v for v in ctx.eval_history]
    check(comp.strategies[0].distilled_epochs == [1, 2] and
          ctx.active_program is s_main and hist[-1] < hist[0],
          f"slim (b): distillation epochs "
          f"{comp.strategies[0].distilled_epochs}, student losses {hist}")
    return {"run_s": time.perf_counter() - t0, "student_losses": hist,
            "distilled_epochs": comp.strategies[0].distilled_epochs}


def lenet_bf16(pt, main, scope, place, cpu, root, batch=LENET_B):
    """(b)'s float16_transpile: the compressed LeNet saved, loaded on
    `place` and on the CPU, frozen and transpiled to bf16 in each; the
    logits within BF16_STEPS steps of bf16 at the largest logit."""
    from paddle_tpu_torch.core.executor import scope_guard
    from paddle_tpu_torch.slim import QuantizationFreezePass, \
        float16_transpile

    d = os.path.join(root, "lenet_compressed")
    logits = _lenet_logits(main)
    with scope_guard(scope):
        pt.io.save_inference_model(d, ["img"], [logits], pt.Executor(place),
                                   main_program=main)
    img, _ = synthetic_mnist(batch, seed=38)
    outs = []
    for where in (place, cpu):
        exe = pt.Executor(where)
        s = pt.Scope()
        with scope_guard(s):
            prog, _, _ = pt.io.load_inference_model(d, exe)
        QuantizationFreezePass().apply(prog, s)
        float16_transpile(prog, s, target_vars=[logits], dtype="bfloat16")
        outs.append(exe.run(prog, feed={"img": img}, fetch_list=[logits],
                            scope=s)[0])
    top = float(np.abs(outs[1]).max())
    step = 2.0 ** (np.floor(np.log2(top)) - 7)
    err = float(np.abs(outs[0] - outs[1]).max())
    check(outs[0].dtype == np.float32 and err <= BF16_STEPS * step,
          f"slim (b): bf16 logits card against CPU {err} (limit "
          f"{BF16_STEPS} x {step})")
    return {"bf16_card_vs_cpu_max_abs": err, "bf16_step_at_top": step,
            "largest_logit": top}


def ctc_ladder(B=CTC_B, T=CTC_T, C=CTC_C, labels=CTC_LABELS,
               frames=CTC_FRAMES, seed=33):
    """tests/test_misc_ops.py:334's ladder at a given size, with lengths:
    row i's frames one-hot on the label each of its llen_i frames
    stretches over, plus noise N(0, 0.1): (feats [B, T, C] f32, labels
    [B, Lmax] int64 padded with 0, label lengths, frame lengths)."""
    rng = np.random.RandomState(seed)
    ylen = rng.randint(labels[0], labels[1] + 1, B).astype("int64")
    llen = rng.randint(frames[0], frames[1] + 1, B).astype("int64")
    lab = np.zeros((B, labels[1]), "int64")
    feats = rng.randn(B, T, C).astype("float32") * 0.1
    for i in range(B):
        lab[i, :ylen[i]] = rng.randint(1, C, ylen[i])
        for t in range(llen[i]):
            feats[i, t, lab[i, min(t * ylen[i] // llen[i], ylen[i] - 1)]] \
                += 1.0
    return feats, lab, ylen, llen


def ctc_programs(pt, T, C, L, lr=CTC_LR):
    """The ladder's train program (fc over the frames, warpctc with
    lengths, mean, Adam) and its decode program (softmax,
    ctc_greedy_decoder, edit_distance against the labels)."""
    with pt.framework.unique_name.guard():
        main, startup = pt.Program(), pt.Program()
        with pt.program_guard(main, startup):
            x = pt.layers.data(name="x", shape=[T, C], dtype="float32")
            y = pt.layers.data(name="y", shape=[L], dtype="int64")
            yl = pt.layers.data(name="yl", shape=[1], dtype="int64")
            xl = pt.layers.data(name="xl", shape=[1], dtype="int64")
            logits = pt.layers.fc(x, size=C, num_flatten_dims=2)
            loss = pt.layers.mean(pt.layers.warpctc(
                logits, y, blank=0, input_length=xl, label_length=yl))
            pt.optimizer.Adam(learning_rate=lr).minimize(loss)
    with pt.framework.unique_name.guard():
        infer = pt.Program()
        with pt.program_guard(infer, pt.Program()):
            x = pt.layers.data(name="x", shape=[T, C], dtype="float32")
            y = pt.layers.data(name="y", shape=[L], dtype="int64")
            yl = pt.layers.data(name="yl", shape=[1], dtype="int64")
            xl = pt.layers.data(name="xl", shape=[1], dtype="int64")
            probs = pt.layers.softmax(pt.layers.fc(x, size=C,
                                                   num_flatten_dims=2))
            dec, dec_len = pt.layers.ctc_greedy_decoder(probs, blank=0,
                                                        input_length=xl)
            dist, _ = pt.layers.edit_distance(dec, y, normalized=False,
                                              input_length=dec_len,
                                              label_length=yl)
    return main, startup, infer, loss, dist, probs


def op_call(op_type, ins, attrs, device, outputs=None, rng_key=None):
    """One kernel call through the port's registry on `device`, numpy in
    and out (None stays None)."""
    import torch

    from paddle_tpu_torch.core.async_exec import to_numpy
    from paddle_tpu_torch.core.ir import OpDesc
    from paddle_tpu_torch.core.registry import KernelCtx, get_op_def

    names = {k: [f"{k}{i}" for i in range(len(v))] for k, v in ins.items()}
    desc = OpDesc(type=op_type, inputs=names, outputs=outputs or {},
                  attrs=attrs)
    ctx = KernelCtx(desc, rng_key=rng_key, device=device)
    vals = {k: [None if a is None else torch.from_numpy(
        np.array(a)).to(device) for a in v] for k, v in ins.items()}
    with torch.no_grad():
        outs = get_op_def(op_type).call(vals, attrs, ctx)
    return {k: [None if o is None else to_numpy(o) for o in v]
            for k, v in outs.items()}


def ctc_op_parity(feats, lab, ylen, llen, device):
    """warpctc's Loss and WarpCTCGrad on `device` against the CPU's on
    the ladder's inputs, with the last row's label made infeasible (L
    repeats of one token in L frames, where 2 L - 1 are needed; L 24 at
    the ladder's size): the worst errors."""
    lab, llen, ylen = lab.copy(), llen.copy(), ylen.copy()
    lab[-1, :] = 7
    ylen[-1] = llen[-1] = lab.shape[1]
    ins = {"Logits": [feats], "Label": [lab], "LogitsLength": [llen],
           "LabelLength": [ylen]}
    outs = {"Loss": ["l"], "WarpCTCGrad": ["g"]}
    got = op_call("warpctc", ins, {"blank": 0}, device, outs)
    want = op_call("warpctc", ins, {"blank": 0}, "cpu", outs)
    lg, lw = got["Loss"][0], want["Loss"][0]
    gg, gw = got["WarpCTCGrad"][0], want["WarpCTCGrad"][0]
    top = float(np.abs(gw).max())
    worst = {"loss": float((np.abs(lg - lw) / np.abs(lw)).max()),
             "grad": float(np.abs(gg[:-1] - gw[:-1]).max()) / top,
             "grad_infeasible": float(np.abs(gg[-1] - gw[-1]).max()) / top,
             "infeasible_loss": float(lw[-1, 0])}
    for key in ("loss", "grad", "grad_infeasible"):
        check(worst[key] <= CTC_TOL[key], f"slim (c): warpctc's {key} on "
              f"the card against the CPU: {worst[key]} (limit "
              f"{CTC_TOL[key]})")
    check(np.isfinite(lg).all() and lw[-1, 0] > 1e4,
          f"slim (c): the infeasible row's loss {lw[-1, 0]}")
    return worst


def _decode_ties(probs, got, want, xl, rel):
    """The rows where the two decodes' distances differ and every frame
    whose argmax differs has its top two within `rel` (relative)."""
    tied = []
    for i in np.nonzero(got != want)[0]:
        top2 = np.sort(probs[i, :xl[i]], axis=-1)[:, -2:]
        gaps = (top2[:, 1] - top2[:, 0]) / np.maximum(top2[:, 1], 1e-30)
        check((gaps <= rel).any(), f"slim (c): row {i}'s edit distance "
              f"{got[i]} against the CPU's {want[i]} with no tie")
        tied.append(int(i))
    return tied


def slim_ctc(pt, place, cpu, steps=CTC_STEPS, **size):
    """Phase 33 (c): the op against the CPU, 100 Adam steps (the loss
    halves), the greedy decode's edit distances against the CPU's."""
    from paddle_tpu_torch.convert import scope_from_numpy

    feats, lab, ylen, llen = ctc_ladder(**size)
    B, T, C = feats.shape
    op = ctc_op_parity(feats, lab, ylen, llen, place.torch_device())
    main, startup, infer, loss, dist, probs = ctc_programs(
        pt, T, C, lab.shape[1])
    exe = pt.Executor(place)
    scope = pt.Scope()
    exe.run(startup, scope=scope)
    feed = {"x": feats, "y": lab, "yl": ylen[:, None], "xl": llen[:, None]}
    losses, ms = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        losses.append(float(exe.run(main, feed=feed, fetch_list=[loss],
                                    scope=scope)[0].reshape(())))
        ms.append((time.perf_counter() - t0) * 1e3)
    check(np.isfinite(losses).all() and losses[-1] < 0.5 * losses[0],
          f"slim (c): the CTC loss {losses[0]} -> {losses[-1]} (must halve)")
    traced = _profiled_step(lambda: exe.run(
        main, feed=feed, fetch_list=[loss], scope=scope)) \
        if place.torch_device().type == "cuda" else None
    pers = {v.name: scope.get(v.name) for v in startup.list_vars()
            if v.persistable}
    got = exe.run(infer, feed=feed, fetch_list=[dist, probs], scope=scope)
    want = pt.Executor(cpu).run(infer, feed=feed, fetch_list=[dist, probs],
                                scope=scope_from_numpy(pt.Scope(), pers,
                                                       cpu))
    d_got, d_want = got[0][:, 0], want[0][:, 0]
    tied = _decode_ties(want[1], d_got, d_want, llen, CTC_TOL["tie"])
    return {"op_card_vs_cpu": op, "losses_first_last": [losses[0],
                                                        losses[-1]],
            "step_ms": ms[:5] + ms[-5:],
            "step_ms_median": statistics.median(ms[1:]),
            "traced_step": None if traced is None else {k: traced[k] for k in (
                "wall_ms", "device_busy_ms", "device_idle_share",
                "device_events")},
            "mean_edit_distance": float(d_got.mean()),
            "rows_tied": tied, "frames": int(llen.sum()),
            "label_tokens": int(ylen.sum())}


def _py_funcs():
    def fwd(x, y):
        return np.tanh(x) * 2.0, (x.sum(1) + y.sum(1)).astype("float64")

    def bwd(x, y, out0, out1, g0, g1):
        return g0 * 2.0 * (1.0 - np.tanh(x) ** 2) + g1[:, None], None

    return fwd, bwd


def sweep_cases(rng):
    """(d)'s cases: (op type, inputs, attrs, class), at the shapes of
    tests/test_misc_ops.py and tests/test_round2b_ops.py; every one of
    the 43 op types this slice adds but the four random ones, which
    `sweep_random` holds by their law."""
    from paddle_tpu_torch.ops.misc import register_py_func

    def n(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype("float32")

    def i64(*v):
        return np.array(v, "int64")

    def f32(*v):
        return np.array(v, "float32")

    w = n(4, 3, 2, 2, scale=4.0)
    st = {"InScale": [f32(0.7)], "InState": [f32(1.3)],
          "InAccum": [f32(0.9)]}
    fwd, bwd = _py_funcs()
    hyps = i64([1, 2, 3, 0, 5], [1, 1, 1, 1, 1], [4, 0, 2, 0, 2],
               [3, 3, 1, 2, 4])
    refs = i64([1, 3, 3, 0, 0, 2], [2, 2, 2, 2, 0, 0], [4, 2, 0, 2, 1, 1],
               [0, 0, 0, 0, 0, 0])
    return [
        ("fake_quantize_dequantize_abs_max", {"X": [w]}, {"bit_length": 8},
         "exact"),
        ("fake_channel_wise_quantize_dequantize_abs_max", {"X": [w]},
         {"bit_length": 8, "quant_axis": 0}, "exact"),
        ("fake_quantize_dequantize_moving_average_abs_max",
         dict(st, X=[w]), {"bit_length": 8, "moving_rate": 0.9}, "exact"),
        ("fake_quantize_abs_max", {"X": [w]}, {"bit_length": 8}, "exact"),
        ("fake_channel_wise_quantize_abs_max", {"X": [w]},
         {"bit_length": 8, "quant_axis": 0}, "exact"),
        ("fake_quantize_range_abs_max",
         {"X": [w], "InScale": [f32(3.0)], "Iter": [i64(5)],
          "InScales": [f32(9.0, 1.0, 2.0)]},
         {"bit_length": 8, "window_size": 3}, "exact"),
        ("fake_quantize_moving_average_abs_max", dict(st, X=[w]),
         {"bit_length": 8, "moving_rate": 0.8}, "exact"),
        ("fake_dequantize_max_abs",
         {"X": [rng.randint(-127, 128, (3, 4)).astype("float32")],
          "Scale": [f32(2.5)]}, {"max_range": 127.0}, "exact"),
        ("fake_channel_wise_dequantize_max_abs",
         {"X": [rng.randint(-127, 128, (4, 3, 2, 2)).astype("float32")],
          "Scales": [f32(1.5, 0.5, 2.0, 3.0), f32(0.25)]},
         {"quant_bits": [8, 8], "quant_axis": 0}, "exact"),
        ("moving_average_abs_max_scale",
         {"X": [w], "InState": st["InState"], "InAccum": st["InAccum"]},
         {"moving_rate": 0.9}, "exact"),
        ("affine_channel", {"X": [n(2, 3, 4, 4)], "Scale": [n(3)],
                            "Bias": [n(3)]}, {}, "ew"),
        ("affine_grid", {"Theta": [n(2, 2, 3)]},
         {"output_shape": [2, 1, 3, 4]}, "mm"),
        ("lrn", {"X": [rng.uniform(0.5, 2.0, (1, 6, 3, 3)).astype(
            "float32")]}, {"n": 5, "k": 2.0, "alpha": 1e-4, "beta": 0.75},
         "ew"),
        ("data_norm", {"X": [n(4, 3)], "BatchSize": [f32(2.0, 3.0, 4.0)],
                       "BatchSum": [n(3)],
                       "BatchSquareSum": [f32(10.0, 20.0, 30.0)]}, {}, "ew"),
        ("shuffle_channel", {"X": [n(2, 6, 2, 2)]}, {"group": 3}, "exact"),
        ("space_to_depth", {"X": [n(1, 2, 4, 4)]}, {"blocksize": 2},
         "exact"),
        ("unfold", {"X": [n(1, 2, 5, 5)]},
         {"kernel_sizes": [2, 3], "strides": [2, 1],
          "paddings": [1, 0, 0, 1], "dilations": [1, 2]}, "exact"),
        ("crop", {"X": [n(2, 3, 4)]}, {"shape": [1, 2, 2],
                                      "offsets": [1, 1, 2]}, "exact"),
        ("crop_tensor", {"X": [n(2, 3, 4)], "Offsets": [i64(1, 5, -3)]},
         {"shape": [-1, 2, 2]}, "exact"),
        ("add_position_encoding", {"X": [n(2, 5, 8)]},
         {"alpha": 0.5, "beta": 2.0}, "ew"),
        ("rank_loss", {"Label": [rng.randint(0, 2, (5, 1)).astype(
            "float32")], "Left": [n(5, 1)], "Right": [n(5, 1)]}, {}, "ew"),
        ("bpr_loss", {"X": [n(4, 5)], "Label": [i64([1], [0], [4], [2])]},
         {}, "ew"),
        ("npair_loss", {"Anchor": [n(4, 6)], "Positive": [n(4, 6)],
                        "Labels": [i64(0, 1, 0, 2)]}, {"l2_reg": 0.002},
         "mm"),
        ("center_loss", {"X": [n(4, 3)], "Label": [i64([0], [2], [0], [1])],
                         "Centers": [n(3, 3)],
                         "CenterUpdateRate": [f32(0.5)]},
         {"update_center": True}, "ew"),
        ("teacher_student_sigmoid_loss",
         {"X": [n(6, 1, scale=4.0)],
          "Label": [f32([-2.0], [-1.0], [-0.5], [0.3], [0.7], [1.4])]},
         {}, "ew"),
        ("modified_huber_loss", {"X": [n(6, 1, scale=4.0)],
                                 "Y": [rng.randint(0, 2, (6, 1)).astype(
                                     "float32")]}, {}, "ew"),
        ("edit_distance", {"Hyps": [hyps], "Refs": [refs],
                           "HypsLength": [i64(3, 5, 5, 0)],
                           "RefsLength": [i64(3, 4, 6, 2)]},
         {"normalized": True, "ignored_tokens": [0]}, "exact"),
        ("ctc_align", {"Input": [i64([0, 1, 1, 0, 2, 2, 3, 0],
                                     [3, 3, 0, 3, 1, 0, 0, 2])],
                       "InputLength": [i64(8, 6)]},
         {"blank": 0, "merge_repeated": True}, "exact"),
        ("warpctc", {"Logits": [n(2, 6, 5)], "Label": [i64([2, 4, 1],
                                                           [3, 3, 1])],
                     "LogitsLength": [i64(6, 5)],
                     "LabelLength": [i64(3, 2)]},
         {"blank": 0, "norm_by_times": True}, "ew"),
        ("multiplex", {"X": [n(4, 5), n(4, 5), n(4, 5)],
                       "Ids": [np.array([[2], [0], [1], [2]], "int32")]},
         {}, "exact"),
        ("minus", {"X": [n(3, 4)], "Y": [n(3, 4)]}, {}, "exact"),
        ("fsp", {"X": [n(2, 3, 4, 5)], "Y": [n(2, 6, 4, 5)]}, {}, "mm"),
        ("mean_iou", {"Predictions": [i64(0, 0, 1, 1, 2)],
                      "Labels": [i64(0, 1, 1, 1, 2)]},
         {"num_classes": 4}, "ew"),
        ("similarity_focus", {"X": [n(2, 3, 4, 5)]},
         {"axis": 1, "indexes": [0, 2]}, "exact"),
        ("py_func", {"X": [n(4, 3), n(4, 2)]},
         {"forward_callable_id": register_py_func(fwd),
          "backward_callable_id": register_py_func(bwd),
          "out_shapes": [[-1, 3], [-1]],
          "out_dtypes": ["float32", "float64"]}, "ew"),
        ("coalesce_tensor", {"Input": [n(2, 3), n(4), n(1, 2, 2)]}, {},
         "exact"),
        ("fake_init", {}, {"shape": [3, 4], "dtype": "float32"}, "exact"),
        ("delete_var", {"X": [n(2, 2)]}, {}, "exact"),
        ("ref_by_trainer_id", {"X": [n(2, 3), n(2, 3), n(2, 3)],
                               "TrainerId": [i64(1)]}, {}, "exact"),
    ]


def _held_by(got, want, cls, what, label="slim (d)"):
    check(got.shape == want.shape and got.dtype == want.dtype,
          f"{label}: {what}: {got.shape} {got.dtype} against "
          f"{want.shape} {want.dtype}")
    if cls == "exact" or not np.issubdtype(want.dtype, np.floating):
        check(np.array_equal(got, want, equal_nan=True),
              f"{label}: {what} differs from the CPU's")
        return 0.0
    rtol, atol = SWEEP_TOL[cls]
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    err = float((np.abs(got - want) - rtol * np.abs(want)).max(initial=0.0))
    check(err <= atol * scale, f"{label}: {what} differs from the CPU's "
          f"by {err} beyond rtol {rtol} (limit {atol * scale})")
    return float(np.abs(got - want).max(initial=0.0))


def sweep_op(op_type, ins, attrs, cls, device, rng, label="slim (d)",
             forward=None):
    """One case on `device` against the CPU: every output (or, given,
    `forward(got, want)`'s own comparison of them), then the generic
    (or py_func's) gradient under a random cotangent where the op has
    one. Returns the largest difference."""
    from paddle_tpu_torch.core.registry import get_op_def

    got = op_call(op_type, ins, attrs, device)
    want = op_call(op_type, ins, attrs, "cpu")
    check(sorted(got) == sorted(want), f"{label}: {op_type}'s outputs")
    worst = 0.0
    if forward is not None:
        worst = forward(got, want)
    else:
        for slot, vals in want.items():
            for i, v in enumerate(vals):
                worst = max(worst, _held_by(got[slot][i], v, cls,
                                            f"{op_type} {slot}[{i}]", label))
    if not get_op_def(op_type).has_grad():
        return worst
    gins, gouts = {}, {}
    for slot, vals in ins.items():
        gins["fwd_in::" + slot] = vals
        if all(np.issubdtype(np.asarray(x).dtype, np.floating)
               for x in vals):
            gouts["in_grad::" + slot] = [f"g{slot}{i}"
                                        for i in range(len(vals))]
    for slot, vals in want.items():
        gins["fwd_out::" + slot] = vals
        gins["out_grad::" + slot] = [
            None if v is None or not np.issubdtype(v.dtype, np.floating)
            else rng.standard_normal(v.shape).astype(v.dtype) for v in vals]
    got = op_call(op_type + "_grad", gins, attrs, device, gouts)
    want = op_call(op_type + "_grad", gins, attrs, "cpu", gouts)
    for slot, vals in want.items():
        for i, v in enumerate(vals):
            worst = max(worst, _held_by(got[slot][i], v, cls,
                                        f"{op_type}_grad {slot}[{i}]",
                                        label))
    return worst


def sweep_random(device):
    """(d)'s four random op types on `device`, by their law: the
    batch-size-like draws' shape, range and moments, random_crop's
    windows contiguous and its offsets spread, sampling_id's one-hot rows
    exact and a spread row's frequencies."""
    ref = np.zeros((200, 3), "float32")
    u = op_call("uniform_random_batch_size_like", {"Input": [ref]},
                {"shape": [-1, 5000], "min": -0.5, "max": 1.5,
                 "__rng_uid__": 1}, device, rng_key=33)["Out"][0]
    g = op_call("gaussian_random_batch_size_like", {"Input": [ref]},
                {"shape": [-1, 5000], "mean": 2.0, "std": 0.5,
                 "__rng_uid__": 2}, device, rng_key=33)["Out"][0]
    check(u.shape == g.shape == (200, 5000) and u.dtype == g.dtype ==
          np.float32 and -0.5 <= u.min() and u.max() <= 1.5 and
          abs(u.mean() - 0.5) < 5e-3 and abs(u.std() - 2 / 12 ** 0.5) < 5e-3
          and abs(g.mean() - 2.0) < 5e-3 and abs(g.std() - 0.5) < 5e-3,
          f"slim (d): batch-size-like draws: uniform {u.mean()} {u.std()}, "
          f"gaussian {g.mean()} {g.std()}")
    x = np.arange(100, dtype="float32").reshape(10, 10)
    starts = set()
    for key in range(64):
        c = op_call("random_crop", {"X": [x]}, {"shape": [4, 4],
                                                "__rng_uid__": 3},
                    device, rng_key=key)["Out"][0]
        r0, c0 = divmod(int(c[0, 0]), 10)
        check(np.array_equal(c, x[r0:r0 + 4, c0:c0 + 4]),
              "slim (d): random_crop's window is not contiguous")
        starts.add((r0, c0))
    check(len(starts) > 20, f"slim (d): random_crop took {len(starts)} "
          "offsets of 64 draws")
    p = np.tile(np.array([[0.1, 0.6, 0.3]], "float32"), (20000, 1))
    p[:2] = [[0.0, 1.0, 0.0], [1.0, 0.0, 0.0]]
    ids = op_call("sampling_id", {"X": [p]}, {"__rng_uid__": 4}, device,
                  rng_key=33)["Out"][0]
    freq = np.bincount(ids[2:], minlength=3) / (len(ids) - 2)
    check(ids.dtype == np.int64 and list(ids[:2]) == [1, 0] and
          np.abs(freq - p[2]).max() < 0.02,
          f"slim (d): sampling_id {ids[:2]}, frequencies {freq}")
    return {"uniform_mean_std": [float(u.mean()), float(u.std())],
            "gaussian_mean_std": [float(g.mean()), float(g.std())],
            "crop_offsets": len(starts), "sampling_freq": freq.tolist()}


def slim_sweep(device):
    """Phase 33 (d): every op type this slice adds, once on `device`."""
    rng = np.random.RandomState(33)
    cases = sweep_cases(rng)
    worst = {}
    for op_type, ins, attrs, cls in cases:
        worst[op_type] = sweep_op(op_type, ins, attrs, cls, device, rng)
    law = sweep_random(device)
    types = set(worst) | {"uniform_random_batch_size_like",
                          "gaussian_random_batch_size_like", "random_crop",
                          "sampling_id"}
    check(len(types) == 43, f"slim (d): {len(types)} op types swept")
    return {"op_types": len(types), "worst_abs": worst, "random": law}


def phase_slim():
    """Phase 33: (a)-(d) above."""
    import tempfile

    import torch

    import paddle_tpu_torch as pt

    t0 = time.perf_counter()
    before = _kernel_counts()
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda, cpu = pt.CUDAPlace(0), pt.CPUPlace()
    out, secs = {}, {}
    try:
        with tempfile.TemporaryDirectory() as root:
            t = time.perf_counter()
            out["a_qat_vgg16_bn"] = slim_qat_vgg(pt, root)
            secs["a"] = time.perf_counter() - t
            print(json.dumps({"phase": "slim", "part": "a", "card": card(),
                              "step_ms_median": out["a_qat_vgg16_bn"][
                                  "step_ms_median"],
                              "idle_share": out["a_qat_vgg16_bn"][
                                  "traced_step"]["device_idle_share"],
                              "peak_bytes": out["a_qat_vgg16_bn"][
                                  "peak_bytes"]}))

            t = time.perf_counter()
            _peak_reset()
            main, scope, comp = lenet_compress(pt, cuda)
            comp["distill"] = lenet_distill(pt, cuda)
            comp["bf16"] = lenet_bf16(pt, main, scope, cuda, cpu, root)
            comp["peak_bytes"] = _peak()
            out["b_compressor_lenet"] = comp
            secs["b"] = time.perf_counter() - t
            print(json.dumps({"phase": "slim", "part": "b", "card": card(),
                              "compressor_s": comp["run_s"],
                              "distill_s": comp["distill"]["run_s"],
                              "peak_bytes": comp["peak_bytes"]}))
            torch.cuda.empty_cache()

            t = time.perf_counter()
            _peak_reset()
            out["c_ctc"] = slim_ctc(pt, cuda, cpu)
            out["c_ctc"]["peak_bytes"] = _peak()
            secs["c"] = time.perf_counter() - t
            print(json.dumps({"phase": "slim", "part": "c", "card": card(),
                              "step_ms_median": out["c_ctc"][
                                  "step_ms_median"],
                              "idle_share": out["c_ctc"]["traced_step"][
                                  "device_idle_share"],
                              "peak_bytes": out["c_ctc"]["peak_bytes"]}))

            t = time.perf_counter()
            _peak_reset()
            out["d_sweep"] = slim_sweep(cuda.torch_device())
            out["d_sweep"]["peak_bytes"] = _peak()
            secs["d"] = time.perf_counter() - t
            print(json.dumps({"phase": "slim", "part": "d", "card": card(),
                              "seconds": secs["d"],
                              "peak_bytes": out["d_sweep"]["peak_bytes"]}))
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags
    check(_kernel_counts() == before,
          "slim: a kernel of the table launched in phase 33")
    print(json.dumps({
        "phase": "slim", "card": card(),
        "programs": f"book vgg_bn_drop (VGG-16-BN) QAT, CIFAR-10 shapes, "
                    f"batch {VGG_B}, Adam 1e-3, drop 0, {SLIM_QAT_STEPS} "
                    f"steps, freeze, Predictor; book LeNet (models/lenet), "
                    f"MNIST shapes, batch {LENET_B}, the Compressor's "
                    f"prune-then-QAT schedule over {LENET_EPOCHS} epochs of "
                    f"{LENET_EPOCH_STEPS} steps, distillation, bf16; CTC "
                    f"ladder batch {CTC_B} x {CTC_T} frames x {CTC_C} "
                    f"classes, labels {CTC_LABELS[0]}-{CTC_LABELS[1]}, "
                    f"Adam {CTC_LR} x {CTC_STEPS}; 43 op types; f32, TF32 "
                    "off",
        **out, "limits": {"vgg": VGG_TOL, "slim": SLIM_TOL, "ctc": CTC_TOL,
                          "sweep": SWEEP_TOL, "bf16_steps": BF16_STEPS},
        "part_seconds": secs, "seconds": time.perf_counter() - t0}))
    torch.cuda.empty_cache()


# Phase 34: the op library's text-match and detection op types on the
# card, f32 with TF32 off: (a) MobileNet-v1 SSD as PaddleCV's
# object_detection/mobilenet_ssd.py builds it, on Pascal VOC shapes
# (300 x 300, 21 classes), 5 RMSProp steps and an eval pass
# (detection_output, detection_map); (b) the Faster R-CNN proposal path
# at Detectron's defaults on one 800 x 1333 image; (c) a text-matching
# program with a CTR branch; (d) every op type this slice adds, and the
# repaired top_k, top_k_v2 and sparse_allreduce on tied inputs, once
# against the port's CPU op. No kernel of the table runs here: the JAX
# package's detection and text-match ops reach no Pallas kernel.
SSD_HW, SSD_CLASSES, SSD_B, SSD_G = 300, 21, 32, 16
SSD_STEPS = 5
SSD_LR = 1e-3
# mobilenet_ssd.py's multi_box_head: the published sizes and aspect
# ratios [[2.], [2., 3.] x 5], with the 1.0 that Paddle's prior_box adds
# to every list (ExpandAspectRatios) written out: the JAX package's
# prior_box does not add it (ROADMAP F27). The first map has no max
# size, so 3 priors a cell there and 6 elsewhere: 1917
SSD_MIN_SIZES = (60.0, 105.0, 150.0, 195.0, 240.0, 285.0)
SSD_MAX_SIZES = ([], 150.0, 195.0, 240.0, 285.0, 300.0)
SSD_RATIOS = ([1.0, 2.0],) + ([1.0, 2.0, 3.0],) * 5
SSD_PRIORS = 1917
SSD_NMS = {"nms_threshold": 0.45, "keep_top_k": 200, "nms_top_k": 400,
           "score_threshold": 0.01}
# (b): Detectron's C4 RPN and Fast R-CNN sampling defaults
RCNN_HW = (800, 1333)
RCNN_FEAT = (1024, 50, 84)       # C4 at stride 16 of the padded 800 x 1344
RCNN_SIZES = (32.0, 64.0, 128.0, 256.0, 512.0)
RCNN_GTS = 8
# (c): query [64, 32] and title [64, 64] ids, hash (2) into 100000
# buckets, 128-wide embeddings, match_matrix_tensor dim_t 8,
# var_conv_2d 3 x 3 to 16 channels, top-k average pooling over 1, 3, 5
TM_SIZE = dict(B=64, Tq=32, Tt=64, vocab=100000, emb=128, dim_t=8, ch=16,
               hid=128, ctr_dim=16)
TM_STEPS = 5
TM_LR = 1e-3
DET_SEED = 34
# Card against CPU, f32. "loss" relative; "head" the SSD heads' outputs
# in the training step (after 27 batch norms' one-pass variances, which
# move with the reductions' order, ROADMAP F13; 4.9e-5 on the H100) and
# "eval_head" in the eval network (test-mode batch norm), and
# "head_grad" their gradients from the loss op, against their
# largest; the gradients of the network behind the heads in
# `vgg_grad_errors`' two classes at VGG_TOL's limits (a batch norm's
# one-pass variance moves its gradients with the reductions' order,
# ROADMAP F13); "tm_grad" the text program's gradients against the
# largest; every other output of (b) and (d) at SWEEP_TOL by class. A
# selection may differ from the CPU's only at a near tie: a hard
# negative whose CE lies within "ce_tie" (absolute, about four f32 ulps
# at CE 3) of the mining boundary's, or an NMS pick whose IoU with a
# kept box lies within "iou_tie" (absolute, f32 rounding of boxes from
# exp, a few ulps of the areas) of the threshold; each is counted, at
# most "ties" a call.
DET_TOL = {"loss": 1e-5, "head": 1e-3, "eval_head": 1e-4,
           "head_grad": 1e-5,
           "grad": VGG_TOL["grad"], "grad_under_bn": VGG_TOL["grad_under_bn"],
           "tm_grad": 1e-3, "ce_tie": 1e-6, "iou_tie": 1e-5,
           "ties": 2}


def _sync(dev):
    import torch

    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def _traced(dev, run):
    """`_profiled_step(run)`'s row on the card; None on the CPU (the
    parts' CPU runs in tests/test_torch_detection.py)."""
    if _dev_type(dev) != "cuda":
        return None
    traced = _profiled_step(run)
    return {k: traced[k] for k in ("wall_ms", "device_busy_ms",
                                   "device_idle_share", "device_events")}


def _dev_type(dev):
    import torch

    return torch.device(dev).type


def _det_peak(dev, reset=False):
    """The card's peak bytes since the last reset (None on the CPU)."""
    if _dev_type(dev) != "cuda":
        return None
    if reset:
        _peak_reset()
        return None
    return _peak()


def _ssd_conv_bn(pt, x, k, filters, stride, pad, groups=1, act="relu",
                 is_test=False):
    """mobilenet_ssd.py's conv_bn: a conv (MSRA init, lr 0.1, no bias)
    and a batch norm."""
    conv = pt.layers.conv2d(
        x, num_filters=filters, filter_size=k, stride=stride, padding=pad,
        groups=groups, act=None, bias_attr=False,
        param_attr=pt.ParamAttr(learning_rate=0.1,
                                initializer=pt.initializer.MSRA()))
    return pt.layers.batch_norm(conv, act=act, is_test=is_test)


def ssd_body(pt, img, width=1.0, maps=6, is_test=False, repeats=5):
    """mobilenet_ssd.py's ssd_net body at `width` (its scale): the
    depthwise-separable MobileNet-v1 to 19 x 19 (512, module11, after
    `repeats` 512-wide blocks) and 10 x 10 (1024, module13), then the
    extra blocks to 5 x 5, 3 x 3, 2 x 2 and 1 x 1; the first `maps` of
    the six maps."""
    def cb(x, k, f, s, p, g=1):
        return _ssd_conv_bn(pt, x, k, max(1, int(f)), s, p,
                            max(1, int(g)), is_test=is_test)

    def dws(x, f1, f2, g, s):
        return cb(cb(x, 3, f1 * width, s, 1, g * width), 1, f2 * width, 1, 0)

    def extra(x, f1, f2, s):
        return cb(cb(x, 1, f1 * width, 1, 0), 3, f2 * width, s, 1)

    x = cb(img, 3, 32 * width, 2, 1)
    for f1, f2, s in ((32, 64, 1), (64, 128, 2), (128, 128, 1),
                      (128, 256, 2), (256, 256, 1), (256, 512, 2)):
        x = dws(x, f1, f2, f1, s)
    for _ in range(repeats):
        x = dws(x, 512, 512, 512, 1)
    feats = [x]
    x = dws(x, 512, 1024, 512, 2)
    feats.append(dws(x, 1024, 1024, 1024, 1))
    for f1, f2 in ((256, 512), (128, 256), (128, 256), (64, 128))[
            :max(0, maps - 2)]:
        feats.append(extra(feats[-1], f1, f2, 2))
    return feats[:maps]


def _ssd_heads(pt, hw, classes, width, maps, is_test, repeats):
    """The image input, the body and multi_box_head with the published
    sizes (scaled to `hw`), kernel 3, pad 1, offset 0.5, flip: (img,
    locs, confs, priors, variances)."""
    scale = hw / float(SSD_HW)
    img = pt.layers.data(name="img", shape=[3, hw, hw], dtype="float32")
    feats = ssd_body(pt, img, width, maps, is_test, repeats)
    locs, confs, box, var = pt.layers.multi_box_head(
        inputs=feats, image=img, base_size=hw, num_classes=classes,
        aspect_ratios=[list(r) for r in SSD_RATIOS[:maps]],
        min_sizes=[v * scale for v in SSD_MIN_SIZES[:maps]],
        max_sizes=[v if v == [] else v * scale
                   for v in SSD_MAX_SIZES[:maps]],
        offset=0.5, flip=True, kernel_size=3, pad=1)
    return img, locs, confs, box, var


def ssd_program(pt, hw=SSD_HW, classes=SSD_CLASSES, width=1.0, maps=6,
                max_gt=SSD_G, lr=SSD_LR, repeats=5):
    """The SSD's programs, built with the fluid package `pt`: "main"
    (ssd_loss, its sum, RMSProp), "grad" (the same network with the
    parameters' gradients from given head gradients, `pt.gradients`),
    "net" (the eval network: softmax scores) and "post"
    (detection_output and detection_map on fed heads), with the names
    the phase fetches."""
    out = {}
    with pt.framework.unique_name.guard():
        main, startup = pt.Program(), pt.Program()
        with pt.program_guard(main, startup):
            img, locs, confs, box, var = _ssd_heads(pt, hw, classes, width,
                                                    maps, False, repeats)
            gt_box = pt.layers.data(name="gt_box", shape=[max_gt, 4],
                                    dtype="float32")
            gt_label = pt.layers.data(name="gt_label", shape=[max_gt],
                                      dtype="int64")
            per_prior = pt.layers.ssd_loss(locs, confs, gt_box, gt_label,
                                           box, var)
            loss = pt.layers.reduce_sum(per_prior)
            params = [p.name for p in main.all_parameters() if p.trainable]
            pt.optimizer.RMSProp(learning_rate=lr).minimize(loss)
    out.update(main=main, startup=startup, loss=loss.name, params=params,
               per_prior=per_prior.name, locs=locs.name, confs=confs.name,
               priors=box.name, variances=var.name,
               fetch=[loss.name] + [p + "@GRAD" for p in params],
               priors_n=int(locs.shape[1]))
    with pt.framework.unique_name.guard():
        grad = pt.Program()
        with pt.program_guard(grad, pt.Program()):
            img, locs, confs, box, var = _ssd_heads(pt, hw, classes, width,
                                                    maps, False, repeats)
            gl = pt.layers.data(name="locs_grad", shape=list(locs.shape[1:]),
                                dtype="float32")
            gc = pt.layers.data(name="confs_grad",
                                shape=list(confs.shape[1:]), dtype="float32")
            ps = [grad.global_block().var(n) for n in params]
            gs = pt.gradients([locs, confs], ps, target_gradients=[gl, gc])
    out.update(grad=grad, grad_fetch=[locs.name, confs.name] +
               [g.name for g in gs])
    with pt.framework.unique_name.guard():
        net = pt.Program()
        with pt.program_guard(net, pt.Program()):
            img, locs, confs, box, var = _ssd_heads(pt, hw, classes, width,
                                                    maps, True, repeats)
            scores = pt.layers.softmax(confs)
    out.update(net=net, net_fetch=[locs.name, scores.name, box.name,
                                   var.name])
    p, c = out["priors_n"], classes
    with pt.framework.unique_name.guard():
        post = pt.Program()
        with pt.program_guard(post, pt.Program()):
            f_locs = pt.layers.data(name="f_locs", shape=[p, 4],
                                    dtype="float32")
            f_scores = pt.layers.data(name="f_scores", shape=[p, c],
                                      dtype="float32")
            f_box = pt.layers.data(name="f_box", shape=[p, 4],
                                   dtype="float32", append_batch_size=False)
            f_var = pt.layers.data(name="f_var", shape=[p, 4],
                                   dtype="float32", append_batch_size=False)
            gt_box = pt.layers.data(name="gt_box", shape=[max_gt, 4],
                                    dtype="float32")
            gt_label = pt.layers.data(name="gt_label", shape=[max_gt],
                                      dtype="int64")
            difficult = pt.layers.data(name="difficult", shape=[max_gt],
                                       dtype="float32")
            nmsed = pt.layers.detection_output(
                f_locs, f_scores, f_box, f_var, background_label=0,
                **SSD_NMS)
            block = post.global_block()
            num = block.ops[-1].output("NmsRoisNum")[0]
            label = pt.layers.concat([
                pt.layers.unsqueeze(pt.layers.cast(gt_label, "float32"), [2]),
                gt_box, pt.layers.unsqueeze(difficult, [2])], axis=2)
            helper = pt.layer_helper.LayerHelper("detection_map")
            m_ap = helper.create_variable_for_type_inference("float32")
            state = [helper.create_variable_for_type_inference(dt)
                     for dt in ("int32", "float32", "float32")]
            helper.append_op(
                type="detection_map",
                inputs={"DetectRes": nmsed, "Label": label},
                outputs={"MAP": m_ap, "AccumPosCount": state[0],
                         "AccumTruePos": state[1],
                         "AccumFalsePos": state[2]},
                attrs={"class_num": classes, "overlap_threshold": 0.5,
                       "evaluate_difficult": False, "ap_type": "11point",
                       "max_dets": SSD_B * SSD_NMS["keep_top_k"]})
    out.update(post=post, post_fetch=[nmsed.name, num, m_ap.name])
    return out


def ssd_feed(rng, batch=SSD_B, hw=SSD_HW, classes=SSD_CLASSES,
             max_gt=SSD_G):
    """Synthetic images N(0, 1) and 1-8 boxes an image (normalized
    corners, sides 0.05-0.6 of the image, classes 1..C-1, one in ten
    difficult), padded to `max_gt` with label -1."""
    box = np.zeros((batch, max_gt, 4), "float32")
    label = np.full((batch, max_gt), -1, "int64")
    for i in range(batch):
        n = rng.randint(1, min(8, max_gt) + 1)
        wh = rng.uniform(0.05, 0.6, (n, 2))
        xy = rng.uniform(0.0, 1.0, (n, 2)) * (1.0 - wh)
        box[i, :n] = np.concatenate([xy, xy + wh], 1)
        label[i, :n] = rng.randint(1, classes, n)
    return {"img": rng.standard_normal((batch, 3, hw, hw)).astype("float32"),
            "gt_box": box, "gt_label": label,
            "difficult": (rng.uniform(size=(batch, max_gt)) < 0.1).astype(
                "float32")}


def _cpu_copy(pt, scope, names):
    """A CPU scope holding copies of `names` from `scope`."""
    from paddle_tpu_torch.convert import scope_from_numpy

    return scope_from_numpy(pt.Scope(), {n: scope.get(n) for n in names},
                            pt.CPUPlace())


def _ce_ties(loss_got, loss_want, conf, tgt_rows):
    """The images whose hard-negative selection (the nonzero per-prior
    losses) differs between two ssd_loss runs on the same inputs, each
    checked to differ only at priors whose CE (from `conf`, f64) lies
    within DET_TOL["ce_tie"] of the boundary between the selected and
    the unselected negatives. Returns ([image, prior] of the differing
    entries, worst gap)."""
    sel_g, sel_w = loss_got != 0, loss_want != 0
    rows, worst = [], 0.0
    for b in np.nonzero((sel_g != sel_w).any(1))[0]:
        x = conf[b].astype(np.float64)
        x -= x.max(1, keepdims=True)
        ce = -(x[:, 0] - np.log(np.exp(x).sum(1)))     # background CE
        cand = ~tgt_rows[b]
        chosen = ce[sel_w[b] & cand]
        rest = ce[~sel_w[b] & cand]
        bound = 0.5 * (chosen.min(initial=np.inf) + rest.max(
            initial=-np.inf))
        for p in np.nonzero(sel_g[b] != sel_w[b])[0]:
            gap = abs(ce[p] - bound)
            check(gap <= DET_TOL["ce_tie"],
                  f"detection (a): prior {p} of image {b} is mined on one "
                  f"device only, {gap} from the boundary CE")
            worst = max(worst, gap)
            rows.append((int(b), int(p)))
    return rows, worst


def _ssd_parity(pt, prog, feed, scope, exe):
    """(a)'s first step on the card, held in three parts against the
    port's CPU from the same inputs: the heads (the CPU network's
    forward), the loss op (ssd_loss on the CPU fed the card's heads:
    the loss, the per-prior losses, the selection up to counted near
    ties, the heads' gradients), and the network's backward (the CPU's
    `grad` program given the card's head gradients). Returns (the card's
    loss, the parity row)."""
    from paddle_tpu_torch.core.registry import GRAD_PREFIX_IG

    pers = [v.name for v in prog["startup"].list_vars() if v.persistable]
    cpu = _cpu_copy(pt, scope, pers)
    names = [prog["loss"], prog["locs"], prog["confs"], prog["per_prior"],
             prog["locs"] + "@GRAD", prog["confs"] + "@GRAD", prog["priors"],
             prog["variances"]] + prog["fetch"][1:]
    got = [np.asarray(v) for v in exe.run(prog["main"], feed=feed,
                                          fetch_list=names, scope=scope)]
    loss, locs, confs, per_prior, g_locs, g_confs, box, var = got[:8]
    pgrads = got[8:]
    # the loss op on the CPU at the card's heads
    ins = {"Location": [locs], "Confidence": [confs],
           "GtBox": [feed["gt_box"]], "GtLabel": [feed["gt_label"]],
           "PriorBox": [box], "PriorBoxVar": [var]}
    want = op_call("ssd_loss", ins, {}, "cpu")["Loss"][0]
    gins = {"fwd_in::" + k: v for k, v in ins.items()}
    gins.update({"fwd_out::Loss": [want],
                 "out_grad::Loss": [np.ones_like(want)]})
    g = op_call("ssd_loss_grad", gins, {}, "cpu",
                {GRAD_PREFIX_IG + "Location": ["gl"],
                 GRAD_PREFIX_IG + "Confidence": ["gc"]})
    # a prior matched to a gt is a positive on both devices (the IoUs
    # are the same arithmetic on the same boxes); the rest are mining
    # candidates
    pos = _ssd_positives(feed, box)
    tied, gap = _ce_ties(per_prior, want, confs, pos)
    check(len(tied) <= DET_TOL["ties"],
          f"detection (a): {len(tied)} mined priors differ (limit "
          f"{DET_TOL['ties']})")
    keep = np.ones(per_prior.shape, bool)
    for b, p in tied:
        keep[b, p] = False
    loss = float(loss.reshape(()))
    loss_rel = abs(loss - float(want.sum())) / abs(float(want.sum()))
    per_err = float(np.abs(per_prior - want)[keep].max()) / float(
        np.abs(want).max())
    hg_scale = max(float(np.abs(g[GRAD_PREFIX_IG + k][0]).max())
                   for k in ("Location", "Confidence"))
    hg_err = max(float(np.abs(a - g[GRAD_PREFIX_IG + k][0])[keep].max())
                 for a, k in ((g_locs, "Location"), (g_confs, "Confidence")))
    hg_err /= hg_scale
    # the network: the CPU's forward and its backward from the card's
    # head gradients
    gfeed = dict(feed, locs_grad=g_locs, confs_grad=g_confs)
    cg = [np.asarray(v) for v in pt.Executor(pt.CPUPlace()).run(
        prog["grad"], feed={k: gfeed[k] for k in ("img", "locs_grad",
                                                   "confs_grad")},
        fetch_list=prog["grad_fetch"], scope=cpu)]
    head_err = max(float(np.abs(a - b).max()) / float(np.abs(b).max())
                   for a, b in ((locs, cg[0]), (confs, cg[1])))
    net = vgg_grad_errors(prog["grad"], prog["params"], pgrads, cg[2:])
    row = {"loss_rel": loss_rel, "per_prior_rel": per_err,
           "head_rel": head_err, "head_grad_rel": hg_err,
           "mined_ties": len(tied), "worst_ce_gap": gap,
           "positives": int(pos.sum()), **net, "params": len(pgrads)}
    check(loss_rel <= DET_TOL["loss"] and per_err <= DET_TOL["loss"] and
          head_err <= DET_TOL["head"] and hg_err <= DET_TOL["head_grad"] and
          net["grad"] <= DET_TOL["grad"] and
          net["grad_under_bn"] <= DET_TOL["grad_under_bn"],
          f"detection (a): the card's first step against the CPU's: {row}")
    return loss, row


def _ssd_positives(feed, box):
    """ssd_loss's positives (per_prediction at 0.5, plus each gt's best
    prior) from the feed and the priors, in numpy: [N, P] bool."""
    gt, lab = feed["gt_box"].astype(np.float64), feed["gt_label"]
    pr = box.astype(np.float64)
    lt = np.maximum(gt[:, :, None, :2], pr[None, None, :, :2])
    rb = np.minimum(gt[:, :, None, 2:], pr[None, None, :, 2:])
    inter = np.clip(rb - lt, 0, None).prod(-1)
    ag = (gt[..., 2] - gt[..., 0]) * (gt[..., 3] - gt[..., 1])
    ap = (pr[:, 2] - pr[:, 0]) * (pr[:, 3] - pr[:, 1])
    iou = inter / (ag[..., None] + ap - inter + 1e-10)
    iou = np.where(lab[..., None] >= 0, iou, -1.0)
    pos = iou.max(1) >= 0.5
    for b in range(gt.shape[0]):
        for k in np.nonzero(lab[b] >= 0)[0]:
            pos[b, iou[b, k].argmax()] = True
    return pos


def _nms_rows_held(label, got, want, thr, normalized, by_class, what):
    """NMS outputs of one call on two devices (rows [label, score, box]
    when `by_class`, else [score, box]), image by image: equal up to the
    first difference, which must be a near tie: one of the two rows
    there has an IoU within DET_TOL["iou_tie"] of `thr` with a row kept
    before it (of its class). Returns (near ties, worst float error over
    the equal rows)."""
    ties, worst = 0, 0.0
    one = 0.0 if normalized else 1.0

    def iou(a, b):
        w = max(min(a[2], b[2]) - max(a[0], b[0]) + one, 0.0)
        h = max(min(a[3], b[3]) - max(a[1], b[1]) + one, 0.0)
        inter = w * h
        ua = (a[2] - a[0] + one) * (a[3] - a[1] + one) + \
            (b[2] - b[0] + one) * (b[3] - b[1] + one) - inter
        return inter / max(ua, 1e-10)

    for i in range(want.shape[0]):
        g, w = got[i].astype(np.float64), want[i].astype(np.float64)
        key = slice(0, 2) if by_class else slice(0, 1)
        diff = np.nonzero((g[:, key] != w[:, key]).any(1))[0]
        k = int(diff[0]) if diff.size else g.shape[0]
        if k:
            err = float(np.abs(g[:k] - w[:k]).max())
            check(err <= 1e-3 * max(1.0, float(np.abs(w[:k]).max())),
                  f"{label}: {what} image {i}'s equal rows differ by {err}")
            worst = max(worst, err)
        if k == g.shape[0]:
            continue
        gaps = []
        for row in (g[k], w[k]):
            bx = row[-4:]
            prior = [r[-4:] for r in w[:k] if not by_class or r[0] == row[0]]
            gaps.append(min((abs(iou(bx, p) - thr) for p in prior),
                            default=np.inf))
        check(min(gaps) <= DET_TOL["iou_tie"],
              f"{label}: {what} image {i} leaves the CPU's picks at row {k} "
              f"with no IoU near {thr} (gaps {gaps})")
        ties += 1
    check(ties <= DET_TOL["ties"], f"{label}: {what}: {ties} near ties")
    return ties, worst


def _ssd_eval(pt, prog, feed, scope, exe, dev):
    """(a)'s eval on the card: the eval network (softmax scores), then
    detection_output and detection_map on its heads; the network against
    the CPU's from the same state, and the post program on the CPU fed
    the card's heads (NmsRoisNum, labels and boxes up to counted near
    ties, the mAP and its state). Timed, traced and counted."""
    pers = [v.name for v in prog["startup"].list_vars() if v.persistable]
    cpu = _cpu_copy(pt, scope, pers)

    def run():
        heads = exe.run(prog["net"], feed={"img": feed["img"]},
                        fetch_list=prog["net_fetch"], scope=scope)
        pfeed = {"f_locs": heads[0], "f_scores": heads[1],
                 "f_box": heads[2], "f_var": heads[3],
                 "gt_box": feed["gt_box"], "gt_label": feed["gt_label"],
                 "difficult": feed["difficult"]}
        return heads, exe.run(prog["post"], feed=pfeed,
                              fetch_list=prog["post_fetch"], scope=scope)

    ms = []
    for _ in range(3):
        _sync(dev)
        t0 = time.perf_counter()
        heads, post = run()
        _sync(dev)
        ms.append((time.perf_counter() - t0) * 1e3)
    traced = _traced(dev, run)
    heads = [np.asarray(h) for h in heads]
    post = [np.asarray(v) for v in post]
    want_heads = [np.asarray(v) for v in pt.Executor(pt.CPUPlace()).run(
        prog["net"], feed={"img": feed["img"]}, fetch_list=prog["net_fetch"],
        scope=cpu)]
    head_err = max(float(np.abs(a - b).max()) / float(np.abs(b).max())
                   for a, b in zip(heads, want_heads))
    check(head_err <= DET_TOL["eval_head"],
          f"detection (a): the eval heads differ from the CPU's by {head_err}")
    pfeed = {"f_locs": heads[0], "f_scores": heads[1], "f_box": heads[2],
             "f_var": heads[3], "gt_box": feed["gt_box"],
             "gt_label": feed["gt_label"], "difficult": feed["difficult"]}
    want = [np.asarray(v) for v in pt.Executor(pt.CPUPlace()).run(
        prog["post"], feed=pfeed, fetch_list=prog["post_fetch"],
        scope=pt.Scope())]
    ties, worst = _nms_rows_held("detection (a)", post[0], want[0],
                                 SSD_NMS["nms_threshold"], True, True,
                                 "detection_output")
    if ties == 0:
        check(np.array_equal(post[1], want[1]) and
              np.array_equal(post[2], want[2]),
              f"detection (a): NmsRoisNum {post[1]} or mAP {post[2]} "
              f"against the CPU's {want[1]} {want[2]}")
    return {"eval_ms": ms, "eval_ms_median": statistics.median(ms),
            "eval_launches": traced and traced["device_events"],
            "eval_traced": traced,
            "head_rel": head_err, "nms_near_ties": ties,
            "nms_worst_abs": worst,
            "detections": int(post[1].sum()), "map_11point": float(
                post[2].reshape(-1)[0]), "map_cpu": float(
                want[2].reshape(-1)[0])}


def det_ssd(pt, place=None, batch=SSD_B, **size):
    """Phase 34 (a): MobileNet-v1 SSD at 300 x 300, 21 classes, batch
    32 on `place` (the card): the prior count, the first step held
    against the CPU, 5 RMSProp steps (the loss finite and falling), a
    traced step, the eval. `size` (hw, classes, width, maps, max_gt)
    shrinks it for the CPU test."""
    place = place or pt.CUDAPlace(0)
    dev = place.torch_device()
    prog = ssd_program(pt, **size)
    if not size:
        check(prog["priors_n"] == SSD_PRIORS,
              f"detection (a): {prog['priors_n']} priors, not {SSD_PRIORS}")
    fsize = {k: size[k] for k in ("hw", "classes", "max_gt") if k in size}
    feed = ssd_feed(np.random.RandomState(DET_SEED), batch=batch, **fsize)
    tfeed = {k: feed[k] for k in ("img", "gt_box", "gt_label")}
    exe = pt.Executor(place)
    scope = pt.Scope()
    exe.run(prog["startup"], scope=scope)
    _det_peak(dev, reset=True)
    t0 = time.perf_counter()
    first, parity = _ssd_parity(pt, prog, tfeed, scope, exe)
    _sync(dev)
    losses, ms = [first], [(time.perf_counter() - t0) * 1e3]
    for _ in range(SSD_STEPS - 1):
        t0 = time.perf_counter()
        out = exe.run(prog["main"], feed=tfeed, fetch_list=[prog["loss"]],
                      scope=scope)
        losses.append(float(np.asarray(out[0]).reshape(())))
        ms.append((time.perf_counter() - t0) * 1e3)
    # RMSProp's first update moves every weight by about 4.5 lr (its mean
    # square starts at 0), and the loss jumps; from there it falls
    check(all(np.isfinite(losses)) and
          all(b < a for a, b in zip(losses[1:], losses[2:])),
          f"detection (a): the SSD loss did not fall: {losses}")
    row = {"priors": prog["priors_n"], "losses": losses, "step_ms": ms,
           "step_ms_median": statistics.median(ms[1:]),
           "step_ms_range": [min(ms[1:]), max(ms[1:])], "parity": parity,
           "traced_step": _traced(dev, lambda: exe.run(
               prog["main"], feed=tfeed, fetch_list=[prog["loss"]],
               scope=scope)),
           "ops_a_step": len(prog["main"].desc.block(0).ops)}
    row["eval"] = _ssd_eval(pt, prog, feed, scope, exe, dev)
    row["peak_bytes"] = _det_peak(dev)
    return row


def proposal_path(run, seed=DET_SEED, hw=RCNN_HW, stride=16,
                  feat=RCNN_FEAT, sizes=RCNN_SIZES, pre_nms=12000,
                  post_nms=2000, rois=512, classes=81, pooled=14,
                  gts=RCNN_GTS):
    """(b)'s chain, each op through `run(op_type, ins, attrs)` (numpy in
    and out): anchor_generator (sizes 32-512, ratios 0.5/1/2, stride
    16), rpn_target_assign (batch 256, fg 0.5, 0.7/0.3), a random RPN
    head's scores and deltas into generate_proposals (pre_nms_topN
    12000, post_nms_topN 2000, 0.7: training's), generate_proposal_labels
    (512 RoIs, fg 0.25, `classes`), roi_align (14 x 14, 1/16, on a
    random C4 map), all from `seed`, use_random off. Returns the records
    [(op type, inputs, attrs, outputs)], each op fed the outputs before
    it."""
    rng = np.random.RandomState(seed)
    c, fh, fw = feat
    a = 3 * len(sizes)
    fmap = rng.standard_normal((1, c, fh, fw)).astype("float32")
    wh = rng.uniform(32, 400, (gts, 2))
    xy = rng.uniform(0, 1, (gts, 2)) * (np.array(hw[::-1]) - wh)
    gt = np.concatenate([xy, xy + wh], 1).astype("float32")
    gcls = rng.randint(1, classes, (1, gts)).astype("int32")
    scores = (1 / (1 + np.exp(-2 * rng.standard_normal(
        (1, a, fh, fw))))).astype("float32")
    deltas = (rng.standard_normal((1, 4 * a, fh, fw)) * 0.2).astype(
        "float32")
    im_info = np.array([[hw[0], hw[1], 1.0]], "float32")
    records = []

    def step(op_type, ins, attrs):
        out = run(op_type, ins, attrs)
        records.append((op_type, ins, attrs, out))
        return out

    anc = step("anchor_generator", {"Input": [fmap]},
               {"anchor_sizes": list(sizes), "aspect_ratios": [0.5, 1.0, 2.0],
                "stride": [float(stride)] * 2, "offset": 0.5})
    step("rpn_target_assign", {"Anchor": [anc["Anchors"][0]],
                               "GtBoxes": [gt]},
         {"rpn_batch_size_per_im": 256, "rpn_fg_fraction": 0.5,
          "rpn_positive_overlap": 0.7, "rpn_negative_overlap": 0.3,
          "use_random": False})
    props = step("generate_proposals",
                 {"Scores": [scores], "BboxDeltas": [deltas],
                  "ImInfo": [im_info], "Anchors": [anc["Anchors"][0]],
                  "Variances": [anc["Variances"][0]]},
                 {"pre_nms_topN": pre_nms, "post_nms_topN": post_nms,
                  "nms_thresh": 0.7, "min_size": 0.1})
    labels = step("generate_proposal_labels",
                  {"RpnRois": [props["RpnRois"][0]], "GtBoxes": [gt[None]],
                   "GtClasses": [gcls],
                   "IsCrowd": [np.zeros((1, gts), "int32")]},
                  {"batch_size_per_im": rois, "fg_fraction": 0.25,
                   "fg_thresh": 0.5, "bg_thresh_hi": 0.5, "bg_thresh_lo": 0.0,
                   "class_nums": classes, "use_random": False})
    step("roi_align", {"X": [fmap], "ROIs": [labels["Rois"][0][0]]},
         {"pooled_height": pooled, "pooled_width": pooled,
          "spatial_scale": 1.0 / stride, "sampling_ratio": 0})
    return records


def _op_ms(op_type, ins, attrs, device, reps):
    """The median ms of `reps` calls of the op on `device` (inputs moved
    there once; CUDA events on the card, the host's clock on the CPU),
    and the call."""
    import torch

    from paddle_tpu_torch.core.ir import OpDesc
    from paddle_tpu_torch.core.registry import KernelCtx, get_op_def

    desc = OpDesc(type=op_type, inputs={k: [f"{k}{i}" for i in range(
        len(v))] for k, v in ins.items()}, outputs={}, attrs=attrs)
    ctx = KernelCtx(desc, device=device)
    vals = {k: [torch.from_numpy(np.array(a)).to(device) for a in v]
            for k, v in ins.items()}
    op = get_op_def(op_type)

    def call():
        with torch.no_grad():
            return op.call(vals, attrs, ctx)

    if _dev_type(device) == "cuda":
        return time_ms(call, reps=reps), call
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        call()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), call


def det_proposals(pt, place=None, **size):
    """Phase 34 (b): the Faster R-CNN proposal path on `place` (the
    card), each op held against the same op on the CPU fed the same
    inputs (the card's outputs before it): selections exactly
    (generate_proposals' picks up to counted near ties), floats at their
    limits; each op's time, and one generate_proposals call traced (its
    launches). `size` (proposal_path's) shrinks it for the CPU test."""
    import torch

    dev = (place or pt.CUDAPlace(0)).torch_device()
    _det_peak(dev, reset=True)
    t0 = time.perf_counter()
    records = proposal_path(lambda t, i, a: op_call(t, i, a, dev), **size)
    row = {"ops": {}, "chain_wall_s": time.perf_counter() - t0}
    for op_type, ins, attrs, got in records:
        want = op_call(op_type, ins, attrs, "cpu")
        r = {}
        if op_type == "generate_proposals":
            g = np.concatenate([got["RpnRoiProbs"][0], got["RpnRois"][0]], 2)
            w = np.concatenate([want["RpnRoiProbs"][0], want["RpnRois"][0]], 2)
            r["near_ties"], r["worst_abs"] = _nms_rows_held(
                "detection (b)", g, w, attrs["nms_thresh"], False, False,
                "generate_proposals")
            if r["near_ties"] == 0:
                check(np.array_equal(got["RpnRoisNum"][0],
                                     want["RpnRoisNum"][0]),
                      "detection (b): RpnRoisNum differs from the CPU's")
            r["proposals"] = int(got["RpnRoisNum"][0].sum())
        else:
            cls = "mm" if op_type == "roi_align" else "ew"
            r["worst_abs"] = max(_held_by(got[k][i], v, cls,
                                          f"{op_type} {k}[{i}]",
                                          "detection (b)")
                                 for k, vs in want.items()
                                 for i, v in enumerate(vs))
        reps = 3 if op_type == "generate_proposals" else 10
        r["ms"], call = _op_ms(op_type, ins, attrs, dev, reps)
        if op_type == "generate_proposals":
            r["traced"] = _traced(dev, call)
        if op_type == "rpn_target_assign":
            r["fg"] = int((got["LocationIndex"][0] >= 0).sum())
        if op_type == "generate_proposal_labels":
            lab = got["LabelsInt32"][0]
            r["fg"], r["bg"] = int((lab > 0).sum()), int((lab == 0).sum())
        row["ops"][op_type] = r
    row["anchors"] = int(np.prod(records[0][3]["Anchors"][0].shape[:3]))
    if not size:
        check(row["anchors"] == 63000,
              f"detection (b): {row['anchors']} anchors, not 63000")
    row["peak_bytes"] = _det_peak(dev)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return row


def text_match_program(pt, B=TM_SIZE["B"], Tq=TM_SIZE["Tq"],
                       Tt=TM_SIZE["Tt"], vocab=TM_SIZE["vocab"],
                       emb=TM_SIZE["emb"], dim_t=TM_SIZE["dim_t"],
                       ch=TM_SIZE["ch"], hid=TM_SIZE["hid"],
                       ctr_dim=TM_SIZE["ctr_dim"], lr=TM_LR):
    """(c)'s program, built with the fluid package `pt`: query and title
    ids hashed twice into `vocab` buckets, one embedding table (the two
    hashes summed), match_matrix_tensor (dim_t), var_conv_2d (3 x 3 to
    `ch`, ROW and COLUMN the lengths), relu, sequence_topk_avg_pooling
    (1, 3, 5), fc `hid`, fc 2, softmax cross-entropy; a CTR branch: an
    embedding through cvm and filter_by_instag into an fc whose squared
    output, weighted by LossWeight, joins the loss; Adam."""
    main, startup = pt.Program(), pt.Program()
    L = pt.layers
    with pt.framework.unique_name.guard(), pt.program_guard(main, startup):
        q = L.data(name="q", shape=[Tq], dtype="int64")
        t = L.data(name="t", shape=[Tt], dtype="int64")
        ql = L.data(name="ql", shape=[], dtype="int64")
        tl = L.data(name="tl", shape=[], dtype="int64")
        label = L.data(name="label", shape=[1], dtype="int64")
        ctr_id = L.data(name="ctr_id", shape=[1], dtype="int64")
        cvm_in = L.data(name="cvm_in", shape=[2], dtype="float32")
        tag = L.data(name="tag", shape=[2], dtype="int64")
        ftag = L.data(name="ftag", shape=[2], dtype="int64",
                      append_batch_size=False)

        def embed(ids, T):
            h = L.hash(L.reshape(ids, [-1, 1]), hash_size=vocab, num_hash=2)
            e = L.embedding(L.reshape(h, [-1, 1]), size=[vocab, emb],
                            param_attr=pt.ParamAttr(name="hash_emb"))
            return L.reduce_sum(L.reshape(e, [-1, T, 2, emb]), dim=2)

        helper = pt.layer_helper.LayerHelper("match_matrix_tensor")
        w = helper.create_parameter(pt.ParamAttr(name="mm_w"),
                                    shape=[emb, dim_t, emb], dtype="float32")
        mm = helper.create_variable_for_type_inference("float32")
        tmp = helper.create_variable_for_type_inference("float32")
        helper.append_op(type="match_matrix_tensor",
                         inputs={"X": embed(q, Tq), "Y": embed(t, Tt),
                                 "W": w},
                         outputs={"Out": mm, "Tmp": tmp},
                         attrs={"dim_t": dim_t})
        helper = pt.layer_helper.LayerHelper("var_conv_2d")
        cw = helper.create_parameter(pt.ParamAttr(name="conv_w"),
                                     shape=[ch, dim_t * 9], dtype="float32")
        conv = helper.create_variable_for_type_inference("float32")
        helper.append_op(type="var_conv_2d",
                         inputs={"X": mm, "ROW": ql, "COLUMN": tl, "W": cw},
                         outputs={"Out": conv},
                         attrs={"InputChannel": dim_t, "OutputChannel": ch,
                                "kernel_h": 3, "kernel_w": 3,
                                "stride_h": 1, "stride_w": 1})
        pooled = L.sequence_topk_avg_pooling(L.relu(conv), topks=[1, 3, 5],
                                             channel_num=ch, row=ql, col=tl)
        logits = L.fc(L.fc(pooled, size=hid, act="relu"), size=2)
        match_loss = L.mean(L.softmax_with_cross_entropy(logits, label))
        ce = L.embedding(ctr_id, size=[1000, ctr_dim])
        kept, weight, _ = L.filter_by_instag(
            L.continuous_value_model(L.reshape(ce, [-1, ctr_dim]), cvm_in),
            tag, ftag)
        ctr = L.fc(kept, size=1)
        ctr_loss = L.mean(L.elementwise_mul(L.square(ctr), weight))
        loss = L.elementwise_add(match_loss, ctr_loss)
        params = [p.name for p in main.all_parameters() if p.trainable]
        pt.optimizer.Adam(learning_rate=lr).minimize(loss)
    return {"main": main, "startup": startup, "loss": loss,
            "params": params,
            "fetch": [loss.name] + [p + "@GRAD" for p in params]}


def text_match_feed(rng, B=TM_SIZE["B"], Tq=TM_SIZE["Tq"], Tt=TM_SIZE["Tt"],
                    **_):
    """Ids up to 2^31 - 1, lengths 1..T a row, labels, and the CTR
    branch's ids, [show, click] counters (each instance shown once,
    clicked or not) and tags (about half the rows carry a tag of the
    filter)."""
    return {"q": rng.randint(0, 2 ** 31 - 1, (B, Tq)).astype("int64"),
            "t": rng.randint(0, 2 ** 31 - 1, (B, Tt)).astype("int64"),
            "ql": rng.randint(1, Tq + 1, B).astype("int64"),
            "tl": rng.randint(1, Tt + 1, B).astype("int64"),
            "label": rng.randint(0, 2, (B, 1)).astype("int64"),
            "ctr_id": rng.randint(0, 1000, (B, 1)).astype("int64"),
            "cvm_in": np.stack([np.ones(B), rng.randint(0, 2, B)],
                               1).astype("float32"),
            "tag": rng.randint(0, 8, (B, 2)).astype("int64"),
            "ftag": np.array([1, 2], "int64")}


def det_text_match(pt, place=None, **size):
    """Phase 34 (c): the text-matching program at TM_SIZE (or `size`,
    for the CPU test) on `place` (the card), its first Adam step held
    against the CPU's from the same state (the loss, and every gradient
    against the step's largest), 5 steps, a traced step."""
    place = place or pt.CUDAPlace(0)
    dev = place.torch_device()
    prog = text_match_program(pt, **size)
    feed = text_match_feed(np.random.RandomState(DET_SEED), **size)
    exe = pt.Executor(place)
    scope = pt.Scope()
    exe.run(prog["startup"], scope=scope)
    pers = [v.name for v in prog["startup"].list_vars() if v.persistable]
    cpu = _cpu_copy(pt, scope, pers)
    _det_peak(dev, reset=True)
    t0 = time.perf_counter()
    got = [np.asarray(v) for v in exe.run(prog["main"], feed=feed,
                                          fetch_list=prog["fetch"],
                                          scope=scope)]
    _sync(dev)
    ms = [(time.perf_counter() - t0) * 1e3]
    want = [np.asarray(v) for v in pt.Executor(pt.CPUPlace()).run(
        prog["main"], feed=feed, fetch_list=prog["fetch"], scope=cpu)]
    g0, w0 = float(got[0].reshape(())), float(want[0].reshape(()))
    loss_rel = abs(g0 - w0) / abs(w0)
    scale = max(float(np.abs(w).max()) for w in want[1:])
    worst = max((float(np.abs(g.astype(np.float64) - w).max()) / scale, p)
                for p, g, w in zip(prog["params"], got[1:], want[1:]))
    check(loss_rel <= DET_TOL["loss"] and worst[0] <= DET_TOL["tm_grad"],
          f"detection (c): the card's step against the CPU's: loss "
          f"{loss_rel}, gradient {worst}")
    losses = [g0]
    for _ in range(TM_STEPS - 1):
        t0 = time.perf_counter()
        out = exe.run(prog["main"], feed=feed, fetch_list=[prog["loss"]],
                      scope=scope)
        losses.append(float(np.asarray(out[0]).reshape(())))
        ms.append((time.perf_counter() - t0) * 1e3)
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"detection (c): the loss did not fall: {losses}")
    return {"losses": losses, "step_ms": ms,
            "step_ms_median": statistics.median(ms[1:]),
            "parity": {"loss_rel": loss_rel, "grad_rel": worst[0],
                       "worst_param": worst[1]},
            "traced_step": _traced(dev, lambda: exe.run(
                prog["main"], feed=feed, fetch_list=[prog["loss"]],
                scope=scope)),
            "peak_bytes": _det_peak(dev)}


def _boxes_np(rng, n, size=1.0, lo=0.05, hi=0.4):
    """n valid [x1, y1, x2, y2] boxes inside [0, size], sides lo..hi of
    it."""
    wh = rng.uniform(lo, hi, (n, 2)) * size
    xy = rng.uniform(0.0, 1.0, (n, 2)) * (size - wh)
    return np.concatenate([xy, xy + wh], 1).astype("float32")


def det_sweep_cases(rng):
    """(d)'s cases: (op type, inputs, attrs, class): the 41 op types
    this slice adds and the repaired top_k and top_k_v2 on tied inputs;
    yolov3_loss and yolo_box at YOLOv3's 608-input coarse scale [8, 255,
    19, 19], multiclass_nms at (a)'s 1917 priors x 21 classes (batch
    8), the rest at the shapes of tests/test_torch_detection.py. The
    random ops at use_random=True are held by `det_sweep_random`."""
    def n(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype("float32")

    def i32(*v):
        return np.array(v, "int32")

    pvar = np.tile(np.array([[0.1, 0.1, 0.2, 0.2]], "float32"), (6, 1))
    rois = _boxes_np(rng, 5, 16.0, 0.2, 0.7)
    ygt = np.concatenate([rng.uniform(0.1, 0.9, (8, 6, 2)),
                          rng.uniform(0.05, 0.6, (8, 6, 2))], 2).astype(
        "float32")
    anchors = [116, 90, 156, 198, 373, 326, 30, 61, 62, 45, 59, 119,
               10, 13, 16, 30, 33, 23]
    prior = _boxes_np(rng, SSD_PRIORS, 1.0, 0.05, 0.6)
    ssd_gt = np.stack([_boxes_np(rng, 4, 1.0, 0.1, 0.5) for _ in range(2)])
    anc = _boxes_np(rng, 40, 64.0, 0.1, 0.5)
    gt3 = _boxes_np(rng, 3, 64.0, 0.2, 0.5)
    gt3[2] = gt3[1]
    ret_anc = [np.tile(np.array([[0, 0, 31, 31]], "float32"), (8, 1)) +
               np.arange(8, dtype="float32")[:, None] * 8,
               np.tile(np.array([[0, 0, 63, 63]], "float32"), (4, 1)) +
               np.arange(4, dtype="float32")[:, None] * 16]
    det = np.concatenate([rng.randint(0, 3, (2, 6, 1)),
                          rng.uniform(0.1, 1.0, (2, 6, 1)),
                          np.stack([_boxes_np(rng, 6) for _ in range(2)])],
                         2).astype("float32")
    lab = np.concatenate([rng.randint(-1, 3, (2, 4, 1)),
                          np.stack([_boxes_np(rng, 4) for _ in range(2)]),
                          rng.randint(0, 2, (2, 4, 1))], 2).astype("float32")
    tied = np.round(rng.uniform(0, 1, (4, 40)) * 5).astype("float32")
    return [
        ("iou_similarity", {"X": [_boxes_np(rng, 5)],
                            "Y": [_boxes_np(rng, 6)]}, {}, "ew"),
        ("box_coder", {"PriorBox": [_boxes_np(rng, 6)], "PriorBoxVar": [pvar],
                       "TargetBox": [n(5, 6, 4, scale=0.5)]},
         {"code_type": "decode_center_size"}, "ew"),
        ("prior_box", {"Input": [n(1, 8, 19, 19)],
                       "Image": [n(1, 3, 300, 300)]},
         {"min_sizes": [60.0], "max_sizes": [], "aspect_ratios": [2.0],
          "flip": True, "offset": 0.5}, "ew"),
        ("density_prior_box", {"Input": [n(1, 8, 3, 3)],
                               "Image": [n(1, 3, 24, 24)]},
         {"fixed_sizes": [4.0, 8.0], "fixed_ratios": [1.0, 2.0],
          "densities": [2, 1], "clip": True}, "ew"),
        ("anchor_generator", {"Input": [n(1, 8, 3, 4)]},
         {"anchor_sizes": [32.0, 64.0], "aspect_ratios": [0.5, 1.0, 2.0],
          "stride": [16.0, 16.0]}, "ew"),
        ("box_clip", {"Input": [n(2, 5, 4, scale=40.0)],
                      "ImInfo": [np.array([[40, 30, 1], [20, 20, 1]],
                                          "float32")]}, {}, "ew"),
        ("polygon_box_transform", {"Input": [n(1, 8, 3, 4)]}, {}, "ew"),
        ("box_decoder_and_assign",
         {"PriorBox": [_boxes_np(rng, 6, 40.0)], "PriorBoxVar": [pvar],
          "TargetBox": [n(6, 12, scale=0.5)], "BoxScore": [n(6, 3)]},
         {"box_clip": 4.135}, "ew"),
        ("yolo_box", {"X": [n(8, 255, 19, 19)],
                      "ImgSize": [np.tile(np.array([[608, 608]], "int32"),
                                          (8, 1))]},
         {"anchors": anchors[:6], "class_num": 80, "conf_thresh": 0.01,
          "downsample_ratio": 32}, "ew"),
        ("roi_align", {"X": [n(1, 3, 8, 10)], "ROIs": [rois]},
         {"pooled_height": 2, "pooled_width": 3, "spatial_scale": 0.5,
          "sampling_ratio": 2}, "mm"),
        ("roi_pool", {"X": [n(1, 3, 8, 10)], "ROIs": [rois]},
         {"pooled_height": 2, "pooled_width": 2, "spatial_scale": 0.5},
         "ew"),
        ("psroi_pool", {"X": [n(1, 8, 8, 8)], "ROIs": [rois]},
         {"output_channels": 2, "pooled_height": 2, "pooled_width": 2,
          "spatial_scale": 0.5}, "mm"),
        ("prroi_pool", {"X": [n(1, 12, 8, 8)], "ROIs": [rois]},
         {"output_channels": 2, "pooled_height": 2, "pooled_width": 3,
          "spatial_scale": 0.5}, "mm"),
        ("deformable_psroi_pooling",
         {"Input": [n(1, 8, 8, 8)], "ROIs": [rois[:3]],
          "Trans": [n(3, 2, 2, 2)]},
         {"spatial_scale": 0.5, "output_dim": 2, "group_size": [2, 2],
          "pooled_height": 2, "pooled_width": 2, "part_size": [2, 2],
          "sample_per_part": 2, "trans_std": 0.1, "no_trans": False}, "ew"),
        ("roi_perspective_transform",
         {"X": [n(1, 2, 8, 8)],
          "ROIs": [np.array([[1, 1, 6, 2, 7, 6, 2, 7],
                             [0.5, 3, 4, 0.5, 5, 5, 1, 6]], "float32")]},
         {"transformed_height": 4, "transformed_width": 5}, "ew"),
        ("bipartite_match", {"DistMat": [rng.uniform(0, 1, (2, 4, 6)).astype(
            "float32")]}, {"match_type": "per_prediction",
                           "dist_threshold": 0.5}, "ew"),
        ("target_assign", {"X": [n(2, 3, 4)],
                           "MatchIndices": [rng.randint(-1, 3, (2, 5)).astype(
                               "int32")],
                           "NegFlag": [rng.randint(0, 2, (2, 5)).astype(
                               "int32")]}, {"mismatch_value": 7.0}, "ew"),
        ("mine_hard_examples",
         {"ClsLoss": [np.round(rng.uniform(0, 1, (2, 8)) * 4).astype(
             "float32") / 4],
          "MatchIndices": [rng.randint(-3, 2, (2, 8)).astype("int32")]},
         {"neg_pos_ratio": 1.5}, "ew"),
        ("rpn_target_assign", {"Anchor": [anc], "GtBoxes": [gt3]},
         {"rpn_batch_size_per_im": 16, "rpn_fg_fraction": 0.25,
          "rpn_positive_overlap": 0.5, "rpn_negative_overlap": 0.3,
          "use_random": False}, "ew"),
        ("retinanet_target_assign",
         {"Anchor": [anc], "GtBoxes": [np.concatenate(
             [gt3, _boxes_np(rng, 1, 64.0, 0.2, 0.5)])],
          "GtLabels": [i32(2, 1, 3, 0)]},
         {"positive_overlap": 0.5, "negative_overlap": 0.4}, "ew"),
        ("generate_proposal_labels",
         {"RpnRois": [np.stack([_boxes_np(rng, 20, 64.0, 0.1, 0.6)] * 2)],
          "GtBoxes": [np.stack([gt3] * 2)],
          "GtClasses": [np.array([[1, 4, 0], [2, 2, 3]], "int32")],
          "IsCrowd": [np.array([[0, 0, 0], [0, 1, 0]], "int32")]},
         {"batch_size_per_im": 8, "fg_fraction": 0.25, "fg_thresh": 0.3,
          "class_nums": 5, "use_random": False}, "ew"),
        ("generate_mask_labels",
         {"GtSegms": [(rng.uniform(0, 1, (3, 16, 16)) > 0.5).astype(
             "int32")], "Rois": [_boxes_np(rng, 5, 16.0, 0.2, 0.8)],
          "LabelsInt32": [i32(1, 0, 2, -1, 3)],
          "MatchedGts": [i32(0, 1, 2, 0, 1)]}, {"resolution": 4}, "ew"),
        ("sigmoid_focal_loss",
         {"X": [n(8, 5)], "Label": [rng.randint(0, 6, (8, 1)).astype(
             "int32")], "FgNum": [i32(5)]}, {"gamma": 2.0, "alpha": 0.25},
         "ew"),
        ("yolov3_loss", {"X": [n(8, 255, 19, 19)], "GTBox": [ygt],
                         "GTLabel": [rng.randint(0, 80, (8, 6)).astype(
                             "int32")]},
         {"anchors": anchors, "anchor_mask": [0, 1, 2], "class_num": 80,
          "ignore_thresh": 0.7, "downsample_ratio": 32}, "ew"),
        ("ssd_loss", {"Location": [n(2, SSD_PRIORS, 4, scale=0.5)],
                      "Confidence": [n(2, SSD_PRIORS, SSD_CLASSES)],
                      "GtBox": [ssd_gt],
                      "GtLabel": [np.array([[3, 7, 9, -1], [1, 1, 20, 5]],
                                           "int64")],
                      "PriorBox": [prior],
                      "PriorBoxVar": [np.tile(pvar[:1], (SSD_PRIORS, 1))]},
         {}, "ew"),
        ("multiclass_nms", {"BBoxes": [np.stack([prior] * 8)],
                            "Scores": [rng.uniform(0, 1, (
                                8, SSD_CLASSES, SSD_PRIORS)).astype(
                                "float32") ** 4]},
         dict(SSD_NMS, background_label=0, normalized=True), "ew"),
        ("multiclass_nms2", {"BBoxes": [np.stack([_boxes_np(rng, 14)] * 2)],
                             "Scores": [np.round(rng.uniform(
                                 0, 1, (2, 4, 14)) * 4).astype(
                                     "float32") / 4]},
         {"score_threshold": 0.1, "nms_top_k": 6, "nms_threshold": 0.4,
          "keep_top_k": 8}, "ew"),
        ("generate_proposals",
         {"Scores": [rng.uniform(0, 1, (2, 6, 4, 4)).astype("float32")],
          "BboxDeltas": [n(2, 24, 4, 4, scale=0.2)],
          "ImInfo": [np.array([[64, 64, 1], [48, 60, 1.5]], "float32")],
          "Anchors": [_boxes_np(rng, 96, 64.0).reshape(4, 4, 6, 4)],
          "Variances": [np.ones((4, 4, 6, 4), "float32")]},
         {"pre_nms_topN": 30, "post_nms_topN": 8, "nms_thresh": 0.5,
          "min_size": 4.0}, "ew"),
        ("collect_fpn_proposals",
         {"MultiLevelRois": [np.stack([_boxes_np(rng, 5, 64.0)] * 2),
                             np.stack([_boxes_np(rng, 4, 64.0)] * 2)],
          "MultiLevelScores": [rng.uniform(0, 1, (2, 5)).astype("float32"),
                               rng.uniform(0, 1, (2, 4)).astype("float32")],
          "MultiLevelRoisNum": [i32(3, 5), i32(4, 1)]},
         {"post_nms_topN": 6}, "ew"),
        ("distribute_fpn_proposals",
         {"FpnRois": [np.concatenate([_boxes_np(rng, 5, 400.0, 0.02, 0.1),
                                      _boxes_np(rng, 5, 400.0, 0.3, 0.9)])]},
         {"min_level": 2, "max_level": 5, "refer_level": 4,
          "refer_scale": 224.0}, "ew"),
        ("retinanet_detection_output",
         {"BBoxes": [n(2, 8, 4, scale=0.1), n(2, 4, 4, scale=0.1)],
          "Scores": [rng.uniform(0, 0.5, (2, 8, 3)).astype("float32"),
                     rng.uniform(0, 0.5, (2, 4, 3)).astype("float32")],
          "Anchors": ret_anc,
          "ImInfo": [np.array([[128, 128, 1], [60, 100, 1]], "float32")]},
         {"score_threshold": 0.05, "nms_top_k": 6, "nms_threshold": 0.3,
          "keep_top_k": 5}, "ew"),
        ("detection_map", {"DetectRes": [det], "Label": [lab]},
         {"class_num": 3, "overlap_threshold": 0.5, "ap_type": "11point",
          "evaluate_difficult": False, "max_dets": 16}, "ew"),
        ("pad_constant_like", {"X": [n(4, 5)], "Y": [n(2, 3)]},
         {"pad_value": 7.0}, "ew"),
        ("squared_l2_distance", {"X": [n(5, 4)], "Y": [n(1, 4)]}, {}, "ew"),
        ("bilinear_tensor_product", {"X": [n(3, 4)], "Y": [n(3, 5)],
                                     "Weight": [n(2, 4, 5)],
                                     "Bias": [n(1, 2)]}, {}, "mm"),
        ("conv_shift", {"X": [n(2, 7)], "Y": [n(2, 3)]}, {}, "ew"),
        ("cvm", {"X": [rng.uniform(0, 9, (5, 6)).astype("float32")],
                 "CVM": [rng.uniform(0, 1, (5, 2)).astype("float32")]},
         {"use_cvm": True}, "ew"),
        ("hash", {"X": [rng.randint(0, 2 ** 31 - 1, (64, 4)).astype(
            "int64")]}, {"num_hash": 3, "mod_by": 1000003}, "exact"),
        ("match_matrix_tensor", {"X": [n(2, 4, 6)], "Y": [n(2, 5, 6)],
                                 "W": [n(6, 3, 6)]}, {}, "mm"),
        ("var_conv_2d", {"X": [n(3, 2, 7, 6)], "W": [n(4, 18)],
                         "ROW": [np.array([7, 3, 1], "int64")],
                         "COLUMN": [np.array([2, 6, 5], "int64")]},
         {"kernel_h": 3, "kernel_w": 3, "stride_h": 2, "stride_w": 2}, "mm"),
        ("filter_by_instag", {"Ins": [n(6, 3)],
                              "Ins_tag": [np.array([[1, -1], [4, 2], [3, -1],
                                                    [2, 2], [5, 6], [9, 1]],
                                                   "int64")],
                              "Filter_tag": [np.array([1, 2], "int64")]},
         {}, "ew"),
        ("top_k", {"X": [tied]}, {"k": 12}, "ew"),
        ("top_k_v2", {"X": [tied.T.copy()]}, {"k": 7, "axis": 0}, "ew"),
    ]


def _nms_forward(op_type, attrs):
    """The forward comparison of an NMS op's outputs in (d): its rows
    through `_nms_rows_held`, its counts exactly where no near tie."""
    def compare(got, want):
        if op_type == "generate_proposals":
            g = np.concatenate([got["RpnRoiProbs"][0], got["RpnRois"][0]], 2)
            w = np.concatenate([want["RpnRoiProbs"][0],
                                want["RpnRois"][0]], 2)
            thr, norm, by_class, num = attrs["nms_thresh"], False, False, \
                "RpnRoisNum"
        else:
            g, w = got["Out"][0], want["Out"][0]
            thr = attrs.get("nms_threshold", 0.3)
            norm = attrs.get("normalized", True) and \
                op_type != "retinanet_detection_output"
            by_class, num = True, "NmsRoisNum"
        ties, worst = _nms_rows_held("detection (d)", g, w, thr, norm,
                                     by_class, op_type)
        if ties == 0:
            check(all(np.array_equal(got[k][0], want[k][0])
                      for k in want if k not in ("Out", "RpnRois",
                                                 "RpnRoiProbs")),
                  f"detection (d): {op_type}'s {num} or Index differ")
        return worst
    return compare


def det_sweep_random(device):
    """(d)'s random ops at use_random=True on `device`, by their laws:
    rpn_target_assign's and generate_proposal_labels' picks inside their
    masks (the use_random=False call's complete lists), at most the
    quota of foreground, no repeats, the same draws for the same seed
    and others for another."""
    rng = np.random.RandomState(DET_SEED)
    anchor = _boxes_np(rng, 3000, 256.0, 0.05, 0.4)
    gt = _boxes_np(rng, 6, 256.0, 0.1, 0.4)
    attrs = {"rpn_batch_size_per_im": 256, "rpn_fg_fraction": 0.5,
             "rpn_positive_overlap": 0.5, "rpn_negative_overlap": 0.3,
             "__rng_uid__": 3}
    ins = {"Anchor": [anchor], "GtBoxes": [gt]}
    full = op_call("rpn_target_assign", ins,
                   dict(attrs, rpn_batch_size_per_im=6000, use_random=False),
                   device)
    fg_all = set(full["LocationIndex"][0][full["LocationIndex"][0] >= 0])
    sc = full["ScoreIndex"][0][3000:]
    bg_all = set(sc[sc >= 0])
    draws = []
    for key in (41, 41, 42):
        out = op_call("rpn_target_assign", ins, dict(attrs, use_random=True),
                      device, rng_key=key)
        fg, bg = out["LocationIndex"][0], out["ScoreIndex"][0][128:]
        fg, bg = fg[fg >= 0], bg[bg >= 0]
        check(len(fg) == min(128, len(fg_all)) and
              len(bg) == min(128, len(bg_all)) and set(fg) <= fg_all and
              set(bg) <= bg_all and len(set(fg)) == len(fg) and
              len(set(bg)) == len(bg),
              f"detection (d): rpn_target_assign's draws: {len(fg)} fg of "
              f"{len(fg_all)}, {len(bg)} bg of {len(bg_all)}")
        draws.append(np.concatenate([fg, bg]))
    check(np.array_equal(draws[0], draws[1]) and
          not np.array_equal(draws[0], draws[2]),
          "detection (d): rpn_target_assign's draws and their seeds")
    rois = _boxes_np(rng, 400, 256.0, 0.05, 0.5)
    rois[:60] = np.repeat(gt, 10, 0) + rng.uniform(-4, 4, (60, 4)).astype(
        "float32")
    gins = {"RpnRois": [rois[None]], "GtBoxes": [gt[None]],
            "GtClasses": [np.arange(1, 7, dtype="int32")[None]]}
    gattrs = {"batch_size_per_im": 128, "fg_fraction": 0.25,
              "class_nums": 7, "__rng_uid__": 4}
    ref = op_call("generate_proposal_labels", gins,
                  dict(gattrs, batch_size_per_im=400, fg_fraction=1.0,
                       use_random=False), device)
    fg_rows = {tuple(r) for r, lb in zip(ref["Rois"][0][0],
                                         ref["LabelsInt32"][0][0]) if lb > 0}
    outs = []
    for key in (43, 43, 44):
        out = op_call("generate_proposal_labels", gins,
                      dict(gattrs, use_random=True), device, rng_key=key)
        lab = out["LabelsInt32"][0][0]
        got = [tuple(r) for r, lb in zip(out["Rois"][0][0][:32], lab[:32])
               if lb >= 0]
        check(len(got) == min(32, len(fg_rows)) and set(got) <= fg_rows and
              len(set(got)) == len(got) and (lab[:32] != 0).all() and
              (lab[32:] <= 0).all(),
              f"detection (d): generate_proposal_labels' draws: {len(got)} "
              f"fg of {len(fg_rows)}")
        outs.append(out["Rois"][0])
    check(np.array_equal(outs[0], outs[1]) and
          not np.array_equal(outs[0], outs[2]),
          "detection (d): generate_proposal_labels' draws and their seeds")
    return {"rpn_fg_bg": [int(min(128, len(fg_all))),
                          int(min(128, len(bg_all)))],
            "proposal_label_fg": int(min(32, len(fg_rows)))}


def det_sweep(device):
    """Phase 34 (d): every op type this slice adds and the repaired
    top_k and top_k_v2 on tied inputs, once on `device` against the
    CPU (the top-k ops also against a stable numpy sort), and
    sparse_allreduce on tied inputs."""
    import torch

    from paddle_tpu_torch.ops.collective import sparse_allreduce

    rng = np.random.RandomState(DET_SEED)
    worst, secs = {}, {}
    for op_type, ins, attrs, cls in det_sweep_cases(rng):
        fwd = _nms_forward(op_type, attrs) if op_type in (
            "multiclass_nms", "multiclass_nms2", "generate_proposals",
            "retinanet_detection_output") else None
        t = time.perf_counter()
        worst[op_type] = sweep_op(op_type, ins, attrs, cls, device, rng,
                                  "detection (d)", fwd)
        secs[op_type] = time.perf_counter() - t
        if op_type.startswith("top_k"):
            x = ins["X"][0]
            axis = attrs.get("axis", -1)
            order = np.argsort(-x, axis=axis, kind="stable")
            want = np.take(order, np.arange(attrs["k"]), axis=axis)
            got = op_call(op_type, ins, attrs, device)["Indices"][0]
            check(np.array_equal(got, want),
                  f"detection (d): {op_type}'s tie order is not the stable "
                  "sort's")
    law = det_sweep_random(device)
    flats = [np.round(rng.standard_normal(4096) * 2).astype("float32")
             for _ in range(4)]
    got = sparse_allreduce([torch.from_numpy(f).to(device) for f in flats],
                           100).cpu().numpy()
    want = sparse_allreduce([torch.from_numpy(f) for f in flats],
                            100).numpy()
    check(np.array_equal(got, want),
          "detection (d): sparse_allreduce on tied inputs differs")
    types = set(worst) | {"rpn_target_assign", "generate_proposal_labels"}
    check(len(types) == 43, f"detection (d): {len(types)} op types swept")
    return {"op_types": len(types), "worst_abs": worst, "random": law,
            "seconds": secs, "sparse_allreduce_nonzero": int(
                (got != 0).sum())}


def phase_detection():
    """Phase 34: (a)-(d) above."""
    import torch

    import paddle_tpu_torch as pt

    t0 = time.perf_counter()
    before = _kernel_counts()
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out, secs = {}, {}
    try:
        for part, fn in (("a", lambda: det_ssd(pt)),
                         ("b", lambda: det_proposals(pt)),
                         ("c", lambda: det_text_match(pt)),
                         ("d", lambda: det_sweep(
                             pt.CUDAPlace(0).torch_device()))):
            t = time.perf_counter()
            _peak_reset()
            out[part] = fn()
            out[part].setdefault("peak_bytes", _peak())
            secs[part] = time.perf_counter() - t
            torch.cuda.empty_cache()
            print(json.dumps({"phase": "detection", "part": part,
                              "card": card(), "seconds": secs[part]}),
                  flush=True)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags
    check(_kernel_counts() == before,
          "detection: a kernel of the table launched in phase 34")
    print(json.dumps({
        "phase": "detection", "card": card(),
        "programs": f"mobilenet_ssd.py's MobileNet-v1 SSD, {SSD_HW} x "
                    f"{SSD_HW}, {SSD_CLASSES} classes, {SSD_PRIORS} priors, "
                    f"batch {SSD_B}, RMSProp {SSD_LR} x {SSD_STEPS}, eval "
                    f"detection_output {SSD_NMS} and detection_map 11point; "
                    f"Faster R-CNN proposals on {RCNN_HW[0]} x {RCNN_HW[1]} "
                    f"(C4 {RCNN_FEAT}, Detectron's defaults); text matching "
                    f"{TM_SIZE}, Adam {TM_LR} x {TM_STEPS}; 43 op types; "
                    "f32, TF32 off",
        "a_ssd": out["a"], "b_proposals": out["b"], "c_text_match": out["c"],
        "d_sweep": out["d"], "limits": DET_TOL, "part_seconds": secs,
        "seconds": time.perf_counter() - t0}))
    torch.cuda.empty_cache()


# phase 35: the serving operator's tools on the card
TOOLS_CHUNK = 16                # bake-decode --prefill-chunk
TOOLS_SPEC_K = 2                # bake-decode --spec-k
# token mode's engine (serve_bench._build_decode_engine) at the tool's
# default grid: block 8, max_len = the largest bucket + 64 + 8, its
# pool; bake-decode bakes that engine's grid with these flags
TOOLS_TOKEN_GRID = ["--slots", "4,8", "--prefill-buckets", "8,16,32",
                    "--block-size", "8", "--max-len", "104",
                    "--num-blocks", "109"]
# the JAX tool's --smoke traffic for token mode, at the default grid
TOOLS_TOKEN_TRAFFIC = ["--rate", "600", "--duration", "0.08",
                       "--timeout-s", "120"]
TOOLS_PROFILE_S = 1.0           # the capture taken during (d)
TOOLS_AUTOSCALE_S = 60          # autoscale --duration: an upper bound,
#                                 the phase interrupts it once answered
TOOLS_OBSDUMP = {               # (g): subcommand -> text its table holds
    "snapshot": "paddle_tpu_fleet_requests_total",
    "events": "fleet",
    "trace": "decode.ttft",
    "decode": "tokens",
    "tenants": "gold-client",
    "fleet": "world size",
    "top": "recording pid",
    "slo": "predict-latency",
    "mem": "watermark",
    "profile": "capture dir",
}


def _tool_cli(args, timeout=600):
    """(rc, stdout, stderr) of `python <args>` run from this checkout."""
    r = subprocess.run([sys.executable] + list(args), capture_output=True,
                       text=True, timeout=timeout,
                       cwd=os.path.dirname(os.path.abspath(__file__)))
    return r.returncode, r.stdout, r.stderr


def _tool_lines(fn, *args, **kw):
    """(rc, {metric: line}) of a serve_bench mode run in this process,
    its JSON lines taken from stdout."""
    import contextlib
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = fn(*args, **kw)
    lines = [json.loads(ln) for ln in out.getvalue().splitlines()
             if ln.startswith("{")]
    return rc, {ln["metric"]: ln for ln in lines}


def _tools_cli_bake(root):
    """(a), by the CLI: `warmstart bake-decode` at tiny, then `inspect`
    by file path on its artifact."""
    tiny = os.path.join(root, "tiny.warmstart")
    rc, text, err = _tool_cli(["-m", "paddle_tpu_torch.tools.warmstart",
                               "bake-decode", "--out", tiny])
    check(rc == 0, f"tools (a): bake-decode rc {rc}: {err[-2000:]}")
    line = json.loads(text)
    check(line["entries"] == line["phases_ready"] == 5,
          f"tools (a): tiny bake {line}")
    rc, text, err = _tool_cli([os.path.join(
        "paddle_tpu_torch", "tools", "warmstart.py"), "inspect", tiny])
    check(rc == 0, f"tools (a): inspect rc {rc}: {err[-2000:]}")
    rep = json.loads(text)
    with open(tiny) as f:
        art = json.load(f)
    check(rep["entries"] == len(art["entries"]) == line["entries"] and
          sorted(s["phase"] for s in rep["signatures"]) == sorted(
              f"{e['phase']}@{e['size']}" for e in art["entries"]) and
          rep["device_name"] == art["device_name"],
          f"tools (a): inspect {rep}")
    line.pop("artifact")
    return {"bake": line, "device_name": rep["device_name"]}


def _tools_cli_bake_predict(model_dir, art):
    """(f), by the CLI: `warmstart bake` of the MLP in `model_dir`."""
    rc, text, err = _tool_cli(["-m", "paddle_tpu_torch.tools.warmstart",
                               "bake", "--model-dir", model_dir, "--out",
                               art])
    check(rc == 0, f"tools (f): bake rc {rc}: {err[-2000:]}")
    bake = json.loads(text)
    check(bake["entries"] == bake["buckets_ready"] ==
          len(bake["buckets"]) > 0, f"tools (f): bake {bake}")
    for key in ("artifact", "model_dir"):
        bake.pop(key)
    return bake


def _tools_bake(root):
    """(a), in this process: the three grids at GPT-2-small, each
    adopted whole by an engine of the same seed, time to healthy cold
    and warm; another seed adopts none. Returns (report, the token
    grid's artifact)."""
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.observability import events
    from paddle_tpu_torch.tools import warmstart as ws

    out = {}
    cfg = gpt.GPTConfig()                       # GPT-2-small
    grids = {"default": TOOLS_TOKEN_GRID,
             "chunked": TOOLS_TOKEN_GRID + ["--prefill-chunk",
                                            str(TOOLS_CHUNK)],
             "speculative": TOOLS_TOKEN_GRID + ["--spec-k",
                                                str(TOOLS_SPEC_K)]}
    for name, flags in grids.items():
        path = os.path.join(root, f"gpt2_{name}.warmstart")
        args = ws.build_parser().parse_args(
            ["bake-decode", "--out", path, "--preset", "gpt2-small"]
            + flags)
        line = ws.bake_decode(args, cfg=cfg)
        t = time.perf_counter()
        eng = ws.decode_engine(args, cfg=cfg)
        try:
            adopted = eng.load_warmstart(path)
            warm_s = time.perf_counter() - t
            grid = len(eng._phase_keys())
        finally:
            eng.stop()
        check(adopted == line["entries"] == line["phases_ready"] == grid,
              f"tools (a): {name} adopted {adopted} of {line}")
        out[name] = {"phases": grid, "bake_warmup_seconds":
                     line["warmup_seconds"],
                     "healthy_cold_s": line["warmup_seconds"],
                     "healthy_warm_s": round(warm_s, 3),
                     "artifact_bytes": line["artifact_bytes"]}
        print(json.dumps({"phase": "tools", "part": "a", "grid": name,
                          "card": card(), **out[name]}), flush=True)
    args = ws.build_parser().parse_args(
        ["bake-decode", "--out", "unused", "--seed", "1"] + TOOLS_TOKEN_GRID)
    eng = ws.decode_engine(args, cfg=cfg)
    try:
        foreign = eng.load_warmstart(os.path.join(root,
                                                  "gpt2_default.warmstart"))
    finally:
        eng.stop()
    ev = events.recent(1, kind="warmstart")[-1]
    check(foreign == 0 and ev["action"] == "reject",
          f"tools (a): seed 1 adopted {foreign}, event {ev}")
    out["foreign_seed"] = {"adopted": foreign, "event": ev["reason"]}
    return out, os.path.join(root, "gpt2_default.warmstart")


def _tools_token(art):
    """(b): token mode at GPT-2-small with (a)'s artifact."""
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.tools import serve_bench as sb

    args = sb._build_args(["--tokens", "--warmstart", art]
                          + TOOLS_TOKEN_TRAFFIC)
    rc, m = _tool_lines(sb.run_token_bench, args,
                        device=_torch_device(), cfg=gpt.GPTConfig())
    cont = m["decode_tokens_per_sec_continuous"]["detail"]
    stat = m["decode_tokens_per_sec_static"]["detail"]
    rep = m["decode_warm_replay_fresh_compiles"]
    d = rep["detail"]
    check(rc == 0 and cont["error"] == stat["error"] == 0 and
          cont["tokens"] > 0, f"tools (b): rc {rc}, {cont}, {stat}")
    check(d["bit_identical"] and d["adopted"] == d["phases"] > 0,
          f"tools (b): warm replay {d}")
    check(rep["value"] == 0, f"tools (b): {rep['value']} eager decode "
          "steps in the warm replay")
    check(d["k1_fwd_launches"] > 0 and d["k1_fwd_launches"] ==
          d["attention_routes"].get("flash_cuda"),
          f"tools (b): K1-fwd {d['k1_fwd_launches']}, routes "
          f"{d['attention_routes']}")
    keys = ("tokens_per_sec", "tokens", "ttft_p50_ms", "ttft_p99_ms",
            "e2e_p50_ms", "e2e_p99_ms", "token_gap_p50_ms",
            "token_gap_p99_ms")
    return {"continuous": {k: cont[k] for k in keys},
            "static": {k: stat[k] for k in keys},
            "speedup": m["decode_continuous_speedup"]["value"],
            "equal_p99_ok": m["decode_continuous_speedup"]["detail"][
                "equal_p99_ok"],
            "adopted": d["adopted"], "phases": d["phases"],
            "eager_decode_steps_warm": rep["value"],
            "requests": d["requests"], "hbm_peak_bytes": d["hbm_peak_bytes"],
            "mfu": d["mfu"]}, d["k1_fwd_launches"]


def _torch_device():
    import torch

    return torch.device("cuda", torch.cuda.current_device())


def _tools_prefix():
    """(c): prefix-share at GPT-2-small."""
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.tools import serve_bench as sb

    args = sb._build_args(["--tokens", "--prefix-share"])
    rc, m = _tool_lines(sb.run_prefix_bench, args, device=_torch_device(),
                        cfg=gpt.GPTConfig())
    d = m["decode_prefix_share_ttft_speedup"]["detail"]
    check(rc == 0 and d["bit_identical"] and d["prefix_hits"] > 0 and
          m["decode_spec_accept_rate"]["value"] >= 0.99,
          f"tools (c): rc {rc}, {json.dumps(d)[:3000]}")
    return {"prefix_hits": d["prefix_hits"],
            "spec_accept_rate": m["decode_spec_accept_rate"]["value"],
            "ttft_warm_p50_ms": {"plain": d["plain"]["ttft_warm_p50_ms"],
                                 "kv_reuse":
                                 d["kv_reuse"]["ttft_warm_p50_ms"]},
            "ttft_speedup": m["decode_prefix_share_ttft_speedup"]["value"],
            "tokens_per_sec": {"plain": d["plain"]["tokens_per_sec"],
                               "kv_reuse": d["kv_reuse"]["tokens_per_sec"]},
            }, d["k1_fwd_launches"]


def _tools_tenants(profile_dir):
    """(d): tenants mode on the card, with a profile capture taken
    while it runs."""
    from paddle_tpu_torch import profiler
    from paddle_tpu_torch.tools import serve_bench as sb

    args = sb.smoke_settings(sb._build_args(["--tenants", "--smoke"]))
    # the profiler's first start imports torch._dynamo: import it here,
    # not in the capture thread beside the tool's first torch calls
    import torch._dynamo  # noqa: F401
    import torch.profiler  # noqa: F401

    box = {}
    cap = threading.Thread(target=lambda: box.update(
        profiler.capture_profile(TOOLS_PROFILE_S, out_dir=profile_dir)),
        daemon=True)
    cap.start()
    rc, m = _tool_lines(sb.run_tenants_bench, args, device=_torch_device())
    cap.join(timeout=300)
    d = m["tenant_gold_p99_ms"]["detail"]
    swap = d["swap"]
    check(rc == 0 and d["gold"]["failed"] == 0 and
          d["shed_delta"].get("bronze", 0) > 0 and
          d["shed_delta"].get("gold", 0) == 0 and swap["failed"] == 0 and
          swap["warmstart_adopted"] == len(swap["buckets"] or ()) > 0,
          f"tools (d): rc {rc}, {json.dumps(d)[:3000]}")
    check(box.get("dir") == profile_dir, f"tools (d): capture {box}")
    return {"gold": d["gold"], "bronze_sheds": d["shed_delta"]["bronze"],
            "flood": d["flood"], "swap": swap}


def _tools_fleet():
    """(e): fleet mode on the card at the smoke's traffic."""
    from paddle_tpu_torch.tools import serve_bench as sb

    args = sb.smoke_settings(sb._build_args(
        ["--fleet", "--smoke", "--replicas", "2", "--fleet-max", "3"]))
    rc, m = _tool_lines(sb.run_fleet_bench, args, device=_torch_device())
    det = {k: v["detail"] for k, v in m.items()}
    fail = det["fleet_failover_failed_requests"]
    out = det["fleet_scaleout_p99_recovered"]
    trace = det["fleet_trace_reconstructed"]
    slo = det["fleet_slo_alert_fired"]
    check(rc == 0 and m["fleet_failover_failed_requests"]["value"] == 0 and
          m["fleet_scalein_dropped_requests"]["value"] == 0,
          f"tools (e): rc {rc}, failed requests "
          f"{json.dumps({k: v['value'] for k, v in m.items()})}")
    check(fail["killed"] and out["scale_outs"] >= 1 and
          (out["warmstart_adopted"] or 0) > 0,
          f"tools (e): respawn/scale-out {json.dumps(out)[:2000]}")
    check(trace["generate_roots"] == 1 and
          trace["generate_processes"] >= 2,
          f"tools (e): generate trace {json.dumps(trace)[:2000]}")
    check("fast_burn" in slo["states_seen"] and
          slo["states_seen"][-1] == "ok",
          f"tools (e): slo_alert {slo['states_seen']}")
    return {
        "respawn_s": fail["respawn_s"], "boot_s": fail["boot_s"],
        "scaleout_s": out["scaleout_s"], "scale_outs": out["scale_outs"],
        "warmstart_adopted": out["warmstart_adopted"],
        "ejections": fail["ejections"], "retries": fail["retries"],
        "trace_overhead_p50": m["fleet_trace_overhead_p50"]["value"],
        "ts_overhead_p50": m["fleet_ts_overhead_p50"]["value"],
        "ts_recording_pids": m["fleet_ts_recording_pids"]["value"],
        "slo_states": slo["states_seen"],
        "breach_detect_s": slo["breach_detect_s"],
        "clear_s": slo["clear_s"],
        "generate_processes": trace["generate_processes"],
    }, {"trace_dir": trace["trace_dir"],
        "trace_id": trace["generate_trace_id"], "ts_dir": slo["ts_dir"],
        "slo_spec": slo["slo_spec"]}


def _tools_autoscale(root, model_dir, art):
    """(f): autoscale.py boots one replica of the MLP in `model_dir`
    from the artifact `art` and answers one predict through its router;
    interrupted once it has."""
    import signal

    t0 = time.perf_counter()
    repo = os.path.dirname(os.path.abspath(__file__))
    # stderr to a file: the replicas' log lines must not fill a pipe
    # nobody reads while the phase waits on stdout
    err_path = os.path.join(root, "autoscale.err")
    err_f = open(err_path, "w")
    proc = subprocess.Popen(
        [sys.executable, "-u", "-m", "paddle_tpu_torch.tools.autoscale",
         "--model-dir", model_dir, "--warmstart", art,
         "--replicas", "1", "--min", "1", "--max", "1", "--port", "0",
         "--rdzv-dir", os.path.join(root, "rdzv_autoscale"),
         "--status-every", "0.5", "--duration", str(TOOLS_AUTOSCALE_S)],
        cwd=repo, stdout=subprocess.PIPE, stderr=err_f, text=True)
    try:
        up = json.loads(proc.stdout.readline())
        port = up["router_port"]
        body = json.dumps({"feeds": {"x": np.random.RandomState(0).rand(
            1, 784).astype("float32").tolist()}}).encode()
        reply, deadline = None, time.monotonic() + TOOLS_AUTOSCALE_S
        while reply is None and time.monotonic() < deadline:
            try:
                req = urllib.request.Request(
                    f"http://127.0.0.1:{port}/v1/predict", data=body,
                    headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(req, timeout=30) as r:
                    reply = json.loads(r.read())
            except (urllib.error.URLError, OSError):
                time.sleep(0.2)
        answered_s = time.perf_counter() - t0
        # the first status line that counts the predict
        status, deadline = {}, time.monotonic() + 30
        while reply is not None and time.monotonic() < deadline and \
                status.get("requests", {}).get("ok", 0) < 1:
            status = json.loads(proc.stdout.readline() or "{}")
    finally:
        proc.send_signal(signal.SIGINT)      # the graceful shutdown
        try:
            proc.communicate(timeout=120)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
        err_f.close()
    with open(err_path) as f:
        err = f.read()
    check(reply is not None and reply.get("batch") == 1 and
          len(reply.get("outputs") or ()) == 1,
          f"tools (f): no predict answered ({reply}); {err[-2000:]}")
    check(proc.returncode == 0, f"tools (f): rc {proc.returncode}: "
          f"{err[-2000:]}")
    check(len(up["replicas"]) == 1 and status.get("replicas") == 1 and
          status.get("healthy") == 1, f"tools (f): {up} {status}")
    return {"answered_s": round(answered_s, 3), "status": status,
            "seconds": time.perf_counter() - t0}


def _in_thread(fn, *args):
    """`fn(*args)` started on a thread; the returned callable joins it
    and returns its result or raises its error."""
    box = {}

    def run():
        try:
            box["out"] = fn(*args)
        except BaseException as e:  # re-raised on the phase's thread
            box["error"] = e

    th = threading.Thread(target=run, daemon=True)
    th.start()

    def join():
        th.join(timeout=900)
        check(not th.is_alive(), f"tools: {fn.__name__} never returned")
        if "error" in box:
            raise box["error"]
        return box["out"]
    return join


def _tools_obsdump(dumps):
    """(g): obsdump by file path over what (a)-(f) wrote: each
    subcommand exits 0 with its table holding rows."""
    tool = os.path.join("paddle_tpu_torch", "tools", "obsdump.py")
    argvs = {
        "snapshot": ["snapshot", dumps["metrics"]],
        "events": ["events", dumps["events"], "-n", "50"],
        "trace": ["trace", dumps["trace_dir"], "--trace-id",
                  dumps["trace_id"]],
        "decode": ["decode", dumps["metrics"]],
        "tenants": ["tenants", dumps["metrics"]],
        "fleet": ["fleet", dumps["metrics"]],
        "top": ["top", dumps["ts_dir"], "--window", "3600"],
        "slo": ["slo", dumps["ts_dir"], "--spec", dumps["slo_spec"]],
        "mem": ["mem", dumps["metrics"]],
        "profile": ["profile", dumps["profile_dir"]],
    }
    runs = {name: _in_thread(_tool_cli, [tool] + argv, 120)
            for name, argv in argvs.items()}
    out = {}
    for name, join in runs.items():
        rc, text, err = join()
        check(rc == 0 and TOOLS_OBSDUMP[name] in text,
              f"tools (g): obsdump {name} rc {rc}: {text[:1500]} "
              f"{err[-1500:]}")
        out[name] = len(text.splitlines())
    return out


def phase_tools():
    """Phase 35: the serving operator's tools (`paddle_tpu_torch/tools/`)
    driven on the card as an operator would. Returns the K1-fwd
    launches of its in-process runs."""
    import shutil
    import tempfile

    import torch

    from paddle_tpu_torch import observability
    from paddle_tpu_torch.observability import memwatch

    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="chip_smoke_tools_")
    dumps = {"metrics": os.path.join(root, "metrics.json"),
             "events": os.path.join(root, "events.jsonl"),
             "profile_dir": os.path.join(root, "profile")}
    # the tools' replicas are processes of their own, at torch's default
    # TF32 flags: an artifact baked here with the flags this script sets
    # would be another environment to them
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    saved = (tempfile.tempdir, os.environ.get("PADDLE_TPU_EVENT_LOG"))
    tempfile.tempdir = root               # the tools' scratch dirs
    os.environ["PADDLE_TPU_EVENT_LOG"] = dumps["events"]
    secs, out, launches = {}, {}, 0
    try:
        # (a)'s and (f)'s processes start first and run beside (a), (c)
        # and (d) in this process: their boots (a torch import, a CUDA
        # context) are most of their time. (b), whose rates this phase
        # reports, runs after them on a quiet host.
        from paddle_tpu_torch.serving import Engine, ServingConfig
        from paddle_tpu_torch.tools import serve_bench as sb

        t = time.perf_counter()
        model_dir = os.path.join(root, "mlp")
        sb._save_model(model_dir, _torch_device())
        mlp_art = os.path.join(root, "mlp.warmstart")
        eng = Engine(ServingConfig(model_dir))
        eng.warmup()
        eng.export_warmstart(mlp_art)
        del eng
        cli_art = os.path.join(root, "mlp_cli.warmstart")
        cli_a = _in_thread(_tools_cli_bake, root)
        cli_bake = _in_thread(_tools_cli_bake_predict, model_dir, cli_art)
        cli_f = _in_thread(_tools_autoscale, root, model_dir, mlp_art)
        out["a_warmstart"], art = _tools_bake(root)
        out["a_warmstart"]["tiny"] = cli_a()
        out["f_bake"] = cli_bake()
        # the CLI's predict artifact is adopted whole here
        eng = Engine(ServingConfig(model_dir, warmstart=cli_art))
        check(eng.warmstart_adopted == out["f_bake"]["entries"],
              f"tools (f): {eng.warmstart_adopted} adopted of "
              f"{out['f_bake']}")
        del eng
        secs["a"] = time.perf_counter() - t
        t = time.perf_counter()
        out["c"], k1 = _tools_prefix()
        launches += k1
        secs["c"] = time.perf_counter() - t
        torch.cuda.empty_cache()
        t = time.perf_counter()
        out["d"] = _tools_tenants(dumps["profile_dir"])
        secs["d"] = time.perf_counter() - t
        t = time.perf_counter()
        out["f"] = cli_f()
        secs["f"] = out["f"]["seconds"]
        secs["f_wait"] = time.perf_counter() - t
        t = time.perf_counter()
        out["b"], k1 = _tools_token(art)
        launches += k1
        secs["b"] = time.perf_counter() - t
        torch.cuda.empty_cache()
        t = time.perf_counter()
        out["e"], fleet = _tools_fleet()
        dumps.update(fleet)
        secs["e"] = time.perf_counter() - t
        memwatch.sweep(force=True)
        with open(dumps["metrics"], "w") as f:
            json.dump(observability.snapshot(), f)
        t = time.perf_counter()
        out["g_obsdump_lines"] = _tools_obsdump(dumps)
        secs["g"] = time.perf_counter() - t
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags
        tempfile.tempdir = saved[0]
        if saved[1] is None:
            os.environ.pop("PADDLE_TPU_EVENT_LOG", None)
        else:
            os.environ["PADDLE_TPU_EVENT_LOG"] = saved[1]
    print(json.dumps({
        "phase": "tools", "card": card(),
        "model": "GPT-2-small (GPTConfig()), weights from a CPU "
                 "torch.Generator seeded 0; tiny for the CLI bake; the "
                 "MLP 784-128-10 for predict, tenants, fleet, autoscale",
        "token_grid": TOOLS_TOKEN_GRID, "token_traffic": TOOLS_TOKEN_TRAFFIC,
        "a_warmstart": out["a_warmstart"], "b_tokens": out["b"],
        "c_prefix_share": out["c"], "d_tenants": out["d"],
        "e_fleet": out["e"], "f_bake": out["f_bake"],
        "f_autoscale": out["f"],
        "g_obsdump_lines": out["g_obsdump_lines"],
        "launches": {"flash_attention_fwd": launches},
        "part_seconds": secs, "seconds": time.perf_counter() - t0}),
        flush=True)
    shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    return launches


def _leftovers():
    """The threads other than this one still alive, and the processes
    whose parent is this one, each as a short description."""
    me = threading.current_thread()
    threads = sorted(f"{t.name}{'' if t.daemon else ' (not daemon)'}"
                     for t in threading.enumerate() if t is not me)
    children = []
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{pid}/stat") as f:
                stat = f.read()
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode(errors="replace")
        except OSError:
            continue
        # the fields after the parenthesised name: state, then the parent
        state, ppid = stat.rsplit(")", 1)[1].split()[:2]
        if state != "Z" and int(ppid) == os.getpid():
            children.append(f"{pid} {cmd.strip()[:160]}")
    return {"threads": threads, "children": children}


def _per_rank_times(row):
    """A K1 or K2 row's times at PER_RANK_SHAPE (ms, plain_ms, bound_ms,
    bound_by, library_ms)."""
    t = row["timings"][PER_RANK_SHAPE]
    return {"ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound"][0], "bound_by": t["bound"][1],
            "library_ms": t["library_ms"]}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU",
              file=sys.stderr)
        return 2
    import paddle_tpu_torch  # noqa: F401  fails when run outside the repo

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # a run that hangs prints every thread's stack on stderr and exits
    # non-zero before the time limit stops it without a word
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    start = time.perf_counter()
    seconds = {}

    def timed(phase, *args):
        t = time.perf_counter()
        print(f"chip_smoke: {phase.__name__} starts at {t - start:.1f} s",
              file=sys.stderr, flush=True)
        result = phase(*args)
        seconds[phase.__name__] = time.perf_counter() - t
        return result

    timed(phase_environment)
    serving_row, training_rows, k2_rows, k3_row, fdb_rows = \
        timed(phase_kernels)
    launches = collections.Counter(
        {"flash_attention_fwd": timed(phase_slice)})
    timed(phase_profile)
    timed(phase_greedy)
    timed(phase_train_parity)
    bert_counts, bert512 = timed(phase_train)
    gpt_counts = timed(phase_gpt_train)
    timed(phase_nmt_parity)
    nmt_counts = timed(phase_nmt_train)
    beam_counts = timed(phase_nmt_beam)
    padded_counts = timed(phase_bert_padded, bert512)
    bottleneck_counts = timed(phase_bottleneck)
    timed(phase_resnet_parity)
    resnet_counts = timed(phase_resnet_train)
    timed(phase_ring_parity)
    sp_counts = timed(phase_bert_long_sp)
    timed(phase_head_dim_gate)
    resilience_counts = timed(phase_resilience)
    timed(phase_fluid)
    launches["flash_attention_fwd"] += timed(phase_kv_reuse)
    moe_counts = timed(phase_gpt_moe)
    timed(phase_infer)
    timed(phase_predict)
    dptp_counts = timed(phase_dp_tp)
    launches["flash_attention_fwd"] += timed(phase_fleet)
    launches["flash_attention_fwd"] += timed(phase_observability)
    timed(phase_fluid_dp)
    timed(phase_fluid_book)
    timed(phase_fluid_trainer)
    timed(phase_dygraph)
    timed(phase_fluid_sequence)
    timed(phase_slim)
    timed(phase_detection)
    launches["flash_attention_fwd"] += timed(phase_tools)
    for counts in (bert_counts, gpt_counts, nmt_counts, beam_counts,
                   padded_counts, bottleneck_counts, resnet_counts,
                   sp_counts, resilience_counts, moe_counts, dptp_counts):
        launches.update(counts)
    # every main path runs attention at bf16, where the dq kernels fold
    # the delta pass in: the delta row counts those folds, and the
    # standalone delta launch must not have run
    check(launches[DELTA] == 0,
          f"the standalone delta launch ran on a main path: {launches}")
    launches[DELTA] = launches[K1_FOLD] + launches[K2_FOLD]
    check(all(launches[row["name"]] > 0 for row in
              [serving_row] + training_rows + k2_rows + [k3_row] + fdb_rows),
          f"a kernel of the main paths was never launched: {launches}")
    src = "paddle_tpu_torch/kernels/csrc/"
    rows = [{
        "name": serving_row["name"], "route": "cuda",
        "source": src + "flash_attention.cu",
        "replaces": "paddle_tpu/ops/pallas/attention.py:361",
        "launches": launches[serving_row["name"]],
        "max_abs_err": serving_row["max_abs_err"],
        "ms": serving_row["kernel_ms"], "plain_ms": serving_row["plain_ms"],
        "bound_ms": serving_row["bound_ms"],
        "bound_by": serving_row["bound_by"],
        "library_ms": serving_row["library_ms"]}]
    for row in training_rows:
        # the row's times at phase 7's first run (BERT-base 256 x 128)
        t = row["timings"]["bert"]
        fold = row["name"] == DELTA
        rows.append({
            "name": row["name"], "route": "cuda",
            "source": src + ("flash_attention.cu" if row["name"].endswith(
                "fwd_lse") else "sm90.cuh" if fold
                else "flash_attention_bwd.cu"),
            "replaces": "paddle_tpu/ops/pallas/attention.py:" + (
                "361" if row["name"].endswith("fwd_lse") else "356"),
            "launches": launches[row["name"]],
            "max_abs_err": row["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound"][0],
            "bound_by": t["bound"][1], "library_ms": t["library_ms"],
            PER_RANK_SHAPE: _per_rank_times(row),
            # the delta pass runs as the prologue of K1's and K2's dq
            # kernels: its launches are their folds, its ms the folded dq
            # launch's time less the external-delta one's
            **({"folded_into": ["flash_attention_bwd_dq",
                                "flash_attention_bias_bwd_dq"]}
               if fold else {})})
    jax_fa = "jax/experimental/pallas/ops/tpu/flash_attention.py:"
    for row in k2_rows:
        # the row's times at phase 10's calls (Transformer-big 128 x 128)
        t = row["timings"]["nmt"]
        fwd = row["name"].endswith("fwd")
        rows.append({
            "name": row["name"], "route": "cuda",
            "source": src + ("flash_attention_bias.cu" if fwd
                             else "flash_attention_bias_bwd.cu"),
            "replaces": "paddle_tpu/ops/pallas/attention.py:393" if fwd
            else jax_fa + ("941" if row["name"].endswith("dkv") else "1287"),
            "launches": launches[row["name"]],
            "max_abs_err": row["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound"][0],
            "bound_by": t["bound"][1], "library_ms": t["library_ms"],
            PER_RANK_SHAPE: _per_rank_times(row),
            # the kernel of each dtype: "sm90" bf16 and f16, "fma" f32
            "kernels": row["kernels"]})
    # K3's times at phase 17's block (8 x 1024 x 12 heads, bf16)
    rows.append({
        "name": k3_row["name"], "route": "cuda",
        "source": src + "flash_attention.cu",
        "replaces": "paddle_tpu/ops/pallas/attention.py:374",
        "launches": launches[k3_row["name"]],
        **{key: k3_row[key] for key in ("max_abs_err", "ms", "plain_ms",
                                        "bound_ms", "bound_by",
                                        "library_ms")}})
    for row in fdb_rows:
        # the row's times at the g2 shape (K5 at phase 13's product)
        t = row["timings"][FDB_LINE_SHAPE]
        rows.append({
            "name": row["name"], "route": "cuda",
            "source": src + "fused_dense_bn.cu",
            "replaces": row["replaces"],
            "launches": launches[row["name"]],
            "max_abs_err": row["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound"][0],
            "bound_by": t["bound"][1], "library_ms": t["library_ms"]})
    # every phase stops the threads and processes it starts (a stopped
    # thread may take a moment to end)
    deadline = time.monotonic() + 10
    while any(_leftovers().values()) and time.monotonic() < deadline:
        time.sleep(0.1)
    left = _leftovers()
    check(not any(left.values()), f"outlived their phases: {left}")
    # each phase's wall seconds (phase_environment's include the build)
    print(json.dumps({"phase": "timing", "seconds": seconds,
                      "total_s": sum(seconds.values())}))
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    rc = main()
    sys.stdout.flush()
    sys.stderr.flush()
    # nothing of the run is left (main checks that no thread or process
    # outlived its phase): skip the interpreter's teardown of CUDA and
    # the profiler, which has nothing to do for the result
    os._exit(rc)
