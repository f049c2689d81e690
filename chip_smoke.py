#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero:

1. environment: Python, torch and CUDA versions, the card's name and
   power limit (``nvidia-smi``);
2. build: ``nvcc`` compiles every kernel from ``src/repro_torch/csrc`` for
   sm_90a (one process per source, all started together), with each
   source's build time;
3. ``bwo_evolve`` against its plain PyTorch version on the card, at the FL
   path's shapes and two small ones, in float32 and bfloat16, and under
   ``torch.func.vmap`` over 10 clients (one launch over 60 rows of the
   paper CNN); the kernel's and the plain version's times and the bound at
   one client's shape and at all clients'; one round's parts (local SGD,
   seeding, a generation, its bit draws and fitness) for one client and
   for ten under vmap; 3b. one local-SGD step's gradient of the paper CNN
   at full width for 10 clients, under vmap and client by client, against
   float64 on the same inputs and the same ReLU and max-pool decisions,
   each op of the step also against float64 on its own inputs (within
   1e-5 of the largest entry, which TF32 fails; 5e-3 for the grouped
   convolution's backward, where cuDNN runs Winograd), with the step's
   device kernels by name;
4. the FL path at full width through the user's entry points:
   ``FLConfig(strategy="fedbwo", task="cnn", bwo_kernel=True,
   device="cuda", max_rounds=3)`` -> ``build_experiment`` -> ``run``, on
   the engine "auto" picks on the card (batched, vmap: 3 launches a
   round), with every launch counter set to 0 just before and read just
   after, and the run's peak device memory; 4b. the same rounds on both
   engines in turn, each round from a common start (3 and 30 launches a
   round), held to each other (the same winner; scores and test loss
   within 1e-2, relative); 4c. 10 rounds with
   ``rounds_per_dispatch="auto"`` (5 on the batched engine) through
   ``run()``: two pipelined blocks, each one replay of a CUDA graph
   captured once (30 ``bwo_evolve`` launches by replay, 3 in the warm-up
   round before the capture, with every launch counter set to 0 just
   before and read just after), the uplink exactly 10 x 9,861,328 bytes,
   the first block against 5 eager rounds from the same start (the same
   winners; round 0's scores within 1e-2, the largest difference
   printed), the capture time, the amortized round beside the single
   rounds, the peak memory, ``timing_summary()`` of the serial and the
   pipelined driver, the card's busy share in an eager round and in a
   replayed block (``torch.profiler``), and a block against 5 eager
   rounds again under ``cudnn.deterministic``, bit for bit;
5. one round of the default (composed) FedBWO on each engine, no launch;
6. the kernel route on the card (batched) against the port's CPU route
   (sequential, the route the tests hold against the JAX reference) on a
   narrow CNN; 6b. a Dirichlet (ragged: padded and masked) split at full
   width, one round on each engine, held to each other; 6c. one FedGWO
   round at full width on the batched engine;
7. ``flash_attention`` against its plain PyTorch version on the card, at
   OLMo-1B's and Jamba's prefill and decode shapes (16 heads on 16 KV
   heads; 32 on 8), the reference's test cases in float32 and bfloat16, a
   windowed and a mixed-type (float32 queries, bf16 cache) shape, each on
   the route ``flash_attention.route`` names for it (tensor cores, split-K,
   3xTF32 for float32 at hd 64, or CUDA cores), with the kernel's, the plain version's and
   ``scaled_dot_product_attention``'s times and the bound at the four
   serving shapes, and at the two decode shapes a second reading of the
   kernel and SDPA after a flush that leaves L2 clean;
8. the serving path at full width and depth: ``serve(get_arch("olmo-1b"),
   batch=4, prompt_len=1024, gen=32, temperature=1.0, device="cuda")``,
   with every launch counter set to 0 just before and read just after
   (flash_attention: 16 calls on the tensor-core route, 496 on split-K,
   none on the CUDA cores); the same call again (warm); then a prefill
   alone and one decode step split into the model and the sampling;
9. serving olmo-1b ``.reduced()`` on the card against the port's CPU
   route, greedy;
10. ``ssm_scan`` against its plain PyTorch version on the card, at the
    reference's test cases (with and without h0), one decode step, the
    state updated in place (h_out aliased to h0) and Jamba's prefill
    shape, with A drawn as the reference's tests draw it and as the mamba
    initialisation sets it; the kernel's and the plain version's times and
    the bound at Jamba's prefill and decode shapes, and a second reading of
    the kernel after a flush that leaves L2 clean;
11. the hybrid serving path at full width and depth: Jamba without its
    experts, ``serve(dataclasses.replace(get_arch("jamba-v0.1-52b"),
    moe=None), batch=4, prompt_len=1024, gen=32, temperature=1.0,
    device="cuda")``, with every launch counter set to 0 just before and
    read just after (flash_attention: 4 tensor-core and 124 split-K
    calls, none on the CUDA cores); then, on one drawing of the weights,
    the parameter count, a prefill alone and one decode step split into
    the model and the sampling, each with both kernels' share;
12. serving Jamba without experts ``.reduced()`` on the card against the
    port's CPU route, greedy;
13. the bf16 routes inside a model (phases 9 and 12 run float32 weights,
    which take the CUDA-core route): olmo-1b ``.reduced()`` with bfloat16
    weights served greedily through the kernels and again with
    ``flash_attention_ref`` in the kernels' place, and full-width OLMo-1B's
    prefill logits both ways;
14. Jamba-v0.1 with its 16 experts at full width, depth cut to one
    8-layer period: ``serve(dataclasses.replace(get_arch("jamba-v0.1-52b"),
    num_layers=8), batch=4, prompt_len=1024, gen=32, temperature=1.0,
    device="cuda")`` with every launch counter set to 0 just before and read
    just after (``ssm_scan`` 224; flash 32: 1 tensor-core, 31 split-K),
    the parameter tree counted (13,295,235,072), then a prefill alone and
    one decode step with the MoE layers' share, one ``moe_apply`` timed at
    both shapes beside its bound;
15. DeepSeek-V2 at full width, 2 layers, the same call (MLA attends in
    plain PyTorch, as the reference does: no kernel launches), its tree
    (8,992,814,080) and latent cache checked, the same split;
16. serving the reduced MoE configurations (Jamba with experts,
    DeepSeek-V2, Arctic) on the card against the port's CPU route, greedy;
17. ``flash_attention``'s backward kernels against their plain version
    (``flash_attention_bwd_ref``) on the card, at OLMo-1B's and Jamba's
    train shapes, the reference's kernel sweep and ragged, windowed shapes,
    float32 and bf16, each on the route ``flash_attention_bwd.route`` names
    (bf16 at hd 64 and 128 on the tensor cores, float32 at hd 64 on them
    as 3xTF32, the rest on the CUDA cores); two launches at each train shape equal bit for bit; the
    route's, the CUDA-core route's, the plain version's and SDPA's backward
    times and the bound at the two train shapes;
18. ``ssm_scan``'s backward kernel against ``ssm_scan_bwd_ref``, at the
    reference's scan cases with and without h0 and at Jamba's train shape,
    A drawn and as the mamba initialisation sets it, two launches at
    Jamba's shape equal bit for bit (no atomics), with the times and the
    bound there;
19. training OLMo-1B at full width and depth:
    ``make_train_step(build_model(get_arch("olmo-1b"), max_seq=1024),
    adamw(warmup_cosine(3e-4, 10, 4)))`` on ``make_token_dataset``
    batches of 4 x 1024, a warm-up step and three timed ones, every
    launch counter set to 0 just before each step and read just after (32
    flash forwards and 16 backwards, all on the tensor cores), loss, aux
    and grad_norm finite, the step split into forward plus backward,
    clipping and the AdamW update, every parameter leaf's gradient
    non-zero, the peak memory, the tree counted (1,176,764,416), and one
    step's gradients through the kernels against the same step with the
    plain versions in their place, leaf by leaf (within 2^-4 of each
    leaf's largest entry);
20. the same for Jamba without experts at full width, depth cut to one
    8-layer period (7 mamba + 1 attention; 2,725,326,848 parameters): 14
    scan forwards and 7 backwards, 2 flash forwards and 1 backward a step
    (on the tensor cores);
    the plain comparison at sequence 256 (``ssm_scan_ref``'s per-step
    autograd graph at 1024 does not fit beside the model);
21. three train steps of reduced OLMo-1B, Jamba with its experts and
    DeepSeek-V2 (float32) on the card against the port's CPU route, from
    one state: losses, aux and grad norms within 1e-3 relative;
22. ``flash_attention`` at the encoder-decoder's and the vision model's
    shapes, each against its plain version on its route and timed beside
    SDPA and the bound: Whisper-medium's encoder (4 x 1500 frames, 16 heads
    on 16, hd 64, bidirectional), its cross-attention at prefill (32
    queries on 1500 keys) and at decode (1 on the 1500-frame cross cache),
    LLaVA-NeXT's prefill (2880 image rows + 32 text, 32 on 8, hd 128,
    causal) and decode (a 2944-position cache, kv_len 2913); Whisper's two
    float32 shapes take the 3xTF32 route, timed beside the CUDA-core
    kernel and SDPA in float32, with the CUDA cores' bound beside the
    3xTF32 one;
23. ``flash_attention``'s backward where queries and keys differ in
    number, both routes, phase 17's tolerances: Whisper's cross-attention
    train shape (4 x 448 queries on 1500 keys) and its encoder (1500 x
    1500), fewer and more queries than keys, causal or not, a window; two
    launches at the timed shapes equal bit for bit; Whisper's two shapes
    timed in bf16 and in float32 (the 3xTF32 route, beside the CUDA-core
    kernel, SDPA's float32 backward and both bounds);
24. serving Whisper-medium at full width and depth (``serve(get_arch(
    "whisper-medium"), batch=4, prompt_len=32, gen=32)``, 1500 zero encoder
    frames): the encoder in float32, as the reference's promotion runs it;
    at prefill 24 tensor-core flash calls (the decoder's self-attentions)
    and 48 on the 3xTF32 route (24 float32 encoder layers, 24
    cross-attentions over its float32 K/V), 1,488 split-K (31 steps x 48);
    the tree counted on the meta device; the card's float32 encoder against
    the CPU route's (RMS within 2^-14); then Whisper-medium reduced served
    on the card against the CPU route;
25. training Whisper-medium at full width and depth on 4 x 448 tokens and
    1500 encoder frames drawn from the seed, as phases 19-20 (120 flash
    forwards, 48 on the tensor cores and 72 on the 3xTF32 route, and 72
    backwards, 24 and 48; the key biases, whose gradient is 0 in exact
    arithmetic, held to the tree's largest gradient entry); 25b. reduced
    Whisper-medium and LLaVA-NeXT train steps on the card against the CPU
    route;
26. serving LLaVA-NeXT-Mistral-7B at full width and depth (2880 zero image
    rows, prompt 32, 32 tokens): 32 tensor-core and 992 split-K calls;
    then LLaVA-NeXT reduced on the card against the CPU route;
27. the int8 KV cache at OLMo-1B full width through the model API
    (``cache_init(4, 1056, quantized=True)``, prefill 1024, 32 decode
    steps) against the bf16 cache on the same weights and tokens: the
    reference's int8 tolerance in units of the logits' RMS, both caches'
    bytes and decode ms a step.
28. serving xLSTM-1.3B at full width and depth (``serve(get_arch(
    "xlstm-1.3b"), batch=4, prompt_len=1024, gen=32)``; tree 3,527,610,688,
    the state cache's bytes): no kernel launches, since the reference has
    no kernel for the mLSTM and sLSTM; 28b. its decode against the full
    forward (prefill 896, 128 steps teacher-forced, batch 2) on float32
    weights, each step within 2^-6 of its largest logit, and the same
    weights in bf16 printed beside it;
29. training xLSTM-1.3B at full width cut to 12 layers (4 x 1024, as
    phase 19, no launches); 29b. the reduced step card against CPU;
30. the continuous-batching server (``serving.BatchedServer``) at
    full-width OLMo-1B: 4 slots, a 1152-position cache, 10 requests of
    seeded prompts (37 to 1024 tokens, 16 to 128 new), one freed slot
    passing the cache's end; every request's tokens against a B = 1 replay
    on the card (the argmax or a near-tie within 2^-6), flash's calls by
    route (prefills on the tensor cores, steps split-K with a (B,)
    kv_len); 30a. flash at those shapes, the per-row kv_len decode timed
    beside SDPA with the matching boolean mask;
31. the same server at Jamba without experts, 8 layers, 3 slots, 6
    requests (``ssm_scan``: a prefill per Mamba layer and request, a
    decode per Mamba layer and step); 31a. the scan at those shapes;
32. training LLaVA-NeXT at full width cut to 8 layers (4 x (2880 seeded
    image rows + 32 tokens): 16 flash forwards and 8 backwards a step on
    the tensor cores); 32a. the backward at that shape beside SDPA's.
33. the mesh schedules (``repro_torch.core.distributed``): FedBWO on the
    paper CNN at ``FLConfig()``'s defaults, one gloo rank per client (10
    processes by ``launch.mesh.run_ranks``, all on the one card), 3
    rounds of ``make_fedx_round`` with ``bwo(use_kernel=True)`` and the
    server's keys, each round against the sequential engine from the same
    start under ``cudnn.deterministic`` (the same winner, scores within
    1e-5, the model the sequential winner's) and the batched engine (the
    same winner, scores within 1e-2); 90 ``bwo_evolve`` launches across
    the ranks; the collectives' bytes (all-gather 40 + broadcast
    9,861,288 = CommMeter's uplink); one FedAvg round (all-reduce 10 x
    9,861,288) against the sequential and the batched FedAvg (rtol 1e-4,
    atol 1e-5); the round time (the slowest rank), the collectives'
    times, the start-up and each rank's peak memory.
34. flcheck (``repro_torch.analysis``) on the card: the strict audit of
    the FL main path at full width (``FLConfig(strategy="fedbwo",
    task="cnn", bwo_kernel=True, rounds_per_dispatch=5,
    pipeline_blocks="on")`` through ``build_experiment(cfg,
    audit="strict")``), its findings by rule and severity and its seconds;
    the audited block's CUDA graph: 15 ``bwo_evolve`` kernel nodes (equal
    to ``CapturedBlock.launches``), no device-to-host copy, no host node,
    a replay under sync-debug "error" that raises nothing, no growth on a
    second replay; 10 rounds of the audited build (two pipelined 5-round
    blocks: the engine's own capture, replayed twice) against 10 of an
    unaudited one under ``cudnn.deterministic``, bit for bit, with one
    capture in each build's ``captures``; the strict
    audit of FedAvg at C = 0.6; and a ``.item()`` and a float64 round
    trip planted in a narrow block, each reported as its rule's error.
35. the dry run and the cost model: (a) ``python -m
    repro_torch.launch.dryrun`` at full width in subprocesses started
    together (a fake world of 256 or 512 ranks in each, host-only, so it
    never meets phase 33's gloo world): OLMo-1B ``train_4k`` on pod16x16
    and on pod2x16x16, DeepSeek-V2 ``decode_32k`` on pod16x16 (the expert-
    parallel dispatch's all-gather), xLSTM-1.3B ``decode_32k`` on pod16x16
    (its recurrences shard by shard), and ``--fedx --arch olmo-1b`` on
    pod2x16x16; each combination's seconds, FLOPs and HBM bytes per
    device, collectives by kind, cross-pod bytes, dominant term and bound
    beside 6·N·D ÷ chips; the FedX round's cross-pod bytes below
    ``local_steps`` synchronous steps' (the paper's Fig. 6 at pod scale).
    (b) phase 19's OLMo-1B train step (4 x 1024, one card): timed, then
    one step recorded (``record_ops(detail=True)``) with its launches
    counted (32 flash forwards, 16 backwards) and ``graph_analysis.analyze``
    run on it: its dot FLOPs beside ``FlopCounterMode``'s count of the same
    step, the roofline's bound beside the median step, the step's share.
Phases 22-35 each print their seconds and the card's name and power limit
(``python3 tools/run_phase.py 22,...,27``, ``28,...,32``, ``33``, ``34``
or ``35`` runs them alone); the script prints its total before the
kernels line.

It then prints a JSON line of the new paths' numbers, one JSON line
describing every ported kernel (``launches`` summed over the paths that
run it, serving, the servers and one train step of each model, flash's
per path in ``route_launches``), the backward kernels included, and as
the last line
``{"ok": true, "device": {...}}``.  Without a CUDA device, or
without the rest of the repository beside it, it fails and prints no
result.
"""
from __future__ import annotations

import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
import types
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# The card's memory rate, float32 rate (non-tensor-core), bf16 dense
# tensor-core rate and exponential rate, by the name nvidia-smi gives: the
# first three from NVIDIA's data sheets, dense rates at the full power limit;
# the last is 16 results a clock on each SM (the CUDA C++ Programming
# Guide's arithmetic-instruction throughput table, compute capability 9.0)
# times the SMs and the boost clock of the data sheets: 132 at 1.98 GHz on
# the H100 SXM and the H200.  None: not recorded here.  Bounds are stated
# against these.
CARDS = {"H100 PCIe": (2.0e12, 51e12, None, None),
         "H100 NVL": (3.9e12, 60e12, None, None),
         "H100": (3.35e12, 67e12, 989e12, 132 * 16 * 1.98e9),
         "H200": (4.8e12, 67e12, 989e12, 132 * 16 * 1.98e9)}

# The dense TF32 tensor-core rate is half the bf16 one on Hopper (495 of
# 989 TFLOP/s, NVIDIA's data sheet).  The 3xTF32 route takes each float32
# product as three TF32 products, so its operations bound is 3 x the
# function's operations at this rate, beside the CUDA cores' (float32
# outside the tensor cores).
TF32_PER_BF16 = 0.5
FLOPS_PER_GENE = 15          # bwo_evolve's float operations per gene
# threefry's bound: the instructions a counter that only the integer ALU
# pipe runs, 20 rotations (SHF) and 21 xors (LOP3), at 64 results a clock
# an SM (the CUDA C++ Programming Guide's throughput table, compute
# capability 9.0) on 132 SMs at 1.98 GHz (the H100 SXM).  The hash's 32
# adds are left out: nvcc emits about two thirds of them as IMAD on the
# FMA pipe, beside the ALU's work (csrc/threefry.cu's SASS)
THREEFRY_INT32_OPS = 41
INT32_RATE = 132 * 64 * 1.98e9
SPIN_CYCLES = 2_000_000      # ~1 ms of the device's clock (time_ms's spin)

# flash_attention checks: B, Sq, Sk, H, KV, hd, causal, window, q_offset,
# kv_len, q dtype, k/v dtype.  The tolerance goes by q's dtype: f32, sums in
# another order than the plain version's cuBLAS products; bf16, both round
# one fp32 result to bf16 (a step of 2^-8 relative).
F32, BF16 = "float32", "bfloat16"
OLMO_PREFILL = (4, 1024, 1024, 16, 16, 128, True, None, 0, None, BF16, BF16)
OLMO_DECODE = (4, 1, 1056, 16, 16, 128, False, None, 0, 1040, BF16, BF16)
# Jamba's attention layers: 32 query heads on 8 KV heads, no RoPE
JAMBA_ATTN_PREFILL = (4, 1024, 1024, 32, 8, 128, True, None, 0, None, BF16, BF16)
JAMBA_ATTN_DECODE = (4, 1, 1056, 32, 8, 128, False, None, 0, 1040, BF16, BF16)
TEST_CASES = [(2, 256, 256, 4, 2, 64, True, None), (1, 512, 512, 4, 4, 128, True, 128),
              (2, 128, 128, 8, 1, 32, False, None), (1, 300, 300, 2, 2, 80, True, None),
              (1, 256, 256, 4, 4, 128, True, 64)]
# the timed shapes; the kernels line carries each, its top-level times the
# first
FA_TIMED = (("olmo prefill", OLMO_PREFILL), ("olmo decode", OLMO_DECODE),
            ("jamba prefill", JAMBA_ATTN_PREFILL),
            ("jamba decode", JAMBA_ATTN_DECODE))
FA_SHAPES = ([OLMO_PREFILL, OLMO_DECODE, JAMBA_ATTN_PREFILL, JAMBA_ATTN_DECODE]
             + [c + (0, None, dt, dt) for c in TEST_CASES for dt in (F32, BF16)]
             + [(4, 1, 1056, 16, 16, 128, True, 128, 1039, None, BF16, BF16),
                (2, 1, 24, 4, 4, 64, False, None, 0, 17, F32, BF16)])
FA_TOL = {F32: 2e-5, BF16: 3e-2}
# bf16 outputs are also held to their own size, since the absolute 3e-2 is
# about a typical entry where a row spreads over ~1500 keys (|o| ~ 0.03):
# each query row's largest error within two bf16 steps of the row's largest
# entry (rounding one fp32 result to bf16 both ways differs by one), and
# the error's RMS over the output within 2^-7 of the output's RMS.
FA_ROW_TOL, FA_RMS_TOL = 2 ** -6, 2 ** -7
# Phase 22: the shapes of the encoder-decoder and vision paths, batch 4,
# in the types the paths give them.  Whisper-medium (16 heads on 16, hd
# 64): its encoder (1500 frames, no multiple of the 128-row tile,
# bidirectional) and cross-attention at prefill (a 32-token prompt against
# the 1500 frames) in float32, as the reference's promotion runs them (the
# 3xTF32 route), and at decode over the bf16 cross cache (no kv_len);
# LLaVA-NeXT-Mistral-7B (32 on 8, hd 128), bf16: prefill of 2880 image rows
# and 32 text tokens, decode over a 2944-position cache.
FA_NEW_TIMED = (
    ("whisper encoder", (4, 1500, 1500, 16, 16, 64, False, None, 0, None,
                         F32, F32)),
    ("whisper cross prefill", (4, 32, 1500, 16, 16, 64, False, None, 0, None,
                               F32, F32)),
    ("whisper cross decode", (4, 1, 1500, 16, 16, 64, False, None, 0, None,
                              BF16, BF16)),
    ("llava prefill", (4, 2912, 2912, 32, 8, 128, True, None, 0, None,
                       BF16, BF16)),
    ("llava decode", (4, 1, 2944, 32, 8, 128, False, None, 0, 2913,
                      BF16, BF16)))

# ssm_scan checks: B, S, D, N, with h0.  The reference's test cases
# (tests/test_kernels.py), each with and without h0, one decode step, and
# Jamba's prefill.  Tolerance 1e-4, the reference's own kernel-against-
# oracle tolerance, relative to max |y| (max |h|) where that exceeds 1.
JAMBA_PREFILL = (4, 1024, 8192, 16, False)
JAMBA_DECODE = (4, 1, 8192, 16, True)
SSM_TEST_CASES = [(2, 128, 64, 16), (1, 64, 256, 8), (2, 96, 32, 16),
                  (1, 200, 48, 4)]
SSM_SHAPES = ([c + (h0,) for c in SSM_TEST_CASES for h0 in (False, True)]
              + [JAMBA_DECODE, JAMBA_PREFILL])
SSM_TIMED = (("prefill", JAMBA_PREFILL), ("decode", JAMBA_DECODE))
SSM_TOL = 1e-4
SSM_FLOPS = 7                # fp32 operations per (b, t, d, n) besides exp


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def valid_pairs(Sq, Sk, causal, window, q_offset, kv_len):
    """(query, key) pairs the attention mask keeps, and the keys some query
    sees, per batch row and head: the mean over the rows where ``kv_len``
    is a tuple of per-row lengths."""
    import torch
    q = q_offset + torch.arange(Sq)[:, None]
    k = torch.arange(Sk)[None, :]
    counts = []
    for n in (kv_len if isinstance(kv_len, tuple) else (kv_len,)):
        keep = (k < (Sk if n is None else n)).expand(Sq, Sk)
        if causal:
            keep = keep & (k <= q)
        if window is not None:
            keep = keep & (k > q - window)
        counts.append((int(keep.sum()), int(keep.any(0).sum())))
    if len(counts) == 1:
        return counts[0]
    return tuple(sum(c) / len(counts) for c in zip(*counts))


def kv_len_arg(torch, kv_len):
    """A shape's kv_len as the kernel takes it: a tuple of per-row lengths
    becomes a (B,) int32 tensor on the card."""
    if isinstance(kv_len, tuple):
        return torch.tensor(kv_len, dtype=torch.int32, device="cuda")
    return kv_len


def card_rates(name):
    for key in sorted(CARDS, key=len, reverse=True):
        if key in name:
            return CARDS[key]
    raise RuntimeError(f"no memory/compute rates recorded for {name!r}")


def time_ms(torch, fn, reps=20, warmup=3, flush=None, spin=False):
    """Median of ``reps`` CUDA-event timings of ``fn`` after warm-up;
    ``flush`` runs before each, outside the timing.  ``spin``: the device
    spins ~1 ms before each start event, so the host has enqueued ``fn``'s
    launches by the time it starts and the events time the device's work,
    not the host's (a kernel's time; a step's time keeps the host in)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        if flush is not None:
            flush()
        if spin:
            torch.cuda._sleep(SPIN_CYCLES)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def timed_entry(torch, kernel, plain, library, nbytes, ops, mem_rate,
                clean=False):
    """Times ``kernel``, its plain version and the library call (None
    where there is none) on the device, each launch with a cold L2 (a 256
    MB buffer is written before it, as a layer finds the cache after the
    others), and bounds the kernel by the larger of ``nbytes`` at
    ``mem_rate`` and each (count, rate) of ``ops``.  Prints the numbers and
    returns them as the kernels line's keys.  ``clean``: the kernel and the
    library call are timed again after a flush that leaves L2 clean (a 256
    MB buffer read, never written while timing), so the write flush's dirty
    lines, written back during the timed launch, can be told from it."""
    scratch = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    flush = scratch.zero_
    ms = time_ms(torch, kernel, flush=flush, spin=True)
    plain_ms = time_ms(torch, plain, reps=3, warmup=1, flush=flush, spin=True)
    lib_ms = (None if library is None
              else time_ms(torch, library, flush=flush, spin=True))
    del scratch
    extra = {}
    if clean:
        readable = torch.ones(64 * 2**20, device="cuda")        # 256 MB

        def read_flush():
            readable.sum()

        extra["clean_flush_ms"] = time_ms(torch, kernel, flush=read_flush,
                                          spin=True)
        if library is not None:
            extra["library_clean_flush_ms"] = time_ms(
                torch, library, flush=read_flush, spin=True)
        del readable
        lib = ("" if library is None else
               f", library {extra['library_clean_flush_ms']:.4f} ms")
        print(f"    after a clean (read) flush: kernel "
              f"{extra['clean_flush_ms']:.4f} ms{lib}")
    bytes_ms = nbytes / mem_rate * 1e3
    ops_ms = max(n / rate * 1e3 for n, rate in ops)
    bound_ms = max(bytes_ms, ops_ms)
    bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
    lib = "" if lib_ms is None else f"  library {lib_ms:.4f} ms"
    print(f"    kernel {ms:.4f} ms  plain {plain_ms:.4f} ms{lib}  bound "
          f"{bound_ms:.4f} ms ({bound_by}; bytes {bytes_ms:.4f} ms, "
          f"operations {ops_ms:.4f} ms); kernel at {bound_ms / ms:.1%} of "
          f"bound, {nbytes / ms / 1e6:.1f} GB/s")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": lib_ms, **extra}


def timer_check(torch, fa_kernel, route, kernel, sdpa):
    """Times the route's kernel, the CUDA-core kernel (the only route
    before the tensor-core and split-K ones) and SDPA with and without
    time_ms's spin, cold L2 as timed_entry's, so a reading of either timer
    can be set beside the other's.  The CUDA-core kernel is reached by
    pointing the wrapper's ``route`` at it for these launches."""
    scratch = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    routed = fa_kernel.route

    def cuda_core():
        fa_kernel.route = lambda *a, **kw: "cuda_core"
        try:
            return kernel()
        finally:
            fa_kernel.route = routed

    got = {}
    for name, fn in ((route, kernel), ("cuda_core", cuda_core),
                     ("sdpa", sdpa)):
        got[name] = [time_ms(torch, fn, reps=10 if name == "cuda_core" else 20,
                             flush=scratch.zero_, spin=spin)
                     for spin in (True, False)]
    del scratch
    print("    timer check, ms with spin / without: " + ", ".join(
        f"{name} {a:.4f} / {b:.4f}" for name, (a, b) in got.items()))
    return got


def size_errors(got, want):
    """The worst query row's largest error over the row's largest entry,
    and the error's RMS over the output's (last axis: a row's entries)."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    row = (err.amax(-1) / want.abs().amax(-1).clamp_min(1e-30)).max().item()
    rms = (err.pow(2).mean().sqrt()
           / want.pow(2).mean().sqrt().clamp_min(1e-30)).item()
    return row, rms


def flash_phase(torch, mem_rate, bf16_rate,
                title="7. flash_attention against its plain version on the "
                      "card", all_shapes=FA_SHAPES, timed_shapes=FA_TIMED,
                seed=7, f32_rate=None):
    """Phase 7 (and 22 at the new paths' shapes): every shape of
    ``all_shapes`` against the plain version on its route, then the
    ``timed_shapes`` timed, each with the timer check; a float32 shape's
    operations bounded at ``f32_rate`` (the CUDA cores') and, on the
    3xTF32 route, three times over at the TF32 rate (its ``bound_ms``, the
    CUDA cores' beside it), a bf16 one's at ``bf16_rate``.  Returns the kernel's entry of the kernels line (all but
    its launches) and its times at the timed shapes, by label."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import flash_attention as fa_kernel
    from repro_torch.kernels.flash_attention import ops as fa_ops, ref as fa_ref
    print(f"== {title}")
    dtypes = {F32: torch.float32, BF16: torch.bfloat16}
    gen = torch.Generator(device="cuda").manual_seed(seed)
    inputs, sizes, max_err = {}, {}, 0.0
    for shape in all_shapes:
        B, Sq, Sk, H, KV, hd, causal, window, q_offset, kv_len, qdt, kvdt = shape
        q = torch.randn(B, Sq, H, hd, device="cuda", generator=gen).to(dtypes[qdt])
        k, v = (torch.randn(B, Sk, KV, hd, device="cuda", generator=gen)
                .to(dtypes[kvdt]) for _ in range(2))
        kw = dict(causal=causal, window=window, q_offset=q_offset,
                  kv_len=kv_len_arg(torch, kv_len))
        route = fa_kernel.route(q.dtype, k.dtype, hd, Sq)
        before = dict(fa_kernel.route_launches)
        got = fa_ops.flash_attention(q, k, v, **kw)
        want = fa_ref.flash_attention_ref(q, k, v, **kw)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        tol = FA_TOL[qdt]
        took = [r for r in fa_kernel.ROUTES
                if fa_kernel.route_launches[r] != before[r]]
        ok = (got.dtype == q.dtype and got.shape == q.shape and took == [route]
              and torch.allclose(got.float(), want.float(), rtol=tol, atol=tol))
        own = ""
        if qdt == BF16:
            row, rms = sizes[shape] = size_errors(got, want)
            ok = ok and row <= FA_ROW_TOL and rms <= FA_RMS_TOL
            own = (f"; worst row {row:.3e} of its largest entry (tol 2^-6), "
                   f"RMS {rms:.3e} of the output's (tol 2^-7)")
        print(f"  B={B} Sq={Sq} Sk={Sk} H={H} KV={KV} hd={hd} causal={causal} "
              f"window={window} q_offset={q_offset} kv_len={kv_len} q {qdt} "
              f"kv {kvdt}, route {took}: max_abs_err {err:.3e} (tol {tol})"
              f"{own} {'ok' if ok else 'FAILED'}")
        check(ok and math.isfinite(err), f"flash_attention disagrees at {shape} "
              f"or left its route {route}")
        max_err = max(max_err, err)
        inputs[shape] = (q, k, v, kw)

    # times at the serving paths' shapes, against the bound and two
    # yardsticks: the plain version and scaled_dot_product_attention
    times, shapes = {}, {}
    for label, shape in timed_shapes:
        B, Sq, Sk, H, KV, hd, causal, window, q_offset, kv_len = shape[:10]
        q, k, v, kw = inputs[shape]
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        mask = None
        if isinstance(kv_len, tuple):      # (B, 1, 1, Sk): each row's length
            mask = (torch.arange(Sk, device="cuda")
                    < kw["kv_len"][:, None])[:, None, None, :]
        elif kv_len is not None:
            mask = (torch.arange(Sk, device="cuda") < kv_len)[None, None, None, :]

        def sdpa():
            return F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, is_causal=causal,
                enable_gqa=H != KV)

        lib_err = (sdpa().transpose(1, 2).float()
                   - fa_ops.flash_attention(q, k, v, **kw).float()).abs().max().item()
        pairs, keys = valid_pairs(Sq, Sk, causal, window, q_offset, kv_len)
        nbytes = (2 * B * Sq * H * hd + 2 * B * keys * KV * hd) * q.element_size()
        flops = 4 * B * H * hd * pairs
        print(f"  {label} {shape[:10]}: {nbytes / 1e6:.1f} MB, "
              f"{flops / 1e9:.2f} GFLOP; sdpa's max diff to the kernel "
              f"{lib_err:.2e}")
        route = fa_kernel.route(q.dtype, k.dtype, hd, Sq)
        ops = [(flops, bf16_rate if shape[10] == BF16 else f32_rate)]
        if route == "tf32x3":
            ops = [(3 * flops, TF32_PER_BF16 * bf16_rate)]
        timed = timed_entry(
            torch, lambda: fa_ops.flash_attention(q, k, v, **kw),
            lambda: fa_ref.flash_attention_ref(q, k, v, **kw), sdpa,
            nbytes, ops, mem_rate, clean=Sq == 1)
        timed["route"] = route
        if route == "tf32x3":
            timed["cuda_core_bound_ms"] = max(nbytes / mem_rate,
                                              flops / f32_rate) * 1e3
            print(f"    the CUDA cores' bound {timed['cuda_core_bound_ms']:.4f} "
                  f"ms (float32 at {f32_rate / 1e12:.0f} TFLOP/s); the "
                  f"3xTF32 bound above")
        if shape in sizes:
            timed["row_err"], timed["rms_err"] = sizes[shape]
        times[label] = timed["ms"]
        shapes[label] = timed
        timed["timer_check"] = timer_check(
            torch, fa_kernel, timed["route"],
            lambda: fa_ops.flash_attention(q, k, v, **kw), sdpa)
    del inputs
    torch.cuda.empty_cache()
    first = shapes[timed_shapes[0][0]]
    entry = {"max_abs_err": max_err,
             **{k: first[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                      "library_ms")},
             "shapes": shapes}
    return entry, times


def read_counts(counters):
    return {k.__name__.rsplit(".", 1)[-1]: k.launches for k in counters}


def reset_counts(counters):
    """Every launch counter to 0, flash_attention's per-route ones too."""
    for k in counters:
        k.launches = 0
        if hasattr(k, "route_launches"):
            k.route_launches.update(dict.fromkeys(k.route_launches, 0))


def fa_routes(**counts):
    """flash_attention's calls by route: every route, 0 where not named."""
    from repro_torch.kernels.flash_attention import flash_attention as fa_kernel
    return {**dict.fromkeys(fa_kernel.ROUTES, 0), **counts}


def check_routes(got, want, where):
    """flash_attention's calls by route on a serving path."""
    print(f"  flash_attention routes {got} (expected {want})")
    check(got == want, f"flash_attention's routes on {where}: {got}, "
          f"expected {want}")


def tree_size(tree, params):
    """(parameters, bytes) of a parameter tree, counted from its leaves."""
    leaves = tree.leaves(params)
    return (sum(t.numel() for t in leaves),
            sum(t.numel() * t.element_size() for t in leaves))


def serve_checked(torch, counters, cfg, want_launches, want_routes, where,
                  P=1024):
    """One full-width ``serve()`` (batch 4, prompt ``P``, 32 tokens,
    temperature 1) with every launch counter set to 0 just before and read
    just after: the launches and routes checked, the tokens in range and
    the logits finite.  Returns the launches, flash's routes and the
    serving numbers (init s, prefill ms, decode ms a step, tokens/s, peak
    GiB)."""
    from repro_torch.kernels.flash_attention import flash_attention as fa_kernel
    from repro_torch.launch.serve import serve
    B, G = 4, 32
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(counters)
    res = serve(cfg, batch=B, prompt_len=P, gen=G, temperature=1.0,
                device="cuda")
    launches = read_counts(counters)
    routes = dict(fa_kernel.route_launches)
    peak = torch.cuda.max_memory_allocated()
    print(f"  {cfg.num_layers} layers {cfg.block_pattern}, d {cfg.d_model}, "
          f"{cfg.param_dtype}; launches {launches} (expected {want_launches})")
    print(f"  init_s {res.init_s:.3f}  prefill_ms {res.prefill_ms:.3f}  "
          f"decode_ms_per_step {res.decode_ms_per_step:.3f}  tokens_per_s "
          f"{res.tokens_per_s:.1f}  max_memory_allocated "
          f"{peak / 2**30:.2f} GiB")
    print(f"  sample: {res.tokens[0, :16].tolist()}")
    check(launches == want_launches, f"launches on {where}: {launches}, "
          f"expected {want_launches}")
    check_routes(routes, want_routes, where)
    toks = res.tokens
    check(toks.shape == (B, G) and toks.is_cuda and toks.dtype == torch.int32
          and bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
          f"tokens out of range or misshapen: {tuple(toks.shape)}")
    check(res.logits.shape == (B, cfg.vocab_size)
          and bool(torch.isfinite(res.logits).all()), "non-finite logits")
    numbers = {"init_s": res.init_s, "prefill_ms": res.prefill_ms,
               "decode_ms_per_step": res.decode_ms_per_step,
               "tokens_per_s": res.tokens_per_s, "peak_gib": peak / 2**30}
    del res
    torch.cuda.empty_cache()
    return launches, routes, numbers


def step_split(torch, model, params, B, P, G):
    """A prefill alone, one decode step of the model at the last position
    and its sampling (key split + categorical), in ms; and the cache."""
    from repro_torch import random
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    dev = torch.device("cuda")
    prompts = random.randint(random.PRNGKey(1, dev), (B, P), 0,
                             model.cfg.vocab_size)
    prefill = make_prefill_step(model, P + G)
    prefill_ms = time_ms(torch, lambda: prefill(params, {"tokens": prompts}),
                         reps=3, warmup=1)
    logits, cache = prefill(params, {"tokens": prompts})
    step = make_serve_step(model)
    tok = logits.argmax(-1)[:, None].to(torch.int32)
    model_ms = time_ms(torch, lambda: step(params, tok, cache, P + G - 2),
                       reps=10)
    key = random.PRNGKey(1, dev)

    def sample():
        _, k = random.split(key)
        return random.categorical(k, logits)

    return prefill_ms, model_ms, time_ms(torch, sample, reps=10), cache


def serve_phase(torch, counters, decode_kernel_ms):
    """Phase 8.  Returns flash_attention's launches on the serving path and
    their count by route."""
    from repro_torch import random
    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import serve
    from repro_torch.models.transformer import build_model
    print("== 8. serving OLMo-1B at full width and depth")
    cfg = get_arch("olmo-1b")
    check(cfg.num_params() == 1_176_764_416, f"olmo-1b has {cfg.num_params()}")
    B, P, G = 4, 1024, 32
    want = cfg.num_layers * (1 + (G - 1))
    print(f"  {cfg.num_params():,} parameters")
    launches, routes, _ = serve_checked(
        torch, counters, cfg,
        {"bwo_evolve": 0, "flash_attention": want, "ssm_scan": 0,
         "flash_attention_bwd": 0, "ssm_scan_bwd": 0},
        fa_routes(tensor_core=cfg.num_layers,
                  split_k=cfg.num_layers * (G - 1)),
        "the OLMo-1B serving path")
    # the same serve() again in this process: its times without the first
    # call's set-up (library load, cuBLAS handles, allocator growth)
    warm = serve(cfg, batch=B, prompt_len=P, gen=G, temperature=1.0,
                 device="cuda")
    print(f"  again (warm): init_s {warm.init_s:.3f}  prefill_ms "
          f"{warm.prefill_ms:.3f}  decode_ms_per_step "
          f"{warm.decode_ms_per_step:.3f}  tokens_per_s {warm.tokens_per_s:.1f}")
    del warm

    # one decode step at the last position, split into the model and the
    # sampling, and a prefill alone (weights drawn again)
    model = build_model(cfg, max_seq=P + G)
    params = model.init(random.PRNGKey(0, torch.device("cuda")))
    prefill_ms, model_ms, sample_ms, cache = step_split(torch, model, params,
                                                        B, P, G)
    attn_ms = cfg.num_layers * decode_kernel_ms
    print(f"  prefill alone {prefill_ms:.3f} ms; one decode step: model "
          f"{model_ms:.3f} ms (of which the attention kernel, {cfg.num_layers} x "
          f"{decode_kernel_ms:.4f} ms cold = {attn_ms:.3f} ms, "
          f"{attn_ms / model_ms:.1%}), sampling (key split + categorical "
          f"over {B} x {cfg.vocab_size}) {sample_ms:.3f} ms")
    del params, cache
    torch.cuda.empty_cache()
    return launches["flash_attention"], routes


def card_vs_cpu(torch, what, cfg, on_differ=None, **kw):
    """Serves ``cfg`` greedily on the card and on the port's CPU route:
    the tokens must be equal and the last logits within 1e-2 (phase 9's
    bound).  ``on_differ(card, cpu)`` runs before a token difference fails
    the check."""
    from repro_torch.launch.serve import serve
    kw = dict(dict(batch=2, prompt_len=16, gen=8, temperature=0.0), **kw)
    on_card, on_cpu = serve(cfg, device="cuda", **kw), serve(cfg, device="cpu", **kw)
    same = bool((on_card.tokens.cpu() == on_cpu.tokens).all())
    diff = (on_card.logits.cpu() - on_cpu.logits).abs().max().item()
    print(f"  {what}: tokens {'equal' if same else 'DIFFER'}, last logits max "
          f"diff {diff:.2e} (tol 1e-2, |logits| up to "
          f"{on_cpu.logits.abs().max().item():.2f})")
    if not same and on_differ is not None:
        on_differ(on_card, on_cpu)
    check(same, f"{what}: card and CPU routes served different tokens")
    check(diff <= 1e-2, f"{what}: card and CPU logits disagree beyond 1e-2")


def serve_card_vs_cpu(torch):
    """Phase 9: greedy serving of olmo-1b reduced (float32 weights, bf16
    cache) on the card against the CPU route.  Logits reach ~200 and are
    read through the bf16 cache, where an element that rounds the other
    way moves a logit by up to ~1e-2: tolerance 1e-2."""
    from repro_torch.configs import get_arch
    print("== 9. serving olmo-1b reduced on the card against the CPU route")
    for window in (None, 6):
        card_vs_cpu(torch, f"window {window}", get_arch("olmo-1b").reduced(),
                    window=window)


def ssm_inputs(torch, shape, gen, mamba_A):
    """As the reference's tests draw them: dt = softplus(z) * 0.1 and
    A = -exp(0.3 z); or A = -(1..N), the mamba initialisation."""
    B, S, D, N, with_h0 = shape
    x = torch.randn(B, S, D, device="cuda", generator=gen)
    dt = torch.nn.functional.softplus(
        torch.randn(B, S, D, device="cuda", generator=gen)) * 0.1
    if mamba_A:
        A = -torch.arange(1, N + 1, dtype=torch.float32,
                          device="cuda").repeat(D, 1)
    else:
        A = -torch.exp(torch.randn(D, N, device="cuda", generator=gen) * 0.3)
    Bc = torch.randn(B, S, N, device="cuda", generator=gen)
    Cc = torch.randn(B, S, N, device="cuda", generator=gen)
    h0 = (torch.randn(B, D, N, device="cuda", generator=gen)
          if with_h0 else None)
    return x, dt, A, Bc, Cc, h0


def ssm_err(got, want):
    """max |got - want| and the scale it is held to, max(1, max |want|)."""
    return ((got - want).abs().max().item(),
            max(1.0, want.abs().max().item()))


def ssm_phase(torch, mem_rate, f32_rate, exp_rate,
              title="10. ssm_scan against its plain version on the card",
              all_shapes=SSM_SHAPES, timed_shapes=SSM_TIMED, seed=13):
    """Phase 10 (and 31a at the server's shapes): every shape of
    ``all_shapes`` against the plain version, the decode shape's state
    updated in place, then the ``timed_shapes`` timed.  Returns the
    kernel's entry of the kernels line (all but its launches) and its times
    at the timed shapes, by label."""
    from repro_torch.kernels.ssm_scan import ops as ssm_ops, ref as ssm_ref
    from repro_torch.kernels.ssm_scan import ssm_scan as ssm_kernel
    print(f"== {title}")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    max_err, inputs = 0.0, {}
    for shape in all_shapes:
        for mamba_A in (False, True):
            args = ssm_inputs(torch, shape, gen, mamba_A)
            y, h = ssm_ops.ssm_scan(*args)
            want_y, want_h = ssm_ref.ssm_scan_ref(*args)
            torch.cuda.synchronize()
            (ey, sy), (eh, sh) = ssm_err(y, want_y), ssm_err(h, want_h)
            ok = (y.shape == want_y.shape and h.shape == want_h.shape
                  and ey <= SSM_TOL * sy and eh <= SSM_TOL * sh)
            print(f"  B,S,D,N,h0={shape} A {'-(1..N)' if mamba_A else 'drawn'}: "
                  f"y max_abs_err {ey:.3e} (scale {sy:.1f}), h {eh:.3e} "
                  f"(scale {sh:.1f}), tol {SSM_TOL} x scale "
                  f"{'ok' if ok else 'FAILED'}")
            check(ok and math.isfinite(ey) and math.isfinite(eh),
                  f"ssm_scan disagrees at {shape}")
            max_err = max(max_err, ey, eh)
            if mamba_A:
                inputs[shape] = args

    # decode's state update in place: h_out is h0 itself
    decode = next(sh for sh in all_shapes if sh[1] == 1 and sh[4])
    x, dt, A, Bc, Cc, h0 = inputs[decode]
    want_y, want_h = ssm_ref.ssm_scan_ref(x, dt, A, Bc, Cc, h0)
    state = h0.clone()
    y, h = ssm_ops.ssm_scan(x, dt, A, Bc, Cc, state, h_out=state)
    torch.cuda.synchronize()
    (ey, sy), (eh, sh) = ssm_err(y, want_y), ssm_err(state, want_h)
    ok = h is state and ey <= SSM_TOL * sy and eh <= SSM_TOL * sh
    print(f"  h_out aliased to h0 at {decode}: y {ey:.3e}, h {eh:.3e} "
          f"{'ok' if ok else 'FAILED'}")
    check(ok, "ssm_scan with h_out aliased to h0 disagrees")

    times, shapes = {}, {}
    for label, shape in timed_shapes:
        B, S, D, N, _ = shape
        x, dt, A, Bc, Cc, h0 = inputs[shape]
        out = None if h0 is None else h0.clone()
        nbytes = 4 * (3 * B * S * D + 2 * B * S * N + D * N
                      + (2 if h0 is not None else 1) * B * D * N)
        exps = B * S * D * N
        print(f"  {label} {shape}: {nbytes / 1e6:.1f} MB, {exps / 1e6:.1f} "
              f"M exp, {SSM_FLOPS * exps / 1e9:.2f} GFLOP fp32")
        timed = timed_entry(
            torch,
            lambda: ssm_kernel.ssm_scan_cuda(x, dt, A, Bc, Cc, out, h_out=out),
            lambda: ssm_ref.ssm_scan_ref(x, dt, A, Bc, Cc, h0),
            None, nbytes, [(exps, exp_rate), (SSM_FLOPS * exps, f32_rate)],
            mem_rate, clean=True)
        times[label] = timed["ms"]
        shapes[label] = timed
    del inputs
    torch.cuda.empty_cache()
    first = shapes[timed_shapes[0][0]]
    entry = {"max_abs_err": max_err,
             **{k: first[k] for k in ("ms", "plain_ms", "bound_ms",
                                      "bound_by", "library_ms")},
             "shapes": shapes}
    return entry, times


def jamba_phase(torch, counters, ssm_times, fa_times):
    """Phase 11.  Returns ssm_scan's launches on the hybrid serving path and
    flash_attention's count by route."""
    from repro_torch import random, tree
    from repro_torch.configs import get_arch
    from repro_torch.models.transformer import build_model
    print("== 11. serving Jamba without experts at full width and depth")
    cfg = dataclasses.replace(get_arch("jamba-v0.1-52b"), moe=None)
    B, P, G = 4, 1024, 32
    n_mamba = cfg.block_pattern.count("mamba") * cfg.num_groups
    n_attn = cfg.num_layers - n_mamba
    launches, routes, _ = serve_checked(
        torch, counters, cfg,
        {"bwo_evolve": 0, "flash_attention": n_attn * G,
         "ssm_scan": n_mamba * G, "flash_attention_bwd": 0, "ssm_scan_bwd": 0},
        fa_routes(tensor_core=n_attn, split_k=n_attn * (G - 1)),
        "the Jamba serving path")

    # one drawing of the weights (serve()'s, seed 0) for the count, a
    # prefill alone and one decode step split into the model and sampling
    model = build_model(cfg, max_seq=P + G)
    params = model.init(random.PRNGKey(0, torch.device("cuda")))
    n_params, n_bytes = tree_size(tree, params)
    print(f"  parameter tree: {n_params:,} parameters, {n_bytes:,} bytes "
          f"(ArchConfig.num_params() reports {cfg.num_params():,}: it counts "
          f"no FFN on a mamba layer)")
    check(n_params == 9_290_682_368 and n_bytes == 18_589_163_520,
          f"the tree holds {n_params} parameters in {n_bytes} bytes")
    prefill_ms, model_ms, sample_ms, cache = step_split(torch, model, params,
                                                        B, P, G)
    state_mb = sum(t.numel() * t.element_size()
                   for t in tree.leaves(cache)) / 1e6

    def kernels_share(part, total_ms):
        scan = n_mamba * ssm_times[part]
        flash = n_attn * fa_times[f"jamba {part}"]
        return (f"the kernels {scan + flash:.3f} ms, "
                f"{(scan + flash) / total_ms:.1%}: ssm_scan {n_mamba} x "
                f"{ssm_times[part]:.4f} ms cold = {scan:.3f} ms, "
                f"flash_attention {n_attn} x {fa_times[f'jamba {part}']:.4f} "
                f"ms cold = {flash:.3f} ms")

    print(f"  KV cache + mamba state {state_mb:.1f} MB; prefill alone "
          f"{prefill_ms:.3f} ms (of which {kernels_share('prefill', prefill_ms)})")
    print(f"  one decode step: model {model_ms:.3f} ms (of which "
          f"{kernels_share('decode', model_ms)}), sampling (key split + "
          f"categorical over {B} x {cfg.vocab_size}) {sample_ms:.3f} ms")
    del params, cache
    torch.cuda.empty_cache()
    return launches["ssm_scan"], routes


def jamba_card_vs_cpu(torch):
    """Phase 12: greedy serving of Jamba without experts, reduced (float32
    weights, bf16 KV cache, float32 mamba state), on the card against the
    CPU route.  Tolerance 1e-2 on the last logits, as phase 9's."""
    from repro_torch.configs import get_arch
    print("== 12. serving Jamba without experts, reduced, on the card "
          "against the CPU route")
    card_vs_cpu(torch, "jamba without experts", dataclasses.replace(
        get_arch("jamba-v0.1-52b"), moe=None).reduced())


def bf16_model_phase(torch):
    """Phase 13: the bf16 routes inside a model, against the same model with
    ``flash_attention_ref`` put in the kernels' place by this script (the
    package has no switch).  Both run bf16 weights, activations and cache:
    they differ only where the kernels round P to bf16 before P V and sum
    in another order, about one bf16 step (2^-8 relative) of an attention
    output, which the layers carry on to the logits.  Tolerance: the last
    logits within 2^-6 of their largest magnitude (2 bf16 steps there; about
    3x the largest difference read on an H100, at full width, and 10x the
    reduced model's), the greedy tokens equal, and the full-width prefill's
    last-position logits within the same bound with the same argmax.  The
    runs with flash_attention_ref in the kernels' place must launch no
    kernel, and the full-width prefill through the kernels one tensor-core
    call a layer."""
    from repro_torch import random
    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attention import flash_attention as fa_kernel
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.launch.serve import serve
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import attention
    from repro_torch.models.transformer import build_model
    print("== 13. the bf16 routes inside a model, against flash_attention_ref")
    kernel_fn = attention.fa_ops.flash_attention

    def counts():
        return fa_kernel.launches, dict(fa_kernel.route_launches)

    def with_ref(fn):
        before = counts()
        attention.fa_ops.flash_attention = fa_ref.flash_attention_ref
        try:
            out = fn()
        finally:
            attention.fa_ops.flash_attention = kernel_fn
        check(counts() == before, "the run with flash_attention_ref in the "
              "kernels' place launched a kernel")
        return out

    def compare(what, got, want, tokens_equal):
        diff = (got - want).abs().max().item()
        scale = want.abs().max().item()
        ok = tokens_equal and math.isfinite(diff) and diff <= scale / 64
        print(f"  {what}: tokens {'equal' if tokens_equal else 'DIFFER'}, "
              f"logits max diff {diff:.3e} (tol {scale / 64:.3e} = 2^-6 x "
              f"max |logits| {scale:.2f}) {'ok' if ok else 'FAILED'}")
        check(ok, f"{what}: the kernels and flash_attention_ref disagree")

    cfg = dataclasses.replace(get_arch("olmo-1b").reduced(),
                              param_dtype=torch.bfloat16)
    for window in (None, 6):
        kw = dict(batch=2, prompt_len=128, gen=8, temperature=0.0,
                  window=window, device="cuda")
        before = dict(fa_kernel.route_launches)
        got = serve(cfg, **kw)
        used = {r: fa_kernel.route_launches[r] - before[r]
                for r in fa_kernel.ROUTES}
        want = with_ref(lambda: serve(cfg, **kw))
        expect = fa_routes(tensor_core=cfg.num_layers,
                           split_k=cfg.num_layers * 7)
        print(f"  olmo-1b reduced, bf16, window {window}: routes {used} "
              f"(expected {expect})")
        check(used == expect, f"the bf16 model took routes {used}")
        compare(f"olmo-1b reduced bf16, window {window}", got.logits.float(),
                want.logits.float(), bool((got.tokens == want.tokens).all()))

    cfg = get_arch("olmo-1b")
    dev = torch.device("cuda")
    model = build_model(cfg, max_seq=1024)
    params = model.init(random.PRNGKey(0, dev))
    prompts = random.randint(random.PRNGKey(1, dev), (4, 1024), 0,
                             cfg.vocab_size)
    prefill = make_prefill_step(model, 1024)
    before = counts()
    got, _ = prefill(params, {"tokens": prompts})
    used = {r: fa_kernel.route_launches[r] - before[1][r]
            for r in fa_kernel.ROUTES}
    check(used == fa_routes(tensor_core=cfg.num_layers),
          f"the full-width bf16 prefill took routes {used}")
    want, _ = with_ref(lambda: prefill(params, {"tokens": prompts}))
    compare("olmo-1b full width, prefill (4 x 1024), last position",
            got.float(), want.float(),
            bool((got.argmax(-1) == want.argmax(-1)).all()))
    del params, got, want
    torch.cuda.empty_cache()


def moe_times(torch, cfg, moe_params, B, P, mem_rate, bf16_rate):
    """One ``moe_apply`` of a layer's experts at the prefill shape (B, P)
    and at the decode shape (B, 1), in ms, each beside its bound: the
    experts' weights read once, or the three expert products' operations on
    the (B, E, C) dispatch buffer at the bf16 tensor-core rate."""
    from repro_torch.models import moe as moe_lib
    m = cfg.moe
    dff = m.expert_d_ff or cfg.d_ff
    E, d = m.num_experts, cfg.d_model
    weight_bytes = sum(moe_params[k].numel() * moe_params[k].element_size()
                       for k in ("wi", "wg", "wo"))
    gen = torch.Generator(device="cuda").manual_seed(14)
    out = {}
    for label, S in (("prefill", P), ("decode", 1)):
        x = torch.randn(B, S, d, device="cuda", generator=gen).to(cfg.param_dtype)
        C = moe_lib.capacity(cfg, S)
        flops = 3 * 2 * B * E * C * d * dff
        ms = time_ms(torch, lambda: moe_lib.moe_apply(moe_params, x, cfg),
                     reps=10 if S == 1 else 5, warmup=2)
        bytes_ms = weight_bytes / mem_rate * 1e3
        ops_ms = flops / bf16_rate * 1e3
        kept = moe_lib.route(moe_params, x, cfg).keep.float().mean().item()
        print(f"  one moe_apply at {label} (B {B}, S {S}, E {E}, top-{m.top_k}, "
              f"C {C}, {kept:.1%} of pairs kept): {ms:.3f} ms; bound "
              f"{max(bytes_ms, ops_ms):.3f} ms (weights {weight_bytes / 1e9:.2f} "
              f"GB: {bytes_ms:.3f} ms; {flops / 1e12:.2f} TFLOP on the "
              f"dispatch buffer: {ops_ms:.3f} ms)")
        out[label] = ms
    return out


def jamba_moe_phase(torch, counters, ssm_times, fa_times, mem_rate, bf16_rate):
    """Phase 14: Jamba-v0.1 with its 16 experts at full width, depth cut to
    one 8-layer period (7 mamba + 1 attention, experts on sublayers 1, 3, 5,
    7).  Returns the launches and flash's routes of its serve()."""
    from repro_torch import random, tree
    from repro_torch.configs import get_arch
    from repro_torch.models.transformer import build_model
    print("== 14. serving Jamba-v0.1 with its experts at full width, 8 layers")
    cfg = dataclasses.replace(get_arch("jamba-v0.1-52b"), num_layers=8)
    B, P, G = 4, 1024, 32
    n_mamba = cfg.block_pattern.count("mamba") * cfg.num_groups
    n_attn = cfg.num_layers - n_mamba
    launches, routes, _ = serve_checked(
        torch, counters, cfg,
        {"bwo_evolve": 0, "flash_attention": n_attn * G,
         "ssm_scan": n_mamba * G, "flash_attention_bwd": 0, "ssm_scan_bwd": 0},
        fa_routes(tensor_core=n_attn, split_k=n_attn * (G - 1)),
        "the Jamba-with-experts serving path")

    # one drawing of the weights (serve()'s, seed 0): the count, a prefill
    # alone, one decode step, and the MoE layers' share of both
    model = build_model(cfg, max_seq=P + G)
    params = model.init(random.PRNGKey(0, torch.device("cuda")))
    n_params, n_bytes = tree_size(tree, params)
    print(f"  parameter tree: {n_params:,} parameters, {n_bytes:,} bytes "
          f"(ArchConfig.num_params() reports {cfg.num_params():,}: it counts "
          f"no FFN on a mamba layer and places MoE on i % 2 == 0)")
    check(n_params == 13_295_235_072 and n_bytes == 26_592_944_128,
          f"the tree holds {n_params} parameters in {n_bytes} bytes")
    prefill_ms, model_ms, sample_ms, cache = step_split(torch, model, params,
                                                        B, P, G)
    moe_subs = [i for i in range(cfg.group_size)
                if "moe" in params["groups"][f"sub{i}"]]
    n_moe = len(moe_subs) * cfg.num_groups
    moe_ms = moe_times(torch, cfg, tree.map(
        lambda a: a[0], params["groups"][f"sub{moe_subs[0]}"]["moe"]),
        B, P, mem_rate, bf16_rate)

    def shares(part, total_ms):
        moe = n_moe * moe_ms[part]
        scan = n_mamba * ssm_times[part]
        flash = n_attn * fa_times[f"jamba {part}"]
        return (f"MoE {n_moe} x {moe_ms[part]:.3f} = {moe:.3f} ms "
                f"({moe / total_ms:.1%}); ssm_scan {n_mamba} x "
                f"{ssm_times[part]:.4f} = {scan:.3f} ms, flash_attention "
                f"{n_attn} x {fa_times[f'jamba {part}']:.4f} = {flash:.3f} ms "
                f"(the kernels {(scan + flash) / total_ms:.1%}, cold)")

    print(f"  prefill alone {prefill_ms:.3f} ms, of which {shares('prefill', prefill_ms)}")
    print(f"  one decode step: model {model_ms:.3f} ms, of which "
          f"{shares('decode', model_ms)}; sampling {sample_ms:.3f} ms")
    del params, cache
    torch.cuda.empty_cache()
    return launches, routes


def deepseek_phase(torch, counters, mem_rate, bf16_rate):
    """Phase 15: DeepSeek-V2 at full width, depth cut to 2 layers (MLA, 160
    routed experts top-6 and 2 shared, on every layer).  MLA attends in
    plain PyTorch, as the reference does: no kernel launches."""
    from repro_torch import random, tree
    from repro_torch.configs import get_arch
    from repro_torch.models.transformer import build_model
    print("== 15. serving DeepSeek-V2 at full width, 2 layers")
    cfg = dataclasses.replace(get_arch("deepseek-v2-236b"), num_layers=2)
    B, P, G = 4, 1024, 32
    serve_checked(torch, counters, cfg,
                  {"bwo_evolve": 0, "flash_attention": 0, "ssm_scan": 0,
                   "flash_attention_bwd": 0, "ssm_scan_bwd": 0},
                  fa_routes(), "the DeepSeek-V2 serving path")
    model = build_model(cfg, max_seq=P + G)
    params = model.init(random.PRNGKey(0, torch.device("cuda")))
    n_params, n_bytes = tree_size(tree, params)
    print(f"  parameter tree: {n_params:,} parameters, {n_bytes:,} bytes "
          f"(ArchConfig.num_params() reports {cfg.num_params():,})")
    check(n_params == 8_992_814_080 and n_bytes == 17_988_904_960,
          f"the tree holds {n_params} parameters in {n_bytes} bytes")
    prefill_ms, model_ms, sample_ms, cache = step_split(torch, model, params,
                                                        B, P, G)
    m = cfg.mla
    want = {"c_kv": (cfg.num_layers, B, P + G, m.kv_lora_rank),
            "k_rope": (cfg.num_layers, B, P + G, m.qk_rope_head_dim)}
    got = {k: tuple(v.shape) for k, v in cache["sub0"].items()}
    cache_bytes = sum(v.numel() * v.element_size() for v in cache["sub0"].values())
    print(f"  MLA latent cache {got}, bf16: {cache_bytes:,} bytes "
          f"(expected {want})")
    check(got == want and all(v.dtype == torch.bfloat16
                              for v in cache["sub0"].values()),
          f"the MLA cache is {got}")
    moe_ms = moe_times(torch, cfg, tree.map(
        lambda a: a[0], params["groups"]["sub0"]["moe"]), B, P, mem_rate,
        bf16_rate)
    n_moe = cfg.num_layers
    print(f"  prefill alone {prefill_ms:.3f} ms (MoE {n_moe} x "
          f"{moe_ms['prefill']:.3f} ms, {n_moe * moe_ms['prefill'] / prefill_ms:.1%}); "
          f"one decode step: model {model_ms:.3f} ms (MoE {n_moe} x "
          f"{moe_ms['decode']:.3f} ms, {n_moe * moe_ms['decode'] / model_ms:.1%}), "
          f"sampling {sample_ms:.3f} ms")
    del params, cache
    torch.cuda.empty_cache()


def moe_card_vs_cpu(torch):
    """Phase 16: greedy serving of the MoE configurations, reduced (float32
    weights), on the card against the CPU route, as phase 9.  The router's
    smallest top-k margin (the gap between the k-th expert's probability and
    the next one's) over each run is printed, and where a token differs the
    margins at the step that made it, before the check fails: a routing flip
    near a tie is a finding, not a tolerance."""
    from repro_torch.configs import get_arch
    from repro_torch.models import moe as moe_lib
    print("== 16. serving the MoE configurations, reduced, on the card "
          "against the CPU route")
    route = moe_lib.route
    gen = 8
    for name in ("jamba-v0.1-52b", "deepseek-v2-236b", "arctic-480b"):
        margins = {"cuda": [], "cpu": []}

        def recording(p, x, cfg, **kw):
            probs = torch.softmax(x.float() @ p["router"]["w"], dim=-1)
            top = probs.topk(cfg.moe.top_k + 1, dim=-1).values
            margins[x.device.type].append(
                (top[..., -2] - top[..., -1]).min().item())
            return route(p, x, cfg, **kw)

        def at_first_difference(on_card, on_cpu):
            per_step = len(margins["cpu"]) // gen       # MoE layers
            j = int((on_card.tokens.cpu() != on_cpu.tokens).any(0)
                    .float().argmax())
            steps = slice(j * per_step, (j + 1) * per_step)
            print(f"  first differing token: {j}; router top-k margins of "
                  f"the step that made it, by MoE layer: card "
                  f"{margins['cuda'][steps]}, CPU {margins['cpu'][steps]}")

        moe_lib.route = recording
        try:
            card_vs_cpu(torch, name, get_arch(name).reduced(),
                        on_differ=at_first_difference, gen=gen)
        finally:
            moe_lib.route = route
        print(f"    smallest router top-k margin: card "
              f"{min(margins['cuda']):.2e}, CPU {min(margins['cpu']):.2e}")


# The backward kernels.  flash: B, Sq, Sk, H, KV, hd, causal, window, dtype
# (queries from position 0 against every key, as training calls it): the
# train shapes of OLMo-1B and Jamba, and the reference's kernel sweep,
# each in float32 and bf16.  Tolerance, of each gradient's largest entry:
# float32 1e-4 (fp32 sums in another order than the plain version's, through
# exp); bf16 2^-7 (both round one fp32 result to bf16, a step of 2^-8 at
# the largest).
OLMO_TRAIN = (4, 1024, 1024, 16, 16, 128, True, None)
JAMBA_TRAIN = (4, 1024, 1024, 32, 8, 128, True, None)
FA_BWD_TIMED = (("olmo train", OLMO_TRAIN), ("jamba train", JAMBA_TRAIN))
# ragged sequences (not a multiple of a tile), windows, rep 1 to 8
FA_BWD_RAGGED = [(2, 200, 200, 4, 4, 64, True, None),
                 (1, 1000, 1000, 8, 1, 128, True, 256),
                 (3, 77, 77, 8, 2, 64, False, 32)]
FA_BWD_SHAPES = [c + (dt,) for c in
                 [OLMO_TRAIN, JAMBA_TRAIN] + [c[:8] for c in TEST_CASES]
                 + FA_BWD_RAGGED for dt in (BF16, F32)]
# Phase 23, where queries and keys differ in number: Whisper-medium's
# cross-attention at its train shape (448 decoder tokens, the model's
# max_target_positions, on 1500 encoder frames) and its encoder (1500 x
# 1500, bidirectional); fewer and more queries than keys, causal or not,
# rep 1 to 4, a window.
WHISPER_CROSS_TRAIN = (4, 448, 1500, 16, 16, 64, False, None)
WHISPER_ENC_TRAIN = (4, 1500, 1500, 16, 16, 64, False, None)
FA_BWD_SQ_SK_TIMED = (("whisper cross train", WHISPER_CROSS_TRAIN),
                      ("whisper encoder train", WHISPER_ENC_TRAIN))
FA_BWD_SQ_SK_SHAPES = [c + (dt,) for c in
                       [WHISPER_CROSS_TRAIN, WHISPER_ENC_TRAIN,
                        (2, 200, 333, 8, 2, 128, True, None),
                        (2, 333, 200, 4, 4, 64, True, None),
                        (3, 77, 1000, 8, 2, 128, False, None),
                        (1, 1000, 77, 8, 1, 64, False, None),
                        (2, 300, 500, 4, 1, 64, True, 100)]
                       for dt in (BF16, F32)]
FA_BWD_TOL = {F32: 1e-4, BF16: 2 ** -7}
# ssm_scan's backward: the reference's scan cases with and without h0 (and a
# last-state gradient with h0), then Jamba's train shape; tolerance 1e-4 of
# each gradient's largest entry (at least 1), as the forward's
SSM_BWD_SHAPES = ([c + (h0,) for c in SSM_TEST_CASES for h0 in (False, True)]
                  + [JAMBA_PREFILL])
SSM_BWD_FLOPS = 12           # fp32 operations per (b, t, d, n) besides exp:
                             # the state recomputed (3), the step back (9)
# One train step's gradients through the kernels against the same step with
# the plain versions in the kernels' place, leaf by leaf, within this share
# of each leaf's largest entry.  Both routes compute in bf16 (weights,
# activations, gradients) around the attention and the scan; they differ
# where the kernels round P to bf16 and sum in other orders, a bf16 step
# or two of an element (2^-8 each), which the layers' backward carries on.
# A missing or wrong gradient differs by the order of the gradient itself.
TRAIN_GRAD_TOL = 2 ** -4
# The reduced train steps on the card against the CPU route, float32:
# losses, aux and grad norms within this relative tolerance over 3 steps.
TRAIN_CARD_CPU_RTOL = 1e-3


def rel_to_largest(got, want):
    """max |got - want| over max(1, max |want|), in float32."""
    got, want = got.float(), want.float()
    return ((got - want).abs().max().item()
            / max(1.0, want.abs().max().item()))


def flash_bwd_phase(torch, mem_rate, bf16_rate,
                    title="17. flash_attention backward against its plain "
                          "version on the card",
                    all_shapes=FA_BWD_SHAPES, timed_shapes=FA_BWD_TIMED,
                    seed=17, f32_rate=None, timed_dtypes=(BF16,)):
    """Phase 17 (and 23 where queries and keys differ in number).  Every
    shape of ``all_shapes`` on the route ``flash_attention_bwd.route``
    names for it; two launches at each timed shape give the same bits; at
    the timed shapes, in each of ``timed_dtypes``, the route's kernels are
    timed beside the plain version, SDPA's backward in the same type and
    the bound, and the CUDA-core route beside them (a float32 shape's
    label ends in "float32"; on the 3xTF32 route its operations are
    bounded three times over at the TF32 rate, the CUDA cores' bound at
    ``f32_rate`` beside it).  Returns the backward kernels' entry of the
    kernels line (all but its launches)."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import flash_attention_bwd as fa_bwd
    from repro_torch.kernels.flash_attention import ref as fa_ref
    print(f"== {title}")
    dtypes = {F32: torch.float32, BF16: torch.bfloat16}
    gen = torch.Generator(device="cuda").manual_seed(seed)
    timed = [shape for _, shape in timed_shapes]
    max_err, inputs = 0.0, {}
    for shape in all_shapes:
        B, Sq, Sk, H, KV, hd, causal, window, dt = shape
        q = torch.randn(B, Sq, H, hd, device="cuda", generator=gen).to(dtypes[dt])
        k, v = (torch.randn(B, Sk, KV, hd, device="cuda", generator=gen)
                .to(dtypes[dt]) for _ in range(2))
        do = torch.randn(B, Sq, H, hd, device="cuda", generator=gen).to(dtypes[dt])
        kw = dict(causal=causal, window=window)
        want_route = fa_bwd.route(q.dtype, hd)
        before = dict(fa_bwd.route_launches)
        got = fa_bwd.flash_attention_bwd_cuda(q, k, v, do, **kw)
        used = [r for r in before if fa_bwd.route_launches[r] != before[r]]
        check(used == [want_route], f"the backward at {shape} took {used}, "
              f"expected the {want_route} route")
        lse = fa_ref.flash_attention_lse_ref(q, k, **kw)
        want = fa_ref.flash_attention_bwd_ref(q, k, v, do, lse, **kw)
        torch.cuda.synchronize()
        errs = [rel_to_largest(g, w) for g, w in zip(got, want)]
        tol = FA_BWD_TOL[dt]
        ok = (all(g.dtype == w.dtype and g.shape == w.shape
                  for g, w in zip(got, want))
              and all(math.isfinite(e) and e <= tol for e in errs))
        print(f"  B={B} Sq={Sq} Sk={Sk} H={H} KV={KV} hd={hd} causal={causal} "
              f"window={window} {dt}, {want_route}: dq, dk, dv errors "
              f"{', '.join(f'{e:.2e}' for e in errs)} of the largest entry "
              f"(tol {tol:.3g}) {'ok' if ok else 'FAILED'}")
        check(ok, f"flash_attention's backward disagrees at {shape}")
        max_err = max(max_err, *errs)
        if dt in timed_dtypes and shape[:8] in timed:
            inputs[shape[:8], dt] = (q, k, v, do, kw)
        del got, want, lse

    timed_inputs = [(label if dt == BF16 else f"{label} float32", shape, dt)
                    for label, shape in timed_shapes for dt in timed_dtypes]
    for label, shape, dt in timed_inputs:
        q, k, v, do, kw = inputs[shape, dt]
        again = [fa_bwd.flash_attention_bwd_cuda(q, k, v, do, **kw)
                 for _ in range(2)]
        same = all(torch.equal(a, b) for a, b in zip(*again))
        print(f"  two launches at the {label} shape: "
              f"{'the same bits' if same else 'DIFFERENT bits'}")
        check(same, f"flash_attention's backward is not deterministic at "
              f"the {label} shape")
        del again

    routed = fa_bwd.route

    def cuda_core_route(*args, **kwargs):
        return "cuda_core"

    shapes = {}
    for label, shape, dt in timed_inputs:
        B, Sq, Sk, H, KV, hd, causal, window = shape
        q, k, v, do, kw = inputs[shape, dt]
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                      for t in (q, k, v))
        out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                             enable_gqa=H != KV)
        dot = do.transpose(1, 2)

        def sdpa_bwd():
            return torch.autograd.grad(out, (qt, kt, vt), dot,
                                       retain_graph=True)

        def plain():
            lse = fa_ref.flash_attention_lse_ref(q, k, **kw)
            return fa_ref.flash_attention_bwd_ref(q, k, v, do, lse, **kw)

        pairs, _ = valid_pairs(Sq, Sk, causal, window, 0, None)
        nbytes = (3 * B * Sq * H * hd + 4 * B * Sk * KV * hd) * q.element_size()
        flops = 10 * B * H * hd * pairs         # 5 products, 2 FLOP each
        route = fa_bwd.route(q.dtype, hd)
        ops = [(flops, bf16_rate if dt == BF16 else f32_rate)]
        if route == "tf32x3":
            ops = [(3 * flops, TF32_PER_BF16 * bf16_rate)]
        print(f"  {label} {shape} {dt}: {nbytes / 1e6:.1f} MB (q, k, v, dO "
              f"read, dq, dk, dv written), {flops / 1e9:.2f} GFLOP (5 "
              f"products over {pairs:,} pairs a head)")
        shapes[label] = timed_entry(
            torch, lambda: fa_bwd.flash_attention_bwd_cuda(q, k, v, do, **kw),
            plain, sdpa_bwd, nbytes, ops, mem_rate)
        shapes[label]["route"] = route
        if route == "tf32x3":
            shapes[label]["cuda_core_bound_ms"] = max(
                nbytes / mem_rate, flops / f32_rate) * 1e3
            print(f"    the CUDA cores' bound "
                  f"{shapes[label]['cuda_core_bound_ms']:.4f} ms (float32 at "
                  f"{f32_rate / 1e12:.0f} TFLOP/s); the 3xTF32 bound above")
        # the CUDA-core route (the only one before the tensor cores'), cold L2
        scratch = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
        fa_bwd.route = cuda_core_route
        try:
            cc = time_ms(torch, lambda: fa_bwd.flash_attention_bwd_cuda(
                q, k, v, do, **kw), reps=10, flush=scratch.zero_, spin=True)
        finally:
            fa_bwd.route = routed
        del scratch
        shapes[label]["cuda_core_ms"] = cc
        print(f"    the cuda_core route: {cc:.4f} ms, "
              f"{cc / shapes[label]['ms']:.2f} x the {shapes[label]['route']} "
              f"route's; SDPA's backward is "
              f"{shapes[label]['ms'] / shapes[label]['library_ms']:.2f} x "
              f"faster than the route")
        del out, qt, kt, vt
    del inputs
    torch.cuda.empty_cache()
    first = shapes[timed_shapes[0][0]]
    return {"max_abs_err": max_err,
            **{k: first[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                     "library_ms")},
            "shapes": shapes}


def ssm_bwd_phase(torch, mem_rate, f32_rate, exp_rate):
    """Phase 18.  Returns the backward kernel's entry of the kernels line
    (all but its launches)."""
    from repro_torch.kernels.ssm_scan import ref as ssm_ref
    from repro_torch.kernels.ssm_scan import ssm_scan_bwd as ssm_bwd
    print("== 18. ssm_scan backward against its plain version on the card")
    gen = torch.Generator(device="cuda").manual_seed(18)
    max_err, timed = 0.0, None
    for shape in SSM_BWD_SHAPES:
        B, S, D, N, with_h0 = shape
        for mamba_A in ((True,) if shape == JAMBA_PREFILL else (False, True)):
            args = ssm_inputs(torch, shape, gen, mamba_A)
            dy = torch.randn(B, S, D, device="cuda", generator=gen)
            dh = (torch.randn(B, D, N, device="cuda", generator=gen)
                  if with_h0 else None)
            got = ssm_bwd.ssm_scan_bwd_cuda(*args, dy, dh)
            want = ssm_ref.ssm_scan_bwd_ref(*args, dy, dh)
            torch.cuda.synchronize()
            errs = [rel_to_largest(g, w) for g, w in zip(got, want)
                    if w is not None]
            ok = ((got[5] is None) == (not with_h0)
                  and all(math.isfinite(e) and e <= SSM_TOL for e in errs))
            print(f"  B,S,D,N,h0={shape} A {'-(1..N)' if mamba_A else 'drawn'}"
                  f"{', dh' if dh is not None else ''}: dx, ddt, dA, dB, dC"
                  f"{', dh0' if with_h0 else ''} errors "
                  f"{', '.join(f'{e:.2e}' for e in errs)} (tol {SSM_TOL}) "
                  f"{'ok' if ok else 'FAILED'}")
            check(ok, f"ssm_scan's backward disagrees at {shape}")
            max_err = max(max_err, *errs)
            del got, want
            if shape == JAMBA_PREFILL:
                timed = (args, dy)
    (x, dt, A, Bc, Cc, h0), dy = timed
    again = [ssm_bwd.ssm_scan_bwd_cuda(x, dt, A, Bc, Cc, h0, dy)
             for _ in range(2)]
    same = all(torch.equal(a, b) for a, b in zip(*again) if a is not None)
    print(f"  two launches at {JAMBA_PREFILL}: "
          f"{'the same bits' if same else 'DIFFERENT bits'}")
    check(same, "ssm_scan's backward is not deterministic")
    del again
    B, S, D, N, _ = JAMBA_PREFILL
    nbytes = 4 * (5 * B * S * D + 4 * B * S * N + 2 * D * N)
    exps = B * S * D * N
    print(f"  train {JAMBA_PREFILL}: {nbytes / 1e6:.1f} MB (x, dt, dy read, "
          f"dx, ddt written; B, C, A and their gradients), {exps / 1e6:.1f} M "
          f"exp (the forward's, recomputed once), "
          f"{SSM_BWD_FLOPS * exps / 1e9:.2f} GFLOP fp32")
    entry = timed_entry(
        torch, lambda: ssm_bwd.ssm_scan_bwd_cuda(x, dt, A, Bc, Cc, h0, dy),
        lambda: ssm_ref.ssm_scan_bwd_ref(x, dt, A, Bc, Cc, h0, dy), None,
        nbytes, [(exps, exp_rate), (SSM_BWD_FLOPS * exps, f32_rate)], mem_rate)
    del timed, x, dt, A, Bc, Cc, dy
    torch.cuda.empty_cache()
    return {"max_abs_err": max_err, **entry, "shapes": {"train": dict(entry)}}


def with_plain_kernels(torch, counters, fn):
    """``fn()`` with the plain versions put in the kernels' place by this
    script (the package has no switch): ``flash_attention_ref`` for the
    attention and ``ssm_scan_ref`` for the scan, both differentiated by
    torch autograd.  The run must launch no kernel."""
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.ssm_scan import ref as ssm_ref
    from repro_torch.models import attention, ssm
    kernels = (attention.fa_ops.flash_attention, ssm.ssm_ops.ssm_scan)

    def plain_scan(x, dt, A, Bc, Cc, h0=None, *, h_out=None):
        check(h_out is None, "the plain scan takes no h_out")
        return ssm_ref.ssm_scan_ref(x, dt, A, Bc, Cc, h0)

    before = read_counts(counters)
    attention.fa_ops.flash_attention = fa_ref.flash_attention_ref
    ssm.ssm_ops.ssm_scan = plain_scan
    try:
        out = fn()
    finally:
        attention.fa_ops.flash_attention, ssm.ssm_ops.ssm_scan = kernels
    check(read_counts(counters) == before, "the run with the plain versions "
          "in the kernels' place launched a kernel")
    return out


def train_cells():
    """Phases 19 and 20, by number: the arguments of ``train_phase`` after
    ``counters`` (its title, the configuration, the tree's parameters, the
    launches of a step, the plain comparison's sequence)."""
    from repro_torch.configs import get_arch
    jamba8 = dataclasses.replace(get_arch("jamba-v0.1-52b"), moe=None,
                                 num_layers=8)
    return {
        "19": ("19. training OLMo-1B at full width and depth",
               get_arch("olmo-1b"), 1_176_764_416,
               {"bwo_evolve": 0, "flash_attention": 32,
                "flash_attention_bwd": 16, "ssm_scan": 0, "ssm_scan_bwd": 0},
               1024),
        "20": ("20. training Jamba without experts at full width, 8 layers",
               jamba8, 2_725_326_848,
               {"bwo_evolve": 0, "flash_attention": 2,
                "flash_attention_bwd": 1, "ssm_scan": 14, "ssm_scan_bwd": 7},
               256)}


def train_phase(torch, counters, title, cfg, want_params, want_launches,
                plain_seq, S=1024, extra=None, zero_leaves=()):
    """Phases 19, 20 and 25: ``make_train_step(build_model(cfg,
    max_seq=S), adamw(warmup_cosine(3e-4, 10, steps)))`` on
    ``make_token_dataset`` batches of 4 x ``S`` at full width (with
    ``extra(B)``'s entries, an encoder's frames, in each): a warm-up step,
    then timed steps, every launch counter set to 0 just before each step
    and read just after (``want_launches`` each); the tree's parameters
    (``want_params``); loss, aux and grad_norm finite; the step split into
    forward plus backward, clipping and the AdamW update; every parameter
    leaf's gradient non-zero but those of ``zero_leaves`` (paths whose
    gradient is 0 in exact arithmetic); the peak memory; one step's
    gradients through the kernels against the plain versions' with each
    input cut to ``plain_seq`` positions (an int, or one for each batch
    key), ``zero_leaves`` held within ZERO_LEAF_TOL of the largest entry
    of the whole tree's gradient.  Flash's routes follow from ``cfg``: an
    encoder's layers and the cross-attentions (the float32 encoder and its
    K/V) on the route ``route`` names for float32 (3xTF32 at hd 64), once
    for each encoder layer and twice for each
    decoder layer (its group's checkpointing runs the forward again), each
    backward once; the rest on the tensor cores.  Returns the launches of a
    step and the step's numbers."""
    from repro_torch import optim, random, tree
    from repro_torch.data import make_token_dataset
    from repro_torch.kernels.flash_attention import flash_attention as fa_kernel
    from repro_torch.kernels.flash_attention import flash_attention_bwd as fa_bwd
    from repro_torch.launch.steps import make_grad_fn, make_train_step
    from repro_torch.models.transformer import build_model
    print(f"== {title}")
    B, steps = 4, 4
    dev = torch.device("cuda")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg, max_seq=S)
    opt = optim.adamw(optim.warmup_cosine(3e-4, 10, steps))
    train_step, init_state = make_train_step(model, opt)
    t0 = time.perf_counter()
    state = init_state(random.PRNGKey(0, dev))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params, n_bytes = tree_size(tree, state["params"])
    moments = tree_size(tree, state["opt"])[1]
    print(f"  {cfg.num_layers} layers {cfg.block_pattern}, d {cfg.d_model}, "
          f"{cfg.param_dtype}; parameter tree {n_params:,} parameters, "
          f"{n_bytes:,} bytes; AdamW moments {moments:,} bytes; init "
          f"{init_s:.3f} s")
    check(n_params == want_params, f"the tree holds {n_params} parameters, "
          f"expected {want_params}")
    data = make_token_dataset(random.PRNGKey(1, dev), n_seqs=B * steps,
                              seq_len=S, vocab=cfg.vocab_size)
    batches = [{k: v[i * B:(i + 1) * B] for k, v in data.items()}
               for i in range(steps)]
    if extra is not None:
        for batch in batches:
            batch.update(extra(B))
    # the float32 encoder's and cross-attention's calls, on their own routes
    cross = cfg.num_layers if cfg.cross_attention else 0
    fwd_f32, bwd_f32 = cfg.encoder_layers + 2 * cross, \
        cfg.encoder_layers + cross
    hd = cfg.resolved_head_dim
    want_routes = fa_routes(
        tensor_core=want_launches["flash_attention"] - fwd_f32)
    want_bwd_routes = {**dict.fromkeys(fa_bwd.ROUTES, 0), "tensor_core":
                       want_launches["flash_attention_bwd"] - bwd_f32}
    if fwd_f32:
        want_routes[fa_kernel.route(torch.float32, torch.float32, hd,
                                    S)] += fwd_f32
        want_bwd_routes[fa_bwd.route(torch.float32, hd)] += bwd_f32
    step_s, launches, routes, bwd_routes = [], None, None, None
    for i, batch in enumerate(batches):
        torch.cuda.synchronize()
        reset_counts(counters)
        t0 = time.perf_counter()
        state, metrics = train_step(state, batch)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        got, got_routes = read_counts(counters), dict(fa_kernel.route_launches)
        got_bwd = dict(fa_bwd.route_launches)
        vals = {k: v.item() for k, v in metrics.items()}
        print(f"  step {i}{' (warm-up)' if i == 0 else ''}: {dt * 1e3:.1f} ms  "
              f"loss {vals['loss']:.4f}  aux {vals['aux']:.4f}  grad_norm "
              f"{vals['grad_norm']:.4f}; launches {got}; backward routes "
              f"{got_bwd}")
        check(all(math.isfinite(v) for v in vals.values()),
              f"non-finite metrics at step {i}: {vals}")
        check(got == want_launches, f"launches in step {i}: {got}, expected "
              f"{want_launches}")
        check(got_routes == want_routes, f"the train step's attention routes: "
              f"{got_routes}, expected {want_routes}")
        check(got_bwd == want_bwd_routes, f"the train step's attention "
              f"backward routes: {got_bwd}, expected {want_bwd_routes}")
        if i > 0:
            step_s.append(dt)
        launches, routes, bwd_routes = got, got_routes, got_bwd
    check(int(state["step"]) == steps, f"step count {int(state['step'])}")

    # the step's parts on the next batch, and every leaf's gradient
    grad_fn = make_grad_fn(model)
    batch = batches[0]
    params, leaves = state["params"], tree.leaves(state["params"])
    parts = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, grads = grad_fn(params, batch)
    torch.cuda.synchronize()
    parts["forward + backward"] = time.perf_counter() - t0
    paths = tree.paths(grads)
    check(set(zero_leaves) <= set(paths), f"no leaves {zero_leaves}")
    zero = [i for i, g in enumerate(tree.leaves(grads))
            if not bool(torch.isfinite(g).all())
            or (paths[i] not in zero_leaves and not bool(g.abs().max() > 0))]
    t0 = time.perf_counter()
    optim.clip_by_global_norm_(grads, 1.0)
    torch.cuda.synchronize()
    parts["clipping"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    opt.update_(params, grads, state["opt"], state["step"])
    torch.cuda.synchronize()
    parts["AdamW update"] = time.perf_counter() - t0
    del grads
    peak = torch.cuda.max_memory_allocated()
    total = sum(parts.values())
    print(f"  steps {', '.join(f'{t * 1e3:.1f}' for t in step_s)} ms "
          f"(tokens/s {B * S / statistics.median(step_s):.0f}); one step's "
          f"parts: " + ", ".join(f"{k} {v * 1e3:.1f} ms ({v / total:.1%})"
                                 for k, v in parts.items()))
    print(f"  {len(leaves)} parameter leaves, {len(leaves) - len(zero)} with "
          f"a non-zero (or, for the {len(zero_leaves)} whose gradient is 0 "
          f"in exact arithmetic, any), finite gradient; "
          f"max_memory_allocated {peak / 2**30:.2f} GiB")
    check(not zero, f"parameter leaves {zero} got a zero or non-finite "
          f"gradient")

    # one step's gradients through the kernels against the plain versions'
    cut = (plain_seq if isinstance(plain_seq, dict)
           else dict.fromkeys(batch, plain_seq))
    short = {k: v[:, :cut[k]] for k, v in batch.items()}
    _, through = grad_fn(params, short)
    _, plain = with_plain_kernels(torch, counters,
                                  lambda: grad_fn(params, short))
    pairs = list(zip(paths, tree.leaves(through), tree.leaves(plain)))
    largest = max(w.float().abs().max().item() for _, _, w in pairs)
    ratios = [(g.float() - w.float()).abs().max().item()
              / max(1e-30, w.float().abs().max().item())
              for p, g, w in pairs if p not in zero_leaves]
    worst = max(range(len(ratios)), key=ratios.__getitem__)
    print(f"  gradients through the kernels against the plain versions "
          f"(inputs cut to {plain_seq}), leaf by leaf, largest difference "
          f"over the leaf's largest entry: max {ratios[worst]:.3e} (leaf "
          f"{worst}), median {statistics.median(ratios):.3e} (tol "
          f"{TRAIN_GRAD_TOL:.4g})")
    check(all(math.isfinite(r) and r <= TRAIN_GRAD_TOL for r in ratios),
          "the kernels' gradients disagree with the plain versions'")
    for p, g, w in pairs:
        if p in zero_leaves:
            sizes = (g.float().abs().max().item(), w.float().abs().max().item())
            print(f"  {p} (0 in exact arithmetic): largest entry through the "
                  f"kernels {sizes[0]:.3e}, plain {sizes[1]:.3e}, against "
                  f"the tree's largest gradient entry {largest:.3e} "
                  f"({max(sizes) / largest:.3e} of it, tol {ZERO_LEAF_TOL})")
            check(max(sizes) <= ZERO_LEAF_TOL * largest,
                  f"{p}'s gradient is not 0 within the tolerance")
    del through, plain, pairs, state, params, leaves, data, batches
    torch.cuda.empty_cache()
    return launches, {"step_ms": [t * 1e3 for t in step_s],
                      "tokens_per_s": B * S / statistics.median(step_s),
                      "init_s": init_s, "params": n_params,
                      "parts_ms": {k: v * 1e3 for k, v in parts.items()},
                      "peak_gib": peak / 2**30, "routes": routes,
                      "bwd_routes": bwd_routes,
                      "grad_vs_plain": {"max": ratios[worst], "leaf": worst,
                                        "median": statistics.median(ratios)}}


def model_extras(cfg, B, key, dev="cpu"):
    """A batch's inputs beside the tokens, drawn from ``key``: an
    encoder's frames (normal, x 0.1) and a vision prefix's rows (normal)."""
    from repro_torch import random
    out = {}
    if cfg.encoder_layers:
        out["encoder_embeds"] = (random.normal(
            key, (B, cfg.encoder_seq, cfg.d_model)) * 0.1).to(dev)
    if cfg.vision_tokens:
        out["image_embeds"] = random.normal(
            random.split(key)[1], (B, cfg.vision_tokens, cfg.d_model)).to(dev)
    return out


def train_card_vs_cpu(torch, names=("olmo-1b", "jamba-v0.1-52b",
                                    "deepseek-v2-236b"),
                      title="21. reduced train steps on the card against "
                            "the CPU route"):
    """Phase 21 (and 25b): three train steps of each reduced configuration
    (float32) from one state, on the card and on the port's CPU route:
    losses, aux and grad norms within TRAIN_CARD_CPU_RTOL relative."""
    from repro_torch import optim, random, tree
    from repro_torch.configs import get_arch
    from repro_torch.data import make_token_dataset
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.transformer import build_model
    print(f"== {title}")
    B, S = 2, 64
    for name in names:
        cfg = get_arch(name).reduced()
        model = build_model(cfg, max_seq=S)
        data = make_token_dataset(random.PRNGKey(1, "cpu"), n_seqs=3 * B,
                                  seq_len=S, vocab=cfg.vocab_size)
        data.update(model_extras(cfg, 3 * B, random.PRNGKey(2, "cpu")))
        got = {}
        for dev in ("cuda", "cpu"):
            step, init = make_train_step(
                model, optim.adamw(optim.warmup_cosine(1e-3, 1, 10)))
            state = init(random.PRNGKey(0, "cpu"))
            state = tree.map(lambda t: t.to(dev), state)
            rows = []
            for i in range(3):
                batch = {k: v[i * B:(i + 1) * B].to(dev)
                         for k, v in data.items()}
                state, met = step(state, batch)
                rows.append({k: v.item() for k, v in met.items()})
            got[dev] = rows
        worst = max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-30)
                    for a, b in zip(got["cuda"], got["cpu"])
                    for k in b if b[k] != 0 or a[k] != 0)
        print(f"  {name} reduced: card "
              f"{[(round(r['loss'], 5), round(r['grad_norm'], 5)) for r in got['cuda']]}"
              f", CPU {[(round(r['loss'], 5), round(r['grad_norm'], 5)) for r in got['cpu']]}"
              f" (loss, grad_norm); aux card {[r['aux'] for r in got['cuda']]}"
              f"; largest relative difference {worst:.2e} (tol "
              f"{TRAIN_CARD_CPU_RTOL})")
        check(worst <= TRAIN_CARD_CPU_RTOL,
              f"{name}: the card's train steps disagree with the CPU route's")


# Whisper's key biases (self-attention and cross-attention of the decoder,
# the encoder's self-attention): each adds one constant to every key's
# score of a query, which softmax does not see, so their gradients are 0 in
# exact arithmetic (rounding in both routes); phase 25 holds them to
# ZERO_LEAF_TOL of the tree's largest gradient entry instead of their own:
# on an H100 they read at most 1.11e-5 of it (7.125e-8 against 6.409e-3,
# through the kernels and plain alike), and the limit is about 10 times
# that.
WHISPER_ZERO_LEAVES = ("/groups/sub0/mixer/wk/b", "/groups/sub0/cross/wk/b",
                       "/encoder/mixer/wk/b")
ZERO_LEAF_TOL = 1e-4
# Phase 27: the int8 cache's decode logits against the bf16 cache's.  The
# reference's int8 tolerance (tests/test_kv_quant.py: rtol 0.1, atol 0.15)
# is stated on logits of RMS ~1 (granite-8b reduced: 0.996); OLMo-1B ties
# its logits to a unit-normal table, RMS ~45 at full width, so the atol is
# taken in units of the bf16 logits' RMS.  The literal one's share of
# elements is printed beside it.
INT8_RTOL, INT8_ATOL_RMS = 0.1, 0.15


def sq_sk_bwd_phase(torch, mem_rate, bf16_rate, f32_rate):
    """Phase 23: ``flash_bwd_phase`` at FA_BWD_SQ_SK_SHAPES (Whisper's
    shapes timed in bf16 and float32), then each type's route at Whisper's cross-attention train shape with keys 1 % apart (a
    deep encoder's frames: each row's attention spread evenly, so dS = P
    (dP - D) is a difference of near-equal numbers) against torch autograd
    through the plain forward in float32 on the same inputs, at
    FA_BWD_TOL.  Returns the backward's entry with the largest of those
    errors."""
    from repro_torch.kernels.flash_attention import flash_attention_bwd as fa_bwd
    from repro_torch.kernels.flash_attention import ref as fa_ref
    entry = flash_bwd_phase(
        torch, mem_rate, bf16_rate, "23. flash_attention backward where "
        "queries and keys differ in number", FA_BWD_SQ_SK_SHAPES,
        FA_BWD_SQ_SK_TIMED, seed=23, f32_rate=f32_rate,
        timed_dtypes=(BF16, F32))
    B, Sq, Sk, H, KV, hd, causal, window = WHISPER_CROSS_TRAIN
    gen = torch.Generator(device="cuda").manual_seed(231)
    worst = 0.0
    for dt, tdt in ((BF16, torch.bfloat16), (F32, torch.float32)):
        q = torch.randn(B, Sq, H, hd, device="cuda", generator=gen)
        k = (torch.randn(1, 1, KV, hd, device="cuda", generator=gen)
             + 0.01 * torch.randn(B, Sk, KV, hd, device="cuda", generator=gen))
        v = torch.randn(B, Sk, KV, hd, device="cuda", generator=gen)
        do = torch.randn(B, Sq, H, hd, device="cuda", generator=gen)
        q, k, v, do = (t.to(tdt) for t in (q, k, v, do))
        got = fa_bwd.flash_attention_bwd_cuda(q, k, v, do, causal=causal,
                                              window=window)
        leaves = [t.float().requires_grad_() for t in (q, k, v)]
        o = fa_ref.flash_attention_ref(*leaves, causal=causal, window=window)
        want = torch.autograd.grad(o, leaves, do.float())
        errs = [rel_to_largest(g, w) for g, w in zip(got, want)]
        print(f"  keys 1 % apart, {WHISPER_CROSS_TRAIN} {dt}, "
              f"{fa_bwd.route(tdt, hd)}: dq, dk, dv against autograd of the "
              f"float32 forward {', '.join(f'{e:.2e}' for e in errs)} of the "
              f"largest entry (tol {FA_BWD_TOL[dt]:.3g})")
        check(all(math.isfinite(e) and e <= FA_BWD_TOL[dt] for e in errs),
              f"the backward misses autograd's gradient with alike keys ({dt})")
        worst = max(worst, *errs)
        del got, want, o, leaves
    torch.cuda.empty_cache()
    return {**entry, "alike_keys_max_err": worst}


def slice_phases(torch, counters, rates, smi, t_start, only=None):
    """Phases 22-27 (those named in ``only``, or all), each followed by
    its seconds, the script's so far and the card's name and power limit
    (``smi``).  ``rates``: the card's memory, float32, bf16 and exp rates.
    Returns each phase's result by number."""
    from repro_torch.configs import get_arch
    mem_rate, f32_rate, bf16_rate, _ = rates
    phases = {
        "22": lambda: flash_phase(
            torch, mem_rate, bf16_rate, "22. flash_attention at "
            "Whisper-medium's and LLaVA-NeXT's shapes",
            [shape for _, shape in FA_NEW_TIMED], FA_NEW_TIMED, seed=22,
            f32_rate=f32_rate)[0],
        "23": lambda: sq_sk_bwd_phase(torch, mem_rate, bf16_rate, f32_rate),
        "24": lambda: encdec_serve_phase(
            torch, counters, "24. serving Whisper-medium at full width and "
            "depth", get_arch("whisper-medium"), 812_935_168),
        "25": lambda: whisper_train_phase(torch, counters),
        "26": lambda: encdec_serve_phase(
            torch, counters, "26. serving LLaVA-NeXT-Mistral-7B at full "
            "width and depth", get_arch("llava-next-mistral-7b"),
            7_241_732_096),
        "27": lambda: int8_phase(torch, counters)}
    return run_numbered(phases, smi, t_start, only)


def meta_tree_size(cfg, max_seq):
    """The parameter tree's size, counted on the meta device (shapes only,
    nothing drawn)."""
    from repro_torch import random, tree
    from repro_torch.models.transformer import build_model
    params = build_model(cfg, max_seq=max_seq).init(random.PRNGKey(0, "meta"))
    return sum(t.numel() for t in tree.leaves(params))


def encdec_serve_phase(torch, counters, title, cfg, want_params):
    """Phases 24 and 26: one full-width ``serve()`` (batch 4, prompt 32,
    32 tokens, temperature 1) with every counter set to 0 just before and
    read just after, flash's routes derived from the configuration: at
    prefill one tensor-core call for each decoder self-attention and one
    call on the route ``route`` names for float32 (3xTF32 at hd 64) for
    each encoder layer and each cross-attention (the float32 encoder, as
    the reference's promotion runs it, and its float32 K/V), at each of the 31 decode steps one split-K call for each decoder
    attention (the cross K/V cached as bf16); then the reduced
    configuration served greedily on the card and on the CPU route (phase
    9's check); with an encoder, the same ``serve()`` again (warm) and
    the float32 encoder against the CPU route's.  Returns the launches,
    the routes and the serving numbers."""
    from repro_torch.configs import get_arch
    print(f"== {title}")
    P, G = 32, 32
    from repro_torch.kernels.flash_attention import flash_attention as fa_kernel
    cross = cfg.num_layers if cfg.cross_attention else 0
    attn = cfg.num_layers + cross
    routes = fa_routes(tensor_core=cfg.num_layers, split_k=attn * (G - 1))
    if cfg.encoder_layers + cross:
        routes[fa_kernel.route(torch.float32, torch.float32,
                               cfg.resolved_head_dim, P)] += \
            cfg.encoder_layers + cross
    n_params = meta_tree_size(cfg, cfg.vision_tokens + P + G)
    print(f"  parameter tree {n_params:,} (ArchConfig.num_params() "
          f"{cfg.num_params():,}); prompt {P} after {cfg.vision_tokens} image "
          f"rows, {cfg.encoder_seq} encoder frames")
    check(n_params == want_params, f"the tree holds {n_params} parameters, "
          f"expected {want_params}")
    launches, got, numbers = serve_checked(
        torch, counters, cfg,
        {"bwo_evolve": 0, "flash_attention": sum(routes.values()),
         "ssm_scan": 0, "flash_attention_bwd": 0, "ssm_scan_bwd": 0},
        routes, f"the {cfg.name} serving path", P=P)
    if cfg.encoder_layers:
        # the same serve() again: the first call's prefill carries the
        # process's set-up (library loads, the first float32 products),
        # 369-846 ms in four runs of phase 24 alone on an H100
        from repro_torch.launch.serve import serve
        warm = serve(cfg, batch=4, prompt_len=P, gen=G, temperature=1.0,
                     device="cuda")
        numbers["warm"] = {"prefill_ms": warm.prefill_ms,
                           "decode_ms_per_step": warm.decode_ms_per_step,
                           "tokens_per_s": warm.tokens_per_s}
        print(f"  again (warm): prefill_ms {warm.prefill_ms:.3f}  "
              f"decode_ms_per_step {warm.decode_ms_per_step:.3f}  "
              f"tokens_per_s {warm.tokens_per_s:.1f}")
        del warm
        numbers["encoder_card_vs_cpu"] = encoder_precision(torch, cfg)
    card_vs_cpu(torch, f"{cfg.name} reduced", get_arch(cfg.name).reduced())
    return launches, got, numbers


# Float32 frames run a bf16 encoder in float32 (``dense_apply`` takes the
# weights as float32), as JAX's promotion runs the reference's.  Phase 24
# holds the card's float32 encoder (cuBLAS with TF32 off, flash's CUDA-core
# route) against the CPU route's (``blockwise_attention``) on the same bf16
# weights and frames, at ENC_CARD_CPU_RMS_TOL in RMS over the CPU output's
# RMS: float32 sums in another order, through 24 layers.
ENC_CARD_CPU_RMS_TOL = 2 ** -14


def encoder_precision(torch, cfg):
    """The encoder's output on the card against the CPU route on one
    drawing of the bf16 weights and 1 x ``encoder_seq`` frames: both
    float32; RMS and largest differences over the CPU output's, and the
    card's flash routes."""
    from repro_torch import random, tree
    from repro_torch.kernels.flash_attention import flash_attention as fa_kernel
    from repro_torch.models.transformer import build_model
    dev = torch.device("cuda")
    model = build_model(cfg, max_seq=8)
    params = model.init(random.PRNGKey(0, dev))
    enc = {k: params[k] for k in ("encoder", "enc_pos", "enc_norm")}
    del params
    frames = model_extras(cfg, 1, random.PRNGKey(2, dev), "cuda")["encoder_embeds"]
    before = dict(fa_kernel.route_launches)
    with torch.no_grad():
        got = model._encode(enc, frames)
        routes = {r: fa_kernel.route_launches[r] - before[r]
                  for r in fa_kernel.ROUTES}
        want = model._encode(tree.map(lambda t: t.cpu(), enc), frames.cpu())
    got = got.cpu()
    diff = got - want
    rms = (diff.pow(2).mean().sqrt() / want.pow(2).mean().sqrt()).item()
    largest = (diff.abs().max() / want.abs().max()).item()
    print(f"  the float32 encoder on the card against the CPU route on the "
          f"same {cfg.param_dtype} weights (1 x {cfg.encoder_seq} frames): "
          f"{got.dtype} and {want.dtype}, RMS {rms:.3e} of the CPU output's "
          f"(tol 2^-14), largest {largest:.3e} of its largest entry; card "
          f"routes {routes}")
    check(got.dtype == want.dtype == torch.float32,
          f"the encoder's output is {got.dtype} / {want.dtype}, not float32")
    want = fa_routes(tf32x3=cfg.encoder_layers)
    check(routes == want, f"the float32 encoder took routes {routes}, "
          f"expected {want}")
    check(math.isfinite(rms) and rms <= ENC_CARD_CPU_RMS_TOL,
          "the card's float32 encoder is further from the CPU route's than "
          "expected")
    del enc, frames, got, want, diff
    torch.cuda.empty_cache()
    return {"rms": rms, "largest": largest}


def whisper_train_phase(torch, counters):
    """Phase 25: Whisper-medium trained at full width and depth on 4 x 448
    decoder tokens (its max_target_positions, arXiv:2212.04356) and 1500
    encoder frames drawn from the seed (``train_phase``): 24 encoder
    forwards, 2 x 24 decoder attentions run twice (the groups' activation
    checkpointing), 72 backwards; the decoder's self-attention on the
    tensor cores, the float32 encoder and cross-attention (K/V from the
    float32 encoder output, as the reference) on the 3xTF32 route; the plain
    comparison on the 448 tokens and 750 of the frames.  Then 25b."""
    from repro_torch import random
    from repro_torch.configs import get_arch
    cfg = get_arch("whisper-medium")
    S, n, enc = 448, cfg.num_layers, cfg.encoder_layers
    key = random.PRNGKey(2, torch.device("cuda"))
    out = train_phase(
        torch, counters, "25. training Whisper-medium at full width and depth",
        cfg, 813_328_384,
        {"bwo_evolve": 0, "flash_attention": enc + 2 * 2 * n,
         "flash_attention_bwd": enc + 2 * n, "ssm_scan": 0,
         "ssm_scan_bwd": 0},
        {"tokens": S, "labels": S, "encoder_embeds": 750}, S=S,
        extra=lambda B: model_extras(cfg, B, key, "cuda"),
        zero_leaves=WHISPER_ZERO_LEAVES)
    train_card_vs_cpu(torch, ("whisper-medium", "llava-next-mistral-7b"),
                      "25b. reduced Whisper-medium and LLaVA-NeXT train steps "
                      "on the card against the CPU route")
    return out


def int8_phase(torch, counters):
    """Phase 27: OLMo-1B at full width through the model API (the
    reference's serve has no int8 switch): ``cache_init(4, 1056,
    quantized=...)``, prefill 1024, then 32 decode steps, with the bf16
    cache and then the int8 one, on one drawing of the weights and the
    same tokens; every counter set to 0 before each run and read after
    (16 tensor-core, 512 split-K calls: the int8 cache is dequantized to
    bf16 before the kernel).  Each step's logits against the bf16 cache's
    (INT8_RTOL, INT8_ATOL_RMS).  Returns the int8 run's launches, routes
    and numbers."""
    from repro_torch import random, tree
    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attention import flash_attention as fa_kernel
    from repro_torch.models.transformer import build_model
    print("== 27. the int8 KV cache at OLMo-1B full width")
    cfg = get_arch("olmo-1b")
    B, P, G = 4, 1024, 32
    dev = torch.device("cuda")
    model = build_model(cfg, max_seq=P + G)
    params = model.init(random.PRNGKey(0, dev))
    toks = random.randint(random.PRNGKey(1, dev), (B, P + G), 0,
                          cfg.vocab_size)
    runs = {}
    for quantized in (False, True):
        cache = model.cache_init(B, P + G, quantized=quantized, device=dev)
        nbytes = sum(t.numel() * t.element_size() for t in tree.leaves(cache))
        torch.cuda.synchronize()
        reset_counts(counters)
        t0 = time.perf_counter()
        _, cache, _ = model.apply(params, {"tokens": toks[:, :P]},
                                  mode="prefill", cache=cache)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        outs = []
        t0 = time.perf_counter()
        for t in range(P, P + G):
            logits, cache, _ = model.apply(
                params, {"tokens": toks[:, t:t + 1]}, mode="decode",
                cache=cache, cache_pos=t)
            outs.append(logits[:, 0])
        torch.cuda.synchronize()
        decode_ms = (time.perf_counter() - t0) / G * 1e3
        launches, routes = read_counts(counters), dict(fa_kernel.route_launches)
        name = "int8" if quantized else "bf16"
        print(f"  {name} cache: {nbytes:,} bytes; prefill {prefill_ms:.3f} ms, "
              f"decode {decode_ms:.3f} ms a step; launches {launches}")
        check_routes(routes, fa_routes(tensor_core=cfg.num_layers,
                                       split_k=cfg.num_layers * G),
                     f"the {name} cache's prefill and decode")
        runs[name] = {"logits": torch.stack(outs), "cache_bytes": nbytes,
                      "prefill_ms": prefill_ms, "decode_ms_per_step": decode_ms,
                      "launches": launches, "routes": routes}
        del cache
    got, want = runs["int8"].pop("logits"), runs["bf16"].pop("logits")
    check(bool(torch.isfinite(got).all()), "non-finite int8 logits")
    diff, mag = (got - want).abs(), want.abs()
    rms = want.pow(2).mean().sqrt().item()
    literal = (diff > 0.15 + 0.1 * mag).float().mean().item()
    ok = bool((diff <= INT8_ATOL_RMS * rms + INT8_RTOL * mag).all())
    top1 = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
    print(f"  int8 against bf16 over {G} steps: max |diff| "
          f"{diff.max().item():.4f}, bf16 logits RMS {rms:.3f} (max "
          f"{mag.max().item():.2f}); within rtol {INT8_RTOL} + atol "
          f"{INT8_ATOL_RMS} x RMS: {'yes' if ok else 'NO'}; the literal atol "
          f"0.15 fails at {literal:.2%} of elements; the same greedy token "
          f"at {top1:.2%} of (step, row); cache bytes "
          f"{runs['int8']['cache_bytes'] / runs['bf16']['cache_bytes']:.3f} "
          f"of bf16's")
    check(ok, "the int8 cache's logits left the reference's int8 tolerance "
          "(in units of the logits' RMS)")
    del params, toks, got, want
    torch.cuda.empty_cache()
    return runs


# Phases 28-32.  xLSTM-1.3B's tree (ArchConfig.num_params() counts
# 2,017,984,512: ROADMAP queue 3) and at the train phase's 12 layers; the
# 8-layer LLaVA-NeXT tree of phase 32.
XLSTM_TREE, XLSTM12_TREE = 3_527_610_688, 1_036_439_632
LLAVA8_TREE = 2_007_044_096
# Phase 28b: decode against the full forward, each step's logits within
# this share of the step's largest logit (phase 8's bf16 limit), on float32
# weights: a random-weight bf16 xLSTM is chaotic at depth (48 layers of
# width 256 on the CPU put a bf16 forward's logits 1.01 of the largest from
# a float32 forward on the same weights, and decode 0.72 from the full
# forward; float32 decode 4.8e-4), so the bf16 numbers are printed beside
# it, not held.
XLSTM_DECODE_TOL = 2 ** -6
# Phases 30-31: the continuous-batching server's requests (prompt length,
# new tokens) in submission order, its slots and cache length.  Phase 30's
# order makes a slot freed at position 1055 stay empty while others decode,
# so its position passes max_len - 1 (1158 at the end).  Phase 31's prompts
# keep the reference's chunk rule for the Mamba prefill, S % min(128, S) ==
# 0 (src/repro/models/ssm.py:103-104), which prompts of 1000, 129 or 700
# fail in both packages: below 128 they are ragged against the scan's
# 32-step tile.
SERVER_OLMO = (((512, 16), (999, 32), (128, 64), (700, 48), (900, 32),
                (1000, 24), (1024, 32), (37, 128), (257, 128), (64, 96)),
               4, 1152)
SERVER_JAMBA = (((512, 32), (37, 32), (896, 32), (127, 32), (640, 32),
                 (64, 32)), 3, 1056)
# a server token against a B = 1 replay on its own tokens: the replay's
# argmax, or within this share of the replay's largest logit of it (a
# near-tie, which the batched products' other rounding may flip)
NEAR_TIE = 2 ** -6
# Phase 30a / 31a: the kernels at the server's shapes.  B = 1 prefills at
# ragged lengths (tensor cores), and the batched decode over the 1152- and
# 1056-position caches with a per-row kv_len (split-K), OLMo-1B's 16 on 16
# and Jamba's 32 on 8 heads; the scan's B = 1 prefills and its decode at 3
# slots.  Phase 32a: the backward at LLaVA-NeXT's train shape (2880 image
# rows + 32 tokens, causal).
SERVER_DECODE = (4, 1, 1152, 16, 16, 128, False, None, 0,
                 (1041, 100, 1152, 530), BF16, BF16)
FA_SERVER_TIMED = (
    ("server prefill 1000", (1, 1000, 1000, 16, 16, 128, True, None, 0, None,
                             BF16, BF16)),
    ("server prefill 37", (1, 37, 37, 16, 16, 128, True, None, 0, None,
                           BF16, BF16)),
    ("server decode, per-row kv_len", SERVER_DECODE))
FA_SERVER_SHAPES = ([shape for _, shape in FA_SERVER_TIMED]
                    + [(1, 896, 896, 32, 8, 128, True, None, 0, None, BF16, BF16),
                       (1, 127, 127, 32, 8, 128, True, None, 0, None, BF16, BF16),
                       (3, 1, 1056, 32, 8, 128, False, None, 0, (513, 38, 928),
                        BF16, BF16)])
SSM_SERVER_TIMED = (("server prefill 896", (1, 896, 8192, 16, False)),
                    ("server prefill 37", (1, 37, 8192, 16, False)),
                    ("server decode, 3 slots", (3, 1, 8192, 16, True)))
SSM_SERVER_SHAPES = ([shape for _, shape in SSM_SERVER_TIMED]
                     + [(1, 127, 8192, 16, False), (1, 64, 8192, 16, False)])
LLAVA_TRAIN = (4, 2912, 2912, 32, 8, 128, True, None)
NO_LAUNCHES = {"bwo_evolve": 0, "flash_attention": 0, "ssm_scan": 0,
               "flash_attention_bwd": 0, "ssm_scan_bwd": 0}


def xlstm_serve_phase(torch, counters):
    """Phase 28: xLSTM-1.3B served at full width and depth (batch 4,
    prompt 1024, 32 tokens, temperature 1) with every counter set to 0 just
    before and read just after: no kernel launches, since the reference has
    no kernel here (the mLSTM and sLSTM run in plain PyTorch).  Then 28b."""
    from repro_torch import tree
    from repro_torch.configs import get_arch
    from repro_torch.models.transformer import build_model
    print("== 28. serving xLSTM-1.3B at full width and depth")
    cfg = get_arch("xlstm-1.3b")
    n_params = meta_tree_size(cfg, 1056)
    cache = build_model(cfg).cache_init(4, 1056, device="meta")
    cache_bytes = sum(t.numel() * t.element_size() for t in tree.leaves(cache))
    print(f"  parameter tree {n_params:,} (ArchConfig.num_params() "
          f"{cfg.num_params():,}); the state cache at batch 4 "
          f"{cache_bytes:,} bytes")
    check(n_params == XLSTM_TREE, f"the tree holds {n_params} parameters, "
          f"expected {XLSTM_TREE}")
    launches, _, numbers = serve_checked(
        torch, counters, cfg, NO_LAUNCHES,
        fa_routes(), "the xLSTM-1.3B serving path")
    numbers["cache_bytes"] = cache_bytes
    numbers["layer_prefill_ms"] = xlstm_layer_times(torch, cfg)
    numbers["decode_vs_forward"] = xlstm_decode_phase(torch, cfg)
    return launches, numbers


def xlstm_layer_times(torch, cfg, B=4, S=1024):
    """One mLSTM and one sLSTM layer's prefill at the serving shape (host
    clock ending in a sync: the sLSTM's S steps are launched one by one
    from the host), in ms."""
    from repro_torch import random
    from repro_torch.models import xlstm
    dev = torch.device("cuda")
    key = random.PRNGKey(3, dev)
    x = random.normal(key, (B, S, cfg.d_model)).to(cfg.param_dtype)
    out = {}
    for kind in ("mlstm", "slstm"):
        p = getattr(xlstm, f"{kind}_init")(key, cfg)
        state = getattr(xlstm, f"{kind}_state_init")(cfg, B, device=dev)
        apply = getattr(xlstm, f"{kind}_apply")
        with torch.no_grad():
            out[kind] = time_ms(torch, lambda: apply(
                p, x, cfg=cfg, mode="prefill", state=state), reps=3, warmup=1)
        del p, state
    print(f"  one layer's prefill ({B} x {S}): mLSTM {out['mlstm']:.3f} ms, "
          f"sLSTM {out['slstm']:.3f} ms ({out['slstm'] / S * 1e3:.1f} us a "
          f"step launched from the host)")
    torch.cuda.empty_cache()
    return out


def xlstm_decode_phase(torch, cfg):
    """Phase 28b: prefill 896 tokens, decode 128 more teacher-forced,
    against one train-mode forward over the 1024, at full width and depth
    (batch 2): float32 weights held to XLSTM_DECODE_TOL; then the same
    weights in bf16, printed (see XLSTM_DECODE_TOL)."""
    from repro_torch import random, tree
    from repro_torch.models.transformer import build_model
    P, T, B = 896, 1024, 2
    dev = torch.device("cuda")
    print(f"== 28b. xLSTM-1.3B decode against the full forward (prefill {P}, "
          f"decode to {T}, batch {B})")
    toks = random.randint(random.PRNGKey(1, dev), (B, T), 0, cfg.vocab_size)
    cfg32 = dataclasses.replace(cfg, param_dtype=torch.float32)
    params = build_model(cfg32, max_seq=T).init(random.PRNGKey(0, dev))
    out, fulls = {}, {}
    for dt in (torch.float32, torch.bfloat16):
        model = build_model(dataclasses.replace(cfg, param_dtype=dt), max_seq=T)
        # the same weights in each leaf's type of a bf16 tree (the gates
        # and rh stay float32)
        types = model.init(random.PRNGKey(0, "meta"))
        p = tree.map(lambda t, like: t.to(like.dtype), params, types)
        with torch.no_grad():
            full = model.apply(p, {"tokens": toks}, mode="train")[0]
            cache = model.cache_init(B, T, device=dev)
            model.apply(p, {"tokens": toks[:, :P]}, mode="prefill",
                        cache=cache)
            worst = 0.0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for t in range(P, T):
                logits = model.apply(p, {"tokens": toks[:, t:t + 1]},
                                     mode="decode", cache=cache,
                                     cache_pos=t)[0][:, 0]
                err = ((logits - full[:, t]).abs().amax(-1)
                       / full[:, t].abs().amax(-1)).max().item()
                worst = max(worst, err)
            step_ms = (time.perf_counter() - t0) / (T - P) * 1e3
        fulls[dt] = full[:, P:].float()
        name = "float32" if dt == torch.float32 else "bf16"
        out[name] = {"worst": worst, "decode_ms_per_step": step_ms}
        print(f"  {name} weights: each step's logits against the full "
              f"forward's, largest difference over the step's largest logit: "
              f"worst {worst:.3e} over {T - P} steps"
              + (f" (tol 2^-6)" if name == "float32" else
                 " (printed, not held: see XLSTM_DECODE_TOL)")
              + f"; {step_ms:.2f} ms a step")
        check(math.isfinite(worst), f"non-finite {name} logits")
        del p, cache, full
    chaos = ((fulls[torch.bfloat16] - fulls[torch.float32]).abs().amax(-1)
             / fulls[torch.float32].abs().amax(-1)).max().item()
    out["bf16_forward_vs_float32"] = chaos
    print(f"  the bf16 forward against the float32 one on the same weights: "
          f"{chaos:.3e} of the largest logit at worst")
    check(out["float32"]["worst"] <= XLSTM_DECODE_TOL,
          "xLSTM's decode left the full forward")
    del params, fulls
    torch.cuda.empty_cache()
    return out


def xlstm_train_phase(torch, counters):
    """Phase 29: xLSTM-1.3B trained at full width on 4 x 1024 tokens, cut
    to 12 layers (2 of its 8 six-layer groups: the full tree's weights,
    gradients and float32 moments alone are ~42 GB), through
    ``train_phase`` (no kernel launches; the plain comparison at 256
    tokens); 29b the reduced step on the card against the CPU route."""
    from repro_torch.configs import get_arch
    cfg = dataclasses.replace(get_arch("xlstm-1.3b"), num_layers=12)
    out = train_phase(torch, counters, "29. training xLSTM-1.3B at full "
                      "width, 12 layers", cfg, XLSTM12_TREE, NO_LAUNCHES, 256)
    train_card_vs_cpu(torch, ("xlstm-1.3b",), "29b. the reduced xLSTM train "
                      "step on the card against the CPU route")
    return out


def server_phase(torch, counters, title, cfg, requests, max_batch, max_len):
    """Phases 30 and 31: ``BatchedServer(build_model(cfg), ...)`` on the
    card with ``requests`` (prompt length, new tokens; prompts drawn from
    the seed) submitted in order, stepped to the end with every counter set
    to 0 just before and read just after: every request completes with its
    length, one prefill each; flash's calls by route (each prefill's
    attention layers on the route ``flash_attention.route`` names for a
    B = 1 prompt, each step's on split-K with a (B,) kv_len, none on the
    CUDA cores); ``ssm_scan`` one prefill per Mamba layer per request and
    one decode per Mamba layer per step.  Prints the largest position an
    empty slot decoded at.  Then each request replayed alone on the card (a
    B = 1 prefill, int positions), teacher-forced on the server's tokens:
    each is the replay's argmax, or within NEAR_TIE of its largest logit.
    Returns the launches, flash's routes and the numbers."""
    from repro_torch import random
    from repro_torch.kernels.flash_attention import flash_attention as fa_kernel
    from repro_torch.models.transformer import build_model
    from repro_torch.serving import BatchedServer, Request
    print(f"== {title}")
    dev = torch.device("cuda")
    n_attn = sum(k == "attn" for k in cfg.block_pattern) * cfg.num_groups
    n_mamba = sum(k == "mamba" for k in cfg.block_pattern) * cfg.num_groups
    model = build_model(cfg, max_seq=max_len)
    params = model.init(random.PRNGKey(0, dev))
    longest = max(p for p, _ in requests)
    toks = random.randint(random.PRNGKey(1, dev), (len(requests), longest), 0,
                          cfg.vocab_size)
    reqs = [Request(uid=i, prompt=toks[i, :p], max_new_tokens=n)
            for i, (p, n) in enumerate(requests)]
    print(f"  {cfg.num_layers} layers {cfg.block_pattern}, d {cfg.d_model}; "
          f"{max_batch} slots, max_len {max_len}; requests (prompt, new "
          f"tokens) {list(requests)}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    server = BatchedServer(model, params, max_batch=max_batch,
                           max_len=max_len, device="cuda")
    for r in reqs:
        server.submit(r)
    torch.cuda.synchronize()
    reset_counts(counters)
    decode_s, past_end = [], 0
    t0 = time.perf_counter()
    while server.queue or any(server.slots):
        idle = ([s for s in range(max_batch) if server.slots[s] is None]
                if not server.queue else [])
        before = server._stats["prefills"]
        s0 = time.perf_counter()
        server.step()                  # ends in the greedy tokens' host sync
        dt = time.perf_counter() - s0
        if server._stats["prefills"] == before:
            decode_s.append(dt)
        if idle:
            pos = server.pos.tolist()  # after the step: the positions + 1
            past_end = max([past_end] + [pos[s] - 1 for s in idle])
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = read_counts(counters)
    routes = dict(fa_kernel.route_launches)
    peak = torch.cuda.max_memory_allocated()
    stats = dict(server._stats)
    steps = stats["steps"]
    new_tokens = sum(len(r.output) for r in reqs)
    numbers = {"steps": steps, "run_s": run_s,
               "tokens_per_s": new_tokens / run_s,
               "decode_ms_per_step": statistics.median(decode_s) * 1e3,
               "empty_slot_max_pos": past_end, "peak_gib": peak / 2**30}
    print(f"  stats {stats}; {new_tokens} tokens in {run_s:.3f} s "
          f"({numbers['tokens_per_s']:.1f} tokens/s); decode step (no "
          f"admission) median {numbers['decode_ms_per_step']:.3f} ms over "
          f"{len(decode_s)} steps; an empty slot decoded at position "
          f"{past_end} at most (max_len - 1 = {max_len - 1}); "
          f"max_memory_allocated {peak / 2**30:.2f} GiB; launches {launches}")
    check(stats == {"steps": steps, "prefills": len(reqs),
                    "completed": len(reqs)}, f"server stats {stats}")
    check(all(r.done and len(r.output) == n for r, (_, n) in zip(reqs, requests)),
          "a request did not complete with its length")
    want_routes = dict.fromkeys(fa_kernel.ROUTES, 0)
    for plen, _ in requests:
        want_routes[fa_kernel.route(cfg.param_dtype, cfg.param_dtype,
                                    cfg.resolved_head_dim, plen)] += n_attn
    want_routes["split_k"] += n_attn * steps
    check_routes(routes, want_routes, f"the {cfg.name} server")
    check(launches == {**NO_LAUNCHES, "flash_attention": sum(routes.values()),
                       "ssm_scan": n_mamba * (len(reqs) + steps)},
          f"launches on the {cfg.name} server: {launches}")

    # each request alone, teacher-forced on the server's tokens
    exact = near = total = 0
    worst = 0.0
    with torch.no_grad():
        for r in reqs:
            plen = int(r.prompt.shape[0])
            cache = model.cache_init(1, max_len, device=dev)
            logits, cache, _ = model.apply(params, {"tokens": r.prompt[None]},
                                           mode="prefill", cache=cache)
            rows = [logits[0, -1]]
            for i, tok in enumerate(r.output[:-1]):
                logits, cache, _ = model.apply(
                    params, {"tokens": torch.tensor([[tok]], device=dev)},
                    mode="decode", cache=cache, cache_pos=plen + i)
                rows.append(logits[0, 0])
            L = torch.stack(rows)
            out = torch.tensor(r.output, device=dev)
            same = L.argmax(-1) == out
            gap = ((L.amax(-1) - L.gather(1, out[:, None])[:, 0])
                   / L.abs().amax(-1))
            bad = ~same & (gap > NEAR_TIE)
            check(not bool(bad.any()), f"request {r.uid}: server tokens at "
                  f"{bad.nonzero()[:, 0].tolist()} are no near-tie of the "
                  f"replay's (gaps {gap[bad].tolist()})")
            exact += int(same.sum())
            near += int((~same).sum())
            total += len(r.output)
            worst = max(worst, gap.max().item())
            del cache
    print(f"  replayed alone: {exact} of {total} server tokens the replay's "
          f"argmax, {near} near-ties (largest gap {worst:.3e} of the largest "
          f"logit, tol 2^-6)")
    numbers.update(replay_exact=exact, replay_near_ties=near)
    del params, server
    torch.cuda.empty_cache()
    return launches, routes, numbers


def llava_train_phase(torch, counters, mem_rate, bf16_rate):
    """Phase 32a: the flash backward at LLaVA-NeXT's train shape against
    its plain version, timed beside SDPA's backward; 32: LLaVA-NeXT-
    Mistral-7B trained at full width, cut to 8 layers, on 4 x (2880 seeded
    image rows + 32 tokens) through ``train_phase`` (16 flash forwards, the
    groups' checkpointing running each layer's twice, and 8 backwards a
    step, all on the tensor cores); the plain comparison on the 32 tokens
    and 1440 of the image rows."""
    from repro_torch import random
    from repro_torch.configs import get_arch
    bwd = flash_bwd_phase(
        torch, mem_rate, bf16_rate, "32a. flash_attention backward at "
        "LLaVA-NeXT's train shape", [LLAVA_TRAIN + (BF16,)],
        (("llava train", LLAVA_TRAIN),), seed=32)
    cfg = dataclasses.replace(get_arch("llava-next-mistral-7b"), num_layers=8)
    key = random.PRNGKey(2, torch.device("cuda"))
    S = 32
    launches, numbers = train_phase(
        torch, counters, "32. training LLaVA-NeXT-Mistral-7B at full width, 8 "
        "layers", cfg, LLAVA8_TREE,
        {**NO_LAUNCHES, "flash_attention": 2 * cfg.num_layers,
         "flash_attention_bwd": cfg.num_layers},
        {"tokens": S, "labels": S, "image_embeds": 1440}, S=S,
        extra=lambda B: model_extras(cfg, B, key, "cuda"))
    return bwd, launches, numbers


def new_paths_phases(torch, counters, rates, smi, t_start, only=None):
    """Phases 28-32 (those named in ``only``, or all), each followed by its
    seconds, the script's so far and the card's name and power limit
    (``smi``).  ``rates``: the card's memory, float32, bf16 and exp rates.
    Returns each phase's result by number."""
    from repro_torch.configs import get_arch
    mem_rate, f32_rate, bf16_rate, exp_rate = rates
    jamba8 = dataclasses.replace(get_arch("jamba-v0.1-52b"), moe=None,
                                 num_layers=8)

    def server(title, cfg, spec, kernel_check):
        return kernel_check(), server_phase(torch, counters, title, cfg, *spec)

    phases = {
        "28": lambda: xlstm_serve_phase(torch, counters),
        "29": lambda: xlstm_train_phase(torch, counters),
        "30": lambda: server(
            "30. the continuous-batching server, OLMo-1B at full width and "
            "depth", get_arch("olmo-1b"), SERVER_OLMO,
            lambda: flash_phase(
                torch, mem_rate, bf16_rate, "30a. flash_attention at the "
                "server's shapes", FA_SERVER_SHAPES, FA_SERVER_TIMED,
                seed=30)[0]),
        "31": lambda: server(
            "31. the continuous-batching server, Jamba without experts at "
            "full width, 8 layers", jamba8, SERVER_JAMBA,
            lambda: ssm_phase(
                torch, mem_rate, f32_rate, exp_rate, "31a. ssm_scan at the "
                "server's shapes", SSM_SERVER_SHAPES, SSM_SERVER_TIMED,
                seed=31)[0]),
        "32": lambda: llava_train_phase(torch, counters, mem_rate, bf16_rate)}
    return run_numbered(phases, smi, t_start, only)


def run_numbered(phases, smi, t_start, only):
    """Run ``phases`` (by number) in order, those in ``only`` or all, each
    followed by its seconds, the script's so far and ``smi``."""
    out = {}
    for name, run in phases.items():
        if only is not None and name not in only:
            continue
        t0 = time.perf_counter()
        out[name] = run()
        print(f"  phase {name} took {time.perf_counter() - t0:.1f} s; the "
              f"script so far {time.perf_counter() - t_start:.1f} s ({smi})")
    return out


# Phase 33: the mesh schedules.  FedBWO on the paper CNN at FLConfig()'s
# defaults, one gloo rank per client on the one card, against the
# sequential engine (the same client update in one process, the same keys)
# under cudnn.deterministic, and against the batched engine (phase 4b's
# limit); one FedAvg round against the sequential and the batched FedAvg
# (the reference's FedAvg tolerance: a mean of ten clients' models).
MESH_ROUNDS = 3
MESH_RTOL = 1e-5             # scores and winner params against sequential
MESH_AVG_TOL = dict(rtol=1e-4, atol=1e-5)
MESH_TIMEOUT = 600           # seconds: the ranks' collectives and the run


def mesh_rank(rank, start, shards, keys, n):
    """One rank of phase 33 (``run_ranks``): this client's shard and keys
    (CPU tensors; ``keys`` is (clients, rounds, 2)) moved to cuda:0, ``MESH_ROUNDS`` FedBWO rounds through
    ``make_fedx_round`` with the kernel, then one FedAvg round from
    ``start``.  Returns per round the time, the collectives' seconds and
    bytes, the scores and a digest of the new model (the whole model on
    rank 0); the launches, the peak memory and the start-up's end."""
    import hashlib
    import torch
    from repro_torch import tree
    from repro_torch.core import FLConfig
    from repro_torch.core.distributed import (make_fedavg_round,
                                              make_fedx_round)
    from repro_torch.data.synthetic import cnn_task
    from repro_torch.kernels.bwo_evolve import bwo_evolve as bwo_kernel
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.metaheuristics import bwo
    torch.cuda.set_device(0)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    dev = torch.device("cuda", 0)
    mesh = make_host_mesh(n, device_type="cuda")
    task, hp = cnn_task(), FLConfig().client_hp()
    params = tree.map(lambda a: a.to(dev), start)
    shard = tree.map(lambda a: a.to(dev), shards[rank])
    keys = keys[rank].to(dev)
    fedx = make_fedx_round(task, hp, bwo(use_kernel=True), mesh)
    torch.distributed.barrier()
    ready = time.time()
    torch.cuda.reset_peak_memory_stats()
    bwo_kernel.launches = 0
    rounds = []
    for r in range(MESH_ROUNDS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, scores = fedx(params, shard, keys[r:r + 1])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        flat = torch.cat([l.reshape(-1) for l in tree.leaves(params)]).cpu()
        rounds.append({
            "s": secs, "seconds": dict(fedx.seconds),
            "traffic": dict(fedx.traffic), "scores": scores.cpu(),
            "digest": hashlib.sha256(flat.numpy().tobytes()).hexdigest(),
            "params": tree.map(lambda a: a.cpu(), params) if rank == 0
            else None})
    launches = bwo_kernel.launches
    peak = torch.cuda.max_memory_allocated()
    avg = make_fedavg_round(task, hp, mesh)
    new, scores = avg(tree.map(lambda a: a.to(dev), start), shard,
                      keys[0:1])
    fedavg = {"traffic": dict(avg.traffic), "seconds": dict(avg.seconds),
              "scores": scores.cpu(),
              "params": tree.map(lambda a: a.cpu(), new) if rank == 0
              else None}
    return {"ready": ready, "rounds": rounds, "launches": launches,
            "peak": peak, "fedavg": fedavg}


def _rel_tree(got, want):
    """The largest difference of two trees over the largest entry of
    ``want``, and whether they are equal bit for bit."""
    import torch
    from repro_torch import tree
    diff = max(float((g.float() - w.float()).abs().max())
               for g, w in zip(tree.leaves(got), tree.leaves(want)))
    top = max(float(w.float().abs().max()) for w in tree.leaves(want))
    same = all(torch.equal(g, w) for g, w in zip(tree.leaves(got),
                                                  tree.leaves(want)))
    return diff / top, same


def mesh_phase(torch):
    """Phase 33: ``make_fedx_round`` on ``make_host_mesh(10)``, one gloo
    rank per client on cuda:0 (``run_ranks``), 3 FedBWO rounds of the
    paper CNN at FLConfig()'s defaults with ``bwo(use_kernel=True)``, the
    keys of the server's schedule; round by round against the sequential
    engine from the same start under cudnn.deterministic (the same winner,
    scores within MESH_RTOL, the new model the sequential winner's) and the
    batched engine (the same winner, scores within ENGINE_RTOL); 90
    bwo_evolve launches across the ranks; the collectives' bytes (a
    round's all-gather and broadcast equal CommMeter's uplink); one FedAvg
    round against the sequential and the batched FedAvg (MESH_AVG_TOL; its
    scores within ENGINE_RTOL of the batched engine's).
    Prints the round time (the slowest rank), the collectives' times, the
    start-up and each rank's peak memory.  Returns the numbers."""
    from repro_torch import random, tree
    from repro_torch.core import FLConfig, build_experiment
    from repro_torch.core.comm import fedavg_round_bytes
    from repro_torch.kernels.bwo_evolve import bwo_evolve as bwo_kernel
    from repro_torch.launch.mesh import run_ranks
    print("== 33. the mesh schedules: FedBWO on the paper CNN at full width, "
          "one gloo rank per client on one card, bwo_evolve in every rank")
    cfg = FLConfig(strategy="fedbwo", task="cnn", bwo_kernel=True,
                   device="cuda", max_rounds=MESH_ROUNDS, tau=1.01)
    n = cfg.n_clients
    seq = build_experiment(dataclasses.replace(cfg, engine="sequential"))
    bat = build_experiment(dataclasses.replace(cfg, engine="batched"))
    start = seq.server.global_params
    rng, keys = seq.server.rng, []
    for _ in range(MESH_ROUNDS):              # Server.run_round's schedule
        split = random.split(rng, n + 2)
        rng = split[0]
        keys.append(split[2:])
    keys = torch.stack(keys, 1)               # (clients, rounds, 2)
    cpu = tree.map(lambda a: a.cpu(), start)
    shards = [tree.map(lambda a: a[None].cpu(), d)
              for d in seq.server.client_data]
    bwo_kernel.build()                        # once, before the ranks
    torch.cuda.synchronize()
    t0 = time.time()
    outs = run_ranks(n, mesh_rank, cpu, shards, keys.cpu(), n,
                     timeout=MESH_TIMEOUT)
    wall = time.time() - t0
    startup = max(o["ready"] for o in outs) - t0

    cudnn = torch.backends.cudnn
    saved = cudnn.deterministic, cudnn.benchmark
    cudnn.deterministic, cudnn.benchmark = True, False
    m_bytes = seq.server.meter.model_bytes
    try:
        params = start
        for r in range(MESH_ROUNDS):
            got = [o["rounds"][r] for o in outs]
            scores = got[0]["scores"]
            winner = int(torch.argmin(scores))
            check(all(torch.equal(g["scores"], scores) for g in got)
                  and len({g["digest"] for g in got}) == 1,
                  f"round {r}: the ranks ended with other scores or models")
            infos = {}
            for name, exp in (("sequential", seq), ("batched", bat)):
                exp.server.global_params = params
                infos[name] = exp.server.run_round()
            si, bi = infos["sequential"], infos["batched"]
            s_diff = max(abs(a - b) / abs(b) for a, b in
                         zip(scores.tolist(), si["scores"]))
            b_diff = max(abs(a - b) / abs(b) for a, b in
                         zip(scores.tolist(), bi["scores"]))
            mesh_params = tree.map(lambda a: a.cuda(), got[0]["params"])
            p_diff, same = _rel_tree(mesh_params, seq.server.global_params)
            traffic = got[0]["traffic"]
            uplink = seq.server.meter.uplink[-1]
            times = [g["s"] for g in got]
            ag = [g["seconds"]["all_gather"] for g in got]
            bc = [g["seconds"]["broadcast"] for g in got]
            print(f"  round {r}: round_time_s (slowest rank) {max(times):.3f} "
                  f"(fastest {min(times):.3f}); all_gather s "
                  f"{min(ag):.6f}-{max(ag):.6f}, broadcast s "
                  f"{min(bc):.6f}-{max(bc):.6f}; winner {winner} vs "
                  f"sequential {si['best_client']}, batched "
                  f"{bi['best_client']}; max relative score diff "
                  f"{s_diff:.3e} (tol {MESH_RTOL}) / {b_diff:.3e} (tol "
                  f"{ENGINE_RTOL}); model against the sequential winner's "
                  f"{p_diff:.3e} of its largest entry, bit for bit {same}; "
                  f"bytes {traffic} = {sum(traffic.values()):,} (CommMeter "
                  f"{uplink:,})")
            check(winner == si["best_client"] == bi["best_client"],
                  f"round {r}: winners differ")
            check(s_diff <= MESH_RTOL and p_diff <= MESH_RTOL,
                  f"round {r}: the mesh's scores or model differ from the "
                  f"sequential engine's beyond {MESH_RTOL}")
            check(b_diff <= ENGINE_RTOL, f"round {r}: the mesh's scores "
                  f"differ from the batched engine's beyond {ENGINE_RTOL}")
            check(traffic == {"all_gather": 4 * n, "broadcast": m_bytes}
                  and sum(traffic.values()) == uplink,
                  f"round {r}: the collectives moved {traffic}, the "
                  f"meter counts {uplink}")
            params = mesh_params
        launches = sum(o["launches"] for o in outs)
        check(launches == n * MESH_ROUNDS * cfg.mh_generations,
              f"bwo_evolve launched {launches} times across the ranks, "
              f"expected {n * MESH_ROUNDS * cfg.mh_generations}")

        # FedAvg, one round from the common start
        avg = [o["fedavg"] for o in outs]
        fa_traffic = avg[0]["traffic"]
        check(fa_traffic["all_reduce"] == fedavg_round_bytes(1.0, n, m_bytes)
              and fa_traffic["all_gather"] == 4 * n,
              f"FedAvg's collectives moved {fa_traffic}")
        mesh_avg = tree.map(lambda a: a.cuda(), avg[0]["params"])
        diffs = {}
        for engine in ("sequential", "batched"):
            exp = build_experiment(dataclasses.replace(
                cfg, strategy="fedavg", engine=engine))
            exp.server.global_params = start
            info = exp.server.run_round()
            want = exp.server.global_params
            close = all(torch.allclose(g, w, **MESH_AVG_TOL) for g, w in
                        zip(tree.leaves(mesh_avg), tree.leaves(want)))
            order = sorted(range(n), key=info["participants"].__getitem__)
            sc = [info["scores"][i] for i in order]
            diffs[engine] = (_rel_tree(mesh_avg, want)[0], close, max(
                abs(a - b) / abs(b) for a, b in
                zip(avg[0]["scores"].tolist(), sc)))
        print(f"  FedAvg: bytes {fa_traffic}, all_reduce s "
              f"{min(a['seconds']['all_reduce'] for a in avg):.6f}-"
              f"{max(a['seconds']['all_reduce'] for a in avg):.6f}; model "
              f"against the sequential FedAvg {diffs['sequential'][0]:.3e} "
              f"of its largest entry (within {MESH_AVG_TOL}: "
              f"{diffs['sequential'][1]}), against the batched "
              f"{diffs['batched'][0]:.3e} (within {MESH_AVG_TOL}: "
              f"{diffs['batched'][1]}); scores {diffs['sequential'][2]:.3e}"
              f" / {diffs['batched'][2]:.3e}")
        check(diffs["sequential"][1] and diffs["batched"][1],
              f"the mesh's FedAvg differs from the sequential or the "
              f"batched engine's beyond {MESH_AVG_TOL}")
        check(diffs["batched"][2] <= ENGINE_RTOL, f"the mesh's FedAvg "
              f"scores differ from the batched engine's beyond {ENGINE_RTOL}")
    finally:
        cudnn.deterministic, cudnn.benchmark = saved
    peaks = [o["peak"] / 2**30 for o in outs]
    round_s = [max(o["rounds"][r]["s"] for o in outs)
               for r in range(MESH_ROUNDS)]
    print(f"  {n} ranks: start-up {startup:.2f} s (spawn to every rank's "
          f"mesh and data on the card), the run {wall:.2f} s; bwo_evolve "
          f"{launches} launches across the ranks; peak memory by rank "
          f"{[round(p, 3) for p in peaks]} GiB")
    torch.cuda.empty_cache()
    return {"launches": launches, "round_time_s": round_s,
            "startup_s": startup,
            "all_gather_s": [min(o["rounds"][r]["seconds"]["all_gather"]
                                 for o in outs) for r in range(MESH_ROUNDS)],
            "broadcast_s": [max(o["rounds"][r]["seconds"]["broadcast"]
                                for o in outs) for r in range(MESH_ROUNDS)],
            "peak_gib": peaks}


# Phase 34: flcheck on the card.  The strict audit of the full-width main
# path, whose 5-round block replays one CUDA graph with 3 bwo_evolve
# launches a round; FedAvg at C = 0.6; two planted faults at a narrow width.
# The rounds after the audit are two pipelined blocks: the engine's own
# capture and two replays of it.
AUDIT_BLOCK = 5
AUDIT_ROUNDS = 2 * AUDIT_BLOCK


# Phase 35: the dry run at full width (host-only subprocesses) and the cost
# model against the card.  Each combination: (tag, the dry run's flags).
DRYRUN_COMBOS = (
    ("olmo-1b train_4k pod16x16", ["--arch", "olmo-1b", "--shape",
                                   "train_4k"]),
    ("olmo-1b train_4k pod2x16x16", ["--arch", "olmo-1b", "--shape",
                                     "train_4k", "--multi-pod"]),
    ("deepseek-v2-236b decode_32k pod16x16",
     ["--arch", "deepseek-v2-236b", "--shape", "decode_32k"]),
    ("xlstm-1.3b decode_32k pod16x16",
     ["--arch", "xlstm-1.3b", "--shape", "decode_32k"]),
    ("olmo-1b fedx round pod2x16x16", ["--arch", "olmo-1b", "--fedx"]))
DRYRUN_LOCAL_STEPS = 8           # the FedX round's, the dry run's default
DRYRUN_TIMEOUT = 600             # seconds, all five together


def _dryrun_file(flags):
    arch = flags[flags.index("--arch") + 1]
    if "--fedx" in flags:
        return f"{arch}__fedx_round__pod2x16x16.json"
    shape = flags[flags.index("--shape") + 1]
    return (f"{arch}__{shape}__"
            f"{'pod2x16x16' if '--multi-pod' in flags else 'pod16x16'}.json")


def start_dryruns(out_dir):
    """Start every ``DRYRUN_COMBOS`` dry run, each in its own process."""
    import os
    out_dir.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = {}
    for tag, flags in DRYRUN_COMBOS:
        log = open(out_dir / (_dryrun_file(flags) + ".log"), "w")
        procs[tag] = (subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", *flags,
             "--force", "--out", str(out_dir)], cwd=ROOT, env=env,
            stdout=log, stderr=subprocess.STDOUT), log, time.perf_counter())
    return procs


def finish_dryruns(procs, out_dir):
    """Wait for the dry runs (the caller kills any left at the time limit)
    and read their JSON, by tag."""
    deadline = time.perf_counter() + DRYRUN_TIMEOUT
    results, failed = {}, []
    for tag, flags in DRYRUN_COMBOS:
        proc, log, t0 = procs[tag]
        try:
            rc = proc.wait(timeout=max(1.0, deadline - time.perf_counter()))
        except subprocess.TimeoutExpired:
            rc = "timed out"
        wall = time.perf_counter() - t0
        log.close()
        path = out_dir / _dryrun_file(flags)
        if rc != 0 or not path.exists():
            tail = (out_dir / (path.name + ".log")).read_text()[-1500:]
            failed.append(f"{tag}: exit {rc}\n{tail}")
            continue
        results[tag] = json.loads(path.read_text())
        results[tag]["process_s"] = wall
    check(not failed, "dry runs failed: " + "\n".join(failed))
    return results


def recorded_train_step(torch, counters, after_timing):
    """Phase 35 (b): phase 19's OLMo-1B train step (4 x 1024, one card)
    timed, ``after_timing()`` called, then one step recorded and counted
    by the cost model.  Returns the recorded step's launches and the
    step's numbers."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch import random
    from repro_torch.analysis.walker import record_ops
    from repro_torch.configs import get_arch
    from repro_torch.data import make_token_dataset
    from repro_torch.launch.analysis import roofline
    from repro_torch.launch.graph_analysis import analyze
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.transformer import build_model
    from repro_torch import optim
    _, cfg, _, want_launches, _ = train_cells()["19"]
    B, S, steps = 4, 1024, 5
    dev = torch.device("cuda")
    torch.cuda.empty_cache()
    model = build_model(cfg, max_seq=S)
    opt = optim.adamw(optim.warmup_cosine(3e-4, 10, 20))
    train_step, init_state = make_train_step(model, opt)
    state = init_state(random.PRNGKey(0, dev))
    data = make_token_dataset(random.PRNGKey(1, dev), n_seqs=B * steps,
                              seq_len=S, vocab=cfg.vocab_size)
    batches = [{k: v[i * B:(i + 1) * B] for k, v in data.items()}
               for i in range(steps)]
    step_ms = []
    for i, batch in enumerate(batches[:-1]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = train_step(state, batch)
        torch.cuda.synchronize()
        if i:                                   # the first warms up
            step_ms.append((time.perf_counter() - t0) * 1e3)
    after_timing()
    counter = FlopCounterMode(display=False)
    reset_counts(counters)
    t0 = time.perf_counter()
    with counter:
        rec, (state, metrics) = record_ops(train_step, state, batches[-1],
                                           detail=True)
    torch.cuda.synchronize()
    recorded_s = time.perf_counter() - t0
    launches = read_counts(counters)
    check(launches == want_launches, f"the recorded step launched "
          f"{launches}, expected {want_launches}")
    check(math.isfinite(metrics["loss"].item()), "the recorded step's loss "
          "is not finite")
    cost = analyze(rec, 1)
    rf = roofline(cost.dot_flops, cost.hbm_bytes, 0.0, 1)
    flop_counter = counter.get_total_flops()
    median = statistics.median(step_ms)
    print(f"  OLMo-1B train step, 4 x 1024 on one card: steps "
          f"{', '.join(f'{t:.1f}' for t in step_ms)} ms (median {median:.1f}); "
          f"the recorded step {recorded_s:.2f} s, {len(rec.calls):,} ops, "
          f"launches {launches}")
    print(f"  cost model: dot FLOPs {cost.dot_flops:.4e} (FlopCounterMode "
          f"{flop_counter:.4e}, ratio {cost.dot_flops / flop_counter:.4f}); "
          f"HBM bytes {cost.hbm_bytes:.4e}; kernels "
          f"{json.dumps(cost.kernels)}")
    print(f"  roofline: compute {rf['compute_s'] * 1e3:.2f} ms, memory "
          f"{rf['memory_s'] * 1e3:.2f} ms, dominant {rf['dominant']}, bound "
          f"{rf['bound_s'] * 1e3:.2f} ms against the median step "
          f"{median:.1f} ms: the step at {rf['bound_s'] * 1e3 / median:.1%} "
          f"of its bound")
    check(cost.dot_flops > 0 and abs(cost.dot_flops / flop_counter - 1) < 0.2,
          "the cost model's dot FLOPs stray from FlopCounterMode's count")
    del state, metrics, rec, batches, data
    torch.cuda.empty_cache()
    return launches, {"step_ms": step_ms, "recorded_s": recorded_s,
                      "dot_flops": cost.dot_flops,
                      "flop_counter": flop_counter,
                      "hbm_bytes": cost.hbm_bytes,
                      "bound_ms": rf["bound_s"] * 1e3,
                      "dominant": rf["dominant"],
                      "share_of_bound": rf["bound_s"] * 1e3 / median}


def dryrun_phase(torch, counters):
    """Phase 35: the step timed on the card first (no other process on the
    host), then the dry runs started and, while they run, the step
    recorded; then each dry run's figures.  Returns the recorded step's
    launches and the phase's numbers."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.analysis import model_flops
    print("== 35. the dry run at full width and the cost model against "
          "the card")
    out_dir = ROOT / "build" / "dryrun"
    t0 = time.perf_counter()
    procs = {}
    try:
        launches, step = recorded_train_step(
            torch, counters, lambda: procs.update(start_dryruns(out_dir)))
        results = finish_dryruns(procs, out_dir)
    finally:
        for proc, log, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    numbers = {"train_step": step}
    for tag, flags in DRYRUN_COMBOS:
        r = results[tag]
        arch = flags[flags.index("--arch") + 1]
        cfg = get_arch(arch)
        chips = 512 if ("--multi-pod" in flags or "--fedx" in flags) else 256
        if "--fedx" in flags:
            tokens, mode = 256 * 4096, "train"
        else:
            mode = r["mode"]
            tokens = r["global_batch"] * (r["seq_len"] if mode != "decode"
                                          else 1)
        predicted = model_flops(cfg.num_active_params(), tokens,
                                "train" if mode == "train" else "fwd") / chips
        c, rf = r["collectives"], r["roofline"]
        print(f"  {tag}: run {r['lower_s']} s in a process of "
              f"{r['process_s']:.1f} s; FLOPs/device "
              f"{r['cost']['flops_per_device']:.4e} (6·N·D or 2·N·D ÷ chips "
              f"{predicted:.4e}), HBM bytes/device "
              f"{r['cost']['hbm_bytes_per_device']:.4e}; collectives "
              f"{json.dumps({k: f'{v:.4e}' for k, v in c['by_kind'].items()})}"
              f", cross-pod {c['cross_pod_link_bytes']:.4e}; dominant "
              f"{rf['dominant']}, bound {rf['bound_s'] * 1e3:.3f} ms")
        check(r["cost"]["flops_per_device"] > 0, f"{tag}: no FLOPs")
        numbers[tag] = {"run_s": r["lower_s"], "process_s": r["process_s"],
                        "flops_per_device": r["cost"]["flops_per_device"],
                        "model_flops_per_device": predicted,
                        "hbm_bytes_per_device":
                            r["cost"]["hbm_bytes_per_device"],
                        "by_kind": c["by_kind"],
                        "cross_pod_link_bytes": c["cross_pod_link_bytes"],
                        "dominant": rf["dominant"],
                        "bound_ms": rf["bound_s"] * 1e3}
    ds = results["deepseek-v2-236b decode_32k pod16x16"]["collectives"]
    check(ds["by_kind"].get("all-gather", 0) > 0, "DeepSeek-V2's decode "
          "shows no all-gather of the expert buffer")
    fedx = results["olmo-1b fedx round pod2x16x16"]["collectives"]
    sync = results["olmo-1b train_4k pod2x16x16"]["collectives"]
    print(f"  FedX round cross-pod {fedx['cross_pod_link_bytes']:.4e} B per "
          f"chip against {DRYRUN_LOCAL_STEPS} synchronous steps' "
          f"{sync['cross_pod_link_bytes'] * DRYRUN_LOCAL_STEPS:.4e} "
          f"({sync['cross_pod_link_bytes']:.4e} a step)")
    check(0 < fedx["cross_pod_link_bytes"]
          < sync["cross_pod_link_bytes"] * DRYRUN_LOCAL_STEPS,
          "the FedX round does not send fewer bytes across pods than "
          "the synchronous steps")
    numbers["seconds"] = time.perf_counter() - t0
    return launches, numbers


def audit_counts(report):
    """The findings of ``report`` by (rule, severity)."""
    out = {}
    for f in report.findings:
        out[f"{f.rule}/{f.severity}"] = out.get(f"{f.rule}/{f.severity}", 0) + 1
    return out


def audit_details(report, rule, subject):
    """The details of ``rule``'s info finding on ``subject``."""
    found = [f for f in report.findings if f.rule == rule
             and f.subject == subject and f.severity == "info"]
    check(len(found) == 1 and found[0].details,
          f"no info finding of {rule} with details on {subject}")
    return found[0].details


def planted_random(kind):
    """``repro_torch.random`` with ``split`` made bad, for the engine's
    own calls only (the block's key schedule, once a round): a ``.item()``
    after it, or a round trip of the keys through float64."""
    from repro_torch import random
    names = {k: getattr(random, k) for k in dir(random)
             if not k.startswith("__")}

    def split(key, num=2):
        out = random.split(key, num)
        if kind == "item":
            out.sum().item()
            return out
        return out.double().long()
    names["split"] = split
    return types.SimpleNamespace(**names)


def audit_block(report, subject, smi):
    """Prints and returns the captured block's graph facts from ``report``."""
    sync = audit_details(report, "one-sync-per-block", subject)
    reuse = audit_details(report, "donation-honored", subject)
    facts = {"nodes": sync["kinds"], "memcpy": sync["memcpy"],
             "bwo_evolve_nodes": sync["kernels"].get("bwo_evolve_kernel", 0),
             "launches_by_replay": sync["launches"],
             "device_to_host": sync["memcpy"].get("DtoH", 0),
             "host_nodes": sync["kinds"].get("HOST", 0),
             "audit_seconds_by_part": sync["seconds"], **reuse}
    print(f"  {subject}'s graph: nodes {facts['nodes']}, memcpy by "
          f"direction {facts['memcpy']}, bwo_evolve kernel nodes "
          f"{facts['bwo_evolve_nodes']} (CapturedBlock.launches "
          f"{facts['launches_by_replay']}), device-to-host copies "
          f"{facts['device_to_host']}, host nodes {facts['host_nodes']}; "
          f"a replay under sync-debug 'error' raised nothing; static "
          f"inputs kept their addresses {reuse['ptrs_kept']}, allocated "
          f"{reuse['allocated_first']:,} B after the first replay and "
          f"{reuse['allocated_second']:,} B after the second; the block's "
          f"audit seconds by part {facts['audit_seconds_by_part']} ({smi})")
    check(facts["device_to_host"] == 0 and facts["host_nodes"] == 0,
          f"{subject}'s graph holds device-to-host nodes")
    check(reuse["ptrs_kept"]
          and reuse["allocated_second"] <= reuse["allocated_first"],
          f"{subject}'s graph does not reuse its buffers")
    return facts


def audit_phase(torch, smi):
    """Phase 34: ``build_experiment(cfg, audit="strict")`` of the FL main
    path at full width (FedBWO on the paper CNN with the kernel, 5-round
    pipelined blocks): the findings by rule and severity, the build's and
    the audit's seconds; the audited block's graph: 15 bwo_evolve kernel
    nodes, equal to ``CapturedBlock.launches``, no device-to-host copy and
    no host node, a clean sync-debug replay, no growth on the second
    replay; 10 rounds (two pipelined 5-round blocks, each build capturing
    its own graph once and replaying it twice) of the audited build
    against 10 of an unaudited one under cudnn.deterministic, bit for
    bit; the strict audit of FedAvg at
    C = 0.6; a ``.item()`` and a float64 round trip planted in the
    block's key schedule at a narrow width, which must give
    ``one-sync-per-block`` and ``no-host-callback-in-scan`` errors (the
    capture refuses the sync) and a ``no-f64`` error.  Returns the
    numbers."""
    from repro_torch import tree
    from repro_torch.analysis.audit import audit_experiment
    from repro_torch.core import FLConfig, build_experiment
    from repro_torch.core import engine as engine_mod
    from repro_torch.kernels.bwo_evolve import bwo_evolve as bwo_kernel
    print("== 34. flcheck: the strict audit of the FL main path at full "
          "width on the card, FedAvg, and two planted faults")
    cfg = FLConfig(strategy="fedbwo", task="cnn", bwo_kernel=True,
                   device="cuda", rounds_per_dispatch=AUDIT_BLOCK,
                   pipeline_blocks="on", max_rounds=AUDIT_ROUNDS, tau=1.01,
                   patience=AUDIT_ROUNDS)
    out = {}
    cudnn = torch.backends.cudnn
    saved = cudnn.deterministic
    cudnn.deterministic = True
    try:
        t0 = time.perf_counter()
        plain = build_experiment(cfg)
        out["build_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        audited = build_experiment(cfg, audit="strict")
        out["build_and_audit_s"] = time.perf_counter() - t0
        report = audited.audit_report
        out["findings"] = audit_counts(report)
        print(f"  fedbwo, full width: {report.counts()}; by rule and "
              f"severity {out['findings']}; build {out['build_s']:.2f} s, "
              f"build and strict audit {out['build_and_audit_s']:.2f} s "
              f"({smi})")
        check(report.ok, "the main path's strict audit has errors")
        block = audit_block(report, f"block[fedbwo x{AUDIT_BLOCK}]", smi)
        out["block"] = block
        check(block["bwo_evolve_nodes"] == AUDIT_BLOCK * 3
              == block["launches_by_replay"],
              f"{block['bwo_evolve_nodes']} bwo_evolve nodes in the block's "
              f"graph, {block['launches_by_replay']} launches a replay; "
              f"want {AUDIT_BLOCK * 3}")
        runs = {}
        for name, exp in (("audited", audited), ("unaudited", plain)):
            bwo_kernel.launches = 0
            t0 = time.perf_counter()
            logs = exp.run().logs
            torch.cuda.synchronize()
            out[f"{name}_run_s"] = time.perf_counter() - t0
            eng = exp.server._engine
            runs[name] = (logs, bwo_kernel.launches,
                          tree.leaves(exp.server.global_params),
                          list(eng.captures), eng.warmup_launches)
        (la, na, pa, ca, wa), (lu, nu, pu, cu, wu) = (runs["audited"],
                                                     runs["unaudited"])
        same = (len(la) == len(lu) == AUDIT_ROUNDS
                and all(a.info["scores"] == b.info["scores"]
                        and a.info["best_client"] == b.info["best_client"]
                        and a.test_loss == b.test_loss
                        for a, b in zip(la, lu))
                and all(torch.equal(a, b) for a, b in zip(pa, pu)))
        out["rounds_bit_for_bit"] = same
        out["launches"] = {"audited": na, "unaudited": nu,
                           "warm_up": {"audited": wa, "unaudited": wu}}
        out["engine_captures"] = {"audited": ca, "unaudited": cu}
        print(f"  {AUDIT_ROUNDS} rounds ({AUDIT_ROUNDS // AUDIT_BLOCK} "
              f"pipelined {AUDIT_BLOCK}-round blocks) of the audited build "
              f"against the unaudited one under cudnn.deterministic: "
              f"scores, winners, test loss and model bit for bit {same}; "
              f"bwo_evolve launches {na} and {nu} (of them the warm-up "
              f"round's {wa} and {wu}); the engine's captures {ca} and {cu}; "
              f"{out['audited_run_s']:.2f} s and {out['unaudited_run_s']:.2f} s "
              f"({smi})")
        check(len(ca) == len(cu) == 1 and ca == cu,
              f"want one capture of one block shape in each build, got "
              f"{ca} and {cu}")
        check(same and na == nu == AUDIT_ROUNDS * 3 + wa and wa == wu == 3,
              "an audited build's rounds differ from an unaudited build's")
    finally:
        cudnn.deterministic = saved

    t0 = time.perf_counter()
    fedavg = build_experiment(dataclasses.replace(
        cfg, strategy="fedavg", bwo_kernel=False, client_ratio=0.6),
        audit="strict")
    out["fedavg_build_and_audit_s"] = time.perf_counter() - t0
    out["fedavg_findings"] = audit_counts(fedavg.audit_report)
    print(f"  fedavg, C = 0.6, full width: {fedavg.audit_report.counts()}; "
          f"by rule and severity {out['fedavg_findings']}; build and strict "
          f"audit {out['fedavg_build_and_audit_s']:.2f} s ({smi})")
    out["fedavg_block"] = audit_block(fedavg.audit_report,
                                      f"block[fedavg x{AUDIT_BLOCK}]", smi)
    del fedavg, audited, plain

    narrow = FLConfig(strategy="fedbwo", task="mlp", bwo_kernel=True,
                      device="cuda", n_clients=3, n_train=90, n_test=30,
                      mh_pop=2, mh_generations=1, local_epochs=1,
                      rounds_per_dispatch=2)
    want = {"item": {"one-sync-per-block", "no-host-callback-in-scan"},
            "double": {"no-f64"}}
    saved_random = engine_mod.random
    for kind, rules in want.items():
        exp = build_experiment(narrow)
        engine_mod.random = planted_random(kind)
        try:
            report = audit_experiment(exp, lint=False)
        finally:
            engine_mod.random = saved_random
        torch.cuda.synchronize()
        errors = sorted({(f.rule, f.subject, f.message[:120])
                         for f in report.errors})
        out[f"planted_{kind}"] = sorted({f.rule for f in report.errors})
        print(f"  planted {kind!r} in the block's key schedule: "
              f"{len(report.errors)} error(s) {out[f'planted_{kind}']}")
        for e in errors:
            print(f"    {e}")
        check(rules <= set(out[f"planted_{kind}"]),
              f"the planted {kind!r} gave errors {out[f'planted_{kind}']}, "
              f"want {sorted(rules)}")
        if kind == "item":
            check(any(f.rule == "one-sync-per-block"
                      and "capture failed" in f.message
                      for f in report.errors),
                  "the card's capture did not refuse the planted sync")
    return out


def bwo_bound(torch, p1, p2, P, D, Dp, mem_rate, f32_rate):
    """bwo_evolve's least time on this card for one launch over P child
    rows: the distinct parent rows this draw reads, both bit planes and
    the children (plus the indices and gates), or its operations."""
    parents = torch.unique(torch.cat([p1, p2])).numel()
    nbytes = (parents * D * 4 + 2 * P * Dp * 4 + P * D * 4
              + 2 * P * 4 + P * 4)
    flops = FLOPS_PER_GENE * P * D
    bytes_ms, ops_ms = nbytes / mem_rate * 1e3, flops / f32_rate * 1e3
    return (parents, nbytes, flops, max(bytes_ms, ops_ms),
            "bytes" if bytes_ms >= ops_ms else "operations")


def threefry_phase(torch, mem_rate):
    """Phase 36: the threefry kernel at CNN FedBWO's two bulk draws under
    vmap over 10 clients' keys (a BWO bit plane and the seeding's normal
    noise), against the int64 route bit for bit (normal: the elements that
    differ counted), timed beside its bound and the int64 route; then its
    launches and counters in two eager FedBWO rounds at full width.
    Returns the kernels line's entry.  No single PyTorch call computes the
    draw."""
    from repro_torch import random
    from repro_torch.core import FLConfig, build_experiment
    from repro_torch.kernels.threefry import ops as tf_ops, ref as tf_ref
    from repro_torch.kernels.threefry import threefry as tf_kernel
    print("== 36. threefry: the FedBWO cells' draws, the kernel against the "
          "int64 route")
    C, P, Dp, D = 10, 6, 2_465_408, 2_465_322
    keys = random.split(random.PRNGKey(2024, "cuda"), C)
    draws = {"bit plane, 10 x (6, 2,465,408)": ("bits", P * Dp, {}),
             "seeding normal, 10 x (6, 2,465,322)":
                 ("normal", P * D, {"lo": random._NORMAL_LO, "hi": 1.0})}
    shapes = {}
    for label, (kind, n, kw) in draws.items():
        def kernel():
            return torch.func.vmap(
                lambda k: tf_ops.draw(k, 0, n, kind, **kw))(keys)

        def plain():
            return tf_ref.threefry_ref(keys, 0, n, kind, **kw)

        before = tf_kernel.launches
        got = kernel()
        torch.cuda.synchronize()
        check(tf_kernel.launches == before + 1,
              f"{label}: {tf_kernel.launches - before} launches, not 1")
        want = plain()
        differ = int((got != want).sum())
        err = float((got.float() - want.float()).abs().max())
        del got, want
        print(f"  {label}: {differ} of {C * n} differ from the int64 route "
              f"(largest {err:.3g})")
        check(differ == 0 or (kind == "normal" and err <= 1e-6),
              f"{label}: the kernel is not the int64 route")
        counters = C * n
        timed = timed_entry(torch, kernel, plain, None, counters * 4,
                            [(counters * THREEFRY_INT32_OPS, INT32_RATE)],
                            mem_rate)
        shapes[label] = {"counters": counters, "differ": differ,
                         "max_abs_err": err, **timed}
        torch.cuda.empty_cache()
    cfg = FLConfig(strategy="fedbwo", task="cnn", bwo_kernel=True,
                   device="cuda", max_rounds=2, tau=1.01)
    exp = build_experiment(cfg)
    torch.cuda.synchronize()
    tf_kernel.launches = tf_kernel.words = 0
    exp.run()
    torch.cuda.synchronize()
    launches = tf_kernel.launches // cfg.max_rounds
    words = tf_kernel.words // cfg.max_rounds
    print(f"  FedBWO, paper CNN, batched engine: {launches} launches and "
          f"{words} counters a round (eager rounds)")
    del exp
    torch.cuda.empty_cache()
    bits = shapes["bit plane, 10 x (6, 2,465,408)"]
    return {"launches": tf_kernel.launches, "launches_per_round": launches,
            "words_per_round": words,
            **{k: bits[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                    "library_ms")},
            "shapes": shapes}


def bwo_phase(torch, mem_rate, f32_rate):
    """Phase 3.  Returns bwo_evolve's entry of the kernels line, all but
    its launches: the top-level times are the main path's launch (the
    batched engine's, C x P rows); ``shapes`` also has one client's."""
    from repro_torch import random
    from repro_torch.convert import ravel_params
    from repro_torch.core.client import ClientHP, make_fitness_fn, make_local_sgd
    from repro_torch.core.engine import stack_clients
    from repro_torch.data import loader, synthetic
    from repro_torch.data.partition import partition_iid
    from repro_torch.kernels.bwo_evolve import bwo_evolve as bwo_kernel
    from repro_torch.kernels.bwo_evolve import ops as bwo_ops, ref as bwo_ref
    from repro_torch.metaheuristics.bwo import bwo
    print("== 3. bwo_evolve against its plain version on the card")
    dev = torch.device("cuda")
    vmap = torch.func.vmap
    C, P, D = 10, 6, 2_465_322      # the main path: 10 clients, pop 6, CNN
    max_err = 0.0
    for (p, d) in [(P, D), (16, 4097), (4, 100)]:
        for dtype, tol in [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)]:
            key = random.PRNGKey(p * 7 + d, dev)
            pop = random.normal(key, (p, d)).to(dtype)
            fit = random.uniform(random.split(key)[1], (p,))
            got = bwo_ops.bwo_evolve(pop, fit, key)
            want = bwo_ops.bwo_evolve_reference(pop, fit, key)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            ok = torch.allclose(got.float(), want.float(), rtol=tol, atol=tol)
            print(f"  P={p} D={d} {str(dtype)[6:]}: max_abs_err {err:.3e} "
                  f"(tol {tol}) {'ok' if ok else 'FAILED'}")
            check(ok and math.isfinite(err), f"bwo_evolve disagrees at "
                  f"P={p} D={d} {dtype}: max_abs_err {err}")
            max_err = max(max_err, err)

    # the batched engine's shape: one launch over C clients' P rows, under
    # torch.func.vmap as the round runs it, against the plain version
    # under the same vmap
    keys = random.split(random.PRNGKey(2025, dev), C)
    pops = torch.stack([random.normal(k, (P, D)) for k in keys])
    fits = torch.stack([random.uniform(random.split(k)[1], (P,)) for k in keys])
    before = bwo_kernel.launches
    got = vmap(bwo_ops.bwo_evolve)(pops, fits, keys)
    torch.cuda.synchronize()
    one_launch = bwo_kernel.launches == before + 1
    want = vmap(bwo_ops.bwo_evolve_reference)(pops, fits, keys)
    err = (got - want).abs().max().item()
    ok = one_launch and torch.allclose(got, want, rtol=1e-5, atol=1e-5)
    print(f"  vmapped over C={C} clients, P={P} D={D} float32: "
          f"{bwo_kernel.launches - before} launch, max_abs_err {err:.3e} "
          f"(tol 1e-05) {'ok' if ok else 'FAILED'}")
    check(ok and math.isfinite(err), "the vmapped bwo_evolve disagrees "
          "or took other than one launch")
    max_err = max(max_err, err)
    del got, want

    kw = dict(pm_gene=0.1, mut_scale=0.05)
    shapes = {}
    # one client's launch (the sequential engine's), timed without a flush
    # as in earlier runs (its 207 MB are four times L2)
    key = random.PRNGKey(2024, dev)
    pop = random.normal(key, (P, D))
    fit = random.uniform(random.split(key)[1], (P,))
    pop32, p1, p2, b1, b2, gate = bwo_ops.sample(pop, fit, key, pm=0.4,
                                                 procreate_frac=0.6)
    Dp = b1.shape[1]
    kernel_ms = time_ms(torch, lambda: bwo_kernel.bwo_evolve_cuda(
        pop32, p1, p2, b1, b2, gate, **kw))
    plain_ms = time_ms(torch, lambda: bwo_ref.bwo_evolve_ref(
        pop32, p1, p2, b1, b2, gate, **kw))
    parents, nbytes, flops, bound_ms, bound_by = bwo_bound(
        torch, p1, p2, P, D, Dp, mem_rate, f32_rate)
    print(f"  one client, P={P} D={D} Dp={Dp}: {parents} distinct parent "
          f"rows, {nbytes / 1e6:.1f} MB, {flops / 1e6:.1f} MFLOP")
    print(f"  kernel {kernel_ms:.4f} ms  plain {plain_ms:.4f} ms  "
          f"bound {bound_ms:.4f} ms ({bound_by})  "
          f"kernel at {bound_ms / kernel_ms:.1%} of bound")
    shapes["one client (sequential engine)"] = {
        "rows": P, "ms": kernel_ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}
    del pop32, b1, b2

    # all clients' launch (the batched engine's): the draws as vmap makes
    # them, the rows folded as the op's vmap rule folds them
    drawn = vmap(lambda p_, f_, k_: bwo_ops.sample(
        p_, f_, k_, pm=0.4, procreate_frac=0.6))(pops, fits, keys)
    offset = (torch.arange(C, dtype=torch.int32, device=dev) * P)[:, None]
    pop32 = drawn[0].reshape(C * P, D)
    p1, p2 = ((i + offset).reshape(C * P) for i in drawn[1:3])
    b1, b2 = (b.reshape(C * P, Dp) for b in drawn[3:5])
    gate = drawn[5].reshape(C * P, 1)
    del drawn
    parents, nbytes, flops, _, _ = bwo_bound(torch, p1, p2, C * P, D, Dp,
                                             mem_rate, f32_rate)
    print(f"  all clients, {C} x {P} = {C * P} rows of D={D}: {parents} "
          f"distinct parent rows, {nbytes / 1e6:.1f} MB, "
          f"{flops / 1e6:.1f} MFLOP")
    timed = timed_entry(
        torch, lambda: bwo_kernel.bwo_evolve_cuda(pop32, p1, p2, b1, b2,
                                                  gate, **kw),
        lambda: bwo_ref.bwo_evolve_ref(pop32, p1, p2, b1, b2, gate, **kw),
        None, nbytes, [(flops, f32_rate)], mem_rate)
    shapes["all clients (batched engine)"] = {"rows": C * P, **timed}
    del pop32, b1, b2, pops

    # one round's parts on each engine, at full width: local SGD (2
    # epochs of 10 batches of 10), the population's seeding, and one
    # kernel-route generation split into the two threefry bit draws, the
    # kernel and the children's fitness; one client (the sequential
    # engine's unit) and all ten under vmap (the batched engine's)
    task = synthetic.cnn_task()
    train, _ = synthetic.make_cifar_like(random.PRNGKey(42, dev), 1000, 10)
    data = stack_clients(loader.client_batches(
        partition_iid(random.PRNGKey(1, dev), train, C), 10))
    one = {k: v[0] for k, v in data.items()}
    params = task.init_params(random.PRNGKey(7, dev))
    sgd = make_local_sgd(task, ClientHP(local_epochs=2))
    flat, unravel = ravel_params(params)
    mh = bwo(use_kernel=True)

    def seed(k, x, d):
        return mh.init(k, x, P, make_fitness_fn(task, d, unravel, 2))

    def generation(k, state, d):
        return mh.step(k, state, make_fitness_fn(task, d, unravel, 2))

    def fitness(pop_, d):
        return make_fitness_fn(task, d, unravel, 2)(pop_)

    def bits(k):
        return random.bits(k, (P, Dp))

    flats = flat[None].expand(C, -1).contiguous()
    split = {}
    for label, run, args in (
            ("one client", lambda f, *a: f(*a), (key, flat, one)),
            (f"{C} clients under vmap", lambda f, *a: vmap(f)(*a),
             (keys, flats, data))):
        k_, x_, d_ = args
        t = {"local SGD": time_ms(torch, lambda: run(
            lambda k, d: sgd(params, d, k), k_, d_), reps=3, warmup=1)}
        with torch.no_grad():
            t["seeding"] = time_ms(torch, lambda: run(seed, k_, x_, d_),
                                   reps=3, warmup=1)
            state = run(seed, k_, x_, d_)
            t["generation"] = time_ms(
                torch, lambda: run(generation, k_, state, d_), reps=3,
                warmup=1)
            t["two bit draws"] = 2 * time_ms(torch, lambda: run(bits, k_),
                                             reps=3, warmup=1)
            t["fitness"] = time_ms(
                torch, lambda: run(fitness, state["pop"], d_), reps=3,
                warmup=1)
        del state
        t["kernel"] = (kernel_ms if label == "one client" else timed["ms"])
        total = t["local SGD"] + t["seeding"] + 3 * t["generation"]
        gen = t["generation"]
        print(f"  {label}: local SGD {t['local SGD']:.2f} ms, population "
              f"seeding {t['seeding']:.2f} ms, 3 generations "
              f"{3 * gen:.2f} ms; sum {total:.2f} ms")
        print(f"    one generation {gen:.2f} ms: two bit draws "
              f"{t['two bit draws']:.2f} ms ({t['two bit draws'] / gen:.1%}), "
              f"kernel {t['kernel']:.4f} ms ({t['kernel'] / gen:.2%}), "
              f"fitness {t['fitness']:.2f} ms ({t['fitness'] / gen:.1%})")
        split[label] = t
    print(f"  one key split (a threefry of ~175 small launches) "
          f"{time_ms(torch, lambda: random.split(key, 5)):.3f} ms")
    del data, train, flats
    torch.cuda.empty_cache()
    return {"max_abs_err": max_err,
            **{k: timed[k] for k in ("ms", "plain_ms", "bound_ms",
                                     "bound_by", "library_ms")},
            "shapes": shapes, "round_split_ms": split}


# Phase 3b holds one client step's gradient at full width against float64
# on the same inputs.  It recomputes each of these float32 ops of the step
# in float64 from the float32 step's own inputs, as issued under
# torch.func.vmap (a grouped convolution, a batched product) or per client:
# the op's own error, apart from any other op's.  Each must be within
# OP_RTOL of the largest entry of its float64 result, which TF32 (10 bits
# of mantissa) fails by 35x or more: 3.5e-4 to 1.0e-3 on an H100 80GB
# HBM3.  One op is held to a limit of its own: a grouped convolution's
# backward, where cuDNN 9.22 computes conv2a's weight gradient by its
# non-fused Winograd algorithm on 9x9 tiles, read at 1.17e-3 (1.48e-3
# with cudnn.deterministic; 2.34e-3 on random inputs of the same shape,
# tools/conv_wgrad_layouts.py); client by client cuDNN picks another
# algorithm (3e-7).  So do the conv weights' gradients under vmap.
# PERF.md, section 6.
GRAD_OPS = ("convolution", "convolution_backward", "mm", "bmm", "addmm")
OP_RTOL = 1e-5
GROUPED_BWD_RTOL = 5e-3


def _op_check_mode(torch):
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_map

    def up(a):
        return (a.double() if isinstance(a, torch.Tensor)
                and a.dtype == torch.float32 else a)

    class OpCheck(TorchDispatchMode):
        """Keeps, for each GRAD_OPS call on float32 tensors, its name,
        groups and error against the float64 op on the same inputs; and
        the ReLU signs and max-pool picks of every call, to count the
        decisions two runs took apart.  With ``replay`` (another run's
        picks, in call order) each ReLU and max pool takes that run's
        decisions instead of its own."""

        def __init__(self, replay=None):
            super().__init__()
            self.ops, self.picks = [], []
            self.replay = None if replay is None else iter(replay)

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            name = func.overloadpacket.__name__
            if self.replay is not None and name == "relu":
                # open where that run's was (its backward reads out > 0)
                out = torch.where(next(self.replay), args[0].abs(), 0.0)
            elif self.replay is not None and name == "max_pool2d_with_indices":
                idx = next(self.replay)
                out = (args[0].flatten(-2).gather(-1, idx.flatten(-2))
                       .view(idx.shape), idx)
            else:
                out = func(*args, **kwargs)
            if name == "relu":
                self.picks.append(out > 0)
            elif name == "max_pool2d_with_indices":
                self.picks.append(out[1])
            elif name in GRAD_OPS and args[0].dtype == torch.float32:
                want = func(*tree_map(up, args), **tree_map(up, kwargs))
                pairs = (zip(out, want) if isinstance(out, (tuple, list))
                         else [(out, want)])
                err = max(((o.double() - w).abs().max()
                           / w.abs().max().clamp_min(1e-30)).item()
                          for o, w in pairs if o is not None)
                groups = {"convolution": 8, "convolution_backward": 9}
                g = args[groups[name]] if name in groups else 1
                self.ops.append((name, g, err))
            return out
    return OpCheck


def grad_phase(torch, strict=True):
    """Phase 3b.  One local-SGD step's gradient of the paper CNN at full
    width, 10 clients (the first batch of each, its own dropout key):
    under ``torch.func.vmap`` as the batched engine takes it and client by
    client as the sequential one does, each in float32 against the same
    step in float64 on the same inputs.  Prints each parameter's error
    (relative to its float64 gradient's largest entry), each checked op's
    own error (GRAD_OPS), the ReLU and max-pool decisions that float32 and
    float64 took apart, and the step's device kernels by name.  With
    ``strict``, fails if an op or a parameter's gradient (against float64
    taking float32's decisions) is beyond OP_RTOL, or GROUPED_BWD_RTOL for
    a grouped convolution's backward and the conv weights under vmap.
    Returns the readings."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import random, tree
    from repro_torch.core.engine import stack_clients
    from repro_torch.data import loader, synthetic
    from repro_torch.data.partition import partition_iid
    print("== 3b. one client step's gradient at full width against float64")
    dev = torch.device("cuda")
    C = 10
    task = synthetic.cnn_task()
    train, _ = synthetic.make_cifar_like(random.PRNGKey(42, dev), 1000, 10)
    data = stack_clients(loader.client_batches(
        partition_iid(random.PRNGKey(1, dev), train, C), 10))
    batch = {k: v[:, 0] for k, v in data.items()}
    dkeys = random.split(random.PRNGKey(3, dev), C)
    params = task.init_params(random.PRNGKey(7, dev))

    def objective(p, b, k):
        return task.loss_fn(p, {**b, "rng": k})[0]

    grad = torch.func.grad(objective)
    OpCheck = _op_check_mode(torch)

    def step(dtype, how, replay=None):
        p = tree.map(lambda a: a.to(dtype), params)
        b = {"images": batch["images"].to(dtype), "labels": batch["labels"]}
        with OpCheck(replay) as rec:
            if how == "vmap":
                g = torch.func.vmap(grad, in_dims=(None, 0, 0))(p, b, dkeys)
            else:
                gs = [grad(p, {k: v[c] for k, v in b.items()}, dkeys[c])
                      for c in range(C)]
                g = tree.map(lambda *xs: torch.stack(xs), *gs)
        torch.cuda.synchronize()
        return g, rec

    def rel_err(g32, g64):
        return {f"{layer}.{k}": ((g32[layer][k].double() - g64[layer][k])
                                 .abs().max() / g64[layer][k].abs().max()
                                 .clamp_min(1e-30)).item()
                for layer in sorted(g32) for k in sorted(g32[layer])}

    def show(errs):
        return ", ".join(f"{k} {v:.2e}" for k, v in errs.items())

    out = {}
    for how, label in (("vmap", "batched (vmap)"),
                       ("loop", "sequential (client by client)")):
        g32, rec32 = step(torch.float32, how)
        g64, rec64 = step(torch.float64, how)
        same, _ = step(torch.float64, how, replay=rec32.picks)
        free, leaf = rel_err(g32, g64), rel_err(g32, same)
        ops = {}
        for name, g, err in rec32.ops:
            k = f"{name} (groups {g})" if g > 1 else name
            ops[k] = max(ops.get(k, 0.0), err)
        flips = sum(int((x != y).sum()) for x, y in zip(rec32.picks,
                                                        rec64.picks))
        picks = sum(x.numel() for x in rec32.picks)
        print(f"  {label}: ReLU and max-pool decisions float32 and float64 "
              f"took apart: {flips} of {picks}")
        print(f"    gradient, largest error / largest entry: {show(free)}")
        print(f"    the same, float64 taking float32's decisions: "
              f"{show(leaf)}")
        print(f"    each op against float64 on its own inputs: "
              f"{show(dict(sorted(ops.items())))}")
        out[how] = {"flips": flips, "leaf_rel_err_free": free,
                    "leaf_rel_err": leaf, "op_rel_err": ops}
        if strict:
            grouped = {k for k in ops if k.startswith(
                "convolution_backward (groups")}
            if how == "vmap":
                grouped |= {k for k in leaf if k.startswith("conv")
                            and k.endswith(".w")}
            bad = {k: v for k, v in {**ops, **leaf}.items() if not v <= (
                GROUPED_BWD_RTOL if k in grouped else OP_RTOL)}
            check(not bad, f"{label}: beyond {OP_RTOL} ({GROUPED_BWD_RTOL} "
                  f"for a grouped convolution's backward) of float64 on the "
                  f"same inputs and decisions: {bad}")
        del g32, g64, same, rec32, rec64

    vgrad = torch.func.vmap(grad, in_dims=(None, 0, 0))
    vgrad(params, batch, dkeys)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        vgrad(params, batch, dkeys)
        torch.cuda.synchronize()
    kernels = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            kernels[e.name] = kernels.get(e.name, 0.0) + e.device_time_total
    print(f"  the vmapped step's device kernels ({len(kernels)} by name; "
          f"us, the longest first):")
    for name, us in sorted(kernels.items(), key=lambda kv: -kv[1])[:25]:
        print(f"    {us:9.1f}  {name[:150]}")
    out["kernels_us"] = kernels
    return out


# the engines against each other on the card at full width, one round from
# a common start: the same winner, scores and test losses (near 2) within
# this relative tolerance.  Both compute in float32 (TF32 off) but sum in
# other orders (a vmapped convolution is a grouped one, which cuDNN runs by
# other algorithms), and either engine's run differs from itself between
# processes.  Twenty SGD steps turn the first ReLU or max-pool decision
# that falls the other way into a difference that grows: one client's
# local SGD in float32 against float64 on the same inputs, either engine,
# read 5e-2 of a bias and 5e-5 of the loss at the end, and one round's
# scores of the two engines read 1.8e-4 to 1.63e-3 apart, the same with
# the grouped weight gradient of phase 3b replaced by an exact one (an
# H100 80GB HBM3; PERF.md, section 6).  A client's scores differ by ~5e-2
# from one another.  Phase 3b holds each op to float64; at narrow width,
# where flips are rare, phase 6 and the tests hold the port to 1e-4.
ENGINE_RTOL = 1e-2


def lockstep(torch, counters, cfg, rounds, want_launches, title):
    """``cfg`` on both engines, round by round from a common start: each
    round, the sequential server starts from the global model the batched
    one started from (the key schedules are the same), so the comparison
    reads one round of each engine, not rounds of drift.  Per round: the
    same winner, scores and test losses within ENGINE_RTOL, and
    ``want_launches[engine]`` bwo_evolve launches.  Returns each engine's
    round times and the launches counted in each of its rounds."""
    from repro_torch.core import build_experiment
    print(f"== {title}")
    exps = {e: build_experiment(dataclasses.replace(cfg, engine=e))
            for e in ("batched", "sequential")}
    for e, exp in exps.items():
        check(exp.server.engine == e, f"engine={e} built {exp.server.engine}")
    times = {e: [] for e in exps}
    counted = {e: [] for e in exps}
    for r in range(rounds):
        start = exps["batched"].server.global_params
        got = {}
        for e, exp in exps.items():
            exp.server.global_params = start
            reset_counts(counters)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            info = exp.server.run_round()
            torch.cuda.synchronize()
            times[e].append(time.perf_counter() - t0)
            n = read_counts(counters)["bwo_evolve"]
            counted[e].append(n)
            check(n == want_launches[e], f"{e}: bwo_evolve launched {n} "
                  f"times in round {r}, expected {want_launches[e]}")
            got[e] = info, exp.server.evaluate(exp.eval_data)[0]
        (bi, bl), (si, sl) = got["batched"], got["sequential"]
        diff = max(abs(s - t) / abs(t) for s, t in zip(bi["scores"],
                                                       si["scores"]))
        loss = abs(bl - sl) / abs(sl)
        print(f"  round {r}: round_time_s batched {times['batched'][-1]:.3f} "
              f"sequential {times['sequential'][-1]:.3f}; winner "
              f"{bi['best_client']} vs {si['best_client']}, max relative "
              f"score diff {diff:.2e}, test loss {bl:.6f} vs {sl:.6f} "
              f"(tol {ENGINE_RTOL})")
        check(all(math.isfinite(s) for s in bi["scores"] + si["scores"]),
              f"non-finite scores in round {r}")
        check(bi["best_client"] == si["best_client"],
              f"{title}: different winners in round {r}")
        check(diff <= ENGINE_RTOL and loss <= ENGINE_RTOL,
              f"{title}: scores or test loss differ beyond {ENGINE_RTOL}")
    check(exps["batched"].meter.summary() == exps["sequential"].meter.summary(),
          "the engines' CommMeter ledgers differ")
    return times, counted


def fl_run(torch, counters, cfg, want_engine, want_launches, title):
    """One run through the user's entry points with every launch counter
    set to 0 just before and read just after; checks the engine, the
    bwo_evolve launches, finite results on the card and the uplink.
    Returns the result, the launches and the peak device memory."""
    from repro_torch import tree
    from repro_torch.core import build_experiment
    print(f"== {title}")
    exp = build_experiment(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(counters)
    t0 = time.perf_counter()
    result = exp.run(verbose=True)
    wall = time.perf_counter() - t0
    launches = read_counts(counters)
    peak = torch.cuda.max_memory_allocated()
    rounds = len(result.logs)
    for log in result.logs:
        print(f"  round {log.round}: round_time_s {log.round_time_s:.3f}  "
              f"test_acc {log.test_acc:.4f}  test_loss {log.test_loss:.4f}  "
              f"winner {log.info['best_client']}")
    engine = result.summary()["engine"]
    print(f"  engine {engine} (vectorize "
          f"{getattr(exp.server._engine, 'vectorize', '-')}); {rounds} rounds "
          f"in {wall:.2f} s; launches {launches}; max_memory_allocated "
          f"{peak / 2**30:.2f} GiB")
    check(engine == want_engine, f"ran engine {engine}, expected {want_engine}")
    check(rounds == cfg.max_rounds, f"ran {rounds} rounds")
    want = want_launches * rounds
    check(launches["bwo_evolve"] == want,
          f"bwo_evolve launched {launches['bwo_evolve']} times, expected {want}")
    check(all(n == 0 for k, n in launches.items() if k != "bwo_evolve"),
          f"the FL path ran attention or the scan: {launches}")
    for log in result.logs:
        check(all(math.isfinite(s) for s in log.info["scores"]),
              f"non-finite score in round {log.round}: {log.info['scores']}")
        check(math.isfinite(log.test_loss), "non-finite test loss")
    model_bytes = exp.meter.model_bytes
    check(model_bytes == 9_861_288, f"model_bytes {model_bytes}")
    uplink = exp.meter.total_uplink
    check(uplink == rounds * (cfg.n_clients * 4 + model_bytes),
          f"uplink {uplink} != {rounds} x (40 + {model_bytes})")
    check(all(t.is_cuda and bool(torch.isfinite(t).all())
              for t in tree.leaves(result.server.global_params)),
          "global params not finite on the card")
    print(f"  uplink {uplink} bytes = {rounds} x "
          f"{cfg.n_clients * 4 + model_bytes}")
    return result, launches["bwo_evolve"], peak


def busy_share(torch, fn):
    """The card's busy share while ``fn`` runs: the time covered by at
    least one kernel, copy or fill that ``torch.profiler`` reads (CUDA
    activity only, so no host op is traced; overlapping ones counted once)
    over the host's wall time, ending in a sync.  None where the profiler
    reads no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    busy, end = 0.0, -math.inf
    for a, b in spans:                      # the union of the spans, in us
        if b > end:
            busy += b - max(a, end)
            end = b
    busy /= 1e6
    return (busy / wall if busy > 0 else None), busy, wall


def exact_block(torch, cfg, R):
    """One fused block against R eager rounds from one start with cuDNN
    held to its deterministic algorithms (in both, for these runs only):
    the replay must equal the eager rounds bit for bit, scores, winners
    and model, which says that what parts them under the default
    algorithms is cuDNN's run-to-run sums, not the graph."""
    from repro_torch import tree
    from repro_torch.core import build_experiment
    cudnn = torch.backends.cudnn
    saved = cudnn.deterministic
    cudnn.deterministic = True
    try:
        fused = build_experiment(cfg).server
        twin = build_experiment(
            dataclasses.replace(cfg, rounds_per_dispatch=1)).server
        twin.global_params = tree.map(torch.clone, fused.global_params)
        twin.rng = fused.rng.clone()
        want = [twin.run_round() for _ in range(R)]
        got = fused.run_block(R)
        torch.cuda.synchronize()
    finally:
        cudnn.deterministic = saved
    same_rounds = all(g["best_client"] == w["best_client"]
                      and g["scores"] == w["scores"]
                      for g, w in zip(got, want))
    same_model = all(torch.equal(a, b) for a, b in zip(
        tree.leaves(fused.global_params), tree.leaves(twin.global_params)))
    print(f"  cudnn.deterministic: a replayed block against {R} eager "
          f"rounds from one start: scores and winners bit for bit "
          f"{same_rounds}, model bit for bit {same_model}")
    check(same_rounds and same_model, "under cudnn.deterministic the "
          "replayed block is not the eager rounds bit for bit")


def fused_phase(torch, counters, single_times=None):
    """Phase 4c: 10 full-width FedBWO rounds with rounds_per_dispatch="auto"
    (5 on the batched engine) through ``build_experiment(...).run()``, the
    pipelined driver: two blocks, each one replay of a CUDA graph captured
    at the first.  First 5 eager rounds of a twin from the same start,
    which the first block must match (the same winners; round 0's scores
    within ENGINE_RTOL, as the engines': a replay runs the kernels an eager
    round runs, but cuDNN's grouped weight gradient sums in an order that
    changes from run to run, and later rounds start from models it has
    parted); then, with the graph captured, the serial fused driver and the
    pipelined one again, the card's busy share in one eager round and one
    replayed block, and ``exact_block``.  Returns the launches on the fused
    path and the numbers for PERF.md."""
    from repro_torch import tree
    from repro_torch.core import FLConfig, build_experiment
    from repro_torch.core.comm import CommMeter
    from repro_torch.core.protocol import run_federated
    print("== 4c. fused rounds: FedBWO, paper CNN at full width, bwo_kernel, "
          "rounds_per_dispatch auto, 10 rounds (two pipelined blocks, each "
          "one CUDA graph replay)")
    cfg = FLConfig(strategy="fedbwo", task="cnn", bwo_kernel=True,
                   device="cuda", rounds_per_dispatch="auto", max_rounds=10,
                   tau=1.01)
    exp = build_experiment(cfg)
    server = exp.server
    R = server.rounds_per_dispatch
    check(server.engine == "batched" and R == 5 and server.pipeline_blocks,
          f"auto resolved to engine {server.engine}, rounds_per_dispatch "
          f"{R}, pipeline_blocks {server.pipeline_blocks}")
    twin = build_experiment(dataclasses.replace(cfg, rounds_per_dispatch=1))
    twin.server.global_params = tree.map(torch.clone, server.global_params)
    twin.server.rng = server.rng.clone()

    # the eager twin: R single rounds from the same start
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    eager, eager_times = [], []
    for _ in range(R):
        t0 = time.perf_counter()
        eager.append(twin.server.run_round())
        torch.cuda.synchronize()
        eager_times.append(time.perf_counter() - t0)
    eager_peak = torch.cuda.max_memory_allocated()

    # the main path of this phase: counts set to 0 just before, read after
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(counters)
    t0 = time.perf_counter()
    result = exp.run(verbose=True)
    wall = time.perf_counter() - t0
    launches = read_counts(counters)
    peak = torch.cuda.max_memory_allocated()
    reserved = torch.cuda.max_memory_reserved()
    engine = server._engine
    check(len(engine.graphs) == 1, f"{len(engine.graphs)} graphs captured")
    (graph,) = engine.graphs.values()
    per_round = cfg.mh_generations
    replayed = graph.replays * graph.launches
    print(f"  capture {graph.capture_s:.3f} s (first block's dispatch, "
          f"warm-up round and capture: "
          f"{server.meter.block_timings[0].dispatch_s:.3f} s); "
          f"{len(result.logs)} rounds in {wall:.2f} s; bwo_evolve "
          f"{launches['bwo_evolve']} launches: {replayed} by {graph.replays} "
          f"replays of a graph holding {graph.launches}, "
          f"{engine.warmup_launches} in the warm-up round")
    check(len(result.logs) == cfg.max_rounds, f"ran {len(result.logs)} rounds")
    check(all(log.info["engine"] == "fused" for log in result.logs),
          "a round ran outside the fused blocks")
    check(graph.replays == cfg.max_rounds // R and
          graph.launches == R * per_round and replayed == 30,
          f"replays {graph.replays} x {graph.launches} launches, "
          f"expected 2 x {R * per_round}")
    check(engine.warmup_launches == per_round,
          f"the warm-up round launched {engine.warmup_launches}")
    check(launches["bwo_evolve"] == replayed + engine.warmup_launches,
          f"bwo_evolve counted {launches['bwo_evolve']}, expected "
          f"{replayed} + {engine.warmup_launches}")
    check(all(n == 0 for k, n in launches.items() if k != "bwo_evolve"),
          f"the FL path ran attention or the scan: {launches}")
    uplink = exp.meter.total_uplink
    check(uplink == cfg.max_rounds * 9_861_328,
          f"uplink {uplink} != 10 x 9,861,328")
    for log in result.logs:
        check(math.isfinite(log.test_loss) and
              all(math.isfinite(s) for s in log.info["scores"]),
              f"non-finite loss or score in round {log.round}")
    check(all(t.is_cuda and bool(torch.isfinite(t).all())
              for t in tree.leaves(server.global_params)),
          "global params not finite on the card")
    print(f"  uplink {uplink} bytes = 10 x 9861328")

    diffs = []
    for r, (got, want) in enumerate(zip(result.logs[:R], eager)):
        diffs.append(max(abs(s - t) / abs(t) for s, t in zip(
            got.info["scores"], want["scores"])))
        print(f"  round {r}: winner {got.info['best_client']} (replay) vs "
              f"{want['best_client']} (eager), max relative score diff "
              f"{diffs[-1]:.3e}")
        check(got.info["best_client"] == want["best_client"],
              f"the first block and the eager rounds differ in winner, "
              f"round {r}")
    diff = max(diffs)
    # round 0 starts both from one model: the engines' one-round bound;
    # later rounds start from models that cuDNN's atomics have already
    # parted, and exact_block below shows the replay itself exact
    print(f"  largest relative score difference, first block against {R} "
          f"eager rounds from a common start: {diff:.3e}; round 0's "
          f"{diffs[0]:.3e} (tol {ENGINE_RTOL})")
    check(diffs[0] <= ENGINE_RTOL, f"round 0 differs by {diffs[0]:.3e}")
    amortized = [log.round_time_s for log in result.logs]
    print(f"  round_time_s amortized (pipelined, capture included) "
          f"{amortized[0]:.3f}; eager twin {eager_times}; phase 4 "
          f"single rounds {single_times}")
    print(f"  peak device memory: fused run {peak / 2**30:.2f} GiB "
          f"(reserved {reserved / 2**30:.2f}), eager twin "
          f"{eager_peak / 2**30:.2f} GiB")
    check(peak < 2 * eager_peak, "the block's peak is not near one round's")
    drivers = {"pipelined, capture included": server.meter.timing_summary()}
    warm_rounds = {}

    # the serial fused driver and the pipelined one again, graph captured
    for label, pipe in (("serial", False), ("pipelined", True)):
        server.pipeline_blocks = pipe
        n0 = len(server.meter.block_timings)
        logs = run_federated(server, exp.eval_data, exp.stop)
        check(len(logs) == cfg.max_rounds and all(
            math.isfinite(l.test_loss) for l in logs),
              f"the {label} driver's rounds")
        warm_rounds[label] = sorted({l.round_time_s for l in logs})
        drivers[label] = CommMeter(
            0, 0, block_timings=server.meter.block_timings[n0:]
        ).timing_summary()
    check(len(engine.graphs) == 1 and graph.replays == 3 * 2,
          "a block shape was captured twice")
    for label, summary in drivers.items():
        print(f"  timing_summary, {label}: {json.dumps(summary)}")
    print(f"  round_time_s amortized, graph captured: serial "
          f"{warm_rounds['serial']}, pipelined {warm_rounds['pipelined']}")

    eager_share = busy_share(torch, twin.server.run_round)
    block_share = busy_share(torch, lambda: server.run_block(
        R, exp.eval_data, eval_every=1))
    for label, (share, busy, secs) in (("one eager round", eager_share),
                                       ("one replayed block", block_share)):
        print(f"  device busy share, {label}: "
              + ("not measured (the profiler read no device time)"
                 if share is None else
                 f"{share:.3f} ({busy:.3f} s of device time in "
                 f"{secs:.3f} s)"))
    exact_block(torch, cfg, R)
    return {"launches": launches["bwo_evolve"], "replays": graph.replays,
            "capture_s": graph.capture_s, "round_time_s": amortized[0],
            "warm_round_time_s": warm_rounds,
            "eager_round_time_s": eager_times, "peak_gib": peak / 2**30,
            "max_rel_score_diff": diff,
            "sync_fraction": {k: v["sync_fraction"]
                              for k, v in drivers.items()},
            "busy_share": {"eager round": eager_share[0],
                           "replayed block": block_share[0]}}


def fl_phases(torch, counters):
    """Phases 4-6.  Returns bwo_evolve's launches on the main path, its
    launches counted in each round of phase 4b by engine, each engine's
    round times there, and phase 4c's numbers."""
    from repro_torch.configs.paper_cnn import CNNConfig
    from repro_torch.core import FLConfig, build_experiment
    from repro_torch.data.synthetic import cnn_task
    # tau above any accuracy, so the run takes all three rounds: on this
    # data the paper's tau = 0.70 stops it after round 2
    cfg = FLConfig(strategy="fedbwo", task="cnn", bwo_kernel=True,
                   device="cuda", max_rounds=3, tau=1.01)
    per_round = {"batched": cfg.mh_generations,
                 "sequential": cfg.n_clients * cfg.mh_generations}
    result, launches, peak = fl_run(
        torch, counters, cfg, "batched", per_round["batched"],
        "4. main path: FedBWO, paper CNN at full width, bwo_kernel "
        "(engine auto: batched, vmap)")
    times, per_round_counted = lockstep(
        torch, counters, cfg, cfg.max_rounds, per_round,
        "4b. the main path on both engines, round by round from a common "
        "start")
    print(f"  round_time_s batched {times['batched']} sequential "
          f"{times['sequential']}; peak device memory of the batched run "
          f"(phase 4) {peak / 2**30:.2f} GiB")
    fused = fused_phase(torch, counters,
                        [log.round_time_s for log in result.logs])

    none = {"batched": 0, "sequential": 0}
    lockstep(torch, counters, dataclasses.replace(cfg, bwo_kernel=False), 1,
             none, "5. one round of the default (composed) FedBWO on each "
             "engine")

    print("== 6. kernel route on the card (batched) against the port's CPU "
          "route (sequential)")
    narrow = CNNConfig(conv1_filters=4, conv2_filters=8, dense_hidden=16)
    small = dict(n_clients=3, n_train=90, n_test=30, mh_pop=3,
                 mh_generations=2, local_epochs=1, max_rounds=2,
                 bwo_kernel=True)
    on_card = build_experiment(FLConfig(device="cuda", **small),
                               task=cnn_task(narrow)).run()
    on_cpu = build_experiment(FLConfig(device="cpu", **small),
                              task=cnn_task(narrow)).run()
    check(on_card.summary()["engine"] == "batched"
          and on_cpu.summary()["engine"] == "sequential",
          "auto chose other engines than batched on the card and "
          "sequential for the CPU's conv task")
    for a, b in zip(on_card.logs, on_cpu.logs):
        diff = max(abs(x - y) for x, y in zip(a.info["scores"],
                                               b.info["scores"]))
        print(f"  round {a.round}: winner {a.info['best_client']} vs "
              f"{b.info['best_client']}, max score diff {diff:.2e}, "
              f"test loss {a.test_loss:.6f} vs {b.test_loss:.6f}")
        check(a.info["best_client"] == b.info["best_client"],
              "card and CPU routes chose different winners")
        check(diff <= 1e-4 and abs(a.test_loss - b.test_loss) <= 1e-4,
              "card and CPU routes disagree beyond 1e-4")

    ragged = dataclasses.replace(cfg, partition="dirichlet")
    check(build_experiment(ragged).server._engine.padded,
          "the Dirichlet split was not padded and masked")
    lockstep(torch, counters, ragged, 1, per_round,
             "6b. a Dirichlet (ragged: padded and masked) split at full "
             "width, one round on each engine")

    fl_run(torch, counters, FLConfig(strategy="fedgwo", device="cuda",
                                     max_rounds=1), "batched", 0,
           "6c. one FedGWO round, full width, batched engine")
    torch.cuda.empty_cache()
    return launches, per_round_counted, times, fused


def main() -> int:
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels.bwo_evolve import bwo_evolve as bwo_kernel
    from repro_torch.kernels.flash_attention import flash_attention as fa_kernel
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd as fa_bwd_kernel)
    from repro_torch.kernels.ssm_scan import ssm_scan as ssm_kernel
    from repro_torch.kernels.ssm_scan import ssm_scan_bwd as ssm_bwd_kernel
    from repro_torch.kernels.threefry import threefry as tf_kernel
    counters = (bwo_kernel, fa_kernel, ssm_kernel, fa_bwd_kernel,
                ssm_bwd_kernel)

    # ---------------------------------------------------- 1. environment --
    print("== 1. environment")
    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
          f"cuda {torch.version.cuda}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(smi)
    name = torch.cuda.get_device_name(0)
    mem_rate, f32_rate, bf16_rate, exp_rate = card_rates(name)
    check(bf16_rate is not None and exp_rate is not None,
          f"no bf16 tensor-core or exponential rate recorded for {name!r}: "
          f"the attention and scan bounds need them")
    print(f"device {name}  count {torch.cuda.device_count()}  "
          f"rates used for bounds: {mem_rate / 1e12} TB/s, "
          f"{f32_rate / 1e12} TFLOP/s fp32, {bf16_rate / 1e12} TFLOP/s bf16, "
          f"{exp_rate / 1e12:.3f} T exp/s")

    # ---------------------------------------------------------- 2. build --
    print("== 2. build")
    builds = {"bwo_evolve": bwo_kernel.build,
              "flash_attention, CUDA cores":
                  lambda: fa_kernel.build(fa_kernel.SOURCE),
              "flash_attention, tensor cores and split-K":
                  lambda: fa_kernel.build(fa_kernel.HOPPER_SOURCE),
              "flash_attention, 3xTF32":
                  lambda: fa_kernel.build(fa_kernel.TF32_SOURCE),
              "ssm_scan": ssm_kernel.build,
              "flash_attention backward, CUDA cores":
                  lambda: fa_bwd_kernel.build(fa_bwd_kernel.SOURCE),
              "flash_attention backward, tensor cores":
                  lambda: fa_bwd_kernel.build(fa_bwd_kernel.HOPPER_SOURCE),
              "flash_attention backward, 3xTF32":
                  lambda: fa_bwd_kernel.build(fa_bwd_kernel.TF32_SOURCE),
              "ssm_scan backward": ssm_bwd_kernel.build,
              "threefry": tf_kernel.build}

    def timed_build(fn):
        t = time.perf_counter()
        return fn(), time.perf_counter() - t

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(builds)) as pool:
        futures = {k: pool.submit(timed_build, fn) for k, fn in builds.items()}
        libs = {k: f.result() for k, f in futures.items()}
    for k, (lib, secs) in libs.items():
        print(f"built {k}: {lib.relative_to(ROOT)} in {secs:.2f} s")
    print(f"build seconds {time.perf_counter() - t0:.2f}")

    # ------------------------------------------- 3.-6. the FL path --
    threefry = threefry_phase(torch, mem_rate)
    bwo = bwo_phase(torch, mem_rate, f32_rate)
    grad_phase(torch)
    (bwo["launches"], bwo["launches_per_round"], bwo["round_time_s"],
     bwo["fused_rounds"]) = fl_phases(torch, counters)

    fa, fa_times = flash_phase(torch, mem_rate, bf16_rate)
    serve_launches, olmo_routes = serve_phase(torch, counters,
                                              fa_times["olmo decode"])
    serve_card_vs_cpu(torch)
    ssm, ssm_times = ssm_phase(torch, mem_rate, f32_rate, exp_rate)
    jamba_launches, jamba_routes = jamba_phase(torch, counters, ssm_times,
                                               fa_times)
    jamba_card_vs_cpu(torch)
    bf16_model_phase(torch)
    moe_launches, moe_routes = jamba_moe_phase(torch, counters, ssm_times,
                                               fa_times, mem_rate, bf16_rate)
    deepseek_phase(torch, counters, mem_rate, bf16_rate)
    moe_card_vs_cpu(torch)

    # ------------------------------------------------ 17.-21. training --
    t_train = time.perf_counter()
    fa_bwd = flash_bwd_phase(torch, mem_rate, bf16_rate)
    ssm_bwd = ssm_bwd_phase(torch, mem_rate, f32_rate, exp_rate)
    cells = train_cells()
    olmo_train, fa_bwd["train_step"] = train_phase(torch, counters,
                                                   *cells["19"])
    jamba_train, ssm_bwd["train_step"] = train_phase(torch, counters,
                                                     *cells["20"])
    train_card_vs_cpu(torch)
    print(f"phases 17-21 took {time.perf_counter() - t_train:.1f} s; the "
          f"script so far {time.perf_counter() - t_start:.1f} s")

    # ------------------- 22.-27. encoder-decoder, vision, the int8 cache --
    new = slice_phases(torch, counters, (mem_rate, f32_rate, bf16_rate,
                                         exp_rate), smi, t_start)
    fa_new, fa_bwd_new = new["22"], new["23"]
    whisper_launches, whisper_routes, whisper_serve = new["24"]
    whisper_train, whisper_step = new["25"]
    llava_launches, llava_routes, llava_serve = new["26"]
    int8 = new["27"]

    # ---- 28.-32. xLSTM, the continuous-batching server, LLaVA training --
    more = new_paths_phases(torch, counters,
                            (mem_rate, f32_rate, bf16_rate, exp_rate), smi,
                            t_start)
    _, xlstm_serve = more["28"]
    _, xlstm_step = more["29"]
    fa_server, (olmo_srv_launches, olmo_srv_routes, olmo_srv) = more["30"]
    ssm_server, (jamba_srv_launches, jamba_srv_routes, jamba_srv) = more["31"]
    fa_bwd_llava, llava_train, llava_step = more["32"]

    # ------------------------------------------ 33. the mesh schedules --
    mesh = run_numbered({"33": lambda: mesh_phase(torch)}, smi,
                        t_start, None)["33"]

    # ------------------------------------------------------ 34. flcheck --
    audit = run_numbered({"34": lambda: audit_phase(torch, smi)}, smi,
                         t_start, None)["34"]

    # ------------------------------ 35. the dry run and the cost model --
    dry_launches, dry = run_numbered(
        {"35": lambda: dryrun_phase(torch, counters)}, smi, t_start,
        None)["35"]

    # --------------------------------------------------------- results --
    def no_routes(numbers):
        return {k: v for k, v in numbers.items() if "routes" not in k}

    print(json.dumps({"paths": {"whisper-medium serve": whisper_serve,
                                "llava-next-mistral-7b serve": llava_serve,
                                "whisper-medium train step":
                                    no_routes(whisper_step),
                                "olmo-1b int8 cache": int8,
                                "xlstm-1.3b serve": xlstm_serve,
                                "xlstm-1.3b train step, 12 layers":
                                    no_routes(xlstm_step),
                                "olmo-1b server": olmo_srv,
                                "jamba server, 8 layers": jamba_srv,
                                "llava-next train step, 8 layers":
                                    no_routes(llava_step),
                                "fedbwo mesh, 10 ranks": mesh,
                                "flcheck, fedbwo at full width": audit,
                                "dry run and cost model": dry}}))
    kernels = [{
        "name": "bwo_evolve", "route": "cuda",
        "source": "src/repro_torch/csrc/bwo_evolve.cu",
        "replaces": "src/repro/kernels/bwo_evolve/bwo_evolve.py:43", **bwo,
        "launches": bwo["launches"] + mesh["launches"],
        "launches_by_path": {"main path (phase 4)": bwo["launches"],
                             "mesh, 10 ranks (phase 33)":
                                 mesh["launches"]}}, {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention_hopper.cu",
        "sources": {"tensor_core": "src/repro_torch/csrc/flash_attention_hopper.cu",
                    "split_k": "src/repro_torch/csrc/flash_attention_hopper.cu",
                    "tf32x3": "src/repro_torch/csrc/flash_attention_tf32.cu",
                    "cuda_core": "src/repro_torch/csrc/flash_attention.cu"},
        "replaces": "src/repro/kernels/flash_attention/flash_attention.py:78",
        "launches": (serve_launches + sum(jamba_routes.values())
                     + moe_launches["flash_attention"]
                     + olmo_train["flash_attention"]
                     + jamba_train["flash_attention"]
                     + whisper_launches["flash_attention"]
                     + whisper_train["flash_attention"]
                     + llava_launches["flash_attention"]
                     + int8["int8"]["launches"]["flash_attention"]
                     + olmo_srv_launches["flash_attention"]
                     + jamba_srv_launches["flash_attention"]
                     + llava_train["flash_attention"]
                     + dry_launches["flash_attention"]),
        "route_launches": {"olmo-1b": olmo_routes,
                           "jamba without experts": jamba_routes,
                           "jamba with experts": moe_routes,
                           "olmo-1b train step": fa_bwd["train_step"]["routes"],
                           "jamba train step":
                               ssm_bwd["train_step"]["routes"],
                           "whisper-medium": whisper_routes,
                           "whisper-medium train step":
                               whisper_step["routes"],
                           "llava-next-mistral-7b": llava_routes,
                           "olmo-1b int8 cache": int8["int8"]["routes"],
                           "olmo-1b server": olmo_srv_routes,
                           "jamba server": jamba_srv_routes,
                           "llava-next train step": llava_step["routes"]},
        **fa, "shapes": {**fa["shapes"], **fa_new["shapes"],
                         **fa_server["shapes"]},
        "max_abs_err": max(fa["max_abs_err"], fa_new["max_abs_err"],
                           fa_server["max_abs_err"])}, {
        "name": "ssm_scan", "route": "cuda",
        "source": "src/repro_torch/csrc/ssm_scan.cu",
        "replaces": "src/repro/kernels/ssm_scan/ssm_scan.py:57",
        "launches": (jamba_launches + moe_launches["ssm_scan"]
                     + jamba_train["ssm_scan"]
                     + jamba_srv_launches["ssm_scan"]),
        **ssm, "shapes": {**ssm["shapes"], **ssm_server["shapes"]},
        "max_abs_err": max(ssm["max_abs_err"], ssm_server["max_abs_err"])}, {
        "name": "flash_attention_bwd", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention_bwd_hopper.cu",
        "sources": {
            "tensor_core": "src/repro_torch/csrc/flash_attention_bwd_hopper.cu",
            "tf32x3": "src/repro_torch/csrc/flash_attention_bwd_tf32.cu",
            "cuda_core": "src/repro_torch/csrc/flash_attention_bwd.cu"},
        "replaces": "src/repro/kernels/flash_attention/flash_attention.py:78",
        "differentiates": "src/repro/models/attention.py:224 (the train "
                          "step's blockwise_attention, differentiated by XLA)",
        "launches": (olmo_train["flash_attention_bwd"]
                     + jamba_train["flash_attention_bwd"]
                     + whisper_train["flash_attention_bwd"]
                     + llava_train["flash_attention_bwd"]
                     + dry_launches["flash_attention_bwd"]),
        "route_launches": {
            "olmo-1b train step": fa_bwd["train_step"]["bwd_routes"],
            "jamba train step": ssm_bwd["train_step"]["bwd_routes"],
            "whisper-medium train step": whisper_step["bwd_routes"],
            "llava-next train step": llava_step["bwd_routes"]},
        **fa_bwd, "shapes": {**fa_bwd["shapes"], **fa_bwd_new["shapes"],
                             **fa_bwd_llava["shapes"]},
        "max_abs_err": max(fa_bwd["max_abs_err"], fa_bwd_new["max_abs_err"],
                           fa_bwd_llava["max_abs_err"])},
        {
        "name": "ssm_scan_bwd", "route": "cuda",
        "source": "src/repro_torch/csrc/ssm_scan_bwd.cu",
        "replaces": "src/repro/kernels/ssm_scan/ssm_scan.py:57",
        "differentiates": "src/repro/models/ssm.py:98 (the train step's "
                          "chunked associative scan, differentiated by XLA)",
        "launches": jamba_train["ssm_scan_bwd"], **ssm_bwd}, {
        "name": "threefry", "route": "cuda",
        "source": "src/repro_torch/csrc/threefry.cu",
        "replaces": "none: XLA's threefry2x32 lowering of jax.random (the "
                    "port's int64 torch ops, src/repro_torch/random.py)",
        **threefry}]
    print(f"chip_smoke took {time.perf_counter() - t_start:.1f} s ({smi})")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
