#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's paths on one CUDA card: the federated
round in plan and device mode, the compressed federated round, the client-sharded round, the
paper's experiments with the client-sequential round, LM serving,
Mamba2 SSD serving, the LM zoo's dense, hybrid, MLA + MoE, multimodal and
audio serving, federated LM training (the seed host loop and through
the device-resident engine), the
streamed federation's checkpoint and resume, the
streaming scenario library through its CLI, the tiered client bank
with its cohort prefetch and the telemetry, the live federation
service with its fault injection and supervised recovery, and the
event-stream fuzzer with the theory-scored validator.

    python3 chip_smoke.py

Run it from the root of a checkout: it imports ``src/repro_torch`` beside
it, and nothing of JAX or of the JAX package.  In order it

1. prints the card (name and power limit, as nvidia-smi gives them), the
   torch and CUDA versions and the two TF32 flags;
2. builds the hand-written kernels from ``src/repro_torch/kernels/csrc``
   (printing each kernel's registers, shared memory and spills from the
   ptxas report), and beside them copies with a planted fault that the
   checks below must catch: flash_attention with its first KV tile skipped
   (FLASH_FAULT), weighted_agg_quant with every tile reading the scale of
   its first chunk (QUANT_FAULT) and with the consumer warps reading the
   ring's place before the one they waited for (QUANT_RING_FAULT),
   ssd_intra_chunk with the first key
   tile of every query tile that reads more than one skipped (SSD_FAULT) and
   with every head of a CTA given the decay and xdt rows of its first head
   (SSD_HEAD_FAULT);
3. holds each kernel against its plain PyTorch version on the card at the
   paths' shapes (and at edge shapes that take other code; weighted_agg
   also at the paper tables' (K, D), masked_sgd also at one row per leaf
   of each paper model, the client-sequential round's), at the
   tolerances of ``repro_torch.kernels.ops`` (weighted_agg_quant: equal),
   flash_attention in bf16 against attention in f32 (BF16_UNIT),
   weighted_agg_quant on each of its paths to the scales (its plan, read
   from the kernel's host code, names the path) and its memory high-water
   mark over one launch, and
   ssd_intra_chunk at the serving prefill's shape with the upper triangle
   overflowing exp (no NaN or inf), in bf16 also against the function in
   f32 within its rounding bound (at the serving cell count on three
   draws), both of its planted faults outside ops.TOLERANCE there;
   flash_attention also at head dim 256 (gemma-7b's prefill shape, bf16
   and f32, causal and not, ragged S; the planted fault outside the bf16
   bound at gemma's shape), at llava-next-34b's prefill with its patches
   (H 56, KV 8, S 4,672) and at musicgen-medium's (hd 64, H = KV = 24),
   the planted fault outside the bf16 bound at both, and ssd_intra_chunk also at hymba-1.5b's 50
   heads (its serving cells (64, 50), N 16, and cut, ragged head blocks,
   SSD_HYMBA; the head fault outside ops.TOLERANCE at each);
4. drives the federated round, ``FederatedTrainer(engine="plan")`` on the
   EMNIST CNN at full width with 62 clients, through one late arrival and
   one excluding departure; checks each kernel's launch count, finite eval
   losses, and the card's parameters against the port's plain path (the
   same trainer on the CPU); then times warm rounds and profiles two;
5. drives device-mode sampling, ``FederatedTrainer(engine="device")`` on
   the same federation with a TraceShift and an InactivityBurst beside the
   arrival and the departure: launch counts (weighted_agg once a round,
   masked_sgd 8 leaves x E a round), both events applied and the burst's
   cohort dark for its rounds, every round's s on the card equal bit for
   bit to the same trainer's on the CPU (the draw is jax's threefry, the
   s-law table the same code's), params within PARAM_TOL of the CPU's,
   finite eval losses; then warm rounds/s of device and plan mode in
   turns (also with every round a span of its own), a profile of two
   device-mode rounds against the plan round's kernels, and the draw alone (``RoundEngine.sample_span`` over a span of
   DRAW_SPAN rounds): its launches and device time per round; the int8
   wire in device mode (weighted_agg_quant once a round, the f32 run's
   draws); and the reference's quickstart (SYNTHETIC(1, 1), 20 clients,
   logreg, 50 rounds from the reference's initial params) on the card and
   the CPU: equal round records, final accuracies within 0.02 of each
   other, printed beside the reference's noted ~0.87, and rounds/s;
6. drives the compressed round, the same trainer with
   ``compression="int8"``, ``"int8-topk"`` and ``"bf16"``: launch counts,
   round records equal to the f32 run's, finite eval losses, wire bytes,
   warm rounds/s in turns with f32, and profiles of int8 and int8-topk
   rounds against the f32 round's kernels; then, from one set of
   params and round inputs, the card's quantizer against the CPU's (bit
   for bit) and one round per wire on the card against the CPU (within
   PARAM_TOL plus one code step per client, see step_bound);
7. drives the sharded round: the same trainer with
   ``sharding=make_fed_sharding()`` over a one-rank NCCL group (a
   ``file://`` init under ``build/``), on the f32 and int8 wires: launch
   counts (weighted_agg_sharded or weighted_agg_quant_sharded once per
   round, weighted_agg never), params and round records bit-identical to
   the unsharded runs', warm rounds/s in turns with the unsharded
   trainers; both sharded kernels against their plain versions within
   ``ops.TOLERANCE`` and bit-identical to the unsharded kernels at the
   main path's slab, a 16-row slab and K 64, D 600, a planted fault (the
   wrapper reducing a shifted slab) caught, and the wrapper, the local
   launch and the all-reduce timed apart over repeated windows (median and
   spread), beside what each piece of the call costs the host.  The group
   is destroyed when the phase ends;
8. runs the paper's experiments and the client-sequential round
   (``FederatedTrainer(mode="client_sequential")``): in the reference's
   own scenario of its int8 modes' invariant (logreg, 4 clients, E 3, 8
   rounds, plan mode), the int8 sequential trainer's params and round
   records bit-identical to the int8 flat parallel trainer's; at full
   width (the EMNIST CNN, 62 slots, the main path's rounds, f32 and int8,
   each round from the parallel run's params), C x E x 8 one-row
   masked_sgd launches a round and no reduction kernel, round records
   equal to the parallel run's, params within PARAM_TOL plus one code step
   per client of it (how many elements differ, and whether one client's
   local steps alone equal its row of the 62-client steps), the memory
   high-water mark of a warm round below C D 4 bytes, warm rounds/s in
   turns with the parallel trainers; ``benchmarks.bound_check`` in both
   modes and Tables 3 (synthetic and images), 4 and 5 at the reference's
   defaults from the reference's initial params, after the tables' data
   are shown to be the reference's, each held to ``reference_rows.json``
   by the rules of ``repro_torch.benchmarks.reference`` and printed as JSON
   lines with their seconds; then one row of each table teacher-forced
   against the port on the CPU (records equal, params within PARAM_TOL
   after every round);
9. serves nemotron-4-15b at full width in bf16 with
   ``attn_impl="flash"`` through ``repro_torch.launch.serve.serve``: a
   batch of 4 prompts of 4,096 tokens, then 32 decode steps; checks
   flash_attention's launches (one per layer per prefill, none per decode
   step), finite logits, the prefill's logits and the chunked path's
   against the same weights with attention in f32 (LOGITS_FACTOR), and the
   reduced config in f32 on the card against the port's plain path on the
   CPU; prints prefill tokens/s (flash and chunked), decode ms/step and the
   memory high-water mark, and profiles a prefill and four decode steps;
   then serves mamba2-130m at full width in bf16 the same way: 24
   ssd_intra_chunk launches per prefill and none per decode step, finite
   logits, the prefill's logits with the kernel and with its plain version
   against the model with the intra-chunk term in f64 (LOGITS_FACTOR),
   decode steps against the full forward in f32, the reduced config on the
   card against the CPU; prefill and decode times, busy shares, memory;
   then the LM zoo (ZOO): starcoder2-3b, gemma-7b (attn_impl="flash", head
   dim 256), hymba-1.5b, deepseek-v2-lite-16b, llava-next-34b and
   musicgen-medium (both attn_impl="flash"; musicgen's prompts and tokens
   carry its 4 codebooks) at full width and depth and
   command-r-plus-104b at full width with 4 of its 64 layers
   (attn_impl="flash"), each from seed 0 through ``serve`` (batch 4,
   prompt 4,096, ZOO_GEN decode steps) and freed before the next: launch
   counts per prefill (flash_attention one per layer for the flash
   configs, ssd_intra_chunk one per layer for hymba) and none per decode
   step, finite logits, warm prefill tokens/s, decode ms/step, busy shares
   and memory high-water mark; the flash configs' prefill logits and the
   chunked path's against the model with attention in f32
   (LOGITS_FACTOR, the planted flash fault outside), hymba's in f32 with
   the kernel and with the plain intra-chunk term against the term in f64
   (LOGITS_FACTOR, the planted SSD fault outside); starcoder2's and
   deepseek's against attention in f32, reported; llava's 576 random
   patches ahead of its 4,096-token prompts through
   ``transformer.prefill(patch_emb=)`` into a cache of 4,704 slots, then
   LLAVA_GEN decode steps at positions 4,672 + i (60 flash launches at S
   4,672, none per step, finite logits); then every new
   architecture's reduced config in f32 on the card against the CPU
   (deepseek-v3-671b runs only so, with a live router_bias; gemma's also
   at head dim 256 with flash; llava's with its 8 patches); then LM
   training (9d): ``repro_torch.launch.train``'s main at its defaults with
   ``--full --arch mamba2-130m`` for TRAIN_ROUNDS rounds (masked_sgd E x
   leaves launches a round and no other kernel inside the rounds, finite
   probe losses, warm rounds/s, memory), then one round of each family's
   reduced representative in f32 on the card against the CPU (each leaf's
   delta within TRAIN_DELTA_TOL of its norm, see TRAIN_FLIP_SHARE); then
   federated LM training through the engine (9e):
   ``repro_torch.launch.fed_train``'s main with ``--full --arch
   mamba2-130m --arrive 1`` for FED_TRAIN_ROUNDS rounds at its other
   defaults (an LMTask, capacity 6, device-mode draws, the arrival
   admitted at round 3), on the f32 wire and with ``--compress int8``:
   inside the spans masked_sgd E x leaves launches a round, weighted_agg
   once a round (int8: weighted_agg_quant once, weighted_agg never), no
   flash or SSD kernel, outside them only the probes' ssd_intra_chunk;
   the arrival applied, finite probe losses, warm rounds/s, the memory
   high-water mark and a profiled round's kernels and busy share; then the
   reduced config in f32 in each engine mode on the card and the CPU from
   the same initial params: equal round records (s bit for bit, the
   events), masked_sgd and weighted_agg once a round (client_sequential:
   capacity x E x leaves one-row masked_sgd launches a round, no
   reduction kernel), each leaf's delta over the first span within
   TRAIN_DELTA_TOL of its norm (after TRAIN_FLIP_SHARE);
10. drives checkpoint and resume of the streamed federation: a
   ``StreamScheduler`` with ``model_kind="cnn"`` over the main path's
   EMNIST federation (capacity CKPT_CAPACITY), a TraceShift, an
   InactivityBurst and an excluding Departure before the cut, an Arrival
   with a brand-new client and an including Departure pending at it; half
   of CKPT_ROUNDS run and ``save`` into ``build/checkpoint/``, the
   scheduler and its engine dropped, ``restore`` onto the card
   (``device=None``) into a fresh engine and the other half run, against
   one uncut run of all the rounds; in device mode on the f32 wire, plan
   mode on the f32 wire and device mode on the int8 wire.  Checks: equal
   round records (s bit for bit, the eval rounds), finite eval losses
   within PARAM_TOL of the uncut run's, the control plane's state, each
   kernel's launches over the resumed rounds, params within PARAM_TOL
   (with the count of elements that differ, and where any does, a second
   uncut run's difference from the first beside it), a flipped byte of the
   saved npz refused (CorruptCheckpointError); prints the npz and manifest
   bytes and the seconds to save and to restore;
11. drives the streaming scenario library through its CLI: each of the
   five named scenarios at its defaults,
   ``repro_torch.launch.fed_stream.main`` on the card (device mode, f32)
   and with ``--device cpu``, each run saving its end state into
   ``build/scenarios/``.  Checks: equal round records (s bit for bit, the
   eval rounds), equal ``events_applied`` and ``clients_end``, finite eval
   losses, launches of weighted_agg 1 and masked_sgd 2 leaves x E a round,
   the first span's params (``build_scheduler``, one round) card against
   CPU within PARAM_TOL; prints rounds/s per scenario and the final
   params' distance in PARAM_TOLs.  Then churn with ``--compress int8
   --mode plan`` (weighted_agg_quant once a round, weighted_agg never,
   the CPU's records), and rotation saved at SCENARIO_CUT and restored
   onto the card (records equal to the uncut run's, params bit-identical);
12. drives the tiered client bank and its cohort prefetch (staged on a CUDA
   stream of the stager's own from pinned memory) and the telemetry:
   (a) make_clients' 62-client EMNIST fleet at full width through BANK_HOT
   capacity slots of a ``StreamScheduler(model_kind="cnn",
   prefetch=True)`` on the reference's rotation schedule (dwell
   BANK_DWELL, BANK_ROUNDS rounds, every event pushed at the start), in
   plan and device mode, each against the same schedule on the same slots
   without a bank: equal records, params bit-identical, launches
   weighted_agg once and masked_sgd 8 leaves x E a round,
   ``prefetch_stats()`` with no staging error, no miss and a hit per
   arrival; in plan mode also against all 62 clients resident (equal
   records, the extra slots' s zero, params within PARAM_TOL, the count of
   differing elements printed); warm rounds/s without and with prefetch in
   turns, with the stager's stage and wait seconds and overlap fraction;
   (b) each scenario at its defaults through fed_stream with
   ``--prefetch`` (rotation also with ``--bank``): records equal and
   params bit-identical to step 11's card run, no staging error, no miss
   in flash-crowd and rotation, the bank's summary beside step 11's
   rounds/s; (c) rotation with ``--prefetch`` saved at SCENARIO_CUT
   (fed-checkpoint-v2, one chunk per client) and restored onto the card
   with its bank and stager rebuilt: records equal and params
   bit-identical to the uncut run's, a flipped byte of one client chunk
   refused (CorruptCheckpointError); (d) flash-crowd with
   ``--metrics-out`` and ``--prom-out``: ``fed_wire_bytes_total`` equal to
   ``wire_bytes(D)`` times the uploads counted from the records, the
   ``span_seconds{name="sched.run_span"}`` count equal to
   ``sched_spans_total``, params bit-identical to the run without
   telemetry, and one span under ``Telemetry(trace_dir=)`` whose Chrome
   trace names weighted_agg and masked_sgd;
13. drives the federation service (``FederationService``, ``fed_serve``,
   ``fed_top``): (a) step 12's fleet through BANK_HOT slots with prefetch
   in device mode, its rotation events submitted from the main thread
   while the worker runs spans of SERVICE_SPAN rounds (serve_live: each
   event a span ahead of its tau), against the same schedule preloaded
   into a blocking scheduler: equal records, params bit-identical,
   launches weighted_agg once and masked_sgd 8 leaves x E a round, every
   event ingested and applied, no staging error; (b) the same fleet
   supervised through tests/test_chaos.py's six faults (SERVICE_SOAK:
   worker crash and hang, mid-span crash, write failure, corrupt
   snapshot, a 256-event flood) with snapshots every span, the watchdog
   at SERVICE_SPAN_TIMEOUT, merge-stale and the engine reused: every site
   fired, at least 3 recoveries, each caused by an injected fault or the
   watchdog's TimeoutError, the hang's by the latter, a snapshot failure,
   256 events merged, no staging error after the last recovery, records
   and params bit-identical to (a)'s preloaded run; MTTR, detection
   latency and recovered rounds printed with weighted_agg's launches;
   (c) ``python -m repro_torch.launch.fed_serve --scenario churn --chaos
   7`` in a process of its own, its chaos block printed and its records
   and params equal to the CLI's without --chaos; a flash-crowd trace
   dumped and replayed with --trace against the paced run; flash-crowd
   with --chaos and --metrics-out (faults_fired_total and the svc_*
   counters in the dump); one FedTop frame of a live service, printed;
   (d) warm rounds/s of the service and the blocking scheduler on (a)'s
   schedule in turns, the service's busy, idle and overhead seconds and
   its ingest lag;
14. drives the event-stream fuzzer and the theory-scored validator
   (``repro_torch.fed.fuzz``, ``repro_torch.fed.validate``) on the card:
   (a) ``run_corpus`` over FUZZ_SEEDS seeds (the reference's nightly
   corpus) on one warm ``FuzzHarness`` with plan parity: every case's
   exact-resume, zero-recompile, weight-sanity and plan-parity, every kill
   resumed; prints cases/s, rounds, kills, resumes and events applied;
   (b) ``run_backend_matrix`` over FUZZ_BACKENDS plus "sharded" over a
   one-rank NCCL group (a ``file://`` init under ``build/``, destroyed when
   the phase ends) for FUZZ_MATRIX_SEEDS seeds: records exact on every
   backend, params within the reference's gates; prints max_param_err and,
   over the same cases, how many final param elements of banked,
   client_sequential and sharded differ from client_parallel and of
   quantized_sequential from quantized (banked must differ in none);
   (c) ``run_chaos_corpus`` over FUZZ_CHAOS_SEEDS seeds: at least one
   recovery, every recovered run bit-exact to its fault-free run; prints
   recoveries, merged events, MTTR mean and max and each case's faults;
   (d) ``validate_corpus`` over VALIDATE_SEEDS seeds on f32 and
   VALIDATE_INT8_SEEDS on int8: the Theorem 3.1 envelope and Table 1's
   ordering on every seed, weighted_agg (int8: weighted_agg_quant) once
   and masked_sgd E times a round; prints the max margin and each seed's
   tails; then the two mutation smokes, each of which must be caught:
   scheme C served B's coefficients (the engine's ``scheme_coefficients``
   patched) as scheme-ordering, and the ``"int8:levels=1"`` wire;
   (e) each backend's launches over one uninterrupted case: weighted_agg
   (int8: weighted_agg_quant; sharded: weighted_agg_sharded) once and
   masked_sgd 2 leaves x E a round on parallel legs, masked_sgd capacity x
   2 x E a round and no reduction kernel on sequential legs;
   (f) FUZZ_CPU_SEED's case on the card and on the CPU: equal round
   records (s bit for bit) and the first span's params within PARAM_TOL;
15. times each kernel beside its bound, its plain version and the one
   PyTorch call that computes the same function (weighted_agg_quant from
   device memory and, beside it, from L2; for weighted_agg_quant,
   ssd_intra_chunk and the sharded kernels, where no single call does, a
   composition of calls, ssd_intra_chunk's computing the group's scores
   once for its heads as the kernel does; for flash_attention,
   scaled_dot_product_attention, whose backend is named and each backend
   timed), and prints them, the sharded kernels' timings from step 7 among
   them, as one ``{"kernels": [...]}`` line; flash_attention's row also
   carries gemma-7b's shape (head dim 256), llava's and musicgen's, and
   ssd_intra_chunk's hymba's cells, under ``other_shapes``, and each the
   zoo paths' launches per prefill under ``other_paths`` (masked_sgd's:
   the training round's and fed_train's; weighted_agg's and
   weighted_agg_quant's: fed_train's a round).  ssd_intra_chunk's bound
   counts the group's scores once per pair, as its inputs need, and the
   per-head reckoning (the scores counted once per head) is printed
   beside it.

Any failure raises and the script exits nonzero.  The last line,
``{"ok": true, "device": {...}}``, is printed only when every phase passed.
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import itertools
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA's data sheet): device memory, f32 outside the
# tensor cores (weighted_agg and masked_sgd), dense bf16 on the tensor cores
# (flash_attention at the serving shape); and its L2 cache
HBM_BYTES_PER_S = 3.35e12
L2_BYTES = 50e6
F32_FLOPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12

N_CLIENTS = 62          # EMNIST_CNN.n_devices
ROUNDS = 6              # main path: arrival at TAU_ARRIVE, departure at
TAU_ARRIVE = 2          # TAU_DEPART, eval every EVAL_EVERY rounds
TAU_DEPART = 4
EVAL_EVERY = 2
WARM_ROUNDS = 10
TURNS = 2               # the wires' warm rounds/s: windows in turns
PROFILED_ROUNDS = 2
NO_EVAL = 10 ** 9
# card against the CPU after ROUNDS rounds: f32 in another summation order
# (cuDNN and cuBLAS against the CPU's convolutions and matmuls)
PARAM_TOL = dict(rtol=1e-5, atol=1e-6)
LOSS_RTOL = 1e-5

ARCH = "nemotron-4-15b"
SERVE_BATCH = 4         # the serving path: 4 prompts of 4,096 tokens, then
PROMPT_LEN = 4096       # 32 decode steps, at full width in bf16
GEN = 32
WARM_STEPS = 8          # decode steps timed again once warm
# flash_attention at the serving prefill's shape: (B, H, KV, S, hd)
FLASH_MAIN = (SERVE_BATCH, 48, 8, PROMPT_LEN, 128)
# and at gemma-7b's, head dim 256 (the kernel's tiles of 64 keys there)
FLASH_GEMMA = (SERVE_BATCH, 16, 16, PROMPT_LEN, 256)
# llava-next-34b's prefill with its 576 patches ahead of the 4,096 text
# tokens (S 4,672, a ragged last tile; a group of 7 query heads per KV
# head), and musicgen-medium's (hd 64, H = KV = 24)
LLAVA_PATCHES = 576
FLASH_LLAVA = (SERVE_BATCH, 56, 8, LLAVA_PATCHES + PROMPT_LEN, 128)
FLASH_MUSICGEN = (SERVE_BATCH, 24, 24, PROMPT_LEN, 64)
# edge shapes that take other code: (B, H, KV, S, hd, dtype, causal)
FLASH_EDGES = [
    (2, 4, 2, 100, 128, torch.bfloat16, True),   # keys past S masked
    (2, 4, 2, 100, 32, torch.float32, True),     # the same in f32, hd 32
    (2, 8, 8, 256, 32, torch.bfloat16, True),    # hd 32 (64-byte swizzle)
    (1, 8, 2, 1000, 64, torch.bfloat16, False),  # hd 64, non-causal
    (1, 8, 2, 1000, 64, torch.float32, False),
    (1, 4, 1, 384, 128, torch.bfloat16, True),   # MQA (one KV head)
    (1, 4, 1, 384, 128, torch.float32, False),
    # the bf16 kernel's tiles are 128 query rows by 128 keys: S shorter
    # than one tile, one row past one and two tiles, KV = H, and hd 128
    # non-causal over a ragged last tile
    (1, 4, 2, 1, 128, torch.bfloat16, True),
    (2, 4, 2, 17, 128, torch.bfloat16, True),
    (1, 4, 2, 64, 64, torch.bfloat16, False),
    (1, 4, 2, 129, 128, torch.bfloat16, True),
    (1, 4, 2, 257, 128, torch.bfloat16, False),
    (1, 8, 8, 300, 128, torch.bfloat16, True),
    (1, 48, 8, 1000, 128, torch.bfloat16, False),
    # head dim 256: gemma's prefill shape in f32, causal; ragged S causal
    # and not, in both types; one key past a KV tile of 64; GQA
    (*FLASH_GEMMA, torch.float32, True),
    (1, 16, 16, 1000, 256, torch.bfloat16, False),
    (1, 16, 16, 1000, 256, torch.float32, False),
    (2, 4, 2, 65, 256, torch.bfloat16, True),
    (1, 8, 2, 300, 256, torch.bfloat16, True),
    (1, 8, 2, 300, 256, torch.float32, True),
]
# flash_attention in bf16 against the same attention computed in f32
# (flash_attention_plain on f32 copies of q, k and v).  The kernel and its
# plain version each round every probability to bf16 (8 significant bits)
# before its product with v, a relative error of at most 2^-8, which moves
# an output by at most 2^-8 * A, A = sum_j p_j |v_j| (the same attention of
# |v|); and they round every output to bf16, at most 2^-8 |o|.  So
# |got - o32| <= 2^-8 (|o32| + A), times BF16_SLACK for f32 sums taken in
# other orders.  At the serving shape the median |o| is a few hundredths,
# the size of ops.TOLERANCE's atol, so that tolerance alone would pass a
# kernel that drops keys.
BF16_UNIT = 2.0 ** -8
BF16_SLACK = 1.0625
# prefill logits with attn_impl="flash" and with "chunked", same weights and
# prompts, in bf16, against one reference: the same model with its
# attention computed in f32 and everything else as the chunked path does
# it.  Both paths make the same roundings, each probability and each output
# to bf16 once per layer, so their errors against that reference are of
# one size, carried and amplified by the layers after them; flash's may be
# at most LOGITS_FACTOR times chunked's, in max abs error and in relative
# norm.  A planted fault must fail both this bound and the kernel's
# (BF16_UNIT): the bf16 kernel built with FLASH_FAULT, which skips the
# first of the KV tiles wherever a query tile sees more than one.  It is
# planted on the first tile of both the producer's and the consumers' loops
# over kv_tiles, which still count their places in the ring from 0, so the
# pipeline stays whole and the fault shows in the numbers instead of
# hanging the card.
LOGITS_FACTOR = 1.5
FLASH_FAULT = ("int kt = 0, it = 0;", "int kt = n > 1, it = 0;")
# the reduced config in f32 on the card against the port's plain path on
# the CPU: f32 in other summation orders (the kernel's f32 path, cuBLAS)
REDUCED_TOL = dict(rtol=1e-4, atol=1e-4)

# Mamba2 SSD serving: mamba2-130m at full width in bf16, the same batch,
# prompt length and decode steps as the nemotron phase
SSM_ARCH = "mamba2-130m"
SSD_HEADS = 24          # mamba2-130m's SSD heads (one group)
SSD_Q, SSD_N, SSD_P = 256, 128, 64
# the serving prefill's cells: (batch * chunks, heads), the group's C and B
# read by its 24 heads through a stride-0 dim (the model's layout)
SSD_MAIN = (SERVE_BATCH * PROMPT_LEN // SSD_Q, SSD_HEADS, SSD_Q, SSD_N,
            SSD_P, torch.float32)
# edge shapes, (G, Q, N, P, dtype): one row, a ragged query tile (Q = 100,
# which a 100-token prompt gives), the reduced config's Q, N and P, and bf16
# (the Pallas kernel's other type) at two shapes, the second of them the
# serving prefill's cell count
SSD_EDGES = [
    (96, 1, SSD_N, SSD_P, torch.float32),
    (96, 100, SSD_N, SSD_P, torch.float32),
    (96, 32, 16, 32, torch.float32),
    (96, 128, 64, 64, torch.bfloat16),
    (SSD_MAIN[0] * SSD_HEADS, SSD_Q, SSD_N, SSD_P, torch.bfloat16),
]
# hymba-1.5b's intra-chunk term, (G, heads, Q, N, P, dtype): its serving
# prefill's cells (64, 50), where one CTA takes all 50 heads, and smaller
# prefills' cells, where heads_per_cta cuts the 50 heads into blocks of a
# multiple of the kernel's 3 consumer warpgroups, the last block ragged: 4
# prompts of 64 tokens (blocks of 3), one of 4,096 (blocks of 18), four of
# 256 (blocks of 6)
SSD_HYMBA_HEADS = 50
SSD_HYMBA = [(SERVE_BATCH * PROMPT_LEN // SSD_Q, SSD_HYMBA_HEADS, SSD_Q, 16,
              SSD_P, torch.float32),
             (4, SSD_HYMBA_HEADS, 64, 16, SSD_P, torch.float32),
             (16, SSD_HYMBA_HEADS, SSD_Q, 16, SSD_P, torch.float32),
             (4, SSD_HYMBA_HEADS, SSD_Q, 16, SSD_P, torch.float32)]
# the last edge shape (bf16 at the serving cell count) is checked on this
# many draws of its inputs, the generator running on between them, so that
# the rounding bound's reading there rests on more than one draw
SSD_BF16_DRAWS = 3
# (outer cells, Q) of f32 prefills whose whole groups fill fewer CTAs than
# the card has SMs, so that heads_per_cta cuts the heads into blocks: a
# batch of 4 prompts of 64 tokens (the serve CLI's default), one prompt of
# 4,096 tokens, one of 1,024
SSD_SPLIT = [(4, 64), (16, 256), (4, 256)]
# In f32 the kernel is held to ops.TOLERANCE against its plain version,
# which at the serving widths it meets only by summing in the plain
# version's order (another f32 order, or the f64 answer, leaves it), and
# beside that against the function in f64 (exp taken where j <= i) within
# the rounding bound of any f32 order, SSD_F32_BOUND:
#   |y - y64| <= 2^-24 sum_j (sum_n |C_in| |B_jn|) L_ij (N + Q + 8 + |d_ij|)
#                |xdt_j|,   d_ij = cum_i - cum_j,
# the two sums' lengths N and Q, the decay's f32 difference (|d| units of
# the exponent), and 8 units for expf (2 ulp), the products' roundings and
# second-order terms.
# ssd_intra_chunk in bf16 against the same function in f32
# (ssd_intra_chunk_plain on the bf16 inputs): the kernel rounds each score
# s_ij (the decay applied) to bf16 once, a relative error of at most 2^-8,
# before its product with xdt, so |got - y32| <= 2^-8 A with A = sum_j
# |s_ij| |xdt_j|, plus the f32 sums taken in another order, at most
# (N + Q) 2^-24 A2 with A2 the same sums of absolute products.  The kernel
# is held to ops.TOLERANCE (the reference suite's) in f32, and in bf16 at
# the reference suite's sizes (Q <= 128): at the serving cell count the
# bf16 rounding of the scores, which is the Pallas body's own arithmetic,
# leaves an element or so of 25 M outside its atol of 0.4, and the bound
# above holds the kernel there.  A planted fault must fail every one of
# these bounds: the kernel built with SSD_FAULT, which skips the first key
# tile of every query tile that reads more than one.  It is planted on the
# f32 kernel's loops over a head's key tiles, the producer's and the
# consumers' (which count their places in the ring apart from the tile, so
# the pipeline stays whole), and on the bf16 kernel's loop.
SSD_FAULT = ("for (int kt = 0; kt < n_kt; ++kt) {",
             "for (int kt = n_kt > 1; kt < n_kt; ++kt) {")
# the f32 kernel built with every head of a CTA staged from the block's
# first head (its cum, so its decay, and its xdt rows): where a CTA takes
# several heads (the serving prefill's shape) it must fail ops.TOLERANCE
SSD_HEAD_FAULT = ("const int h = h0 + h1 + g;", "const int h = h0;")
# the prefill logits of mamba2-130m in bf16, the intra-chunk term from the
# kernel and from its plain version (same weights and prompts), against one
# reference: the same model with the intra-chunk term summed in f64 and
# rounded to f32.  The kernel and the plain version both sum in f32 in
# their own orders, so their errors against that reference are of one
# size, carried through the layers by the bf16 roundings after them; the
# kernel's may be at most LOGITS_FACTOR times the plain version's, in max
# abs error and in relative norm, and the planted fault must fail that.
SSM_DECODE_STEPS = 8    # decode steps held against a full forward (f32)
# the LM zoo's serving phases, after mamba2's: (arch, attn_impl, layers kept
# or None for all), each at full width from seed 0, batch SERVE_BATCH,
# prompt PROMPT_LEN, then ZOO_GEN decode steps; command-r-plus-104b (208 GB
# in bf16) keeps 4 of its 64 layers
ZOO = [("starcoder2-3b", "chunked", None),
       ("gemma-7b", "flash", None),
       ("hymba-1.5b", "chunked", None),
       ("deepseek-v2-lite-16b", "chunked", None),
       ("command-r-plus-104b", "flash", 4),
       ("llava-next-34b", "flash", None),
       ("musicgen-medium", "flash", None)]
# decode steps through serve: the warm ms/step is read over WARM_STEPS
# steps after it, so 8 keep every check at a quarter of 32's host time
ZOO_GEN = 8
# llava's patch prefill: its prompts after LLAVA_PATCHES patches into a
# cache of LLAVA_PATCHES + PROMPT_LEN + LLAVA_GEN = 4,704 slots
LLAVA_GEN = GEN
# the reduced configs run on the card against the CPU (deepseek-v3-671b,
# 1.34 TB in bf16, runs only so; llava-next-34b with its reduced config's
# 8 patches)
ZOO_REDUCED = ["starcoder2-3b", "gemma-7b", "command-r-plus-104b",
               "hymba-1.5b", "deepseek-v2-lite-16b", "deepseek-v3-671b",
               "llava-next-34b", "musicgen-medium"]
# LM training: launch/train.py at its defaults (the reference CLI's: C 4,
# E 2, batch 2, seq 128, scheme C, eta0 0.05) at full width on TRAIN_ARCH
# for TRAIN_ROUNDS rounds; then one round of each family's reduced
# representative (TRAIN_REDUCED) in f32 on the card against the CPU, from
# the same params, masks and batches.  Each leaf's delta there must agree
# within TRAIN_DELTA_TOL of its norm.  Each local step and the aggregation
# round the parameter in f32, so two rounds whose updates differ at all
# put a few elements an ulp apart at each of those E + 1 roundings: where
# such elements are at most TRAIN_FLIP_SHARE of a leaf they are set aside
# first (measured on the CPU against the reference: 0.1-0.2% of the
# reduced mamba2's in_B, in_C, in_dt, at most 2 ulps; a leaf-wide error
# moves most elements and is held to TRAIN_DELTA_TOL)
TRAIN_ARCH = "mamba2-130m"
TRAIN_ROUNDS = 4
TRAIN_REDUCED = ["nemotron-4-15b", "gemma-7b", "deepseek-v3-671b",
                 "mamba2-130m", "hymba-1.5b", "llava-next-34b",
                 "musicgen-medium"]
TRAIN_SHAPE = dict(n_clients=4, local_epochs=2, batch=2, seq=32)
TRAIN_DELTA_TOL = 1e-4
TRAIN_FLIP_SHARE = 0.01
# federated LM training through the engine (9e): launch.fed_train at its
# defaults with one arrival mid-run (capacity = clients + 2, device-mode
# draws), at full width and then reduced in f32 on the card and the CPU
# from the same initial params, once per engine mode; the spans are
# [0, 1), [1, 3), [3, 4), [4, 5), [5, 6) (the arrival at 3, probes at 0, 3
# and 4): the first is the warm-up, the last is profiled, the three
# between are timed
FED_TRAIN_ROUNDS = 6
FED_TRAIN_ARGS = ["--arch", TRAIN_ARCH, "--arrive", "1", "--quiet"]
FED_TRAIN_PROFILED_SPAN = 4
# the full-width run's capacity (its default: 4 clients + 2): the rows of
# the (capacity, D) reductions and of the masked_sgd launches, at which
# step 3 holds each kernel against its plain version
FED_TRAIN_CAPACITY = 6
FED_TRAIN_MODES = ("client_parallel", "client_sequential")
FED_TRAIN_REDUCED_ROUNDS = 4
# a leaf whose exact gradient is zero has a delta of rounding noise alone,
# which no tolerance relative to itself can hold: the key bias without
# rotary embeddings (each query's scores shift by one constant, which the
# softmax removes; musicgen's).  Both devices' deltas there must stay below
# TRAIN_ZERO_TOL of the round's largest leaf delta
TRAIN_ZERO_GRAD = "attn/bk"
TRAIN_ZERO_TOL = 1e-6
# the decode steps against the full forward in f32 (tests/test_decode.py's
# check at the reference's tolerance), the same weights upcast to f32
DECODE_TOL = dict(rtol=1e-4, atol=1e-4)

# the compressed round: each wire's trainer runs this many rounds on the
# main path's clients and plan (the int8 one through the arrival and the
# departure)
WIRE_ROUNDS = {"int8": ROUNDS, "int8-topk": 2, "bf16": 2}
QUANT_CHUNK = 256       # CompressionSpec's default chunk
# weighted_agg_quant against its plain version, both (K, D, chunk, levels,
# wider) of codes from quantize_chunked, the payload's row stride made
# `wider` bytes wider: the int8 wire's shape, and edge shapes that take
# other code: several TMA row boxes a tile, both paths to the scales
# (csrc/weighted_agg_quant.cu's header says which shapes take which)
QUANT_MAIN = (N_CLIENTS, None, QUANT_CHUNK, 127, 0)  # D: the CNN's
QUANT_EDGES = [
    (1, 4099, 256, 127, 0),            # one client; D not a chunk multiple
    (70, 4099, 256, 127, 0),           # K > 64, the reference's K-tiled case
    (N_CLIENTS, 100_000, 64, 127, 0),  # another chunk that 16 divides
    (N_CLIENTS, None, 100, 127, 0),    # warps straddle chunks; scale
                                       # rows of 18,468 bytes; rows padded
    (8, 1000, 1, 127, 0),              # one scale per code
    (N_CLIENTS, 4099, 256, 7, 0),      # codes of levels=7
    (256, 65_536, 256, 127, 0),        # K 256: several boxes a tile
    (257, 100_000, 256, 127, 0),       # one row past 256
    (300, None, 256, 127, 0),          # five boxes at the wire's width
    (4, 16, 4, 127, 0),                # D below one tile; per code
    (N_CLIENTS, 100_000, 50, 127, 0),  # per code, few chunks a tile
    (N_CLIENTS, 10_000, 256, 127, 0),  # fewer tiles than SMs
    (N_CLIENTS, 10_000, 256, 127, 4096),  # rows wider than Dp
]
# the planted faults: every tile reads the scale of its first chunk, right
# only where a tile lies inside one chunk (caught at chunk 100); and the
# consumer warps read the ring's place before the one they waited for (the
# previous group's where a group has one place; caught at K > 256 and at
# the wire's shape)
QUANT_FAULT = ("static_cast<int>((col + j < a.D ? col + j : a.D - 1) / "
               "a.chunk -", "static_cast<int>(c0 -")
QUANT_RING_FAULT = (
    "ring + static_cast<size_t>(p) * a.place_bytes;",
    "ring + static_cast<size_t>((p + GROUPS * a.stages - 1) % (GROUPS * "
    "a.stages)) * a.place_bytes;")


# the sharded kernels against their plain versions, (K, D) and (K, D,
# chunk), D None for the CNN's: the main path's slab (62 rows at one rank),
# a 16-row slab (one of four ranks' share of 64 slots) and the reference's
# K 64, D 600 (tests/_sharded_check.py:68); the first two are timed
SHARDED_SLABS = [(N_CLIENTS, None), (16, None), (64, 600)]
SHARDED_QUANT_SLABS = [(N_CLIENTS, None, QUANT_CHUNK), (16, None, QUANT_CHUNK),
                       (64, 600, 100)]
# the sharded wrappers, their local launches and all-reduces are each
# timed over this many windows, taken in turns, each after the card spun
# this many cycles (~0.1 s) while the host queued its calls
SHARDED_WINDOWS = 7
SHARDED_SPIN = 200_000_000
# the caching allocator's pool is grown by this many bytes before the
# sharded kernels are timed, so that back-to-back calls take their outputs
# from it and no cudaMalloc falls inside the timed window
POOL_BYTES = 2 ** 30

# the paper's experiments: weighted_agg at the tables' (K, D) (Table 3 on
# SYNTHETIC and on images with 24 clients, Tables 4 and 5 with 10)
TABLE_AGG = [(24, 610), (24, 159_010), (10, 610)]
# the reference's own scenario of int8 parallel == int8 sequential
# (tests/test_compression.py:157-190): logreg, 4 clients of
# synthetic_federation(0.5, 0.5, 4, seed=0), E 3, B 10, scheme C, eta0 0.5,
# 8 rounds, eval every 4
SEQ_SCENARIO = dict(n_clients=4, local_epochs=3, batch_size=10, eta0=0.5,
                    rounds=8, eval_every=4)
SEQ_WARM_ROUNDS = 3     # the sequential round's warm windows, in turns
# device mode (engine="device"): the main path's federation plus a
# TraceShift of client 5 to trace 5 (bw_low) at tau 1 and clients 0-2 dark
# for 2 rounds from tau 3; the int8 wire for DEVICE_INT8_ROUNDS rounds
DEVICE_SHIFT = (1, 5, 5)            # (tau, client, index into TRACES)
DEVICE_BURST = (3, 2, (0, 1, 2))    # (tau, duration, clients)
DEVICE_INT8_ROUNDS = 2
DRAW_SPAN = 10                      # rounds of the timed draw
# checkpoint and resume: CKPT_ROUNDS rounds cut in half; before the cut a
# TraceShift (tau, client, index into TRACES), an InactivityBurst (tau,
# duration, clients) and an excluding Departure (tau, client); pending at
# it a brand-new client's Arrival and an including Departure (tau, client)
CKPT_ROUNDS = 12
CKPT_CAPACITY = 64
CKPT_SHIFT = (1, 5, 5)
CKPT_BURST = (2, 2, (0, 1, 2))
CKPT_EXCLUDE = (4, 3)
CKPT_ARRIVE = 8
CKPT_INCLUDE = (10, 7)
CKPT_LEGS = (("device", None), ("plan", None), ("device", "int8"))
# the streaming scenarios: rotation (60 rounds) is cut here, saved and
# restored onto the card
SCENARIO_CUT = 30
# the client bank: the EMNIST fleet rotates through BANK_HOT slots (the
# reference's rotation schedule: every BANK_DWELL rounds the oldest
# resident departs and the next member arrives) over BANK_ROUNDS rounds;
# warm rounds/s in BANK_TURNS rounds of turns
BANK_HOT = 16
BANK_DWELL = 2
BANK_ROUNDS = 24
BANK_EVAL_EVERY = 8
BANK_TURNS = 2
# the federation service: the bank's fleet and rotation schedule served by a
# FederationService in spans of SERVICE_SPAN rounds, the events submitted
# from the main thread while the worker runs (serve_live); the chaos soak's
# faults (site, at, kind, size, seconds) are tests/test_chaos.py's, under
# its watchdog timeout; warm rounds/s of the service and the blocking
# scheduler in SERVICE_TURNS rounds of turns
SERVICE_SPAN = 4
SERVICE_SOAK = (("worker", 1, "crash", 0, 0.0),
                ("worker", 4, "hang", 0, 30.0),
                ("sched_span", 6, "crash", 0, 0.0),
                ("ckpt_save", 3, "io-error", 0, 0.0),
                ("ckpt_written", 5, "corrupt", 16, 0.0),
                ("flood", 2, "flood", 256, 0.0))
SERVICE_SPAN_TIMEOUT = 2.0
SERVICE_TURNS = 2
# fed_serve's scenario traces submitted at this rate, so that each event
# lands before its tau (at the CLI's default 50 a second the card's worker
# runs past the first taus before their events are submitted)
SERVICE_EVENTS_PER_S = "1000000"
# fed_serve's chaos seeds: churn's (7) puts its hang in a generation that
# has run no span yet, where the watchdog waits its warmup grace (10 x
# --span-timeout); flash-crowd's metrics run takes a seed whose hang comes
# after a span (4), so the phase pays that grace once
SERVICE_CHURN_CHAOS = "7"
SERVICE_METRICS_CHAOS = "4"
# the event-stream fuzzer and the theory-scored validator: the reference's
# nightly corpus (benchmarks/fuzz_bench.py:83) with plan parity, the backend
# matrix, fuzzed supervised chaos and the validator's corpora, each over
# these seeds; the backends of the matrix (plus "sharded" over a one-rank
# NCCL group); the fuzz harness's PARAM_TOL-held first span, card against
# CPU, on FUZZ_CPU_SEED's case
FUZZ_SEEDS = 64
FUZZ_MATRIX_SEEDS = 8
FUZZ_CHAOS_SEEDS = 6
VALIDATE_SEEDS = 4
VALIDATE_INT8_SEEDS = 1
FUZZ_BACKENDS = ("client_parallel", "client_sequential", "quantized",
                 "quantized_sequential", "banked")
FUZZ_CPU_SEED = 3
# the reference's quickstart (examples/quickstart.py): SYNTHETIC(1, 1), 20
# clients, logreg, scheme C, E 5, B 20, eta0 1.0, 50 rounds, eval every 5;
# its accuracy after 50 rounds as the verify notes give it, and how far the
# card's may lie from the CPU's
QUICKSTART = dict(n_clients=20, local_epochs=5, batch_size=20, eta0=1.0,
                  rounds=50, eval_every=5)
QUICKSTART_NOTED_ACC = 0.87
QUICKSTART_ACC_TOL = 0.02
# one teacher-forced row per table, card against the port on the CPU: (label,
# table, trainer arguments, rounds, eval_every)
TEACHER_FORCED = (
    [(f"table3 synthetic niid |T|=8 scheme {s}", "table3",
      ("synthetic", True, 8, s), 60, 5) for s in "ABC"]
    + [(f"table4 tau0=10 fast_reboot={f}", "table4", (10, f), 70, 1)
       for f in (True, False)]
    + [(f"table5 (1.0, 1.0) tau0=10 {p}", "table5", (1.0, 1.0, 10, p), 70, 1)
       for p in ("include", "exclude")])


def log(*args) -> None:
    print(*args, flush=True)


def import_port():
    src = ROOT / "src"
    if not (src / "repro_torch" / "__init__.py").is_file():
        raise SystemExit(f"chip_smoke.py: no src/repro_torch beside "
                         f"{Path(__file__).name}; run it from the root of a "
                         f"checkout of the repository")
    sys.path.insert(0, str(src))


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def ptxas_summary(report: str):
    """One line per kernel of nvcc's -Xptxas -v report: its name, then its
    spills, registers and shared memory."""
    name, spills, lines = None, "", []
    for line in report.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            try:
                name = subprocess.run(["c++filt", name], capture_output=True,
                                      text=True, timeout=10).stdout.strip()
            except (OSError, subprocess.SubprocessError):
                pass
        elif "spill" in line:
            spills = line.strip()
        elif "registers" in line:
            lines.append(f"{name}: {spills}; "
                         f"{line.split(':', 1)[1].strip()}")
    return lines


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a.float() - b.float()).abs().max().item()


def expected_launches(**counts) -> dict:
    """Every kernel's launch count: those named, 0 for the others."""
    from repro_torch.kernels import ops
    return {name: counts.get(name, 0) for name in ops.launches}


def lm_leaves(dev, arch: str) -> dict:
    """Each leaf's element count and dtype in ``arch``'s full-width tree,
    in the order a round flattens it."""
    from repro_torch.configs import get_config
    from repro_torch.core.fed_step import flatten_tree
    from repro_torch.models.params import init_params
    params = init_params(get_config(arch), seed=0, device=dev)
    out = {name: (p.numel(), p.dtype)
           for name, p in flatten_tree(params).items()}
    del params
    torch.cuda.empty_cache()
    return out


# -- 3. each kernel against its plain version ---------------------------------
def check_weighted_agg(dev, D: int, lm_D: int) -> float:
    from repro_torch.kernels import ops
    from repro_torch.kernels.weighted_agg import padded, weighted_agg_plain
    gen = torch.Generator(device=dev).manual_seed(0)
    worst = 0.0
    # the main path's shape in f32 (D = 2 mod 4: the last vector of a row
    # is half pad) and bf16 (D = 6 mod 8); rows of whole vectors with no
    # pad, passed as a plain contiguous tensor; a tail of 3 columns; and
    # K > 64 (the reference's K-tiled layout); then the paper tables'
    # rounds; then fed_train's round at full width: TRAIN_ARCH's flat
    # (capacity, lm_D) f32 buffer, more than 2^31 bytes
    for K, n, dtype in [(N_CLIENTS, D, torch.float32),
                        (N_CLIENTS, D, torch.bfloat16),
                        (N_CLIENTS, D + 2, torch.float32),
                        (N_CLIENTS, D + 1, torch.float32),
                        (100, D, torch.float32)] + [
                            (K, n, torch.float32) for K, n in TABLE_AGG] + [
                            (FED_TRAIN_CAPACITY, lm_D, torch.float32)]:
        c = torch.rand(K, device=dev, generator=gen)
        c[::7] = 0.0                          # clients with no work
        d = padded(torch.randn(K, n, device=dev, generator=gen).to(dtype))
        if n % 4 == 0:
            d = d.contiguous()
        got = ops.weighted_agg(c, d)
        want = weighted_agg_plain(c, d)
        torch.cuda.synchronize()
        tol = ops.TOLERANCE["weighted_agg"][dtype]
        err = max_abs_err(got, want)
        log(f"  weighted_agg K={K} D={n} {dtype}: max_abs_err {err:.3e} "
            f"(rtol {tol['rtol']:g}, atol {tol['atol']:g})")
        torch.testing.assert_close(got, want, **tol)
        worst = max(worst, err)
        del c, d, got, want
    torch.cuda.empty_cache()
    return worst


def check_masked_sgd(dev, leaves, paper_leaves, train_leaves) -> float:
    from repro_torch.kernels import ops
    from repro_torch.kernels.masked_sgd import masked_sgd_plain
    gen = torch.Generator(device=dev).manual_seed(1)
    tol = ops.TOLERANCE["masked_sgd"][torch.float32]
    worst = 0.0
    D = sum(leaves.values())
    # one local step's launches: every leaf as (clients, n) with a scale
    # per client (zeros: masked steps), then the Pallas kernel's scalar
    # form, then the client-sequential round's: every leaf of each paper
    # model as one row
    cases = [(name, (N_CLIENTS, n)) for name, n in leaves.items()]
    cases.append(("scalar form", (D,)))
    cases += [(f"{kind} {name}", (1, n))
              for kind, model in paper_leaves.items()
              for name, n in model.items()]
    for name, shape in cases:
        w = torch.randn(*shape, device=dev, generator=gen)
        g = torch.randn(*shape, device=dev, generator=gen)
        rows = shape[0] if len(shape) == 2 else 1
        s = 5e-4 * (torch.rand(rows, device=dev, generator=gen) < 0.8)
        got = ops.masked_sgd(w.clone(), g, s)
        want = masked_sgd_plain(w.clone(), g, s)
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        log(f"  masked_sgd {name} {tuple(shape)} f32: max_abs_err {err:.3e} "
            f"(rtol {tol['rtol']:g}, atol {tol['atol']:g})")
        torch.testing.assert_close(got, want, **tol)
        worst = max(worst, err)
    # the LM round's launches (step 9d): every leaf of TRAIN_ARCH at full
    # width in its own dtype (bf16; f32 for the norms' scales and the
    # SSM's A_log, D, dt_bias) as (clients, n), compared by the change
    # w_new - w, at training's 4 clients and at fed_train's capacity rows.
    # At the round's own scale (eta0 0.05, gradients far below w) the
    # change is below bf16's resolution of w at most elements, so a kernel
    # that dropped it would pass a comparison of w_new: here the gradient
    # is drawn 20x w's scale, so that the change (scale 0.05) is as large
    # as w, and the run fails unless a dropped update would fail
    for C, (name, (n, dtype)) in itertools.product(
            (TRAIN_SHAPE["n_clients"], FED_TRAIN_CAPACITY),
            train_leaves.items()):
        tol = ops.TOLERANCE["masked_sgd"][dtype]
        w = torch.randn(C, n, device=dev, generator=gen).to(dtype)
        g = (20 * torch.randn(C, n, device=dev, generator=gen)).to(dtype)
        s = 0.05 * (torch.rand(C, device=dev, generator=gen) < 0.8)
        s[0] = 0.05                           # at least one live client
        got = ops.masked_sgd(w.clone(), g, s).float() - w.float()
        want = masked_sgd_plain(w.clone(), g, s).float() - w.float()
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        caught = (~torch.isclose(torch.zeros_like(want), want, **tol))
        caught = caught[s > 0].float().mean().item()
        log(f"  masked_sgd {TRAIN_ARCH} {name} ({C}, {n}) {dtype}, "
            f"the change w_new - w: max_abs_err {err:.3e} (rtol "
            f"{tol['rtol']:g}, atol {tol['atol']:g}); a dropped update "
            f"fails at {caught:.4f} of the live rows' elements")
        torch.testing.assert_close(got, want, **tol)
        if caught < 0.9:
            raise RuntimeError(f"masked_sgd {name} {dtype}: a dropped update "
                               f"would fail at only {caught:.4f} of the "
                               f"elements")
        worst = max(worst, err)
        del w, g, got, want
    return worst


def _qkv(dev, gen, B, H, KV, S, hd, dtype):
    """q, k, v in the model's layout: transposed views of (B, S, heads, hd)
    projections, as ``gqa_attention`` hands them to the kernel."""
    return [torch.randn(B, S, n, hd, device=dev, generator=gen).to(dtype)
            .transpose(1, 2) for n in (H, KV, KV)]


def start_planted_fault(name: str, fault, sites: int = 1,
                        tag: str = "planted_fault"):
    """Starts nvcc on csrc/<name>.cu with ``fault`` (old, new) planted at
    each of its ``sites``, into lib<name>_<tag>.so; returns the library's
    path and the compile."""
    from repro_torch.kernels import build
    text = (build.CSRC / f"{name}.cu").read_text()
    if text.count(fault[0]) != sites:
        raise RuntimeError(f"the planted fault's line is not in {name}.cu "
                           f"{sites} time(s)")
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = build.BUILD_DIR / f"{name}_{tag}.cu"
    src.write_text(text.replace(*fault))
    target = src.with_name(f"lib{name}_{tag}.so")
    return target, build.compile_source(src, target)


def finish_planted_fault(target, proc, signatures):
    from repro_torch.kernels import build
    report = proc.communicate()[0]
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on the planted fault:\n{report}")
    return build.open_library(target, signatures)


def f32_reference(q, k, v, causal):
    """The same attention computed in f32; returns the function that
    measures an output against it, in units of its bf16 bound (see
    BF16_UNIT), and the median |o| and A."""
    from repro_torch.kernels.flash_attention import flash_attention_plain
    qf, kf, vf = q.float(), k.float(), v.float()
    o32 = flash_attention_plain(qf, kf, vf, causal)
    bound = flash_attention_plain(qf, kf, vf.abs(), causal)
    medians = (o32.abs().median().item(), bound.median().item())
    bound = bound.add_(o32.abs()).mul_(BF16_UNIT)
    del qf, kf, vf

    def excess(o):
        return ((o.float() - o32).abs_() / bound).max().item()
    return excess, medians


def check_flash_attention(dev, planted) -> float:
    from repro_torch.kernels import ops
    from repro_torch.kernels import flash_attention as fa
    gen = torch.Generator(device=dev).manual_seed(4)
    worst = 0.0
    # the serving shapes, nemotron's, gemma's, llava's (with its patches)
    # and musicgen's, where the planted fault must fail both bounds
    mains = [(*FLASH_MAIN, torch.bfloat16, True),
             (*FLASH_GEMMA, torch.bfloat16, True),
             (*FLASH_LLAVA, torch.bfloat16, True),
             (*FLASH_MUSICGEN, torch.bfloat16, True)]
    for B, H, KV, S, hd, dtype, causal in mains + FLASH_EDGES:
        q, k, v = _qkv(dev, gen, B, H, KV, S, hd, dtype)
        got = ops.flash_attention(q, k, v, causal=causal)
        want = fa.flash_attention_plain(q, k, v, causal)
        torch.cuda.synchronize()
        tol = ops.TOLERANCE["flash_attention"][dtype]
        err = max_abs_err(got, want)
        log(f"  flash_attention B={B} H={H} KV={KV} S={S} hd={hd} {dtype} "
            f"causal={causal}: max_abs_err {err:.3e} against the plain "
            f"version (rtol {tol['rtol']:g}, atol {tol['atol']:g})")
        torch.testing.assert_close(got, want, **tol)
        worst = max(worst, err)
        if dtype == torch.bfloat16:
            excess, (med_o, med_a) = f32_reference(q, k, v, causal)
            x_got, x_plain = excess(got), excess(want)
            log(f"    against attention in f32 (median |o| {med_o:.3e}, "
                f"median A {med_a:.3e}): max |o - o32| / (2^-8 (|o32| + A)) "
                f"kernel {x_got:.4f}, plain version {x_plain:.4f}, bound "
                f"{BF16_SLACK:g} for the kernel")
            if x_got > BF16_SLACK:
                raise RuntimeError("flash_attention is off its bf16 bound "
                                   "against attention in f32")
            if (B, H, KV, S, hd, dtype, causal) in mains:
                bad = fa.launch(q, k, v, causal, lib=planted)
                x_bad = excess(bad)
                tol_ok = torch.allclose(bad.float(), want.float(), **tol)
                log(f"    planted fault (first KV tile skipped): {x_bad:.4f} "
                    f"of the bound; {'within' if tol_ok else 'outside'} "
                    f"ops.TOLERANCE against the plain version")
                if x_bad <= BF16_SLACK:
                    raise RuntimeError("the bf16 bound does not see the "
                                       "planted fault")
                del bad
            del excess
        del q, k, v, got, want
        torch.cuda.empty_cache()
    return worst


def quantized(dev, gen, K, D, chunk, levels, wider: int = 0):
    """coeffs (some 0) and quantize_chunked's payload and scales of seeded
    normal deltas (some rows all zero); the payload's rows `wider` bytes
    further apart than quantize_chunked lays them."""
    from repro_torch.core.compression import quantize_chunked
    c = torch.rand(K, device=dev, generator=gen)
    c[::7] = 0.0                              # clients with no work
    d = torch.randn(K, D, device=dev, generator=gen) * 1e-2
    d[1::5] = 0.0                             # all-zero rows: scales 0
    payload, scales = quantize_chunked(d, chunk=chunk, levels=levels)
    if wider:
        rows = torch.zeros(K, payload.stride(0) + wider, dtype=torch.int8,
                           device=dev)
        rows[:, :payload.shape[1]] = payload
        payload = rows[:, :payload.shape[1]]
    return c, payload, scales


def check_weighted_agg_quant(dev, D: int, lm_D: int, planted,
                             planted_ring) -> float:
    """The kernel equals its plain version at the int8 wire's shape, at
    fed_train's int8 round at full width (TRAIN_ARCH's flat (capacity,
    lm_D) buffer, QUANT_CHUNK) and at the edge shapes, which between them
    take every path to the scales and several row boxes a tile; the
    planted faults must differ: the tile's first chunk at chunk 100, the
    previous ring place at K > 256 and at both wires' shapes."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import weighted_agg as agg
    gen = torch.Generator(device=dev).manual_seed(6)
    worst, paths, boxes = 0.0, set(), set()
    lm = (FED_TRAIN_CAPACITY, lm_D, QUANT_CHUNK, 127, 0)
    for K, n, chunk, levels, wider in [QUANT_MAIN, lm] + QUANT_EDGES:
        n = n or D
        c, payload, scales = quantized(dev, gen, K, n, chunk, levels, wider)
        plan = agg.quant_plan(payload, scales, chunk)
        if plan["boxes"] != -(-K // plan["rows"]):
            raise RuntimeError(f"weighted_agg_quant's plan {plan} does not "
                               f"cover K={K} rows")
        paths.add(plan["path"])
        boxes.add(plan["boxes"])
        got = ops.weighted_agg_quant(c, payload, scales, chunk=chunk)
        want = agg.weighted_agg_quant_plain(c, payload, scales, chunk)
        bad = agg.launch_quant(c, payload, scales, chunk, lib=planted)
        bad_ring = agg.launch_quant(c, payload, scales, chunk,
                                    lib=planted_ring)
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        log(f"  weighted_agg_quant K={K} D={n} chunk={chunk} "
            f"levels={levels}: Dp {payload.shape[1]}, payload row stride "
            f"{payload.stride(0)}, plan {plan}, max_abs_err {err:.3e} "
            f"against the plain version (must be 0); planted faults: first "
            f"chunk {max_abs_err(bad, want):.3e}, previous place "
            f"{max_abs_err(bad_ring, want):.3e}")
        if not torch.equal(got, want):
            raise RuntimeError("weighted_agg_quant differs from its plain "
                               "version")
        if chunk == 100 and torch.equal(bad, want):
            raise RuntimeError("the check does not see the planted fault "
                               "at chunk 100")
        if (K > 256 or (K, n, chunk) in ((N_CLIENTS, D, QUANT_CHUNK),
                                         lm[:3])) \
                and torch.equal(bad_ring, want):
            raise RuntimeError(f"the check does not see the ring's planted "
                               f"fault at K={K} D={n}")
        worst = max(worst, err)
        del c, payload, scales, got, want, bad, bad_ring
        torch.cuda.empty_cache()
    log(f"  weighted_agg_quant paths reached: {sorted(paths)}, boxes a "
        f"tile: {sorted(boxes)}")
    if paths != {"staged", "per-code"} or max(boxes) < 2:
        raise RuntimeError("the edge shapes do not reach every path of the "
                           "weighted_agg_quant kernel")
    return worst


def check_quant_memory(dev, D: int) -> None:
    """One launch at the int8 wire's shape raises the memory high-water
    mark by no more than its (Dp,) f32 output plus 1 MiB: the dequantized
    (K, Dp) deltas never exist in device memory."""
    from repro_torch.kernels import ops
    gen = torch.Generator(device=dev).manual_seed(7)
    c, payload, scales = quantized(dev, gen, N_CLIENTS, D, QUANT_CHUNK, 127)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    ops.weighted_agg_quant(c, payload, scales, chunk=QUANT_CHUNK)
    torch.cuda.synchronize()
    rise = torch.cuda.max_memory_allocated(dev) - base
    limit = 4 * payload.shape[1] + 2 ** 20
    log(f"  weighted_agg_quant memory: one launch at ({N_CLIENTS}, "
        f"{payload.shape[1]}) raised the high-water mark by {rise} bytes "
        f"(limit {limit}: the output plus 1 MiB; dequantized deltas would "
        f"add {4 * payload.numel()})")
    if rise > limit:
        raise RuntimeError("weighted_agg_quant allocated more than its "
                           "output")


def ssd_inputs(dev, gen, G, Q, N, P, dtype, heads: int = 0):
    """cum from mamba2's step sizes and decay rates (dt log-uniform in
    [1e-3, 1e-1] per position, A in [-16, -1] per cell), so that above the
    diagonal cum_i - cum_j overflows exp in many cells; C, B and xdt normal.
    With ``heads``, the model's layout: cells (G, heads), C and B of the
    cell's group expanded over its heads (stride 0), xdt the (G, heads, Q,
    P) view of a (G, Q, heads, P) buffer."""
    cells = (G, heads) if heads else (G,)
    n = G * max(heads, 1)
    dt = torch.exp(torch.empty(n, Q, device=dev).uniform_(
        math.log(1e-3), math.log(1e-1), generator=gen))
    A = -torch.empty(n, 1, device=dev).uniform_(1.0, 16.0, generator=gen)
    cum = torch.cumsum(dt * A, dim=-1).view(*cells, Q)
    if heads:
        C, B = (torch.randn(G, 1, Q, N, device=dev, generator=gen).to(dtype)
                .expand(G, heads, Q, N) for _ in range(2))
        xdt = torch.randn(G, Q, heads, P, device=dev, generator=gen) \
            .to(dtype).transpose(1, 2)
    else:
        C, B = (torch.randn(G, Q, N, device=dev, generator=gen).to(dtype)
                for _ in range(2))
        xdt = torch.randn(G, Q, P, device=dev, generator=gen).to(dtype)
    return cum, C, B, xdt


def ssd_bf16_reference(cum, C, B, xdt):
    """The function in f32 on the bf16 inputs; returns the function that
    measures an output against it in units of its bf16 bound (see SSD_FAULT's
    comment), and the Pallas body's arithmetic in plain PyTorch: the scores
    in f32, rounded to bf16, their product with xdt summed in f32."""
    Q, N = cum.shape[-1], C.shape[-1]
    diff = cum[..., :, None] - cum[..., None, :]
    mask = torch.ones(Q, Q, dtype=torch.bool, device=cum.device).tril()
    L = torch.where(mask, torch.exp(diff), 0.0)
    del diff
    Cf, Bf, xf = C.float(), B.float(), xdt.float()
    s = torch.einsum("...qn,...sn->...qs", Cf, Bf).mul_(L)
    y32 = s @ xf
    pallas = s.to(torch.bfloat16).float() @ xf
    bound = s.abs_() @ xf.abs()
    bound.mul_(2.0 ** -8).add_(
        (torch.einsum("...qn,...sn->...qs", Cf.abs(), Bf.abs()).mul_(L)
         @ xf.abs()).mul_((N + Q) * 2.0 ** -24))
    del s, L, Cf, Bf, xf

    def excess(o):
        return ((o - y32).abs_() / bound.clamp_min(1e-30)).max().item()
    return excess, pallas


def ssd_f32_reference(cum, C, B, xdt):
    """The function in f64; returns the function that measures an f32
    output against it in units of its f32 rounding bound, SSD_F32_BOUND."""
    Q, N = cum.shape[-1], C.shape[-1]
    cum = cum.double()
    d = cum[..., :, None] - cum[..., None, :]
    mask = torch.ones(Q, Q, dtype=torch.bool, device=cum.device).tril()
    L = torch.where(mask, torch.exp(torch.where(mask, d, 0.0)), 0.0)
    Cd, Bd, xd = C.double(), B.double(), xdt.double()
    y64 = (torch.einsum("...qn,...sn->...qs", Cd, Bd) * L) @ xd
    W = L * (N + Q + 8 + d.abs_())
    del d, L
    bound = (torch.einsum("...qn,...sn->...qs", Cd.abs(), Bd.abs()) * W) \
        @ xd.abs()
    bound.mul_(2.0 ** -24)
    del W, Cd, Bd, xd

    def excess(o):
        return ((o.double() - y64).abs_() / bound.clamp_min(1e-300)).max() \
            .item()
    return excess


def check_ssd_intra_chunk(dev, planted, planted_head) -> float:
    """The kernel against its plain version at the serving prefill's shape
    (f32, the model's layout) and the edge shapes; no NaN or inf; bf16 also
    against the function in f32 within its rounding bound, f32 also
    against the function in f64 within SSD_F32_BOUND.  The planted fault
    (SSD_FAULT) must fail ops.TOLERANCE and the rounding bound of its type
    wherever it skips a tile; SSD_HEAD_FAULT must fail ops.TOLERANCE at the
    serving shape.  Returns the serving shape's max abs error."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_chunk as sc
    from repro_torch.kernels import build
    gen = torch.Generator(device=dev).manual_seed(9)
    main_err = None
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    n_wg = build.load("ssd_intra_chunk", sc.SIGNATURES) \
        .ssd_intra_chunk_f32_warpgroups(SSD_P)
    cases = [SSD_MAIN] + SSD_HYMBA + [(g, 0, *rest) for g, *rest in SSD_EDGES]
    cases += [cases[-1]] * (SSD_BF16_DRAWS - 1)
    for G, heads, Q, N, P, dtype in cases:
        cum, C, B, xdt = ssd_inputs(dev, gen, G, Q, N, P, dtype, heads)
        got = ops.ssd_intra_chunk(cum, C, B, xdt)
        want = sc.ssd_intra_chunk_plain(cum, C, B, xdt)
        bad = sc.launch(cum, C, B, xdt, lib=planted)
        torch.cuda.synchronize()
        tol = ops.TOLERANCE["ssd_intra_chunk"][dtype]
        err = max_abs_err(got, want)
        top = (cum[..., 0] - cum[..., -1]).flatten()
        cells = f"({G}, {heads})" if heads else f"{G}"
        log(f"  ssd_intra_chunk cells {cells} Q={Q} N={N} P={P} {dtype}: "
            f"max_abs_err {err:.3e} against the plain version (rtol "
            f"{tol['rtol']:g}, atol {tol['atol']:g}), median |y| "
            f"{want.abs().median().item():.3e}; largest exponent above the "
            f"diagonal {top.max().item():.1f} ({int((top > 88.72).sum())} of "
            f"{top.numel()} cells overflow exp); planted fault "
            f"{max_abs_err(bad, want):.3e}")
        if not bool(torch.isfinite(got).all()):
            raise RuntimeError("ssd_intra_chunk wrote NaN or inf")
        tol_sees_fault = not torch.allclose(bad, want, **tol)
        if dtype == torch.bfloat16:
            excess, pallas = ssd_bf16_reference(cum, C, B, xdt)
            x_got, x_bad = excess(got), excess(bad)

            def outside(o):
                return int((~torch.isclose(o, want, **tol)).sum())
            log(f"    against the function in f32: max |y - y32| / (2^-8 A "
                f"+ (N + Q) 2^-24 A2) kernel {x_got:.4f} (bound 1), planted "
                f"fault {x_bad:.4f}; outside ops.TOLERANCE of the {got.numel()} "
                f"elements: kernel {outside(got)}, the Pallas body's "
                f"arithmetic in plain PyTorch {outside(pallas)}, planted fault "
                f"{outside(bad)}; kernel against that arithmetic "
                f"{max_abs_err(got, pallas):.3e}")
            if x_got > 1.0:
                raise RuntimeError("ssd_intra_chunk is off its bf16 bound")
            if x_bad <= 1.0:
                raise RuntimeError("the bf16 bound does not see the planted "
                                   "fault")
            del excess, pallas
        else:
            excess = ssd_f32_reference(cum, C, B, xdt)
            x_got, x_bad = excess(got), excess(bad)
            log(f"    against the function in f64: max |y - y64| / "
                f"SSD_F32_BOUND kernel {x_got:.4f} (bound 1), plain version "
                f"{excess(want):.4f}, planted fault {x_bad:.4f}")
            if x_got > 1.0:
                raise RuntimeError("ssd_intra_chunk is off its f32 bound")
            if Q > 64 and x_bad <= 1.0:
                raise RuntimeError("the f32 bound does not see the planted "
                                   "fault")
            del excess
        # ops.TOLERANCE (the reference suite's) in f32, and in bf16 at the
        # reference suite's sizes; the bf16 rounding of the scores alone
        # (the Pallas body's own arithmetic) leaves it at the serving cell
        # count, where the bound above holds the kernel
        if dtype == torch.float32 or Q <= 128:
            torch.testing.assert_close(got, want, **tol)
            if Q > 64 and not tol_sees_fault:
                raise RuntimeError("ops.TOLERANCE does not see the planted "
                                   "fault")
        if (G, heads, Q, N, P, dtype) == SSD_MAIN:
            main_err = err
        if heads:
            per_cta = sc.heads_per_cta(G, heads, Q, sc.group_shared(C, B),
                                       n_sm, n_wg)
            bad_head = sc.launch(cum, C, B, xdt, lib=planted_head)
            log(f"    {per_cta} heads per CTA ({-(-heads // per_cta)} blocks, "
                f"the last of {heads - (-(-heads // per_cta) - 1) * per_cta}); "
                f"planted fault with every head of a CTA staged from "
                f"its first head: {max_abs_err(bad_head, want):.3e}; "
                f"the first key tile skipped: {max_abs_err(bad, want):.3e}")
            if torch.allclose(bad_head, want, **tol):
                raise RuntimeError(f"ops.TOLERANCE does not see the planted "
                                   f"head fault at cells ({G}, {heads})")
            del bad_head
        del cum, C, B, xdt, got, want, bad
        torch.cuda.empty_cache()
    return main_err


# -- 4. the main path ---------------------------------------------------------
def make_clients(n_clients: int = N_CLIENTS, seed: int = 0):
    """The paper's EMNIST federation, synthetic and seeded: label-sorted
    non-IID shards with Pareto sample counts, a Table-2 trace per client,
    the last client arriving at TAU_ARRIVE and client 3 leaving at
    TAU_DEPART under the exclude policy."""
    from repro_torch.configs.paper import EMNIST_CNN
    from repro_torch.core.participation import TRACES
    from repro_torch.data import label_sorted_partition, make_class_dataset
    from repro_torch.fed import Client
    x, y = make_class_dataset(EMNIST_CNN.n_classes, 100, seed=seed)
    x = x[..., None]                                  # (N, 28, 28, 1)
    train, test = label_sorted_partition(x, y, n_clients, seed=seed)
    rng = np.random.default_rng(seed)
    clients = [Client(x=tr[0], y=tr[1], trace=TRACES[rng.integers(0, 8)],
                      x_test=te[0], y_test=te[1])
               for tr, te in zip(train, test)]
    clients[-1].active_from = TAU_ARRIVE
    clients[3].departs_at = TAU_DEPART
    clients[3].departure_policy = "exclude"
    return clients


def emnist_eval(params, x, y):
    """The EMNIST CNN's held-out loss and accuracy."""
    from repro_torch.configs.paper import EMNIST_CNN as cfg
    from repro_torch.models.small import logits_small
    ll = torch.log_softmax(logits_small(params, cfg, x), -1)
    loss = -ll.gather(1, y[:, None].long()).mean()
    return float(loss), float((ll.argmax(-1) == y).float().mean())


def make_trainer(clients, device, agg: str = "auto", compression=None,
                 sharding=None, mode: str = "client_parallel",
                 engine: str = "plan"):
    from repro_torch.configs.paper import EMNIST_CNN as cfg
    from repro_torch.fed import FederatedTrainer
    from repro_torch.models.small import init_small, make_loss_fn
    return FederatedTrainer(
        loss_fn=make_loss_fn(cfg), eval_fn=emnist_eval,
        init_params=init_small(cfg, seed=0, device=device), clients=clients,
        local_epochs=cfg.local_epochs, batch_size=cfg.batch_size,
        scheme="C", eta0=cfg.eta0, seed=0, engine=engine, agg=agg,
        compression=compression, device=device, model_kind=cfg.kind,
        sharding=sharding, mode=mode)


def check_history(history) -> None:
    events = "".join(h.event for h in history)
    if "arrival:" not in events or "departure-exclude:" not in events:
        raise RuntimeError(f"the main path saw events {events!r}; expected "
                           f"an arrival and an excluding departure")
    evals = [h for h in history if not math.isnan(h.loss)]
    if len(evals) < ROUNDS // EVAL_EVERY:
        raise RuntimeError(f"{len(evals)} eval rounds in {ROUNDS}")
    if not all(math.isfinite(h.loss) and math.isfinite(h.acc)
               for h in evals):
        raise RuntimeError("non-finite eval loss on the main path")


def same_records(a, b) -> bool:
    """Two RoundRecords with equal tau, eta, n_active, event and s."""
    return ((a.tau, a.eta, a.n_active, a.event)
            == (b.tau, b.eta, b.n_active, b.event)
            and np.array_equal(a.s, b.s))


def compare_with_plain(card, plain) -> float:
    """The card's run against the same run on the CPU: equal records,
    eval losses within LOSS_RTOL and parameters within PARAM_TOL."""
    for a, b in zip(card.history, plain.history, strict=True):
        if not same_records(a, b):
            raise RuntimeError(f"round records differ at tau={a.tau}")
        if math.isnan(a.loss) != math.isnan(b.loss) or (
                not math.isnan(a.loss)
                and abs(a.loss - b.loss) > LOSS_RTOL * abs(b.loss)):
            raise RuntimeError(f"eval loss {a.loss} on the card, {b.loss} "
                               f"on the CPU at tau={a.tau}")
    worst = 0.0
    for name, p in plain.params.items():
        got = card.params[name].cpu()
        worst = max(worst, max_abs_err(got, p))
        torch.testing.assert_close(got, p, **PARAM_TOL, msg=name)
    return worst


def profile_card(label: str, fn, baseline=None, stats=None,
                 device_only: bool = False) -> dict:
    """Kernel time by name over one call of fn, and the card's busy share:
    the union of kernel intervals over the host's wall time.  Returns
    {name: (us, launches)}; with a ``baseline`` of that form it also prints
    each kernel whose time differs from the baseline's by 50 us or more.
    A ``stats`` dict receives the busy share and the wall ms.
    ``device_only`` records the card's activity alone, not the host's
    operators: a call of tens of thousands of operators costs the
    profiler tens of seconds to read back otherwise."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    activities = [ProfilerActivity.CUDA]
    if not device_only:
        activities.append(ProfilerActivity.CPU)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        # the profile only reports where the time goes; the phases above
        # hold the path and the kernels
        log(f"  profile of {label}: the profiler recorded no kernel on the "
            f"card, no breakdown")
        return {}
    by_name = {}
    for e in kernels:
        t, c = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us(), c + 1)
    busy, end = 0.0, -math.inf
    for s, e in sorted((k.time_range.start, k.time_range.end)
                       for k in kernels):
        busy += max(0.0, e - max(s, end))
        end = max(end, e)
    total = sum(t for t, _ in by_name.values())
    if stats is not None:
        stats.update(busy=busy / wall_us, wall_ms=wall_us / 1e3)
    log(f"  profile of {label}: wall {wall_us / 1e3:.3f} ms under "
        f"the profiler, kernels {total / 1e3:.3f} ms summed, "
        f"{busy / 1e3:.3f} ms busy ({100 * busy / wall_us:.1f}% of wall)")
    for name, (t, c) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]:
        log(f"    {t / 1e3:9.3f} ms {c:6d}x  {name[:100]}")
    if baseline:
        log(f"    against the baseline's kernels (time and launches here "
            f"minus there, 50 us or more):")
        for name in sorted(set(by_name) | set(baseline),
                           key=lambda n: -abs(by_name.get(n, (0, 0))[0]
                                              - baseline.get(n, (0, 0))[0])):
            (t, c), (t0, c0) = by_name.get(name, (0, 0)), \
                baseline.get(name, (0, 0))
            if abs(t - t0) >= 50:
                log(f"    {(t - t0) / 1e3:+9.3f} ms {c - c0:+6d}x  "
                    f"{name[:100]}")
    return by_name


def main_path(dev):
    from repro_torch.kernels import ops
    clients = make_clients()
    trainer = make_trainer(clients, dev)
    C, E = len(clients), trainer.E
    n_leaves = len(trainer.params)
    D = sum(p.numel() for p in trainer.params.values())
    log(f"main path: EMNIST CNN, {C} clients, D = {D} params in {n_leaves} "
        f"leaves, E={E}, B={trainer.B}, scheme {trainer.scheme}, "
        f"eta0={trainer.eta0:g}, plan engine, {ROUNDS} rounds")
    ops.reset_launches()
    t0 = time.perf_counter()
    trainer.run(ROUNDS, eval_every=EVAL_EVERY)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    launches = dict(ops.launches)
    for h in trainer.history:
        log(f"  tau={h.tau} loss={h.loss:.6f} acc={h.acc:.4f} eta={h.eta:.3e} "
            f"n_active={h.n_active} event={h.event!r}")
    want = expected_launches(weighted_agg=ROUNDS,
                             masked_sgd=ROUNDS * n_leaves * E)
    log(f"  launches {launches}, expected {want} (weighted_agg 1 per round, "
        f"masked_sgd {n_leaves} leaves x E={E} per round)")
    if launches != want:
        raise RuntimeError(f"launch counts {launches} != expected {want}")
    check_history(trainer.history)
    # the params after the main path's rounds, which the sharded round
    # must reproduce bit for bit
    first = {k: v.clone() for k, v in trainer.params.items()}

    t0 = time.perf_counter()
    plain = make_trainer(make_clients(), "cpu", agg="flat")
    plain.run(ROUNDS, eval_every=EVAL_EVERY)
    plain_s = time.perf_counter() - t0
    err = compare_with_plain(trainer, plain)
    log(f"  card against the plain path on the CPU ({plain_s:.1f} s): equal "
        f"round records, params max_abs_err {err:.3e} (rtol "
        f"{PARAM_TOL['rtol']:g}, atol {PARAM_TOL['atol']:g}), eval loss "
        f"rtol {LOSS_RTOL:g}")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.run(WARM_ROUNDS, eval_every=NO_EVAL)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    log(f"  rounds/s: {ROUNDS / cold_s:.3f} over the first {ROUNDS} rounds "
        f"(eval and first calls included), {WARM_ROUNDS / warm_s:.3f} over "
        f"{WARM_ROUNDS} warm rounds without eval")
    profile = profile_card(
        f"{PROFILED_ROUNDS} warm rounds",
        lambda: trainer.run(PROFILED_ROUNDS, eval_every=NO_EVAL))
    return trainer, launches, profile, first


# -- 5. device-mode sampling --------------------------------------------------
def make_device_trainer(device, agg: str = "auto", compression=None):
    """The main path's trainer with engine="device", DEVICE_SHIFT and
    DEVICE_BURST queued beside its arrival and departure."""
    from repro_torch.core.participation import TRACES
    from repro_torch.fed import InactivityBurst, TraceShift
    trainer = make_trainer(make_clients(), device, agg=agg,
                           compression=compression, engine="device")
    tau, client, trace = DEVICE_SHIFT
    start, duration, cohort = DEVICE_BURST
    trainer._stream_scheduler().push(
        TraceShift(tau, client_id=client, trace=TRACES[trace]),
        InactivityBurst(start, duration=duration, client_ids=cohort))
    return trainer


def check_device_events(history) -> None:
    """Both extra events applied, and the burst's cohort dark (s = 0) for
    exactly its rounds."""
    events = "".join(h.event for h in history)
    tau, client, _ = DEVICE_SHIFT
    start, duration, cohort = DEVICE_BURST
    want = [f"trace-shift:{client};",
            f"burst:{','.join(map(str, cohort))}@{duration};"]
    if not all(w in events for w in want):
        raise RuntimeError(f"device mode saw events {events!r}; expected "
                           f"{want} among them")
    s = np.stack([h.s for h in history])
    dark = s[start:start + duration][:, list(cohort)]
    if dark.any() or not s[start + duration:, list(cohort)].any():
        raise RuntimeError("the inactivity burst's cohort trained inside "
                           "its window or never after it")


class OneRoundSpans:
    """A trainer whose run(n) runs n spans of one round each: the cost a
    span pays once (the draw, the span arguments) paid every round, as at
    eval_every=1."""

    def __init__(self, trainer):
        self.trainer = trainer

    def run(self, n_rounds: int, eval_every: int) -> None:
        for _ in range(n_rounds):
            self.trainer.run(1, eval_every=eval_every)


def time_draw(trainer) -> tuple:
    """The device draw of the trainer's next DRAW_SPAN rounds alone
    (``RoundEngine.sample_span``), its second call under the profiler:
    the kernels it launched on the card and their summed device time in
    ms."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    sch = trainer._scheduler
    eng, st = sch.engine, sch.state
    active = sch._args(st.next_tau)["active"]
    eng.sample_span(st.key, st.next_tau, DRAW_SPAN, active)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        eng.sample_span(st.key, st.next_tau, DRAW_SPAN, active)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        raise RuntimeError("the profiler recorded no kernel of the draw")
    return len(kernels), sum(e.time_range.elapsed_us()
                             for e in kernels) / 1e3


def quickstart_trainer(device):
    """The reference's quickstart on the port: its clients and traces,
    from the reference's init_small(PRNGKey(0)) params."""
    from repro_torch.benchmarks.reference import reference_init
    from repro_torch.configs.paper import SYNTHETIC_LR as cfg
    from repro_torch.core.participation import TRACES
    from repro_torch.data import synthetic_federation
    from repro_torch.fed import Client, FederatedTrainer
    from repro_torch.models.small import logits_small, make_loss_fn
    q = QUICKSTART
    train, test = synthetic_federation(1.0, 1.0, q["n_clients"], seed=0)
    rng = np.random.default_rng(0)
    clients = [Client(x=tr[0], y=tr[1], trace=TRACES[rng.integers(0, 8)],
                      x_test=te[0], y_test=te[1])
               for tr, te in zip(train, test)]

    def eval_fn(params, x, y):
        ll = torch.log_softmax(logits_small(params, cfg, x), -1)
        loss = -ll.gather(1, y[:, None].long()).mean()
        return float(loss), float((ll.argmax(-1) == y).float().mean())

    return FederatedTrainer(
        loss_fn=make_loss_fn(cfg), eval_fn=eval_fn,
        init_params=reference_init(cfg, device), clients=clients,
        local_epochs=q["local_epochs"], batch_size=q["batch_size"],
        scheme="C", eta0=q["eta0"], seed=0, engine="device", device=device)


def quickstart_on_card(dev) -> None:
    """The quickstart on the card and on the CPU: equal round records,
    final accuracies within QUICKSTART_ACC_TOL, rounds/s."""
    q = QUICKSTART
    runs = {}
    for device in (dev, "cpu"):
        trainer = quickstart_trainer(device)
        if device != "cpu":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.run(q["rounds"], eval_every=q["eval_every"])
        if device != "cpu":
            torch.cuda.synchronize()
        runs[device] = (trainer, q["rounds"] / (time.perf_counter() - t0),
                        trainer.evaluate()[1])
    (card, card_rps, card_acc), (cpu, cpu_rps, cpu_acc) = runs.values()
    if not all(same_records(a, b)
               for a, b in zip(card.history, cpu.history, strict=True)):
        raise RuntimeError("the quickstart's round records differ between "
                           "the card and the CPU")
    log(f"  quickstart (SYNTHETIC(1, 1), {q['n_clients']} clients, logreg, "
        f"scheme C, E {q['local_epochs']}, B {q['batch_size']}, eta0 "
        f"{q['eta0']:g}, {q['rounds']} rounds, eval every "
        f"{q['eval_every']}): final accuracy {card_acc:.4f} on the card, "
        f"{cpu_acc:.4f} on the CPU (noted for the reference: "
        f"~{QUICKSTART_NOTED_ACC}); round records equal; "
        f"{card_rps:.3f} rounds/s on the card (first calls and evals "
        f"included), {cpu_rps:.3f} on the CPU")
    log("  accuracy by eval round, card: " + " ".join(
        f"{h.acc:.3f}" for h in card.history if not math.isnan(h.acc)))
    if not abs(card_acc - cpu_acc) <= QUICKSTART_ACC_TOL:
        raise RuntimeError(f"quickstart accuracy {card_acc} on the card, "
                           f"{cpu_acc} on the CPU")


def device_path(dev, plan_trainer, n_leaves: int, plan_profile) -> None:
    """engine="device" on the main path's federation (DEVICE_SHIFT and
    DEVICE_BURST added): launch counts, its events, round records equal to
    the same trainer's on the CPU (the draw bit for bit), params within
    PARAM_TOL of it, finite eval losses; warm rounds/s in turns with the
    plan trainer, a profile of two rounds and the draw's own launches and
    device time; the int8 wire's launches; the reference's quickstart."""
    from repro_torch.kernels import ops
    t_phase = time.perf_counter()
    trainer = make_device_trainer(dev)
    E = trainer.E
    log(f"device-mode round: engine='device' on the main path's federation, "
        f"TraceShift {DEVICE_SHIFT} and InactivityBurst {DEVICE_BURST} "
        f"added, {ROUNDS} rounds")
    ops.reset_launches()
    trainer.run(ROUNDS, eval_every=EVAL_EVERY)
    torch.cuda.synchronize()
    launches = dict(ops.launches)
    for h in trainer.history:
        log(f"  tau={h.tau} loss={h.loss:.6f} acc={h.acc:.4f} eta={h.eta:.3e} "
            f"n_active={h.n_active} event={h.event!r}")
    want = expected_launches(weighted_agg=ROUNDS,
                             masked_sgd=ROUNDS * n_leaves * E)
    log(f"  launches {launches}, expected {want}")
    if launches != want:
        raise RuntimeError(f"launch counts {launches} != expected {want}")
    check_history(trainer.history)
    check_device_events(trainer.history)
    if same_run(trainer.history, plan_trainer.history[:ROUNDS]):
        raise RuntimeError("device mode drew the plan's rounds")
    t0 = time.perf_counter()
    plain = make_device_trainer("cpu", agg="flat")
    plain.run(ROUNDS, eval_every=EVAL_EVERY)
    plain_s = time.perf_counter() - t0
    err = compare_with_plain(trainer, plain)
    log(f"  card against the same trainer on the CPU ({plain_s:.1f} s): "
        f"every round's s equal bit for bit, equal round records, params "
        f"max_abs_err {err:.3e} (rtol {PARAM_TOL['rtol']:g}, atol "
        f"{PARAM_TOL['atol']:g}), eval loss rtol {LOSS_RTOL:g}")
    del plain

    trainer.run(WARM_ROUNDS, eval_every=NO_EVAL)
    rounds_per_s_in_turns({"plan": plan_trainer, "device": trainer,
                           "plan, 1-round spans": OneRoundSpans(plan_trainer),
                           "device, 1-round spans": OneRoundSpans(trainer)})
    profile_card(f"{PROFILED_ROUNDS} warm device-mode rounds",
                 lambda: trainer.run(PROFILED_ROUNDS, eval_every=NO_EVAL),
                 baseline=plan_profile)
    draw_launches, draw_ms = time_draw(trainer)
    log(f"  the draw of a {DRAW_SPAN}-round span alone (sample_span: "
        f"fold_in on the host, split and two uniforms on the card): "
        f"{draw_launches} kernels, {draw_ms:.3f} ms of device time summed; "
        f"per round {draw_launches / DRAW_SPAN:.1f} kernels, "
        f"{draw_ms / DRAW_SPAN * 1e3:.1f} us")

    int8 = make_device_trainer(dev, compression="int8")
    ops.reset_launches()
    int8.run(DEVICE_INT8_ROUNDS, eval_every=EVAL_EVERY)
    torch.cuda.synchronize()
    int8_launches = dict(ops.launches)
    want = expected_launches(
        weighted_agg_quant=DEVICE_INT8_ROUNDS,
        masked_sgd=DEVICE_INT8_ROUNDS * n_leaves * E)
    log(f"  int8 wire, {DEVICE_INT8_ROUNDS} rounds: launches "
        f"{int8_launches}, expected {want}")
    if int8_launches != want:
        raise RuntimeError(f"launch counts {int8_launches} != expected "
                           f"{want}")
    if not all(same_records(a, b) for a, b in
               zip(int8.history, trainer.history[:DEVICE_INT8_ROUNDS],
                   strict=True)):
        raise RuntimeError("device mode on the int8 wire drew other rounds "
                           "than on f32")
    del int8
    quickstart_on_card(dev)
    log(f"  device-mode phase: {time.perf_counter() - t_phase:.1f} s")


# -- 6. the compressed round --------------------------------------------------
def compressed_path(dev, f32_trainer, n_leaves: int, f32_profile):
    """The trainer of the main path on each wire: launch counts, the f32
    run's round records, finite eval losses and wire bytes; profiles of two
    int8 and two int8-topk rounds against the f32 rounds', and warm
    rounds/s of every wire and f32 in turns.  Returns the int8 trainer,
    the kernels' launch counts over its run and its params after those
    rounds."""
    f32_history = f32_trainer.history
    from repro_torch.core.compression import wire_bytes
    from repro_torch.kernels import ops
    out = {}
    for wire, rounds in WIRE_ROUNDS.items():
        trainer = make_trainer(make_clients(), dev, compression=wire)
        E = trainer.E
        log(f"compressed round: compression={wire!r} "
            f"({trainer.compression.name}), {rounds} rounds")
        ops.reset_launches()
        trainer.run(rounds, eval_every=EVAL_EVERY)
        torch.cuda.synchronize()
        launches = dict(ops.launches)
        for h in trainer.history:
            log(f"  tau={h.tau} loss={h.loss:.6f} acc={h.acc:.4f} "
                f"eta={h.eta:.3e} n_active={h.n_active} event={h.event!r}")
        quantized = trainer.compression.quantized
        want = expected_launches(
            weighted_agg=0 if quantized else rounds,
            weighted_agg_quant=rounds if quantized else 0,
            masked_sgd=rounds * n_leaves * E)
        log(f"  launches {launches}, expected {want}")
        if launches != want:
            raise RuntimeError(f"launch counts {launches} != expected {want}")
        for a, b in zip(trainer.history, f32_history[:rounds], strict=True):
            if not same_records(a, b):
                raise RuntimeError(f"{wire}: round record at tau={a.tau} "
                                   f"differs from the f32 run's")
        evals = [h for h in trainer.history if not math.isnan(h.loss)]
        if not evals or not all(math.isfinite(h.loss) for h in evals):
            raise RuntimeError(f"{wire}: no finite eval loss")
        if rounds >= TAU_DEPART:
            check_history(trainer.history)
        log(f"  round records equal the f32 run's; eval losses finite")
        out[wire] = (trainer, launches,
                     {k: v.clone() for k, v in trainer.params.items()})
    D = sum(p.numel() for p in out["int8"][0].params.values())
    f32_bytes = wire_bytes(D, "none", n_clients=N_CLIENTS)
    log(f"wire bytes per round, {N_CLIENTS} clients of D = {D}: f32 "
        f"{f32_bytes}, "
        + ", ".join(f"{w} {wire_bytes(D, w, n_clients=N_CLIENTS)} "
                    f"({f32_bytes / wire_bytes(D, w, n_clients=N_CLIENTS):.3f}"
                    f"x fewer)" for w in WIRE_ROUNDS))
    # past the arrival and the departure (an event round evaluates) before
    # any window is timed or profiled
    for trainer, _, _ in out.values():
        trainer.run(WARM_ROUNDS, eval_every=NO_EVAL)
    rounds_per_s_in_turns(
        {"f32": f32_trainer, **{w: t for w, (t, _, _) in out.items()}})
    for wire in ("int8", "int8-topk"):
        trainer = out[wire][0]
        profile_card(f"{PROFILED_ROUNDS} warm {wire} rounds",
                     lambda: trainer.run(PROFILED_ROUNDS, eval_every=NO_EVAL),
                     baseline=f32_profile)
    return out["int8"]


def rounds_per_s_in_turns(trainers, rounds: int = WARM_ROUNDS) -> None:
    """Warm rounds/s of each trainer, ``rounds`` rounds without eval at a
    time, in the order given and then reversed, TURNS times over; prints
    each one's median and its ratio to the first one's."""
    order = list(trainers)
    times = {name: [] for name in order}
    for _ in range(TURNS):
        for name in order + order[::-1]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainers[name].run(rounds, eval_every=NO_EVAL)
            torch.cuda.synchronize()
            times[name].append(rounds / (time.perf_counter() - t0))
    first = float(np.median(times[order[0]]))
    log(f"warm rounds/s in turns ({2 * TURNS} windows of {rounds} "
        f"rounds each, median): "
        + ", ".join(f"{name} {np.median(r):.3f} "
                    f"({np.median(r) / first:.3f}x {order[0]})"
                    for name, r in times.items()))
    for name, r in times.items():
        log(f"  {name}: " + " ".join(f"{x:.3f}" for x in r))


def round_inputs(clients, E: int, B: int, seed: int = 1):
    """One round's inputs for every client, drawn with numpy as the host
    loop draws them: alpha (C, E) from each client's trace, E batches of B
    samples, and the data weights p over the clients' sample counts."""
    rng = np.random.default_rng(seed)
    C = len(clients)
    alpha = np.zeros((C, E), np.float32)
    x = np.zeros((C, E, B, *clients[0].x.shape[1:]), np.float32)
    y = np.zeros((C, E, B), np.int32)
    for i, cl in enumerate(clients):
        alpha[i] = np.arange(E) < cl.trace.sample_s(rng, E)
        idx = rng.integers(0, cl.n, size=(E, B))
        x[i], y[i] = cl.x[idx], cl.y[idx]
    n = np.array([cl.n for cl in clients], np.float64)
    return alpha, {"x": x, "y": y}, (n / n.sum()).astype(np.float32)


def bf16_spacing(x: torch.Tensor) -> torch.Tensor:
    """The distance between the two bf16 values around each f32 x (8
    significant bits: 2^(e-8) for |x| in [2^(e-1), 2^e)); 0 where x = 0,
    which the cast keeps exactly."""
    _, e = torch.frexp(x)
    return torch.ldexp(torch.ones_like(x), e - 8).masked_fill_(x == 0, 0.0)


def step_bound(spec, coeffs, flat_a, flat_b, inverse) -> torch.Tensor:
    """Per element d of the flat update, sum_k |c_k| * step_k(d): the most
    that one flipped rounding per client can move it when two sides
    quantize client deltas that agree to f32 noise.  int8: the larger of
    the two sides' scales of d's chunk, on the wire's buffers (flat_a,
    flat_b, in the reference's order) and taken back to the port's order by
    ``inverse``; bf16: the larger of the two sides' bf16 spacings at
    delta_k[d].  All on the CPU."""
    from repro_torch.core.compression import compress_flat
    c = coeffs.abs()
    D = flat_a.shape[1]
    if spec.quantized:
        scales = torch.maximum(compress_flat(flat_a, spec)[1],
                               compress_flat(flat_b, spec)[1])
        bound = (c @ scales).repeat_interleave(spec.chunk)[:D]
        return bound if inverse is None else bound[inverse.cpu()]
    return c @ torch.maximum(bf16_spacing(flat_a), bf16_spacing(flat_b))


def bit_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and torch.equal(a, b)


def wires_against_cpu(dev, params) -> None:
    """From ``params`` and one round's inputs, the local steps on the card
    and on the CPU; then the card's quantizer against the CPU's on the
    card's own deltas (payload, scales and top-k mask bit for bit), and one
    round's aggregation per wire on the card against the CPU's, each
    parameter within PARAM_TOL plus one code step per client
    (step_bound)."""
    from repro_torch.configs.paper import EMNIST_CNN as cfg
    from repro_torch.core.aggregation import (aggregate_deltas_flat,
                                              flatten_client_deltas,
                                              flatten_for_wire,
                                              scheme_coefficients)
    from repro_torch.core.compression import (compress_flat,
                                              resolve_compression, topk_mask)
    from repro_torch.core.fed_step import local_sgd
    from repro_torch.models.small import make_loss_fn
    E = cfg.local_epochs
    alpha, batches, p = round_inputs(make_clients(), E, cfg.batch_size)
    coeffs = scheme_coefficients("C", p, alpha.sum(1), E)
    sides = {}
    t0 = time.perf_counter()
    for side, d in (("card", dev), ("cpu", torch.device("cpu"))):
        start = {k: v.to(d, copy=True) for k, v in params.items()}
        deltas = local_sgd(
            make_loss_fn(cfg), start,
            {k: torch.from_numpy(v).to(d) for k, v in batches.items()},
            torch.from_numpy(alpha).to(d),
            torch.tensor(cfg.eta0, dtype=torch.float32, device=d))
        sides[side] = (start, deltas, coeffs.to(d))
    torch.cuda.synchronize()
    flat = {side: flatten_client_deltas(v[1]) for side, v in sides.items()}
    log(f"card against CPU, one round from the int8 run's params "
        f"({time.perf_counter() - t0:.1f} s for both sides' local steps): "
        f"deltas max_abs_err {max_abs_err(flat['card'].cpu(), flat['cpu']):.3e}")

    # the quantizer: the card's deltas, on the wire's buffer (the CNN's in
    # the reference's element order), quantized on the card and on the CPU
    wire_flat = {side: flatten_for_wire(v[0], v[1], resolve_compression(
        "int8"), cfg.kind) for side, v in sides.items()}
    card_deltas = wire_flat["card"][0].cpu()
    for wire in ("int8", "int8-topk"):
        spec = resolve_compression(wire)
        pc, sc = compress_flat(wire_flat["card"][0], spec)
        ph, sh = compress_flat(card_deltas, spec)
        same = bit_equal(pc.cpu(), ph) and bit_equal(sc.cpu(), sh)
        log(f"  quantizer {wire}: payload {tuple(pc.shape)} and scales "
            f"{tuple(sc.shape)} from the card's deltas, card against CPU: "
            f"{'bit-identical' if same else 'DIFFERENT'}")
        if not same:
            raise RuntimeError(f"the {wire} quantizer on the card differs "
                               f"from the CPU's")
    spec = resolve_compression("int8-topk")
    mc = topk_mask(wire_flat["card"][0], spec.topk_frac).cpu()
    mh = topk_mask(card_deltas, spec.topk_frac)
    log(f"  top-k mask (frac {spec.topk_frac:g}, {int(mh.sum())} kept), card "
        f"against CPU: "
        f"{'bit-identical' if torch.equal(mc, mh) else 'DIFFERENT'}")
    if not torch.equal(mc, mh):
        raise RuntimeError("the top-k mask on the card differs from the CPU's")

    # one round's aggregation per wire, card against CPU
    for wire in ("int8", "bf16"):
        spec = resolve_compression(wire)
        new = {}
        for side, (start, deltas, c) in sides.items():
            prm = aggregate_deltas_flat(
                {k: v.clone() for k, v in start.items()}, deltas, c,
                compression=spec, model_kind=cfg.kind)
            new[side] = torch.cat([prm[k].reshape(-1).cpu()
                                   for k in sorted(prm)])
        if spec.quantized:
            bound = step_bound(spec, coeffs, card_deltas,
                               wire_flat["cpu"][0], wire_flat["cpu"][1])
        else:
            bound = step_bound(spec, coeffs, flat["card"].cpu(), flat["cpu"],
                               None)
        diff = (new["card"] - new["cpu"]).abs()
        tol = PARAM_TOL["atol"] + PARAM_TOL["rtol"] * new["cpu"].abs()
        stepped = int((diff > tol).sum())
        log(f"  round on the {wire} wire, card against CPU: params "
            f"max_abs_err {diff.max().item():.3e}; {stepped} of "
            f"{diff.numel()} elements outside PARAM_TOL (rtol "
            f"{PARAM_TOL['rtol']:g}, atol {PARAM_TOL['atol']:g}) took the "
            f"one-step allowance (median step {bound.median().item():.3e}, "
            f"max {bound.max().item():.3e}); largest excess over PARAM_TOL "
            f"plus the step {(diff - tol - bound).max().item():.3e}")
        # f32 noise as in the f32 round, plus the flipped roundings
        if not bool((diff <= tol + bound).all()):
            raise RuntimeError(f"the {wire} round on the card is off the "
                               f"CPU's by more than PARAM_TOL plus one code "
                               f"step per client")


# -- 7. the sharded round -----------------------------------------------------
def same_run(a, b) -> bool:
    """Two histories with equal round records, eval losses and accuracies
    (NaN where no eval ran)."""
    return len(a) == len(b) and all(
        same_records(x, y) and np.array_equal([x.loss, x.acc],
                                              [y.loss, y.acc],
                                              equal_nan=True)
        for x, y in zip(a, b))


def sharded_path(dev, f32_trainer, f32_params, int8_trainer, int8_params,
                 n_leaves: int, D: int):
    """The main path's trainer with its client axis sharded over a
    one-rank NCCL group, on the f32 and int8 wires: launch counts, params
    and round records bit-identical to the unsharded runs'; warm rounds/s
    in turns with the unsharded trainers; both sharded kernels against
    their plain versions and timed.  The group is destroyed when the phase
    ends, failed or not.  Returns the launch counts of the two runs, the
    kernels' max_abs_err and their timings."""
    import torch.distributed as dist
    from repro_torch.fed import make_fed_sharding
    from repro_torch.kernels import ops
    init = ROOT / "build" / "sharded_round.pg"
    init.parent.mkdir(parents=True, exist_ok=True)
    init.unlink(missing_ok=True)
    dist.init_process_group("nccl", init_method=f"file://{init}", rank=0,
                            world_size=1)
    try:
        fs = make_fed_sharding()
        log(f"sharded round: the main path's trainer with sharding="
            f"make_fed_sharding() over {fs.n_shards} NCCL rank "
            f"(backend {dist.get_backend()}), {ROUNDS} rounds per wire")
        trainers, launches = {}, {}
        for wire, unsharded, first in ((None, f32_trainer, f32_params),
                                       ("int8", int8_trainer, int8_params)):
            name = wire or "f32"
            trainer = make_trainer(make_clients(), dev, compression=wire,
                                   sharding=fs)
            ops.reset_launches()
            trainer.run(ROUNDS, eval_every=EVAL_EVERY)
            torch.cuda.synchronize()
            launches[name] = dict(ops.launches)
            want = expected_launches(
                weighted_agg_sharded=0 if wire else ROUNDS,
                weighted_agg_quant_sharded=ROUNDS if wire else 0,
                masked_sgd=ROUNDS * n_leaves * trainer.E)
            log(f"  {name}: launches {launches[name]}, expected {want}")
            if launches[name] != want:
                raise RuntimeError(f"launch counts {launches[name]} != "
                                   f"expected {want}")
            check_history(trainer.history)
            if not same_run(trainer.history, unsharded.history[:ROUNDS]):
                raise RuntimeError(f"{name}: the sharded run's round records "
                                   f"differ from the unsharded run's")
            same = all(bit_equal(trainer.params[k], v)
                       for k, v in first.items())
            log(f"  {name}: params after {ROUNDS} rounds against the "
                f"unsharded run's: "
                f"{'bit-identical' if same else 'DIFFERENT'}; round records, "
                f"eval losses and accuracies equal")
            if not same:
                raise RuntimeError(f"{name}: the sharded run's params differ "
                                   f"from the unsharded run's")
            trainer.run(WARM_ROUNDS, eval_every=NO_EVAL)
            trainers[name] = trainer
        rounds_per_s_in_turns({"f32": f32_trainer,
                               "f32 sharded": trainers["f32"],
                               "int8": int8_trainer,
                               "int8 sharded": trainers["int8"]})
        del trainers
        errs = check_sharded_kernels(dev, D, fs)
        timings = time_sharded_kernels(dev, D, fs)
    finally:
        dist.destroy_process_group()
    return launches, errs, timings


def shifted_slab(rows: torch.Tensor) -> torch.Tensor:
    """The planted fault's slab: every row moved down by one (the last
    comes first), in the layout the kernels read."""
    from repro_torch.kernels.weighted_agg import padded
    return padded(torch.roll(rows, 1, 0))


def check_sharded_kernels(dev, D: int, fs) -> dict:
    """Both sharded kernels at the main path's 62-row slab, a 16-row slab
    (one of four ranks' share of 64 slots) and the reference's K 64, D 600
    against their plain versions within ops.TOLERANCE, and, one rank being
    the whole federation, bit-identical to the unsharded kernels; a planted
    fault (the wrapper reducing a shifted slab) must fail the tolerance."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import weighted_agg as agg
    gen = torch.Generator(device=dev).manual_seed(11)
    errs = {}
    cases = [(K, n or D, torch.float32) for K, n in SHARDED_SLABS]
    for K, n, dtype in cases + [(N_CLIENTS, D, torch.bfloat16)]:
        c = torch.rand(K, device=dev, generator=gen)
        c[::7] = 0.0
        d = agg.padded(torch.randn(K, n, device=dev, generator=gen).to(dtype))
        got = ops.weighted_agg_sharded(c, d, sharding=fs)
        want = agg.weighted_agg_sharded_plain(c, d, fs)
        unsharded = agg.launch(c, d)
        bad = fs.all_reduce(agg.launch(c, shifted_slab(d)))
        torch.cuda.synchronize()
        tol = ops.TOLERANCE["weighted_agg_sharded"][dtype]
        errs[("weighted_agg_sharded", K, n, dtype)] = _held(
            "weighted_agg_sharded", f"K={K} D={n} {dtype}", got, want,
            unsharded, bad, tol)
    for K, n, chunk in SHARDED_QUANT_SLABS:
        n = n or D
        c, payload, scales = quantized(dev, gen, K, n, chunk, 127)
        got = ops.weighted_agg_quant_sharded(c, payload, scales, chunk=chunk,
                                             sharding=fs)
        want = agg.weighted_agg_quant_sharded_plain(c, payload, scales, chunk,
                                                    fs)
        unsharded = agg.launch_quant(c, payload, scales, chunk)
        bad = fs.all_reduce(agg.launch_quant(
            c, shifted_slab(payload), torch.roll(scales, 1, 0), chunk))
        torch.cuda.synchronize()
        tol = ops.TOLERANCE["weighted_agg_quant_sharded"][torch.int8]
        errs[("weighted_agg_quant_sharded", K, n, chunk)] = _held(
            "weighted_agg_quant_sharded", f"K={K} D={n} chunk={chunk}", got,
            want, unsharded, bad, tol)
    return {name: max(e for k, e in errs.items() if k[0] == name)
            for name in ("weighted_agg_sharded",
                         "weighted_agg_quant_sharded")}


def _held(name: str, shape: str, got, want, unsharded, bad, tol) -> float:
    err = max_abs_err(got, want)
    same = bit_equal(got, unsharded)
    log(f"  {name} {shape}: max_abs_err {err:.3e} against the plain version "
        f"(rtol {tol['rtol']:g}, atol {tol['atol']:g}), "
        f"{'bit-identical to' if same else 'DIFFERENT from'} the unsharded "
        f"kernel; planted fault {max_abs_err(bad, want):.3e}")
    torch.testing.assert_close(got, want, **tol)
    if not same:
        raise RuntimeError(f"{name} on one rank differs from the unsharded "
                           f"kernel")
    try:
        torch.testing.assert_close(bad, want, **tol)
    except AssertionError:
        return err
    raise RuntimeError(f"the check of {name} does not see the planted fault")


# -- 8. the paper's experiments ----------------------------------------------
def flat_params(params) -> torch.Tensor:
    return torch.cat([params[k].reshape(-1) for k in sorted(params)])


def sequential_reference_scenario(dev) -> None:
    """The reference's own scenario of its int8 modes' invariant, in plan
    mode (device-mode sampling is the reference's alone): the int8
    client-sequential trainer's params and round records bit-identical to
    the int8 client-parallel trainer's on the flat path; the same on the
    f32 wire is printed, not required."""
    from repro_torch.benchmarks.reference import reference_init
    from repro_torch.configs.paper import SYNTHETIC_LR as cfg
    from repro_torch.core.participation import TRACES
    from repro_torch.data import synthetic_federation
    from repro_torch.fed import Client, FederatedTrainer
    from repro_torch.models.small import make_loss_fn
    sc = SEQ_SCENARIO
    train, test = synthetic_federation(0.5, 0.5, sc["n_clients"], seed=0)
    log(f"client-sequential round, the reference's scenario: logreg, "
        f"{sc['n_clients']} clients, E={sc['local_epochs']}, "
        f"B={sc['batch_size']}, scheme C, eta0={sc['eta0']:g}, "
        f"{sc['rounds']} rounds, plan engine, the reference's init")
    for wire in ("int8", None):
        runs = {}
        for mode, agg in (("client_parallel", "flat"),
                          ("client_sequential", "auto")):
            rng = np.random.default_rng(0)
            clients = [Client(x=tr[0], y=tr[1],
                              trace=TRACES[rng.integers(0, 8)],
                              x_test=te[0], y_test=te[1])
                       for tr, te in zip(train, test)]
            runs[mode] = FederatedTrainer(
                loss_fn=make_loss_fn(cfg),
                init_params=reference_init(cfg, dev), clients=clients,
                local_epochs=sc["local_epochs"], batch_size=sc["batch_size"],
                scheme="C", eta0=sc["eta0"], seed=0, engine="plan", agg=agg,
                compression=wire, device=dev, model_kind=cfg.kind,
                mode=mode)
            runs[mode].run(sc["rounds"], eval_every=sc["eval_every"])
        par, seq = runs["client_parallel"], runs["client_sequential"]
        records = all(same_records(a, b) for a, b in
                      zip(seq.history, par.history, strict=True))
        same = all(bit_equal(seq.params[k], par.params[k])
                   for k in par.params)
        err = max_abs_err(flat_params(seq.params), flat_params(par.params))
        log(f"  {wire or 'f32'}: sequential against flat parallel: params "
            f"{'bit-identical' if same else 'DIFFERENT'} (max_abs_err "
            f"{err:.3e}), round records {'equal' if records else 'DIFFER'}")
        if wire and not (same and records):
            raise RuntimeError(f"{wire}: the client-sequential trainer is "
                               f"not bit-identical to the flat "
                               f"client-parallel one in the reference's "
                               f"scenario")


def stacked_one_client_deltas(start, batches, alpha, eta):
    """Each client's local steps alone (C = 1), stacked: the deltas the
    client-sequential round computes, as one (C, ...) dict."""
    from repro_torch.configs.paper import EMNIST_CNN as cfg
    from repro_torch.core.fed_step import local_sgd
    from repro_torch.models.small import make_loss_fn
    rows = [local_sgd(make_loss_fn(cfg), start,
                      {k: b[c:c + 1] for k, b in batches.items()},
                      alpha[c:c + 1], eta) for c in range(alpha.shape[0])]
    return {k: torch.cat([r[k] for r in rows]) for k in rows[0]}


def sequential_full_width(dev, n_leaves: int, D: int) -> dict:
    """The main path's trainer in mode="client_sequential" (62 slots, the
    main path's rounds with its arrival and departure), f32 and int8,
    teacher-forced: before every round it takes the params of the
    client-parallel trainer's same round.  Per round: masked_sgd C x E x
    leaves launches and no reduction kernel, round records equal to the
    parallel run's, params bit-identical or within PARAM_TOL plus one code
    step per client (step_bound) of it, with how many elements differ and
    whether one client's local steps alone (C = 1) equal its row of the
    C-client steps.  Then one warm round of each, its memory high-water
    mark over its start (sequential: below C D 4 bytes), and warm rounds/s
    in turns."""
    from repro_torch.configs.paper import EMNIST_CNN as cfg
    from repro_torch.core.aggregation import flatten_for_wire
    from repro_torch.core.compression import resolve_compression
    from repro_torch.core.fed_step import local_sgd
    from repro_torch.fed import engine
    from repro_torch.kernels import ops
    from repro_torch.models.small import make_loss_fn
    limit = N_CLIENTS * D * 4
    calls = []
    parallel_round = engine.fed_round_parallel

    def spy(loss_fn, params, batches, alpha, coeffs, eta, **kw):
        calls.append((batches, alpha, coeffs, eta))
        return parallel_round(loss_fn, params, batches, alpha, coeffs, eta,
                              **kw)
    trainers = {}
    for wire in (None, "int8"):
        name = wire or "f32"
        spec = resolve_compression(wire)
        par = make_trainer(make_clients(), dev, compression=wire)
        seq = make_trainer(make_clients(), dev, compression=wire,
                           mode="client_sequential")
        C, E = N_CLIENTS, seq.E
        log(f"client-sequential round at full width, {name}: EMNIST CNN, "
            f"{C} slots, {ROUNDS} rounds, each from the client-parallel "
            f"run's params of that round")
        total = dict.fromkeys(ops.launches, 0)
        for tau in range(ROUNDS):
            start = {k: v.clone() for k, v in par.params.items()}
            calls.clear()
            engine.fed_round_parallel = spy
            try:
                par.run(1, eval_every=EVAL_EVERY)
            finally:
                engine.fed_round_parallel = parallel_round
            seq.params = {k: v.clone() for k, v in start.items()}
            ops.reset_launches()
            seq.run(1, eval_every=EVAL_EVERY)
            torch.cuda.synchronize()
            launches = dict(ops.launches)
            want = expected_launches(masked_sgd=C * E * n_leaves)
            if launches != want:
                raise RuntimeError(f"{name} tau={tau}: sequential launches "
                                   f"{launches} != expected {want}")
            for k, v in launches.items():
                total[k] += v
            if not same_records(seq.history[-1], par.history[-1]):
                raise RuntimeError(f"{name} tau={tau}: the sequential round "
                                   f"record differs from the parallel one")
            got = flat_params(seq.params).cpu()
            want_p = flat_params(par.params).cpu()
            diff = (got - want_p).abs()
            tol = PARAM_TOL["atol"] + PARAM_TOL["rtol"] * want_p.abs()
            # the round's inputs, as the parallel round took them
            batches, alpha, coeffs, eta = calls[0]
            rows = local_sgd(make_loss_fn(cfg), start, batches, alpha, eta)
            ones = stacked_one_client_deltas(start, batches, alpha, eta)
            one_equal = all(bit_equal(ones[k], rows[k]) for k in rows)
            one_err = max(max_abs_err(ones[k], rows[k]) for k in rows)
            bound = torch.zeros_like(diff)
            if spec.quantized:
                flat_a, inverse = flatten_for_wire(start, rows, spec,
                                                   cfg.kind)
                flat_b, _ = flatten_for_wire(start, ones, spec, cfg.kind)
                bound = step_bound(spec, coeffs.cpu(), flat_a.cpu(),
                                   flat_b.cpu(), inverse)
            n_diff = int((got.view(torch.int32)
                          != want_p.view(torch.int32)).sum())
            log(f"  tau={tau} event={seq.history[-1].event!r}: params "
                + ("bit-identical" if n_diff == 0 else
                   f"differ in {n_diff} of {got.numel()} elements")
                + f" (max_abs_err {diff.max().item():.3e}"
                + (f", largest excess over PARAM_TOL plus the step "
                   f"{(diff - tol - bound).max().item():.3e}"
                   if spec.quantized else "")
                + f"); one client's local steps alone against its row of "
                f"the {C}-client steps: "
                + ("bit-identical" if one_equal else
                   f"max_abs_err {one_err:.3e}"))
            if not bool((diff <= tol + bound).all()):
                raise RuntimeError(
                    f"{name} tau={tau}: the sequential round's params are "
                    f"off the parallel round's by more than PARAM_TOL"
                    + (" plus one code step per client"
                       if spec.quantized else ""))
            del rows, ones
        log(f"  {name}: launches over {ROUNDS} sequential rounds {total} "
            f"(masked_sgd {C} slots x E={E} x {n_leaves} leaves = "
            f"{C * E * n_leaves} one-row launches a round, no reduction "
            f"kernel)")
        peaks = {}
        for label, tr in (("parallel", par), ("sequential", seq)):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            tr.run(1, eval_every=NO_EVAL)
            torch.cuda.synchronize()
            peaks[label] = torch.cuda.max_memory_allocated() - base
        log(f"  {name}: memory high-water mark of one warm round over its "
            f"start: sequential {peaks['sequential']} bytes, parallel "
            f"{peaks['parallel']} bytes (C D 4 = {limit} bytes)")
        if peaks["sequential"] >= limit:
            raise RuntimeError(f"{name}: the sequential round rose "
                               f"{peaks['sequential']} bytes over its start, "
                               f"not below C D 4 = {limit}")
        trainers[name] = par
        trainers[f"{name} sequential"] = seq
    rounds_per_s_in_turns(trainers, rounds=SEQ_WARM_ROUNDS)


def bound_check_on_card(dev) -> dict:
    """benchmarks.bound_check at its defaults, in both modes, held to the
    reference's rows (``benchmarks.reference.compare_bound_check``).
    Returns each mode's seconds."""
    from repro_torch.benchmarks import bound_check
    from repro_torch.benchmarks import reference as R
    from repro_torch.kernels import ops
    want = R.reference_rows()["rows"]["bound_check"]
    seconds = {}
    for mode in ("client_parallel", "client_sequential"):
        ops.reset_launches()
        t0 = time.perf_counter()
        rows = bound_check.run(mode=mode, device=dev)
        seconds[mode] = time.perf_counter() - t0
        lines, failures = R.compare_bound_check(rows, want)
        worst = max(abs(g[1] - r[1]) / abs(r[1]) for g, r in zip(rows, want))
        log(f"bound_check, {mode}, {len(rows)} rows over 200 rounds in "
            f"{seconds[mode]:.2f} s, launches {dict(ops.launches)}: errors "
            f"within {worst:.3e} (relative) of the reference's, tolerance "
            f"{R.BOUND_RTOL:g}; last error {rows[-1][1]:.6g} (first "
            f"{rows[0][1]:.6g}, bound {rows[-1][2]:.6g})")
        log(json.dumps({"bound_check": mode, "rows": rows}))
        for line in lines:
            log("  " + line)
        if failures:
            raise RuntimeError(f"bound_check {mode}: {failures}")
    return seconds


def tables_on_card(dev) -> None:
    """Tables 3 (synthetic and images), 4 and 5 at the reference's defaults
    from the reference's initial params, each row printed as one JSON line
    with its seconds and held to the reference's rows by the rules of
    ``benchmarks.reference``; every rule failure is listed before the phase
    fails."""
    from repro_torch.benchmarks import paper_tables as T
    from repro_torch.benchmarks import reference as R
    from repro_torch.kernels import ops
    want = R.reference_rows()["rows"]
    data = R.data_fingerprints()
    same = data == R.reference_rows()["data"]
    log(f"paper tables: the {len(data)} federations the tables draw, on "
        f"this machine's numpy {np.__version__}: "
        f"{'identical to' if same else 'DIFFERENT from'} the reference's "
        f"(SHA-256 of every client's arrays)")
    if not same:
        raise RuntimeError(f"the tables' data differ from the reference's: "
                           f"{data}")
    log(f"paper tables on the card, rules: Table 3 signs beyond "
        f"{R.TABLE3_NOISE_SAMPLES} held-out samples of {R.TABLE3_N_TEST}, "
        f"Tables 4 and 5 epochs within +-{R.EPOCH_TOL}")
    failures = []
    ops.reset_launches()
    for name, run, compare in (
            ("table3_synthetic", lambda: T.table3_scheme_comparison(
                dataset="synthetic", device=dev), R.compare_table3),
            ("table3_images", lambda: T.table3_scheme_comparison(
                dataset="images", device=dev), R.compare_table3),
            ("table4", lambda: T.table4_fast_reboot(device=dev),
             R.compare_table4),
            ("table5", lambda: T.table5_departure_crossing(device=dev),
             R.compare_table5)):
        t0 = time.perf_counter()
        rows = [list(r) for r in run()]
        seconds = time.perf_counter() - t0
        log(json.dumps({"table": name, "seconds": round(seconds, 3),
                        "rows": rows}))
        lines, fails = compare(rows, want[name])
        for line in lines:
            log("  " + line)
        failures += fails
    launches = dict(ops.launches)
    log(f"  launches over the four tables: {launches}")
    if not launches["weighted_agg"] or not launches["masked_sgd"]:
        raise RuntimeError(f"the tables launched {launches}")
    if failures:
        raise RuntimeError(f"{len(failures)} table rules failed: {failures}")


def teacher_forced_rows(dev) -> None:
    """One row of each table, the card against the port on the CPU round by
    round: before every round the card takes the CPU's params; the round
    records must be equal, the eval losses within LOSS_RTOL and the params
    within PARAM_TOL after every round."""
    from repro_torch.benchmarks import paper_tables as T
    makers = {"table3": T.table3_trainer, "table4": T.table4_trainer,
              "table5": T.table5_trainer}
    for label, table, args, rounds, every in TEACHER_FORCED:
        card = makers[table](*args, device=dev)
        cpu = makers[table](*args, device="cpu")
        worst = 0.0
        t0 = time.perf_counter()
        for tau in range(rounds):
            card.params = {k: v.to(dev, copy=True)
                           for k, v in cpu.params.items()}
            g = card.run(1, eval_every=every)[-1]
            w = cpu.run(1, eval_every=every)[-1]
            if not same_records(g, w):
                raise RuntimeError(f"{label} tau={tau}: round records "
                                   f"differ, card against CPU")
            if math.isnan(g.loss) != math.isnan(w.loss) or (
                    not math.isnan(w.loss)
                    and abs(g.loss - w.loss) > LOSS_RTOL * abs(w.loss)):
                raise RuntimeError(f"{label} tau={tau}: eval loss {g.loss} "
                                   f"on the card, {w.loss} on the CPU")
            for k, v in cpu.params.items():
                got = card.params[k].cpu()
                worst = max(worst, max_abs_err(got, v))
                torch.testing.assert_close(got, v, **PARAM_TOL,
                                           msg=f"{label} tau={tau} {k}")
        log(f"  teacher-forced {label}: {rounds} rounds "
            f"({time.perf_counter() - t0:.1f} s), records equal, params "
            f"max_abs_err {worst:.3e} (rtol {PARAM_TOL['rtol']:g}, atol "
            f"{PARAM_TOL['atol']:g}) after every round")


def paper_path(dev, n_leaves: int, D: int) -> None:
    """The paper's experiments and the client-sequential round (phase 7 of
    the docstring), with each piece's seconds."""
    t0 = time.perf_counter()
    sequential_reference_scenario(dev)
    sequential_full_width(dev, n_leaves, D)
    t1 = time.perf_counter()
    bound_s = bound_check_on_card(dev)
    tables_on_card(dev)
    t2 = time.perf_counter()
    log("teacher-forced rows, card against the port on the CPU:")
    teacher_forced_rows(dev)
    t3 = time.perf_counter()
    log(f"paper experiments: sequential rounds {t1 - t0:.1f} s, bound_check "
        f"{sum(bound_s.values()):.1f} s, tables {t2 - t1:.1f} s, "
        f"teacher-forced rows {t3 - t2:.1f} s")


# -- 9. LM serving -----------------------------------------------------------
def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def _prefill_then_decode(params, cfg, tokens, n_decode: int, dev,
                         patch_emb=None):
    """Prefill all but the last n_decode tokens (after the patches, where
    given), then decode those teacher-forced; the logits of every step."""
    from repro_torch.models import transformer
    B, S = tokens.shape[:2]
    Sp = S - n_decode
    P = 0 if patch_emb is None else patch_emb.shape[1]
    cache = transformer.init_cache(cfg, B, P + S, dev)
    lg, cache = transformer.prefill(params, cfg, tokens[:, :Sp], cache,
                                    patch_emb=patch_emb)
    out = [lg]
    for t in range(Sp, S):
        lg, cache = transformer.decode_step(params, cfg, cache,
                                            tokens[:, t:t + 1], P + t)
        out.append(lg)
    return out


def check_reduced_against_cpu(dev) -> float:
    """The reduced config in f32 with attn_impl="flash": prefill and four
    teacher-forced decode steps on the card against the same on the CPU
    (the port's plain path), the same weights and tokens."""
    from repro_torch.configs import get_config
    from repro_torch.models.params import init_params
    cfg = dataclasses.replace(get_config(ARCH).reduced(), attn_impl="flash")
    params = init_params(cfg, seed=0, device="cpu")
    tokens = torch.randint(0, cfg.vocab, (2, 64),
                           generator=torch.Generator().manual_seed(0))
    plain = _prefill_then_decode(params, cfg, tokens, 4, torch.device("cpu"))
    card = _prefill_then_decode(_to(params, dev), cfg, tokens.to(dev), 4, dev)
    worst = 0.0
    for a, b in zip(card, plain, strict=True):
        worst = max(worst, max_abs_err(a.cpu(), b))
        torch.testing.assert_close(a.cpu(), b, **REDUCED_TOL)
    log(f"  reduced config in f32 (prefill 60 + 4 decode steps, flash) on "
        f"the card against the CPU: logits max_abs_err {worst:.3e} (rtol "
        f"{REDUCED_TOL['rtol']:g}, atol {REDUCED_TOL['atol']:g})")
    return worst


def serve_path(dev, planted):
    """nemotron-4-15b at full width, bf16, through ``serve``: returns the
    kernels' launch counts over that run."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve
    from repro_torch.models import transformer
    from repro_torch.models.params import init_params, param_count
    cfg = dataclasses.replace(get_config(ARCH), attn_impl="flash")
    B, S = SERVE_BATCH, PROMPT_LEN
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    log(f"serving path: {cfg.name} at full width, {param_count(params):,} "
        f"{cfg.dtype} params drawn on the card in "
        f"{time.perf_counter() - t0:.2f} s; attn_impl={cfg.attn_impl}, "
        f"batch {B}, prompt {S}, {GEN} decode steps")

    ops.reset_launches()
    out = serve(cfg, batch=B, prompt_len=S, gen=GEN, seed=0, device=dev,
                params=params)
    torch.cuda.synchronize()
    launches = dict(ops.launches)
    peak = torch.cuda.max_memory_allocated(dev)
    want = expected_launches(flash_attention=cfg.n_layers)
    log(f"  launches {launches}, expected {want} (flash_attention one per "
        f"layer per prefill, none per decode step)")
    if launches != want:
        raise RuntimeError(f"launch counts {launches} != expected {want}")
    for name in ("prefill_logits", "logits"):
        if not bool(torch.isfinite(out[name]).all()):
            raise RuntimeError(f"non-finite {name} on the serving path")
    if out["prefill_logits"].shape != (B, 1, cfg.vocab) or \
            out["tokens"].shape != (B, GEN):
        raise RuntimeError(f"prefill logits shaped "
                           f"{tuple(out['prefill_logits'].shape)}, tokens "
                           f"{tuple(out['tokens'].shape)}")
    log(f"  prefill {B}x{S}: {out['prefill_s']:.3f} s, "
        f"{B * S / out['prefill_s']:.1f} tokens/s; decode {GEN} steps: "
        f"{out['decode_s'] / GEN * 1e3:.3f} ms/step, "
        f"{B * GEN / out['decode_s']:.1f} tokens/s; memory high-water mark "
        f"{peak / 2**30:.2f} GiB; sampled ids (seq 0) "
        f"{out['tokens'][0, :8].tolist()}")

    # a decode step on its own launches no flash_attention: the last step
    # again, at its position with its token, which rewrites the same slot
    ops.reset_launches()
    lg, _ = transformer.decode_step(params, cfg, out["cache"],
                                    out["tokens"][:, -1:], S + GEN - 1)
    torch.cuda.synchronize()
    if ops.launches["flash_attention"] != 0:
        raise RuntimeError(f"a decode step launched flash_attention "
                           f"{ops.launches['flash_attention']} times")

    prompts, cache = out["prompts"], out["cache"]
    tok, flash = out["tokens"][:, :1], out["prefill_logits"]
    del out, lg
    # serve's numbers include the first calls' allocations; once more warm
    t0 = time.perf_counter()
    transformer.prefill(params, cfg, prompts, cache)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for i in range(WARM_STEPS):
        transformer.decode_step(params, cfg, cache, tok, S + i)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / WARM_STEPS
    log(f"  warm: prefill {prefill_s:.3f} s, {B * S / prefill_s:.1f} "
        f"tokens/s; decode {step_s * 1e3:.3f} ms/step over {WARM_STEPS} "
        f"steps, {B / step_s:.1f} tokens/s")
    profile_card(f"one prefill {B}x{S}",
                 lambda: transformer.prefill(params, cfg, prompts, cache))

    def four_steps():
        for i in range(4):
            transformer.decode_step(params, cfg, cache, tok, S + i)
    profile_card("4 decode steps", four_steps)

    chunked_s = compare_with_chunked(params, cfg, prompts, cache, flash,
                                     planted)
    log(f"  warm prefill {B}x{S} with attn_impl=\"chunked\": {chunked_s:.3f} "
        f"s, {B * S / chunked_s:.1f} tokens/s (flash: {prefill_s:.3f} s)")
    del params, cache
    torch.cuda.empty_cache()
    check_reduced_against_cpu(dev)
    return launches


def prefill_logits(params, cfg, tokens, attend):
    """The prefill's last-position logits computed layer by layer from the
    port's building blocks, with ``attend(q, k, v)`` ((B, S, heads, hd) ->
    (B, S, H, hd)) as each layer's attention: with ``causal_attention``,
    the chunked path's own arithmetic, step for step."""
    from repro_torch.models.attention import gqa_project_qkv
    from repro_torch.models.common import apply_norm, mlp_apply
    from repro_torch.models.transformer import embed_tokens, logits_fn
    if cfg.parallel_residual:
        raise NotImplementedError("sequential residual blocks only")
    B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device)
    x = embed_tokens(params, cfg, tokens, positions)
    blocks = params["blocks"]
    for i in range(cfg.n_layers):
        p = {name: {k: t[i] for k, t in sub.items()}
             for name, sub in blocks.items()}
        q, k, v = gqa_project_qkv(p["attn"], apply_norm(x, p["ln1"], cfg),
                                  cfg, positions)
        a = attend(q, k, v).reshape(B, S, -1) @ p["attn"]["wo"]
        if "bo" in p["attn"]:
            a = a + p["attn"]["bo"]
        x = x + a
        x = x + mlp_apply(p["mlp"], apply_norm(x, p["ln2"], cfg), cfg)
    x = apply_norm(x, params["final_norm"], cfg)
    return logits_fn(params, cfg, x[:, -1:])[..., : cfg.vocab]


def compare_with_chunked(params, cfg, prompts, cache, flash, planted):
    """The flash prefill's logits and the chunked path's, on the same
    weights and prompts, against attention in f32 (see LOGITS_FACTOR); the
    planted fault must fail the same bound.  Returns the chunked prefill's
    time, warm."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import transformer
    from repro_torch.models.attention import causal_attention
    chunked_cfg = dataclasses.replace(cfg, attn_impl="chunked")
    chunked, _ = transformer.prefill(params, chunked_cfg, prompts, cache)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    transformer.prefill(params, chunked_cfg, prompts, cache)
    torch.cuda.synchronize()
    chunked_s = time.perf_counter() - t0

    same = prefill_logits(params, cfg, prompts, causal_attention)
    if not torch.equal(same, chunked):
        raise RuntimeError(f"the layer-by-layer prefill is "
                           f"{max_abs_err(same, chunked):.3e} off the "
                           f"chunked path's")
    ref = prefill_logits(params, cfg, prompts, lambda q, k, v: (
        causal_attention(q.float(), k.float(), v.float()).to(q.dtype)))
    bad = prefill_logits(params, cfg, prompts, lambda q, k, v: fa.launch(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        lib=planted).transpose(1, 2))

    def errors(lg):
        return max_abs_err(lg, ref), ((lg - ref).norm() / ref.norm()).item()
    e_flash, e_chunked, e_bad = errors(flash), errors(chunked), errors(bad)
    bound = [LOGITS_FACTOR * e for e in e_chunked]
    log(f"  prefill logits (std {ref.std().item():.3f}) against the model "
        f"with attention in f32, max_abs_err / relative norm: flash "
        f"{e_flash[0]:.3e} / {e_flash[1]:.3e}, chunked {e_chunked[0]:.3e} / "
        f"{e_chunked[1]:.3e}, planted fault {e_bad[0]:.3e} / "
        f"{e_bad[1]:.3e}; bound {LOGITS_FACTOR:g}x chunked's; flash against "
        f"chunked {max_abs_err(flash, chunked):.3e}; the layer-by-layer "
        f"prefill equals the chunked path's")

    def within(e):
        return e[0] <= bound[0] and e[1] <= bound[1]
    if not within(e_flash):
        raise RuntimeError("flash prefill logits are further from attention "
                           "in f32 than the chunked path's bf16 error allows")
    if within(e_bad):
        raise RuntimeError("the logits' bound does not see the planted "
                           "fault")
    return chunked_s


# -- 9b. Mamba2 SSD serving --------------------------------------------------
def ssm_prefill_logits(params, cfg, tokens, intra):
    """The prefill's last-position logits computed layer by layer from the
    port's building blocks, with ``intra`` as each layer's intra-chunk term
    (``ops.ssd_intra_chunk``'s signature): with the kernel's wrapper, the
    model's own arithmetic, step for step."""
    from repro_torch.models.common import apply_norm
    from repro_torch.models.ssd import mamba_mixer
    from repro_torch.models.transformer import embed_tokens, logits_fn
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    x = embed_tokens(params, cfg, tokens, positions)
    blocks = params["blocks"]
    for i in range(cfg.n_layers):
        p = {name: {k: t[i] for k, t in sub.items()}
             for name, sub in blocks.items()}
        y, _ = mamba_mixer(p["ssm"], apply_norm(x, p["ln1"], cfg), cfg,
                           intra=intra)
        x = x + y
    x = apply_norm(x, params["final_norm"], cfg)
    return logits_fn(params, cfg, x[:, -1:])[..., : cfg.vocab]


def intra_f64(cum, C, B, xdt):
    """The intra-chunk term summed in f64, rounded to f32: the reference
    the kernel's and the plain version's f32 sums are measured against."""
    Q = cum.shape[-1]
    cum = cum.double()
    diff = cum[..., :, None] - cum[..., None, :]
    mask = torch.ones(Q, Q, dtype=torch.bool, device=cum.device).tril()
    L = torch.where(mask, torch.exp(diff), 0.0)
    s = torch.einsum("...qn,...sn->...qs", C.double(), B.double()) * L
    return torch.einsum("...qs,...sp->...qp", s, xdt.double()).float()


def compare_ssm_intra(params, cfg, prompts, kernel_logits, planted):
    """The prefill's logits with the intra-chunk term from the kernel, from
    its plain version and from the planted fault, against the model with
    that term summed in f64 (see LOGITS_FACTOR's use in SSM serving)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_chunk as sc
    same = ssm_prefill_logits(params, cfg, prompts, ops.ssd_intra_chunk)
    if not torch.equal(same, kernel_logits):
        raise RuntimeError(f"the layer-by-layer prefill is "
                           f"{max_abs_err(same, kernel_logits):.3e} off the "
                           f"model's")
    plain = ssm_prefill_logits(params, cfg, prompts, sc.ssd_intra_chunk_plain)
    ref = ssm_prefill_logits(params, cfg, prompts, intra_f64)
    bad = ssm_prefill_logits(params, cfg, prompts, lambda *a: sc.launch(
        *a, lib=planted))

    def errors(lg):
        return max_abs_err(lg, ref), ((lg - ref).norm() / ref.norm()).item()
    e_kernel, e_plain, e_bad = errors(same), errors(plain), errors(bad)
    bound = [LOGITS_FACTOR * e for e in e_plain]
    log(f"  prefill logits (std {ref.std().item():.3f}) against the model "
        f"with the intra-chunk term in f64, max_abs_err / relative norm: "
        f"kernel {e_kernel[0]:.3e} / {e_kernel[1]:.3e}, plain version "
        f"{e_plain[0]:.3e} / {e_plain[1]:.3e}, planted fault {e_bad[0]:.3e} / "
        f"{e_bad[1]:.3e}; bound {LOGITS_FACTOR:g}x the plain version's; "
        f"kernel against plain {max_abs_err(same, plain):.3e}; the "
        f"layer-by-layer prefill equals the model's")

    def within(e):
        return e[0] <= bound[0] and e[1] <= bound[1]
    if not within(e_kernel):
        raise RuntimeError("the kernel's prefill logits are further from the "
                           "f64 intra-chunk term than the plain version's "
                           "f32 error allows")
    if within(e_bad):
        raise RuntimeError("the logits' bound does not see the planted fault")


def ssm_decode_against_full_forward(params, cfg, prompts, tokens):
    """The prefill of the prompts and SSM_DECODE_STEPS teacher-forced decode
    steps, each step's logits against the full forward of all the tokens at
    its position (tests/test_decode.py's check), in f32 on the serving
    model's weights upcast; the same in bf16, reported.  Returns the f32
    max abs error."""
    from repro_torch.models import transformer
    B, S = prompts.shape
    seq = torch.cat([prompts, tokens[:, :SSM_DECODE_STEPS]], dim=1)
    worst = {}
    for dtype in ("float32", cfg.dtype):
        c = dataclasses.replace(cfg, dtype=dtype)
        p = params if dtype == cfg.dtype else _to(params, torch.float32)
        h, _, _ = transformer.model_forward(p, c, seq)
        full = transformer.logits_fn(p, c, h[:, S - 1:])[..., : c.vocab]
        del h
        cache = transformer.init_cache(c, B, seq.shape[1], prompts.device)
        lg, cache = transformer.prefill(p, c, prompts, cache)
        steps = [lg]
        for t in range(S, seq.shape[1]):
            lg, cache = transformer.decode_step(p, c, cache, seq[:, t:t + 1],
                                                t)
            steps.append(lg)
        got = torch.cat(steps, dim=1)
        worst[dtype] = max_abs_err(got, full)
        if dtype == "float32":
            torch.testing.assert_close(got, full, **DECODE_TOL)
        del p, cache, full, got
        torch.cuda.empty_cache()
    log(f"  prefill of {S} tokens and {seq.shape[1] - S} decode steps against "
        f"the full forward of {seq.shape[1]} tokens: f32 max_abs_err "
        f"{worst['float32']:.3e} (rtol {DECODE_TOL['rtol']:g}, atol "
        f"{DECODE_TOL['atol']:g}); {cfg.dtype} {worst[cfg.dtype]:.3e} "
        f"(reported)")
    return worst["float32"]


def check_ssm_reduced_against_cpu(dev) -> float:
    """The reduced config in f32: prefill and four teacher-forced decode
    steps on the card (the kernel) against the same on the CPU (the plain
    path), the same weights and tokens."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.params import init_params
    cfg = get_config(SSM_ARCH).reduced()
    params = init_params(cfg, seed=0, device="cpu")
    tokens = torch.randint(0, cfg.vocab, (2, 100),
                           generator=torch.Generator().manual_seed(0))
    plain = _prefill_then_decode(params, cfg, tokens, 4, torch.device("cpu"))
    before = ops.launches["ssd_intra_chunk"]
    card = _prefill_then_decode(_to(params, dev), cfg, tokens.to(dev), 4, dev)
    if ops.launches["ssd_intra_chunk"] != before + cfg.n_layers:
        raise RuntimeError("the reduced prefill on the card did not launch "
                           "ssd_intra_chunk once per layer")
    worst = 0.0
    for a, b in zip(card, plain, strict=True):
        worst = max(worst, max_abs_err(a.cpu(), b))
        torch.testing.assert_close(a.cpu(), b, **REDUCED_TOL)
    log(f"  reduced config in f32 (prefill 96 + 4 decode steps) on the card "
        f"against the CPU: logits max_abs_err {worst:.3e} (rtol "
        f"{REDUCED_TOL['rtol']:g}, atol {REDUCED_TOL['atol']:g})")
    return worst


def ssm_serve_path(dev, planted):
    """mamba2-130m at full width, bf16, through ``serve``: returns the
    kernels' launch counts over that run and the serving numbers."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve
    from repro_torch.models import transformer
    from repro_torch.models.params import init_params, param_count
    cfg = get_config(SSM_ARCH)
    B, S = SERVE_BATCH, PROMPT_LEN
    torch.cuda.reset_peak_memory_stats(dev)
    params = init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    log(f"SSM serving path: {cfg.name} at full width ({cfg.n_layers} layers, "
        f"d_model {cfg.d_model}, {cfg.ssm_n_heads} SSD heads of "
        f"{cfg.ssm_head_dim}, N {cfg.ssm_d_state}, chunks of "
        f"{cfg.ssm_chunk}), {param_count(params):,} {cfg.dtype} params; "
        f"batch {B}, prompt {S}, {GEN} decode steps")

    ops.reset_launches()
    out = serve(cfg, batch=B, prompt_len=S, gen=GEN, seed=0, device=dev,
                params=params)
    torch.cuda.synchronize()
    launches = dict(ops.launches)
    peak = torch.cuda.max_memory_allocated(dev)
    want = expected_launches(ssd_intra_chunk=cfg.n_layers)
    log(f"  launches {launches}, expected {want} (ssd_intra_chunk one per "
        f"layer per prefill, none per decode step)")
    if launches != want:
        raise RuntimeError(f"launch counts {launches} != expected {want}")
    for name in ("prefill_logits", "logits"):
        if not bool(torch.isfinite(out[name]).all()):
            raise RuntimeError(f"non-finite {name} on the SSM serving path")
    if out["prefill_logits"].shape != (B, 1, cfg.vocab) or \
            out["tokens"].shape != (B, GEN):
        raise RuntimeError(f"prefill logits shaped "
                           f"{tuple(out['prefill_logits'].shape)}, tokens "
                           f"{tuple(out['tokens'].shape)}")
    log(f"  prefill {B}x{S}: {out['prefill_s']:.3f} s, "
        f"{B * S / out['prefill_s']:.1f} tokens/s; decode {GEN} steps: "
        f"{out['decode_s'] / GEN * 1e3:.3f} ms/step, "
        f"{B * GEN / out['decode_s']:.1f} tokens/s; memory high-water mark "
        f"{peak / 2**30:.2f} GiB; sampled ids (seq 0) "
        f"{out['tokens'][0, :8].tolist()}")

    prompts, cache, tokens = out["prompts"], out["cache"], out["tokens"]
    kernel_logits = out["prefill_logits"]
    del out
    # a prefill alone launches the kernel once per layer, a decode step none
    ops.reset_launches()
    t0 = time.perf_counter()
    transformer.prefill(params, cfg, prompts, cache)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    per_prefill = ops.launches["ssd_intra_chunk"]
    tok = tokens[:, :1]
    ops.reset_launches()
    t0 = time.perf_counter()
    for i in range(WARM_STEPS):
        transformer.decode_step(params, cfg, cache, tok, S + i)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / WARM_STEPS
    per_step = ops.launches["ssd_intra_chunk"] / WARM_STEPS
    log(f"  warm: prefill {prefill_s:.3f} s, {B * S / prefill_s:.1f} "
        f"tokens/s, {per_prefill} ssd_intra_chunk launches; decode "
        f"{step_s * 1e3:.3f} ms/step over {WARM_STEPS} steps, {B / step_s:.1f} "
        f"tokens/s, {per_step:g} launches per step")
    if per_prefill != cfg.n_layers or per_step != 0:
        raise RuntimeError("ssd_intra_chunk launches per prefill or per "
                           "decode step off 24 and 0")
    profile_card(f"one {cfg.name} prefill {B}x{S}",
                 lambda: transformer.prefill(params, cfg, prompts, cache))

    def four_steps():
        for i in range(4):
            transformer.decode_step(params, cfg, cache, tok, S + i)
    profile_card(f"4 {cfg.name} decode steps", four_steps)

    compare_ssm_intra(params, cfg, prompts, kernel_logits, planted)
    ssm_decode_against_full_forward(params, cfg, prompts, tokens)
    del params, cache
    torch.cuda.empty_cache()
    check_ssm_reduced_against_cpu(dev)
    return launches


# -- 9c. the LM zoo: dense, hybrid and MLA + MoE serving ----------------------
@contextlib.contextmanager
def substituted(attend=None, flash=None, intra=None):
    """A context in which the models compute their chunked attention
    (``attention.causal_attention``, which MLA's prefill also calls), their
    flash attention (``ops.flash_attention``) or their SSD intra-chunk term
    (``ops.ssd_intra_chunk``) with the functions given: the same model with
    one piece computed another way, for the logit comparisons."""
    from unittest import mock

    from repro_torch.kernels import ops
    from repro_torch.models import attention
    with contextlib.ExitStack() as stack:
        for target, name, fn in ((attention, "causal_attention", attend),
                                 (ops, "flash_attention", flash),
                                 (ops, "ssd_intra_chunk", intra)):
            if fn is not None:
                stack.enter_context(mock.patch.object(target, name, fn))
        yield


def zoo_logits(params, cfg, tokens, **subs):
    """The last position's logits of a forward pass of the prompts (no
    cache), with ``substituted(**subs)``."""
    from repro_torch.models import transformer
    with substituted(**subs):
        h, _, _ = transformer.model_forward(params, cfg, tokens)
        return transformer.logits_fn(params, cfg, h[:, -1:])[..., :cfg.vocab]


def attention_in_f32():
    """The chunked attention on f32 copies of q, k and v, rounded back (the
    model's own causal_attention, taken before any substitution)."""
    from repro_torch.models.attention import causal_attention

    def attend(q, k, v, **kw):
        return causal_attention(q.float(), k.float(), v.float(),
                                **kw).to(q.dtype)
    return attend


def logit_errors(lg, ref):
    return max_abs_err(lg, ref), ((lg - ref).norm() / ref.norm()).item()


def hold_within_factor(what: str, got, plain, bad, ref, of: str) -> None:
    """got's error against ref may be at most LOGITS_FACTOR times plain's
    (max abs error and relative norm), and the planted fault's must not."""
    e_got, e_plain, e_bad = (logit_errors(x, ref) for x in (got, plain, bad))
    bound = [LOGITS_FACTOR * e for e in e_plain]
    log(f"  prefill logits (std {ref.std().item():.3f}) against the model "
        f"with {of}, max_abs_err / relative norm: {what} {e_got[0]:.3e} / "
        f"{e_got[1]:.3e}, plain {e_plain[0]:.3e} / {e_plain[1]:.3e}, planted "
        f"fault {e_bad[0]:.3e} / {e_bad[1]:.3e}; bound {LOGITS_FACTOR:g}x "
        f"plain's")

    def within(e):
        return e[0] <= bound[0] and e[1] <= bound[1]
    if not within(e_got):
        raise RuntimeError(f"the {what} prefill logits are further from "
                           f"{of} than the plain path's error allows")
    if within(e_bad):
        raise RuntimeError("the logits' bound does not see the planted fault")


def zoo_expected(cfg) -> dict:
    """The launches of one prefill: flash_attention once per GQA layer
    under attn_impl="flash" with no sliding window, ssd_intra_chunk once
    per SSD layer."""
    counts = {}
    if cfg.attn_impl == "flash" and not cfg.sliding_window \
            and cfg.n_heads and not cfg.use_mla:
        counts["flash_attention"] = cfg.n_layers
    if cfg.family in ("ssm", "hybrid"):
        counts["ssd_intra_chunk"] = cfg.n_layers
    return expected_launches(**counts)


def zoo_config(arch: str, attn_impl: str, layers):
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config(arch), attn_impl=attn_impl)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    return cfg


def zoo_serve(dev, arch: str, attn_impl: str, layers, planted: dict,
              card: str) -> dict:
    """One architecture at full width from seed 0 through ``serve``
    (ZOO_GEN decode steps), ``layers`` of its layers where given: launch
    counts per prefill and per decode step, finite logits, warm prefill
    and decode times, busy shares, memory high-water mark; the logits
    against the model with attention in f32 (flash against the chunked
    path, the planted flash fault outside) or, for the hybrid, with its
    intra-chunk term in f64 (the kernel against its plain version, the
    planted SSD fault outside).  Returns the serving numbers."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_chunk as sc
    from repro_torch.launch.serve import serve
    from repro_torch.models import transformer
    from repro_torch.models.params import init_params, param_count
    cfg = zoo_config(arch, attn_impl, layers)
    full = zoo_config(arch, attn_impl, None)
    B, S = SERVE_BATCH, PROMPT_LEN
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    n_params = param_count(params)
    depth = (f"{cfg.n_layers} of its {full.n_layers} layers (depth cut; "
             f"full width)" if layers is not None else
             f"all {cfg.n_layers} layers")
    log(f"zoo serving: {cfg.name} ({cfg.family}) at full width, {depth}: "
        f"{n_params:,} {cfg.dtype} params ({2 * n_params / 1e9:.2f} GB) "
        f"drawn on the card in {time.perf_counter() - t0:.2f} s; "
        f"attn_impl={cfg.attn_impl}, batch {B}, prompt {S}, {ZOO_GEN} "
        f"decode steps")

    ops.reset_launches()
    out = serve(cfg, batch=B, prompt_len=S, gen=ZOO_GEN, seed=0, device=dev,
                params=params)
    torch.cuda.synchronize()
    launches = dict(ops.launches)
    peak = torch.cuda.max_memory_allocated(dev)
    want = zoo_expected(cfg)
    log(f"  launches {launches}, expected {want}")
    if launches != want:
        raise RuntimeError(f"{cfg.name}: launch counts {launches} != "
                           f"expected {want}")
    for name in ("prefill_logits", "logits"):
        if not bool(torch.isfinite(out[name]).all()):
            raise RuntimeError(f"non-finite {name} serving {cfg.name}")
    K = (cfg.n_codebooks,) if cfg.n_codebooks else ()
    if out["prefill_logits"].shape != (B, 1, *K, cfg.vocab) or \
            out["tokens"].shape != (B, ZOO_GEN, *K):
        raise RuntimeError(f"{cfg.name}: prefill logits shaped "
                           f"{tuple(out['prefill_logits'].shape)}, tokens "
                           f"{tuple(out['tokens'].shape)}")
    log(f"  prefill {B}x{S}: {out['prefill_s']:.3f} s; decode {ZOO_GEN} "
        f"steps: {out['decode_s'] / ZOO_GEN * 1e3:.3f} ms/step; memory "
        f"high-water mark {peak / 2**30:.2f} GiB; sampled ids (seq 0) "
        f"{out['tokens'][0, :8].tolist()}")
    prompts, cache, tok = out["prompts"], out["cache"], out["tokens"][:, :1]
    served = out["prefill_logits"]
    del out

    # warm: a prefill alone, then decode steps alone, with their launches
    ops.reset_launches()
    t0 = time.perf_counter()
    transformer.prefill(params, cfg, prompts, cache)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    per_prefill = dict(ops.launches)
    ops.reset_launches()
    t0 = time.perf_counter()
    for i in range(WARM_STEPS):
        transformer.decode_step(params, cfg, cache, tok, S + i)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / WARM_STEPS
    per_step = {k: n / WARM_STEPS for k, n in ops.launches.items() if n}
    if per_prefill != want or per_step:
        raise RuntimeError(f"{cfg.name}: a prefill launched {per_prefill} "
                           f"(expected {want}), decode steps {per_step} "
                           f"per step (expected none)")
    prefill_stats, decode_stats = {}, {}
    profile_card(f"one {cfg.name} prefill {B}x{S}",
                 lambda: transformer.prefill(params, cfg, prompts, cache),
                 stats=prefill_stats)

    def four_steps():
        for i in range(4):
            transformer.decode_step(params, cfg, cache, tok, S + i)
    profile_card(f"4 {cfg.name} decode steps", four_steps,
                 stats=decode_stats)
    del cache
    torch.cuda.empty_cache()

    # the logits against the same model with one piece in higher precision
    f32 = attention_in_f32()
    if cfg.attn_impl == "flash":
        chunked_cfg = dataclasses.replace(cfg, attn_impl="chunked")
        same = zoo_logits(params, cfg, prompts)
        chunked = zoo_logits(params, chunked_cfg, prompts)
        ref = zoo_logits(params, chunked_cfg, prompts, attend=f32)
        bad = zoo_logits(params, cfg, prompts, flash=lambda q, k, v: fa.launch(
            q, k, v, lib=planted["flash_attention"]))
        if not torch.equal(same, served):
            raise RuntimeError(f"{cfg.name}: the forward pass's logits are "
                               f"{max_abs_err(same, served):.3e} off the "
                               f"served prefill's")
        hold_within_factor("flash", served, chunked, bad, ref,
                           "attention in f32")
    elif cfg.family == "hybrid":
        same = zoo_logits(params, cfg, prompts)
        if not torch.equal(same, served):
            raise RuntimeError(f"{cfg.name}: the forward pass's logits are "
                               f"{max_abs_err(same, served):.3e} off the "
                               f"served prefill's")
        e = logit_errors(served, zoo_logits(params, cfg, prompts, attend=f32))
        log(f"  against the model with attention in f32 (reported): "
            f"{e[0]:.3e} / {e[1]:.3e}")
        # held in f32, the weights upcast: in bf16 the roundings of 32
        # layers of two averaged branches already move the logits by ~2% of
        # their norm, as much as a skipped key tile of the intra-chunk term
        c32 = dataclasses.replace(cfg, dtype="float32")
        p32 = _to(params, torch.float32)
        got = zoo_logits(p32, c32, prompts)
        plain = zoo_logits(p32, c32, prompts, intra=sc.ssd_intra_chunk_plain)
        ref = zoo_logits(p32, c32, prompts, intra=intra_f64)
        bad = zoo_logits(p32, c32, prompts, intra=lambda *a: sc.launch(
            *a, lib=planted["ssd_intra_chunk"]))
        del p32
        hold_within_factor("kernel (f32 model)", got, plain, bad, ref,
                           "the intra-chunk term in f64")
    else:
        ref = zoo_logits(params, cfg, prompts, attend=f32)
        e = logit_errors(served, ref)
        log(f"  prefill logits (std {ref.std().item():.3f}) against the "
            f"model with attention in f32 (reported; no kernel on this "
            f"path): max_abs_err {e[0]:.3e}, relative norm {e[1]:.3e}")
    patches = llava_patch_path(dev, params, cfg, prompts) \
        if cfg.n_patches else None
    del params
    torch.cuda.empty_cache()
    row = dict(arch=cfg.name, layers=cfg.n_layers, of_layers=full.n_layers,
               params=n_params, attn_impl=cfg.attn_impl,
               launches_per_prefill={k: n for k, n in want.items() if n},
               prefill_tokens_per_s=B * S / prefill_s, prefill_s=prefill_s,
               decode_ms_per_step=step_s * 1e3,
               prefill_busy=prefill_stats.get("busy"),
               decode_busy=decode_stats.get("busy"),
               peak_gib=peak / 2 ** 30, card=card)
    if patches is not None:
        row["with_patches"] = patches
    log(f"  warm: prefill {prefill_s:.3f} s, {B * S / prefill_s:.1f} "
        f"tokens/s, busy {row['prefill_busy']}; decode {step_s * 1e3:.3f} "
        f"ms/step over {WARM_STEPS} steps, busy {row['decode_busy']}")
    return row


def llava_patch_path(dev, params, cfg, prompts) -> dict:
    """llava's multimodal prefill: LLAVA_PATCHES random N(0, 0.02) patch
    embeddings ahead of the text prompts through
    ``transformer.prefill(patch_emb=)`` into a cache of P + S + LLAVA_GEN
    slots, then LLAVA_GEN decode steps at positions P + S + i: one
    flash_attention launch per layer at S = P + S_text, none per decode
    step, finite logits.  Returns its numbers."""
    from repro_torch.kernels import ops
    from repro_torch.models import transformer
    B, S = prompts.shape
    P = cfg.n_patches
    if P != LLAVA_PATCHES or FLASH_LLAVA[3] != P + S:
        raise RuntimeError(f"{cfg.name}: {P} patches, FLASH_LLAVA "
                           f"{FLASH_LLAVA}")
    gen = torch.Generator(device=dev).manual_seed(7)
    patches = 0.02 * torch.randn(B, P, cfg.d_model, device=dev,
                                 generator=gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    cache = transformer.init_cache(cfg, B, P + S + LLAVA_GEN, dev)
    cache_gb = sum(t.numel() * t.element_size() for c in cache.values()
                   for a in c.values() for t in a.values()) / 1e9
    ops.reset_launches()
    t0 = time.perf_counter()
    lg, cache = transformer.prefill(params, cfg, prompts, cache,
                                    patch_emb=patches)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    per_prefill = dict(ops.launches)
    want = expected_launches(flash_attention=cfg.n_layers)
    ops.reset_launches()
    tok = lg[:, 0].argmax(-1, keepdim=True)
    t0 = time.perf_counter()
    for i in range(LLAVA_GEN):
        lg_d, cache = transformer.decode_step(params, cfg, cache, tok,
                                              P + S + i)
        tok = lg_d[:, 0].argmax(-1, keepdim=True)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / LLAVA_GEN
    per_steps = {k: n for k, n in ops.launches.items() if n}
    peak = torch.cuda.max_memory_allocated(dev)
    pos_map = cache["blocks"]["attn"]["pos_map"][0]
    log(f"  with {P} patches: cache of {P + S + LLAVA_GEN} slots "
        f"({cache_gb:.2f} GB), prefill {B}x({P}+{S}) {prefill_s:.3f} s "
        f"({B * (P + S) / prefill_s:.1f} tokens/s), launches {per_prefill}"
        f"; {LLAVA_GEN} decode steps at positions {P + S}.."
        f"{P + S + LLAVA_GEN - 1}"
        f" (argmax) {step_s * 1e3:.3f} ms/step, launches {per_steps}; "
        f"memory high-water mark over it {peak / 2**30:.2f} GiB")
    if per_prefill != want or per_steps:
        raise RuntimeError(f"{cfg.name} with patches: a prefill launched "
                           f"{per_prefill} (expected {want}), the decode "
                           f"steps {per_steps} (expected none)")
    if not (bool(torch.isfinite(lg).all())
            and bool(torch.isfinite(lg_d).all())):
        raise RuntimeError(f"non-finite logits serving {cfg.name} with "
                           f"patches")
    if pos_map[:P + S + LLAVA_GEN].tolist() != list(range(P + S + LLAVA_GEN)):
        raise RuntimeError(f"{cfg.name} with patches: the cache's positions "
                           f"are not 0..{P + S + LLAVA_GEN - 1}")
    del cache
    torch.cuda.empty_cache()
    return dict(patches=P,
                flash_launches_per_prefill=per_prefill["flash_attention"],
                prefill_s=prefill_s,
                prefill_tokens_per_s=B * (P + S) / prefill_s,
                decode_ms_per_step=step_s * 1e3, cache_gb=cache_gb,
                peak_gib=peak / 2 ** 30)


def zoo_reduced_against_cpu(dev) -> None:
    """Each new architecture's reduced config in f32 (and gemma's at its
    real head dim of 256 with attn_impl="flash"): prefill past the reduced
    sliding window and four teacher-forced decode steps on the card
    against the same on the CPU, the same weights and tokens; on the card
    the kernels of the path launch once per layer per prefill.  deepseek-v3
    (the one path of the MLA q_lora_rank and the sigmoid router) gets a
    live router_bias."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.params import init_params
    cases = [(arch, get_config(arch).reduced()) for arch in ZOO_REDUCED]
    cases.append(("gemma-7b hd 256 flash", dataclasses.replace(
        get_config("gemma-7b").reduced(), head_dim=256, attn_impl="flash")))
    for label, cfg in cases:
        params = init_params(cfg, seed=0, device="cpu")
        if "router_bias" in params.get("moe_blocks", {}).get("moe", {}):
            params["moe_blocks"]["moe"]["router_bias"] = 0.01 * torch.randn(
                params["moe_blocks"]["moe"]["router_bias"].shape,
                generator=torch.Generator().manual_seed(1))
        K = (cfg.n_codebooks,) if cfg.n_codebooks else ()
        tokens = torch.randint(0, cfg.vocab, (2, 100, *K),
                               generator=torch.Generator().manual_seed(0))
        patches = 0.02 * torch.randn(
            2, cfg.n_patches, cfg.d_model,
            generator=torch.Generator().manual_seed(1)) \
            if cfg.n_patches else None
        plain = _prefill_then_decode(params, cfg, tokens, 4,
                                     torch.device("cpu"), patches)
        ops.reset_launches()
        card = _prefill_then_decode(
            _to(params, dev), cfg, tokens.to(dev), 4, dev,
            None if patches is None else patches.to(dev))
        want = zoo_expected(cfg)
        if dict(ops.launches) != want:
            raise RuntimeError(f"{label} reduced: launches {ops.launches}, "
                               f"expected {want}")
        worst = 0.0
        for a, b in zip(card, plain, strict=True):
            worst = max(worst, max_abs_err(a.cpu(), b))
            torch.testing.assert_close(a.cpu(), b, **REDUCED_TOL)
        with_p = f"{cfg.n_patches} patches + " if cfg.n_patches else ""
        log(f"  {label} reduced config in f32 (prefill {with_p}96 + 4 decode "
            f"steps) "
            f"on the card against the CPU: logits max_abs_err {worst:.3e} "
            f"(rtol {REDUCED_TOL['rtol']:g}, atol {REDUCED_TOL['atol']:g}); "
            f"launches {({k: n for k, n in want.items() if n})}")


def zoo_path(dev, planted: dict, card: str) -> list:
    """Every ZOO model at full width, then the reduced configs on the card
    against the CPU.  Returns each model's serving row."""
    rows = []
    for arch, attn_impl, layers in ZOO:
        rows.append(zoo_serve(dev, arch, attn_impl, layers, planted, card))
        torch.cuda.empty_cache()
    zoo_reduced_against_cpu(dev)
    for row in rows:
        log(json.dumps({"serving": row}))
    return rows


# -- 9d. LM training ----------------------------------------------------------
def train_full_width(dev, card) -> dict:
    """``python -m repro_torch.launch.train --full --arch TRAIN_ARCH`` at its
    defaults for TRAIN_ROUNDS rounds, through its ``main``: each round
    launches masked_sgd E x leaves times and no other kernel (the flash and
    SSD kernels are forward-only; the round aggregates leaf by leaf,
    agg="tree"), counted around the round calls; the probe loss after each
    round, a forward under no_grad, launches the SSD kernel once per layer
    as a prefill does.  Finite probe losses and delta norms, warm rounds/s
    (the rounds after the first), the memory high-water mark."""
    from unittest import mock

    from repro_torch.core.fed_step import flatten_tree
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.models.params import param_count
    E = 2                                   # the CLI's --local-epochs
    in_rounds = dict.fromkeys(ops.launches, 0)
    make_round = train.make_fed_round

    def counted(*args, **kw):
        round_fn = make_round(*args, **kw)

        def run(*a, **k):
            before = dict(ops.launches)
            out = round_fn(*a, **k)
            for name, n in ops.launches.items():
                in_rounds[name] += n - before[name]
            return out
        return run

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launches()
    t0 = time.perf_counter()
    with mock.patch.object(train, "make_fed_round", counted):
        out = train.main(["--full", "--arch", TRAIN_ARCH, "--rounds",
                          str(TRAIN_ROUNDS)])
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = dict(ops.launches)
    peak = torch.cuda.max_memory_allocated(dev)
    cfg = out["cfg"]
    n_leaves = len(flatten_tree(out["params"]))
    want_rounds = expected_launches(masked_sgd=TRAIN_ROUNDS * E * n_leaves)
    ssd = cfg.n_layers if cfg.family in ("ssm", "hybrid") else 0
    want = expected_launches(masked_sgd=TRAIN_ROUNDS * E * n_leaves,
                             ssd_intra_chunk=TRAIN_ROUNDS * ssd)
    warm = out["seconds"][1:]
    rounds_per_s = len(warm) / sum(warm)
    log(f"training: {cfg.name} at full width ({param_count(out['params']):,}"
        f" {cfg.dtype} params, {n_leaves} leaves), C 4, E {E}, batch 2, seq "
        f"128, scheme C, {TRAIN_ROUNDS} rounds in {total_s:.2f} s: launches "
        f"in the rounds {({k: n for k, n in in_rounds.items() if n})} "
        f"(expected masked_sgd E x leaves a round, nothing else), in all "
        f"{({k: n for k, n in launches.items() if n})} (the probes' "
        f"no-grad forwards add ssd_intra_chunk {ssd} each); probe losses "
        f"{[round(x, 4) for x in out['losses']]}, |delta| "
        f"{[f'{x:.3e}' for x in out['delta_norms']]}; round seconds "
        f"{[round(x, 3) for x in out['seconds']]}, warm {rounds_per_s:.3f} "
        f"rounds/s; memory high-water mark {peak / 2**30:.2f} GiB")
    if in_rounds != want_rounds or launches != want:
        raise RuntimeError(f"training launches {in_rounds} in the rounds, "
                           f"{launches} in all; expected {want_rounds}, "
                           f"{want}")
    if not (np.isfinite(out["losses"]).all()
            and np.isfinite(out["delta_norms"]).all()
            and min(out["delta_norms"]) > 0):
        raise RuntimeError(f"training losses {out['losses']}, delta norms "
                           f"{out['delta_norms']}")
    del out
    torch.cuda.empty_cache()
    return dict(arch=TRAIN_ARCH, rounds=TRAIN_ROUNDS, leaves=n_leaves,
                masked_sgd_per_round=in_rounds["masked_sgd"] // TRAIN_ROUNDS,
                warm_rounds_per_s=rounds_per_s, peak_gib=peak / 2 ** 30,
                card=card)


def delta_gap(got, want, w0, rounds: int):
    """A leaf's new value against another's, both from w0: the norm of
    their difference; of what is left of it once the elements at most
    ``rounds`` ulps apart are set aside, where they are at most
    TRAIN_FLIP_SHARE of the leaf; the share of such elements; and the norm
    of want's delta (see TRAIN_DELTA_TOL)."""
    diff = got.float() - want.float()
    top = torch.maximum(got.float().abs(), want.float().abs())
    flips = (diff != 0) & (diff.abs() <= rounds * (
        torch.nextafter(top, torch.tensor(float("inf"))) - top))
    share = flips.float().mean().item()
    kept = diff.masked_fill(flips, 0.0) if share <= TRAIN_FLIP_SHARE else diff
    return (diff.norm().item(), kept.norm().item(), share,
            (want.float() - w0.float()).norm().item())


def train_reduced_against_cpu(dev) -> float:
    """One client-parallel round of each TRAIN_REDUCED config in f32, on the
    card and on the CPU, from the same params (the port's init, seed 0),
    masks (one step masked, one client dark), scheme C coefficients and
    batches (``launch.train.round_batches``): masked_sgd E x leaves launches
    on the card and no other kernel, every leaf's delta within
    TRAIN_DELTA_TOL of its norm (after TRAIN_FLIP_SHARE).  Returns the
    largest raw ratio."""
    from repro_torch.configs import get_config
    from repro_torch.core.aggregation import scheme_coefficients
    from repro_torch.core.fed_step import (flatten_tree, make_fed_round,
                                           per_client_loss)
    from repro_torch.kernels import ops
    from repro_torch.launch.train import round_batches
    from repro_torch.models import transformer
    from repro_torch.models.params import init_params
    C, E = TRAIN_SHAPE["n_clients"], TRAIN_SHAPE["local_epochs"]
    alpha = torch.tensor([[1, 1], [1, 0], [0, 0], [1, 1]],
                         dtype=torch.float32)
    coeffs = scheme_coefficients("C", torch.full((C,), 1.0 / C),
                                 alpha.sum(1), E)
    worst_raw = 0.0
    for arch in TRAIN_REDUCED:
        cfg = get_config(arch).reduced()
        start = init_params(cfg, seed=0, device="cpu")
        batch = {k: torch.from_numpy(v) for k, v in round_batches(
            np.random.default_rng(1), cfg, 0, **TRAIN_SHAPE).items()}
        round_fn = make_fed_round(per_client_loss(
            lambda p, b: transformer.train_loss(p, cfg, b)),
            "client_parallel")
        runs = {}
        for where in ("cpu", "card"):
            d = torch.device("cpu") if where == "cpu" else dev
            flat = {k: v.clone().to(d) for k, v in
                    flatten_tree(start).items()}
            ops.reset_launches()
            _, m = round_fn(flat, _to(batch, d), alpha.to(d), coeffs.to(d),
                            torch.tensor(0.05, device=d), with_metrics=True)
            runs[where] = (flat, float(m["delta_norm"]), dict(ops.launches))
        want = expected_launches(masked_sgd=E * len(runs["card"][0]))
        if runs["card"][2] != want:
            raise RuntimeError(f"{arch} reduced training round: launches "
                               f"{runs['card'][2]}, expected {want}")
        w0 = flatten_tree(start)
        rows, bad, zero = [], [], []
        top = max((runs["cpu"][0][n] - w).float().norm().item()
                  for n, w in w0.items())
        for name, w in w0.items():
            card_w = runs["card"][0][name].cpu()
            raw, past, share, norm = delta_gap(
                card_w, runs["cpu"][0][name], w, E + 1)
            if name.endswith(TRAIN_ZERO_GRAD) and cfg.pos_emb != "rope":
                noise = max(norm, (card_w - w).float().norm().item())
                zero.append(f"{name} {noise:.2e}")
                if noise > TRAIN_ZERO_TOL * top:
                    bad.append((name, "zero-gradient leaf moved", noise, top))
                continue
            ratio = raw / norm if norm else 0.0
            rows.append((ratio, name, share))
            if past > TRAIN_DELTA_TOL * norm:
                bad.append((name, raw, past, share, norm))
        rows.sort(reverse=True)
        worst_raw = max(worst_raw, rows[0][0])
        over = [f"{n} {r:.2e} (elements {E + 1} ulps or less apart: "
                f"{sh:.4f})" for r, n, sh in rows if r > TRAIN_DELTA_TOL]
        log(f"  {arch} reduced, one round (C {C}, E {E}) in f32 on the card "
            f"against the CPU: delta_norm {runs['card'][1]:.6e} / "
            f"{runs['cpu'][1]:.6e}; largest |d_card - d_cpu| / |d| "
            f"{rows[0][0]:.3e} ({rows[0][1]}); leaves over "
            f"{TRAIN_DELTA_TOL:g} before the elements an ulp apart at each "
            f"rounding are set aside: "
            f"{over or 'none'}; zero-gradient leaves' largest delta "
            f"{zero or 'none'} (largest leaf delta {top:.3e}); launches "
            f"{({k: n for k, n in want.items() if n})}")
        if bad:
            raise RuntimeError(f"{arch}: leaves outside TRAIN_DELTA_TOL "
                               f"(name, raw, kept, share set aside or not, "
                               f"norm): {bad}")
    return worst_raw


def train_path(dev, card) -> dict:
    row = train_full_width(dev, card)
    row["reduced_worst_delta_ratio"] = train_reduced_against_cpu(dev)
    log(json.dumps({"training": row}))
    return row


@contextlib.contextmanager
def watched_spans(label: str = "", profile_span=None, stats=None):
    """While it is open, every ``RoundEngine.run_span`` is timed between
    two synchronisations, with the kernel launches it makes, and the
    params after the first span are kept (CPU copies); span number
    ``profile_span`` on the card runs under ``profile_card`` (its busy
    share into ``stats``, its kernels by name under "profile"); every
    ``StreamScheduler`` that runs is kept.  Yields {"spans": [(tau,
    rounds, seconds, launches)], "first": params, "schedulers": [...]}."""
    from unittest import mock

    from repro_torch.fed.engine import RoundEngine
    from repro_torch.fed.stream import StreamScheduler
    from repro_torch.kernels import ops
    seen = {"spans": [], "first": None, "schedulers": []}
    run_span, run = RoundEngine.run_span, StreamScheduler.run

    def timed(self, params, tau_start, n_rounds, **kw):
        cuda = self.device.type == "cuda"
        if cuda:
            torch.cuda.synchronize(self.device)
        before = dict(ops.launches)
        t0 = time.perf_counter()
        if cuda and len(seen["spans"]) == profile_span:
            box = []
            seen["profile"] = profile_card(label, lambda: box.append(
                run_span(self, params, tau_start, n_rounds, **kw)),
                stats=stats, device_only=True)
            out = box[0]
        else:
            out = run_span(self, params, tau_start, n_rounds, **kw)
        if cuda:
            torch.cuda.synchronize(self.device)
        seen["spans"].append((tau_start, n_rounds, time.perf_counter() - t0,
                              {k: n - before[k]
                               for k, n in ops.launches.items()}))
        if seen["first"] is None:
            seen["first"] = {k: v.detach().cpu().clone()
                             for k, v in out[0].items()}
        return out

    def kept(self, *args, **kw):
        seen["schedulers"].append(self)
        return run(self, *args, **kw)
    with mock.patch.object(RoundEngine, "run_span", timed), \
            mock.patch.object(StreamScheduler, "run", kept):
        yield seen


def span_launches(seen) -> dict:
    """The launches of every kernel summed over the watched spans."""
    return {k: sum(sp[3][k] for sp in seen["spans"])
            for k in seen["spans"][0][3]}


def fed_train_full_width(dev, card, compress=None) -> dict:
    """``python -m repro_torch.launch.fed_train --full --arch TRAIN_ARCH
    --arrive 1`` for FED_TRAIN_ROUNDS rounds at its other defaults (C 4,
    capacity 6, E 2, batch 2, seq 64, scheme C, device-mode draws, agg
    "auto" = "flat" on the card), through its ``main``: inside the spans
    masked_sgd E x leaves launches a round (every capacity row in one
    launch), weighted_agg once a round (``--compress int8``:
    weighted_agg_quant once, weighted_agg never) and no flash or SSD
    kernel (training takes the differentiable paths); outside them only
    the probes' no-grad forwards, ssd_intra_chunk once per layer each.
    The arrival applied, finite probe losses; warm rounds/s over the
    timed spans, the profiled span's busy share, the memory high-water
    mark.  The last span is profiled (the card's activity alone): the
    busy share under the profiler and, as the profiler slows the host,
    its kernel time over the fastest timed one-round span's wall."""
    from repro_torch.kernels import ops
    from repro_torch.launch import fed_train
    argv = FED_TRAIN_ARGS + ["--full", "--rounds", str(FED_TRAIN_ROUNDS)]
    if compress:
        argv += ["--compress", compress]
    wire = compress or "f32"
    stats = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launches()
    t0 = time.perf_counter()
    with watched_spans(f"a fed_train round ({wire})",
                       FED_TRAIN_PROFILED_SPAN, stats) as seen:
        out = fed_train.main(argv)
    total_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    sch = seen["schedulers"][0]
    cfg = sch.engine.task.cfg
    n_leaves, E, R = len(sch.params), sch.E, FED_TRAIN_ROUNDS
    reduction = "weighted_agg_quant" if compress else "weighted_agg"
    want = expected_launches(masked_sgd=R * E * n_leaves, **{reduction: R})
    got = span_launches(seen)
    losses = [h.loss for h in sch.history if not math.isnan(h.loss)]
    outside = {k: n - got[k] for k, n in ops.launches.items()}
    want_outside = expected_launches(
        ssd_intra_chunk=len(losses) * cfg.n_layers)
    if not seen.get("profile") or stats.get("busy") is None:
        raise RuntimeError(f"fed_train ({wire}): the profiled span recorded "
                           f"no kernel on the card")
    timed = [sp for i, sp in enumerate(seen["spans"])
             if 0 < i != FED_TRAIN_PROFILED_SPAN]
    rounds_per_s = sum(sp[1] for sp in timed) / sum(sp[2] for sp in timed)
    one_round = min(sp[2] for sp in timed if sp[1] == 1)
    kernel_s = sum(t for t, _ in seen["profile"].values()) / 1e6
    busy = dict(profiled=stats["busy"],
                kernels_over_timed_round=kernel_s / one_round)
    log(f"fed_train {cfg.name} at full width ({out['params']:,} {cfg.dtype} "
        f"params, {n_leaves} leaves), {out['mode']}, capacity "
        f"{out['capacity']}, wire {out['compression']}: {R} rounds in "
        f"{out['wall_s']:.3f} s ({total_s:.2f} s with the build); spans "
        f"{[(t, r, round(sec, 3)) for t, r, sec, _ in seen['spans']]}; "
        f"launches in the spans {({k: n for k, n in got.items() if n})} "
        f"(expected {({k: n for k, n in want.items() if n})}), outside "
        f"them {({k: n for k, n in outside.items() if n})} ({len(losses)} "
        f"probes); events applied {out['events_applied']}; probe losses "
        f"{[round(x, 4) for x in losses]}; warm {rounds_per_s:.3f} rounds/s "
        f"(spans 1-3); busy {busy} (under the profiler; its "
        f"{kernel_s * 1e3:.1f} ms of kernels over the fastest timed round, "
        f"{one_round:.3f} s); memory high-water mark {peak / 2**30:.2f} "
        f"GiB; {card}")
    if got != want or outside != want_outside:
        raise RuntimeError(f"fed_train ({wire}) launches {got} in the "
                           f"spans, {outside} outside; expected {want}, "
                           f"{want_outside}")
    if out["capacity"] != FED_TRAIN_CAPACITY:
        raise RuntimeError(f"fed_train's capacity {out['capacity']}: step 3 "
                           f"checks the kernels at {FED_TRAIN_CAPACITY} rows")
    if out["events_applied"] != 1 or sch.events_applied != 1:
        raise RuntimeError(f"fed_train applied {out['events_applied']} "
                           f"events, expected the one arrival")
    if not losses or not np.isfinite(losses).all():
        raise RuntimeError(f"fed_train probe losses {losses}")
    row = dict(arch=cfg.name, wire=out["compression"], rounds=R,
               leaves=n_leaves, capacity=out["capacity"],
               launches_per_round={k: n // R for k, n in got.items() if n},
               warm_rounds_per_s=rounds_per_s, busy=busy,
               peak_gib=peak / 2 ** 30, card=card)
    del out, sch, seen
    torch.cuda.empty_cache()
    return row


@contextlib.contextmanager
def same_initial_params(drawn: list):
    """LMTask.init_params drawn on the CPU and moved to the device asked
    for, so the card's run and the CPU's start from the same params; each
    draw is kept in ``drawn``."""
    from unittest import mock

    from repro_torch.fed.task import LMTask
    init = LMTask.init_params

    def on_cpu(self, key, device=None):
        flat = init(self, key, device="cpu")
        drawn.append({k: v.clone() for k, v in flat.items()})
        return {k: v.to(device) for k, v in flat.items()}
    with mock.patch.object(LMTask, "init_params", on_cpu):
        yield


def fed_train_reduced_against_cpu(dev) -> float:
    """fed_train on TRAIN_ARCH's reduced config in f32 at its defaults with
    one arrival, FED_TRAIN_REDUCED_ROUNDS rounds, once per engine mode, on
    the card and on the CPU from the same initial params: equal round
    records (s bit for bit, events), the card's launches in the spans
    (client_parallel: masked_sgd E x leaves and weighted_agg once a round;
    client_sequential: masked_sgd capacity x E x leaves one-row launches a
    round and no reduction kernel), and each leaf's delta over the first
    span within TRAIN_DELTA_TOL of its norm (after TRAIN_FLIP_SHARE).
    Returns the largest raw ratio."""
    from repro_torch.kernels import ops
    from repro_torch.launch import fed_train
    R = FED_TRAIN_REDUCED_ROUNDS
    worst = 0.0
    for mode in FED_TRAIN_MODES:
        argv = FED_TRAIN_ARGS + ["--rounds", str(R), "--mode", mode]
        runs, drawn = {}, []
        for where in ("cpu", "card"):
            ops.reset_launches()
            with same_initial_params(drawn), watched_spans() as seen:
                out = fed_train.main(argv + (["--device", "cpu"]
                                             if where == "cpu" else []))
            runs[where] = (out, seen)
        sch = {w: runs[w][1]["schedulers"][0] for w in runs}
        if not all(same_records(a, b) for a, b in zip(
                sch["card"].history, sch["cpu"].history, strict=True)):
            raise RuntimeError(f"fed_train reduced {mode}: the card's round "
                               f"records differ from the CPU's")
        n_leaves, E = len(sch["card"].params), sch["card"].E
        cap = sch["card"].engine.capacity
        want = (expected_launches(masked_sgd=R * E * n_leaves,
                                  weighted_agg=R)
                if mode == "client_parallel" else
                expected_launches(masked_sgd=R * cap * E * n_leaves))
        got = span_launches(runs["card"][1])
        if got != want:
            raise RuntimeError(f"fed_train reduced {mode}: launches {got} "
                               f"in the spans, expected {want}")
        w0 = drawn[0]
        if any(not torch.equal(w0[k], drawn[1][k]) for k in w0):
            raise RuntimeError("the card's run and the CPU's started from "
                               "different params")
        first = {w: runs[w][1]["first"] for w in runs}
        rows, bad = [], []
        for name, w in w0.items():
            raw, kept, share, norm = delta_gap(first["card"][name],
                                               first["cpu"][name], w, E + 1)
            rows.append((raw / norm if norm else 0.0, name, share))
            if kept > TRAIN_DELTA_TOL * norm:
                bad.append((name, raw, kept, share, norm))
        rows.sort(reverse=True)
        worst = max(worst, rows[0][0])
        log(f"  fed_train {TRAIN_ARCH} reduced (f32), {mode}, {R} rounds, "
            f"capacity {cap}: records equal to the CPU's "
            f"({''.join(h.event for h in sch['card'].history)}); launches "
            f"in the spans {({k: n for k, n in got.items() if n})}; first "
            f"span's largest |d_card - d_cpu| / |d| {rows[0][0]:.3e} "
            f"({rows[0][1]}, elements {E + 1} ulps or less apart: "
            f"{rows[0][2]:.4f}); final probe loss card "
            f"{runs['card'][0]['final_loss']:.6f}, CPU "
            f"{runs['cpu'][0]['final_loss']:.6f}")
        if bad:
            raise RuntimeError(f"fed_train reduced {mode}: leaves outside "
                               f"TRAIN_DELTA_TOL (name, raw, kept, share, "
                               f"norm): {bad}")
    return worst


def fed_train_path(dev, card) -> list:
    rows = [fed_train_full_width(dev, card),
            fed_train_full_width(dev, card, "int8")]
    rows[0]["reduced_worst_delta_ratio"] = fed_train_reduced_against_cpu(dev)
    log(json.dumps({"fed_train": rows}))
    return rows


# -- 10. checkpoint and resume -------------------------------------------------
def checkpoint_scheduler(mode: str, compression=None):
    """The main path's federation on a StreamScheduler (model_kind "cnn",
    capacity CKPT_CAPACITY, eval on EVAL_EVERY rounds), with its events:
    CKPT_SHIFT, CKPT_BURST and CKPT_EXCLUDE before the cut,
    an Arrival of a brand-new client (the federation's 63rd shard) at
    CKPT_ARRIVE and CKPT_INCLUDE pending at it."""
    from repro_torch.configs.paper import EMNIST_CNN as cfg
    from repro_torch.core.participation import TRACES
    from repro_torch.fed import (Arrival, Departure, InactivityBurst,
                                 RoundEngine, StreamScheduler, TraceShift)
    from repro_torch.models.small import init_small, make_loss_fn
    clients = make_clients(N_CLIENTS + 1)
    for c in clients:                   # the events below say who moves
        c.active_from, c.departs_at = 0, None
    newcomer = clients.pop()
    engine = RoundEngine(
        loss_fn=make_loss_fn(cfg), clients=clients,
        local_epochs=cfg.local_epochs, batch_size=cfg.batch_size,
        scheme="C", eta0=cfg.eta0, capacity=CKPT_CAPACITY,
        max_samples=newcomer.n, compression=compression,
        model_kind=cfg.kind)
    tau, client, trace = CKPT_SHIFT
    start, duration, cohort = CKPT_BURST
    return StreamScheduler(
        clients=clients, init_params=init_small(cfg, seed=0,
                                                device=engine.device),
        engine=engine, mode=mode, eval_fn=emnist_eval, seed=0,
        events=[TraceShift(tau, client_id=client, trace=TRACES[trace]),
                InactivityBurst(start, duration=duration,
                                client_ids=cohort),
                Departure(CKPT_EXCLUDE[0], client_id=CKPT_EXCLUDE[1],
                          policy="exclude"),
                Arrival(CKPT_ARRIVE, client=newcomer),
                Departure(CKPT_INCLUDE[0], client_id=CKPT_INCLUDE[1],
                          policy="include")])


def differing(a: dict, b: dict) -> tuple:
    """(elements that differ, max abs difference) over two param dicts."""
    n, worst = 0, 0.0
    for k, v in a.items():
        d = (v.float() - b[k].float()).abs()
        n += int((d > 0).sum())
        worst = max(worst, float(d.max()))
    return n, worst


def checkpoint_leg(dev, n_leaves: int, mode: str, compression) -> dict:
    """One leg of the phase: uncut run, cut run saved, restored, resumed
    and held against the uncut run; a flipped byte refused."""
    import shutil
    from repro_torch.checkpoint import CorruptCheckpointError
    from repro_torch.configs.paper import EMNIST_CNN as cfg
    from repro_torch.fed import StreamScheduler
    from repro_torch.kernels import ops
    from repro_torch.models.small import make_loss_fn
    label = f"{mode}-{compression or 'f32'}"
    half = CKPT_ROUNDS // 2
    uncut = checkpoint_scheduler(mode, compression)
    uncut.run(CKPT_ROUNDS, eval_every=EVAL_EVERY)
    torch.cuda.synchronize()

    cut = checkpoint_scheduler(mode, compression)
    cut.run(half, eval_every=EVAL_EVERY)
    if cut.pending != 2:
        raise RuntimeError(f"{cut.pending} events pending at the cut, "
                           f"expected 2")
    path = ROOT / "build" / "checkpoint" / label
    shutil.rmtree(path, ignore_errors=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cut.save(str(path))
    save_s = time.perf_counter() - t0
    del cut                             # the scheduler and its engine
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    res = StreamScheduler.restore(str(path), loss_fn=make_loss_fn(cfg),
                                  eval_fn=emnist_eval)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    if res.engine.device.type != "cuda" or res.next_tau != half \
            or res.pending != 2:
        raise RuntimeError(f"restored onto {res.engine.device} at tau "
                           f"{res.next_tau} with {res.pending} pending")
    ops.reset_launches()
    res.run(CKPT_ROUNDS - half, eval_every=EVAL_EVERY)
    torch.cuda.synchronize()
    launches = dict(ops.launches)
    reduction = "weighted_agg_quant" if compression else "weighted_agg"
    want = expected_launches(**{
        reduction: CKPT_ROUNDS - half,
        "masked_sgd": (CKPT_ROUNDS - half) * n_leaves * cfg.local_epochs})
    if launches != want:
        raise RuntimeError(f"{label}: launches over the resumed rounds "
                           f"{launches} != expected {want}")

    for a, b in zip(res.history, uncut.history, strict=True):
        if not same_records(a, b) or \
                math.isnan(a.loss) != math.isnan(b.loss):
            raise RuntimeError(f"{label}: the resumed run's record at "
                               f"tau={a.tau} differs from the uncut run's")
        if not math.isnan(b.loss) and not (
                math.isfinite(a.loss) and abs(a.loss - b.loss)
                <= PARAM_TOL["atol"] + PARAM_TOL["rtol"] * abs(b.loss)):
            raise RuntimeError(f"{label}: eval loss {a.loss} resumed, "
                               f"{b.loss} uncut at tau={a.tau}")
    events = "".join(h.event for h in res.history)
    for tag in ("trace-shift:", "burst:", "departure-exclude:",
                f"arrival:{N_CLIENTS};", "departure-include:"):
        if tag not in events:
            raise RuntimeError(f"{label}: events {events!r} lack {tag!r}")
    for attr in ("objective", "slot_of", "departed", "lr_shift_tau",
                 "events_applied", "next_tau"):
        if getattr(res, attr) != getattr(uncut, attr):
            raise RuntimeError(f"{label}: restored {attr} differs")
    n_diff, err = differing(res.params, uncut.params)
    for name, p in uncut.params.items():
        torch.testing.assert_close(res.params[name], p, **PARAM_TOL,
                                   msg=f"{label} {name}")
    noise = ""
    if n_diff:
        again = checkpoint_scheduler(mode, compression)
        again.run(CKPT_ROUNDS, eval_every=EVAL_EVERY)
        torch.cuda.synchronize()
        n2, err2 = differing(again.params, uncut.params)
        noise = (f"; a second uncut run against the first: {n2} elements "
                 f"differ, max {err2:.3e}")
        del again

    npz = path / "fed_checkpoint.npz"
    npz_bytes = npz.stat().st_size
    manifest_bytes = (path / "fed_manifest.json").stat().st_size
    with open(npz, "r+b") as f:         # the planted fault: one byte
        f.seek(npz_bytes // 2)
        b = f.read(1)
        f.seek(-1, 1)
        f.write(bytes([b[0] ^ 0xFF]))
    try:
        StreamScheduler.restore(str(path), loss_fn=make_loss_fn(cfg))
    except CorruptCheckpointError as e:
        caught = ("CorruptCheckpointError, checksum" if "checksum" in str(e)
                  else f"CorruptCheckpointError: {e}")
    else:
        raise RuntimeError(f"{label}: a checkpoint with a flipped byte was "
                           f"restored")
    log(f"  {label}: cut at tau {half} of {CKPT_ROUNDS}; events "
        f"{events!r}; resumed records equal the uncut run's; launches over "
        f"the resumed rounds {{{reduction}: {launches[reduction]}, "
        f"masked_sgd: {launches['masked_sgd']}}}; params: {n_diff} of "
        f"{sum(p.numel() for p in res.params.values())} elements differ "
        f"from the uncut run's, max {err:.3e}{noise}; npz {npz_bytes} "
        f"bytes, manifest {manifest_bytes} bytes; save {save_s:.3f} s, "
        f"restore {restore_s:.3f} s; flipped byte refused ({caught})")
    del res, uncut
    torch.cuda.empty_cache()
    return dict(npz=npz_bytes, manifest=manifest_bytes, save_s=save_s,
                restore_s=restore_s, n_diff=n_diff)


def checkpoint_path(dev, n_leaves: int, card: str) -> None:
    """Phase 10: checkpoint and resume in device mode (f32), plan mode
    (f32) and device mode (int8)."""
    t0 = time.perf_counter()
    log(f"checkpoint and resume: StreamScheduler over the EMNIST "
        f"federation ({N_CLIENTS} clients, capacity {CKPT_CAPACITY}, "
        f"model_kind 'cnn'), TraceShift {CKPT_SHIFT}, InactivityBurst "
        f"{CKPT_BURST}, excluding Departure {CKPT_EXCLUDE}; an Arrival of "
        f"a new client at tau {CKPT_ARRIVE} and including Departure "
        f"{CKPT_INCLUDE} pending at the cut; on {card}")
    for mode, compression in CKPT_LEGS:
        checkpoint_leg(dev, n_leaves, mode, compression)
    log(f"  checkpoint phase: {time.perf_counter() - t0:.1f} s")


# -- 11. the streaming scenarios ----------------------------------------------
def param_tols(a: dict, b: dict) -> float:
    """The largest |a - b| / (atol + rtol |b|) over every element, PARAM_TOL's
    units (1 is its edge)."""
    return max(float(np.max(np.abs(np.asarray(a[k], np.float64)
                                   - np.asarray(v, np.float64))
                            / (PARAM_TOL["atol"] + PARAM_TOL["rtol"]
                               * np.abs(np.asarray(v, np.float64)))))
               for k, v in b.items())


def saved_run(path):
    """(history, params) of a fed_stream --save-state checkpoint."""
    from repro_torch.checkpoint.io import load_fed_checkpoint
    from repro_torch.fed.stream import history_from_dict
    params, _, history, _, _ = load_fed_checkpoint(str(path))
    return history_from_dict(history), params


def same_run_records(label: str, got, want) -> None:
    """Equal round records (s bit for bit), the same eval rounds, finite
    eval losses."""
    if len(got) != len(want):
        raise RuntimeError(f"{label}: {len(got)} rounds against "
                           f"{len(want)}")
    for a, b in zip(got, want):
        if not same_records(a, b) or math.isnan(a.loss) != math.isnan(b.loss):
            raise RuntimeError(f"{label}: the record at tau={a.tau} differs")
        if not math.isnan(a.loss) and not (math.isfinite(a.loss)
                                           and math.isfinite(a.acc)):
            raise RuntimeError(f"{label}: non-finite eval at tau={a.tau}")


def scenario_cli(args, dev, path):
    """fed_stream's main on dev (or the CPU), saving its end state at path:
    (summary, launches, history, params)."""
    import shutil
    from repro_torch.kernels import ops
    from repro_torch.launch.fed_stream import main as fed_stream
    shutil.rmtree(path, ignore_errors=True)
    device = [] if dev.type == "cuda" else ["--device", "cpu"]
    ops.reset_launches()
    summary = fed_stream(list(args) + device + ["--quiet", "--save-state",
                                                 str(path)])
    torch.cuda.synchronize()
    launches = dict(ops.launches)
    return (summary, launches) + saved_run(path)


def first_span_against_cpu(name: str, dev) -> float:
    """The scenario's first span (round 0, an eval round) from the
    reference's initial params on the card and on the CPU: the card's
    params in PARAM_TOLs of the CPU's (at most 1)."""
    from repro_torch.fed.scenarios import build_scheduler, make_scenario
    runs = []
    for device in (dev, "cpu"):
        sc = make_scenario(name)
        sch = build_scheduler(sc, device=device)
        sch.run(1, eval_every=sc.eval_every)
        runs.append({k: v.cpu().numpy() for k, v in sch.params.items()})
    d = param_tols(*runs)
    if d > 1:
        raise RuntimeError(f"{name}: the first span's params lie {d:.3f} "
                           f"PARAM_TOLs from the CPU's")
    return d


def scenario_path(dev, card: str) -> dict:
    """Phase 11: the five scenarios through fed_stream on the card and the
    CPU, churn on the int8 wire in plan mode, rotation cut and resumed.
    Returns each scenario's card run: {name: (history, params,
    summary)}."""
    from repro_torch.configs.paper import SYNTHETIC_LR
    from repro_torch.fed.scenarios import SCENARIOS, make_scenario
    t0 = time.perf_counter()
    cpu = torch.device("cpu")
    out = ROOT / "build" / "scenarios"
    leaves = 2                          # the logreg's w and b
    log(f"streaming scenarios: repro_torch.launch.fed_stream at each "
        f"scenario's defaults, on the card (device mode, f32) and with "
        f"--device cpu; {SYNTHETIC_LR.name}, from the reference's initial "
        f"params; on {card}")
    uncut = {}
    for name in SCENARIOS:
        sc = make_scenario(name)
        summary, launches, history, params = scenario_cli(
            ["--scenario", name], dev, out / f"{name}-card")
        c_summary, _, c_history, c_params = scenario_cli(
            ["--scenario", name], cpu, out / f"{name}-cpu")
        same_run_records(name, history, c_history)
        for key in ("events_applied", "clients_end", "rounds", "evals"):
            if summary[key] != c_summary[key]:
                raise RuntimeError(f"{name}: {key} {summary[key]} on the "
                                   f"card, {c_summary[key]} on the CPU")
        R = summary["rounds"]
        want = expected_launches(weighted_agg=R,
                                 masked_sgd=R * leaves * sc.local_epochs)
        if launches != want:
            raise RuntimeError(f"{name}: launches {launches} != {want}")
        first = first_span_against_cpu(name, dev)
        final = param_tols(params, c_params)
        uncut[name] = (history, params, summary)
        log(f"  {name} ({sc.notes}): {R} rounds, {summary['events_applied']} "
            f"events, clients_end {summary['clients_end']}, records equal "
            f"to the CPU's; launches weighted_agg {launches['weighted_agg']}, "
            f"masked_sgd {launches['masked_sgd']}; rounds/s card "
            f"{summary['rounds_per_sec']} (wall {summary['wall_s']} s, "
            f"build included), CPU {c_summary['rounds_per_sec']}; first "
            f"span's params {first:.3f} PARAM_TOLs from the CPU's, final "
            f"{final:.3f}; final loss {summary['final_loss']:.6f} card, "
            f"{c_summary['final_loss']:.6f} CPU")

    args = ["--scenario", "churn", "--compress", "int8", "--mode", "plan"]
    summary, launches, history, _ = scenario_cli(args, dev,
                                                 out / "churn-int8-card")
    _, _, c_history, _ = scenario_cli(args, cpu, out / "churn-int8-cpu")
    same_run_records("churn int8 plan", history, c_history)
    R = summary["rounds"]
    want = expected_launches(weighted_agg_quant=R,
                             masked_sgd=R * leaves * SYNTHETIC_LR.local_epochs)
    if launches != want or summary["compression"] != "int8":
        raise RuntimeError(f"churn int8: launches {launches} != {want} "
                           f"(wire {summary['compression']})")
    log(f"  churn --compress int8 --mode plan: {R} rounds, records equal to "
        f"the CPU's; launches weighted_agg_quant "
        f"{launches['weighted_agg_quant']}, weighted_agg "
        f"{launches['weighted_agg']}, masked_sgd {launches['masked_sgd']}; "
        f"rounds/s {summary['rounds_per_sec']}")

    total = make_scenario("rotation").n_rounds
    scenario_cli(["--scenario", "rotation", "--rounds", str(SCENARIO_CUT)],
                 dev, out / "rotation-cut")
    summary, launches, history, params = scenario_cli(
        ["--scenario", "rotation", "--restore", str(out / "rotation-cut"),
         "--rounds", str(total - SCENARIO_CUT)], dev,
        out / "rotation-resumed")
    want_history, want_params, _ = uncut["rotation"]
    same_run_records("rotation resumed", history, want_history)
    n_diff = sum(int(np.sum(params[k] != v)) for k, v in want_params.items())
    R = total - SCENARIO_CUT
    want = expected_launches(weighted_agg=R,
                             masked_sgd=R * leaves * SYNTHETIC_LR.local_epochs)
    if n_diff or launches != want or summary["resumed_from"] != SCENARIO_CUT:
        raise RuntimeError(f"rotation resumed at {summary['resumed_from']}: "
                           f"{n_diff} params differ from the uncut run's, "
                           f"launches {launches} != {want}")
    log(f"  rotation cut at tau {SCENARIO_CUT} and restored onto the card: "
        f"records of all {total} rounds equal the uncut run's, 0 param "
        f"elements differ; launches over the resumed rounds weighted_agg "
        f"{launches['weighted_agg']}, masked_sgd {launches['masked_sgd']}")
    log(f"  scenario phase: {time.perf_counter() - t0:.1f} s")
    return uncut


# -- 12. the tiered client bank and its cohort prefetch ----------------------
def bank_rotation():
    """make_clients' 62-client EMNIST fleet and the reference's rotation
    schedule over it (BANK_HOT slots, dwell BANK_DWELL, BANK_ROUNDS
    rounds): (clients, events)."""
    from repro_torch.fed.scenarios import rotation_events
    clients = make_clients()
    for c in clients:                   # the events say who moves
        c.active_from, c.departs_at = 0, None
    return clients, rotation_events(clients, BANK_HOT, BANK_DWELL,
                                    BANK_ROUNDS)


def bank_scheduler(dev, mode: str, capacity: int, prefetch: bool,
                   fleet=None, preload: bool = True):
    """The EMNIST fleet at full width (``fleet``, bank_rotation()'s by
    default) on a scheduler-built engine of ``capacity`` slots, the first
    BANK_HOT founding and, with ``preload``, the rotation schedule pushed
    at the start."""
    from repro_torch.configs.paper import EMNIST_CNN as cfg
    from repro_torch.fed import StreamScheduler
    from repro_torch.models.small import init_small, make_loss_fn
    clients, events = fleet if fleet is not None else bank_rotation()
    return StreamScheduler(
        clients=clients[:BANK_HOT],
        init_params=init_small(cfg, seed=0, device=dev),
        loss_fn=make_loss_fn(cfg), eval_fn=emnist_eval, capacity=capacity,
        max_samples=max(c.n for c in clients),
        local_epochs=cfg.local_epochs, batch_size=cfg.batch_size,
        scheme="C", eta0=cfg.eta0, seed=0, mode=mode, prefetch=prefetch,
        model_kind=cfg.kind, device=dev, events=events if preload else ())


def check_stager(label: str, stats: dict, misses: bool = True) -> dict:
    """No staging error (a failed copy or launch on the staging thread would
    otherwise pass as a slower miss), and with ``misses`` no miss."""
    stager = stats["stager"]
    if stager["stage_errors"] or (misses and stats["misses"]):
        raise RuntimeError(f"{label}: stage_errors "
                           f"{stager['stage_errors']}, misses "
                           f"{stats['misses']}")
    return stager


def stager_line(stats: dict) -> str:
    st = stats["stager"]
    return (f"hits {stats['hits']}, misses {stats['misses']}, "
            f"{st['cohorts_staged']} cohorts of {st['rows_staged']} rows, "
            f"stage {st['stage_seconds_total']:.6f} s, wait "
            f"{st['wait_seconds_total']:.6f} s, overlap "
            f"{st['overlap_fraction']:.4f}, superseded {st['superseded']}")


def bank_fleet(dev, card: str, n_leaves: int) -> None:
    """Phase 12 (a): the EMNIST fleet through BANK_HOT slots with prefetch,
    in plan and device mode, against the same schedule on the same slots
    without a bank (bit-identical params) and, in plan mode, against all 62
    clients resident (params within PARAM_TOL); warm rounds/s in turns."""
    from repro_torch.configs.paper import EMNIST_CNN as cfg
    from repro_torch.kernels import ops
    arrivals = len(range(BANK_DWELL, BANK_ROUNDS, BANK_DWELL))
    for mode in ("plan", "device"):
        label = f"EMNIST fleet {mode}"
        plain = bank_scheduler(dev, mode, BANK_HOT, prefetch=False)
        plain.run(BANK_ROUNDS, eval_every=BANK_EVAL_EVERY)
        banked = bank_scheduler(dev, mode, BANK_HOT, prefetch=True)
        torch.cuda.synchronize()
        ops.reset_launches()
        banked.run(BANK_ROUNDS, eval_every=BANK_EVAL_EVERY)
        torch.cuda.synchronize()
        launches = dict(ops.launches)
        banked.close()
        want = expected_launches(
            weighted_agg=BANK_ROUNDS,
            masked_sgd=BANK_ROUNDS * n_leaves * cfg.local_epochs)
        if launches != want:
            raise RuntimeError(f"{label}: launches {launches} != {want}")
        stats = banked.prefetch_stats()
        stager = check_stager(label, stats)
        if stats["hits"] != arrivals:
            raise RuntimeError(f"{label}: {stats['hits']} prefetch hits, "
                               f"{arrivals} arrivals")
        same_run_records(label, banked.history, plain.history)
        for a, b in zip(banked.history, plain.history):
            if not math.isnan(a.loss) and (a.loss, a.acc) != (b.loss, b.acc):
                raise RuntimeError(f"{label}: eval at tau={a.tau} differs")
        n_diff, err = differing(banked.params, plain.params)
        if n_diff:
            raise RuntimeError(f"{label}: {n_diff} param elements differ "
                               f"from the unbanked run's (max {err:.3e})")
        bank = stats["bank"]
        cohort = 1 << (stager["rows_staged"] - 1).bit_length()
        log(f"  {label}: {len(banked.clients)} clients through "
            f"{banked.engine.capacity} slots, {arrivals} arrivals; records "
            f"equal, 0 of {sum(p.numel() for p in banked.params.values())} "
            f"param elements differ from the unbanked run's; launches "
            f"weighted_agg {launches['weighted_agg']}, masked_sgd "
            f"{launches['masked_sgd']}; bank {bank['clients']} clients, "
            f"{bank['resident_bytes']} bytes ({bank['row_nbytes']} a row); "
            f"{stager_line(stats)}; first cohort padded to {cohort} rows, "
            f"{cohort * bank['row_nbytes']} bytes")
        if mode == "plan":
            big = bank_scheduler(dev, mode, N_CLIENTS, prefetch=False)
            big.run(BANK_ROUNDS, eval_every=BANK_EVAL_EVERY)
            torch.cuda.synchronize()
            if any(h.s[BANK_HOT:].any() for h in big.history):
                raise RuntimeError(f"{label}: a slot past {BANK_HOT} trained")
            same_run_records(f"{label} against 62 resident", banked.history,
                             [dataclasses.replace(h, s=h.s[:BANK_HOT])
                              for h in big.history])
            n_diff, err = differing(banked.params, big.params)
            for name, v in big.params.items():
                torch.testing.assert_close(banked.params[name], v,
                                           **PARAM_TOL, msg=f"{label} {name}")
            log(f"  {label} against all {N_CLIENTS} clients resident: "
                f"records equal (the extra slots' s all 0), params within "
                f"PARAM_TOL: {n_diff} elements differ, max {err:.3e} (a "
                f"{BANK_HOT}-client and a {N_CLIENTS}-client batch of the "
                f"CNN sum in other orders)")
            del big
        del plain, banked
        torch.cuda.empty_cache()

    rates = {False: [], True: []}
    staged = []
    for prefetch in [False, True, True, False] * BANK_TURNS:
        sch = bank_scheduler(dev, "device", BANK_HOT, prefetch=prefetch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sch.run(BANK_ROUNDS, eval_every=NO_EVAL)
        torch.cuda.synchronize()
        rates[prefetch].append(BANK_ROUNDS / (time.perf_counter() - t0))
        sch.close()
        if prefetch:
            stats = sch.prefetch_stats()
            check_stager("EMNIST fleet timed", stats)
            staged.append(stats["stager"])
        del sch
    def listed(values, digits):
        return ", ".join(f"{v:.{digits}f}" for v in values)
    log(f"  EMNIST fleet, device mode, {BANK_ROUNDS} rounds a window, no "
        f"eval, in turns (plain, prefetch, prefetch, plain) x {BANK_TURNS}: "
        f"rounds/s without a bank {listed(rates[False], 3)}; with prefetch "
        f"{listed(rates[True], 3)}; stage seconds "
        f"{listed([st['stage_seconds_total'] for st in staged], 6)}; wait "
        f"seconds {listed([st['wait_seconds_total'] for st in staged], 6)}; "
        f"overlap {listed([st['overlap_fraction'] for st in staged], 4)}; "
        f"on {card}")


def bank_scenarios(dev, card: str, uncut: dict) -> None:
    """Phase 12 (b): every scenario at its defaults with --prefetch (and
    rotation with --bank alone) through fed_stream on the card, against
    step 11's runs without a bank."""
    from repro_torch.configs.paper import SYNTHETIC_LR
    from repro_torch.fed.scenarios import SCENARIOS
    out = ROOT / "build" / "bank"
    leaves = 2
    for name in SCENARIOS:
        for flag in ["--prefetch"] + (["--bank"] if name == "rotation"
                                      else []):
            label = f"{name} {flag}"
            summary, launches, history, params = scenario_cli(
                ["--scenario", name, flag], dev, out / f"{name}{flag}")
            want_history, want_params, want_summary = uncut[name]
            same_run_records(label, history, want_history)
            for a, b in zip(history, want_history):
                if not math.isnan(a.loss) and a.loss != b.loss:
                    raise RuntimeError(f"{label}: eval at tau={a.tau}")
            n_diff = sum(int(np.sum(params[k] != v))
                         for k, v in want_params.items())
            R = summary["rounds"]
            want = expected_launches(
                weighted_agg=R,
                masked_sgd=R * leaves * SYNTHETIC_LR.local_epochs)
            if n_diff or launches != want:
                raise RuntimeError(f"{label}: {n_diff} params differ from "
                                   f"the unbanked run's, launches "
                                   f"{launches} != {want}")
            bank = summary["bank"]
            detail = f"bank {bank['bank']['clients']} clients"
            if flag == "--prefetch":
                check_stager(label, bank,
                             misses=name in ("flash-crowd", "rotation"))
                detail += f", {stager_line(bank)}"
            elif "stager" in bank:
                raise RuntimeError(f"{label}: a stager without --prefetch")
            log(f"  {label}: records equal and 0 param elements differ from "
                f"step 11's card run; launches weighted_agg "
                f"{launches['weighted_agg']}, masked_sgd "
                f"{launches['masked_sgd']}; {detail}; rounds/s "
                f"{summary['rounds_per_sec']} (step 11: "
                f"{want_summary['rounds_per_sec']})")


def bank_checkpoint(dev, uncut: dict) -> None:
    """Phase 12 (c): rotation with --prefetch saved at SCENARIO_CUT (v2,
    one chunk per client), restored onto the card with its bank and stager
    rebuilt, against the uncut run; a flipped byte of a chunk refused."""
    import shutil
    from repro_torch.checkpoint import CorruptCheckpointError
    from repro_torch.configs.paper import SYNTHETIC_LR
    from repro_torch.fed import StreamScheduler
    from repro_torch.fed.scenarios import make_scenario
    from repro_torch.models.small import make_loss_fn
    out = ROOT / "build" / "bank"
    total = make_scenario("rotation").n_rounds
    cut = out / "rotation-prefetch-cut"
    _, _, cut_history, _ = scenario_cli(
        ["--scenario", "rotation", "--prefetch", "--rounds",
         str(SCENARIO_CUT)], dev, cut)
    manifest = json.loads((cut / "fed_manifest.json").read_text())
    chunks = sorted((cut / "clients").glob("client-*.npz"))
    cfg = manifest["config"]
    if manifest["format"] != "fed-checkpoint-v2" or not cfg["bank"] \
            or not cfg["prefetch"] \
            or len(chunks) != len(manifest["client_chunks"]):
        raise RuntimeError(f"rotation --prefetch at tau {SCENARIO_CUT}: "
                           f"{manifest['format']}, bank {cfg['bank']}, "
                           f"prefetch {cfg['prefetch']}, {len(chunks)} "
                           f"chunk files for "
                           f"{len(manifest['client_chunks'])} clients")
    summary, launches, history, params = scenario_cli(
        ["--scenario", "rotation", "--restore", str(cut), "--rounds",
         str(total - SCENARIO_CUT)], dev, out / "rotation-prefetch-resumed")
    want_history, want_params, _ = uncut["rotation"]
    same_run_records("rotation --prefetch resumed", history, want_history)
    n_diff = sum(int(np.sum(params[k] != v)) for k, v in want_params.items())
    if n_diff or summary["resumed_from"] != SCENARIO_CUT:
        raise RuntimeError(f"rotation --prefetch resumed at "
                           f"{summary['resumed_from']}: {n_diff} params "
                           f"differ from the uncut run's")
    if "stager" not in summary["bank"]:
        raise RuntimeError("the restored rotation has no stager")
    check_stager("rotation --prefetch resumed", summary["bank"])
    bad = out / "rotation-prefetch-flipped"
    shutil.rmtree(bad, ignore_errors=True)
    shutil.copytree(cut, bad)
    chunk = sorted((bad / "clients").glob("client-*.npz"))[len(chunks) // 2]
    raw = bytearray(chunk.read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    chunk.write_bytes(bytes(raw))
    try:
        StreamScheduler.restore(str(bad), loss_fn=make_loss_fn(SYNTHETIC_LR),
                                model_kind=SYNTHETIC_LR.kind)
    except CorruptCheckpointError as e:
        caught = ("CorruptCheckpointError, checksum" if "checksum" in str(e)
                  else f"CorruptCheckpointError: {e}")
    else:
        raise RuntimeError("a bank checkpoint with a flipped byte in "
                           f"{chunk.name} was restored")
    log(f"  rotation --prefetch cut at tau {SCENARIO_CUT}: "
        f"{manifest['format']}, {len(chunks)} client chunks, config bank "
        f"and prefetch true; restored onto the card with its bank "
        f"({summary['bank']['bank']['clients']} clients) and stager rebuilt: "
        f"records of all {total} rounds equal the uncut run's, 0 param "
        f"elements differ; {stager_line(summary['bank'])}; a flipped byte "
        f"in {chunk.name} refused ({caught})")


def bank_telemetry(dev, uncut: dict) -> None:
    """Phase 12 (d): flash-crowd with --metrics-out and --prom-out: the
    wire counter against the records, the run_span histogram against the
    span counter, params bit-identical to the run without telemetry; one
    span under Telemetry(trace_dir=)."""
    from repro_torch.core.compression import wire_bytes
    from repro_torch.fed.scenarios import build_scheduler, make_scenario
    from repro_torch.obs import Telemetry
    out = ROOT / "build" / "bank"
    out.mkdir(parents=True, exist_ok=True)
    jsonl, prom = out / "flash-crowd.jsonl", out / "flash-crowd.prom"
    for path in (jsonl, prom):
        path.unlink(missing_ok=True)
    summary, _, history, params = scenario_cli(
        ["--scenario", "flash-crowd", "--metrics-out", str(jsonl),
         "--prom-out", str(prom)], dev, out / "flash-crowd-telemetry")
    recs = [json.loads(line) for line in jsonl.read_text().splitlines()]
    metrics = {r["name"]: r for r in recs if r["kind"] != "span"}
    D = sum(int(np.asarray(v).size) for v in params.values())
    uploads = sum(int((np.asarray(h.s) > 0).sum()) for h in history)
    (wire,) = metrics["fed_wire_bytes_total"]["samples"]
    want_wire = wire_bytes(D, summary["compression"], n_clients=uploads)
    spans = {s["labels"]["name"]: s["count"]
             for s in metrics["span_seconds"]["samples"]}
    (sched_spans,) = metrics["sched_spans_total"]["samples"]
    if wire["value"] != want_wire or \
            wire["labels"] != {"wire": summary["compression"]}:
        raise RuntimeError(f"fed_wire_bytes_total {wire} != wire_bytes({D}) "
                           f"x {uploads} uploads = {want_wire}")
    if spans["sched.run_span"] != sched_spans["value"]:
        raise RuntimeError(f"{spans['sched.run_span']} sched.run_span spans, "
                           f"sched_spans_total {sched_spans['value']}")
    line = f'fed_wire_bytes_total{{wire="{summary["compression"]}"}} '
    if line + str(want_wire) not in prom.read_text().splitlines():
        raise RuntimeError(f"{prom.name} lacks {line}{want_wire}")
    _, want_params, _ = uncut["flash-crowd"]
    n_diff = sum(int(np.sum(params[k] != v)) for k, v in want_params.items())
    if n_diff:
        raise RuntimeError(f"flash-crowd with telemetry: {n_diff} params "
                           f"differ from the run without")
    trace_dir = out / "trace"
    for old in trace_dir.glob("*.json"):
        old.unlink()
    sch = build_scheduler(make_scenario("flash-crowd"), device=dev,
                          telemetry=Telemetry(trace_dir=str(trace_dir)))
    sch.run(1, eval_every=NO_EVAL)
    torch.cuda.synchronize()
    (trace,) = trace_dir.glob("run_span-*.json")
    text = trace.read_text()
    named = [k for k in ("weighted_agg", "masked_sgd") if k in text]
    if len(named) != 2:
        raise RuntimeError(f"{trace.name} names only {named}")
    log(f"  flash-crowd --metrics-out --prom-out: fed_wire_bytes_total"
        f"{{wire=\"{summary['compression']}\"}} {wire['value']:.0f} = "
        f"wire_bytes({D}) x {uploads} uploads counted from the records; "
        f"span_seconds{{name=\"sched.run_span\"}} count "
        f"{spans['sched.run_span']} = sched_spans_total; span counts "
        f"{dict(sorted(spans.items()))}; {len(recs)} JSONL lines, "
        f"{len(prom.read_text().splitlines())} prom lines; params "
        f"bit-identical to the run without telemetry; one span under "
        f"Telemetry(trace_dir=): {trace.name}, {trace.stat().st_size} "
        f"bytes, naming weighted_agg and masked_sgd")


def bank_path(dev, card: str, n_leaves: int, uncut: dict) -> None:
    """Phase 12: the tiered client bank with its prefetch on a CUDA staging
    stream, and the telemetry, through the entry points."""
    t0 = time.perf_counter()
    log(f"client bank and prefetch: the EMNIST fleet ({N_CLIENTS} clients) "
        f"through {BANK_HOT} slots on the reference's rotation (dwell "
        f"{BANK_DWELL}, {BANK_ROUNDS} rounds), the scenarios with --prefetch, "
        f"a bank checkpoint and telemetry; on {card}")
    bank_fleet(dev, card, n_leaves)
    bank_scenarios(dev, card, uncut)
    bank_checkpoint(dev, uncut)
    bank_telemetry(dev, uncut)
    log(f"  bank phase: {time.perf_counter() - t0:.1f} s")


# -- 13. the federation service ----------------------------------------------
def serve_live(svc, events, rounds: int) -> None:
    """Serve ``rounds`` rounds while this thread submits ``events``: the
    worker runs spans of SERVICE_SPAN rounds and ingests at their
    boundaries, so each event goes in at least a span ahead of its tau.
    The round budget (``svc.max_rounds``) is raised a span at a time, each
    time after every event with a tau up to a span past the new budget was
    submitted, and again as soon as the worker starts the last span before
    it: a late thread stalls the worker at its budget instead of handing it
    an event after its tau.  Raises if the service stops short."""
    events = sorted(events, key=lambda e: e.tau)      # stable: push order
    j, budget = 0, 0
    svc.max_rounds = 0
    with svc:
        while budget < rounds:
            budget = min(rounds, budget + SERVICE_SPAN)
            while j < len(events) and events[j].tau < budget + SERVICE_SPAN:
                svc.submit(events[j])
                j += 1
            svc.max_rounds = budget
            svc.resume()                  # wake a worker parked at the budget
            if not svc.wait_rounds(budget - SERVICE_SPAN, timeout=600):
                raise RuntimeError(f"the service stalled: {svc.stats()}")
        svc.submit(*events[j:])
        if not (svc.drain(timeout=600) and svc.wait_rounds(rounds,
                                                           timeout=600)):
            raise RuntimeError(f"the service stopped short: {svc.stats()}")


def service_live(dev, n_leaves: int):
    """Phase 13 (a): the EMNIST fleet through BANK_HOT slots with prefetch,
    in device mode, its rotation events submitted from this thread while
    the service's worker runs spans, against the same schedule preloaded
    into a blocking scheduler: (blocking history, blocking params)."""
    from repro_torch.configs.paper import EMNIST_CNN as cfg
    from repro_torch.fed import FederationService
    from repro_torch.kernels import ops
    label = "service, events submitted live"
    blocking = bank_scheduler(dev, "device", BANK_HOT, prefetch=True)
    blocking.run(BANK_ROUNDS, eval_every=BANK_EVAL_EVERY)
    torch.cuda.synchronize()
    blocking.close()
    fleet = bank_rotation()
    sch = bank_scheduler(dev, "device", BANK_HOT, prefetch=True, fleet=fleet,
                         preload=False)
    svc = FederationService(sch, span_rounds=SERVICE_SPAN,
                            eval_every=BANK_EVAL_EVERY)
    torch.cuda.synchronize()
    ops.reset_launches()
    serve_live(svc, fleet[1], BANK_ROUNDS)
    torch.cuda.synchronize()
    launches = dict(ops.launches)
    want = expected_launches(
        weighted_agg=BANK_ROUNDS,
        masked_sgd=BANK_ROUNDS * n_leaves * cfg.local_epochs)
    if launches != want:
        raise RuntimeError(f"{label}: launches {launches} != {want}")
    st = svc.stats()
    n_events = len(fleet[1])
    counts = (st["events_submitted"], st["events_ingested"],
              st["events_applied"])
    if counts != (n_events,) * 3 or st["events_pending"]:
        raise RuntimeError(f"{label}: {n_events} events; submitted, "
                           f"ingested, applied {counts}, pending "
                           f"{st['events_pending']}")
    check_stager(label, st["prefetch"], misses=False)
    same_run_records(label, sch.history, blocking.history)
    for a, b in zip(sch.history, blocking.history):
        if not math.isnan(a.loss) and (a.loss, a.acc) != (b.loss, b.acc):
            raise RuntimeError(f"{label}: eval at tau={a.tau} differs")
    n_diff, err = differing(sch.params, blocking.params)
    if n_diff:
        raise RuntimeError(f"{label}: {n_diff} param elements differ from "
                           f"the preloaded run's (max {err:.3e})")
    log(f"  {label}: {n_events} rotation events submitted from the main "
        f"thread while the worker ran {st['spans_run']} spans of "
        f"{SERVICE_SPAN} rounds; submitted, ingested and applied "
        f"{counts[0]}, {counts[1]}, {counts[2]}; records equal and 0 of "
        f"{sum(p.numel() for p in sch.params.values())} param elements "
        f"differ from the same schedule preloaded into a blocking "
        f"scheduler; launches weighted_agg {launches['weighted_agg']}, "
        f"masked_sgd {launches['masked_sgd']} over {BANK_ROUNDS} rounds; "
        f"{stager_line(st['prefetch'])}")
    return blocking.history, blocking.params


def service_chaos(dev, want_history, want_params) -> None:
    """Phase 13 (b): the same fleet and schedule, supervised, through
    SERVICE_SOAK's six faults with the engine reused in every recovery,
    against (a)'s preloaded run."""
    import shutil
    from repro_torch.configs.paper import EMNIST_CNN as cfg
    from repro_torch.fed import Fault, FaultPlan, FederationService
    from repro_torch.kernels import ops
    from repro_torch.models.small import make_loss_fn
    label = "service chaos soak"
    snapshots = ROOT / "build" / "service" / "soak"
    shutil.rmtree(snapshots, ignore_errors=True)
    fleet = bank_rotation()
    sch = bank_scheduler(dev, "device", BANK_HOT, prefetch=True, fleet=fleet,
                         preload=False)
    sch.injector = FaultPlan([Fault(*f) for f in SERVICE_SOAK], seed=7)
    engine = sch.engine
    svc = FederationService(
        sch, span_rounds=SERVICE_SPAN, eval_every=BANK_EVAL_EVERY,
        max_rounds=BANK_ROUNDS, supervise=True, snapshot_dir=str(snapshots),
        snapshot_every=1, keep_snapshots=4, backoff0=0.01, join_timeout=10.0,
        span_timeout=SERVICE_SPAN_TIMEOUT, queue_policy="merge-stale",
        max_queue=64, engine_factory=lambda: engine,
        restore_kwargs=dict(loss_fn=make_loss_fn(cfg), eval_fn=emnist_eval))
    svc.submit(*fleet[1])
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    with svc:
        if not svc.wait_rounds(BANK_ROUNDS, timeout=600):
            raise RuntimeError(f"{label}: stopped short: {svc.stats()}")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.launches)
    rep = svc.chaos_report()
    recs = rep["recoveries"]
    sites = {site for site, _, _ in rep["faults"]["fired"]}
    causes = [r["cause"] for r in recs]
    bad = [c for c in causes if not c.startswith(("InjectedFault(",
                                                  "TimeoutError("))]
    if bad:
        raise RuntimeError(f"{label}: recoveries from faults that were not "
                           f"injected: {bad}")
    if sites != {"worker", "sched_span", "ckpt_save", "ckpt_written",
                 "flood"} or rep["n_recoveries"] < 3 \
            or rep["snapshot_failures"] < 1 or rep["events_merged"] != 256 \
            or not any(c.startswith("TimeoutError(") for c in causes) \
            or not all(r["engine_reused"] for r in recs):
        raise RuntimeError(f"{label}: sites {sorted(sites)}, "
                           f"{rep['n_recoveries']} recoveries, "
                           f"{rep['snapshot_failures']} snapshot failures, "
                           f"{rep['events_merged']} merged, causes {causes}, "
                           f"engine reused "
                           f"{[r['engine_reused'] for r in recs]}")
    restored = svc.scheduler
    if restored.engine is not engine or restored.engine.device != dev:
        raise RuntimeError(f"{label}: the last generation runs on another "
                           f"engine ({restored.engine.device})")
    stager = check_stager(label, restored.prefetch_stats(), misses=False)
    same_run_records(label, restored.history, want_history)
    for a, b in zip(restored.history, want_history):
        if not math.isnan(a.loss) and (a.loss, a.acc) != (b.loss, b.acc):
            raise RuntimeError(f"{label}: eval at tau={a.tau} differs")
    n_diff, err = differing(restored.params, want_params)
    if n_diff:
        raise RuntimeError(f"{label}: {n_diff} param elements differ from "
                           f"the run without faults (max {err:.3e})")
    served = BANK_ROUNDS + rep["recovered_rounds"]
    if launches["weighted_agg"] < served:
        raise RuntimeError(f"{label}: weighted_agg launched "
                           f"{launches['weighted_agg']} times for {served} "
                           f"rounds served and recovered")
    log(f"  {label}: faults fired {rep['faults']['fired']}; "
        f"{rep['n_recoveries']} recoveries, each onto the same engine, "
        f"causes {causes}; snapshot failures {rep['snapshot_failures']}, "
        f"events merged {rep['events_merged']}; records equal and 0 param "
        f"elements differ from the run without faults; stage_errors "
        f"{stager['stage_errors']} after the last recovery")
    log(f"  {label}: MTTR mean {rep['mttr_mean_s']:.4f} s, max "
        f"{rep['mttr_max_s']:.4f} s; detection latency mean "
        f"{rep['detect_latency_mean_s']:.4f} s, max "
        f"{rep['detect_latency_max_s']:.4f} s; per recovery (cause, "
        f"detect s, mttr s, tau failed -> resumed, corrupt skipped, "
        f"replayed): "
        + "; ".join(f"{r['cause'].split('(')[0]} "
                    f"{r['detect_latency_s']:.4f} {r['mttr_s']:.4f} "
                    f"{r['tau_at_failure']}->{r['tau_resumed']} "
                    f"{len(r['corrupt_skipped'])} {r['events_replayed']}"
                    for r in recs)
        + f"; recovered rounds {rep['recovered_rounds']}; weighted_agg "
        f"launches {launches['weighted_agg']} beside {BANK_ROUNDS} rounds "
        f"served + {rep['recovered_rounds']} recovered (a mid-span crash's "
        f"torn rounds count in neither); wall {wall:.3f} s")


def fed_serve_cli(args, path):
    """fed_serve's main on the card, its scenario events submitted at
    SERVICE_EVENTS_PER_S and its end state saved at ``path``: (summary,
    history, params)."""
    import shutil
    from repro_torch.launch import fed_serve
    shutil.rmtree(path, ignore_errors=True)
    summary = fed_serve.main(list(args) + [
        "--events-per-sec", SERVICE_EVENTS_PER_S, "--snapshot", str(path),
        "--quiet"])
    torch.cuda.synchronize()
    return (summary,) + saved_run(path)


def same_cli_run(label: str, got, want) -> None:
    """Equal records (the eval rounds' losses too) and params, bit for
    bit, of two fed_serve_cli runs."""
    _, history, params = got
    _, want_history, want_params = want
    same_run_records(label, history, want_history)
    for a, b in zip(history, want_history):
        if not math.isnan(a.loss) and (a.loss, a.acc) != (b.loss, b.acc):
            raise RuntimeError(f"{label}: eval at tau={a.tau} differs")
    n_diff = sum(int(np.sum(params[k] != v)) for k, v in want_params.items())
    if n_diff:
        raise RuntimeError(f"{label}: {n_diff} param elements differ")


def service_cli(dev) -> None:
    """Phase 13 (c): fed_serve on the card: churn with --chaos against the
    run without, a flash-crowd trace dumped and replayed against the paced
    run, flash-crowd with --chaos and --metrics-out; then one FedTop frame
    of a live service."""
    from repro_torch.fed import FederationService
    from repro_torch.fed.scenarios import build_scheduler, make_scenario
    from repro_torch.launch import fed_serve
    from repro_torch.launch.fed_top import FedTop
    from repro_torch.obs import Telemetry
    import os
    import shutil
    out = ROOT / "build" / "service"
    out.mkdir(parents=True, exist_ok=True)
    timeout = ["--span-timeout", f"{SERVICE_SPAN_TIMEOUT:g}"]
    # the churn soak as a user runs it, in a process of its own
    path, summary_path = out / "churn-chaos", out / "churn-chaos.json"
    shutil.rmtree(path, ignore_errors=True)
    cmd = [sys.executable, "-m", "repro_torch.launch.fed_serve",
           "--scenario", "churn", "--chaos", SERVICE_CHURN_CHAOS] + timeout + [
           "--chaos-dir", str(out / "churn-snapshots"), "--events-per-sec",
           SERVICE_EVENTS_PER_S, "--snapshot", str(path), "--json",
           str(summary_path)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          timeout=600, env={**os.environ,
                                            "PYTHONPATH": str(ROOT / "src")})
    if proc.returncode:
        raise RuntimeError(f"{' '.join(cmd[1:])} exited {proc.returncode}:\n"
                           f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    log(f"  python -m repro_torch.launch.fed_serve --scenario churn --chaos "
        f"{SERVICE_CHURN_CHAOS} {' '.join(timeout)} "
        f"({time.perf_counter() - t0:.1f} s, process start included):")
    for line in proc.stdout.splitlines():
        log(f"    {line}")
    churn = (json.loads(summary_path.read_text()),) + saved_run(path)
    plain = fed_serve_cli(["--scenario", "churn"], out / "churn")
    same_cli_run("fed_serve churn --chaos", churn, plain)
    block = churn[0]["chaos"]
    causes = [r["cause"] for r in block["recoveries"]]
    if not block["n_recoveries"] or not all(
            c.startswith(("InjectedFault(", "TimeoutError(")) for c in causes):
        raise RuntimeError(f"fed_serve churn --chaos: recoveries {causes}")
    log(f"  its records and params equal the same CLI's without --chaos "
        f"({churn[0]['rounds_served']} rounds, {churn[0]['rounds_per_sec']} "
        f"rounds/s against {plain[0]['rounds_per_sec']}); its chaos block: "
        + json.dumps({k: v for k, v in block.items() if k != "recoveries"})
        + f"; causes {causes}")

    trace = out / "flash-crowd.jsonl"
    fed_serve.main(["--scenario", "flash-crowd", "--dump-trace", str(trace),
                    "--events-per-sec", SERVICE_EVENTS_PER_S, "--quiet"])
    replayed = fed_serve_cli(["--scenario", "flash-crowd", "--trace",
                              str(trace)], out / "flash-crowd-trace")
    paced = fed_serve_cli(["--scenario", "flash-crowd"], out / "flash-crowd")
    same_cli_run("fed_serve flash-crowd --trace", replayed, paced)
    n_lines = len(trace.read_text().splitlines())
    log(f"  fed_serve flash-crowd --dump-trace ({n_lines} events, "
        f"{trace.stat().st_size} bytes), then --trace: records and params "
        f"equal the paced scenario run ({paced[0]['events_applied']} events "
        f"applied)")

    jsonl, prom = out / "flash-crowd-chaos.jsonl", out / "flash-crowd.prom"
    for path in (jsonl, prom):
        path.unlink(missing_ok=True)
    metered = fed_serve_cli(["--scenario", "flash-crowd", "--metrics-out",
                             str(jsonl), "--prom-out", str(prom), "--chaos",
                             SERVICE_METRICS_CHAOS] + timeout + [
        "--chaos-dir", str(out / "flash-crowd-snapshots")],
        out / "flash-crowd-chaos")
    same_cli_run("fed_serve flash-crowd --chaos --metrics-out", metered,
                 paced)
    recs = [json.loads(line) for line in jsonl.read_text().splitlines()]
    metrics = {r["name"]: r for r in recs if r["kind"] != "span"}
    fired = {f"{s['labels']['site']}/{s['labels']['kind']}": s["value"]
             for s in metrics.get("faults_fired_total",
                                  {"samples": []})["samples"]}
    svc_counters = {name: r["samples"][0]["value"]
                    for name, r in sorted(metrics.items())
                    if name.startswith("svc_") and r["kind"] == "counter"}
    n_fired = len(metered[0]["chaos"]["faults"]["fired"])
    if sum(fired.values()) != n_fired or \
            svc_counters.get("svc_events_ingested_total") != 12 or \
            svc_counters.get("svc_recoveries_total") != \
            metered[0]["chaos"]["n_recoveries"]:
        raise RuntimeError(f"{jsonl.name}: faults_fired_total {fired} "
                           f"({n_fired} fired), svc counters {svc_counters}")
    log(f"  fed_serve flash-crowd --chaos {SERVICE_METRICS_CHAOS} "
        f"--metrics-out --prom-out: "
        f"records and params equal the paced run's; faults_fired_total "
        f"{fired}; "
        + ", ".join(f"{k} {v:.6g}" for k, v in svc_counters.items())
        + f"; {len(recs)} JSONL lines, "
        f"{len(prom.read_text().splitlines())} prom lines")

    sc = make_scenario("flash-crowd")
    events, sc.events = sc.events, []
    sch = build_scheduler(sc, device=dev, telemetry=Telemetry())
    svc = FederationService(sch, span_rounds=SERVICE_SPAN,
                            eval_every=sc.eval_every, max_rounds=sc.n_rounds)
    svc.submit(*events)
    with svc:
        if not svc.wait_rounds(sc.n_rounds // 2, timeout=300):
            raise RuntimeError(f"fed_top's service: {svc.stats()}")
        top = FedTop(svc)
        top.frame()
        frame = top.frame()
        if not svc.wait_rounds(sc.n_rounds, timeout=300):
            raise RuntimeError(f"fed_top's service: {svc.stats()}")
    if "fed_top" not in frame or "paper" not in frame:
        raise RuntimeError(f"FedTop frame:\n{frame}")
    log("  FedTop(svc).frame() against a live flash-crowd service:")
    for line in frame.rstrip("\n").splitlines():
        log(f"    {line}")


def quantile_bound(hist, q: float) -> float:
    """The upper bound of the bucket that holds the q-quantile of a
    histogram child (its buckets() are cumulative)."""
    want = q * hist.count
    for bound, cum in hist.buckets():
        if cum >= want:
            return bound
    return math.inf


def service_timing(dev, card: str) -> None:
    """Phase 13 (d): warm rounds/s of the service (events submitted live,
    as in (a)) and of the blocking scheduler (events preloaded) on (a)'s
    schedule, no eval, in turns; the service's busy, idle and overhead
    seconds and its ingest lag."""
    from repro_torch.fed import FederationService
    rates = {"blocking": [], "service": []}
    last = None
    for kind in ["blocking", "service", "service",
                 "blocking"] * SERVICE_TURNS:
        if kind == "blocking":
            sch = bank_scheduler(dev, "device", BANK_HOT, prefetch=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sch.run(BANK_ROUNDS, eval_every=NO_EVAL)
            torch.cuda.synchronize()
        else:
            fleet = bank_rotation()
            sch = bank_scheduler(dev, "device", BANK_HOT, prefetch=True,
                                 fleet=fleet, preload=False)
            last = FederationService(sch, span_rounds=SERVICE_SPAN,
                                     eval_every=NO_EVAL)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            serve_live(last, fleet[1], BANK_ROUNDS)
            torch.cuda.synchronize()
        rates[kind].append(BANK_ROUNDS / (time.perf_counter() - t0))
        sch.close()
        del sch
    reg = last._registry                 # null telemetry: the private one
    busy, idle, over = (reg.get(f"svc_{k}_seconds_total").labels().value
                        for k in ("busy", "idle", "overhead"))
    lag = reg.get("svc_ingest_lag_seconds").labels()

    def listed(values):
        return ", ".join(f"{v:.3f}" for v in values)
    log(f"  EMNIST fleet, device mode, {BANK_ROUNDS} rounds a window, no "
        f"eval, in turns (blocking, service, service, blocking) x "
        f"{SERVICE_TURNS}: rounds/s blocking {listed(rates['blocking'])}; "
        f"service {listed(rates['service'])}; the last service window: "
        f"busy {busy:.6f} s, idle {idle:.6f} s, overhead {over:.6f} s; "
        f"ingest lag of {lag.count} events: mean "
        f"{lag.sum / max(1, lag.count):.6f} s, p50 <= "
        f"{quantile_bound(lag, 0.5):g} s, p99 <= "
        f"{quantile_bound(lag, 0.99):g} s (bucket bounds); on {card}")


def service_path(dev, card: str, n_leaves: int) -> None:
    """Phase 13: the federation service with its supervisor and faults,
    through the entry points, on the card."""
    t0 = time.perf_counter()
    log(f"federation service: the EMNIST fleet ({N_CLIENTS} clients, "
        f"{BANK_HOT} slots, prefetch) served live, a supervised chaos soak, "
        f"fed_serve and fed_top; on {card}")
    want_history, want_params = service_live(dev, n_leaves)
    service_chaos(dev, want_history, want_params)
    service_cli(dev)
    service_timing(dev, card)
    log(f"  service phase: {time.perf_counter() - t0:.1f} s")


# -- 14. the event-stream fuzzer and the theory-scored validator --------------
def fuzz_corpus(dev):
    """Phase 14 (a): run_corpus over FUZZ_SEEDS seeds with plan parity, on
    a harness on the card.  Returns the harness."""
    from repro_torch.fed import FuzzHarness, run_corpus
    t0 = time.perf_counter()
    harness = FuzzHarness(device=dev)
    warm = time.perf_counter() - t0
    t0 = time.perf_counter()
    agg = run_corpus(range(FUZZ_SEEDS), harness=harness)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    if agg["cases"] != FUZZ_SEEDS or not all(
            r["plan_parity"] for r in agg["per_case"]):
        raise RuntimeError(f"the corpus ran {agg['cases']} cases, plan "
                           f"parity on {sum(r['plan_parity'] for r in agg['per_case'])}")
    if agg["kills"] == 0 or agg["resumes"] != agg["kills"]:
        raise RuntimeError(f"kills {agg['kills']}, resumes {agg['resumes']}")
    log(f"  (a) run_corpus: {agg['cases']} cases, {agg['rounds']} rounds, "
        f"every invariant (exact-resume, zero-recompile, weight-sanity, "
        f"plan-parity) on each, in {secs:.3f} s: "
        f"{agg['cases'] / secs:.3f} cases/s, "
        f"{3 * agg['rounds'] / secs:.1f} rounds/s over the 3 runs a case; "
        f"kills {agg['kills']}, resumes {agg['resumes']}, events applied "
        f"{agg['events_applied']}; harness warm-up {warm:.3f} s")
    return harness


def fuzz_chaos(harness) -> None:
    """Phase 14 (c): run_chaos_corpus over FUZZ_CHAOS_SEEDS seeds."""
    from repro_torch.fed import run_chaos_corpus
    t0 = time.perf_counter()
    agg = run_chaos_corpus(range(FUZZ_CHAOS_SEEDS), harness=harness)
    secs = time.perf_counter() - t0
    if agg["recoveries"] < 1 or agg["cases"] != FUZZ_CHAOS_SEEDS:
        raise RuntimeError(f"the chaos corpus recovered "
                           f"{agg['recoveries']} times in {agg['cases']} "
                           f"cases")
    log(f"  (c) run_chaos_corpus: {agg['cases']} cases, {agg['rounds']} "
        f"rounds, {agg['events']} events, {agg['recoveries']} recoveries "
        f"onto the harness's engine, every run bit-exact to its fault-free "
        f"run; events merged {agg['events_merged']}; MTTR mean "
        f"{agg['mttr_mean_s']:.4f} s, max {agg['mttr_max_s']:.4f} s; "
        f"{secs:.3f} s")
    for r in agg["per_case"]:
        log(f"      seed {r['seed']}: recoveries {r['recoveries']}, mttr "
            f"{[round(m, 4) for m in r['mttr_s']]}, fired {r['fired']}")


def fuzz_against_cpu(harness) -> None:
    """Phase 14 (f): one case on the card and on the CPU: equal records (s
    bit for bit: the device draw), the first span's params within
    PARAM_TOL."""
    from repro_torch.fed import FuzzHarness, generate_case
    from repro_torch.fed.fuzz import _execute, _numpy_params
    cpu = FuzzHarness(device="cpu")
    case = generate_case(FUZZ_CPU_SEED)
    card_run = _execute(harness, case, mode="device", honor_kills=False)
    cpu_run = _execute(cpu, case, mode="device", honor_kills=False)
    for a, b in zip(card_run["history"], cpu_run["history"], strict=True):
        if not same_records(a, b):
            raise RuntimeError(f"seed {FUZZ_CPU_SEED}: round {a.tau} on the "
                               f"card {a} != the CPU's {b}")
    first = []
    for h in (harness, cpu):
        sch = h.new_scheduler("device", case_seed=case.seed)
        for op in h.materialize(case):
            if op[0] == "push":
                sch.push(op[1])
            elif op[0] == "run":
                sch.run(op[1], eval_every=NO_EVAL)
                n_first = op[1]
                break
        first.append(_numpy_params(sch.params))
    dist_tol = max(float(np.max(np.abs(first[0][k] - v)
                                / (PARAM_TOL["atol"] + PARAM_TOL["rtol"]
                                   * np.abs(v))))
                   for k, v in first[1].items())
    log(f"  (f) seed {FUZZ_CPU_SEED} on the card against the CPU: "
        f"{len(card_run['history'])} round records equal (s bit for bit), "
        f"events applied {card_run['state'].events_applied} both; the "
        f"first span ({n_first} rounds) {dist_tol:.4f} PARAM_TOLs apart")
    if dist_tol > 1.0:
        raise RuntimeError(f"the first span's params lie {dist_tol:.3f} "
                           f"PARAM_TOLs from the CPU's")


def fuzz_leg_launches(pool, case) -> None:
    """Phase 14 (e): each backend's launches per round over one
    uninterrupted run of ``case``: weighted_agg once per client-parallel
    f32 round, weighted_agg_quant once per parallel int8 round,
    weighted_agg_sharded once per sharded round, masked_sgd 2 leaves x E a
    round on parallel legs; on sequential legs no reduction kernel and
    masked_sgd capacity x 2 leaves x E a round (one row per slot)."""
    from repro_torch.fed.fuzz import _execute
    from repro_torch.kernels import ops
    R = case.total_rounds
    for name, h in pool.items():
        E, C = h.E, h.capacity
        ops.reset_launches()
        _execute(h, case, mode="device", honor_kills=False)
        torch.cuda.synchronize()
        got = dict(ops.launches)
        if h.engine_mode == "client_sequential":
            want = expected_launches(masked_sgd=C * 2 * E * R)
        else:
            reduction = ("weighted_agg_sharded" if name == "sharded" else
                         "weighted_agg_quant" if h.engine.compression.quantized
                         else "weighted_agg")
            want = expected_launches(masked_sgd=2 * E * R,
                                     **{reduction: R})
        log(f"  (e) {name}: launches over {R} rounds "
            f"{ {k: v for k, v in got.items() if v} }, a round "
            f"{ {k: v / R for k, v in got.items() if v} }")
        if got != want:
            raise RuntimeError(f"{name}: launches {got} != expected {want}")


def fuzz_backends(dev) -> None:
    """Phase 14 (b) and (e): run_backend_matrix over FUZZ_BACKENDS plus
    "sharded" over a one-rank NCCL group (a file:// init under build/, as
    step 7's), for FUZZ_MATRIX_SEEDS seeds; banked against client_parallel
    and the sharded leg against client_parallel element by element; then
    each leg's launches.  The group is destroyed when the phase ends."""
    import torch.distributed as dist
    from repro_torch.fed import (generate_case, make_backend_pool,
                                 make_fed_sharding, run_backend_matrix)
    from repro_torch.fed.fuzz import _execute
    init = ROOT / "build" / "fuzz_pool.pg"
    init.parent.mkdir(parents=True, exist_ok=True)
    init.unlink(missing_ok=True)
    dist.init_process_group("nccl", init_method=f"file://{init}", rank=0,
                            world_size=1)
    try:
        t0 = time.perf_counter()
        pool = make_backend_pool(FUZZ_BACKENDS + ("sharded",),
                                 sharding=make_fed_sharding(), device=dev)
        warm = time.perf_counter() - t0
        t0 = time.perf_counter()
        agg = run_backend_matrix(range(FUZZ_MATRIX_SEEDS), pool=pool)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        log(f"  (b) run_backend_matrix: {agg['cases']} cases, "
            f"{agg['rounds']} rounds on each of {agg['backends']}: records "
            f"exact, max_param_err {agg['max_param_err']:.6g} (int8 legs "
            f"against f32 under QUANT_VS_F32, the others under 5e-4); "
            f"{secs:.3f} s, pool warm-up {warm:.3f} s")
        pairs = (("banked", "client_parallel"),
                 ("quantized_sequential", "quantized"),
                 ("client_sequential", "client_parallel"),
                 ("sharded", "client_parallel"))
        differ = {pair: [0, 0.0] for pair in pairs}
        for seed in range(FUZZ_MATRIX_SEEDS):
            case = generate_case(seed)
            runs = {name: _execute(pool[name], case, mode="device",
                                   honor_kills=False)
                    for name in {n for pair in pairs for n in pair}}
            for a, b in pairs:
                for k, v in runs[b]["params"].items():
                    d = np.abs(runs[a]["params"][k] - v)
                    differ[a, b][0] += int((d != 0).sum())
                    differ[a, b][1] = max(differ[a, b][1], float(d.max()))
        n = sum(v.size for v in runs["client_parallel"]["params"].values())
        for (a, b), (count, worst) in differ.items():
            log(f"      {a} against {b}: {count} of "
                f"{n * FUZZ_MATRIX_SEEDS} final param elements differ over "
                f"{FUZZ_MATRIX_SEEDS} cases (max {worst:.3g})")
        if differ["banked", "client_parallel"][0]:
            raise RuntimeError("banked is not client_parallel bit for bit")
        fuzz_leg_launches(pool, generate_case(0))
    finally:
        dist.destroy_process_group()


def fuzz_validate(dev) -> None:
    """Phase 14 (d): validate_corpus over VALIDATE_SEEDS seeds on f32 and
    VALIDATE_INT8_SEEDS on int8 on the card, with their launches; the two
    mutation smokes: scheme C collapsed onto B's coefficients (the engine's
    scheme_coefficients patched) trips scheme-ordering, and the
    "int8:levels=1" wire trips the validator."""
    import repro_torch.fed.engine as engine_mod
    from repro_torch.fed import (InvariantViolation, QuadraticRunner,
                                 validate_corpus)
    from repro_torch.kernels import ops
    for wire, seeds in ((None, VALIDATE_SEEDS),
                        ("int8", VALIDATE_INT8_SEEDS)):
        runner = QuadraticRunner(compression=wire, device=dev)
        ops.reset_launches()
        t0 = time.perf_counter()
        agg = validate_corpus(range(seeds), runner=runner)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        R = agg["rounds"]
        want = expected_launches(
            masked_sgd=R * runner.E,
            **{"weighted_agg_quant" if wire else "weighted_agg": R})
        got = dict(ops.launches)
        log(f"  (d) validate_corpus {wire or 'f32'}: {agg['cases']} seeds x "
            f"3 schemes, {R} rounds in {secs:.3f} s, max margin "
            f"{agg['max_margin']:.6g} (of slack 1.0), launches "
            f"{ {k: v for k, v in got.items() if v} }")
        for r in agg["per_case"]:
            log(f"      seed {r['seed']}: events {r['n_events']}, tails "
                f"C {r['tails']['C']:.6g} A {r['tails']['A']:.6g} B "
                f"{r['tails']['B']:.6g}, C/A {r['tails']['C'] / r['tails']['A']:.4f}"
                f" C/B {r['tails']['C'] / r['tails']['B']:.4f} (limit 0.6)")
        if got != want:
            raise RuntimeError(f"validate launches {got} != {want}")
    orig = engine_mod.scheme_coefficients

    def collapsed(scheme, p, s, E):
        return orig("B" if scheme == "C" else scheme, p, s, E)

    caught = {}
    engine_mod.scheme_coefficients = collapsed
    try:
        validate_corpus(range(1), runner=QuadraticRunner(device=dev))
    except InvariantViolation as e:
        caught["collapsed"] = e.invariant
    finally:
        engine_mod.scheme_coefficients = orig
    try:
        validate_corpus(range(1), rounds=48, compression="int8:levels=1",
                        device=dev)
    except InvariantViolation as e:
        caught["levels=1"] = e.invariant
    log(f"  (d) mutation smokes: scheme C collapsed onto B caught as "
        f"{caught.get('collapsed')}; int8:levels=1 caught as "
        f"{caught.get('levels=1')}")
    if caught.get("collapsed") != "scheme-ordering" or \
            "levels=1" not in caught:
        raise RuntimeError(f"a validator mutation was not caught: {caught}")


def fuzz_path(dev, card: str) -> None:
    """Phase 14: the event-stream fuzzer and the theory-scored validator
    on the card."""
    t0 = time.perf_counter()
    log(f"fuzzer and validator: run_corpus ({FUZZ_SEEDS} seeds), the "
        f"backend matrix ({FUZZ_MATRIX_SEEDS} seeds), fuzzed chaos "
        f"({FUZZ_CHAOS_SEEDS} seeds), validate_corpus ({VALIDATE_SEEDS} "
        f"f32, {VALIDATE_INT8_SEEDS} int8); on {card}")
    harness = fuzz_corpus(dev)
    fuzz_chaos(harness)
    fuzz_against_cpu(harness)
    del harness
    fuzz_backends(dev)
    fuzz_validate(dev)
    log(f"  fuzz phase: {time.perf_counter() - t0:.1f} s")


# -- 15. timing ---------------------------------------------------------------
def device_ms(fn, n: int, spin: int = 50_000_000) -> float:
    """Mean time of fn on the card's timeline, between CUDA events around n
    back-to-back calls.  The card first spins for `spin` cycles (a few tens
    of ms by default), so the host queues the calls ahead of it and no call
    waits for the host as far as the queue allows."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(spin)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def bound_ms(n_bytes: float, ops: float, ops_per_s: float = F32_FLOPS_PER_S):
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / ops_per_s * 1e3
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else \
        "operations"


def time_weighted_agg(dev, D: int):
    from repro_torch.kernels import weighted_agg as agg
    gen = torch.Generator(device=dev).manual_seed(2)
    K = N_CLIENTS
    c = torch.rand(K, device=dev, generator=gen)
    d = agg.padded(torch.randn(K, D, device=dev, generator=gen))
    kernel = device_ms(lambda: agg.launch(c, d), 100)
    plain = device_ms(lambda: agg.weighted_agg_plain(c, d), 10)
    library = device_ms(lambda: torch.mv(d.t(), c), 100)
    bound, by = bound_ms(4 * (K * D + K + D), 2 * K * D)
    log(f"  weighted_agg, coeffs ({K},) f32 and deltas ({K}, {D}) f32: "
        f"kernel {kernel * 1e3:.1f} us, bound {bound * 1e3:.1f} us by {by}, "
        f"plain {plain * 1e3:.1f} us, torch.mv(deltas.t(), coeffs) "
        f"{library * 1e3:.1f} us")
    return dict(ms=kernel, plain_ms=plain, bound_ms=bound, bound_by=by,
                library_ms=library)


def time_masked_sgd(dev, leaves):
    """One local step: the masked_sgd launch of every leaf, (clients, n)
    f32 with one scale per client."""
    from repro_torch.kernels import masked_sgd as sgd
    gen = torch.Generator(device=dev).manual_seed(3)
    C = N_CLIENTS
    s = 5e-4 * torch.rand(C, device=dev, generator=gen)
    w = [torch.randn(C, n, device=dev, generator=gen) for n in leaves.values()]
    g = [torch.randn(C, n, device=dev, generator=gen) for n in leaves.values()]
    s_col = s[:, None]

    def step(fn):
        def run():
            for wi, gi in zip(w, g):
                fn(wi, gi)
        return run

    kernel = device_ms(step(lambda wi, gi: sgd.launch(wi, gi, s)), 50)
    plain = device_ms(step(lambda wi, gi: sgd.masked_sgd_plain(wi, gi, s)),
                      50)
    library = device_ms(step(lambda wi, gi: wi.addcmul_(s_col, gi,
                                                        value=-1.0)), 50)
    n = C * sum(leaves.values())
    bound, by = bound_ms(4 * (3 * n + len(leaves) * C), 2 * n)
    log(f"  masked_sgd, one local step of {len(leaves)} leaves ({C}, n) f32, "
        f"{n} elements: kernel {kernel * 1e3:.1f} us, bound "
        f"{bound * 1e3:.1f} us by {by}, plain {plain * 1e3:.1f} us, "
        f"w.addcmul_(s, g, value=-1) per leaf {library * 1e3:.1f} us")
    return dict(ms=kernel, plain_ms=plain, bound_ms=bound, bound_by=by,
                library_ms=library)


def time_flash_attention(dev, shape=FLASH_MAIN):
    """A serving prefill's attention (nemotron's by default): one layer's q,
    k, v in the model's layout, bf16, causal."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    gen = torch.Generator(device=dev).manual_seed(5)
    B, H, KV, S, hd = shape
    q, k, v = _qkv(dev, gen, B, H, KV, S, hd, torch.bfloat16)

    def sdpa():
        return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                              enable_gqa=True)
    kernel = device_ms(lambda: fa.launch(q, k, v), 20)
    plain = device_ms(lambda: fa.flash_attention_plain(q, k, v), 3)
    library = device_ms(sdpa, 20)
    # the (query, key) pairs causal masking keeps, two hd-long products
    # each; q, k, v read once and o written once in bf16
    flops = 4.0 * B * H * hd * S * (S + 1) / 2
    n_bytes = 2 * (2 * B * H * S * hd + 2 * B * KV * S * hd)
    bound, by = bound_ms(n_bytes, flops, BF16_FLOPS_PER_S)
    log(f"  flash_attention, q ({B}, {H}, {S}, {hd}), k, v ({B}, {KV}, {S}, "
        f"{hd}) bf16, causal: kernel {kernel:.3f} ms "
        f"({flops / kernel / 1e9:.1f} TFLOP/s, {bound / kernel:.3f} of the "
        f"bound), bound {bound:.3f} ms by {by}, plain {plain:.3f} ms, "
        f"scaled_dot_product_attention(is_causal=True, enable_gqa=True) "
        f"{library:.3f} ms ({flops / library / 1e9:.1f} TFLOP/s)")
    backend = sdpa_backends(sdpa, q, k, v)
    return dict(ms=kernel, plain_ms=plain, bound_ms=bound, bound_by=by,
                library_ms=library, library_backend=backend)


def sdpa_backends(sdpa, q, k, v) -> str:
    """Names the yardstick: the backend PyTorch's dispatcher picks for the
    call and the kernels a profile of it records, then the call's time
    under each backend that takes it.  Returns the backend's name."""
    import warnings

    from torch.autograd import DeviceType
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from torch.profiler import ProfilerActivity, profile
    try:
        choice = SDPBackend(torch._fused_sdp_choice(
            q, k, v, is_causal=True, enable_gqa=True)).name
    except (AttributeError, RuntimeError, TypeError, ValueError) as e:
        choice = f"unknown ({e})"
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sdpa()
        torch.cuda.synchronize()
    names = sorted({e.name for e in prof.events()
                    if e.device_type == DeviceType.CUDA})
    log(f"    the default scaled_dot_product_attention: backend {choice} "
        f"(torch._fused_sdp_choice); kernels in a profile of it: "
        f"{'; '.join(n[:100] for n in names) or 'none recorded'}")
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION):
        try:
            with sdpa_kernel(backend), warnings.catch_warnings():
                warnings.simplefilter("ignore")
                t = device_ms(sdpa, 20)
            log(f"    under sdpa_kernel({backend.name}): {t:.3f} ms")
        except RuntimeError as e:
            log(f"    under sdpa_kernel({backend.name}): not taken "
                f"({str(e).splitlines()[0][:100]})")
    return choice


def time_weighted_agg_quant(dev, D: int):
    """The int8 wire's reduction: coeffs (K,), payload (K, Dp) int8 and
    scales (K, Dp / chunk) f32 from quantize_chunked, read from device
    memory as the byte bound counts them (``rotation``), and beside that
    one input set launched again and again, which the 50 MB L2 holds."""
    from repro_torch.kernels import weighted_agg as agg
    gen = torch.Generator(device=dev).manual_seed(8)
    K, chunk = N_CLIENTS, QUANT_CHUNK
    sets = rotation(lambda: quantized(dev, gen, K, D, chunk, 127), K * D)
    c, payload, scales = next(sets)
    Dp, n_chunks = payload.shape[1], scales.shape[1]
    kernel = device_ms(lambda: agg.launch_quant(*next(sets), chunk), 100)
    l2 = device_ms(lambda: agg.launch_quant(c, payload, scales, chunk), 100)
    plain = device_ms(lambda: agg.weighted_agg_quant_plain(
        c, payload, scales, chunk), 10)
    composition = device_ms(lambda: dequantized_mv(*next(sets), chunk), 20)
    # codes, scales and coeffs read once, the output written once; a
    # multiply by the scale, one by the coefficient and an add per code
    n_bytes = K * Dp + 4 * (K * n_chunks + K + Dp)
    bound, by = bound_ms(n_bytes, 3 * K * Dp)
    log(f"  weighted_agg_quant, coeffs ({K},), payload ({K}, {Dp}) int8, "
        f"scales ({K}, {n_chunks}) f32, plan "
        f"{agg.quant_plan(payload, scales, chunk)}: kernel from device "
        f"memory {kernel * 1e3:.1f} us ({n_bytes / kernel / 1e9:.3f} TB/s, "
        f"{bound / kernel:.3f} of the bound), from L2 {l2 * 1e3:.1f} us, "
        f"bound {bound * 1e3:.1f} us by {by}, plain {plain * 1e3:.1f} us; no "
        f"single PyTorch call computes it: the composition "
        f"torch.mv((payload.float().view(K, -1, chunk) * scales[..., None])"
        f".view(K, -1).t(), coeffs) {composition * 1e3:.1f} us")
    return dict(ms=kernel, l2_ms=l2, plain_ms=plain, bound_ms=bound,
                bound_by=by, library_ms=None, composition_ms=composition)


def time_sharded_kernels(dev, D: int, fs) -> dict:
    """Both sharded kernels at the main path's 62-row slab and a 16-row
    slab: on the card's timeline, the wrapper (``ops``), its local launch
    and the all-reduce of its (D,) f32 partial, each alone, over
    SHARDED_WINDOWS windows (median, least and most), its plain version,
    and the composition of PyTorch calls that computes the same (torch.mv,
    or time_weighted_agg_quant's dequantize-and-mv, then the all-reduce),
    on inputs that come from device memory (``rotation``); and on the
    host's clock, what each piece of the wrapper's call costs to enqueue
    (``host_us``).  The bound is the slab's bytes over the card's memory
    rate (on one rank nothing crosses a link).  Returns {name: {rows:
    timings}}."""
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import weighted_agg as agg
    gen = torch.Generator(device=dev).manual_seed(12)
    out = {"weighted_agg_sharded": {}, "weighted_agg_quant_sharded": {}}
    lib = build.load("weighted_agg", agg._SIGNATURES)
    stream = torch.cuda.current_stream().cuda_stream
    for K, n in SHARDED_SLABS[:2]:
        n = n or D
        sets = rotation(lambda: (torch.rand(K, device=dev, generator=gen),
                                 agg.padded(torch.randn(K, n, device=dev,
                                                        generator=gen))),
                        4 * K * n)
        c, d = next(sets)
        partial = agg.launch(c, d)
        grow_pool(dev)
        r = windows(
            ms=lambda: ops.weighted_agg_sharded(*next(sets), sharding=fs),
            local=lambda: agg.launch(*next(sets)),
            all_reduce=lambda: fs.all_reduce(partial))
        r.update(
            plain_ms=device_ms(lambda: agg.weighted_agg_sharded_plain(
                *next(sets), fs), 10),
            composition_ms=device_ms(lambda: fs.all_reduce(
                mv(*next(sets))), 100),
            host_us=dict(
                kernel_c_call=host_us(lambda: lib.weighted_agg_f32(
                    c.data_ptr(), d.data_ptr(), d.stride(0),
                    partial.data_ptr(), K, n, stream)),
                launch=host_us(lambda: agg.launch(c, d)),
                all_reduce=host_us(lambda: fs.all_reduce(partial)),
                wrapper=host_us(lambda: ops.weighted_agg_sharded(
                    c, d, sharding=fs))))
        r["bound_ms"], r["bound_by"] = bound_ms(4 * (K * n + K + n),
                                                2 * K * n)
        out["weighted_agg_sharded"][K] = r
        _log_sharded("weighted_agg_sharded", f"coeffs ({K},) f32 and deltas "
                     f"({K}, {n}) f32", r, "torch.mv(deltas.t(), coeffs)")
    qlib = build.load("weighted_agg_quant", agg.QUANT_SIGNATURES)
    for K, n, chunk in SHARDED_QUANT_SLABS[:2]:
        n = n or D
        sets = rotation(lambda: quantized(dev, gen, K, n, chunk, 127), K * n)
        c, payload, scales = next(sets)
        Dp, n_chunks = payload.shape[1], scales.shape[1]
        partial = agg.launch_quant(c, payload, scales, chunk)
        plan = (ctypes.c_int * 6)()
        grow_pool(dev)
        r = windows(
            ms=lambda: ops.weighted_agg_quant_sharded(
                *next(sets), chunk=chunk, sharding=fs),
            local=lambda: agg.launch_quant(*next(sets), chunk),
            all_reduce=lambda: fs.all_reduce(partial))
        r.update(
            plain_ms=device_ms(lambda: agg.weighted_agg_quant_sharded_plain(
                *next(sets), chunk, fs), 10),
            composition_ms=device_ms(lambda: fs.all_reduce(dequantized_mv(
                *next(sets), chunk)), 20),
            host_us=dict(
                kernel_c_call=host_us(lambda: qlib.weighted_agg_quant(
                    c.data_ptr(), payload.data_ptr(), payload.stride(0),
                    scales.data_ptr(), chunk, partial.data_ptr(), K, Dp,
                    stream)),
                plan_and_tensor_maps=host_us(
                    lambda: qlib.weighted_agg_quant_plan(
                        payload.data_ptr(), payload.stride(0),
                        scales.data_ptr(), chunk, K, Dp, plan)),
                launch=host_us(lambda: agg.launch_quant(c, payload, scales,
                                                        chunk)),
                all_reduce=host_us(lambda: fs.all_reduce(partial)),
                wrapper=host_us(lambda: ops.weighted_agg_quant_sharded(
                    c, payload, scales, chunk=chunk, sharding=fs))))
        r["bound_ms"], r["bound_by"] = bound_ms(
            K * Dp + 4 * (K * n_chunks + K + Dp), 3 * K * Dp)
        out["weighted_agg_quant_sharded"][K] = r
        _log_sharded("weighted_agg_quant_sharded", f"coeffs ({K},), payload "
                     f"({K}, {Dp}) int8, scales ({K}, {n_chunks}) f32", r,
                     "the dequantize-and-mv composition")
    return out


def windows(**fns) -> dict:
    """device_ms of each fn (100 calls a window) over SHARDED_WINDOWS
    windows taken in turns: <name>_ms the median window, <name>_min_ms and
    <name>_max_ms the least and the most ("ms" itself for the name ms).
    Each window's head start is SHARDED_SPIN cycles: the wrapper's host
    path (its all-reduce's enqueue above all) takes up to hundreds of us a
    call, and a window whose queue runs dry times the host, not the card."""
    times = {name: [] for name in fns}
    for _ in range(SHARDED_WINDOWS):
        for name, fn in fns.items():
            times[name].append(device_ms(fn, 100, spin=SHARDED_SPIN))
    out = {}
    for name, t in times.items():
        t = sorted(t)
        key = "" if name == "ms" else f"{name}_"
        out[f"{key}ms"] = t[len(t) // 2]
        out[f"{key}min_ms"], out[f"{key}max_ms"] = t[0], t[-1]
    return out


def host_us(fn, n: int = 200) -> float:
    """The host's time per call of fn, in us, from an idle card: what a
    call costs to enqueue (the window holds no synchronise)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / n * 1e6


def rotation(draw, n_bytes: float):
    """An endless cycle over enough input sets (each from draw()) that the
    bytes read between two uses of one set exceed twice the L2 cache:
    every timed call then reads its operands from device memory, as the
    byte bound counts them.  A 16-row slab alone would stay in L2."""
    return itertools.cycle(
        [draw() for _ in range(max(1, math.ceil(2 * L2_BYTES / n_bytes)))])


def grow_pool(dev) -> None:
    """Grow the caching allocator's pool by POOL_BYTES; the timed calls
    then take their outputs from it."""
    torch.empty(POOL_BYTES, dtype=torch.uint8, device=dev)


def mv(c, d):
    return torch.mv(d.t(), c)


def dequantized_mv(c, payload, scales, chunk):
    K = payload.shape[0]
    return torch.mv((payload.float().view(K, -1, chunk) * scales[..., None])
                    .view(K, -1).t(), c)


def sharded_row(timings: dict) -> dict:
    """A sharded kernel's numbers for the kernels line: its timings at the
    main path's slab, and the smaller slab's beside them."""
    K = SHARDED_SLABS[1][0]
    return {**timings[N_CLIENTS], f"slab{K}": timings[K]}


def _log_sharded(name: str, shape: str, r: dict, composition: str) -> None:
    def spread(key):
        return (f"{r[key + 'ms'] * 1e3:.1f} us [{r[key + 'min_ms'] * 1e3:.1f}"
                f", {r[key + 'max_ms'] * 1e3:.1f}]")
    host = ", ".join(f"{k} {v:.1f}" for k, v in r["host_us"].items())
    log(f"  {name}, {shape}, one NCCL rank, on the card (median [least, "
        f"most] of {SHARDED_WINDOWS} windows): wrapper {spread('')} = local "
        f"launch {spread('local_')} + all_reduce {spread('all_reduce_')} "
        f"(each timed alone), bound {r['bound_ms'] * 1e3:.1f} us by "
        f"{r['bound_by']}, plain {r['plain_ms'] * 1e3:.1f} us; no single "
        f"PyTorch call computes it: {composition} + all_reduce "
        f"{r['composition_ms'] * 1e3:.1f} us; host us per call: {host}")


def time_ssd_intra_chunk(dev, shape=SSD_MAIN):
    """A serving prefill's intra-chunk term (mamba2's by default), one
    layer's: cells (batch * chunks, heads) in the model's layout (C and B
    shared by the heads through a stride-0 dim), f32."""
    from repro_torch.kernels import ssd_chunk as sc
    gen = torch.Generator(device=dev).manual_seed(10)
    G, H, Q, N, P, dtype = shape
    cum, C, B, xdt = ssd_inputs(dev, gen, G, Q, N, P, dtype, H)
    kernel = device_ms(lambda: sc.launch(cum, C, B, xdt), 20)
    plain = device_ms(lambda: sc.ssd_intra_chunk_plain(cum, C, B, xdt), 5)
    # the composition, as the kernel does it, computes the group's scores
    # once per outer cell and broadcasts them over the heads; its operands
    # are (cells, Q, n) copies made beforehand (a batched product cannot
    # read the stride-0 head dim or the strided xdt), L built in the call
    c_g, b_g = (t[:, 0].contiguous() for t in (C, B))
    x3 = xdt.reshape(G * H, Q, P).contiguous()
    mask = torch.ones(Q, Q, dtype=torch.bool, device=dev).tril()

    def composition():
        L = torch.where(mask, torch.exp(cum[..., :, None] - cum[..., None, :]),
                        0.0)
        s = torch.bmm(c_g, b_g.mT)[:, None] * L
        return torch.bmm(s.view(G * H, Q, Q), x3)
    comp = device_ms(composition, 5)
    # the (i, j <= i) pairs of every cell: the group's scores once per outer
    # cell and pair (N-long rows), each head's product (P-long rows); cum,
    # the group's C and B rows, xdt read once and the output written once,
    # in f32.  The per-head reckoning counts the scores once per head.
    pairs = Q * (Q + 1) / 2
    flops = 2.0 * G * pairs * N + 2.0 * G * H * pairs * P
    flops_per_head = 2.0 * G * H * pairs * (N + P)
    n_bytes = 4 * (G * H * Q + 2 * G * Q * N + 2 * G * H * Q * P)
    bound, by = bound_ms(n_bytes, flops)
    per_head, _ = bound_ms(n_bytes, flops_per_head)
    log(f"  ssd_intra_chunk, cells ({G}, {H}) of Q={Q}, N={N}, P={P} f32, "
        f"C and B shared by the {H} heads: kernel {kernel:.3f} ms "
        f"({flops / kernel / 1e9:.1f} TFLOP/s of the work these inputs "
        f"need, {bound / kernel:.3f} of the bound), bound {bound:.3f} ms by "
        f"{by} ({flops / 1e9:.2f} GFLOP at the f32 CUDA-core peak against "
        f"{n_bytes / 1e6:.1f} MB; the column's bound), the per-head "
        f"reckoning {per_head:.3f} ms "
        f"({flops_per_head / 1e9:.2f} GFLOP); plain {plain:.3f} ms; no "
        f"single PyTorch call computes it: the group-shared composition "
        f"torch.bmm(torch.bmm(C_g, B_g.mT)[:, None] * L, xdt), L by "
        f"torch.where, {comp:.3f} ms with "
        f"torch.backends.cuda.matmul.allow_tf32 = "
        f"{torch.backends.cuda.matmul.allow_tf32}")
    return dict(ms=kernel, plain_ms=plain, bound_ms=bound, bound_by=by,
                library_ms=None, composition_ms=comp)


def time_ssd_head_blocks(dev) -> None:
    """The f32 kernel where whole groups fill too few CTAs for the card's
    SMs and heads_per_cta cuts a group's heads into blocks (SSD_SPLIT):
    its time at the heads per CTA chosen, at all the group's heads and at
    one head per CTA, each output held to ops.TOLERANCE of the plain
    version."""
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import ssd_chunk as sc
    gen = torch.Generator(device=dev).manual_seed(11)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    n_wg = build.load("ssd_intra_chunk", sc.SIGNATURES) \
        .ssd_intra_chunk_f32_warpgroups(SSD_P)
    for Go, Q in SSD_SPLIT:
        cum, C, B, xdt = ssd_inputs(dev, gen, Go, Q, SSD_N, SSD_P,
                                    torch.float32, SSD_HEADS)
        want = sc.ssd_intra_chunk_plain(cum, C, B, xdt)
        chosen = sc.heads_per_cta(Go, SSD_HEADS, Q, True, n_sm, n_wg)
        times = {}
        for heads in dict.fromkeys((chosen, SSD_HEADS, 1)):
            torch.testing.assert_close(
                sc.launch(cum, C, B, xdt, heads=heads), want,
                **ops.TOLERANCE["ssd_intra_chunk"][torch.float32])
            times[heads] = device_ms(
                lambda: sc.launch(cum, C, B, xdt, heads=heads), 20)
        log(f"  ssd_intra_chunk head blocks, cells ({Go}, {SSD_HEADS}) of "
            f"Q={Q} ({Go * -(-Q // sc.BQ)} CTAs of whole groups, {n_sm} "
            f"SMs): " + ", ".join(
                f"{h} heads per CTA{' (chosen)' if h == chosen else ''} "
                f"{ms:.4f} ms" for h, ms in times.items()))


def phase(label: str, fn, *args, **kw):
    """fn(*args, **kw), its wall seconds logged under ``label``."""
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    log(f"phase {label}: {time.perf_counter() - t0:.1f} s")
    return out


def main() -> None:
    import_port()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device: "
                         "torch.cuda.is_available() is False")
    from repro_torch import resolve_device
    from repro_torch.kernels import build

    card = card_line()
    dev = resolve_device(None)
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python "
        f"{sys.version.split()[0]}, device 0: {torch.cuda.get_device_name(0)}")
    log(f"tf32: torch.backends.cuda.matmul.allow_tf32 = "
        f"{torch.backends.cuda.matmul.allow_tf32}, "
        f"torch.backends.cudnn.allow_tf32 = {torch.backends.cudnn.allow_tf32}")
    if torch.backends.cuda.matmul.allow_tf32 or \
            torch.backends.cudnn.allow_tf32:
        raise RuntimeError("TF32 is on")

    from repro_torch.kernels import flash_attention, ssd_chunk, weighted_agg
    t0 = time.perf_counter()
    # the planted faults compile with the others, as controls
    flash_job = start_planted_fault("flash_attention", FLASH_FAULT,
                                    sites=2)
    quant_job = start_planted_fault("weighted_agg_quant", QUANT_FAULT)
    ring_job = start_planted_fault("weighted_agg_quant", QUANT_RING_FAULT,
                                   tag="planted_ring_fault")
    # the loops over a head's key tiles: the f32 producer's and consumers',
    # and the bf16 body's
    ssd_job = start_planted_fault("ssd_intra_chunk", SSD_FAULT, sites=3)
    ssd_head_job = start_planted_fault("ssd_intra_chunk", SSD_HEAD_FAULT,
                                       tag="planted_head_fault")
    reports = build.build()
    planted = finish_planted_fault(*flash_job, flash_attention.SIGNATURES)
    planted_quant = finish_planted_fault(*quant_job,
                                         weighted_agg.QUANT_SIGNATURES)
    planted_ring = finish_planted_fault(*ring_job,
                                        weighted_agg.QUANT_SIGNATURES)
    planted_ssd = finish_planted_fault(*ssd_job, ssd_chunk.SIGNATURES)
    planted_ssd_head = finish_planted_fault(*ssd_head_job,
                                            ssd_chunk.SIGNATURES)
    log(f"build: {len(reports)} of {len(build.SOURCES)} sources compiled in "
        f"{time.perf_counter() - t0:.2f} s into {build.BUILD_DIR}")
    for name, report in reports.items():
        for line in ptxas_summary(report):
            log(f"  {name}: {line}")

    from repro_torch.configs.paper import EMNIST_CNN, MNIST_MLP, SYNTHETIC_LR
    from repro_torch.models.small import init_small
    leaves = {name: p.numel() for name, p in
              sorted(init_small(EMNIST_CNN, device=dev).items())}
    D = sum(leaves.values())
    log("kernels against their plain versions on the card:")
    paper_leaves = {cfg.kind: {name: p.numel() for name, p in
                               sorted(init_small(cfg, device=dev).items())}
                    for cfg in (SYNTHETIC_LR, MNIST_MLP, EMNIST_CNN)}
    train_leaves = lm_leaves(dev, TRAIN_ARCH)
    lm_D = sum(n for n, _ in train_leaves.values())
    agg_err = check_weighted_agg(dev, D, lm_D)
    sgd_err = check_masked_sgd(dev, leaves, paper_leaves, train_leaves)
    flash_err = phase("3 flash_attention", check_flash_attention, dev,
                      planted)
    quant_err = check_weighted_agg_quant(dev, D, lm_D, planted_quant,
                                         planted_ring)
    check_quant_memory(dev, D)
    ssd_err = phase("3 ssd_intra_chunk", check_ssd_intra_chunk, dev,
                    planted_ssd, planted_ssd_head)

    f32_trainer, launches, f32_profile, f32_params = phase(
        "4 main path", main_path, dev)
    phase("5 device mode", device_path, dev, f32_trainer, len(leaves),
          f32_profile)
    int8_trainer, int8_launches, int8_params = phase(
        "6 compressed", compressed_path, dev, f32_trainer, len(leaves),
        f32_profile)
    sharded_launches, sharded_errs, sharded_t = phase(
        "7 sharded", sharded_path, dev, f32_trainer, f32_params,
        int8_trainer, int8_params, len(leaves), D)
    del f32_trainer
    phase("6 wires against the CPU", wires_against_cpu, dev,
          int8_trainer.params)
    del int8_trainer
    phase("8 paper", paper_path, dev, len(leaves), D)
    serve_launches = phase("9 nemotron", serve_path, dev, planted)
    ssm_launches = phase("9b mamba2", ssm_serve_path, dev, planted_ssd)
    zoo_rows = phase("9c zoo", zoo_path, dev,
                     {"flash_attention": planted,
                      "ssd_intra_chunk": planted_ssd}, card)
    train_row = phase("9d training", train_path, dev, card)
    fed_train_rows = phase("9e fed_train", fed_train_path, dev, card)
    phase("10 checkpoint", checkpoint_path, dev, len(leaves), card)
    uncut = phase("11 scenarios", scenario_path, dev, card)
    phase("12 bank", bank_path, dev, card, len(leaves), uncut)
    phase("13 service", service_path, dev, card, len(leaves))
    phase("14 fuzz", fuzz_path, dev, card)

    log("timing on the card:")
    agg_t = time_weighted_agg(dev, D)
    sgd_t = time_masked_sgd(dev, leaves)
    flash_t = time_flash_attention(dev)
    flash_gemma_t = time_flash_attention(dev, FLASH_GEMMA)
    flash_llava_t = time_flash_attention(dev, FLASH_LLAVA)
    flash_musicgen_t = time_flash_attention(dev, FLASH_MUSICGEN)
    quant_t = time_weighted_agg_quant(dev, D)
    ssd_t = time_ssd_intra_chunk(dev)
    ssd_hymba_t = time_ssd_intra_chunk(dev, SSD_HYMBA[0])

    def by_path(kernel):
        """Each zoo path's launches of the kernel per prefill."""
        paths = {r["arch"]: r["launches_per_prefill"][kernel]
                 for r in zoo_rows if kernel in r["launches_per_prefill"]}
        for r in zoo_rows:
            if kernel == "flash_attention" and "with_patches" in r:
                p = r["with_patches"]
                paths[f"{r['arch']} with {p['patches']} patches"] = \
                    p["flash_launches_per_prefill"]
        return paths
    def fed_train_paths(kernel):
        """The fed_train rounds' launches of the kernel per round, by
        wire."""
        return {f"fed_train {r['arch']} {r['wire']} (a round)":
                r["launches_per_round"][kernel]
                for r in fed_train_rows if kernel in r["launches_per_round"]}
    time_ssd_head_blocks(dev)
    csrc = "src/repro_torch/kernels/csrc"
    rows = [
        dict(name="weighted_agg", route="cuda",
             source=f"{csrc}/weighted_agg.cu",
             replaces="src/repro/kernels/weighted_agg.py:108",
             launches=launches["weighted_agg"], max_abs_err=agg_err, **agg_t,
             other_paths=fed_train_paths("weighted_agg")),
        dict(name="weighted_agg_quant", route="cuda",
             source=f"{csrc}/weighted_agg_quant.cu",
             replaces="src/repro/kernels/weighted_agg.py:187",
             launches=int8_launches["weighted_agg_quant"],
             max_abs_err=quant_err, **quant_t,
             other_paths=fed_train_paths("weighted_agg_quant")),
        dict(name="weighted_agg_sharded", route="cuda",
             source=f"{csrc}/weighted_agg.cu",
             replaces="src/repro/kernels/weighted_agg.py:294",
             launches=sharded_launches["f32"]["weighted_agg_sharded"],
             max_abs_err=sharded_errs["weighted_agg_sharded"],
             library_ms=None, **sharded_row(
                 sharded_t["weighted_agg_sharded"])),
        dict(name="weighted_agg_quant_sharded", route="cuda",
             source=f"{csrc}/weighted_agg_quant.cu",
             replaces="src/repro/kernels/weighted_agg.py:254",
             launches=sharded_launches["int8"]["weighted_agg_quant_sharded"],
             max_abs_err=sharded_errs["weighted_agg_quant_sharded"],
             library_ms=None, **sharded_row(
                 sharded_t["weighted_agg_quant_sharded"])),
        dict(name="masked_sgd", route="cuda", source=f"{csrc}/masked_sgd.cu",
             replaces="src/repro/kernels/masked_sgd.py:26",
             launches=launches["masked_sgd"], max_abs_err=sgd_err, **sgd_t,
             other_paths={f"train {train_row['arch']} (a round)":
                          train_row["masked_sgd_per_round"],
                          **fed_train_paths("masked_sgd")}),
        dict(name="flash_attention", route="cuda",
             source=f"{csrc}/flash_attention.cu",
             replaces="src/repro/kernels/flash_attention.py:64",
             launches=serve_launches["flash_attention"],
             max_abs_err=flash_err, **flash_t,
             other_paths=by_path("flash_attention"),
             other_shapes=[dict(q_k_v=list(FLASH_GEMMA), dtype="bf16",
                                causal=True, **flash_gemma_t),
                           dict(q_k_v=list(FLASH_LLAVA), dtype="bf16",
                                causal=True, **flash_llava_t),
                           dict(q_k_v=list(FLASH_MUSICGEN), dtype="bf16",
                                causal=True, **flash_musicgen_t)]),
        dict(name="ssd_intra_chunk", route="cuda",
             source=f"{csrc}/ssd_intra_chunk.cu",
             replaces="src/repro/kernels/ssd_chunk.py:43",
             launches=ssm_launches["ssd_intra_chunk"], max_abs_err=ssd_err,
             **ssd_t, other_paths=by_path("ssd_intra_chunk"),
             other_shapes=[dict(cells_q_n_p=list(SSD_HYMBA[0][:5]),
                                dtype="f32", **ssd_hymba_t)]),
    ]
    log(card)
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
