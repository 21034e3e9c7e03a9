#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py                 # from the root of a checkout

Phases (any failure raises; nothing is caught):
  1. setup: require a CUDA card, build every kernel from ``src/repro_torch/
     csrc/`` with nvcc, turn TF32 off for matmul and cuDNN;
  2. each kernel against its plain PyTorch version on the card, at the
     shapes the serving path gives it, with the tolerance stated; kernel,
     plain and library times (cold L2, CUDA events) and the roofline bound;
  3. full-width yi-9b (48 layers, bf16, random weights from a seeded
     generator on the card): 8 prompts prefilled through the kernels, the
     plain ("ref") policy and the plain policy on fp32 weights;
     last-position logits compared;
  4. serve 6 requests through ``SlotEngine`` + ``serve()`` with every
     launch counter reset just before and read just after; request 0's
     tokens must equal ``generate`` on its prompt, bitwise;
  4b. gated early-exit decode (``SlotEngine(gated=True)``) on the same
     requests: at exit threshold -1.0 (no row exits: every step with a
     live slot runs the full depth) and 2.0 (every row exits: every step
     skips layers 12-47, their K/V filled by CALM propagation from the
     exit hidden state) the tokens equal the ungated engine's at the same
     threshold, bitwise; launches exact (``gated_step_launches``: a
     skipped step gemm 157, rmsnorm 61, attn_decode 12, entropy_exit 1);
     at 2.0 request 0 == ``generate(gated=True)`` bitwise, exit rate 1.0,
     gated fraction 0.75, and one skipped step's propagated rows equal
     ``_kv_propagate_layer`` through the kernels, bitwise, and the plain
     policy's within one bf16 ulp; at a threshold among the exit
     entropies of a first chunk some steps skip (each step's branch
     recorded) and a second run replays bitwise; a chunk of every-step
     skipped and every-step full gated decode traced;
  5. the same 6 requests through the paged engine (page size 16, a pool
     of 24 usable pages, fewer than the slots could ask for): tokens equal
     phase 4's per request, bitwise, with no contiguous decode launch;
  5b. prefix sharing (``SlotEngine(paged=True, prefix_sharing=True)``): 8
     requests, 6 sharing a 64-token prefix and 2 a 70-token stem that
     part inside a page (``sharing_prompts``), served without sharing and
     then with it, twice on phase 5's pool (the second replays bitwise)
     and once on a pool just above the working set (index pages
     evicted). Every fork-point admission (``SharingProbe``,
     ``check_admissions``): the shared pages' bytes untouched, the COW
     rows == the donor's and the donor untouched, layer 0's suffix K/V ==
     the unshared prefill's, bitwise; launches exactly gemm 337 and
     rmsnorm 97, no flash (``shared_prefill_launches``); first-token
     logits within rel L2 5e-2 of the unshared prefill's and no further
     from fp32; at least 5 fork-point admissions, fewer prefill tokens;
     tokens == the unshared run's up to a near tie (``near_tie_parts``).
     A 128-token prompt as a 64-token ``prefill_chunk`` and a shared 64
     (``run_chunked``: layer-0 K/V of every position == the full
     prefill's, bitwise; 24 decoded tokens == ``generate`` up to a near
     tie); one fork-point admission timed against the standard one
     (``time_admission``);
  5c. overload control (``run_overload``): 8 seeded requests (prompts of
     20-128 tokens, 24 new each) served uncontended on the paged engine,
     then through ``serve(..., overload=OverloadConfig(...))`` on 17
     usable pages (under half of the slots' worst case of 40): with host
     swap, with recompute resumes only, and with 64-token chunked
     admission under mixed priorities; then a sampled pair (temperature
     0.7, top-k 50, top-p 0.9) uncontended and with swap. At least 2
     preemptions, a swap resume, a recompute resume and a chunked
     admission; every swapped-in block gathered back from its new pages
     == the fetched bytes, bitwise (``OverloadProbe``); requests neither
     chunk-admitted nor recompute-resumed == the uncontended tokens,
     bitwise, greedy and sampled (the sampled run resumes by swap only:
     the victim's generator state goes with its pages); the others ==
     them up to a near tie (``near_tie_parts``); launches exactly
     ``zoo_launches`` plus ``shared_prefill_launches`` of each chunk and
     chunked tail; the pool drained clean; one swap-out and one swap-in
     timed by CUDA events;
  5d. fault-tolerant serving (``run_resilient``, run after 6f, whose
     seeded run is one of its references): phase 4's 6 requests under the
     restart supervisor (``serve_resilient``, a snapshot every 2 chunks).
     An armed injector that never fires: tokens and launches exactly the
     plain serve's, contiguous and paged. Kill and resume on the
     contiguous, paged (24 usable pages of 16) and prefix-sharing engines
     (the last on phase 5b's prompts), greedy and seeded-sampled at phase
     6e's settings, one stream each with a fault at every site the engine
     has (prefill, decode; page_alloc, swap when paged): every fault
     fired, one restart each, 100% completion, tokens == the
     uninterrupted run of the same engine, bitwise. rmsnorm through the
     ``chaos`` backend: with a circuit breaker no restart and a trip,
     without a restart from the middle of a decode chunk, both == the
     chaos policy's run; no chaos backend left registered. A 3 s stall
     against a 2 s watchdog. NaN quarantine, contiguous and paged
     (``quarantine_run``): only the poisoned request shed. Each stream
     prints its snapshots' bytes and ms, its restores' ms (CUDA events,
     ``SnapshotProbe``), ``recovery_s_mean`` and its launches beyond the
     uninterrupted run's; 8d and 10b run one paged stream with a decode
     fault on deepseek (latent pages) and jamba (the whole cache, Mamba
     state written in place) the same way;
  5e. the shape-aware dispatch policy (``run_dispatch``, after 5d):
     ``core.autotune.autotune`` at yi-9b's serve dims (the generic fp32
     cells and yi-9b's in bf16), one line a cell (each backend's ms by
     CUDA events, the winner, the skipped backends and why, the prior's
     flops and bytes and its bound); a rule, its cell's argmin, on every
     yi-9b cell (the kernel measured on each) and on no generic cell, no
     kernel skipped on a yi-9b cell but by its ``supports``, every kernel
     a generic cell's ``supports`` accepts launched, the persisted policy
     loaded back equal on this card. Phase 4's requests served contiguous
     and paged
     under (a) an all-"kernel" DispatchPolicy (tokens and launches ==
     phases 4 and 5, bitwise; no fallback; its host-clock ms a step
     against "auto" in turns), (b) the tuned policy and (c) ``{("gemm",
     "rows_m"): "ref"}``: launches exactly what a CPU run of the same
     geometry predicts (``record_calls``: the calls recorded by a wrapper
     of ``xaif.call``, resolved under each policy); where a rule moves a
     call off the kernel, first-token logits within rel L2 5e-2 of (a)'s
     and tokens == (a)'s up to a near tie; no fallback in any of them.
     (d) the tuned policy on the first 4 requests at 1040 positions,
     contiguous and paged (66 pages of 16, one max-length request and
     the scratch page), so
     that decode attention's KV extent is in the kv_l bucket (which no
     yi-9b cell measured): tokens and launches == "auto"'s at the same
     geometry, bitwise, every call recorded there on the kernel, no
     fallback. The zoo's qwen1.5-32b,
     qwen3-moe-30b-a3b and chameleon-34b run at half depth to make room
     (each prints the seconds saved);
  6. greedy speculative decoding on yi-9b without its exit heads, against
     the plain engine on that config: a tied draft on the paged engine
     (acceptance 1.0) and an independent 2-layer draft on the contiguous
     engine, both token for token equal to plain greedy;
  6e. sampled decode on yi-9b (temperature 0.7, top-k 50, top-p 0.9, the
     6 requests seeded): a second run's tokens equal, bitwise, with
     greedy's launches; request 1 served alone (slot 0) equals it
     co-batched (slot 1), bitwise; at temperature 1e-4 the tokens equal
     phase 4's greedy tokens up to an exact top tie of the bf16 logits
     (``greedy_ties``); the sampler alone on 4 rows of yi's [4, 64000]
     logits, 4096 draws a row, within the multinomial null's 99.99th
     percentile of total variation from ``make_probs``;
  6f. sampled speculative decoding on phase 6's config: a tied draft on
     the paged engine accepts every proposal; the 2-layer draft replays
     bitwise and a seeded request's tokens do not depend on its slot;
  6b. yi-9b on int8 weights, its bf16 weights still on the card: the
     port's ``quantize_weights_int8`` on the card (exactly the
     projections of ``_QUANT_NAMES`` in yi's tree); 8 prompts prefilled
     through the kernels against the plain path on the same int8 weights
     in both modes -- weight-only (the default policy: the int8-weight
     instance of ``gemm``) and W8A8 (a policy that names the lossy
     ``int8`` backend of gemm: ``gemm_int8``) -- and each mode's
     distance from the bf16 model's logits;
  6c. the 6-request serve of phase 4 weight-only, contiguous and paged:
     request 0 == ``generate`` and paged == contiguous, bitwise; every
     gemm launch on the int8 weights (338 a step);
  6d. the same serve under W8A8, contiguous: request 0 == ``generate``
     bitwise; every GEMM launch is ``gemm_int8``, no bf16 gemm runs, and
     a traced decode step runs no more device kernels than weight-only's
     (``gemm_int8`` quantizes the activations itself: one kernel a GEMM);
  7. full-width, full-depth deepseek-v2-lite-16b (27 layers, MLA, 64
     experts top-6, bf16, random weights; yi's weights freed first): 128
     prompts prefilled through the kernels, the plain policy and the plain
     policy computing in fp32 on the same weights; 128 prompts at a cut
     depth (the dense layer + 3 MoE layers, full width) against an fp32
     weight copy;
  8. the 6-request serve of phase 4 on deepseek (contiguous KV, greedy,
     exact-length MoE prefill): request 0 equals ``generate`` bitwise, and
     the launch counters show moe_decode, precise attn_decode (its
     counter is attn_decode's: no GQA decode runs on deepseek), gemm_heads
     and the (192, 128) flash attention on every layer; then the same 6
     requests through the paged engine (latent pages of 16, a pool of 24
     usable pages): tokens equal the contiguous run's per request,
     bitwise, precise attn_decode_paged on all 27 layers every step and
     no attn_decode; 8c: the gated engine at threshold 2.0 (MLA latents
     propagated: ``serve_gated``, as phase 4b's);
  9. jamba-v0.1-52b at full width, cut to two super-blocks (16 of its 32
     layers: 14 Mamba, 2 attention, 8 MoE of 16 experts x 14336 top-2;
     bf16, random weights; deepseek's weights freed first): 64 prompts
     prefilled through the kernels, the plain policy and the plain policy
     computing in fp32 on the same bf16 weights (an fp32 copy would not
     fit beside them), and 16 prompts teacher-forced layer by layer;
 10. the 6-request serve of phase 4 on jamba (contiguous KV and
     slot-indexed Mamba state, greedy, exact-length prefill): request 0
     equals ``generate`` bitwise, and the launch counters show ssm_decode
     on the 14 Mamba layers, moe_decode on the 8 MoE layers and
     attn_decode on the 2 attention layers every step, ssm_scan and flash
     attention on them every prefill; then the paged hybrid engine (KV
     pages of 16 for the 2 attention layers beside slot-indexed Mamba
     state, 24 usable pages): tokens equal the contiguous run's, bitwise,
     attn_decode_paged on the 2 attention layers and ssm_decode on the 14
     Mamba layers every step, no attn_decode;
 11. xlstm-350m at full width and full depth (24 layers: 21 mLSTM with
     head dim 512, 3 sLSTM, no attention layer; bf16, random weights;
     jamba's weights freed first): 64 prompts prefilled through the
     kernels, the plain policy and the plain policy on an fp32 weight
     copy, and 16 prompts teacher-forced layer by layer;
 12. the 6-request serve of phase 4 on xlstm (slot-indexed mLSTM and sLSTM
     state, greedy, exact-length prefill): request 0 equals ``generate``
     bitwise, the launch counters are exactly gemm, gemm_heads, rmsnorm,
     entropy_exit and ssm_decode (its mLSTM mode on the 21 mLSTM layers
     every step); then the paged engine (no pool: 24 usable pages are
     accounted, nothing is stored in them): tokens equal the contiguous
     run's, bitwise;
 12d-12h. the rest of the zoo, one arch after another, each built after
     the one before was freed (``run_zoo``; random weights from seed 0,
     bf16, full width, at ``ZOO_LAYERS`` layers, served from token ids):
     chatglm3-6b (28 layers, 32 query heads over 2 KV heads: group 16,
     rotary over half the head dim, QKV biases; 6.24 B params),
     qwen1.5-32b (32 of 64 layers, 40 over 40: group 1, QKV biases; 18.38
     B), qwen3-moe-30b-a3b (24 of 48 layers of 128 experts of 768 top-8,
     QK-norm, 32 heads of 128 over d_model 2048; 15.58 B), chameleon-34b
     (24 of 48 layers, QK-norm, its image tokenizer a stub; 17.68 B) and
     mistral-large-123b cut to 24 of its 88 layers (group 12; 34.02 B):
     8 prompts (qwen3-moe: 64) prefilled through the kernels, the plain
     policy and the plain policy in fp32 (chatglm3 on an fp32 weight copy,
     the four large ones computing in fp32 on their bf16 weights); the
     6-request serve
     contiguous (request 0 == ``generate`` bitwise; every launch counter
     exactly ``zoo_launches``: with a QK-norm, 2 more rmsnorm a layer;
     qwen3-moe's moe_decode on all 48 layers) and paged (tokens equal,
     bitwise; exact launches); one decode chunk of each engine timed and
     traced; greedy speculative decoding without the exit (tokens == plain
     greedy, bitwise) on chatglm3 (a tied draft, paged, and a 2-layer
     draft, contiguous: 64 query rows a KV head at k = 3, the kernels'
     most) and on mistral (a tied draft, paged: 48 rows); chatglm3
     (12e: QKV biases, rotary over half the head dim) and chameleon
     (12g: the K-norm) also served gated at threshold 2.0
     (``serve_gated``); chatglm3 also serves phase 5b's shared-prefix
     stream (``run_sharing``: QKV biases and half rotary in the
     fork-point prefill);
 13. a check that no serve run launched the fp32 flash instance (its
     own counter);
 14. the paper's seizure workload at its published configs (the CNN and
     the encoder transformer, window 1024, 18 channels, fp32): each model
     trained at its operating point on the card (300 steps of batch 64,
     seed 0, the plain policy under autograd), its first 20 steps held
     against the port's CPU training from the same init and batches (from
     the CPU's parameters before each step: loss and gradients; the
     free-running losses' difference printed), cuDNN deterministic; 2048
     windows (seed 1) evaluated through the kernels and through plain from
     the same parameters: logits and entropies within tolerance, exit
     decisions equal (rows within 1e-5 of the threshold counted apart),
     launches exact a batch of 256 (transformer: attention 4, all of the
     fp32 (16, 16) instance, rmsnorm 8, gemm 2, entropy_exit 1; CNN: gemm
     2, entropy_exit 1); exit rate, F1 and accuracy printed, F1 >= 0.9 and
     exit rate > 0.5 asserted, and the exit rate never falling over
     thresholds 0.1-0.5; the Fig. 3 table from the measured exit rates;
     and a kernel launch on a tensor that requires grad raises;
 15. the LM training path (``run_training``): (a) reduced yi-9b,
     deepseek (MLA, MoE, a dense prefix), jamba, xlstm and musicgen in
     fp32, 3 train steps each (``make_train_step`` under the plain
     policy), each step on the card from the CPU's parameters and AdamW
     state against the CPU's step (loss 1e-5, grad_norm 1e-4 relative,
     parameters 1e-5 + 1e-4 |p|); (b) full-width musicgen-medium (48
     layers, d_model 1536, 1.818 B params) trained by ``train()`` for 120
     steps of 8 x 256 tokens from ``lm_batches`` (bf16 parameters, fp32
     master and moments, remat "nothing", peak lr 1e-3): ms a step by CUDA
     events, the peak allocation and the losses printed; every loss
     finite, the mean of the last 10 final and exit losses below the
     first 10's, no kernel launched; (c) the optimizer state freed, the
     trained weights served through the kernels as phases 12b-12c did the
     random ones (``run_zoo``: 8 prompts prefilled through the kernels,
     the plain policy and an fp32 weight copy; the 6-request serve
     contiguous and paged, exact launches, request 0 == ``generate`` and
     paged == contiguous, bitwise; greedy speculative decoding without
     the exit, tied and 2-layer drafts), the same requests under the
     plain policy (tokens == the kernels' up to a near tie), and, as
     findings, the exit rate at the config's threshold (0.45) and a
     gated serve's skipped steps and gated fraction;
 16. one JSON line listing the kernels (those on ``forward_decode_gated``'s
     path with their launches in its threshold-2.0 runs beside, those on
     the prefix-sharing path with their launches in its first sharing
     run, those on the overload path with their launches in phase 5c's
     chunked run, those on the fault-tolerant path with their launches in
     phase 5d's supervised streams whose injector never fires, those on
     the dispatch-policy path with their launches in phase 5e's tuned
     serves, and each kernel's autotune cells; every kernel's launches in
     phase 15's training steps, all 0, and musicgen's kernels' launches
     serving the trained weights), the card's name and power limit, the
     script's seconds, and the final ``{"ok": true, ...}`` line.

Phase 2 also holds deepseek's, jamba's, xlstm's and musicgen's kernels
at their serving shapes (musicgen's head-dim-64 decode kernels in bf16 and
fp32, with the bitwise identities of the paged and verify kernels at D =
64, and its bf16 flash (64, 64) with the padded-prompt rows), the rest of
the zoo's (``check_zoo``: the decode GEMMs of the five archs and
qwen3-moe's fp32 router; flash attention, decode attention and the paged
and verify kernels with their bitwise identities at groups 16, 1 and 12;
moe_decode at 128 experts top-8; rmsnorm over the head dim, the QK-norm),
and the int8 kernels at yi-9b's (``gemm_int8``, which
quantizes the activations itself, bitwise == plain for none / relu; the
int8-weight ``gemm`` bitwise == the bf16 kernel on the dequantized
weight), and asserts, bitwise, that row b of a
B = 4 launch of moe_decode (at h = 1408 and 14336), precise attn_decode,
GQA attn_decode and attn_decode_paged (at yi-9b's group of 8 and
jamba's of 4), gemm_heads (both layouts), ssm_decode, mlstm_decode,
gemm_int8 and the int8-weight gemm equals its B = 1 launch, that row i
of an M = 4, 16, 20 and 128 launch of the bf16, int8-weight and fp32 gemm,
of gemm_int8 and of gemm_heads (all three layouts) equals its M = 1
launch (ptxas's registers, shared memory and spills of each gemm.cu,
gemm_int8.cu and moe_decode.cu instance printed beside), and that a
selective scan of
T1 then T2 tokens with the state carried equals the scan of T1 + T2; that
the first t rows of flash attention (both bf16 instances) on a prompt
right-padded to the next multiple of 16 equal the unpadded prompt's (t =
20, 100), flash being held at yi-9b's serve buckets (B 1, T 32 / 64 /
128), check_prefill's B 8 x 100 and deepseek's prefill lengths; verify
attention at K1 = 2 and 4; and the precise (MLA) paged
decode kernel against its plain version, bitwise against the contiguous
precise kernel on the same latent at page sizes 16 and 32, row b of a B =
4 launch against its B = 1 launch, with NaN on -1 pages and past
cache_pos kept out. rmsnorm is held at every shape the serving path gives
it (the layer norms, exit heads, MLA ``kv_norm`` and xLSTM norms at 4
live slots, d_model up to 12288, the QK-norm's rows of 128, and [128,
4096]), its line naming its thread map
(``rmsnorm_plan``), and, bitwise, the rows of an M = 4 launch equal their
M = 1 launches, rows of an M = 128 launch their M = 4 launch, and an input
at a 2-element offset its aligned copy. entropy_exit is held at every
served vocabulary (4 live slots, bf16: 2048, 32768, 50304, 64000,
65024, 65536, 102400, 151936, 152064), at
[4, 64000] fp32 and at two odd widths (scalar loads), its lines naming
its cluster plan (``entropy_plan``), and, bitwise, row b of an M = 4
launch equals its M = 1 launch, rows of an M = 16 launch their M = 4
launch, an input at a 2-element offset its aligned copy, and a row
holding a NaN gives NaN while the other rows keep their bits. The
seizure models' evaluation shapes are held too (``check_seizure_kernels``):
the fp32 flash instance at (16, 16), non-causal (and causal, ragged, GQA),
the fp32 gemm with bias at N = 2 (and 3, 6), rmsnorm fp32 d 64 and
entropy_exit fp32 V = 2, with row b of a B = 4 launch == its B = 1 launch
for the attention instance and the N = 2 gemm, bitwise. Each
decode-attention kernel's
time line names its block plan (``decode_plan`` / ``mla_plan``, read
from the card's library); gemm_int8's and moe_decode's lines name theirs (``int8_plan``,
``moe_plan``). Each serve run resets every launch counter just
before it and reads them just after; a kernel's ``launches`` in the JSON
line come from the run of its path (phase 4, 5, 5b, 5c, 6, 6c, 6d, 8, 10,
12, 12d-12h, 14 or 15(c)). Each served model
also has three decode chunks timed by the host clock and two steps more
traced per engine (``TRACE_STEPS``; ``decode step`` lines, with the
device kernels a step, the GEMM,
decode-attention and MoE kernels' shares, and rmsnorm's and the mLSTM
step's, entropy_exit's and the Mamba step's ms and launches a step),
paged beside contiguous;
yi-9b's weight-only and W8A8 engines are also timed in turns (``host
clock in turns``).

Imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import math
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
PEAK_FLOPS = {"bfloat16": 989e12,  # dense tensor-core rate
              "int8": 1979e12,     # dense tensor-core rate (TOP/s)
              "float32": 67e12}    # CUDA cores, no TF32
# xlstm-350m's prefill, kernels against plain: bounds on the rel L2 of the
# last-position logits (max, mean over 64 prompts), 2x the readings of the
# first run on the H100 (max 0.397, mean 0.273; PERF.md)
XLSTM_PREFILL = (0.79, 0.55)
# yi-9b on int8 weights, kernels against plain on the same weights: bounds
# on the rel L2 of the last-position logits (max, mean over 8 prompts) and
# the largest rel L2 from the bf16 model's logits, 2x the readings of the
# first run on the H100 (weight-only: max 0.0228, mean 0.0214, 0.0647 from
# bf16; W8A8: max 0.0503, mean 0.0478, 0.0871 from bf16; PERF.md); and the
# clear prompts required (default 4 of 8; W8A8's plain path is 0.069 RMS
# from fp32, so its clear gap is 0.35 and one prompt of 8 was clear)
WQ_PREFILL = (0.046, 0.043, None)
W8A8_PREFILL = (0.10, 0.096, 1)
QUANT_VS_BF16 = {"weight-only": 0.13, "w8a8": 0.175}
# the zoo archs served by ``run_zoo`` in phases 12d-12h and 15(c):
# the layers each is served at, at full width. musicgen-medium and
# chatglm3-6b at full depth; qwen1.5-32b (64 layers), qwen3-moe-30b-a3b
# (48) and chameleon-34b (48) cut to half their depth, their exits at
# layers 16, 12 and 12 kept, to make room for phase 5e within the
# script's time; mistral-large-123b (1.384 B parameters a layer, 246 GB
# whole) cut to 24 of its 88 layers (63.4 GiB), as jamba is cut, its exit
# at layer 22 kept
ZOO_LAYERS = {"musicgen-medium": 48, "chatglm3-6b": 28, "qwen1.5-32b": 32,
              "qwen3-moe-30b-a3b": 24, "chameleon-34b": 24,
              "mistral-large-123b": 24}
# the seconds of those three archs' phases at full depth, on an NVIDIA H100
# 80GB HBM3 at 700 W (this script's run before the cut): what the cut saves
# is printed against them
ZOO_FULL_DEPTH_S = {"qwen1.5-32b": 92.7, "qwen3-moe-30b-a3b": 95.8,
                    "chameleon-34b": 76.4}
# phase 5b's pool just above the live working set of its 8 shared-prefix
# requests (4 slots, pages of 16): admission there evicts index pages
SHARE_SMALL_POOL = 14
# the fewest rows torch._int_mm takes on the card (the library yardstick)
INT_MM_MIN_ROWS = 17
# the seizure workload: training steps on the card; the first 20 held
# against the port's CPU training from the same init and batches, in two
# ways. Step by step from the CPU's parameters before each step, the card's
# loss within 1e-5 relative and each gradient leaf within a tolerance of
# its largest element: the transformer's 1e-4 (fp32 sums in other orders);
# the CNN's 1e-2, because its max-pool windows and ReLUs route a gradient
# by which input wins a near-tie, which rounding decides (on the CPU, a
# 1e-7 relative perturbation of its parameters moves its gradients by up
# to 5.9e-4 of a leaf's largest element, the transformer's by 8e-6; the
# card's first run read 1.8e-3 and 1.2e-5). Free-running, the card's
# losses within 1e-2 + 5e-2 |loss| of the CPU's: a step's update is
# lr * m / sqrt(v), near lr * sign(g) in the first steps whatever |g|, so
# a gradient element within rounding of 0 moves its weight by +-lr on one
# side and the other, and max-pool windows within rounding of a tie route
# the gradient elsewhere; the CNN's trajectories part (two runs on the
# card: 3e-5 apart at step 2, cuDNN's backward is not deterministic; 5.3e-4
# and 2.9e-3 from the CPU's at a loss of 0.038 at step 17), the
# transformer's (no pooling) stay within 1e-6. Then the thresholds of the
# exit-rate sweep.
SEIZURE_STEPS = 300
SEIZURE_CPU_STEPS = 20
SEIZURE_LOSS_TOL = 1e-5                 # relative, from the same parameters
SEIZURE_GRAD_TOL = {"transformer": 1e-4, "cnn": 1e-2}   # of a leaf's max
SEIZURE_THRESHOLDS = (0.1, 0.2, 0.35, 0.45, 0.5)


def bound(nbytes: float, flops: float, dtype: str):
    """(bound_ms, bound_by): the larger of the memory and compute times."""
    t_mem = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_mem, "bytes") if t_mem >= t_ops else (t_ops, "operations")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip()
    return out.splitlines()[0]


class Timer:
    """Median time of one call with a cold L2 (a 128 MiB buffer is
    written between calls), by CUDA events around each call. A ~0.5 ms
    spin of the device (``torch.cuda._sleep``) is queued before the start
    event, so the host's work before the first launch (a wrapper's checks
    and allocations) overlaps it and stays out of the reading: the time is
    the device's, from the first kernel of the call to the end of the
    last."""

    SPIN_CYCLES = 1_000_000

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")

    def __call__(self, fn, iters: int = 10) -> float:
        torch = self.torch
        fn()
        fn()
        times = []
        for _ in range(iters):
            self.flush.zero_()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(self.SPIN_CYCLES)
            s.record()
            fn()
            e.record()
            e.synchronize()
            times.append(s.elapsed_time(e))
        return sorted(times)[len(times) // 2]


def check_kernels(torch, timer):
    """Phase 2. Returns {kernel name: record of its representative shape}."""
    import torch.nn.functional as F

    from repro_torch.kernels.attn_decode import ops as ad
    from repro_torch.kernels.attn_decode.ref import attn_decode_ref
    from repro_torch.kernels.entropy_exit import ops as ee
    from repro_torch.kernels.entropy_exit.ref import entropy_ref
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.gemm import ops as gm
    from repro_torch.kernels.gemm.ref import gemm_ref
    from repro_torch.kernels.rmsnorm import ops as rn
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

    gen = torch.Generator(device="cuda").manual_seed(1234)
    bf16 = torch.bfloat16

    def randn(*shape, dtype=bf16, scale=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda") * scale
                ).to(dtype)

    records = {}

    def compare(name, shape, kernel, plain, library, nbytes, flops, dtype,
                rtol, atol, representative=False, plan=None):
        """Kernel against plain on the same inputs. A kernel returning a
        tuple is compared output by output, ``rtol`` / ``atol`` then
        tuples of per-output tolerances; ``max_abs_err`` is the largest.
        ``plan`` (the kernel's block plan) is printed beside its times."""
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        if not isinstance(got, tuple):
            got, want, rtol, atol = (got,), (want,), (rtol,), (atol,)
        errs, ok = [], True
        for g, w, rt, at in zip(got, want, rtol, atol):
            err = (g.float() - w.float()).abs()
            errs.append(float(err.max()))
            ok = ok and bool((err <= at + rt * w.float().abs()).all())
        max_abs = max(errs)
        ms, plain_ms = timer(kernel), timer(plain)
        lib_ms = timer(library) if library is not None else None
        b_ms, b_by = bound(nbytes, flops, dtype)
        tol = ", ".join(f"{a:g} + {r:g}*|ref|" for r, a in zip(rtol, atol))
        each = "" if len(errs) == 1 else f" per output {errs}"
        print(f"kernel {name:12s} {shape:34s} max_abs_err={max_abs:.3e}"
              f"{each} (tol {tol}) ms={ms:.4f} "
              f"plain_ms={plain_ms:.4f} library_ms="
              f"{'null' if lib_ms is None else f'{lib_ms:.4f}'} "
              f"bound_ms={b_ms:.4f} ({b_by})"
              f"{'' if plan is None else f'; plan {plan}'}", flush=True)
        if not ok:
            raise AssertionError(f"{name} {shape}: kernel disagrees with "
                                 f"its plain version (max abs err {errs})")
        if representative:
            records[name] = dict(shape=shape, max_abs_err=max_abs, ms=ms,
                                 plain_ms=plain_ms, bound_ms=b_ms,
                                 bound_by=b_by, library_ms=lib_ms)

    # gemm: bf16 outputs of magnitude ~1; the two sides differ only in the
    # fp32 summation order, which can move the bf16 rounding by one unit
    # in the last place (2^-8 relative): rtol = atol = 1e-2
    for m in (4, 128):
        for k, n, act in ((4096, 4096, "none"), (4096, 512, "none"),
                          (4096, 11008, "silu"), (11008, 4096, "none"),
                          (4096, 64000, "none")):
            x, w = randn(m, k), randn(k, n, scale=k ** -0.5)
            lib = (lambda x=x, w=w: torch.matmul(x, w)) if act == "none" \
                else None
            compare("gemm", f"M={m} K={k} N={n} {act}",
                    lambda x=x, w=w, a=act: gm.gemm(x, w, activation=a),
                    lambda x=x, w=w, a=act: gemm_ref(x, w, activation=a),
                    lib, 2 * (m * k + k * n + m * n), 2 * m * k * n,
                    "bfloat16", 1e-2, 1e-2,
                    representative=(m == 4 and k == 4096 and n == 4096))
    # fp32 inputs: full fp32 on both sides, summation order only
    x, w = randn(4, 4096, dtype=torch.float32), randn(
        4096, 512, dtype=torch.float32, scale=4096 ** -0.5)
    compare("gemm", "M=4 K=4096 N=512 none fp32",
            lambda: gm.gemm(x, w), lambda: gemm_ref(x, w),
            lambda: torch.matmul(x, w), 4 * (4 * 4096 + 4096 * 512 + 4 * 512),
            2 * 4 * 4096 * 512, "float32", 1e-4, 1e-4)
    check_int8(torch, compare, randn)
    check_gemm_rows(torch, randn)

    # rmsnorm: fp32 math on both sides, bf16 output: one bf16 ulp
    x, sc = randn(128, 4096), randn(4096, dtype=torch.float32)
    compare("rmsnorm", "[128, 4096] scale fp32",
            lambda: rn.rmsnorm(x, sc), lambda: rmsnorm_ref(x, sc),
            lambda: F.rms_norm(x, (4096,), sc.to(bf16), 1e-5),
            2 * 128 * 4096 * 2 + 4096 * 4, 4 * 128 * 4096, "bfloat16",
            1e-2, 1e-2, representative=True,
            plan=rn.rmsnorm_plan(4096, bf16))
    check_rmsnorm(torch, compare)

    # flash attention: fp32 online softmax (P rounded to bf16 for the
    # tensor cores) vs the materialized fp32 softmax, bf16 output: one
    # bf16 ulp. yi-9b's serve buckets (B 1, T 32 / 64 / 128; the last is
    # the representative row) and check_prefill's 8 prompts x 100 tokens
    for b, t in ((1, 32), (1, 64), (8, 100), (1, 128)):
        q, k_, v_ = randn(b, 32, t, 128), randn(b, 4, t, 128), \
            randn(b, 4, t, 128)
        pairs = t * (t + 1) // 2                # causal (query, key) pairs
        compare("attention", f"q[{b},32,{t},128] kv[{b},4,{t},128] causal",
                lambda q=q, k_=k_, v_=v_: fa.attention(q, k_, v_,
                                                       causal=True),
                lambda q=q, k_=k_, v_=v_: attention_ref(q, k_, v_,
                                                        causal=True),
                lambda q=q, k_=k_, v_=v_: F.scaled_dot_product_attention(
                    q, k_, v_, is_causal=True, enable_gqa=True),
                2 * (2 * q.numel() + 2 * k_.numel()),
                4 * b * 32 * 128 * pairs, "bfloat16", 1e-2, 1e-2,
                representative=(b, t) == (1, 128))
    check_flash_padding(torch, randn, 4, 128)

    # decode attention: the plain version rounds the softmax weights to
    # bf16 before the weighted sum (as the JAX ref), the kernel keeps them
    # fp32: differences up to ~2^-9 of the output scale
    b, s = 4, 160
    q, kc, vc = randn(b, 32, 128), randn(b, 4, s, 128), randn(b, 4, s, 128)
    cp = torch.tensor([19, 75, 130, 159], dtype=torch.int32, device="cuda")
    n_valid = int((cp + 1).sum())
    mask = (torch.arange(s, device="cuda")[None, :] <= cp[:, None]
            )[:, None, None, :]
    compare("attn_decode", "q[4,32,128] kv[4,4,160,128] ragged",
            lambda: ad.attn_decode(q, kc, vc, cp),
            lambda: attn_decode_ref(q, kc, vc, cp),
            lambda: F.scaled_dot_product_attention(
                q[:, :, None], kc, vc, attn_mask=mask, enable_gqa=True),
            2 * q.numel() + 2 * 2 * 4 * 128 * n_valid + 4 * b * 32 * 128 + 4 * b,
            4 * 32 * 128 * n_valid, "bfloat16", 1e-2, 1e-2,
            representative=True, plan=ad.decode_plan(b, 32, 4))

    check_paged_and_verify(torch, compare, randn, gen)
    check_mla_moe(torch, compare, randn, gen)
    check_paged_mla(torch, compare, randn, gen)
    check_jamba(torch, compare, randn, gen)
    check_xlstm(torch, compare, randn, gen)
    check_musicgen(torch, compare)
    check_zoo(torch, compare)

    # entropy: fp32 sums in another order; the result is O(1). Library:
    # the entropy of torch.distributions.Categorical over log V
    lg = randn(4, 64000, scale=3.0)
    log_v = math.log(64000)
    compare("entropy_exit", "[4, 64000] yi-9b",
            lambda: ee.entropy(lg), lambda: entropy_ref(lg),
            lambda: torch.distributions.Categorical(
                logits=lg.float()).entropy() / log_v,
            2 * lg.numel() + 4 * 4, 6 * lg.numel(), "bfloat16", 1e-4, 1e-4,
            representative=True, plan=ee.entropy_plan(64000, bf16))
    check_entropy(torch, compare)
    check_seizure_kernels(torch, compare)
    return records


def check_seizure_kernels(torch, compare):
    """Phase 2 for the seizure models' evaluation (batches of 256 windows,
    fp32 throughout): the fp32 flash instance at (16, 16), non-causal, q /
    k / v [256, 4, 16, 16] (the transformer's 4 heads of 16 over 16
    tokens), also causal, ragged (T = S = 20) and GQA; the fp32 gemm with
    bias at N = 2 (the heads: CNN exit [256, 32] @ [32, 2] and head [256,
    128] @ [128, 2], transformer [256, 64] @ [64, 2]), at N = 3, 6, 7
    (gelu, K = 100) and 1 (relu, K = 2048) (the narrow kernel, a warp a
    row) and at N = 8 (the tiled kernel);
    rmsnorm fp32 [256, 16, 64] with an fp32 scale; entropy_exit fp32
    [256, 2]. Tolerance 1e-4 + 1e-4 |ref|: fp32 on both sides, sums in
    another order. Library calls: SDPA (fp32, TF32 off), ``torch.addmm``
    (bias + x @ w in one call), ``F.rms_norm``, ``Categorical``. Bitwise:
    row b of a B = 4 launch == its B = 1 launch for the attention instance,
    and row i of an M = 20 launch == its M = 1 launch for the N = 2 gemm.
    Inputs from a generator of their own."""
    import torch.nn.functional as F

    from repro_torch.kernels.entropy_exit import ops as ee
    from repro_torch.kernels.entropy_exit.ref import entropy_ref, log_vocab
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.gemm import ops as gm
    from repro_torch.kernels.gemm.ref import gemm_ref
    from repro_torch.kernels.rmsnorm import ops as rn
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

    f32 = torch.float32
    g = torch.Generator(device="cuda").manual_seed(25)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device="cuda") * scale

    # attention: (B, Hq, Hkv, T, causal); the first is the evaluation's
    for b, hq, hkv, t, causal in ((256, 4, 4, 16, False),
                                  (256, 4, 4, 16, True),
                                  (4, 4, 2, 20, False), (4, 4, 4, 20, True)):
        q, k, v = randn(b, hq, t, 16), randn(b, hkv, t, 16), \
            randn(b, hkv, t, 16)
        pairs = t * (t + 1) // 2 if causal else t * t
        compare("attention_fp32_d16" if not causal and b == 256
                else "attention",
                f"q[{b},{hq},{t},16] kv[{b},{hkv},{t},16] fp32 "
                f"{'causal' if causal else 'non-causal'}",
                lambda q=q, k=k, v=v, c=causal: fa.attention(q, k, v,
                                                             causal=c),
                lambda q=q, k=k, v=v, c=causal: attention_ref(q, k, v,
                                                              causal=c),
                lambda q=q, k=k, v=v, c=causal:
                    F.scaled_dot_product_attention(q, k, v, is_causal=c,
                                                   enable_gqa=True),
                4 * (2 * q.numel() + 2 * k.numel()), 4 * b * hq * 16 * pairs,
                "float32", 1e-4, 1e-4,
                representative=(b == 256 and not causal))
    q, k, v = randn(4, 4, 16, 16), randn(4, 4, 16, 16), randn(4, 4, 16, 16)
    four = fa.attention(q, k, v, causal=False)
    for i in range(4):
        assert torch.equal(four[i:i + 1], fa.attention(
            q[i:i + 1].contiguous(), k[i:i + 1].contiguous(),
            v[i:i + 1].contiguous(), causal=False)), ("attention d16", i)

    # gemm fp32 with bias: (K, N, activation, where); the transformer's is
    # the record. Below 8 columns the narrow kernel (a warp a row) runs.
    for kk, n, act, what in ((32, 2, "none", "CNN exit head"),
                             (128, 2, "none", "CNN head"),
                             (64, 2, "none", "transformer heads"),
                             (64, 3, "none", "N = 3"),
                             (128, 6, "none", "N = 6"),
                             (100, 7, "gelu", "N = 7, ragged K"),
                             (2048, 1, "relu", "N = 1, long K"),
                             (64, 8, "none", "N = 8, the tiled kernel")):
        x, w, bias = randn(256, kk), randn(kk, n, scale=kk ** -0.5), \
            randn(n)
        compare("gemm_fp32_n2" if what == "transformer heads" else "gemm",
                f"M=256 K={kk} N={n} bias {act} fp32 {what}",
                lambda x=x, w=w, bias=bias, a=act: gm.gemm(x, w, bias, a),
                lambda x=x, w=w, bias=bias, a=act: gemm_ref(x, w, bias, a),
                (lambda x=x, w=w, bias=bias: torch.addmm(bias, x, w))
                if act == "none" else None,
                4 * (256 * kk + kk * n + n + 256 * n), 2 * 256 * kk * n,
                "float32", 1e-4, 1e-4,
                representative=(what == "transformer heads"),
                plan=("gemm_f32_narrow_kernel, a warp a row"
                      if n < gm.F32_NARROW else str(gm.f32_plan(n, kk))))
    for kk in (32, 64, 128):
        x, w, bias = randn(20, kk), randn(kk, 2, scale=kk ** -0.5), randn(2)
        many = gm.gemm(x, w, bias)
        for i in (0, 1, 2, 3, 9, 19):     # the first and second blocks
            assert torch.equal(many[i:i + 1], gm.gemm(
                x[i:i + 1].contiguous(), w, bias)), ("gemm N=2", kk, i)

    x, sc = randn(256, 16, 64, scale=3.0), randn(64)
    compare("rmsnorm_fp32_d64", "[256, 16, 64] fp32 scale fp32",
            lambda: rn.rmsnorm(x, sc), lambda: rmsnorm_ref(x, sc),
            lambda: F.rms_norm(x, (64,), sc, 1e-5),
            4 * (2 * x.numel() + 64), 4 * x.numel(), "float32", 1e-4, 1e-4,
            representative=True, plan=rn.rmsnorm_plan(64, f32))

    lg = randn(256, 2, scale=3.0)
    compare("entropy_exit_fp32_v2", "[256, 2] fp32 seizure exit",
            lambda: ee.entropy(lg), lambda: entropy_ref(lg),
            lambda: torch.distributions.Categorical(
                logits=lg).entropy() / log_vocab(2),
            4 * (lg.numel() + 256), 6 * lg.numel(), "float32", 1e-4, 1e-4,
            representative=True, plan=ee.entropy_plan(2, f32))
    torch.cuda.synchronize()
    print("bitwise: attention fp32 (16, 16) non-causal row b of a B = 4 "
          "launch == its B = 1 launch; gemm fp32 N = 2 with bias row i of "
          "an M = 20 launch == its M = 1 launch (K = 32, 64, 128)",
          flush=True)


def check_entropy(torch, compare):
    """Phase 2 for entropy_exit at the other served vocabularies (4 live
    slots, bf16: xlstm-350m's 50304, jamba-v0.1-52b's 65536,
    deepseek-v2-lite-16b's 102400, musicgen-medium's 2048, chatglm3-6b's
    65024, qwen1.5-32b's 152064, qwen3-moe-30b-a3b's 151936,
    mistral-large-123b's 32768; chameleon-34b's 65536 is jamba's), at
    yi-9b's [4, 64000] in fp32, and at
    two odd widths, [3, 1001] and [4, 50257], whose rows start off 16-byte
    boundaries (the kernel's scalar loads); each line names the kernel's
    plan (``entropy_plan``). Tolerance 1e-4 + 1e-4 |ref|: fp32 sums in
    another order. Bitwise, at every served V (and [*, 64000] fp32): row b
    of an M = 4 launch == its M = 1 launch, rows 0-3 and 12-15 of an M = 16
    launch == their M = 4 launches, an input at a 2-element offset (not
    16-byte aligned) == its aligned copy, and a NaN (in row 1 at the last
    element, which the cluster's last block reads, and in row 2 at element
    777) gives NaN on exactly those rows and leaves rows 0 and 3 equal to
    their M = 1 launches. Inputs from a generator of their own, so that the
    later phases draw what they drew before."""
    from repro_torch.kernels.entropy_exit import ops as ee
    from repro_torch.kernels.entropy_exit.ref import entropy_ref, log_vocab

    f32, bf16 = torch.float32, torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(24)

    def logits(m, v, dt):
        return (torch.randn(m, v, generator=g, device="cuda") * 3).to(dt)

    for m, v, dt, what in ((4, 50304, bf16, "xlstm-350m"),
                           (4, 65536, bf16, "jamba-v0.1-52b"),
                           (4, 102400, bf16, "deepseek-v2-lite-16b"),
                           (4, 64000, f32, "yi-9b fp32"),
                           (3, 1001, bf16, "odd V"),
                           (4, 50257, bf16, "odd V"),
                           (4, 2048, bf16, "musicgen-medium"),
                           (4, 65024, bf16, "chatglm3-6b"),
                           (4, 152064, bf16, "qwen1.5-32b"),
                           (4, 151936, bf16, "qwen3-moe-30b-a3b"),
                           (4, 32768, bf16, "mistral-large-123b")):
        x = logits(m, v, dt)
        compare("entropy_exit", f"[{m}, {v}] {what}",
                lambda x=x: ee.entropy(x), lambda x=x: entropy_ref(x),
                lambda x=x, v=v: torch.distributions.Categorical(
                    logits=x.float()).entropy() / log_vocab(v),
                x.numel() * x.element_size() + 4 * m, 6 * x.numel(),
                "bfloat16" if dt == bf16 else "float32", 1e-4, 1e-4,
                plan=ee.entropy_plan(v, dt))

    widths = []
    for v, dt in ((50304, bf16), (64000, bf16), (65536, bf16),
                  (102400, bf16), (64000, f32), (2048, bf16),
                  (65024, bf16), (152064, bf16), (151936, bf16),
                  (32768, bf16)):
        x = logits(16, v, dt)
        full = ee.entropy(x)
        four = ee.entropy(x[:4].contiguous())
        solo = [ee.entropy(x[b:b + 1].contiguous()) for b in range(4)]
        for b in range(4):
            assert torch.equal(four[b:b + 1], solo[b]), ("entropy M=1", v,
                                                         dt, b)
        assert torch.equal(full[:4], four), ("entropy M=16", v, dt)
        assert torch.equal(full[12:], ee.entropy(x[12:].contiguous())), (
            "entropy M=16", v, dt)
        buf = torch.empty(4 * v + 2, dtype=dt, device="cuda")
        buf[2:] = x[:4].reshape(-1)
        xu = buf[2:].view(4, v)
        assert xu.data_ptr() % 16, "the offset input is 16-byte aligned"
        assert torch.equal(ee.entropy(xu), four), ("entropy offset", v, dt)
        xn = x[:4].clone()
        xn[1, v - 1] = float("nan")
        xn[2, 777] = float("nan")
        got = ee.entropy(xn)
        assert torch.isnan(got).tolist() == [False, True, True, False], (
            "entropy NaN rows", v, dt, got)
        assert torch.equal(got[0:1], solo[0]) and torch.equal(
            got[3:4], solo[3]), ("entropy NaN: other rows", v, dt)
        widths.append(f"{v} {'bf16' if dt == bf16 else 'fp32'}")
    torch.cuda.synchronize()
    print(f"bitwise: entropy_exit row b of an M = 4 launch == its M = 1 "
          f"launch, rows 0-3 and 12-15 of an M = 16 launch == their M = 4 "
          f"launches, an input at a 2-element offset == its aligned copy, "
          f"NaN rows NaN and the others' bits kept, at V = {widths}",
          flush=True)


def check_rmsnorm(torch, compare):
    """Phase 2 for rmsnorm at every other shape the serving path gives it
    (4 live slots at decode): yi-9b's and jamba's layer norms [4, 4096]
    bf16 with an fp32 scale, the exit head's with a bf16 scale, deepseek's
    [4, 2048] (and its exit head's) and its ``kv_norm`` [4, 512], xlstm's
    block norms [4, 1024], its mLSTM head norm [16, 512] fp32 with a unit
    scale and its sLSTM norm [4, 1024] fp32, musicgen-medium's [4, 1536]
    (layer norms and exit head), and the other zoo archs' new widths:
    qwen1.5-32b's [4, 5120], chameleon-34b's [4, 8192] and
    mistral-large-123b's [4, 12288] (layer norms; mistral's exit head too;
    chatglm3's 4096 and qwen3-moe's 2048 are above); each line names the
    kernel's
    thread map. A call at decode sits under the cold-L2 timer's floor (~8.5
    us), so these times say little (``kernel_ab.py --kernel rmsnorm`` and
    the decode-step traces time it). Bitwise, at [*, 4096] bf16 (both
    scales) and the other served widths: the rows of an M = 4 launch == their
    M = 1 launches, rows 60-63 of an M = 128 launch == the M = 4 launch of
    those rows, and an input at a 2-element offset (not 16-byte aligned:
    the kernel's scalar loads) == its aligned copy. Inputs from a generator
    of their own, so that the later phases draw what they drew before."""
    import torch.nn.functional as F

    from repro_torch.kernels.rmsnorm import ops as rn
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

    f32, bf16 = torch.float32, torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(22)

    def inputs(m, d, dt, sdt):
        x = (torch.randn(m, d, generator=g, device="cuda") * 3).to(dt)
        sc = (torch.ones(d, device="cuda") if sdt is None else torch.randn(
            d, generator=g, device="cuda")).to(sdt or f32)
        return x, sc

    # (M, d, x dtype, scale dtype (None: a unit fp32 scale), where)
    for m, d, dt, sdt, what in (
            (4, 4096, bf16, f32, "yi-9b / jamba layer norms"),
            (4, 4096, bf16, bf16, "exit head"),
            (4, 2048, bf16, f32, "deepseek layer norms"),
            (4, 2048, bf16, bf16, "deepseek exit head"),
            (4, 512, bf16, f32, "deepseek kv_norm"),
            (4, 1024, bf16, f32, "xlstm block norms"),
            (16, 512, f32, None, "xlstm mLSTM head norm"),
            (4, 1024, f32, f32, "xlstm sLSTM norm"),
            (4, 1536, bf16, f32, "musicgen layer norms"),
            (4, 1536, bf16, bf16, "musicgen exit head"),
            (4, 5120, bf16, f32, "qwen1.5 layer norms"),
            (4, 8192, bf16, f32, "chameleon layer norms"),
            (4, 12288, bf16, f32, "mistral layer norms"),
            (4, 12288, bf16, bf16, "mistral exit head")):
        x, sc = inputs(m, d, dt, sdt)
        # bf16 output: one bf16 ulp; fp32 output: rsqrt and summation order
        tol = 1e-2 if dt == bf16 else 1e-4
        compare("rmsnorm", f"[{m}, {d}] {what}",
                lambda x=x, sc=sc: rn.rmsnorm(x, sc),
                lambda x=x, sc=sc: rmsnorm_ref(x, sc),
                lambda x=x, sc=sc, d=d: F.rms_norm(x, (d,), sc.to(x.dtype),
                                                   1e-5),
                2 * x.numel() * x.element_size() + d * sc.element_size(),
                4 * x.numel(), "bfloat16" if dt == bf16 else "float32",
                tol, tol, plan=rn.rmsnorm_plan(d, dt))

    widths = []
    for d, dt, sdt in ((4096, bf16, f32), (4096, bf16, bf16),
                       (2048, bf16, f32), (1024, bf16, f32), (512, bf16, f32),
                       (512, f32, f32), (1024, f32, f32), (1536, bf16, f32),
                       (5120, bf16, f32), (8192, bf16, f32),
                       (12288, bf16, f32), (12288, bf16, bf16)):
        x, sc = inputs(128, d, dt, sdt)
        full = rn.rmsnorm(x, sc)
        four = rn.rmsnorm(x[:4].contiguous(), sc)
        for i in range(4):
            assert torch.equal(four[i:i + 1], rn.rmsnorm(
                x[i:i + 1].contiguous(), sc)), ("rmsnorm M=1", d, dt, i)
        assert torch.equal(full[:4], four), ("rmsnorm M=128", d, dt)
        assert torch.equal(full[60:64], rn.rmsnorm(x[60:64].contiguous(),
                                                   sc)), ("rmsnorm", d, dt)
        buf = torch.empty(4 * d + 2, dtype=dt, device="cuda")
        buf[2:] = x[:4].reshape(-1)
        xu = buf[2:].view(4, d)
        assert xu.data_ptr() % 16, "the offset input is 16-byte aligned"
        assert torch.equal(rn.rmsnorm(xu, sc), four), ("rmsnorm offset", d,
                                                       dt)
        widths.append(f"{d} {'bf16' if dt == bf16 else 'fp32'}"
                      f"{' (bf16 scale)' if sdt == bf16 else ''}")
    torch.cuda.synchronize()
    print(f"bitwise: rmsnorm rows of an M = 4 launch == their M = 1 "
          f"launches, rows 60-63 of an M = 128 launch == their M = 4 "
          f"launch, an input at a 2-element offset == its aligned copy, at "
          f"d = {widths}", flush=True)


def check_flash_padding(torch, randn, hkv: int, dqk: int, hq: int = 0,
                        dv: int = 128):
    """A row of flash attention does not depend on the rows after it: the
    first t rows of a prompt right-padded to the next multiple of 16 (the
    engine's prefill buckets) equal the unpadded prompt's, bitwise, at t =
    20 and 100 (q [1, hq, t, dqk], values of dv; hq defaults to 32 at dqk
    128, else 16)."""
    from repro_torch.kernels.flash_attention import ops as fa

    hq = hq or (32 if dqk == 128 else 16)
    for t in (20, 100):
        tp = -(-t // 16) * 16
        q, k, v = randn(1, hq, tp, dqk), randn(1, hkv, tp, dqk), \
            randn(1, hkv, tp, dv)
        padded = fa.attention(q, k, v, causal=True)
        exact = fa.attention(q[:, :, :t].contiguous(),
                             k[:, :, :t].contiguous(),
                             v[:, :, :t].contiguous(), causal=True)
        assert torch.equal(padded[:, :, :t], exact), \
            f"flash ({dqk}, {dv}): rows of a prompt of {t} moved when " \
            f"padded to {tp}"
    torch.cuda.synchronize()
    print(f"bitwise: flash attention ({dqk}, {dv}) rows 0..t-1 of a prompt "
          f"padded to the next multiple of 16 == the unpadded prompt's "
          f"(t = 20, 100)", flush=True)


def check_int8(torch, compare, randn):
    """Phase 2 for the int8 serving path at yi-9b's GEMM shapes, on
    weights quantized by ``quantize_leaf``: the W8A8 kernel ``gemm_int8``
    (activations quantized per row inside the kernel, bit for bit as
    ``quantize_int8``) against its plain version, bitwise for none / relu
    and to one bf16 ulp for silu (the kernel's expf); and the int8-weight
    instance of ``gemm`` (weight-only) against the plain gemm on the same WeightQ (summation order: the gemm
    tolerance) and bitwise against the bf16 kernel on ``dequantize(w)``.
    At the decode shapes (M = 4), one prefill shape (M = 128) and a ragged
    shape with a bias (the element-wise load path). Bitwise: row b of a B
    = 4 launch of either == its B = 1 launch, and the plain
    ``quantize_int8`` on the card == on the CPU at every shape."""
    import torch.nn.functional as F

    from repro_torch.kernels.gemm import ops as gm
    from repro_torch.kernels.gemm.ref import (gemm_ref, gemm_w8a8_ref,
                                              quantize_int8)
    from repro_torch.serve.quantize import dequantize, quantize_leaf

    def bf16_ulps(a, b):
        """The largest distance in bf16 ulps between two bf16 tensors
        (their bit patterns as ordered integers)."""
        def ordered(t):
            i = t.view(torch.int16).int()
            return i.where(i >= 0, -32768 - i)
        return int((ordered(a) - ordered(b)).abs().max())

    def int_mm_lib(x, wq, act):
        """torch._int_mm and the epilogue in PyTorch: the library's W8A8
        GEMM on the same inputs (activations quantized by
        ``quantize_int8``). _int_mm takes at least INT_MM_MIN_ROWS rows:
        fewer are padded with zero rows (timed at that M)."""
        def run():
            xq, xs = quantize_int8(x)
            pad = INT_MM_MIN_ROWS - xq.shape[0]
            if pad > 0:
                xq = F.pad(xq, (0, 0, 0, pad))
            acc = torch._int_mm(xq, wq.q)[:x.shape[0]]
            out = acc.float() * xs * wq.scale.reshape(1, -1)
            return (F.silu(out) if act == "silu" else out).to(x.dtype)
        return run

    shapes = [(4, k, n, act, False) for k, n, act in (
        (4096, 4096, "none"), (4096, 512, "none"), (4096, 11008, "silu"),
        (11008, 4096, "none"), (4096, 64000, "none"))]
    shapes += [(128, 4096, 11008, "silu", False), (5, 1000, 300, "relu", True)]
    for m, k, n, act, with_bias in shapes:
        x = randn(m, k)
        w = quantize_leaf(randn(k, n, scale=k ** -0.5))
        deq = dequantize(w, torch.bfloat16)
        bias = randn(n, dtype=torch.float32) if with_bias else None
        shape = f"M={m} K={k} N={n} {act}{' bias' if with_bias else ''}"
        exact = act in ("none", "relu")
        rep = (m == 4 and k == 4096 and n == 4096)
        # the plain quantizer, to which the kernel's prologue is held, gives
        # the CPU's bits on the card (the CPU's are JAX's, tests/)
        for on_card, on_cpu in zip(quantize_int8(x), quantize_int8(x.cpu())):
            assert torch.equal(on_card.cpu(), on_cpu), (
                "quantize_int8 card != CPU", shape)
        got = gm.gemm_int8(x, w, bias, act)
        assert bf16_ulps(got, gemm_w8a8_ref(x, w, bias, act)) <= (
            0 if exact else 1), ("gemm_int8", shape)
        compare("gemm_int8", shape,
                lambda x=x, w=w, b=bias, a=act: gm.gemm_int8(x, w, b, a),
                lambda x=x, w=w, b=bias, a=act: gemm_w8a8_ref(x, w, b, a),
                None if with_bias else int_mm_lib(x, w, act),
                2 * m * k + k * n + 4 * n + 2 * m * n
                + (4 * n if with_bias else 0), 2 * m * k * n, "int8",
                0.0 if exact else 2.0 ** -7, 0.0, representative=rep,
                plan=gm.int8_plan(n, k))
        assert torch.equal(gm.gemm(x, w, bias, act),
                           gm.gemm(x, deq, bias, act)), ("gemm_wq", shape)
        compare("gemm_wq", shape,
                lambda x=x, w=w, b=bias, a=act: gm.gemm(x, w, b, a),
                lambda x=x, w=w, b=bias, a=act: gemm_ref(x, w, b, a),
                (lambda x=x, d=deq: torch.matmul(x, d))
                if act == "none" and not with_bias else None,
                2 * m * k + k * n + 4 * n + 2 * m * n
                + (4 * n if with_bias else 0), 2 * m * k * n, "bfloat16",
                1e-2, 1e-2, representative=rep)
    print(f"library: gemm_int8's is torch._int_mm + the epilogue in "
          f"PyTorch, at M = {INT_MM_MIN_ROWS} for M < {INT_MM_MIN_ROWS} "
          f"(zero rows padded: _int_mm takes no fewer); gemm_wq's "
          f"torch.matmul on the dequantized bf16 weight", flush=True)

    # row independence, bitwise: row i of the B = 4 launch == B = 1 launch
    x, w = randn(4, 4096), quantize_leaf(randn(4096, 11008,
                                               scale=4096 ** -0.5))
    full8, fullq = gm.gemm_int8(x, w, None, "silu"), gm.gemm(x, w, None,
                                                             "silu")
    for i in range(4):
        one = slice(i, i + 1)
        assert torch.equal(full8[one], gm.gemm_int8(x[one], w, None, "silu")
                           ), ("gemm_int8", i)
        assert torch.equal(fullq[one], gm.gemm(x[one], w, None, "silu")), \
            ("gemm_wq", i)
    torch.cuda.synchronize()

    # the host's cost of one call at M = 4 (4096 x 4096; the fp32 router
    # 2048 -> 64, K split; xLSTM's head-major bf16 q/k/v): the time to
    # enqueue 100 calls (no synchronize among them), by the host clock;
    # the median of 5 such runs (the host is shared: single runs spread)
    wb = randn(4096, 4096, scale=4096 ** -0.5)
    wq = quantize_leaf(wb)
    xr = randn(4, 2048, dtype=torch.float32)
    wr = randn(2048, 64, dtype=torch.float32, scale=2048 ** -0.5)
    xh = randn(4, 4, 512, dtype=torch.float32)
    wh = randn(4, 512, 512, scale=512 ** -0.5)
    enqueue = {}
    for name, fn in (("gemm bf16", lambda: gm.gemm(x, wb)),
                     ("gemm int8-weight", lambda: gm.gemm(x, wq)),
                     ("gemm_int8", lambda: gm.gemm_int8(x, wq)),
                     ("gemm fp32 router", lambda: gm.gemm(xr, wr)),
                     ("gemm_heads head-major", lambda: gm.gemm_heads(
                         xh, wh, head_major=True))):
        fn()
        runs = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(100):
                fn()
            runs.append((time.perf_counter() - t0) * 1e4)
        enqueue[name] = round(sorted(runs)[2], 1)
        torch.cuda.synchronize()
    print(f"host us a call (enqueue, M = 4, median of 5 x 100 calls): "
          f"{enqueue}", flush=True)
    print("bitwise: gemm_int8 == plain (none, relu; silu within 1 bf16 "
          "ulp); int8-weight gemm == the bf16 kernel on dequantize(w); rows "
          "of a B = 4 launch of either == their B = 1 launches", flush=True)


def check_gemm_rows(torch, randn):
    """Phase 2: the two GEMM kernels of ``csrc/gemm.cu`` reduce a row in an
    order fixed by the shape of w alone. Bitwise, row i of a launch of M =
    4, 16, 20 and 128 rows equals its M = 1 launch, for the bf16 gemm
    (4096 -> 4096, 4096 -> 512), the int8-weight gemm, the fp32 gemm (the
    routers 2048 -> 64 and 4096 -> 16, xLSTM's ``w_if`` 2048 -> 8) and
    ``gemm_heads`` in its three layouts (bf16 and fp32 weights). Then the
    registers, shared memory and spills ptxas reported for each kernel
    instance of the source. The same for ``gemm_int8`` (4096 -> 11008
    silu, and the ragged 1000 -> 300 relu with a bias: the element-wise
    path), whose integer sums and per-row quantization make every row
    independent of the others."""
    from repro_torch.kernels.gemm import ops as gm
    from repro_torch.serve.quantize import quantize_leaf

    f32, bf16 = torch.float32, torch.bfloat16
    cases = []
    for k, n in ((4096, 4096), (4096, 512)):
        x, w = randn(128, k), randn(k, n, scale=k ** -0.5)
        cases.append((f"gemm bf16 {k}->{n}", x,
                      lambda x, w=w: gm.gemm(x, w)))
    x, w = randn(128, 4096), quantize_leaf(randn(4096, 4096,
                                                 scale=4096 ** -0.5))
    cases.append(("gemm int8-weight 4096->4096 silu", x,
                  lambda x, w=w: gm.gemm(x, w, None, "silu")))
    for k, n in ((2048, 64), (4096, 16), (2048, 8)):
        x, w = randn(128, k, dtype=f32), randn(k, n, dtype=f32,
                                               scale=k ** -0.5)
        cases.append((f"gemm fp32 {k}->{n}", x,
                      lambda x, w=w: gm.gemm(x, w)))
    # gemm_int8's inputs from a generator of their own, so that the later
    # phases draw the inputs they drew before these cases existed
    g8 = torch.Generator(device="cuda").manual_seed(8)

    def randn8(*shape, dtype=bf16, scale=1.0):
        return (torch.randn(*shape, generator=g8, device="cuda") * scale
                ).to(dtype)
    for k, n, act, with_bias in ((4096, 11008, "silu", False),
                                 (1000, 300, "relu", True)):
        x = randn8(128, k)
        w = quantize_leaf(randn8(k, n, scale=k ** -0.5))
        b = randn8(n, dtype=f32) if with_bias else None
        cases.append((f"gemm_int8 {k}->{n} {act}", x,
                      lambda x, w=w, b=b, a=act: gm.gemm_int8(x, w, b, a)))
    for name, xs, ws, wdt, kw in (
            ("gemm_heads transposed [512,16,128]", (16, 128), (512, 16, 128),
             bf16, dict(transpose_w=True)),
            ("gemm_heads [512,16,128]", (16, 512), (512, 16, 128), bf16, {}),
            ("gemm_heads head-major [4,512,512]", (4, 512), (4, 512, 512),
             bf16, dict(head_major=True)),
            ("gemm_heads head-major [4,256,1024] fp32", (4, 256),
             (4, 256, 1024), f32, dict(head_major=True))):
        x = randn(128, *xs, dtype=f32)
        w = randn(*ws, dtype=wdt, scale=xs[1] ** -0.5)
        cases.append((name, x, lambda x, w=w, kw=kw: gm.gemm_heads(x, w,
                                                                   **kw)))
    for name, x, fn in cases:
        solo = [fn(x[i:i + 1].contiguous()) for i in range(128)]
        for m in (4, 16, 20, 128):
            full = fn(x[:m].contiguous())
            for i in range(m):
                assert torch.equal(full[i:i + 1], solo[i]), (name, m, i)
    torch.cuda.synchronize()
    print(f"bitwise: row i of a launch of M = 4, 16, 20, 128 == its M = 1 "
          f"launch for {[name for name, _, _ in cases]}", flush=True)
    for stem in ("gemm", "gemm_int8", "moe_decode", "mlstm_decode",
                 "rmsnorm"):
        for line in ptxas_usage(stem):
            print(line, flush=True)


def ptxas_usage(stem: str):
    """'ptxas <kernel>: <registers, shared memory, spills>' for each kernel
    instance of csrc/<stem>.cu, from its build log (``-Xptxas -v``)."""
    from repro_torch.kernels._build import BUILD_DIR
    log = BUILD_DIR / f"{stem}.log"
    if not log.exists():
        return [f"ptxas {stem}: no build log (library built before this "
                f"run)"]
    out, name = {}, None
    for raw in log.read_text().splitlines():
        if "Compiling entry function" in raw:
            name = raw.split("'")[1]
        elif name and ("Used" in raw or "spill" in raw):
            out.setdefault(name, []).append(raw.split(" : ")[-1].strip())
    names = list(out)
    filt = shutil.which("c++filt") or shutil.which("cu++filt")
    if filt:
        names = subprocess.run([filt], input="\n".join(out), check=True,
                               capture_output=True,
                               text=True).stdout.splitlines()
    return [f"ptxas {pretty.split('(')[0]}: {'; '.join(what)}"
            for pretty, what in zip(names, out.values())]


def check_paged_and_verify(torch, compare, randn, gen, hq=32, hkv=4, d=128,
                           dtype=None, suffix=""):
    """Phase 2 for the paged and verify kernels, at the serving path's
    shapes: by default yi-9b's, q [4, 32, 128] / [4, 32, 4, 128], pools
    [25, 4, 16, 128] bf16 behind a shuffled page table (extent 10 pages =
    the contiguous engine's 160 positions), NaN in the page no sequence
    owns, ragged cache_pos; other heads (``hq`` over ``hkv`` of ``d``) and
    dtypes are named by ``suffix`` (musicgen's: 24 over 24 of 64, bf16 and
    fp32). Beside the tolerance checks, the identities the serving path's
    token equalities rest on are asserted bitwise. The bf16 rows are the
    kernels' representative rows."""
    import torch.nn.functional as F

    from repro_torch.kernels.attn_decode import ops as ad
    from repro_torch.kernels.paged_attention import ops as pa
    from repro_torch.kernels.paged_attention.ref import (gather_pages,
                                                         paged_attention_ref)
    from repro_torch.kernels.verify_decode import ops as vd
    from repro_torch.kernels.verify_decode.ref import (
        verify_decode_paged_ref, verify_decode_ref)

    dtype = dtype or torch.bfloat16
    bf = dtype == torch.bfloat16
    dname, esz = ("bfloat16", 2) if bf else ("float32", 4)
    tol = 1e-2 if bf else 1e-4
    b, ps, n_pool, np_, k1 = 4, 16, 25, 10, 4
    cps = (19, 75, 100, 140)
    cp = torch.tensor(cps, dtype=torch.int32, device="cuda")
    need = [(c + k1 - 1) // ps + 1 for c in cps]          # 23 of 24 pages
    perm = (torch.randperm(n_pool - 1, generator=gen, device="cuda") + 1
            ).tolist()
    table = torch.full((b, np_), -1, dtype=torch.int32)
    at = 0
    for i, n in enumerate(need):
        table[i, :n] = torch.tensor(perm[at:at + n])
        at += n
    table = table.cuda()
    kp, vp = randn(n_pool, hkv, ps, d, dtype=dtype), \
        randn(n_pool, hkv, ps, d, dtype=dtype)
    for pid in perm[at:]:          # pages no sequence owns: never read
        kp[pid] = vp[pid] = float("nan")
    q = randn(b, hq, d, dtype=dtype)
    # the same KV as a contiguous cache (-1 entries gather the finite
    # scratch page 0; no kernel reads them)
    kc, vc = gather_pages(kp, table), gather_pages(vp, table)
    n_valid = sum(c + 1 for c in cps)
    tbl = 4 * sum(need)
    pools = f"pools[{n_pool},{hkv},{ps},{d}]"
    dt = "" if bf else " fp32"

    # one token: the plain version rounds the softmax weights to bf16, the
    # kernel keeps them fp32 (as attn_decode)
    compare(f"attn_decode_paged{suffix}", f"q[4,{hq},{d}] {pools} ragged{dt}",
            lambda: pa.attn_decode_paged(q, kp, vp, table, cp),
            lambda: paged_attention_ref(q, kp, vp, table, cp), None,
            esz * q.numel() + 2 * esz * hkv * d * n_valid + 4 * b * hq * d
            + 4 * b + tbl, 4 * hq * d * n_valid, dname, tol, tol,
            representative=bf, plan=ad.decode_plan(b, hq, hkv, d=d))
    # verify at K1 = 2 and 4 query tokens (spec k = 1, 3; K1 = 4 is the
    # representative row)
    qvs = {kk: randn(b, hq, kk, d, dtype=dtype) for kk in (2, k1)}
    for kk, qv in qvs.items():
        n_read = sum(c + kk for c in cps)      # positions < cp + K1
        pairs = sum(c + 1 + i for c in cps for i in range(kk))
        staircase = (torch.arange(np_ * ps, device="cuda")[None, None, :]
                     <= (cp[:, None] + torch.arange(kk, device="cuda")
                         )[:, :, None])[:, None]            # [B, 1, K1, S]
        compare(f"verify_decode{suffix}",
                f"q[4,{hq},{kk},{d}] kv[4,{hkv},160,{d}] ragged{dt}",
                lambda qv=qv: vd.verify_decode(qv, kc, vc, cp),
                lambda qv=qv: verify_decode_ref(qv, kc, vc, cp),
                lambda qv=qv, m=staircase: F.scaled_dot_product_attention(
                    qv, kc, vc, attn_mask=m, enable_gqa=True),
                esz * qv.numel() + 2 * esz * hkv * d * n_read
                + 4 * qv.numel() + 4 * b, 4 * hq * d * pairs, dname, tol, tol,
                representative=bf and kk == k1,
                plan=ad.decode_plan(b, hq, hkv, kk, d))
        compare(f"verify_decode_paged{suffix}",
                f"q[4,{hq},{kk},{d}] {pools} ragged{dt}",
                lambda qv=qv: vd.verify_decode_paged(qv, kp, vp, table, cp),
                lambda qv=qv: verify_decode_paged_ref(qv, kp, vp, table, cp),
                None, esz * qv.numel() + 2 * esz * hkv * d * n_read
                + 4 * qv.numel() + 4 * b + tbl, 4 * hq * d * pairs,
                dname, tol, tol, representative=bf and kk == k1,
                plan=ad.decode_plan(b, hq, hkv, kk, d))
    print("library: none for attn_decode_paged and verify_decode_paged "
          "(no single PyTorch call reads KV through a page table)",
          flush=True)

    # (a) paged == contiguous, (b) verify row i == attn_decode at cp + i,
    # (c) paged verify row i == attn_decode_paged at cp + i: bitwise
    qv = qvs[k1]
    one = pa.attn_decode_paged(q, kp, vp, table, cp)
    assert torch.equal(one, ad.attn_decode(q, kc, vc, cp)), "(a) paged"
    check_gqa_rows(torch, q, kc, vc, kp, vp, table, cp)
    ver = vd.verify_decode(qv, kc, vc, cp)
    verp = vd.verify_decode_paged(qv, kp, vp, table, cp)
    for i in range(k1):
        qi = qv[:, :, i].contiguous()
        assert torch.equal(ver[:, :, i], ad.attn_decode(qi, kc, vc, cp + i)
                           ), f"(b) verify row {i}"
        assert torch.equal(verp[:, :, i], pa.attn_decode_paged(
            qi, kp, vp, table, cp + i)), f"(c) paged verify row {i}"
    # a row never multiplies in the V row of a position it masks: with NaN
    # at positions cp + 1 .. cp + K1 - 1, row 0 keeps its bits
    kn, vn = kp.clone(), vp.clone()
    for bi, c in enumerate(cps):
        for p in range(c + 1, c + k1):
            pid = int(table[bi, p // ps])
            kn[pid, :, p % ps] = vn[pid, :, p % ps] = float("nan")
    row0 = vd.verify_decode_paged(qv, kn, vn, table, cp)[:, :, 0]
    assert torch.equal(row0, pa.attn_decode_paged(
        qv[:, :, 0].contiguous(), kp, vp, table, cp)), "masked NaN leaked"
    torch.cuda.synchronize()
    print(f"bitwise (D {d}, group of {hq // hkv}, {dname}): "
          f"attn_decode_paged == attn_decode; rows of a B = 4 launch of "
          f"each == their B = 1 launches; verify_decode row i == "
          f"attn_decode at cache_pos + i; verify_decode_paged row i == "
          f"attn_decode_paged at cache_pos + i (i < 4); NaN past a row's "
          f"window leaves it unchanged", flush=True)


def check_gqa_rows(torch, q, kc, vc, kp, vp, table, cp):
    """Row b of a B = 4 launch of attn_decode (contiguous KV kc / vc) and of
    attn_decode_paged (pools kp / vp behind ``table``) == its B = 1 launch,
    bitwise: the kernel's plan splits a sequence's query rows over blocks,
    and a row's result must not depend on the batch."""
    from repro_torch.kernels.attn_decode import ops as ad
    from repro_torch.kernels.paged_attention import ops as pa

    full = ad.attn_decode(q, kc, vc, cp)
    full_paged = pa.attn_decode_paged(q, kp, vp, table, cp)
    for i in range(q.shape[0]):
        one = slice(i, i + 1)
        assert torch.equal(full[one], ad.attn_decode(
            q[one], kc[one], vc[one], cp[one])), ("attn_decode row", i)
        assert torch.equal(full_paged[one], pa.attn_decode_paged(
            q[one], kp, vp, table[one], cp[one])), ("attn_decode_paged row", i)


def check_mla_moe(torch, compare, randn, gen):
    """Phase 2 for deepseek-v2-lite-16b's kernels at its serving shapes (B
    = 4 slots, 16 heads, latent 512, rotary 64, 64 experts of 2048 x 1408,
    top-6): flash attention at (Dqk, Dv) = (192, 128), the precise (MLA)
    decode kernel, the per-head absorbed products and dropless MoE decode.
    Beside the tolerance checks, each decode kernel's row b of a B = 4
    launch must equal its B = 1 launch on that row, bitwise (the serve
    engine's token equality with ``generate`` rests on it)."""
    import torch.nn.functional as F

    from repro_torch.kernels.attn_decode import ops as ad
    from repro_torch.kernels.attn_decode.ref import attn_decode_ref
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.gemm import ops as gm
    from repro_torch.kernels.gemm.ref import gemm_heads_ref, gemm_ref
    from repro_torch.kernels.moe_decode import ops as md
    from repro_torch.kernels.moe_decode.ref import moe_decode_ref

    f32 = torch.float32
    b, h, r, rd, dn, dv, s = 4, 16, 512, 64, 128, 128, 160

    # deepseek's decode GEMMs at M = 4 slots (per step: wq, w_dkv, w_kr,
    # wo and the shared experts in 27 / 26 layers, the dense layer's MLP,
    # the unembedding twice with the exit head): bf16, one bf16 ulp; the
    # fp32 router 2048 -> 64 (26 a step), summation order only
    for k, n, act in ((2048, 3072, "none"), (2048, 512, "none"),
                      (2048, 64, "none"), (2048, 2048, "none"),
                      (2048, 2816, "silu"), (2816, 2048, "none"),
                      (2048, 10944, "silu"), (10944, 2048, "none"),
                      (2048, 102400, "none")):
        x, w = randn(b, k), randn(k, n, scale=k ** -0.5)
        lib = (lambda x=x, w=w: torch.matmul(x, w)) if act == "none" \
            else None
        compare("gemm", f"M=4 K={k} N={n} {act}",
                lambda x=x, w=w, a=act: gm.gemm(x, w, activation=a),
                lambda x=x, w=w, a=act: gemm_ref(x, w, activation=a), lib,
                2 * (b * k + k * n + b * n), 2 * b * k * n, "bfloat16", 1e-2,
                1e-2)
    x, w = randn(b, 2048, dtype=f32), randn(2048, 64, dtype=f32,
                                             scale=2048 ** -0.5)
    compare("gemm", "M=4 K=2048 N=64 none fp32 (router)",
            lambda: gm.gemm(x, w), lambda: gemm_ref(x, w),
            lambda: torch.matmul(x, w), 4 * (b * 2048 + 2048 * 64 + b * 64),
            2 * b * 2048 * 64, "float32", 1e-4, 1e-4)

    # MLA prefill attention: q/k [B, 16, T, 192], v [B, 16, T, 128] at
    # a serve prompt of 100 tokens, check_prefill's 128 prompts x 100, and
    # T = 128 (the representative row)
    for bb, t in ((1, 100), (128, 100), (1, 128)):
        q, k_, v_ = randn(bb, h, t, dn + rd), randn(bb, h, t, dn + rd), \
            randn(bb, h, t, dv)
        pairs = t * (t + 1) // 2
        compare("attention_mla",
                f"q/k[{bb},16,{t},192] v[{bb},16,{t},128] causal",
                lambda q=q, k_=k_, v_=v_: fa.attention(q, k_, v_,
                                                       causal=True),
                lambda q=q, k_=k_, v_=v_: attention_ref(q, k_, v_,
                                                        causal=True),
                lambda q=q, k_=k_, v_=v_: F.scaled_dot_product_attention(
                    q, k_, v_, is_causal=True),
                2 * (2 * q.numel() + v_.numel() + bb * h * t * dv),
                2 * bb * h * pairs * (dn + rd + dv), "bfloat16", 1e-2, 1e-2,
                representative=(bb, t) == (1, 128))
    del q, k_, v_
    check_flash_padding(torch, randn, h, dn + rd)

    # absorbed products: fp32 on both sides, summation order only
    qn = randn(b, h, dn, dtype=f32)
    w_uk = randn(r, h, dn, scale=r ** -0.5)
    pooled = randn(b, h, r, dtype=f32)
    w_uv = randn(r, h, dv, scale=r ** -0.5)
    compare("gemm_heads", "x[4,16,128] w[512,16,128] -> [4,16,512]",
            lambda: gm.gemm_heads(qn, w_uk, True),
            lambda: gemm_heads_ref(qn, w_uk, True),
            lambda: torch.einsum("bhd,lhd->bhl", qn, w_uk.float()),
            4 * qn.numel() + 2 * w_uk.numel() + 4 * b * h * r,
            2 * b * h * dn * r, "float32", 1e-4, 1e-4, representative=True)
    compare("gemm_heads", "x[4,16,512] w[512,16,128] -> [4,16,128]",
            lambda: gm.gemm_heads(pooled, w_uv, False),
            lambda: gemm_heads_ref(pooled, w_uv, False),
            lambda: torch.einsum("bhl,lhd->bhd", pooled, w_uv.float()),
            4 * pooled.numel() + 2 * w_uv.numel() + 4 * b * h * dv,
            2 * b * h * r * dv, "float32", 1e-4, 1e-4)

    # precise decode: fp32 logits and softmax on both sides; a latent of
    # unit scale (it leaves an RMSNorm) and queries giving O(1) logits
    cps = (19, 75, 130, 159)
    cp = torch.tensor(cps, dtype=torch.int32, device="cuda")
    n_valid = sum(c + 1 for c in cps)
    qa, q2 = randn(b, h, r, dtype=f32, scale=0.5), randn(b, h, rd, dtype=f32)
    lat, kr = randn(b, 1, s, r), randn(b, 1, s, rd)
    scale = (dn + rd) ** -0.5
    mask = (torch.arange(s, device="cuda")[None, :] <= cp[:, None]
            )[:, None, None, :]
    qcat = torch.cat([qa, q2], -1)[:, :, None]           # [B, H, 1, 576]
    kcat = torch.cat([lat, kr], -1).float().expand(b, h, s, r + rd)
    latf = lat.float().expand(b, h, s, r)
    compare("attn_decode_mla", "q[4,16,512]+[4,16,64] latent[4,1,160,512]",
            lambda: ad.attn_decode(qa, lat, lat, cp, scale=scale, q2=q2,
                                   k2=kr, precise=True),
            lambda: attn_decode_ref(qa, lat, lat, cp, scale=scale, q2=q2,
                                    k2=kr, precise=True),
            lambda: F.scaled_dot_product_attention(
                qcat, kcat, latf, attn_mask=mask, scale=scale),
            4 * (qa.numel() + q2.numel()) + 2 * (r + rd) * n_valid
            + 4 * b * h * r + 4 * b, 2 * h * (2 * r + rd) * n_valid,
            "float32", 1e-4, 1e-4, representative=True,
            plan=ad.mla_plan(b, h, lat.dtype))

    # dropless MoE decode at B = 4 live slots, top-6 of 64 experts (the
    # serve path's usual step): routing from random router probabilities;
    # fp32 on both sides
    e_, k6, d, hh = 64, 6, 2048, 1408
    x = randn(b, d)
    wg = randn(e_, d, hh, scale=d ** -0.5)
    wu = randn(e_, d, hh, scale=d ** -0.5)
    wd = randn(e_, hh, d, scale=hh ** -0.5)
    probs = torch.softmax(randn(b, e_, dtype=f32), -1)
    gate, idx = torch.topk(probs, k6, dim=-1)
    gate = gate / gate.sum(-1, keepdim=True)
    idx = idx.to(torch.int32)
    live = gate != 0
    touched = int(torch.unique(idx[live]).numel())
    n_assign = int(live.sum())
    compare("moe_decode", f"x[4,2048] top-6 of 64 experts [2048,1408] "
            f"({touched} experts read)",
            lambda: md.moe_decode(x, idx, gate, wg, wu, wd),
            lambda: moe_decode_ref(x, idx, gate, wg, wu, wd), None,
            2 * 3 * touched * d * hh + 2 * x.numel() + 8 * b * k6
            + 4 * b * d, 6 * n_assign * d * hh, "bfloat16", 1e-4, 1e-4,
            representative=True, plan=md.moe_plan(d, hh))
    # repeated experts inside a row, a zero gate inside a live row, and a
    # dead slot (all gates zero, as the engine gives a free slot): its
    # experts are not read and its output row is zero
    idx_rep = idx.clone()
    idx_rep[0, 1] = idx_rep[0, 0]
    gate_rep = gate.clone()
    gate_rep[1, 2] = 0.0
    gate_rep[3] = 0.0
    got = md.moe_decode(x, idx_rep, gate_rep, wg, wu, wd)
    want = moe_decode_ref(x, idx_rep, gate_rep, wg, wu, wd)
    err = float((got - want).abs().max())
    assert err <= 1e-4 + 1e-4 * float(want.abs().max()), err
    assert not bool(got[3].any()), "a dead slot's output row is not zero"
    lib = md._lib()        # the wrapper's limits are the library's
    assert (lib.moe_decode_max_assignments(), lib.moe_decode_max_experts()
            ) == (md.MAX_ASSIGN, md.MAX_EXPERTS)
    print(f"kernel moe_decode repeated expert / zero gate / dead slot: "
          f"max_abs_err={err:.3e}; library: none (no single PyTorch call "
          f"routes tokens to experts)", flush=True)

    # row independence, bitwise: row i of the B = 4 launch == B = 1 launch
    outs = {"moe_decode": md.moe_decode(x, idx, gate, wg, wu, wd),
            "attn_decode_mla": ad.attn_decode(qa, lat, lat, cp, scale=scale,
                                              q2=q2, k2=kr, precise=True),
            "gemm_heads": gm.gemm_heads(qn, w_uk, True)}
    for i in range(b):
        one = slice(i, i + 1)
        solo = {"moe_decode": md.moe_decode(x[one], idx[one], gate[one], wg,
                                            wu, wd),
                "attn_decode_mla": ad.attn_decode(
                    qa[one], lat[one], lat[one], cp[one], scale=scale,
                    q2=q2[one], k2=kr[one], precise=True),
                "gemm_heads": gm.gemm_heads(qn[one], w_uk, True)}
        for name, full in outs.items():
            assert torch.equal(full[one], solo[name]), (name, i)
    # positions past a row's cache_pos never reach its output, even NaN
    lat_nan, kr_nan = lat.clone(), kr.clone()
    for i, c in enumerate(cps):
        lat_nan[i, 0, c + 1:] = float("nan")
        kr_nan[i, 0, c + 1:] = float("nan")
    assert torch.equal(outs["attn_decode_mla"], ad.attn_decode(
        qa, lat_nan, lat_nan, cp, scale=scale, q2=q2, k2=kr_nan,
        precise=True)), "masked NaN leaked into precise decode"
    torch.cuda.synchronize()
    print("bitwise: moe_decode, attn_decode (precise) and gemm_heads rows "
          "of a B = 4 launch == their B = 1 launches; NaN past cache_pos "
          "leaves precise decode unchanged", flush=True)


def check_paged_mla(torch, compare, randn, gen):
    """Phase 2 for the precise (MLA) paged decode kernel at deepseek's
    decode shapes: B = 4, 16 heads, latent 512 + rotary 64, cache_pos (19,
    75, 130, 159) of 160, pages of 16 from a pool in shuffled order whose
    scratch page 0 and one page no sequence owns hold NaN. Bitwise: (a)
    the paged kernel == the contiguous precise kernel on the same latent,
    at page sizes 16 and 32; (b) row b of a B = 4 launch == its B = 1
    launch; (c) NaN past cache_pos in a sequence's own pages never reaches
    the output (nor does the NaN of -1 pages, in every launch here)."""
    from repro_torch.kernels.attn_decode import ops as ad
    from repro_torch.kernels.paged_attention import ops as pa
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref

    f32 = torch.float32
    b, h, r, rd, s = 4, 16, 512, 64, 160
    cps = (19, 75, 130, 159)
    cp = torch.tensor(cps, dtype=torch.int32, device="cuda")
    n_valid = sum(c + 1 for c in cps)
    qa, q2 = randn(b, h, r, dtype=f32, scale=0.5), randn(b, h, rd, dtype=f32)
    lat, kr = randn(b, 1, s, r), randn(b, 1, s, rd)
    scale = (128 + rd) ** -0.5

    def pages(ps):
        """lat / kr scattered into NaN-filled pools behind a shuffled page
        table (-1 past each sequence's last page)."""
        need = [c // ps + 1 for c in cps]
        n_pool = sum(need) + 2               # + the scratch page + one unused
        perm = (torch.randperm(n_pool - 1, generator=gen, device="cuda") + 1
                ).tolist()
        table = torch.full((b, s // ps), -1, dtype=torch.int32)
        cpool = torch.full((n_pool, 1, ps, r), float("nan"),
                           dtype=lat.dtype, device="cuda")
        kpool = torch.full((n_pool, 1, ps, rd), float("nan"),
                           dtype=kr.dtype, device="cuda")
        at = 0
        for i, n in enumerate(need):
            ids = perm[at:at + n]
            at += n
            table[i, :n] = torch.tensor(ids)
            cpool[ids, 0] = lat[i, 0, :n * ps].reshape(n, ps, r)
            kpool[ids, 0] = kr[i, 0, :n * ps].reshape(n, ps, rd)
        return cpool, kpool, table.cuda(), sum(need)

    def paged(cpool, kpool, table, rows=slice(None)):
        return pa.attn_decode_paged(qa[rows], cpool, cpool, table[rows],
                                    cp[rows], scale=scale, q2=q2[rows],
                                    k2_pages=kpool, precise=True)

    cpool, kpool, table, n_pages = pages(16)
    compare("attn_decode_paged_mla",
            "q[4,16,512]+[4,16,64] pages[28,1,16,512]+[28,1,16,64]",
            lambda: paged(cpool, kpool, table),
            lambda: paged_attention_ref(qa, cpool, cpool, table, cp,
                                        scale=scale, q2=q2, k2_pages=kpool,
                                        precise=True), None,
            4 * (qa.numel() + q2.numel()) + 2 * (r + rd) * n_valid
            + 4 * b * h * r + 4 * b + 4 * n_pages,
            2 * h * (2 * r + rd) * n_valid, "float32", 1e-4, 1e-4,
            representative=True, plan=ad.mla_plan(b, h, lat.dtype))
    print("library: none for attn_decode_paged_mla (no single PyTorch call "
          "reads a latent through a page table)", flush=True)

    contiguous = ad.attn_decode(qa, lat, lat, cp, scale=scale, q2=q2, k2=kr,
                                precise=True)
    for ps in (16, 32):
        pools = pages(ps)[:3]
        full = paged(*pools)
        assert torch.equal(full, contiguous), f"(a) paged ps={ps}"
        for i in range(b):
            assert torch.equal(full[i:i + 1], paged(*pools, rows=slice(
                i, i + 1))), f"(b) row {i} ps={ps}"
    cnan, knan = cpool.clone(), kpool.clone()
    for i, c in enumerate(cps):
        for p in range(c + 1, (c // 16 + 1) * 16):   # own pages, past c
            pid = int(table[i, p // 16])
            cnan[pid, 0, p % 16] = float("nan")
            knan[pid, 0, p % 16] = float("nan")
    assert torch.equal(paged(cnan, knan, table), contiguous), "(c) NaN"
    torch.cuda.synchronize()
    print("bitwise: attn_decode_paged (precise) == attn_decode (precise) on "
          "the same latent at page sizes 16 and 32; rows of a B = 4 launch "
          "== their B = 1 launches; NaN on -1 pages, unowned pages and "
          "past cache_pos leaves it unchanged", flush=True)


def check_jamba(torch, compare, randn, gen):
    """Phase 2 for jamba-v0.1-52b's kernels at its serving shapes (B = 4
    slots, d_model 4096, Mamba d_inner 8192 and d_state 16, 32/8 heads of
    128, 16 experts of 4096 x 14336 top-2): the selective scan of one
    120-token prompt with and without h0, the Mamba decode step, dropless
    MoE decode at h = 14336, GQA attention at group 4 and the decode
    GEMMs. Bitwise: row b of a B = 4 launch of ssm_decode and moe_decode
    == its B = 1 launch, the decode step written in place (``out=h``) ==
    its separate output, and a scan of 57 then 63 tokens with the state
    carried == the scan of all 120."""
    import torch.nn.functional as F

    from repro_torch.kernels.attn_decode import ops as ad
    from repro_torch.kernels.attn_decode.ref import attn_decode_ref
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.gemm import ops as gm
    from repro_torch.kernels.gemm.ref import gemm_ref
    from repro_torch.kernels.moe_decode import ops as md
    from repro_torch.kernels.moe_decode.ref import moe_decode_ref
    from repro_torch.kernels.ssm_decode import ops as sd
    from repro_torch.kernels.ssm_decode.ref import ssm_decode_ref
    from repro_torch.kernels.ssm_scan import ops as ss
    from repro_torch.kernels.ssm_scan.ref import selective_scan_ref

    f32 = torch.float32
    b, d, din, n, t = 4, 4096, 8192, 16, 120

    # the decode GEMMs at M = 4 (per step: Mamba in/x/dt/out projections in
    # 14 layers, the dense MLPs in 8, attention in 2, the fp32 router in 8,
    # the unembedding twice with the exit head): bf16, one bf16 ulp
    for k, nn, act in ((4096, 16384, "none"), (8192, 288, "none"),
                       (256, 8192, "none"), (8192, 4096, "none"),
                       (4096, 14336, "silu"), (14336, 4096, "none"),
                       (4096, 1024, "none"), (4096, 65536, "none")):
        x, w = randn(b, k), randn(k, nn, scale=k ** -0.5)
        lib = (lambda x=x, w=w: torch.matmul(x, w)) if act == "none" \
            else None
        compare("gemm", f"M=4 K={k} N={nn} {act}",
                lambda x=x, w=w, a=act: gm.gemm(x, w, activation=a),
                lambda x=x, w=w, a=act: gemm_ref(x, w, activation=a), lib,
                2 * (b * k + k * nn + b * nn), 2 * b * k * nn, "bfloat16",
                1e-2, 1e-2)
    x, w = randn(b, d, dtype=f32), randn(d, 16, dtype=f32, scale=d ** -0.5)
    compare("gemm", "M=4 K=4096 N=16 none fp32 (router)",
            lambda: gm.gemm(x, w), lambda: gemm_ref(x, w),
            lambda: torch.matmul(x, w), 4 * (b * d + d * 16 + b * 16),
            2 * b * d * 16, "float32", 1e-4, 1e-4)

    # GQA at group 4 (32 query heads over 8 KV heads): prefill and decode
    q, k_, v_ = randn(1, 32, t, 128), randn(1, 8, t, 128), \
        randn(1, 8, t, 128)
    pairs = t * (t + 1) // 2
    compare("attention", f"q[1,32,{t},128] kv[1,8,{t},128] causal",
            lambda: fa.attention(q, k_, v_, causal=True),
            lambda: attention_ref(q, k_, v_, causal=True),
            lambda: F.scaled_dot_product_attention(q, k_, v_, is_causal=True,
                                                   enable_gqa=True),
            2 * (2 * q.numel() + 2 * k_.numel()), 4 * 32 * 128 * pairs,
            "bfloat16", 1e-2, 1e-2)
    s = 160
    q, kc, vc = randn(b, 32, 128), randn(b, 8, s, 128), randn(b, 8, s, 128)
    cp = torch.tensor([19, 75, 130, 159], dtype=torch.int32, device="cuda")
    n_valid = int((cp + 1).sum())
    mask = (torch.arange(s, device="cuda")[None, :] <= cp[:, None]
            )[:, None, None, :]
    compare("attn_decode", "q[4,32,128] kv[4,8,160,128] ragged",
            lambda: ad.attn_decode(q, kc, vc, cp),
            lambda: attn_decode_ref(q, kc, vc, cp),
            lambda: F.scaled_dot_product_attention(
                q[:, :, None], kc, vc, attn_mask=mask, enable_gqa=True),
            2 * q.numel() + 2 * 2 * 8 * 128 * n_valid + 4 * b * 32 * 128
            + 4 * b, 4 * 32 * 128 * n_valid, "bfloat16", 1e-2, 1e-2,
            plan=ad.decode_plan(b, 32, 8))
    # rows independent of the batch at group 4, contiguous and paged (the
    # same KV as pools of 16 behind a shuffled page table)
    ps = 16
    perm = torch.randperm(b * s // ps, generator=gen, device="cuda")
    table = perm.view(b, s // ps).to(torch.int32)

    def pool(c):
        out = torch.empty(b * s // ps, 8, ps, 128, dtype=c.dtype,
                          device="cuda")
        out[perm] = c.view(b, 8, s // ps, ps, 128).transpose(1, 2).reshape(
            b * s // ps, 8, ps, 128)
        return out
    check_gqa_rows(torch, q, kc, vc, pool(kc), pool(vc), table, cp)

    # selective scan: inputs at the mixer's scales (u the conv + silu
    # output, dt = softplus in [1e-3, 0.1], A the S4D-real -(1..16), B and
    # C the x_proj outputs, D = 1). y is bf16 (one bf16 ulp); the state is
    # fp32 (summation order and exp's last bit only)
    a = -torch.arange(1, n + 1, dtype=f32, device="cuda").repeat(din, 1)
    dsk = torch.ones(din, dtype=f32, device="cuda")
    u = F.silu(randn(1, t, din, dtype=f32)).to(torch.bfloat16)
    dt = (torch.rand(1, t, din, generator=gen, device="cuda") * 0.099
          + 1e-3).to(torch.bfloat16)
    bm, cm = randn(1, t, n), randn(1, t, n)
    h0 = randn(1, din, n, dtype=f32)
    # (the engine's prefill hands the scan its zeroed cache state as h0);
    # the served prompts are 20-120 tokens: T = 20 and 57 end in a short
    # chunk
    for name, tt, h_ in (("ssm_scan", 20, h0), ("ssm_scan", 57, h0),
                         ("ssm_scan_no_h0", t, None), ("ssm_scan", t, h0)):
        nbytes = (3 * 2 * tt * din + 4 * din * n + 2 * 2 * tt * n + 4 * din
                  + 4 * din * n * (2 if h_ is not None else 1))
        ut, dtt, bt, ct = (z[:, :tt] for z in (u, dt, bm, cm))
        compare(name, f"u[1,{tt},{din}] N={n}"
                f"{' h0' if h_ is not None else ''}",
                lambda h_=h_, z=(ut, dtt, bt, ct): ss.ssm_scan(
                    z[0], z[1], a, z[2], z[3], dsk, h_),
                lambda h_=h_, z=(ut, dtt, bt, ct): selective_scan_ref(
                    z[0], z[1], a, z[2], z[3], dsk, h_),
                None, nbytes, 9 * tt * din * n, "float32", (1e-2, 1e-4),
                (1e-2, 1e-4),
                representative=(tt, h_ is not None) == (t, True))
    t1 = 57
    whole = ss.ssm_scan(u, dt, a, bm, cm, dsk, h0)
    y1, h1 = ss.ssm_scan(u[:, :t1].contiguous(), dt[:, :t1].contiguous(), a,
                         bm[:, :t1].contiguous(), cm[:, :t1].contiguous(),
                         dsk, h0)
    y2, h2 = ss.ssm_scan(u[:, t1:].contiguous(), dt[:, t1:].contiguous(), a,
                         bm[:, t1:].contiguous(), cm[:, t1:].contiguous(),
                         dsk, h1)
    assert torch.equal(torch.cat([y1, y2], 1), whole[0]), "split scan y"
    assert torch.equal(h2, whole[1]), "split scan state"

    # the Mamba decode step, fp32 throughout
    xs, g = randn(b, din, dtype=f32), torch.rand(
        b, din, generator=gen, device="cuda") * 0.099 + 1e-3
    bd_, cd_ = randn(b, n, dtype=f32), randn(b, n, dtype=f32)
    h = randn(b, din, n, dtype=f32)
    for bb in (1, b):       # one slot, then the four of the serve runs
        one = slice(0, bb)
        compare("ssm_decode", f"x[{bb},{din}] h[{bb},{din},{n}] fp32",
                lambda one=one: sd.ssm_decode(xs[one], g[one], a, bd_[one],
                                              cd_[one], dsk, h[one]),
                lambda one=one: ssm_decode_ref(xs[one], g[one], a, bd_[one],
                                               cd_[one], dsk, h[one]), None,
                4 * (2 * bb * din + din * n + 2 * bb * n + din + bb * din * n)
                + 4 * (bb * din + bb * din * n), 8 * bb * din * n, "float32",
                (1e-4, 1e-4), (1e-4, 1e-4), representative=bb == b)
    # the step as the mixer calls it, writing the new state over the old:
    # bitwise the separate output
    sep = sd.ssm_decode(xs, g, a, bd_, cd_, dsk, h)
    h_in = h.clone()
    y_in, h_ret = sd.ssm_decode(xs, g, a, bd_, cd_, dsk, h_in, out=h_in)
    assert h_ret is h_in, "ssm_decode out"
    assert torch.equal(y_in, sep[0]) and torch.equal(h_in, sep[1]), \
        "ssm_decode in place"
    print("library: none for ssm_scan and ssm_decode (no single PyTorch "
          "call runs the selective-SSM recurrence)", flush=True)

    # dropless MoE decode at h = 14336 (the down pass stages the hidden
    # rows in chunks): 4 live slots, top-2 of 16; fp32 on both sides
    e_, k2, hh = 16, 2, 14336
    x = randn(b, d)
    wg = randn(e_, d, hh, scale=d ** -0.5)
    wu = randn(e_, d, hh, scale=d ** -0.5)
    wd = randn(e_, hh, d, scale=hh ** -0.5)
    probs = torch.softmax(randn(b, e_, dtype=f32), -1)
    gate, idx = torch.topk(probs, k2, dim=-1)
    gate = gate / gate.sum(-1, keepdim=True)
    idx = idx.to(torch.int32)
    touched = int(torch.unique(idx).numel())
    compare("moe_decode_jamba", f"x[4,4096] top-2 of 16 experts "
            f"[4096,14336] ({touched} experts read)",
            lambda: md.moe_decode(x, idx, gate, wg, wu, wd),
            lambda: moe_decode_ref(x, idx, gate, wg, wu, wd), None,
            2 * 3 * touched * d * hh + 2 * x.numel() + 8 * b * k2
            + 4 * b * d, 6 * b * k2 * d * hh, "bfloat16", 1e-4, 1e-4,
            representative=True, plan=md.moe_plan(d, hh))

    # row independence, bitwise: row i of the B = 4 launch == B = 1 launch
    full = {"ssm_decode": sd.ssm_decode(xs, g, a, bd_, cd_, dsk, h),
            "moe_decode": md.moe_decode(x, idx, gate, wg, wu, wd)}
    for i in range(b):
        one = slice(i, i + 1)
        solo = {"ssm_decode": sd.ssm_decode(xs[one], g[one], a, bd_[one],
                                            cd_[one], dsk, h[one]),
                "moe_decode": md.moe_decode(x[one], idx[one], gate[one], wg,
                                            wu, wd)}
        assert torch.equal(full["ssm_decode"][0][one], solo["ssm_decode"][0]
                           ), ("ssm_decode y", i)
        assert torch.equal(full["ssm_decode"][1][one], solo["ssm_decode"][1]
                           ), ("ssm_decode h", i)
        assert torch.equal(full["moe_decode"][one], solo["moe_decode"]), \
            ("moe_decode", i)
    del wg, wu, wd
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    print("bitwise: ssm_decode, moe_decode (h = 14336), attn_decode and "
          "attn_decode_paged (group of 4) rows of a B = 4 launch == their "
          "B = 1 launches; ssm_decode in place == its separate output; "
          "ssm_scan of 57 then 63 tokens with the state carried == the "
          "scan of 120", flush=True)


def check_xlstm(torch, compare, randn, gen):
    """Phase 2 for xlstm-350m's kernels at its serving shapes (B = 4
    slots, d_model 1024, 4 heads; mLSTM d_in 2048, head dim 512; sLSTM
    head dim 256, gated FFN of 1365): the mLSTM decode step, the decode
    GEMMs (the FFN's K = 1365 and N = 2730 take the element-wise load
    path) and the head-major ``gemm_heads`` of the block-diagonal q/k/v
    (bf16) and sLSTM recurrent (fp32) weights. Bitwise: row b of a B = 4
    launch of mlstm_decode and head-major gemm_heads == its B = 1 launch,
    and the step writing C' over C (``out=c``) == its separate output."""
    from repro_torch.kernels.gemm import ops as gm
    from repro_torch.kernels.gemm.ref import gemm_heads_ref, gemm_ref
    from repro_torch.kernels.ssm_decode import ops as sd
    from repro_torch.kernels.ssm_decode.ref import ssm_decode_ref

    f32 = torch.float32
    b, h, dh, d = 4, 4, 512, 1024

    # the decode GEMMs at M = 4 (per step: up_proj, down_proj and the fp32
    # gate projection in 21 layers; wx, w_ff1, w_ff2 in 3; the unembedding
    # twice with the exit head): bf16, one bf16 ulp; fp32 summation order
    for k, n in ((1024, 4096), (2048, 1024), (1024, 2730), (1365, 1024),
                 (1024, 50304)):
        x, w = randn(b, k), randn(k, n, scale=k ** -0.5)
        compare("gemm", f"M=4 K={k} N={n} none",
                lambda x=x, w=w: gm.gemm(x, w),
                lambda x=x, w=w: gemm_ref(x, w),
                lambda x=x, w=w: torch.matmul(x, w),
                2 * (b * k + k * n + b * n), 2 * b * k * n, "bfloat16", 1e-2,
                1e-2)
    x, w = randn(b, 2048, dtype=f32), randn(2048, 8, dtype=f32,
                                             scale=2048 ** -0.5)
    compare("gemm", "M=4 K=2048 N=8 none fp32 (w_if)",
            lambda: gm.gemm(x, w), lambda: gemm_ref(x, w),
            lambda: torch.matmul(x, w), 4 * (b * 2048 + 2048 * 8 + b * 8),
            2 * b * 2048 * 8, "float32", 1e-4, 1e-4)

    # head-major per-head products: fp32 on both sides, summation order
    heads = {}
    for name, kk, nn, wdt in (("gemm_heads_qkv", dh, dh, torch.bfloat16),
                              ("gemm_heads_wr", 256, 1024, f32)):
        xh = randn(b, h, kk, dtype=f32)
        wh = randn(h, kk, nn, dtype=wdt, scale=kk ** -0.5)
        heads[name] = (xh, wh)
        compare("gemm_heads", f"x[{b},{h},{kk}] w[{h},{kk},{nn}] "
                f"{'bf16' if wdt != f32 else 'fp32'} head-major",
                lambda xh=xh, wh=wh: gm.gemm_heads(xh, wh, head_major=True),
                lambda xh=xh, wh=wh: gemm_heads_ref(xh, wh, head_major=True),
                lambda xh=xh, wh=wh: torch.einsum("mhk,hkn->mhn", xh,
                                                  wh.float()),
                4 * xh.numel() + wh.element_size() * wh.numel()
                + 4 * b * h * nn, 2 * b * h * kk * nn, "float32", 1e-4, 1e-4)

    # the mLSTM step at the cell's scales (k scaled by dh^-1/2 as the
    # mixer scales it, a forget gate near sigmoid(3)); m spread over
    # [-4, 2] so that some heads divide by |q . n'| and some by exp(-m').
    # fp32 on both sides: h is held relative to its largest value (a
    # head's output scales with 1 / its denominator), the state to 1e-4
    q, v = randn(b, h, dh, dtype=f32), randn(b, h, dh, dtype=f32)
    k = randn(b, h, dh, dtype=f32, scale=dh ** -0.5)
    li = randn(b, h, dtype=f32)
    lf = torch.nn.functional.logsigmoid(3 + randn(b, h, dtype=f32))
    m = torch.rand(b, h, generator=gen, device="cuda") * 6 - 4
    c = randn(b, h, dh, dh, dtype=f32, scale=4 * dh ** -0.5)
    n = randn(b, h, dh, dtype=f32, scale=4 * dh ** -0.5)
    args = (q, k, v, li, lf, m, c, n)
    want = ssm_decode_ref(*args)
    h_scale = float(want[0].abs().max())
    nbytes = 4 * (2 * c.numel() + 3 * q.numel() + 3 * m.numel() + n.numel()
                  + 2 * q.numel() + m.numel())
    def flat(out):                  # (h, (C', n', m')) -> (h, C', n', m')
        return (out[0],) + out[1]

    compare("mlstm_decode", f"q[{b},{h},{dh}] C[{b},{h},{dh},{dh}] fp32",
            lambda: flat(sd.ssm_decode(*args)),
            lambda: flat(ssm_decode_ref(*args)), None,
            nbytes, 5 * c.numel(), "float32", (1e-4,) * 4,
            (1e-4 * h_scale, 1e-4, 1e-4, 1e-4), representative=True)
    print("library: none for mlstm_decode (no single PyTorch call runs the "
          "mLSTM recurrence)", flush=True)

    # the step as the mixer calls it, C' written over C: bitwise the
    # separate output (n' and m' new either way)
    full = flat(sd.ssm_decode(*args))
    c_in = c.clone()
    got = flat(sd.ssm_decode(q, k, v, li, lf, m, c_in, n, out=c_in))
    assert got[1] is c_in, "mlstm_decode out"
    for j, (x_, y_) in enumerate(zip(got, full)):
        assert torch.equal(x_, y_), ("mlstm_decode in place", j)

    # row independence, bitwise: row i of the B = 4 launch == B = 1 launch
    full_heads = {name: gm.gemm_heads(xh, wh, head_major=True)
                  for name, (xh, wh) in heads.items()}
    for i in range(b):
        one = slice(i, i + 1)
        solo = flat(sd.ssm_decode(*(a[one] for a in args)))
        for j, (got, ref) in enumerate(zip(full, solo)):
            assert torch.equal(got[one], ref), ("mlstm_decode", i, j)
        for name, (xh, wh) in heads.items():
            assert torch.equal(full_heads[name][one], gm.gemm_heads(
                xh[one], wh, head_major=True)), (name, i)
    torch.cuda.synchronize()
    print("bitwise: mlstm_decode (h, C', n', m') and head-major gemm_heads "
          "rows of a B = 4 launch == their B = 1 launches; mlstm_decode "
          "with C' written over C == its separate output", flush=True)


def check_musicgen(torch, compare):
    """Phase 2 for musicgen-medium's kernels at its serving shapes (B = 4
    slots, d_model 1536, 24 query heads over 24 KV heads of 64: group 1,
    the head-dim-64 instances): the decode GEMMs, flash attention (64, 64)
    causal at its serve buckets (B 1, T 32 / 64 / 128) and at check_prefill's
    B 8 x 100, decode attention over a ragged cache of 160, and the paged
    and verify kernels (``check_paged_and_verify``), bf16 and fp32; bitwise,
    the padded-prompt rows of flash and the decode identities at D = 64.
    The library yardsticks are SDPA (causal, or with the decode mask).
    Inputs from a generator of their own, so that the later phases draw
    what they drew before."""
    import torch.nn.functional as F

    from repro_torch.kernels.attn_decode import ops as ad
    from repro_torch.kernels.attn_decode.ref import attn_decode_ref
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.gemm import ops as gm
    from repro_torch.kernels.gemm.ref import gemm_ref

    gen = torch.Generator(device="cuda").manual_seed(26)
    f32, bf16 = torch.float32, torch.bfloat16

    def randn(*shape, dtype=bf16, scale=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda") * scale
                ).to(dtype)

    b, h, d = 4, 24, 64
    # the decode GEMMs at M = 4 (per step: q, k, v, o and the MLP of 48
    # layers, the unembedding twice with the exit head): one bf16 ulp
    for k, n, act in ((1536, 1536, "none"), (1536, 6144, "silu"),
                      (6144, 1536, "none"), (1536, 2048, "none")):
        x, w = randn(b, k), randn(k, n, scale=k ** -0.5)
        lib = (lambda x=x, w=w: torch.matmul(x, w)) if act == "none" \
            else None
        compare("gemm", f"M=4 K={k} N={n} {act} musicgen",
                lambda x=x, w=w, a=act: gm.gemm(x, w, activation=a),
                lambda x=x, w=w, a=act: gemm_ref(x, w, activation=a), lib,
                2 * (b * k + k * n + b * n), 2 * b * k * n, "bfloat16",
                1e-2, 1e-2)

    # flash attention (64, 64), group 1: one bf16 ulp, as the (128, 128)
    # instance; T = 128 at B 1 is the representative row
    for bb, t in ((1, 32), (1, 64), (8, 100), (1, 128)):
        q, k_, v_ = randn(bb, h, t, d), randn(bb, h, t, d), randn(bb, h, t, d)
        pairs = t * (t + 1) // 2
        compare("attention_bf16_d64",
                f"q[{bb},{h},{t},{d}] kv[{bb},{h},{t},{d}] causal",
                lambda q=q, k_=k_, v_=v_: fa.attention(q, k_, v_,
                                                       causal=True),
                lambda q=q, k_=k_, v_=v_: attention_ref(q, k_, v_,
                                                        causal=True),
                lambda q=q, k_=k_, v_=v_: F.scaled_dot_product_attention(
                    q, k_, v_, is_causal=True),
                2 * 4 * q.numel(), 4 * bb * h * d * pairs, "bfloat16",
                1e-2, 1e-2, representative=(bb, t) == (1, 128))
    check_flash_padding(torch, randn, h, d, hq=h, dv=d)

    # decode attention over a ragged contiguous cache: bf16 (the plain
    # version rounds the softmax weights to bf16, the kernel keeps them
    # fp32) and fp32 (summation order only)
    s = 160
    cp = torch.tensor([19, 75, 130, 159], dtype=torch.int32, device="cuda")
    n_valid = int((cp + 1).sum())
    mask = (torch.arange(s, device="cuda")[None, :] <= cp[:, None]
            )[:, None, None, :]
    for dt, dname, esz, tol in ((bf16, "bfloat16", 2, 1e-2),
                                (f32, "float32", 4, 1e-4)):
        q, kc, vc = randn(b, h, d, dtype=dt), randn(b, h, s, d, dtype=dt), \
            randn(b, h, s, d, dtype=dt)
        compare("attn_decode_d64",
                f"q[4,{h},{d}] kv[4,{h},{s},{d}] ragged"
                f"{'' if dt == bf16 else ' fp32'}",
                lambda q=q, kc=kc, vc=vc: ad.attn_decode(q, kc, vc, cp),
                lambda q=q, kc=kc, vc=vc: attn_decode_ref(q, kc, vc, cp),
                lambda q=q, kc=kc, vc=vc: F.scaled_dot_product_attention(
                    q[:, :, None], kc, vc, attn_mask=mask),
                esz * q.numel() + 2 * esz * h * d * n_valid + 4 * b * h * d
                + 4 * b, 4 * h * d * n_valid, dname, tol, tol,
                representative=dt == bf16, plan=ad.decode_plan(b, h, h, d=d))
        check_paged_and_verify(torch, compare, randn, gen, hq=h, hkv=h, d=d,
                               dtype=dt, suffix="_d64")


def check_zoo(torch, compare):
    """Phase 2 for the rest of the zoo at its serving shapes (B = 4 slots,
    head dim 128): the decode GEMMs of each arch at M = 4 (chatglm3-6b's
    and qwen1.5-32b's q / k / v with their biases) and qwen3-moe's fp32
    router 2048 -> 128; flash attention at groups 16 (chatglm3: 32 query
    heads over 2), 1 (qwen1.5: 40 over 40) and 12 (mistral: 96 over 8) at
    the serve bucket T = 128 and check_prefill's B 8 x 100; decode attention
    over a ragged cache of 160 and the paged and verify kernels
    (``check_paged_and_verify``, with its bitwise identities) at those three
    groups, bf16; moe_decode at qwen3-moe's 128 experts of 2048 x 768,
    top-8, with row b of the B = 4 launch == its B = 1 launch, bitwise; and
    rmsnorm over the head dim (the QK-norm of qwen3-moe and chameleon:
    q [4, 32, 128] and k [4, 4, 128] at decode, q [4, 4, 32, 128] at
    verify), with rows of a launch == their M = 1 launches, bitwise. The
    new d_model widths of rmsnorm and vocabularies of entropy_exit are in
    ``check_rmsnorm`` / ``check_entropy``. Inputs from a generator of their
    own, so that the later phases draw what they drew before."""
    import torch.nn.functional as F

    from repro_torch.kernels.attn_decode import ops as ad
    from repro_torch.kernels.attn_decode.ref import attn_decode_ref
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.gemm import ops as gm
    from repro_torch.kernels.gemm.ref import gemm_ref
    from repro_torch.kernels.moe_decode import ops as md
    from repro_torch.kernels.moe_decode.ref import moe_decode_ref
    from repro_torch.kernels.rmsnorm import ops as rn
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

    gen = torch.Generator(device="cuda").manual_seed(27)
    f32, bf16 = torch.float32, torch.bfloat16

    def randn(*shape, dtype=bf16, scale=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda") * scale
                ).to(dtype)

    b, d = 4, 128
    # the decode GEMMs at M = 4: one bf16 ulp. (K, N, activation, bias,
    # where); an MLP's gate projection carries the silu
    for k, n, act, bias, what in (
            (4096, 4096, "none", True, "chatglm3 wq"),
            (4096, 256, "none", True, "chatglm3 wk / wv"),
            (4096, 4096, "none", False, "chatglm3 wo"),
            (4096, 13696, "silu", False, "chatglm3 MLP gate"),
            (13696, 4096, "none", False, "chatglm3 MLP down"),
            (4096, 65024, "none", False, "chatglm3 unembed"),
            (5120, 5120, "none", True, "qwen1.5 wq / wk / wv"),
            (5120, 27392, "silu", False, "qwen1.5 MLP gate"),
            (27392, 5120, "none", False, "qwen1.5 MLP down"),
            (5120, 152064, "none", False, "qwen1.5 unembed"),
            (2048, 4096, "none", False, "qwen3-moe wq"),
            (4096, 2048, "none", False, "qwen3-moe wo"),
            (2048, 512, "none", False, "qwen3-moe wk / wv"),
            (2048, 151936, "none", False, "qwen3-moe unembed"),
            (8192, 8192, "none", False, "chameleon wq / wo"),
            (8192, 1024, "none", False, "chameleon wk / wv"),
            (8192, 22016, "silu", False, "chameleon MLP gate"),
            (22016, 8192, "none", False, "chameleon MLP down"),
            (8192, 65536, "none", False, "chameleon unembed"),
            (12288, 12288, "none", False, "mistral wq / wo"),
            (12288, 1024, "none", False, "mistral wk / wv"),
            (12288, 28672, "silu", False, "mistral MLP gate"),
            (28672, 12288, "none", False, "mistral MLP down"),
            (12288, 32768, "none", False, "mistral unembed")):
        x, w = randn(b, k), randn(k, n, scale=k ** -0.5)
        bv = randn(n, scale=0.5) if bias else None
        lib = None
        if act == "none":
            lib = ((lambda x=x, w=w, bv=bv: torch.addmm(bv, x, w)) if bias
                   else (lambda x=x, w=w: torch.matmul(x, w)))
        compare("gemm", f"M=4 K={k} N={n} {act}{' bias' if bias else ''} "
                f"{what}",
                lambda x=x, w=w, bv=bv, a=act: gm.gemm(x, w, bv, a),
                lambda x=x, w=w, bv=bv, a=act: gemm_ref(x, w, bv, a), lib,
                2 * (b * k + k * n + b * n + (n if bias else 0)),
                2 * b * k * n, "bfloat16", 1e-2, 1e-2,
                plan=str(gm.gemm_plan(n, k)))
        del x, w, bv
    # qwen3-moe's router: fp32, summation order only
    x, w = randn(b, 2048, dtype=f32), randn(2048, 128, dtype=f32,
                                            scale=2048 ** -0.5)
    compare("gemm", "M=4 K=2048 N=128 none fp32 qwen3-moe router",
            lambda: gm.gemm(x, w), lambda: gemm_ref(x, w),
            lambda: torch.matmul(x, w), 4 * (b * 2048 + 2048 * 128 + b * 128),
            2 * b * 2048 * 128, "float32", 1e-4, 1e-4,
            plan=str(gm.f32_plan(128, 2048)))

    s = 160
    cp = torch.tensor([19, 75, 130, 159], dtype=torch.int32, device="cuda")
    n_valid = int((cp + 1).sum())
    mask = (torch.arange(s, device="cuda")[None, :] <= cp[:, None]
            )[:, None, None, :]
    for hq, hkv, what in ((32, 2, "chatglm3-6b"), (40, 40, "qwen1.5-32b"),
                          (96, 8, "mistral-large-123b")):
        sfx = f"_g{hq // hkv}"
        # flash attention (128, 128) at the group: one bf16 ulp
        for bb, t in ((8, 100), (1, 128)):
            q, k_, v_ = randn(bb, hq, t, d), randn(bb, hkv, t, d), \
                randn(bb, hkv, t, d)
            pairs = t * (t + 1) // 2
            compare("attention", f"q[{bb},{hq},{t},{d}] kv[{bb},{hkv},{t},"
                    f"{d}] causal {what}",
                    lambda q=q, k_=k_, v_=v_: fa.attention(q, k_, v_,
                                                           causal=True),
                    lambda q=q, k_=k_, v_=v_: attention_ref(q, k_, v_,
                                                            causal=True),
                    lambda q=q, k_=k_, v_=v_: F.scaled_dot_product_attention(
                        q, k_, v_, is_causal=True, enable_gqa=True),
                    2 * (2 * q.numel() + 2 * k_.numel()),
                    4 * bb * hq * d * pairs, "bfloat16", 1e-2, 1e-2)
        # decode attention over a ragged contiguous cache (the plain version
        # rounds the softmax weights to bf16, the kernel keeps them fp32)
        q, kc, vc = randn(b, hq, d), randn(b, hkv, s, d), randn(b, hkv, s, d)
        compare(f"attn_decode{sfx}",
                f"q[4,{hq},{d}] kv[4,{hkv},{s},{d}] ragged {what}",
                lambda q=q, kc=kc, vc=vc: ad.attn_decode(q, kc, vc, cp),
                lambda q=q, kc=kc, vc=vc: attn_decode_ref(q, kc, vc, cp),
                lambda q=q, kc=kc, vc=vc: F.scaled_dot_product_attention(
                    q[:, :, None], kc, vc, attn_mask=mask, enable_gqa=True),
                2 * q.numel() + 2 * 2 * hkv * d * n_valid + 4 * b * hq * d
                + 4 * b, 4 * hq * d * n_valid, "bfloat16", 1e-2, 1e-2,
                representative=True, plan=ad.decode_plan(b, hq, hkv))
        check_paged_and_verify(torch, compare, randn, gen, hq=hq, hkv=hkv,
                               d=d, suffix=sfx)

    # dropless MoE decode at qwen3-moe's 128 experts of 2048 x 768, top-8,
    # 4 live slots (32 assignments): fp32 on both sides
    e_, k8, dm, hh = 128, 8, 2048, 768
    x = randn(b, dm)
    wg = randn(e_, dm, hh, scale=dm ** -0.5)
    wu = randn(e_, dm, hh, scale=dm ** -0.5)
    wd = randn(e_, hh, dm, scale=hh ** -0.5)
    probs = torch.softmax(randn(b, e_, dtype=f32), -1)
    gate, idx = torch.topk(probs, k8, dim=-1)
    gate = gate / gate.sum(-1, keepdim=True)
    idx = idx.to(torch.int32)
    touched = int(torch.unique(idx).numel())
    compare("moe_decode_qwen3", f"x[4,2048] top-8 of 128 experts "
            f"[2048,768] ({touched} experts read)",
            lambda: md.moe_decode(x, idx, gate, wg, wu, wd),
            lambda: moe_decode_ref(x, idx, gate, wg, wu, wd), None,
            2 * 3 * touched * dm * hh + 2 * x.numel() + 8 * b * k8
            + 4 * b * dm, 6 * b * k8 * dm * hh, "bfloat16", 1e-4, 1e-4,
            representative=True, plan=md.moe_plan(dm, hh))
    full = md.moe_decode(x, idx, gate, wg, wu, wd)
    for i in range(b):
        one = slice(i, i + 1)
        assert torch.equal(full[one], md.moe_decode(
            x[one], idx[one], gate[one], wg, wu, wd)), ("moe_decode E 128", i)
    del wg, wu, wd

    # rmsnorm over the head dim (QK-norm), an fp32 scale that is not 1 (a
    # trained norm's): one bf16 ulp
    sc = 1 + 0.1 * randn(d, dtype=f32)
    for shape, what in (((4, 32, 128), "q at decode"),
                        ((4, 4, 128), "k at decode"),
                        ((4, 4, 32, 128), "q at verify, K1 = 4")):
        x = randn(*shape, scale=3.0)
        compare("rmsnorm_qk_d128" if shape == (4, 32, 128) else "rmsnorm",
                f"{list(shape)} QK-norm {what}",
                lambda x=x: rn.rmsnorm(x, sc), lambda x=x: rmsnorm_ref(x, sc),
                lambda x=x: F.rms_norm(x, (d,), sc.to(bf16), 1e-5),
                2 * 2 * x.numel() + 4 * d, 4 * x.numel(), "bfloat16", 1e-2,
                1e-2, representative=shape == (4, 32, 128),
                plan=rn.rmsnorm_plan(d, bf16))
        full = rn.rmsnorm(x, sc).reshape(-1, d)
        rows = x.reshape(-1, d)
        for i in (0, 1, 7, 8, rows.shape[0] - 1):   # two blocks of 8 rows
            assert torch.equal(full[i:i + 1], rn.rmsnorm(
                rows[i:i + 1].contiguous(), sc)), ("rmsnorm d 128", shape, i)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    print("bitwise: moe_decode (128 experts of 2048 x 768, top-8) rows of a "
          "B = 4 launch == their B = 1 launches; rmsnorm over the head dim "
          "(d 128) rows of a launch == their M = 1 launches", flush=True)


def check_prefill(torch, lm, cfg, params, n_prompts: int = 8,
                  length: int = 100, fp32_copy: bool = True,
                  max_rel: float | None = 5e-2,
                  max_mean_rel: float | None = None,
                  min_clear: int | None = None, policy="auto",
                  ref_policy="ref", label: str = ""):
    """Last-position prefill logits of the kernel path against the plain
    policy on the same bf16 weights, and both against the plain policy
    computing in fp32 (the rounding-free yardstick): on an fp32 copy of
    the weights (``fp32_copy``), or on the bf16 weights themselves with an
    fp32 config (every plain op upcasts its weights, exactly, so the result
    is the same without the copy). The kernel-vs-plain rel L2 of every
    prompt must stay under ``max_rel`` (and its mean under
    ``max_mean_rel``), and the kernels must be no further from fp32 than
    1.5x the plain version.

    With random weights the logits are ~N(0, 1) over the vocabulary, so
    the top two of a prompt can lie closer than bf16 rounding moves them.
    A prompt is clear when its plain top-2 gap is at least 5x the RMS
    logit difference of the plain bf16 path from fp32 (its rounding
    noise, which the kernels do not enter), and at least 0.1; the argmax
    must agree on every clear prompt, and at least ``min_clear`` prompts
    (default 1/16 of them, 4 at least) must be clear. Near ties are
    reported. ``max_rel=None`` sets no bound on the kernel-vs-plain
    distance (a model whose bf16 rounding noise swamps its logits).
    ``policy`` / ``ref_policy`` are the kernel path's and the plain path's
    policies (the W8A8 check names the int8 backend in both). Returns the
    last-position logits of each path (fp32)."""
    rng = torch.Generator().manual_seed(7)
    prompts = torch.randint(0, cfg.vocab_size, (n_prompts, length),
                            generator=rng, dtype=torch.int32).cuda()
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    runs = (("kernels", policy, cfg, params),
            ("plain", ref_policy, cfg, params),
            ("fp32", ref_policy, cfg32, None if fp32_copy else params))
    last = {}
    with torch.inference_mode():
        for name, pol, c, p in runs:
            if p is None:       # fp32 copy of the same weights, then freed
                p = lm._map(params, lambda t: t.float())
            cache = lm.init_cache(c, n_prompts, length, device="cuda")
            logits, _ = lm.forward_prefill(p, prompts, c, pol, cache)
            last[name] = logits.float()
            del p, cache
    torch.cuda.empty_cache()

    def rel(a, b):
        return (last[a] - last[b]).norm(dim=-1) / last[b].norm(dim=-1)

    rel_kp, rel_kf, rel_pf = (rel("kernels", "plain"), rel("kernels", "fp32"),
                              rel("plain", "fp32"))
    rms_pf = float((last["plain"] - last["fp32"]).pow(2).mean().sqrt())
    thr = max(0.1, 5 * rms_pf)
    if min_clear is None:
        min_clear = max(4, n_prompts // 16)
    top2 = last["plain"].topk(2, dim=-1).values
    gap = top2[:, 0] - top2[:, 1]
    arg = {k: last[k].argmax(-1) for k in last}
    clear = gap >= thr
    ref = "weight copy" if fp32_copy else "fp32 compute on the same weights"
    print(f"prefill logits {cfg.name}{label} ({cfg.num_layers} layers), "
          f"{n_prompts} "
          f"prompts x {length} tokens: rel_l2 kernels-vs-plain max "
          f"{float(rel_kp.max()):.3e} (bound {max_rel}) mean "
          f"{float(rel_kp.mean()):.3e} (bound {max_mean_rel}); vs fp32 "
          f"({ref}): kernels {float(rel_kf.mean()):.3e} plain "
          f"{float(rel_pf.mean()):.3e}, plain RMS {rms_pf:.3e}; argmax "
          f"kernels==plain {int((arg['kernels'] == arg['plain']).sum())}/"
          f"{n_prompts} (clear {int(clear.sum())}, at least {min_clear}, at "
          f"gap >= {thr:.3f}), kernels==fp32 "
          f"{int((arg['kernels'] == arg['fp32']).sum())}/{n_prompts}; plain "
          f"top-2 gaps {[round(float(g), 3) for g in gap]}", flush=True)
    assert torch.isfinite(last["kernels"]).all(), "non-finite prefill logits"
    if max_rel is not None:
        assert float(rel_kp.max()) < max_rel, \
            f"prefill logits differ: {rel_kp}"
    if max_mean_rel is not None:
        assert float(rel_kp.mean()) < max_mean_rel, \
            f"prefill logits differ on average: {rel_kp}"
    assert float(rel_kf.mean()) <= 1.5 * float(rel_pf.mean()), \
        "kernels are further from fp32 than the plain version"
    assert int(clear.sum()) >= min_clear, f"too few clear prompts {gap}"
    assert bool((arg["kernels"] == arg["plain"])[clear].all()), \
        f"argmax differs on a clear prompt: {arg}, gaps {gap}"
    return last


def check_layers(torch, lm, cfg, params, n_prompts: int = 16,
                 length: int = 100):
    """Teacher-forced, layer by layer: every layer takes the plain path's
    hidden state as its input and runs three ways on it, through the
    kernels, the plain policy, and the plain policy computing in fp32 on
    the same bf16 weights; its update (output - input) is compared per
    token (rel L2 over d_model). Unlike the last-position logits, no
    layer inherits the rounding of the layers before it, so a model
    whose bf16 paths drift apart with depth (a routing near-tie flips a
    token's experts, a recurrence carries every perturbation forward) is
    still held layer by layer. Per layer: all finite; the kernels' median
    token no further from fp32 than 1.5x the plain path's, and under
    5e-2 (a few bf16 steps); at most 2% of the tokens further than 0.1
    from the plain path (a routing flip moves a token by ~1)."""
    rng = torch.Generator().manual_seed(7)
    prompts = torch.randint(0, cfg.vocab_size, (n_prompts, length),
                            generator=rng, dtype=torch.int32).cuda()
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    paths = (("kernels", "auto", cfg), ("plain", "ref", cfg),
             ("fp32", "ref", cfg32))
    caches = {name: lm.init_cache(c, n_prompts, length, device="cuda")
              for name, _, c in paths}

    def rel(a, b):
        return ((a - b).norm(dim=-1) / b.norm(dim=-1)).flatten()

    worst = []
    with torch.inference_mode():
        x = lm._embed(params, prompts, cfg)
        for i in range(cfg.num_layers):
            spec, p = cfg.layer_spec(i), lm._layer(params, cfg, i)
            upd = {}
            for name, policy, c in paths:
                xin = x.to(getattr(torch, c.dtype))
                y = lm._apply_layer(p, xin, c, spec, policy,
                                    caches[name].layer(i), "prefill")
                upd[name] = y.float() - xin.float()
                if name == "plain":
                    x_next = y
            r_kf, r_pf = rel(upd["kernels"], upd["fp32"]), \
                rel(upd["plain"], upd["fp32"])
            r_kp = rel(upd["kernels"], upd["plain"])
            far = float((r_kp > 0.1).float().mean())
            med_k, med_p = float(r_kf.median()), float(r_pf.median())
            print(f"layer {i:2d} {spec.mixer:5s}+{spec.ffn:3s}: update rel "
                  f"L2 vs fp32 median kernels {med_k:.3e} plain "
                  f"{med_p:.3e}, mean {float(r_kf.mean()):.3e} / "
                  f"{float(r_pf.mean()):.3e}; kernels vs plain median "
                  f"{float(r_kp.median()):.3e}, > 0.1 on {far:.2%} of "
                  f"{r_kp.numel()} tokens", flush=True)
            assert all(bool(torch.isfinite(u).all()) for u in upd.values()), \
                f"layer {i}: non-finite update"
            assert med_k <= 1.5 * med_p and med_k < 5e-2, \
                f"layer {i}: kernels' update off ({med_k} vs plain {med_p})"
            assert far <= 0.02, f"layer {i}: {far:.2%} of tokens moved"
            worst.append(med_k)
            x = x_next
    del caches
    torch.cuda.empty_cache()
    print(f"layers {cfg.name}: teacher-forced per-layer check passed on "
          f"{n_prompts} prompts x {length} tokens; largest median update "
          f"rel L2 of the kernels vs fp32 {max(worst):.3e}", flush=True)


def fill_slots(engine, params, prompts):
    """Prefill every slot of ``engine`` (on a paged engine, with every page
    its five chunks need) and run one warm-up chunk: (cache, state)."""
    from repro_torch.serve.paging import PageAllocator

    cache, st = engine.init_state()
    new = 5 * engine.chunk + 1
    alloc = (PageAllocator(engine.num_pages, engine.capacity,
                           engine.max_pages, engine.page_size)
             if engine.paged else None)
    for slot in range(engine.capacity):
        ids = None
        if alloc is not None:     # every page the five chunks will need
            t = len(prompts[slot])
            ids = alloc.admit(slot, engine._bucket(t), t, new)
            alloc.ensure(slot, t + new - 1)
        cache, st, _ = engine.prefill_into(params, cache, st, prompts[slot],
                                           slot, new, page_ids=ids)
    if alloc is not None:
        cache = engine.set_page_table(cache, alloc.table)
    cache, st, _ = engine.decode(params, cache, st)          # warm-up
    return cache, st


def timed_chunk(torch, engine, params, cache, st):
    """One decode chunk between two synchronizes: (cache, state, host-clock
    ms a step)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cache, st, _ = engine.decode(params, cache, st)
    torch.cuda.synchronize()
    return cache, st, (time.perf_counter() - t0) / engine.chunk * 1e3


def host_ab(torch, label, sides, prompts):
    """The host clock of two engines' decode steps in turns, in one
    process: both filled first, then a chunk each in the order A B B A A
    B. Prints each side's ms a step over its three chunks, each chunk's
    beside it: a difference between the sides that holds in every turn is
    theirs, not the host's drift from one window to the next."""
    state = {name: fill_slots(engine, params, prompts)
             for name, engine, params in sides}
    times = {name: [] for name, _, _ in sides}
    for i in (0, 1, 1, 0, 0, 1):
        name, engine, params = sides[i]
        cache, st, ms = timed_chunk(torch, engine, params, *state[name])
        state[name] = cache, st
        times[name].append(ms)
    print(f"host clock in turns, {label}: " + "; ".join(
        f"{name} {sum(t) / len(t):.2f} ms a step (a chunk "
        f"{[round(x, 2) for x in t]})" for name, t in times.items()),
        flush=True)


# the host's CUDA calls that launch one kernel each (the runtime's and the
# driver's; Memcpy and Memset go through other calls)
LAUNCH_APIS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
               "cuLaunchKernelEx")


# the decode steps ``profile_decode`` traces (a chunk of the engine cut to
# this many steps): the profiler's host-side processing grows with the
# window's events (~25k a yi-9b step: CPU ops, runtime calls, kernels);
# whole chunks of 8 steps took 438.7 s over the script's 23 calls, 2
# steps 115.4 s (on an H100's host), and the device's kernel records
# then come up to ~27 a step short of the launches (~7 at 8 steps)
TRACE_STEPS = 2


def profile_decode(torch, name, engine, params, prompts):
    """Where a decode step's time goes: fill every slot, then time three
    chunks of ``engine.chunk`` steps by the host clock, each between two
    synchronizes (ms a step: the whole window's, the three chunks' times
    over all their steps, with each chunk's beside it), and trace
    ``TRACE_STEPS`` more steps with torch.profiler for the device time a
    step by kernel, the device kernels a step (the profiler's event
    counts), the device's busy share of the untraced step and the traced
    step's host ops. A measurement, not a check: if the profiler shows no
    device time, that part is reported as not measured. Returns the kernel
    launches a step as the host issued them (the CUDA launch calls the
    profiler recorded on the host; None if it recorded none): the device's
    kernel records of a traced chunk can come up to a few kernels a step
    short of them."""
    from torch.profiler import ProfilerActivity, profile

    t_call = time.perf_counter()
    cache, st = fill_slots(engine, params, prompts)
    walls = []
    for _ in range(3):
        cache, st, ms = timed_chunk(torch, engine, params, cache, st)
        walls.append(ms)
    wall = sum(walls) / len(walls)      # equal chunks: the window's mean
    chunk, engine.chunk = engine.chunk, TRACE_STEPS
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            cache, st, traced = timed_chunk(torch, engine, params, cache, st)
    finally:
        engine.chunk = chunk
    events = prof.key_averages()
    per, count, calls = {}, {}, 0
    for e in events:
        t = getattr(e, "self_device_time_total", 0) or 0
        if t > 0 and e.device_type.name == "CUDA":
            per[e.key] = per.get(e.key, 0.0) + t / 1e3 / TRACE_STEPS
            count[e.key] = count.get(e.key, 0) + e.count / TRACE_STEPS
            if not e.key.startswith(("Memcpy", "Memset")):
                calls += e.count
    dev = sum(per.values())
    kernels = calls / TRACE_STEPS if dev > 0 else None
    issued = sum(e.count for e in events
                 if e.device_type.name == "CPU" and e.key in LAUNCH_APIS)
    issued = issued / TRACE_STEPS if issued else None
    # the GEMM kernels' share: csrc/gemm.cu's (bf16, int8-weight, fp32)
    # and csrc/gemm_int8.cu's (its activation quantization included), by
    # their own names (no library kernel)
    gemm = sum(v for k, v in per.items()
               if any(s in k for s in ("bf::gemm_bf16_kernel<",
                                       "f32::gemm_f32_kernel<",
                                       "i8::gemm_int8_kernel<")))
    # the decode-attention kernels' share: csrc/decode_tile.cuh's (GQA,
    # contiguous or paged) and csrc/mla_tile.cuh's (precise)
    attn = sum(v for k, v in per.items()
               if any(s in k for s in ("decode::gqa_decode_kernel<",
                                       "mla::mla_decode_kernel<")))
    # the MoE kernels' share: csrc/moe_decode.cu's up / down passes and
    # the combine
    moe = sum(v for k, v in per.items()
              if any(s in k for s in ("moe::moe_pass_kernel<",
                                      "moe::moe_combine_kernel")))
    # rmsnorm's and entropy_exit's kernels, the mLSTM and Mamba steps' and
    # the device to device copies (recurrent state written back): ms and
    # launches a step
    named = {}
    for label, sub in (("rmsnorm", "rmsnorm_kernel<"),
                       ("entropy_exit", "entropy_kernel<"),
                       ("mLSTM", "mlstm_decode_kernel"),
                       ("Mamba decode", "mamba_decode_kernel"),
                       ("Memcpy DtoD", "Memcpy DtoD")):
        keys = [k for k in per if sub in k]
        named[label] = (sum(per[k] for k in keys),
                        sum(count[k] for k in keys))
    top = sorted(per.items(), key=lambda kv: -kv[1])[:10]
    # the host's side of the traced step: self time and calls a step of
    # the costliest host ops (profiled, so larger than untraced)
    host = sorted(((e.key, e.self_cpu_time_total / 1e3 / TRACE_STEPS,
                    e.count / TRACE_STEPS) for e in events
                   if e.device_type.name == "CPU"), key=lambda r: -r[1])[:6]
    busy = (f"device busy {dev:.2f} ms a step = {dev / wall:.1%} of the "
            f"untraced step, {kernels:.3f} device kernels a step "
            f"({issued} launch calls a step on the host), GEMM "
            f"kernels {gemm:.3f} ms, decode attention {attn:.3f} ms, MoE "
            f"kernels {moe:.3f} ms, "
            + ", ".join(f"{k} {v:.3f} ms ({n:.1f} launches)"
                        for k, (v, n) in named.items()) if dev > 0 else
            "device time not measured (the profiler showed none)")
    print(f"decode step {name}: {wall:.2f} ms a step (host clock, "
          f"{3 * engine.chunk} steps in 3 chunks of {engine.chunk}, a chunk "
          f"{[round(w, 2) for w in walls]}; traced {traced:.2f} over "
          f"{TRACE_STEPS} steps; {engine.capacity} live slots); {busy}; "
          f"top kernels ms/step "
          f"{[(k[:48], round(v, 3)) for k, v in top]}; top host ops "
          f"(ms, calls) a traced step "
          f"{[(k[:32], round(v, 2), round(c)) for k, v, c in host]}; "
          f"profile took {time.perf_counter() - t_call:.1f}s", flush=True)
    return issued


def make_prompts(torch, vocab: int, seed: int = 11):
    """6 prompts of 20-120 tokens from a seeded generator (numpy arrays)."""
    rs = torch.Generator().manual_seed(seed)
    lens = torch.randint(20, 121, (6,), generator=rs).tolist()
    return [torch.randint(0, vocab, (n,), generator=rs,
                          dtype=torch.int32).numpy() for n in lens]


def serve_run(torch, runs, card, name, run_cfg, p, prompts, policy="auto",
              seeds=None, on_engine=None, priorities=None, overload=None,
              resilient=None, max_len=160, **engine_kw):
    """Serve one request a prompt (the 6 of ``make_prompts`` but in phases
    5b and 5c; 24 new tokens each; request i seeded with ``seeds[i]`` and
    of priority ``priorities[i]`` when given) with every launch counter
    reset just before and read just after; the result goes to
    ``runs[name]``. ``on_engine(engine)`` is called before the reset
    (phase 5b's, 5c's and 5d's probes wrap the engine's methods there);
    ``overload``: an ``OverloadConfig`` for ``serve``; ``resilient``: the
    keywords of ``serve_resilient`` (phase 5d), which then drives the
    stream under the restart supervisor instead of ``serve``."""
    from repro_torch.configs.base import RunConfig
    from repro_torch.core import xaif
    from repro_torch.serve.engine import SlotEngine
    from repro_torch.serve.resilient import serve_resilient
    from repro_torch.serve.scheduler import Request, serve

    requests = [Request(rid=i, prompt=pr, max_new_tokens=24,
                        seed=None if seeds is None else seeds[i],
                        priority=0 if priorities is None else priorities[i])
                for i, pr in enumerate(prompts)]
    engine = SlotEngine(RunConfig(arch=run_cfg, policy=policy), capacity=4,
                        max_len=max_len, chunk=8, prompt_bucket=16,
                        **engine_kw)
    if on_engine is not None:
        on_engine(engine)
    torch.cuda.synchronize()
    xaif.reset_launch_counts()
    if resilient is not None:
        report = serve_resilient(engine, p, requests, **resilient)
    else:
        report = serve(engine, p, requests, overload=overload)
    torch.cuda.synchronize()
    launches = {k: n for k, n in xaif.launch_counts().items() if n}
    fallbacks = xaif.fallback_counts()
    steps = engine.decode_calls * engine.chunk
    assert len(report.served) == len(prompts), [r.reject_reason
                                                for r in requests]
    for r in requests:
        assert len(r.tokens) == 24 and all(
            0 <= t < run_cfg.vocab_size for t in r.tokens), (r.rid, r.tokens)
    lat = report.latency_percentiles()
    print(f"serve {name}: {len(prompts)}/{len(prompts)} served, 24 tokens "
          f"each, "
          f"{report.tokens_per_s:.1f} tok/s p50={lat['p50'] * 1e3:.0f}ms "
          f"p99={lat['p99'] * 1e3:.0f}ms over {steps} decode steps "
          f"(rounds) and {engine.prefill_calls} prefills; launches "
          f"{launches}; stats {report.stats} on {card}", flush=True)
    runs[name] = dict(tokens=[r.tokens for r in requests],
                      launches=launches, steps=steps, report=report,
                      prefills=engine.prefill_calls, fallbacks=fallbacks)
    return runs[name]


def with_threshold(cfg, threshold: float):
    """``cfg`` with its exit's entropy threshold set: 2.0 makes every row
    exit (the normalized entropy is at most 1), -1.0 none."""
    return dataclasses.replace(cfg, early_exit=dataclasses.replace(
        cfg.early_exit, entropy_threshold=threshold))


def gated_step_launches(cfg, skip: bool):
    """Kernel launches of one step of ``forward_decode_gated``: the layers
    up to the exit, the exit head (rmsnorm, gemm) and its decision
    (entropy_exit); then, on a skipped step, each later layer's
    propagation (ln1 and the K and V projections, with the K-norm; MLA:
    ln1, the latent and rotary-key projections and the latent's norm), or
    else the later layers and the final head (the ungated step's launches).
    A GQA layer: q, k, v, o, ln1, ln2 (and q_norm, k_norm with a QK-norm),
    one decode attention; an MLA layer: wq, w_dkv, w_kr, wo, ln1, kv_norm,
    ln2, two gemm_heads, one precise decode attention; then the MLP's
    three GEMMs, or an MoE's fp32 router, its shared experts' three GEMMs
    and one moe_decode."""
    from collections import Counter

    el, nl = cfg.early_exit.exit_layers[0], cfg.num_layers
    out = Counter()
    for i in range(el if skip else nl):
        if cfg.mla is not None:
            out.update(gemm=4, rmsnorm=3, gemm_heads=2, attn_decode=1)
        else:
            out.update(gemm=4, rmsnorm=4 if cfg.qk_norm else 2,
                       attn_decode=1)
        if cfg.layer_spec(i).ffn == "moe":
            out.update(gemm=1 + 3 * bool(cfg.moe.num_shared_experts),
                       moe_decode=1)
        else:
            out.update(gemm=3)
    out.update(gemm=1, rmsnorm=1, entropy_exit=1)
    if skip:
        n = nl - el
        out.update(gemm=2 * n,
                   rmsnorm=(2 if cfg.qk_norm or cfg.mla else 1) * n)
    else:
        out.update(gemm=1, rmsnorm=1)
    return out


def cache_rows(torch, cache, layer: int, pos):
    """The cache rows of ``layer`` at each slot's position ``pos`` [B]:
    K and V [B, Hkv, D], or the latent [B, r] and rotary key [B, rd]."""
    bidx = torch.arange(pos.shape[0], device=pos.device)
    return [t.movedim(-2, 1)[bidx, pos.long()] for t in cache.layer(layer)]


def check_gated_rows(torch, cfg, params, prompts):
    """One skipped step on full-width weights: ``cfg``'s gated engine (an
    exit threshold of 2.0) filled with 4 live slots, then, on three copies
    of its cache, (a) the gated step through the kernels, (b) the layers
    up to the exit through the kernels and ``_kv_propagate_layer`` of each
    later layer from that exit hidden state through the kernels, (c) the
    same propagation through the plain policy from the same hidden state.
    (a) == (b) bitwise at every propagated row; (b) against (c) within one
    bf16 ulp (1e-2 + 1e-2 |plain|: the kernels' fp32 sums in other orders
    move a bf16 rounding by one unit). Returns the largest abs difference."""
    from repro_torch.models import lm
    from repro_torch.serve.engine import SlotEngine

    engine = SlotEngine(cfg, capacity=4, max_len=160, chunk=8, gated=True)
    cache, st = fill_slots(engine, params, prompts)
    live, tok = ~st.done, st.tokens[:, None]
    assert bool(live.all()), st.done

    def copy():
        return cache._replace(**{f: getattr(cache, f).clone() for f in
                                 ("pos", "k", "v", "c_kv", "k_rope")
                                 if getattr(cache, f) is not None})

    gated, kern, plain = copy(), copy(), copy()
    _, mask, _ = lm.forward_decode_gated(params, tok, cfg, "auto", gated,
                                         live=live)
    assert bool(mask.all()), mask
    el, nl = cfg.early_exit.exit_layers[0], cfg.num_layers
    x = lm._embed(params, tok, cfg)
    x = lm._run_layers(params, x, range(el), cfg, "auto", kern, "decode",
                       kern.pos, None, live)
    for policy, dst in (("auto", kern), ("ref", plain)):
        for i in range(el, nl):
            lm._kv_propagate_layer(lm._layer(params, cfg, i), x, cfg, policy,
                                   dst.layer(i), dst.pos)
    torch.cuda.synchronize()
    worst = 0.0
    for i in range(el, nl):
        for a, b, c in zip(*(cache_rows(torch, t, i, cache.pos)
                             for t in (gated, kern, plain))):
            assert torch.equal(a, b), (cfg.name, i, "gated step's rows")
            err = (b.float() - c.float()).abs()
            bad = err > 1e-2 + 1e-2 * c.float().abs()
            assert not bad.any(), (cfg.name, i, float(err.max()))
            worst = max(worst, float(err.max()))
    print(f"gated rows {cfg.name}: one skipped step with 4 live slots; the "
          f"propagated rows of layers {el}-{nl - 1} == _kv_propagate_layer "
          f"through the kernels from the exit hidden state, bitwise; "
          f"kernels vs plain max abs {worst:.3e} (bound 1e-2 + 1e-2 |ref|)",
          flush=True)
    return worst


def serve_gated(torch, run_serve, name, cfg, params, prompts, ungated):
    """The 6-request serve through ``SlotEngine(gated=True)`` at an exit
    threshold of 2.0: every live row exits, so every decode step skips the
    layers past the exit. Launches exactly ``ungated``'s (the arch's
    ungated serve of the same requests: the same prefills and steps) less
    each step's difference between a full and a skipped step
    (``gated_step_launches``); exit rate 1.0 and gated fraction 1 - exit /
    layers; request 0 == ``generate(gated=True)`` bitwise; one skipped
    step's propagated rows held (``check_gated_rows``). Returns the run."""
    from repro_torch.serve.engine import generate

    cfg2 = with_threshold(cfg, 2.0)
    run = run_serve(name, cfg2, params, prompts, gated=True)
    steps = run["steps"]
    assert (steps, run["prefills"]) == (ungated["steps"],
                                        ungated["prefills"]), name
    full = gated_step_launches(cfg, skip=False)
    skip = gated_step_launches(cfg, skip=True)
    want = {k: n - steps * (full[k] - skip[k])
            for k, n in ungated["launches"].items()}
    want = {k: n for k, n in want.items() if n}
    assert run["launches"] == want, (name, run["launches"], want)
    el = cfg.early_exit.exit_layers[0]
    stats = run["report"].stats
    assert stats["exit_rate"] == 1.0, stats
    assert abs(stats["gated_fraction"] - (1 - el / cfg.num_layers)) < 1e-6, \
        stats
    ref_toks, _ = generate(cfg2, params, prompts[0][None], 24, gated=True)
    assert ref_toks[0].tolist() == run["tokens"][0], (
        f"{name} tokens differ from generate(gated=True)",
        ref_toks[0].tolist(), run["tokens"][0])
    print(f"serve {name}: request 0 == generate(gated=True), bitwise; every "
          f"step skipped layers {el}-{cfg.num_layers - 1} (exit rate "
          f"{stats['exit_rate']:.3f}, gated fraction "
          f"{stats['gated_fraction']:.4f}); launches exactly {want}; a "
          f"skipped step {dict(skip)}, a full one {dict(full)}", flush=True)
    check_gated_rows(torch, cfg2, params, prompts)
    return run


def gated_steps(run_serve, name, cfg, params, prompts):
    """``run_serve`` of the gated engine with each decode step's branch
    recorded (``lm.forward_decode_gated`` wrapped for this run: a host
    read of the live and exit masks a step). Returns (the run, skipped
    steps, steps with no live slot: those skip too, as under JAX's
    ``lax.cond``, and their outputs are discarded)."""
    from repro_torch.models import lm

    real, seen = lm.forward_decode_gated, []

    def recorded(params, tokens, cfg, policy, cache, live=None):
        out = real(params, tokens, cfg, policy, cache, live=live)
        seen.append((bool((out[1] | ~live).all()), not bool(live.any())))
        return out

    lm.forward_decode_gated = recorded
    try:
        run = run_serve(name, cfg, params, prompts, gated=True)
    finally:
        lm.forward_decode_gated = real
    assert len(seen) == run["steps"], (len(seen), run["steps"])
    return run, sum(s for s, _ in seen), sum(d for _, d in seen)


def exit_entropy_threshold(torch, cfg, params, prompts):
    """A threshold among the exit entropies: 4 slots filled with
    ``prompts[:4]`` as a serve's first chunk starts, 8 full-depth decode
    steps, the largest exit entropy of each step; the threshold halfway
    between the 4th and 5th smallest of the 8, so that a gated run's steps
    skip about half the time (a step skips when every live row is below
    it). Returns (threshold, the 8 step maxima)."""
    from repro_torch.core.early_exit import should_exit
    from repro_torch.models import lm
    from repro_torch.serve.engine import SlotEngine

    engine = SlotEngine(cfg, capacity=4, max_len=160, chunk=8)
    cache, st = engine.init_state()
    for slot in range(4):
        cache, st, _ = engine.prefill_into(params, cache, st, prompts[slot],
                                           slot, 24)
    tok, worst = st.tokens, []
    with torch.inference_mode():
        for _ in range(8):
            lg, exits, cache = lm.forward_decode(params, tok[:, None], cfg,
                                                 "auto", cache)
            worst.append(float(should_exit(exits[0], 0.0, "auto")[1].max()))
            tok = lg.argmax(-1).to(torch.int32)
    srt = sorted(worst)
    return (srt[3] + srt[4]) / 2, worst


def run_gated_yi(torch, run_serve, cfg, params, prompts, plain):
    """Phase 4b: gated early-exit decode on full-width yi-9b (``plain``:
    phase 4's run). At thresholds -1.0 and 2.0 the gated engine's tokens
    equal the ungated engine's at the same threshold, bitwise (at -1 every
    step runs the full depth, with exactly the ungated launches; at 2.0
    every step skips layers 12-47, ``serve_gated``); at a threshold among
    the exit entropies of a first chunk some steps skip and some do not:
    the skipped steps (from the decode-attention launches) and the gated
    fraction printed, a second run's tokens equal, bitwise. A decode chunk
    of the gated engine at 2.0 (every step skipped) and at -1.0 (every
    step full) traced. Returns the threshold-2.0 gated run."""
    from repro_torch.serve.engine import SlotEngine

    cfg_m1, cfg_2 = with_threshold(cfg, -1.0), with_threshold(cfg, 2.0)
    full_step = gated_step_launches(cfg, skip=False)
    skip_step = gated_step_launches(cfg, skip=True)

    def less(launches, n):       # n steps skipped rather than full
        out = {k: c - n * (full_step[k] - skip_step[k])
               for k, c in launches.items()}
        return {k: c for k, c in out.items() if c}

    ungated = run_serve("thr-1-contiguous", cfg_m1, params, prompts)
    full, skipped, dead = gated_steps(run_serve, "gated-thr-1", cfg_m1,
                                      params, prompts)
    assert full["tokens"] == ungated["tokens"], "gated at -1 differs"
    assert skipped == dead, (skipped, dead)
    assert full["launches"] == less(ungated["launches"], dead), (
        full["launches"], ungated["launches"], dead)
    stats = full["report"].stats
    assert stats["exit_rate"] == 0.0 and stats["gated_fraction"] == 0.0
    print(f"serve gated-thr-1: tokens == the ungated engine's at threshold "
          f"-1, bitwise; every step with a live slot ran the full depth, "
          f"the {dead} of {full['steps']} steps with none skipped; launches "
          f"exactly the ungated run's less those {dead} steps' difference",
          flush=True)
    ungated2 = run_serve("thr2-contiguous", cfg_2, params, prompts)
    gated2 = serve_gated(torch, run_serve, "gated-thr2", cfg, params,
                         prompts, plain)
    assert gated2["tokens"] == ungated2["tokens"], "gated at 2.0 differs"
    print("serve gated-thr2: tokens == the ungated engine's at threshold "
          "2.0, bitwise (the exit logits depend only on layers 0-11)",
          flush=True)

    thr, maxima = exit_entropy_threshold(torch, cfg, params, prompts)
    cfg_mix = with_threshold(cfg, thr)
    mixed = [gated_steps(run_serve, f"gated-mixed-{i}", cfg_mix, params,
                         prompts) for i in (1, 2)]
    run, skipped, dead = mixed[0]
    assert run["tokens"] == mixed[1][0]["tokens"], "mixed gated differs"
    assert mixed[1][1:] == (skipped, dead), (mixed[1][1:], skipped, dead)
    assert run["launches"] == less(ungated["launches"], skipped), (
        run["launches"], skipped)
    el, nl = cfg.early_exit.exit_layers[0], cfg.num_layers
    print(f"serve gated-mixed: threshold {thr:.6f} (halfway in the exit "
          f"entropies' step maxima {[round(m, 6) for m in maxima]}); "
          f"{skipped - dead} of the {run['steps'] - dead} steps with a live "
          f"slot skipped layers {el}-{nl - 1} ({dead} with none skipped "
          f"too); launches exact; stats {run['report'].stats}; a second "
          f"run's tokens and branches equal, bitwise", flush=True)

    profile_decode(torch, "yi-9b gated, every step skipped", SlotEngine(
        cfg_2, capacity=4, max_len=160, chunk=8, gated=True), params, prompts)
    profile_decode(torch, "yi-9b gated, every step full", SlotEngine(
        cfg_m1, capacity=4, max_len=160, chunk=8, gated=True), params,
        prompts)
    return gated2


def serve_alone(torch, cfg, params, prompt, seed, **engine_kw):
    """One seeded 24-token request served alone (it lands in slot 0): its
    tokens."""
    from repro_torch.configs.base import RunConfig
    from repro_torch.serve.engine import SlotEngine
    from repro_torch.serve.scheduler import Request, serve

    req = Request(rid=0, prompt=prompt, max_new_tokens=24, seed=seed)
    engine = SlotEngine(RunConfig(arch=cfg), capacity=4, max_len=160,
                        chunk=8, prompt_bucket=16, **engine_kw)
    serve(engine, params, [req])
    return req.tokens


def teacher_logits(torch, cfg, params, prompt, tokens):
    """Teacher-forced batch-1 decode of ``prompt`` along greedy ``tokens``
    (a cache of the engine's 160 positions; every kernel keeps a row's
    bits whatever the batch, so the logits are the engine's row's): the
    logits [len(tokens), V] each token was picked from (fp32). Asserts
    each token is its step's argmax."""
    from repro_torch.models import lm
    from repro_torch.serve.engine import _select

    cache = lm.init_cache(cfg, 1, 160)
    pr = torch.as_tensor(prompt, device="cuda")[None]
    logits, cache = lm.forward_prefill(params, pr, cfg, "auto", cache)
    rows = []
    for j, t in enumerate(tokens):
        row = logits[0]
        assert int(row.argmax()) == t, (j, int(row.argmax()), t)
        rows.append(row.float())
        if j + 1 < len(tokens):
            tok = torch.tensor([[t]], dtype=torch.int32, device="cuda")
            lg, exits, cache = lm.forward_decode(params, tok, cfg, "auto",
                                                 cache)
            logits, _ = _select(lg, exits, cfg, "auto")
    return torch.stack(rows)


def greedy_ties(torch, cfg, params, prompt, tokens):
    """At each of greedy ``tokens`` (``teacher_logits``), whether its
    step's top logit is tied exactly."""
    rows = teacher_logits(torch, cfg, params, prompt, tokens)
    return ((rows == rows.max(-1, keepdim=True).values).sum(-1) > 1).tolist()


def check_sampler_tv(torch, cfg, params, prompts, kw, draws: int = 4096):
    """The sampler alone on 4 rows of the model's own logits (the last
    prefill position of ``prompts[:4]``, bf16 [4, V]) at the sampling
    settings ``kw``: ``draws`` draws a row (one generator a row, seeded)
    against ``make_probs``. Each row's total variation distance between
    the draws' frequencies and the probabilities must stay within the
    99.99th percentile of the same distance under the multinomial null
    (20000 multinomial samples of ``draws`` from the probabilities, numpy,
    seed 0). Prints each row's distance, bound and support."""
    import numpy as np

    from repro_torch.models import lm
    from repro_torch.serve.engine import (gumbel_noise, make_probs,
                                          make_sampler)

    rows = []
    for pr in prompts[:4]:
        cache = lm.init_cache(cfg, 1, len(pr))
        lg, _ = lm.forward_prefill(params, torch.as_tensor(
            pr, device="cuda")[None], cfg, "auto", cache)
        rows.append(lg[0])
    logits = torch.stack(rows)                              # [4, V]
    v = logits.shape[-1]
    probs = make_probs(**kw)(logits)
    sampler = make_sampler(**kw)
    gens = [torch.Generator(device="cuda").manual_seed(70 + r)
            for r in range(4)]
    counts = torch.zeros(4, v, device="cuda")
    chunk = 256
    for _ in range(draws // chunk):
        noise = gumbel_noise(gens, (chunk, v), "cuda")      # [4, chunk, V]
        toks = sampler(logits[:, None].expand(4, chunk, v), noise)
        counts.scatter_add_(1, toks.long(),
                            torch.ones_like(toks, dtype=counts.dtype))
    freq = (counts / draws).double().cpu().numpy()
    p = probs.double().cpu().numpy()
    rng = np.random.default_rng(0)
    lines = []
    for r in range(4):
        support = np.flatnonzero(p[r] > 0)
        pr = p[r, support] / p[r, support].sum()
        null = 0.5 * np.abs(rng.multinomial(draws, pr, size=20000) / draws
                            - pr).sum(-1)
        bound = float(np.quantile(null, 0.9999))
        tv = 0.5 * float(np.abs(freq[r] - p[r]).sum())
        assert freq[r][p[r] == 0].sum() == 0, r        # never off-support
        assert tv <= bound, (r, tv, bound)
        lines.append(f"row {r}: TV {tv:.4f} <= {bound:.4f} "
                     f"(support {support.size})")
    print(f"sampler alone, {kw}, {draws} draws a row of [4, {v}] logits "
          f"against make_probs (bound: the multinomial null's 99.99th "
          f"percentile): " + "; ".join(lines), flush=True)


SAMPLING = dict(temperature=0.7, top_k=50, top_p=0.9)


def run_sampling(torch, run_serve, cfg, params, prompts, greedy):
    """Phase 6e: sampled decode on full-width yi-9b (``greedy``: phase 4's
    run), temperature 0.7, top-k 50, top-p 0.9, the 6 requests seeded:
    a second run's tokens equal, bitwise, and the same launches as greedy
    (the sampler is plain PyTorch); request 1 served alone (slot 0 of an
    empty engine) equals its tokens co-batched in slot 1, bitwise; at
    temperature 1e-4 the tokens equal phase 4's greedy tokens up to each
    request's first step whose greedy logits tie exactly at the top (bf16
    logits tie there; the sampler splits a tie at random, argmax takes the
    first index), and such a step must be a tie; the sampler alone within
    a total-variation bound of ``make_probs`` (``check_sampler_tv``)."""
    seeds = [1000 + i for i in range(6)]
    a = run_serve("sampled", cfg, params, prompts, seeds=seeds, **SAMPLING)
    b = run_serve("sampled-again", cfg, params, prompts, seeds=seeds,
                  **SAMPLING)
    assert a["tokens"] == b["tokens"], "sampled run does not replay"
    assert a["tokens"] != greedy["tokens"], "sampled == greedy"
    assert a["launches"] == greedy["launches"], (a["launches"],
                                                 greedy["launches"])
    alone = serve_alone(torch, cfg, params, prompts[1], seeds[1], **SAMPLING)
    assert alone == a["tokens"][1], ("seeded request depends on placement",
                                     alone, a["tokens"][1])
    print("serve sampled: a second run's tokens equal, bitwise; request 1 "
          "alone (slot 0) == co-batched (slot 1), bitwise; launches == "
          "greedy's", flush=True)
    cold = run_serve("sampled-t1e-4", cfg, params, prompts,
                     temperature=1e-4)
    parted = []
    for i, (got, want) in enumerate(zip(cold["tokens"], greedy["tokens"])):
        if got != want:          # only at a step whose top logit is tied
            first = next(j for j, (x, y) in enumerate(zip(got, want))
                         if x != y)
            ties = greedy_ties(torch, cfg, params, prompts[i], want)
            assert ties[first], (i, first, got, want)
            parted.append((i, first))
    print(f"serve sampled-t1e-4: {6 - len(parted)} of 6 requests == phase "
          f"4's greedy tokens, bitwise; (request, step) parting at an exact "
          f"top tie of the greedy logits: {parted}", flush=True)
    check_sampler_tv(torch, cfg, params, prompts, SAMPLING)


def run_sampled_spec(torch, run_serve, cfg_ne, params, prompts):
    """Phase 6f: sampled speculative decoding on yi-9b without its exits
    (phase 6's config), the 6 requests seeded, at phase 6e's settings: a
    tied draft on the paged engine accepts every proposal (p == q bitwise:
    verify row i equals decode); the 2-layer draft (contiguous) replays
    bitwise, and request 1 alone equals it co-batched, bitwise;
    verify_decode(_paged) on every layer a round. Returns the runs."""
    from repro_torch.serve.engine import SpecConfig

    seeds = [2000 + i for i in range(6)]
    nl = cfg_ne.num_layers
    tied = run_serve("sampled-spec-tied-paged", cfg_ne, params, prompts,
                     seeds=seeds, paged=True, page_size=16, num_pages=25,
                     spec=SpecConfig(draft_arch=cfg_ne, k=3,
                                     share_params=True), **SAMPLING)
    assert tied["report"].stats["spec_acceptance"] == 1.0, \
        tied["report"].stats
    assert tied["launches"]["verify_decode_paged"] == nl * tied["steps"]
    draft = dataclasses.replace(cfg_ne, name="yi-9b-draft-2l", num_layers=2)
    spec = SpecConfig(draft_arch=draft, k=3, draft_seed=1)
    runs = [run_serve(f"sampled-spec-draft2l-{i}", cfg_ne, params, prompts,
                      seeds=seeds, spec=spec, **SAMPLING) for i in (1, 2)]
    assert runs[0]["tokens"] == runs[1]["tokens"], "sampled spec differs"
    assert runs[0]["launches"]["verify_decode"] == nl * runs[0]["steps"]
    alone = serve_alone(torch, cfg_ne, params, prompts[1], seeds[1],
                        spec=spec, **SAMPLING)
    assert alone == runs[0]["tokens"][1], ("sampled spec depends on "
                                           "placement", alone,
                                           runs[0]["tokens"][1])
    print(f"serve sampled spec: tied (paged) acceptance "
          f"{tied['report'].stats['spec_acceptance']:.3f}; 2-layer draft "
          f"replays bitwise, request 1 alone == co-batched, bitwise; "
          f"acceptance {runs[0]['report'].stats['spec_acceptance']:.3f}",
          flush=True)


# -- phase 5b: prefix sharing and chunked prefill ----------------------------

# a fork-point admission's first-token logits against the unshared
# prefill's of the same prompt, as ``check_prefill`` holds the kernels
# against the plain path: rel L2 under SHARE_MAX_REL, and no further from
# the fp32 prefill than SHARE_FP32_RATIO x the unshared prefill (means
# over a run's admissions). The shared suffix attends in fp32 (as JAX),
# the flash kernel rounds P to bf16, and 48 layers carry each rounding on:
# single logits part by more than a single kernel's 1e-2 + 1e-2 |ref|
# (phase 5b prints the largest difference)
SHARE_MAX_REL, SHARE_FP32_RATIO = 5e-2, 1.5


def sharing_prompts(vocab: int, seed: int = 12):
    """Phase 5b's 8 prompts from a seeded numpy generator: 6 open with one
    64-token prefix (4 full pages of 16) and go on with suffixes of 1-40
    tokens; 2 share a 70-token stem of their own (4 pages and 6 rows of a
    fifth) and part there, with tails of 12 and 18 tokens, so the second
    is admitted at a copy-on-write fork (rem 6)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    common = rng.integers(0, vocab, 64)
    stem = rng.integers(0, vocab, 70)
    out = [np.concatenate([common, rng.integers(0, vocab, n)])
           for n in (1, 40, 9, 23, 16, 33)]
    out += [np.concatenate([stem, rng.integers(0, vocab, n)])
            for n in (12, 18)]
    return [p.astype(np.int32) for p in out]


def shared_prefill_launches(cfg, head: bool = True):
    """Kernel launches of one fork-point prefill on a dense GQA arch: each
    layer's seven GEMMs and its norms (two; four with a QK-norm), then the
    final norm and the unembedding with ``head``; no flash attention (the
    suffix attends in plain PyTorch, as JAX computes it)."""
    nl = cfg.num_layers
    return {"gemm": 7 * nl + int(head),
            "rmsnorm": (4 if cfg.qk_norm else 2) * nl + int(head)}


def _rows(torch, pool, row, positions, ps):
    """Rows [len(positions), Hkv, D] of one layer's pool [P, Hkv, ps, D]
    at absolute ``positions`` through a page-table ``row``."""
    pos = torch.as_tensor(positions, device=pool.device)
    page = torch.as_tensor(row, device=pool.device).long()[pos // ps]
    return pool[page, :, pos % ps]


class SharingProbe:
    """Holds each fork-point admission of a sharing engine as it happens.
    ``install`` (``serve_run``'s ``on_engine``) wraps the engine's
    ``copy_page`` and ``prefill_into_shared`` on the instance and spies on
    ``lm.forward_prefill_shared`` for the logits until ``close``. Per
    admission, bitwise: every layer's shared prefix pages unchanged across
    it; after a copy-on-write the first ``rem`` rows of region page 0
    equal the donor's, and the donor page unchanged; and its launches
    exactly ``shared_prefill_launches``. Kept for ``check_admissions``:
    the prompt, its bucket, the fork point, layer 0's K/V rows at the
    suffix positions and the first-token logits. The wrappers only copy
    and compare tensors: no counted kernel runs in them."""

    def __init__(self, torch, cfg):
        self.torch, self.cfg = torch, cfg
        self.admissions, self.cows = [], 0
        self._cow, self._logits, self._restore = None, None, None

    def install(self, engine):
        import numpy as np

        from repro_torch.core import xaif
        from repro_torch.models import lm

        torch, ps = self.torch, engine.page_size
        copy0, shared0 = engine.copy_page, engine.prefill_into_shared
        spied = lm.forward_prefill_shared

        def spy(*args, **kw):
            logits, cache = spied(*args, **kw)
            if logits is not None:
                self._logits = logits.float().clone()
            return logits, cache

        def copy_page(cache, src, dst):
            donor = [pool[:, src].clone() for pool in cache.pools]
            cache = copy0(cache, src, dst)
            self._cow = (int(src), int(dst), donor)
            return cache

        def prefill_into_shared(params, cache, st, prompt, start, slot,
                                max_new, prefix_ids, region_ids, row,
                                seed=None):
            pre = torch.as_tensor(np.asarray(prefix_ids, np.int64),
                                  device="cuda")
            before = [pool[:, pre].clone() for pool in cache.pools]
            before_n = xaif.launch_counts()
            out = shared0(params, cache, st, prompt, start, slot, max_new,
                          prefix_ids, region_ids, row, seed)
            after_n = xaif.launch_counts()
            launches = {k: n - before_n.get(k, 0) for k, n in
                        after_n.items() if n != before_n.get(k, 0)}
            want = shared_prefill_launches(self.cfg)
            assert launches == want, (launches, want)
            pools = out[0].pools
            assert all(torch.equal(p[:, pre], b)
                       for p, b in zip(pools, before)), \
                "a shared prefix page was written"
            rem = start - len(pre) * ps
            if self._cow is not None:
                src, dst, donor = self._cow
                self._cow = None
                assert dst == int(region_ids[0]) and rem > 0, (dst, rem)
                for p, d in zip(pools, donor):
                    assert torch.equal(p[:, dst, :, :rem], d[:, :, :rem]), \
                        "COW rows differ from the donor's"
                    assert torch.equal(p[:, src], d), "the donor was written"
                self.cows += 1
            t = len(prompt)
            suffix = list(range(start, t))
            self.admissions.append(dict(
                prompt=np.asarray(prompt), start=start, rem=rem,
                bucket=engine._bucket(t), logits=self._logits,
                k0=_rows(torch, pools[0][0], row, suffix, ps).clone(),
                v0=_rows(torch, pools[1][0], row, suffix, ps).clone()))
            return out

        engine.copy_page = copy_page
        engine.prefill_into_shared = prefill_into_shared
        lm.forward_prefill_shared = spy
        self._restore = (lm, spied)

    def close(self):
        if self._restore is not None:
            lm, spied = self._restore
            lm.forward_prefill_shared = spied
            self._restore = None


def prefill_refs(torch, cfg, params, prompt, bucket, refs):
    """The unshared paged engine's prefill of ``prompt`` (``prefill_into``'s
    bucketed batch-1 ``forward_prefill``, rerun: the same inputs give the
    same bits) and the fp32 yardstick (the plain policy computing in fp32
    on the same weights): (logits, layer-0 K and V [Hkv, T, D], fp32
    logits), kept in ``refs`` by prompt."""
    from repro_torch.models import lm

    key = prompt.tobytes()
    if key not in refs:
        t = len(prompt)
        padded = torch.zeros(1, bucket, dtype=torch.int32)
        padded[0, :t] = torch.from_numpy(prompt)
        lengths = torch.tensor([t], dtype=torch.int32, device="cuda")
        out = []
        for c, policy in ((cfg, "auto"),
                          (dataclasses.replace(cfg, dtype="float32"), "ref")):
            cache = lm.init_cache(c, 1, bucket)
            with torch.inference_mode():
                logits, cache = lm.forward_prefill(
                    params, padded.cuda(), c, policy, cache, lengths=lengths)
            out.append((logits.float(), cache.k[0, 0, :, :t],
                        cache.v[0, 0, :, :t]))
            del cache
        refs[key] = (out[0][0], out[0][1], out[0][2], out[1][0])
    return refs[key]


def check_admissions(torch, cfg, params, admissions, refs):
    """Each recorded fork-point admission against the unshared paged
    engine's prefill of the same prompt (``prefill_refs``): layer 0's K/V
    rows at the suffix positions bitwise (layer 0 runs embed, rmsnorm, the
    GEMMs and rotary, and each keeps a row's bits whatever M); the
    first-token logits within SHARE_MAX_REL (rel L2) and, on average, no
    further from the fp32 prefill than SHARE_FP32_RATIO x the unshared
    prefill. Returns the numbers: rel L2 max, mean to fp32 of both, the
    largest and the RMS logit difference."""
    def rel(a, b):
        return float((a - b).norm() / b.norm())

    r_su, r_sf, r_uf, worst, sq, n = [], [], [], 0.0, 0.0, 0
    for a in admissions:
        t = len(a["prompt"])
        ref, k0, v0, f32 = prefill_refs(torch, cfg, params, a["prompt"],
                                        a["bucket"], refs)
        for got, want in ((a["k0"], k0), (a["v0"], v0)):
            assert torch.equal(got, want[:, a["start"]:t].transpose(0, 1)), (
                "layer-0 suffix K/V differ from the unshared prefill's",
                t, a["start"])
        got = a["logits"]
        r_su.append(rel(got, ref))
        r_sf.append(rel(got, f32))
        r_uf.append(rel(ref, f32))
        worst = max(worst, float((got - ref).abs().max()))
        sq += float((got - ref).pow(2).sum())
        n += got.numel()
    out = dict(rel_max=max(r_su), to_fp32=sum(r_sf) / len(r_sf),
               unshared_to_fp32=sum(r_uf) / len(r_uf), max_diff=worst,
               rms=(sq / n) ** 0.5)
    assert out["rel_max"] < SHARE_MAX_REL, (r_su, out)
    assert out["to_fp32"] <= SHARE_FP32_RATIO * out["unshared_to_fp32"], out
    return out


def near_tie_parts(torch, cfg, params, prompts, got, want, rms, seen=None):
    """Greedy ``got`` tokens against ``want`` (a run whose logits come from
    another attention's rounding, ``rms`` apart on the first tokens): each
    request either equals whole, or parts at a step j where ``want``'s
    logits (``teacher_logits``, kept in ``seen`` by request) hold
    ``got[j]`` within max(0.1, 5 x rms) of ``want[j]``: a near tie
    rounding may split either way, by ``check_prefill``'s rule for a
    prompt that is not clear. Returns the parted (request, step, logit
    gap, exact tie); asserts the rest."""
    thr = max(0.1, 5 * rms)
    seen = {} if seen is None else seen
    parted = []
    for i, (g, w) in enumerate(zip(got, want)):
        if g == w:
            continue
        j = next(k for k, (x, y) in enumerate(zip(g, w)) if x != y)
        if i not in seen:
            seen[i] = teacher_logits(torch, cfg, params, prompts[i], w)
        rows = seen[i]
        top, other = float(rows[j, w[j]]), float(rows[j, g[j]])
        assert top - other <= thr, (i, j, top, other, thr)
        parted.append((i, j, round(top - other, 5), top == other))
    return parted


def run_sharing(torch, run_serve, name, cfg, params, small_pool=None):
    """Phase 5b (and 12e's sharing run): the 8 ``sharing_prompts`` through
    the paged engine (pages of 16, 24 usable) without sharing, then with
    ``prefix_sharing=True`` twice (the second must replay the first's
    tokens bitwise) and, with ``small_pool``, once more on a pool just
    above the live working set, where admission evicts index pages. Each
    sharing run: every admission probed (``SharingProbe``,
    ``check_admissions``: layer-0 K/V bitwise, first-token logits), at
    least 5 fork-point admissions and a COW one
    (24-page runs), fewer prefill tokens than without sharing, launches
    exactly ``zoo_launches`` of its standard admissions and decode steps
    plus ``shared_prefill_launches`` a fork-point admission, and the
    tokens of the run without sharing up to a near tie
    (``near_tie_parts``). Returns the runs."""
    prompts = sharing_prompts(cfg.vocab_size)
    refs, seen = {}, {}
    paged = dict(paged=True, page_size=16)
    off = run_serve(f"{name}-share-off", cfg, params, prompts,
                    num_pages=25, **paged)
    assert "attention" in off["launches"], off["launches"]
    runs = {}
    pools = [("share", 25), ("share-again", 25)]
    if small_pool is not None:
        pools.append(("share-evict", small_pool))
    for label, pool in pools:
        probe = SharingProbe(torch, cfg)
        try:
            run = run_serve(f"{name}-{label}", cfg, params, prompts,
                            num_pages=pool, prefix_sharing=True,
                            on_engine=probe.install, **paged)
        finally:
            probe.close()
        stats = run["report"].stats
        n_shared = int(stats["shared_admissions"])
        assert n_shared == len(probe.admissions), (n_shared,
                                                   len(probe.admissions))
        assert n_shared >= 5, stats
        assert stats["prefill_tokens"] < off["report"].stats[
            "prefill_tokens"], (stats, off["report"].stats)
        if pool == 25:
            assert probe.cows >= 1, "no copy-on-write admission"
        else:
            assert stats["index_evictions"] > 0, stats
        want = zoo_launches(cfg, run["steps"], run["prefills"], paged=True)
        for k, n in shared_prefill_launches(cfg).items():
            want[k] += n_shared * n
        assert run["launches"] == want, (run["launches"], want)
        num = check_admissions(torch, cfg, params, probe.admissions, refs)
        parted = near_tie_parts(torch, cfg, params, prompts, run["tokens"],
                                off["tokens"], num["rms"], seen)
        runs[label] = run
        print(f"serve {name}-{label} ({pool - 1} usable pages): "
              f"{n_shared} fork-point admissions ({probe.cows} COW), "
              f"{int(stats['shared_tokens'])} prompt tokens from resident "
              f"pages, prefill tokens {int(stats['prefill_tokens'])} "
              f"against {int(off['report'].stats['prefill_tokens'])} "
              f"unshared; index {int(stats['index_pages'])} pages, "
              f"{int(stats['index_evictions'])} evicted; bitwise: shared "
              f"pages untouched, COW rows == donor's, layer-0 suffix K/V "
              f"== the unshared prefill's; first-token logits rel L2 max "
              f"{num['rel_max']:.3e} (bound {SHARE_MAX_REL}), to fp32 "
              f"{num['to_fp32']:.3e} against the unshared prefill's "
              f"{num['unshared_to_fp32']:.3e}, max diff "
              f"{num['max_diff']:.4f}, RMS {num['rms']:.4f}; "
              f"launches exact, {shared_prefill_launches(cfg)} and no "
              f"flash a fork-point admission; {8 - len(parted)} of 8 "
              f"requests == unshared tokens whole, parted (request, step, "
              f"gap, exact tie) {parted}", flush=True)
    assert runs["share-again"]["tokens"] == runs["share"]["tokens"], \
        "a second sharing run does not replay"
    return runs


def run_chunked(torch, cfg, params):
    """Phase 5b's chunked prefill on yi-9b: a 128-token prompt (numpy seed
    13) goes in as one 64-token ``prefill_chunk`` (no head) and
    ``prefill_into_shared`` for the other 64, into 8 pages of one slot;
    launches exactly ``shared_prefill_launches`` (no head, then head);
    layer 0's K/V at all 128 positions == the full prefill's, bitwise,
    the logits held as ``check_admissions`` holds them; then 24 tokens
    decoded, == ``generate``'s up to a near tie (``near_tie_parts``)."""
    import numpy as np

    from repro_torch.core import xaif
    from repro_torch.models import lm
    from repro_torch.serve.engine import SlotEngine, generate
    from repro_torch.serve.paging import PageAllocator

    prompt = np.random.default_rng(13).integers(
        0, cfg.vocab_size, 128).astype(np.int32)
    engine = SlotEngine(cfg, capacity=4, max_len=160, chunk=8, paged=True,
                        page_size=16)
    cache, st = engine.init_state()
    alloc = PageAllocator(engine.num_pages, 4, engine.max_pages, 16)
    ids = alloc.admit(0, bucket_len=128, true_len=128, max_new=24)
    row = alloc.table[0]
    probe = SharingProbe(torch, cfg)
    probe.install(engine)
    try:
        xaif.reset_launch_counts()
        cache = engine.prefill_chunk(params, cache, prompt[:64], 0, 0, [],
                                     ids[:4], row)
        chunk_n = {k: n for k, n in xaif.launch_counts().items() if n}
        cache, st, tok0 = engine.prefill_into_shared(
            params, cache, st, prompt, 64, 0, 24, ids[:4], ids[4:], row)
    finally:
        probe.close()
    assert chunk_n == shared_prefill_launches(cfg, head=False), chunk_n
    assert engine.prefill_tokens == 128, engine.prefill_tokens
    num = check_admissions(torch, cfg, params, probe.admissions, {})
    full = lm.init_cache(cfg, 1, 128)
    with torch.inference_mode():
        _, full = lm.forward_prefill(params, torch.from_numpy(prompt)[None]
                                     .cuda(), cfg, "auto", full)
    for pool, ref in zip(cache.pools, (full.k, full.v)):
        got = _rows(torch, pool[0], row, list(range(128)), 16)
        assert torch.equal(got, ref[0, 0].transpose(0, 1)), \
            "chunked layer-0 K/V differ from the full prefill's"
    tokens = [int(tok0)]
    while len(tokens) < 24:
        steps = min(engine.chunk, 24 - len(tokens))
        alloc.ensure(0, 128 + len(tokens) - 1 + steps - 1)
        cache = engine.set_page_table(cache, alloc.table)
        seen = int(st.generated[0])
        cache, st, toks = engine.decode(params, cache, st)
        tokens += toks[0, :int(st.generated[0]) - seen].tolist()
    want, _ = generate(cfg, params, prompt[None], 24)
    parted = near_tie_parts(torch, cfg, params, [prompt], [tokens],
                            [want[0].tolist()], num["rms"])
    assert len(probe.admissions) == 1, probe.admissions
    print(f"chunked prefill {cfg.name}: 64 + 64 tokens, launches "
          f"{chunk_n} for the chunk and {shared_prefill_launches(cfg)} for "
          f"the rest; layer-0 K/V of all 128 positions == the full "
          f"prefill's, bitwise; first-token logits rel L2 "
          f"{num['rel_max']:.3e}, to fp32 {num['to_fp32']:.3e} against the "
          f"full prefill's {num['unshared_to_fp32']:.3e}, max diff "
          f"{num['max_diff']:.4f}; 24 decoded tokens == generate "
          f"{'whole' if not parted else f'up to a near tie {parted}'}",
          flush=True)


def time_admission(torch, cfg, params, card):
    """The device time of one fork-point admission against the standard
    admission of the same prompt: ``sharing_prompts()[1]`` (64 shared and
    40 suffix tokens: a suffix bucket of 48 against a bucket of 112) into
    slots of one paged engine, the donor's 64 tokens admitted first. After
    2 warm-up calls each, 6 in turns (standard, shared, shared,
    standard, ...): the span a call by CUDA events (host launch gaps
    included), then 5 of each under torch.profiler: the device kernel
    time a call and the kernels a call. A measurement, printed."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve.engine import SlotEngine
    from repro_torch.serve.paging import PageAllocator

    prompts = sharing_prompts(cfg.vocab_size)
    donor, p = prompts[0], prompts[1]
    engine = SlotEngine(cfg, capacity=4, max_len=160, chunk=8, paged=True,
                        page_size=16, prefix_sharing=True)
    cache, st = engine.init_state()
    alloc = PageAllocator(engine.num_pages, 4, engine.max_pages, 16,
                          sharing=True)
    t0 = len(donor)
    ids0 = alloc.admit(0, engine._bucket(t0), t0, 24)
    cache, st, _ = engine.prefill_into(params, cache, st, donor, 0, 24,
                                       page_ids=ids0)
    alloc.register(donor, 0)
    t = len(p)
    ids1 = alloc.admit(1, engine._bucket(t), t, 24)
    pages, _, _ = alloc.match(p)
    start = len(pages) * 16
    pre, reg = alloc.admit_shared(2, pages, None, 0, engine._bucket(t - start),
                                  t, 24)
    calls = {
        "standard": lambda: engine.prefill_into(params, cache, st, p, 1, 24,
                                                page_ids=ids1),
        "shared": lambda: engine.prefill_into_shared(
            params, cache, st, p, start, 2, 24, pre, reg, alloc.table[2])}
    for fn in calls.values():
        for _ in range(2):
            fn()
    spans = {k: [] for k in calls}
    for i in range(6):
        for name in (("standard", "shared") if i % 2 == 0 else
                     ("shared", "standard")):
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            torch.cuda.synchronize()
            a.record()
            calls[name]()
            b.record()
            torch.cuda.synchronize()
            spans[name].append(a.elapsed_time(b))
    dev, kernels = {}, {}
    for name, fn in calls.items():
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                fn()
            torch.cuda.synchronize()
        evs = [e for e in prof.key_averages()
               if e.device_type.name == "CUDA"
               and (getattr(e, "self_device_time_total", 0) or 0) > 0]
        dev[name] = sum(e.self_device_time_total for e in evs) / 1e3 / 5
        kernels[name] = sum(e.count for e in evs
                            if not e.key.startswith(("Memcpy", "Memset")))
        kernels[name] /= 5
    med = {k: statistics.median(v) for k, v in spans.items()}
    print(f"admission {cfg.name}, a {t}-token prompt: standard (bucket "
          f"{engine._bucket(t)}) {med['standard']:.3f} ms a call by CUDA "
          f"events (median of 6 in turns; "
          f"{[round(x, 3) for x in spans['standard']]}), device "
          f"{dev['standard']:.3f} ms and {kernels['standard']:.0f} kernels "
          f"a call; fork-point (64 shared, suffix bucket "
          f"{engine._bucket(t - start)}) {med['shared']:.3f} ms "
          f"({[round(x, 3) for x in spans['shared']]}), device "
          f"{dev['shared']:.3f} ms and {kernels['shared']:.0f} kernels a "
          f"call; on {card}", flush=True)
    return med, dev


# -- phase 5c: overload control ----------------------------------------------

# phase 5c's pool: 17 usable pages of 16 for 4 slots whose worst case is
# 4 x 10 pages (under half of it); the stream of ``overload_prompts``
# preempts on it (the scheduler's decisions depend on lengths, pages and
# priorities only, so a CPU run of the same geometry predicts them)
OVERLOAD_POOL = 18
OVERLOAD_PRIORITIES = (0, 2, 1, 0, 2, 1, 0, 1)


def overload_prompts(vocab: int, seed: int = 14):
    """Phase 5c's 8 prompts from a seeded numpy generator: 20-128 tokens
    (the first 128: 8 pages of 16, two 64-token chunks)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).astype(np.int32)
            for n in (128, 40, 72, 20, 100, 56, 33, 90)]


class OverloadProbe:
    """Holds the overload scheduler of one serve run as it works.
    ``install`` (``serve_run``'s ``on_engine``) wraps the engine's
    ``fetch_pages`` / ``restore_pages`` / ``prefill_chunk`` on the instance
    and replaces ``serve/overload.py``'s ``OverloadScheduler`` by a
    subclass that records each chunked admission and each resume (swap or
    recompute, and how many tokens the request had then) until ``close``.
    Every swap-out and swap-in is timed by CUDA events (the span of the
    call, the copy between host and card included); after each swap-in the
    restored pages are gathered back from their new ids and must equal the
    fetched blocks, bitwise. The wrappers only copy and compare tensors:
    no counted kernel runs in them."""

    def __init__(self, torch):
        self.torch = torch
        self.chunks, self.outs, self.ins, self.scheds = 0, [], [], []
        self._restore = None

    def _timed(self, fn):
        torch = self.torch
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        a.record()
        out = fn()
        b.record()
        torch.cuda.synchronize()
        return out, a.elapsed_time(b)

    def install(self, engine):
        import numpy as np

        from repro_torch.models import lm
        from repro_torch.serve import overload
        from repro_torch.serve.scheduler import ADMITTED

        torch, probe = self.torch, self
        fetch0, restore0 = engine.fetch_pages, engine.restore_pages
        chunk0 = engine.prefill_chunk

        def nbytes(blocks):
            return sum(b.numel() * b.element_size() for b in blocks)

        def fetch_pages(cache, page_ids):
            blocks, ms = self._timed(lambda: fetch0(cache, page_ids))
            assert all(not b.is_cuda for b in blocks), "blocks on the card"
            self.outs.append(([int(i) for i in page_ids], ms,
                               nbytes(blocks)))
            return blocks

        def restore_pages(cache, page_ids, blocks):
            cache, ms = self._timed(lambda: restore0(cache, page_ids,
                                                     blocks))
            ids = torch.as_tensor(np.asarray(page_ids, np.int64),
                                  device="cuda")
            back = lm.gather_pages(cache, ids)
            assert all(torch.equal(g.cpu(), b)
                       for g, b in zip(back, blocks)), \
                "swapped-in pages differ from the fetched bytes"
            self.ins.append(([int(i) for i in page_ids], ms,
                              nbytes(blocks)))
            return cache

        def prefill_chunk(*args, **kw):
            self.chunks += 1
            return chunk0(*args, **kw)

        base = overload.OverloadScheduler

        class Recorded(base):
            def __init__(self, *args, **kw):
                super().__init__(*args, **kw)
                self.chunked_rids, self.resumed = set(), []
                probe.scheds.append(self)

            def _start_chunked(self, req, now, t):
                res = super()._start_chunked(req, now, t)
                if res == ADMITTED:
                    self.chunked_rids.add(req.rid)
                return res

            def _resume(self, ent, now):
                kind = "swap" if ent.swap is not None else "recompute"
                had = len(ent.req.tokens)
                res = super()._resume(ent, now)
                if res == ADMITTED:
                    self.resumed.append((ent.req.rid, kind, had))
                return res

        engine.fetch_pages = fetch_pages
        engine.restore_pages = restore_pages
        engine.prefill_chunk = prefill_chunk
        overload.OverloadScheduler = Recorded
        self._restore = (overload, base)

    def close(self):
        if self._restore is not None:
            mod, base = self._restore
            mod.OverloadScheduler = base
            self._restore = None

    def drained(self):
        """The run's scheduler after the drain: nothing owned, reserved,
        queued, prefilling or swapped; every usable page free; every slot
        done on the card."""
        (sched,) = self.scheds
        al = sched.alloc
        assert not al.owned and not al.reserved and not al.refcnt, \
            (al.owned, al.reserved, al.refcnt)
        assert sorted(al.free) == list(range(1, al.num_pages)), al.free
        assert (al.table == -1).all()
        assert not sched.occupant and not sched.prefilling
        assert not sched.requeued and len(sched.swap_pool) == 0
        assert bool(sched.state.done.all())
        return sched


def recompute_rms(torch, cfg, params, prompts, want, resumed, seen, refs):
    """The RMS logit difference at recompute resumes: the re-prefill of
    prompt ++ the tokens the request had (``prefill_refs``: the engine's
    bucketed prefill through the flash kernel) against the uncontended
    run's decode logits at that step (``teacher_logits``, kept in
    ``seen``). None without a recompute resume."""
    import numpy as np

    sq, n = 0.0, 0
    for rid, kind, had in resumed:
        if kind != "recompute":
            continue
        ext = np.concatenate([prompts[rid], np.asarray(want[rid][:had],
                                                       np.int32)])
        bucket = min(-(-len(ext) // 16) * 16, 160)
        logits = prefill_refs(torch, cfg, params, ext, bucket, refs)[0][0]
        if rid not in seen:
            seen[rid] = teacher_logits(torch, cfg, params, prompts[rid],
                                       want[rid])
        d = logits - seen[rid][had]
        sq += float(d.pow(2).sum())
        n += d.numel()
    return (sq / n) ** 0.5 if n else None


def run_overload(torch, run_serve, cfg, params, card):
    """Phase 5c: overload control on full-width yi-9b, paged (pages of
    16). The 8 ``overload_prompts`` (24 new tokens each, seeded) served
    uncontended (the default pool: the worst case), then under
    ``OverloadConfig(mode="preempt")`` on ``OVERLOAD_POOL`` pages (17
    usable of the 40 the slots could ask for): with host swap, with
    ``swap=False`` (every resume a recompute), and with ``prefill_chunk=64``
    and mixed priorities (swap, recompute and chunked admissions); then a
    sampled pair (temperature 0.7, top-k 50, top-p 0.9), uncontended and
    with swap. Bars: >= 2 preemptions, >= 1 swap resume, >= 1 recompute
    resume, >= 1 chunked admission; every swapped-in block bitwise the
    fetched one (``OverloadProbe``); a request never chunk-admitted nor
    recompute-resumed == the uncontended run's tokens, bitwise (greedy and
    sampled: the sampled overload run must resume by swap only); the
    others == them up to a near tie (``near_tie_parts``, with the RMS of
    the recompute prefills against the decode logits they replace and of
    the chunked admissions, ``check_admissions``); launches exactly
    ``zoo_launches`` of the run's standard prefills and decode steps plus
    ``shared_prefill_launches`` of each chunk (no head) and each chunked
    tail; the pool drained clean. Prints the counts, the swap bytes' peak
    and one swap-out and one swap-in time."""
    from repro_torch.serve.overload import OverloadConfig

    t0 = time.perf_counter()
    prompts = overload_prompts(cfg.vocab_size)
    seeds = [300 + i for i in range(len(prompts))]
    kw = dict(paged=True, page_size=16, seeds=seeds)
    small = dict(kw, num_pages=OVERLOAD_POOL)
    base = run_serve("yi-9b-overload-uncontended", cfg, params, prompts,
                     **kw)
    want = base["tokens"]
    assert base["launches"] == zoo_launches(cfg, base["steps"],
                                            base["prefills"], paged=True)
    cases = (
        ("swap", dict(overload=OverloadConfig())),
        ("recompute", dict(overload=OverloadConfig(swap=False))),
        ("chunked", dict(overload=OverloadConfig(prefill_chunk=64),
                         priorities=OVERLOAD_PRIORITIES)))
    refs, seen, totals, probes = {}, {}, {}, {}
    for label, extra in cases:
        probe, share = OverloadProbe(torch), SharingProbe(torch, cfg)

        def install(engine, probe=probe, share=share):
            probe.install(engine)
            share.install(engine)
        try:
            run = run_serve(f"yi-9b-overload-{label}", cfg, params, prompts,
                            on_engine=install, **small, **extra)
        finally:
            probe.close()
            share.close()
        probes[label] = probe
        sched = probe.drained()
        st = run["report"].stats
        for k in ("preemptions", "swap_resumes", "recompute_resumes",
                  "chunked_admissions"):
            totals[k] = totals.get(k, 0) + int(st[k])
        assert len(probe.ins) == int(st["swap_resumes"]), (probe.ins, st)
        # a chunked admission preempted part-way never reaches its tail
        assert len(share.admissions) <= int(st["chunked_admissions"]), st
        assert bool(share.admissions) == bool(st["chunked_admissions"]), st
        want_n = zoo_launches(cfg, run["steps"], run["prefills"], paged=True)
        for k, n in shared_prefill_launches(cfg, head=False).items():
            want_n[k] += probe.chunks * n
        for k, n in shared_prefill_launches(cfg).items():
            want_n[k] += len(share.admissions) * n
        assert run["launches"] == want_n, (label, run["launches"], want_n)
        rms = [recompute_rms(torch, cfg, params, prompts, want,
                             sched.resumed, seen, refs)]
        if share.admissions:
            rms.append(check_admissions(torch, cfg, params, share.admissions,
                                        refs)["rms"])
        rms = max([r for r in rms if r is not None], default=0.0)
        loose = sched.chunked_rids | {rid for rid, kind, _ in sched.resumed
                                      if kind == "recompute"}
        for i, (g, w) in enumerate(zip(run["tokens"], want)):
            if i not in loose:
                assert g == w, (label, i, "a request differs from the "
                                "uncontended run", sched.resumed)
        order = sorted(loose)
        parted = [(order[j], *rest) for j, *rest in near_tie_parts(
            torch, cfg, params, [prompts[i] for i in order],
            [run["tokens"][i] for i in order], [want[i] for i in order],
            rms, {j: seen[i] for j, i in enumerate(order) if i in seen})]
        print(f"overload yi-9b-{label} ({OVERLOAD_POOL - 1} usable pages): "
              f"preemptions {int(st['preemptions'])}, swap outs "
              f"{int(st['swap_outs'])}, swap resumes "
              f"{int(st['swap_resumes'])}, recompute resumes "
              f"{int(st['recompute_resumes'])}, chunked admissions "
              f"{int(st['chunked_admissions'])} ({probe.chunks} chunks of "
              f"64), peak pages {int(st['peak_pages'])}, swap bytes peak "
              f"{int(st['swap_bytes_peak'])}; resumes (request, kind, "
              f"tokens then) {sched.resumed}; swapped-in pages == fetched "
              f"bytes, bitwise ({len(probe.ins)}); "
              f"{len(prompts) - len(loose)} requests == uncontended, "
              f"bitwise; {len(loose)} chunked or recomputed held to a near "
              f"tie (RMS {rms:.4f}), parted {parted}; launches exact; pool "
              f"drained", flush=True)
    sampled = dict(small, temperature=0.7, top_k=50, top_p=0.9)
    s_base = run_serve("yi-9b-overload-sampled-uncontended", cfg, params,
                       prompts, **dict(kw, temperature=0.7, top_k=50,
                                       top_p=0.9))
    probe = OverloadProbe(torch)
    try:
        s_run = run_serve("yi-9b-overload-sampled", cfg, params, prompts,
                          on_engine=probe.install,
                          overload=OverloadConfig(), **sampled)
    finally:
        probe.close()
    probe.drained()
    st = s_run["report"].stats
    assert st["swap_resumes"] >= 1 and st["recompute_resumes"] == 0, st
    assert s_run["tokens"] == s_base["tokens"], \
        "sampled swap-resumed tokens differ from the uncontended stream"
    assert s_run["tokens"] != want, "the sampled run drew greedy's tokens"
    for run in (s_base, s_run):
        want_n = zoo_launches(cfg, run["steps"], run["prefills"], paged=True)
        assert run["launches"] == want_n, (run["launches"], want_n)
    for k in ("preemptions", "swap_resumes"):
        totals[k] += int(st[k])
    assert totals["preemptions"] >= 2 and totals["swap_resumes"] >= 1, totals
    assert totals["recompute_resumes"] >= 1, totals
    assert totals["chunked_admissions"] >= 1, totals
    probes["sampled"] = probe
    (out_ids, out_ms, out_b), (in_ids, in_ms, in_b) = (probes["swap"].outs[0],
                                                        probes["swap"].ins[0])
    # every swap of the phase, in order (the first swap-out also pays the
    # first pinned host allocation of the process)
    outs = [(len(i), round(ms, 3)) for p in probes.values() for i, ms, _
            in p.outs]
    ins = [(len(i), round(ms, 3)) for p in probes.values() for i, ms, _
           in p.ins]
    print(f"overload yi-9b-sampled: {int(st['swap_resumes'])} swap resumes, "
          f"0 recompute; all 8 seeded requests' tokens == the uncontended "
          f"sampled run's, bitwise; launches exact; pool drained. Swap-out "
          f"of {len(out_ids)} pages ({out_b / 2**20:.1f} MiB, every layer's "
          f"K and V) {out_ms:.3f} ms by CUDA events "
          f"({out_b / out_ms / 1e6:.2f} GB/s), swap-in of {len(in_ids)} "
          f"pages (out of ids {out_ids}, into {in_ids}) "
          f"{in_ms:.3f} ms ({in_b / in_ms / 1e6:.2f} GB/s); every swap-out "
          f"(pages, ms) {outs}, swap-in {ins}; totals {totals}; phase 5c "
          f"{time.perf_counter() - t0:.1f} s on {card}", flush=True)
    return totals


# -- phase 5d: fault-tolerant serving ----------------------------------------

# the restart supervisor's snapshot cadence in phase 5d (decode chunks)
SNAPSHOT_EVERY = 2
# the watchdog's budget a chunk and the injected stall (1.5x): a chunk of 8
# yi-9b steps takes ~0.3-0.7 s of host clock (PERF.md section 5)
WATCHDOG_MS = 2000.0


def tensor_bytes(tree) -> int:
    """Bytes of every tensor in a tree of dicts, lists and tuples: an
    ``SlotEngine.snapshot`` (cache or pages, the decode state, the
    generators' states, a draft cache) or a device cache."""
    import torch

    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(tensor_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tensor_bytes(v) for v in tree)
    return 0


class SnapshotProbe:
    """Wraps one engine's ``snapshot`` and ``restore`` on the instance
    (``serve_run``'s ``on_engine``): each call's span by CUDA events (the
    copies between card and host included), each snapshot's host bytes
    and each restore's peak device allocation beyond what was allocated
    before it: a restore writes the snapshot back over the live cache in
    place, so that peak must stay under half the cache's bytes (a restore
    into a fresh cache would hold two caches at once). The wrappers copy
    nothing themselves and launch no counted kernel."""

    def __init__(self, torch):
        self.torch = torch
        self.snaps, self.restores = [], []   # (bytes, ms); (ms, peak bytes)
        # each restored snapshot's (tokens realized by decode, pages held)
        self.restored = []

    def _timed(self, fn, *args):
        torch = self.torch
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        out = fn(*args)
        b.record()
        b.synchronize()
        return out, a.elapsed_time(b)

    def install(self, engine):
        snapshot0, restore0 = engine.snapshot, engine.restore

        def snapshot(cache, st, alloc=None):
            snap, ms = self._timed(snapshot0, cache, st, alloc)
            self.snaps.append((tensor_bytes(snap), ms))
            return snap

        def restore(snap, cache, alloc=None):
            torch = self.torch
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            out, ms = self._timed(restore0, snap, cache, alloc)
            peak = torch.cuda.max_memory_allocated() - base
            self.restored.append((int(snap["state"]["tensors"].realized),
                                  sum(len(g) for g, _ in
                                      snap.get("pages", ()))))
            live = tensor_bytes(cache)
            assert peak < live / 2, ("a restore allocated", peak,
                                     "bytes beside a cache of", live)
            self.restores.append((ms, peak))
            return out

        engine.snapshot, engine.restore = snapshot, restore

    def line(self, report) -> str:
        """The snapshots of a non-empty stream (the first, pristine one
        copies no page) and the restores, as one phrase."""
        full = [s for s in self.snaps if s[0] == max(b for b, _ in
                                                      self.snaps)]
        ms = sorted(m for _, m in self.snaps[1:]) or [0.0]
        out = (f"{len(self.snaps)} snapshots, the largest "
               f"{full[0][0] / 2**20:.2f} MiB in {full[0][1]:.2f} ms, "
               f"median {statistics.median(ms):.2f} ms (CUDA events)")
        if self.restores:
            out += (f"; {len(self.restores)} restores, "
                    f"{', '.join(f'{m:.2f}' for m, _ in self.restores)} ms, "
                    f"a restore's peak new device allocation "
                    f"{max(b for _, b in self.restores) / 2**20:.2f} MiB; "
                    f"recovery_s_mean "
                    f"{report.stats['recovery_s_mean'] * 1e3:.2f} ms")
        return out


def extra_launches(run, ref):
    """The launch counts of ``run`` beyond those of ``ref`` (a replay's
    cost), nonzero entries only."""
    keys = set(run["launches"]) | set(ref["launches"])
    out = {k: run["launches"].get(k, 0) - ref["launches"].get(k, 0)
           for k in sorted(keys)}
    return {k: n for k, n in out.items() if n}


def supervised(torch, run_serve, name, cfg, params, prompts, ref, schedule,
               card, **kw):
    """One supervised stream (``serve_resilient`` at ``SNAPSHOT_EVERY``)
    with ``schedule`` injected: every fault fired, one restart a fault,
    100% completion (``serve_run`` asserts it) and the tokens of ``ref``
    (the uninterrupted run of the same engine), bitwise. Prints its
    snapshot and restore costs and its launches beyond ``ref``'s."""
    from repro_torch.serve.faults import FaultInjector

    probe = SnapshotProbe(torch)
    inj = FaultInjector(schedule=schedule)
    run = run_serve(name, cfg, params, prompts, on_engine=probe.install,
                    resilient=dict(snapshot_every=SNAPSHOT_EVERY,
                                   injector=inj), **kw)
    stats = run["report"].stats
    assert inj.fired == sum(len(v) for v in schedule.values()), (
        name, inj.calls, schedule)
    assert stats["restarts"] == inj.fired >= 1, stats
    assert run["tokens"] == ref["tokens"], f"{name}: tokens differ"
    # every restore brought back a snapshot taken after a decode chunk,
    # with pages when the engine snapshots pages
    assert all(n > 0 and (p > 0 or not kw.get("paged") or cfg.recurrent)
               for n, p in probe.restored), (name, probe.restored)
    print(f"resilient {name}: faults {schedule} fired, "
          f"{int(stats['restarts'])} restarts, 100% completion, tokens == "
          f"the uninterrupted run, bitwise; restored snapshots (tokens "
          f"decoded, pages) {probe.restored}; {probe.line(run['report'])}; "
          f"launches beyond the uninterrupted run "
          f"{extra_launches(run, ref)} on {card}", flush=True)
    return run


def quarantine_run(torch, name, cfg, params, prompts, ref, **engine_kw):
    """NaN quarantine: the first admission round (4 slots; 3 on the paged
    engine's 24 pages), one chunk decoded, slot 1's attention state
    poisoned with NaN in place (``poison_slot``: its first pool page, or
    its row), then drained. Only that request is shed (``nan-quarantined``,
    nothing emitted past the poison); the others, those backfilled into
    the freed slot and pages included, equal ``ref``'s tokens, bitwise."""
    from collections import deque

    from repro_torch.configs.base import RunConfig
    from repro_torch.serve.engine import SlotEngine
    from repro_torch.serve.faults import poison_slot
    from repro_torch.serve.scheduler import REASON_NAN, Request, SlotScheduler

    engine = SlotEngine(RunConfig(arch=cfg), capacity=4, max_len=160, chunk=8,
                        prompt_bucket=16, **engine_kw)
    reqs = [Request(rid=i, prompt=pr, max_new_tokens=24)
            for i, pr in enumerate(prompts)]
    sched, waiting = SlotScheduler(engine, params), deque(reqs)
    sched.admission_round(waiting, 0.0, False)
    first = list(sched.occupant.values())
    victim = sched.occupant[1]
    sched.step_chunk(0.0)
    salvaged = len(victim.tokens)
    poisoned = list(sched.alloc.owned[1][:1]) if sched.alloc else []
    sched.cache = poison_slot(engine, sched.cache, 1, sched.alloc)
    while waiting or sched.busy:
        sched.admission_round(waiting, 0.0, False)
        if sched.busy:
            sched.step_chunk(0.0)
    torch.cuda.synchronize()
    assert victim.reject_reason.startswith(REASON_NAN + ":"), \
        victim.reject_reason
    assert len(victim.tokens) == salvaged, (salvaged, victim.tokens)
    for r in reqs:
        if r is not victim:
            assert r.reject_reason is None, (r.rid, r.reject_reason)
            assert r.tokens == ref["tokens"][r.rid], (name, r.rid)
    later = [r.rid for r in reqs if all(r is not f for f in first)]
    print(f"resilient {name}: request {victim.rid} poisoned after "
          f"{salvaged} tokens and shed ({victim.reject_reason}); the other "
          f"5 (requests {later} admitted after the poison, into the "
          f"scrubbed slot{' and pages ' + str(poisoned) if poisoned else ''}"
          f" among others) == the uninterrupted run, bitwise", flush=True)


def run_resilient(torch, run_serve, runs, cfg, params, prompts, card):
    """Phase 5d: fault-tolerant serving on full-width yi-9b (phase 4's 6
    requests of 24 tokens, capacity 4, chunks of 8, a snapshot every 2
    chunks). A supervised stream whose armed injector never fires launches
    exactly what the plain serve launches (contiguous and paged: a
    snapshot launches no kernel of the port) and gives its tokens. Kill
    and resume: contiguous, paged (24 usable pages of 16) and paged with
    prefix sharing (phase 5b's shared-prefix prompts, its first sharing run
    the greedy reference), greedy and seeded-sampled (phase 6e's settings),
    each one stream with one fault at every site the engine has (prefill,
    decode; page_alloc and swap when paged), held to the uninterrupted run
    bitwise. The backend site: rmsnorm routed through the ``chaos``
    backend, with a breaker (no restart, a trip) and without (a restart
    from a fault in the middle of a decode chunk), both == the chaos
    policy's run without an injector. The watchdog: a stall of 1.5x its
    budget at decode call 2. NaN quarantine, contiguous and paged
    (``quarantine_run``). Returns the runs of the never-firing streams."""
    from repro_torch.core import xaif
    from repro_torch.serve.faults import FaultInjector, chaos_backends

    t0 = time.perf_counter()
    paged = dict(paged=True, page_size=16, num_pages=25)
    seeds = [1000 + i for i in range(6)]     # phase 6e's
    never = {}
    for kind, ref, kw in (("contiguous", runs["contiguous"], {}),
                          ("paged", runs["paged"], paged)):
        probe = SnapshotProbe(torch)
        inj = FaultInjector(schedule={"decode": [10**6]})
        run = run_serve(f"resilient-never-{kind}", cfg, params, prompts,
                        on_engine=probe.install,
                        resilient=dict(snapshot_every=SNAPSHOT_EVERY,
                                       injector=inj), **kw)
        assert inj.fired == 0 and run["report"].stats["restarts"] == 0
        assert run["tokens"] == ref["tokens"], kind
        assert run["launches"] == ref["launches"], (run["launches"],
                                                    ref["launches"])
        never[kind] = run
        print(f"resilient never-{kind}: an armed injector that never fires; "
              f"tokens == the plain serve, launches exactly the plain "
              f"serve's; {probe.line(run['report'])}", flush=True)

    # kill and resume. The call counts run on across restarts, so a fault
    # early in a stream (inside the first admission, or inside the first
    # snapshot that holds pages) would replay it from the empty pristine
    # snapshot and shift every later index: each index below is one whose
    # restore brings back a snapshot taken after a decode chunk, holding
    # pages on a paged engine (found by a CPU run of the same geometry;
    # ``supervised`` asserts it). Contiguous: decode call 3 comes a chunk
    # after the snapshot of chunk 2, prefill call 4 is a backfill. Paged:
    # swap call 2 is inside the second snapshot, page_alloc 20 / 16 in a
    # later admission or growth (the allocator half mutated).
    contig_sites = {"prefill": [4], "decode": [3]}
    paged_sites = {"swap": [2], "decode": [2], "prefill": [6],
                   "page_alloc": [20]}
    prefix_sites = {"decode": [2], "prefill": [4], "swap": [2],
                    "page_alloc": [16]}
    share_prompts = sharing_prompts(cfg.vocab_size)
    share_seeds = [3000 + i for i in range(len(share_prompts))]
    sampled_ref = {
        "contiguous": runs["sampled"],
        "paged": run_serve("resilient-ref-paged-sampled", cfg, params,
                           prompts, seeds=seeds, **paged, **SAMPLING),
        "prefix": run_serve("resilient-ref-prefix-sampled", cfg, params,
                            share_prompts, seeds=share_seeds, **paged,
                            prefix_sharing=True, **SAMPLING)}
    assert sampled_ref["paged"]["tokens"] == runs["sampled"]["tokens"]
    for kind, sites, pr, sd, kw in (
            ("contiguous", contig_sites, prompts, seeds, {}),
            ("paged", paged_sites, prompts, seeds, paged),
            ("prefix", prefix_sites, share_prompts, share_seeds,
             dict(paged, prefix_sharing=True))):
        greedy_ref = (runs["yi-9b-share"] if kind == "prefix"
                      else runs[kind])
        supervised(torch, run_serve, f"resilient-{kind}-greedy", cfg, params,
                   pr, greedy_ref, sites, card, **kw)
        supervised(torch, run_serve, f"resilient-{kind}-sampled", cfg,
                   params, pr, sampled_ref[kind], sites, card, seeds=sd,
                   **kw, **SAMPLING)

    # the backend site: rmsnorm through the chaos backend (its plain
    # version behind the injector); the fault without a breaker falls in
    # the middle of the third decode chunk (4 prefills of 2L + 1 rmsnorm,
    # then 20 steps of 2L + 2)
    counters = set(xaif.launch_counts())
    with chaos_backends(("rmsnorm",)):
        chaos = xaif.Policy({"rmsnorm": "chaos"})
        ref = run_serve("resilient-chaos-ref", cfg, params, prompts,
                        policy=chaos)
        assert "rmsnorm" not in ref["launches"], ref["launches"]
        breaker = xaif.CircuitBreaker()
        inj = FaultInjector(schedule={"backend": [0]})
        run = run_serve("resilient-chaos-breaker", cfg, params, prompts,
                        policy=chaos, resilient=dict(
                            snapshot_every=SNAPSHOT_EVERY, injector=inj,
                            breaker=breaker))
        stats = run["report"].stats
        assert stats["restarts"] == 0 and stats["breaker_trips"] >= 1, stats
        assert breaker.pinned == {("rmsnorm", "*"): "ref"}
        assert run["tokens"] == ref["tokens"], "breaker run differs"
        assert xaif.active_breaker() is None
        n = 4 * (2 * cfg.num_layers + 1) + 20 * (2 * cfg.num_layers + 2)
        supervised(torch, run_serve, "resilient-chaos-no-breaker", cfg,
                   params, prompts, ref, {"backend": [n]}, card,
                   policy=chaos)
    assert set(xaif.launch_counts()) == counters, "a chaos counter is left"
    print(f"resilient chaos: with a breaker {int(stats['breaker_trips'])} "
          f"trip, rmsnorm pinned to plain, no restart; without, a restart; "
          f"both == the chaos policy's run, bitwise; no chaos backend left "
          f"registered", flush=True)

    # the watchdog: a stall of 1.5x the budget at decode call 2
    inj = FaultInjector(stalls={"decode": {2: 1.5 * WATCHDOG_MS / 1e3}})
    run = run_serve("resilient-watchdog", cfg, params, prompts,
                    resilient=dict(snapshot_every=SNAPSHOT_EVERY,
                                   watchdog_ms=WATCHDOG_MS, injector=inj))
    assert inj.stalled == 1 and run["report"].stats["restarts"] >= 1
    assert run["tokens"] == runs["contiguous"]["tokens"], "watchdog differs"
    print(f"resilient watchdog: a {1.5 * WATCHDOG_MS:.0f} ms stall against "
          f"a {WATCHDOG_MS:.0f} ms budget, "
          f"{int(run['report'].stats['restarts'])} restart, tokens == the "
          f"uninterrupted run, bitwise", flush=True)

    quarantine_run(torch, "quarantine-contiguous", cfg, params, prompts,
                   runs["contiguous"])
    quarantine_run(torch, "quarantine-paged", cfg, params, prompts,
                   runs["paged"], **paged)
    print(f"phase 5d (fault-tolerant serving) took "
          f"{time.perf_counter() - t0:.1f}s on {card}", flush=True)
    return never


# -- phase 5e: the shape-aware dispatch policy and measured autotune -------

# first-token logits of a serve under another policy than the kernels':
# rel L2 bound against the kernels' run (as phase 5b's fork-point prefill)
DISPATCH_MAX_REL = 5e-2


class CallRecorder:
    """Wraps ``xaif.call`` while a ``with`` block runs and counts each
    call's (op, shapes, dtype): which calls a serve makes does not depend
    on the policy, so these counts predict any policy's launches
    (``predicted``)."""

    def __init__(self):
        from collections import Counter
        self.calls = Counter()

    def __enter__(self):
        from repro_torch.core import xaif
        self.xaif, self.real = xaif, xaif.call

        def call(op, policy, *args, **kwargs):
            dtype = next(a.dtype for a in args if hasattr(a, "dtype"))
            self.calls[(op, xaif._shapes_of(args), dtype)] += 1
            return self.real(op, policy, *args, **kwargs)
        xaif.call = call
        return self

    def __exit__(self, *exc):
        self.xaif.call = self.real

    def predicted(self, policy):
        """(launches a counter, calls an (op, bucket, backend run)) of the
        recorded calls under ``policy``, as ``xaif.resolve`` dispatches
        them (a rule's backend, or its supports fallback)."""
        from collections import Counter
        xaif = self.xaif
        launches, cells = Counter(), Counter()
        for (op, shapes, dtype), n in self.calls.items():
            b = xaif.resolve(op, policy, shapes, dtype)
            cells[(op, xaif.shape_bucket(op, shapes, dtype), b.name)] += n
            if not b.plain and hasattr(b.entry.kernel, "launches"):
                launches[op if b.name == xaif.KERNEL
                         else f"{op}_{b.name}"] += n
        return dict(launches), dict(cells)


class PrefillLogits:
    """Keeps the first-token logits of every admission (``lm.forward_
    prefill``'s, in admission order) while a ``with`` block runs."""

    def __enter__(self):
        from repro_torch.models import lm
        self.lm, self.real, self.rows = lm, lm.forward_prefill, []

        def spy(*args, **kwargs):
            logits, cache = self.real(*args, **kwargs)
            self.rows.append(logits[0].float())
            return logits, cache
        lm.forward_prefill = spy
        return self

    def __exit__(self, *exc):
        self.lm.forward_prefill = self.real


# serve (d)'s positions: decode attention's KV extent in the kv_l bucket
# (past 1024 positions; 65 pages of 16 a slot)
DISPATCH_LONG_LEN = 1040

# the vocabulary of the CPU run that predicts phase 5e's launches (no
# bucket or supports reads the vocabulary: a head's rows decide its cell)
DISPATCH_CPU_VOCAB = 512


def dispatch_geometry(cfg):
    """yi-9b's serve geometry at a narrow width, for the CPU run that
    predicts the card's launches: its depth, exit, dtype, head dim and
    group (8 query heads a KV head), so that every call lands in the
    bucket and meets the ``supports`` the card's call does."""
    g = cfg.num_heads // cfg.num_kv_heads
    return cfg.reduced(num_layers=cfg.num_layers, num_heads=g,
                       num_kv_heads=1, head_dim=cfg.head_dim,
                       vocab_size=DISPATCH_CPU_VOCAB,
                       early_exit=cfg.early_exit)


def record_calls(cfg, prompts, **engine_kw):
    """The xaif calls of phase 4's serve (``serve_run``'s engine settings)
    at ``dispatch_geometry(cfg)`` on the CPU."""
    import torch
    from repro_torch.models import lm
    from repro_torch.serve.engine import SlotEngine
    from repro_torch.serve.scheduler import Request, serve

    small = dispatch_geometry(cfg)
    params = lm.init_lm(small, seed=0, device="cpu")
    engine = SlotEngine(small, capacity=4, max_len=160, chunk=8,
                        prompt_bucket=16, device="cpu", **engine_kw)
    requests = [Request(rid=i, prompt=pr % small.vocab_size,
                        max_new_tokens=24) for i, pr in enumerate(prompts)]
    # thousands of tiny ops: one intra-op thread runs them fastest
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with torch.inference_mode(), CallRecorder() as rec:
            serve(engine, params, requests)
    finally:
        torch.set_num_threads(threads)
    return rec


def run_dispatch(torch, run_serve, runs, cfg, params, prompts, card):
    """Phase 5e: the shape-aware dispatch policy on full-width yi-9b (phase
    4's 6 requests, capacity 4, 160 positions, chunks of 8, prompt buckets
    of 16). ``autotune`` at yi-9b's serve dims (every generic and yi-9b
    cell, each backend's ms, the winner, what was skipped and why, the
    prior and its bound): a rule, the cell's argmin, on every yi-9b cell
    whose kernel was measured and on no generic cell (its fp32 toy shapes
    are no yi-9b call), no kernel skipped on a yi-9b cell but by its
    ``supports``, every generic cell a kernel takes launches it, and the
    persisted policy loads back equal on this card.
    Then three policies serve, contiguous and paged (24 usable pages of
    16): (a) "kernel" in every cell, bitwise phase 4's and 5's tokens and
    launches with no fallback, its host-clock ms a step against "auto" in
    turns (the cost of bucketing every call); (b) the tuned policy and (c)
    ``{("gemm", "rows_m"): "ref"}`` (prompts beyond 32 rows prefill on the
    plain GEMM), each with exactly the launches that a CPU run of the same
    geometry predicts (``record_calls``) and, where a rule moves a call
    off the kernel, first-token logits within DISPATCH_MAX_REL of (a)'s
    and tokens equal up to a near tie (``near_tie_parts``); no fallback in
    any. (d) the tuned policy on the first 4 requests at DISPATCH_LONG_LEN
    positions, contiguous and paged: decode attention in the kv_l bucket on the kernel, launches
    those recorded on the run, and where every cell of the path names the
    kernel, tokens and launches == "auto"'s at that geometry, bitwise.
    Returns the autotune result."""
    import tempfile

    from repro_torch.configs.base import RunConfig
    from repro_torch.core import autotune, xaif
    from repro_torch.serve.engine import SlotEngine

    t0 = time.perf_counter()
    paged = dict(paged=True, page_size=16, num_pages=25)
    bucket_len = max(-(-len(p) // 16) * 16 for p in prompts)
    xaif.reset_launch_counts()
    res = autotune.autotune(arch=cfg, capacity=4, max_len=160, page_size=16,
                            bucket_len=bucket_len, device="cuda")
    torch.cuda.synchronize()
    tuned_launches = {k: n for k, n in xaif.launch_counts().items() if n}
    for c in res.cells:
        win = c.winner()
        dims = autotune._cost_args(c.op, c.shapes)
        itemsize = 4 if c.dtype == "torch.float32" else 2
        cost = xaif.entry(c.op).cost_fn(*dims, dtype_bytes=itemsize)
        b_ms, b_by = bound(cost["hbm_bytes"], cost["flops"],
                           c.dtype.replace("torch.", ""))
        print(f"autotune {c.op}/{c.bucket} ({c.source}, {c.dtype}, "
              f"{[list(x) for x in c.shapes]}): ms "
              f"{ {n: round(us / 1e3, 4) for n, us in c.measured_us.items()} }"
              f"; winner {win}; rule {c.rule or 'none: ' + c.no_rule}; "
              f"skipped {c.skipped}; prior flops "
              f"{c.prior['flops']:.4g} bytes {c.prior['hbm_bytes']:.4g}; "
              f"bound {b_ms:.4f} ms ({b_by}, {itemsize}-byte operands) on "
              f"{card}", flush=True)
        assert win == min(c.measured_us, key=c.measured_us.get), c
        if c.source == cfg.name:
            # a yi-9b cell the kernel takes writes its argmin
            assert ("kernel" in c.measured_us
                    or c.skipped["kernel"] == "supports"), c
            assert c.rule == (win if "kernel" in c.measured_us else None), c
        else:
            # a generic cell's fp32 toy shapes are no yi-9b call
            assert c.rule is None, c
        assert res.policy.backend_for(c.op, c.bucket) == (c.rule
                                                          or "kernel"), c
        if "kernel" in c.measured_us:
            assert tuned_launches.get(c.op, 0) > 0, (c.op, tuned_launches)
    assert {(o, b) for o, b, _ in res.policy.rules} == {
        (c.op, c.bucket) for c in res.cells if c.rule}
    path = Path(tempfile.mkdtemp()) / "yi-9b-policy.json"
    res.persist(str(path))
    tuned = autotune.load_policy(str(path), "cuda")
    assert tuned == res.policy, "the persisted policy differs"
    shutil.rmtree(path.parent)
    print(f"autotune: {len(res.cells)} cells on {res.device}, a rule (its "
          f"cell's argmin) on each of yi-9b's {len(res.policy.rules)} cells "
          f"and on no generic one; the policy persisted and loaded back "
          f"equal on this card; kernel launches while timing "
          f"{tuned_launches}", flush=True)

    t_tune = time.perf_counter() - t0
    # the calls phase 4's and 5's serves make, recorded on the CPU
    t1 = time.perf_counter()
    recorded = {"contiguous": record_calls(cfg, prompts),
                "paged": record_calls(cfg, prompts, **paged)}
    t_record = time.perf_counter() - t1
    allk = xaif.DispatchPolicy.make(
        {(op, b): "kernel" for op in xaif.ops() for b in xaif.op_buckets(op)})
    mixed = xaif.DispatchPolicy.make({("gemm", "rows_m"): "ref"})
    # (a)'s first-token logits by engine; teacher logits along (a)'s tokens
    # (the same on both engines), by request
    first, seen = {}, {}
    for kind, kw in (("contiguous", {}), ("paged", paged)):
        rec = recorded[kind]
        want, path_cells = rec.predicted(allk)
        ref = runs[kind]
        assert want == ref["launches"], (kind, want, ref["launches"])
        with PrefillLogits() as spy:
            a = run_serve(f"dispatch-kernel-{kind}", cfg, params, prompts,
                          policy=allk, **kw)
        first[kind] = spy.rows
        assert a["tokens"] == ref["tokens"], f"(a) {kind} tokens differ"
        assert a["launches"] == ref["launches"], (a["launches"],
                                                  ref["launches"])
        assert not a["fallbacks"], a["fallbacks"]
        print(f"dispatch (a) all-kernel {kind}: tokens and launches == the "
              f"'auto' run's, bitwise; no fallback; cells on the path "
              f"{sorted(path_cells.items())}", flush=True)
        for name, policy in (("tuned", tuned), ("mixed", mixed)):
            want, cells = rec.predicted(policy)
            on_kernel = all(b == xaif.KERNEL for _, _, b in cells)
            with PrefillLogits() as spy:
                r = run_serve(f"dispatch-{name}-{kind}", cfg, params,
                              prompts, policy=policy, **kw)
            assert r["launches"] == want, (name, kind, r["launches"], want)
            assert not r["fallbacks"], (name, kind, r["fallbacks"])
            moved = {k: n for k, n in cells.items() if k[2] != xaif.KERNEL}
            if on_kernel:
                assert r["tokens"] == a["tokens"], (name, kind)
                print(f"dispatch ({name}) {kind}: every cell on the path "
                      f"names the kernel; tokens and launches == (a)'s, "
                      f"bitwise; no fallback", flush=True)
                continue
            rel = [float((x - y).norm() / y.norm())
                   for x, y in zip(spy.rows, first[kind])]
            rms = float(torch.cat([(x - y).pow(2).flatten() for x, y in
                                   zip(spy.rows, first[kind])]).mean()) ** .5
            assert max(rel) < DISPATCH_MAX_REL, (name, kind, rel)
            parted = near_tie_parts(torch, cfg, params, prompts, r["tokens"],
                                    a["tokens"], rms, seen)
            if name == "mixed":
                others = {k: n for k, n in r["launches"].items()
                          if k != "gemm"}
                assert others == {k: n for k, n in a["launches"].items()
                                  if k != "gemm"}, (others, a["launches"])
            print(f"dispatch ({name}) {kind}: launches exactly the CPU "
                  f"prediction {want}; calls off the kernel "
                  f"{sorted(moved.items())}; first-token logits rel L2 max "
                  f"{max(rel):.4g} (bound {DISPATCH_MAX_REL}), RMS "
                  f"{rms:.4g}; {6 - len(parted)} of 6 requests == (a) "
                  f"whole, parted at near ties {parted}; no fallback",
                  flush=True)
    # (d) the tuned policy where decode attention's KV extent is past 1024
    # positions (the kv_l bucket, which no yi-9b cell measured): its rules
    # there are the default, so the kernels run as under "auto". The first
    # 4 requests: one admission a slot
    long_len, four = DISPATCH_LONG_LEN, prompts[:4]
    # the pool holds one max-length request (65 pages + the scratch page)
    long_paged = dict(paged, num_pages=-(-long_len // 16) + 1)
    for kind, kw in (("contiguous", {}), ("paged", long_paged)):
        auto = run_serve(f"dispatch-auto-long-{kind}", cfg, params, four,
                         max_len=long_len, **kw)
        with CallRecorder() as rec:
            r = run_serve(f"dispatch-tuned-long-{kind}", cfg, params, four,
                          policy=tuned, max_len=long_len, **kw)
        want, cells = rec.predicted(tuned)
        op = "attn_decode_paged" if kw else "attn_decode"
        assert (op, "kv_l", xaif.KERNEL) in cells, sorted(cells)
        assert r["launches"] == want, (r["launches"], want)
        assert not r["fallbacks"], r["fallbacks"]
        same = all(b == xaif.KERNEL for _, _, b in cells)
        if same:
            assert r["tokens"] == auto["tokens"], f"(d) {kind} tokens"
            assert r["launches"] == auto["launches"], (r["launches"],
                                                       auto["launches"])
        print(f"dispatch (d) tuned at {long_len} positions {kind}: "
              + ("tokens and launches == 'auto''s, bitwise" if same else
                 "a rule moves calls off the kernel (tokens held in (b))")
              + f"; launches == the calls recorded; no fallback; cells on "
              f"the path {sorted(cells.items())}", flush=True)
    host_ab(torch, "yi-9b, 'auto' against an all-kernel DispatchPolicy "
            "(the cost of per-call bucketing)",
            [("auto", SlotEngine(cfg, capacity=4, max_len=160, chunk=8),
              params),
             ("dispatch", SlotEngine(RunConfig(arch=cfg, policy=allk),
                                     capacity=4, max_len=160, chunk=8),
              params)],
            prompts)
    print(f"phase 5e (dispatch policy and autotune) took "
          f"{time.perf_counter() - t0:.1f}s (autotune {t_tune:.1f}s, the "
          f"CPU runs {t_record:.1f}s) on {card}", flush=True)
    return res


def run_quantized(torch, run_serve, cfg, params, prompts, bf16):
    """Phases 6b-6d: yi-9b on int8 weights. The port's
    ``quantize_weights_int8`` on the card (exactly the projections of
    ``_QUANT_NAMES`` in yi's tree); prefill of 8 prompts through the
    kernels against the plain path on the same quantized weights, in both
    modes (weight-only: the default policy; W8A8: the lossy ``int8``
    backend of gemm), and each mode's distance from the bf16 model's
    logits (``bf16``: phase 3's readings); then the 6-request serve,
    weight-only contiguous and paged and W8A8 contiguous, each with
    request 0 == ``generate`` bitwise, every GEMM launch on the int8
    weights, and one decode chunk traced. Returns the quantized tree."""
    from repro_torch.configs.base import RunConfig
    from repro_torch.core import xaif
    from repro_torch.models import lm
    from repro_torch.serve.engine import SlotEngine, generate
    from repro_torch.serve.quantize import (_QUANT_NAMES, WeightQ,
                                            quantize_weights_int8)

    w8a8 = xaif.Policy({"gemm": "int8"}, allow_lossy=True)
    w8a8_ref = xaif.Policy({"gemm": "int8"}, allow_lossy=True, mode="ref")
    t0 = time.perf_counter()
    qparams = quantize_weights_int8(params)
    torch.cuda.synchronize()

    def entries(tree):
        """(key, leaf) of every tensor or WeightQ under a dict key."""
        if isinstance(tree, dict):
            for k, v in tree.items():
                if isinstance(v, (torch.Tensor, WeightQ)):
                    yield k, v
                else:
                    yield from entries(v)
        elif isinstance(tree, (tuple, list)):
            for v in tree:
                yield from entries(v)

    quantized = [(k, v) for k, v in entries(qparams) if isinstance(v, WeightQ)]
    got = {k for k, _ in quantized}
    matrices = {k for k, v in entries(params)
                if v.dim() >= 2 and v.is_floating_point()}
    assert got == _QUANT_NAMES & matrices, (got, matrices)
    int8_bytes = sum(v.q.numel() for _, v in quantized)
    scale_bytes = sum(4 * v.scale.numel() for _, v in quantized)
    print(f"quantized {cfg.name} on the card in "
          f"{time.perf_counter() - t0:.1f}s: {sorted(got)} int8, "
          f"{int8_bytes / 2**30:.2f} GiB of int8 weights + "
          f"{scale_bytes / 2**20:.1f} MiB of scales; "
          f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB on the card",
          flush=True)

    # prefill: kernels against plain on the same quantized weights; the
    # bounds are 2x the readings of the first run on the H100 (PERF.md)
    last = {}
    for mode, pol, ref, (max_rel, max_mean, min_clear) in (
            ("weight-only", "auto", "ref", WQ_PREFILL),
            ("w8a8", w8a8, w8a8_ref, W8A8_PREFILL)):
        last[mode] = check_prefill(
            torch, lm, cfg, qparams, fp32_copy=False, max_rel=max_rel,
            max_mean_rel=max_mean, min_clear=min_clear, policy=pol,
            ref_policy=ref, label=f" {mode}")["kernels"]
        rel = ((last[mode] - bf16).norm(dim=-1) / bf16.norm(dim=-1))
        agree = int((last[mode].argmax(-1) == bf16.argmax(-1)).sum())
        print(f"prefill logits {cfg.name} {mode} vs the bf16 model (both "
              f"through the kernels): rel_l2 max {float(rel.max()):.3e} "
              f"mean {float(rel.mean()):.3e}; argmax equal {agree}/"
              f"{len(rel)}", flush=True)
        assert float(rel.max()) < QUANT_VS_BF16[mode], (mode, rel)

    # serve weight-only: every GEMM launch is the int8-weight instance
    # per layer wq wk wv wo w_gate w_up w_down; the unembedding once a
    # prefill, and at each decode step once more per exit head (338 and
    # 337 on yi-9b)
    prefill_gemm = 7 * cfg.num_layers + 1
    steps_gemm = prefill_gemm + len(cfg.early_exit.exit_layers)
    wq = run_serve("wq-contiguous", cfg, qparams, prompts)
    lc, steps, prefills = wq["launches"], wq["steps"], wq["prefills"]
    assert set(lc) == {"gemm", "gemm_wq", "rmsnorm", "attention",
                       "attn_decode", "entropy_exit"}, lc
    assert lc["gemm"] == lc["gemm_wq"] == (steps_gemm * steps
                                           + prefill_gemm * prefills), lc
    assert lc["attn_decode"] == cfg.num_layers * steps, lc
    ref_toks, _ = generate(cfg, qparams, prompts[0][None], 24)
    assert ref_toks[0].tolist() == wq["tokens"][0], (
        "weight-only engine tokens differ from generate",
        ref_toks[0].tolist(), wq["tokens"][0])
    wq_kernels = profile_decode(
        torch, f"{cfg.name} weight-only int8",
        SlotEngine(cfg, capacity=4, max_len=160, chunk=8), qparams, prompts)
    wqp = run_serve("wq-paged", cfg, qparams, prompts, paged=True,
                    page_size=16, num_pages=25)
    assert wqp["tokens"] == wq["tokens"], "weight-only paged tokens differ"
    assert wqp["report"].stats["peak_pages"] <= 24, wqp["report"].stats
    lc = wqp["launches"]
    assert set(lc) == {"gemm", "gemm_wq", "rmsnorm", "attention",
                       "attn_decode_paged", "entropy_exit"}, lc
    assert lc["gemm"] == lc["gemm_wq"], lc
    print(f"serve weight-only: request 0 == generate, paged == contiguous, "
          f"bitwise; {steps_gemm} gemm a step, every one on int8 weights",
          flush=True)

    # serve W8A8: every GEMM launch is gemm_int8, no bf16 gemm runs
    run = run_serve("w8a8-contiguous", cfg, qparams, prompts, policy=w8a8)
    lc, steps, prefills = run["launches"], run["steps"], run["prefills"]
    assert set(lc) == {"gemm_int8", "rmsnorm", "attention", "attn_decode",
                       "entropy_exit"}, lc
    assert lc["gemm_int8"] == steps_gemm * steps + prefill_gemm * prefills, lc
    ref_toks, _ = generate(RunConfig(arch=cfg, policy=w8a8), qparams,
                           prompts[0][None], 24)
    assert ref_toks[0].tolist() == run["tokens"][0], (
        "W8A8 engine tokens differ from generate", ref_toks[0].tolist(),
        run["tokens"][0])
    w8a8_kernels = profile_decode(torch, f"{cfg.name} W8A8", SlotEngine(
        RunConfig(arch=cfg, policy=w8a8), capacity=4, max_len=160, chunk=8),
        qparams, prompts)
    # gemm_int8 quantizes the activations itself: a W8A8 step launches
    # the kernels of a weight-only step, one a GEMM, and no PyTorch op
    # more (one op a GEMM would add 338 a step), counted by the host's
    # launch calls (the device's kernel records of a traced chunk lose up
    # to a few a step, a different number in each run)
    if wq_kernels is not None and w8a8_kernels is not None:
        assert w8a8_kernels == wq_kernels, (w8a8_kernels, wq_kernels)
    host_ab(torch, f"{cfg.name} weight-only int8 vs W8A8", [
        ("weight-only", SlotEngine(cfg, capacity=4, max_len=160, chunk=8),
         qparams),
        ("W8A8", SlotEngine(RunConfig(arch=cfg, policy=w8a8), capacity=4,
                            max_len=160, chunk=8), qparams)], prompts)
    agree = sum(a == b for x, y in zip(run["tokens"], wq["tokens"])
                for a, b in zip(x, y))
    print(f"serve W8A8: request 0 == generate, bitwise; {steps_gemm} "
          f"gemm_int8 a step, no bf16 gemm; kernel launches a traced step "
          f"{w8a8_kernels} (weight-only {wq_kernels}); tokens equal to "
          f"weight-only's at {agree}/{6 * 24} positions", flush=True)
    return qparams


def serve_deepseek(torch, run_serve, ds, dparams, t_start):
    """Phase 8: the 6-request serve on deepseek through the contiguous
    engine (request 0 == ``generate`` bitwise; every kernel of the path
    launched on every layer), then through the paged MLA engine (tokens ==
    the contiguous run's, bitwise; precise attn_decode_paged on every
    layer), each with one decode chunk timed and traced."""
    from repro_torch.serve.engine import SlotEngine, generate

    # -- 8. serve deepseek: contiguous KV, greedy, request 0 == generate ---
    ds_prompts = make_prompts(torch, ds.vocab_size)
    mla = run_serve("deepseek-contiguous", ds, dparams, ds_prompts)
    steps, n_moe = mla["steps"], ds.num_layers - ds.first_k_dense
    assert set(mla["launches"]) == {
        "gemm", "gemm_heads", "rmsnorm", "attention", "attn_decode",
        "moe_decode", "entropy_exit"}, mla["launches"]
    # every attn_decode launch of this run is a precise (MLA) one
    assert mla["launches"]["attn_decode"] == ds.num_layers * steps, \
        mla["launches"]
    assert mla["launches"]["moe_decode"] == n_moe * steps, mla["launches"]
    assert mla["launches"]["gemm_heads"] == 2 * ds.num_layers * steps, \
        mla["launches"]
    assert mla["launches"]["attention"] == \
        ds.num_layers * mla["prefills"], mla["launches"]
    ref_toks, _ = generate(ds, dparams, ds_prompts[0][None], 24)
    assert ref_toks[0].tolist() == mla["tokens"][0], (
        "deepseek engine tokens differ from generate", ref_toks[0].tolist(),
        mla["tokens"][0])
    profile_decode(torch, ds.name, SlotEngine(ds, capacity=4, max_len=160,
                                              chunk=8), dparams, ds_prompts)
    print("serve deepseek-contiguous: request 0 == generate, bitwise",
          flush=True)
    # -- 8c. gated at threshold 2.0: MLA latents propagated ---------------
    serve_gated(torch, run_serve, f"{ds.name}-gated-thr2", ds, dparams,
                ds_prompts, mla)

    # -- 8b. the paged MLA engine: latent pages, 24 usable for 4 slots that
    #    could ask for 40; tokens equal the contiguous engine's, bitwise --
    mla_paged = run_serve("deepseek-paged", ds, dparams, ds_prompts,
                          paged=True, page_size=16, num_pages=25)
    lc, steps = mla_paged["launches"], mla_paged["steps"]
    assert mla_paged["tokens"] == mla["tokens"], "paged MLA tokens differ"
    assert mla_paged["report"].stats["peak_pages"] <= 24, \
        mla_paged["report"].stats
    assert set(lc) == {"gemm", "gemm_heads", "rmsnorm", "attention",
                       "attn_decode_paged", "moe_decode", "entropy_exit"}, lc
    assert lc["attn_decode_paged"] == ds.num_layers * steps, lc
    profile_decode(torch, f"{ds.name} paged", SlotEngine(
        ds, capacity=4, max_len=160, chunk=8, paged=True, page_size=16),
        dparams, ds_prompts)
    print(f"serve deepseek-paged: tokens == contiguous engine, bitwise, per "
          f"request; {ds.num_layers} precise attn_decode_paged a step, no "
          f"attn_decode; peak "
          f"{int(mla_paged['report'].stats['peak_pages'])} of 24 pages",
          flush=True)
    # -- 8d. phase 5d's kill and resume on the paged MLA engine: a decode
    #    fault, the latent pages snapshotted through fetch_pages ---------
    supervised(torch, run_serve, "deepseek-resilient-paged", ds, dparams,
               ds_prompts, mla_paged, {"decode": [3]}, card_line(),
               paged=True, page_size=16, num_pages=25)
    print(f"deepseek phases done at {time.perf_counter() - t_start:.1f}s",
          flush=True)


def run_jamba(torch, run_serve, t_start):
    """Phases 9-10: jamba-v0.1-52b at full width cut to two super-blocks
    (16 layers: 14 Mamba, 2 attention, 8 MoE of 16 experts x 14336 top-2,
    8 dense MLPs; exit at layer 8; 26.05 B params, 48.5 GiB bf16). The
    prefill of 64 prompts through the kernels, the plain policy and the
    plain policy computing in fp32 on the same bf16 weights (an fp32 copy
    would not fit beside them), end to end and layer by layer; then the
    6-request serve: request 0 == ``generate`` bitwise, and every kernel of
    the path launched in it; then the same requests through the paged
    hybrid engine, token for token equal to the contiguous run."""
    from repro_torch.configs.base import get_arch
    from repro_torch.models import lm
    from repro_torch.serve.engine import SlotEngine, generate

    jb = dataclasses.replace(get_arch("jamba-v0.1-52b"), num_layers=16)
    t0 = time.perf_counter()
    jparams = lm.init_lm(jb, seed=0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in lm._leaves(jparams))
    mixers = [jb.layer_spec(i).mixer for i in range(jb.num_layers)]
    n_mamba, n_attn = mixers.count("mamba"), mixers.count("attn")
    n_moe = sum(jb.layer_spec(i).ffn == "moe" for i in range(jb.num_layers))
    print(f"{jb.name}: {jb.num_layers} of 32 layers (two super-blocks: "
          f"{n_mamba} Mamba, {n_attn} attention, {n_moe} MoE of "
          f"{jb.moe.num_experts} experts top-{jb.moe.top_k}) d_model="
          f"{jb.d_model} {n_params / 1e9:.3f}B params ({jb.dtype}) "
          f"initialised in {time.perf_counter() - t0:.1f}s; "
          f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB on the card",
          flush=True)
    # End to end the two bf16 paths drift apart with depth on random
    # weights (a routing near-tie, then the recurrence and attention carry
    # the difference to the last token): the plain path's RMS logit
    # distance from fp32 exceeds every prompt's top-2 gap, so no prompt is
    # clear and no distance bound would hold (PERF.md). End to end the
    # kernels must stay finite and no further from fp32 than 1.5x the plain
    # path; layer by layer, teacher-forced, they are held to bf16 accuracy
    check_prefill(torch, lm, jb, jparams, n_prompts=64, fp32_copy=False,
                  max_rel=None, min_clear=0)
    check_layers(torch, lm, jb, jparams)

    prompts = make_prompts(torch, jb.vocab_size)
    run = run_serve("jamba-contiguous", jb, jparams, prompts)
    steps, prefills, lc = run["steps"], run["prefills"], run["launches"]
    assert set(lc) == {"gemm", "rmsnorm", "attention", "attn_decode",
                       "moe_decode", "entropy_exit", "ssm_scan",
                       "ssm_decode"}, lc
    assert lc["ssm_decode"] == n_mamba * steps, lc
    assert lc["moe_decode"] == n_moe * steps, lc
    assert lc["attn_decode"] == n_attn * steps, lc
    assert lc["entropy_exit"] == steps, lc
    assert lc["ssm_scan"] == n_mamba * prefills, lc
    assert lc["attention"] == n_attn * prefills, lc
    ref_toks, _ = generate(jb, jparams, prompts[0][None], 24)
    assert ref_toks[0].tolist() == run["tokens"][0], (
        "jamba engine tokens differ from generate", ref_toks[0].tolist(),
        run["tokens"][0])
    print(f"serve jamba-contiguous: request 0 == generate, bitwise; "
          f"{n_mamba} ssm_decode, {n_moe} moe_decode, {n_attn} attn_decode "
          f"a step, {n_mamba} ssm_scan and {n_attn} attention a prefill",
          flush=True)
    profile_decode(torch, jb.name, SlotEngine(jb, capacity=4, max_len=160,
                                              chunk=8), jparams, prompts)

    # the paged hybrid engine: KV pages for the 2 attention layers beside
    # the slot-indexed Mamba state; tokens equal the contiguous engine's
    paged = run_serve("jamba-paged", jb, jparams, prompts, paged=True,
                      page_size=16, num_pages=25)
    lc, steps = paged["launches"], paged["steps"]
    assert paged["tokens"] == run["tokens"], "paged jamba tokens differ"
    assert paged["report"].stats["peak_pages"] <= 24, paged["report"].stats
    assert set(lc) == {"gemm", "rmsnorm", "attention", "attn_decode_paged",
                       "moe_decode", "entropy_exit", "ssm_scan",
                       "ssm_decode"}, lc
    assert lc["attn_decode_paged"] == n_attn * steps, lc
    assert lc["ssm_decode"] == n_mamba * steps, lc
    assert lc["moe_decode"] == n_moe * steps, lc
    profile_decode(torch, f"{jb.name} paged", SlotEngine(
        jb, capacity=4, max_len=160, chunk=8, paged=True, page_size=16),
        jparams, prompts)
    print(f"serve jamba-paged: tokens == contiguous engine, bitwise, per "
          f"request; {n_attn} attn_decode_paged and {n_mamba} ssm_decode a "
          f"step, no attn_decode; peak "
          f"{int(paged['report'].stats['peak_pages'])} of 24 pages",
          flush=True)
    # -- 10b. phase 5d's kill and resume on the paged hybrid engine: a
    #    decode fault, the whole cache snapshotted (the Mamba state is
    #    written in place by every step) -----------------------------------
    supervised(torch, run_serve, "jamba-resilient-paged", jb, jparams,
               prompts, paged, {"decode": [3]}, card_line(), paged=True,
               page_size=16, num_pages=25)
    print(f"jamba phases done at {time.perf_counter() - t_start:.1f}s",
          flush=True)


def run_xlstm(torch, run_serve, t_start, prefill_bounds=XLSTM_PREFILL):
    """Phases 11-12: xlstm-350m at full width and full depth (24 layers:
    21 mLSTM with head dim 512, 3 sLSTM; no attention layer; exit at layer
    8; 0.33 B params). The prefill of 64 prompts through the kernels, the
    plain policy and the plain policy on an fp32 weight copy, end to end
    (kernels-vs-plain rel L2 max / mean under ``prefill_bounds``) and
    layer by layer; then the 6-request serve: request 0 == ``generate``
    bitwise, every decode step through the mLSTM kernel on all 21 mLSTM
    layers and no attention op; then the same requests through the paged
    engine (no pool: pages are accounted, nothing is stored in them),
    token for token equal to the contiguous run."""
    from repro_torch.configs.base import get_arch
    from repro_torch.models import lm
    from repro_torch.serve.engine import SlotEngine, generate

    xl = get_arch("xlstm-350m")
    t0 = time.perf_counter()
    params = lm.init_lm(xl, seed=0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in lm._leaves(params))
    mixers = [xl.layer_spec(i).mixer for i in range(xl.num_layers)]
    n_ml, n_sl = mixers.count("mlstm"), mixers.count("slstm")
    print(f"{xl.name}: {xl.num_layers} layers ({n_ml} mLSTM, {n_sl} sLSTM) "
          f"d_model={xl.d_model} {n_params / 1e9:.3f}B params ({xl.dtype}) "
          f"initialised in {time.perf_counter() - t0:.1f}s; "
          f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB on the card",
          flush=True)
    # End to end the two bf16 paths drift apart through 24 recurrent layers
    # on random weights, as jamba's do: the plain path's RMS logit
    # distance from fp32 (0.44) exceeds every prompt's top-2 gap, so no
    # prompt is clear. End to end the kernels are held to finite logits,
    # the distance bounds and 1.5x plain's distance from fp32; layer by
    # layer, teacher-forced, to bf16 accuracy
    check_prefill(torch, lm, xl, params, n_prompts=64,
                  max_rel=prefill_bounds[0], max_mean_rel=prefill_bounds[1],
                  min_clear=0)
    check_layers(torch, lm, xl, params)

    prompts = make_prompts(torch, xl.vocab_size)
    run = run_serve("xlstm-contiguous", xl, params, prompts)
    steps, lc = run["steps"], run["launches"]
    assert set(lc) == {"gemm", "gemm_heads", "rmsnorm", "entropy_exit",
                       "ssm_decode"}, lc
    assert lc["ssm_decode"] == n_ml * steps, lc
    assert lc["entropy_exit"] == steps, lc
    ref_toks, _ = generate(xl, params, prompts[0][None], 24)
    assert ref_toks[0].tolist() == run["tokens"][0], (
        "xlstm engine tokens differ from generate", ref_toks[0].tolist(),
        run["tokens"][0])
    print(f"serve xlstm-contiguous: request 0 == generate, bitwise; {n_ml} "
          f"mlstm_decode (ssm_decode) a step, no attention op", flush=True)
    profile_decode(torch, xl.name, SlotEngine(xl, capacity=4, max_len=160,
                                              chunk=8), params, prompts)

    paged = run_serve("xlstm-paged", xl, params, prompts, paged=True,
                      page_size=16, num_pages=25)
    lc, steps = paged["launches"], paged["steps"]
    assert paged["tokens"] == run["tokens"], "paged xlstm tokens differ"
    assert paged["report"].stats["peak_pages"] <= 24, paged["report"].stats
    assert set(lc) == {"gemm", "gemm_heads", "rmsnorm", "entropy_exit",
                       "ssm_decode"}, lc
    assert lc["ssm_decode"] == n_ml * steps, lc
    profile_decode(torch, f"{xl.name} paged", SlotEngine(
        xl, capacity=4, max_len=160, chunk=8, paged=True, page_size=16),
        params, prompts)
    print(f"serve xlstm-paged: tokens == contiguous engine, bitwise, per "
          f"request; {n_ml} mlstm_decode a step, no pool; peak "
          f"{int(paged['report'].stats['peak_pages'])} of 24 pages; xlstm "
          f"phases done at {time.perf_counter() - t_start:.1f}s", flush=True)


def zoo_launches(cfg, steps: int, prefills: int, paged: bool):
    """Every launch counter of a serve run on a GQA arch without recurrent
    layers (dense MLP or MoE on every layer), from its decode steps and
    prefills. A decode step: q, k, v, o on each layer, then the MLP's
    three GEMMs or the fp32 router and ``moe_decode``; two layer norms a
    layer (four with a QK-norm: q and k over the head dim); the exit
    heads' norm and unembedding and the final ones; one decode attention a
    layer and one ``entropy_exit`` an exit. A prefill: the same layers
    through flash attention (the MoE's experts and router in plain
    PyTorch, as the capacity path computes them) and the final head only."""
    nl, n_exit = cfg.num_layers, len(cfg.early_exit.exit_layers)
    moe = cfg.moe is not None
    norms = (4 if cfg.qk_norm else 2) * nl
    out = {"gemm": steps * ((5 if moe else 7) * nl + 1 + n_exit)
           + prefills * ((4 if moe else 7) * nl + 1),
           "rmsnorm": steps * (norms + 1 + n_exit) + prefills * (norms + 1),
           "attention": prefills * nl,
           "attn_decode_paged" if paged else "attn_decode": steps * nl,
           "entropy_exit": steps * n_exit}
    if moe:
        out["moe_decode"] = steps * nl
    return out


def run_zoo(torch, run_serve, t_start, name: str, prefill: dict,
            spec: tuple = (), gated: bool = False, sharing: bool = False,
            params=None):
    """Phases 12d-12h and 15(c), one zoo arch served at full width and
    ``ZOO_LAYERS[name]`` layers (random weights from seed 0, bf16, or the
    caller's ``params``: phase 15's trained musicgen; the phases before
    freed theirs), from token ids (musicgen's and
    chameleon's frontends are stubs: ids through the ``embed`` table).
    As yi-9b's
    phases 3-6: the prefill through the kernels, the plain policy and the
    plain policy in fp32 (``check_prefill`` with the arguments
    ``prefill``: an fp32 weight copy unless ``fp32_copy=False``, which
    computes in fp32 on the bf16 weights); the 6-request serve
    contiguous (request 0 == ``generate`` bitwise; every
    launch counter exactly ``zoo_launches``) and paged (tokens ==
    contiguous, bitwise; exact launches, attn_decode_paged only), one
    decode chunk of each engine timed and traced; then greedy speculative
    decoding without the exit heads (tokens == plain greedy, bitwise;
    verify_decode(_paged) on every layer a round) for each of ``spec``:
    "tied-paged" (the target as its own draft, on the paged engine) and
    "draft2l-contiguous" (a 2-layer draft of its own weights). ``gated``:
    the gated engine at an exit threshold of 2.0 too (``serve_gated``).
    ``sharing``: phase 5b's shared-prefix stream too (``run_sharing``, on
    24 pages). Returns (the config, ``check_prefill``'s logits, the
    prompts, the contiguous run)."""
    from repro_torch.configs.base import get_arch
    from repro_torch.models import lm
    from repro_torch.serve.engine import SlotEngine, SpecConfig, generate

    full = get_arch(name)
    cfg = dataclasses.replace(full, num_layers=ZOO_LAYERS[name])
    t_phase = t0 = time.perf_counter()
    made = "given" if params is not None else "initialised"
    if params is None:
        params = lm.init_lm(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    leaves = lm._leaves(params)
    n_params = sum(t.numel() for t in leaves)
    nbytes = sum(t.numel() * t.element_size() for t in leaves)
    nl, g = cfg.num_layers, cfg.num_heads // cfg.num_kv_heads
    print(f"{name}: {nl} of {full.num_layers} layers d_model={cfg.d_model} "
          f"{cfg.num_heads} heads over {cfg.num_kv_heads} KV heads of "
          f"{cfg.head_dim} (group {g}){', QKV bias' if cfg.qkv_bias else ''}"
          f"{', QK-norm' if cfg.qk_norm else ''}"
          f"{f', rotary over {cfg.rope_partial_pct:.0%}' if cfg.rope == 'partial' else ''}"
          f"{f', {cfg.moe.num_experts} experts top-{cfg.moe.top_k} of {cfg.moe.d_expert}' if cfg.moe else ''}"
          f", vocab {cfg.vocab_size}; {n_params / 1e9:.3f}B params "
          f"({cfg.dtype}, {nbytes / 2**30:.1f} GiB) {made} in "
          f"{time.perf_counter() - t0:.1f}s; "
          f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB on the card",
          flush=True)
    last = check_prefill(torch, lm, cfg, params, **prefill)

    prompts = make_prompts(torch, cfg.vocab_size)
    run = run_serve(f"{name}-contiguous", cfg, params, prompts)
    want = zoo_launches(cfg, run["steps"], run["prefills"], paged=False)
    assert run["launches"] == want, (name, run["launches"], want)
    ref_toks, _ = generate(cfg, params, prompts[0][None], 24)
    assert ref_toks[0].tolist() == run["tokens"][0], (
        f"{name} engine tokens differ from generate", ref_toks[0].tolist(),
        run["tokens"][0])
    print(f"serve {name}-contiguous: request 0 == generate, bitwise; "
          f"launches exactly {want}", flush=True)
    profile_decode(torch, name, SlotEngine(cfg, capacity=4, max_len=160,
                                           chunk=8), params, prompts)
    if gated:
        serve_gated(torch, run_serve, f"{name}-gated-thr2", cfg, params,
                    prompts, run)

    paged = run_serve(f"{name}-paged", cfg, params, prompts, paged=True,
                      page_size=16, num_pages=25)
    assert paged["tokens"] == run["tokens"], f"paged {name} tokens differ"
    assert paged["report"].stats["peak_pages"] <= 24, paged["report"].stats
    want = zoo_launches(cfg, paged["steps"], paged["prefills"], paged=True)
    assert paged["launches"] == want, (name, paged["launches"], want)
    profile_decode(torch, f"{name} paged", SlotEngine(
        cfg, capacity=4, max_len=160, chunk=8, paged=True, page_size=16),
        params, prompts)
    print(f"serve {name}-paged: tokens == contiguous engine, bitwise, per "
          f"request; {nl} attn_decode_paged a step, no attn_decode; peak "
          f"{int(paged['report'].stats['peak_pages'])} of 24 pages",
          flush=True)
    if sharing:
        run_sharing(torch, run_serve, name, cfg, params)

    if spec:
        cfg_ne = dataclasses.replace(cfg, early_exit=None)
        greedy = run_serve(f"{name}-plain-noexit", cfg_ne, params, prompts)
        for kind in spec:
            if kind == "tied-paged":
                kw = dict(paged=True, page_size=16, num_pages=25,
                          spec=SpecConfig(draft_arch=cfg_ne, k=3,
                                          share_params=True))
            else:
                draft = dataclasses.replace(cfg_ne, name=f"{name}-draft-2l",
                                            num_layers=2)
                kw = dict(spec=SpecConfig(draft_arch=draft, k=3,
                                          draft_seed=1))
            sr = run_serve(f"{name}-spec-{kind}", cfg_ne, params, prompts,
                           **kw)
            assert sr["tokens"] == greedy["tokens"], (name, kind,
                                                      "spec tokens differ")
            op = "verify_decode_paged" if "paged" in kind else \
                "verify_decode"
            assert sr["launches"][op] == nl * sr["steps"], sr["launches"]
            if kind == "tied-paged":
                assert sr["report"].stats["spec_acceptance"] == 1.0, \
                    sr["report"].stats
            print(f"serve {name} spec {kind}: tokens == plain greedy, "
                  f"bitwise; {nl} {op} a round at {g * 4} query rows a KV "
                  f"head (k = 3); acceptance "
                  f"{sr['report'].stats['spec_acceptance']:.3f}", flush=True)
    del params, ref_toks
    torch.cuda.empty_cache()
    took = time.perf_counter() - t_phase
    saved = ""
    if name in ZOO_FULL_DEPTH_S:
        saved = (f"; {full.num_layers} -> {nl} layers saved "
                 f"{ZOO_FULL_DEPTH_S[name] - took:.1f}s of its "
                 f"{ZOO_FULL_DEPTH_S[name]:.1f}s at full depth")
    print(f"{name} phases took {took:.1f}s{saved}; done at "
          f"{time.perf_counter() - t_start:.1f}s", flush=True)
    return cfg, last, prompts, run


def check_seizure_steps(torch, tr, kind, w, batches):
    """The port's CPU training of ``kind`` over ``batches`` (on the card),
    and before each step the card's loss and gradients from the CPU's
    parameters, held to ``SEIZURE_LOSS_TOL`` and ``SEIZURE_GRAD_TOL``.
    Returns (the CPU's losses, the largest relative loss difference, the
    largest gradient difference relative to its leaf's largest element)."""
    config, init, fwd = tr.MODELS[kind]
    cfg = config()
    cpu, card = init(cfg, 0, "cpu"), init(cfg, 0, "cuda")
    for t in tr.leaves(cpu) + tr.leaves(card):
        t.requires_grad_(True)
    step, opt = tr.make_train_step(cfg, fwd, w), tr.adam_state(cpu)
    losses, worst_loss, worst_grad = [], 0.0, 0.0
    for x, y in batches:
        with torch.no_grad():
            for a, b in zip(tr.leaves(card), tr.leaves(cpu)):
                a.copy_(b)
        got = tr.joint_loss(card, x, y, cfg, fwd, w)
        grads = torch.autograd.grad(got, tr.leaves(card))
        want = tr.joint_loss(cpu, x.cpu(), y.cpu(), cfg, fwd, w)
        wgrads = torch.autograd.grad(want, tr.leaves(cpu))
        worst_loss = max(worst_loss, abs(float(got.detach())
                                         - float(want.detach()))
                         / abs(float(want.detach())))
        for g, wg in zip(grads, wgrads):
            worst_grad = max(worst_grad, float(
                (g.cpu() - wg).abs().max() / wg.abs().max().clamp_min(
                    1e-30)))
        losses.append(float(step(cpu, opt, x.cpu(), y.cpu())))
    assert worst_loss <= SEIZURE_LOSS_TOL and \
        worst_grad <= SEIZURE_GRAD_TOL[kind], (kind, worst_loss, worst_grad)
    return losses, worst_loss, worst_grad


def run_seizure(torch, card, t_start):
    """Phase 14: the paper's seizure workload at the published configs
    (window 1024, 18 channels; CNN channels (32, 64, 64, 128); transformer
    d_model 64, 4 heads, 4 layers, patch 64), each at its operating point:
    300 steps of batch 64 from seed 0 on the card under the plain policy
    (autograd; the first 20 steps held against the port's CPU training
    from the same init and batches), then 2048 windows from seed 1
    evaluated through the kernels and through plain from the same trained
    parameters (launches counted over the kernels' run alone), the exit
    rate re-read at five thresholds, and the Fig. 3 table from the measured
    rates. Returns {kind: the kernels' launches}."""
    from repro_torch.core import xaif
    from repro_torch.train import early_exit as tr

    # cuDNN's deterministic convolutions, so that card runs repeat
    torch.backends.cudnn.deterministic = True
    t0 = time.perf_counter()
    cfg = tr.MODELS["cnn"][0]()        # both models read the same windows
    data = list(tr.signal_batches(range(SEIZURE_STEPS), 64, cfg, 0, "cuda"))
    evalb = tr.eval_batches(cfg, 2048, 1, "cuda")
    torch.cuda.synchronize()
    print(f"seizure data: {SEIZURE_STEPS} training batches of 64 and "
          f"{len(evalb)} evaluation batches of 256 on the card in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    per_batch = {"cnn": {"gemm": 2, "entropy_exit": 1},
                 "transformer": {"attention": 4, "attention_fp32": 4,
                                 "rmsnorm": 8, "gemm": 2,
                                 "entropy_exit": 1}}
    launches, rates = {}, {}
    for kind, w, th in tr.OPERATING_POINTS:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cfg, params, fwd, losses = tr.train_model(
            kind, w, steps=SEIZURE_STEPS, device="cuda", batches=data)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        n_params = sum(t.numel() for t in tr.leaves(params))
        print(f"seizure {kind}: {n_params} params, {SEIZURE_STEPS} steps "
              f"(weight {w}) on the card in {secs:.2f}s; loss {losses[0]:.4f}"
              f" -> {losses[-1]:.4f} on {card}", flush=True)
        # the card's training against the CPU's (cuDNN's convolutions with
        # TF32 off; tolerances above). The free-running trajectories part
        # (the CNN's max-pool / ReLU near-ties, Adam's early ~lr * sign(g)
        # steps), so their difference is printed, not held.
        t0 = time.perf_counter()
        cpu_losses, step_loss, step_grad = check_seizure_steps(
            torch, tr, kind, w, data[:SEIZURE_CPU_STEPS])
        diff = [abs(a - b) / b for a, b in zip(losses, cpu_losses)]
        print(f"seizure {kind}: first {SEIZURE_CPU_STEPS} steps against the "
              f"CPU's: from the CPU's parameters, loss max rel diff "
              f"{step_loss:.3e}, gradients max diff {step_grad:.3e} of the "
              f"leaf's largest (tol {SEIZURE_LOSS_TOL:g}, "
              f"{SEIZURE_GRAD_TOL[kind]:g}); free-running, losses max rel "
              f"diff {max(diff):.3e} (not held); CPU run "
              f"{time.perf_counter() - t0:.1f}s", flush=True)

        # through the kernels, counted, then plain on the same parameters
        torch.cuda.synchronize()
        xaif.reset_launch_counts()
        kern = tr.predict(cfg, params, fwd, evalb, th, "auto")
        torch.cuda.synchronize()
        launches[kind] = {k: n for k, n in xaif.launch_counts().items() if n}
        plain = tr.predict(cfg, params, fwd, evalb, th, "ref")
        errs = {}
        for key in ("logits", "exit_logits", "entropy"):
            a, b = kern[key], plain[key]
            errs[key] = float((a - b).abs().max())
            assert bool(((a - b).abs() <= 1e-4 + 1e-4 * b.abs()).all()), (
                kind, key, errs[key])
        near = (plain["entropy"] - th).abs() < 1e-5
        assert torch.equal(kern["exited"][~near], plain["exited"][~near]), (
            kind, "exit decisions differ")
        want = {k: len(evalb) * n for k, n in per_batch[kind].items()}
        assert launches[kind] == want, (kind, launches[kind], want)
        m = tr.metrics(kern)
        print(f"seizure {kind}: 2048 windows through the kernels against "
              f"plain: max abs err {errs} (tol 1e-4 + 1e-4*|ref|); exit "
              f"decisions equal ({int(near.sum())} rows within 1e-5 of the "
              f"threshold {th}); launches {launches[kind]}; exit rate "
              f"{m['exit_rate']:.4f}, F1 {m['f1_full']:.4f} -> "
              f"{m['f1_early_exit']:.4f}, accuracy {m['accuracy_full']:.4f} "
              f"-> {m['accuracy_early_exit']:.4f}", flush=True)
        assert m["f1_full"] >= 0.9 and m["exit_rate"] > 0.5, (kind, m)
        sweep = [tr.metrics(tr.predict(cfg, params, fwd, evalb, t,
                                       "auto"))["exit_rate"]
                 for t in SEIZURE_THRESHOLDS]
        assert all(a <= b for a, b in zip(sweep, sweep[1:])), (kind, sweep)
        print(f"seizure {kind}: exit rate at thresholds "
              f"{dict(zip(SEIZURE_THRESHOLDS, sweep))}: never falls",
              flush=True)
        rates[kind] = m["exit_rate"]

    for kind, table in tr.fig3_table(rates).items():
        print(f"fig3 {kind} exit rate {table['exit_rate']:.4f}: " + "; ".join(
            f"{name} speedup {v['speedup']:.2f}x energy {v['energy_gain']:.2f}x"
            f" (paper {v['paper_speedup']}x, {v['paper_energy_gain']}x)"
            for name, v in table.items()
            if name not in ("exit_rate", "cpu_baseline")),
            flush=True)

    # a kernel launch under autograd raises, and launches nothing
    x = torch.randn(4, 64, device="cuda", requires_grad=True)
    before = xaif.launch_counts()
    try:
        xaif.call("gemm", "auto", x, torch.randn(64, 2, device="cuda"))
    except RuntimeError as e:
        assert "requires grad" in str(e), e
    else:
        raise AssertionError("a gemm launch under autograd did not raise")
    assert xaif.launch_counts() == before
    torch.backends.cudnn.deterministic = False
    print(f"seizure: a kernel launch under autograd raises; phase done at "
          f"{time.perf_counter() - t_start:.1f}s", flush=True)
    return launches


# phase 15: the LM training path. (a) Reduced configs in fp32, each
# train step on the card from the CPU's parameters and AdamW state before
# it, against the CPU's step (the embedding's gradient sums by atomics on
# the card, so bits are not required): loss 1e-5 and grad_norm 1e-4
# relative, parameters after the step 1e-5 + 1e-4 |p|. Reduced xlstm's
# gradients are chaotic at fp32 rounding (its mLSTM and sLSTM layers
# together: a grad norm of ~7000, and on the CPU a 1e-7 relative change of
# its parameters moves the three steps' grad_norm by 5.2e-2 relative and
# the parameters after them to 3.5 times the bound; the loss by 9.2e-6):
# its grad_norm is held to 0.15 and its parameters to 7 times the bound,
# 3x and 2x that sensitivity (the card's first reading: 3.2e-2, 2.0).
# (b) Full-width musicgen-medium trained through ``train()``: bf16
# parameters with an fp32 master, remat "nothing", the launcher's peak
# learning rate.
TRAIN_ARCHS = {"yi-9b": {}, "deepseek-v2-lite-16b": {}, "jamba-v0.1-52b": {},
               "xlstm-350m": {}, "musicgen-medium": dict(num_kv_heads=4)}
TRAIN_CHECK_STEPS = 3
TRAIN_LOSS_TOL = 1e-5                                      # relative
TRAIN_GNORM_TOL = {"xlstm-350m": 0.15}                     # else 1e-4
TRAIN_PARAM_BOUNDS = {"xlstm-350m": 7.0}       # x (1e-5 + 1e-4 |p|), else 1
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_LR = 120, 8, 256, 1e-3
TRAIN_LOG_EVERY = 10


def copy_train_state(torch, state, device):
    """A ``TrainState`` (parameters and AdamW state) copied to ``device``."""
    from repro_torch.models import lm
    from repro_torch.train.train_step import TrainState

    def tree(t):
        return None if t is None else lm._map(
            t, lambda a: a.detach().to(device, copy=True))
    opt = state.opt
    return TrainState(tree(state.params), opt._replace(
        step=opt.step.to(device, copy=True), m=tree(opt.m), v=tree(opt.v),
        master=tree(opt.master)))


def check_train_steps(torch, name):
    """Phase 15(a): ``TRAIN_CHECK_STEPS`` steps of the reduced ``name`` in
    fp32 (``make_train_step`` under "ref", remat "nothing", batch 4 x 32
    from ``lm_batches``), each from the CPU's state on both devices, the
    card against the CPU (``TRAIN_LOSS_TOL``, ``TRAIN_GNORM_TOL``,
    ``TRAIN_PARAM_BOUNDS``); no kernel launched. Returns the
    largest relative loss and grad-norm differences and the largest
    parameter difference over its bound."""
    from repro_torch.configs.base import RunConfig, get_arch
    from repro_torch.core import xaif
    from repro_torch.data.pipeline import lm_batches
    from repro_torch.models import lm
    from repro_torch.optim.adamw import init_adamw
    from repro_torch.train.train_step import TrainState, make_train_step

    cfg = get_arch(name).reduced(dtype="float32", **TRAIN_ARCHS[name])
    _, step = make_train_step(RunConfig(cfg, policy="ref", remat="nothing",
                                        learning_rate=TRAIN_LR))
    params = lm.init_lm(cfg, seed=0, device="cpu")
    cpu = TrainState(params, init_adamw(params))
    data = lm_batches(cfg.vocab_size, 4, 32, seed=0)
    worst = dict(loss=0.0, grad_norm=0.0, params=0.0)
    xaif.reset_launch_counts()
    for _ in range(TRAIN_CHECK_STEPS):
        batch = {k: torch.from_numpy(v) for k, v in next(data).items()
                 if k != "step"}
        card, got = step(copy_train_state(torch, cpu, "cuda"),
                         {k: v.cuda() for k, v in batch.items()})
        cpu, want = step(cpu, batch)
        for k in ("loss", "grad_norm"):
            worst[k] = max(worst[k], abs(float(got[k]) - float(want[k]))
                           / abs(float(want[k])))
        for a, b in zip(lm._leaves(card.params), lm._leaves(cpu.params)):
            err = (a.cpu().float() - b.float()).abs()
            worst["params"] = max(worst["params"], float(
                (err / (1e-5 + 1e-4 * b.float().abs())).max()))
    torch.cuda.synchronize()
    launched = {k: n for k, n in xaif.launch_counts().items() if n}
    assert not launched, (name, launched)
    gtol = TRAIN_GNORM_TOL.get(name, 1e-4)
    ptol = TRAIN_PARAM_BOUNDS.get(name, 1.0)
    print(f"train {name} (reduced, fp32, {cfg.num_layers} layers): "
          f"{TRAIN_CHECK_STEPS} steps on the card, each from the CPU's "
          f"state, against the CPU's: loss max rel diff "
          f"{worst['loss']:.3e} (tol {TRAIN_LOSS_TOL:g}), grad_norm "
          f"{worst['grad_norm']:.3e} (tol {gtol:g}), parameters after the "
          f"step {worst['params']:.3f} of the bound 1e-5 + 1e-4 |p| (at "
          f"most {ptol:g}); no kernel launched", flush=True)
    assert worst["loss"] <= TRAIN_LOSS_TOL and worst["grad_norm"] <= gtol \
        and worst["params"] <= ptol, (name, worst)
    return worst


def train_musicgen(torch, card):
    """Phase 15(b): full-width musicgen-medium trained for ``TRAIN_STEPS``
    steps through ``train()`` (batch ``TRAIN_BATCH`` x ``TRAIN_SEQ`` from
    ``lm_batches``, "ref", bf16 parameters with an fp32 master, remat
    "nothing", peak learning rate ``TRAIN_LR``), every launch counter
    reset just before and read just after. The ms a step by CUDA events
    over each window of ``TRAIN_LOG_EVERY`` steps after the first (an
    event recorded at each of the trainer's log lines, which follow a host
    read of the step's metrics), the peak allocation, and the losses.
    Asserts: every loss and grad norm finite; the mean of the last 10
    final and exit losses below the mean of their first 10; no kernel
    launched. Returns (the trained parameters, the history, the launch
    counts of the run)."""
    from repro_torch.configs.base import RunConfig, get_arch
    from repro_torch.core import xaif
    from repro_torch.models import lm
    from repro_torch.train.trainer import train

    cfg = get_arch("musicgen-medium")
    params = lm.init_lm(cfg, seed=0, device="cuda")
    run = RunConfig(cfg, policy="ref", remat="nothing",
                    learning_rate=TRAIN_LR)
    marks, lines = [], []

    def log(line):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append(ev)
        lines.append(line)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    xaif.reset_launch_counts()
    t0 = time.perf_counter()
    hist = train(run, TRAIN_STEPS, log_every=TRAIN_LOG_EVERY,
                 batch_override=TRAIN_BATCH, seq_override=TRAIN_SEQ,
                 print_fn=log, params=params)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = xaif.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    windows = [a.elapsed_time(b) / TRAIN_LOG_EVERY
               for a, b in zip(marks, marks[1:])]
    n_params = sum(t.numel() for t in lm._leaves(params))
    first, last = {}, {}
    for k in ("loss", "loss_final", "loss_exit0", "aux_loss", "grad_norm",
              "lr"):
        v = hist[k]
        assert len(v) == TRAIN_STEPS and all(math.isfinite(x) for x in v), k
        first[k], last[k] = sum(v[:10]) / 10, sum(v[-10:]) / 10
    print(f"train musicgen-medium: {cfg.num_layers} layers d_model="
          f"{cfg.d_model}, {n_params / 1e9:.3f}B params (bf16, fp32 master "
          f"and moments), {TRAIN_STEPS} steps of {TRAIN_BATCH} x "
          f"{TRAIN_SEQ} tokens, peak lr {TRAIN_LR:g}, in {secs:.1f}s: "
          f"{sorted(windows)[len(windows) // 2]:.1f} ms a step by CUDA "
          f"events (median of the {TRAIN_LOG_EVERY}-step windows after the "
          f"first: {[round(w, 1) for w in windows]}); peak allocated "
          f"{peak / 2**30:.2f} GiB; loss_final {hist['loss_final'][0]:.4f} "
          f"-> {hist['loss_final'][-1]:.4f} (mean of 10: "
          f"{first['loss_final']:.4f} -> {last['loss_final']:.4f}), "
          f"loss_exit0 {hist['loss_exit0'][0]:.4f} -> "
          f"{hist['loss_exit0'][-1]:.4f} ({first['loss_exit0']:.4f} -> "
          f"{last['loss_exit0']:.4f}), grad_norm {hist['grad_norm'][0]:.3f} "
          f"-> {hist['grad_norm'][-1]:.3f}; trainer lines {lines[-1]!r}; "
          f"launches {launches} on {card}", flush=True)
    assert last["loss_final"] < first["loss_final"], (first, last)
    assert last["loss_exit0"] < first["loss_exit0"], (first, last)
    assert not any(launches.values()), launches
    return params, hist, launches


def serve_trained(torch, run_serve, runs, params, t_start):
    """Phase 15(c): the trained musicgen-medium served through the kernels
    (``run_zoo`` with its parameters: phases 12b-12c's checks, the
    prefill against the plain policy by ``check_prefill``'s bounds, every
    launch counter exactly ``zoo_launches``, paged == contiguous and
    request 0 == ``generate``, bitwise, the spec runs); then the same
    requests under the plain policy, whose tokens may part from the
    kernels' only at near ties (``near_tie_parts``, at 5x the prefill
    logits' RMS distance), and, as findings, the exit rate at the config's
    threshold and one gated serve's skipped steps and gated fraction."""
    cfg, last, prompts, run = run_zoo(
        torch, run_serve, t_start, "musicgen-medium", {},
        ("tied-paged", "draft2l-contiguous"), params=params)
    plain = run_serve("musicgen-medium-trained-plain", cfg, params, prompts,
                      policy="ref")
    rms = float((last["kernels"] - last["plain"]).pow(2).mean().sqrt())
    parted = near_tie_parts(torch, cfg, params, prompts, plain["tokens"],
                            run["tokens"], rms)
    gated, skipped, idle = gated_steps(run_serve, "musicgen-medium-trained-"
                                       "gated", cfg, params, prompts)
    stats, gstats = run["report"].stats, gated["report"].stats
    print(f"serve musicgen-medium trained: plain-policy tokens == the "
          f"kernels' on {len(prompts) - len(parted)} of {len(prompts)} "
          f"requests, the rest parted at near ties (request, step, gap, "
          f"exact tie) {parted} (bound max(0.1, 5 x {rms:.3e})); exit rate "
          f"at threshold {cfg.early_exit.entropy_threshold} "
          f"{stats['exit_rate']:.4f}; gated serve: {skipped} of "
          f"{gated['steps']} steps skipped ({idle} with no live slot), "
          f"exit rate {gstats['exit_rate']:.4f}, gated fraction "
          f"{gstats['gated_fraction']:.4f}", flush=True)
    return run


def run_training(torch, run_serve, runs, card, t_start):
    """Phase 15: the LM training path ((a), (b)), then the trained weights
    served through the kernels ((c)). Returns the launch counts of the
    training steps."""
    t0 = time.perf_counter()
    for name in TRAIN_ARCHS:
        check_train_steps(torch, name)
    print(f"phase 15(a) took {time.perf_counter() - t0:.1f}s", flush=True)
    t0 = time.perf_counter()
    params, _, launches = train_musicgen(torch, card)
    torch.cuda.empty_cache()       # the optimizer state went with train()
    print(f"phase 15(b) took {time.perf_counter() - t0:.1f}s; "
          f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB on the card",
          flush=True)
    t0 = time.perf_counter()
    serve_trained(torch, run_serve, runs, params, t_start)
    del params
    torch.cuda.empty_cache()
    print(f"phase 15(c) took {time.perf_counter() - t0:.1f}s; phase 15 done "
          f"at {time.perf_counter() - t_start:.1f}s", flush=True)
    return launches


def main() -> int:

    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script runs on a CUDA card")
    from repro_torch.configs.base import get_arch
    from repro_torch.kernels import _build
    from repro_torch.models import lm
    from repro_torch.serve.engine import SlotEngine, SpecConfig, generate

    # -- 1. setup -----------------------------------------------------------
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = t0 = time.perf_counter()
    libs = _build.build_all()
    print(f"built {sorted(libs)} in {time.perf_counter() - t0:.1f}s",
          flush=True)
    card = card_line()
    timer = Timer(torch)

    # -- 2. kernels against their plain versions ----------------------------
    records = check_kernels(torch, timer)

    # -- 3. full-width yi-9b: kernels against the plain policy --------------
    cfg = get_arch("yi-9b")
    t0 = time.perf_counter()
    params = lm.init_lm(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in lm._leaves(params))
    print(f"yi-9b: {cfg.num_layers} layers d_model={cfg.d_model} "
          f"{n_params / 1e9:.3f}B params ({cfg.dtype}) initialised in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    yi_last = check_prefill(torch, lm, cfg, params)

    # -- 4. serve through the engine; counters cover this run only ---------
    prompts = make_prompts(torch, cfg.vocab_size)
    runs = {}

    run_serve = functools.partial(serve_run, torch, runs, card)

    plain = run_serve("contiguous", cfg, params, prompts)
    assert set(plain["launches"]) == {"gemm", "rmsnorm", "attention",
                                      "attn_decode", "entropy_exit"}, plain
    assert plain["launches"]["attn_decode"] == \
        cfg.num_layers * plain["steps"], plain["launches"]
    ref_toks, _ = generate(cfg, params, prompts[0][None], 24)
    assert ref_toks[0].tolist() == plain["tokens"][0], (
        "engine tokens differ from generate", ref_toks[0].tolist(),
        plain["tokens"][0])
    want = zoo_launches(cfg, plain["steps"], plain["prefills"], paged=False)
    assert plain["launches"] == want, (plain["launches"], want)
    print(f"serve contiguous: request 0 == generate, bitwise; launches "
          f"exactly {want}", flush=True)
    profile_decode(torch, "yi-9b", SlotEngine(cfg, capacity=4, max_len=160,
                                               chunk=8), params, prompts)

    # -- 4b. gated early-exit decode: thresholds -1, 2 and one among the
    #    exit entropies; a skipped and a full step traced ----------------
    run_gated_yi(torch, run_serve, cfg, params, prompts, plain)

    # -- 5. the paged engine: 24 usable pages for 4 slots that could ask
    #    for 40; tokens equal the contiguous engine's, bitwise -------------
    paged = run_serve("paged", cfg, params, prompts, paged=True,
                      page_size=16, num_pages=25)
    assert paged["tokens"] == plain["tokens"], "paged tokens differ"
    assert paged["report"].stats["peak_pages"] <= 24, paged["report"].stats
    assert paged["launches"]["attn_decode_paged"] == \
        cfg.num_layers * paged["steps"], paged["launches"]
    assert "attn_decode" not in paged["launches"], paged["launches"]
    print("serve paged: tokens == contiguous engine, bitwise, per request",
          flush=True)

    # -- 5b. prefix sharing: 8 shared-prefix requests unshared, then shared
    #    on 24 pages twice and on a pool just above the working set;
    #    chunked prefill; a fork-point admission timed -------------------
    run_sharing(torch, run_serve, "yi-9b", cfg, params,
                small_pool=SHARE_SMALL_POOL)
    run_chunked(torch, cfg, params)
    time_admission(torch, cfg, params, card)

    # -- 5c. overload control: preemption with host swap and with recompute
    #    resume, chunked admission under priorities, a sampled pair ------
    run_overload(torch, run_serve, cfg, params, card)

    # -- 6. greedy speculative decoding, against plain greedy on yi-9b
    #    without its exit heads (the same weights) -------------------------
    cfg_ne = dataclasses.replace(cfg, early_exit=None)
    greedy = run_serve("plain-noexit", cfg_ne, params, prompts)
    tied = run_serve("spec-tied-paged", cfg_ne, params, prompts, paged=True,
                     page_size=16, num_pages=25,
                     spec=SpecConfig(draft_arch=cfg_ne, k=3,
                                     share_params=True))
    assert tied["tokens"] == greedy["tokens"], "tied spec tokens differ"
    assert tied["report"].stats["spec_acceptance"] == 1.0, \
        tied["report"].stats
    assert tied["launches"]["verify_decode_paged"] == \
        cfg.num_layers * tied["steps"], tied["launches"]
    draft = dataclasses.replace(cfg_ne, name="yi-9b-draft-2l", num_layers=2)
    indep = run_serve("spec-draft2l-contiguous", cfg_ne, params, prompts,
                      spec=SpecConfig(draft_arch=draft, k=3, draft_seed=1))
    assert indep["tokens"] == greedy["tokens"], "independent spec differs"
    assert indep["launches"]["verify_decode"] == \
        cfg.num_layers * indep["steps"], indep["launches"]
    print(f"serve spec: tied (paged) and independent 2-layer draft "
          f"(contiguous) tokens == plain greedy, bitwise; acceptance tied "
          f"{tied['report'].stats['spec_acceptance']:.3f}, independent "
          f"{indep['report'].stats['spec_acceptance']:.3f}", flush=True)

    # -- 6e-6f. sampled decode (temperature, top-k, top-p, seeded requests)
    #    and sampled speculative decoding ----------------------------------
    run_sampling(torch, run_serve, cfg, params, prompts, plain)
    run_sampled_spec(torch, run_serve, cfg_ne, params, prompts)

    # -- 5d. fault-tolerant serving: kill and resume at every site, the
    #    chaos backend with and without a breaker, the watchdog, NaN
    #    quarantine (after 6e: its seeded run is a reference) ------------
    run_resilient(torch, run_serve, runs, cfg, params, prompts, card)

    # -- 5e. the shape-aware dispatch policy: autotune at yi-9b's serve
    #    dims, then the all-kernel, tuned and mixed policies served -------
    tuned = run_dispatch(torch, run_serve, runs, cfg, params, prompts, card)

    # -- 6b-6d. yi-9b on int8 weights (the bf16 weights still on the card):
    #    weight-only contiguous and paged, W8A8 contiguous ----------------
    qparams = run_quantized(torch, run_serve, cfg, params, prompts,
                            yi_last["kernels"])
    print(f"yi-9b phases done at {time.perf_counter() - t_start:.1f}s",
          flush=True)

    # -- 7. full-width, full-depth deepseek-v2-lite-16b (MLA + MoE): yi's
    #    weights, bf16 and int8, are freed first (with them deepseek would
    #    not fit) --------------------------------------------------------
    del params, qparams, ref_toks, yi_last
    torch.cuda.empty_cache()
    ds = get_arch("deepseek-v2-lite-16b")
    t0 = time.perf_counter()
    dparams = lm.init_lm(ds, seed=0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in lm._leaves(dparams))
    print(f"{ds.name}: {ds.num_layers} layers (first {ds.first_k_dense} "
          f"dense) d_model={ds.d_model} {ds.moe.num_experts} experts top-"
          f"{ds.moe.top_k} {n_params / 1e9:.3f}B params ({ds.dtype}) "
          f"initialised in {time.perf_counter() - t0:.1f}s; "
          f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB on the card",
          flush=True)
    # kernels against plain at full depth in bf16, both against fp32
    # compute on the same bf16 weights (an fp32 copy of all 27 layers would
    # not fit beside them); and against an fp32 weight copy at a cut depth
    # (the dense layer + 3 MoE layers, full width). A near-tie in routing
    # sends a token to other experts, so rounding differences grow with
    # depth more than in a dense model: the bounds are 2x the readings of
    # 64 prompts (full depth: max 0.139, mean 0.0575) and 32 prompts (cut:
    # max 0.094, mean 0.0233) on the H100 (PERF.md)
    check_prefill(torch, lm, ds, dparams, n_prompts=128, fp32_copy=False,
                  max_rel=0.3, max_mean_rel=0.12)
    cut = dataclasses.replace(ds, num_layers=4, early_exit=None)
    cut_params = {k: v for k, v in dparams.items() if k != "exits"}
    cut_params["slots"] = (lm._map(dparams["slots"][0], lambda t: t[:3]),)
    check_prefill(torch, lm, cut, cut_params, n_prompts=128, max_rel=0.2,
                  max_mean_rel=5e-2)
    del cut_params
    torch.cuda.empty_cache()

    # -- 8. serve deepseek: contiguous, then paged ----------------------
    serve_deepseek(torch, run_serve, ds, dparams, t_start)

    # -- 9-10. jamba-v0.1-52b, two super-blocks: deepseek's 29.4 GiB are
    #    freed before jamba's 48.5 GiB are built -------------------------
    del dparams
    torch.cuda.empty_cache()
    run_jamba(torch, run_serve, t_start)

    # -- 11-12. xlstm-350m, full depth: jamba's weights (local to
    #    run_jamba) are freed first ----------------------------------------
    torch.cuda.empty_cache()
    run_xlstm(torch, run_serve, t_start)

    # -- 12d-12h. the rest of the zoo (musicgen-medium, head dim 64, is
    #    served in phase 15(c) on the weights phase 15 trains; xlstm's
    #    weights, local to run_xlstm, are freed first), each arch's weights
    #    freed before the next is built: (arch,
    #    check_prefill's arguments, spec runs). The
    #    four large ones compute fp32 on their bf16 weights (an fp32 copy
    #    would not fit beside them). qwen3-moe's 48 MoE layers route
    #    near-ties apart, as deepseek's do: its plain path's RMS distance
    #    from fp32 (0.034) sets the clear gap at 0.168, which 1 prompt of 8
    #    reached on the H100, so it takes 64 prompts, and bounds at ~2x the
    #    8-prompt readings (kernels vs plain max 0.043, mean 0.031) with
    #    room for the larger max of 64; the others read max 0.018-0.025
    #    and 5-6 clear prompts of 8 under the default bounds (PERF.md). At
    #    half depth the random logits' top-2 gaps shrink: qwen1.5 at 32
    #    layers read 2 clear prompts of 8 (kernels vs plain max 0.0196,
    #    argmax 8/8 equal), so it and chameleon, cut alike, take 64 prompts
    #    as qwen3-moe does ---
    for name, prefill, spec in (
            ("chatglm3-6b", {}, ("tied-paged", "draft2l-contiguous")),
            ("qwen1.5-32b", dict(fp32_copy=False, n_prompts=64), ()),
            ("qwen3-moe-30b-a3b", dict(fp32_copy=False, n_prompts=64,
                                       max_rel=0.15, max_mean_rel=0.0625),
             ()),
            ("chameleon-34b", dict(fp32_copy=False, n_prompts=64), ()),
            ("mistral-large-123b", dict(fp32_copy=False), ("tied-paged",))):
        torch.cuda.empty_cache()
        # gated decode (phases 12e, 12g): chatglm3's QKV biases and half
        # rotary, chameleon's K-norm in the propagated rows
        run_zoo(torch, run_serve, t_start, name, prefill, spec,
                gated=name in ("chatglm3-6b", "chameleon-34b"),
                sharing=name == "chatglm3-6b")

    # -- 13. the scalar fp32 flash instance is on no serving path ----------
    fp32 = [n for n, r in runs.items() if "attention_fp32" in r["launches"]]
    assert not fp32, f"fp32 flash attention launched on {fp32}"
    print(f"launches: no fp32 flash attention in the {len(runs)} serve runs",
          flush=True)

    # -- 14. the paper's seizure workload: train, evaluate, Fig. 3 ---------
    torch.cuda.empty_cache()
    seizure = run_seizure(torch, card, t_start)
    tf, cnn = seizure["transformer"], seizure["cnn"]

    # -- 15. the LM training path: reduced configs held step by step against
    #    the CPU, full-width musicgen-medium trained (no kernel launched),
    #    then served through the kernels (phases 12b-12c on its trained
    #    weights) -------------------------------------------------------
    torch.cuda.empty_cache()
    train_launches = run_training(torch, run_serve, runs, card, t_start)

    # -- 16. the kernels line, the card, the verdict -------------------------
    replaces = {   # kernel: (what it replaces, source, run, counter)
        "gemm": ("kernels/gemm/gemm.py:48", "gemm", "contiguous", "gemm"),
        "rmsnorm": ("kernels/rmsnorm/rmsnorm.py:26", "rmsnorm", "contiguous",
                    "rmsnorm"),
        "attention": ("kernels/flash_attention/flash_attention.py:70",
                      "flash_attention", "contiguous", "attention"),
        "attn_decode": ("kernels/attn_decode/attn_decode.py:73",
                        "attn_decode", "contiguous", "attn_decode"),
        "entropy_exit": ("kernels/entropy_exit/entropy_exit.py:68",
                         "entropy_exit", "contiguous", "entropy_exit"),
        "attn_decode_paged": ("kernels/paged_attention/paged_attention.py:73",
                              "paged_attention", "paged",
                              "attn_decode_paged"),
        "verify_decode": ("kernels/verify_decode/verify_decode.py:77",
                          "verify_decode", "spec-draft2l-contiguous",
                          "verify_decode"),
        "verify_decode_paged": ("kernels/verify_decode/verify_decode.py:162",
                                "verify_decode", "spec-tied-paged",
                                "verify_decode_paged"),
        # the (192, 128) instance of the flash kernel: every attention
        # launch of the deepseek run is of this instance
        "attention_mla": ("kernels/flash_attention/flash_attention.py:70",
                          "flash_attention", "deepseek-contiguous",
                          "attention"),
        # precise mode: every attn_decode launch of the deepseek run
        "attn_decode_mla": ("kernels/attn_decode/attn_decode.py:73",
                            "attn_decode_mla", "deepseek-contiguous",
                            "attn_decode"),
        "moe_decode": ("kernels/moe_decode/moe_decode.py:46", "moe_decode",
                       "deepseek-contiguous", "moe_decode"),
        # no Pallas kernel: the absorbed decode's two fp32 einsums
        "gemm_heads": ("models/attention.py:549", "gemm",
                       "deepseek-contiguous", "gemm_heads"),
        "ssm_scan": ("kernels/ssm_scan/ssm_scan.py:63", "ssm_scan",
                     "jamba-contiguous", "ssm_scan"),
        "ssm_decode": ("kernels/ssm_decode/ssm_decode.py:43", "ssm_decode",
                       "jamba-contiguous", "ssm_decode"),
        # moe_decode at jamba's h = 14336 (the chunked down pass)
        "moe_decode_jamba": ("kernels/moe_decode/moe_decode.py:46",
                             "moe_decode", "jamba-contiguous", "moe_decode"),
        # precise mode: every attn_decode_paged launch of the deepseek
        # paged run
        "attn_decode_paged_mla": (
            "kernels/paged_attention/paged_attention.py:73",
            "paged_attention_mla", "deepseek-paged", "attn_decode_paged"),
        # the mLSTM mode of ssm_decode: every ssm_decode launch of the
        # xlstm run
        "mlstm_decode": ("kernels/ssm_decode/ssm_decode.py:104",
                         "mlstm_decode", "xlstm-contiguous", "ssm_decode"),
        # W8A8: every GEMM launch of the yi-9b W8A8 run
        "gemm_int8": ("kernels/gemm/gemm.py:108", "gemm_int8",
                      "w8a8-contiguous", "gemm_int8"),
        # the int8-weight instance of gemm (JAX's gemm_pallas on the
        # dequantized weights): every gemm launch of the weight-only run
        "gemm_wq": ("kernels/gemm/gemm.py:48", "gemm", "wq-contiguous",
                    "gemm_wq"),
        # the head-dim-64 instances: every attention launch of the
        # musicgen runs
        "attn_decode_d64": ("kernels/attn_decode/attn_decode.py:73",
                            "attn_decode", "musicgen-medium-contiguous",
                            "attn_decode"),
        "attn_decode_paged_d64": (
            "kernels/paged_attention/paged_attention.py:73",
            "paged_attention", "musicgen-medium-paged", "attn_decode_paged"),
        "verify_decode_d64": ("kernels/verify_decode/verify_decode.py:77",
                              "verify_decode",
                              "musicgen-medium-spec-draft2l-contiguous",
                              "verify_decode"),
        "verify_decode_paged_d64": (
            "kernels/verify_decode/verify_decode.py:162", "verify_decode",
            "musicgen-medium-spec-tied-paged", "verify_decode_paged"),
        "attention_bf16_d64": ("kernels/flash_attention/flash_attention.py:70",
                               "flash_attention", "musicgen-medium-contiguous",
                               "attention"),
        # the rest of the zoo at head dim 128 (phase 2's rows at each
        # group): every decode-attention launch of the arch's runs, groups
        # 16 (chatglm3-6b), 1 (qwen1.5-32b) and 12 (mistral-large-123b)
        "attn_decode_g16": ("kernels/attn_decode/attn_decode.py:73",
                            "attn_decode", "chatglm3-6b-contiguous",
                            "attn_decode"),
        "attn_decode_paged_g16": (
            "kernels/paged_attention/paged_attention.py:73",
            "paged_attention", "chatglm3-6b-paged", "attn_decode_paged"),
        "verify_decode_g16": ("kernels/verify_decode/verify_decode.py:77",
                              "verify_decode",
                              "chatglm3-6b-spec-draft2l-contiguous",
                              "verify_decode"),
        "verify_decode_paged_g16": (
            "kernels/verify_decode/verify_decode.py:162", "verify_decode",
            "chatglm3-6b-spec-tied-paged", "verify_decode_paged"),
        "attn_decode_g1": ("kernels/attn_decode/attn_decode.py:73",
                           "attn_decode", "qwen1.5-32b-contiguous",
                           "attn_decode"),
        "attn_decode_paged_g1": (
            "kernels/paged_attention/paged_attention.py:73",
            "paged_attention", "qwen1.5-32b-paged", "attn_decode_paged"),
        "attn_decode_g12": ("kernels/attn_decode/attn_decode.py:73",
                            "attn_decode", "mistral-large-123b-contiguous",
                            "attn_decode"),
        "attn_decode_paged_g12": (
            "kernels/paged_attention/paged_attention.py:73",
            "paged_attention", "mistral-large-123b-paged",
            "attn_decode_paged"),
        "verify_decode_paged_g12": (
            "kernels/verify_decode/verify_decode.py:162", "verify_decode",
            "mistral-large-123b-spec-tied-paged", "verify_decode_paged"),
        # moe_decode at 128 experts of 2048 x 768, top-8: every moe_decode
        # launch of the qwen3-moe run
        "moe_decode_qwen3": ("kernels/moe_decode/moe_decode.py:46",
                             "moe_decode", "qwen3-moe-30b-a3b-contiguous",
                             "moe_decode"),
        # rmsnorm over the head dim (QK-norm): the qwen3-moe run's rmsnorm
        # launches, 2 of every 4 a layer of them on q and k
        "rmsnorm_qk_d128": ("kernels/rmsnorm/rmsnorm.py:26", "rmsnorm",
                            "qwen3-moe-30b-a3b-contiguous", "rmsnorm"),
    }
    kernels = [dict(name=name, route="cuda",
                    source=f"src/repro_torch/csrc/{src}.cu",
                    replaces=f"src/repro/{tpu}",
                    launches=runs[run]["launches"][counter], **records[name])
               for name, (tpu, src, run, counter) in replaces.items()]
    # forward_decode_gated's path (phases 4b, 8c, 12e, 12g): the kernels of
    # a threshold-2.0 gated serve, every decode step skipped, with their
    # launches there (prefills included)
    gated_paths = {
        "gemm": "gated-thr2", "rmsnorm": "gated-thr2",
        "attention": "gated-thr2", "attn_decode": "gated-thr2",
        "entropy_exit": "gated-thr2",
        "attention_mla": "deepseek-v2-lite-16b-gated-thr2",
        "attn_decode_mla": "deepseek-v2-lite-16b-gated-thr2",
        "moe_decode": "deepseek-v2-lite-16b-gated-thr2",
        "gemm_heads": "deepseek-v2-lite-16b-gated-thr2",
        "attn_decode_g16": "chatglm3-6b-gated-thr2"}
    for k in kernels:
        if k["name"] in gated_paths:
            run, counter = gated_paths[k["name"]], replaces[k["name"]][3]
            k["paths"] = ["serve", "forward_decode_gated"]
            k["gated_launches"] = runs[run]["launches"][counter]
    # the prefix-sharing path (phases 5b, 12e): the kernels of the first
    # 24-page sharing run of yi-9b (chatglm3's decode instance: of its
    # own), with their launches there (standard and fork-point admissions
    # and decode steps)
    sharing_paths = {
        "gemm": "yi-9b-share", "rmsnorm": "yi-9b-share",
        "attention": "yi-9b-share", "attn_decode_paged": "yi-9b-share",
        "entropy_exit": "yi-9b-share",
        "attn_decode_paged_g16": "chatglm3-6b-share"}
    for k in kernels:
        if k["name"] in sharing_paths:
            run, counter = sharing_paths[k["name"]], replaces[k["name"]][3]
            k["paths"] = k.get("paths", ["serve"]) + ["prefix_sharing"]
            k["sharing_launches"] = runs[run]["launches"][counter]
    # the overload path (phase 5c): the kernels of yi-9b's chunked run
    # under priorities (standard, recomputed and chunked admissions,
    # swap resumes, decode steps), with their launches there
    for k in kernels:
        if k["name"] in ("gemm", "rmsnorm", "attention", "attn_decode_paged",
                         "entropy_exit"):
            counter = replaces[k["name"]][3]
            k["paths"] = k.get("paths", ["serve"]) + ["overload"]
            k["overload_launches"] = runs["yi-9b-overload-chunked"][
                "launches"][counter]
    # the fault-tolerant path (phase 5d): the five kernels of yi-9b's
    # supervised streams whose armed injector never fires, with their
    # launches there (== the plain serve's)
    for k in kernels:
        if k["name"] in ("gemm", "rmsnorm", "attention", "attn_decode",
                         "attn_decode_paged", "entropy_exit"):
            run = ("resilient-never-paged" if k["name"] == "attn_decode_paged"
                   else "resilient-never-contiguous")
            k["paths"] = k.get("paths", ["serve"]) + ["resilient"]
            k["resilient_launches"] = runs[run]["launches"][
                replaces[k["name"]][3]]
    # the shape-aware dispatch path (phase 5e): the kernels of yi-9b's
    # serves under the tuned DispatchPolicy, with their launches there;
    # and each kernel's autotune cells (the generic ones fp32, yi-9b's in
    # its dtype), each backend's ms and the winner
    for k in kernels:
        if k["name"] in ("gemm", "rmsnorm", "attention", "attn_decode",
                         "attn_decode_paged", "entropy_exit"):
            kind = "paged" if k["name"] == "attn_decode_paged" \
                else "contiguous"
            k["paths"] = k.get("paths", ["serve"]) + ["dispatch_policy"]
            k["dispatch_launches"] = runs[f"dispatch-tuned-{kind}"][
                "launches"].get(replaces[k["name"]][3], 0)
    # the training path (phase 15(b)): no kernel launches in the steps;
    # musicgen's kernels then serve the trained weights (phase 15(c): the
    # musicgen runs of the replaces table, with their launches there)
    trained = {"gemm": "musicgen-medium-contiguous",
               "rmsnorm": "musicgen-medium-contiguous",
               "entropy_exit": "musicgen-medium-contiguous",
               "attention_bf16_d64": "musicgen-medium-contiguous",
               "attn_decode_d64": "musicgen-medium-contiguous",
               "attn_decode_paged_d64": "musicgen-medium-paged",
               "verify_decode_d64": "musicgen-medium-spec-draft2l-contiguous",
               "verify_decode_paged_d64": "musicgen-medium-spec-tied-paged"}
    for k in kernels:
        counter = replaces[k["name"]][3]
        k["train_launches"] = train_launches.get(counter, 0)
        if k["name"] in trained:
            k["paths"] = k.get("paths", ["serve"]) + ["trained_serve"]
            k["trained_serve_launches"] = runs[trained[k["name"]]][
                "launches"][counter]
    by_name = {k["name"]: k for k in kernels}
    for c in tuned.cells:
        if "kernel" not in c.measured_us:
            continue
        name = "mlstm_decode" if c.bucket == "mlstm" else c.op
        by_name[name].setdefault("autotune_cells", []).append(dict(
            cell=f"{c.op}/{c.bucket}", source=c.source, dtype=c.dtype,
            ms={n: us / 1e3 for n, us in c.measured_us.items()},
            winner=c.winner(), rule=c.rule))
    # the seizure evaluation's instances (phase 14's kernels run): the
    # transformer's attention and norms; both models' heads and exits
    seizure_kernels = {   # kernel: (what it replaces, source, counter)
        "attention_fp32_d16": ("kernels/flash_attention/flash_attention.py:70",
                               "flash_attention", "attention_fp32"),
        "rmsnorm_fp32_d64": ("kernels/rmsnorm/rmsnorm.py:26", "rmsnorm",
                             "rmsnorm"),
        "gemm_fp32_n2": ("kernels/gemm/gemm.py:48", "gemm", "gemm"),
        "entropy_exit_fp32_v2": ("kernels/entropy_exit/entropy_exit.py:68",
                                 "entropy_exit", "entropy_exit"),
    }
    kernels += [dict(name=name, route="cuda",
                     source=f"src/repro_torch/csrc/{src}.cu",
                     replaces=f"src/repro/{tpu}",
                     launches=tf.get(counter, 0) + cnn.get(counter, 0),
                     train_launches=train_launches.get(counter, 0),
                     **records[name])
                for name, (tpu, src, counter) in seizure_kernels.items()]
    print(f"chip_smoke: all phases passed in "
          f"{time.perf_counter() - t_start:.1f}s on {card}", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
