"""Smoke test of the PyTorch/CUDA port (kvquant_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py            # every phase, one card
    python3 chip_smoke.py --phases 1,2,3,5,21            # K2: both bodies
    python3 chip_smoke.py --phases 1,6 --verbose-build   # build + K1 check
    python3 chip_smoke.py --phases 1,6,9,14,17,18,21     # K1 / K5 decode body
    python3 chip_smoke.py --phases 1,6,9,18,21           # K1 chunk body
    python3 chip_smoke.py --phases 1,10 --verbose-build  # build + K3/K4
    python3 chip_smoke.py --phases 1,23                  # calibrate -> deploy
    python3 chip_smoke.py --phases 1,24                  # MISTRAL_7B via K1
    python3 chip_smoke.py --phases 1,25                  # DBRX (MoE, G 6)
    python3 chip_smoke.py --phases 1,26                  # tp 2 over gloo
    python3 chip_smoke.py --phases 1,27                  # training
    python3 chip_smoke.py --phases 1,28                  # graphed decode
    python3 chip_smoke.py --phases 1,15,29               # graphed paged step
    python3 chip_smoke.py --phases 1,22,30,31            # graphed prefill,
                                                         # fp16-KV graph

Phases (each prints its own lines; any failure raises and exits non-zero).
K2 is csrc/flash_serial.cu (flash_serial_decode), K1 csrc/flash_decode.cu
(flash_attention / flash_decode):
  1. device and build: the card, torch / CUDA versions, one nvcc per
     kvquant_tpu_torch/csrc/*.cu source of this checkout, run in parallel;
  2. K2 against its plain PyTorch version on the card: int4 / int8 /
     int4x2 x channels / slots x sink 0 / 5, B=2 at unequal positions, and a
     sliding window, with fp32 dots and with bf16 dot operands, each case
     on the plan's body (fs_mma for bf16 dots on int4 / int4x2, fs_partial
     otherwise) and on fs_partial forced; fs_mma's edge grid (int4 / int4x2
     x G 1/2/4/8 x D 32/64/128 x head group 2/4/16 x channels / slots /
     none x sink 0/5, a window; B=3 rows at ragged positions: no packed
     token, a live length that is not a multiple of a tile, a split with no
     tile); both bodies refuse a plan 16 B off their layout;
  3. the speed-config main path at full LLaMA-2-7B width (32 layers, random
     bf16 weights from a seed): prefill of a 2048-token prompt then greedy
     generate of 64 tokens (int4, post-RoPE K, 16 static K channels, no
     slots, head_group 16, sink 5, kernel "flash_serial"); K2 must have run
     32 times per decode step, every time through fs_mma (launches counted
     per body); on the live cache K2 is held against the
     plain version at layers 0 and 31, with bf16 and with fp32 dots;
     decode tok/s, also at 32K context;
  4. card against CPU: a toy-sized random model gives the same 32 greedy
     tokens on the card and on the CPU through K2;
  5. K2 alone at one LLaMA-2-7B layer's shapes with a filled cache at 32K
     and 128K tokens: agreement with the plain version in both dot modes;
     fs_mma, fs_partial forced on the same bf16 call and fs_partial with
     fp32 dots timed in turns (CUDA events around back-to-back calls queued
     behind a sleep kernel, median of 7 repeats after warm-up; and the
     per-call time with host overhead), the plain version, both plans and
     the byte bound;
  6. K1 against its plain version: nuq 2/3/4 bits, int4, int8 x pre / post
     RoPE x slots / channels x sink 0 / 5 x (decode at B=2, unequal
     positions; a first prefill chunk; a later chunk), a sliding window and
     other widths, fp32 and bf16 dots; then the decode body's edge grid
     (every mode x pre / post x G 1/2/4/8, head groups 1-16, D 32/64/128,
     slots / channels / none x sink 0 / 5, a window; B=3 rows at ragged
     positions: one with no packed token, a live length that is not a
     multiple of a tile, splits with no tile), the chunk bodies' edge grid
     (fd_chunk with bf16 dots, fd_partial with fp32: every mode x pre /
     post x G 1/4 with rows straddling g boundaries, 256 / 261 rows, D
     32/64/128, slots / channels / none, sink 0/5, a first chunk whose sink
     rows see no packed token, B=2 at unequal positions, a partly masked
     last tile, a window) and the cached RoPE table against rope_cos_sin on
     the card;
  7. the reference-faithful main path at LLaMA-2-7B width (nuq3, pre-RoPE
     K, slots cap 2, head_group 4, sink 5, kernel "flash"): quantized
     chunked prefill of 2048 tokens (chunk 256) and 64 greedy tokens; K1
     must have run 32 x (chunks + 64) times, 32 x chunks of them through
     the chunk body; K1 against plain on the live
     cache; decode tok/s at 2K and at 32K, a profiler pass at 32K;
  8. card against CPU through K1: the committed toy checkpoint and 3-bit
     quantizers give the same 32 greedy tokens on both, fp16 and quantized
     prefill;
  9. K1 alone at one LLaMA-2-7B layer: decode at 32K and 128K, a 256-row
     prefill chunk at 2K and 32K; times as in phase 5, bound from bytes
     and bf16 tensor-core operations, the previous PR's time beside each;
     SDPA over bf16 K/V of the same length as context only.
K3 (qk_fused) and K4 (pv_fused) are csrc/attention.cu, kernel="pallas":
 10. K3 and K4 against their plain versions: bits 2/3/4 x head group
     1/2/4 x cap 0/2 at R = G and R = G*261 rows, G 1/4, D 32/64/128,
     capacity 256 / 2304, B=2, fp32 and bf16 dots; then their edge grid
     (R 1/2/4/8/261 x D 32/64/128 x head group 1/2/4 with slot words that
     collide at one dim, at a dim and its RoPE partner, at dims >= D x
     capacity 128 / 256 / 2304, B=2 with a tail of zero probabilities);
     and each body refuses a plan whose shared-memory count is off;
 11. the main path through the user's entry point: cli.generate
     --kernel pallas --prefill-mode quantized at LLaMA-2-7B width (2048-word
     prompt, 64 new tokens); K3 and K4 must each have run 32 x (chunks +
     64) times and K1 never; engine-level quantized prefill seconds, decode
     tok/s at 2K and 32K (profiler pass), K3 / K4 against plain on the live
     cache (the fp16-KV baseline's tok/s: phase 31); cli.passkey and
     cli.needle at toy width;
 12. card against CPU through K3 / K4: the toy checkpoint's 32 greedy
     tokens, fp16 and quantized prefill;
 13. K3 and K4 alone at one LLaMA-2-7B layer: decode rows at 32K and 128K,
     a 261-row prefill chunk at 2K; times, plain, bound as in phase 9, the
     times before the redesign beside them, each call's plan and the
     (cos, sin) table's reads per call.
K5 (paged_flash_decode) is fd_paged_attention in csrc/flash_decode.cu:
K1's decode body (fd_decode) addressed through a page table:
 14. K5 against its plain version: nuq 2/3/4, int4, int8 x pre / post RoPE
     x slots / channels x sink 0 / 5 x page 256 / 1024, three live slots
     at unequal positions (inside page 0, just past a page boundary, deep
     in the last live page) over permuted pages with junk trailing table
     ids, and an inactive slot aliasing another's pages; fp32 and bf16
     dots; and K5 == K1 on the same tokens laid out contiguously; then the
     decode body's edge grid of phase 6 over permuted pages;
 15. the serving main path through the user's entry point: cli.serve_demo
     --paged at LLaMA-2-7B width (4 slots, 8 requests, 2048-token prompts,
     64 new tokens, pages of 1024, chunked admission, bursts of 32): every
     budget served, every page returned, K5 32 times per decode step, K1
     32 times per admission chunk, K2 / K3 / K4 never; pool MiB, aggregate
     tok/s, the chunked admission's share of the serving wall (its chunks
     replay the held admission cache's two chunk graphs), a profiler pass
     over steady-state eager steps with 4 active slots (the server itself
     replays its step graph, phase 29); then
     cli.serve_demo without --paged (slot pool, K1) at toy width;
 16. card against CPU through PagedServer: the toy checkpoint (P 256, 2
     slots, 4 requests, chunked admission, bursts) gives the same tokens
     on both, and the same as the port's isolated generate on the card;
 17. K5 alone at one LLaMA-2-7B layer: B=1 at 32K (32 permuted pages) and
     B=4 at 8K each; kernel, plain, bytes bound, K1 on the same tokens,
     the previous decode body's time beside each.
int4x2 (the head-paired 2-bit container) through K1 and K5:
 18. K1 and K5 int4x2 against their plain versions: pre / post RoPE x
     channels (n_kc 4) / slots (cap 2) / no sparse x sink 0 / 5 x head group
     2 / 4 (and 16 with channels) x D 64 / 128; K1 decode at B=2 with
     unequal positions, a first and a later prefill chunk, a sliding
     window; K5 over pages of 256 / 1024 as phase 14; fp32 and bf16 dots;
     K5 == K1 on the same tokens; the decode body's edge grid for int4x2
     (even head groups) through K1 and K5; the chunk bodies' edge grid of
     phase 6 for int4x2;
 19. the 2-bit exact-density main path at LLaMA-2-7B width (int4x2, post-
     RoPE K, 4 static K channels per head group of 4, no V slots, sink 5,
     kernel "flash"): quantized chunked prefill of 2048 tokens (chunk 256)
     and 64 greedy tokens; K1 32 x (chunks + 64) times, K2-K5 never; K1
     against plain on the live cache; decode tok/s at 2K, 32K (profiled)
     and 128K;
 20. the accuracy oracle on the card: the port's uniform 2-bit fit on the
     toy checkpoint's roped calibration tokens, deployed through K1 ==
     simulated within 0.02 in log and card == CPU within 1e-3; the
     committed nuq3 quantizers through K3 / K4 == simulated; PagedServer
     with int4x2 card == CPU; cli.calibrate and cli.eval_ppl --deployed
     --kernel flash at LLaMA-2-7B width (K1 32 x 256 times);
 21. K1 (decode at 32K / 128K / 512K, a 256-row chunk at 2K and 32K) and
     K5 (B=4 x 8K) on int4x2 at one LLaMA-2-7B layer: kernel, plain, bound;
     K1 on int4 containers and K2 on the same int4x2 tokens as context (K2
     through fs_mma, held to its plain version, and fs_partial forced, with
     the plan); the previous PR's times beside;
 22. the 2-bit config of phase 19 at LLaMA-2-7B width runs a 32K-token
     quantized prefill (128 chunks of 256), graphed and eager: K1 32 x 128
     chunk launches in each, wall seconds of each, the last token's logits
     bitwise equal, a profiler window over the last four chunks, eager and
     replayed (device ms in K1 against the rest, idle share), K1 against
     plain on the live cache at layers 0 and 31.
The calibrate -> deploy chain and a second model:
 23. the CLIs at LLaMA-2-7B width (their random init, d_ff = 3 x d_model,
     bf16): cli.fisher over 2 x 2048 tokens (wall s, peak GiB, shapes,
     finite and >= 0), one Fisher step with remat beside a plain one (both
     peaks, their difference), cli.calibrate nuq3 with those weights,
     cli.deploy --check --prefill 2048 --benchmark 64 through K1 (32 x 64
     launches in the timed pass), --kernel pallas --benchmark 16 through
     K3 / K4 (32 x 16 each, K1 none), --benchmark 4 --profile (launches
     and device ms per step from the trace), and cache_io on the card
     (save / load of a 2048-token prefill: bitwise equal logits from the
     restored cache; reset_cache and a fresh prefill give them again);
 24. MISTRAL_7B at full width (d_ff 14336, 32 / 8 heads, window 4096;
     random bf16 weights) with phase 7's storage at kv_hidden 1024: a
     6144-token quantized prefill (24 chunks of 256) and 32 greedy tokens,
     K1 32 x (24 + 32) times, K1 against plain on the live cache at layers
     0 and 31 (a decode row and a chunk, both dot modes), the window live
     (K1 with it differs from K1 without it); prefill s, decode tok/s, a
     profiler pass over decode steps past 6K (device ms, idle share).
The MoE family and the HF loader:
 25. DBRX: a DBRX-schema BF16 checkpoint (2 layers, narrow, G 6) written by
     the script's own safetensors writer and loaded onto the card through
     load_hf_checkpoint, equal to the same tensors in memory; then the
     published DBRX config (d_model 6144, 48 / 8 heads, 16 experts top 4,
     ffn 10752, vocab 100352) read through config_from_hf and cut from 40
     to 8 layers, random bf16 weights from a seed: the faithful nuq3 config
     through K1 (2048-token quantized prefill in 8 chunks of 256, 32
     greedy tokens: K1 8 x (8 + 32), the chunks on fd_chunk and the decode
     steps at G 6 on the tensor-core decode body fd_gqa;
     K1 == plain on the live cache at layers 0 and 7, a decode row and a
     chunk, both dot modes), kernel pallas through K3 / K4 (16 tokens, 8 x
     16 each, K3 on qk_gqa, == plain at R 6 and 1536) and the speed
     config (int4,
     post-RoPE, hg 8) through K2 (16 tokens, 8 x 16, all fs_mma at 8
     padded rows, == plain); each path's decode tok/s and a profiler pass
     over 3 steps (device ms split into the expert FFN, the attention
     kernel and the rest; idle share) beside the step's weight-read bounds
     (routed experts only, all experts); prefill s, the fp16-KV baseline's
     tok/s on the same weights, peak GiB; the graphed step at 32K on a
     filled cache (~0.22 GB) through K1 and K3 / K4, graphed == eager
     bitwise over 4 steps, device ms and K1 / K3 by name in a replay's
     trace, beside the same step captured with the old G 3-8 routes forced
     (K1 on fd_chunk, K3 on the 8-row qk_decode); the G 6 routes alone at
     one DBRX layer (K1 decode on fd_gqa beside fd_chunk and the rows
     padded to fd_decode, K2, K3 on qk_gqa beside the 8-row qk_decode, K4
     at R 6, K5 at B=4 x 8K on fd_gqa beside the padded fd_decode) against
     plain, with times and bounds, and the routing rows K1 G 4 (MISTRAL_7B,
     window live) / G 8 and K3 R 4 / 8, old body beside new; K2 at G 3 / 6
     against plain; the decode edge grid at G 3 / 5 / 6 / 7 through K1 and
     K5 (every mode), K3's qk_gqa grid (R 3 / 5 / 6 / 7); a toy MoE's
     greedy tokens card == CPU through K1 and K2.
     The MoE family's compiled step: the expert products' kernel
     (csrc/moe_experts.cu, moe_glu then moe_down) against its plain version
     at layer 0's weights, C 1 / 2 / 4 / 8 with empty experts and a batch
     of identical tokens that overflows capacity (tokens past it get a
     zero FFN), timed at the decode shape beside its byte bound,
     per-expert torch.matmul and torch.bmm over all experts; the 2048-token
     quantized prefill's chunk graph == eager chunks bitwise; for each of
     the three paths 16 greedy steps graphed and eager from clones of one
     cache: tokens, logits, caches bitwise, launches a step (moe_experts
     on every layer) == the port's kernels by name in a replay's trace,
     device ms, wall / device and idle, the expert products' device ms in
     a graphed step (moe_glu + moe_down by name) beside the routed and
     all-experts bounds, capture s and pool MiB, and one eager step under
     torch.cuda's sync debug mode "error"; the fp16-KV baseline's graph
     == eager; serve.Server on the toy MoE (4 slots, chunked admission)
     graphed == eager.
Tensor parallelism (kvquant_tpu_torch/parallel):
 26. tp 2 on the one card: two rank processes on cuda:0 joined over gloo
     (backend="gloo", set explicitly: NCCL takes one card per rank, and
     gloo's collectives on CUDA tensors go through host memory), each
     holding its half of the heads (and of DBRX's experts) of weights drawn
     from the same seed; LLaMA-2-7B at full width through K1 (faithful
     nuq3, 2048-token quantized prefill, 16 steps; 16 kv heads a rank) and
     K2 (the speed config, one head group of 16 a rank, 8 steps), DBRX at
     its published widths cut to 2 of 40 layers through K1 (hg 4, 8 of 16
     experts a rank, 8 steps). A tp 1 run of the same weights in this
     process comes first (then freed). Each rank prefills and decodes the
     tp 1 tokens (launches == layers x (chunks + steps), the kernel ==
     plain on its live cache, its prefill codes within 5% of tp 1's), then
     decodes them again from its shards of tp 1's cache after the prefill;
     those steps hold max |dlogit| <= 0.05 max |logit_tp1| and the argmax
     at every step whose tp 1 top-2 margin exceeds 1% of max |logit|. The
     own-prefill steps' agreement, the router's flips (DBRX) and, per
     rank, ms per step, device ms per step, the collectives' ms per step,
     launches per step, peak GiB and tok/s beside tp 1's are printed.
Training (utils/toymodel, utils/induction; no kernel of its own):
 27. the toy model's JAX recipe on the card (train_toy_model(): TOY_CFG,
     1200 steps of 16 x 256, fp32 Adam 1e-3, seed 0): wall s, ms a step,
     device ms a step and idle share over profiled steps, peak GiB, the
     final loss beside the committed checkpoint's, ppl below 1.5 x the
     bigram floor (the JAX gate); 1, 2 and 3 steps from the committed
     weights on the card and on the CPU (losses within 1e-4 relative); the
     checkpoint written with save_toy_checkpoint and read back bitwise; the
     card-trained model's nuq3 fit (ppl_table's recipe) deployed through
     K1 == simulated within 0.02 in log (K1 layers x 256 decode launches);
     the retrieval model at IND_CFG's widths and the JAX batch shapes,
     steps cut to 200 / 125 / 10 (stage 1, stage 2, robust fine-tune at
     long_T 8192 with chunked attention and remat): ms and device ms a
     step, idle share, peak GiB per stage, the full recipe's projected
     wall time; then a nuq3 fit on copy haystacks and greedy tokens
     through K1 at 2048 context (quantized prefill, fp32 dots), card ==
     CPU (launches layers x (8 chunks + 8 steps) per prompt).
The compiled decode step (engine.DecodeGraph, one CUDA graph per step;
generate, deployed_ppl, cli.deploy and serve.Server step through it on
the card, so phases 3, 7, 11, 19, 20, 23 and 27 replay graphs):
 28. at LLaMA-2-7B width (random bf16 weights from a seed, B=1) for the
     speed config (K2), faithful nuq3 through K1 and K3 / K4, 2-bit int4x2
     through K1 and the eager xla oracle: from clones of one filled 2K
     cache, 32 greedy steps graphed and eager (8 for xla) give the same
     tokens, bitwise the same logits at every step and bitwise the same
     caches; launches per step graphed == eager == layers (x2 for K3 /
     K4); no host wait in either step (torch.cuda's sync debug mode);
     tok/s, device ms a step (the graph's replays back to back between
     CUDA events) and idle share, eager and graphed in turn, at 2K and 32K
     (and 128K for int4x2), with capture seconds and the graph pool's
     MiB; at 2K the profiler's kernel ms and kernels a step (printed),
     and the port's kernels it saw by name (fd_* / fs_* / qk_* / pv_*),
     which must equal the counters' launches a step for a replay and for
     an eager step; serve.Server with 4 slots and 6
     requests through K1, graphed tokens == the tokens of the same server
     stepping eagerly.
The page pool's compiled step (paged.PagedGraph: PagedServer's greedy step
as one CUDA graph, replayed once a step and H times a burst; phases 15, 16
and 20 serve through it):
 29. phase 15's requests (cli.serve_demo's draws: 8 requests, 2048-token
     prompts, 64 new tokens, 4 slots, pages of 1024, chunked admission of
     256, bursts of 32) at LLaMA-2-7B width, faithful nuq3 and the 2-bit
     int4x2 config through K5, once through the graphed server and once
     with the eager PagedStep in its place: tokens, the whole pool and the
     free list bitwise equal; wall s, aggregate tok/s and the admission's
     share of the wall time apart; then 4 active slots at 35-65% of their
     pages: device ms a step (the graph's replays back to back between
     CUDA events), wall ms a server step (copy in, replay, read the
     logits) and a burst step (copy in once, 8 replays, one read) and
     the idle share, eager and graphed; kernels a step and K5's kernels
     (fd_decode) by name in the profiler's trace == the counters'; capture
     s and the graph pool's MiB; the device ms of a step's appends against
     their quantization alone (the pool writes' cost, each captured as a
     graph); then an inactive slot that aliases an
     active slot's page row (and one a row further), 64 appends, the pool
     bitwise equal to the same appends with those slots' table rows on a
     spare page. The eager reference also runs its admission chunks
     eagerly, so the admission's share compares graphed chunks with eager.
     Then (nuq3) prompts of 1 to 6 pages of 256, 5 temporary capacities
     out of their first-use order, through a graphed and an eager server:
     tokens and pool equal, the admission caches of every capacity in one
     buffer, the graphed server's peak memory beside the eager one's.
The compiled prefill chunk (engine.ChunkGraph: on a card prefill_quantized
replays one graph for the chunks after the first, and serve.Server's and
PagedServer's chunked admission two graphs over a held admission cache, so
phases 7, 11, 15, 16, 19, 20, 22, 24, 27 and 29 replay chunk graphs) and
the fp16-KV baseline's compiled step (baseline_fp16.DecodeGraph):
 30. at LLaMA-2-7B width (random bf16 weights from a seed, B=1) for nuq3
     through K1 and through K3 / K4, the 2-bit int4x2 config and the speed
     config (chunks through K1): a 2048-token prompt (8 chunks of 256)
     through prefill_quantized eager and graphed, and the chunk loop eager
     and through one graph: every chunk's logits, the last token's and the
     caches bitwise; launches (layers x chunks of K1, or of K3 and K4);
     wall s, capture s, the graph pool's MiB; device ms a chunk (replays
     back to back between CUDA events) and host wall ms a chunk eager and
     graphed with their idle shares over the last 4 chunks; kernels a
     replay and the port's kernels by name in its profiler trace == the
     graph's counters; then prompts of 2 to 5 chunks (512 to 1280 tokens)
     through prefill_quantized eager and with its chunk graph forced: the
     wall of each, and what prefill_quantized chooses
     (engine.CHUNK_GRAPH_MIN_REPLAYS);
 31. the fp16-KV baseline at LLaMA-2-7B width (bf16 cache read in fp32):
     64 greedy steps after a 2048-token prefill, graphed == eager bitwise
     (tokens, logits, caches), no host wait a step; tok/s, device ms a
     step, idle share and kernels a step, eager and graphed, at 2K and 32K
     (a cache drawn at random), capture s and pool MiB; cli.passkey
     without --quantizers at toy width replays the graph.
The line before the last lists every ported kernel as JSON; the last line
is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory, NVIDIA data sheet
BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak, data sheet
FP32_TOL = 1e-4  # fp32 dots: |kernel - plain| <= FP32_TOL * (1 + max|plain|)
SOURCES = ("flash_serial", "flash_decode", "attention",
           "moe_experts")  # csrc/<name>.cu
VERBOSE_BUILD = False  # --verbose-build: nvcc's register / spill report
# the kernels' device times before their last redesign (PERF.md §6; an
# H100 80GB HBM3 at 700 W): K1 / K5 before fd_decode and fd_chunk, K3 / K4
# before attention.cu's decode and mma bodies; printed in the log beside
# this run's, never in the kernels line, which holds only this run's
# measurements: (kernel, storage, kind or B, tokens) -> ms
BEFORE_MS = {("K1", "nuq3", "decode", 32768): 0.2927,
             ("K1", "nuq3", "decode", 131072): 1.0844,
             ("K1", "nuq3", "prefill", 2048): 0.9025,
             ("K1", "nuq3", "prefill", 32768): 11.0661,
             ("K5", "nuq3", 1, 32768): 0.2929, ("K5", "nuq3", 4, 8192): 0.2880,
             ("K1", "int4x2", "decode", 32768): 0.2419,
             ("K1", "int4x2", "decode", 131072): 0.7813,
             ("K1", "int4x2", "decode", 524288): 2.8717,
             ("K1", "int4x2", "prefill", 32768): 14.7080,
             ("K5", "int4x2", 4, 8192): 0.2385,
             # K3 / K4 before their redesign (PERF.md §6)
             ("K3", "nuq3", "decode", 34816): 0.3528,
             ("K3", "nuq3", "decode", 133120): 1.3341,
             ("K3", "nuq3", "prefill", 2304): 0.6885,
             ("K4", "nuq3", "decode", 34816): 0.3068,
             ("K4", "nuq3", "decode", 133120): 1.0898,
             ("K4", "nuq3", "prefill", 2304): 0.8329}


def vs_before(key, ms):
    """'; before x ms, y.yyx faster' for a time of BEFORE_MS, else ''."""
    old = BEFORE_MS.get(key)
    return "" if old is None else \
        f"; before {old:.4f} ms (PERF.md), {old / ms:.2f}x faster"


BF16_TOL = 1e-2  # bf16 dot operands: |kernel - plain| <= BF16_TOL * max|plain|;
# the kernel rounds each split's probabilities against the split's own
# maximum, the plain version against the row's


def log(msg):
    print(msg, flush=True)


def agree(tag, got, want, dot_bf16):
    """Max |kernel - plain|; raises when it exceeds the tolerance of the
    dot mode (FP32_TOL / BF16_TOL above)."""
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    bound = BF16_TOL * scale if dot_bf16 else FP32_TOL * (1 + scale)
    log(f"{tag} {'bf16' if dot_bf16 else 'fp32'} dots: max|kernel-plain| "
        f"{err:.3e} (tol {bound:.1e}, max|plain| {scale:.3e})")
    if not err <= bound:
        raise AssertionError(f"kernel disagrees with plain: {tag}")
    return err


def check_case(tag, got, want, dot_bf16, worst):
    """Hold ``got`` to ``want`` in the dot mode's bound; track the worst
    |err| / bound per dot mode in ``worst``."""
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    bound = BF16_TOL * scale if dot_bf16 else FP32_TOL * (1 + scale)
    if not (err <= bound and bool(torch.isfinite(got).all())):
        agree(tag, got, want, dot_bf16)  # logs and raises
    worst[dot_bf16] = max(worst[dot_bf16], err / bound)
    return err


def median_ms(fn, runs=30, warmup=3):
    """Median wall time of one call between CUDA events: device time plus
    whatever host time the call's enqueue adds when the card waits."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def device_ms(fn, n=20, reps=7, warmup=3):
    """Device time of one call: a sleep kernel holds the card while the
    host enqueues ``n`` calls between two events, so the events bracket
    back-to-back device work only. Median over ``reps`` of elapsed / n."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        torch.cuda._sleep(100_000_000)  # ~60 ms at 1.7 GHz
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / n)
    return float(np.median(times))


# ---------------------------------------------------------------------------
# synthetic operands of the kernel
# ---------------------------------------------------------------------------


def kernel_operands(dcfg, mcfg, L, B, G, Tc, gen, dev):
    """Random cache arrays (L, B, ...) for one DeployConfig, on ``dev``."""
    from kvquant_tpu_torch.ops import packing as pk

    Hkv, D, S = dcfg.n_kv_heads, dcfg.d_head, dcfg.sink
    NG, J, spk = dcfg.n_groups, dcfg.n_slots, dcfg.slots_per_kind
    bits = dcfg.bits

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    # random container bytes: every nibble (int4 at 4 bits, int4x2 at 2+2
    # bits) and every byte (int8 at 8 bits) is a valid code
    assert bits == {"int4": 4, "int8": 8, "int4x2": 2}[dcfg.codes]

    def container():
        return torch.randint(0, 256, (L, B, dcfg.code_heads, Tc,
                                      dcfg.code_cols),
                             generator=gen, device=dev,
                             dtype=torch.uint8).view(dcfg.code_dtype)

    def words(shape):
        vals = randn(*shape, scale=0.5)
        idx = (torch.randint(0, dcfg.head_group, shape, generator=gen,
                             device=dev) << 7) | torch.randint(
            0, D, shape, generator=gen, device=dev)
        return pk.encode_outlier_words(vals, idx)

    if dcfg.k_outliers == "channels":
        kv_out = randn(L, B, NG, J, Tc, scale=0.1)
        if J > spk and dcfg.cap_per_side > 0:
            kv_out[:, :, :, spk:] = words((L, B, NG, J - spk, Tc))
    else:
        kv_out = words((L, B, NG, J, Tc))
    K = 2 ** bits
    return dict(
        k_planes=container(), v_planes=container(), kv_out=kv_out.contiguous(),
        k_range=torch.rand((L, Hkv, D), generator=gen, device=dev) + 0.5,
        k_offset=randn(L, Hkv, D, scale=0.1),
        v_scale=torch.rand((L, B, Tc), generator=gen, device=dev) + 0.5,
        v_offset=randn(L, B, Tc, scale=0.1),
        k_sink=randn(L, B, Hkv, S, D), v_sink=randn(L, B, Hkv, S, D),
        k_lut=torch.linspace(-1, 1, K, device=dev).repeat(L, 1),
        v_lut=torch.linspace(-0.9, 1.1, K, device=dev).repeat(L, 1),
        k_ressc=torch.rand((L, Hkv * D), generator=gen, device=dev),
    )


def call(fn, q, ops, li, pos, dcfg, mcfg):
    return fn(q, ops["k_planes"], ops["v_planes"], ops["kv_out"],
              ops["k_range"], ops["k_offset"], ops["v_scale"],
              ops["v_offset"], ops["k_sink"], ops["v_sink"], ops["k_lut"],
              ops["v_lut"], li, pos, dcfg, mcfg, k_ressc=ops["k_ressc"])


def stored_bytes_per_token(dcfg):
    """Bytes of cache one packed token occupies in one layer: K and V codes
    of every kv head, the head groups' outlier rows, V scale and offset."""
    code = {"int4": 0.5, "int4x2": 0.25, "int8": 1.0}[dcfg.codes]
    return (2 * dcfg.n_kv_heads * dcfg.d_head * code
            + dcfg.n_groups * dcfg.n_slots * 4 + 8)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_device_and_build(report):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else \
        f"nvidia-smi failed: {smi.stderr.strip()}"
    log(card)
    log(f"[1] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from concurrent.futures import ThreadPoolExecutor

    from kvquant_tpu_torch.ops.kernels import build, flash_decode as fd
    from kvquant_tpu_torch.ops.kernels import attention as at
    from kvquant_tpu_torch.ops.kernels import flash_serial as fs
    from kvquant_tpu_torch.ops.kernels import moe_experts as mx

    # one nvcc per source, all started together
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES)) as ex:
        for f in [ex.submit(build.build, name, VERBOSE_BUILD)
                  for name in SOURCES]:
            f.result()
    fs.load_library()
    fd.load_library()
    at.load_library()
    mx.load_library()
    log(f"[1] built and loaded {', '.join(f'csrc/{n}.cu' for n in SOURCES)} "
        f"in {time.perf_counter() - t0:.1f} s (nvcc " + ", ".join(
            f"{n} {build.build_seconds.get(n, 0.0):.1f} s" for n in SOURCES)
        + ")")
    report["card"] = card
    report["nvcc_s"] = dict(build.build_seconds)


def phase_kernel_vs_plain(report):
    """K2 against its plain version on both bodies: every case below runs
    the plan's body (fs_mma for bf16 dots on int4 / int4x2, fs_partial
    otherwise) and, where that is fs_mma, fs_partial forced as well; then
    fs_mma's edge grid and the refusal of a plan 16 B off."""
    from kvquant_tpu_torch.cache import DeployConfig
    from kvquant_tpu_torch.models.config import ModelConfig
    from kvquant_tpu_torch.ops.kernels import flash_serial as fs

    dev = torch.device("cuda")
    L, B, Hkv, G, D, Tc = 2, 2, 4, 2, 128, 1024
    worst = 0.0
    cases = []
    for codes in ("int4", "int8", "int4x2"):
        for k_out in ("channels", "slots"):
            for sink in (0, 5):
                cases.append((codes, k_out, sink, None))
    cases += [("int4", "channels", 5, 300), ("int4x2", "slots", 5, 300)]
    routes = {b: 0 for b in fs.BODIES}
    for dot_bf16 in (False, True):
        for codes, k_out, sink, window in cases:
            bits = {"int4": 4, "int8": 8, "int4x2": 2}[codes]
            dcfg = DeployConfig.create(
                bits=bits, n_kv_heads=Hkv, d_head=D, max_len=Tc + sink,
                sink=sink, kernel="flash_serial", dot_bf16=dot_bf16,
                head_group=4 if k_out == "slots" else 2, codes=codes,
                post_rope_k=True, k_outliers=k_out, n_kc=3,
                cap_per_side=0 if k_out == "channels" else 2)
            mcfg = ModelConfig(vocab_size=64, d_model=Hkv * G * D,
                               n_layers=L, n_heads=Hkv * G, n_kv_heads=Hkv,
                               d_head=D, d_ff=64, max_seq_len=Tc,
                               sliding_window=window)
            gen = torch.Generator(device=dev).manual_seed(11)
            ops = kernel_operands(dcfg, mcfg, L, B, G, Tc, gen, dev)
            q = torch.randn((B, Hkv, G, D), generator=gen, device=dev)
            # one row still inside the sink (or at the start), one past
            # several 128-token tiles; with a window, both deep
            pos = torch.tensor([3, 700] if window is None else [700, 1001],
                               dtype=torch.int32, device=dev)
            want = call(fs.flash_serial_decode_ref, q, ops, 1, pos, dcfg,
                        mcfg)
            bodies = [fs.fs_body(dcfg)]
            if bodies[0] == "fs_mma":
                bodies.append("fs_partial")
            for body in bodies:
                got = call(lambda *a, **k: fs.flash_serial_decode(
                    *a, body=body, **k), q, ops, 1, pos, dcfg, mcfg)
                torch.cuda.synchronize()
                err = agree(f"[2] {body} {codes}/{k_out}/sink{sink}/"
                            f"win{window}", got, want, dot_bf16)
                routes[body] += 1
                if not dot_bf16:
                    worst = max(worst, err)
    log(f"[2] cases per body: {routes}")
    report["max_abs_err_fp32"] = worst
    report["k2_edge_worst"] = k2_edge_grid()
    k2_wrong_smem_refused()


def k2_edge_grid():
    """fs_mma against the plain version over its edge cases, bf16 dots:
    int4 / int4x2 x G 1/2/4/8 x D 32/64/128 x head group 2/4/16 x static
    channels (more than the 4 a tile stages at head groups 2 / 4; V slot
    words beside them at head group 4) / slot words (head groups 2 / 4:
    words carry a 2-bit head index) / none x sink 0/5, and a sliding window
    at D 128 with the sink; B = 3 rows at ragged positions: one with no
    packed token, one whose live length 201 is not a multiple of a 32-token
    tile (its 7 tiles leave a split of the plan's 8 empty), one deep.
    Returns the worst |err| / bound."""
    from kvquant_tpu_torch.cache import DeployConfig
    from kvquant_tpu_torch.models.config import ModelConfig
    from kvquant_tpu_torch.ops.kernels import flash_serial as fs

    dev = torch.device("cuda")
    L, Tc = 2, 1024
    worst = {False: 0.0, True: 0.0}
    n, t0 = 0, time.perf_counter()
    before = fs.flash_serial_decode.route_launches["fs_mma"]
    for codes in ("int4", "int4x2"):
        for G in (1, 2, 4, 8):
            for D in (32, 64, 128):
                for hg in (2, 4, 16):
                    for k_out in ("channels", "slots", "none"):
                        if k_out == "slots" and hg == 16:
                            continue
                        for sink in (0, 5):
                            for window in ((None, 300) if D == 128 and sink
                                           else (None,)):
                                Hkv = max(4, hg)
                                dcfg = DeployConfig.create(
                                    bits=4 if codes == "int4" else 2,
                                    n_kv_heads=Hkv, d_head=D,
                                    max_len=Tc + sink, sink=sink,
                                    kernel="flash_serial", dot_bf16=True,
                                    head_group=hg, codes=codes,
                                    post_rope_k=True,
                                    k_outliers="slots" if k_out == "slots"
                                    else "channels",
                                    n_kc={2: 10, 4: 12, 16: 16}[hg],
                                    include_sparse=k_out != "none",
                                    cap_per_side=2 if k_out == "slots" or (
                                        k_out == "channels" and hg == 4)
                                    else 0)
                                mcfg = ModelConfig(
                                    vocab_size=64, d_model=Hkv * G * D,
                                    n_layers=L, n_heads=Hkv * G,
                                    n_kv_heads=Hkv, d_head=D, d_ff=64,
                                    max_seq_len=Tc, sliding_window=window)
                                gen = torch.Generator(device=dev).manual_seed(
                                    91 + n)
                                ops = kernel_operands(dcfg, mcfg, L, 3, G, Tc,
                                                      gen, dev)
                                q = torch.randn((3, Hkv, G, D), generator=gen,
                                                device=dev)
                                pos = torch.tensor(
                                    [max(sink - 2, 0), sink + 200,
                                     sink + Tc - 4], dtype=torch.int32,
                                    device=dev)
                                got = call(fs.flash_serial_decode, q, ops, 1,
                                           pos, dcfg, mcfg)
                                torch.cuda.synchronize()
                                want = call(fs.flash_serial_decode_ref, q,
                                            ops, 1, pos, dcfg, mcfg)
                                check_case(
                                    f"[2] fs_mma edge {codes} G{G} D{D} hg{hg}"
                                    f" {k_out} sink{sink} win{window}", got,
                                    want, True, worst)
                                n += 1
    ran = fs.flash_serial_decode.route_launches["fs_mma"] - before
    if ran != n:
        raise AssertionError(f"[2] edge grid: {ran} fs_mma launches for {n} "
                             f"cases")
    log(f"[2] fs_mma edge grid: {n} cases (bf16 dots) in "
        f"{time.perf_counter() - t0:.1f} s, all through fs_mma; worst "
        f"|err| / bound {worst[True]:.3f}")
    return worst[True]


def k2_wrong_smem_refused():
    """Both bodies of K2 refuse a plan whose shared-memory count is 16
    bytes off their own layout, and the refused call counts no launch."""
    from kvquant_tpu_torch.cache import DeployConfig
    from kvquant_tpu_torch.models.config import ModelConfig
    from kvquant_tpu_torch.ops.kernels import flash_serial as fs

    dev = torch.device("cuda")
    plan_fn, n = fs.fs_plan, 0
    fs.fs_plan = lambda *a, **k: (lambda p: p._replace(smem=p.smem + 16))(
        plan_fn(*a, **k))
    try:
        for dot_bf16 in (True, False):
            dcfg = DeployConfig.create(
                bits=4, n_kv_heads=4, d_head=128, max_len=256 + 5, sink=5,
                kernel="flash_serial", dot_bf16=dot_bf16, head_group=2,
                codes="int4", post_rope_k=True, k_outliers="channels",
                n_kc=3, cap_per_side=0)
            mcfg = ModelConfig(vocab_size=64, d_model=512, n_layers=1,
                               n_heads=4, n_kv_heads=4, d_head=128, d_ff=64,
                               max_seq_len=256)
            gen = torch.Generator(device=dev).manual_seed(5)
            ops = kernel_operands(dcfg, mcfg, 1, 1, 1, 256, gen, dev)
            q = torch.randn((1, 4, 1, 128), generator=gen, device=dev)
            pos = torch.tensor([200], dtype=torch.int32, device=dev)
            before = fs.flash_serial_decode.launches
            try:
                call(fs.flash_serial_decode, q, ops, 0, pos, dcfg, mcfg)
            except RuntimeError:
                n += 1
            else:
                raise AssertionError(f"[2] K2 {fs.fs_body(dcfg)} took a plan "
                                     f"with a wrong shared-memory count")
            if fs.flash_serial_decode.launches != before:
                raise AssertionError("[2] K2: a refused call counted a launch")
    finally:
        fs.fs_plan = plan_fn
    log(f"[2] a plan's shared-memory count 16 B off the body's layout: "
        f"refused by {n} of 2 bodies (fs_mma, fs_partial)")


def speed_config(max_len, n_layers):
    """LLaMA-2-7B width and the README's speed config."""
    from kvquant_tpu_torch.cache import DeployConfig
    from kvquant_tpu_torch.models.config import LLAMA2_7B
    from kvquant_tpu_torch.quant.artifacts import (
        KQuantizer, VQuantizer, LayerQuantizers, QuantizerSet)

    cfg = LLAMA2_7B
    dcfg = DeployConfig.create(
        bits=4, n_kv_heads=cfg.n_kv_heads, d_head=cfg.d_head,
        max_len=max_len, sink=5, kernel="flash_serial", head_group=16,
        codes="int4", post_rope_k=True, k_outliers="channels", n_kc=16,
        cap_per_side=0)
    rng = np.random.default_rng(0)
    lut = np.linspace(-1, 1, 16, dtype=np.float32)
    layers = []
    for _ in range(n_layers):
        u = (np.abs(rng.normal(size=cfg.kv_hidden)) * 2 + 1).astype(np.float32)
        layers.append(LayerQuantizers(
            k=KQuantizer(upper=u, lower=(-u * 0.9).astype(np.float32),
                         lut=lut.copy(),
                         ressc=rng.random(cfg.kv_hidden).astype(np.float32)),
            v=VQuantizer(lut=lut.copy())))
    qs = QuantizerSet(layers=layers, bits=4, sparsity_threshold=0.99,
                      cap_outliers=True, first_few_fp16=5)
    return cfg, dcfg, qs


def phase_main_path(report):
    from kvquant_tpu_torch import engine
    from kvquant_tpu_torch.cache import create_cache, deployed_from_quantizers
    from kvquant_tpu_torch.models import init_params
    from kvquant_tpu_torch.ops.kernels import flash_serial as fs

    T0, N = 2048, 64
    cfg, dcfg, qs = speed_config(T0 + N + 5, 32)
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         dtype=torch.bfloat16, device="cuda")
    dq = deployed_from_quantizers(qs, cfg.n_kv_heads, cfg.d_head,
                                  device="cuda")
    torch.cuda.synchronize()
    log(f"[3] LLaMA-2-7B width, {cfg.n_layers} layers, bf16 weights "
        f"{sum(p.numel() for p in params.parameters()) / 1e9:.2f} G params "
        f"initialised in {time.perf_counter() - t0:.1f} s")
    prompt = torch.randint(0, cfg.vocab_size, (1, T0),
                           generator=torch.Generator().manual_seed(1))

    cache = create_cache(dcfg, cfg.n_layers, 1, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.prefill(params, cfg, dcfg, dq, cache, prompt.cuda())
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0

    gcfg = engine.GenerateConfig(max_new_tokens=N)
    fs.flash_serial_decode.launches = 0
    fs.flash_serial_decode.route_launches = {b: 0 for b in fs.BODIES}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks, cache = engine.generate(params, cfg, dcfg, dq, prompt, gcfg,
                                  device="cuda")
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    launches = fs.flash_serial_decode.launches
    routes = dict(fs.flash_serial_decode.route_launches)
    report["launches"] = launches
    report["route_launches"] = routes
    log(f"[3] prefill {T0} tokens {prefill_s:.3f} s; generate (prefill + "
        f"{N} decode steps) {gen_s:.3f} s; kernel launches {launches} "
        f"(expected {cfg.n_layers * N}, all through fs_mma): per body "
        f"{routes}")
    if launches != cfg.n_layers * N or routes["fs_mma"] != launches:
        raise AssertionError("main path did not run fs_mma per layer")
    if not (toks.shape == (1, N) and int(toks.min()) >= 0
            and int(toks.max()) < cfg.vocab_size):
        raise AssertionError(f"bad tokens {toks.shape}")
    _, logits = engine.decode_step(params, cfg, dcfg, dq, cache,
                                   toks[:, -1], T0 + N)
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("non-finite logits")
    decode_tps = N / (gen_s - prefill_s)
    log(f"[3] decode {decode_tps:.2f} tok/s at {T0}-{T0 + N} context "
        f"(64 / (generate - prefill) wall time)")

    # the live cache: kernel against plain at the first and last layer
    q = torch.randn((1, cfg.n_kv_heads, 1, cfg.d_head),
                    generator=torch.Generator(device="cuda").manual_seed(2),
                    device="cuda")
    pos = torch.tensor([T0 + N], dtype=torch.int32, device="cuda")
    arrs = cache.arrays()
    worst = 0.0
    for li in (0, cfg.n_layers - 1):
        # the main path's instance (G=1, hg 16, n_kc 16) with its bf16 dot
        # operands, and the same operands with fp32 dots at the tight bound
        for d in (dcfg, dataclasses.replace(dcfg, dot_bf16=False)):
            args = (q, arrs["k_planes"], arrs["v_planes"], arrs["kv_out"],
                    dq.k_range, dq.k_offset, arrs["v_scale"],
                    arrs["v_offset"], arrs["k_sink"], arrs["v_sink"],
                    dq.k_lut_dec, dq.v_lut_dec, li, pos, d, cfg)
            got = fs.flash_serial_decode(*args, k_ressc=dq.k_ressc)
            want = fs.flash_serial_decode_ref(*args, k_ressc=dq.k_ressc)
            worst = max(worst, agree(f"[3] live cache layer {li}", got, want,
                                     d.dot_bf16))
    report["max_abs_err_main"] = worst
    report["decode_tps_2k"] = decode_tps
    report["prefill_s_2k"] = prefill_s
    del cache, arrs

    # decode speed at 32K context over a synthetic filled cache
    ctx, steps = 32768, 16
    cfg32, dcfg32, qs32 = speed_config(ctx + steps + 8, 32)
    dq32 = deployed_from_quantizers(qs32, cfg.n_kv_heads, cfg.d_head,
                                    device="cuda")
    cache = filled_cache(dcfg32, cfg.n_layers, ctx, 3)
    tok = torch.zeros((1,), dtype=torch.int32, device="cuda")
    tps32, _ = decode_profile(
        f"[3] {ctx} ctx", lambda i: engine.decode_step(
            params, cfg32, dcfg32, dq32, cache, tok, ctx + i), steps)
    report["decode_tps_32k"] = tps32
    del cache, params
    torch.cuda.empty_cache()


def phase_card_vs_cpu(report):
    from kvquant_tpu_torch import engine
    from kvquant_tpu_torch.cache import DeployConfig, deployed_from_quantizers
    from kvquant_tpu_torch.models import init_params, params_from_numpy
    from kvquant_tpu_torch.quant.artifacts import (
        KQuantizer, VQuantizer, LayerQuantizers, QuantizerSet)
    from kvquant_tpu_torch.utils.toymodel import TOY_CFG as cfg

    cpu = init_params(cfg, torch.Generator().manual_seed(4),
                      dtype=torch.float32, device="cpu")
    tree = {"embed": cpu.embed.numpy(), "final_norm": cpu.final_norm.numpy(),
            "lm_head": cpu.lm_head.numpy(),
            "layers": {k: v.numpy() for k, v in cpu.layers.items()}}
    gpu = params_from_numpy(tree, cfg, device="cuda")
    rng = np.random.default_rng(5)
    lut = np.linspace(-1, 1, 16, dtype=np.float32)
    layers = []
    for _ in range(cfg.n_layers):
        u = (np.abs(rng.normal(size=cfg.kv_hidden)) + 0.5).astype(np.float32)
        layers.append(LayerQuantizers(
            k=KQuantizer(upper=u, lower=-u, lut=lut.copy(),
                         ressc=rng.random(cfg.kv_hidden).astype(np.float32)),
            v=VQuantizer(lut=lut.copy())))
    qs = QuantizerSet(layers=layers, bits=4, sparsity_threshold=0.99,
                      cap_outliers=True, first_few_fp16=5)
    dcfg = DeployConfig.create(
        bits=4, n_kv_heads=cfg.n_kv_heads, d_head=cfg.d_head, max_len=64,
        sink=5, kernel="flash_serial", head_group=4, codes="int4",
        post_rope_k=True, k_outliers="channels", n_kc=4, cap_per_side=0,
        dot_bf16=False)
    prompt = torch.randint(0, cfg.vocab_size, (1, 16),
                           generator=torch.Generator().manual_seed(6))
    gcfg = engine.GenerateConfig(max_new_tokens=32)
    out = {}
    for dev, params in (("cuda", gpu), ("cpu", cpu)):
        dq = deployed_from_quantizers(qs, cfg.n_kv_heads, cfg.d_head,
                                      device=dev)
        toks, _ = engine.generate(params, cfg, dcfg, dq, prompt, gcfg,
                                  device=dev)
        out[dev] = toks.cpu().tolist()
    same = out["cuda"] == out["cpu"]
    log(f"[4] toy model, 32 greedy tokens: card == cpu: {same}")
    if not same:
        raise AssertionError(f"card {out['cuda']} != cpu {out['cpu']}")


def phase_times(report):
    """K2 alone at one LLaMA-2-7B layer (the speed config: int4, G 1, D 128,
    hg 16, 16 static channels) at 32K and 128K: fs_mma (the plan's body for
    bf16 dots), fs_partial forced on the same bf16 call, and fs_partial on
    the fp32-dot call, timed in turns; each held to the plain version;
    the plans and the byte bound."""
    from kvquant_tpu_torch.ops.kernels import flash_serial as fs

    dev = torch.device("cuda")
    rows = []
    for ctx in (32768, 131072):
        cfg, dcfg, _ = speed_config(ctx + 8, 1)
        gen = torch.Generator(device=dev).manual_seed(7)
        Tc = dcfg.cache_tokens
        ops = kernel_operands(dcfg, cfg, 1, 1, 1, Tc, gen, dev)
        q = torch.randn((1, cfg.n_kv_heads, 1, cfg.d_head), generator=gen,
                        device=dev)
        pos = torch.tensor([ctx - 1], dtype=torch.int32, device=dev)
        n_live = ctx - dcfg.sink
        chan = fs.k_channel_index(ops["k_ressc"], dcfg).to(torch.int32)
        d32 = dataclasses.replace(dcfg, dot_bf16=False)

        def kern(d=dcfg, body=None):
            return fs.flash_serial_decode(
                q, ops["k_planes"], ops["v_planes"], ops["kv_out"],
                ops["k_range"], ops["k_offset"], ops["v_scale"],
                ops["v_offset"], ops["k_sink"], ops["v_sink"], ops["k_lut"],
                ops["v_lut"], 0, pos, d, cfg, k_chan=chan, body=body)

        def plain(d=dcfg):
            return call(fs.flash_serial_decode_ref, q, ops, 0, pos, d, cfg)

        want, want32 = plain(), plain(d32)
        err = max(agree(f"[5] K2 fs_mma ctx {ctx}", kern(), want, True),
                  agree(f"[5] K2 fs_partial (forced) ctx {ctx}",
                        kern(body="fs_partial"), want, True),
                  agree(f"[5] K2 fs_partial ctx {ctx}", kern(d32), want32,
                        False))
        report["max_abs_err_main"] = max(report.get("max_abs_err_main", 0.0),
                                         err)
        shape = (1, cfg.n_kv_heads, 1, cfg.d_head, Tc)
        plans = {"fs_mma": fs.fs_plan(dcfg, *shape, dev),
                 "fs_partial": fs.fs_plan(dcfg, *shape, dev,
                                          body="fs_partial")}
        mma = lambda: kern()  # noqa: E731
        part = lambda: kern(body="fs_partial")  # noqa: E731
        p32 = lambda: kern(d32)  # noqa: E731
        runs = {"fs_mma": [], "fs_partial": [], "fp32": []}
        for _ in range(2):  # in turns: mma, partial, fp32, fp32, partial, mma
            for name, fn in (("fs_mma", mma), ("fs_partial", part),
                             ("fp32", p32)):
                runs[name].append(device_ms(fn))
            for name, fn in (("fp32", p32), ("fs_partial", part),
                             ("fs_mma", mma)):
                runs[name].append(device_ms(fn))
        ms = {k: min(v) for k, v in runs.items()}
        plain_ms = device_ms(plain, n=3, reps=3, warmup=1)
        call_ms = median_ms(mma)
        nbytes = (n_live * stored_bytes_per_token(dcfg)
                  + 4 * cfg.n_kv_heads * cfg.d_head * (2 * dcfg.sink + 2))
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        # context only, never called by the port: SDPA over a bf16 K/V
        # cache of the same length
        kb = torch.randn((1, cfg.n_kv_heads, ctx, cfg.d_head), device=dev,
                         dtype=torch.bfloat16)
        qb = torch.randn((1, cfg.n_kv_heads, 1, cfg.d_head), device=dev,
                         dtype=torch.bfloat16)
        sdpa_ms = device_ms(lambda: torch.nn.functional.
                            scaled_dot_product_attention(qb, kb, kb))
        del kb
        row = dict(ctx=ctx, body="fs_mma", ms=ms["fs_mma"],
                   ms_runs=runs["fs_mma"], partial_ms=ms["fs_partial"],
                   partial_runs=runs["fs_partial"], fp32_partial_ms=ms["fp32"],
                   fp32_runs=runs["fp32"], call_ms=call_ms,
                   plain_ms=plain_ms, bound_ms=bound_ms, bytes=nbytes,
                   max_abs_err=err, plans={k: repr(v)
                                           for k, v in plans.items()},
                   sdpa_bf16_kv_ms_context_only=sdpa_ms)
        log(f"[5] K2 ctx {ctx}: plans {plans['fs_mma']!r}; "
            f"{plans['fs_partial']!r}")
        log(f"[5] K2 ctx {ctx}: fs_mma {ms['fs_mma']:.4f} ms device (runs "
            + ", ".join(f"{x:.4f}" for x in runs["fs_mma"])
            + f"; {call_ms:.4f} ms per call with the wrapper's host time), "
            f"{bound_ms / ms['fs_mma']:.0%} of bound; fs_partial on the same "
            f"bf16 call {ms['fs_partial']:.4f} ms (runs "
            + ", ".join(f"{x:.4f}" for x in runs["fs_partial"])
            + f"), fs_partial with fp32 dots {ms['fp32']:.4f} ms (runs "
            + ", ".join(f"{x:.4f}" for x in runs["fp32"])
            + f"); plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms "
            f"({nbytes / 1e6:.1f} MB at 3.35 TB/s), |err| {err:.2e}; "
            f"context only: SDPA over bf16 K/V {sdpa_ms:.4f} ms")
        if ms["fs_mma"] > ms["fs_partial"]:
            log(f"[5] K2 ctx {ctx}: fs_mma is SLOWER than fs_partial")
        rows.append(row)
        del ops
        torch.cuda.empty_cache()
    report["times"] = rows


# ---------------------------------------------------------------------------
# K1: flash_attention (csrc/flash_decode.cu)
# ---------------------------------------------------------------------------


def k1_operands(dcfg, L, B, Tc, gen, dev):
    """Random cache arrays for K1: bit planes (random int32 words are valid
    planes) with non-affine sorted codebooks, or integer containers."""
    if dcfg.codes != "nuq":
        return kernel_operands(dcfg, None, L, B, None, Tc, gen, dev)
    ops = kernel_operands(dataclasses.replace(dcfg, codes="int8", bits=8),
                          None, L, B, None, Tc, gen, dev)
    K = 2 ** dcfg.bits
    shape = (L, B, dcfg.n_kv_heads, dcfg.bits, Tc // 32, dcfg.d_head)
    for name in ("k_planes", "v_planes"):
        ops[name] = torch.randint(-2 ** 31, 2 ** 31, shape, generator=gen,
                                  device=dev, dtype=torch.int64).to(
            torch.int32)
    for name in ("k_lut", "v_lut"):
        ops[name] = torch.sort(torch.rand((L, K), generator=gen, device=dev)
                               * 2 - 1, dim=-1).values
    return ops


def filled_cache(dcfg, n_layers, ctx, seed):
    """A synthetic cache of ``ctx`` tokens (random containers and rows)."""
    from kvquant_tpu_torch.cache import KVCache

    ops = k1_operands(dcfg, n_layers, 1, dcfg.cache_tokens,
                      torch.Generator(device="cuda").manual_seed(seed),
                      torch.device("cuda"))
    return KVCache(length=torch.full((1,), ctx, dtype=torch.int32,
                                     device="cuda"),
                   **{k: ops[k] for k in ("k_planes", "v_planes", "kv_out",
                                          "v_scale", "v_offset", "k_sink",
                                          "v_sink")})


def k1_config(codes, bits, Hkv, D, G, Tc, sink, post, k_out, hg, window,
              dot_bf16, L=2, n_kc=None):
    """A K1 DeployConfig (k_out: "channels" cap 0 / "slots" cap 2 / "none"
    no sparse rows; n_kc 3, or 16 at head group 16) and its ModelConfig."""
    from kvquant_tpu_torch.cache import DeployConfig
    from kvquant_tpu_torch.models.config import ModelConfig

    dcfg = DeployConfig.create(
        bits=bits, n_kv_heads=Hkv, d_head=D, max_len=Tc + sink, sink=sink,
        kernel="flash", dot_bf16=dot_bf16, head_group=hg, codes=codes,
        post_rope_k=post,
        k_outliers="channels" if k_out == "channels" else "slots",
        n_kc=n_kc or (3 if hg < 16 else 16), include_sparse=k_out != "none",
        cap_per_side=2 if k_out == "slots" else 0)
    mcfg = ModelConfig(vocab_size=64, d_model=Hkv * G * D, n_layers=L,
                       n_heads=Hkv * G, n_kv_heads=Hkv, d_head=D, d_ff=64,
                       max_seq_len=Tc, sliding_window=window)
    return dcfg, mcfg


def phase_k1_vs_plain(report):
    """K1 against its plain version: nuq 2/3/4 bits, int4, int8 x pre/post
    RoPE x slots (cap 2, hg 4) / channels (cap 0) x sink 0/5 x (decode at
    B=2 with unequal positions; a first prefill chunk of 128 + sink rows;
    a later chunk of 128 rows), a sliding window, and other widths (D 32 /
    64, G 1 / 4 / 8, hg 1 / 2 / 16), each with fp32 and with bf16 dots."""
    from kvquant_tpu_torch.ops.kernels import flash_decode as fd

    dev = torch.device("cuda")
    L, B, Hkv, G, D, Tc = 2, 2, 4, 2, 128, 1024
    cases = []
    for codes, bits in (("nuq", 2), ("nuq", 3), ("nuq", 4), ("int4", 4),
                        ("int8", 8)):
        for post in (False, True):
            for k_out, hg in (("slots", 4), ("channels", 2)):
                for sink in (0, 5):
                    for tq, pos in ((1, [3, 700]), (128 + sink, [0, 0]),
                                    (128, [sink + 128, sink + 384])):
                        cases.append((codes, bits, Hkv, D, G, sink, post,
                                      k_out, hg, None, tq, pos))
    cases += [
        ("nuq", 3, Hkv, D, G, 5, False, "slots", 4, 300, 1, [700, 1001]),
        ("nuq", 3, Hkv, D, G, 5, False, "slots", 4, 200, 128, [389, 645]),
        ("nuq", 3, 8, 32, 8, 5, False, "slots", 1, None, 1, [40, 900]),
        ("nuq", 2, 4, 64, 4, 5, False, "slots", 2, None, 133, [0, 0]),
        ("int4", 4, 16, 128, 1, 5, True, "channels", 16, None, 1, [5, 1000]),
        ("nuq", 4, 4, 32, 1, 0, True, "channels", 1, None, 128, [256, 512]),
    ]
    worst = {False: 0.0, True: 0.0}
    t0 = time.perf_counter()
    for dot_bf16 in (False, True):
        for (codes, bits, hkv, d, g, sink, post, k_out, hg, window, tq,
             pos) in cases:
            dcfg, mcfg = k1_config(codes, bits, hkv, d, g, Tc, sink, post,
                                   k_out, hg, window, dot_bf16)
            gen = torch.Generator(device=dev).manual_seed(21)
            ops = k1_operands(dcfg, L, B, Tc, gen, dev)
            q = torch.randn((B, hkv, g * tq, d), generator=gen, device=dev)
            p = torch.tensor(pos, dtype=torch.int32, device=dev)
            args = (q, ops["k_planes"], ops["v_planes"], ops["kv_out"],
                    ops["k_range"], ops["k_offset"], ops["v_scale"],
                    ops["v_offset"], ops["k_sink"], ops["v_sink"],
                    ops["k_lut"], ops["v_lut"], 1, p, dcfg, mcfg)
            got = fd.flash_attention(*args, Tq=tq, k_ressc=ops["k_ressc"])
            torch.cuda.synchronize()
            want = fd.flash_attention_ref(*args, Tq=tq,
                                          k_ressc=ops["k_ressc"])
            check_case(f"[6] {codes}{bits} {'post' if post else 'pre'} "
                       f"{k_out} hg{hg} sink{sink} D{d} G{g} Tq{tq} "
                       f"win{window}", got, want, dot_bf16, worst)
    log(f"[6] K1 == plain on {len(cases)} cases x 2 dot modes in "
        f"{time.perf_counter() - t0:.1f} s; worst |err| / bound: fp32 dots "
        f"{worst[False]:.3f} (bound 1e-4*(1+max|plain|)), bf16 dots "
        f"{worst[True]:.3f} (bound 1e-2*max|plain|)")
    report["k1_grid_worst_ratio"] = worst
    report["k1_decode_edges"] = decode_edge_grid(
        "[6]", (("nuq", 2), ("nuq", 3), ("nuq", 4), ("int4", 4),
                ("int8", 8)), paged=False)
    report["k1_chunk_edges"] = chunk_edge_grid(
        "[6]", (("nuq", 2), ("nuq", 3), ("nuq", 4), ("int4", 4),
                ("int8", 8)))
    rope_table_check("[6]")


def decode_widths(codes):
    """(G, head group, d_head, K outliers) of the decode-body edge grid:
    G 1/2/4/8, head groups 1-16 and d_head 32/64/128 as the mode allows
    (int4x2 pairs heads: even groups; slot words carry a 2-bit head index
    and hg * D <= 512: slots only at hg <= 4)."""
    if codes == "int4x2":
        return [(1, 2, 128, "slots"), (2, 4, 64, "slots"),
                (4, 2, 32, "slots"), (8, 4, 128, "none"),
                (1, 8, 128, "channels"), (2, 16, 64, "channels"),
                (4, 4, 32, "channels")]
    return [(1, 4, 128, "slots"), (2, 2, 64, "slots"), (4, 1, 32, "slots"),
            (8, 4, 32, "slots"), (1, 8, 128, "channels"),
            (2, 16, 64, "channels"), (8, 1, 128, "channels"),
            (4, 2, 128, "none")]


def decode_edge_grid(tag, modes, paged, odd_g=False):
    """The decode body (fd_decode) against the plain version over its edge
    cases, fp32 and bf16 dots: each mode x pre / post RoPE x the widths of
    ``decode_widths`` x sink 0 / 5, and a sliding window; B = 3 rows at
    ragged positions: one with no packed token (pos < S; pos 0 at sink 0),
    one whose live length 201 is not a multiple of a tile, one deep; the
    card's splits beyond a row's live tiles hold no tile. ``paged``: K5
    over permuted pages of 256 (with an inactive fourth slot aliasing the
    third's pages), also held to K1 on the same tokens. ``odd_g``: the
    widths' G 1 / 2 / 4 / 8 become 3 / 5 / 6 / 7, head ratios without an
    fd_decode instance (with bf16 dots K1 and K5 run them on the
    tensor-core decode body fd_gqa; with fp32 dots K1 runs its chunk body
    at Tq = 1 and K5 pads them to the next instance), and K5 == K1 is held
    to the dot mode's bound. Returns the worst |err| / bound per dot
    mode."""
    from kvquant_tpu_torch.ops.kernels import flash_decode as fd
    from kvquant_tpu_torch.ops.kernels import paged_decode as pdk

    dev = torch.device("cuda")
    L, Tc, P = 2, 1024, 256
    worst = {False: 0.0, True: 0.0}
    k1_diff, n = 0.0, 0
    t0 = time.perf_counter()
    for dot_bf16 in (False, True):
        for codes, bits in modes:
            widths = decode_widths(codes)
            if odd_g:
                widths = [({1: 3, 2: 5, 4: 6, 8: 7}[G], hg, D, k)
                          for G, hg, D, k in widths]
            for post in (False, True):
                for i, (G, hg, D, k_out) in enumerate(widths):
                    for sink in (0, 5):
                        for window in (None, 300) if i == 0 else (None,):
                            Hkv = max(4, hg)
                            dcfg, mcfg = k1_config(
                                codes, bits, Hkv, D, G, 3 * P if paged else Tc,
                                sink, post, k_out, hg, window, dot_bf16, L=L,
                                n_kc=4 if codes == "int4x2" else None)
                            gen = torch.Generator(device=dev).manual_seed(
                                61 + n)
                            case = (f"{tag} edge {codes}{bits} "
                                    f"{'post' if post else 'pre'} {k_out} "
                                    f"G{G} hg{hg} D{D} sink{sink} "
                                    f"win{window}")
                            if paged:
                                dcfg = dataclasses.replace(dcfg,
                                                           page_tokens=P)
                                pool, ops, table, pos = paged_case(
                                    dcfg, L, P, gen, dev)
                                pos[0] = max(sink - 2, 0)
                                pos[1] = sink + 200
                                dq = paged_dq(ops)
                                q = torch.randn((4, Hkv, G, D), generator=gen,
                                                device=dev)
                                got = pdk.paged_flash_decode(
                                    q, pool, table, dq, 1, pos, dcfg, mcfg)
                                torch.cuda.synchronize()
                                want = pdk.paged_flash_decode_ref(
                                    q, pool, table, dq, 1, pos, dcfg, mcfg)
                                k1 = k1_on_pages(q, pool, table, dq, 1, pos,
                                                 dcfg, mcfg,
                                                 fd.flash_attention)
                                diff = float((got - k1).abs().max())
                                scale = float(want.abs().max())
                                if not diff <= (
                                        BF16_TOL * scale
                                        if odd_g and dot_bf16
                                        else FP32_TOL * (1 + scale)):
                                    raise AssertionError(
                                        f"{case}: K5 != K1 on the same "
                                        f"tokens ({diff:.3e})")
                                k1_diff = max(k1_diff, diff)
                            else:
                                ops = k1_operands(dcfg, L, 3, Tc, gen, dev)
                                q = torch.randn((3, Hkv, G, D), generator=gen,
                                                device=dev)
                                pos = torch.tensor(
                                    [max(sink - 2, 0), sink + 200,
                                     sink + Tc - 4], dtype=torch.int32,
                                    device=dev)
                                got = call(fd.flash_attention, q, ops, 1, pos,
                                           dcfg, mcfg)
                                torch.cuda.synchronize()
                                want = call(fd.flash_attention_ref, q, ops, 1,
                                            pos, dcfg, mcfg)
                            check_case(case, got, want, dot_bf16, worst)
                            n += 1
    log(f"{tag} decode body edge grid ({'K5' if paged else 'K1'}): "
        f"{n // 2} cases x 2 dot modes in {time.perf_counter() - t0:.1f} s; "
        f"worst |err| / bound: fp32 dots {worst[False]:.3f}, bf16 dots "
        f"{worst[True]:.3f}" + (f"; max |K5 - K1 on the same tokens| "
                                f"{k1_diff:.3e}" if paged else ""))
    return dict(worst)


def chunk_edge_grid(tag, modes):
    """The chunk bodies (fd_chunk with bf16 dots, fd_partial with fp32 dots)
    against the plain version over their edge cases: each mode x pre / post
    RoPE x G 1 / 4 (g-major rows, Q = G x 256 and G x 261: row blocks
    straddle g boundaries, and 261 rows are no multiple of a block's rows),
    cycling D 32 / 64 / 128 x slots / channels / none x sink 0 / 5; each
    with a first chunk at pos 0 (its sink rows see no packed token), a
    later 261-row chunk at unequal positions of B = 2 (its last tile partly
    masked) and a 256-row chunk under a sliding window. Returns the worst
    |err| / bound per dot mode."""
    from kvquant_tpu_torch.ops.kernels import flash_decode as fd

    dev = torch.device("cuda")
    L, Tc = 2, 1024
    if modes[0][0] == "int4x2":  # pairs heads: even head groups
        widths = [(128, "slots", 4), (64, "channels", 2), (32, "none", 2),
                  (128, "channels", 4)]
    else:
        widths = [(128, "slots", 4), (64, "channels", 2), (32, "none", 1),
                  (128, "channels", 4)]
    worst = {False: 0.0, True: 0.0}
    n = 0
    t0 = time.perf_counter()
    for dot_bf16 in (False, True):
        i = 0
        for codes, bits in modes:
            for post in (False, True):
                for G in (1, 4):
                    D, k_out, hg = widths[i % len(widths)]
                    sink = (0, 5)[(i // len(widths)) % 2]
                    i += 1
                    for tq, pos, window in (
                            (256 + sink, [0, 0], None),
                            (261, [sink + 256, sink + 517], None),
                            (256, [sink + 300, sink + 700], 200)):
                        dcfg, mcfg = k1_config(
                            codes, bits, 4, D, G, Tc, sink, post, k_out, hg,
                            window, dot_bf16, L=L,
                            n_kc=4 if codes == "int4x2" else None)
                        gen = torch.Generator(device=dev).manual_seed(71 + n)
                        ops = k1_operands(dcfg, L, 2, Tc, gen, dev)
                        q = torch.randn((2, 4, G * tq, D), generator=gen,
                                        device=dev)
                        p = torch.tensor(pos, dtype=torch.int32, device=dev)
                        got = call(lambda *a, **k: fd.flash_attention(
                            *a, Tq=tq, **k), q, ops, 1, p, dcfg, mcfg)
                        torch.cuda.synchronize()
                        want = call(lambda *a, **k: fd.flash_attention_ref(
                            *a, Tq=tq, **k), q, ops, 1, p, dcfg, mcfg)
                        check_case(f"{tag} chunk edge {codes}{bits} "
                                   f"{'post' if post else 'pre'} {k_out} "
                                   f"G{G} hg{hg} D{D} sink{sink} Tq{tq} "
                                   f"pos{pos} win{window}", got, want,
                                   dot_bf16, worst)
                        n += 1
    log(f"{tag} chunk body edge grid (K1, Tq > 1): {n // 2} cases x 2 dot "
        f"modes in {time.perf_counter() - t0:.1f} s; worst |err| / bound: "
        f"fp32 dots (fd_partial) {worst[False]:.3f}, bf16 dots (fd_chunk) "
        f"{worst[True]:.3f}")
    return dict(worst)


def rope_table_check(tag):
    """The kernels' cached (cos, sin) table on the card: bitwise the plain
    version's rope_cos_sin on the card, one tensor per key. Its distance
    to the CPU's table is printed, not held: torch.pow rounds the RoPE
    frequencies an ulp apart on the two devices, an ulp of a 1e5-radian
    angle."""
    from kvquant_tpu_torch.models.llama import rope_cos_sin
    from kvquant_tpu_torch.ops.kernels import flash_decode as fd

    _, mcfg = k1_config("nuq", 3, 32, 128, 1, 131072, 5, False, "slots", 4,
                        None, True, L=1)
    S, Tc = 5, 131072
    tab = fd.rope_table(mcfg, S, Tc, "cuda")
    half = mcfg.d_head // 2
    cos, sin = rope_cos_sin(S + torch.arange(Tc, dtype=torch.int32,
                                             device="cuda"), mcfg)
    same = bool(torch.equal(tab[..., 0], cos[:, :half])
                and torch.equal(tab[..., 1], sin[:, :half]))
    cc, sc = rope_cos_sin(S + torch.arange(Tc, dtype=torch.int32), mcfg)
    cpu = float(torch.stack([cc[:, :half], sc[:, :half]], -1).sub(
        tab.cpu()).abs().max())
    again = fd.rope_table(mcfg, S, Tc, torch.device("cuda")) is tab
    log(f"{tag} cached RoPE table ({Tc} x {half}): == rope_cos_sin on the "
        f"card bitwise: {same}; the same tensor on a second call: {again}; "
        f"max |card - CPU| {cpu:.2e}")
    if not (same and again):
        raise AssertionError("cached RoPE table")


# a fixed non-affine 3-bit codebook, normalized to [-1, 1]
NUQ3_LUT = np.array([-1.0, -0.62, -0.33, -0.1, 0.09, 0.31, 0.6, 1.0],
                    np.float32)


def faithful_config(max_len, n_layers, cfg=None):
    """LLaMA-2-7B width (or ``cfg``'s) and the reference-faithful scheme
    (the JAX package's DeployConfig defaults): nuq3 bit planes, pre-RoPE
    K, slot outliers with cap 2 per side per head group of 4, sink 5, K1."""
    from kvquant_tpu_torch.cache import DeployConfig
    from kvquant_tpu_torch.models.config import LLAMA2_7B
    from kvquant_tpu_torch.quant.artifacts import (
        KQuantizer, VQuantizer, LayerQuantizers, QuantizerSet)

    cfg = cfg or LLAMA2_7B
    dcfg = DeployConfig.create(
        bits=3, n_kv_heads=cfg.n_kv_heads, d_head=cfg.d_head,
        max_len=max_len, sink=5, kernel="flash", head_group=4, codes="nuq",
        post_rope_k=False, k_outliers="slots", cap_per_side=2)
    rng = np.random.default_rng(10)
    layers = []
    for _ in range(n_layers):
        u = (np.abs(rng.normal(size=cfg.kv_hidden)) * 2 + 1).astype(np.float32)
        layers.append(LayerQuantizers(
            k=KQuantizer(upper=u, lower=(-u * 0.9).astype(np.float32),
                         lut=NUQ3_LUT.copy()),
            v=VQuantizer(lut=NUQ3_LUT.copy())))
    qs = QuantizerSet(layers=layers, bits=3, sparsity_threshold=0.99,
                      cap_outliers=True, first_few_fp16=5)
    return cfg, dcfg, qs


def nuq_bytes_per_token(dcfg):
    """Cache bytes of one packed token in one layer under bit planes: K
    and V codes of every kv head, the groups' slot words, V scale/offset."""
    return (2 * dcfg.n_kv_heads * dcfg.d_head * dcfg.bits // 8
            + dcfg.n_groups * dcfg.n_slots * 4 + 8)


def decode_profile(tag, step, steps, prof_steps=3):
    """Host wall time of ``steps`` decode steps after two warm-up steps,
    then one profiler pass over ``prof_steps`` more: device kernel time per
    step, device idle share (profiled device time over the step time of the
    unprofiled loop, since the profiler slows the host) and the top
    kernels. ``step(i)`` runs the decode step at offset i; with
    ``prof_steps`` 0 only the wall time (idle share None)."""
    from torch.profiler import ProfilerActivity, profile

    for i in range(2):  # warm-up
        step(i)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(steps):
        step(2 + i)
    torch.cuda.synchronize()
    tps = steps / (time.perf_counter() - t0)
    if prof_steps == 0:
        log(f"{tag} decode {tps:.2f} tok/s (host wall time, {steps} steps)")
        return tps, None
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA], acc_events=True) as prof:
        for i in range(prof_steps):
            step(2 + steps + i)
        torch.cuda.synchronize()
    # device-side events only: CPU ops also report the device time of the
    # kernels they launched, which would count every kernel twice
    ev = [e for e in prof.key_averages()
          if e.device_type == torch.autograd.DeviceType.CUDA
          and e.self_device_time_total > 0]
    dev_us = sum(e.self_device_time_total for e in ev) / prof_steps
    idle = 1 - dev_us / 1e3 * tps / 1e3
    log(f"{tag} decode {tps:.2f} tok/s (host wall time, {steps} steps); "
        f"profiler: device kernel time {dev_us / 1e3:.3f} ms/step vs "
        f"{1e3 / tps:.3f} ms/step unprofiled wall (device idle share "
        f"{idle:.3f}); {sum(e.count for e in ev) / prof_steps:.0f} "
        f"kernels/step")
    for e in sorted(ev, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"{tag}   {e.self_device_time_total / prof_steps / 1e3:8.3f} "
            f"ms/step  x{e.count // prof_steps:5d}  {e.key[:90]}")
    return tps, idle


def phase_k1_main_path(report):
    """The slice's main path at LLaMA-2-7B width: quantized chunked prefill
    of a 2048-token prompt and 64 greedy tokens, all through K1."""
    from kvquant_tpu_torch import engine
    from kvquant_tpu_torch.cache import create_cache, deployed_from_quantizers
    from kvquant_tpu_torch.models import init_params
    from kvquant_tpu_torch.ops.kernels import flash_decode as fd

    T0, N, chunk = 2048, 64, 256
    cfg, dcfg, qs = faithful_config(T0 + N + 5, 32)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         dtype=torch.bfloat16, device="cuda")
    dq = deployed_from_quantizers(qs, cfg.n_kv_heads, cfg.d_head,
                                  device="cuda")
    prompt = torch.randint(0, cfg.vocab_size, (1, T0),
                           generator=torch.Generator().manual_seed(1))
    n_chunks = -(-(T0 - dcfg.sink) // chunk)
    log(f"[7] LLaMA-2-7B width, {cfg.n_layers} layers, bf16 weights; nuq3 "
        f"pre-RoPE, slots cap 2, hg 4, sink 5, kernel flash; cache "
        f"{nuq_bytes_per_token(dcfg)} B/token/layer")

    # prefill alone (also the warm-up of every shape the path uses)
    cache = create_cache(dcfg, cfg.n_layers, 1, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.prefill_quantized(params, cfg, dcfg, dq, cache, prompt.cuda(),
                             chunk=chunk)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    del cache

    gcfg = engine.GenerateConfig(max_new_tokens=N)
    read = reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks, cache = engine.generate(params, cfg, dcfg, dq, prompt, gcfg,
                                  prefill_mode="quantized", device="cuda")
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    n = read()
    launches = n["K1"]
    want = cfg.n_layers * (n_chunks + N)
    report["k1_launches"] = launches
    report["k1_chunk_launches"] = n["K1_chunk"]
    log(f"[7] quantized prefill {T0} tokens ({n_chunks} chunks of {chunk}) "
        f"{prefill_s:.3f} s; generate (prefill + {N} decode steps) "
        f"{gen_s:.3f} s; K1 launches {launches} (expected {want}), of them "
        f"chunks (fd_chunk) {n['K1_chunk']} (expected "
        f"{cfg.n_layers * n_chunks})")
    if launches != want or n["K1_chunk"] != cfg.n_layers * n_chunks:
        raise AssertionError("main path did not run K1 per layer and chunk")
    if not (toks.shape == (1, N) and int(toks.min()) >= 0
            and int(toks.max()) < cfg.vocab_size):
        raise AssertionError(f"bad tokens {toks.shape}")
    _, logits = engine.decode_step(params, cfg, dcfg, dq, cache,
                                   toks[:, -1], T0 + N)
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("non-finite logits")
    decode_tps = N / (gen_s - prefill_s)
    log(f"[7] decode {decode_tps:.2f} tok/s at {T0}-{T0 + N} context "
        f"(64 / (generate - prefill) wall time)")

    # the live cache: K1 against plain at the first and last layer, a
    # decode row and a 256-row chunk, bf16 and fp32 dots
    gen = torch.Generator(device="cuda").manual_seed(2)
    arrs = cache.arrays()
    worst = 0.0
    for tq, p0 in ((1, T0 + N), (256, 1029)):
        q = torch.randn((1, cfg.n_kv_heads, tq, cfg.d_head), generator=gen,
                        device="cuda")
        pos = torch.tensor([p0], dtype=torch.int32, device="cuda")
        for li in (0, cfg.n_layers - 1):
            for d in (dcfg, dataclasses.replace(dcfg, dot_bf16=False)):
                args = (q, arrs["k_planes"], arrs["v_planes"],
                        arrs["kv_out"], dq.k_range, dq.k_offset,
                        arrs["v_scale"], arrs["v_offset"], arrs["k_sink"],
                        arrs["v_sink"], dq.k_lut_dec, dq.v_lut_dec, li, pos,
                        d, cfg)
                got = fd.flash_attention(*args, Tq=tq)
                want_ = fd.flash_attention_ref(*args, Tq=tq)
                worst = max(worst, agree(f"[7] live cache layer {li} Tq {tq}",
                                         got, want_, d.dot_bf16))
    report["k1_max_abs_err"] = worst
    report["k1_decode_tps_2k"] = decode_tps
    report["k1_prefill_s_2k"] = prefill_s
    del cache, arrs

    # decode at 32K context over a synthetic filled nuq3 cache
    ctx, steps = 32768, 16
    cfg32, dcfg32, qs32 = faithful_config(ctx + steps + 8, 32)
    dq32 = deployed_from_quantizers(qs32, cfg.n_kv_heads, cfg.d_head,
                                    device="cuda")
    cache = filled_cache(dcfg32, cfg.n_layers, ctx, 3)
    tok = torch.zeros((1,), dtype=torch.int32, device="cuda")
    builds = fd._rope_table.cache_info().misses
    tps32, idle = decode_profile(
        f"[7] {ctx} ctx", lambda i: engine.decode_step(
            params, cfg32, dcfg32, dq32, cache, tok, ctx + i), steps)
    builds = fd._rope_table.cache_info().misses - builds
    log(f"[7] (cos, sin) tables built over the {steps + 5} decode steps of "
        f"32 layers: {builds} (one per capacity and sink)")
    if builds > 1:
        raise AssertionError("the RoPE table was rebuilt within a run")
    report["k1_decode_tps_32k"] = tps32
    report["k1_idle_32k"] = idle
    del cache, params
    torch.cuda.empty_cache()


def toy_card_vs_cpu(tag, kernel):
    """The committed toy checkpoint with its 3-bit quantizers, nuq3
    pre-RoPE slots hg 4, fp32 dots, through ``kernel``: 32 greedy tokens,
    card == CPU, with the fp16 and the quantized prefill."""
    import os

    from kvquant_tpu_torch import engine
    from kvquant_tpu_torch.cache import DeployConfig, deployed_from_quantizers
    from kvquant_tpu_torch.models import params_from_numpy
    from kvquant_tpu_torch.quant.artifacts import load_quantizers
    from kvquant_tpu_torch.utils.toymodel import TOY_CFG as cfg
    from kvquant_tpu_torch.utils.toymodel import load_toy_checkpoint

    art = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "artifacts")
    tree, _, _ = load_toy_checkpoint(os.path.join(art, "toy_model.npz"))
    qs = load_quantizers(os.path.join(art, "toy_quantizers_3bit.npz"))
    dcfg = DeployConfig.create(
        bits=3, n_kv_heads=cfg.n_kv_heads, d_head=cfg.d_head, max_len=69,
        sink=5, kernel=kernel, head_group=4, codes="nuq", post_rope_k=False,
        k_outliers="slots", cap_per_side=2, dot_bf16=False)
    prompt = torch.as_tensor(np.random.default_rng(6).integers(
        0, cfg.vocab_size, (1, 16), dtype=np.int32))
    gcfg = engine.GenerateConfig(max_new_tokens=32)
    for mode in ("fp16", "quantized"):
        out = {}
        for dev in ("cuda", "cpu"):
            params = params_from_numpy(tree, cfg, device=dev)
            dq = deployed_from_quantizers(qs, cfg.n_kv_heads, cfg.d_head,
                                          device=dev)
            toks, _ = engine.generate(params, cfg, dcfg, dq, prompt, gcfg,
                                      prefill_mode=mode, device=dev)
            out[dev] = toks.cpu().tolist()
        same = out["cuda"] == out["cpu"]
        log(f"{tag} toy checkpoint, nuq3 kernel {kernel}, prefill {mode}, "
            f"32 greedy tokens: card == cpu: {same}")
        if not same:
            raise AssertionError(f"card {out['cuda']} != cpu {out['cpu']}")


def phase_k1_card_vs_cpu(report):
    """The toy checkpoint through K1: card == CPU, both prefill modes."""
    toy_card_vs_cpu("[8]", "flash")


def phase_k1_times(report):
    """K1 at one LLaMA-2-7B layer (reference-faithful config, bf16 dots):
    decode at 32K and 128K, a 256-row prefill chunk at 2K and 32K."""
    from kvquant_tpu_torch.ops.kernels import flash_decode as fd

    dev = torch.device("cuda")
    rows = []
    for kind, ctx in (("decode", 32768), ("decode", 131072),
                      ("prefill", 2048), ("prefill", 32768)):
        tq = 1 if kind == "decode" else 256
        cfg, dcfg, _ = faithful_config(ctx + tq + 8, 1)
        Hkv, D, S = cfg.n_kv_heads, cfg.d_head, dcfg.sink
        gen = torch.Generator(device=dev).manual_seed(7)
        ops = k1_operands(dcfg, 1, 1, dcfg.cache_tokens, gen, dev)
        q = torch.randn((1, Hkv, tq, D), generator=gen, device=dev)
        # decode: the row at ctx - 1; prefill: rows at ctx .. ctx + 255
        p0 = ctx - 1 if kind == "decode" else ctx
        pos = torch.tensor([p0], dtype=torch.int32, device=dev)

        def run(fn, d=dcfg):
            return fn(q, ops["k_planes"], ops["v_planes"], ops["kv_out"],
                      ops["k_range"], ops["k_offset"], ops["v_scale"],
                      ops["v_offset"], ops["k_sink"], ops["v_sink"],
                      ops["k_lut"], ops["v_lut"], 0, pos, d, cfg, Tq=tq)

        d32 = dataclasses.replace(dcfg, dot_bf16=False)
        err = max(agree(f"[9] K1 {kind} ctx {ctx}", run(fd.flash_attention),
                        run(fd.flash_attention_ref), True),
                  agree(f"[9] K1 {kind} ctx {ctx}",
                        run(fd.flash_attention, d32),
                        run(fd.flash_attention_ref, d32), False))
        report["k1_max_abs_err"] = max(report.get("k1_max_abs_err", 0.0), err)
        kern = lambda: run(fd.flash_attention)
        ms = device_ms(kern)
        plain_ms = device_ms(lambda: run(fd.flash_attention_ref), n=2,
                             reps=3, warmup=1)
        ms2 = device_ms(kern)
        call_ms = median_ms(kern)
        # what this run's rows need: packed keys up to each row's position
        # and the sink; every live token's bytes read once, q and out once
        last = p0 + tq - 1 - S
        n_live = last + 1
        pairs = sum(p0 + r - S + 1 + S for r in range(tq))
        nbytes = (n_live * nuq_bytes_per_token(dcfg)
                  + 4 * Hkv * D * (2 * S + 2 * tq))
        flops = 4 * pairs * D * Hkv
        b_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        b_ops = flops / BF16_FLOPS * 1e3
        bound_ms = max(b_bytes, b_ops)
        # context only, never called by the port: SDPA over a bf16 K/V of
        # the same length (non-causal)
        kb = torch.randn((1, Hkv, ctx, D), device=dev, dtype=torch.bfloat16)
        qb = torch.randn((1, Hkv, tq, D), device=dev, dtype=torch.bfloat16)
        sdpa_ms = device_ms(lambda: torch.nn.functional.
                            scaled_dot_product_attention(qb, kb, kb))
        del kb
        row = dict(kind=kind, ctx=ctx, tq=tq, ms=min(ms, ms2),
                   ms_runs=[ms, ms2], call_ms=call_ms, plain_ms=plain_ms,
                   bound_ms=bound_ms,
                   bound_by="bytes" if b_bytes >= b_ops else "operations",
                   bytes=nbytes, flops=flops, max_abs_err=err,
                   sdpa_bf16_kv_ms_context_only=sdpa_ms)
        log(f"[9] K1 {kind} Tq {tq} ctx {ctx}: kernel {row['ms']:.4f} ms "
            f"device (runs {ms:.4f}, {ms2:.4f}; {call_ms:.4f} ms per call "
            f"with the wrapper's host time), plain {plain_ms:.3f} ms, bound "
            f"{bound_ms:.4f} ms by {row['bound_by']} ({nbytes / 1e6:.1f} MB "
            f"at 3.35 TB/s = {b_bytes:.4f} ms; {flops / 1e9:.2f} GFLOP at "
            f"989 TFLOP/s = {b_ops:.4f} ms), |err| {err:.2e}; context only: "
            f"SDPA over bf16 K/V {sdpa_ms:.4f} ms"
            f"{vs_before(('K1', 'nuq3', kind, ctx), row['ms'])}")
        rows.append(row)
        del ops
        torch.cuda.empty_cache()
    report["k1_times"] = rows


# ---------------------------------------------------------------------------
# K3 / K4: qk_fused and pv_fused (csrc/attention.cu)
# ---------------------------------------------------------------------------


def k34_operands(dcfg, B, R, Tc, gen, dev, p_cols=5):
    """Random operands of K3 and K4 for one config: random int32 words are
    valid bit planes; slot words at in-group heads below head_group and
    dims below d_head, a fifth of them zero (padding); the probabilities a
    column slice of a softmax over p_cols + Tc columns, as the main path
    hands them over after the sink columns."""
    from kvquant_tpu_torch.ops import packing as pk

    Hkv, D, hg, bits = dcfg.n_kv_heads, dcfg.d_head, dcfg.head_group, dcfg.bits
    K = 2 ** bits

    def planes():
        return torch.randint(-2 ** 31, 2 ** 31, (B, Hkv, bits, Tc // 32, D),
                             generator=gen, device=dev,
                             dtype=torch.int64).to(torch.int32)

    shape = (B, dcfg.n_groups, dcfg.n_slots, Tc)
    vals = torch.randn(shape, generator=gen, device=dev) * 0.5
    idx = (torch.randint(0, hg, shape, generator=gen, device=dev) << 7) | \
        torch.randint(0, D, shape, generator=gen, device=dev)
    words = pk.encode_outlier_words(vals, idx)
    words = words.masked_fill(torch.rand(shape, generator=gen, device=dev)
                              < 0.2, 0.0)
    logits = torch.randn((B, Hkv, R, p_cols + Tc), generator=gen, device=dev)
    return dict(
        q=torch.randn((B, Hkv, R, D), generator=gen, device=dev),
        k_planes=planes(), v_planes=planes(), kv_out=words.contiguous(),
        k_range=torch.rand((Hkv, D), generator=gen, device=dev) + 0.5,
        k_offset=torch.randn((Hkv, D), generator=gen, device=dev) * 0.1,
        k_lut=torch.sort(torch.rand(K, generator=gen, device=dev) * 2 - 1
                         ).values,
        v_lut=torch.sort(torch.rand(K, generator=gen, device=dev) * 2 - 1
                         ).values,
        probs=torch.softmax(logits * 3, dim=-1)[..., p_cols:],
        v_scale=torch.rand((B, Tc), generator=gen, device=dev) + 0.5,
        v_offset=torch.randn((B, Tc), generator=gen, device=dev) * 0.1,
    )


def run_qk(fn, o, dcfg, mcfg):
    return fn(o["q"], o["k_planes"], o["kv_out"], o["k_range"],
              o["k_offset"], o["k_lut"], dcfg, mcfg)


def run_pv(fn, o, dcfg):
    return fn(o["probs"], o["v_planes"], o["v_scale"], o["v_offset"],
              o["kv_out"], o["v_lut"], dcfg)


def phase_k34_vs_plain(report):
    """K3 and K4 against their plain versions, B=2: bits 2/3/4 x head
    group 1/2/4 x cap 0/2, each at R = G (decode) and R = G*(256+5) (a
    first prefill chunk), with G 1/4, D 32/64/128 and Tc 256/2304 in
    rotation, fp32 and bf16 dots."""
    from kvquant_tpu_torch.cache import DeployConfig
    from kvquant_tpu_torch.models.config import ModelConfig
    from kvquant_tpu_torch.ops.kernels import attention as at

    dev = torch.device("cuda")
    B, Hkv = 2, 4
    cases = []
    i = 0
    for bits in (2, 3, 4):
        for hg in (1, 2, 4):
            for cap in (0, 2):
                g, d, tc = (1, 4)[(i // 3) % 2], (32, 64, 128)[i % 3], \
                    (256, 2304)[(i // 2) % 2]
                cases += [(bits, hg, cap, g, d, tc, r) for r in (g, g * 261)]
                i += 1
    worst = {False: 0.0, True: 0.0}
    t0 = time.perf_counter()
    for dot_bf16 in (False, True):
        for bits, hg, cap, g, d, tc, r in cases:
            dcfg = DeployConfig.create(
                bits=bits, n_kv_heads=Hkv, d_head=d, max_len=tc + 5, sink=5,
                kernel="pallas", dot_bf16=dot_bf16, head_group=hg,
                cap_per_side=cap)
            mcfg = ModelConfig(vocab_size=64, d_model=Hkv * g * d,
                               n_layers=1, n_heads=Hkv * g, n_kv_heads=Hkv,
                               d_head=d, d_ff=64, max_seq_len=tc,
                               rope_scaling=2.0)
            gen = torch.Generator(device=dev).manual_seed(31)
            o = k34_operands(dcfg, B, r, tc, gen, dev)
            tag = f"[10] nuq{bits} hg{hg} cap{cap} G{g} D{d} Tc{tc} R{r}"
            for name, got, want in (
                    ("K3", run_qk(at.qk_fused, o, dcfg, mcfg),
                     run_qk(at.qk_fused_ref, o, dcfg, mcfg)),
                    ("K4", run_pv(at.pv_fused, o, dcfg),
                     run_pv(at.pv_fused_ref, o, dcfg))):
                torch.cuda.synchronize()
                err = float((got - want).abs().max())
                scale = float(want.abs().max())
                bound = BF16_TOL * scale if dot_bf16 else \
                    FP32_TOL * (1 + scale)
                if not (err <= bound and bool(torch.isfinite(got).all())):
                    agree(f"{tag} {name}", got, want, dot_bf16)  # raises
                worst[dot_bf16] = max(worst[dot_bf16], err / bound)
    log(f"[10] K3 and K4 == plain on {len(cases)} cases x 2 dot modes in "
        f"{time.perf_counter() - t0:.1f} s; worst |err| / bound: fp32 dots "
        f"{worst[False]:.3f} (bound 1e-4*(1+max|plain|)), bf16 dots "
        f"{worst[True]:.3f} (bound 1e-2*max|plain|)")
    report["k34_grid_worst_ratio"] = worst
    report["k34_edge_worst_ratio"] = k34_edge_grid()
    k34_wrong_smem_refused()


def k34_wrong_smem_refused():
    """Each body of K3 and K4 (decode, mma, SIMT) refuses a plan whose
    shared-memory count is 16 bytes off its own layout, and the refused
    call counts no launch: the host plan and the kernel's layout cannot
    drift apart unseen."""
    from kvquant_tpu_torch.cache import DeployConfig
    from kvquant_tpu_torch.models.config import ModelConfig
    from kvquant_tpu_torch.ops.kernels import attention as at

    def off(plan_fn):
        return lambda *a: (lambda p: p._replace(smem=p.smem + 16))(
            plan_fn(*a))

    dev = torch.device("cuda")
    plans, n = (at.qk_plan, at.pv_plan), 0
    at.qk_plan, at.pv_plan = off(plans[0]), off(plans[1])
    try:
        for dot_bf16, r in ((True, 1), (True, 261), (False, 261)):
            dcfg = DeployConfig.create(
                bits=3, n_kv_heads=4, d_head=64, max_len=256 + 5, sink=5,
                kernel="pallas", dot_bf16=dot_bf16, head_group=2,
                cap_per_side=2)
            mcfg = ModelConfig(vocab_size=64, d_model=256, n_layers=1,
                               n_heads=4, n_kv_heads=4, d_head=64, d_ff=64,
                               max_seq_len=256)
            o = k34_operands(dcfg, 1, r, 256,
                             torch.Generator(device=dev).manual_seed(5), dev)
            for name, fn, call in (
                    ("K3", at.qk_fused, lambda: run_qk(at.qk_fused, o, dcfg,
                                                       mcfg)),
                    ("K4", at.pv_fused, lambda: run_pv(at.pv_fused, o,
                                                       dcfg))):
                before = fn.launches
                try:
                    call()
                except RuntimeError:
                    n += 1
                else:
                    raise AssertionError(f"[10] {name} R {r} took a plan "
                                         f"with a wrong shared-memory count")
                if fn.launches != before:
                    raise AssertionError(f"[10] {name}: a refused call "
                                         f"counted a launch")
    finally:
        at.qk_plan, at.pv_plan = plans
    log(f"[10] a plan's shared-memory count 16 B off the kernel's layout: "
        f"refused by {n} of 6 bodies (K3 / K4 decode, mma, SIMT)")


def colliding_words(dcfg, B, Tc, gen, dev):
    """Slot words (B, NG, n_slots, Tc) built where a register design goes
    wrong: per (row, group, token) one of four patterns, every slot of the
    token at one head and dim; at a dim and its RoPE partner (d, d + D/2,
    alternating); at dims >= D (nothing to add; D = 128 keeps random dims);
    random heads and dims. A fifth of the values are zero."""
    from kvquant_tpu_torch.ops import packing as pk

    D, hg, n = dcfg.d_head, dcfg.head_group, dcfg.n_slots
    shape = (B, dcfg.n_groups, 1, Tc)

    def rint(lo, hi, shp=shape):
        return torch.randint(lo, hi, shp, generator=gen, device=dev)

    mode, head0, dim0 = rint(0, 4), rint(0, hg), rint(0, D)
    j = torch.arange(n, device=dev)[None, None, :, None]
    full = (B, dcfg.n_groups, n, Tc)
    dims = torch.where(mode == 0, dim0.expand(full),
                       torch.where(mode == 1, (dim0 + (j % 2) * (D // 2)) % D,
                                   torch.where(mode == 2, rint(D, 128, full)
                                               if D < 128 else rint(0, D, full),
                                               rint(0, D, full))))
    heads = torch.where(mode < 2, head0.expand(full), rint(0, hg, full))
    vals = torch.randn(full, generator=gen, device=dev) * 0.5
    vals = vals.masked_fill(torch.rand(full, generator=gen, device=dev) < 0.2,
                            0.0)
    return pk.encode_outlier_words(vals, (heads << 7) | dims).contiguous()


def k34_edge_grid():
    """K3 and K4 against their plain versions at the edges of their
    bodies: R 1/2/4/8 (decode instances) and 261 (mma with bf16 dots, SIMT
    with fp32) x D 32/64/128 x head group 1/2/4 with colliding slot words
    (cap 2, or 4 at head group 2: eight slot rows of a kind) x capacity 128
    / 256 (one or two ring stages, fewer tiles than splits) / 2304 (18
    tiles); B = 2, the second row's probabilities zero past 60% of the
    capacity; fp32 and bf16 dots. Returns the worst |err| / bound per mode."""
    from kvquant_tpu_torch.cache import DeployConfig
    from kvquant_tpu_torch.models.config import ModelConfig
    from kvquant_tpu_torch.ops.kernels import attention as at

    dev = torch.device("cuda")
    B, Hkv = 2, 8
    worst = {False: 0.0, True: 0.0}
    n, t0 = 0, time.perf_counter()
    for dot_bf16 in (False, True):
        for r in (1, 2, 4, 8, 261):
            for d in (32, 64, 128):
                for hg in (1, 2, 4):
                    for tc in (128, 256, 2304):
                        dcfg = DeployConfig.create(
                            bits=(2, 3, 4)[n % 3], n_kv_heads=Hkv, d_head=d,
                            max_len=tc + 5, sink=5, kernel="pallas",
                            dot_bf16=dot_bf16, head_group=hg,
                            cap_per_side=4 if hg == 2 else 2)
                        mcfg = ModelConfig(
                            vocab_size=64, d_model=Hkv * d, n_layers=1,
                            n_heads=Hkv, n_kv_heads=Hkv, d_head=d, d_ff=64,
                            max_seq_len=tc, rope_scaling=2.0)
                        gen = torch.Generator(device=dev).manual_seed(n)
                        o = k34_operands(dcfg, B, r, tc, gen, dev)
                        o["kv_out"] = colliding_words(dcfg, B, tc, gen, dev)
                        o["probs"][1, ..., int(0.6 * tc):] = 0.0
                        tag = (f"[10] edge R{r} D{d} hg{hg} Tc{tc} "
                               f"nuq{dcfg.bits}")
                        for name, got, want in (
                                ("K3", run_qk(at.qk_fused, o, dcfg, mcfg),
                                 run_qk(at.qk_fused_ref, o, dcfg, mcfg)),
                                ("K4", run_pv(at.pv_fused, o, dcfg),
                                 run_pv(at.pv_fused_ref, o, dcfg))):
                            torch.cuda.synchronize()
                            check_case(f"{tag} {name}", got, want, dot_bf16,
                                       worst)
                        n += 1
    log(f"[10] K3 / K4 edge grid == plain on {n // 2} cases x 2 dot modes "
        f"in {time.perf_counter() - t0:.1f} s; worst |err| / bound: fp32 "
        f"dots {worst[False]:.3f}, bf16 dots {worst[True]:.3f}")
    return worst


def k3_gqa_grid(tag):
    """K3 on its tensor-core decode body (qk_gqa, bf16 dots) against the
    plain version at R 3 / 5 / 6 / 7 x D 32 / 64 / 128 x head group 1 / 2 /
    4 with colliding slot words (cap 2, or 4 at head group 2) x capacity
    128 / 256 / 2304, B = 2; the launches counted on qk_gqa. Returns the
    worst |err| / bound."""
    from kvquant_tpu_torch.cache import DeployConfig
    from kvquant_tpu_torch.models.config import ModelConfig
    from kvquant_tpu_torch.ops.kernels import attention as at

    dev = torch.device("cuda")
    B, Hkv = 2, 8
    worst = {False: 0.0, True: 0.0}
    n, t0 = 0, time.perf_counter()
    before = at.qk_fused.gqa_launches
    for r in (3, 5, 6, 7):
        for d in (32, 64, 128):
            for hg in (1, 2, 4):
                for tc in (128, 256, 2304):
                    dcfg = DeployConfig.create(
                        bits=(2, 3, 4)[n % 3], n_kv_heads=Hkv, d_head=d,
                        max_len=tc + 5, sink=5, kernel="pallas",
                        head_group=hg, cap_per_side=4 if hg == 2 else 2)
                    mcfg = ModelConfig(
                        vocab_size=64, d_model=Hkv * d, n_layers=1,
                        n_heads=Hkv * r, n_kv_heads=Hkv, d_head=d, d_ff=64,
                        max_seq_len=tc, rope_scaling=2.0)
                    gen = torch.Generator(device=dev).manual_seed(900 + n)
                    o = k34_operands(dcfg, B, r, tc, gen, dev)
                    o["kv_out"] = colliding_words(dcfg, B, tc, gen, dev)
                    got = run_qk(at.qk_fused, o, dcfg, mcfg)
                    torch.cuda.synchronize()
                    check_case(f"{tag} K3 qk_gqa R{r} D{d} hg{hg} Tc{tc} "
                               f"nuq{dcfg.bits}", got,
                               run_qk(at.qk_fused_ref, o, dcfg, mcfg), True,
                               worst)
                    n += 1
    launched = at.qk_fused.gqa_launches - before
    log(f"{tag} K3 qk_gqa grid == plain on {n} cases (bf16 dots, "
        f"{launched} launches on qk_gqa) in {time.perf_counter() - t0:.1f} "
        f"s; worst |err| / bound {worst[True]:.3f}")
    if launched != n:
        raise AssertionError("K3 at R 3-8 with bf16 dots did not run qk_gqa")
    return worst[True]


def live_k34_check(tag, cache, dq, dcfg, cfg, li_list, gen, rs=(1, 261)):
    """K3 and K4 against plain on layers of a live cache: random queries
    and probabilities at R rows of ``rs``, the main path's bf16 dots and
    fp32 dots. Returns the worst |err| of each kernel."""
    from kvquant_tpu_torch.ops.kernels import attention as at

    Hkv, D, Tc = cfg.n_kv_heads, cfg.d_head, dcfg.cache_tokens
    worst = {"qk_fused": 0.0, "pv_fused": 0.0}
    for r in rs:
        q = torch.randn((1, Hkv, r, D), generator=gen, device="cuda")
        probs = torch.softmax(3 * torch.randn(
            (1, Hkv, r, dcfg.sink + Tc), generator=gen, device="cuda"),
            dim=-1)[..., dcfg.sink:]
        for li in li_list:
            lc, lq = cache.layer(li), dq.layer(li)
            for d in (dcfg, dataclasses.replace(dcfg, dot_bf16=False)):
                qk = [fn(q, lc.k_planes, lc.kv_out, lq.k_range, lq.k_offset,
                         lq.k_lut_dec, d, cfg)
                      for fn in (at.qk_fused, at.qk_fused_ref)]
                pv = [fn(probs, lc.v_planes, lc.v_scale, lc.v_offset,
                         lc.kv_out, lq.v_lut_dec, d)
                      for fn in (at.pv_fused, at.pv_fused_ref)]
                for name, (got, want) in (("qk_fused", qk), ("pv_fused", pv)):
                    worst[name] = max(worst[name], agree(
                        f"{tag} {name} layer {li} R {r}", got, want,
                        d.dot_bf16))
    return worst


def phase_pallas_main_path(report):
    """The CLIs' default datapath (kernel="pallas": K3 + K4) through the
    user's entry point: cli.generate at LLaMA-2-7B width (the CLI's own
    random init, d_ff = 3 * d_model) with quantized prefill of a 2048-word
    prompt and 64 greedy tokens; then engine-level timings at LLAMA2_7B
    with the faithful scheme (the fp16-KV baseline on the same weights is
    phase 31's), and short card runs of cli.passkey and cli.needle at toy
    width."""
    import os
    import shutil

    from kvquant_tpu_torch import engine
    from kvquant_tpu_torch.cache import create_cache, deployed_from_quantizers
    from kvquant_tpu_torch.cli import generate as generate_cli
    from kvquant_tpu_torch.cli import needle as needle_cli
    from kvquant_tpu_torch.cli import passkey as passkey_cli
    from kvquant_tpu_torch.models import init_params
    from kvquant_tpu_torch.ops.kernels import attention as at
    from kvquant_tpu_torch.ops.kernels import flash_decode as fd
    from kvquant_tpu_torch.quant.artifacts import save_quantizers

    root = os.path.dirname(os.path.abspath(__file__))
    # scratch files of this phase, in the checkout's ignored build directory
    work = os.path.join(root, "kvquant_tpu_torch", "_build", "smoke_work")
    os.makedirs(work, exist_ok=True)
    T0, N, chunk = 2048, 64, 256
    _, _, qs = faithful_config(T0 + N + 5, 32)
    qpath = os.path.join(work, "faithful_nuq3_quantizers.npz")
    save_quantizers(qpath, qs)

    # ---- the CLI run: the main path's launches are counted here ----
    prompt = " ".join(f"w{i % 1500}" for i in range(T0))
    argv = ["--toy-layers", "32", "--toy-dmodel", "4096", "--toy-heads",
            "32", "--toy-vocab", "32000", "--quantizers", qpath,
            "--kernel", "pallas", "--prefill-mode", "quantized",
            "--prompt", prompt, "--max-new-tokens", str(N),
            "--device", "cuda"]
    n_chunks = -(-(T0 - 5) // chunk)
    at.qk_fused.launches = at.pv_fused.launches = 0
    fd.flash_attention.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    text = generate_cli.main(argv)
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    k3, k4 = at.qk_fused.launches, at.pv_fused.launches
    want = 32 * (n_chunks + N)
    report["k3_launches"], report["k4_launches"] = k3, k4
    log(f"[11] cli.generate --kernel pallas --prefill-mode quantized at "
        f"LLaMA-2-7B width: {T0}-word prompt ({n_chunks} chunks), {N} new "
        f"tokens in {cli_s:.3f} s (model init included); launches K3 {k3}, "
        f"K4 {k4} (expected {want} each), K1 "
        f"{fd.flash_attention.launches}; printed {len(text.split())} words")
    if not (k3 == k4 == want and fd.flash_attention.launches == 0):
        raise AssertionError("the CLI's main path did not run K3 and K4 per "
                             "layer, chunk and step")
    if len(text.split()) != N:
        raise AssertionError(f"cli.generate printed {text!r}")
    torch.cuda.empty_cache()

    # ---- engine-level timings at LLAMA2_7B, faithful scheme, pallas ----
    cfg, dcfg, qs = faithful_config(T0 + N + 5, 32)
    dcfg = dataclasses.replace(dcfg, kernel="pallas")
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         dtype=torch.bfloat16, device="cuda")
    dq = deployed_from_quantizers(qs, cfg.n_kv_heads, cfg.d_head,
                                  device="cuda")
    toks = torch.randint(0, cfg.vocab_size, (1, T0),
                         generator=torch.Generator().manual_seed(1)).cuda()
    cache = create_cache(dcfg, cfg.n_layers, 1, device="cuda")
    engine.prefill_quantized(params, cfg, dcfg, dq, cache, toks, chunk=chunk)
    cache = create_cache(dcfg, cfg.n_layers, 1, device="cuda")  # warm: timed
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, logits = engine.prefill_quantized(params, cfg, dcfg, dq, cache, toks,
                                         chunk=chunk)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("non-finite logits after quantized prefill")
    log(f"[11] LLaMA-2-7B width, faithful nuq3 hg 4 cap 2, kernel pallas: "
        f"quantized prefill of {T0} tokens ({n_chunks} chunks of {chunk}) "
        f"{prefill_s:.3f} s")
    tok = torch.zeros((1,), dtype=torch.int32, device="cuda")
    tps2, idle2 = decode_profile(
        f"[11] pallas {T0} ctx", lambda i: engine.decode_step(
            params, cfg, dcfg, dq, cache, tok, T0 + i), 16)
    gen = torch.Generator(device="cuda").manual_seed(2)
    report["k34_max_abs_err"] = live_k34_check(
        "[11] live cache", cache, dq, dcfg, cfg, (0, cfg.n_layers - 1), gen)
    del cache
    torch.cuda.empty_cache()

    ctx = 32768
    _, dcfg32, qs32 = faithful_config(ctx + 32, 32)
    dcfg32 = dataclasses.replace(dcfg32, kernel="pallas")
    dq32 = deployed_from_quantizers(qs32, cfg.n_kv_heads, cfg.d_head,
                                    device="cuda")
    cache = filled_cache(dcfg32, cfg.n_layers, ctx, 3)
    tps32, idle32 = decode_profile(
        f"[11] pallas {ctx} ctx", lambda i: engine.decode_step(
            params, cfg, dcfg32, dq32, cache, tok, ctx + i), 16)
    report.update(k34_prefill_s_2k=prefill_s, k34_decode_tps_2k=tps2,
                  k34_idle_2k=idle2, k34_decode_tps_32k=tps32,
                  k34_idle_32k=idle32)
    del cache
    torch.cuda.empty_cache()

    # the fp16-KV baseline on the same weights: phase 31, graphed and eager
    del params
    torch.cuda.empty_cache()

    # ---- the other CLIs at toy width on the card ----
    toy = ["--toy-layers", "4", "--toy-dmodel", "256", "--toy-heads", "8",
           "--toy-kv-heads", "4", "--toy-vocab", "512", "--device", "cuda",
           "--quantizers", os.path.join(root, "artifacts",
                                        "toy_quantizers_3bit.npz")]
    at.qk_fused.launches = 0
    res = passkey_cli.main(toy + ["--ctx", "512", "--trials", "2"])
    grid = needle_cli.main(toy + ["--ctx", "512", "--depths", "0,100",
                                  "--results",
                                  os.path.join(work, "needle.json")])
    log(f"[11] cli.passkey ctx 512 x 2 trials: accuracy "
        f"{res[0].accuracy:.2f}; cli.needle ctx 512 depths 0/100: "
        f"{sorted(grid.values())}; K3 launches {at.qk_fused.launches} "
        f"(random weights: accuracy is not the point)")
    if at.qk_fused.launches == 0 or len(grid) != 2:
        raise AssertionError("passkey / needle did not run through K3")
    shutil.rmtree(work)


def phase_pallas_card_vs_cpu(report):
    """The toy checkpoint through K3 / K4: card == CPU, both prefills."""
    toy_card_vs_cpu("[12]", "pallas")


def phase_k34_times(report):
    """K3 and K4 alone at one LLaMA-2-7B layer (B=1, Hkv=32, G=1, D=128,
    nuq3, hg 4, cap 2): decode rows (R=1) over 32K and 128K capacities and
    a 261-row prefill chunk over a 2K capacity."""
    from kvquant_tpu_torch.ops.kernels import attention as at
    from kvquant_tpu_torch.ops.kernels.common import sm_count

    dev = torch.device("cuda")
    rows = []
    for kind, ctx, r in (("decode", 32768, 1), ("decode", 131072, 1),
                         ("prefill", 2048, 261)):
        cfg, dcfg, _ = faithful_config(ctx + 8, 1)
        dcfg = dataclasses.replace(dcfg, kernel="pallas")
        Hkv, D, Tc = cfg.n_kv_heads, cfg.d_head, dcfg.cache_tokens
        o = k34_operands(dcfg, 1, r, Tc, torch.Generator(device=dev)
                         .manual_seed(7), dev)
        d32 = dataclasses.replace(dcfg, dot_bf16=False)
        qk = lambda fn, d=dcfg: run_qk(fn, o, d, cfg)
        pv = lambda fn, d=dcfg: run_pv(fn, o, d)
        code_b = Hkv * D * dcfg.bits // 8  # one kind's codes per token
        J, spk = dcfg.n_slots, dcfg.slots_per_kind
        flops = 2 * r * Tc * D * Hkv  # the contraction of either kernel
        for name, fn, ref, nbytes in (
                ("qk_fused", at.qk_fused, at.qk_fused_ref,
                 Tc * (code_b + dcfg.n_groups * spk * 4 + Hkv * r * 4)
                 + 4 * Hkv * D * (r + 2) + 4 * 2 ** dcfg.bits),
                ("pv_fused", at.pv_fused, at.pv_fused_ref,
                 Tc * (code_b + dcfg.n_groups * (J - spk) * 4 + 8
                       + Hkv * r * 4) + 4 * Hkv * D * r
                 + 4 * 2 ** dcfg.bits)):
            call = qk if name == "qk_fused" else pv
            err = max(agree(f"[13] {name} {kind} Tc {Tc}", call(fn),
                            call(ref), True),
                      agree(f"[13] {name} {kind} Tc {Tc}", call(fn, d32),
                            call(ref, d32), False))
            ms = device_ms(lambda: call(fn))
            plain_ms = device_ms(lambda: call(ref), n=2, reps=3, warmup=1)
            ms2 = device_ms(lambda: call(fn))
            call_ms = median_ms(lambda: call(fn))
            b_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            b_ops = flops / BF16_FLOPS * 1e3
            plan = (at.qk_plan if name == "qk_fused" else at.pv_plan)(
                dcfg, r, D, Tc, 1, Hkv, J, sm_count(dev))
            key = ("K3" if name == "qk_fused" else "K4", "nuq3", kind, Tc)
            row = dict(name=name, kind=kind, ctx=ctx, Tc=Tc, R=r,
                       plan=plan._asdict(),
                       ms=min(ms, ms2), ms_runs=[ms, ms2], call_ms=call_ms,
                       plain_ms=plain_ms, bound_ms=max(b_bytes, b_ops),
                       bound_by="bytes" if b_bytes >= b_ops else "operations",
                       bytes=nbytes, flops=flops, max_abs_err=err)
            rows.append(row)
            log(f"[13] {name} {kind} R {r} Tc {Tc}: kernel {row['ms']:.4f} "
                f"ms device (runs {ms:.4f}, {ms2:.4f}; {call_ms:.4f} ms per "
                f"call with the wrapper's host time), plain {plain_ms:.3f} "
                f"ms, bound {row['bound_ms']:.4f} ms by {row['bound_by']} "
                f"({nbytes / 1e6:.1f} MB at 3.35 TB/s = {b_bytes:.4f} ms; "
                f"{flops / 1e9:.2f} GFLOP at 989 TFLOP/s = {b_ops:.4f} ms), "
                f"|err| {err:.2e}{vs_before(key, row['ms'])}")
            if plan.body == "decode" and name == "qk_fused":
                log(f"[13] {name} plan {plan.body}: {plan.hc} kv heads a block, "
                    f"{plan.stages} stages, {plan.n_split} splits, "
                    f"{plan.smem} B shared; the (cos, sin) table "
                    f"({Tc * D * 4 / 1e6:.1f} MB) is read by "
                    f"{Hkv // plan.hc} head blocks per call")
            else:
                log(f"[13] {name} plan {plan.body}: {plan.rows} rows x "
                    f"{plan.n_rt} row blocks, {plan.hc} kv heads, "
                    f"{plan.n_split} splits, {plan.smem} B shared")
        # context only, never called by the port: a bf16 matmul of the
        # queries against a dense K of the same length
        kb = torch.randn((1, Hkv, Tc, D), device=dev, dtype=torch.bfloat16)
        qb = o["q"].to(torch.bfloat16)
        mm_ms = device_ms(lambda: torch.matmul(qb, kb.transpose(-1, -2)))
        rows[-1]["matmul_bf16_dense_k_ms_context_only"] = mm_ms
        rows[-2]["matmul_bf16_dense_k_ms_context_only"] = mm_ms
        log(f"[13] context only: bf16 torch.matmul of the {r} query rows "
            f"against a dense bf16 K of {Tc} tokens {mm_ms:.4f} ms")
        del kb, o
        torch.cuda.empty_cache()
    report["k34_times"] = rows


# ---------------------------------------------------------------------------
# K5: paged_flash_decode (fd_paged_attention in csrc/flash_decode.cu)
# ---------------------------------------------------------------------------


def paged_case(dcfg, L, P, gen, dev, n_pages=8):
    """A random pool (k1_operands' arrays with the page axis for the batch
    axis), 4 slots (slot 3 inactive, its row aliasing slot 2's pages)
    and their positions; trailing table entries hold other slots' pages."""
    from kvquant_tpu_torch.paged import PagedPool

    S = dcfg.sink
    ops = k1_operands(dcfg, L, n_pages, P, gen, dev)
    sinks = k1_operands(dcfg, L, 4, 128, gen, dev)
    pool = PagedPool(k_planes=ops["k_planes"], v_planes=ops["v_planes"],
                     kv_out=ops["kv_out"], v_scale=ops["v_scale"],
                     v_offset=ops["v_offset"], k_sink=sinks["k_sink"],
                     v_sink=sinks["v_sink"])
    table = torch.tensor([[5, 1, 4], [2, 7, 0], [6, 0, 3], [6, 0, 3]],
                         dtype=torch.int32, device=dev)
    pos = torch.tensor([S + 10, S + P + 3, S + 3 * P - 30, S + P + 100],
                       dtype=torch.int32, device=dev)
    return pool, ops, table, pos


def paged_dq(ops):
    from kvquant_tpu_torch.cache import DeployedQuant

    L, Hkv, D = ops["k_range"].shape
    z = torch.zeros((L, Hkv * D), device=ops["k_range"].device)
    return DeployedQuant(k_range=ops["k_range"], k_offset=ops["k_offset"],
                         k_lower=z, k_upper=z, k_lut_enc=ops["k_lut"],
                         k_lut_dec=ops["k_lut"], v_lut_enc=ops["v_lut"],
                         v_lut_dec=ops["v_lut"], k_ressc=ops["k_ressc"])


def k1_on_pages(q, pool, table, dq, li, pos, dcfg, mcfg, fn):
    """K1 (``fn``: the kernel or its plain version) over the slots' live
    pages gathered into a contiguous (1, B, ...) layer."""
    from kvquant_tpu_torch.ops.kernels import paged_decode as pdk

    g = pdk.gather_layer(pool, pdk.live_pages(table, pos, dcfg), li, dcfg)
    one = lambda t: t[li][None].contiguous()  # noqa: E731
    return fn(q, g["k_planes"][None], g["v_planes"][None], g["kv_out"][None],
              one(dq.k_range), one(dq.k_offset), g["v_scale"][None],
              g["v_offset"][None], one(pool.k_sink), one(pool.v_sink),
              one(dq.k_lut_dec), one(dq.v_lut_dec), 0, pos, dcfg, mcfg,
              k_ressc=one(dq.k_ressc))


def phase_k5_vs_plain(report):
    """K5 against its plain version and against K1 on the same tokens."""
    from kvquant_tpu_torch.ops.kernels import flash_decode as fd
    from kvquant_tpu_torch.ops.kernels import paged_decode as pdk

    dev = torch.device("cuda")
    L, Hkv, G, D = 2, 4, 2, 128
    cases = []
    for codes, bits in (("nuq", 2), ("nuq", 3), ("nuq", 4), ("int4", 4),
                        ("int8", 8)):
        for post in (False, True):
            for k_out, hg in (("slots", 4), ("channels", 2)):
                for sink in (0, 5):
                    for P in (256, 1024):
                        cases.append((codes, bits, post, k_out, hg, sink, P))
    worst = {False: 0.0, True: 0.0}
    k1_diff = 0.0
    t0 = time.perf_counter()
    for dot_bf16 in (False, True):
        for codes, bits, post, k_out, hg, sink, P in cases:
            dcfg, mcfg = k1_config(codes, bits, Hkv, D, G, 3 * P, sink, post,
                                   k_out, hg, None, dot_bf16, L=L)
            dcfg = dataclasses.replace(dcfg, page_tokens=P)
            gen = torch.Generator(device=dev).manual_seed(41)
            pool, ops, table, pos = paged_case(dcfg, L, P, gen, dev)
            dq = paged_dq(ops)
            q = torch.randn((4, Hkv, G, D), generator=gen, device=dev)
            got = pdk.paged_flash_decode(q, pool, table, dq, 1, pos, dcfg,
                                         mcfg)
            torch.cuda.synchronize()
            want = pdk.paged_flash_decode_ref(q, pool, table, dq, 1, pos,
                                              dcfg, mcfg)
            tag = (f"[14] {codes}{bits} {'post' if post else 'pre'} {k_out} "
                   f"hg{hg} sink{sink} P{P}")
            check_case(tag, got, want, dot_bf16, worst)
            # JAX's ground truth: the paged kernel equals the contiguous one
            k1 = k1_on_pages(q, pool, table, dq, 1, pos, dcfg, mcfg,
                             fd.flash_attention)
            diff = float((got - k1).abs().max())
            if not diff <= FP32_TOL * (1 + float(want.abs().max())):
                raise AssertionError(f"{tag}: K5 != K1 on the same tokens "
                                     f"({diff:.3e})")
            k1_diff = max(k1_diff, diff)
    log(f"[14] K5 == plain on {len(cases)} cases x 2 dot modes in "
        f"{time.perf_counter() - t0:.1f} s; worst |err| / bound: fp32 dots "
        f"{worst[False]:.3f} (bound 1e-4*(1+max|plain|)), bf16 dots "
        f"{worst[True]:.3f} (bound 1e-2*max|plain|); max |K5 - K1 on the "
        f"same tokens| {k1_diff:.3e}")
    report["k5_grid_worst_ratio"] = worst
    report["k5_vs_k1_max_diff"] = k1_diff
    report["k5_decode_edges"] = decode_edge_grid(
        "[14]", (("nuq", 2), ("nuq", 3), ("nuq", 4), ("int4", 4),
                 ("int8", 8)), paged=True)


def demo_prompts(n, prompt_len, max_new, vocab, seed=0):
    """The requests cli.serve_demo draws (its numpy draws from ``seed``)."""
    from kvquant_tpu_torch.serve import Request

    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        prompt = rng.integers(0, vocab, size=int(
            prompt_len * rng.uniform(0.5, 1.0))).astype(np.int32)
        out.append(Request(rid=i, prompt=prompt, max_new_tokens=int(
            max_new * rng.uniform(0.5, 1.0))))
    return out


def demo_requests(n, prompt_len, max_new, vocab, seed=0):
    """The (prompt length, budget) pairs cli.serve_demo draws."""
    return [(len(r.prompt), r.max_new_tokens)
            for r in demo_prompts(n, prompt_len, max_new, vocab, seed)]


def reset_launches():
    from kvquant_tpu_torch.ops.kernels import attention as at
    from kvquant_tpu_torch.ops.kernels import flash_decode as fd
    from kvquant_tpu_torch.ops.kernels import flash_serial as fs
    from kvquant_tpu_torch.ops.kernels import moe_experts as mx
    from kvquant_tpu_torch.ops.kernels import paged_decode as pdk

    counters = {"K1": fd.flash_attention, "K2": fs.flash_serial_decode,
                "K3": at.qk_fused, "K4": at.pv_fused,
                "K5": pdk.paged_flash_decode, "moe_experts": mx.moe_experts}
    for fn in counters.values():
        fn.launches = 0
    fd.flash_attention.chunk_launches = 0
    for fn in (fd.flash_attention, at.qk_fused, pdk.paged_flash_decode):
        fn.gqa_launches = 0
    fs.flash_serial_decode.route_launches = {b: 0 for b in fs.BODIES}
    return lambda: dict({k: fn.launches for k, fn in counters.items()},
                        K1_chunk=fd.flash_attention.chunk_launches,
                        K1_gqa=fd.flash_attention.gqa_launches,
                        K3_gqa=at.qk_fused.gqa_launches,
                        K5_gqa=pdk.paged_flash_decode.gqa_launches)


def phase_paged_main_path(report):
    """The serving main path through cli.serve_demo --paged at LLaMA-2-7B
    width, then the slot pool at toy width."""
    import os
    import shutil

    from kvquant_tpu_torch import paged
    from kvquant_tpu_torch.cli import serve_demo
    from kvquant_tpu_torch.quant.artifacts import save_quantizers

    root = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(root, "kvquant_tpu_torch", "_build", "smoke_work")
    os.makedirs(work, exist_ok=True)
    n_req, T, N, P, slots, chunk = 8, 2048, 64, 1024, 4, 256
    _, _, qs = faithful_config(T + N + 5, 32)
    qpath = os.path.join(work, "faithful_nuq3_quantizers.npz")
    save_quantizers(qpath, qs)

    servers = []
    run = paged.PagedServer.run

    def recording_run(self, requests, max_steps=10_000):
        servers.append(self)
        self.admit_s = 0.0
        admit = self._admit

        def timed_admit():  # the admission's share of the wall time
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            admit()
            torch.cuda.synchronize()
            self.admit_s += time.perf_counter() - t0

        self._admit = timed_admit
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run(self, requests, max_steps)
        torch.cuda.synchronize()
        self.run_s = time.perf_counter() - t0
        return out

    argv = ["--toy-layers", "32", "--toy-dmodel", "4096", "--toy-heads",
            "32", "--toy-vocab", "32000", "--quantizers", qpath,
            "--slots", str(slots), "--requests", str(n_req), "--prompt-len",
            str(T), "--max-new-tokens", str(N), "--page-tokens", str(P),
            "--paged", "--device", "cuda"]
    want = demo_requests(n_req, T, N, 32000)
    read = reset_launches()
    paged.PagedServer.run = recording_run
    try:
        t0 = time.perf_counter()
        comps = serve_demo.main(argv)
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
    finally:
        paged.PagedServer.run = run
    n = read()
    srv = servers[0]
    chunks = sum(-(-(t0_ - 5) // chunk) for t0_, _ in want)
    tokens = sum(len(c.tokens) for c in comps.values())
    pool_b = sum(getattr(srv.pool, f.name).numel()
                 * getattr(srv.pool, f.name).element_size()
                 for f in dataclasses.fields(paged.PagedPool))
    log(f"[15] cli.serve_demo --paged at LLaMA-2-7B width: {n_req} requests "
        f"(prompts {min(w[0] for w in want)}-{max(w[0] for w in want)}, "
        f"budgets {min(w[1] for w in want)}-{max(w[1] for w in want)}), "
        f"{slots} slots, pool {len(srv.free)} pages x {P} tokens = "
        f"{pool_b / 2 ** 20:.1f} MiB; {tokens} tokens in {srv.run_s:.3f} s "
        f"of serving = {tokens / srv.run_s:.2f} tok/s aggregate "
        f"({cli_s:.3f} s with model init); launches {n} (K1 expected 32 x "
        f"{chunks} admission chunks); chunked admission {srv.admit_s:.3f} s "
        f"({srv.admit_s / srv.run_s:.3f} of the serving wall) through "
        f"{sum(len(h.graphs) for h in srv._adm_caches.values())} chunk "
        f"graphs")
    budgets_ok = [len(comps[i].tokens) for i in range(n_req)] == \
        [w[1] for w in want]
    if not (budgets_ok and sorted(srv.free) == list(range(len(srv.free)))
            and len(srv.free) == srv.pool.k_planes.shape[1]):
        raise AssertionError("a budget was not served or a page not returned")
    if not (n["K5"] > 0 and n["K5"] % 32 == 0
            and n["K5"] >= 32 * max(w[1] for w in want)
            and n["K1"] == 32 * chunks
            and n["K2"] == n["K3"] == n["K4"] == 0):
        raise AssertionError(f"serving main path launches {n}")
    if not all(len(h.graphs) == 2 for h in srv._adm_caches.values()):
        raise AssertionError("the admission chunks did not run as graphs")
    report["k5_launches"] = n["K5"]
    report["serve_tps"] = tokens / srv.run_s
    report["serve_admit_share"] = srv.admit_s / srv.run_s
    report["serve_pool_mib"] = pool_b / 2 ** 20

    # steady state: 4 active slots over the pool's pages, at a third to
    # two thirds of their capacity
    table = np.arange(slots * srv.MP, dtype=np.int32).reshape(slots, srv.MP)
    act = np.ones(slots, bool)
    pos0 = (5 + srv.MP * P * np.linspace(0.35, 0.65, slots)).astype(np.int32)
    tok = torch.zeros((slots,), dtype=torch.int32, device="cuda")
    steps_s, idle = decode_profile(
        f"[15] paged {slots} slots", lambda i: paged.paged_decode_step(
            srv.params, srv.cfg, srv.dcfg, srv.dq, srv.pool, table, tok,
            pos0 + i, act), 8)
    log(f"[15] paged decode step, {slots} active slots at {pos0.min()}-"
        f"{pos0.max()}: "
        f"{1e3 / steps_s:.3f} ms/step, {slots * steps_s:.2f} tok/s "
        f"aggregate (the 'tok/s' above counts steps)")
    report["serve_step_ms"] = 1e3 / steps_s
    report["serve_idle"] = idle
    del srv, servers, comps
    torch.cuda.empty_cache()

    # the slot pool (serve.Server, kernel flash) at toy width
    toy = ["--toy-layers", "4", "--toy-dmodel", "256", "--toy-heads", "8",
           "--toy-kv-heads", "4", "--toy-vocab", "512", "--device", "cuda",
           "--quantizers", os.path.join(root, "artifacts",
                                        "toy_quantizers_3bit.npz"),
           "--slots", "2", "--requests", "4", "--prompt-len", "300",
           "--max-new-tokens", "16"]
    read = reset_launches()
    comps = serve_demo.main(toy)
    n = read()
    want = demo_requests(4, 300, 16, 512)
    log(f"[15] cli.serve_demo (slot pool, kernel flash) at toy width: "
        f"{[len(comps[i].tokens) for i in range(4)]} tokens, launches {n}")
    if not ([len(comps[i].tokens) for i in range(4)] == [w[1] for w in want]
            and n["K1"] > 0 and n["K5"] == 0):
        raise AssertionError("slot-pool serve_demo did not run through K1")
    shutil.rmtree(work)


def phase_paged_card_vs_cpu(report):
    """PagedServer on the toy checkpoint: card == CPU, and == the port's
    isolated quantized-prefill generate through K1 on the card (the same
    256-token capacity on both: the token splits sum in the same order)."""
    import os

    from kvquant_tpu_torch import engine
    from kvquant_tpu_torch.cache import DeployConfig, deployed_from_quantizers
    from kvquant_tpu_torch.models import params_from_numpy
    from kvquant_tpu_torch.paged import PagedServer
    from kvquant_tpu_torch.quant.artifacts import load_quantizers
    from kvquant_tpu_torch.serve import Request
    from kvquant_tpu_torch.utils.toymodel import TOY_CFG as cfg
    from kvquant_tpu_torch.utils.toymodel import load_toy_checkpoint

    art = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "artifacts")
    tree, _, _ = load_toy_checkpoint(os.path.join(art, "toy_model.npz"))
    qs = load_quantizers(os.path.join(art, "toy_quantizers_3bit.npz"))
    P = 256
    dcfg = dataclasses.replace(DeployConfig.create(
        bits=3, n_kv_heads=cfg.n_kv_heads, d_head=cfg.d_head,
        max_len=P + 5, sink=5, kernel="flash", head_group=4, codes="nuq",
        post_rope_k=False, k_outliers="slots", cap_per_side=2,
        dot_bf16=False), page_tokens=P)
    rng = np.random.default_rng(16)
    reqs = [(rng.integers(0, cfg.vocab_size, n).astype(np.int32), m)
            for n, m in ((16, 12), (40, 9), (25, 16), (33, 7))]
    out = {}
    for dev in ("cuda", "cpu"):
        params = params_from_numpy(tree, cfg, device=dev)
        dq = deployed_from_quantizers(qs, cfg.n_kv_heads, cfg.d_head,
                                      device=dev)
        srv = PagedServer(params, cfg, dcfg, dq, n_pages=2, n_slots=2,
                          max_pages_per_slot=1, admit_mode="chunked",
                          burst=8, device=dev)
        comps = srv.run([Request(rid=i, prompt=p, max_new_tokens=m)
                         for i, (p, m) in enumerate(reqs)])
        out[dev] = [comps[i].tokens for i in range(len(reqs))]
        if sorted(srv.free) != [0, 1]:
            raise AssertionError(f"{dev}: pages not returned")
        if dev == "cuda":
            iso = []
            for p, m in reqs:
                t, _ = engine.generate(
                    params, cfg, dcfg, dq, torch.as_tensor(p)[None],
                    engine.GenerateConfig(max_new_tokens=m),
                    prefill_mode="quantized", device="cuda")
                iso.append(t[0].tolist())
    same, same_iso = out["cuda"] == out["cpu"], out["cuda"] == iso
    log(f"[16] toy checkpoint through PagedServer (P {P}, 2 slots, 4 "
        f"requests, chunked admission, bursts of 8): card == cpu: {same}; "
        f"card == isolated generate (K1) on the card: {same_iso}")
    if not (same and same_iso):
        raise AssertionError(f"card {out['cuda']} cpu {out['cpu']} "
                             f"isolated {iso}")


def phase_k5_times(report):
    """K5 alone at one LLaMA-2-7B layer (faithful nuq3, bf16 dots): B=1 at
    32K over 32 permuted pages of 1024, B=4 at 8K each; K1 over the same
    tokens laid out contiguously as context."""
    from kvquant_tpu_torch.ops.kernels import flash_decode as fd
    from kvquant_tpu_torch.ops.kernels import paged_decode as pdk
    from kvquant_tpu_torch.paged import PagedPool

    dev = torch.device("cuda")
    P, rows = 1024, []
    for B, ctx in ((1, 32768), (4, 8192)):
        cfg, dcfg, _ = faithful_config(ctx + 8, 1)
        dcfg = dataclasses.replace(dcfg, page_tokens=P)
        Hkv, D, S = cfg.n_kv_heads, cfg.d_head, dcfg.sink
        MP = ctx // P
        gen = torch.Generator(device=dev).manual_seed(17)
        ops = k1_operands(dcfg, 1, B * MP, P, gen, dev)
        sinks = k1_operands(dcfg, 1, B, 128, gen, dev)
        pool = PagedPool(k_planes=ops["k_planes"], v_planes=ops["v_planes"],
                         kv_out=ops["kv_out"], v_scale=ops["v_scale"],
                         v_offset=ops["v_offset"], k_sink=sinks["k_sink"],
                         v_sink=sinks["v_sink"])
        dq = paged_dq(ops)
        table = torch.randperm(B * MP, generator=torch.Generator()
                               .manual_seed(18)).to(torch.int32).reshape(
            B, MP).to(dev)
        pos = torch.full((B,), ctx - 1, dtype=torch.int32, device=dev)
        q = torch.randn((B, Hkv, 1, D), generator=gen, device=dev)

        def run(fn, d=dcfg):
            return fn(q, pool, table, dq, 0, pos, d, cfg)

        d32 = dataclasses.replace(dcfg, dot_bf16=False)
        err = max(agree(f"[17] K5 B {B} ctx {ctx}",
                        run(pdk.paged_flash_decode),
                        run(pdk.paged_flash_decode_ref), True),
                  agree(f"[17] K5 B {B} ctx {ctx}",
                        run(pdk.paged_flash_decode, d32),
                        run(pdk.paged_flash_decode_ref, d32), False))
        kern = lambda: run(pdk.paged_flash_decode)  # noqa: E731
        ms = device_ms(kern)
        plain_ms = device_ms(lambda: run(pdk.paged_flash_decode_ref), n=2,
                             reps=3, warmup=1)
        ms2 = device_ms(kern)
        call_ms = median_ms(kern)
        # K1 over the same tokens, gathered contiguously once (context)
        g = pdk.gather_layer(pool, pdk.live_pages(table, pos, dcfg), 0, dcfg)
        one = lambda t: t[0][None].contiguous()  # noqa: E731
        k1_args = (q, g["k_planes"][None], g["v_planes"][None],
                   g["kv_out"][None], one(dq.k_range), one(dq.k_offset),
                   g["v_scale"][None], g["v_offset"][None],
                   one(pool.k_sink), one(pool.v_sink), one(dq.k_lut_dec),
                   one(dq.v_lut_dec), 0, pos, dcfg, cfg)
        k1_ms = device_ms(lambda: fd.flash_attention(*k1_args))
        n_live = B * (ctx - 1 - S + 1)
        nbytes = (n_live * nuq_bytes_per_token(dcfg)
                  + 4 * Hkv * D * (2 * S + 2) * B + 4 * B * MP)
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        row = dict(B=B, ctx=ctx, pages=B * MP, ms=min(ms, ms2),
                   ms_runs=[ms, ms2], call_ms=call_ms, plain_ms=plain_ms,
                   bound_ms=bound_ms, bytes=nbytes, k1_same_tokens_ms=k1_ms,
                   max_abs_err=err)
        log(f"[17] K5 B {B} ctx {ctx} ({B * MP} permuted pages of {P}): "
            f"kernel {row['ms']:.4f} ms device (runs {ms:.4f}, {ms2:.4f}; "
            f"{call_ms:.4f} ms per call with the wrapper's host time), plain "
            f"{plain_ms:.3f} ms, bound {bound_ms:.4f} ms by bytes "
            f"({nbytes / 1e6:.1f} MB at 3.35 TB/s), |err| {err:.2e}; "
            f"context: K1 on the same tokens contiguous {k1_ms:.4f} ms"
            f"{vs_before(('K5', 'nuq3', B, ctx), row['ms'])}")
        rows.append(row)
        del ops, pool, g, k1_args
        torch.cuda.empty_cache()
    report["k5_times"] = rows


# ---------------------------------------------------------------------------
# int4x2 (the head-paired 2-bit container) through K1 and K5
# ---------------------------------------------------------------------------


def phase_x2_vs_plain(report):
    """K1 and K5 on int4x2 against their plain versions, and K5 against K1
    on the same tokens."""
    from kvquant_tpu_torch.ops.kernels import flash_decode as fd
    from kvquant_tpu_torch.ops.kernels import paged_decode as pdk

    dev = torch.device("cuda")
    L, B, Tc = 2, 2, 1024
    outl = (("channels", 2), ("channels", 4), ("slots", 2), ("slots", 4),
            ("none", 2), ("none", 4))
    # (post, k_out, hg, sink, D, Hkv, G, Tq, pos, window)
    k1 = []
    for post in (False, True):
        for k_out, hg in outl:
            for sink in (0, 5):
                for D in (64, 128):
                    k1.append((post, k_out, hg, sink, D, 4, 2, 1, [3, 700],
                               None))
                for tq, pos in ((128 + sink, [0, 0]),
                                (128, [sink + 128, sink + 384])):
                    k1.append((post, k_out, hg, sink, 128, 4, 2, tq, pos,
                               None))
        for sink in (0, 5):  # hg 16 with channels, the speed layout
            for tq, pos in ((1, [5, 1000]), (128 + sink, [0, 0]),
                            (128, [sink + 128, sink + 640])):
                k1.append((post, "channels", 16, sink, 128, 16, 1, tq, pos,
                           None))
    k1 += [(False, "slots", 4, 5, 128, 4, 2, 1, [700, 1001], 300),
           (True, "channels", 2, 5, 128, 4, 2, 128, [389, 645], 200)]
    worst = {False: 0.0, True: 0.0}
    t0 = time.perf_counter()
    for dot_bf16 in (False, True):
        for (post, k_out, hg, sink, D, Hkv, G, tq, pos, window) in k1:
            dcfg, mcfg = k1_config("int4x2", 2, Hkv, D, G, Tc, sink, post,
                                   k_out, hg, window, dot_bf16, n_kc=4)
            gen = torch.Generator(device=dev).manual_seed(51)
            ops = k1_operands(dcfg, L, B, Tc, gen, dev)
            q = torch.randn((B, Hkv, G * tq, D), generator=gen, device=dev)
            p = torch.tensor(pos, dtype=torch.int32, device=dev)
            args = (q, ops["k_planes"], ops["v_planes"], ops["kv_out"],
                    ops["k_range"], ops["k_offset"], ops["v_scale"],
                    ops["v_offset"], ops["k_sink"], ops["v_sink"],
                    ops["k_lut"], ops["v_lut"], 1, p, dcfg, mcfg)
            got = fd.flash_attention(*args, Tq=tq, k_ressc=ops["k_ressc"])
            torch.cuda.synchronize()
            want = fd.flash_attention_ref(*args, Tq=tq,
                                          k_ressc=ops["k_ressc"])
            check_case(f"[18] K1 int4x2 {'post' if post else 'pre'} {k_out} "
                       f"hg{hg} sink{sink} D{D} G{G} Tq{tq} win{window}",
                       got, want, dot_bf16, worst)
    log(f"[18] K1 int4x2 == plain on {len(k1)} cases x 2 dot modes in "
        f"{time.perf_counter() - t0:.1f} s; worst |err| / bound: fp32 dots "
        f"{worst[False]:.3f}, bf16 dots {worst[True]:.3f}")
    report["x2_k1_grid_worst_ratio"] = dict(worst)

    worst5 = {False: 0.0, True: 0.0}
    k1_diff, n5 = 0.0, 0
    t0 = time.perf_counter()
    for dot_bf16 in (False, True):
        for post in (False, True):
            for k_out, hg in (("channels", 2), ("slots", 4), ("none", 2)):
                for sink in (0, 5):
                    for P in (256, 1024):
                        dcfg, mcfg = k1_config("int4x2", 2, 4, 128, 2, 3 * P,
                                               sink, post, k_out, hg, None,
                                               dot_bf16, n_kc=4)
                        dcfg = dataclasses.replace(dcfg, page_tokens=P)
                        gen = torch.Generator(device=dev).manual_seed(52)
                        pool, ops, table, pos = paged_case(dcfg, L, P, gen,
                                                           dev)
                        dq = paged_dq(ops)
                        q = torch.randn((4, 4, 2, 128), generator=gen,
                                        device=dev)
                        got = pdk.paged_flash_decode(q, pool, table, dq, 1,
                                                     pos, dcfg, mcfg)
                        torch.cuda.synchronize()
                        want = pdk.paged_flash_decode_ref(q, pool, table, dq,
                                                          1, pos, dcfg, mcfg)
                        tag = (f"[18] K5 int4x2 {'post' if post else 'pre'} "
                               f"{k_out} hg{hg} sink{sink} P{P}")
                        check_case(tag, got, want, dot_bf16, worst5)
                        k1_ = k1_on_pages(q, pool, table, dq, 1, pos, dcfg,
                                          mcfg, fd.flash_attention)
                        diff = float((got - k1_).abs().max())
                        if not diff <= FP32_TOL * (1 + float(
                                want.abs().max())):
                            raise AssertionError(f"{tag}: K5 != K1 on the "
                                                 f"same tokens ({diff:.3e})")
                        k1_diff = max(k1_diff, diff)
                        n5 += 1
    log(f"[18] K5 int4x2 == plain on {n5 // 2} cases x 2 dot modes in "
        f"{time.perf_counter() - t0:.1f} s; worst |err| / bound: fp32 dots "
        f"{worst5[False]:.3f}, bf16 dots {worst5[True]:.3f}; max |K5 - K1 "
        f"on the same tokens| {k1_diff:.3e}")
    report["x2_k5_grid_worst_ratio"] = dict(worst5)
    report["x2_k5_vs_k1_max_diff"] = k1_diff
    report["x2_decode_edges"] = {
        "K1": decode_edge_grid("[18]", (("int4x2", 2),), paged=False),
        "K5": decode_edge_grid("[18]", (("int4x2", 2),), paged=True)}
    report["x2_chunk_edges"] = chunk_edge_grid("[18]", (("int4x2", 2),))


def speed2_config(max_len, n_layers, cfg=None):
    """The 2-bit exact-density speed config (benchmarks/ppl_table.py:
    281-286) at LLaMA-2-7B width: int4x2, post-RoPE K, 4 static K channels
    per head group of 4, no V slots, sink 5, K1; uniform 2-bit quantizers
    drawn from a seed."""
    from kvquant_tpu_torch.cache import DeployConfig
    from kvquant_tpu_torch.models.config import LLAMA2_7B
    from kvquant_tpu_torch.quant.artifacts import (
        KQuantizer, VQuantizer, LayerQuantizers, QuantizerSet)

    cfg = cfg or LLAMA2_7B
    dcfg = DeployConfig.create(
        bits=2, n_kv_heads=cfg.n_kv_heads, d_head=cfg.d_head,
        max_len=max_len, sink=5, kernel="flash", head_group=4,
        codes="int4x2", post_rope_k=True, k_outliers="channels", n_kc=4,
        cap_per_side=0)
    rng = np.random.default_rng(19)
    lut = np.linspace(-1, 1, 4, dtype=np.float32)
    layers = []
    for _ in range(n_layers):
        u = (np.abs(rng.normal(size=cfg.kv_hidden)) * 2 + 1).astype(np.float32)
        layers.append(LayerQuantizers(
            k=KQuantizer(upper=u, lower=(-u * 0.9).astype(np.float32),
                         lut=lut.copy(),
                         ressc=rng.random(cfg.kv_hidden).astype(np.float32)),
            v=VQuantizer(lut=lut.copy())))
    qs = QuantizerSet(layers=layers, bits=2, sparsity_threshold=0.99,
                      cap_outliers=True, first_few_fp16=5,
                      meta={"post_rope_k": True})
    return cfg, dcfg, qs


def phase_x2_main_path(report):
    """The 2-bit exact-density main path at LLaMA-2-7B width: quantized
    chunked prefill of a 2048-token prompt and 64 greedy tokens, all
    attention through K1's int4x2 instances."""
    from kvquant_tpu_torch import engine
    from kvquant_tpu_torch.cache import create_cache, deployed_from_quantizers
    from kvquant_tpu_torch.models import init_params
    from kvquant_tpu_torch.ops.kernels import flash_decode as fd

    T0, N, chunk = 2048, 64, 256
    cfg, dcfg, qs = speed2_config(T0 + N + 5, 32)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         dtype=torch.bfloat16, device="cuda")
    dq = deployed_from_quantizers(qs, cfg.n_kv_heads, cfg.d_head,
                                  device="cuda")
    prompt = torch.randint(0, cfg.vocab_size, (1, T0),
                           generator=torch.Generator().manual_seed(1))
    n_chunks = -(-(T0 - dcfg.sink) // chunk)
    bpt = stored_bytes_per_token(dcfg)
    log(f"[19] LLaMA-2-7B width, {cfg.n_layers} layers, bf16 weights; int4x2 "
        f"2-bit post-RoPE, 4 static K channels per group of 4, no V slots, "
        f"sink 5, kernel flash; cache {bpt:.0f} B/token/layer (nuq3 faithful "
        f"{nuq_bytes_per_token(faithful_config(64, 1)[1])} B, fp16 "
        f"{4 * cfg.kv_hidden} B)")

    # prefill alone (also the warm-up of every shape the path uses)
    cache = create_cache(dcfg, cfg.n_layers, 1, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.prefill_quantized(params, cfg, dcfg, dq, cache, prompt.cuda(),
                             chunk=chunk)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    del cache

    gcfg = engine.GenerateConfig(max_new_tokens=N)
    read = reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks, cache = engine.generate(params, cfg, dcfg, dq, prompt, gcfg,
                                  prefill_mode="quantized", device="cuda")
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    n = read()
    want = cfg.n_layers * (n_chunks + N)
    report["x2_k1_launches"] = n["K1"]
    report["x2_k1_chunk_launches"] = n["K1_chunk"]
    log(f"[19] quantized prefill {T0} tokens ({n_chunks} chunks of {chunk}) "
        f"{prefill_s:.3f} s; generate (prefill + {N} decode steps) "
        f"{gen_s:.3f} s; launches {n} (K1 expected {want})")
    if not (n["K1"] == want and n["K1_chunk"] == cfg.n_layers * n_chunks
            and n["K2"] == n["K3"] == n["K4"] == n["K5"] == 0):
        raise AssertionError("the 2-bit main path did not run K1 alone per "
                             "layer, chunk and step")
    if not (toks.shape == (1, N) and int(toks.min()) >= 0
            and int(toks.max()) < cfg.vocab_size):
        raise AssertionError(f"bad tokens {toks.shape}")
    _, logits = engine.decode_step(params, cfg, dcfg, dq, cache,
                                   toks[:, -1], T0 + N)
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("non-finite logits")
    decode_tps = N / (gen_s - prefill_s)
    log(f"[19] decode {decode_tps:.2f} tok/s at {T0}-{T0 + N} context "
        f"(64 / (generate - prefill) wall time)")

    # the live cache: K1 against plain at the first and last layer
    gen = torch.Generator(device="cuda").manual_seed(2)
    arrs = cache.arrays()
    k_chan = fd.k_channel_index(dq.k_ressc, dcfg).to(torch.int32)
    worst = 0.0
    for tq, p0 in ((1, T0 + N), (256, 1029)):
        q = torch.randn((1, cfg.n_kv_heads, tq, cfg.d_head), generator=gen,
                        device="cuda")
        pos = torch.tensor([p0], dtype=torch.int32, device="cuda")
        for li in (0, cfg.n_layers - 1):
            for d in (dcfg, dataclasses.replace(dcfg, dot_bf16=False)):
                args = (q, arrs["k_planes"], arrs["v_planes"],
                        arrs["kv_out"], dq.k_range, dq.k_offset,
                        arrs["v_scale"], arrs["v_offset"], arrs["k_sink"],
                        arrs["v_sink"], dq.k_lut_dec, dq.v_lut_dec, li, pos,
                        d, cfg)
                got = fd.flash_attention(*args, Tq=tq, k_chan=k_chan)
                want_ = fd.flash_attention_ref(*args, Tq=tq, k_chan=k_chan)
                worst = max(worst, agree(f"[19] live cache layer {li} Tq {tq}",
                                         got, want_, d.dot_bf16))
    report["x2_max_abs_err"] = worst
    del cache, arrs

    # decode at 32K (profiled) and 128K over synthetic filled caches
    tok = torch.zeros((1,), dtype=torch.int32, device="cuda")
    tps = {T0: decode_tps}
    for ctx, prof in ((32768, True), (131072, False)):
        _, dcfg_c, qs_c = speed2_config(ctx + 32, 32)
        dq_c = deployed_from_quantizers(qs_c, cfg.n_kv_heads, cfg.d_head,
                                        device="cuda")
        cache = filled_cache(dcfg_c, cfg.n_layers, ctx, 3)
        tps[ctx], idle = decode_profile(
            f"[19] {ctx} ctx", lambda i: engine.decode_step(
                params, cfg, dcfg_c, dq_c, cache, tok, ctx + i), 16,
            prof_steps=3 if prof else 0)
        if prof:
            report["x2_idle_32k"] = idle
        del cache
        torch.cuda.empty_cache()
    report["x2_decode_tps"] = tps
    report["x2_prefill_s_2k"] = prefill_s
    report["x2_bytes_per_token"] = bpt
    log(f"[19] 2-bit int4x2 decode tok/s: " + ", ".join(
        f"{c}: {t:.2f}" for c, t in tps.items()))
    del params
    torch.cuda.empty_cache()


def toy_deployed_and_simulated(dev, qs, dcfg, windows, params_tree):
    """(deployed ppl, simulated ppl) of the toy checkpoint on ``dev``."""
    from kvquant_tpu_torch import engine
    from kvquant_tpu_torch.cache import deployed_from_quantizers
    from kvquant_tpu_torch.evals import perplexity
    from kvquant_tpu_torch.models import params_from_numpy
    from kvquant_tpu_torch.models import simquant_from_quantizers
    from kvquant_tpu_torch.utils.toymodel import TOY_CFG as cfg

    params = params_from_numpy(params_tree, cfg, device=dev)
    dq = deployed_from_quantizers(qs, cfg.n_kv_heads, cfg.d_head, device=dev)
    dep = engine.deployed_ppl(params, cfg, dcfg, dq, windows, device=dev)
    sq = simquant_from_quantizers(
        qs, v_mode="topk", n_kv_heads=cfg.n_kv_heads,
        head_group=dcfg.head_group, k_outliers=dcfg.k_outliers,
        cap_per_side=dcfg.cap_per_side, n_kc=dcfg.n_kc, device=dev)
    return dep, perplexity(params, cfg, windows, simquant=sq)


def phase_x2_oracle(report):
    """The accuracy oracle on the card: calibration -> simulated ppl ->
    deployed ppl on the committed toy checkpoint (int4x2 through K1; the
    committed nuq3 quantizers through K3 / K4), PagedServer with int4x2
    card == CPU, then cli.calibrate and cli.eval_ppl at LLaMA-2-7B
    width."""
    import os
    import shutil

    from kvquant_tpu_torch.cache import DeployConfig, deployed_from_quantizers
    from kvquant_tpu_torch.cli import calibrate as calibrate_cli
    from kvquant_tpu_torch.cli import eval_ppl as eval_ppl_cli
    from kvquant_tpu_torch.models import params_from_numpy
    from kvquant_tpu_torch.paged import PagedServer
    from kvquant_tpu_torch.quant.artifacts import load_quantizers
    from kvquant_tpu_torch.quant.calibration import (collect_kv_activations,
                                                     fit_quantizers)
    from kvquant_tpu_torch.serve import Request
    from kvquant_tpu_torch.utils.toymodel import TOY_CFG as cfg
    from kvquant_tpu_torch.utils.toymodel import (BigramLM,
                                                  load_toy_checkpoint)

    root = os.path.dirname(os.path.abspath(__file__))
    art = os.path.join(root, "artifacts")
    tree, _, seed = load_toy_checkpoint(os.path.join(art, "toy_model.npz"))
    lm = BigramLM(cfg.vocab_size, seed=seed)
    ev = lm.sample(4, 256, seed=10_001)[:2]
    cal = lm.sample(4, 256, seed=20_002)

    # the speed config's quantizers, fitted on the card
    params = params_from_numpy(tree, cfg, device="cuda")
    k, v = collect_kv_activations(params, cfg, [cal], rope_k=True)
    qs = fit_quantizers(k, v, bits=2, sparsity_threshold=0.99,
                        cap_outliers=True, first_few_fp16=5, sample_seqlen=256,
                        mode="uniform", meta={"post_rope_k": True})
    del params, k, v
    d2 = DeployConfig.create(
        bits=2, n_kv_heads=cfg.n_kv_heads, d_head=cfg.d_head, max_len=261,
        sink=5, head_group=4, codes="int4x2", post_rope_k=True,
        k_outliers="channels", kernel="flash", cap_per_side=0)
    read = reset_launches()
    dep, sim = toy_deployed_and_simulated("cuda", qs, d2, ev, tree)
    n = read()
    dep_cpu, sim_cpu = toy_deployed_and_simulated("cpu", qs, d2, ev, tree)
    gap = abs(np.log(dep) - np.log(sim))
    log(f"[20] toy checkpoint, int4x2 speed config (uniform 2-bit fitted on "
        f"the card on roped activations): simulated ppl {sim:.4f}, deployed "
        f"ppl through K1 {dep:.4f} (|log gap| {gap:.2e}, bound 0.02; K1 "
        f"launches {n['K1']}); CPU: deployed {dep_cpu:.4f}, simulated "
        f"{sim_cpu:.4f} (card/cpu deployed {dep / dep_cpu - 1:+.2e})")
    if not (gap < 0.02 and abs(dep / dep_cpu - 1) < 1e-3 and n["K1"] > 0):
        raise AssertionError("int4x2 deployed != simulated, or card != cpu")

    qs3 = load_quantizers(os.path.join(art, "toy_quantizers_3bit.npz"))
    d3 = DeployConfig.create(bits=3, n_kv_heads=cfg.n_kv_heads,
                             d_head=cfg.d_head, max_len=261, sink=5,
                             head_group=4, kernel="pallas")
    read = reset_launches()
    dep3, sim3 = toy_deployed_and_simulated("cuda", qs3, d3, ev, tree)
    n = read()
    gap3 = abs(np.log(dep3) - np.log(sim3))
    log(f"[20] toy checkpoint, committed nuq3 quantizers hg 4: simulated "
        f"{sim3:.4f}, deployed through K3/K4 {dep3:.4f} (|log gap| "
        f"{gap3:.2e}; launches {n})")
    if not (gap3 < 0.02 and n["K3"] > 0 and n["K4"] > 0):
        raise AssertionError("nuq3 deployed through K3/K4 != simulated")
    report["x2_oracle"] = dict(sim=sim, dep=dep, dep_cpu=dep_cpu,
                               sim_nuq3=sim3, dep_nuq3=dep3)

    # PagedServer with int4x2 on the toy checkpoint: card == CPU
    P = 256
    dp = dataclasses.replace(d2, dot_bf16=False, max_len=P + 5,
                             page_tokens=P)
    rng = np.random.default_rng(20)
    reqs = [(rng.integers(0, cfg.vocab_size, m).astype(np.int32), b)
            for m, b in ((16, 12), (40, 9), (25, 16), (33, 7))]
    out = {}
    for dev in ("cuda", "cpu"):
        srv = PagedServer(params_from_numpy(tree, cfg, device=dev), cfg, dp,
                          deployed_from_quantizers(qs, cfg.n_kv_heads,
                                                   cfg.d_head, device=dev),
                          n_pages=2, n_slots=2, max_pages_per_slot=1,
                          admit_mode="chunked", burst=8, device=dev)
        read = reset_launches()
        comps = srv.run([Request(rid=i, prompt=p, max_new_tokens=m)
                         for i, (p, m) in enumerate(reqs)])
        if dev == "cuda":
            n = read()
        out[dev] = [comps[i].tokens for i in range(len(reqs))]
    same = out["cuda"] == out["cpu"]
    log(f"[20] PagedServer int4x2 toy checkpoint (P {P}, 2 slots, 4 "
        f"requests): card == cpu: {same}; card launches {n}")
    if not (same and n["K5"] > 0 and n["K1"] > 0):
        raise AssertionError(f"card {out['cuda']} cpu {out['cpu']}")

    # the CLIs at LLaMA-2-7B width (their own random init)
    work = os.path.join(root, "kvquant_tpu_torch", "_build", "smoke_work")
    os.makedirs(work, exist_ok=True)
    qpath = os.path.join(work, "cli_uniform2.npz")
    big = ["--toy-layers", "32", "--toy-dmodel", "4096", "--toy-heads", "32",
           "--toy-vocab", "32000", "--device", "cuda", "--seqlen", "256",
           "--post-rope-k", "--k-outliers", "channels"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    calibrate_cli.main(big + ["--abits", "2", "--mode", "uniform",
                              "--nsamples", "2", "--output", qpath])
    torch.cuda.synchronize()
    cal_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    read = reset_launches()
    t0 = time.perf_counter()
    ppl, dep7 = eval_ppl_cli.main(big + ["--quantizers", qpath, "--deployed",
                                         "--kernel", "flash",
                                         "--max-windows", "2"])
    torch.cuda.synchronize()
    ev_s = time.perf_counter() - t0
    n = read()
    log(f"[20] cli.calibrate (uniform 2-bit, 2 x 256 tokens) at LLaMA-2-7B "
        f"width {cal_s:.1f} s; cli.eval_ppl --deployed --kernel flash: "
        f"simulated ppl {ppl:.4f}, deployed ppl {dep7:.4f} in {ev_s:.1f} s "
        f"(model init included); launches {n} (K1 expected 32 x 256)")
    if not (np.isfinite([ppl, dep7]).all() and n["K1"] == 32 * 256):
        raise AssertionError("the CLIs did not run through K1")
    report["x2_cli"] = dict(sim=ppl, dep=dep7, calibrate_s=cal_s,
                            eval_s=ev_s, k1_launches=n["K1"])
    shutil.rmtree(work)
    torch.cuda.empty_cache()


def phase_x2_times(report):
    """K1 and K5 on int4x2 at one LLaMA-2-7B layer (Hkv 32, D 128, hg 4,
    channels n_kc 4, cap 0, post-RoPE, bf16 dots): K1 decode at 32K, 128K
    and 512K and a 256-row chunk at 2K and 32K; K5 at B=4 x 8K over permuted pages
    of 1024. Context: K1 on int4 containers and K2 on the same int4x2
    tokens."""
    from kvquant_tpu_torch.ops.kernels import flash_decode as fd
    from kvquant_tpu_torch.ops.kernels import flash_serial as fs
    from kvquant_tpu_torch.ops.kernels import paged_decode as pdk
    from kvquant_tpu_torch.paged import PagedPool

    dev = torch.device("cuda")
    rows = []
    for kind, ctx in (("decode", 32768), ("decode", 131072),
                      ("decode", 524288), ("prefill", 2048),
                      ("prefill", 32768)):
        tq = 1 if kind == "decode" else 256
        cfg, dcfg, _ = speed2_config(ctx + tq + 8, 1)
        Hkv, D, S = cfg.n_kv_heads, cfg.d_head, dcfg.sink
        gen = torch.Generator(device=dev).manual_seed(7)
        ops = k1_operands(dcfg, 1, 1, dcfg.cache_tokens, gen, dev)
        q = torch.randn((1, Hkv, tq, D), generator=gen, device=dev)
        p0 = ctx - 1 if kind == "decode" else ctx
        pos = torch.tensor([p0], dtype=torch.int32, device=dev)

        def run(fn, d=dcfg, o=ops):
            return call(lambda *a, **k: fn(*a, Tq=tq, **k), q, o, 0, pos, d,
                        cfg)

        d32 = dataclasses.replace(dcfg, dot_bf16=False)
        err = max(agree(f"[21] K1 int4x2 {kind} ctx {ctx}",
                        run(fd.flash_attention), run(fd.flash_attention_ref),
                        True),
                  agree(f"[21] K1 int4x2 {kind} ctx {ctx}",
                        run(fd.flash_attention, d32),
                        run(fd.flash_attention_ref, d32), False))
        torch.cuda.empty_cache()
        kern = lambda: run(fd.flash_attention)  # noqa: E731
        ms = device_ms(kern)
        plain_ms = device_ms(lambda: run(fd.flash_attention_ref), n=1,
                             reps=3, warmup=1)
        torch.cuda.empty_cache()
        ms2 = device_ms(kern)
        last = p0 + tq - 1 - S
        pairs = sum(p0 + r - S + 1 + S for r in range(tq))
        nbytes = ((last + 1) * stored_bytes_per_token(dcfg)
                  + 4 * Hkv * D * (2 * S + 2 * tq))
        flops = 4 * pairs * D * Hkv
        b_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        b_ops = flops / BF16_FLOPS * 1e3
        row = dict(kernel="K1", kind=kind, ctx=ctx, tq=tq, ms=min(ms, ms2),
                   ms_runs=[ms, ms2], plain_ms=plain_ms,
                   bound_ms=max(b_bytes, b_ops),
                   bound_by="bytes" if b_bytes >= b_ops else "operations",
                   bytes=nbytes, flops=flops, max_abs_err=err)
        ctx_note = ""
        if kind == "decode" and ctx <= 131072:
            # context on the same tokens: K2 on these int4x2 arrays, and
            # K1 on int4 containers of the same token count
            d2 = dataclasses.replace(dcfg, kernel="flash_serial")
            chan = fs.k_channel_index(ops["k_ressc"], d2).to(torch.int32)

            def k2(body=None):
                return call(lambda *a, **k: fs.flash_serial_decode(
                    *a, k_chan=chan, body=body), q, ops, 0, pos, d2, cfg)

            before = fs.flash_serial_decode.route_launches["fs_mma"]
            agree(f"[21] K2 fs_mma int4x2 ctx {ctx}", k2(),
                  call(fs.flash_serial_decode_ref, q, ops, 0, pos, d2, cfg),
                  True)
            if fs.flash_serial_decode.route_launches["fs_mma"] != before + 1:
                raise AssertionError("[21] K2 int4x2 did not run fs_mma")
            k2_runs = [device_ms(k2), device_ms(lambda: k2("fs_partial")),
                       device_ms(lambda: k2("fs_partial")), device_ms(k2)]
            row["k2_same_tokens_ms"] = min(k2_runs[0], k2_runs[3])
            row["k2_partial_same_tokens_ms"] = min(k2_runs[1], k2_runs[2])
            plan = fs.fs_plan(d2, 1, Hkv, 1, D, dcfg.cache_tokens, dev)
            log(f"[21] K2 int4x2 ctx {ctx}: {plan!r}: "
                f"{row['k2_same_tokens_ms']:.4f} ms (runs "
                f"{k2_runs[0]:.4f}, {k2_runs[3]:.4f}); fs_partial forced "
                f"{row['k2_partial_same_tokens_ms']:.4f} ms (runs "
                f"{k2_runs[1]:.4f}, {k2_runs[2]:.4f}); bound "
                f"{row['bound_ms']:.4f} ms (K1's bytes of these tokens)")
            d4 = dataclasses.replace(dcfg, codes="int4", bits=4)
            ops4 = k1_operands(d4, 1, 1, dcfg.cache_tokens, gen, dev)
            row["k1_int4_same_tokens_ms"] = device_ms(
                lambda: run(fd.flash_attention, d4, ops4))
            del ops4
            ctx_note = (f"; context: K2 (fs_mma) on the same int4x2 tokens "
                        f"{row['k2_same_tokens_ms']:.4f} ms, K1 on int4 "
                        f"containers of the same length "
                        f"{row['k1_int4_same_tokens_ms']:.4f} ms" + vs_before(
                            ('K1', 'int4', kind, ctx),
                            row['k1_int4_same_tokens_ms']))
        log(f"[21] K1 int4x2 {kind} Tq {tq} ctx {ctx}: kernel "
            f"{row['ms']:.4f} ms (runs {ms:.4f}, {ms2:.4f}), plain "
            f"{plain_ms:.3f} ms, bound {row['bound_ms']:.4f} ms by "
            f"{row['bound_by']} ({nbytes / 1e6:.1f} MB = {b_bytes:.4f} ms; "
            f"{flops / 1e9:.2f} GFLOP = {b_ops:.4f} ms), |err| {err:.2e}"
            f"{vs_before(('K1', 'int4x2', kind, ctx), row['ms'])}{ctx_note}")
        rows.append(row)
        del ops
        torch.cuda.empty_cache()

    # K5: B=4 slots at 8K each over permuted pages of 1024
    P, B, ctx = 1024, 4, 8192
    cfg, dcfg, _ = speed2_config(ctx + 8, 1)
    dcfg = dataclasses.replace(dcfg, page_tokens=P)
    Hkv, D, S = cfg.n_kv_heads, cfg.d_head, dcfg.sink
    MP = ctx // P
    gen = torch.Generator(device=dev).manual_seed(17)
    ops = k1_operands(dcfg, 1, B * MP, P, gen, dev)
    sinks = k1_operands(dcfg, 1, B, 128, gen, dev)
    pool = PagedPool(k_planes=ops["k_planes"], v_planes=ops["v_planes"],
                     kv_out=ops["kv_out"], v_scale=ops["v_scale"],
                     v_offset=ops["v_offset"], k_sink=sinks["k_sink"],
                     v_sink=sinks["v_sink"])
    dq = paged_dq(ops)
    table = torch.randperm(B * MP, generator=torch.Generator().manual_seed(18)
                           ).to(torch.int32).reshape(B, MP).to(dev)
    pos = torch.full((B,), ctx - 1, dtype=torch.int32, device=dev)
    q = torch.randn((B, Hkv, 1, D), generator=gen, device=dev)

    def run5(fn, d=dcfg):
        return fn(q, pool, table, dq, 0, pos, d, cfg)

    d32 = dataclasses.replace(dcfg, dot_bf16=False)
    err = max(agree("[21] K5 int4x2", run5(pdk.paged_flash_decode),
                    run5(pdk.paged_flash_decode_ref), True),
              agree("[21] K5 int4x2", run5(pdk.paged_flash_decode, d32),
                    run5(pdk.paged_flash_decode_ref, d32), False))
    kern = lambda: run5(pdk.paged_flash_decode)  # noqa: E731
    ms = device_ms(kern)
    plain_ms = device_ms(lambda: run5(pdk.paged_flash_decode_ref), n=2,
                         reps=3, warmup=1)
    ms2 = device_ms(kern)
    # K1 over the same tokens, gathered contiguously once (context)
    g = pdk.gather_layer(pool, pdk.live_pages(table, pos, dcfg), 0, dcfg)
    one = lambda t: t[0][None].contiguous()  # noqa: E731
    k1_args = (q, g["k_planes"][None], g["v_planes"][None],
               g["kv_out"][None], one(dq.k_range), one(dq.k_offset),
               g["v_scale"][None], g["v_offset"][None], one(pool.k_sink),
               one(pool.v_sink), one(dq.k_lut_dec), one(dq.v_lut_dec), 0,
               pos, dcfg, cfg)
    k1_ms = device_ms(lambda: fd.flash_attention(*k1_args,
                                                 k_ressc=one(dq.k_ressc)))
    nbytes = (B * (ctx - S) * stored_bytes_per_token(dcfg)
              + 4 * Hkv * D * (2 * S + 2) * B + 4 * B * MP)
    row = dict(kernel="K5", B=B, ctx=ctx, pages=B * MP, ms=min(ms, ms2),
               ms_runs=[ms, ms2], plain_ms=plain_ms,
               bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
               bytes=nbytes, k1_same_tokens_ms=k1_ms, max_abs_err=err)
    log(f"[21] K5 int4x2 B {B} ctx {ctx} ({B * MP} permuted pages of {P}): "
        f"kernel {row['ms']:.4f} ms (runs {ms:.4f}, {ms2:.4f}), plain "
        f"{plain_ms:.3f} ms, bound {row['bound_ms']:.4f} ms by bytes "
        f"({nbytes / 1e6:.1f} MB), |err| {err:.2e}; context: K1 on the same "
        f"tokens contiguous {k1_ms:.4f} ms"
        f"{vs_before(('K5', 'int4x2', B, ctx), row['ms'])}")
    rows.append(row)
    del ops, pool, g, k1_args
    torch.cuda.empty_cache()
    report["x2_times"] = rows


def phase_long_prefill(report):
    """The 2-bit speed config of phase 19 at LLaMA-2-7B width runs a
    32K-token quantized prefill (128 chunks of 256), graphed (the chunks
    after the first replay one engine.ChunkGraph) and eager: K1 32 x 128
    chunk launches and nothing else in each; wall seconds of each and the
    last token's logits bitwise equal; a profiler window over the last
    four chunks (run again on the same cache, eager chunks and a chunk
    graph's replays: device ms in K1 against the rest, and the idle
    share); K1 against plain on the live cache at layers 0 and 31, bf16
    and fp32 dots."""
    from torch.profiler import ProfilerActivity, profile

    from kvquant_tpu_torch import engine
    from kvquant_tpu_torch.cache import create_cache, deployed_from_quantizers
    from kvquant_tpu_torch.models import init_params
    from kvquant_tpu_torch.ops.kernels import flash_decode as fd

    T0, chunk, last = 32768, 256, 4
    cfg, dcfg, qs = speed2_config(T0 + 8, 32)
    S = dcfg.sink
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         dtype=torch.bfloat16, device="cuda")
    dq = deployed_from_quantizers(qs, cfg.n_kv_heads, cfg.d_head,
                                  device="cuda")
    prompt = torch.randint(0, cfg.vocab_size, (1, T0),
                           generator=torch.Generator().manual_seed(22)).cuda()
    n_chunks = -(-(T0 - S) // chunk)
    cache = create_cache(dcfg, cfg.n_layers, 1, device="cuda")
    # warm-up of the chunk shapes at a short prompt, eager and graphed
    with eager_prefill():
        engine.prefill_quantized(params, cfg, dcfg, dq, cache,
                                 prompt[:, :1029], chunk=chunk)
    engine.prefill_quantized(params, cfg, dcfg, dq, cache, prompt[:, :1029],
                             chunk=chunk)
    torch.cuda.synchronize()
    # the same prefill graphed (prefill_quantized on a card) and eager, over
    # the same cache: the second writes what the first wrote
    walls, last_logits = {}, {}
    want = cfg.n_layers * n_chunks
    for mode in ("graphed", "eager"):
        read = reset_launches()
        with (eager_prefill() if mode == "eager"
              else contextlib.nullcontext()):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, logits = engine.prefill_quantized(params, cfg, dcfg, dq,
                                                 cache, prompt, chunk=chunk)
            torch.cuda.synchronize()
            walls[mode] = time.perf_counter() - t0
        n = read()
        last_logits[mode] = logits
        log(f"[22] 2-bit int4x2 config, LLaMA-2-7B width, {cfg.n_layers} "
            f"layers: quantized prefill of {T0} tokens ({n_chunks} chunks of "
            f"{chunk}), {mode}: {walls[mode]:.3f} s "
            f"({T0 / walls[mode]:.0f} tok/s); launches {n} (K1 chunks "
            f"expected {want})")
        if not (n["K1"] == n["K1_chunk"] == want
                and n["K2"] == n["K3"] == n["K4"] == n["K5"] == 0):
            raise AssertionError("the long prefill did not run K1 per layer "
                                 "and chunk")
        if not bool(torch.isfinite(logits).all()):
            raise AssertionError("non-finite logits")
    same = bitwise(last_logits["graphed"], last_logits["eager"])
    log(f"[22] graphed / eager wall {walls['graphed'] / walls['eager']:.3f}; "
        f"last-token logits graphed == eager bitwise: {same}")
    if not same:
        raise AssertionError("[22] the graphed prefill != eager")
    wall_s = walls["graphed"]

    # the last four chunks again on the same cache (same tokens, same
    # positions): eager chunks and a chunk graph's replays, unprofiled
    # wall time, then one profiled pass of each
    toks = torch.nn.functional.pad(prompt, (0, n_chunks * chunk - (T0 - S)))
    p_tail = S + (n_chunks - last) * chunk
    graph = engine.ChunkGraph(params, cfg, dcfg, dq, cache,
                              toks[:, p_tail:p_tail + chunk], p_tail, False)

    def tail():
        for c in range(n_chunks - last, n_chunks):
            start = S + c * chunk
            engine.prefill_chunk(params, cfg, dcfg, dq, cache,
                                 toks[:, start:start + chunk], start, False)

    def tail_graphed():
        for c in range(n_chunks - last, n_chunks):
            start = S + c * chunk
            graph(toks[:, start:start + chunk], start)

    tails = {}
    for mode, fn in (("eager", tail), ("graphed", tail_graphed)):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        tail_s = time.perf_counter() - t0
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     acc_events=True) as prof:
            fn()
            torch.cuda.synchronize()
        ev = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.self_device_time_total > 0]
        k1_us = sum(e.self_device_time_total for e in ev
                    if "fd_chunk" in e.key or "fd_merge" in e.key)
        dev_us = sum(e.self_device_time_total for e in ev)
        idle = 1 - dev_us / 1e6 / tail_s
        tails[mode] = dict(ms=tail_s * 1e3 / last, dev_ms=dev_us / 1e3 / last,
                           k1_ms=k1_us / 1e3 / last, idle=idle)
        log(f"[22] last {last} chunks (context {T0 - last * chunk}-{T0}), "
            f"{mode}: {tail_s * 1e3 / last:.3f} ms/chunk host wall; "
            f"profiler: device {dev_us / 1e3 / last:.3f} ms/chunk, of it K1 "
            f"(fd_chunk + fd_merge) {k1_us / 1e3 / last:.3f} ms and the rest "
            f"{(dev_us - k1_us) / 1e3 / last:.3f} ms; device idle share "
            f"{idle:.3f}")
        if mode == "eager":
            for e in sorted(ev, key=lambda e: -e.self_device_time_total)[:6]:
                log(f"[22]   {e.self_device_time_total / last / 1e3:8.3f} "
                    f"ms/chunk  x{e.count // last:5d}  {e.key[:90]}")
    del graph
    tail_s = tails["eager"]["ms"] * last / 1e3
    dev_us = tails["eager"]["dev_ms"] * last * 1e3
    k1_us = tails["eager"]["k1_ms"] * last * 1e3
    idle = tails["eager"]["idle"]

    # the live cache: K1 against plain at the first and last layer, the
    # last chunk's rows
    arrs = cache.arrays()
    k_chan = fd.k_channel_index(dq.k_ressc, dcfg).to(torch.int32)
    gen = torch.Generator(device="cuda").manual_seed(23)
    q = torch.randn((1, cfg.n_kv_heads, chunk, cfg.d_head), generator=gen,
                    device="cuda")
    pos = torch.tensor([S + (n_chunks - 1) * chunk], dtype=torch.int32,
                       device="cuda")
    worst = 0.0
    for li in (0, cfg.n_layers - 1):
        for d in (dcfg, dataclasses.replace(dcfg, dot_bf16=False)):
            args = (q, arrs["k_planes"], arrs["v_planes"], arrs["kv_out"],
                    dq.k_range, dq.k_offset, arrs["v_scale"],
                    arrs["v_offset"], arrs["k_sink"], arrs["v_sink"],
                    dq.k_lut_dec, dq.v_lut_dec, li, pos, d, cfg)
            got = fd.flash_attention(*args, Tq=chunk, k_chan=k_chan)
            want_ = fd.flash_attention_ref(*args, Tq=chunk, k_chan=k_chan)
            worst = max(worst, agree(f"[22] live cache layer {li} Tq {chunk} "
                                     f"pos {int(pos)}", got, want_,
                                     d.dot_bf16))
            del got, want_
            torch.cuda.empty_cache()
    report["long_prefill"] = dict(tokens=T0, wall_s=wall_s,
                                  eager_wall_s=walls["eager"], tails=tails,
                                  k1_chunk_launches=n["K1_chunk"],
                                  tail_ms_per_chunk=tail_s * 1e3 / last,
                                  device_ms_per_chunk=dev_us / 1e3 / last,
                                  k1_ms_per_chunk=k1_us / 1e3 / last,
                                  idle=idle, max_abs_err=worst)
    del cache, arrs, params
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# the calibrate -> deploy chain (cli.fisher, cli.calibrate --fisher,
# cli.deploy, cache_io) and MISTRAL_7B through K1
# ---------------------------------------------------------------------------


def gib_peak():
    """Peak device memory since the last reset, GiB."""
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() / 2 ** 30


def phase_calibrate_deploy(report):
    """The calibrate -> deploy chain through the user's entry points at
    LLaMA-2-7B width (the CLIs' random init: 32 layers, d_model 4096, 32
    heads, vocab 32000, bf16, d_ff = 3 * d_model): cli.fisher over 2
    windows of 2048 tokens, one remat step beside a plain one, cli.calibrate
    nuq3 with those Fisher weights, cli.deploy --check through K1 and its
    timed decode and profile through K3 / K4, and cache_io on the card."""
    import argparse
    import os
    import shutil

    from torch.utils.checkpoint import checkpoint

    from kvquant_tpu_torch import cache_io, engine
    from kvquant_tpu_torch.cache import (DeployConfig, create_cache,
                                         deployed_from_quantizers,
                                         reset_cache)
    from kvquant_tpu_torch.cli import calibrate as calibrate_cli
    from kvquant_tpu_torch.cli import common
    from kvquant_tpu_torch.cli import deploy as deploy_cli
    from kvquant_tpu_torch.cli import fisher as fisher_cli
    from kvquant_tpu_torch.fisher.fisher import _fisher_step
    from kvquant_tpu_torch.quant.artifacts import load_quantizers

    root = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(root, "kvquant_tpu_torch", "_build", "smoke_chain")
    os.makedirs(work, exist_ok=True)
    fpath = os.path.join(work, "fisher.npz")
    qpath = os.path.join(work, "quantizers.npz")
    big = ["--toy-layers", "32", "--toy-dmodel", "4096", "--toy-heads", "32",
           "--toy-vocab", "32000", "--device", "cuda"]
    data = ["--nsamples", "2", "--seqlen", "2048"]
    out = {}

    # 1. Fisher information through cli.fisher
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    fk, fv = fisher_cli.main(big + data + ["--batch", "1", "--output", fpath])
    out["fisher_s"] = time.perf_counter() - t0
    out["fisher_peak_gib"] = gib_peak()
    ok = all(bool(torch.isfinite(f).all()) and bool((f >= 0).all())
             and bool(f.any()) for f in (fk, fv))
    log(f"[23] LLaMA-2-7B width (the CLIs' random init, d_ff 3 x d_model "
        f"12288, bf16): cli.fisher 2 x 2048 tokens, batch 1: "
        f"{out['fisher_s']:.1f} s wall (model init included), peak "
        f"{out['fisher_peak_gib']:.2f} GiB allocated; fisher_k "
        f"{tuple(fk.shape)}, fisher_v {tuple(fv.shape)}; finite, >= 0, "
        f"not all zero: {ok}")
    if not (ok and fk.shape == fv.shape == (32, 4096, 4096)):
        raise AssertionError("bad Fisher information")
    del fk, fv

    # one step with remat beside the plain step, at the same shape
    ap = argparse.ArgumentParser()
    common.add_model_args(ap)
    common.add_data_args(ap)
    args = ap.parse_args(big + data)
    params, cfg = common.load_model(args)
    train, test = common.load_data(args, cfg)
    tokens = torch.as_tensor(train[:1])
    # the first torch.utils.checkpoint call imports torch._dynamo: paid
    # here, before the timed steps
    t0 = time.perf_counter()
    checkpoint(torch.square, torch.ones(1, device="cuda", requires_grad=True),
               use_reentrant=False)
    out["first_checkpoint_s"] = time.perf_counter() - t0
    peaks, steps = {}, {}
    for remat in (False, True):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        g = _fisher_step(params, cfg, tokens, remat=remat)
        peaks[remat] = gib_peak()
        steps[remat] = time.perf_counter() - t0
        g = [x.cpu() for x in g] if not remat else g
        if remat:
            rel = max(float((a - b.cuda()).abs().max() / b.abs().max())
                      for a, b in zip(g, plain))
        else:
            plain = g
    del g, plain
    out.update(step_peak_gib=peaks[False], remat_peak_gib=peaks[True],
               step_s=steps[False], remat_step_s=steps[True], remat_rel=rel)
    log(f"[23] one Fisher step (1 x 2048): peak {peaks[False]:.2f} GiB, "
        f"{steps[False]:.2f} s; with remat {peaks[True]:.2f} GiB, "
        f"{steps[True]:.2f} s (the first checkpoint call, before them: "
        f"{out['first_checkpoint_s']:.1f} s); max |remat - plain| / "
        f"max|plain| {rel:.2e}")
    if not rel <= 1e-6:
        raise AssertionError("remat changed the Fisher step")

    # 2. cli.calibrate nuq3 with those Fisher weights
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    calibrate_cli.main(big + data + ["--abits", "3", "--mode", "nuq",
                                     "--fisher", fpath, "--output", qpath])
    torch.cuda.synchronize()
    out["calibrate_s"] = time.perf_counter() - t0
    log(f"[23] cli.calibrate --mode nuq --abits 3 --fisher over the same "
        f"2 x 2048 tokens: {out['calibrate_s']:.1f} s (model init "
        f"included)")
    os.remove(fpath)

    # 3. cli.deploy: --check and the timed decode through K1, then K3 / K4
    #    with a profile of one decode pass
    dep = big + ["--nsamples", "2", "--seqlen", "2304", "--quantizers",
                 qpath, "--prefill", "2048"]
    torch.cuda.empty_cache()
    read = reset_launches()
    t0 = time.perf_counter()
    r = deploy_cli.main(dep + ["--check", "--benchmark", "64", "--kernel",
                               "flash"])
    wall = time.perf_counter() - t0
    n = read()
    log(f"[23] cli.deploy --check --prefill 2048 --benchmark 64 --kernel "
        f"flash ({wall:.1f} s wall): {r['tok_s']:.2f} tok/s; timed-pass "
        f"launches {r['launches']};"
        f" whole run {n} (K1 expected 32 x 64 per pass: the check's 64 "
        f"steps, the warm-up, the timed pass)")
    if not (np.isfinite([r["sim_ppl"], r["dep_ppl"]]).all()
            and r["launches"]["K1"] == 32 * 64
            and n["K1"] == 3 * 32 * 64
            and n["K2"] == n["K3"] == n["K4"] == n["K5"] == 0):
        raise AssertionError("cli.deploy did not run through K1")
    out["deploy_flash"] = {k: r[k] for k in ("cache_mib", "sim_ppl",
                                             "dep_ppl", "tok_s")}
    out["k1_launches"] = n["K1"]
    read = reset_launches()
    t0 = time.perf_counter()
    r = deploy_cli.main(dep + ["--benchmark", "16", "--kernel", "pallas"])
    wall = time.perf_counter() - t0
    n = read()
    log(f"[23] cli.deploy --benchmark 16 --kernel pallas ({wall:.1f} s "
        f"wall): {r['tok_s']:.2f} tok/s; timed-pass launches "
        f"{r['launches']}; whole run {n} (the warm-up, the timed pass)")
    if not (r["launches"]["K3"] == r["launches"]["K4"] == 32 * 16
            and r["launches"]["K1"] == 0 and n["K1"] == 0
            and n["K3"] == n["K4"] == 2 * 32 * 16):
        raise AssertionError("cli.deploy --kernel pallas did not run K3/K4")
    out["k34_launches"] = n["K3"]
    out["deploy_pallas_tok_s"] = r["tok_s"]
    # the profile: a third run, 4 steps (a trace holds ~16 MB a step)
    prof = os.path.join(work, "profile")
    read = reset_launches()
    t0 = time.perf_counter()
    r = deploy_cli.main(dep + ["--benchmark", "4", "--kernel", "flash",
                               "--profile", prof])
    wall = time.perf_counter() - t0
    n = read()
    trace = os.path.join(prof, "trace.json")
    size = os.path.getsize(trace) if os.path.exists(trace) else 0
    p = r["profile"]
    log(f"[23] cli.deploy --benchmark 4 --kernel flash --profile ({wall:.1f} "
        f"s wall): {p['launches'] / 4:.0f} kernel launches/step, "
        f"{p['kernel_ms'] / 4:.3f} device ms/step against "
        f"{1e3 / r['tok_s']:.1f} ms/step unprofiled wall; trace {size} B; "
        f"launches {n}")
    for name, ms in p["by_kernel"][:6]:
        log(f"[23]   {ms / 4:8.3f} ms/step  {name[:90]}")
    if not (n["K1"] == 3 * 32 * 4 and size > 0 and p["device"] == "cuda"):
        raise AssertionError("cli.deploy --profile wrote no trace of K1")
    out["deploy_profile"] = dict(launches_per_step=p["launches"] / 4,
                                 device_ms_per_step=p["kernel_ms"] / 4,
                                 ms_per_step=1e3 / r["tok_s"])

    # 4. cache_io on the card: save / load a 2048-token prefill
    qs = load_quantizers(qpath)
    dcfg = DeployConfig.create(
        bits=qs.bits, n_kv_heads=cfg.n_kv_heads, d_head=cfg.d_head,
        max_len=2048 + 64, sink=qs.first_few_fp16, kernel="flash",
        head_group=4, sparsity_threshold=qs.sparsity_threshold)
    dq = deployed_from_quantizers(qs, cfg.n_kv_heads, cfg.d_head,
                                  device="cuda")
    prompt = torch.as_tensor(test[:1, :2048]).cuda()
    cache = create_cache(dcfg, cfg.n_layers, 1, device="cuda")
    cache, logits = engine.prefill(params, cfg, dcfg, dq, cache, prompt)
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    path = os.path.join(work, "cache.npz")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cache_io.save_cache(path, cache, dcfg)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    restored, d2 = cache_io.load_cache(path, device="cuda")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    mib = os.path.getsize(path) / 2 ** 20
    _, want = engine.decode_step(params, cfg, dcfg, dq, cache, tok, 2048)
    _, got = engine.decode_step(params, cfg, dcfg, dq, restored, tok, 2048)
    same = bool(torch.equal(got, want))
    reset_cache(cache)
    zero = not any(bool(a.any()) for a in (*cache.arrays().values(),
                                           cache.length))
    cache, logits2 = engine.prefill(params, cfg, dcfg, dq, cache, prompt)
    _, again = engine.decode_step(params, cfg, dcfg, dq, cache, tok, 2048)
    fresh = bool(torch.equal(logits2, logits)) and bool(
        torch.equal(again, want))
    log(f"[23] cache_io: {mib:.1f} MiB file, save {save_s:.2f} s, load "
        f"{load_s:.2f} s; decode step from the restored cache bitwise "
        f"equal: {same}; reset_cache zeroed every array: {zero}; a fresh "
        f"prefill after it gives the same logits: {fresh}")
    if not (same and zero and fresh and d2 == dcfg):
        raise AssertionError("cache_io / reset_cache round trip failed")
    out.update(cache_mib=mib, save_s=save_s, load_s=load_s)
    report["chain"] = out
    del cache, restored, params
    shutil.rmtree(work)
    torch.cuda.empty_cache()


def phase_mistral(report):
    """MISTRAL_7B at its full widths (d_ff 14336, 32 / 8 heads, window
    4096; random bf16 weights from a seed) with the reference-faithful
    storage of phase 7 at kv_hidden 1024: a quantized chunked prefill of
    6144 tokens (24 chunks of 256, past the window), then 32 greedy tokens,
    all through K1."""
    from kvquant_tpu_torch import engine
    from kvquant_tpu_torch.cache import create_cache, deployed_from_quantizers
    from kvquant_tpu_torch.models import init_params
    from kvquant_tpu_torch.models.config import MISTRAL_7B
    from kvquant_tpu_torch.ops.kernels import flash_decode as fd

    T0, N, chunk = 6144, 32, 256
    cfg, dcfg, qs = faithful_config(T0 + N + 5, 32, MISTRAL_7B)
    S = dcfg.sink
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(24),
                         dtype=torch.bfloat16, device="cuda")
    dq = deployed_from_quantizers(qs, cfg.n_kv_heads, cfg.d_head,
                                  device="cuda")
    prompt = torch.randint(0, cfg.vocab_size, (1, T0),
                           generator=torch.Generator().manual_seed(24)).cuda()
    n_chunks = -(-(T0 - S) // chunk)
    log(f"[24] MISTRAL_7B: {cfg.n_layers} layers, d_ff {cfg.d_ff}, "
        f"{cfg.n_heads} / {cfg.n_kv_heads} heads (G {cfg.q_per_kv}), window "
        f"{cfg.sliding_window}, bf16 weights; nuq3 pre-RoPE, slots cap 2, hg "
        f"4, sink 5, kernel flash; capacity {dcfg.cache_tokens} tokens")

    cache = create_cache(dcfg, cfg.n_layers, 1, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.prefill_quantized(params, cfg, dcfg, dq, cache, prompt,
                             chunk=chunk)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    del cache

    read = reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks, cache = engine.generate(params, cfg, dcfg, dq, prompt,
                                  engine.GenerateConfig(max_new_tokens=N),
                                  prefill_mode="quantized", device="cuda")
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    n = read()
    want = cfg.n_layers * (n_chunks + N)
    tps = N / (gen_s - prefill_s)
    log(f"[24] quantized prefill {T0} tokens ({n_chunks} chunks of {chunk}) "
        f"{prefill_s:.3f} s; generate (prefill + {N} steps) {gen_s:.3f} s, "
        f"decode {tps:.2f} tok/s; launches {n} (K1 expected {want}, "
        f"{cfg.n_layers * n_chunks} of them chunks)")
    if not (n["K1"] == want and n["K1_chunk"] == cfg.n_layers * n_chunks
            and n["K2"] == n["K3"] == n["K4"] == n["K5"] == 0):
        raise AssertionError("MISTRAL_7B did not run K1 per layer and chunk")
    if not (toks.shape == (1, N) and int(toks.min()) >= 0
            and int(toks.max()) < cfg.vocab_size):
        raise AssertionError(f"bad tokens {toks.shape}")

    # the live cache: K1 against plain at the first and last layer, the
    # last decode position and the last chunk; the window is live
    arrs = cache.arrays()
    gen = torch.Generator(device="cuda").manual_seed(25)
    G = cfg.q_per_kv
    worst, moved = 0.0, 0.0
    for tq, p0 in ((1, T0 + N), (chunk, S + (n_chunks - 1) * chunk)):
        q = torch.randn((1, cfg.n_kv_heads, G * tq, cfg.d_head),
                        generator=gen, device="cuda")
        pos = torch.tensor([p0], dtype=torch.int32, device="cuda")
        for li in (0, cfg.n_layers - 1):
            for d in (dcfg, dataclasses.replace(dcfg, dot_bf16=False)):
                args = (q, arrs["k_planes"], arrs["v_planes"],
                        arrs["kv_out"], dq.k_range, dq.k_offset,
                        arrs["v_scale"], arrs["v_offset"], arrs["k_sink"],
                        arrs["v_sink"], dq.k_lut_dec, dq.v_lut_dec, li, pos,
                        d)
                got = fd.flash_attention(*args, cfg, Tq=tq)
                worst = max(worst, agree(
                    f"[24] live cache layer {li} Tq {tq} pos {p0}", got,
                    fd.flash_attention_ref(*args, cfg, Tq=tq), d.dot_bf16))
                if tq == 1:
                    full = fd.flash_attention(
                        *args, dataclasses.replace(cfg, sliding_window=None),
                        Tq=tq)
                    moved = max(moved, float((got - full).abs().max()
                                             / got.abs().max()))
    log(f"[24] window live: K1 at position {T0 + N} with the window against "
        f"the same call without it: max |diff| / max|out| {moved:.3e}")
    if not moved > 1e-2:
        raise AssertionError("the sliding window changed nothing")
    tok = toks[:, -1]
    _, idle = decode_profile(
        f"[24] {T0 + N} ctx", lambda i: engine.decode_step(
            params, cfg, dcfg, dq, cache, tok, T0 + N + i), 8)
    report["mistral"] = dict(prefill_s=prefill_s, decode_tps=tps,
                             k1_launches=n["K1"], max_abs_err=worst,
                             idle=idle)
    del cache, arrs, params
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# DBRX (the MoE family, G 6) through K1, K2 and K3 / K4
# ---------------------------------------------------------------------------

# databricks/dbrx-base config.json (Hugging Face Hub): the widths phase 25
# runs at; its depth (40 layers) is cut to DBRX_LAYERS so that one card
# holds the bf16 weights
DBRX_CONFIG = {
    "model_type": "dbrx", "d_model": 6144, "n_heads": 48, "n_layers": 40,
    "max_seq_len": 32768, "vocab_size": 100352,
    "attn_config": {"kv_n_heads": 8, "rope_theta": 500000, "clip_qkv": 8},
    "ffn_config": {"ffn_hidden_size": 10752, "moe_num_experts": 16,
                   "moe_top_k": 4},
}
DBRX_LAYERS = 8
_ST_DTYPES = {torch.bfloat16: "BF16", torch.float16: "F16",
              torch.float32: "F32"}


def write_safetensors(path, tensors):
    """A .safetensors file without the safetensors package: an 8-byte
    little-endian header length, the JSON header, the raw bytes."""
    import struct

    header, blobs, off = {}, [], 0
    for name, t in tensors.items():
        b = t.detach().contiguous().cpu().view(torch.uint8).numpy().tobytes()
        header[name] = {"dtype": _ST_DTYPES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [off, off + len(b)]}
        blobs.append(b)
        off += len(b)
    h = json.dumps(header).encode()
    h += b" " * (-len(h) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(h)) + h)
        for b in blobs:
            f.write(b)


def dbrx_checkpoint_check(work):
    """A DBRX-schema BF16 checkpoint of 2 layers at narrow widths (G 6),
    written by ``write_safetensors`` and loaded onto the card through
    ``load_hf_checkpoint``: every parameter equal to the same tensors
    placed in memory; a forward on it is finite."""
    import os

    from kvquant_tpu_torch.models import get_forward
    from kvquant_tpu_torch.models.hf_loader import load_hf_checkpoint

    D, H, Hkv, L, E, Fd, V = 384, 12, 2, 2, 4, 128, 512
    Dh = D // H
    path = os.path.join(work, "dbrx_small")
    os.makedirs(path, exist_ok=True)
    cfgj = dict(DBRX_CONFIG, d_model=D, n_heads=H, n_layers=L, vocab_size=V,
                attn_config=dict(DBRX_CONFIG["attn_config"], kv_n_heads=Hkv),
                ffn_config=dict(DBRX_CONFIG["ffn_config"],
                                ffn_hidden_size=Fd, moe_num_experts=E,
                                moe_top_k=2))
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(cfgj, f)
    g = torch.Generator().manual_seed(250)

    def r(*shape):
        return (torch.randn(shape, generator=g) * 0.05).to(torch.bfloat16)

    t = {"transformer.wte.weight": r(V, D), "lm_head.weight": r(V, D),
         "transformer.norm_f.weight": 1 + r(D)}
    for i in range(L):
        p = f"transformer.blocks.{i}."
        t[p + "norm_attn_norm.attn.Wqkv.weight"] = r((H + 2 * Hkv) * Dh, D)
        t[p + "norm_attn_norm.attn.out_proj.weight"] = r(D, H * Dh)
        t[p + "norm_attn_norm.norm_1.weight"] = 1 + r(D)
        t[p + "norm_attn_norm.norm_2.weight"] = 1 + r(D)
        t[p + "ffn.router.layer.weight"] = r(E, D)
        for n in ("w1", "v1", "w2"):
            t[p + f"ffn.experts.mlp.{n}"] = r(E * Fd, D)
    fname = os.path.join(path, "model.safetensors")
    write_safetensors(fname, t)
    params, cfg = load_hf_checkpoint(path, dtype=torch.bfloat16,
                                     device="cuda")

    def blk(name):
        return torch.stack([t[f"transformer.blocks.{i}.{name}"]
                            for i in range(L)])

    want = {
        "w_qkv": blk("norm_attn_norm.attn.Wqkv.weight").transpose(1, 2),
        "wo": blk("norm_attn_norm.attn.out_proj.weight").transpose(1, 2),
        "w_router": blk("ffn.router.layer.weight").transpose(1, 2),
        "w_gate": blk("ffn.experts.mlp.w1").reshape(L, E, Fd, D)
        .transpose(2, 3),
        "w_up": blk("ffn.experts.mlp.v1").reshape(L, E, Fd, D)
        .transpose(2, 3),
        "w_down": blk("ffn.experts.mlp.w2").reshape(L, E, Fd, D),
        "ln_attn": blk("norm_attn_norm.norm_1.weight").float(),
        "ln_mlp": blk("norm_attn_norm.norm_2.weight").float(),
    }
    same = all(torch.equal(params.layers[k].cpu(), v)
               for k, v in want.items())
    same &= torch.equal(params.embed.cpu(), t["transformer.wte.weight"])
    same &= torch.equal(params.lm_head.cpu(), t["lm_head.weight"].T)
    same &= torch.equal(params.final_norm.cpu(),
                        t["transformer.norm_f.weight"].float())
    logits, _ = get_forward(cfg)(params, cfg, torch.randint(
        0, V, (1, 32), generator=g).cuda())
    log(f"[25] DBRX-schema checkpoint (2 layers, d {D}, {H} / {Hkv} heads, "
        f"{E} experts top 2, BF16, {os.path.getsize(fname) / 1e6:.1f} MB) "
        f"through load_hf_checkpoint onto the card: {type(params).__name__}, "
        f"{cfg.ffn_mode} {cfg.norm_type}; every parameter equal to the "
        f"tensors in memory: {same}; forward finite: "
        f"{bool(torch.isfinite(logits).all())}")
    if not (same and bool(torch.isfinite(logits).all())):
        raise AssertionError("the loader's parameters differ from the file")


def dbrx_speed_config(cfg, max_len, n_layers):
    """The speed config at DBRX's 8 kv heads: int4, post-RoPE K, 16 static
    K channels per head group of 8, no slots, sink 5, K2."""
    from kvquant_tpu_torch.cache import DeployConfig
    from kvquant_tpu_torch.quant.artifacts import (
        KQuantizer, VQuantizer, LayerQuantizers, QuantizerSet)

    dcfg = DeployConfig.create(
        bits=4, n_kv_heads=cfg.n_kv_heads, d_head=cfg.d_head,
        max_len=max_len, sink=5, kernel="flash_serial", head_group=8,
        codes="int4", post_rope_k=True, k_outliers="channels", n_kc=16,
        cap_per_side=0)
    rng = np.random.default_rng(0)
    lut = np.linspace(-1, 1, 16, dtype=np.float32)
    layers = []
    for _ in range(n_layers):
        u = (np.abs(rng.normal(size=cfg.kv_hidden)) * 2 + 1).astype(np.float32)
        layers.append(LayerQuantizers(
            k=KQuantizer(upper=u, lower=(-u * 0.9).astype(np.float32),
                         lut=lut.copy(),
                         ressc=rng.random(cfg.kv_hidden).astype(np.float32)),
            v=VQuantizer(lut=lut.copy())))
    qs = QuantizerSet(layers=layers, bits=4, sparsity_threshold=0.99,
                      cap_outliers=True, first_few_fp16=5)
    return dcfg, qs


ATTN_KERNEL = ("fd_", "fs_", "qk_", "pv_")  # the port's kernels' names


def moe_profile(tag, step, steps, prof_steps=3):
    """``decode_profile`` for an MoE model, with the device time of a step
    split into the expert FFN, the attention kernel (the port's CUDA
    kernels) and the rest. The expert FFN is the ATen kernels launched
    inside ``moe.moe_ffn``, marked by a profiler range, plus the expert
    products' kernels by name (moe_glu, moe_down): the profiler does not
    attribute a kernel launched through ctypes to the range. Returns
    (tok/s, dict of device ms per step and the idle share)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from kvquant_tpu_torch.models import moe

    for i in range(2):
        step(i)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(steps):
        step(2 + i)
    torch.cuda.synchronize()
    tps = steps / (time.perf_counter() - t0)
    ffn = moe.moe_ffn

    def marked(*a, **k):
        with record_function("expert_ffn"):
            return ffn(*a, **k)

    moe.moe_ffn = marked
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for i in range(prof_steps):
                step(2 + steps + i)
            torch.cuda.synchronize()
    finally:
        moe.moe_ffn = ffn
    # kernels only: the range's own device-side span is not a kernel
    ev = [e for e in prof.key_averages()
          if e.device_type == torch.autograd.DeviceType.CUDA
          and e.self_device_time_total > 0 and e.key != "expert_ffn"]
    dev_ms = sum(e.self_device_time_total for e in ev) / prof_steps / 1e3
    attn_ms = sum(e.self_device_time_total for e in ev
                  if any(k in e.key for k in ATTN_KERNEL)) / prof_steps / 1e3
    range_ms = sum(e.device_time_total for e in prof.events()
                   if e.name == "expert_ffn"
                   and e.device_type == torch.autograd.DeviceType.CPU
                   ) / prof_steps / 1e3
    products_ms = sum(e.self_device_time_total for e in ev
                      if any(f"::{k}<" in e.key
                             for k in ("moe_glu", "moe_down"))
                      ) / prof_steps / 1e3
    expert_ms = range_ms + products_ms
    idle = 1 - dev_ms * tps / 1e3
    log(f"{tag} decode {tps:.2f} tok/s (host wall time, {steps} steps); "
        f"profiler over {prof_steps} steps: device {dev_ms:.3f} ms/step = "
        f"expert FFN {expert_ms:.3f} (its range {range_ms:.3f} + the expert "
        f"products {products_ms:.3f}) + attention kernel {attn_ms:.3f} + rest "
        f"{dev_ms - expert_ms - attn_ms:.3f}; {1e3 / tps:.3f} ms/step "
        f"unprofiled wall (device idle share {idle:.3f}); "
        f"{sum(e.count for e in ev) / prof_steps:.0f} kernels/step")
    for e in sorted(ev, key=lambda e: -e.self_device_time_total)[:6]:
        log(f"{tag}   {e.self_device_time_total / prof_steps / 1e3:8.3f} "
            f"ms/step  x{e.count // prof_steps:5d}  {e.key[:90]}")
    return tps, dict(device_ms=dev_ms, expert_ms=expert_ms,
                     expert_products_ms=products_ms, attn_ms=attn_ms,
                     rest_ms=dev_ms - expert_ms - attn_ms, idle=idle)


def k2_odd_g_check(tag):
    """K2 at G 3 and 6 (padded to the 4 / 8 row instances) against its
    plain version: int4 / int4x2 / int8 x channels / slots x both dot
    modes, B=2 at unequal positions, a sliding window on one case."""
    from kvquant_tpu_torch.cache import DeployConfig
    from kvquant_tpu_torch.models.config import ModelConfig
    from kvquant_tpu_torch.ops.kernels import flash_serial as fs

    dev = torch.device("cuda")
    L, B, Hkv, D, Tc = 2, 2, 4, 128, 1024
    worst = {False: 0.0, True: 0.0}
    n = 0
    read = reset_launches()
    for dot_bf16 in (False, True):
        for codes in ("int4", "int4x2", "int8"):
            for k_out in ("channels", "slots"):
                for G in (3, 6):
                    bits = {"int4": 4, "int8": 8, "int4x2": 2}[codes]
                    window = 300 if (codes, k_out) == ("int4", "slots") \
                        else None
                    dcfg = DeployConfig.create(
                        bits=bits, n_kv_heads=Hkv, d_head=D, max_len=Tc + 5,
                        sink=5, kernel="flash_serial", dot_bf16=dot_bf16,
                        head_group=4, codes=codes, post_rope_k=True,
                        k_outliers=k_out, n_kc=4,
                        cap_per_side=0 if k_out == "channels" else 2)
                    mcfg = ModelConfig(n_heads=Hkv * G, n_kv_heads=Hkv,
                                       d_head=D, sliding_window=window)
                    gen = torch.Generator(device=dev).manual_seed(260 + n)
                    ops = kernel_operands(dcfg, mcfg, L, B, G, Tc, gen, dev)
                    q = torch.randn((B, Hkv, G, D), generator=gen,
                                    device=dev)
                    pos = torch.tensor([5 + 200, 5 + Tc - 3],
                                       dtype=torch.int32, device=dev)
                    got = call(fs.flash_serial_decode, q, ops, 1, pos, dcfg,
                               mcfg)
                    want = call(fs.flash_serial_decode_ref, q, ops, 1, pos,
                                dcfg, mcfg)
                    check_case(f"{tag} K2 {codes} {k_out} G{G} "
                               f"win{window}", got, want, dot_bf16, worst)
                    n += 1
    launches = read()["K2"]
    log(f"{tag} K2 at G 3 / 6 == plain on {n // 2} cases x 2 dot modes "
        f"({launches} launches, one per call); worst |err| / bound: fp32 "
        f"dots {worst[False]:.3f}, bf16 dots {worst[True]:.3f}")
    if launches != n:
        raise AssertionError("K2 at G 3 / 6 did not launch once per call")
    return worst


def dbrx_kernel_times(tag, cfg):
    """The kernels at one DBRX layer (8 kv heads, G 6, D 128) over a 32K
    filled cache: K1 decode (the faithful nuq3: the route, the tensor-core
    decode body fd_gqa, beside the old routes forced in the same call:
    fd_chunk at Tq = 1 and the rows padded to 8 on fd_decode), K2 (speed
    config, fs_mma at 8 rows), K3 (R = 6: qk_gqa beside the 8-row
    qk_decode forced) and K4 (pv_decode's 8-row instance), K5 (B=4 x 8K:
    fd_gqa beside the rows padded to 8 on fd_decode); each route held to
    its plain version in both dot modes; bound by bytes as phases 5 / 9 /
    13 / 17 count them. Then the routing rows: K1 at G 4 (MISTRAL_7B's 32
    / 8 heads, its 4096-token window live at 32K) and G 8, K3 at R 4 and 8,
    each on fd_gqa / qk_gqa beside fd_decode / qk_decode, the new body held
    to plain with bf16 dots."""
    from kvquant_tpu_torch.models.config import MISTRAL_7B
    from kvquant_tpu_torch.ops.kernels import attention as at
    from kvquant_tpu_torch.ops.kernels import common
    from kvquant_tpu_torch.ops.kernels import flash_decode as fd
    from kvquant_tpu_torch.ops.kernels import flash_serial as fs
    from kvquant_tpu_torch.ops.kernels import paged_decode as pdk
    from kvquant_tpu_torch.paged import PagedPool

    dev = torch.device("cuda")
    ctx = 32768
    Hkv, G, D = cfg.n_kv_heads, cfg.q_per_kv, cfg.d_head
    one = dataclasses.replace(cfg, n_layers=1)
    rows = {}

    def best(fn):
        return min(device_ms(fn), device_ms(fn))

    def timed(name, kern, plain, nbytes, tokens, extra=""):
        ms = best(kern)
        plain_ms = device_ms(plain, n=2, reps=3, warmup=1)
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        rows[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound,
                          bytes=nbytes, ctx=tokens, **rows.get(name, {}))
        log(f"{tag} {name} at {tokens} tokens: kernel {ms:.4f} ms device, "
            f"plain {plain_ms:.3f} ms, bound {bound:.4f} ms by bytes "
            f"({nbytes / 1e6:.1f} MB at 3.35 TB/s){extra}")

    def k1_bytes(dcfg, live, g):
        return live * nuq_bytes_per_token(dcfg) + 4 * Hkv * D * (
            2 * dcfg.sink + 2 * g)

    # K1: the faithful config's decode row at G 6, the route and the old
    # routes forced
    _, dcfg, _ = faithful_config(ctx + 8, 1, one)
    gen = torch.Generator(device=dev).manual_seed(251)
    ops = k1_operands(dcfg, 1, 1, dcfg.cache_tokens, gen, dev)
    q = torch.randn((1, Hkv, G, D), generator=gen, device=dev)
    pos = torch.tensor([ctx - 1], dtype=torch.int32, device=dev)
    d32 = dataclasses.replace(dcfg, dot_bf16=False)

    def k1(d=dcfg, qq=q, body=None, p=pos, mcfg=one):
        return fd.flash_attention(
            qq, ops["k_planes"], ops["v_planes"], ops["kv_out"],
            ops["k_range"], ops["k_offset"], ops["v_scale"], ops["v_offset"],
            ops["k_sink"], ops["v_sink"], ops["k_lut"], ops["v_lut"], 0, p,
            d, mcfg, body=body)

    def k1_ref(d=dcfg, qq=q, p=pos, mcfg=one):
        return call(fd.flash_attention_ref, qq, ops, 0, p, d, mcfg)

    before = fd.flash_attention.gqa_launches
    err = max(agree(f"{tag} K1 G{G} decode (fd_gqa)", k1(), k1_ref(), True),
              agree(f"{tag} K1 G{G} decode", k1(d32), k1_ref(d32), False))
    if fd.flash_attention.gqa_launches - before != 1:
        raise AssertionError(f"K1 at G {G} with bf16 dots did not run fd_gqa")
    rows["K1"] = dict(route=fd.body(dcfg, G, 1), max_abs_err=err)
    q8 = torch.nn.functional.pad(q, (0, 0, 0, 8 - G))
    agree(f"{tag} K1 G{G} on fd_chunk at Tq = 1 (old route)", k1(body="mma"),
          k1_ref(), True)
    agree(f"{tag} K1 G{G} padded to fd_decode at 8 rows",
          k1(qq=q8, body="decode")[:, :, :G], k1_ref(), True)
    rows["K1"]["old_ms"] = {
        "fd_chunk": best(lambda: k1(body="mma")),
        "fd_decode_pad8": best(lambda: k1(qq=q8, body="decode"))}
    timed("K1", k1, k1_ref, k1_bytes(dcfg, ctx - dcfg.sink, G), ctx,
          f" (route {rows['K1']['route']}; the old routes in the same call: "
          f"fd_chunk {rows['K1']['old_ms']['fd_chunk']:.4f} ms, padded to 8 "
          f"on fd_decode {rows['K1']['old_ms']['fd_decode_pad8']:.4f} ms)")

    # K1 routing rows: G 4 (MISTRAL_7B, window live) and G 8 on fd_gqa
    # beside fd_decode, the same cache
    for g_r, mcfg in ((4, dataclasses.replace(MISTRAL_7B, n_layers=1)),
                      (8, dataclasses.replace(one, n_heads=Hkv * 8))):
        assert mcfg.n_kv_heads == Hkv and mcfg.q_per_kv == g_r
        qg = torch.randn((1, Hkv, g_r, D), generator=gen, device=dev)
        new = lambda: k1(qq=qg, body="gqa", mcfg=mcfg)  # noqa: E731
        old = lambda: k1(qq=qg, body="decode", mcfg=mcfg)  # noqa: E731
        e = agree(f"{tag} K1 G{g_r} on fd_gqa", new(),
                  k1_ref(qq=qg, mcfg=mcfg), True)
        win = mcfg.sliding_window
        live = min(ctx - dcfg.sink, win or ctx)
        rows[f"K1 G{g_r}"] = dict(
            ms=best(new), old_ms={"fd_decode": best(old)}, max_abs_err=e,
            bound_ms=k1_bytes(dcfg, live, g_r) / HBM_BYTES_PER_S * 1e3,
            route=fd.body(dcfg, g_r, 1), window=win, ctx=ctx)
        r = rows[f"K1 G{g_r}"]
        log(f"{tag} K1 G{g_r} at {ctx} tokens (window {win}): fd_gqa "
            f"{r['ms']:.4f} ms, fd_decode {r['old_ms']['fd_decode']:.4f} ms, "
            f"bound {r['bound_ms']:.4f}; route {r['route']}")

    # K3 / K4: decode rows R = G over the same capacity (kernel "pallas")
    dp = dataclasses.replace(dcfg, kernel="pallas")
    o = k34_operands(dp, 1, G, dp.cache_tokens, gen, dev)
    Tc = dp.cache_tokens
    code_b = Hkv * D * dp.bits // 8
    J, spk = dp.n_slots, dp.slots_per_kind

    def k3_bytes(r):
        return (Tc * (code_b + dp.n_groups * spk * 4 + Hkv * r * 4)
                + 4 * Hkv * D * (r + 2) + 4 * 2 ** dp.bits)

    for name, fn, ref, run, nbytes in (
            ("K3", at.qk_fused, at.qk_fused_ref,
             lambda f, d=dp: run_qk(f, o, d, one), k3_bytes(G)),
            ("K4", at.pv_fused, at.pv_fused_ref,
             lambda f, d=dp: run_pv(f, o, d),
             Tc * (code_b + dp.n_groups * (J - spk) * 4 + 8 + Hkv * G * 4)
             + 4 * Hkv * D * G + 4 * 2 ** dp.bits)):
        d32p = dataclasses.replace(dp, dot_bf16=False)
        rows[name] = dict(max_abs_err=max(
            agree(f"{tag} {name} R {G}", run(fn), run(ref), True),
            agree(f"{tag} {name} R {G}", run(fn, d32p), run(ref, d32p),
                  False)))
        extra = ""
        if name == "K3":
            rows[name]["route"] = at.qk_plan(dp, G, D, Tc, 1, Hkv, J,
                                             common.sm_count(dev)).body
            old = lambda: at.qk_fused(  # noqa: E731
                o["q"], o["k_planes"], o["kv_out"], o["k_range"],
                o["k_offset"], o["k_lut"], dp, one, body="decode")
            agree(f"{tag} K3 R {G} on the 8-row qk_decode (old route)",
                  old(), run(ref), True)
            rows[name]["old_ms"] = {"qk_decode": best(old)}
            extra = (f" (route {rows[name]['route']}; the 8-row qk_decode "
                     f"in the same call: "
                     f"{rows[name]['old_ms']['qk_decode']:.4f} ms)")
        timed(name, lambda: run(fn), lambda: run(ref), nbytes, ctx, extra)
    # K3 routing rows: R 4 and 8 on qk_gqa beside qk_decode
    for r_r in (4, 8):
        o_r = k34_operands(dp, 1, r_r, Tc, gen, dev)

        def k3(body, o_r=o_r):
            return at.qk_fused(o_r["q"], o_r["k_planes"], o_r["kv_out"],
                               o_r["k_range"], o_r["k_offset"], o_r["k_lut"],
                               dp, one, body=body)
        e = agree(f"{tag} K3 R{r_r} on qk_gqa", k3("gqa"),
                  run_qk(at.qk_fused_ref, o_r, dp, one), True)
        rows[f"K3 R{r_r}"] = dict(
            ms=best(lambda: k3("gqa")),
            old_ms={"qk_decode": best(lambda: k3("decode"))}, max_abs_err=e,
            bound_ms=k3_bytes(r_r) / HBM_BYTES_PER_S * 1e3,
            route=at.qk_plan(dp, r_r, D, Tc, 1, Hkv, J,
                             common.sm_count(dev)).body, ctx=Tc)
        r = rows[f"K3 R{r_r}"]
        log(f"{tag} K3 R{r_r} over Tc {Tc}: qk_gqa {r['ms']:.4f} ms, "
            f"qk_decode {r['old_ms']['qk_decode']:.4f} ms, bound "
            f"{r['bound_ms']:.4f}; route {r['route']}")
        del o_r
    del ops, o

    # K2: the speed config's decode row at G 6 (padded to fs_mma's 8)
    dcfg2, _ = dbrx_speed_config(one, ctx + 8, 1)
    ops = kernel_operands(dcfg2, one, 1, 1, G, dcfg2.cache_tokens, gen, dev)
    chan = fs.k_channel_index(ops["k_ressc"], dcfg2).to(torch.int32)

    def k2(f, d=dcfg2):
        return f(q, ops["k_planes"], ops["v_planes"], ops["kv_out"],
                 ops["k_range"], ops["k_offset"], ops["v_scale"],
                 ops["v_offset"], ops["k_sink"], ops["v_sink"], ops["k_lut"],
                 ops["v_lut"], 0, pos, d, one, k_chan=chan)

    d32 = dataclasses.replace(dcfg2, dot_bf16=False)
    rows["K2"] = dict(
        plan=repr(fs.fs_plan(dcfg2, 1, Hkv, G, D, dcfg2.cache_tokens, dev)),
        max_abs_err=max(
            agree(f"{tag} K2 G{G}", k2(fs.flash_serial_decode),
                  k2(fs.flash_serial_decode_ref), True),
            agree(f"{tag} K2 G{G}", k2(fs.flash_serial_decode, d32),
                  k2(fs.flash_serial_decode_ref, d32), False)))
    timed("K2", lambda: k2(fs.flash_serial_decode),
          lambda: k2(fs.flash_serial_decode_ref),
          (ctx - dcfg2.sink) * stored_bytes_per_token(dcfg2)
          + 4 * Hkv * D * (2 * dcfg2.sink + 2 * G), ctx,
          f" ({rows['K2']['plan']})")
    del ops

    # K5: B=4 slots of 8K in permuted pages of 1024, the faithful config
    B, P, c5 = 4, 1024, 8192
    _, dcfg5, _ = faithful_config(c5 + 8, 1, one)
    dcfg5 = dataclasses.replace(dcfg5, page_tokens=P)
    MP = c5 // P
    ops = k1_operands(dcfg5, 1, B * MP, P, gen, dev)
    sinks = k1_operands(dcfg5, 1, B, 128, gen, dev)
    pool = PagedPool(k_planes=ops["k_planes"], v_planes=ops["v_planes"],
                     kv_out=ops["kv_out"], v_scale=ops["v_scale"],
                     v_offset=ops["v_offset"], k_sink=sinks["k_sink"],
                     v_sink=sinks["v_sink"])
    dq = paged_dq(ops)
    table = torch.randperm(B * MP, generator=torch.Generator().manual_seed(
        252)).to(torch.int32).reshape(B, MP).to(dev)
    pos5 = torch.full((B,), c5 - 1, dtype=torch.int32, device=dev)
    q5 = torch.randn((B, Hkv, G, D), generator=gen, device=dev)
    q58 = torch.nn.functional.pad(q5, (0, 0, 0, 8 - G))
    run5 = lambda f, d=dcfg5, qq=q5: f(qq, pool, table, dq, 0, pos5, d,  # noqa
                                       one)
    d32 = dataclasses.replace(dcfg5, dot_bf16=False)
    before = pdk.paged_flash_decode.gqa_launches
    rows["K5"] = dict(
        plan=repr(pdk.paged_plan(dcfg5, B, Hkv, G, D, dcfg5.n_slots, c5,
                                 common.sm_count(dev))),
        max_abs_err=max(
            agree(f"{tag} K5 G{G} (fd_gqa)", run5(pdk.paged_flash_decode),
                  run5(pdk.paged_flash_decode_ref), True),
            agree(f"{tag} K5 G{G}", run5(pdk.paged_flash_decode, d32),
                  run5(pdk.paged_flash_decode_ref, d32), False)))
    if pdk.paged_flash_decode.gqa_launches - before != 1:
        raise AssertionError(f"K5 at G {G} with bf16 dots did not run fd_gqa")
    old5 = lambda: run5(pdk.paged_flash_decode, qq=q58)  # noqa: E731
    with old_routes():  # 8 rows on fd_decode
        agree(f"{tag} K5 G{G} padded to fd_decode at 8 rows (old route)",
              old5()[:, :, :G], run5(pdk.paged_flash_decode_ref), True)
        rows["K5"]["old_ms"] = {"fd_decode_pad8": best(old5)}
    timed("K5", lambda: run5(pdk.paged_flash_decode),
          lambda: run5(pdk.paged_flash_decode_ref),
          B * (c5 - dcfg5.sink) * nuq_bytes_per_token(dcfg5)
          + 4 * Hkv * D * (2 * dcfg5.sink + 2 * G) * B + 4 * B * MP, c5,
          f" per slot, B {B} ({rows['K5']['plan']}; padded to 8 on "
          f"fd_decode in the same call: "
          f"{rows['K5']['old_ms']['fd_decode_pad8']:.4f} ms)")
    del ops, pool
    torch.cuda.empty_cache()
    return rows


def toy_moe():
    """A toy MoE (12 / 2 heads, G 6, 4 experts top 2, sparse, LayerNorm;
    fp32 weights drawn on the CPU): (cfg, CPU params, the same on the card,
    kernel -> (QuantizerSet, DeployConfig)) for "flash_serial" (int4
    post-RoPE channels) and "flash" (nuq3 pre-RoPE slots)."""
    from kvquant_tpu_torch.cache import DeployConfig
    from kvquant_tpu_torch.models import moe
    from kvquant_tpu_torch.quant.artifacts import (
        KQuantizer, VQuantizer, LayerQuantizers, QuantizerSet)

    cfg = moe.MoEConfig(vocab_size=512, d_model=384, n_layers=2, n_heads=12,
                        n_kv_heads=2, d_head=32, d_ff=128, n_experts=4,
                        top_k=2, ffn_mode="sparse", norm_type="layernorm",
                        rope_theta=500000.0, max_seq_len=512)
    cpu = moe.init_params(cfg, torch.Generator().manual_seed(253),
                          dtype=torch.float32, device="cpu")
    tree = {"embed": cpu.embed.numpy(), "final_norm": cpu.final_norm.numpy(),
            "lm_head": cpu.lm_head.numpy(),
            "layers": {k: v.numpy() for k, v in cpu.layers.items()}}
    gpu = moe.params_from_numpy(tree, cfg, device="cuda")
    rng = np.random.default_rng(254)
    storage = {
        "flash_serial": (4, dict(codes="int4", post_rope_k=True,
                                 k_outliers="channels", n_kc=4,
                                 cap_per_side=0)),
        "flash": (3, dict(codes="nuq", post_rope_k=False,
                          k_outliers="slots", cap_per_side=2))}
    out = {}
    for kernel, (bits, kw) in storage.items():
        lut = np.linspace(-1, 1, 2 ** bits, dtype=np.float32)
        layers = []
        for _ in range(cfg.n_layers):
            u = (np.abs(rng.normal(size=cfg.kv_hidden)) + 0.5).astype(
                np.float32)
            layers.append(LayerQuantizers(
                k=KQuantizer(upper=u, lower=-u, lut=lut.copy(),
                             ressc=rng.random(cfg.kv_hidden).astype(
                                 np.float32)),
                v=VQuantizer(lut=lut.copy())))
        qs = QuantizerSet(layers=layers, bits=bits, sparsity_threshold=0.99,
                          cap_outliers=True, first_few_fp16=5)
        out[kernel] = (qs, DeployConfig.create(
            bits=bits, n_kv_heads=cfg.n_kv_heads, d_head=cfg.d_head,
            max_len=5 + 256 + 32, sink=5, kernel=kernel, head_group=2,
            dot_bf16=False, **kw))
    return cfg, cpu, gpu, out


def toy_moe_card_vs_cpu(tag):
    """The toy MoE (``toy_moe``) gives the same 16 greedy tokens on the
    card and on the CPU: through K2 (int4 post-RoPE channels) and through
    K1 (nuq3 pre-RoPE slots) with the fp16 and the quantized prefill."""
    from kvquant_tpu_torch import engine
    from kvquant_tpu_torch.cache import deployed_from_quantizers

    cfg, cpu, gpu, storage = toy_moe()
    prompt = torch.randint(0, cfg.vocab_size, (1, 16),
                           generator=torch.Generator().manual_seed(255))
    gcfg = engine.GenerateConfig(max_new_tokens=16)
    for kernel, (qs, dcfg) in storage.items():
        for mode in (("fp16",) if kernel == "flash_serial"
                     else ("fp16", "quantized")):
            out = {}
            for dev, params in (("cuda", gpu), ("cpu", cpu)):
                dq = deployed_from_quantizers(qs, cfg.n_kv_heads, cfg.d_head,
                                              device=dev)
                toks, _ = engine.generate(params, cfg, dcfg, dq, prompt,
                                          gcfg, prefill_mode=mode,
                                          device=dev)
                out[dev] = toks.cpu().tolist()
            same = out["cuda"] == out["cpu"]
            log(f"{tag} toy MoE (G 6, sparse), kernel {kernel}, prefill "
                f"{mode}, 16 greedy tokens: card == cpu: {same}")
            if not same:
                raise AssertionError(f"card {out['cuda']} != cpu "
                                     f"{out['cpu']}")


# moe_experts against its plain version: bf16 gate / up / silu * up and y
# are rounded in both, so a rounding flipped by another fp32 sum order
# moves an element by an ulp or two of bf16: |err| <= MOE_TOL x max|plain|
MOE_TOL = 2e-2


def moe_kernel_check(tag, lp, cfg):
    """``moe_experts`` against ``moe_experts_plain`` at one DBRX
    layer's weights (E 16, D 6144, F 10752, bf16): C 1 / 2 / 4 / 8 with
    counts drawn in 1..C and every third expert empty, and the slots of a
    batch of 4 identical tokens (C 2: each routed expert keeps tokens 0
    and 1, tokens 2 and 3 lose all four, so their FFN output is 0); then
    the main path's shape (C 1, the top_k experts of one token live)
    timed: the kernel, the plain version, per-expert ``torch.matmul`` on
    the live rows (the eager route before) and ``torch.bmm`` over all E
    experts (``swiglu_products``), device ms between CUDA events (median
    of 7), beside the byte bound (the live experts' weights, xe and y at
    3.35 TB/s). Returns the record for the kernels line."""
    import torch.nn.functional as F

    from kvquant_tpu_torch.models import moe
    from kvquant_tpu_torch.ops.kernels import moe_experts as mx

    E, D, Fd = cfg.n_experts, cfg.d_model, cfg.d_ff
    wts = (lp["w_gate"], lp["w_up"], lp["w_down"])
    gen = torch.Generator(device="cuda").manual_seed(251)
    cases = []
    for C in (1, 2, 4, 8):
        xe = torch.randn((E, C, D), generator=gen,
                         device="cuda").to(torch.bfloat16)
        count = torch.randint(1, C + 1, (E,), generator=gen, device="cuda",
                              dtype=torch.int32)
        count[::3] = 0
        cases.append((f"C {C}", xe, count))
    h = torch.randn((1, D), generator=gen, device="cuda").to(
        torch.bfloat16).expand(4, D).contiguous()
    _, w = moe._router_weights(h, lp, cfg)
    C4 = moe.capacity(4, cfg)
    s = moe.dispatch_slots(w, C4)
    xe4 = torch.cat([h, h.new_zeros((1, D))])[s.tokens]
    cases.append((f"4 identical tokens, C {C4}", xe4, s.count))
    worst = 0.0
    for name, xe, count in cases:
        got = mx.moe_experts(xe, count, *wts)
        want = mx.moe_experts_plain(xe, count, *wts)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        scale = float(want.float().abs().max())
        dead = torch.arange(xe.shape[1], device="cuda")[None] >= \
            count[:, None]
        log(f"{tag} moe_experts {name}, counts {count.tolist()}: "
            f"max|kernel-plain| {err:.3e} (tol {MOE_TOL * scale:.1e}, "
            f"max|plain| {scale:.3e})")
        if not (err <= MOE_TOL * scale and bool(torch.isfinite(got).all())
                and not got[dead].any()):
            raise AssertionError(f"{tag} moe_experts disagrees with plain: "
                                 f"{name}")
        worst = max(worst, err)
    ffn = moe.moe_ffn_sparse(h, lp, cfg)
    kept = s.keep.sum(1).tolist()
    log(f"{tag} 4 identical tokens: kept pairs per token {kept}; FFN rows "
        f"2-3 zero {not ffn[2:].any()}, rows 0 == 1 "
        f"{torch.equal(ffn[0], ffn[1])}")
    if not (kept == [cfg.top_k] * 2 + [0, 0] and not ffn[2:].any()
            and torch.equal(ffn[0], ffn[1]) and bool(ffn[0].any())):
        raise AssertionError(f"{tag} the overflowing batch: kept {kept}")

    # the main path's call: B=1, C 1, the router's top_k experts live
    xe1 = torch.randn((E, 1, D), generator=gen,
                      device="cuda").to(torch.bfloat16)
    count1 = torch.zeros((E,), dtype=torch.int32, device="cuda")
    live = torch.randperm(E, generator=gen, device="cuda")[:cfg.top_k]
    count1[live] = 1
    rows = {int(e): xe1[int(e)] for e in live.tolist()}

    def per_expert():
        for e, x in rows.items():
            (F.silu(x @ wts[0][e]) * (x @ wts[1][e])) @ wts[2][e]

    ms = {"ms": device_ms(lambda: mx.moe_experts(xe1, count1, *wts), n=10),
          "plain_ms": device_ms(lambda: mx.moe_experts_plain(
              xe1, count1, *wts), n=10),
          "library_ms": device_ms(lambda: mx.swiglu_products(xe1, *wts),
                                  n=10),
          "per_expert_matmul_ms": device_ms(per_expert, n=10)}
    nbytes = (cfg.top_k * 3 * D * Fd + 2 * E * D) * 2
    ms["bound_ms"] = nbytes / HBM_BYTES_PER_S * 1e3
    log(f"{tag} moe_experts at the decode shape (B=1: C 1, {cfg.top_k} of "
        f"{E} experts live): kernel {ms['ms']:.4f} ms, bound "
        f"{ms['bound_ms']:.4f} ms ({nbytes / 1e9:.3f} GB at 3.35 TB/s; "
        f"{ms['bound_ms'] / ms['ms']:.1%}), plain {ms['plain_ms']:.4f}, "
        f"per-expert torch.matmul {ms['per_expert_matmul_ms']:.4f}, "
        f"torch.bmm over all {E} experts {ms['library_ms']:.4f}")
    return dict(max_abs_err=worst, **ms)


def dbrx_graph_vs_eager(tag, params, cfg, dcfg, dq, cache, ctx, steps,
                        want, bounds):
    """DBRX decode graphed beside eager from clones of one cache
    at ``ctx``: ``steps`` greedy steps, tokens, every step's logits and the
    caches bitwise; device ms a step (replays back to back), wall / device
    and idle of each; a replay's trace: kernels, the port's kernels by
    name == the counters a step (``want``, moe_experts on every layer), the
    expert products' device ms (``moe_glu`` + ``moe_down``); capture s,
    pool MiB; one eager step under sync-debug "error" (an op that makes
    the host wait raises). ``bounds``: the expert weights' read at 3.35
    TB/s a step, (routed experts only, all experts), in ms."""
    from kvquant_tpu_torch import engine
    from kvquant_tpu_torch.cache import static_channels

    cache_g = clone_cache(cache)
    graph = engine.DecodeGraph(params, cfg, dcfg, dq, cache_g)
    k_chan = static_channels(dq, dcfg)

    def eager(tok, pos):
        return engine.decode_step(params, cfg, dcfg, dq, cache, tok, pos,
                                  k_chan=k_chan)[1]

    tok_e, lg_e, wall_e, n_e = greedy_run(eager, ctx, steps)
    tok_g, lg_g, wall_g, n_g = greedy_run(graph, ctx, steps)
    r = {"capture_s": graph.capture_s, "pool_mib": graph.pool_mib,
         "tokens_equal": bool(torch.equal(tok_e, tok_g)),
         "logits_bitwise": bitwise(lg_e, lg_g),
         "caches_equal": caches_equal(cache, cache_g),
         "finite": bool(torch.isfinite(lg_g).all())}
    per = {k: v / steps for k, v in n_g.items() if v}
    pos_end = torch.full((1,), ctx + steps, dtype=torch.int32, device="cuda")
    tok = tok_e[:, -1]
    dev = device_ms(lambda: graph(tok, pos_end), n=8, reps=3)
    for mode, step, wall in (("eager", eager, wall_e),
                             ("graphed", graph, wall_g)):
        kms, kern, own, own_ms = step_trace(
            lambda: step(tok, pos_end), n=2,
            kernels={**OWN_KERNELS, "moe_down": ("moe_down",)})
        wall_ms = wall / steps * 1e3
        moe_ms = {"moe_glu": own_ms.get("moe_experts", 0.0),
                  "moe_down": own_ms.get("moe_down", 0.0)}
        r[mode] = {"tok_s": steps / wall, "wall_ms": wall_ms,
                   "wall_per_device": wall_ms / dev, "idle": 1 - dev / wall_ms,
                   "kernel_ms": kms, "kernels": kern,
                   "moe_down_launches": own.pop("moe_down", 0.0),
                   "trace_launches": own,
                   "expert_products_ms": sum(moe_ms.values()),
                   "expert_products_by_name": moe_ms}
    torch.cuda.set_sync_debug_mode("error")
    try:
        eager(tok, pos_end)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    r.update(device_ms=dev, launches_per_step=per)
    e, g = r["eager"], r["graphed"]
    log(f"{tag} {ctx} ctx, {steps} steps: device {dev:.3f} ms a step "
        f"(graph replays); eager {e['tok_s']:.2f} tok/s (wall "
        f"{e['wall_ms']:.3f} ms, {e['wall_per_device']:.3f} x device, "
        f"idle {e['idle']:.3f}); graphed {g['tok_s']:.2f} tok/s (wall "
        f"{g['wall_ms']:.3f} ms, {g['wall_per_device']:.3f} x device, idle "
        f"{g['idle']:.3f}); kernels a replay {g['kernels']:.0f} "
        f"({g['kernel_ms']:.3f} kernel ms); the expert products "
        f"(moe_glu + moe_down) {g['expert_products_ms']:.3f} ms a graphed "
        f"step ({g['expert_products_by_name']}) against the expert weights' "
        f"read {bounds[0]:.2f} ms (routed) / {bounds[1]:.2f} ms (all "
        f"experts); launches a step {per}, "
        f"the port's kernels in a replay's trace {g['trace_launches']}; "
        f"capture {graph.capture_s:.3f} s, pool {graph.pool_mib:.1f} MiB; "
        f"graphed == eager: tokens {r['tokens_equal']}, logits bitwise "
        f"{r['logits_bitwise']}, caches {r['caches_equal']}; an eager step "
        f"under sync-debug \"error\" ran")
    if not (r["tokens_equal"] and r["logits_bitwise"] and r["caches_equal"]
            and r["finite"]):
        raise AssertionError(f"{tag}: graphed != eager")
    if n_e != n_g or per != want:
        raise AssertionError(f"{tag}: launches a step eager {n_e} graphed "
                             f"{n_g}, expected {want} a step")
    if not (e["trace_launches"] == g["trace_launches"] == want
            and e["moe_down_launches"] == g["moe_down_launches"]
            == want["moe_experts"]):
        raise AssertionError(
            f"{tag}: the trace a step {g['trace_launches']}, moe_down "
            f"{g['moe_down_launches']} (eager {e['trace_launches']}, "
            f"{e['moe_down_launches']}), counters {want}")
    del graph, cache_g
    return r


@contextlib.contextmanager
def old_routes():
    """The routes of 3-8 query rows per kv head as they were before the
    tensor-core decode bodies: K1 and K5 steps off fd_gqa (K1 on fd_chunk
    at Tq = 1 for 3 / 5 / 6 / 7 rows and on fd_decode at 4 / 8, K5 padded
    to fd_decode), K3 off qk_gqa (qk_decode's 4- or 8-row instance)."""
    from kvquant_tpu_torch.ops.kernels import attention as at
    from kvquant_tpu_torch.ops.kernels import flash_decode as fd

    saved = fd.GQA_ROWS, at.QK_GQA_ROWS
    fd.GQA_ROWS, at.QK_GQA_ROWS = (), ()
    try:
        yield
    finally:
        fd.GQA_ROWS, at.QK_GQA_ROWS = saved


STEP_NAMES = {n: (n,) for n in ("fd_gqa", "fd_decode", "fd_chunk", "qk_gqa",
                                "qk_decode", "pv_decode")}


def dbrx_long_step(params, cfg, dq, bounds, ctx=32768, steps=4):
    """DBRX's graphed decode step at ``ctx`` on a synthetic filled cache
    (the faithful nuq3 storage filled as phase 28 fills LLaMA's; ~0.22 GB
    at 8 layers) through ``flash`` (K1) and ``pallas`` (K3 / K4):
    ``dbrx_graph_vs_eager`` over ``steps`` steps (graphed == eager
    bitwise, device ms a step, wall / device), the attention kernels by
    name in a replay's trace; then the same step captured with the old
    routes forced (``old_routes``) in the same call, its device ms and
    kernels by name."""
    from kvquant_tpu_torch import engine

    L = cfg.n_layers
    _, dcfg, _ = faithful_config(ctx + steps + 8, L, cfg)
    cache = filled_cache(dcfg, L, ctx, 2532)
    tok = torch.zeros((1,), dtype=torch.int32, device="cuda")
    pos = torch.full((1,), ctx + steps, dtype=torch.int32, device="cuda")
    out = {"cache_gib": sum(t.numel() * t.element_size()
                            for t in cache.arrays().values()) / 2 ** 30}
    for path, d, want in (
            ("flash", dcfg, {"K1": L, "moe_experts": L}),
            ("pallas", dataclasses.replace(dcfg, kernel="pallas"),
             {"K3": L, "K4": L, "moe_experts": L})):
        tag = f"[25] {path} graphed {ctx}"
        r = dbrx_graph_vs_eager(tag, params, cfg, d, dq, cache, ctx, steps,
                                want, bounds)
        graph = engine.DecodeGraph(params, cfg, d, dq, clone_cache(cache))
        new_ms = device_ms(lambda: graph(tok, pos), n=8, reps=3)
        _, _, names, names_ms = step_trace(lambda: graph(tok, pos), n=2,
                                           kernels=STEP_NAMES)
        with old_routes():
            old = engine.DecodeGraph(params, cfg, d, dq, clone_cache(cache))
        old_ms = device_ms(lambda: old(tok, pos), n=8, reps=3)
        _, _, old_names, old_names_ms = step_trace(lambda: old(tok, pos), n=2,
                                                   kernels=STEP_NAMES)
        new_ms2 = device_ms(lambda: graph(tok, pos), n=8, reps=3)
        r.update(new_ms=(new_ms, new_ms2), old_ms=old_ms,
                 trace_names=names, trace_names_ms=names_ms,
                 old_trace_names=old_names, old_trace_names_ms=old_names_ms)
        log(f"{tag}: device {new_ms:.3f} / {new_ms2:.3f} ms a step "
            f"(new routes, before / after), {old_ms:.3f} with the old routes "
            f"forced (K1 fd_chunk, K3 8-row qk_decode), "
            f"{old_ms - min(new_ms, new_ms2):.3f} ms saved a step; by name a "
            f"step: new {names} {names_ms}, old {old_names} {old_names_ms}")
        want_new = {"flash": {"fd_gqa": L}, "pallas": {"qk_gqa": L,
                                                        "pv_decode": L}}[path]
        want_old = {"flash": {"fd_chunk": L},
                    "pallas": {"qk_decode": L, "pv_decode": L}}[path]
        if names != want_new or old_names != want_old:
            raise AssertionError(f"{tag}: kernels by name {names} (new) / "
                                 f"{old_names} (old routes)")
        out[path] = r
        del graph, old
    del cache
    torch.cuda.empty_cache()
    return out


def dbrx_prefill_graph(tag, params, cfg, dcfg, dq, prompt, chunk):
    """The quantized prefill of ``prompt`` through a chunk graph
    (chunk 0 eager, 1 the warm-up, replays after) beside every chunk
    eager: every chunk's logits and the caches bitwise; the wall of
    prefill_quantized both ways; capture s, pool MiB, launches a
    replay."""
    from kvquant_tpu_torch import engine
    from kvquant_tpu_torch.cache import create_cache

    S = dcfg.sink
    n_chunks = -(-(prompt.shape[1] - S) // chunk)
    toks = torch.nn.functional.pad(
        prompt, (0, n_chunks * chunk - (prompt.shape[1] - S)))
    walls = {}
    for mode in ("eager", "graphed"):
        cache = create_cache(dcfg, cfg.n_layers, 1, device="cuda")
        ctx = eager_prefill() if mode == "eager" \
            else contextlib.nullcontext()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with ctx:
            engine.prefill_quantized(params, cfg, dcfg, dq, cache, prompt,
                                     chunk=chunk)
        torch.cuda.synchronize()
        walls[mode] = time.perf_counter() - t0
        del cache
    ce = create_cache(dcfg, cfg.n_layers, 1, device="cuda")
    lg_e, _ = chunk_loop(params, cfg, dcfg, dq, ce, toks, chunk, False)
    cg = create_cache(dcfg, cfg.n_layers, 1, device="cuda")
    lg_g, graph = chunk_loop(params, cfg, dcfg, dq, cg, toks, chunk, True)
    r = {"eager_wall_s": walls["eager"], "graphed_wall_s": walls["graphed"],
         "capture_s": graph.capture_s, "pool_mib": graph.pool_mib,
         "launches_per_replay": dict(graph.launches),
         "logits_bitwise": all(bitwise(a, b) for a, b in zip(lg_e, lg_g)),
         "caches_equal": caches_equal(ce, cg),
         "finite": all(bool(torch.isfinite(x).all()) for x in lg_g)}
    log(f"{tag} quantized prefill {prompt.shape[1]} tokens ({n_chunks} "
        f"chunks of {chunk}): eager {walls['eager']:.3f} s, graphed "
        f"{walls['graphed']:.3f} s; chunk graph capture "
        f"{graph.capture_s:.3f} s, pool {graph.pool_mib:.1f} MiB, launches "
        f"a replay {r['launches_per_replay']}; every chunk's logits bitwise "
        f"{r['logits_bitwise']}, caches equal {r['caches_equal']}")
    if not (r["logits_bitwise"] and r["caches_equal"] and r["finite"]):
        raise AssertionError(f"{tag}: the chunk graph != eager chunks")
    del graph, ce, cg, lg_e, lg_g
    torch.cuda.empty_cache()
    return r


def dbrx_fp16_graph(tag, params, cfg, fcache, ctx, steps):
    """The fp16-KV baseline's step graphed beside eager from clones of
    one cache: tokens, logits, caches bitwise; device ms, tok/s."""
    from kvquant_tpu_torch import baseline_fp16

    ref = baseline_fp16.Fp16Cache(**{
        f.name: getattr(fcache, f.name).clone()
        for f in dataclasses.fields(fcache)})
    graph = baseline_fp16.DecodeGraph(params, cfg, fcache)
    tok_e, lg_e, wall_e, _ = greedy_run(
        lambda t, p: baseline_fp16.decode_step(params, cfg, ref, t, p)[1],
        ctx, steps)
    tok_g, lg_g, wall_g, _ = greedy_run(graph, ctx, steps)
    r = {"tokens_equal": bool(torch.equal(tok_e, tok_g)),
         "logits_bitwise": bitwise(lg_e, lg_g),
         "caches_equal": all(torch.equal(getattr(ref, n), getattr(fcache, n))
                             for n in ("k", "v", "length")),
         "eager_tok_s": steps / wall_e, "graphed_tok_s": steps / wall_g,
         "capture_s": graph.capture_s, "pool_mib": graph.pool_mib}
    # the replays timed at the next position write into the graph's cache
    # alone: after the comparison
    pos_end = torch.full((1,), ctx + steps, dtype=torch.int32, device="cuda")
    r["device_ms"] = dev = device_ms(lambda: graph(tok_e[:, -1], pos_end),
                                     n=8, reps=3)
    log(f"{tag} fp16-KV baseline {ctx} ctx, {steps} steps: device {dev:.3f} "
        f"ms a step; eager {r['eager_tok_s']:.2f} tok/s, graphed "
        f"{r['graphed_tok_s']:.2f} tok/s (wall / device "
        f"{1e3 / r['graphed_tok_s'] / dev:.3f}); capture "
        f"{graph.capture_s:.3f} s, pool {graph.pool_mib:.1f} MiB; graphed "
        f"== eager: tokens {r['tokens_equal']}, logits bitwise "
        f"{r['logits_bitwise']}, caches {r['caches_equal']}")
    if not (r["tokens_equal"] and r["logits_bitwise"] and r["caches_equal"]
            and bool(torch.isfinite(lg_g).all())):
        raise AssertionError(f"{tag}: the baseline graph != eager")
    del graph, ref
    return r


def toy_moe_server_graph(tag):
    """serve.Server on the toy MoE of ``toy_moe_card_vs_cpu`` (G 6, 4
    experts top 2, sparse, fp32 weights; nuq3 through K1) with 4 slots,
    6 requests and chunked admission: graphed (its DecodeGraph and the
    admission chunk graphs) == the same server stepping eagerly (the eager
    step in the graph's place, eager chunks), request by request;
    moe_experts launched on every layer of every step."""
    from kvquant_tpu_torch import engine, serve
    from kvquant_tpu_torch.cache import (deployed_from_quantizers,
                                         static_channels)
    from kvquant_tpu_torch.ops.kernels import launch_counts

    cfg, _, gpu, storage = toy_moe()
    qs, dcfg = storage["flash"]
    dq = deployed_from_quantizers(qs, cfg.n_kv_heads, cfg.d_head,
                                  device="cuda")
    rng = np.random.default_rng(256)
    reqs = [(rng.integers(0, cfg.vocab_size, size=int(n)).astype(np.int32),
             int(m)) for n, m in zip(rng.integers(20, 120, 6),
                                     rng.integers(6, 20, 6))]
    served, out = {}, {}
    for graphed in (False, True):
        srv = serve.Server(gpu, cfg, dcfg, dq, n_slots=4, seed=0,
                           admit_mode="chunked", device="cuda")
        if not graphed:
            srv._step = lambda t, p, srv=srv: engine.decode_step(
                gpu, cfg, dcfg, dq, srv.cache, t, p,
                k_chan=static_channels(dq, dcfg))[1]
        before = launch_counts()
        ctx = contextlib.nullcontext() if graphed else eager_prefill()
        t0 = time.perf_counter()
        with ctx:
            done = srv.run([serve.Request(rid=i, prompt=p, max_new_tokens=m)
                            for i, (p, m) in enumerate(reqs)])
        torch.cuda.synchronize()
        n = {k: v - before[k] for k, v in launch_counts().items()}
        served[graphed] = {rid: c.tokens for rid, c in done.items()}
        out["graphed" if graphed else "eager"] = dict(
            wall_s=time.perf_counter() - t0, steps=srv.decode_steps,
            moe_experts=n["moe_experts"], chunk_graphs=len(
                srv._adm.graphs) if srv._adm else 0)
        if n["moe_experts"] != cfg.n_layers * srv.decode_steps:
            raise AssertionError(f"{tag} serve: moe_experts "
                                 f"{n['moe_experts']}, steps "
                                 f"{srv.decode_steps}")
        del srv
    same = served[True] == served[False]
    g = out["graphed"]
    log(f"{tag} serve.Server, toy MoE (G 6, sparse, fp32), 4 slots, "
        f"{len(reqs)} requests, chunked admission: graphed tokens == eager "
        f"{same}; {g['steps']} decode steps, moe_experts {g['moe_experts']}, "
        f"{g['chunk_graphs']} admission chunk graphs; wall eager "
        f"{out['eager']['wall_s']:.3f} s, graphed {g['wall_s']:.3f} s")
    if not (same and g["chunk_graphs"]):
        raise AssertionError(f"{tag} serve: graphed != eager")
    out["equal"] = same
    return out


def phase_dbrx(report):
    """DBRX at its published widths through the loader's config (G 6, 16
    experts top 4, sparse dispatch, LayerNorm), cut to DBRX_LAYERS layers,
    random bf16 weights from a seed: the faithful nuq3 config through K1
    (2048-token quantized prefill, 32 greedy tokens), the speed config
    through K2 and kernel "pallas" through K3 / K4 (16 tokens each), each
    kernel held to its plain version on the live cache; the graphed step
    at 32K on a filled cache through K1 and K3 / K4, beside the same step
    with the G 3-8 routes of before the tensor-core decode bodies forced;
    then the G 6 routes alone (the new bodies beside the old routes, and
    the G 4 / G 8 routing rows), K1's and K5's edge grids at G 3 / 5 / 6 /
    7, K3's qk_gqa grid, a toy MoE card == CPU, and the fp16-KV baseline
    on the same weights."""
    import os
    import shutil

    from kvquant_tpu_torch import baseline_fp16, engine
    from kvquant_tpu_torch.cache import create_cache, deployed_from_quantizers
    from kvquant_tpu_torch.models import moe
    from kvquant_tpu_torch.models.hf_loader import config_from_hf
    from kvquant_tpu_torch.ops.kernels import attention as at
    from kvquant_tpu_torch.ops.kernels import flash_decode as fd
    from kvquant_tpu_torch.ops.kernels import flash_serial as fs

    root = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(root, "kvquant_tpu_torch", "_build", "smoke_dbrx")
    os.makedirs(work, exist_ok=True)
    dbrx_checkpoint_check(work)

    # the published config, read through the port's loader; depth cut
    with open(os.path.join(work, "config.json"), "w") as f:
        json.dump(DBRX_CONFIG, f)
    full = config_from_hf(work)
    cfg = dataclasses.replace(full, n_layers=DBRX_LAYERS)
    G = cfg.q_per_kv
    if not (isinstance(cfg, moe.MoEConfig) and G == 6 and cfg.d_head == 128
            and cfg.ffn_mode == "sparse" and cfg.norm_type == "layernorm"):
        raise AssertionError(f"unexpected DBRX config {cfg}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = moe.init_params(cfg, torch.Generator(device="cuda")
                             .manual_seed(25), dtype=torch.bfloat16,
                             device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    nbytes = {k: v.numel() * v.element_size()
              for k, v in params.named_parameters()}
    w_gib = sum(nbytes.values()) / 2 ** 30
    expert_b = sum(nbytes[f"layers.{k}"] for k in ("w_gate", "w_up",
                                                   "w_down"))
    other_b = sum(nbytes.values()) - expert_b - nbytes["embed"]
    routed_b = expert_b * cfg.top_k // cfg.n_experts
    log(f"[25] DBRX (databricks/dbrx-base config via config_from_hf): "
        f"d_model {cfg.d_model}, {cfg.n_heads} / {cfg.n_kv_heads} heads "
        f"(G {G}), {cfg.n_experts} experts top {cfg.top_k}, ffn "
        f"{cfg.d_ff}, vocab {cfg.vocab_size}, {cfg.n_layers} of "
        f"{full.n_layers} layers; bf16 weights {w_gib:.2f} GiB (experts "
        f"{expert_b / 2 ** 30:.2f} GiB) initialised in {init_s:.1f} s, "
        f"peak {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    # a decode step's weight reads (B=1): the routed experts only, or all
    step_routed = (routed_b + other_b) / HBM_BYTES_PER_S * 1e3
    step_all = (expert_b + other_b) / HBM_BYTES_PER_S * 1e3
    ffn_routed = routed_b / HBM_BYTES_PER_S * 1e3
    ffn_all = expert_b / HBM_BYTES_PER_S * 1e3
    log(f"[25] bounds of a decode step's weight reads at 3.35 TB/s: routed "
        f"experts only {(routed_b + other_b) / 1e9:.1f} GB = "
        f"{step_routed:.2f} ms (expert FFN {routed_b / 1e9:.1f} GB = "
        f"{ffn_routed:.2f} ms); all experts "
        f"{(expert_b + other_b) / 1e9:.1f} GB = {step_all:.2f} ms (expert "
        f"FFN {expert_b / 1e9:.1f} GB = {ffn_all:.2f} ms)")
    out = dict(weights_gib=w_gib, init_s=init_s,
               bound_step_routed_ms=step_routed, bound_step_all_ms=step_all,
               bound_ffn_routed_ms=ffn_routed, bound_ffn_all_ms=ffn_all)
    out["moe_experts"] = moe_kernel_check("[25]", params.layer(0), cfg)
    L = cfg.n_layers

    T0, N, N2, chunk = 2048, 32, 16, 256
    max_len = T0 + N + 24
    prompt = torch.randint(0, cfg.vocab_size, (1, T0),
                           generator=torch.Generator().manual_seed(26)).cuda()
    gen = torch.Generator(device="cuda").manual_seed(27)

    # ---- the faithful nuq3 config through K1 ----
    _, dcfg, qs = faithful_config(max_len, cfg.n_layers, cfg)
    dq = deployed_from_quantizers(qs, cfg.n_kv_heads, cfg.d_head,
                                  device="cuda")
    S = dcfg.sink
    n_chunks = -(-(T0 - S) // chunk)
    cache = create_cache(dcfg, cfg.n_layers, 1, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.prefill_quantized(params, cfg, dcfg, dq, cache, prompt,
                             chunk=chunk)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    del cache
    out["prefill_graph"] = dbrx_prefill_graph(
        "[25] flash nuq3", params, cfg, dcfg, dq, prompt, chunk)
    read = reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks, cache = engine.generate(params, cfg, dcfg, dq, prompt,
                                  engine.GenerateConfig(max_new_tokens=N),
                                  prefill_mode="quantized", device="cuda")
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    n = read()
    want = cfg.n_layers * (n_chunks + N)
    log(f"[25] faithful nuq3 (pre-RoPE, slots cap 2, hg 4, sink 5), kernel "
        f"flash: quantized prefill {T0} tokens ({n_chunks} chunks of "
        f"{chunk}, {G * chunk} rows a kv head) {prefill_s:.3f} s; generate "
        f"(prefill + {N} steps) {gen_s:.3f} s, decode "
        f"{N / (gen_s - prefill_s):.2f} tok/s; launches {n} (K1 expected "
        f"{want}: the chunks on fd_chunk, the decode steps at G {G} on "
        f"fd_gqa)")
    if not (n["K1"] == want and n["K1_chunk"] == cfg.n_layers * n_chunks
            and n["K1_gqa"] == cfg.n_layers * N
            and n["K2"] == n["K3"] == n["K4"] == n["K5"] == 0
            and n["moe_experts"] == cfg.n_layers * N):
        raise AssertionError("DBRX did not run K1 per layer, chunk (fd_chunk)"
                             " and step (fd_gqa), and moe_experts per layer "
                             "and step")
    if not (toks.shape == (1, N) and int(toks.min()) >= 0
            and int(toks.max()) < cfg.vocab_size):
        raise AssertionError(f"bad tokens {toks.shape}")
    arrs = cache.arrays()
    worst = 0.0
    for tq, p0 in ((1, T0 + N), (chunk, S + (n_chunks - 1) * chunk)):
        q = torch.randn((1, cfg.n_kv_heads, G * tq, cfg.d_head),
                        generator=gen, device="cuda")
        pos = torch.tensor([p0], dtype=torch.int32, device="cuda")
        for li in (0, cfg.n_layers - 1):
            for d in (dcfg, dataclasses.replace(dcfg, dot_bf16=False)):
                args = (q, arrs["k_planes"], arrs["v_planes"],
                        arrs["kv_out"], dq.k_range, dq.k_offset,
                        arrs["v_scale"], arrs["v_offset"], arrs["k_sink"],
                        arrs["v_sink"], dq.k_lut_dec, dq.v_lut_dec, li, pos,
                        d, cfg)
                worst = max(worst, agree(
                    f"[25] K1 live cache layer {li} Tq {tq} pos {p0}",
                    fd.flash_attention(*args, Tq=tq),
                    fd.flash_attention_ref(*args, Tq=tq), d.dot_bf16))
    tok = toks[:, -1]
    tps, prof = moe_profile(f"[25] flash {T0 + N} ctx", lambda i: engine.
                            decode_step(params, cfg, dcfg, dq, cache, tok,
                                        T0 + N + i), 8)
    out["flash"] = dict(prefill_s=prefill_s, decode_tps=tps,
                        k1_launches=n["K1"], k1_gqa_launches=n["K1_gqa"],
                        max_abs_err=worst,
                        moe_launches=n["moe_experts"], **prof)
    out["flash"]["graph"] = dbrx_graph_vs_eager(
        "[25] flash graphed", params, cfg, dcfg, dq, cache, T0 + N, 16,
        {"K1": L, "moe_experts": L}, (ffn_routed, ffn_all))
    del cache, arrs
    torch.cuda.empty_cache()

    # ---- kernel "pallas": K3 / K4 on the same storage ----
    dcfg_p = dataclasses.replace(dcfg, kernel="pallas")
    read = reset_launches()
    toks, cache = engine.generate(params, cfg, dcfg_p, dq, prompt,
                                  engine.GenerateConfig(max_new_tokens=N2),
                                  device="cuda")
    torch.cuda.synchronize()
    n = read()
    log(f"[25] kernel pallas, fp16 prefill {T0} + {N2} greedy tokens: "
        f"launches {n} (K3 / K4 expected {cfg.n_layers * N2} each, K3 on "
        f"qk_gqa)")
    if not (n["K3"] == n["K4"] == n["moe_experts"] == cfg.n_layers * N2
            == n["K3_gqa"] and n["K1"] == n["K2"] == n["K5"] == 0):
        raise AssertionError("DBRX pallas did not run K3 (qk_gqa) / K4 per "
                             "step")
    k34 = live_k34_check("[25] live cache", cache, dq, dcfg_p, cfg,
                         (0, cfg.n_layers - 1), gen, rs=(G, G * chunk))
    tok = toks[:, -1]
    tps, prof = moe_profile(f"[25] pallas {T0 + N2} ctx", lambda i: engine.
                            decode_step(params, cfg, dcfg_p, dq, cache, tok,
                                        T0 + N2 + i), 8)
    out["pallas"] = dict(decode_tps=tps, k3_launches=n["K3"],
                         k3_gqa_launches=n["K3_gqa"],
                         k4_launches=n["K4"], max_abs_err=k34,
                         moe_launches=n["moe_experts"], **prof)
    out["pallas"]["graph"] = dbrx_graph_vs_eager(
        "[25] pallas graphed", params, cfg, dcfg_p, dq, cache, T0 + N2, 16,
        {"K3": L, "K4": L, "moe_experts": L}, (ffn_routed, ffn_all))
    del cache
    torch.cuda.empty_cache()

    # ---- the graphed step at 32K, new routes beside the old ones ----
    out["step_32k"] = dbrx_long_step(params, cfg, dq, (ffn_routed, ffn_all))

    # ---- the speed config through K2 (G 6 padded to fs_mma's 8 rows) ----
    dcfg2, qs2 = dbrx_speed_config(cfg, max_len, cfg.n_layers)
    dq2 = deployed_from_quantizers(qs2, cfg.n_kv_heads, cfg.d_head,
                                   device="cuda")
    read = reset_launches()
    toks, cache = engine.generate(params, cfg, dcfg2, dq2, prompt,
                                  engine.GenerateConfig(max_new_tokens=N2),
                                  device="cuda")
    torch.cuda.synchronize()
    n = read()
    routes = dict(fs.flash_serial_decode.route_launches)
    log(f"[25] speed config (int4, post-RoPE, 16 static K channels, hg 8), "
        f"kernel flash_serial, fp16 prefill {T0} + {N2} greedy tokens: "
        f"launches {n}, per body {routes} (K2 expected "
        f"{cfg.n_layers * N2}, all fs_mma)")
    if not (n["K2"] == cfg.n_layers * N2 == routes["fs_mma"]
            == n["moe_experts"]
            and n["K1"] == n["K3"] == n["K4"] == n["K5"] == 0):
        raise AssertionError("DBRX speed config did not run K2 per step")
    arrs = cache.arrays()
    q = torch.randn((1, cfg.n_kv_heads, G, cfg.d_head), generator=gen,
                    device="cuda")
    pos = torch.tensor([T0 + N2], dtype=torch.int32, device="cuda")
    worst = 0.0
    for li in (0, cfg.n_layers - 1):
        for d in (dcfg2, dataclasses.replace(dcfg2, dot_bf16=False)):
            args = (q, arrs["k_planes"], arrs["v_planes"], arrs["kv_out"],
                    dq2.k_range, dq2.k_offset, arrs["v_scale"],
                    arrs["v_offset"], arrs["k_sink"], arrs["v_sink"],
                    dq2.k_lut_dec, dq2.v_lut_dec, li, pos, d, cfg)
            worst = max(worst, agree(
                f"[25] K2 live cache layer {li}",
                fs.flash_serial_decode(*args, k_ressc=dq2.k_ressc),
                fs.flash_serial_decode_ref(*args, k_ressc=dq2.k_ressc),
                d.dot_bf16))
    tok = toks[:, -1]
    tps, prof = moe_profile(f"[25] flash_serial {T0 + N2} ctx", lambda i:
                            engine.decode_step(params, cfg, dcfg2, dq2, cache,
                                               tok, T0 + N2 + i), 8)
    out["flash_serial"] = dict(decode_tps=tps, k2_launches=n["K2"],
                               max_abs_err=worst,
                               moe_launches=n["moe_experts"], **prof)
    out["flash_serial"]["graph"] = dbrx_graph_vs_eager(
        "[25] flash_serial graphed", params, cfg, dcfg2, dq2, cache,
        T0 + N2, 16, {"K2": L, "moe_experts": L}, (ffn_routed, ffn_all))
    del cache, arrs
    torch.cuda.empty_cache()

    # ---- the fp16-KV baseline on the same weights (context only) ----
    fcache = baseline_fp16.create_fp16_cache(cfg, max_len, 1, device="cuda")
    baseline_fp16.prefill(params, cfg, fcache, prompt)
    tok = torch.zeros((1,), dtype=torch.int32, device="cuda")
    out["fp16_baseline_tps"], _ = decode_profile(
        f"[25] fp16-KV baseline {T0} ctx", lambda i: baseline_fp16.
        decode_step(params, cfg, fcache, tok, T0 + i), 8, prof_steps=0)
    out["fp16_graph"] = dbrx_fp16_graph("[25]", params, cfg, fcache, T0, 16)
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"[25] peak device memory {out['peak_gib']:.2f} GiB")
    del fcache, params
    torch.cuda.empty_cache()

    # ---- the G 6 routes alone; edge grids at G 3 / 6; toy card == CPU ----
    out["times"] = dbrx_kernel_times("[25]", cfg)
    out["k2_odd_g"] = k2_odd_g_check("[25]")
    modes = (("nuq", 2), ("nuq", 3), ("nuq", 4), ("int4", 4), ("int8", 8),
             ("int4x2", 2))
    out["k1_edges"] = decode_edge_grid("[25]", modes, paged=False, odd_g=True)
    out["k5_edges"] = decode_edge_grid("[25]", modes, paged=True, odd_g=True)
    out["k3_gqa_grid"] = k3_gqa_grid("[25]")
    toy_moe_card_vs_cpu("[25]")
    out["serve_graph"] = toy_moe_server_graph("[25]")
    report["dbrx"] = out
    shutil.rmtree(work)


# ---------------------------------------------------------------------------
# tensor parallelism (kvquant_tpu_torch/parallel): tp 2 as two rank
# processes sharing the card over gloo
# ---------------------------------------------------------------------------

TP_WORKLOADS = ("llama_k1", "llama_k2", "dbrx_k1")


def tp_workload(name, work):
    """(model config, deploy config, quantizers, prompt, decode steps,
    prefill mode, kernel, weight seed) of a phase-26 workload: LLaMA-2-7B
    through K1 (faithful nuq3, 2048-token quantized prefill, 16 steps) and
    K2 (the speed config, one head group of 16 on each rank, 1024-token
    prefill, 8 steps); DBRX at its published widths cut to 2 of 40
    layers through K1 (faithful, head group 4, 1024-token quantized
    prefill, 8 steps; 8 of its 16 experts on each rank)."""
    import os

    from kvquant_tpu_torch.models.hf_loader import config_from_hf

    if name == "llama_k1":
        T0, N = 2048, 16
        cfg, dcfg, qs = faithful_config(T0 + N + 16, 32)
        mode, kernel, seed = "quantized", "K1", 0
    elif name == "llama_k2":
        T0, N = 1024, 8
        cfg, dcfg, qs = speed_config(T0 + N + 16, 32)
        mode, kernel, seed = "fp16", "K2", 0
    else:
        T0, N = 1024, 8
        d = os.path.join(work, f"dbrx_{os.getpid()}")  # one per process
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "config.json"), "w") as f:
            json.dump(DBRX_CONFIG, f)
        cfg = dataclasses.replace(config_from_hf(d), n_layers=2)
        _, dcfg, qs = faithful_config(T0 + N + 16, 2, cfg)
        mode, kernel, seed = "quantized", "K1", 25
    prompt = torch.randint(0, cfg.vocab_size, (1, T0),
                           generator=torch.Generator().manual_seed(26))
    return cfg, dcfg, qs, prompt, N, mode, kernel, seed


def tp_params(cfg, seed):
    from kvquant_tpu_torch.models import init_params, moe

    init = moe.init_params if isinstance(cfg, moe.MoEConfig) else init_params
    return init(cfg, torch.Generator(device="cuda").manual_seed(seed),
                dtype=torch.bfloat16, device="cuda")


def tp_run(params, cfg, dcfg, dq, prompt, steps, mode, forced=None,
           start=None, snapshot=False):
    """Prefill, then ``steps`` decode steps: greedy, or teacher-forced on
    ``forced`` (steps,) tokens. ``start`` (a cache holding the prompt)
    skips the prefill: the steps decode from that state. Returns a dict:
    the logits of every step on the host (the prefill's first, unless
    ``start``), the tokens fed, the decode wall seconds, the prefill
    seconds, the live cache and, with ``snapshot``, a host copy of the
    cache's arrays after the prefill."""
    from kvquant_tpu_torch import engine
    from kvquant_tpu_torch.cache import create_cache
    from kvquant_tpu_torch.parallel import collectives

    T0 = prompt.shape[1]
    outs, snap, prefill_s = [], None, 0.0
    if start is None:
        cache = create_cache(dcfg, cfg.n_layers, 1, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if mode == "quantized":
            cache, logits = engine.prefill_quantized(
                params, cfg, dcfg, dq, cache, prompt.cuda(), chunk=256)
        else:
            cache, logits = engine.prefill(params, cfg, dcfg, dq, cache,
                                           prompt.cuda())
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        outs.append(logits[0])
        if snapshot:
            snap = {f.name: getattr(cache, f.name).cpu()
                    for f in dataclasses.fields(cache)}
    else:
        cache = start
    collectives.reset_stats()  # count the decode steps' alone
    toks = []
    t0 = time.perf_counter()
    for i in range(steps):
        tok = (torch.argmax(logits, -1).to(torch.int32) if forced is None
               else forced[i:i + 1].cuda())
        toks.append(tok)
        cache, logits = engine.decode_step(params, cfg, dcfg, dq, cache, tok,
                                           T0 + i)
        outs.append(logits[0])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return dict(logits=torch.stack(outs).float().cpu(),
                toks=torch.cat(toks).cpu(), wall=wall, prefill_s=prefill_s,
                cache=cache, snap=snap)


def code_agreement(mine, want, dcfg, live):
    """Share of the ``live`` packed tokens' K and V codes that differ
    between two caches' arrays of the same shards: over every layer, and
    per layer."""
    from kvquant_tpu_torch.ops.deployed import _stored_codes

    diff = [(_stored_codes(mine[f], dcfg)[..., :live, :]
             != _stored_codes(want[f], dcfg)[..., :live, :])
            for f in ("k_planes", "v_planes")]
    per_layer = torch.stack([d.flatten(1).float().mean(1) for d in diff])
    return float(per_layer.mean()), per_layer.mean(0).tolist()


class RouteLog:
    """Records which experts the MoE router keeps on every call (a
    (tokens, experts) bool mask each), to tell routing flips between the
    tp 1 and tp 2 runs from other differences."""

    def __enter__(self):
        from kvquant_tpu_torch.models import moe

        self.moe, self.orig, self.calls = moe, moe._router_weights, []

        def recorded(h, lp, cfg):
            logits, w = self.orig(h, lp, cfg)
            self.calls.append((w > 0).reshape(-1, w.shape[-1]).cpu())
            return logits, w

        moe._router_weights = recorded
        return self

    def __exit__(self, *exc):
        self.moe._router_weights = self.orig


def tp_live_check(tag, kernel, cache, dq, dcfg, cfg, pos):
    """K1 (resp. K2) against its plain version on this rank's live cache
    at the first and last layer, a decode row, both dot modes."""
    from kvquant_tpu_torch.ops.kernels import flash_decode as fd
    from kvquant_tpu_torch.ops.kernels import flash_serial as fs

    G = cfg.q_per_kv
    q = torch.randn((1, dcfg.n_kv_heads, G, cfg.d_head), device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(3))
    p = torch.tensor([pos], dtype=torch.int32, device="cuda")
    arrs = cache.arrays()
    worst = 0.0
    for li in (0, cfg.n_layers - 1):
        for d in (dcfg, dataclasses.replace(dcfg, dot_bf16=False)):
            args = (q, arrs["k_planes"], arrs["v_planes"], arrs["kv_out"],
                    dq.k_range, dq.k_offset, arrs["v_scale"],
                    arrs["v_offset"], arrs["k_sink"], arrs["v_sink"],
                    dq.k_lut_dec, dq.v_lut_dec, li, p, d, cfg)
            if kernel == "K2":
                got = fs.flash_serial_decode(*args, k_ressc=dq.k_ressc)
                want = fs.flash_serial_decode_ref(*args, k_ressc=dq.k_ressc)
            else:
                got = fd.flash_attention(*args, k_ressc=dq.k_ressc)
                want = fd.flash_attention_ref(*args, k_ressc=dq.k_ressc)
            worst = max(worst, agree(f"{tag} {kernel} live cache layer {li}",
                                     got, want, d.dot_bf16))
    return worst


def tp_rank_main(rank_dir):
    """One rank of phase 26 (``--tp-rank``): joins the gloo world from
    KVQ_*, runs every workload teacher-forced on the tp 1 tokens in
    ``rank_dir`` over its shards, writes its numbers (and rank 0 its
    logits) there."""
    import os

    from kvquant_tpu_torch import engine
    from kvquant_tpu_torch.cache import KVCache as KVCacheT
    from kvquant_tpu_torch.cache import deployed_from_quantizers
    from kvquant_tpu_torch.parallel import collectives, shardings
    from kvquant_tpu_torch.parallel.distributed import (
        init_distributed, make_multihost_mesh)

    torch.backends.cuda.matmul.allow_tf32 = False
    if not init_distributed(backend="gloo", device="cuda", timeout_s=300):
        raise RuntimeError("--tp-rank needs the KVQ_* variables")
    mesh = make_multihost_mesh(tp=2, device="cuda")
    r = mesh.rank
    log(f"[26] rank {r}: mesh {mesh.shape} on {mesh.device}, backend "
        f"{torch.distributed.get_backend()}")
    params_by_seed = {}
    for name in TP_WORKLOADS:
        cfg, dcfg, qs, prompt, N, mode, kernel, seed = tp_workload(
            name, rank_dir)
        forced = torch.load(os.path.join(rank_dir, f"{name}_tp1.pt"))["toks"]
        if seed not in params_by_seed:
            params_by_seed.clear()
            torch.cuda.empty_cache()
            full = tp_params(cfg, seed)  # the tp 1 run's weights
            params_by_seed[seed] = shardings.shard_params(mesh, full)
            del full
            torch.cuda.empty_cache()
        params = params_by_seed[seed]
        lcfg = params.cfg
        ldcfg = shardings.shard_config(mesh, dcfg)
        dq = shardings.shard_quant(mesh, deployed_from_quantizers(
            qs, cfg.n_kv_heads, cfg.d_head, device="cuda"))
        torch.cuda.reset_peak_memory_stats()
        tp_run(params, lcfg, ldcfg, dq, prompt, 2, mode,
               forced=forced)  # warm-up
        read = reset_launches()
        collectives.timing(True)
        run = tp_run(params, lcfg, ldcfg, dq, prompt, N, mode,
                     forced=forced, snapshot=True)
        collectives.timing(False)
        n = read()
        st = dict(collectives.STATS)
        wall, prefill_s, cache = run["wall"], run["prefill_s"], run["cache"]
        # the same steps decoded from tp 1's own cache after its prefill
        # (this rank's shards of it): the state teacher-forced as well
        snap_path = os.path.join(rank_dir, f"{name}_cache.pt")

        def tp1_state(device):
            mine = shardings.shard_cache(
                mesh, KVCacheT(**torch.load(snap_path)))
            return KVCacheT(**{f.name: getattr(mine, f.name).to(device)
                               for f in dataclasses.fields(mine)})

        codes_differ, codes_by_layer = code_agreement(
            run["snap"], tp1_state("cpu").__dict__, ldcfg,
            prompt.shape[1] - dcfg.sink)
        forced_state = tp_run(params, lcfg, ldcfg, dq, prompt, N, mode,
                              forced=forced,
                              start=tp1_state("cuda"))["logits"]
        if hasattr(lcfg, "n_experts"):  # the routing of both runs
            for tag, start in (("routes", None),
                               ("routes_state", tp1_state("cuda"))):
                with RouteLog() as routes:
                    tp_run(params, lcfg, ldcfg, dq, prompt, N, mode,
                           forced=forced, start=start)
                if r == 0:
                    torch.save(routes.calls, os.path.join(
                        rank_dir, f"{name}_{tag}.pt"))
        n_chunks = -(-(prompt.shape[1] - dcfg.sink) // 256)
        want = lcfg.n_layers * (N + (n_chunks if mode == "quantized" else 0))
        err = tp_live_check(f"[26] rank {r} {name}", kernel, cache, dq,
                            ldcfg, lcfg, prompt.shape[1] + N)
        # device time of decode steps past the run (both ranks in step)
        T1 = prompt.shape[1] + N
        tok = forced[-1:].cuda()
        try:
            tps, idle = decode_profile(
                f"[26] rank {r} {name}", lambda i: engine.decode_step(
                    params, lcfg, ldcfg, dq, cache, tok, T1 + i), 4,
                prof_steps=2)
            dev_ms = (1 - idle) * 1e3 / tps
        except RuntimeError as e:  # a second process tracing the card
            log(f"[26] rank {r} {name}: profiler failed ({e}); device ms "
                f"not measured")
            tps = idle = dev_ms = None
        res = dict(
            launches=n[kernel], launches_expected=want,
            launches_per_step=n[kernel] / (N + (n_chunks if mode ==
                                               "quantized" else 0)),
            max_abs_err=err, wall_s=wall, prefill_s=prefill_s,
            tok_s=N / wall, ms_per_step=wall * 1e3 / N,
            collective_calls_per_step=st["calls"] / N,
            collective_ms_per_step=st["seconds"] * 1e3 / N,
            peak_gib=gib_peak(), profiled_tps=tps, idle=idle,
            device_ms_per_step=dev_ms, prefill_codes_differ=codes_differ,
            prefill_codes_differ_by_layer=codes_by_layer,
            local_kv_heads=ldcfg.n_kv_heads, local_heads=lcfg.n_heads,
            local_experts=getattr(lcfg, "n_experts", None))
        log(f"[26] rank {r} {name}: {kernel} launches {n[kernel]} "
            f"(expected {want}), {N} forced steps {res['ms_per_step']:.2f} "
            f"ms/step ({res['tok_s']:.2f} tok/s), collectives "
            f"{res['collective_calls_per_step']:.0f}/step "
            f"{res['collective_ms_per_step']:.3f} ms/step (gloo through "
            f"host memory), peak {res['peak_gib']:.2f} GiB")
        if n[kernel] != want:
            raise AssertionError(f"rank {r} {name}: {kernel} launches "
                                 f"{n[kernel]} != {want}")
        with open(os.path.join(rank_dir, f"{name}_rank{r}.json"), "w") as f:
            json.dump(res, f)
        if r == 0:
            torch.save({"tokens": run["logits"], "state": forced_state},
                       os.path.join(rank_dir, f"{name}_tp2.pt"))
        del cache, dq, run
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    return 0


def phase_tp(report):
    """Tensor parallelism on the card: tp 1 runs of each workload
    (``tp_workload``) in this process, then two rank processes on cuda:0
    over gloo. Each rank prefills the prompt itself and decodes the tp 1
    tokens (its launches held to layers x (chunks + steps), its kernel to
    the plain version on its live cache, its prefill codes to tp 1's),
    then decodes the same tokens from its shards of tp 1's cache after
    the prefill: those steps' logits are held to tp 1's (max |dlogit| <=
    0.05 max |logit|, the argmax at every step with a clear margin). The
    own-prefill steps' logits are printed beside them: bf16 rounding parts
    the two caches' codes over a 2048-token prefill, and the parting
    compounds."""
    import os
    import shutil
    import socket

    from kvquant_tpu_torch.cache import deployed_from_quantizers

    root = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(root, "kvquant_tpu_torch", "_build", "smoke_tp")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    log("[26] tp 2 = two rank processes sharing cuda:0, backend=\"gloo\" "
        "(NCCL takes one card per rank): the collectives go through host "
        "memory, so their times are gloo's, not NCCL's")
    tp1 = {}
    params, seed_now = None, None
    for name in TP_WORKLOADS:
        cfg, dcfg, qs, prompt, N, mode, kernel, seed = tp_workload(name, work)
        if seed != seed_now:
            params = None
            torch.cuda.empty_cache()
            params, seed_now = tp_params(cfg, seed), seed
        dq = deployed_from_quantizers(qs, cfg.n_kv_heads, cfg.d_head,
                                      device="cuda")
        tp_run(params, cfg, dcfg, dq, prompt, 2, mode)  # warm-up
        torch.cuda.reset_peak_memory_stats()
        run = tp_run(params, cfg, dcfg, dq, prompt, N, mode, snapshot=True)
        wall = run["wall"]
        tp1[name] = dict(logits=run["logits"], tok_s=N / wall,
                         prefill_s=run["prefill_s"], peak_gib=gib_peak(),
                         n_layers=cfg.n_layers)
        if hasattr(cfg, "n_experts"):  # the routing of the same tokens
            with RouteLog() as routes:
                tp_run(params, cfg, dcfg, dq, prompt, N, mode,
                       forced=run["toks"])
            tp1[name]["routes"] = routes.calls
        torch.save({"toks": run["toks"]},
                   os.path.join(work, f"{name}_tp1.pt"))
        torch.save(run["snap"], os.path.join(work, f"{name}_cache.pt"))
        log(f"[26] tp 1 {name}: prefill {prompt.shape[1]} tokens "
            f"({mode}) {run['prefill_s']:.3f} s, {N} greedy steps "
            f"{wall * 1e3 / N:.2f} ms/step ({N / wall:.2f} tok/s), peak "
            f"{tp1[name]['peak_gib']:.2f} GiB")
        del run, dq
    params = None
    torch.cuda.empty_cache()

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, KVQ_COORDINATOR=f"localhost:{port}",
               KVQ_NUM_PROCESSES="2")
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--tp-rank", work],
        env=dict(env, KVQ_PROCESS_ID=str(r))) for r in range(2)]
    try:
        # a rank that fails leaves the other waiting in a collective: stop
        # both at the first failure
        deadline = time.monotonic() + 600
        while (any(p.poll() is None for p in procs)
               and not any(p.poll() for p in procs)
               and time.monotonic() < deadline):
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(p.returncode for p in procs):
        raise AssertionError(f"[26] rank processes exited with "
                             f"{[p.returncode for p in procs]}")
    log(f"[26] rank processes done in {time.perf_counter() - t0:.1f} s")

    def compare(tag, got, want):
        """Per-step |dlogit| / max|logit_tp1|, the clear-margin steps and
        the argmax agreement of ``got`` against ``want`` (steps, V)."""
        scale = want.abs().amax(-1)
        rel = (got - want).abs().amax(-1) / scale
        top2 = torch.topk(want, 2, dim=-1).values
        margin = (top2[:, 0] - top2[:, 1]) / scale
        clear = margin > 0.01
        same = torch.argmax(got, -1) == torch.argmax(want, -1)
        log(f"{tag}: per step |dlogit| / max|logit_tp1| "
            f"{[round(float(x), 4) for x in rel]}; tp 1 top-2 margin / "
            f"max|logit| {[round(float(x), 4) for x in margin]}; argmax "
            f"equal {same.int().tolist()}")
        log(f"{tag}: max |dlogit| / max|logit_tp1| {float(rel.max()):.4f}; "
            f"argmax equal at {int((same & clear).sum())} of "
            f"{int(clear.sum())} steps with a top-2 margin > 1% of "
            f"max|logit|, {int((~clear).sum())} other steps (argmax equal "
            f"at {int((same & ~clear).sum())} of them)")
        ok = (float(rel.max()) <= 0.05 and bool(same[clear].all())
              and bool(torch.isfinite(got).all()))
        return ok, dict(max_rel_dlogit=float(rel.max()),
                        clear_steps=int(clear.sum()),
                        clear_equal=int((same & clear).sum()),
                        other_steps=int((~clear).sum()))

    out, failed = {}, []
    for name in TP_WORKLOADS:
        ranks = []
        for r in range(2):
            with open(os.path.join(work, f"{name}_rank{r}.json")) as f:
                ranks.append(json.load(f))
        want = tp1[name]["logits"]
        got = torch.load(os.path.join(work, f"{name}_tp2.pt"))
        # gated: the steps decoded from tp 1's cache (state and tokens
        # forced), each step's own arithmetic alone
        ok, gates = compare(f"[26] {name} from tp 1's cache", got["state"],
                            want[1:])
        # printed: tp 2's own prefill, then the steps (tokens forced); the
        # caches part by rounding, and the parting compounds
        _, own = compare(f"[26] {name} own prefill", got["tokens"], want)
        differ = max(x["prefill_codes_differ"] for x in ranks)
        by_layer = ranks[0]["prefill_codes_differ_by_layer"]
        log(f"[26] {name}: prefill K / V codes that differ from tp 1's "
            f"(rank shards, live tokens): {differ:.5f} (gate 0.05); rank 0 "
            f"by layer {[round(x, 5) for x in by_layer]}")
        if "routes" in tp1[name]:
            decode_calls = tp1[name]["n_layers"] * (len(want) - 1)
            for tag, base in (("routes", tp1[name]["routes"]),
                              ("routes_state",
                               tp1[name]["routes"][-decode_calls:])):
                mine = torch.load(os.path.join(work, f"{name}_{tag}.pt"))
                flips = [int((a != b).any(-1).sum())
                         for a, b in zip(base, mine)]
                log(f"[26] {name} {tag}: tokens whose experts differ from "
                    f"tp 1's, per router call: {flips}")
        log(f"[26] {name}: tok/s tp 1 {tp1[name]['tok_s']:.2f}, tp 2 "
            f"rank 0 {ranks[0]['tok_s']:.2f}, rank 1 {ranks[1]['tok_s']:.2f}")
        for r, x in enumerate(ranks):
            dev = ("not measured" if x["device_ms_per_step"] is None
                   else f"{x['device_ms_per_step']:.3f} ms/step")
            log(f"[26] {name} rank {r}: {x['ms_per_step']:.2f} ms/step wall, "
                f"device kernel time {dev}, collectives "
                f"{x['collective_ms_per_step']:.3f} ms/step "
                f"({x['collective_calls_per_step']:.0f} calls, gloo), "
                f"launches/step {x['launches_per_step']:.0f}, peak "
                f"{x['peak_gib']:.2f} GiB, {x['local_kv_heads']} kv heads"
                + (f", {x['local_experts']} experts" if x["local_experts"]
                   else ""))
        if not (ok and differ <= 0.05):
            failed.append(name)
        out[name] = dict(tp1=dict((k, v) for k, v in tp1[name].items()
                                  if k not in ("logits", "routes")),
                         ranks=ranks, gated=gates, own_prefill=own,
                         prefill_codes_differ=differ)
    if failed:
        raise AssertionError(f"[26] tp 2 logits fail the gates: {failed}")
    report["tp"] = out
    shutil.rmtree(work, ignore_errors=True)


def step_trace(step, n=3, kernels=None):
    """(device kernel ms, kernels, the port's kernels by wrapper, their
    device ms by wrapper) per call of ``step()`` over ``n`` calls under
    torch.profiler (utils.profiling.kernel_summary, the reading of
    ``cli.deploy --profile``), after one warm-up call. The third counts
    the trace's kernels named in ``kernels`` (default OWN_KERNELS): what
    the card ran, whatever the counters say."""
    import re

    from torch.profiler import ProfilerActivity, profile

    from kvquant_tpu_torch.utils.profiling import kernel_summary

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        for _ in range(n):
            step()
        torch.cuda.synchronize()
    s = kernel_summary(prof, cuda=True)
    own, own_ms = {}, {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        m = re.search(r"::(\w+)[<(]", e.key)
        for k, names in (kernels or OWN_KERNELS).items():
            if m and m.group(1) in names:
                own[k] = own.get(k, 0) + e.count / n
                own_ms[k] = own_ms.get(k, 0) + \
                    e.self_device_time_total / n / 1e3
    return s["kernel_ms"] / n, s["launches"] / n, own, own_ms


# the port's kernels in a profiler trace, by the wrapper that launches
# them: one of these a wrapper call (the merges that may follow are left
# out)
OWN_KERNELS = {"K1": ("fd_decode", "fd_gqa", "fd_chunk", "fd_partial"),
               "K2": ("fs_mma", "fs_partial"),
               "K3": ("qk_decode", "qk_gqa", "qk_mma", "qk_simt"),
               "K4": ("pv_decode", "pv_mma", "pv_simt"),
               "moe_experts": ("moe_glu",)}


def step_profile(step, n=3):
    """(device kernel ms, kernels) per call of ``step()`` (``step_trace``)."""
    return step_trace(step, n)[:2]


def profiled_ms(step, n=3):
    """Device kernel ms per call of ``step()`` (``step_profile``)."""
    return step_profile(step, n)[0]


def host_syncs(step):
    """Times one call of ``step()`` (after a warm-up call) made the host
    wait for the card: torch.cuda's sync debug mode warns at each
    synchronizing operation. Returns (count, the first warning or None)."""
    import warnings

    step()
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            step()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [str(w.message) for w in caught
             if "called a synchronizing" in str(w.message)]
    return len(syncs), (syncs[0][:160] if syncs else None)


def phase_training(report):
    """The training slice on the card: the toy model's full JAX recipe,
    card against CPU from the same weights, the checkpoint written and read
    back, the card-trained model calibrated and served through K1; then the
    retrieval model at IND_CFG's widths and batch shapes, with the step
    counts cut, calibrated on copy haystacks and served through K1 at 2048
    context, card == CPU."""
    import os
    import shutil

    from kvquant_tpu_torch import engine
    from kvquant_tpu_torch.cache import DeployConfig, deployed_from_quantizers
    from kvquant_tpu_torch.evals import perplexity
    from kvquant_tpu_torch.fisher import clm_loss, fisher_info
    from kvquant_tpu_torch.models import params_from_numpy, params_to_numpy
    from kvquant_tpu_torch.models import trainable
    from kvquant_tpu_torch.quant.calibration import (collect_kv_activations,
                                                     fit_quantizers)
    from kvquant_tpu_torch.utils import induction as ind
    from kvquant_tpu_torch.utils.toymodel import TOY_CFG as cfg
    from kvquant_tpu_torch.utils.toymodel import (_flatten, adam,
                                                  load_toy_checkpoint,
                                                  save_toy_checkpoint,
                                                  to_device, train_step,
                                                  train_toy_model)

    root = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(root, "kvquant_tpu_torch", "_build", "smoke_train")
    os.makedirs(work, exist_ok=True)
    ck_tree, ck_loss, _ = load_toy_checkpoint(
        os.path.join(root, "artifacts", "toy_model.npz"))
    out = {}

    # 1. the toy model: train_toy_model's defaults (1200 steps, batch 16,
    #    T 256, lr 1e-3, seed 0) on the card
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, lm, loss = train_toy_model()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ms = wall / 1200 * 1e3
    peak = gib_peak()
    tree = params_to_numpy(params)
    t_params = trainable(params)
    t_opt = adam(t_params, 1e-3)

    def toy_step():  # train_toy_model's loop body
        train_step(t_opt, clm_loss(t_params, cfg, to_device(
            lm.sample(16, 256, 1200), torch.device("cuda"))))

    dev_ms = profiled_ms(toy_step)
    syncs = {"toy": host_syncs(toy_step)}
    t_host = time.perf_counter()
    for i in range(20):
        lm.sample(16, 256, i)
    sample_ms = (time.perf_counter() - t_host) / 20 * 1e3
    # the same step with its batch already on the card: the host's launches
    staged = to_device(lm.sample(16, 256, 1200), torch.device("cuda"))
    torch.cuda.synchronize()
    t_host = time.perf_counter()
    for _ in range(50):
        train_step(t_opt, clm_loss(t_params, cfg, staged))
    torch.cuda.synchronize()
    staged_ms = (time.perf_counter() - t_host) / 50 * 1e3
    del t_params, t_opt, staged
    ppl = perplexity(params, cfg, lm.sample(4, 256, seed=10_001))
    floor = lm.ideal_ppl
    log(f"[27] toy model (TOY_CFG: vocab 512, d 256, 4 layers, 8 / 4 heads, "
        f"d_ff 512, fp32) trained on the card, 1200 steps of 16 x 256: "
        f"{wall:.2f} s wall, {ms:.3f} ms/step; profiled steps: "
        f"{dev_ms:.3f} device ms/step (idle share {1 - dev_ms / ms:.3f}); "
        f"the batch's numpy draw alone {sample_ms:.3f} ms on the host, a "
        f"step with its batch already on the card {staged_ms:.3f} ms; "
        f"peak {peak:.3f} GiB; final loss {loss:.4f} (the committed "
        f"checkpoint's {ck_loss:.4f}); ppl {ppl:.4f} against the bigram "
        f"floor {floor:.4f} (gate: below 1.5 x = {1.5 * floor:.4f})")
    if not (np.isfinite(loss) and ppl < 1.5 * floor):
        raise AssertionError("the card-trained toy model did not learn")
    out["toy"] = dict(wall_s=wall, ms_per_step=ms, device_ms_per_step=dev_ms,
                      idle_share=1 - dev_ms / ms, sample_ms=sample_ms,
                      staged_ms=staged_ms,
                      peak_gib=peak, loss=loss, committed_loss=ck_loss,
                      ppl=ppl, floor=floor)

    # 2. card against CPU: 1, 2, 3 steps from the committed checkpoint's
    #    weights (the loss of an n-step run is step n's)
    losses = {dev: [train_toy_model(steps=n, init=ck_tree, device=dev)[2]
                    for n in (1, 2, 3)] for dev in ("cuda", "cpu")}
    rel = max(abs(a / b - 1) for a, b in zip(losses["cuda"], losses["cpu"]))
    log(f"[27] 3 steps from the committed weights: card {losses['cuda']}, "
        f"cpu {losses['cpu']}; max relative difference {rel:.2e} (tol 1e-4)")
    if not rel <= 1e-4:
        raise AssertionError("card and CPU training steps disagree")
    out["card_vs_cpu_rel"] = rel

    # 3. the checkpoint written and read back
    path = os.path.join(work, "toy_model.npz")
    save_toy_checkpoint(path, params, loss, seed=0)
    back, bloss, bseed = load_toy_checkpoint(path)
    flat, bflat = _flatten(tree), _flatten(back)
    same = flat.keys() == bflat.keys() and all(
        np.array_equal(flat[k], bflat[k]) for k in flat)
    reloaded = params_from_numpy(back, cfg, device="cuda")
    same_dev = all(torch.equal(a, b) for a, b in zip(
        reloaded.parameters(), params.parameters()))
    log(f"[27] save_toy_checkpoint / load_toy_checkpoint "
        f"({os.path.getsize(path)} B): {len(flat)} arrays bitwise equal: "
        f"{same}; on the card again: {same_dev}; loss {bloss:.4f}, seed "
        f"{bseed}")
    if not (same and same_dev and bloss == np.float32(loss) and bseed == 0):
        raise AssertionError("the checkpoint did not round-trip")

    # 4. calibrate the card-trained model as benchmarks/ppl_table.py makes
    #    the committed quantizers, deploy through K1
    cal = lm.sample(4, 256, seed=20_002)
    fk, fv = fisher_info(params, cfg, [cal])
    k, v = collect_kv_activations(params, cfg, [cal])
    qs = fit_quantizers(k, v, bits=3, sparsity_threshold=0.99,
                        cap_outliers=True, first_few_fp16=5, sample_seqlen=256,
                        kmeans_iters=30, fisher_k=fk, fisher_v=fv)
    del fk, fv, k, v
    d3 = DeployConfig.create(bits=3, n_kv_heads=cfg.n_kv_heads,
                             d_head=cfg.d_head, max_len=261, sink=5,
                             head_group=4, kernel="flash")
    ev = lm.sample(4, 256, seed=10_001)[:2]
    read = reset_launches()
    dep, sim = toy_deployed_and_simulated("cuda", qs, d3, ev, tree)
    n = read()
    gap = abs(np.log(dep) - np.log(sim))
    want = cfg.n_layers * ev.shape[1]
    log(f"[27] the card-trained model, nuq3 (Fisher-weighted, fitted on the "
        f"card) hg 4 through K1: simulated ppl {sim:.4f}, deployed "
        f"{dep:.4f} (|log gap| {gap:.2e}, bound 0.02; fp16 {ppl:.4f}); "
        f"launches {n} (K1 expected {cfg.n_layers} x {ev.shape[1]})")
    if not (gap < 0.02 and n["K1"] == want
            and n["K2"] == n["K3"] == n["K4"] == n["K5"] == 0):
        raise AssertionError("deployed != simulated, or not through K1")
    out.update(sim_ppl=sim, dep_ppl=dep, k1_launches=n["K1"])
    del params

    # 5. the retrieval model at IND_CFG's widths and the JAX batch shapes
    #    (stage 1: 32 x 512; stage 2: 16 x 1024; robust: 2 x 8192 long and
    #    8 x 1024 blocks), step counts cut; every log line follows a host
    #    read of the loss, so its time marks the end of a stage
    marks = []

    def mark(msg):
        marks.append((time.perf_counter(), gib_peak()))
        torch.cuda.reset_peak_memory_stats()
        log(f"[27] {msg}")

    s1 = 200
    s2 = s1 * 5 // 8
    s3 = 10
    icfg = ind.IND_CFG
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    iparams, iloss = ind.train_induction_model(steps=s1, segment=s1,
                                               log=mark)
    t1 = time.perf_counter()
    iparams = ind.finetune_retrieval_robust(iparams, steps=s3, log=mark)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    stages = {"stage1": (s1, marks[0][0] - t0, marks[0][1]),
              "stage2": (s2, marks[1][0] - marks[0][0], marks[1][1]),
              "robust": (s3, t3 - t1, marks[2][1])}
    # device ms of each stage's step (its loop body), profiled
    tp = trainable(iparams)
    opt = adam(tp, 1e-3)
    gen = ind.generator(123)
    kstd, vstd = ind.kv_stds(tp, icfg)

    def robust_step():
        for b, chunk, remat in ((ind.sample_long_batch(gen, 2, 8192), 1024,
                                 True),
                                (ind.sample_blocks_batch(gen, 8, 1024, 1.0),
                                 None, False)):
            probes = ind.noise_probes(gen, icfg, *b[0].shape, 0.08 * kstd,
                                      0.05 * vstd)
            train_step(opt, ind.noisy_loss(tp, icfg, *b, probes, chunk,
                                           remat))

    bodies = {
        "stage1": lambda: train_step(opt, ind.masked_loss(
            tp, icfg, *ind.sample_mixed_batch(gen, 32, 512, 131072, 1.0))),
        "stage2": lambda: train_step(opt, ind.masked_loss(
            tp, icfg, *ind.sample_blocks_batch(gen, 16, 1024, 1.0))),
        "robust": robust_step}
    rows = {}
    for name, (steps, wall_s, peak) in stages.items():
        ms = wall_s / steps * 1e3
        dms = profiled_ms(bodies[name], n=2 if name == "robust" else 3)
        syncs[name] = host_syncs(bodies[name])
        rows[name] = dict(steps=steps, ms_per_step=ms, device_ms=dms,
                          idle_share=1 - dms / ms, peak_gib=peak)
        log(f"[27] {name}: {steps} steps, {ms:.2f} ms/step (host wall), "
            f"{dms:.2f} device ms/step profiled (idle share "
            f"{1 - dms / ms:.3f}), peak {peak:.3f} GiB")
    del tp, opt
    # the detector's control: reading a device scalar must count
    control = host_syncs(lambda: float(torch.ones((), device="cuda")))[0]
    log(f"[27] host waits for the card in one step of each loop body "
        f"(sampling, loss, backward, Adam; torch.cuda sync debug mode): "
        f"{ {k: v[0] for k, v in syncs.items()} } (a float() of a device "
        f"scalar: {control})"
        + "".join(f"; {k}: {v[1]}" for k, v in syncs.items() if v[0]))
    if any(v[0] for v in syncs.values()) or control < 1:
        raise AssertionError("a training step waits for the card")
    out["host_syncs"] = {k: v[0] for k, v in syncs.items()}
    proj = (16000 * rows["stage1"]["ms_per_step"]
            + 10000 * rows["stage2"]["ms_per_step"]
            + 3000 * rows["robust"]["ms_per_step"]) / 1e3
    log(f"[27] projection, not a measurement: the full recipe (16000 + "
        f"10000 + 3000 steps) at these ms/step would take {proj:.0f} s "
        f"({proj / 3600:.2f} h) on this card")
    out["induction"] = dict(stages=rows, projected_full_s=proj,
                            final_loss=iloss)

    # calibrate on copy haystacks (benchmarks/retrieval_demo.py's recipe at
    # 2048 tokens), serve through K1 at 2048 context, card == CPU
    ctx = 2048
    hay = np.stack([ind.build_copy_prompt(ctx, (s % 4) / 4.0, seed=s)[0]
                    for s in range(4)])
    k, v = collect_kv_activations(iparams, icfg, [hay])
    qs = fit_quantizers(k, v, bits=3, sparsity_threshold=0.95,
                        cap_outliers=True, first_few_fp16=5,
                        sample_seqlen=ctx, kmeans_iters=20)
    del k, v
    dcfg = DeployConfig.create(bits=3, n_kv_heads=icfg.n_kv_heads,
                               d_head=icfg.d_head, max_len=ctx + 16, sink=5,
                               kernel="flash", head_group=4,
                               sparsity_threshold=0.95, dot_bf16=False)
    new = 8
    prompts = [ind.build_copy_prompt(ctx, depth, seed=ctx + i)
               for i, depth in enumerate((0.0, 0.5, 1.0))]
    itree = params_to_numpy(iparams)
    toks, secs = {}, {}
    for dev in ("cuda", "cpu"):
        p = params_from_numpy(itree, icfg, device=dev)
        dq = deployed_from_quantizers(qs, icfg.n_kv_heads, icfg.d_head,
                                      device=dev)
        read = reset_launches()
        t0 = time.perf_counter()
        toks[dev] = [engine.generate(
            p, icfg, dcfg, dq, torch.as_tensor(ids[None]),
            engine.GenerateConfig(max_new_tokens=new),
            prefill_mode="quantized", device=dev)[0][0].cpu().numpy()
            for ids, _ in prompts]
        secs[dev] = time.perf_counter() - t0
        if dev == "cuda":
            n = read()
    same = all(np.array_equal(a, b) for a, b in zip(toks["cuda"],
                                                    toks["cpu"]))
    hits = sum(bool(np.array_equal(t[:ind.VL], ans))
               for t, (_, ans) in zip(toks["cuda"], prompts))
    chunks = -(-(ctx - 5) // 256)
    want = icfg.n_layers * (chunks + new) * len(prompts)
    log(f"[27] retrieval model, nuq3 (sparsity 0.95, fitted on 4 x {ctx} "
        f"copy haystacks) through K1 at {ctx} context: {len(prompts)} "
        f"prompts, quantized prefill + {new} greedy tokens each, card "
        f"{secs['cuda']:.2f} s, CPU {secs['cpu']:.2f} s; card == CPU: "
        f"{same}; launches "
        f"{n} (K1 expected {icfg.n_layers} x ({chunks} + {new}) x "
        f"{len(prompts)} = {want}); retrieval {hits}/{len(prompts)} (context "
        f"only: {s1} + {s2} + {s3} steps of 16000 + 10000 + 3000)")
    if not (same and n["K1"] == want
            and n["K2"] == n["K3"] == n["K4"] == n["K5"] == 0):
        raise AssertionError(f"card {toks['cuda']} cpu {toks['cpu']}")
    out["retrieval"] = dict(card_eq_cpu=same, hits=hits, n=len(prompts),
                            k1_launches=n["K1"])
    out["k1_launches"] += n["K1"]
    report["training"] = out
    del iparams
    shutil.rmtree(work)
    torch.cuda.empty_cache()


# (tag, config of LLaMA-2-7B width, kernel, {context: greedy steps}): the
# token and cache comparison runs at 2K, the timings at every context
GRAPH_PATHS = (
    ("K2 speed int4", "speed_config", "flash_serial", {2048: 32, 32768: 8}),
    ("K1 nuq3", "faithful_config", "flash", {2048: 32, 32768: 8}),
    ("K3/K4 nuq3", "faithful_config", "pallas", {2048: 32, 32768: 8}),
    ("K1 int4x2", "speed2_config", "flash",
     {2048: 32, 32768: 8, 131072: 8}),
    ("xla nuq3", "faithful_config", "xla", {2048: 8}),
)


def clone_cache(cache):
    from kvquant_tpu_torch.cache import KVCache

    return KVCache(**{f.name: getattr(cache, f.name).clone()
                      for f in dataclasses.fields(cache)})


def caches_equal(a, b) -> bool:
    """Every array of two caches bitwise (fp32 compared as bit patterns)."""
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if x.dtype == torch.float32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        if not torch.equal(x, y):
            return False
    return True


def greedy_run(step, ctx, steps):
    """``steps`` greedy steps of ``step(token, pos) -> logits`` from token 0
    at position ``ctx`` (positions made on the card, as a server holds
    them): (tokens (1, steps), the logits of every step, wall seconds
    between two synchronizes, launches by kernel)."""
    from kvquant_tpu_torch.ops.kernels import launch_counts

    tok = torch.zeros((1,), dtype=torch.int32, device="cuda")
    toks, logits_all = [], []
    before = launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(steps):
        pos = torch.full((1,), ctx + i, dtype=torch.int32, device="cuda")
        logits = step(tok, pos)
        logits_all.append(logits.clone())
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        toks.append(tok)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n = {k: v - before[k] for k, v in launch_counts().items()}
    return torch.stack(toks, dim=1), torch.stack(logits_all), wall, n


def phase_graphed_decode(report):
    """One CUDA graph per decode step (engine.DecodeGraph) against the
    eager step at LLaMA-2-7B width (random bf16 weights from a seed, B=1):
    greedy tokens, every step's logits and the caches afterwards bitwise
    from clones of one filled 2K cache; tok/s, device ms and kernels per
    step, idle share, launches per step (the counters, and at 2K the
    port's kernels by name in the profiler's trace), host waits per step,
    capture seconds and the graph pool's MiB, eager and graphed in turn,
    at 2K and 32K (128K for int4x2); serve.Server with 4 slots, graphed
    tokens == the tokens of the same server stepping eagerly."""
    from kvquant_tpu_torch import engine, serve
    from kvquant_tpu_torch.cache import (deployed_from_quantizers,
                                         static_channels)
    from kvquant_tpu_torch.models import init_params
    from kvquant_tpu_torch.models.config import LLAMA2_7B
    from kvquant_tpu_torch.ops.kernels import launch_counts

    cfg = LLAMA2_7B
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         dtype=torch.bfloat16, device="cuda")
    makers = {"speed_config": speed_config, "faithful_config":
              faithful_config, "speed2_config": speed2_config}
    out = {}
    for tag, make, kernel, runs in GRAPH_PATHS:
        res = out[tag] = {}
        for ctx, steps in runs.items():
            t_case = time.perf_counter()
            _, dcfg, qs = makers[make](ctx + steps + 8, cfg.n_layers)
            dcfg = dataclasses.replace(dcfg, kernel=kernel)
            dq = deployed_from_quantizers(qs, cfg.n_kv_heads, cfg.d_head,
                                          device="cuda")
            base = filled_cache(dcfg, cfg.n_layers, ctx, 3)
            compare = ctx == 2048
            cache_g = clone_cache(base) if compare else base
            graph = engine.DecodeGraph(params, cfg, dcfg, dq, cache_g)
            # the eager step as decode_stepper builds it off the card: the
            # static K channels computed once, as the graph has them
            k_chan = static_channels(dq, dcfg)

            def eager(tok, pos, c=base):
                return engine.decode_step(params, cfg, dcfg, dq, c, tok,
                                          pos, k_chan=k_chan)[1]

            r = {"capture_s": graph.capture_s, "pool_mib": graph.pool_mib,
                 "setup_launches": graph.setup_launches}
            tok_e, lg_e, wall_e, n_e = greedy_run(eager, ctx, steps)
            tok_g, lg_g, wall_g, n_g = greedy_run(graph, ctx, steps)
            pos_end = torch.full((1,), ctx + steps, dtype=torch.int32,
                                 device="cuda")
            if compare:
                r["tokens_equal"] = bool(torch.equal(tok_e, tok_g))
                r["logits_bitwise"] = bool(torch.equal(
                    lg_e.view(torch.int32), lg_g.view(torch.int32)))
                r["logits_max_abs_diff"] = float((lg_e - lg_g).abs().max())
                r["caches_equal"] = caches_equal(base, cache_g)
                r["finite"] = bool(torch.isfinite(lg_g).all())
                r["host_waits"] = {
                    "eager": host_syncs(lambda: eager(tok_e[:, -1],
                                                      pos_end))[0],
                    "graphed": host_syncs(lambda: graph(tok_e[:, -1],
                                                        pos_end))[0]}
            if n_e != n_g:
                raise AssertionError(f"[28] {tag} {ctx}: launches eager "
                                     f"{n_e} graphed {n_g}")
            per = {k: v / steps for k, v in n_g.items() if v}
            want = {"flash": {"K1": 32}, "flash_serial": {"K2": 32},
                    "pallas": {"K3": 32, "K4": 32}, "xla": {}}[kernel]
            if per != want:
                raise AssertionError(f"[28] {tag} {ctx}: launches per step "
                                     f"{per}, expected {want}")
            # device ms a step: the graph's replays back to back between
            # CUDA events (the eager step runs the same kernels); the
            # profiler's kernel sum and count, and the port's kernels it
            # saw by name, eager and graphed
            dev = device_ms(lambda: graph(tok_e[:, -1], pos_end), n=8,
                            reps=3)
            for mode, step, wall in (("eager", eager, wall_e),
                                     ("graphed", graph, wall_g)):
                wall_ms = wall / steps * 1e3
                # the profiler's trace at 2K (the kernels a step do not
                # change with the context; the counters are read at each)
                kms, kern, own, _ = step_trace(lambda: step(tok_e[:, -1],
                                                            pos_end), n=2) \
                    if compare else (None, None, None, None)
                r[mode] = {"tok_s": steps / wall, "wall_ms": wall_ms,
                           "device_ms": dev, "idle": 1 - dev / wall_ms,
                           "kernel_ms": kms, "kernels": kern,
                           "trace_launches": own}
            r["launches_per_step"] = per
            res[ctx] = r
            e, g = r["eager"], r["graphed"]
            prof = (f"; profiler kernel ms / kernels a step: eager "
                    f"{e['kernel_ms']:.3f} / {e['kernels']:.0f}, graphed "
                    f"{g['kernel_ms']:.3f} / {g['kernels']:.0f}; the port's "
                    f"kernels in the trace a step: eager "
                    f"{e['trace_launches']}, graphed {g['trace_launches']}"
                    if compare else "")
            log(f"[28] {tag} {ctx} ctx, {steps} steps: device {dev:.3f} ms "
                f"a step (graph replays); eager {e['tok_s']:.2f} tok/s "
                f"(wall {e['wall_ms']:.3f} ms, {e['wall_ms'] / dev:.3f} x "
                f"device, idle {e['idle']:.3f}); graphed {g['tok_s']:.2f} "
                f"tok/s (wall {g['wall_ms']:.3f} ms, {g['wall_ms'] / dev:.3f}"
                f" x device, idle {g['idle']:.3f}); launches a step {per}; "
                f"capture {graph.capture_s:.3f} s, pool "
                f"{graph.pool_mib:.1f} MiB, warm-up launches "
                f"{graph.setup_launches}{prof}; {time.perf_counter() - t_case:.1f} s")
            if compare:
                log(f"[28] {tag}: tokens equal {r['tokens_equal']}, logits "
                    f"bitwise {r['logits_bitwise']} (max |diff| "
                    f"{r['logits_max_abs_diff']:.3e}), caches equal "
                    f"{r['caches_equal']}, host waits a step {r['host_waits']}")
                if not (r["tokens_equal"] and r["caches_equal"]
                        and r["logits_bitwise"] and r["finite"]):
                    raise AssertionError(f"[28] {tag}: graphed != eager")
                if r["host_waits"] != {"eager": 0, "graphed": 0}:
                    raise AssertionError(f"[28] {tag}: the step waits for "
                                         f"the card")
            # a replay's trace holds the graph's kernels, and the card ran
            # the port's kernels as often as the counters say. The totals
            # are printed, not held: the trace's count of one graph's
            # replays varies by a kernel or two (4029 and 4030 for the
            # same int4x2 replay), so eager and graphed totals part by
            # as much
            if compare and not (e["trace_launches"] == g["trace_launches"]
                                == per):
                raise AssertionError(
                    f"[28] {tag} {ctx}: the port's kernels in the trace a "
                    f"step, eager {e['trace_launches']}, graphed "
                    f"{g['trace_launches']}; counters {per}")
            del graph, eager, base, cache_g, lg_e, lg_g
            torch.cuda.empty_cache()

    # the slot pool: 4 slots, 6 requests, graphed against eager (K1)
    _, dcfg, qs = faithful_config(320, cfg.n_layers)
    dq = deployed_from_quantizers(qs, cfg.n_kv_heads, cfg.d_head,
                                  device="cuda")
    rng = np.random.default_rng(28)
    reqs = [(rng.integers(0, cfg.vocab_size, size=int(n)).astype(np.int32),
             int(m)) for n, m in zip(rng.integers(40, 160, 6),
                                     rng.integers(6, 20, 6))]
    served = {}
    for graphed in (False, True):
        srv = serve.Server(params, cfg, dcfg, dq, n_slots=4, seed=0,
                           device="cuda")
        if not graphed:  # the reference: the eager step in the graph's place
            srv._step = lambda t, p, srv=srv: engine.decode_step(
                params, cfg, dcfg, dq, srv.cache, t, p,
                k_chan=static_channels(dq, dcfg))[1]
        before = launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        done = srv.run([serve.Request(rid=i, prompt=p, max_new_tokens=m)
                        for i, (p, m) in enumerate(reqs)])
        torch.cuda.synchronize()
        k1 = launch_counts()["K1"] - before["K1"]
        served[graphed] = {rid: c.tokens for rid, c in done.items()}
        out[f"serve_{'graphed' if graphed else 'eager'}"] = dict(
            wall_s=time.perf_counter() - t0, steps=srv.decode_steps, k1=k1)
        if k1 != cfg.n_layers * srv.decode_steps:
            raise AssertionError(f"[28] serve: K1 {k1}, steps "
                                 f"{srv.decode_steps}")
        del srv
    same = served[True] == served[False]
    se, sg = out["serve_eager"], out["serve_graphed"]
    log(f"[28] serve.Server 4 slots, {len(reqs)} requests: graphed tokens == "
        f"eager {same}; {sg['steps']} decode steps, K1 {sg['k1']}; wall "
        f"eager {se['wall_s']:.3f} s, graphed {sg['wall_s']:.3f} s")
    if not same:
        raise AssertionError("[28] serve: graphed tokens != eager")
    out["serve_equal"] = same
    report["graphed"] = out
    del params
    torch.cuda.empty_cache()


# (tag, config of LLaMA-2-7B width): the paged server's storage modes, both
# through K5
PAGED_GRAPH_PATHS = (("K5 nuq3", "faithful_config"),
                     ("K5 int4x2", "speed2_config"))


def pools_equal(a, b) -> bool:
    """Every array of two page pools bitwise (fp32 as bit patterns)."""
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if x.dtype == torch.float32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        if not torch.equal(x, y):
            return False
    return True


def paged_alias_check(tag, cfg, dcfg, dq, repeats=64):
    """One layer's appends (paged_append_token) with slots 1 and 3 inactive:
    slot 1's table row and position alias active slot 0's page row, slot
    3's lie one row past active slot 2's (the same bit-plane word). Each
    append must leave the pool bitwise as the same append leaves a copy
    whose inactive slots point at a spare page. Returns the repeats that
    differed (0)."""
    from kvquant_tpu_torch import paged

    dev = torch.device("cuda")
    S, P = dcfg.sink, dcfg.page_tokens
    gen = torch.Generator(device=dev).manual_seed(29)
    pool = paged.create_paged_pool(dcfg, 1, 5, 4, device="cuda")
    for f in dataclasses.fields(pool):
        a = getattr(pool, f.name)
        if a.dtype == torch.float32:
            a.copy_(torch.randn(a.shape, generator=gen, device=dev))
        else:
            a.copy_(torch.randint(-2 ** 31, 2 ** 31 - 1, a.shape,
                                  generator=gen, device=dev,
                                  dtype=torch.int64).to(a.dtype))
    ref = paged.PagedPool(**{f.name: getattr(pool, f.name).clone()
                             for f in dataclasses.fields(pool)})
    table = torch.tensor([[0, 1], [0, 1], [2, 3], [2, 3]], dtype=torch.int32,
                         device=dev)
    spare = table.clone()
    spare[1] = spare[3] = 4
    act = torch.tensor([True, False, True, False], device=dev)
    lq, C = dq.layer(0), cfg.kv_hidden
    bad = 0
    for i in range(repeats):
        p0, p2 = S + P - 32 + i, S + 100 + i  # slot 0 crosses its page
        pos = torch.tensor([p0, p0, p2, p2 + 1], dtype=torch.int32,
                           device=dev)
        k = torch.randn((4, C), generator=gen, device=dev) * 2
        v = torch.randn((4, C), generator=gen, device=dev)
        paged.paged_append_token(pool, table, lq, dcfg, cfg, k, v, pos, 0,
                                 act)
        paged.paged_append_token(ref, spare, lq, dcfg, cfg, k, v, pos, 0, act)
        bad += not pools_equal(pool, ref)
    torch.cuda.synchronize()
    log(f"[29] {tag}: aliasing inactive slots, {repeats} appends: pool == "
        f"the same appends without the aliases in {repeats - bad} of "
        f"{repeats}")
    return bad


def paged_write_ms(cfg, dcfg, dq, pool, host):
    """Device ms of one step's pool writes: every layer's paged_append_token
    (the step's page_rows included) against the same layers' quantization
    alone, each captured as a CUDA graph (engine.CapturedStep) and timed
    over back-to-back replays; returns (appends ms, quantization ms)."""
    from kvquant_tpu_torch import paged
    from kvquant_tpu_torch.cache import static_channels
    from kvquant_tpu_torch.engine import CapturedStep
    from kvquant_tpu_torch.models import llama
    from kvquant_tpu_torch.ops.deployed import _quantize_token

    dev = torch.device("cuda")
    _, pos, act, table = (torch.as_tensor(a, device=dev) for a in host)
    B = pos.shape[0]
    gen = torch.Generator(device=dev).manual_seed(30)
    k = torch.randn((B, cfg.kv_hidden), generator=gen, device=dev).to(
        torch.bfloat16)
    v = torch.randn((B, cfg.kv_hidden), generator=gen, device=dev).to(
        torch.bfloat16)
    cos_sin = llama.rope_cos_sin(pos, cfg)
    k_chan = static_channels(dq, dcfg)
    chan = [None if k_chan is None else k_chan[li]
            for li in range(cfg.n_layers)]

    def appends():
        at = paged.page_rows(pool, table, pos, act, dcfg)
        for li in range(cfg.n_layers):
            paged.paged_append_token(pool, table, dq.layer(li), dcfg, cfg, k,
                                     v, pos, li, rows=at, cos_sin=cos_sin,
                                     k_chan=chan[li])

    def quantize():
        for li in range(cfg.n_layers):
            _quantize_token(dq.layer(li), dcfg, cfg, k, v, *cos_sin, chan[li])

    return tuple(device_ms(CapturedStep(fn, dev).replay, n=8, reps=3)
                 for fn in (appends, quantize))


def paged_step_walls(st, host, burst, reps):
    """Wall ms of a server decode step on the stepper ``st`` (copy the host
    state in, one step, read the logits: PagedServer.step) and of a burst
    step (copy in once, ``burst`` steps, one read of the tokens:
    PagedServer._step_burst), over ``reps`` of each after a warm-up."""
    emitted = torch.zeros((burst, st.token.shape[0]), dtype=torch.int32,
                          device="cuda")

    def one():
        st.load(*host)
        return st().cpu()

    def burst_run():
        st.load(*host)
        for h in range(burst):
            emitted[h].copy_(st.token)
            st()
        return torch.cat([emitted, st.token[None], st.pos[None]]).cpu()

    out = {}
    for name, fn, steps in (("step", one, 1), ("burst", burst_run, burst)):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        out[name] = (time.perf_counter() - t0) / (reps * steps) * 1e3
    return out


def paged_varied_admission(params, cfg, dcfg, dq):
    """PagedServer with prompts of 1 to 6 pages of 256 (5 temporary
    capacities, out of their first-use order, one used three times), 2
    slots, 8 tokens each: graphed tokens and pool == an eager server's
    (its step and its admission chunks eager); the admission caches view
    one buffer; the graphed server's peak memory over its run, the
    admission buffer, the growth of the chunk graphs' shared pool, and
    what one cache for each capacity would hold."""
    from kvquant_tpu_torch import paged
    from kvquant_tpu_torch.cache import cache_storage_bytes
    from kvquant_tpu_torch.serve import Request

    P, N, slots, chunk = 256, 8, 2, 256
    lens = (200, 900, 450, 1400, 200, 700, 200)  # 1, 4, 2, 6, 1, 3, 1 pages
    rng = np.random.default_rng(29)
    prompts = [rng.integers(0, cfg.vocab_size, t).astype(np.int32)
               for t in lens]
    mp = max(-(-(t + N - dcfg.sink) // P) for t in lens)
    dcfg = dataclasses.replace(dcfg, page_tokens=P,
                               max_len=dcfg.sink + mp * P)
    res = {}
    for mode in ("graphed", "eager"):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        srv = paged.PagedServer(params, cfg, dcfg, dq, n_pages=slots * mp,
                                n_slots=slots, max_pages_per_slot=mp,
                                admit_mode="chunked", admit_chunk=chunk,
                                burst=4, device="cuda")
        if mode == "eager":
            srv._step = paged.PagedStep(params, cfg, dcfg, dq, srv.pool,
                                        srv.MP)
            held = srv._admission_cache

            def eager_held(tmp_dcfg, held=held):
                h = held(tmp_dcfg)
                h.graphed = False
                return h

            srv._admission_cache = eager_held
        t0 = time.perf_counter()
        comps = srv.run([Request(rid=i, prompt=p, max_new_tokens=N)
                         for i, p in enumerate(prompts)])
        torch.cuda.synchronize()
        res[mode] = dict(
            srv=srv, wall_s=time.perf_counter() - t0,
            tokens={rid: c.tokens for rid, c in comps.items()},
            peak_mib=(torch.cuda.max_memory_allocated() - base) / 2 ** 20)
    g, e = res["graphed"], res["eager"]
    srv = g["srv"]
    mem = srv._adm_memory
    caps = sorted(srv._adm_caches)
    graphs = [x for h in srv._adm_caches.values() for x in h.graphs.values()]
    one_buffer = all(
        getattr(h.cache, f.name).untyped_storage().data_ptr()
        == mem.storage.untyped_storage().data_ptr()
        for h in srv._adm_caches.values()
        for f in dataclasses.fields(h.cache))
    per_cap = sum(cache_storage_bytes(h.dcfg, cfg.n_layers, 1)
                  for h in srv._adm_caches.values())
    out = dict(capacities=caps, graphs=len(graphs), one_buffer=one_buffer,
               tokens_equal=g["tokens"] == e["tokens"],
               pools_equal=pools_equal(srv.pool, e["srv"].pool),
               storage_mib=mem.storage.numel() / 2 ** 20,
               per_capacity_mib=per_cap / 2 ** 20,
               pool_mib=sum(x.pool_mib for x in graphs),
               capture_s=sum(x.capture_s for x in graphs),
               peak_mib={m: res[m]["peak_mib"] for m in res},
               wall_s={m: res[m]["wall_s"] for m in res})
    log(f"[29] varied prompts {lens} ({len(caps)} capacities "
        f"{[c // P for c in caps]} pages of {P}, MP {mp}): graphed == "
        f"eager tokens {out['tokens_equal']}, pool {out['pools_equal']}; "
        f"{out['graphs']} chunk graphs, capture {out['capture_s']:.3f} s, "
        f"one admission buffer {out['one_buffer']} "
        f"({out['storage_mib']:.1f} MiB; a cache for each capacity would "
        f"hold {out['per_capacity_mib']:.1f} MiB), the graphs' shared pool "
        f"{out['pool_mib']:.1f} MiB; the server's peak over its run: "
        f"graphed {out['peak_mib']['graphed']:.1f} MiB, eager "
        f"{out['peak_mib']['eager']:.1f} MiB; wall graphed "
        f"{out['wall_s']['graphed']:.3f} s, eager "
        f"{out['wall_s']['eager']:.3f} s")
    if not (out["tokens_equal"] and out["pools_equal"] and one_buffer
            and len(caps) == 5):
        raise AssertionError("[29] varied prompts: graphed != eager, or "
                             "the admission caches do not share one buffer")
    return out


def phase_paged_graph(report):
    """PagedServer's step graph (paged.PagedGraph) against the eager
    PagedStep swapped into the same server, at LLaMA-2-7B width with phase
    15's requests (random bf16 weights from a seed): tokens, pool and free
    list bitwise; wall, tok/s and the admission's share; a steady-state
    4-slot step's device ms, wall ms a step and a burst step, idle share,
    kernels and K5 by name in the trace; the aliasing appends; then the
    admission of prompts of varied length (paged_varied_admission)."""
    from kvquant_tpu_torch import paged
    from kvquant_tpu_torch.cache import deployed_from_quantizers
    from kvquant_tpu_torch.models import init_params
    from kvquant_tpu_torch.models.config import LLAMA2_7B
    from kvquant_tpu_torch.ops.kernels import launch_counts

    cfg = LLAMA2_7B
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         dtype=torch.bfloat16, device="cuda")
    makers = {"faithful_config": faithful_config,
              "speed2_config": speed2_config}
    n_req, T, N, P, slots, chunk, burst = 8, 2048, 64, 1024, 4, 256, 32
    maxlen = T + N + 64  # cli.serve_demo's default
    mp = -(-(maxlen - 5) // P)
    k5_names = {"K5": ("fd_decode",)}
    out = {}
    for tag, make in PAGED_GRAPH_PATHS:
        t_case = time.perf_counter()
        _, dcfg, qs = makers[make](maxlen, cfg.n_layers)
        dcfg = dataclasses.replace(dcfg, page_tokens=P, kernel="flash")
        dq = deployed_from_quantizers(qs, cfg.n_kv_heads, cfg.d_head,
                                      device="cuda")
        r = out[tag] = {}
        servers = {}
        for mode in ("graphed", "eager"):
            srv = paged.PagedServer(params, cfg, dcfg, dq,
                                    n_pages=slots * mp, n_slots=slots,
                                    max_pages_per_slot=mp,
                                    admit_mode="chunked", admit_chunk=chunk,
                                    burst=burst, device="cuda")
            if mode == "graphed":
                g = srv._step
                r.update(capture_s=g.capture_s, pool_mib=g.pool_mib,
                         setup_launches=g.setup_launches,
                         launches_per_step=g.launches)
            else:  # the reference: the eager step in the graph's place
                srv._step = paged.PagedStep(params, cfg, dcfg, dq, srv.pool,
                                            srv.MP)
            admit = [0.0]
            if mode == "eager":  # and eager admission chunks
                held = srv._admission_cache

                def eager_held(tmp_dcfg, held=held):
                    h = held(tmp_dcfg)
                    h.graphed = False
                    return h

                srv._admission_cache = eager_held

            def timed_admit(inner=srv._admit, admit=admit):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                inner()
                torch.cuda.synchronize()
                admit[0] += time.perf_counter() - t0

            srv._admit = timed_admit
            reqs = demo_prompts(n_req, T, N, cfg.vocab_size)
            before = launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            comps = srv.run(reqs)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            n = {k: v - before[k] for k, v in launch_counts().items()}
            tokens = {rid: c.tokens for rid, c in comps.items()}
            n_tok = sum(len(t) for t in tokens.values())
            r[mode] = dict(wall_s=wall, admit_s=admit[0], tokens=n_tok,
                           tok_s=n_tok / wall,
                           decode_tok_s=n_tok / (wall - admit[0]),
                           launches=n)
            servers[mode] = (srv, tokens)
            if mode == "graphed":  # the admission chunks' graphs
                gs = [g for h in srv._adm_caches.values()
                      for g in h.graphs.values()]
                if len(gs) != 2 * len(srv._adm_caches):
                    raise AssertionError(f"[29] {tag}: admission graphs "
                                         f"{len(gs)}")
                r.update(adm_graphs=len(gs),
                         adm_capture_s=sum(g.capture_s for g in gs),
                         adm_pool_mib=sum(g.pool_mib for g in gs))
            if [len(tokens[q.rid]) for q in reqs] != \
                    [q.max_new_tokens for q in reqs]:
                raise AssertionError(f"[29] {tag} {mode}: a budget was not "
                                     f"served")
        (sg, tg), (se, te) = servers["graphed"], servers["eager"]
        r["tokens_equal"] = tg == te
        r["pools_equal"] = pools_equal(sg.pool, se.pool)
        r["free_equal"] = sg.free == se.free
        g_run, e_run = r["graphed"], r["eager"]
        if g_run["launches"] != e_run["launches"] or \
                g_run["launches"]["K5"] % cfg.n_layers:
            raise AssertionError(f"[29] {tag}: launches graphed "
                                 f"{g_run['launches']} eager "
                                 f"{e_run['launches']}")
        if r["launches_per_step"] != {"K5": cfg.n_layers}:
            raise AssertionError(f"[29] {tag}: a replay launches "
                                 f"{r['launches_per_step']}")
        log(f"[29] {tag}: graphed == eager: tokens {r['tokens_equal']}, "
            f"pool {r['pools_equal']}, free list {r['free_equal']}; "
            f"{g_run['tokens']} tokens, "
            f"{g_run['launches']['K5'] // cfg.n_layers} decode steps, "
            f"launches {g_run['launches']}; capture {r['capture_s']:.3f} s, "
            f"graph pool {r['pool_mib']:.1f} MiB, warm-up launches "
            f"{r['setup_launches']}; admission: {r['adm_graphs']} chunk "
            f"graphs, capture {r['adm_capture_s']:.3f} s, pools "
            f"{r['adm_pool_mib']:.1f} MiB (the eager server's admission "
            f"runs eager chunks)")
        for mode in ("eager", "graphed"):
            x = r[mode]
            log(f"[29] {tag} {mode} server: {x['wall_s']:.3f} s, "
                f"{x['tok_s']:.2f} tok/s aggregate; admission "
                f"{x['admit_s']:.3f} s ({x['admit_s'] / x['wall_s']:.3f} of "
                f"the wall), decode {x['wall_s'] - x['admit_s']:.3f} s "
                f"({x['decode_tok_s']:.2f} tok/s)")
        if not (r["tokens_equal"] and r["pools_equal"] and r["free_equal"]):
            raise AssertionError(f"[29] {tag}: graphed != eager")
        del servers, se, te, tg

        # steady state: 4 active slots over the pool's pages, at 35-65% of
        # their capacity, positions reloaded at every server step
        pos0 = (5 + mp * P * np.linspace(0.35, 0.65, slots)).astype(np.int32)
        host = (np.zeros(slots, np.int32), pos0, np.ones(slots, bool),
                np.arange(slots * mp, dtype=np.int32).reshape(slots, mp))
        steppers = {"graphed": sg._step, "eager": paged.PagedStep(
            params, cfg, dcfg, dq, sg.pool, sg.MP)}
        steppers["graphed"].load(*host)
        dev_ms = device_ms(steppers["graphed"], n=8, reps=3)
        r["device_ms"] = dev_ms
        for mode, st in steppers.items():
            walls = paged_step_walls(st, host, 8,
                                     reps=1 if mode == "eager" else 10)
            st.load(*host)
            kms, kern, own, _ = step_trace(st, n=2, kernels=k5_names)
            r[f"{mode}_steady"] = x = dict(
                step_wall_ms=walls["step"], burst_wall_ms=walls["burst"],
                step_idle=1 - dev_ms / walls["step"],
                burst_idle=1 - dev_ms / walls["burst"], kernel_ms=kms,
                kernels=kern, trace_launches=own)
            log(f"[29] {tag} {mode}, {slots} active slots at "
                f"{pos0.min()}-{pos0.max()}: device {dev_ms:.3f} ms a step "
                f"(graph replays); wall {x['step_wall_ms']:.3f} ms a server "
                f"step (idle {x['step_idle']:.3f}), {x['burst_wall_ms']:.3f} "
                f"ms a burst step (idle {x['burst_idle']:.3f}); profiler "
                f"kernel ms {kms:.3f}, {kern:.0f} kernels a step, K5 in the "
                f"trace {own}")
            if own != {"K5": float(cfg.n_layers)}:
                raise AssertionError(f"[29] {tag} {mode}: K5 kernels in "
                                     f"the trace a step {own}")
        r["append_ms"], r["quantize_ms"] = paged_write_ms(
            cfg, dcfg, dq, sg.pool, host)
        log(f"[29] {tag}: a step's {cfg.n_layers} appends {r['append_ms']:.3f}"
            f" device ms, their quantization alone {r['quantize_ms']:.3f}: "
            f"the pool writes {r['append_ms'] - r['quantize_ms']:.3f} ms "
            f"({(r['append_ms'] - r['quantize_ms']) / dev_ms:.3f} of the "
            f"step)")
        r["alias_mismatches"] = paged_alias_check(tag, cfg, dcfg, dq)
        if r["alias_mismatches"]:
            raise AssertionError(f"[29] {tag}: an inactive slot's scatter "
                                 f"changed the pool")
        del steppers, sg
        torch.cuda.empty_cache()
        if tag == PAGED_GRAPH_PATHS[0][0]:
            r["varied"] = paged_varied_admission(params, cfg, dcfg, dq)
        log(f"[29] {tag}: {time.perf_counter() - t_case:.1f} s")
    report["paged_graph"] = out
    del params
    torch.cuda.empty_cache()


# (tag, config of LLaMA-2-7B width, kernel): the quantized prefill's chunk
# graph (the int4x2 config's 32K prefill, graphed and eager, is phase 22's)
PREFILL_GRAPH_PATHS = (
    ("K1 nuq3", "faithful_config", "flash"),
    ("K3/K4 nuq3", "faithful_config", "pallas"),
    ("K1 int4x2", "speed2_config", "flash"),
    ("K1 speed int4", "speed_config", "flash_serial"),
)


@contextlib.contextmanager
def eager_prefill():
    """engine.prefill_quantized and the servers' chunked admission run
    every chunk as an eager prefill_chunk call inside this context: the
    reference the chunk graph is held to."""
    from kvquant_tpu_torch import engine

    graphable = engine.chunk_graphable
    engine.chunk_graphable = lambda cache, cfg: False
    try:
        yield
    finally:
        engine.chunk_graphable = graphable


def chunk_loop(params, cfg, dcfg, dq, cache, toks, chunk, graphed):
    """The chunks of a quantized prefill of the padded tokens ``toks``
    (1, S + n x chunk), as prefill_quantized runs them: chunk 0 eager,
    then prefill_chunk calls or one engine.ChunkGraph (its warm-up chunk
    1, replays after). Returns (every chunk's logits, cloned; the graph or
    None)."""
    from kvquant_tpu_torch import engine

    S = dcfg.sink
    out = [engine.prefill_chunk(params, cfg, dcfg, dq, cache,
                                toks[:, :S + chunk], S, True)[1].clone()]
    graph = None
    for c in range(1, (toks.shape[1] - S) // chunk):
        blk, pos0 = toks[:, S + c * chunk:S + (c + 1) * chunk], S + c * chunk
        if not graphed:
            lg = engine.prefill_chunk(params, cfg, dcfg, dq, cache, blk,
                                      pos0, False)[1]
        elif graph is None:
            graph = engine.ChunkGraph(params, cfg, dcfg, dq, cache, blk,
                                      pos0, False)
            lg = graph.first
        else:
            lg = graph(blk, pos0)
        out.append(lg.clone())
    return out, graph


def bitwise(a, b) -> bool:
    """Two fp32 tensors bit for bit."""
    return bool(torch.equal(a.view(torch.int32), b.view(torch.int32)))


def tail_walls(params, cfg, dcfg, dq, cache, toks, chunk, graph, last):
    """The last ``last`` chunks of a prefill again over its cache (the same
    tokens at the same positions write the same values): host wall ms a
    chunk of eager prefill_chunk calls and of ``graph``'s replays, and
    device ms a chunk (the replays back to back between CUDA events)."""
    from kvquant_tpu_torch import engine

    S = dcfg.sink
    n = (toks.shape[1] - S) // chunk
    blks = [(toks[:, S + c * chunk:S + (c + 1) * chunk], S + c * chunk)
            for c in range(n - last, n)]

    def eager():
        for blk, p in blks:
            engine.prefill_chunk(params, cfg, dcfg, dq, cache, blk, p, False)

    def replays():
        for blk, p in blks:
            graph(blk, p)

    out = {}
    for mode, fn in (("eager", eager), ("graphed", replays)):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out[mode] = (time.perf_counter() - t0) * 1e3 / last
    out["device"] = device_ms(replays, n=1, reps=3, warmup=1) / last
    return out


def phase_graphed_prefill(report):
    """The quantized prefill's chunk graph (engine.ChunkGraph) against the
    eager chunks at LLaMA-2-7B width (random bf16 weights from a seed,
    B=1), for nuq3 through K1 and through K3 / K4, the 2-bit int4x2 config
    and the speed config (its chunks through K1): a 2048-token prompt (8
    chunks of 256) through engine.prefill_quantized eager and graphed,
    and the chunk loop eager and through one graph: every chunk's logits,
    the last token's and the four caches bitwise; launches; wall s,
    capture s, the graph pool's MiB; device ms a chunk (replays back to
    back between CUDA events), host wall ms a chunk eager and graphed and
    the idle shares over the last 4 chunks; kernels a replay and the
    port's kernels in its profiler trace == the graph's counters. Then
    short prompts, 2 to 5 chunks, through prefill_quantized eager and with
    the chunk graph forced (engine.CHUNK_GRAPH_MIN_REPLAYS 0): the wall of
    each beside what prefill_quantized chooses."""
    from kvquant_tpu_torch import engine
    from kvquant_tpu_torch.cache import (create_cache, deployed_from_quantizers,
                                         reset_cache)
    from kvquant_tpu_torch.models import init_params
    from kvquant_tpu_torch.models.config import LLAMA2_7B

    cfg = LLAMA2_7B
    L = cfg.n_layers
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         dtype=torch.bfloat16, device="cuda")
    makers = {"speed_config": speed_config, "faithful_config":
              faithful_config, "speed2_config": speed2_config}
    T0, chunk, last = 2048, 256, 4
    short = (512, 768, 1024, 1280)  # 2, 3, 4 and 5 chunks
    out = report["graphed_prefill"] = {}
    for tag, make, kernel in PREFILL_GRAPH_PATHS:
        r = out[tag] = {}
        t_case = time.perf_counter()
        _, dcfg, qs = makers[make](T0 + 64, L)
        dcfg = dataclasses.replace(dcfg, kernel=kernel)
        dq = deployed_from_quantizers(qs, cfg.n_kv_heads, cfg.d_head,
                                      device="cuda")
        S = dcfg.sink
        n_chunks = -(-(T0 - S) // chunk)
        prompt = torch.randint(
            0, cfg.vocab_size, (1, T0),
            generator=torch.Generator().manual_seed(30)).cuda()
        toks = torch.nn.functional.pad(prompt,
                                       (0, n_chunks * chunk - (T0 - S)))

        def launches(n_chunks):
            return ({"K3": L * n_chunks, "K4": L * n_chunks}
                    if kernel == "pallas" else
                    {"K1": L * n_chunks, "K1_chunk": L * n_chunks})

        want = launches(n_chunks)
        runs = {}
        for mode in ("eager", "graphed"):
            cache = create_cache(dcfg, L, 1, device="cuda")
            read = reset_launches()
            ctx = eager_prefill() if mode == "eager" \
                else contextlib.nullcontext()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with ctx:
                _, lg = engine.prefill_quantized(params, cfg, dcfg, dq,
                                                 cache, prompt,
                                                 chunk=chunk)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            n = {k: v for k, v in read().items() if v}
            if n != want:
                raise AssertionError(f"[30] {tag} {mode}: launches {n}, "
                                     f"expected {want}")
            if not bool(torch.isfinite(lg).all()):
                raise AssertionError(f"[30] {tag}: non-finite")
            runs[mode] = (cache, lg)
            r[f"{mode}_wall_s"] = wall
        r["launches"] = want
        # every chunk's logits, eager loop against the graph's
        ce = create_cache(dcfg, L, 1, device="cuda")
        lg_e, _ = chunk_loop(params, cfg, dcfg, dq, ce, toks, chunk, False)
        cache = create_cache(dcfg, L, 1, device="cuda")
        lg_g, graph = chunk_loop(params, cfg, dcfg, dq, cache, toks, chunk,
                                 True)
        for c in (ce, cache):
            c.length.fill_(T0)
        lpos = (T0 - 1) - (S + (n_chunks - 1) * chunk)
        r["chunk_logits_bitwise"] = all(
            bitwise(a, b) for a, b in zip(lg_e, lg_g))
        r["last_logits_bitwise"] = (
            bitwise(runs["eager"][1], runs["graphed"][1])
            and bitwise(lg_e[-1][:, lpos], runs["eager"][1]))
        r["caches_equal"] = (caches_equal(ce, cache)
                             and caches_equal(ce, runs["eager"][0])
                             and caches_equal(ce, runs["graphed"][0]))
        del ce, lg_e, lg_g, runs
        r.update(capture_s=graph.capture_s, pool_mib=graph.pool_mib,
                 launches_per_replay={k: v for k, v in
                                      graph.launches.items()
                                      if k in ("K1", "K3", "K4")})
        r.update(tail_walls(params, cfg, dcfg, dq, cache, toks, chunk,
                            graph, last))
        blk = toks[:, S + (n_chunks - 1) * chunk:]
        p_last = S + (n_chunks - 1) * chunk
        kms, kern, own, _ = step_trace(lambda: graph(blk, p_last), n=2)
        r.update(kernel_ms=kms, kernels=kern, trace_launches=own)
        log(f"[30] {tag} {T0}-token prefill ({n_chunks} chunks of "
            f"{chunk}): wall eager {r['eager_wall_s']:.3f} s, graphed "
            f"{r['graphed_wall_s']:.3f} s; launches {want}; capture "
            f"{graph.capture_s:.3f} s, pool {graph.pool_mib:.1f} MiB; last "
            f"{last} chunks: device {r['device']:.3f} ms a chunk (graph "
            f"replays), host wall eager {r['eager']:.3f} ms (idle "
            f"{1 - r['device'] / r['eager']:.3f}), graphed "
            f"{r['graphed']:.3f} ms (idle "
            f"{1 - r['device'] / r['graphed']:.3f}); a replay: "
            f"{kern:.0f} kernels, {kms:.3f} kernel ms, the port's "
            f"kernels in the trace {own}, counters "
            f"{r['launches_per_replay']}")
        log(f"[30] {tag}: graphed == eager: chunk logits bitwise "
            f"{r['chunk_logits_bitwise']}, caches equal "
            f"{r['caches_equal']}, last-token logits bitwise "
            f"{r['last_logits_bitwise']}")
        if not (r["chunk_logits_bitwise"] and r["caches_equal"]
                and r["last_logits_bitwise"]):
            raise AssertionError(f"[30] {tag}: graphed != eager")
        per = {k: float(v) for k, v in r["launches_per_replay"].items()}
        if own != per or not per:
            raise AssertionError(f"[30] {tag}: the port's kernels in the "
                                 f"trace {own}, counters {per}")
        del graph
        # short prompts: eager, the chunk graph forced, and the choice
        keep = engine.CHUNK_GRAPH_MIN_REPLAYS
        r["short"] = {}
        for t in short:
            n_c = -(-(t - S) // chunk)
            walls = {}
            for mode in ("eager", "forced"):
                reset_cache(cache)
                read = reset_launches()
                ctx = eager_prefill() if mode == "eager" \
                    else contextlib.nullcontext()
                engine.CHUNK_GRAPH_MIN_REPLAYS = 0
                try:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    with ctx:
                        _, lg = engine.prefill_quantized(
                            params, cfg, dcfg, dq, cache, prompt[:, :t],
                            chunk=chunk)
                    torch.cuda.synchronize()
                    walls[mode] = time.perf_counter() - t0
                finally:
                    engine.CHUNK_GRAPH_MIN_REPLAYS = keep
                n = {k: v for k, v in read().items() if v}
                if n != launches(n_c) or not bool(torch.isfinite(lg).all()):
                    raise AssertionError(f"[30] {tag} {t} {mode}: launches "
                                         f"{n}, expected {launches(n_c)}")
            walls["chosen"] = "graphed" if n_c - 2 >= keep else "eager"
            r["short"][t] = walls
        log(f"[30] {tag} short prompts, wall s eager / chunk graph forced "
            f"(prefill_quantized's choice at CHUNK_GRAPH_MIN_REPLAYS "
            f"{keep}): " + ", ".join(
                f"{t} ({-(-(t - S) // chunk)} chunks) {w['eager']:.3f} / "
                f"{w['forced']:.3f} ({w['chosen']})"
                for t, w in r["short"].items())
            + f"; {time.perf_counter() - t_case:.1f} s")
        del cache
        torch.cuda.empty_cache()
    del params
    torch.cuda.empty_cache()


def phase_fp16_graph(report):
    """The fp16-KV baseline's step as one CUDA graph (baseline_fp16.
    DecodeGraph) against its eager step at LLaMA-2-7B width (random bf16
    weights, B=1, the bf16 cache read in fp32): 64 greedy steps after a
    2048-token prefill from clones of one cache, tokens, every step's
    logits and the caches bitwise, no host wait in either step; tok/s,
    device ms a step (replays back to back between CUDA events), idle
    share and the profiler's kernels a step, eager and graphed, at 2K and
    at 32K (a cache drawn at random, as the fp16 prefill of 32K tokens
    does not fit); capture s and pool MiB; cli.passkey without
    --quantizers at toy width replays the graph."""
    from kvquant_tpu_torch import baseline_fp16, engine
    from kvquant_tpu_torch.cli import passkey as passkey_cli
    from kvquant_tpu_torch.models import init_params
    from kvquant_tpu_torch.models.config import LLAMA2_7B

    cfg = LLAMA2_7B
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         dtype=torch.bfloat16, device="cuda")
    out = {}
    for ctx, steps in ((2048, 64), (32768, 8)):
        t_case = time.perf_counter()
        fcache = baseline_fp16.create_fp16_cache(cfg, ctx + steps + 8, 1,
                                                 device="cuda")
        compare = ctx == 2048
        if compare:
            prompt = torch.randint(
                0, cfg.vocab_size, (1, ctx),
                generator=torch.Generator().manual_seed(31)).cuda()
            baseline_fp16.prefill(params, cfg, fcache, prompt)
        else:
            for t in (fcache.k, fcache.v):  # drawn layer by layer
                for li in range(cfg.n_layers):
                    t[li].normal_(generator=torch.Generator(device="cuda")
                                  .manual_seed(li))
            fcache.length.fill_(ctx)
        ref = baseline_fp16.Fp16Cache(
            **{f.name: getattr(fcache, f.name).clone()
               for f in dataclasses.fields(fcache)}) if compare else fcache
        graph = baseline_fp16.DecodeGraph(params, cfg, fcache)

        def eager(tok, pos, c=ref):
            return baseline_fp16.decode_step(params, cfg, c, tok, pos)[1]

        tok_e, lg_e, wall_e, _ = greedy_run(eager, ctx, steps)
        tok_g, lg_g, wall_g, _ = greedy_run(graph, ctx, steps)
        r = out[ctx] = {"capture_s": graph.capture_s,
                        "pool_mib": graph.pool_mib}
        pos_end = torch.full((1,), ctx + steps, dtype=torch.int32,
                             device="cuda")
        if compare:
            r["tokens_equal"] = bool(torch.equal(tok_e, tok_g))
            r["logits_bitwise"] = bitwise(lg_e, lg_g)
            r["caches_equal"] = all(
                torch.equal(getattr(ref, n), getattr(fcache, n))
                for n in ("k", "v", "length"))
            r["host_waits"] = {
                "eager": host_syncs(lambda: eager(tok_e[:, -1], pos_end))[0],
                "graphed": host_syncs(lambda: graph(tok_e[:, -1],
                                                    pos_end))[0]}
        dev = device_ms(lambda: graph(tok_e[:, -1], pos_end), n=8, reps=3)
        for mode, step, wall in (("eager", eager, wall_e),
                                 ("graphed", graph, wall_g)):
            wall_ms = wall / steps * 1e3
            kms, kern = step_profile(lambda: step(tok_e[:, -1], pos_end), n=2)
            r[mode] = {"tok_s": steps / wall, "wall_ms": wall_ms,
                       "device_ms": dev, "idle": 1 - dev / wall_ms,
                       "kernel_ms": kms, "kernels": kern}
        e, g = r["eager"], r["graphed"]
        log(f"[31] fp16-KV baseline {ctx} ctx, {steps} steps: device "
            f"{dev:.3f} ms a step (graph replays); eager {e['tok_s']:.2f} "
            f"tok/s (wall {e['wall_ms']:.3f} ms, idle {e['idle']:.3f}, "
            f"{e['kernels']:.0f} kernels, {e['kernel_ms']:.3f} kernel ms); "
            f"graphed {g['tok_s']:.2f} tok/s (wall {g['wall_ms']:.3f} ms, "
            f"idle {g['idle']:.3f}, {g['kernels']:.0f} kernels, "
            f"{g['kernel_ms']:.3f} kernel ms); capture {graph.capture_s:.3f}"
            f" s, pool {graph.pool_mib:.1f} MiB; "
            f"{time.perf_counter() - t_case:.1f} s")
        if compare:
            log(f"[31] fp16-KV baseline: graphed == eager: tokens "
                f"{r['tokens_equal']}, logits bitwise {r['logits_bitwise']},"
                f" caches equal {r['caches_equal']}, host waits a step "
                f"{r['host_waits']}")
            if not (r["tokens_equal"] and r["logits_bitwise"]
                    and r["caches_equal"]
                    and bool(torch.isfinite(lg_g).all())):
                raise AssertionError("[31] the baseline graph != eager")
            if r["host_waits"] != {"eager": 0, "graphed": 0}:
                raise AssertionError("[31] the baseline step waits for the "
                                     "card")
        del graph, fcache, ref, lg_e, lg_g
        torch.cuda.empty_cache()
    del params
    torch.cuda.empty_cache()

    # cli.passkey's baseline (no --quantizers) replays the graph
    replays = [0]
    replay = engine.CapturedStep.replay

    def counting(self):
        replays[0] += 1
        return replay(self)

    engine.CapturedStep.replay = counting
    try:
        res = passkey_cli.main(
            ["--toy-layers", "4", "--toy-dmodel", "256", "--toy-heads", "8",
             "--toy-kv-heads", "4", "--toy-vocab", "512", "--device", "cuda",
             "--ctx", "512", "--trials", "2"])
    finally:
        engine.CapturedStep.replay = replay
    log(f"[31] cli.passkey (fp16-KV baseline) ctx 512 x 2 trials: accuracy "
        f"{res[0].accuracy:.2f}, {replays[0]} graph replays")
    if replays[0] == 0:
        raise AssertionError("[31] cli.passkey's baseline did not replay "
                             "its graph")
    out["passkey_replays"] = replays[0]
    report["fp16_graph"] = out


PHASES = {1: phase_device_and_build, 2: phase_kernel_vs_plain,
          3: phase_main_path, 4: phase_card_vs_cpu, 5: phase_times,
          6: phase_k1_vs_plain, 7: phase_k1_main_path,
          8: phase_k1_card_vs_cpu, 9: phase_k1_times,
          10: phase_k34_vs_plain, 11: phase_pallas_main_path,
          12: phase_pallas_card_vs_cpu, 13: phase_k34_times,
          14: phase_k5_vs_plain, 15: phase_paged_main_path,
          16: phase_paged_card_vs_cpu, 17: phase_k5_times,
          18: phase_x2_vs_plain, 19: phase_x2_main_path,
          20: phase_x2_oracle, 21: phase_x2_times,
          22: phase_long_prefill, 23: phase_calibrate_deploy,
          24: phase_mistral, 25: phase_dbrx, 26: phase_tp,
          27: phase_training, 28: phase_graphed_decode,
          29: phase_paged_graph, 30: phase_graphed_prefill,
          31: phase_fp16_graph}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(map(str, PHASES)),
                    help="comma-separated subset, for debugging")
    ap.add_argument("--verbose-build", action="store_true",
                    help="print nvcc's register / spill report")
    ap.add_argument("--tp-rank", default=None, metavar="DIR",
                    help="run as one rank of phase 26 (started by it)")
    args = ap.parse_args(argv)
    global VERBOSE_BUILD
    VERBOSE_BUILD = args.verbose_build
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    import kvquant_tpu_torch  # noqa: F401  (fails outside a checkout)
    if args.tp_rank:
        return tp_rank_main(args.tp_rank)

    phases = [int(p) for p in args.phases.split(",")]
    report: dict = {}
    t_all = time.perf_counter()
    for p in phases:
        t0 = time.perf_counter()
        PHASES[p](report)
        log(f"[{p}] done in {time.perf_counter() - t0:.1f} s")
    log(f"total {time.perf_counter() - t_all:.1f} s")

    kernels = []
    if 5 in phases and 3 in phases:
        t = report["times"][-1]
        kernels.append({
            "name": "flash_serial_decode",
            "route": "cuda",
            "source": "kvquant_tpu_torch/csrc/flash_serial.cu",
            "replaces": "kvquant_tpu/ops/pallas/flash_serial.py:62",
            "body": t["body"],
            "launches": report["launches"],
            "launches_by_body": report["route_launches"],
            "max_abs_err": report["max_abs_err_main"],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": "bytes",
            "library_ms": None,
            "fs_partial_ms": t["partial_ms"],
            "ms_32k": report["times"][0]["ms"],
            "bound_ms_32k": report["times"][0]["bound_ms"],
            "fs_partial_ms_32k": report["times"][0]["partial_ms"],
            "shape": f"B=1 Hkv=32 G=1 D=128 hg=16 int4 n_kc=16 cap=0 "
                     f"bf16 dots, {t['ctx']} tokens",
        })
    if 9 in phases and 7 in phases:
        t = report["k1_times"][0]  # decode at 32K
        c = report["k1_times"][3]  # a 256-row chunk at 32K
        kernels.append({
            "name": "flash_attention",
            "route": "cuda",
            "source": "kvquant_tpu_torch/csrc/flash_decode.cu",
            "replaces": "kvquant_tpu/ops/pallas/flash_decode.py:255",
            "launches": report["k1_launches"],
            "max_abs_err": report["k1_max_abs_err"],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": None,
            "shape": f"B=1 Hkv=32 G=1 D=128 nuq3 pre-RoPE slots cap=2 hg=4 "
                     f"sink=5, {t['kind']} Tq={t['tq']}, {t['ctx']} tokens",
            "chunk_ms": c["ms"], "chunk_bound_ms": c["bound_ms"],
            "chunk_launches": report["k1_chunk_launches"],
            "chunk_shape": f"nuq3 as above, prefill Tq={c['tq']} rows at "
                           f"{c['ctx']} tokens (fd_chunk, tensor cores)",
        })
        if 21 in phases and 19 in phases:
            x = report["x2_times"][0]  # int4x2 decode at 32K
            kernels[-1].update({
                "int4x2_launches": report["x2_k1_launches"],
                "int4x2_ms": x["ms"], "int4x2_plain_ms": x["plain_ms"],
                "int4x2_bound_ms": x["bound_ms"],
                "int4x2_max_abs_err": max(report["x2_max_abs_err"], max(
                    r["max_abs_err"] for r in report["x2_times"])),
                "int4x2_shape": "B=1 Hkv=32 G=1 D=128 int4x2 post-RoPE "
                                "channels n_kc=4 cap=0 hg=4 sink=5, decode "
                                f"Tq=1, {x['ctx']} tokens",
                "int4x2_chunk_ms": next(
                    r["ms"] for r in report["x2_times"]
                    if r.get("kind") == "prefill" and r["ctx"] == 32768),
            })
        if 23 in phases:  # cli.deploy --check + warm-up + timed pass
            kernels[-1]["deploy_launches"] = report["chain"]["k1_launches"]
        if 27 in phases:  # the card-trained toy model and retrieval model
            kernels[-1]["training_launches"] = \
                report["training"]["k1_launches"]
        if 24 in phases:  # MISTRAL_7B, G 4, window 4096
            kernels[-1].update({
                "mistral_launches": report["mistral"]["k1_launches"],
                "mistral_max_abs_err": report["mistral"]["max_abs_err"]})
    if 13 in phases and 11 in phases:
        for name, body_line, launches in (
                ("qk_fused", 156, report["k3_launches"]),
                ("pv_fused", 249, report["k4_launches"])):
            t = next(x for x in report["k34_times"]
                     if x["name"] == name and x["ctx"] == 32768)
            c = next(x for x in report["k34_times"]
                     if x["name"] == name and x["kind"] == "prefill")
            kernels.append({
                "name": name, "route": "cuda",
                "source": "kvquant_tpu_torch/csrc/attention.cu",
                "replaces": f"kvquant_tpu/ops/pallas/attention.py:{body_line}",
                "launches": launches,
                "max_abs_err": max(report["k34_max_abs_err"][name], max(
                    x["max_abs_err"] for x in report["k34_times"]
                    if x["name"] == name)),
                "ms": t["ms"], "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                "library_ms": None,
                "shape": f"B=1 Hkv=32 G=1 D=128 nuq3 pre-RoPE slots cap=2 "
                         f"hg=4 sink=5, decode R=1, Tc={t['Tc']}",
                "chunk_ms": c["ms"], "chunk_bound_ms": c["bound_ms"],
                "chunk_shape": f"R={c['R']} rows over Tc={c['Tc']} (tensor "
                               f"cores, bf16 dots)",
            })
            if 23 in phases:  # cli.deploy --kernel pallas, two passes
                kernels[-1]["deploy_launches"] = \
                    report["chain"]["k34_launches"]
    if 17 in phases and 15 in phases:
        t = report["k5_times"][-1]  # B=4 slots at 8K, as the main path
        kernels.append({
            "name": "paged_flash_decode",
            "route": "cuda",
            "source": "kvquant_tpu_torch/csrc/flash_decode.cu",
            "replaces": "kvquant_tpu/paged.py:103",
            "launches": report["k5_launches"],
            "max_abs_err": max(x["max_abs_err"]
                               for x in report["k5_times"]),
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": "bytes",
            "library_ms": None,
            "shape": f"B={t['B']} Hkv=32 G=1 D=128 nuq3 pre-RoPE slots "
                     f"cap=2 hg=4 sink=5, {t['ctx']} tokens per slot in "
                     f"{t['pages']} permuted pages of 1024",
        })
        if 21 in phases:
            x = report["x2_times"][-1]  # int4x2 K5, B=4 at 8K
            kernels[-1].update({
                "int4x2_ms": x["ms"], "int4x2_plain_ms": x["plain_ms"],
                "int4x2_bound_ms": x["bound_ms"],
                "int4x2_max_abs_err": x["max_abs_err"],
                "int4x2_shape": f"B={x['B']} Hkv=32 G=1 D=128 int4x2 "
                                "post-RoPE channels n_kc=4 cap=0 hg=4 sink=5, "
                                f"{x['ctx']} tokens per slot in "
                                f"{x['pages']} permuted pages of 1024",
            })
    if 25 in phases:  # DBRX (G 6): its launches and errors, G 6 times
        d = report["dbrx"]
        path = {"flash_attention": ("K1", d["flash"]["k1_launches"],
                                    d["flash"]["max_abs_err"]),
                "flash_serial_decode": ("K2", d["flash_serial"]["k2_launches"],
                                        d["flash_serial"]["max_abs_err"]),
                "qk_fused": ("K3", d["pallas"]["k3_launches"],
                             d["pallas"]["max_abs_err"]["qk_fused"]),
                "pv_fused": ("K4", d["pallas"]["k4_launches"],
                             d["pallas"]["max_abs_err"]["pv_fused"]),
                "paged_flash_decode": ("K5", 0, 0.0)}
        for k in kernels:
            key, launches, err = path[k["name"]]
            t = d["times"][key]
            k.update({"dbrx_launches": launches,
                      "dbrx_max_abs_err": max(err, t["max_abs_err"]),
                      "dbrx_g6_ms": t["ms"], "dbrx_g6_plain_ms": t["plain_ms"],
                      "dbrx_g6_bound_ms": t["bound_ms"],
                      "dbrx_g6_ctx": t["ctx"]})
            if "old_ms" in t:
                k["dbrx_g6_old_route_ms"] = t["old_ms"]
            k["dbrx_graphed_launches_per_step"] = next(
                (d[p]["graph"]["launches_per_step"][key]
                 for p in ("flash", "pallas", "flash_serial")
                 if key in d[p]["graph"]["launches_per_step"]), 0)
        # the tensor-core decode bodies by name: K1's at G 6 (K5's through
        # the page table beside it), K3's at R 6; the G 4 / R 4 and G 8 / R 8
        # rows of the routing decision; DBRX's graphed step at 32K
        t = d["times"]
        step = d["step_32k"]
        for name, key, launches, k5, rows in (
                ("flash_attention:fd_gqa", "K1", d["flash"]["k1_gqa_launches"],
                 True, ("K1 G4", "K1 G8")),
                ("qk_fused:qk_gqa", "K3", d["pallas"]["k3_gqa_launches"],
                 False, ("K3 R4", "K3 R8"))):
            mode = "flash" if key == "K1" else "pallas"
            kernels.append({
                "name": name, "route": "cuda",
                "source": ("kvquant_tpu_torch/csrc/flash_decode.cu" if k5
                           else "kvquant_tpu_torch/csrc/attention.cu"),
                "replaces": ("kvquant_tpu/ops/pallas/flash_decode.py:255" if k5
                             else "kvquant_tpu/ops/pallas/attention.py:156"),
                "launches": launches,
                "max_abs_err": max(t[key]["max_abs_err"],
                                   *(t[r]["max_abs_err"] for r in rows)),
                "ms": t[key]["ms"], "plain_ms": t[key]["plain_ms"],
                "bound_ms": t[key]["bound_ms"], "bound_by": "bytes",
                "library_ms": None, "old_route_ms": t[key]["old_ms"],
                "routing_rows": {r: {k: t[r][k] for k in (
                    "ms", "old_ms", "bound_ms", "route")} for r in rows},
                "dbrx_step_32k_ms": {"new": step[mode]["new_ms"],
                                     "old_routes": step[mode]["old_ms"]},
                "shape": "one DBRX layer: Hkv=8 G=6 D=128 nuq3 pre-RoPE slots "
                         "cap=2 hg=4 sink=5, bf16 dots, 32K tokens",
                **({"k5_ms": t["K5"]["ms"],
                    "k5_old_route_ms": t["K5"]["old_ms"],
                    "k5_bound_ms": t["K5"]["bound_ms"],
                    "k5_max_abs_err": t["K5"]["max_abs_err"],
                    "k5_shape": "B=4 x 8K in permuted pages of 1024"}
                   if k5 else {}),
            })
        m = d["moe_experts"]
        kernels.append({
            "name": "moe_experts", "route": "cuda",
            "source": "kvquant_tpu_torch/csrc/moe_experts.cu",
            "replaces": "kvquant_tpu/models/moe.py:148 (XLA einsums of the "
                        "capacity dispatch; no TPU kernel)",
            "launches": d["flash"]["moe_launches"],
            "max_abs_err": m["max_abs_err"],
            "ms": m["ms"], "plain_ms": m["plain_ms"],
            "bound_ms": m["bound_ms"], "bound_by": "bytes",
            "library_ms": m["library_ms"],
            "per_expert_matmul_ms": m["per_expert_matmul_ms"],
            "graphed_launches_per_step": {
                p: d[p]["graph"]["launches_per_step"]["moe_experts"]
                for p in ("flash", "pallas", "flash_serial")},
            "graphed_trace_launches_per_step": {
                p: d[p]["graph"]["graphed"]["trace_launches"]["moe_experts"]
                for p in ("flash", "pallas", "flash_serial")},
            "graphed_step_ms": {
                p: d[p]["graph"]["graphed"]["expert_products_ms"]
                for p in ("flash", "pallas", "flash_serial")},
            "shape": "one DBRX layer: E=16 D=6144 F=10752 bf16, C=1 with "
                     "top_k=4 experts live (B=1 decode)",
        })
    if 26 in phases:  # tp 2 on the card: per-rank launches and errors
        tp = report["tp"]
        for k in kernels:
            if k["name"] == "flash_attention":
                k.update({
                    "tp2_launches_per_rank": [
                        x["launches"] for x in tp["llama_k1"]["ranks"]],
                    "tp2_max_abs_err": max(
                        x["max_abs_err"] for w in ("llama_k1", "dbrx_k1")
                        for x in tp[w]["ranks"]),
                    "tp2_dbrx_launches_per_rank": [
                        x["launches"] for x in tp["dbrx_k1"]["ranks"]],
                    "tp2_ms_per_step": [
                        x["ms_per_step"] for x in tp["llama_k1"]["ranks"]]})
            if k["name"] == "flash_serial_decode":
                k.update({
                    "tp2_launches_per_rank": [
                        x["launches"] for x in tp["llama_k2"]["ranks"]],
                    "tp2_max_abs_err": max(
                        x["max_abs_err"] for x in tp["llama_k2"]["ranks"]),
                    "tp2_ms_per_step": [
                        x["ms_per_step"] for x in tp["llama_k2"]["ranks"]]})
    if 28 in phases:  # launches per replay of the captured decode step
        g = report["graphed"]
        for k in kernels:
            key, path = {"flash_attention": ("K1", "K1 nuq3"),
                         "flash_serial_decode": ("K2", "K2 speed int4"),
                         "qk_fused": ("K3", "K3/K4 nuq3"),
                         "pv_fused": ("K4", "K3/K4 nuq3")}.get(
                             k["name"], (None, None))
            if key:
                r = g[path][2048]
                k["graphed_launches_per_step"] = r["launches_per_step"][key]
                k["graphed_trace_launches_per_step"] = (
                    r["graphed"]["trace_launches"][key])
                k["graphed_tok_s_2k"] = r["graphed"]["tok_s"]
    if 29 in phases:  # launches per replay of the paged step graph
        g = report["paged_graph"]["K5 nuq3"]
        for k in kernels:
            if k["name"] == "paged_flash_decode":
                k["graphed_launches_per_step"] = g["launches_per_step"]["K5"]
                k["graphed_trace_launches_per_step"] = (
                    g["graphed_steady"]["trace_launches"]["K5"])
                k["graphed_serve_tok_s"] = g["graphed"]["tok_s"]
    if 30 in phases:  # launches per replay of the prefill chunk graph
        g = report["graphed_prefill"]
        for k in kernels:
            key, path = {"flash_attention": ("K1", "K1 nuq3"),
                         "qk_fused": ("K3", "K3/K4 nuq3"),
                         "pv_fused": ("K4", "K3/K4 nuq3")}.get(
                             k["name"], (None, None))
            if key:
                r = g[path]
                k["graphed_chunk_launches_per_replay"] = (
                    r["launches_per_replay"][key])
                k["graphed_chunk_trace_launches_per_replay"] = (
                    r["trace_launches"][key])
                k["prefill_wall_s_2k"] = {"eager": r["eager_wall_s"],
                                          "graphed": r["graphed_wall_s"]}
    if kernels:
        log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
