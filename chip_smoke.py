"""Smoke test of the PyTorch/CUDA port (kvquant_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py            # every phase, one card
    python3 chip_smoke.py --phases 1,2,3,5,21            # K2: both bodies
    python3 chip_smoke.py --phases 1,6 --verbose-build   # build + K1 check
    python3 chip_smoke.py --phases 1,6,9,14,17,18,21     # K1 / K5 decode body
    python3 chip_smoke.py --phases 1,6,9,18,21           # K1 chunk body
    python3 chip_smoke.py --phases 1,10 --verbose-build  # build + K3/K4
    python3 chip_smoke.py --phases 1,23                  # calibrate -> deploy
    python3 chip_smoke.py --phases 1,24                  # MISTRAL_7B via K1

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
     cache; the fp16-KV baseline's tok/s on the same weights; cli.passkey
     and cli.needle at toy width;
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
     tok/s, a profiler pass over steady-state steps with 4 active slots;
     then cli.serve_demo without --paged (slot pool, K1) at toy width;
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
     quantized prefill (128 chunks of 256): K1 32 x 128 chunk launches,
     wall seconds, a profiler window over the last four chunks (device ms
     in K1 against the rest, idle share), K1 against plain on the live
     cache at layers 0 and 31.
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
The line before the last lists every ported kernel as JSON; the last line
is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
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
SOURCES = ("flash_serial", "flash_decode", "attention")  # csrc/<name>.cu
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

    # one nvcc per source, all started together
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES)) as ex:
        for f in [ex.submit(build.build, name, VERBOSE_BUILD)
                  for name in SOURCES]:
            f.result()
    fs.load_library()
    fd.load_library()
    at.load_library()
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


def decode_edge_grid(tag, modes, paged):
    """The decode body (fd_decode) against the plain version over its edge
    cases, fp32 and bf16 dots: each mode x pre / post RoPE x the widths of
    ``decode_widths`` x sink 0 / 5, and a sliding window; B = 3 rows at
    ragged positions: one with no packed token (pos < S; pos 0 at sink 0),
    one whose live length 201 is not a multiple of a tile, one deep; the
    card's splits beyond a row's live tiles hold no tile. ``paged``: K5
    over permuted pages of 256 (with an inactive fourth slot aliasing the
    third's pages), also held to K1 on the same tokens. Returns the worst
    |err| / bound per dot mode."""
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
                                if not diff <= FP32_TOL * (
                                        1 + float(want.abs().max())):
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


def live_k34_check(tag, cache, dq, dcfg, cfg, li_list, gen):
    """K3 and K4 against plain on layers of a live cache: random queries
    and probabilities at R = 1 and R = 261, the main path's bf16 dots and
    fp32 dots. Returns the worst |err| of each kernel."""
    from kvquant_tpu_torch.ops.kernels import attention as at

    Hkv, D, Tc = cfg.n_kv_heads, cfg.d_head, dcfg.cache_tokens
    worst = {"qk_fused": 0.0, "pv_fused": 0.0}
    for r in (1, 261):
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
    with the faithful scheme, the fp16-KV baseline on the same weights,
    and short card runs of cli.passkey and cli.needle at toy width."""
    import os
    import shutil

    from kvquant_tpu_torch import baseline_fp16, engine
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

    # ---- the fp16-KV baseline on the same weights (context only) ----
    base = {}
    fcache = baseline_fp16.create_fp16_cache(cfg, T0 + 32, 1, device="cuda")
    baseline_fp16.prefill(params, cfg, fcache, toks)
    base["2k"], _ = decode_profile(
        f"[11] fp16-KV baseline {T0} ctx", lambda i: baseline_fp16.
        decode_step(params, cfg, fcache, tok, T0 + i), 16)
    del fcache
    fcache = baseline_fp16.create_fp16_cache(cfg, ctx + 32, 1, device="cuda")
    for t in (fcache.k, fcache.v):  # a filled cache, drawn layer by layer
        for li in range(cfg.n_layers):
            t[li].normal_(generator=torch.Generator(device="cuda")
                          .manual_seed(li))
    base["32k"], _ = decode_profile(
        f"[11] fp16-KV baseline {ctx} ctx", lambda i: baseline_fp16.
        decode_step(params, cfg, fcache, tok, ctx + i), 16)
    del fcache, params
    torch.cuda.empty_cache()
    report["fp16_baseline_tps"] = base
    log(f"[11] fp16-KV baseline (bf16 cache cast to fp32 in its attention, "
        f"as the JAX baseline does): {base['2k']:.2f} tok/s at {T0}, "
        f"{base['32k']:.2f} tok/s at {ctx}; kernel pallas: {tps2:.2f} / "
        f"{tps32:.2f} tok/s")

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


def demo_requests(n, prompt_len, max_new, vocab, seed=0):
    """The (prompt length, budget) pairs cli.serve_demo draws."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        t0 = len(rng.integers(0, vocab, size=int(prompt_len
                                                 * rng.uniform(0.5, 1.0))))
        out.append((t0, int(max_new * rng.uniform(0.5, 1.0))))
    return out


def reset_launches():
    from kvquant_tpu_torch.ops.kernels import attention as at
    from kvquant_tpu_torch.ops.kernels import flash_decode as fd
    from kvquant_tpu_torch.ops.kernels import flash_serial as fs
    from kvquant_tpu_torch.ops.kernels import paged_decode as pdk

    counters = {"K1": fd.flash_attention, "K2": fs.flash_serial_decode,
                "K3": at.qk_fused, "K4": at.pv_fused,
                "K5": pdk.paged_flash_decode}
    for fn in counters.values():
        fn.launches = 0
    fd.flash_attention.chunk_launches = 0
    fs.flash_serial_decode.route_launches = {b: 0 for b in fs.BODIES}
    return lambda: dict({k: fn.launches for k, fn in counters.items()},
                        K1_chunk=fd.flash_attention.chunk_launches)


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
        f"{chunks} admission chunks)")
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
    report["k5_launches"] = n["K5"]
    report["serve_tps"] = tokens / srv.run_s
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
    32K-token quantized prefill (128 chunks of 256): K1 32 x 128 chunk
    launches and nothing else; wall seconds; a profiler window over the
    last four chunks (run again on the same cache: device ms in K1 against
    the rest, and the idle share); K1 against plain on the live cache at
    layers 0 and 31, bf16 and fp32 dots."""
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
    # warm-up of the chunk shapes at a short prompt
    engine.prefill_quantized(params, cfg, dcfg, dq, cache, prompt[:, :1029],
                             chunk=chunk)
    torch.cuda.synchronize()
    read = reset_launches()
    t0 = time.perf_counter()
    _, logits = engine.prefill_quantized(params, cfg, dcfg, dq, cache, prompt,
                                         chunk=chunk)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    n = read()
    want = cfg.n_layers * n_chunks
    log(f"[22] 2-bit int4x2 config, LLaMA-2-7B width, {cfg.n_layers} layers: "
        f"quantized "
        f"prefill of {T0} tokens ({n_chunks} chunks of {chunk}) {wall_s:.3f} "
        f"s ({T0 / wall_s:.0f} tok/s); launches {n} (K1 chunks expected "
        f"{want})")
    if not (n["K1"] == n["K1_chunk"] == want
            and n["K2"] == n["K3"] == n["K4"] == n["K5"] == 0):
        raise AssertionError("the long prefill did not run K1 per layer and "
                             "chunk")
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("non-finite logits")

    # the last four chunks again on the same cache (same tokens, same
    # positions): unprofiled wall time, then one profiled pass
    toks = torch.nn.functional.pad(prompt, (0, n_chunks * chunk - (T0 - S)))

    def tail():
        for c in range(n_chunks - last, n_chunks):
            start = S + c * chunk
            engine.prefill_chunk(params, cfg, dcfg, dq, cache,
                                 toks[:, start:start + chunk], start, False)
    tail()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tail()
    torch.cuda.synchronize()
    tail_s = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA], acc_events=True) as prof:
        tail()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages()
          if e.device_type == torch.autograd.DeviceType.CUDA
          and e.self_device_time_total > 0]
    k1_us = sum(e.self_device_time_total for e in ev
                if "fd_chunk" in e.key or "fd_merge" in e.key)
    dev_us = sum(e.self_device_time_total for e in ev)
    idle = 1 - dev_us / 1e6 / tail_s
    log(f"[22] last {last} chunks (context {T0 - last * chunk}-{T0}): "
        f"{tail_s * 1e3 / last:.3f} ms/chunk host wall; profiler: device "
        f"{dev_us / 1e3 / last:.3f} ms/chunk, of it K1 (fd_chunk + fd_merge) "
        f"{k1_us / 1e3 / last:.3f} ms and the rest {(dev_us - k1_us) / 1e3 / last:.3f} "
        f"ms; device idle share {idle:.3f}")
    for e in sorted(ev, key=lambda e: -e.self_device_time_total)[:6]:
        log(f"[22]   {e.self_device_time_total / last / 1e3:8.3f} ms/chunk  "
            f"x{e.count // last:5d}  {e.key[:90]}")

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
          24: phase_mistral}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(map(str, PHASES)),
                    help="comma-separated subset, for debugging")
    ap.add_argument("--verbose-build", action="store_true",
                    help="print nvcc's register / spill report")
    args = ap.parse_args(argv)
    global VERBOSE_BUILD
    VERBOSE_BUILD = args.verbose_build
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    import kvquant_tpu_torch  # noqa: F401  (fails outside a checkout)

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
    if kernels:
        log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
