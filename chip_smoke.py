"""Smoke test of the PyTorch/CUDA port (kvquant_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py            # every phase, one card

Phases (each prints its own lines; any failure raises and exits non-zero):
  1. device and build: the card, torch / CUDA versions, the nvcc build of
     kvquant_tpu_torch/csrc/flash_serial.cu from this checkout;
  2. the kernel against its plain PyTorch version on the card: int4 / int8 /
     int4x2 x channels / slots x sink 0 / 5, B=2 at unequal positions, and a
     sliding window, with fp32 dots and with bf16 dot operands;
  3. the main path at full LLaMA-2-7B width (32 layers, random bf16 weights
     from a seed): prefill of a 2048-token prompt then greedy generate of
     64 tokens through the speed config (int4, post-RoPE K, 16 static K
     channels, no slots, head_group 16, sink 5, kernel "flash_serial"); the
     kernel must have run 32 times per decode step; on the live cache the
     kernel is held against the plain version at layers 0 and 31, with
     bf16 and with fp32 dots; decode tok/s, also at 32K context;
  4. card against CPU: a toy-sized random model gives the same 32 greedy
     tokens on the card and on the CPU;
  5. the kernel alone at one LLaMA-2-7B layer's shapes with a filled cache
     at 32K and 128K tokens: agreement with the plain version in both dot
     modes; kernel, plain version, bound (CUDA events
     around back-to-back calls queued behind a sleep kernel, median of 7
     repeats after warm-up; and the per-call time with host overhead).
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
FP32_TOL = 1e-4  # fp32 dots: |kernel - plain| <= FP32_TOL * (1 + max|plain|)
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
    Hc = Hkv // 2 if dcfg.codes == "int4x2" else Hkv

    def container():
        return torch.randint(0, 256, (L, B, Hc, Tc, dcfg.code_cols),
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

    from kvquant_tpu_torch.ops.kernels import build, flash_serial as fs

    t0 = time.perf_counter()
    fs.load_library()
    log(f"[1] built and loaded csrc/flash_serial.cu in "
        f"{time.perf_counter() - t0:.1f} s "
        f"(nvcc {build.build_seconds.get('flash_serial', 0.0):.1f} s)")
    report["card"] = card


def phase_kernel_vs_plain(report):
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
            got = call(fs.flash_serial_decode, q, ops, 1, pos, dcfg, mcfg)
            torch.cuda.synchronize()
            want = call(fs.flash_serial_decode_ref, q, ops, 1, pos, dcfg,
                        mcfg)
            err = agree(f"[2] {codes}/{k_out}/sink{sink}/win{window}",
                        got, want, dot_bf16)
            if not dot_bf16:
                worst = max(worst, err)
    report["max_abs_err_fp32"] = worst


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
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks, cache = engine.generate(params, cfg, dcfg, dq, prompt, gcfg,
                                  device="cuda")
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    launches = fs.flash_serial_decode.launches
    report["launches"] = launches
    log(f"[3] prefill {T0} tokens {prefill_s:.3f} s; generate (prefill + "
        f"{N} decode steps) {gen_s:.3f} s; kernel launches {launches} "
        f"(expected {cfg.n_layers * N})")
    if launches != cfg.n_layers * N:
        raise AssertionError("main path did not run the kernel per layer")
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
    gen = torch.Generator(device="cuda").manual_seed(3)
    ops = kernel_operands(dcfg32, cfg32, cfg.n_layers, 1, 1,
                          dcfg32.cache_tokens, gen, torch.device("cuda"))
    from kvquant_tpu_torch.cache import KVCache

    cache = KVCache(k_planes=ops["k_planes"], v_planes=ops["v_planes"],
                    kv_out=ops["kv_out"], v_scale=ops["v_scale"],
                    v_offset=ops["v_offset"], k_sink=ops["k_sink"],
                    v_sink=ops["v_sink"],
                    length=torch.full((1,), ctx, dtype=torch.int32,
                                      device="cuda"))
    tok = torch.zeros((1,), dtype=torch.int32, device="cuda")
    for i in range(2):  # warm-up
        engine.decode_step(params, cfg32, dcfg32, dq32, cache, tok, ctx + i)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(steps):
        _, logits = engine.decode_step(params, cfg32, dcfg32, dq32, cache,
                                       tok, ctx + 2 + i)
    torch.cuda.synchronize()
    tps32 = steps / (time.perf_counter() - t0)
    log(f"[3] decode {tps32:.2f} tok/s at {ctx} context (synthetic filled "
        f"cache, {steps} steps, host wall time)")
    report["decode_tps_32k"] = tps32

    # where a 32K decode step's time goes: device kernel time by name
    from torch.profiler import ProfilerActivity, profile

    prof_steps = 3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA], acc_events=True) as prof:
        for i in range(prof_steps):
            engine.decode_step(params, cfg32, dcfg32, dq32, cache, tok,
                               ctx + 2 + steps + i)
        torch.cuda.synchronize()
    # device-side events only: CPU ops also report the device time of the
    # kernels they launched, which would count every kernel twice
    ev = [e for e in prof.key_averages()
          if e.device_type == torch.autograd.DeviceType.CUDA
          and e.self_device_time_total > 0]
    dev_us = sum(e.self_device_time_total for e in ev) / prof_steps
    # the idle share divides the profiled device time by the step time of
    # the unprofiled loop above (the profiler slows the host)
    log(f"[3] profiler, 32K decode step: device kernel time "
        f"{dev_us / 1e3:.3f} ms/step vs {1e3 / tps32:.3f} ms/step unprofiled "
        f"wall (device idle share {1 - dev_us / 1e3 * tps32 / 1e3:.3f}); "
        f"{sum(e.count for e in ev) / prof_steps:.0f} kernels/step")
    for e in sorted(ev, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"[3]   {e.self_device_time_total / prof_steps / 1e3:8.3f} "
            f"ms/step  x{e.count // prof_steps:5d}  {e.key[:90]}")
    del cache, ops, params
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

        def kern(d=dcfg):
            return fs.flash_serial_decode(
                q, ops["k_planes"], ops["v_planes"], ops["kv_out"],
                ops["k_range"], ops["k_offset"], ops["v_scale"],
                ops["v_offset"], ops["k_sink"], ops["v_sink"], ops["k_lut"],
                ops["v_lut"], 0, pos, d, cfg, k_chan=chan)

        def plain(d=dcfg):
            return call(fs.flash_serial_decode_ref, q, ops, 0, pos, d, cfg)

        d32 = dataclasses.replace(dcfg, dot_bf16=False)
        err = max(agree(f"[5] K2 ctx {ctx}", kern(), plain(), True),
                  agree(f"[5] K2 ctx {ctx}", kern(d32), plain(d32), False))
        report["max_abs_err_main"] = max(report.get("max_abs_err_main", 0.0),
                                         err)
        ms = device_ms(kern)
        plain_ms = device_ms(plain, n=3, reps=3, warmup=1)
        ms2 = device_ms(kern)
        call_ms = median_ms(kern)
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
        row = dict(ctx=ctx, ms=min(ms, ms2), ms_runs=[ms, ms2],
                   call_ms=call_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                   bytes=nbytes, max_abs_err=err,
                   sdpa_bf16_kv_ms_context_only=sdpa_ms)
        log(f"[5] K2 ctx {ctx}: kernel {row['ms']:.4f} ms device (runs "
            f"{ms:.4f}, {ms2:.4f}; {call_ms:.4f} ms per call with the "
            f"wrapper's host time), plain {plain_ms:.3f} ms, bound "
            f"{bound_ms:.4f} ms "
            f"({nbytes / 1e6:.1f} MB at 3.35 TB/s), |err| {err:.2e}; "
            f"context only: SDPA over bf16 K/V {sdpa_ms:.4f} ms")
        rows.append(row)
        del ops
        torch.cuda.empty_cache()
    report["times"] = rows


PHASES = {1: phase_device_and_build, 2: phase_kernel_vs_plain,
          3: phase_main_path, 4: phase_card_vs_cpu, 5: phase_times}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="1,2,3,4,5",
                    help="comma-separated subset, for debugging")
    args = ap.parse_args(argv)
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

    if 5 in phases and 3 in phases:
        t = report["times"][-1]
        log(json.dumps({"kernels": [{
            "name": "flash_serial_decode",
            "route": "cuda",
            "source": "kvquant_tpu_torch/csrc/flash_serial.cu",
            "replaces": "kvquant_tpu/ops/pallas/flash_serial.py:62",
            "launches": report["launches"],
            "max_abs_err": report["max_abs_err_main"],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": "bytes",
            "library_ms": None,
            "shape": f"B=1 Hkv=32 G=1 D=128 hg=16 int4 n_kc=16 cap=0, "
                     f"{t['ctx']} tokens",
        }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
