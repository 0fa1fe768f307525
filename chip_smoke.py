"""Smoke test of the PyTorch/CUDA port (kvquant_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py            # every phase, one card
    python3 chip_smoke.py --phases 1,6 --verbose-build   # build + K1 check
    python3 chip_smoke.py --phases 1,10 --verbose-build  # build + K3/K4

Phases (each prints its own lines; any failure raises and exits non-zero).
K2 is csrc/flash_serial.cu (flash_serial_decode), K1 csrc/flash_decode.cu
(flash_attention / flash_decode):
  1. device and build: the card, torch / CUDA versions, one nvcc per
     kvquant_tpu_torch/csrc/*.cu source of this checkout, run in parallel;
  2. K2 against its plain PyTorch version on the card: int4 / int8 /
     int4x2 x channels / slots x sink 0 / 5, B=2 at unequal positions, and a
     sliding window, with fp32 dots and with bf16 dot operands;
  3. the speed-config main path at full LLaMA-2-7B width (32 layers, random
     bf16 weights from a seed): prefill of a 2048-token prompt then greedy
     generate of 64 tokens (int4, post-RoPE K, 16 static K channels, no
     slots, head_group 16, sink 5, kernel "flash_serial"); K2 must have run
     32 times per decode step; on the live cache K2 is held against the
     plain version at layers 0 and 31, with bf16 and with fp32 dots;
     decode tok/s, also at 32K context;
  4. card against CPU: a toy-sized random model gives the same 32 greedy
     tokens on the card and on the CPU through K2;
  5. K2 alone at one LLaMA-2-7B layer's shapes with a filled cache at 32K
     and 128K tokens: agreement with the plain version in both dot modes;
     kernel, plain version, bound (CUDA events around back-to-back calls
     queued behind a sleep kernel, median of 7 repeats after warm-up; and
     the per-call time with host overhead);
  6. K1 against its plain version: nuq 2/3/4 bits, int4, int8 x pre / post
     RoPE x slots / channels x sink 0 / 5 x (decode at B=2, unequal
     positions; a first prefill chunk; a later chunk), a sliding window and
     other widths, fp32 and bf16 dots;
  7. the reference-faithful main path at LLaMA-2-7B width (nuq3, pre-RoPE
     K, slots cap 2, head_group 4, sink 5, kernel "flash"): quantized
     chunked prefill of 2048 tokens (chunk 256) and 64 greedy tokens; K1
     must have run 32 x (chunks + 64) times; K1 against plain on the live
     cache; decode tok/s at 2K and at 32K, a profiler pass at 32K;
  8. card against CPU through K1: the committed toy checkpoint and 3-bit
     quantizers give the same 32 greedy tokens on both, fp16 and quantized
     prefill;
  9. K1 alone at one LLaMA-2-7B layer: decode at 32K and 128K, a 256-row
     prefill chunk at 2K and 32K; times as in phase 5, bound from bytes
     and bf16 tensor-core operations.
K3 (qk_fused) and K4 (pv_fused) are csrc/attention.cu, kernel="pallas":
 10. K3 and K4 against their plain versions: bits 2/3/4 x head group
     1/2/4 x cap 0/2 at R = G and R = G*261 rows, G 1/4, D 32/64/128,
     capacity 256 / 2304, B=2, fp32 and bf16 dots;
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
     a 261-row prefill chunk at 2K; times, plain, bound as in phase 9.
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
    tps32, _ = decode_profile(
        f"[3] {ctx} ctx", lambda i: engine.decode_step(
            params, cfg32, dcfg32, dq32, cache, tok, ctx + i), steps)
    report["decode_tps_32k"] = tps32
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


def k1_config(codes, bits, Hkv, D, G, Tc, sink, post, k_out, hg, window,
              dot_bf16, L=2):
    from kvquant_tpu_torch.cache import DeployConfig
    from kvquant_tpu_torch.models.config import ModelConfig

    dcfg = DeployConfig.create(
        bits=bits, n_kv_heads=Hkv, d_head=D, max_len=Tc + sink, sink=sink,
        kernel="flash", dot_bf16=dot_bf16, head_group=hg, codes=codes,
        post_rope_k=post, k_outliers=k_out, n_kc=3 if hg < 16 else 16,
        cap_per_side=0 if k_out == "channels" else 2)
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
            tag = (f"[6] {codes}{bits} {'post' if post else 'pre'} {k_out} "
                   f"hg{hg} sink{sink} D{d} G{g} Tq{tq} win{window}")
            err = float((got - want).abs().max())
            scale = float(want.abs().max())
            bound = BF16_TOL * scale if dot_bf16 else FP32_TOL * (1 + scale)
            if not (err <= bound and bool(torch.isfinite(got).all())):
                agree(tag, got, want, dot_bf16)  # logs and raises
            worst[dot_bf16] = max(worst[dot_bf16], err / bound)
    log(f"[6] K1 == plain on {len(cases)} cases x 2 dot modes in "
        f"{time.perf_counter() - t0:.1f} s; worst |err| / bound: fp32 dots "
        f"{worst[False]:.3f} (bound 1e-4*(1+max|plain|)), bf16 dots "
        f"{worst[True]:.3f} (bound 1e-2*max|plain|)")
    report["k1_grid_worst_ratio"] = worst


# a fixed non-affine 3-bit codebook, normalized to [-1, 1]
NUQ3_LUT = np.array([-1.0, -0.62, -0.33, -0.1, 0.09, 0.31, 0.6, 1.0],
                    np.float32)


def faithful_config(max_len, n_layers):
    """LLaMA-2-7B width and the reference-faithful scheme (the JAX
    package's DeployConfig defaults): nuq3 bit planes, pre-RoPE K, slot
    outliers with cap 2 per side per head group of 4, sink 5, K1."""
    from kvquant_tpu_torch.cache import DeployConfig
    from kvquant_tpu_torch.models.config import LLAMA2_7B
    from kvquant_tpu_torch.quant.artifacts import (
        KQuantizer, VQuantizer, LayerQuantizers, QuantizerSet)

    cfg = LLAMA2_7B
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
    kernels. ``step(i)`` runs the decode step at offset i."""
    from torch.profiler import ProfilerActivity, profile

    for i in range(2):  # warm-up
        step(i)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(steps):
        step(2 + i)
    torch.cuda.synchronize()
    tps = steps / (time.perf_counter() - t0)
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
    from kvquant_tpu_torch.cache import (KVCache, create_cache,
                                         deployed_from_quantizers)
    from kvquant_tpu_torch.models import init_params
    from kvquant_tpu_torch.ops.kernels import flash_decode as fd

    T0, N, chunk = 2048, 64, 256
    cfg, dcfg, qs = faithful_config(T0 + N + 5, 32)
    dev = torch.device("cuda")
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
    fd.flash_attention.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks, cache = engine.generate(params, cfg, dcfg, dq, prompt, gcfg,
                                  prefill_mode="quantized", device="cuda")
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    launches = fd.flash_attention.launches
    want = cfg.n_layers * (n_chunks + N)
    report["k1_launches"] = launches
    log(f"[7] quantized prefill {T0} tokens ({n_chunks} chunks of {chunk}) "
        f"{prefill_s:.3f} s; generate (prefill + {N} decode steps) "
        f"{gen_s:.3f} s; K1 launches {launches} (expected {want})")
    if launches != want:
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
    ops = k1_operands(dcfg32, cfg.n_layers, 1, dcfg32.cache_tokens,
                      torch.Generator(device="cuda").manual_seed(3), dev)
    cache = KVCache(length=torch.full((1,), ctx, dtype=torch.int32,
                                      device="cuda"),
                    **{k: ops[k] for k in ("k_planes", "v_planes", "kv_out",
                                           "v_scale", "v_offset", "k_sink",
                                           "v_sink")})
    tok = torch.zeros((1,), dtype=torch.int32, device="cuda")
    tps32, idle = decode_profile(
        f"[7] {ctx} ctx", lambda i: engine.decode_step(
            params, cfg32, dcfg32, dq32, cache, tok, ctx + i), steps)
    report["k1_decode_tps_32k"] = tps32
    report["k1_idle_32k"] = idle
    del cache, ops, params
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
            f"SDPA over bf16 K/V {sdpa_ms:.4f} ms")
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
    from kvquant_tpu_torch.cache import (KVCache, create_cache,
                                         deployed_from_quantizers)
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
    ops = k1_operands(dcfg32, cfg.n_layers, 1, dcfg32.cache_tokens,
                      torch.Generator(device="cuda").manual_seed(3),
                      torch.device("cuda"))
    cache = KVCache(length=torch.full((1,), ctx, dtype=torch.int32,
                                      device="cuda"),
                    **{k: ops[k] for k in ("k_planes", "v_planes", "kv_out",
                                           "v_scale", "v_offset", "k_sink",
                                           "v_sink")})
    tps32, idle32 = decode_profile(
        f"[11] pallas {ctx} ctx", lambda i: engine.decode_step(
            params, cfg, dcfg32, dq32, cache, tok, ctx + i), 16)
    report.update(k34_prefill_s_2k=prefill_s, k34_decode_tps_2k=tps2,
                  k34_idle_2k=idle2, k34_decode_tps_32k=tps32,
                  k34_idle_32k=idle32)
    del cache, ops
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
            row = dict(name=name, kind=kind, ctx=ctx, Tc=Tc, R=r,
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
                f"|err| {err:.2e}")
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


PHASES = {1: phase_device_and_build, 2: phase_kernel_vs_plain,
          3: phase_main_path, 4: phase_card_vs_cpu, 5: phase_times,
          6: phase_k1_vs_plain, 7: phase_k1_main_path,
          8: phase_k1_card_vs_cpu, 9: phase_k1_times,
          10: phase_k34_vs_plain, 11: phase_pallas_main_path,
          12: phase_pallas_card_vs_cpu, 13: phase_k34_times}


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
            "launches": report["launches"],
            "max_abs_err": report["max_abs_err_main"],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": "bytes",
            "library_ms": None,
            "shape": f"B=1 Hkv=32 G=1 D=128 hg=16 int4 n_kc=16 cap=0, "
                     f"{t['ctx']} tokens",
        })
    if 9 in phases and 7 in phases:
        t = report["k1_times"][0]  # decode at 32K
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
        })
    if 13 in phases and 11 in phases:
        for name, body_line, launches in (
                ("qk_fused", 156, report["k3_launches"]),
                ("pv_fused", 249, report["k4_launches"])):
            t = next(x for x in report["k34_times"]
                     if x["name"] == name and x["ctx"] == 32768)
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
            })
    if kernels:
        log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
