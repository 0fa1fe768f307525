"""The inputs a run makes from its seed (the weights, the K thresholds)
and the program under test built over them.

The weights are drawn on the device, one ``normal_`` call per stacked
tensor, in bf16, the type they are served in: normal / sqrt(fan_in),
embedding 0.02, norms 1, the port's ``init_params`` distributions. The
same tensors go to the program and to the reference.
"""

from __future__ import annotations

import numpy as np
import torch


def weight_shapes(m: dict) -> dict:
    """{name: (shape, std)} of every weight, by the reference's names."""
    L, D, H, Hkv, Dh, F, V = (m["L"], m["D"], m["H"], m["Hkv"], m["Dh"],
                              m["F"], m["V"])
    inv = lambda n: n ** -0.5  # noqa: E731
    if m["family"] == "dbrx":
        E = m["E"]
        layers = dict(w_qkv=((L, D, (H + 2 * Hkv) * Dh), inv(D)),
                      wo=((L, H * Dh, D), inv(H * Dh)),
                      w_router=((L, D, E), inv(D)),
                      w_gate=((L, E, D, F), inv(D)),
                      w_up=((L, E, D, F), inv(D)),
                      w_down=((L, E, F, D), inv(F)))
    else:
        layers = dict(wq=((L, D, H * Dh), inv(D)),
                      wk=((L, D, Hkv * Dh), inv(D)),
                      wv=((L, D, Hkv * Dh), inv(D)),
                      wo=((L, H * Dh, D), inv(H * Dh)),
                      w_gate=((L, D, F), inv(D)), w_up=((L, D, F), inv(D)),
                      w_down=((L, F, D), inv(F)))
    return dict(layers, embed=((V, D), 0.02), head=((D, V), inv(D)))


def make_weights(m: dict, seed: int, device, out: dict | None = None,
                 dtype=torch.bfloat16) -> dict:
    """The bf16 weights of ``m`` drawn from ``seed`` (into ``out``'s
    tensors when given, so a second seed reuses the memory) and the fp32
    norms (ones)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    w = {} if out is None else out
    for name, (shape, std) in weight_shapes(m).items():
        if name not in w:
            w[name] = torch.empty(shape, dtype=dtype, device=device)
        w[name].normal_(0.0, std, generator=gen)
    for name, shape in (("ln_attn", (m["L"], m["D"])),
                        ("ln_mlp", (m["L"], m["D"])), ("final_norm", (m["D"],))):
        w[name] = torch.ones(shape, dtype=torch.float32, device=device)
    return w


def k_thresholds(m: dict, scheme: dict, seed: int):
    """Per-layer, per-channel K thresholds (upper, lower), each (L, C)
    fp32, drawn as the scheme's ``k_range`` says."""
    r = scheme["k_range"]
    rng = np.random.default_rng([seed, 1])
    C = m["Hkv"] * m["Dh"]
    up = (np.abs(rng.normal(size=(m["L"], C))) * r["abs_normal_scale"]
          + r["abs_normal_offset"]).astype(np.float32)
    return up, (-up * r["lower_ratio"]).astype(np.float32)


def capacity_tokens(traffic) -> int:
    """The server's context capacity: the longest prompt and answer, and
    the position the last token is written at."""
    return traffic.max_prompt + traffic.max_answer + 1


def build_server(config_path: str, m: dict, scheme: dict, w: dict, k_up,
                 k_lo, n_slots: int, max_len: int, admit_chunk: int, device):
    """The program under test: ``serve.Server`` over the port's model
    container holding ``w``, its deploy config from ``scheme`` and its
    quantizers from the drawn thresholds and the scheme's codebooks."""
    from kvquant_tpu_torch.cache import DeployConfig, deployed_from_quantizers
    from kvquant_tpu_torch.models.hf_loader import config_from_hf
    from kvquant_tpu_torch.models.llama import Llama
    from kvquant_tpu_torch.models.moe import MoE
    from kvquant_tpu_torch.quant.artifacts import (KQuantizer,
                                                   LayerQuantizers,
                                                   QuantizerSet, VQuantizer)
    from kvquant_tpu_torch.serve import Server

    cfg = config_from_hf(config_path)
    got = (cfg.d_model, cfg.n_layers, cfg.n_heads, cfg.n_kv_heads, cfg.d_head,
           cfg.d_ff, cfg.vocab_size)
    want = (m["D"], m["L"], m["H"], m["Hkv"], m["Dh"], m["F"], m["V"])
    if got != want:
        raise SystemExit(f"the port reads {config_path} as {got}, the "
                         f"benchmark as {want}")
    cls = MoE if m["family"] == "dbrx" else Llama
    layers = {k: w[k] for k in cls.LAYER_KEYS}
    params = cls(cfg, w["embed"], w["final_norm"], layers, w["head"])
    s = scheme
    dcfg = DeployConfig.create(
        bits=s["bits"], n_kv_heads=cfg.n_kv_heads, d_head=cfg.d_head,
        max_len=max_len, sink=s["sink"], kernel=s["kernel"],
        head_group=s["head_group"], codes=s["codes"],
        post_rope_k=s["post_rope_k"], k_outliers=s["k_outliers"],
        cap_per_side=s["cap_per_side"],
        sparsity_threshold=s["sparsity_threshold"], dot_bf16=s["dot_bf16"])
    k_lut = np.asarray(s["k_lut"], np.float32)
    v_lut = np.asarray(s["v_lut"], np.float32)
    qs = QuantizerSet(
        layers=[LayerQuantizers(k=KQuantizer(upper=k_up[i], lower=k_lo[i],
                                             lut=k_lut.copy()),
                                v=VQuantizer(lut=v_lut.copy()))
                for i in range(cfg.n_layers)],
        bits=s["bits"], sparsity_threshold=s["sparsity_threshold"],
        cap_outliers=True, first_few_fp16=s["sink"])
    dq = deployed_from_quantizers(qs, cfg.n_kv_heads, cfg.d_head,
                                  device=device)
    return Server(params, cfg, dcfg, dq, n_slots=n_slots, seed=0,
                  admit_mode="chunked", admit_chunk=admit_chunk,
                  device=device)
