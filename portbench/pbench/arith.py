"""The yardstick's arithmetic: the card's published peaks, the stored bytes
of the quantized cache, the operations and bytes a kernel call needs, and
the model FLOPs of a token. Counts are worked out from shapes and
positions: each input byte read once, each output byte written once, and
where the work depends on the data, what these inputs need.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet: dense bf16 tensor-core rate, HBM3 bandwidth
PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12


def model_dims(cfg: dict) -> dict:
    """Widths of a published config.json (Mistral / LLaMA schema or
    DBRX's) under one set of names."""
    if cfg.get("model_type") == "dbrx":
        a, f = cfg["attn_config"], cfg["ffn_config"]
        D, H = cfg["d_model"], cfg["n_heads"]
        return dict(family="dbrx", D=D, H=H, Hkv=a["kv_n_heads"], Dh=D // H,
                    F=f["ffn_hidden_size"], L=cfg["n_layers"],
                    V=cfg["vocab_size"], E=f["moe_num_experts"],
                    K=f["moe_top_k"], theta=float(a["rope_theta"]),
                    eps=1e-5, window=None)
    D, H = cfg["hidden_size"], cfg["num_attention_heads"]
    return dict(family="llama", D=D, H=H,
                Hkv=cfg.get("num_key_value_heads", H),
                Dh=cfg.get("head_dim") or D // H, F=cfg["intermediate_size"],
                L=cfg["num_hidden_layers"], V=cfg["vocab_size"], E=0, K=0,
                theta=float(cfg.get("rope_theta", 10000.0)),
                eps=float(cfg.get("rms_norm_eps", 1e-5)),
                window=cfg.get("sliding_window"))


def n_groups(m: dict, scheme: dict) -> int:
    return m["Hkv"] // scheme["head_group"]


def n_slots(scheme: dict) -> int:
    return max(4 * scheme["cap_per_side"], 1)


def stored_bytes_per_token(m: dict, scheme: dict) -> int:
    """One packed token of one layer under bit planes: K and V codes of
    every kv head, its head groups' outlier slot words (fp32), V scale and
    offset (fp32)."""
    return (2 * m["Hkv"] * m["Dh"] * scheme["bits"] // 8
            + n_groups(m, scheme) * n_slots(scheme) * 4 + 8)


def sink_bytes(m: dict, scheme: dict) -> int:
    """The exact sink rows of one sequence and layer, K and V, fp32."""
    return 2 * m["Hkv"] * scheme["sink"] * m["Dh"] * 4


def attn_flops(m: dict, visible: int) -> int:
    """QK and PV of one query row over ``visible`` keys, every head."""
    return 4 * m["Dh"] * m["H"] * visible


def k1_decode_bound(m: dict, scheme: dict, positions) -> tuple[float, float]:
    """(bytes, FLOPs) of one decode step's K1 calls, every layer, for the
    slots at ``positions`` (the position each decodes, which it writes
    first): each slot's live packed tokens (positions sink..pos), its sinks,
    its query and its output (fp32)."""
    S = scheme["sink"]
    per_tok = stored_bytes_per_token(m, scheme)
    qo = 2 * m["H"] * m["Dh"] * 4
    nbytes = flops = 0
    for p in positions:
        p = int(p)
        nbytes += max(p - S + 1, 0) * per_tok + sink_bytes(m, scheme) + qo
        flops += attn_flops(m, p + 1)
    return m["L"] * nbytes, m["L"] * flops


def k1_chunk_bound(m: dict, scheme: dict, first: int, n_rows: int
                   ) -> tuple[float, float]:
    """(bytes, FLOPs) of one prompt chunk's K1 calls, every layer: rows at
    positions first .. first + n_rows - 1, each over the keys up to its own
    position (the sinks included); bytes: the chunk's visible packed
    tokens, the sinks, queries and outputs (fp32)."""
    S = scheme["sink"]
    last = first + n_rows - 1
    visible = n_rows * (first + 1) + n_rows * (n_rows - 1) // 2
    nbytes = (max(last - S + 1, 0) * stored_bytes_per_token(m, scheme)
              + sink_bytes(m, scheme) + 2 * n_rows * m["H"] * m["Dh"] * 4)
    return m["L"] * nbytes, m["L"] * attn_flops(m, 1) * visible


def roofline_seconds(nbytes: float, flops: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_BF16_FLOPS)


def expert_bytes_per_step(m: dict) -> int:
    """Every expert's gate, up and down weights of every layer, bf16: what
    a decode step reads when each expert has a live slot."""
    return m["L"] * m["E"] * 3 * m["D"] * m["F"] * 2


def matmul_params_per_token(m: dict) -> int:
    """Weights one token multiplies through: attention projections, the
    FFN (DBRX: router and top_k experts) of every layer, and the LM head."""
    D, H, Hkv, Dh, F = m["D"], m["H"], m["Hkv"], m["Dh"], m["F"]
    attn = D * (H + 2 * Hkv) * Dh + H * Dh * D
    if m["family"] == "dbrx":
        ffn = D * m["E"] + m["K"] * 3 * D * F
    else:
        ffn = 3 * D * F
    return m["L"] * (attn + ffn) + D * m["V"]


def token_flops(m: dict, visible: int) -> int:
    """Model FLOPs of one token that sees ``visible`` keys."""
    return 2 * matmul_params_per_token(m) + m["L"] * attn_flops(m, visible)


def prompt_flops(m: dict, lo: int, hi: int) -> int:
    """Model FLOPs of prompt rows at positions lo .. hi - 1."""
    n = hi - lo
    visible = n * (lo + 1) + n * (n - 1) // 2
    return n * 2 * matmul_params_per_token(m) + m["L"] * attn_flops(
        m, 1) * visible

