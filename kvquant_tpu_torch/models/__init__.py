from .config import ModelConfig, LLAMA2_7B, MISTRAL_7B, TINY_LLAMA, TINY_GQA
from .llama import (
    Llama,
    init_params,
    params_from_numpy,
    forward,
    make_kv_probes,
    rope_cos_sin,
    apply_rope,
    rotate_half,
    rms_norm,
    norm,
    SimQuantArrays,
    SimQuantConfig,
    SimQuantParams,
    simquant_from_quantizers,
    simquant_k,
    simquant_v,
    v_topk_range_and_mask,
)


def get_forward(cfg):
    """The forward of ``cfg``'s model family (kvquant_tpu/models/__init__.py
    get_forward): the Llama forward for a ModelConfig. The MoE family is not
    ported yet (ROADMAP queue 1 item 11)."""
    if type(cfg) is not ModelConfig:
        raise NotImplementedError(
            f"no forward for {type(cfg).__name__}: only the Llama family is "
            f"ported (the MoE family is ROADMAP queue 1 item 11)")
    return forward
