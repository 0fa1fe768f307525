from .config import ModelConfig, LLAMA2_7B, MISTRAL_7B, TINY_LLAMA, TINY_GQA
from .llama import (
    Llama,
    init_params,
    params_from_numpy,
    params_to_numpy,
    trainable,
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
from .hf_loader import load_hf_checkpoint, config_from_hf


def get_forward(cfg):
    """The forward of ``cfg``'s model family (kvquant_tpu/models/__init__.py
    get_forward): ``moe.forward`` for a ``MoEConfig``, else the Llama
    forward; both return (logits, aux) under the same keywords."""
    from . import moe

    if isinstance(cfg, moe.MoEConfig):
        return moe.forward
    return forward
