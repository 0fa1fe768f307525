from .config import ModelConfig, LLAMA2_7B, TINY_LLAMA, TINY_GQA
from .llama import (
    Llama,
    init_params,
    params_from_numpy,
    forward,
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
