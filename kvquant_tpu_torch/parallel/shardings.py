"""Sharding rules and rank-local shards: tensor-parallel weights and the
head-sharded quantized KV cache (port of kvquant_tpu/parallel/shardings.py).

The rule tables name, for every field, the mesh axis each tensor axis is
split over, as the JAX package's PartitionSpecs do ((None, None, "tp"):
the last axis split over tp; () replicated):

  wq/wk/wv  (L, D, H*Dh)   (None, None, "tp")   heads split
  wo        (L, H*Dh, D)   (None, "tp", None)   rows split, summed after
  w_gate/up (L, D, F)      (None, None, "tp")
  w_down    (L, F, D)      (None, "tp", None)
  MoE experts (L, E, ...)  (None, "tp", ...)    experts split over tp
  embed / norms / lm_head / router              replicated

Where the JAX package places a sharded array and GSPMD reshards it, a rank
here holds its shard and computes on it, so three rules differ:

  - MoE ``w_qkv`` (L, D, (H + 2 Hkv) Dh): JAX splits the fused columns
    contiguously and GSPMD reshards for ``split_qkv``; a rank here takes
    its q heads, its k heads and its v heads out of the fused matrix, so
    that ``models.moe.split_qkv`` works on the rank-local config;
  - ``DeployedQuant.k_lower`` / ``k_upper`` / ``k_ressc`` (L, C): JAX
    replicates them (``flash_attention_sharded`` splits ``k_ressc`` by
    heads); a rank holds the channels of its heads (C is head-major, so a
    contiguous split is a split by heads). Static K channels are chosen
    per head group, so each rank's selection is its part of the global one;
  - the rank-local configs (``shard_config``): heads / tp and kv heads / tp,
    ``d_ff`` / tp for the LLaMA family, experts / tp for the MoE family
    (whose ``d_ff`` is not split), carrying the tp group for the model's
    and the engine's collectives (``parallel.collectives``).

The head-group rule: (n_kv_heads / tp) % head_group == 0, so that outlier
groups and their slot words never straddle ranks (ValueError otherwise).
"""

from __future__ import annotations

import dataclasses
from dataclasses import fields

import torch

from ..cache import KVCache, DeployConfig, DeployedQuant
from ..models.config import ModelConfig
from .mesh import Mesh

REP = ()


def param_shardings(mesh: Mesh, params) -> dict:
    """Spec table matching the parameters of ``models.llama`` and
    ``models.moe`` (a module, or a dict with a "layers" dict)."""
    layers = params["layers"] if isinstance(params, dict) else params.layers
    rules = dict(
        wq=(None, None, "tp"), wk=(None, None, "tp"), wv=(None, None, "tp"),
        wo=(None, "tp", None),
        w_gate=(None, None, "tp"), w_up=(None, None, "tp"),
        w_down=(None, "tp", None),
        ln_attn=REP, ln_mlp=REP,
    )
    if "w_qkv" in layers:  # MoE family: experts split over tp
        rules = dict(
            w_qkv=(None, None, "tp"), wo=(None, "tp", None), w_router=REP,
            w_gate=(None, "tp", None, None), w_up=(None, "tp", None, None),
            w_down=(None, "tp", None, None), ln_attn=REP, ln_mlp=REP,
        )
    has_head = (params.get("lm_head") is not None if isinstance(params, dict)
                else params.lm_head is not None)
    out = dict(embed=REP, final_norm=REP, layers={k: rules[k] for k in layers})
    if has_head:
        out["lm_head"] = REP
    return out


def cache_shardings(mesh: Mesh) -> KVCache:
    """KVCache spec table: (L, B, Hkv or groups, ...) arrays split B over
    dp and heads over tp; per-token V ranges and lengths split only B."""
    return KVCache(
        k_planes=(None, "dp", "tp"), v_planes=(None, "dp", "tp"),
        kv_out=(None, "dp", "tp"), v_scale=(None, "dp"),
        v_offset=(None, "dp"), k_sink=(None, "dp", "tp"),
        v_sink=(None, "dp", "tp"), length=("dp",),
    )


def quant_shardings(mesh: Mesh) -> DeployedQuant:
    """DeployedQuant spec table: per-channel arrays follow their heads over
    tp; the codebooks replicate."""
    return DeployedQuant(
        k_range=(None, "tp", None), k_offset=(None, "tp", None),
        k_lower=(None, "tp"), k_upper=(None, "tp"),
        k_lut_enc=REP, k_lut_dec=REP, v_lut_enc=REP, v_lut_dec=REP,
        k_ressc=(None, "tp"),
    )


def data_sharding(mesh: Mesh) -> tuple:
    """Token batches split over dp."""
    return ("dp",)


# ---------------------------------------------------------------------------
# rank-local shards
# ---------------------------------------------------------------------------


def shard_tensor(mesh: Mesh, x: torch.Tensor, spec) -> torch.Tensor:
    """This rank's block of ``x`` under ``spec`` (a new contiguous tensor
    on ``x``'s device); an axis its mesh axis does not divide raises."""
    for ax, name in enumerate(spec):
        if name is None:
            continue
        n = getattr(mesh, name)
        if n == 1:
            continue
        i = mesh.tp_rank if name == "tp" else mesh.dp_rank
        if x.shape[ax] % n:
            raise ValueError(
                f"axis {ax} of a tensor of shape {tuple(x.shape)} is split "
                f"over {name}={n}, which does not divide {x.shape[ax]}")
        w = x.shape[ax] // n
        x = x.narrow(ax, i * w, w)
    return x.clone(memory_format=torch.contiguous_format)


def shard_data(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """This rank's part of a (B, ...) batch."""
    return shard_tensor(mesh, x, data_sharding(mesh))


def gather_data(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """The whole (B, ...) batch of a floating tensor (logits) from every
    dp rank's part, the same on every rank."""
    from .collectives import gather_max

    if mesh.dp_group is None:
        return x
    return torch.cat(list(gather_max(x, mesh.dp_group)), dim=0)


def _qkv_columns(cfg, tp: int, r: int) -> torch.Tensor:
    """Columns of the fused (H + 2 Hkv) * Dh projection that hold rank
    r's q heads, k heads and v heads, in that order."""
    H, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    hq, hk = H // tp, Hkv // tp
    q = torch.arange(r * hq * Dh, (r + 1) * hq * Dh)
    k = H * Dh + torch.arange(r * hk * Dh, (r + 1) * hk * Dh)
    return torch.cat([q, k, k + Hkv * Dh])


def shard_params(mesh: Mesh, params):
    """This rank's shards of the parameter module (``models.llama.Llama``
    or ``models.moe.MoE``) as a module of the same class, whose ``cfg`` is
    the rank-local config (``shard_config``)."""
    cfg = params.cfg
    lcfg = shard_config(mesh, cfg)
    rules = param_shardings(mesh, params)["layers"]
    layers = {}
    for k, w in params.layers.items():
        if k == "w_qkv" and mesh.tp > 1:
            cols = _qkv_columns(cfg, mesh.tp, mesh.tp_rank).to(w.device)
            layers[k] = w.index_select(-1, cols).contiguous()
        else:
            layers[k] = shard_tensor(mesh, w.data, rules[k])
    head = None if params.lm_head is None else params.lm_head.data
    return type(params)(lcfg, params.embed.data, params.final_norm.data,
                        layers, head)


def shard_cache(mesh: Mesh, cache: KVCache) -> KVCache:
    """This rank's shards of a full cache."""
    spec = cache_shardings(mesh)
    return KVCache(**{f.name: shard_tensor(mesh, getattr(cache, f.name),
                                           getattr(spec, f.name))
                      for f in fields(cache)})


def shard_quant(mesh: Mesh, dq: DeployedQuant) -> DeployedQuant:
    """This rank's shards of the deployed quantizer arrays."""
    spec = quant_shardings(mesh)
    return DeployedQuant(**{f.name: shard_tensor(mesh, getattr(dq, f.name),
                                                 getattr(spec, f.name))
                            for f in fields(dq)})


_LOCAL_CLASSES: dict = {}


def _local_class(base: type) -> type:
    """``base`` with the fields of a rank-local config: the tp group, this
    rank's index in it and its size (neither compared nor printed)."""
    cls = _LOCAL_CLASSES.get(base)
    if cls is None:
        cls = dataclasses.make_dataclass(
            f"Local{base.__name__}",
            [("tp_group", object, dataclasses.field(
                default=None, compare=False, repr=False)),
             ("tp_rank", int, 0), ("tp_size", int, 1)],
            bases=(base,), frozen=True, namespace={"__module__": __name__})
        _LOCAL_CLASSES[base] = cls
    return cls


def check_head_groups(n_kv_heads: int, head_group: int, tp: int):
    """The head-group rule of the sharded cache."""
    if n_kv_heads % tp or (n_kv_heads // tp) % head_group:
        raise ValueError(
            f"tp {tp} with {n_kv_heads} kv heads in head groups of "
            f"{head_group}: the rule (n_kv_heads / tp) % head_group == 0 "
            f"fails, so outlier groups would straddle ranks")


def shard_config(mesh: Mesh, cfg):
    """The rank-local config of a ``DeployConfig`` (kv heads / tp), a
    ``ModelConfig`` (heads, kv heads and d_ff / tp) or an ``MoEConfig``
    (heads, kv heads and experts / tp). The model configs gain the tp
    group; with tp 1 ``cfg`` itself is returned."""
    tp = mesh.tp
    if tp == 1:
        return cfg
    if isinstance(cfg, DeployConfig):
        check_head_groups(cfg.n_kv_heads, cfg.head_group, tp)
        return dataclasses.replace(cfg, n_kv_heads=cfg.n_kv_heads // tp)
    if not isinstance(cfg, ModelConfig):
        raise TypeError(f"no rank-local rule for {type(cfg).__name__}")
    if getattr(cfg, "tp_size", 1) != 1:
        raise ValueError("config is rank-local already")
    split = dict(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads)
    if hasattr(cfg, "n_experts"):
        split["n_experts"] = cfg.n_experts
    else:
        split["d_ff"] = cfg.d_ff
    for name, n in split.items():
        if n % tp:
            raise ValueError(f"tp {tp} does not divide {name}={n}")
    kw = {f.name: getattr(cfg, f.name) for f in fields(cfg)}
    kw.update({k: n // tp for k, n in split.items()})
    return _local_class(type(cfg))(**kw, tp_group=mesh.tp_group,
                                   tp_rank=mesh.tp_rank, tp_size=tp)


# ---------------------------------------------------------------------------
# head-local attention
# ---------------------------------------------------------------------------


def flash_attention_sharded(mesh: Mesh, q_rot, k_planes, v_planes, kv_out,
                            k_range, k_offset, v_scale, v_offset,
                            k_sink, v_sink, k_lut, v_lut, li, pos,
                            dcfg: DeployConfig, mcfg, Tq: int = 1,
                            block_tokens: int = 1024, k_ressc=None):
    """K1 (``ops.kernels.flash_decode.flash_attention``), or K2
    (``flash_serial_decode``) under ``dcfg.kernel == "flash_serial"`` at
    Tq = 1, on this rank's shards: q_rot (B/dp, Hkv/tp, Q, D), the cache
    arrays and quantizer arrays as ``shard_cache`` / ``shard_quant`` give
    them, ``k_ressc`` (L, C/tp). ``dcfg`` / ``mcfg`` are the global
    configs. Attention is head-local: no collective runs. Returns this
    rank's (B/dp, Hkv/tp, Q, D) block of the output."""
    from ..ops.kernels.flash_decode import flash_attention
    from ..ops.kernels.flash_serial import flash_serial_decode

    check_head_groups(dcfg.n_kv_heads, dcfg.head_group, mesh.tp)
    ldcfg = dataclasses.replace(dcfg, n_kv_heads=dcfg.n_kv_heads // mesh.tp)
    if k_ressc is None:
        k_ressc = torch.zeros((k_range.shape[0], ldcfg.kv_hidden),
                              dtype=torch.float32, device=k_range.device)
    args = (q_rot, k_planes, v_planes, kv_out, k_range, k_offset, v_scale,
            v_offset, k_sink, v_sink, k_lut, v_lut, li, pos, ldcfg, mcfg)
    if dcfg.kernel == "flash_serial" and Tq == 1:
        return flash_serial_decode(*args, block_tokens=block_tokens,
                                   k_ressc=k_ressc)
    return flash_attention(*args, Tq=Tq, block_tokens=block_tokens,
                           k_ressc=k_ressc)
