"""Quantized KV cache (port of kvquant_tpu/cache.py:47-467).

Per layer (all arrays carry leading (L, B)):

  k_planes / v_planes : code containers, by DeployConfig.codes
        "int4"   (L,B,Hkv,Tc,D/2)   uint8, two 4-bit two's-complement codes
                                    per byte along D (low nibble = even d)
        "int4x2" (L,B,Hkv/2,Tc,D/2) uint8, the same nibbles holding the
                                    head-paired value c_even + 4*c_odd - 8
        "int8"   (L,B,Hkv,Tc,D)     int8
        "nuq"    (L,B,Hkv,bits,Tc/32,D) int32 bit planes (allocated here;
                                    their packing arrives with the general
                                    flash kernel)
  kv_out              : (L,B,n_groups,J,Tc) fp32  K rows [0, slots_per_kind)
                        then V rows: encoded slot words or dense K channel
                        residuals (see ops/packing.py encode_outlier_words)
  v_scale / v_offset  : (L,B,Tc) fp32  per-token V range
  k_sink / v_sink     : (L,B,Hkv,S,D) fp32  exact attention-sink prefix
                        (K post-RoPE, V raw)
  length              : (B,) int32  tokens present (incl. sink)

torch has no int4 dtype, so the JAX package's int4 arrays become nibble
pairs in uint8 at the same 4-bit density (``cache_bytes`` reports the same
numbers). The packed caches hold positions S..S+Tc-1.

Unlike the JAX cache (an immutable pytree), these tensors are updated in
place by the append and pack functions of ops/deployed.py.
"""

from __future__ import annotations

from dataclasses import dataclass, fields

import numpy as np
import torch

from .device import resolve_device
from .quant.outliers import outlier_budget_per_side
from .utils.topk import top_k


@dataclass(frozen=True)
class DeployConfig:
    """Static deployment scheme parameters (field meanings as in
    kvquant_tpu/cache.py DeployConfig)."""

    bits: int
    n_kv_heads: int
    d_head: int
    max_len: int  # total context capacity incl. sink tokens
    cap_per_side: int  # outlier slots per side per token PER HEAD GROUP
    head_group: int = 1  # kv heads sharing one outlier slot tile
    sink: int = 5  # first_few_fp16
    sparsity_threshold: float = 0.99
    include_sparse: bool = True
    kernel: str = "xla"  # "xla" (eager) / "pallas" / "flash" / "flash_serial"
    v_range_exclude: int = 21  # global extremes/side excluded from V range
    dot_bf16: bool = True  # bf16 dot operands, fp32 accumulation
    codes: str = "nuq"  # "nuq" | "int4" | "int8" | "int4x2"
    k_outliers: str = "slots"  # "slots" | "channels"
    n_kc: int = 4  # static K channels per head group ("channels" mode)
    post_rope_k: bool = False  # store keys post-rotary
    page_tokens: int = 1024  # paged-pool page size (paged.py): tokens per
    #   page, the token block the paged kernel addresses through its table

    def __post_init__(self):
        assert self.codes in ("nuq", "int4", "int8", "int4x2"), self.codes
        assert self.k_outliers in ("slots", "channels"), self.k_outliers
        if self.codes == "int4":
            assert self.bits <= 4, "int4 container holds <= 4-bit codes"
        if self.codes == "int8":
            assert self.bits <= 8
        if self.codes == "int4x2":
            assert self.bits == 2, "int4x2 packs exactly two 2-bit codes"
            assert self.n_kv_heads % 2 == 0, "int4x2 pairs adjacent kv heads"
        if self.codes in ("int4", "int4x2"):
            assert self.d_head % 2 == 0, "nibble pairs need an even d_head"

    @property
    def code_dtype(self) -> torch.dtype:
        """Container dtype: int8, or uint8 nibble pairs for int4/int4x2."""
        return {
            "int4": torch.uint8, "int8": torch.int8, "int4x2": torch.uint8,
        }[self.codes]

    @property
    def code_cols(self) -> int:
        """Last-axis width of a container row (D/2 for nibble pairs)."""
        return self.d_head // 2 if self.codes in ("int4", "int4x2") \
            else self.d_head

    @property
    def code_heads(self) -> int:
        """Head axis of an integer container: n_kv_heads, or half of it for
        int4x2, whose container head j holds kv heads 2j and 2j + 1."""
        return self.n_kv_heads // 2 if self.codes == "int4x2" \
            else self.n_kv_heads

    @property
    def code_bias(self) -> int:
        """Offset between the signed container code and the unsigned
        codebook index (0 for int4x2, whose pairing absorbs the bias)."""
        if self.codes == "int4x2":
            return 0
        return 1 << (self.bits - 1)

    @property
    def kv_hidden(self) -> int:
        return self.n_kv_heads * self.d_head

    @property
    def cache_tokens(self) -> int:
        """Packed-cache capacity: a multiple of 256 (2048 above 4096)."""
        t = self.max_len - self.sink
        unit = 2048 if t > 4096 else 256
        return ((t + unit - 1) // unit) * unit

    @property
    def n_groups(self) -> int:
        assert self.n_kv_heads % self.head_group == 0, (
            self.n_kv_heads, self.head_group
        )
        return self.n_kv_heads // self.head_group

    @property
    def n_slots(self) -> int:
        """Outlier rows per (token, head group): K rows first, then V rows
        (at least 1 so the array stays well-formed)."""
        if self.k_outliers == "channels":
            raw = self.n_kc + 2 * self.cap_per_side
        else:
            raw = 4 * self.cap_per_side
        return max(raw, 1)

    @property
    def slots_per_kind(self) -> int:
        """Row where the V slots start (== the K row count)."""
        if self.k_outliers == "channels":
            return self.n_kc
        return self.n_slots // 2

    @classmethod
    def create(cls, bits, n_kv_heads, d_head, max_len, sink=5,
               sparsity_threshold=0.99, include_sparse=True, kernel="xla",
               cap_per_side=None, dot_bf16=True, head_group=1, codes="nuq",
               post_rope_k=False, k_outliers="slots", n_kc=4):
        if head_group in (None, 0):  # auto: largest of {1,2,4} that divides
            head_group = 4
        while n_kv_heads % head_group:
            head_group //= 2
        # the encoded slot word packs (head-in-group, dim) into 9 bits
        cap_eff = 2 if cap_per_side is None else cap_per_side
        if cap_eff > 0:
            assert head_group * d_head <= 512, "9-bit (head, dim) index field"
        return cls(
            bits=bits, n_kv_heads=n_kv_heads, d_head=d_head, max_len=max_len,
            cap_per_side=cap_eff, head_group=head_group,
            sink=sink, sparsity_threshold=sparsity_threshold,
            include_sparse=include_sparse, kernel=kernel,
            v_range_exclude=outlier_budget_per_side(
                n_kv_heads * d_head, sparsity_threshold
            ),
            dot_bf16=dot_bf16, codes=codes, post_rope_k=post_rope_k,
            k_outliers=k_outliers, n_kc=n_kc,
        )


@dataclass
class KVCache:
    k_planes: torch.Tensor
    v_planes: torch.Tensor
    kv_out: torch.Tensor
    v_scale: torch.Tensor
    v_offset: torch.Tensor
    k_sink: torch.Tensor
    v_sink: torch.Tensor
    length: torch.Tensor

    def layer(self, i) -> "KVCache":
        """Layer ``i`` as VIEWS of the stacked arrays (writes go through)."""
        return KVCache(**{
            f.name: (getattr(self, f.name)[i]
                     if getattr(self, f.name).dim() > 1
                     else getattr(self, f.name))
            for f in fields(self)
        })

    def arrays(self) -> dict:
        """The stacked (L, ...) arrays by name (everything but length)."""
        return {f.name: getattr(self, f.name) for f in fields(self)
                if f.name != "length"}


def create_cache(dcfg: DeployConfig, n_layers: int, batch: int,
                 device="cuda") -> KVCache:
    dev = resolve_device(device)
    L, B = n_layers, batch
    H, D, S = dcfg.n_kv_heads, dcfg.d_head, dcfg.sink
    Tc = dcfg.cache_tokens
    ns = dcfg.n_slots

    def z(shape, dt):
        return torch.zeros(shape, dtype=dt, device=dev)

    assert D <= 128, "outlier words encode a 7-bit in-head dim"
    if dcfg.codes == "nuq":
        code_shape, code_dt = (L, B, H, dcfg.bits, Tc // 32, D), torch.int32
    else:
        code_shape = (L, B, dcfg.code_heads, Tc, dcfg.code_cols)
        code_dt = dcfg.code_dtype
    return KVCache(
        k_planes=z(code_shape, code_dt),
        v_planes=z(code_shape, code_dt),
        kv_out=z((L, B, dcfg.n_groups, ns, Tc), torch.float32),
        v_scale=z((L, B, Tc), torch.float32),
        v_offset=z((L, B, Tc), torch.float32),
        k_sink=z((L, B, H, S, D), torch.float32),
        v_sink=z((L, B, H, S, D), torch.float32),
        length=z((B,), torch.int32),
    )


def reset_cache(cache: KVCache) -> KVCache:
    """Zero every array in place, ``length`` included, keeping devices and
    dtypes (JAX's reset_cache returns a zeroed copy; the reference's
    QuantK.reset / QuantV.reset). Returns ``cache``."""
    for f in fields(cache):
        getattr(cache, f.name).zero_()
    return cache


def cache_bytes(dcfg: DeployConfig, n_layers: int, batch: int) -> dict:
    """Memory accounting for the quantized cache vs an fp16 baseline."""
    C = dcfg.kv_hidden
    Tc = dcfg.cache_tokens
    stored_bits = {
        "nuq": dcfg.bits, "int4": 4, "int8": 8, "int4x2": 2,
    }[dcfg.codes]
    packed = 2 * n_layers * batch * C * stored_bits * Tc // 8
    outliers = n_layers * batch * dcfg.n_groups * Tc * dcfg.n_slots * 4
    vlut = 2 * n_layers * batch * Tc * 4
    sink = 2 * n_layers * batch * C * dcfg.sink * 4
    fp16 = 2 * n_layers * batch * C * (Tc + dcfg.sink) * 2
    total = packed + outliers + vlut + sink
    return dict(
        packed=packed, outliers=outliers, v_range=vlut, sink=sink,
        total=total, fp16_baseline=fp16, ratio=fp16 / total,
    )


# ---------------------------------------------------------------------------
# deployed quantizer arrays (static per model, stacked over layers)
# ---------------------------------------------------------------------------


@dataclass
class DeployedQuant:
    """Per-layer quantizer state for the deployed datapath; k_lut_enc
    selects codes, k_lut_dec dequantizes (they differ under Q-Norm)."""

    k_range: torch.Tensor  # (L, Hkv, D) fp32 per-channel halfrange
    k_offset: torch.Tensor  # (L, Hkv, D) fp32 per-channel zeropoint
    k_lower: torch.Tensor  # (L, C) outlier thresholds
    k_upper: torch.Tensor  # (L, C)
    k_lut_enc: torch.Tensor  # (L, 2**bits) sorted normalized
    k_lut_dec: torch.Tensor  # (L, 2**bits)
    v_lut_enc: torch.Tensor  # (L, 2**bits)
    v_lut_dec: torch.Tensor  # (L, 2**bits)
    k_ressc: torch.Tensor  # (L, C) per-channel K residual energy

    def layer(self, i) -> "DeployedQuant":
        return DeployedQuant(**{f.name: getattr(self, f.name)[i]
                                for f in fields(self)})


def k_channel_index(k_ressc: torch.Tensor, dcfg: DeployConfig) -> torch.Tensor:
    """Static K outlier channels ("channels" mode): the top-n_kc
    residual-energy channels of each head group, as int64 indices into the
    group's head_group*d_head channels. k_ressc (..., C) ->
    (..., n_groups, n_kc), ordered as jax.lax.top_k orders them."""
    gw = dcfg.head_group * dcfg.d_head
    g = k_ressc.reshape(*k_ressc.shape[:-1], -1, gw)
    return top_k(g, dcfg.n_kc)[1]


def k_channel_onehot(k_ressc: torch.Tensor, dcfg: DeployConfig) -> torch.Tensor:
    """The same selection as one-hot rows: (..., n_groups, n_kc,
    head_group*d_head) fp32 with sel[..., g, n, c] == 1 iff group g's n-th
    selected channel is c."""
    gw = dcfg.head_group * dcfg.d_head
    idx = k_channel_index(k_ressc, dcfg)
    ar = torch.arange(gw, device=k_ressc.device)
    return (idx[..., None] == ar).to(torch.float32)


def affine_lut_coeffs(lut, tol: float = 1e-4):
    """For an affine (evenly spaced) codebook, return (a, b) per layer with
    ``lut[c] == a + b*c``; raise if any layer's codebook is not affine.
    lut: (L, K). Returns (a (L,), b (L,)) float32 numpy arrays."""
    if isinstance(lut, torch.Tensor):
        lut = lut.detach().cpu().numpy()
    lut = np.asarray(lut, np.float32)
    L, K = lut.shape
    a = lut[:, 0]
    b = (lut[:, -1] - lut[:, 0]) / (K - 1)
    recon = a[:, None] + b[:, None] * np.arange(K, dtype=np.float32)
    err = np.abs(recon - lut).max(axis=1)
    scale = np.maximum(np.abs(lut).max(axis=1), 1e-8)
    bad = err > tol * scale
    if bad.any():
        raise ValueError(
            f"intN code storage requires an affine codebook; layers "
            f"{np.nonzero(bad)[0].tolist()} deviate by up to "
            f"{float((err / scale).max()):.2e} (calibrate with "
            f"--mode uniform, or use codes='nuq')"
        )
    return a, b


def check_intn_codebook(dcfg, dq) -> None:
    """Guard for the intN storage modes, whose dequant folds the codebook
    into ``a + b*code`` from its endpoints: a non-affine codebook would
    silently mis-dequantize in the kernel. No-op for codes == "nuq".

    The check copies the codebooks to the host once per DeployedQuant
    object (a device sync); later calls with the same object skip it."""
    if dcfg.codes == "nuq" or getattr(dq, "_affine_checked", False):
        return
    affine_lut_coeffs(dq.k_lut_dec)
    affine_lut_coeffs(dq.v_lut_dec)
    dq._affine_checked = True


def deployed_from_quantizers(qs, n_kv_heads: int, d_head: int,
                             device="cuda") -> DeployedQuant:
    dev = resolve_device(device)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    def luts(get):
        enc, dec = [], []
        for lq in qs.layers:
            q = get(lq)
            lut = np.sort(np.asarray(q.lut, np.float32).reshape(-1))
            enc.append(lut)
            if q.normscale is not None:
                dec.append(lut * q.normscale + q.normoffset)
            else:
                dec.append(lut)
        return t(np.stack(enc)), t(np.stack(dec))

    k_enc, k_dec = luts(lambda lq: lq.k)
    v_enc, v_dec = luts(lambda lq: lq.v)
    up = t(np.stack([np.asarray(lq.k.upper, np.float32).reshape(-1)
                     for lq in qs.layers]))
    lo = t(np.stack([np.asarray(lq.k.lower, np.float32).reshape(-1)
                     for lq in qs.layers]))
    L, C = up.shape
    assert C == n_kv_heads * d_head
    ressc = t(np.stack([
        np.zeros(C, np.float32) if lq.k.ressc is None
        else np.asarray(lq.k.ressc, np.float32).reshape(-1)
        for lq in qs.layers
    ]))
    return DeployedQuant(
        k_ressc=ressc,
        k_range=((up - lo) / 2).reshape(L, n_kv_heads, d_head),
        k_offset=((up + lo) / 2).reshape(L, n_kv_heads, d_head),
        k_lower=lo,
        k_upper=up,
        k_lut_enc=k_enc,
        k_lut_dec=k_dec,
        v_lut_enc=v_enc,
        v_lut_dec=v_dec,
    )
