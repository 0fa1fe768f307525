"""Quantizer artifact format (port of kvquant_tpu/quant/artifacts.py).

A single .npz (plus a JSON metadata blob inside it) with a typed in-memory
schema; the on-disk format is the JAX package's byte for byte, so a file
written by either package loads in the other. numpy only.

Schema per transformer layer:
  k: per-channel quantizer for Keys (static thresholds)
       upper/lower: (H_kv*D,) fp32 calibrated percentile thresholds
       lut:         (2**bits,) fp32 normalized centroids, sorted
       normscale/normoffset: optional Q-Norm scalars
       ressc:       optional (H_kv*D,) per-channel residual energy
  v: per-token quantizer for Values (dynamic range at runtime)
       lut:         (2**bits,) fp32 normalized centroids, sorted
       normscale/normoffset: optional Q-Norm scalars
"""

from __future__ import annotations

import json
import dataclasses
from dataclasses import dataclass

import numpy as np


@dataclass
class KQuantizer:
    upper: np.ndarray  # (C,) fp32
    lower: np.ndarray  # (C,) fp32
    lut: np.ndarray  # (2**bits,) fp32, sorted, normalized to [-1, 1]
    normscale: float | None = None
    normoffset: float | None = None
    ressc: np.ndarray | None = None  # (C,) expected squared residual per
    #   channel after quantization — the static-channel outlier selection
    #   signal for DeployConfig.k_outliers="channels"

    @property
    def zeropoint(self) -> np.ndarray:
        return (self.upper + self.lower) * 0.5

    @property
    def halfrange(self) -> np.ndarray:
        return (self.upper - self.lower) * 0.5


@dataclass
class VQuantizer:
    lut: np.ndarray  # (2**bits,) fp32, sorted, normalized to [-1, 1]
    normscale: float | None = None
    normoffset: float | None = None
    # calibrated per-token thresholds are not needed at runtime (V quant is
    # dynamic) but kept for the simulated static path / introspection:
    upper: np.ndarray | None = None
    lower: np.ndarray | None = None


@dataclass
class LayerQuantizers:
    k: KQuantizer
    v: VQuantizer


@dataclass
class QuantizerSet:
    layers: list[LayerQuantizers]
    bits: int
    sparsity_threshold: float  # e.g. 0.99 => 1% outliers
    cap_outliers: bool
    first_few_fp16: int  # attention-sink tokens kept exact
    meta: dict = dataclasses.field(default_factory=dict)

    def __len__(self):
        return len(self.layers)


def _put(d, prefix, q):
    for f in dataclasses.fields(q):
        v = getattr(q, f.name)
        if v is None:
            continue
        d[f"{prefix}.{f.name}"] = np.asarray(v)


def save_quantizers(path: str, qs: QuantizerSet) -> None:
    arrays: dict[str, np.ndarray] = {}
    for i, lq in enumerate(qs.layers):
        _put(arrays, f"layers.{i}.k", lq.k)
        _put(arrays, f"layers.{i}.v", lq.v)
    header = dict(
        version=1,
        n_layers=len(qs.layers),
        bits=qs.bits,
        sparsity_threshold=qs.sparsity_threshold,
        cap_outliers=qs.cap_outliers,
        first_few_fp16=qs.first_few_fp16,
        meta=qs.meta,
    )
    arrays["__meta__"] = np.frombuffer(
        json.dumps(header).encode("utf-8"), dtype=np.uint8
    )
    with open(path, "wb") as f:
        np.savez_compressed(f, **arrays)


def load_quantizers(path: str) -> QuantizerSet:
    with np.load(path) as z:
        header = json.loads(bytes(z["__meta__"]).decode("utf-8"))
        layers = []
        for i in range(header["n_layers"]):

            def get(name, default=None):
                return z[name] if name in z.files else default

            def scalar(name):
                v = get(name)
                return None if v is None else float(v)

            k = KQuantizer(
                upper=get(f"layers.{i}.k.upper"),
                lower=get(f"layers.{i}.k.lower"),
                lut=get(f"layers.{i}.k.lut"),
                normscale=scalar(f"layers.{i}.k.normscale"),
                normoffset=scalar(f"layers.{i}.k.normoffset"),
                ressc=get(f"layers.{i}.k.ressc"),
            )
            v = VQuantizer(
                lut=get(f"layers.{i}.v.lut"),
                normscale=scalar(f"layers.{i}.v.normscale"),
                normoffset=scalar(f"layers.{i}.v.normoffset"),
                upper=get(f"layers.{i}.v.upper"),
                lower=get(f"layers.{i}.v.lower"),
            )
            layers.append(LayerQuantizers(k=k, v=v))
    return QuantizerSet(
        layers=layers,
        bits=header["bits"],
        sparsity_threshold=header["sparsity_threshold"],
        cap_outliers=header["cap_outliers"],
        first_few_fp16=header["first_few_fp16"],
        meta=header.get("meta", {}),
    )
