"""The plain reference: the served model in fp32 with TF32 off, written
from the published configs and the storage scheme, in plain PyTorch.

It imports nothing of the program. From the benchmark it takes the inputs
the benchmark made (the bf16 weights, the drawn K thresholds, the scheme's
codebooks, the prompts) and the tokens the program served, which it judges;
everything the program derives from them it works out again:

  - the quantized cache: every key and value at a position past the sink
    is stored as the scheme stores it and read back dequantized (keys per
    channel before RoPE against the drawn thresholds, values per token
    against their 7th extreme each side, the codebook's nearest entry; per
    token and head group of 4 the 2 largest and 2 smallest normalised
    excursions past 1 kept as residuals, truncated to the 14 mantissa bits
    an outlier word holds); the sink positions stay exact;
  - attention of every position over the dequantized cache up to its own
    position, as chunked admission and decode both see it;
  - DBRX's expert dispatch with its capacity rule (``calls``: the rows the
    program ran together, in arrival order, and the rows of the call).

``Reference(..., low=True)`` is the control: the same computation with
every matmul operand rounded to fp8 (e4m3, a scale per row or column),
the precision below the configuration's bf16.

Rows: ``seqs[i]`` are the tokens of sequence i at positions 0..n-1 (its
real rows, row id ``off[i] + p``); ``junk`` rows ``(i, P, token)`` are a
slot's extra decode of ``token`` at position P of sequence i (i = -1: a
slot never admitted, at position 0), attending over sequence i's rows
below P and itself, one row per appearance.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

FP8_MAX = 448.0


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale per slice along ``dim``
    (the contraction axis), back in fp32."""
    s = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30) / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s


def _trunc9(v: torch.Tensor) -> torch.Tensor:
    """fp32 values with the 9 low mantissa bits cleared (an outlier word
    keeps the index there)."""
    return (v.contiguous().view(torch.int32) & -512).view(torch.float32)


def _codes(xn: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """Index of the nearest codebook entry: the number of midpoints that
    ``xn`` strictly exceeds."""
    mids = (lut[:-1] + lut[1:]) * 0.5
    code = torch.zeros(xn.shape, dtype=torch.int64, device=xn.device)
    for m in mids.tolist():
        code += xn > m
    return code


class KVQuant:
    """The scheme's store-and-read-back of keys and values, per layer."""

    def __init__(self, scheme: dict, k_upper, k_lower, dims: dict, device):
        t = lambda a: torch.as_tensor(np.asarray(a, np.float32),  # noqa
                                      device=device)
        self.k_lut = t(sorted(scheme["k_lut"]))
        self.v_lut = t(sorted(scheme["v_lut"]))
        up, lo = t(k_upper), t(k_lower)  # (L, C)
        self.zp, self.hr = (up + lo) * 0.5, (up - lo) * 0.5
        C = dims["Hkv"] * dims["Dh"]
        # the range of a token's values: its 7th extreme each side at
        # C = 1024 (the outlier budget per side, plus one)
        self.v_k = int(((1.0 - scheme["sparsity_threshold"]) / 2.0) * C) + 2
        self.group = scheme["head_group"] * dims["Dh"]
        self.cap = scheme["cap_per_side"]

    def _outliers(self, x, xn, deq):
        """``deq`` plus each head group's kept residuals."""
        N, C = x.shape
        shape = (N, C // self.group, self.group)
        xg, xng = x.reshape(shape), xn.reshape(shape)
        out = deq.reshape(shape).clone()
        signed = torch.where(xng.abs() > 1.0, xng, torch.zeros_like(xng))
        for sign in (1.0, -1.0):
            val = signed * sign
            idx = torch.sort(val, dim=-1, descending=True,
                             stable=True).indices[..., :self.cap]
            genuine = torch.gather(val, -1, idx) > 0
            res = torch.gather(xg, -1, idx) - torch.gather(
                deq.reshape(shape), -1, idx)
            out.scatter_add_(-1, idx, torch.where(
                genuine, _trunc9(res), torch.zeros_like(res)))
        return out.reshape(N, C)

    def keys(self, li: int, k: torch.Tensor) -> torch.Tensor:
        """Pre-RoPE keys (N, C) as read back from the cache."""
        zp, hr = self.zp[li], self.hr[li]
        xn = (k - zp) / hr
        deq = self.k_lut[_codes(xn, self.k_lut)] * hr + zp
        return self._outliers(k, xn, deq)

    def values(self, v: torch.Tensor) -> torch.Tensor:
        """Values (N, C) as read back from the cache."""
        top = torch.topk(v, self.v_k, dim=-1).values[..., -1:]
        bot = -torch.topk(-v, self.v_k, dim=-1).values[..., -1:]
        off, sc = (top + bot) * 0.5, (top - bot) * 0.5
        xn = (v - off) / sc
        deq = self.v_lut[_codes(xn, self.v_lut)] * sc + off
        return self._outliers(v, xn, deq)


class Reference:
    """The model of ``dims`` (``pbench.arith.model_dims``) over
    ``weights`` (the benchmark's bf16 tensors by the names of
    ``pbench.model.make_weights``), fp32, or the fp8 control with
    ``low``."""

    BLOCK = 4096  # rows per block of the row-wise work
    QBLOCK = 512  # queries per block of the attention

    def __init__(self, dims: dict, weights: dict, kvq: KVQuant, sink: int,
                 low: bool = False):
        self.m, self.w, self.kvq, self.S, self.low = dims, weights, kvq, \
            sink, low
        self.dev = weights["embed"].device
        self.dropped = 0  # (token, expert) pairs past capacity, all layers
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        Dh = dims["Dh"]
        inv = 1.0 / dims["theta"] ** (
            torch.arange(0, Dh // 2, dtype=torch.float64) * 2.0 / Dh)
        self.inv_freq = inv.to(self.dev)

    # -- arithmetic -----------------------------------------------------
    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.low:
            return _fp8(a, -1) @ _fp8(b, -2)
        return a @ b

    def f32(self, name: str, *idx) -> torch.Tensor:
        t = self.w[name]
        for i in idx:
            t = t[i]
        return t.to(torch.float32)

    def norm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        eps = self.m["eps"]
        if self.m["family"] == "dbrx":  # bias-free LayerNorm
            mu = x.mean(-1, keepdim=True)
            var = ((x - mu) ** 2).mean(-1, keepdim=True)
            return (x - mu) * torch.rsqrt(var + eps) * w
        return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w

    def rope(self, x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        """x (n, heads, Dh) at positions ``pos`` (n,), rotate-half."""
        ang = pos.to(torch.float64)[:, None] * self.inv_freq
        ang = torch.cat([ang, ang], -1)
        cos = torch.cos(ang).to(torch.float32)[:, None]
        sin = torch.sin(ang).to(torch.float32)[:, None]
        h = x.shape[-1] // 2
        rot = torch.cat([-x[..., h:], x[..., :h]], -1)
        return x * cos + rot * sin

    # -- one layer ------------------------------------------------------
    def _qkv(self, h: torch.Tensor, lw: dict):
        m = self.m
        Hq, Hk = m["H"] * m["Dh"], m["Hkv"] * m["Dh"]
        if m["family"] == "dbrx":
            y = self.mm(h, lw["w_qkv"])
            return y[:, :Hq], y[:, Hq:Hq + Hk], y[:, Hq + Hk:]
        return self.mm(h, lw["wq"]), self.mm(h, lw["wk"]), self.mm(h, lw["wv"])

    def _cache_kv(self, li, k, v, pos):
        """Keys (post-RoPE) and values of rows at ``pos`` as attention reads
        them: exact below the sink, stored and read back above."""
        m = self.m
        q = pos >= self.S
        kc, vc = k.clone(), v.clone()
        if q.any():
            kc[q] = self.kvq.keys(li, k[q])
            vc[q] = self.kvq.values(v[q])
        n = k.shape[0]
        kc = self.rope(kc.reshape(n, m["Hkv"], m["Dh"]), pos)
        return kc, vc.reshape(n, m["Hkv"], m["Dh"])

    def _attend(self, q, kc, vc, qpos):
        """q (n, H, Dh) roped at ``qpos`` over keys / values (t, Hkv, Dh)
        at positions 0..t-1; each query sees the keys at or below its
        position."""
        m = self.m
        G = m["H"] // m["Hkv"]
        n = q.shape[0]
        qh = q.reshape(n, m["Hkv"], G, m["Dh"]).permute(1, 2, 0, 3)
        kh, vh = kc.permute(1, 0, 2), vc.permute(1, 0, 2)  # (Hkv, t, Dh)
        out = torch.empty_like(qh)
        for a in range(0, n, self.QBLOCK):
            b = min(a + self.QBLOCK, n)
            hi = int(qpos[a:b].max()) + 1
            sc = self.mm(qh[:, :, a:b], kh[:, None, :hi].transpose(-1, -2))
            sc = sc * (1.0 / m["Dh"] ** 0.5)
            kpos = torch.arange(hi, device=self.dev)
            mask = kpos[None, :] <= qpos[a:b, None]
            if m["window"] is not None:
                mask &= kpos[None, :] > qpos[a:b, None] - m["window"]
            p = torch.softmax(sc.masked_fill(~mask, float("-inf")), -1)
            out[:, :, a:b] = self.mm(p, vh[:, None, :hi])
        return out.permute(2, 0, 1, 3).reshape(n, m["H"] * m["Dh"])

    def _attention(self, li, h, lw, rows):
        m = self.m
        out = torch.empty((h.shape[0], m["H"] * m["Dh"]), device=self.dev)
        for s, r0, n in rows.seq_spans():
            pos = torch.arange(n, device=self.dev)
            q, k, v = self._qkv(h[r0:r0 + n], lw)
            kc, vc = self._cache_kv(li, k, v, pos)
            q = self.rope(q.reshape(n, m["H"], m["Dh"]), pos)
            out[r0:r0 + n] = self._attend(q, kc, vc, pos)
            for r, P in rows.junk_of(s):
                self._junk(li, h, lw, out, r, P, kc[:P], vc[:P])
        for r, P in rows.junk_of(-1):
            self._junk(li, h, lw, out, r, P, kc[:0], vc[:0])
        return out

    def _junk(self, li, h, lw, out, r, P, kc, vc):
        m = self.m
        pos = torch.tensor([P], device=self.dev)
        q, k, v = self._qkv(h[r:r + 1], lw)
        k1, v1 = self._cache_kv(li, k, v, pos)
        q = self.rope(q.reshape(1, m["H"], m["Dh"]), pos)
        out[r:r + 1] = self._attend(q, torch.cat([kc, k1]),
                                    torch.cat([vc, v1]), pos)

    def _dense_ffn(self, h2, lw):
        out = torch.empty_like(h2)
        for a in range(0, h2.shape[0], self.BLOCK):
            x = h2[a:a + self.BLOCK]
            g = F.silu(self.mm(x, lw["w_gate"])) * self.mm(x, lw["w_up"])
            out[a:a + self.BLOCK] = self.mm(g, lw["w_down"])
        return out

    def _moe_ffn(self, li, h2, lw, calls):
        m = self.m
        E, K = m["E"], m["K"]
        logits = self.mm(h2, lw["w_router"])
        idx = torch.sort(logits, dim=-1, descending=True,
                         stable=True).indices[:, :K]
        wts = torch.zeros_like(logits).scatter_(
            -1, idx, torch.softmax(torch.gather(logits, -1, idx), -1))
        routed = wts > 0
        keep = torch.zeros_like(routed)
        for ids, n in calls:
            cap = min(n, -(-n * K // E) * 2)
            r = routed[ids].to(torch.int64)
            before = torch.cumsum(r, 0) - r
            keep[ids] = routed[ids] & (before < cap)
        self.dropped += int((routed & ~keep).sum())
        out = torch.zeros_like(h2)
        for e in range(E):
            sel = torch.nonzero(keep[:, e]).flatten()
            if sel.numel() == 0:
                continue
            wg, wu = self.f32("w_gate", li, e), self.f32("w_up", li, e)
            wd = self.f32("w_down", li, e)
            for a in range(0, sel.numel(), self.BLOCK):
                s = sel[a:a + self.BLOCK]
                x = h2[s]
                y = self.mm(F.silu(self.mm(x, wg)) * self.mm(x, wu), wd)
                out[s] += wts[s, e, None] * y
        return out

    # -- the whole replay -----------------------------------------------
    def run(self, rows, want: np.ndarray, cols: np.ndarray):
        """Forward over every row of ``rows``; for the rows ``want`` return
        (best logit, logits at ``cols`` (n_want, k), argmax), each on the
        host."""
        m = self.m
        tok = torch.as_tensor(rows.tokens(), device=self.dev)
        x = self.w["embed"][tok].to(torch.float32)
        calls = [(torch.as_tensor(i, device=self.dev), n)
                 for i, n in rows.calls]
        for li in range(m["L"]):
            names = (("w_qkv", "wo", "w_router") if m["family"] == "dbrx"
                     else ("wq", "wk", "wv", "wo", "w_gate", "w_up",
                           "w_down"))
            lw = {k: self.f32(k, li) for k in names}
            ln1, ln2 = self.f32("ln_attn", li), self.f32("ln_mlp", li)
            h = torch.empty_like(x)
            for a in range(0, x.shape[0], self.BLOCK):
                h[a:a + self.BLOCK] = self.norm(x[a:a + self.BLOCK], ln1)
            attn = self._attention(li, h, lw, rows)
            for a in range(0, x.shape[0], self.BLOCK):
                x[a:a + self.BLOCK] += self.mm(attn[a:a + self.BLOCK],
                                               lw["wo"])
            del attn
            for a in range(0, x.shape[0], self.BLOCK):
                h[a:a + self.BLOCK] = self.norm(x[a:a + self.BLOCK], ln2)
            if m["family"] == "dbrx":
                x += self._moe_ffn(li, h, lw, calls)
            else:
                x += self._dense_ffn(h, lw)
            del h, lw
        head, fn = self.f32("head"), self.f32("final_norm")
        want = torch.as_tensor(want, device=self.dev)
        cols = torch.as_tensor(cols, device=self.dev)
        best, at, arg = [], [], []
        for a in range(0, want.numel(), 256):
            lg = self.mm(self.norm(x[want[a:a + 256]], fn), head)
            v, i = lg.max(-1)
            best.append(v)
            arg.append(i)
            at.append(torch.gather(lg, -1, cols[a:a + 256]))
        cat = lambda z: torch.cat(z).cpu().numpy()  # noqa: E731
        return cat(best), cat(at), cat(arg)


class Rows:
    """The rows a reference run computes (see the module docstring), and
    the program's calls over them for the capacity rule."""

    def __init__(self, seqs: list, junk: list | None = None,
                 calls: list | None = None):
        self.seqs = [np.asarray(s, np.int64) for s in seqs]
        self.off = np.concatenate([[0], np.cumsum([len(s) for s in
                                                   self.seqs])]).astype(int)
        self.junk = list(junk or [])
        self.n_real = int(self.off[-1])
        self.calls = calls or []

    def row(self, seq: int, pos: int) -> int:
        return int(self.off[seq]) + pos

    def junk_row(self, j: int) -> int:
        return self.n_real + j

    def tokens(self) -> np.ndarray:
        return np.concatenate(self.seqs + [np.asarray(
            [t for _, _, t in self.junk], np.int64)])

    def seq_spans(self):
        for i, s in enumerate(self.seqs):
            yield i, int(self.off[i]), len(s)

    def junk_of(self, seq: int):
        for j, (s, P, _) in enumerate(self.junk):
            if s == seq:
                yield self.junk_row(j), P
