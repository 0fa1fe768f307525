"""The MoE family's capturable capacity dispatch (kvquant_tpu_torch/models/
moe.py: dispatch_slots, moe_ffn_sparse) and the expert products' kernel
wrapper (ops/kernels/moe_experts.py), against the JAX package's
``moe_ffn_sparse`` (kvquant_tpu/models/moe.py:113-152) on the same numpy
inputs, at TINY_MOE widths (4 experts, top 2) and the G 6 toy's:

  (a) ``moe_ffn_sparse`` == JAX's in fp32 within 1e-5 of the output's
      scale (tests/test_torch_moe.py::test_moe_ffn_matches_jax), at
      decode N 1 / 2 / 4 and a chunk-sized N 64, capacity factors 1 and 2,
      with a skewed router that makes pairs drop;
  (b) the kept pairs and their arrival order == JAX's ``keep`` /
      ``pos_in_e``; the slot table holds each kept token at its slot and
      the zero row elsewhere; the counts are the kept pairs;
  (c) close to the per-expert gather / ``index_add`` loop that the port
      ran before, copied here as its reference (sum orders differ between
      a batched and a per-expert product: 1e-6 of the scale in fp32, 2e-2
      in bf16);
  (d) the sparse and the dense FFN read nothing back to the host:
      ``torch.nonzero``, ``Tensor.tolist`` / ``item`` / ``cpu`` patched to
      raise and aten._local_scalar_dense refused;
  (e) ``moe_experts_plain`` == the per-expert ``_expert`` at C 1-8 with
      empty experts (rows past the count zero); the wrapper on the CPU is
      the plain version and counts no launch; the plan by C (the kernel
      at C <= 8, ``torch.bmm`` above and where a gradient is needed); the
      kernel's body by (C, dtype, widths), fp32 never on the tensor
      cores; the rows each body reads (xe itself for "mma", no copy) and
      its scratch, launched through a stub library; the per-body launch
      counts through a graph's record and replay; the ticket array;
  (f) ``engine.graph_unsupported`` is None for an MoEConfig at tp 1 and
      still names tensor parallelism for a rank-local one;
  (g) a rank-local config's partial sums (experts split over two ranks)
      add up to the unsharded FFN.

The kernel itself runs only on a card (chip_smoke.py phase 25).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kvquant_tpu.models import moe as jmoe

from kvquant_tpu_torch import engine
from kvquant_tpu_torch.models import moe
from kvquant_tpu_torch.ops.kernels import moe_experts as mx

torch.set_num_threads(1)

G6 = dict(vocab_size=256, d_model=96, n_layers=1, n_heads=12, n_kv_heads=2,
          d_head=8, d_ff=64, max_seq_len=512, n_experts=4, top_k=2,
          ffn_mode="sparse", norm_type="layernorm", rope_theta=500000.0)
MODELS = {"tiny": (dataclasses.replace(jmoe.TINY_MOE, ffn_mode="sparse"),
                   dataclasses.replace(moe.TINY_MOE, ffn_mode="sparse")),
          "g6": (jmoe.MoEConfig(**G6), moe.MoEConfig(**G6))}


def _layer(which, cf=2.0, skew=0.0, seed=3):
    """(JAX layer, port layer, JAX cfg, port cfg) at capacity factor cf;
    ``skew`` added to expert 0's router column makes it every token's
    favourite, so it overflows."""
    jcfg, tcfg = (dataclasses.replace(c, capacity_factor=cf)
                  for c in MODELS[which])
    jp = jmoe.init_params(jax.random.PRNGKey(seed), jcfg, dtype=jnp.float32)
    tree = jax.tree.map(np.array, jp)
    tree["layers"]["w_router"][0][:, 0] += skew
    tp = moe.params_from_numpy(tree, tcfg, device="cpu")
    jl = jax.tree.map(lambda a: jnp.asarray(a[0]), tree["layers"])
    return jl, tp.layer(0), jcfg, tcfg


def _h(n, d, seed=4):
    return np.abs(np.random.default_rng(seed).standard_normal(
        (1, n, d))).astype(np.float32)


def _close(got, want, rel):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, (err, scale)


def _jax_dispatch(h, jl, jcfg):
    """JAX's keep / pos_in_e, as its moe_ffn_sparse computes them."""
    n = h.shape[1]
    _, jw = jmoe._router_weights(jnp.asarray(h), jl, jcfg)
    routed = (np.asarray(jw).reshape(n, -1) > 0).astype(np.int32)
    pos = np.cumsum(routed, axis=0) - routed
    C = min(n, -(-n * jcfg.top_k // jcfg.n_experts)
            * max(1, int(round(jcfg.capacity_factor))))
    return routed.astype(bool) & (pos < C), pos, C


def _loop_reference(h, lp, cfg):
    """The port's former sparse FFN: each expert on its kept tokens
    gathered on the host, summed back with index_add in expert order."""
    hf = h.reshape(-1, h.shape[-1])
    _, w = moe._router_weights(hf, lp, cfg)
    keep = moe.dispatch(w, moe.capacity(hf.shape[0], cfg))
    exp, tok = torch.nonzero(keep.T, as_tuple=True)
    out = torch.zeros(hf.shape, dtype=torch.float32)
    start = 0
    for e, n in enumerate(torch.bincount(exp, minlength=cfg.n_experts)
                          .tolist()):
        r = tok[start:start + n]
        start += n
        if n:
            y = moe._expert(hf[r], lp, e).to(torch.float32)
            out = out.index_add(0, r, y * w[r, e].to(torch.float32)[:, None])
    return out.to(h.dtype).reshape(h.shape)


CASES = [(which, n, cf) for which in MODELS for n in (1, 2, 4, 64)
         for cf in (1.0, 2.0)]


@pytest.mark.parametrize("which,n,cf", CASES)
def test_sparse_dispatch_matches_jax(which, n, cf):
    """(a) the FFN, (b) the kept pairs and the slot table, (c) the former
    loop, on one skewed router."""
    jl, tl, jcfg, tcfg = _layer(which, cf, skew=0.1)
    h = _h(n, tcfg.d_model)
    want = np.asarray(jmoe.moe_ffn_sparse(jnp.asarray(h), jl, jcfg))
    got = moe.moe_ffn_sparse(torch.as_tensor(h), tl, tcfg)
    assert got.shape == h.shape and got.dtype == torch.float32
    _close(got, want, 1e-5)
    _close(got, _loop_reference(torch.as_tensor(h), tl, tcfg), 1e-6)

    jkeep, jpos, C = _jax_dispatch(h, jl, jcfg)
    assert C == moe.capacity(n, tcfg)
    _, w = moe._router_weights(torch.as_tensor(h).reshape(n, -1), tl, tcfg)
    s = moe.dispatch_slots(w, C)
    np.testing.assert_array_equal(s.keep.numpy(), jkeep)
    np.testing.assert_array_equal(s.pos.numpy()[jkeep], jpos[jkeep])
    np.testing.assert_array_equal(s.count.numpy(), jkeep.sum(0))
    table = np.full((tcfg.n_experts, C), n)
    tok, exp = np.nonzero(jkeep)
    table[exp, jpos[jkeep]] = tok
    np.testing.assert_array_equal(s.tokens.numpy(), table)
    if n > 1 and cf == 1.0:
        assert jkeep.sum() < n * tcfg.top_k  # the skew made pairs drop


@pytest.mark.parametrize("n", [1, 64])
def test_sparse_dispatch_bf16_matches_the_loop(n):
    """(c) in bf16: gate, up, silu * up and the down product round to
    bf16 in both; the fp32 sums of kept experts cast once."""
    _, tl, _, tcfg = _layer("g6", 1.0, skew=0.1)
    tl = {k: v.to(torch.bfloat16) for k, v in tl.items()}
    h = torch.as_tensor(_h(n, tcfg.d_model)).to(torch.bfloat16)
    got = moe.moe_ffn_sparse(h, tl, tcfg)
    assert got.dtype == torch.bfloat16
    _close(got.float(), _loop_reference(h, tl, tcfg).float(), 2e-2)


class _NoHostRead(torch.utils._python_dispatch.TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten._local_scalar_dense.default:
            raise AssertionError("host read: aten._local_scalar_dense")
        return func(*args, **(kwargs or {}))


def _refuse(name):
    def run(*a, **kw):
        raise AssertionError(f"host read: {name}")
    return run


@pytest.mark.parametrize("mode", ["sparse", "dense"])
def test_ffn_makes_no_host_read(mode, monkeypatch):
    """(d) at decode and chunk sizes, drops included."""
    _, tl, _, tcfg = _layer("g6", 1.0, skew=0.1)
    tcfg = dataclasses.replace(tcfg, ffn_mode=mode)
    for n in (4, 64):
        want = moe.moe_ffn(torch.as_tensor(_h(n, 96)), tl, tcfg)
    monkeypatch.setattr(torch, "nonzero", _refuse("torch.nonzero"))
    for name in ("nonzero", "tolist", "item", "cpu"):
        monkeypatch.setattr(torch.Tensor, name, _refuse(f"Tensor.{name}"))
    with _NoHostRead():
        for n in (4, 64):
            got = moe.moe_ffn(torch.as_tensor(_h(n, 96)), tl, tcfg)
        with pytest.raises(AssertionError, match="host read"):
            bool(got.sum() > 0)  # the guard sees a host read
    assert torch.equal(got, want)


def _experts(E, D, Fd, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    return [(torch.randn((E, a, b), generator=g) / a ** 0.5).to(dtype)
            for a, b in ((D, Fd), (D, Fd), (Fd, D))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C", list(range(1, 9)))
def test_experts_plain_matches_per_expert(C, dtype):
    """(e) rows past an expert's count are 0 (whatever xe holds there);
    experts 1 and 3 hold none; the wrapper on the CPU is the plain
    version bitwise and counts no launch."""
    E, D, Fd = 5, 32, 48
    wg, wu, wd = _experts(E, D, Fd, dtype, seed=C)
    xe = torch.randn((E, C, D), generator=torch.Generator().manual_seed(9)
                     ).to(dtype)
    count = torch.tensor([C, 0, max(C - 1, 1), 0, 1], dtype=torch.int32)
    lp = {"w_gate": wg, "w_up": wu, "w_down": wd}
    y = mx.moe_experts_plain(xe, count, wg, wu, wd)
    assert y.shape == (E, C, D) and y.dtype == dtype
    for e in range(E):
        n = int(count[e])
        assert not y[e, n:].any()
        if n:
            _close(y[e, :n].float(), moe._expert(xe[e, :n], lp, e).float(),
                   1e-6 if dtype == torch.float32 else 1e-2)
    before = mx.moe_experts.launches
    assert torch.equal(mx.moe_experts(xe, count, wg, wu, wd), y)
    assert mx.moe_experts.launches == before


def test_kernel_rows_pad_to_an_instance():
    """(e) the kernel's instances hold 1 / 2 / 4 / 8 rows an expert; a C
    between them runs on the next one up, zero rows padding it."""
    assert [mx.kernel_rows(c) for c in range(1, 9)] == [1, 2, 4, 4, 8, 8, 8,
                                                        8]
    for c in (0, mx.KERNEL_ROWS + 1):
        with pytest.raises(ValueError, match="rows an expert"):
            mx.kernel_rows(c)


@pytest.mark.parametrize("n,grad,route", [(4, False, "kernel"),
                                          (64, False, "bmm"),
                                          (4, True, "bmm")])
def test_expert_products_route_by_rows(n, grad, route, monkeypatch):
    """(e) the plan by C: C = 2 at N 4 goes to the kernel's wrapper, C 32
    at N 64 to torch.bmm, and so does a call whose weights need a
    gradient (the kernel has no backward)."""
    _, tl, _, tcfg = _layer("tiny", 1.0)
    if grad:
        tl = {k: v.clone().requires_grad_(True) for k, v in tl.items()}
    took = []
    for name in ("moe_experts", "swiglu_products"):
        orig = getattr(mx, name)
        monkeypatch.setattr(mx, name, lambda *a, o=orig, k=name: (
            took.append(k), o(*a))[1])
    out = moe.moe_ffn_sparse(torch.as_tensor(_h(n, 64)), tl, tcfg)
    # on the CPU the kernel's wrapper runs its plain version, itself
    # through swiglu_products
    assert took == {"kernel": ["moe_experts", "swiglu_products"],
                    "bmm": ["swiglu_products"]}[route]
    if grad:
        out.sum().backward()
        assert tl["w_down"].grad is not None


DBRX = (16, 6144, 10752)  # E, D, F of the DBRX layer the card runs


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C", list(range(1, 9)))
def test_kernel_body_by_rows_and_dtype(C, dtype):
    """(e) bf16 at DBRX's widths runs the tensor-core body at the rows of
    MMA_ROWS and the SIMT body elsewhere; fp32 never leaves the SIMT body
    (the tensor cores would take it as TF32)."""
    want = ("mma" if dtype == torch.bfloat16 and C in mx.MMA_ROWS
            else "simt")
    assert mx.body(C, dtype, *DBRX) == want
    assert mx.mma_takes(dtype, *DBRX) == (dtype == torch.bfloat16)


@pytest.mark.parametrize("E,D,Fd", [(16, 6144 + 16, 10752),
                                    (16, 6144, 10752 + 8),
                                    (mx.MMA_MAX_EXPERTS + 1, 64, 64)])
def test_kernel_body_needs_whole_stages(E, D, Fd):
    """(e) widths that do not fill whole ring stages, or more experts than
    the live list holds, keep bf16 on the SIMT body at every C."""
    assert not mx.mma_takes(torch.bfloat16, E, D, Fd)
    assert {mx.body(C, torch.bfloat16, E, D, Fd)
            for C in range(1, 9)} == {"simt"}
    with pytest.raises(ValueError, match="rows an expert"):
        mx.body(mx.KERNEL_ROWS + 1, torch.bfloat16, *DBRX)


class _StubLib:
    """What ``_launch`` hands the C entry, recorded; launches nothing."""

    PART, TICKS = 96, 40

    def __init__(self):
        self.calls = []

    def moe_experts_scratch(self, E, D, Fd, out):
        out[0], out[1], out[2], out[3] = self.PART, self.TICKS, 132, 132
        return 0

    def moe_experts(self, *args):
        self.calls.append(args)
        return 0


@pytest.mark.parametrize("route", ["mma", "simt"])
@pytest.mark.parametrize("C", [1, 3, 8])
def test_launch_lays_out_each_body(route, C, monkeypatch):
    """(e) the tensor-core body reads the rows as they are (the pointer of
    xe: no transpose, no copy) with CR = C, an (E, C, F) scratch and the
    partials and tickets; the SIMT body reads them by element, (E, D, CR),
    a view of xe only at C 1, with no partials or tickets. Each launch
    counts once in ``launches`` and once under its body."""
    monkeypatch.setattr(mx.moe_experts, "launches", 0)
    monkeypatch.setattr(mx.moe_experts, "launches_by_body",
                        {"simt": 0, "mma": 0})
    monkeypatch.setattr(mx, "_tickets", {})
    E, D, Fd = 3, 32, 64
    wg, wu, wd = _experts(E, D, Fd, torch.bfloat16, seed=C)
    xe = torch.randn((E, C, D)).to(torch.bfloat16)
    count = torch.tensor([C, 0, 1], dtype=torch.int32)
    lib = _StubLib()
    y = mx._launch(lib, route, xe, count, wg, wu, wd, 0)
    assert y.shape == (E, C, D) and y.dtype == torch.bfloat16
    (x_ptr, c_ptr, g_ptr, u_ptr, d_ptr, a_ptr, y_ptr, part, ticks, e_, c_,
     cr, d_, f_, dt, b, stream), = lib.calls
    assert (x_ptr == xe.data_ptr()) == (route == "mma" or C == 1)
    assert (c_ptr, g_ptr, u_ptr, d_ptr, y_ptr) == (
        count.data_ptr(), wg.data_ptr(), wu.data_ptr(), wd.data_ptr(),
        y.data_ptr())
    assert (e_, c_, d_, f_, dt, b) == (E, C, D, Fd, 1, mx.BODIES[route])
    assert cr == (C if route == "mma" else mx.kernel_rows(C))
    if route == "mma":
        t = mx._tickets[xe.device]
        assert ticks == t.data_ptr() and t.numel() >= lib.TICKS
        assert part is not None and not t.any()
    else:
        assert part is None and ticks is None and not mx._tickets
    assert mx.moe_experts.launches == 1
    assert mx.moe_experts.launches_by_body == {
        "simt": int(route == "simt"), "mma": int(route == "mma")}


@pytest.mark.parametrize("C", [1, 3, 8])
def test_rows_operand_by_body(C):
    """(e) the rows each body reads: xe itself for "mma"; for "simt" the
    rows by element, zero past C up to the instance's CR, equal to xe."""
    xe = torch.randn((4, C, 16))
    assert mx.kernel_rows_operand(xe, "mma") is xe
    x = mx.kernel_rows_operand(xe, "simt")
    CR = mx.kernel_rows(C)
    assert x.shape == (4, 16, CR) and x.is_contiguous()
    assert torch.equal(x[..., :C], xe.transpose(1, 2))
    assert not x[..., C:].any()


def test_tickets_made_zero_once_and_kept(monkeypatch):
    """(e) one zero ticket array a device, kept across calls (the kernels
    leave it zero), made anew only where a longer one is needed."""
    monkeypatch.setattr(mx, "_tickets", {})
    dev = torch.device("cpu")
    t = mx.tickets(dev, 10)
    assert t.dtype == torch.int32 and t.numel() == 10 and not t.any()
    assert mx.tickets(dev, 8) is t
    t2 = mx.tickets(dev, 12)
    assert t2 is not t and t2.numel() == 12 and not t2.any()


def test_body_counters_recorded_and_replayed(monkeypatch):
    """(e) the per-body counts are counters of their own: a graph's
    capture records them and each replay adds them; launch_counts keeps
    one count for the wrapper."""
    from kvquant_tpu_torch.ops import kernels as tk

    monkeypatch.setattr(mx.moe_experts, "launches", 4)
    monkeypatch.setattr(mx.moe_experts, "launches_by_body",
                        {"simt": 1, "mma": 3})

    def capture():
        mx.moe_experts.launches += 8
        mx.moe_experts.launches_by_body["mma"] += 8

    _, delta = tk.counted(capture)
    assert delta == {"moe_experts": 8, "moe_experts:mma": 8}
    assert mx.moe_experts.launches_by_body == {"simt": 1, "mma": 3}
    for _ in range(2):
        tk.add_launches(delta)
    assert mx.moe_experts.launches == 20
    assert mx.moe_experts.launches_by_body == {"simt": 1, "mma": 19}
    assert tk.snapshot()["moe_experts:simt"] == 1
    assert "moe_experts:mma" not in tk.launch_counts()


def _rank_local(cfg, rank, tp):
    from kvquant_tpu_torch.parallel import shardings

    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    kw["n_experts"] = cfg.n_experts // tp
    return shardings._local_class(type(cfg))(
        **kw, tp_group=object(), tp_rank=rank, tp_size=tp)


def test_graph_unsupported_takes_the_moe_family():
    """(f)"""
    for which in MODELS:
        for mode in ("dense", "sparse"):
            cfg = dataclasses.replace(MODELS[which][1], ffn_mode=mode)
            assert engine.graph_unsupported(cfg) is None
    assert "tensor parallelism" in engine.graph_unsupported(
        _rank_local(moe.TINY_MOE, 0, 2))


@pytest.mark.parametrize("n", [2, 64])
def test_rank_local_experts_sum_to_the_whole(n, monkeypatch):
    """(g) two ranks of two experts each: the global routing and capacity
    on both, each rank's own experts, the fp32 sums added (the tp group's
    sum, here in the test) == the unsharded FFN."""
    _, tl, _, tcfg = _layer("tiny", 1.0, skew=0.1)
    h = torch.as_tensor(_h(n, 64))
    want = moe.moe_ffn_sparse(h, tl, tcfg)
    monkeypatch.setattr(moe, "reduce_from_tp", lambda x, group: x)
    parts = []
    for rank in range(2):
        lp = dict(tl)
        for k in ("w_gate", "w_up", "w_down"):
            lp[k] = tl[k][2 * rank:2 * rank + 2].contiguous()
        parts.append(moe.moe_ffn_sparse(h, lp, _rank_local(tcfg, rank, 2)))
    _close(parts[0] + parts[1], want, 1e-6)
