"""The yardstick's pieces against hand counts: seeded traffic, rates and
tails, the K1 / expert bounds and the model FLOPs, the loops on a fake
server, files found by name, and the import rule."""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest

from pbench import arith, driver, layers, spec, stats, traffic
from pbench.tracing import Group, reduce_events

MISTRAL = spec.config("mistral-7b-v0.2")
DBRX = spec.config("dbrx-8of40")
SCHEME = spec.scheme("nuq3-k1")


# -- traffic ---------------------------------------------------------------

def _reqs(spec_, seed, n=20, vocab=1000):
    t = traffic.Traffic(spec_, seed, vocab)
    return [t.next() for _ in range(n)]


def test_traffic_same_seed_same_requests():
    tr = spec.traffic("decode-moe")
    a, b = _reqs(tr, 5), _reqs(tr, 5)
    assert all(np.array_equal(x.prompt, y.prompt) and x.answer == y.answer
               for x, y in zip(a, b))


def test_traffic_seeds_share_sizes_not_order_nor_tokens():
    tr = dict(spec.traffic("decode-moe"), pool=16, strata=4)
    a, b = _reqs(tr, 5, 32), _reqs(tr, 2 ** 31 + 7, 32)
    for lo in (0, 16):  # every pass over the pool: the same sizes
        for size in (lambda r: len(r.prompt), lambda r: r.answer):
            assert sorted(map(size, a[lo:lo + 16])) == sorted(
                map(size, b[lo:lo + 16]))
    assert [len(r.prompt) for r in a] != [len(r.prompt) for r in b]
    assert not np.array_equal(a[0].prompt, b[0].prompt)
    assert min(len(r.prompt) for r in a) >= 16


def test_traffic_pool_means_are_the_sources():
    tr = spec.traffic("decode-moe")
    n = tr["pool"]
    assert traffic.pool(tr["prompt"], n).mean() == pytest.approx(161.31,
                                                                 rel=0.01)
    assert traffic.pool(tr["answer"], n).mean() == pytest.approx(337.99,
                                                                 rel=0.01)
    assert tr["prompt"]["max"] <= 1024
    assert tr["prompt"]["max"] + tr["answer"]["max"] <= 2048


def test_traffic_blocks_hold_one_size_of_each_stratum():
    rng = np.random.default_rng(0)
    vals = np.arange(64)
    out = traffic.stratified(rng, vals, 8)
    assert sorted(out) == list(vals)
    for b in range(8):
        assert sorted(out[8 * b:8 * b + 8] // 8) == list(range(8))


@pytest.mark.parametrize("dist,lo,hi", [("uniform", 8192, 16384),
                                        ("loguniform", 512, 2048)])
def test_traffic_pool_quantiles(dist, lo, hi):
    p = traffic.pool({"dist": dist, "min": lo, "max": hi}, 4)
    q = (np.arange(4) + 0.5) / 4
    want = lo + (hi - lo) * q if dist == "uniform" else np.exp(
        np.log(lo) + (np.log(hi) - np.log(lo)) * q)
    assert np.array_equal(p, np.rint(want).astype(int))


def test_open_loop_gaps_are_a_fixed_pool_in_a_seeded_order():
    tr = {"loop": "open", "rate_per_s": 10.0, "pool": 8,
          "prompt": {"dist": "uniform", "min": 64, "max": 64},
          "answer": {"dist": "uniform", "min": 8, "max": 8}}
    a, b = _reqs(tr, 1, 8), _reqs(tr, 2, 8)
    ga = np.diff([0.0] + [r.due for r in a])
    gb = np.diff([0.0] + [r.due for r in b])
    assert np.allclose(sorted(ga), sorted(gb)) and not np.allclose(ga, gb)
    assert abs(a[-1].due - b[-1].due) < 1e-9
    assert abs(ga.mean() - 0.1) < 0.03


def test_open_loop_gaps_are_not_stratified():
    """Arrivals bunch as a Poisson process's do: some stretch of 16
    requests holds several of the pool's shortest sixteenth of gaps (a
    stratified order would hold exactly one in each block of 16)."""
    tr = {"loop": "open", "rate_per_s": 10.0, "pool": 256, "strata": 16,
          "prompt": {"dist": "uniform", "min": 64, "max": 64},
          "answer": {"dist": "uniform", "min": 8, "max": 8}}
    g = np.diff([0.0] + [r.due for r in _reqs(tr, 3, 256)])
    short = g <= np.sort(g)[15]
    assert max(short[i:i + 16].sum() for i in range(0, 256, 16)) >= 3


# -- rates and tails -------------------------------------------------------

def test_percentile_interpolates_and_counts_inf():
    assert stats.percentile([1, 2, 3, 4, 5], 50) == 3
    assert stats.percentile([0, 10], 95) == pytest.approx(9.5)
    assert stats.percentile([1] * 20 + [math.inf], 95) == 1
    assert stats.percentile([1] * 10 + [math.inf] * 10, 95) == math.inf


def test_rates_and_gaps_over_all_tokens():
    a = driver.ReqLog(0, np.zeros(3), 4, due=0.0, token_t=[0.5, 1.0, 1.5, 2.5])
    b = driver.ReqLog(1, np.zeros(3), 2, due=1.2, token_t=[1.6, 1.7])
    c = driver.ReqLog(2, np.zeros(3), 2, due=1.9)
    assert stats.tokens_in([a, b], 0.75, 2.0) == 4
    assert sorted(stats.gaps_in([a, b], 0.75, 2.0)) == pytest.approx(
        [0.1, 0.5])
    assert stats.ttfts([a, b, c], 1.0, 2.0) == pytest.approx(
        [0.4, math.inf])


# -- bounds and FLOPs ------------------------------------------------------

def test_stored_bytes_per_token():
    for cfg in (MISTRAL, DBRX):
        m = arith.model_dims(cfg)
        # 2 x 8 heads x 128 x 3 bits = 768 B codes, 2 groups x 8 slots x 4
        # B = 64 B slot words, 8 B V scale and offset
        assert arith.stored_bytes_per_token(m, SCHEME) == 840


def test_k1_decode_bound_by_hand():
    m = dict(arith.model_dims(MISTRAL), L=1)
    nbytes, flops = arith.k1_decode_bound(m, SCHEME, [4, 5, 104])
    sinks = 2 * 8 * 5 * 128 * 4
    qo = 2 * 32 * 128 * 4
    assert nbytes == (0 + 1 + 100) * 840 + 3 * (sinks + qo)
    assert flops == 4 * 128 * 32 * (5 + 6 + 105)


def test_k1_chunk_bound_by_hand():
    m = dict(arith.model_dims(DBRX), L=1)
    nbytes, flops = arith.k1_chunk_bound(m, SCHEME, 261, 256)
    visible = sum(p + 1 for p in range(261, 517))
    assert flops == 4 * 128 * 48 * visible
    assert nbytes == (516 - 5 + 1) * 840 + 2 * 8 * 5 * 128 * 4 + \
        2 * 256 * 48 * 128 * 4


def test_expert_bytes_and_params():
    m = arith.model_dims(DBRX)
    assert arith.expert_bytes_per_step(m) == 8 * 16 * 3 * 6144 * 10752 * 2
    per_layer = 6144 * (48 + 16) * 128 + 48 * 128 * 6144 + 6144 * 16 + \
        4 * 3 * 6144 * 10752
    assert arith.matmul_params_per_token(m) == 8 * per_layer + 6144 * 100352
    mm = arith.model_dims(MISTRAL)
    assert arith.matmul_params_per_token(mm) == 32 * (
        4096 * 48 * 128 + 4096 * 4096 + 3 * 4096 * 14336) + 4096 * 32000


def test_model_flops_by_hand():
    m = dict(arith.model_dims(MISTRAL), L=2, V=10)
    p = arith.matmul_params_per_token(m)
    assert arith.token_flops(m, 7) == 2 * p + 2 * 4 * 128 * 32 * 7
    assert arith.prompt_flops(m, 3, 6) == 3 * 2 * p + 2 * 4 * 128 * 32 * (
        4 + 5 + 6)


# -- the loops on a fake server ---------------------------------------------

class FakeServer:
    """The public surface of serve.Server with its chunked admission (one
    chunk of one admission a step, free slots in order) and instant steps
    that advance a fake clock by ``dt``; each decode emits token 7."""

    def __init__(self, n=3, chunk=128, sink=5, dt=0.01):
        from collections import deque

        self.n, self.admit_chunk = n, chunk
        self.dcfg = SimpleNamespace(sink=sink)
        self.queue, self.admitting, self.active = deque(), [], [None] * n
        self.out, self.pos = {}, np.zeros(n, np.int32)
        self.last_tok = np.zeros(n, np.int32)
        self.decode_steps, self.t, self.dt = 0, 0.0, dt
        self.remaining = np.zeros(n, np.int32)

    def clock(self):
        return self.t

    def submit(self, req):
        self.queue.append(req)
        self.out[req.rid] = SimpleNamespace(tokens=[])

    def step(self):
        self.t += self.dt
        busy = {a.slot for a in self.admitting}
        for b in range(self.n):
            if self.active[b] is None and b not in busy and self.queue:
                r = self.queue.popleft()
                n = -(-(len(r.prompt) - self.dcfg.sink) // self.admit_chunk)
                self.admitting.append(SimpleNamespace(req=r, slot=b, ci=0,
                                                      n_chunks=n))
                busy.add(b)
        if self.admitting:
            a = self.admitting[0]
            a.ci += 1
            if a.ci == a.n_chunks:
                self.admitting.pop(0)
                b = a.slot
                self.active[b], self.pos[b] = a.req, len(a.req.prompt)
                self.remaining[b] = a.req.max_new_tokens - 1
                self.out[a.req.rid].tokens.append(3)
                self.last_tok[b] = 3
                if self.remaining[b] <= 0:
                    self.active[b] = None
        if any(a is not None for a in self.active):
            self.decode_steps += 1
            for b in range(self.n):
                if self.active[b] is None:
                    continue
                self.pos[b] += 1
                self.out[self.active[b].rid].tokens.append(7)
                self.last_tok[b] = 7
                self.remaining[b] -= 1
                if self.remaining[b] <= 0:
                    self.active[b] = None


def _fake(n=3):
    srv = FakeServer(n)
    Req = lambda rid, prompt, max_new_tokens: SimpleNamespace(  # noqa
        rid=rid, prompt=prompt, max_new_tokens=max_new_tokens)
    return srv, driver.Recorder(srv, Req, clock=srv.clock)


def _tr(loop="closed", **kw):
    return dict({"loop": loop, "clients": 3, "pool": 8,
                 "prompt": {"dist": "uniform", "min": 100, "max": 600},
                 "answer": {"dist": "uniform", "min": 3, "max": 9}}, **kw)


def test_closed_loop_keeps_every_client_busy():
    srv, rec = _fake()
    t = traffic.Traffic(_tr(), 3, 50)
    driver.fill(rec, t, 3)
    assert not srv.queue and not srv.admitting
    driver.closed_loop(rec, t, srv.t + 2.0)
    live = [r for r in rec.reqs.values() if not r.finished]
    assert len(live) == 3  # one request per client in flight at any time
    done = [r for r in rec.reqs.values() if r.finished]
    assert done and all(len(r.token_t) == r.answer for r in done)
    # every step decoded the slots it said, at the positions it said
    for st in rec.steps:
        if st.decoded:
            assert st.active.any()


def test_closed_loop_records_chunks_and_decodes():
    srv, rec = _fake()
    t = traffic.Traffic(_tr(), 4, 50)
    driver.fill(rec, t, 3)
    driver.closed_loop(rec, t, srv.t + 1.0)
    chunks = [st.chunk for st in rec.steps if st.chunk is not None]
    for r in rec.reqs.values():
        mine = [c for c in chunks if c.rid == r.rid]
        if mine and mine[-1].last:
            assert [c.ci for c in mine] == list(range(mine[-1].n_chunks))
            assert mine[-1].hi == len(r.prompt)


def test_open_loop_submits_when_due():
    srv, rec = _fake(n=8)
    t = traffic.Traffic(_tr("open", rate_per_s=20.0), 5, 50)
    loop = driver.OpenLoop(rec, t, srv.t)
    fake_sleep = lambda s: setattr(srv, "t", srv.t + s)  # noqa: E731
    orig, driver.time.sleep = driver.time.sleep, fake_sleep
    try:
        loop.run(3.0)
    finally:
        driver.time.sleep = orig
    assert len(rec.reqs) >= 40
    assert all(late >= 0 and late <= srv.dt + 1e-9 for _, late in loop.late)
    dues = [r.due for r in rec.reqs.values()]
    assert dues == sorted(dues)


# -- files found by name -----------------------------------------------------

def test_throwaway_cell_metric_and_config_found_by_name(tiny_base):
    base, bench = tiny_base
    with open(os.path.join(base, "metrics", "zz.throwaway_pct.py"), "w") as f:
        f.write("def read(run):\n    return 42.0 + run.extra\n")
    assert spec.metric_reader("zz.throwaway_pct", base)(
        SimpleNamespace(extra=1)) == 43.0
    c = spec.cell(bench, "tiny-dbrx-closed", base)
    assert c["config"]["d_model"] == 96 and c["traffic"]["clients"] == 3
    assert c["scheme"]["bits"] == 3 and c["workload"]["slots"] == 3
    assert {m["name"] for m in c["end_to_end"]} >= {"setup_s"}


def test_every_benchmark_entry_has_its_files():
    bench = spec.benchmark()
    for w in bench["workloads"]:
        c = spec.cell(bench, w["name"])
        assert c["per_layer"] and c["end_to_end"]
    for mt in bench["per_layer"]:
        assert callable(spec.metric_reader(mt["name"]))
    for cfg in bench["configs"]:
        with open(os.path.join(spec.REPO, cfg["file"])) as f:
            assert json.load(f)["source"].startswith("https://")


# -- the trace's reduction ---------------------------------------------------

def _ev(name, s, e, cuda):
    import torch

    dt = torch.autograd.DeviceType.CUDA if cuda else \
        torch.autograd.DeviceType.CPU
    return SimpleNamespace(name=name, device_type=dt,
                           time_range=SimpleNamespace(start=s, end=e))


def test_reduce_events_busy_idle_and_k1_bodies():
    # device times in microseconds from the trace's start; the first
    # device event is put at the group's start on the host clock (10 s)
    ev = [_ev("void fd_chunk<3>(FdArgs)", 1010, 1030, True),
          _ev("cudaLaunchKernel", 1000, 1001, False),
          _ev("fd_merge(FdArgs)", 1030, 1032, True),
          _ev("gemm", 1031, 1050, True),
          _ev("void fd_gqa<1>(FdArgs)", 1060, 1070, True),
          _ev("fd_merge(FdArgs)", 1070, 1071, True),
          _ev("Memcpy DtoH (Device -> Pageable)", 1080, 1085, True)]
    lo, hi = 10.0, 10.0 + 85e-6
    spans = [("server.step", lo, lo + 75e-6),
             ("loadgen", lo + 75e-6, hi)]
    g = reduce_events(ev, [], spans, lo, hi)
    assert g.window_s == pytest.approx(85e-6)
    assert g.busy_s == pytest.approx((50 - 10 + 11 + 5) * 1e-6)
    assert g.k1["fd_chunk"] == pytest.approx(22e-6)
    assert g.k1["fd_gqa"] == pytest.approx(11e-6)
    assert g.n_kernels == 5
    assert sorted(g.gaps) == [("loadgen", pytest.approx(10e-6)),
                              ("server.step", pytest.approx(9e-6)),
                              ("server.step", pytest.approx(10e-6))]


def test_trace_cost_by_kind():
    from pbench.tracing import trace_cost

    st = lambda t, chunk=None: SimpleNamespace(t0=0.0, t1=t,  # noqa: E731
                                               chunk=chunk)
    g = Group(steps=[st(0.04), st(0.06), st(0.09, 1)])
    out = trace_cost([g], [st(0.03), st(0.05), st(0.04), st(0.08, 1)])
    assert out["decode_traced_ms"] == pytest.approx(50.0)
    assert out["decode_untraced_ms"] == pytest.approx(40.0)
    assert out["chunk_traced_ms"] == pytest.approx(90.0)
    assert out["chunk_untraced_n"] == 1


def test_idle_share_against_untraced_iterations():
    st = lambda t0, chunk=None: SimpleNamespace(t0=t0, t1=t0 + 0.01,  # noqa
                                                chunk=chunk)
    # untraced iterations: decode-only 0.03, 0.04, 0.05 s; a chunk 0.08 s
    steps = [st(0.0), st(0.03), st(0.07), st(0.12, 1), st(0.20)]
    g = Group(steps=[st(1.0), st(1.1), st(1.2, 1)], busy_s=0.12)
    run = SimpleNamespace(steps=steps, groups=[g])
    assert layers.idle_pct(run) == pytest.approx(
        100 * (1 - 0.12 / (0.04 + 0.04 + 0.08)))
    run.steps = steps[:3]  # no untraced chunk step: nothing to read
    assert layers.idle_pct(run) is None


def test_readers_return_nothing_without_a_trace():
    run = SimpleNamespace(groups=[], steps=[], reqs={}, late=[], t0=0.0,
                          t1=1.0, n_slots=4, m=arith.model_dims(DBRX),
                          scheme=SCHEME)
    for f in (layers.k1_decode_pct, layers.k1_chunk_pct, layers.experts_pct,
              layers.kernels_per_step, layers.idle_pct, layers.mfu_pct,
              layers.occupancy_pct, layers.queue_wait_p90_ms,
              layers.late_p90_ms):
        assert f(run) is None
    assert Group(steps=[]).busy_s == 0.0


# -- imports -------------------------------------------------------------------

def test_reference_and_harness_import_no_jax_nor_program():
    code = ("import sys; sys.path[:0] = [%r, %r]\n"
            "import reference.model, pbench.correct, pbench.arith, "
            "pbench.traffic, pbench.driver, pbench.stats, pbench.layers\n"
            "bad = {k.split('.')[0] for k in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'kvquant_tpu', 'kvquant_tpu_torch'}\n"
            "print(sorted(bad))" % (os.path.dirname(spec.ROOT), spec.ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, env=dict(
                             os.environ, JAX_PLATFORMS="cpu"))
    assert out.stdout.strip() == "[]"


def test_foreign_module_check_compares_whole_names(monkeypatch):
    import run as bench

    monkeypatch.setitem(sys.modules, "kvquant_tpu_torch_fake", object())
    assert "kvquant_tpu" not in bench.foreign_modules()
    monkeypatch.setitem(sys.modules, "kvquant_tpu.fake", object())
    assert bench.foreign_modules() == ["kvquant_tpu"]
