"""The serving path's span recorder (``kvquant_tpu_torch.utils.profiling``,
``SpanRecorder`` / ``SPANS``) on the CPU: nesting, parents and self time,
the bounded rings, host gaps on a scripted sequence of blocking reads and
enqueues (a fake clock), device times from a replay's launch, read only at
the next blocking read (fake events), the switch, and ``serve.Server`` over the committed toy
model served with the recorder on and off."""

import os

import numpy as np
import pytest
import torch

from kvquant_tpu_torch import serve
from kvquant_tpu_torch.cache import DeployConfig, deployed_from_quantizers
from kvquant_tpu_torch.models import params_from_numpy
from kvquant_tpu_torch.quant.artifacts import load_quantizers
from kvquant_tpu_torch.utils import profiling
from kvquant_tpu_torch.utils.profiling import SPANS, SpanRecorder
from kvquant_tpu_torch.utils.toymodel import TOY_CFG, load_toy_checkpoint

ART = os.path.join(os.path.dirname(__file__), os.pardir, "artifacts")
torch.set_num_threads(1)


class Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def tick(self, dt):
        self.t += dt


class FakeEvent:
    """A CUDA event's surface: ``done`` says whether the device has
    reached it; ``elapsed_time`` refuses an event it has not."""

    def __init__(self, clock):
        self.clock, self.at, self.done = clock, None, False

    def record(self, stream):
        assert stream is STREAM
        self.at, self.done = self.clock(), False

    def query(self):
        return self.done

    def elapsed_time(self, end):
        assert self.done and end.done, "read before the events completed"
        return (end.at - self.at) * 1e3


STREAM = object()  # the stream a replay runs on


def _rec(capacity=1 << 16):
    clk = Clock()
    made = []

    def event():
        made.append(FakeEvent(clk))
        return made[-1]

    return SpanRecorder(capacity, clock=clk, event=event), clk, made


def test_spans_nest_with_parents_and_self_time():
    rec, clk, _ = _rec()
    with rec.span("root") as root:
        clk.tick(1.0)
        with rec.span("a", rid=7) as a:
            clk.tick(2.0)
            with rec.span("b") as b:
                clk.tick(0.5)
        with rec.span("a", rid=8) as a2:
            clk.tick(1.5)
        clk.tick(0.25)
    assert root.parent is None
    assert a.parent == root.id and a2.parent == root.id and b.parent == a.id
    assert (a.rid, a2.rid, b.rid) == (7, 8, None)
    out = rec.read(0.0, 10.0)
    assert [s.name for s in out["spans"]] == ["root", "a", "b", "a"]
    by = out["summary"]["by_name"]
    assert by["root"]["count"] == 1
    assert by["root"]["host_s"] == pytest.approx(5.25)
    assert by["root"]["self_s"] == pytest.approx(1.25)
    assert by["a"]["count"] == 2 and by["a"]["host_s"] == pytest.approx(4.0)
    assert by["a"]["self_s"] == pytest.approx(3.5)
    assert by["b"]["self_s"] == pytest.approx(0.5)
    # the ring holds plain tuples, nothing that refers to the recorder
    assert all(type(s) is tuple for s in rec._ring)
    # the interval takes the spans that start in it
    assert [s.name for s in rec.read(1.0, 3.5)["spans"]] == ["a", "b"]


def test_rings_stay_bounded():
    rec, clk, _ = _rec(capacity=8)
    for i in range(20):
        with rec.span("s"):
            clk.tick(1.0)
            rec.device_idle()
        clk.tick(1.0)
        rec.enqueue()
    assert len(rec._ring) == 8 and len(rec._gaps) == 8
    assert [s.id for s in rec.read(0.0, 40.0)["spans"]] == list(
        range(12, 20))  # the newest
    old = rec.read(0.0, 40.0)["summary"]
    assert old["complete"] is False
    assert old["by_name"]["s"]["count"] == 8
    assert rec.read(30.0, 40.0)["summary"]["complete"] is True


def test_host_gap_from_blocking_read_to_next_enqueue():
    rec, clk, _ = _rec()
    rec.enqueue()  # nothing open: nothing recorded
    with rec.span("server.step"):
        clk.tick(1.0)
        with rec.span("server.logits_read"):
            clk.tick(2.0)  # the read waits on the device: no gap yet
            rec.device_idle()  # t 3: idle from here
        with rec.span("server.sample"):
            clk.tick(0.5)
            rec.device_idle()  # a second read: the gap began at the first
        clk.tick(0.25)
    clk.tick(1.0)  # between two steps
    with rec.span("server.step"):
        clk.tick(0.125)
        with rec.span("server.admit"):
            clk.tick(0.125)
            rec.enqueue()  # t 5: closed
            clk.tick(1.0)
            rec.enqueue()  # no gap open
    g = rec.read(0.0, 10.0)
    assert [(x.t0, x.t1) for x in g["gaps"]] == [(3.0, 5.0)]
    hg = g["summary"]["host_gap"]
    assert hg["n"] == 1 and hg["s"] == pytest.approx(2.0)
    assert hg["outside_s"] == pytest.approx(1.0)
    assert hg["pct"] == pytest.approx(20.0)
    assert hg["by_span"] == pytest.approx({
        "server.sample": 0.5, "server.step": 0.375, "outside": 1.0,
        "server.admit": 0.125})
    # an interval that cuts the gap counts what lies inside it
    part = rec.read(4.0, 6.0)["summary"]["host_gap"]
    assert part["s"] == pytest.approx(1.0)
    assert part["outside_s"] == pytest.approx(0.75)
    assert part["by_span"] == pytest.approx({
        "outside": 0.75, "server.step": 0.125, "server.admit": 0.125})


def test_timed_span_reads_its_events_at_the_next_blocking_read():
    rec, clk, made = _rec()

    def device():
        return [s.device_s for s in rec.read(0.0, 100.0)["spans"]
                if s.name == "engine.decode"]

    rec.device_idle()  # t 0: the device idle from here
    with rec.span("server.step"):
        with rec.span("engine.decode", stream=STREAM):
            clk.tick(1.0)  # the inputs' copies: the device still waits
            assert not made
            rec.launch()  # t 1: the replay's launch
            clk.tick(3.0)
        for e in made:
            e.done = True
        assert device() == [None]  # not before the next blocking read
        rec.device_idle()
    assert device() == [pytest.approx(3.0)]
    # the launch closed the gap, after the copies
    assert [(g.t0, g.t1) for g in rec.read(0.0, 100.0)["gaps"]] == [
        (0.0, 1.0)]
    with rec.span("engine.decode", stream=STREAM):
        rec.launch()
        clk.tick(2.0)
    assert len(made) == 2  # the read pair was reused
    rec.device_idle()  # the device has not reached the end event yet
    assert device() == [pytest.approx(3.0), None]
    made[1].done = True
    made[0].done = True
    rec.device_idle()
    assert device() == [pytest.approx(3.0), pytest.approx(2.0)]
    # a timed span that launches nothing (an eager path) takes no events,
    # and a launch outside a timed span records none
    with rec.span("engine.decode", stream=STREAM):
        clk.tick(1.0)
    rec.launch()
    assert len(made) == 2 and not rec._pending
    by = rec.read(0.0, 10.0)["summary"]["by_name"]["engine.decode"]
    assert by["count"] == 3
    assert by["device_n"] == 2 and by["device_s"] == pytest.approx(5.0)
    assert by["device_median_s"] == pytest.approx(2.5)


def test_switched_off_records_nothing():
    rec, clk, made = _rec()
    rec.device_idle()
    rec.enabled = False
    with rec.span("server.step") as sp:
        with rec.span("engine.decode", stream=STREAM):
            clk.tick(1.0)
            rec.device_idle()
        rec.enqueue()  # clears the gap opened before the switch
    assert sp is profiling._NULL
    assert not made and not rec._ring
    out = rec.read(-1.0, 10.0)
    assert out["spans"] == [] and out["gaps"] == []
    assert out["summary"]["host_gap"]["n"] == 0
    rec.enabled = True
    rec.enqueue()
    assert not rec._gaps


# -- serve.Server over the toy model -----------------------------------------

@pytest.fixture(scope="module")
def toy():
    tree, _, _ = load_toy_checkpoint(os.path.join(ART, "toy_model.npz"))
    dq = deployed_from_quantizers(
        load_quantizers(os.path.join(ART, "toy_quantizers_3bit.npz")), 4,
        32, device="cpu")
    dcfg = DeployConfig.create(
        bits=3, n_kv_heads=4, d_head=32, max_len=320, sink=5,
        kernel="flash", dot_bf16=False, head_group=4, codes="nuq",
        post_rope_k=False, k_outliers="slots", cap_per_side=2)
    return params_from_numpy(tree, TOY_CFG, device="cpu"), dcfg, dq


def _requests():
    rng = np.random.default_rng(5)
    return [serve.Request(rid=i, prompt=rng.integers(0, 512, n)
                          .astype(np.int32), max_new_tokens=m)
            for i, (n, m) in enumerate([(20, 9), (150, 6), (30, 5)])]


def _serve(toy, admit_mode):
    params, dcfg, dq = toy
    srv = serve.Server(params, TOY_CFG, dcfg, dq, n_slots=2,
                       admit_mode=admit_mode, admit_chunk=128, device="cpu")
    t0 = SPANS.clock()
    out = srv.run(_requests())
    return srv, {r: c.tokens for r, c in out.items()}, t0, SPANS.clock()


def _by_step(spans):
    """Each root span's name sequence (itself, then its descendants in
    the order they started)."""
    steps, root_of = [], {}
    for s in spans:
        if s.parent is None:
            steps.append([s.name])
            root_of[s.id] = len(steps) - 1
        else:
            root_of[s.id] = root_of[s.parent]
            steps[root_of[s.id]].append(s.name)
    return steps


DECODE = ["engine.decode", "server.logits_read", "server.sample"]


@pytest.mark.parametrize("admit_mode", ["chunked", "sync"])
def test_server_spans_on_and_off(toy, admit_mode, monkeypatch):
    srv, on, t0, t1 = _serve(toy, admit_mode)
    out = SPANS.read(t0, t1)
    spans = out["spans"]
    names = {s.id: s.name for s in spans}
    for s in spans:  # every parent is in the same step
        assert s.parent is None or s.parent in names
        assert s.device_s is None  # no events on the CPU
    parent = {s.name: names.get(s.parent) for s in spans}
    assert parent["server.step"] is None
    assert parent["server.admit"] == "server.step"
    assert parent["server.first_token"] == "server.admit"
    assert parent["engine.decode"] == "server.step"
    steps = _by_step(spans)
    # sync admission prefills a whole prompt inside server.admit
    prompt = ["engine.chunk"] if admit_mode == "chunked" else []
    finish = ["server.step", "server.admit"] + prompt + ["server.first_token"]
    kinds = {"decode": ["server.step"] + DECODE,
             "queued": ["server.step", "server.admit"] + DECODE,
             "finish": finish + DECODE, "finish_only": finish,
             # sync admission fills both free slots in one step
             "finish_two": finish + finish[2:] + DECODE}
    if admit_mode == "chunked":
        kinds["chunk"] = ["server.step", "server.admit"] + prompt + DECODE
    seen = {k: sum(st == v for st in steps) for k, v in kinds.items()}
    assert sum(seen.values()) == len(steps), steps
    assert seen["decode"] and seen["finish"] and seen["queued"]
    by = out["summary"]["by_name"]
    assert by["engine.decode"]["count"] == srv.decode_steps
    assert sorted(s.rid for s in spans if s.name == "server.first_token") \
        == [0, 1, 2]
    if admit_mode == "chunked":
        assert seen["chunk"]  # the 150-token prompt takes two chunks
        assert parent["engine.chunk"] == "server.admit"
        assert sorted(s.rid for s in spans if s.name == "engine.chunk") \
            == [0, 1, 1, 2]
    assert by["server.step"]["count"] == len(steps)
    hg = out["summary"]["host_gap"]
    assert hg["n"] >= srv.decode_steps and 0 < hg["s"] < t1 - t0

    monkeypatch.setattr(SPANS, "enabled", False)
    ring, gaps = list(SPANS._ring), list(SPANS._gaps)
    _, off, t0, t1 = _serve(toy, admit_mode)
    assert off == on  # the same tokens, bitwise
    assert SPANS.read(t0, t1)["spans"] == []
    assert list(SPANS._ring) == ring and list(SPANS._gaps) == gaps
