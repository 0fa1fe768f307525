"""The readers of the program's own spans (``pbench/program_spans.py``,
``metrics/server.host_gap_pct.py``, ``engine.decode_replay_ms``,
``engine.chunk_replay_ms``) against a recorder filled by hand: the
interval they read, the medians, and None where nothing was recorded or
the program has no recorder. On a card: a ``DecodeGraph`` replay inside
``serve.Server.step`` launches the same kernels with the recorder on as
with it off, and the readers find the replays' device times."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from pbench import program_spans, spec


class Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


class Event:
    """Completed at once: ``elapsed_time`` is the clock's difference."""

    def __init__(self, clock):
        self.clock, self.at = clock, None

    def record(self, stream):
        self.at = self.clock()

    def query(self):
        return True

    def elapsed_time(self, end):
        return (end.at - self.at) * 1e3


def _filled():
    """Steps i = 0..9 of a fake server, starting at t = 10 i (seconds): a
    chunk replay of 2 s on every third step, a decode replay of 4 + i s,
    the logits read, and a host gap from there to the next step's first
    launch, 0.5 s after its start (``_gap``); between the steps the
    program is idle (outside every span)."""
    from kvquant_tpu_torch.utils.profiling import SpanRecorder

    clk = Clock()
    rec = SpanRecorder(clock=clk, event=lambda: Event(clk))
    for i in range(10):
        clk.t = 10.0 * i
        with rec.span("server.step"):
            clk.t += 0.5
            if i % 3 == 0:
                with rec.span("engine.chunk", rid=i, stream="s"):
                    rec.launch()
                    clk.t += 2.0
            with rec.span("engine.decode", stream="s"):
                rec.launch()
                clk.t += 4.0 + i
            with rec.span("server.logits_read"):
                rec.device_idle()
            with rec.span("server.sample"):
                clk.t += 0.5
        clk.t += 0.5
    return rec


def _gap(i):
    return 10.0 * i + 4.5 + i + 2.0 * (i % 3 == 0), 10.0 * (i + 1) + 0.5


def _run(t0, t1):
    return SimpleNamespace(t0=t0, t1=t1)


def test_readers_take_the_interval_and_medians():
    rec = _filled()
    # steps 2..5: decode 6, 7, 8, 9 s; chunks at steps 3 only
    run = _run(20.0, 60.0)
    assert program_spans.replay_ms(run, "engine.decode", rec) == \
        pytest.approx(7500.0)
    assert program_spans.replay_ms(run, "engine.chunk", rec) == \
        pytest.approx(2000.0)
    # the gaps' parts inside [20, 60): step 1's last 0.5 s, steps 2-4's
    # whole, step 5's first 0.5 s
    gaps = [min(b, 60.0) - max(a, 20.0) for a, b in map(_gap, range(1, 6))]
    assert gaps == [0.5, 4.0, 1.0, 2.0, 0.5]
    hg = program_spans.summary(run, rec)["summary"]["host_gap"]
    assert hg["n"] == 5 and hg["s"] == pytest.approx(8.0)
    # outside the program: from each step's end to the next one's start
    assert hg["outside_s"] == pytest.approx(3.0 + 1.0)
    assert program_spans.host_gap_pct(run, rec) == pytest.approx(
        100 * 8.0 / 40)
    whole = _run(0.0, 100.0)
    assert program_spans.replay_ms(whole, "engine.decode", rec) == \
        pytest.approx(8500.0)  # median of 4..13 s
    assert program_spans.replay_ms(whole, "engine.chunk", rec) == \
        pytest.approx(2000.0)


def test_readers_give_none_without_records():
    from kvquant_tpu_torch.utils.profiling import SpanRecorder

    rec = _filled()
    empty = _run(200.0, 300.0)  # nothing recorded there
    assert program_spans.host_gap_pct(empty, rec) is None
    assert program_spans.replay_ms(empty, "engine.decode", rec) is None
    # no chunk in [10, 30): no chunk time; decode still there
    assert program_spans.replay_ms(_run(10.0, 30.0), "engine.chunk",
                                   rec) is None
    # spans but no device times (a CPU run)
    clk = Clock()
    cpu = SpanRecorder(clock=clk)
    with cpu.span("engine.decode"):
        clk.t = 1.0
    assert program_spans.replay_ms(_run(0.0, 2.0), "engine.decode",
                                   cpu) is None
    assert program_spans.host_gap_pct(_run(0.0, 2.0), cpu) == 0.0
    # a ring that dropped part of the interval
    small = SpanRecorder(capacity=4, clock=clk)
    for i in range(8):
        clk.t = float(i)
        with small.span("engine.decode"):
            clk.t += 0.5
    assert program_spans.summary(_run(0.0, 8.0), small) is None
    assert program_spans.summary(_run(6.0, 8.0), small) is not None


def test_readers_give_none_for_a_program_without_the_recorder(monkeypatch):
    import kvquant_tpu_torch.utils.profiling as profiling

    monkeypatch.delattr(profiling, "SPANS")
    assert program_spans.recorder() is None
    for name in ("server.host_gap_pct", "engine.decode_replay_ms",
                 "engine.chunk_replay_ms"):
        assert spec.metric_reader(name)(_run(0.0, 1.0)) is None


def test_metric_files_read_the_process_recorder(monkeypatch):
    import kvquant_tpu_torch.utils.profiling as profiling

    monkeypatch.setattr(profiling, "SPANS", _filled())
    run = _run(0.0, 100.0)
    assert spec.metric_reader("engine.decode_replay_ms")(run) == \
        pytest.approx(8500.0)
    assert spec.metric_reader("engine.chunk_replay_ms")(run) == \
        pytest.approx(2000.0)
    assert spec.metric_reader("server.host_gap_pct")(run) == \
        pytest.approx(program_spans.host_gap_pct(run, profiling.SPANS))


def _card_server(tiny_base, device):
    """A DBRX-schema server at widths the card's kernels take (d_head 32,
    G 6, 4 kv heads), 2 layers of 8 experts, top 2; 3 slots."""
    import json
    import os

    from pbench import arith
    from pbench.model import build_server, k_thresholds, make_weights

    base, bj = tiny_base
    with open(os.path.join(base, "configs", "tiny-dbrx", "config.json"),
              "w") as f:
        json.dump(dict(model_type="dbrx", d_model=768, n_heads=24,
                       n_layers=2, max_seq_len=4096, vocab_size=128,
                       attn_config={"kv_n_heads": 4, "rope_theta": 500000},
                       ffn_config={"ffn_hidden_size": 256,
                                   "moe_num_experts": 8, "moe_top_k": 2}),
                  f)
    c = spec.cell(bj, "tiny-dbrx-closed", base)
    m = arith.model_dims(c["config"])
    w = make_weights(m, 11, device)
    k_up, k_lo = k_thresholds(m, c["scheme"], 11)
    return build_server(c["config_path"], m, c["scheme"], w, k_up, k_lo, 3,
                        512, 128, device), m


def test_card_server_serves_on_the_cpu(tiny_base):
    """The card test's server, on the CPU (the kernels' plain versions):
    its requests are admitted and decoded."""
    import numpy as np

    from kvquant_tpu_torch.serve import Request

    srv, m = _card_server(tiny_base, "cpu")
    rng = np.random.default_rng(0)
    for rid, n in enumerate((40, 200)):
        srv.submit(Request(rid=rid, prompt=rng.integers(0, m["V"], n)
                           .astype(np.int32), max_new_tokens=3))
    srv.run([])
    assert [len(srv.out[r].tokens) for r in (0, 1)] == [3, 3]


@pytest.mark.card
def test_replay_kernels_same_with_recorder_on_and_off(card, tiny_base):
    """A decode-only step of a tiny DBRX-schema server on the card: the
    device activity of its DecodeGraph replay, kernel by kernel, is the
    same with the recorder on and off; the readers find device times."""
    import numpy as np
    import torch

    from kvquant_tpu_torch.serve import Request
    from kvquant_tpu_torch.utils.profiling import SPANS

    srv, m = _card_server(tiny_base, "cuda")

    rng = np.random.default_rng(0)
    t0 = SPANS.clock()
    for rid, n in enumerate((40, 200, 300)):
        srv.submit(Request(rid=rid, prompt=rng.integers(0, m["V"], n)
                           .astype(np.int32), max_new_tokens=60))
    while srv.queue or srv.admitting:
        srv.step()
    for _ in range(3):
        srv.step()

    def names_of_one_step():
        torch.cuda.synchronize()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            srv.step()
            torch.cuda.synchronize()
        ev = sorted((e.time_range.start, e.name) for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA)
        return [n for _, n in ev]

    on = names_of_one_step()
    try:
        SPANS.enabled = False
        off = names_of_one_step()
    finally:
        SPANS.enabled = True
    again = names_of_one_step()
    assert srv.active.count(None) == 0  # decode-only steps
    assert len(on) > 10 and on == off == again
    t1 = SPANS.clock()
    run = _run(t0, t1)
    assert program_spans.replay_ms(run, "engine.decode") > 0
    assert program_spans.replay_ms(run, "engine.chunk") > 0
    assert 0 < program_spans.host_gap_pct(run) < 100
