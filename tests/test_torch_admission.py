"""Whole-prompt admission in sub-chunks (``serve.Server``'s
``_step_admission``, ``serve.AdmissionCache``, ``engine.prefill_chunk``'s
one-row LM head) on a tiny Mistral-v0.2-schema model (GQA 4, rope theta
1e6, no sliding window) with seeded random fp32 weights, on the CPU:

  (a) a server whose admission chunk holds the longest prompt, run as
      sub-chunks narrower than it, serves the logits of the plain fp32
      reference (``portbench/reference/model.py``) teacher-forced over
      each prompt and its served tokens;
  (b) a sub-chunked admission leaves the cache codes and the last row's
      logits of the same admission run as one padded chunk;
  (c) the one-row LM head is that row of the full logits;
  (d) an admission records the rows and the number of its replays:
      ceil((T - S) / w) sub-chunks, the first with the S sink rows.

The sub-width is the module constant ``serve.ADMIT_SUB_CHUNK``, set here
to 128 (K1's blocks are 128-aligned) so that tiny prompts take several.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

PORTBENCH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "portbench")
if PORTBENCH not in sys.path:
    sys.path.insert(0, PORTBENCH)

from pbench import arith  # noqa: E402
from pbench.model import build_server, k_thresholds, make_weights  # noqa
from reference.model import KVQuant, Reference, Rows  # noqa: E402

from kvquant_tpu_torch import engine, serve  # noqa: E402
from kvquant_tpu_torch.ops.packing import unpack_codes  # noqa: E402
from kvquant_tpu_torch.utils.profiling import SPANS  # noqa: E402

TINY_V02 = {
    "model_type": "mistral", "hidden_size": 256, "intermediate_size": 384,
    "num_hidden_layers": 2, "num_attention_heads": 16,
    "num_key_value_heads": 4, "max_position_embeddings": 4096,
    "rms_norm_eps": 1e-5, "rope_theta": 1000000.0, "sliding_window": None,
    "tie_word_embeddings": False, "vocab_size": 128,
}
SEED = 2 ** 31 + 11
W = 128  # the sub-width under test
CHUNK = 512  # admit_chunk: S + 512 rows hold every prompt below
MAX_LEN = 1024
# the program and the reference both compute in fp32 over the same
# quantized cache (the same thresholds, codebooks and outlier rule); what
# differs is the order of fp32 sums (GEMM blocking, K1's online softmax
# over tiles against one softmax over all keys), ~1e-6 of a logit's size.
# A quantization code that flipped would move a logit by ~1e-2 here.
LOGIT_ATOL = 2e-4


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    d = tmp_path_factory.mktemp("tiny_v02")
    with open(d / "config.json", "w") as f:
        json.dump(TINY_V02, f)
    m = arith.model_dims(TINY_V02)
    with open(os.path.join(PORTBENCH, "schemes", "nuq3-k1.json")) as f:
        scheme = dict(json.load(f), dot_bf16=False)
    w = make_weights(m, SEED, "cpu", dtype=torch.float32)
    k_up, k_lo = k_thresholds(m, scheme, SEED)
    return dict(path=str(d), m=m, scheme=scheme, w=w, k_up=k_up, k_lo=k_lo)


def _server(tiny, monkeypatch, sub, n_slots=2, admit_chunk=CHUNK):
    monkeypatch.setattr(serve, "ADMIT_SUB_CHUNK", sub)
    t = tiny
    return build_server(t["path"], t["m"], t["scheme"], t["w"], t["k_up"],
                        t["k_lo"], n_slots, MAX_LEN, admit_chunk, "cpu")


def _record_logits(monkeypatch):
    """{rid: [logits each time a token of rid is sampled]}."""
    seen = {}
    sample = serve.Server._sample_with

    def rec(self, req, logits):
        seen.setdefault(req.rid, []).append(np.array(logits, np.float32))
        return sample(self, req, logits)

    monkeypatch.setattr(serve.Server, "_sample_with", rec)
    return seen


def _prompts(lengths, seed=5):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, TINY_V02["vocab_size"], n).astype(np.int32)
            for n in lengths]


# -- (a) the served logits against the plain reference ---------------------

@pytest.mark.parametrize("dot_bf16", [False, True])
def test_sub_chunked_server_serves_the_reference_logits(tiny, monkeypatch,
                                                        dot_bf16):
    """fp32 dots (5e-6 at most here) lie within LOGIT_ATOL; K1's dots in
    bf16, the control, lie outside it (4.6e-2 here)."""
    t = dict(tiny, scheme=dict(tiny["scheme"], dot_bf16=dot_bf16))
    S = t["scheme"]["sink"]
    lengths = (S + 1, S + W, 300, S + CHUNK)  # 1, 1, 3 and 4 sub-chunks
    answers = (3, 5, 4, 6)
    seen = _record_logits(monkeypatch)
    srv = _server(t, monkeypatch, W)
    assert srv.sub_chunk == W
    prompts = _prompts(lengths)
    out = srv.run([serve.Request(rid=i, prompt=p, max_new_tokens=n)
                   for i, (p, n) in enumerate(zip(prompts, answers))])
    ref = Reference(t["m"], t["w"], KVQuant(t["scheme"], t["k_up"],
                                            t["k_lo"], t["m"], "cpu"), S)
    V = TINY_V02["vocab_size"]
    worst = 0.0
    for i, (p, n) in enumerate(zip(prompts, answers)):
        toks = out[i].tokens
        assert len(toks) == n and len(seen[i]) == n
        rows = Rows([np.concatenate([p, np.asarray(toks[:-1], np.int32)])])
        want = np.arange(len(p) - 1, len(p) - 1 + n)
        _, at, arg = ref.run(rows, want, np.tile(np.arange(V), (n, 1)))
        got = np.stack(seen[i])
        worst = max(worst, float(np.abs(got - at).max()))
        if not dot_bf16:
            assert (np.argmax(got, -1) == arg).all()
    assert (worst > LOGIT_ATOL) if dot_bf16 else (worst <= LOGIT_ATOL), worst


# -- (b) sub-chunks against one padded chunk -------------------------------

def _admit_one(tiny, monkeypatch, sub, prompt):
    """The slot cache and first logits of ``prompt`` admitted alone."""
    seen = _record_logits(monkeypatch)
    srv = _server(tiny, monkeypatch, sub, n_slots=1)
    srv.run([serve.Request(rid=0, prompt=prompt, max_new_tokens=1)])
    return srv.cache, seen[0][0], srv.sub_chunk


@pytest.mark.parametrize("T", [300, 5 + CHUNK])
def test_sub_chunks_equal_one_padded_chunk(tiny, monkeypatch, T):
    S, bits = tiny["scheme"]["sink"], tiny["scheme"]["bits"]
    (prompt,) = _prompts([T], seed=T)
    sub, lg_sub, w = _admit_one(tiny, monkeypatch, W, prompt)
    one, lg_one, w1 = _admit_one(tiny, monkeypatch, 1 << 20, prompt)
    assert (w, w1) == (W, CHUNK)
    n = T - S  # packed positions the prompt holds
    for name in ("k_planes", "v_planes"):
        a = unpack_codes(getattr(sub, name)[:, 0], bits)[..., :n, :]
        b = unpack_codes(getattr(one, name)[:, 0], bits)[..., :n, :]
        assert torch.equal(a, b), name
    for name in ("kv_out", "v_scale", "v_offset"):
        a, b = getattr(sub, name)[:, 0], getattr(one, name)[:, 0]
        torch.testing.assert_close(a[..., :n], b[..., :n], rtol=1e-5,
                                   atol=1e-6)
    for name in ("k_sink", "v_sink"):
        torch.testing.assert_close(getattr(sub, name), getattr(one, name),
                                   rtol=1e-5, atol=1e-6)
    assert int(sub.length[0]) == int(one.length[0]) == T
    np.testing.assert_allclose(lg_sub, lg_one, rtol=1e-5, atol=1e-5)


# -- (c) the one-row LM head -----------------------------------------------

@pytest.mark.parametrize("sink_fill", [True, False])
def test_one_row_head_is_that_row_of_the_full_logits(tiny, monkeypatch,
                                                     sink_fill):
    srv = _server(tiny, monkeypatch, W, n_slots=1)
    S = srv.dcfg.sink
    (toks,) = _prompts([S + 2 * W], seed=9)
    toks = torch.as_tensor(toks)[None]
    if sink_fill:
        blk, pos0 = toks[:, :S + W], S
    else:
        blk, pos0 = toks[:, S + W:], S + W
    full = {}
    for row in (None, 0, 7, blk.shape[1] - 1,
                torch.tensor(blk.shape[1] // 2, dtype=torch.int32)):
        adm = serve.AdmissionCache(srv.params, srv.cfg, srv.dcfg, srv.dq,
                                   "cpu")
        adm.start()
        if not sink_fill:  # the later chunk reads the sink chunk's cache
            engine.prefill_chunk(srv.params, srv.cfg, srv.dcfg, srv.dq,
                                 adm.cache, toks[:, :S + W], S, True)
        _, lg = engine.prefill_chunk(srv.params, srv.cfg, srv.dcfg, srv.dq,
                                     adm.cache, blk, pos0, sink_fill, row)
        if row is None:
            full = lg
            assert lg.shape == (1, blk.shape[1], TINY_V02["vocab_size"])
            continue
        assert lg.shape == (1, TINY_V02["vocab_size"])
        torch.testing.assert_close(lg, full[:, int(row)], rtol=1e-6,
                                   atol=1e-6)


# -- (d) the rows and replays an admission records -------------------------

@pytest.mark.parametrize("admit_chunk,sub,n_pack", [
    (CHUNK, W, 1), (CHUNK, W, W - 1), (CHUNK, W, W), (CHUNK, W, W + 1),
    (CHUNK, W, 3 * W), (CHUNK, W, 295), (CHUNK, W, CHUNK),
    (2 * W, W, 600),  # three chunks of 2, 2 and 1 sub-chunks
    (2 * W, 2048, 300),  # the sub-width does not divide: one a chunk
])
def test_admission_records_its_rows_and_replays(tiny, monkeypatch,
                                                admit_chunk, sub, n_pack):
    srv = _server(tiny, monkeypatch, sub, n_slots=1,
                  admit_chunk=admit_chunk)
    S, w = srv.dcfg.sink, srv.sub_chunk
    (prompt,) = _prompts([S + n_pack], seed=n_pack)
    t0 = SPANS.clock()
    srv.run([serve.Request(rid=7, prompt=prompt, max_new_tokens=2)])
    out = SPANS.read(t0, SPANS.clock())
    chunks = [s for s in out["spans"] if s.name == "engine.chunk"]
    n_chunks = -(-n_pack // admit_chunk)
    assert len(chunks) == n_chunks and {s.rid for s in chunks} == {7}
    rows = [r for s in chunks for r in s.rows]
    assert len(rows) == sum(
        -(-min(admit_chunk, n_pack - c * admit_chunk) // w)
        for c in range(n_chunks))
    if admit_chunk % sub == 0:
        assert len(rows) == -(-n_pack // w)
    assert rows[0] == S + w and set(rows[1:]) <= {w}
    assert [len(s.rows) for s in chunks] == [
        -(-min(admit_chunk, n_pack - c * admit_chunk) // w)
        for c in range(n_chunks)]
    assert all(s.rows is None for s in out["spans"]
               if s.name != "engine.chunk")
