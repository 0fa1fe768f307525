"""Port of the CLIs and what they stand on (kvquant_tpu_torch/cli,
evals, utils/toytokenizer.py, baseline_fp16.py) against the JAX package:

  - the word tokenizer encodes and decodes as JAX's does;
  - passkey and needle prompts are identical to JAX's for the same
    arguments; the eval harnesses score an oracle retriever perfectly and
    the needle grid resumes from its JSON (tests/test_evals.py's cases);
  - baseline_fp16 prefill + 8 decode steps match the JAX baseline at fp32
    tolerance on the same weights (params_from_numpy);
  - cli.generate / cli.passkey / cli.needle run end to end on the CPU with
    --kernel pallas (the default) at the committed toy quantizers' widths;
  - cli.serve_demo serves every request its budget on the CPU, from the
    page pool (--paged) and from the slot pool;
  - cli.calibrate writes an artifact the JAX package loads (uniform with
    roped keys; k-means with Fisher weights), and cli.eval_ppl scores it
    simulated and deployed through K1's plain version;
  - every option of the JAX CLIs' --help is an option of the port's
    (cli.fisher and cli.deploy included).
"""

import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kvquant_tpu import baseline_fp16 as jbase
from kvquant_tpu.evals import needle as jneedle, passkey as jpasskey
from kvquant_tpu.models import TINY_GQA as J_GQA, init_params as jinit
from kvquant_tpu.utils.toytokenizer import WordTokenizer as JTok

from kvquant_tpu_torch import baseline_fp16 as tbase
from kvquant_tpu_torch.evals.needle import (NeedleHaystackTester,
                                            accuracy_grid,
                                            build_needle_prompt)
from kvquant_tpu_torch.evals.passkey import build_passkey_prompt, eval_passkey
from kvquant_tpu_torch.models import TINY_GQA, params_from_numpy
from kvquant_tpu_torch.utils.toytokenizer import WordTokenizer

torch.set_num_threads(1)

ART = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "artifacts")
TOY = ["--toy-layers", "4", "--toy-dmodel", "256", "--toy-heads", "8",
       "--toy-kv-heads", "4", "--toy-vocab", "512", "--device", "cpu",
       "--kernel", "pallas",
       "--quantizers", os.path.join(ART, "toy_quantizers_3bit.npz")]


def test_tokenizer_matches_jax():
    text = ("The pass key is 12345 . the sky was clear and The sky was "
            "clear ; 12345 ends")
    t, j = WordTokenizer(), JTok()
    assert t.encode(text) == j.encode(text)
    assert t.encode("new words then the sky") == j.encode(
        "new words then the sky")
    ids = [0, 3, 999, -1, 7]
    assert t.decode(ids) == j.decode(ids)
    assert t.vocab_size == j.vocab_size


@pytest.mark.parametrize("depth", [0.0, 0.37, 1.0])
def test_prompts_match_jax(depth):
    t, j = WordTokenizer(), JTok()
    ids, ans = build_passkey_prompt(t, 512, 48213, depth)
    jids, jans = jpasskey.build_passkey_prompt(j, 512, 48213, depth)
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_array_equal(ans, jans)
    nid = build_needle_prompt(t, 512, depth * 100, "black garlic")
    jnid = jneedle.build_needle_prompt(j, 512, depth * 100, "black garlic")
    np.testing.assert_array_equal(nid, jnid)
    assert t.decode(list(nid)) == j.decode(list(jnid))


def oracle_generate(tok):
    """Answers by scanning its own prompt for the marker phrase (retrieval
    made perfect, so harness accuracy must be 1.0)."""

    def fn(prompt_ids, max_new_tokens):
        words = tok.decode([int(t) for t in prompt_ids.reshape(-1)]).split()
        for i, w in enumerate(words):
            if w == "is" and i + 1 < len(words) and any(
                    ch.isdigit() for ch in words[i + 1]):
                return np.asarray(tok.encode(words[i + 1] + " end")
                                  [:max_new_tokens])
        for i in range(len(words) - 1):
            if words[i] == "recipe" and words[i + 1] == "is":
                ans = " ".join(words[i + 2:i + 4])
                return np.asarray(tok.encode(ans)[:max_new_tokens])
        return np.zeros(max_new_tokens, np.int32)

    return fn


def test_passkey_oracle_gets_perfect_accuracy():
    tok = WordTokenizer()
    res = eval_passkey(oracle_generate(tok), tok, ctx_lengths=(256, 512),
                       n_trials=5, verbose=False)
    assert [r.accuracy for r in res] == [1.0, 1.0]


def test_needle_grid_and_resume(tmp_path):
    tok = WordTokenizer()
    path = str(tmp_path / "results.json")
    kw = dict(context_lengths=(256, 512), depth_percents=(0, 50, 100),
              rounds=1, results_path=path, verbose=False)
    trials = NeedleHaystackTester(oracle_generate(tok), tok, **kw).run()
    assert len(trials) == 6
    assert all(v == 1.0 for v in accuracy_grid(trials).values())
    with open(path) as f:
        before = json.load(f)
    calls = {"n": 0}
    orig = oracle_generate(tok)

    def counting(prompt_ids, m):
        calls["n"] += 1
        return orig(prompt_ids, m)

    trials2 = NeedleHaystackTester(counting, tok, **kw).run()
    assert calls["n"] == 0 and len(trials2) == len(before)


def test_baseline_fp16_matches_jax():
    """fp32 weights and an fp32 cache: prefill of 12 tokens at B=2 and 8
    decode steps; logits within atol 1e-4 / rtol 1e-4, the caches within
    1e-5."""
    params = jinit(jax.random.PRNGKey(3), J_GQA, dtype=jnp.float32)
    tp = params_from_numpy(jax.tree.map(np.asarray, params), TINY_GQA,
                           device="cpu")
    toks = np.random.default_rng(4).integers(0, J_GQA.vocab_size, (2, 20),
                                             dtype=np.int32)
    jc = jbase.create_fp16_cache(J_GQA, 24, 2, dtype=jnp.float32)
    tc = tbase.create_fp16_cache(TINY_GQA, 24, 2, dtype=torch.float32,
                                 device="cpu")
    jc, jl = jbase.prefill(params, J_GQA, jc, jnp.asarray(toks[:, :12]))
    tc, tl = tbase.prefill(tp, TINY_GQA, tc, torch.as_tensor(toks[:, :12]))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=1e-4)
    for pos in range(12, 20):
        jc, jl = jbase.decode_step(params, J_GQA, jc,
                                   jnp.asarray(toks[:, pos]), pos)
        tc, tl = tbase.decode_step(tp, TINY_GQA, tc,
                                   torch.as_tensor(toks[:, pos]), pos)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                                   rtol=1e-4, err_msg=f"pos {pos}")
    for name in ("k", "v"):
        np.testing.assert_allclose(getattr(tc, name).numpy(),
                                   np.asarray(getattr(jc, name)), atol=1e-5,
                                   rtol=1e-5, err_msg=name)
    assert tc.length.tolist() == np.asarray(jc.length).tolist() == [20, 20]


def test_cli_generate_runs_pallas(capsys):
    from kvquant_tpu_torch.cli import generate

    for mode in ("fp16", "quantized"):
        text = generate.main(TOY + ["--prompt", "a b c d e f g h i j k l",
                                    "--max-new-tokens", "4",
                                    "--prefill-mode", mode])
        assert len(text.split()) == 4
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 2 and all(out)


def test_cli_passkey_and_needle_run_pallas(tmp_path, capsys):
    from kvquant_tpu_torch.cli import needle, passkey

    res = passkey.main(TOY + ["--ctx", "256", "--trials", "1"])
    assert [(r.ctx_tokens, r.n_trials) for r in res] == [(256, 1)]
    grid = needle.main(TOY + ["--ctx", "256", "--depths", "0,100",
                              "--results", str(tmp_path / "n.json")])
    assert sorted(grid) == [(256, 0.0), (256, 100.0)]
    out = capsys.readouterr().out
    assert "ctx 256: accuracy" in out and "ctx 256 depth" in out


def test_cli_passkey_fp16_baseline_and_refusals():
    from kvquant_tpu_torch.cli import generate, passkey

    base = [a for a in TOY if not a.endswith(".npz") and a != "--quantizers"]
    res = passkey.main(base + ["--ctx", "256", "--trials", "1"])
    assert res[0].n_trials == 1
    # --model reads DIR/config.json; --moe runs (tests/test_torch_moe_engine.py)
    with pytest.raises(FileNotFoundError, match="config.json"):
        generate.main(TOY + ["--model", "/nonexistent"])


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "slots"])
def test_cli_serve_demo_runs(paged, capsys):
    from kvquant_tpu_torch.cli import serve_demo

    argv = [a for a in TOY if a not in ("--kernel", "pallas")] + [
        "--slots", "2", "--requests", "3", "--prompt-len", "40",
        "--max-new-tokens", "8", "--page-tokens", "256"]
    comps = serve_demo.main(argv + (["--paged"] if paged else []))
    rng = np.random.default_rng(0)  # the CLI's request draws
    budgets = []
    for _ in range(3):
        rng.integers(0, 512, size=int(40 * rng.uniform(0.5, 1.0)))
        budgets.append(int(8 * rng.uniform(0.5, 1.0)))
    assert [len(comps[i].tokens) for i in range(3)] == budgets
    out = capsys.readouterr().out
    assert ("paged pool: 2 pages x 256 tok" in out) == paged
    assert "served 3 requests" in out


def _options(main, capsys):
    with pytest.raises(SystemExit):
        main(["--help"])
    return set(re.findall(r"(?<![\w-])--[a-z][a-z0-9-]*",
                          capsys.readouterr().out))


SMALL = ["--toy-layers", "2", "--toy-dmodel", "64", "--toy-heads", "4",
         "--toy-kv-heads", "2", "--toy-vocab", "128", "--device", "cpu",
         "--nsamples", "2", "--seqlen", "64"]


@pytest.mark.parametrize("mode", ["uniform-post", "nuq-fisher"])
def test_cli_calibrate_then_eval_ppl(mode, tmp_path, capsys):
    """cli.calibrate writes an artifact the JAX package reads; cli.eval_ppl
    scores it simulated and deployed (--kernel flash: K1's plain version
    here)."""
    from kvquant_tpu.quant.artifacts import load_quantizers as jload
    from kvquant_tpu_torch.cli import calibrate, eval_ppl

    out = str(tmp_path / "q.npz")
    argv = SMALL + ["--abits", "2", "--output", out]
    if mode == "uniform-post":
        argv += ["--mode", "uniform", "--post-rope-k"]
    else:
        fisher = str(tmp_path / "f.npz")
        rng = np.random.default_rng(0)
        np.savez(fisher, fisher_k=rng.random((2, 128, 32), np.float32),
                 fisher_v=rng.random((2, 128, 32), np.float32))
        argv += ["--mode", "nuq", "--kmeans-iters", "5", "--fisher", fisher]
    qs = calibrate.main(argv)
    back = jload(out)
    assert back.bits == qs.bits == 2 and len(back.layers) == 2
    assert back.meta["post_rope_k"] == (mode == "uniform-post")
    for a, b in zip(back.layers, qs.layers):
        np.testing.assert_array_equal(a.k.lut, b.k.lut)
        np.testing.assert_array_equal(a.k.upper, b.k.upper)

    ppl, dep = eval_ppl.main(SMALL + ["--quantizers", out, "--deployed",
                                      "--kernel", "flash", "--max-windows",
                                      "2"])
    fp16, none = eval_ppl.main(SMALL + ["--max-windows", "2"])
    assert none is None and np.isfinite([ppl, dep, fp16]).all()
    assert abs(np.log(ppl) - np.log(fp16)) < 0.5, (ppl, fp16)
    assert abs(np.log(dep) - np.log(ppl)) < 0.5, (dep, ppl)
    text = capsys.readouterr().out
    assert "saved 2-layer 2-bit quantizers" in text
    assert "quantized ppl over 2x64 tokens" in text
    assert "deployed ppl (first window, kernel=flash)" in text
    assert "fp16 ppl over 2x64 tokens" in text


@pytest.mark.parametrize("name", ["generate", "passkey", "needle",
                                  "serve_demo", "eval_ppl", "calibrate",
                                  "fisher", "deploy"])
def test_cli_options_cover_jax(name, capsys):
    import importlib

    jmain = importlib.import_module(f"kvquant_tpu.cli.{name}").main
    tmain = importlib.import_module(f"kvquant_tpu_torch.cli.{name}").main
    want, got = _options(jmain, capsys), _options(tmain, capsys)
    assert want and want <= got, want - got
    assert "--device" in got
