"""Whether what the timed path served is correct: the plain reference run
once over the judged requests' prompts and served tokens, teacher-forced,
and the widest gap by which a served token's logit lies below the
reference's best at its position (0 where the token is the reference's
own first choice). Greedy tokens only; every request of the traffic is
greedy.

A dense model's requests do not touch each other in the program, so the
reference runs only the judged sequences. DBRX's capacity rule makes a
token's experts depend on the other tokens of its call, so there the
reference replays every call the record holds, from the first step of the
run, in the program's arrival order: each admission chunk's prompt rows
and each decode step's rows of every slot, the junk decode of a slot whose
request is done or that was never admitted included. This follows the
program's schedule (which request sat in which slot at which step), read
from its host state between steps; the numbers are the reference's own.
"""

from __future__ import annotations

import numpy as np

from reference.model import KVQuant, Reference, Rows


def served(rec, rid: int) -> np.ndarray:
    return rec.tokens(rid)[:rec.reqs[rid].answer]


def pick(rec, seed: int, n: int) -> list[int]:
    """The finished requests to judge: the one with the most served
    tokens, and ``n - 1`` others drawn from the seed."""
    done = sorted(r for r, log in rec.reqs.items() if log.finished)
    if not done:
        return []
    longest = max(done, key=lambda r: (rec.reqs[r].answer, -r))
    rest = [r for r in done if r != longest]
    rng = np.random.default_rng([seed, 3])
    extra = rng.choice(len(rest), size=min(n - 1, len(rest)), replace=False)
    return [longest] + sorted(rest[i] for i in extra)


def dense_rows(rec, rids: list[int]) -> tuple[Rows, dict]:
    """Each judged request's prompt and served tokens but the last."""
    seqs, where = [], {}
    for i, r in enumerate(rids):
        seqs.append(np.concatenate([rec.reqs[r].prompt, served(rec, r)[:-1]]))
        where[r] = i
    return Rows(seqs), where


def replay_rows(rec, rids: list[int]) -> tuple[Rows, dict]:
    """Every row the program ran up to the last step that holds a row of
    ``rids``, with its calls (see the module docstring). Raises where the
    record does not cover each sequence's rows exactly once."""
    last = max(i for i, st in enumerate(rec.steps)
               if (st.chunk is not None and st.chunk.rid in rids)
               or (st.decoded and np.isin(st.rid[st.active], rids).any()))
    steps = rec.steps[:last + 1]
    order, seen = [], {}
    for st in steps:
        if st.chunk is not None and st.chunk.rid not in seen:
            seen[st.chunk.rid] = len(order)
            order.append(st.chunk.rid)
    n_rows = {r: 0 for r in order}
    for st in steps:
        if st.chunk is not None:
            n_rows[st.chunk.rid] = max(n_rows[st.chunk.rid], st.chunk.hi)
        if st.decoded:
            for b in np.nonzero(st.active)[0]:
                r = int(st.rid[b])
                n_rows[r] = max(n_rows[r], int(st.pos[b]) + 1)
    seqs = [np.concatenate([rec.reqs[r].prompt, served(rec, r)])[:n_rows[r]]
            for r in order]
    rows = Rows(seqs)
    cover = [np.zeros(n_rows[r], np.int64) for r in order]
    junk, calls = [], []
    for st in steps:
        if st.chunk is not None:
            c = st.chunk
            i = seen[c.rid]
            ids = np.arange(rows.row(i, c.lo), rows.row(i, c.hi))
            cover[i][c.lo:c.hi] += 1
            calls.append((ids, c.n_rows))
        if st.decoded:
            ids = []
            for b in range(len(st.rid)):
                r, p = int(st.rid[b]), int(st.pos[b])
                if st.active[b]:
                    i = seen[r]
                    ids.append(rows.row(i, p))
                    cover[i][p] += 1
                else:
                    i = seen[r] if r >= 0 else -1
                    if i >= 0 and p != n_rows[r]:
                        raise RuntimeError(f"slot {b} decodes request {r}'s "
                                           f"junk at {p}, not past its "
                                           f"{n_rows[r]} rows")
                    junk.append((i, p, int(st.tok[b])))
                    ids.append(-len(junk))  # fixed below
            calls.append((np.asarray(ids, np.int64), len(st.rid)))
    for i, c in enumerate(cover):
        if not (c == 1).all():
            raise RuntimeError(f"request {order[i]}'s rows are covered "
                               f"{c.min()}..{c.max()} times by the record")
    rows = Rows(seqs, junk)
    fixed = []
    for ids, n in calls:
        ids = np.where(ids < 0, rows.n_real - ids - 1, ids)
        fixed.append((ids, n))
    rows.calls = fixed
    return rows, seen


def reference_for(m, scheme, w, k_up, k_lo, low=False) -> Reference:
    dev = w["embed"].device
    return Reference(m, w, KVQuant(scheme, k_up, k_lo, m, dev),
                     scheme["sink"], low=low)


def gaps(best, at, arg, cols) -> dict:
    """The numbers a cell's limits may name, for the tokens ``cols`` whose
    logits the reference gave as ``at``: ``gap`` (the widest), its mean
    and 90th percentile, and the share of tokens that are the reference's
    own first choice."""
    g = best - at
    return dict(gap=float(g.max()), gap_mean=float(g.mean()),
                gap_p90=float(np.percentile(g, 90)),
                agree=float((arg == cols).mean()))


def judge(rec, m, scheme, w, k_up, k_lo, seed: int, n_judge: int,
          control: bool = False) -> dict:
    """The gaps of the judged requests' served tokens (``gaps``); with
    ``control`` also the fp8 control's, put in the program's place at the
    same positions: its first choices judged the same way (``control``,
    the same keys)."""
    rids = pick(rec, seed, n_judge)
    if not rids:
        return dict(requests=0, tokens=0, gap=None)
    rows, where = (replay_rows(rec, rids) if m["family"] == "dbrx"
                   else dense_rows(rec, rids))
    want, cols = [], []
    for r in rids:
        T0, toks = len(rec.reqs[r].prompt), served(rec, r)
        want.extend(rows.row(where[r], T0 - 1 + i) for i in range(len(toks)))
        cols.extend(toks)
    want, cols = np.asarray(want), np.asarray(cols)[:, None]
    out = dict(requests=len(rids), tokens=int(len(want)))
    if control:
        ref = reference_for(m, scheme, w, k_up, k_lo, low=True)
        _, _, ctrl = ref.run(rows, want, cols)
        cols = np.concatenate([cols, ctrl[:, None]], 1)
    ref = reference_for(m, scheme, w, k_up, k_lo)
    best, at, arg = ref.run(rows, want, cols)
    out.update(gaps(best, at[:, 0], arg, cols[:, 0]),
               rows=rows.n_real + len(rows.junk), dropped=ref.dropped)
    if control:
        out["control"] = gaps(best, at[:, 1], arg, cols[:, 1])
    return out
