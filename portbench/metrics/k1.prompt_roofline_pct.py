"""K1's prompt bound over its fd_chunk time in the traced steps that hold an admission, the bound worked out from the rows the program's replays ran.

The program records, with each ``engine.chunk`` span, the rows of every
replay it wrapped (``Span.rows``, sinks included). For a traced step that
ran an admission chunk, those replays lie back to back from the chunk's
first row: replay i runs rows at positions first_i .. first_i + rows_i - 1,
each over the keys up to its own position. The bound of each is
``arith.k1_chunk_bound`` at the card's peaks; their sum over the traced
steps is divided by the fd_chunk (and its fd_merge) time of those steps.
A program that records no rows (no ``rows`` on its spans) gives None.
"""

from pbench import arith, program_spans


def chunk_rows(rec, st):
    """The rows of each replay of step ``st``'s admission chunk, as the
    program recorded them, or None."""
    got = [getattr(s, "rows", None) for s in rec.read(st.t0, st.t1)["spans"]
           if s.name == "engine.chunk" and s.rid == st.chunk.rid]
    return got[0] if len(got) == 1 else None


def read(run):
    rec = program_spans.recorder()
    if rec is None or not hasattr(rec, "read"):
        return None
    bound = t = 0.0
    for g in run.groups:
        t += g.k1.get("fd_chunk", 0.0)
        for st in g.steps:
            if st.chunk is None:
                continue
            rows = chunk_rows(rec, st)
            if not rows:
                return None
            first = st.chunk.lo
            for n in rows:
                bound += arith.roofline_seconds(*arith.k1_chunk_bound(
                    run.m, run.scheme, first, n))
                first += n
    return 100.0 * bound / t if t and bound else None
