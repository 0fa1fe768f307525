"""Per-layer quantities that the program records itself: the spans of
``kvquant_tpu_torch.serve.Server`` in the port's process-wide recorder
(``kvquant_tpu_torch.utils.profiling.SPANS``, on the host clock the
harness runs on), read over the untraced part of the window [``run.t0``,
``run.t1``). A program without the recorder, one that recorded nothing
there, or one whose ring no longer holds the whole interval gives None.
The program is imported only when a reader runs."""

from __future__ import annotations


def recorder():
    """The program's span recorder, or None where it has none."""
    try:
        from kvquant_tpu_torch.utils import profiling
    except ImportError:
        return None
    return getattr(profiling, "SPANS", None)


def summary(run, rec=None):
    """The recorder's ``read`` over [run.t0, run.t1), or None."""
    rec = rec or recorder()
    if rec is None or not hasattr(rec, "read"):
        return None
    out = rec.read(run.t0, run.t1)
    if not out["spans"] or not out["summary"]["complete"]:
        return None
    return out


def host_gap_pct(run, rec=None):
    """The host gaps' time (blocking read to the next reset, slot write or
    launch, inside and between steps) over the interval's wall, in %."""
    out = summary(run, rec)
    return None if out is None else out["summary"]["host_gap"]["pct"]


def replay_ms(run, name: str, rec=None):
    """The median device time (CUDA events) of the spans ``name``, in
    ms."""
    out = summary(run, rec)
    if out is None:
        return None
    e = out["summary"]["by_name"].get(name, {})
    return e["device_median_s"] * 1e3 if e.get("device_n") else None
