"""The program's own spans and counters, as the per-layer metrics read them
after a traced window: ``summer_clip_torch.core.profiling`` records while the
window's ``torch.profiler`` session is open, and only then.

:func:`recorded` is None where the window was not traced (``busy_s <= 0``) or
where the program has no recorder (a tree from before it), so a metric that
reads it finds nothing there and reads None."""

from __future__ import annotations

import typing as tp


def recorded(r):
    """The program's record (``profiling.Recorded``) after a traced window,
    else None."""
    if r.busy_s <= 0:
        return None
    from summer_clip_torch.core import profiling

    read = getattr(profiling, "recorded", None)
    return read() if read is not None else None


def seconds(rec, name: str) -> tp.List[float]:
    """The durations of the closed spans called ``name``."""
    return [(t1 - t0) / 1e9 for n, t0, t1 in rec.items if n == name and t1]


def self_seconds(rec, name: str, child: str) -> tp.List[float]:
    """Each closed span called ``name`` less the spans called ``child`` that
    it encloses directly."""
    inside: tp.Dict[int, float] = {}
    for (n, t0, t1), parent in zip(rec.items, rec.parents):
        if n == child and parent >= 0 and t1:
            inside[parent] = inside.get(parent, 0.0) + (t1 - t0) / 1e9
    return [(t1 - t0) / 1e9 - inside.get(i, 0.0)
            for i, (n, t0, t1) in enumerate(rec.items) if n == name and t1]


def device_seconds_under(rec, name: str, ancestor: str) -> tp.Optional[tp.List[float]]:
    """The device seconds of the spans called ``name`` inside a span called
    ``ancestor``; None where one of them has no device time."""
    out = []
    for i, (n, _, _) in enumerate(rec.items):
        if n != name:
            continue
        p = rec.parents[i]
        while p >= 0 and rec.items[p][0] != ancestor:
            p = rec.parents[p]
        if p < 0:
            continue
        if rec.device_ms[i] is None:
            return None
        out.append(rec.device_ms[i] / 1e3)
    return out
