"""The device timeline of a traced window, from ``torch.profiler`` (CUPTI).

Only the device activity is traced (the host's operator events cost seconds
a window and move the host's times): every kernel, copy and set on the card
with its start and end. From them: the busy seconds (the union of the
intervals), time by kernel name, and the idle gaps, each named by the
harness's innermost span open where the gap begins (the host's clock and the
trace's are matched where one of them brackets every device event; otherwise
a gap is named by the kernel before it).
"""

from __future__ import annotations

import dataclasses
import time
import typing as tp

import torch


@dataclasses.dataclass
class DeviceEvent:
    name: str
    start_ns: int
    end_ns: int


def _ns(ev, what: str) -> int:
    f = getattr(ev, f"{what}_ns", None)
    if f is not None:
        return int(f())
    return int(getattr(ev, f"{what}_us")() * 1000)


def kernel_name(name: str) -> str:
    """A kernel's function name without return type, namespaces, template
    arguments and parameters: ``void (anonymous namespace)::k<2>(int)`` ->
    ``k``."""
    n = name.replace("(anonymous namespace)::", "").strip()
    if n.startswith("void "):
        n = n[len("void "):]
    cut = min([i for i in (n.find("("), n.find("<")) if i >= 0], default=len(n))
    head = n[:cut].strip()
    return head.split(" ")[-1].split("::")[-1] if head else name


class TraceWindow:
    """``with TraceWindow() as tw:`` around the window; then ``tw.events``."""

    def __enter__(self) -> "TraceWindow":
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        self.mono0, self.real0 = time.perf_counter_ns(), time.time_ns()
        return self

    def __exit__(self, *exc) -> None:
        torch.cuda.synchronize()
        self.mono1, self.real1 = time.perf_counter_ns(), time.time_ns()
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self.events = self._device_events()

    def _device_events(self) -> tp.List[DeviceEvent]:
        from torch.autograd import DeviceType

        out = []
        for ev in self._prof.profiler.kineto_results.events():
            if ev.device_type() != DeviceType.CUDA:
                continue
            start = _ns(ev, "start")
            dur = _ns(ev, "duration")
            if dur > 0:
                out.append(DeviceEvent(ev.name(), start, start + dur))
        out.sort(key=lambda e: e.start_ns)
        return out

    def host_offset_ns(self) -> tp.Optional[int]:
        """What to add to a ``perf_counter_ns`` time to place it on the
        trace's clock, or None where neither host clock brackets the trace."""
        if not self.events:
            return None
        lo, hi = self.events[0].start_ns, max(e.end_ns for e in self.events)
        slack = 2_000_000
        if self.mono0 - slack <= lo and hi <= self.mono1 + slack:
            return 0
        if self.real0 - slack <= lo and hi <= self.real1 + slack:
            return self.real0 - self.mono0
        return None


def busy_ns(events: tp.Sequence[DeviceEvent]) -> int:
    total, end = 0, None
    for e in events:
        if end is None or e.start_ns >= end:
            total += e.end_ns - e.start_ns
            end = e.end_ns
        elif e.end_ns > end:
            total += e.end_ns - end
            end = e.end_ns
    return total


def by_kernel(events: tp.Sequence[DeviceEvent]) -> tp.Dict[str, tp.Tuple[int, float]]:
    """kernel name -> (launches, seconds)."""
    out: tp.Dict[str, tp.Tuple[int, float]] = {}
    for e in events:
        k = kernel_name(e.name)
        n, s = out.get(k, (0, 0.0))
        out[k] = (n + 1, s + (e.end_ns - e.start_ns) / 1e9)
    return out


def idle_gaps(events: tp.Sequence[DeviceEvent], spans: tp.Sequence[tp.Tuple[str, int, int]],
              offset_ns: tp.Optional[int], top: int = 10) -> tp.List[tp.List]:
    """The ``top`` longest gaps with no device activity, ``[label, seconds]``;
    the label is the innermost harness span open at the gap's start (on the
    trace's clock), else the kernel the gap follows."""
    gaps = []
    end, last = None, None
    for e in events:
        if end is not None and e.start_ns > end:
            gaps.append((e.start_ns - end, end, last))
        if end is None or e.end_ns > end:
            end, last = e.end_ns, e.name
    gaps.sort(key=lambda g: -g[0])
    out = []
    for length, at, before in gaps[:top]:
        label = None
        if offset_ns is not None:
            inside = [(s1 - s0, name) for name, s0, s1 in spans
                      if s0 + offset_ns <= at < s1 + offset_ns]
            if inside:
                label = f"host in {min(inside)[1]}"
        out.append([label or f"after {kernel_name(before)}", length / 1e9])
    return out
