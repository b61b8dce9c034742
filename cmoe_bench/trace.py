"""What the traced run reads from ``torch.profiler``: the device's busy
intervals, the time of each device operation, and the benchmark's own
spans (``torch.profiler.record_function("cmoe.<name>")``), all on the
profiler's one clock.

:func:`summarize` turns the profiler's events into a :class:`Trace`;
the per-layer readers and the ``breakdown`` read only that.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field

SPAN_PREFIX = "cmoe."


@dataclass
class Trace:
    """Device intervals (start_ns, end_ns), merged and sorted; device time
    per operation name (s); the benchmark's spans (name, start_ns,
    end_ns); the traced window (start_ns, end_ns)."""

    busy: list
    op_seconds: dict
    spans: list
    window: tuple
    idle_by_span: dict = field(default_factory=dict)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-9

    @property
    def busy_s(self) -> float:
        return busy_within(self.busy, *self.window)

    def busy_in_spans(self, name: str) -> float:
        """Device-busy seconds inside the spans called ``name``."""
        return sum(busy_within(self.busy, a, b)
                   for n, a, b in self.spans if n == name)


def merge(intervals) -> list:
    """Sorted, non-overlapping union of (start, end) intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return [tuple(x) for x in out]


def busy_within(busy: list, lo: int, hi: int) -> float:
    """Seconds of the merged intervals ``busy`` inside [lo, hi] (ns)."""
    total = 0
    for a, b in busy:
        if b <= lo or a >= hi:
            continue
        total += min(b, hi) - max(a, lo)
    return total * 1e-9


def idle_gaps(busy: list, lo: int, hi: int) -> list:
    """(start, end) of the stretches of [lo, hi] with no device
    operation."""
    gaps, t = [], lo
    for a, b in busy:
        if b <= lo:
            continue
        if a >= hi:
            break
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if t < hi:
        gaps.append((t, hi))
    return gaps


def label_gaps(gaps: list, spans: list, window_name: str) -> dict:
    """Idle seconds by the innermost benchmark span open at each gap's
    start (the window's own span where no other is open)."""
    out = defaultdict(float)
    for a, b in gaps:
        best = None
        for n, s, e in spans:
            if n != window_name and s <= a < e and (
                    best is None or s >= best[1]):
                best = (n, s)
        out[best[0] if best else window_name] += (b - a) * 1e-9
    return dict(out)


def summarize(events, window_name: str = "window") -> Trace:
    """A :class:`Trace` from profiler events, each with ``name``,
    ``device`` ("cuda" or "cpu"), ``start_ns`` and ``end_ns``; the window
    is the span ``window_name``.  The profiler mirrors each span on the
    device's timeline as an annotation: those are no device work."""
    intervals, ops, spans = [], defaultdict(float), []
    for ev in events:
        ours = ev["name"].startswith(SPAN_PREFIX)
        if ev["device"] == "cuda" and not ours:
            intervals.append((ev["start_ns"], ev["end_ns"]))
            ops[ev["name"]] += (ev["end_ns"] - ev["start_ns"]) * 1e-9
        elif ev["device"] == "cpu" and ours:
            spans.append((ev["name"][len(SPAN_PREFIX):], ev["start_ns"],
                          ev["end_ns"]))
    windows = [(s, e) for n, s, e in spans if n == window_name]
    if not windows:
        raise ValueError(f"the trace holds no span {window_name!r}")
    window = windows[0]
    busy = merge(intervals)
    trace = Trace(busy=busy, op_seconds=dict(ops), spans=spans,
                  window=window)
    trace.idle_by_span = label_gaps(idle_gaps(busy, *window), spans,
                                    window_name)
    return trace


def profiler_events(prof) -> list:
    """The events of a finished ``torch.profiler.profile`` as
    :func:`summarize` takes them."""
    from torch.autograd import DeviceType
    out = []
    for ev in prof.profiler.kineto_results.events():
        start = ev.start_ns()
        out.append({"name": ev.name(), "start_ns": start,
                    "end_ns": start + ev.duration_ns(),
                    "device": "cuda" if ev.device_type() == DeviceType.CUDA
                    else "cpu"})
    return out


def breakdown(trace: Trace, top: int = 10, width: int = 120) -> dict:
    """The device operations that took most time (names cut to ``width``
    characters) and the idle time by the span open on the host, each as
    [name, seconds], at most ``top``."""
    ops = sorted(trace.op_seconds.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(trace.idle_by_span.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n[:width], s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in gaps]}
