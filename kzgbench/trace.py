"""Reading torch.profiler's trace of the traced calls.

The profile is exported as a Chrome trace under the run's temporary
directory, read and deleted. Device events (kernels, copies, sets) are
counted once each, as the profiler's own table counts them; GPU annotations
(a span's shadow on the device) are not device work. A device event belongs
to the host scope that launched it through its correlation id.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("user_annotation", "cpu_op", "cuda_runtime", "cuda_driver")
CALL_SPAN = "kzgbench/call"


def union_seconds(intervals, lo: float, hi: float) -> float:
    """Length of the union of [start, end) intervals clipped to [lo, hi)."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals if e > lo and s < hi):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    """The stretches of [lo, hi) that no interval covers."""
    out, t = [], lo
    for s, e in sorted(intervals):
        if e <= t:
            continue
        if s > t:
            out.append((t, min(s, hi)))
        t = max(t, e)
        if t >= hi:
            break
    if t < hi:
        out.append((t, hi))
    return [(a, b) for a, b in out if b > a]


class Trace:
    """Times in seconds on the trace's clock."""

    def __init__(self, events: list[dict]):
        self.device, self.host, self.calls = [], [], []
        launch_at = {}
        for ev in events:
            if ev.get("ph") != "X":
                continue
            cat, name = ev.get("cat", ""), ev.get("name", "")
            s = ev["ts"] / 1e6
            e = s + ev.get("dur", 0) / 1e6
            corr = (ev.get("args") or {}).get("correlation")
            if cat in DEVICE_CATS:
                self.device.append((name, s, e, corr))
            elif cat in HOST_CATS:
                self.host.append((name, s, e))
                if name == CALL_SPAN:
                    self.calls.append((s, e))
                if cat in ("cuda_runtime", "cuda_driver") and corr is not None:
                    launch_at[corr] = s
        self.calls.sort()
        self.launch_at = launch_at
        self.window = (self.calls[0][0], self.calls[-1][1]) if self.calls else (0.0, 0.0)

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def busy_s(self, lo=None, hi=None) -> float:
        lo = self.window[0] if lo is None else lo
        hi = self.window[1] if hi is None else hi
        return union_seconds([(s, e) for _, s, e, _ in self.device], lo, hi)

    def device_s_by_name(self) -> dict[str, float]:
        out = {}
        for name, s, e, _ in self.device:
            out[name] = out.get(name, 0.0) + (e - s)
        return out

    def device_s_under(self, span: str) -> float:
        """Device seconds of the events launched inside a host scope named `span`."""
        scopes = sorted((s, e) for name, s, e in self.host if name == span)
        total = 0.0
        for _, s, e, corr in self.device:
            t = self.launch_at.get(corr)
            if t is not None and any(a <= t <= b for a, b in scopes):
                total += e - s
        return total

    def innermost_host(self, t: float) -> str:
        best = None
        for name, s, e in self.host:
            if s <= t <= e and (best is None or e - s < best[1]):
                best = (name, e - s)
        return best[0] if best else "none"

    def idle_gaps(self, top: int = 10) -> list[list]:
        lo, hi = self.window
        found = sorted(gaps([(s, e) for _, s, e, _ in self.device], lo, hi), key=lambda g: g[0] - g[1])[:top]
        return [[self.innermost_host((a + b) / 2), b - a] for a, b in found]


def profile(torch, drive) -> Trace:
    """Run `drive(scope)` under torch.profiler, where `scope()` opens the span
    CALL_SPAN that each call runs in; the trace goes to a directory under
    TMPDIR that is deleted once read."""
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        drive(lambda: record_function(CALL_SPAN))
        torch.cuda.synchronize()
    tmp = tempfile.mkdtemp(prefix="kzgbench-trace-")
    try:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return Trace(events)
