"""What the metric readers share: per-call figures of the traced calls and
kernels' roofline shares."""

from kzgbench import peaks, registry


def traced_calls(run) -> int:
    return len(run.trace.calls) if run.trace is not None else 0


def per_call_ms(run, seconds: float):
    n = traced_calls(run)
    return seconds / n * 1e3 if n else None


def roofline(run, kernel: str):
    """The least time the call's `kernel` work needs (larger of operations
    over the IMAD peak and bytes over HBM bandwidth) over the kernel's
    device time a call, in %. None where the call runs no such work or the
    trace holds no event of the kernel."""
    w = registry.module("work", kernel, run.root).work(run.shapes)
    n = traced_calls(run)
    spent = run.kernel_s.get(kernel, 0.0)
    if w is None or not n or spent <= 0:
        return None
    least, _ = peaks.least_seconds(*w)
    return 100.0 * least / (spent / n)
