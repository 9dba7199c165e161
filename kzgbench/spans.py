"""What the readers of the program's stage spans share.

The port opens a span (a `record_function` event, on the clock of the
device events) around each stage of its three PeerDAS calls
(rust_eth_kzg_tpu_torch/utils/tracing.py). The host ms of a span is the
`host_ms_per_call` reading restricted to the span: over the traced calls,
the span's wall less the device busy time inside it, a call. It is the
device-idle time the stage accounts for.
"""

from __future__ import annotations

from kzgbench.readers import per_call_ms

# the spans the host_ms.* metrics read: stages that never overlap, each
# inside its call
HOST_STAGES = ("das/blob_codec", "das/cells_bytes", "das/proofs_bytes", "das/recovery_arrays", "das/verify_inputs",
               "verifier/prepare", "verifier/check", "verifier/lincomb")


def _host_s(tr, intervals) -> float:
    return sum((e - s) - tr.busy_s(s, e) for s, e in intervals)


def host_ms(run, span: str):
    """Host ms a call of the span's occurrences; None where the trace holds
    none (a program without the span)."""
    tr = run.trace
    if tr is None:
        return None
    found = [(s, e) for name, s, e in tr.host if name == span]
    return per_call_ms(run, _host_s(tr, found)) if found else None


def other_host_ms(run):
    """Host ms a call outside every span of HOST_STAGES: the traced calls'
    host time that no stage metric explains. None where the trace holds no
    such span."""
    tr = run.trace
    if tr is None:
        return None
    stages = [(s, e) for name, s, e in tr.host if name in HOST_STAGES]
    return per_call_ms(run, _host_s(tr, tr.calls) - _host_s(tr, stages)) if stages else None


def device_ms(run, span: str):
    """Device ms a call of the events launched inside the span (as the
    fk20_ms.* metrics read theirs); None where nothing ran under it."""
    if run.trace is None:
        return None
    spent = run.trace.device_s_under(span)
    return per_call_ms(run, spent) if spent > 0 else None
