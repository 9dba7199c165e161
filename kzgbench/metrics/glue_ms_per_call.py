"""glue_ms_per_call: device ms a call in events that are none of the
program's kernels: torch's own kernels, copies and sets."""

from kzgbench.readers import per_call_ms


def read(run):
    if run.trace is None:
        return None
    return per_call_ms(run, run.kernel_s.get(None, 0.0))
