"""launches_per_call: the program's own count of kernel launches
(ops/kernels.py LAUNCHES) over the traced calls, a call."""

from kzgbench.readers import traced_calls


def read(run):
    n = traced_calls(run)
    return sum(run.launches.values()) / n if n and run.launches is not None else None
