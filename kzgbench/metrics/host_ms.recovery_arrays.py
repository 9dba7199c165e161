"""host_ms.recovery_arrays: host ms a call of the span das/recovery_arrays,
recovery's input checks and erasure layout (api.py): its wall less the
device busy time inside it (kzgbench/spans.py)."""

from kzgbench.spans import host_ms


def read(run):
    return host_ms(run, "das/recovery_arrays")
