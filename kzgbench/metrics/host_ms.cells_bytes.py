"""host_ms.cells_bytes: host ms a call of the span das/cells_bytes, the cells'
fetch and serialization (api.py): its wall less the device busy time inside
it (kzgbench/spans.py)."""

from kzgbench.spans import host_ms


def read(run):
    return host_ms(run, "das/cells_bytes")
