"""host_ms.proofs_bytes: host ms a call of the span das/proofs_bytes, the
proofs' fetch and compression, one by one (api.py): its wall less the device
busy time inside it (kzgbench/spans.py)."""

from kzgbench.spans import host_ms


def read(run):
    return host_ms(run, "das/proofs_bytes")
