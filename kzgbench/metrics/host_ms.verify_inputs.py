"""host_ms.verify_inputs: host ms a call of the span das/verify_inputs, the
verify's host checks, cell parsing and Fiat-Shamir (api.py): its wall less
the device busy time inside it (kzgbench/spans.py)."""

from kzgbench.spans import host_ms


def read(run):
    return host_ms(run, "das/verify_inputs")
