"""host_ms.verifier_prepare: host ms a call of the span verifier/prepare, the
verifier's point parsing, scalar sets and upload (models/fk20_verifier.py):
its wall less the device busy time inside it (kzgbench/spans.py)."""

from kzgbench.spans import host_ms


def read(run):
    return host_ms(run, "verifier/prepare")
