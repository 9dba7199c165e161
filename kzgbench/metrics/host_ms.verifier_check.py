"""host_ms.verifier_check: host ms a call of the span verifier/check, the
verifier's flags' fetch and pairing (models/fk20_verifier.py): its wall less
the device busy time inside it (kzgbench/spans.py)."""

from kzgbench.spans import host_ms


def read(run):
    return host_ms(run, "verifier/check")
