"""host_ms.verifier_lincomb: host ms a call of the span verifier/lincomb,
Pippenger's launches in the verifier (models/fk20_verifier.py): its wall
less the device busy time inside it (kzgbench/spans.py)."""

from kzgbench.spans import host_ms


def read(run):
    return host_ms(run, "verifier/lincomb")
