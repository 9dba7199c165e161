"""verifier_ms.lincomb: device ms a call of the events launched inside the
verifier's span verifier/lincomb (models/fk20_verifier.py)."""

from kzgbench.spans import device_ms


def read(run):
    return device_ms(run, "verifier/lincomb")
