"""verifier_ms.decompress: device ms a call of the events launched inside the
verifier's span verifier/decompress (models/fk20_verifier.py)."""

from kzgbench.spans import device_ms


def read(run):
    return device_ms(run, "verifier/decompress")
