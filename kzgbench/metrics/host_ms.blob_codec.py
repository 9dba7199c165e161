"""host_ms.blob_codec: host ms a call of the span das/blob_codec, the prove's
blob codec: deserialize, stack, upload, to_mont (api.py): its wall less the
device busy time inside it (kzgbench/spans.py)."""

from kzgbench.spans import host_ms


def read(run):
    return host_ms(run, "das/blob_codec")
