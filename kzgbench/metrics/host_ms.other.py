"""host_ms.other: host ms a call outside every span that the other host_ms.*
metrics read (kzgbench/spans.py): the traced calls' host time that no stage
metric explains. With them it adds up to host_ms_per_call."""

from kzgbench.spans import other_host_ms


def read(run):
    return other_host_ms(run)
