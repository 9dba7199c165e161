"""g1_fft_roofline: the least time the call's g1_fft work needs over the device
time of its g1_fft events, in % (kzgbench/work/g1_fft.py, kzgbench/peaks.py)."""

from kzgbench.readers import roofline


def read(run):
    return roofline(run, "g1_fft")
