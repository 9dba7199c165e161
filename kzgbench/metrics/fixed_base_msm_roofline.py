"""fixed_base_msm_roofline: the least time the call's fixed_base_msm work needs over the device
time of its fixed_base_msm events, in % (kzgbench/work/fixed_base_msm.py, kzgbench/peaks.py)."""

from kzgbench.readers import roofline


def read(run):
    return roofline(run, "fixed_base_msm")
