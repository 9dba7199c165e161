"""The trace's reductions on a hand-made event list."""

from kzgbench import trace as TR


def _ev(cat, name, ts, dur, corr=None):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "args": {"correlation": corr}}


EVENTS = [
    _ev("user_annotation", TR.CALL_SPAN, 0, 100),
    _ev("user_annotation", "fk20/proofs_g1_fft", 10, 30),
    _ev("cuda_runtime", "cudaLaunchKernel", 12, 1, corr=1),
    _ev("cuda_runtime", "cudaLaunchKernel", 50, 1, corr=2),
    _ev("cpu_op", "aten::copy_", 60, 30),
    _ev("kernel", "g1_fft_kernel", 20, 20, corr=1),
    _ev("kernel", "void at::elementwise", 30, 20, corr=2),
    _ev("gpu_user_annotation", "fk20/proofs_g1_fft", 20, 20),
    _ev("user_annotation", TR.CALL_SPAN, 100, 100),
    _ev("gpu_memcpy", "Memcpy DtoH", 150, 10, corr=3),
]


def test_reductions():
    tr = TR.Trace(EVENTS)
    assert tr.window == (0.0, 200e-6)
    assert abs(tr.busy_s() - 40e-6) < 1e-12  # [20, 50) and [150, 160)
    assert abs(tr.device_s_under("fk20/proofs_g1_fft") - 20e-6) < 1e-12
    assert tr.device_s_by_name()["g1_fft_kernel"] == 20e-6
    # gaps [50, 150), [160, 200), [0, 20), each named by the innermost host
    # scope open at its middle
    assert TR.gaps([(20, 50), (150, 160)], 0, 200) == [(0, 20), (50, 150), (160, 200)]
    gaps = tr.idle_gaps(3)
    assert [g[0] for g in gaps] == [TR.CALL_SPAN, TR.CALL_SPAN, "fk20/proofs_g1_fft"]
    assert [round(g[1] * 1e6, 6) for g in gaps] == [100, 40, 20]
