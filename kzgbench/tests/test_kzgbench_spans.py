"""The readers of the program's stage spans on hand-made event lists: two
calls of a verify and two of a prove, and a program without the spans."""

from types import SimpleNamespace

import pytest

from kzgbench import registry
from kzgbench import trace as TR


def _ev(cat, name, ts, dur, corr=None):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "args": {"correlation": corr}}


def _call(t0, root, stages, device):
    """One call at t0 (us): its spans [(name, start, end)] and its device
    events [(name, start, end, launched at)], each launch a runtime event."""
    evs = [_ev("user_annotation", TR.CALL_SPAN, t0, 100), _ev("user_annotation", root, t0, 100)]
    evs += [_ev("user_annotation", name, t0 + s, e - s) for name, s, e in stages]
    for i, (name, s, e, at) in enumerate(device):
        corr = t0 + i + 1
        evs.append(_ev("cuda_runtime", "cudaLaunchKernel", t0 + at, 1, corr=corr))
        evs.append(_ev("kernel" if "Memcpy" not in name else "gpu_memcpy", name, t0 + s, e - s, corr=corr))
    return evs


# per call: 100 us, device busy 35 us ([25, 28), [32, 60), [66, 68), [80, 82)), host 65 us
VERIFY = ("das/verify_cell_kzg_proof_batch",
          [("das/verify_inputs", 0, 20), ("verifier/prepare", 20, 30), ("verifier/decompress", 30, 40),
           ("verifier/lincomb", 40, 70), ("verifier/interpolate", 70, 80), ("verifier/check", 80, 100)],
          [("Memcpy HtoD", 25, 28, 25), ("g1_decompress_kernel", 32, 50, 31), ("g1_double_kernel", 50, 60, 45),
           ("g1_add_kernel", 66, 68, 65), ("Memcpy DtoH", 80, 82, 80)])
# per call: device busy [10, 12), [20, 60), [70, 75): host 53 us
PROVE = ("das/compute_cells_and_kzg_proofs_batch",
         [("das/blob_codec", 0, 15), ("fk20/h_poly_commitments", 15, 25), ("fk20/proofs_g1_fft", 25, 30),
          ("das/cells_bytes", 30, 65), ("das/proofs_bytes", 65, 100)],
         [("Memcpy HtoD", 10, 12, 10), ("g1_fft_kernel", 20, 60, 16), ("Memcpy DtoH", 70, 75, 66)])

# host ms a call of each reader: the span's wall less the device busy inside it
WANT = {
    "verify": {"host_ms_per_call": 0.065, "host_ms.verify_inputs": 0.020, "host_ms.verifier_prepare": 0.007,
               "host_ms.verifier_lincomb": 0.008, "host_ms.verifier_check": 0.018,
               "host_ms.other": 0.012,  # decompress 2 + interpolate 10
               "verifier_ms.decompress": 0.018, "verifier_ms.lincomb": 0.012},
    "prove": {"host_ms_per_call": 0.053, "host_ms.blob_codec": 0.013, "host_ms.cells_bytes": 0.005,
              "host_ms.proofs_bytes": 0.030,
              "host_ms.other": 0.005},  # h_poly 5 + proofs_g1_fft 0
}
ABSENT = {"verify": ["host_ms.blob_codec", "host_ms.cells_bytes", "host_ms.recovery_arrays"],
          "prove": ["host_ms.verify_inputs", "verifier_ms.decompress", "verifier_ms.lincomb"]}


def _run(spec):
    events = _call(0, *spec) + _call(200, *spec)
    return SimpleNamespace(trace=TR.Trace(events))


def _read(name, run):
    return registry.module("metrics", name).read(run)


@pytest.mark.parametrize("cell", ["verify", "prove"])
def test_readers_and_their_sum(cell):
    run = _run(VERIFY if cell == "verify" else PROVE)
    got = {name: _read(name, run) for name in WANT[cell]}
    assert got == pytest.approx(WANT[cell], abs=1e-12)
    for name in ABSENT[cell]:
        assert _read(name, run) is None
    # the cell's host_ms.* add up to host_ms_per_call
    stages = [v for k, v in got.items() if k.startswith("host_ms.")]
    assert sum(stages) == pytest.approx(got["host_ms_per_call"], abs=1e-12)


def test_gaps_are_named_by_their_stage():
    gaps = _run(VERIFY).trace.idle_gaps(10)
    # [0, 25) verify_inputs, [28, 32) prepare, [60, 66) lincomb, [68, 80)
    # interpolate, and the second call's [282, 300) check; the first call's
    # check runs into the second call's start, [82, 225), outside every span
    names = {round(length * 1e6, 6): name for name, length in gaps}
    assert names[25] == "das/verify_inputs"
    assert names[18] == "verifier/check"
    assert names[12] == "verifier/interpolate"
    assert names[6] == "verifier/lincomb"
    assert names[4] == "verifier/prepare"
    assert TR.CALL_SPAN not in names.values() and "das/verify_cell_kzg_proof_batch" not in names.values()


def test_a_program_without_the_spans_reads_nothing():
    events = [_ev("user_annotation", TR.CALL_SPAN, 0, 100), _ev("cuda_runtime", "cudaLaunchKernel", 5, 1, corr=1),
              _ev("kernel", "g1_fft_kernel", 10, 20, corr=1)]
    run = SimpleNamespace(trace=TR.Trace(events))
    names = [m["name"] for m in registry.benchmark()["per_layer"] if m["name"].startswith(("host_ms.", "verifier_ms."))]
    assert len(names) == 11
    assert all(_read(name, run) is None for name in names)
    assert all(_read(name, SimpleNamespace(trace=None)) is None for name in names)
