"""fk20_ms.proofs_g1_fft: device ms a call of the events launched inside the
prover's span fk20/proofs_g1_fft (models/fk20.py)."""

from kzgbench.readers import per_call_ms


def read(run):
    if run.trace is None:
        return None
    spent = run.trace.device_s_under("fk20/proofs_g1_fft")
    return per_call_ms(run, spent) if spent > 0 else None
