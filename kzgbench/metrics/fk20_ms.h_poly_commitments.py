"""fk20_ms.h_poly_commitments: device ms a call of the events launched inside the
prover's span fk20/h_poly_commitments (models/fk20.py)."""

from kzgbench.readers import per_call_ms


def read(run):
    if run.trace is None:
        return None
    spent = run.trace.device_s_under("fk20/h_poly_commitments")
    return per_call_ms(run, spent) if spent > 0 else None
