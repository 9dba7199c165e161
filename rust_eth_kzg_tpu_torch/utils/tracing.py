"""Tracing and profiling hooks: the counterpart of the JAX package's
`utils/tracing.py`, in torch's idiom.

`span(name)` is a named `torch.profiler.record_function` scope: whenever a
profiler is on, whatever `KZG_TPU_TRACE` says, the span is an event of its
trace, on the clock of the CUDA kernels and copies launched inside it.
With `KZG_TPU_TRACE=1` in the environment at import (or `TRACE_ENABLED` set
to True) a span also prints `[kzg-tpu] <name>: <ms> ms` at its exit: a
device stage (`device` a CUDA device) the time between two CUDA events
around the block (the exit waits for the end event), a host stage the host
clock. Without a profiler and with `KZG_TPU_TRACE` off a span costs one
`record_function` enter and exit and never synchronizes. A span closes,
and prints, when its block raises. `span(name)` also decorates a function.

The spans of the three PeerDAS calls (root, then its stages in order; a
stage with a device is timed on the device):
- `das/compute_cells_and_kzg_proofs_batch`: `das/blob_codec`, the prover's
  `fk20/h_poly_commitments`, `fk20/proofs_g1_fft`,
  `fk20/coset_evaluations`, `fk20/batch_normalize` (device),
  `das/cells_bytes`, `das/proofs_bytes`;
- `das/recover_cells_and_kzg_proofs_batch`: `das/recovery_arrays`,
  `das/upload` (device), `rs/decode` (device), the four `fk20/*`,
  `das/degree_check`, `das/cells_bytes`, `das/proofs_bytes`;
- `das/verify_cell_kzg_proof_batch`: `das/verify_inputs`,
  `verifier/prepare`, `verifier/decompress`, `verifier/lincomb`,
  `verifier/interpolate` (device), `verifier/check`.

`device_trace(logdir)` profiles a region (host activity, and CUDA activity
where CUDA is available) and writes a `*.pt.trace.json` that TensorBoard
reads; it yields the `torch.profiler.profile` object.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

TRACE_ENABLED = os.environ.get("KZG_TPU_TRACE", "0") not in ("", "0", "false")


@contextlib.contextmanager
def span(name: str, device=None):
    """Named profiler scope + optional timing line (KZG_TPU_TRACE=1);
    `device` picks the clock: CUDA events on a CUDA device, else the host's."""
    with torch.profiler.record_function(name):
        if not TRACE_ENABLED:
            yield
            return
        device = torch.device(device) if device is not None else None
        if device is not None and device.type == "cuda":
            stream = torch.cuda.current_stream(device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record(stream)
            try:
                yield
            finally:
                end.record(stream)
                end.synchronize()
                print(f"[kzg-tpu] {name}: {start.elapsed_time(end):.2f} ms")
        else:
            t0 = time.perf_counter()
            try:
                yield
            finally:
                print(f"[kzg-tpu] {name}: {(time.perf_counter() - t0) * 1e3:.2f} ms")


@contextlib.contextmanager
def device_trace(logdir: str):
    """Profile a region into `logdir` (view with TensorBoard)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
        activities=activities, on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir)
    ) as prof:
        yield prof
