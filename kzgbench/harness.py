"""One run of one cell: set-up, the measured window (or the traced calls),
the judgement of what the window produced, and the result line.

`run` takes the program and the reference's setup as arguments so that the
tests can drive it on the CPU with the reference in the program's place;
`main` is the command line, which needs the card.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import multiprocessing
import os
import random
import subprocess
import sys
import time
from types import SimpleNamespace

from kzgbench import registry
from kzgbench import trace as TR
from kzgbench.reference import kzg as REF

JAX_NAMES = {"jax", "jaxlib", "flax", "rust_eth_kzg_tpu"}


def loaded_jax() -> list[str]:
    """Modules of sys.modules whose top-level name is JAX's or the JAX
    package's, compared whole (the port's name begins with the package's)."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in JAX_NAMES)


def card_line(torch) -> dict:
    """The card and the peaks the rooflines are read against."""
    from kzgbench import peaks

    limit = "not read"
    try:
        q = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True, timeout=20)
        if q.returncode == 0:
            limit = q.stdout.strip().splitlines()[0]
    except (OSError, subprocess.TimeoutExpired):
        pass
    return {"card": torch.cuda.get_device_name(0), "nvidia_smi_name_power_limit": limit,
            "peak_imad_per_s": peaks.IMAD_PER_S, "peak_hbm_bytes_per_s": peaks.HBM_BYTES_PER_S,
            "peaks_source": "H100 SXM: 132 SMs x 64 IMAD x 1.98 GHz (derived); HBM 3.35 TB/s (published)"}


def kernel_of_event(names: dict[str, str], event: str):
    for kernel, fn in names.items():
        if fn in event:
            return kernel
    return None


def kernel_function_names(kernels) -> dict[str, str]:
    """The program's kernels -> the device function name each event holds,
    longest first so that no name matches inside another."""
    special = registry.read_json(os.path.join(registry.BENCH_DIR, "kernel_names.json"))
    names = {k: special.get(k, f"{k}_kernel") for k in kernels}
    return dict(sorted(names.items(), key=lambda kv: -len(kv[1])))


class Window:
    """The calls of the warm-up or of the window, made by the cell's pacing
    (kzgbench/pacing/): each is timed by the host clock from its arrival
    (its start, in a closed loop) to the return of its bytes or its verdict
    on the host, inside `scope()` (the traced run's span)."""

    def __init__(self, pool, target, keep: int, seed: int, sync):
        self.pool, self.target, self.keep, self.seed, self.sync = pool, target, keep, seed, sync
        self.rng = random.Random(f"kzgbench-keep-{seed}")
        self.scope = contextlib.nullcontext
        self.latencies, self.kept, self.verdicts, self.errors, self.ends = [], [], [], [], []
        self.calls = self.failed = self.blobs = 0

    def one(self, j: int, arrival: float | None = None) -> None:
        i = self.calls
        self.calls += 1
        t0 = time.perf_counter() if arrival is None else arrival
        try:
            with self.scope():
                verdict, output = self.pool.call(self.target, j)
        except Exception as exc:  # a failed call: counted, judged as a wrong answer
            self.failed += 1
            if len(self.errors) < 3:
                self.errors.append(f"call {i} (pool {j}): {type(exc).__name__}: {exc}"[:500])
            return
        finally:
            t1 = time.perf_counter()
            self.latencies.append(t1 - t0)
            self.ends.append(t1)
        self.blobs += self.pool.blobs_per_call
        if self.pool.kind == "verify":
            self.verdicts.append((j, "valid" if verdict == "ok" else "invalid"))
        elif i < self.keep:  # a reservoir sample of the outputs, drawn from the seed
            self.kept.append((j, output))
        else:
            slot = self.rng.randrange(i + 1)
            if slot < self.keep:
                self.kept[slot] = (j, output)

    def run(self, pacer, pacing: dict, seconds: float | None = None, calls: int | None = None) -> float:
        """Calls as the pacing makes them, for `seconds` or `calls`; the
        window closes when the last one returns."""
        t_start = time.perf_counter()
        pacer.drive(self, pacing, self.seed, seconds, calls)
        self.sync()
        return time.perf_counter() - t_start


def make_reference(cell: dict, seed: int, setup_g1, workers, root: str):
    conf = cell["configuration"]
    geom = REF.Geometry(conf["field_elements_per_blob"], conf["field_elements_per_cell"])
    if setup_g1 is None:
        path = os.path.join(root, conf["trusted_setup_file"])
        setup_g1 = REF.load_setup_g1(path, geom.n, workers)
    return REF.Judge(geom, setup_g1, seed)


def run(name: str, seed: int, seconds: float, trace: bool, *, t_start: float | None = None,
        program=None, setup_g1=None, wrap=None, use_card: bool = True, root: str = registry.ROOT,
        workers: int | None = None, out=None, err=None) -> int:
    """One run; prints the result line on `out` and returns the exit code.

    program: the object whose methods the calls drive (default: what the
    configuration's program module builds, kzgbench/programs/); setup_g1: the reference's
    monomial G1 points (default: the configuration's setup file); wrap:
    (program, pool) -> the object the window calls instead (a fault or the
    control); use_card=False skips the look for a card (tests)."""
    out = out or sys.stdout
    err = err or sys.stderr
    t_start = time.perf_counter() if t_start is None else t_start
    cell = registry.cell(name, root)
    conf, params = cell["configuration"], cell["params"]
    wanted = registry.metrics(name, trace, root)
    builder = registry.module("programs", conf["program"]["builder"], root)
    pacer = registry.module("pacing", params["pacing"]["mode"], root)
    torch = None
    phases = {}

    def phase(key):
        phases[key] = time.perf_counter() - t_start - sum(phases.values())

    if use_card:
        import torch

        phase("import_torch")
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            print(f"kzgbench: cell {name} needs {cell['chips']} CUDA device(s); torch sees "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=err)
            return 2
        torch.zeros(1, device="cuda")
        torch.cuda.synchronize()
        phase("cuda_start")
    sync = torch.cuda.synchronize if use_card else (lambda: None)
    if program is None:
        program = builder.build(conf, phase)
    pool = registry.module("traffic", cell["generator"], root).make(params, conf, seed, program)
    target = program if wrap is None else wrap(program, pool)
    phase("pool")
    warm = Window(pool, target, 0, seed, sync)
    for j in range(params["warmup_calls"]):
        warm.one(j % len(pool))
    sync()
    if warm.failed:
        print(f"kzgbench: a warm-up call failed: {warm.errors}", file=err)
    phase("warmup")
    setup_s = time.perf_counter() - t_start
    if use_card:
        print(json.dumps(dict(card_line(torch), setup_phases_s=phases)), file=out, flush=True)

    keep = params["check_calls"] if pool.kind != "verify" else 0
    window = Window(pool, target, keep, seed, sync)
    launches = tr = None
    if trace:
        builder.reset_launches()

        def drive(scope):
            window.scope = scope
            window.run(pacer, params["pacing"], calls=params["trace_calls"])

        tr = TR.profile(torch, drive)
        launches = builder.launches()
        kernels = builder.kernels()
        window_s = tr.window_s
    else:
        window_s = window.run(pacer, params["pacing"], seconds=seconds)
    memory_peak = torch.cuda.max_memory_allocated() if use_card else 0
    found = loaded_jax()
    if found:
        print(f"kzgbench: JAX or the JAX package is loaded in this process: {found}", file=err)
        return 3
    device = {"platform": "gpu" if use_card else "cpu",
              "kind": torch.cuda.get_device_name(0) if use_card else "cpu",
              "count": cell["chips"], "memory_peak_bytes": memory_peak}
    for line in window.errors:
        print(f"kzgbench: {line}", file=err)
    lat = sorted(window.latencies)
    if lat:
        t0 = window.ends[0] - window.latencies[0]
        per_s = [0] * (int(window.ends[-1] - t0) + 1)
        for t in window.ends:
            per_s[int(t - t0)] += 1
        print(json.dumps({"window_calls": window.calls, "window_s": window_s, "calls_each_second": per_s,
                          "call_ms": {"min": lat[0] * 1e3, "median": lat[len(lat) // 2] * 1e3,
                                      "max": lat[-1] * 1e3}}), file=out, flush=True)

    run_info = SimpleNamespace(
        setup_s=setup_s, context_init_s=phases.get("context_init"), window_s=window_s, blobs=window.blobs,
        latencies_s=list(window.latencies), trace=tr, launches=launches, shapes=pool.shapes, root=root)
    breakdown = None
    if trace:
        names = kernel_function_names(kernels)
        per_kernel = {}
        for ev, secs in tr.device_s_by_name().items():
            k = kernel_of_event(names, ev)
            per_kernel[k] = per_kernel.get(k, 0.0) + secs
        run_info.kernel_s = per_kernel
        for k in kernels:
            if launches and launches.get(k) and not per_kernel.get(k):
                print(f"kzgbench: warning: kernel {k} was launched {launches[k]} times in the traced calls "
                      f"and the trace holds no event of it", file=out, flush=True)
        device.update(busy_s=tr.busy_s(), window_s=tr.window_s)
        ops = sorted(tr.device_s_by_name().items(), key=lambda kv: -kv[1])[:10]
        breakdown = {"device_ops": [[n[:120], s] for n, s in ops], "idle_gaps": tr.idle_gaps(10)}
    metrics = {}
    for m in wanted:
        value = registry.module("metrics", m["name"], root).read(run_info)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    # the judgement, once the program's state is freed
    window.target = warm.target = None
    del target, program
    gc.collect()
    if use_card:
        torch.cuda.empty_cache()
    t_judge = time.perf_counter()
    n_workers = workers if workers is not None else min(8, os.cpu_count() or 1)
    record = {"failed": window.failed, "kept": window.kept, "verdicts": window.verdicts}
    with workers_pool(n_workers) as wp:
        ref = make_reference(cell, seed, setup_g1, wp, root)
        checks = registry.module("traffic", cell["generator"], root).judge(
            pool, record, ref, wp, params["check_calls"], seed)
    print(f"kzgbench: judged in {time.perf_counter() - t_judge:.1f} s", file=err)
    correct = all(v <= lim for v, lim in checks.values())
    result = {"correct": correct, "attempted": window.calls, "failed": window.failed, "metrics": metrics,
              "device": device}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    for k, (v, lim) in checks.items():
        print(f"check {k}: {v} (limit {lim})", file=err)
    err.flush()
    print(json.dumps(result), file=out, flush=True)
    return 0


@contextlib.contextmanager
def workers_pool(n: int):
    """The reference's worker processes (spawned: they import the reference
    alone, never the program), closed and waited for on exit; None for one."""
    if n <= 1:
        yield None
        return
    pool = multiprocessing.get_context("spawn").Pool(n)
    try:
        yield pool
    finally:
        pool.close()
        pool.join()


def main(argv=None, t_start: float | None = None) -> int:
    ap = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json on the card.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    return run(args.workload, args.seed, args.seconds, bool(args.trace), t_start=t_start)
