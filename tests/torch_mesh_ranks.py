"""Rank programs of tests/test_torch_mesh.py, and the launcher that runs them.

A spawned rank imports this module to find its program, so it imports
torch and the port only, never JAX. `run_world` starts `world` gloo ranks
with the spawn start method over a FileStore, each at one intra-op thread,
and gives every world a hard time limit: ranks still alive at the limit
are terminated and the call raises. Each rank writes its program's result
to a file, which `run_world` returns in rank order.
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import pickle
import time
import traceback

import torch
import torch.distributed as dist

from rust_eth_kzg_tpu_torch import DASContext, ProverError, TrustedSetup, api
from rust_eth_kzg_tpu_torch.models.fk20 import FK20Config, FK20Prover
from rust_eth_kzg_tpu_torch.ops import curve as C
from rust_eth_kzg_tpu_torch.ops import field as F
from rust_eth_kzg_tpu_torch.ops import ntt
from rust_eth_kzg_tpu_torch.parallel import mesh as PM

WORLD_TIMEOUT_S = 120
CFG = FK20Config(poly_len=64, coset_size=8, expansion=2, fk20_window=4, commit_window=4)
FR = F.FR


def _entry(program, rank, world, out_dir, args):
    torch.set_num_threads(1)
    try:
        store = dist.FileStore(os.path.join(out_dir, "store"), world)
        dist.init_process_group("gloo", store=store, rank=rank, world_size=world,
                                timeout=datetime.timedelta(seconds=WORLD_TIMEOUT_S))
        try:
            result = program(*args)
        finally:
            dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as fh:
            fh.write(traceback.format_exc())
        raise
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as fh:
        pickle.dump(result, fh)


def start_world(program, world: int, out_dir, *args):
    """Start the ranks of `program(*args)` (not waiting for them)."""
    os.makedirs(out_dir, exist_ok=True)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_entry, args=(program, r, world, str(out_dir), args)) for r in range(world)]
    for p in procs:
        p.start()
    return procs, time.monotonic() + WORLD_TIMEOUT_S, str(out_dir)


def join_world(started) -> list:
    """Wait for the ranks until the world's limit; then each rank's result."""
    procs, deadline, out_dir = started
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
    finally:
        hung = [p for p in procs if p.is_alive()]
        for p in hung:
            p.terminate()
        for p in hung:
            p.join(10)
            if p.is_alive():
                p.kill()
                p.join()
    errors = ""
    for r in range(len(procs)):
        path = os.path.join(out_dir, f"rank{r}.err")
        if os.path.exists(path):
            with open(path) as fh:
                errors += f"\n--- rank {r}:\n{fh.read()}"
    if hung:
        raise TimeoutError(f"{len(hung)} of {len(procs)} ranks still running after {WORLD_TIMEOUT_S} s{errors}")
    codes = [p.exitcode for p in procs]
    if any(codes):
        raise RuntimeError(f"ranks exited with codes {codes}{errors}")
    out = []
    for r in range(len(procs)):
        with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as fh:
            out.append(pickle.load(fh))
    return out


def run_world(program, world: int, out_dir, *args) -> list:
    return join_world(start_world(program, world, out_dir, *args))


# --- rank programs: every rank gets the same arguments ---


def fft_program(x, n):
    """fft_sharded of x [8, B, n] over a mesh of the whole world on `work`:
    canonical values."""
    mesh = PM.make_mesh()
    got = PM.fft_sharded(ntt.Domain(n, "cpu"), x, mesh)
    return FR.from_mont_host(got.reshape(FR.nlimbs, -1).numpy())


def lincomb_program(points, scalars):
    """lincomb_sharded of host points and Montgomery scalars over `work`."""
    mesh = PM.make_mesh()
    got = PM.lincomb_sharded(C.points_to_device(points, "cpu"), scalars, mesh)
    return C.points_from_device(C._map(lambda c: c[:, None], got))[0]


def as_bytes(proofs, cells):
    """(proofs [B, K], cells [8, B, K, M]) -> per blob (cells, proofs) bytes,
    as the prover calls of DASContext return them."""
    b, k = cells.shape[1], cells.shape[2]
    return list(zip(api.cells_bytes_from_std(F.from_mont(FR, cells).numpy()), api.proofs_bytes(proofs, b, k)))


def prove_sharded_program(g1s, cache, data):
    """prove_sharded on a (1, world) mesh with a prover of every slot, its
    tables read from the snapshot at `cache`."""
    full = FK20Prover(g1s, CFG, "cpu", table_cache=cache)
    return as_bytes(*PM.prove_sharded(full, PM.make_mesh(dp=1), data))


def prove_work_sharded_program(g1s, cache, data):
    """prove_work_sharded on a (2, world / 2) mesh with a sharded prover
    whose tables are cut from the snapshot at `cache`; its FK20 table bytes
    and slots; the dp-divisibility error of a context around it and its
    refusal to save a snapshot."""
    mesh = PM.make_mesh(dp=2)
    sharded = FK20Prover(g1s, CFG, "cpu", table_cache=cache, mesh=mesh)
    out = {"proved": as_bytes(*PM.prove_work_sharded(sharded, mesh, data)), "fk20_table_bytes": sharded.tables.nbytes,
           "slots": (sharded.slots.start, sharded.slots.stop)}
    ctx = DASContext.from_prover(sharded)
    try:
        ctx.compute_cells_and_kzg_proofs_batch([bytes(32 * CFG.poly_len)] * 3)
    except ProverError as exc:
        out["dp_error"] = str(exc)
    try:
        ctx.save_tables(os.path.join(os.path.dirname(cache), "never.bin"))
    except ValueError as exc:
        out["save_error"] = str(exc)
    return out


def context_program(g1s, g2s, blobs, kept):
    """DASContext(mesh=make_mesh(dp=1)) built from the setup: its prove of
    `blobs`, its recovery of blob 0 from the cells at `kept`, its FK20
    table bytes and slot instances."""
    mesh = PM.make_mesh(dp=1)
    ctx = DASContext(device="cpu", trusted_setup=TrustedSetup(g1s, g2s), config=CFG, mesh=mesh)
    proved = ctx.compute_cells_and_kzg_proofs_batch(blobs)
    recovered = ctx.recover_cells_and_kzg_proofs(kept, [proved[0][0][i] for i in kept])
    return {"proved": proved, "recovered": recovered, "fk20_table_bytes": ctx.prover.tables.nbytes,
            "table_instances": ctx.prover.tables.table_x.shape[1], "mesh_shape": tuple(ctx.mesh.shape)}
