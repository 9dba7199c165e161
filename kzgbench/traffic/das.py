"""The general generator of PeerDAS calls, and their judgement.

A cell's workload file gives the parameters; everything else comes from the
run's seed. Three entries of `DASContext`, each called with one argument
list from a pool made in set-up and taken in turn:

- "prove": `compute_cells_and_kzg_proofs_batch(blobs)`, `blobs_per_call`
  blobs of uniform canonical scalars a call, `pool_calls` distinct calls.
- "recover": `recover_cells_and_kzg_proofs_batch(batches)`: the blobs of one
  call, every one missing the same columns: `kept_columns` of the cells
  drawn from the seed for each call. The cells are the program's, proved in
  set-up; the judgement works them out again from the blobs.
- "verify": `verify_cell_kzg_proof_batch(commitments, indices, cells,
  proofs)` over every cell of `blobs_per_call` blobs, in `order`
  "blob-major" (one blob's cells after another: a transaction's wrapper) or
  "column-major" (one column's cells after another: a block's sidecars).
  Cells, proofs and commitments are the program's, made in set-up.
  `invalid_calls` of the pool's calls, drawn from the seed, carry one cell
  with one scalar raised by 1: the verifier must reject them. Accepting and
  rejecting cost the verifier the same work.

Every seed gets the same sizes; only the bytes differ.
"""

from __future__ import annotations

import numpy as np

from kzgbench.reference import kzg as REF

# exact comparisons: one wrong byte, proof or verdict is one too many
LIMITS = {"calls_failed": 0, "no_call_judged": 0, "cells_wrong": 0, "proof_checks_failed": 0, "verdicts_wrong": 0}


def make_blobs(rng: np.random.Generator, count: int, poly_len: int) -> list[bytes]:
    """Blobs of uniform-looking canonical scalars: the top 64-bit word below r's."""
    top = rng.integers(0, REF.R >> 192, size=(count, poly_len, 1), dtype=np.uint64)
    low = rng.integers(0, 1 << 64, size=(count, poly_len, 3), dtype=np.uint64)
    words = np.concatenate([top, low], axis=2).astype(">u8")
    return [words[i].tobytes() for i in range(count)]


def bump_scalar(cell: bytes, at: int) -> bytes:
    """The cell with scalar `at` raised by 1 (mod r): still canonical."""
    v = (int.from_bytes(cell[32 * at : 32 * at + 32], "big") + 1) % REF.R
    return cell[: 32 * at] + v.to_bytes(32, "big") + cell[32 * at + 32 :]


class Pool:
    """The calls of one run: argument lists, the blobs behind each, and
    what the judgement needs to know of how they were made."""

    def __init__(self, kind: str, entry: str, blobs_per_call: int, shapes: dict):
        self.kind, self.entry, self.blobs_per_call, self.shapes = kind, entry, blobs_per_call, shapes
        self.args: list[tuple] = []
        self.blobs: list[list[bytes]] = []
        self.owner: list[list[int]] = []  # verify: the blob of each cell position
        self.invalid: set[int] = set()

    def __len__(self) -> int:
        return len(self.args)

    def call(self, program, j: int):
        """("ok", output), ("invalid", None) for a rejected verify, or raises."""
        try:
            return "ok", getattr(program, self.entry)(*self.args[j])
        except Exception as exc:  # the verdict of a verify is an exception by its class name
            if self.kind == "verify" and type(exc).__name__ == "InvalidProofError":
                return "invalid", None
            raise


def make(params: dict, configuration: dict, seed: int, program) -> Pool:
    n = configuration["field_elements_per_blob"]
    m = configuration["field_elements_per_cell"]
    cells_per_blob = 2 * n // m
    kind = params["entry"]
    per_call, count = params["blobs_per_call"], params["pool_calls"]
    entry = {"prove": "compute_cells_and_kzg_proofs_batch", "recover": "recover_cells_and_kzg_proofs_batch",
             "verify": "verify_cell_kzg_proof_batch"}[kind]
    shapes = {}
    if kind in ("prove", "recover"):
        shapes = {"fk20_blobs": per_call, "poly_len": n, "cell_size": m, "window": configuration["precomp_width"]}
    pool = Pool(kind, entry, per_call, shapes)
    rng = np.random.default_rng(seed)
    blobs = make_blobs(rng, per_call * count, n)
    pool.blobs = [blobs[i * per_call : (i + 1) * per_call] for i in range(count)]
    if kind == "prove":
        pool.args = [(b,) for b in pool.blobs]
        return pool
    proved = [program.compute_cells_and_kzg_proofs_batch(b) for b in pool.blobs]
    if kind == "recover":
        for block in proved:
            cols = sorted(int(c) for c in rng.choice(cells_per_blob, size=params["kept_columns"], replace=False))
            pool.args.append(([(cols, [cells[c] for c in cols]) for cells, _ in block],))
        return pool
    pool.invalid = {int(i) for i in rng.choice(count, size=params["invalid_calls"], replace=False)}
    for j, (block, block_blobs) in enumerate(zip(proved, pool.blobs)):
        comms = [program.blob_to_kzg_commitment(b) for b in block_blobs]
        cells = [list(c) for c, _ in block]
        if j in pool.invalid:
            b, k, at = int(rng.integers(per_call)), int(rng.integers(cells_per_blob)), int(rng.integers(m))
            cells[b][k] = bump_scalar(cells[b][k], at)
        if params["order"] == "blob-major":
            order = [(b, k) for b in range(per_call) for k in range(cells_per_blob)]
        else:
            order = [(b, k) for k in range(cells_per_blob) for b in range(per_call)]
        pool.args.append(([comms[b] for b, _ in order], [k for _, k in order], [cells[b][k] for b, k in order],
                          [block[b][1][k] for b, k in order]))
        pool.owner.append([b for b, _ in order])
    return pool


def _verify_truth(pool: Pool, judged: list[int], ref, workers) -> dict[int, str]:
    """The reference's verdict on each judged call: "valid" iff every cell
    is its blob's and every proof and commitment the spec's."""
    geom = ref.geom
    per_blob = {}  # (call, blob) -> (commitments seen, cells by index, proofs by index)
    for j in judged:
        comms, indices, cells, proofs = pool.args[j]
        for pos, b in enumerate(pool.owner[j]):
            seen, cs, ps = per_blob.setdefault((j, b), (set(), {}, {}))
            seen.add(bytes(comms[pos]))
            cs[indices[pos]] = bytes(cells[pos])
            ps[indices[pos]] = bytes(proofs[pos])
    keys = list(per_blob)
    if any(sorted(per_blob[key][1]) != list(range(geom.cells)) for key in keys):
        raise ValueError("a judged verify call does not hold every cell of each of its blobs")
    wrong = REF.cells_wrong(geom, [pool.blobs[j][b] for j, b in keys],
                            [[per_blob[key][1][k] for k in range(geom.cells)] for key in keys], workers)
    verdict = {j: "valid" for j in judged}
    for (j, b), w, in zip(keys, wrong):
        if w or len(per_blob[(j, b)][0]) != 1:
            verdict[j] = "invalid"
    def holds(calls):
        ks = [key for key in keys if key[0] in calls]
        return ref.openings_hold([pool.blobs[j][b] for j, b in ks],
                                 [[per_blob[key][2][k] for k in range(geom.cells)] for key in ks],
                                 [next(iter(per_blob[key][0])) for key in ks], workers)
    rest = [j for j in judged if verdict[j] == "valid"]
    if rest and not holds(set(rest)):
        for j in rest:
            if not holds({j}):
                verdict[j] = "invalid"
    return verdict


def judge(pool: Pool, record: dict, ref, workers, check_calls: int, seed: int) -> dict:
    """The compared numbers of one run: {name: (value, limit)}.

    record: "failed" (calls that raised), "kept" ([(pool index, output)]:
    prove and recover, a sample drawn from the seed) and "verdicts" ([(pool
    index, verdict)] of every verify call)."""
    out = {"calls_failed": record["failed"]}
    if pool.kind == "verify":
        called = sorted({j for j, _ in record["verdicts"]})
        rng = np.random.default_rng(seed + 1)
        valid = [j for j in called if j not in pool.invalid]
        judged = sorted([j for j in called if j in pool.invalid]
                        + [int(j) for j in rng.choice(valid, size=min(check_calls, len(valid)), replace=False)])
        truth = _verify_truth(pool, judged, ref, workers) if judged else {}
        out["no_call_judged"] = int(not judged)
        out["verdicts_wrong"] = sum(1 for j, v in record["verdicts"] if j in truth and v != truth[j])
    else:
        kept = record["kept"]
        out["no_call_judged"] = int(not kept)
        geom = ref.geom
        wrong, blobs, proofs = 0, [], []
        for j, output in kept:
            try:
                if len(output) != pool.blobs_per_call or any(len(o) != 2 for o in output):
                    raise TypeError("not one (cells, proofs) pair a blob")
                cells, prfs = [o[0] for o in output], [list(o[1]) for o in output]
            except TypeError:
                wrong += pool.blobs_per_call * geom.cells
                continue
            wrong += sum(REF.cells_wrong(geom, pool.blobs[j], cells, workers))
            blobs.extend(pool.blobs[j])
            proofs.extend(prfs)
        out["cells_wrong"] = wrong
        out["proof_checks_failed"] = int(bool(blobs) and not ref.openings_hold(blobs, proofs, None, workers))
    return {name: (value, LIMITS[name]) for name, value in out.items()}
