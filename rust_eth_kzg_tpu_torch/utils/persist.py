"""A snapshot of the prover's fixed-base MSM tables, so that a later context
starts without building them.

The counterpart of rust_eth_kzg_tpu/utils/persist.py, for the port's own
table layout (`msm.FixedBaseMSM`: 32-bit-limb `table_x` / `table_y`,
`base_inf`, window, chains, wpc); the JAX package's snapshots (uint8 rows
of bf16 halves) are not read: `utils/convert.py` is the route from its
tables. `FK20Prover(..., table_cache=path)` calls `try_load_tables` before
any device work: a hit runs no SRS G1-FFT and builds no table.

File layout: MAGIC, the header's length (8 bytes, little-endian), a JSON
header (layout version, SRS fingerprint, geometry, and for each table its
window, chains, wpc, instance_ndim and its arrays' dtype, shape and byte
offset), then the arrays' raw bytes, each at a 64-byte aligned offset. A
snapshot is written to a temporary file and renamed into place. Loading
refuses, and the prover then builds its tables, a snapshot whose layout
version, SRS fingerprint, geometry (poly_len, coset_size, expansion) or
window differs, or whose file is shorter than its header says.
"""

from __future__ import annotations

import hashlib
import json
import os

import numpy as np
import torch

from ..ops.msm import FixedBaseMSM

# Bump when FixedBaseMSM's layout or this file's layout changes.
LAYOUT_VERSION = 1
MAGIC = b"KZGTORCHTABLES\n\0"
_ALIGN = 64
_ARRAYS = ("table_x", "table_y", "base_inf")
_TABLES = ("fk20", "commit")


def srs_fingerprint(commit_key_points: list) -> str:
    """Content hash of the host SRS points ((x, y) int tuples or None)."""
    h = hashlib.sha256()
    h.update(str(len(commit_key_points)).encode())
    for pt in commit_key_points:
        h.update(repr(pt).encode())
    return h.hexdigest()[:16]


def save_tables_file(path: str, fingerprint: str, fk20: FixedBaseMSM, commit: FixedBaseMSM, geometry) -> None:
    """Write both tables (fetched from their device) under `path`."""
    header = {"layout_version": LAYOUT_VERSION, "fingerprint": fingerprint,
              "geometry": [int(g) for g in geometry], "tables": {}}
    arrays = []
    offset = 0
    for name, table in zip(_TABLES, (fk20, commit)):
        entry = {"window": table.window, "instance_ndim": table.instance_ndim, "chains": table.chains,
                 "wpc": table.wpc, "arrays": {}}
        for key in _ARRAYS:
            arr = np.ascontiguousarray(getattr(table, key).cpu().numpy())
            entry["arrays"][key] = {"dtype": arr.dtype.str, "shape": list(arr.shape), "offset": offset}
            arrays.append(arr)
            offset += -(-arr.nbytes // _ALIGN) * _ALIGN
        header["tables"][name] = entry
    head = json.dumps(header).encode()
    start = -(-(len(MAGIC) + 8 + len(head)) // _ALIGN) * _ALIGN
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        with open(tmp, "wb") as fh:
            fh.write(MAGIC + len(head).to_bytes(8, "little") + head)
            for arr in arrays:
                fh.write(b"\0" * (start - fh.tell()))
                fh.write(memoryview(arr).cast("B"))
                start += -(-arr.nbytes // _ALIGN) * _ALIGN
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _read_header(fh):
    if fh.read(len(MAGIC)) != MAGIC:
        return None, 0
    size = int.from_bytes(fh.read(8), "little")
    header = json.loads(fh.read(size).decode())
    return header, -(-(len(MAGIC) + 8 + size) // _ALIGN) * _ALIGN


def _read_table(fh, start: int, entry: dict, device) -> FixedBaseMSM | None:
    tensors = {}
    for key in _ARRAYS:
        spec = entry["arrays"][key]
        arr = np.empty(spec["shape"], dtype=np.dtype(spec["dtype"]))
        fh.seek(start + spec["offset"])
        if fh.readinto(memoryview(arr).cast("B")) != arr.nbytes:
            return None  # truncated
        tensors[key] = torch.from_numpy(arr).to(device)
    return FixedBaseMSM(tensors["table_x"], tensors["table_y"], tensors["base_inf"], int(entry["window"]),
                        int(entry["instance_ndim"]), int(entry["chains"]), int(entry["wpc"]))


def try_load_tables(path: str, fingerprint: str, fk20_window: int, commit_window: int, geometry, device):
    """(fk20 tables, commit tables) on `device` if the snapshot at `path`
    matches the layout version, the SRS fingerprint, the geometry and both
    windows; else None."""
    if not path or not os.path.exists(path):
        return None
    try:
        with open(path, "rb") as fh:
            header, start = _read_header(fh)
            if (header is None or header["layout_version"] != LAYOUT_VERSION
                    or header["fingerprint"] != fingerprint
                    or header["geometry"] != [int(g) for g in geometry]):
                return None
            entries = header["tables"]
            if [entries[name]["window"] for name in _TABLES] != [fk20_window, commit_window]:
                return None
            tables = tuple(_read_table(fh, start, entries[name], device) for name in _TABLES)
    except (OSError, ValueError, KeyError, TypeError):
        return None
    return None if None in tables else tables


def config_geometry(config) -> tuple[int, int, int]:
    """The geometry a snapshot is made for: (poly_len, coset_size, expansion)."""
    return config.poly_len, config.coset_size, config.expansion


def save_prover_tables(prover, path: str) -> None:
    if prover.tables is None or prover.commit_tables is None:
        raise ValueError("this prover has no fixed-base tables to save (a window of None)")
    if prover.mesh is not None:
        raise ValueError("this prover holds only its slice of the FK20 tables (a mesh): it cannot save them")
    save_tables_file(path, prover.srs_fingerprint, prover.tables, prover.commit_tables, config_geometry(prover.config))


def load_prover_tables(prover, path: str) -> bool:
    """Replace the prover's tables by the snapshot's (a sharded prover keeps
    its slice); False (the prover unchanged) if it is missing or made for
    another SRS, geometry, window or layout, or if the prover runs without
    tables."""
    cfg = prover.config
    if cfg.fk20_window is None or cfg.commit_window is None:
        return False
    loaded = try_load_tables(path, prover.srs_fingerprint, cfg.fk20_window, cfg.commit_window, config_geometry(cfg),
                             prover.device)
    if loaded is None:
        return False
    prover.set_tables(*loaded)
    return True
