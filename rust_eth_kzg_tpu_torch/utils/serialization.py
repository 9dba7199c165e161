"""Byte codecs between the wire format and limb arrays.

Canonical big-endian scalars (each must be < r), blobs and cells of scalars,
with the validation rules of the consensus specs; compressed G1 points,
decompressed with their subgroup checks on the device (`ops/decompress.py`:
the `g1_decompress` kernel on CUDA tensors) with the error texts of the JAX
package's native library.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import BYTES_PER_BLOB, BYTES_PER_CELL, BYTES_PER_FIELD_ELEMENT, BYTES_PER_G1_POINT, R_SCALAR
from ..errors import SerializationError
from ..ops import curve as C
from ..ops import decompress as D
from ..ops import field as F
from ..ops import limbs as L
from . import bls_host as bls

FR_LIMBS = 8

# big-endian uint64 words of r, for the vectorized canonicity check
_R_WORDS = np.array(
    [(R_SCALAR >> (64 * (3 - i))) & 0xFFFFFFFFFFFFFFFF for i in range(4)], dtype=np.uint64
)


def _check_canonical_scalars(raw: np.ndarray) -> None:
    """raw: [N, 32] uint8 big-endian. Scans word 0 of every scalar, then word
    1, and so on, and raises at the first scalar that exceeds r in the word
    scanned (its earlier words equal r's); then at the first scalar equal to r."""
    words = np.ascontiguousarray(raw).view(">u8").astype(np.uint64)  # [N, 4]
    lt = np.zeros(len(words), dtype=bool)  # below r in an earlier word
    for i in range(4):
        w = words[:, i]
        gt = ~lt & (w > _R_WORDS[i])
        if gt.any():
            idx = int(np.argmax(gt))
            raise SerializationError(f"scalar at index {idx} is not canonical (>= field modulus)")
        lt |= w < _R_WORDS[i]
    eq = ~lt
    if eq.any():
        idx = int(np.argmax(eq))
        raise SerializationError(f"scalar at index {idx} is not canonical (== field modulus)")


def deserialize_scalars(data: bytes, expected_len: int | None = None) -> np.ndarray:
    """Bytes -> canonical standard-form Fr limbs [8, N] int32."""
    if len(data) % BYTES_PER_FIELD_ELEMENT != 0:
        raise SerializationError(
            f"byte length {len(data)} is not a multiple of {BYTES_PER_FIELD_ELEMENT}"
        )
    n = len(data) // BYTES_PER_FIELD_ELEMENT
    if expected_len is not None and n != expected_len:
        raise SerializationError(f"expected {expected_len} scalars, got {n}")
    raw = np.frombuffer(bytes(data), dtype=np.uint8).reshape(n, 32)
    _check_canonical_scalars(raw)
    return L.bytes_be_to_limbs(raw, FR_LIMBS)


def deserialize_blob(blob: bytes) -> np.ndarray:
    """A mainnet blob (BYTES_PER_BLOB bytes) -> standard-form Fr limbs [8, 4096]."""
    if len(blob) != BYTES_PER_BLOB:
        raise SerializationError(f"blob has invalid length {len(blob)}, expected {BYTES_PER_BLOB}")
    return deserialize_scalars(blob)


def deserialize_cells_batch(cells, cell_bytes: int = BYTES_PER_CELL) -> np.ndarray:
    """K cells -> [K, coset, 8] standard-form limbs in one vectorized pass;
    every cell must be `cell_bytes` long (BYTES_PER_CELL at mainnet
    geometry) and every scalar canonical."""
    cells = [bytes(c) for c in cells]
    for c in cells:
        if len(c) != cell_bytes:
            raise SerializationError(f"cell has invalid length {len(c)}, expected {cell_bytes}")
    per_cell = cell_bytes // BYTES_PER_FIELD_ELEMENT
    std = deserialize_scalars(b"".join(cells))  # [8, K * coset]
    return np.ascontiguousarray(std.reshape(std.shape[0], len(cells), per_cell).transpose(1, 2, 0))


def serialize_scalars(std_limbs) -> bytes:
    """Canonical standard-form limbs [8, N] -> N * 32 big-endian bytes."""
    return L.limbs_to_bytes_be(np.asarray(std_limbs))


# --- compressed G1 points ---

G1_ERRORS = (*D.BYTE_ERRORS, "x coordinate not on curve", "point not in the prime-order subgroup")


def decompress_g1_groups(groups, device, batch: bool = True) -> list[C.G1]:
    """Groups of compressed G1 points -> one G1 [len(group)] (Montgomery, Z
    one or zero) per group on `device`, every point of every group
    decompressed and subgroup-checked in one `decompress.decompress_g1` call
    (on an error, the points before the first byte-level failure).

    Errors come in the order of one validating call a group, one after
    another: each group as one `deserialize_g1_batch` (`batch`: the lengths
    of the group first; a message names the point's index in its group),
    or, a group of one point each, as one `deserialize_g1` (no index). The
    first failure raises SerializationError.
    """
    groups = [[bytes(p) for p in g] for g in groups]
    stop, length_error = len(groups), None
    for gi, group in enumerate(groups):
        bad = [i for i, p in enumerate(group) if len(p) != BYTES_PER_G1_POINT]
        if bad:
            i, n = bad[0], len(group[bad[0]])
            where = f"G1 point {i}" if batch else "G1 point"
            stop, length_error = gi, f"{where} has invalid length {n}, expected {BYTES_PER_G1_POINT}"
            break
    flat = [p for group in groups[:stop] for p in group]
    points = C.identity((0,), device)
    if flat:
        x_std, sort, inf, code = D.parse_compressed_g1_codes(flat)
        # the lanes before the first byte-level error go to the device
        live = int(np.argmax(code != 0)) if code.any() else len(flat)
        if live:
            x, sort_t, inf_t = (torch.from_numpy(a[..., :live]).to(device) for a in (x_std, sort, inf))
            points, on_curve, in_subgroup = D.decompress_g1(x, sort_t, inf_t)
            on_curve, in_subgroup = on_curve.cpu().numpy(), in_subgroup.cpu().numpy()
            code[:live] = np.where(~on_curve, 4, np.where(~in_subgroup, 5, 0))
        if code.any():
            j = int(np.argmax(code != 0))
            sizes = np.cumsum([len(g) for g in groups[:stop]])
            gi = int(np.searchsorted(sizes, j, side="right"))
            i = j - (int(sizes[gi - 1]) if gi else 0)
            message = G1_ERRORS[code[j] - 1]
            raise SerializationError(f"point {i}: {message}" if batch else message)
    if length_error is not None:
        raise SerializationError(length_error)
    out, start = [], 0
    for group in groups:
        out.append(C._map(lambda c: c[:, start : start + len(group)], points))
        start += len(group)
    return out


def points_to_host(points: C.G1) -> list:
    """Decompressed points (Z one or zero, Montgomery) -> host affine (x, y)
    ints, None for the identity; no kernel launch."""
    fp = F.FP
    xs, ys = (fp.from_mont_host(c.reshape(fp.nlimbs, -1).cpu().numpy()) for c in points[:2])
    inf = F.is_zero(fp, points.z).reshape(-1).cpu().numpy()
    return [None if i else (x, y) for x, y, i in zip(xs, ys, inf)]


def deserialize_g1(data: bytes, device):
    """48 bytes -> host affine (x, y) ints, or None for the identity;
    decompressed and subgroup-checked on `device`. Messages as the JAX
    package's single-point form (no index)."""
    return points_to_host(decompress_g1_groups([[data]], device, batch=False)[0])[0]


def serialize_g1(point) -> bytes:
    return bls.g1_compress(point)


def deserialize_g1_batch(points: list[bytes], device) -> list:
    """Compressed points -> host affine points / None, in one decompression
    launch on `device`; a message names the first bad point's index."""
    return points_to_host(decompress_g1_groups([points], device)[0])
