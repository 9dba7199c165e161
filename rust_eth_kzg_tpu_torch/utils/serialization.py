"""Byte codecs between the wire format and limb arrays.

Canonical big-endian scalars (each must be < r), blobs and cells of scalars,
with the validation rules of the consensus specs.
"""

from __future__ import annotations

import numpy as np

from ..constants import BYTES_PER_BLOB, BYTES_PER_CELL, BYTES_PER_FIELD_ELEMENT, R_SCALAR
from ..errors import SerializationError
from ..ops import limbs as L

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
