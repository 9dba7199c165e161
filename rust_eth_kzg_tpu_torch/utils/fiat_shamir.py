"""Fiat-Shamir challenge of verify_cell_kzg_proof_batch (SHA-256, host side).

Byte-exact with the consensus specs and the reference's FK20 verifier: the
domain separator, the geometry, the counts, the deduplicated commitments,
then (row index, cell index, cell bytes, proof bytes) for every cell, all
over the raw input bytes, before any point is decompressed.
"""

from __future__ import annotations

import hashlib

from ..constants import RANDOM_CHALLENGE_KZG_CELL_BATCH_DOMAIN, R_SCALAR
from . import bls_host as bls


def compute_cell_batch_challenge(
    num_coefficients: int,
    coset_size: int,
    row_commitments: list[bytes],
    row_indices: list[int],
    coset_indices: list[int],
    coset_evals: list[bytes],
    proofs: list[bytes],
) -> int:
    """Challenge for verify_cell_kzg_proof_batch (RCKZGCBATCH__V1_)."""
    h = hashlib.sha256()
    h.update(RANDOM_CHALLENGE_KZG_CELL_BATCH_DOMAIN)
    h.update(num_coefficients.to_bytes(8, "big"))
    h.update(coset_size.to_bytes(8, "big"))
    h.update(len(row_commitments).to_bytes(8, "big"))
    h.update(len(coset_indices).to_bytes(8, "big"))
    for c in row_commitments:
        h.update(c)
    for k in range(len(coset_indices)):
        h.update(int(row_indices[k]).to_bytes(8, "big"))
        h.update(int(coset_indices[k]).to_bytes(8, "big"))
        h.update(coset_evals[k])
        h.update(proofs[k])
    return bls.reduce_bytes_to_scalar(h.digest())


def compute_powers(value: int, n: int) -> list[int]:
    """[1, value, value^2, ..., value^(n-1)] mod r."""
    powers = []
    acc = 1
    for _ in range(n):
        powers.append(acc)
        acc = acc * value % R_SCALAR
    return powers
