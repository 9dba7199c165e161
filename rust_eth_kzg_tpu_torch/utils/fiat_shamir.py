"""Fiat-Shamir challenges (SHA-256, host side), byte-exact with the
consensus specs:
- EIP-4844's blob challenge (`compute_blob_challenge`) and the powers of
  its batch verifier's challenge (`compute_r_powers_blob_batch`);
- verify_cell_kzg_proof_batch's challenge, as the reference's FK20
  verifier computes it: the domain separator, the geometry, the counts, the
  deduplicated commitments, then (row index, cell index, cell bytes, proof
  bytes) for every cell, all over the raw input bytes, before any point is
  decompressed.
"""

from __future__ import annotations

import hashlib

from ..constants import (
    BYTES_PER_FIELD_ELEMENT,
    FIAT_SHAMIR_PROTOCOL_DOMAIN,
    RANDOM_CHALLENGE_KZG_BATCH_DOMAIN,
    RANDOM_CHALLENGE_KZG_CELL_BATCH_DOMAIN,
    R_SCALAR,
)
from . import bls_host as bls


def compute_blob_challenge(blob: bytes, commitment: bytes) -> int:
    """EIP-4844's `compute_challenge`: hash(domain || blob width as 16 bytes
    || blob || commitment), reduced mod r."""
    h = hashlib.sha256()
    h.update(FIAT_SHAMIR_PROTOCOL_DOMAIN)
    h.update((len(blob) // BYTES_PER_FIELD_ELEMENT).to_bytes(16, "big"))
    h.update(blob)
    h.update(commitment)
    return bls.reduce_bytes_to_scalar(h.digest())


def compute_r_powers_blob_batch(domain_size: int, commitments, zs, ys, proofs, n: int) -> list[int]:
    """[1, r, ..., r^(n-1)] for verify_blob_kzg_proof_batch, r the hash of
    (domain, width, n, then each blob's commitment, z, y and proof)."""
    h = hashlib.sha256()
    h.update(RANDOM_CHALLENGE_KZG_BATCH_DOMAIN)
    h.update(domain_size.to_bytes(8, "big"))
    h.update(n.to_bytes(8, "big"))
    for c, z, y, pf in zip(commitments, zs, ys, proofs):
        h.update(c)
        h.update(z.to_bytes(32, "big"))
        h.update(y.to_bytes(32, "big"))
        h.update(pf)
    return compute_powers(bls.reduce_bytes_to_scalar(h.digest()), n)


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
