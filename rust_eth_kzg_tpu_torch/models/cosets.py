"""Coset bookkeeping of the cell layout: generators and evaluation-order
recovery, on the host.

A copy of rust_eth_kzg_tpu/models/cosets.py (the reference's fk20/cosets.rs):
O(domain) index manipulations done once per call; the field work stays on
the device.
"""

from __future__ import annotations

import numpy as np

from ..constants import R_SCALAR, ROOT_OF_UNITY, TWO_ADICITY
from ..ops.ntt import bitrev_indices


def reverse_bits(n: int, bits: int) -> int:
    out = 0
    for b in range(bits):
        out |= ((n >> b) & 1) << (bits - 1 - b)
    return out


def domain_generator(size: int) -> int:
    """Generator of the multiplicative subgroup of order `size` (a power of two)."""
    return pow(ROOT_OF_UNITY, 1 << (TWO_ADICITY - (size.bit_length() - 1)), R_SCALAR)


def coset_gens(num_points: int, num_cosets: int, bit_reversed: bool) -> list[int]:
    """Generator h_k of the k-th coset of the num_points domain."""
    gen = domain_generator(num_points)
    bits = num_cosets.bit_length() - 1
    out = []
    for i in range(num_cosets):
        exp = reverse_bits(i, bits) if bit_reversed else i
        out.append(pow(gen, exp, R_SCALAR))
    return out


def recover_evaluations_in_domain_order(
    domain_size: int, coset_indices: list[int], coset_evaluations: np.ndarray
):
    """Scatter bit-reversed cells back into natural domain order.

    coset_evaluations: [K, coset_len, ...] rows of any dtype (only positions
    move). Returns (new_coset_indices, elements [domain_size, ...]) with the
    missing positions zero-filled, or None if the inputs are inconsistent.
    """
    if len(coset_indices) == 0:
        return None
    coset_evaluations = np.asarray(coset_evaluations)
    k, coset_len = coset_evaluations.shape[:2]
    if k != len(coset_indices):
        return None
    coset_capacity = domain_size // coset_len
    if any(i >= coset_capacity for i in coset_indices):
        return None

    elements = np.zeros((domain_size,) + coset_evaluations.shape[2:], dtype=coset_evaluations.dtype)
    for idx, evals in zip(coset_indices, coset_evaluations):
        start = idx * coset_len
        elements[start : start + coset_len] = evals
    # un-bit-reverse the whole domain ordering
    elements = elements[bitrev_indices(domain_size)]

    bits = coset_capacity.bit_length() - 1
    new_indices = [reverse_bits(i, bits) for i in coset_indices]
    return new_indices, elements
