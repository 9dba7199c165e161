"""Horner evaluation and division by (X - z) over Fr coefficient tensors.

The same recurrences as rust_eth_kzg_tpu/ops/poly.py: fed the coefficients
from the top, Horner's step acc -> z acc + c is an affine map, and the
running values of that recurrence are the Ruffini quotient's coefficients,
the last one f(z). JAX composes the maps with an associative scan; here
every map has the same multiplier z, so a composition of 2^j consecutive
maps multiplies by z^(2^j), the same on every lane, and the scans carry only
the offsets:
- `divide_by_linear` runs the Hillis-Steele inclusive scan, log2(N) steps
  of a <- a + z^(2^j) shift(a, 2^j);
- `poly_eval` needs only the whole composition and runs the reduce phase
  of a Blelloch scan: log2(N) levels c'_i = c_2i + z^(2^j) c_2i+1, each half
  the length of the last.
Each step is one `field.mont_mul` (the `mont_mul` kernel on CUDA tensors,
its plain version on CPU tensors) and one `field.add`; the powers
z^(2^j) are log2(N) - 1 squarings of z.
"""

from __future__ import annotations

import torch

from . import field as F

FR = F.FR


def _square_chain(z: torch.Tensor, steps: int) -> list[torch.Tensor]:
    """[z, z^2, z^4, ..., z^(2^(steps-1))] for z [8, *batch] (Montgomery)."""
    powers = [z]
    for _ in range(steps - 1):
        powers.append(F.mont_mul(FR, powers[-1], powers[-1]))
    return powers


def poly_eval(coeffs: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """sum_i c_i z^i for coeffs [8, *batch, N] and z [8, *batch] (Montgomery)
    -> [8, *batch]. N is padded with zero coefficients to a power of two."""
    n = coeffs.shape[-1]
    if n == 0:
        return torch.zeros_like(z)
    levels = max(n - 1, 0).bit_length()
    if n != 1 << levels:
        pad = torch.zeros(coeffs.shape[:-1] + ((1 << levels) - n,), dtype=coeffs.dtype, device=coeffs.device)
        coeffs = torch.cat((coeffs, pad), dim=-1)
    for zp in _square_chain(z, levels) if levels else []:
        c = coeffs.reshape(coeffs.shape[:-1] + (-1, 2))
        coeffs = F.add(FR, c[..., 0], F.mont_mul(FR, c[..., 1], zp[..., None]))
    return coeffs[..., 0]


def divide_by_linear(coeffs: torch.Tensor, z: torch.Tensor):
    """f(X) / (X - z) by synthetic division: coeffs [8, *batch, N] and z
    [8, *batch] (Montgomery) -> (quotient [8, *batch, N - 1], lowest
    coefficient first; remainder [8, *batch] = f(z)), f = q (X - z) + f(z).

    a_k = c_(N-1-k) scanned as s_k = a_k + z s_(k-1): s_k = q_(N-2-k) for
    k < N - 1 and s_(N-1) = f(z).
    """
    n = coeffs.shape[-1]
    a = torch.flip(coeffs, (-1,))
    steps = max(n - 1, 0).bit_length()
    for j, zp in enumerate(_square_chain(z, steps) if steps else []):
        d = 1 << j
        a = torch.cat((a[..., :d], F.add(FR, a[..., d:], F.mont_mul(FR, a[..., :-d], zp[..., None]))), dim=-1)
    return torch.flip(a[..., : n - 1], (-1,)), a[..., n - 1]
