"""Reed-Solomon erasure decoding over the Fr evaluation domain, on torch tensors.

The same decoder as rust_eth_kzg_tpu/models/reed_solomon.py (the reference's
erasure_codes crate): the device part is five NTTs over the codeword domain,
two pointwise products and one batched inversion; only the vanishing
polynomial of the missing block indices, a product of at most
`acceptable_num_block_erasures` roots, is built on the host per blob.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import FR_MULTIPLICATIVE_GENERATOR, R_SCALAR
from ..errors import RecoveryError
from ..ops import field as F
from ..ops import limbs as LB
from ..ops import ntt
from . import cosets

FR = F.FR


def vanishing_poly_host(roots: list[int]) -> list[int]:
    """Monic polynomial with the given roots (coefficients, lowest first)."""
    coeffs = [1]
    for r in roots:
        nxt = [0] * (len(coeffs) + 1)
        for i, c in enumerate(coeffs):
            nxt[i] = (nxt[i] - c * r) % R_SCALAR
            nxt[i + 1] = (nxt[i + 1] + c) % R_SCALAR
        coeffs = nxt
    return coeffs


class ReedSolomon:
    """poly_len coefficients encoded onto an expansion * poly_len domain.

    Block-synchronized erasures: the codeword is `num_blocks` blocks of
    `block_size`; a missing cell removes the same index within every block,
    so the vanishing polynomial of the erasures is Z(X) = z(X^num_blocks)
    with z the vanishing polynomial of the missing block indices' roots.
    """

    def __init__(self, poly_len: int, expansion_factor: int, block_size: int, device):
        if any(x & (x - 1) for x in (poly_len, expansion_factor, block_size)):
            raise ValueError("poly_len, expansion_factor and block_size must be powers of two")
        self.poly_len = poly_len
        self.expansion_factor = expansion_factor
        self.block_size = block_size
        self.device = torch.device(device)
        self.evaluation_domain = ntt.Domain(self.codeword_length, device)

    @property
    def codeword_length(self) -> int:
        return self.poly_len * self.expansion_factor

    @property
    def num_blocks(self) -> int:
        return self.codeword_length // self.block_size

    @property
    def acceptable_num_block_erasures(self) -> int:
        return (self.codeword_length - self.poly_len) // self.num_blocks

    def construct_vanishing_poly_small(self, block_indices: list[int]) -> np.ndarray:
        """Host: the coefficients of z, standard-form limbs [8, nz] with
        nz = acceptable_num_block_erasures + 1 (zero-padded)."""
        for b in block_indices:
            if b >= self.block_size:
                raise RecoveryError(f"invalid block index {b} for block size {self.block_size}")
        if len(block_indices) > self.acceptable_num_block_erasures:
            raise RecoveryError(
                f"{len(block_indices)} block erasures exceed the maximum "
                f"{self.acceptable_num_block_erasures}"
            )
        gen = cosets.domain_generator(self.block_size)
        small = vanishing_poly_host([pow(gen, b, R_SCALAR) for b in block_indices])
        nz = self.acceptable_num_block_erasures + 1
        return LB.ints_to_limbs(small + [0] * (nz - len(small)), FR.nlimbs)

    def spread_vanishing(self, z_small: torch.Tensor) -> torch.Tensor:
        """z [8, *batch, nz] -> Z [8, *batch, codeword_length], z's
        coefficients placed at stride num_blocks (on z's device)."""
        nz = z_small.shape[-1]
        z = torch.zeros(z_small.shape[:-1] + (self.codeword_length,), dtype=z_small.dtype, device=z_small.device)
        z[..., :: self.num_blocks][..., :nz] = z_small
        return z

    def recover_device(self, e_eval: torch.Tensor, z_std: torch.Tensor):
        """e_eval [8, B, n] Montgomery codeword with zeros at the erasures;
        z_std [8, n] (shared) or [8, B, n] standard-form Z coefficients.

        Returns (coefficients [8, B, n] Montgomery, ok [B]); ok is False
        where the recovered polynomial has degree >= poly_len.
        """
        g = FR_MULTIPLICATIVE_GENERATOR
        dom = self.evaluation_domain
        z_x = F.to_mont(FR, z_std)
        if z_x.dim() == 2:
            z_x = z_x[:, None, :]
        ez_eval = F.mont_mul(FR, dom.fft(z_x), e_eval)  # (E Z)(w^i)
        dz_coeffs = dom.ifft(ez_eval)
        dz_coset = dom.coset_fft(dz_coeffs, g)
        z_coset = dom.coset_fft(z_x, g)  # Z has no zero on the coset g H
        z_inv = F.batch_inverse(FR, z_coset.contiguous())
        d_coeffs = dom.coset_ifft(F.mont_mul(FR, dz_coset, z_inv), g)
        ok = torch.all(F.is_zero(FR, d_coeffs[..., self.poly_len :]), dim=-1)
        return d_coeffs, ok

    def recover_polynomial_coefficient(self, e_std: torch.Tensor, z_small: torch.Tensor):
        """The device recovery as the API runs it: e_std [8, B, n] standard-form
        codewords in natural order, zero at the erasures; z_small [8, B, nz]
        standard-form coefficients of each blob's small vanishing polynomial,
        spread on the device at stride num_blocks.

        Returns (coefficients [8, B, poly_len] Montgomery, ok [B]); a blob
        whose ok is False failed the degree check.
        """
        d_coeffs, ok = self.recover_device(F.to_mont(FR, e_std), self.spread_vanishing(z_small))
        return d_coeffs[..., : self.poly_len].contiguous(), ok
