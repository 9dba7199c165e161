"""Single-point KZG opening and its checks (the EIP-4844 core), on torch tensors.

The counterpart of rust_eth_kzg_tpu/models/kzg_single.py (the reference's
kzg_single_open prover and verifier). The prover divides the polynomial by
(X - z) with `poly.divide_by_linear` and commits to the quotient over the
commit key: its fixed-base tables (`msm.fixed_base_msm`) or, without them,
its points (`msm.lincomb`). The verifier checks one opening with host
arithmetic and the native pairing, and a batch of openings with its two
MSMs on the device (`msm.lincomb_host`: GLV ladders on the `g1_add` and
`g1_double` kernels) and the native pairing.
"""

from __future__ import annotations

import torch

from ..constants import R_SCALAR
from ..errors import InvalidProofError
from ..ops import curve as C
from ..ops import msm as M
from ..ops import poly as POLY
from ..utils import bls_host as bls
from ..utils import native
from .fk20 import _broadcast


class SingleOpenProver:
    """Proofs pi = [q(tau)]_1 with q = (f - f(z)) / (X - z), over the commit
    key's fixed-base tables, or its points where there are no tables."""

    def __init__(self, commit_tables: M.FixedBaseMSM | None = None, commit_points: C.G1 | None = None):
        if commit_tables is None and commit_points is None:
            raise ValueError("SingleOpenProver needs the commit key's tables or its points")
        self._tables = commit_tables
        self._points = commit_points

    def compute_kzg_proof(self, poly: torch.Tensor, z: torch.Tensor):
        """poly [8, B, n] Montgomery coefficients, z [8, B] Montgomery ->
        (proofs G1 [B], y = f(z) [8, B]). The quotient's n - 1 coefficients
        and one zero make the n scalars of the commit key's MSM."""
        quotient, y = POLY.divide_by_linear(poly, z)
        zero = torch.zeros(quotient.shape[:-1] + (1,), dtype=quotient.dtype, device=quotient.device)
        padded = torch.cat((quotient, zero), dim=-1)
        if self._tables is not None:
            return M.fixed_base_msm(self._tables, padded), y
        return M.lincomb(_broadcast(self._points, padded), padded), y


class SingleOpenVerifier:
    """Pairing checks of single openings; `device` runs the batch check's MSMs."""

    def __init__(self, gen_g1, gen_g2, tau_g2, device):
        self.gen_g1 = gen_g1
        self.gen_g2 = gen_g2
        self.tau_g2 = tau_g2
        self.device = torch.device(device)
        self._gen_g1_dev = C.points_to_device([gen_g1], device)

    def verify_kzg_proof(self, commitment, z: int, y: int, proof) -> None:
        """e(C - [y]_1, -[1]_2) e(pi, [tau - z]_2) == 1 for host affine points,
        or raise InvalidProofError."""
        lhs_g1 = bls.g1_add(commitment, bls.g1_neg(bls.g1_mul(self.gen_g1, y)))
        rhs_g2 = bls.g2_add(self.tau_g2, bls.g2_neg(bls.g2_mul(self.gen_g2, z)))
        if not native.multi_pairings([(lhs_g1, bls.g2_neg(self.gen_g2)), (proof, rhs_g2)]):
            raise InvalidProofError("KZG proof failed the pairing check")

    def batch_points(self, commitments: C.G1, zs, ys, proofs: C.G1, r_powers):
        """The batch check's two MSMs, one `lincomb_host` call over [2, 2B + 1]
        lanes: lhs = sum r^i C_i - (sum r^i y_i) G + sum r^i z_i pi_i and
        rhs = sum r^i pi_i (its row padded with identity lanes and zero
        scalars). commitments, proofs: G1 [B] on the device. Returns the two
        points as host affine points."""
        n = len(zs)
        if not (commitments.x.shape[1] == proofs.x.shape[1] == len(ys) == len(r_powers) == n):
            raise ValueError("batch_points: commitments, zs, ys, proofs and r_powers differ in length")
        y_lincomb = sum(r * y for r, y in zip(r_powers, ys)) % R_SCALAR
        ident = C.identity((n + 1,), self.device)
        row0 = C._map(lambda c, g, p: torch.cat((c, g, p), dim=1), commitments, self._gen_g1_dev, proofs)
        row1 = C._map(lambda p, i: torch.cat((p, i), dim=1), proofs, ident)
        points = C._map(lambda a, b: torch.stack((a, b), dim=1), row0, row1)
        scalars = [
            list(r_powers) + [(-y_lincomb) % R_SCALAR] + [r * z % R_SCALAR for r, z in zip(r_powers, zs)],
            list(r_powers) + [0] * (n + 1),
        ]
        return C.points_from_device(M.lincomb_host(points, scalars))

    def pairing_check(self, lhs_g1, rhs_g1) -> None:
        """e(lhs, -[1]_2) e(rhs, [tau]_2) == 1, or raise InvalidProofError."""
        if not native.multi_pairings([(lhs_g1, bls.g2_neg(self.gen_g2)), (rhs_g1, self.tau_g2)]):
            raise InvalidProofError("batch KZG proof failed the pairing check")

    def verify_kzg_proof_batch(self, commitments: C.G1, zs, ys, proofs: C.G1, r_powers) -> None:
        """The random-linear-combination check of B openings (the reference's
        verifier.rs): two MSMs on the device, two pairings on the host."""
        self.pairing_check(*self.batch_points(commitments, zs, ys, proofs, r_powers))
