"""FK20 batch verifier of cell proofs, on torch tensors.

The same check as rust_eth_kzg_tpu/models/fk20_verifier.py (the reference's
fk20/verifier.rs). The device part (`verify_device`) decompresses every
commitment and proof with its subgroup check, runs the three random linear
combinations as one batched `lincomb`, interpolates every cell with a 64-point
inverse NTT over its coset, sums the interpolation polynomials weighted by the
challenge powers and commits to the sum with fixed-base tables over the
verifier's SRS. Fiat-Shamir (by the caller) and the closing two-pairing check
(native library) stay on the host. Tensors move plainly: one upload of each
input, one fetch of the four points and the flags. `verify` runs three
stages, `prepare` (host, upload), `verify_device` and `check` (fetch,
flags, pairing); each is a span (`verifier/prepare`, `verifier/check`, and
in `verify_device` `verifier/decompress`, `verifier/lincomb`,
`verifier/interpolate`) that a profile times one by one.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..constants import R_SCALAR
from ..errors import InvalidProofError
from ..ops import curve as C
from ..ops import decompress as D
from ..ops import field as F
from ..ops import msm as M
from ..ops import ntt
from ..utils import bls_host as bls
from ..utils import fiat_shamir as fs
from ..utils import native
from ..utils.tracing import span
from . import cosets

FR = F.FR
FP = F.FP


class FK20Verifier:
    def __init__(self, g1s: list, g2s: list, coset_size: int, num_points_to_open: int, num_cosets: int, device):
        if num_cosets * coset_size != num_points_to_open:
            raise ValueError("num_cosets * coset_size must equal num_points_to_open")
        if len(g2s) <= coset_size:
            raise ValueError("the verifier needs more G2 points than the coset size")
        self.device = torch.device(device)
        self.g1s = g1s
        self.coset_size = coset_size
        self.num_cosets = num_cosets
        self.coset_domain = ntt.Domain(coset_size, device)
        # bit-reversed coset generators h_k, their n-th powers, and the rows
        # h_k^-j that turn each coset's inverse NTT into its interpolation
        self.coset_gens = cosets.coset_gens(num_points_to_open, num_cosets, True)
        self.coset_gens_pow_n = [pow(g, coset_size, R_SCALAR) for g in self.coset_gens]
        scale = []
        for g in self.coset_gens:
            ginv = pow(g, R_SCALAR - 2, R_SCALAR)
            acc = 1
            for _ in range(coset_size):
                scale.append(acc)
                acc = acc * ginv % R_SCALAR
        self.coset_scale = torch.from_numpy(FR.to_mont_host(scale)).reshape(FR.nlimbs, num_cosets, coset_size).to(device)
        self.tau_pow_n_g2 = g2s[coset_size]
        self._commit_tables = None

    @property
    def commit_tables(self) -> M.FixedBaseMSM:
        """Window-8 fixed-base tables over g1s[:coset_size], built on the
        first verify."""
        if self._commit_tables is None:
            pts = C.points_to_device(self.g1s[: self.coset_size], self.device)
            self._commit_tables = M.build_fixed_base_msm(pts, window=8)
        return self._commit_tables

    def padded_size(self, batch: int) -> int:
        """Lanes per point set: the next power of two of the batch, at least
        num_cosets; padding lanes are identity points with zero scalars."""
        return max(1 << max(batch - 1, 0).bit_length(), self.num_cosets)

    def verify(self, unique_commitment_bytes: list[bytes], commitment_indices: list[int],
               coset_indices: list[int], coset_evals_std: np.ndarray, proof_bytes: list[bytes], r: int) -> None:
        """coset_evals_std: [K, coset_size, 8] standard-form limbs; r: the
        Fiat-Shamir challenge over the raw bytes. Raises SerializationError
        for a malformed point, InvalidProofError when the pairing check fails."""
        inputs = self.prepare(unique_commitment_bytes, commitment_indices, coset_indices, coset_evals_std, proof_bytes, r)
        self.check(inputs, verify_device(self, *inputs.tensors))

    @span("verifier/prepare")
    def prepare(self, unique_commitment_bytes, commitment_indices, coset_indices, coset_evals_std, proof_bytes, r):
        """Host stage: byte checks, padding, the three scalar sets, and the
        upload of `verify_device`'s inputs."""
        batch = len(coset_indices)
        n_comm = len(unique_commitment_bytes)
        r_powers = fs.compute_powers(r, batch)
        x_std, sort, inf = D.parse_compressed_g1_batch(list(unique_commitment_bytes) + list(proof_bytes))

        padded = self.padded_size(batch)
        xs = np.zeros((FP.nlimbs, 2 * padded), dtype=np.int32)
        xs[:, :n_comm] = x_std[:, :n_comm]
        xs[:, padded : padded + batch] = x_std[:, n_comm:]
        sort_p = np.zeros(2 * padded, dtype=bool)
        sort_p[:n_comm] = sort[:n_comm]
        sort_p[padded : padded + batch] = sort[n_comm:]
        inf_p = np.ones(2 * padded, dtype=bool)  # padding lanes are the identity
        inf_p[:n_comm] = inf[:n_comm]
        inf_p[padded : padded + batch] = inf[n_comm:]

        # the three scalar sets: r^i over proofs, r^i h_k^n over proofs, and
        # the summed weights of each deduplicated commitment
        weighted = [rp * self.coset_gens_pow_n[ci] % R_SCALAR for rp, ci in zip(r_powers, coset_indices)]
        weights = [0] * n_comm
        for ci, rp in zip(commitment_indices, r_powers):
            weights[ci] = (weights[ci] + rp) % R_SCALAR
        pad_pf, pad_cm = [0] * (padded - batch), [0] * (padded - n_comm)
        scal3 = FR.to_mont_host(r_powers + pad_pf + weighted + pad_pf + weights + pad_cm)
        evals = np.zeros((FR.nlimbs, padded, self.coset_size), dtype=np.int32)
        evals[:, :batch] = np.moveaxis(np.asarray(coset_evals_std, dtype=np.int32), -1, 0)
        cidx = np.zeros(padded, dtype=np.int64)
        cidx[:batch] = coset_indices

        dev = self.device
        tensors = (
            torch.from_numpy(xs).to(dev),
            torch.from_numpy(sort_p).to(dev),
            torch.from_numpy(inf_p).to(dev),
            torch.from_numpy(scal3).reshape(FR.nlimbs, 3, padded).to(dev),
            torch.from_numpy(evals).to(dev),
            torch.from_numpy(FR.to_mont_host(r_powers + pad_pf)).to(dev),
            torch.from_numpy(cidx).to(dev),
        )
        return VerifyInputs(tensors, n_comm, batch, padded)

    @span("verifier/check")
    def check(self, inputs: "VerifyInputs", outputs) -> None:
        """Host stage: fetch the flags and raise for a malformed point (all
        commitments before all proofs, as the reference orders them), then the
        closing two-pairing check on the four fetched points."""
        aff, on_curve, in_sub = outputs
        n_comm, batch, padded = inputs.n_comm, inputs.batch, inputs.padded
        labels = [f"commitment {i}" for i in range(n_comm)] + [f"proof {i}" for i in range(batch)]
        order = list(range(n_comm)) + list(range(padded, padded + batch))
        D.raise_for_flags(on_curve.cpu().numpy()[order], in_sub.cpu().numpy()[order], labels)
        sp, wsp, sc, cip = C.affine_from_device(aff)
        pairing_input = bls.g1_add(bls.g1_add(sc, bls.g1_neg(cip)), wsp)
        if not native.multi_pairings([(sp, self.tau_pow_n_g2), (pairing_input, bls.g2_neg(bls.G2_GEN))]):
            raise InvalidProofError("cell proof batch failed the pairing check")


class VerifyInputs(NamedTuple):
    """`verify_device`'s argument tensors, with the counts that place the
    commitments (lanes [0, n_comm)) and the proofs (lanes [padded, padded +
    batch)) in them."""

    tensors: tuple
    n_comm: int
    batch: int
    padded: int


def verify_device(verifier: FK20Verifier, xs, sort_bits, inf, scal3, evals_std, r_mont, cidx):
    """The device part of a verify.

    xs [12, 2P] standard-form x limbs of [commitments (P lanes) | proofs (P
    lanes)] with their sort and identity flags [2P]; scal3 [8, 3, P]
    Montgomery scalars of the three combinations; evals_std [8, P, coset]
    standard-form cells; r_mont [8, P] Montgomery challenge powers; cidx [P]
    coset indices. Returns (G1Affine [4]: sum r^i proof_i, sum r^i h_k^n
    proof_i, sum w_c commitment_c, the interpolation commitment; on_curve
    [2P]; in_subgroup [2P]).
    """
    padded = cidx.shape[0]
    dev = verifier.device
    with span("verifier/decompress", dev):
        pts, on_curve, in_sub = D.decompress_g1(xs, sort_bits, inf)
    with span("verifier/lincomb", dev):
        comms = C._map(lambda c: c[:, :padded], pts)
        proofs = C._map(lambda c: c[:, padded:], pts)
        pts3 = C._map(lambda cp, cm: torch.stack((cp, cp, cm), dim=1), proofs, comms)  # [12, 3, P]
        sums3 = M.lincomb(pts3, scal3)  # G1 [3]
    with span("verifier/interpolate", dev):
        return _interpolate(verifier, sums3, evals_std, r_mont, cidx), on_curve, in_sub


def _interpolate(verifier: FK20Verifier, sums3: C.G1, evals_std, r_mont, cidx) -> C.G1Affine:
    """The interpolation commitment beside the three sums, all four affine."""
    # interpolate each cell over its coset: un-bit-reverse, inverse NTT,
    # scale row j by h_k^-j, weight by r^i; then a tree sum over the cells
    evals = ntt.bit_reverse_permutation(F.to_mont(FR, evals_std), dim=-1)
    interp = verifier.coset_domain.ifft(evals)  # [8, P, coset]
    interp = F.mont_mul(FR, interp, torch.index_select(verifier.coset_scale, 1, cidx))
    interp = F.mont_mul(FR, interp, r_mont[:, :, None])
    k = interp.shape[1]
    while k > 1:
        h = k // 2
        red = F.add(FR, interp[:, :h], interp[:, h : 2 * h])
        if k % 2:
            red = torch.cat((red, interp[:, -1:]), dim=1)
            k = h + 1
        else:
            k = h
        interp = red
    comm_interp = M.fixed_base_msm(verifier.commit_tables, interp[:, :1].contiguous())  # G1 [1]

    all4 = C._map(lambda s, c: torch.cat((s, c), dim=-1), sums3, comm_interp)
    return C.batch_normalize(all4)
