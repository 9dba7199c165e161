"""The reference put in the program's place: `DASContext`'s three PeerDAS
calls computed from the spec in Python integers, for a setup whose secret tau
is known. Tests drive the harness with it at a small geometry (the
quadratic recovery and the per-proof scalar multiplications make it far too
slow at mainnet sizes), sound and with faults planted.
"""

from __future__ import annotations

from . import kzg as K


class InvalidProofError(Exception):
    """A verify call's inputs are well formed but a proof does not open."""


class StandIn:
    def __init__(self, geom: K.Geometry, tau: int):
        self.geom = geom
        self.tau = tau % K.R

    def _poly_eval(self, coeffs, x):
        acc = 0
        for c in reversed(coeffs):
            acc = (acc * x + c) % K.R
        return acc

    def _prove(self, coeffs: list[int]):
        g = self.geom
        evals = K.fft(coeffs + [0] * (g.ext - g.n), K.root_of_unity(g.ext))
        flat = K.scalars_to_bytes(evals[i] for i in K.bit_reversal(g.ext))
        cells = tuple(flat[k * g.cell_bytes : (k + 1) * g.cell_bytes] for k in range(g.cells))
        f_tau = self._poly_eval(coeffs, self.tau)
        proofs = []
        for ck in g.coset_pow:
            # q_k(tau) = (f(tau) - I_k(tau)) / (tau^m - c_k), I_k = f mod (X^m - c_k)
            rem = [0] * g.m
            p = 1
            for t in range(g.blocks):
                for j in range(g.m):
                    rem[j] = (rem[j] + p * coeffs[t * g.m + j]) % K.R
                p = p * ck % K.R
            den = (pow(self.tau, g.m, K.R) - ck) % K.R
            q = (f_tau - self._poly_eval(rem, self.tau)) * pow(den, K.R - 2, K.R) % K.R
            proofs.append(K.compress(K.scalar_mul(K.G1_GEN, q)))
        return cells, tuple(proofs)

    def blob_to_kzg_commitment(self, blob: bytes) -> bytes:
        coeffs = self.geom.coefficients(K.scalars_from_bytes(blob))
        return K.compress(K.scalar_mul(K.G1_GEN, self._poly_eval(coeffs, self.tau)))

    def compute_cells_and_kzg_proofs_batch(self, blobs):
        return [self._prove(self.geom.coefficients(K.scalars_from_bytes(b))) for b in blobs]

    def _cell_points(self, k: int) -> list[int]:
        g = self.geom
        brp = K.bit_reversal(g.ext)
        w = K.root_of_unity(g.ext)
        return [pow(w, brp[g.m * k + t], K.R) for t in range(g.m)]

    def recover_cells_and_kzg_proofs_batch(self, batches):
        """Each blob's polynomial by Lagrange interpolation through n of its
        known points (quadratic: small geometries only), then proved."""
        g = self.geom
        out = []
        for indices, cells in batches:
            xs, ys = [], []
            for k, cell in zip(indices, cells):
                xs.extend(self._cell_points(k))
                ys.extend(K.scalars_from_bytes(bytes(cell)))
            xs, ys = xs[: g.n], ys[: g.n]
            coeffs = [0] * g.n
            for i, (xi, yi) in enumerate(zip(xs, ys)):
                basis, den = [1], 1
                for j, xj in enumerate(xs):
                    if j != i:
                        basis = [((basis[t - 1] if t else 0) - xj * (basis[t] if t < len(basis) else 0)) % K.R
                                 for t in range(len(basis) + 1)]
                        den = den * (xi - xj) % K.R
                scale = yi * pow(den, K.R - 2, K.R) % K.R
                for t, b in enumerate(basis):
                    coeffs[t] = (coeffs[t] + scale * b) % K.R
            out.append(self._prove(coeffs))
        return out

    def verify_cell_kzg_proof_batch(self, commitments, cell_indices, cells, proofs) -> None:
        """With tau known the pairing equation is one in G1:
        (tau^m - c_k) pi = C - [I_k(tau)]_1."""
        g = self.geom
        inv_m = pow(g.m, K.R - 2, K.R)
        for c, k, cell, pf in zip(commitments, cell_indices, cells, proofs):
            ys = K.scalars_from_bytes(bytes(cell))
            pts = self._cell_points(k)
            # the interpolant through the cell's points, evaluated at tau by the
            # barycentric formula over the coset h <w_m>
            hm = g.coset_pow[k]
            i_tau = 0
            for x, y in zip(pts, ys):
                i_tau = (i_tau + y * x * pow((self.tau - x) % K.R, K.R - 2, K.R)) % K.R
            i_tau = i_tau * (pow(self.tau, g.m, K.R) - hm) % K.R * inv_m % K.R * pow(hm, K.R - 2, K.R) % K.R
            lhs = K.scalar_mul(K.decompress(bytes(pf)), (pow(self.tau, g.m, K.R) - hm) % K.R)
            cpt = K.decompress(bytes(c))
            rhs = K.to_affine(K._add(K.INF if cpt is None else (cpt[0], cpt[1], 1),
                                     _neg(K.scalar_mul(K.G1_GEN, i_tau))))
            if lhs != rhs:
                raise InvalidProofError("a cell proof does not open its commitment")


def _neg(point):
    if point is None:
        return K.INF
    return point[0], (-point[1]) % K.P, 1
