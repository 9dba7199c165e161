"""Plain reference of the PeerDAS calls that the benchmark judges.

Written from the consensus specs (Fulu, polynomial-commitments-sampling.md:
`compute_cells_and_kzg_proofs`, `recover_cells_and_kzg_proofs`,
`verify_cell_kzg_proof_batch`) in Python integers: BLS12-381's G1 in Jacobian
coordinates, the scalar field's roots of unity and radix-2 transforms. It
imports nothing of the program under test and takes nothing it made: it reads
the blobs the benchmark made and the trusted setup's raw JSON, and the
program's outputs only to judge them.

What is compared, for each blob of a judged call:
- cells: all of them, byte for byte, against the blob's extension computed
  here (an inverse transform of the blob and a transform over the extended
  domain, in the spec's bit-reversed order);
- proofs: all of them at once, through a random linear combination. With
  r_k and rho_i random 64-bit numbers drawn from the run's seed,
  sum_{i,k} rho_i r_k pi_ik must equal [Q(tau)]_1, where
  Q = sum_i rho_i sum_k r_k q_ik and q_ik is the quotient of blob i's
  polynomial by X^m - h_k^m (h_k the shift of cell k's coset): the proof the
  spec defines is [q_ik(tau)]_1. [Q(tau)]_1 is an MSM over the setup's
  monomial G1 points. A wrong proof passes only if the random combination
  cancels it: for one wrong proof, probability 2^-64 at most.
- commitments (verify calls): sum_i sigma_i C_i = [sum_i sigma_i f_i(tau)]_1,
  folded into the same check.

A verify call's verdict here is "valid" iff every cell equals the truth of its
blob, and every proof and commitment is the one the spec computes from the
blob. That is the pairing check's verdict for every input that can be made
without the setup's secret tau: for a commitment to f and a cell's values, at
most one point passes the pairing equation, and for values other than f's it
is one that only tau can compute. So no pairing is needed.

Points are decompressed with the on-curve check only: a point off the
prime-order subgroup would have to differ from the true proof by a torsion
point exactly, which no arithmetic fault produces.
"""

from __future__ import annotations

import json
import random

P = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB
R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001
G1_GEN = (
    0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB,
    0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1,
)
PRIMITIVE_ROOT = 7  # the spec's PRIMITIVE_ROOT_OF_UNITY
FE_BYTES = 32
INF = (1, 1, 0)  # Jacobian identity
_SQRT_EXP = (P + 1) // 4
_HALF_P = (P - 1) // 2


# ------------------------------------------------------------ the scalar field


def root_of_unity(n: int) -> int:
    return pow(PRIMITIVE_ROOT, (R - 1) // n, R)


def bit_reversal(n: int) -> list[int]:
    bits = n.bit_length() - 1
    return [int(format(i, f"0{bits}b")[::-1], 2) if bits else 0 for i in range(n)]


def fft(values: list[int], omega: int) -> list[int]:
    """out[i] = sum_j values[j] omega^(i j), natural order in and out."""
    n = len(values)
    a = [values[i] for i in bit_reversal(n)]
    size = 2
    while size <= n:
        half = size // 2
        step = pow(omega, n // size, R)
        ws = [1] * half
        for j in range(1, half):
            ws[j] = ws[j - 1] * step % R
        for start in range(0, n, size):
            for j in range(half):
                u = a[start + j]
                v = a[start + j + half] * ws[j] % R
                a[start + j] = (u + v) % R
                a[start + j + half] = (u - v) % R
        size *= 2
    return a


def scalars_from_bytes(data: bytes) -> list[int]:
    """32-byte big-endian scalars; raises ValueError on one that is not canonical."""
    if len(data) % FE_BYTES:
        raise ValueError(f"{len(data)} bytes is not a whole number of scalars")
    out = [int.from_bytes(data[i : i + FE_BYTES], "big") for i in range(0, len(data), FE_BYTES)]
    if any(v >= R for v in out):
        raise ValueError("scalar is not canonical")
    return out


def scalars_to_bytes(values) -> bytes:
    return b"".join(v.to_bytes(FE_BYTES, "big") for v in values)


class Geometry:
    """A blob of n scalars, extended by `expansion`, cut into cells of m."""

    def __init__(self, poly_len: int, cell_size: int, expansion: int = 2):
        self.n, self.m = poly_len, cell_size
        self.ext = poly_len * expansion
        self.cells = self.ext // cell_size
        self.blocks = poly_len // cell_size
        self.blob_bytes = poly_len * FE_BYTES
        self.cell_bytes = cell_size * FE_BYTES
        brp_ext = bit_reversal(self.ext)
        w_ext = root_of_unity(self.ext)
        # cell k's coset is h_k <w_m>, h_k = w_ext^brp(m k); X^m - h_k^m vanishes on it
        self.coset_pow = [pow(w_ext, brp_ext[self.m * k] * self.m, R) for k in range(self.cells)]

    def coefficients(self, blob_values: list[int]) -> list[int]:
        """A blob (evaluations at the bit-reversed n-th roots) -> its coefficients."""
        n = self.n
        natural = [blob_values[i] for i in bit_reversal(n)]
        inv_n = pow(n, R - 2, R)
        return [c * inv_n % R for c in fft(natural, pow(root_of_unity(n), R - 2, R))]

    def cells_of(self, blob: bytes) -> list[bytes]:
        """The spec's cells of one blob: its extension, bit-reversed, cut in cells."""
        coeffs = self.coefficients(scalars_from_bytes(blob))
        evals = fft(coeffs + [0] * (self.ext - self.n), root_of_unity(self.ext))
        flat = scalars_to_bytes(evals[i] for i in bit_reversal(self.ext))
        return [flat[k * self.cell_bytes : (k + 1) * self.cell_bytes] for k in range(self.cells)]

    def quotient_combination(self, coeffs: list[int], r: list[int]) -> list[int]:
        """sum_k r_k q_k, q_k the quotient of the polynomial `coeffs` by
        X^m - c_k (c_k = h_k^m): with F_t the t-th block of m coefficients,
        q_k's block s is sum_{t > s} c_k^(t-1-s) F_t."""
        m, nb = self.m, self.blocks
        g = [0] * (nb - 1)  # g_d = sum_k r_k c_k^d
        for rk, ck in zip(r, self.coset_pow):
            p = rk
            for d in range(nb - 1):
                g[d] = (g[d] + p) % R
                p = p * ck % R
        out = [0] * (self.n - m)
        for s in range(nb - 1):
            acc = [0] * m
            for t in range(s + 1, nb):
                gd = g[t - 1 - s]
                block = coeffs[t * m : (t + 1) * m]
                for j in range(m):
                    acc[j] += gd * block[j]
            out[s * m : (s + 1) * m] = [v % R for v in acc]
        return out


# ------------------------------------------------------------------------ G1


def decompress(data: bytes):
    """A compressed G1 point -> affine (x, y), or None for the identity.
    Raises ValueError on malformed bytes or an x off the curve."""
    if len(data) != 48:
        raise ValueError(f"G1 point has {len(data)} bytes, not 48")
    flags = data[0]
    if not flags & 0x80:
        raise ValueError("G1 point is not in compressed form")
    if flags & 0x40:
        if flags & 0x3F or any(data[1:]):
            raise ValueError("malformed G1 identity")
        return None
    x = int.from_bytes(bytes([flags & 0x1F]) + data[1:], "big")
    if x >= P:
        raise ValueError("G1 x coordinate is not canonical")
    y2 = (x * x * x + 4) % P
    y = pow(y2, _SQRT_EXP, P)
    if y * y % P != y2:
        raise ValueError("G1 x coordinate is not on the curve")
    if bool(flags & 0x20) != (y > _HALF_P):
        y = P - y
    return x, y


def compress(point) -> bytes:
    if point is None:
        return bytes([0xC0]) + bytes(47)
    x, y = point
    out = bytearray(x.to_bytes(48, "big"))
    out[0] |= 0x80 | (0x20 if y > _HALF_P else 0)
    return bytes(out)


def decompress_many(items: list[bytes]) -> list:
    """Each point (None for the identity), or False for malformed bytes: a
    wrong answer, not an error."""
    out = []
    for b in items:
        try:
            out.append(decompress(bytes(b)))
        except ValueError:
            out.append(False)
    return out


def _dbl(p):
    X, Y, Z = p
    if Z == 0 or Y == 0:
        return INF
    A = X * X % P
    B = Y * Y % P
    C = B * B % P
    D = 2 * ((X + B) * (X + B) - A - C) % P
    E = 3 * A % P
    X3 = (E * E - 2 * D) % P
    return X3, (E * (D - X3) - 8 * C) % P, 2 * Y * Z % P


def _madd(p, q):
    """Jacobian p + affine q."""
    X1, Y1, Z1 = p
    x2, y2 = q
    if Z1 == 0:
        return x2, y2, 1
    Z1Z1 = Z1 * Z1 % P
    H = (x2 * Z1Z1 - X1) % P
    rr = 2 * (y2 * Z1 * Z1Z1 - Y1) % P
    if H == 0:
        return _dbl(p) if rr == 0 else INF
    HH = H * H % P
    I = 4 * HH % P
    J = H * I % P
    V = X1 * I % P
    X3 = (rr * rr - J - 2 * V) % P
    return X3, (rr * (V - X3) - 2 * Y1 * J) % P, ((Z1 + H) * (Z1 + H) - Z1Z1 - HH) % P


def _add(p, q):
    X1, Y1, Z1 = p
    X2, Y2, Z2 = q
    if Z1 == 0:
        return q
    if Z2 == 0:
        return p
    Z1Z1 = Z1 * Z1 % P
    Z2Z2 = Z2 * Z2 % P
    U1 = X1 * Z2Z2 % P
    S1 = Y1 * Z2 * Z2Z2 % P
    H = (X2 * Z1Z1 - U1) % P
    rr = 2 * (Y2 * Z1 * Z1Z1 - S1) % P
    if H == 0:
        return _dbl(p) if rr == 0 else INF
    I = 4 * H * H % P
    J = H * I % P
    V = U1 * I % P
    X3 = (rr * rr - J - 2 * V) % P
    return X3, (rr * (V - X3) - 2 * S1 * J) % P, ((Z1 + Z2) * (Z1 + Z2) - Z1Z1 - Z2Z2) * H % P


def to_affine(p):
    X, Y, Z = p
    if Z == 0:
        return None
    zi = pow(Z, P - 2, P)
    zi2 = zi * zi % P
    return X * zi2 % P, Y * zi2 * zi % P


def scalar_mul(point, k: int):
    """Affine point times k (double and add), affine out."""
    acc = INF
    if point is None:
        return None
    for bit in bin(k % R)[2:]:
        acc = _dbl(acc)
        if bit == "1":
            acc = _madd(acc, point)
    return to_affine(acc)


def _window(n: int, bits: int) -> int:
    best, best_cost = 1, None
    for c in range(1, 17):
        cost = -(-bits // c) * (n + 2 * (1 << c))
        if best_cost is None or cost < best_cost:
            best, best_cost = c, cost
    return best


def msm_jacobian(points: list, scalars: list[int]):
    """sum_i scalars[i] points[i] by Pippenger's buckets; affine points
    (None for the identity), scalars >= 0; Jacobian out."""
    pairs = [(pt, s) for pt, s in zip(points, scalars) if pt is not None and s]
    if not pairs:
        return INF
    bits = max(s.bit_length() for _, s in pairs)
    c = _window(len(pairs), bits)
    mask = (1 << c) - 1
    acc = INF
    for w in reversed(range(-(-bits // c))):
        for _ in range(c):
            acc = _dbl(acc)
        buckets = [INF] * (mask + 1)
        shift = w * c
        for pt, s in pairs:
            d = (s >> shift) & mask
            if d:
                buckets[d] = _madd(buckets[d], pt)
        running = total = INF
        for d in range(mask, 0, -1):
            running = _add(running, buckets[d])
            total = _add(total, running)
        acc = _add(acc, total)
    return acc


def _msm_task(args):
    return msm_jacobian(*args)


def msm(points: list, scalars: list[int], pool=None):
    """sum_i scalars[i] points[i], affine out; over `pool`'s workers in chunks."""
    if pool is None or len(points) < 64:
        return to_affine(msm_jacobian(points, scalars))
    parts = pool._processes
    step = -(-len(points) // parts)
    chunks = [(points[i : i + step], scalars[i : i + step]) for i in range(0, len(points), step)]
    acc = INF
    for part in pool.map(_msm_task, chunks):
        acc = _add(acc, part)
    return to_affine(acc)


def decompress_all(items: list[bytes], pool=None) -> list:
    if pool is None or len(items) < 64:
        return decompress_many(items)
    step = -(-len(items) // (4 * pool._processes))
    out = []
    for part in pool.map(decompress_many, [items[i : i + step] for i in range(0, len(items), step)]):
        out.extend(part)
    return out


# ------------------------------------------------------------- the setup


def load_setup_g1(path: str, count: int, pool=None) -> list:
    """The first `count` monomial G1 points of a trusted setup JSON (the
    consensus specs' format: hex strings under "g1_monomial")."""
    with open(path) as fh:
        raw = json.load(fh)["g1_monomial"][:count]
    pts = decompress_all([bytes.fromhex(h[2:] if h.startswith("0x") else h) for h in raw], pool)
    if any(p is False for p in pts):
        raise ValueError(f"{path}: a monomial G1 point does not decompress")
    return pts


def insecure_setup_g1(count: int, tau: int) -> list:
    """[tau^i]_1 for i < count: a setup whose secret is known (tests only)."""
    pts, s = [], 1
    for _ in range(count):
        pts.append(scalar_mul(G1_GEN, s))
        s = s * tau % R
    return pts


# ------------------------------------------------------------ the judgement


def _cells_task(args):
    """(geometry sizes, blob, the program's cells) -> the number of cells that differ."""
    (n, m, e), blob, cells = args
    truth = Geometry(n, m, e).cells_of(blob)
    try:
        if len(cells) != len(truth):
            return len(truth)
        return sum(1 for a, b in zip(cells, truth) if bytes(a) != b)
    except TypeError:  # not a sequence of byte strings: every cell is wrong
        return len(truth)


def cells_wrong(geom: Geometry, blobs: list[bytes], cells: list, pool=None) -> list[int]:
    """For each blob, how many of the program's cells differ from the spec's."""
    tasks = [((geom.n, geom.m, geom.ext // geom.n), b, c) for b, c in zip(blobs, cells)]
    return list(pool.map(_cells_task, tasks)) if pool is not None else [_cells_task(t) for t in tasks]


class Judge:
    """The reference's side of one run: the geometry, the setup's first
    n - m monomial points (n for commitments), and the run's randomness."""

    def __init__(self, geom: Geometry, setup_g1: list, seed: int):
        self.geom = geom
        self.setup_g1 = setup_g1
        self.rng = random.Random(f"kzgbench-judge-{seed}")

    def _rand(self) -> int:
        return self.rng.getrandbits(64) | 1

    def openings_hold(self, blobs: list[bytes], proofs: list, commitments: list | None = None, pool=None) -> bool:
        """Whether every proof of every blob (proofs[i][k], compressed, of cell
        k) and, if given, every commitment (commitments[i], compressed) is the
        one the spec computes from the blob: one random linear combination."""
        g = self.geom
        r = [self._rand() for _ in range(g.cells)]
        rho = [self._rand() for _ in blobs]
        flat = []
        try:
            for p in proofs:
                if len(p) != g.cells:
                    return False
                flat.extend(bytes(b) for b in p)
        except TypeError:
            return False
        sigma = [self._rand() for _ in blobs] if commitments is not None else []
        if commitments is not None:
            flat.extend(bytes(c) for c in commitments)
        points = decompress_all(flat, pool)
        if any(pt is False for pt in points):
            return False
        scalars = [ri * rk for ri in rho for rk in r] + sigma
        # the same combination of the blobs' polynomials: rho for the
        # quotients, sigma for the commitments (linear in the evaluations)
        def combine(weights):
            agg = [0] * g.n
            for w, blob in zip(weights, blobs):
                for j, v in enumerate(scalars_from_bytes(blob)):
                    agg[j] += w * v
            return g.coefficients([v % R for v in agg])

        poly = g.quotient_combination(combine(rho), r) + [0] * g.m
        if commitments is not None:
            poly = [(a + b) % R for a, b in zip(poly, combine(sigma))]
        lhs = msm(points, scalars, pool)
        rhs = msm(self.setup_g1[: len(poly)], poly, pool)
        return lhs == rhs
