"""Public API of the port: `DASContext` (EIP-7594, PeerDAS) and
`Context4844` (EIP-4844).

`DASContext`: the prover calls (`compute_cells_and_kzg_proofs(_batch)`,
`compute_cells`, `blob_to_kzg_commitment`), erasure recovery
(`recover_cells_and_kzg_proofs(_batch)`), cell-proof batch verification
(`verify_cell_kzg_proof_batch`), the five EIP-4844 calls of its `eip4844`
context, and the snapshot of its tables (`table_cache`, `save_tables`,
`load_tables`). `Context4844`: `blob_to_kzg_commitment`,
`compute_kzg_proof`, `compute_blob_kzg_proof`, `verify_kzg_proof`,
`verify_blob_kzg_proof` and `verify_blob_kzg_proof_batch`. Function names,
validation order and error semantics mirror rust_eth_kzg_tpu/api.py (and
through it the reference's eip7594 and eip4844 crates): raw bytes in, raw
bytes out. `device` picks the card; it defaults to "cuda" and a context
never falls back to the CPU on its own.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from . import constants as CONST
from .errors import ProverError, RecoveryError, SerializationError, VerifierError
from .models import cosets
from .models.fk20 import FK20Config, FK20Prover, recover_and_prove
from .models.fk20_verifier import FK20Verifier
from .models.kzg_single import SingleOpenProver, SingleOpenVerifier
from .models.reed_solomon import ReedSolomon
from .ops import curve as C
from .ops import field as F
from .ops import poly as POLY
from .parallel import mesh as PM
from .utils import bls_host as bls
from .utils import fiat_shamir as fs
from .utils import persist
from .utils import serialization as ser
from .utils.tracing import span
from .utils.trusted_setup import TrustedSetup

FR = F.FR


def resolve_device(device=None) -> torch.device:
    """`None` means "cuda"; a CUDA device without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
    return dev


def cells_bytes_from_std(arr: np.ndarray) -> list[tuple[bytes, ...]]:
    """Standard-form limbs [8, B, K, M] -> per-blob tuples of cell bytes."""
    nl, b, k, m = arr.shape
    out = []
    for i in range(b):
        flat = ser.serialize_scalars(arr[:, i].reshape(nl, k * m))
        step = m * CONST.BYTES_PER_FIELD_ELEMENT
        out.append(tuple(flat[j * step : (j + 1) * step] for j in range(k)))
    return out


def proofs_bytes(aff: C.G1Affine, b: int, k: int) -> list[tuple[bytes, ...]]:
    """Affine proofs [B, K] -> per-blob tuples of compressed proofs."""
    pts = C.affine_from_device(aff)
    return [tuple(bls.g1_compress(pts[i * k + j]) for j in range(k)) for i in range(b)]


def recover_inputs(config: FK20Config, cell_indices, cells):
    """Validate one blob's recovery input (the reference's recovery.rs
    order) -> (codeword std limbs [8, ext] in natural order, zero at the
    erasures; the missing block indices)."""
    num_cells = config.num_proofs
    if len(cell_indices) != len(cells):
        raise RecoveryError(
            f"number of cell indices ({len(cell_indices)}) does not match number of cells ({len(cells)})"
        )
    for idx in cell_indices:
        if idx >= num_cells:
            raise RecoveryError(f"cell index {idx} out of range (max {num_cells})")
    if any(b >= a for a, b in zip(cell_indices[1:], cell_indices)):
        raise RecoveryError("cell indices must be unique and sorted")
    min_needed = num_cells // config.expansion
    if len(cell_indices) < min_needed:
        raise RecoveryError(f"not enough cells to reconstruct: got {len(cells)}, need at least {min_needed}")
    if len(cell_indices) > num_cells:
        raise RecoveryError(f"too many cells: got {len(cells)}, max {num_cells}")
    cell_limbs = ser.deserialize_cells_batch(cells, config.coset_size * CONST.BYTES_PER_FIELD_ELEMENT)
    indices_normal, flat = cosets.recover_evaluations_in_domain_order(config.ext_size, list(cell_indices), cell_limbs)
    present = set(indices_normal)
    missing = [i for i in range(num_cells) if i not in present]
    return np.ascontiguousarray(flat.T), missing


class _BlobContext:
    """What `DASContext` and `Context4844` share: the blob codec at the
    prover's geometry and the commitment. Subclasses set `config`, `device`
    and `prover`."""

    config: FK20Config
    device: torch.device
    prover: FK20Prover

    def _blob(self, blob: bytes) -> np.ndarray:
        """One blob -> standard-form limbs [8, poly_len]: at mainnet geometry
        the blob codec (its length message names bytes), else the scalar
        codec at the configured length."""
        if self.config.poly_len == CONST.FIELD_ELEMENTS_PER_BLOB:
            return ser.deserialize_blob(blob)
        return ser.deserialize_scalars(blob, self.config.poly_len)

    def _data(self, blobs: list[bytes]) -> torch.Tensor:
        """Blobs -> Montgomery scalars [8, B, poly_len] on the device."""
        std = np.stack([self._blob(b) for b in blobs], axis=1)
        return F.to_mont(FR, torch.from_numpy(std).to(self.device))

    def blob_to_kzg_commitment(self, blob: bytes) -> bytes:
        commitment = self.prover.commit_from_data(self._data([blob]))
        return bls.g1_compress(C.points_from_device(commitment)[0])


def _deserialize_scalar_checked(data: bytes) -> int:
    """32 big-endian bytes -> a canonical scalar, with the JAX package's messages."""
    if len(data) != CONST.BYTES_PER_FIELD_ELEMENT:
        raise SerializationError(f"scalar has invalid length {len(data)}, expected 32")
    value = int.from_bytes(data, "big")
    if value >= CONST.R_SCALAR:
        raise SerializationError("scalar is not canonical")
    return value


class Context4844(_BlobContext):
    """EIP-4844 blob calls over an FK20 prover's commit key and a setup's
    generators (the reference's eip4844 crate).

    Proofs divide the blob's polynomial by (X - z) on the device and commit
    to the quotient through the commit key (`SingleOpenProver`); one
    opening is checked with host arithmetic and the native pairing, a batch
    with two MSMs on the device and two pairings (`SingleOpenVerifier`).
    Points are decompressed on the device, one launch a call. A setup
    without G2 points serves the prover calls only.
    """

    def __init__(self, prover: FK20Prover, setup: TrustedSetup | None = None):
        self.prover = prover
        self.config = prover.config
        self.device = prover.device
        self.verifier = None
        if setup is not None and len(setup.g2_monomial) >= 2:
            self.verifier = SingleOpenVerifier(setup.g1_monomial[0], setup.g2_monomial[0], setup.g2_monomial[1],
                                               self.device)

    def _prover(self) -> SingleOpenProver:
        # read at each call: load_tables may replace the prover's tables
        return SingleOpenProver(self.prover.commit_tables, self.prover.commit_points)

    def _verifier(self) -> SingleOpenVerifier:
        if self.verifier is None:
            raise ValueError("this context's trusted setup has no G2 points: it cannot verify")
        return self.verifier

    def _z(self, zs: list[int]) -> torch.Tensor:
        return torch.from_numpy(FR.to_mont_host(zs)).to(self.device)

    def _open(self, data: torch.Tensor, z: int):
        """(proof bytes, y) of one blob's polynomial at z; data [8, 1, n]."""
        poly = self.prover.blob_to_poly(data)
        proof, y = self._prover().compute_kzg_proof(poly, self._z([z]))
        return bls.g1_compress(C.points_from_device(proof)[0]), FR.from_mont_host(y.cpu().numpy())[0]

    # --- prover ---

    def compute_kzg_proof(self, blob: bytes, z: bytes) -> tuple[bytes, bytes]:
        """(proof, y = f(z)) of the blob's polynomial f at the scalar z."""
        data = self._data([blob])
        proof, y = self._open(data, _deserialize_scalar_checked(z))
        return proof, y.to_bytes(32, "big")

    def compute_blob_kzg_proof(self, blob: bytes, commitment: bytes) -> bytes:
        """The proof at the blob's Fiat-Shamir challenge; the commitment is
        checked (decompression, subgroup) but not recomputed."""
        data = self._data([blob])
        ser.decompress_g1_groups([[commitment]], self.device, batch=False)
        return self._open(data, fs.compute_blob_challenge(blob, commitment))[0]

    # --- verifier ---

    def _pair(self, commitment: bytes, proof: bytes):
        """A commitment and a proof, decompressed in one launch, as host points."""
        groups = ser.decompress_g1_groups([[commitment], [proof]], self.device, batch=False)
        return tuple(ser.points_to_host(g)[0] for g in groups)

    def verify_kzg_proof(self, commitment: bytes, z: bytes, y: bytes, proof: bytes) -> None:
        """None if the proof opens the commitment to y at z; SerializationError
        for malformed bytes, InvalidProofError for a failed check."""
        verifier = self._verifier()
        c, pf = self._pair(commitment, proof)
        z_int, y_int = _deserialize_scalar_checked(z), _deserialize_scalar_checked(y)
        verifier.verify_kzg_proof(c, z_int, y_int, pf)

    def verify_blob_kzg_proof(self, blob: bytes, commitment: bytes, proof: bytes) -> None:
        verifier = self._verifier()
        c, pf = self._pair(commitment, proof)
        z = self.challenges([blob], [commitment])[0]
        verifier.verify_kzg_proof(c, z, self.evaluate([blob], [z])[0], pf)

    def verify_blob_kzg_proof_batch(self, blobs: list[bytes], commitments: list[bytes], proofs: list[bytes]) -> None:
        """None if every blob's proof verifies (an empty batch does);
        VerifierError for lists of different lengths, SerializationError for
        malformed bytes, InvalidProofError when the batch fails its check."""
        verifier = self._verifier()
        if not len(blobs) == len(commitments) == len(proofs):
            raise VerifierError(
                "batch verification inputs must have the same length: "
                f"{len(blobs)} blobs, {len(commitments)} commitments, {len(proofs)} proofs"
            )
        if not blobs:
            return
        commitments, proofs = [bytes(c) for c in commitments], [bytes(p) for p in proofs]
        cs, pfs = ser.decompress_g1_groups([commitments, proofs], self.device)
        zs = self.challenges(blobs, commitments)
        ys = self.evaluate(blobs, zs)
        r_powers = fs.compute_r_powers_blob_batch(self.config.poly_len, commitments, zs, ys, proofs, len(blobs))
        verifier.verify_kzg_proof_batch(cs, zs, ys, pfs, r_powers)

    @staticmethod
    def challenges(blobs: list[bytes], commitments: list[bytes]) -> list[int]:
        """Each blob's Fiat-Shamir evaluation point (host hashes)."""
        return [fs.compute_blob_challenge(bytes(b), bytes(c)) for b, c in zip(blobs, commitments)]

    def evaluate(self, blobs: list[bytes], zs: list[int]) -> list[int]:
        """y_i = f_i(z_i) for every blob, in one device pass (blob_to_poly,
        then poly_eval over [8, B, n])."""
        y = POLY.poly_eval(self.prover.blob_to_poly(self._data(blobs)), self._z(zs))
        return FR.from_mont_host(y.cpu().numpy())


class _DefaultWidth(int):
    """The default of `DASContext(use_precomp=...)`: the recommended width,
    told apart by its type from the same width passed explicitly."""


class DASContext(_BlobContext):
    """EIP-7594 context: cells, proofs and commitments; recovery; cell-proof
    batch verification; and, through `eip4844` (a `Context4844` over the
    same prover and setup), the EIP-4844 calls.

    `use_precomp` is the window width of both fixed-base MSM tables at
    mainnet geometry; None builds no tables: the prover's MSMs then run
    `msm.lincomb` (Pippenger) over the points themselves. `config` sets the
    geometry and both windows instead (tests use small ones); passing it
    with an explicit `use_precomp` is an error. Verification needs the
    setup's G2 points; a setup without them serves the other calls.
    `table_cache` (default: the KZG_TPU_TABLE_CACHE variable) is the path
    of a table snapshot: a matching one replaces the table build, else the
    built tables are saved there.

    `mesh` (a ("dp", "work") mesh from `parallel.mesh.make_mesh`; every rank
    of it builds the context and makes the same calls) shards the prover:
    the rank holds and builds only its 2k / work proof slots' tables (a
    snapshot is read whole and cut; none is written), the prover calls split
    their blobs over `dp` and the slots over `work` and return the whole
    batch on every rank; a recovery re-proves every blob with the slots over
    `work`. The verifier and the EIP-4844 calls run on every rank as they
    are.
    """

    def __init__(
        self,
        device=None,
        trusted_setup: TrustedSetup | None = None,
        use_precomp: int | None = _DefaultWidth(CONST.RECOMMENDED_PRECOMP_WIDTH),
        config: FK20Config | None = None,
        table_cache: str | None = None,
        mesh=None,
    ):
        if config is not None and not isinstance(use_precomp, _DefaultWidth):
            raise ValueError("pass either use_precomp or config, not both")
        self.device = resolve_device(device)
        setup = trusted_setup or TrustedSetup.default()
        width = None if use_precomp is None else int(use_precomp)
        self.config = config or FK20Config(
            poly_len=CONST.FIELD_ELEMENTS_PER_BLOB,
            coset_size=CONST.FIELD_ELEMENTS_PER_CELL,
            expansion=CONST.EXPANSION_FACTOR,
            fk20_window=width,
            commit_window=width,
        )
        if table_cache is None:
            table_cache = os.environ.get("KZG_TPU_TABLE_CACHE") or None
        self.prover = FK20Prover(setup.g1_monomial, self.config, self.device, table_cache=table_cache, mesh=mesh)
        self._init_recovery_and_verifier(setup)

    @property
    def mesh(self):
        """The mesh the prover is sharded over, or None."""
        return self.prover.mesh

    @classmethod
    def from_prover(cls, prover: FK20Prover) -> "DASContext":
        """A context around an existing prover, e.g. one whose tables were
        carried over from the JAX package (utils/convert.py); it has no G2
        points, so it cannot verify."""
        ctx = cls.__new__(cls)
        ctx.device = prover.device
        ctx.config = prover.config
        ctx.prover = prover
        ctx._init_recovery_and_verifier(None)
        return ctx

    def _init_recovery_and_verifier(self, setup: TrustedSetup | None) -> None:
        cfg = self.config
        self.rs = ReedSolomon(cfg.poly_len, cfg.expansion, cfg.num_proofs, self.device)
        self.verifier = None
        if setup is not None and len(setup.g2_monomial) > cfg.coset_size:
            self.verifier = FK20Verifier(
                g1s=setup.g1_monomial[: len(setup.g2_monomial)],
                g2s=setup.g2_monomial,
                coset_size=cfg.coset_size,
                num_points_to_open=cfg.ext_size,
                num_cosets=cfg.num_proofs,
                device=self.device,
            )
        self.eip4844 = Context4844(self.prover, setup)

    # --- the table snapshot ---

    def save_tables(self, path: str) -> None:
        """Write the prover's fixed-base tables to `path` (utils/persist.py),
        for a later `DASContext(table_cache=path)` or `load_tables`."""
        persist.save_prover_tables(self.prover, path)

    def load_tables(self, path: str) -> bool:
        """Take the prover's tables from the snapshot at `path`; False, and
        nothing changed, if it does not match this context."""
        return persist.load_prover_tables(self.prover, path)

    # --- EIP-4844 (blob_to_kzg_commitment is shared with Context4844) ---

    def compute_kzg_proof(self, blob: bytes, z: bytes):
        return self.eip4844.compute_kzg_proof(blob, z)

    def compute_blob_kzg_proof(self, blob: bytes, commitment: bytes) -> bytes:
        return self.eip4844.compute_blob_kzg_proof(blob, commitment)

    def verify_kzg_proof(self, commitment: bytes, z: bytes, y: bytes, proof: bytes) -> None:
        return self.eip4844.verify_kzg_proof(commitment, z, y, proof)

    def verify_blob_kzg_proof(self, blob: bytes, commitment: bytes, proof: bytes) -> None:
        return self.eip4844.verify_blob_kzg_proof(blob, commitment, proof)

    def verify_blob_kzg_proof_batch(self, blobs: list[bytes], commitments: list[bytes], proofs: list[bytes]) -> None:
        return self.eip4844.verify_blob_kzg_proof_batch(blobs, commitments, proofs)

    # --- PeerDAS ---

    def compute_cells_and_kzg_proofs(self, blob: bytes):
        return self.compute_cells_and_kzg_proofs_batch([blob])[0]

    @span("das/compute_cells_and_kzg_proofs_batch")
    def compute_cells_and_kzg_proofs_batch(self, blobs: list[bytes]):
        """B blobs -> list of B (cells, proofs) tuples, proved in one batch."""
        if not blobs:
            raise SerializationError("batch contains no blobs")
        with span("das/blob_codec"):
            data = self._data(blobs)
        mesh = self.mesh
        if mesh is None:
            proofs_aff, cells = self.prover.prove_from_data(data)
        else:
            dp = PM.dim_size(mesh, "dp")
            if len(blobs) % dp:
                raise ProverError(
                    f"blob batch of {len(blobs)} does not divide the mesh's dp axis ({dp}); "
                    "pad the batch or reshape the mesh"
                )
            proofs_aff, cells = PM.prove_work_sharded(self.prover, mesh, data)
        return self._cells_and_proofs(proofs_aff, cells)

    def _cells_and_proofs(self, proofs_aff: C.G1Affine, cells: torch.Tensor):
        """Fetch: cells [8, B, K, M] (Montgomery) and proofs [B, K] -> list of
        B (cells, proofs) tuples of bytes."""
        b, k = cells.shape[1], self.config.num_proofs
        with span("das/cells_bytes"):
            cells_bytes = cells_bytes_from_std(F.from_mont(FR, cells).cpu().numpy())
        with span("das/proofs_bytes"):
            proofs = proofs_bytes(proofs_aff, b, k)
        return list(zip(cells_bytes, proofs))

    def compute_cells(self, blob: bytes):
        cells = self.prover.extend_from_data(self._data([blob]))
        return cells_bytes_from_std(F.from_mont(FR, cells).cpu().numpy())[0]

    def recover_cells_and_kzg_proofs(self, cell_indices: list[int], cells: list[bytes]):
        return self.recover_cells_and_kzg_proofs_batch([(cell_indices, cells)])[0]

    @span("das/recover_cells_and_kzg_proofs_batch")
    def recover_cells_and_kzg_proofs_batch(self, batches):
        """[(cell_indices, cells), ...] -> [(cells, proofs), ...]: every blob
        recovered from at least half of its cells (each with its own erasure
        pattern) and re-proved, all blobs in one device pass. Raises
        RecoveryError naming every blob that fails the degree check."""
        e_std, z_small = self.recovery_arrays(batches)
        ok, proofs_aff, cells = recover_and_prove(self.rs, self.prover, *self.upload(e_std, z_small))
        return self.recovery_outputs(ok, proofs_aff, cells)

    def upload(self, *arrays: np.ndarray) -> tuple[torch.Tensor, ...]:
        with span("das/upload", self.device):
            return tuple(torch.from_numpy(a).to(self.device) for a in arrays)

    def recovery_outputs(self, ok: torch.Tensor, proofs_aff: C.G1Affine, cells: torch.Tensor):
        """The fetch of a recovery: every blob's degree check, then its cells
        and proofs as bytes."""
        with span("das/degree_check"):
            ok = ok.cpu().numpy()
            if not ok.all():
                bad = [i for i, v in enumerate(ok) if not v]
                raise RecoveryError(
                    f"recovered polynomial has invalid degree for batch entries {bad} (corrupt input cells?)"
                )
        return self._cells_and_proofs(proofs_aff, cells)

    @span("das/recovery_arrays")
    def recovery_arrays(self, batches):
        """The host part of a recovery: each blob's checks and erasure layout
        -> (codewords [8, B, ext], small vanishing polynomials [8, B, nz]),
        standard-form numpy limbs."""
        if not batches:
            raise SerializationError("batch contains no recovery inputs")
        e_stds, z_stds = [], []
        for cell_indices, cells in batches:
            e_std, missing = recover_inputs(self.config, cell_indices, cells)
            e_stds.append(e_std)
            z_stds.append(self.rs.construct_vanishing_poly_small(missing))
        return np.stack(e_stds, axis=1), np.stack(z_stds, axis=1)

    @span("das/verify_cell_kzg_proof_batch")
    def verify_cell_kzg_proof_batch(self, commitments: list[bytes], cell_indices: list[int],
                                    cells: list[bytes], proofs: list[bytes]) -> None:
        """Returns None if every cell proof verifies; raises VerifierError on
        malformed lengths or indices, SerializationError on malformed bytes,
        InvalidProofError when the batch fails the pairing check."""
        args = self.verify_inputs(commitments, cell_indices, cells, proofs)
        if args is not None:
            self.verifier.verify(*args)

    @span("das/verify_inputs")
    def verify_inputs(self, commitments, cell_indices, cells, proofs):
        """The host checks of a verify, before any point is decompressed:
        commitments deduplicated by bytes in first-seen order, the length and
        index checks, the cell bytes and the Fiat-Shamir challenge over the
        raw bytes. Returns the arguments of `FK20Verifier.verify`, or None for
        an empty batch."""
        if self.verifier is None:
            raise ValueError("this context's trusted setup has no G2 points: it cannot verify")
        cfg = self.config
        commitments = [bytes(c) for c in commitments]
        proofs = [bytes(p) for p in proofs]
        unique, indices, seen = [], [], {}
        for c in commitments:
            if c not in seen:
                seen[c] = len(unique)
                unique.append(c)
            indices.append(seen[c])
        if not len(indices) == len(cell_indices) == len(cells) == len(proofs):
            raise VerifierError(
                "batch verification inputs must have the same length: "
                f"{len(indices)} commitments, {len(cell_indices)} cell indices, "
                f"{len(cells)} cells, {len(proofs)} proofs"
            )
        for ci in cell_indices:
            if ci >= cfg.num_proofs:
                raise VerifierError(f"cell index {ci} out of range (max {cfg.num_proofs})")
        if not cells:
            return None
        cells = [bytes(c) for c in cells]
        cell_limbs = ser.deserialize_cells_batch(cells, cfg.coset_size * CONST.BYTES_PER_FIELD_ELEMENT)
        r = fs.compute_cell_batch_challenge(
            cfg.poly_len, cfg.coset_size, unique, indices, list(cell_indices), cells, proofs
        )
        return unique, indices, list(cell_indices), cell_limbs, proofs, r
