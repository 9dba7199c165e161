"""FK20 multi-point prover: blob -> 128 cells + 128 proofs, on torch tensors.

The same pipeline as rust_eth_kzg_tpu/models/fk20.py:
- the Toeplitz -> circulant embedding is a static gather of the coefficient
  vector plus a zero mask;
- the 64 circulant column FFTs are one batched NTT;
- the 128 size-64 MSMs are one batched fixed-base MSM with an instance axis;
- the inverse circulant G1-FFT keeps the first k outputs (its 1/(2k) scale
  is folded into the MSM scalars), and the proof-domain G1-FFT makes the
  proofs.
Everything is batched over a leading blob axis: [L, B, poly_len] in.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ops import curve as C
from ..ops import field as F
from ..ops import msm as M
from ..ops import ntt
from ..parallel import mesh as PM
from ..utils import persist
from ..utils.tracing import span

FR = F.FR


@dataclass(frozen=True)
class FK20Config:
    """Protocol geometry. Mainnet: poly_len=4096, coset_size=64, expansion=2."""

    poly_len: int = 4096
    coset_size: int = 64
    expansion: int = 2
    # window widths of the fixed-base MSM tables; None: no table, the MSM
    # runs `msm.lincomb` over the points
    fk20_window: int | None = 8
    commit_window: int | None = 8

    @property
    def ext_size(self) -> int:
        return self.poly_len * self.expansion

    @property
    def num_proofs(self) -> int:
        return self.ext_size // self.coset_size


def _circulant_index_map(poly_len: int, coset_size: int):
    """Static (index, mask) arrays mapping poly coefficients to circulant rows.

    Row i (i < coset_size) is the circulant embedding of the Toeplitz row
    r_i[t] = c[poly_len - 1 - i - coset_size t]:
      circ[i][0] = r_i[0], circ[i][1..k] = 0,
      circ[i][k + t] = c[coset_size t - i - 1] (t = 1..k-1), k = poly_len / coset_size.
    """
    k = poly_len // coset_size
    idx = np.zeros((coset_size, 2 * k), dtype=np.int64)
    mask = np.zeros((coset_size, 2 * k), dtype=bool)
    for i in range(coset_size):
        idx[i, 0] = poly_len - 1 - i
        mask[i, 0] = True
        for t in range(1, k):
            j = coset_size * t - i - 1
            if 0 <= j < poly_len:
                idx[i, k + t] = j
                mask[i, k + t] = True
    return idx, mask


def _broadcast(points: C.G1, scalars: torch.Tensor) -> C.G1:
    """Points G1 [*shape] -> [*lead, *shape] for scalars [L, *lead, *shape]."""
    lead = tuple(scalars.shape[1 : scalars.dim() - points.x.dim() + 1])
    return C._map(lambda c: c.reshape((c.shape[0],) + (1,) * len(lead) + tuple(c.shape[1:]))
                  .expand((c.shape[0],) + lead + tuple(c.shape[1:])), points)


class FK20Prover:
    """SRS tables and domains on one device; `prove_from_data` runs the prover.

    The SRS is reversed, truncated by one coset, strided into coset_size
    vectors, group-FFT'd over the circulant domain and baked into one MSM
    table per proof slot; the commit key gets its own table. A window of
    None keeps the points instead (`slot_points` [2k, coset],
    `commit_points` [poly_len]) and its MSMs run `msm.lincomb`, as the JAX
    package's table-free route does; `tables` and `commit_tables` are then
    None. With `table_cache` (a path; both windows set) the tables come from
    that snapshot when it matches (`utils/persist.py`: no SRS G1-FFT, no
    table build), else they are built and saved there.

    With `mesh` (`parallel.mesh.make_mesh`) the prover is sharded over the
    mesh's `work` dim: the rank keeps only its 2k / work proof slots,
    `slots` (their tables, or their points without tables), builds only
    those, runs their MSMs and gathers the slot results over `work` before
    the G1-IFFT; every rank of a `work` group must prove the same blobs.
    Whole tables passed in or loaded from a snapshot are cut to the slice
    (the rest is freed); such a prover saves no snapshot. The commit key's
    tables stay whole.
    """

    def __init__(self, commit_key_points: list, config: FK20Config, device, tables=None, table_cache=None,
                 mesh=None):
        cfg = config
        if cfg.poly_len % cfg.coset_size:
            raise ValueError("poly_len must be a multiple of coset_size")
        self.config = cfg
        self.device = torch.device(device)
        k = cfg.poly_len // cfg.coset_size
        self.mesh = mesh
        self.slots = slice(0, 2 * k)
        if mesh is not None:
            work = PM.dim_size(mesh, "work")
            if (2 * k) % work:
                raise ValueError(f"{2 * k} proof slots do not split over work = {work}")
            w = PM.dim_rank(mesh, "work")
            self.slots = slice(w * 2 * k // work, (w + 1) * 2 * k // work)
        self.circulant_domain = ntt.Domain(2 * k, device)
        self.proof_domain = ntt.Domain(cfg.num_proofs, device)
        self.evaluation_domain = ntt.Domain(cfg.ext_size, device)
        self.poly_domain = ntt.Domain(cfg.poly_len, device)
        ci, cm = _circulant_index_map(cfg.poly_len, cfg.coset_size)
        self._circ_idx = torch.as_tensor(ci.reshape(-1), device=device)
        self._circ_mask = torch.as_tensor(cm, device=device)
        self.slot_points = self.commit_points = None
        self.srs_fingerprint = "" if commit_key_points is None else persist.srs_fingerprint(commit_key_points)
        cache = table_cache if cfg.fk20_window is not None and cfg.commit_window is not None else None
        if tables is None and cache:
            tables = persist.try_load_tables(cache, self.srs_fingerprint, cfg.fk20_window, cfg.commit_window,
                                             persist.config_geometry(cfg), self.device)
        if tables is not None:
            self.set_tables(*tables)
            return

        srs = commit_key_points
        vectors = []
        for i in range(cfg.coset_size):
            vec = [None] * (2 * k)  # padded to the circulant domain with the identity
            for t in range(k - 1):
                vec[t] = srs[cfg.poly_len - 1 - cfg.coset_size - i - cfg.coset_size * t]
            vectors.append(vec)
        dev = C.points_to_device([pt for vec in vectors for pt in vec], device)
        dev = C._map(lambda c: c.reshape(-1, cfg.coset_size, 2 * k), dev)
        slot_points = self.circulant_domain.fft_g1(dev)  # [coset, 2k]
        slot_points = C._map(lambda c: c.transpose(1, 2)[:, self.slots].contiguous(), slot_points)
        self.tables = None
        if cfg.fk20_window is None:
            self.slot_points = slot_points
        else:
            self.tables = M.build_fixed_base_msm(slot_points, cfg.fk20_window, instance_ndim=1)
        commit_pts = C.points_to_device(list(srs[: cfg.poly_len]), device)
        self.commit_tables = None
        if cfg.commit_window is None:
            self.commit_points = commit_pts
        else:
            self.commit_tables = M.build_fixed_base_msm(commit_pts, cfg.commit_window)
        if cache and mesh is None:
            persist.save_prover_tables(self, cache)

    def set_tables(self, fk20: M.FixedBaseMSM, commit: M.FixedBaseMSM) -> None:
        """Take whole tables (all 2k slots); a sharded prover keeps its slice."""
        if self.mesh is not None:
            fk20 = M.slice_instances(fk20, self.slots)
        self.tables, self.commit_tables = fk20, commit

    # --- pipeline pieces (all shapes [L, B, ...]) ---

    def blob_to_poly(self, data: torch.Tensor) -> torch.Tensor:
        """Blob scalars (evaluation form, bit-reversed order) -> coefficients."""
        return self.poly_domain.ifft(ntt.bit_reverse_permutation(data))

    def _h_poly_commitments(self, poly: torch.Tensor) -> C.G1:
        """poly [L, B, poly_len] -> h-poly commitments G1 [B, k]."""
        cfg = self.config
        k = cfg.poly_len // cfg.coset_size
        rows = torch.index_select(poly, -1, self._circ_idx)
        rows = rows.reshape(poly.shape[:-1] + (cfg.coset_size, 2 * k))
        rows = torch.where(self._circ_mask, rows, torch.zeros((), dtype=rows.dtype, device=rows.device))
        col_fft = self.circulant_domain.fft(rows)
        # the prover's slots' scalars [L, B, slots, coset], with the circulant
        # IFFT's 1/(2k) folded in (one Fr product instead of a G1 scalar
        # multiplication)
        msm_scalars = F.mont_mul_const(
            FR, col_fft.transpose(-1, -2)[..., self.slots, :], self.circulant_domain.size_inv
        )
        if self.tables is not None:
            slot_results = M.fixed_base_msm(self.tables, msm_scalars)  # [B, slots]
        else:
            slot_results = M.lincomb(_broadcast(self.slot_points, msm_scalars), msm_scalars)
        if self.mesh is not None:
            slot_results = PM.all_gather_g1(self.mesh, "work", slot_results, 1)  # [B, 2k]
        return self.circulant_domain.ifft_g1(slot_results, take_n=k, prescaled=True)

    def _proofs_from_h(self, h_comms: C.G1) -> C.G1:
        """h commitments [B, k] -> bit-reversed proofs [B, num_proofs]."""
        cfg = self.config
        b, k = h_comms.batch_shape
        idp = C.identity((b, cfg.num_proofs - k), self.device)
        padded = C._map(lambda c, i: torch.cat((c, i), dim=-1), h_comms, idp)
        proofs = self.proof_domain.fft_g1(padded)
        return C._map(ntt.bit_reverse_permutation, proofs)

    def _coset_evaluations(self, poly: torch.Tensor) -> torch.Tensor:
        """poly [L, B, n] -> cells [L, B, num_proofs, coset] (bit-reversed order)."""
        cfg = self.config
        pad = torch.zeros(poly.shape[:-1] + (cfg.ext_size - cfg.poly_len,), dtype=poly.dtype, device=poly.device)
        evals = self.evaluation_domain.fft(torch.cat((poly, pad), dim=-1))
        evals = ntt.bit_reverse_permutation(evals)
        return evals.reshape(evals.shape[:-1] + (cfg.num_proofs, cfg.coset_size))

    def prove_from_poly(self, poly: torch.Tensor):
        """poly [L, B, poly_len] -> (proofs G1Affine [B, num_proofs],
        cells [L, B, num_proofs, coset] in Montgomery form); its four stages
        are the JAX prover's tracing spans."""
        with span("fk20/h_poly_commitments", self.device):
            h = self._h_poly_commitments(poly)
        with span("fk20/proofs_g1_fft", self.device):
            proofs = self._proofs_from_h(h)
        with span("fk20/coset_evaluations", self.device):
            cells = self._coset_evaluations(poly)
        with span("fk20/batch_normalize", self.device):
            out = C.batch_normalize(proofs)
        return out, cells

    def prove_from_data(self, data: torch.Tensor):
        """Blob scalars [L, B, poly_len] (Montgomery, bit-reversed evaluations)."""
        return self.prove_from_poly(self.blob_to_poly(data))

    def extend_from_data(self, data: torch.Tensor) -> torch.Tensor:
        return self._coset_evaluations(self.blob_to_poly(data))

    def commit_from_poly(self, poly: torch.Tensor) -> C.G1:
        """poly [L, B, n] -> commitments G1 [B]."""
        if self.commit_tables is None:
            return M.lincomb(_broadcast(self.commit_points, poly), poly)
        return M.fixed_base_msm(self.commit_tables, poly)

    def commit_from_data(self, data: torch.Tensor) -> C.G1:
        return self.commit_from_poly(self.blob_to_poly(data))


def recover_and_prove(rs, prover: FK20Prover, e_std: torch.Tensor, z_small: torch.Tensor):
    """Recovery and the re-prove as one device pass (the counterpart of the
    JAX package's fused `_recover_prove_packed`).

    e_std: [8, B, ext] standard-form codewords in natural order, zero at the
    erasures; z_small: [8, B, nz] standard-form coefficients of each blob's
    small vanishing polynomial, spread on the device at stride num_blocks.
    Returns (ok [B], proofs G1Affine [B, num_proofs], cells [8, B,
    num_proofs, coset] Montgomery); a blob whose ok is False failed the
    degree check and its outputs are meaningless.
    """
    with span("rs/decode", prover.device):
        poly, ok = rs.recover_polynomial_coefficient(e_std, z_small)
    proofs, cells = prover.prove_from_poly(poly)
    return ok, proofs, cells
