"""Multi-device: a (dp, work) device mesh over torch.distributed, and the
sharded FK20 programs.

The counterpart of rust_eth_kzg_tpu/parallel/mesh.py, whose mesh has two
axes:
- `dp`:   blob-batch data parallelism; blobs are independent, so sharding
          the batch needs no collective until the outputs are gathered;
- `work`: intra-blob work parallelism; FK20's 2k proof slots (the Toeplitz
          MSMs, and each rank's slice of their tables) shard over it, and
          the G1-IFFT that mixes the slots gathers them back.

JAX partitions global arrays; torch.distributed runs one process a rank.
So every function here is SPMD: every rank of the mesh calls it with the
same global inputs and gets back what the single-device function returns,
gathered where JAX would leave the result sharded. A function that needs a
mesh raises without one; none falls back to an unsharded run.

The collectives are `all_gather_into_tensor` and `all_to_all_single` on a
mesh dim's process group (`all_gather`, `all_to_all`). A tensor goes to the
group on the mesh's own device type: a NCCL mesh ("cuda") takes CUDA
tensors as they are; a gloo mesh ("cpu") takes host tensors, so a tensor
computed on the card is copied to the host and back around the collective
(the transport of several gloo ranks that share one card). `COLLECTIVES`
counts the collectives and those host round trips.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..constants import R_SCALAR
from ..ops import curve as C
from ..ops import field as F
from ..ops import msm as M
from ..ops import ntt

FR = F.FR
DIMS = ("dp", "work")

COLLECTIVES = {"all_gather": 0, "all_to_all": 0, "host_copies": 0}


def reset_collectives() -> None:
    for name in COLLECTIVES:
        COLLECTIVES[name] = 0


def make_mesh(n_devices: int | None = None, dp: int | None = None, device_type: str | None = None) -> DeviceMesh:
    """A (dp, work) mesh over the initialized default process group.

    n_devices must be the world size (default: it). Without `dp`, work is
    the first of 8, 4, 2 and 1 that divides n (work parallelism inside a
    host, dp across the rest), as the JAX package chooses. `device_type`
    defaults to the group's own: "cuda" for NCCL, "cpu" for gloo.
    """
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized default process group "
                           "(torch.distributed.init_process_group)")
    world = dist.get_world_size()
    n = world if n_devices is None else n_devices
    if n != world:
        raise ValueError(f"a mesh of {n} devices over a world of {world} ranks")
    if dp is None:
        work = next(c for c in (8, 4, 2, 1) if n % c == 0)
        dp = n // work
    elif dp < 1 or n % dp:
        raise ValueError(f"dp = {dp} does not divide the {n} devices")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (dp, n // dp), mesh_dim_names=DIMS)


def dim_size(mesh: DeviceMesh, dim: str) -> int:
    return mesh.shape[mesh.mesh_dim_names.index(dim)]


def dim_rank(mesh: DeviceMesh, dim: str) -> int:
    """This rank's coordinate along `dim`."""
    return mesh.get_local_rank(dim)


def _to_group(mesh: DeviceMesh, t: torch.Tensor) -> torch.Tensor:
    """t, contiguous, on the mesh's device type (bool as uint8)."""
    if t.dtype == torch.bool:
        t = t.to(torch.uint8)
    if t.device.type != mesh.device_type:
        COLLECTIVES["host_copies"] += 1
        t = t.to(mesh.device_type)
    return t.contiguous()


def all_gather(mesh: DeviceMesh, dim: str, t: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """The concatenation along `axis` of every rank's t over the mesh dim, in
    rank order: rank w's block lands at [w a, (w + 1) a), a = t.shape[axis].
    Returned on t's device and dtype."""
    group = mesh.get_group(dim)
    n = dist.get_world_size(group)
    src = _to_group(mesh, torch.movedim(t, axis, 0))
    out = torch.empty((n * src.shape[0],) + tuple(src.shape[1:]), dtype=src.dtype, device=src.device)
    dist.all_gather_into_tensor(out, src, group=group)
    COLLECTIVES["all_gather"] += 1
    return torch.movedim(out.to(device=t.device, dtype=t.dtype), 0, axis)


def all_to_all(mesh: DeviceMesh, dim: str, t: torch.Tensor) -> torch.Tensor:
    """Block exchange over the mesh dim: t's dim 0 is n equal blocks, block j
    goes to rank j, and block i of the result came from rank i."""
    group = mesh.get_group(dim)
    src = _to_group(mesh, t)
    if src.shape[0] % dist.get_world_size(group):
        raise ValueError(f"all_to_all: dim 0 of {tuple(t.shape)} does not split over the mesh dim {dim!r}")
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    COLLECTIVES["all_to_all"] += 1
    return out.to(device=t.device, dtype=t.dtype)


def all_gather_g1(mesh: DeviceMesh, dim: str, p: C.G1, axis: int) -> C.G1:
    """G1 points gathered along batch axis `axis` (one collective)."""
    out = all_gather(mesh, dim, torch.stack(tuple(p)), axis + 2)
    return C.G1(*out.unbind(0))


def _gather_blobs(mesh: DeviceMesh, dims, proofs: C.G1Affine, cells: torch.Tensor):
    """(proofs [B_loc, K], cells [L, B_loc, K, M]) -> the whole batch, blob
    blocks in the flattened order of `dims` (innermost last)."""
    for dim in reversed(dims):
        xy = all_gather(mesh, dim, torch.stack((proofs.x, proofs.y)), 2)
        inf = all_gather(mesh, dim, proofs.inf, 0)
        proofs = C.G1Affine(xy[0], xy[1], inf)
        cells = all_gather(mesh, dim, cells, 1)
    return proofs, cells


def _blob_block(data: torch.Tensor, index: int, parts: int) -> torch.Tensor:
    b = data.shape[1]
    if b % parts:
        raise ValueError(f"a batch of {b} blobs does not split over {parts} ranks")
    per = b // parts
    return data[:, index * per : (index + 1) * per]


def shard_blob_batch(mesh: DeviceMesh, data: torch.Tensor) -> torch.Tensor:
    """This rank's slice of [L, B, n] blob scalars, the batch axis split over
    the flattened (dp, work) ranks (the zero-collective layout)."""
    work = dim_size(mesh, "work")
    return _blob_block(data, dim_rank(mesh, "dp") * work + dim_rank(mesh, "work"), work * dim_size(mesh, "dp"))


def prove_sharded(prover, mesh: DeviceMesh, data: torch.Tensor):
    """FK20 prove with the blob batch split over the whole mesh.

    data: [L, B, poly_len] Montgomery blob scalars, B divisible by the mesh
    size; the prover holds every slot. Each rank proves its B / n blobs, then
    the outputs are gathered. Returns (proofs G1Affine [B, num_proofs],
    cells [L, B, num_proofs, coset]) on every rank.
    """
    if prover.mesh is not None:
        raise ValueError("prove_sharded splits blobs over every rank: it needs a prover that holds every slot")
    proofs, cells = prover.prove_from_data(shard_blob_batch(mesh, data))
    return _gather_blobs(mesh, DIMS, proofs, cells)


def prove_work_sharded(prover, mesh: DeviceMesh, data: torch.Tensor):
    """FK20 prove with blobs over `dp` and proof slots over `work`.

    The prover is sharded over this mesh (`FK20Prover(..., mesh=mesh)`): it
    holds its 2k / work slots' tables, runs their MSMs on the rank's B / dp
    blobs and gathers the slot results over `work` for the G1-IFFT; the
    outputs are gathered over `dp`. Returns what `prove_from_data` returns
    for the whole batch, on every rank.
    """
    if prover.mesh is not mesh:
        raise ValueError("prove_work_sharded needs a prover sharded over this mesh (FK20Prover(..., mesh=mesh))")
    local = _blob_block(data, dim_rank(mesh, "dp"), dim_size(mesh, "dp"))
    proofs, cells = prover.prove_from_data(local)
    return _gather_blobs(mesh, ("dp",), proofs, cells)


def lincomb_sharded(points: C.G1, scalars_mont: torch.Tensor, mesh: DeviceMesh, axis: str = "work") -> C.G1:
    """Variable-base MSM with the point axis split over one mesh dim.

    points: G1 [*batch, N]; scalars_mont: [8, *batch, N], N divisible by the
    dim's size. Each rank runs `msm.lincomb` over its N / ndev points; the
    partial sums are gathered and summed with `curve.reduce_sum` (G1
    addition is no reduction op of a collective). Returns G1 [*batch] on
    every rank.
    """
    ndev = dim_size(mesh, axis)
    n = points.x.shape[-1]
    if n % ndev:
        raise ValueError(f"{n} points do not split over the {ndev} ranks of {axis!r}")
    lo = dim_rank(mesh, axis) * (n // ndev)
    sl = slice(lo, lo + n // ndev)
    local = M.lincomb(C._map(lambda c: c[..., sl], points), scalars_mont[..., sl])
    parts = all_gather_g1(mesh, axis, C._map(lambda c: c[..., None], local), local.x.dim() - 1)
    return C.reduce_sum(parts, axis=-1)


def fft_sharded(dom: ntt.Domain, x: torch.Tensor, mesh: DeviceMesh, axis: str = "work") -> torch.Tensor:
    """The scalar NTT over the mesh dim in the four-step form, one exchange.

    n = n1 n2 with n1 the dim's size; A[j1, j2] = x[j1 + n1 j2]. Rank j1:
    1. the n2-point NTT of its row A[j1, :] (`ntt.Domain.fft`);
    2. the twiddles w^(j1 k2) (`field.mont_mul`);
    3. the j1 <-> k2 transpose: one `all_to_all`, after which the rank holds
       k2 in [j1 n2 / n1, (j1 + 1) n2 / n1) of every row;
    4. the n1-point NTT along j1; element [k1, k2] is X[k2 + n2 k1].
    A closing `all_gather` over the k2 blocks returns natural order.
    x: [L, B, n] Montgomery; returns dom.fft(x) on every rank.
    """
    n = dom.size
    n1 = dim_size(mesh, axis)
    if n % n1 or (n // n1) % n1:
        raise ValueError(f"a {n}-point domain does not split into the four-step form over {n1} ranks")
    n2 = n // n1
    c = n2 // n1
    j1 = dim_rank(mesh, axis)
    nl, b, _ = x.shape
    row = x[:, :, j1::n1]  # A[j1, :], [L, B, n2]
    v = ntt.Domain(n2, x.device).fft(row.contiguous())
    tw = torch.from_numpy(FR.to_mont_host([pow(dom.generator, j1 * k2, R_SCALAR) for k2 in range(n2)]))
    v = F.mont_mul(FR, v, tw.to(x.device)[:, None, :])
    # blocks of k2 to ranks: [n1 (dest), L, B, c]; back: [n1 (j1), L, B, c]
    v = all_to_all(mesh, axis, v.reshape(nl, b, n1, c).permute(2, 0, 1, 3))
    v = ntt.Domain(n1, x.device).fft(v.permute(1, 2, 3, 0).contiguous())  # [L, B, c, n1 (k1)]
    out = all_gather(mesh, axis, v, 2)  # [L, B, n2 (k2), n1 (k1)]
    return out.transpose(-1, -2).reshape(nl, b, n)
