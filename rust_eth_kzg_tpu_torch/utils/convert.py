"""Carry state from the JAX package's arrays into the port's tensors.

The JAX package keeps Montgomery field elements as 15-bit limbs with
R = 2^(15 L) (26 limbs for Fp, 18 for Fr), lazily reduced; its fixed-base
tables split each limb into 8-bit halves stored as bf16. These helpers take
the numpy forms of those arrays (no JAX import) and re-encode every value in
the port's radix, fully reduced.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import curve as C
from ..ops import curve_g2 as G2
from ..ops import field as F
from ..ops import msm as M

_JAX_LIMB_BITS = 15
_JAX_NLIMBS = {"fp": 26, "fr": 18}


def _ints_from_limbs15(arr: np.ndarray) -> list:
    """[L15, N] int limbs (any magnitudes) -> N Python ints."""
    arr = np.asarray(arr).astype(np.int64)
    out = [0] * arr.shape[1]
    for j in range(arr.shape[0] - 1, -1, -1):
        row = arr[j].tolist()
        out = [(v << _JAX_LIMB_BITS) + int(r) for v, r in zip(out, row)]
    return out


def limbs15_to_port(arr, spec: F.FieldSpec, device) -> torch.Tensor:
    """JAX Montgomery limbs [L15, *batch] -> port Montgomery limbs [L, *batch]."""
    arr = np.asarray(arr)
    batch = arr.shape[1:]
    m = spec.modulus
    r15_inv = pow(1 << (_JAX_LIMB_BITS * _JAX_NLIMBS[spec.name]), -1, m)
    std = [v * r15_inv % m for v in _ints_from_limbs15(arr.reshape(arr.shape[0], -1))]
    out = spec.to_mont_host(std).reshape((spec.nlimbs,) + batch)
    return torch.from_numpy(np.ascontiguousarray(out)).to(device)


def g1_from_jax(x, y, z, device) -> C.G1:
    """JAX projective G1 coordinates [26, *batch] -> port G1."""
    return C.G1(*(limbs15_to_port(c, F.FP, device) for c in (x, y, z)))


def g2_from_jax(point, device) -> G2.G2:
    """A JAX `curve_g2.G2` (Fp2 components of [26, *batch] limbs) -> port G2."""
    return G2.G2(*(G2.Fp2(*(limbs15_to_port(c, F.FP, device) for c in f)) for f in point))


def fixed_base_tables_from_jax(
    table_rows, base_inf, window: int, chains: int, wpc: int, instance_ndim: int, device
) -> M.FixedBaseMSM:
    """JAX `FixedBaseMSM.table_rows` [*inst, CP, 4 * 26, D] (rows x_hi, y_hi,
    x_lo, y_lo of 8-bit limb halves) -> the port's affine tables."""
    rows = np.asarray(table_rows).astype(np.float32).astype(np.int64)
    nl = _JAX_NLIMBS["fp"]
    lead = rows.shape[:-2]
    d = rows.shape[-1]
    limbs = (rows[..., : 2 * nl, :] << 8) | rows[..., 2 * nl :, :]  # [*lead, 2L, D]
    limbs = np.moveaxis(limbs, -2, 0)  # [2L, *lead, D]
    x = limbs15_to_port(limbs[:nl], F.FP, device)
    y = limbs15_to_port(limbs[nl:], F.FP, device)
    inf = torch.as_tensor(np.asarray(base_inf).astype(bool), device=device)
    if x.shape[1:] != lead + (d,):
        raise ValueError("unexpected table layout")
    return M.FixedBaseMSM(x, y, inf, window, instance_ndim, chains, wpc)
