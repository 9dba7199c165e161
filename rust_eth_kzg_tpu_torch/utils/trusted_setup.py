"""Trusted setup loading: the G1 and G2 monomial points of the embedded mainnet setup.

The port's copy of the consensus-spec JSON lives in `data/`. The default
setup decompresses its 4096 G1 and 65 G2 points without subgroup checks
(on-curve checks still apply), as the reference's unchecked default does;
`g1_lagrange` is not read. The prover needs the G1 points; the cell-proof
verifier needs the first 65 G1 points and the G2 points.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass

from . import bls_host as bls

SETUP_JSON_PATH = os.path.join(os.path.dirname(os.path.dirname(__file__)), "data", "trusted_setup_4096.json")


@dataclass(frozen=True)
class TrustedSetup:
    """Monomial points as affine int tuples (None for the identity): G1 as
    (x, y), G2 as ((x0, x1), (y0, y1)). A setup without G2 points serves the
    prover only."""

    g1_monomial: list
    g2_monomial: list = ()

    @staticmethod
    def from_json(json_str: str, subgroup_check: bool = True) -> "TrustedSetup":
        data = json.loads(json_str)
        return TrustedSetup(
            g1_monomial=[
                bls.g1_decompress(_hex_bytes(h, 48), subgroup_check=subgroup_check)
                for h in data["g1_monomial"]
            ],
            g2_monomial=[
                bls.g2_decompress(_hex_bytes(h, 96), subgroup_check=subgroup_check)
                for h in data["g2_monomial"]
            ],
        )

    @staticmethod
    def default() -> "TrustedSetup":
        """The embedded mainnet setup, unchecked."""
        with open(SETUP_JSON_PATH) as fh:
            return TrustedSetup.from_json(fh.read(), subgroup_check=False)


def _hex_bytes(hex_str: str, expect_len: int) -> bytes:
    if not hex_str.startswith("0x"):
        raise ValueError("expected hex points to be prefixed with `0x`")
    raw = bytes.fromhex(hex_str[2:])
    if len(raw) != expect_len:
        raise ValueError(f"expected {expect_len} bytes, got {len(raw)}")
    return raw
