"""Trusted setup loading: the G1 and G2 monomial points of the embedded mainnet setup.

The port's copy of the consensus-spec JSON lives in `data/`. The default
setup decompresses its 4096 G1 and 65 G2 points without subgroup checks
(on-curve checks still apply), as the reference's unchecked default does;
`g1_lagrange` is not read. The prover needs the G1 points; the cell-proof
verifier needs the first 65 G1 points and the G2 points.

Decompressing 4161 points in Python takes seconds, so `default()` keeps the
decompressed points in `CACHE_DIR/setup_cache_<sha256(json)[:16]>.npz`: the
name is keyed by the JSON's text, so the cache cannot go stale. The first
call parses and writes it; every later call loads it. Delete the file to
force a parse.

The cache's layout (the port's own): `g1` uint8 [n, 2, 48] and `g2` uint8
[m, 4, 48], each coordinate big-endian (G2 as x0, x1, y0, y1), and bool
flags `g1_inf` [n] and `g2_inf` [m] for identity points, whose coordinates
are zero: a setup with identity points round-trips. A file of another
layout version, or one that does not read, counts as a miss.
"""

from __future__ import annotations

import hashlib
import json
import os
import tempfile
import zipfile
from dataclasses import dataclass

import numpy as np

from . import bls_host as bls

DATA_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data")
SETUP_JSON_PATH = os.path.join(DATA_DIR, "trusted_setup_4096.json")
# where default() keeps its cache (tests point it at a temporary directory)
CACHE_DIR = DATA_DIR
CACHE_LAYOUT = 1
_COORD_BYTES = 48


@dataclass(frozen=True)
class TrustedSetup:
    """Monomial points as affine int tuples (None for the identity): G1 as
    (x, y), G2 as ((x0, x1), (y0, y1)). A setup without G2 points serves the
    prover only."""

    g1_monomial: list
    g2_monomial: list = ()

    @staticmethod
    def from_json(json_str: str, subgroup_check: bool = True) -> "TrustedSetup":
        return _parse(json_str, subgroup_check)

    @staticmethod
    def from_json_unchecked(json_str: str) -> "TrustedSetup":
        """Parse without subgroup checks (on-curve checks still apply)."""
        return _parse(json_str, subgroup_check=False)

    @staticmethod
    def default() -> "TrustedSetup":
        """The embedded mainnet setup, unchecked, through the cache."""
        with open(SETUP_JSON_PATH) as fh:
            raw = fh.read()
        path = cache_path(raw)
        setup = load_cache(path)
        if setup is None:
            setup = _parse(raw, subgroup_check=False)
            save_cache(path, setup)
        return setup


def cache_path(json_str: str) -> str:
    """The cache file of a setup JSON's text, in CACHE_DIR."""
    digest = hashlib.sha256(json_str.encode()).hexdigest()[:16]
    return os.path.join(CACHE_DIR, f"setup_cache_{digest}.npz")


def _parse(json_str: str, subgroup_check: bool) -> TrustedSetup:
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


def _hex_bytes(hex_str: str, expect_len: int) -> bytes:
    if not hex_str.startswith("0x"):
        raise ValueError("expected hex points to be prefixed with `0x`")
    raw = bytes.fromhex(hex_str[2:])
    if len(raw) != expect_len:
        raise ValueError(f"expected {expect_len} bytes, got {len(raw)}")
    return raw


def save_cache(path: str, setup: TrustedSetup) -> bool:
    """Write `setup` to `path` through a unique temporary file in the same
    directory and os.replace, so that concurrent writers and readers see no
    cache or a whole one. Returns False, writing nothing, where the
    directory is not writable."""
    arrays = {
        "layout": np.array(CACHE_LAYOUT),
        "g1": _coords(setup.g1_monomial, 2, lambda p: p),
        "g1_inf": np.array([p is None for p in setup.g1_monomial], dtype=bool),
        "g2": _coords(setup.g2_monomial, 4, lambda p: (p[0][0], p[0][1], p[1][0], p[1][1])),
        "g2_inf": np.array([p is None for p in setup.g2_monomial], dtype=bool),
    }
    try:
        fd, tmp = tempfile.mkstemp(prefix=os.path.basename(path) + ".", suffix=".tmp", dir=os.path.dirname(path))
    except OSError:
        return False
    try:
        with os.fdopen(fd, "wb") as fh:
            np.savez(fh, **arrays)
        os.chmod(tmp, 0o644)  # mkstemp's 0600 would hide the cache from other users
        os.replace(tmp, path)
    except OSError:
        os.unlink(tmp)
        return False
    return True


def load_cache(path: str) -> TrustedSetup | None:
    """The setup cached at `path`, or None if there is none of this layout."""
    try:
        with np.load(path) as data:
            if int(data["layout"]) != CACHE_LAYOUT:
                return None
            g1 = _points(data["g1"], data["g1_inf"], lambda c: (c[0], c[1]))
            g2 = _points(data["g2"], data["g2_inf"], lambda c: ((c[0], c[1]), (c[2], c[3])))
    except (OSError, KeyError, ValueError, EOFError, zipfile.BadZipFile):
        return None
    return TrustedSetup(g1_monomial=g1, g2_monomial=g2)


def _coords(points, width, coords) -> np.ndarray:
    """Points -> uint8 [n, width, 48]: coords(p)'s big-endian bytes, zeros for the identity."""
    raw = b"".join(
        b"".join(c.to_bytes(_COORD_BYTES, "big") for c in (coords(p) if p is not None else (0,) * width))
        for p in points
    )
    return np.frombuffer(raw, dtype=np.uint8).reshape(len(points), width, _COORD_BYTES)


def _points(coords: np.ndarray, inf: np.ndarray, shape) -> list:
    """The inverse of _coords: shape(ints of a row), None where `inf`."""
    return [
        None if is_inf else shape([int.from_bytes(c.tobytes(), "big") for c in row])
        for row, is_inf in zip(coords, inf)
    ]
