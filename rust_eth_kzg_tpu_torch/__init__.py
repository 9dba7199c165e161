"""PyTorch + CUDA port of the PeerDAS (EIP-7594) calls of rust_eth_kzg_tpu.

`DASContext(device=...)` computes cells, FK20 cell proofs and commitments,
recovers cells and proofs from half of the cells, and verifies batches of
cell proofs. The field and curve kernels are hand-written CUDA for sm_90a
(`csrc/`, loaded by `ops/kernels.py`), with plain torch versions that run
on the CPU; the closing pairing check runs in a native host library
(`csrc/host/`, loaded by `utils/native.py`).
"""

from .api import DASContext
from .errors import (
    Error,
    InvalidProofError,
    ProverError,
    RecoveryError,
    SerializationError,
    VerifierError,
)
from .models.fk20 import FK20Config
from .utils.trusted_setup import TrustedSetup

__all__ = [
    "DASContext",
    "FK20Config",
    "TrustedSetup",
    "Error",
    "InvalidProofError",
    "ProverError",
    "RecoveryError",
    "SerializationError",
    "VerifierError",
]
