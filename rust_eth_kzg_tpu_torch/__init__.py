"""PyTorch + CUDA port of rust_eth_kzg_tpu's PeerDAS (EIP-7594) and EIP-4844 calls.

`DASContext(device=...)` computes cells, FK20 cell proofs and commitments,
recovers cells and proofs from half of the cells, and verifies batches of
cell proofs; `Context4844` (also `DASContext.eip4844`) computes and
verifies single-point KZG proofs of blobs. A context can start from a
snapshot of its tables (`table_cache`), and its prover can be sharded over
a torch.distributed device mesh (`mesh`, `parallel/mesh.py`); G2
arithmetic is `ops/curve_g2.py`. The field and curve kernels are hand-written CUDA for sm_90a
(`csrc/`, loaded by `ops/kernels.py`), with plain torch versions that run
on the CPU; the closing pairing check runs in a native host library
(`csrc/host/`, loaded by `utils/native.py`).
"""

from .api import Context4844, DASContext
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
    "Context4844",
    "FK20Config",
    "TrustedSetup",
    "Error",
    "InvalidProofError",
    "ProverError",
    "RecoveryError",
    "SerializationError",
    "VerifierError",
]
