"""The port's scalar codec (rust_eth_kzg_tpu_torch.utils.serialization)
against the JAX package's: the same SerializationError message, word for
word, on non-canonical scalars. Both scan the four big-endian 64-bit words
of every scalar, word 0 first, and name the first scalar above r in the
word scanned; a scalar equal to r is reported after that scan. At mainnet
geometry a blob of the wrong length is named by its byte length, by the
codec and through `DASContext`'s blob dispatch, as in the JAX package."""

import pytest
import torch

from rust_eth_kzg_tpu import errors as JE
from rust_eth_kzg_tpu.utils import serialization as JSER
from rust_eth_kzg_tpu_torch import DASContext, FK20Config
from rust_eth_kzg_tpu_torch import errors as E
from rust_eth_kzg_tpu_torch.constants import BYTES_PER_BLOB, R_SCALAR
from rust_eth_kzg_tpu_torch.utils import serialization as ser

# One intra-op thread: the plain versions run many small tensor ops, and
# beside other busy processes (xdist workers, XLA compiles) a thread pool
# stalls each op until all its threads are scheduled.
torch.set_num_threads(1)

ABOVE_IN_LAST_WORD = R_SCALAR + 1
ABOVE_IN_WORD_0 = R_SCALAR + (1 << 192)


def _bytes(values):
    return b"".join(v.to_bytes(32, "big") for v in values)


@pytest.mark.parametrize(
    "values,index,relation",
    [
        ([5, R_SCALAR], 1, "=="),
        ([ABOVE_IN_LAST_WORD, ABOVE_IN_WORD_0], 1, ">="),
        ([ABOVE_IN_LAST_WORD, R_SCALAR], 0, ">="),
        ([R_SCALAR, ABOVE_IN_LAST_WORD], 1, ">="),
    ],
    ids=["equal_to_r", "word_0_first", "above_then_equal", "equal_then_above"],
)
def test_non_canonical_message_matches_jax(values, index, relation):
    data = _bytes(values)
    with pytest.raises(E.SerializationError) as got:
        ser.deserialize_scalars(data)
    with pytest.raises(JE.SerializationError) as want:
        JSER.deserialize_scalars(data)
    assert str(got.value) == str(want.value)
    assert str(got.value) == f"scalar at index {index} is not canonical ({relation} field modulus)"


@pytest.mark.parametrize("length", [BYTES_PER_BLOB - 32, 100], ids=["131040", "100"])
def test_blob_length_message_matches_jax(length):
    """The codec and the mainnet context's blob dispatch (a context shell:
    no tables are built) raise JAX's deserialize_blob message."""
    data = bytes(length)
    with pytest.raises(JE.SerializationError) as want:
        JSER.deserialize_blob(data)
    assert str(want.value) == f"blob has invalid length {length}, expected {BYTES_PER_BLOB}"
    with pytest.raises(E.SerializationError) as got:
        ser.deserialize_blob(data)
    assert str(got.value) == str(want.value)
    ctx = DASContext.__new__(DASContext)
    ctx.config, ctx.device = FK20Config(), "cpu"
    with pytest.raises(E.SerializationError) as got:
        ctx._data([bytes(BYTES_PER_BLOB), data])
    assert str(got.value) == str(want.value)
    assert ser.deserialize_blob(bytes(BYTES_PER_BLOB)).shape == (8, 4096)
