"""kzgbench/work/ counts the same work as chip_smoke.py's functions at the
main path's shapes: exactly for the G1 transforms, and within a few parts
in ten thousand for the fixed-base MSM, whose live digits chip_smoke counts
on the scalars it is given and kzgbench in expectation."""

import random
from types import SimpleNamespace

import pytest
import torch

import chip_smoke as CS
from kzgbench import peaks
from kzgbench.work import fixed_base_msm as W
from kzgbench.work import g1_fft as G

torch.set_num_threads(1)


def test_g1_fft_products_match():
    for n in (16, 128, 256):
        assert G.products(n) == CS.g1_fft_products(n)
    imad, _ = G.work({"fk20_blobs": 21, "poly_len": 4096, "cell_size": 64, "window": 8})
    assert imad == 42 * CS.g1_fft_products(128) * CS.mont_mul_imad(12)
    assert peaks.IMAD_PER_S == CS.IMAD_PER_S and peaks.HBM_BYTES_PER_S == CS.HBM_BYTES_PER_S


@pytest.mark.parametrize("blobs", [1, 8, 21])
def test_fixed_base_msm_counts_match(blobs):
    from rust_eth_kzg_tpu_torch.ops import field as F
    from rust_eth_kzg_tpu_torch.ops import kernels as K
    from rust_eth_kzg_tpu_torch.ops import msm as M

    rng = random.Random(blobs)
    vals = [rng.randrange(W.R) for _ in range(blobs * 128 * 64)]
    scalars = torch.from_numpy(F.FR.to_mont_host(vals)).reshape(8, blobs, 128, 64)
    tables = SimpleNamespace(window=8, chains=4, wpc=9, base_inf=torch.zeros(128, 256, dtype=torch.bool))
    theirs = CS.fixed_base_msm_work(K, M, tables, scalars)
    ours = W.counts(blobs * 128, 64, 8, instances=128)
    assert ours["imad"] == pytest.approx(theirs["imad"], rel=5e-4)
    assert ours["bytes"] == pytest.approx(theirs["bytes"], rel=5e-4)
    assert ours["imad"] == pytest.approx(W.work({"fk20_blobs": blobs, "poly_len": 4096, "cell_size": 64,
                                                 "window": 8})[0])
