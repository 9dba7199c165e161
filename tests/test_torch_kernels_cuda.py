"""The port's CUDA kernels against their plain torch versions, on the card.

Marked `cuda`; skipped where torch sees no CUDA device. On a machine with a
card (which need not have JAX) run:
    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels_cuda.py
Integer arithmetic: every comparison is exact.
"""

import numpy as np
import pytest
import torch

from rust_eth_kzg_tpu_torch.ops import curve as C
from rust_eth_kzg_tpu_torch.ops import curve_g2 as G2
from rust_eth_kzg_tpu_torch.ops import decompress as D
from rust_eth_kzg_tpu_torch.ops import field as F
from rust_eth_kzg_tpu_torch.ops import kernels as K
from rust_eth_kzg_tpu_torch.ops import limbs as LB
from rust_eth_kzg_tpu_torch.ops import msm as M
from rust_eth_kzg_tpu_torch.ops import ntt
from rust_eth_kzg_tpu_torch.utils import bls_host as B
from rust_eth_kzg_tpu_torch.constants import FR_MULTIPLICATIVE_GENERATOR, R_SCALAR
from rust_eth_kzg_tpu_torch.utils.edge_inputs import decompress_inputs, edge_operands, inverse_edge_values, msm_scalars

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _field(spec, n, seed, device):
    rng = np.random.default_rng(seed)
    vals = [int(v) ** 7 % spec.modulus for v in rng.integers(1, 2**62, size=n)]
    return torch.from_numpy(spec.to_mont_host(vals)).to(device)


def _points(n, seed, device):
    rng = np.random.default_rng(seed)
    base = [B.g1_mul(B.G1_GEN, int(v)) for v in rng.integers(1, 2**62, size=8)]
    pts = [base[i % 8] for i in range(n)]
    pts[3] = None
    p = C.points_to_device(pts, device)
    lam = _field(F.FP, n, seed + 1, device)
    return C.G1(F.mont_mul_plain(F.FP, p.x, lam), F.mont_mul_plain(F.FP, p.y, lam), lam)


@pytest.mark.parametrize("spec", [F.FR, F.FP], ids=["fr", "fp"])
def test_mont_mul_kernel(device, spec):
    a, b = _field(spec, 1000, 1, device), _field(spec, 1000, 2, device)
    assert torch.equal(K.mont_mul(spec, a, b), F.mont_mul_plain(spec, a, b))


@pytest.mark.parametrize("spec", [F.FR, F.FP], ids=["fr", "fp"])
def test_mont_mul_edge_operands(device, spec):
    """The PTX core on the edge operands, against Python integers and the
    plain version, both operand orders' bounds kept (a < 2m, b < m)."""
    a, b = edge_operands(spec, n_random=4096)
    ta = torch.from_numpy(LB.ints_to_limbs(a, spec.nlimbs)).to(device)
    tb = torch.from_numpy(LB.ints_to_limbs(b, spec.nlimbs)).to(device)
    got = K.mont_mul(spec, ta, tb)
    r_inv = pow(spec.r, -1, spec.modulus)
    assert LB.limbs_to_ints(got.cpu().numpy()) == [x * y * r_inv % spec.modulus for x, y in zip(a, b)]
    assert torch.equal(got, F.mont_mul_plain(spec, ta, tb))


@pytest.mark.parametrize("spec", [F.FR, F.FP], ids=["fr", "fp"])
def test_mont_mul_chain_probe(device, spec):
    """The chain probe squares each lane k times: a^(2^k)."""
    vals = [v * 7919 % spec.modulus for v in range(1, 65)]
    x = torch.from_numpy(spec.to_mont_host(vals)).to(device)
    for k in (0, 1, 37):
        got = spec.from_mont_host(K.mont_mul_chain(spec, x, k).cpu().numpy())
        assert got == [pow(v, 1 << k, spec.modulus) for v in vals]


def test_field_butterfly_kernel(device):
    dom = ntt.Domain(256, device)
    x = _field(F.FR, 3 * 256, 3, device).reshape(8, 3, 256)
    for stage in range(8):
        got = K.field_butterfly(F.FR, x, dom._tw["inv"], stage)
        assert torch.equal(got, F.butterfly_plain(F.FR, x, dom._tw["inv"], stage))


def test_g1_kernels(device):
    p, q = _points(300, 4, device), _points(300, 5, device)
    q = C.G1(*(torch.cat((c[:, :150], pc[:, 150:]), dim=1) for c, pc in zip(q, p)))  # equal lanes
    assert all(torch.equal(g, w) for g, w in zip(K.g1_add(p, q), C.add_plain(p, q)))
    assert all(torch.equal(g, w) for g, w in zip(K.g1_double(p), C.double_plain(p)))
    a, b = C.batch_normalize(p), C.batch_normalize(_points(300, 6, device))
    got = K.g1_add_affine(a.x, a.y, a.inf, b.x, b.y, b.inf)
    assert all(torch.equal(g, w) for g, w in zip(got, C.add_affine_plain(a, b)))


def test_g1_add_mixed_kernel(device):
    """Projective p + affine q with identity q lanes, identity p lanes and
    p == q lanes (the complete formula doubles there)."""
    p = _points(300, 8, device)
    q = C.batch_normalize(_points(300, 9, device))
    ident = C.identity((300,), device)
    p = C.select(torch.arange(300, device=device) % 11 == 0, ident, p)
    same = C.batch_normalize(p)
    mask = (torch.arange(300, device=device) % 7 == 3) & ~same.inf
    q = C.G1Affine(F.select(mask, same.x, q.x), F.select(mask, same.y, q.y), q.inf | (torch.arange(300, device=device) % 13 == 5))
    got = K.g1_add_mixed(p, q.x, q.y, q.inf)
    assert all(torch.equal(g, w) for g, w in zip(got, C.add_mixed_plain(p, q)))
    want = C.add(p, C.G1(q.x, q.y, F.select(q.inf, torch.zeros_like(q.x), F.FP.broadcast(F.FP.one(device), (300,)))))
    assert bool(C.equal(C.G1(*got), C.select(q.inf, p, want)).all())


@pytest.mark.parametrize("n", [1, 128, 333, 1024, 32 * 640 + 5, 65536])
def test_batch_inverse_kernel(device, n):
    """The GCD kernel in both modes (a GCD a lane; one a block behind
    Montgomery's trick) against batch_inverse_plain, Fp and Fr: the GCD's
    edge values first, and zero lanes in several blocks (lanes i = c mod
    ceil(n / 32)), whose blocks must come out zero."""
    c = -(-n // 32)
    for spec in (F.FR, F.FP):
        z = _field(spec, n, 7, device)
        edges = inverse_edge_values(spec)[:n]
        z[:, : len(edges)] = torch.from_numpy(spec.to_mont_host(edges)).to(device)
        zeros = sorted({n - 1, n // 2, 7 % n} - set(range(len(edges)))) if n > 1 else []
        z[:, zeros] = 0
        want = F.batch_inverse_plain(spec, z)
        dead = torch.zeros(n, dtype=torch.bool, device=device)
        for i in zeros:
            dead |= torch.arange(n, device=device) % c == i % c
        assert bool(F.is_zero(spec, want)[dead].all()) and not bool(F.is_zero(spec, want)[~dead].any())
        for per_lane in (True, False):
            assert torch.equal(K.batch_inverse(spec, z, per_lane=per_lane), want)
        assert torch.equal(K.batch_inverse(spec, z), want)


@pytest.mark.parametrize("n", [64, 128, 4096, 8192])
@pytest.mark.parametrize("rows", [1, 8])
def test_ntt_kernel(device, n, rows):
    """Domain's four transforms on CUDA tensors (one `ntt` call each: one
    launch up to 1,024 points, two above) against `_dit_plain` with the same
    scales, limb for limb."""
    dom = ntt.Domain(n, device)
    x = _field(F.FR, rows * n, 50 + rows, device).reshape(8, rows, n)
    g = FR_MULTIPLICATIVE_GENERATOR
    cases = [(dom.fft, (), "fwd", None, None), (dom.ifft, (), "inv", None, dom._scale("ifft")),
             (dom.coset_fft, (g,), "fwd", dom._scale(("coset", g)), None),
             (dom.coset_ifft, (g,), "inv", None, dom._scale(("coset_inv", g)))]
    for fn, args, tag, pre, post in cases:
        before = dict(K.LAUNCHES)
        got = fn(x, *args)
        assert K.LAUNCHES["ntt"] == before["ntt"] + (2 if n > 1024 else 1)
        assert all(K.LAUNCHES[k] == before[k] for k in K.LAUNCHES if k != "ntt")
        assert torch.equal(got, dom._dit_plain(x, tag, pre, post))



@pytest.mark.parametrize("rows,n", [(1, 16), (1, 128), (8, 128), (64, 128)])
def test_g1_fft_kernel(device, rows, n):
    """The fused G1 transform against the plain stage-by-stage route, both
    directions, limb for limb: points with identity lanes and equal lanes,
    row 0 the identity in its second half (the proof transform's padding)
    and, where there is one, row 1 all identity."""
    dom = ntt.Domain(n, device)
    p = C._map(lambda c: c.reshape(12, rows, n).clone(), _points(rows * n, 10 + rows, device))
    ident = C.identity((n,), device)
    for c, ic in zip(p, ident):
        c[:, 0, n // 2 :] = ic[:, n // 2 :]
        if rows > 1:
            c[:, 1] = ic
    for tag in ("fwd", "inv"):
        before = dict(K.LAUNCHES)
        got = dom._dit_g1(p, tag)
        assert K.LAUNCHES["g1_fft"] == before["g1_fft"] + 1
        assert all(K.LAUNCHES[k] == before[k] for k in ("g1_add", "g1_double"))
        want = dom._dit_g1_plain(p, tag)
        assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("n", [129, 1032])
def test_g1_decompress_kernel(device, n):
    """The fused decompression kernel against decompress_g1_plain on every
    lane: the point's three coordinates and both flags, off-curve and
    non-subgroup lanes included; one launch."""
    (x, sort, inf), kinds = decompress_inputs(n, 40 + n)
    x, sort, inf = torch.from_numpy(x).to(device), torch.from_numpy(sort).to(device), torch.from_numpy(inf).to(device)
    assert bool(sort.any()) and not bool(sort.all())
    before = dict(K.LAUNCHES)
    pt, on_curve, in_sub = D.decompress_g1(x, sort, inf)
    assert K.LAUNCHES["g1_decompress"] == before["g1_decompress"] + 1
    assert all(K.LAUNCHES[k] == before[k] for k in K.LAUNCHES if k != "g1_decompress")
    want_pt, want_on, want_sub = D.decompress_g1_plain(x, sort, inf)
    assert all(torch.equal(g, w) for g, w in zip(pt, want_pt))
    assert torch.equal(on_curve, want_on) and torch.equal(in_sub, want_sub)
    on, sub = on_curve.tolist(), in_sub.tolist()
    for i, kind in enumerate(kinds):
        assert on[i] == (kind != "off_curve")
        if kind != "off_curve":
            assert sub[i] == (kind != "not_in_subgroup")


def test_g1_decompress_kernel_eip4844_batch(device):
    """The 16 lanes of an EIP-4844 batch of 8 (commitments and proofs in one
    launch) against decompress_g1_plain: identity, off-curve and
    non-subgroup lanes among them."""
    (x, sort, inf), kinds = decompress_inputs(16, 56)
    assert {"identity", "off_curve", "not_in_subgroup"} <= set(kinds)
    x, sort, inf = torch.from_numpy(x).to(device), torch.from_numpy(sort).to(device), torch.from_numpy(inf).to(device)
    before = dict(K.LAUNCHES)
    got = D.decompress_g1(x, sort, inf)
    assert K.LAUNCHES["g1_decompress"] == before["g1_decompress"] + 1
    want = D.decompress_g1_plain(x, sort, inf)
    assert all(torch.equal(g, w) for g, w in zip((*got[0], *got[1:]), (*want[0], *want[1:])))


def test_lincomb_host_eip4844_batch(device):
    """lincomb_host at the EIP-4844 batch verifier's 17 lanes (2B + 1, B = 8),
    as its two MSMs ([2, 17]: identity points and zero scalars among them),
    on the g1_add and g1_double kernels, against the plain route; and the
    sums against host arithmetic."""
    n = 17
    lanes = torch.arange(2 * n, device=device)
    pts = C.select(lanes % 7 == 3, C.identity((2 * n,), device), _points(2 * n, 57, device))
    pts = C._map(lambda c: c.reshape(12, 2, n).contiguous(), pts)
    rng = np.random.default_rng(58)
    scalars = [[int(v) ** 4 % R_SCALAR for v in rng.integers(1, 2**62, size=n)] for _ in range(2)]
    scalars[0][5] = 0
    scalars[1][8:] = [0] * (n - 8)
    before = dict(K.LAUNCHES)
    got = M.lincomb_host(pts, scalars)
    assert K.LAUNCHES["g1_add"] > before["g1_add"] and K.LAUNCHES["g1_double"] > before["g1_double"]
    assert K.LAUNCHES["g1_fft"] == before["g1_fft"]
    want = M.lincomb_host(pts, scalars, plain=True)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    host = C.points_from_device(C._map(lambda c: c.reshape(12, -1), pts))
    sums = []
    for r in range(2):
        acc = None
        for p, k in zip(host[r * n : (r + 1) * n], scalars[r]):
            acc = B.g1_add(acc, B.g1_mul(p, k) if p is not None else None)
        sums.append(acc)
    assert C.points_from_device(got) == sums


@pytest.mark.parametrize("n_inst,n_pts,batch", [(128, 64, 1), (128, 64, 2), (64, 64, 2), (32, 64, 2), (0, 64, 1),
                                                 (0, 2048, 2)],
                         ids=["fk20_b1", "fk20_b2", "fk20_work2_b2", "fk20_work4_b2", "commit_64", "commit_2048_b2"])
def test_fixed_base_msm_kernel(device, n_inst, n_pts, batch):
    """The fused fixed-base MSM against fixed_base_msm_plain limb for limb, on
    window-8, 4-chain tables: the FK20 shape (128 instances of 64 points),
    a rank's slot slice of it over a mesh's work dim (64 and 32 instances),
    the verifier's 64-point commitment table, and a commit key of 2,048
    points (8,192 lanes a window sum, split over 32 blocks). An identity
    base point in every table; zero scalars, r - 1, and an all-zero first
    row where the batch is 2. Two launches of one kernel source, and no
    g1_add, g1_double or g1_add_affine launch."""
    inst = (n_inst,) if n_inst else ()
    n = max(n_inst, 1) * n_pts
    pts = C.select(torch.arange(n, device=device) % 61 == 3, C.identity((n,), device), _points(n, 30, device))
    pts = C._map(lambda c: c.reshape((12,) + inst + (n_pts,)).contiguous(), pts)
    tables = M.build_fixed_base_msm(pts, 8, instance_ndim=len(inst))
    assert bool(tables.base_inf.any())
    scalars = torch.from_numpy(msm_scalars((batch,) + inst + (n_pts,), 31 + n_pts)).to(device)
    before = dict(K.LAUNCHES)
    got = M.fixed_base_msm(tables, scalars)
    assert K.LAUNCHES["fixed_base_msm"] == before["fixed_base_msm"] + K.LAUNCHES_PER_CALL["fixed_base_msm"] == before["fixed_base_msm"] + 2
    assert all(K.LAUNCHES[k] == before[k] for k in K.LAUNCHES if k != "fixed_base_msm")
    after = dict(K.LAUNCHES)
    want = M.fixed_base_msm_plain(tables, scalars)
    assert dict(K.LAUNCHES) == after  # the plain route launches nothing
    assert all(g.shape == (12, batch) + inst for g in got)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    if batch > 1:
        assert bool(C.is_identity(C._map(lambda c: c[:, 0], C.G1(*got))).all())


def test_g2_on_the_card(device):
    """G2 add, double and g2_lincomb (N = 4, an identity point, a zero
    scalar) on CUDA tensors against their CPU route: every Fp product is a
    mont_mul launch, and no G1 kernel runs."""
    rng = np.random.default_rng(50)
    pts = [B.g2_mul(B.G2_GEN, int(v)) for v in rng.integers(1, 2**62, size=4)]
    pts[1] = None
    scal = [int(v) ** 5 % R_SCALAR for v in rng.integers(1, 2**62, size=4)]
    scal[2] = 0
    sm = torch.from_numpy(F.FR.to_mont_host(scal))
    on_card = G2.points_to_device(pts, device)
    before = dict(K.LAUNCHES)
    got = G2.g2_lincomb(on_card, sm.to(device))
    assert {k for k in K.LAUNCHES if K.LAUNCHES[k] != before[k]} == {"mont_mul"}
    want = G2.g2_lincomb(G2.points_to_device(pts, "cpu"), sm)
    assert G2.points_from_device(got) == G2.points_from_device(want)
    q = G2.points_to_device(pts[::-1], device)
    for g, w in ((G2.add(on_card, q), G2.add(G2.points_to_device(pts, "cpu"), G2.points_to_device(pts[::-1], "cpu"))),
                 (G2.double(on_card), G2.double(G2.points_to_device(pts, "cpu")))):
        assert G2.points_from_device(g) == G2.points_from_device(w)


def test_prove_spans_on_the_card(device, tmp_path):
    """A mainnet prove B=1 inside tracing.device_trace: the JAX prover's four
    span names, each with CUDA kernel time under it."""
    from rust_eth_kzg_tpu_torch import DASContext
    from rust_eth_kzg_tpu_torch.utils import tracing

    spans = ["fk20/h_poly_commitments", "fk20/proofs_g1_fft", "fk20/coset_evaluations", "fk20/batch_normalize"]
    ctx = DASContext(device=device)
    rng = np.random.default_rng(60)
    blob = b"".join((int(v) ** 5 % R_SCALAR).to_bytes(32, "big") for v in rng.integers(1, 2**62, size=4096))
    want = ctx.compute_cells_and_kzg_proofs(blob)
    with tracing.device_trace(str(tmp_path)) as prof:
        got = ctx.compute_cells_and_kzg_proofs(blob)
        torch.cuda.synchronize()
    assert got == want
    device_us = {}
    for ev in prof.key_averages():
        if ev.key in spans:
            device_us[ev.key] = getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0.0)
    assert set(device_us) == set(spans) and all(us > 0 for us in device_us.values()), device_us
    assert len(list(tmp_path.glob("*.pt.trace.json"))) == 1


def test_verify_and_recover_spans_on_the_card(device, tmp_path):
    """A mainnet verify of one 6-blob transaction (768 cells) and a mainnet
    recovery of 2 blobs from 64 of their 128 cells inside
    tracing.device_trace: every stage span lies within its call's root span,
    the decompression kernel runs under verifier/decompress and Pippenger's
    g1_double and g1_add under verifier/lincomb, and the outputs are those of
    the untraced calls."""
    import json

    from rust_eth_kzg_tpu_torch import DASContext
    from rust_eth_kzg_tpu_torch.utils import tracing

    stages = {
        "das/verify_cell_kzg_proof_batch": ["das/verify_inputs", "verifier/prepare", "verifier/decompress",
                                            "verifier/lincomb", "verifier/interpolate", "verifier/check"],
        "das/recover_cells_and_kzg_proofs_batch": [
            "das/recovery_arrays", "das/upload", "rs/decode", "fk20/h_poly_commitments", "fk20/proofs_g1_fft",
            "fk20/coset_evaluations", "fk20/batch_normalize", "das/degree_check", "das/cells_bytes",
            "das/proofs_bytes"],
    }
    ctx = DASContext(device=device)
    rng = np.random.default_rng(61)
    blobs = [b"".join((int(v) ** 5 % R_SCALAR).to_bytes(32, "big") for v in rng.integers(1, 2**62, size=4096))
             for _ in range(6)]
    proved = ctx.compute_cells_and_kzg_proofs_batch(blobs)
    comms = [ctx.blob_to_kzg_commitment(b) for b in blobs]
    ks = range(128)
    verify_args = ([comms[b] for b in range(6) for _ in ks], [k for _ in range(6) for k in ks],
                   [proved[b][0][k] for b in range(6) for k in ks], [proved[b][1][k] for b in range(6) for k in ks])
    keep = list(range(0, 128, 2))
    recover_args = ([(keep, [cells[k] for k in keep]) for cells, _ in proved[:2]],)
    assert ctx.verify_cell_kzg_proof_batch(*verify_args) is None
    want = ctx.recover_cells_and_kzg_proofs_batch(*recover_args)
    assert want == proved[:2]
    with tracing.device_trace(str(tmp_path)):
        verdict = ctx.verify_cell_kzg_proof_batch(*verify_args)
        got = ctx.recover_cells_and_kzg_proofs_batch(*recover_args)
        torch.cuda.synchronize()
    assert verdict is None and got == want

    (path,) = tmp_path.glob("*.pt.trace.json")
    with open(path) as fh:
        events = [e for e in json.load(fh)["traceEvents"] if e.get("ph") == "X"]
    spans = {}
    for e in events:
        if e.get("cat") == "user_annotation":
            spans.setdefault(e["name"], []).append((e["ts"], e["ts"] + e["dur"]))
    for root, leaves in stages.items():
        assert len(spans.get(root, [])) == 1, root
        (lo, hi) = spans[root][0]
        for leaf in leaves:
            assert spans.get(leaf) and all(lo <= s and e <= hi for s, e in spans[leaf]), (root, leaf)
    launched = {}
    for e in events:
        corr = (e.get("args") or {}).get("correlation")
        if e.get("cat") in ("cuda_runtime", "cuda_driver") and corr is not None:
            launched[corr] = e["ts"]

    def launches_of(kernel):
        out = [launched.get(e["args"].get("correlation")) for e in events
               if e.get("cat") == "kernel" and kernel + "(" in e["name"]]
        assert out and None not in out, kernel
        return out

    for kernel, span in (("g1_decompress_kernel", "verifier/decompress"), ("g1_double_kernel", "verifier/lincomb"),
                         ("g1_add_kernel", "verifier/lincomb")):
        assert all(any(s <= t <= e for s, e in spans[span]) for t in launches_of(kernel)), kernel
