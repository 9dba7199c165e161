#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `rust_eth_kzg_tpu_torch/csrc/` (and its
native pairing library from `csrc/host/`) and runs, printing one JSON line
per phase:
  1. build           nvcc time, registers and spills of every kernel;
  2. kernels         each kernel against its plain torch version on the card,
                     exactly (integer arithmetic: tolerance 0); the Fp/Fr
                     core (mont_mul) also on edge operands against Python
                     integers, and its chain probe: the latency of one
                     dependent product (one lane, k = 1 and k = 4,096
                     squarings in a row) and the products per second over
                     2^23 Fp lanes; for g1_fft and g1_decompress the
                     critical path of their dependent chains; ntt at every
                     shape the paths run (fft, ifft and the coset forms);
                     batch_inverse in both modes (a GCD a lane, one a block)
                     with zero lanes and at the table build's slice (2^20 Fp
                     lanes, one GCD a block), the two modes timed over a
                     sweep of sizes and the GCD's one-lane latency;
                     g1_decompress at the 16 lanes of an EIP-4844 batch of 8,
                     and g1_add / g1_double as that batch verifier's two
                     MSMs (lincomb_host over [2, 17] lanes) against their
                     plain route;
  3. mainnet_setup   DASContext() on the embedded mainnet setup, then the
                     prove path: compute_cells_and_kzg_proofs_batch on the
                     zero blob and seven seeded random blobs (zero-blob,
                     systematic-cell and repeatability checks); then the
                     last kernel of phase 2, fixed_base_msm, against its
                     plain version on the prover's mainnet tables (the FK20
                     slot MSMs of 1 blob timed, of 8 blobs timed as
                     "wide"; a rank's slot slice at work = 2 and 4), the
                     verifier's 64-point commitment table and
                     the 4,096-point commit key (zero scalars, r - 1,
                     all-zero rows, identity base points), with its work
                     from this run's digits and the device ms of its two
                     launches;
  4. recover         recover_cells_and_kzg_proofs(_batch) from 64 of 128
                     cells, one blob and the 8 blobs with a seeded pattern
                     each, against the prover's bytes; too few cells and a
                     corrupted cell must raise RecoveryError;
  5. verify          verify_cell_kzg_proof_batch accepts the port's own
                     proofs (128 cells of one blob; 1,024 cells of 8 blobs)
                     and rejects four tampered batches with the right error;
  5b. eip4844        the five EIP-4844 calls on the same context and blobs:
                     the commitments of phase 5; compute_kzg_proof at a cell
                     element's evaluation point (cell 0 and a seeded cell)
                     returns that element of phase 3's cells; the three
                     checks accept at a seeded z and every blob's proof;
                     the zero blob gives the identity; y + 1, another blob's
                     proof, a swapped pair, z = r, an off-curve commitment,
                     a proof outside the subgroup and mismatched lengths are
                     rejected with the JAX package's error classes; the
                     empty batch passes;
  5c. mesh           parallel/mesh.py: a world of 2 gloo ranks (spawned,
                     sharing cuda:0, exchanging through host memory, each
                     with a hard time limit): DASContext on a work = 2 mesh
                     proves phase 3's 8 blobs and recovers them from 64 of
                     128 cells, one on a dp = 2 mesh proves them, all
                     byte-equal to phases 3 and 4 (digests sent back to
                     this process); fft_sharded at [8, 8, 8192] equals
                     Domain.fft and lincomb_sharded of 1,024 setup points
                     msm.lincomb; each rank holds half of the FK20 tables
                     and its work-sharded prove is 2 g1_fft launches and
                     one fixed_base_msm call; the proves timed (median of
                     3), and an all_gather of the slot results. Then a
                     world of 1 NCCL rank: a (1, 1) mesh proves the 8 blobs
                     byte-equal, its collectives on CUDA tensors with no
                     host copy. The port's setup cache is removed before
                     the gloo world: both ranks miss it and race to write
                     it, and one whole cache file equal to a parse must
                     remain;
  5d. g2             curve_g2.g2_lincomb over the setup's 65 G2 points with
                     seeded scalars against a host oracle (bls_host), with
                     mont_mul launches and no G1 kernel; add and double on
                     the card against their CPU route;
  6. launches        the kernel launch counts of one call of each path
                     (prove B=8, recover B=8, verify 1,024 cells,
                     compute_blob_kzg_proof of one blob,
                     verify_blob_kzg_proof_batch of 8 blobs, rank 0's
                     work-sharded prove B=8 of phase 5c, g2_lincomb of 65
                     points), each reset
                     just before its call and read just after: every kernel
                     a path runs must have launched on it, the prover's two
                     G1 transforms as 2 g1_fft launches and its fixed-base
                     MSM as one fixed_base_msm call (2 launches) with no
                     g1_add, g1_double or g1_add_affine launch beside them,
                     every NTT an ntt call (at most 5 launches a prove, 16
                     a recover, 2 a verify) and no field_butterfly launch,
                     the verifier's decompression as 1 g1_decompress launch
                     with at most 20 mont_mul launches in the whole call and
                     its commitment MSM as one fixed_base_msm call; every
                     kernel is launched on some path or runs inside one that
                     is and names it in its `replaces` (g1_add_mixed in
                     g1_decompress, g1_add_affine in fixed_base_msm,
                     field_butterfly in ntt); the EIP-4844 prover as one
                     fixed_base_msm call, at most 2 ntt launches and no G1
                     transform or per-operation group kernel, its batch
                     verifier as 1 g1_decompress launch and the g1_add /
                     g1_double GLV ladders, no g1_fft; the mesh prove as
                     the prover's; g2_lincomb as mont_mul launches alone;
  6b. table_free     DASContext(use_precomp=None): no fixed-base table; a
                     prove B=1, a commitment and a recover B=1 through
                     Pippenger, byte-equal to the table route, with its
                     init, prove and recover seconds;
  6c. persist        the table snapshot: the mainnet tables saved under a
                     temporary directory, a DASContext(table_cache=...)
                     whose init launches no g1_fft and no table-build
                     kernel, its prove of the 8 blobs byte-equal to phase
                     3; seconds to save, file bytes, cold init against init
                     from the snapshot; a snapshot of another geometry or
                     window refused (the latter rebuilt and saved); the
                     trusted setup's cache (under a temporary directory):
                     a miss (parse and write), the write alone and a hit,
                     equal to the parse; both inits again with the setup
                     cache warm;
  7. mainnet_oracle  an insecure mainnet-size setup with a seeded tau: cells,
                     four proofs and the commitment against host Python-int
                     oracles (models/naive.py), and compute_kzg_proof at two
                     z: y = f(z), proof [(f(tau) - y) / (tau - z)] G;
  8. timing          prove B=1 and B=8, verify 128 and 1,024 cells, recover
                     B=1 and B=8, compute_blob_kzg_proof B=1,
                     compute_kzg_proof, verify_kzg_proof,
                     verify_blob_kzg_proof and verify_blob_kzg_proof_batch
                     of 8 blobs: median of 5 after a warm-up, device busy
                     time, host share and launches per call; stage splits
                     of a prove, a verify, a recover and the 8-blob
                     verify_blob_kzg_proof_batch; g2_lincomb of 65 points
                     (median of 3) and phase 5c's two mesh proves (median
                     of 3 in each rank; no scaling figure: both ranks share
                     one card); then utils/tracing.py: a prove B=8 inside
                     device_trace holds its root span and the four prover
                     spans in order, each with CUDA time under it, a prove
                     B=8 with TRACE_ENABLED prints its span lines (stages,
                     then the root), both byte-equal to phase 3; prove B=1
                     and recover B=8 by the host clock with the spans and
                     with null spans, interleaved.
Then the per-kernel summary line, the card's name and power limit, and as
the last line {"ok": true, "device": {...}}. Any failed check exits nonzero.
Needs one CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import json
import os
import random
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 20260
# H100 SXM peaks: HBM 3.35 TB/s; 32-bit integer multiply-add at 64 per SM per
# clock, half the fp32 FMA rate behind the 67 TFLOP/s fp32 figure:
# 132 SMs x 64 x 1.98 GHz = 16.7e12 IMAD/s. A 32x32 -> 64-bit limb product
# takes 2 IMADs (low and high halves), a low-half product 1.
HBM_BYTES_PER_S = 3.35e12
IMAD_PER_S = 132 * 64 * 1.98e9


class CheckFailed(Exception):
    pass


def check(cond, what):
    if not cond:
        raise CheckFailed(what)


def emit(obj):
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, reps):
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def mont_mul_imad(nlimbs):
    # CIOS: N^2 products a_i b_j and N^2 products m p_j (2 IMADs each), N low products m
    return 2 * (2 * nlimbs * nlimbs) + nlimbs


# Products of the g1_fft kernel: a doubling is 8 Montgomery products and an
# addition 12 (the products by 3b = 12 are additions); each product round of
# a team holds one doubling's or addition's independent products.
DBL_PRODUCTS, ADD_PRODUCTS, DBL_ROUNDS, ADD_ROUNDS = 8, 12, 2, 2
GLV_STEPS = 65


def _ladder(products_dbl, products_add, beta):
    """One GLV ladder: the product by beta, the table (2 doublings, 14
    additions) and 65 steps of 2 doublings and 1 addition."""
    return beta + 2 * products_dbl + 14 * products_add + GLV_STEPS * (2 * products_dbl + products_add)


def g1_fft_products(n):
    """Montgomery products of one n-point row: n/2 butterflies a stage (2
    additions each), and a ladder per butterfly in stages 1..log n - 1."""
    log_n = n.bit_length() - 1
    return (n // 2) * (log_n * 2 * ADD_PRODUCTS + (log_n - 1) * _ladder(DBL_PRODUCTS, ADD_PRODUCTS, 1))


def g1_fft_rounds(n):
    """Product rounds on one team's dependent chain through a whole row."""
    log_n = n.bit_length() - 1
    return log_n * 2 * ADD_ROUNDS + (log_n - 1) * _ladder(DBL_ROUNDS, ADD_ROUNDS, 1)


def _one_lane_ms(torch, fn, launches):
    """Device ms of one launch of `fn`, from `launches` launches replayed from
    one CUDA graph, so that no Python is timed."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / launches


def g1_fft_latency_floor(torch, K, C, F, device, launches=200):
    """The critical-path floor of g1_fft at 128 points: its product rounds
    times the latency of one dependent Fp product on one lane, read from
    the g1_double kernel (9 dependent products) on one lane. That reading
    also holds the launch and the loads; the one-lane g1_add (14 products)
    beside it gives a second reading with those cancelled, (add - double) / 5."""
    p, _ = _random_points(C, F, 1, SEED + 30, device)
    p = C.G1(*(c.contiguous() for c in p))
    dbl = _one_lane_ms(torch, lambda: K.g1_double(p), launches)
    add = _one_lane_ms(torch, lambda: K.g1_add(p, p), launches)
    per_product = dbl / 9
    rounds = g1_fft_rounds(128)
    return {"g1_double_1lane_ms": dbl, "g1_add_1lane_ms": add, "product_latency_ms": per_product,
            "product_latency_diff_ms": (add - dbl) / 5, "product_rounds": rounds,
            "critical_path_ms": rounds * per_product, "critical_path_diff_ms": rounds * (add - dbl) / 5}


# Montgomery products of one g1_decompress lane (csrc/g1_decompress.cu):
# x R, x^3 (2), the root's table (1 squaring, 15 products), 375 squarings and
# 66 products, y^2 and y's standard form; then the subgroup ladder, 128
# doublings of 9 products and 48 mixed additions of 13; and 3 to compare.
# The dependency depth of a live lane:
# 460 products to the root, 1 for the sign, 3 per doubling and 3 per
# addition, 2 for the comparison.
DECOMPRESS_ROOT_PRODUCTS = 1 + 2 + 16 + 375 + 66 + 2
DECOMPRESS_LIVE_PRODUCTS = DECOMPRESS_ROOT_PRODUCTS + 128 * 9 + 48 * 13 + 3
DECOMPRESS_DEPTH = 460 + 1 + 128 * 3 + 48 * 3 + 2
CHAIN_LONG = 4096


def chain_probe(torch, spec, run, device, throughput_lanes=1 << 23, throughput_k=8):
    """The latency of one dependent Montgomery product: `run(x, k)` (the chain
    probe: k squarings in a row on every lane of x) on one lane at k = 1 and
    k = CHAIN_LONG, each replayed from a CUDA graph, (long - short) /
    (CHAIN_LONG - 1); and, for Fp, products per second over
    `throughput_lanes` lanes at k = `throughput_k` against the IMAD bound.
    Checks the squarings against Python integers."""
    vals = _random_ints(spec.modulus, 64, SEED + 40)
    x64 = torch.from_numpy(spec.to_mont_host(vals)).to(device)
    for k in (1, 37):
        got = spec.from_mont_host(run(x64, k).cpu().numpy())
        check(got == [pow(v, 1 << k, spec.modulus) for v in vals], f"chain probe {spec.name} k = {k}")
    one = x64[:, :1].contiguous()
    short = _one_lane_ms(torch, lambda: run(one, 1), 200)
    long = _one_lane_ms(torch, lambda: run(one, CHAIN_LONG), 10)
    out = {"chain_1_ms": short, f"chain_{CHAIN_LONG}_ms": long,
           "product_latency_us": (long - short) / (CHAIN_LONG - 1) * 1e3}
    if spec.name == "fp" and throughput_lanes:
        g = torch.Generator(device=device).manual_seed(SEED)
        x = torch.randint(0, 2**31, (spec.nlimbs, throughput_lanes), generator=g, device=device, dtype=torch.int32)
        x[-1] %= spec.modulus >> (32 * (spec.nlimbs - 1))  # top limb below p's: every value < p
        ms = cuda_ms(lambda: run(x, throughput_k), 5)
        products = throughput_lanes * throughput_k
        head = x[:, :16].cpu().numpy()
        got = spec.from_mont_host(run(x, throughput_k)[:, :16].cpu().numpy())
        check(got == [pow(v, 1 << throughput_k, spec.modulus) for v in spec.from_mont_host(head)],
              "chain probe over many lanes")
        out.update({"throughput_lanes": throughput_lanes, "throughput_k": throughput_k, "throughput_ms": ms,
                    "products_per_s": products / (ms / 1e3),
                    "imad_bound_products_per_s": IMAD_PER_S / mont_mul_imad(spec.nlimbs)})
    return out


def batch_inverse_imad(K, spec, n):
    """IMADs that batch_inverse's function needs on n lanes, in either mode:
    its contract has ceil(n / 32) blocks, so Montgomery's trick does it with
    one GCD a block and 3 products a lane. A GCD is, each outer iteration, 4
    linear combinations of N words (2 products of 2 IMADs a word) and 2
    one-word Montgomery steps (N + 1 products), then one Montgomery product
    (the 31-step loops' adds and shifts are not counted)."""
    nl = spec.nlimbs
    gcd = K.GCD_OUTER[spec.name] * (16 * nl + 4 * nl + 2) + mont_mul_imad(nl)
    return -(-n // 32) * gcd + 3 * n * mont_mul_imad(nl)


def bound(imad, nbytes):
    t_ops = imad / IMAD_PER_S * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# ---------------------------------------------------------------- phases


def phase_build(K):
    t0 = time.perf_counter()
    info = K.build_all()
    out = {}
    for name, rec in info.items():
        funcs = rec["functions"].values()
        out[name] = {
            "nvcc_s": rec["seconds"],
            "cached": rec["cached"],
            "registers": max(f["registers"] or 0 for f in funcs),
            "spill_stores": max(f["spill_stores"] for f in funcs),
            "spill_loads": max(f["spill_loads"] for f in funcs),
            "stack": max(f["stack"] for f in funcs),
            "functions": rec["functions"],
        }
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "kernels": out})
    return out


def _random_ints(modulus, n, seed):
    """n integers below `modulus` from numpy.random.default_rng(seed)."""
    import numpy as np

    words = np.random.default_rng(seed).integers(0, 2**32, size=(n, 16), dtype=np.uint64)
    raw = words.astype("<u4").tobytes()
    return [int.from_bytes(raw[64 * i : 64 * (i + 1)], "little") % modulus for i in range(n)]


def _random_field(spec, n, seed, device):
    import torch

    ints = _random_ints(spec.modulus, n, seed)
    return ints, torch.from_numpy(spec.to_mont_host(ints)).to(device)


def _random_points(C, F, n, seed, device):
    """n projective points: 16 host-made curve points k G spread over the
    lanes, each lane rescaled (X, Y, Z) -> (l X, l Y, l Z) by a random l."""
    import torch

    from rust_eth_kzg_tpu_torch.utils import bls_host as B

    import numpy as np

    base = [B.g1_mul(B.G1_GEN, k or 1) for k in _random_ints(F.FR.modulus, 16, seed)]
    pts = [base[i] for i in np.random.default_rng(seed).integers(0, 16, size=n)]
    p = C.points_to_device(pts, device)
    _, lam = _random_field(F.FP, n, seed + 1, device)
    return C.G1(F.mont_mul_plain(F.FP, p.x, lam), F.mont_mul_plain(F.FP, p.y, lam), lam), pts


def _max_abs_err(got, want):
    import torch

    worst = 0
    for g, w in zip(got, want):
        d = (g.to(torch.int64) & 0xFFFFFFFF) - (w.to(torch.int64) & 0xFFFFFFFF)
        worst = max(worst, int(d.abs().max().item()) if d.numel() else 0)
    return worst


def _compare(torch, results, name, kernel, plain, nbytes, imad, reps=20, main=True, record=None, plain_reps=2):
    """Hold kernel() against plain() exactly; where `main`, time both and
    keep the row in results[record or name] with its bound."""
    got = kernel()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    want = plain()
    stop.record()
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = _max_abs_err(got, want)
    ok = err == 0 and all(torch.equal(g, w) for g, w in zip(got, want))
    if not ok:
        raise CheckFailed(f"kernel {name} disagrees with its plain version (max abs limb error {err})")
    if main:
        ms = cuda_ms(kernel, reps)
        # plain_reps=0: the checking run alone times the plain version (a slow one)
        plain_ms = cuda_ms(plain, plain_reps) if plain_reps else start.elapsed_time(stop)
        b_ms, b_by = bound(imad, nbytes)
        results[record or name] = {
            "ok": True, "max_abs_err": err, "kernel_ms": ms, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by,
        }


def phase_kernels(torch, K, F, C, device):
    """Each kernel at a main-path shape (timed) and at the extra shapes of the
    port's test list, against its plain version on the same card inputs."""
    import numpy as np

    from rust_eth_kzg_tpu_torch.constants import FR_MULTIPLICATIVE_GENERATOR
    from rust_eth_kzg_tpu_torch.ops import limbs as LB
    from rust_eth_kzg_tpu_torch.ops import ntt
    from rust_eth_kzg_tpu_torch.utils.edge_inputs import decompress_inputs, edge_operands

    t0 = time.perf_counter()
    FR, FP = F.FR, F.FP
    results = {}

    def compare(*args, **kwargs):
        _compare(torch, results, *args, **kwargs)

    # mont_mul: Fr [8, 1, 128, 64] (the 1/(2k) fold of one blob) timed; Fr and
    # Fp on 2^16 lanes with the a < 2p and p - 1 extremes
    _, a = _random_field(FR, 8192, SEED, device)
    _, b = _random_field(FR, 8192, SEED + 1, device)
    a, b = a.reshape(8, 1, 128, 64), b.reshape(8, 1, 128, 64)
    compare("mont_mul", lambda: K.mont_mul(FR, a, b), lambda: F.mont_mul_plain(FR, a, b),
            3 * 32 * 8192, 8192 * mont_mul_imad(8))
    for spec in (FR, FP):
        ai, a = _random_field(spec, 1 << 16, SEED + 2, device)
        _, b = _random_field(spec, 1 << 16, SEED + 3, device)
        # a takes values below 2p, b below p
        edge = [spec.modulus - 1, 2 * spec.modulus - 1, spec.modulus, 0]
        a[:, :4] = torch.from_numpy(LB.ints_to_limbs(edge, spec.nlimbs)).to(device)
        b[:, :4] = torch.from_numpy(LB.ints_to_limbs([spec.modulus - 1] * 4, spec.nlimbs)).to(device)
        compare(f"mont_mul_{spec.name}", lambda: K.mont_mul(spec, a, b),
                lambda: F.mont_mul_plain(spec, a, b), 0, 0, main=False)
        # the edge operands of the card test, against Python integers
        ea, eb = edge_operands(spec, n_random=4096)
        ta = torch.from_numpy(LB.ints_to_limbs(ea, spec.nlimbs)).to(device)
        tb = torch.from_numpy(LB.ints_to_limbs(eb, spec.nlimbs)).to(device)
        got = LB.limbs_to_ints(K.mont_mul(spec, ta, tb).cpu().numpy())
        r_inv = pow(spec.r, -1, spec.modulus)
        check(got == [x * y * r_inv % spec.modulus for x, y in zip(ea, eb)],
              f"mont_mul {spec.name} on the edge operands equals Python integers")
        compare(f"mont_mul_edge_{spec.name}", lambda: K.mont_mul(spec, ta, tb),
                lambda: F.mont_mul_plain(spec, ta, tb), 0, 0, main=False)
        probe = chain_probe(torch, spec, lambda x, k: K.mont_mul_chain(spec, x, k), device)
        results["mont_mul"].update({f"{spec.name}_{k}": v for k, v in probe.items()})

    # field_butterfly: one stage of the 8192-point cells NTT, [8, 1, 8192]
    dom = ntt.Domain(8192, device)
    _, x = _random_field(FR, 8192, SEED + 4, device)
    x = x.reshape(8, 1, 8192)
    tw = dom._tw["fwd"]
    compare("field_butterfly", lambda: K.field_butterfly(FR, x, tw, 12),
            lambda: F.butterfly_plain(FR, x, tw, 12), 32 * (8192 + 4096 + 8192),
            4096 * mont_mul_imad(8))
    for stage in (0, 5):
        compare("field_butterfly", lambda: K.field_butterfly(FR, x, tw, stage),
                lambda: F.butterfly_plain(FR, x, tw, stage), 0, 0, main=False)

    # ntt: every transform the three paths run, at their shapes: the cells
    # NTT of prove B=8, [8, 8, 8192] fwd (timed: the main row); the
    # blob_to_poly ifft [8, 8, 4096], the circulant fft [8, 8 x 64, 128],
    # recover's coset transforms [8, 8, 8192], the verifier's 64-point
    # inverse [8, 1024, 64] and the B=1 forms (timed as shapes); each
    # against Domain._dit_plain with the same scales
    g = FR_MULTIPLICATIVE_GENERATOR
    ntt_shapes = {}
    for n, rows, kind, main in ((8192, 8, "fft", True), (4096, 8, "ifft", False), (128, 512, "fft", False),
                                (8192, 8, "coset_fft", False), (8192, 8, "coset_ifft", False),
                                (64, 1024, "ifft", False), (4096, 1, "ifft", False), (128, 64, "fft", False),
                                (8192, 1, "fft", False), (64, 128, "ifft", False)):
        dom = ntt.Domain(n, device)
        _, x = _random_field(FR, rows * n, SEED + 20 + n + rows, device)
        x = x.reshape(8, rows, n)
        tag, pre, post = {"fft": ("fwd", None, None), "ifft": ("inv", None, dom._scale("ifft")),
                          "coset_fft": ("fwd", dom._scale(("coset", g)), None),
                          "coset_ifft": ("inv", None, dom._scale(("coset_inv", g)))}[kind]
        scales = (pre is not None) + (post is not None)
        nbytes = 32 * (2 * rows * n + n + scales * n)
        imad = rows * (n // 2 * dom.log_size + scales * n) * mont_mul_imad(8)
        record = None if main else f"ntt_{kind}_{n}x{rows}"
        compare("ntt", lambda: K.ntt(x, dom._roots[tag], pre, post), lambda: dom._dit_plain(x, tag, pre, post),
                nbytes, imad, reps=20, record=record, plain_reps=0)
        if not main:
            ntt_shapes[record[4:]] = {k: results[record][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")}
            del results[record]
    results["ntt"]["shapes"] = ntt_shapes

    # g1_add: the first complete level of the window-sum tree of one blob,
    # [12, 9, 1, 128, 64]; and 4096 lanes with identity / equal / opposite lanes
    n = 9 * 128 * 64
    p, _ = _random_points(C, F, n, SEED + 5, device)
    q, _ = _random_points(C, F, n, SEED + 6, device)
    shape = (12, 9, 1, 128, 64)
    p = C.G1(*(c.reshape(shape) for c in p))
    q = C.G1(*(c.reshape(shape) for c in q))
    compare("g1_add", lambda: K.g1_add(p, q), lambda: tuple(C.add_plain(p, q)),
            9 * 48 * n, n * 14 * mont_mul_imad(12))
    p, _ = _random_points(C, F, 4096, SEED + 7, device)
    q, _ = _random_points(C, F, 4096, SEED + 8, device)
    q = C.G1(*(c.clone() for c in q))
    ident = C.identity((4096,), device)
    for c, pc, ic in zip(q, p, ident):
        c[:, 0:64] = pc[:, 0:64]  # equal lanes: the complete adder doubles
        c[:, 128:192] = ic[:, 128:192]  # identity lanes
    negp = C.neg(p)
    q.y[:, 64:128] = negp.y[:, 64:128]
    q.x[:, 64:128] = p.x[:, 64:128]
    q.z[:, 64:128] = p.z[:, 64:128]  # opposite lanes
    compare("g1_add", lambda: K.g1_add(p, q), lambda: tuple(C.add_plain(p, q)), 0, 0, main=False)
    pi = C.select(torch.arange(4096, device=device) % 7 == 0, ident, p)
    compare("g1_add", lambda: K.g1_add(pi, q), lambda: tuple(C.add_plain(pi, q)), 0, 0, main=False)

    # g1_double: the Horner accumulator of one blob, [12, 1, 128]; and 4096
    # lanes with identity lanes
    p128, _ = _random_points(C, F, 128, SEED + 9, device)
    p128 = C.G1(*(c.reshape(12, 1, 128) for c in p128))
    compare("g1_double", lambda: K.g1_double(p128), lambda: tuple(C.double_plain(p128)),
            6 * 48 * 128, 128 * 9 * mont_mul_imad(12))
    compare("g1_double", lambda: K.g1_double(pi), lambda: tuple(C.double_plain(pi)), 0, 0, main=False)

    # g1_add_mixed: the subgroup-check ladder of a 128-cell verify, 256 lanes
    # (commitments and proofs, padded), timed; and 73,728 lanes (timed as
    # "wide"). Both with identity q lanes, identity p lanes and p == q lanes.
    for n, record in ((256, None), (73728, "g1_add_mixed_wide")):
        p, _ = _random_points(C, F, n, SEED + 14, device)
        q = C.batch_normalize(_random_points(C, F, n, SEED + 15, device)[0])
        lane = torch.arange(n, device=device)
        p = C.select(lane % 17 == 1, C.identity((n,), device), p)
        pa = C.batch_normalize(p)
        same = (lane % 16 == 5) & ~pa.inf
        qinf = lane % 16 == 9
        q = C.G1Affine(F.select(same, pa.x, q.x), F.select(same, pa.y, q.y), qinf)
        live = int((~qinf).sum().item())
        compare("g1_add_mixed", lambda: K.g1_add_mixed(p, q.x, q.y, q.inf),
                lambda: tuple(C.add_mixed_plain(p, q)), (5 * 48 + 1) * n + 3 * 48 * n,
                live * 13 * mont_mul_imad(12), record=record)
        check(bool((~C.is_identity(p)).sum() < n) and bool(same.any()) and bool(qinf.any()),
              "g1_add_mixed inputs hold identity p, p == q and identity q lanes")

    # g1_add_affine: the chord level of the window sums of one blob,
    # [12, 9, 1, 128, 128], identity lanes where a digit is 0
    n = 9 * 128 * 128
    pa, _ = _random_points(C, F, n, SEED + 10, device)
    pb, _ = _random_points(C, F, n, SEED + 11, device)
    aa, ab = C.batch_normalize(pa), C.batch_normalize(pb)
    g = torch.Generator(device="cpu").manual_seed(SEED)
    ainf = (torch.rand(n, generator=g) < 1 / 128).to(device)
    binf = (torch.rand(n, generator=g) < 1 / 128).to(device)
    shape = (12, 9, 1, 128, 128)
    A = C.G1Affine(aa.x.reshape(shape), aa.y.reshape(shape), ainf.reshape(shape[1:]))
    Bq = C.G1Affine(ab.x.reshape(shape), ab.y.reshape(shape), binf.reshape(shape[1:]))
    live = int((~(ainf | binf)).sum().item())
    compare("g1_add_affine", lambda: K.g1_add_affine(A.x, A.y, A.inf, Bq.x, Bq.y, Bq.inf),
            lambda: tuple(C.add_affine_plain(A, Bq)), (4 * 48 + 2) * n + 3 * 48 * n,
            live * 8 * mont_mul_imad(12))

    # g1_fft: the proof transform of one blob, [12, 1, 128] fwd, the identity
    # in its second half (timed); wide: the init's [12, 64, 128] circulant
    # transform (timed); inv at [12, 1, 128] and [12, 8, 128], checked. Row 0
    # of each is the identity in its second half, row 1 all identity.
    dom128 = ntt.Domain(128, device)
    for rows, record, tag in ((1, None, "fwd"), (64, "g1_fft_wide", "fwd"), (1, False, "inv"),
                              (8, False, "inv")):
        p, _ = _random_points(C, F, rows * 128, SEED + 16 + rows, device)
        p = C.G1(*(c.reshape(12, rows, 128).contiguous() for c in p))
        ident = C.identity((128,), device)
        for c, ic in zip(p, ident):
            c[:, 0, 64:] = ic[:, 64:]
            if rows > 1:
                c[:, 1] = ic
        digits, neg1, neg2 = dom128._stage_digits(tag)
        compare("g1_fft", lambda: K.g1_fft(p, digits, neg1, neg2),
                lambda: tuple(dom128._dit_g1_plain(p, tag)),
                2 * 3 * 48 * rows * 128 + digits.numel() + 2 * neg1.numel(),
                rows * g1_fft_products(128) * mont_mul_imad(12), reps=5,
                main=record is not False, record=record or None, plain_reps=0)
    results["g1_fft"].update(g1_fft_latency_floor(torch, K, C, F, device))
    latency_ms = results["mont_mul"]["fp_product_latency_us"] / 1e3
    results["g1_fft"]["critical_path_probe_ms"] = results["g1_fft"]["product_rounds"] * latency_ms

    # g1_decompress: a 1,024-cell verify's decompression (8 commitments and
    # 1,024 proofs in 2 x 1,024 lanes, the rest identity padding, as
    # FK20Verifier.prepare lays them out), timed; 129 and 1,032 lanes,
    # checked. Identity, both sort bits, x off the curve and curve points
    # outside the subgroup in every run (tests/test_torch_kernels_cuda.py).
    from rust_eth_kzg_tpu_torch.ops import decompress as D

    for n, main in ((2048, True), (129, False), (1032, False), (16, False)):
        (xs, sort, inf), kinds = decompress_inputs(1032 if main else n, SEED + 50 + n)
        if main:
            lanes = np.r_[0:8, 1024:2048]
            xs_p, sort_p, inf_p = np.zeros((12, n), np.int32), np.zeros(n, bool), np.ones(n, bool)
            xs_p[:, lanes], sort_p[lanes], inf_p[lanes] = xs, sort, inf
            xs, sort, inf = xs_p, sort_p, inf_p
        x, sb, inf_t = (torch.from_numpy(a).to(device) for a in (xs, sort, inf))
        check(bool(inf_t.any()) and bool(sb.any()) and bool((~sb & ~inf_t).any())
              and {"off_curve", "not_in_subgroup"} <= set(kinds), "g1_decompress inputs hold every kind of lane")

        def plain():
            pt, on, sub = D.decompress_g1_plain(x, sb, inf_t)
            return (*pt, on.to(torch.uint8), sub.to(torch.uint8))

        # the work the function needs: x and the two flag bytes in, the point
        # and two flag bytes out, a lane; products on live lanes only (an
        # identity lane's output is the fixed (0 : 1 : 0))
        live = int((~inf_t).sum().item())
        compare("g1_decompress", lambda: K.g1_decompress(x, sb, inf_t), plain, n * (48 + 2 + 3 * 48 + 2),
                live * DECOMPRESS_LIVE_PRODUCTS * mont_mul_imad(12), reps=10, main=main, plain_reps=0)
    # g1_add and g1_double at the EIP-4844 batch verifier's shape: its two
    # MSMs as one lincomb_host over [2, 2B + 1] = [2, 17] lanes (B = 8), an
    # identity point and zero scalars among them, against the plain route
    from rust_eth_kzg_tpu_torch.ops import msm as M

    pts, _ = _random_points(C, F, 34, SEED + 60, device)
    pts = C.select(torch.arange(34, device=device) % 11 == 4, C.identity((34,), device), pts)
    pts = C._map(lambda c: c.reshape(12, 2, 17).contiguous(), pts)
    sc = [_random_ints(FR.modulus, 17, SEED + 61), _random_ints(FR.modulus, 8, SEED + 62) + [0] * 9]
    compare("g1_add", lambda: tuple(M.lincomb_host(pts, sc)), lambda: tuple(M.lincomb_host(pts, sc, plain=True)),
            0, 0, main=False)
    results["g1_decompress"].update({
        "products_per_live_lane": DECOMPRESS_LIVE_PRODUCTS, "critical_path_products": DECOMPRESS_DEPTH,
        "critical_path_probe_ms": DECOMPRESS_DEPTH * latency_ms,
        "serial_path_probe_ms": DECOMPRESS_LIVE_PRODUCTS * latency_ms,
    })

    # batch_inverse: the proofs of one blob, Fp [12, 128] (timed; one GCD a
    # lane; the bound is the function's least work, one GCD a block); the
    # GCD's edge values and zero lanes in several blocks at the card test's
    # sizes, both modes; the table build's slice; the two modes timed over a
    # sweep of sizes (the threshold), and one lane alone (the GCD's latency)
    from rust_eth_kzg_tpu_torch.utils.edge_inputs import inverse_edge_values

    _, z = _random_field(FP, 128, SEED + 12, device)
    compare("batch_inverse", lambda: K.batch_inverse(FP, z), lambda: F.batch_inverse_plain(FP, z),
            2 * 48 * 128, batch_inverse_imad(K, FP, 128))
    for spec in (FR, FP):
        for nn in (1, 128, 333, 1024, 32 * 640 + 5, 65536):
            ints, z = _random_field(spec, nn, SEED + 13 + nn, device)
            edges = inverse_edge_values(spec)[:nn]
            z[:, : len(edges)] = torch.from_numpy(spec.to_mont_host(edges)).to(device)
            ints[: len(edges)] = edges
            zeros = [i for i in (nn // 2, nn - 1) if i >= len(edges)]
            z[:, zeros] = 0
            want = F.batch_inverse_plain(spec, z)
            c = -(-nn // 32)
            dead = {i for i in range(nn) if any(i % c == j % c for j in zeros)}
            for per_lane in (True, False):
                compare("batch_inverse", lambda: K.batch_inverse(spec, z, per_lane=per_lane), lambda: want, 0, 0,
                        main=False)
            inv = spec.from_mont_host(want.cpu().numpy())
            check(all(inv[i] == (0 if i in dead else pow(ints[i], -1, spec.modulus)) for i in range(min(nn, 200))),
                  "batch_inverse equals Python inverses, zero blocks zero")
    # the table build's slice (ops/msm.py _build_tables: about 2^20 Fp lanes
    # a batch_normalize), the one run-time shape above the threshold: block
    # mode, zero lanes in three blocks; random limbs made on the card, the
    # top limb below p's, so every value is below p
    nn = 1 << 20
    check(nn > K.BATCH_INVERSE_PER_LANE_MAX, "the table build's slice runs one GCD a block")
    g = torch.Generator(device=device).manual_seed(SEED + 16)
    z = torch.randint(-(2**31), 2**31, (FP.nlimbs, nn), generator=g, device=device, dtype=torch.int32)
    z[-1] = torch.remainder(z[-1], FP.modulus >> (32 * (FP.nlimbs - 1)))
    zeros = [5, nn // 2 + 7, nn - 1]
    z[:, zeros] = 0
    compare("batch_inverse", lambda: K.batch_inverse(FP, z), lambda: F.batch_inverse_plain(FP, z), 0, 0, main=False)
    c = nn // 32
    head = FP.from_mont_host(z[:, :64].cpu().numpy())
    inv = FP.from_mont_host(K.batch_inverse(FP, z)[:, :64].cpu().numpy())
    check(all(inv[i] == (0 if any(i % c == j % c for j in zeros) else pow(head[i], -1, FP.modulus))
              for i in range(64)), "batch_inverse at the table build's slice equals Python inverses")
    sweep = {}
    derived = {}
    for spec in (FP, FR):
        for nn in (128, 1024, 4096, 16384, 65536, 262144):
            _, z = _random_field(spec, nn, SEED + 14, device)
            row = {}
            for per_lane in (True, False):
                row["lane_ms" if per_lane else "block_ms"] = cuda_ms(lambda: K.batch_inverse(spec, z, per_lane=per_lane), 5)
            check(torch.equal(K.batch_inverse(spec, z, per_lane=True), K.batch_inverse(spec, z, per_lane=False)),
                  "batch_inverse: the two modes agree")
            sweep[f"{spec.name}_{nn}"] = row
        one = _random_field(spec, 1, SEED + 15, device)[1]
        lane_ms = _one_lane_ms(torch, lambda: K.batch_inverse(spec, one, per_lane=True), 50)
        sweep[f"{spec.name}_gcd_one_lane_ms"] = lane_ms
        # derived, not read: the one-lane time (launch, the 32-lane zero scan
        # and the closing product included) over the GCD's static step count
        steps = K.GCD_OUTER[spec.name] * K.GCD_STEPS
        derived[f"{spec.name}_gcd_steps"] = steps
        derived[f"{spec.name}_gcd_step_latency_us_upper"] = lane_ms * 1e3 / steps
    results["batch_inverse"].update({"sweep": sweep, "critical_path_ms": sweep["fp_gcd_one_lane_ms"]})
    emit({"phase": "kernels_batch_inverse_derived", "per_lane_max": K.BATCH_INVERSE_PER_LANE_MAX, **derived})

    emit({"phase": "kernels", "seconds": time.perf_counter() - t0, "checked": [
        {"name": k, "ok": v["ok"], "kernel_ms": v["kernel_ms"], "plain_ms": v["plain_ms"]}
        for k, v in results.items()
    ]})
    return results


def _random_blob(seed, n=4096):
    from rust_eth_kzg_tpu_torch.constants import R_SCALAR

    return b"".join(v.to_bytes(32, "big") for v in _random_ints(R_SCALAR, n, seed))


def _setup_cache():
    """The port's trusted_setup module, the embedded setup's JSON text and
    the path of its decompressed-point cache."""
    from rust_eth_kzg_tpu_torch.utils import trusted_setup as TS

    with open(TS.SETUP_JSON_PATH) as fh:
        text = fh.read()
    return TS, text, TS.cache_path(text)


def phase_mainnet_setup(torch, api, K, device):
    """Init, then one call of the prove path whose launch counts are returned."""
    from rust_eth_kzg_tpu_torch.utils import bls_host as B

    _, _, setup_cache = _setup_cache()
    setup_cache_present = os.path.exists(setup_cache)
    t0 = time.perf_counter()
    ctx = api.DASContext(device=device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    table_bytes = ctx.prover.tables.nbytes + ctx.prover.commit_tables.nbytes
    blobs = [bytes(131072)] + [_random_blob(SEED + i) for i in range(1, 8)]
    t1 = time.perf_counter()
    K.reset_launches()
    out = ctx.compute_cells_and_kzg_proofs_batch(blobs)
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    prove_s = time.perf_counter() - t1
    cells0, proofs0 = out[0]
    check(len(cells0) == 128 and len(proofs0) == 128, "128 cells and proofs")
    check(all(c == bytes(2048) for c in cells0), "zero blob: every cell is zero")
    check(all(p == B.g1_compress(None) for p in proofs0), "zero blob: every proof is the identity")
    for blob, (cells, proofs) in zip(blobs, out):
        check(b"".join(cells[:64]) == blob, "systematic cells: the first 64 cells are the blob")
        check(len(set(proofs)) == 128 or blob == blobs[0], "distinct proofs for a random blob")
    again = ctx.compute_cells_and_kzg_proofs_batch(blobs[:4])
    check(again == out[:4], "a repeated call gives identical bytes")
    commitment = ctx.blob_to_kzg_commitment(blobs[0])
    check(commitment == B.g1_compress(None), "zero blob commits to the identity")
    emit({
        "phase": "mainnet_setup", "init_s": init_s, "setup_cache_present": setup_cache_present, "prove_b8_s": prove_s,
        "table_bytes": table_bytes,
        "fk20_table_bytes": ctx.prover.tables.nbytes,
        "commit_table_bytes": ctx.prover.commit_tables.nbytes,
        "cuda_memory_allocated": torch.cuda.memory_allocated(),
        "seconds": time.perf_counter() - t0,
    })
    return ctx, launches, blobs, out, init_s


def expect_raises(cls, what, fn, *args):
    try:
        fn(*args)
    except cls as exc:
        return str(exc)
    raise CheckFailed(f"{what}: expected {cls.__name__}")


def _kept(rng, n_keep, n=128):
    return sorted(int(i) for i in rng.choice(n, size=n_keep, replace=False))


def _bump_first_scalar(cell):
    """The cell with its first scalar replaced by the next canonical value."""
    from rust_eth_kzg_tpu_torch.constants import R_SCALAR

    v = (int.from_bytes(cell[:32], "big") + 1) % R_SCALAR
    return v.to_bytes(32, "big") + cell[32:]


def phase_recover(torch, K, ctx, out):
    """Recovery from 64 of 128 cells: B=1 and the gated B=8 call."""
    import numpy as np

    from rust_eth_kzg_tpu_torch.errors import RecoveryError

    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED + 200)
    cells1, proofs1 = out[1]
    idx = _kept(rng, 64)
    got = ctx.recover_cells_and_kzg_proofs(idx, [cells1[i] for i in idx])
    check(got == (cells1, proofs1), "recover B=1: cells and proofs equal the prover's bytes")
    batches = []
    for cells, _ in out:
        idx = _kept(rng, 64)
        batches.append((idx, [cells[i] for i in idx]))
    check(len({tuple(i) for i, _ in batches}) == len(out), "a different erasure pattern for each blob")
    K.reset_launches()
    got = ctx.recover_cells_and_kzg_proofs_batch(batches)
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    check(got == out, "recover B=8: cells and proofs equal the prover's bytes")
    idx = _kept(rng, 63)
    too_few = expect_raises(RecoveryError, "63 cells", ctx.recover_cells_and_kzg_proofs,
                            idx, [cells1[i] for i in idx])
    idx = _kept(rng, 80)
    bad = [cells1[i] for i in idx]
    bad[7] = _bump_first_scalar(bad[7])
    corrupt = expect_raises(RecoveryError, "a corrupted cell", ctx.recover_cells_and_kzg_proofs, idx, bad)
    emit({"phase": "recover", "b1_ok": True, "b8_ok": True, "too_few_cells": too_few,
          "corrupted_cell": corrupt, "seconds": time.perf_counter() - t0})
    return launches


def verify_batch(out, comms, nblobs):
    """Every cell of the first `nblobs` blobs as one verify batch."""
    commitments = [comms[b] for b in range(nblobs) for _ in range(128)]
    indices = list(range(128)) * nblobs
    cells = [c for b in range(nblobs) for c in out[b][0]]
    proofs = [p for b in range(nblobs) for p in out[b][1]]
    return commitments, indices, cells, proofs


def phase_verify(torch, K, ctx, blobs, out):
    """Accept the port's proofs (128 and 1,024 cells; the latter gated) and
    reject four tampered 128-cell batches."""
    from rust_eth_kzg_tpu_torch.errors import InvalidProofError, SerializationError
    from rust_eth_kzg_tpu_torch.utils.edge_inputs import not_in_subgroup_bytes, off_curve_bytes

    t0 = time.perf_counter()
    comms = [ctx.blob_to_kzg_commitment(b) for b in blobs]
    one = verify_batch(out[1:], comms[1:], 1)
    ctx.verify_cell_kzg_proof_batch(*one)
    eight = verify_batch(out, comms, 8)
    K.reset_launches()
    ctx.verify_cell_kzg_proof_batch(*eight)
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    c, i, cells, proofs = one
    swapped = list(proofs)
    swapped[5], swapped[6] = swapped[6], swapped[5]
    errors = {"swapped_proof": expect_raises(InvalidProofError, "swapped proofs",
                                             ctx.verify_cell_kzg_proof_batch, c, i, cells, swapped)}
    changed = list(cells)
    changed[9] = _bump_first_scalar(changed[9])
    errors["changed_cell"] = expect_raises(InvalidProofError, "a changed cell",
                                           ctx.verify_cell_kzg_proof_batch, c, i, changed, proofs)
    for name, bad_point, pos in (("proof_not_in_subgroup", not_in_subgroup_bytes(random.Random(SEED)), 3),
                                 ("proof_off_curve", off_curve_bytes(random.Random(SEED)), 4)):
        bad = list(proofs)
        bad[pos] = bad_point
        errors[name] = expect_raises(SerializationError, name, ctx.verify_cell_kzg_proof_batch, c, i, cells, bad)
    emit({"phase": "verify", "accepted": [128, 1024], "errors": errors,
          "seconds": time.perf_counter() - t0})
    return launches, comms


def _scalar_bytes(v):
    return v.to_bytes(32, "big")


def _launches_of(torch, K, fn):
    """The kernel launches of one call of fn (counts set to 0 just before,
    read just after)."""
    K.reset_launches()
    fn()
    torch.cuda.synchronize()
    return dict(K.LAUNCHES)


def phase_eip4844(torch, K, ctx, blobs, out, comms):
    """The five EIP-4844 calls on the mainnet context and phase 3's 8 blobs:
    the commitments phase 5 verified; compute_kzg_proof at the evaluation
    point of one element of cell 0 and of a seeded cell returns that
    element of phase 3's cells (the Ruffini remainder held against the FK20
    path); at a seeded z and at each blob's challenge the three checks
    accept; the zero blob's commitment and proofs are the identity; seven
    bad inputs are rejected with the JAX package's error classes; the empty
    batch passes. Returns the blob proofs and the launches of the two gated
    paths (compute_blob_kzg_proof of one blob; verify_blob_kzg_proof_batch
    of the 8 blobs)."""
    import numpy as np

    from rust_eth_kzg_tpu_torch.constants import R_SCALAR
    from rust_eth_kzg_tpu_torch.errors import InvalidProofError, SerializationError, VerifierError
    from rust_eth_kzg_tpu_torch.ops import ntt
    from rust_eth_kzg_tpu_torch.utils import bls_host as B
    from rust_eth_kzg_tpu_torch.utils.edge_inputs import not_in_subgroup_bytes, off_curve_bytes

    t0 = time.perf_counter()
    eip = ctx.eip4844
    check([eip.blob_to_kzg_commitment(b) for b in blobs] == comms,
          "Context4844.blob_to_kzg_commitment gives the commitments phase 5 verified")
    # cell k, element j is f at w^rev(64 k + j), w the 8,192-point root
    ext = ntt.Domain(8192, "cpu")
    rev = ntt.bitrev_indices(8192)
    rng = np.random.default_rng(SEED + 400)
    elements = []
    for k in (0, int(rng.integers(1, 128))):
        j = int(rng.integers(0, 64))
        z = ext.roots[int(rev[64 * k + j])]
        _, y = ctx.compute_kzg_proof(blobs[1], _scalar_bytes(z))
        check(y == out[1][0][k][32 * j : 32 * j + 32], f"compute_kzg_proof at cell {k}'s element {j}: y is that element")
        elements.append([k, j])
    z = _random_ints(R_SCALAR, 1, SEED + 401)[0]
    proof, y = ctx.compute_kzg_proof(blobs[1], _scalar_bytes(z))
    ctx.verify_kzg_proof(comms[1], _scalar_bytes(z), y, proof)
    proofs = [ctx.compute_blob_kzg_proof(b, c) for b, c in zip(blobs, comms)]
    for b, c, p in zip(blobs, comms, proofs):
        ctx.verify_blob_kzg_proof(b, c, p)
    prove_launches = _launches_of(torch, K, lambda: ctx.compute_blob_kzg_proof(blobs[2], comms[2]))
    verify_launches = _launches_of(torch, K, lambda: ctx.verify_blob_kzg_proof_batch(blobs, comms, proofs))
    ident = B.g1_compress(None)
    check(comms[0] == ident and proofs[0] == ident, "zero blob: identity commitment and blob proof")
    check(ctx.compute_kzg_proof(blobs[0], _scalar_bytes(z)) == (ident, bytes(32)), "zero blob: identity proof, y = 0")
    ctx.verify_blob_kzg_proof_batch([], [], [])
    y1 = _scalar_bytes((int.from_bytes(y, "big") + 1) % R_SCALAR)
    swapped = list(proofs)
    swapped[3], swapped[4] = swapped[4], swapped[3]
    rnd = random.Random(SEED + 402)
    errors = {
        "y_plus_1": expect_raises(InvalidProofError, "y + 1", ctx.verify_kzg_proof, comms[1], _scalar_bytes(z), y1, proof),
        "another_blobs_proof": expect_raises(InvalidProofError, "another blob's proof", ctx.verify_blob_kzg_proof,
                                             blobs[1], comms[1], proofs[2]),
        "swapped_pair": expect_raises(InvalidProofError, "a swapped pair", ctx.verify_blob_kzg_proof_batch,
                                      blobs, comms, swapped),
        "non_canonical_z": expect_raises(SerializationError, "z = r", ctx.compute_kzg_proof, blobs[1],
                                         _scalar_bytes(R_SCALAR)),
        "off_curve_commitment": expect_raises(SerializationError, "an off-curve commitment", ctx.verify_blob_kzg_proof,
                                              blobs[1], off_curve_bytes(rnd), proofs[1]),
        "proof_not_in_subgroup": expect_raises(SerializationError, "a proof outside the subgroup",
                                               ctx.verify_blob_kzg_proof_batch, blobs[:2], comms[:2],
                                               [proofs[0], not_in_subgroup_bytes(rnd)]),
        "mismatched_lengths": expect_raises(VerifierError, "mismatched lengths", ctx.verify_blob_kzg_proof_batch,
                                            blobs, comms, proofs[:7]),
    }
    check(errors["off_curve_commitment"] == "x coordinate not on curve"
          and errors["proof_not_in_subgroup"] == "point 1: point not in the prime-order subgroup",
          f"decompression messages as the JAX package's native library gives them: {errors}")
    emit({"phase": "eip4844", "cell_elements_checked": elements, "blob_proofs_verified": len(proofs),
          "batch_verified": len(blobs), "errors": errors, "seconds": time.perf_counter() - t0})
    return proofs, prove_launches, verify_launches


# Each mesh world's hard limit: a rank still alive then is terminated and
# the phase fails; a collective waits at most its group's timeout.
MESH_WORLD_TIMEOUT_S = 150
MESH_COLLECTIVE_TIMEOUT_S = 120
MESH_NOTE = ("two gloo ranks share one card and exchange through host memory: a check of the sharded "
             "programs at mainnet shapes, no scaling figure")


def _digest(results):
    """sha256 of the cells and proofs of a prover call's result, in order."""
    import hashlib

    h = hashlib.sha256()
    for cells, proofs in results:
        for part in (*cells, *proofs):
            h.update(part)
    return h.hexdigest()


def _host_ms(torch, fn, reps=3):
    """Median host-clock ms of `reps` calls after a warm-up, each closed by a
    synchronize, and the runs."""
    fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t) * 1e3)
    return statistics.median(runs), runs


def _mesh_rank(backend, rank, world, tmp, program, args):
    """A spawned rank: its process group over a FileStore in `tmp`, then
    program(*args) on cuda:0; the result is pickled to tmp/rank<r>.pkl."""
    import datetime
    import pickle

    import torch
    import torch.distributed as dist

    if backend == "nccl":
        os.environ["NCCL_SOCKET_IFNAME"] = "lo"
    torch.cuda.set_device(0)
    dist.init_process_group(backend, store=dist.FileStore(os.path.join(tmp, "store"), world), rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=MESH_COLLECTIVE_TIMEOUT_S))
    try:
        result = program(*args)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as fh:
        pickle.dump(result, fh)


def _run_world(backend, world, program, *args):
    """`world` ranks of program(*args) (spawn start method), each with the
    world's hard limit; their results in rank order. A rank that fails or
    outlives the limit fails the phase."""
    import multiprocessing as mp
    import pickle
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=_mesh_rank, args=(backend, r, world, tmp, program, args)) for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + MESH_WORLD_TIMEOUT_S
        try:
            for p in procs:
                p.join(max(0.0, deadline - time.monotonic()))
        finally:
            hung = [p for p in procs if p.is_alive()]
            for p in hung:
                p.terminate()
            for p in hung:
                p.join(10)
                if p.is_alive():
                    p.kill()
                    p.join()
        check(not hung, f"mesh {backend} world {world}: {len(hung)} ranks still running after {MESH_WORLD_TIMEOUT_S} s")
        codes = [p.exitcode for p in procs]
        check(not any(codes), f"mesh {backend} world {world}: ranks exited with {codes}")
        results = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as fh:
                results.append(pickle.load(fh))
        return results


def _mesh_gloo_program(blobs, batches):
    """World 2, gloo, both ranks on cuda:0: DASContext on a (1, 2) mesh
    (work = 2) proves the blobs (launches counted) and recovers the batches;
    one on a (2, 1) mesh (dp = 2) proves them; each prove timed (median of
    3); fft_sharded at [8, 8, 8192] against Domain.fft and lincomb_sharded
    over 1,024 setup points against msm.lincomb; an all_gather of the
    slot results' shape timed. Returns digests, flags, counts and times."""
    import torch

    from rust_eth_kzg_tpu_torch import api
    from rust_eth_kzg_tpu_torch.ops import curve as C
    from rust_eth_kzg_tpu_torch.ops import field as F
    from rust_eth_kzg_tpu_torch.ops import kernels as K
    from rust_eth_kzg_tpu_torch.ops import msm as M
    from rust_eth_kzg_tpu_torch.ops import ntt
    from rust_eth_kzg_tpu_torch.parallel import mesh as PM
    from rust_eth_kzg_tpu_torch.utils.trusted_setup import TrustedSetup

    out = {}
    _, _, setup_cache = _setup_cache()
    out["setup_cache_present"] = os.path.exists(setup_cache)
    t = time.perf_counter()
    setup = TrustedSetup.default()
    out["setup_s"] = time.perf_counter() - t
    work_mesh = PM.make_mesh(2, dp=1)
    t = time.perf_counter()
    ctx = api.DASContext(device=torch.device("cuda", 0), trusted_setup=setup, mesh=work_mesh)
    device = ctx.device
    torch.cuda.synchronize()
    out["init_s"] = time.perf_counter() - t
    out["fk20_table_bytes"] = ctx.prover.tables.nbytes
    out["slots"] = [ctx.prover.slots.start, ctx.prover.slots.stop]
    K.reset_launches()
    PM.reset_collectives()
    proved = ctx.compute_cells_and_kzg_proofs_batch(blobs)
    torch.cuda.synchronize()
    out["launches"] = dict(K.LAUNCHES)
    out["collectives"] = dict(PM.COLLECTIVES)
    out["prove_work2"] = _digest(proved)
    out["recover_work2"] = _digest(ctx.recover_cells_and_kzg_proofs_batch(batches))
    out["prove_work2_ms"], out["prove_work2_runs_ms"] = _host_ms(torch, lambda: ctx.compute_cells_and_kzg_proofs_batch(blobs))
    # the slot results of a prove B=8 over work: G1 [8, 64] a rank, stacked
    part = torch.zeros((3, 12, len(blobs), ctx.prover.slots.stop - ctx.prover.slots.start), dtype=torch.int32,
                       device=device)
    out["slot_gather_ms"], _ = _host_ms(torch, lambda: PM.all_gather(work_mesh, "work", part, 3), reps=20)
    data = ctx._data(blobs)  # [8, 8, 4096]
    x = torch.cat((data, data.flip(-1)), dim=-1).contiguous()  # [8, 8, 8192]
    del ctx
    dp_ctx = api.DASContext(device=device, trusted_setup=setup, mesh=PM.make_mesh(2, dp=2))
    K.reset_launches()
    out["prove_dp2"] = _digest(dp_ctx.compute_cells_and_kzg_proofs_batch(blobs))
    torch.cuda.synchronize()
    out["launches_dp2"] = dict(K.LAUNCHES)
    out["prove_dp2_ms"], out["prove_dp2_runs_ms"] = _host_ms(torch, lambda: dp_ctx.compute_cells_and_kzg_proofs_batch(blobs))
    del dp_ctx
    dom = ntt.Domain(x.shape[-1], device)
    out["fft_equal"] = bool(torch.equal(PM.fft_sharded(dom, x, work_mesh), dom.fft(x)))
    pts = C.points_to_device(setup.g1_monomial[:1024], device)
    _, s = _random_field(F.FR, pts.x.shape[-1], SEED + 601, device)
    got, want = PM.lincomb_sharded(pts, s, work_mesh), M.lincomb(pts, s)
    out["lincomb_equal"] = bool(C.equal(got, want).item()) and not bool(C.is_identity(want).item())
    return out


def _mesh_nccl_program(blobs):
    """World 1, NCCL: DASContext on a (1, 1) mesh proves the blobs; its
    collectives take the CUDA tensors as they are (no host copy)."""
    import torch

    from rust_eth_kzg_tpu_torch import api
    from rust_eth_kzg_tpu_torch.parallel import mesh as PM

    mesh = PM.make_mesh(1, dp=1)
    ctx = api.DASContext(device=torch.device("cuda", 0), mesh=mesh)
    PM.reset_collectives()
    proved = ctx.compute_cells_and_kzg_proofs_batch(blobs)
    torch.cuda.synchronize()
    return {"device_type": mesh.device_type, "prove": _digest(proved), "collectives": dict(PM.COLLECTIVES)}


def phase_mesh(torch, K, ctx, blobs, out):
    """parallel/mesh.py on the card, against phases 3 and 4: a world of 2
    gloo ranks sharing cuda:0 (work = 2: prove and recover B=8; dp = 2:
    prove B=8; fft_sharded; lincomb_sharded; launch counts), then a world of
    1 NCCL rank (prove B=8). The port's setup cache is removed first, so
    both gloo ranks miss it and race to write it: one whole cache file must
    remain, equal to a parse. Returns rank 0's launches of the
    work-sharded prove, and its timings."""
    import numpy as np

    t0 = time.perf_counter()
    TS, text, setup_cache = _setup_cache()
    if os.path.exists(setup_cache):
        os.remove(setup_cache)
    want = _digest(out)
    rng = np.random.default_rng(SEED + 500)
    batches = []
    for cells, _ in out:
        idx = _kept(rng, 64)
        batches.append((idx, [cells[i] for i in idx]))
    gloo = _run_world("gloo", 2, _mesh_gloo_program, blobs, batches)
    base = os.path.basename(setup_cache)
    left = sorted(n for n in os.listdir(TS.CACHE_DIR) if n.startswith(base))
    check(left == [base], f"mesh: two ranks that started with no setup cache leave one cache file: {left}")
    check(not any(res["setup_cache_present"] for res in gloo), "mesh: both ranks started with no setup cache")
    check(TS.load_cache(setup_cache) == TS.TrustedSetup.from_json_unchecked(text),
          "mesh: the setup cache the ranks wrote equals a parse")
    fk20_bytes = ctx.prover.tables.nbytes
    msm_call = K.LAUNCHES_PER_CALL["fixed_base_msm"]
    for r, res in enumerate(gloo):
        n = res["launches"]
        check(res["prove_work2"] == want, f"mesh rank {r}: work = 2 prove B=8 is phase 3's bytes")
        check(res["recover_work2"] == want, f"mesh rank {r}: work = 2 recover B=8 is phase 4's bytes")
        check(res["prove_dp2"] == want, f"mesh rank {r}: dp = 2 prove B=8 is phase 3's bytes")
        check(res["fft_equal"], f"mesh rank {r}: fft_sharded [8, 8, 8192] equals Domain.fft")
        check(res["lincomb_equal"], f"mesh rank {r}: lincomb_sharded of 1,024 points equals msm.lincomb")
        check(res["slots"] == [64 * r, 64 * (r + 1)] and 2 * res["fk20_table_bytes"] == fk20_bytes,
              f"mesh rank {r}: slots {res['slots']} and half of the FK20 tables ({res['fk20_table_bytes']} B)")
        check(n["g1_fft"] == 2 and n["fixed_base_msm"] == msm_call
              and n["g1_add"] + n["g1_double"] + n["g1_add_affine"] == 0,
              f"mesh rank {r}: 2 g1_fft launches, one fixed_base_msm call and no g1_add, g1_double or "
              f"g1_add_affine launch a work-sharded prove: {n}")
        check(res["collectives"]["all_gather"] > 0 and res["collectives"]["host_copies"] > 0,
              f"mesh rank {r}: the gloo collectives ran through host copies: {res['collectives']}")
    nccl = _run_world("nccl", 1, _mesh_nccl_program, blobs)[0]
    check(nccl["prove"] == want, "mesh NCCL world 1: prove B=8 is phase 3's bytes")
    check(nccl["device_type"] == "cuda" and nccl["collectives"]["all_gather"] > 0
          and nccl["collectives"]["host_copies"] == 0,
          f"mesh NCCL world 1: the collectives took CUDA tensors with no host copy: {nccl}")
    timing = {k: [res[k] for res in gloo] for k in ("setup_s", "init_s", "prove_work2_ms", "prove_work2_runs_ms", "prove_dp2_ms",
                                                      "prove_dp2_runs_ms", "slot_gather_ms", "launches_dp2")}
    emit({"phase": "mesh", "gloo_world": 2, "nccl_world": 1, "checked": [
        "prove_work2", "recover_work2", "prove_dp2", "fft_sharded_8x8x8192", "lincomb_sharded_1024", "nccl_prove",
        "setup_cache_race"],
        "launches_rank0": gloo[0]["launches"], "collectives_rank0": gloo[0]["collectives"],
        "nccl_collectives": nccl["collectives"], "by_rank": timing, "note": MESH_NOTE,
        "seconds": time.perf_counter() - t0})
    return gloo[0]["launches"], timing


def phase_g2(torch, K, device):
    """curve_g2 on the card: g2_lincomb over the setup's 65 G2 points with
    seeded scalars against a host oracle (bls_host g2_mul and g2_add), its
    launches (mont_mul only); add and double of 8 lanes, identities among
    them, against their CPU route. Returns the launches and the inputs."""
    from rust_eth_kzg_tpu_torch.constants import R_SCALAR
    from rust_eth_kzg_tpu_torch.ops import curve_g2 as G2
    from rust_eth_kzg_tpu_torch.ops import field as F
    from rust_eth_kzg_tpu_torch.utils import bls_host as B
    from rust_eth_kzg_tpu_torch.utils.trusted_setup import TrustedSetup

    t0 = time.perf_counter()
    pts = list(TrustedSetup.default().g2_monomial)
    check(len(pts) == 65, f"the mainnet setup has 65 G2 points, not {len(pts)}")
    scal = _random_ints(R_SCALAR, 65, SEED + 800)
    sm = torch.from_numpy(F.FR.to_mont_host(scal)).to(device)
    on_card = G2.points_to_device(pts, device)
    K.reset_launches()
    got = G2.g2_lincomb(on_card, sm)
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    check(launches["mont_mul"] > 0 and all(v == 0 for k, v in launches.items() if k != "mont_mul"),
          f"g2_lincomb launches mont_mul and no other kernel: {launches}")
    t1 = time.perf_counter()
    want = None
    for p, k in zip(pts, scal):
        want = B.g2_add(want, B.g2_mul(p, k))
    oracle_s = time.perf_counter() - t1
    check(G2.points_from_device(got) == [want], "g2_lincomb of 65 points equals the host oracle")
    lanes = pts[:6] + [None, pts[7]]
    others = pts[8:14] + [pts[20], None]
    for name, card, cpu in (
        ("add", lambda: G2.add(G2.points_to_device(lanes, device), G2.points_to_device(others, device)),
         lambda: G2.add(G2.points_to_device(lanes, "cpu"), G2.points_to_device(others, "cpu"))),
        ("double", lambda: G2.double(G2.points_to_device(lanes, device)),
         lambda: G2.double(G2.points_to_device(lanes, "cpu"))),
    ):
        check(G2.points_from_device(card()) == G2.points_from_device(cpu()), f"G2 {name} on the card equals its CPU route")
    emit({"phase": "g2", "points": 65, "launches": launches, "host_oracle_s": oracle_s,
          "checked": ["g2_lincomb_65", "add_8", "double_8"], "seconds": time.perf_counter() - t0})
    return launches, (on_card, sm)


def phase_table_free(torch, api, K, ctx, blobs, out):
    """DASContext(use_precomp=None) at mainnet geometry: no fixed-base table
    (the prover's MSMs run msm.lincomb, Pippenger on g1_add / g1_double);
    a prove B=1, a commitment and a recover B=1 (from the even cells)
    byte-equal to the table route's."""
    t0 = time.perf_counter()
    free = api.DASContext(device=ctx.device, use_precomp=None)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    check(free.prover.tables is None and free.prover.commit_tables is None, "use_precomp=None builds no table")
    blob = blobs[1]
    t1 = time.perf_counter()
    K.reset_launches()
    proved = free.compute_cells_and_kzg_proofs(blob)
    torch.cuda.synchronize()
    prove_s = time.perf_counter() - t1
    launches = {k: v for k, v in K.LAUNCHES.items() if v}
    check(proved == out[1], "table-free prove B=1: cells and proofs equal the table route's bytes")
    t2 = time.perf_counter()
    commitment = free.blob_to_kzg_commitment(blob)
    torch.cuda.synchronize()
    commit_s = time.perf_counter() - t2
    check(commitment == ctx.blob_to_kzg_commitment(blob), "table-free commitment equals the table route's")
    check(launches.get("fixed_base_msm", 0) == 0 and launches.get("g1_add", 0) > 0,
          f"table-free prove: Pippenger's g1_add and no fixed_base_msm launch expected: {launches}")
    keep = list(range(0, 128, 2))
    t3 = time.perf_counter()
    recovered = free.recover_cells_and_kzg_proofs(keep, [out[1][0][i] for i in keep])
    torch.cuda.synchronize()
    recover_s = time.perf_counter() - t3
    check(recovered == out[1], "table-free recover B=1: cells and proofs equal the table route's bytes")
    emit({"phase": "table_free", "init_s": init_s, "prove_b1_s": prove_s, "commit_s": commit_s,
          "recover_b1_s": recover_s, "launches": launches, "seconds": time.perf_counter() - t0})


TABLE_BUILD_KERNELS = ("g1_fft", "g1_add", "g1_double", "batch_inverse")


@contextlib.contextmanager
def _setup_cache_dir(TS, path):
    """The port's setup cache kept in `path` for the block."""
    saved, TS.CACHE_DIR = TS.CACHE_DIR, path
    try:
        yield
    finally:
        TS.CACHE_DIR = saved


def phase_persist(torch, api, K, ctx, blobs, out, cold_init_s):
    """The table snapshot: save the mainnet context's tables under a
    temporary directory, start a new DASContext(table_cache=path) (its init
    must launch no g1_fft and none of the table build's kernels), prove the
    8 blobs byte-equal to phase 3; then a context of another window over the
    same snapshot refuses it, builds its own tables and saves them there.
    Also the parts of an init: the embedded setup's parse (a miss of its
    cache), the cache's write and load (a hit, equal to the parse), a
    prover's cold build, and the snapshot's read and upload alone; then both
    inits with the setup cache warm. The setup cache lives in temporary
    directories here: "cold" stays empty for the first init from the
    snapshot (a parse, as in cold_init_s), "warm" holds it."""
    import tempfile

    from rust_eth_kzg_tpu_torch.models.fk20 import FK20Prover
    from rust_eth_kzg_tpu_torch.utils import persist

    TS, text, _ = _setup_cache()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        warm_dir, cold_dir = os.path.join(tmp, "warm"), os.path.join(tmp, "cold")
        os.mkdir(warm_dir)
        os.mkdir(cold_dir)
        # where an init's time goes: the embedded setup's parse (a miss) or
        # its cache's load (a hit), the tables' build (cold) or their read
        # and upload (snapshot)
        with _setup_cache_dir(TS, warm_dir):
            t1 = time.perf_counter()
            setup = TS.TrustedSetup.default()
            parse_s = time.perf_counter() - t1
            check(os.listdir(warm_dir) == [os.path.basename(TS.cache_path(text))],
                  "a setup cache miss writes one cache file")
            t1 = time.perf_counter()
            check(TS.save_cache(os.path.join(tmp, "setup_cache_write.npz"), setup), "the setup cache writes")
            cache_write_s = time.perf_counter() - t1
            t1 = time.perf_counter()
            hit = TS.TrustedSetup.default()
            cache_load_s = time.perf_counter() - t1
        check(hit.g1_monomial == setup.g1_monomial and hit.g2_monomial == setup.g2_monomial
              and len(hit.g1_monomial) == 4096 and len(hit.g2_monomial) == 65,
              "the setup cache's hit gives the parse's 4,096 G1 and 65 G2 points")
        cfg = ctx.config
        geometry = persist.config_geometry(cfg)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        FK20Prover(setup.g1_monomial, cfg, ctx.device)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t1
        path = os.path.join(tmp, "tables.snap")
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        ctx.save_tables(path)
        save_s = time.perf_counter() - t1
        file_bytes = os.path.getsize(path)
        t1 = time.perf_counter()
        persist.try_load_tables(path, ctx.prover.srs_fingerprint, cfg.fk20_window, cfg.commit_window, geometry,
                                ctx.device)
        torch.cuda.synchronize()
        read_s = time.perf_counter() - t1
        K.reset_launches()
        t2 = time.perf_counter()
        with _setup_cache_dir(TS, cold_dir):
            warm = api.DASContext(device=ctx.device, table_cache=path)
            torch.cuda.synchronize()
        load_init_s = time.perf_counter() - t2
        init_launches = {k: v for k, v in K.LAUNCHES.items() if v}
        check(all(K.LAUNCHES[k] == 0 for k in TABLE_BUILD_KERNELS),
              f"init from the snapshot: no G1-FFT and no table-build launch expected: {init_launches}")
        for mine, cold in ((warm.prover.tables, ctx.prover.tables), (warm.prover.commit_tables, ctx.prover.commit_tables)):
            check(all(torch.equal(getattr(mine, k), getattr(cold, k)) for k in ("table_x", "table_y", "base_inf")),
                  "the snapshot's tables equal the built ones")
        check(warm.compute_cells_and_kzg_proofs_batch(blobs) == out,
              "prove B=8 from the snapshot's tables: phase 3's bytes")
        del warm
        # both inits with the setup cache warm
        with _setup_cache_dir(TS, warm_dir):
            t2 = time.perf_counter()
            warm = api.DASContext(device=ctx.device, table_cache=path)
            torch.cuda.synchronize()
            load_init_warm_setup_s = time.perf_counter() - t2
            del warm
            t2 = time.perf_counter()
            cold = api.DASContext(device=ctx.device)
            torch.cuda.synchronize()
            cold_init_warm_setup_s = time.perf_counter() - t2
        check(cold.compute_cells_and_kzg_proofs_batch(blobs[:2]) == out[:2],
              "prove B=2 of a context whose setup came from the cache: phase 3's bytes")
        del cold
        check(persist.try_load_tables(path, ctx.prover.srs_fingerprint, cfg.fk20_window, cfg.commit_window,
                                      (cfg.poly_len, 2 * cfg.coset_size, cfg.expansion), ctx.device) is None,
              "a snapshot of another geometry is refused")
        K.reset_launches()
        t3 = time.perf_counter()
        other = api.DASContext(device=ctx.device, use_precomp=6, table_cache=path)
        torch.cuda.synchronize()
        rebuild_s = time.perf_counter() - t3
        rebuilt = {k: v for k, v in K.LAUNCHES.items() if v}
        check(other.prover.tables.window == 6 and rebuilt.get("g1_fft", 0) > 0,
              f"a snapshot of another window is refused and the tables rebuilt: {rebuilt}")
        check(persist.try_load_tables(path, other.prover.srs_fingerprint, 6, 6, geometry, ctx.device) is not None,
              "the rebuilt tables were saved over the snapshot")
        del other
    emit({"phase": "persist", "save_s": save_s, "file_bytes": file_bytes, "cold_init_s": cold_init_s,
          "init_from_snapshot_s": load_init_s, "init_launches": init_launches, "rebuild_window6_s": rebuild_s,
          "setup_parse_s": parse_s, "setup_cache_write_s": cache_write_s, "setup_cache_load_s": cache_load_s,
          "cold_init_warm_setup_s": cold_init_warm_setup_s, "init_from_snapshot_warm_setup_s": load_init_warm_setup_s,
          "prover_build_s": build_s, "snapshot_read_upload_s": read_s, "seconds": time.perf_counter() - t0})


def phase_mainnet_oracle(torch, api, C, device):
    from rust_eth_kzg_tpu_torch.constants import R_SCALAR
    from rust_eth_kzg_tpu_torch.models import naive
    from rust_eth_kzg_tpu_torch.ops import ntt
    from rust_eth_kzg_tpu_torch.utils import bls_host as B
    from rust_eth_kzg_tpu_torch.utils.trusted_setup import TrustedSetup

    t0 = time.perf_counter()
    tau = _random_ints(R_SCALAR - 2, 1, SEED + 100)[0] + 2
    # SRS [tau^i] G, i < 4096, by one batched GLV ladder on the card
    powers = [1] * 4096
    for i in range(1, 4096):
        powers[i] = powers[i - 1] * tau % R_SCALAR
    g = C.points_to_device([B.G1_GEN] * 4096, device)
    digits, n1, n2 = (torch.from_numpy(a).to(device) for a in C.glv_digits_host(powers))
    srs = C.affine_from_device(C.batch_normalize(C.scalar_mul_glv(g, digits, n1, n2)))
    check(srs[1] == B.g1_mul(B.G1_GEN, tau), "SRS point 1 is [tau] G")
    srs_s = time.perf_counter() - t0
    ctx = api.DASContext(device=device, trusted_setup=TrustedSetup(srs))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0 - srs_s

    coeffs = _random_ints(R_SCALAR, 4096, SEED + 101)
    dom = ntt.Domain(4096, "cpu")
    evals = naive.ntt_host(coeffs, dom.generator)
    rev = ntt.bitrev_indices(4096)
    blob = b"".join(evals[int(r)].to_bytes(32, "big") for r in rev)
    cells, proofs = ctx.compute_cells_and_kzg_proofs(blob)
    commitment = ctx.blob_to_kzg_commitment(blob)
    check(commitment == B.g1_compress(naive.commit_with_tau(coeffs, tau)), "commitment == [p(tau)] G")
    ext = ntt.Domain(8192, "cpu")
    ext_evals = naive.ntt_host(coeffs + [0] * 4096, ext.generator)
    rev_ext = ntt.bitrev_indices(8192)
    want_cells = b"".join(ext_evals[int(r)].to_bytes(32, "big") for r in rev_ext)
    check(b"".join(cells) == want_cells, "all 128 cells == host evaluations")
    coset = ntt.Domain(64, "cpu")
    checked = []
    for k in (0, 1, 77, 127):
        hk = ext.roots[int(ntt.bitrev_indices(128)[k])]
        pts = [hk * w % R_SCALAR for w in coset.roots]
        want, _ = naive.compute_multi_opening_naive(coeffs, pts, tau)
        check(proofs[k] == B.g1_compress(want), f"proof {k} == [q_k(tau)] G")
        checked.append(k)
    # EIP-4844: y = f(z) and the proof [(f(tau) - y) / (tau - z)] G at two z
    f_tau = naive.poly_eval_host(coeffs, tau)
    for z in _random_ints(R_SCALAR, 2, SEED + 102):
        proof, y = ctx.compute_kzg_proof(blob, z.to_bytes(32, "big"))
        want_y = naive.poly_eval_host(coeffs, z)
        check(int.from_bytes(y, "big") == want_y, "compute_kzg_proof: y == f(z)")
        q_tau = (f_tau - want_y) * pow(tau - z, -1, R_SCALAR) % R_SCALAR
        check(proof == B.g1_compress(B.g1_mul(B.G1_GEN, q_tau)), "compute_kzg_proof: proof == [(f(tau) - y) / (tau - z)] G")
    emit({"phase": "mainnet_oracle", "srs_s": srs_s, "init_s": init_s, "proofs_checked": checked,
          "cells_checked": 128, "commitment_checked": True, "kzg_proofs_checked": 2,
          "seconds": time.perf_counter() - t0})


# Montgomery products of a chord addition (curve.cuh's g1_add_affine, the
# fixed-base MSM's first level); its tree and Horner run the teams' team_add
# and team_double (g1_team.cuh): ADD_PRODUCTS and DBL_PRODUCTS.
MSM_CHORD_PRODUCTS = 8


def fixed_base_msm_work(K, M, tables, scalars):
    """The work fixed_base_msm needs on these inputs, from their digits (on
    the host): a live entry has a nonzero digit and a base point that is not
    the identity; a chord addition with both lanes live costs 8 products (one
    with an identity lane passes the other through), a tree addition whose
    two operands both hold a live lane 12, and each output point's Horner
    loop (wpc - 1) (window doublings of 8 + 1 addition of 12); one Fr
    product a scalar to standard form. Bytes: 96 B a live entry, the
    scalars, the identity mask and the output points. Also, as counts, the
    gather's bytes in 32 B sectors (one a word of an entry: the tables are
    limb-major) and Horner's product rounds on one team's chain."""
    import torch

    w, chains, wpc = tables.window, tables.chains, tables.wpc
    sm = scalars.cpu()
    digits = M.chain_digits(M.signed_digits(sm, w), chains, wpc)  # [wpc, *batch, CP]
    cp = digits.shape[-1]
    live = ((digits != 0) & ~tables.base_inf.cpu()).reshape(-1, cp)
    chord, m, s, g = K.fixed_base_split(cp)
    chord_adds = 0
    level = live
    if chord:
        chord_adds = int((live[:, :m] & live[:, m:]).sum())
        level = live[:, :m] | live[:, m:]
    if s * g > level.shape[1]:
        level = torch.cat((level, torch.zeros((level.shape[0], s * g - level.shape[1]), dtype=torch.bool)), dim=1)
    tree_adds = 0
    while level.shape[1] > 1:
        h = level.shape[1] // 2
        tree_adds += int((level[:, :h] & level[:, h:]).sum())
        level = level[:, :h] | level[:, h:]
    n_scalars = sm[0].numel()
    n_out = n_scalars // (cp // chains)
    horner_products = n_out * (wpc - 1) * (w * DBL_PRODUCTS + ADD_PRODUCTS)
    products = chord_adds * MSM_CHORD_PRODUCTS + tree_adds * ADD_PRODUCTS + horner_products
    live_entries = int(live.sum())
    sector_bytes = live_entries * 24 * 32
    return {
        "live_entries": live_entries, "lanes": live.numel(), "chord_additions": chord_adds,
        "tree_additions": tree_adds, "horner_products": horner_products, "fp_products": products,
        "fr_products": n_scalars, "output_points": n_out, "split_blocks": g,
        "imad": products * mont_mul_imad(12) + n_scalars * mont_mul_imad(8),
        "bytes": 96 * live_entries + 32 * n_scalars + tables.base_inf.numel() + 3 * 48 * n_out,
        "gather_sector_bytes": sector_bytes,
        "horner_rounds": (wpc - 1) * (w * DBL_ROUNDS + ADD_ROUNDS),
    }


def _launch_split_ms(torch, fn):
    """Device ms of each of fixed_base_msm's two launches in one call, by
    torch.profiler as measure_call reads it; None for a launch the profiler
    did not report."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    split = {"windows": None, "horner": None}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0.0)
        for part in split:
            if f"fixed_base_msm_{part}_kernel" in ev.key and us:
                split[part] = (split[part] or 0.0) + us / 1e3
    return split


def phase_fixed_base_msm(torch, K, C, ctx, results, device):
    """fixed_base_msm against fixed_base_msm_plain (the last kernel of phase
    2; it needs the prover's mainnet tables): the FK20 slot MSMs of one blob,
    [1, 128, 64] random scalars (timed: the main-path row), and of 8 blobs
    (timed as `wide`; the plain route one blob at a time); checked on the
    same tables at [2, 128, 64], on the verifier's 64-point commitment table
    with two identity base points and on the 4,096-point commit key with one
    lane in 997 flagged as an identity base point, each with zero scalars,
    r - 1 and an all-zero first row (edge_inputs.msm_scalars)."""
    from rust_eth_kzg_tpu_torch.ops import msm as M
    from rust_eth_kzg_tpu_torch.utils.edge_inputs import msm_scalars

    t0 = time.perf_counter()

    def compare(*args, **kwargs):
        _compare(torch, results, *args, **kwargs)

    def kernel_of(tables, scalars):
        return lambda: K.fixed_base_msm(tables.table_x, tables.table_y, tables.base_inf, scalars,
                                        tables.window, tables.chains, tables.wpc)

    def launches_of(fn):
        before = dict(K.LAUNCHES)
        fn()
        torch.cuda.synchronize()
        return {k: v - before[k] for k, v in K.LAUNCHES.items() if v != before[k]}

    latency_ms = results["mont_mul"]["fp_product_latency_us"] / 1e3
    fk = ctx.prover.tables
    horner_ms = {}
    for b, record in ((1, "fixed_base_msm"), (8, "fixed_base_msm_wide")):
        scalars = torch.from_numpy(msm_scalars((b, 128, 64), SEED + 60 + b, edges=False)).to(device)
        kernel = kernel_of(fk, scalars)
        if b == 1:
            def plain():
                return tuple(M.fixed_base_msm_plain(fk, scalars))
        else:
            def plain():
                rows = [M.fixed_base_msm_plain(fk, scalars[:, i : i + 1]) for i in range(b)]
                return tuple(torch.cat([r[c] for r in rows], dim=1) for c in range(3))
        check(launches_of(kernel) == {"fixed_base_msm": K.LAUNCHES_PER_CALL["fixed_base_msm"]},
              "fixed_base_msm: one call is its two launches and nothing else")
        check(launches_of(plain) == {}, "fixed_base_msm_plain launches no kernel")
        work = fixed_base_msm_work(K, M, fk, scalars)
        compare("fixed_base_msm", kernel, plain, work["bytes"], work["imad"], reps=10, record=record,
                plain_reps=0)
        results[record].update({k: v for k, v in work.items() if k not in ("imad", "bytes")})
        results[record]["launch_ms"] = _launch_split_ms(torch, kernel)
        # a model figure (rounds x the probe's latency): on the phase line only
        horner_ms[record] = work["horner_rounds"] * latency_ms
    s2 = torch.from_numpy(msm_scalars((2, 128, 64), SEED + 69)).to(device)
    compare("fixed_base_msm", kernel_of(fk, s2), lambda: tuple(M.fixed_base_msm_plain(fk, s2)), 0, 0, main=False)
    # the last rank's slot slice over a mesh's work dim: [2, 64, 64] at work =
    # 2 and [2, 32, 64] at work = 4 (the sharded prover's shapes)
    for work in (2, 4):
        part = M.slice_instances(fk, slice(128 - 128 // work, 128))
        sp = torch.from_numpy(msm_scalars((2, 128 // work, 64), SEED + 72 + work)).to(device)
        compare("fixed_base_msm", kernel_of(part, sp), lambda: tuple(M.fixed_base_msm_plain(part, sp)), 0, 0,
                main=False)
    # the verifier's 64-point commitment table, two of its base points the identity
    pts = list(ctx.verifier.g1s[:64])
    pts[5] = pts[40] = None
    t64 = M.build_fixed_base_msm(C.points_to_device(pts, device), window=8)
    check(int(t64.base_inf.sum()) == 2 * t64.chains, "64-point table: two identity base points a chain")
    s64 = torch.from_numpy(msm_scalars((2, 64), SEED + 70)).to(device)
    compare("fixed_base_msm", kernel_of(t64, s64), lambda: tuple(M.fixed_base_msm_plain(t64, s64)), 0, 0,
            main=False)
    # the commit key, [12, 16384, 128]: 8,192 points a window sum after the
    # chord level, split over 64 blocks
    ck = ctx.prover.commit_tables
    inf = ck.base_inf.clone()
    inf[::997] = True
    ckf = M.FixedBaseMSM(ck.table_x, ck.table_y, inf, ck.window, ck.instance_ndim, ck.chains, ck.wpc)
    sck = torch.from_numpy(msm_scalars((2, 4096), SEED + 71)).to(device)
    compare("fixed_base_msm", kernel_of(ckf, sck), lambda: tuple(M.fixed_base_msm_plain(ckf, sck)), 0, 0,
            main=False)
    results["fixed_base_msm"]["commit_key_split_blocks"] = K.fixed_base_split(ck.table_x.shape[-2])[3]
    emit({"phase": "kernels_fixed_base_msm", "seconds": time.perf_counter() - t0, "checked": [
        {"name": k, "ok": results[k]["ok"], "kernel_ms": results[k]["kernel_ms"], "plain_ms": results[k]["plain_ms"],
         "launch_ms": results[k]["launch_ms"], "horner_critical_path_probe_ms": horner_ms[k]} for k in ("fixed_base_msm", "fixed_base_msm_wide")
    ] + [{"name": "fixed_base_msm", "shape": shape, "ok": True} for shape in (
        "fk20_b2_edges", "fk20_work2_b2", "fk20_work4_b2", "commit_64", "commit_key_4096")]})


KERNEL_FUNCTIONS = {
    "g1_add_affine": "g1_add_affine_kernel", "g1_add_mixed": "g1_add_mixed_kernel",
    "g1_add": "g1_add_kernel", "g1_double": "g1_double_kernel", "mont_mul": "mont_mul_kernel",
    "field_butterfly": "butterfly_kernel", "batch_inverse": "batch_inverse_",  # _lanes_kernel, _blocks_kernel
    "ntt": "ntt_pass_kernel",
    "g1_fft": "g1_fft_kernel", "g1_decompress": "g1_decompress_kernel",
    "fixed_base_msm": "fixed_base_msm_",  # its two launches: _windows_kernel, _horner_kernel
}


def measure_call(torch, K, fn, reps=5):
    """One call timed: a warm-up, then `reps` runs by the host clock (each
    closed by a synchronize) and CUDA events; then one run under
    torch.profiler for device busy time (self time of every device event
    that is no annotation) and device ms by kernel; then one run for the
    launches per call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    host, dev = [], []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        h0 = time.perf_counter()
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        host.append((time.perf_counter() - h0) * 1e3)
        dev.append(start.elapsed_time(stop))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    per_kernel = dict.fromkeys(K.KERNELS, 0.0)
    busy = 0.0
    for ev in prof.key_averages():
        # device events only, as torch.profiler's own table sums them: a
        # span (record_function) is a GPU annotation over its kernels and
        # the CPU parent of the kernels launched through ctypes, so it would
        # count them again
        if ev.device_type == torch.autograd.DeviceType.CPU or getattr(ev, "is_user_annotation", False):
            continue
        self_us = getattr(ev, "self_device_time_total", None)
        if self_us is None:
            self_us = getattr(ev, "self_cuda_time_total", 0.0)
        if not self_us:
            continue
        busy += self_us / 1e3
        for name, kfn in KERNEL_FUNCTIONS.items():
            if kfn in ev.key:
                per_kernel[name] += self_us / 1e3
                break
    K.reset_launches()
    fn()
    torch.cuda.synchronize()
    median = statistics.median(host)
    return {
        "median_ms": median, "runs_ms": host, "cuda_event_ms": statistics.median(dev),
        "device_busy_ms": busy, "host_share_ms": median - busy,
        "in_no_kernel_ms": busy - sum(per_kernel.values()),
        "kernel_device_ms": per_kernel, "launches": dict(K.LAUNCHES),
    }


def measure_host_call(torch, K, fn, reps=3):
    """One call timed without the profiler: a warm-up, then `reps` runs by
    the host clock, each closed by a synchronize; the launches per call
    are those of the timed runs over `reps`. For g2_lincomb, whose ~4e5
    small torch ops made torch.profiler's trace of one call take minutes:
    its device busy time is not measured."""
    fn()
    torch.cuda.synchronize()
    K.reset_launches()
    runs = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t) * 1e3)
    return {"median_ms": statistics.median(runs), "runs_ms": runs, "device_busy_ms": None,
            "launches": {k: v // reps for k, v in K.LAUNCHES.items()}}


def phase_timing(torch, K, ctx, card, out, comms, blobs, blob_proofs, g2_inputs, mesh_launches, mesh_timing):
    import numpy as np

    from rust_eth_kzg_tpu_torch.constants import R_SCALAR
    from rust_eth_kzg_tpu_torch.ops import curve_g2 as G2

    t0 = time.perf_counter()
    calls = {}
    def no_per_op_msm(name, r):
        n = r["launches"]
        check(n["fixed_base_msm"] == K.LAUNCHES_PER_CALL["fixed_base_msm"]
              and n["g1_add"] + n["g1_double"] + n["g1_add_affine"] == 0,
              f"{name}: one fixed_base_msm call and no g1_add, g1_double or g1_add_affine launch a call")

    for b in (1, 8):
        pblobs = [_random_blob(SEED + 10 + i) for i in range(b)]
        r = measure_call(torch, K, lambda: ctx.compute_cells_and_kzg_proofs_batch(pblobs))
        r["blobs_per_s"] = b / (r["median_ms"] / 1e3)
        no_per_op_msm(f"prove_B{b}", r)
        calls[f"prove_B{b}"] = r
    for first, nblobs in ((1, 1), (0, 8)):
        args = verify_batch(out[first:], comms[first:], nblobs)
        r = measure_call(torch, K, lambda: ctx.verify_cell_kzg_proof_batch(*args))
        check(r["launches"]["g1_decompress"] == 1, f"verify_{128 * nblobs}: 1 g1_decompress launch a call")
        calls[f"verify_{128 * nblobs}"] = r
    rng = np.random.default_rng(SEED + 300)
    for b in (1, 8):
        src = out[1:2] if b == 1 else out
        batches = []
        for cells, _ in src:
            idx = _kept(rng, 64)
            batches.append((idx, [cells[i] for i in idx]))
        calls[f"recover_B{b}"] = measure_call(torch, K, lambda: ctx.recover_cells_and_kzg_proofs_batch(batches))
        no_per_op_msm(f"recover_B{b}", calls[f"recover_B{b}"])
    # EIP-4844: one blob's proofs and checks, and the batch check of 8 blobs
    blob, comm = blobs[1], comms[1]
    z = _scalar_bytes(_random_ints(R_SCALAR, 1, SEED + 403)[0])
    proof, y = ctx.compute_kzg_proof(blob, z)
    calls["compute_blob_kzg_proof_B1"] = measure_call(torch, K, lambda: ctx.compute_blob_kzg_proof(blob, comm))
    no_per_op_msm("compute_blob_kzg_proof_B1", calls["compute_blob_kzg_proof_B1"])
    calls["compute_kzg_proof"] = measure_call(torch, K, lambda: ctx.compute_kzg_proof(blob, z))
    calls["verify_kzg_proof"] = measure_call(torch, K, lambda: ctx.verify_kzg_proof(comm, z, y, proof))
    calls["verify_blob_kzg_proof"] = measure_call(torch, K, lambda: ctx.verify_blob_kzg_proof(blob, comm, blob_proofs[1]))
    calls["verify_blob_kzg_proof_batch_8"] = measure_call(
        torch, K, lambda: ctx.verify_blob_kzg_proof_batch(blobs, comms, blob_proofs))
    check(calls["verify_blob_kzg_proof_batch_8"]["launches"]["g1_decompress"] == 1,
          "verify_blob_kzg_proof_batch: 1 g1_decompress launch a call")
    calls["g2_lincomb_65"] = measure_host_call(torch, K, lambda: G2.g2_lincomb(*g2_inputs))
    # the mesh proves, timed inside the ranks of phase mesh (host clock, median of 3)
    for name, key, launches in (("mesh_prove_B8_work2", "prove_work2", mesh_launches),
                                ("mesh_prove_B8_dp2", "prove_dp2", mesh_timing["launches_dp2"][0])):
        calls[name] = {"median_ms": mesh_timing[f"{key}_ms"][0], "runs_ms": mesh_timing[f"{key}_runs_ms"][0],
                       "by_rank_median_ms": mesh_timing[f"{key}_ms"], "launches": launches, "note": MESH_NOTE}
    emit({"phase": "timing", "card": card, "calls": calls,
          "stages_ms": _stage_times(torch, ctx, _random_blob(SEED + 7)),
          "verify_stages_ms": {
              "verify_128": _verify_stage_times(torch, ctx, verify_batch(out[1:], comms[1:], 1)),
              "verify_1024": _verify_stage_times(torch, ctx, verify_batch(out, comms, 8)),
          },
          "recover_stages_ms": _recover_stage_times(torch, ctx, batches),
          "verify_blob_batch_8_stages_ms": _verify_4844_stage_times(torch, ctx, blobs, comms, blob_proofs),
          "seconds": time.perf_counter() - t0})
    return calls


PROVE_SPANS = ("fk20/h_poly_commitments", "fk20/proofs_g1_fft", "fk20/coset_evaluations", "fk20/batch_normalize")
# a prove's spans in exit order: its stages, then its root
PROVE_CALL_SPANS = ("das/blob_codec", *PROVE_SPANS, "das/cells_bytes", "das/proofs_bytes",
                    "das/compute_cells_and_kzg_proofs_batch")


def _span_ab(torch, fn, pairs=5):
    """Host-clock ms of fn with the spans as they are (tracing off) and with
    every span's record_function a null context, interleaved: (with, without)
    runs. The decorator spans are bound at import, so the profiler scope
    itself is what is nulled."""
    with_spans, without = [], []
    saved = torch.profiler.record_function
    for _ in range(pairs):
        with_spans.append(_host_ms(torch, fn, reps=1)[0])
        torch.profiler.record_function = lambda name, args=None: contextlib.nullcontext()
        try:
            without.append(_host_ms(torch, fn, reps=1)[0])
        finally:
            torch.profiler.record_function = saved
    return with_spans, without


def phase_tracing(torch, ctx, blobs, out, calls):
    """utils/tracing.py on the card: a prove B=8 inside device_trace holds
    its root span and the four prover spans, each prover span with CUDA
    kernel time under it (device ms from the profiler's averages, and from
    the trace's GPU annotations); a prove B=8 with TRACE_ENABLED prints its
    span lines in exit order (stages, then the root); both give phase 3's
    bytes. Then prove B=1 and recover B=8 by the host clock with the spans
    as they are (tracing off) against the same call with every span a null
    context, interleaved, 5 pairs each."""
    import glob
    import io
    import tempfile

    import numpy as np

    from rust_eth_kzg_tpu_torch.utils import tracing

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        with tracing.device_trace(tmp) as prof:
            traced = ctx.compute_cells_and_kzg_proofs_batch(blobs)
            torch.cuda.synchronize()
        check(traced == out, "prove B=8 inside device_trace: phase 3's bytes")
        spans_ms = dict.fromkeys(PROVE_SPANS, 0.0)
        for ev in prof.key_averages():
            if ev.key in spans_ms:
                us = getattr(ev, "device_time_total", None)
                spans_ms[ev.key] += (us if us is not None else getattr(ev, "cuda_time_total", 0.0)) / 1e3
        traces = glob.glob(os.path.join(tmp, "*.pt.trace.json"))
        check(len(traces) == 1, f"device_trace wrote one *.pt.trace.json: {traces}")
        with open(traces[0]) as fh:
            events = json.load(fh)["traceEvents"]
    host = sorted((e["ts"], e["name"]) for e in events
                  if e.get("name") in PROVE_CALL_SPANS and e.get("ph") == "X" and e.get("cat") != "gpu_user_annotation")
    gpu_ms = dict.fromkeys(PROVE_SPANS, 0.0)
    for e in events:
        if e.get("name") in gpu_ms and e.get("cat") == "gpu_user_annotation":
            gpu_ms[e["name"]] += e.get("dur", 0) / 1e3
    check([name for _, name in host if name in PROVE_SPANS] == list(PROVE_SPANS)
          and [name for _, name in host][0] == PROVE_CALL_SPANS[-1]
          and sorted(name for _, name in host) == sorted(PROVE_CALL_SPANS),
          f"the trace holds the prove's root span, then its stages with the four prover spans in order: {host}")
    check(all(spans_ms[n] > 0 or gpu_ms[n] > 0 for n in PROVE_SPANS),
          f"each prover span has CUDA kernel time under it: {spans_ms}, {gpu_ms}")
    printed = io.StringIO()
    tracing.TRACE_ENABLED = True
    try:
        with contextlib.redirect_stdout(printed):
            logged = ctx.compute_cells_and_kzg_proofs_batch(blobs)
    finally:
        tracing.TRACE_ENABLED = False
    check(logged == out, "prove B=8 with KZG_TPU_TRACE on: phase 3's bytes")
    lines = printed.getvalue().splitlines()
    check([line.split(": ")[0] for line in lines] == [f"[kzg-tpu] {n}" for n in PROVE_CALL_SPANS]
          and all(line.endswith(" ms") for line in lines), f"KZG_TPU_TRACE prints the prove's span lines: {lines}")
    trace_ms = {line.split(": ")[0][len("[kzg-tpu] "):]: float(line.split(": ")[1][:-3]) for line in lines}
    blob = [_random_blob(SEED + 10)]
    prove_with, prove_without = _span_ab(torch, lambda: ctx.compute_cells_and_kzg_proofs_batch(blob))
    rng = np.random.default_rng(SEED + 301)
    batches = []
    for cells, _ in out:
        idx = _kept(rng, 64)
        batches.append((idx, [cells[i] for i in idx]))
    recover_with, recover_without = _span_ab(torch, lambda: ctx.recover_cells_and_kzg_proofs_batch(batches))
    check(ctx.recover_cells_and_kzg_proofs_batch(batches) == out, "recover B=8 after the span A/B: phase 3's bytes")
    emit({"phase": "tracing", "spans_device_ms": spans_ms, "spans_gpu_annotation_ms": gpu_ms,
          "trace_enabled_lines_ms": trace_ms, "prove_b1_median_ms": statistics.median(prove_with),
          "prove_b1_runs_ms": prove_with, "prove_b1_no_spans_median_ms": statistics.median(prove_without),
          "prove_b1_no_spans_runs_ms": prove_without, "prove_b1_phase8_median_ms": calls["prove_B1"]["median_ms"],
          "recover_b8_median_ms": statistics.median(recover_with), "recover_b8_runs_ms": recover_with,
          "recover_b8_no_spans_median_ms": statistics.median(recover_without),
          "recover_b8_no_spans_runs_ms": recover_without,
          "recover_b8_phase8_median_ms": calls["recover_B8"]["median_ms"], "seconds": time.perf_counter() - t0})


def _timed_stages(torch):
    """stage(name, fn, *args): runs fn between two synchronizes and keeps its
    host-clock ms under `name` in the returned dict."""
    stages = {}

    def stage(name, fn, *args):
        torch.cuda.synchronize()
        t = time.perf_counter()
        result = fn(*args)
        torch.cuda.synchronize()
        stages[name] = (time.perf_counter() - t) * 1e3
        return result

    return stages, stage


def _verify_stage_times(torch, ctx, args):
    """Host-clock ms of each stage of one verify: the API's host checks and
    Fiat-Shamir, the verifier's host preparation and upload, the device
    part, and the fetch, flag checks and pairing."""
    from rust_eth_kzg_tpu_torch.models.fk20_verifier import verify_device

    stages, stage = _timed_stages(torch)
    vargs = stage("host_checks_fiat_shamir", ctx.verify_inputs, *args)
    inputs = stage("prepare_upload", ctx.verifier.prepare, *vargs)
    outputs = stage("device", verify_device, ctx.verifier, *inputs.tensors)
    stage("fetch_flags_pairing", ctx.verifier.check, inputs, outputs)
    return stages


def _verify_4844_stage_times(torch, ctx, blobs, comms, proofs):
    """Host-clock ms of each stage of one verify_blob_kzg_proof_batch, through
    the functions it composes: the points' decompression (one launch), the
    blobs' challenges, the polynomial evaluations, the r powers, the two
    MSMs and the pairing."""
    from rust_eth_kzg_tpu_torch.utils import fiat_shamir as fs
    from rust_eth_kzg_tpu_torch.utils import serialization as ser

    eip = ctx.eip4844
    stages, stage = _timed_stages(torch)
    cs, pfs = stage("decompress", ser.decompress_g1_groups, [comms, proofs], ctx.device)
    zs = stage("challenges", eip.challenges, blobs, comms)
    ys = stage("evaluations", eip.evaluate, blobs, zs)
    r_powers = stage("r_powers", fs.compute_r_powers_blob_batch, ctx.config.poly_len, comms, zs, ys, proofs, len(blobs))
    lhs, rhs = stage("msms", eip.verifier.batch_points, cs, zs, ys, pfs, r_powers)
    stage("pairing", eip.verifier.pairing_check, lhs, rhs)
    return stages


def _recover_stage_times(torch, ctx, batches):
    """Host-clock ms of each stage of one recover, through the functions that
    `recover_cells_and_kzg_proofs_batch` composes: input checks and erasure
    layout, upload, the Reed-Solomon decode, the re-prove, and the fetch with
    the degree check and the encoding of cells and proofs."""
    stages, stage = _timed_stages(torch)
    e_std, z_small = stage("host_checks_layout", ctx.recovery_arrays, batches)
    e, z = stage("upload", ctx.upload, e_std, z_small)
    poly, ok = stage("rs_decode", ctx.rs.recover_polynomial_coefficient, e, z)
    proofs, cells = stage("reprove", ctx.prover.prove_from_poly, poly)
    stage("fetch_encode", ctx.recovery_outputs, ok, proofs, cells)
    return stages


def _stage_times(torch, ctx, blob):
    """Host-clock ms of each prover stage of one single-blob prove, each
    stage closed by a synchronize (the h-poly stage holds the 128 MSMs and
    the 128-point inverse G1-FFT; the proofs stage the forward G1-FFT)."""
    from rust_eth_kzg_tpu_torch.ops import curve as C

    prover = ctx.prover
    stages, stage = _timed_stages(torch)

    data = stage("to_mont", ctx._data, [blob])
    poly = stage("blob_to_poly", prover.blob_to_poly, data)
    h = stage("h_poly_commitments", prover._h_poly_commitments, poly)
    proofs = stage("proofs_fft_g1", prover._proofs_from_h, h)
    stage("batch_normalize", C.batch_normalize, proofs)
    stage("cells", prover._coset_evaluations, poly)
    return stages


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from rust_eth_kzg_tpu_torch import api
    from rust_eth_kzg_tpu_torch.ops import curve as C
    from rust_eth_kzg_tpu_torch.ops import field as F
    from rust_eth_kzg_tpu_torch.ops import kernels as K

    device = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    card = f"{smi}; torch {torch.__version__}; CUDA {torch.version.cuda}"
    try:
        build = phase_build(K)
        native_s = time.perf_counter()
        from rust_eth_kzg_tpu_torch.utils import native

        native.build()
        emit({"phase": "build_native", "library": os.path.relpath(native.library_path(), REPO),
              "seconds": time.perf_counter() - native_s})
        results = phase_kernels(torch, K, F, C, device)
        ctx, prove_launches, blobs, out, init_s = phase_mainnet_setup(torch, api, K, device)
        phase_fixed_base_msm(torch, K, C, ctx, results, device)
        recover_launches = phase_recover(torch, K, ctx, out)
        verify_launches, comms = phase_verify(torch, K, ctx, blobs, out)
        blob_proofs, prove_4844_launches, verify_4844_launches = phase_eip4844(torch, K, ctx, blobs, out, comms)
        mesh_launches, mesh_timing = phase_mesh(torch, K, ctx, blobs, out)
        g2_launches, g2_inputs = phase_g2(torch, K, device)
        paths = {
            "prove": ("compute_cells_and_kzg_proofs_batch, 8 blobs", prove_launches),
            "recover": ("recover_cells_and_kzg_proofs_batch, 8 blobs, 64 of 128 cells each", recover_launches),
            "verify": ("verify_cell_kzg_proof_batch, 1,024 cells of 8 blobs", verify_launches),
            "prove_4844": ("compute_blob_kzg_proof, 1 blob", prove_4844_launches),
            "verify_4844": ("verify_blob_kzg_proof_batch, 8 blobs", verify_4844_launches),
            "mesh_prove": ("compute_cells_and_kzg_proofs_batch on a work = 2 mesh, 8 blobs: rank 0 of 2",
                           mesh_launches),
            "g2_lincomb": ("curve_g2.g2_lincomb, the setup's 65 G2 points", g2_launches),
        }
        emit({"phase": "launches", "paths": {k: {"call": c, "launches": n} for k, (c, n) in paths.items()}})
        # every kernel each path runs launched on it; g1_decompress runs only
        # in the verifier (its subgroup ladder holds g1_add_mixed's work),
        # every scalar NTT is one ntt call (its passes hold field_butterfly's
        # stages),
        # g1_fft only in the prover's two G1 transforms (prove, and recover's
        # re-prove), fixed_base_msm in every fixed-base MSM (its chord level
        # holds g1_add_affine's work); g1_add and g1_double run in the
        # verifier's Pippenger MSMs only
        fused_away = {"g1_add_mixed", "g1_add_affine", "field_butterfly"}
        # the EIP-4844 prover checks its commitment (g1_decompress) and runs
        # the blob's inverse NTT, the Ruffini scan (mont_mul) and one
        # fixed-base MSM; its batch verifier decompresses every point in one
        # launch and runs its two MSMs as GLV ladders (g1_add, g1_double)
        expected = {
            "prove": set(K.KERNELS) - fused_away - {"g1_decompress", "g1_add", "g1_double"},
            "recover": set(K.KERNELS) - fused_away - {"g1_decompress", "g1_add", "g1_double"},
            "verify": set(K.KERNELS) - fused_away - {"g1_fft"},
            "prove_4844": {"g1_decompress", "mont_mul", "ntt", "fixed_base_msm", "batch_inverse"},
            "verify_4844": {"g1_decompress", "mont_mul", "ntt", "g1_add", "g1_double", "batch_inverse"},
            # a rank of the work-sharded prover runs what the prover runs, over its slots
            "mesh_prove": set(K.KERNELS) - fused_away - {"g1_decompress", "g1_add", "g1_double"},
            # every Fp2 product a mont_mul launch; no G1 kernel
            "g2_lincomb": {"mont_mul"},
        }
        for path, (_, counts) in paths.items():
            missing = sorted(k for k in expected[path] if counts[k] <= 0)
            check(not missing, f"{path} path launched no {missing}: {counts}")
        # the G1 transforms are one g1_fft launch each and the slot MSMs one
        # fixed_base_msm call, not ladders, trees and Horner loops composed
        # from the per-operation kernels
        msm_call = K.LAUNCHES_PER_CALL["fixed_base_msm"]
        for path in ("prove", "recover", "mesh_prove"):
            counts = paths[path][1]
            check(counts["g1_fft"] == 2, f"{path}: 2 g1_fft launches expected: {counts}")
            check(counts["fixed_base_msm"] == msm_call,
                  f"{path}: one fixed_base_msm call ({msm_call} launches) expected: {counts}")
            check(counts["g1_add"] + counts["g1_double"] + counts["g1_add_affine"] == 0,
                  f"{path}: no g1_add, g1_double or g1_add_affine launch expected: {counts}")
        # whole NTTs: no field_butterfly launch on any path, and at most 5 ntt
        # launches a prove B=8 (the 4,096-point ifft and the 8,192-point
        # cells NTT two each, the circulant 128-point NTT one), 16 a recover
        # B=8, 2 a verify
        for path, most in (("prove", 5), ("recover", 16), ("verify", 2)):
            counts = paths[path][1]
            check(counts["field_butterfly"] == 0 and 1 <= counts["ntt"] <= most,
                  f"{path}: no field_butterfly launch and 1 to {most} ntt launches expected: {counts}")
        # the verifier's decompression is one fused launch: the square root's
        # products and the subgroup ladder no longer launch one by one; its
        # commitment MSM is one fixed_base_msm call
        counts = paths["verify"][1]
        check(counts["g1_decompress"] == 1, f"verify: 1 g1_decompress launch expected: {counts}")
        check(counts["mont_mul"] <= 20, f"verify: at most 20 mont_mul launches expected: {counts}")
        check(counts["fixed_base_msm"] == msm_call and counts["g1_add_affine"] == 0,
              f"verify: one fixed_base_msm call and no g1_add_affine launch expected: {counts}")
        # the EIP-4844 prover: one fixed_base_msm call over the commit key, at
        # most 2 ntt launches (the blob's 4,096-point inverse), no G1
        # transform and no per-operation group kernel; its batch verifier:
        # exactly 1 g1_decompress launch for all 16 points, the GLV ladders'
        # g1_add and g1_double, no G1 transform
        counts = paths["prove_4844"][1]
        check(counts["fixed_base_msm"] == msm_call and counts["ntt"] <= 2
              and all(counts[k] == 0 for k in ("g1_fft", "g1_add", "g1_double", "g1_add_affine", "field_butterfly")),
              f"prove_4844: one fixed_base_msm call, at most 2 ntt launches, no g1_fft, g1_add, g1_double, "
              f"g1_add_affine or field_butterfly launch expected: {counts}")
        counts = paths["verify_4844"][1]
        check(counts["g1_decompress"] == 1 and counts["g1_add"] > 0 and counts["g1_double"] > 0
              and counts["g1_fft"] == 0,
              f"verify_4844: 1 g1_decompress launch, g1_add and g1_double launches, no g1_fft expected: {counts}")
        counts = paths["g2_lincomb"][1]
        check(all(n == 0 for k, n in counts.items() if k != "mont_mul"),
              f"g2_lincomb: mont_mul launches only, no G1 kernel expected: {counts}")
        # every kernel launched on some path, or its work runs inside a
        # launched kernel whose `replaces` names its TPU kernel
        launched = {k for k in K.KERNELS if any(n[k] > 0 for _, n in paths.values())}
        for k in sorted(set(K.KERNELS) - launched):
            inside = [j for j in launched if K.KERNELS[k][2] in K.KERNELS[j][2]]
            check(inside, f"kernel {k} launched on no path and runs inside no launched kernel")
        phase_table_free(torch, api, K, ctx, blobs, out)
        phase_persist(torch, api, K, ctx, blobs, out, init_s)
        phase_mainnet_oracle(torch, api, C, device)
        calls = phase_timing(torch, K, ctx, card, out, comms, blobs, blob_proofs, g2_inputs, mesh_launches,
                             mesh_timing)
        phase_tracing(torch, ctx, blobs, out, calls)
    except CheckFailed as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr, flush=True)
        return 1
    summary = []
    for name, (src, _, replaces) in K.KERNELS.items():
        r = results[name]
        by_path = {k: n[name] for k, (_, n) in paths.items()}
        row = {
            "name": name, "route": "cuda", "source": f"rust_eth_kzg_tpu_torch/csrc/{src}",
            "replaces": replaces, "launches": sum(by_path.values()), "launches_by_path": by_path,
            "launches_per_call": {k: v["launches"][name] for k, v in calls.items()},
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "kernel_ms": r["kernel_ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": None, "ok": r["ok"], "registers": build[name]["registers"],
            "spill_stores": build[name]["spill_stores"], "spill_loads": build[name]["spill_loads"],
            "stack": build[name]["stack"],
        }
        wide = results.get(f"{name}_wide")
        if wide:
            row.update({"wide_ms": wide["ms"], "wide_plain_ms": wide["plain_ms"],
                        "wide_bound_ms": wide["bound_ms"], "wide_bound_by": wide["bound_by"]})
            row.update({f"wide_{k}": v for k, v in wide.items() if k in ("launch_ms", "fp_products", "live_entries",
                                                                           "gather_sector_bytes")})
        for key, value in r.items():
            if key not in row and key not in ("kernel_ms", "ok"):
                row[key] = value
        summary.append(row)
    emit({"kernels": summary})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
