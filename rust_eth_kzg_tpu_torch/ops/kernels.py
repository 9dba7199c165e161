"""The port's CUDA kernels: build, load and launch.

Each source `csrc/<name>.cu` is compiled by nvcc for sm_90a into its own
shared library with a plain C entry point, loaded through ctypes (no
PyTorch headers, so a build takes seconds). The libraries go to
`_build/<hash of the sources>/` inside the package, built on first use; all
sources compile in parallel.

Each wrapper below takes CUDA tensors only: it checks device, dtype, shape
and contiguity, allocates its outputs and scratch with `torch.empty`,
launches on the current stream, raises if the launch failed, and adds its
launches to `LAUNCHES[name]` (one, `LAUNCHES_PER_CALL[name]`, or for `ntt`
one a pass). The plain
versions of the same functions live beside their callers (`ops/field.py`,
`ops/curve.py`, `ops/msm.py`, `ops/decompress.py`); the callers choose the
plain version only for tensors on the CPU.

Importing this module builds nothing and needs no card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time

import torch

from ..constants import GLV_NBITS, SCALAR_BITS

CSRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(os.path.dirname(__file__)), "_build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

# name -> (source, C entry point, the TPU kernel it replaces)
KERNELS = {
    "mont_mul": ("mont_mul.cu", "kzg_mont_mul", "rust_eth_kzg_tpu/ops/pallas_kernels.py:365"),
    "field_butterfly": (
        "field_butterfly.cu", "kzg_field_butterfly", "rust_eth_kzg_tpu/ops/pallas_kernels.py:243",
    ),
    "g1_add": ("g1_add.cu", "kzg_g1_add", "rust_eth_kzg_tpu/ops/pallas_kernels.py:163"),
    "g1_double": ("g1_double.cu", "kzg_g1_double", "rust_eth_kzg_tpu/ops/pallas_kernels.py:176"),
    "g1_add_mixed": (
        "g1_add_mixed.cu", "kzg_g1_add_mixed", "rust_eth_kzg_tpu/ops/pallas_kernels.py:186",
    ),
    "g1_add_affine": (
        "g1_add_affine.cu", "kzg_g1_add_affine", "rust_eth_kzg_tpu/ops/pallas_kernels.py:210",
    ),
    "batch_inverse": (
        "batch_inverse.cu", "kzg_batch_inverse", "rust_eth_kzg_tpu/ops/pallas_kernels.py:274",
    ),
    "g1_fft": ("g1_fft.cu", "kzg_g1_fft", "rust_eth_kzg_tpu/ops/ntt.py:232"),
    "g1_decompress": (
        "g1_decompress.cu", "kzg_g1_decompress",
        "rust_eth_kzg_tpu/ops/pallas_kernels.py:186 (g1_add_mixed; with :176 g1_double and :365 mont_mul)"
        " as composed by rust_eth_kzg_tpu/ops/decompress.py:139",
    ),
    "fixed_base_msm": (
        "fixed_base_msm.cu", "kzg_fixed_base_msm",
        "rust_eth_kzg_tpu/ops/pallas_kernels.py:163 (g1_add) and :176 (g1_double);"
        " rust_eth_kzg_tpu/ops/pallas_kernels.py:210 (g1_add_affine);"
        " as composed by rust_eth_kzg_tpu/ops/msm.py:334 (_window_sums) and :369 (fixed_base_msm)",
    ),
    "ntt": (
        "ntt.cu", "kzg_ntt",
        "rust_eth_kzg_tpu/ops/pallas_kernels.py:243 (field_butterfly; with :365 mont_mul for the scales)"
        " as composed by rust_eth_kzg_tpu/ops/ntt.py:128 (Domain._dit) and :171-205 (fft, ifft, coset_fft, coset_ifft)",
    ),
}

# Further entry points of a kernel's library, not on any path of the port:
# name -> (the kernel whose library holds it, C entry point)
PROBES = {"mont_mul_chain": ("mont_mul", "kzg_mont_mul_chain")}

LAUNCHES = dict.fromkeys([*KERNELS, *PROBES], 0)
# Kernel launches a wrapper call makes, where that is not 1 (each is counted)
LAUNCHES_PER_CALL = {"fixed_base_msm": 2}

_P = ctypes.c_void_p
_N = ctypes.c_longlong
_I = ctypes.c_int
_ARGTYPES = {
    "kzg_mont_mul": [_I, _P, _P, _P, _N, _P],
    "kzg_field_butterfly": [_I, _P, _P, _P, _N, _I, _I, _P],
    "kzg_batch_inverse": [_I, _P, _P, _P, _N, _I, _P],
    "kzg_g1_add": [_P] * 9 + [_N, _P],
    "kzg_g1_double": [_P] * 6 + [_N, _P],
    "kzg_g1_add_mixed": [_P] * 9 + [_N, _P],
    "kzg_g1_add_affine": [_P] * 9 + [_N, _P],
    "kzg_g1_fft": [_P] * 9 + [_N, _I, _P],
    "kzg_g1_decompress": [_P] * 8 + [_N, _P],
    "kzg_mont_mul_chain": [_I, _P, _P, _N, _I, _P],
    "kzg_fixed_base_msm": [_P] * 8 + [_N, _N] + [_I] * 9 + [_P],
    "kzg_ntt": [_P] * 6 + [_N, _I, _I, _P],
}

_lock = threading.Lock()
_fns: dict = {}
_build_info: dict = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for fname in sorted(os.listdir(CSRC)):
        if fname.endswith((".cu", ".cuh")):
            h.update(fname.encode())
            with open(os.path.join(CSRC, fname), "rb") as fh:
                h.update(fh.read())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the CUDA toolkit")


def parse_ptxas(log: str) -> dict:
    """Registers and spill bytes of each entry function in `nvcc -Xptxas -v` output."""
    out = {}
    func = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            func = m.group(1)
            out[func] = {"registers": None, "spill_stores": 0, "spill_loads": 0, "stack": 0}
            continue
        if func is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out[func].update(stack=int(m.group(1)), spill_stores=int(m.group(2)), spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[func]["registers"] = int(m.group(1))
    return out


def build_all() -> dict:
    """Compile every kernel source that is not built yet, all in parallel.

    Returns {name: {"seconds", "cached", "functions": ptxas report}} for this
    build directory. A library built by an earlier call is `cached`: its
    `seconds` is None and its ptxas report is the one its build logged.
    """
    with _lock:
        build_dir = os.path.join(BUILD_ROOT, _source_hash())
        os.makedirs(build_dir, exist_ok=True)
        nvcc = None
        procs = {}
        for name, (src, _, _) in KERNELS.items():
            lib = os.path.join(build_dir, f"lib{name}.so")
            if os.path.exists(lib):
                continue
            nvcc = nvcc or _nvcc()
            tmp = lib + f".{os.getpid()}.tmp"
            cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, src)]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), tmp, lib, time.perf_counter())
        failed = []
        for name, (proc, tmp, lib, t0) in procs.items():
            log, _ = proc.communicate()
            seconds = time.perf_counter() - t0
            with open(os.path.join(build_dir, f"{name}.log"), "w") as fh:
                fh.write(f"seconds {seconds:.3f}\n{log}")
            if proc.returncode != 0:
                failed.append(f"{name}:\n{log}")
                continue
            os.replace(tmp, lib)
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
        info = {}
        for name in KERNELS:
            with open(os.path.join(build_dir, f"{name}.log")) as fh:
                first, _, log = fh.read().partition("\n")
            cached = name not in procs
            info[name] = {
                "seconds": None if cached else float(first.split()[1]),
                "cached": cached,
                "functions": parse_ptxas(log),
            }
        _build_info.clear()
        _build_info.update(info)
        _build_info["_dir"] = build_dir
        return info


def _fn(name: str):
    fn = _fns.get(name)
    if fn is None:
        if "_dir" not in _build_info:
            build_all()
        lib_name, entry = PROBES[name] if name in PROBES else (name, KERNELS[name][1])
        lib = ctypes.CDLL(os.path.join(_build_info["_dir"], f"lib{lib_name}.so"))
        fn = getattr(lib, entry)
        fn.argtypes = _ARGTYPES[entry]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _check(t: torch.Tensor, rows: int | None, what: str, dtype=torch.int32) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{what}: expected a CUDA tensor, got one on {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{what}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous tensor")
    if rows is not None and (t.dim() < 1 or t.shape[0] != rows):
        raise ValueError(f"{what}: expected {rows} limb rows, got shape {tuple(t.shape)}")


def _launch(name: str, device: torch.device, *args, count: int | None = None) -> None:
    """Call `name`'s C entry on the current stream; it launches `count`
    kernels (default LAUNCHES_PER_CALL[name], else 1)."""
    fn = _fn(name)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {rc}")
    LAUNCHES[name] += LAUNCHES_PER_CALL.get(name, 1) if count is None else count


def _field_code(spec) -> int:
    return 1 if spec.name == "fp" else 0


def mont_mul(spec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a * b * R^-1 mod p over [L, *batch] (inputs broadcast together)."""
    a, b = torch.broadcast_tensors(a, b)
    a, b = a.contiguous(), b.contiguous()
    _check(a, spec.nlimbs, "mont_mul a")
    _check(b, spec.nlimbs, "mont_mul b")
    out = torch.empty_like(a)
    n = a[0].numel()
    if n:
        _launch("mont_mul", a.device, _field_code(spec), a.data_ptr(), b.data_ptr(), out.data_ptr(), n)
    return out


def mont_mul_chain(spec, a: torch.Tensor, k: int) -> torch.Tensor:
    """The chain probe: each lane of a [L, n] squared k times in a row
    (a^(2^k) in Montgomery form), k dependent products a lane."""
    _check(a, spec.nlimbs, "mont_mul_chain a")
    if a.dim() != 2 or k < 0:
        raise ValueError(f"mont_mul_chain: expected [L, n] and k >= 0, got {tuple(a.shape)}, k = {k}")
    out = torch.empty_like(a)
    n = a.shape[1]
    if n:
        _launch("mont_mul_chain", a.device, _field_code(spec), a.data_ptr(), out.data_ptr(), n, k)
    return out


def field_butterfly(spec, x: torch.Tensor, tw: torch.Tensor, stage: int) -> torch.Tensor:
    """One NTT stage over x [L, rows, n] with twiddles tw [L, n/2] (tw[k] = w^k)."""
    _check(x, spec.nlimbs, "field_butterfly x")
    _check(tw, spec.nlimbs, "field_butterfly tw")
    nl, rows, n = x.shape
    log_n = n.bit_length() - 1
    if n < 2 or n != 1 << log_n or tw.shape != (nl, n // 2) or not 0 <= stage < log_n:
        raise ValueError(f"field_butterfly: bad shapes x {tuple(x.shape)}, tw {tuple(tw.shape)}, stage {stage}")
    out = torch.empty_like(x)
    if rows:
        _launch("field_butterfly", x.device, _field_code(spec), x.data_ptr(), out.data_ptr(), tw.data_ptr(), rows, log_n, stage)
    return out


NTT_MAX_LOG_LINE = 10  # a pass transforms lines of up to 1,024 points in shared memory


def ntt_split(log_n: int) -> int:
    """log n1 of the `ntt` kernel's split of a 2^log_n-point transform: 0
    (one pass, one launch) up to 1,024 points; above, the four-step split
    n = n1 n2 with n1 = max(64, n / 1,024) (two launches): pass 1 the n2
    strided columns of length n1, each output k1 of column j2 times
    w^(j2 k1); pass 2 the n1 rows of length n2, written transposed."""
    if not 0 <= log_n <= 2 * NTT_MAX_LOG_LINE:
        raise ValueError(f"ntt: 2^{log_n} points is outside [1, 2^{2 * NTT_MAX_LOG_LINE}]")
    return 0 if log_n <= NTT_MAX_LOG_LINE else max(6, log_n - NTT_MAX_LOG_LINE)


def ntt(x: torch.Tensor, roots: torch.Tensor, pre=None, post=None) -> torch.Tensor:
    """The DFT of every row of x [8, rows, n] (Montgomery Fr, natural order
    in and out) over roots [8, n] (roots[k] = w^k): out[k] = post[k] sum_j
    pre[j] x[j] w^(j k), with pre and post [8, n] or None. One call: one
    launch up to 1,024 points, two above (`ntt_split`)."""
    _check(x, 8, "ntt x")
    _check(roots, 8, "ntt roots")
    if x.dim() != 3:
        raise ValueError(f"ntt: expected x [8, rows, n], got {tuple(x.shape)}")
    _, rows, n = x.shape
    log_n = n.bit_length() - 1
    if n != 1 << log_n or roots.shape != (8, n):
        raise ValueError(f"ntt: bad shapes x {tuple(x.shape)}, roots {tuple(roots.shape)}")
    log_n1 = ntt_split(log_n)
    scales = []
    for t, what in ((pre, "pre"), (post, "post")):
        if t is not None:
            _check(t, 8, f"ntt {what}")
            if t.shape != (8, n):
                raise ValueError(f"ntt: expected {what} [8, {n}], got {tuple(t.shape)}")
        scales.append(None if t is None else t.data_ptr())
    if any(t is not None and t.device != x.device for t in (roots, pre, post)):
        raise ValueError("ntt: x, roots and scales on different devices")
    out = torch.empty_like(x)
    scratch = torch.empty_like(x) if log_n1 else None
    if rows:
        _launch("ntt", x.device, x.data_ptr(), out.data_ptr(), None if scratch is None else scratch.data_ptr(),
                roots.data_ptr(), *scales, rows, log_n, log_n1, count=2 if log_n1 else 1)
    return out


# lanes up to which `batch_inverse` runs one GCD a lane rather than one a
# block of 32 behind Montgomery's trick: on the H100 a GCD a lane was the
# faster at every size from 128 to 65,536 lanes, Fp and Fr (chip_smoke.py's
# sweep; PERF.md)
BATCH_INVERSE_PER_LANE_MAX = 65536
# the GCD's shape: binary-GCD steps an outer iteration (STEPS in
# batch_inverse.cu) and outer iterations by field (GCD_OUTER in field.cuh,
# ceil((2 len(p) - 1) / GCD_STEPS) + 1)
GCD_STEPS = 31
GCD_OUTER = {"fp": 26, "fr": 18}


def batch_inverse(spec, a: torch.Tensor, per_lane: bool | None = None) -> torch.Tensor:
    """Elementwise inverse of [L, n] Montgomery limbs by a binary GCD; a zero
    lane makes its block (lanes i = c mod ceil(n / 32)) zero. `per_lane`:
    one GCD a lane, or one a block behind Montgomery's trick; None picks by
    n (BATCH_INVERSE_PER_LANE_MAX)."""
    _check(a, spec.nlimbs, "batch_inverse a")
    if a.dim() != 2:
        raise ValueError(f"batch_inverse: expected [L, n], got {tuple(a.shape)}")
    n = a.shape[1]
    if per_lane is None:
        per_lane = n <= BATCH_INVERSE_PER_LANE_MAX
    out = torch.empty_like(a)
    scratch = None if per_lane else torch.empty((spec.nlimbs, 32 * (-(-n // 32))), dtype=torch.int32, device=a.device)
    if n:
        _launch("batch_inverse", a.device, _field_code(spec), a.data_ptr(), out.data_ptr(),
                None if scratch is None else scratch.data_ptr(), n, int(per_lane))
    return out


def _coords(pts, nlimbs: int, what: str, shape=None):
    out = []
    for c, t in zip("xyz", pts):
        t = t.contiguous() if shape is None else t.expand(shape).contiguous()
        _check(t, nlimbs, f"{what}.{c}")
        out.append(t)
    return out


def g1_add(p, q):
    """Complete projective addition of (x, y, z) Fp coordinate tensors [12, *batch]."""
    shape = torch.broadcast_shapes(p[0].shape, q[0].shape)
    p = _coords(p, 12, "g1_add p", shape)
    q = _coords(q, 12, "g1_add q", shape)
    out = [torch.empty(shape, dtype=torch.int32, device=p[0].device) for _ in range(3)]
    n = p[0][0].numel()
    if n:
        _launch("g1_add", p[0].device, *(t.data_ptr() for t in (*p, *q, *out)), n)
    return tuple(out)


def g1_double(p):
    """Complete projective doubling of (x, y, z) Fp coordinate tensors [12, *batch]."""
    p = _coords(p, 12, "g1_double p")
    out = [torch.empty_like(p[0]) for _ in range(3)]
    n = p[0][0].numel()
    if n:
        _launch("g1_double", p[0].device, *(t.data_ptr() for t in (*p, *out)), n)
    return tuple(out)


def g1_add_mixed(p, qx, qy, qinf):
    """Complete mixed addition of projective p (x, y, z [12, *batch]) and
    affine q (x, y [12, *batch], inf bool [*batch]) -> (x, y, z)."""
    shape = torch.broadcast_shapes(p[0].shape, qx.shape)
    p = _coords(p, 12, "g1_add_mixed p", shape)
    qx, qy = (t.expand(shape).contiguous() for t in (qx, qy))
    _check(qx, 12, "g1_add_mixed qx")
    _check(qy, 12, "g1_add_mixed qy")
    qinf = qinf.expand(shape[1:]).to(torch.uint8).contiguous()
    _check(qinf, None, "g1_add_mixed qinf", torch.uint8)
    out = [torch.empty(shape, dtype=torch.int32, device=qx.device) for _ in range(3)]
    n = qx[0].numel()
    if n:
        _launch("g1_add_mixed", qx.device, *(t.data_ptr() for t in (*p, qx, qy, qinf, *out)), n)
    return tuple(out)


def g1_add_affine(ax, ay, ainf, bx, by, binf):
    """Chord addition of affine points (x, y [12, *batch], inf bool [*batch]) -> (x, y, z)."""
    shape = torch.broadcast_shapes(ax.shape, bx.shape)
    ax, ay, bx, by = (t.expand(shape).contiguous() for t in (ax, ay, bx, by))
    for t, what in ((ax, "ax"), (ay, "ay"), (bx, "bx"), (by, "by")):
        _check(t, 12, f"g1_add_affine {what}")
    ainf = ainf.expand(shape[1:]).to(torch.uint8).contiguous()
    binf = binf.expand(shape[1:]).to(torch.uint8).contiguous()
    _check(ainf, None, "g1_add_affine ainf", torch.uint8)
    _check(binf, None, "g1_add_affine binf", torch.uint8)
    out = [torch.empty(shape, dtype=torch.int32, device=ax.device) for _ in range(3)]
    n = ax[0].numel()
    if n:
        _launch("g1_add_affine", ax.device, *(t.data_ptr() for t in (ax, ay, ainf, bx, by, binf, *out)), n)
    return tuple(out)


G1_FFT_MAX_N = 512  # 8 blocks of 64 points a row: 256 threads and 136 KB of shared memory a block


def g1_fft(p, digits, neg1, neg2):
    """The DIT G1 transform of `ntt.Domain._dit_g1` over every row of p
    (x, y, z [12, B, n], natural order in and out): digits uint8
    [log n - 1, 65, n/2] and signs neg1, neg2 uint8 [log n - 1, n/2] are
    `Domain._stage_digits`. One launch for all rows and stages."""
    p = _coords(p, 12, "g1_fft p")
    shape = p[0].shape
    if any(c.shape != shape for c in p) or len(shape) != 3:
        raise ValueError(f"g1_fft: expected three [12, B, n] coordinates, got {[tuple(c.shape) for c in p]}")
    _, rows, n = shape
    log_n = n.bit_length() - 1
    if n < 2 or n != 1 << log_n or n > G1_FFT_MAX_N:
        raise ValueError(f"g1_fft: n must be a power of two in [2, {G1_FFT_MAX_N}], got {n}")
    _check(digits, None, "g1_fft digits", torch.uint8)
    _check(neg1, None, "g1_fft neg1", torch.uint8)
    _check(neg2, None, "g1_fft neg2", torch.uint8)
    signs = (log_n - 1, n // 2)
    if digits.shape != (log_n - 1, GLV_NBITS // 2, n // 2) or neg1.shape != signs or neg2.shape != signs:
        raise ValueError(
            f"g1_fft: bad digit tables {tuple(digits.shape)}, {tuple(neg1.shape)}, {tuple(neg2.shape)} for n = {n}"
        )
    if any(t.device != p[0].device for t in (digits, neg1, neg2)):
        raise ValueError("g1_fft: digit tables and points on different devices")
    out = [torch.empty_like(p[0]) for _ in range(3)]
    if rows:
        _launch("g1_fft", p[0].device, *(t.data_ptr() for t in (*p, digits, neg1, neg2, *out)), rows, log_n)
    return tuple(out)


def g1_decompress(x_std: torch.Tensor, sort_bits: torch.Tensor, inf: torch.Tensor):
    """The device half of `decompress.decompress_g1` in one launch: x_std
    [12, N] standard-form limbs, sort_bits and inf [N] (bool or 0/1) ->
    (x, y, z [12, N] Montgomery, on_curve [N] uint8, in_subgroup [N] uint8)."""
    _check(x_std, 12, "g1_decompress x_std")
    if x_std.dim() != 2:
        raise ValueError(f"g1_decompress: expected x_std [12, N], got {tuple(x_std.shape)}")
    n = x_std.shape[1]
    flags = []
    for t, what in ((sort_bits, "sort_bits"), (inf, "inf")):
        if t.shape != (n,):
            raise ValueError(f"g1_decompress: expected {what} [{n}], got {tuple(t.shape)}")
        t = t.to(torch.uint8).contiguous()
        _check(t, None, f"g1_decompress {what}", torch.uint8)
        flags.append(t)
    out = [torch.empty_like(x_std) for _ in range(3)]
    on_curve = torch.empty(n, dtype=torch.uint8, device=x_std.device)
    in_subgroup = torch.empty_like(on_curve)
    if n:
        _launch("g1_decompress", x_std.device, *(t.data_ptr() for t in (x_std, *flags, *out, on_curve, in_subgroup)), n)
    return (*out, on_curve, in_subgroup)


# post-chord points a block of the first launch sums: at most its 128
# threads (THREADS in fixed_base_msm.cu, which refuses a larger s)
_POINTS_PER_BLOCK = 128


def fixed_base_split(k: int, per_block: int = _POINTS_PER_BLOCK) -> tuple[int, int, int, int]:
    """How `fixed_base_msm` cuts a window sum of k lanes: (chord, m, s, g).

    chord: 1 if the first level pairs lane j with lane j + k/2 (k even and
    above 1), as `msm._window_sums` does; m: the points after that level;
    s: the points a block sums, min(next power of two of m, per_block); g: the
    blocks a window sum, next power of two of m over s. Block i takes the
    points j = i (mod g), identity padding past m.
    """
    chord = int(k % 2 == 0 and k > 1)
    m = k // 2 if chord else k
    mp = 1 << max(m - 1, 0).bit_length()
    s = min(mp, per_block)
    return chord, m, s, mp // s


def fixed_base_msm(table_x, table_y, base_inf, scalars, window: int, chains: int, wpc: int):
    """The whole of `msm.fixed_base_msm` in one source (two launches): table_x,
    table_y [12, *inst, chains * P, D] Montgomery Fp with D = 2^(window - 1),
    base_inf [*inst, chains * P] bool or 0/1, scalars [8, *lead, *inst, P]
    Montgomery Fr -> (x, y, z) [12, *lead, *inst]."""
    _check(table_x, 12, "fixed_base_msm table_x")
    _check(table_y, 12, "fixed_base_msm table_y")
    if table_y.shape != table_x.shape or table_x.dim() < 3:
        raise ValueError(f"fixed_base_msm: bad tables {tuple(table_x.shape)}, {tuple(table_y.shape)}")
    inst = tuple(table_x.shape[1:-2])
    cp, d = table_x.shape[-2:]
    if not 1 <= window <= 16 or d != 1 << (window - 1) or chains < 1 or cp < 1 or cp % chains or wpc < 1:
        raise ValueError(f"fixed_base_msm: bad geometry window {window}, chains {chains}, wpc {wpc}, tables {tuple(table_x.shape)}")
    n_win = SCALAR_BITS // window + 1
    if chains * wpc < n_win:
        raise ValueError(f"fixed_base_msm: {chains} chains of {wpc} windows hold fewer than {n_win} windows")
    p = cp // chains
    if tuple(base_inf.shape) != inst + (cp,):
        raise ValueError(f"fixed_base_msm: expected base_inf {inst + (cp,)}, got {tuple(base_inf.shape)}")
    inf = base_inf.to(torch.uint8).contiguous()
    _check(inf, None, "fixed_base_msm base_inf", torch.uint8)
    scalars = scalars.contiguous()
    _check(scalars, 8, "fixed_base_msm scalars")
    ni = len(inst)
    if scalars.dim() < 2 + ni or tuple(scalars.shape[scalars.dim() - 1 - ni :]) != inst + (p,):
        raise ValueError(f"fixed_base_msm: scalars {tuple(scalars.shape)} do not end in {inst + (p,)}")
    if any(t.device != table_x.device for t in (table_y, inf, scalars)):
        raise ValueError("fixed_base_msm: tables and scalars on different devices")
    batch = tuple(scalars.shape[1:-1])
    n_out = scalars[0].numel() // p
    chord, m, s, g = fixed_base_split(cp)
    if n_out * wpc * g >= 1 << 31:
        raise ValueError(f"fixed_base_msm: {n_out} output points are too many for one launch")
    out = [torch.empty((12,) + batch, dtype=torch.int32, device=scalars.device) for _ in range(3)]
    if n_out:
        partials = torch.empty(n_out * wpc * g * 36, dtype=torch.int32, device=scalars.device)
        n_inst = inf.numel() // cp
        _launch("fixed_base_msm", scalars.device, scalars.data_ptr(), table_x.data_ptr(), table_y.data_ptr(),
                inf.data_ptr(), partials.data_ptr(), *(t.data_ptr() for t in out), n_out, n_inst, p, chains,
                wpc, n_win, window, chord, m, g, s)
    return tuple(out)
