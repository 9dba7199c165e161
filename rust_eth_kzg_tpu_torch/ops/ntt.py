"""Radix-2 NTT over Fr and the G1 group FFT, on torch tensors.

`fft` evaluates a coefficient vector at the domain's roots in natural order
[f(w^0), f(w^1), ...]; `ifft` inverts it; `coset_fft` / `coset_ifft` do the
same over a coset g H; `fft_g1` / `ifft_g1` run the transform over curve
points. On CUDA tensors every scalar transform is one `ntt` kernel call
(one launch up to 1,024 points, two above: the four-step split), natural
order in and out, with the 1/n of `ifft` and the coset powers fused in as
per-point scales of its input or output. On CPU tensors it runs
`Domain._dit_plain`, the kernel's plain version: a bit reversal, then
log n stages of `field.butterfly_plain` (the textbook in-order decimation
in time), with the same scales as separate products. Every value is fully
reduced, so any schedule of the same transform gives the same limbs.
The G1 transform keeps the JAX package's schedule:
stage 0 is a plain add/sub, later stages multiply every pair's second
point by its twiddle with the GLV ladder. On CUDA tensors the whole G1
transform, every stage and ladder of every row, is one `g1_fft` kernel
launch; on CPU tensors it runs stage by stage through `curve.scalar_mul_glv`.
Both read the same digit tables (`Domain._stage_digits`).
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import GLV_NBITS, R_SCALAR, ROOT_OF_UNITY, TWO_ADICITY
from . import curve as C
from . import field as F
from . import kernels as K

FR = F.FR


def bitrev_indices(n: int) -> np.ndarray:
    bits = n.bit_length() - 1
    idx = np.arange(n)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(bits):
        rev |= ((idx >> b) & 1) << (bits - 1 - b)
    return rev


def bit_reverse_permutation(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    n = x.shape[dim]
    return torch.index_select(x, dim, torch.as_tensor(bitrev_indices(n), device=x.device))


class Domain:
    """Roots-of-unity domain of power-of-two size over Fr, with its twiddle
    tables on `device`."""

    def __init__(self, size: int, device):
        if size <= 0 or size & (size - 1):
            raise ValueError("domain size must be a power of two")
        log_size = size.bit_length() - 1
        if log_size > TWO_ADICITY:
            raise ValueError("domain larger than the field's two-adicity")
        self.size = size
        self.log_size = log_size
        self.device = torch.device(device)
        self.generator = pow(ROOT_OF_UNITY, 1 << (TWO_ADICITY - log_size), R_SCALAR)
        self.generator_inv = pow(self.generator, R_SCALAR - 2, R_SCALAR)
        self.size_inv = pow(size, R_SCALAR - 2, R_SCALAR)
        self.roots = [1] * size
        for i in range(1, size):
            self.roots[i] = self.roots[i - 1] * self.generator % R_SCALAR
        # per tag: the n powers w^k of the kernel, and the n/2 of a butterfly stage
        self._roots = {}
        self._tw = {}
        for tag, gen in (("fwd", self.generator), ("inv", self.generator_inv)):
            self._roots[tag] = self._powers(gen)
            self._tw[tag] = self._roots[tag][:, : max(size // 2, 1)].contiguous()
        self._scales = {}
        self._g1_digits = {}

    def _powers(self, gen: int, scale: int = 1) -> torch.Tensor:
        """[scale gen^0, ..., scale gen^(n-1)] in Montgomery form, [L, n] on the device."""
        pw = [scale % R_SCALAR] * self.size
        for i in range(1, self.size):
            pw[i] = pw[i - 1] * gen % R_SCALAR
        return torch.from_numpy(FR.to_mont_host(pw)).to(self.device)

    def _scale(self, key) -> torch.Tensor:
        """The per-point scales a transform fuses in, [L, n], cached: "ifft"
        (1/n at every point), ("coset", g) (g^k on the input of coset_fft)
        and ("coset_inv", g) ((1/n) g^-k on the output of coset_ifft)."""
        if key not in self._scales:
            if key == "ifft":
                self._scales[key] = self._powers(1, self.size_inv)
            elif key[0] == "coset":
                self._scales[key] = self._powers(key[1])
            else:
                self._scales[key] = self._powers(pow(key[1], R_SCALAR - 2, R_SCALAR), self.size_inv)
        return self._scales[key]

    # --- scalar transforms: x is [L, *batch, n] Montgomery limbs ---

    def _transform(self, x: torch.Tensor, tag: str, pre=None, post=None) -> torch.Tensor:
        """The DFT over w (tag "fwd") or w^-1 ("inv") of every row of x, input
        point k times pre[k] first and output point k times post[k] after:
        one `ntt` kernel call for CUDA tensors (it refuses a row of another
        size than the domain's), `_dit_plain` for CPU tensors."""
        if x.device.type == "cpu":
            return self._dit_plain(x, tag, pre, post)
        return K.ntt(x.reshape(FR.nlimbs, -1, x.shape[-1]).contiguous(), self._roots[tag], pre, post).reshape(x.shape)

    def _dit_plain(self, x: torch.Tensor, tag: str, pre=None, post=None) -> torch.Tensor:
        """The plain version of the `ntt` kernel, on any device: the scales
        as `mont_mul_plain` products, a bit reversal and log n stages of
        `butterfly_plain`."""
        shape = x.shape
        n = shape[-1]
        if n != self.size:
            raise ValueError(f"expected size {self.size}, got {n}")
        x = x.reshape(FR.nlimbs, -1, n)
        if pre is not None:
            x = F.mont_mul_plain(FR, x, pre[:, None, :])
        x = bit_reverse_permutation(x).contiguous()
        for stage in range(self.log_size):
            x = F.butterfly_plain(FR, x, self._tw[tag], stage)
        if post is not None:
            x = F.mont_mul_plain(FR, x, post[:, None, :])
        return x.reshape(shape)

    def fft(self, coeffs: torch.Tensor) -> torch.Tensor:
        """Evaluate at the domain roots (natural order)."""
        return self._transform(coeffs, "fwd")

    def ifft(self, evals: torch.Tensor) -> torch.Tensor:
        return self._transform(evals, "inv", post=self._scale("ifft"))

    def coset_fft(self, coeffs: torch.Tensor, coset_gen: int) -> torch.Tensor:
        """Evaluate over the coset g H: scale coefficient k by g^k, then FFT."""
        return self._transform(coeffs, "fwd", pre=self._scale(("coset", coset_gen)))

    def coset_ifft(self, evals: torch.Tensor, coset_gen: int) -> torch.Tensor:
        """Inverse of `coset_fft`: IFFT, then scale coefficient k by g^-k."""
        return self._transform(evals, "inv", post=self._scale(("coset_inv", coset_gen)))

    # --- G1 transforms: p is a G1 with batch shape [B, n] ---

    def _stage_digits(self, tag: str):
        """GLV digit tables of the twiddles w^(pos n / 2h) of stages 1..log n - 1:
        (digits uint8 [log n - 1, 65, n/2], neg1, neg2 uint8 [log n - 1, n/2])
        on the device, pos < h = 2^s and zero padding for pos >= h."""
        if tag not in self._g1_digits:
            gen = self.generator if tag == "fwd" else self.generator_inv
            half = max(self.size // 2, 1)
            stages = max(self.log_size - 1, 0)
            digits = np.zeros((stages, GLV_NBITS // 2, half), dtype=np.uint8)
            neg1 = np.zeros((stages, half), dtype=np.uint8)
            neg2 = np.zeros((stages, half), dtype=np.uint8)
            for s in range(1, self.log_size):
                h = 1 << s
                step = pow(gen, self.size >> (s + 1), R_SCALAR)
                d, n1, n2 = C.glv_digits_host([pow(step, pos, R_SCALAR) for pos in range(h)])
                digits[s - 1, :, :h], neg1[s - 1, :h], neg2[s - 1, :h] = d, n1, n2
            self._g1_digits[tag] = tuple(
                torch.from_numpy(a).to(self.device) for a in (digits, neg1, neg2)
            )
        return self._g1_digits[tag]

    def _dit_g1(self, p: C.G1, tag: str) -> C.G1:
        """The DIT transform of bit-reversed p: one `g1_fft` launch for CUDA
        tensors, `_dit_g1_plain` for CPU tensors."""
        if p.x.device.type == "cpu":
            return self._dit_g1_plain(p, tag)
        b, n = p.batch_shape
        if n != self.size:
            raise ValueError(f"expected size {self.size}, got {n}")
        if n == 1:
            return p
        return C.G1(*K.g1_fft(p, *self._stage_digits(tag)))

    def _dit_g1_plain(self, p: C.G1, tag: str) -> C.G1:
        """The plain version of `g1_fft` on any device: stage by stage, each
        twiddle multiplication a plain GLV ladder over the digit tables."""
        b, n = p.batch_shape
        if n != self.size:
            raise ValueError(f"expected size {self.size}, got {n}")
        p = C._map(bit_reverse_permutation, p)
        if n == 1:
            return p
        digits, neg1, neg2 = self._stage_digits(tag)
        nl = C.FP.nlimbs
        for s in range(self.log_size):
            h = 1 << s
            groups = n // (2 * h)
            v = C._map(lambda c: c.reshape(nl, b, groups, 2, h), p)
            a = C._map(lambda c: c[:, :, :, 0], v)
            t = C._map(lambda c: c[:, :, :, 1], v)
            if s > 0:
                nd = digits.shape[1]
                t = C.scalar_mul_glv(
                    t,
                    digits[s - 1, :, None, None, :h].expand(nd, b, groups, h),
                    neg1[s - 1, :h].expand(b, groups, h),
                    neg2[s - 1, :h].expand(b, groups, h),
                    plain=True,
                )
            plus = C.add_plain(a, t)
            minus = C.add_plain(a, C.neg(t))
            p = C._map(lambda cp, cm: torch.stack((cp, cm), dim=3).reshape(nl, b, n), plus, minus)
        return p

    def fft_g1(self, p: C.G1) -> C.G1:
        """Group FFT: out[i] = sum_j roots[i]^j p[j]."""
        return self._dit_g1(p, "fwd")

    def ifft_g1(self, p: C.G1, take_n: int | None = None, prescaled: bool = False) -> C.G1:
        """Inverse group FFT, optionally truncated to the first `take_n`
        outputs; with `prescaled` the final 1/n scalar multiplication is
        skipped (the caller folded 1/n into the scalars that made `p`)."""
        out = self._dit_g1(p, "inv")
        if take_n is not None:
            out = C._map(lambda c: c[..., :take_n].contiguous(), out)
        if prescaled:
            return out
        digits, n1, n2 = (torch.from_numpy(a).to(self.device) for a in C.glv_digits_host([self.size_inv]))
        batch = tuple(out.batch_shape)
        ones = (1,) * len(batch)
        return C.scalar_mul_glv(
            out,
            digits.reshape((digits.shape[0],) + ones).expand((digits.shape[0],) + batch),
            n1.reshape(ones).expand(batch),
            n2.reshape(ones).expand(batch),
        )
