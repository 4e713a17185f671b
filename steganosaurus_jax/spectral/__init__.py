"""Spectral engine: plane conversion, pow2 padding, 2D FFT, medians, cover hash.

The reference's iterative radix-2 `complex<double>` FFT (steganosaur.cpp:
340-366) becomes `jnp.fft.fft2` over batched planes: complex64 on the
device (cuFFT on the GPU), with a complex128 path for CPU parity
arbitration.

Precision note (SURVEY.md §7 hard parts): parity is required on *payload
bits*, not spectra. complex64 phase error (~1e-6 rad) is negligible against
the alpha=0.5 rad decision margin and Rep-7's 43% BER budget; tests prove it
per config.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np


def next_pow2(v: int) -> int:
    """Smallest power of two >= v (reference next_pow2, steganosaur.cpp:369)."""
    p = 1
    while p < v:
        p <<= 1
    return p


def fft_dims(H: int, W: int) -> tuple[int, int]:
    """Spectral grid dims for an H x W image: the NATIVE size, no padding.

    The reference pads to next_pow2 (steganosaur.cpp:393-398) because its
    radix-2 FFT requires it — and that padding is a LATENT BUG: cropping the
    padded IFFT back to H x W attenuates and cross-couples the written phase
    deltas (the rect window's Dirichlet kernel leaks up to ~47% of a delta
    into walk-adjacent bins at 1080p aspect ratios), so the reference's own
    embed->extract fails with "Magic not found" on every non-pow2 image
    (verified empirically at 1080p and 4K, both noise and natural covers; its
    README capacity claims for those sizes are theoretical only).

    jnp.fft (and the corner engine's pruned DFT matmuls) work at ANY size —
    so the transform runs at the native resolution: no crop, no
    attenuation, exact round-trip, and strictly less compute (4K native is
    2160x3840 = 40% fewer bins than the padded 4096^2). For pow2 images the
    grid equals the reference's padded grid, preserving bit-exact
    cross-interop; non-pow2 interop does not exist to preserve.
    """
    return H, W


def to_planes(img_u8: np.ndarray) -> np.ndarray:
    """(H, W, 3) u8 interleaved -> (3, H, W) float64 planes (reference :383-386)."""
    assert img_u8.ndim == 3 and img_u8.shape[2] == 3, img_u8.shape
    return np.ascontiguousarray(img_u8.transpose(2, 0, 1)).astype(np.float64)


def from_planes(planes) -> np.ndarray:
    """(3, H, W) float -> (H, W, 3) u8 with round-half-away-from-zero + clamp.

    The reference uses C `round` (half away from zero) then clamps to [0,255]
    (:387-391). `jnp.round` is banker's rounding — for the non-negative branch
    that survives the clamp, floor(v + 0.5) is exactly half-away-from-zero,
    and every v < 0.5 clamps/rounds to 0 under both schemes.
    """
    xp = jnp if isinstance(planes, jnp.ndarray) else np
    q = xp.clip(xp.floor(planes + 0.5), 0.0, 255.0).astype(xp.uint8)
    moved = xp.transpose(q, (1, 2, 0))
    return moved if xp is jnp else np.ascontiguousarray(moved)


def apply_center(planes, on: bool):
    """Optional (-1)^(x+y) spectrum centering (reference apply_center, :392)."""
    if not on:
        return planes
    xp = jnp if isinstance(planes, jnp.ndarray) else np
    H, W = planes.shape[-2:]
    yy = xp.arange(H)[:, None]
    xx = xp.arange(W)[None, :]
    sign = xp.where((yy + xx) % 2 == 1, -1.0, 1.0)
    return planes * sign


def pad_planes(planes, PH: int, PW: int):
    """Zero-pad (…, H, W) real planes into (…, PH, PW) (reference pad_to_fft :393-398)."""
    xp = jnp if isinstance(planes, jnp.ndarray) else np
    H, W = planes.shape[-2:]
    pad = [(0, 0)] * (planes.ndim - 2) + [(0, PH - H), (0, PW - W)]
    return xp.pad(planes, pad)


def fft2(planes, dtype=jnp.complex64):
    """Forward 2D FFT over the last two axes — REFERENCE SIGN CONVENTION.

    The reference's radix-2 kernel uses w = e^{+2*pi*i/len} for the FORWARD
    transform (steganosaur.cpp:347: `ang = 2*M_PI/len * (inverse?-1:1)`),
    which is the CONJUGATE of the numpy/XLA forward convention. Phases are
    therefore negated relative to jnp.fft.fft2; for the real-valued inputs in
    this pipeline, conj(fft2(x)) reproduces the reference spectrum exactly.
    """
    out = jnp.fft.fft2(jnp.asarray(planes).astype(_real_of(dtype))).astype(dtype)
    return jnp.conj(out)


def ifft2_real(spectrum):
    """Inverse 2D FFT (reference convention), real part.

    Reference inverse (steganosaur.cpp:347,357) sums F * e^{-2*pi*i...} / N =
    conj(ifft_np(conj(F))); the real part equals real(ifft_np(conj(F))).
    """
    return jnp.fft.ifft2(jnp.conj(spectrum)).real


def _real_of(cdtype):
    return jnp.float64 if jnp.dtype(cdtype) == jnp.complex128 else jnp.float32


def median_abs(spectrum):
    """Upper median of |F| over each plane (reference median_abs, :404-409).

    The reference takes nth_element at index n/2 of n = PH*PW magnitudes —
    the (n/2)-th order statistic (upper median for even n). Computed exactly
    via bit-pattern bisection (ops.stats) — no sort.
    """
    from steganosaurus_jax.ops import stats

    mags = jnp.abs(spectrum).reshape(spectrum.shape[0], -1)
    return stats.median_upper(mags)


def cover_hash_features(spectrum) -> jnp.ndarray:
    """Quantized low-frequency magnitudes for the cover hash.

    Per plane: the region x region top-left (low-frequency) square of |F|,
    quantized q = clamp(floor(log(1+mag)/2), 0, 7), region = min(8,
    min(PH,PW)//8) (reference compute_cover_hash, steganosaur.cpp:415-444).
    Returns (3, region, region) uint8; the host SHA-256 hashes R||G||B bytes.
    """
    PH, PW = spectrum.shape[-2:]
    region = min(8, min(PH, PW) // 8)
    mags = jnp.abs(spectrum[..., :region, :region])
    q = jnp.clip(jnp.floor(jnp.log1p(mags) / 2.0), 0.0, 7.0)
    return q.astype(jnp.uint8)
