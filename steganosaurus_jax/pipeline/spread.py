"""Keyed per-bin randomized write amplitude (Params.alpha_spread).

Rebuild-only stealth feature (the reference's own doc/TODO.md lists
"per-bin randomized alpha" as future work): bin i is written at

    alpha_i = alpha * (1 + alpha_spread * v_i),   v_i in [0, 1)

with v_i drawn from a KS keystream keyed by
crypto.derive_alpha_spread_key(path_key) — independent of the walk/plane
keystreams, so the turtle replay stays byte-exact vs the reference.

The spread is deliberately ONE-SIDED (upward): the decode margin of a
written bin is its phase distance to the half-plane boundary, i.e. exactly
alpha_i, so alpha_i >= alpha keeps every bin's margin at least the hard
write's. (A symmetric spread was measured to flip weak-magnitude header
bins: at alpha_i = 0.25 the u8-quantization phase noise on
low-|v| bins of a 256x256 cover reaches the boundary, two flips in one
Rep-3 group corrupt the salt, and the AEAD chain fails. One-sided spread
keeps BER identical-or-better vs the reference write by construction.)

Why this is free at extraction time: the decode rule is a half-plane test
(ops/phase.read_phases / spectral/corner.read_bits_dense) — bit = 1 iff
sign(sin alpha) * sin(theta - jitter) >= 0 — which uses only the SIGN of
sin(alpha), never its magnitude. Any written amplitude alpha_i with
sin(alpha_i) of the same sign decodes identically, by this framework AND by
the stock reference binary (steganosaur.cpp:734-746 computes circular
distances to +-alpha, equivalent to the same half-plane test). So the
extractor needs no knowledge of the spread, and the embedded phase residuals
spread over [alpha(1-s), alpha(1+s)] instead of concentrating at +-alpha
(doc/ATTACKS.md §3a quantifies the histogram effect).
"""

from __future__ import annotations

import math

import numpy as np

from steganosaurus_jax import crypto, keystream
from steganosaurus_jax.config import Params
from steganosaurus_jax.pipeline.errors import StegoError


def validate(params: Params) -> None:
    """Reject spreads that could flip sign(sin(alpha_i)) vs sign(sin(alpha)).

    Decode correctness needs every alpha_i in the same sin-sign band as the
    base alpha; with the one-sided upward spread and the standard
    0 < alpha < pi band that means alpha(1+s) < pi (the lower edge is alpha
    itself).
    """
    s = params.alpha_spread
    if s == 0.0:
        return
    if s < 0.0:
        raise StegoError(f"alpha_spread must be >= 0, got {s}")
    a = params.alpha
    if not 0.0 < a * (1.0 + s) < math.pi:
        raise StegoError(
            f"alpha_spread={s} with alpha={a} leaves the (0, pi) sin-sign "
            f"band: need 0 < alpha and alpha*(1+s) < pi"
        )


def spread_alphas(path_key: bytes, params: Params,
                  nbits: int) -> np.ndarray | None:
    """(nbits,) f32 per-bit write amplitudes in [alpha, alpha(1+s)), or None
    when spread is off."""
    if params.alpha_spread == 0.0:
        return None
    validate(params)
    u = keystream.signed_unit_offsets(
        crypto.derive_alpha_spread_key(path_key), nbits)
    v = (u + 1.0) * 0.5  # [0, 1)
    return (params.alpha * (1.0 + params.alpha_spread * v)).astype(np.float32)
