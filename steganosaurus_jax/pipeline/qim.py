"""Dithered phase QIM for payload bits (Params.qim).

Rebuild-only embedding mode (the reference's own doc/TODO.md lists
"quantization index modulation (QIM/STDM)" as future work). With level
L >= 2 and step Delta = 2*pi/L, payload bit b at walk slot i is embedded by
quantizing the bin's phase onto the keyed-dithered lattice

    theta' = d_i + (k + b/2) * Delta,   k = round((theta - d_i)/Delta - b/2),

with dither d_i uniform in [0, Delta) drawn from a KS keystream keyed by
crypto.derive_qim_key(path_key) — independent of the walk/plane keystreams,
so the turtle replay stays byte-exact vs the reference. Decoding is the
nearest-coset rule, closed form (no lattice search):

    bit = 1  iff  cos(L * (theta - d_i)) <= 0,

because cos(L*(theta-d)) is +1 exactly at bit-0 centroids and -1 at bit-1
centroids; the matched soft-decision value is -cos(L*(theta-d)) * mag
(ops/ecc.rep_decode_soft combining, same magnitude weighting as the hard
path's read_values).

Why this mode exists (measured numbers in doc/ATTACKS.md §1b/§2b):
- energy: the within-coset quantization error is uniform in
  [-Delta/2, Delta/2), so E[dtheta^2] = Delta^2/12 — ~9x below the hard
  write's uniform-to-fixed-point E = pi^2/3 at L=3, and ~3x below the soft
  write; larger L shrinks it further. This is the payload/PSNR frontier
  lever past the soft write's measured ceiling.
- margin: the decision boundary sits Delta/4 = pi/(2L) from every centroid
  (L=3 ~ 0.524 rad ~ the hard write's default alpha=0.5), a symmetric
  margin the hard/soft writes only reach one-sided.
- stealth: d_i uniform over a full dither period makes the written bin's
  phase marginally UNIFORM on the circle to anyone without the key — no
  +-alpha spike (hard write), no boundary notch (soft write).

Scope: payload bits ONLY. The 38-byte header stays on the reference's hard
+-alpha write — it must decode before any mode is known — and carries L in
FLAGS bits 4-7 (pipeline/header.py), so extraction auto-detects QIM with no
parameter. The stock reference binary fails closed on QIM stegos (its
half-plane payload read returns garbage -> AEAD failure), exactly like the
per-image-walk flag.
"""

from __future__ import annotations

import math

import numpy as np

from steganosaurus_jax import crypto, keystream
from steganosaurus_jax.config import Params
from steganosaurus_jax.pipeline.errors import StegoError


def validate(params: Params) -> None:
    """Reject invalid or unsupported QIM parameter combinations."""
    L = params.qim
    if L == 0:
        return
    if not 2 <= L <= 15:
        raise StegoError(f"qim level must be 0 or 2..15, got {L}")
    if params.adaptive_alpha:
        raise StegoError("qim and adaptive_alpha are mutually exclusive "
                         "(QIM replaces the payload write rule)")
    if params.cover_dependent_path:
        raise StegoError("qim is not supported with cover_dependent_path")


def dither_angles(path_key: bytes, L: int, nbits: int) -> np.ndarray:
    """(nbits,) f32 keyed dither angles d_i in [0, Delta), Delta = 2*pi/L.

    Indexed by FRAME SLOT (header slots' draws exist but are unused — the
    header is never QIM-written), so the batch statics and per-image-walk
    paths all share one slot-aligned array."""
    u = keystream.signed_unit_offsets(crypto.derive_qim_key(path_key), nbits)
    delta = 2.0 * math.pi / L
    return ((u.astype(np.float64) + 1.0) * 0.5 * delta).astype(np.float32)
