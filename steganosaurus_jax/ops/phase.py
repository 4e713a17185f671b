"""Phase-domain embed/extract as one vectorized gather -> rotate -> scatter.

Replaces the reference's sequential per-bit `write_bit_on_bin` /
`read_bit_from_bin` (steganosaur.cpp:698-746) with batched device ops over the
index arrays produced by host keystream expansion. The turtle guarantees every
selected bin and its Hermitian mirror are distinct and selected at most once
(axis/Nyquist bins are rejected, visited marks both of a pair), so the two
scatters are conflict-free.
"""

from __future__ import annotations

import jax.numpy as jnp


def conj_indices(y, x, H: int, W: int):
    """Vectorized Hermitian mirror index (reference conj_idx, :370-372)."""
    cy = jnp.where(y == 0, 0, H - y) % H
    cx = jnp.where(x == 0, 0, W - x) % W
    return cy, cx


def adaptive_alpha(base_alpha, mag, median_mag, enabled: bool):
    """alpha * clamp(mag/median, 0.5, 2.0) when enabled (reference :704-710)."""
    if not enabled:
        return jnp.broadcast_to(jnp.asarray(base_alpha, mag.dtype), mag.shape)
    scale = jnp.clip(mag / jnp.maximum(1e-12, median_mag), 0.5, 2.0)
    return base_alpha * scale


WRITE_FLOOR_BMAX = 32.0  # boost clip; past this the config is hopeless anyway


def write_floor_boost(v, nv, wm, img_pixels: float, floor: float):
    """Closed-form magnitude boost b so the write survives u8 rounding.

    The spatial delta of a phase write is real(IFFT(Delta)) with Delta =
    nv - v at each written bin (+ its conjugate). The cover is integer u8,
    so wherever the summed per-pixel delta stays inside (-0.5, 0.5) the
    round() in from_planes returns the ORIGINAL pixel and the write is
    erased outright — measured at 4K with a 2.4k-bit frame: delta RMS
    0.15 px, read-back BER 0.45 (total loss; Params.write_floor has the
    numbers). Remedy: scale every moved bin's TARGET to b*nv — magnitude
    only, the phase stays exactly the decode target, so overshoot is
    impossible and partial survival degrades toward the cover phase, never
    past the target (writing v + b*(nv-v) instead would rotate the phase
    past the target on surviving bins and flip bits — rejected by
    measurement).

    b solves rho(b) = floor where rho is the mean-square spatial delta
    over all 3*H*W plane-pixels, via Parseval:
        rho(b)^2 = 2*E(b) / (3*img_pixels^2),
        E(b)     = sum_wm |b*nv - v|^2 = A b^2 - 2 C b + V,
    with A = sum|nv|^2, C = sum Re(nv conj v), V = sum|v|^2 over the moved
    bins `wm` (E is an upward parabola with minimum at b = C/A <= 1, so
    the + root is the unique crossing >= C/A). b is clipped to
    [1, WRITE_FLOOR_BMAX]: 1 whenever the write already clears the floor
    (bit-identical to the un-floored write), 32 caps the spectral spike.

    v/nv: (n,) complex. wm: (n,) bool — moved bins only (soft-valid bins
    and bucket-pad duplicates must be EXCLUDED so energy is counted once).
    img_pixels: H*W of the OUTPUT image (the gain pre-compensation and the
    PH x PW -> H x W crop cancel in the Parseval sum, so the native-image
    pixel count is the right normalizer at padded dims too). Returns a
    scalar (same real dtype as v).
    """
    real_dtype = jnp.zeros(0, v.dtype).real.dtype
    w = wm.astype(real_dtype)
    # Normalize by img_pixels BEFORE summing: raw C^2 overflows f32 at
    # large-cover magnitudes (|v| ~ 1e9 in a synthetic stress case already
    # puts C^2 past 3.4e38 -> inf - inf = nan). b is scale-invariant.
    s = jnp.asarray(1.0 / img_pixels, real_dtype)
    vr, vi = v.real * s, v.imag * s
    nr, ni = nv.real * s, nv.imag * s
    A = jnp.sum(w * (nr * nr + ni * ni))
    C = jnp.sum(w * (nr * vr + ni * vi))
    V = jnp.sum(w * (vr * vr + vi * vi))
    e_star = jnp.asarray(1.5 * floor ** 2, real_dtype)
    disc = jnp.maximum(C * C - A * (V - e_star), 0.0)
    b = (C + jnp.sqrt(disc)) / jnp.maximum(A, 1e-30)
    return jnp.clip(b, 1.0, WRITE_FLOOR_BMAX)


def embed_phases(spectrum, plane, y, x, bits, jitters, alpha, medians,
                 adaptive: bool, gain: float = 1.0,
                 hermitian_half: bool = False, soft: bool = False,
                 floor: float = 0.0, img_pixels: float = 0.0,
                 n_valid=None):
    """Write `bits` into the phases of the selected bins.

    Per bin (reference write_bit_on_bin, :712-732): keep magnitude, set phase
    to (bit ? +a : -a) + jitter where a may be magnitude-adaptive; mirror the
    conjugate bin. Self-conjugate bins cannot occur (axis/Nyquist rejected by
    the walk), so the forced-real branch (:726-731) is unreachable here.

    soft=True (rebuild-only, params.soft_write): minimal-energy write. The
    decode rule reduces to a half-plane test — bit = 1 iff
    sign(sin a)*sin(theta - jitter) >= 0 (read_phases) — with decision
    margin equal to the phase distance from the boundary {0, pi} (in the
    jitter-rotated frame). The hard write places every bin at distance
    exactly `a` from the 0-boundary; the soft write instead LEAVES bins
    whose phase already decodes with distance >= a untouched (zero delta),
    and clamps the rest to the nearest point at distance exactly `a` in
    the correct half-plane (preserving the sign of the rotated cosine).
    Every written bin therefore ends with margin >= the hard write's, at
    ~2.8x less total write energy on uniform cover phases (measured
    +3-5 dB stego PSNR at equal payload, doc/ATTACKS.md §1a). Stego pixels
    diverge from the reference's, but the bits decode identically — by the
    reference binary too (its read is the same half-plane rule).

    gain: crop retention factor (H*W)/(PH*PW). Cropping the padded IFFT back
    to H x W multiplies every written spectral delta by `gain` when the stego
    is re-FFT'd (the cover passes through unchanged — it is window-supported).
    The REFERENCE ignores this and silently fails on every non-pow2 image
    (verified: its own embed->extract at 1080p/4K returns "Magic not found").
    Writing v + (target - v)/gain pre-compensates so the measured bin reads
    exactly target; at pow2 sizes gain == 1 and this reduces bit-identically
    to the reference's magnitude-preserving write.

    hermitian_half: write only the primary bins, pre-doubled. Consumers that
    take real(IFFT(S)) — both FFT backends do — see the effective spectrum
    (S + mirror(conj(S)))/2, so writing 2*nv - v at bin k while leaving the
    stale conj(v) at its mirror yields exactly nv effective (and conj(nv) at
    the mirror). This HALVES the scatter, the full-grid embed graph's
    dominant non-FFT cost. Bit-identical in exact arithmetic to
    the mirrored write; the f64 numpy backend keeps the literal reference
    form as the parity oracle.

    spectrum: (3, PH, PW) complex. plane/y/x/bits: (nbits,) int32.
    jitters: (nbits,) float. medians: (3,) float.
    """
    H, W = spectrum.shape[-2:]
    real_dtype = jnp.zeros(0, spectrum.dtype).real.dtype
    v = spectrum[plane, y, x]
    mag = jnp.maximum(1e-12, jnp.abs(v)).astype(real_dtype)
    a = adaptive_alpha(alpha, mag, medians[plane].astype(real_dtype), adaptive)
    if soft:
        s = jnp.where(bits.astype(bool), 1.0, -1.0).astype(real_dtype)
        sigma = jnp.where(jnp.sin(a) < 0, -1.0, 1.0).astype(real_dtype)
        phi = jnp.angle(v).astype(real_dtype) - jitters.astype(real_dtype)
        valid = s * sigma * jnp.sin(phi) >= jnp.abs(jnp.sin(a))
        # nearest boundary point at distance `a` in the correct half-plane
        tgt_sin = s * sigma * jnp.abs(jnp.sin(a))
        tgt_cos = jnp.where(jnp.cos(phi) < 0, -1.0, 1.0) * jnp.abs(jnp.cos(a))
        theta = jnp.arctan2(tgt_sin, tgt_cos) + jitters.astype(real_dtype)
        moved = (mag * jnp.exp(1j * theta.astype(real_dtype))
                 ).astype(spectrum.dtype)
        nv = jnp.where(valid, v, moved)
        moved_mask = ~valid
    else:
        theta = (jnp.where(bits.astype(bool), a, -a)
                 + jitters.astype(real_dtype))
        nv = (mag * jnp.exp(1j * theta.astype(real_dtype))
              ).astype(spectrum.dtype)
        moved_mask = None
    if floor:
        # Quantization write floor (Params.write_floor; write_floor_boost).
        # Energy counts each MOVED bin once: soft-valid bins carry zero
        # delta, bucket-pad slots duplicate the last real bin (n_valid is
        # the un-padded count). The boost APPLIES to padded duplicates too
        # — they scatter the same value as their real twin, so boosting
        # only the real slot would make duplicate .set() values diverge
        # (XLA picks an arbitrary winner).
        wm = (jnp.ones(v.shape, bool) if n_valid is None
              else jnp.arange(v.shape[0]) < n_valid)
        if moved_mask is not None:
            wm = wm & moved_mask
        b = write_floor_boost(v, nv, wm, img_pixels, floor)
        boosted = (b.astype(real_dtype) * nv.real
                   + 1j * b.astype(real_dtype) * nv.imag
                   ).astype(spectrum.dtype)
        if moved_mask is not None:
            nv = jnp.where(moved_mask, boosted, nv)
        else:
            nv = boosted
    if gain != 1.0:
        nv = v + (nv - v) / jnp.asarray(gain, real_dtype)
    if hermitian_half:
        # No unique_indices promise: the batch path pads index arrays to the
        # bucket size by repeating the last walk bin, so duplicates (carrying
        # identical values) are the norm, and XLA defines duplicate scatter
        # under unique_indices=True as UB.
        return spectrum.at[plane, y, x].set(
            2.0 * nv - v, mode="promise_in_bounds")
    cy, cx = conj_indices(y, x, H, W)
    out = spectrum.at[plane, y, x].set(nv)
    out = out.at[plane, cy, cx].set(jnp.conj(nv))
    return out


def read_phases(spectrum, plane, y, x, jitters, alpha, medians, adaptive: bool):
    """Read bits back from bin phases.

    Decision (reference read_bit_from_bin, :734-746): bit = 1 iff the circular
    distance from the bin phase to (jitter + a) is <= the distance to
    (jitter - a). Since circular distance d(u,v) in [0, pi] satisfies
    cos(d) = cos(u - v) and cos is monotone decreasing on [0, pi], this is
    exactly cos(th - j - a) >= cos(th - j + a), with ties -> 1 as in the
    reference's `dpos <= dneg`.
    """
    v = spectrum[plane, y, x]
    th = jnp.angle(v)
    mag = jnp.maximum(1e-12, jnp.abs(v))
    a = adaptive_alpha(alpha, mag, medians[plane], adaptive)
    base = th - jitters
    return (jnp.cos(base - a) >= jnp.cos(base + a)).astype(jnp.uint8)


def embed_phases_qim(spectrum, plane, y, x, bits, dithers, L: int,
                     gain: float = 1.0, hermitian_half: bool = False,
                     floor: float = 0.0, img_pixels: float = 0.0,
                     n_valid=None):
    """Dithered phase-QIM write (Params.qim; pipeline/qim.py).

    Per bin: keep magnitude, set phase to the nearest point of the keyed
    lattice coset for `bits` — theta' = d + (round((theta-d)/Delta - b/2)
    + b/2) * Delta with Delta = 2*pi/L. Conjugate mirroring, `gain`
    pre-compensation, and the Hermitian-half pre-doubled scatter follow
    embed_phases exactly (same consumers). Payload-only: callers write the
    header with embed_phases.
    """
    H, W = spectrum.shape[-2:]
    real_dtype = jnp.zeros(0, spectrum.dtype).real.dtype
    v = spectrum[plane, y, x]
    mag = jnp.maximum(1e-12, jnp.abs(v)).astype(real_dtype)
    d = dithers.astype(real_dtype)
    delta = jnp.asarray(2.0 * jnp.pi / L, real_dtype)
    half_b = bits.astype(real_dtype) * 0.5
    q = (jnp.angle(v).astype(real_dtype) - d) / delta - half_b
    theta = d + (jnp.round(q) + half_b) * delta
    nv = (mag * jnp.exp(1j * theta.astype(real_dtype))).astype(spectrum.dtype)
    if floor:
        # Quantization write floor — see embed_phases / write_floor_boost.
        wm = (jnp.ones(v.shape, bool) if n_valid is None
              else jnp.arange(v.shape[0]) < n_valid)
        b = write_floor_boost(v, nv, wm, img_pixels, floor
                              ).astype(real_dtype)
        nv = (b * nv.real + 1j * b * nv.imag).astype(spectrum.dtype)
    if gain != 1.0:
        nv = v + (nv - v) / jnp.asarray(gain, real_dtype)
    if hermitian_half:
        return spectrum.at[plane, y, x].set(
            2.0 * nv - v, mode="promise_in_bounds")
    cy, cx = conj_indices(y, x, H, W)
    out = spectrum.at[plane, y, x].set(nv)
    out = out.at[plane, cy, cx].set(jnp.conj(nv))
    return out


def read_values_qim(spectrum, plane, y, x, dithers, L: int):
    """Per-bin QIM DECISION VALUES d = -cos(L*(theta - dither)) * mag.

    cos(L*(theta-d)) is +1 exactly at bit-0 centroids and -1 at bit-1
    centroids (pipeline/qim.py), so sign(d) is the nearest-coset decode and
    |d| scales with both the coset confidence and the bin magnitude — the
    matched-filter weight for ops.ecc.rep_decode_soft, mirroring
    read_values' mag * sin(...) weighting on the hard path."""
    v = spectrum[plane, y, x]
    real_dtype = jnp.zeros(0, spectrum.dtype).real.dtype
    mag = jnp.maximum(1e-12, jnp.abs(v)).astype(real_dtype)
    th = jnp.angle(v).astype(real_dtype)
    return -jnp.cos(L * (th - dithers.astype(real_dtype))) * mag


def read_phases_qim(spectrum, plane, y, x, dithers, L: int):
    """QIM nearest-coset bit read: bit = 1 iff -cos(L*(theta - d)) >= 0
    (ties -> 1, matching the hard read's tie rule)."""
    return (read_values_qim(spectrum, plane, y, x, dithers, L) >= 0).astype(
        jnp.uint8)


def _coherent_common(spectrum, y, x):
    """Gather all three planes at the (y, x) sites and compute the
    common-mode phase: the angle of the unweighted phasor resultant
    S = sum_c v_c/|v_c| over planes c (rebuild-only; Params.coherent).

    The coherent write rotates all three planes by ONE delta, which moves
    angle(S) by exactly that delta while preserving every pairwise phase
    difference th_a - th_b — the statistic the cross-channel warden keys
    on (utils/steganalysis.cross_channel_report; doc/ATTACKS.md §2e). The
    unweighted resultant (not magnitude-weighted) is the decode anchor:
    both sides recompute it identically, and |S| doubles as the per-site
    decision confidence (3 on channel-correlated covers — exactly where
    the mode matters — Rayleigh-distributed ~1.6 mean on iid covers).

    Returns (v3 (3, n) complex, mag3 (3, n) real, S (n,) complex,
    theta (n,) real).
    """
    real_dtype = jnp.zeros(0, spectrum.dtype).real.dtype
    v3 = spectrum[:, y, x]
    mag3 = jnp.maximum(1e-12, jnp.abs(v3)).astype(real_dtype)
    u = v3 / mag3
    S = jnp.sum(u, axis=0)
    theta = jnp.angle(S).astype(real_dtype)
    return v3, mag3, S, theta


def _coherent_finish(spectrum, y, x, v3, nv3, moved_sites, gain: float,
                     hermitian_half: bool, floor: float, img_pixels: float,
                     n_valid):
    """Shared coherent-write tail: write-floor boost (energy over all three
    planes of each moved site), gain pre-compensation, all-plane scatter
    with conjugate mirroring. moved_sites: (n,) bool site mask or None
    (hard write: every valid site moves)."""
    H, W = spectrum.shape[-2:]
    real_dtype = jnp.zeros(0, spectrum.dtype).real.dtype
    if floor:
        wm = (jnp.ones(y.shape, bool) if n_valid is None
              else jnp.arange(y.shape[0]) < n_valid)
        if moved_sites is not None:
            wm = wm & moved_sites
        wm3 = jnp.broadcast_to(wm[None, :], v3.shape).reshape(-1)
        b = write_floor_boost(v3.reshape(-1), nv3.reshape(-1), wm3,
                              img_pixels, floor).astype(real_dtype)
        boosted = (b * nv3.real + 1j * b * nv3.imag).astype(spectrum.dtype)
        if moved_sites is not None:
            nv3 = jnp.where(moved_sites[None, :], boosted, nv3)
        else:
            nv3 = boosted
    if gain != 1.0:
        nv3 = v3 + (nv3 - v3) / jnp.asarray(gain, real_dtype)
    if hermitian_half:
        return spectrum.at[:, y, x].set(2.0 * nv3 - v3,
                                        mode="promise_in_bounds")
    cy, cx = conj_indices(y, x, H, W)
    out = spectrum.at[:, y, x].set(nv3)
    out = out.at[:, cy, cx].set(jnp.conj(nv3))
    return out


def embed_phases_coherent(spectrum, y, x, bits, jitters, alpha,
                          gain: float = 1.0, hermitian_half: bool = False,
                          soft: bool = False, floor: float = 0.0,
                          img_pixels: float = 0.0, n_valid=None):
    """Channel-coherent phase write (rebuild-only; Params.coherent).

    Per site: rotate ALL THREE planes' bins at (y, x) by one common delta
    so the common-mode phase (angle of the unweighted phasor resultant,
    _coherent_common) lands on the hard-write target (bit ? +a : -a) +
    jitter. Magnitudes are untouched and every pairwise phase difference
    is preserved EXACTLY, so the cross-channel warden's alignment and
    conditional-misalignment statistics see the cover's own values at
    written sites (measured: doc/ATTACKS.md §2e). Cost: three planes move
    per bit (~3x write energy at equal payload) and a site is consumed
    whole by the walk (~3x fewer payload sites; keystream coherent
    semantics).

    soft=True composes like embed_phases: sites whose common mode already
    decodes with margin >= a are left untouched (zero delta), the rest
    clamp to the nearest boundary point at distance exactly `a`.

    y/x/bits: (n,) int32. jitters: (n,) float. alpha: scalar or (n,)
    (alpha_spread). Payload-only: callers write the header with
    embed_phases (the header must decode before any mode is known).
    """
    real_dtype = jnp.zeros(0, spectrum.dtype).real.dtype
    v3, _mag3, _S, theta = _coherent_common(spectrum, y, x)
    a = jnp.broadcast_to(jnp.asarray(alpha, real_dtype), theta.shape)
    j = jitters.astype(real_dtype)
    if soft:
        s = jnp.where(bits.astype(bool), 1.0, -1.0).astype(real_dtype)
        sigma = jnp.where(jnp.sin(a) < 0, -1.0, 1.0).astype(real_dtype)
        phi = theta - j
        valid = s * sigma * jnp.sin(phi) >= jnp.abs(jnp.sin(a))
        tgt_sin = s * sigma * jnp.abs(jnp.sin(a))
        tgt_cos = jnp.where(jnp.cos(phi) < 0, -1.0, 1.0) * jnp.abs(
            jnp.cos(a))
        tgt = jnp.arctan2(tgt_sin, tgt_cos) + j
        delta = jnp.where(valid, 0.0, tgt - theta)
        moved_sites = ~valid
    else:
        tgt = jnp.where(bits.astype(bool), a, -a) + j
        delta = tgt - theta
        moved_sites = None
    rot = jnp.exp(1j * delta.astype(real_dtype))[None, :]
    nv3 = (v3 * rot).astype(spectrum.dtype)
    return _coherent_finish(spectrum, y, x, v3, nv3, moved_sites, gain,
                            hermitian_half, floor, img_pixels, n_valid)


def embed_phases_coherent_qim(spectrum, y, x, bits, dithers, L: int,
                              gain: float = 1.0,
                              hermitian_half: bool = False,
                              floor: float = 0.0, img_pixels: float = 0.0,
                              n_valid=None):
    """Coherent + QIM composition: the common-mode phase is quantized to
    the keyed dithered lattice (embed_phases_qim's rule applied to
    angle(S)), then all three planes rotate by the common delta. Pairwise
    differences preserved exactly, written-site common modes marginally
    uniform (the QIM stealth property, doc/ATTACKS.md §2b)."""
    real_dtype = jnp.zeros(0, spectrum.dtype).real.dtype
    v3, _mag3, _S, theta = _coherent_common(spectrum, y, x)
    d = dithers.astype(real_dtype)
    delta_l = jnp.asarray(2.0 * jnp.pi / L, real_dtype)
    half_b = bits.astype(real_dtype) * 0.5
    q = (theta - d) / delta_l - half_b
    tgt = d + (jnp.round(q) + half_b) * delta_l
    rot = jnp.exp(1j * (tgt - theta).astype(real_dtype))[None, :]
    nv3 = (v3 * rot).astype(spectrum.dtype)
    return _coherent_finish(spectrum, y, x, v3, nv3, None, gain,
                            hermitian_half, floor, img_pixels, n_valid)


def read_values_coherent(spectrum, y, x, jitters, alpha):
    """Coherent DECISION VALUES d = w * sin(theta - jitter) * sign(sin a)
    on the common-mode phase theta = angle(S). Weight w = |S| * mean mag:
    |S| is the phasor-resultant coherence of the three planes (the angle's
    conditioning) and the mean magnitude scales the quantization-noise SNR
    exactly as in read_values — the matched-filter weight for
    ops.ecc.rep_decode_soft."""
    real_dtype = jnp.zeros(0, spectrum.dtype).real.dtype
    _v3, mag3, S, theta = _coherent_common(spectrum, y, x)
    a = jnp.asarray(alpha, real_dtype)
    w = jnp.abs(S).astype(real_dtype) * jnp.mean(mag3, axis=0)
    base = theta - jitters.astype(real_dtype)
    return w * jnp.sin(base) * jnp.sign(jnp.sin(a))


def read_phases_coherent(spectrum, y, x, jitters, alpha):
    """Coherent bit read: the hard half-plane rule on the common-mode
    phase (ties -> 1, matching read_phases)."""
    return (read_values_coherent(spectrum, y, x, jitters, alpha) >= 0
            ).astype(jnp.uint8)


def read_values_coherent_qim(spectrum, y, x, dithers, L: int):
    """Coherent QIM decision values: -cos(L*(theta - d)) * w on the
    common-mode phase (read_values_qim's rule; weight as
    read_values_coherent)."""
    real_dtype = jnp.zeros(0, spectrum.dtype).real.dtype
    _v3, mag3, S, theta = _coherent_common(spectrum, y, x)
    w = jnp.abs(S).astype(real_dtype) * jnp.mean(mag3, axis=0)
    return -jnp.cos(L * (theta - dithers.astype(real_dtype))) * w


def read_phases_coherent_qim(spectrum, y, x, dithers, L: int):
    """Coherent QIM nearest-coset read (ties -> 1)."""
    return (read_values_coherent_qim(spectrum, y, x, dithers, L) >= 0
            ).astype(jnp.uint8)


def read_values(spectrum, plane, y, x, jitters, alpha, medians, adaptive: bool):
    """Per-bin DECISION VALUES d = mag * sin(theta - jitter) * sign(sin a).

    sign(d) reproduces read_phases exactly (the circular-distance rule
    reduces to this half-plane test — see read_phases), and |d| is the
    bin's decision confidence: under ~constant-absolute quantization noise
    per bin, d's SNR scales with magnitude. Soft-decision repetition decode
    (ops.ecc.rep_decode_soft) sums these across each bit's copies — the
    matched-filter combiner used by the extraction recovery fallback."""
    v = spectrum[plane, y, x]
    th = jnp.angle(v)
    mag = jnp.maximum(1e-12, jnp.abs(v))
    a = adaptive_alpha(alpha, mag, medians[plane], adaptive)
    real_dtype = jnp.zeros(0, spectrum.dtype).real.dtype
    base = th - jitters.astype(real_dtype)
    return mag * jnp.sin(base) * jnp.sign(jnp.sin(a))
