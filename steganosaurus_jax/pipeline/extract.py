"""Extract pipeline (reference do_extract, steganosaur.cpp:1112-1312).

Two device dispatches with a host round-trip in between (clen is
data-dependent, SURVEY.md §7): read the 38-byte Rep-3 header first, parse
salt/nonce/clen, then read the Rep-7 payload. The walk key is deliberately
salt-independent — SHA256(pass|master) — which is what makes the header
locatable before the salt is known (reference rationale comment :1134-1143).

Wrong-passphrase behavior matches the reference: the walk diverges, the header
magic check fails FAST (before any PBKDF2); a correct walk with a corrupted
payload fails AEAD auth after the KDF (doc/HARDENING.md:425-428).
"""

from __future__ import annotations

import numpy as np

from steganosaurus_jax import crypto, keystream, spectral
from steganosaurus_jax.config import Params
from steganosaurus_jax.io import image as image_io
from steganosaurus_jax.ops import bits as bit_ops
from steganosaurus_jax.ops import ecc
from steganosaurus_jax.ops import rs as rs_mod
from steganosaurus_jax.pipeline import device
from steganosaurus_jax.pipeline import qim as qim_mod
from steganosaurus_jax.pipeline.errors import StegoError
from steganosaurus_jax.pipeline import header as header_mod
from steganosaurus_jax.pipeline.header import Header
from steganosaurus_jax.utils import debug

_HEADER_STREAM_BITS = header_mod.FIXED_LEN * 8 * 3  # 38*8 under Rep-3 = 912


def extract_array(
    img: np.ndarray,
    password: str | None = None,
    master_key: bytes | None = None,
    params: Params = Params(),
) -> bytes:
    """Extract and authenticate the secret from a stego image."""
    if (password is None) == (master_key is None):
        raise ValueError("exactly one of password/master_key required")

    backend = device.get_backend(params)
    planes = spectral.to_planes(img)
    H, W = img.shape[:2]
    PH, PW = spectral.fft_dims(H, W)

    # lazy: skip the capacity/feature host pulls — extraction never uses
    # capacity, and each pull waits for the whole analyze graph.
    spec, med, _capacity, feat = backend.analyze(planes, params, lazy=True)

    # Path key from the *stego* planes (cover-dependent mode hashes the stego
    # spectrum — the coarse quantization is what makes that mostly stable;
    # reference :1156-1176).
    cover_hash = None
    if params.cover_dependent_path:
        feat = np.asarray(feat).astype(np.uint8)  # pull only when needed
        cover_hash = crypto.sha256(feat.tobytes())
    path_key = crypto.derive_path_key(password, master_key, cover_hash)
    key_walk, key_r, key_g, key_b = crypto.derive_turtle_keys(path_key)
    plane_keys = (key_r, key_g, key_b)

    # --- pass 1: header (38 bytes under Rep-3), two-rule trial ---
    # The header rides the standard shared walk for every wire mode except
    # coherent, whose header takes the coherent walk + common-mode write
    # (its 912 single-plane writes alone would hand the cross-channel
    # warden AUC 1.0 — doc/ATTACKS.md §2e). Rule 1 (standard) first; on
    # magic failure, rule 2 (coherent). Both trials are device reads that
    # run BEFORE any KDF, so the wrong-passphrase fast-fail property is
    # preserved (reference rationale :1134-1143; doc/HARDENING.md).
    def _read_header(coh: bool) -> bytes:
        if coh:
            _hp, hy, hx, hj, _vis = keystream.header_walk_with_visited(
                key_walk, plane_keys, PH, PW, params.rmin, params.rmax,
                params.density, params.jitter, _HEADER_STREAM_BITS,
                coherent=True)
            # Soft decode, not hard: the common-mode resultant of three
            # independent cover phasors can nearly cancel at a site
            # (|Σ m_c e^{iθ_c}| ≈ 0), where u8-quantization noise flips
            # the hard bit — measured ~2% raw BER, which Rep-3 majority
            # cannot absorb over 304 header bits. Magnitude-weighted
            # rep_decode_soft gives the near-cancelled sites ~zero weight
            # and the header decodes from the strong ones.
            hvals = backend.read_values_coherent(spec, (hy, hx), hj,
                                                 params.alpha)
            return bit_ops.bytes_from_bits(
                np.asarray(ecc.rep_decode_soft(hvals, 3)))
        else:
            idx_p, idx_y, idx_x, jit = keystream.turtle_expand(
                key_walk, plane_keys, PH, PW,
                params.rmin, params.rmax, params.density, params.jitter,
                _HEADER_STREAM_BITS,
            )
            if debug.enabled():  # reference -DDEBUG=1 (steganosaur.cpp:1211-)
                debug.dump_dims("extract", H, W, PH, PW)
                debug.dump_key_prefix("extract path_key", path_key)
                debug.dump_walk("extract", idx_p, idx_y, idx_x)
            stream = backend.read_bits(
                spec, med, (idx_p, idx_y, idx_x), jit, params.alpha, params)
        return bit_ops.bytes_from_bits(np.asarray(ecc.rep3_decode(stream)))

    hdr_coh = False
    hdr_bytes = _read_header(False)
    if hdr_bytes[:4] != header_mod.MAGIC:
        hdr_coh = True
        hdr_bytes = _read_header(True)
        if hdr_bytes[:4] != header_mod.MAGIC:
            raise StegoError("Magic not found.")
    debug.dump_header("extract header", hdr_bytes)
    if hdr_bytes[4] != header_mod.VERSION:
        raise StegoError(f"Unsupported version ({hdr_bytes[4]}).")
    hdr = Header.from_bytes(hdr_bytes)

    # --- pass 2: payload ((clen+16) bytes under Rep-7) ---
    # Walk-capacity bound: each accepted bit marks a bin + its conjugate, so
    # no image carries more than 3*PH*PW/2 bits. A corrupted clen (u32 up to
    # 4G) must degrade to "Payload truncated", not allocate 100s of GB of
    # index arrays (the batch path applies the same bound, pipeline/batch.py
    # _ExtractJob._cap_bits).
    cap_bits = 3 * PH * PW // 2
    # Payload FEC auto-detect (FLAGS bit 0x02, ops/rs.py): interleaved
    # RS(255,223) coded bytes, or the reference's Rep-7 stream.
    rs_on = bool(hdr.flags & header_mod.FLAG_RS_PAYLOAD)
    want_bits = (rs_mod.coded_len(hdr.clen + 16) * 8 if rs_on
                 else (hdr.clen + 16) * 8 * 7)
    payload_stream_bits = min(want_bits, cap_bits)
    total_bits = _HEADER_STREAM_BITS + payload_stream_bits
    # QIM auto-detect (FLAGS bits 4-7, pipeline/qim.py): the payload was
    # written by dithered phase QIM at level L; params.qim is embed-side
    # only. L == 1 is not a valid level — treat as corruption.
    L = header_mod.qim_levels(hdr.flags)
    if L == 1:
        raise StegoError("Corrupt header (invalid QIM level).")

    coherent = bool(hdr.flags & header_mod.FLAG_COHERENT)

    def read_payload(idx_pyx, jit_arr, skip):
        """Payload stream read under the header-selected rule. `skip` is
        the first payload slot's frame-slot index (dither alignment)."""
        if coherent:
            # Common-mode read over all three planes at each site
            # (FLAG_COHERENT; ops/phase.py read_phases_coherent[_qim]).
            yx = idx_pyx[1:]
            if L:
                d = qim_mod.dither_angles(path_key, L, skip + len(jit_arr))
                return backend.read_bits_coherent_qim(spec, yx, d[skip:], L)
            return backend.read_bits_coherent(spec, yx, jit_arr,
                                              params.alpha)
        if L:
            d = qim_mod.dither_angles(path_key, L, skip + len(jit_arr))
            return backend.read_bits_qim(spec, idx_pyx, d[skip:], L)
        return backend.read_bits(spec, med, idx_pyx, jit_arr, params.alpha,
                                 params)

    if (hdr.flags & header_mod.FLAG_PER_IMAGE_WALK) or coherent:
        # Auto-detected from the header: the payload walk is salt-keyed and
        # resumes from the header walk's visited state (embed side:
        # pipeline/embed.py; params.per_image_walk is embed-side only).
        # Coherent stegos always ride this chained walk, with the coherent
        # site semantics (keystream/_pure.py). The visited state comes
        # from the header rule that actually matched (hdr_coh), so both
        # the current layout (coherent header) and the pre-trial layout
        # (standard header + coherent payload) resolve.
        *_, vis = keystream.header_walk_with_visited(
            key_walk, plane_keys, PH, PW, params.rmin, params.rmax,
            params.density, params.jitter, _HEADER_STREAM_BITS,
            coherent=hdr_coh)
        skeys = crypto.derive_turtle_keys(
            crypto.derive_salt_path_key(path_key, hdr.salt))
        # allow_short: a corrupted clen must degrade to garbage trailing
        # bits (AEAD rejects), never hang or abort (doc/TESTING.md:151-156)
        pp, py, px, pj, _n = keystream.turtle_expand_chained(
            skeys[0], skeys[1:], PH, PW, params.rmin, params.rmax,
            params.density, params.jitter, payload_stream_bits, vis,
            allow_short=True, coherent=coherent)
        payload_stream = read_payload((pp, py, px), pj, _HEADER_STREAM_BITS)
    else:
        # Re-expand from scratch: the walk is deterministic, the prefix
        # replays identically; expansion is a few ms on the C++ path. The
        # step budget in turtle_expand bounds a corrupted clen (fixes
        # doc/TESTING.md:151-156); allow_short so an exhausted walk (clen
        # decoded wrong but magic intact) degrades to garbage trailing
        # bits -> AEAD failure, never an internal RuntimeError.
        idx_p, idx_y, idx_x, jit, _n = keystream.turtle_expand(
            key_walk, plane_keys, PH, PW,
            params.rmin, params.rmax, params.density, params.jitter,
            total_bits, allow_short=True,
        )
        sl = slice(_HEADER_STREAM_BITS, total_bits)
        payload_stream = read_payload(
            (idx_p[sl], idx_y[sl], idx_x[sl]), jit[sl], _HEADER_STREAM_BITS)
    if rs_on:
        coded = bit_ops.bytes_from_bits(np.asarray(payload_stream))
        if len(coded) < rs_mod.coded_len(hdr.clen + 16):
            raise StegoError("Payload truncated after ECC decode.")
        # undecodable blocks return their data uncorrected; AEAD rejects
        rest, _rs_ok, _ = rs_mod.rs_decode_interleaved(coded, hdr.clen + 16)
    else:
        payload_bits = np.asarray(ecc.rep7_decode(payload_stream))
        rest = bit_ops.bytes_from_bits(payload_bits)
    if len(rest) < hdr.clen + 16:
        raise StegoError("Payload truncated after ECC decode.")
    ct, tag = rest[: hdr.clen], rest[hdr.clen : hdr.clen + 16]

    # --- KDF + AEAD open (header bytes as AAD, reference :1299-1308) ---
    # Vault-first: derive -> open -> wipe inside the native mlock'd slot.
    with crypto.derive_keys_vault(password, master_key, salt=hdr.salt,
                                  iters=params.pbkdf2_iter) as km:
        pt = header_mod.maybe_unpad(
            km.open(hdr_bytes[: header_mod.FIXED_LEN], ct, tag), hdr.flags)
    if pt is None and params.soft_decode_fallback:
        # Soft-decision retry (rebuild-only; ops/ecc.rep_decode_soft):
        # re-decode header AND payload with matched-filter combining —
        # copies weighted by their decision values — which recovers
        # margin-failure images the hard majority loses, including stegos
        # the reference binary itself cannot extract. Runs only after a
        # hard AEAD failure; a pass stays bit-identical to the hard path.
        pt = _soft_retry(backend, spec, med, password, master_key, params,
                         path_key, key_walk, plane_keys, PH, PW, hdr,
                         payload_stream_bits, hdr_coh)
    if pt is None:
        raise StegoError("Auth failed (wrong pass or data corrupted).")
    return pt


def _rs_soft_decode(pvals, m: int) -> bytes | None:
    """RS errors-and-erasures decode from per-bit decision values: hard
    bits from sign(v), per-coded-byte confidence = min |v| over the byte's
    8 bits (a byte is only as trustworthy as its weakest bit), fed to
    ops/rs.rs_decode_interleaved_soft."""
    v = np.asarray(pvals, dtype=np.float64)
    need = rs_mod.coded_len(m) * 8
    if v.shape[0] < need:
        return None
    v = v[:need]
    bits = (v >= 0).astype(np.uint8)
    coded = bit_ops.bytes_from_bits(bits)
    conf = np.abs(v).reshape(-1, 8).min(axis=1)
    rest, _ok = rs_mod.rs_decode_interleaved_soft(coded, m, conf)
    return rest


def _soft_retry(backend, spec, med, password, master_key, params, path_key,
                key_walk, plane_keys, PH, PW, hard_hdr,
                payload_stream_bits, hdr_coh: bool = False) -> bytes | None:
    """One soft-decision re-decode of header + payload; None if still bad.
    hdr_coh: which header rule the hard pass matched (two-rule trial,
    extract_array) — the soft re-read must use the same walk + read rule."""
    hp, hy, hx, hj, vis = keystream.header_walk_with_visited(
        key_walk, plane_keys, PH, PW, params.rmin, params.rmax,
        params.density, params.jitter, _HEADER_STREAM_BITS,
        coherent=hdr_coh)
    if hdr_coh:
        hvals = backend.read_values_coherent(spec, (hy, hx), hj,
                                             params.alpha)
    else:
        hvals = backend.read_values(spec, med, (hp, hy, hx), hj,
                                    params.alpha, params)
    hdr_bits = np.asarray(ecc.rep_decode_soft(hvals, 3))
    hdr_bytes = bit_ops.bytes_from_bits(hdr_bits)
    if hdr_bytes[:4] != header_mod.MAGIC or hdr_bytes[4] != header_mod.VERSION:
        return None
    hdr = Header.from_bytes(hdr_bytes)
    rs_on = bool(hdr.flags & header_mod.FLAG_RS_PAYLOAD)
    if hdr.clen != hard_hdr.clen or rs_on != bool(
            hard_hdr.flags & header_mod.FLAG_RS_PAYLOAD):
        # soft-corrected clen or FEC flag: resize the read
        want = (rs_mod.coded_len(hdr.clen + 16) * 8 if rs_on
                else (hdr.clen + 16) * 8 * 7)
        payload_stream_bits = min(want, 3 * PH * PW // 2)
    L = header_mod.qim_levels(hdr.flags)
    if L == 1:
        return None
    coherent = bool(hdr.flags & header_mod.FLAG_COHERENT)
    if (hdr.flags & header_mod.FLAG_PER_IMAGE_WALK) or coherent:
        skeys = crypto.derive_turtle_keys(
            crypto.derive_salt_path_key(path_key, hdr.salt))
        pp, py, px, pj, _n = keystream.turtle_expand_chained(
            skeys[0], skeys[1:], PH, PW, params.rmin, params.rmax,
            params.density, params.jitter, payload_stream_bits, vis,
            allow_short=True, coherent=coherent)
    else:
        total = _HEADER_STREAM_BITS + payload_stream_bits
        pp, py, px, pj, _n = keystream.turtle_expand(
            key_walk, plane_keys, PH, PW, params.rmin, params.rmax,
            params.density, params.jitter, total, allow_short=True)
        sl = slice(_HEADER_STREAM_BITS, total)
        pp, py, px, pj = pp[sl], py[sl], px[sl], pj[sl]
    if coherent:
        if L:
            d = qim_mod.dither_angles(path_key, L,
                                      _HEADER_STREAM_BITS + len(pj))
            pvals = backend.read_values_coherent_qim(
                spec, (py, px), d[_HEADER_STREAM_BITS:], L)
        else:
            pvals = backend.read_values_coherent(spec, (py, px), pj,
                                                 params.alpha)
    elif L:
        d = qim_mod.dither_angles(path_key, L,
                                  _HEADER_STREAM_BITS + len(pj))
        pvals = backend.read_values_qim(spec, (pp, py, px),
                                        d[_HEADER_STREAM_BITS:], L)
    else:
        pvals = backend.read_values(spec, med, (pp, py, px), pj,
                                    params.alpha, params)
    if rs_on:
        rest = _rs_soft_decode(pvals, hdr.clen + 16)
        if rest is None:
            return None
    else:
        payload_bits = np.asarray(ecc.rep_decode_soft(pvals, 7))
        rest = bit_ops.bytes_from_bits(payload_bits)
    if len(rest) < hdr.clen + 16:
        return None
    ct, tag = rest[: hdr.clen], rest[hdr.clen: hdr.clen + 16]
    # unpad under THIS (soft-corrected) header's flags — its FLAG_PADDED
    # bit may differ from the hard-decoded header the caller holds
    with crypto.derive_keys_vault(password, master_key, salt=hdr.salt,
                                  iters=params.pbkdf2_iter) as km:
        return header_mod.maybe_unpad(
            km.open(hdr_bytes[: header_mod.FIXED_LEN], ct, tag), hdr.flags)


def extract(
    in_path: str,
    password: str | None = None,
    master_key: bytes | None = None,
    params: Params = Params(),
) -> bytes:
    """File-level extract."""
    try:
        img = image_io.load_rgb(in_path)
    except Exception as e:
        raise StegoError(f"Failed to load {in_path}") from e
    return extract_array(img, password=password, master_key=master_key, params=params)
