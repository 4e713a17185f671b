"""Embed pipeline (reference do_embed, steganosaur.cpp:907-1109).

Host/device split (accelerator-first redesign of the reference's
sequential loop):

  host: PNG decode -> planes
  dev : analyze = center+pad+FFT + medians + capacity + cover features
  host: [cover hash] -> salt -> KDF split -> AEAD seal -> ECC frame bits
        -> path key -> turtle keystream expansion (C++) -> index arrays
  dev : gather -> phase rotate -> conjugate-mirror scatter -> IFFT -> quantize
  host: PNG encode
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from steganosaurus_jax import crypto, keystream, spectral
from steganosaurus_jax.config import Params
from steganosaurus_jax.io import image as image_io
from steganosaurus_jax.ops import bits as bit_ops
from steganosaurus_jax.ops import ecc
from steganosaurus_jax.ops import rs as rs_mod
from steganosaurus_jax.pipeline import device, qim as qim_mod, spread
from steganosaurus_jax.pipeline import header as header_mod
from steganosaurus_jax.pipeline.errors import StegoError
from steganosaurus_jax.pipeline.header import Header
from steganosaurus_jax.utils import debug


@dataclass
class EmbedResult:
    stego: np.ndarray       # (H, W, 3) uint8
    written_bits: int
    payload_bytes: int
    capacity_bits: int


def frame_bits(header_bytes: bytes, ct: bytes, tag: bytes,
               rs: bool = False) -> np.ndarray:
    """ECC frame: rep3(bits(header)) || payload-FEC(bits(ct || tag)).

    Payload FEC is Rep-7 (reference :983-995) or, with rs=True, interleaved
    RS(255,223) (ops/rs.py; header FLAG_RS_PAYLOAD — rebuild-only)."""
    header_rep3 = ecc.rep3_encode(bit_ops.bits_from_bytes(header_bytes))
    if rs:
        payload = bit_ops.bits_from_bytes(rs_mod.rs_encode_interleaved(ct + tag))
    else:
        payload = ecc.rep7_encode(bit_ops.bits_from_bytes(ct + tag))
    return np.concatenate([np.asarray(header_rep3), np.asarray(payload)])


def _refine_coherent(backend, stego, plane, y, x, bits, jit, alphas,
                     dithers, params: Params, H: int, W: int) -> np.ndarray:
    """Iterative requantization refinement for the coherent write.

    The common-mode write survives u8 rounding only as well as the site's
    phasor resultant |S| is large: sites with moderate |S| drift across the
    sign boundary (plain rule) or a whole QIM cell after IFFT -> round ->
    FFT — measured ~2% plain / ~5% L=8 raw BER at 256², too much for the
    Rep-3 header and for short interleaved-RS payload blocks (a cell-hop is
    a CONFIDENT wrong value, so it escapes the erasure ladder's
    lowest-|d| set). Each pass re-reads the frame off the quantized stego
    and re-rotates drifted sites back onto the exact target; untouched
    pixels re-round identically, so passes converge. What survives is the
    near-cancelled tail (|S| ~ quantization noise), which carries ~zero
    weight in the soft decoders (pipeline/extract.py two-rule trial,
    _soft_retry) — exactly the sites a decoder should discount.

    Refine passes run with write_floor=0: the corrections are sub-floor by
    construction and ops/phase.write_floor_boost would inflate the written
    magnitudes by up to BMAX to push them over — the main pass already
    delivered the floored energy, and the coherent write's common rotation
    preserves it."""
    from dataclasses import replace as _dc_replace

    refine_p = _dc_replace(params, write_floor=0.0)
    hdr_n = header_mod.FIXED_LEN * 8 * 3
    want = np.asarray(bits, np.uint8)
    for _ in range(3):
        planes2 = spectral.to_planes(stego)
        spec2, med2, _c2, _f2 = backend.analyze(planes2, params, lazy=True)
        got_h = backend.read_bits_coherent(
            spec2, (y[:hdr_n], x[:hdr_n]), jit[:hdr_n], params.alpha)
        if params.qim:
            got_p = backend.read_bits_coherent_qim(
                spec2, (y[hdr_n:], x[hdr_n:]), dithers[hdr_n:], params.qim)
        else:
            got_p = backend.read_bits_coherent(
                spec2, (y[hdr_n:], x[hdr_n:]), jit[hdr_n:], params.alpha)
        got = np.concatenate([np.asarray(got_h), np.asarray(got_p)])
        if np.array_equal(got, want):
            break
        stego = backend.embed_apply(
            spec2, med2, (plane, y, x), bits, jit,
            params.alpha if alphas is None else alphas, refine_p, H, W,
            qim_dithers=dithers, hdr_bits=hdr_n)
    return stego


def embed_array(
    img: np.ndarray,
    secret: bytes,
    password: str | None = None,
    master_key: bytes | None = None,
    params: Params = Params(),
    salt: bytes | None = None,
) -> EmbedResult:
    """Embed `secret` into (H, W, 3) uint8 `img`. Returns the stego image.

    Exactly one of password / master_key must be given. `salt` is injectable
    for deterministic tests; default is 16 CSPRNG bytes (the reference pulls
    from std::random_device, :927-929 — ledger says use the CSPRNG).
    """
    if (password is None) == (master_key is None):
        raise ValueError("exactly one of password/master_key required")

    backend = device.get_backend(params)
    planes = spectral.to_planes(img)
    H, W = img.shape[:2]
    PH, PW = spectral.fft_dims(H, W)

    spec, med, capacity, feat = backend.analyze(planes, params)

    # Key material & AEAD seal (header is AAD, reference :946-975)
    if salt is None:
        salt = crypto.get_random_bytes(16)
    # Vault-first derivation: the AEAD key stays in the native mlock'd slot
    # (crypto.VaultedKeys) through seal_stream; falls back to Python bytes
    # only when the native library is absent.
    km = crypto.derive_keys_vault(password, master_key, salt=salt,
                                  iters=params.pbkdf2_iter)
    flags = 0
    if params.per_image_walk:
        if params.cover_dependent_path:
            raise StegoError(
                "per_image_walk and cover_dependent_path are mutually "
                "exclusive (both re-key the walk per image)")
        flags = header_mod.FLAG_PER_IMAGE_WALK
    if params.coherent:
        if params.adaptive_alpha:
            raise StegoError(
                "coherent and adaptive_alpha are mutually exclusive (a "
                "per-plane magnitude rescale has no common-mode analog)")
        if params.cover_dependent_path:
            raise StegoError(
                "coherent and cover_dependent_path are mutually exclusive "
                "(the coherent payload walk is salt-keyed per image)")
        flags |= header_mod.FLAG_COHERENT
    if params.qim:
        qim_mod.validate(params)
        flags = header_mod.flags_with_qim(flags, params.qim)
    if params.rs:
        flags |= header_mod.FLAG_RS_PAYLOAD
    header_bytes, ct, tag = header_mod.seal_stream(secret, km, flags,
                                                   params.pad_quantum)
    km.close()  # wipe the vault slot: the sealed stream is all we need

    bits = frame_bits(header_bytes, ct, tag, rs=params.rs)
    hdr_n = header_mod.FIXED_LEN * 8 * 3
    # Coherent bits (header AND payload) consume a whole (y, x) site —
    # three plane-bins plus conjugates — so the pair-counting capacity
    # must be charged 3x (the walk exhaustion check below is the hard
    # backstop; this pre-check keeps the reference's fast-fail contract).
    need = 3 * len(bits) if params.coherent else len(bits)
    if need > capacity:
        raise StegoError(
            f"Message too large. Need {need} bits (after ECC), "
            f"capacity ~{capacity} bits."
        )

    # Path key (salt-independent; optionally cover-dependent, :1017-1040)
    cover_hash = None
    if params.cover_dependent_path:
        cover_hash = crypto.sha256(np.asarray(feat).tobytes())
    path_key = crypto.derive_path_key(password, master_key, cover_hash)
    key_walk, key_r, key_g, key_b = crypto.derive_turtle_keys(path_key)

    if params.per_image_walk or params.coherent:
        # Header on the shared walk prefix; payload on the salt-keyed walk
        # resuming from the header walk's visited state (pipeline/header.py
        # FLAG_PER_IMAGE_WALK; doc/ATTACKS.md §4). Coherent mode rides the
        # same chained structure (FLAG_COHERENT) with the coherent site
        # semantics on BOTH walks — the header too, else its 912
        # single-plane writes alone hand the cross-channel warden AUC 1.0
        # (measured, doc/ATTACKS.md §2e); extraction resolves which header
        # rule applies by a two-rule trial (pipeline/extract.py).
        hp, hy, hx, hj, vis = keystream.header_walk_with_visited(
            key_walk, (key_r, key_g, key_b), PH, PW,
            params.rmin, params.rmax, params.density, params.jitter, hdr_n,
            coherent=params.coherent)
        skeys = crypto.derive_turtle_keys(
            crypto.derive_salt_path_key(path_key, salt))
        try:
            pp, py, px, pj = keystream.turtle_expand_chained(
                skeys[0], skeys[1:], PH, PW,
                params.rmin, params.rmax, params.density, params.jitter,
                len(bits) - hdr_n, vis, coherent=params.coherent)
        except RuntimeError as e:
            raise StegoError(
                f"Message too large. Salt-keyed payload walk exhausted: {e}"
            ) from e
        plane = np.concatenate([hp, pp])
        y = np.concatenate([hy, py])
        x = np.concatenate([hx, px])
        jit = np.concatenate([hj, pj])
    else:
        plane, y, x, jit = keystream.turtle_expand(
            key_walk, (key_r, key_g, key_b), PH, PW,
            params.rmin, params.rmax, params.density, params.jitter,
            len(bits),
        )
    if debug.enabled():  # reference -DDEBUG=1 dumps (steganosaur.cpp:1082-1094)
        debug.dump_dims("embed", H, W, PH, PW)
        debug.dump_key_prefix("embed path_key", path_key)
        debug.dump_walk("embed", plane, y, x)
        debug.dump_header("embed header", header_bytes)

    # Randomized write amplitude (rebuild-only, embed-side only: the decode
    # rule never uses the written magnitude — pipeline/spread.py).
    alphas = spread.spread_alphas(path_key, params, len(bits))
    # Keyed QIM dither angles, slot-aligned with the frame (payload slots
    # only are consumed — pipeline/qim.py).
    dithers = (qim_mod.dither_angles(path_key, params.qim, len(bits))
               if params.qim else None)
    stego = backend.embed_apply(
        spec, med, (plane, y, x), bits, jit,
        params.alpha if alphas is None else alphas, params, H, W,
        qim_dithers=dithers, hdr_bits=header_mod.FIXED_LEN * 8 * 3,
    )
    if params.coherent:
        stego = _refine_coherent(backend, stego, plane, y, x, bits, jit,
                                 alphas, dithers, params, H, W)
    return EmbedResult(
        stego=stego,
        written_bits=int(len(bits)),
        payload_bytes=len(secret),
        capacity_bits=capacity,
    )


def embed(
    in_path: str,
    out_path: str,
    secret: str,
    password: str | None = None,
    master_key: bytes | None = None,
    params: Params = Params(),
) -> EmbedResult:
    """File-level embed: load PNG, embed, write stego PNG."""
    try:
        img = image_io.load_rgb(in_path)
    except Exception as e:
        raise StegoError(f"Failed to load {in_path}") from e
    res = embed_array(
        img, secret.encode(), password=password, master_key=master_key, params=params
    )
    image_io.save_png(out_path, res.stego)
    return res
