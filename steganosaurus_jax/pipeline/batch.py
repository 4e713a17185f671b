"""Batched embed/extract over a device mesh (the throughput path).

The reference processes one image per process invocation (~6 s, KDF-bound).
The batched bulk path amortizes everything:

- host: AEAD/KDF/ECC per image (C++ crypto), ONE turtle expansion for the
  whole batch — the walk key is salt-independent (steganosaur.cpp:1134-1143),
  so with a shared password/master key every image follows the same bin
  sequence; only the bit values differ.
- link: images cross host<->device exactly once per direction, as uint8 in
  native (B, H, W, 3) layout; the shared (nbits,) index arrays upload once
  per batch, not per image.
- device: one traced graph per (H, W) bucket — u8 decode -> pad -> FFT ->
  median -> phase scatter -> IFFT -> quantize — vmapped over the batch and
  sharded over the mesh "batch" axis with no steady-state collectives
  (SURVEY.md §2.3). Extraction FFTs each image once: the spectrum stays
  device-resident between the header and payload gather passes.

Ragged payloads: shorter frames repeat their last bit into the shared walk's
surplus bins; bins past an image's own frame are never read back (clen bounds
the read), so the padding is invisible to extraction — including extraction
by the reference binary.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax.numpy as jnp
import numpy as np

from steganosaurus_jax import crypto, keystream, spectral
from steganosaurus_jax.config import Params
from steganosaurus_jax.ops import bits as bit_ops
from steganosaurus_jax.ops import ecc
from steganosaurus_jax.ops import rs as rs_mod
from steganosaurus_jax.parallel import batch as pbatch
from steganosaurus_jax.parallel import transfer
from steganosaurus_jax.pipeline import header as header_mod
from steganosaurus_jax.pipeline import qim as qim_mod
from steganosaurus_jax.pipeline import spread as spread_mod
from steganosaurus_jax.pipeline.errors import StegoError
from steganosaurus_jax.pipeline.header import Header

_HEADER_STREAM_BITS = header_mod.FIXED_LEN * 8 * 3


@dataclass
class BatchEmbedResult:
    stego: np.ndarray            # (B, H, W, 3) uint8 (jax array if device_resident)
    written_bits: list[int]
    payload_bytes: list[int]
    salts: list[bytes] | None = None     # final per-image salts (verify mode
    #                                      may re-salt failed images)
    verified: list[bool] | None = None   # per-image read-back success
    #                                      (None unless verify=True)


def _walk_indices(password, master_key, params, PH, PW, nbits,
                  allow_short=False):
    path_key = crypto.derive_path_key(password, master_key, None)
    key_walk, key_r, key_g, key_b = crypto.derive_turtle_keys(path_key)
    return keystream.turtle_expand(
        key_walk, (key_r, key_g, key_b), PH, PW,
        params.rmin, params.rmax, params.density, params.jitter, nbits,
        allow_short=allow_short,
    )


# Device-resident walk index cache. The host walk cache (keystream) makes
# expansion free for repeated keys, but each gather/embed still re-uploaded
# ~20 B/bit of index arrays over the host<->device link (~18 MB at 4K/16KB).
# The arrays are a pure
# function of (path_key, dims, walk params, slice), so one upload serves all
# subsequent calls.
_DEV_IDX_CACHE: "OrderedDict[tuple, tuple]" = __import__(
    "collections").OrderedDict()
_DEV_IDX_MAX = 16


def _walk_indices_device(password, master_key, params, PH, PW, nbits,
                         skip, bucket, mesh):
    """((plane, y, x, jitter) device arrays of length `bucket` covering walk
    bits [skip, nbits) tail-padded with the last index, nproduced). jitter is
    f32. nproduced < nbits means the walk exhausted (gathers past it read the
    last bin; embed must treat it as capacity exceeded)."""
    import jax

    path_key = crypto.derive_path_key(password, master_key, None)
    # Key on the Mesh object itself (hashable), never id(mesh): a GC'd mesh's
    # id can be reused by a new Mesh, silently serving arrays placed for dead
    # devices. Holding the mesh in the key also pins its devices alive for
    # exactly as long as the cached placement is servable.
    key = (path_key, PH, PW, params.rmin, params.rmax, params.density,
           params.jitter, skip, bucket, nbits, mesh)
    ent = _DEV_IDX_CACHE.get(key)
    if ent is None:
        plane, y, x, jit, nprod = _walk_indices(password, master_key, params,
                                                PH, PW, nbits,
                                                allow_short=True)
        pad = bucket - (nbits - skip)
        sl = slice(skip, nbits)
        host = [np.concatenate([a[sl], np.repeat(a[nbits - 1], pad)])
                for a in (plane, y, x)]
        host.append(np.concatenate([jit[sl], np.repeat(jit[nbits - 1], pad)])
                    .astype(np.float32))
        if mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P

            rep = NamedSharding(mesh, P())
            arrs = tuple(jax.device_put(a, rep) for a in host)
        else:
            arrs = tuple(jax.device_put(a) for a in host)
        ent = (arrs, nprod)
        _DEV_IDX_CACHE[key] = ent
    _DEV_IDX_CACHE.move_to_end(key)
    while len(_DEV_IDX_CACHE) > _DEV_IDX_MAX:
        _DEV_IDX_CACHE.popitem(last=False)
    return ent


# Corner-path static maps (pos / jitter trig), one scatter per walk, then
# reused by every batch under the same key. Same key discipline as
# _DEV_IDX_CACHE (Mesh object, never id()).
_CORNER_STATICS_CACHE: "OrderedDict[tuple, tuple]" = __import__(
    "collections").OrderedDict()


def _corner_statics_device(password, master_key, params, PH, PW, nbits,
                           bucket, Ky, Kx, mesh, qim_levels: int | None = None):
    """((pos, [cjd, sjd], [cad, sad], [dq, qm]) device maps, nprod) for the
    walk's first `bucket` slots (see parallel.batch.corner_statics_core).
    The amplitude maps cad/sad appear when params.alpha_spread != 0
    (pipeline/spread.py); the QIM dither/payload-mask maps dq/qm when the
    effective QIM level is nonzero (params.qim, overridable per call via
    `qim_levels` — extraction auto-detects L from headers and may need maps
    for a level other than the params'). Read-side consumers select pairs
    positionally via _read_maps — the order is fixed as
    (pos, [cjd, sjd], [cad, sad], [dq, qm])."""
    path_key = crypto.derive_path_key(password, master_key, None)
    has_jitter = params.jitter != 0.0
    has_spread = params.alpha_spread != 0.0
    L = params.qim if qim_levels is None else qim_levels
    # nbits is part of the key: the walk arrays' tail padding in
    # [nbits, bucket) depends on it (repeats bin nbits-1). alpha joins the
    # key only under spread (the amplitude maps bake cos/sin(alpha_i)).
    key = (path_key, PH, PW, params.rmin, params.rmax, params.density,
           params.jitter, nbits, bucket, Ky, Kx, mesh,
           (params.alpha, params.alpha_spread) if has_spread else None, L)
    ent = _CORNER_STATICS_CACHE.get(key)
    if ent is None:
        import jax

        def pad_put(a):
            a = np.concatenate(
                [a, np.repeat(a[nbits - 1], bucket - nbits)]).astype(
                np.float32)
            if mesh is not None:
                from jax.sharding import NamedSharding, PartitionSpec as P

                return jax.device_put(a, NamedSharding(mesh, P()))
            return jax.device_put(a)

        (plane, y, x, jit), nprod = _walk_indices_device(
            password, master_key, params, PH, PW, nbits, 0, bucket, mesh)
        build = pbatch.corner_statics_core(
            Ky, Kx, bucket, has_jitter, mesh, has_spread=has_spread,
            qim_hdr=_HEADER_STREAM_BITS if L else 0)
        args = (plane, y, x, jit)
        if has_spread:
            args = args + (pad_put(
                spread_mod.spread_alphas(path_key, params, nbits)),)
        if L:
            args = args + (pad_put(
                qim_mod.dither_angles(path_key, L, nbits)),)
        ent = (build(*args), nprod)
        _CORNER_STATICS_CACHE[key] = ent
    _CORNER_STATICS_CACHE.move_to_end(key)
    while len(_CORNER_STATICS_CACHE) > _DEV_IDX_MAX:
        _CORNER_STATICS_CACHE.popitem(last=False)
    return ent


def _read_maps(maps, params, qim_levels: int | None = None):
    """Select the read-side static map pairs from a _corner_statics_device
    tuple: ([cjd, sjd] when jitter, [dq, qm] when QIM) — skipping the
    embed-only amplitude pair. This is what corner_bits_core /
    corner_extract_fused_core / corner_soft_extract_core(shared) take
    between the image and alpha arguments."""
    L = params.qim if qim_levels is None else qim_levels
    out = ()
    i = 1
    if params.jitter != 0.0:
        out += (maps[i], maps[i + 1])
        i += 2
    if params.alpha_spread != 0.0:
        i += 2
    if L:
        out += (maps[i], maps[i + 1])
    return out


# Prefetched per-image payload walks (per-image-walk streams): keyed by
# (path_key, salt, dims, walk params, need). Unlike the shared-walk cache
# (keystream module), entries are single-use — salts rotate per batch — so
# consumers POP them; the prefetcher (prefetch_piw_walks, driven by
# pipeline.stream) fills them while earlier batches hold the device.
_PIW_CACHE: "OrderedDict[tuple, tuple]" = __import__(
    "collections").OrderedDict()
_PIW_CACHE_MAX = 256
_PIW_CACHE_LOCK = __import__("threading").Lock()


def _piw_key(path_key, salt, params, PH, PW, need):
    return (path_key, salt, PH, PW, params.rmin, params.rmax, params.density,
            params.jitter, need)


def _piw_expand_one(path_key, salt, params, PH, PW, need, vis):
    """One salt-keyed payload expansion (turtle_expand_chained), consulting
    and maintaining the prefetch cache."""
    key = _piw_key(path_key, salt, params, PH, PW, need)
    with _PIW_CACHE_LOCK:
        ent = _PIW_CACHE.pop(key, None)
    if ent is not None:
        return ent
    sk = crypto.derive_turtle_keys(crypto.derive_salt_path_key(path_key,
                                                               salt))
    return keystream.turtle_expand_chained(
        sk[0], sk[1:], PH, PW, params.rmin, params.rmax, params.density,
        params.jitter, need, vis, allow_short=True)


def prefetch_piw_walks(password, master_key, params: Params, H: int, W: int,
                       salts: list[bytes], secret_lens: list[int]) -> None:
    """Warm the per-image payload-walk cache for an upcoming batch.

    The per-image-walk mode's dominant host cost is the B salt-keyed
    sequential expansions (doc/SUMMARY.md: ~2.3x the shared-walk batch at
    1080p); pipeline.stream submits this to a worker thread so they run
    while the in-flight device batches execute, exactly like prefetch_walk
    does for the shared walk. Needs the batch's salts, so streams draw
    salts up front for flagged params. Errors are swallowed — the
    subsequent embed surfaces them with full context."""
    try:
        from concurrent.futures import ThreadPoolExecutor

        PH, PW = spectral.fft_dims(H, W)
        path_key = crypto.derive_path_key(password, master_key, None)
        kw, kr, kg, kb = crypto.derive_turtle_keys(path_key)
        *_, vis = keystream.header_walk_with_visited(
            kw, (kr, kg, kb), PH, PW, params.rmin, params.rmax,
            params.density, params.jitter, _HEADER_STREAM_BITS)
        needs = [(n + 16) * 8 * 7 for n in secret_lens]

        def one(i):
            key = _piw_key(path_key, salts[i], params, PH, PW, needs[i])
            with _PIW_CACHE_LOCK:
                if key in _PIW_CACHE:
                    return
            sk = crypto.derive_turtle_keys(
                crypto.derive_salt_path_key(path_key, salts[i]))
            ent = keystream.turtle_expand_chained(
                sk[0], sk[1:], PH, PW, params.rmin, params.rmax,
                params.density, params.jitter, needs[i], vis,
                allow_short=True)
            with _PIW_CACHE_LOCK:
                _PIW_CACHE[key] = ent
                while len(_PIW_CACHE) > _PIW_CACHE_MAX:
                    _PIW_CACHE.popitem(last=False)

        with ThreadPoolExecutor(max_workers=min(8, len(salts))) as ex:
            list(ex.map(one, range(len(salts))))
    except Exception:  # noqa: BLE001 — deliberately quiet (see docstring)
        pass


def _piw_walk_arrays(password, master_key, params, PH, PW, salts,
                     need_lens, bucket, strict=True):
    """Per-image-walk (B, bucket) plane/y/x i32 + jitter f32 arrays.

    Row i = shared header prefix (912 bits, cached with its visited bitmap)
    followed by the salt-keyed payload walk for salts[i] resuming from that
    visited state (keystream.turtle_expand_chained), expanded to
    need_lens[i] - 912 bits and tail-padded to `bucket` by repeating the
    last real bin (duplicate scatters carry identical values — the batch
    padding contract). Payload expansions are independent per image and the
    C++ walker releases the GIL, so they run on a thread pool — the only
    sequential cost left is max over images, not the sum.

    strict=True (embed): raises StegoError if any image's walk exhausts
    before its frame fits. strict=False (extraction — need_lens come from
    DECODED, possibly corrupt, header clens): an exhausted walk pads with
    the last real bin so downstream gathers read garbage the AEAD rejects —
    one bad image must never abort the batch (reference hang class,
    doc/TESTING.md:151-156).
    """
    from concurrent.futures import ThreadPoolExecutor

    path_key = crypto.derive_path_key(password, master_key, None)
    kw, kr, kg, kb = crypto.derive_turtle_keys(path_key)
    hdr_n = _HEADER_STREAM_BITS
    hp, hy, hx, hj, vis = keystream.header_walk_with_visited(
        kw, (kr, kg, kb), PH, PW, params.rmin, params.rmax, params.density,
        params.jitter, hdr_n)

    def expand(i):
        return _piw_expand_one(path_key, salts[i], params, PH, PW,
                               need_lens[i] - hdr_n, vis)

    B = len(salts)
    with ThreadPoolExecutor(max_workers=min(8, B)) as ex:
        outs = list(ex.map(expand, range(B)))

    plane = np.empty((B, bucket), np.int32)
    yarr = np.empty((B, bucket), np.int32)
    xarr = np.empty((B, bucket), np.int32)
    jarr = np.empty((B, bucket), np.float32)
    for i, (pp, py, px, pj, n) in enumerate(outs):
        need = need_lens[i] - hdr_n
        if n < need and strict:
            raise StegoError(
                f"Message too large. Image {i}: salt-keyed payload walk "
                f"exhausted after {n}/{need} bits."
            )
        for dst, pre, pay in ((plane, hp, pp), (yarr, hy, py),
                              (xarr, hx, px), (jarr, hj, pj)):
            row = dst[i]
            row[:hdr_n] = pre
            row[hdr_n:hdr_n + need] = pay[:need]
            row[hdr_n + need:] = row[hdr_n + need - 1]
    return plane, yarr, xarr, jarr


def prefetch_walk(password, master_key, params: Params, H: int, W: int,
                  secret_lens: list[int]) -> None:
    """Warm the HOST walk cache for (key, dims, params) ahead of use.

    The turtle walk is the pipeline's only strictly sequential host cost
    (~1.5 s per M-bit fresh-key expansion, steganosaur.cpp:665-810);
    pipeline.stream submits this to a worker thread when a stream's key
    rotates so the expansion overlaps the in-flight device batches instead
    of stalling the next embed_batch. Errors are swallowed — the subsequent
    embed surfaces them with full context."""
    try:
        PH, PW = spectral.fft_dims(H, W)
        if params.per_image_walk:
            # only the shared header prefix is prefetchable — the payload
            # walks are salt-keyed and the salts don't exist yet (pre-drawn
            # salt prefetch is a possible future stream optimization)
            path_key = crypto.derive_path_key(password, master_key, None)
            kw, kr, kg, kb = crypto.derive_turtle_keys(path_key)
            keystream.header_walk_with_visited(
                kw, (kr, kg, kb), PH, PW, params.rmin, params.rmax,
                params.density, params.jitter, _HEADER_STREAM_BITS)
            return
        nmax = max(_HEADER_STREAM_BITS + (n + 16) * 8 * 7
                   for n in secret_lens)
        _walk_indices(password, master_key, params, PH, PW, nmax,
                      allow_short=True)
    except Exception:  # noqa: BLE001 — deliberately quiet (see docstring)
        pass


def embed_batch(
    imgs: np.ndarray,
    secrets: list[bytes],
    password: str | None = None,
    master_key: bytes | None = None,
    params: Params = Params(),
    salts: list[bytes] | None = None,
    mesh=None,
    device_resident: bool = False,
    verify: bool = False,
    max_retries: int = 2,
    layout: str = "nhwc",
) -> BatchEmbedResult:
    """Embed `secrets[i]` into `imgs[i]` under one shared password/master key.

    imgs: (B, H, W, 3) uint8 — numpy, or an already-device-resident jax array
    (amortize the upload across calls by `jax.device_put`-ing covers once).
    cover_dependent_path is not supported on the batch path (the walk would
    differ per image; use embed_array).

    layout="nchw": imgs are (B, 3, H, W) and the stego result keeps that
    layout. Device-resident serving chains should use it — it skips two
    strided u8 relayouts per round-trip (~25% of the 4K step); corner path
    only. PNG I/O callers keep the default "nhwc".

    device_resident=True returns the stego batch as a device u8 array (no
    host pull) — feed it straight to extract_batch or pull it later; the
    host<->device link is the bulk path's bottleneck, not compute.

    verify=True read-back-verifies every image on device after embedding
    (costs ~one extract pass) and re-embeds failures with FRESH SALTS up to
    max_retries times: a new salt produces a different AEAD stream, hence
    different bits and different quantization/clamp noise — heavy payloads
    near the Rep-3 header margin (e.g. 16 KB on full-range noise covers,
    ~7%/image failure odds) converge to 100% recovery in 1-2 retries.
    Result.verified reports per-image status; result.salts the final salts.
    Explicit `salts` are respected on the first attempt only.
    """
    if (password is None) == (master_key is None):
        raise ValueError("exactly one of password/master_key required")
    if params.cover_dependent_path:
        raise StegoError("cover_dependent_path is per-image; use embed_array")
    if getattr(params, "coherent", False):
        raise StegoError(
            "coherent batch embedding is not wired into the fused batch "
            "cores; use embed_array (extract_batch auto-detects and "
            "resolves coherent stegos per image)")
    if layout == "nchw":
        if params.adaptive_alpha:
            raise StegoError("layout='nchw' is corner-path only")
        B, _, H, W = imgs.shape
    else:
        B, H, W = imgs.shape[:3]
    assert len(secrets) == B
    PH, PW = spectral.fft_dims(H, W)

    if salts is None:
        salts = [crypto.get_random_bytes(16) for _ in range(B)]

    # Host crypto per image -> header||ct||tag streams (ECC expansion happens
    # on device on the corner path; host-side only on the legacy path)
    flags = header_mod.FLAG_PER_IMAGE_WALK if params.per_image_walk else 0
    if params.qim:
        qim_mod.validate(params)
        flags = header_mod.flags_with_qim(flags, params.qim)
    if params.rs:
        flags |= header_mod.FLAG_RS_PAYLOAD
    streams = []
    for secret, salt in zip(secrets, salts):
        with crypto.derive_keys_vault(password, master_key, salt=salt,
                                      iters=params.pbkdf2_iter) as km:
            hdr_bytes, ct, tag = header_mod.seal_stream(
                secret, km, flags, params.pad_quantum)
        streams.append(hdr_bytes + ct + tag)

    if params.rs:
        frame_lens = [_HEADER_STREAM_BITS
                      + rs_mod.coded_len(len(s) - header_mod.FIXED_LEN) * 8
                      for s in streams]
    else:
        frame_lens = [_HEADER_STREAM_BITS
                      + (len(s) - header_mod.FIXED_LEN) * 8 * 7
                      for s in streams]
    nmax = max(frame_lens)
    # One walk serves the whole batch (salt-independent path key). Indices
    # are bucketed to a multiple of 4096 and live on device (see
    # _walk_indices_device) — nearby payload sizes reuse one compiled graph
    # and one index upload. Surplus bins repeat the last (bin, bit) pair:
    # duplicate writes of an identical value are benign and never read back.
    bucket = -(-nmax // 4096) * 4096
    if params.per_image_walk:
        plane = y = x = jit = None  # per-image arrays built in the branch
    else:
        (plane, y, x, jit), nprod = _walk_indices_device(
            password, master_key, params, PH, PW, nmax, 0, bucket, mesh)
        if nprod < nmax:
            raise StegoError(
                f"Message too large. Need {nmax} bits (after ECC), walk "
                f"exhausted after {nprod}."
            )

    def _host_frames():
        """ECC-expanded bit frames, padded to `bucket` with each image's
        last bit (reference frame layout, steganosaur.cpp:986-995; RS wire
        mode codes the payload section via ops/rs.py instead of Rep-7)."""
        bits = np.zeros((B, bucket), np.uint8)
        for i, s in enumerate(streams):
            h = ecc.rep3_encode(
                bit_ops.bits_from_bytes(s[: header_mod.FIXED_LEN]))
            if params.rs:
                p = bit_ops.bits_from_bytes(rs_mod.rs_encode_interleaved(
                    s[header_mod.FIXED_LEN:]))
            else:
                p = ecc.rep7_encode(
                    bit_ops.bits_from_bytes(s[header_mod.FIXED_LEN:]))
            f = np.concatenate([np.asarray(h), np.asarray(p)])
            bits[i, : len(f)] = f
            bits[i, len(f):] = f[-1]
        return bits

    if mesh is not None and not isinstance(imgs, jnp.ndarray):
        imgs_d = pbatch.shard_batch(np.ascontiguousarray(imgs), mesh)
    else:
        imgs_d = imgs if isinstance(imgs, jnp.ndarray) else np.ascontiguousarray(imgs)
    alpha = jnp.float32(params.alpha)
    has_spread = params.alpha_spread != 0.0
    if has_spread:
        spread_mod.validate(params)

    if params.per_image_walk:
        from steganosaurus_jax.spectral import corner as corner_mod

        plane, y, x, jit = _piw_walk_arrays(
            password, master_key, params, PH, PW, salts, frame_lens, bucket)
        bits_w = pbatch.pack_bits_words_host(_host_frames())
        if mesh is not None:
            plane, y, x, jit, bits_w = (pbatch.shard_batch(a, mesh) for a in
                                        (plane, y, x, jit, bits_w))
        if params.adaptive_alpha:
            # adaptive needs the full-spectrum median: legacy per-image
            # scatter core (shared_idx=False)
            fn = pbatch.batched_embed_core(H, W, params.center, True, mesh,
                                           shared_idx=False,
                                           pack=not device_resident,
                                           bits_packed=True,
                                           soft=params.soft_write,
                                           floor=params.write_floor)
            if params.write_floor:
                nb_piw = np.asarray(frame_lens, np.int32)
                if mesh is not None:
                    nb_piw = pbatch.shard_batch(nb_piw, mesh)
                out = fn(imgs_d, plane, y, x, bits_w, jit, alpha, nb_piw)
            else:
                out = fn(imgs_d, plane, y, x, bits_w, jit, alpha)
        else:
            Ky, Kx = corner_mod.corner_dims(PH, PW, params.rmax)
            fn = pbatch.corner_piw_embed_core(H, W, Ky, Kx, params.center,
                                              mesh,
                                              pack=not device_resident,
                                              layout=layout,
                                              soft=params.soft_write,
                                              spread=has_spread,
                                              qim_levels=params.qim,
                                              qim_hdr=(_HEADER_STREAM_BITS
                                                       if params.qim else 0),
                                              floor=params.write_floor)
            need_nb = has_spread or params.qim
            path_key = crypto.derive_path_key(password, master_key, None)
            args = (imgs_d, plane, y, x, bits_w, jit)
            if need_nb:
                nb_per = np.asarray(frame_lens, np.int32)
                if mesh is not None:
                    nb_per = pbatch.shard_batch(nb_per, mesh)
                args = args + (nb_per,)
            if params.qim:
                args = args + (jnp.asarray(qim_mod.dither_angles(
                    path_key, params.qim, bucket)),)
            if has_spread:
                al = jnp.asarray(
                    spread_mod.spread_alphas(path_key, params, bucket))
                out = fn(*args, al)
            else:
                out = fn(*args, alpha)
    elif not params.adaptive_alpha:
        # Corner fast path: pruned-DFT matmuls + dense phase write, no
        # scatter, no full-grid FFT (spectral/corner.py). Adaptive alpha
        # needs the full-spectrum median and stays on the legacy path.
        from steganosaurus_jax.spectral import corner as corner_mod

        Ky, Kx = corner_mod.corner_dims(PH, PW, params.rmax)
        has_jitter = params.jitter != 0.0
        maps, _ = _corner_statics_device(password, master_key, params, PH,
                                         PW, nmax, bucket, Ky, Kx, mesh)
        if len(set(frame_lens)) == 1 and mesh is None and not params.rs:
            # equal-length single-chip path: upload raw streams (~28x
            # smaller than ECC bit words); the ECC expansion AND the packed
            # frame table build run INSIDE the embed module (one dispatch
            # instead of two)
            words = pbatch.pack_bytes_words_host(streams)
            fn = pbatch.corner_embed_core(H, W, Ky, Kx, params.center, None,
                                          has_jitter,
                                          pack=not device_resident,
                                          layout=layout,
                                          stream_bytes=len(streams[0]),
                                          bucket=bucket,
                                          soft=params.soft_write,
                                          has_spread=has_spread,
                                          qim_levels=params.qim,
                                          floor=params.write_floor)
            out = fn(imgs_d, words, *maps, alpha)
        else:
            if len(set(frame_lens)) == 1 and not params.rs:
                words = pbatch.pack_bytes_words_host(streams)
                tbl_fn = pbatch.frame_table_core(len(streams[0]), bucket,
                                                 mesh)
            elif mesh is None:
                words = pbatch.pack_bits_words_host(_host_frames())
                tbl_fn = pbatch.bits_table_packed_core(bucket, B)
            else:
                words = pbatch.pack_bits_words_host(_host_frames())
                tbl_fn = pbatch.bits_table_core(bucket, mesh)
            words_d = (pbatch.shard_batch(words, mesh) if mesh is not None
                       else words)
            table = tbl_fn(words_d)
            fn = pbatch.corner_embed_core(H, W, Ky, Kx, params.center, mesh,
                                          has_jitter,
                                          pack=not device_resident,
                                          layout=layout,
                                          soft=params.soft_write,
                                          has_spread=has_spread,
                                          qim_levels=params.qim,
                                          floor=params.write_floor)
            out = fn(imgs_d, table, *maps, alpha)
    else:
        if has_spread:
            # Per-slot amplitude array rides the (already per-bin) alpha
            # argument of the legacy scatter core (ops/phase.embed_phases
            # broadcasts it; spread composes multiplicatively with the
            # reference's adaptive magnitude scaling).
            path_key = crypto.derive_path_key(password, master_key, None)
            al = spread_mod.spread_alphas(path_key, params, nmax)
            alpha = jnp.asarray(np.concatenate(
                [al, np.repeat(al[nmax - 1], bucket - nmax)]).astype(
                np.float32))
        bits_w = pbatch.pack_bits_words_host(_host_frames())
        bits_d = (pbatch.shard_batch(bits_w, mesh) if mesh is not None
                  and not isinstance(imgs, jnp.ndarray) else bits_w)
        fn = pbatch.batched_embed_core(H, W, params.center,
                                       params.adaptive_alpha, mesh,
                                       pack=not device_resident,
                                       bits_packed=True,
                                       soft=params.soft_write,
                                       floor=params.write_floor)
        out = (fn(imgs_d, plane, y, x, bits_d, jit, alpha,
                  jnp.int32(nmax))
               if params.write_floor else
               fn(imgs_d, plane, y, x, bits_d, jit, alpha))

    out_shape = (B, 3, H, W) if layout == "nchw" else (B, H, W, 3)
    verified = None
    if verify:
        salts = list(salts)
        # the on-wire clen is the PADDED plaintext length; an unpadded hint
        # would undersize the fused pass and force a second dispatch on
        # every verify extraction
        maxlen = max(len(s) for s in secrets)
        if params.pad_quantum:
            maxlen = header_mod.padded_len(maxlen, params.pad_quantum)
        # np.array: unpack_u8 returns a read-only buffer view; retries patch
        # failed rows in place.
        check_src = out if device_resident else np.array(
            transfer.unpack_u8(np.asarray(out), out_shape))
        got = extract_batch(check_src, password=password,
                            master_key=master_key, params=params, mesh=mesh,
                            clen_hint=maxlen, layout=layout)
        verified = [g == s for g, s in zip(got, secrets)]
        for _ in range(max_retries):
            failed = [i for i, ok in enumerate(verified) if not ok]
            if not failed:
                break
            sub_imgs = (imgs_d[np.asarray(failed)]
                        if isinstance(imgs_d, jnp.ndarray)
                        else np.ascontiguousarray(imgs_d[failed]))
            new_salts = [crypto.get_random_bytes(16) for _ in failed]
            # The failed-subset size rarely divides the mesh: re-embed it
            # unsharded (retries are a small tail; single-device is fine).
            sub_mesh = (mesh if mesh is not None
                        and len(failed) % mesh.size == 0 else None)
            sub = embed_batch(sub_imgs, [secrets[i] for i in failed],
                              password=password, master_key=master_key,
                              params=params, salts=new_salts, mesh=sub_mesh,
                              device_resident=device_resident, verify=False,
                              layout=layout)
            if device_resident:
                check_src = check_src.at[jnp.asarray(failed)].set(sub.stego)
            else:
                check_src[np.asarray(failed)] = sub.stego
            got = extract_batch(check_src, password=password,
                                master_key=master_key, params=params,
                                mesh=mesh, clen_hint=maxlen, layout=layout)
            for i, s_new in zip(failed, new_salts):
                salts[i] = s_new
            verified = [g == s for g, s in zip(got, secrets)]

    if verify:
        stego = check_src  # device or host array, patched by retries
    elif device_resident:
        stego = out
    else:
        stego = transfer.unpack_u8(np.asarray(out), out_shape)
    return BatchEmbedResult(
        stego=stego,
        written_bits=frame_lens,
        payload_bytes=[len(s) for s in secrets],
        salts=list(salts),
        verified=verified,
    )


def channel_report(
    stego: np.ndarray,
    secrets: list[bytes],
    salts: list[bytes],
    password: str | None = None,
    master_key: bytes | None = None,
    params: Params = Params(),
    mesh=None,
    layout: str = "nhwc",
    per_image: bool = False,
) -> dict:
    """Measure channel quality: raw and post-ECC BER, header and payload,
    averaged over the batch (SURVEY.md §5 'BER before/after ECC').
    per_image=True adds a "per_image" list with each image's report (used
    by the precision-margin validator to attribute errors to covers).

    Re-derives each image's exact on-wire frame from (secret, salt) — the
    AEAD is deterministic given the salt — reads the raw stream bits back
    from the stego batch, and runs utils.metrics.ecc_report per image. This
    is the number that explains verify/re-salt behavior: post-ECC BER > 0 on
    any image means AEAD failure and a re-salt retry.
    """
    if (password is None) == (master_key is None):
        raise ValueError("exactly one of password/master_key required")
    if params.adaptive_alpha or params.cover_dependent_path \
            or params.per_image_walk:
        raise StegoError("channel_report supports the shared-walk corner "
                         "path only")
    from steganosaurus_jax.spectral import corner as corner_mod
    from steganosaurus_jax.utils import metrics

    if layout == "nchw":
        B, _, H, W = stego.shape
    else:
        B, H, W = stego.shape[:3]
    PH, PW = spectral.fft_dims(H, W)

    frames, frame_lens, clens = [], [], []
    flags = (header_mod.flags_with_qim(0, params.qim) if params.qim else 0)
    if params.rs:
        flags |= header_mod.FLAG_RS_PAYLOAD
    for secret, salt in zip(secrets, salts):
        with crypto.derive_keys_vault(password, master_key, salt=salt,
                                      iters=params.pbkdf2_iter) as km:
            hdr_bytes, ct, tag = header_mod.seal_stream(
                secret, km, flags, params.pad_quantum)
        clens.append(len(ct))
        h = ecc.rep3_encode(bit_ops.bits_from_bytes(hdr_bytes))
        if params.rs:
            p_ = bit_ops.bits_from_bytes(
                rs_mod.rs_encode_interleaved(ct + tag))
        else:
            p_ = ecc.rep7_encode(bit_ops.bits_from_bytes(ct + tag))
        frames.append(np.concatenate([np.asarray(h), np.asarray(p_)]))
        frame_lens.append(len(frames[-1]))

    nmax = max(frame_lens)
    bucket = -(-nmax // 4096) * 4096
    (plane, y, x, jit), nprod = _walk_indices_device(
        password, master_key, params, PH, PW, nmax, 0, bucket, mesh)
    if nprod < nmax:
        raise StegoError("stego batch cannot carry the claimed frames")

    if isinstance(stego, jnp.ndarray):
        stego_d = stego
    elif mesh is not None:
        stego_d = pbatch.shard_batch(np.ascontiguousarray(stego), mesh)
    else:
        stego_d = np.ascontiguousarray(stego)

    Ky, Kx = corner_mod.corner_dims(PH, PW, params.rmax)
    has_jitter = params.jitter != 0.0
    bits_fn = pbatch.corner_bits_core(H, W, Ky, Kx, params.center, mesh,
                                      has_jitter, layout=layout,
                                      qim_levels=params.qim)
    alpha = jnp.float32(params.alpha)
    if has_jitter or params.qim:
        # (nmax, bucket) — the same statics key the embed side used, so the
        # report reuses the embed's cached maps instead of building a second
        # functionally-identical pair.
        maps, _ = _corner_statics_device(password, master_key, params, PH,
                                         PW, nmax, bucket, Ky, Kx, mesh)
        bd = bits_fn(stego_d, *_read_maps(maps, params), alpha)
    else:
        bd = bits_fn(stego_d, alpha)
    raw_fn = pbatch.corner_gather_raw_core(mesh,
                                           B=B if mesh is None else 0)
    got = pbatch.unpack_words_host(np.asarray(raw_fn(bd, plane, y, x)),
                                   bucket)

    reports = [metrics.ecc_report(
        frames[i], got[i, : frame_lens[i]], _HEADER_STREAM_BITS,
        rs_payload_bytes=(clens[i] + 16) if params.rs else 0)
        for i in range(B)]
    out = {k: float(np.mean([r[k] for r in reports])) for k in reports[0]}
    if per_image:
        out["per_image"] = [
            {k: float(v) for k, v in r.items()} for r in reports]
    return out


def _bucket_sel(idxs: list[int], B: int) -> tuple[np.ndarray, int]:
    """(padded index array, real count): pad a failed-image subset to the
    next power-of-2 size (capped at B) by repeating the first index.

    jax.jit compiles per input SHAPE, and rotating-salt serving draws a
    different failure count every batch — without bucketing, the recovery
    passes paid one fresh 4K module compile per distinct count (measured:
    the soft fallback cut the bench's rotating-salt stage from ~220 to
    9 img/s before this fix). Power-of-2 buckets bound the variants at
    log2(B), all persistent-compile-cached; duplicate rows' results are
    ignored by the caller (rows [0, real count) map to idxs)."""
    n = len(idxs)
    size = 1
    while size < n:
        size *= 2
    size = min(size, B)
    return np.asarray(idxs + [idxs[0]] * (size - n)), n


class _ExtractJob:
    """An in-flight batch extraction: the fused header+payload device pass is
    DISPATCHED at construction (JAX async dispatch — no host block) and only
    pulled in finalize(). This split is the host/device pipelining seam:
    while batch N's gather-decode runs on device, the host can prep, upload,
    and dispatch batch N+1 (pipeline.stream drives it)."""

    def __init__(self, imgs, password, master_key, params, mesh, clen_hint,
                 layout="nhwc"):
        if (password is None) == (master_key is None):
            raise ValueError("exactly one of password/master_key required")
        if params.cover_dependent_path:
            raise StegoError(
                "cover_dependent_path is per-image; use extract_array")
        if layout == "nchw":
            if params.adaptive_alpha:
                raise StegoError("layout='nchw' is corner-path only")
            self.B, _, H, W = imgs.shape
        else:
            self.B, H, W = imgs.shape[:3]
        self._HW = (H, W)
        self._layout = layout
        PH, PW = spectral.fft_dims(H, W)
        self._key = (password, master_key)
        self._params, self._mesh = params, mesh
        self._dims = (PH, PW)

        if isinstance(imgs, jnp.ndarray):
            imgs_d = imgs  # already device-resident (e.g. embed's output)
        elif mesh is not None:
            imgs_d = pbatch.shard_batch(np.ascontiguousarray(imgs), mesh)
        else:
            imgs_d = np.ascontiguousarray(imgs)
        self._imgs_d = imgs_d

        alpha = jnp.float32(params.alpha)
        self._alpha = alpha
        # Assumed QIM level for the speculative fused pass (pipeline/qim.py):
        # headers always decode (they are never QIM-written), and images
        # whose header-carried L differs from the assumption get a corrected
        # payload pass in finalize — a wrong assumption never misdecodes.
        self._qim = params.qim
        # Assumed payload FEC for the speculative fused pass, same
        # correction contract as the QIM assumption: images whose header
        # flag disagrees get a corrected payload-only pass in finalize.
        self._rs = params.rs
        if params.qim:
            from steganosaurus_jax.pipeline import qim as _qim_mod

            _qim_mod.validate(params)
        self._use_corner = not params.adaptive_alpha
        if self._use_corner:
            from steganosaurus_jax.spectral import corner as corner_mod

            Ky, Kx = corner_mod.corner_dims(PH, PW, params.rmax)
            self._corner_kk = (Ky, Kx)
            self._has_jitter = params.jitter != 0.0
            self._bd_cache: dict[object, object] = {}
        else:
            analyze = pbatch.batched_analyze_core(
                H, W, params.center, mesh, adaptive=params.adaptive_alpha)
            self._spec, self._med = analyze(imgs_d)  # one FFT, device-resident

        # Walk capacity upper bound: each accepted bit marks a bin + its
        # conjugate, so no image can carry more than this many bits. Bounds
        # both the gather size under a corrupt header clen (the reference
        # hangs here, doc/TESTING.md:151-156) and oversized clen_hints.
        self._cap_bits = 3 * PH * PW // 2
        self._hint_bits = (min(self._payload_bits(clen_hint, params.rs),
                               self._cap_bits) if clen_hint else 0)
        self._covered_payload_bits = 0  # set by the with_header dispatch
        self._result: list[bytes | None] | None = None
        # Fused pass: header + hinted payload in one device round-trip
        # (dispatch only; the pull happens in finalize). With no hint the
        # payload section is empty and the second pass always runs.
        self._words_d, self._pass_info = self._dispatch_pass(
            self._hint_bits, True)

    @staticmethod
    def _payload_bits(clen: int, rs: bool) -> int:
        """Payload stream bits for a ciphertext length, by FEC mode."""
        return (rs_mod.coded_len(clen + 16) * 8 if rs
                else (clen + 16) * 8 * 7)

    def _bit_dense_for(self, nbits: int, bucket: int, L: int):
        """Dense decoded-bit corner (mesh path) under QIM level L — plus
        the dense decision values (mesh soft fallback) when
        soft_decode_fallback is on, as a (bits, values) tuple. With no
        jitter and no QIM the result is independent of the read length (one
        FFT per batch); static jd/dither maps must cover every read slot, so
        a longer second pass re-analyzes."""
        password, master_key = self._key
        PH, PW = self._dims
        H, W = self._HW
        Ky, Kx = self._corner_kk
        has_maps = self._has_jitter or L
        key = 0 if not has_maps else (nbits, bucket, L)
        bd = self._bd_cache.get(key)
        if bd is None:
            bits_fn = pbatch.corner_bits_core(
                H, W, Ky, Kx, self._params.center, self._mesh,
                self._has_jitter, layout=self._layout, qim_levels=L,
                with_values=bool(self._params.soft_decode_fallback))
            if has_maps:
                maps, _ = _corner_statics_device(
                    password, master_key, self._params, PH, PW, nbits,
                    bucket, Ky, Kx, self._mesh, qim_levels=L)
                bd = bits_fn(self._imgs_d,
                             *_read_maps(maps, self._params, L), self._alpha)
            else:
                bd = bits_fn(self._imgs_d, self._alpha)
            self._bd_cache[key] = bd
        return bd

    def _dispatch_pass(self, payload_stream_bits: int, with_header: bool,
                       qim: int | None = None, rs: bool | None = None):
        """Dispatch gather + device-ECC-decode for one pass; returns
        (words_d, info): the (B, words) DEVICE array (not pulled) plus the
        section layout `(hdr_bits, n_slots, rep)` when the pass ALSO
        carries the inline soft-decision decode (single-chip fused corner
        path with soft_decode_fallback on — parallel.batch
        corner_extract_fused_core with_soft), else None. Bits past walk
        exhaustion are garbage (last-bin re-reads) — consumers only use
        bytes their authenticated clen covers, or fail AEAD. `qim` is the
        QIM level the payload section decodes under (default: the assumed
        self._qim; the header section always decodes by the hard rule).

        The TOTAL frame length (header + payload stream bits) is bucketed to
        a 4096 multiple and the walk/statics cached as (nbits=total,
        bucket=ceil4096(total)) — EXACTLY how embed_batch keys them for a
        frame of the same length. Nearby payload sizes share one compiled
        graph, and an embed->extract round trip (or verify-mode embed)
        shares ONE device index upload and ONE jitter-statics build instead
        of building per side."""
        password, master_key = self._key
        PH, PW = self._dims
        L = self._qim if qim is None else qim
        rep = 1 if (self._rs if rs is None else rs) else 7
        hdr = _HEADER_STREAM_BITS
        if payload_stream_bits:
            total = hdr + payload_stream_bits
            bucket_total = -(-total // 4096) * 4096
        else:  # header-only probe (no hint): 912 slots, no rounding
            total = bucket_total = hdr
            L = 0  # header decoding never involves QIM
        hdr_bits = hdr if with_header else 0
        skip = 0 if with_header else hdr
        if with_header:
            # Slots [total, bucket_total) are tail-padded DUPLICATES of slot
            # total-1 (embed's padding semantics), not real walk bins — only
            # the unrounded payload bits are genuinely readable.
            self._covered_payload_bits = total - hdr
        (pl, yy, xx, jj), _ = _walk_indices_device(
            password, master_key, self._params, PH, PW, total, skip,
            bucket_total - skip, self._mesh)
        if self._use_corner and self._mesh is None:
            # single-chip: FFT-read + gather + ECC decode fused into ONE
            # dispatched module (one launch, no intermediate pull). A
            # rare second pass (clen_hint too small) re-runs the FFT read —
            # acceptable: the hint covers it on every serving path. With
            # soft_decode_fallback on, the SAME module also emits the soft
            # decode so AEAD failures resolve with no extra dispatch.
            H, W = self._HW
            Ky, Kx = self._corner_kk
            with_soft = bool(self._params.soft_decode_fallback)
            info = ((hdr_bits, bucket_total - skip, rep)
                    if with_soft else None)
            core = pbatch.corner_extract_fused_core(
                H, W, Ky, Kx, self._params.center, self._has_jitter,
                self._layout, hdr_bits, self.B, qim_levels=L,
                payload_rep=rep, with_soft=with_soft)
            if self._has_jitter or L:
                maps, _ = _corner_statics_device(
                    password, master_key, self._params, PH, PW, total,
                    bucket_total, Ky, Kx, None, qim_levels=L)
                return core(self._imgs_d,
                            *_read_maps(maps, self._params, L),
                            self._alpha, pl, yy, xx), info
            return core(self._imgs_d, self._alpha, pl, yy, xx), info
        if self._use_corner:
            # mesh-sharded corner gather: soft fallback rides the dense
            # decision values from corner_bits_core with_values
            with_soft = bool(self._params.soft_decode_fallback)
            core = pbatch.corner_gather_decode_core(
                self._mesh, hdr_stream_bits=hdr_bits, payload_rep=rep,
                with_soft=with_soft)
            dense = self._bit_dense_for(total, bucket_total, L)
            if with_soft:
                info = (hdr_bits, bucket_total - skip, rep)
                return core(dense[0], dense[1], pl, yy, xx), info
            return core(dense, pl, yy, xx), None
        # legacy-spectra path (adaptive-alpha): same fused soft emission as
        # the corner path — the fallback covers every batch extract mode
        with_soft = bool(self._params.soft_decode_fallback)
        info = ((hdr_bits, bucket_total - skip, rep) if with_soft else None)
        core = pbatch.batched_gather_decode_core(
            self._params.adaptive_alpha, self._mesh, hdr_stream_bits=hdr_bits,
            payload_rep=rep, with_soft=with_soft)
        return core(self._spec, self._med, pl, yy, xx, jj,
                    self._alpha), info

    @staticmethod
    def _to_bufs(words_d) -> list[bytes]:
        words = np.asarray(words_d)  # the blocking device pull
        return [w.view(np.uint32).astype(">u4").tobytes() for w in words]

    @staticmethod
    def _split_pass(words_d, info):
        """(hard bufs pulled NOW, soft device array or None). A with_soft
        pass (corner_extract_fused_core) returns (hard, soft) device
        arrays; the soft side stays ON DEVICE until a failure needs it —
        the happy path pays zero extra pull bytes."""
        if info is None:
            return _ExtractJob._to_bufs(words_d), None
        hard_d, soft_d = words_d
        return _ExtractJob._to_bufs(hard_d), soft_d

    @staticmethod
    def _soft_sections(soft_d, info):
        """Pull a pass's soft output (bytes already computed in HBM — a
        transfer, not a dispatch) and split per-image rows into
        (soft bufs, RS confidences). Row layout: [soft words | conf
        bitcast (RS only)]; word counts mirror the device-side
        _pack_bits_words shapes exactly (asserted)."""
        hdr_bits, n_slots, rep = info
        hw = (hdr_bits // 3 + 31) // 32 if hdr_bits else 0
        pw = ((n_slots - hdr_bits) // rep + 31) // 32
        wh = hw + pw
        c = (n_slots - hdr_bits) // 8 if rep == 1 else 0
        words = np.asarray(soft_d)  # the blocking pull
        if words.shape[1] != wh + c:  # survives python -O, unlike assert
            raise RuntimeError(
                f"soft-row word-layout mismatch: device rows have "
                f"{words.shape[1]} words, host expects {wh}+{c}")
        soft = [w[:wh].view(np.uint32).astype(">u4").tobytes()
                for w in words]
        confs = words[:, wh:].view(np.float32) if c else None
        return soft, confs

    def _open_payload(self, hdr, payload: bytes, conf=None) -> bytes | None:
        """FEC-decode a payload byte section under `hdr` and AEAD-open it.
        `conf` (RS wire mode only): per-coded-byte confidences from a soft
        pass — errors-and-erasures decode (ops/rs.py). Returns the secret
        or None (anything short/corrupt fails closed via AEAD)."""
        password, master_key = self._key
        if hdr.flags & header_mod.FLAG_RS_PAYLOAD:
            ncoded = rs_mod.coded_len(hdr.clen + 16)
            if len(payload) < ncoded:
                return None
            if conf is not None:
                rest, _ok = rs_mod.rs_decode_interleaved_soft(
                    payload[:ncoded], hdr.clen + 16, conf[:ncoded])
            else:
                rest, _ok, _ = rs_mod.rs_decode_interleaved(
                    payload[:ncoded], hdr.clen + 16)
        else:
            rest = payload[: hdr.clen + 16]
        if len(rest) < hdr.clen + 16:
            return None
        ct, tag = rest[: hdr.clen], rest[hdr.clen: hdr.clen + 16]
        with crypto.derive_keys_vault(password, master_key, salt=hdr.salt,
                                      iters=self._params.pbkdf2_iter) as km:
            return header_mod.maybe_unpad(
                km.open(hdr.to_bytes(), ct, tag), hdr.flags)

    def _dispatch_piw_pass(self, idxs: list[int], headers: list,
                           qim: int = 0, rs: bool = False) -> list[bytes]:
        """Per-image-walk payload pass for the header-flagged images
        (pipeline/header.py FLAG_PER_IMAGE_WALK, auto-detected in
        finalize): salt-keyed chained walks expanded on a thread pool from
        each image's decoded header salt, then ONE fused
        corner-FFT + per-image gather + ECC-decode module
        (parallel.batch.corner_piw_extract_core). `qim` is the group's
        header-carried QIM level (payload slots decode by the QIM rule with
        the shared slot-aligned dither). Returns payload byte buffers
        aligned with `idxs`."""
        from concurrent.futures import ThreadPoolExecutor

        password, master_key = self._key
        PH, PW = self._dims
        params = self._params
        path_key = crypto.derive_path_key(password, master_key, None)
        kw, kr, kg, kb = crypto.derive_turtle_keys(path_key)
        *_, vis = keystream.header_walk_with_visited(
            kw, (kr, kg, kb), PH, PW, params.rmin, params.rmax,
            params.density, params.jitter, _HEADER_STREAM_BITS)

        sel, _nreal = _bucket_sel(list(idxs), self.B)
        idxs = [int(i) for i in sel]  # padded; rows [0, nreal) map to input
        needs = [min(self._payload_bits(headers[i].clen, rs),
                     self._cap_bits) for i in idxs]
        n = -(-max(needs) // 4096) * 4096

        def expand(k):
            # allow_short inside: a corrupted clen degrades to garbage
            # trailing bits (AEAD rejects) instead of aborting the batch;
            # consults the stream prefetch cache (same key as embed's when
            # clen is below the capacity bound)
            return _piw_expand_one(path_key, headers[idxs[k]].salt, params,
                                   PH, PW, needs[k], vis)

        with ThreadPoolExecutor(max_workers=min(8, len(idxs))) as ex:
            outs = list(ex.map(expand, range(len(idxs))))

        Bs = len(idxs)
        plane = np.empty((Bs, n), np.int32)
        yarr = np.empty((Bs, n), np.int32)
        xarr = np.empty((Bs, n), np.int32)
        jarr = np.empty((Bs, n), np.float32)
        for k, (pp, py, px, pj, _np_) in enumerate(outs):
            m = needs[k]
            for dst, src in ((plane, pp), (yarr, py), (xarr, px),
                             (jarr, pj)):
                dst[k, :m] = src[:m]
                dst[k, m:] = dst[k, m - 1]
        imgs_sub = (self._imgs_d[sel] if sel.size != self.B
                    else self._imgs_d)
        H, W = self._HW
        if self._use_corner:
            from steganosaurus_jax.spectral import corner as corner_mod

            Ky, Kx = corner_mod.corner_dims(PH, PW, params.rmax)
            # subset batches rarely divide the mesh; jit without shardings
            # accepts whatever placement the inputs carry
            core_mesh = (self._mesh if self._mesh is not None
                         and len(idxs) == self.B
                         and self.B % self._mesh.size == 0 else None)
            core = pbatch.corner_piw_extract_core(
                H, W, Ky, Kx, params.center, self._layout, 0, core_mesh,
                qim_levels=qim, qim_hdr=0, payload_rep=1 if rs else 7)
            if qim:
                # payload-only slots: frame slot of payload bit k is
                # hdr + k, so slice the slot-aligned dither (pipeline/qim.py)
                dith = qim_mod.dither_angles(
                    path_key, qim, _HEADER_STREAM_BITS + n)[
                    _HEADER_STREAM_BITS:]
                words = core(imgs_sub, plane, yarr, xarr, jarr,
                             jnp.asarray(dith), self._alpha)
            else:
                words = core(imgs_sub, plane, yarr, xarr, jarr, self._alpha)
        else:
            core = pbatch.batched_gather_decode_core(
                params.adaptive_alpha, None, hdr_stream_bits=0,
                shared_idx=False, payload_rep=1 if rs else 7)
            words = core(self._spec[sel], self._med[sel], plane, yarr,
                         xarr, jarr, self._alpha)
        return self._to_bufs(words)

    def finalize(self) -> list[bytes | None]:
        """Pull the fused pass, parse headers, run the payload second pass if
        the hint was too small, AEAD-open everything. Idempotent: repeat
        calls return the cached result."""
        if self._words_d is None:
            if self._result is not None:
                return self._result
            raise StegoError("extract job already failed; re-dispatch it")
        password, master_key = self._key
        bufs, soft0_d = self._split_pass(self._words_d, self._pass_info)
        self._words_d = None
        # lazy soft pulls, memoized per pass: nothing is transferred until
        # a failure (or unparseable header) actually needs the soft words
        pulled: dict[int, tuple] = {}

        def _soft_of(soft_d, info):
            key = id(soft_d)
            if key not in pulled:
                pulled[key] = self._soft_sections(soft_d, info)
            return pulled[key]

        def _parse_hdr(buf) -> Header | None:
            hb = buf[:header_mod.FIXED_LEN]
            if hb[:4] != header_mod.MAGIC or hb[4] != header_mod.VERSION:
                return None
            if header_mod.qim_levels(hb[5]) == 1:
                return None            # invalid QIM level: corrupt header
            return Header.from_bytes(hb)

        headers: list[Header | None] = [_parse_hdr(b) for b in bufs]
        if soft0_d is not None and any(h is None for h in headers):
            # a header the hard Rep-3 majority corrupted can still parse
            # from the matched-filter sections of the same fused pass
            soft_bufs0, _ = _soft_of(soft0_d, self._pass_info)
            for i, h in enumerate(headers):
                if h is None:
                    headers[i] = _parse_hdr(soft_bufs0[i])
        # Channel-coherent stegos (pipeline/header.py FLAG_COHERENT,
        # auto-detected): header AND payload live in the common-mode phase
        # of all three planes per site, which the fused single-plane
        # gather cores cannot read — their headers fail BOTH parses above,
        # so every still-unparsed row gets the single-image extractor's
        # two-rule header trial (pipeline/extract.py reads the coherent
        # rule natively). Genuinely corrupt rows pay one per-image FFT +
        # two header reads there and stay None — an error-path cost.
        # Parsed headers that still carry the flag (pre-trial layout:
        # standard header + coherent payload) route the same way.
        coh_idx = [i for i, h in enumerate(headers) if h is None
                   or (h.flags & header_mod.FLAG_COHERENT)]
        coh_set = set(coh_idx)
        piw_idx = [i for i, h in enumerate(headers) if h is not None
                   and (h.flags & header_mod.FLAG_PER_IMAGE_WALK)
                   and i not in coh_set]
        piw_set = set(piw_idx)

        def _mode(h) -> tuple[int, bool]:
            """(QIM level, RS flag) carried by a header (pipeline/header.py;
            usually one group — homogeneous batches)."""
            return (header_mod.qim_levels(h.flags),
                    bool(h.flags & header_mod.FLAG_RS_PAYLOAD))

        shared_by_mode: dict[tuple[int, bool], list[int]] = {}
        for i, h in enumerate(headers):
            if h is not None and i not in piw_set and i not in coh_set:
                shared_by_mode.setdefault(_mode(h), []).append(i)
        if not shared_by_mode and not piw_idx and not coh_idx:
            self._result = [None] * self.B
            return self._result
        payloads: list[bytes | None] = [None] * self.B
        # (soft device array, pass info, payload byte offset) per image —
        # consulted (and pulled) only if that image's hard open fails
        soft_src: list[tuple | None] = [None] * self.B
        for (L, R), idxs in shared_by_mode.items():
            clens = {i: headers[i].clen for i in idxs}
            big = [i for i in idxs
                   if self._payload_bits(clens[i], R) >= self._cap_bits]
            if big and soft0_d is not None:
                # A Rep-3-corrupted clen in ONE parseable header blows this
                # whole group's pass (and its host walk expansion) to full
                # capacity. Cross-check the matched-filter header of the
                # probe/hint pass and size by the smaller claim — the open
                # loop still tries both headers, and an undersized pass
                # only costs that one image the retry pass.
                soft_bufs0, _ = _soft_of(soft0_d, self._pass_info)
                for i in big:
                    h2 = _parse_hdr(soft_bufs0[i])
                    if h2 is not None:
                        clens[i] = min(clens[i], h2.clen)
            need = min(self._payload_bits(max(clens.values()), R),
                       self._cap_bits)
            if (L == self._qim and R == self._rs
                    and need <= self._covered_payload_bits):
                # the fused pass already decoded this group's payload rule:
                # payload bytes follow the 40-byte header block
                for i in idxs:
                    payloads[i] = bufs[i][40:]
                    if soft0_d is not None:
                        soft_src[i] = (soft0_d, self._pass_info, 40)
            else:  # hint too small/absent, or the assumed QIM/FEC mode was
                #    wrong for this group: payload-only corrected pass
                gw, ginfo = self._dispatch_pass(need, False, qim=L, rs=R)
                grp, gsoft_d = self._split_pass(gw, ginfo)
                for i in idxs:
                    payloads[i] = grp[i]
                    if gsoft_d is not None:
                        soft_src[i] = (gsoft_d, ginfo, 0)
        if piw_idx:
            # header-flagged images: salt-keyed per-image payload walks
            # (auto-detected; the fused pass's shared-walk payload section
            # does not apply to them), grouped by (QIM level, FEC mode)
            piw_by_mode: dict[tuple[int, bool], list[int]] = {}
            for i in piw_idx:
                piw_by_mode.setdefault(_mode(headers[i]), []).append(i)
            for (L, R), idxs in piw_by_mode.items():
                for i, buf in zip(idxs, self._dispatch_piw_pass(
                        idxs, headers, L, rs=R)):
                    payloads[i] = buf

        resolved: dict[int, bytes | None] = {}
        if coh_idx:
            # per-image resolution (see coh_idx above): pull just those
            # rows and run the full single-image extract — it auto-detects
            # the coherent wire mode from the header flag and carries its
            # own soft retry, so these images skip the fused soft paths
            import importlib

            # (attribute import would shadow: pipeline/__init__ re-exports
            # an `extract` FUNCTION under the submodule's name)
            _extract_mod = importlib.import_module(
                "steganosaurus_jax.pipeline.extract")
            for i in coh_idx:
                img = np.asarray(self._imgs_d[i])
                if self._layout == "nchw":
                    img = np.ascontiguousarray(img.transpose(1, 2, 0))
                try:
                    resolved[i] = _extract_mod.extract_array(
                        img, password=password, master_key=master_key,
                        params=self._params)
                except StegoError:
                    resolved[i] = None

        out: list[bytes | None] = []
        for i, hdr in enumerate(headers):
            if i in resolved:
                out.append(resolved[i])
                continue
            if hdr is None or payloads[i] is None:
                out.append(None)
                continue
            # hard sections first (reference-equivalent decode), then the
            # matched-filter soft sections of the SAME dispatched pass —
            # an AEAD failure costs a lazy pull, never an extra dispatch
            got = self._open_payload(hdr, payloads[i])
            soft_pay = None
            if got is None and soft_src[i] is not None:
                sd, info, off = soft_src[i]
                soft_bufs, confs = _soft_of(sd, info)
                conf = confs[i] if confs is not None else None
                soft_pay = (soft_bufs[i][off:], conf)
                got = self._open_payload(hdr, *soft_pay)
            if got is None and soft0_d is not None:
                # last inline resort: a PARSEABLE hard header can still
                # carry Rep-3-corrupted salt/clen/nonce/flag bits (every
                # open above fails AEAD no matter how good the payload
                # is); the probe/hint pass's matched-filter header
                # sections usually hold the true bytes. Same decode mode
                # assumed — a mode mismatch fails AEAD again and falls
                # through to the retry pass, which re-decodes under the
                # corrected mode.
                soft_bufs0, _ = _soft_of(soft0_d, self._pass_info)
                h2 = _parse_hdr(soft_bufs0[i])
                if h2 is not None and h2.to_bytes() != hdr.to_bytes():
                    got = self._open_payload(h2, payloads[i])
                    if got is None and soft_pay is not None:
                        got = self._open_payload(h2, *soft_pay)
            out.append(got)
        if (self._params.soft_decode_fallback and self._use_corner
                and any(h is not None and o is None
                        for h, o in zip(headers, out))):
            self._soft_retry_failed(headers, out)
        self._result = out
        return out

    def _soft_retry_failed(self, headers, out) -> None:
        """Soft-decision re-decode for images whose header parsed but AEAD
        failed (rebuild-only recovery; ops/ecc.rep_decode_soft): ONE fused
        module per failure class re-reads header AND payload with
        matched-filter combining of the Rep-3/Rep-7 copies. Recovers
        margin-failure images the hard majority loses — including stegos
        the reference binary itself cannot extract. Mutates `out` in place;
        images that still fail stay None."""
        password, master_key = self._key
        params = self._params
        PH, PW = self._dims
        H, W = self._HW
        Ky, Kx = self._corner_kk
        hdr_n = _HEADER_STREAM_BITS
        # coherent stegos are excluded: they were resolved per image by the
        # single-image extractor (which runs its own soft retry), and the
        # fused single-plane soft readers here cannot decode their rule
        failed = [i for i, (h, o) in enumerate(zip(headers, out))
                  if h is not None and o is None
                  and not (h.flags & header_mod.FLAG_COHERENT)]

        def open_from(buf, conf=None):
            """AEAD-open from a soft-pass buffer. With `conf` (RS wire mode,
            per-coded-byte confidence from the device pass) the payload
            section holds raw coded bytes: errors-and-erasures decode them
            (ops/rs.py) before the open."""
            hb = buf[:header_mod.FIXED_LEN]
            if hb[:4] != header_mod.MAGIC or hb[4] != header_mod.VERSION:
                return None
            h2 = Header.from_bytes(hb)
            if conf is not None:
                ncoded = rs_mod.coded_len(h2.clen + 16)
                if len(buf) - 40 < ncoded:
                    return None
                rest, _ok = rs_mod.rs_decode_interleaved_soft(
                    buf[40: 40 + ncoded], h2.clen + 16, conf[:ncoded])
            else:
                rest = buf[40:][: h2.clen + 16]
            if len(rest) < h2.clen + 16:
                return None
            ct, tag = rest[: h2.clen], rest[h2.clen: h2.clen + 16]
            with crypto.derive_keys_vault(password, master_key,
                                          salt=h2.salt,
                                          iters=params.pbkdf2_iter) as km:
                return header_mod.maybe_unpad(
                    km.open(hb, ct, tag), h2.flags)

        def _mode(h) -> tuple[int, bool]:
            return (header_mod.qim_levels(h.flags),
                    bool(h.flags & header_mod.FLAG_RS_PAYLOAD))

        def _parse_soft_header(buf):
            hb = buf[:header_mod.FIXED_LEN]
            if hb[:4] != header_mod.MAGIC or hb[4] != header_mod.VERSION:
                return None
            if header_mod.qim_levels(hb[5]) == 1:
                return None            # invalid QIM level: corrupt header
            return Header.from_bytes(hb)

        path_key = crypto.derive_path_key(password, master_key, None)

        def run_shared(grp, hdrs, L, R):
            need = min(max(self._payload_bits(hdrs[i].clen, R)
                           for i in grp), self._cap_bits)
            total = hdr_n + need
            bucket_total = -(-total // 4096) * 4096
            (pl, yy, xx, _jj), _ = _walk_indices_device(
                password, master_key, params, PH, PW, total, 0,
                bucket_total, None)
            sel, _nreal = _bucket_sel(grp, self.B)
            imgs_sub = (self._imgs_d[sel] if sel.size != self.B
                        else self._imgs_d)
            core = pbatch.corner_soft_extract_core(
                H, W, Ky, Kx, params.center, self._has_jitter, self._layout,
                hdr_n, qim_levels=L, payload_rep=1 if R else 7)
            if self._has_jitter or L:
                maps, _ = _corner_statics_device(
                    password, master_key, params, PH, PW, total,
                    bucket_total, Ky, Kx, None, qim_levels=L)
                words = core(imgs_sub, *_read_maps(maps, params, L),
                             self._alpha, pl, yy, xx)
            else:
                words = core(imgs_sub, self._alpha, pl, yy, xx)
            conf_np = None
            if R:
                words, conf_d = words
                conf_np = np.asarray(conf_d)
            return self._to_bufs(words), conf_np

        def run_piw(grp, hdrs, L, R):
            sel, _nreal = _bucket_sel(grp, self.B)
            padded = [int(i) for i in sel]
            needs = [hdr_n + min(self._payload_bits(hdrs[i].clen, R),
                                 self._cap_bits) for i in padded]
            bucket_total = -(-max(needs) // 4096) * 4096
            plane, yarr, xarr, jarr = _piw_walk_arrays(
                password, master_key, params, PH, PW,
                [hdrs[i].salt for i in padded], needs, bucket_total,
                strict=False)
            imgs_sub = (self._imgs_d[sel] if sel.size != self.B
                        else self._imgs_d)
            core = pbatch.corner_soft_extract_core(
                H, W, Ky, Kx, params.center, False, self._layout, hdr_n,
                per_image=True, qim_levels=L, payload_rep=1 if R else 7)
            if L:
                dith = qim_mod.dither_angles(path_key, L, bucket_total)
                words = core(imgs_sub, plane, yarr, xarr, jarr,
                             jnp.asarray(dith), self._alpha)
            else:
                words = core(imgs_sub, plane, yarr, xarr, jarr, self._alpha)
            conf_np = None
            if R:
                words, conf_d = words
                conf_np = np.asarray(conf_d)
            return self._to_bufs(words), conf_np

        # Two rounds: round 1 groups by the HARD-pass header mode; a raw
        # channel flip that survives the hard Rep-3 majority can corrupt the
        # flags byte (phantom QIM/RS/PIW bits) and misroute the payload
        # decode. Header bins always use the plain half-plane decision rule
        # regardless of the assumed mode (corner.decision_values_dense_qim),
        # so the SOFT buffer's header is mode-reliable: round 2 retries any
        # still-failing image whose soft header disagrees with the mode (or
        # salt/clen) it was decoded under.
        cur = {i: headers[i] for i in failed}
        for round_ in range(2):
            shared_by_mode: dict[tuple[int, bool], list[int]] = {}
            piw_by_mode: dict[tuple[int, bool], list[int]] = {}
            for i, h in cur.items():
                grp = (piw_by_mode
                       if h.flags & header_mod.FLAG_PER_IMAGE_WALK
                       else shared_by_mode)
                grp.setdefault(_mode(h), []).append(i)
            retry: dict[int, Header] = {}

            def _consume(grp, bufs, conf_np):
                for k, i in enumerate(grp):
                    got = open_from(
                        bufs[k], conf_np[k] if conf_np is not None else None)
                    if got is not None:
                        out[i] = got
                    elif round_ == 0:
                        h2 = _parse_soft_header(bufs[k])
                        if h2 is not None and (
                                h2.flags != cur[i].flags
                                or h2.clen != cur[i].clen
                                or h2.salt != cur[i].salt):
                            retry[i] = h2

            for (L, R), grp in shared_by_mode.items():
                bufs, conf_np = run_shared(grp, cur, L, R)
                _consume(grp, bufs, conf_np)
            for (L, R), grp in piw_by_mode.items():
                bufs, conf_np = run_piw(grp, cur, L, R)
                _consume(grp, bufs, conf_np)
            cur = retry
            if not cur:
                break


def extract_dispatch(
    imgs: np.ndarray,
    password: str | None = None,
    master_key: bytes | None = None,
    params: Params = Params(),
    mesh=None,
    clen_hint: int | None = None,
    layout: str = "nhwc",
) -> _ExtractJob:
    """Async-dispatch a batch extraction; call .finalize() for the results.
    Host work between dispatch and finalize overlaps the device pass."""
    return _ExtractJob(imgs, password, master_key, params, mesh, clen_hint,
                       layout)


def extract_batch(
    imgs: np.ndarray,
    password: str | None = None,
    master_key: bytes | None = None,
    params: Params = Params(),
    mesh=None,
    clen_hint: int | None = None,
    layout: str = "nhwc",
) -> list[bytes | None]:
    """Extract secrets from a batch of stego images (shared key).

    Returns one bytes per image, or None where extraction failed (bad magic /
    truncated / auth failure) — batch semantics must not abort the whole batch
    on one bad image.

    clen_hint: expected on-wire ciphertext length in bytes — the secret
    length, or header_mod.padded_len(secret_len, q) when the embed used
    Params.pad_quantum=q (an unpadded hint undersizes the fused pass and
    costs a second dispatch per batch). When
    given, the header and hinted payload are gathered AND ECC-decoded in ONE
    device pass (device decode shrinks the pull ~250x; the link, not the
    gather, dominates extract latency). Images whose actual header clen
    exceeds the hint fall back to a second pass; a wrong hint never
    misdecodes (clen is read from the authenticated header either way).
    """
    return _ExtractJob(imgs, password, master_key, params, mesh,
                       clen_hint, layout).finalize()
