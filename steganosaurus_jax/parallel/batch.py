"""Sharded batch embed/extract device cores (the DP axis).

One traced graph covers the full device side of a batch: u8 decode -> pad ->
FFT -> median -> phase scatter -> IFFT -> quantize for embed; extract splits
into one analyze graph (u8 -> spectrum + medians, kept device-resident) plus
cheap bin-gather graphs, so the header and payload passes reuse one FFT and
the image crosses the host<->device link exactly once, as uint8.

Transfer discipline (keep host<->device traffic small):
- images move as uint8 in native (B, H, W, 3) layout; plane split, f32
  conversion, and padding happen on device inside the graph.
- the turtle walk is salt-independent (steganosaur.cpp:1134-1143), so one
  (nbits,) index set serves the whole batch when the key is shared — indices
  upload once, not B times; only the bit values are per-image.

Batches shard over a `jax.sharding.Mesh` axis named "batch" with no
steady-state collectives (each image is independent — SURVEY.md §2.3).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from steganosaurus_jax import spectral
from steganosaurus_jax.ops import ecc
from steganosaurus_jax.ops import phase as phase_ops
from steganosaurus_jax.parallel import transfer


def make_mesh(n_devices: int | None = None, axis: str = "batch") -> Mesh:
    """1D device mesh over the first `n_devices` local devices."""
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (axis,))


def shard_batch(arr, mesh: Mesh, axis: str = "batch"):
    """Place `arr` with its leading dim sharded over `axis`, rest replicated."""
    spec = P(axis, *([None] * (np.ndim(arr) - 1)))
    return jax.device_put(arr, NamedSharding(mesh, spec))


def _to_planes_dev(img_u8, center: bool, PH: int, PW: int):
    """(H, W, 3) u8 -> (3, PH, PW) f32 padded planes, on device."""
    planes = jnp.transpose(img_u8, (2, 0, 1)).astype(jnp.float32)
    planes = spectral.apply_center(planes, center)
    return spectral.pad_planes(planes, PH, PW)


def _analyze_core(img_u8, *, PH, PW, center, adaptive=True):
    """(H, W, 3) u8 -> (3, PH, PW) c64 spectrum + (3,) medians.

    The exact median costs 32 count-passes over the spectrum (~27 ms/4 imgs
    at 4K); it only feeds adaptive-alpha, so non-adaptive graphs return ones.
    """
    spec = spectral.fft2(_to_planes_dev(img_u8, center, PH, PW))
    if adaptive:
        return spec, spectral.median_abs(spec)
    return spec, jnp.ones((3,), spec.real.dtype)


def _embed_core(img_u8, plane, y, x, bits, jitters, alpha, n_valid=None,
                *, H, W, PH, PW, center, adaptive, soft=False, floor=0.0):
    """Single-image embed: (H, W, 3) u8 -> (H, W, 3) u8 stego.

    The full embed data path of reference do_embed (steganosaur.cpp:907-1109)
    minus host crypto/keystream: center -> pad -> FFT -> [median] ->
    vectorized phase write (Hermitian-half scatter) -> IFFT -> crop ->
    quantize. floor/n_valid: quantization write floor
    (Params.write_floor; ops.phase.write_floor_boost) — n_valid is the
    un-padded slot count so bucket-pad duplicates are not double-counted.
    """
    spec, med = _analyze_core(img_u8, PH=PH, PW=PW, center=center,
                              adaptive=adaptive)
    spec2 = phase_ops.embed_phases(spec, plane, y, x, bits, jitters, alpha,
                                   med, adaptive, gain=(H * W) / (PH * PW),
                                   hermitian_half=True, soft=soft,
                                   floor=floor, img_pixels=float(H) * W,
                                   n_valid=n_valid)
    planes2 = spectral.ifft2_real(spec2)[..., :H, :W]
    planes2 = spectral.apply_center(planes2, center)
    return spectral.from_planes(planes2)


def _read_core(spec, med, plane, y, x, jitters, alpha, *, adaptive):
    """Gather bits from a device-resident spectrum (cheap; no FFT)."""
    return phase_ops.read_phases(spec, plane, y, x, jitters, alpha, med,
                                 adaptive)


@functools.lru_cache(maxsize=32)
def batched_embed_core(H: int, W: int, center: bool, adaptive: bool,
                       mesh: Mesh | None = None, shared_idx: bool = True,
                       pack: bool = False, bits_packed: bool = False,
                       soft: bool = False, floor: float = 0.0):
    """Jitted batched embed core.

    shared_idx=True (one walk for the batch — shared key):
      (imgs (B,H,W,3) u8, plane/y/x (n,) i32, bits (B,n) u8,
       jitters (n,) f32, alpha () f32) -> (B,H,W,3) u8
    shared_idx=False: plane/y/x/jitters are (B, n) per-image.
    pack=True: output is transfer.pack_u8'd f32 words (see transfer
    module); unpack with transfer.unpack_u8(host, (B, H, W, 3)).
    bits_packed=True: bits arrive as (B, n/32) int32 words from
    pack_bits_words_host (32x less upload traffic) and are unpacked on
    device.
    """
    PH, PW = spectral.fft_dims(H, W)
    core = functools.partial(_embed_core, H=H, W=W, PH=PH, PW=PW,
                             center=center, adaptive=adaptive, soft=soft,
                             floor=floor)
    # shared_idx vmaps the index arrays with in_axes=None, NOT broadcast_to:
    # broadcasting makes XLA treat the scatter indices as per-image varying,
    # which compiles to a ~3x slower batched scatter (measured at 4K).
    # floor > 0 appends a trailing n_valid argument (per-image (B,) when
    # per-image walks, scalar when shared) — arity is floor-gated so
    # floor == 0 callers keep the historical 7-arg signature.
    if shared_idx:
        inner = jax.vmap(core,
                         in_axes=(0, None, None, None, 0, None, None, None))
    else:
        inner = jax.vmap(core, in_axes=(0, 0, 0, 0, 0, 0, None, 0))

    def fn(imgs, plane, y, x, bits, jitters, alpha, n_valid=None):
        if bits_packed:
            n = bits.shape[-1] * 32
            bits = jax.vmap(functools.partial(_unpack_bits_words, n=n))(bits)
        if not floor:
            n_valid = (jnp.int32(0) if shared_idx
                       else jnp.zeros(imgs.shape[0], jnp.int32))
        out = inner(imgs, plane, y, x, bits, jitters, alpha, n_valid)
        return transfer.pack_u8(out) if pack else out

    if not floor:
        base = fn
        fn = lambda imgs, plane, y, x, bits, jitters, alpha: base(  # noqa: E731
            imgs, plane, y, x, bits, jitters, alpha)
    if mesh is None:
        return jax.jit(fn)
    shard = NamedSharding(mesh, P("batch"))
    rep = NamedSharding(mesh, P())
    in_sh = ((shard, rep, rep, rep, shard, rep, rep) if shared_idx
             else (shard,) * 6 + (rep,))
    if floor:
        in_sh += (rep,) if shared_idx else (shard,)
    return jax.jit(fn, in_shardings=in_sh, out_shardings=shard)


@functools.lru_cache(maxsize=32)
def batched_analyze_core(H: int, W: int, center: bool,
                         mesh: Mesh | None = None, adaptive: bool = True):
    """Jitted: (B,H,W,3) u8 imgs -> ((B,3,PH,PW) c64 spectra, (B,3) medians).

    Run once per extract batch; outputs stay device-resident for the header
    and payload gather passes. adaptive=False skips the (unused) median.
    """
    PH, PW = spectral.fft_dims(H, W)
    core = functools.partial(_analyze_core, PH=PH, PW=PW, center=center,
                             adaptive=adaptive)
    fn = jax.vmap(core)
    if mesh is None:
        return jax.jit(fn)
    shard = NamedSharding(mesh, P("batch"))
    return jax.jit(fn, in_shardings=(shard,), out_shardings=(shard, shard))


@functools.lru_cache(maxsize=32)
def batched_gather_bits_core(adaptive: bool, mesh: Mesh | None = None,
                             shared_idx: bool = True):
    """Jitted: (spectra, medians, plane/y/x (n,), jitters (n,), alpha) ->
    (B, n) i32 raw bits. Spectra/medians come from batched_analyze_core.
    """
    inner = functools.partial(_read_core, adaptive=adaptive)

    def core(*args):
        return inner(*args).astype(jnp.int32)

    if shared_idx:
        fn = jax.vmap(core, in_axes=(0, 0, None, None, None, None, None))
    else:
        fn = jax.vmap(core, in_axes=(0, 0, 0, 0, 0, 0, None))
    if mesh is None:
        return jax.jit(fn)
    shard = NamedSharding(mesh, P("batch"))
    rep = NamedSharding(mesh, P())
    n_rep = 5 if shared_idx else 1
    n_shard = 2 if shared_idx else 6
    return jax.jit(fn, in_shardings=(shard,) * n_shard + (rep,) * n_rep,
                   out_shardings=shard)


def pack_bits_words_host(bits: np.ndarray) -> np.ndarray:
    """(B, n) 0/1 u8 -> (B, n/32) int32, MSB-first big-endian byte order —
    host-side twin of _pack_bits_words. The embed path uploads bit frames as
    words: 32x fewer bytes than one u8 per bit."""
    B, n = bits.shape
    assert n % 32 == 0
    byts = np.packbits(bits, axis=1).reshape(B, n // 32, 4).astype(np.uint32)
    words = ((byts[:, :, 0] << 24) | (byts[:, :, 1] << 16)
             | (byts[:, :, 2] << 8) | byts[:, :, 3])
    return words.view(np.int32)


def _unpack_bits_words(words, n: int):
    """(n/32,) int32 -> (n,) u8 bits, inverse of pack_bits_words_host."""
    w = jax.lax.bitcast_convert_type(words, jnp.uint32)
    shifts = jnp.arange(31, -1, -1, dtype=jnp.uint32)
    bits = (w[:, None] >> shifts) & jnp.uint32(1)
    return bits.reshape(n).astype(jnp.uint8)


def _pack_bits_words(bits):
    """(m,) 0/1 -> (ceil(m/32),) int32, MSB-first big-endian byte order.

    Host decode: words.view(np.uint32).astype('>u4').tobytes() is the byte
    stream. Packing on device shrinks the extract pull 32x.
    """
    bits = jnp.asarray(bits, jnp.uint32)
    pad = (-bits.shape[0]) % 32
    if pad:
        bits = jnp.pad(bits, (0, pad))
    weights = jnp.left_shift(
        jnp.uint32(1), jnp.arange(31, -1, -1, dtype=jnp.uint32))
    words = (bits.reshape(-1, 32) * weights).sum(axis=1, dtype=jnp.uint32)
    return jax.lax.bitcast_convert_type(words, jnp.int32)


def _decode_sections(raw, hdr_stream_bits: int, payload_rep: int):
    """Hard section decode shared by every extract core: Rep-3 header words
    + payload words under payload_rep (1 = raw packed bits, RS wire)."""
    outs = []
    if hdr_stream_bits:
        outs.append(_pack_bits_words(
            ecc.rep_decode(raw[:hdr_stream_bits], 3)))
    outs.append(_pack_bits_words(
        ecc.rep_decode(raw[hdr_stream_bits:], payload_rep)))
    return jnp.concatenate(outs)


def _decode_sections_soft(d, hdr_stream_bits: int, payload_rep: int):
    """Matched-filter soft decode of decision values `d` -> one i32 row
    laid out [hdr soft words | payload soft words | conf bitcast (RS
    only)], the exact layout pipeline.batch._soft_sections parses. For the
    RS wire (payload_rep == 1) the payload section is the hard sign bits
    plus a per-coded-byte confidence (min |d| over the byte's 8 bits) for
    the host errors-and-erasures decode."""
    outs = []
    if hdr_stream_bits:
        outs.append(_pack_bits_words(
            ecc.rep_decode_soft(d[:hdr_stream_bits], 3)))
    pay = d[hdr_stream_bits:]
    if payload_rep == 1:
        outs.append(_pack_bits_words((pay >= 0).astype(jnp.uint8)))
        conf = jnp.abs(pay).reshape(-1, 8).min(axis=1)
        outs.append(jax.lax.bitcast_convert_type(
            conf.astype(jnp.float32), jnp.int32))
    else:
        outs.append(_pack_bits_words(ecc.rep_decode_soft(pay, payload_rep)))
    return jnp.concatenate(outs)


@functools.lru_cache(maxsize=32)
def batched_gather_decode_core(adaptive: bool, mesh: Mesh | None = None,
                               hdr_stream_bits: int = 0,
                               shared_idx: bool = True,
                               payload_rep: int = 7,
                               with_soft: bool = False):
    """Jitted: gather walk bins AND ECC-decode on device, returning packed
    bytes as i32 words — (B, 10 + ceil(payload_bytes/4)) instead of (B, n)
    raw bits, a ~250x smaller pull (ECC 3x/7x + bit->word 32x).

    Input bin arrays cover [0, hdr_stream_bits + payload_stream_bits): the
    first hdr_stream_bits are Rep-3 decoded (-> 10 words = 38 header bytes +
    2 pad), the rest decoded under payload_rep — 7 = the reference's Rep-7
    frame (steganosaur.cpp:986-995); 1 = raw packed bits for the RS wire
    mode, whose FEC decode runs on host (ops/rs.py; rep_decode with n=1 is
    the identity). hdr_stream_bits=0 skips the header section (payload-only
    second pass). shared_idx=False takes per-image (B, n) bin/jitter arrays
    (per-image-walk mode).

    with_soft=True additionally emits the matched-filter soft row
    (_decode_sections_soft) from the SAME decision values whose sign is
    the hard bit (ops/phase.read_values: sign(d) == read_phases exactly,
    including ties and the adaptive-alpha sign flip), returning
    (hard, soft) — the legacy-spectra twin of corner_extract_fused_core's
    with_soft, closing the adaptive-alpha batch fallback gap
    (doc/HARDENING.md §3 scope note, removed round 4)."""

    def core(spec, med, plane, y, x, jitters, alpha):
        if with_soft:
            d = phase_ops.read_values(spec, plane, y, x, jitters, alpha,
                                      med, adaptive)
            raw = (d >= 0).astype(jnp.uint8)
            return (_decode_sections(raw, hdr_stream_bits, payload_rep),
                    _decode_sections_soft(d, hdr_stream_bits, payload_rep))
        raw = _read_core(spec, med, plane, y, x, jitters, alpha,
                         adaptive=adaptive)
        return _decode_sections(raw, hdr_stream_bits, payload_rep)

    if shared_idx:
        fn = jax.vmap(core, in_axes=(0, 0, None, None, None, None, None))
    else:
        fn = jax.vmap(core, in_axes=(0, 0, 0, 0, 0, 0, None))
    if mesh is None:
        return jax.jit(fn)
    shard = NamedSharding(mesh, P("batch"))
    rep = NamedSharding(mesh, P())
    in_sh = ((shard, shard) + (rep,) * 5 if shared_idx
             else (shard,) * 6 + (rep,))
    out_sh = (shard, shard) if with_soft else shard
    return jax.jit(fn, in_shardings=in_sh, out_shardings=out_sh)


# ---------------------------------------------------------------------------
# Corner fast path (non-adaptive modes): pruned-DFT matmuls + dense phase
# write/read over the [0,Ky)x[0,Kx) corner that provably contains every walk
# bin (spectral/corner.py). Replaces the per-bin scatter (the embed graph's
# dominant op, ~166 ms/batch at 4K) with dense elementwise math driven by
# static per-walk maps, and replaces the full-grid FFT/IFFT with corner
# matmuls: stego = planes + real(IFFT2(corner delta)).
# ---------------------------------------------------------------------------


def _rep(mesh):
    return None if mesh is None else NamedSharding(mesh, P())


def _shardB(mesh, ndim: int, axis: int = 0):
    if mesh is None:
        return None
    spec = [None] * ndim
    spec[axis] = "batch"
    return NamedSharding(mesh, P(*spec))


@functools.lru_cache(maxsize=32)
def corner_statics_core(Ky: int, Kx: int, bucket: int, has_jitter: bool,
                        mesh: Mesh | None = None, has_spread: bool = False,
                        qim_hdr: int = 0):
    """Jitted one-time-per-walk builder of the static corner maps.

    (plane, y, x, jitters — the cached device walk arrays, length `bucket`,
    tail-padded by repeating the last REAL bin and ITS jitter
    [, alphas (bucket,) f32 per-slot write amplitudes when has_spread]
    [, dithers (bucket,) f32 per-slot QIM dither angles when qim_hdr]) ->
      pos (3,Ky,Kx) i32: walk position owning each bin, `bucket` elsewhere
      [cjd, sjd (3,Ky,Kx) f32: cos/sin of the bin's jitter, when has_jitter]
      [cad, sad (3,Ky,Kx) f32: cos/sin of the bin's write amplitude
       alpha_i, when has_spread (Params.alpha_spread; pipeline/spread.py)]
      [dq (3,Ky,Kx) f32 dither angle + qm (3,Ky,Kx) f32 payload-slot mask
       (1.0 where the bin's frame slot >= qim_hdr, i.e. a PAYLOAD bin),
       when qim_hdr > 0 (Params.qim; pipeline/qim.py)]

    The tail padding repeats the last real bin, so its slots scatter onto
    one bin several times. The jitter/amplitude/dither/payload-mask values
    of those duplicates are identical, but their slot ids differ; `pos`
    therefore takes the MINIMUM slot id per bin (the real slot), which is
    independent of the order in which duplicate updates land (unspecified
    on the GPU). Embed tables hold each image's last frame bit in every
    padded slot, so the real slot reads the same bit a padded one would.
    """

    def build(plane, y, x, jit, *extras):
        ei = 0
        idx = (plane, y, x)
        pos = jnp.full((3, Ky, Kx), bucket, jnp.int32).at[idx].min(
            jnp.arange(bucket, dtype=jnp.int32), mode="promise_in_bounds")
        out = (pos,)
        if has_jitter:
            cjd = jnp.ones((3, Ky, Kx), jnp.float32).at[idx].set(
                jnp.cos(jit), mode="promise_in_bounds")
            sjd = jnp.zeros((3, Ky, Kx), jnp.float32).at[idx].set(
                jnp.sin(jit), mode="promise_in_bounds")
            out = out + (cjd, sjd)
        if has_spread:
            al = extras[ei]
            ei += 1
            cad = jnp.ones((3, Ky, Kx), jnp.float32).at[idx].set(
                jnp.cos(al), mode="promise_in_bounds")
            sad = jnp.zeros((3, Ky, Kx), jnp.float32).at[idx].set(
                jnp.sin(al), mode="promise_in_bounds")
            out = out + (cad, sad)
        if qim_hdr:
            dith = extras[ei]
            ei += 1
            dq = jnp.zeros((3, Ky, Kx), jnp.float32).at[idx].set(
                dith, mode="promise_in_bounds")
            pay = (jnp.arange(bucket) >= qim_hdr).astype(jnp.float32)
            qm = jnp.zeros((3, Ky, Kx), jnp.float32).at[idx].set(
                pay, mode="promise_in_bounds")
            out = out + (dq, qm)
        return out

    has_qim = qim_hdr > 0
    n_in = 4 + has_spread + has_qim
    n_out = 1 + 2 * (has_jitter + has_spread + has_qim)
    if mesh is None:
        return jax.jit(build)
    rep = _rep(mesh)
    return jax.jit(build, in_shardings=(rep,) * n_in,
                   out_shardings=(rep,) * n_out)


def _frame_from_words(words, stream_bytes: int, bucket: int):
    """(B, ceil(stream_bytes/4)) i32 big-endian words of header||ct||tag ->
    (B, bucket) u8 ECC frame bits: rep3 over the 304 header bits, rep7 over
    the payload bits (reference frame layout, steganosaur.cpp:986-995),
    tail-padded by repeating each image's last bit. The SINGLE source of
    the device frame layout — every table builder calls this."""
    nwords = -(-stream_bytes // 4)
    nmax = 304 * 3 + (stream_bytes - 38) * 8 * 7
    bits = jax.vmap(functools.partial(_unpack_bits_words, n=nwords * 32))(
        words)[:, : stream_bytes * 8]
    frame = jnp.concatenate(
        [jnp.repeat(bits[:, :304], 3, axis=1),
         jnp.repeat(bits[:, 304:], 7, axis=1)], axis=1)
    if bucket > nmax:
        frame = jnp.concatenate(
            [frame, jnp.tile(frame[:, -1:], (1, bucket - nmax))], axis=1)
    return frame


@functools.lru_cache(maxsize=32)
def frame_table_core(stream_bytes: int, bucket: int, mesh: Mesh | None = None):
    """Jitted device ECC encoder for the equal-length MESH path: stream
    words -> (bucket+1, B) u8 frame-bit table (zero sentinel row last).
    Uploading raw stream bytes instead of ECC-expanded bit words shrinks the
    embed upload ~28x. The
    single-chip path builds its batch-packed table inside the embed module
    instead (corner_embed_core stream_bytes arg)."""

    def fn(words):
        frame = _frame_from_words(words, stream_bytes, bucket)
        return jnp.concatenate(
            [frame.T, jnp.zeros((1, frame.shape[0]), jnp.uint8)])

    if mesh is None:
        return jax.jit(fn)
    return jax.jit(fn, in_shardings=(_shardB(mesh, 2),),
                   out_shardings=_shardB(mesh, 2, axis=1))


@functools.lru_cache(maxsize=32)
def bits_table_core(bucket: int, mesh: Mesh | None = None):
    """Jitted ragged-path table builder: (B, bucket/32) i32 packed frame bits
    (pack_bits_words_host output) -> (bucket+1, B) u8 table."""

    def fn(words):
        bits = jax.vmap(functools.partial(_unpack_bits_words, n=bucket))(words)
        return jnp.concatenate(
            [bits.T, jnp.zeros((1, bits.shape[0]), jnp.uint8)])

    if mesh is None:
        return jax.jit(fn)
    return jax.jit(fn, in_shardings=(_shardB(mesh, 2),),
                   out_shardings=_shardB(mesh, 2, axis=1))


# --- batch-packed bit words --------------------------------------------------
# The per-bin/per-slot bit lookups are random-access gathers, which pay a
# full memory transaction per row: gathering per (bin, image) costs B times
# the rows of gathering per bin. Packing the BATCH dimension into i32 words
# (bit j of word g = image g*32+j's bit) turns (rows x B) u8 gathers into
# (rows x ceil(B/32)) i32 gathers; the unpack back to per-image bits is
# elementwise shift/mask that XLA fuses into the consumer. Single-chip only:
# a mesh shards the batch axis, and packing across shard boundaries would
# couple devices (the mesh paths keep the u8 tables).


def _bitcast(x, dt):
    return jax.lax.bitcast_convert_type(x, dt)


def _pack_batch_words(bits):
    """(B, n) u8 bits -> (ceil(B/32), n) i32 words, image b at bit b%32 of
    word row b//32."""
    B, n = bits.shape
    Bw = -(-B // 32)
    b = jnp.pad(bits, ((0, Bw * 32 - B), (0, 0))).astype(jnp.uint32)
    sh = jnp.arange(32, dtype=jnp.uint32)[None, :, None]
    return _bitcast((b.reshape(Bw, 32, n) << sh).sum(axis=1,
                                                     dtype=jnp.uint32),
                    jnp.int32)


def _unpack_batch_words(words_u32, B: int):
    """(Bw, ...) u32 -> (B, ...) u8 bits (inverse of _pack_batch_words along
    the leading axis). Pure shift/mask — fuses into consumers."""
    outs = []
    for g in range(words_u32.shape[0]):
        nb = min(32, B - g * 32)
        sh = jnp.arange(nb, dtype=jnp.uint32).reshape(
            (nb,) + (1,) * (words_u32.ndim - 1))
        outs.append(((words_u32[g][None] >> sh) & 1).astype(jnp.uint8))
    return jnp.concatenate(outs, axis=0)


@functools.lru_cache(maxsize=32)
def bits_table_packed_core(bucket: int, B: int):
    """bits_table_core with the output batch-packed."""

    def fn(words):
        bits = jax.vmap(functools.partial(_unpack_bits_words, n=bucket))(words)
        packed = _pack_batch_words(bits)
        return jnp.concatenate(
            [packed.T, jnp.zeros((1, packed.shape[0]), jnp.int32)])

    return jax.jit(fn)


def _maps_adapter(base, n_lead: int, pair_flags: tuple[bool, ...]):
    """Adapt a base fn taking the FULL static-map signature
    (lead args..., m1a, m1b, m2a, m2b, ..., trailing...) to the compact
    call signature where absent map pairs are omitted: pair_flags[i] says
    whether pair i is present in the call; absent pairs become (None, None).
    """

    def adapted(*args):
        lead, rest = list(args[:n_lead]), list(args[n_lead:])
        maps = []
        for flag in pair_flags:
            if flag:
                maps += [rest.pop(0), rest.pop(0)]
            else:
                maps += [None, None]
        return base(*lead, *maps, *rest)

    return adapted


@functools.lru_cache(maxsize=32)
def corner_embed_core(H: int, W: int, Ky: int, Kx: int, center: bool,
                      mesh: Mesh | None = None, has_jitter: bool = False,
                      pack: bool = False, layout: str = "nhwc",
                      stream_bytes: int = 0, bucket: int = 0,
                      soft: bool = False, has_spread: bool = False,
                      qim_levels: int = 0, floor: float = 0.0):
    """Jitted corner embed: (imgs u8, table, pos (3,Ky,Kx) i32, [cjd, sjd],
    [cad, sad], alpha () f32) -> u8 stego.

    has_spread: the statics carry per-bin write-amplitude maps cad/sad
    (cos/sin(alpha_i), Params.alpha_spread) which replace the scalar
    cos/sin(alpha) in the write; map argument order follows
    corner_statics_core ((pos, [cjd, sjd], [cad, sad])).

    Full embed data path with zero scatters and no full-grid FFT: corner
    forward matmuls -> dense bit-sign map via the static pos gather -> dense
    write_delta -> corner delta-IFFT matmuls -> planes + delta -> quantize.

    layout: "nhwc" takes/returns (B,H,W,3); "nchw" takes/returns (B,3,H,W),
    skipping both u8 relayouts — the strided (…,3) u8 transpose costs
    ~2 ms/image at 4K, and device-resident embed->extract chains never need
    the NHWC form (measured: the pair of transposes is ~25% of the step).

    Single-chip (mesh=None) expects the BATCH-PACKED (bucket+1, ceil(B/32))
    i32 table: the per-bin bit lookup gathers one word per bin instead of B
    u8 rows (see _pack_batch_words). Mesh paths keep the (bucket+1, B) u8
    table — packing would couple batch shards.

    stream_bytes > 0 (single-chip, equal-length path): the `table` argument
    is instead the (B, ceil(stream_bytes/4)) i32 raw stream words and the
    batch-packed frame table is built INSIDE this module (_frame_from_words
    + _pack_batch_words) — one dispatched module instead of two. `bucket`
    must then be given.
    """
    from steganosaurus_jax.spectral import corner

    prec = corner.precision()
    packed_table = mesh is None
    assert stream_bytes == 0 or (packed_table and bucket > 0)

    def build_table(words):
        packed = _pack_batch_words(
            _frame_from_words(words, stream_bytes, bucket))  # (Bw, bucket)
        return jnp.concatenate(
            [packed.T, jnp.zeros((1, packed.shape[0]), jnp.int32)])

    def fn(imgs, table, pos, cjd, sjd, cad, sad, dq, qm, alpha, *tabs):
        if layout == "nchw":
            planes = imgs.astype(jnp.float32)
        else:
            planes = jnp.transpose(imgs, (0, 3, 1, 2)).astype(jnp.float32)
        B = planes.shape[0]
        pin = spectral.apply_center(planes, center)
        cr, ci = corner.fwd_corner(pin, Ky, Kx, tabs, prec)
        if stream_bytes:
            table = build_table(table)
        tbucket = table.shape[0] - 1
        if packed_table:
            bw = table[pos.reshape(-1), :]               # (3*Ky*Kx, Bw) i32
            bw = _bitcast(jnp.transpose(bw).reshape(-1, 3, Ky, Kx),
                          jnp.uint32)                    # (Bw, 3, Ky, Kx)
            sign = _unpack_batch_words(bw, B).astype(jnp.float32) * 2.0 - 1.0
        else:
            bit = table[pos.reshape(-1), :]              # (3*Ky*Kx, B)
            sign = jnp.transpose(
                bit.reshape(3, Ky, Kx, -1), (3, 0, 1, 2)
            ).astype(jnp.float32) * 2.0 - 1.0            # (B,3,Ky,Kx)
        mask = (pos < tbucket).astype(jnp.float32)
        ca = jnp.cos(alpha) if cad is None else cad
        sa = jnp.sin(alpha) if sad is None else sad
        if qim_levels:
            dr, di = corner.write_delta_qim(cr, ci, sign, mask, qm, ca, sa,
                                            dq, qim_levels, cjd, sjd,
                                            soft=soft)
        else:
            dr, di = corner.write_delta(cr, ci, sign, mask, ca, sa, cjd, sjd,
                                        soft=soft)
        if floor:
            # Quantization write floor (Params.write_floor): per-image
            # magnitude boost so the spatial delta survives u8 rounding;
            # b == 1 (bit-identical) whenever the write already clears it.
            dr, di = corner.apply_write_floor(dr, di, cr, ci, floor,
                                              float(H) * float(W))
        t = corner.ifft_corner_real(dr, di, H, W, tabs, prec)
        t = spectral.apply_center(t, center)
        out = jnp.clip(jnp.floor(planes + t + 0.5), 0.0, 255.0)
        out = out.astype(jnp.uint8)
        if layout != "nchw":
            out = jnp.transpose(out, (0, 2, 3, 1))
        return transfer.pack_u8(out) if pack else out

    # Positional maps arrive in corner_statics_core order:
    # (pos, [cjd, sjd], [cad, sad], [dq, qm]); absent maps become None.
    pair_flags = (has_jitter, has_spread, qim_levels > 0)
    fn = _maps_adapter(fn, 3, pair_flags)
    # DFT tables are runtime ARGUMENTS (uploaded once, shared by every
    # module), never closure constants — capturing a device array bakes it
    # into each compiled module via a host pull (spectral/corner.py).
    tabs = corner.dft_tables_device(H, Ky, W, Kx, mesh)
    if mesh is None:
        jfn = jax.jit(fn)
        out = lambda *args: jfn(*args, *tabs)  # noqa: E731
        # Cost-model handles (utils/cost.py): lowering jfn at the runtime
        # argument shapes yields the EXACT dispatched module's compiler
        # cost analysis (and a persistent-cache compile hit, not a fresh
        # compile of a wrapper module).
        out.jfn, out.tabs = jfn, tabs
        return out
    rep = _rep(mesh)
    in_sh = (_shardB(mesh, 4), _shardB(mesh, 2, axis=1), rep)
    in_sh += (rep, rep) * sum(pair_flags) + (rep,)
    in_sh += (rep,) * len(tabs)
    # P("batch") with no trailing dims is rank-agnostic (pack=True -> rank 2)
    jfn = jax.jit(fn, in_shardings=in_sh,
                  out_shardings=NamedSharding(mesh, P("batch")))
    return lambda *args: jfn(*args, *tabs)


@functools.lru_cache(maxsize=32)
def corner_bits_core(H: int, W: int, Ky: int, Kx: int, center: bool,
                     mesh: Mesh | None = None, has_jitter: bool = False,
                     layout: str = "nhwc", qim_levels: int = 0,
                     with_values: bool = False):
    """Jitted corner analyze+read: (imgs u8, [cjd, sjd], [dq, qm], alpha) ->
    dense decoded bits (device-resident between the header and payload
    gather passes — replaces the full c64 spectrum). qim_levels > 0: payload
    bins (qm mask) decode by the QIM nearest-coset rule
    (spectral/corner.read_bits_dense_qim; Params.qim).

    Single-chip (mesh=None): output is BATCH-PACKED (ceil(B/32),3,Ky,Kx) i32
    — bit b%32 of word row b//32 is image b's decoded bit — so the slot
    gathers downstream fetch one word per walk bin instead of B u8 rows.
    Mesh: (B,3,Ky,Kx) u8 (batch stays shardable). layout as in
    corner_embed_core.

    with_values=True (mesh only): additionally returns the dense decision
    values as (B,3,Ky,Kx) bf16 (sign preserved exactly — hard bit ==
    sign(d); the soft combiner only needs coarse magnitude), feeding the
    mesh extract's soft fallback (corner_gather_decode_core with_soft)."""
    from steganosaurus_jax.spectral import corner

    prec = corner.precision()
    packed = mesh is None
    assert not (with_values and packed), \
        "with_values is the mesh soft path; single-chip uses the fused core"

    def fn(imgs, cjd, sjd, dq, qm, alpha, *tabs):
        if layout == "nchw":
            planes = imgs.astype(jnp.float32)
        else:
            planes = jnp.transpose(imgs, (0, 3, 1, 2)).astype(jnp.float32)
        pin = spectral.apply_center(planes, center)
        cr, ci = corner.fwd_corner(pin, Ky, Kx, tabs, prec)
        ssa = jnp.sign(jnp.sin(alpha))
        if with_values:
            if qim_levels:
                dd = corner.decision_values_dense_qim(
                    cr, ci, ssa, qm, dq, qim_levels, cjd, sjd)
            else:
                dd = ci if cjd is None else ci * cjd - cr * sjd
                dd = dd * ssa
            return (dd >= 0).astype(jnp.uint8), dd.astype(jnp.bfloat16)
        if qim_levels:
            bd = corner.read_bits_dense_qim(cr, ci, ssa, qm, dq, qim_levels,
                                            cjd, sjd)
        else:
            bd = corner.read_bits_dense(cr, ci, ssa, cjd, sjd)
        return _pack_bd_batch(bd) if packed else bd

    pair_flags = (has_jitter, qim_levels > 0)
    fn = _maps_adapter(fn, 1, pair_flags)
    tabs = corner.dft_tables_device(H, Ky, W, Kx, mesh)
    if mesh is None:
        jfn = jax.jit(fn)
        return lambda *args: jfn(*args, *tabs)
    rep = _rep(mesh)
    in_sh = (_shardB(mesh, 4),)
    in_sh += (rep, rep) * sum(pair_flags) + (rep,)
    in_sh += (rep,) * len(tabs)
    out_sh = ((_shardB(mesh, 4), _shardB(mesh, 4)) if with_values
              else _shardB(mesh, 4))
    jfn = jax.jit(fn, in_shardings=in_sh, out_shardings=out_sh)
    return lambda *args: jfn(*args, *tabs)


def _pack_bd_batch(bd):
    """(B,3,Ky,Kx) u8 decoded bits -> (ceil(B/32),3,Ky,Kx) i32 batch-packed
    words (bit b%32 of row b//32 = image b's bit)."""
    B = bd.shape[0]
    Bw = -(-B // 32)
    b = jnp.pad(bd, ((0, Bw * 32 - B),) + ((0, 0),) * 3).astype(jnp.uint32)
    sh = jnp.arange(32, dtype=jnp.uint32).reshape(1, 32, 1, 1, 1)
    shp = b.shape[1:]
    return _bitcast((b.reshape(Bw, 32, *shp) << sh).sum(axis=1,
                                                        dtype=jnp.uint32),
                    jnp.int32)


@functools.lru_cache(maxsize=32)
def corner_extract_fused_core(H: int, W: int, Ky: int, Kx: int, center: bool,
                              has_jitter: bool, layout: str,
                              hdr_stream_bits: int, B: int,
                              qim_levels: int = 0, payload_rep: int = 7,
                              with_soft: bool = False):
    """ONE-dispatch extract fast path (single chip): (imgs u8, [cjd, sjd],
    alpha, plane/y/x (n,)) -> (B, words) decoded i32 words.

    Fuses corner_bits_core + corner_gather_decode_core into a single XLA
    module: one launch and no intermediate pull for the read, gather, and
    ECC decode.

    with_soft=True additionally computes the matched-filter soft decode
    (ops/ecc.rep_decode_soft over the same decision values whose SIGN is
    the hard bit — spectral/corner.read_bits_dense) in the SAME module,
    returning (hard_words, soft_words) with the soft row laid out
    [soft | conf-bitcast (RS only)]. The host pulls hard always and soft
    LAZILY — only when an AEAD failure needs it (a transfer of bytes
    already in HBM, not a dispatch) — the serving-path fix for the
    fallback pass's inline compile/launch stall (measured 15.3 s on a
    1-failure batch, 2026-08-18). Hard-section bytes are bit-identical to
    with_soft=False (same packed path, same tie semantics); the soft
    decision values ride a pair-packed bf16 gather (shared walk indices
    across the batch; sign is preserved exactly by the f32->bf16 round,
    and the combiner/confidences only need coarse magnitude). Measured
    module cost at 4K/B=32: 88 -> ~100 ms vs the 126 ms of a pulled-f32
    variant."""
    from steganosaurus_jax.spectral import corner

    prec = corner.precision()

    def decode(raw):
        return _decode_sections(raw, hdr_stream_bits, payload_rep)

    def fn(imgs, cjd, sjd, dq, qm, alpha, plane, y, x, *tabs):
        if layout == "nchw":
            planes = imgs.astype(jnp.float32)
        else:
            planes = jnp.transpose(imgs, (0, 3, 1, 2)).astype(jnp.float32)
        pin = spectral.apply_center(planes, center)
        cr, ci = corner.fwd_corner(pin, Ky, Kx, tabs, prec)
        ssa = jnp.sign(jnp.sin(alpha))
        if with_soft:
            # hard sections stay on the 32x-packed word gather (bytes
            # IDENTICAL to with_soft=False); the soft sections gather the
            # dense decision values — hard bit == sign(d) exactly — as
            # bf16 packed two-images-per-u32 (the walk indices are shared
            # across the batch, so image pairs ride one gathered element;
            # the combiner/confidences only need sign + coarse magnitude)
            if qim_levels:
                dd = corner.decision_values_dense_qim(
                    cr, ci, ssa, qm, dq, qim_levels, cjd, sjd)
            else:
                dd = ci if cjd is None else ci * cjd - cr * sjd
                dd = dd * ssa
            bdw = _pack_bd_batch((dd >= 0).astype(jnp.uint8))
            raw_w = _bitcast(bdw[:, plane, y, x], jnp.uint32)
            raw = _unpack_batch_words(raw_w, B)             # (B, n) u8
            db = dd.astype(jnp.bfloat16)
            if B % 2 == 0:
                # [img 2k | img 2k+1] bf16 pair -> one u32 plane
                pair = jax.lax.bitcast_convert_type(
                    db.reshape(B // 2, 2, *db.shape[1:])
                    .transpose(0, 2, 3, 4, 1), jnp.uint32)
                g = pair[:, plane, y, x]                    # (B/2, n) u32
                half = jax.lax.bitcast_convert_type(
                    g, jnp.bfloat16)                        # (B/2, n, 2)
                d = half.transpose(0, 2, 1).reshape(B, -1)  # (B, n)
            else:
                d = db[:, plane, y, x]                      # (B, n) bf16

            def one_soft(di):
                return _decode_sections_soft(di.astype(jnp.float32),
                                             hdr_stream_bits, payload_rep)

            return jax.vmap(decode)(raw), jax.vmap(one_soft)(d)
        if qim_levels:
            bd = corner.read_bits_dense_qim(cr, ci, ssa, qm, dq, qim_levels,
                                            cjd, sjd)
        else:
            bd = corner.read_bits_dense(cr, ci, ssa, cjd, sjd)
        bdw = _pack_bd_batch(bd)
        raw_w = _bitcast(bdw[:, plane, y, x], jnp.uint32)   # (Bw, n)
        raw = _unpack_batch_words(raw_w, B)                 # (B, n) u8
        return jax.vmap(decode)(raw)

    fn = _maps_adapter(fn, 1, (has_jitter, qim_levels > 0))
    tabs = corner.dft_tables_device(H, Ky, W, Kx, None)
    jfn = jax.jit(fn)
    out = lambda *args: jfn(*args, *tabs)  # noqa: E731
    out.jfn, out.tabs = jfn, tabs  # cost-model handles (utils/cost.py)
    return out


def _piw_write_vals(vr, vi, s, cj, sj, ca, sa, soft: bool):
    """Per-bin write values for the PER-IMAGE-WALK corner scatter embed:
    the 1-D (gathered-bin) twin of spectral.corner.write_delta's dense math.
    vr/vi: gathered corner values (n,). s: bit signs +-1. cj/sj: cos/sin of
    the per-bit jitter. ca/sa: cos/sin of the per-bit write amplitude
    (scalar or (n,) under alpha_spread). Returns the pre-doubled
    Hermitian-half deltas (2*(nv - v), ops/phase.py)."""
    mag = jnp.maximum(jnp.float32(1e-12), jnp.sqrt(vr * vr + vi * vi))
    if soft:
        sigma = jnp.where(jnp.asarray(sa) < 0, -1.0, 1.0)
        abs_sin, abs_cos = jnp.abs(jnp.asarray(sa)), jnp.abs(jnp.asarray(ca))
        u_r = vr * cj + vi * sj
        u_i = vi * cj - vr * sj
        valid = s * sigma * u_i >= mag * abs_sin
        t_r = jnp.where(u_r < 0, -1.0, 1.0) * (mag * abs_cos)
        t_i = (s * sigma) * (mag * abs_sin)
        nv_r = t_r * cj - t_i * sj
        nv_i = t_r * sj + t_i * cj
        dr = 2.0 * jnp.where(valid, 0.0, nv_r - vr)
        di = 2.0 * jnp.where(valid, 0.0, nv_i - vi)
        return dr, di
    cos_t = cj * ca - s * (sj * sa)
    sin_t = sj * ca + s * (cj * sa)
    return 2.0 * (mag * cos_t - vr), 2.0 * (mag * sin_t - vi)


def _piw_qim_write_vals(vr, vi, s, dith, L: int):
    """Per-bin dithered phase-QIM write values (Params.qim; pipeline/qim.py)
    — the 1-D gathered-bin twin of spectral.corner.write_delta_qim's payload
    branch. s: bit signs +-1. dith: per-bit dither angles. Returns the
    pre-doubled Hermitian-half deltas."""
    import math

    mag = jnp.maximum(jnp.float32(1e-12), jnp.sqrt(vr * vr + vi * vi))
    theta = jnp.arctan2(vi, vr)
    delta = jnp.float32(2.0 * math.pi / L)
    half_b = (s + 1.0) * 0.25
    q = (theta - dith) / delta - half_b
    th_q = dith + (jnp.round(q) + half_b) * delta
    return (2.0 * (mag * jnp.cos(th_q) - vr),
            2.0 * (mag * jnp.sin(th_q) - vi))


@functools.lru_cache(maxsize=32)
def corner_soft_extract_core(H: int, W: int, Ky: int, Kx: int, center: bool,
                             has_jitter: bool, layout: str,
                             hdr_stream_bits: int, per_image: bool = False,
                             qim_levels: int = 0, payload_rep: int = 7):
    """Soft-decision extract pass (the AEAD-failure recovery fallback,
    pipeline/batch.py): ONE module computing the corner spectrum, gathering
    per-bin DECISION VALUES d = sign(sin a)*(Im*cos(jd) - Re*sin(jd))
    (spectral/corner.py read rule without the final sign), and
    matched-filter combining the Rep-3/Rep-7 copies (ops.ecc
    rep_decode_soft: bit = sum of copies' d >= 0).

    per_image=False (shared walk): (imgs, [cjd, sjd maps], alpha,
    plane/y/x (n,)) — jitter rides the static maps.
    per_image=True (per-image-walk): (imgs, plane/y/x/jit (B, n), alpha) —
    jitter from the per-bit angles, as in corner_piw_extract_core.
    Returns (B, words) decoded i32 words (corner_extract_fused_core
    contract). Single-chip only: the fallback runs on small failed
    subsets."""
    from steganosaurus_jax.spectral import corner

    prec = corner.precision()

    def decode_soft(d):
        outs = []
        if hdr_stream_bits:
            outs.append(_pack_bits_words(
                ecc.rep_decode_soft(d[:hdr_stream_bits], 3)))
        pay = d[hdr_stream_bits:]
        if payload_rep == 1:
            # RS wire mode: hard payload bits + per-coded-byte confidence
            # (min |decision value| of the byte's bits) for the host-side
            # errors-and-erasures decode (ops/rs.py).
            outs.append(_pack_bits_words((pay >= 0).astype(jnp.uint8)))
            conf = jnp.abs(pay).reshape(-1, 8).min(axis=1)
            return jnp.concatenate(outs), conf
        outs.append(_pack_bits_words(ecc.rep_decode_soft(pay, payload_rep)))
        return jnp.concatenate(outs)

    def shared_fn(imgs, cjd, sjd, dq, qm, alpha, plane, y, x, *tabs):
        if layout == "nchw":
            planes = imgs.astype(jnp.float32)
        else:
            planes = jnp.transpose(imgs, (0, 3, 1, 2)).astype(jnp.float32)
        pin = spectral.apply_center(planes, center)
        cr, ci = corner.fwd_corner(pin, Ky, Kx, tabs, prec)
        ssa = jnp.sign(jnp.sin(alpha))
        if qim_levels:
            dd = corner.decision_values_dense_qim(cr, ci, ssa, qm, dq,
                                                  qim_levels, cjd, sjd)
        else:
            dd = ci if cjd is None else ci * cjd - cr * sjd
            dd = dd * ssa
        d = dd[:, plane, y, x]                      # (B, n)
        return jax.vmap(decode_soft)(d)

    def piw_fn(imgs, plane, y, x, jit, dith, alpha, *tabs):
        if layout == "nchw":
            planes = imgs.astype(jnp.float32)
        else:
            planes = jnp.transpose(imgs, (0, 3, 1, 2)).astype(jnp.float32)
        pin = spectral.apply_center(planes, center)
        cr, ci = corner.fwd_corner(pin, Ky, Kx, tabs, prec)
        ssa = jnp.sign(jnp.sin(alpha))

        def per(crb, cib, pl, yy, xx, jt):
            vr = crb[pl, yy, xx]
            vi = cib[pl, yy, xx]
            d = (vi * jnp.cos(jt) - vr * jnp.sin(jt)) * ssa
            if qim_levels:
                # payload slots (>= hdr_stream_bits) decode by the QIM rule
                # with the shared slot-aligned dither (pipeline/qim.py)
                mag = jnp.maximum(jnp.float32(1e-12),
                                  jnp.sqrt(vr * vr + vi * vi))
                dqv = -jnp.cos(
                    qim_levels * (jnp.arctan2(vi, vr) - dith)) * mag
                pay = jnp.arange(d.shape[0]) >= hdr_stream_bits
                d = jnp.where(pay, dqv, d)
            return decode_soft(d)

        return jax.vmap(per, in_axes=(0, 0, 0, 0, 0, 0))(
            cr, ci, plane, y, x, jit)

    if per_image:
        fn = piw_fn
        if not qim_levels:
            fn = lambda imgs, plane, y, x, jit, alpha, *tabs: piw_fn(  # noqa: E731
                imgs, plane, y, x, jit, jit, alpha, *tabs)
    else:
        fn = _maps_adapter(shared_fn, 1, (has_jitter, qim_levels > 0))
    tabs = corner.dft_tables_device(H, Ky, W, Kx, None)
    jfn = jax.jit(fn)
    return lambda *args: jfn(*args, *tabs)


@functools.lru_cache(maxsize=32)
def corner_piw_embed_core(H: int, W: int, Ky: int, Kx: int, center: bool,
                          mesh: Mesh | None = None, pack: bool = False,
                          layout: str = "nhwc", soft: bool = False,
                          spread: bool = False, qim_levels: int = 0,
                          qim_hdr: int = 0, floor: float = 0.0):
    """Per-image-walk corner embed (ONE dispatched module): (imgs u8,
    plane/y/x (B, n) i32, bits_words (B, n/32) i32, jitters (B, n) f32,
    [nbits_per (B,) i32 when spread,] alpha () f32 — or (n,) when spread)
    -> u8 stego.

    The shared-walk fast path's dense write needs per-WALK static maps;
    with per-image walks those would be (B, 3, Ky, Kx) per batch (~12 MB x B
    at 4K) — instead each image gathers its own bins from the corner
    spectrum, computes the write values per bit, and scatters the
    pre-doubled delta into a zero corner. Keeps the pruned-DFT
    forward/inverse matmuls — no full-grid FFT (pipeline/batch.py
    per_image_walk).

    Tail-pad slots repeat each image's LAST real bin/bit/jitter, so
    duplicate scatters carry identical values; under spread the per-slot
    amplitude is clamped to the image's last real slot (alphas[min(i,
    nbits_per-1)]) to keep that invariant."""
    from steganosaurus_jax.spectral import corner

    prec = corner.precision()

    def per_image(crb, cib, pl, yy, xx, btw, jt, nb, dith, alpha):
        n = jt.shape[0]
        bt = _unpack_bits_words(btw, n=n)
        s = bt.astype(jnp.float32) * 2.0 - 1.0
        vr = crb[pl, yy, xx]
        vi = cib[pl, yy, xx]
        if spread:
            a = alpha[jnp.minimum(jnp.arange(n), nb - 1)]
        else:
            a = alpha
        dr_v, di_v = _piw_write_vals(vr, vi, s, jnp.cos(jt), jnp.sin(jt),
                                     jnp.cos(a), jnp.sin(a), soft)
        if qim_levels:
            # payload slots (>= qim_hdr) take the dithered QIM write with
            # the shared slot-aligned dither (pipeline/qim.py); header slots
            # keep the hard/soft values above. The dither is clamped to the
            # image's last REAL slot (nb - 1) so the tail-pad duplicates
            # scatter identical values (same invariant as `a` under spread).
            d_i = dith[jnp.minimum(jnp.arange(n), nb - 1)]
            dr_q, di_q = _piw_qim_write_vals(vr, vi, s, d_i, qim_levels)
            pay = jnp.arange(n) >= qim_hdr
            dr_v = jnp.where(pay, dr_q, dr_v)
            di_v = jnp.where(pay, di_q, di_v)
        idx = (pl, yy, xx)
        dr = jnp.zeros((3, Ky, Kx), jnp.float32).at[idx].set(
            dr_v, mode="promise_in_bounds")
        di = jnp.zeros((3, Ky, Kx), jnp.float32).at[idx].set(
            di_v, mode="promise_in_bounds")
        return dr, di

    def fn(imgs, plane, y, x, bits_w, jit, nbits_per, dith, alpha, *tabs):
        if layout == "nchw":
            planes = imgs.astype(jnp.float32)
        else:
            planes = jnp.transpose(imgs, (0, 3, 1, 2)).astype(jnp.float32)
        pin = spectral.apply_center(planes, center)
        cr, ci = corner.fwd_corner(pin, Ky, Kx, tabs, prec)
        dr, di = jax.vmap(per_image, in_axes=(0,) * 8 + (None, None))(
            cr, ci, plane, y, x, bits_w, jit, nbits_per, dith, alpha)
        if floor:
            # Quantization write floor (Params.write_floor) on the scattered
            # dense deltas — tail-pad duplicate scatters carry identical
            # values, so the dense D counts each moved bin exactly once.
            dr, di = corner.apply_write_floor(dr, di, cr, ci, floor,
                                              float(H) * float(W))
        t = corner.ifft_corner_real(dr, di, H, W, tabs, prec)
        t = spectral.apply_center(t, center)
        out = jnp.clip(jnp.floor(planes + t + 0.5), 0.0, 255.0)
        out = out.astype(jnp.uint8)
        if layout != "nchw":
            out = jnp.transpose(out, (0, 2, 3, 1))
        return transfer.pack_u8(out) if pack else out

    base = fn
    if qim_levels:
        # qim always takes nbits_per (the dither clamp needs each image's
        # real frame length): (imgs, plane, y, x, bits_w, jit, nbits_per,
        # dith, alpha) — the full base signature, spread or not.
        pass
    elif spread:
        fn = lambda imgs, plane, y, x, bits_w, jit, nbits_per, alpha, *tabs: base(  # noqa: E731
            imgs, plane, y, x, bits_w, jit, nbits_per, jit[0], alpha, *tabs)
    else:
        fn = lambda imgs, plane, y, x, bits_w, jit, alpha, *tabs: base(  # noqa: E731
            imgs, plane, y, x, bits_w, jit,
            jnp.zeros(plane.shape[0], jnp.int32), jit[0], alpha, *tabs)
    tabs = corner.dft_tables_device(H, Ky, W, Kx, mesh)
    if mesh is None:
        jfn = jax.jit(fn)
        return lambda *args: jfn(*args, *tabs)
    rep = _rep(mesh)
    in_sh = (_shardB(mesh, 4),) + (_shardB(mesh, 2),) * 5
    if spread or qim_levels:
        in_sh += (_shardB(mesh, 1),)   # nbits_per
    if qim_levels:
        in_sh += (rep,)                # dith (slot-aligned, replicated)
    in_sh += (rep,) + (rep,) * len(tabs)
    jfn = jax.jit(fn, in_shardings=in_sh,
                  out_shardings=NamedSharding(mesh, P("batch")))
    return lambda *args: jfn(*args, *tabs)


@functools.lru_cache(maxsize=32)
def corner_piw_extract_core(H: int, W: int, Ky: int, Kx: int, center: bool,
                            layout: str, hdr_stream_bits: int,
                            mesh: Mesh | None = None, qim_levels: int = 0,
                            qim_hdr: int = 0, payload_rep: int = 7):
    """Per-image-walk corner extract (ONE dispatched module): (imgs u8,
    plane/y/x (B, n) i32, jitters (B, n) f32, alpha () f32) -> (B, words)
    decoded i32 words (same contract as corner_extract_fused_core).

    Per-image bins rule out the dense static-map read; instead each image
    gathers its own (re, im) corner values and decodes with the per-bit
    jitter angles directly — sign(sin a) * (Im*cos(jd) - Re*sin(jd)) >= 0
    (spectral/corner.py module docstring) — so jitter needs no maps."""
    from steganosaurus_jax.spectral import corner

    prec = corner.precision()

    def per_image(crb, cib, pl, yy, xx, jt, dith, ssa):
        vr = crb[pl, yy, xx]
        vi = cib[pl, yy, xx]
        d = vi * jnp.cos(jt) - vr * jnp.sin(jt)
        raw = (d * ssa >= 0).astype(jnp.uint8)
        if qim_levels:
            mag = jnp.maximum(jnp.float32(1e-12),
                              jnp.sqrt(vr * vr + vi * vi))
            dqv = -jnp.cos(qim_levels * (jnp.arctan2(vi, vr) - dith)) * mag
            pay = jnp.arange(raw.shape[0]) >= qim_hdr
            raw = jnp.where(pay, (dqv >= 0).astype(jnp.uint8), raw)
        outs = []
        if hdr_stream_bits:
            outs.append(_pack_bits_words(
                ecc.rep_decode(raw[:hdr_stream_bits], 3)))
        outs.append(_pack_bits_words(
            ecc.rep_decode(raw[hdr_stream_bits:], payload_rep)))
        return jnp.concatenate(outs)

    def fn(imgs, plane, y, x, jit, dith, alpha, *tabs):
        if layout == "nchw":
            planes = imgs.astype(jnp.float32)
        else:
            planes = jnp.transpose(imgs, (0, 3, 1, 2)).astype(jnp.float32)
        pin = spectral.apply_center(planes, center)
        cr, ci = corner.fwd_corner(pin, Ky, Kx, tabs, prec)
        ssa = jnp.sign(jnp.sin(alpha))
        return jax.vmap(per_image, in_axes=(0, 0, 0, 0, 0, 0, None, None))(
            cr, ci, plane, y, x, jit, dith, ssa)

    if not qim_levels:
        base = fn
        fn = lambda imgs, plane, y, x, jit, alpha, *tabs: base(  # noqa: E731
            imgs, plane, y, x, jit, jit[0], alpha, *tabs)
    tabs = corner.dft_tables_device(H, Ky, W, Kx, mesh)
    if mesh is None:
        jfn = jax.jit(fn)
        return lambda *args: jfn(*args, *tabs)
    rep = _rep(mesh)
    in_sh = (_shardB(mesh, 4),) + (_shardB(mesh, 2),) * 4
    if qim_levels:
        in_sh += (rep,)
    in_sh += (rep,)
    in_sh += (rep,) * len(tabs)
    jfn = jax.jit(fn, in_shardings=in_sh, out_shardings=_shardB(mesh, 2))
    return lambda *args: jfn(*args, *tabs)


@functools.lru_cache(maxsize=32)
def corner_gather_raw_core(mesh: Mesh | None = None, B: int = 0):
    """Jitted: (bit_dense, plane/y/x (n,)) -> (B, n/32) i32 packed RAW
    stream bits (no ECC decode) — the channel-quality measurement path
    (utils.metrics.ecc_report wants pre-ECC bits). bit_dense is the
    corner_bits_core output for the SAME mesh: batch-packed i32 words when
    mesh is None (B required), per-image u8 otherwise."""

    if mesh is None:
        assert B > 0

        def fn(bdw, plane, y, x):
            raw_w = _bitcast(bdw[:, plane, y, x], jnp.uint32)  # (Bw, n)
            raw = _unpack_batch_words(raw_w, B)                # (B, n) u8
            return jax.vmap(_pack_bits_words)(raw)

        return jax.jit(fn)

    def core(bd, plane, y, x):
        return _pack_bits_words(bd[plane, y, x])

    fn = jax.vmap(core, in_axes=(0, None, None, None))
    rep = _rep(mesh)
    return jax.jit(fn, in_shardings=(_shardB(mesh, 4), rep, rep, rep),
                   out_shardings=_shardB(mesh, 2))


def unpack_words_host(words: np.ndarray, n: int) -> np.ndarray:
    """(B, n/32) i32 big-endian packed words -> (B, n) u8 bits (host twin of
    _unpack_bits_words)."""
    byts = np.asarray(words).view(np.uint32).astype(">u4")
    bits = np.unpackbits(byts.view(np.uint8).reshape(words.shape[0], -1),
                         axis=1)
    return bits[:, :n]


@functools.lru_cache(maxsize=32)
def corner_gather_decode_core(mesh: Mesh | None = None,
                              hdr_stream_bits: int = 0, B: int = 0,
                              payload_rep: int = 7,
                              with_soft: bool = False):
    """Jitted: (bit_dense, plane/y/x (n,)) -> packed decoded words, same
    output contract as batched_gather_decode_core (rep3 header section +
    payload_rep payload — 7 = Rep-7, 1 = raw bits for host RS decode —
    bit->word packing). bit_dense is corner_bits_core's output for the SAME
    mesh (batch-packed when mesh is None, B required).

    with_soft=True (mesh only): takes (bit_dense, value_dense, plane, y, x)
    — value_dense from corner_bits_core with_values — and returns
    (hard, soft) with the soft row in _decode_sections_soft layout,
    completing the fallback on the mesh-sharded corner extract."""

    def decode(raw):
        return _decode_sections(raw, hdr_stream_bits, payload_rep)

    if mesh is None:
        assert B > 0 and not with_soft

        def fn(bdw, plane, y, x):
            raw_w = _bitcast(bdw[:, plane, y, x], jnp.uint32)  # (Bw, n)
            raw = _unpack_batch_words(raw_w, B)                # (B, n) u8
            return jax.vmap(decode)(raw)

        return jax.jit(fn)

    rep = _rep(mesh)
    if with_soft:
        def one(bd, dv, plane, y, x):
            return (decode(bd[plane, y, x]),
                    _decode_sections_soft(
                        dv[plane, y, x].astype(jnp.float32),
                        hdr_stream_bits, payload_rep))

        fn = jax.vmap(one, in_axes=(0, 0, None, None, None))
        return jax.jit(
            fn,
            in_shardings=(_shardB(mesh, 4), _shardB(mesh, 4), rep, rep, rep),
            out_shardings=(_shardB(mesh, 2), _shardB(mesh, 2)))

    fn = jax.vmap(lambda bd, plane, y, x: decode(bd[plane, y, x]),
                  in_axes=(0, None, None, None))
    return jax.jit(fn, in_shardings=(_shardB(mesh, 4), rep, rep, rep),
                   out_shardings=_shardB(mesh, 2))


def pack_bytes_words_host(rows: list[bytes]) -> np.ndarray:
    """(B,) equal-length byte strings -> (B, ceil(len/4)) int32 big-endian
    words (the layout _unpack_bits_words inverts MSB-first)."""
    n = len(rows[0])
    npad = -(-n // 4) * 4
    arr = np.zeros((len(rows), npad), np.uint8)
    for i, r in enumerate(rows):
        arr[i, :n] = np.frombuffer(r, np.uint8)
    a32 = arr.reshape(len(rows), -1, 4).astype(np.uint32)
    words = (a32[:, :, 0] << 24) | (a32[:, :, 1] << 16) \
        | (a32[:, :, 2] << 8) | a32[:, :, 3]
    return words.view(np.int32)


# Back-compat convenience: full extract in one graph (FFT included), used by
# __graft_entry__ and places that do a single read pass.
@functools.lru_cache(maxsize=32)
def batched_read_core(H: int, W: int, center: bool, adaptive: bool,
                      mesh: Mesh | None = None, shared_idx: bool = True):
    PH, PW = spectral.fft_dims(H, W)

    def full(img_u8, plane, y, x, jitters, alpha):
        spec, med = _analyze_core(img_u8, PH=PH, PW=PW, center=center)
        return _read_core(spec, med, plane, y, x, jitters, alpha,
                          adaptive=adaptive).astype(jnp.int32)

    if shared_idx:
        fn = jax.vmap(full, in_axes=(0, None, None, None, None, None))
    else:
        fn = jax.vmap(full, in_axes=(0, 0, 0, 0, 0, None))
    if mesh is None:
        return jax.jit(fn)
    shard = NamedSharding(mesh, P("batch"))
    rep = NamedSharding(mesh, P())
    n_shard = 1 if shared_idx else 5
    n_rep = 5 if shared_idx else 1
    return jax.jit(fn, in_shardings=(shard,) * n_shard + (rep,) * n_rep,
                   out_shardings=shard)
