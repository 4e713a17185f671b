"""Quantization write floor (Params.write_floor).

The u8 quantize step erases any write whose summed per-pixel spatial delta
stays inside (-0.5, 0.5): the cover is integer-valued, so round() returns
the original pixel DETERMINISTICALLY — no dither, no partial credit.
Discovered at 4K with a single-bucket frame (delta RMS 0.15 px, read-back
BER 0.45 — total loss; every 4K recovery test before this used >= 16 KB
payloads whose summed delta clears the threshold). The floor predicts the
spatial RMS via Parseval and magnitude-boosts every moved bin's target
nv -> b*nv (phase exact, decode unchanged — including by the reference
binary; b == 1 whenever the write already clears the floor).

The tests run a 2048^2 LOW-NOISE cover: flat + tiny noise gives small
annulus magnitudes, so a small frame is deep in the erasure regime while
the FFT stays cheap (same physics as the 4K failure, ~6x faster)."""

import numpy as np
import pytest

from steganosaurus_jax.config import Params
from steganosaurus_jax.pipeline.batch import embed_batch, extract_batch
from steganosaurus_jax.pipeline.embed import embed_array
from steganosaurus_jax.pipeline.errors import StegoError
from steganosaurus_jax.pipeline.extract import extract_array

FAST = dict(pbkdf2_iter=500)
MK = bytes(range(32))


@pytest.fixture(scope="module")
def big_flat_cover():
    rng = np.random.default_rng(19)
    img = np.clip(180.0 + rng.integers(-2, 3, (2048, 2048, 3)),
                  0, 255).astype(np.uint8)
    return img


def test_sub_lsb_write_is_erased_without_floor(big_flat_cover):
    """The mechanism: floor=0 reproduces deterministic erasure — a small
    frame in a big low-noise cover does not survive u8 rounding."""
    p = Params(write_floor=0.0, **FAST)
    res = embed_batch(big_flat_cover[None], [b"tiny"], master_key=MK,
                      params=p, salts=[b"\x05" * 16])
    got = extract_batch(np.asarray(res.stego), master_key=MK, params=p)
    assert got == [None]  # erased -> header unreadable -> isolated failure


def test_floor_restores_batch_roundtrip(big_flat_cover):
    p = Params(**FAST)
    res = embed_batch(big_flat_cover[None], [b"tiny payload"], master_key=MK,
                      params=p, salts=[b"\x05" * 16])
    got = extract_batch(np.asarray(res.stego), master_key=MK, params=p)
    assert got == [b"tiny payload"]


def test_floor_restores_single_path_roundtrip(big_flat_cover):
    p = Params(**FAST)
    res = embed_array(big_flat_cover, b"single tiny", master_key=MK,
                      params=p, salt=b"\x06" * 16)
    assert extract_array(res.stego, master_key=MK, params=p) == b"single tiny"
    with pytest.raises(StegoError):
        p0 = Params(write_floor=0.0, **FAST)
        res0 = embed_array(big_flat_cover, b"single tiny", master_key=MK,
                           params=p0, salt=b"\x06" * 16)
        extract_array(res0.stego, master_key=MK, params=p0)


def test_floor_noop_is_bit_identical(small_image):
    """b == 1 regime (small covers clear the floor naturally): the floored
    embed must be BIT-IDENTICAL to write_floor=0 — certified configs and
    reference pixel parity are untouched."""
    kw = dict(master_key=MK, salts=[b"\x07" * 16])
    r1 = embed_batch(small_image[None], [b"x" * 40], params=Params(**FAST),
                     **kw)
    r0 = embed_batch(small_image[None], [b"x" * 40],
                     params=Params(write_floor=0.0, **FAST), **kw)
    assert np.array_equal(np.asarray(r1.stego), np.asarray(r0.stego))


def test_write_floor_boost_math():
    """Unit: the closed-form b solves rho(b) = floor; b clamps to 1 above
    the floor and to 32 in hopeless configs."""
    import jax.numpy as jnp

    from steganosaurus_jax.ops.phase import write_floor_boost

    rng = np.random.default_rng(3)
    n, px = 256, 1024.0 * 1024.0
    # sigma sized so the solving b lands inside (1, 32): A ~ 2 n sigma^2,
    # b ~ sqrt(E*/A) with E* = 1.5 (floor px)^2
    v = (rng.normal(0, 5000, n) + 1j * rng.normal(0, 5000, n))
    th = rng.uniform(-np.pi, np.pi, n)
    nv = np.abs(v) * np.exp(1j * th)
    wm = jnp.ones(n, bool)
    floor = 0.45
    b = float(write_floor_boost(jnp.asarray(v, jnp.complex64),
                                jnp.asarray(nv, jnp.complex64), wm, px,
                                floor))
    assert b > 1.0
    E = np.sum(np.abs(b * nv - v) ** 2)
    rho = np.sqrt(2.0 * E / (3.0 * px * px))
    assert rho == pytest.approx(floor, rel=2e-3)
    # already above the floor -> exactly 1
    b1 = float(write_floor_boost(jnp.asarray(v * 1e6, jnp.complex64),
                                 jnp.asarray(nv * 1e6, jnp.complex64),
                                 wm, px, floor))
    assert b1 == 1.0
    # hopeless -> clipped at 32
    b32 = float(write_floor_boost(jnp.asarray(v * 1e-4, jnp.complex64),
                                  jnp.asarray(nv * 1e-4, jnp.complex64),
                                  wm, px, floor))
    assert b32 == 32.0


def test_corner_apply_write_floor_matches_slot_form():
    """Unit: the dense corner twin produces D_b = 2*(b*nv - v) with the
    same b as the slot-form solver, and leaves zero-delta bins at zero."""
    import jax.numpy as jnp

    from steganosaurus_jax.ops.phase import write_floor_boost
    from steganosaurus_jax.spectral.corner import apply_write_floor

    rng = np.random.default_rng(5)
    K, px = 32, 512.0 * 512.0
    cr = rng.normal(0, 200, (3, K, K)).astype(np.float32)
    ci = rng.normal(0, 200, (3, K, K)).astype(np.float32)
    wm = rng.random((3, K, K)) < 0.1
    mag = np.hypot(cr, ci)
    th = rng.uniform(-np.pi, np.pi, (3, K, K))
    nvr = np.where(wm, mag * np.cos(th), cr).astype(np.float32)
    nvi = np.where(wm, mag * np.sin(th), ci).astype(np.float32)
    dr = (2.0 * (nvr - cr)).astype(np.float32)
    di = (2.0 * (nvi - ci)).astype(np.float32)
    floor = 0.45
    dr_b, di_b = (np.asarray(a) for a in apply_write_floor(
        jnp.asarray(dr), jnp.asarray(di), jnp.asarray(cr), jnp.asarray(ci),
        floor, px))
    v = (cr + 1j * ci)[wm]
    nv = (nvr + 1j * nvi)[wm]
    b = float(write_floor_boost(jnp.asarray(v, jnp.complex64),
                                jnp.asarray(nv, jnp.complex64),
                                jnp.ones(v.shape, bool), px, floor))
    want_r = 2.0 * (b * nvr - cr)
    want_i = 2.0 * (b * nvi - ci)
    np.testing.assert_allclose(dr_b[wm], want_r[wm], rtol=2e-3)
    np.testing.assert_allclose(di_b[wm], want_i[wm], rtol=2e-3)
    assert np.all(dr_b[~wm] == 0) and np.all(di_b[~wm] == 0)
