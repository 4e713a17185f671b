"""Dithered phase QIM (Params.qim; pipeline/qim.py) — the rebuild-only
payload write that quantizes each payload bin's phase onto a keyed-dithered
lattice of step 2*pi/L. The reference's own doc/TODO.md lists QIM/STDM as
future work; there is no reference code path — behavior here is defined by
this framework (header FLAGS bits 4-7 carry L, auto-detected at extraction;
pipeline/header.py).

Pixel-level parity between the corner-matmul batch path and the
scatter/FFT single path is NOT expected for QIM: round() in the lattice
quantizer is data-dependent, so f32 spectral noise can land a boundary bin
in cell k vs k+-1 — both centroids of the SAME coset, so DECODE parity
holds (asserted below) while a few pixels differ.
"""

import numpy as np
import pytest

from steganosaurus_jax.config import Params
from steganosaurus_jax.pipeline import header as header_mod
from steganosaurus_jax.pipeline import qim as qim_mod
from steganosaurus_jax.pipeline.batch import (channel_report, embed_batch,
                                              extract_batch)
from steganosaurus_jax.pipeline.embed import embed_array
from steganosaurus_jax.pipeline.extract import extract_array
from steganosaurus_jax.pipeline.errors import StegoError

MK = bytes(range(32))


@pytest.fixture(scope="module")
def cover():
    rng = np.random.default_rng(11)
    return rng.integers(0, 256, (256, 256, 3)).astype(np.uint8)


@pytest.fixture(scope="module")
def batch_covers():
    rng = np.random.default_rng(12)
    return rng.integers(0, 256, (8, 128, 160, 3)).astype(np.uint8)


def test_flags_roundtrip():
    f = header_mod.flags_with_qim(header_mod.FLAG_PER_IMAGE_WALK, 13)
    assert header_mod.qim_levels(f) == 13
    assert f & header_mod.FLAG_PER_IMAGE_WALK
    assert header_mod.qim_levels(0) == 0


def test_dither_angles_range_and_determinism():
    d1 = qim_mod.dither_angles(MK, 3, 1000)
    d2 = qim_mod.dither_angles(MK, 3, 1000)
    np.testing.assert_array_equal(d1, d2)
    assert d1.min() >= 0.0 and d1.max() < 2 * np.pi / 3
    # different keys -> different draws
    assert not np.array_equal(d1, qim_mod.dither_angles(b"x" * 32, 3, 1000))


def test_validate_rejects_bad_combos():
    with pytest.raises(StegoError):
        qim_mod.validate(Params(qim=1))
    with pytest.raises(StegoError):
        qim_mod.validate(Params(qim=16))
    with pytest.raises(StegoError):
        qim_mod.validate(Params(qim=3, adaptive_alpha=True))
    with pytest.raises(StegoError):
        qim_mod.validate(Params(qim=3, cover_dependent_path=True))
    qim_mod.validate(Params(qim=3))  # valid


@pytest.mark.parametrize("L", [2, 3, 6, 15])
def test_single_roundtrip_autodetect(cover, L):
    secret = bytes(range(64))
    p = Params(qim=L, pbkdf2_iter=1000)
    res = embed_array(cover, secret, master_key=MK, params=p, salt=b"s" * 16)
    # extraction auto-detects L from the header; no qim param given
    got = extract_array(res.stego, master_key=MK,
                        params=Params(pbkdf2_iter=1000))
    assert got == secret


def test_f64_backend_roundtrip_and_cross_decode(cover):
    secret = b"qim f64 oracle"
    p64 = Params(qim=3, pbkdf2_iter=1000, fft_dtype="complex128")
    res = embed_array(cover, secret, master_key=MK, params=p64,
                      salt=b"t" * 16)
    # same-backend round trip
    assert extract_array(res.stego, master_key=MK, params=p64) == secret
    # cross-backend: f64-embedded stego decodes on the c64/jax path
    assert extract_array(res.stego, master_key=MK,
                         params=Params(pbkdf2_iter=1000)) == secret


def test_batch_matches_single_decode_and_nearly_pixels(cover):
    secret = bytes(range(48))
    p = Params(qim=3, pbkdf2_iter=1000)
    salt = b"u" * 16
    single = embed_array(cover, secret, master_key=MK, params=p, salt=salt)
    batch = embed_batch(cover[None], [secret], master_key=MK, params=p,
                        salts=[salt])
    st_b = np.asarray(batch.stego)[0]
    # decode parity both ways (see module docstring for why not pixels)
    assert extract_array(st_b, master_key=MK,
                         params=Params(pbkdf2_iter=1000)) == secret
    assert extract_batch(single.stego[None], master_key=MK,
                         params=p, clen_hint=len(secret)) == [secret]
    # and the two stegos are near-identical: the few boundary bins that
    # land in different (same-coset) lattice cells spread as low-amplitude
    # IFFT noise over all pixels
    from steganosaurus_jax.utils import metrics

    assert metrics.psnr(st_b, single.stego) > 40.0
    assert np.abs(st_b.astype(int) - single.stego.astype(int)).max() <= 4


def test_batch_roundtrip_modes(batch_covers):
    secrets = [bytes([65 + i]) * 40 for i in range(8)]
    salts = [bytes([i]) * 16 for i in range(8)]
    for p in (Params(qim=3, pbkdf2_iter=1000),
              Params(qim=4, jitter=0.3, alpha_spread=0.5, soft_write=True,
                     pbkdf2_iter=1000),
              Params(qim=3, per_image_walk=True, pbkdf2_iter=1000)):
        res = embed_batch(batch_covers, secrets, master_key=MK, params=p,
                          salts=salts)
        got = extract_batch(np.asarray(res.stego), master_key=MK,
                            params=Params(pbkdf2_iter=1000), clen_hint=40)
        assert got == secrets, p


def test_batch_mesh_roundtrip(batch_covers):
    from steganosaurus_jax.parallel import batch as pbatch

    mesh8 = pbatch.make_mesh(8)
    secrets = [bytes([65 + i]) * 40 for i in range(8)]
    salts = [bytes([i]) * 16 for i in range(8)]
    p = Params(qim=3, pbkdf2_iter=1000)
    res = embed_batch(batch_covers, secrets, master_key=MK, params=p,
                      salts=salts, mesh=mesh8)
    got = extract_batch(res.stego, master_key=MK, params=p, mesh=mesh8,
                        clen_hint=40)
    assert got == secrets
    # the mesh-embedded stego also extracts single-chip with auto-detect
    got2 = extract_batch(np.asarray(res.stego), master_key=MK,
                         params=Params(pbkdf2_iter=1000), clen_hint=40)
    assert got2 == secrets


def test_mixed_levels_one_extract_batch(batch_covers):
    """A batch mixing QIM levels and the hard write extracts in one call:
    finalize groups images by their header-carried L."""
    secrets = [bytes([65 + i]) * 40 for i in range(8)]
    parts = []
    for sl, p in ((slice(0, 3), Params(qim=3, pbkdf2_iter=1000)),
                  (slice(3, 6), Params(qim=6, pbkdf2_iter=1000)),
                  (slice(6, 8), Params(pbkdf2_iter=1000))):
        parts.append(np.asarray(embed_batch(
            batch_covers[sl], secrets[sl], master_key=MK, params=p,
            verify=True).stego))
    mixed = np.concatenate(parts)
    got = extract_batch(mixed, master_key=MK,
                        params=Params(pbkdf2_iter=1000), clen_hint=40)
    assert got == secrets


def test_channel_report_qim(batch_covers):
    secrets = [bytes([65 + i]) * 30 for i in range(8)]
    salts = [bytes([i + 1]) * 16 for i in range(8)]
    p = Params(qim=3, pbkdf2_iter=1000)
    res = embed_batch(batch_covers, secrets, master_key=MK, params=p,
                      salts=salts)
    rep = channel_report(res.stego, secrets, salts, master_key=MK, params=p)
    assert rep["payload_ber_post_ecc"] == 0.0
    assert rep["payload_ber_raw"] < 0.05


def test_qim_beats_hard_and_soft_psnr(cover):
    """The QIM energy claim (doc/ATTACKS.md §1b): at equal payload and equal
    decode margin (L=3 ~ alpha=0.5), QIM writes measurably less energy than
    both the hard and the minimal-energy soft write."""
    from steganosaurus_jax.utils import metrics

    secret = bytes(np.random.default_rng(5).integers(0, 256, 200,
                                                     dtype=np.uint8))
    out = {}
    for name, p in (("hard", Params(pbkdf2_iter=1000)),
                    ("soft", Params(pbkdf2_iter=1000, soft_write=True)),
                    ("qim", Params(pbkdf2_iter=1000, qim=3))):
        res = embed_array(cover, secret, master_key=MK, params=p,
                          salt=b"v" * 16)
        out[name] = metrics.psnr(cover, res.stego)
    assert out["qim"] > out["soft"] > out["hard"]


def test_qim_flattens_phase_histogram(cover):
    """The QIM stealth claim (doc/ATTACKS.md §2b): the keyed dither makes
    written-bin phases marginally uniform — the chi-square warden statistic
    collapses vs the hard write (measured ~48x on this cover/payload)."""
    from steganosaurus_jax.utils.steganalysis import phase_histogram_report

    secret = bytes(np.random.default_rng(6).integers(0, 256, 200,
                                                     dtype=np.uint8))
    z = {}
    for name, p in (("hard", Params(pbkdf2_iter=1000)),
                    ("qim", Params(pbkdf2_iter=1000, qim=3))):
        res = embed_array(cover, secret, master_key=MK, params=p,
                          salt=b"w" * 16)
        z[name] = phase_histogram_report(res.stego, p)["chi2_z"]
    assert z["qim"] < z["hard"] / 10


def test_soft_fallback_on_qim_margin_failure():
    """The matched-filter fallback works under the QIM decision values:
    construct a margin-stressed batch (small cover, near-capacity payload,
    higher L = smaller margin) and check the fallback recovers salts the
    hard nearest-coset decode loses."""
    rng = np.random.default_rng(1)
    cover = rng.integers(0, 256, (256, 256, 3)).astype(np.uint8)
    secret = bytes(rng.integers(0, 256, 220, dtype=np.uint8))
    hard = Params(qim=8, pbkdf2_iter=1000, soft_decode_fallback=False)
    soft = Params(qim=8, pbkdf2_iter=1000)
    hard_fail = soft_fail = 0
    for s in range(24):
        salt = bytes([s]) * 16
        res = embed_array(cover, secret, master_key=MK, params=hard,
                          salt=salt)
        try:
            assert extract_array(res.stego, master_key=MK,
                                 params=hard) == secret
        except StegoError:
            hard_fail += 1
            try:
                assert extract_array(res.stego, master_key=MK,
                                     params=soft) == secret
            except StegoError:
                soft_fail += 1
    assert soft_fail <= hard_fail
    if hard_fail:  # when the margin does bite, the fallback must help
        assert soft_fail < hard_fail
