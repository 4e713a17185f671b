"""Interleaved Reed-Solomon payload FEC in the pipelines (Params.rs;
ops/rs.py + pipeline/embed.py frame_bits + pipeline/extract.py).

The reference's own doc/TODO.md lists "Stronger FEC (Reed-Solomon or
LDPC)" with interleaving as future work; there is no reference code path —
the wire behavior (header FLAGS bit 0x02, auto-detected at extraction) is
defined by this framework. The stock reference binary must fail CLOSED on
RS stegos (its Rep-7 payload walk length diverges -> AEAD reject)."""

import numpy as np
import pytest

from steganosaurus_jax.config import Params
from steganosaurus_jax.ops import rs as rs_mod
from steganosaurus_jax.pipeline import header as header_mod
from steganosaurus_jax.pipeline.embed import embed_array, frame_bits
from steganosaurus_jax.pipeline.extract import extract_array
from steganosaurus_jax.pipeline.errors import StegoError

MK = bytes(range(32))
P_RS = Params(pbkdf2_iter=1000, rs=True)
P_PLAIN = Params(pbkdf2_iter=1000)


@pytest.fixture(scope="module")
def cover():
    rng = np.random.default_rng(21)
    base = rng.integers(180, 221, (256, 256, 3))
    return (base + rng.integers(-10, 11, (256, 256, 3))).clip(0, 255).astype(
        np.uint8)


def test_frame_bits_rs_layout():
    hdr = bytes(range(38))
    ct, tag = b"x" * 100, b"t" * 16
    plain = frame_bits(hdr, ct, tag)
    rsf = frame_bits(hdr, ct, tag, rs=True)
    assert len(plain) == 38 * 8 * 3 + 116 * 8 * 7
    assert len(rsf) == 38 * 8 * 3 + rs_mod.coded_len(116) * 8
    # header section identical (always Rep-3)
    np.testing.assert_array_equal(plain[: 38 * 8 * 3], rsf[: 38 * 8 * 3])


def test_roundtrip_and_autodetect(cover):
    secret = np.random.default_rng(3).bytes(300)
    r = embed_array(cover, secret, master_key=MK, params=P_RS)
    # Rep-7 would need (300+16)*8*7 = 17696 payload bits — over this
    # cover's capacity; RS fits easily
    assert r.written_bits == 912 + rs_mod.coded_len(316) * 8
    assert r.written_bits < 17696
    # extraction with the flag, and with defaults (header auto-detect)
    assert extract_array(r.stego, master_key=MK, params=P_RS) == secret
    assert extract_array(r.stego, master_key=MK, params=P_PLAIN) == secret


def test_capacity_multiplier(cover):
    """RS carries ~6x the payload of Rep-7 in the same cover."""
    big = np.random.default_rng(4).bytes(1400)  # rep7: 79k bits >> capacity
    with pytest.raises(StegoError):
        embed_array(cover, big, master_key=MK, params=P_PLAIN)
    r = embed_array(cover, big, master_key=MK, params=P_RS)
    assert extract_array(r.stego, master_key=MK, params=P_PLAIN) == big


def test_rs_composes_with_other_modes(cover):
    secret = b"rs compose check" * 5
    for kw in (dict(qim=6), dict(per_image_walk=True),
               dict(soft_write=True), dict(qim=4, per_image_walk=True)):
        p = Params(pbkdf2_iter=1000, rs=True, **kw)
        r = embed_array(cover, secret, master_key=MK, params=p)
        out = extract_array(r.stego, master_key=MK, params=P_PLAIN)
        assert out == secret, kw


def test_wrong_password_fast_fail(cover):
    r = embed_array(cover, b"secret", password="right",
                    params=P_RS.replace(soft_decode_fallback=False))
    with pytest.raises(StegoError, match="Magic not found"):
        extract_array(r.stego, password="wrong",
                      params=P_RS.replace(soft_decode_fallback=False))


def test_noise_recovery_via_rs_correction(cover):
    """Pixel noise flips some payload bits; RS corrects where Rep-7 would
    majority-vote. Light noise on a strong-margin write must round-trip."""
    secret = np.random.default_rng(6).bytes(600)
    r = embed_array(cover, secret, master_key=MK, params=P_RS)
    rng = np.random.default_rng(7)
    noisy = r.stego.astype(np.int16).copy()
    mask = rng.random(noisy.shape) < 0.02
    noisy[mask] += rng.integers(-1, 2, mask.sum()).astype(np.int16)
    noisy = noisy.clip(0, 255).astype(np.uint8)
    assert extract_array(noisy, master_key=MK, params=P_RS) == secret


@pytest.fixture(scope="module")
def batch_covers():
    """Moderate-texture covers INSIDE the RS channel envelope. RS(255,223)
    corrects ~6% byte corruption (t=16/codeword); full-random-noise covers
    run the rounding channel at ~1% raw bit BER => ~8% byte errors, beyond
    ANY decoder (measured: 17-30 errors/codeword, capacity 16) — Rep-7 is
    the mode for such channels (ops/rs.py docstring). These covers match
    the documented RS usage: raw BER well under 0.5%."""
    rng = np.random.default_rng(22)
    base = rng.integers(60, 196, (6, 1, 1, 3))
    grad = np.linspace(0, 40, 160)[None, None, :, None]
    noise = rng.integers(-12, 13, (6, 128, 160, 3))
    return (base + grad + noise).clip(0, 255).astype(np.uint8)


def _batch_secrets(rng=None):
    rng = rng or np.random.default_rng(23)
    return [rng.bytes(200 + 13 * i) for i in range(6)]


def test_batch_roundtrip_hint_and_autodetect(batch_covers):
    from steganosaurus_jax.pipeline.batch import embed_batch, extract_batch

    secrets = _batch_secrets()
    r = embed_batch(batch_covers, secrets, master_key=MK, params=P_RS)
    # speculative fused pass covers the hint -> single device round-trip
    got = extract_batch(r.stego, master_key=MK, params=P_RS,
                        clen_hint=max(len(s) for s in secrets))
    assert got == secrets
    # plain-params extraction: the assumed Rep-7 pass reads the header,
    # the RS flag triggers a corrected payload-only pass
    assert extract_batch(r.stego, master_key=MK, params=P_PLAIN) == secrets


def test_batch_verify_channel_and_isolation(batch_covers):
    from steganosaurus_jax.pipeline.batch import (channel_report,
                                                  embed_batch, extract_batch)

    secrets = _batch_secrets()
    r = embed_batch(batch_covers, secrets, master_key=MK, params=P_RS,
                    verify=True)
    assert r.verified == [True] * 6
    rep = channel_report(np.asarray(r.stego), secrets, r.salts,
                         master_key=MK, params=P_RS)
    assert rep["payload_ber_post_ecc"] == 0.0
    assert rep["payload_ber_raw"] < 0.05
    # per-image isolation: trashing one image must not sink the others
    bad = np.array(r.stego)
    bad[2] = np.random.default_rng(1).integers(
        0, 256, bad[2].shape).astype(np.uint8)
    got = extract_batch(bad, master_key=MK, params=P_RS)
    assert got[2] is None
    assert [got[i] for i in (0, 1, 3, 4, 5)] == [
        secrets[i] for i in (0, 1, 3, 4, 5)]


def test_batch_rs_piw(batch_covers):
    from steganosaurus_jax.pipeline.batch import embed_batch, extract_batch

    secrets = _batch_secrets()
    p = Params(pbkdf2_iter=1000, rs=True, per_image_walk=True)
    r = embed_batch(batch_covers, secrets, master_key=MK, params=p)
    assert extract_batch(r.stego, master_key=MK,
                         params=P_PLAIN) == secrets


@pytest.mark.skipif(
    len(__import__("jax").devices()) < 8, reason="needs 8 devices")
def test_batch_rs_over_mesh(batch_covers):
    from steganosaurus_jax.parallel import batch as pbatch
    from steganosaurus_jax.pipeline.batch import embed_batch, extract_batch

    mesh = pbatch.make_mesh(8)
    imgs = np.concatenate([batch_covers, batch_covers[:2]], axis=0)  # B=8
    secrets = _batch_secrets() + [b"seven", b"eight"]
    r = embed_batch(imgs, secrets, master_key=MK, params=P_RS, mesh=mesh)
    got = extract_batch(r.stego, master_key=MK, params=P_RS, mesh=mesh,
                        clen_hint=max(len(s) for s in secrets))
    assert got == secrets


def test_stream_rs(batch_covers):
    from steganosaurus_jax.pipeline.stream import embed_stream, extract_stream

    secrets = _batch_secrets()
    feeds = [(batch_covers, secrets), (batch_covers, secrets[::-1])]
    stegos = [np.asarray(r.stego) for r in
              embed_stream(iter(feeds), master_key=MK, params=P_RS)]
    outs = list(extract_stream(iter(stegos), master_key=MK, params=P_RS,
                               clen_hint=max(len(s) for s in secrets)))
    assert outs[0] == secrets and outs[1] == secrets[::-1]


def test_soft_fallback_rs_batch(batch_covers):
    """Force a payload margin failure and check the RS errors-and-erasures
    fallback path executes (the recovery itself is channel-dependent; the
    assertion is that hard-pass failures do not crash and anything the
    fallback recovers is correct)."""
    from steganosaurus_jax.pipeline.batch import embed_batch, extract_batch

    secrets = _batch_secrets()
    r = embed_batch(batch_covers, secrets, master_key=MK, params=P_RS)
    noisy = np.array(r.stego).astype(np.int16)
    rng = np.random.default_rng(8)
    mask = rng.random(noisy.shape) < 0.15
    noisy += np.where(mask, rng.integers(-2, 3, noisy.shape), 0)
    noisy = noisy.clip(0, 255).astype(np.uint8)
    got = extract_batch(noisy, master_key=MK, params=P_RS)
    for g, s in zip(got, secrets):
        assert g is None or g == s


def test_reference_binary_fails_closed(cover, tmp_path, reference_bin):
    """The stock reference binary must NOT extract an RS stego (it would
    read the payload as Rep-7 at the wrong length) — and must not crash."""
    from steganosaurus_jax.io import image as image_io
    from tests.test_reference_parity import _run

    stego = tmp_path / "rs_stego.png"
    r = embed_array(cover, b"not for the reference", password="pw",
                    params=Params(pbkdf2_iter=1000, rs=True))
    image_io.save_png(str(stego), r.stego)
    res = _run([reference_bin, "extract", "--in", stego, "--pass", "pw",
                "--pbkdf2_iter", "1000"])
    assert res.returncode != 0 or "not for the reference" not in res.stdout


def test_rs_inline_soft_conf(monkeypatch):
    """RS wire mode margin failures recover via the INLINE soft sections'
    per-coded-byte confidences (errors-and-erasures, ops/rs.py) with the
    retry pass stubbed out — the conf words ride the same fused pull
    (parallel.batch corner_extract_fused_core with_soft, rep=1)."""
    from steganosaurus_jax.pipeline import batch as pbm
    from steganosaurus_jax.pipeline.batch import embed_batch, extract_batch

    rng = np.random.default_rng(1)
    cover = rng.integers(0, 256, (256, 256, 3)).astype(np.uint8)
    B = 8
    covers = np.stack([cover] * B)
    secrets = [bytes(rng.integers(0, 256, 1200, dtype=np.uint8))] * B
    salts = [bytes([i]) * 16 for i in range(B)]
    hard_p = Params(rs=True, soft_decode_fallback=False)
    soft_p = Params(rs=True)
    res = embed_batch(covers, secrets, master_key=MK, params=hard_p,
                      salts=salts)
    stego = np.asarray(res.stego)
    hard = extract_batch(stego, master_key=MK, params=hard_p)
    n_hard = sum(g is None for g in hard)
    assert n_hard > 0, "margin fixture no longer fails hard"

    monkeypatch.setattr(pbm._ExtractJob, "_soft_retry_failed",
                        lambda self, headers, out: None)
    inline = extract_batch(stego, master_key=MK, params=soft_p)
    n_inline = sum(g is None for g in inline)
    assert n_inline < n_hard, (n_inline, n_hard)
    for g in inline:
        assert g is None or g == secrets[0]
