"""Payload padding wire mode (Params.pad_quantum / --pad; header FLAG
0x04; pipeline/header.py pad_plaintext/unpad_plaintext).

The reference's own doc/TODO.md lists "Payload Padding — add random
padding to ciphertext to obscure message length" as future work; there is
no reference code path. Design: plaintext = BE32(true_len) || secret ||
HKDF-keyed pad to the next pad_quantum multiple, so the header clen — and
the written-bin footprint a warden could count — quantizes to byte
buckets. The pad is deterministic per (key, salt) so sealed streams stay
reproducible for verify retries and channel reports. The stock reference
binary still AEAD-opens padded stegos, but its output truncates at the
length prefix's NUL bytes (interop degraded, not failed — asserted
below)."""

import numpy as np
import pytest

from steganosaurus_jax.config import Params
from steganosaurus_jax.pipeline import header as header_mod
from steganosaurus_jax.pipeline.batch import embed_batch, extract_batch
from steganosaurus_jax.pipeline.embed import embed_array
from steganosaurus_jax.pipeline.extract import extract_array

MK = bytes(range(32))
P_PAD = Params(pbkdf2_iter=1000, pad_quantum=256)


@pytest.fixture(scope="module")
def cover():
    rng = np.random.default_rng(31)
    base = rng.integers(180, 221, (256, 256, 3))
    return (base + rng.integers(-10, 11, (256, 256, 3))).clip(0, 255).astype(
        np.uint8)


def test_pad_unpad_helpers():
    key = bytes(32)
    for n in (0, 1, 251, 252, 300):
        pt = header_mod.pad_plaintext(b"x" * n, 256, key)
        assert len(pt) % 256 == 0 and len(pt) >= n + 4
        assert header_mod.unpad_plaintext(pt) == b"x" * n
    # deterministic per key; different keys give different pad bytes
    a = header_mod.pad_plaintext(b"s", 64, b"\x01" * 32)
    assert a == header_mod.pad_plaintext(b"s", 64, b"\x01" * 32)
    assert a != header_mod.pad_plaintext(b"s", 64, b"\x02" * 32)
    # malformed framing fails closed
    assert header_mod.unpad_plaintext(b"\x00\x00") is None
    assert header_mod.unpad_plaintext(b"\x00\x00\x01\x00" + b"x" * 8) is None


def test_padded_clen_quantizes(cover):
    """Secrets of different lengths inside one bucket produce IDENTICAL
    sealed stream sizes (the length-leak the mode exists to close), and
    round-trip. The wire clen equals the padded plaintext length."""
    from steganosaurus_jax import crypto

    p = Params(pbkdf2_iter=1000, pad_quantum=128)
    salt = bytes([7]) * 16
    km = crypto.derive_keys_from_raw(MK, salt)
    for secret in (b"a", b"b" * 60, b"c" * 100):
        pt = header_mod.pad_plaintext(secret, 128, km.aead_key)
        assert len(pt) == 128  # identical bucket for all three lengths
        r = embed_array(cover, secret, master_key=MK, params=p, salt=salt)
        # written payload bits reflect the padded clen, not the secret
        assert r.payload_bytes == len(secret)
        assert r.written_bits == 38 * 8 * 3 + (128 + 16) * 8 * 7
        assert extract_array(r.stego, master_key=MK, params=p) == secret


def test_padded_batch_roundtrip(cover):
    """Batch path: mixed-length secrets, auto-detected extraction (no
    pad param needed on the extract side)."""
    B = 4
    covers = np.stack([cover] * B)
    secrets = [b"s%d" % i * (i + 1) for i in range(B)]
    res = embed_batch(covers, secrets, master_key=MK, params=P_PAD)
    stego = np.asarray(res.stego)
    assert extract_batch(stego, master_key=MK,
                         params=Params(pbkdf2_iter=1000)) == secrets


def test_padded_rs_compose(cover):
    """Padding composes with the RS payload FEC (both flag bits set,
    auto-detected on extraction)."""
    p = Params(pbkdf2_iter=1000, pad_quantum=128, rs=True)
    secret = b"pad+rs" * 40
    r = embed_array(cover, secret, master_key=MK, params=p)
    assert extract_array(r.stego, master_key=MK,
                         params=Params(pbkdf2_iter=1000)) == secret


def test_reference_binary_interop_degrades(cover, tmp_path, reference_bin):
    """Interop contract (measured): the stock reference binary AEAD-opens
    a padded stego (same walk, same AEAD — it succeeds), but its output
    truncates at the BE32 length prefix's leading NUL bytes, so the
    secret never appears in its stdout. Degraded, not crashed."""
    from steganosaurus_jax.io import image as image_io
    from tests.test_reference_parity import _run

    secret = b"hidden-behind-framing"
    r = embed_array(cover, secret, password="pw",
                    params=Params(pbkdf2_iter=1000, pad_quantum=64))
    stego = tmp_path / "pad_stego.png"
    image_io.save_png(str(stego), r.stego)
    res = _run([reference_bin, "extract", "--in", stego, "--pass", "pw",
                "--pbkdf2_iter", "1000"])
    assert res.returncode == 0
    assert secret.decode() not in res.stdout


def test_pad_large_quantum_past_hkdf_expand_cap():
    """Pads longer than RFC 5869's 255-block expand cap (8160 bytes) must
    chunk, not crash (regression: bytes([ctr]) overflow at ctr=256)."""
    key = bytes(32)
    pt = header_mod.pad_plaintext(b"x", 16384, key)
    assert len(pt) == 16384
    assert header_mod.unpad_plaintext(pt) == b"x"
    # deterministic across calls at chunked sizes too
    assert pt == header_mod.pad_plaintext(b"x", 16384, key)


def test_channel_report_pad_rs_layout(cover):
    """channel_report's RS post-ECC decode must use the PADDED clen (the
    on-wire message size), not the secret length — clean padded RS
    batches read back with zero post-ECC BER."""
    from steganosaurus_jax.pipeline.batch import channel_report, embed_batch

    p = Params(pbkdf2_iter=1000, pad_quantum=128, rs=True)
    secrets, salts = [b"pad-rs-ber" * 5], [bytes([9]) * 16]
    res = embed_batch(cover[None], secrets, master_key=MK, params=p,
                      salts=salts)
    rep = channel_report(np.asarray(res.stego), secrets, salts,
                         master_key=MK, params=p)
    assert rep["payload_ber_post_ecc"] == 0.0
    assert rep["header_ber_post_ecc"] == 0.0


def test_padded_verify_hint_covers_fused_pass(cover, monkeypatch):
    """embed_batch(verify=True) must hint the PADDED clen: the verify
    extraction's fused pass covers the payload and no corrected
    payload-only pass (with_header=False) is dispatched."""
    from steganosaurus_jax.pipeline import batch as pbm

    second_passes = []
    orig = pbm._ExtractJob._dispatch_pass

    def spy(self, payload_stream_bits, with_header, qim=None, rs=None):
        if not with_header:
            second_passes.append(payload_stream_bits)
        return orig(self, payload_stream_bits, with_header, qim=qim, rs=rs)

    monkeypatch.setattr(pbm._ExtractJob, "_dispatch_pass", spy)
    res = embed_batch(np.stack([cover] * 2), [b"hint-a", b"hint-b" * 3],
                      master_key=MK, params=P_PAD, verify=True)
    assert all(res.verified)
    assert second_passes == []


def test_requantization_report_rs_and_pad(cover):
    """requantization_noise_report builds its frame through the same
    seal/FEC path as the embeds (header.seal_stream + frame_bits), so it
    works — with the right frame sizes — under rs and pad_quantum."""
    from steganosaurus_jax.utils.channel import requantization_noise_report

    rep = requantization_noise_report(
        cover, b"m" * 600, master_key=MK,
        params=Params(pbkdf2_iter=1000, rs=True, pad_quantum=128))
    # RS frame: 912 header bits + coded bits of the PADDED message
    from steganosaurus_jax.ops import rs as rs_mod
    assert rep["n_bins"] == 912 + rs_mod.coded_len(
        header_mod.padded_len(600, 128) + 16) * 8
    assert rep["raw_flip_rate_payload"] < 0.5
