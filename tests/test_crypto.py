"""Crypto unit tests: RFC vectors, native/pure cross-checks, key wrapping."""

import pytest

from steganosaurus_jax import _native_loader, crypto
from steganosaurus_jax.crypto import _pure, keywrap

RFC_KEY = bytes(range(0x80, 0xA0))
RFC_NONCE = bytes.fromhex("070000004041424344454647")
RFC_AAD = bytes.fromhex("50515253c0c1c2c3c4c5c6c7")
RFC_PT = (
    b"Ladies and Gentlemen of the class of '99: If I could offer you "
    b"only one tip for the future, sunscreen would be it."
)


def test_chacha20_block_rfc8439():
    # RFC 8439 §2.3.2
    key = bytes(range(32))
    nonce = bytes.fromhex("000000090000004a00000000")
    block = _pure.chacha20_block(key, 1, nonce)
    assert block[:16].hex() == "10f1e7e4d13b5915500fdd1fa32071c4"


def test_poly1305_rfc8439_vector():
    key = bytes.fromhex(
        "85d6be7857556d337f4452fe42d506a8"
        "0103808afb0db2fd4abff6af4149f51b"
    )
    tag = _pure.poly1305_mac(b"Cryptographic Forum Research Group", key, ref_compat=False)
    assert tag.hex() == "a8061dc1305136c6c22b8baf0c0127a9"


def test_aead_rfc8439_vector_rfc_mode():
    ct, tag = _pure.aead_seal(RFC_KEY, RFC_NONCE, RFC_AAD, RFC_PT, ref_compat=False)
    assert ct[:16].hex() == "d31a8d34648e60db7b86afbc53ef7ec2"
    assert tag.hex() == "1ae10b594f09e26a7e902ecbd0600691"
    assert _pure.aead_open(RFC_KEY, RFC_NONCE, RFC_AAD, ct, tag, ref_compat=False) == RFC_PT


def test_ref_compat_tags_differ_from_rfc():
    """The reference's Poly1305 serialization bug must be reproduced, not fixed."""
    _, tag_ref = _pure.aead_seal(RFC_KEY, RFC_NONCE, RFC_AAD, RFC_PT, ref_compat=True)
    _, tag_rfc = _pure.aead_seal(RFC_KEY, RFC_NONCE, RFC_AAD, RFC_PT, ref_compat=False)
    assert tag_ref != tag_rfc


@pytest.mark.parametrize("ref_compat", [True, False])
@pytest.mark.parametrize("ptlen", [0, 1, 15, 16, 17, 64, 113, 1000])
def test_native_matches_pure(ref_compat, ptlen):
    lib = _native_loader.get()
    if lib is None:
        pytest.skip("native library not built")
    pt = bytes(i % 251 for i in range(ptlen))
    for aad in (b"", RFC_AAD, b"x" * 38):
        a = _pure.aead_seal(RFC_KEY, RFC_NONCE, aad, pt, ref_compat)
        b = lib.aead_seal(RFC_KEY, RFC_NONCE, aad, pt, ref_compat)
        assert a == b
        assert lib.aead_open(RFC_KEY, RFC_NONCE, aad, a[0], a[1], ref_compat) == pt
        bad = bytes([a[1][0] ^ 1]) + a[1][1:]
        assert lib.aead_open(RFC_KEY, RFC_NONCE, aad, a[0], bad, ref_compat) is None
        assert _pure.aead_open(RFC_KEY, RFC_NONCE, aad, a[0], bad, ref_compat) is None


def test_hkdf_rfc5869_case1():
    ikm = b"\x0b" * 22
    salt = bytes(range(13))
    info = bytes.fromhex("f0f1f2f3f4f5f6f7f8f9")
    prk = crypto.hkdf_extract(salt, ikm)
    assert prk.hex() == (
        "077709362c2e32df0ddc3f0dc47bba6390b6c73bb50f9c3122ec844ad7c2b3e5"
    )
    okm = crypto.hkdf_expand(prk, info, 42)
    assert okm.hex() == (
        "3cb25f25faacd57a90434f64d0362f2a2d2d0a90cf1a5a4c5db02d56ecc4c5bf"
        "34007208d5b887185865"
    )


def test_pbkdf2_known_vector():
    # RFC 7914 §11 PBKDF2-HMAC-SHA-256 test vector
    dk = crypto.pbkdf2_hmac_sha256(b"passwd", b"salt", 1, 64)
    assert dk.hex().startswith("55ac046e56e3089fec1691c22544b605")


def test_key_material_split():
    km = crypto.derive_keys("pw", b"\x00" * 16, 100)
    assert len(km.aead_key) == 32 and len(km.nonce) == 12
    km2 = crypto.derive_keys_from_raw(b"\x01" * 32, b"\x00" * 16)
    assert km2.aead_key != km.aead_key


def test_path_key_salt_independent():
    """Walk key must ignore the salt (reference rationale :1136-1143)."""
    assert crypto.derive_path_key("pw", None) == crypto.sha256(b"pw")
    assert crypto.derive_path_key(None, b"\x02" * 32) == crypto.sha256(b"\x02" * 32)
    ch = b"\xaa" * 32
    assert crypto.derive_path_key("pw", None, ch) == crypto.sha256(b"pw" + ch)


def test_keywrap_main_roundtrip():
    mk = crypto.get_random_bytes(32)
    blob = keywrap.wrap_key_main(mk, "wrap-pw", 1000)
    assert len(blob) == 80 and blob[:4] == b"TFKW"
    assert keywrap.unwrap_key_main(blob, "wrap-pw", 1000) == mk
    assert keywrap.unwrap_key_main(blob, "wrong", 1000) is None


def test_keywrap_tool_roundtrip():
    mk = crypto.get_random_bytes(32)
    blob = keywrap.wrap_key_tool(mk, "wrap-pw")
    assert len(blob) == 81 and blob[:4] == b"TFKW" and blob[4] == 1
    assert keywrap.unwrap_key_tool(blob, "wrap-pw") == mk
    assert keywrap.unwrap_key_tool(blob, "nope") is None


def test_decode_or_unwrap_key():
    mk = crypto.get_random_bytes(32)
    assert keywrap.decode_or_unwrap_key(crypto.base64_encode(mk), "", 1000) == mk
    blob = keywrap.wrap_key_main(mk, "w", 1000)
    assert keywrap.decode_or_unwrap_key(crypto.base64_encode(blob), "w", 1000) == mk
    assert keywrap.decode_or_unwrap_key(crypto.base64_encode(blob), "", 1000) is None
    assert keywrap.decode_or_unwrap_key("!!!notb64", "", 1000) is None


def test_fingerprint_and_base64():
    assert crypto.key_fingerprint(b"\x00" * 32) == crypto.sha256(b"\x00" * 32)[:8].hex()
    assert crypto.base64_decode(" QU JD \n ") == b"ABC"  # whitespace skipping


def test_decode_or_unwrap_accepts_tool_format():
    """Interop-bug fix: `--key` accepts keys wrapped by the key TOOL (81B
    TFKW v1) as well as the main binary's 80B format (SURVEY.md §3.4 — the
    reference rejects its own tool's output)."""
    from steganosaurus_jax import crypto
    from steganosaurus_jax.crypto import keywrap

    key = bytes(range(32))
    tool_blob = keywrap.wrap_key_tool(key, "pw")
    assert len(tool_blob) == keywrap.TOOL_WRAPPED_LEN
    b64 = crypto.base64_encode(tool_blob)
    assert keywrap.decode_or_unwrap_key(b64, "pw", 1000) == key
    assert keywrap.decode_or_unwrap_key(b64, "", 1000) is None
    assert keywrap.decode_or_unwrap_key(b64, "wrong", 1000) is None
