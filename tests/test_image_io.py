"""Image I/O: the fast PNG encoder must be losslessly decodable by a
stock decoder (PIL) — the stego channel requires bit-exact pixels
(reference analog: stb_image_write PNG, steganosaur.cpp:1104)."""

import io

import numpy as np
import pytest
from PIL import Image

from steganosaurus_jax.io import image as image_io


def _families(rng, h, w):
    grad = (np.linspace(0, 255, w, dtype=np.uint8)[None, :, None]
            + np.zeros((h, 1, 3), np.uint8))
    photo = (grad.astype(np.int16)
             + rng.integers(-10, 10, (h, w, 3))).clip(0, 255).astype(np.uint8)
    noise = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    return {"grad": grad, "photo": photo, "noise": noise}


@pytest.mark.parametrize("hw", [(1, 1), (1, 7), (5, 1), (33, 17), (64, 64),
                                (127, 255)])
def test_fast_png_lossless(hw):
    rng = np.random.default_rng(sum(hw))
    for name, img in _families(rng, *hw).items():
        data = image_io.encode_png(img)
        back = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
        assert np.array_equal(back, img), (name, hw)


def test_save_load_roundtrip(tmp_path):
    rng = np.random.default_rng(7)
    img = rng.integers(0, 256, (48, 31, 3), dtype=np.uint8)
    p = tmp_path / "x.png"
    image_io.save_png(str(p), img)
    assert np.array_equal(image_io.load_rgb(str(p)), img)
    # Standard signature + parseable by PIL's strict verifier.
    raw = p.read_bytes()
    assert raw[:8] == b"\x89PNG\r\n\x1a\n"
    with Image.open(p) as im:
        im.verify()


def test_encoder_output_smaller_or_close_to_pil():
    """The fast path trades filter search for speed; Z_RLE keeps output
    within a small factor of PIL's default on every cover family."""
    rng = np.random.default_rng(3)
    for name, img in _families(rng, 256, 256).items():
        fast = len(image_io.encode_png(img))
        buf = io.BytesIO()
        Image.fromarray(img, "RGB").save(buf, format="PNG")
        assert fast <= 1.6 * buf.tell() + 1024, (name, fast, buf.tell())


def test_fast_decode_path_matches_pil(tmp_path):
    """load_rgb's fast path (our own Up-filtered PNGs) and the PIL
    fallback (arbitrary-filter PNGs) must both return exact pixels."""
    rng = np.random.default_rng(5)
    for name, img in _families(rng, 77, 53).items():
        p = tmp_path / f"{name}.png"
        image_io.save_png(str(p), img)  # fast encoder -> fast decoder
        assert np.array_equal(image_io.load_rgb(str(p)), img), name
        q = tmp_path / f"{name}_pil.png"
        Image.fromarray(img, "RGB").save(str(q), format="PNG")
        assert np.array_equal(image_io.load_rgb(str(q)), img), name
    # fast path actually engages on our own files
    raw = (tmp_path / "noise.png").read_bytes()
    assert image_io._decode_png_fast(raw) is not None
    # PIL's adaptive-filter output falls back (unless it chose None/Up)
    assert image_io.load_rgb(str(tmp_path / "noise_pil.png")) is not None


def test_fast_decode_rejects_oddballs(tmp_path):
    """Non-PNG magic, truncated streams, and non-RGB PNGs must not crash
    the fast path — they return None/fall back to PIL."""
    assert image_io._decode_png_fast(b"not a png") is None
    rng = np.random.default_rng(6)
    img = rng.integers(0, 256, (9, 9, 3), dtype=np.uint8)
    data = image_io.encode_png(img)
    assert image_io._decode_png_fast(data[:40]) is None
    # grayscale PNG via PIL -> fast path declines, load_rgb still works
    p = tmp_path / "gray.png"
    Image.fromarray(img[:, :, 0], "L").save(str(p))
    assert image_io._decode_png_fast(p.read_bytes()) is None
    g = image_io.load_rgb(str(p))
    assert g.shape == (9, 9, 3) and np.array_equal(g[:, :, 0], img[:, :, 0])


def test_fast_decode_bounds_zlib_bomb():
    """An IDAT that inflates far beyond the IHDR-declared size must be
    rejected by the fast path WITHOUT materializing the inflated stream
    (bounded decompressobj read), falling back to PIL's own guards."""
    import struct
    import zlib

    from steganosaurus_jax.io.image import _decode_png_fast, _png_chunk

    ihdr = struct.pack(">IIBBBBB", 4, 4, 8, 2, 0, 0, 0)  # declares 4x4
    bomb = zlib.compress(b"\x00" * 50_000_000, 9)  # ~50 MB inflated
    data = (b"\x89PNG\r\n\x1a\n" + _png_chunk(b"IHDR", ihdr)
            + _png_chunk(b"IDAT", bomb) + _png_chunk(b"IEND", b""))
    assert _decode_png_fast(data) is None
    # absurd declared dims punt to PIL before any inflate
    huge = struct.pack(">IIBBBBB", 1 << 15, 1 << 15, 8, 2, 0, 0, 0)
    data2 = (b"\x89PNG\r\n\x1a\n" + _png_chunk(b"IHDR", huge)
             + _png_chunk(b"IDAT", bomb) + _png_chunk(b"IEND", b""))
    assert _decode_png_fast(data2) is None


def test_fast_decode_rejects_corrupted_crc():
    """A bit-corrupted None/Up RGB PNG must NOT decode silently to wrong
    pixels on the fast path (round-4 advisor finding): the chunk CRC check
    bounces it to None so load semantics match PIL's strictness."""
    from steganosaurus_jax.io.image import _decode_png_fast, encode_png

    rng = np.random.default_rng(5)
    img = rng.integers(0, 256, (24, 16, 3), dtype=np.uint8)
    data = encode_png(img)
    assert np.array_equal(_decode_png_fast(data), img)
    # flip one bit inside the IDAT payload (after the 8-byte sig + 25-byte
    # IHDR chunk + 8-byte IDAT header)
    corrupt = bytearray(data)
    corrupt[8 + 25 + 8 + 5] ^= 0x10
    assert _decode_png_fast(bytes(corrupt)) is None
    # corrupt the IHDR CRC itself
    corrupt = bytearray(data)
    corrupt[30] ^= 0x01
    assert _decode_png_fast(bytes(corrupt)) is None


@pytest.mark.parametrize("hw", [(1, 1), (33, 17), (256, 384), (1080, 1920)])
def test_image_size_from_ihdr(tmp_path, hw):
    """image_size reads a PNG's IHDR (width, height) without decoding, and
    agrees with PIL; non-PNG files still go through PIL."""
    h, w = hw
    path = tmp_path / "x.png"
    image_io.save_png(str(path), np.zeros((h, w, 3), np.uint8))
    assert image_io.image_size(str(path)) == (w, h)
    with Image.open(path) as im:
        assert im.size == (w, h)
    bmp = tmp_path / "x.bmp"
    Image.fromarray(np.zeros((h, w, 3), np.uint8)).save(bmp)
    assert image_io.image_size(str(bmp)) == (w, h)


def test_cli_embed_extract_without_pil(tmp_path, monkeypatch, capsysbinary):
    """The main path needs no Pillow: embed/extract of a save_png cover with
    PIL unimportable, and a clear StegoError for a file outside the
    built-in PNG subset."""
    import base64
    import sys

    from steganosaurus_jax import cli
    from steganosaurus_jax.pipeline.errors import StegoError

    rng = np.random.default_rng(5)
    base = np.linspace(150, 230, 192)[None, :, None]
    cover = np.clip(base + rng.integers(-12, 13, (128, 192, 3)), 0, 255)
    host, stego = tmp_path / "host.png", tmp_path / "stego.png"
    image_io.save_png(str(host), cover.astype(np.uint8))
    bmp = tmp_path / "cover.bmp"
    Image.fromarray(cover.astype(np.uint8)).save(bmp)
    key = base64.b64encode(bytes(range(32))).decode()

    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)
    assert cli.main(["turtlefft", "embed", "--in", str(host), "--out",
                     str(stego), "--secret", "no pillow", "--key", key]) == 0
    capsysbinary.readouterr()
    assert cli.main(["turtlefft", "extract", "--in", str(stego),
                     "--key", key]) == 0
    assert capsysbinary.readouterr().out.rstrip(b"\n") == b"no pillow"
    with pytest.raises(StegoError, match="needs Pillow"):
        image_io.load_rgb(str(bmp))
    with pytest.raises(StegoError, match="needs Pillow"):
        image_io.image_size(str(bmp))
