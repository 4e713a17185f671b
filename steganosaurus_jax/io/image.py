"""Image load/save (replaces vendored stb_image / stb_image_write).

The reference force-loads 3 channels (`stbi_load(..., 3)`, steganosaur.cpp:909)
— RGBA drops alpha, grayscale replicates — and writes 8-bit RGB PNG
(stbi_write_png, :1104). The PNGs this module writes (8-bit RGB, filter
None/Up) decode on a built-in path with numpy and zlib alone; every other
file goes through PIL, imported only then: `convert("RGB")` drops alpha
without compositing and replicates luma.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from steganosaurus_jax.pipeline.errors import StegoError

_PNG_SIG = b"\x89PNG\r\n\x1a\n"


def _pil_image(path: str):
    """PIL's Image module, for files outside the built-in PNG subset."""
    try:
        from PIL import Image
    except ImportError:
        with open(path, "rb") as f:
            head = f.read(16)
        kind = ("PNG outside the built-in 8-bit RGB subset"
                if head.startswith(_PNG_SIG)
                else f"file starting {head[:8]!r}")
        raise StegoError(f"{path}: {kind} needs Pillow, which is not "
                         f"installed") from None
    return Image


def image_size(path: str) -> tuple[int, int]:
    """(width, height) of an image file. PNGs are read from their IHDR
    chunk (no decode); other formats ask PIL."""
    with open(path, "rb") as f:
        head = f.read(24)
    if len(head) == 24 and head[:8] == _PNG_SIG and head[12:16] == b"IHDR":
        w, h = struct.unpack(">II", head[16:24])
        return w, h
    Image = _pil_image(path)
    with Image.open(path) as im:
        return im.size


def _decode_png_fast(data: bytes) -> np.ndarray | None:
    """Decode the subset of PNGs this module's encoder emits (8-bit RGB,
    non-interlaced, every row filter None/Up) ~3x faster than PIL: one
    zlib inflate + a vectorized mod-256 column cumsum. Returns None for
    anything outside the subset (caller falls back to PIL)."""
    if len(data) < 33 or data[:8] != _PNG_SIG:
        return None
    if data[12:16] != b"IHDR":
        return None
    w, h = struct.unpack(">II", data[16:24])
    bitdepth, color, comp, filt, interlace = data[24:29]
    if (bitdepth, color, comp, filt, interlace) != (8, 2, 0, 0, 0):
        return None  # not plain 8-bit RGB
    if h == 0 or w == 0 or h * w > (1 << 28):
        return None  # absurd declared dims: let PIL's bomb guard decide
    # CRC-check the chunks this path consumes (IHDR + every IDAT) so a
    # bit-corrupted file fails here exactly as it would under PIL, instead
    # of silently decoding to wrong pixels (round-4 advisor finding).
    # zlib.crc32 runs ~GB/s — noise next to the inflate below.
    if zlib.crc32(data[12:29]) != struct.unpack(">I", data[29:33])[0]:
        return None
    idat, pos = [], 8
    while pos + 8 <= len(data):
        (ln,), typ = struct.unpack(">I", data[pos:pos + 4]), \
            data[pos + 4:pos + 8]
        if typ == b"IDAT":
            body = data[pos + 8:pos + 8 + ln]
            if (len(body) != ln or pos + 12 + ln > len(data)
                    or zlib.crc32(typ + body) != struct.unpack(
                        ">I", data[pos + 8 + ln:pos + 12 + ln])[0]):
                return None  # truncated or corrupted IDAT
            idat.append(body)
        elif typ == b"IEND":
            break
        elif typ in (b"tRNS", b"acTL"):  # transparency/APNG: punt to PIL
            return None
        pos += 12 + ln
    stride = 1 + w * 3
    want = h * stride
    # Bounded inflate: never allocate beyond the IHDR-declared size + 1,
    # so a zlib-bomb IDAT cannot balloon memory (PIL's incremental decode
    # has the same property; want+1 detects oversized streams cheaply).
    try:
        raw = zlib.decompressobj().decompress(b"".join(idat), want + 1)
    except zlib.error:
        return None
    if len(raw) != want:
        return None
    rows = np.frombuffer(raw, dtype=np.uint8).reshape(h, stride)
    filters = rows[:, 0]
    px = rows[:, 1:]
    if np.all(filters == 2) or (filters[0] == 0 and h > 1
                                and np.all(filters[1:] == 2)):
        # Up filter: recon(y) = recon(y-1) + raw(y) mod 256 (row 0's Up
        # predecessor is zero, so a leading filter-0 row is equivalent).
        # Row-at-a-time np.add is SIMD; np.cumsum's u8 reduce path is
        # ~30x slower (measured 0.40 s vs 0.013 s on a 4K plane).
        px = px.copy()
        for i in range(1, h):
            np.add(px[i], px[i - 1], out=px[i])
        return px.reshape(h, w, 3)
    if not np.all(filters == 0):
        return None  # Sub/Average/Paeth or mixed: PIL handles it
    return np.ascontiguousarray(px).reshape(h, w, 3)


def load_rgb(path: str) -> np.ndarray:
    """Load an image as (H, W, 3) uint8. PNGs written by save_png (and any
    other None/Up-filtered 8-bit RGB PNG) take a fast vectorized path that
    needs no PIL; everything else decodes via PIL."""
    with open(path, "rb") as f:
        # Probe signature + IHDR (33 bytes) before slurping the file, so
        # PNGs outside the fast subset (grayscale/palette/Paeth) don't pay
        # a full read here AND a second full read in the PIL fallback.
        head = f.read(33)
        if (len(head) == 33 and head[:8] == _PNG_SIG
                and head[12:16] == b"IHDR"
                and head[24:29] == b"\x08\x02\x00\x00\x00"):
            img = _decode_png_fast(head + f.read())
            if img is not None:
                return img
    Image = _pil_image(path)
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), dtype=np.uint8)


def _png_chunk(typ: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + typ + data
            + struct.pack(">I", zlib.crc32(typ + data) & 0xFFFFFFFF))


def encode_png(rgb: np.ndarray) -> bytes:
    """Lossless 8-bit RGB PNG encoder tuned for serving latency.

    PIL's encoder spends ~2.7 s on a 4K stego (per-row adaptive filter
    search + zlib level 6); that was the single largest term in the warm
    `serve` embed p50. This path uses the libpng "fast" recipe — fixed
    Up filter (vectorized as one row-difference) + zlib level 1 with
    Z_RLE strategy — measured ~5x faster at equal-or-smaller output on
    gradient, photo-like, and noise covers (doc/PAPER.md §5b). Output is
    a standard single-IDAT PNG every decoder reads; round-trip equality
    is asserted in tests/test_image_io.py::test_fast_png_lossless.
    """
    assert rgb.dtype == np.uint8 and rgb.ndim == 3 and rgb.shape[2] == 3
    h, w, _ = rgb.shape
    flat = rgb.reshape(h, w * 3)
    raw = np.empty((h, 1 + w * 3), dtype=np.uint8)
    raw[:, 0] = 2  # PNG filter type 2 ("Up"); u8 wraparound == PNG spec
    raw[0, 1:] = flat[0]
    np.subtract(flat[1:], flat[:-1], out=raw[1:, 1:])
    comp = zlib.compressobj(1, zlib.DEFLATED, 15, 8, zlib.Z_RLE)
    idat = comp.compress(raw.tobytes()) + comp.flush()
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)  # 8-bit RGB
    return (_PNG_SIG + _png_chunk(b"IHDR", ihdr)
            + _png_chunk(b"IDAT", idat) + _png_chunk(b"IEND", b""))


def save_png(path: str, rgb: np.ndarray) -> None:
    """Write (H, W, 3) uint8 as a lossless RGB PNG (fast encoder)."""
    data = encode_png(rgb)
    with open(path, "wb") as f:
        f.write(data)
