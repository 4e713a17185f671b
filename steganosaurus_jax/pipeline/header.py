"""Wire-format header framing (reference Header, steganosaur.cpp:879-904).

38-byte plaintext header embedded under Rep-3:
MAGIC "FTTG"(4) || VER=2(1) || FLAGS(1) || SALT(16) || NONCE(12) || CLEN(4, BE).
The 16-byte Poly1305 tag is NOT part of the header; it is appended after the
ciphertext in the Rep-7 payload stream.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

MAGIC = b"FTTG"
VERSION = 2
FIXED_LEN = 4 + 1 + 1 + 16 + 12 + 4  # 38

# FLAGS bits. The reference writes FLAGS=0 and never reads it
# (steganosaur.cpp:884,897), so flag bits are a forward-compatible channel:
# a flagged stego still header-parses everywhere, and the reference binary
# fails closed (payload walk diverges -> AEAD auth failure).
FLAG_PER_IMAGE_WALK = 0x01  # payload walk is salt-keyed (pipeline/batch.py)
FLAG_RS_PAYLOAD = 0x02      # payload FEC is interleaved RS(255,223) instead
#                             of Rep-7 (ops/rs.py; ~6x capacity). The header
#                             itself always stays Rep-3: it must be locatable
#                             and decodable before any flag is known.
FLAG_PADDED = 0x04          # plaintext is BE32(true_len) || secret || keyed
#                             pad to a Params.pad_quantum multiple (the
#                             reference doc/TODO.md "Payload Padding" item:
#                             clen — and with it the spectral footprint —
#                             leaks only the padded bucket, not the true
#                             message length). pad/unpad helpers below.
FLAG_COHERENT = 0x08        # payload bits are channel-coherent common-mode
#                             writes on a salt-keyed chained walk with
#                             coherent site semantics (Params.coherent;
#                             ops/phase.py embed_phases_coherent — the
#                             cross-channel warden counter-move, measured
#                             in doc/ATTACKS.md §2e). Header stays on the
#                             standard shared-walk write.

# FLAGS bits 4-7 carry the QIM quantizer level L (Params.qim; 0 = payload on
# the reference's hard +-alpha write, 2..15 = dithered phase QIM with step
# 2*pi/L — pipeline/qim.py). Self-describing so extraction needs no param.
QIM_SHIFT = 4


_PAD_INFO = b"turtle_pad"


def padded_len(secret_len: int, quantum: int) -> int:
    """Plaintext length (= wire clen) after FLAG_PADDED framing."""
    return -(-(4 + secret_len) // quantum) * quantum


def pad_plaintext(secret: bytes, quantum: int, aead_key) -> bytes:
    """Frame `secret` as BE32(len) || secret || pad so the plaintext length
    is the next `quantum` multiple (FLAG_PADDED wire mode). Pad bytes are
    HKDF-expanded from the AEAD key (deterministic per (key, salt) — the
    whole sealed stream stays reproducible for channel reports and verify
    retries; randomness is unnecessary because the pad only ever exists
    under ChaCha20), chunked under RFC 5869's 255-block expand cap. A
    warden estimating payload size from the spectral footprint sees only
    the padded bucket.

    `aead_key` is the 32-byte key, or a vaulted-keys object exposing
    hkdf_expand(info, n) (crypto.VaultedKeys — the key then never leaves
    the native mlock'd slot; HKDF output is one-way)."""
    if quantum <= 0:
        raise ValueError("pad_quantum must be positive")
    inner = struct.pack(">I", len(secret)) + secret
    n = padded_len(len(secret), quantum) - len(inner)
    if not n:
        return inner
    from steganosaurus_jax import crypto

    if hasattr(aead_key, "hkdf_expand"):
        expand = aead_key.hkdf_expand
    else:
        def expand(info, ln):
            return crypto.hkdf_expand(aead_key, info, ln)
    chunks = [expand(_PAD_INFO + struct.pack(">I", i), min(8160, n - i))
              for i in range(0, n, 8160)]  # 8160 = 255 * 32, the RFC cap
    return inner + b"".join(chunks)


def unpad_plaintext(pt: bytes) -> bytes | None:
    """Inverse of pad_plaintext on an AEAD-authenticated plaintext. None on
    malformed framing (fails closed; cannot happen on honest streams since
    the length prefix is covered by the tag)."""
    if len(pt) < 4:
        return None
    n = struct.unpack(">I", pt[:4])[0]
    if 4 + n > len(pt):
        return None
    return bytes(pt[4:4 + n])


def maybe_unpad(pt: bytes | None, flags: int) -> bytes | None:
    """Post-AEAD-open unframing, keyed on the FLAGS byte of the header the
    open was performed UNDER (never a differently-sourced header — a
    soft-corrected header may carry a different FLAG_PADDED bit than the
    hard-decoded one). None stays None; malformed framing fails closed."""
    if pt is None or not (flags & FLAG_PADDED):
        return pt
    return unpad_plaintext(pt)


def seal_stream(secret: bytes, km, flags: int,
                pad_quantum: int) -> tuple[bytes, bytes, bytes]:
    """(header_bytes, ct, tag) for one image: the ONE place plaintext
    framing (FLAG_PADDED padding), the wire clen, and the AEAD seal are
    decided — embed_array, embed_batch, and channel_report all build
    their streams here so the three can never disagree on the frame.

    `km` is a KeyMaterial (legacy: keys as Python bytes) or a vaulted-keys
    object (crypto.derive_keys_vault: seal/HKDF run in the native mlock'd
    vault, the AEAD key never materializes in Python)."""
    from steganosaurus_jax import crypto

    vk = km if hasattr(km, "seal") else crypto._FallbackKeys(km)
    pt = secret
    if pad_quantum:
        flags |= FLAG_PADDED
        pt = pad_plaintext(secret, pad_quantum, vk)
    hb = Header(salt=vk.salt, nonce=vk.nonce, clen=len(pt),
                flags=flags).to_bytes()
    ct, tag = vk.seal(hb, pt)
    return hb, ct, tag


def qim_levels(flags: int) -> int:
    """QIM level L from a header FLAGS byte (0 = QIM off)."""
    return (flags >> QIM_SHIFT) & 0x0F


def flags_with_qim(flags: int, L: int) -> int:
    assert L == 0 or 2 <= L <= 15
    return flags | (L << QIM_SHIFT)


@dataclass
class Header:
    salt: bytes           # 16
    nonce: bytes          # 12
    clen: int
    flags: int = 0
    ver: int = VERSION

    def to_bytes(self) -> bytes:
        assert len(self.salt) == 16 and len(self.nonce) == 12
        return (
            MAGIC
            + bytes([self.ver, self.flags])
            + self.salt
            + self.nonce
            + struct.pack(">I", self.clen)
        )

    @classmethod
    def from_bytes(cls, data: bytes) -> "Header":
        """Parse without validation; callers check magic/version explicitly to
        preserve the reference's distinct error messages (:1236-1238)."""
        assert len(data) >= FIXED_LEN
        return cls(
            ver=data[4],
            flags=data[5],
            salt=bytes(data[6:22]),
            nonce=bytes(data[22:34]),
            clen=struct.unpack(">I", data[34:38])[0],
        )
