"""Pure-Python keystream + turtle-walk expansion (reference semantics, exact).

This replays, byte-for-byte, the reference's sequential per-bit selection loop
(steganosaur.cpp:665-810 `KS`/`Turtle`, :1074-1097 embed loop, :1205-1220
extract loop) and emits flat index/jitter arrays. The device side then runs a
single vectorized gather -> phase-rotate -> scatter — the data-parallel
refactoring of the reference's strictly sequential hot loop #3 (SURVEY.md §3.5).

The C++ backend (native/keystream.cc) implements the same expansion ~100x
faster; tests assert both produce identical streams.
"""

from __future__ import annotations

import hashlib
import math
import struct

import numpy as np


class KS:
    """Counter-mode SHA-256 PRG (reference struct KS, steganosaur.cpp:665-695).

    Block i = SHA256(key || 0xAA || LE32(i)), 32 bytes each.
    """

    __slots__ = ("key", "state", "pos", "ctr", "bitpool", "bits")

    def __init__(self, key: bytes):
        assert len(key) == 32
        self.key = key
        self.state = b"\x00" * 32
        self.pos = 32
        self.ctr = 0
        self.bitpool = 0
        self.bits = 0

    def next_byte(self) -> int:
        if self.pos >= 32:
            block = self.key + b"\xaa" + struct.pack("<I", self.ctr)
            self.state = hashlib.sha256(block).digest()
            self.pos = 0
            self.ctr += 1
        b = self.state[self.pos]
        self.pos += 1
        return b

    def next_opcode3(self) -> int:
        # 3 bits MSB-first from an accumulating bitpool (reference :685).
        while self.bits < 3:
            self.bitpool = ((self.bitpool << 8) | self.next_byte()) & 0xFFFFFFFF
            self.bits += 8
        op = (self.bitpool >> (self.bits - 3)) & 7
        self.bits -= 3
        return op

    def hit_density(self, density: float) -> bool:
        # true iff byte < uint8(floor(density*256)) (reference :686-689).
        # NB the reference quirk: density >= 1.0 folds to threshold 0 via the
        # uint8_t cast, so NOTHING ever embeds — replicated faithfully; the
        # expansion loop's step budget turns the hang into an error.
        thresh = int(math.floor(density * 256.0)) & 0xFF
        return self.next_byte() < thresh

    def jitter(self, maxj: float) -> float:
        # int16 from two bytes -> u in [-1, 1) -> u*maxj (reference :690-694).
        hi = self.next_byte()
        lo = self.next_byte()
        r = (hi << 8) | lo
        if r >= 0x8000:
            r -= 0x10000
        return (r / 32768.0) * maxj


def turtle_seed(walk_key: bytes, H: int, W: int) -> tuple[int, int, int]:
    """Start position (y, x, plane) (reference Turtle ctor, :762-769)."""
    seed = b"seed:" + f"{H}x{W}".encode() + b"|key:" + walk_key
    h = hashlib.sha256(seed).digest()
    s = int.from_bytes(h[:8], "big")
    return s % H, (s >> 16) % W, (s >> 32) % 3


def on_axis(y: int, x: int, H: int, W: int) -> bool:
    """Axis/Nyquist exclusion (reference :698-700)."""
    return y == 0 or x == 0 or (H % 2 == 0 and y == H // 2) or (W % 2 == 0 and x == W // 2)


def conj_idx(y: int, x: int, H: int, W: int) -> tuple[int, int]:
    """Hermitian-conjugate bin index (reference :370-372)."""
    yy = 0 if y == 0 else H - y
    xx = 0 if x == 0 else W - x
    return yy % H, xx % W


def turtle_expand(
    walk_key: bytes,
    plane_keys: tuple[bytes, bytes, bytes],
    H: int,
    W: int,
    rmin: float,
    rmax: float,
    density: float,
    jitter_max: float,
    nbits: int,
    max_steps: int | None = None,
    allow_short: bool = False,
    init_visited: np.ndarray | None = None,
    want_visited: bool = False,
    coherent: bool = False,
) -> tuple:
    """Expand the keyed walk into per-bit (plane, y, x, jitter) arrays.

    Exactly replays: per bit, `{advance_to_valid(); density-accept or
    mark-and-retry}` (:1076-1081 / :1206), then one per-plane jitter draw — two
    bytes consumed even when jitter_max == 0.0 (:719 / :1208) — then
    mark_here() on the accepted bin AND its conjugate (:805-809).

    coherent=True (rebuild-only; Params.coherent payload walks): a written
    bit rotates ALL THREE planes at its (y, x) site by one common phase
    delta (ops/phase.py coherent write), so a site is consumed as a WHOLE:
    the visited check rejects a candidate if ANY plane of (y, x) or its
    conjugate is marked, and every mark — accept and density-skip alike —
    marks all three planes at both (y, x) and the conjugate. The walk
    dynamics (opcode stream, plane hops, jitter draws keyed by the current
    plane) are otherwise unchanged; keystream consumption is identical to
    the standard walk on the same accept/skip sequence, so embed and
    extract replay each other exactly. The reference has no such mode.

    `max_steps` bounds total walk steps, fixing the reference's unbounded-loop
    hazard on corrupted clen (doc/TESTING.md:151-156). On exhaustion: raises
    RuntimeError, unless allow_short=True — then the remaining slots are padded
    with the last produced bin and a 5-tuple (plane, y, x, jitter, nproduced)
    is returned. With allow_short the return is always the 5-tuple.

    Visited chaining (per-image-walk mode; native twin turtle_expand_v):
    init_visited pre-seeds the visited set from a prior expansion — the
    salt-keyed payload walk resumes from the shared header walk's state so
    its bins never collide with the header's. want_visited=True appends the
    final visited bitmap to the return tuple. Bitmaps are uint64 word arrays
    of (3*H*W + 63)//64 words, bit index (plane*H + y)*W + x (matching the
    native layout).
    """
    ks_walk = KS(walk_key)
    ks_planes = (KS(plane_keys[0]), KS(plane_keys[1]), KS(plane_keys[2]))
    y, x, plane = turtle_seed(walk_key, H, W)
    if init_visited is not None:
        nwords = (3 * H * W + 63) // 64
        assert init_visited.shape == (nwords,)
        bits = np.unpackbits(
            init_visited.astype("<u8").view(np.uint8), bitorder="little")
        visited = bits[: 3 * H * W].astype(bool).reshape(3, H, W)
    else:
        visited = np.zeros((3, H, W), dtype=bool)

    def _pack_visited() -> np.ndarray:
        nwords = (3 * H * W + 63) // 64
        flat = np.packbits(visited.reshape(-1), bitorder="little")
        out = np.zeros(nwords * 8, dtype=np.uint8)
        out[: flat.size] = flat
        return out.view("<u8").astype(np.uint64)
    rlo = rmin * min(H, W)
    rhi = rmax * min(H, W)
    if max_steps is None:
        # Generous default: ~64 walk steps per candidate, plus the initial
        # ~distance^2 diffusion to reach the annulus on large grids.
        max_steps = max(10_000_000, 64 * nbits * 8 + 4 * H * W)

    out_plane = np.empty(nbits, dtype=np.int32)
    out_y = np.empty(nbits, dtype=np.int32)
    out_x = np.empty(nbits, dtype=np.int32)
    out_j = np.empty(nbits, dtype=np.float64)

    if coherent:
        def _vis(p, yy, xx):
            return bool(visited[:, yy, xx].any())

        def _mark(p, yy, xx):
            visited[:, yy, xx] = True
    else:
        def _vis(p, yy, xx):
            return bool(visited[p, yy, xx])

        def _mark(p, yy, xx):
            visited[p, yy, xx] = True

    steps = 0
    for i in range(nbits):
        while True:  # candidate loop (advance + density Bernoulli)
            # --- advance_to_valid (reference :778-804) ---
            while True:
                steps += 1
                if steps > max_steps:
                    if not allow_short:
                        raise RuntimeError(
                            f"turtle walk exhausted {max_steps} steps at bit "
                            f"{i}/{nbits}"
                        )
                    # pad remaining slots with the last valid bin (jitter 0)
                    if i > 0:
                        lp, ly, lx = out_plane[i - 1], out_y[i - 1], out_x[i - 1]
                    else:
                        lp, ly, lx = 0, 1, 1
                    out_plane[i:] = lp
                    out_y[i:] = ly
                    out_x[i:] = lx
                    out_j[i:] = 0.0
                    ret = (out_plane, out_y, out_x, out_j, i)
                    return ret + (_pack_visited(),) if want_visited else ret
                op = ks_walk.next_opcode3()
                if op == 0:
                    plane = (plane + 1) % 3
                elif op == 1:
                    x = (x + 1) % W
                elif op == 2:
                    y = (y + 1) % H
                elif op == 3:
                    x = (x - 1) % W
                elif op == 4:
                    y = (y - 1) % H
                elif op == 5:
                    x = (x + 1) % W
                    y = (y + 1) % H
                elif op == 6:
                    x = (x - 1) % W
                    y = (y + 1) % H
                # op 7: stay
                if on_axis(y, x, H, W):
                    continue
                if y == 0 and x == 0:
                    continue
                if _vis(plane, y, x):
                    continue
                r = math.hypot(y, x)
                if r < rlo or r > rhi:
                    continue
                # magnitude check intentionally disabled (reference :797-799)
                cy, cx = conj_idx(y, x, H, W)
                if _vis(plane, cy, cx):
                    continue
                break
            if ks_walk.hit_density(density):
                break
            # density skip: mark used-but-empty (reference :1079-1080)
            _mark(plane, y, x)
            cy, cx = conj_idx(y, x, H, W)
            _mark(plane, cy, cx)

        out_plane[i] = plane
        out_y[i] = y
        out_x[i] = x
        out_j[i] = ks_planes[plane].jitter(jitter_max)
        _mark(plane, y, x)
        cy, cx = conj_idx(y, x, H, W)
        _mark(plane, cy, cx)

    if want_visited:
        # with want_visited the produced count is always included (native
        # turtle_expand_v return contract): (p, y, x, j, nprod, visited)
        return out_plane, out_y, out_x, out_j, nbits, _pack_visited()
    if allow_short:
        return out_plane, out_y, out_x, out_j, nbits
    return out_plane, out_y, out_x, out_j
