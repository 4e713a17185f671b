"""Keystream/turtle tests: golden reference coordinates + native/pure equality."""

import hashlib

import numpy as np
import pytest

from steganosaurus_jax import _native_loader, crypto
from steganosaurus_jax.keystream import _pure


# Captured from the reference binary built with -DDEBUG=1:
#   turtlefft embed --in host.png(256x256) --secret "Hello World!"
#   --pass testpass  =>  [EMBED bit i] lines (steganosaur.cpp:1082-1084).
GOLDEN_PASS = "testpass"
GOLDEN_COORDS = [  # (plane, y, x) for bits 0..9, 256x256, defaults
    (2, 13, 6), (2, 14, 5), (0, 15, 6), (0, 15, 7), (0, 15, 8),
    (0, 16, 9), (1, 15, 9), (1, 16, 9), (1, 17, 9), (1, 17, 10),
]
GOLDEN_PATH_KEY_PREFIX = "13d249f2cb4127b4"


def _keys(password: str):
    pk = crypto.derive_path_key(password, None)
    return pk, crypto.derive_turtle_keys(pk)


def test_golden_coordinates_vs_reference_debug():
    pk, (kw, kr, kg, kb) = _keys(GOLDEN_PASS)
    assert pk[:8].hex() == GOLDEN_PATH_KEY_PREFIX
    p, y, x, _ = _pure.turtle_expand(kw, (kr, kg, kb), 256, 256, 0.05, 0.45, 0.7, 0.0, 10)
    got = list(zip(p.tolist(), y.tolist(), x.tolist()))
    assert got == GOLDEN_COORDS


def test_ks_prg_structure():
    key = hashlib.sha256(b"k").digest()
    ks = _pure.KS(key)
    first = bytes(ks.next_byte() for _ in range(64))
    import struct

    b0 = hashlib.sha256(key + b"\xaa" + struct.pack("<I", 0)).digest()
    b1 = hashlib.sha256(key + b"\xaa" + struct.pack("<I", 1)).digest()
    assert first == b0 + b1


def test_opcode_msb_first():
    key = hashlib.sha256(b"op").digest()
    ks = _pure.KS(key)
    raw = _pure.KS(key)
    stream = [raw.next_byte() for _ in range(4)]
    bits = "".join(f"{b:08b}" for b in stream)
    ops = [ks.next_opcode3() for _ in range(10)]
    expect = [int(bits[3 * i : 3 * i + 3], 2) for i in range(10)]
    assert ops == expect


def test_jitter_range_and_consumption():
    key = hashlib.sha256(b"j").digest()
    ks = _pure.KS(key)
    vals = [ks.jitter(0.25) for _ in range(100)]
    assert all(-0.25 <= v < 0.25 for v in vals)
    # zero max still consumes two bytes (extract-side sync, reference :1208)
    ks2 = _pure.KS(key)
    assert ks2.jitter(0.0) == 0.0
    ref = _pure.KS(key)
    ref.next_byte(), ref.next_byte()
    assert ks2.next_byte() == ref.next_byte()


@pytest.mark.parametrize(
    "H,W,rmin,rmax,density,jitter,n",
    [
        (256, 256, 0.05, 0.45, 0.7, 0.0, 2480),
        (512, 512, 0.05, 0.45, 0.7, 0.05, 3000),
        (128, 256, 0.10, 0.40, 0.9, 0.02, 500),
        (64, 64, 0.05, 0.45, 0.3, 0.0, 100),
    ],
)
def test_native_matches_pure(H, W, rmin, rmax, density, jitter, n):
    lib = _native_loader.get()
    if lib is None:
        pytest.skip("native library not built")
    kw, kr, kg, kb = crypto.derive_turtle_keys(crypto.sha256(b"xpass"))
    a = lib.turtle_expand(kw, (kr, kg, kb), H, W, rmin, rmax, density, jitter, n, 10**9)
    b = _pure.turtle_expand(kw, (kr, kg, kb), H, W, rmin, rmax, density, jitter, n)
    for u, v in zip(a, b):
        np.testing.assert_array_equal(u, v)


def test_walk_properties():
    """Accepted bins: unique, off-axis, inside annulus, conjugate-disjoint."""
    kw, kr, kg, kb = crypto.derive_turtle_keys(crypto.sha256(b"props"))
    H = W = 128
    p, y, x, _ = _pure.turtle_expand(kw, (kr, kg, kb), H, W, 0.05, 0.45, 0.7, 0.0, 400)
    seen = set()
    for pi, yi, xi in zip(p.tolist(), y.tolist(), x.tolist()):
        assert not _pure.on_axis(yi, xi, H, W)
        r = np.hypot(yi, xi)
        assert 0.05 * H <= r <= 0.45 * H
        assert (pi, yi, xi) not in seen
        cy, cx = _pure.conj_idx(yi, xi, H, W)
        assert (pi, cy, cx) not in seen
        seen.add((pi, yi, xi))
        seen.add((pi, cy, cx))


def test_step_budget_raises():
    kw, kr, kg, kb = crypto.derive_turtle_keys(crypto.sha256(b"tiny"))
    with pytest.raises(RuntimeError):
        # 64x64 grid cannot host 50k bits: budget must trip, not hang
        _pure.turtle_expand(kw, (kr, kg, kb), 64, 64, 0.05, 0.45, 0.7, 0.0, 50_000,
                            max_steps=200_000)
    lib = _native_loader.get()
    if lib is not None:
        with pytest.raises(RuntimeError):
            lib.turtle_expand(kw, (kr, kg, kb), 64, 64, 0.05, 0.45, 0.7, 0.0,
                              50_000, 200_000)


def test_cache_reexpands_after_budget_limited_exhaustion(monkeypatch):
    """A cached exhaustion from a small step budget must not be treated as
    final: a later larger request computes a larger budget and must re-walk
    (near-capacity behavior cannot depend on call history)."""
    import steganosaurus_jax.keystream as ks

    kw, kr, kg, kb = crypto.derive_turtle_keys(crypto.sha256(b"re-expand"))
    args = (kw, (kr, kg, kb), 128, 128, 0.05, 0.45, 0.7, 0.0)
    ks._CACHE.clear()
    monkeypatch.setattr(ks, "_step_budget", lambda t, H, W: 2_000)
    p, y, x, j, n1 = ks.turtle_expand(*args, 900, allow_short=True)
    assert n1 < 900, "budget of 2000 steps was expected to exhaust early"
    monkeypatch.undo()
    # Larger request -> larger real budget -> must re-expand, not pad.
    p, y, x, j, n2 = ks.turtle_expand(*args, 1000, allow_short=True)
    assert n2 == 1000
    fresh = _pure.turtle_expand(*args, 1000, max_steps=10**9)
    for g, f in zip((p, y, x, j), fresh):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(f))
    ks._CACHE.clear()


def test_expansion_cache_prefix_property():
    """The cache serves shorter requests as prefix views and re-expands for
    longer ones; every answer must equal a fresh uncached expansion."""
    import steganosaurus_jax.keystream as ks

    kw, kr, kg, kb = crypto.derive_turtle_keys(crypto.sha256(b"cache-test"))
    args = (kw, (kr, kg, kb), 128, 128, 0.05, 0.45, 0.7, 0.0)
    ks._CACHE.clear()
    a100 = ks.turtle_expand(*args, 100)            # miss: expands 100
    a40 = ks.turtle_expand(*args, 40)              # hit: prefix view
    a400 = ks.turtle_expand(*args, 400)            # miss: re-expands >= 400
    a100_again = ks.turtle_expand(*args, 100)      # hit on the longer entry
    fresh = _pure.turtle_expand(*args, 400, max_steps=10**9)
    for got, n in ((a40, 40), (a100, 100), (a400, 400), (a100_again, 100)):
        for g, f in zip(got, fresh):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(f)[:n])
    # allow_short on a cached entry reports full production
    p, y, x, j, nprod = ks.turtle_expand(*args, 200, allow_short=True)
    assert nprod == 200
    # exhaustion via cache: tiny grid cannot host 50k bits
    kw2, kr2, kg2, kb2 = crypto.derive_turtle_keys(crypto.sha256(b"tiny2"))
    args2 = (kw2, (kr2, kg2, kb2), 32, 32, 0.05, 0.45, 0.7, 0.0)
    p, y, x, j, nprod = ks.turtle_expand(*args2, 50_000, allow_short=True)
    assert nprod < 50_000
    with pytest.raises(RuntimeError):
        ks.turtle_expand(*args2, 50_000)  # same entry, strict mode raises


def test_signed_unit_offsets_match_ks_jitter():
    """keystream.signed_unit_offsets must replay the KS two-byte jitter
    mapping exactly (same PRG blocks, big-endian int16 / 32768) so the
    alpha-spread draw is a documented, testable function of its key."""
    from steganosaurus_jax.keystream import KS, signed_unit_offsets

    key = bytes(range(32))
    n = 1000
    got = signed_unit_offsets(key, n)
    ks = KS(key)
    want = np.array([ks.jitter(1.0) for _ in range(n)], dtype=np.float32)
    np.testing.assert_array_equal(got, want)
    assert got.min() >= -1.0 and got.max() < 1.0


def test_visited_chaining_native_pure_equality():
    """turtle_expand_v (native) and the pure twin must agree on chained
    expansions: header prefix with visited capture, then a re-keyed payload
    walk resuming from that visited state (per-image-walk mode). The chained
    walk must never touch a header bin or its conjugate."""
    lib = _native_loader.get()
    if lib is None or not getattr(lib, "has_expand_v", False):
        pytest.skip("native turtle_expand_v unavailable")

    wk = bytes(range(32))
    pk = (b"\x01" * 32, b"\x02" * 32, b"\x03" * 32)
    H = W = 128
    hn = _native = lib.turtle_expand_v(wk, pk, H, W, 0.05, 0.45, 0.7, 0.0,
                                       912, 10**7, want_visited=True)
    hp = _pure.turtle_expand(wk, pk, H, W, 0.05, 0.45, 0.7, 0.0, 912, 10**7,
                             want_visited=True)
    for a, b in zip(hn[:4], hp[:4]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(hn[5], hp[5])

    wk2 = bytes(range(31, -1, -1))
    cn = lib.turtle_expand_v(wk2, pk, H, W, 0.05, 0.45, 0.7, 0.0, 1500,
                             10**7, init_visited=hn[5])
    cp = _pure.turtle_expand(wk2, pk, H, W, 0.05, 0.45, 0.7, 0.0, 1500,
                             10**7, init_visited=hp[5])
    for a, b in zip(cn[:4], cp[:4]):
        np.testing.assert_array_equal(a, b)

    hdr = set(zip(hn[0].tolist(), hn[1].tolist(), hn[2].tolist()))
    hdr |= {(p, (H - y) % H, (W - x) % W) for p, y, x in hdr}
    pay = set(zip(cn[0].tolist(), cn[1].tolist(), cn[2].tolist()))
    assert not (hdr & pay)
    # sanity: WITHOUT chaining the same payload walk collides with the header
    un = lib.turtle_expand_v(wk2, pk, H, W, 0.05, 0.45, 0.7, 0.0, 1500, 10**7)
    upay = set(zip(un[0].tolist(), un[1].tolist(), un[2].tolist()))
    assert hdr & upay


# --- persistent disk cache (keystream/diskcache.py) --------------------------


def _fresh_expand(tmp_path, monkeypatch, subdir, **kw):
    """turtle_expand with an isolated disk cache dir and a CLEARED in-memory
    cache (simulating a cold process)."""
    import steganosaurus_jax.keystream as ks_mod

    monkeypatch.setenv("STEGANOSAURUS_WALK_CACHE", str(tmp_path / subdir))
    ks_mod._CACHE.clear()
    defaults = dict(rmin=0.05, rmax=0.45, density=0.7, jitter_max=0.0,
                    nbits=4000)
    defaults.update(kw)
    return ks_mod.turtle_expand(
        b"k" * 32, (b"r" * 32, b"g" * 32, b"b" * 32), 256, 256, **defaults)


def test_disk_cache_hit_serves_identical_expansion(tmp_path, monkeypatch):
    import time

    first = _fresh_expand(tmp_path, monkeypatch, "c")
    t0 = time.perf_counter()
    second = _fresh_expand(tmp_path, monkeypatch, "c")  # cold memory, warm disk
    hit_time = time.perf_counter() - t0
    for a, b in zip(first, second):
        np.testing.assert_array_equal(a, b)
    # a hit must not re-run the sequential walk: generous 10x margin on I/O
    assert hit_time < 0.5
    from steganosaurus_jax.keystream import diskcache

    assert len(list(diskcache.cache_dir().glob("*.walk"))) == 1


def test_disk_cache_miss_on_different_key(tmp_path, monkeypatch):
    _fresh_expand(tmp_path, monkeypatch, "c")
    from steganosaurus_jax.keystream import diskcache

    _fresh_expand(tmp_path, monkeypatch, "c", density=0.6)  # different params
    assert len(list(diskcache.cache_dir().glob("*.walk"))) == 2


def test_disk_cache_corruption_self_heals(tmp_path, monkeypatch):
    first = _fresh_expand(tmp_path, monkeypatch, "c")
    from steganosaurus_jax.keystream import diskcache

    [f] = diskcache.cache_dir().glob("*.walk")
    raw = bytearray(f.read_bytes())
    raw[len(raw) // 2] ^= 0xFF  # flip a byte mid-array
    f.write_bytes(bytes(raw))
    second = _fresh_expand(tmp_path, monkeypatch, "c")  # must detect + redo
    for a, b in zip(first, second):
        np.testing.assert_array_equal(a, b)
    # the corrupt file was replaced by a fresh valid one
    [f2] = diskcache.cache_dir().glob("*.walk")
    assert f2.exists()


def test_disk_cache_truncation_and_bad_magic(tmp_path, monkeypatch):
    from steganosaurus_jax.keystream import diskcache

    monkeypatch.setenv("STEGANOSAURUS_WALK_CACHE", str(tmp_path / "d"))
    key = ("x", 1)
    diskcache.store("t", key, {"a": np.arange(10, dtype=np.int32)}, {"n": 1})
    path = diskcache._path_for("t", key)
    good = path.read_bytes()
    path.write_bytes(good[: len(good) // 2])     # truncated
    assert diskcache.load("t", key) is None
    assert not path.exists()                     # unlinked
    diskcache.store("t", key, {"a": np.arange(10, dtype=np.int32)}, {"n": 1})
    path.write_bytes(b"NOTMAGIC" + good[8:])     # bad magic
    assert diskcache.load("t", key) is None


def test_disk_cache_disabled_by_env(tmp_path, monkeypatch):
    from steganosaurus_jax.keystream import diskcache

    monkeypatch.setenv("STEGANOSAURUS_WALK_CACHE", "0")
    assert diskcache.cache_dir() is None
    diskcache.store("t", ("k",), {"a": np.zeros(4)}, {})  # no-op, no error
    assert diskcache.load("t", ("k",)) is None


def test_disk_cache_header_walk(tmp_path, monkeypatch):
    import steganosaurus_jax.keystream as ks_mod

    monkeypatch.setenv("STEGANOSAURUS_WALK_CACHE", str(tmp_path / "h"))
    args = (b"w" * 32, (b"1" * 32, b"2" * 32, b"3" * 32), 128, 128,
            0.05, 0.45, 0.7, 0.0, 912)
    ks_mod._HDR_CACHE.clear()
    first = ks_mod.header_walk_with_visited(*args)
    ks_mod._HDR_CACHE.clear()  # cold process, warm disk
    second = ks_mod.header_walk_with_visited(*args)
    for a, b in zip(first, second):
        np.testing.assert_array_equal(a, b)
    from steganosaurus_jax.keystream import diskcache

    assert len(list(diskcache.cache_dir().glob("*.walk"))) == 1
