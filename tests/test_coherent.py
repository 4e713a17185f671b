"""Channel-coherent write mode (Params.coherent; header FLAG_COHERENT).

The rebuild-only answer to the cross-channel warden (doc/ATTACKS.md §2e):
payload bits rotate ALL THREE planes at a site by one common phase delta,
encoding the bit in the common-mode phase (ops/phase.py _coherent_common)
while preserving every pairwise R/G/B phase difference EXACTLY — the
statistic the warden keys on. The reference has no such mode
(/root/reference/doc/TODO.md lists "cross-channel correlation tests" as
unbuilt Tier-3); header FLAGS bit 0x08 makes it self-describing and the
stock reference binary fails closed.
"""

import hashlib

import numpy as np
import pytest

import jax.numpy as jnp

from steganosaurus_jax import keystream
from steganosaurus_jax.config import Params
from steganosaurus_jax.keystream import _pure
from steganosaurus_jax.ops import phase as phase_ops
from steganosaurus_jax.pipeline import device as device_mod
from steganosaurus_jax.pipeline.batch import embed_batch, extract_batch
from steganosaurus_jax.pipeline.embed import embed_array
from steganosaurus_jax.pipeline.errors import StegoError
from steganosaurus_jax.pipeline.extract import extract_array


def _keys(tag: bytes):
    kw = hashlib.sha256(tag + b"w").digest()
    kr = hashlib.sha256(tag + b"r").digest()
    kg = hashlib.sha256(tag + b"g").digest()
    kb = hashlib.sha256(tag + b"b").digest()
    return kw, (kr, kg, kb)


# ---------------------------------------------------------------- walk layer


def test_coherent_walk_sites_consumed_whole():
    """A coherent walk never reuses a (y, x) site on ANY plane — a site
    (and its conjugate) is consumed whole regardless of which plane the
    walk was on when it accepted it."""
    kw, pk = _keys(b"coh-walk")
    H = W = 128
    p, y, x, _ = _pure.turtle_expand(
        kw, pk, H, W, 0.05, 0.45, 0.7, 0.0, 300, coherent=True)
    seen = set()
    for yi, xi in zip(y.tolist(), x.tolist()):
        cy, cx = _pure.conj_idx(yi, xi, H, W)
        assert (yi, xi) not in seen and (cy, cx) not in seen
        seen.add((yi, xi))
        seen.add((cy, cx))


def test_coherent_walk_native_matches_pure():
    from steganosaurus_jax import _native_loader

    lib = _native_loader.get()
    if lib is None or not getattr(lib, "has_expand_vc", False):
        pytest.skip("native coherent expansion unavailable")
    kw, pk = _keys(b"coh-nat")
    H = W = 96
    a = lib.turtle_expand_v(kw, pk, H, W, 0.05, 0.45, 0.7, 0.25, 200,
                            10**9, allow_short=False, init_visited=None,
                            want_visited=False, coherent=True)
    b = _pure.turtle_expand(kw, pk, H, W, 0.05, 0.45, 0.7, 0.25, 200,
                            coherent=True)
    for xa, xb in zip(a[:4], b[:4]):
        np.testing.assert_array_equal(np.asarray(xa), np.asarray(xb))


def test_coherent_walk_differs_from_standard():
    """Coherent site semantics consume ~3x the footprint, so the streams
    must diverge once a cross-plane collision happens (same dynamics,
    different accept set)."""
    kw, pk = _keys(b"coh-div")
    std = _pure.turtle_expand(kw, pk, 64, 64, 0.05, 0.45, 0.7, 0.0, 400)
    coh = _pure.turtle_expand(kw, pk, 64, 64, 0.05, 0.45, 0.7, 0.0, 400,
                              coherent=True)
    assert not (np.array_equal(std[1], coh[1])
                and np.array_equal(std[2], coh[2]))


# ----------------------------------------------------------------- ops layer


def _rand_sites(rng, H, W, n):
    """Distinct non-conjugate-colliding sites in the writable annulus."""
    seen, ys, xs = set(), [], []
    while len(ys) < n:
        yy = int(rng.integers(1, H)); xx = int(rng.integers(1, W))
        r = np.hypot(min(yy, H - yy), min(xx, W - xx)) / min(H, W)
        cy, cx = _pure.conj_idx(yy, xx, H, W)
        if (yy, xx) in seen or (cy, cx) in seen or not 0.08 < r < 0.42:
            continue
        seen.add((yy, xx)); seen.add((cy, cx))
        ys.append(yy); xs.append(xx)
    return np.asarray(ys, np.int32), np.asarray(xs, np.int32)


def test_coherent_write_preserves_pairwise_differences():
    rng = np.random.default_rng(3)
    H = W = 64
    spec = (rng.normal(size=(3, H, W)) + 1j * rng.normal(size=(3, H, W))
            ).astype(np.complex64) * 50
    y, x = _rand_sites(rng, H, W, 40)
    bits = rng.integers(0, 2, 40).astype(np.int32)
    jit = rng.uniform(-0.2, 0.2, 40).astype(np.float32)
    out = np.asarray(phase_ops.embed_phases_coherent(
        jnp.asarray(spec), jnp.asarray(y), jnp.asarray(x),
        jnp.asarray(bits), jnp.asarray(jit), 1.2))
    for a, b in ((0, 1), (0, 2), (1, 2)):
        before = np.angle(spec[a, y, x]) - np.angle(spec[b, y, x])
        after = np.angle(out[a, y, x]) - np.angle(out[b, y, x])
        d = np.angle(np.exp(1j * (after - before)))
        np.testing.assert_allclose(d, 0.0, atol=2e-3)
    # magnitudes untouched (pure rotation)
    np.testing.assert_allclose(np.abs(out[:, y, x]), np.abs(spec[:, y, x]),
                               rtol=2e-3)
    # and the common mode decodes the bits back
    got = np.asarray(phase_ops.read_phases_coherent(
        jnp.asarray(out), jnp.asarray(y), jnp.asarray(x),
        jnp.asarray(jit), 1.2))
    np.testing.assert_array_equal(got, bits)


def test_coherent_qim_write_reads_back():
    rng = np.random.default_rng(5)
    H = W = 64
    spec = (rng.normal(size=(3, H, W)) + 1j * rng.normal(size=(3, H, W))
            ).astype(np.complex64) * 50
    y, x = _rand_sites(rng, H, W, 40)
    bits = rng.integers(0, 2, 40).astype(np.int32)
    dith = rng.uniform(0, 2 * np.pi, 40).astype(np.float32)
    out = phase_ops.embed_phases_coherent_qim(
        jnp.asarray(spec), jnp.asarray(y), jnp.asarray(x),
        jnp.asarray(bits), jnp.asarray(dith), 8)
    got = np.asarray(phase_ops.read_phases_coherent_qim(
        out, jnp.asarray(y), jnp.asarray(x), jnp.asarray(dith), 8))
    np.testing.assert_array_equal(got, bits)
    # pairwise differences still exact under the QIM composition
    outn = np.asarray(out)
    for a, b in ((0, 1), (1, 2)):
        before = np.angle(spec[a, y, x]) - np.angle(spec[b, y, x])
        after = np.angle(outn[a, y, x]) - np.angle(outn[b, y, x])
        d = np.angle(np.exp(1j * (after - before)))
        np.testing.assert_allclose(d, 0.0, atol=2e-3)


def test_coherent_read_jax_matches_numpy_oracle():
    rng = np.random.default_rng(9)
    H = W = 64
    spec = (rng.normal(size=(3, H, W)) + 1j * rng.normal(size=(3, H, W))
            ).astype(np.complex128) * 20
    y, x = _rand_sites(rng, H, W, 30)
    jit = rng.uniform(-0.2, 0.2, 30)
    nb = device_mod.NumpyBackend()
    want = nb.read_values_coherent(spec, (y, x), jit, 1.2)
    got = np.asarray(phase_ops.read_values_coherent(
        jnp.asarray(spec.astype(np.complex64)), jnp.asarray(y),
        jnp.asarray(x), jnp.asarray(jit, jnp.float32), 1.2))
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=1e-4)
    dith = rng.uniform(0, 2 * np.pi, 30)
    want_q = nb.read_values_coherent_qim(spec, (y, x), dith, 8)
    got_q = np.asarray(phase_ops.read_values_coherent_qim(
        jnp.asarray(spec.astype(np.complex64)), jnp.asarray(y),
        jnp.asarray(x), jnp.asarray(dith, jnp.float32), 8))
    np.testing.assert_allclose(got_q, want_q, rtol=2e-3, atol=1e-4)


# ------------------------------------------------------------ pipeline layer


@pytest.mark.parametrize("extra", [
    dict(),
    dict(soft_write=True),
    dict(qim=8),
    dict(rs=True),
    dict(qim=8, rs=True, pad_quantum=32),
    dict(write_floor=0.45),
    dict(alpha_spread=0.5),
    dict(jitter=0.25),
    dict(per_image_walk=True),
])
def test_coherent_roundtrip_compositions(extra):
    rng = np.random.default_rng(sum(map(ord, repr(sorted(extra)))))
    # 256^2: the payload's 3x site charge needs the larger walk capacity
    cover = rng.integers(0, 256, (256, 256, 3), dtype=np.uint8)
    secret = b"coherent roundtrip"
    p = Params(pbkdf2_iter=100, coherent=True, **extra)
    res = embed_array(cover, secret, password="pw", params=p)
    # extraction is self-describing: default Params, no coherent flag needed
    out = extract_array(res.stego, password="pw",
                        params=Params(pbkdf2_iter=100))
    assert out == secret


def test_coherent_flag_on_wire():
    """The header itself rides the COHERENT walk + common-mode rule (a
    standard header's 912 single-plane writes alone hand the cross-channel
    warden AUC 1.0 — doc/ATTACKS.md §2e) and carries FLAGS bit 0x08; the
    standard shared-walk rule must NOT find the magic (no single-plane
    writes exist anywhere in a coherent stego)."""
    from steganosaurus_jax import crypto, spectral
    from steganosaurus_jax.ops import bits as bit_ops
    from steganosaurus_jax.ops import ecc
    from steganosaurus_jax.pipeline import header as header_mod

    rng = np.random.default_rng(21)
    cover = rng.integers(0, 256, (256, 256, 3), dtype=np.uint8)
    p = Params(pbkdf2_iter=100, coherent=True)
    res = embed_array(cover, b"flagcheck", password="pw", params=p)
    # decode the header exactly as extract_array's two-rule trial does
    ep = Params(pbkdf2_iter=100)
    backend = device_mod.get_backend(ep)
    planes = spectral.to_planes(res.stego)
    PH, PW = spectral.fft_dims(256, 256)
    spec, med, _cap, _feat = backend.analyze(planes, ep, lazy=True)
    path_key = crypto.derive_path_key("pw", None, None)
    kw, kr, kg, kb = crypto.derive_turtle_keys(path_key)
    n = header_mod.FIXED_LEN * 8 * 3
    # rule 1 (standard single-plane) finds nothing
    ip, iy, ix, jit = keystream.turtle_expand(
        kw, (kr, kg, kb), PH, PW, ep.rmin, ep.rmax, ep.density, ep.jitter, n)
    stream = backend.read_bits(spec, med, (ip, iy, ix), jit, ep.alpha, ep)
    miss = bit_ops.bytes_from_bits(np.asarray(ecc.rep3_decode(stream)))
    assert miss[:4] != header_mod.MAGIC
    # rule 2 (coherent walk, soft rep-3 on common-mode values) decodes
    _hp, hy, hx, hj, _vis = keystream.header_walk_with_visited(
        kw, (kr, kg, kb), PH, PW, ep.rmin, ep.rmax, ep.density, ep.jitter,
        n, coherent=True)
    hvals = backend.read_values_coherent(spec, (hy, hx), hj, ep.alpha)
    hdr_bytes = bit_ops.bytes_from_bits(
        np.asarray(ecc.rep_decode_soft(hvals, 3)))
    assert hdr_bytes[:4] == header_mod.MAGIC
    assert hdr_bytes[5] & header_mod.FLAG_COHERENT


def test_coherent_exclusions_raise():
    cover = np.zeros((128, 128, 3), np.uint8)
    for bad in (dict(adaptive_alpha=True), dict(cover_dependent_path=True)):
        p = Params(pbkdf2_iter=100, coherent=True, **bad)
        with pytest.raises(StegoError):
            embed_array(cover, b"x", password="pw", params=p)


def test_coherent_capacity_charged_3x():
    """Payload bits consume a whole site, so the fast-fail capacity check
    must charge 3x: a message that fits the standard walk comfortably can
    exceed the coherent pre-check."""
    rng = np.random.default_rng(2)
    cover = rng.integers(0, 256, (256, 256, 3), dtype=np.uint8)
    big = bytes(rng.integers(0, 256, 200, dtype=np.uint8).tolist())
    embed_array(cover, big, password="pw",
                params=Params(pbkdf2_iter=100))  # fits standard
    with pytest.raises(StegoError, match="too large"):
        embed_array(cover, big, password="pw",
                    params=Params(pbkdf2_iter=100, coherent=True))


# --------------------------------------------------------------- batch layer


def test_embed_batch_coherent_guard():
    covers = np.zeros((2, 128, 128, 3), np.uint8)
    with pytest.raises(StegoError, match="coherent"):
        embed_batch(covers, [b"a", b"b"], password="pw",
                    params=Params(pbkdf2_iter=100, coherent=True))


def test_extract_batch_autodetects_coherent_mixed():
    """A mixed batch (standard + PIW + coherent + coherent-QIM stegos) must
    resolve every image under ONE default-Params extract_batch call."""
    rng = np.random.default_rng(13)
    covers = rng.integers(0, 256, (4, 256, 256, 3), dtype=np.uint8)
    secrets = [b"std", b"coh one", b"piw two", b"coh qim three"]
    modes = [Params(pbkdf2_iter=100),
             Params(pbkdf2_iter=100, coherent=True),
             Params(pbkdf2_iter=100, per_image_walk=True),
             Params(pbkdf2_iter=100, coherent=True, qim=8)]
    stegos = np.stack([
        embed_array(covers[i], secrets[i], password="pw",
                    params=modes[i]).stego
        for i in range(4)])
    out = extract_batch(stegos, password="pw",
                        params=Params(pbkdf2_iter=100))
    # per-image assert: if one mode ever regresses (or flakes under
    # load), the failure names it instead of diffing two opaque lists
    names = ["standard", "coherent", "per_image_walk", "coherent+qim"]
    for i, (got, want) in enumerate(zip(out, secrets)):
        assert got == want, (
            f"image {i} ({names[i]}): got {got!r}, want {want!r}")
