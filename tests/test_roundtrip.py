"""End-to-end embed/extract round-trip property tests (BASELINE.json configs)."""

import numpy as np
import pytest

from steganosaurus_jax.config import Params
from steganosaurus_jax.pipeline.embed import embed_array
from steganosaurus_jax.pipeline.extract import extract_array
from steganosaurus_jax.pipeline.errors import StegoError

FAST = dict(pbkdf2_iter=500)


def _roundtrip(img, secret, params, **kw):
    res = embed_array(img, secret, params=params, **kw)
    out = extract_array(res.stego, params=params, **kw)
    assert out == secret
    return res


@pytest.mark.parametrize("dtype", ["complex64", "complex128"])
def test_defaults(small_image, dtype):
    p = Params(fft_dtype=dtype, **FAST)
    res = _roundtrip(small_image, b"Hello World!", p, password="pw")
    assert res.payload_bytes == 12


def test_long_message(host_image):
    p = Params(**FAST)
    # 200 bytes of binary payload: fits the 256x256 fixture's ~15286-bit
    # capacity (verified identical to the reference binary's count).
    secret = bytes(range(200))
    _roundtrip(host_image, secret, p, password="long pass phrase!")


def test_long_message_over_capacity_matches_reference(host_image):
    """512B on a 256x256 cover: reference says 'Message too large. Need 28128
    bits (after ECC), capacity ~15286 bits.' — we must agree on the boundary."""
    p = Params(**FAST)
    with pytest.raises(StegoError, match="Message too large"):
        embed_array(host_image, bytes(range(32, 126)) * 5, password="pw", params=p)


def test_raw_key_mode(small_image):
    p = Params(**FAST)
    mk = bytes(range(32))
    _roundtrip(small_image, b"keyed secret", p, master_key=mk)


def test_jitter(small_image):
    p = Params(jitter=0.05, **FAST)
    _roundtrip(small_image, b"jittery", p, password="pw")


def test_adaptive_alpha(small_image):
    """BASELINE config 4. Device-side adaptive alpha round-trips (the
    magnitude-median recomputation on the stego spectrum is close enough that
    Rep-7 absorbs the residual flips — same mechanism as the reference)."""
    p = Params(adaptive_alpha=True, **FAST)
    _roundtrip(small_image, b"adaptive", p, password="pw")


def test_cover_dependent_path(small_image):
    """BASELINE config 5: spectral-hash-keyed walk.

    The mode is known-broken in the reference (doc/HARDENING.md:325-381): the
    cover hash is recomputed from the *stego* spectrum on extract, diverges
    from the embed-time hash, and extraction fails 'Magic not found' — even on
    near-flat covers (verified against the reference binary). Parity means
    embed succeeds and extraction fails identically; SURVEY.md §7 calls
    matching this failure acceptable parity.
    """
    p = Params(cover_dependent_path=True, **FAST)
    res = embed_array(small_image, b"cover-keyed", password="pw", params=p)
    assert res.payload_bytes == 11
    with pytest.raises(StegoError, match="Magic not found"):
        extract_array(res.stego, password="pw", params=p)


@pytest.mark.parametrize("density", [0.3, 0.7, 0.95])
def test_density_sweep(small_image, density):
    p = Params(density=density, **FAST)
    _roundtrip(small_image, b"dense", p, password="pw")


@pytest.mark.parametrize("rmin,rmax", [(0.05, 0.45), (0.02, 0.48)])
def test_annulus_sweep(small_image, rmin, rmax):
    p = Params(rmin=rmin, rmax=rmax, **FAST)
    _roundtrip(small_image, b"annulus", p, password="pw")


def test_annulus_narrow(host_image):
    # A (0.10, 0.30) annulus on a 128x128 cover holds only ~1509 bits — under
    # the 2200-bit minimum frame — so the narrow band needs the 256x256 cover.
    p = Params(rmin=0.10, rmax=0.30, **FAST)
    _roundtrip(host_image, b"annulus", p, password="pw")


def test_alpha_sweep(small_image):
    for alpha in (0.22, 0.5, 1.0):
        p = Params(alpha=alpha, **FAST)
        _roundtrip(small_image, b"alpha", p, password="pw")


def test_center_mode(small_image):
    p = Params(center=True, **FAST)
    _roundtrip(small_image, b"centered", p, password="pw")


def test_rectangular_image():
    """Non-pow2 covers round-trip HERE but not in the reference: it pads to
    pow2 and crops the IFFT, which attenuates + cross-couples the written
    phases, so its own embed->extract fails with 'Magic not found' on every
    non-pow2 image (verified directly at 96x200, 1080p, and 4K). We run the
    transform at native size instead (spectral.fft_dims), which makes the
    round-trip exact — a deliberate, documented improvement. pow2 covers
    keep bit-exact cross-interop (test_reference_parity)."""
    rng = np.random.default_rng(11)
    img = np.clip(190 + rng.integers(-20, 21, (96, 200, 3)), 0, 255).astype(np.uint8)
    p = Params(**FAST)
    res = embed_array(img, b"rect", password="pw", params=p)
    assert res.stego.shape == img.shape
    assert extract_array(res.stego, password="pw", params=p) == b"rect"


def test_wrong_password_fails_fast(small_image):
    p = Params(**FAST)
    res = embed_array(small_image, b"secret", password="right", params=p)
    with pytest.raises(StegoError, match="Magic not found"):
        extract_array(res.stego, password="wrong", params=p)


def test_capacity_exceeded(small_image):
    p = Params(**FAST)
    with pytest.raises(StegoError, match="Message too large"):
        embed_array(small_image, b"x" * 5000, password="pw", params=p)


def test_psnr_imperceptibility(host_image):
    """Stego quality parity. README.md:137 claims 'typically >50 dB' but that
    is cover-dependent: the reference binary itself measures 45.28 dB on this
    exact fixture (noisy gradient, 2480 modified bins on 256x256). We match it
    within 0.1 dB (ours: 45.31); assert we are at least as good as the
    reference minus measurement slack."""
    p = Params(**FAST)
    res = embed_array(host_image, b"Hello World!", password="pw", params=p)
    mse = np.mean((host_image.astype(np.float64) - res.stego.astype(np.float64)) ** 2)
    psnr = 10 * np.log10(255.0**2 / mse)
    assert psnr > 45.0, psnr


def test_deterministic_with_fixed_salt(small_image):
    p = Params(**FAST)
    salt = bytes(16)
    a = embed_array(small_image, b"det", password="pw", params=p, salt=salt)
    b = embed_array(small_image, b"det", password="pw", params=p, salt=salt)
    np.testing.assert_array_equal(a.stego, b.stego)


def test_single_image_graphs_bucketed(small_image):
    """Two different secret lengths at one image size must share one compiled
    graph (4096-bit index bucketing in pipeline.device): the CLI path must
    not pay a fresh XLA compile per payload length."""
    from steganosaurus_jax.pipeline import device

    p = Params(**FAST)
    H, W = small_image.shape[:2]
    embed_fn = device._jit_embed_apply(H, W, p.center, p.adaptive_alpha)
    read_fn = device._jit_read_bits(p.adaptive_alpha)
    e0, r0 = embed_fn._cache_size(), read_fn._cache_size()
    _roundtrip(small_image, b"short", p, password="bucketpw")
    _roundtrip(small_image, b"a rather longer secret payload!", p,
               password="bucketpw")
    # <= 1, not == 1: earlier tests in a full run may already have compiled
    # the shared 4096 bucket (that sharing is the point). Without bucketing
    # the two fresh lengths would each compile, giving a delta of 2.
    assert embed_fn._cache_size() - e0 <= 1
    # header pass + payload pass share the bucketed read graph too
    assert read_fn._cache_size() - r0 <= 1


def _psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return 10 * np.log10(255.0**2 / mse)


def test_soft_write_roundtrip_and_psnr(host_image):
    """Rebuild-only soft_write (minimal-energy phase write, ops/phase.py):
    bins already decoding with margin >= alpha are left untouched, the rest
    clamp to the margin boundary — decode is unchanged (half-plane rule).
    Must round-trip AND measurably beat the hard write's PSNR at the same
    payload (~2.8x energy reduction expected on uniform cover phases)."""
    secret = bytes(range(150))
    salt = bytes(range(16))
    hard = embed_array(host_image, secret, password="pw",
                       params=Params(**FAST), salt=salt)
    psoft = Params(soft_write=True, **FAST)
    soft = embed_array(host_image, secret, password="pw", params=psoft,
                       salt=salt)
    assert extract_array(soft.stego, password="pw", params=psoft) == secret
    gain = _psnr(host_image, soft.stego) - _psnr(host_image, hard.stego)
    assert gain > 2.0, gain


def test_soft_write_jitter_and_adaptive(small_image):
    """soft_write composes with the jitter rotation and with per-bin
    adaptive alpha (margin follows the bin's own a)."""
    _roundtrip(small_image, b"soft jit",
               Params(soft_write=True, jitter=0.05, **FAST), password="pw")
    _roundtrip(small_image, b"soft adaptive",
               Params(soft_write=True, adaptive_alpha=True, **FAST),
               password="pw")


def test_soft_write_f64_oracle(small_image):
    """The numpy f64 backend implements the same minimal-energy write; both
    backends round-trip the same payload with soft_write on."""
    p = Params(soft_write=True, fft_dtype="complex128", **FAST)
    _roundtrip(small_image, b"soft f64", p, password="pw")


def test_alpha_spread_roundtrip_and_amplitudes(host_image):
    """Keyed randomized write amplitude (params.alpha_spread,
    pipeline/spread.py): embeds at alpha_i in [alpha, alpha(1+s)) per bin
    (one-sided — margin never below the hard write's). Must round-trip —
    including when the EXTRACT params carry a different spread value,
    because the decode half-plane rule never uses the written amplitude —
    and the measured per-bin write phases must match the keyed alpha_i draw
    (not concentrate at +-alpha)."""
    from steganosaurus_jax import crypto, keystream, spectral
    from steganosaurus_jax.pipeline import spread as spread_mod

    secret = bytes(range(120))
    salt = bytes(range(16))
    p = Params(alpha_spread=0.5, **FAST)
    res = embed_array(host_image, secret, password="pw", params=p, salt=salt)
    # extraction is spread-independent (reads never use the amplitude)
    assert extract_array(res.stego, password="pw", params=p) == secret
    assert extract_array(res.stego, password="pw",
                         params=Params(**FAST)) == secret

    # measured write phases at the walk bins == the keyed alpha_i draw
    path_key = crypto.derive_path_key("pw", None, None)
    kw, kr, kg, kb = crypto.derive_turtle_keys(path_key)
    H, W = host_image.shape[:2]
    PH, PW = spectral.fft_dims(H, W)
    nbits = res.written_bits
    plane, y, x, _ = keystream.turtle_expand(
        kw, (kr, kg, kb), PH, PW, p.rmin, p.rmax, p.density, p.jitter, nbits)
    alphas = spread_mod.spread_alphas(path_key, p, nbits)
    assert alphas is not None and alphas.min() >= 0.5 - 1e-6  # one-sided
    assert alphas.max() < 0.5 * 1.5
    planes = host_image.astype(np.float64).transpose(2, 0, 1)
    stego_p = res.stego.astype(np.float64).transpose(2, 0, 1)
    # reference forward convention = conj of numpy's: |angle| is unaffected
    spec = np.conj(np.fft.fft2(stego_p))
    v = spec[plane, y, x]
    th = np.abs(np.angle(v))
    # u8 quantization perturbs phases of weak bins; judge the keyed-amplitude
    # match on the strong half, where the angular noise is small
    strong = np.abs(v) > np.median(np.abs(v))
    close = np.abs(th - alphas) < 0.08
    assert np.mean(close[strong]) > 0.9, np.mean(close[strong])
    # and the amplitudes genuinely spread (kills the +-alpha histogram spike)
    assert alphas.max() - alphas.min() > 0.2
    del planes


def test_alpha_spread_validation():
    from steganosaurus_jax.pipeline import spread as spread_mod
    from steganosaurus_jax.pipeline.errors import StegoError

    with pytest.raises(StegoError, match="alpha_spread"):
        spread_mod.validate(Params(alpha_spread=-0.1))
    with pytest.raises(StegoError, match="sin-sign"):
        spread_mod.validate(Params(alpha=2.5, alpha_spread=0.5))
    spread_mod.validate(Params(alpha_spread=1.2))  # one-sided: 1.1 < pi, ok
    spread_mod.validate(Params(alpha_spread=0.9))  # in-band: ok


def test_alpha_spread_composes(small_image):
    """spread composes with soft_write (margin follows alpha_i) and with
    jitter (amplitude rides on top of the keyed offset)."""
    _roundtrip(small_image, b"spread soft",
               Params(alpha_spread=0.4, soft_write=True, **FAST),
               password="pw")
    _roundtrip(small_image, b"spread jit",
               Params(alpha_spread=0.4, jitter=0.05, **FAST), password="pw")
    _roundtrip(small_image, b"spread adaptive",
               Params(alpha_spread=0.4, adaptive_alpha=True, **FAST),
               password="pw")


def test_per_image_walk_roundtrip_and_decorrelated_bins(host_image):
    """Salt-keyed per-image payload walks (params.per_image_walk,
    doc/ATTACKS.md §4): round-trips with EXTRACTION AUTO-DETECTING the mode
    from the header flag (no param needed), and two embeds under the same
    key with different salts select INDEPENDENT payload bin sets — overlap
    drops from 100% (shared walk: identical bins every image, the
    correlation attack's precondition) to the random-coincidence rate."""
    from steganosaurus_jax import crypto, keystream, spectral
    from steganosaurus_jax.pipeline import header as header_mod

    p = Params(per_image_walk=True, **FAST)
    secret = bytes(range(100))
    s1, s2 = bytes(range(16)), bytes(range(16, 32))
    r1 = embed_array(host_image, secret, password="pw", params=p, salt=s1)
    r2 = embed_array(host_image, secret, password="pw", params=p, salt=s2)
    # plain default params on extraction: flag-driven
    assert extract_array(r1.stego, password="pw",
                         params=Params(**FAST)) == secret
    assert extract_array(r2.stego, password="pw",
                         params=Params(**FAST)) == secret

    # exact bin-level disjointness of the two payload walks
    path_key = crypto.derive_path_key("pw", None, None)
    kw, kr, kg, kb = crypto.derive_turtle_keys(path_key)
    H, W = host_image.shape[:2]
    PH, PW = spectral.fft_dims(H, W)
    hdr_n = header_mod.FIXED_LEN * 8 * 3
    *_, vis = keystream.header_walk_with_visited(
        kw, (kr, kg, kb), PH, PW, p.rmin, p.rmax, p.density, p.jitter, hdr_n)
    npay = r1.written_bits - hdr_n
    bins = []
    for s in (s1, s2):
        sk = crypto.derive_turtle_keys(crypto.derive_salt_path_key(path_key, s))
        pp, py, px, _ = keystream.turtle_expand_chained(
            sk[0], sk[1:], PH, PW, p.rmin, p.rmax, p.density, p.jitter,
            npay, vis)
        full = set(zip(pp.tolist(), py.tolist(), px.tolist()))
        full |= {(pl, (PH - y) % PH, (PW - x) % PW) for pl, y, x in full}
        bins.append(full)
    # independent draws over the annulus: overlap ~= coincidence rate
    # (|bins| / annulus size, ~10% here), nothing like the shared walk's
    # 100%. The averaging attack needs bins common to MANY images; pairwise
    # random overlap decays geometrically with collection size.
    overlap = len(bins[0] & bins[1]) / len(bins[0])
    assert overlap < 0.3, overlap
    # contrast: header bins (shared prefix) ARE identical across salts —
    # that part is the locate-before-salt constraint, common to all modes
    hdr_bins = set(zip(*(a.tolist() for a in
                         keystream.header_walk_with_visited(
                             kw, (kr, kg, kb), PH, PW, p.rmin, p.rmax,
                             p.density, p.jitter, hdr_n)[:3])))
    assert hdr_bins  # non-empty, deterministic


def test_per_image_walk_excludes_cover_dependent_path(small_image):
    from steganosaurus_jax.pipeline.errors import StegoError

    p = Params(per_image_walk=True, cover_dependent_path=True, **FAST)
    with pytest.raises(StegoError, match="mutually exclusive"):
        embed_array(small_image, b"x", password="pw", params=p)


def test_per_image_walk_composes(small_image):
    """per_image_walk composes with jitter (salt-keyed plane PRGs draw the
    payload jitters on both sides) and with alpha_spread / soft_write."""
    p = Params(per_image_walk=True, jitter=0.05, **FAST)
    res = embed_array(small_image, b"piw jit", password="pw", params=p)
    assert extract_array(res.stego, password="pw", params=p) == b"piw jit"
    p2 = Params(per_image_walk=True, alpha_spread=0.4, soft_write=True,
                **FAST)
    res2 = embed_array(small_image, b"piw sp", password="pw", params=p2)
    assert extract_array(res2.stego, password="pw",
                         params=Params(**FAST)) == b"piw sp"


def test_stealth_modes_f64_oracle(small_image):
    """The numpy f64 parity-arbiter backend supports both stealth modes
    (per-bit amplitude array; per-image payload walk)."""
    p = Params(per_image_walk=True, alpha_spread=0.5,
               fft_dtype="complex128", **FAST)
    res = embed_array(small_image, b"stealth f64", password="pw", params=p)
    assert extract_array(res.stego, password="pw",
                         params=Params(fft_dtype="complex128",
                                       **FAST)) == b"stealth f64"


def test_stealth_profile(host_image):
    """Params.stealth(): the recommended full stealth stack (jitter +
    one-sided spread + soft write + per-image walks) round-trips; the
    extractor needs only the jitter value (everything else auto-detected
    or embed-side-only); and the warden-view spike statistic measurably
    collapses vs the default write."""
    from steganosaurus_jax.utils.steganalysis import phase_histogram_report

    p = Params.stealth(**FAST)
    secret = bytes(range(160))
    salt = bytes(range(16))
    res = embed_array(host_image, secret, password="pw", params=p, salt=salt)
    assert extract_array(res.stego, password="pw",
                         params=Params(jitter=p.jitter, **FAST)) == secret
    hard = embed_array(host_image, secret, password="pw",
                       params=Params(**FAST), salt=salt)
    r_stealth = phase_histogram_report(res.stego)
    r_hard = phase_histogram_report(hard.stego)
    assert r_stealth["spike_excess"] < r_hard["spike_excess"] / 4
    assert r_stealth["chi2_z"] < r_hard["chi2_z"] / 3
    # reference-interop variant keeps everything but the flagged walk
    p2 = Params.stealth(per_image_walk=False, **FAST)
    assert not p2.per_image_walk and p2.soft_write
