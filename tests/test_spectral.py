"""Spectral engine tests: sign convention, rounding parity, padding, medians."""

import numpy as np
import pytest

from steganosaurus_jax import spectral


def test_fft_reference_sign_convention():
    """spectral.fft2 must equal the reference's e^{+i} forward transform."""
    rng = np.random.default_rng(0)
    x = rng.random((3, 16, 16)).astype(np.float32)
    got = np.asarray(spectral.fft2(x))
    # direct DFT with the reference's sign (steganosaur.cpp:347)
    n = 16
    k = np.arange(n)
    wy = np.exp(+2j * np.pi * np.outer(k, k) / n)
    want = np.einsum("yk,pkl,xl->pyx", wy, x.astype(np.complex128), wy)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)


def test_ifft_inverts_fft():
    rng = np.random.default_rng(1)
    x = rng.random((3, 32, 32)).astype(np.float32) * 255
    back = np.asarray(spectral.ifft2_real(spectral.fft2(x)))
    np.testing.assert_allclose(back, x, atol=1e-2)


def test_from_planes_rounding_half_away_from_zero():
    """Must match C++ round()+clamp (reference :387-391), not banker's."""
    vals = np.array([[[-3.7, -0.5, -0.2, 0.0, 0.49999, 0.5, 1.5, 2.5,
                       254.5, 255.49, 255.5, 300.0]]] * 3)
    out = spectral.from_planes(vals)
    expect = [0, 0, 0, 0, 0, 1, 2, 3, 255, 255, 255, 255]
    assert out[0, :, 0].tolist() == expect
    # C++: round(2.5)=3 (away from zero); banker's would give 2
    assert out[0, 7, 0] == 3


def test_planes_roundtrip():
    rng = np.random.default_rng(2)
    img = rng.integers(0, 256, (8, 12, 3)).astype(np.uint8)
    planes = spectral.to_planes(img)
    assert planes.shape == (3, 8, 12)
    back = spectral.from_planes(planes)
    np.testing.assert_array_equal(back, img)


def test_apply_center_sign_pattern():
    p = np.ones((3, 4, 4))
    c = np.asarray(spectral.apply_center(p, True))
    assert c[0, 0, 0] == 1 and c[0, 0, 1] == -1 and c[0, 1, 0] == -1 and c[0, 1, 1] == 1
    np.testing.assert_array_equal(np.asarray(spectral.apply_center(p, False)), p)


def test_pad_and_next_pow2():
    assert spectral.next_pow2(1) == 1
    assert spectral.next_pow2(255) == 256
    assert spectral.next_pow2(256) == 256
    assert spectral.next_pow2(257) == 512
    p = np.ones((3, 5, 6))
    padded = np.asarray(spectral.pad_planes(p, 8, 8))
    assert padded.shape == (3, 8, 8)
    assert padded[:, :5, :6].sum() == 3 * 5 * 6 and padded.sum() == 3 * 5 * 6


def test_median_abs_matches_nth_element():
    rng = np.random.default_rng(3)
    spec = (rng.normal(size=(3, 16, 16)) + 1j * rng.normal(size=(3, 16, 16))).astype(np.complex64)
    got = np.asarray(spectral.median_abs(spec))
    mags = np.abs(spec).reshape(3, -1)
    want = np.sort(mags, axis=-1)[:, mags.shape[-1] // 2]  # upper median
    np.testing.assert_array_equal(got, want)


def test_cover_hash_features_quantization():
    spec = np.zeros((3, 64, 64), np.complex64)
    spec[:, 0, 0] = np.exp(6.0) - 1.0  # log1p == 6.0 -> q = 3
    spec[:, 1, 1] = 1e12               # clamps to 7
    feat = np.asarray(spectral.cover_hash_features(spec))
    assert feat.shape == (3, 8, 8)
    assert feat[0, 0, 0] == 3 and feat[0, 1, 1] == 7 and feat[0, 2, 2] == 0


def test_factored_corner_matches_dense(monkeypatch):
    """The four-step factored corner transforms (axis_plan != 0) must match
    the dense pruned-DFT matmuls to f32 roundoff in both directions — the
    factorization is exact math (validated to 1e-15 in f64), so any drift
    here is a table/indexing bug."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from steganosaurus_jax.spectral import corner

    H, W, Ky, Kx = 512, 768, 256, 256
    # the factored path is opt-in; force it on for this equivalence check
    monkeypatch.setenv("STEGANOSAURUS_CORNER_FACTORED", "1")
    corner.axis_plan.cache_clear()
    assert corner.axis_plan(W, Kx) == 128
    assert corner.axis_plan(H, Ky) == 128
    rng = np.random.default_rng(5)
    planes = rng.uniform(0, 255, (2, 3, H, W)).astype(np.float32)
    hp = jax.lax.Precision.HIGHEST
    prec = (hp, hp, hp, hp)

    dense_y = corner._dft_tables(H, Ky)
    dense_x = corner._dft_tables(W, Kx)
    fact = corner.dft_tables_device(H, Ky, W, Kx)
    assert len(fact) == 8  # both axes factored

    # dense reference result computed directly from the dense tables
    eyr, eyi = (jnp.asarray(a) for a in dense_y)
    exr, exi = (jnp.asarray(a) for a in dense_x)
    ar = corner._mm("...hw,xw->...hx", jnp.asarray(planes), exr, hp)
    ai = corner._mm("...hw,xw->...hx", jnp.asarray(planes), exi, hp)
    want_r = (corner._mm("yh,...hx->...yx", eyr, ar, hp)
              - corner._mm("yh,...hx->...yx", eyi, ai, hp))
    want_i = (corner._mm("yh,...hx->...yx", eyr, ai, hp)
              + corner._mm("yh,...hx->...yx", eyi, ar, hp))
    got_r, got_i = corner.fwd_corner(jnp.asarray(planes), Ky, Kx, fact, prec)
    scale = float(jnp.max(jnp.abs(want_r)))
    np.testing.assert_allclose(np.asarray(got_r) / scale,
                               np.asarray(want_r) / scale, atol=3e-6)
    np.testing.assert_allclose(np.asarray(got_i) / scale,
                               np.asarray(want_i) / scale, atol=3e-6)
    # inverse direction: dense vs factored real IFFT of a corner delta
    dr = rng.normal(size=(2, 3, Ky, Kx)).astype(np.float32) * 100
    di = rng.normal(size=(2, 3, Ky, Kx)).astype(np.float32) * 100
    mr = (corner._mm("yh,...yx->...hx", eyr, jnp.asarray(dr), hp)
          - corner._mm("yh,...yx->...hx", eyi, jnp.asarray(-di), hp))
    mi = (corner._mm("yh,...yx->...hx", eyr, jnp.asarray(-di), hp)
          + corner._mm("yh,...yx->...hx", eyi, jnp.asarray(dr), hp))
    want_t = (corner._mm("...hx,xw->...hw", mr, exr, hp)
              - corner._mm("...hx,xw->...hw", mi, exi, hp)) / (H * W)
    got_t = corner.ifft_corner_real(jnp.asarray(dr), jnp.asarray(di),
                                    H, W, fact, prec)
    tscale = float(jnp.max(jnp.abs(want_t)))
    np.testing.assert_allclose(np.asarray(got_t) / tscale,
                               np.asarray(want_t) / tscale, atol=3e-6)
    monkeypatch.delenv("STEGANOSAURUS_CORNER_FACTORED")
    corner.axis_plan.cache_clear()


def test_split_fwd_y_band_semantics(monkeypatch):
    """mix_split's forward stage-2: columns x < X0 must EXACTLY equal the
    all-ACCURATE stage (the hazard band keeps its full accuracy), columns
    x >= X0 must EXACTLY equal the true-bf16 stage (operand-rounded, f32
    accumulated) — the split is a per-column selection between the two
    existing modes, never a third numeric."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from steganosaurus_jax.spectral import corner

    H, W, Ky, Kx = 384, 512, 256, 256
    monkeypatch.setenv("STEGANOSAURUS_MM_PRECISION", "mix_split")
    monkeypatch.setenv("STEGANOSAURUS_SPLIT_X0", "64")
    prec = corner.precision()
    assert prec[1] == "split"
    X0 = corner.split_x0()
    rng = np.random.default_rng(11)
    planes = rng.uniform(0, 255, (2, 3, H, W)).astype(np.float32)
    tabs = corner.dft_tables_device(H, Ky, W, Kx)
    got_r, got_i = corner.fwd_corner(jnp.asarray(planes), Ky, Kx, tabs, prec)

    for band_p, sl in ((corner.ACCURATE, slice(0, X0)),
                       ("bf16", slice(X0, None))):
        ref_p = (prec[0], band_p, prec[2], prec[3])
        want_r, want_i = corner.fwd_corner(jnp.asarray(planes), Ky, Kx,
                                           tabs, ref_p)
        np.testing.assert_array_equal(np.asarray(got_r[..., sl]),
                                      np.asarray(want_r[..., sl]))
        np.testing.assert_array_equal(np.asarray(got_i[..., sl]),
                                      np.asarray(want_i[..., sl]))


def test_adaptive_fwd_y_band_semantics(monkeypatch):
    """mix_adaptive's forward stage-2: per (image, plane), the X0 columns
    with the LARGEST stage-1 energy must EXACTLY equal the all-ACCURATE stage
    and every other column EXACTLY the true-bf16 stage — an exact per-column
    selection between the two existing numerics, with the band placed by
    measured energy instead of the static low-x prior (so covers whose
    texture peaks at a high in-corner frequency protect themselves)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from steganosaurus_jax.spectral import corner

    H, W, Ky, Kx = 384, 512, 256, 256
    monkeypatch.setenv("STEGANOSAURUS_MM_PRECISION", "mix_adaptive")
    monkeypatch.setenv("STEGANOSAURUS_SPLIT_X0", "64")
    prec = corner.precision()
    assert prec[1] == "adaptive"
    X0 = corner.split_x0()
    rng = np.random.default_rng(12)
    planes = rng.uniform(0, 255, (2, 3, H, W)).astype(np.float32)
    # plant a strong horizontal texture at an x-frequency OUTSIDE the
    # static band on image 0 so the adaptive band must move to cover it
    xs = np.arange(W, dtype=np.float32)
    planes[0] += 90.0 * np.sin(2 * np.pi * 200 * xs / W)[None, None, :]
    tabs = corner.dft_tables_device(H, Ky, W, Kx)
    got_r, got_i = corner.fwd_corner(jnp.asarray(planes), Ky, Kx, tabs, prec)

    HIGH = corner.ACCURATE
    results = {}
    for band_p in (HIGH, "bf16"):
        ref_p = (prec[0], band_p, prec[2], prec[3])
        results[band_p] = corner.fwd_corner(jnp.asarray(planes), Ky, Kx,
                                            tabs, ref_p)
    # replicate the band selection with the SAME ops the adaptive path
    # uses: stage-1 at prec[0] (bf16-emulated on CPU), energy in f32,
    # jax.lax.top_k tie-breaking
    exr, exi = tabs[2], tabs[3]
    ar = corner._mm("bphw,xw->bphx", jnp.asarray(planes), exr, prec[0])
    ai = corner._mm("bphw,xw->bphx", jnp.asarray(planes), exi, prec[0])
    energy = jnp.sum(ar * ar + ai * ai, axis=-2)
    _, idx_all = jax.lax.top_k(energy, X0)
    idx_all = np.asarray(idx_all)
    n_checked_moved = 0
    for b in range(planes.shape[0]):
        for p in range(3):
            idx = idx_all[b, p]
            sel = np.zeros(Kx, dtype=bool)
            sel[idx] = True
            if idx.max() >= X0:
                n_checked_moved += 1
            for band_p, mask in ((HIGH, sel), ("bf16", ~sel)):
                want_r, want_i = results[band_p]
                np.testing.assert_array_equal(
                    np.asarray(got_r[b, p][..., mask]),
                    np.asarray(want_r[b, p][..., mask]))
                np.testing.assert_array_equal(
                    np.asarray(got_i[b, p][..., mask]),
                    np.asarray(want_i[b, p][..., mask]))
    assert n_checked_moved >= 3  # the planted texture moved the band


@pytest.mark.parametrize("mode,want", [
    ("mix_adaptive", ("bf16", "adaptive", "bf16", "bf16")),
    ("mix_split", ("bf16", "split", "bf16", "bf16")),
    ("mix", ("bf16", "ACCURATE", "bf16", "bf16")),
    ("mix3", ("bf16", "ACCURATE", "bf16", "bf16")),
    ("mix_conservative", ("bf16", "ACCURATE", "ACCURATE", "ACCURATE")),
    ("mix2", ("bf16", "ACCURATE", "bf16", "ACCURATE")),
    ("high", ("ACCURATE",) * 4),
    ("bf16", ("bf16",) * 4),
    ("highest", ("HIGHEST",) * 4),
])
def test_precision_modes_map_to_explicit_precisions(monkeypatch, mode, want):
    """Every mode resolves to bf16, the explicit f32-faithful dot algorithm
    corner.ACCURATE (bf16_3x — never Precision.HIGH, which is one TF32 pass
    on the GPU) or HIGHEST; the default is mix_adaptive."""
    import jax

    from steganosaurus_jax.spectral import corner

    assert corner.ACCURATE == jax.lax.DotAlgorithmPreset.BF16_BF16_F32_X3
    names = {"ACCURATE": corner.ACCURATE,
             "HIGHEST": jax.lax.Precision.HIGHEST}
    monkeypatch.setenv("STEGANOSAURUS_MM_PRECISION", mode)
    got = corner.precision()
    assert got == tuple(names.get(w, w) for w in want)
    assert jax.lax.Precision.HIGH not in got
    monkeypatch.delenv("STEGANOSAURUS_MM_PRECISION")
    assert corner.precision() == ("bf16", "adaptive", "bf16", "bf16")
