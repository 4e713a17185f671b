"""spectral.fft2 / ifft2_real (jnp.fft; cuFFT on the GPU) against numpy
float64 in the reference sign convention (conj of numpy's forward —
steganosaur.cpp:347), at pow2, non-pow2 (native 1080p/4K-style factors)
and prime sizes, and through the full-grid embed/extract pipeline."""

import numpy as np
import pytest
import jax

from steganosaurus_jax import spectral


def _ref_spectrum(planes):
    return np.conj(np.fft.fft2(planes.astype(np.float64)))


@pytest.mark.parametrize("N", [64, 128, 512, 1024, 2048, 96, 541, 1080])
def test_forward_matches_f64(N):
    rng = np.random.default_rng(N)
    x = rng.uniform(0, 255, (2, N, N)).astype(np.float32)
    ref = _ref_spectrum(x)
    got = np.asarray(jax.jit(spectral.fft2)(x))
    # error budget: phase decisions have a 0.5 rad margin; spectra must
    # agree to 2e-3 of the mean magnitude
    scale = np.abs(ref).mean()
    assert np.abs(got - ref).max() / scale < 2e-3


@pytest.mark.parametrize("N", [64, 512, 1024, 541, 1080])
def test_roundtrip_identity(N):
    rng = np.random.default_rng(N + 1)
    x = rng.uniform(0, 255, (1, N, N)).astype(np.float32)
    back = np.asarray(jax.jit(
        lambda a: spectral.ifft2_real(spectral.fft2(a)))(x))
    assert np.abs(back - x).max() < 0.01  # far under the 0.5 u8 rounding step


def test_nonsquare():
    rng = np.random.default_rng(3)
    x = rng.uniform(0, 255, (3, 128, 512)).astype(np.float32)
    ref = _ref_spectrum(x)
    got = np.asarray(jax.jit(spectral.fft2)(x))
    assert np.abs(got - ref).max() / np.abs(ref).mean() < 2e-3


def test_sign_convention_matches_direct_dft():
    """The forward transform is the reference's e^{+i} DFT, evaluated here
    as a direct float64 sum."""
    rng = np.random.default_rng(4)
    x = rng.uniform(0, 255, (1, 256, 256)).astype(np.float32)
    k = np.arange(256)
    w = np.exp(+2j * np.pi * np.outer(k, k) / 256)
    want = np.einsum("yh,phw,xw->pyx", w, x.astype(np.complex128), w)
    got = np.asarray(spectral.fft2(x))
    assert np.abs(got - want).max() / np.abs(want).mean() < 2e-3


def test_pipeline_roundtrip_full_grid(small_image):
    """Full embed->extract round-trip through the single-image path, whose
    analyze and embed graphs run spectral.fft2 / ifft2_real on the full
    grid."""
    from steganosaurus_jax.config import Params
    from steganosaurus_jax.pipeline.embed import embed_array
    from steganosaurus_jax.pipeline.extract import extract_array

    p = Params(pbkdf2_iter=100)
    secret = b"full-grid fft roundtrip"
    res = embed_array(small_image, secret, password="pw", params=p)
    got = extract_array(res.stego, password="pw", params=p)
    assert got == secret
