"""Quality metrics (PSNR/SSIM/BER) and debug tracing."""

import numpy as np
import pytest

from steganosaurus_jax.ops import ecc
from steganosaurus_jax.utils import metrics


def test_psnr_identity_and_known_value():
    img = np.full((32, 32, 3), 128, np.uint8)
    assert metrics.psnr(img, img) == float("inf")
    noisy = img.astype(np.int32).copy()
    noisy[::2] += 2  # mse = 2 (half the pixels off by 2)
    want = 10 * np.log10(255**2 / 2.0)
    assert abs(metrics.psnr(img, noisy.astype(np.uint8)) - want) < 1e-9


def test_ssim_bounds():
    rng = np.random.default_rng(5)
    img = rng.integers(0, 256, (64, 64, 3)).astype(np.uint8)
    assert metrics.ssim(img, img) == pytest.approx(1.0)
    # tiny perturbation stays near 1; gross noise drops it
    tiny = np.clip(img.astype(np.int32) + rng.integers(-1, 2, img.shape), 0, 255)
    assert metrics.ssim(img, tiny.astype(np.uint8)) > 0.99
    other = rng.integers(0, 256, img.shape).astype(np.uint8)
    assert metrics.ssim(img, other) < 0.2


def test_quality_device_matches_host():
    """Device batch PSNR/SSIM == host f64 versions (bench uses the device
    path so 4K stego batches never cross to the host)."""
    import jax

    rng = np.random.default_rng(7)
    B, H, W = 3, 64, 96
    cover = rng.integers(0, 256, (B, H, W, 3)).astype(np.uint8)
    stego = np.clip(cover.astype(np.int32)
                    + rng.integers(-3, 4, cover.shape), 0, 255).astype(
                        np.uint8)
    p_host = metrics.psnr(cover, stego)
    s_host = float(np.mean([metrics.ssim(cover[i], stego[i])
                            for i in range(B)]))
    p_dev, s_dev = metrics.quality_device(jax.device_put(cover),
                                          jax.device_put(stego))
    assert abs(p_dev - p_host) < 1e-3
    assert abs(s_dev - s_host) < 1e-5
    # NCHW layout is auto-detected (bench serving layout)
    p2, s2 = metrics.quality_device(
        jax.device_put(cover.transpose(0, 3, 1, 2)),
        jax.device_put(stego.transpose(0, 3, 1, 2)))
    assert abs(p2 - p_host) < 1e-3
    assert abs(s2 - s_host) < 1e-5
    # batch chunking (HBM discipline at 4K/B=64) accumulates exactly,
    # including a ragged tail chunk
    p3, s3 = metrics.quality_device(jax.device_put(cover),
                                    jax.device_put(stego), chunk=2)
    assert abs(p3 - p_host) < 1e-3
    assert abs(s3 - s_host) < 1e-5


def test_ber_and_ecc_report():
    rng = np.random.default_rng(6)
    data = rng.integers(0, 2, 304).astype(np.uint8)
    payload = rng.integers(0, 2, 800).astype(np.uint8)
    frame = np.concatenate([np.asarray(ecc.rep3_encode(data)),
                            np.asarray(ecc.rep7_encode(payload))])
    # flip 5% of the channel bits
    rx = frame.copy()
    flips = rng.choice(len(rx), size=len(rx) // 20, replace=False)
    rx[flips] ^= 1
    rep = metrics.ecc_report(frame, rx, header_stream_bits=304 * 3)
    assert 0.02 < rep["header_ber_raw"] < 0.09
    assert 0.02 < rep["payload_ber_raw"] < 0.09
    # ECC must reduce the error rate by orders of magnitude at 5% raw
    assert rep["header_ber_post_ecc"] < rep["header_ber_raw"] / 3
    assert rep["payload_ber_post_ecc"] < rep["payload_ber_raw"] / 10


def test_debug_dump_gated_by_env(monkeypatch, capsys):
    from steganosaurus_jax.utils import debug

    monkeypatch.delenv("STEGANOSAURUS_DEBUG", raising=False)
    debug.log("hidden")
    monkeypatch.setenv("STEGANOSAURUS_DEBUG", "1")
    debug.dump_dims("t", 16, 32, 16, 32)
    debug.dump_walk("t", [1], [2], [3])
    err = capsys.readouterr().err
    assert "hidden" not in err
    assert "image 32x16" in err and "plane=1 y=2 x=3" in err
