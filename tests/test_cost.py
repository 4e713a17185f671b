"""utils/cost.py: the MFU/roofline cost model must count the EXACT modules
the serving pipeline dispatches (bench `mfu_pct` / `link_utilization` are
only honest if the counted module is the dispatched module); the device
peak table; the compilation-cache location (runtime.py)."""

import pathlib

import numpy as np
import pytest

from steganosaurus_jax.config import Params
from steganosaurus_jax.utils import cost


def _covers(B, H, W, rng):
    base = np.linspace(170, 225, W)
    return np.clip(
        base[None, None, None, :] + rng.integers(-12, 13, (B, 3, H, W)),
        0, 255).astype(np.uint8)


def test_cost_counts_the_dispatched_modules():
    import jax

    from steganosaurus_jax.parallel import batch as pbatch
    from steganosaurus_jax.pipeline.batch import embed_batch, extract_batch

    B, H, W, n = 4, 128, 128, 40
    rng = np.random.default_rng(0)
    covers_d = jax.device_put(_covers(B, H, W, rng))
    secrets = [bytes(rng.integers(0, 256, n, dtype=np.uint8))
               for _ in range(B)]
    mk = bytes(range(32))
    res = embed_batch(covers_d, secrets, master_key=mk,
                      device_resident=True, layout="nchw")
    got = extract_batch(res.stego, master_key=mk, clen_hint=n,
                        layout="nchw")
    assert got == secrets

    e0 = pbatch.corner_embed_core.cache_info()
    x0 = pbatch.corner_extract_fused_core.cache_info()
    rep = cost.roundtrip_cost(B, H, W, n, layout="nchw")
    e1 = pbatch.corner_embed_core.cache_info()
    x1 = pbatch.corner_extract_fused_core.cache_info()
    # Builder-key parity: the cost model requested EXACTLY the modules the
    # round-trip above dispatched — lru cache hits, zero new builder misses.
    assert e1.misses == e0.misses and e1.hits == e0.hits + 1
    assert x1.misses == x0.misses and x1.hits == x0.hits + 1

    # XLA counted real work: the corner DFT matmuls touch every pixel with
    # O(K) MACs, so a deeply conservative floor is a few flops per pixel.
    assert rep["embed_flops"] > 3 * B * H * W
    assert rep["extract_flops"] > 3 * B * H * W
    assert rep["roundtrip_flops_per_image"] == (
        rep["embed_flops"] + rep["extract_flops"]) / B

    g = rep["geometry"]
    assert g["stream_bytes"] == 38 + n + 16
    assert g["frame_bits"] == 912 + (n + 16) * 8 * 7
    assert rep["link_bytes_per_image"] == 4 * (
        g["stream_words_per_image"] + g["hard_words_per_image"])
    # ingest = covers up + stego down, u8 x 3 planes
    assert rep["ingest_bytes_per_image"] == 2 * 3 * H * W


def test_cost_rejects_off_branch_params():
    import pytest

    for p in (Params(adaptive_alpha=True), Params(per_image_walk=True),
              Params(rs=True)):
        with pytest.raises(ValueError):
            cost.roundtrip_cost(2, 128, 128, 40, params=p)


def test_measure_device_step_and_link_smoke():
    import jax

    rng = np.random.default_rng(1)
    covers_d = jax.device_put(_covers(2, 128, 128, rng))
    d = cost.measure_device_step(covers_d, bytes(range(32)), 40, reps=1)
    assert d["embed_s"] > 0 and d["extract_s"] > 0
    assert d["device_roundtrip_s"] == d["embed_s"] + d["extract_s"]
    link = cost.measure_link(nbytes=1 << 20, reps=1)
    assert link["up_bytes_per_sec"] > 0
    assert link["down_bytes_per_sec"] > 0


@pytest.mark.parametrize("env_dir", [True, False])
def test_compilation_cache_honours_env(monkeypatch, tmp_path, env_dir):
    """JAX_COMPILATION_CACHE_DIR set: JAX reads it and no other directory
    is set in code. Unset: the fixed in-checkout path."""
    import jax

    from steganosaurus_jax import runtime

    calls = {}
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: calls.__setitem__(k, v))
    if env_dir:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    runtime.enable_compilation_cache()
    if env_dir:
        assert "jax_compilation_cache_dir" not in calls
    else:
        got = calls["jax_compilation_cache_dir"]
        repo = pathlib.Path(runtime.__file__).resolve().parent.parent
        assert got.startswith(str(repo / ".cache" / "jax-"))


def test_device_peaks_h100_and_unknown():
    from steganosaurus_jax.utils import metrics

    p = metrics.device_peaks("NVIDIA H100 80GB HBM3")
    assert p["bf16_flops_per_s"] == 989e12
    assert p["tf32_flops_per_s"] == 495e12
    assert p["fp32_flops_per_s"] == 67e12
    assert p["hbm_bytes_per_s"] == 3.35e12
    with pytest.raises(ValueError, match="no published peaks"):
        metrics.device_peaks("cpu")
    assert metrics.mfu_pct(989e12, 2.0, p["bf16_flops_per_s"]) == 50.0
