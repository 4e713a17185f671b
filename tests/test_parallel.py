"""Parallel layer tests on the virtual 8-device CPU mesh.

Covers the DP axis (batched, sharded embed/extract cores) and the SP axis
(shard_map distributed FFT + sharded phase ops) against the single-device
reference implementations.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from steganosaurus_jax import spectral
from steganosaurus_jax.ops import phase as phase_ops
from steganosaurus_jax.parallel import batch as pbatch
from steganosaurus_jax.parallel import fft_dist


needs_8 = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 devices")


@pytest.fixture(scope="module")
def mesh8():
    return Mesh(np.asarray(jax.devices()[:8]), ("image",))


def _rand_planes(rng, PH, PW):
    return rng.uniform(0, 255, (3, PH, PW)).astype(np.float32)


# ------------------------------------------------------------------ dist FFT
@needs_8
def test_fft2_distributed_matches_local(mesh8):
    rng = np.random.default_rng(0)
    planes = _rand_planes(rng, 64, 128)
    sharded = jax.device_put(planes, NamedSharding(mesh8, P(None, "image", None)))
    got = np.asarray(fft_dist.fft2_distributed(sharded, mesh8))
    want = np.asarray(spectral.fft2(jnp.asarray(planes)))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-1)


@needs_8
def test_ifft2_real_distributed_roundtrip(mesh8):
    rng = np.random.default_rng(1)
    planes = _rand_planes(rng, 128, 64)
    sharded = jax.device_put(planes, NamedSharding(mesh8, P(None, "image", None)))
    spec = fft_dist.fft2_distributed(sharded, mesh8)
    back = np.asarray(fft_dist.ifft2_real_distributed(spec, mesh8))
    np.testing.assert_allclose(back, planes, rtol=1e-4, atol=5e-3)


@needs_8
def test_median_abs_distributed(mesh8):
    rng = np.random.default_rng(2)
    planes = _rand_planes(rng, 64, 64)
    sharded = jax.device_put(planes, NamedSharding(mesh8, P(None, "image", None)))
    spec = fft_dist.fft2_distributed(sharded, mesh8)
    got = np.asarray(fft_dist.median_abs_distributed(spec, mesh8))
    want = np.asarray(spectral.median_abs(jnp.asarray(np.asarray(spec))))
    np.testing.assert_array_equal(got, want)


@needs_8
def test_sharded_gather_scatter_match_dense(mesh8):
    rng = np.random.default_rng(3)
    PH = PW = 64
    planes = _rand_planes(rng, PH, PW)
    spec_local = np.asarray(spectral.fft2(jnp.asarray(planes)))

    n = 50
    plane = rng.integers(0, 3, n).astype(np.int32)
    # off-axis bins in the lower-left quadrant: distinct from their mirrors,
    # chosen without collisions between a bin and any selected mirror
    y = rng.integers(1, PH // 2, n).astype(np.int32)
    x = rng.integers(1, PW // 2, n).astype(np.int32)
    uniq = {}
    for i in range(n):
        uniq[(int(plane[i]), int(y[i]), int(x[i]))] = i
    keep = sorted(uniq.values())
    plane, y, x = plane[keep], y[keep], x[keep]
    m = len(keep)
    nv = (rng.normal(size=m) + 1j * rng.normal(size=m)).astype(np.complex64)

    sharded = jax.device_put(
        jnp.asarray(spec_local), NamedSharding(mesh8, P(None, None, "image"))
    )
    got_vals = np.asarray(
        fft_dist.gather_bins_distributed(sharded, plane, y, x, mesh8)
    )
    np.testing.assert_allclose(got_vals, spec_local[plane, y, x], rtol=1e-6)

    got_spec = np.asarray(
        fft_dist.scatter_bins_distributed(sharded, plane, y, x, nv, mesh8)
    )
    want = spec_local.copy()
    want[plane, y, x] = nv
    cy, cx = np.asarray(phase_ops.conj_indices(y, x, PH, PW))
    want[plane, cy, cx] = np.conj(nv)
    np.testing.assert_allclose(got_spec, want, rtol=1e-6)


@needs_8
def test_distributed_embed_read_roundtrip(mesh8):
    """SP-sharded embed -> quantize -> SP-sharded read recovers the bits."""
    rng = np.random.default_rng(4)
    PH = PW = 128
    planes = np.clip(
        190 + rng.integers(-20, 21, (3, PH, PW)), 0, 255
    ).astype(np.float32)

    n = 64
    plane = rng.integers(0, 3, n).astype(np.int32)
    y = rng.integers(8, PH // 2 - 1, n).astype(np.int32)
    x = rng.integers(8, PW // 2 - 1, n).astype(np.int32)
    seen, keep = set(), []
    for i in range(n):
        k = (int(plane[i]), int(y[i]), int(x[i]))
        if k not in seen:
            seen.add(k)
            keep.append(i)
    plane, y, x = plane[keep], y[keep], x[keep]
    m = len(keep)
    bits = rng.integers(0, 2, m).astype(np.uint8)
    jit = np.zeros(m, np.float32)

    rows = NamedSharding(mesh8, P(None, "image", None))
    sharded = jax.device_put(planes, rows)
    out = fft_dist.embed_core_distributed(
        sharded, plane, y, x, jnp.asarray(bits), jit, jnp.float32(0.5), mesh8
    )
    stego_planes = np.clip(np.floor(np.asarray(out) + 0.5), 0, 255).astype(
        np.float32
    )
    sharded2 = jax.device_put(stego_planes, rows)
    got = np.asarray(
        fft_dist.read_core_distributed(
            sharded2, plane, y, x, jit, jnp.float32(0.5), mesh8
        )
    )
    # raw (pre-ECC) bit errors from u8 quantization must stay tiny
    assert (got != bits).mean() < 0.05


# ------------------------------------------------------------------ DP batch
def _rand_batch(rng, B, H, W, n, shared_idx):
    imgs = rng.integers(0, 256, (B, H, W, 3)).astype(np.uint8)
    shp = (n,) if shared_idx else (B, n)
    plane = rng.integers(0, 3, shp).astype(np.int32)
    y = rng.integers(1, H // 2, shp).astype(np.int32)
    x = rng.integers(1, W // 2, shp).astype(np.int32)
    bits = rng.integers(0, 2, (B, n)).astype(np.uint8)
    jit = np.zeros(shp, np.float32)
    return imgs, plane, y, x, bits, jit


@pytest.mark.parametrize("shared_idx", [True, False])
def test_batched_embed_matches_single(shared_idx):
    rng = np.random.default_rng(5)
    B, H, W, n = 4, 64, 64, 40
    imgs, plane, y, x, bits, jit = _rand_batch(rng, B, H, W, n, shared_idx)

    fn = pbatch.batched_embed_core(H, W, False, False, None, shared_idx)
    got = np.asarray(fn(imgs, plane, y, x, bits, jit, jnp.float32(0.5)))

    core = pbatch._embed_core
    for b in range(B):
        sel = (lambda a: a) if shared_idx else (lambda a: a[b])
        want = np.asarray(
            core(imgs[b], sel(plane), sel(y), sel(x), bits[b], sel(jit),
                 jnp.float32(0.5), H=H, W=W, PH=H, PW=W,
                 center=False, adaptive=False)
        )
        np.testing.assert_array_equal(got[b], want)


def test_analyze_plus_gather_matches_full_read():
    """Split analyze+gather path == one-shot read core (spectrum reuse)."""
    rng = np.random.default_rng(7)
    B, H, W, n = 3, 64, 64, 25
    imgs, plane, y, x, _, jit = _rand_batch(rng, B, H, W, n, True)
    a = jnp.float32(0.5)

    spec, med = pbatch.batched_analyze_core(H, W, False)(imgs)
    got = np.asarray(
        pbatch.batched_gather_bits_core(False)(spec, med, plane, y, x, jit, a)
    )
    want = np.asarray(
        pbatch.batched_read_core(H, W, False, False)(imgs, plane, y, x, jit, a)
    )
    np.testing.assert_array_equal(got, want)


@needs_8
def test_batched_core_sharded_over_mesh():
    rng = np.random.default_rng(6)
    mesh = pbatch.make_mesh(8)
    B, H, W, n = 8, 64, 64, 16
    imgs, plane, y, x, bits, jit = _rand_batch(rng, B, H, W, n, True)

    fn = pbatch.batched_embed_core(H, W, False, False, mesh)
    got = fn(pbatch.shard_batch(imgs, mesh), plane, y, x,
             pbatch.shard_batch(bits, mesh), jit, jnp.float32(0.5))
    assert got.shape == (B, H, W, 3)
    ref = pbatch.batched_embed_core(H, W, False, False)(
        imgs, plane, y, x, bits, jit, jnp.float32(0.5)
    )
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))


def test_mesh_composed_piw_rs_qim_roundtrip():
    """VERDICT r3 item 8: the full wire-format stack composed across mesh
    shards — salt-keyed per-image walks + interleaved RS(255,223) FEC +
    dithered phase QIM — embeds under the mesh and extracts under plain
    defaults (wire modes are self-describing via header flags)."""
    from steganosaurus_jax.config import Params
    from steganosaurus_jax.pipeline.batch import embed_batch, extract_batch

    rng = np.random.default_rng(11)
    mesh = pbatch.make_mesh(8)
    B, H, W = 8, 128, 128
    base = np.linspace(170, 225, W)
    imgs = np.clip(
        base[None, None, :, None] + rng.integers(-12, 13, (B, H, W, 3)),
        0, 255).astype(np.uint8)
    secrets = [bytes(rng.integers(0, 256, 40, dtype=np.uint8))
               for _ in range(B)]
    p_embed = Params(pbkdf2_iter=100, per_image_walk=True, rs=True, qim=3)
    p_plain = Params(pbkdf2_iter=100)
    res = embed_batch(imgs, secrets, password="pw", params=p_embed,
                      mesh=mesh)
    got = extract_batch(np.asarray(res.stego), password="pw",
                        params=p_plain, mesh=mesh)
    assert got == secrets
    # and single-device extraction agrees (mesh does not change the wire)
    got1 = extract_batch(np.asarray(res.stego), password="pw",
                         params=p_plain)
    assert got1 == secrets
