"""Soft-decision recovery fallback (ops/ecc.rep_decode_soft;
params.soft_decode_fallback): matched-filter combining of the Rep-3/Rep-7
copies recovers margin-failure images the reference's hard majority vote
loses. Measured on the pinned cover below: 27/48 salts fail hard
extraction at the 240-byte capacity edge, the soft fallback recovers 21 of
them (56% -> 12.5% failure)."""

import numpy as np
import pytest

from steganosaurus_jax.config import Params
from steganosaurus_jax.ops import ecc
from steganosaurus_jax.pipeline.batch import embed_batch, extract_batch
from steganosaurus_jax.pipeline.embed import embed_array
from steganosaurus_jax.pipeline.extract import extract_array
from steganosaurus_jax.pipeline.errors import StegoError

MK = bytes(range(32))
HARD = Params(soft_decode_fallback=False)
SOFT = Params()


@pytest.fixture(scope="module")
def noise_cover():
    """Full-range noise: the adversarial cover class for channel margin
    (doc/HARDENING.md reliability model)."""
    rng = np.random.default_rng(1)
    return rng.integers(0, 256, (256, 256, 3)).astype(np.uint8)


@pytest.fixture(scope="module")
def heavy_secret():
    rng = np.random.default_rng(1)
    rng.integers(0, 256, (256, 256, 3))  # consume the cover draw
    return bytes(rng.integers(0, 256, 240, dtype=np.uint8))


def test_rep_decode_soft_agrees_on_clean_and_wins_on_weak():
    # clean channel: identical to the hard majority
    rng = np.random.default_rng(3)
    bits = rng.integers(0, 2, 70).astype(np.uint8)
    vals = (bits * 2.0 - 1.0) * rng.uniform(0.5, 2.0, 70)
    np.testing.assert_array_equal(
        np.asarray(ecc.rep_decode_soft(vals, 7)),
        np.asarray(ecc.rep_decode((vals >= 0).astype(np.uint8), 7)))
    # 4 weak flipped copies vs 3 strong correct ones: hard majority loses,
    # matched filter wins
    group = np.array([-0.1, -0.1, -0.1, -0.1, 5.0, 4.0, 3.0])
    assert ecc.rep_decode((group >= 0).astype(np.uint8), 7)[0] == 0
    assert ecc.rep_decode_soft(group, 7)[0] == 1


def test_soft_fallback_recovers_single_image(noise_cover, heavy_secret):
    """Pinned (cover, salt) pair where the hard majority fails — verified
    to be a reference-class failure (our hard path is oracle-tested
    bit-identical to the reference) — and the soft fallback recovers."""
    salt = bytes([4]) * 16
    res = embed_array(noise_cover, heavy_secret, master_key=MK, params=HARD,
                      salt=salt)
    with pytest.raises(StegoError):
        extract_array(res.stego, master_key=MK, params=HARD)
    assert extract_array(res.stego, master_key=MK,
                         params=SOFT) == heavy_secret
    # honesty: not every margin failure is recoverable (salt 0 is beyond
    # even the matched filter on this cover)
    res0 = embed_array(noise_cover, heavy_secret, master_key=MK, params=HARD,
                       salt=bytes([0]) * 16)
    with pytest.raises(StegoError):
        extract_array(res0.stego, master_key=MK, params=SOFT)


def test_soft_fallback_batch_paths(noise_cover, heavy_secret):
    """Batch extraction: the fallback re-decodes ONLY the AEAD-failed
    images (one fused soft module per failure class) and must strictly
    reduce the failure count on the margin workload."""
    B = 8
    covers = np.stack([noise_cover] * B)
    secrets = [heavy_secret] * B
    salts = [bytes([i]) * 16 for i in range(B)]
    res = embed_batch(covers, secrets, master_key=MK, params=HARD,
                      salts=salts)
    hard = extract_batch(np.asarray(res.stego), master_key=MK, params=HARD)
    soft = extract_batch(np.asarray(res.stego), master_key=MK, params=SOFT)
    n_hard = sum(g is None for g in hard)
    n_soft = sum(g is None for g in soft)
    assert n_hard > 0, "margin workload no longer produces hard failures"
    assert n_soft < n_hard, (n_soft, n_hard)
    # every soft success is the true secret, and no passing image changed
    for h, s in zip(hard, soft):
        if s is not None:
            assert s == heavy_secret
        if h is not None:
            assert s == h


def test_soft_fallback_piw(noise_cover, heavy_secret):
    """The fallback handles per-image-walk images (per-image soft module
    keyed by each header's salt). Payload slightly below the shared-walk
    ceiling: a salt-keyed payload walk re-seeds randomly after the header's
    visited marks, so its exhaustion point is a little earlier."""
    B = 6
    covers = np.stack([noise_cover] * B)
    secrets = [heavy_secret[:200]] * B
    salts = [bytes([i]) * 16 for i in range(B)]
    p_hard = Params(per_image_walk=True, soft_decode_fallback=False)
    res = embed_batch(covers, secrets, master_key=MK, params=p_hard,
                      salts=salts)
    hard = extract_batch(np.asarray(res.stego), master_key=MK, params=HARD)
    soft = extract_batch(np.asarray(res.stego), master_key=MK, params=SOFT)
    n_hard = sum(g is None for g in hard)
    n_soft = sum(g is None for g in soft)
    assert n_soft <= n_hard
    for s in soft:
        assert s is None or s == heavy_secret[:200]


def test_bucket_sel_shapes():
    """Failure subsets pad to power-of-2 sizes (capped at B) so jax.jit
    compiles at most log2(B) recovery-module variants instead of one per
    distinct failure count (measured: per-count compiles cut the bench's
    rotating-salt stage from ~220 to 9 img/s)."""
    from steganosaurus_jax.pipeline.batch import _bucket_sel

    for idxs, B, want in (([3], 64, 1), ([3, 5], 64, 2), ([1, 2, 3], 64, 4),
                          ([0, 1, 2, 3, 4], 64, 8), ([0, 1, 2, 3, 4], 6, 6),
                          (list(range(6)), 6, 6)):
        sel, n = _bucket_sel(idxs, B)
        assert n == len(idxs) and sel.size == want
        assert list(sel[:n]) == idxs and all(s == idxs[0] for s in sel[n:])


def test_inline_soft_recovers_without_retry_pass(noise_cover, heavy_secret,
                                                 monkeypatch):
    """The fused extract pass carries the matched-filter decode INLINE
    (parallel.batch corner_extract_fused_core with_soft): most margin
    failures resolve from a lazy pull of bytes already in HBM, with NO
    retry dispatch. Measured motivation: one failed image in a
    rotating-salt stream cost a 15.3 s fallback-module compile/launch
    (2026-08-18). The inline combiner runs on bf16 decision values (the
    f32 retry pass remains for the residual, where the two are a
    coin-flip: bf16 rounding ~0.4%% relative is far below the ~6%% u8
    quantization noise), so the contract is: inline recovers strictly
    more than hard, the retry pass sees ONLY what inline couldn't fix,
    and full recovery is at least inline's."""
    from steganosaurus_jax.pipeline import batch as pbm

    B = 8
    covers = np.stack([noise_cover] * B)
    secrets = [heavy_secret] * B
    salts = [bytes([i]) * 16 for i in range(B)]
    res = embed_batch(covers, secrets, master_key=MK, params=HARD,
                      salts=salts)
    stego = np.asarray(res.stego)
    hard = extract_batch(stego, master_key=MK, params=HARD)
    n_hard = sum(g is None for g in hard)
    full = extract_batch(stego, master_key=MK, params=SOFT)
    n_full = sum(g is None for g in full)
    assert n_full < n_hard

    monkeypatch.setattr(pbm._ExtractJob, "_soft_retry_failed",
                        lambda self, headers, out: None)
    inline = extract_batch(stego, master_key=MK, params=SOFT)
    n_inline = sum(g is None for g in inline)
    assert n_inline < n_hard          # inline recovery without dispatch
    assert n_full <= n_inline         # retry can only add on top
    for g, s in zip(inline, secrets):
        assert g is None or g == s
    # the retry pass is invoked only with the inline-unrecoverable rest
    seen = []
    monkeypatch.setattr(
        pbm._ExtractJob, "_soft_retry_failed",
        lambda self, headers, out: seen.append(
            sum(h is not None and o is None
                for h, o in zip(headers, out))))
    extract_batch(stego, master_key=MK, params=SOFT)
    assert seen == ([n_inline] if n_inline else [])


def test_inline_soft_sections_roundtrip_clean(noise_cover):
    """Clean batch under the combined pass: the hard sections decode
    everything (soft sections ride along unused), results identical to
    the fallback-off hard path."""
    B = 4
    covers = np.stack([noise_cover] * B)
    secrets = [b"inline-%d" % i for i in range(B)]
    salts = [bytes([100 + i]) * 16 for i in range(B)]
    res = embed_batch(covers, secrets, master_key=MK, params=SOFT,
                      salts=salts)
    stego = np.asarray(res.stego)
    assert extract_batch(stego, master_key=MK, params=SOFT) == secrets
    assert extract_batch(stego, master_key=MK, params=HARD) == secrets


def test_corrupt_clen_does_not_blow_pass_size(noise_cover, heavy_secret,
                                              monkeypatch):
    """A Rep-3-corrupted clen in one PARSEABLE hard header (the salt-0
    image on this fixture reads clen=1048816 instead of 240) must not
    inflate the whole group's payload pass to full capacity — sizing
    cross-checks the probe pass's matched-filter header. Without the
    cross-check the pass covers cap_bits (~101k slots here, a fresh host
    walk expansion); with it, the honest ~15k-slot bucket."""
    from steganosaurus_jax.pipeline import batch as pbm

    B = 4
    covers = np.stack([noise_cover] * B)
    secrets = [heavy_secret] * B
    salts = [bytes([i]) * 16 for i in [0, 4, 5, 6]]
    res = embed_batch(covers, secrets, master_key=MK, params=HARD,
                      salts=salts)
    stego = np.asarray(res.stego)

    sizes = []
    orig = pbm._ExtractJob._dispatch_pass

    def spy(self, payload_stream_bits, with_header, qim=None, rs=None):
        if not with_header:
            sizes.append(payload_stream_bits)
        return orig(self, payload_stream_bits, with_header, qim=qim, rs=rs)

    monkeypatch.setattr(pbm._ExtractJob, "_dispatch_pass", spy)
    got = extract_batch(stego, master_key=MK, params=SOFT)
    honest = (240 + 16) * 8 * 7
    assert sizes and all(s <= honest for s in sizes), sizes
    assert all(g == heavy_secret for g in got)


def test_soft_fallback_mesh_path(noise_cover, heavy_secret):
    """Sharded (mesh) extraction composes with the soft fallback — since
    round 4 INLINE: corner_gather_decode_core with_soft emits the soft
    sections from the mesh-sharded dense decision values
    (corner_bits_core with_values), so AEAD failures resolve without
    routing to single-chip retry cores."""
    from steganosaurus_jax.parallel.batch import make_mesh

    B = 8
    covers = np.stack([noise_cover] * B)
    secrets = [heavy_secret] * B
    salts = [bytes([i]) * 16 for i in range(B)]
    res = embed_batch(covers, secrets, master_key=MK, params=HARD,
                      salts=salts)
    stego = np.asarray(res.stego)
    mesh = make_mesh()
    hard = extract_batch(stego, master_key=MK, params=HARD, mesh=mesh)
    soft = extract_batch(stego, master_key=MK, params=SOFT, mesh=mesh)
    n_hard = sum(g is None for g in hard)
    n_soft = sum(g is None for g in soft)
    assert n_hard > 0 and n_soft < n_hard, (n_soft, n_hard)
    for g in soft:
        assert g is None or g == heavy_secret


def test_soft_fallback_adaptive_alpha_batch(noise_cover, heavy_secret):
    """VERDICT r3 item 5: the adaptive-alpha BATCH path (legacy-spectra
    extract, pipeline.batch _use_corner=False) now rides the same fused
    soft emission (parallel.batch batched_gather_decode_core with_soft).
    The margin workload must show the fallback recovering failed images,
    and soft successes must be the true secret with passing images
    unchanged."""
    B = 8
    covers = np.stack([noise_cover] * B)
    secrets = [heavy_secret] * B
    salts = [bytes([i]) * 16 for i in range(B)]
    hard_p = Params(adaptive_alpha=True, soft_decode_fallback=False)
    soft_p = Params(adaptive_alpha=True)
    res = embed_batch(covers, secrets, master_key=MK, params=hard_p,
                      salts=salts)
    hard = extract_batch(np.asarray(res.stego), master_key=MK, params=hard_p)
    soft = extract_batch(np.asarray(res.stego), master_key=MK, params=soft_p)
    n_hard = sum(g is None for g in hard)
    n_soft = sum(g is None for g in soft)
    assert n_soft <= n_hard, (n_soft, n_hard)
    for h, s in zip(hard, soft):
        if s is not None:
            assert s == heavy_secret
        if h is not None:
            assert s == h
    # the margin workload must actually exercise the fallback: if this
    # stops producing hard failures, tighten the channel instead of
    # silently testing the no-op path
    assert n_hard > 0, "adaptive margin workload no longer fails hard"
    assert n_soft < n_hard, "fallback recovered nothing on adaptive batch"
