"""Batched pipeline tests: ragged secrets, mesh sharding, cross-consistency
with the single-image pipeline, and per-image failure isolation."""

import jax
import numpy as np
import pytest

from steganosaurus_jax.config import Params
from steganosaurus_jax.parallel import batch as pbatch
from steganosaurus_jax.pipeline.batch import embed_batch, extract_batch
from steganosaurus_jax.pipeline.extract import extract_array

FAST = dict(pbkdf2_iter=500)


@pytest.fixture(scope="module")
def covers():
    rng = np.random.default_rng(21)
    base = np.linspace(170, 225, 128)
    imgs = base[None, None, :, None] + rng.integers(-12, 13, (6, 128, 128, 3))
    return np.clip(imgs, 0, 255).astype(np.uint8)


def test_embed_extract_batch_ragged(covers):
    p = Params(**FAST)
    secrets = [b"a", b"bb", b"ccc", b"x" * 40, b"hello world", b"z"]
    # Pinned salts: random salts make this a channel-margin coin flip (a
    # fresh salt redraws the AEAD bit pattern; a small per-salt failure
    # probability is inherent to the scheme - verify mode exists for exactly
    # that). A parity/semantics test must be deterministic.
    salts = [bytes([11 * i + 1]) * 16 for i in range(6)]
    res = embed_batch(covers, secrets, password="pw", params=p, salts=salts)
    assert res.stego.shape == covers.shape
    got = extract_batch(res.stego, password="pw", params=p)
    assert got == secrets


def test_batch_1080p_multikb_payload():
    """BASELINE config 2: 1080p covers, multi-KB secrets (Rep-3 header +
    Rep-7 payload). Non-pow2 dims run at native spectral size — the reference
    binary cannot round-trip these at all (see test_rectangular_image).

    A 4 KB secret uses ~60% of the 1080p walk capacity, where the Rep-3
    header has a small per-salt failure probability (same BER physics as the
    reference) — verify=True is the production mechanism that re-salts until
    read-back succeeds, making recovery deterministic."""
    rng = np.random.default_rng(31)
    base = np.linspace(140, 230, 1920)
    covers = np.clip(base[None, None, :, None]
                     + rng.integers(-25, 26, (2, 1080, 1920, 3)),
                     0, 255).astype(np.uint8)
    p = Params(**FAST)
    secrets = [bytes(rng.integers(0, 256, 4096, dtype=np.uint8)),
               bytes(rng.integers(0, 256, 2000, dtype=np.uint8))]
    res = embed_batch(covers, secrets, password="pw", params=p, verify=True,
                      max_retries=4)
    assert res.verified == [True, True]
    got = extract_batch(res.stego, password="pw", params=p, clen_hint=4096)
    assert got == secrets
    err = res.stego.astype(np.float64) - covers.astype(np.float64)
    psnr = 10 * np.log10(255.0 ** 2 / np.mean(np.square(err)))
    assert psnr > 30.0, psnr  # imperceptibility sanity at 4KB payloads


def test_batch_embed_verify_mode(covers, monkeypatch):
    """verify=True read-back-verifies and re-salts failures until recovery."""
    p = Params(**FAST)
    secrets = [b"v0", b"v1", b"v2"]
    res = embed_batch(covers[:3], secrets, password="pw", params=p, verify=True)
    assert res.verified == [True, True, True]
    assert len(res.salts) == 3 and all(len(s) == 16 for s in res.salts)
    assert extract_batch(res.stego, password="pw", params=p) == secrets

    # Force one failure on the first read-back: the retry must re-embed that
    # image with a fresh salt and converge.
    import steganosaurus_jax.pipeline.batch as pb

    real_extract = pb.extract_batch
    calls = {"n": 0}

    def flaky_extract(*a, **kw):
        out = real_extract(*a, **kw)
        calls["n"] += 1
        if calls["n"] == 1:
            out = list(out)
            out[1] = None
        return out

    monkeypatch.setattr(pb, "extract_batch", flaky_extract)
    fixed_salts = [bytes([i]) * 16 for i in range(3)]
    res2 = pb.embed_batch(covers[:3], secrets, password="pw", params=p,
                          salts=fixed_salts, verify=True)
    monkeypatch.undo()
    assert res2.verified == [True, True, True]
    assert res2.salts[0] == fixed_salts[0] and res2.salts[2] == fixed_salts[2]
    assert res2.salts[1] != fixed_salts[1]  # re-salted on retry
    assert extract_batch(res2.stego, password="pw", params=p) == secrets


def test_batch_matches_single_image_pipeline(covers):
    """A batch-embedded stego must decode with the single-image extractor."""
    p = Params(**FAST)
    secrets = [b"batch-vs-single"] * 2
    res = embed_batch(covers[:2], secrets, password="pw", params=p)
    for i in range(2):
        assert extract_array(res.stego[i], password="pw", params=p) == secrets[i]


def test_batch_raw_key(covers):
    p = Params(**FAST)
    mk = bytes(range(32))
    secrets = [b"k0", b"k1", b"k2"]
    res = embed_batch(covers[:3], secrets, master_key=mk, params=p)
    assert extract_batch(res.stego, master_key=mk, params=p) == secrets


def test_batch_failure_isolation(covers):
    """A corrupted image yields None without poisoning its batchmates."""
    p = Params(**FAST)
    secrets = [b"good0", b"good1", b"good2"]
    res = embed_batch(covers[:3], secrets, password="pw", params=p)
    stego = res.stego.copy()
    stego[1] = covers[3]  # not a stego image at all
    got = extract_batch(stego, password="pw", params=p)
    assert got == [b"good0", None, b"good2"]


def test_batch_clen_hint_paths(covers):
    """clen_hint fuses gathers; exact, oversized, and undersized hints all
    decode correctly (an undersized hint falls back to a second gather)."""
    p = Params(**FAST)
    secrets = [b"short", b"a much longer secret payload here", b"mid-size!"]
    res = embed_batch(covers[:3], secrets, password="pw", params=p)
    for hint in (33, 64, 2):  # exact max, oversized, undersized
        got = extract_batch(res.stego, password="pw", params=p, clen_hint=hint)
        assert got == secrets, hint


def test_batch_device_resident_roundtrip(covers):
    """Device-resident covers in, device-resident stego out, no host hop."""
    p = Params(**FAST)
    secrets = [b"dev0", b"dev1"]
    covers_d = jax.device_put(covers[:2])
    res = embed_batch(covers_d, secrets, password="pw", params=p,
                      device_resident=True)
    assert not isinstance(res.stego, np.ndarray)
    got = extract_batch(res.stego, password="pw", params=p, clen_hint=8)
    assert got == secrets
    # pulled stego matches the host-path pixels exactly
    res2 = embed_batch(covers[:2], secrets, password="pw", params=p,
                       salts=[bytes(16)] * 2)
    res3 = embed_batch(covers_d, secrets, password="pw", params=p,
                       salts=[bytes(16)] * 2, device_resident=True)
    np.testing.assert_array_equal(res2.stego, np.asarray(res3.stego))


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 devices")
def test_batch_verify_mesh_retry_nondivisible(covers, monkeypatch):
    """verify=True over a mesh must survive a failed-image count that does
    not divide the mesh size (the retry re-embeds the subset unsharded)."""
    import steganosaurus_jax.pipeline.batch as pb

    p = Params(**FAST)
    mesh = pbatch.make_mesh(8)
    imgs = np.concatenate([covers, covers[:2]], axis=0)  # B=8
    secrets = [f"vm{i}".encode() for i in range(8)]

    real_extract = pb.extract_batch
    calls = {"n": 0}

    def flaky_extract(*a, **kw):
        out = real_extract(*a, **kw)
        calls["n"] += 1
        if calls["n"] == 1:  # 3 failures: 3 does not divide 8
            out = list(out)
            for i in (1, 4, 6):
                out[i] = None
        return out

    monkeypatch.setattr(pb, "extract_batch", flaky_extract)
    res = pb.embed_batch(imgs, secrets, password="pw", params=p, mesh=mesh,
                         verify=True)
    monkeypatch.undo()
    assert res.verified == [True] * 8
    assert extract_batch(res.stego, password="pw", params=p) == secrets


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 devices")
def test_batch_sharded_over_mesh(covers):
    p = Params(**FAST)
    mesh = pbatch.make_mesh(8)
    imgs = np.concatenate([covers, covers[:2]], axis=0)  # B=8
    secrets = [f"img{i}".encode() for i in range(8)]
    res = embed_batch(imgs, secrets, password="pw", params=p, mesh=mesh)
    got = extract_batch(res.stego, password="pw", params=p, mesh=mesh)
    assert got == secrets
    # sharded and unsharded paths produce identical stego pixels
    res2 = embed_batch(imgs, secrets, password="pw", params=p,
                       salts=[bytes(16)] * 8)
    res3 = embed_batch(imgs, secrets, password="pw", params=p, mesh=mesh,
                       salts=[bytes(16)] * 8)
    np.testing.assert_array_equal(res2.stego, res3.stego)


def test_4k_uhd_payload_ceiling():
    """BASELINE config 3 payload ceiling at native 4K UHD. The walk capacity
    is key-dependent but ~1.53M stream bits (quarter-annulus of radius
    0.45*min(H,W)=972 holds ~2.2M candidate bins; density rejections consume
    ~1/0.7 candidates per accepted bit) => max payload ~26-27 KB. The
    reference's "15-50 KB at 4K" claim (README.md:110-117) rides its pow2 pad
    to 4096^2, where min(H,W)=4096 quadruples the annulus — see
    test_4k_pow2_50kb_payload for that class.

    A 26 KB payload must embed+extract; 27.5 KB must exhaust the walk and
    raise the bounded capacity error (the reference HANGS past capacity on a
    corrupt clen — doc/TESTING.md:151-156 — and aborts on its conservative
    estimator otherwise; our boundary is the true walk capacity)."""
    from steganosaurus_jax.pipeline.errors import StegoError

    rng = np.random.default_rng(5)
    base = np.linspace(140, 230, 3840)
    cover = np.clip(base[None, None, :, None]
                    + rng.integers(-20, 21, (1, 2160, 3840, 3)),
                    0, 255).astype(np.uint8)
    p = Params(**FAST)
    secret = bytes(rng.integers(0, 256, 26 * 1024, dtype=np.uint8))
    res = embed_batch(cover, [secret], password="pw", params=p,
                      salts=[bytes([77]) * 16])
    got = extract_batch(res.stego, password="pw", params=p,
                        clen_hint=len(secret))
    assert got == [secret]

    with pytest.raises(StegoError, match="Message too large"):
        embed_batch(cover, [bytes(28160)], password="pw", params=p)


def test_4k_pow2_50kb_payload():
    """BASELINE config 3 upper bound: 50 KB in a 4096^2 (pow2) cover — the
    class the reference's 15-50 KB capacity claim actually describes. The
    walk needs ~2.87M stream bits of the ~5.5M available at min(H,W)=4096."""
    rng = np.random.default_rng(6)
    base = np.linspace(130, 235, 4096)
    cover = np.clip(base[None, None, :, None]
                    + rng.integers(-24, 25, (1, 4096, 4096, 3)),
                    0, 255).astype(np.uint8)
    p = Params(**FAST)
    secret = bytes(rng.integers(0, 256, 50 * 1024, dtype=np.uint8))
    res = embed_batch(cover, [secret], password="pw", params=p,
                      salts=[bytes([78]) * 16])
    got = extract_batch(res.stego, password="pw", params=p,
                        clen_hint=len(secret))
    assert got == [secret]


def test_stream_pipelining_matches_batch(covers):
    """embed_stream/extract_stream (pipeline.stream) must produce results
    identical to per-batch embed_batch/extract_batch: the overlap is pure
    scheduling, never semantics. Fixed salts make the comparison exact."""
    from steganosaurus_jax.pipeline import stream

    p = Params(**FAST)
    secrets = [bytes([i]) * (5 + i) for i in range(6)]
    salts = [bytes([i * 7]) * 16 for i in range(6)]
    batches = [(covers[:2], secrets[:2], salts[:2]),
               (covers[2:4], secrets[2:4], salts[2:4]),
               (covers[4:], secrets[4:], salts[4:])]

    streamed = list(stream.embed_stream(iter(batches), password="pw",
                                        params=p, depth=2))
    assert len(streamed) == 3
    for (imgs, secs, sl), res in zip(batches, streamed):
        ref = embed_batch(imgs, secs, password="pw", params=p, salts=sl)
        np.testing.assert_array_equal(np.asarray(res.stego), ref.stego)

    got = list(stream.extract_stream((r.stego for r in streamed),
                                     password="pw", params=p, depth=2))
    assert [s for g in got for s in g] == secrets


def test_extract_dispatch_finalize(covers):
    """The dispatch/finalize split (host/device overlap seam) is
    semantically identical to the blocking call, including with a fused
    clen_hint and with interleaved jobs in flight."""
    from steganosaurus_jax.pipeline.batch import extract_dispatch

    p = Params(**FAST)
    secrets = [b"dispatch" * 3] * 3 + [b"finalize!"] * 3
    res = embed_batch(covers, secrets, password="pw", params=p,
                      salts=[bytes(16)] * 6)
    j1 = extract_dispatch(res.stego[:3], password="pw", params=p,
                          clen_hint=24)
    j2 = extract_dispatch(res.stego[3:], password="pw", params=p)
    assert j2.finalize() == secrets[3:]
    assert j1.finalize() == secrets[:3]


def test_nchw_layout_matches_nhwc(covers):
    """layout='nchw' (the device-resident serving fast path that skips both
    u8 relayouts) must produce pixel-identical stego and identical
    extraction vs the default layout."""
    from steganosaurus_jax.pipeline.batch import channel_report

    p = Params(**FAST)
    secrets = [bytes([40 + i]) * 12 for i in range(6)]
    salts = [bytes([i * 3]) * 16 for i in range(6)]
    ref = embed_batch(covers, secrets, password="pw", params=p, salts=salts)
    res = embed_batch(np.ascontiguousarray(covers.transpose(0, 3, 1, 2)),
                      secrets, password="pw", params=p, salts=salts,
                      layout="nchw")
    np.testing.assert_array_equal(
        np.asarray(res.stego).transpose(0, 2, 3, 1), ref.stego)
    got = extract_batch(res.stego, password="pw", params=p, layout="nchw")
    assert got == secrets
    rep = channel_report(res.stego, secrets, salts, password="pw", params=p,
                         layout="nchw")
    assert rep["payload_ber_post_ecc"] == 0.0


def test_stream_over_mesh(covers):
    """The stream pipeline composes with mesh sharding: streamed results
    over an 8-device mesh equal the unsharded per-batch results."""
    from steganosaurus_jax.pipeline import stream

    mesh = pbatch.make_mesh(8)
    p = Params(**FAST)
    secrets = [bytes([60 + i]) * 9 for i in range(8)]
    salts = [bytes([3 * i + 2]) * 16 for i in range(8)]
    big = np.concatenate([covers, covers[:2]])  # 8 images
    batches = [(big, secrets, salts), (big, secrets, salts)]
    outs = list(stream.embed_stream(iter(batches), password="pw", params=p,
                                    mesh=mesh, depth=1))
    ref = embed_batch(big, secrets, password="pw", params=p, salts=salts)
    for res in outs:
        np.testing.assert_array_equal(np.asarray(res.stego), ref.stego)
    got = list(stream.extract_stream((r.stego for r in outs), password="pw",
                                     params=p, mesh=mesh, depth=1))
    assert got == [secrets, secrets]


def test_batch_jitter_corner_paths(covers):
    """jitter != 0 drives the corner statics (cjd/sjd maps), the dense
    jitter write/read trig, the fused-extract jitter branch, and the
    channel report's jitter analysis — previously only the single-image
    legacy scatter path had jitter coverage."""
    from steganosaurus_jax.pipeline.batch import channel_report

    p = Params(jitter=0.2, **FAST)
    secrets = [bytes([70 + i]) * (7 + i) for i in range(6)]
    salts = [bytes([5 * i + 1]) * 16 for i in range(6)]
    res = embed_batch(covers, secrets, password="pw", params=p, salts=salts)

    # unhinted (header fused pass + payload second pass) and hinted
    # (single fused pass) must both decode
    assert extract_batch(res.stego, password="pw", params=p) == secrets
    assert extract_batch(res.stego, password="pw", params=p,
                         clen_hint=13) == secrets
    rep = channel_report(res.stego, secrets, salts, password="pw", params=p)
    assert rep["payload_ber_post_ecc"] == 0.0

    # cross-path: the single-image legacy scatter pipeline must read the
    # batch-embedded stego identically (locks the dense jitter trig
    # against the reference-literal formulation)
    assert extract_array(res.stego[2], password="pw", params=p) == secrets[2]

    # mesh path with jitter (replicated statics + sharded cores)
    mesh = pbatch.make_mesh(8)
    big = np.concatenate([covers, covers[:2]])
    secrets8 = [bytes([80 + i]) * 11 for i in range(8)]
    salts8 = [bytes([7 * i + 3]) * 16 for i in range(8)]
    res8 = embed_batch(big, secrets8, password="pw", params=p, salts=salts8,
                       mesh=mesh)
    assert extract_batch(res8.stego, password="pw", params=p,
                         mesh=mesh) == secrets8
    # mesh and single-chip embeds must be pixel-identical
    res8b = embed_batch(big, secrets8, password="pw", params=p,
                        salts=salts8)
    np.testing.assert_array_equal(res8.stego, res8b.stego)


def test_edge_cases(covers):
    """Empty payloads, empty streams, clean-cover extraction, and wrong
    passwords must all behave gracefully (no crashes, None per failed
    image) across batch, dispatch, and stream surfaces."""
    from steganosaurus_jax.pipeline import stream
    from steganosaurus_jax.pipeline.batch import extract_dispatch

    p = Params(**FAST)
    two = covers[:2]
    res = embed_batch(two, [b"", b"x"], password="pw", params=p,
                      salts=[bytes(16)] * 2)
    assert extract_batch(res.stego, password="pw", params=p) == [b"", b"x"]
    assert list(stream.embed_stream(iter([]), password="pw", params=p)) == []
    assert extract_batch(two, password="pw", params=p) == [None, None]
    assert extract_batch(res.stego, password="WRONG", params=p) == [None] * 2
    assert extract_dispatch(two, password="pw",
                            params=p).finalize() == [None, None]


def test_stream_depth_watermark(covers, monkeypatch):
    """The stream generators must hold AT MOST `depth` batches in flight —
    the docstring's promise (a prior off-by-one held depth+1: ~800 MB of
    surplus device-resident stego at 4K/B=32). Watermark = dispatched minus
    yielded, sampled at every dispatch."""
    from steganosaurus_jax.pipeline import stream as pstream
    from steganosaurus_jax.pipeline.batch import extract_dispatch as real_ed

    p = Params(**FAST)
    secrets = [b"watermark"] * 2
    salts = [bytes([9]) * 16, bytes([10]) * 16]

    state = {"created": 0, "consumed": 0, "marks": []}
    real_embed = pstream.embed_batch

    def counting_embed(*a, **k):
        state["created"] += 1
        state["marks"].append(state["created"] - state["consumed"])
        return real_embed(*a, **k)

    monkeypatch.setattr(pstream, "embed_batch", counting_embed)
    results = []
    for res in pstream.embed_stream(
            ((covers[:2], secrets, salts) for _ in range(5)),
            password="pw", params=p, depth=2):
        state["consumed"] += 1
        results.append(res)
    assert len(results) == 5
    assert max(state["marks"]) <= 2

    state2 = {"created": 0, "consumed": 0, "marks": []}

    def counting_dispatch(*a, **k):
        state2["created"] += 1
        state2["marks"].append(state2["created"] - state2["consumed"])
        return real_ed(*a, **k)

    monkeypatch.setattr(pstream, "extract_dispatch", counting_dispatch)
    n = 0
    for got in pstream.extract_stream((r.stego for r in results),
                                      password="pw", params=p, depth=2):
        state2["consumed"] += 1
        n += 1
        assert got == secrets
    assert n == 5
    assert max(state2["marks"]) <= 2


def test_extract_finalize_idempotent(covers):
    """finalize() must cache its result: a second call on a job obtained
    from the public extract_dispatch() returns the SAME list instead of
    crashing on the consumed device buffer."""
    from steganosaurus_jax.pipeline.batch import extract_dispatch

    p = Params(**FAST)
    secrets = [b"idempotent"] * 6
    res = embed_batch(covers, secrets, password="pw", params=p,
                      salts=[bytes([5 * i + 2]) * 16 for i in range(6)])
    job = extract_dispatch(res.stego, password="pw", params=p, clen_hint=10)
    first = job.finalize()
    assert first == secrets
    assert job.finalize() is first


@pytest.mark.parametrize("jitter", [0.0, 0.05])
def test_embed_extract_share_cached_statics(covers, jitter):
    """An equal-length embed -> hinted-extract round trip must share ONE
    device walk-index upload and ONE corner-statics build: both sides key
    the caches (nbits=frame_total, bucket=ceil4096(total)) identically
    (total-frame bucketing; a prior mismatch built functionally identical
    statics twice on the jitter path)."""
    from steganosaurus_jax.pipeline import batch as pipeline_batch

    p = Params(jitter=jitter, **FAST)
    secrets = [b"one-shared-statics-build"] * 6  # equal-length fast path
    salts = [bytes([3 * i + 1]) * 16 for i in range(6)]
    pipeline_batch._CORNER_STATICS_CACHE.clear()
    pipeline_batch._DEV_IDX_CACHE.clear()

    res = embed_batch(covers, secrets, password="pw", params=p, salts=salts)
    n_statics = len(pipeline_batch._CORNER_STATICS_CACHE)
    n_idx = len(pipeline_batch._DEV_IDX_CACHE)
    assert n_statics >= 1 and n_idx >= 1

    got = extract_batch(res.stego, password="pw", params=p,
                        clen_hint=len(secrets[0]))
    assert got == secrets
    assert len(pipeline_batch._CORNER_STATICS_CACHE) == n_statics
    assert len(pipeline_batch._DEV_IDX_CACHE) == n_idx


def test_stream_key_rotation_prefetch(covers, monkeypatch):
    """Per-batch master_key rotation in embed_stream: results must match
    per-key embed_batch calls, and the NEW key's sequential walk expansion
    must be kicked onto the worker thread (overlapping device work) rather
    than stalling the dispatching thread."""
    import threading

    from steganosaurus_jax import keystream
    from steganosaurus_jax.pipeline import stream as pstream

    expand_threads: list[str] = []
    real_expand = keystream.turtle_expand

    def spy(*a, **k):
        expand_threads.append(threading.current_thread().name)
        return real_expand(*a, **k)

    monkeypatch.setattr(keystream, "turtle_expand", spy)
    keystream._CACHE.clear()  # cold walks: both keys must expand

    p = Params(**FAST)
    mk1, mk2 = bytes(range(32)), bytes(range(1, 33))
    secrets = [b"rotate", b"keys!!"]
    salts = [bytes([40]) * 16, bytes([41]) * 16]
    batches = [(covers[:2], secrets, salts),
               (covers[2:4], secrets, salts, mk2),
               (covers[4:6], secrets, salts, mk2)]
    got = list(pstream.embed_stream(iter(batches), master_key=mk1,
                                    params=p, depth=2))
    assert len(got) == 3
    assert any(t.startswith("walk-pf") for t in expand_threads), expand_threads

    ref1 = embed_batch(covers[:2], secrets, master_key=mk1, params=p,
                       salts=salts)
    ref2 = embed_batch(covers[2:4], secrets, master_key=mk2, params=p,
                       salts=salts)
    np.testing.assert_array_equal(np.asarray(got[0].stego), ref1.stego)
    np.testing.assert_array_equal(np.asarray(got[1].stego), ref2.stego)
    assert extract_batch(np.asarray(got[2].stego), master_key=mk2,
                         params=p) == secrets


def test_extract_stream_key_rotation(covers):
    """extract_stream accepts (stego, master_key) tuples — the symmetric
    rotation surface to embed_stream's 4th element."""
    from steganosaurus_jax.pipeline import stream as pstream

    p = Params(**FAST)
    mk1, mk2 = bytes(range(32)), bytes(range(2, 34))
    secrets = [b"stream-rot-a", b"stream-rot-b"]
    salts = [bytes([50]) * 16, bytes([51]) * 16]
    r1 = embed_batch(covers[:2], secrets, master_key=mk1, params=p,
                     salts=salts)
    r2 = embed_batch(covers[2:4], secrets, master_key=mk2, params=p,
                     salts=salts)
    got = list(pstream.extract_stream(
        iter([r1.stego, (r2.stego, mk2)]), master_key=mk1, params=p,
        clen_hint=12, depth=2))
    assert got == [secrets, secrets]


def test_batch_soft_write_corner_and_gather_paths(covers):
    """soft_write on the BATCH paths: the corner dense write (shared-walk
    fast path) and the scatter path (adaptive_alpha) both round-trip, and
    the corner path's stego beats the hard write's PSNR on every image at
    equal payload (minimal-energy write, ops/phase.py)."""
    secrets = [bytes([i]) * 30 for i in range(6)]
    salts = [bytes([7 * i + 3]) * 16 for i in range(6)]
    hard = embed_batch(covers, secrets, password="pw", params=Params(**FAST),
                       salts=salts)
    psoft = Params(soft_write=True, **FAST)
    soft = embed_batch(covers, secrets, password="pw", params=psoft,
                       salts=salts)
    assert extract_batch(soft.stego, password="pw", params=psoft) == secrets

    def psnr(a, b):
        mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2,
                      axis=(1, 2, 3))
        return 10 * np.log10(255.0**2 / mse)

    gain = psnr(covers, soft.stego) - psnr(covers, hard.stego)
    assert (gain > 1.0).all(), gain

    # scatter path (adaptive_alpha forces the non-corner batched core)
    pa = Params(soft_write=True, adaptive_alpha=True, **FAST)
    res = embed_batch(covers, secrets, password="pw", params=pa, salts=salts)
    assert extract_batch(res.stego, password="pw", params=pa) == secrets


def test_batch_alpha_spread_corner_paths(covers):
    """alpha_spread on the BATCH corner path: the statics carry per-bin
    amplitude maps (cad/sad) and the dense write uses them in place of the
    scalar cos/sin(alpha). Round-trips on every corner variant (equal-length
    fused, jitter compose) and the stego must agree with the single-image
    scatter pipeline's decode."""
    psp = Params(alpha_spread=0.5, **FAST)
    secrets = [b"spread-batch-%d" % i for i in range(4)]
    salts = [bytes([7 * i + 3]) * 16 for i in range(4)]
    res = embed_batch(covers[:4], secrets, password="pw", params=psp,
                      salts=salts)
    assert extract_batch(res.stego, password="pw", params=psp) == secrets
    # spread-free extractor params also decode (amplitude never read back)
    assert extract_batch(res.stego, password="pw",
                         params=Params(**FAST)) == secrets
    # single-image extractor agrees
    assert extract_array(res.stego[0], password="pw", params=psp) == secrets[0]
    # pixels actually differ from the unspread write
    res0 = embed_batch(covers[:4], secrets, password="pw",
                       params=Params(**FAST), salts=salts)
    assert np.any(np.asarray(res.stego) != np.asarray(res0.stego))

    # jitter + spread: both map pairs live in the statics, order fixed
    pj = Params(alpha_spread=0.4, jitter=0.05, **FAST)
    resj = embed_batch(covers[:4], secrets, password="pw", params=pj,
                       salts=salts)
    assert extract_batch(resj.stego, password="pw", params=pj) == secrets

    # ragged (unequal-length) corner path + soft compose
    prs = Params(alpha_spread=0.4, soft_write=True, **FAST)
    rag = [b"a", b"bb" * 8, b"c" * 30, b"d"]
    resr = embed_batch(covers[:4], rag, password="pw", params=prs,
                       salts=salts)
    assert extract_batch(resr.stego, password="pw", params=prs) == rag


def test_batch_per_image_walk(covers):
    """per_image_walk on the BATCH path: salt-keyed payload walks expanded
    on a thread pool, one fused per-image corner embed module, extraction
    AUTO-DETECTING the mode from header flags (plain default params)."""
    p = Params(per_image_walk=True, **FAST)
    secrets = [b"piw-%d" % i for i in range(4)]
    salts = [bytes([13 * i + 5]) * 16 for i in range(4)]
    res = embed_batch(covers[:4], secrets, password="pw", params=p,
                      salts=salts)
    got = extract_batch(res.stego, password="pw", params=Params(**FAST))
    assert got == secrets
    # single-image extractor agrees (flag-driven there too)
    assert extract_array(res.stego[1], password="pw",
                         params=Params(**FAST)) == secrets[1]

    # ragged + jitter + spread + soft compose; clen_hint path
    pj = Params(per_image_walk=True, jitter=0.05, alpha_spread=0.5,
                soft_write=True, **FAST)
    rag = [b"a" * 40, b"b", b"c" * 17, b"d" * 8]
    resj = embed_batch(covers[:4], rag, password="pw", params=pj,
                       salts=salts)
    assert extract_batch(resj.stego, password="pw", params=pj,
                         clen_hint=40) == rag

    # verify mode (re-salt loop) composes — extraction auto-detects
    resv = embed_batch(covers[:4], secrets, password="pw", params=p,
                       verify=True)
    assert resv.verified == [True] * 4


def test_batch_mixed_shared_and_piw_extract(covers):
    """One extract batch holding BOTH shared-walk and per-image-walk stegos:
    finalize routes each image down its own payload path by header flag."""
    p0, p1 = Params(**FAST), Params(per_image_walk=True, **FAST)
    salts = [bytes([31 * i + 7]) * 16 for i in range(4)]
    r0 = embed_batch(covers[:2], [b"shared-0", b"shared-1"], password="pw",
                     params=p0, salts=salts[:2])
    r1 = embed_batch(covers[2:4], [b"piw-2", b"piw-3"], password="pw",
                     params=p1, salts=salts[2:])
    mixed = np.concatenate([np.asarray(r0.stego), np.asarray(r1.stego)])
    got = extract_batch(mixed, password="pw", params=Params(**FAST))
    assert got == [b"shared-0", b"shared-1", b"piw-2", b"piw-3"]


def test_batch_piw_over_mesh(covers):
    """per_image_walk shards over the batch mesh axis (full-batch flagged)."""
    mesh = pbatch.make_mesh(2)
    p = Params(per_image_walk=True, **FAST)
    secrets = [b"piw-mesh-%d" % i for i in range(4)]
    salts = [bytes([17 * i + 3]) * 16 for i in range(4)]
    res = embed_batch(covers[:4], secrets, password="pw", params=p,
                      salts=salts, mesh=mesh)
    got = extract_batch(np.asarray(res.stego), password="pw",
                        params=Params(**FAST), mesh=mesh)
    assert got == secrets


def test_piw_prefetch_cache_and_stream(covers):
    """prefetch_piw_walks warms the per-image payload-walk cache (the
    per-image-walk mode's dominant host cost); embed_batch POPS the entries
    (single-use — salts rotate). embed_stream draws salts up front and
    prefetches for flagged params; results must be identical."""
    from steganosaurus_jax.pipeline import batch as pbatch_mod
    from steganosaurus_jax.pipeline.stream import embed_stream

    p = Params(per_image_walk=True, **FAST)
    secrets = [b"piw-pf-%d" % i for i in range(4)]
    salts = [bytes([41 * i + 9]) * 16 for i in range(4)]

    pbatch_mod._PIW_CACHE.clear()
    pbatch_mod.prefetch_piw_walks(
        "pw", None, p, 128, 128, salts, [len(s) for s in secrets])
    assert len(pbatch_mod._PIW_CACHE) == 4
    res = embed_batch(covers[:4], secrets, password="pw", params=p,
                      salts=salts)
    assert len(pbatch_mod._PIW_CACHE) == 0  # consumed
    assert extract_batch(res.stego, password="pw",
                         params=Params(**FAST)) == secrets

    # stream: two batches, auto-drawn salts, prefetch path exercised
    batches = [(covers[:3], secrets[:3]), (covers[3:6], secrets[1:])]
    outs = list(embed_stream(iter(batches), password="pw", params=p))
    assert len(outs) == 2
    got0 = extract_batch(np.asarray(outs[0].stego), password="pw",
                         params=Params(**FAST))
    got1 = extract_batch(np.asarray(outs[1].stego), password="pw",
                         params=Params(**FAST))
    assert got0 == secrets[:3] and got1 == secrets[1:]


def test_piw_walk_arrays_strict_vs_tolerant():
    """_piw_walk_arrays strict=True (embed) raises on walk exhaustion;
    strict=False (extraction, where need_lens come from DECODED — possibly
    corrupt — header clens) pads with the last real bin instead, so one
    corrupt-clen image degrades to an AEAD failure rather than aborting
    the whole batch (the reference hang class, doc/TESTING.md:151-156)."""
    from steganosaurus_jax.pipeline.batch import (_HEADER_STREAM_BITS,
                                                  _piw_walk_arrays)
    from steganosaurus_jax.pipeline.errors import StegoError

    salts = [bytes([1]) * 16]
    # 64x64 grid cannot carry ~6k payload bits after the header
    need = [_HEADER_STREAM_BITS + 6000]
    bucket = -(-need[0] // 4096) * 4096
    with pytest.raises(StegoError, match="Message too large"):
        _piw_walk_arrays("pw", None, Params(**FAST), 64, 64, salts, need,
                         bucket, strict=True)
    pl, yy, xx, jj = _piw_walk_arrays("pw", None, Params(**FAST), 64, 64,
                                      salts, need, bucket, strict=False)
    assert pl.shape == (1, bucket) and np.all(yy >= 0) and np.all(yy < 64)


def test_extract_stream_piw(covers):
    """extract_stream handles per-image-walk stegos (the flag-driven payload
    pass lives in the dispatch/finalize seam the stream drives)."""
    from steganosaurus_jax.pipeline.stream import extract_stream

    p = Params(per_image_walk=True, **FAST)
    secrets = [b"s-piw-%d" % i for i in range(3)]
    salts = [bytes([23 * i + 11]) * 16 for i in range(3)]
    res = embed_batch(covers[:3], secrets, password="pw", params=p,
                      salts=salts)
    outs = list(extract_stream(iter([np.asarray(res.stego)] * 2),
                               password="pw", params=Params(**FAST)))
    assert outs == [secrets, secrets]
