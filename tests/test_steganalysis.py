"""Phase-histogram warden statistics (utils.steganalysis; doc/ATTACKS.md
§2/§2a): the hard write's +-alpha spike must be measurable from the stego
alone, and the alpha_spread mitigation must measurably dilute it."""

import numpy as np
import pytest

from steganosaurus_jax.config import Params
from steganosaurus_jax.pipeline.embed import embed_array
from steganosaurus_jax.utils.steganalysis import phase_histogram_report

FAST = dict(pbkdf2_iter=500)


@pytest.fixture(scope="module")
def cover():
    rng = np.random.default_rng(99)
    base = np.linspace(170, 220, 256)
    img = base[None, :, None] + rng.integers(-12, 13, (256, 256, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


def test_spike_detection_and_spread_dilution(cover):
    salt = bytes(range(16))
    secret = bytes(range(200))  # heavy payload: clear footprint at 256^2

    clean = phase_histogram_report(cover)
    hard = phase_histogram_report(
        embed_array(cover, secret, password="pw", params=Params(**FAST),
                    salt=salt).stego)
    spread = phase_histogram_report(
        embed_array(cover, secret, password="pw",
                    params=Params(alpha_spread=1.0, **FAST),
                    salt=salt).stego)

    # the clean cover reads near-uniform; the hard write does not
    assert abs(clean["spike_excess"]) < hard["spike_excess"] / 5
    assert hard["spike_excess"] > 0.003  # the §2 delta-spike feature
    assert hard["chi2_z"] > clean["chi2_z"] + 3.0

    # spread kills the narrow spike (the peak-detector feature)...
    assert spread["spike_excess"] < hard["spike_excess"] / 3
    # ...while honestly leaving band mass (ATTACKS §2a: mitigation, not
    # invisibility): the band statistic still sees the footprint
    assert spread["band_excess"] > 0.003


def test_pairwise_harmonic_attack_and_piw_defense(cover):
    """Second-order warden (ATTACKS §4a): the cross-image phase-difference
    harmonic statistic detects shared-walk embeds (hard AND QIM — where
    harmonic 2L fingers the level), and per-image walks defeat it."""
    from steganosaurus_jax.utils.steganalysis import (
        pairwise_difference_report)

    rng = np.random.default_rng(7)
    base = np.linspace(170, 220, 256)
    cover2 = np.clip(base[None, :, None] + rng.integers(-12, 13,
                                                        (256, 256, 3)),
                     0, 255).astype(np.uint8)
    secret = bytes(range(200))
    s1, s2 = bytes([1]) * 16, bytes([2]) * 16

    null = pairwise_difference_report(cover, cover2)
    assert null["max_z"] < 5.0  # clean pair ~Rayleigh null

    p = Params(qim=3, **FAST)
    a = embed_array(cover, secret, password="pw", params=p, salt=s1).stego
    b = embed_array(cover2, secret, password="pw", params=p, salt=s2).stego
    r = pairwise_difference_report(a, b, p)
    # harmonic 2L carries the shared-walk QIM lattice alignment
    assert r["argmax_m"] == 6 and r["max_z"] > 20.0

    ps = Params.stealth(**FAST)  # per_image_walk: disjoint payload bins
    a = embed_array(cover, secret, password="pw", params=ps, salt=s1).stego
    b = embed_array(cover2, secret, password="pw", params=ps, salt=s2).stego
    r2 = pairwise_difference_report(a, b, ps)
    assert r2["max_z"] < r["max_z"] / 10
    assert r2["harmonics"][5] < 3.0  # the 2L fingerprint is gone


def test_magnitude_conditioned_report(cover):
    """Magnitude-stratified warden (doc/TODO.md honesty item): the hard
    write's signature lands in EVERY magnitude band (the walk is
    magnitude-blind, reference mag_ok disabled :797-799), conditioning adds
    no power over the marginal test, and the stealth profile stays at the
    clean cover's noise floor even when stratified."""
    from steganosaurus_jax.utils.steganalysis import (
        magnitude_conditioned_report)

    secret = bytes(range(200))
    salt = bytes(range(16))

    clean = magnitude_conditioned_report(cover)
    assert clean["max_chi2_z"] < 4.0

    hard = magnitude_conditioned_report(
        embed_array(cover, secret, password="pw", params=Params(**FAST),
                    salt=salt).stego)
    zs = [b["chi2_z"] for b in hard["bands"] if b["chi2_z"] is not None]
    assert min(zs) > 20.0          # signature present in every band...
    assert hard["max_chi2_z"] < hard["chi2_z_marginal"]  # ...but diluted:
    # conditioning splits the population without concentrating the signal

    ps = Params.stealth(**FAST)
    stealth = magnitude_conditioned_report(
        embed_array(cover, secret, password="pw", params=ps,
                    salt=salt).stego, ps)
    assert stealth["max_chi2_z"] < clean["max_chi2_z"] + 3.0


def test_requantization_noise_report(cover):
    """Channel-noise analyzer (utils.channel): phase noise must scale
    ~1/magnitude, raw flip rates must sit far under the ECC budget at
    defaults, and QIM-10's tighter margin must show a higher (but still
    ECC-absorbable) payload flip rate."""
    from steganosaurus_jax.utils.channel import requantization_noise_report

    secret = bytes(range(200))
    mk = bytes(range(32))

    hard = requantization_noise_report(cover, secret, master_key=mk,
                                       params=Params(**FAST))
    # noise is 1/mag: lowest-magnitude band at least 3x noisier than highest
    stds = [b["std_rad"] for b in hard["by_magnitude"]
            if b["std_rad"] is not None]
    assert stds[0] > 3.0 * stds[-1]
    # defaults: raw BER far below the Rep-7 43% budget
    assert hard["raw_flip_rate_payload"] < 0.05
    assert hard["raw_flip_rate_header"] < 0.05
    assert hard["margin_payload_rad"] == pytest.approx(0.5)

    q = requantization_noise_report(cover, secret, master_key=mk,
                                    params=Params(qim=10, **FAST))
    assert q["margin_payload_rad"] == pytest.approx(np.pi / 20)
    # tighter margin -> more raw flips than the hard write, still small
    assert q["raw_flip_rate_payload"] < 0.2
    # write energy: QIM-10's payload lattice rms (~Delta/sqrt(12) ~ 0.18)
    # is far below the hard write's uniform-to-fixed-point ~pi/sqrt(3) ~
    # 1.8 (the MIXED rms includes the always-hard header, which dominates
    # at this small image — hence the payload-only field)
    assert q["write_rms_payload_rad"] < hard["write_rms_payload_rad"] / 5
    assert hard["write_rms_rad"] == pytest.approx(np.pi / np.sqrt(3),
                                                  rel=0.05)
    # the hard write's noise carries the clamping/large-perturbation
    # excess over the constant rounding floor (doc/ATTACKS.md 2c)
    assert q["noise_std_rad"] < hard["noise_std_rad"]


def test_collusion_report_attack_and_piw_defense(cover):
    """N-image collusion warden (the reference doc/TODO.md "collusion
    test (mean FFT across multiple images)"): averaging phase coherence
    across a collection of DIFFERENT covers under one key detects
    shared-walk embeds — hard write at low harmonics, QIM at 2L — and
    per-image walks crush the statistic toward the header-only floor."""
    from steganosaurus_jax.utils.steganalysis import collusion_report

    rng = np.random.default_rng(11)
    base = np.linspace(170, 220, 256)
    covers = [np.clip(base[None, :, None]
                      + rng.integers(-12, 13, (256, 256, 3)),
                      0, 255).astype(np.uint8) for _ in range(6)]
    secret = bytes(range(200))
    salts = [bytes([i]) * 16 for i in range(6)]

    null = collusion_report(covers)
    assert null["max_z"] < 5.0  # independent clean covers

    p = Params(**FAST)  # hard write, shared walk
    stegos = [embed_array(c, secret, password="pw", params=p, salt=s).stego
              for c, s in zip(covers, salts)]
    hard = collusion_report(stegos, p)
    # coherence at written bins ~ cos^2(m*alpha): strong at m=1 and at
    # every m*alpha near a multiple of pi (m=6*0.5=3.0 rad ~ pi peaks)
    assert hard["max_z"] > 20.0 and hard["harmonics"][0] > 20.0

    pq = Params(qim=3, **FAST)  # shared walk, shared dither: lattice at 2L
    stegos_q = [embed_array(c, secret, password="pw", params=pq,
                            salt=s).stego
                for c, s in zip(covers, salts)]
    qim = collusion_report(stegos_q, pq)
    assert qim["harmonics"][5] > 20.0  # m = 2L = 6 fingers the level

    ps = Params.stealth(**FAST)  # per-image payload walks
    stegos_p = [embed_array(c, secret, password="pw", params=ps,
                            salt=s).stego
                for c, s in zip(covers, salts)]
    piw = collusion_report(stegos_p, ps)
    assert piw["max_z"] < hard["max_z"] / 10
    assert piw["harmonics"][5] < qim["harmonics"][5] / 10


def test_robustness_report_awgn_and_jpeg(cover):
    """Channel robustness curve (utils.channel.robustness_report — the
    reference doc/TODO.md "BER vs AWGN/JPEG robustness tests" item): raw
    BER grows monotonically-ish with sigma, tiny AWGN survives the Rep-7
    majority, heavy AWGN kills recovery, and JPEG recompression destroys
    the global-FFT phase channel at any tested quality (the honest
    lossless-PNG-only answer, stated with a measurement)."""
    from steganosaurus_jax.utils.channel import robustness_report

    mk = bytes(range(32))
    rep = robustness_report(cover, bytes(range(64)), Params(),
                            master_key=mk,
                            noise_sigmas=(0.25, 8.0),
                            jpeg_qualities=(95,))
    lo, hi = rep["awgn"]
    assert lo["raw_ber_payload"] < hi["raw_ber_payload"]
    assert lo["recovered"] and lo["recovered_soft"]
    assert not hi["recovered"]
    assert rep["jpeg"] and not rep["jpeg"][0]["recovered_soft"]


def test_robustness_report_stealth_params(cover):
    """robustness_report must work for the recommended stealth profile
    (per-image walks): the recovery booleans are measured, raw BER is
    None (channel_report supports the shared-walk corner path only)."""
    from steganosaurus_jax.utils.channel import robustness_report

    rep = robustness_report(cover, b"stealth-robust",
                            Params.stealth(**FAST),
                            master_key=bytes(range(32)),
                            noise_sigmas=(0.25,), jpeg_qualities=())
    a = rep["awgn"][0]
    assert a["raw_ber_payload"] is None
    assert a["recovered_soft"] in (True, False)
    assert rep["jpeg"] == []


# --- SRM-lite learned warden (utils.steganalysis.srm_*) ---------------------


def test_srm_features_shape_and_determinism():
    from steganosaurus_jax.utils import steganalysis as sa

    covers = sa.srm_corpus(2, hw=(128, 128), seed=3)
    f1 = sa.srm_features(covers[0])
    f2 = sa.srm_features(covers[0])
    assert f1.shape == (490,)
    np.testing.assert_array_equal(f1, f2)
    # normalized histograms: each co-occurrence block sums to ~1
    assert np.all(f1 >= 0) and abs(f1.sum() - 10.0) < 1e-6


def test_srm_report_blind_on_identical_and_detects_noise():
    """Power calibration: identical pairs are exactly chance; +-1-per-pixel
    iid noise (louder than any embed here) must be detected on a
    same-source corpus."""
    from steganosaurus_jax.utils import steganalysis as sa

    n = 32
    covers = sa.srm_corpus(n, hw=(128, 128), seed=5, kind="gradient")
    rep0 = sa.srm_report(covers, covers)
    assert abs(rep0["auc"] - 0.5) < 1e-9 and rep0["accuracy"] == 0.5
    rng = np.random.default_rng(0)
    noisy = np.clip(covers.astype(np.int16)
                    + rng.integers(-1, 2, covers.shape), 0,
                    255).astype(np.uint8)
    rep1 = sa.srm_report(covers, noisy)
    assert rep1["auc"] > 0.75, rep1


def test_srm_detects_hard_write_and_corpus_kinds():
    """The default hard write at heavy payload is spatially LOUD (measured
    AUC 1.0 at 240 B / 256^2 in doc/ATTACKS.md 2d); assert a safely weaker
    bound on the smaller/faster test configuration."""
    from steganosaurus_jax.config import Params
    from steganosaurus_jax.pipeline.batch import embed_batch
    from steganosaurus_jax.utils import steganalysis as sa

    n = 16
    covers = sa.srm_corpus(n, hw=(128, 128), seed=9, kind="gradient")
    rng = np.random.default_rng(1)
    secrets = [bytes(rng.integers(0, 256, 60, dtype=np.uint8))
               for _ in range(n)]
    salts = [bytes(rng.integers(0, 256, 16, dtype=np.uint8))
             for _ in range(n)]
    res = embed_batch(covers, secrets, master_key=bytes(range(32)),
                      params=Params(), salts=salts)
    rep = sa.srm_report(covers, np.asarray(res.stego))
    assert rep["auc"] > 0.8, rep
    with pytest.raises(ValueError):
        sa.srm_corpus(2, kind="nope")


def test_srm_photo_corpus_crops():
    """The natural-photo family (JPEG-decoded grace_hopper crops): shape/
    dtype contract, seed determinism, crops differ, and oversize crops are
    rejected with a clear error."""
    from steganosaurus_jax.utils import steganalysis as sa

    a = sa.srm_corpus(6, hw=(128, 128), seed=3, kind="photo")
    b = sa.srm_corpus(6, hw=(128, 128), seed=3, kind="photo")
    assert a.shape == (6, 128, 128, 3) and a.dtype == np.uint8
    assert np.array_equal(a, b)
    assert any(not np.array_equal(a[0], a[i]) for i in range(1, 6))
    with pytest.raises(ValueError):
        sa.srm_corpus(2, hw=(1024, 1024), kind="photo")


# --- Cross-channel warden (utils.steganalysis.cross_channel_*) --------------


@pytest.fixture(scope="module")
def correlated_cover():
    """Photo-like cover: one shared smooth field + small per-channel noise
    — the cover class whose cross-plane phase alignment the cross-channel
    warden exploits (doc/ATTACKS.md §2e)."""
    rng = np.random.default_rng(4)
    H = W = 256
    base = np.cumsum(np.cumsum(rng.normal(0, 1, (H + 8, W + 8)), 0), 1)
    base = (base - base.min()) / (base.max() - base.min()) * 140 + 50
    base = base[4:H + 4, 4:W + 4]
    img = np.stack([base + rng.normal(0, 3, (H, W)) for _ in range(3)], -1)
    return img.clip(0, 255).astype(np.uint8)


def test_cross_channel_alignment_physics(correlated_cover):
    """Correlated covers show strong cross-plane phase alignment; iid-noise
    covers show none — the precondition that decides which cover classes
    this warden can attack at all."""
    from steganosaurus_jax.utils import steganalysis as sa

    r = sa.cross_channel_report(correlated_cover)
    assert min(r["align_z"].values()) > 6, r["align_z"]
    rng = np.random.default_rng(0)
    noise = rng.integers(0, 256, (256, 256, 3), dtype=np.uint8)
    rn = sa.cross_channel_report(noise)
    assert max(rn["align_z"].values()) < 4, rn["align_z"]


def test_cross_channel_detects_write_even_under_stealth(correlated_cover):
    """The paired diagnostic: a write re-rolls one plane's phase per bin,
    inflating the conditional misalignment rate. Unlike the histogram
    wardens, the stealth profile does NOT flatten this on correlated
    covers (QIM still randomizes the written phase)."""
    from steganosaurus_jax.utils import steganalysis as sa

    rng = np.random.default_rng(8)
    secret = bytes(rng.integers(0, 256, 120, dtype=np.uint8))
    res = embed_array(correlated_cover, secret, master_key=bytes(range(32)),
                      params=Params())
    r = sa.cross_channel_report(np.asarray(res.stego),
                                cover=correlated_cover)
    assert r["max_z"] > 3, r
    assert len(r["cond_off_z"]) == 3 and len(r["n_aligned"]) == 3


def test_cross_channel_corpus_blind_on_iid_channels():
    """The keyless corpus protocol on the gradient family (iid per-channel
    noise): the stealth profile leaves nothing for the cross-channel
    features to key on — AUC must sit near chance. The same protocol on
    the photo family measures AUC 1.0 (doc/ATTACKS.md §2e); that heavy
    run is documented, not asserted here."""
    from steganosaurus_jax.pipeline.batch import embed_batch
    from steganosaurus_jax.utils import steganalysis as sa

    n = 16
    p = Params().stealth()
    covers = sa.srm_corpus(n, hw=(128, 128), seed=11, kind="gradient")
    rng = np.random.default_rng(2)
    secrets = [bytes(rng.integers(0, 256, 40, dtype=np.uint8))
               for _ in range(n)]
    salts = [bytes(rng.integers(0, 256, 16, dtype=np.uint8))
             for _ in range(n)]
    res = embed_batch(covers, secrets, master_key=bytes(range(32)),
                      params=p, salts=salts)
    stegos = np.asarray(res.stego)
    X0 = np.stack([sa.cross_channel_features(c, p) for c in covers])
    X1 = np.stack([sa.cross_channel_features(s, p) for s in stegos])
    rep = sa._paired_eval(X0, X1)
    assert rep["auc"] < 0.75, rep
    assert rep["feature_dim"] == 6


def test_cross_channel_features_are_plain_resultants():
    """Feature dims 0-2 must be the size-normalized pairwise alignment
    resultants (align_z / sqrt(n_bins), in [0, 1]) — independent of the
    conditioning populations that scale dims 3-5."""
    import math

    from steganosaurus_jax.utils.steganalysis import (
        cross_channel_features, cross_channel_report)

    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (96, 96, 3), dtype=np.uint8)
    r = cross_channel_report(img)
    f = cross_channel_features(img)
    want = np.array(list(r["align_z"].values())) / math.sqrt(r["n_bins"])
    assert np.allclose(f[:3], want)
    assert np.all((f[:3] >= 0.0) & (f[:3] <= 1.0))
    assert np.allclose(f[3:], r["cond_off_rate"])


def test_report_phase_precompute_hooks_match():
    """phases=/cover_phases= precompute kwargs must reproduce the
    from-image results exactly (the do_check single-FFT path)."""
    from steganosaurus_jax.utils.steganalysis import (
        annulus_phases, cross_channel_report, phase_histogram_report)

    rng = np.random.default_rng(4)
    a = rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)
    b = rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)
    pa, pb = annulus_phases(a), annulus_phases(b)
    assert phase_histogram_report(a, phases=pa) == phase_histogram_report(a)
    assert cross_channel_report(a, cover=b, phases=pa, cover_phases=pb) \
        == cross_channel_report(a, cover=b)


# --- Joint phase-magnitude residual warden (joint_residual_*) ---------------


@pytest.fixture(scope="module")
def photo_cover():
    """A natural-photograph crop (256²) — the cover class whose local
    spectral phase coherence the joint warden's cover model exploits
    (doc/ATTACKS.md §2f)."""
    from steganosaurus_jax.utils import steganalysis as sa

    return sa.srm_corpus(1, hw=(256, 256), seed=7, kind="photo")[0]


def test_joint_residual_coherence_physics(photo_cover):
    """The cover model's precondition: natural photos couple phase
    coherence to magnitude (high-magnitude annulus bins sit on locally
    linear phase ramps); synthetic iid-phase covers have no coherence at
    any magnitude — the families the warden is blind to by construction."""
    from steganosaurus_jax.utils import steganalysis as sa

    rp = sa.joint_residual_report(photo_cover)
    assert rp["top_coherence"] > 0.12, rp["top_coherence"]
    # coherence RISES with magnitude: top band beats the bottom band
    top = max(rp["bands"][-1]["coherence"])
    bot = max(rp["bands"][0]["coherence"])
    assert top > bot + 0.05, (bot, top)
    for kind in ("gradient", "texture"):
        c = sa.srm_corpus(1, hw=(256, 256), seed=7, kind=kind)[0]
        r = sa.joint_residual_report(c)
        assert r["top_coherence"] < 0.10, (kind, r["top_coherence"])


def test_joint_residual_detects_write_even_under_stealth(photo_cover):
    """The paired diagnostic: every write mode re-rolls written-bin
    phases while preserving magnitudes — exactly the signature the cover
    model keys on. On a coherent cover the per-band coherence drop is
    significant even under the full stealth profile (QIM randomizes the
    phase too; there is no embedding knob against this warden)."""
    from steganosaurus_jax.utils import steganalysis as sa

    rng = np.random.default_rng(9)
    secret = bytes(rng.integers(0, 256, 240, dtype=np.uint8))
    for p in (Params(), Params.stealth()):
        res = embed_array(photo_cover, secret, master_key=bytes(range(32)),
                          params=p)
        r = sa.joint_residual_report(np.asarray(res.stego),
                                     cover=photo_cover)
        assert r["max_z"] > 3, (p.qim, r["max_z"])


def test_joint_residual_corpus_blind_on_iid_phase_covers():
    """The keyless corpus protocol on the gradient family (annulus content
    is iid pixel noise -> iid bin phases): no coherence to break, so the
    stealth profile must sit near chance. The same protocol on the photo
    family measures AUC ~1.0 (doc/ATTACKS.md §2f); that heavy run is
    documented, not asserted here."""
    from steganosaurus_jax.pipeline.batch import embed_batch
    from steganosaurus_jax.utils import steganalysis as sa

    n = 16
    p = Params().stealth()
    covers = sa.srm_corpus(n, hw=(128, 128), seed=11, kind="gradient")
    rng = np.random.default_rng(2)
    secrets = [bytes(rng.integers(0, 256, 40, dtype=np.uint8))
               for _ in range(n)]
    salts = [bytes(rng.integers(0, 256, 16, dtype=np.uint8))
             for _ in range(n)]
    res = embed_batch(covers, secrets, master_key=bytes(range(32)),
                      params=p, salts=salts)
    stegos = np.asarray(res.stego)
    X0 = np.stack([sa.joint_residual_features(c, p) for c in covers])
    X1 = np.stack([sa.joint_residual_features(s, p) for s in stegos])
    rep = sa._paired_eval(X0, X1)
    assert rep["auc"] < 0.75, rep
    assert rep["feature_dim"] == 16


def test_joint_residual_features_match_report_bands():
    """Feature vector layout contract: axis-major per-band mean-cos
    coherences, equal to the report's band values; deterministic."""
    from steganosaurus_jax.utils import steganalysis as sa

    rng = np.random.default_rng(5)
    img = rng.integers(0, 256, (96, 96, 3), dtype=np.uint8)
    f = sa.joint_residual_features(img)
    g = sa.joint_residual_features(img)
    assert f.shape == (16,) and np.array_equal(f, g)
    r = sa.joint_residual_report(img)
    for ax in range(2):
        for b in range(8):
            assert np.isclose(f[ax * 8 + b], r["bands"][b]["coherence"][ax])
