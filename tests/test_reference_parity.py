"""Differential tests against the reference C++ binary (the oracle).

Cross-decoding must be bit-exact in BOTH directions (SURVEY.md §4 implication,
BASELINE.md parity bar). The reference is built from /root/reference sources
by the conftest fixture.
"""

import subprocess

import numpy as np
import pytest

from steganosaurus_jax import crypto
from steganosaurus_jax.config import Params
from steganosaurus_jax.crypto import keywrap
from steganosaurus_jax.io import image as image_io
from steganosaurus_jax.pipeline.embed import embed
from steganosaurus_jax.pipeline.extract import extract
from steganosaurus_jax.pipeline.errors import StegoError

ITER = "5000"  # keep PBKDF2 fast in tests; timing tests cover the default


def _run(args, **kw):
    """Run the reference binary, BOUNDED: its extraction loop hangs forever
    on a corrupt header clen (doc/TESTING.md:151-156 — the bug our bounded
    extraction fixes), and an unlucky random salt can trigger that on its
    own stego. A timeout is reported as rc=124 — i.e. the reference FAILED."""
    kw.setdefault("timeout", 180)
    try:
        return subprocess.run([str(a) for a in args], capture_output=True,
                              text=True, **kw)
    except subprocess.TimeoutExpired as e:
        return subprocess.CompletedProcess(
            e.cmd, 124,
            (e.stdout or b"").decode(errors="replace") if isinstance(
                e.stdout, bytes) else (e.stdout or ""),
            "timeout: reference extraction hung (its documented "
            "unbounded-loop bug)")


@pytest.fixture(scope="module")
def host_png(tmp_path_factory, host_image):
    p = tmp_path_factory.mktemp("imgs") / "host.png"
    image_io.save_png(str(p), host_image)
    return p


@pytest.mark.parametrize("dtype", ["complex64", "complex128"])
def test_reference_embed_our_extract(reference_bin, host_png, tmp_path, dtype):
    stego = tmp_path / "stego_ref.png"
    r = _run([reference_bin, "embed", "--in", host_png, "--out", stego,
              "--secret", "Parity secret 123", "--pass", "pp",
              "--pbkdf2_iter", ITER])
    assert r.returncode == 0, r.stderr
    out = extract(str(stego), password="pp",
                  params=Params(pbkdf2_iter=int(ITER), fft_dtype=dtype))
    assert out == b"Parity secret 123"


@pytest.mark.parametrize("dtype", ["complex64", "complex128"])
def test_our_embed_reference_extract(reference_bin, host_png, tmp_path, dtype):
    stego = tmp_path / "stego_ours.png"
    embed(str(host_png), str(stego), "Round trip via JAX frame",
          password="pp", params=Params(pbkdf2_iter=int(ITER), fft_dtype=dtype))
    r = _run([reference_bin, "extract", "--in", stego, "--pass", "pp",
              "--pbkdf2_iter", ITER])
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "Round trip via JAX frame"


def test_cross_decode_with_params_sweep(reference_bin, host_png, host_image,
                                        tmp_path):
    """alpha/density/rmin/rmax/jitter sweeps cross-decode both ways.

    Our embeds use a PINNED salt: at alpha=0.22 the phase margin is thin
    enough that a few percent of random salts draw AEAD bit patterns that
    exceed the ECC budget on this cover — an inherent property of the scheme
    (the reference's own per-salt failure odds; see the inherent
    ~3%-per-key failure note in test_wrapped_key_interop_main_format) — and a
    parity test must be deterministic, not a channel-margin coin flip. All 16 probed salts pass
    today; the pin freezes one so any future failure is a real code change."""
    from steganosaurus_jax.io import image as image_io
    from steganosaurus_jax.pipeline.embed import embed_array

    cases = [
        dict(alpha=0.22, density=0.5, rmin=0.08, rmax=0.40, jitter=0.0),
        dict(alpha=0.50, density=0.9, rmin=0.05, rmax=0.45, jitter=0.05),
    ]
    for i, c in enumerate(cases):
        flags = []
        for k, v in c.items():
            flags += [f"--{k}", str(v)]
        stego = tmp_path / f"sweep_{i}.png"
        r = _run([reference_bin, "embed", "--in", host_png, "--out", stego,
                  "--secret", f"sweep{i}", "--pass", "pp",
                  "--pbkdf2_iter", ITER, *flags])
        assert r.returncode == 0, r.stderr
        p = Params(pbkdf2_iter=int(ITER), **c)
        try:
            got = extract(str(stego), password="pp", params=p)
        except StegoError:
            got = None
        if got != f"sweep{i}".encode():
            # The reference embeds with ITS OWN random salt (no flag to pin
            # it), and at alpha=0.22 a few percent of salts lose to the ECC
            # margin. Parity semantics: we may fail only when the reference
            # also fails to extract its own stego.
            rx = _run([reference_bin, "extract", "--in", stego, "--pass",
                       "pp", "--pbkdf2_iter", ITER, *flags])
            assert rx.returncode != 0 or f"sweep{i}" not in rx.stdout, (
                f"our extract failed but the reference succeeded: {got!r}")

        stego2 = tmp_path / f"sweep_ours_{i}.png"
        res = embed_array(host_image, f"ours{i}".encode(), password="pp",
                          params=p, salt=bytes(16))
        image_io.save_png(str(stego2), res.stego)
        r = _run([reference_bin, "extract", "--in", stego2, "--pass", "pp",
                  "--pbkdf2_iter", ITER, *flags])
        assert r.returncode == 0, r.stderr
        assert r.stdout.strip() == f"ours{i}"


def test_512px_batch_cross_decode(reference_bin, tmp_path):
    """The bench headline size: a 512x512 stego produced by the BATCH device
    pipeline must extract bit-exactly with the reference binary, and a
    reference-embedded 512x512 stego must decode via extract_batch."""
    from steganosaurus_jax.pipeline.batch import embed_batch, extract_batch

    rng = np.random.default_rng(9)
    base = np.linspace(150, 235, 512)
    cover = np.clip(base[None, :, None] + rng.integers(-18, 19, (512, 512, 3)),
                    0, 255).astype(np.uint8)
    mk = crypto.get_random_bytes(32)
    key_b64 = crypto.base64_encode(mk)

    res = embed_batch(cover[None], [b"batch 512 parity"], master_key=mk)
    stego = tmp_path / "b512.png"
    image_io.save_png(str(stego), res.stego[0])
    r = _run([reference_bin, "extract", "--in", stego, "--key", key_b64])
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "batch 512 parity"

    cp = tmp_path / "c512.png"
    sp = tmp_path / "r512.png"
    image_io.save_png(str(cp), cover)
    r = _run([reference_bin, "embed", "--in", cp, "--out", sp,
              "--secret", "ref to batch", "--key", key_b64])
    assert r.returncode == 0, r.stderr
    got = extract_batch(image_io.load_rgb(str(sp))[None], master_key=mk)
    assert got == [b"ref to batch"]


def test_raw_key_cross_decode(reference_bin, host_png, tmp_path):
    mk = crypto.get_random_bytes(32)
    key_b64 = crypto.base64_encode(mk)
    stego = tmp_path / "keyed.png"
    r = _run([reference_bin, "embed", "--in", host_png, "--out", stego,
              "--secret", "keyed!", "--key", key_b64, "--pbkdf2_iter", ITER])
    assert r.returncode == 0, r.stderr
    assert extract(str(stego), master_key=mk,
                   params=Params(pbkdf2_iter=int(ITER))) == b"keyed!"

    stego2 = tmp_path / "keyed2.png"
    embed(str(host_png), str(stego2), "keyed back", master_key=mk,
          params=Params(pbkdf2_iter=int(ITER)))
    r = _run([reference_bin, "extract", "--in", stego2, "--key", key_b64,
              "--pbkdf2_iter", ITER])
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "keyed back"


def test_wrong_password_matches_reference_behavior(reference_bin, host_png, tmp_path):
    stego = tmp_path / "wp.png"
    r = _run([reference_bin, "embed", "--in", host_png, "--out", stego,
              "--secret", "s", "--pass", "right", "--pbkdf2_iter", ITER])
    assert r.returncode == 0
    rr = _run([reference_bin, "extract", "--in", stego, "--pass", "wrong",
               "--pbkdf2_iter", ITER])
    assert rr.returncode != 0 and "Magic not found" in rr.stderr
    with pytest.raises(StegoError, match="Magic not found"):
        extract(str(stego), password="wrong", params=Params(pbkdf2_iter=int(ITER)))


def test_wrapped_key_interop_main_format(reference_bin, host_png, tmp_path):
    """gen-key --wrap-pass (80B format) unwraps on both sides."""
    keyfile = tmp_path / "wrapped.key"
    r = _run([reference_bin, "gen-key", "--key-out", keyfile,
              "--wrap-pass", "wp", "--pbkdf2_iter", ITER])
    assert r.returncode == 0, r.stderr
    key_b64 = keyfile.read_text().strip()
    mk = keywrap.decode_or_unwrap_key(key_b64, "wp", int(ITER))
    assert mk is not None and len(mk) == 32
    # reference prints "Base64: <key>" — ours must match its unwrap
    for line in r.stdout.splitlines():
        if "Base64:" in line:
            assert crypto.base64_decode(line.split()[-1]) == mk

    # our wrap -> reference --key
    blob = keywrap.wrap_key_main(mk, "wp2", int(ITER))
    stego = tmp_path / "wk.png"
    rr = _run([reference_bin, "embed", "--in", host_png, "--out", stego,
               "--secret", "wrapped roundtrip", "--key",
               crypto.base64_encode(blob), "--wrap-pass", "wp2",
               "--pbkdf2_iter", ITER])
    assert rr.returncode == 0, rr.stderr
    try:
        got = extract(str(stego), master_key=mk,
                      params=Params(pbkdf2_iter=int(ITER)))
        assert got == b"wrapped roundtrip"
    except StegoError:
        # The reference has an inherent ~3%-per-key failure rate on this
        # cover class (mag_ok intentionally disabled, steganosaur.cpp:797-799
        # -> the walk can land on near-zero-magnitude bins whose phases lose
        # to u8 quantization noise beyond the ECC budget). Parity means we
        # fail exactly when IT fails — verified: the reference cannot extract
        # its own stego for such keys (both our f32 and f64 backends agree).
        rx = _run([reference_bin, "extract", "--in", stego, "--key",
                   crypto.base64_encode(mk), "--pbkdf2_iter", ITER])
        assert rx.returncode != 0 or "wrapped roundtrip" not in rx.stdout, (
            "our extract failed but the reference succeeded — real parity bug"
        )


def test_wrapped_key_interop_tool_format(reference_keytool, tmp_path):
    """turtlefft-key 81B versioned format unwraps on both sides."""
    keyfile = tmp_path / "tool.key"
    r = _run([reference_keytool, "--gen-key", "--key-out", keyfile, "--wrap", "tp"])
    assert r.returncode == 0, r.stderr
    blob = keyfile.read_bytes()
    assert len(blob) == 81
    mk = keywrap.unwrap_key_tool(blob, "tp")
    assert mk is not None
    ref_hex = _run([reference_keytool, "--export-hex", keyfile, "--pass", "tp"])
    assert ref_hex.stdout.strip() == mk.hex()

    # our wrap -> reference tool unwrap
    blob2 = keywrap.wrap_key_tool(mk, "tp2")
    keyfile2 = tmp_path / "tool2.key"
    keyfile2.write_bytes(blob2)
    r2 = _run([reference_keytool, "--export-hex", keyfile2, "--pass", "tp2"])
    assert r2.returncode == 0, r2.stderr
    assert r2.stdout.strip() == mk.hex()


def test_stego_images_pixel_identical_f64(reference_bin, host_png, tmp_path):
    """With identical salt the f64 backend should match the reference's
    pixels EXACTLY. Salt is random in both, so instead compare our f64 and
    the reference decoding each other's images at zero ECC corrections —
    approximated here by asserting pixel-level PSNR of the two stegos vs
    cover are statistically indistinguishable."""
    stego_ref = tmp_path / "a.png"
    _run([reference_bin, "embed", "--in", host_png, "--out", stego_ref,
          "--secret", "pixcheck", "--pass", "pp", "--pbkdf2_iter", ITER])
    stego_ours = tmp_path / "b.png"
    embed(str(host_png), str(stego_ours), "pixcheck", password="pp",
          params=Params(pbkdf2_iter=int(ITER), fft_dtype="complex128"))
    cover = image_io.load_rgb(str(host_png)).astype(np.float64)
    d_ref = np.mean((image_io.load_rgb(str(stego_ref)) - cover) ** 2)
    d_ours = np.mean((image_io.load_rgb(str(stego_ours)) - cover) ** 2)
    assert abs(d_ref - d_ours) / max(d_ref, 1e-9) < 0.25, (d_ref, d_ours)


@pytest.mark.parametrize("mode_flags,params_kw", [
    (["--adaptive_alpha", "1"], dict(adaptive_alpha=True)),      # BASELINE cfg 4
    (["--cover_dependent_path", "1"], dict(cover_dependent_path=True)),  # cfg 5
    # cfg 5's density/rmin/rmax sweep combined with the cover-dependent walk
    (["--cover_dependent_path", "1", "--density", "0.5", "--rmin", "0.08",
      "--rmax", "0.40"],
     dict(cover_dependent_path=True, density=0.5, rmin=0.08, rmax=0.40)),
    (["--center", "1"], dict(center=True)),
], ids=["adaptive_alpha", "cover_dependent_path", "cdp_sweep", "center"])
def test_experimental_modes_oracle_parity(reference_bin, host_png, tmp_path,
                                          mode_flags, params_kw):
    """BASELINE configs 4/5 (+ --center) against the live oracle, per-case:
    whatever the reference binary does — round-trip or fail — we must do the
    same, in both cross-decode directions. adaptive_alpha and
    cover_dependent_path are known-fragile in the reference
    (steganosaur.cpp:704-710, :1156-1176; doc/HARDENING.md:325-381), so the
    assertion is BEHAVIORAL parity, not unconditional success. The rebuild's
    soft-decision fallback is pinned OFF here: it recovers margin-failure
    stegos the reference binary cannot (tests/test_soft_decode.py), which is
    strictly-better behavior, not parity — with it on, this test flakes
    whenever the reference's own fragile mode fails on a random salt draw
    that the soft decoder still rescues."""
    p = Params(pbkdf2_iter=int(ITER), soft_decode_fallback=False, **params_kw)
    msg = "exp mode parity"

    # reference embed -> {reference, ours} extract must agree
    stego_ref = tmp_path / "exp_ref.png"
    r = _run([reference_bin, "embed", "--in", host_png, "--out", stego_ref,
              "--secret", msg, "--pass", "xp", "--pbkdf2_iter", ITER,
              *mode_flags])
    assert r.returncode == 0, r.stderr
    rx = _run([reference_bin, "extract", "--in", stego_ref, "--pass", "xp",
               "--pbkdf2_iter", ITER, *mode_flags])
    ref_self = rx.stdout.strip() if rx.returncode == 0 else None
    try:
        ours = extract(str(stego_ref), password="xp", params=p).decode()
    except StegoError:
        ours = None
    assert ours == ref_self, (
        f"oracle divergence on ref-embedded stego: ref={ref_self!r} "
        f"ours={ours!r}")
    if ref_self is not None:
        assert ref_self == msg

    # our embed -> {ours, reference} extract must agree
    stego_ours = tmp_path / "exp_ours.png"
    embed(str(host_png), str(stego_ours), msg, password="xp", params=p)
    try:
        self_dec = extract(str(stego_ours), password="xp", params=p).decode()
    except StegoError:
        self_dec = None
    rx2 = _run([reference_bin, "extract", "--in", stego_ours, "--pass", "xp",
                "--pbkdf2_iter", ITER, *mode_flags])
    ref_dec = rx2.stdout.strip() if rx2.returncode == 0 else None
    assert ref_dec == self_dec, (
        f"oracle divergence on our stego: ref={ref_dec!r} ours={self_dec!r}")


def test_soft_write_reference_extract(reference_bin, host_png, tmp_path):
    """The minimal-energy soft write (params.soft_write, rebuild-only)
    changes WHICH phase value is written but not the decode rule — the
    reference's read_bit_from_bin (steganosaur.cpp:734-746) compares
    circular distances to +-alpha, which reduces to the same half-plane
    test, so the reference binary must extract a soft-written image
    bit-exactly (every soft bin keeps decision margin >= alpha)."""
    stego = tmp_path / "stego_soft.png"
    embed(str(host_png), str(stego), "Soft write, reference decode",
          password="pp",
          params=Params(pbkdf2_iter=int(ITER), soft_write=True))
    r = _run([reference_bin, "extract", "--in", stego, "--pass", "pp",
              "--pbkdf2_iter", ITER])
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "Soft write, reference decode"


def test_alpha_spread_reference_extract(reference_bin, host_png, tmp_path):
    """Randomized write amplitude (params.alpha_spread, rebuild-only,
    pipeline/spread.py) varies WHICH amplitude is written per bin but every
    alpha_i keeps sin(alpha_i) > 0, so the reference's circular-distance
    read (steganosaur.cpp:734-746 — the same half-plane test) must extract
    the image bit-exactly with stock default flags and no knowledge of the
    spread."""
    stego = tmp_path / "stego_spread.png"
    embed(str(host_png), str(stego), "Spread amplitude, reference decode",
          password="pp",
          params=Params(pbkdf2_iter=int(ITER), alpha_spread=0.5))
    r = _run([reference_bin, "extract", "--in", stego, "--pass", "pp",
              "--pbkdf2_iter", ITER])
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "Spread amplitude, reference decode"


def test_per_image_walk_reference_fails_closed(reference_bin, host_png,
                                               tmp_path):
    """per_image_walk stegos carry header FLAGS bit 0x01. The reference
    ignores FLAGS (steganosaur.cpp:884,897): it parses the header fine,
    then reads the payload along the SHARED walk — which this mode does not
    use — so it must fail AEAD auth ("Auth failed"), never crash or
    mis-extract."""
    stego = tmp_path / "stego_piw.png"
    embed(str(host_png), str(stego), "per-image walk payload",
          password="pp",
          params=Params(pbkdf2_iter=int(ITER), per_image_walk=True))
    r = _run([reference_bin, "extract", "--in", stego, "--pass", "pp",
              "--pbkdf2_iter", ITER])
    assert r.returncode != 0
    assert "Auth failed" in (r.stderr + r.stdout)


def test_qim_reference_fails_closed(reference_bin, host_png, tmp_path):
    """QIM stegos carry the level in header FLAGS bits 4-7
    (pipeline/qim.py). The reference ignores FLAGS (steganosaur.cpp:
    884,897): it parses the header fine, then reads the QIM-quantized
    payload with its half-plane rule — garbage bits — so it must fail
    AEAD auth ("Auth failed"), never crash or mis-extract."""
    stego = tmp_path / "stego_qim.png"
    embed(str(host_png), str(stego), "qim payload",
          password="pp",
          params=Params(pbkdf2_iter=int(ITER), qim=3))
    r = _run([reference_bin, "extract", "--in", stego, "--pass", "pp",
              "--pbkdf2_iter", ITER])
    assert r.returncode != 0
    assert "Auth failed" in (r.stderr + r.stdout)
