"""Batch CLI modes (rebuild-only surface over the bulk pipeline)."""

import numpy as np
import pytest

from steganosaurus_jax import cli
from steganosaurus_jax.io import image as image_io

FAST = ["--pbkdf2_iter", "500"]


@pytest.fixture()
def batch_dirs(tmp_path):
    rng = np.random.default_rng(17)
    in_dir = tmp_path / "covers"
    out_dir = tmp_path / "stego"
    in_dir.mkdir()
    # two sizes: groups must each run as their own batch
    for i, (h, w) in enumerate([(128, 128), (128, 128), (96, 128)]):
        base = np.linspace(160, 220, w)[None, :, None]
        img = np.clip(base + rng.integers(-15, 16, (h, w, 3)),
                      0, 255).astype(np.uint8)
        image_io.save_png(str(in_dir / f"c{i}.png"), img)
    secrets = tmp_path / "secrets.txt"
    secrets.write_text("alpha secret\nbeta secret\ngamma secret\n")
    return in_dir, out_dir, secrets


def test_batch_embed_extract_cli(batch_dirs, capsys):
    in_dir, out_dir, secrets = batch_dirs
    rc = cli.main(["turtlefft", "batch-embed", "--in-dir", str(in_dir),
                   "--out-dir", str(out_dir), "--secrets-file", str(secrets),
                   "--pass", "pw", "--verify", "1", *FAST])
    assert rc == 0
    assert capsys.readouterr().out.startswith("Embedded 3/3")
    rc = cli.main(["turtlefft", "batch-extract", "--in-dir", str(out_dir),
                   "--pass", "pw", *FAST])
    out = capsys.readouterr().out
    assert rc == 0
    assert "c0.png\talpha secret" in out
    assert "c1.png\tbeta secret" in out
    assert "c2.png\tgamma secret" in out


def test_batch_extract_failure_isolation(batch_dirs, capsys):
    in_dir, out_dir, secrets = batch_dirs
    cli.main(["turtlefft", "batch-embed", "--in-dir", str(in_dir),
              "--out-dir", str(out_dir), "--secrets-file", str(secrets),
              "--pass", "pw", *FAST])
    capsys.readouterr()
    rc = cli.main(["turtlefft", "batch-extract", "--in-dir", str(out_dir),
                   "--pass", "wrong", *FAST])
    out = capsys.readouterr().out
    assert rc == 1
    assert out.count("<FAILED>") == 3


def test_batch_embed_count_mismatch(batch_dirs, capsys):
    in_dir, out_dir, secrets = batch_dirs
    secrets.write_text("only one\n")
    rc = cli.main(["turtlefft", "batch-embed", "--in-dir", str(in_dir),
                   "--out-dir", str(out_dir), "--secrets-file", str(secrets),
                   "--pass", "pw", *FAST])
    assert rc == 1


def test_check_mode(tmp_path, capsys):
    """`check` mode (the reference doc/TODO.md "--test mode" item): dry
    run reporting capacity, PSNR/SSIM, and warden-view statistics; rc 0
    iff the payload fits and round-trips, rc 1 on over-capacity."""
    rng = np.random.default_rng(23)
    base = np.linspace(160, 220, 128)[None, :, None]
    img = np.clip(base + rng.integers(-15, 16, (128, 128, 3)),
                  0, 255).astype(np.uint8)
    cover = tmp_path / "cover.png"
    image_io.save_png(str(cover), img)

    rc = cli.main(["turtlefft", "check", "--in", str(cover),
                   "--secret", "dry run", "--pass", "pw", *FAST])
    out = capsys.readouterr().out
    assert rc == 0
    assert "capacity:" in out and "psnr" in out and "chi2_z" in out
    assert "cross-channel: align_z" in out  # §2e cover screening
    assert "joint-residual: coherence" in out  # §2f cover screening
    assert "round-trip: ok" in out
    # nothing written anywhere
    assert sorted(p.name for p in tmp_path.iterdir()) == ["cover.png"]

    rc = cli.main(["turtlefft", "check", "--in", str(cover),
                   "--secret", "x" * 4000, "--pass", "pw", *FAST])
    out = capsys.readouterr().out
    assert rc == 1 and "check FAILED" in out


def test_cli_pad_flag_roundtrip(tmp_path, capsys):
    """--pad embeds the padded wire mode; extraction needs no flag."""
    rng = np.random.default_rng(29)
    base = np.linspace(160, 220, 128)[None, :, None]
    img = np.clip(base + rng.integers(-15, 16, (128, 128, 3)),
                  0, 255).astype(np.uint8)
    cover, stego = tmp_path / "c.png", tmp_path / "s.png"
    image_io.save_png(str(cover), img)
    rc = cli.main(["turtlefft", "embed", "--in", str(cover), "--out",
                   str(stego), "--secret", "padded cli", "--pass", "pw",
                   "--pad", "32", *FAST])
    assert rc == 0
    capsys.readouterr()
    rc = cli.main(["turtlefft", "extract", "--in", str(stego),
                   "--pass", "pw", *FAST])
    assert rc == 0
    # negative quantum is a usage error (rc 2 + usage text), not a traceback
    assert cli.main(["turtlefft", "embed", "--in", str(cover), "--out",
                     str(stego), "--secret", "x", "--pass", "pw",
                     "--pad", "-1"]) != 0
