"""chip_smoke.py off the card: its refusal of the CPU and its comparison
phases at small shapes (the same functions main() runs at 4K on the GPU).
The virtual 8-device CPU mesh stands in for the four cards."""

import pathlib

import numpy as np
import pytest

import chip_smoke


def test_main_refuses_cpu(capsys):
    """No accelerator: a non-zero exit and no result line."""
    assert chip_smoke.main([]) != 0
    out = capsys.readouterr().out
    assert '"ok"' not in out


def test_signal_scale_and_rel_err():
    F = np.full((3, 64, 64), 2.0 + 0j)
    sc = chip_smoke.signal_scale(F, 0.05, 0.45, np.pi / 2)
    assert sc == pytest.approx(2.0)
    mx, rms = chip_smoke.rel_err(np.array([1.0, 3.0]), np.array([1.0, 1.0]),
                                 2.0)
    assert mx == pytest.approx(1.0) and rms == pytest.approx(np.sqrt(0.5))


def test_phase_precision_small():
    out = chip_smoke.phase_precision(0, 128, 192, [(128, 192), (128, 128)],
                                     2000)
    assert out["fwd"]["HIGHEST"]["within_tol"]
    assert out["ifft"]["production"]["within_tol"]
    assert set(out["fft"]) == {"128x192", "128x128"}


def test_phase_main_small():
    """Recovery, bit-identical re-embed, highest vs default BER and the
    band-precision sweep, at 256x384 with a batch of 4."""
    out = chip_smoke.phase_main(1, 256, 384, 4, 120, "cpu", iters=1)
    assert out["default"]["recovery"] == 1.0
    assert out["highest"]["recovery"] == 1.0
    assert set(out["bands"]) == set(chip_smoke.CANDIDATES)


def test_phase_cli_and_serve_small(tmp_path):
    chip_smoke.phase_cli(2, 192, 256, tmp_path)
    chip_smoke.phase_serve(2, 192, 256, 100, tmp_path, "cpu")


def test_phase_mesh_matches_one_device():
    chip_smoke.phase_mesh(3, 192, 256, 8, 60, 4, "cpu")


def test_phase_fft_dist_matches_one_device():
    chip_smoke.phase_fft_dist(4, 128, 256, 2000, 4, "cpu")


def test_script_alone_fails(tmp_path):
    """In a directory that holds chip_smoke.py and nothing else of the repo
    the script fails and prints no result."""
    import subprocess
    import sys

    src = pathlib.Path(chip_smoke.__file__)
    (tmp_path / src.name).write_text(src.read_text())
    r = subprocess.run([sys.executable, src.name], cwd=tmp_path,
                       capture_output=True, text=True, timeout=120,
                       env={"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu"})
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


@pytest.mark.gpu
def test_chip_smoke_on_card(gpu):
    """The whole one-card check, in a child process that may use the card
    (this process's JAX is held to the CPU): exit 0 and the result line."""
    import json
    import os
    import subprocess
    import sys

    src = pathlib.Path(chip_smoke.__file__)
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    r = subprocess.run([sys.executable, src.name], cwd=src.parent, env=env,
                       capture_output=True, text=True, timeout=1200)
    assert r.returncode == 0, r.stderr[-4000:]
    last = json.loads(r.stdout.strip().splitlines()[-1])
    assert last == {"ok": True, "device": {
        "platform": "gpu", "kind": last["device"]["kind"], "count": 1}}
