"""The native library's build: cmake+ninja from native/*.cc, and a build that
fails says so and returns None (its callers then refuse to run) instead of
raising or pretending."""

import subprocess

from steganosaurus_jax import _native_loader as nl


def test_failed_build_returns_none_and_says_why(monkeypatch, capsys):
    def no_cmake(cmd, **kw):
        raise FileNotFoundError(cmd[0])

    monkeypatch.setattr(nl, "get", lambda: None)
    monkeypatch.setattr(subprocess, "run", no_cmake)
    monkeypatch.setattr(nl, "build_method", None)
    assert nl.ensure_built() is None
    assert "native build failed (FileNotFoundError)" in capsys.readouterr().err
    assert nl.build_method is None


def test_ensure_built_reports_its_method():
    assert nl.ensure_built() is not None
    assert nl.build_method in ("prebuilt", "cmake+ninja")
