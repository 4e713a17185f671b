"""A former package name (steganosaurus_jax/_alias.py) resolves to the very
same modules, and `python -m <former>.cli` runs the CLI. The shim here has
the same body as the repo's own former-name package."""

import importlib
import os
import subprocess
import sys
import warnings

import pytest

import steganosaurus_jax
import steganosaurus_jax.cli
import steganosaurus_jax.pipeline.batch

OLD = "stegano_formerly"
SHIM = ("from steganosaurus_jax._alias import install\n\n"
        "install(__name__)\n")


@pytest.fixture
def shim_dir(tmp_path):
    (tmp_path / OLD).mkdir()
    (tmp_path / OLD / "__init__.py").write_text(SHIM)
    return tmp_path


def test_alias_is_the_same_modules(shim_dir, monkeypatch):
    monkeypatch.syspath_prepend(str(shim_dir))
    monkeypatch.setattr(sys, "meta_path", list(sys.meta_path))
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            old = importlib.import_module(OLD)
        assert any(issubclass(w.category, DeprecationWarning)
                   for w in caught)
        assert old is steganosaurus_jax
        cli = importlib.import_module(OLD + ".cli")
        batch = importlib.import_module(OLD + ".pipeline.batch")
        assert cli is steganosaurus_jax.cli
        assert batch is steganosaurus_jax.pipeline.batch
        assert cli.__spec__.name == "steganosaurus_jax.cli"
        assert batch.__spec__.name == "steganosaurus_jax.pipeline.batch"
        with pytest.raises(ModuleNotFoundError):
            importlib.import_module(OLD + ".no_such_module")
    finally:
        for name in [n for n in sys.modules
                     if n == OLD or n.startswith(OLD + ".")]:
            del sys.modules[name]


def test_alias_runs_the_cli_as_a_module(shim_dir):
    repo = os.path.dirname(os.path.dirname(steganosaurus_jax.__file__))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(shim_dir), repo]))
    r = subprocess.run([sys.executable, "-m", OLD + ".cli"], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 1
    assert steganosaurus_jax.cli.USAGE.strip() in r.stderr
