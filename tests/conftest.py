"""Test configuration: virtual 8-device CPU mesh + persistent compile cache.

Env must be set before jax imports anywhere, hence top of conftest.
"""

import os
import pathlib
import subprocess

# Unit tests run on a virtual 8-device CPU mesh whatever the machine has:
# JAX_PLATFORMS=cpu before jax is imported, and jax.config.update below in
# case something imported jax first. Checks that need the card run through
# chip_smoke.py; tests marked `gpu` run it in a child where a card exists
# and skip elsewhere.
os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import tempfile  # noqa: E402

# Hermetic walk-expansion disk cache (keystream/diskcache.py): without this
# the suite would read/write ~/.cache, coupling test runs to each other.
_walk_cache_tmp = tempfile.mkdtemp(prefix="stwc_test_")
os.environ["STEGANOSAURUS_WALK_CACHE"] = _walk_cache_tmp

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parent.parent
REF_SRC = pathlib.Path("/root/reference/steganosaurus")
REF_BUILD = REPO / "build_ref"


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skips elsewhere (the card's "
        "checks run through `python chip_smoke.py`)")
    config.addinivalue_line("markers", "slow: long-running test")
    from steganosaurus_jax import _native_loader, runtime

    runtime.enable_compilation_cache()
    # Build the native host library (walk expander / crypto) if missing: the
    # pure-Python fallback is ~1000x slower on the big-grid walk tests. Tests
    # that cross-check the pure paths force STEGANOSAURUS_NO_NATIVE anyway.
    _native_loader.ensure_built()


@pytest.fixture(scope="session")
def host_image() -> np.ndarray:
    """Deterministic 256x256 gradient+noise cover (like tools/gen_png.cpp)."""
    rng = np.random.default_rng(12345)
    base = np.linspace(180, 220, 256)
    img = base[None, :, None] + rng.integers(-10, 11, (256, 256, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


@pytest.fixture(scope="session")
def small_image() -> np.ndarray:
    """128x128 cover for fast round-trip tests."""
    rng = np.random.default_rng(7)
    base = np.linspace(160, 230, 128)
    img = base[None, :, None] + rng.integers(-15, 16, (128, 128, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


def _build_reference() -> pathlib.Path | None:
    """Build the reference binary (test oracle) if sources + toolchain exist."""
    exe = REF_BUILD / "turtlefft"
    if exe.exists():
        return exe
    if not REF_SRC.exists():
        return None
    try:
        REF_BUILD.mkdir(exist_ok=True)
        subprocess.run(
            ["cmake", "-S", str(REF_SRC), "-B", str(REF_BUILD), "-G", "Ninja",
             "-DCMAKE_BUILD_TYPE=Release"],
            check=True, capture_output=True,
        )
        subprocess.run(
            ["ninja", "-C", str(REF_BUILD)], check=True, capture_output=True
        )
    except (subprocess.CalledProcessError, FileNotFoundError):
        return None
    return exe if exe.exists() else None


@pytest.fixture(scope="session")
def reference_bin():
    exe = _build_reference()
    if exe is None:
        pytest.skip("reference binary unavailable")
    return exe


@pytest.fixture(scope="session")
def reference_keytool():
    exe = _build_reference()
    tool = REF_BUILD / "turtlefft-key"
    if exe is None or not tool.exists():
        pytest.skip("reference key tool unavailable")
    return tool


@pytest.fixture
def gpu() -> str:
    """The first NVIDIA card as `nvidia-smi -L` names it; skips where there is
    none. This process's JAX stays on the CPU, so a `gpu` test drives the
    card from a child process. Decided here, at run time, so every
    pytest-xdist worker collects the same tests."""
    import shutil

    smi = shutil.which("nvidia-smi")
    r = (subprocess.run([smi, "-L"], capture_output=True, text=True,
                        timeout=60) if smi else None)
    if r is None or r.returncode != 0 or not r.stdout.strip():
        pytest.skip("needs an NVIDIA GPU (nvidia-smi finds none)")
    return r.stdout.splitlines()[0]
