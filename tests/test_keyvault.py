"""Native key-vault tests (native/keyvault.cc + crypto.derive_keys_vault).

VERDICT r3 next-round item 4: derived AEAD keys must live in mlock'd native
buffers, be wiped on drop, and never round-trip through Python bytes on the
hot paths. The heap-dump test below is the acceptance criterion: after a
full pipeline embed+extract in a child process, the derived 32-byte AEAD
key must not appear anywhere in that process's readable memory.
"""

import os
import re
import signal
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest

from steganosaurus_jax import _native_loader, crypto


def _vault_lib():
    lib = _native_loader.get()
    if lib is None or not getattr(lib, "has_keyvault", False):
        pytest.skip("native key vault not built")
    return lib


def test_vault_matches_classic_derivation():
    lib = _vault_lib()
    salt = os.urandom(16)
    km = crypto.derive_keys("pw", salt, 5000)
    with crypto.derive_keys_vault("pw", None, salt=salt, iters=5000) as vk:
        assert isinstance(vk, crypto.VaultedKeys)
        assert vk.nonce == km.nonce and vk.salt == salt
        ct, tag = vk.seal(b"aad", b"secret payload")
        ct2, tag2 = crypto.aead_seal(km.aead_key, km.nonce, b"aad",
                                     b"secret payload")
        assert (ct, tag) == (ct2, tag2)
        assert vk.open(b"aad", ct, tag) == b"secret payload"
        assert vk.open(b"aad", ct, b"\x00" * 16) is None
        assert vk.hkdf_expand(b"info", 40) == crypto.hkdf_expand(
            km.aead_key, b"info", 40)
    # closed: the slot is wiped and the handle rejected
    with pytest.raises(RuntimeError):
        crypto.VaultedKeys(lib, 0, km.nonce, salt).seal(b"", b"x")  # noqa


def test_vault_raw_master_key_path():
    _vault_lib()
    mk, salt = os.urandom(32), os.urandom(16)
    km = crypto.derive_keys_from_raw(mk, salt)
    with crypto.derive_keys_vault(None, mk, salt=salt, iters=0) as vk:
        assert vk.nonce == km.nonce
        ct, tag = vk.seal(b"", b"z" * 77)
        assert crypto.aead_open(km.aead_key, km.nonce, b"", ct, tag) \
            == b"z" * 77


def test_vault_slot_reuse_after_close():
    """Destroy must free slots: 4x the vault capacity of derive/close
    cycles may not exhaust it."""
    _vault_lib()
    salt = os.urandom(16)
    for _ in range(512):
        vk = crypto.derive_keys_vault(None, b"M" * 32, salt=salt, iters=0)
        assert isinstance(vk, crypto.VaultedKeys)
        vk.close()


def test_vault_mlocked_reported():
    lib = _vault_lib()
    # mlock can legitimately fail under RLIMIT_MEMLOCK; only assert the
    # introspection works and record the state in the test output
    assert lib.kv_mlocked() in (True, False)


def test_fallback_keys_cover_same_interface():
    os.environ["STEGANOSAURUS_NO_NATIVE"] = "1"
    try:
        salt = b"s" * 16
        vk = crypto.derive_keys_vault("pw", None, salt=salt, iters=2000)
        assert not isinstance(vk, crypto.VaultedKeys)
        km = crypto.derive_keys("pw", salt, 2000)
        ct, tag = vk.seal(b"a", b"pt")
        assert vk.open(b"a", ct, tag) == b"pt"
        assert (ct, tag) == crypto.aead_seal(km.aead_key, km.nonce, b"a",
                                             b"pt")
        assert vk.hkdf_expand(b"i", 16) == crypto.hkdf_expand(
            km.aead_key, b"i", 16)
    finally:
        del os.environ["STEGANOSAURUS_NO_NATIVE"]


_CHILD = textwrap.dedent("""
    import sys, time
    import numpy as np
    from steganosaurus_jax.config import Params
    from steganosaurus_jax.pipeline.embed import embed_array
    from steganosaurus_jax.pipeline.extract import extract_array

    MK = bytes(range(32))
    SALT = bytes(range(100, 116))
    rng = np.random.default_rng(5)
    img = rng.integers(60, 200, (128, 128, 3)).astype(np.uint8)
    # complex128 selects the numpy backend: the child stays jax-free, so
    # the parent's memory scan covers a small, fully readable process
    p = Params(pbkdf2_iter=1000, fft_dtype="complex128")
    res = embed_array(img, b"vault heap test", master_key=MK, params=p,
                      salt=SALT)
    out = extract_array(res.stego, master_key=MK, params=p)
    assert out == b"vault heap test", out
    print("READY", flush=True)
    time.sleep(60)
""")


def _scan_child_memory(pid: int, needles: dict[str, bytes]) -> dict:
    """Scan every readable private mapping of `pid` for the byte patterns.
    Chunked reads with overlap so needles spanning chunk borders hit."""
    found = {name: 0 for name in needles}
    maxlen = max(len(n) for n in needles.values())
    with open(f"/proc/{pid}/maps") as f:
        maps = f.readlines()
    with open(f"/proc/{pid}/mem", "rb", buffering=0) as mem:
        for line in maps:
            m = re.match(r"([0-9a-f]+)-([0-9a-f]+) (r)(w?)", line)
            if not m:
                continue  # unreadable region
            if " /dev/" in line or "(deleted)" in line:
                continue
            start, end = int(m.group(1), 16), int(m.group(2), 16)
            pos = start
            tail = b""
            while pos < end:
                n = min(1 << 22, end - pos)
                try:
                    mem.seek(pos)
                    chunk = mem.read(n)
                except OSError:
                    break  # vsyscall etc.
                hay = tail + chunk
                for name, needle in needles.items():
                    found[name] += hay.count(needle)
                tail = chunk[-(maxlen - 1):] if maxlen > 1 else b""
                pos += n
    return found


@pytest.mark.skipif(not os.path.exists("/proc/self/mem"),
                    reason="/proc memory introspection unavailable")
def test_no_derived_key_in_child_heap_dump():
    """Acceptance test for the vault: a child process runs a REAL pipeline
    embed+extract under a known master key; the parent then scans the
    child's entire readable memory for the derived AEAD key. The key is
    derived, used, and wiped inside the native vault, so zero copies may
    remain. The child's master key itself lives in Python bytes by
    construction (the caller supplied it) — the assertion is on the
    DERIVED key, which modulo this feature would be a Python bytes object
    too (and provably was: the fallback path fails this test)."""
    _vault_lib()
    mk = bytes(range(32))
    salt = bytes(range(100, 116))
    km = crypto.derive_keys_from_raw(mk, salt)

    env = dict(os.environ)
    env.pop("STEGANOSAURUS_NO_NATIVE", None)
    proc = subprocess.Popen([sys.executable, "-c", _CHILD],
                            stdout=subprocess.PIPE, env=env)
    try:
        line = proc.stdout.readline().strip()
        assert line == b"READY", line
        time.sleep(0.2)
        found = _scan_child_memory(
            proc.pid, {"aead_key": km.aead_key,
                       "nonce": km.nonce,       # public: allowed
                       "master": mk})           # caller-owned: expected
        # the derived AEAD key must appear NOWHERE in the child
        assert found["aead_key"] == 0, found
        # sanity of the scanner itself: the master key (held in Python
        # bytes by the child) MUST be visible, or the scan saw nothing
        assert found["master"] >= 1, found
    finally:
        proc.send_signal(signal.SIGKILL)
        proc.wait()
