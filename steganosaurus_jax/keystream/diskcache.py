"""Persistent on-disk cache for turtle-walk expansions.

The walk is a pure function of (keys, dims, walk params) but strictly
sequential to produce (reference steganosaur.cpp:749-810 — each accepted
bin mutates the visited set); on this host a cold 1M-bit expansion costs
~1.5 s single-threaded, which dominates a cold single-image CLI embed
(device compute is ~12 ms). The in-memory prefix cache
(keystream/__init__.py) only helps within one process; this module makes
the expansion survive process restarts.

Layout: one file per cache key under $STEGANOSAURUS_WALK_CACHE (default
~/.cache/steganosaurus_jax/walks; set to `0` to disable). The filename is
SHA-256(tag || serialized key) — the walk key itself is never stored.

Format (version STWC0001):
    magic(8) | meta_len u32 LE | meta JSON | raw arrays | sha256(all prior)
Every structural or checksum mismatch is treated as a miss and the file is
unlinked (corruption self-heals by re-expansion).

SECURITY TRADE-OFF (doc/HARDENING.md section 7): a cached expansion reveals
WHICH spectrum bins a given passphrase's walk would touch. It does not
contain key material, and an attacker with read access to the embedder's
disk cache is outside the warden threat model (they could read the cover
and secret inputs directly) — but high-paranoia deployments should disable
the cache (STEGANOSAURUS_WALK_CACHE=0).
"""

from __future__ import annotations

import hashlib
import json
import os
import pathlib
import tempfile

import numpy as np

_MAGIC = b"STWC0001"
_MAX_ENTRIES = int(os.environ.get("STEGANOSAURUS_WALK_CACHE_MAX", "32"))


def cache_dir() -> pathlib.Path | None:
    """Resolved cache directory, or None when disabled."""
    env = os.environ.get("STEGANOSAURUS_WALK_CACHE")
    if env is not None:
        if env in ("", "0"):
            return None
        return pathlib.Path(env)
    return (pathlib.Path(os.environ.get("XDG_CACHE_HOME",
                                        pathlib.Path.home() / ".cache"))
            / "steganosaurus_jax" / "walks")


def _path_for(tag: str, key: tuple) -> pathlib.Path | None:
    d = cache_dir()
    if d is None:
        return None
    digest = hashlib.sha256(
        tag.encode() + b"\x00" + repr(key).encode()).hexdigest()[:40]
    return d / f"{digest}.walk"


def store(tag: str, key: tuple, arrays: dict[str, np.ndarray],
          meta: dict) -> None:
    """Atomically persist `arrays` + `meta` under (tag, key). Best-effort:
    any OS error (read-only FS, quota, ...) is swallowed — the cache is an
    optimization, never a correctness dependency."""
    path = _path_for(tag, key)
    if path is None:
        return
    try:
        path.parent.mkdir(parents=True, exist_ok=True)
        spec = []
        blobs = []
        for name, arr in arrays.items():
            arr = np.ascontiguousarray(arr)
            spec.append([name, arr.dtype.str, list(arr.shape)])
            blobs.append(arr.tobytes())
        head = json.dumps({"arrays": spec, "meta": meta},
                          separators=(",", ":")).encode()
        h = hashlib.sha256()
        body = [_MAGIC, len(head).to_bytes(4, "little"), head, *blobs]
        for b in body:
            h.update(b)
        fd, tmp = tempfile.mkstemp(dir=path.parent, suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                for b in body:
                    f.write(b)
                f.write(h.digest())
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        _prune(path.parent)
    except OSError:
        pass


def load(tag: str, key: tuple) -> tuple[dict, dict] | None:
    """Return (arrays, meta) for (tag, key), or None on miss/corruption.
    Corrupt files are unlinked so the next store rewrites them."""
    path = _path_for(tag, key)
    if path is None:
        return None
    try:
        raw = path.read_bytes()
    except OSError:
        return None
    try:
        if len(raw) < len(_MAGIC) + 4 + 32 or raw[:8] != _MAGIC:
            raise ValueError("bad magic/size")
        if hashlib.sha256(raw[:-32]).digest() != raw[-32:]:
            raise ValueError("checksum mismatch")
        mlen = int.from_bytes(raw[8:12], "little")
        head = json.loads(raw[12: 12 + mlen].decode())
        off = 12 + mlen
        arrays = {}
        for name, dtype, shape in head["arrays"]:
            dt = np.dtype(dtype)
            count = int(np.prod(shape)) if shape else 1
            nbytes = dt.itemsize * count
            if off + nbytes > len(raw) - 32:
                raise ValueError("truncated arrays")
            arrays[name] = np.frombuffer(
                raw[off: off + nbytes], dtype=dt).reshape(shape)
            off += nbytes
        if off != len(raw) - 32:
            raise ValueError("trailing bytes")
        # touch for LRU pruning
        try:
            os.utime(path)
        except OSError:
            pass
        return arrays, head["meta"]
    except (ValueError, KeyError, TypeError, json.JSONDecodeError):
        try:
            path.unlink()
        except OSError:
            pass
        return None


def _prune(d: pathlib.Path) -> None:
    """Keep the `_MAX_ENTRIES` most recently used .walk files."""
    try:
        files = sorted(d.glob("*.walk"), key=lambda p: p.stat().st_mtime)
        for p in files[: max(0, len(files) - _MAX_ENTRIES)]:
            p.unlink()
    except OSError:
        pass
