"""`turtlefft serve` — a long-running steady-state serving worker.

The bench's headline serving numbers ride process-level warm state: jitted
modules (runtime compilation cache), walk expansions (keystream prefix
cache + disk cache), derived keys (native key vault), and DFT tables. A
one-shot CLI call pays all of it per image; this daemon pays it once and
then serves requests at steady-state cost — it is the deployment shape the
`steady_state_caches: true` bench field describes (README "Performance").

No reference counterpart (the reference binary is strictly one-shot,
steganosaur.cpp:879-1313 main dispatch); rebuild-only surface.

Protocol: JSON lines on stdin, one JSON line per response on stdout
(stderr is free-form logging). The key and Params are fixed at startup —
that is what makes the caches coherent; run one worker per (key, params)
serving class. Requests:

  {"op": "ping"}
  {"op": "embed",   "in": P, "out": P2, "secret": S | "secret_b64": B}
  {"op": "extract", "in": P2}
  (raw-tensor mode: "in_npy"/"out_npy" — (H, W, 3) uint8 .npy paths —
   replace "in"/"out" on the single ops; callers that already hold
   pixels write the .npy to /dev/shm and skip the PNG codec entirely,
   which dominates warm single-op 4K latency. "out" and "out_npy" may
   be given together to get both encodings.)
  {"op": "embed_batch",   "jobs": [{"in":..., "out":...,
                                    "secret"|"secret_b64":...}, ...]}
  {"op": "extract_batch", "ins": [P, ...] [, "clen_hint": N]}
  {"op": "stats"}
  {"op": "shutdown"}

Observability: every response carries "ms" (request wall time); "stats"
returns uptime and per-op {n, errors, images, ms_p50, ms_p95, ms_max}
over a bounded window (last 512 latencies per op) — the serving-side
complement of the bench record's throughput/MFU fields.

Every request may carry an "id"; it is echoed in the response. Responses
are {"ok": true, "op": ..., ...} or {"ok": false, "error": "..."}; batch
ops return per-item "results" arrays and ok=true iff every item
succeeded. Extracted secrets are returned base64 ("secret_b64") — they
are bytes, not necessarily text. Single-image ops keep per-request
latency minimal; the batch ops run the pipelined stream (threaded PNG
decode/AEAD overlap device graphs) for bulk throughput.
"""

from __future__ import annotations

import base64
import json
import sys

from steganosaurus_jax.pipeline.errors import StegoError


def _secret_of(req: dict) -> bytes:
    if "secret_b64" in req:
        return base64.b64decode(req["secret_b64"])
    s = req.get("secret")
    if s is None:
        raise StegoError("embed request needs 'secret' or 'secret_b64'")
    return s.encode() if isinstance(s, str) else bytes(s)


def _load(path: str):
    from steganosaurus_jax.io import image as image_io

    try:
        return image_io.load_rgb(path)
    except Exception as e:
        raise StegoError(f"Failed to load {path}") from e


def _load_npy(path: str):
    """Raw-tensor ingest: an (H, W, 3) uint8 .npy file (callers that
    already hold pixels write one to /dev/shm — a memcpy, not a codec).
    This is the PNG-free serving path: at warm 4K the PNG decode+encode
    pair is the majority of single-op latency (doc/PAPER.md §5b)."""
    import numpy as np

    try:
        arr = np.load(path)
    except Exception as e:
        raise StegoError(f"Failed to load npy {path}") from e
    if not (isinstance(arr, np.ndarray) and arr.dtype == np.uint8
            and arr.ndim == 3 and arr.shape[2] == 3):
        raise StegoError(
            f"npy {path} must be (H, W, 3) uint8, got "
            f"{getattr(arr, 'dtype', '?')} {getattr(arr, 'shape', '?')}")
    return arr


def _load_req(req: dict):
    """Resolve a request's input image: 'in_npy' (raw tensor) wins over
    'in' (any PIL-supported image file)."""
    if req.get("in_npy"):
        return _load_npy(req["in_npy"])
    if req.get("in"):
        return _load(req["in"])
    raise StegoError("request needs 'in' or 'in_npy'")


def _clen_of(secret_len: int, params) -> int:
    """On-wire ciphertext length for a secret of this size under the
    worker's params (the padded length when pad_quantum is on)."""
    from steganosaurus_jax.pipeline import header as header_mod

    if params.pad_quantum:
        return header_mod.padded_len(secret_len, params.pad_quantum)
    return secret_len


def _do_embed(req: dict, password, mk, params, hints: dict) -> dict:
    import numpy as np

    from steganosaurus_jax.io import image as image_io

    if not (req.get("out") or req.get("out_npy")):
        raise StegoError("embed request needs 'out' or 'out_npy'")
    secret = _secret_of(req)
    cover = _load_req(req)
    if params.cover_dependent_path:
        # Per-image cover-hash walks are per-image by contract: the batch
        # path rejects them (pipeline/batch.py embed_batch), so this
        # serving class rides the single-image path.
        from steganosaurus_jax.pipeline.embed import embed_array
        from steganosaurus_jax.pipeline.extract import extract_array

        res = embed_array(cover, secret, password=password, master_key=mk,
                          params=params)
        stego = np.asarray(res.stego)
        if req.get("verify"):
            try:
                got = extract_array(stego, password=password, master_key=mk,
                                    params=params)
            except StegoError:
                got = None
            if got != secret:
                raise StegoError("verify failed")
        bits, payload = int(res.written_bits), int(res.payload_bytes)
    else:
        # B=1 through the batch path: its fused corner modules and packed
        # pulls skip the full-grid FFTs of the single-image path, with
        # identical wire output — same salting, framing, and write rule;
        # the single path remains the library/CLI surface.
        from steganosaurus_jax.pipeline.batch import embed_batch

        res = embed_batch(cover[None], [secret], password=password,
                          master_key=mk, params=params,
                          verify=bool(req.get("verify", False)))
        if res.verified is not None and not res.verified[0]:
            raise StegoError("verify failed")
        stego = np.asarray(res.stego)[0]
        bits, payload = int(res.written_bits[0]), int(res.payload_bytes[0])
    out: dict = {"bits": bits, "payload_bytes": payload}
    if req.get("out_npy"):
        np.save(req["out_npy"], stego)
        out["out_npy"] = req["out_npy"]
    if req.get("out"):
        image_io.save_png(req["out"], stego)
        out["out"] = req["out"]
    # The worker's serving class usually has one payload size; remember
    # it so subsequent single extracts ride the one-pass hinted path.
    hints["clen"] = _clen_of(len(secret), params)
    return out


def _hint_int(hint) -> int | None:
    """Validate a client-supplied clen hint: positive int or None, never a
    crash (serve_loop's never-raise contract covers malformed request
    fields). Non-positive hints are rejected rather than coerced — a
    negative clen would flow into _ExtractJob geometry and dispatch
    nonsense shapes (round-4 advisor finding)."""
    if hint is None:
        return None
    try:
        hint = int(hint)
    except (TypeError, ValueError) as e:
        raise StegoError(f"bad clen_hint: {hint!r}") from e
    if hint <= 0:
        raise StegoError(f"bad clen_hint: {hint} (must be positive)")
    return hint


def _do_extract(req: dict, password, mk, params, hints: dict) -> dict:
    from steganosaurus_jax.pipeline.extract import extract_array

    img = _load_req(req)
    hint = _hint_int(req.get("clen_hint", hints.get("clen")))
    secret = None
    # cover_dependent_path walks are per-image by contract — extract_batch
    # raises for them, so those serving classes take the single path below.
    if hint and not params.cover_dependent_path:
        # One fused device pass: header + hinted payload gathered and
        # ECC-decoded on device, ~250x smaller pull (pipeline/batch.py
        # extract_batch docstring). A wrong hint can cost the fallback
        # below, never misdecode.
        from steganosaurus_jax.pipeline.batch import extract_batch

        secret = extract_batch(img[None], password=password, master_key=mk,
                               params=params, clen_hint=hint)[0]
    if secret is None:
        # No hint, stale hint, or a genuine failure: the two-pass single
        # path re-derives everything and raises the precise StegoError
        # ("Magic not found." vs auth failure) on real failures.
        secret = extract_array(img, password=password, master_key=mk,
                               params=params)
    hints["clen"] = _clen_of(len(secret), params)
    return {"secret_b64": base64.b64encode(secret).decode()}


def _preflight(paths: list) -> tuple[list, dict]:
    """Split paths into (loadable, {path: error-result}). The stream
    loader (load_rgb_batches) propagates decode failures, which would turn
    one bad file into a whole-request error; a cheap header probe up front
    (the PNG IHDR, PIL for other formats) keeps per-item isolation for the
    common failure (missing or non-image file). A file that passes the
    probe but fails full decode still errors the request — documented, and
    rare."""
    from steganosaurus_jax.io import image as image_io

    good, bad = [], {}
    for p in paths:
        try:
            image_io.image_size(p)
            good.append(p)
        except Exception as e:  # noqa: BLE001 — per-item isolation
            bad[p] = {"ok": False, "in": p,
                      "error": f"{type(e).__name__}: {e}"}
    return good, bad


def _do_embed_batch(req: dict, password, mk, params, hints: dict) -> dict:
    import numpy as np

    from steganosaurus_jax.io import image as image_io
    from steganosaurus_jax.pipeline import stream

    jobs = req.get("jobs") or []
    if not jobs:
        raise StegoError("embed_batch request needs non-empty 'jobs'")
    # Jobs are keyed by INDEX, not input path: two jobs may legally share
    # a cover path with different secrets/outputs (round-4 advisor finding
    # — path keying silently dropped all but the last such job). The
    # preflight probe is still cached per path.
    all_paths = [j["in"] for j in jobs]
    good_paths, bad = _preflight(sorted(set(all_paths)))
    goodset = set(good_paths)
    results: list = [dict(bad[p], **{"in": p}) if p in bad
                     else {"ok": False, "in": p, "error": "not processed"}
                     for p in all_paths]
    idxs = [i for i, p in enumerate(all_paths) if p in goodset]

    def batches():
        pos = 0
        for got_paths, covers in stream.load_rgb_batches(
                [all_paths[i] for i in idxs], 32):
            got = idxs[pos:pos + len(got_paths)]
            pos += len(got_paths)
            batches.q.append(got)
            yield covers, [_secret_of(jobs[i]) for i in got]

    batches.q = []
    for res in stream.embed_stream(batches(), password=password,
                                   master_key=mk, params=params,
                                   verify=bool(req.get("verify", False))):
        got = batches.q.pop(0)
        stego = np.asarray(res.stego)
        for j, i in enumerate(got):
            p = all_paths[i]
            if req.get("verify") and not res.verified[j]:
                results[i] = {"ok": False, "in": p,
                              "error": "verify failed"}
                continue
            out = jobs[i]["out"]
            image_io.save_png(out, stego[j])
            results[i] = {"ok": True, "in": p, "out": out,
                          "bits": int(res.written_bits[j])}
    if idxs:
        # oversized hints are bucket-covered and safe; undersized ones
        # cost a second pass — learn the largest payload in the batch
        hints["clen"] = max(_clen_of(len(_secret_of(jobs[i])), params)
                            for i in idxs)
    return {"results": results,
            "n_ok": sum(1 for r in results if r["ok"])}


def _do_extract_batch(req: dict, password, mk, params,
                      hints: dict) -> dict:
    from steganosaurus_jax.pipeline import stream

    all_paths = req.get("ins") or []
    if not all_paths:
        raise StegoError("extract_batch request needs non-empty 'ins'")
    paths, results = _preflight(all_paths)

    def batches():
        for got_paths, stegos in stream.load_rgb_batches(paths, 32):
            batches.q.append(got_paths)
            yield stegos

    batches.q = []
    hint = _hint_int(req.get("clen_hint", hints.get("clen")))
    for got in stream.extract_stream(batches(), password=password,
                                     master_key=mk, params=params,
                                     clen_hint=hint):
        for p, secret in zip(batches.q.pop(0), got):
            if secret is None:
                results[p] = {"ok": False, "in": p,
                              "error": "extraction failed"}
            else:
                results[p] = {"ok": True, "in": p, "secret_b64":
                              base64.b64encode(secret).decode()}
    ordered = [results[p] for p in all_paths]
    return {"results": ordered,
            "n_ok": sum(1 for r in ordered if r["ok"])}


class _OpStats:
    """Per-op serving telemetry over a bounded latency window."""

    WINDOW = 512

    def __init__(self):
        from collections import deque

        self.n = 0
        self.errors = 0
        self.images = 0  # items processed by batch ops; 1 per single op
        self.ms_max = 0.0
        self.recent = deque(maxlen=self.WINDOW)

    def record(self, ms: float, ok: bool, images: int) -> None:
        self.n += 1
        self.errors += 0 if ok else 1
        self.images += images
        self.ms_max = max(self.ms_max, ms)
        self.recent.append(ms)

    def report(self) -> dict:
        lat = sorted(self.recent)

        def pct(q: float) -> float:
            return lat[min(len(lat) - 1, int(q * len(lat)))] if lat else 0.0

        return {"n": self.n, "errors": self.errors, "images": self.images,
                "ms_p50": round(pct(0.50), 1), "ms_p95": round(pct(0.95), 1),
                "ms_max": round(self.ms_max, 1)}


def _warmup_shape(h: int, w: int, payload: int, password, mk,
                  params) -> float:
    """Compile + cache-fill for one (H, W, payload-size) serving class:
    synthetic cover, in-memory embed + extract (never touches disk).
    Exercises exactly the jitted modules, DFT tables, walk expansion, and
    vaulted key a real request of this class uses. The payload size
    matters because device modules are specialized per 4096-bit frame
    bucket (pipeline/batch.py _dispatch_pass) — warming with a token
    secret would leave the real bucket cold. Returns wall seconds."""
    import time

    import numpy as np

    from steganosaurus_jax.pipeline.batch import embed_batch, extract_batch
    from steganosaurus_jax.pipeline.extract import extract_array

    if h <= 0 or w <= 0 or payload <= 0:
        raise StegoError(f"bad warmup shape {h}x{w}:{payload}")
    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    base = np.linspace(60.0, 200.0, w)[None, :, None]
    cover = np.clip(base + rng.integers(-12, 13, (h, w, 3)),
                    0, 255).astype(np.uint8)
    secret = bytes(rng.integers(0, 256, max(1, payload), dtype=np.uint8))
    try:
        # exactly the modules the single ops dispatch: B=1 batch embed,
        # the fused hinted extract, and the two-pass fallback path
        res = embed_batch(cover[None], [secret], password=password,
                          master_key=mk, params=params)
        stego = np.asarray(res.stego)[0]
        extract_batch(stego[None], password=password, master_key=mk,
                      params=params, clen_hint=_clen_of(len(secret), params))
        extract_array(stego, password=password, master_key=mk,
                      params=params)
    except StegoError:
        # A margin failure on synthetic data (or a shape too small for
        # the frame) still warmed every module it reached; keep serving.
        pass
    return time.perf_counter() - t0


def serve_loop(password, mk, params, stdin=None, stdout=None,
               warmup=()) -> int:
    """Read JSON-lines requests until EOF or a shutdown op. Returns the
    process exit code (0 on clean EOF/shutdown). Never raises on a bad
    request — every per-request failure becomes an {"ok": false}
    response so one malformed job cannot kill the worker.

    `warmup`: iterable of (H, W) or (H, W, payload_bytes) serving
    classes to compile BEFORE the ready line — the first real request of
    a warmed class runs at warm p50 instead of paying the jit compile."""
    stdin = stdin if stdin is not None else sys.stdin
    stdout = stdout if stdout is not None else sys.stdout
    import os
    import time

    from steganosaurus_jax import __version__

    def reply(obj: dict) -> None:
        stdout.write(json.dumps(obj, separators=(",", ":")) + "\n")
        stdout.flush()

    warmed = []
    for spec in warmup:
        h, w = int(spec[0]), int(spec[1])
        payload = int(spec[2]) if len(spec) > 2 else 6
        dt = _warmup_shape(h, w, payload, password, mk, params)
        print(f"warmed {h}x{w}:{payload} in {dt:.1f}s", file=sys.stderr,
              flush=True)
        warmed.append(f"{h}x{w}:{payload}")
    t_up = time.perf_counter()
    stats: dict[str, _OpStats] = {}
    hints: dict = {}  # learned serving-class state (last wire clen)
    reply({"ok": True, "op": "ready", "pid": os.getpid(),
           "version": __version__,
           **({"warmed": warmed} if warmed else {})})
    for line in stdin:
        line = line.strip()
        if not line:
            continue
        rid = None
        op = None
        t0 = time.perf_counter()
        try:
            req = json.loads(line)
            if not isinstance(req, dict):
                raise StegoError("request must be a JSON object")
            rid = req.get("id")
            op = req.get("op")
            if op == "shutdown":
                reply({"ok": True, "op": "shutdown",
                       **({"id": rid} if rid is not None else {})})
                return 0
            if op == "ping":
                out = {"pid": os.getpid(), "version": __version__}
            elif op == "stats":
                out = {"uptime_s": round(time.perf_counter() - t_up, 1),
                       "ops": {k: v.report()
                               for k, v in sorted(stats.items())}}
            elif op == "embed":
                out = _do_embed(req, password, mk, params, hints)
            elif op == "extract":
                out = _do_extract(req, password, mk, params, hints)
            elif op == "embed_batch":
                out = _do_embed_batch(req, password, mk, params, hints)
            elif op == "extract_batch":
                out = _do_extract_batch(req, password, mk, params, hints)
            else:
                raise StegoError(f"unknown op: {op!r}")
            n_ok = out.get("n_ok")
            ok = (n_ok == len(out["results"])) if n_ok is not None else True
            ms = 1e3 * (time.perf_counter() - t0)
            stats.setdefault(op, _OpStats()).record(
                ms, ok, n_ok if n_ok is not None else 1)
            reply({"ok": ok, "op": op,
                   **({"id": rid} if rid is not None else {}), **out,
                   "ms": round(ms, 1)})
        except Exception as e:  # noqa: BLE001 — never-raise contract
            # The worker must survive ANY per-request failure, including
            # JAX/XLA RuntimeErrors (e.g. RESOURCE_EXHAUSTED on a request
            # too large for the free device memory). The
            # expected types (StegoError/ValueError/...) are normal bad-
            # request traffic; anything else gets a traceback on stderr so
            # operator logs can distinguish a bug from a bad request.
            ms = 1e3 * (time.perf_counter() - t0)
            if not isinstance(e, (StegoError, ValueError, KeyError,
                                  TypeError, OSError)):
                import traceback

                traceback.print_exc(file=sys.stderr)
                sys.stderr.flush()
            if op is not None:
                stats.setdefault(op, _OpStats()).record(ms, False, 0)
            reply({"ok": False,
                   **({"id": rid} if rid is not None else {}),
                   "error": f"{type(e).__name__}: {e}", "ms": round(ms, 1)})
    return 0
