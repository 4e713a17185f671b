"""`turtlefft serve` steady-state worker: JSON-lines protocol, warm-cache
single ops, pipelined batch ops, per-request error isolation (rebuild-only
surface; the reference binary is strictly one-shot)."""

import base64
import io
import json

import numpy as np
import pytest

from steganosaurus_jax import crypto
from steganosaurus_jax.config import Params
from steganosaurus_jax.io import image as image_io
from steganosaurus_jax.pipeline.serve import serve_loop

MK = bytes(range(32))
P = Params(pbkdf2_iter=500)


def run_serve(requests, params=P):
    """Feed JSON requests through serve_loop; return (rc, responses)."""
    stdin = io.StringIO(
        "".join(json.dumps(r) + "\n" if isinstance(r, dict) else r + "\n"
                for r in requests))
    stdout = io.StringIO()
    rc = serve_loop(None, MK, params, stdin=stdin, stdout=stdout)
    lines = [json.loads(x) for x in stdout.getvalue().splitlines()]
    assert lines[0] == {"ok": True, "op": "ready", **{
        k: lines[0][k] for k in ("pid", "version")}}
    return rc, lines[1:]


def _cover(tmp_path, name, seed=11, hw=(128, 128)):
    rng = np.random.default_rng(seed)
    base = np.linspace(160, 220, hw[1])[None, :, None]
    img = np.clip(base + rng.integers(-15, 16, (*hw, 3)),
                  0, 255).astype(np.uint8)
    p = tmp_path / name
    image_io.save_png(str(p), img)
    return str(p)


def test_ping_unknown_op_bad_json_and_shutdown():
    rc, rs = run_serve([{"op": "ping", "id": 7}, {"op": "nope"},
                        "this is not json", {"op": "shutdown", "id": 9},
                        {"op": "ping"}])  # after shutdown: never processed
    assert rc == 0
    assert rs[0]["ok"] and rs[0]["op"] == "ping" and rs[0]["id"] == 7
    assert not rs[1]["ok"] and "unknown op" in rs[1]["error"]
    assert not rs[2]["ok"]
    assert rs[3] == {"ok": True, "op": "shutdown", "id": 9}
    assert len(rs) == 4  # the loop exited on shutdown


def test_embed_extract_roundtrip_and_binary_secret(tmp_path):
    cov = _cover(tmp_path, "c.png")
    out = str(tmp_path / "s.png")
    blob = bytes([0, 255, 10, 13, 127]) * 4
    rc, rs = run_serve([
        {"op": "embed", "in": cov, "out": out, "secret": "hello serve"},
        {"op": "extract", "in": out, "id": "x1"},
        {"op": "embed", "in": cov, "out": out,
         "secret_b64": base64.b64encode(blob).decode()},
        {"op": "extract", "in": out},
    ])
    assert rc == 0
    assert rs[0]["ok"] and rs[0]["bits"] > 0 and rs[0]["out"] == out
    assert base64.b64decode(rs[1]["secret_b64"]) == b"hello serve"
    assert rs[1]["id"] == "x1"
    assert base64.b64decode(rs[3]["secret_b64"]) == blob


def test_batch_ops_and_per_item_error_isolation(tmp_path):
    covs = [_cover(tmp_path, f"c{i}.png", seed=20 + i) for i in range(3)]
    outs = [str(tmp_path / f"s{i}.png") for i in range(3)]
    jobs = [{"in": c, "out": o, "secret": f"msg {i}"}
            for i, (c, o) in enumerate(zip(covs, outs))]
    rc, rs = run_serve([
        {"op": "embed_batch", "jobs": jobs, "verify": True},
        {"op": "extract_batch", "ins": outs},
        # a missing input fails ITS item; the worker and peers survive
        {"op": "extract_batch", "ins": [outs[0], str(tmp_path / "no.png")]},
        {"op": "embed_batch", "jobs": []},
        {"op": "embed", "in": covs[0], "out": outs[0]},  # missing secret
    ])
    assert rc == 0
    assert rs[0]["ok"] and rs[0]["n_ok"] == 3
    assert all(r["ok"] for r in rs[0]["results"])
    got = [base64.b64decode(r["secret_b64"]) for r in rs[1]["results"]]
    assert got == [f"msg {i}".encode() for i in range(3)]
    assert not rs[2]["ok"] and rs[2]["n_ok"] == 1
    assert rs[2]["results"][0]["ok"] and not rs[2]["results"][1]["ok"]
    assert not rs[3]["ok"] and "non-empty" in rs[3]["error"]
    assert not rs[4]["ok"] and "secret" in rs[4]["error"]


def test_cli_serve_wiring(tmp_path, monkeypatch, capsys):
    """cli.main routes `serve` to the loop (stdin/stdout), key via --key."""
    from steganosaurus_jax import cli

    cov = _cover(tmp_path, "c.png", seed=5)
    out = str(tmp_path / "s.png")
    reqs = [{"op": "embed", "in": cov, "out": out, "secret": "via cli"},
            {"op": "extract", "in": out}, {"op": "shutdown"}]
    monkeypatch.setattr("sys.stdin",
                        io.StringIO("".join(json.dumps(r) + "\n"
                                            for r in reqs)))
    rc = cli.main(["turtlefft", "serve", "--key",
                   crypto.base64_encode(MK), "--pbkdf2_iter", "500"])
    assert rc == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert lines[0]["op"] == "ready"
    assert base64.b64decode(lines[2]["secret_b64"]) == b"via cli"
    assert lines[3]["op"] == "shutdown"


def test_stats_and_latency_fields(tmp_path):
    cov = _cover(tmp_path, "c.png", seed=31)
    out = str(tmp_path / "s.png")
    rc, rs = run_serve([
        {"op": "embed", "in": cov, "out": out, "secret": "t"},
        {"op": "embed", "in": cov, "out": out},  # error: missing secret
        {"op": "extract", "in": out},
        {"op": "stats"},
    ])
    assert rc == 0
    assert all("ms" in r and r["ms"] >= 0 for r in rs)
    st = rs[3]
    assert st["ok"] and st["uptime_s"] >= 0
    emb = st["ops"]["embed"]
    assert emb["n"] == 2 and emb["errors"] == 1 and emb["images"] == 1
    assert emb["ms_p95"] >= emb["ms_p50"] >= 0
    assert st["ops"]["extract"]["n"] == 1
    assert "stats" not in st["ops"]  # the stats op itself reports first


def test_serve_requires_key():
    from steganosaurus_jax import cli

    assert cli.parse_args(["turtlefft", "serve"]) is None
    assert cli.parse_args(["turtlefft", "serve", "--pass", "pw"]) is not None


def test_serve_warmup_flag_and_ready_field(tmp_path):
    """--warmup HxW pre-compiles shape classes before the ready line; the
    ready response lists them. Parser rejects malformed values."""
    from steganosaurus_jax import cli

    a = cli.parse_args(["turtlefft", "serve", "--pass", "pw",
                        "--warmup", "64x48", "--warmup", "128X96:4096"])
    assert a.warmup == [(64, 48), (128, 96, 4096)]
    assert cli.parse_args(["turtlefft", "serve", "--pass", "pw",
                           "--warmup", "64"]) is None
    assert cli.parse_args(["turtlefft", "serve", "--pass", "pw",
                           "--warmup", "axb"]) is None
    assert cli.parse_args(["turtlefft", "serve", "--pass", "pw",
                           "--warmup", "64x48:big"]) is None

    stdin = io.StringIO(json.dumps({"op": "shutdown"}) + "\n")
    stdout = io.StringIO()
    rc = serve_loop(None, MK, P, stdin=stdin, stdout=stdout,
                    warmup=[(64, 48), (128, 96, 16)])
    assert rc == 0
    ready = json.loads(stdout.getvalue().splitlines()[0])
    assert ready["op"] == "ready"
    assert ready["warmed"] == ["64x48:6", "128x96:16"]


def test_serve_extract_rides_hint_and_survives_stale_hint(tmp_path):
    """Single extracts use the fused one-pass path once a payload size is
    known (learned from embeds/extracts or given as clen_hint); a stale or
    wrong hint falls back to the two-pass path and still decodes."""
    cov = _cover(tmp_path, "c.png")
    out1, out2 = str(tmp_path / "a.png"), str(tmp_path / "b.png")
    rc, rs = run_serve([
        {"op": "embed", "in": cov, "out": out1, "secret": "short"},
        {"op": "extract", "in": out1},                      # learned hint
        {"op": "embed", "in": cov, "out": out2,
         "secret": "a much longer secret body"},
        # hint is now 25 (from the last embed); extract of the SHORT stego
        # with that oversized learned hint must still decode (bucket
        # covers it), and an explicitly wrong undersized hint must fall
        # back to the two-pass path and succeed:
        {"op": "extract", "in": out1, "clen_hint": 1},
        {"op": "extract", "in": out2},
        {"op": "shutdown"},
    ])
    assert rc == 0
    assert base64.b64decode(rs[1]["secret_b64"]) == b"short"
    assert base64.b64decode(rs[3]["secret_b64"]) == b"short"
    assert base64.b64decode(rs[4]["secret_b64"]) == b"a much longer secret body"


@pytest.mark.parametrize("wire", ["rs", "pad", "qim"])
def test_serve_hinted_extract_composes_with_wire_modes(tmp_path, wire):
    """The learned-clen fused path must stay correct under each wire mode
    (RS changes the coded length, padding changes the wire clen, QIM
    changes the read rule) — all auto-detected from the header."""
    p = {"rs": Params(pbkdf2_iter=500, rs=True),
         "pad": Params(pbkdf2_iter=500, pad_quantum=64),
         "qim": Params(pbkdf2_iter=500, qim=10)}[wire]
    cov = _cover(tmp_path, "c.png", seed=40, hw=(192, 192))
    out = str(tmp_path / "s.png")
    rc, rs_ = run_serve([
        {"op": "embed", "in": cov, "out": out, "secret": "wire-mode body"},
        {"op": "extract", "in": out},                 # learned hint
        {"op": "extract", "in": out, "clen_hint": 14},  # explicit
    ], params=p)
    assert rc == 0, rs_
    assert rs_[0]["ok"], rs_[0]
    for r in rs_[1:]:
        assert r["ok"] and base64.b64decode(r["secret_b64"]) == \
            b"wire-mode body", (wire, r)


def test_serve_batch_ops_learn_and_use_hint(tmp_path):
    """embed_batch teaches the worker its payload size; a following
    extract_batch and single extract ride the hint."""
    covs = [_cover(tmp_path, f"c{i}.png", seed=50 + i) for i in range(3)]
    outs = [str(tmp_path / f"s{i}.png") for i in range(3)]
    jobs = [{"in": c, "out": o, "secret": f"msg number {i}"}
            for i, (c, o) in enumerate(zip(covs, outs))]
    rc, rs_ = run_serve([
        {"op": "embed_batch", "jobs": jobs},
        {"op": "extract_batch", "ins": outs},
        {"op": "extract", "in": outs[0]},
    ])
    assert rc == 0
    assert rs_[0]["n_ok"] == 3
    got = [base64.b64decode(r["secret_b64"]).decode()
           for r in rs_[1]["results"]]
    assert got == [f"msg number {i}" for i in range(3)]
    assert base64.b64decode(rs_[2]["secret_b64"]) == b"msg number 0"


def test_serve_cover_dependent_path_class(tmp_path):
    """A worker started with --cover_dependent_path 1 must serve: embed
    rides the single-image path (the batch path rejects the mode by
    contract), and extract either round-trips or reports the mode's real
    parity failure ("Magic not found", doc/HARDENING.md) — whether the
    stego-side cover hash matches is salt-dependent (the random AEAD
    stream decides which low-freq magnitude bins cross a quantization
    boundary), so BOTH outcomes are in-contract. What must never appear
    is the internal 'use embed_array' contract error, and the worker
    must stay alive."""
    p = Params(cover_dependent_path=True, pbkdf2_iter=500)
    cov = _cover(tmp_path, "c.png", seed=60)
    out = str(tmp_path / "s.png")
    rc, rs = run_serve([
        {"op": "embed", "in": cov, "out": out, "secret": "cover-keyed"},
        {"op": "extract", "in": out},            # learned hint is skipped
        {"op": "extract", "in": out, "clen_hint": 11},  # explicit hint too
        {"op": "ping"},
    ], params=p)
    assert rc == 0
    assert rs[0]["ok"], rs[0]
    for r in rs[1:3]:
        if r["ok"]:
            assert base64.b64decode(r["secret_b64"]) == b"cover-keyed", r
        else:
            assert "Magic not found" in r["error"] \
                and "embed_array" not in r["error"], r
    assert rs[3]["ok"] and rs[3]["op"] == "ping"


def test_serve_malformed_hint_types_keep_worker_alive(tmp_path):
    """A client bug sending a non-scalar clen_hint must produce one
    ok:false reply, not a dead worker (the never-raise contract)."""
    cov = _cover(tmp_path, "c.png", seed=61)
    out = str(tmp_path / "s.png")
    rc, rs = run_serve([
        {"op": "embed", "in": cov, "out": out, "secret": "hi"},
        {"op": "extract", "in": out, "clen_hint": [4096]},
        {"op": "extract_batch", "ins": [out], "clen_hint": {"n": 1}},
        {"op": "extract", "in": out, "clen_hint": "not-a-number"},
        {"op": "ping"},
    ])
    assert rc == 0
    for r in rs[1:4]:
        assert not r["ok"] and "clen_hint" in r["error"], r
    assert rs[4]["ok"] and rs[4]["op"] == "ping"


def test_warmup_specs_validated_at_parse_and_runtime():
    """Non-positive --warmup dims are rejected at parse time; a bad spec
    reaching serve_loop raises StegoError, not a numpy traceback."""
    from steganosaurus_jax.cli import parse_args
    from steganosaurus_jax.pipeline.serve import _warmup_shape
    from steganosaurus_jax.pipeline.errors import StegoError

    for bad in ("-1x64", "0x0", "64x-2", "64x48:0", "64x48:-6"):
        assert parse_args(["turtlefft", "serve", "--pass", "pw",
                           "--warmup", bad]) is None, bad
    ok = parse_args(["turtlefft", "serve", "--pass", "pw",
                     "--warmup", "64x48:16"])
    assert ok is not None and ok.warmup == [(64, 48, 16)]
    with pytest.raises(StegoError):
        _warmup_shape(-1, 64, 6, None, MK, P)


def test_serve_rejects_nonpositive_hint(tmp_path):
    """clen_hint <= 0 must be rejected as a bad request (round-4 advisor:
    a negative clen flowed into extract geometry), never dispatched."""
    cov = _cover(tmp_path, "c.png", seed=71)
    out = str(tmp_path / "s.png")
    rc, rs = run_serve([
        {"op": "embed", "in": cov, "out": out, "secret": "hi"},
        {"op": "extract", "in": out, "clen_hint": 0},
        {"op": "extract", "in": out, "clen_hint": -5},
        {"op": "extract_batch", "ins": [out], "clen_hint": -4096},
        {"op": "ping"},
    ])
    assert rc == 0
    for r in rs[1:4]:
        assert not r["ok"] and "clen_hint" in r["error"], r
    assert rs[4]["ok"]


def test_serve_survives_unexpected_runtime_error(tmp_path, monkeypatch,
                                                 capsys):
    """The never-raise contract covers ANY exception type — a transient
    XLA RuntimeError (round-4 advisor medium) becomes one ok:false reply
    with a stderr traceback, not a dead worker."""
    import steganosaurus_jax.pipeline.serve as serve_mod

    def boom(*a, **k):
        raise RuntimeError("RESOURCE_EXHAUSTED: transient device hiccup")

    monkeypatch.setattr(serve_mod, "_do_embed", boom)
    cov = _cover(tmp_path, "c.png", seed=72)
    rc, rs = run_serve([
        {"op": "embed", "in": cov, "out": str(tmp_path / "s.png"),
         "secret": "x", "id": 1},
        {"op": "ping", "id": 2},
    ])
    assert rc == 0
    assert not rs[0]["ok"] and "RESOURCE_EXHAUSTED" in rs[0]["error"]
    assert rs[1]["ok"] and rs[1]["op"] == "ping"
    assert "RuntimeError" in capsys.readouterr().err  # operator traceback


def test_serve_embed_batch_duplicate_cover_paths(tmp_path):
    """Two jobs sharing one cover path are distinct jobs (round-4 advisor:
    path-keyed results silently dropped all but the last)."""
    cov = _cover(tmp_path, "c.png", seed=73)
    outs = [str(tmp_path / f"s{i}.png") for i in range(2)]
    rc, rs = run_serve([
        {"op": "embed_batch", "jobs": [
            {"in": cov, "out": outs[0], "secret": "first secret"},
            {"in": cov, "out": outs[1], "secret": "second secret"}]},
        {"op": "extract_batch", "ins": outs},
    ])
    assert rc == 0
    assert rs[0]["ok"] and rs[0]["n_ok"] == 2
    assert [r["out"] for r in rs[0]["results"]] == outs
    got = [base64.b64decode(r["secret_b64"]) for r in rs[1]["results"]]
    assert got == [b"first secret", b"second secret"]


def test_serve_raw_npy_mode_roundtrip(tmp_path):
    """PNG-free serving: in_npy/out_npy carry raw (H, W, 3) u8 tensors,
    skipping both PNG codecs; out + out_npy may be combined; malformed
    npy inputs are rejected as bad requests."""
    rng = np.random.default_rng(74)
    base = np.linspace(160, 220, 128)[None, :, None]
    cover = np.clip(base + rng.integers(-15, 16, (128, 128, 3)),
                    0, 255).astype(np.uint8)
    cov_npy = str(tmp_path / "c.npy")
    np.save(cov_npy, cover)
    out_npy = str(tmp_path / "s.npy")
    out_png = str(tmp_path / "s.png")
    bad_npy = str(tmp_path / "bad.npy")
    np.save(bad_npy, np.zeros((4, 4), np.float32))
    rc, rs = run_serve([
        {"op": "embed", "in_npy": cov_npy, "out_npy": out_npy,
         "out": out_png, "secret": "raw tensor path"},
        {"op": "extract", "in_npy": out_npy},
        {"op": "extract", "in": out_png},
        {"op": "embed", "in_npy": bad_npy, "out_npy": out_npy,
         "secret": "x"},
        {"op": "embed", "in_npy": cov_npy, "secret": "x"},  # no output
        {"op": "ping"},
    ])
    assert rc == 0
    assert rs[0]["ok"] and rs[0]["out_npy"] == out_npy \
        and rs[0]["out"] == out_png
    # both encodings carry the identical stego
    assert np.array_equal(np.load(out_npy), image_io.load_rgb(out_png))
    assert base64.b64decode(rs[1]["secret_b64"]) == b"raw tensor path"
    assert base64.b64decode(rs[2]["secret_b64"]) == b"raw tensor path"
    assert not rs[3]["ok"] and "uint8" in rs[3]["error"]
    assert not rs[4]["ok"] and "out" in rs[4]["error"]
    assert rs[5]["ok"]
