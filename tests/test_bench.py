"""Bench harness mechanics (CPU-only: no device, no big shapes).

The bench is certification infrastructure: a driver timeout must never
erase the record again (round 2 lost everything to one). These tests pin
the pieces that make that guarantee — incremental emits, budget gating,
the frontier search, covers caching, and baseline resolution order."""

import json

import numpy as np
import pytest

import bench


def test_make_covers_deterministic_and_cached(tmp_path, monkeypatch):
    monkeypatch.setattr(bench, "REPO", tmp_path)
    a = bench.make_covers(3, 32, 48)
    assert (tmp_path / ".cache" / "covers_3x32x48.npy").exists()
    b = bench.make_covers(3, 32, 48)  # served from cache
    np.testing.assert_array_equal(a, b)
    assert a.shape == (3, 32, 48, 3) and a.dtype == np.uint8
    # chunked generation must equal the historical one-shot draw (the
    # known-verified (cover, salt) pairs depend on these exact pixels)
    rng = np.random.default_rng(42)
    base = np.linspace(150, 235, 48)
    want = np.clip(base[None, None, :, None]
                   + rng.integers(-18, 19, (3, 32, 48, 3)), 0, 255)
    np.testing.assert_array_equal(a, want.astype(np.uint8))


def test_fits_budget_and_full_override(monkeypatch):
    import time

    monkeypatch.setattr(bench, "_BUDGET_T0", time.perf_counter() - 100.0)
    monkeypatch.setattr(bench, "BUDGET", 120.0)
    monkeypatch.setattr(bench, "FULL", False)
    assert bench.fits(10)          # 10 <= ~20 remaining
    assert not bench.fits(50)      # 50 > remaining
    monkeypatch.setattr(bench, "FULL", True)
    assert bench.fits(10**9)       # FULL ignores the budget


def test_budget_clock_reset_forgives_pre_headline_stall(monkeypatch):
    """r04's failure mode: a pre-headline stall blew the shared budget and
    every post-headline gate skipped. The clock reset makes gate decisions
    independent of pre-headline wall time."""
    import time

    monkeypatch.setattr(bench, "BUDGET", 120.0)
    monkeypatch.setattr(bench, "FULL", False)
    # simulate a 1,734 s stall before the headline
    monkeypatch.setattr(bench, "_BUDGET_T0", time.perf_counter() - 1734.0)
    assert not bench.fits(10)
    bench.budget_clock_reset()
    try:
        assert bench.fits(10)      # post-reset: full budget available
        assert not bench.fits(10**9)
    finally:
        bench._BUDGET_T0 = bench.T0


def test_stage_records_wall_time(monkeypatch):
    monkeypatch.setitem(bench.RESULT, "stage_wall_s", {})
    with bench.stage("unit_test_stage"):
        pass
    got = bench.RESULT["stage_wall_s"]["unit_test_stage"]
    assert isinstance(got, float) and got >= 0.0
    bench.RESULT.pop("stage_wall_s", None)


def test_device_record_refuses_cpu():
    """bench.py measures a GPU: on the CPU it stops before measuring."""
    with pytest.raises(SystemExit, match="measures a GPU"):
        bench.device_record()


def test_failed_stages_make_the_run_fail():
    rec = {"value": 1.0, "loop_error": "RuntimeError: x",
           "ber_error": "ValueError: y", "payload_ber_raw": 0.001}
    assert bench.failed_stages(rec) == ["ber_error", "loop_error"]
    assert bench.failed_stages({"value": 1.0}) == []


def test_emit_is_incremental_superset(capsys, monkeypatch):
    monkeypatch.setitem(bench.RESULT, "value", 1.0)
    bench.emit()
    bench.RESULT["extra_field"] = 7
    bench.emit()
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert len(lines) == 2
    assert "extra_field" not in lines[0]
    assert lines[1]["extra_field"] == 7
    assert set(lines[0]) <= set(lines[1])  # last line is the superset
    bench.RESULT.pop("extra_field")


@pytest.mark.parametrize(
    "threshold,expect",
    [
        (1536, 1536),   # pass up to 1536: search must find exactly 1536
        (512, 512),     # only the floor passes
        (16384, 16384), # everything passes: finds the ceiling
        (0, None),      # nothing passes
    ],
)
def test_frontier_search_converges(threshold, expect):
    probed = []

    def probe(n):
        probed.append(n)
        return {"secret_bytes": n} if n <= threshold else None

    got = bench._frontier_search(probe, lambda: True, lo=512, hi=16384,
                                 step=512, first=2048)
    if expect is None:
        assert got is None
    else:
        assert got["secret_bytes"] == expect
        assert got["search_exhausted"] is True
    assert len(probed) == len(set(probed)), "no size probed twice"
    assert len(probed) <= 8, probed  # gallop doublings + bisect of bracket


def test_frontier_search_banks_floor_first():
    """first=lo must bank a passing record on probe #1 (the whole point of
    the gallop ordering: a budget gate firing after one probe still leaves
    a non-null psnr_target_config), then expand upward by doubling."""
    probed = []

    def probe(n):
        probed.append(n)
        return {"secret_bytes": n} if n <= 1024 else None

    got = bench._frontier_search(probe, lambda: True, lo=512, hi=16384,
                                 step=512, first=512)
    assert probed[0] == 512                      # floor probed first
    assert got["secret_bytes"] == 1024
    assert got["search_exhausted"] is True
    # doubling, not bisection from the top: no probe above 2x the frontier
    assert max(probed) <= 2048, probed


def test_frontier_search_budget_stop_keeps_floor():
    """One allowed probe at first=lo → the floor record survives, not null."""
    budget = [1]

    def may_continue():
        budget[0] -= 1
        return budget[0] >= 0

    got = bench._frontier_search(
        lambda n: {"secret_bytes": n, "search_exhausted": False},
        may_continue, lo=512, hi=16384, step=512, first=512)
    assert got is not None and got["secret_bytes"] == 512
    assert got["search_exhausted"] is False


def test_frontier_search_budget_stop():
    budget = [2]  # allow exactly two probes

    def may_continue():
        budget[0] -= 1
        return budget[0] >= 0

    got = bench._frontier_search(
        lambda n: {"secret_bytes": n, "search_exhausted": False},
        may_continue, lo=512, hi=16384, step=512, first=2048)
    # best-so-far is returned, but NOT flagged exhausted (budget ran out)
    assert got is not None
    assert got["search_exhausted"] is False


def test_reference_baselines_resolution_order(tmp_path, monkeypatch):
    tracked = tmp_path / "BASELINE_MEASURED.json"
    legacy = tmp_path / ".cache" / "bench_baseline.json"
    legacy.parent.mkdir()
    monkeypatch.setattr(bench, "BASELINE_TRACKED", tracked)
    monkeypatch.setattr(bench, "BASELINE_CACHE", legacy)
    # nothing on disk, measurement disallowed -> honest nulls
    out = bench.reference_baselines("k", allow_measure=False)
    assert out["measured"] is False and out["spi_4096"] is None
    # legacy cache present -> served AND promoted to the tracked file
    legacy.write_text(json.dumps({"measured": True, "spi_512": 1.0,
                                  "psnr_512": 40.0, "spi_4096": 100.0,
                                  "psnr_4096": 45.0}))
    out = bench.reference_baselines("k", allow_measure=False)
    assert out["measured"] and tracked.exists()
    # unmeasured cached failures are never served
    tracked.write_text(json.dumps({"measured": False}))
    legacy.unlink()
    out = bench.reference_baselines("k", allow_measure=False)
    assert out["measured"] is False


def test_dist_record_median_and_spread():
    d = bench.dist_record([10.0, 30.0, 20.0])
    assert d == {"median": 20.0, "min": 10.0, "max": 30.0, "n": 3}
    d1 = bench.dist_record([181.25])
    assert d1["median"] == d1["min"] == d1["max"] == 181.25
    assert d1["n"] == 1
