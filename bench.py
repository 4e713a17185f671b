"""Benchmark: batched 4K-UHD embed+extract round-trips per second, one GPU.

Prints a JSON line {"metric", "value", "unit", "vs_baseline", ...} — and
prints it INCREMENTALLY: the headline measurement is taken first and a
complete JSON line is flushed immediately; every later stage re-prints the
(superset) line with its fields added. The LAST line on stdout is always the
most complete record, and a timeout mid-run still captures everything
measured so far. A SIGTERM handler additionally flushes the current
snapshot on a best-effort basis. The record names the device (platform,
device_kind, count, nvidia-smi name and power limit). The bench fails,
rather than degrading, without a GPU, without the native library, or on a
device missing from the peak table; a stage that raised makes the process
exit non-zero after the last record.

Stages after the headline are wall-clock-budgeted (STEGANOSAURUS_BENCH_BUDGET
seconds, default 500). The budget CLOCK STARTS AT THE HEADLINE, not at
process start, so set-up cost (build, compile, upload) is recorded
(stage_wall_s) but never charged against certification. Two gate tiers:

- CORE certifications (loop, BER, PSNR/SSIM, rotating-salt, RS mode, MFU/
  roofline, pow2-4096, 1080p, 512px) ALWAYS run — a blown budget reduces
  their repeat counts, never skips them (a headline-only record certifies
  almost nothing).
- The frontier searches stay budget-gated (open-ended probe loops).

Every stage's wall time lands in the record's "stage_wall_s" map, so a
stall is attributable from the JSON alone (stderr notes are truncated by
the driver's tail capture). STEGANOSAURUS_BENCH_FULL=1 ignores the budget
and runs everything at full repeats.

Headline metric (BASELINE.json north star): 4K UHD (2160x3840) batched
embed+extract with 16 KB payloads, payload recovery verified (AEAD tag)
every iteration.

Baseline: the reference C++ binary CANNOT round-trip 4K UHD at all — it
pads to pow2 and crops the IFFT, which corrupts the written phases on every
non-pow2 image ("Magic not found", verified directly; see spectral.fft_dims).
The honest baseline is therefore the largest image class it CAN round-trip:
4096x4096 (pow2, 2x the UHD pixel count), measured live once and persisted
in BASELINE_MEASURED.json (a reference round-trip takes ~4 min of
single-core C++; the measurement is tracked so certified runs never re-pay
it). Comparison is apples-to-apples on the pipeline itself: both sides run
raw-master-key mode (PBKDF2 is a user-tunable stretching cost; the
reference's own docs put it at ~99% of runtime, doc/SUMMARY.md:95).
"""

from __future__ import annotations

import base64
import json
import os
import pathlib
import signal
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = pathlib.Path(__file__).resolve().parent
REF_SRC = pathlib.Path("/root/reference/steganosaurus")
REF_BUILD = REPO / "build_ref"
BASELINE_CACHE = REPO / ".cache" / "bench_baseline.json"
BASELINE_TRACKED = REPO / "BASELINE_MEASURED.json"

# Headline config: 4K UHD, 16 KB payloads (BASELINE.json config 3).
# Batch 64: dispatch/launch overhead amortizes further over the batch —
# measured serialized loop 350 ms (183 img/s) at B=64 vs 209 ms (153) at
# B=32, stream 218-231 vs 183 img/s; all 64 fixed (cover, salt) pairs
# verify recovery (no HBM pressure: ~7 GB peak of 16).
UHD_H, UHD_W = 2160, 3840
UHD_BASE_BATCH = 32   # the disk-cached, known-verified cover set
UHD_BATCH = 64
UHD_SECRET = 16 * 1024
UHD_ITERS = 3

# Secondary config (continuity with earlier rounds)
SMALL = 512
SMALL_BATCH = 16
SMALL_SECRET = 100
SMALL_ITERS = 4

# Tertiary: BASELINE config 2 (1080p, multi-KB payloads)
FHD_H, FHD_W = 1080, 1920
FHD_BATCH = 32
FHD_SECRET = 4 * 1024
FHD_ITERS = 3

# Same-workload baseline comparison: 4096^2 pow2, the largest class the
# reference can round-trip, at the same 2 KB payload its baseline
# measurement uses — vs_baseline_same_size divides like for like.
P2_N = 4096
P2_BATCH = 8
P2_SECRET = 2000
P2_ITERS = 2

T0 = time.perf_counter()
BUDGET = float(os.environ.get("STEGANOSAURUS_BENCH_BUDGET", "500"))
FULL = os.environ.get("STEGANOSAURUS_BENCH_FULL") == "1"
# The budget clock origin. Reset to "now" when the headline measurement
# starts (budget_clock_reset below): pre-headline environment stalls are
# recorded but not charged against the certification stages.
_BUDGET_T0 = T0

# The evolving record. Emitted (full line, flushed) after every stage.
RESULT: dict = {
    "metric": "embed_extract_4k_uhd_images_per_sec",
    "value": None,
    "unit": "images/sec/chip",
    "vs_baseline": None,
}
_EMITTED = False

# Per-frontier-search failure evidence (cleared by psnr_frontier, attached
# to the record by main when a search returns None): a null frontier field
# must explain itself.
LAST_FRONTIER_DIAG: list = []

# Frontier cover batch, device-resident, shared by all psnr_frontier calls.
_FRONTIER_COVERS: dict = {}


def emit():
    global _EMITTED
    _EMITTED = True
    print(json.dumps(RESULT), flush=True)


def _on_term(signum, frame):  # best-effort snapshot on driver timeout
    RESULT["truncated_by_signal"] = int(signum)
    try:
        emit()
    finally:
        sys.stdout.flush()
        os._exit(3)


def note(msg: str) -> None:
    """Progress marker on stderr: a timed-out run's log shows exactly which
    phase ate the budget."""
    print(f"[bench +{time.perf_counter() - T0:7.1f}s] {msg}",
          file=sys.stderr, flush=True)


def remaining() -> float:
    return BUDGET - (time.perf_counter() - _BUDGET_T0)


def fits(estimate_s: float) -> bool:
    return FULL or remaining() >= estimate_s


def budget_clock_reset() -> None:
    """Start charging the stage budget from NOW (called when the headline
    measurement begins). Whatever wall time the environment ate before
    this point is attributed in stage_wall_s, not billed to the gates."""
    global _BUDGET_T0
    _BUDGET_T0 = time.perf_counter()


class stage:
    """Timed stage context: notes the start on stderr and records the
    stage's wall seconds into RESULT["stage_wall_s"][name] — the in-record
    attribution (stderr notes are truncated by the
    driver's tail capture, so a stall must be explicable from the JSON)."""

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        note(self.name)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        RESULT.setdefault("stage_wall_s", {})[self.name] = round(
            time.perf_counter() - self.t0, 1)
        return False


def dist_record(samples: list[float]) -> dict:
    """{median,min,max,n} of a throughput sample list: every throughput
    metric carries its spread, not a point."""
    return {"median": round(float(np.median(samples)), 3),
            "min": round(min(samples), 3),
            "max": round(max(samples), 3),
            "n": len(samples)}


def make_covers(B: int, h: int, w: int) -> np.ndarray:
    """Deterministic bench covers (seed 42), disk-cached (generating the
    4K batch is minutes of single-core numpy). Generation is chunked per
    image only to bound the int64 scratch."""
    path = REPO / ".cache" / f"covers_{B}x{h}x{w}.npy"
    if path.exists():
        return np.load(path)
    rng = np.random.default_rng(42)
    base = np.linspace(150, 235, w)
    rows = []
    for _ in range(B):
        noise = rng.integers(-18, 19, (h, w, 3))
        rows.append(np.clip(base[None, :, None] + noise, 0, 255)
                    .astype(np.uint8))
    out = np.stack(rows)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.save(path, out)
    return out


def build_reference() -> pathlib.Path | None:
    exe = REF_BUILD / "turtlefft"
    if exe.exists():
        return exe
    if not REF_SRC.exists():
        return None
    try:
        REF_BUILD.mkdir(exist_ok=True)
        subprocess.run(
            ["cmake", "-S", str(REF_SRC), "-B", str(REF_BUILD), "-G", "Ninja",
             "-DCMAKE_BUILD_TYPE=Release"], check=True, capture_output=True)
        subprocess.run(["ninja", "-C", str(REF_BUILD)], check=True,
                       capture_output=True)
    except (subprocess.CalledProcessError, FileNotFoundError):
        return None
    return exe if exe.exists() else None


def bench_reference(exe: pathlib.Path, cover: np.ndarray, secret: bytes,
                    key_b64: str, reps: int = 3) -> tuple[float, float] | None:
    """(Seconds per embed+extract round-trip, stego PSNR dB) via the
    reference binary on the given cover."""
    from PIL import Image

    with tempfile.TemporaryDirectory() as td:
        cp = f"{td}/cover.png"
        sp = f"{td}/stego.png"
        Image.fromarray(cover).save(cp)
        txt = secret.decode()
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            r1 = subprocess.run(
                [str(exe), "embed", "--in", cp, "--out", sp, "--secret", txt,
                 "--key", key_b64], capture_output=True)
            r2 = subprocess.run(
                [str(exe), "extract", "--in", sp, "--key", key_b64],
                capture_output=True)
            times.append(time.perf_counter() - t0)
            if r1.returncode or r2.returncode or txt.encode() not in r2.stdout:
                return None
        st = np.asarray(Image.open(sp)).astype(np.float64)
        mse = float(np.mean(np.square(st - cover.astype(np.float64))))
        psnr = 10.0 * np.log10(255.0 * 255.0 / mse) if mse > 0 else float("inf")
        return min(times), psnr


def reference_baselines(key_b64: str, allow_measure: bool) -> dict:
    """Measured reference numbers. Resolution order: tracked
    BASELINE_MEASURED.json (committed after the first successful live
    measurement — certified runs must not re-pay ~4 min of single-core
    C++), then the legacy .cache file, then a live measurement if
    `allow_measure` (budget permitting). No invented numbers, ever: a
    guessed baseline in the headline ratio is worse than no ratio."""
    for path in (BASELINE_TRACKED, BASELINE_CACHE):
        if path.exists():
            try:
                cached = json.loads(path.read_text())
                if cached.get("measured"):
                    if path is BASELINE_CACHE:  # promote to the tracked file
                        BASELINE_TRACKED.write_text(json.dumps(cached))
                    return cached
            except json.JSONDecodeError:
                pass
    out = {"measured": False, "spi_512": None, "psnr_512": None,
           "spi_4096": None, "psnr_4096": None}
    if not allow_measure:
        return out
    exe = build_reference()
    if exe is None:
        return out
    small = bench_reference(exe, make_covers(1, SMALL, SMALL)[0],
                            b"A" * SMALL_SECRET, key_b64, reps=3)
    big = bench_reference(exe, make_covers(1, 4096, 4096)[0],
                          b"A" * 2000, key_b64, reps=1)
    if small and big:
        out = {"measured": True,
               "spi_512": small[0], "psnr_512": small[1],
               "spi_4096": big[0], "psnr_4096": big[1]}
        BASELINE_TRACKED.write_text(json.dumps(out))
        BASELINE_CACHE.parent.mkdir(parents=True, exist_ok=True)
        BASELINE_CACHE.write_text(json.dumps(out))
    return out




class Workload:
    """One (shape, batch, secret_len) workload with its device-resident
    covers and jitted step; lets the stages of a measurement be interleaved
    with emits instead of bundled into one long function."""

    def __init__(self, h, w, batch, secret_len, master_key, covers=None,
                 salts=None, covers_base=None, params=None, covers_d=None):
        import jax
        import jax.numpy as jnp

        from steganosaurus_jax.config import Params

        self.h, self.w, self.batch, self.secret_len = h, w, batch, secret_len
        self.master_key = master_key
        self.p = Params() if params is None else params
        rng = np.random.default_rng(7)
        self.secrets = [bytes(rng.integers(0, 256, secret_len, dtype=np.uint8))
                        for _ in range(batch)]
        self.salts = (salts if salts is not None
                      else [bytes([i]) * 16 for i in range(batch)])
        # Serving layout: covers live on device in (B, 3, H, W) —
        # layout="nchw" skips two strided u8 relayouts per round-trip (the
        # one-time transpose below is paid at ingest, exactly like a
        # production pipeline would).
        if covers_d is not None:
            # share another workload's device-resident (B, 3, H, W) covers —
            # zero additional upload
            self.covers = covers if covers is not None else None
            self.covers_d = covers_d
        elif covers_base is not None:
            # batch > base set: upload the base ONCE and tile ON DEVICE —
            # halves the upload (1.6 GB -> 0.8 GB at 4K/B=64). Every image
            # still gets a DISTINCT salt, hence distinct AEAD bits, walk
            # writes, and quantization noise — duplicate cover pixels
            # lighten no stage of the pipeline.
            reps = -(-batch // covers_base.shape[0])
            self.covers = covers_base
            self.covers_d = jax.jit(lambda a: jnp.transpose(
                jnp.concatenate([a] * reps)[:batch], (0, 3, 1, 2)))(
                jax.device_put(covers_base))
        else:
            self.covers = make_covers(batch, h, w) if covers is None else covers
            self.covers_d = jax.jit(lambda a: jnp.transpose(a, (0, 3, 1, 2)))(
                jax.device_put(self.covers))
        self.covers_d.block_until_ready()

    def step(self):
        from steganosaurus_jax.pipeline.batch import embed_batch, extract_batch

        res = embed_batch(self.covers_d, self.secrets,
                          master_key=self.master_key, params=self.p,
                          salts=self.salts, device_resident=True,
                          layout="nchw")
        got = extract_batch(res.stego, master_key=self.master_key,
                            params=self.p, clen_hint=self.secret_len,
                            layout="nchw")
        assert got == self.secrets, "payload recovery failed"
        return res.stego

    def stream_ips(self, iters: int, salts_for_iter=None) -> tuple[float, float]:
        """(images/sec, recovery_rate) over the pipelined serving path
        (pipeline.stream) — batch N+1's host AEAD/packing and dispatch
        overlap batch N's device graphs, which hides host time.

        salts_for_iter(k) -> per-iteration salts enables the rotating-salt
        honesty variant (fresh AEAD bits every batch). Recovery is COUNTED,
        not asserted, and returned as a rate."""
        from steganosaurus_jax.pipeline import stream as pstream

        mk, p = self.master_key, self.p
        salt_fn = salts_for_iter or (lambda k: self.salts)
        n_ok = n_tot = 0
        t0 = time.perf_counter()
        embeds = pstream.embed_stream(
            ((self.covers_d, self.secrets, salt_fn(k)) for k in range(iters)),
            master_key=mk, params=p, depth=2, layout="nchw")
        for got in pstream.extract_stream((r.stego for r in embeds),
                                          master_key=mk, params=p,
                                          clen_hint=self.secret_len, depth=2,
                                          layout="nchw"):
            n_ok += sum(g == s for g, s in zip(got, self.secrets))
            n_tot += self.batch
        dt = time.perf_counter() - t0
        return (self.batch * iters) / dt, n_ok / n_tot

    def loop_ips(self, iters: int) -> float:
        """Strictly serialized embed->extract round-trip loop (latency-
        shaped: every dispatch gap lands on the critical path)."""
        t0 = time.perf_counter()
        for _ in range(iters):
            self.step()
        return (self.batch * iters) / (time.perf_counter() - t0)

    def quality(self, stego_d) -> tuple[float, float]:
        """PSNR and SSIM over the WHOLE batch, entirely on device
        (utils.metrics.quality_device): one jitted reduction, no stego
        pull."""
        from steganosaurus_jax.utils import metrics

        return metrics.quality_device(self.covers_d, stego_d)

    def ber(self, stego_d) -> dict:
        from steganosaurus_jax.pipeline.batch import channel_report

        return channel_report(stego_d, self.secrets, self.salts,
                              master_key=self.master_key, params=self.p,
                              layout="nchw")


def psnr_frontier(master_key: bytes, probe_cost_s: float = 45.0,
                  soft: bool = False, alpha: float = 0.5,
                  qim: int = 0) -> dict | None:
    """Binary-search the LARGEST 4K-UHD payload meeting the BASELINE
    imperceptibility bar (PSNR > 50 dB, SSIM > 0.995) with AEAD-verified
    recovery (verify mode re-salts failures, so recovery is deterministic
    when it converges).

    The headline 16 KB config trades imperceptibility for payload density —
    the write sets a bin's phase to +-alpha regardless of its current
    (uniform) phase, so the per-bin delta is ~mag*O(1) INDEPENDENT of alpha;
    PSNR moves ~6 dB per payload halving and essentially not at all with
    alpha (measured; doc/ATTACKS.md §1 derives the footprint formula). The
    search is over payload size at the default alpha=0.5 (full noise
    margin), quantized to 512-byte steps (each distinct ECC bucket is a
    fresh 4K XLA module; coarse steps bound compile count). Budget-gated
    per probe; returns the best bar-meeting config found, flagged
    `search_exhausted` when the bracket closed."""
    import jax

    from steganosaurus_jax.config import Params
    from steganosaurus_jax.pipeline.batch import embed_batch
    from steganosaurus_jax.utils import metrics

    LAST_FRONTIER_DIAG.clear()
    rng = np.random.default_rng(13)
    B, STEP, ALPHA = 4, 512, alpha
    # first 4 of the cached base cover set (same seed/order as the headline),
    # built/uploaded ONCE across the four frontier stages: the rebuild cost
    # before the first budget-gate check ate the psnr_target stage's whole
    # window in the 2026-08-18 run (gate closed before any probe ran).
    covers_d = _FRONTIER_COVERS.get(B)
    if covers_d is None:
        covers = np.ascontiguousarray(make_covers(UHD_BASE_BATCH, UHD_H,
                                                  UHD_W)[:B])
        covers_d = _FRONTIER_COVERS[B] = jax.device_put(covers)

    def probe(nbytes: int):
        p = Params(alpha=ALPHA, soft_write=soft, qim=qim)
        secrets = [bytes(rng.integers(0, 256, nbytes, dtype=np.uint8))
                   for _ in range(B)]
        res = embed_batch(covers_d, secrets, master_key=master_key, params=p,
                          device_resident=True, verify=True, max_retries=4)
        if not all(res.verified):
            # A null frontier with no explanation certified nothing in the
            # 2026-08-18 run — record WHICH images failed verification so a
            # failing record is still evidence (standalone re-runs of the
            # same probe pass 3/3; see doc/TODO.md).
            LAST_FRONTIER_DIAG.append(
                {"secret_bytes": nbytes, "fail": "verify",
                 "verified": list(res.verified)})
            return None
        psnr, ssim = metrics.quality_device(covers_d, res.stego)
        if psnr <= 50.0 or ssim <= 0.995:
            LAST_FRONTIER_DIAG.append(
                {"secret_bytes": nbytes, "fail": "bar",
                 "psnr_db": round(psnr, 2), "ssim": round(ssim, 4)})
        return psnr, ssim

    cost = [probe_cost_s]

    def timed_probe(nbytes: int) -> dict | None:
        t_probe = time.perf_counter()
        q = probe(nbytes)
        # Adapt the cost estimate: each distinct payload bucket is a fresh
        # 4K XLA module, and a cold compile is minutes, not seconds.
        cost[0] = max(cost[0], 1.1 * (time.perf_counter() - t_probe))
        if q is not None and q[0] > 50.0 and q[1] > 0.995:
            out = {"alpha": ALPHA, "secret_bytes": nbytes,
                   "psnr_db": round(q[0], 2), "ssim": round(q[1], 4),
                   "recovery_verified": True, "search_exhausted": False}
            if soft:
                out["soft_write"] = True
            if qim:
                out["qim"] = qim
            return out
        return None

    # First probe at the MEASURED bar-meeting payload — 512 B hard
    # (50.07 dB / 0.9977), 1024 B soft (51.18 dB / 0.9982; the soft write's
    # ~2.8x energy cut buys ~+3.7 dB, doc/ATTACKS.md §1a) — banking a
    # passing record on the very first probe, before the budget gate can
    # fire (round 2's first-probe-at-2KB ordering burned the whole budget
    # on failing sizes and recorded null). The gallop then expands upward.
    # low-alpha soft: the SOFT write's energy scales with alpha (only
    # boundary-violating bins move, by ~alpha), unlike the hard write —
    # measured 2 KB at 50.5 dB / 0.9980 with alpha=0.15 (4x the hard
    # frontier). First probe starts there.
    first = STEP
    if soft:
        first = 4 * STEP if ALPHA < 0.25 else 2 * STEP
    if qim:
        # QIM energy is Delta^2/12 per bin vs the hard write's ~pi^2/3
        # (doc/ATTACKS.md §1b): at L=6 that is ~15 dB, worth ~2^5 payload
        # steps over the 512 B hard frontier. Measured 2026-08-18 (4K/B=4):
        # L=6 16 KB = 48.79 dB (under), L=8 = 50.90, L=10 = 52.43 dB with
        # verified recovery — the FULL 16 KB headline payload clears the bar
        # at L>=8. First probe goes straight to the headline size so one
        # probe banks the frontier before any budget gate can fire.
        first = (32 if qim >= 8 else 8) * STEP
    return _frontier_search(timed_probe, lambda: fits(cost[0]),
                            lo=STEP, hi=UHD_SECRET, step=STEP, first=first)


def _frontier_search(probe, may_continue, lo: int, hi: int, step: int,
                     first: int) -> dict | None:
    """Pure exponential-then-binary search over step-quantized payloads.

    probe(n) returns a bar-meeting config dict or None; may_continue() is
    the budget gate, checked before every probe. While probes pass the
    candidate DOUBLES (galloping: each probe both banks a better record and
    halves the log-distance to the frontier); the first failure switches to
    bisection of the remaining bracket. Invariant: every size in [lo, hi]
    is undecided; a pass moves lo up, a fail moves hi down. The returned
    best (largest passing) config carries search_exhausted=True only if
    the bracket closed rather than the budget running out."""
    best: dict | None = None
    galloping = True
    cand = min(max(first, lo), hi)
    while True:
        if not may_continue():
            break
        q = probe(cand)
        if q is not None:
            best = q
            lo = cand + step
        else:
            hi = cand - step
            galloping = False
        if lo > hi:
            if best is not None:
                best["search_exhausted"] = True
            break
        if galloping:
            cand = min(2 * cand // step * step, hi // step * step)
        else:
            cand = max((lo + hi) // 2 // step * step, step)
        cand = max(cand, lo)
    return best


def failed_stages(record: dict) -> list[str]:
    """The `*_error` fields a stage left in the record (sorted)."""
    return sorted(k for k in record if k.endswith("_error"))


def device_record() -> dict:
    """The device the record was measured on. Fails without a GPU."""
    import jax

    d = jax.devices()[0]
    if d.platform != "gpu":
        raise SystemExit(f"bench.py measures a GPU; JAX found {d.platform!r}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    name, _, limit = card.partition(",")
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices()), "name": name.strip(),
            "power_limit": limit.strip()}


def main():
    from steganosaurus_jax import _native_loader, runtime
    from steganosaurus_jax.utils import metrics

    signal.signal(signal.SIGTERM, _on_term)
    signal.signal(signal.SIGINT, _on_term)
    runtime.enable_compilation_cache()
    device = device_record()
    peaks = metrics.device_peaks(device["kind"])
    # The C++ walk expander is a build artifact; without it the fresh-key
    # turtle expansion runs in pure Python (~1000x slower).
    with stage("native_build"):
        if _native_loader.ensure_built() is None:
            raise SystemExit("native library did not build or load")
    master_key = bytes(range(32))
    key_b64 = base64.b64encode(master_key).decode()

    # Baseline first: tracked-file read is instant; a live measurement is
    # allowed only when the budget safely covers ~4 min of C++ plus the
    # headline (i.e. effectively only under STEGANOSAURUS_BENCH_FULL).
    with stage("reference_baseline"):
        ref = reference_baselines(key_b64, allow_measure=fits(600))
    ref_4096_ips = (1.0 / ref["spi_4096"]) if ref["measured"] else None

    # ---- HEADLINE: 4K UHD pipelined stream, fixed known-verified salts ----
    with stage("uhd_build_upload"):
        uhd = Workload(UHD_H, UHD_W, UHD_BATCH, UHD_SECRET, master_key,
                       covers_base=make_covers(UHD_BASE_BATCH, UHD_H, UHD_W),
                       # measured: all 64 (cover, salt) pairs recover raw
                       salts=[bytes([i % 256, i // 256]) * 8
                              for i in range(UHD_BATCH)])
    with stage("uhd_warmup_step"):
        stego_d = uhd.step()  # warmup + compile + correctness (recovery
        #                       asserted inside)
    # Everything before this line is set-up cost (build, compile, upload) —
    # attribute it (stage_wall_s) but do not bill it to the stages below.
    budget_clock_reset()
    RESULT["pre_headline_wall_s"] = round(time.perf_counter() - T0, 1)
    # 3 samples ALWAYS (headline = median). The only escape is a sample
    # slower than 180 s, at which point more samples measure a stall, not
    # the pipeline.
    hd_samples = []
    with stage("headline_stream_x3"):
        for j in range(3):
            t_s = time.perf_counter()
            uhd_ips, rec = uhd.stream_ips(UHD_ITERS)
            assert rec == 1.0, "headline recovery failed"
            hd_samples.append(uhd_ips)
            if not FULL and time.perf_counter() - t_s > 180 and j < 2:
                RESULT["headline_samples_truncated"] = (
                    f"sample {j + 1} exceeded 180s")
                break
    uhd_ips = float(np.median(hd_samples))
    RESULT.update({
        "metric": "embed_extract_4k_uhd_images_per_sec",
        "value": round(uhd_ips, 3),
        "value_dist": dist_record(hd_samples),
        "vs_baseline": (round(uhd_ips / ref_4096_ips, 1)
                        if ref_4096_ips else None),
        "baseline_4096px_images_per_sec": (round(ref_4096_ips, 5)
                                           if ref_4096_ips else None),
        "baseline_4k_uhd": "fails: reference cannot round-trip non-pow2 "
                           "images (pad+crop corrupts phases)",
        "baseline_measured": ref["measured"],
        "batch": UHD_BATCH,
        "secret_bytes": UHD_SECRET,
        "recovery_verified": True,
        # The headline reuses fixed known-verified (cover, salt) pairs every
        # iteration: walk/table/statics caches are steady-state warm (as in
        # real serving under one key); host AEAD still runs per image. The
        # rotating-salt variant below pays fresh AEAD bits per batch.
        "steady_state_caches": True,
        # extraction ran with the default soft-decision fallback available
        # (it only engages on AEAD failures; headline recovery is verified
        # either way)
        "soft_decode_fallback": True,
        "device": device,
        "bench_budget_s": BUDGET,
    })
    emit()  # certified headline is on stdout from this point on

    # ---- CORE certifications: never skipped. A blown budget reduces
    # repeat counts below, not coverage. ----

    # ---- serialized loop (latency-shaped secondary) ----
    with stage("loop"):
        try:
            RESULT["loop_images_per_sec"] = round(uhd.loop_ips(UHD_ITERS), 3)
        except Exception as e:  # noqa: BLE001 — a failed extra must not
            RESULT["loop_error"] = f"{type(e).__name__}: {e}"  # kill the rec
    emit()

    # ---- channel quality: BER on the final stego batch ----
    with stage("ber"):
        try:
            ber = uhd.ber(stego_d)
            RESULT.update({
                "payload_ber_raw": round(ber["payload_ber_raw"], 6),
                "payload_ber_post_ecc": round(ber["payload_ber_post_ecc"], 6),
                "header_ber_raw": round(ber["header_ber_raw"], 6),
            })
        except Exception as e:  # noqa: BLE001
            RESULT["ber_error"] = f"{type(e).__name__}: {e}"
    emit()

    # ---- PSNR/SSIM of the headline stego batch ----
    with stage("psnr_ssim"):
        try:
            psnr, ssim = uhd.quality(stego_d)
            RESULT["stego_psnr_db"] = round(psnr, 2)
            RESULT["stego_ssim"] = round(ssim, 4)
        except Exception as e:  # noqa: BLE001
            RESULT["quality_error"] = f"{type(e).__name__}: {e}"
    emit()

    # ---- rotating-salt stream (honesty variant: fresh AEAD every batch).
    # Repeated up to 5x (budget-gated per repeat) and recorded as a
    # DISTRIBUTION: the scalar field is the median, the _dist field carries
    # {median,min,max,n}. ----
    with stage("rotating_salt"):
        try:
            rot_samples, rot_recs = [], []
            for j in range(5):
                # core stage: the FIRST sample always runs; repeats 2-5
                # are budget-gated (a blown budget reduces n, never to 0)
                if j and not fits(25):
                    break
                rot_ips, rot_rec = uhd.stream_ips(
                    UHD_ITERS,
                    salts_for_iter=lambda k: [
                        bytes([i % 256, 200 + (37 * j + k) % 56]) * 8
                        for i in range(UHD_BATCH)])
                rot_samples.append(rot_ips)
                rot_recs.append(rot_rec)
            rot_dist = dist_record(rot_samples)
            RESULT["rotating_salt_images_per_sec"] = rot_dist["median"]
            RESULT["rotating_salt_images_per_sec_dist"] = rot_dist
            RESULT["rotating_salt_recovery_rate"] = round(
                float(np.mean(rot_recs)), 4)
            RESULT["rotating_salt_meets_100ips_bar"] = bool(
                min(rot_samples) >= 100.0)
        except Exception as e:  # noqa: BLE001
            RESULT["rotating_salt_error"] = f"{type(e).__name__}: {e}"
    emit()

    # ---- RS wire mode on the headline workload (Params.rs: interleaved
    # RS(255,223) payload FEC, ops/rs.py). Same 4K/B=64/16 KB job, ~6.1x
    # fewer written bins (151k vs 919k frame bits) -> smaller walk,
    # gathers, and write energy. Reference-incompatible wire (flag 0x02,
    # its binary fails closed), so it is a SECONDARY record: the headline
    # stays on the reference-compatible Rep-7 frame. Runs right after
    # rotating-salt so the budget gate cannot starve it. Shares
    # uhd.covers_d; its device working set is freed in `finally`, before
    # the frontier stages allocate theirs. ----
    with stage("rs_wire_mode"):
        rsw = rs_stego = None
        try:
            from steganosaurus_jax.config import Params

            rsw = Workload(UHD_H, UHD_W, UHD_BATCH, UHD_SECRET, master_key,
                           salts=uhd.salts, covers_d=uhd.covers_d,
                           params=Params(rs=True))
            rs_stego = rsw.step()  # compile + recovery assert
            rs_samples, rs_recs = [], []
            for j in range(5):
                # core stage: first sample unconditional, repeats gated
                if j and not fits(10):
                    break
                rs_ips, rs_rec = rsw.stream_ips(UHD_ITERS)
                rs_samples.append(rs_ips)
                rs_recs.append(rs_rec)
            rs_dist = dist_record(rs_samples)
            psnr, ssim = rsw.quality(rs_stego)
            RESULT.update({
                "rs_mode_images_per_sec": rs_dist["median"],
                "rs_mode_images_per_sec_dist": rs_dist,
                "rs_mode_recovery_rate": round(float(np.mean(rs_recs)), 4),
                "rs_mode_meets_100ips_bar": bool(min(rs_samples) >= 100.0),
                "rs_mode_psnr_db": round(psnr, 2),
                "rs_mode_ssim": round(ssim, 4),
            })
        except Exception as e:  # noqa: BLE001
            RESULT["rs_mode_error"] = f"{type(e).__name__}: {e}"
        finally:
            rsw = rs_stego = None
    emit()

    # ---- MFU / roofline accounting: compiler-counted FLOPs and HBM bytes
    # of the EXACT dispatched headline modules (utils/cost.py lowers the
    # same lru-cached constructors the pipeline uses), over the device-step
    # wall time (block_until_ready), against the device's published peaks
    # (utils/metrics.DEVICE_PEAKS); host-link traffic vs a measured
    # host<->device copy rate. ----
    with stage("mfu_roofline"):
        try:
            from steganosaurus_jax.utils import cost as cost_mod

            note("cost model: counting the dispatched modules")
            rc = cost_mod.roundtrip_cost(UHD_BATCH, UHD_H, UHD_W, UHD_SECRET)
            note("device-step timing")
            dstep = cost_mod.measure_device_step(
                uhd.covers_d, master_key, UHD_SECRET, reps=2)
            note("host-link ceiling probe")
            link = cost_mod.measure_link(nbytes=1 << 26, reps=2)
            flops = rc["embed_flops"] + rc["extract_flops"]
            hbm_b = rc["embed_hbm_bytes"] + rc["extract_hbm_bytes"]
            dt = dstep["device_roundtrip_s"]
            g = rc["geometry"]
            ips = RESULT["value"]
            up_bps = ips * 4 * g["stream_words_per_image"]
            down_bps = ips * 4 * g["hard_words_per_image"]
            # with per-image cover ingest + stego egress un-amortized
            up_ing = up_bps + ips * 3 * UHD_H * UHD_W
            down_ing = down_bps + ips * 3 * UHD_H * UHD_W
            RESULT.update({
                "mfu_pct": round(
                    100.0 * flops / (dt * peaks["bf16_flops_per_s"]), 3),
                "hbm_utilization_pct": round(
                    100.0 * hbm_b / (dt * peaks["hbm_bytes_per_s"]), 1),
                "roundtrip_gflops_per_image": round(
                    flops / UHD_BATCH / 1e9, 2),
                "roundtrip_hbm_mbytes_per_image": round(
                    hbm_b / UHD_BATCH / 1e6, 1),
                "device_roundtrip_ms_per_batch": round(dt * 1e3, 1),
                "device_only_images_per_sec": round(UHD_BATCH / dt, 1),
                "link_up_mbytes_per_sec": round(
                    link["up_bytes_per_sec"] / 1e6, 1),
                "link_down_mbytes_per_sec": round(
                    link["down_bytes_per_sec"] / 1e6, 1),
                # steady-state serving traffic (covers/stego device-resident)
                "link_utilization": round(max(
                    up_bps / link["up_bytes_per_sec"],
                    down_bps / link["down_bytes_per_sec"]), 4),
                # if every image's cover+stego crossed the link un-amortized
                "link_utilization_with_ingest": round(max(
                    up_ing / link["up_bytes_per_sec"],
                    down_ing / link["down_bytes_per_sec"]), 3),
            })
        except Exception as e:  # noqa: BLE001
            RESULT["mfu_error"] = f"{type(e).__name__}: {e}"
    emit()

    # Free the 4K working set (covers 1.6 GB + stego 1.6 GB + jitted
    # closures) before the frontier/secondary stages allocate theirs.
    del uhd, stego_d

    def frontier_stage(key: str, est: float, retries: int = 0, **kw) -> None:
        """One budget-gated psnr_frontier stage. On a null result the probe
        failure evidence (LAST_FRONTIER_DIAG) is attached as `<key>_diag`,
        and verify-flake failures are retried up to `retries` times (fresh
        salts each embed — the 2026-08-18 run recorded a bare null that
        standalone re-runs could not reproduce; never record null without
        either evidence or a retry)."""
        if not fits(est):
            RESULT.setdefault("stage_wall_s", {})[key] = "skipped (budget)"
            return
        with stage(key):
            try:
                out = psnr_frontier(master_key, **kw)
                for _ in range(retries):
                    if out is not None or not fits(est):
                        break
                    note(f"{key} retry; diag={LAST_FRONTIER_DIAG}")
                    out = psnr_frontier(master_key, **kw)
                RESULT[key] = out
                if out is None and LAST_FRONTIER_DIAG:
                    RESULT[key + "_diag"] = list(LAST_FRONTIER_DIAG)
            except Exception as e:  # noqa: BLE001
                RESULT[key.replace("_config", "_error")] = (
                    f"{type(e).__name__}: {e}")
        emit()

    # ---- QIM frontier (params.qim: dithered phase QIM payload write,
    # energy Delta^2/12 per bin at margin pi/(2L) — doc/ATTACKS.md §1b;
    # also the histogram-uniform stealth mode, §2b). L=10 is the measured
    # sweet spot: the full 16 KB headline payload at 52.43 dB / 0.9987
    # (L=8 passes at 50.90; L=6 misses at 48.79). Runs FIRST of the
    # frontier stages: it is the one that certifies the headline payload
    # meeting the >50 dB bar, and its single 16 KB probe banks the record
    # (the others' values are already certified in earlier round records
    # and re-certify when budget allows). ----
    frontier_stage("psnr_qim_config", 60, retries=1, qim=10)

    # ---- imperceptibility frontier (PSNR>50dB/SSIM>0.995 max payload) ----
    frontier_stage("psnr_target_config", 60)

    # ---- soft-write frontier (params.soft_write: minimal-energy write,
    # ~2.8x less energy at the same decode margin — doc/ATTACKS.md §1a) ----
    frontier_stage("psnr_soft_config", 90, soft=True)

    # ---- low-alpha soft frontier (soft write energy ~ alpha: doc/ATTACKS
    # §1a; soft-decision fallback covers the reduced noise margin) ----
    frontier_stage("psnr_soft_low_alpha_config", 90, soft=True, alpha=0.15)

    # Frontier covers (cached across the 4 stages above to avoid repeated
    # uploads) are dead weight for the remaining workloads — free them.
    _FRONTIER_COVERS.clear()

    # ---- identical workload to the reference baseline (4096^2, 2 KB):
    # core — the apples-to-apples vs_baseline_same_size ratio must not
    # fall out of the record ----
    with stage("pow2_4096"):
        p2 = None
        try:
            p2 = Workload(P2_N, P2_N, P2_BATCH, P2_SECRET, master_key)
            p2.step()
            p2_samples = [p2.stream_ips(P2_ITERS)[0]
                          for _ in range(3 if fits(60) else 1)]
            RESULT["pow2_4096_images_per_sec"] = dist_record(
                p2_samples)["median"]
            RESULT["pow2_4096_images_per_sec_dist"] = dist_record(p2_samples)
            RESULT["vs_baseline_same_size"] = (
                round(RESULT["pow2_4096_images_per_sec"] / ref_4096_ips, 1)
                if ref_4096_ips else None)
        except Exception as e:  # noqa: BLE001
            RESULT["pow2_error"] = f"{type(e).__name__}: {e}"
        finally:
            p2 = None
    emit()

    # ---- 1080p tertiary (BASELINE config 2): core ----
    with stage("fhd_1080p"):
        fhd = sd = None
        try:
            fhd = Workload(FHD_H, FHD_W, FHD_BATCH, FHD_SECRET, master_key)
            sd = fhd.step()
            fhd_samples = [fhd.stream_ips(FHD_ITERS)[0]
                           for _ in range(3 if fits(45) else 1)]
            RESULT["fhd_1080p_images_per_sec"] = dist_record(
                fhd_samples)["median"]
            RESULT["fhd_1080p_images_per_sec_dist"] = dist_record(fhd_samples)
            RESULT["fhd_1080p_psnr_db"] = round(fhd.quality(sd)[0], 2)
        except Exception as e:  # noqa: BLE001
            RESULT["fhd_error"] = f"{type(e).__name__}: {e}"
        finally:
            fhd = sd = None
    emit()

    # ---- 512px secondary (continuity with earlier rounds; serialized-loop
    # semantic — at 0.3 ms/img of device work the stream's per-batch yield
    # overhead dominates and the loop is the better number): core ----
    with stage("secondary_512px"):
        try:
            small = Workload(SMALL, SMALL, SMALL_BATCH, SMALL_SECRET,
                             master_key)
            sd = small.step()
            small_samples = [small.loop_ips(SMALL_ITERS)
                             for _ in range(3 if fits(30) else 1)]
            small_ips = dist_record(small_samples)["median"]
            spsnr, sssim = small.quality(sd)
            RESULT.update({
                "secondary_512px_images_per_sec": small_ips,
                "secondary_512px_images_per_sec_dist": dist_record(
                    small_samples),
                "secondary_512px_vs_baseline": (
                    round(small_ips * ref["spi_512"], 2)
                    if ref["measured"] else None),
                "secondary_512px_psnr_db": round(spsnr, 2),
                "secondary_512px_ssim": round(sssim, 4),
                "ref_psnr_512_db": (round(ref["psnr_512"], 2)
                                    if ref.get("psnr_512") else None),
            })
        except Exception as e:  # noqa: BLE001
            RESULT["small_error"] = f"{type(e).__name__}: {e}"
    emit()

    RESULT["bench_wall_s"] = round(time.perf_counter() - T0, 1)
    emit()
    failed = failed_stages(RESULT)
    if failed:
        note(f"stages failed: {', '.join(failed)}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
