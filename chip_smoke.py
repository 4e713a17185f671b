#!/usr/bin/env python3
"""End-to-end check of the system on an NVIDIA GPU.

Drives the main path once through the entry points a user calls, at the
headline deployment (4K UHD covers, 16 KB payloads, batch 64, Rep-7, raw
master key), and compares each device computation with the repo's plain
reference (float64 numpy spectra, AEAD-verified payload recovery). Stops
with a non-zero exit at the first failure; there is no CPU fallback.

    python chip_smoke.py [--seed N]        # one card: phases 1-8
    python chip_smoke.py --four-cards      # the 4-card paths only

Phases: 1 device, 2 native library, 3 precision against float64 numpy,
4 main path (4K batch embed -> extract), 5 full-grid paths (4096^2 batch,
adaptive alpha), 6 CLI, 7 serve worker, 8 the result line. The last line
of stdout is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}

Every phase function takes its sizes as arguments, so each can be
rehearsed on the CPU at small shapes (main() itself refuses a CPU).
"""

from __future__ import annotations

import argparse
import base64
import contextlib
import io
import json
import math
import os
import pathlib
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

# Headline deployment (bench.py's 4K UHD constants).
UHD_H, UHD_W, UHD_BATCH, UHD_SECRET = 2160, 3840, 64, 16 * 1024
P2_N, P2_BATCH, P2_SECRET = 4096, 8, 2000
FHD_H, FHD_W = 1080, 1920

# Tolerances, relative to the walk-bin signal scale mag*sin(alpha) (the
# median spectrum magnitude over the annulus the walk draws from, times
# sin(alpha)). A written bin decodes wrong only when an error exceeds its
# margin, which is exactly mag*sin(alpha); a max error of 0.1 leaves a median
# bin 10x clear, and an RMS error of 0.01 is ~5x below the u8 rounding noise
# every stego already carries at 4K (sqrt(H*W/12) per bin, ~0.05 of scale).
TOL_SPEC_MAX, TOL_SPEC_RMS = 0.1, 0.01
# The delta IFFT's output is added to u8 pixels and rounded, which adds
# 0.29 px RMS of noise to every pixel: an error of 0.05 px RMS is ~6x below
# that, and an error under 1 px moves no pixel by more than one u8 level.
TOL_IFFT_MAX_PX, TOL_IFFT_RMS_PX = 1.0, 0.05
# Precision candidates for the f32-faithful forward stage-2 contraction.
CANDIDATES = ("HIGH", "BF16_BF16_F32_X3", "TF32_TF32_F32_X3", "HIGHEST")
# A precision whose raw payload BER is within this of "highest"'s on the
# same covers and salts leaves the channel as it is.
TOL_BER_REL = 0.10


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise SmokeFailure(msg)


def say(*parts) -> None:
    print(*parts, flush=True)


# --- inputs made from the seed ----------------------------------------------


def host_covers(rng: np.random.Generator, B: int, H: int, W: int):
    """(B, H, W, 3) u8 covers: a horizontal gradient plus uniform noise,
    the recipe of bench.py's covers."""
    base = np.linspace(150, 235, W)[None, :, None]
    return np.stack([np.clip(base + rng.integers(-18, 19, (H, W, 3)), 0, 255)
                     .astype(np.uint8) for _ in range(B)])


def device_covers(seed: int, B: int, H: int, W: int, layout: str = "nchw"):
    """The host_covers recipe generated on the device (a 4K batch of 64 is
    1.6 GB: making it in place skips the host generation and the upload)."""
    import jax
    import jax.numpy as jnp

    shape = (B, 3, H, W) if layout == "nchw" else (B, H, W, 3)

    @jax.jit
    def make(key):
        base = jnp.linspace(150.0, 235.0, W)
        if layout != "nchw":
            base = base[:, None]
        noise = jax.random.randint(key, shape, -18, 19)
        return jnp.clip(base + noise, 0, 255).astype(jnp.uint8)

    return jax.block_until_ready(make(jax.random.PRNGKey(seed)))


def payloads(rng: np.random.Generator, B: int, n: int):
    secrets = [rng.bytes(n) for _ in range(B)]
    salts = [rng.bytes(16) for _ in range(B)]
    return secrets, salts


# --- phase 1: device -------------------------------------------------------


def card_line() -> str:
    """`name, power limit` of the card, from nvidia-smi in a child process
    that does not import JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def phase_device(expect_count: int) -> dict:
    import jax

    from steganosaurus_jax.utils import metrics

    devs = jax.devices()
    d = devs[0]
    check(d.platform == "gpu",
          f"JAX platform is {d.platform!r}, not 'gpu': this check runs "
          f"only on a GPU")
    check(len(devs) >= expect_count,
          f"{len(devs)} devices, {expect_count} needed")
    card = card_line()
    peaks = metrics.device_peaks(d.device_kind)
    say(f"[1 device] platform={d.platform} kind={d.device_kind} "
        f"count={len(devs)} jax={jax.__version__}")
    say(f"[1 device] nvidia-smi: {card}")
    say(f"[1 device] peaks (NVIDIA data sheet): "
        + " ".join(f"{k}={v:.3g}" for k, v in peaks.items()))
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(devs), "card": card}


# --- phase 2: native library -------------------------------------------------


def phase_native() -> None:
    from steganosaurus_jax import _native_loader

    have = {t: shutil.which(t) is not None for t in ("cmake", "ninja")}
    lib = _native_loader.ensure_built()
    check(lib is not None, "native library did not build or load; the "
          "pure-Python walk is not an acceptable fallback")
    say(f"[2 native] cmake={have['cmake']} ninja={have['ninja']} "
        f"built_by={_native_loader.build_method}")


# --- phase 3: precision against float64 numpy --------------------------------


def resolve_precision(name: str):
    import jax

    if name in ("HIGH", "HIGHEST"):
        return getattr(jax.lax.Precision, name)
    return getattr(jax.lax.DotAlgorithmPreset, name)


def signal_scale(F: np.ndarray, rmin: float, rmax: float,
                 alpha: float) -> float:
    """Walk-bin signal scale: median |F| over the annulus the walk draws
    bins from (y, x >= 1, rmin <= hypot/min(H, W) <= rmax), times
    sin(alpha)."""
    H, W = F.shape[-2:]
    R = int(rmax * min(H, W)) + 1
    yy, xx = np.mgrid[:R, :R]
    r = np.hypot(yy, xx) / min(H, W)
    sel = (yy >= 1) & (xx >= 1) & (r >= rmin) & (r <= rmax)
    return float(np.median(np.abs(F[:, :R, :R][:, sel]))
                 * abs(math.sin(alpha)))


def rel_err(got: np.ndarray, want: np.ndarray, scale: float):
    e = np.abs(got - want)
    return float(e.max() / scale), float(np.sqrt(np.mean(e * e)) / scale)


def walk_mask(H: int, W: int, Ky: int, Kx: int, nbits: int, master_key,
              params) -> np.ndarray:
    """(3, Ky, Kx) bool: the corner bins the walk writes for an nbits
    frame."""
    from steganosaurus_jax.pipeline.batch import _walk_indices

    plane, y, x, _, nprod = _walk_indices(None, master_key, params, H, W,
                                          nbits, allow_short=True)
    m = np.zeros((3, Ky, Kx), bool)
    m[plane[:nprod], y[:nprod], x[:nprod]] = True
    return m


def phase_precision(seed: int, H: int, W: int, fft_sizes, nbits: int,
                    candidates=CANDIDATES) -> dict:
    """Corner forward spectra, the delta IFFT and jnp.fft (cuFFT) against
    float64 numpy. Each forward candidate runs stage 1 at HIGHEST so the
    stage-2 contraction's own error is what is measured."""
    import jax
    import jax.numpy as jnp

    from steganosaurus_jax.config import Params
    from steganosaurus_jax.spectral import corner

    p = Params()
    rng = np.random.default_rng(seed)
    cover = host_covers(rng, 1, H, W)[0]
    planes = cover.transpose(2, 0, 1).astype(np.float64)
    F = np.conj(np.fft.fft2(planes))          # reference sign convention
    Ky, Kx = corner.corner_dims(H, W, p.rmax)
    scale = signal_scale(F, p.rmin, p.rmax, p.alpha)
    mask = walk_mask(H, W, Ky, Kx, nbits, bytes(range(32)), p)
    ref = F[:, :Ky, :Kx]
    tabs = corner.dft_tables_device(H, Ky, W, Kx)
    planes_d = jnp.asarray(planes.astype(np.float32))
    hi = jax.lax.Precision.HIGHEST
    say(f"[3 precision] {H}x{W} corner {Ky}x{Kx}, {int(mask.sum())} walk "
        f"bins, signal scale mag*sin(alpha) = {scale:.1f}; tolerance "
        f"max <= {TOL_SPEC_MAX}, rms <= {TOL_SPEC_RMS} of scale")

    def fwd(prec):
        f = jax.jit(lambda pl, *t: corner.fwd_corner(pl, Ky, Kx, t, prec))
        cr, ci = f(planes_d, *tabs)
        return np.asarray(cr) + 1j * np.asarray(ci)

    out = {"scale": scale, "fwd": {}, "ifft": {}, "fft": {}}
    modes = [(n, (hi, resolve_precision(n), hi, hi)) for n in candidates]
    modes.append(("production:" + os.environ.get(
        "STEGANOSAURUS_MM_PRECISION", "mix_adaptive"), corner.precision()))
    C = None
    for name, prec in modes:
        try:
            got = fwd(prec)
        except Exception as e:  # noqa: BLE001 — a preset may not lower
            say(f"[3 precision] fwd stage2={name}: does not lower "
                f"({type(e).__name__}: {str(e).splitlines()[0][:160]})")
            out["fwd"][name] = None
            continue
        mx, rms = rel_err(got[mask], ref[mask], scale)
        ok = mx <= TOL_SPEC_MAX and rms <= TOL_SPEC_RMS
        out["fwd"][name] = {"max": mx, "rms": rms, "within_tol": ok}
        say(f"[3 precision] fwd stage2={name}: max {mx:.3e} rms {rms:.3e} "
            f"{'within' if ok else 'OUTSIDE'} tolerance")
        if name == "HIGHEST":
            C = got
    check(out["fwd"].get("HIGHEST", {}) and out["fwd"]["HIGHEST"][
        "within_tol"], "HIGHEST corner spectra outside tolerance")
    acc = _precision_name(corner.ACCURATE)
    check(acc in out["fwd"] and out["fwd"][acc] is not None
          and out["fwd"][acc]["within_tol"],
          f"corner.ACCURATE ({acc}) spectra outside tolerance")

    # delta IFFT of a realistic walk delta (the dense write of random bits)
    sign = np.where(rng.integers(0, 2, mask.shape) > 0, 1.0, -1.0)
    dr, di = corner.write_delta(
        jnp.asarray(C.real, jnp.float32), jnp.asarray(C.imag, jnp.float32),
        jnp.asarray(sign, jnp.float32), jnp.asarray(mask, jnp.float32),
        math.cos(p.alpha), math.sin(p.alpha))
    D = np.zeros((3, H, W), np.complex128)
    D[:, :Ky, :Kx] = np.asarray(dr) + 1j * np.asarray(di)
    t_ref = np.fft.ifft2(np.conj(D)).real
    rms_delta = float(np.sqrt(np.mean(t_ref ** 2)))
    say(f"[3 precision] delta IFFT: rms delta {rms_delta:.3f} px; tolerance "
        f"max <= {TOL_IFFT_MAX_PX} px, rms <= {TOL_IFFT_RMS_PX} px")
    for name, prec in [(n, (hi, hi, resolve_precision(n),
                            resolve_precision(n))) for n in candidates] + [
            ("production", corner.precision())]:
        try:
            t = np.asarray(jax.jit(lambda a, b, *tb: corner.ifft_corner_real(
                a, b, H, W, tb, prec))(dr, di, *tabs))
        except Exception as e:  # noqa: BLE001
            say(f"[3 precision] ifft={name}: does not lower "
                f"({type(e).__name__})")
            out["ifft"][name] = None
            continue
        mx, rms = rel_err(t, t_ref, 1.0)
        ok = mx <= TOL_IFFT_MAX_PX and rms <= TOL_IFFT_RMS_PX
        out["ifft"][name] = {"max_px": mx, "rms_px": rms, "within_tol": ok}
        say(f"[3 precision] ifft={name}: max {mx:.3e} px rms {rms:.3e} px "
            f"{'within' if ok else 'OUTSIDE'} tolerance")
    for name in ("production", acc):
        check(out["ifft"].get(name) and out["ifft"][name]["within_tol"],
              f"delta IFFT ({name}) outside tolerance")

    # jnp.fft (cuFFT on the GPU) against numpy float64
    from steganosaurus_jax import spectral

    for (h, w) in fft_sizes:
        x = (planes if (h, w) == (H, W) else host_covers(
            rng, 1, h, w)[0].transpose(2, 0, 1).astype(np.float64))
        Fr = np.conj(np.fft.fft2(x))
        sc = signal_scale(Fr, p.rmin, p.rmax, p.alpha)
        got = np.asarray(jax.jit(spectral.fft2)(x.astype(np.float32)))
        mx, rms = rel_err(got, Fr, sc)
        ok = mx <= TOL_SPEC_MAX and rms <= TOL_SPEC_RMS
        out["fft"][f"{h}x{w}"] = {"max": mx, "rms": rms}
        say(f"[3 precision] spectral.fft2 {h}x{w} (complex64): max "
            f"{mx:.3e} rms {rms:.3e} of scale {sc:.1f} "
            f"{'within' if ok else 'OUTSIDE'} tolerance")
        check(ok, f"spectral.fft2 at {h}x{w} outside tolerance")
    return out


def _precision_name(prec) -> str:
    return getattr(prec, "name", str(prec))


# --- phase 4: main path ------------------------------------------------------


def clear_core_caches() -> None:
    """Drop the lru-cached device-core constructors and the cached static
    maps: the constructors read corner.precision() when they run, so a
    precision switch takes effect on the next call, and the next embed
    rebuilds its static corner maps with a fresh scatter."""
    import steganosaurus_jax.parallel.batch as pb
    import steganosaurus_jax.pipeline.batch as pipb
    import steganosaurus_jax.pipeline.device as pdev

    for mod in (pb, pipb, pdev):
        for v in vars(mod).values():
            if hasattr(v, "cache_clear"):
                v.cache_clear()
    pipb._CORNER_STATICS_CACHE.clear()
    pipb._DEV_IDX_CACHE.clear()


@contextlib.contextmanager
def precision_mode(mode: str):
    old = os.environ.get("STEGANOSAURUS_MM_PRECISION")
    os.environ["STEGANOSAURUS_MM_PRECISION"] = mode
    clear_core_caches()
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("STEGANOSAURUS_MM_PRECISION", None)
        else:
            os.environ["STEGANOSAURUS_MM_PRECISION"] = old
        clear_core_caches()


def roundtrip(covers_d, secrets, salts, mk, params, secret_len: int) -> dict:
    """One embed_batch -> extract_batch over device-resident NCHW covers,
    with the channel report (raw / post-ECC BER) and PSNR/SSIM."""
    from steganosaurus_jax.pipeline.batch import (channel_report,
                                                  embed_batch, extract_batch)
    from steganosaurus_jax.utils import metrics

    t0 = time.perf_counter()
    res = embed_batch(covers_d, secrets, master_key=mk, params=params,
                      salts=salts, device_resident=True, layout="nchw")
    got = extract_batch(res.stego, master_key=mk, params=params,
                        clen_hint=secret_len, layout="nchw")
    dt = time.perf_counter() - t0
    ber = channel_report(res.stego, secrets, salts, master_key=mk,
                         params=params, layout="nchw")
    psnr, ssim = metrics.quality_device(covers_d, res.stego)
    return {"stego": res.stego, "seconds": dt,
            "recovery": sum(g == s for g, s in zip(got, secrets))
            / len(secrets),
            "payload_ber_raw": ber["payload_ber_raw"],
            "payload_ber_post_ecc": ber["payload_ber_post_ecc"],
            "header_ber_raw": ber["header_ber_raw"],
            "psnr_db": psnr, "ssim": ssim}


def ber_line(tag: str, r: dict) -> str:
    return (f"{tag}: recovery {r['recovery']:.4f} payload BER raw "
            f"{r['payload_ber_raw']:.6f} post-ECC "
            f"{r['payload_ber_post_ecc']:.6f} header BER raw "
            f"{r['header_ber_raw']:.6f} PSNR {r['psnr_db']:.2f} dB "
            f"SSIM {r['ssim']:.4f}")


def stream_ips(covers_d, secrets, salts, mk, params, secret_len: int,
               iters: int) -> tuple[float, float]:
    """(images/s, recovery rate) over embed_stream -> extract_stream, the
    pipelined serving path, with AEAD-verified recovery counted."""
    from steganosaurus_jax.pipeline import stream

    n_ok = n_tot = 0
    t0 = time.perf_counter()
    embeds = stream.embed_stream(
        ((covers_d, secrets, salts) for _ in range(iters)), master_key=mk,
        params=params, depth=2, layout="nchw")
    for got in stream.extract_stream((r.stego for r in embeds),
                                     master_key=mk, params=params,
                                     clen_hint=secret_len, depth=2,
                                     layout="nchw"):
        n_ok += sum(g == s for g, s in zip(got, secrets))
        n_tot += len(secrets)
    dt = time.perf_counter() - t0
    return n_tot / dt, n_ok / n_tot


def stage1_ms(covers_d, Ky: int, Kx: int, reps: int = 3) -> float:
    """Host-clock time of the corner engine's stage-1 einsum pair alone
    (the u8 planes against the x-axis DFT tables, bf16 operands) over the
    whole batch, min over `reps`."""
    import jax
    import jax.numpy as jnp

    from steganosaurus_jax.spectral import corner

    H, W = covers_d.shape[-2:]
    exr, exi = corner.dft_tables_device(H, Ky, W, Kx)[2:4]

    @jax.jit
    def s1(imgs, a, b):
        pl = imgs.astype(jnp.float32)
        return (corner._mm("...hw,xw->...hx", pl, a, "bf16"),
                corner._mm("...hw,xw->...hx", pl, b, "bf16"))

    jax.block_until_ready(s1(covers_d, exr, exi))
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(s1(covers_d, exr, exi))
        best = min(best, time.perf_counter() - t0)
    return 1e3 * best


def precision_bands(covers_d, secrets, salts, mk, params, secret_len: int,
                    card: str, ber_limit: float) -> dict:
    """The default mode with each candidate as its f32-faithful band
    precision (corner.ACCURATE): recovery, BER and the device embed time,
    on the same covers and salts. The candidate in use must stay within
    `ber_limit`; the others are evidence for the choice."""
    from steganosaurus_jax.spectral import corner
    from steganosaurus_jax.utils import cost

    chosen = _precision_name(corner.ACCURATE)
    out = {}
    for name in CANDIDATES:
        saved = corner.ACCURATE
        corner.ACCURATE = resolve_precision(name)
        try:
            with precision_mode("mix_adaptive"):
                r = roundtrip(covers_d, secrets, salts, mk, params,
                              secret_len)
                r["stego"] = None
                t = cost.measure_device_step(covers_d, mk, secret_len,
                                             params, reps=3)
        finally:
            corner.ACCURATE = saved
        r["embed_ms"] = 1e3 * t["embed_s"]
        r["extract_ms"] = 1e3 * t["extract_s"]
        out[name] = r
        say(f"[4 main] band={name}{' (in use)' if name == chosen else ''}: "
            f"{ber_line('', r)[2:]}; device embed {r['embed_ms']:.1f} ms "
            f"extract {r['extract_ms']:.1f} ms ({card})")
    c = out[chosen]
    check(c["recovery"] == 1.0 and c["payload_ber_post_ecc"] == 0.0
          and c["payload_ber_raw"] <= ber_limit,
          f"band precision in use ({chosen}) outside tolerance")
    return out


def phase_main(seed: int, H: int, W: int, B: int, secret_len: int,
               card: str, iters: int = 3) -> dict:
    import jax
    import jax.numpy as jnp

    from steganosaurus_jax.config import Params
    from steganosaurus_jax.pipeline.batch import embed_batch
    from steganosaurus_jax.spectral import corner
    from steganosaurus_jax.utils import cost

    p = Params()
    rng = np.random.default_rng(seed + 1)
    mk = rng.bytes(32)
    covers_d = device_covers(seed, B, H, W)
    secrets, salts = payloads(rng, B, secret_len)
    say(f"[4 main] {H}x{W} batch {B} secret {secret_len} B Rep-7 master "
        f"key; fwd stage-2 ACCURATE = {_precision_name(corner.ACCURATE)}")

    d = roundtrip(covers_d, secrets, salts, mk, p, secret_len)
    say(f"[4 main] compile + first embed->extract: {d['seconds']:.1f} s "
        f"({card})")
    say("[4 main] " + ber_line("default (mix_adaptive)", d))
    check(d["recovery"] == 1.0, "default precision: recovery below 1.0")
    check(d["payload_ber_post_ecc"] == 0.0,
          "default precision: post-ECC payload BER is not 0")

    # the same embed again with fresh device cores and static maps: the stego
    # must be bit-identical
    clear_core_caches()
    again = embed_batch(covers_d, secrets, master_key=mk, params=p,
                        salts=salts, device_resident=True, layout="nchw")
    same = bool(jnp.array_equal(again.stego, d["stego"]))
    say(f"[4 main] second embed bit-identical: {same}")
    check(same, "a second embed of the same batch gave different stego")
    del again

    ips, rec = stream_ips(covers_d, secrets, salts, mk, p, secret_len, iters)
    say(f"[4 main] warm embed_stream->extract_stream: {ips:.2f} images/s "
        f"over {iters * B} images, recovery {rec:.4f} ({card})")
    check(rec == 1.0, "stream recovery below 1.0")

    Ky, Kx = corner.corner_dims(H, W, p.rmax)
    step = cost.measure_device_step(covers_d, mk, secret_len, p, reps=3)
    s1 = stage1_ms(covers_d, Ky, Kx)
    dev_ms = 1e3 * step["device_roundtrip_s"]
    say(f"[4 main] device modules alone: embed {1e3 * step['embed_s']:.1f} "
        f"ms + extract {1e3 * step['extract_s']:.1f} ms per batch; stage-1 "
        f"einsum pair {s1:.1f} ms per pass, 2 passes = "
        f"{100 * 2 * s1 / dev_ms:.1f}% of the device round trip ({card})")

    d["stego"] = None
    with precision_mode("highest"):
        h = roundtrip(covers_d, secrets, salts, mk, p, secret_len)
    h["stego"] = None
    say("[4 main] " + ber_line("highest", h))
    check(h["recovery"] == 1.0, "highest: recovery below 1.0")
    lim = h["payload_ber_raw"] * (1 + TOL_BER_REL)
    say(f"[4 main] default raw BER {d['payload_ber_raw']:.6f} vs highest "
        f"{h['payload_ber_raw']:.6f}: tolerance <= highest x "
        f"{1 + TOL_BER_REL:.2f} = {lim:.6f}")
    check(d["payload_ber_raw"] <= lim,
          "default precision raw BER outside tolerance of highest's")
    bands = precision_bands(covers_d, secrets, salts, mk, p, secret_len,
                            card, lim)
    peak = (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use")
    say(f"[4 main] peak_bytes_in_use {peak}")
    return {"default": d, "highest": h, "bands": bands, "images_per_s": ips,
            "device_roundtrip_ms": dev_ms, "stage1_ms": s1}


# --- phase 5: full-grid paths ------------------------------------------------


def phase_fullgrid(seed: int, n: int, B: int, secret_len: int,
                   fhd: tuple[int, int], fhd_secret: int, card: str) -> None:
    from steganosaurus_jax.config import Params
    from steganosaurus_jax.pipeline.batch import embed_batch, extract_batch

    rng = np.random.default_rng(seed + 2)
    mk = rng.bytes(32)
    covers = host_covers(rng, B, n, n)
    secrets, salts = payloads(rng, B, secret_len)
    t0 = time.perf_counter()
    res = embed_batch(covers, secrets, master_key=mk, salts=salts)
    got = extract_batch(res.stego, master_key=mk, clen_hint=secret_len)
    ok = sum(g == s for g, s in zip(got, secrets))
    say(f"[5 full-grid] {n}x{n} batch {B} secret {secret_len} B: recovered "
        f"{ok}/{B} ({time.perf_counter() - t0:.1f} s with compile, {card})")
    check(ok == B, f"{n}x{n} batch recovery {ok}/{B}")

    h, w = fhd
    pa = Params(adaptive_alpha=True)
    cover = host_covers(rng, 1, h, w)
    secret = rng.bytes(fhd_secret)
    res = embed_batch(cover, [secret], master_key=mk, params=pa)
    got = extract_batch(res.stego, master_key=mk, params=pa)
    say(f"[5 full-grid] adaptive_alpha {h}x{w}: recovered "
        f"{int(got[0] == secret)}/1")
    check(got[0] == secret, "adaptive-alpha image did not recover")


# --- phase 6: CLI ------------------------------------------------------------


@contextlib.contextmanager
def captured_stdout():
    buf = io.BytesIO()
    text = io.TextIOWrapper(buf, encoding="utf-8", write_through=True)
    old = sys.stdout
    sys.stdout = text
    try:
        yield buf
    finally:
        text.flush()
        text.detach()  # keep `buf` open for the caller
        sys.stdout = old


def run_cli(args: list[str]) -> tuple[int, bytes]:
    from steganosaurus_jax import cli

    with captured_stdout() as buf:
        rc = cli.main(["turtlefft", *args])
    return rc, buf.getvalue()


def phase_cli(seed: int, H: int, W: int, workdir: pathlib.Path) -> None:
    from steganosaurus_jax.io import image

    rng = np.random.default_rng(seed + 3)
    key = base64.b64encode(rng.bytes(32)).decode()
    covers = host_covers(rng, 5, H, W)
    host, stego = workdir / "host.png", workdir / "stego.png"
    image.save_png(str(host), covers[0])
    secret = "chip smoke " + rng.bytes(48).hex()
    rc, _ = run_cli(["embed", "--in", str(host), "--out", str(stego),
                     "--secret", secret, "--key", key])
    check(rc == 0, f"cli embed rc {rc}")
    rc, out = run_cli(["extract", "--in", str(stego), "--key", key])
    check(rc == 0 and out.rstrip(b"\n") == secret.encode(),
          f"cli extract rc {rc}, got {out[:80]!r}")
    say(f"[6 cli] embed/extract {H}x{W} PNG: secret recovered")

    ind, outd = workdir / "in", workdir / "out"
    ind.mkdir()
    sec = [f"batch secret {i} " + rng.bytes(16).hex() for i in range(4)]
    for i in range(4):
        image.save_png(str(ind / f"img{i}.png"), covers[1 + i])
    (workdir / "secrets.txt").write_text("\n".join(sec) + "\n")
    rc, _ = run_cli(["batch-embed", "--in-dir", str(ind), "--out-dir",
                     str(outd), "--secrets-file",
                     str(workdir / "secrets.txt"), "--key", key])
    check(rc == 0, f"cli batch-embed rc {rc}")
    rc, out = run_cli(["batch-extract", "--in-dir", str(outd), "--key", key])
    got = dict(line.split("\t", 1) for line in out.decode().splitlines())
    want = {f"img{i}.png": sec[i] for i in range(4)}
    check(rc == 0 and got == want, f"cli batch-extract rc {rc}: {got}")
    say(f"[6 cli] batch-embed/batch-extract of 4 PNGs: all recovered")


# --- phase 7: serve ----------------------------------------------------------


def phase_serve(seed: int, H: int, W: int, payload: int,
                workdir: pathlib.Path, card: str) -> None:
    from steganosaurus_jax import cli
    from steganosaurus_jax.io import image

    rng = np.random.default_rng(seed + 4)
    key = base64.b64encode(rng.bytes(32)).decode()
    covers = host_covers(rng, 2, H, W)
    png_in, png_out = workdir / "s_in.png", workdir / "s_out.png"
    npy_in, npy_out = workdir / "s_in.npy", workdir / "s_out.npy"
    image.save_png(str(png_in), covers[0])
    np.save(npy_in, covers[1])
    s1, s2 = rng.bytes(payload), rng.bytes(payload)
    b64 = lambda b: base64.b64encode(b).decode()  # noqa: E731
    reqs = [{"op": "ping", "id": 0},
            {"op": "embed", "id": 1, "in": str(png_in), "out": str(png_out),
             "secret_b64": b64(s1)},
            {"op": "extract", "id": 2, "in": str(png_out)},
            {"op": "embed", "id": 3, "in_npy": str(npy_in),
             "out_npy": str(npy_out), "secret_b64": b64(s2)},
            {"op": "extract", "id": 4, "in_npy": str(npy_out)},
            {"op": "stats", "id": 5},
            {"op": "shutdown", "id": 6}]
    old_in = sys.stdin
    sys.stdin = io.StringIO("".join(json.dumps(r) + "\n" for r in reqs))
    try:
        with captured_stdout() as buf:
            rc = cli.main(["turtlefft", "serve", "--key", key, "--warmup",
                           f"{H}x{W}:{payload}"])
    finally:
        sys.stdin = old_in
    resp = [json.loads(x) for x in buf.getvalue().decode().splitlines()]
    check(rc == 0, f"serve rc {rc}")
    check(resp and resp[0].get("op") == "ready", f"no ready line: {resp[:1]}")
    by_id = {r.get("id"): r for r in resp[1:]}
    for i in range(7):
        check(by_id.get(i, {}).get("ok"), f"serve request {i} failed: "
              f"{by_id.get(i)}")
    check(base64.b64decode(by_id[2]["secret_b64"]) == s1,
          "serve PNG extract returned the wrong secret")
    check(base64.b64decode(by_id[4]["secret_b64"]) == s2,
          "serve npy extract returned the wrong secret")
    say(f"[7 serve] warmup {resp[0].get('warmed')}; ping, PNG embed/extract "
        f"and npy embed/extract verified; latency ms: PNG "
        f"{by_id[1]['ms']}/{by_id[2]['ms']}, npy "
        f"{by_id[3]['ms']}/{by_id[4]['ms']} ({card})")


# --- four cards --------------------------------------------------------------


def phase_mesh(seed: int, H: int, W: int, B: int, secret_len: int,
               n_dev: int, card: str) -> None:
    """The batch of B over an n_dev-card `batch` mesh against one card, in
    one process: the stego must match byte for byte."""
    import jax

    from steganosaurus_jax.parallel import batch as pbatch
    from steganosaurus_jax.pipeline.batch import embed_batch, extract_batch

    rng = np.random.default_rng(seed + 5)
    mk = rng.bytes(32)
    covers_d = device_covers(seed, B, H, W, layout="nhwc")
    secrets, salts = payloads(rng, B, secret_len)
    one = embed_batch(covers_d, secrets, master_key=mk, salts=salts,
                      device_resident=True)
    one_host = np.asarray(one.stego)
    del one
    mesh = pbatch.make_mesh(n_dev)
    sharded = pbatch.shard_batch(covers_d, mesh)
    t0 = time.perf_counter()
    res = embed_batch(sharded, secrets, master_key=mk, salts=salts,
                      mesh=mesh, device_resident=True)
    got = extract_batch(res.stego, master_key=mk, mesh=mesh,
                        clen_hint=secret_len)
    dt = time.perf_counter() - t0
    many = np.asarray(res.stego)
    n_diff = int(np.count_nonzero(many != one_host))
    ok = sum(g == s for g, s in zip(got, secrets))
    say(f"[mesh] {H}x{W} batch {B} over {n_dev} cards ({B // n_dev} each): "
        f"recovered {ok}/{B}; stego bytes differing from the one-card run: "
        f"{n_diff} of {many.size} ({dt:.1f} s with compile, {card})")
    check(ok == B, "mesh recovery below 1.0")
    check(n_diff == 0, "mesh stego differs from the one-card stego")
    del sharded, covers_d
    jax.clear_caches()


def _embed_reference(planes, plane, y, x, bits, jit, alpha):
    """Single-device plain-JAX twin of fft_dist.embed_core_distributed
    (non-adaptive): full FFT, phase write plus Hermitian mirror, IFFT."""
    import jax.numpy as jnp

    from steganosaurus_jax.ops import phase as phase_ops

    PH, PW = planes.shape[-2:]
    spec = jnp.conj(jnp.fft.fft2(planes.astype(jnp.complex64)))
    v = spec[plane, y, x]
    mag = jnp.maximum(1e-12, jnp.abs(v))
    theta = jnp.where(bits.astype(bool), alpha, -alpha) + jit
    nv = (mag * jnp.exp(1j * theta)).astype(spec.dtype)
    cy, cx = phase_ops.conj_indices(y, x, PH, PW)
    spec = spec.at[plane, y, x].set(nv).at[plane, cy, cx].set(jnp.conj(nv))
    return jnp.fft.ifft2(jnp.conj(spec)).real


def _read_reference(planes, plane, y, x, jit, alpha):
    import jax.numpy as jnp

    spec = jnp.conj(jnp.fft.fft2(planes.astype(jnp.complex64)))
    base = jnp.angle(spec[plane, y, x]) - jit
    return (jnp.cos(base - alpha) >= jnp.cos(base + alpha)).astype(jnp.uint8)


def phase_fft_dist(seed: int, H: int, W: int, nbits: int, n_dev: int,
                   card: str) -> None:
    """One image's spectrum sharded over n_dev cards
    (parallel/fft_dist.py) against the single-device plain-JAX path."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from steganosaurus_jax.config import Params
    from steganosaurus_jax.parallel import fft_dist
    from steganosaurus_jax.pipeline.batch import _walk_indices

    rng = np.random.default_rng(seed + 6)
    p = Params()
    cover = host_covers(rng, 1, H, W)[0]
    planes = cover.transpose(2, 0, 1).astype(np.float32)
    plane, y, x, jt, nprod = _walk_indices(None, rng.bytes(32), p, H, W,
                                           nbits, allow_short=True)
    plane, y, x = plane[:nprod], y[:nprod], x[:nprod]
    jt = jt[:nprod].astype(np.float32)
    bits = rng.integers(0, 2, nprod).astype(np.uint8)
    alpha = jnp.float32(p.alpha)
    mesh = Mesh(np.asarray(jax.devices()[:n_dev]), ("image",))
    rows = NamedSharding(mesh, P(None, "image", None))
    t0 = time.perf_counter()
    out = jax.jit(lambda pl: fft_dist.embed_core_distributed(
        pl, plane, y, x, jnp.asarray(bits), jt, alpha, mesh))(
        jax.device_put(planes, rows))
    out = np.asarray(out)
    ref = np.asarray(jax.jit(_embed_reference)(planes, plane, y, x, bits,
                                               jt, alpha))
    dmax = float(np.abs(out - ref).max())
    stego = np.clip(np.floor(out + 0.5), 0, 255).astype(np.float32)
    got = np.asarray(jax.jit(lambda pl: fft_dist.read_core_distributed(
        pl, plane, y, x, jt, alpha, mesh))(jax.device_put(stego, rows)))
    want = np.asarray(jax.jit(_read_reference)(stego, plane, y, x, jt,
                                               alpha))
    n_mis = int(np.count_nonzero(got != want))
    ber = float(np.mean(got != bits))
    say(f"[fft_dist] {H}x{W}, {nprod} walk bins over {n_dev} cards: max "
        f"|sharded - single-device| {dmax:.2e} px; read mismatches vs "
        f"single-device {n_mis}; raw BER after u8 rounding {ber:.5f} "
        f"({time.perf_counter() - t0:.1f} s with compile, {card})")
    check(dmax <= 1e-2, "sharded embed differs from the single-device path")
    check(n_mis == 0, "sharded read differs from the single-device read")
    check(ber <= 0.01, "sharded embed->read raw BER above 1%")


# --- main --------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-card paths and what they are "
                         "compared with")
    args = ap.parse_args(argv)
    import jax

    from steganosaurus_jax import runtime

    runtime.enable_compilation_cache()
    n_dev = 4 if args.four_cards else 1
    try:
        dev = phase_device(n_dev)
        card = dev["card"]
        phase_native()
        if args.four_cards:
            phase_mesh(args.seed, UHD_H, UHD_W, UHD_BATCH, UHD_SECRET, 4,
                       card)
            phase_fft_dist(args.seed, UHD_H, UHD_W, 200_000, 4, card)
        else:
            nbits = 912 + (UHD_SECRET + 16) * 8 * 7
            phase_precision(args.seed, UHD_H, UHD_W,
                            [(UHD_H, UHD_W), (P2_N, P2_N)], nbits)
            phase_main(args.seed, UHD_H, UHD_W, UHD_BATCH, UHD_SECRET, card)
            jax.clear_caches()
            phase_fullgrid(args.seed, P2_N, P2_BATCH, P2_SECRET,
                           (FHD_H, FHD_W), 1000, card)
            with tempfile.TemporaryDirectory() as td:
                phase_cli(args.seed, UHD_H, UHD_W, pathlib.Path(td))
                phase_serve(args.seed, UHD_H, UHD_W, 4096, pathlib.Path(td),
                            card)
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr, flush=True)
        return 1
    say(json.dumps({"ok": True, "device": {
        "platform": dev["platform"], "kind": dev["kind"],
        "count": dev["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
