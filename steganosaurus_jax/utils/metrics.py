"""Stego quality metrics: PSNR, SSIM, and ECC bit-error rates.

The reference ships no metrics code; its docs cite PSNR >50 dB and
SSIM >0.995 as the imperceptibility bar (README.md:137,
doc/ATTACKS.md:162-166) and ~43%/33% as the Rep-7/Rep-3 BER budgets
(doc/HARDENING.md:277-283). This module makes those numbers measurable
(SURVEY.md §5 "Rebuild should emit: images/sec/chip, payload bit accuracy,
PSNR/SSIM vs cover, and BER before/after ECC").

Pure numpy host versions, plus a jitted device batch version
(quality_device) for bench-scale 4K batches, which stay on the device
instead of crossing to the host.
"""

from __future__ import annotations

import numpy as np

_QUALITY_JIT: dict = {}


def psnr(cover: np.ndarray, stego: np.ndarray, peak: float = 255.0) -> float:
    """Peak signal-to-noise ratio in dB over all channels."""
    err = stego.astype(np.float64) - cover.astype(np.float64)
    mse = float(np.mean(np.square(err)))
    if mse == 0:
        return float("inf")
    return 10.0 * np.log10(peak * peak / mse)


def ssim(cover: np.ndarray, stego: np.ndarray, peak: float = 255.0,
         win: int = 8) -> float:
    """Mean structural similarity (Wang et al. 2004), non-overlapping
    win x win windows, per channel, standard constants K1=0.01, K2=0.03.

    Block SSIM (not gaussian-windowed) keeps this dependency-free; for the
    >0.995 imperceptibility bar the two agree to ~1e-4.
    """
    a = cover.astype(np.float64)
    b = stego.astype(np.float64)
    if a.ndim == 2:
        a = a[..., None]
        b = b[..., None]
    H, W, C = a.shape
    h = (H // win) * win
    w = (W // win) * win
    # (nby, nbx, win, win, C) blocks
    ab = a[:h, :w].reshape(h // win, win, w // win, win, C).transpose(0, 2, 1, 3, 4)
    bb = b[:h, :w].reshape(h // win, win, w // win, win, C).transpose(0, 2, 1, 3, 4)
    mu_a = ab.mean(axis=(2, 3))
    mu_b = bb.mean(axis=(2, 3))
    var_a = ab.var(axis=(2, 3))
    var_b = bb.var(axis=(2, 3))
    cov = (ab * bb).mean(axis=(2, 3)) - mu_a * mu_b
    c1 = (0.01 * peak) ** 2
    c2 = (0.03 * peak) ** 2
    s = ((2 * mu_a * mu_b + c1) * (2 * cov + c2)) / (
        (mu_a ** 2 + mu_b ** 2 + c1) * (var_a + var_b + c2)
    )
    return float(s.mean())


def quality_device(cover_d, stego_d, peak: float = 255.0, win: int = 8,
                   chunk: int = 8):
    """(PSNR dB, mean SSIM) computed ON DEVICE for a batch of images.

    Same block-SSIM as ssim() above (non-overlapping win x win windows per
    channel) but jitted over the batch, so nothing crosses to the host (a
    4K batch of 64 is 1.6 GB of stego). Two device-memory disciplines keep
    the working set small: the per-layout kernels block H,W IN PLACE (an
    NCHW->NHWC transpose would materialize padded f32 copies of the whole
    batch), and batches are processed `chunk` images per dispatch (f32
    centered-moment temps are ~95 MB/image at 4K).

    f32 throughout with CENTERED variance/covariance (E[(x-mu)(y-nu)],
    not E[xy]-mu*nu: at pixel scale ~200 the uncentered form cancels
    catastrophically in f32); agrees with the f64 host version to ~1e-6
    SSIM / ~1e-4 dB on 4K stego pairs, far inside the >0.995 / >50 dB
    bar margins (tests/test_metrics.py).

    Accepts (B,H,W,C) or (B,C,H,W) (C in {1,3} decides; H,W are multiples
    of win in every framework layout used here). Returns Python floats.
    """
    import jax
    import jax.numpy as jnp

    from jax import lax

    nchw = cover_d.shape[-1] not in (1, 3)
    key = (peak, win, nchw)
    fn = _QUALITY_JIT.get(key)
    if fn is None:
        # Block moments via reduce_window pooling + repeat upsampling, NOT a
        # 6D blocked reshape: a (..., w//win, win) view leaves win=8 as the
        # minor dim, which tiled device layouts pad many-fold. Every tensor
        # here stays 4D with >=128-wide minor dims.
        if nchw:
            wdims = (1, 1, win, win)
            hax, wax = 2, 3
        else:
            wdims = (1, win, win, 1)
            hax, wax = 1, 2

        def stats(a, b):
            a = a.astype(jnp.float32)
            b = b.astype(jnp.float32)
            mse_sum = jnp.sum(jnp.square(a - b))
            H, W = a.shape[hax], a.shape[wax]
            h, w = (H // win) * win, (W // win) * win
            sl = [slice(None)] * 4
            sl[hax], sl[wax] = slice(0, h), slice(0, w)
            a = a[tuple(sl)]
            b = b[tuple(sl)]

            def pool(x):
                return lax.reduce_window(x, np.float32(0), lax.add, wdims,
                                         wdims, "VALID") / (win * win)

            def up(x):
                return jnp.repeat(jnp.repeat(x, win, hax), win, wax)

            mu_a = pool(a)
            mu_b = pool(b)
            ca = a - up(mu_a)
            cb = b - up(mu_b)
            var_a = pool(ca * ca)
            var_b = pool(cb * cb)
            cov = pool(ca * cb)
            c1 = jnp.float32((0.01 * peak) ** 2)
            c2 = jnp.float32((0.03 * peak) ** 2)
            s = ((2 * mu_a * mu_b + c1) * (2 * cov + c2)) / (
                (mu_a ** 2 + mu_b ** 2 + c1) * (var_a + var_b + c2))
            return mse_sum, jnp.mean(s)

        fn = _QUALITY_JIT[key] = jax.jit(stats)

    B = cover_d.shape[0]
    mse_sum = 0.0
    ssim_sum = 0.0
    npix = float(np.prod(cover_d.shape[1:]))
    for i in range(0, B, chunk):
        m, s = fn(cover_d[i:i + chunk], stego_d[i:i + chunk])
        n = min(chunk, B - i)
        mse_sum += float(m)
        ssim_sum += float(s) * n
    mse = mse_sum / (B * npix)
    p = 10.0 * float(np.log10(peak * peak / mse)) if mse > 0 else float("inf")
    return p, ssim_sum / B


def ber(sent_bits: np.ndarray, received_bits: np.ndarray) -> float:
    """Raw bit-error rate between two 0/1 arrays (pre-ECC channel quality)."""
    s = np.asarray(sent_bits).ravel()
    r = np.asarray(received_bits).ravel()
    n = min(len(s), len(r))
    if n == 0:
        return 0.0
    return float(np.mean(s[:n] != r[:n]))


def ecc_report(sent_frame: np.ndarray, received_frame: np.ndarray,
               header_stream_bits: int, rs_payload_bytes: int = 0) -> dict:
    """BER before/after ECC for one embedded frame.

    sent/received: full on-wire bit frames (Rep-3 header stream followed by
    the payload stream — Rep-7 per the reference frame layout
    steganosaur.cpp:986-995, or interleaved RS(255,223) coded bits when
    rs_payload_bytes (= clen + 16, the pre-FEC message size) is given.
    """
    from steganosaurus_jax.ops import bits as bit_ops
    from steganosaurus_jax.ops import ecc
    from steganosaurus_jax.ops import rs as rs_mod

    s = np.asarray(sent_frame).ravel()
    r = np.asarray(received_frame).ravel()
    hdr_raw = ber(s[:header_stream_bits], r[:header_stream_bits])
    pay_raw = ber(s[header_stream_bits:], r[header_stream_bits:])
    hdr_post = ber(np.asarray(ecc.rep3_decode(s[:header_stream_bits])),
                   np.asarray(ecc.rep3_decode(r[:header_stream_bits])))
    if rs_payload_bytes:
        m = rs_payload_bytes
        dec_s, _, _ = rs_mod.rs_decode_interleaved(
            bit_ops.bytes_from_bits(s[header_stream_bits:]), m)
        dec_r, _, _ = rs_mod.rs_decode_interleaved(
            bit_ops.bytes_from_bits(r[header_stream_bits:]), m)
        pay_post = ber(np.asarray(bit_ops.bits_from_bytes(dec_s)),
                       np.asarray(bit_ops.bits_from_bytes(dec_r)))
    else:
        pay_post = ber(np.asarray(ecc.rep7_decode(s[header_stream_bits:])),
                       np.asarray(ecc.rep7_decode(r[header_stream_bits:])))
    return {
        "header_ber_raw": hdr_raw,
        "header_ber_post_ecc": hdr_post,
        "payload_ber_raw": pay_raw,
        "payload_ber_post_ecc": pay_post,
    }


# ---------------------------------------------------------------------------
# Device peaks (roofline denominators) and utilization.
# ---------------------------------------------------------------------------

# Published dense peaks, keyed by `jax.devices()[0].device_kind`. Source:
# NVIDIA H100 Tensor Core GPU data sheet, SXM5 part, dense rates without
# sparsity, at the 700 W power limit. A card set below that limit cannot
# hold these rates, so every utilization is reported beside the card's
# power limit (nvidia-smi).
DEVICE_PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "bf16_flops_per_s": 989e12,
        "tf32_flops_per_s": 495e12,
        "fp32_flops_per_s": 67e12,
        "hbm_bytes_per_s": 3.35e12,
    },
}


def device_peaks(device_kind: str) -> dict:
    """Peak rates of the device named by `device_kind`. A device missing
    from DEVICE_PEAKS is an error: a utilization against a guessed peak is
    worse than none."""
    try:
        return DEVICE_PEAKS[device_kind]
    except KeyError:
        raise ValueError(
            f"no published peaks for device kind {device_kind!r}; add it to "
            f"utils/metrics.py DEVICE_PEAKS with its source") from None


def xla_module_flops(fn, *example_args) -> float | None:
    """FLOPs of `fn`'s compiled XLA module at the example arguments' shapes
    (the compiler's own cost analysis). Returns None when the backend does
    not expose cost analysis. `fn` may itself call jitted functions — the
    outer trace inlines them."""
    import jax

    try:
        comp = jax.jit(fn).lower(*example_args).compile()
        d = comp.cost_analysis()
        if isinstance(d, (list, tuple)):
            d = d[0] if d else {}
        f = float(d.get("flops", 0.0))
        return f if f > 0 else None
    except Exception:  # noqa: BLE001 — introspection only, never fatal
        return None


def mfu_pct(flops_per_step: float, step_seconds: float,
            peak_flops: float) -> float:
    """Model-FLOPs-utilization: counted step FLOPs over (wall x peak)."""
    return 100.0 * flops_per_step / (step_seconds * peak_flops)
