"""Corner-restricted spectral embed/extract math (the 4K fast path).

The turtle walk accepts only bins with hypot(y, x) <= rmax*min(H, W) on RAW
indices and y, x >= 1 (reference annulus check, steganosaur.cpp:791-795;
keystream/_pure.py turtle_expand), so every primary bin lives in the
[0, K) x [0, K) top-left corner of the spectrum, K = floor(rmax*min(H,W))+1.
Under the Hermitian-half write (ops/phase.py) the embed is

    stego = planes + real(IFFT2(Delta)),   supp(Delta) subset corner,

because real(IFFT2(FFT2(planes))) == planes exactly (native-size grids,
spectral.fft_dims). This module evaluates both directions as pruned-DFT
matmuls — O(K/N) of the full transform — and replaces the per-bin
scatter/gather with dense elementwise math over the corner:

- phase WRITE: new value at a bin is mag*exp(i*(jd + s*alpha)) with s = +-1
  from the bit; as a dense op it needs only a static position map (which walk
  slot owns each bin), a per-image bit-sign plane, and static jitter maps.
- phase READ (reference read_bit_from_bin, :734-746): bit = 1 iff
  cos(th - jd - a) >= cos(th - jd + a)  <=>  sin(th - jd) * sin(a) >= 0,
  i.e. sign(sin a) * (Im(C)*cos(jd) - Re(C)*sin(jd)) >= 0 — no per-bin trig,
  no gather, and alpha enters only through the scalar sign(sin(alpha))
  (ties decode as 1, matching the reference's `dpos <= dneg`).

Complex values are carried as (re, im) float32 pairs throughout, so every
contraction is a plain real f32 (or bf16) matrix product.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp


# The f32-faithful matmul used where operand dynamic range forbids bf16 (the
# forward stage-2 contraction; see precision()). On the GPU
# `jax.lax.Precision.HIGH` is ONE TF32 pass: operands keep 10 explicit
# mantissa bits, which is not f32-faithful — at 4K its corner spectra miss
# float64 by up to 0.78 of a walk bin's decision margin. BF16_BF16_F32_X3
# splits each f32 operand into three bf16 parts and sums the cross products
# in f32 (three bf16 tensor-core passes, "bf16_3x"): within 0.016 of the
# margin, the cheapest dot algorithm that stays f32-faithful (chip_smoke.py
# phase 3 measures the candidates; phase 4 their payload BER).
ACCURATE = jax.lax.DotAlgorithmPreset.BF16_BF16_F32_X3


def precision():
    """Per-stage matmul modes for the corner DFTs
    (STEGANOSAURUS_MM_PRECISION). Returns a 4-tuple
    (stage1, fwd_stage2, ifft_stage2, ifft_stage1): stage1 covers the
    matmuls whose LHS operand is the exact u8 plane data, the others the
    contractions over intermediate f32 spectra. Each entry is "bf16" (bf16
    operands, f32 accumulation), an explicit XLA precision (ACCURATE or
    HIGHEST), or, for fwd_stage2 only, "adaptive"/"split" (a per-column mix
    of bf16 and ACCURATE, see _fwd_y_split).

    - "mix_adaptive" (DEFAULT): "mix" but the forward stage-2 contraction
      runs bf16 on all corner columns EXCEPT the top-X0 (default 64 of 1024
      at 4K) ranked by measured per-(image, plane) column energy, which run
      at ACCURATE — ranking by column energy is ranking by expected bf16
      contraction error (see _fwd_y_split), so adversarial spectra protect
      themselves.
    - "mix_split": "mix_adaptive" but the ACCURATE band is the STATIC low-x
      window [0, X0) (no energy ranking, no gather/scatter). Correct for
      natural-image spectra; covers with strong texture at an in-corner
      horizontal frequency >= X0 lose raw BER (errors concentrate in few
      columns and Rep-7 copies are spread randomly, so it degrades
      gracefully).
    - "mix": stage1 and BOTH delta-IFFT stages bf16; only the forward
      stage2 at ACCURATE. Why this split:
        * stage1's operands are a u8 plane (every integer <= 255 is EXACT
          in bf16) and a cos/sin table (|e| <= 1, 2^-9 relative rounding).
          The product error is ~2^-9 * sqrt(W) * E|plane| ~ tens, absolute,
          per output element — two orders below the walk-bin signal
          (mag*sin(alpha) ~ 1e4 on typical covers).
        * the forward stage2's operands are partially-transformed spectra
          whose columns near x=0 carry the image's low-frequency energy —
          values up to ~1e6 next to walk-bin signals of ~1e4. bf16's 8-bit
          mantissa on THOSE operands puts ~0.2% of the large values onto
          the small ones after contraction: bit flips concentrated at
          low-x walk bins (full bf16 breaks 4K/16KB recovery). An
          f32-faithful product is immune to the dynamic range.
        * the delta-IFFT operands carry the masked walk delta — no DC
          term, mild dynamic range — and bf16 there leaves the channel
          indistinguishable from "highest" (same raw BER, post-ECC 0).
    - "mix_conservative": every stage2-class matmul at ACCURATE.
    - "mix2": the forward stage2 and the last delta-IFFT stage at ACCURATE.
    - "high": ACCURATE everywhere (no bf16 stage).
    - "bf16": bf16 everywhere — breaks 4K/16KB recovery; measurement only.
    - "highest": full f32 products everywhere — the parity arbiter.
    """
    import os

    name = os.environ.get("STEGANOSAURUS_MM_PRECISION",
                          "mix_adaptive").lower()
    HIGHEST = jax.lax.Precision.HIGHEST
    if name == "mix_split":  # fwd stage2 ACCURATE only at the static band
        return ("bf16", "split", "bf16", "bf16")
    if name == "mix_adaptive":  # fwd stage2 ACCURATE at the top-X0 columns
        return ("bf16", "adaptive", "bf16", "bf16")
    if name in ("mix", "mix3"):
        return ("bf16", ACCURATE, "bf16", "bf16")
    if name == "mix_conservative":
        return ("bf16", ACCURATE, ACCURATE, ACCURATE)
    if name == "mix2":
        return ("bf16", ACCURATE, "bf16", ACCURATE)
    if name == "bf16":  # experimental / measurement only
        global _WARNED_BF16
        if not _WARNED_BF16:
            _WARNED_BF16 = True
            import sys

            print("steganosaurus_jax: STEGANOSAURUS_MM_PRECISION=bf16 runs "
                  "the forward stage-2 contraction in bf16, which is "
                  "MEASURED to break 4K/16KB payload recovery (operand "
                  "dynamic range ~1e6 vs ~1e4 signal) — measurement mode "
                  "only, not for real embeds", file=sys.stderr)
        return ("bf16", "bf16", "bf16", "bf16")
    p = ACCURATE if name == "high" else HIGHEST
    return (p, p, p, p)


_WARNED_BF16 = False


def _mm(subscripts, a, b, precision):
    """einsum wrapper implementing the bf16-operand/f32-accumulate mode.

    On CPU backends the same semantics are emulated by rounding the
    operands through bf16 and running the dot in f32: XLA:CPU's DotThunk
    rejects bf16 x bf16 = f32 for batched/3D dot shapes (the four-step
    factored transforms hit this), and the emulation is numerically
    identical (bf16 operand rounding, f32 products and accumulation). XLA:CPU
    also rejects most dot-algorithm presets; its f32 dot is exact f32
    products, so a preset runs there as HIGHEST."""
    cpu = jax.default_backend() == "cpu"
    if precision == "bf16":
        if cpu:
            return jnp.einsum(subscripts,
                              a.astype(jnp.bfloat16).astype(jnp.float32),
                              b.astype(jnp.bfloat16).astype(jnp.float32),
                              precision=jax.lax.Precision.HIGHEST)
        return jnp.einsum(subscripts, a.astype(jnp.bfloat16),
                          b.astype(jnp.bfloat16),
                          preferred_element_type=jnp.float32)
    if cpu and isinstance(precision, jax.lax.DotAlgorithmPreset):
        precision = jax.lax.Precision.HIGHEST
    return jnp.einsum(subscripts, a, b, precision=precision)


def _small_p(p):
    """Precision for the four-step transforms' SMALL contractions (the
    twiddle-merged group sums, contraction length 8-30): their flops are
    negligible next to the radix-N1 matmuls, so never spend bf16's operand
    rounding there — full f32 products unless the caller asked for a
    specific XLA precision."""
    return jax.lax.Precision.HIGHEST if p == "bf16" else p


@functools.lru_cache(maxsize=64)
def axis_plan(N: int, K: int) -> int:
    """Four-step split radix N1 for a length-N transform axis with K corner
    outputs, or 0 for the dense pruned-DFT matmul.

    The dense matmul contracts N (or emits K) with per-element cost ~2K
    MACs; a Bailey four-step factorization N = N1*N2 costs ~2*N1 (+ small)
    per element — an ~K/N1 arithmetic reduction (~8x at 4K where K=1024,
    N1=128). N1 is chosen among divisors of N to maximize its density in
    128-wide tiles, d / (128*ceil(d/128)); density < 0.82 or N < 512 stays
    dense.

    DEFAULT OFF: on the accelerator this repo was first built for, the
    factored step measured slower end to end despite the ~7x arithmetic cut
    (its radix-batched small matmuls and per-stage reshapes schedule worse
    than the dense pruned DFT's large matmuls). On the H100 it is not
    measured. STEGANOSAURUS_CORNER_FACTORED=1 opts in."""
    import os

    if os.environ.get("STEGANOSAURUS_CORNER_FACTORED", "0") != "1":
        return 0
    if N < 512 or K < 1:
        return 0
    best, score = 0, 0.82
    for d in range(64, 193):
        if N % d == 0:
            s = d / (128.0 * -(-d // 128))
            if s > score:
                best, score = d, s
    return best


@functools.lru_cache(maxsize=32)
def _factored_tables(N: int, K: int, N1: int):
    """HOST numpy f32 four-step tables (e1r, e1i, cr, ci) for one axis.

    E1[a, b] = exp(+2j*pi*a*b/N1), (N1, N1) — the radix transform, shared
    by both directions (it is symmetric).
    C[j1, j2, m] = exp(+2j*pi*m*(j1 + N1*j2)/N), (N1, ceil(K/N1), N//N1) —
    the twiddle MERGED with the short transform: for the forward direction
    j is the output index k (k = k1 + N1*k2) contracted over m = n2; for
    the inverse, j is the input index x contracted over j2 = group, m = w2.
    One table pair serves both (the reference's +2pi forward convention,
    steganosaur.cpp:347, conj of numpy's). Exact int64 angle reduction as
    in _dft_tables."""
    import numpy as np

    N2, ng = N // N1, -(-K // N1)
    j1 = np.arange(N1, dtype=np.int64)
    a1 = ((j1[:, None] * j1[None, :]) % N1).astype(np.float32) * np.float32(
        2.0 * math.pi / N1)
    jj = j1[:, None, None] + N1 * np.arange(ng, dtype=np.int64)[None, :, None]
    a2 = ((jj * np.arange(N2, dtype=np.int64)[None, None, :]) % N).astype(
        np.float32) * np.float32(2.0 * math.pi / N)
    return (np.cos(a1, dtype=np.float32), np.sin(a1, dtype=np.float32),
            np.cos(a2, dtype=np.float32), np.sin(a2, dtype=np.float32))


def _fwd_last_fact(v, K, tabs, p):
    """Four-step forward DFT along the LAST axis of real `v` (..., N) ->
    (re, im) (..., K). Inner radix-N1 matmul at stage precision; short
    twiddle-merged sum at _small_p."""
    e1r, e1i, ct_r, ct_i = tabs
    N1, ng, N2 = e1r.shape[0], ct_r.shape[1], ct_r.shape[2]
    lead = v.shape[:-1]
    sp = _small_p(p)
    y = v.reshape(*lead, N1, N2)
    ar = _mm("...nm,kn->...km", y, e1r, p)
    ai = _mm("...nm,kn->...km", y, e1i, p)
    xr = (_mm("...km,kjm->...kj", ar, ct_r, sp)
          - _mm("...km,kjm->...kj", ai, ct_i, sp))
    xi = (_mm("...km,kjm->...kj", ar, ct_i, sp)
          + _mm("...km,kjm->...kj", ai, ct_r, sp))
    xr = jnp.swapaxes(xr, -1, -2).reshape(*lead, ng * N1)[..., :K]
    xi = jnp.swapaxes(xi, -1, -2).reshape(*lead, ng * N1)[..., :K]
    return xr, xi


def _fwd_y_fact(vr, vi, K, tabs, p):
    """Four-step forward DFT along axis -2 of complex (vr, vi)
    (..., N, X) -> (..., K, X)."""
    e1r, e1i, ct_r, ct_i = tabs
    N1, ng, N2 = e1r.shape[0], ct_r.shape[1], ct_r.shape[2]
    lead, X = vr.shape[:-2], vr.shape[-1]
    sp = _small_p(p)
    yr = vr.reshape(*lead, N1, N2, X)
    yi = vi.reshape(*lead, N1, N2, X)
    ar = (_mm("...nmx,kn->...kmx", yr, e1r, p)
          - _mm("...nmx,kn->...kmx", yi, e1i, p))
    ai = (_mm("...nmx,kn->...kmx", yr, e1i, p)
          + _mm("...nmx,kn->...kmx", yi, e1r, p))
    xr = (_mm("...knx,kjn->...jkx", ar, ct_r, sp)
          - _mm("...knx,kjn->...jkx", ai, ct_i, sp))
    xi = (_mm("...knx,kjn->...jkx", ar, ct_i, sp)
          + _mm("...knx,kjn->...jkx", ai, ct_r, sp))
    xr = xr.reshape(*lead, ng * N1, X)[..., :K, :]
    xi = xi.reshape(*lead, ng * N1, X)[..., :K, :]
    return xr, xi


def _ifft_y_fact(mr, mi, H, tabs, p):
    """Four-step inverse-direction sum over axis -2: complex (..., K, X) ->
    complex (..., H, X), t[h] = sum_y M[y] e^{+2j*pi*y*h/H}."""
    e1r, e1i, ct_r, ct_i = tabs
    N1, ng, N2 = e1r.shape[0], ct_r.shape[1], ct_r.shape[2]
    lead, K, X = mr.shape[:-2], mr.shape[-2], mr.shape[-1]
    sp = _small_p(p)
    pad = ng * N1 - K
    if pad:
        pw = [(0, 0)] * len(lead) + [(0, pad), (0, 0)]
        mr, mi = jnp.pad(mr, pw), jnp.pad(mi, pw)
    mr = mr.reshape(*lead, ng, N1, X)
    mi = mi.reshape(*lead, ng, N1, X)
    dr = (_mm("...gyx,ygm->...ymx", mr, ct_r, sp)
          - _mm("...gyx,ygm->...ymx", mi, ct_i, sp))
    di = (_mm("...gyx,ygm->...ymx", mr, ct_i, sp)
          + _mm("...gyx,ygm->...ymx", mi, ct_r, sp))
    tr = (_mm("...ymx,yk->...kmx", dr, e1r, p)
          - _mm("...ymx,yk->...kmx", di, e1i, p))
    ti = (_mm("...ymx,yk->...kmx", dr, e1i, p)
          + _mm("...ymx,yk->...kmx", di, e1r, p))
    return tr.reshape(*lead, H, X), ti.reshape(*lead, H, X)


def _ifft_last_fact(mr, mi, N, tabs, p):
    """Four-step inverse-direction sum over the LAST axis, REAL part only:
    complex (..., K) -> real (..., N), t[w] = Re(sum_x M[x] e^{+2j*pi*x*w/N})."""
    e1r, e1i, ct_r, ct_i = tabs
    N1, ng, N2 = e1r.shape[0], ct_r.shape[1], ct_r.shape[2]
    lead, K = mr.shape[:-1], mr.shape[-1]
    sp = _small_p(p)
    pad = ng * N1 - K
    if pad:
        pw = [(0, 0)] * len(lead) + [(0, pad)]
        mr, mi = jnp.pad(mr, pw), jnp.pad(mi, pw)
    m2r = mr.reshape(*lead, ng, N1)
    m2i = mi.reshape(*lead, ng, N1)
    dr = (_mm("...gx,xgm->...xm", m2r, ct_r, sp)
          - _mm("...gx,xgm->...xm", m2i, ct_i, sp))
    di = (_mm("...gx,xgm->...xm", m2r, ct_i, sp)
          + _mm("...gx,xgm->...xm", m2i, ct_r, sp))
    t = (_mm("...xm,xk->...km", dr, e1r, p)
         - _mm("...xm,xk->...km", di, e1i, p))
    return t.reshape(*lead, N)


def corner_dims(H: int, W: int, rmax: float) -> tuple[int, int]:
    """(Ky, Kx) corner size covering every walk-accepted primary bin.

    hypot(y, x) <= rmax*min(H,W) implies y, x <= floor(rmax*min(H,W)), so
    K = floor(..)+1 rows/cols suffice; rounded up to a multiple of 256 (a
    whole number of 64-row Hopper wgmma tiles and of the 128/256-wide GEMM
    tiles cuBLAS picks, so no tile runs part-empty; K also sets the matmul
    work, which is why the rounding is kept fixed) and clamped to the grid
    (small images degenerate to the full DFT, which is still exact).
    """
    b = int(math.floor(rmax * min(H, W))) + 1
    k = -(-b // 256) * 256
    return min(k, H), min(k, W)


@functools.lru_cache(maxsize=16)
def _dft_tables(N: int, K: int):
    """HOST numpy (K, N) f32 tables (re, im) of exp(+2j*pi*k*n/N).

    The +2pi sign is the REFERENCE forward convention (conj of numpy's,
    steganosaur.cpp:347). The angle argument is reduced with an exact int64
    mod — so table phases are accurate to f32 sin/cos, not to a rounded
    float product.

    Host-built and passed to the corner cores as ARGUMENTS (never closure
    constants): a device array captured by a traced function is pulled back
    to host during lowering and baked (~49 MB of table data at 4K) into
    every compiled module variant. As arguments they upload once per
    placement (dft_tables_device) and every module shares them.
    """
    import numpy as np

    k = np.arange(K, dtype=np.int64)[:, None]
    n = np.arange(N, dtype=np.int64)[None, :]
    ang = ((k * n) % N).astype(np.float32) * np.float32(2.0 * math.pi / N)
    return np.cos(ang, dtype=np.float32), np.sin(ang, dtype=np.float32)


_DEV_TABLES: dict = {}


def _axis_tables_host(N: int, K: int):
    """Host f32 tables for one transform axis: the four-step set (4 arrays)
    when axis_plan elects factoring, the dense (K, N) pair otherwise."""
    N1 = axis_plan(N, K)
    return _factored_tables(N, K, N1) if N1 else _dft_tables(N, K)


def dft_tables_device(H: int, Ky: int, W: int, Kx: int, mesh=None):
    """Flat tuple of device-resident f32 transform tables for an (H, W)
    grid's (Ky, Kx) corner — y-axis tables first, then x-axis; each axis
    contributes 2 (dense pruned-DFT) or 4 (four-step factored, see
    axis_plan) arrays. Consumers split via _split_tabs. Uploaded once per
    (dims, plan, mesh) and cached (replicated over the mesh when given)."""
    key = (H, Ky, W, Kx, axis_plan(H, Ky), axis_plan(W, Kx), mesh)
    ent = _DEV_TABLES.get(key)
    if ent is None:
        host = _axis_tables_host(H, Ky) + _axis_tables_host(W, Kx)
        if mesh is None:
            put = jax.device_put
        else:
            from jax.sharding import NamedSharding, PartitionSpec

            sh = NamedSharding(mesh, PartitionSpec())
            put = lambda a: jax.device_put(a, sh)  # noqa: E731
        ent = tuple(put(a) for a in host)
        _DEV_TABLES[key] = ent
        while len(_DEV_TABLES) > 16:
            _DEV_TABLES.pop(next(iter(_DEV_TABLES)))
    return ent


def _split_tabs(H: int, Ky: int, W: int, Kx: int, tabs):
    """(y_tabs, x_tabs) from the flat dft_tables_device tuple."""
    ny = 4 if axis_plan(H, Ky) else 2
    return tabs[:ny], tabs[ny:]


def fwd_corner(planes, Ky, Kx, tabs, precision):
    """planes (..., H, W) f32 real -> corner spectrum (re, im) (..., Ky, Kx).

    C[y, x] = sum_{h,w} planes[h,w] * e^{+2pi*i*(yh/H + xw/W)}; the big
    dimension (w) is contracted first so the widest matmul runs on the
    smaller operand. precision is the 4-tuple from precision(): stage1
    contracts the exact u8 planes, fwd_stage2 the f32 intermediates (see
    precision() for why they differ). tabs is the dft_tables_device tuple;
    per axis_plan each stage runs either as the dense pruned-DFT matmul or
    the four-step factored form (~K/N1 ~ 8x fewer MACs at 4K).

    Separate re/im dots rather than one stacked (2K, ·) dot per stage: the
    stacked form materializes a concat and slices, extra device-memory
    traffic that the separate dots avoid.
    """
    p1, p2 = precision[0], precision[1]
    H, W = planes.shape[-2], planes.shape[-1]
    ty, tx = _split_tabs(H, Ky, W, Kx, tabs)
    if len(tx) == 4:
        ar, ai = _fwd_last_fact(planes, Kx, tx, p1)
    else:
        exr, exi = tx
        ar = _mm("...hw,xw->...hx", planes, exr, p1)
        ai = _mm("...hw,xw->...hx", planes, exi, p1)
    if len(ty) == 4:
        if p2 in ("split", "adaptive"):  # factored path: no column split
            p2 = ACCURATE
        cr, ci = _fwd_y_fact(ar, ai, Ky, ty, p2)
    else:
        eyr, eyi = ty
        if p2 in ("split", "adaptive"):
            return _fwd_y_split(ar, ai, ty, adaptive=(p2 == "adaptive"))
        cr = (_mm("yh,...hx->...yx", eyr, ar, p2)
              - _mm("yh,...hx->...yx", eyi, ai, p2))
        ci = (_mm("yh,...hx->...yx", eyr, ai, p2)
              + _mm("yh,...hx->...yx", eyi, ar, p2))
    return cr, ci


def split_x0() -> int:
    """Width of the fwd stage-2 high-accuracy column band (see
    _fwd_y_split). Env-tunable for measurement (STEGANOSAURUS_SPLIT_X0)."""
    import os

    return int(os.environ.get("STEGANOSAURUS_SPLIT_X0", "64"))


def _fwd_y_split(ar, ai, ty, adaptive: bool = False):
    """Forward stage-2 y-contraction with column-split precision.

    The y stage's bf16 hazard is operand dynamic range: stage-1 output
    column x carries the image's energy at horizontal frequency x, so the
    high-energy columns hold values up to ~1e6 next to ~1e4 walk-bin
    signals, and bf16's 8-bit mantissa on THOSE operands flips decoded bits
    (which is why the whole stage can run at ACCURATE). But the contraction
    is over h: a rounding error in operand column x lands ONLY in output
    column x, with absolute size ~2^-9 * sqrt(sum_h |a[h,x]|^2) —
    proportional to the COLUMN's energy, independent of the walk-bin signal
    there. So the narrow high-energy band gets ACCURATE and every other
    column runs bf16 at the tensor cores' full rate.

    adaptive=False (mix_split): the band is the static low-x window
    [0, X0) — correct for natural-image spectra (energy ~1/f, concentrated
    at low horizontal frequency), measured +2-10% raw BER on adversarial
    covers whose texture peaks at a higher in-corner frequency.

    adaptive=True (mix_adaptive): the band is the top-X0 columns ranked by
    measured column energy PER (image, plane) — ranking by energy IS
    ranking by expected bf16 error, so adversarial spectra protect
    themselves. Columns are gathered, contracted at ACCURATE, and scattered
    over the bf16 result via an exact one-hot matmul (take_along_axis has
    no scatter dual with batch dims; the one-hot contraction at HIGHEST is
    exact and selects between the two numerics — no third value is ever
    produced).
    """
    eyr, eyi = ty
    X0 = min(split_x0(), ar.shape[-1])
    if X0 == ar.shape[-1]:  # degenerate (tiny corner): plain ACCURATE
        cr = (_mm("yh,...hx->...yx", eyr, ar, ACCURATE)
              - _mm("yh,...hx->...yx", eyi, ai, ACCURATE))
        ci = (_mm("yh,...hx->...yx", eyr, ai, ACCURATE)
              + _mm("yh,...hx->...yx", eyi, ar, ACCURATE))
        return cr, ci
    if not adaptive:
        crs, cis = [], []
        for sl, p in ((slice(0, X0), ACCURATE), (slice(X0, None), "bf16")):
            a_r, a_i = ar[..., sl], ai[..., sl]
            crs.append(_mm("yh,...hx->...yx", eyr, a_r, p)
                       - _mm("yh,...hx->...yx", eyi, a_i, p))
            cis.append(_mm("yh,...hx->...yx", eyr, a_i, p)
                       + _mm("yh,...hx->...yx", eyi, a_r, p))
        return (jnp.concatenate(crs, axis=-1), jnp.concatenate(cis, axis=-1))
    X = ar.shape[-1]
    energy = jnp.sum(ar * ar + ai * ai, axis=-2)          # (..., X)
    _, idx = jax.lax.top_k(energy, X0)                    # (..., X0)
    onehot = (idx[..., :, None] ==
              jnp.arange(X)[None, :]).astype(jnp.float32)  # (..., X0, X)
    # gather the selected columns as an exact 0/1 contraction (f32 products
    # of exact values at HIGHEST — no rounding)
    ag_r = _mm("...hx,...kx->...hk", ar, onehot, jax.lax.Precision.HIGHEST)
    ag_i = _mm("...hx,...kx->...hk", ai, onehot, jax.lax.Precision.HIGHEST)
    import os

    if os.environ.get("STEGANOSAURUS_STAGE1_STORE") == "bf16":
        # Measurement variant: force a MATERIALIZED bf16 copy of the
        # stage-1 output before the band matmuls, halving their device-
        # memory read vs XLA's default fuse-the-convert-into-the-read. The
        # ACCURATE band's f32 gather above is unaffected (reads the f32
        # original). The barrier stops XLA from folding the copy away.
        ar, ai = jax.lax.optimization_barrier(
            (ar.astype(jnp.bfloat16), ai.astype(jnp.bfloat16)))
    cr = (_mm("yh,...hx->...yx", eyr, ar, "bf16")
          - _mm("yh,...hx->...yx", eyi, ai, "bf16"))
    ci = (_mm("yh,...hx->...yx", eyr, ai, "bf16")
          + _mm("yh,...hx->...yx", eyi, ar, "bf16"))
    hr = (_mm("yh,...hk->...yk", eyr, ag_r, ACCURATE)
          - _mm("yh,...hk->...yk", eyi, ag_i, ACCURATE))
    hi = (_mm("yh,...hk->...yk", eyr, ag_i, ACCURATE)
          + _mm("yh,...hk->...yk", eyi, ag_r, ACCURATE))
    # scatter-by-one-hot: selected columns take the ACCURATE value exactly
    sel = jnp.max(onehot, axis=-2)                        # (..., X) 0/1
    put = jax.lax.Precision.HIGHEST
    cr = cr * (1.0 - sel[..., None, :]) + _mm(
        "...yk,...kx->...yx", hr, onehot, put)
    ci = ci * (1.0 - sel[..., None, :]) + _mm(
        "...yk,...kx->...yx", hi, onehot, put)
    return cr, ci


def ifft_corner_real(dr, di, H, W, tabs, precision):
    """real(IFFT2(Delta)) for a corner-supported Delta = (dr, di).

    ifft2_real under the reference convention is
    (1/(H*W)) * Re( sum conj(Delta)[y,x] * e^{+2pi*i*(yh/H + xw/W)} )
    (spectral.ifft2_real). With Dc = conj(Delta) = (dr, -di):
    M = Ey^T @ Dc (contract y), then Re(M @ Ex) (contract x).

    Both stages contract the masked walk delta (mild dynamic range, no DC
    term) and run at precision()'s ifft modes (bf16 under the default mix;
    see precision()). Per axis_plan each stage runs dense or four-step
    factored.

    Separate re/im dots, for the same measured reason as fwd_corner.
    """
    p2, p3 = precision[3], precision[2]
    Ky, Kx = dr.shape[-2], dr.shape[-1]
    ty, tx = _split_tabs(H, Ky, W, Kx, tabs)
    dcr, dci = dr, -di
    if len(ty) == 4:
        mr, mi = _ifft_y_fact(dcr, dci, H, ty, p2)
    else:
        eyr, eyi = ty
        mr = (_mm("yh,...yx->...hx", eyr, dcr, p2)
              - _mm("yh,...yx->...hx", eyi, dci, p2))
        mi = (_mm("yh,...yx->...hx", eyr, dci, p2)
              + _mm("yh,...yx->...hx", eyi, dcr, p2))
    if len(tx) == 4:
        t = _ifft_last_fact(mr, mi, W, tx, p3)
    else:
        exr, exi = tx
        t = (_mm("...hx,xw->...hw", mr, exr, p3)
             - _mm("...hx,xw->...hw", mi, exi, p3))
    return t * jnp.float32(1.0 / (H * W))


def write_delta(cr, ci, sign, mask, cos_a, sin_a, cjd=None, sjd=None,
                soft: bool = False):
    """Dense phase-write delta over the corner (reference write_bit_on_bin,
    steganosaur.cpp:712-732, vectorized to the whole corner at once).

    cr/ci: (..., Ky, Kx) corner spectrum. sign: per-image bit sign (+1/-1)
    f32, same shape. mask: (3, Ky, Kx) f32 1.0 where a walk bin lives.
    cos_a/sin_a: scalars cos(alpha), sin(alpha) — or (3, Ky, Kx) static maps
    of cos/sin(alpha_i) when the write amplitude is per-bin
    (Params.alpha_spread; pipeline/spread.py): every use below is
    elementwise, so maps broadcast exactly like the scalars. cjd/sjd: static
    per-walk cos/sin jitter maps (3, Ky, Kx), or None when jitter == 0.

    soft=True (params.soft_write): minimal-energy write — bins whose phase
    already decodes to the right bit with margin >= alpha are left
    UNTOUCHED (exact-zero delta) and the rest are clamped to the nearest
    point at margin exactly alpha in the correct half-plane; see
    ops.phase.embed_phases for the derivation (the decode rule is a
    half-plane test, so every soft-written bin keeps a decision margin >=
    the hard write's while total write energy drops ~2.8x). Done in
    cartesian form in the jitter-rotated frame: u = v * e^{-i*jd},
    valid iff s*sigma*u_i >= mag*|sin a|, clamp target
    u' = (sign(u_r)*mag*|cos a|, s*sigma*mag*|sin a|), rotate back.

    Returns (dr, di) with value 2*(nv - v) at walk bins (the Hermitian-half
    pre-doubled write; consumers take real(IFFT), ops/phase.py) and 0
    elsewhere. mag uses the same 1e-12 floor as ops.phase.embed_phases.
    """
    mag = jnp.sqrt(cr * cr + ci * ci)
    mag = jnp.maximum(jnp.float32(1e-12), mag)
    if soft:
        sigma = jnp.where(jnp.asarray(sin_a) < 0, -1.0, 1.0)
        abs_sin, abs_cos = jnp.abs(jnp.asarray(sin_a)), jnp.abs(
            jnp.asarray(cos_a))
        if cjd is None:
            u_r, u_i = cr, ci
        else:
            u_r = cr * cjd + ci * sjd
            u_i = ci * cjd - cr * sjd
        valid = sign * sigma * u_i >= mag * abs_sin
        t_r = jnp.where(u_r < 0, -1.0, 1.0) * (mag * abs_cos)
        t_i = (sign * sigma) * (mag * abs_sin)
        if cjd is None:
            nv_r, nv_i = t_r, t_i
        else:
            nv_r = t_r * cjd - t_i * sjd
            nv_i = t_r * sjd + t_i * cjd
        dr = (2.0 * mask) * jnp.where(valid, 0.0, nv_r - cr)
        di = (2.0 * mask) * jnp.where(valid, 0.0, nv_i - ci)
        return dr, di
    if cjd is None:
        cos_t = cos_a
        sin_t = sign * sin_a
    else:
        # theta = jd + s*alpha
        cos_t = cjd * cos_a - sign * (sjd * sin_a)
        sin_t = sjd * cos_a + sign * (cjd * sin_a)
    dr = (2.0 * mask) * (mag * cos_t - cr)
    di = (2.0 * mask) * (mag * sin_t - ci)
    return dr, di


def apply_write_floor(dr, di, cr, ci, floor: float, img_pixels: float):
    """Quantization write floor for the dense corner write (the corner twin
    of ops.phase.write_floor_boost; Params.write_floor has the physics).

    dr/di: (..., 3, Ky, Kx) pre-doubled Hermitian-half deltas from
    write_delta / write_delta_qim — value 2*(nv - v) at moved bins, exactly
    0 elsewhere (soft-valid and unmasked bins), so the moved-bin mask is
    simply D != 0. cr/ci: the cover corner spectrum (v). Per-IMAGE boost b
    (reduction over the trailing plane/corner axes, batch axes broadcast):

        effective spectral delta  D_eff(b) = b*nv - v = (b-1)*v + b*h,
        h = D/2;  E(b) = (b-1)^2 V + 2b(b-1) X + b^2 Hs
        with V = sum wm*|v|^2, X = sum Re(h conj v), Hs = sum |h|^2;
        rho(b)^2 = 2 E(b) / (3 * img_pixels^2)  (Parseval; both mirrors).

    Solving rho(b) = floor gives b = [(V+X) + sqrt((V+X)^2 - p(V - E*))]/p
    with p = V + 2X + Hs = sum wm*|nv|^2, clipped to [1, 32]. The boosted
    pre-doubled delta is D_b = 2*(b*nv - v) = b*D + 2*(b-1)*wm*v — phases
    stay exactly on target, so b=1 is bit-identical to the plain write."""
    # 1/img_pixels pre-scaling keeps the quadratic's squares inside f32
    # (raw (V+X)^2 overflows at large-cover magnitudes); b is
    # scale-invariant — see ops.phase.write_floor_boost.
    s = jnp.asarray(1.0 / img_pixels, dr.dtype)
    hr, hi = (0.5 * s) * dr, (0.5 * s) * di
    wm = ((hr * hr + hi * hi) > 0).astype(dr.dtype)
    crs, cis = cr * s, ci * s
    axes = (-3, -2, -1)
    V = jnp.sum(wm * (crs * crs + cis * cis), axes, keepdims=True)
    X = jnp.sum(crs * hr + cis * hi, axes, keepdims=True)
    Hs = jnp.sum(hr * hr + hi * hi, axes, keepdims=True)
    p = V + 2.0 * X + Hs
    e_star = jnp.asarray(1.5 * floor ** 2, dr.dtype)
    disc = jnp.maximum((V + X) ** 2 - p * (V - e_star), 0.0)
    b = jnp.clip((V + X + jnp.sqrt(disc)) / jnp.maximum(p, 1e-30),
                 1.0, 32.0)
    return (b * dr + 2.0 * (b - 1.0) * wm * cr,
            b * di + 2.0 * (b - 1.0) * wm * ci)


def qim_values_dense(cr, ci, dq, L: int):
    """Dense QIM decision values over the corner: -cos(L*(theta - d)) * mag
    (pipeline/qim.py decode rule; sign >= 0 -> bit 1, |value| is the
    magnitude-weighted coset confidence for ops.ecc.rep_decode_soft).
    dq: (3, Ky, Kx) static dither-angle map (corner_statics_core)."""
    mag = jnp.sqrt(cr * cr + ci * ci)
    theta = jnp.arctan2(ci, cr)
    return -jnp.cos(L * (theta - dq)) * mag


def write_delta_qim(cr, ci, sign, mask, qm, cos_a, sin_a, dq, L: int,
                    cjd=None, sjd=None, soft: bool = False):
    """write_delta with the PAYLOAD bins quantized by dithered phase QIM
    (Params.qim; pipeline/qim.py) while header bins keep the reference
    hard/soft write.

    qm: (3, Ky, Kx) f32, 1.0 at payload walk bins (frame slot >= the header
    stream length), 0 elsewhere. dq: static dither-angle map (same shape).
    The header part runs the unchanged write_delta over mask*(1-qm); the
    payload part sets each bin's phase to the nearest point of its bit's
    dithered lattice coset: theta' = d + (round((theta-d)/Delta - b/2)
    + b/2)*Delta, Delta = 2*pi/L (ops/phase.embed_phases_qim, dense form).
    Returns the summed pre-doubled Hermitian-half deltas."""
    mask_hdr = mask * (1.0 - qm)
    dr, di = write_delta(cr, ci, sign, mask_hdr, cos_a, sin_a, cjd, sjd,
                         soft=soft)
    mag = jnp.maximum(jnp.float32(1e-12), jnp.sqrt(cr * cr + ci * ci))
    theta = jnp.arctan2(ci, cr)
    delta = jnp.float32(2.0 * math.pi / L)
    half_b = (sign + 1.0) * 0.25          # bit/2 from the +-1 sign plane
    q = (theta - dq) / delta - half_b
    th_q = dq + (jnp.round(q) + half_b) * delta
    dr = dr + (2.0 * qm) * (mag * jnp.cos(th_q) - cr)
    di = di + (2.0 * qm) * (mag * jnp.sin(th_q) - ci)
    return dr, di


def read_bits_dense(cr, ci, sign_sin_a, cjd=None, sjd=None):
    """Dense phase read: u8 bit plane over the corner.

    bit = 1 iff sign(sin a) * sin(th - jd) >= 0 (see module docstring); with
    sin(a) == 0 the decision value is exactly 0 and every bit decodes 1,
    matching the reference's tie rule.
    """
    if cjd is None:
        d = ci
    else:
        d = ci * cjd - cr * sjd
    return (d * sign_sin_a >= 0).astype(jnp.uint8)


def read_bits_dense_qim(cr, ci, sign_sin_a, qm, dq, L: int,
                        cjd=None, sjd=None):
    """read_bits_dense with payload bins decoded by the QIM nearest-coset
    rule (qm/dq as in write_delta_qim): bit = 1 iff -cos(L*(theta-d)) >= 0
    at payload bins, the half-plane test elsewhere."""
    hard = read_bits_dense(cr, ci, sign_sin_a, cjd, sjd)
    qim = (qim_values_dense(cr, ci, dq, L) >= 0).astype(jnp.uint8)
    return jnp.where(qm > 0, qim, hard)


def decision_values_dense_qim(cr, ci, sign_sin_a, qm, dq, L: int,
                              cjd=None, sjd=None):
    """Blended soft-decision values: QIM coset confidence at payload bins,
    the half-plane value sign(sin a)*(Im*cos(jd) - Re*sin(jd)) elsewhere.
    Every Rep-3/Rep-7 copy group lies entirely on one side of the header/
    payload split, so the two scales never mix inside a combiner group."""
    hard = ci if cjd is None else ci * cjd - cr * sjd
    hard = hard * sign_sin_a
    return jnp.where(qm > 0, qim_values_dense(cr, ci, dq, L), hard)
