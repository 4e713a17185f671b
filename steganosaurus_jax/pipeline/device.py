"""Device compute cores for the embed/extract pipelines.

Three pure functions per backend:
- analyze:     planes -> (spectrum, medians, capacity_bits, cover_features)
- embed_apply: spectrum + bit/bin arrays -> stego u8 image
- read_bits:   spectrum + bin arrays -> raw embedded bits

Backends:
- "jax" (default): complex64, jitted, runs on the device. Everything between PNG
  decode and PNG encode is one traced graph per call; host<->device traffic is
  the planes in, the u8 stego out, and the small index arrays.
- "numpy": complex128 on host — bit-for-bit the reference's arithmetic
  (double FFT, double phase math). Used as the CPU parity arbiter
  (SURVEY.md §7 "precision parity") and as the test oracle.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from steganosaurus_jax import spectral
from steganosaurus_jax.parallel import transfer
from steganosaurus_jax.ops import mask as mask_ops
from steganosaurus_jax.ops import phase as phase_ops
from steganosaurus_jax.keystream import conj_idx

# ---------------------------------------------------------------------------
# JAX backend
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=32)
def _jit_analyze(H, W, PH, PW, center, rmin, rmax, magmin):
    @jax.jit
    def analyze(planes):
        p = spectral.apply_center(planes, center)
        padded = spectral.pad_planes(p, PH, PW)
        spec = spectral.fft2(padded)
        med = spectral.median_abs(spec)
        thr = (magmin * med).astype(med.dtype)
        cap = mask_ops.capacity_bits(spec, thr, rmin, rmax)
        feat = spectral.cover_hash_features(spec)
        # f32 returns (capacity < 2^24 and feat values 0..7 are exact in
        # f32); the host restores their integer types.
        return spec, med, cap.astype(jnp.float32), feat.astype(jnp.float32)

    return analyze


# Single-image graphs are compiled per index-array LENGTH. Bucketing the
# length to a 4096 multiple (same discipline as pipeline/batch.py) makes
# nearby secret sizes share one compiled graph: the CLI path stops paying a
# fresh XLA compile for every new payload length.
_BUCKET = 4096


def _bucket_pad(arrs, n):
    """Tail-pad each (n,) array to the 4096 bucket by repeating its last
    element. Padded walk slots re-write/re-read the last real bin with its
    real bit/jitter — duplicate writes of identical values, never read back
    (callers slice read results to n)."""
    b = -(-n // _BUCKET) * _BUCKET
    if b == n:
        return arrs
    return [np.concatenate([a, np.repeat(a[-1:], b - n, axis=0)])
            for a in (np.asarray(a) for a in arrs)]


@functools.lru_cache(maxsize=32)
def _jit_embed_apply(H, W, center, adaptive, soft=False, qim_levels=0,
                     hdr_bits=0, floor=0.0, coherent=False):
    PH, PW = spectral.fft_dims(H, W)
    gain = (H * W) / (PH * PW)  # crop retention; see phase_ops.embed_phases
    px = float(H) * W  # write-floor Parseval normalizer (Params.write_floor)

    @jax.jit
    def apply_fn(spec, med, plane, y, x, bits, jitters, alpha, n_valid,
                 dithers=None):
        if coherent:
            # Header AND payload take the channel-coherent common-mode
            # write (Params.coherent; ops/phase.py) — a standard header
            # would hand the cross-channel warden 912 single-plane writes
            # (measured AUC 1.0 from the header alone, doc/ATTACKS.md
            # §2e), so the header rides the coherent plain (hard/soft)
            # rule and extraction runs a two-rule header trial
            # (pipeline/extract.py). Payload slots compose QIM-lattice
            # common mode when qim_levels, else the same hard/soft target.
            h = slice(0, hdr_bits)
            p = slice(hdr_bits, None)
            a_h = alpha[h] if jnp.ndim(alpha) else alpha
            a_p = alpha[p] if jnp.ndim(alpha) else alpha
            spec2 = phase_ops.embed_phases_coherent(
                spec, y[h], x[h], bits[h], jitters[h], a_h,
                gain=gain, soft=soft, floor=floor, img_pixels=px)
            if qim_levels:
                spec2 = phase_ops.embed_phases_coherent_qim(
                    spec2, y[p], x[p], bits[p], dithers[p], qim_levels,
                    gain=gain, floor=floor, img_pixels=px,
                    n_valid=n_valid - hdr_bits)
            else:
                spec2 = phase_ops.embed_phases_coherent(
                    spec2, y[p], x[p], bits[p], jitters[p], a_p, gain=gain,
                    soft=soft, floor=floor, img_pixels=px,
                    n_valid=n_valid - hdr_bits)
        elif qim_levels:
            # Header slots [0, hdr_bits) keep the reference hard/soft write
            # (the header must decode before any mode is known); payload
            # slots take the dithered QIM write (pipeline/qim.py). Each
            # split write clears the floor independently (conservative:
            # energies add, so the union over-delivers by <= sqrt(2)).
            h = slice(0, hdr_bits)
            p = slice(hdr_bits, None)
            a_h = alpha[h] if jnp.ndim(alpha) else alpha  # per-bit spread
            spec2 = phase_ops.embed_phases(
                spec, plane[h], y[h], x[h], bits[h], jitters[h], a_h, med,
                adaptive, gain=gain, soft=soft, floor=floor, img_pixels=px)
            spec2 = phase_ops.embed_phases_qim(
                spec2, plane[p], y[p], x[p], bits[p], dithers[p], qim_levels,
                gain=gain, floor=floor, img_pixels=px,
                n_valid=n_valid - hdr_bits)
        else:
            spec2 = phase_ops.embed_phases(
                spec, plane, y, x, bits, jitters, alpha, med, adaptive,
                gain=gain, soft=soft, floor=floor, img_pixels=px,
                n_valid=n_valid,
            )
        planes2 = spectral.ifft2_real(spec2)[..., :H, :W]
        planes2 = spectral.apply_center(planes2, center)
        # packed as f32 words (parallel.transfer); rows act as the pack
        # batch dim.
        return transfer.pack_u8(spectral.from_planes(planes2))

    return apply_fn


@functools.lru_cache(maxsize=32)
def _jit_read_bits(adaptive):
    @jax.jit
    def read_fn(spec, med, plane, y, x, jitters, alpha):
        return phase_ops.read_phases(
            spec, plane, y, x, jitters, alpha, med, adaptive
        ).astype(jnp.int32)  # i32 not u8: fast device->host path

    return read_fn


@functools.lru_cache(maxsize=32)
def _jit_read_values(adaptive):
    @jax.jit
    def read_fn(spec, med, plane, y, x, jitters, alpha):
        return phase_ops.read_values(
            spec, plane, y, x, jitters, alpha, med, adaptive
        ).astype(jnp.float32)

    return read_fn


@functools.lru_cache(maxsize=8)
def _jit_read_qim(L, values: bool):
    @jax.jit
    def read_fn(spec, plane, y, x, dithers):
        if values:
            return phase_ops.read_values_qim(
                spec, plane, y, x, dithers, L).astype(jnp.float32)
        return phase_ops.read_phases_qim(
            spec, plane, y, x, dithers, L).astype(jnp.int32)

    return read_fn


@functools.lru_cache(maxsize=8)
def _jit_read_coherent(values: bool):
    @jax.jit
    def read_fn(spec, y, x, jitters, alpha):
        if values:
            return phase_ops.read_values_coherent(
                spec, y, x, jitters, alpha).astype(jnp.float32)
        return phase_ops.read_phases_coherent(
            spec, y, x, jitters, alpha).astype(jnp.int32)

    return read_fn


@functools.lru_cache(maxsize=8)
def _jit_read_coherent_qim(L, values: bool):
    @jax.jit
    def read_fn(spec, y, x, dithers):
        if values:
            return phase_ops.read_values_coherent_qim(
                spec, y, x, dithers, L).astype(jnp.float32)
        return phase_ops.read_phases_coherent_qim(
            spec, y, x, dithers, L).astype(jnp.int32)

    return read_fn


class JaxBackend:
    name = "jax"

    def analyze(self, planes_f64: np.ndarray, params, lazy: bool = False):
        H, W = planes_f64.shape[-2:]
        PH, PW = spectral.fft_dims(H, W)
        fn = _jit_analyze(H, W, PH, PW, params.center,
                          params.rmin, params.rmax, params.magmin)
        # u8-valued planes are exactly representable in f32.
        spec, med, cap, feat = fn(planes_f64.astype(np.float32))
        if lazy:
            # Skip the two blocking device->host pulls: capacity/feature
            # conversion waits for the whole FFT (extract never uses
            # capacity; feat only under cover_dependent_path — the caller
            # pulls via np.asarray when it actually needs them).
            return spec, med, cap, feat
        # cap/feat arrive as f32 (transfer quirk, see _jit_analyze); restore
        # the u8 feature bytes the cover hash is defined over (:415-444).
        return spec, med, int(cap), np.asarray(feat).astype(np.uint8)

    def embed_apply(self, spec, med, idx, bits, jitters, alpha, params, H, W,
                    qim_dithers=None, hdr_bits=0):
        nbits = len(bits)
        plane, y, x = _bucket_pad(idx, len(idx[0]))
        bits, jitters = _bucket_pad((bits, jitters), nbits)
        if np.ndim(alpha):  # per-bit array (Params.alpha_spread)
            (alpha,) = _bucket_pad((alpha,), nbits)
        coherent = getattr(params, "coherent", False)
        fn = _jit_embed_apply(H, W, params.center, params.adaptive_alpha,
                              params.soft_write, params.qim,
                              hdr_bits if (params.qim or coherent) else 0,
                              params.write_floor, coherent)
        args = (
            spec, med,
            jnp.asarray(plane), jnp.asarray(y), jnp.asarray(x),
            jnp.asarray(bits, jnp.uint8), jnp.asarray(jitters, jnp.float32),
            jnp.asarray(alpha, jnp.float32),
            jnp.asarray(nbits, jnp.int32),  # n_valid: un-padded slot count
        )
        if params.qim:
            (qd,) = _bucket_pad((qim_dithers,), nbits)
            args = args + (jnp.asarray(qd, jnp.float32),)
        out = fn(*args)
        return transfer.unpack_u8(np.asarray(out), (H, W, 3))

    def read_bits_coherent(self, spec, idx_yx, jitters, alpha):
        """Coherent payload read (ops.phase.read_phases_coherent): bits from
        the common-mode phase at the (y, x) sites (Params.coherent)."""
        nbits = len(jitters)
        y, x = _bucket_pad(idx_yx, len(idx_yx[0]))
        (jitters,) = _bucket_pad((jitters,), nbits)
        fn = _jit_read_coherent(values=False)
        out = fn(spec, jnp.asarray(y), jnp.asarray(x),
                 jnp.asarray(jitters, jnp.float32), jnp.float32(alpha))
        return np.asarray(out[:nbits]).astype(np.uint8)

    def read_values_coherent(self, spec, idx_yx, jitters, alpha):
        nbits = len(jitters)
        y, x = _bucket_pad(idx_yx, len(idx_yx[0]))
        (jitters,) = _bucket_pad((jitters,), nbits)
        fn = _jit_read_coherent(values=True)
        out = fn(spec, jnp.asarray(y), jnp.asarray(x),
                 jnp.asarray(jitters, jnp.float32), jnp.float32(alpha))
        return np.asarray(out[:nbits], dtype=np.float64)

    def read_bits_coherent_qim(self, spec, idx_yx, dithers, L):
        nbits = len(dithers)
        y, x = _bucket_pad(idx_yx, len(idx_yx[0]))
        (dithers,) = _bucket_pad((dithers,), nbits)
        fn = _jit_read_coherent_qim(L, values=False)
        out = fn(spec, jnp.asarray(y), jnp.asarray(x),
                 jnp.asarray(dithers, jnp.float32))
        return np.asarray(out[:nbits]).astype(np.uint8)

    def read_values_coherent_qim(self, spec, idx_yx, dithers, L):
        nbits = len(dithers)
        y, x = _bucket_pad(idx_yx, len(idx_yx[0]))
        (dithers,) = _bucket_pad((dithers,), nbits)
        fn = _jit_read_coherent_qim(L, values=True)
        out = fn(spec, jnp.asarray(y), jnp.asarray(x),
                 jnp.asarray(dithers, jnp.float32))
        return np.asarray(out[:nbits], dtype=np.float64)

    def read_bits_qim(self, spec, idx, dithers, L):
        """QIM payload read (ops.phase.read_phases_qim); dithers are the
        payload slots' keyed angles (pipeline/qim.py)."""
        nbits = len(dithers)
        plane, y, x = _bucket_pad(idx, len(idx[0]))
        (dithers,) = _bucket_pad((dithers,), nbits)
        fn = _jit_read_qim(L, values=False)
        out = fn(spec, jnp.asarray(plane), jnp.asarray(y), jnp.asarray(x),
                 jnp.asarray(dithers, jnp.float32))
        return np.asarray(out[:nbits]).astype(np.uint8)

    def read_values_qim(self, spec, idx, dithers, L):
        nbits = len(dithers)
        plane, y, x = _bucket_pad(idx, len(idx[0]))
        (dithers,) = _bucket_pad((dithers,), nbits)
        fn = _jit_read_qim(L, values=True)
        out = fn(spec, jnp.asarray(plane), jnp.asarray(y), jnp.asarray(x),
                 jnp.asarray(dithers, jnp.float32))
        return np.asarray(out[:nbits], dtype=np.float64)

    def read_bits(self, spec, med, idx, jitters, alpha, params):
        nbits = len(jitters)
        plane, y, x = _bucket_pad(idx, len(idx[0]))
        (jitters,) = _bucket_pad((jitters,), nbits)
        fn = _jit_read_bits(params.adaptive_alpha)
        out = fn(
            spec, med,
            jnp.asarray(plane), jnp.asarray(y), jnp.asarray(x),
            jnp.asarray(jitters, jnp.float32), jnp.float32(alpha),
        )
        return np.asarray(out[:nbits]).astype(np.uint8)

    def read_values(self, spec, med, idx, jitters, alpha, params):
        """Per-bin decision values (ops.phase.read_values) — the
        soft-decision recovery fallback's input."""
        nbits = len(jitters)
        plane, y, x = _bucket_pad(idx, len(idx[0]))
        (jitters,) = _bucket_pad((jitters,), nbits)
        fn = _jit_read_values(params.adaptive_alpha)
        out = fn(
            spec, med,
            jnp.asarray(plane), jnp.asarray(y), jnp.asarray(x),
            jnp.asarray(jitters, jnp.float32), jnp.float32(alpha),
        )
        return np.asarray(out[:nbits], dtype=np.float64)


# ---------------------------------------------------------------------------
# numpy (f64) backend — reference-exact arithmetic, CPU-only arbiter
# ---------------------------------------------------------------------------


class NumpyBackend:
    name = "numpy"

    def analyze(self, planes_f64: np.ndarray, params, lazy: bool = False):
        # `lazy` is a JaxBackend pull optimization; everything is already
        # host-resident here, so it is accepted and ignored.
        H, W = planes_f64.shape[-2:]
        PH, PW = spectral.fft_dims(H, W)
        p = planes_f64
        if params.center:
            yy, xx = np.arange(H)[:, None], np.arange(W)[None, :]
            p = p * np.where((yy + xx) % 2 == 1, -1.0, 1.0)
        padded = np.zeros((3, PH, PW), dtype=np.float64)
        padded[:, :H, :W] = p
        # conj: reference forward-FFT sign convention (see spectral.fft2)
        spec = np.conj(np.fft.fft2(padded))
        mags = np.abs(spec).reshape(3, -1)
        n = mags.shape[-1]
        med = np.partition(mags, n // 2, axis=-1)[:, n // 2]
        thr = params.magmin * med
        cap = self._capacity(spec, thr, params.rmin, params.rmax)
        region = min(8, min(PH, PW) // 8)
        feat = np.clip(
            np.floor(np.log1p(np.abs(spec[:, :region, :region])) / 2.0), 0, 7
        ).astype(np.uint8)
        return spec, med, cap, feat

    @staticmethod
    def _capacity(spec, thr, rmin, rmax):
        _, H, W = spec.shape
        yy, xx = np.arange(H)[:, None], np.arange(W)[None, :]
        axis = (yy == 0) | (xx == 0)
        if H % 2 == 0:
            axis |= yy == H // 2
        if W % 2 == 0:
            axis |= xx == W // 2
        r = np.hypot(yy.astype(np.float64), xx.astype(np.float64))
        ok = (~axis) & (r >= rmin * min(H, W)) & (r <= rmax * min(H, W))
        magok = np.abs(spec) >= thr[:, None, None]
        return int(((ok[None] & magok).sum(axis=(1, 2)) // 2).sum())

    def embed_apply(self, spec, med, idx, bits, jitters, alpha, params, H, W,
                    qim_dithers=None, hdr_bits=0, return_targets=False):
        """f64 oracle embed. return_targets=True additionally returns the
        complex TARGET values written at the walk bins (pre conjugate-mirror,
        pre IFFT/quantize) — the intended channel input that
        utils.channel.requantization_noise_report compares the re-FFT'd
        stego against."""
        plane, y, x = (np.asarray(a) for a in idx)
        PH, PW = spec.shape[-2:]
        spec = spec.copy()
        if getattr(params, "coherent", False):
            return self._embed_coherent(spec, plane, y, x, bits, jitters,
                                        alpha, med, params, H, W,
                                        qim_dithers, hdr_bits,
                                        return_targets)
        v = spec[plane, y, x]
        mag = np.maximum(1e-12, np.abs(v))
        a = self._alpha(alpha, mag, med[plane], params.adaptive_alpha)
        jit_arr = np.asarray(jitters)
        if params.qim:
            # f64 oracle of the split write: header slots hard/soft, payload
            # slots dithered QIM (pipeline/qim.py; ops/phase.py qim fns).
            s_sign = np.where(np.asarray(bits, bool), 1.0, -1.0)
            theta = np.where(np.asarray(bits, bool), a, -a) + jit_arr
            if params.soft_write:
                sigma = np.where(np.sin(a) < 0, -1.0, 1.0)
                phi = np.angle(v) - jit_arr
                valid = s_sign * sigma * np.sin(phi) >= np.abs(np.sin(a))
                t_sin = s_sign * sigma * np.abs(np.sin(a))
                t_cos = np.where(np.cos(phi) < 0, -1.0, 1.0) * np.abs(
                    np.cos(a))
                theta = np.arctan2(t_sin, t_cos) + jit_arr
                nv_h = np.where(valid, v, mag * np.exp(1j * theta))
            else:
                nv_h = mag * np.exp(1j * theta)
            delta = 2.0 * np.pi / params.qim
            d = np.asarray(qim_dithers, np.float64)
            half_b = np.asarray(bits, np.float64) * 0.5
            q = (np.angle(v) - d) / delta - half_b
            th_q = d + (np.round(q) + half_b) * delta
            nv = np.where(np.arange(len(v)) < hdr_bits, nv_h,
                          mag * np.exp(1j * th_q))
            out = self._finish_embed(spec, plane, y, x, v, nv, params, H, W)
            return (out, nv) if return_targets else out
        if params.soft_write:
            # f64 oracle of the minimal-energy write (ops/phase.py): keep
            # bins already decoding with margin >= a, clamp the rest to the
            # margin boundary in the correct half-plane.
            s_sign = np.where(np.asarray(bits, bool), 1.0, -1.0)
            sigma = np.where(np.sin(a) < 0, -1.0, 1.0)
            phi = np.angle(v) - jit_arr
            valid = s_sign * sigma * np.sin(phi) >= np.abs(np.sin(a))
            t_sin = s_sign * sigma * np.abs(np.sin(a))
            t_cos = np.where(np.cos(phi) < 0, -1.0, 1.0) * np.abs(np.cos(a))
            theta = np.arctan2(t_sin, t_cos) + jit_arr
            nv = np.where(valid, v, mag * np.exp(1j * theta))
        else:
            theta = np.where(np.asarray(bits, bool), a, -a) + jit_arr
            nv = mag * np.exp(1j * theta)
        out = self._finish_embed(spec, plane, y, x, v, nv, params, H, W)
        return (out, nv) if return_targets else out

    @staticmethod
    def _apply_write_floor(v, nv, params, H, W):
        """f64 oracle of the quantization write floor (Params.write_floor;
        ops.phase.write_floor_boost): magnitude-boost every MOVED bin's
        target so the spatial delta survives u8 rounding. nv == v bins
        (soft-write valid) stay untouched; b == 1 whenever the write is
        already above the floor."""
        floor = params.write_floor
        if not floor:
            return nv
        wm = nv != v
        A = float(np.sum(np.abs(nv[wm]) ** 2))
        C = float(np.sum((nv[wm] * np.conj(v[wm])).real))
        V = float(np.sum(np.abs(v[wm]) ** 2))
        e_star = 1.5 * (floor * H * W) ** 2
        disc = max(C * C - A * (V - e_star), 0.0)
        b = np.clip((C + np.sqrt(disc)) / max(A, 1e-20), 1.0, 32.0)
        return np.where(wm, b * nv, nv)

    @staticmethod
    def _ifft_quantize(spec, params, H, W):
        """Embed tail: inverse FFT, center, round-half-away-from-zero
        quantize (reference from_planes_u8, :387-392)."""
        planes2 = np.fft.ifft2(np.conj(spec)).real[:, :H, :W]
        if params.center:
            yy2, xx2 = np.arange(H)[:, None], np.arange(W)[None, :]
            planes2 = planes2 * np.where((yy2 + xx2) % 2 == 1, -1.0, 1.0)
        q = np.clip(np.floor(planes2 + 0.5), 0, 255).astype(np.uint8)
        return np.ascontiguousarray(q.transpose(1, 2, 0))

    @staticmethod
    def _finish_embed(spec, plane, y, x, v, nv, params, H, W):
        """Common embed tail: write-floor boost, gain pre-compensation,
        conjugate-mirror scatter, inverse FFT, center,
        round-half-away-from-zero quantize."""
        PH, PW = spec.shape[-2:]
        nv = NumpyBackend._apply_write_floor(v, nv, params, H, W)
        gain = (H * W) / (PH * PW)  # crop retention; see phase_ops.embed_phases
        if gain != 1.0:
            nv = v + (nv - v) / gain
        cys, cxs = zip(*(conj_idx(int(yy), int(xxx), PH, PW) for yy, xxx in zip(y, x)))
        spec[plane, y, x] = nv
        spec[plane, np.asarray(cys), np.asarray(cxs)] = np.conj(nv)
        return NumpyBackend._ifft_quantize(spec, params, H, W)

    @staticmethod
    def _coherent_theta(spec, y, x):
        """f64 oracle of ops.phase._coherent_common: (v3 (3, n), mag3,
        common-mode phase theta = angle(sum_c v_c/|v_c|), resultant S)."""
        v3 = spec[:, y, x]
        mag3 = np.maximum(1e-12, np.abs(v3))
        S = (v3 / mag3).sum(axis=0)
        return v3, mag3, S, np.angle(S)

    def _embed_coherent(self, spec, plane, y, x, bits, jitters, alpha, med,
                        params, H, W, qim_dithers, hdr_bits, return_targets):
        """f64 oracle of the coherent split write (_jit_embed_apply
        coherent branch; ops/phase.py embed_phases_coherent[_qim]): header
        AND payload rotate ALL THREE planes at each (y, x) site by one
        common delta — the header on the plain hard/soft target (read
        back by the two-rule header trial, pipeline/extract.py), the
        payload on the hard/soft/QIM target. Each section clears the
        write floor independently (jax twin semantics). return_targets
        yields the payload's (3, n) complex targets (pre-mirror,
        pre-IFFT)."""
        PH, PW = spec.shape[-2:]
        gain = (H * W) / (PH * PW)
        bbits = np.asarray(bits, bool)
        jit_arr = np.asarray(jitters, np.float64)
        a_all = np.broadcast_to(np.asarray(alpha, np.float64), bbits.shape)
        h = slice(0, hdr_bits)
        # --- header: coherent plain (hard/soft) common-mode write ---
        if hdr_bits:
            yh, xh = y[h], x[h]
            v3h, _m3, _Sh, th_h = self._coherent_theta(spec, yh, xh)
            a = a_all[h]
            if params.soft_write:
                s_sign = np.where(bbits[h], 1.0, -1.0)
                sigma = np.where(np.sin(a) < 0, -1.0, 1.0)
                phi = th_h - jit_arr[h]
                valid = s_sign * sigma * np.sin(phi) >= np.abs(np.sin(a))
                t_sin = s_sign * sigma * np.abs(np.sin(a))
                t_cos = np.where(np.cos(phi) < 0, -1.0, 1.0) * np.abs(
                    np.cos(a))
                tgt = np.arctan2(t_sin, t_cos) + jit_arr[h]
                dlt = np.where(valid, 0.0, tgt - th_h)
            else:
                tgt = np.where(bbits[h], a, -a) + jit_arr[h]
                dlt = tgt - th_h
            nv3h = v3h * np.exp(1j * dlt)[None, :]
            nv3h = self._apply_write_floor(
                v3h.ravel(), nv3h.ravel(), params, H, W).reshape(v3h.shape)
            if gain != 1.0:
                nv3h = v3h + (nv3h - v3h) / gain
            cys, cxs = zip(*(conj_idx(int(a_), int(b_), PH, PW)
                             for a_, b_ in zip(yh, xh)))
            spec[:, yh, xh] = nv3h
            spec[:, np.asarray(cys), np.asarray(cxs)] = np.conj(nv3h)
        # --- payload: coherent all-plane common-mode write ---
        p = slice(hdr_bits, None)
        yp, xp = y[p], x[p]
        v3, _mag3, _S, th = self._coherent_theta(spec, yp, xp)
        ap = a_all[p]
        if params.qim:
            delta_l = 2.0 * np.pi / params.qim
            d = np.asarray(qim_dithers, np.float64)[p]
            half_b = bbits[p].astype(np.float64) * 0.5
            q = (th - d) / delta_l - half_b
            tgt = d + (np.round(q) + half_b) * delta_l
            delta = tgt - th
        elif params.soft_write:
            s_p = np.where(bbits[p], 1.0, -1.0)
            sigma = np.where(np.sin(ap) < 0, -1.0, 1.0)
            phi = th - jit_arr[p]
            valid = s_p * sigma * np.sin(phi) >= np.abs(np.sin(ap))
            t_sin = s_p * sigma * np.abs(np.sin(ap))
            t_cos = np.where(np.cos(phi) < 0, -1.0, 1.0) * np.abs(
                np.cos(ap))
            tgt = np.arctan2(t_sin, t_cos) + jit_arr[p]
            delta = np.where(valid, 0.0, tgt - th)
        else:
            tgt = np.where(bbits[p], ap, -ap) + jit_arr[p]
            delta = tgt - th
        nv3 = v3 * np.exp(1j * delta)[None, :]
        nv3 = self._apply_write_floor(v3.ravel(), nv3.ravel(), params, H, W
                                      ).reshape(v3.shape)
        if gain != 1.0:
            nv3 = v3 + (nv3 - v3) / gain
        cys, cxs = zip(*(conj_idx(int(a_), int(b_), PH, PW)
                         for a_, b_ in zip(yp, xp)))
        spec[:, yp, xp] = nv3
        spec[:, np.asarray(cys), np.asarray(cxs)] = np.conj(nv3)
        out = self._ifft_quantize(spec, params, H, W)
        return (out, nv3) if return_targets else out

    @staticmethod
    def _alpha(base, mag, med, adaptive):
        base = np.broadcast_to(np.asarray(base, mag.dtype), mag.shape)
        if not adaptive:
            return base
        return base * np.clip(mag / np.maximum(1e-12, med), 0.5, 2.0)

    def read_bits(self, spec, med, idx, jitters, alpha, params):
        plane, y, x = (np.asarray(a) for a in idx)
        v = spec[plane, y, x]
        th = np.angle(v)
        mag = np.maximum(1e-12, np.abs(v))
        a = self._alpha(alpha, mag, med[plane], params.adaptive_alpha)
        base = th - np.asarray(jitters)
        return (np.cos(base - a) >= np.cos(base + a)).astype(np.uint8)

    def read_values(self, spec, med, idx, jitters, alpha, params):
        plane, y, x = (np.asarray(a) for a in idx)
        v = spec[plane, y, x]
        th = np.angle(v)
        mag = np.maximum(1e-12, np.abs(v))
        a = self._alpha(alpha, mag, med[plane], params.adaptive_alpha)
        return mag * np.sin(th - np.asarray(jitters)) * np.sign(np.sin(a))

    def read_values_qim(self, spec, idx, dithers, L):
        """f64 oracle of ops.phase.read_values_qim."""
        plane, y, x = (np.asarray(a) for a in idx)
        v = spec[plane, y, x]
        mag = np.maximum(1e-12, np.abs(v))
        return -np.cos(L * (np.angle(v) - np.asarray(dithers))) * mag

    def read_bits_qim(self, spec, idx, dithers, L):
        return (self.read_values_qim(spec, idx, dithers, L) >= 0).astype(
            np.uint8)

    def read_values_coherent(self, spec, idx_yx, jitters, alpha):
        """f64 oracle of ops.phase.read_values_coherent."""
        y, x = (np.asarray(a) for a in idx_yx)
        _v3, mag3, S, th = self._coherent_theta(spec, y, x)
        w = np.abs(S) * mag3.mean(axis=0)
        base = th - np.asarray(jitters)
        return w * np.sin(base) * np.sign(np.sin(alpha))

    def read_bits_coherent(self, spec, idx_yx, jitters, alpha):
        return (self.read_values_coherent(spec, idx_yx, jitters, alpha)
                >= 0).astype(np.uint8)

    def read_values_coherent_qim(self, spec, idx_yx, dithers, L):
        """f64 oracle of ops.phase.read_values_coherent_qim."""
        y, x = (np.asarray(a) for a in idx_yx)
        _v3, mag3, S, th = self._coherent_theta(spec, y, x)
        w = np.abs(S) * mag3.mean(axis=0)
        return -np.cos(L * (th - np.asarray(dithers))) * w

    def read_bits_coherent_qim(self, spec, idx_yx, dithers, L):
        return (self.read_values_coherent_qim(spec, idx_yx, dithers, L)
                >= 0).astype(np.uint8)


def get_backend(params) -> JaxBackend | NumpyBackend:
    if params.fft_dtype == "complex128":
        return NumpyBackend()
    return JaxBackend()
