"""Distributed 2D FFT + sharded phase ops for grids too large for one chip.

SURVEY.md §5 flags 4K UHD as the CP-like hard part: 3 planes of 4096x4096
complex64 (~400 MB) per direction. This module shards ONE image's spectrum
across the mesh:

  rows-sharded planes (3, PH/n, PW)
    -> local row FFT (W complete on-shard)
    -> all_to_all shard transpose (NCCL over NVLink on GPUs)
    -> local column FFT (H complete on-shard)
  = spectrum sharded along W (3, PH, PW/n)

The phase scatter/gather then runs *in the W-sharded layout*: bin indices are
replicated, each shard applies only the writes landing in its W slab, and bin
values are recovered shard-locally then `psum`-combined (each bin lives on
exactly one shard, so the sum IS the value). The global magnitude median uses
the same bit-pattern bisection as ops.stats with a `psum` inside the counting
loop. No full spectrum is ever materialized on a single device.

Reference sign convention (conjugated forward transform) is preserved — see
spectral.fft2. All functions here are shard_map bodies composed under one jit.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from steganosaurus_jax.ops import phase as phase_ops


# ---------------------------------------------------------------------------
# distributed transforms (shard_map bodies)
# ---------------------------------------------------------------------------


def _fft2_body(x, *, axis_name: str, n: int):
    """(3, PH/n, PW) real/complex rows-shard -> (3, PH, PW/n) W-shard spectrum."""
    xr = jnp.fft.fft(x.astype(jnp.complex64), axis=-1)          # row pass
    s = xr.shape
    xr = xr.reshape(s[0], s[1], n, s[2] // n)                   # split W
    # piece j -> device j, received pieces stack along H in device order
    xt = jax.lax.all_to_all(xr, axis_name, split_axis=2, concat_axis=1,
                            tiled=False)
    # xt: (3, n, PH/n, PW/n) -> (3, PH, PW/n)
    xt = xt.reshape(s[0], n * s[1], s[2] // n)
    xc = jnp.fft.fft(xt, axis=-2)                               # column pass
    return jnp.conj(xc)                                         # ref convention


def _ifft2_real_body(F, *, axis_name: str, n: int):
    """(3, PH, PW/n) W-shard spectrum -> (3, PH/n, PW) rows-shard real planes."""
    x = jnp.fft.ifft(jnp.conj(F), axis=-2)                      # column pass
    s = x.shape                                                  # (3, PH, PW/n)
    x = x.reshape(s[0], n, s[1] // n, s[2])                     # split H
    xt = jax.lax.all_to_all(x, axis_name, split_axis=1, concat_axis=2,
                            tiled=False)
    # split_axis is consumed; a new size-n source-device axis appears at
    # concat_axis=2 -> (3, PH/n, n, PW/n), W pieces already in device order
    xt = xt.reshape(s[0], s[1] // n, n * s[2])
    return jnp.fft.ifft(xt, axis=-1).real                       # row pass


def _median_abs_body(F, *, axis_name: str):
    """Global upper median of |F| per plane over the W-sharded spectrum.

    Bit-pattern bisection (see ops.stats): for non-negative f32, the uint32
    pattern is order-isomorphic to the value, so 31 global masked counts
    (local count + psum) recover the exact order statistic without a sort.
    """
    mags = jnp.abs(F).reshape(F.shape[0], -1)
    u = jax.lax.bitcast_convert_type(mags, jnp.int32)
    n_local = mags.shape[-1]
    n_total = n_local * jax.lax.psum(1, axis_name)
    k = n_total // 2

    def body(i, r):
        bit = 31 - i
        cand = r | (jnp.int32(1) << bit)
        cnt = jax.lax.psum((u < cand[:, None]).sum(axis=-1), axis_name)
        return jnp.where(cnt <= k, cand, r)

    r = jax.lax.fori_loop(1, 32, body, jnp.zeros(F.shape[0], jnp.int32))
    return jax.lax.bitcast_convert_type(r, jnp.float32)


def _gather_bins_body(F, plane, y, x, *, axis_name: str, n: int):
    """Replicated gather of spectrum values at (plane, y, x) bins.

    Each bin lives on exactly one W shard; everyone reads its local candidate
    (clamped index, masked to zero off-shard) and a psum reconstructs the
    value on every shard.
    """
    Wn = F.shape[-1]
    my = jax.lax.axis_index(axis_name)
    x0 = my * Wn
    own = (x >= x0) & (x < x0 + Wn)
    xl = jnp.clip(x - x0, 0, Wn - 1)
    v = jnp.where(own, F[plane, y, xl], 0)
    return jax.lax.psum(v, axis_name)


def _scatter_bins_body(F, plane, y, x, nv, *, axis_name: str):
    """Masked scatter of new bin values + Hermitian mirrors into the W shard.

    The turtle guarantees a bin and its mirror are distinct and written once
    (phase_ops.embed_phases docstring), so shard-local scatter-set is
    conflict-free; off-shard writes are mapped to an out-of-bounds local
    column and dropped (mode="drop") — masking via index-clipping would alias
    an off-shard write onto a real local bin.
    """
    PH = F.shape[-2]
    PW = F.shape[-1] * jax.lax.psum(1, axis_name)
    Wn = F.shape[-1]
    my = jax.lax.axis_index(axis_name)
    x0 = my * Wn

    cy, cx = phase_ops.conj_indices(y, x, PH, PW)
    out = F
    for (yy, xx, vv) in ((y, x, nv), (cy, cx, jnp.conj(nv))):
        own = (xx >= x0) & (xx < x0 + Wn)
        xl = jnp.where(own, xx - x0, Wn)  # Wn is out of bounds -> dropped
        out = out.at[plane, yy, xl].set(vv, mode="drop")
    return out


# ---------------------------------------------------------------------------
# public API — composed shard_map calls (use under one jit)
# ---------------------------------------------------------------------------


def _smap(mesh, body, in_specs, out_specs):
    return shard_map(body, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
                     check_vma=False)


def fft2_distributed(planes, mesh: Mesh, axis: str = "image"):
    """(3, PH, PW) planes (rows sharded over `axis`) -> W-sharded spectrum."""
    n = mesh.shape[axis]
    body = functools.partial(_fft2_body, axis_name=axis, n=n)
    return _smap(mesh, body, P(None, axis, None), P(None, None, axis))(planes)


def ifft2_real_distributed(spectrum, mesh: Mesh, axis: str = "image"):
    """W-sharded spectrum -> (3, PH, PW) real planes, rows sharded."""
    n = mesh.shape[axis]
    body = functools.partial(_ifft2_real_body, axis_name=axis, n=n)
    return _smap(mesh, body, P(None, None, axis), P(None, axis, None))(spectrum)


def median_abs_distributed(spectrum, mesh: Mesh, axis: str = "image"):
    body = functools.partial(_median_abs_body, axis_name=axis)
    return _smap(mesh, body, P(None, None, axis), P(None))(spectrum)


def gather_bins_distributed(spectrum, plane, y, x, mesh: Mesh,
                            axis: str = "image"):
    n = mesh.shape[axis]
    body = functools.partial(_gather_bins_body, axis_name=axis, n=n)
    rep = P(None)
    return _smap(mesh, body, (P(None, None, axis), rep, rep, rep), rep)(
        spectrum, plane, y, x)


def scatter_bins_distributed(spectrum, plane, y, x, nv, mesh: Mesh,
                             axis: str = "image"):
    body = functools.partial(_scatter_bins_body, axis_name=axis)
    rep = P(None)
    return _smap(mesh, body, (P(None, None, axis), rep, rep, rep, rep),
                 P(None, None, axis))(spectrum, plane, y, x, nv)


def embed_core_distributed(planes, plane, y, x, bits, jitters, alpha,
                           mesh: Mesh, *, adaptive: bool = False,
                           axis: str = "image", floor: float = 0.0,
                           img_pixels: float = 0.0):
    """Full single-image embed device core, spectrum sharded across `axis`.

    planes: (3, PH, PW) f32, pow2-padded, rows sharded. Returns rows-sharded
    real (3, PH, PW) planes (crop + quantize happen outside, where the caller
    knows the true H, W). floor/img_pixels: quantization write floor
    (Params.write_floor; ops.phase.write_floor_boost) — the gathered bin
    values are replicated after the psum, so the boost is computed
    identically on every shard, no extra collective.
    """
    spec = fft2_distributed(planes, mesh, axis)
    med = median_abs_distributed(spec, mesh, axis)
    v = gather_bins_distributed(spec, plane, y, x, mesh, axis)
    mag = jnp.maximum(1e-12, jnp.abs(v))
    a = phase_ops.adaptive_alpha(alpha, mag, med[plane], adaptive)
    theta = jnp.where(bits.astype(bool), a, -a) + jitters
    nv = (mag * jnp.exp(1j * theta)).astype(spec.dtype)
    if floor:
        b = phase_ops.write_floor_boost(
            v, nv, jnp.ones(v.shape, bool), img_pixels, floor)
        nv = (b * nv.real + 1j * b * nv.imag).astype(spec.dtype)
    spec2 = scatter_bins_distributed(spec, plane, y, x, nv, mesh, axis)
    return ifft2_real_distributed(spec2, mesh, axis)


def read_core_distributed(planes, plane, y, x, jitters, alpha, mesh: Mesh,
                          *, adaptive: bool = False, axis: str = "image"):
    """Single-image extract device core over a sharded spectrum -> raw bits."""
    spec = fft2_distributed(planes, mesh, axis)
    med = median_abs_distributed(spec, mesh, axis)
    v = gather_bins_distributed(spec, plane, y, x, mesh, axis)
    th = jnp.angle(v)
    mag = jnp.maximum(1e-12, jnp.abs(v))
    a = phase_ops.adaptive_alpha(alpha, mag, med[plane], adaptive)
    base = th - jitters
    return (jnp.cos(base - a) >= jnp.cos(base + a)).astype(jnp.uint8)
