"""Order statistics without sorting.

`jnp.sort`/`jnp.partition` over a 4K spectrum (16.7M magnitudes/plane) are
expensive on accelerators and compile slowly. The median the
pipeline needs (reference median_abs, steganosaur.cpp:404-409) is an *exact*
k-th order statistic, which we compute by binary search on the IEEE-754 bit
pattern: for non-negative floats, the uint32 bit pattern is order-isomorphic
to the float value, so 32 masked count-reductions recover the exact element.
Runtime is 32 memory-bound passes (vs a full sort); compile is a fori_loop.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def kth_smallest_nonneg(vals, k: int):
    """Exact k-th smallest (0-indexed) per row of non-negative floats.

    vals: (..., N) float32/float64, all >= 0. Returns (...,) of same dtype.
    """
    dtype = vals.dtype
    bits = 64 if dtype == jnp.float64 else 32
    idt = jnp.int64 if bits == 64 else jnp.int32
    u = jax.lax.bitcast_convert_type(vals, idt)

    def body(i, r):
        bit = (bits - 1) - i
        cand = r | (jnp.asarray(1, idt) << bit)
        # count of elements strictly below the candidate, per row
        cnt = (u < cand[..., None]).sum(axis=-1)
        return jnp.where(cnt <= k, cand, r)

    # Skip the sign bit (inputs are non-negative, so it is always 0).
    r0 = jnp.zeros(vals.shape[:-1], idt)
    r = jax.lax.fori_loop(1, bits, body, r0)
    return jax.lax.bitcast_convert_type(r, dtype)


def median_upper(vals):
    """Upper median: the element at sorted index N//2 (reference takes
    nth_element at n/2 — the upper median for even n)."""
    n = vals.shape[-1]
    return kth_smallest_nonneg(vals, n // 2)
