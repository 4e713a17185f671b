"""Unit tests for ECC, bit packing, masks, order statistics, phase ops."""

import numpy as np
import pytest

from steganosaurus_jax.ops import bits as bit_ops
from steganosaurus_jax.ops import ecc, mask, phase, stats


# ---------------------------------------------------------------------- ECC
@pytest.mark.parametrize("n,dec", [(3, ecc.rep3_decode), (5, ecc.rep5_decode), (7, ecc.rep7_decode)])
def test_rep_roundtrip_and_majority(n, dec):
    rng = np.random.default_rng(0)
    data = rng.integers(0, 2, 101).astype(np.uint8)
    enc = np.asarray(ecc.rep_encode(data, n))
    assert len(enc) == len(data) * n
    np.testing.assert_array_equal(np.asarray(dec(enc)), data)
    # flip floor((n-1)/2) bits inside one group: still decodes
    enc2 = enc.copy()
    enc2[: (n - 1) // 2] ^= 1
    np.testing.assert_array_equal(np.asarray(dec(enc2)), data)
    # majority threshold matches the reference (>= ceil((n+1)/2) ones)
    group = np.zeros(n, np.uint8)
    group[: (n + 1) // 2] = 1
    assert np.asarray(dec(group))[0] == 1
    group[(n + 1) // 2 - 1] = 0
    assert np.asarray(dec(group))[0] == 0


def test_rep_trailing_partial_dropped():
    # the reference iterates i+n<=size, dropping the trailing partial group
    out = np.asarray(ecc.rep_decode(np.array([1, 1, 1, 1], np.uint8), 3))
    assert out.tolist() == [1]


def test_ham74_single_error_correction():
    rng = np.random.default_rng(1)
    data = rng.integers(0, 2, 64).astype(np.uint8)
    enc = np.asarray(ecc.ham74_encode(data))
    assert len(enc) == len(data) // 4 * 7
    np.testing.assert_array_equal(np.asarray(ecc.ham74_decode(enc, 64)), data)
    for pos in range(7):  # any single flipped bit per codeword corrects
        enc2 = enc.copy()
        enc2[pos] ^= 1
        np.testing.assert_array_equal(np.asarray(ecc.ham74_decode(enc2, 64)), data)


# --------------------------------------------------------------------- bits
def test_bits_msb_first_roundtrip():
    data = bytes([0b10110001, 0xFF, 0x00, 0x42])
    bits = bit_ops.bits_from_bytes(data)
    assert bits[:8].tolist() == [1, 0, 1, 1, 0, 0, 0, 1]
    assert bit_ops.bytes_from_bits(bits) == data
    # partial trailing byte zero-padded (reference :450)
    assert bit_ops.bytes_from_bits(np.array([1, 1], np.uint8)) == b"\xc0"
    # device packer agrees
    np.testing.assert_array_equal(
        np.asarray(bit_ops.jnp_bytes_from_bits(bits)), np.frombuffer(data, np.uint8)
    )


# -------------------------------------------------------------------- stats
@pytest.mark.parametrize("n", [16, 100, 1 << 12])
def test_kth_smallest_matches_sort(n):
    rng = np.random.default_rng(3)
    vals = (rng.random((3, n)) * rng.integers(1, 10**6)).astype(np.float32)
    for k in [0, 1, n // 2, n - 1]:
        got = np.asarray(stats.kth_smallest_nonneg(vals, k))
        want = np.sort(vals, axis=-1)[:, k]
        np.testing.assert_array_equal(got, want)


def test_median_with_duplicates_and_zeros():
    vals = np.array([[0.0, 0.0, 2.0, 2.0, 5.0, 5.0, 5.0, 1.0]], np.float32)
    got = float(np.asarray(stats.median_upper(vals))[0])
    assert got == float(np.sort(vals[0])[4])


# --------------------------------------------------------------------- mask
def test_capacity_matches_reference_scan():
    """Device capacity reduction == scalar reference algorithm (:997-1008)."""
    rng = np.random.default_rng(5)
    H = W = 64
    spec = (rng.normal(size=(3, H, W)) + 1j * rng.normal(size=(3, H, W))) * 50
    thr = np.array([40.0, 50.0, 60.0])
    rmin, rmax = 0.05, 0.45

    def scalar_count(F, t):
        c = 0
        for y in range(H):
            for x in range(W):
                if y == 0 or x == 0 or y == H // 2 or x == W // 2:
                    continue
                r = np.hypot(y, x)
                if r < rmin * min(H, W) or r > rmax * min(H, W):
                    continue
                if abs(F[y, x]) < t:
                    continue
                c += 1
        return c // 2

    want = sum(scalar_count(spec[i], thr[i]) for i in range(3))
    import jax.numpy as jnp

    got = int(mask.capacity_bits(jnp.asarray(spec, jnp.complex64), jnp.asarray(thr, jnp.float32), rmin, rmax))
    assert got == want


# -------------------------------------------------------------------- phase
def test_phase_write_read_roundtrip():
    import jax.numpy as jnp

    rng = np.random.default_rng(9)
    H = W = 32
    spec = (rng.normal(size=(3, H, W)) + 1j * rng.normal(size=(3, H, W))).astype(np.complex64) * 100
    n = 40
    plane = rng.integers(0, 3, n).astype(np.int32)
    y = rng.integers(1, H // 2 - 1, n).astype(np.int32)
    x = rng.integers(1, W // 2 - 1, n).astype(np.int32)
    # dedupe (the walk guarantees uniqueness; synthetic indices must too)
    _, keep = np.unique(plane * H * W + y * W + x, return_index=True)
    plane, y, x = plane[keep], y[keep], x[keep]
    n = len(plane)
    bits = rng.integers(0, 2, n).astype(np.uint8)
    jit = (rng.random(n).astype(np.float32) - 0.5) * 0.1
    med = jnp.asarray(np.full(3, 50.0, np.float32))

    out = phase.embed_phases(jnp.asarray(spec), plane, y, x, jnp.asarray(bits), jnp.asarray(jit), 0.5, med, False)
    got = np.asarray(phase.read_phases(out, plane, y, x, jnp.asarray(jit), 0.5, med, False))
    np.testing.assert_array_equal(got, bits)

    # hermitian mirror written
    out_np = np.asarray(out)
    for pi, yi, xi in zip(plane, y, x):
        assert np.isclose(out_np[pi, (H - yi) % H, (W - xi) % W], np.conj(out_np[pi, yi, xi]))

    # magnitudes preserved
    mags_before = np.abs(spec[plane, y, x])
    mags_after = np.abs(out_np[plane, y, x])
    np.testing.assert_allclose(mags_after, mags_before, rtol=1e-5)


def test_adaptive_alpha_clamps():
    import jax.numpy as jnp

    mag = jnp.asarray(np.array([1.0, 50.0, 1000.0], np.float32))
    a = np.asarray(phase.adaptive_alpha(0.5, mag, jnp.float32(50.0), True))
    np.testing.assert_allclose(a, [0.25, 0.5, 1.0], rtol=1e-6)
    a2 = np.asarray(phase.adaptive_alpha(0.5, mag, jnp.float32(50.0), False))
    np.testing.assert_allclose(a2, [0.5, 0.5, 0.5])
