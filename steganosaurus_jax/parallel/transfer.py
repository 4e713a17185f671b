"""Device->host transfer packing for uint8 payloads.

Graphs that return image bytes to the host end with a bitcast of groups of
4 bytes into float32 words (bit pattern preserved exactly — verified
byte-for-byte), viewed back as uint8 on the host. The packing was a
workaround for a slow u8 device->host path on the accelerator this system
was first built for; whether it pays on the GPU is not measured (ROADMAP
design item 1). Pure plumbing: no arithmetic touches the packed values, so
this is lossless by construction.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def pack_u8(out_u8):
    """(B, ...) u8 device array -> (B, ceil(prod/4)) f32 words (in-graph).

    Trailing bytes are zero-padded to a multiple of 4; `unpack_u8` slices
    them off using the logical shape.
    """
    B = out_u8.shape[0]
    flat = out_u8.reshape(B, -1)
    pad = (-flat.shape[1]) % 4
    if pad:
        flat = jnp.pad(flat, ((0, 0), (0, pad)))
    return jax.lax.bitcast_convert_type(
        flat.reshape(B, -1, 4), jnp.float32
    )


def unpack_u8(host_f32: np.ndarray, shape: tuple[int, ...]) -> np.ndarray:
    """Host-side inverse of pack_u8: (B, m) f32 words -> `shape` u8 array."""
    B = shape[0]
    n = int(np.prod(shape[1:]))
    flat = np.ascontiguousarray(host_f32).view(np.uint8).reshape(B, -1)
    return flat[:, :n].reshape(shape)
