#!/usr/bin/env python3
"""Generate the 256x256 gradient+noise test cover `host.png`.

Equivalent of the reference tools/gen_png.cpp:5-21 (RGB gradient base 180..220
plus +/-10 noise); seeded for reproducibility (the reference uses unseeded
rand(), reproducible only per libc).
"""

import sys

import numpy as np


def gen_host(seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = np.arange(256)
    y = np.arange(256)
    # base gradient per channel, like the reference's (180 + 40*x/W etc.)
    r = 180 + 40.0 * x[None, :] / 256
    g = 180 + 40.0 * y[:, None] / 256 + 0 * x[None, :]
    b = 200 + 20.0 * (x[None, :] + y[:, None]) / 512
    img = np.stack([np.broadcast_to(r, (256, 256)),
                    np.broadcast_to(g, (256, 256)),
                    np.broadcast_to(b, (256, 256))], axis=-1)
    img = img + rng.integers(-10, 11, (256, 256, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


if __name__ == "__main__":
    sys.path.insert(0, __file__.rsplit("/", 2)[0])
    from steganosaurus_jax.io import image as image_io

    out = sys.argv[1] if len(sys.argv) > 1 else "host.png"
    image_io.save_png(out, gen_host())
    print(f"Wrote {out}")
