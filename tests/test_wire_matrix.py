"""Wire-mode composition matrix: the FULL valid flag lattice in one sweep.

Every rebuild-only wire/write mode must compose with every other — a new
mode that silently breaks a composition has to fail here, not in the field.
Axes (2 values each, 128 combos total — all valid; the only invalid
compositions in the Params surface involve adaptive_alpha /
cover_dependent_path, which are deliberately outside this lattice per
pipeline/qim.py validate()):

  wire-format axes (change the embedded stream / walk):
    per_image_walk  — salt-keyed payload walks   (header FLAG 0x01)
    rs              — RS(255,223) payload FEC    (header FLAG 0x02)
    pad_quantum     — length-hiding padding      (header FLAG 0x04)
    qim             — dithered phase QIM payload (header FLAGS bits 4-7)
  embed-side-only axes (wire format unchanged, bytes differ):
    alpha_spread    — one-sided randomized write amplitude
    soft_write      — minimal-energy header/payload write
    write_floor     — quantization-floor magnitude boost

All 128 stegos are extracted in ONE extract_batch call over the 8-device
mesh: extraction is self-describing per image (header flags), so a single
mixed-mode batch is the strongest composition check — grouping, dispatch
and decode must all be right for every mode pair simultaneously.
"""

import itertools

import numpy as np
import pytest

from steganosaurus_jax.config import Params
from steganosaurus_jax.parallel import batch as pbatch
from steganosaurus_jax.pipeline.batch import embed_batch, extract_batch

AXES = {
    "per_image_walk": (False, True),
    "rs": (False, True),
    "qim": (0, 3),
    "pad_quantum": (0, 24),
    "alpha_spread": (0.0, 0.5),
    "soft_write": (False, True),
    "write_floor": (0.0, 0.45),
}

COMBOS = [dict(zip(AXES, vals))
          for vals in itertools.product(*AXES.values())]


@pytest.mark.slow
def test_full_wire_mode_lattice_roundtrip():
    rng = np.random.default_rng(23)
    cover = rng.integers(0, 256, (1, 128, 128, 3)).astype(np.uint8)

    stegos, secrets = [], []
    for i, combo in enumerate(COMBOS):
        p = Params(pbkdf2_iter=100, **combo)
        secret = f"c{i:03d}".encode()  # short: worst-case combo (pad=24,
        # rep7) must fit a 128^2 cover's walk capacity
        res = embed_batch(cover, [secret], password="pw", params=p)
        stegos.append(np.asarray(res.stego)[0])
        secrets.append(secret)

    mesh = pbatch.make_mesh(8)
    got = extract_batch(np.stack(stegos), password="pw",
                        params=Params(pbkdf2_iter=100), mesh=mesh)
    bad = [i for i, (g, s) in enumerate(zip(got, secrets)) if g != s]
    assert not bad, (
        f"{len(bad)}/{len(COMBOS)} combos failed round-trip; first "
        f"failures: {[COMBOS[i] for i in bad[:4]]}")
