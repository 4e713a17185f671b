"""Measurement driver for the channel-coherent write (doc/ATTACKS.md §2e).

Runs the three corpus wardens (cross-channel, SRM-lite spatial residual,
phase-magnitude joint residual) over capacity-equalized configs — the
coherent mode consumes a whole 3-plane site per payload bit, so its
capacity ceiling at 256^2 is ~1/3 of the standard walk's; every config
below embeds the SAME 64-byte secrets so the comparison is at equal
payload, not equal footprint fraction.

Usage: python tools/coherent_study.py [out.json]
Heavy (~10-25 min: 4 configs x 3 wardens x 3 families x 64 images).
"""

import json
import sys
import time

from steganosaurus_jax.config import Params
from steganosaurus_jax.utils import steganalysis as sa

SECRET_BYTES = 56  # capacity-equalized: coherent charges every site 3x
                   # (header AND payload ride the common-mode write), so
                   # it needs 3*(912 + 72*8*7) = 14832 bits of the 256^2
                   # walk's ~15286

CONFIGS = {
    "hard": Params(),
    "stealth": Params.stealth(),
    "coherent": Params(coherent=True),
    "coherent_stealth": Params.stealth(coherent=True),
}

STUDIES = {
    "cross_channel": sa.cross_channel_study,
    "srm": sa.srm_study,
    "joint_residual": sa.joint_residual_study,
}


def main(out_path: str = "/tmp/coherent_study.json") -> None:
    out = {"secret_bytes": SECRET_BYTES, "hw": [256, 256], "n": 32,
           "results": {}}
    for cname, params in CONFIGS.items():
        out["results"][cname] = {}
        for sname, study in STUDIES.items():
            t0 = time.time()
            rep = study(params, secret_bytes=SECRET_BYTES, n=32,
                        hw=(256, 256), seed=7)
            row = {fam: {"auc": r["auc"], "accuracy": r["accuracy"]}
                   for fam, r in rep["families"].items()}
            row["max_auc"] = rep["max_auc"]
            row["wall_s"] = round(time.time() - t0, 1)
            out["results"][cname][sname] = row
            print(f"{cname:18s} {sname:15s} "
                  + " ".join(f"{f}={v['auc']:.3f}" for f, v in row.items()
                             if isinstance(v, dict))
                  + f"  ({row['wall_s']}s)", flush=True)
    with open(out_path, "w") as f:
        json.dump(out, f, indent=1)
    print("wrote", out_path)


if __name__ == "__main__":
    main(*sys.argv[1:])
