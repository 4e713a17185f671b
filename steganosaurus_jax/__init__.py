"""steganosaurus_jax — a JAX rebuild of TurtleFFT (rickenator/steganosaurus).

A JAX/XLA framework that hides a ChaCha20-Poly1305-encrypted,
repetition-ECC-protected secret in the phase of the 2D FFT of an RGB image,
selecting frequency bins via a keyed pseudo-random "turtle walk".

Architecture (accelerator-first, not a translation of the C++ reference):

- ``crypto/``    host-side crypto (SHA-256/HMAC/PBKDF2/HKDF via OpenSSL-backed
                 stdlib, clean-room ChaCha20-Poly1305, key wrap formats).
                 Native C++ backend in ``native/`` when built.
- ``keystream/`` the sequential keyed turtle walk, refactored into *host-side
                 keystream expansion* (C++ fast path): emits int32 bin-index
                 arrays + jitter arrays so the device side is fully vectorized.
- ``spectral/``  JAX 2D FFT over padded R/G/B planes (complex64 on the
                 device, complex128 arbiter on CPU), the pruned corner DFT,
                 plane conversion, medians.
- ``ops/``       vectorized device ops: gather -> phase-rotate -> scatter with
                 conjugate mirroring, ECC encode/majority-decode as reductions,
                 bit/byte packing, annulus capacity masks.
- ``pipeline/``  embed / extract / gen-key orchestration, header framing,
                 batched + pjit-sharded variants.
- ``cli``        flag- and output-compatible `turtlefft` / `turtlefft-key`.

Reference behavior is documented per-function with `file:line` citations into
the reference tree (steganosaurus/src/steganosaur.cpp et al.).
"""

from steganosaurus_jax.config import Params

# 0.3: adaptive column-split precision default; 0.4: stealth modes;
# 0.5: dithered phase QIM (Params.qim — uniform written-bin phases,
# ~9-36x less write energy; header FLAGS bits 4-7, auto-detected)
# (alpha_spread, per_image_walk) + warden-view steganalysis reporting;
# 0.6: inline soft decode in the fused extract pass, payload padding
# (Params.pad_quantum, header FLAG 0x04), `check` CLI mode, collusion +
# AWGN/JPEG robustness reports; 0.7: native RS codec, key vault, walk
# disk cache, SRM-lite warden, MFU/roofline bench, serve worker,
# write floor; 0.8: fast PNG codec, serve warm-path routing (--warmup,
# learned clen hints, B=1 batch modules), cross-channel warden; 0.9:
# channel-coherent wire mode (common-mode write, two-rule header trial,
# requantization refinement), raw-tensor serve ingest.
__version__ = "0.9.0"

# Lazy top-level convenience API (PEP 562): `import steganosaurus_jax as st;
# st.embed_batch(...)`. Resolved on first touch so importing the package
# stays cheap (no jax / device init until a pipeline symbol is used).
_API = {
    "embed": ("steganosaurus_jax.pipeline.embed", "embed"),
    "embed_array": ("steganosaurus_jax.pipeline.embed", "embed_array"),
    "extract": ("steganosaurus_jax.pipeline.extract", "extract"),
    "extract_array": ("steganosaurus_jax.pipeline.extract", "extract_array"),
    "embed_batch": ("steganosaurus_jax.pipeline.batch", "embed_batch"),
    "extract_batch": ("steganosaurus_jax.pipeline.batch", "extract_batch"),
    "extract_dispatch": ("steganosaurus_jax.pipeline.batch",
                         "extract_dispatch"),
    "channel_report": ("steganosaurus_jax.pipeline.batch", "channel_report"),
    "phase_histogram_report": ("steganosaurus_jax.utils.steganalysis",
                               "phase_histogram_report"),
    "pairwise_difference_report": ("steganosaurus_jax.utils.steganalysis",
                                   "pairwise_difference_report"),
    "magnitude_conditioned_report": ("steganosaurus_jax.utils.steganalysis",
                                     "magnitude_conditioned_report"),
    "requantization_noise_report": ("steganosaurus_jax.utils.channel",
                                    "requantization_noise_report"),
    "collusion_report": ("steganosaurus_jax.utils.steganalysis",
                         "collusion_report"),
    "srm_report": ("steganosaurus_jax.utils.steganalysis", "srm_report"),
    "srm_study": ("steganosaurus_jax.utils.steganalysis", "srm_study"),
    "cross_channel_report": ("steganosaurus_jax.utils.steganalysis",
                             "cross_channel_report"),
    "cross_channel_study": ("steganosaurus_jax.utils.steganalysis",
                            "cross_channel_study"),
    "joint_residual_report": ("steganosaurus_jax.utils.steganalysis",
                              "joint_residual_report"),
    "joint_residual_study": ("steganosaurus_jax.utils.steganalysis",
                             "joint_residual_study"),
    "robustness_report": ("steganosaurus_jax.utils.channel",
                          "robustness_report"),
    "embed_stream": ("steganosaurus_jax.pipeline.stream", "embed_stream"),
    "extract_stream": ("steganosaurus_jax.pipeline.stream", "extract_stream"),
    "load_rgb_batches": ("steganosaurus_jax.pipeline.stream",
                         "load_rgb_batches"),
    "StegoError": ("steganosaurus_jax.pipeline.errors", "StegoError"),
}


def __getattr__(name: str):
    try:
        mod, attr = _API[name]
    except KeyError:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}") from None
    import importlib

    val = getattr(importlib.import_module(mod), attr)
    globals()[name] = val  # cache for subsequent lookups
    return val


__all__ = ["Params", "__version__", *_API]
