"""Parallelism layer: device meshes, sharded batch pipelines, distributed FFT.

The reference is a single-threaded CPU binary (SURVEY.md §2.3 — no threads, no
SIMD, no GPU). The accelerator scaling axes are therefore ours to design:

- batch parallelism (DP analog): images sharded over a 1D/2D `jax.sharding.Mesh`
  via NamedSharding; the steady state needs no cross-device collectives.
- intra-image parallelism (SP/TP analog): a shard_map distributed 2D FFT that
  splits an image's rows across devices and transposes via all_to_all (NCCL
  over NVLink on GPUs; `fft_dist`), for grids too large for one device.
- host/device pipelining (PP analog): `pipeline.stream` keeps several batches
  in flight — batch N+1's threaded PNG decode, C++ AEAD/KDF, and frame
  packing run on the host while batch N's embed/extract graphs execute on
  device (JAX async dispatch; extract splits into dispatch/finalize phases).
"""

from steganosaurus_jax.parallel.batch import (  # noqa: F401
    batched_embed_core,
    batched_read_core,
    make_mesh,
    shard_batch,
)
from steganosaurus_jax.parallel.fft_dist import (  # noqa: F401
    fft2_distributed,
    ifft2_real_distributed,
)
