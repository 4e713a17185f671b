"""Embed / extract / gen-key orchestration."""

from steganosaurus_jax.pipeline.embed import embed
from steganosaurus_jax.pipeline.extract import extract
from steganosaurus_jax.pipeline.errors import StegoError

__all__ = ["embed", "extract", "StegoError"]
