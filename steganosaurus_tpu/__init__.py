"""Former import name of steganosaurus_jax, kept so existing imports and
`python -m` calls of the CLI keep working (see steganosaurus_jax/_alias.py)."""

from steganosaurus_jax._alias import install

install(__name__)
