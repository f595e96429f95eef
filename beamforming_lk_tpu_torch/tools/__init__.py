"""Offline tools of the port (counterparts of the repository's ``tools/``
scripts that read the JAX package)."""
