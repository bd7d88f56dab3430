"""Utilities of the port: :mod:`.checkpoint` (the ``.npz`` format shared
with the JAX package)."""
