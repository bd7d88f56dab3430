"""Utilities of the port: :mod:`.checkpoint` (the ``.npz`` format shared
with the JAX package, training state and configs), :mod:`.metrics`
(JSON-lines metrics, throughput) and :mod:`.resilience` (hang watchdog,
latest checkpoint)."""
