"""Utilities of the port: :mod:`.checkpoint` (the ``.npz`` format shared
with the JAX package, training state and configs), :mod:`.metrics`
(JSON-lines metrics, throughput), :mod:`.resilience` (hang watchdog,
latest checkpoint), :mod:`.bijectors` (the MVN scale parameterisation),
:mod:`.profiling` (traces, synchronised timing, anomaly detection) and
:mod:`.substitution` (amino-acid substitution models)."""
