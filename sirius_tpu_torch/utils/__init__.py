"""Fault injection, device-failure classes, timers and checksums (copies
of sirius_tpu/utils/)."""
