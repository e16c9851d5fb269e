"""Convergence analytics of the SCF loop (copies of sirius_tpu/obs/)."""
