"""Band occupations: smearing functions and Fermi-level search.

Reference: src/dft/smearing.cpp (definitions copied exactly, argument
x = E_F - e) and K_point_set::find_band_occupancies
(k_point_set.cpp:171-378, Newton with bisection fallback). Mirrors
sirius_tpu/dft/occupation.py: a fixed-count bisection over (k, spin,
band), on tensors. The functions live with their kernel, K13
(kernels/fermi.py: the plain version on a CPU tensor, one launch for the
whole search on a CUDA tensor).
"""

from sirius_tpu_torch.kernels.fermi import (  # noqa: F401
    entropy_term,
    find_fermi,
    occupancy,
)
