"""matchinglib_poselib_tpu — Batched sparse matching and pose estimation.

A from-scratch JAX/XLA/Pallas framework with the capabilities of the C++
reference `josefmaierfl/matchinglib_poselib` (feature detection/description/
matching + robust relative pose estimation + refinement + bundle adjustment +
rectification + continuous stereo pose refinement), re-designed accelerator-first:

- fixed-shape, masked, batched arrays everywhere (no pointer-chasing)
- minimal solvers (5pt/8pt/homography) batched over thousands of hypotheses
- robust estimation as massive hypothesis batches scored densely as matmuls
- descriptor matching as tiled Hamming/L2 distance-matrix kernels (Pallas)
- scale-out via jax.sharding Mesh axes ("pairs", "db") and XLA collectives

See SURVEY.md at the repo root for the reference blueprint.
"""

__version__ = "0.1.0"

import jax as _jax

# Geometry/solver math needs true f32 matmuls: a reduced-precision default
# (bf16 or TF32 passes) introduces ~1e-3 error, which breaks
# essential-matrix SVDs and rotation orthonormality. Kernels that tolerate or exploit bf16 (descriptor
# Hamming/L2 distance matrices) request lower precision explicitly.
_jax.config.update("jax_default_matmul_precision", "highest")

from matchinglib_poselib_tpu.config import (  # noqa: F401
    MatchingConfig,
    PoseConfig,
    RobustConfig,
    StereoRefineConfig,
)
