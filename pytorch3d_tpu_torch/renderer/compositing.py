"""Point compositing functions (port of pytorch3d_tpu/renderer/compositing.py).

They live in renderer/points/compositing.py; this module mirrors the JAX
package's layout.
"""

from .points.compositing import (  # noqa: F401
    alpha_composite,
    norm_weighted_sum,
    weighted_sum,
)
