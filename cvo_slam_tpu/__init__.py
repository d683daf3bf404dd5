"""JAX RGB-D SLAM framework with the capabilities of bexilin/CVO-SLAM.

Brand-new JAX/XLA/Pallas implementation: CVO dense registration frontend,
keyframe/local-map tracking, pose-graph + BA backend, loop closure — built
from dense masked pairwise kernels, lax.while_loop solvers, fixed-capacity
graphs and shard_map scale-out; the align loop's moment pass has a fused
Pallas kernel for the GPU (cvo.moment_kernel).
"""

__version__ = "0.1.0"

# SLAM numerics need true f32 matmuls: on the GPU a float32 matmul may
# otherwise run in TF32 (about three decimal digits), which flips
# borderline kernel-threshold gates and degrades the flow integration.
import jax as _jax
_jax.config.update("jax_default_matmul_precision", "highest")
