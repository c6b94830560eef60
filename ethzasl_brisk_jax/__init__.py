"""ethzasl_brisk_jax — a JAX BRISK feature framework.

A from-scratch JAX/XLA re-design of the capabilities of the
ethz-asl/ethzasl_brisk C++ library: AGAST/OAST corner scoring, the BRISK
scale-space detector (Harris and AST paths), the BRISK binary descriptor,
Hamming brute-force matching, camera models, plus new accelerator-first layers
(batched frame pipelines, sharded matching, VO/BA) that have no counterpart
in the reference.

Everything on the compute path is dense, statically shaped, batched and
jit-compiled; keypoint sets are fixed-capacity struct-of-arrays with
validity masks.
"""

from ethzasl_brisk_jax.core.keypoints import KeyPoints
from ethzasl_brisk_jax.pipeline import BriskFeature

__version__ = "0.1.0"

__all__ = ["KeyPoints", "BriskFeature", "__version__"]
