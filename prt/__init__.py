"""prt: a differentiable renderer with the capability surface of pbrt-v1
(see SURVEY.md). Built on JAX/XLA/Pallas."""
import jax as _jax

# Geometry is precision-critical: on an H100, XLA runs float32 matmuls in
# TF32 by default (10-bit mantissa, ~1e-3 relative), enough error to break
# ray-surface intersection (self-shadowing) and to make the matmul-based
# rank in integrators/path_wavefront.py inexact. All matmuls in the renderer
# go through full f32.
_jax.config.update("jax_default_matmul_precision", "highest")

__version__ = "0.1.0"
