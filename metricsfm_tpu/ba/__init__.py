"""Bundle adjustment: residuals, Schur-complement LM, distributed assembly.

Replaces the reference's Ceres DENSE_SCHUR BundleAdjuster
(SfM/src/optimizer.{h,cc}) with a native Levenberg-Marquardt solver designed
for batched device execution: fixed-shape masked track tensors, vmapped per-observation
Jacobians, block-sparse Schur reduction assembled with segment-sums and
static scatters, and (for multi-chip) psum-assembled reduced camera systems.
"""
from .problem import BAProblem  # noqa: F401
from .lm import solve_lm, LMConfig  # noqa: F401
