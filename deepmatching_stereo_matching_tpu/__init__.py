"""DeepMatching dense stereo-matching engine in JAX.

A from-scratch JAX/XLA re-architecture of the capabilities of
`Yuki-Kumon/deepmatching_stereo_matching` (see SURVEY.md): patch-level
correlation cost volumes, the DeepMatching aggregation pyramid, dense
top-down backtracking, and disparity extraction with left-right
consistency — jitted end-to-end on device and sharded over device
meshes.
"""

from .config import Config, Geometry

__all__ = ["Config", "Geometry"]
__version__ = "0.1.0"
