"""Host-side tools of the port: the offline dataset toolchain (the JAX
package's `tools/`, re-exported as there), SNE normals in torch
(`tools.sne`), the synthetic dataset and the kernels' A/B tools."""

from gwdepth_tpu_torch.tools.depth_completion import (  # noqa: F401
    Intrinsics, deproject, project, interpolate_side_points,
    complete_polygon_depth, complete_depth, compare_depth_preds)
from gwdepth_tpu_torch.tools.reflection import (  # noqa: F401
    reflection_difference, sample_reflection_points)
