"""Training losses: line set criterion, multi-scale SiLog depth, seg CE,
and the plane-normal loss that the train step logs."""

from gwdepth_tpu_torch.losses.criterion import (  # noqa: F401
    build_match_cost, line_set_criterion, multiscale_depth_loss, seg_ce_loss,
    silog_loss)
from gwdepth_tpu_torch.losses.plane import (  # noqa: F401
    plane_norm_loss, point_in_triangle, sobel_grad)
