"""Training losses: line set criterion, multi-scale SiLog depth, seg CE."""

from gwdepth_tpu_torch.losses.criterion import (  # noqa: F401
    build_match_cost, line_set_criterion, multiscale_depth_loss, seg_ce_loss,
    silog_loss)
