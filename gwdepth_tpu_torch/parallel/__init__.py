"""Train state, train and eval steps, and the data mesh they run on."""

from gwdepth_tpu_torch.parallel.mesh import (  # noqa: F401
    DataMesh, make_mesh, setup)
from gwdepth_tpu_torch.parallel.train_state import (  # noqa: F401
    TrainState, create_train_state, param_group_label, param_groups)
from gwdepth_tpu_torch.parallel.train_step import (  # noqa: F401
    compute_losses, depth_error_sums, make_eval_step, make_train_step,
    seg_confusion, summarize_depth, summarize_seg)
