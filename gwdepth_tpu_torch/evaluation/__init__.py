"""Offline line metrics (sAP, F-score, APH) and the benchmark dumps."""

from gwdepth_tpu_torch.evaluation.line_metrics import (  # noqa: F401
    ap, fscore, ms_tp_fp, sap_score, fscore_score, aph_score, aph_pr_points,
    postprocess_lines, line_nms, dump_benchmark_npz, dump_gt_lines)
