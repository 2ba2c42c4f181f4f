"""Training / evaluation CLI of the port, on one card.

The flags and defaults of `gwdepth_tpu.main`, plus `--device` (cuda by
default; the CUDA kernels run there, CPU tensors take their plain
versions). It writes the same `log.txt` JSON lines and
`eval_results.txt` lines, and `torch.save` checkpoints under
`<output_dir>/checkpoints/`.

  python -m gwdepth_tpu_torch.main --output_dir exp/ckpt_0 \\
      --data_path ... --gt_depth_path ... --gt_seg_path ... \\
      --gt_line_path ... --filenames_file_train ... --filenames_file_eval ... \\
      --with_line --with_dense --with_center --num_queries 100

Eval outputs, as the JAX CLI writes them under `<output_dir>`:
`--dump_gt_lines` the GT line npz files (`lines_npz/eval`), and with
`--eval`: `--benchmark` one prediction npz per image
(`benchmark/benchmark_val`, for `evaluation.sap_score`, `fscore_score`
and `aph_score`), `--save_dense` the depth/seg grids (`dense_pred`),
`--save_line` the predicted-vs-GT line overlays (`line_pred`). Training
writes the first batch's label overlay per epoch to `input_log`.

Every flag of the JAX CLI reaches the run, but two, which stop it
with an error instead of being ignored (see `_refuse`): `--mesh` other
than one device, and `--pre_norm` (which no JAX model reads either).
`--bf16` runs the backbone and the DETR's dense layers in bfloat16, as
the JAX CLI's (`cfg.dtype`; the parameters, the losses and AdamW stay
float32), and on the card lets cuBLAS and cuDNN round the float32
matmuls and convolutions to TF32 (`GWDepthConfig.set_matmul_precision`).
`--coco_path` with `--coco_ann_train` / `--coco_ann_val` trains
and evaluates on a COCO-lines set (wireframe, YorkUrban) instead of
GW-Depth; `--frozen_weights` loads the transformer, dense encoder,
decoder and line heads of a checkpoint by name and shape, and freezes
nothing (as the JAX CLI); `--remat` recomputes the dense encoder's Swin
blocks in the backward; `--with_plane_norm_loss` logs `loss_plane`,
which no total includes. `--with_reflection` sets the config flag and
nothing else: the reflection hints also need
`glassrgbd_rhint_points_path`, for which neither CLI has a flag. The
dense encoder's gates `--with_dense_center`, `--with_line_depth` and
`--class_tokenfuse_layers` reach the model. `--matcher` is accepted with
either value: the port always solves the assignment exactly on the host.
`--use_pallas` routes the model through kernels K1 and K2 (bf16 taps in
K2) as the JAX CLI routes it through its Pallas kernels; without it the
model runs their plain float32 formulations, on the card too.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from gwdepth_tpu_torch.config import GWDepthConfig, tiny_test_config


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("GW-Depth training (PyTorch/CUDA port)",
                                add_help=True)
    cfg = GWDepthConfig()
    for name in ("lr", "lr_backbone", "weight_decay", "dropout", "eos_coef",
                 "variance_focus", "set_cost_class", "set_cost_line",
                 "line_loss_coef", "seg_loss_weight", "plane_norm_loss_coef",
                 "min_depth_eval", "max_depth_eval"):
        p.add_argument(f"--{name}", type=float, default=getattr(cfg, name))
    for name in ("batch_size", "grad_accum", "epochs", "lr_drop", "seed",
                 "num_queries", "enc_layers", "dec_layers", "hidden_dim",
                 "nheads", "dim_feedforward", "layer1_num", "num_ref",
                 "max_lines", "class_init_size", "dense_trans_dim",
                 "dense_trans_heads", "class_token_dim"):
        p.add_argument(f"--{name}", type=int, default=getattr(cfg, name))
    p.add_argument("--pre_norm", action="store_true")
    p.add_argument("--clip_max_norm", type=float, default=cfg.clip_max_norm)
    p.add_argument("--backbone", type=str, default=cfg.backbone)
    p.add_argument("--position_embedding", type=str, default="sine",
                   choices=("sine", "v2", "learned", "v3"))
    p.add_argument("--max_depth", type=float, default=cfg.max_depth)
    for gate in ("with_line", "with_dense", "with_center",
                 "with_plane_norm_loss", "with_reflection",
                 "with_dense_center", "with_line_depth",
                 "aux_loss_off", "eval",
                 "log_depth_error", "bf16", "benchmark", "save_dense",
                 "save_line", "dump_gt_lines", "no_opt"):
        p.add_argument(f"--{gate}", action="store_true")
    p.add_argument("--label_loss_func", type=str, default="cross_entropy",
                   choices=("cross_entropy", "focal_loss"))
    p.add_argument("--focal_gamma", type=float, default=2.0)
    p.add_argument("--class_tokenfuse_layers", type=str, default="0,0,0")
    for name in ("data_path", "gt_depth_path", "gt_seg_path", "gt_line_path",
                 "filenames_file_train", "filenames_file_eval",
                 "glassrgbd_images_json", "output_dir", "resume",
                 "torch_init", "frozen_weights", "coco_path",
                 "coco_ann_train", "coco_ann_val"):
        p.add_argument(f"--{name}", type=str, default="")
    p.add_argument("--save_freq", type=int, default=25)
    p.add_argument("--eval_batch_size", type=int, default=1)
    p.add_argument("--eval_freq", type=int, default=1)
    p.add_argument("--matcher", type=str, default="jax",
                   choices=("jax", "scipy"),
                   help="accepted for compatibility: the port always solves "
                        "the assignment exactly on the host (scipy)")
    p.add_argument("--use_pallas", action="store_true",
                   help="run the model through kernels K1 and K2 (the "
                        "CUDA kernels on the card)")
    p.add_argument("--remat", action="store_true")
    p.add_argument("--num_workers", type=int, default=4)
    p.add_argument("--mesh", type=str, default="-1",
                   help="'-1' or '1': the port trains on one device")
    p.add_argument("--train_h", type=int, default=cfg.train_hw[0])
    p.add_argument("--train_w", type=int, default=cfg.train_hw[1])
    p.add_argument("--eval_h", type=int, default=cfg.eval_hw[0])
    p.add_argument("--eval_w", type=int, default=cfg.eval_hw[1])
    p.add_argument("--tiny", action="store_true",
                   help="toy model dims for smoke runs (keeps every "
                        "architectural mechanism)")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return p


_CFG_PASSTHROUGH = (
    "lr", "lr_backbone", "weight_decay", "dropout", "eos_coef",
    "variance_focus", "set_cost_class", "set_cost_line", "line_loss_coef",
    "seg_loss_weight", "plane_norm_loss_coef", "min_depth_eval",
    "max_depth_eval", "batch_size", "grad_accum", "epochs", "lr_drop",
    "seed", "clip_max_norm", "backbone", "position_embedding", "pre_norm",
    "num_queries", "enc_layers", "dec_layers", "hidden_dim", "nheads",
    "dim_feedforward", "layer1_num", "num_ref", "max_lines", "max_depth",
    "class_init_size", "dense_trans_dim", "dense_trans_heads",
    "class_token_dim", "with_line", "with_dense", "with_center",
    "with_plane_norm_loss", "with_reflection", "with_dense_center",
    "with_line_depth", "label_loss_func", "focal_gamma", "matcher",
    "use_pallas", "remat", "data_path", "gt_depth_path", "gt_seg_path",
    "gt_line_path", "filenames_file_train", "filenames_file_eval",
    "glassrgbd_images_json", "output_dir",
)


def _config_kwargs(args: argparse.Namespace) -> dict:
    kw = {name: getattr(args, name) for name in _CFG_PASSTHROUGH}
    kw.update(
        class_tokenfuse_layers=tuple(
            bool(int(v)) for v in args.class_tokenfuse_layers.split(",")),
        aux_loss=not args.aux_loss_off,
        log_depth_error=True,
        dtype="bfloat16" if args.bf16 else "float32",
        train_hw=(args.train_h, args.train_w),
        eval_hw=(args.eval_h, args.eval_w),
        mesh_shape=tuple(int(v) for v in args.mesh.split(",")),
        mesh_axes=("data", "model")[:len(args.mesh.split(","))],
    )
    return kw


def config_from_args(args: argparse.Namespace) -> GWDepthConfig:
    kw = _config_kwargs(args)
    if args.tiny:
        # only the values the user changed reach the toy config
        defaults = _config_kwargs(build_argparser().parse_args([]))
        kw = {k: v for k, v in kw.items() if v != defaults[k]}
        return tiny_test_config(**kw)
    return GWDepthConfig(**kw)


def _refuse(args: argparse.Namespace, cfg: GWDepthConfig) -> None:
    """Stop on a flag the port does not carry yet."""
    unsupported = ["--pre_norm"] if args.pre_norm else []
    if cfg.mesh_shape not in ((-1,), (1,)):
        unsupported.append(f"--mesh {args.mesh}")
    if unsupported:
        raise SystemExit(f"{', '.join(unsupported)}: not supported by the "
                         "PyTorch port yet")


def local_checkpoint(path: str, flag: str) -> str:
    """`path`, unless it is a URL: the port downloads nothing."""
    if path.startswith(("http://", "https://")):
        raise SystemExit(f"{flag} {path}: a URL; the PyTorch port reads "
                         "local checkpoints only")
    return path


def load_frozen_weights(model, path: str) -> int:
    """The two-stage warm start: the checkpoint's tensors whose names
    contain `encoder`, `decoder`, `class_embed`, `lines_embed` or
    `bbox_embed` (the transformer, the dense encoder, the depth decoder
    and the line heads; never the backbone or the input projections),
    each loaded where the model has a tensor of that name and shape.
    Nothing is frozen. Returns the number of tensors loaded."""
    import torch
    from gwdepth_tpu_torch.predict import _normalize_keys

    raw = torch.load(path, map_location="cpu", weights_only=False)
    raw = raw.get("model", raw)
    keep = ("encoder", "decoder", "class_embed", "lines_embed",
            "bbox_embed")
    sd = _normalize_keys({k: v for k, v in raw.items()
                          if any(t in k for t in keep)})
    own = model.state_dict()
    sd = {k: v for k, v in sd.items()
          if k in own and tuple(v.shape) == tuple(own[k].shape)}
    model.load_state_dict(sd, strict=False)
    print(f"frozen_weights from {path}: {len(sd)} tensors loaded "
          "(encoder/decoder/heads only)")
    return len(sd)


def dump_line_predictions(cfg: GWDepthConfig, line_dumps, out_dir: str
                          ) -> None:
    """One benchmark npz per image from `evaluate`'s `line_dumps`: the
    lines, normalized over the canvas, renormalized over the image's
    extent on it."""
    from gwdepth_tpu_torch.evaluation import dump_benchmark_npz

    ch, cw = cfg.eval_hw
    for d in line_dumps:
        ih, iw = [int(v) for v in d["extent"]]
        lines = np.asarray(d["pred_lines"], np.float64).copy()
        lines[:, 0::2] *= cw / max(iw, 1)
        lines[:, 1::2] *= ch / max(ih, 1)
        dump_benchmark_npz(out_dir, d["name"], d["pred_logits"], lines,
                           (ih, iw))


def main(argv=None):
    args = build_argparser().parse_args(argv)
    cfg = config_from_args(args)
    _refuse(args, cfg)

    import torch
    from gwdepth_tpu_torch.data.coco_lines import CocoLinesDataset
    from gwdepth_tpu_torch.data.dataset import GlassRGBDDataset, Loader
    from gwdepth_tpu_torch.engine import (evaluate, format_eval_line,
                                          train_one_epoch)
    from gwdepth_tpu_torch.evaluation import dump_gt_lines
    from gwdepth_tpu_torch.models import build_glassrgbd
    from gwdepth_tpu_torch.parallel import (create_train_state,
                                            make_eval_step, make_train_step)
    from gwdepth_tpu_torch.predict import load_original_checkpoint
    from gwdepth_tpu_torch.utils.checkpoint import (CheckpointManager,
                                                    restore_file)
    from gwdepth_tpu_torch.utils.logging import git_sha_banner

    def build_dataset(split):
        """COCO-lines with --coco_path, else GW-Depth."""
        if args.coco_path:
            ann = args.coco_ann_train if split == "train" else args.coco_ann_val
            return CocoLinesDataset(cfg, args.coco_path, ann, split)
        return GlassRGBDDataset(cfg, split)

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda, but CUDA is not available")
    device = torch.device(args.device)
    cfg.set_matmul_precision()
    out_dir = cfg.output_dir or "exp/default"
    os.makedirs(out_dir, exist_ok=True)
    print("git:", git_sha_banner())

    seed = cfg.seed
    np.random.seed(seed)
    torch.manual_seed(seed)
    generator = torch.Generator(device=device).manual_seed(seed)

    model = build_glassrgbd(cfg, seed, device="cpu")
    assert not (args.resume and args.frozen_weights), \
        "--resume and --frozen_weights are mutually exclusive"
    if args.torch_init:
        n = load_original_checkpoint(
            model, local_checkpoint(args.torch_init, "--torch_init"),
            warm_start=True)
        print(f"warm start from {args.torch_init}: {n} tensors loaded")
    if args.frozen_weights:
        load_frozen_weights(model, local_checkpoint(args.frozen_weights,
                                                    "--frozen_weights"))
    model = model.to(device)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"model: {n_params / 1e6:.1f}M params, device: {device}")

    eval_ds = build_dataset("val")
    eval_loader = Loader(eval_ds, batch_size=args.eval_batch_size,
                         shuffle=False, drop_last=False,
                         pad_to_batch=args.eval_batch_size > 1,
                         num_workers=args.num_workers)
    eval_step = make_eval_step(cfg, return_dense=args.save_dense)
    ckpt_dir = os.path.join(out_dir, "checkpoints")

    if args.dump_gt_lines:
        gt_dir = os.path.join(out_dir, "lines_npz", "eval")
        n = dump_gt_lines(eval_ds, gt_dir)
        print(f"GT line npz dumps ({n} images) -> {gt_dir}")
        if not args.eval:
            return {"gt_lines_dumped": n}

    if args.eval:
        state = create_train_state(cfg, model)
        CheckpointManager(ckpt_dir).restore(state)
        stats = evaluate(
            cfg, model, eval_step, eval_loader, device,
            collect_lines=args.benchmark,
            save_dense_dir=(os.path.join(out_dir, "dense_pred")
                            if args.save_dense else None),
            save_line_dir=(os.path.join(out_dir, "line_pred")
                           if args.save_line else None))
        if args.benchmark and cfg.with_line:
            bench_dir = os.path.join(out_dir, "benchmark", "benchmark_val")
            dump_line_predictions(cfg, stats.pop("line_dumps", []),
                                  bench_dir)
            print(f"benchmark npz dumps -> {bench_dir}")
        print(format_eval_line(0, stats))
        with open(os.path.join(out_dir, "eval_results.txt"), "a") as f:
            f.write(format_eval_line(0, stats) + "\n")
        return stats

    train_loader = Loader(build_dataset("train"),
                          batch_size=cfg.batch_size, shuffle=True, seed=seed,
                          num_workers=args.num_workers)
    state = create_train_state(cfg, model,
                               steps_per_epoch=max(len(train_loader), 1))
    train_step = make_train_step(cfg)
    ckpt = CheckpointManager(ckpt_dir, save_freq_epochs=args.save_freq)
    # --resume: a .pth file (this port's, or the original code's weights),
    # another experiment's checkpoint directory, or any other value for
    # this experiment's own rolling checkpoint; --no_opt keeps the fresh
    # optimizer, schedule and epoch
    start_epoch = 0
    if args.resume:
        if args.resume.endswith(".pth"):
            start_epoch = restore_file(state, args.resume, args.no_opt)
        else:
            rdir = args.resume if os.path.isdir(args.resume) else ckpt_dir
            start_epoch = CheckpointManager(rdir).restore(
                state, params_only=args.no_opt)
        print(f"resumed from {args.resume}: start epoch {start_epoch}")

    print("Start training")
    t0 = time.time()
    for epoch in range(start_epoch, cfg.epochs):
        state, train_stats = train_one_epoch(
            state, train_step, train_loader, epoch, generator, device,
            vis_dir=os.path.join(out_dir, "input_log"),
            with_center=cfg.with_center)
        ckpt.save(epoch, state, cfg)
        log = {"epoch": epoch,
               **{f"train_{k}": v for k, v in train_stats.items()}}
        if (epoch + 1) % args.eval_freq == 0:
            stats = evaluate(cfg, model, eval_step, eval_loader, device)
            log.update({f"test_{k}": v for k, v in stats.items()})
            with open(os.path.join(out_dir, "eval_results.txt"), "a") as f:
                f.write(format_eval_line(epoch, stats) + "\n")
        with open(os.path.join(out_dir, "log.txt"), "a") as f:
            f.write(json.dumps(log) + "\n")
    print(f"Training time {time.time() - t0:.0f}s")
    return state


if __name__ == "__main__":
    main()
