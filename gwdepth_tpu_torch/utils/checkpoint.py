"""torch.save checkpoints: a rolling `checkpoint.pth` plus one copy every
`save_freq` epochs (`checkpoint{epoch:04}.pth`).

The payload is the original code's: {model, optimizer, lr_scheduler,
epoch, args}, plus the step count. `model` holds the original parameter
names, so a port checkpoint loads into the original code by name and the
original's `.pth` loads here (weights only). Writes go to a temporary
file first and are renamed into place, so a cut run never leaves half a
checkpoint.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch

ROLLING = "checkpoint.pth"


class CheckpointManager:
    def __init__(self, directory: str, save_freq_epochs: int = 25):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.save_freq = max(save_freq_epochs, 1)

    def save(self, epoch: int, state, config=None) -> str:
        """Write the rolling checkpoint (and the epoch's copy at every
        `save_freq`-th epoch); returns the rolling path."""
        payload = {"model": state.model.state_dict(),
                   "optimizer": state.optimizer.state_dict(),
                   "lr_scheduler": state.scheduler.state_dict(),
                   "epoch": epoch, "step": state.step,
                   "args": (dataclasses.asdict(config)
                            if config is not None else None)}
        paths = [os.path.join(self.directory, ROLLING)]
        if (epoch + 1) % self.save_freq == 0:
            paths.append(os.path.join(self.directory,
                                      f"checkpoint{epoch:04}.pth"))
        for path in paths:
            tmp = f"{path}.tmp{os.getpid()}"
            torch.save(payload, tmp)
            os.replace(tmp, path)
        return paths[0]

    def latest(self) -> Optional[str]:
        path = os.path.join(self.directory, ROLLING)
        return path if os.path.exists(path) else None

    def restore(self, state, path: Optional[str] = None,
                params_only: bool = False) -> int:
        """Load `path` (default: the rolling checkpoint) into `state`;
        returns the epoch to start from (0 when there is no checkpoint).
        `params_only` (`--no_opt`) loads the weights and keeps the fresh
        optimizer, schedule, step and epoch."""
        path = path or self.latest()
        if path is None:
            return 0
        return restore_file(state, path, params_only)


def restore_file(state, path: str, params_only: bool = False) -> int:
    """Restore a checkpoint file; see `CheckpointManager.restore`. A file
    without an optimizer state (the original code's weights-only `.pth`)
    restores the weights only."""
    from gwdepth_tpu_torch.predict import _normalize_keys

    raw = torch.load(path, map_location="cpu", weights_only=False)
    sd = _normalize_keys(raw.get("model", raw))
    res = state.model.load_state_dict(sd, strict=False)
    missing = [k for k in res.missing_keys
               if not k.endswith("relative_position_index")]
    if missing:
        raise KeyError(f"{path} lacks {len(missing)} tensors of the model, "
                       f"e.g. {missing[:5]}")
    if params_only or "optimizer" not in raw:
        return 0
    state.optimizer.load_state_dict(raw["optimizer"])
    state.scheduler.load_state_dict(raw["lr_scheduler"])
    state.step = int(raw.get("step", 0))
    return int(raw["epoch"]) + 1
