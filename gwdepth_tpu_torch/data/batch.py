"""Static-shape training batch: the padded canvas with its validity mask.

The same six fields as `gwdepth_tpu.data.batch.Batch`, as torch tensors:

    images:    (B, H, W, 3) float32  normalized RGB on the padded canvas
    valid:     (B, H, W)    bool     True on real (non-padding) pixels
    depth:     (B, H, W)    float32  GT depth in meters (0 where missing)
    seg:       (B, H, W)    int64    glass segmentation {0, 1}
    lines:     (B, T, D)    float32  normalized line coords (+center), [0, 1]
    line_mask: (B, T)       bool     True for real GT lines
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

FIELDS = ("images", "valid", "depth", "seg", "lines", "line_mask")


@dataclasses.dataclass
class Batch:
    images: torch.Tensor
    valid: torch.Tensor
    depth: torch.Tensor
    seg: torch.Tensor
    lines: torch.Tensor
    line_mask: torch.Tensor

    @property
    def batch_size(self) -> int:
        return self.images.shape[0]

    def to(self, device, non_blocking: bool = False) -> "Batch":
        return Batch(*(getattr(self, f).to(device, non_blocking=non_blocking)
                       for f in FIELDS))

    def pin_memory(self) -> "Batch":
        """The batch in page-locked host memory, from which a copy to a
        card runs asynchronously. Raises where pinning fails: no path
        falls back to pageable memory."""
        return self.map(lambda t: t.pin_memory())

    def is_pinned(self) -> bool:
        return all(getattr(self, f).is_pinned() for f in FIELDS)

    def map(self, fn) -> "Batch":
        """A batch of `fn(field)` for every field."""
        return Batch(*(fn(getattr(self, f)) for f in FIELDS))

    @staticmethod
    def from_numpy(arrays) -> "Batch":
        """Batch from a mapping of numpy arrays, segmentation widened to
        int64."""
        t = {f: torch.from_numpy(np.ascontiguousarray(arrays[f]))
             for f in FIELDS}
        t["seg"] = t["seg"].long()
        return Batch(**t)


def dummy_batch(cfg, batch_size: int = 2, num_lines: int = 4,
                seed: int = 0) -> Batch:
    """Synthetic batch on the configured train canvas, the same numbers as
    the JAX package's `dummy_batch` for the same seed."""
    H, W = cfg.train_hw
    rng = np.random.default_rng(seed)
    T = cfg.max_lines
    lines = np.zeros((batch_size, T, cfg.line_dim), np.float32)
    lines[:, :num_lines] = rng.uniform(0.1, 0.9,
                                       (batch_size, num_lines, cfg.line_dim))
    mask = np.zeros((batch_size, T), bool)
    mask[:, :num_lines] = True
    return Batch.from_numpy({
        "images": rng.normal(0, 1, (batch_size, H, W, 3)).astype(np.float32),
        "valid": np.ones((batch_size, H, W), bool),
        "depth": rng.uniform(0.5, 9.5, (batch_size, H, W)).astype(np.float32),
        "seg": rng.integers(0, 2, (batch_size, H, W)),
        "lines": lines,
        "line_mask": mask,
    })
