from gwdepth_tpu_torch.models.glassrgbd import (GlassRGBD, build_glassrgbd,
                                               init_weights)

__all__ = ["GlassRGBD", "build_glassrgbd", "init_weights"]
