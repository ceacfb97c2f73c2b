from splatjax_torch.ops.projection import (
    ProjectedGaussians,
    eval_sh,
    project_gaussians,
)

__all__ = ["ProjectedGaussians", "eval_sh", "project_gaussians"]
