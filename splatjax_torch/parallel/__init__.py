"""Multi-card rendering and training on ``torch.distributed`` (PyTorch
port of ``splatjax.parallel``): one process per rank, every rank passing
the full inputs and receiving the full outputs."""
from splatjax_torch.parallel.mesh import (
    init_distributed,
    make_mesh,
    make_mesh_2d,
)
from splatjax_torch.parallel.dist_render import (
    padded_band_height,
    render_sharded,
)
from splatjax_torch.parallel.dist_train import make_dp_band_train_step

__all__ = [
    "init_distributed",
    "make_mesh",
    "make_mesh_2d",
    "padded_band_height",
    "render_sharded",
    "make_dp_band_train_step",
]
