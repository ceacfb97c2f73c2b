from splatjax_torch.reference import viewer_math
from splatjax_torch.reference.rasterizer import (
    composite_pixels,
    render_projected_reference,
    render_reference,
)

__all__ = [
    "composite_pixels",
    "render_projected_reference",
    "render_reference",
    "viewer_math",
]
