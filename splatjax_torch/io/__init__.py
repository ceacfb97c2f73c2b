from splatjax_torch.io.ply_format import load_ply, parse_ply_bytes, save_ply
from splatjax_torch.io.splat_format import (
    ROW_LENGTH,
    StreamingSplatReader,
    load_splat,
    parse_splat_bytes,
    save_splat,
    scene_to_splat_bytes,
)
from splatjax_torch.io.synthetic import (
    synthetic_scene,
    synthetic_splat_bytes,
    tile_scene,
)

__all__ = [
    "ROW_LENGTH",
    "StreamingSplatReader",
    "load_ply",
    "load_splat",
    "parse_ply_bytes",
    "parse_splat_bytes",
    "save_ply",
    "save_splat",
    "scene_to_splat_bytes",
    "synthetic_scene",
    "synthetic_splat_bytes",
    "tile_scene",
]
