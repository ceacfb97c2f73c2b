"""Port parity, PNG writer: splatjax_torch.utils.encode_png gives the bytes
of splatjax.utils.encode_png for the same image (stdlib zlib, level 6,
filter byte 0), and takes a CPU tensor as its numpy array."""
import numpy as np
import pytest
import torch

from splatjax.utils import encode_png as j_encode_png

from splatjax_torch.utils.png import encode_png, to_u8, write_png


def _images():
    rng = np.random.default_rng(3)
    return {
        "rgba_float": rng.random((23, 41, 4)).astype(np.float32),
        "rgb_float": rng.random((9, 14, 3)).astype(np.float32),
        "gray_2d": (np.ones((4, 4)) * 0.5),
        "gray_1ch": rng.random((6, 5, 1)).astype(np.float32),
        "uint8": np.arange(48, dtype=np.uint8).reshape(4, 4, 3),
        "out_of_range": rng.normal(0.5, 1.0, (7, 8, 4)).astype(np.float32),
        "float64_halves": (np.arange(256)[None, :, None] / 510.0)
        .repeat(3, 2),
    }


@pytest.mark.parametrize("name", sorted(_images()))
def test_encode_png_bytes_equal_splatjax(name):
    img = _images()[name]
    assert encode_png(img) == j_encode_png(img)


@pytest.mark.parametrize("name", ["rgba_float", "uint8", "out_of_range",
                                  "gray_2d"])
def test_encode_png_takes_a_cpu_tensor(name, tmp_path):
    img = _images()[name]
    t = torch.from_numpy(np.array(img))
    if name == "rgba_float":
        t.requires_grad_(True)          # read through .detach()
    assert encode_png(t) == j_encode_png(img)
    np.testing.assert_array_equal(to_u8(t), to_u8(img))
    path = tmp_path / "t.png"
    write_png(str(path), t)
    assert path.read_bytes() == j_encode_png(img)
