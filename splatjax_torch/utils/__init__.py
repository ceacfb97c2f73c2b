from splatjax_torch.utils.png import encode_png, write_png

__all__ = ["encode_png", "write_png"]
