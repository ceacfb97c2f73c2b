"""The roofline's work count against a count by hand."""
import math

import torch

import reference
import roofline


def _two_layers():
    """Two opaque gaussians over one 16 px tile, the nearer first: every
    pixel needs both (T = 1e-3 after the first, 1e-6 after the second)."""
    view = reference.View(torch.eye(4), torch.eye(4), 16, 16, 16)
    feat = torch.tensor([[8.0, 8.0, 1e-6, 0.0, 1e-6, 1.0, 0.0, 0.0, 1.0],
                         [8.0, 8.0, 1e-6, 0.0, 1e-6, 0.0, 1.0, 0.0, 1.0]])
    lists = reference.Lists(gid=torch.tensor([0, 1]),
                            starts=torch.tensor([0]), counts=torch.tensor([2]))
    return view, feat, lists


def test_work_counts_by_hand():
    view, feat, lists = _two_layers()
    b = reference.blend(feat, lists, view, alpha_clip=0.999, early_stop=1e-4)
    assert b.fragments == 256 * 2
    assert b.instances == 2
    rgb = b.image[..., :3]
    assert torch.allclose(rgb[..., 0], torch.full((16, 16), 0.999), atol=1e-6)
    assert torch.allclose(rgb[..., 1], torch.full((16, 16), 0.000999),
                          atol=1e-7)
    w = {"fragments": b.fragments, "instances": b.instances, "pixels": 256}
    want_fwd = max(12 * 512 / 67e12, (32 * 2 + 32 * 256) / 3.35e12)
    assert math.isclose(roofline.forward(w, 32), want_fwd)
    want_bwd = max(22 * 512 / 67e12, (16 + 32) * 2 / 3.35e12
                   + 48 * 256 / 3.35e12)
    assert math.isclose(roofline.backward(w, 16), want_bwd)
    want_k3 = max((12 * 512 + 192 * 2) / 67e12,
                  (64 * 2 + 32 * 256) / 3.35e12)
    assert math.isclose(roofline.cached(w), want_k3)


def test_early_stop_ends_the_count():
    """A third gaussian behind the two is walked by no pixel."""
    view, feat, _ = _two_layers()
    feat = torch.cat([feat, feat[:1]])
    lists = reference.Lists(gid=torch.tensor([0, 1, 2]),
                            starts=torch.tensor([0]),
                            counts=torch.tensor([3]))
    b = reference.blend(feat, lists, view, alpha_clip=0.999, early_stop=1e-4)
    assert b.fragments == 256 * 2 and b.instances == 2
    # the tile's one chunk is walked whole: the kernel's granularity
    assert b.walked_instances == 3
