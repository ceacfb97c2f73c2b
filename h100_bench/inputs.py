"""The benchmark's inputs, made from ``--seed``: the tiled scene, the noisy
training start, the eyes and the views. Both the program and the reference
take these; the program makes none of them."""
from __future__ import annotations

import math
from pathlib import Path

import numpy as np
import torch

from reference import View, look_at, perspective

SPLAT_ROW = 32
# streams of one seed: each draw takes its own generator
_STREAMS = {"offsets": 1, "sh": 2, "noise": 3, "eyes": 4, "sample": 5}


def generator(seed: int, stream: str, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) << 4) | _STREAMS[stream])
    return g


def rng(seed: int, stream: str) -> np.random.Generator:
    return np.random.default_rng([int(seed), _STREAMS[stream]])


def parse_splat(path: Path) -> dict:
    """A .splat file as float32 arrays in the renderer's world space: z of
    the positions negated, the quaternion (w, x, y, z) = (q0, -q1, -q2, q3)
    of the stored bytes, as the reference viewer builds them."""
    raw = np.frombuffer(path.read_bytes(), dtype=np.uint8)
    rows = raw[: raw.size // SPLAT_ROW * SPLAT_ROW].reshape(-1, SPLAT_ROW)
    floats = rows[:, :24].copy().view("<f4")
    rgba = rows[:, 24:28].astype(np.float32) / 255.0
    q = (rows[:, 28:32].astype(np.float32) - 128.0) / 128.0
    return dict(
        means=floats[:, :3] * np.array([1.0, 1.0, -1.0], np.float32),
        scales=floats[:, 3:6].astype(np.float32),
        quats=np.stack([q[:, 0], -q[:, 1], -q[:, 2], q[:, 3]], axis=-1),
        colors=rgba[:, :3].copy(),
        opacities=rgba[:, 3].copy(),
    )


def tiled_scene(base: dict, cfg: dict, seed: int, device) -> dict:
    """``cfg["splats"]`` gaussians: copies of the base scene shrunk by
    ``tile_scale``, each moved by an offset drawn uniformly from
    [-tile_jitter, tile_jitter]^3, on the device."""
    n = int(cfg["splats"])
    m = base["means"].shape[0]
    reps = -(-n // m)
    jit = float(cfg["tile_jitter"])
    offs = (torch.rand((reps, 3), generator=generator(seed, "offsets", device),
                       device=device) * 2.0 - 1.0) * jit
    t = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
         for k, v in base.items()}
    s = float(cfg["tile_scale"])
    scene = dict(
        means=(t["means"][None] * s + offs[:, None, :]).reshape(-1, 3)[:n],
        scales=(t["scales"] * s).repeat(reps, 1)[:n],
        quats=t["quats"].repeat(reps, 1)[:n],
        colors=t["colors"].repeat(reps, 1)[:n],
        opacities=t["opacities"].repeat(reps)[:n],
        sh=None,
    )
    bases = (int(cfg.get("sh_degree", 0)) + 1) ** 2 - 1
    if bases:
        scene["sh"] = torch.randn((n, bases, 3),
                                  generator=generator(seed, "sh", device),
                                  device=device) * float(cfg["sh_std"])
    return {k: None if v is None else v.contiguous() for k, v in scene.items()}


def raw_leaves(scene: dict) -> dict:
    """The training leaves of a scene (log scales, logits of color and
    opacity)."""
    eps = 1e-6
    col = scene["colors"].clamp(eps, 1.0 - eps)
    opa = scene["opacities"].clamp(eps, 1.0 - eps)
    return dict(
        means=scene["means"].clone(),
        log_scales=torch.log(scene["scales"].clamp_min(1e-12)),
        quats=scene["quats"].clone(),
        logit_opacities=torch.log(opa) - torch.log1p(-opa),
        colors=torch.log(col) - torch.log1p(-col),
        sh=None if scene["sh"] is None else scene["sh"].clone(),
    )


def noisy(raw: dict, noise: dict, seed: int) -> dict:
    """A copy of the leaves with seeded normal noise of the given std on
    each leaf named in ``noise``."""
    out = {k: None if v is None else v.clone() for k, v in raw.items()}
    dev = raw["means"].device
    g = generator(seed, "noise", dev)
    for leaf, std in sorted(noise.items()):
        if out.get(leaf) is not None:
            out[leaf] += float(std) * torch.randn(out[leaf].shape, generator=g,
                                                  device=dev)
    return out


def eyes(spec: dict, seed: int) -> list:
    """The eyes of a traffic mix, each looking at the origin:

    * ``cap``: uniform on the sphere of ``radius`` within ``half_angle_deg``
      of +z;
    * ``orbit``: ``count`` eyes evenly on a circle of ``radius`` about
      ``center`` in its z plane, the first at a phase drawn from the seed;
    * ``arc``: ``radius`` from the origin, azimuth about +z drawn in
      ±``azimuth_deg``, elevation in ±``elevation_deg``."""
    r = rng(seed, "eyes")
    n = int(spec["count"])
    kind = spec["kind"]
    if kind == "cap":
        cos_h = math.cos(math.radians(float(spec["half_angle_deg"])))
        ct = r.uniform(cos_h, 1.0, n)
        ph = r.uniform(0.0, 2.0 * math.pi, n)
        st = np.sqrt(1.0 - ct * ct)
        rad = float(spec["radius"])
        return [(rad * s * math.cos(p), rad * s * math.sin(p), rad * c)
                for s, p, c in zip(st, ph, ct)]
    if kind == "orbit":
        phase = r.uniform(0.0, 1.0)
        cx, cy, cz = spec["center"]
        rad = float(spec["radius"])
        return [(cx + rad * math.sin(2 * math.pi * (i + phase) / n),
                 cy + rad * math.cos(2 * math.pi * (i + phase) / n), cz)
                for i in range(n)]
    if kind == "arc":
        az = np.radians(r.uniform(-1, 1, n) * float(spec["azimuth_deg"]))
        el = np.radians(r.uniform(-1, 1, n) * float(spec["elevation_deg"]))
        rad = float(spec["radius"])
        return [(rad * math.cos(e) * math.sin(a), rad * math.sin(e),
                 rad * math.cos(e) * math.cos(a)) for a, e in zip(az, el)]
    raise ValueError(f"unknown eye kind {kind!r}")


def views(eye_list: list, cfg: dict, device) -> list:
    proj = perspective(float(cfg["fov_y_deg"]),
                       cfg["width"] / cfg["height"]).to(device)
    return [View(look_at(e).to(device), proj, int(cfg["width"]),
                 int(cfg["height"]), int(cfg["tile_size"])) for e in eye_list]


def capacity(demands: list, margin: float) -> int:
    """The largest demand over the views, plus ``margin``, aligned to
    1024."""
    need = math.ceil(max(demands) * (1.0 + margin))
    return max(1024, -(-need // 1024) * 1024)
