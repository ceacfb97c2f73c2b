"""Port parity, IO and package boundary: the port's .splat codec and scene
generators against splatjax's (byte- and bit-equal), and a check that
splatjax_torch imports neither jax nor splatjax."""
import ast
import glob
import importlib
import inspect
import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import splatjax.io as jio
import splatjax_torch
import splatjax_torch.io as tio

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "trained_scene.splat")
FIELDS = ("means", "scales", "quats", "colors", "opacities")
EXAMPLES = ("demo_render", "demo_orbit", "demo_stereo", "demo_cutout",
            "demo_depth_interaction", "demo_train", "fit_trained_fixture")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _assert_scene_equal(t_scene, j_scene):
    for f in FIELDS:
        np.testing.assert_array_equal(
            getattr(t_scene, f).numpy(), np.asarray(getattr(j_scene, f)),
            err_msg=f,
        )


def test_splat_roundtrip_byte_equal(tmp_path):
    with open(FIXTURE, "rb") as f:
        data = f.read()
    j_scene = jio.parse_splat_bytes(data)
    t_scene = tio.load_splat(FIXTURE, device="cpu")
    assert t_scene.num_gaussians == len(data) // 32
    _assert_scene_equal(t_scene, j_scene)
    t_bytes = tio.scene_to_splat_bytes(t_scene)
    assert t_bytes == jio.scene_to_splat_bytes(j_scene)
    path = tmp_path / "rt.splat"
    tio.save_splat(path, t_scene)
    assert path.read_bytes() == t_bytes
    _assert_scene_equal(tio.load_splat(path, device="cpu"),
                        jio.parse_splat_bytes(t_bytes))


def test_synthetic_and_tile_scene_bit_equal():
    kw = dict(extent=0.6, scale_range=(0.02, 0.08))
    _assert_scene_equal(
        tio.synthetic_scene(257, seed=21, device="cpu", **kw),
        jio.synthetic_scene(257, seed=21, **kw),
    )
    base_t = tio.load_splat(FIXTURE, device="cpu")
    base_j = jio.parse_splat_bytes(open(FIXTURE, "rb").read())
    n = 3 * base_t.num_gaussians + 17          # a partial last repeat
    _assert_scene_equal(tio.tile_scene(base_t, n), jio.tile_scene(base_j, n))


def test_port_imports_no_jax():
    """Every splatjax_torch module, the multi-card ones included, imports
    with jax and splatjax blocked."""
    names = [m.name for m in pkgutil.walk_packages(
        splatjax_torch.__path__, "splatjax_torch.")]
    assert "splatjax_torch.ops.rasterize" in names
    assert {"splatjax_torch.parallel", "splatjax_torch.parallel.mesh",
            "splatjax_torch.parallel.dist_render",
            "splatjax_torch.parallel.dist_train"} <= set(names)
    assert {"splatjax_torch.utils", "splatjax_torch.utils.png",
            "splatjax_torch.tools.make_fixture",
            "splatjax_torch.reference.viewer_math",
            "splatjax_torch.examples"} | {
        f"splatjax_torch.examples.{m}" for m in EXAMPLES} <= set(names)
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['splatjax'] = None\n"
        f"for name in {['splatjax_torch'] + names!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'splatjax' or m.startswith('splatjax.')]\n"
        "assert all(sys.modules[m] is None for m in bad), bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def _imported_names(init_path):
    """The public names a package ``__init__`` binds by import."""
    with open(init_path) as f:
        tree = ast.parse(f.read())
    return {alias.asname or alias.name
            for node in ast.walk(tree)
            if isinstance(node, (ast.Import, ast.ImportFrom))
            for alias in node.names
            if not (alias.asname or alias.name).startswith("_")}


def _package_pairs():
    """(splatjax package, its __init__ path, the port's package) for every
    splatjax package."""
    inits = sorted(glob.glob(os.path.join(ROOT, "splatjax", "**",
                                          "__init__.py"), recursive=True))
    assert len(inits) >= 8
    for init in inits:
        rel = os.path.relpath(os.path.dirname(init),
                              os.path.join(ROOT, "splatjax"))
        suffix = "" if rel == "." else "." + rel.replace(os.sep, ".")
        yield "splatjax" + suffix, init, "splatjax_torch" + suffix


def test_public_surface_matches_splatjax():
    """Every public name a splatjax package __init__ imports is imported
    by the port's matching __init__, and resolves there."""
    for _, init, pkg in _package_pairs():
        port_init = os.path.join(ROOT, *pkg.split("."), "__init__.py")
        assert os.path.exists(port_init), pkg
        want = _imported_names(init)
        missing = want - _imported_names(port_init)
        assert not missing, (pkg, sorted(missing))
        mod = importlib.import_module(pkg)
        assert all(hasattr(mod, n) for n in want), pkg


# The parameter-name divergences ROADMAP.md's queue 3 records: the port's
# entry points take the result's `device`; a torch.Generator replaces a
# jax key; the optimizer object replaces its state; `CachedBins` keeps
# K3's rows instance-major (`prm`); a checkpoint also saves `extra`
# (the densify run's state). Everything else must match by name.
PORT_ONLY = {"device"}
RENAMED = {
    ("splatjax.train", "init_random"): {"key": "generator"},
    ("splatjax.train", "densify_and_prune"): {"opt_state": "opt"},
    ("splatjax.train", "CheckpointManager.save"): {"opt_state": "opt"},
    ("splatjax.train", "CheckpointManager.restore"): {
        "opt_state_like": "opt_like"},
    ("splatjax", "CachedBins"): {"prm_cm": "prm"},
}
EXTRA = {("splatjax.train", "CheckpointManager.save"): {"extra"}}


def _callables(pkg, names):
    """(name, object) for every callable of ``names`` in module ``pkg``
    and every public method of those that are classes."""
    mod = importlib.import_module(pkg)
    for n in sorted(names):
        obj = getattr(mod, n)
        if not callable(obj):
            continue
        yield n, obj
        if inspect.isclass(obj):
            for m in sorted(vars(obj)):
                if not m.startswith("_") and callable(getattr(obj, m)):
                    yield f"{n}.{m}", getattr(obj, m)


def _resolve(pkg, dotted):
    obj = importlib.import_module(pkg)
    for part in dotted.split("."):
        obj = getattr(obj, part)
    return obj


def test_public_callables_take_splatjax_parameter_names():
    """Every public callable a splatjax package __init__ exports (and each
    public method of its classes) has a counterpart in the port that takes
    the same parameter names, up to the divergences queue 3 records. The
    port's missing ``tile_size`` (render, bin_scene, SplatRenderer, ...)
    fails here."""
    checked = 0
    for jpkg, init, tpkg in _package_pairs():
        for name, jobj in _callables(jpkg, _imported_names(init)):
            key = (jpkg, name)
            want = {RENAMED.get(key, {}).get(p, p)
                    for p in inspect.signature(jobj).parameters}
            got = set(inspect.signature(_resolve(tpkg, name)).parameters)
            got -= PORT_ONLY | EXTRA.get(key, set())
            assert got == want, (key, "missing", sorted(want - got),
                                 "port only", sorted(got - want))
            checked += 1
    assert checked > 60
