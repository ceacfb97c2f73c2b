"""The root conftest.py's xdist scheduling rule.

The root conftest.py is loaded by path: pytest registers more than one
module named ``conftest``, so ``import conftest`` could find another.
"""
import importlib.util
import os
from types import SimpleNamespace

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _root_conftest():
    spec = importlib.util.spec_from_file_location(
        "_root_conftest", os.path.join(REPO, "conftest.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


ROOT = _root_conftest()


@pytest.mark.parametrize("nodeid, scope", [
    ("tests/test_distributed.py::test_sharded_gradients_match_single_chip",
     "tests/test_distributed.py::test_sharded_gradients_match_single_chip"),
    ("tests/test_torch_tiles.py::test_render_matches_splatjax[tile8-32]",
     "tests/test_torch_tiles.py"),
], ids=["per_case", "per_file"])
def test_xdist_scope(nodeid, scope):
    assert ROOT.xdist_scope(nodeid) == scope


def _config(dist):
    values = {"dist": dist, "tx": ["2*popen"]}
    return SimpleNamespace(getoption=values.__getitem__,
                           getvalue=values.__getitem__)


@pytest.mark.parametrize("dist", ["load", "no"])
def test_hook_inert_outside_loadfile(dist):
    assert ROOT.pytest_xdist_make_scheduler(_config(dist), None) is None


@pytest.mark.parametrize("nodeid", [
    "tests/test_distributed.py::test_sharded_render_two_devices",
    "tests/test_png.py::test_png_round_trip_rgba",
], ids=["per_case", "per_file"])
def test_loadfile_scheduler_splits_by_xdist_scope(nodeid):
    sched = ROOT.pytest_xdist_make_scheduler(_config("loadfile"), None)
    assert sched._split_scope(nodeid) == ROOT.xdist_scope(nodeid)


@pytest.mark.parametrize("path", ROOT.PER_CASE_FILES)
def test_per_case_file_exists(path):
    assert path.startswith("tests/")
    assert os.path.isfile(os.path.join(REPO, path))
