"""Test scheduling under pytest-xdist's ``--dist loadfile``.

``--dist loadfile`` gives each test file to one worker whole. The files
named in ``PER_CASE_FILES`` go to workers case by case instead.
"""
import pytest

# tests/test_distributed.py (19 cases of splatjax's shard_map paths on the
# 8-device virtual CPU mesh) held one worker for 1360-1523 s, the whole of
# the suite's wall. It is the JAX reference's own test, older than the
# PyTorch port, and is kept as it is rather than split into files.
PER_CASE_FILES = ("tests/test_distributed.py",)


def xdist_scope(nodeid):
    """The unit of work a test belongs to: its node id or its file."""
    path = nodeid.split("::", 1)[0]
    return nodeid if path in PER_CASE_FILES else path


@pytest.hookimpl(optionalhook=True)
def pytest_xdist_make_scheduler(config, log):
    if config.getoption("dist") != "loadfile":
        return None
    from xdist.scheduler import LoadFileScheduling

    class CaseScopedLoadFile(LoadFileScheduling):
        def _split_scope(self, nodeid):
            return xdist_scope(nodeid)

    return CaseScopedLoadFile(config, log)
