"""Port parity, .ply IO: splatjax_torch's ``parse_ply_bytes``, ``load_ply``
and ``save_ply`` against splatjax's on the same bytes (bit-equal arrays and
bytes), and the port's native (C++) converter, built with g++ from
``native/splat_ingest.cpp``, against the port's NumPy parser.

Native against NumPy: .splat rows and the .ply means, quaternions and
colors are bit-equal; the .ply scales and opacities go through the C
library's ``expf`` against NumPy's float32 ``exp`` and differ by at most 4
ulps; so the importance order may differ only between splats whose
importances lie within a relative 1e-6 of each other.
"""
import os

import numpy as np
import pytest
import torch

import splatjax.io as jio
from splatjax.io import ply_format as jply
from splatjax_torch.io import native
from splatjax_torch.io import ply_format as tply
import splatjax_torch.io as tio
from tests.test_io import _make_ply

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "trained_scene.ply")
FIELDS = ("means", "scales", "quats", "colors", "opacities")


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def native_lib():
    assert native.ensure_built(), "g++ could not build the native library"
    return native


def _fixture_bytes():
    with open(FIXTURE, "rb") as f:
        return f.read()


def _assert_equal(t_scene, j_scene):
    for f in FIELDS + ("sh",):
        want = getattr(j_scene, f)
        got = getattr(t_scene, f)
        if want is None:
            assert got is None, f
            continue
        assert got.dtype == torch.float32 and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                      err_msg=f)


def _typed_ply(n, rng):
    """A .ply whose properties use the other types of the header table,
    one of them unknown (read as int8, as 'char')."""
    props = [("double", "x"), ("float", "y"), ("short", "z"),
             ("uchar", "red"), ("char", "green"), ("int8", "blue"),
             ("ushort", "nx"), ("int", "ny"), ("uint", "nz")]
    dt = np.dtype([(name, {"double": "<f8", "float": "<f4", "short": "<i2",
                           "uchar": "u1", "char": "i1", "int8": "i1",
                           "ushort": "<u2", "int": "<i4", "uint": "<u4"}[t])
                   for t, name in props])
    body = np.zeros((n,), dt)
    for name in dt.names:
        body[name] = rng.integers(0, 100, n)
    header = ("ply\nformat binary_little_endian 1.0\n"
              f"element vertex {n}\n"
              + "".join(f"property {t} {name}\n" for t, name in props)
              + "end_header\n")
    return header.encode() + body.tobytes()


def _cases():
    rng = np.random.default_rng(0)
    return {
        "sh1": _make_ply(40, rng, with_sh_rest=9)[0],
        "sh2": _make_ply(40, rng, with_sh_rest=24)[0],
        "sh3": _make_ply(40, rng, with_sh_rest=45)[0],
        "no_sh": _make_ply(40, rng)[0],
        "pointcloud": _make_ply(30, rng, with_scale=False)[0],
        "typed": _typed_ply(25, rng),
    }


CASES = _cases()


@pytest.mark.parametrize("importance_sort", [True, False])
def test_parse_fixture_bit_equal(importance_sort):
    data = _fixture_bytes()
    _assert_equal(
        tply.parse_ply_bytes(data, importance_sort=importance_sort,
                             device="cpu"),
        jply.parse_ply_bytes(data, importance_sort=importance_sort))


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("max_sh_degree", [3, 1, 0])
def test_parse_synthetic_bit_equal(case, max_sh_degree):
    """SH degrees 1-3 cut to ``max_sh_degree``, missing scale/rotation/
    opacity/f_dc (the point-cloud fallbacks), and every header type."""
    data = CASES[case]
    kw = dict(max_sh_degree=max_sh_degree, importance_sort=True)
    got = tply.parse_ply_bytes(data, device="cpu", **kw)
    _assert_equal(got, jply.parse_ply_bytes(data, **kw))
    if case.startswith("sh") and max_sh_degree:
        assert got.sh.shape[1] == min(int(case[2:]),
                                      max_sh_degree) * (
            min(int(case[2:]), max_sh_degree) + 2)


def test_parse_rejects_what_splatjax_rejects():
    for bad, msg in ((b"ply\nno header end", "Unable to read"),
                     (b"ply\nend_header\n", "element vertex"),
                     (b"ply\nelement vertex 1\nproperty list uchar int "
                      b"vertex_indices\nend_header\n", "list properties")):
        with pytest.raises(ValueError, match=msg):
            tply.parse_ply_bytes(bad, device="cpu")
        with pytest.raises(ValueError, match=msg):
            jply.parse_ply_bytes(bad)


@pytest.mark.parametrize("case", ["fixture", "sh3", "no_sh"])
def test_save_ply_bytes_equal(tmp_path, case):
    data = _fixture_bytes() if case == "fixture" else CASES[case]
    t_path, j_path = tmp_path / "t.ply", tmp_path / "j.ply"
    tply.save_ply(t_path, tply.parse_ply_bytes(data, device="cpu"))
    jply.save_ply(j_path, jply.parse_ply_bytes(data))
    assert t_path.read_bytes() == j_path.read_bytes()
    # and what it wrote loads back to the same scene in both packages
    _assert_equal(tio.load_ply(t_path, backend="numpy", device="cpu"),
                  jio.load_ply(j_path, backend="numpy"))


def _assert_native_close(nat, ref, importance_sort):
    """``nat`` (native) against ``ref`` (NumPy) numpy dicts: see the module
    doc for the contract."""
    def imp(d):
        return d["scales"].prod(axis=-1) * d["opacities"]

    same_row = np.ones(ref["means"].shape[0], bool)
    if importance_sort:
        same_row = (nat["means"] == ref["means"]).all(axis=-1)
        moved = ~same_row
        np.testing.assert_allclose(imp(nat)[moved], imp(ref)[moved],
                                   rtol=1e-6)
    for f in ("means", "quats", "colors"):
        np.testing.assert_array_equal(nat[f][same_row], ref[f][same_row],
                                      err_msg=f)
    for f in ("scales", "opacities"):
        np.testing.assert_array_max_ulp(nat[f][same_row], ref[f][same_row],
                                        maxulp=4)
    if ref["sh"] is not None:
        np.testing.assert_array_equal(nat["sh"][same_row],
                                      ref["sh"][same_row])
    return int((~same_row).sum())


@pytest.mark.parametrize("importance_sort", [False, True])
@pytest.mark.parametrize("case", ["fixture", "sh3", "pointcloud", "typed"])
def test_native_ply_matches_numpy(native_lib, case, importance_sort):
    data = _fixture_bytes() if case == "fixture" else CASES[case]
    ref = tply.parse_ply_arrays(data, importance_sort=importance_sort)
    scene = native_lib.parse_ply_bytes_native(
        data, importance_sort=importance_sort, device="cpu")
    nat = {f: None if getattr(scene, f) is None
           else getattr(scene, f).numpy() for f in FIELDS + ("sh",)}
    moved = _assert_native_close(nat, ref, importance_sort)
    assert moved <= 8


def test_native_splat_bit_equal(native_lib, tmp_path):
    data = jio.synthetic_splat_bytes(513, seed=11)
    got = native_lib.parse_splat_bytes_native(data, device="cpu")
    _assert_equal(got, jio.parse_splat_bytes(data))
    path = tmp_path / "s.splat"
    path.write_bytes(data)
    _assert_equal(tio.load_splat(path, backend="native", device="cpu"),
                  jio.parse_splat_bytes(data))
    back = np.frombuffer(native_lib.scene_to_splat_bytes_native(got),
                         np.uint8).reshape(-1, 32).astype(np.int16)
    want = np.frombuffer(data, np.uint8).reshape(-1, 32).astype(np.int16)
    assert (back[:, :24] == want[:, :24]).all()
    assert np.abs(back[:, 24:] - want[:, 24:]).max() <= 1


def test_load_ply_backends(native_lib, tmp_path):
    path = tmp_path / "f.ply"
    path.write_bytes(_fixture_bytes())
    want = jio.load_ply(path, backend="numpy")
    _assert_equal(tio.load_ply(path, backend="numpy", device="cpu"), want)
    tio.load_ply(path, backend="native", device="cpu")
    assert native.available()
    # built or not, "auto" is the NumPy parser, the semantics of record
    _assert_equal(tio.load_ply(path, device="cpu"), want)
    # a header with CRLF line ends: the native converter reads no "x"
    # property and raises ValueError; "auto" parses it with NumPy
    head, body = CASES["sh1"].split(b"end_header\n", 1)
    crlf = tmp_path / "crlf.ply"
    crlf.write_bytes(head.replace(b"\n", b"\r\n") + b"end_header\n" + body)
    with pytest.raises(ValueError, match="malformed"):
        tio.load_ply(crlf, backend="native", device="cpu")
    _assert_equal(tio.load_ply(crlf, device="cpu"),
                  jio.load_ply(crlf, backend="numpy"))


def test_load_ply_auto_never_takes_native(native_lib, monkeypatch,
                                         tmp_path):
    """With the library built, "auto" still parses a .ply with NumPy (the
    native converter can swap near-tied splats); "native" takes it."""
    calls = []

    def spy(data, **kw):
        calls.append(len(data))
        raise ValueError("malformed (spy)")

    monkeypatch.setattr(native, "parse_ply_bytes_native", spy)
    path = tmp_path / "f.ply"
    path.write_bytes(CASES["sh1"])
    assert native.available()
    _assert_equal(tio.load_ply(path, device="cpu"), jio.load_ply(
        path, backend="numpy"))
    assert calls == []
    with pytest.raises(ValueError, match="spy"):
        tio.load_ply(path, backend="native", device="cpu")
    assert calls == [len(CASES["sh1"])]


def test_native_backend_raises_without_library(monkeypatch, tmp_path):
    """backend="native" raises when the library cannot be built; "auto"
    takes the NumPy parser."""
    from splatjax_torch.tools import build_native

    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(build_native, "library_path",
                        lambda: tmp_path / "absent" / "lib.so")
    monkeypatch.setattr(build_native, "CXX_FLAGS", ("--no-such-flag",))
    path = tmp_path / "f.ply"
    path.write_bytes(CASES["sh1"])
    assert not native.available()
    with pytest.raises(RuntimeError, match="unavailable"):
        tio.load_ply(path, backend="native", device="cpu")
    _assert_equal(tio.load_ply(path, device="cpu"), jio.load_ply(
        path, backend="numpy"))


def test_nothing_built_at_import():
    """Nothing is built or loaded when the modules are imported."""
    import subprocess
    import sys

    code = ("import splatjax_torch.io.native as n, "
            "splatjax_torch.tools.build_native as b, "
            "splatjax_torch.tools.convert\n"
            "assert n._lib is None\nprint(b.library_path().name)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout
    assert out.startswith("splat_ingest-") and out.strip().endswith(".so")
