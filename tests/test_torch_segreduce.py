"""Port parity, gradient gather transpose: the plain versions of the port's
K5/K6/K7 (``splatjax_torch.ops.segreduce`` on CPU tensors) and its
``segment_sum_by_gid*`` against splatjax's Pallas kernels (interpret mode)
and its ``segment_sum_by_gid*`` on the same numpy rows.

Layouts differ: the port's rows and sums are instance-major (K, C) /
(N, C), splatjax's feature-major (C, K) / (C, N); the tests transpose.

Tolerances:
* K6 (biased-u16 pairs) is bit-equal: both return the exact integer run
  sum rounded once to f32. The default "i16" gather mode built on it is
  bit-equal too (same scale, same rounding, same sums).
* K5 (f32 rows) and K7 (bf16 pairs): rtol 1e-5 and atol 1e-5 x the
  channel's largest |sum|. The port's plain versions sum each run in
  float64; splatjax sums windowed one-hot matmuls in f32, which round at
  about 2^-24 of a window's prefix.
* ``_pack_grad_bf16`` is bit-equal.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from splatjax.ops import binning as jb
from splatjax.ops import segreduce as js
from splatjax.ops.rasterize_vjp import _pack_grad_bf16 as j_pack_grad_bf16

from splatjax_torch.ops import binning as tb
from splatjax_torch.ops import segreduce as ts
from splatjax_torch.ops.rasterize_vjp import _pack_grad_bf16

RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _t(a):
    return torch.from_numpy(np.array(a))


def _runs(n=256, k=2048, seed=0, max_run=7):
    """Inclusive run ends for n gaussians with 0..max_run rows each, padded
    so the total stays below k (pad rows match no run)."""
    rng = np.random.default_rng(seed)
    count = rng.integers(0, max_run, size=n)
    count[5] = 40                       # one long run
    cum = np.cumsum(count).astype(np.int32)
    assert cum[-1] <= k
    return cum


def _close(got, want):
    """|got - want| <= RTOL (|want| + the channel's largest |want|)."""
    scale = np.abs(want).max(axis=0, keepdims=True)
    err = np.abs(got - want)
    bound = RTOL * (np.abs(want) + scale)
    assert (err <= bound).all(), (err / np.maximum(bound, 1e-30)).max()


def _packed_rows(rng, k, kind):
    if kind == "u16":
        u = rng.integers(1, 65536, size=(k, 16)).astype(np.int64)
    else:
        g = rng.normal(size=(k, 16)) * 10.0 ** rng.integers(-3, 3, (1, 16))
        u = (_t(g.astype(np.float32)).to(torch.bfloat16).view(torch.int16)
             .numpy().astype(np.int64) & 0xFFFF)
    return ((u[:, 8:] << 16) | u[:, :8]).astype(np.uint32).view(np.int32)


@pytest.mark.parametrize("kind", ["rows", "u16", "bf16"])
def test_segment_reduce_plain_matches_splatjax(kind):
    rng = np.random.default_rng(1)
    k = 2048
    cum = _runs(k=k)
    if kind == "rows":
        rows = rng.normal(size=(k, 16)).astype(np.float32)
        want = np.asarray(js.segment_reduce_rows(jnp.asarray(rows.T),
                                                 jnp.asarray(cum))).T
        got = ts.segment_reduce_rows(_t(rows), _t(cum)).numpy()
        _close(got, want)
        return
    rows = _packed_rows(rng, k, kind)
    jfn = {"u16": js.segment_reduce_packed_u16,
           "bf16": js.segment_reduce_packed_bf16}[kind]
    tfn = {"u16": ts.segment_reduce_packed_u16,
           "bf16": ts.segment_reduce_packed_bf16}[kind]
    want = np.asarray(jfn(jnp.asarray(rows.T), jnp.asarray(cum))).T
    got = tfn(_t(rows), _t(cum)).numpy()
    assert got.shape == want.shape == (cum.shape[0], 16)
    if kind == "u16":
        np.testing.assert_array_equal(got, want)
    else:
        _close(got, want)


def _gather_case(n, cap, seed, truncate):
    """bin_gaussians' run structure: depth-major instances truncated at
    cap (dropping the depth-farthest), shuffled like a tile sort, sentinel
    tail gid n - 1 with zero rows."""
    rng = np.random.default_rng(seed)
    count = rng.integers(0, 5, size=n).astype(np.int32)
    depth = -rng.uniform(1.0, 9.0, size=n).astype(np.float32)
    cum = np.cumsum(count).astype(np.int32)
    assert (int(cum[-1]) > cap) == truncate
    perm = np.argsort(np.where(count > 0, -depth, np.inf),
                      kind="stable").astype(np.int32)
    count_d = count[perm]
    cum_d = np.cumsum(count_d).astype(np.int32)
    gid_depth = np.repeat(perm, count[perm])[:cap]
    valid = len(gid_depth)
    gid = np.full((cap,), n - 1, np.int32)
    gid[:valid] = gid_depth[rng.permutation(valid)]
    g = (rng.normal(size=(cap, 16))
         * 10.0 ** rng.integers(-2, 3, size=(1, 16))).astype(np.float32)
    g[valid:] = 0.0
    return dict(gid=gid, cum=cum, count=count, perm=perm, cum_d=cum_d,
                count_d=count_d,
                overflow=np.int32(max(int(cum[-1]) - cap, 0))), g


RES = ("gid", "cum", "count", "perm", "cum_d", "count_d", "overflow")


@pytest.mark.parametrize("mode", ["f32", "i16", "bf16"])
@pytest.mark.parametrize("truncate", [False, True], ids=["full", "overflow"])
def test_segment_sum_by_gid_matches_splatjax(monkeypatch, mode, truncate):
    monkeypatch.setenv("SPLATJAX_GRAD_GATHER", mode)
    n, cap = (37, 64) if truncate else (23, 256)
    res, g = _gather_case(n, cap, seed=3 if truncate else 4,
                          truncate=truncate)
    want = np.asarray(jb.segment_sum_by_gid(
        jnp.asarray(g.T), *(jnp.asarray(res[k]) for k in RES)))
    got = tb.segment_sum_by_gid(_t(g), *(_t(res[k]) for k in RES)).numpy()
    assert got.shape == want.shape == (n, 16)
    if mode == "i16":
        np.testing.assert_array_equal(got, want)
    else:
        _close(got, want)
    if mode == "f32":   # the exact transpose of the gather
        expect = np.zeros((n, 16), np.float64)
        np.add.at(expect, res["gid"], g.astype(np.float64))
        _close(got, expect)


@pytest.mark.parametrize("truncate", [False, True], ids=["full", "overflow"])
def test_segment_sum_by_gid_packed_bf16_matches_splatjax(truncate):
    n, cap = (37, 64) if truncate else (23, 256)
    res, g = _gather_case(n, cap, seed=3 if truncate else 5,
                          truncate=truncate)
    gp = _pack_grad_bf16(_t(g)).numpy()
    want = np.asarray(jb.segment_sum_by_gid_packed_bf16(
        jnp.asarray(gp.T), *(jnp.asarray(res[k]) for k in RES)))
    got = tb.segment_sum_by_gid_packed_bf16(
        _t(gp), *(_t(res[k]) for k in RES)).numpy()
    assert got.shape == want.shape == (n, 16)
    _close(got, want)


def test_pack_grad_bf16_bit_equal():
    rng = np.random.default_rng(7)
    g = (rng.normal(size=(300, 16))
         * 10.0 ** rng.integers(-30, 30, size=(300, 16))).astype(np.float32)
    g[0] = 0.0
    g[1] = -0.0
    got = _pack_grad_bf16(_t(g)).numpy()
    want = np.asarray(j_pack_grad_bf16(jnp.asarray(g.T))).T
    np.testing.assert_array_equal(got, want)
    # decoding gives each value rounded to bf16
    back = ts.unpack_bf16_pairs(_t(got)).numpy()
    np.testing.assert_array_equal(
        back, _t(g).to(torch.bfloat16).float().numpy())


def test_effective_cum_matches_splatjax():
    for truncate in (False, True):
        n, cap = (37, 64) if truncate else (23, 256)
        res, _ = _gather_case(n, cap, seed=3 if truncate else 4,
                              truncate=truncate)
        want = np.asarray(jb._effective_cum(
            *(jnp.asarray(res[k]) for k in RES[1:]), cap))
        got = tb._effective_cum(*(_t(res[k]) for k in RES[1:]), cap)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


def test_grad_gather_mode_read_at_call_time(monkeypatch):
    monkeypatch.delenv("SPLATJAX_GRAD_GATHER", raising=False)
    assert tb._grad_gather_mode() == jb._grad_gather_mode() == "i16"
    monkeypatch.setenv("SPLATJAX_GRAD_GATHER", "bf16")
    assert tb._grad_gather_mode() == "bf16"


def test_segreduce_wrappers_reject_bad_inputs():
    cum = _t(np.array([2, 4], np.int32))
    with pytest.raises(ValueError, match="rows"):
        ts.segment_reduce_rows(torch.zeros((4, 16), dtype=torch.float64), cum)
    with pytest.raises(ValueError, match="dividing 32"):
        ts.segment_reduce_rows(torch.zeros((4, 12)), cum)
    with pytest.raises(ValueError, match="rows"):
        ts.segment_reduce_packed_u16(torch.zeros((4, 4), dtype=torch.int32),
                                     cum)
    with pytest.raises(ValueError, match="eff_cum"):
        ts.segment_reduce_packed_bf16(torch.zeros((4, 8), dtype=torch.int32),
                                      cum.long())
    # an empty scene sums nothing
    assert ts.segment_reduce_rows(torch.zeros((0, 16)),
                                  torch.zeros((0,), dtype=torch.int32)
                                  ).shape == (0, 16)
