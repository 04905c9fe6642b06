"""The port's spec rules, grid and flat ranges against the reference.

  * ``param_specs`` equals the reference's leaf for leaf for all ten archs
    at full size, on stub meshes of 16 x 16 and 2 x 16 x 16 (the
    reference's ``jax.eval_shape`` trees, the port's ``meta`` trees), and
    so do ``make_plan``, ``batch_specs``, ``wire_state_specs``,
    ``server_state_specs`` and ``cache_specs`` (the decode and long-context
    caches of every family); the grid's own state layout,
    ``range_state_specs`` and ``range_server_specs``, holds a rank's range.
  * E1 over a range: the plain encode of coordinates [t0 * 8192, t1 *
    8192) with ``tile0 = t0`` is the byte slice of the whole vector's
    encode: bit for bit the reference's ``fused_sign_encode_jnp`` at z =
    inf, and at z = 1 the port's own whole-vector encode (the reference's
    up to the erf rule).
  * ``_LeafShards`` maps shard elements to leaf positions as slicing does
    (a leaf cut along one dimension or, an expert tensor, along two),
    ``flat_ranges`` cuts whole tiles, ``RangeLayout.flat_coords`` gives a
    shard element's flat coordinate, and each exchange's piece count
    covers what every rank sends and receives.
  * ``make_production_mesh`` on a fake group of 256 ranks: coordinates,
    subgroup sizes and indices.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs.common import SHAPES as JSHAPES
from repro.configs.common import get_arch as j_arch
from repro.configs.common import list_archs
from repro.core import compression as JC
from repro.core import fedavg as JF
from repro.launch import sharding as JSH
from repro.models.api import build_model as j_build
from repro_torch.configs.common import SHAPES, get_arch
from repro_torch.core import compression as TC
from repro_torch.core import fedavg as TF
from repro_torch.core import wire as TW
from repro_torch.core.tree import tree_paths
from repro_torch.kernels.zsign import ops as TO
from repro_torch.launch import sharding as SH
from repro_torch.models.api import build_model, family_module

torch.set_num_threads(1)


class _M:
    axis_names = ("data", "model")
    shape = {"data": 16, "model": 16}


class _M2:
    axis_names = ("pod", "data", "model")
    shape = {"pod": 2, "data": 16, "model": 16}


MESHES = {"16x16": _M(), "pod2x16x16": _M2()}


def _jpaths(tree, is_leaf=None):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)
    return {tuple(str(getattr(k, "key", getattr(k, "idx", k))) for k in p):
            v for p, v in flat}


def _is_spec(x):
    return isinstance(x, jax.sharding.PartitionSpec)


@functools.lru_cache(maxsize=None)
def _jshapes(arch_id):
    return jax.eval_shape(j_build(j_arch(arch_id).model).init,
                          jax.random.PRNGKey(0))


def _plans(arch_id, mesh):
    jplan = JSH.make_plan(j_arch(arch_id), JSHAPES["train_4k"], mesh)
    tplan = SH.make_plan(get_arch(arch_id), SHAPES["train_4k"], mesh)
    return jplan, tplan


def _same(jspecs, tspecs):
    want = {p: tuple(s) for p, s in _jpaths(jspecs, _is_spec).items()}
    got = dict(tree_paths(tspecs))
    assert set(got) == set(want)
    for p in want:
        assert got[p] == want[p], (p, got[p], want[p])
    return len(want)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch_id", list_archs())
def test_param_specs_equal_the_reference(arch_id, mesh):
    m = MESHES[mesh]
    jplan, tplan = _plans(arch_id, m)
    assert dataclasses.asdict(tplan) == {
        k: (tuple(v) if isinstance(v, (list, tuple)) else v)
        for k, v in dataclasses.asdict(jplan).items()}
    ja, ta = j_arch(arch_id), get_arch(arch_id)
    jspecs = JSH.param_specs(_jshapes(arch_id), m, jplan,
                             moe_experts=ja.model.moe_experts)
    tspecs = SH.param_specs(family_module(ta.model).param_shapes(ta.model),
                            m, tplan, moe_experts=ta.model.moe_experts)
    n = _same(jspecs, tspecs)
    assert n >= 5


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch_id", list_archs())
def test_batch_and_state_specs_equal_the_reference(arch_id, mesh):
    m = MESHES[mesh]
    jplan, tplan = _plans(arch_id, m)
    ja = j_arch(arch_id)
    jb = j_build(ja.model)
    fcfg = JF.FedConfig(n_clients=jplan.n_clients,
                        client_groups=jplan.client_groups,
                        local_steps=jplan.local_steps)
    jbatch = JF.make_batch_spec(fcfg, jb.train_batch_spec(
        jplan.micro, JSHAPES["train_4k"].seq_len))
    tb = build_model(get_arch(arch_id).model)
    tbatch = {k: tuple(v.shape) for k, v in _jpaths(jbatch).items()}
    tbatch = {k[0]: v for k, v in tbatch.items()}
    # the port's per-step spec has the reference's leaves
    assert set(tb.train_batch_spec(jplan.micro, 4096)) == set(tbatch)
    _same(JSH.batch_specs(jbatch, jplan), SH.batch_specs(tbatch, tplan))
    d = 1_000_000
    jstate = {"ef": jax.ShapeDtypeStruct((jplan.client_groups,
                                          jplan.n_clients, d), jnp.float32)}
    tstate = {"ef": (tplan.client_groups, tplan.n_clients, d)}
    _same(JSH.wire_state_specs(jstate, jplan),
          SH.wire_state_specs(tstate, tplan))
    jserver = {"cv_server": jax.ShapeDtypeStruct((d,), jnp.float32)}
    _same(JSH.server_state_specs(jserver, jplan),
          SH.server_state_specs({"cv_server": (d,)}, tplan))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch_id", ["qwen2_0_5b", "qwen2_5_32b"])
def test_range_state_specs_hold_a_ranks_range(arch_id, mesh):
    """The model-sharded replica's state layout: a client slot's (G, N,
    d_pad) has its clients over the client axes and its coordinates over
    the replica axes, so a rank holds (G, 1, hi - lo) (its payload's
    range, ``wire.flat_ranges``); a server slot's (d_pad,) has its
    coordinates over the replica axes. The reference layout's bytes a
    rank are the replica's size times these."""
    m = MESHES[mesh]
    _, plan = _plans(arch_id, m)
    G, N = plan.client_groups, plan.n_clients
    R = SH.axis_size_tuple(plan.replica_axes)
    d_pad = 8192 * 512
    spec = SH.range_state_specs({"ef": (G, N, d_pad)}, plan)["ef"]
    assert spec == (None, SH._axes_entry(plan.client_axes),
                    SH._axes_entry(plan.replica_axes))
    lo, hi = TW.flat_ranges(d_pad, R)[0]
    assert SH.shard_shape((G, N, d_pad), spec, m) == (G, 1, hi - lo)
    ref = SH.wire_state_specs({"ef": (G, N, d_pad)}, plan)["ef"]
    assert SH.shard_shape((G, N, d_pad), ref, m) == (G, 1, R * (hi - lo))
    server = SH.range_server_specs({"cv_server": (d_pad,)}, plan)
    assert SH.shard_shape((d_pad,), server["cv_server"], m) == (hi - lo,)


@pytest.mark.parametrize("shape_name", ["decode_32k", "long_500k"])
@pytest.mark.parametrize("arch_id", list_archs())
def test_cache_specs_equal_the_reference(arch_id, shape_name):
    shape = JSHAPES[shape_name]
    m = MESHES["16x16"]
    jplan, tplan = _plans(arch_id, m)
    ja = j_arch(arch_id)
    jcache = jax.eval_shape(lambda: j_build(ja.model).init_cache(
        shape.global_batch, shape.seq_len))
    tcache = build_model(get_arch(arch_id).model).init_cache(
        shape.global_batch, shape.seq_len, device="meta")
    kw = dict(batch=shape.global_batch, seq_lens=(shape.seq_len, 2048))
    _same(JSH.cache_specs(jcache, jplan, **kw),
          SH.cache_specs(tcache, tplan, **kw))


def test_axis_size_tuple():
    for axes in [(), ("model",), ("data", "model"), ("pod", "data",
                                                     "model")]:
        assert SH.axis_size_tuple(axes) == JSH.axis_size_tuple(axes)


@pytest.mark.parametrize("z", ["inf", "1"])
def test_e1_over_a_range_is_the_byte_slice(z):
    """Coordinates [t0 * 8192, t1 * 8192) encoded with tile0 = t0 give the
    whole vector's bytes [t0 * 1024, t1 * 1024)."""
    d, n_tiles = 5 * 8192 + 1000, 6
    rng = np.random.default_rng(3)
    x = (rng.standard_normal(d) * 0.02).astype(np.float32)
    spec = f"zsign(z={z},sigma=0.02)"
    jz = JC.Pipeline(spec).codec.z
    tz = TC.Pipeline(spec).codec.z
    key = jax.random.fold_in(jax.random.PRNGKey(5), 3)
    want = np.asarray(JC.fused_sign_encode_jnp(jnp.asarray(x), key, 0.02,
                                               z=jz))
    keys = torch.from_numpy(np.asarray(key).astype(np.int64)[None])
    sig = torch.full((1,), 0.02)
    full = np.zeros((1, n_tiles * 8192), np.float32)
    full[0, :d] = x
    whole = TO.zsign_encode_plain(torch.from_numpy(full), keys, sig, tz)
    for t0, t1 in [(0, 2), (2, 5), (5, 6), (1, 6), (3, 4)]:
        rows = torch.from_numpy(full[:, t0 * 8192:t1 * 8192].copy())
        got = TO.zsign_encode_plain(rows, keys, sig, tz, tile0=t0)
        np.testing.assert_array_equal(got.numpy(),
                                      whole[:, t0 * 1024:t1 * 1024].numpy())
        ref = torch.from_numpy(want[None, t0 * 1024:t1 * 1024])
        if z == "inf":
            np.testing.assert_array_equal(got.numpy(), ref.numpy())
        else:
            _, far = TO.erf_rule_flips(rows, keys, sig, 1, got, ref,
                                       tile0=t0)
            assert far == 0
    # the range route of the codec is the same call
    rows = torch.from_numpy(full[:, 2 * 8192:5 * 8192].copy())
    comp = TC.Pipeline(spec)
    comp.check_range_encode()
    np.testing.assert_array_equal(
        comp.encode_range(keys, rows, 2).numpy(),
        whole[:, 2 * 1024:5 * 1024].numpy())


@pytest.mark.parametrize("shape,cuts", [
    pytest.param((3, 8, 12), ((2, 4),), id="shape0-2-4"),
    pytest.param((3, 8, 12), ((1, 2),), id="shape1-1-2"),
    pytest.param((16, 6), ((0, 4),), id="shape2-0-4"),
    pytest.param((5, 7), (), id="shape3-None-1"),
    pytest.param((2, 4, 6, 8), ((2, 3),), id="shape4-2-3"),
    # two cut dimensions: a stacked expert tensor (L, E, D, F) cut along E
    # and F, and one cut along its first and last dimension
    pytest.param((3, 4, 5, 6), ((1, 2), (3, 3)), id="experts-1x2-3x3"),
    pytest.param((4, 6, 8), ((0, 2), (2, 4)), id="first-last-2x4"),
    pytest.param((2, 4, 3, 2), ((1, 4), (3, 2)), id="experts-1x4-3x2")])
def test_leaf_shards_map_like_slicing(shape, cuts):
    numel = int(np.prod(shape))
    pos = np.arange(numel).reshape(shape)
    leaf = TW._LeafShards.of(0, shape, cuts)
    n = int(np.prod([c for _, c in cuts])) if cuts else 1
    for k in range(n):
        idx = [slice(None)] * len(shape)
        rem = k
        for dim, c in reversed(cuts):
            w = shape[dim] // c
            idx[dim] = slice(rem % c * w, (rem % c + 1) * w)
            rem //= c
        shard = pos[tuple(idx)].reshape(-1)
        np.testing.assert_array_equal(
            leaf.position(k, torch.arange(shard.size)).numpy(), shard)
        for x0, x1 in [(0, numel), (5, numel - 3), (7, 8), (0, 1),
                       (numel // 3, numel // 2)]:
            t0, t1 = leaf.count_before(k, x0), leaf.count_before(k, x1)
            inside = shard[(shard >= x0) & (shard < x1)]
            np.testing.assert_array_equal(shard[t0:t1], inside)
            mapped = []
            for t, nrows, width, p in leaf.blocks(k, t0, t1):
                for r in range(nrows):
                    mapped.extend(range(p + r * leaf.W,
                                        p + r * leaf.W + width))
            np.testing.assert_array_equal(np.array(mapped, int), inside)


@pytest.mark.parametrize("replica", [("data", "model"), ("model",)])
def test_range_layout_flat_coords_and_pieces(replica):
    """On every rank of a 2 x 2 grid: ``flat_coords`` of a rank's local
    shard elements are their flat positions under slicing, and the piece
    count of each exchange covers the most any rank sends or receives
    (counted here over every pair of ranks)."""
    from repro_torch.launch.mesh import ReplicaGrid
    leaves = [((16, 6), ((0, ("model",)),)), ((3, 8, 12), ((2, replica),)),
              ((5, 7), ()), ((2, 4, 8192), ((1, ("model",)),)),
              # an expert tensor (L, E, D, F): E over model, F over data
              ((2, 4, 6, 8), ((1, ("model",)), (3, ("data",))))]
    if replica == ("model",):
        leaves = leaves[:-1]
    shapes = tuple(s for s, _ in leaves)
    offsets = tuple(int(x) for x in np.cumsum(
        [0] + [int(np.prod(s)) for s in shapes[:-1]]))
    d = offsets[-1] + int(np.prod(shapes[-1]))
    spec = TW.TreeSpec(tuple(str(i) for i in range(len(leaves))), shapes,
                       offsets, d)
    lays = [TW.RangeLayout(spec, [dims for _, dims in leaves],
                           ReplicaGrid((2, 2), ("data", "model"), r, {}),
                           replica, tile=64) for r in range(4)]
    for r, lay in enumerate(lays):
        grid = ReplicaGrid((2, 2), ("data", "model"), r, {})
        for i, (shape, dims) in enumerate(leaves):
            pos = offsets[i] + np.arange(int(np.prod(shape))).reshape(shape)
            idx = [slice(None)] * len(shape)
            for dim, axes in dims:
                c = shape[dim] // 2 ** len(axes)
                k = grid.index(axes)
                idx[dim] = slice(k * c, (k + 1) * c)
            pos = pos[tuple(idx)]
            got = lay.flat_coords(i, torch.arange(pos.size))
            np.testing.assert_array_equal(got.numpy(), pos.reshape(-1))
    by_me = {lay.me: lay for lay in lays}
    for use, k in (("to_range", "_fwd"), ("from_range", "_bwd")):
        sent = {j: sum(t1 - t0 for segs in getattr(lay, k)[0]
                       for _, t0, t1 in segs) for j, lay in by_me.items()}
        got = {j: sum(t1 - t0 for segs in getattr(lay, k)[1]
                      for _, t0, t1 in segs) for j, lay in by_me.items()}
        most = max(max(sent.values()), max(got.values()))
        assert lays[0]._most(use == "to_range") >= most
        assert lays[0]._pieces[use] == max(
            1, -(-4 * lays[0]._most(use == "to_range")
                 // TW.REDUCE_CHUNK_BYTES))
        if use == "to_range":
            assert max(got.values()) == max(
                min(hi, d) - min(lo, d) for lo, hi in lays[0].ranges)


@pytest.mark.parametrize("d,parts", [(90_688, 4), (90_688, 2), (8192, 4),
                                     (494_032_768, 2), (1, 1)])
def test_flat_ranges_cut_whole_tiles(d, parts):
    ranges = TW.flat_ranges(d, parts)
    n_tiles = -(-d // 8192)
    assert ranges[0][0] == 0 and ranges[-1][1] == n_tiles * 8192
    for (lo, hi), (lo2, _) in zip(ranges, ranges[1:]):
        assert hi == lo2
    for lo, hi in ranges:
        assert lo % 8192 == 0 and (hi - lo) % 8192 == 0 and hi >= lo


def test_production_mesh_on_a_fake_group():
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.launch.mesh import make_production_mesh
    if dist.is_initialized():
        pytest.skip("a process group is up in this worker")
    dist.init_process_group("fake", store=FakeStore(), rank=37,
                            world_size=256)
    try:
        grid = make_production_mesh(device_type="cpu")
        assert grid.shape == {"data": 16, "model": 16}
        assert grid.coords == {"data": 2, "model": 5}
        assert grid.index(("model",)) == 5
        assert grid.index(("data", "model")) == 37
        assert dist.get_world_size(grid.group(("model",))) == 16
        assert dist.get_world_size(grid.group(("data", "model"))) == 256
        assert dist.get_rank(grid.group(("data",))) == 2
        plan = SH.make_plan(get_arch("qwen2_0_5b"), SHAPES["train_4k"], grid)
        assert plan.n_clients == 16 and plan.replica_axes == ("model",)
    finally:
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=300,
                            world_size=512)
    try:
        grid = make_production_mesh(multi_pod=True, device_type="cpu")
        assert grid.coords == {"pod": 1, "data": 2, "model": 12}
        assert dist.get_world_size(grid.group(("pod", "data"))) == 32
        plan = SH.make_plan(get_arch("qwen2_5_32b"), SHAPES["train_4k"],
                            grid)
        assert plan.client_axes == ("pod",) and plan.n_clients == 2
    finally:
        dist.destroy_process_group()


def test_a_grid_raises_for_the_wrong_world():
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.launch.mesh import make_replica_grid
    if dist.is_initialized():
        pytest.skip("a process group is up in this worker")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=6)
    try:
        with pytest.raises(ValueError, match="needs 4 ranks"):
            make_replica_grid((2, 2), ("data", "model"), device_type="cpu")
    finally:
        dist.destroy_process_group()


def test_sharded_step_refuses_a_mismatched_client_axis():
    """The plan's client count must be the client axes' rows."""
    class G:
        axis_names = ("data", "model")
        shape = {"data": 2, "model": 2}
    plan = SH.make_plan(get_arch("qwen2_0_5b"), SHAPES["train_4k"], G())
    with pytest.raises(ValueError, match="clients side by side"):
        TF.build_sharded_round_step(
            lambda p, b: 0.0, TC.Pipeline("zsign"), TF.FedConfig(n_clients=3),
            None, grid=G(), plan=plan, specs={})
