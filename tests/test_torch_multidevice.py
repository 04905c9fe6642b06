"""The port's multi-device cohort, ``stream(shard=K,devices=D)`` over a
``torch.distributed`` group, against the reference's plans.

Four gloo ranks on the CPU (a ``FileStore`` under ``tmp_path``, so xdist
workers never share a port) are spawned ONCE for the module
(``tests/torch_multidevice_ranks.py``) and run every scenario: at D = 4 over
the four ranks and at D = 2 on two pairs of ranks. The reference's
consensus problem (``tests/test_cohort_stream.py``: n = 16, d = 96,
``_MASK16``; numpy targets) runs in this process through the reference's
vmap plan, op by op, and holds each rank's result:

  * zsign_packed (shards of 3 and 8), ``ef|zsign(scale=none)``,
    ``agg=vote|trimmed|median``, ``byte_corrupt`` under
    ``stream(shard=2,devices=D)``, and with dyadic targets
    ``ef|topk(frac=0.25)``, ``topk(frac=0.25,agg=coord)`` (the (2, d)
    carry) and the dense f32 wire: params (and EF residuals) bit-identical
    over every round, on every rank;
  * ``ef|zsign`` (f32 scale weights), one round: residuals bit-identical to
    the port's one-process plan and params within rtol 5e-5, atol 1e-7 of
    the reference (its own tolerance, ``test_cohort_stream.py:382-384``);
  * an uneven cohort (10 clients in 5 shards over 2 ranks; at D = 4 the
    last rank walks padding only) and equal params on every rank;
  * the only cross-rank traffic of a round is one O(d) accumulator reduce
    and one scalar, pinned by recording every ``torch.distributed`` call
    with its bytes, as ``test_shard_map_only_collective_is_od_psum`` pins
    the jaxpr;
  * each rank holds O(ceil(total / D) * d) client-state bytes, its own
    rows only;
  * async rounds ignore ``devices=`` (every rank walks every shard and
    reduces nothing), as the reference's async rounds do;
  * a checkpoint saved at D (its rows gathered in pieces) resumes at D
    (each rank reading only its rows) and at D = 1, bit for bit;
  * the launcher, ``launch.train.run``, at 4 ranks equals its one-process
    run, prints on rank 0 only, and its checkpoint resumes in one process.

One subprocess runs the reference's own ``stream(shard=8,devices=2)``
shard_map under ``XLA_FLAGS=--xla_force_host_platform_device_count=2``
(jitted) on ``ef|zsign`` and holds the port's D = 2 params to it: they
agree within the stated tolerance and the largest gap is recorded in ulp.
"""
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import torch_multidevice_ranks as R
from repro.core import compression as JC
from repro.core import fedavg as JF
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core import fedavg as TF

torch.set_num_threads(1)

WORLD = 4
#: the scenarios that must be bit-identical to the reference's vmap plan
EXACT = ["zsign_s3", "zsign_s8", "ef_none", "topk", "vote", "trimmed",
         "median", "byte_corrupt", "uneven", "ckpt", "topk_coord", "dense"]
#: scenarios run by each pair at D = 2: pair p takes every other one
_NAMES = list(R.SCENARIOS)


def _ranks(name, devices):
    if devices == WORLD:
        return range(WORLD)
    p = _NAMES.index(name) % 2
    return range(2 * p, 2 * p + 2)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("ranks")
    mp.spawn(R.main, args=(WORLD, str(out / "store"), str(out)),
             nprocs=WORLD, join=True)
    res = []
    for r in range(WORLD):
        with open(out / f"rank{r}.pkl", "rb") as f:
            res.append(pickle.load(f))
    return res, out


def _i32(a):
    return np.asarray(a, np.float32).view(np.int32)


_REF = {}


def reference(name):
    """The reference's vmap plan on the scenario, op by op (cached) ->
    (params, residual rows (n, d) or None, last metrics)."""
    spec, _, _, n_rounds, opt = R.SCENARIOS[name]
    # scenarios that differ only in the port's plan share one run
    key = (spec, tuple(sorted((k, v) for k, v in opt.items()
                              if k != "ckpt_at")))
    if key in _REF:
        return _REF[key]
    n = opt.get("n", R.N)
    comp = JC.Pipeline(spec)
    cfg = JF.FedConfig(n_clients=n, client_lr=opt.get("glr", 0.01),
                       server_lr=opt.get("slr", 0.3))
    step = JF.build_round_step(
        lambda p, b: 0.5 * jnp.sum((p["x"] - b["y"]) ** 2), comp, cfg,
        JF.RoundContext(cohort="vmap", weights_are_mask=True,
                        adversary=opt.get("adversary", "none")))
    st = JF.init_server_state({"x": jnp.zeros(R.D_COORDS)}, cfg, comp,
                              jax.random.PRNGKey(1))
    y = jnp.asarray(R.targets(n, opt.get("integer_targets", False)))
    mask = jnp.asarray(R.mask_for(n))
    for _ in range(n_rounds):
        st, m = step(st, {"y": y}, mask)
    rows = (None if st.comp_state is None else
            np.asarray(st.comp_state["ef"]).reshape(n, -1))
    _REF[key] = (np.asarray(st.params["x"]), rows, m)
    return _REF[key]


def port_one(name, devices=1):
    """The port's own round in this process: the vmap plan (devices=0) or
    the one-process stream plan -> the final state and metrics."""
    cohort = "vmap" if devices == 0 else R.cohort(name, 1)
    step, st, _, _, batch, mask, n_rounds, _ = R.build(name, cohort)
    for _ in range(n_rounds):
        st, m = step(st, batch, mask)
    return st, m


def _state_rows(results, name, devices):
    """The residual rows of every rank of the run, stitched in rank order
    by each rank's owned rows -> (n, d)."""
    parts = []
    for r in _ranks(name, devices):
        out = results[r][(name, devices)]
        lo, hi = out["owned"]
        assert out["state"]["ef"].shape == (hi - lo, R.D_COORDS)
        parts.append(out["state"]["ef"])
    return np.concatenate(parts)


@pytest.mark.parametrize("devices", [2, 4])
@pytest.mark.parametrize("name", EXACT)
def test_bit_identical_to_reference_vmap(ranks, name, devices):
    results, _ = ranks
    want, want_rows, wm = reference(name)
    for r in _ranks(name, devices):
        out = results[r][(name, devices)]
        assert out["plan_devices"] == devices
        np.testing.assert_array_equal(_i32(out["params"]), _i32(want),
                                      err_msg=f"rank {r}")
        assert out["participation"] == float(wm.participation)
        assert out["losses"][-1] == pytest.approx(float(wm.loss), rel=1e-6)
    if want_rows is not None:
        np.testing.assert_array_equal(
            _i32(_state_rows(results, name, devices)), _i32(want_rows))


@pytest.mark.parametrize("devices", [2, 4])
def test_ef_scale_weights_one_round(ranks, devices):
    """f32 scale weights: residuals are per client, never summed across
    ranks, so they equal the port's one-process plan bit for bit; the
    params pass the cross-rank reduce in another association order than
    the one-process fold and are held to the reference's tolerance."""
    results, _ = ranks
    want, _, _ = reference("ef_1r")
    one, _ = port_one("ef_1r", devices=0)
    for r in _ranks("ef_1r", devices):
        np.testing.assert_allclose(results[r][("ef_1r", devices)]["params"],
                                   want, rtol=5e-5, atol=1e-7)
    np.testing.assert_array_equal(
        _i32(_state_rows(results, "ef_1r", devices)),
        _i32(one.comp_state["ef"].numpy().reshape(R.N, -1)))


@pytest.mark.parametrize("devices", [2, 4])
def test_only_cross_rank_traffic_is_one_od_reduce_and_a_scalar(ranks,
                                                               devices):
    """Per round and rank: send/recv only, of two sizes, the finalized
    accumulator (O(d): independent of the cohort) and the 4-byte loss,
    each in one chain (2 messages at its ends, 4 in its middle)."""
    results, _ = ranks
    for name in EXACT + ["ef_1r"]:
        for r in _ranks(name, devices):
            out = results[r][(name, devices)]
            end = r in (min(_ranks(name, devices)), max(_ranks(name,
                                                               devices)))
            for calls in out["calls"]:
                assert {c for c, _ in calls} == {"send", "recv"}, calls
                sizes = sorted({b for _, b in calls})
                assert len(sizes) == 2 and sizes[0] == 4, (name, sizes)
                acc = sizes[1]
                # the f32 sum of d_pad coordinates, the (2, d_pad) int32
                # vote pair or top-k's (d,) sum: never per-client data
                assert acc <= 2 * 4 * 8192, (name, acc)
                n_msgs = 2 if end else 4
                assert sorted(b for _, b in calls) == \
                    [4] * n_msgs + [acc] * n_msgs, (name, calls)
            st = out["reduce_stats"]
            assert st["calls"] == 2 * len(out["calls"])
            assert st["sent"] + st["received"] == \
                len(out["calls"]) * n_msgs * (acc + 4)


@pytest.mark.parametrize("devices", [2, 4])
def test_state_rows_stay_with_their_rank(ranks, devices):
    """Each rank holds the client-state rows of its own shard slice: at
    most ceil(n_shards / D) * shard rows, fewer than the cohort, and
    together exactly the cohort, each row once."""
    results, _ = ranks
    for name in ("ef_none", "topk", "uneven", "ef_1r", "ckpt"):
        spec, s2, s4, _, opt = R.SCENARIOS[name]
        total, shard = opt.get("n", R.N), (s2 if devices == 2 else s4)
        per = -(-(-(-total // shard)) // devices)
        spans = []
        for r in _ranks(name, devices):
            out = results[r][(name, devices)]
            lo, hi = out["owned"]
            assert out["state"]["ef"].nbytes == (hi - lo) * R.D_COORDS * 4
            assert hi - lo <= per * shard < total
            spans.append((lo, hi))
        assert spans[0][0] == 0 and spans[-1][1] == total
        assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    # uneven, D = 4: 5 shards of 2 pad to 8; the last rank walks padding
    if devices == 4:
        assert [results[r][("uneven", 4)]["owned"] for r in range(4)] == \
            [(0, 4), (4, 8), (8, 10), (10, 10)]


@pytest.mark.parametrize("devices", [2, 4])
def test_async_rounds_ignore_devices(ranks, devices):
    """An async round walks every shard on each rank whatever devices=
    says, holds every state row and reduces nothing: each rank equals the
    one-process async run."""
    results, _ = ranks
    one, m = port_one("async", devices=1)
    for r in _ranks("async", devices):
        out = results[r][("async", devices)]
        np.testing.assert_array_equal(_i32(out["params"]),
                                      _i32(one.params["x"].numpy()))
        assert out["participation"] == float(m.participation)
        assert all(calls == [] for calls in out["calls"])
        assert out["reduce_stats"]["calls"] == 0


@pytest.mark.parametrize("devices", [2, 4])
def test_checkpoint_at_d_resumes_at_one_device(ranks, devices):
    """The D-rank run saved after round 2 (rank 0 wrote the reference's
    (1, n, d) layout) and resumed at D (above: bit-identical to the
    reference); here the same checkpoint resumes in one process at D = 1
    and its 2 rounds give the straight run's params and residuals."""
    results, out_dir = ranks
    mgr = CheckpointManager(str(out_dir / f"ck-ckpt-{devices}"))
    step, st, _, _, batch, mask, rounds, at = R.build("ckpt",
                                                      R.cohort("ckpt", 1))
    r, tree = mgr.restore_latest(st._asdict())
    assert r == at == 2
    st = TF.ServerState(**tree)
    for _ in range(rounds - at):
        st, _ = step(st, batch, mask)
    want = results[0][("ckpt", devices)] if devices == 4 else \
        results[min(_ranks("ckpt", 2))][("ckpt", 2)]
    np.testing.assert_array_equal(_i32(st.params["x"].numpy()),
                                  _i32(want["params"]))
    np.testing.assert_array_equal(
        _i32(st.comp_state["ef"].numpy().reshape(R.N, -1)),
        _i32(_state_rows(results, "ckpt", devices)))


def test_read_rows_reads_a_span_in_pieces(tmp_path, monkeypatch):
    """A D-rank restore reads a rank's rows from the .npz member alone, in
    pieces of READ_CHUNK_BYTES: each span (empty, inside, at either end,
    the whole) equals that slice of the full array, for f32 rows and the
    2-byte words of bf16 rows; a span past the rows raises."""
    from repro_torch.checkpoint import manager
    monkeypatch.setattr(manager, "READ_CHUNK_BYTES", 40)
    rng = np.random.RandomState(0)
    arrays = {"comp_state/ef": rng.standard_normal((2, 5, 7)).astype(
                  np.float32),
              "comp_state/w": rng.randint(0, 1 << 16, (2, 5, 3)).astype(
                  np.uint16)}
    path = str(tmp_path / "arrays.npz")
    np.savez(path, **arrays)
    for key, arr in arrays.items():
        rows = arr.reshape((10,) + arr.shape[2:])
        for lo, hi in ((0, 0), (3, 7), (0, 1), (9, 10), (0, 10)):
            got = manager._read_rows(path, key, 2, (lo, hi))
            assert got.dtype == arr.dtype and got.flags.writeable
            np.testing.assert_array_equal(got, rows[lo:hi])
    with pytest.raises(ValueError, match="rows"):
        manager._read_rows(path, "comp_state/ef", 2, (4, 11))


def _train_one(argv):
    from repro_torch.core.tree import tree_leaves
    from repro_torch.launch import train
    states = []
    train.run(train.parse_args(argv),
              on_round=lambda t, b, a, m, s: states.append(a))
    return states[-1], tree_leaves(states[-1].params)


def test_launcher_at_four_ranks_and_its_checkpoint(ranks, tmp_path,
                                                   capsys):
    """``launch.train.run`` on 4 ranks (a reduced qwen2-0.5B, 8 EF clients
    with 0/1 weights in shards of 2): every rank ends with the params of
    the one-process stream(shard=2) run, bit for bit, and holds its own 2
    clients' residual rows; only rank 0 printed. Its checkpoint (written
    by rank 0 from every rank's rows) resumes in one process: a third
    round there equals a straight 3-round run."""
    results, out_dir = ranks
    r = R.TRAIN_ROUNDS
    one, leaves = _train_one(R.train_argv("stream(shard=2)", r,
                                          str(tmp_path / "a")))
    for k in range(WORLD):
        got = results[k]["train"]
        for a, b in zip(got["params"], leaves):
            np.testing.assert_array_equal(_i32(a), _i32(b.numpy()))
        np.testing.assert_array_equal(
            _i32(got["state"]),
            _i32(one.comp_state["ef"].numpy().reshape(8, -1)[2 * k:
                                                              2 * k + 2]))
        assert ("round,loss" in got["printed"]) == (k == 0)
        assert ("# checkpoint saved: round 2" in got["printed"]) == (k == 0)
    straight, s_leaves = _train_one(R.train_argv(
        "stream(shard=2)", r + 1, str(tmp_path / "b")))
    capsys.readouterr()
    resumed, r_leaves = _train_one(R.train_argv(
        "stream(shard=2)", r + 1, str(out_dir / "ck-train")))
    assert f"# resumed from checkpoint at round {r}" in \
        capsys.readouterr().out
    for a, b in zip(r_leaves, s_leaves):
        np.testing.assert_array_equal(_i32(a.numpy()), _i32(b.numpy()))
    np.testing.assert_array_equal(_i32(resumed.comp_state["ef"].numpy()),
                                  _i32(straight.comp_state["ef"].numpy()))


def test_make_cohort_group_one_rank(tmp_path):
    """One gloo rank joined through a FileStore: the default group; more
    devices than ranks raise the reference's ``make_cohort_mesh`` text,
    then how to start them; devices=auto resolves to the world."""
    import torch.distributed as dist
    from repro.launch.mesh import make_cohort_mesh
    from repro_torch.launch.mesh import make_cohort_group
    g = make_cohort_group(device_type="cpu", rank=0, world_size=1,
                          init_method=f"file://{tmp_path / 'store'}",
                          verbose=False)
    try:
        assert g is dist.group.WORLD and dist.get_backend() == "gloo"
        with pytest.raises(ValueError) as te:
            make_cohort_group(2, device_type="cpu")
        with pytest.raises(ValueError) as je:
            make_cohort_mesh(2)
        assert str(te.value).startswith(str(je.value) + " (start 2 ranks")
        assert TF.resolve_cohort("stream(shard=4,devices=auto)", 16, 96) \
            == TF.CohortPlan("stream", 4, 1, 1, "device")
    finally:
        dist.destroy_process_group()


def test_make_cohort_group_refuses_fewer_devices_than_ranks(ranks):
    """A cohort of 2 in a group of 4 ranks raises on every rank: each rank
    holds the rows of its own slice, so none may sit idle."""
    results, _ = ranks
    for r in range(WORLD):
        assert results[r]["fewer_devices"] == (
            "cohort mesh wants 2 devices but the group has 4 ranks (start "
            "2 ranks: python -m torch.distributed.run --nproc-per-node 2)")


def test_backend_follows_the_cards(monkeypatch):
    """nccl only when every rank of the host has a card of its own."""
    from repro_torch.launch.mesh import backend_for
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    assert backend_for(2, "cuda") == "nccl"
    assert backend_for(3, "cuda") == "gloo"        # two ranks share a card
    assert backend_for(2, "cpu") == "gloo"
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")      # 2 a host, 2 hosts
    assert backend_for(4, "cuda") == "nccl"


def test_resolve_needs_a_group_of_d_ranks():
    """Without a group the world is one rank: devices=2 raises the
    reference's text with how to start D ranks; devices=auto is 1."""
    with pytest.raises(ValueError, match=r"wants devices=2 but only 1 are "
                       r"visible \(start D ranks"):
        TF.resolve_cohort("stream(shard=4,devices=2)", 16, 96)
    assert TF.resolve_cohort("stream(shard=4,devices=auto)", 16, 96) == \
        TF.CohortPlan("stream", 4, 1, 1, "device")


_REF_SHARD_MAP = """
import sys
import jax, jax.numpy as jnp, numpy as np
sys.path.insert(0, sys.argv[2])
import torch_multidevice_ranks as R
from repro.core import compression as C, fedavg
from repro.core.context import RoundContext
assert jax.device_count() == 2
comp = C.Pipeline("ef|zsign")
cfg = fedavg.FedConfig(n_clients=16, client_lr=0.01, server_lr=0.3)
step = jax.jit(fedavg.build_round_step(
    lambda p, b: 0.5 * jnp.sum((p["x"] - b["y"]) ** 2), comp, cfg,
    RoundContext(cohort="stream(shard=8,devices=2)")))
st = fedavg.init_server_state({"x": jnp.zeros(96)}, cfg, comp,
                              jax.random.PRNGKey(1))
st, m = step(st, {"y": jnp.asarray(R.targets(16, False))},
             jnp.asarray(R.mask_for(16)))
np.save(sys.argv[1], np.asarray(st.params["x"]))
"""


def test_reference_shard_map_d2_against_port_d2(ranks, tmp_path):
    """The reference's own stream(shard=8,devices=2) shard_map (jitted,
    two host devices) on ef|zsign, one round, against the port's D = 2
    ranks: within rtol 5e-5 / atol 1e-7; the largest gap is recorded in
    ulp (the jit folds constants, the port follows the op order)."""
    results, _ = ranks
    out = tmp_path / "ref.npy"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2")
    here = os.path.dirname(os.path.abspath(__file__))
    subprocess.run([sys.executable, "-c", _REF_SHARD_MAP, str(out), here],
                   env=env, check=True, timeout=300)
    want = np.load(out)
    ulp = []
    for r in _ranks("ef_1r", 2):
        got = results[r][("ef_1r", 2)]["params"]
        np.testing.assert_allclose(got, want, rtol=5e-5, atol=1e-7)
        ulp.append(int(np.max(np.abs(_i32(got).astype(np.int64)
                                     - _i32(want).astype(np.int64)))))
    print(f"port D=2 vs reference shard_map D=2: max {max(ulp)} ulp")
    assert ulp[0] == ulp[1]
