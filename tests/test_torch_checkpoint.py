"""The port's checkpoints (``repro_torch.checkpoint.manager``) against the
reference's ``tests/test_checkpoint.py`` and across the two packages.

Each test of the reference's file (round trip, retention, the fallback past
a corrupt checkpoint, the restart replay) is held in the port; the replay
is BIT-IDENTICAL here, not the reference's rtol 1e-6. A checkpoint one
package writes restores in the other: the reference's f32 consensus state
with ef and cv slots (then the rounds that follow are bit-identical, as
``tests/torch_consensus.py`` holds the consensus rounds), and the port's
in the reference's manager. bf16 leaves round-trip bit for bit in the port,
which also reads the reference's numpy ``V2`` bf16 payload; the reference's
own restore of that payload returns ``(None, None)``.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_consensus as tc
from repro.checkpoint.manager import CheckpointManager as JManager
from repro.core import compression as JC
from repro.core import fedavg as JF
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core import compression as TC
from repro_torch.core import fedavg as TF
from repro_torch.core import noise as TN
from repro_torch.core.tree import tree_leaves, tree_paths
from repro_torch.launch import train as TT

torch.set_num_threads(1)


def small_state():
    return {"params": {"w": torch.arange(6.0).reshape(2, 3)},
            "opt": {"m": torch.ones(3)},
            "round": 7}


def _bits(x):
    if isinstance(x, torch.Tensor):
        iv = {1: torch.uint8, 2: torch.int16, 4: torch.int32,
              8: torch.int64}[x.element_size()]
        return x.view(iv).numpy()
    return x


def assert_trees_bit_equal(a, b):
    pa, pb = tree_paths(a), tree_paths(b)
    assert [p for p, _ in pa] == [p for p, _ in pb]
    for (p, x), (_, y) in zip(pa, pb):
        assert type(x) is type(y), p
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and x.device == y.device, p
            np.testing.assert_array_equal(_bits(x), _bits(y), err_msg=str(p))
        else:
            assert x == y, p


def test_save_restore_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    st = small_state()
    mgr.save(7, st)
    r, got = mgr.restore_latest(small_state())
    assert r == 7
    assert_trees_bit_equal(got, st)
    assert mgr.last_save["bytes"] > 0 and mgr.last_restore["round"] == 7


def test_retention_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for r in range(5):
        mgr.save(r, small_state())
    assert sorted(os.listdir(tmp_path)) == ["ckpt-00000003", "ckpt-00000004"]


def test_corrupt_checkpoint_falls_back(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=5)
    mgr.save(1, small_state())
    mgr.save(2, small_state())
    path = os.path.join(tmp_path, "ckpt-00000002", "arrays.npz")
    with open(path, "r+b") as f:
        f.seek(10)
        f.write(b"\xde\xad\xbe\xef")
    r, got = mgr.restore_latest(small_state())
    assert r == 1 and got is not None
    assert mgr.skipped and "digest" in mgr.skipped[0][1]


def test_template_mismatch_falls_back(tmp_path):
    """A checkpoint that does not fit the template (a missing key, another
    shape) is walked past like a corrupt one; none that fits -> (None,
    None)."""
    mgr = CheckpointManager(str(tmp_path), keep=5)
    mgr.save(1, small_state())
    other = small_state()
    other["params"]["w"] = torch.zeros(3, 2)
    mgr.save(2, other)
    r, _ = mgr.restore_latest(small_state())
    assert r == 1
    extra = dict(small_state(), more=torch.zeros(1))
    assert mgr.restore_latest(extra) == (None, None)


def _consensus_step(spec, n=4):
    comp = TC.Pipeline(spec)
    cfg = TF.FedConfig(n_clients=n, client_lr=0.05, server_lr=0.1)
    step = TF.build_round_step(
        lambda p, b: 0.5 * torch.sum((p["x"] - b["y"]) ** 2), comp, cfg)
    return comp, cfg, step


def test_restart_replays_identically(tmp_path):
    """Kill-and-restart gives the uninterrupted run's trajectory bit for
    bit: the rng words, the round and the sigma are in the state, the data
    is deterministic."""
    comp, cfg, step = _consensus_step("zsign(z=1,sigma=0.5)")
    y = torch.from_numpy(np.array(
        jax.random.normal(jax.random.PRNGKey(5), (1, 4, 1, 16))))
    mask = torch.ones((1, 4))

    def fresh():
        return TF.init_server_state({"x": torch.zeros(16)}, cfg, comp,
                                    TN.prng_key(9))

    st = fresh()
    for _ in range(10):
        st, _ = step(st, {"y": y}, mask)
    ref = st
    mgr = CheckpointManager(str(tmp_path))
    st = fresh()
    for _ in range(6):
        st, _ = step(st, {"y": y}, mask)
    mgr.save(6, st._asdict())
    del st
    r, got = mgr.restore_latest(fresh()._asdict())
    st = TF.ServerState(**got)
    assert r == 6 and st.round == 6 and isinstance(st.round, int)
    for _ in range(4):
        st, _ = step(st, {"y": y}, mask)
    assert_trees_bit_equal(st._asdict(), ref._asdict())


@pytest.mark.parametrize("opt", ["sgd", "momentum", "adam"])
def test_server_state_keys_and_dtypes_are_the_references(tmp_path, opt):
    """The port's ServerState saves under the reference's flattened keys
    and dtypes (rng uint32 (2,), round int32 0-d, sigma f32, the optimizer
    trees, Adam's t int32, every comp_state and comp_server slot), and
    restores with Adam's Python-int step count."""
    spec = "cv|ef|zsign"
    params = {"a": jnp.zeros(5), "b": {"c": jnp.zeros(3)}}
    jcfg = JF.FedConfig(n_clients=3, server_opt=opt)
    jst = JF.init_server_state(params, jcfg, JC.Pipeline(spec),
                               jax.random.PRNGKey(1))
    JManager(str(tmp_path / "ref")).save(0, jst._asdict())
    tcfg = TF.FedConfig(n_clients=3, server_opt=opt)
    tst = TF.init_server_state({"a": torch.zeros(5),
                                "b": {"c": torch.zeros(3)}}, tcfg,
                               TC.Pipeline(spec), TN.prng_key(1))
    if opt == "adam":
        tst.opt_state["t"] = 3
    mgr = CheckpointManager(str(tmp_path / "port"))
    mgr.save(0, tst._asdict())
    jz = np.load(tmp_path / "ref" / "ckpt-00000000" / "arrays.npz")
    tz = np.load(tmp_path / "port" / "ckpt-00000000" / "arrays.npz")
    assert sorted(jz.files) == sorted(tz.files)
    for k in jz.files:
        assert (jz[k].dtype, jz[k].shape) == (tz[k].dtype, tz[k].shape), k
    np.testing.assert_array_equal(tz["rng"], np.asarray(jst.rng))
    _, got = mgr.restore_latest(tst._asdict())
    assert_trees_bit_equal(got, tst._asdict())


def _assert_restored_equal(tst, jst):
    """Every leaf of the port's restored state bit-equal to the
    reference's state it was saved from."""
    np.testing.assert_array_equal(tc.i32(tc.flat_params(tst, True)),
                                  tc.i32(tc.flat_params(jst, False)))
    tc.assert_state_equal(jst, tst)
    assert (jst.comp_server is None) == (tst.comp_server is None)
    for k, v in (jst.comp_server or {}).items():
        np.testing.assert_array_equal(tc.i32(tst.comp_server[k].numpy()),
                                      tc.i32(np.asarray(v)), err_msg=k)
    assert tst.round == int(jst.round) and isinstance(tst.round, int)
    assert tst.rng.dtype == torch.int64
    np.testing.assert_array_equal(tst.rng.numpy(), np.asarray(jst.rng))
    assert tc.i32(tst.sigma.numpy()) == tc.i32(np.asarray(jst.sigma))


@pytest.mark.parametrize("spec", ["cv|zsign_packed(z=1,sigma=0.01)",
                                  "cv|ef|zsign", "ef|zsign_packed"])
def test_reference_checkpoint_restores_into_port(tmp_path, spec):
    """The reference runs 4 consensus rounds op by op and saves with its
    own manager; the port restores that file into its own ServerState,
    every leaf bit-equal to the reference's (params, ef/cv rows, the
    server variate, rng, round, sigma), and both run 4 more rounds. The
    rounds that follow are held as the consensus tests hold them:
    bit-identical without EF; with EF, params within 1e-7 and residuals
    within 1e-6 of their largest entry (the EF scale's mean reduces in
    another order in each framework, ROADMAP queue 3)."""
    ys = tc.targets()
    comp_j, comp_t = JC.Pipeline(spec), TC.Pipeline(spec)
    jcfg, tcfg = tc._cfg(JF, 1, 1, 2.0), tc._cfg(TF, 1, 1, 2.0)
    jstep = JF.build_round_step(tc._jloss, comp_j, jcfg, JF.RoundContext(
        cohort="vmap", weights_are_mask=True))
    tstep = TF.build_round_step(tc._tloss, comp_t, tcfg, TF.RoundContext(
        cohort="vmap", weights_are_mask=True))
    jst = JF.init_server_state({k: jnp.zeros(s) for k, s in tc.LEAVES},
                               jcfg, comp_j, jax.random.PRNGKey(1))
    for _ in range(4):
        jst, _ = jstep(jst, {"y": jnp.asarray(ys)}, jnp.asarray(tc.MASK))
    JManager(str(tmp_path)).save(4, jst._asdict())
    template = TF.init_server_state({k: torch.zeros(s) for k, s in tc.LEAVES},
                                    tcfg, comp_t, TN.prng_key(1))
    r, got = CheckpointManager(str(tmp_path)).restore_latest(
        template._asdict())
    assert r == 4
    tst = TF.ServerState(**got)
    _assert_restored_equal(tst, jst)
    for _ in range(4):
        jst, _ = jstep(jst, {"y": jnp.asarray(ys)}, jnp.asarray(tc.MASK))
        tst, _ = tstep(tst, {"y": torch.from_numpy(ys)}, tc.MASK)
    assert tst.round == int(jst.round) == 8
    np.testing.assert_array_equal(tst.rng.numpy(), np.asarray(jst.rng))
    if "ef" not in spec.split("|"):
        np.testing.assert_array_equal(tc.i32(tc.flat_params(tst, True)),
                                      tc.i32(tc.flat_params(jst, False)))
        tc.assert_state_equal(jst, tst)
        return
    np.testing.assert_allclose(tc.flat_params(tst, True),
                               tc.flat_params(jst, False), rtol=0, atol=1e-7)
    e_ref = np.asarray(jst.comp_state["ef"])
    np.testing.assert_allclose(tst.comp_state["ef"].numpy(), e_ref, rtol=0,
                               atol=1e-6 * np.abs(e_ref).max())


def test_reference_restores_port_checkpoint(tmp_path):
    """An f32 checkpoint the port wrote (4 rounds of cv|ef|zsign) restores
    in the reference's manager into the reference's ServerState, every leaf
    bit-equal to the port's."""
    spec = "cv|ef|zsign"
    tst, _ = tc.port(spec, tc.targets(), rounds=4)
    CheckpointManager(str(tmp_path)).save(4, tst._asdict())
    comp = JC.Pipeline(spec)
    template = JF.init_server_state({k: jnp.zeros(s) for k, s in tc.LEAVES},
                                    tc._cfg(JF, 1, 1, 2.0), comp,
                                    jax.random.PRNGKey(1))
    r, got = JManager(str(tmp_path)).restore_latest(template._asdict())
    assert r == 4
    jst = JF.ServerState(**got)
    _assert_restored_equal(tst, jst)
    assert jst.round.dtype == jnp.int32 and jst.rng.dtype == jnp.uint32


def _bf16_words(seed, shape):
    """Random bf16 words (finite, both signs, subnormals) as uint16."""
    w = np.random.RandomState(seed).randint(0, 1 << 16, shape)
    w = w.astype(np.uint16)
    exp = (w >> 7) & 0xFF
    return np.where(exp == 0xFF, w & 0x807F, w).astype(np.uint16)


def test_bf16_roundtrip_bit_for_bit(tmp_path):
    words = _bf16_words(0, (4, 33))
    w = torch.from_numpy(words.view(np.int16)).view(torch.bfloat16)
    tree = {"w": w, "f": torch.randn(3), "k": TN.prng_key(3), "r": 2}
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, tree)
    meta = open(tmp_path / "ckpt-00000001" / "meta.json").read()
    assert '"w": "bfloat16"' in meta
    with np.load(tmp_path / "ckpt-00000001" / "arrays.npz") as z:
        assert z["w"].dtype == np.uint16 and z["k"].dtype == np.uint32
        np.testing.assert_array_equal(z["w"], words)
    _, got = mgr.restore_latest({"w": torch.zeros(4, 33, dtype=torch.bfloat16),
                                 "f": torch.zeros(3),
                                 "k": torch.zeros(2, dtype=torch.int64),
                                 "r": 0})
    assert_trees_bit_equal(got, tree)


def _reference_bf16_payload(tmp_path):
    words = _bf16_words(1, (5, 7))
    w = jnp.asarray(words.view(jnp.bfloat16))
    JManager(str(tmp_path)).save(3, {"w": w, "r": jnp.asarray(9, jnp.int32),
                                     "k": jax.random.PRNGKey(4)})
    return words


def test_port_reads_reference_bf16_payload(tmp_path):
    words = _reference_bf16_payload(tmp_path)
    with np.load(tmp_path / "ckpt-00000003" / "arrays.npz") as z:
        assert z["w"].dtype.kind == "V" and z["w"].dtype.itemsize == 2
    r, got = CheckpointManager(str(tmp_path)).restore_latest(
        {"w": torch.zeros(5, 7, dtype=torch.bfloat16), "r": 0,
         "k": torch.zeros(2, dtype=torch.int64)})
    assert r == 3 and got["r"] == 9
    np.testing.assert_array_equal(got["w"].view(torch.int16).numpy()
                                  .view(np.uint16), words)
    np.testing.assert_array_equal(got["k"].numpy(),
                                  np.asarray(jax.random.PRNGKey(4)))


def test_reference_cannot_restore_its_bf16(tmp_path):
    """The reference's fault the port's bf16 storage answers: its manager
    writes a bf16 leaf as numpy void V2, and its own restore_latest then
    fails inside its try, skips the checkpoint and returns (None, None)."""
    _reference_bf16_payload(tmp_path)
    template = {"w": jnp.zeros((5, 7), jnp.bfloat16),
                "r": jnp.asarray(0, jnp.int32), "k": jax.random.PRNGKey(0)}
    assert JManager(str(tmp_path)).restore_latest(template) == (None, None)


def test_host_fed_rows_restore_to_host(tmp_path):
    """A stream(feed=host) state keeps its client rows in host memory
    (pinned when the params lie on a card); restored, the rows land where
    the template's are, with the template's dtype."""
    comp = TC.Pipeline("ef|zsign")
    cfg = TF.FedConfig(n_clients=4, client_lr=0.05, server_lr=0.1)
    params = {"x": torch.zeros(40)}
    st = TF.init_server_state(params, cfg, comp, TN.prng_key(2),
                              host_state=True)
    st.comp_state["ef"].copy_(torch.randn(1, 4, st.comp_state["ef"].shape[-1]))
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, st._asdict())
    tmpl = TF.init_server_state(params, cfg, comp, TN.prng_key(2),
                                host_state=True)
    _, got = mgr.restore_latest(tmpl._asdict())
    rows = got["comp_state"]["ef"]
    assert rows.device.type == "cpu"
    assert rows.is_pinned() == tmpl.comp_state["ef"].is_pinned()
    assert_trees_bit_equal(got, st._asdict())


def _args(tmp, rounds, **kw):
    argv = ["--arch", "qwen2_0_5b", "--reduced", "--rounds", str(rounds),
            "--clients", "3", "--local-steps", "1", "--seq-len", "16",
            "--pipeline", "ef|zsign", "--device", "cpu"]
    if tmp is not None:
        argv += ["--ckpt-dir", str(tmp), "--save-every", "2"]
    return TT.parse_args(argv)


def test_train_run_resumes_bit_identically(tmp_path, capsys):
    """launch.train.run with --ckpt-dir --save-every 2: 4 rounds, then a
    rerun to 6 prints the resume line and runs rounds 4 and 5; its params
    and EF rows equal an uninterrupted 6-round run's bit for bit
    (participation 1.0, no Plateau)."""
    finals = {}

    def keep(tag):
        def on_round(t, before, after, m, sec):
            finals[tag] = (t, after)
        return on_round

    TT.run(_args(None, 6), on_round=keep("straight"))
    h1 = TT.run(_args(tmp_path, 4), on_round=keep("first"))
    events = []
    h2 = TT.run(_args(tmp_path, 6), on_round=keep("resumed"),
                on_ckpt=lambda e, s: events.append((e, s["round"])))
    out = capsys.readouterr().out
    assert "# resumed from checkpoint at round 4" in out
    assert len(h1) == 4 and len(h2) == 2
    assert events == [("restore", 4), ("save", 6)]
    assert sorted(os.listdir(tmp_path)) == [
        "ckpt-00000002", "ckpt-00000004", "ckpt-00000006"]
    t, straight = finals["straight"]
    t2, resumed = finals["resumed"]
    assert t == t2 == 5
    assert_trees_bit_equal(resumed.params, straight.params)
    assert_trees_bit_equal(resumed.comp_state, straight.comp_state)
    assert resumed.round == straight.round == 6
