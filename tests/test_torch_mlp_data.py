"""The port's MLP task and synthetic data against the reference
(repro.models.mlp, repro.data.synthetic).

(a) ``mlp_loss_builder``: logits, loss and gradients on the reference's
    params and batches, within f32 matmul tolerance (the two frameworks
    order the dot products differently).
(b) The MLP round's wire: the reference's client pseudo-gradients of the
    non-iid task, encoded by both packages from the same buffers and keys,
    give identical payload bytes for ``zsign``, ``zsign(z=1,sigma=2.0)``
    and ``ef|zsign`` (the EF scale within 2 ulp, its residual rows to
    1e-6); and one whole MLP round of both packages.
(c) The four synthetic-data functions equal the reference's arrays (both
    draw from numpy RandomStates), and the Dirichlet partition keeps the
    laws of tests/test_synthetic_data.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compression as JC
from repro.core import fedavg as JF
from repro.core import noise as JN
from repro.core import wire as JW
from repro.data import synthetic as JS
from repro.models import mlp as JM
from repro_torch.core import compression as TC
from repro_torch.core import fedavg as TF
from repro_torch.core import noise as TN
from repro_torch.data import synthetic as TS
from repro_torch.models import mlp as TM

torch.set_num_threads(1)

N, DIM, CLASSES = 10, 64, 10


def _i32(a):
    return np.asarray(a).view(np.int32)


def _task():
    x, y = JS.gaussian_mixture_task(n_classes=CLASSES, dim=DIM,
                                    n_per_class=40)
    parts = JS.label_partition(y, N)
    batch = JS.client_batches(x, y, parts, (1, N, 1, 32), seed=1,
                              round_idx=0)
    jinit, jloss, _ = JM.mlp_loss_builder(DIM, CLASSES)
    jparams = jinit(jax.random.PRNGKey(0))
    return x, y, batch, jloss, jparams


# ---------------------------------------------------------------------------
# (a) the model
# ---------------------------------------------------------------------------

def test_mlp_loss_and_grads_match_reference():
    x, y, batch, jloss, jparams = _task()
    _, tloss, tacc = TM.mlp_loss_builder(DIM, CLASSES)
    tparams = TM.params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    for c in range(3):
        jb = {"x": batch["x"][0, c, 0], "y": batch["y"][0, c, 0]}
        tb = {"x": torch.from_numpy(np.array(jb["x"])),
              "y": torch.from_numpy(np.array(jb["y"]))}
        jl, jg = jax.value_and_grad(jloss)(jparams, jb)
        p = {k: v.clone().requires_grad_(True) for k, v in tparams.items()}
        tl = tloss(p, tb)
        tg = dict(zip(p, torch.autograd.grad(tl, list(p.values()))))
        np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=2e-6)
        for k in p:
            ref = np.asarray(jg[k])
            np.testing.assert_allclose(tg[k].numpy(), ref, rtol=0,
                                       atol=2e-6 * max(np.abs(ref).max(),
                                                       1e-3))
    _, _, jacc = JM.mlp_loss_builder(DIM, CLASSES)
    assert tacc(tparams, torch.from_numpy(np.array(x)),
                torch.from_numpy(np.array(y))) == jacc(jparams, x, y)


def test_mlp_init_law():
    init, _, _ = TM.mlp_loss_builder(DIM, CLASSES, width=32)
    a = init(torch.Generator().manual_seed(0), "cpu")
    b = init(torch.Generator().manual_seed(0), "cpu")
    shapes = {k: tuple(v.shape) for k, v in
              JM.mlp_loss_builder(DIM, CLASSES, width=32)[0](
                  jax.random.PRNGKey(0)).items()}
    assert {k: tuple(v.shape) for k, v in a.items()} == shapes
    for k in a:
        assert torch.equal(a[k], b[k]) and a[k].dtype == torch.float32
    assert not torch.any(a["b1"]) and not torch.any(a["b3"])
    # N(0, 1 / fan_in): w1's 64 x 32 draws have std ~ 1/8
    assert 0.1 < float(a["w1"].std()) < 0.15


# ---------------------------------------------------------------------------
# (b) the MLP round's wire
# ---------------------------------------------------------------------------

def _reference_rows(jloss, jparams, batch):
    spec = JW.tree_spec(jparams)
    grad = jax.grad(jloss)
    return spec, np.stack([np.asarray(spec.flatten(grad(
        jparams, {"x": batch["x"][0, c, 0], "y": batch["y"][0, c, 0]})))
        for c in range(N)])


@pytest.mark.parametrize("pipe", ["zsign", "zsign(z=1,sigma=2.0)",
                                  "ef|zsign"])
def test_mlp_wire_bytes_from_reference_buffers(pipe):
    _, _, batch, jloss, jparams = _task()
    spec, rows = _reference_rows(jloss, jparams, batch)
    d = spec.n_coords
    jcomp, tcomp = JC.Pipeline(pipe), TC.Pipeline(pipe)
    sub = jax.random.split(jax.random.PRNGKey(1))[1]
    jkeys = JN.client_keys(sub, 0, N)
    tkeys = TN.client_keys(TN.split(TN.prng_key(1))[1], 0, N)
    np.testing.assert_array_equal(tkeys.numpy(), np.asarray(jkeys))
    # the reference's vmapped client encode over stacked state
    jstate = jcomp.init_state(d)
    if jstate is not None:
        jstate = jax.tree.map(lambda v: jnp.zeros((N,) + v.shape, v.dtype),
                              jstate)
    jenc, jnew = jax.vmap(lambda k, f, s: jcomp.encode(k, f, s))(
        jkeys, jnp.asarray(rows), jstate)
    mult = tcomp.pad_multiple()
    d_pad = -(-d // mult) * mult
    buf = torch.from_numpy(np.pad(rows, ((0, 0), (0, d_pad - d))))
    tstate = tcomp.init_state(d, lead=(N,))
    tenc, tnew = tcomp.encode_batch(tkeys, buf, d, tstate,
                                    torch.ones(N))
    if isinstance(jenc, dict):
        # the reference's EF wire is ceil(d/8) bytes; the port's runs to
        # the encode tile, its zero padding packed as +1 bits (255), as
        # the reference's pack_flat packs the pad of its last byte
        want = np.asarray(jenc["packed"])
        got = tenc["packed"].numpy()
        np.testing.assert_array_equal(got[:, :want.shape[1]], want)
        assert np.all(got[:, want.shape[1]:] == 255)
        np.testing.assert_allclose(tenc["scale"].numpy(),
                                   np.asarray(jenc["scale"]), rtol=2.5e-7)
        e_ref = np.asarray(jnew["ef"])
        np.testing.assert_allclose(tnew["ef"].numpy(), e_ref, rtol=0,
                                   atol=1e-6 * np.abs(e_ref).max())
    else:
        np.testing.assert_array_equal(tenc.numpy(), np.asarray(jenc))


@pytest.mark.parametrize("pipe,slr", [("zsign(z=1,sigma=0.05)", 0.5),
                                      ("ef|zsign", 1.0)])
def test_mlp_round_matches_reference(pipe, slr):
    """Two rounds of the non-iid MLP task (8 of 10 clients live) in both
    packages from the reference's params: the gradients differ by f32
    matmul order only, so at most a handful of signs flip and the params
    agree to one sign step on those coordinates."""
    x, y, _, jloss, jparams = _task()
    parts = JS.label_partition(y, N)
    _, tloss, _ = TM.mlp_loss_builder(DIM, CLASSES)
    kw = dict(n_clients=N, client_lr=0.05, server_lr=slr)
    jcomp, tcomp = JC.Pipeline(pipe), TC.Pipeline(pipe)
    jcfg, tcfg = JF.FedConfig(**kw), TF.FedConfig(**kw)
    jstep = JF.build_round_step(jloss, jcomp, jcfg)
    tstep = TF.build_round_step(tloss, tcomp, tcfg)
    js = JF.init_server_state(jparams, jcfg, jcomp, jax.random.PRNGKey(1))
    ts = TF.init_server_state(
        TM.params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu"), tcfg,
        tcomp,
        TN.prng_key(1))
    mask = np.ones((1, N), np.float32)
    mask[0, [2, 5]] = 0.0
    tx, ty = TS.gaussian_mixture_task(n_classes=CLASSES, dim=DIM,
                                      n_per_class=40)
    tparts = TS.label_partition(ty, N)
    for t in range(2):
        jb = JS.client_batches(x, y, parts, (1, N, 1, 32), seed=1,
                               round_idx=t)
        tb = TS.client_batches(tx, ty, tparts, (1, N, 1, 32), seed=1,
                               round_idx=t)
        js, jm = jstep(js, jb, jnp.asarray(mask))
        ts, tm = tstep(ts, tb, mask)
    step = 0.05 * slr
    diffs = 0
    for k in jparams:
        a, b = ts.params[k].numpy(), np.asarray(js.params[k])
        far = np.abs(a - b) > 1e-5
        diffs += int(far.sum())
        assert np.all(np.abs(a - b)[far] < 3 * step * 2 + 1e-5)
    assert diffs <= 10, diffs
    assert float(tm.participation) == float(jm.participation) == 8.0
    assert float(tm.uplink_bits) == float(jm.uplink_bits)
    np.testing.assert_allclose(float(tm.loss), float(jm.loss), rtol=1e-5)


# ---------------------------------------------------------------------------
# (c) synthetic data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(), dict(n_classes=4, dim=8,
                                             n_per_class=30, seed=3)])
def test_synthetic_arrays_equal_reference(kw):
    jx, jy = JS.gaussian_mixture_task(**kw)
    tx, ty = TS.gaussian_mixture_task(**kw)
    assert tx.dtype == torch.float32 and ty.dtype == torch.int32
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
    n_classes = kw.get("n_classes", 10)
    for n in (2, n_classes):
        for a, b in zip(TS.label_partition(ty, n),
                        JS.label_partition(jy, n)):
            np.testing.assert_array_equal(a, b)
    for alpha, n, seed in [(0.1, 7, 0), (1.0, 10, 2), (100.0, 3, 5)]:
        tp = TS.dirichlet_partition(ty, n, alpha=alpha, seed=seed)
        jp = JS.dirichlet_partition(jy, n, alpha=alpha, seed=seed)
        assert len(tp) == len(jp) == n
        for a, b in zip(tp, jp):
            np.testing.assert_array_equal(a, b)
        for layout, r in [((1, n, 2, 4), 0), ((2, 3, 1, 5), 7)]:
            if any(p.size == 0 for p in tp):
                # an empty part: both refuse to sample it
                with pytest.raises(ValueError):
                    JS.client_batches(jx, jy, jp, layout, seed, r)
                with pytest.raises(ValueError):
                    TS.client_batches(tx, ty, tp, layout, seed, r)
                continue
            tb = TS.client_batches(tx, ty, tp, layout, seed=seed,
                                   round_idx=r)
            jb = JS.client_batches(jx, jy, jp, layout, seed=seed,
                                   round_idx=r)
            assert tb["y"].dtype == torch.int32
            np.testing.assert_array_equal(tb["x"].numpy(),
                                          np.asarray(jb["x"]))
            np.testing.assert_array_equal(tb["y"].numpy(),
                                          np.asarray(jb["y"]))


def _labels(n_classes=10, per=400, seed=3):
    rng = np.random.RandomState(seed)
    return rng.permutation(np.repeat(np.arange(n_classes), per))


def test_dirichlet_partition_deterministic():
    y = _labels()
    a = TS.dirichlet_partition(y, 8, alpha=0.3, seed=11)
    b = TS.dirichlet_partition(torch.from_numpy(y), 8, alpha=0.3, seed=11)
    assert len(a) == len(b) == 8
    for pa, pb in zip(a, b):
        np.testing.assert_array_equal(pa, pb)
    c = TS.dirichlet_partition(y, 8, alpha=0.3, seed=12)
    assert any(pa.shape != pc.shape or (pa != pc).any()
               for pa, pc in zip(a, c))


@pytest.mark.parametrize("alpha", [0.05, 1.0, 100.0])
def test_dirichlet_partition_is_a_partition(alpha):
    y = _labels()
    cat = np.concatenate(TS.dirichlet_partition(y, 7, alpha=alpha, seed=0))
    assert cat.size == y.size
    np.testing.assert_array_equal(np.sort(cat), np.arange(y.size))


def _mean_top_label_share(y, parts):
    shares = []
    for p in parts:
        if p.size == 0:
            continue
        counts = np.bincount(y[p], minlength=int(y.max()) + 1)
        shares.append(counts.max() / counts.sum())
    return float(np.mean(shares))


def test_dirichlet_skew_increases_as_alpha_drops():
    y = _labels(n_classes=10, per=500)
    skew = {a: _mean_top_label_share(
                y, TS.dirichlet_partition(y, 10, alpha=a, seed=2))
            for a in (0.05, 1.0, 100.0)}
    assert skew[0.05] > skew[1.0] > skew[100.0]
    assert skew[100.0] < 0.2
    assert skew[0.05] > 0.5


def test_dirichlet_empty_client_edge_case():
    y = np.asarray([0, 0, 1, 1], np.int32)
    parts = TS.dirichlet_partition(y, 8, alpha=0.1, seed=0)
    assert len(parts) == 8 and any(p.size == 0 for p in parts)
    np.testing.assert_array_equal(np.sort(np.concatenate(parts)),
                                  np.arange(y.size))
    for p in parts:
        assert p.dtype.kind == "i" or p.size == 0
        assert p.size == 0 or (0 <= p.min() and p.max() < y.size)
    x = np.zeros((y.size, 4), np.float32)
    empty_slot = int(np.argmax([p.size == 0 for p in parts]))
    with pytest.raises(ValueError):
        TS.client_batches(x, y, [parts[empty_slot]], (1, 1, 1, 2), seed=0,
                          round_idx=0)
