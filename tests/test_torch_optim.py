"""The port's server optimizers against the reference
(repro.optim.optimizers), op by op on the same numpy inputs: ``sgd`` and
``momentum`` (nesterov too) bit-exact, ``adam`` within 1e-7 (its bias
corrections are f32, as the reference's; one sqrt and divide may round
differently on a few coordinates); and each server optimizer through a
consensus round (``FedConfig.server_opt``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compression as JC
from repro.core import fedavg as JF
from repro.optim import optimizers as JO
from repro_torch.core import compression as TC
from repro_torch.core import fedavg as TF
from repro_torch.core import noise as TN
from repro_torch.optim import optimizers as TO

torch.set_num_threads(1)

OPTS = [("sgd", {}), ("momentum", {}), ("momentum", {"beta": 0.5}),
        ("momentum", {"nesterov": True}), ("adam", {}),
        ("adam", {"b1": 0.8, "b2": 0.99, "eps": 1e-6})]


def _i32(a):
    return np.asarray(a).view(np.int32)


@pytest.mark.parametrize("name,kw", OPTS)
def test_five_steps_match_reference(name, kw):
    rs = np.random.RandomState(0)
    p0 = {"a": rs.randn(10_000).astype(np.float32),
          "b": rs.randn(40, 25).astype(np.float32)}
    grads = [{k: rs.randn(*v.shape).astype(np.float32) for k, v in
              p0.items()} for _ in range(5)]
    jo, to = JO.make_optimizer(name, 0.01, **kw), TO.make_optimizer(
        name, 0.01, **kw)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    js, ts = jo.init(jp), to.init(tp)
    for g in grads:
        jp, js = jo.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        tp, ts = to.update({k: torch.from_numpy(v) for k, v in g.items()},
                           ts, tp)
    for k in p0:
        got, want = tp[k].numpy(), np.asarray(jp[k])
        if name == "adam":
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)
        else:
            np.testing.assert_array_equal(_i32(got), _i32(want))
    if name == "adam":
        assert ts["t"] == int(js["t"]) == 5
        for k in p0:
            np.testing.assert_array_equal(_i32(ts["m"][k].numpy()),
                                          _i32(js["m"][k]))
            np.testing.assert_array_equal(_i32(ts["v"][k].numpy()),
                                          _i32(js["v"][k]))


def test_adam_bias_corrections_are_f32():
    """1 - b ** t in f32: at t = 1 the correction of b2 = 0.999 is
    f32(1) - f32(0.999), not the f64 value 0.001 (1.3e-5 relative
    apart), and the first step is the reference's bit for bit."""
    jo, to = JO.make_optimizer("adam", 0.01), TO.make_optimizer("adam", 0.01)
    p = np.linspace(-1, 1, 4096, dtype=np.float32)
    g = np.cos(np.arange(4096, dtype=np.float32))
    jp, _ = jo.update({"x": jnp.asarray(g)}, jo.init({"x": jnp.asarray(p)}),
                      {"x": jnp.asarray(p)})
    tp, _ = to.update({"x": torch.from_numpy(g)},
                      to.init({"x": torch.from_numpy(p)}),
                      {"x": torch.from_numpy(p)})
    np.testing.assert_allclose(tp["x"].numpy(), np.asarray(jp["x"]),
                               rtol=0, atol=1e-7)
    assert float(np.float32(1) - np.float32(0.999)) != 0.001


@pytest.mark.parametrize("opt", [("sgd", ()), ("momentum", (("beta", 0.9),)),
                                 ("adam", ())])
def test_server_opt_round_matches_reference(opt):
    """Six consensus rounds of zsign(z=1,sigma=2.0) with each server
    optimizer: the wire is bit-exact, so params follow the optimizer's
    own rule (bit-exact for sgd and momentum, 1e-6 for adam)."""
    d, n = 200, 10
    ys = np.array(jax.random.normal(jax.random.PRNGKey(0), (1, n, 1, d)))
    kw = dict(n_clients=n, client_lr=0.01, server_lr=0.5,
              server_opt=opt[0], server_opt_kw=opt[1])
    jcomp, tcomp = JC.Pipeline("zsign(z=1,sigma=2.0)"), TC.Pipeline(
        "zsign(z=1,sigma=2.0)")
    jcfg, tcfg = JF.FedConfig(**kw), TF.FedConfig(**kw)
    jstep = JF.build_round_step(
        lambda p, b: 0.5 * jnp.sum((p["x"] - b["y"]) ** 2), jcomp, jcfg)
    tstep = TF.build_round_step(
        lambda p, b: 0.5 * torch.sum((p["x"] - b["y"]) ** 2), tcomp, tcfg)
    js = JF.init_server_state({"x": jnp.zeros(d)}, jcfg, jcomp,
                              jax.random.PRNGKey(1))
    ts = TF.init_server_state({"x": torch.zeros(d)}, tcfg, tcomp,
                              TN.prng_key(1))
    mask = np.ones((1, n), np.float32)
    for _ in range(6):
        js, _ = jstep(js, {"y": jnp.asarray(ys)}, jnp.asarray(mask))
        ts, _ = tstep(ts, {"y": torch.from_numpy(ys)}, mask)
    if opt[0] == "adam":
        np.testing.assert_allclose(ts.params["x"].numpy(),
                                   np.asarray(js.params["x"]), rtol=0,
                                   atol=1e-6)
    else:
        np.testing.assert_array_equal(_i32(ts.params["x"].numpy()),
                                      _i32(js.params["x"]))
