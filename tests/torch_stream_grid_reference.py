"""The reference's side of ``tests/test_torch_sharded_stream.py``, run as a
subprocess on a forced-host CPU platform of 4 devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=4``, so that
``stream(devices=2)`` has its devices), beside the port's gloo ranks:

    python tests/torch_stream_grid_reference.py <in.pkl> <out.pkl>

``<in.pkl>`` holds the reduced qwen2.5-32b's numpy params, its round-0
(G, 1, 1, micro, S) token batch of each G, the client and server learning
rates, and the scenarios: name -> (G, pipeline spec, cohort policy). For
each G it writes each client's loss and flat gradient
(``wire.tree_spec`` order) of the reference's model; for
each scenario, the flat params after the reference's round on those
gradients (a linear loss whose gradient they are, the same keys as the
port's round) under the scenario's cohort policy, with its
``shard_clients``.
"""
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs.common import get_arch
from repro.core import compression as JC
from repro.core import fedavg as JF
from repro.core import wire as JW
from repro.models.api import build_model


def _grads(cfg, params, tokens):
    bundle = build_model(cfg)
    spec = JW.tree_spec(params)
    step = jax.jit(jax.value_and_grad(bundle.loss_fn))
    out = []
    for g in range(tokens.shape[0]):
        loss, grad = step(params, {"tokens": jnp.asarray(tokens[g, 0, 0])})
        out.append({"loss": float(loss),
                    "grad": np.asarray(spec.flatten(grad))})
    return out


def _round(params, grads, spec_str, cohort, lrs):
    G = len(grads)
    tspec = JW.tree_spec(params)
    gs = jnp.stack([jnp.asarray(c["grad"]) for c in grads])

    def loss_fn(p, b):
        return jnp.sum(tspec.flatten(p) * gs[b["c"].reshape(-1)[0]])
    comp = JC.Pipeline(spec_str)
    cfg = JF.FedConfig(n_clients=1, client_groups=G, local_steps=1,
                       client_lr=lrs[0], server_lr=lrs[1])
    step = JF.build_round_step(loss_fn, comp, cfg, JF.RoundContext(
        weights_are_mask=True, cohort=cohort))
    st = JF.init_server_state(params, cfg, comp, jax.random.PRNGKey(1))
    c = np.arange(G, dtype=np.int32).reshape(G, 1, 1, 1)
    st, m = step(st, {"c": c}, np.ones((G, 1), np.float32))
    return {"params": np.asarray(tspec.flatten(st.params)),
            "shard_clients": int(m.shard_clients)}


def main(src, dst):
    assert jax.device_count() == 4, jax.device_count()
    with open(src, "rb") as f:
        inputs = pickle.load(f)
    cfg = get_arch("qwen2_5_32b").reduced().model
    params = jax.tree.map(jnp.asarray, inputs["params"])
    grads = {G: _grads(cfg, params, t) for G, t in inputs["tokens"].items()}
    rounds = {name: _round(params, grads[G], spec, cohort, inputs["lrs"])
              for name, (G, spec, cohort) in inputs["scenarios"].items()}
    with open(dst, "wb") as f:
        pickle.dump({"grads": grads, "rounds": rounds}, f)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
