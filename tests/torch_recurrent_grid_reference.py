"""The reference's side of ``tests/test_torch_sharded_recurrent.py`` (and
of ``tests/test_torch_sharded_encdec.py``), run as a subprocess on a
forced-host CPU platform of 4 devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=4``), beside the port's
gloo ranks:

    python tests/torch_recurrent_grid_reference.py <in.pkl> <out.pkl>

``<in.pkl>`` holds ``rounds``: name -> arch id, numpy params, the round's
(G, N, E, micro, S) token batch, and the (data, model) shape of a mesh
whose hints the reference runs under (the hybrid's MoE counts its capacity
per sequence shard, so its grid function is the one under the mesh's
``sharding_hints(mesh, ("model",), ("data",))``), or None for one device
(the xLSTM, whose function has no shard count), and the mLSTM's key chunk
(``xlstm.CHUNK``) where the case cuts it. An enc-dec round's case also
holds its (G, N, E, micro, S_src, D) frames, ``embeds``, beside the target
tokens. For every client of a round it writes the reference's loss, its
flat gradient (``wire.tree_spec`` order) and the MoE aux
(``hybrid.forward_hidden``'s; 0 for the other families).
"""
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh

from repro.configs.common import get_arch
from repro.core import wire as JW
from repro.launch.hints import sharding_hints
from repro.models import hybrid as JH
from repro.models import xlstm as JX
from repro.models.api import build_model


def _round(case):
    JX.CHUNK = case.get("chunk", 256)
    cfg = get_arch(case["arch_id"]).reduced().model
    bundle = build_model(cfg)
    params = jax.tree.map(jnp.asarray, case["params"])
    spec = JW.tree_spec(params)
    tokens = case["tokens"]
    mesh = None
    if case["mesh"] is not None:
        mesh = Mesh(np.array(jax.devices()).reshape(case["mesh"]),
                    ("data", "model"))
    hybrid = cfg.family == "hybrid"

    def step(p, b):
        loss, grad = jax.value_and_grad(bundle.loss_fn)(p, b)
        aux = (JH.forward_hidden(p, b["tokens"], cfg)[1] if hybrid
               else jnp.zeros(()))
        return loss, grad, aux

    with sharding_hints(mesh, ("model",), ("data",)):
        step = jax.jit(step)
        out = []
        for g in range(tokens.shape[0]):
            for c in range(tokens.shape[1]):
                batch = {"tokens": jnp.asarray(tokens[g, c, 0])}
                if "embeds" in case:
                    batch["embeds"] = jnp.asarray(case["embeds"][g, c, 0])
                loss, grad, aux = step(params, batch)
                out.append({"loss": float(loss), "aux": float(aux),
                            "grad": np.asarray(spec.flatten(grad))})
    return out


def main(src, dst):
    assert jax.device_count() == 4, jax.device_count()
    with open(src, "rb") as f:
        inputs = pickle.load(f)
    res = {n: _round(c) for n, c in inputs["rounds"].items()}
    with open(dst, "wb") as f:
        pickle.dump(res, f)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
