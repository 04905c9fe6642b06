"""The reference's side of ``tests/test_torch_sharded_moe.py``, run as a
subprocess on a forced-host CPU mesh of 4 devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=4``), so the reference's
``moe_apply`` counts its capacity over the same sequence shards as the
port's 2 x 2 grid:

    python tests/torch_moe_grid_reference.py <in.pkl> <out.pkl>

``<in.pkl>`` holds ``rounds`` (name -> arch id, ModelCfg overrides, big
plan or not, whether to run under the mesh's hints, numpy params and the
round's (G, N, E, micro, ...) batch) and ``layers`` (name -> arch id, x,
the layer's params, sequence shards). For every client of a round it
writes the reference's loss, its flat gradient (``wire.tree_spec`` order)
and the layer-mean MoE aux, each under ``sharding_hints(mesh, ("model",),
batch_axes)`` on a (data=2, model=2) mesh (the regular plan splits only
the sequence, the big plan the micro-batch over ``data`` too), or on one
device; for every layer case ``moe_apply``'s output and aux under the
mesh's hints.
"""
import dataclasses
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh

from repro.configs.common import get_arch
from repro.core import wire as JW
from repro.launch.hints import sharding_hints
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.models.api import build_model


def _cfg(arch_id, over):
    m = get_arch(arch_id).reduced().model
    return dataclasses.replace(m, **over)


def _round(case, mesh):
    cfg = _cfg(case["arch_id"], case["over"])
    bundle = build_model(cfg)
    params = jax.tree.map(jnp.asarray, case["params"])
    spec = JW.tree_spec(params)
    batch = case["batch"]
    G, N = next(iter(batch.values())).shape[:2]
    with sharding_hints(mesh if case["mesh"] else None, ("model",),
                        ("data",) if case["big"] else None):
        vg = jax.jit(jax.value_and_grad(bundle.loss_fn))
        aux_of = jax.jit(lambda p, t: JT.forward_hidden(p, t, cfg)[1])
        out = []
        for g in range(G):
            for c in range(N):
                b = {k: jnp.asarray(v[g, c, 0]) for k, v in batch.items()}
                loss, grad = vg(params, b)
                aux = (float(aux_of(params, b["tokens"]))
                       if cfg.moe_experts else 0.0)
                out.append({"loss": float(loss), "aux": aux,
                            "grad": np.asarray(spec.flatten(grad))})
    return out


def _layer(case, mesh):
    cfg = _cfg(case["arch_id"], {})
    lp = {k: jnp.asarray(v) for k, v in case["lp"].items()}
    with sharding_hints(mesh, ("model",), None):
        f = jax.jit(lambda x, p: JL.moe_apply(
            x, p, cfg.moe_experts, cfg.moe_topk, ep=cfg.moe_ep))
        out, aux = f(jnp.asarray(case["x"]), lp)
    return {"out": np.asarray(out), "aux": float(aux)}


def main(src, dst):
    assert jax.device_count() == 4, jax.device_count()
    mesh = Mesh(np.array(jax.devices()).reshape(2, 2), ("data", "model"))
    with open(src, "rb") as f:
        inputs = pickle.load(f)
    res = {"rounds": {n: _round(c, mesh)
                      for n, c in inputs["rounds"].items()},
           "layers": {n: _layer(c, mesh)
                      for n, c in inputs["layers"].items()}}
    with open(dst, "wb") as f:
        pickle.dump(res, f)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
