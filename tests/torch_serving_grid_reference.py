"""The reference's side of ``tests/test_torch_sharded_serving.py``, run as a
subprocess on a forced-host CPU platform of 4 devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=4``):

    python tests/torch_serving_grid_reference.py <in.pkl> <out.pkl>

``<in.pkl>`` maps each scenario to its ModelCfg fields, the (data, model)
shape of its grid, numpy params, the
prefill cell's input (tokens, or the enc-dec's f32 frames), the start
tokens, the cache length and steps, and (enc-dec) the 2,048 source frames
of the decode's memory. For each it writes the reference's prefill cell as
``src/repro/launch/dryrun.build_prefill_cell`` computes it (the hybrid's
and the xLSTM's ``forward_hidden``, the last position's f32 logits through
``_head``; the enc-dec's ``encode(params, embeds)[:, -1:]``), the hybrid's
under ``sharding_hints`` on a mesh of the grid's shape (``("model",)``,
``("data",)``: its MoE counts capacity per sequence shard as the grid
does); then a greedy decode of ``bundle.decode_step`` on one device from
``bundle.init_cache`` (the enc-dec's memory from ``prefill_memory`` over
the source frames first): each step's logits and argmax, and the final
cache.
"""
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh

from repro.launch.hints import sharding_hints
from repro.models import encdec as JE
from repro.models import hybrid as JH
from repro.models import xlstm as JX
from repro.models.api import ModelCfg, build_model


def _prefill(cfg):
    if cfg.family == "hybrid":
        return lambda p, t: (JH.forward_hidden(p, t, cfg)[0][:, -1:]
                             @ JH._head(p, cfg)).astype(jnp.float32)
    if cfg.family == "xlstm":
        return lambda p, t: (JX.forward_hidden(p, t, cfg)[:, -1:]
                             @ JX._head(p, cfg)).astype(jnp.float32)
    return lambda p, e: JE.encode(p, e, cfg)[:, -1:]


def _case(case):
    cfg = ModelCfg(**case["cfg"], dtype=jnp.float32)
    bundle = build_model(cfg)
    params = jax.tree.map(jnp.asarray, case["params"])
    mesh = Mesh(np.array(jax.devices()).reshape(case["grid"]),
                ("data", "model"))
    hybrid = cfg.family == "hybrid"
    with sharding_hints(mesh if hybrid else None, ("model",), ("data",)):
        pre = np.asarray(jax.jit(_prefill(cfg))(
            params, jnp.asarray(case["prefill"])).astype(jnp.float32))
    cache = bundle.init_cache(case["start"].shape[0], case["slots"])
    if cfg.family == "encdec":
        ks, vs = jax.jit(lambda p, e: JE.prefill_memory(p, e, cfg))(
            params, jnp.asarray(case["frames"]))
        cache = dict(cache, mem_k=ks, mem_v=vs)
    step = jax.jit(bundle.decode_step)
    tok = jnp.asarray(case["start"])
    logits, tokens = [], []
    for t in range(case["steps"]):
        out, cache = step(params, cache, tok, jnp.int32(t))
        logits.append(np.asarray(out))
        tok = jnp.argmax(out[:, -1], axis=-1).astype(jnp.int32)[:, None]
        tokens.append(np.asarray(tok))
    return {"prefill": pre, "logits": logits, "tokens": tokens,
            "cache": jax.tree.map(lambda v: np.asarray(v, np.float32),
                                  cache)}


def main(src, dst):
    assert jax.device_count() == 4, jax.device_count()
    with open(src, "rb") as f:
        inputs = pickle.load(f)
    res = {n: _case(c) for n, c in inputs.items()}
    with open(dst, "wb") as f:
        pickle.dump(res, f)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
