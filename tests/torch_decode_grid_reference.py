"""The reference's side of ``tests/test_torch_sharded_decode.py``, run as a
subprocess on a forced-host CPU mesh of 4 devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=4``), so that the
reference's ``moe_apply`` counts a prefill's capacity over the same
sequence shards as the port's 2 x 2 grid:

    python tests/torch_decode_grid_reference.py <in.pkl> <out.pkl>

``<in.pkl>`` maps each scenario to its ModelCfg fields, big plan or not,
numpy params, prefill tokens, start tokens and steps. For each it writes
the reference's prefill (``transformer.forward_hidden``, the last
position's f32 logits through the head; an MoE model under
``sharding_hints(mesh, ("model",), batch_axes)`` on a (data=2, model=2)
mesh, as the reference's dry run runs the cell), and a greedy decode of
``bundle.decode_step`` from a zero ``init_cache`` (one device; at S = 1
the MoE's shard count is 1 either way): each step's logits and argmax,
and the final cache.
"""
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh

from repro.launch.hints import sharding_hints
from repro.models import transformer as JT
from repro.models.api import ModelCfg, build_model


def _case(case, mesh):
    cfg = ModelCfg(**case["cfg"], dtype=jnp.float32)
    bundle = build_model(cfg)
    params = jax.tree.map(jnp.asarray, case["params"])
    moe = cfg.moe_experts > 0
    with sharding_hints(mesh if moe else None, ("model",),
                        ("data",) if case["big"] else None):
        prefill = jax.jit(lambda p, t: (JT.forward_hidden(p, t, cfg)[0][
            :, -1:] @ JT.lm_head(p, cfg)).astype(jnp.float32))
        pre = np.asarray(prefill(params, jnp.asarray(case["prefill"])))
    step = jax.jit(bundle.decode_step)
    cache = bundle.init_cache(case["start"].shape[0], case["slots"])
    tok = jnp.asarray(case["start"])
    logits, tokens = [], []
    for t in range(case["steps"]):
        out, cache = step(params, cache, tok, jnp.int32(t))
        logits.append(np.asarray(out))
        tok = jnp.argmax(out[:, -1], axis=-1).astype(jnp.int32)[:, None]
        tokens.append(np.asarray(tok))
    return {"prefill": pre, "logits": logits, "tokens": tokens,
            "cache": {k: np.asarray(v) for k, v in cache.items()}}


def main(src, dst):
    assert jax.device_count() == 4, jax.device_count()
    mesh = Mesh(np.array(jax.devices()).reshape(2, 2), ("data", "model"))
    with open(src, "rb") as f:
        inputs = pickle.load(f)
    res = {n: _case(c, mesh) for n, c in inputs.items()}
    with open(dst, "wb") as f:
        pickle.dump(res, f)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
