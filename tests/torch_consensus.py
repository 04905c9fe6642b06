"""Shared harness of the port's consensus-round tests: the same small
problem (D = 200 coordinates in three leaves, N = 10 clients, two of them
dead) through the reference's round step, run op by op, and the port's.

The loss 0.5 * ||x - y||^2 has the exact gradient x - y in both
frameworks, so any difference between the two rounds comes from the
wire, the aggregate or the decode."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.core import compression as JC
from repro.core import fedavg as JF
from repro_torch.core import compression as TC
from repro_torch.core import fedavg as TF
from repro_torch.core import noise as TN

LEAVES = (("a", (10, 10)), ("b", (60,)), ("c", (40,)))
D, N, ROUNDS = 200, 10, 12
MASK = np.ones((1, N), np.float32)
MASK[0, [2, 7]] = 0.0


def i32(a):
    return np.asarray(a).view(np.int32)


def ref_row_norms(p2d, n_coords):
    """The reference's norms of the port's rows (XLA's batched norm, as the
    reference's vmapped round computes them): monkeypatched into
    ``repro_torch.core.dp.row_norms`` where a test holds bits that depend
    on a norm's f32 summation order."""
    x = jnp.asarray(p2d[:, :n_coords].detach().cpu().numpy())
    return torch.from_numpy(np.array(jax.vmap(jnp.linalg.norm)(x)))


def _jloss(p, b):
    flat = jnp.concatenate([p[k].reshape(-1) for k, _ in LEAVES])
    return 0.5 * jnp.sum((flat - b["y"]) ** 2)


def _tloss(p, b):
    flat = torch.cat([p[k].reshape(-1) for k, _ in LEAVES])
    return 0.5 * torch.sum((flat - b["y"]) ** 2)


def targets(G=1, local_steps=1, seed=0):
    t = np.asarray(jax.random.normal(jax.random.PRNGKey(seed),
                                     (G, N // G, D)))
    return np.repeat(t[:, :, None], local_steps, axis=2)


def _cfg(mod, G, local_steps, slr):
    return mod.FedConfig(n_clients=N // G, client_groups=G,
                         local_steps=local_steps, client_lr=0.01,
                         server_lr=slr)


def reference(spec, ys, mask=MASK, *, G=1, local_steps=1, cohort="vmap",
              adversary="none", slr=2.0, rounds=ROUNDS):
    """The reference's rounds, op by op (no jit), under the 0/1-mask
    guarantee. -> (final state, last metrics)."""
    comp = JC.Pipeline(spec)
    cfg = _cfg(JF, G, local_steps, slr)
    step = JF.build_round_step(_jloss, comp, cfg, JF.RoundContext(
        cohort=cohort, weights_are_mask=True, adversary=adversary))
    st = JF.init_server_state({k: jnp.zeros(s) for k, s in LEAVES}, cfg,
                              comp, jax.random.PRNGKey(1))
    for _ in range(rounds):
        st, m = step(st, {"y": jnp.asarray(ys)},
                     jnp.asarray(mask.reshape(G, -1)))
    return st, m


def port(spec, ys, mask=MASK, *, G=1, local_steps=1, cohort="vmap",
         adversary="none", slr=2.0, rounds=ROUNDS, **ctx):
    """The port's rounds on the CPU, same problem and seeds."""
    comp = TC.Pipeline(spec)
    cfg = _cfg(TF, G, local_steps, slr)
    step = TF.build_round_step(_tloss, comp, cfg, TF.RoundContext(
        cohort=cohort, weights_are_mask=True, adversary=adversary, **ctx))
    st = TF.init_server_state({k: torch.zeros(s) for k, s in LEAVES}, cfg,
                              comp, TN.prng_key(1),
                              host_state="feed=host" in cohort)
    for _ in range(rounds):
        st, m = step(st, {"y": torch.from_numpy(ys)}, mask.reshape(G, -1))
    return st, m


def flat_params(st, torch_side: bool):
    if torch_side:
        return np.concatenate([st.params[k].numpy().ravel()
                               for k, _ in LEAVES])
    return np.concatenate([np.asarray(st.params[k]).ravel()
                           for k, _ in LEAVES])


def assert_state_equal(js, ts, n_total=N):
    """Client-state rows (EF residuals), bit for bit."""
    assert (js.comp_state is None) == (ts.comp_state is None)
    for k in (js.comp_state or {}):
        np.testing.assert_array_equal(
            i32(ts.comp_state[k].numpy().reshape(n_total, -1)),
            i32(np.asarray(js.comp_state[k]).reshape(n_total, -1)),
            err_msg=k)


def assert_port_same(a, b):
    """Two port runs: params and client-state rows bit for bit."""
    np.testing.assert_array_equal(i32(flat_params(a, True)),
                                  i32(flat_params(b, True)))
    for k in (a.comp_state or {}):
        np.testing.assert_array_equal(
            i32(a.comp_state[k].numpy().reshape(N, -1)),
            i32(b.comp_state[k].numpy().reshape(N, -1)), err_msg=k)
