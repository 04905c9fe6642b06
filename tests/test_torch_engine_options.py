"""Engine surface of the port against the reference (repro.core.context,
repro.core.compression): the ``RoundContext`` fields the port shares with
the reference, and the ``compression.global_norm`` / ``pack_signs``
exports."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.core import compression as JC
from repro.core import context as JX
from repro.core import wire as JW
from repro_torch.core import compression as TC
from repro_torch.core import context as TX
from repro_torch.core import wire as TW

torch.set_num_threads(1)

#: reference RoundContext fields the port leaves out until a caller needs
#: them: ``legacy_client_path`` (set only by the reference's bench driver,
#: not ported) and ``donate_state`` (XLA buffer donation; the port updates
#: its state in place)
NOT_PORTED = ("legacy_client_path", "donate_state")


def test_round_context_fields_match_reference():
    """Every other field of the reference's RoundContext, in its order and
    with its default (``debug_wire`` reads the environment in both)."""
    want = [(f.name, f.default) for f in dataclasses.fields(JX.RoundContext)
            if f.name not in NOT_PORTED + ("debug_wire",)]
    got = [(f.name, f.default) for f in dataclasses.fields(TX.RoundContext)
           if f.name != "debug_wire"]
    assert got == want
    assert {f.name for f in dataclasses.fields(JX.RoundContext)} >= set(
        NOT_PORTED)


def test_global_norm_and_pack_signs_match_reference():
    rs = np.random.RandomState(3)
    tree = {"a": rs.randn(7, 9).astype(np.float32),
            "b": {"c": rs.randn(1000).astype(np.float32),
                  "d": rs.randn(3).astype(np.float32)}}
    want = np.asarray(JC.global_norm(jax.tree.map(jnp.asarray, tree)))
    got = TC.global_norm({"a": torch.from_numpy(tree["a"]),
                          "b": {k: torch.from_numpy(v)
                                for k, v in tree["b"].items()}})
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    bf = torch.from_numpy(tree["a"]).to(torch.bfloat16)
    np.testing.assert_allclose(
        TC.global_norm({"w": bf}).numpy(),
        np.asarray(JC.global_norm({"w": jnp.asarray(bf.float().numpy(),
                                                    jnp.bfloat16)})),
        rtol=1e-6)
    signs = np.where(rs.rand(4096) < 0.5, -1, 1).astype(np.int8)
    packed = TC.pack_signs(torch.from_numpy(signs))
    np.testing.assert_array_equal(packed.numpy(),
                                  np.asarray(JC.pack_signs(
                                      jnp.asarray(signs))))
    np.testing.assert_array_equal(TC.unpack_signs(packed).numpy(), signs)
    assert TC.pack_signs is TW.pack_signs
    np.testing.assert_array_equal(
        TW.pack_flat(torch.from_numpy(signs.astype(np.float32))).numpy(),
        np.asarray(JW.pack_flat(jnp.asarray(signs, jnp.float32))))
