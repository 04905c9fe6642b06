"""The port's flat wire substrate against the reference (repro.core.wire).

Every comparison is bit-exact: f32 sums are compared as int32 bit patterns,
so the sign of a zero counts too.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import wire as JW
from repro_torch.core import wire as TW

# The suite runs in parallel worker processes beside the reference's
# tests; one intra-op thread per worker keeps torch from oversubscribing
# the cores they share.
torch.set_num_threads(1)


def _bits(a):
    return np.asarray(a).view(np.int32)


def _tree(rng):
    return {"b": {"z": rng.randn(3, 5).astype(np.float32),
                  "a": rng.randn(7).astype(np.float32)},
            "a": rng.randn(2, 2, 2).astype(np.float32),
            "c": np.float32(rng.randn(1)).reshape(())}


def test_tree_spec_order_and_round_trip():
    rng = np.random.RandomState(0)
    tree = _tree(rng)
    jspec = JW.tree_spec(jax.tree.map(jnp.asarray, tree))
    ttree = {"b": {k: torch.from_numpy(v) for k, v in tree["b"].items()},
             "a": torch.from_numpy(tree["a"]),
             "c": torch.from_numpy(np.asarray(tree["c"]))}
    tspec = TW.tree_spec(ttree)
    assert tspec.shapes == jspec.shapes
    assert tspec.offsets == jspec.offsets
    assert tspec.n_coords == jspec.n_coords
    paths = [tuple(k.key for k in p) for p, _ in
             jax.tree_util.tree_flatten_with_path(tree)[0]]
    assert list(tspec.paths) == paths
    flat = tspec.flatten(ttree)
    np.testing.assert_array_equal(
        flat.numpy(), np.asarray(jspec.flatten(jax.tree.map(jnp.asarray,
                                                            tree))))
    back = tspec.unflatten(torch.nn.functional.pad(flat, (0, 5)))
    for path in tspec.paths:
        a, b = ttree, back
        for k in path:
            a, b = a[k], b[k]
        np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("d", [1, 8, 13, 1000])
def test_pack_flat_and_unpack_signs(d):
    rng = np.random.RandomState(d)
    x = rng.randn(d).astype(np.float32)
    x[::7] = 0.0
    want = np.asarray(JW.pack_flat(jnp.asarray(x)))
    got = TW.pack_flat(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        TW.unpack_signs(torch.from_numpy(want.copy())).numpy(),
        np.asarray(JW.unpack_signs(jnp.asarray(want))))


@pytest.mark.parametrize("n", [1, 8, 13])
@pytest.mark.parametrize("nb", [1, 13, 1025])
@pytest.mark.parametrize("kind", ["f32", "zero", "mask"])
def test_unpack_sum_bit_exact(n, nb, kind):
    rng = np.random.RandomState(n * 100 + nb)
    p = rng.randint(0, 256, (n, nb)).astype(np.uint8)
    w = {"f32": rng.randn(n), "zero": np.zeros(n),
         "mask": rng.randint(0, 2, n)}[kind].astype(np.float32)
    if kind == "f32":
        w[rng.randint(n)] = 0.0
    acc = rng.randn(8 * nb).astype(np.float32)
    jp, jw, tp, tw = (jnp.asarray(p), jnp.asarray(w), torch.from_numpy(p),
                      torch.from_numpy(w))
    np.testing.assert_array_equal(_bits(TW.unpack_sum(tp, tw)),
                                  _bits(JW.unpack_sum(jp, jw)))
    np.testing.assert_array_equal(
        _bits(TW.unpack_sum(tp, tw, torch.from_numpy(acc))),
        _bits(JW.unpack_sum(jp, jw, jnp.asarray(acc))))
    if kind != "f32":
        np.testing.assert_array_equal(_bits(TW.unpack_sum_mask(tp, tw)),
                                      _bits(JW.unpack_sum_mask(jp, jw)))
        np.testing.assert_array_equal(
            _bits(TW.unpack_sum_mask(tp, tw, torch.from_numpy(acc))),
            _bits(JW.unpack_sum_mask(jp, jw, jnp.asarray(acc))))


def test_all_zero_weights_sum_to_positive_zero():
    """Pins the sign of zero: zero-weight clients (dead, or the padding of
    the last 8-client block) give +0.0, as the reference does."""
    for n in (8, 13):
        p = np.zeros((n, 4), np.uint8)
        p[: n // 2] = 255
        w = np.zeros(n, np.float32)
        want = _bits(JW.unpack_sum(jnp.asarray(p), jnp.asarray(w)))
        got = _bits(TW.unpack_sum(torch.from_numpy(p), torch.from_numpy(w)))
        np.testing.assert_array_equal(got, want)
        assert not np.signbit(np.asarray(got).view(np.float32)).any()
