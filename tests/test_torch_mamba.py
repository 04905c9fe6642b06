"""The port's mamba block (``repro_torch.models.mamba``) against the
reference's ``repro.models.mamba`` on the same numpy inputs and weights.

Tolerances: ``a_log`` and the training conv ``_causal_conv`` are
bit-exact (f32 and bf16: elementwise products and adds, summed from 0 with
tap 0 first in both packages); ``mamba_block`` (one chunk at T = 32, two
chunks of 256 at T = 512) and the decode steps, in f32, within 1e-5 of the
largest |output|: the matmuls and the scan's sum over the 16 states run in
each framework's order, and the decode conv is an f32 einsum.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import mamba as JM
from repro_torch.models import mamba as TM

torch.set_num_threads(1)

REL = 1e-5
D_MODEL = 16            # d_inner 32, dt_rank 1


def _weights(seed, d_model=D_MODEL):
    """One layer's weights (the reference's init from a seed) as numpy."""
    p = JM.mamba_init(jax.random.PRNGKey(seed), d_model, 1, jnp.float32)
    return {k: np.array(v[0]) for k, v in p.items()}


def _t(lp):
    return {k: torch.from_numpy(v.copy()) for k, v in lp.items()}


def _close(got, want, rel=REL):
    want = np.asarray(want)
    err = np.max(np.abs(np.asarray(got) - want))
    assert err <= rel * np.max(np.abs(want)), (err, np.max(np.abs(want)))


def test_param_tree_and_a_log_bits_equal_reference():
    """Every leaf's shape and dtype; a_log = log(1..16) equal to the bit
    (computed, not drawn); d_skip and dt_bias as the reference's."""
    jp = JM.mamba_init(jax.random.PRNGKey(0), 24, 3, jnp.bfloat16)
    tp = TM.mamba_init(torch.Generator().manual_seed(0), 24, 3,
                       torch.bfloat16, "cpu")
    assert sorted(tp) == sorted(jp)
    for k in jp:
        assert tuple(tp[k].shape) == jp[k].shape, k
        assert str(tp[k].dtype).split(".")[1] == jp[k].dtype.name, k
    np.testing.assert_array_equal(tp["a_log"].numpy().view(np.int32),
                                  np.asarray(jp["a_log"]).view(np.int32))
    for k in ("d_skip", "dt_bias"):
        np.testing.assert_array_equal(tp[k].float().numpy(),
                                      np.asarray(jp[k], np.float32))
    # the table is log(1..16) within one ulp of the correctly rounded f32
    exact = np.log(np.arange(1, 17, dtype=np.float64)).astype(np.float32)
    ulps = tp["a_log"][0, 0].numpy().view(np.int32) - exact.view(np.int32)
    assert set(ulps.tolist()) <= {0, 1}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv_bit_exact(dtype):
    rs = np.random.RandomState(3)
    x = rs.randn(2, 40, 32).astype(np.float32)
    w = (rs.randn(4, 32) * 0.5).astype(np.float32)
    jd = getattr(jnp, dtype)
    want = JM._causal_conv(jnp.asarray(x, jd), jnp.asarray(w, jd))
    td = getattr(torch, dtype)
    got = TM._causal_conv(torch.from_numpy(x).to(td),
                          torch.from_numpy(w).to(td))
    assert got.dtype == td
    iv = np.int32 if dtype == "float32" else np.int16
    np.testing.assert_array_equal(
        got.view(torch.int32 if dtype == "float32" else torch.int16).numpy(),
        np.asarray(want).view(iv))


_j_block = jax.jit(JM.mamba_block, static_argnames=("d_model",))


@pytest.mark.parametrize("T", [32, 512])
def test_mamba_block_matches_reference(T):
    rs = np.random.RandomState(T)
    lp = _weights(T)
    x = rs.randn(2, T, D_MODEL).astype(np.float32)
    want = _j_block(jnp.asarray(x), {k: jnp.asarray(v) for k, v in
                                     lp.items()}, d_model=D_MODEL)
    got = TM.mamba_block(torch.from_numpy(x), _t(lp), d_model=D_MODEL)
    _close(got.numpy(), want)


def test_scan_chunked_state_matches_reference():
    """The scan's final state h_T after two chunks, and its outputs."""
    rs = np.random.RandomState(8)
    B, T, d_in, N = 2, 512, 8, TM.D_STATE
    dt = np.abs(rs.randn(B, T, d_in)).astype(np.float32) * 0.1
    b_, c_ = (rs.randn(B, T, N).astype(np.float32) for _ in range(2))
    x = rs.randn(B, T, d_in).astype(np.float32)
    a_log = _weights(0, 4)["a_log"]
    h0 = rs.randn(B, d_in, N).astype(np.float32)
    jy, jh = JM._scan_chunked(*(jnp.asarray(a) for a in
                                (dt, b_, c_, x, a_log, h0)))
    ty, th = TM._scan_chunked(*(torch.from_numpy(a) for a in
                                (dt, b_, c_, x, a_log, h0)))
    _close(ty.numpy(), jy)
    _close(th.numpy(), jh)


def test_decode_steps_match_reference():
    """8 one-token steps from the zero cache: outputs, state h and conv
    tail after each step."""
    rs = np.random.RandomState(5)
    lp = _weights(5)
    jlp = {k: jnp.asarray(v) for k, v in lp.items()}
    tlp = _t(lp)
    jc = JM.mamba_cache_init(3, D_MODEL, 1)
    tc = TM.mamba_cache_init(3, D_MODEL, 1, "cpu")
    jh, jconv = jc["h"][0], jc["conv"][0]
    th, tconv = tc["h"][0], tc["conv"][0]
    for _ in range(8):
        x = rs.randn(3, 1, D_MODEL).astype(np.float32)
        jy, jh, jconv = JM.mamba_decode_step(jnp.asarray(x), jlp, jh, jconv,
                                             d_model=D_MODEL)
        ty, th, tconv = TM.mamba_decode_step(torch.from_numpy(x), tlp, th,
                                             tconv, d_model=D_MODEL)
        _close(ty.numpy(), jy)
        _close(th.numpy(), jh)
        np.testing.assert_array_equal(tconv.numpy(), np.asarray(jconv))


@pytest.mark.parametrize("T", [40, 601])
def test_decode_recurrence_matches_block(T):
    """The port's own two forms: T decode steps against one mamba_block
    over the same T positions (f32; the conv sums in another order). At T
    = 601 the scan's chunks of 300 leave a last chunk of 1 step, a length
    the reference's reshape refuses."""
    rs = np.random.RandomState(6)
    tlp = _t(_weights(6))
    x = torch.from_numpy(rs.randn(2, T, D_MODEL).astype(np.float32))
    full = TM.mamba_block(x, tlp, d_model=D_MODEL)
    c = TM.mamba_cache_init(2, D_MODEL, 1, "cpu")
    h, conv, outs = c["h"][0], c["conv"][0], []
    for t in range(T):
        y, h, conv = TM.mamba_decode_step(x[:, t:t + 1], tlp, h, conv,
                                          d_model=D_MODEL)
        outs.append(y)
    _close(torch.cat(outs, dim=1).numpy(), full.numpy())
