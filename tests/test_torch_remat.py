"""Rematerialization in the port, on the CPU at reduced sizes: every layer
(transformer and enc-dec layers, xLSTM groups, hybrid super-blocks) and
every mamba scan chunk, sLSTM scan chunk and cross-entropy chunk is
recomputed in the backward pass, off a grid as the reference's
``jax.checkpoint`` does, and that changes no bit. The scans' ``CHUNK`` and
the cross entropy's ``q_chunk`` are cut so that every scan and the loss run
at least three chunks. The saved-tensor counts (``torch.autograd.graph.
saved_tensors_hooks``) show what the backward keeps: the chunk carries and
inputs, no (B, S, V) logits, and per layer its input (and weights, which
it does not copy); off a grid no K/V.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.common import get_arch as j_get_arch
from repro.core import compression as JC
from repro.core import fedavg as JF
from repro.core import noise as JN
from repro.core import wire as JW
from repro.data.synthetic import TokenStream as JTokenStream
from repro.models.api import build_model as j_build
from repro_torch.configs.common import get_arch
from repro_torch.core import compression as TC
from repro_torch.core import fedavg as TF
from repro_torch.core import noise as TN
from repro_torch.core import wire as TW
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.launch import hints
from repro_torch.models import layers as L
from repro_torch.models import mamba as TM
from repro_torch.models import transformer as TT
from repro_torch.models import xlstm as TX
from repro_torch.models.api import build_model, params_from_numpy

FAMILIES = ("qwen2_0_5b", "granite_moe_1b_a400m", "internvl2_1b",
            "xlstm_350m", "jamba_1_5_large_398b", "seamless_m4t_large_v2")
SEQ = 32
#: the scans' and the loss's chunk at SEQ: 4 mamba / sLSTM chunks and 4
#: cross-entropy chunks (the enc-dec's 15 predicted target tokens in 3
#: chunks of 5)
CHUNK = 8
Q_CHUNK = {"seamless_m4t_large_v2": 5}
_RematSlot = hints.RematSlot


@pytest.fixture(autouse=True)
def _cut_chunks(monkeypatch):
    monkeypatch.setattr(TM, "CHUNK", CHUNK)
    monkeypatch.setattr(TX, "CHUNK", CHUNK)
    # one intra-op thread: at these sizes more threads only spin (the file
    # took 140 s instead of 27 s on 8 cores)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _bundle(arch_id):
    m = get_arch(arch_id).reduced().model
    return build_model(dataclasses.replace(
        m, q_chunk=Q_CHUNK.get(arch_id, CHUNK)))


def _batch(bundle, lead, seed):
    """A training batch of ``bundle``'s spec at (micro 2, SEQ) with the
    leading dims ``lead``, drawn with numpy from ``seed``."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, leaf in bundle.train_batch_spec(2, SEQ).items():
        shape = tuple(lead) + tuple(leaf.shape)
        if leaf.dtype in (torch.int32, torch.int64):
            out[name] = torch.from_numpy(
                rng.integers(0, bundle.cfg.vocab, shape)).long()
        else:
            out[name] = torch.from_numpy(
                rng.standard_normal(shape).astype(np.float32))
    return out


def _loss_and_grads(bundle, params, batch, remat, counted):
    """(loss, gradients, the regions the forward opened)."""
    p = tree_map(lambda w: w.detach().requires_grad_(True), params)
    with hints.remat_mode(remat):
        counted.reset()
        loss = bundle.loss_fn(p, batch)
        grads = torch.autograd.grad(loss, tree_leaves(p))
    return loss.detach(), grads, (counted.layers, dict(counted.chunks))


class _Counted:
    """Wraps ``hints.remat`` and ``hints.remat_chunk`` to count the layer
    and chunk regions a forward and backward open, by the chunk function's
    name (a layer's first forward records nothing, so the chunk regions in
    it open in its recompute)."""

    def __init__(self, monkeypatch):
        self.reset()
        remat, chunk = hints.remat, hints.remat_chunk

        def count_remat(fn, save_weights, *args):
            if hints.remat_on():
                self.layers += 1
            return remat(fn, save_weights, *args)

        def count_chunk(fn, *args):
            if hints.remat_on():
                name = getattr(fn, "func", fn).__name__
                self.chunks[name] = self.chunks.get(name, 0) + 1
            return chunk(fn, *args)

        monkeypatch.setattr(hints, "remat", count_remat)
        monkeypatch.setattr(hints, "remat_chunk", count_chunk)

    def reset(self):
        self.layers, self.chunks = 0, {}


#: remat regions a forward and backward open at SEQ: layers, and chunks by
#: function
REGIONS = {
    "qwen2_0_5b": (2, {"_ce_chunk": 4}),
    "granite_moe_1b_a400m": (2, {"_ce_chunk": 4}),
    "internvl2_1b": (2, {"_ce_chunk": 4}),
    "xlstm_350m": (1, {"_slstm_chunk": 4, "_ce_chunk": 4}),
    "jamba_1_5_large_398b": (1, {"_scan_chunk": 7 * 4, "_ce_chunk": 4}),
    "seamless_m4t_large_v2": (4, {"_ce_chunk": 3}),
}


@pytest.mark.parametrize("arch_id", FAMILIES)
def test_loss_and_gradients_bit_identical_with_remat_on_and_off(
        arch_id, monkeypatch):
    bundle = _bundle(arch_id)
    params = bundle.init(torch.Generator().manual_seed(0), device="cpu")
    batch = _batch(bundle, (), 1)
    counted = _Counted(monkeypatch)
    loss_on, g_on, regions = _loss_and_grads(bundle, params, batch, True,
                                             counted)
    assert regions == REGIONS[arch_id]
    loss_off, g_off, regions = _loss_and_grads(bundle, params, batch, False,
                                               counted)
    assert regions == (0, {})
    assert torch.isfinite(loss_on) and torch.equal(loss_on, loss_off)
    assert len(g_on) == len(g_off)
    for a, b in zip(g_on, g_off):
        assert torch.equal(a, b)
        assert torch.isfinite(a).all()


@pytest.mark.parametrize("arch_id", FAMILIES)
def test_round_params_bit_identical_with_remat_on_and_off(arch_id):
    """One round of 2 clients at 2 local steps through ``build_round_step``
    with its ``remat`` switch on and off, on the dense f32 wire (the
    identity codec), so that every bit of each pseudo-gradient reaches the
    params."""
    bundle = _bundle(arch_id)
    params = bundle.init(torch.Generator().manual_seed(0), device="cpu")
    batch = _batch(bundle, (1, 2, 2), 2)
    comp = TC.Compressor()
    cfg = TF.FedConfig(n_clients=2, local_steps=2, client_lr=0.05,
                       server_lr=0.5)
    out = []
    for remat in (True, False):
        step = TF.build_round_step(bundle.loss_fn, comp, cfg,
                                   TF.RoundContext(weights_are_mask=True),
                                   remat=remat)
        state = TF.init_server_state(params, cfg, comp, TN.prng_key(1),
                                     sigma0=0.01)
        state, metrics = step(state, batch, np.ones((1, 2), np.float32))
        out.append((state.params, metrics.loss))
    (p_on, l_on), (p_off, l_off) = out
    assert torch.equal(torch.as_tensor(l_on), torch.as_tensor(l_off))
    changed = False
    for a, b, w in zip(tree_leaves(p_on), tree_leaves(p_off),
                       tree_leaves(params)):
        assert torch.equal(a, b)
        changed = changed or not torch.equal(a, w)
    assert changed


def test_remat_is_off_without_autograd_and_under_the_switch():
    assert hints.remat_on()
    with torch.no_grad():
        assert not hints.remat_on()
    with hints.remat_mode(False):
        assert not hints.remat_on()
        with hints.remat_mode(True):
            assert hints.remat_on()
        assert not hints.remat_on()
    assert hints.remat_on()


# ---------------------------------------------------------------------------
# what the backward keeps
# ---------------------------------------------------------------------------

class _Saved:
    """The tensors autograd packs for the backward while it is entered
    (a region's own saves go to its checkpoint, not here)."""

    def __init__(self):
        self.shapes = []
        self.bytes = 0
        self._hooks = torch.autograd.graph.saved_tensors_hooks(
            self._pack, lambda t: t)

    def _pack(self, t):
        self.shapes.append((tuple(t.shape), t.dtype))
        self.bytes += t.numel() * t.element_size()
        return t

    def __enter__(self):
        self._hooks.__enter__()
        return self

    def __exit__(self, *exc):
        self._hooks.__exit__(*exc)


def _f32(rng, *shape, requires_grad=True):
    return torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).requires_grad_(requires_grad)


def _nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def test_mamba_scan_keeps_its_chunk_carries_and_inputs_not_every_step():
    rng = np.random.default_rng(3)
    B, T, d, N = 2, 64, 32, TM.D_STATE
    dt = torch.nn.functional.softplus(_f32(rng, B, T, d))
    B_, C_, x = _f32(rng, B, T, N), _f32(rng, B, T, N), _f32(rng, B, T, d)
    a_log = _f32(rng, d, N)
    h0 = torch.zeros((B, d, N))
    n_chunks = T // CHUNK
    h_bytes, a_bytes = _nbytes(h0), _nbytes(a_log)
    got = {}
    for remat in (True, False):
        with hints.remat_mode(remat), _Saved() as saved:
            y, _ = TM._scan_chunked(dt, B_, C_, x, a_log, h0)
        got[remat] = (saved, y)
    on, off = got[True][0], got[False][0]
    assert torch.equal(got[True][1], got[False][1])
    # each chunk region keeps its carry, its input slices and A; outside
    # them only A's exp output
    assert on.bytes <= _nbytes(dt, B_, C_, x) + n_chunks * (
        h_bytes + a_bytes) + a_bytes
    assert sum(1 for s, _ in on.shapes if s == (B, d, N)) == n_chunks
    # without remat every step's state, and each chunk's decay and input
    # terms, are kept: three (B, T, d, N) f32 at least
    assert off.bytes >= 3 * T * h_bytes
    print(f"mamba scan saves {on.bytes} bytes with remat, {off.bytes} "
          f"without")


def test_slstm_scan_keeps_its_chunk_carries_and_inputs_not_every_step():
    rng = np.random.default_rng(4)
    B, S, D, H = 2, 48, 32, 4
    x_pre = _f32(rng, B, S, 4 * D)
    wr = _f32(rng, H, D // H, 4 * D // H)
    n_chunks = S // CHUNK
    carry_bytes = 4 * B * D * 4
    got = {}
    for remat in (True, False):
        with hints.remat_mode(remat), _Saved() as saved:
            h = TX._slstm_scan(x_pre, wr, H)
        got[remat] = (saved, h)
    on, off = got[True][0], got[False][0]
    assert torch.equal(got[True][1], got[False][1])
    assert on.bytes <= _nbytes(x_pre) + n_chunks * (carry_bytes
                                                    + _nbytes(wr))
    assert off.bytes >= S * carry_bytes
    print(f"sLSTM scan saves {on.bytes} bytes with remat, {off.bytes} "
          f"without")


def test_chunked_ce_keeps_no_logits():
    rng = np.random.default_rng(5)
    B, S, D, V, c = 2, 48, 16, 997, 16
    x = _f32(rng, B, S, D)
    head = _f32(rng, D, V)
    tgt = torch.from_numpy(rng.integers(0, V, (B, S)))
    mask = torch.from_numpy((rng.random((B, S)) > 0.2).astype(np.float32))
    got = {}
    for remat in (True, False):
        with hints.remat_mode(remat), _Saved() as saved:
            tot, cnt = L.chunked_ce_sums(x, head, tgt, mask, chunk=c)
        got[remat] = (saved, tot, cnt)
    on, off = got[True][0], got[False][0]
    assert torch.equal(got[True][1], got[False][1])
    assert torch.equal(got[True][2], got[False][2])
    logits = [s for s, dt in on.shapes if s[-1] == V and s != (D, V)]
    assert logits == []
    # each chunk keeps its input slices and the head
    assert on.bytes <= _nbytes(x, tgt, mask) + (S // c) * _nbytes(head)
    # without remat each chunk's f32 logits are kept: B x S x V in all
    assert sum(np.prod(s) * 4 for s, dt in off.shapes
               if s == (B, c, V) and dt == torch.float32) >= B * S * V * 4


def _forward_saved(n_layers, remat, monkeypatch):
    """(bytes packed for the backward, bytes the regions' slots keep) of a
    reduced qwen2 forward at ``n_layers``."""
    m = get_arch("qwen2_0_5b").reduced().model
    cfg = dataclasses.replace(m, n_layers=n_layers)
    params = build_model(cfg).init(torch.Generator().manual_seed(0),
                                   device="cpu")
    params = tree_map(lambda w: w.requires_grad_(True), params)
    tokens = torch.from_numpy(np.random.default_rng(6).integers(
        0, cfg.vocab, (2, SEQ)))
    slots = []

    class Slot(_RematSlot):
        def __init__(self, save_weights):
            super().__init__(save_weights)
            slots.append(self)

    monkeypatch.setattr(hints, "RematSlot", Slot)
    with hints.remat_mode(remat), _Saved() as saved:
        TT.forward_hidden(params, tokens, cfg)
    return saved.bytes, sum(_nbytes(*s.kept) for s in slots), cfg


def test_transformer_forward_keeps_per_layer_its_input_and_kv(monkeypatch):
    """Per layer the backward keeps the layer's arguments: its input, its
    positions and its weights (views of the stacked leaves, which it does
    not copy). Off a grid nothing is gathered, so the slots keep no K/V:
    the recompute runs the whole layer, K/V included."""
    out1, kept1, cfg = _forward_saved(2, True, monkeypatch)
    out2, kept2, _ = _forward_saved(4, True, monkeypatch)
    B, S, D = 2, SEQ, cfg.d_model
    x_bytes = B * S * D * 4
    params = build_model(cfg).init(torch.Generator().manual_seed(0),
                                   device="cpu")
    w_bytes = sum(_nbytes(*tree_leaves(lp))
                  for lp in TT._layer_params(params, cfg)[:1])
    arg_bytes = x_bytes + S * 8 + w_bytes
    # two layers more: two more layers' arguments packed, no K/V kept
    assert out2 - out1 == 2 * arg_bytes
    assert kept1 == kept2 == 0
    off1, none1, _ = _forward_saved(2, False, monkeypatch)
    off2, none2, _ = _forward_saved(4, False, monkeypatch)
    assert none1 == none2 == 0
    per_layer_off = (off2 - off1) // 2
    print(f"a layer keeps {x_bytes} bytes of activations with remat, "
          f"{per_layer_off - w_bytes} without")
    assert per_layer_off - w_bytes > 4 * x_bytes


# ---------------------------------------------------------------------------
# held against the reference
# ---------------------------------------------------------------------------

SIGMA, CLR, SLR = 0.01, 0.05, 0.5


@pytest.mark.parametrize("remat", [True, False])
def test_zsign_round_held_against_the_reference(remat):
    """The reduced qwen2 round of ``test_torch_round.py`` through
    ``build_round_step`` with remat on (the default) and off: the wire
    bits it sends are the reference's but for its gradients' float
    differences, and the params it moves without such a difference are the
    reference's."""
    jarch = j_get_arch("qwen2_0_5b").reduced()
    jb = j_build(jarch.model)
    tb = build_model(get_arch("qwen2_0_5b").reduced().model)
    jparams = jb.init(jax.random.PRNGKey(0))
    tokens = np.asarray(JTokenStream(vocab=jarch.model.vocab).round_batch(
        0, (1, 3, 2, 2), SEQ))
    jcomp = JC.ZSignCompressor(z=1, sigma=SIGMA)
    jcfg = JF.FedConfig(n_clients=3, local_steps=2, client_lr=CLR,
                        server_lr=SLR)
    jstep = jax.jit(JF.build_round_step(
        jb.loss_fn, jcomp, jcfg, JF.RoundContext(weights_are_mask=True)))
    js0 = JF.init_server_state(jparams, jcfg, jcomp, jax.random.PRNGKey(1),
                               sigma0=SIGMA)
    js1, jm = jstep(js0, {"tokens": jnp.asarray(tokens)}, jnp.ones((1, 3)))

    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tb.cfg,
                                "cpu")
    tcomp = TC.ZSignCompressor(z=1, sigma=SIGMA)
    tcfg = TF.FedConfig(n_clients=3, local_steps=2, client_lr=CLR,
                        server_lr=SLR)
    tstep = TF.build_round_step(tb.loss_fn, tcomp, tcfg,
                                TF.RoundContext(weights_are_mask=True),
                                remat=remat)
    ts0 = TF.init_server_state(tparams, tcfg, tcomp, TN.prng_key(1),
                               sigma0=SIGMA)
    ts1, tm = tstep(ts0, {"tokens": torch.tensor(tokens).long()},
                    np.ones((1, 3), np.float32))

    np.testing.assert_allclose(float(tm.loss), float(jm.loss), rtol=1e-4)
    spec = JW.tree_spec(jparams)
    p0 = np.asarray(spec.flatten(jparams))
    pj = np.asarray(spec.flatten(js1.params))
    pt = TW.tree_spec(ts1.params).flatten(ts1.params).numpy()
    unit = SLR * CLR * JN.eta_z(1) * SIGMA / 3
    sj = np.rint((p0 - pj) / unit)
    st = np.rint((p0 - pt) / unit)
    assert set(np.unique(sj)) <= {-3, -1, 1, 3}
    frac = np.abs(sj - st).sum() / 2 / (3 * spec.n_coords)
    assert frac < 1e-3
    same = sj == st
    np.testing.assert_allclose(pt[same], pj[same], rtol=0, atol=1e-6)
