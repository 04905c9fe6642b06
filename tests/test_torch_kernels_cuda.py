"""The CUDA kernels E1 (zsign_encode), R1 (sign_reduce), C1
(zsign_compress_rows), U1 (unpack_sum) and F1 (ef_sign_rows) against their
plain PyTorch versions, on the card. Marked ``cuda``: they skip without a
card, and import neither jax nor the reference, so the machine with the
card runs them as they are:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

E1 must give the plain version's exact bytes (z=1: any differing bit within
4 ulp of its threshold, the erf rule), also with a different sigma for each
client (sto-sign), a client with sigma 0, and over a flat range (``tile0``:
the byte slice of the whole rows' encode); C1 exact bytes; R1, U1 and F1 equal
int32 bit patterns (F1's payload bytes too); R1 as the robust laws' vote
pair route equal int32 to the popcount route.
"""
import pytest
import torch

from repro_torch.core import noise as TN
from repro_torch.kernels.zsign import ops as TO

TILE = TO.TILE


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 8, 13])
@pytest.mark.parametrize("z", [0, 1, None])
def test_cuda_encode_matches_plain(cuda, n, z):
    gen = torch.Generator(device=cuda).manual_seed(n)
    x = torch.randn((n, 5 * TILE), generator=gen, device=cuda) * 0.05
    keys = TN.client_keys(TN.prng_key(n), 0, n)
    for s in (0.0, 0.05):
        sig = torch.full((n,), s, device=cuda)
        before = TO.zsign_encode.launches
        got = TO.zsign_encode(x, keys, sig, z)
        torch.cuda.synchronize()
        assert TO.zsign_encode.launches == before + 1
        want = TO.zsign_encode_plain(x, keys, sig, z)
        flips, far = TO.erf_rule_flips(x, keys, sig, 0 if z is None else z,
                                       got, want)
        assert far == 0 and (z == 1 or flips == 0)
        for c in range(n):
            one = TO.zsign_encode(x[c:c + 1].contiguous(), keys[c:c + 1],
                                  sig[c:c + 1], z)
            assert torch.equal(one[0], got[c])


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("z", [0, 1])
def test_cuda_encode_over_a_range(cuda, n, z):
    """E1 with tile0 (the model-sharded replica's flat range): equal to its
    plain version with the same tile0, and to the byte slice of the whole
    rows' encode."""
    gen = torch.Generator(device=cuda).manual_seed(10 + n)
    x = torch.randn((n, 7 * TILE), generator=gen, device=cuda) * 0.05
    keys = TN.client_keys(TN.prng_key(n), 0, n)
    sig = torch.full((n,), 0.05, device=cuda)
    whole = TO.zsign_encode(x, keys, sig, z)
    for t0, t1 in [(3, 7), (1, 2), (0, 7)]:
        rows = x[:, t0 * TILE:t1 * TILE].contiguous()
        before = TO.zsign_encode.launches_range
        got = TO.zsign_encode(rows, keys, sig, z, tile0=t0)
        torch.cuda.synchronize()
        assert TO.zsign_encode.launches_range == before + 1
        want = TO.zsign_encode_plain(rows, keys, sig, z, tile0=t0)
        flips, far = TO.erf_rule_flips(rows, keys, sig, z, got, want,
                                       tile0=t0)
        assert far == 0 and (z == 1 or flips == 0)
        assert torch.equal(got, whole[:, t0 * TILE // 8:t1 * TILE // 8])


@pytest.mark.cuda
@pytest.mark.parametrize("n", [3, 8, 13])
@pytest.mark.parametrize("z", [0, 1])
def test_cuda_encode_per_client_sigma(cuda, n, z):
    """E1 with a sigma vector that differs across rows (the sto-sign route:
    each client's own norm), one row with sigma 0 (its noise-free pack):
    the plain version's bytes, each row those of its own n = 1 launch."""
    gen = torch.Generator(device=cuda).manual_seed(100 + n)
    x = torch.randn((n, 3 * TILE), generator=gen, device=cuda) * 0.05
    keys = TN.client_keys(TN.prng_key(n + 1), 0, n)
    sig = torch.rand((n,), generator=gen, device=cuda) * 0.2 + 0.01
    sig[n // 2] = 0.0
    got = TO.zsign_encode(x, keys, sig, z)
    want = TO.zsign_encode_plain(x, keys, sig, z)
    torch.cuda.synchronize()
    flips, far = TO.erf_rule_flips(x, keys, sig, z, got, want)
    assert far == 0 and (z == 1 or flips == 0)
    h = slice(n // 2, n // 2 + 1)
    noise_free = TO.zsign_encode_plain(x[h], keys[h], sig[h], None)
    assert torch.equal(got[n // 2], noise_free[0])
    for c in range(n):
        one = TO.zsign_encode(x[c:c + 1].contiguous(), keys[c:c + 1],
                              sig[c:c + 1], z)
        assert torch.equal(one[0], got[c])
    # a uniform sigma gives other bytes than the per-client vector
    flat = TO.zsign_encode(x, keys, torch.full_like(sig, float(sig[0])), z)
    assert not torch.equal(flat[1:], got[1:])


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 8, 13])
def test_cuda_sign_reduce_matches_plain(cuda, n):
    gen = torch.Generator(device=cuda).manual_seed(n)
    nb = 4099
    p = torch.randint(0, 256, (n, nb), generator=gen, device=cuda,
                      dtype=torch.uint8)
    acc = torch.randn((8 * nb,), generator=gen, device=cuda)
    for w in (torch.randn((n,), generator=gen, device=cuda),
              torch.randint(0, 2, (n,), generator=gen, device=cuda).float(),
              torch.zeros((n,), device=cuda)):
        for a in (None, acc):
            got = TO.sign_reduce(p, w, a)
            torch.cuda.synchronize()
            want = TO.sign_reduce_plain(p, w, a)
            assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def _ef_inputs(cuda, n, d, seed):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    d_pad = -(-d // TILE) * TILE
    g = torch.zeros((n, d_pad), device=cuda)
    g[:, :d] = torch.randn((n, d), generator=gen, device=cuda)
    e = torch.randn((n, d), generator=gen, device=cuda) * 0.3
    g[:, :d:7] = -e[:, ::7]                  # p == 0 exactly: packs as +1
    scale = torch.rand((n,), generator=gen, device=cuda) + 0.1
    return g, e, scale


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 3, 8])
@pytest.mark.parametrize("with_q", [False, True])
def test_cuda_ef_sign_matches_plain(cuda, n, with_q):
    from repro_torch.kernels.efsign import ops as EO
    d = 2 * TILE + 37
    g, e, scale = _ef_inputs(cuda, n, d, seed=n)
    live = torch.ones((n,), device=cuda)
    live[n // 2] = 0.0                        # one dead client
    for lv in (None, live):
        before = EO.ef_sign_rows.launches
        got = EO.ef_sign_rows(g, e, scale, live=lv, with_q=with_q)
        torch.cuda.synchronize()
        assert EO.ef_sign_rows.launches == before + 1
        want = EO.ef_sign_rows_plain(g, e, scale, live=lv, with_q=with_q)
        assert torch.equal(got[0], want[0])
        assert torch.equal(got[1].view(torch.int32), want[1].view(torch.int32))
        if with_q:
            assert torch.equal(got[2].view(torch.int32),
                               want[2].view(torch.int32))
    # in place over the residual: dead rows keep their bits
    e2 = e.clone()
    packed, out, _ = EO.ef_sign_rows(g, e2, scale, live=live, in_place=True)
    torch.cuda.synchronize()
    want = EO.ef_sign_rows_plain(g, e, scale, live=live)
    assert out.data_ptr() == e2.data_ptr()
    assert torch.equal(packed, want[0])
    assert torch.equal(e2.view(torch.int32), want[1].view(torch.int32))
    assert torch.equal(e2[n // 2], e[n // 2])


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 3, 8])
def test_cuda_zsign_compress_matches_plain(cuda, n):
    gen = torch.Generator(device=cuda).manual_seed(n)
    d = 3 * TILE + 5
    x = torch.zeros((n, 4 * TILE), device=cuda)
    nz = torch.zeros_like(x)
    x[:, :d] = torch.randn((n, d), generator=gen, device=cuda) * 0.05
    nz[:, :d] = torch.randn((n, d), generator=gen, device=cuda)
    sig = torch.rand((n,), generator=gen, device=cuda) * 0.1
    x[:, :d:5] = -(sig.reshape(n, 1) * nz[:, :d:5])   # y == 0 unfused
    for s in (sig, torch.zeros_like(sig)):
        before = TO.zsign_compress_rows.launches
        got = TO.zsign_compress_rows(x, nz, s)
        torch.cuda.synchronize()
        assert TO.zsign_compress_rows.launches == before + 1
        assert torch.equal(got, TO.zsign_compress_rows_plain(x, nz, s))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 3, 8])
def test_cuda_unpack_sum_matches_plain(cuda, n):
    gen = torch.Generator(device=cuda).manual_seed(n)
    p = torch.randint(0, 256, (n, 4099), generator=gen, device=cuda,
                      dtype=torch.uint8)
    before = TO.unpack_sum.launches
    got = TO.unpack_sum(p)
    torch.cuda.synchronize()
    assert TO.unpack_sum.launches == before + 1
    want = TO.unpack_sum_plain(p)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("shards", [(3, 5, 8, 1, 13), (8, 8), (6, 6, 6),
                                    (1, 1, 1, 1, 1, 1, 1, 2)])
def test_cuda_sign_fold_matches_plain(cuda, shards):
    """R1 in fold mode (sign_fold_step / sign_fold_finalize) against its
    plain version on the same shard sequence, with and without pending
    rows at the end; the launches are the complete 8-row blocks plus one
    to close a pending block."""
    from repro_torch.core import wire as TW
    n, nb = sum(shards), 4099
    gen = torch.Generator(device=cuda).manual_seed(n)
    p = torch.randint(0, 256, (n, nb), generator=gen, device=cuda,
                      dtype=torch.uint8)
    w = torch.randn((n,), generator=gen, device=cuda)
    w[:8] = -0.0                              # a first block of +-0.0 sums
    got = TW.sign_fold_init(nb, cuda)
    want = TW.sign_fold_init(nb, "cpu")
    before = (TO.sign_reduce.launches, TO.sign_reduce.fold_launches)
    want_launches, pend, lo = 0, 0, 0
    for k in shards:
        got = TO.sign_fold_step(p[lo:lo + k], w[lo:lo + k], got)
        want = TO.sign_fold_step(p[lo:lo + k].cpu(), w[lo:lo + k].cpu(),
                                 want)
        want_launches += (pend + k) // 8 > 0
        pend = (pend + k) % 8
        lo += k
        assert got.pend_n == want.pend_n == pend
    out = TO.sign_fold_finalize(got)
    torch.cuda.synchronize()
    want_launches += pend > 0
    assert TO.sign_reduce.launches - before[0] == want_launches
    assert TO.sign_reduce.fold_launches - before[1] == want_launches
    ref = TO.sign_fold_finalize(want)
    assert torch.equal(out.cpu().view(torch.int32), ref.view(torch.int32))
    one_shot = TO.sign_reduce_plain(p.cpu(), w.cpu())
    assert torch.equal(ref.view(torch.int32), one_shot.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("spec", ["efsign", "ef|zsign"])
def test_cuda_noise_free_ef_encode_launches_e1(cuda, spec):
    """The noise-free mean-|p| encode (``--compressor efsign``) packs on the
    card through E1 with z=None: one launch a round, bytes equal to the
    plain pack."""
    from repro_torch.core import compression as TC
    from repro_torch.core import fedavg as TF
    n, d = 4, 3 * TILE + 11
    comp = TC.EFSignCompressor() if spec == "efsign" else TC.Pipeline(spec)
    cfg = TF.FedConfig(n_clients=n, client_lr=0.01)
    step = TF.build_round_step(
        lambda p, b: 0.5 * torch.sum((p["x"] - b["y"]) ** 2), comp, cfg)
    st = TF.init_server_state({"x": torch.zeros(d, device=cuda)}, cfg, comp,
                              TN.prng_key(2))
    gen = torch.Generator(device=cuda).manual_seed(3)
    y = torch.randn((1, n, 1, d), generator=gen, device=cuda)
    before = TO.zsign_encode.launches
    for _ in range(2):
        st, m = step(st, {"y": y}, torch.ones((1, n)))
    torch.cuda.synchronize()
    assert TO.zsign_encode.launches - before == 2
    x2d = torch.zeros((n, 4 * TILE), device=cuda)
    x2d[:, :d] = torch.randn((n, d), generator=gen, device=cuda)
    keys = TN.client_keys(TN.prng_key(1), 0, n)
    payload, _ = comp.codec.encode_with_decode_batch(keys, x2d, d)
    assert torch.equal(payload["packed"], TO.zsign_encode_plain(
        x2d, keys, torch.zeros(n, device=cuda), None))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [5, 13])
def test_cuda_vote_pair_r1_route_matches_popcount(cuda, n):
    """The robust laws' vote pair on the kernel route (R1's masked sign
    sum cast to int32) against the plain popcount route, n not a multiple
    of 8, a dead client, with and without a carried pair: equal int32."""
    from repro_torch.core import compression as TC
    from repro_torch.core import wire as TW
    gen = torch.Generator(device=cuda).manual_seed(200 + n)
    packed = torch.randint(0, 256, (n, 5 * 1024 + 7), generator=gen,
                           device=cuda, dtype=torch.uint8)
    mask = torch.ones((n,), device=cuda)
    mask[2] = 0.0
    before = TO.sign_reduce.launches
    got = TC.vote_pair(packed, mask, "cuda")
    torch.cuda.synchronize()
    assert TO.sign_reduce.launches == before + 1
    want = TW.vote_accumulator(packed, mask)
    assert got.dtype == want.dtype == torch.int32
    assert torch.equal(got, want)
    assert torch.equal(TC.vote_pair(packed, mask, "cuda", got),
                       TW.vote_accumulator(packed, mask, want))
    assert int(got[1, 0]) == n - 1
