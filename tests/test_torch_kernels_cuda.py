"""The CUDA kernels E1 (zsign_encode), R1 (sign_reduce), C1
(zsign_compress_rows), U1 (unpack_sum) and F1 (ef_sign_rows) against their
plain PyTorch versions, on the card. Marked ``cuda``: they skip without a
card, and import neither jax nor the reference, so the machine with the
card runs them as they are:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

E1 must give the plain version's exact bytes (z=1: any differing bit within
4 ulp of its threshold, the erf rule); C1 exact bytes; R1, U1 and F1 equal
int32 bit patterns (F1's payload bytes too).
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
