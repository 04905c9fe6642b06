"""The CUDA kernels E1 (zsign_encode) and R1 (sign_reduce) against their
plain PyTorch versions, on the card. Marked ``cuda``: they skip without a
card, and import neither jax nor the reference, so the machine with the
card runs them as they are:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

E1 must give the plain version's exact bytes (z=1: any differing bit within
4 ulp of its threshold, the erf rule); R1 equal int32 bit patterns.
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
