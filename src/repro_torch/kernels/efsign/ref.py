"""Plain oracle of the fused EF-SignSGD update (port of
``repro.kernels.efsign.ref``)."""
import torch


def ef_sign_update_ref(g: torch.Tensor, e: torch.Tensor, scale):
    """p = g + e; q = scale * Sign(p); e' = p - q. Returns (q, e').

    Sign convention is ``p >= 0 -> +1`` (the bitpacked wire's), so the
    residual accounts exactly for what the server decodes, p == 0
    coordinates included."""
    p = g + e
    one = torch.ones((), dtype=p.dtype, device=p.device)
    q = scale * torch.where(p >= 0, one, -one)
    return q, p - q
