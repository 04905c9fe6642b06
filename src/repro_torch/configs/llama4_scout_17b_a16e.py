"""llama4-scout-17b-a16e [hf:meta-llama/Llama-4-Scout-17B-16E; unverified]
48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048, MoE 16e top-1."""
import torch

from repro_torch.configs.common import ArchConfig
from repro_torch.models.api import ModelCfg

ARCH = ArchConfig(
    arch_id="llama4_scout_17b_a16e",
    source="hf:meta-llama/Llama-4-Scout-17B-16E (unverified)",
    model=ModelCfg(name="llama4-scout-17b-a16e", family="moe",
                   n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
                   d_ff=8192, vocab=202048, moe_experts=16, moe_topk=1,
                   moe_ep=True,
                   tie_embeddings=True, dtype=torch.bfloat16),
    big=True, seq_client_groups=4,
    notes="~109B total / 17B active; early-fusion frontend out of scope "
          "for the LM cells (text backbone per assignment)")
