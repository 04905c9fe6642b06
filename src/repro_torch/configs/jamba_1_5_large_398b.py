"""jamba-1.5-large-398b [arXiv:2403.19887; hf]
72L d_model=8192 64H (GQA kv=8) d_ff=24576 vocab=65536,
Mamba:attn 7:1 interleave, MoE 16e top-2 on alternate sublayers."""
import torch

from repro_torch.configs.common import ArchConfig
from repro_torch.models.api import ModelCfg

ARCH = ArchConfig(
    arch_id="jamba_1_5_large_398b",
    source="arXiv:2403.19887",
    model=ModelCfg(name="jamba-1.5-large-398b", family="hybrid",
                   n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8,
                   d_ff=24576, vocab=65536, moe_experts=16, moe_topk=2,
                   moe_ep=True,
                   dtype=torch.bfloat16),
    big=True, seq_client_groups=2,
    notes="398B hybrid; sub-quadratic (mamba) => runs long_500k")
