"""granite-moe-1b-a400m [hf:ibm-granite/granite-3.0-1b-a400m-base; hf]
24L d_model=1024 16H (GQA kv=8) d_ff=512/expert vocab=49155, MoE 32e top-8."""
import torch

from repro_torch.configs.common import ArchConfig
from repro_torch.models.api import ModelCfg

ARCH = ArchConfig(
    arch_id="granite_moe_1b_a400m",
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
    model=ModelCfg(name="granite-moe-1b-a400m", family="moe",
                   n_layers=24, d_model=1024, n_heads=16, n_kv_heads=8,
                   d_ff=512, vocab=49155, moe_experts=32, moe_topk=8,
                   dtype=torch.bfloat16),
    notes="fine-grained MoE: 32 small experts, top-8 routing")
