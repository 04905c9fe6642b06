"""internvl2-1b [arXiv:2404.16821; hf]
LM backbone = qwen2-0.5b spec (24L d_model=896 14H kv=2 d_ff=4864,
vocab=151655); InternViT frontend is a STUB (precomputed patch embeds)."""
import torch

from repro_torch.configs.common import ArchConfig
from repro_torch.models.api import ModelCfg

ARCH = ArchConfig(
    arch_id="internvl2_1b",
    source="arXiv:2404.16821",
    model=ModelCfg(name="internvl2-1b", family="vlm",
                   n_layers=24, d_model=896, n_heads=14, n_kv_heads=2,
                   d_ff=4864, vocab=151655, qkv_bias=True,
                   n_img_tokens=256, dtype=torch.bfloat16,
                   remat_save_weights=True),
    notes="vlm: 256 stub image tokens prefixed; loss on text only")
