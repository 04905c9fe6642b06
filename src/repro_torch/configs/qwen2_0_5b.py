"""qwen2-0.5b [arXiv:2407.10671; hf]
24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151936, QKV bias."""
import torch

from repro_torch.configs.common import ArchConfig
from repro_torch.models.api import ModelCfg

ARCH = ArchConfig(
    arch_id="qwen2_0_5b",
    source="arXiv:2407.10671",
    model=ModelCfg(name="qwen2-0.5b", family="dense",
                   n_layers=24, d_model=896, n_heads=14, n_kv_heads=2,
                   d_ff=4864, vocab=151936, qkv_bias=True,
                   dtype=torch.bfloat16,
                   remat_save_weights=True),
    notes="GQA kv=2, QKV bias, tied embeddings")
