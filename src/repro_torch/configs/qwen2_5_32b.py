"""qwen2.5-32b [hf:Qwen/Qwen2.5-32B; hf]
64L d_model=5120 40H (GQA kv=8) d_ff=27648 vocab=152064, QKV bias."""
import torch

from repro_torch.configs.common import ArchConfig
from repro_torch.models.api import ModelCfg

ARCH = ArchConfig(
    arch_id="qwen2_5_32b",
    source="hf:Qwen/Qwen2.5-32B",
    model=ModelCfg(name="qwen2.5-32b", family="dense",
                   n_layers=64, d_model=5120, n_heads=40, n_kv_heads=8,
                   d_ff=27648, vocab=152064, qkv_bias=True,
                   tie_embeddings=False, dtype=torch.bfloat16),
    big=True, seq_client_groups=2,
    notes="32B dense: per-client replica needs >16-way sharding => "
          "sequential clients single-pod, per-pod clients multi-pod")
