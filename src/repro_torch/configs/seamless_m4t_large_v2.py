"""seamless-m4t-large-v2 [arXiv:2308.11596; hf]
enc-dec, 24L per stack, d_model=1024 16H (kv=16) d_ff=8192 vocab=256206;
speech frontend is a STUB (precomputed frame embeddings)."""
import torch

from repro_torch.configs.common import ArchConfig
from repro_torch.models.api import ModelCfg

ARCH = ArchConfig(
    arch_id="seamless_m4t_large_v2",
    source="arXiv:2308.11596",
    model=ModelCfg(name="seamless-m4t-large-v2", family="encdec",
                   n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
                   d_ff=8192, vocab=256206, dtype=torch.bfloat16,
                   remat_save_weights=True),
    notes="24 enc + 24 dec; train seq split src:tgt 50:50")
