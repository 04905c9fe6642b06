"""granite-3-8b [hf:ibm-granite/granite-3.0-2b-base family; hf]
40L d_model=4096 32H (GQA kv=8) d_ff=12800 vocab=49155."""
import torch

from repro_torch.configs.common import ArchConfig
from repro_torch.models.api import ModelCfg

ARCH = ArchConfig(
    arch_id="granite_3_8b",
    source="hf:ibm-granite/granite-3.0-8b-base",
    model=ModelCfg(name="granite-3-8b", family="dense",
                   n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8,
                   d_ff=12800, vocab=49155, dtype=torch.bfloat16),
    notes="dense GQA")
