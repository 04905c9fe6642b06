"""xlstm-350m [arXiv:2405.04517; unverified]
24L d_model=1024 4H d_ff=0 vocab=50304; sLSTM + mLSTM blocks (3:1)."""
import torch

from repro_torch.configs.common import ArchConfig
from repro_torch.models.api import ModelCfg

ARCH = ArchConfig(
    arch_id="xlstm_350m",
    source="arXiv:2405.04517 (unverified)",
    model=ModelCfg(name="xlstm-350m", family="xlstm",
                   n_layers=24, d_model=1024, n_heads=4, n_kv_heads=4,
                   d_ff=0, vocab=50304, dtype=torch.bfloat16,
                   remat_save_weights=True),
    notes="recurrent: O(1) decode state => runs long_500k")
