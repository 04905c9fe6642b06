"""h2o-danube-3-4b [arXiv:2401.16818; unverified]
24L d_model=3840 32H (GQA kv=8) d_ff=10240 vocab=32000, sliding window."""
import torch

from repro_torch.configs.common import ArchConfig
from repro_torch.models.api import ModelCfg

ARCH = ArchConfig(
    arch_id="h2o_danube_3_4b",
    source="arXiv:2401.16818 (unverified)",
    model=ModelCfg(name="h2o-danube-3-4b", family="dense",
                   n_layers=24, d_model=3840, n_heads=32, n_kv_heads=8,
                   d_ff=10240, vocab=32000, sliding_window=4096,
                   dtype=torch.bfloat16),
    notes="llama+mistral mix: SWA(4096) => sub-quadratic, runs long_500k")
