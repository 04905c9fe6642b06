"""Architecture registry and shape grid (port of ``repro.configs.common``):
the ten archs of the reference, every family, and the four cells of the
analytic roofline (``launch/roofline.py``)."""
from __future__ import annotations

import dataclasses
import importlib

import torch

from repro_torch.models.api import ModelCfg


@dataclasses.dataclass(frozen=True)
class ShapeCfg:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeCfg("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeCfg("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeCfg("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeCfg("long_500k", "decode", 524_288, 1),
}


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    arch_id: str
    model: ModelCfg
    source: str                      # public-literature citation tag
    big: bool = False                # sequential client groups on one pod,
    #                                  one client per pod on several
    #                                  (``launch/sharding.make_plan``)
    seq_client_groups: int = 4       # sequential clients when big
    local_steps: int = 1             # E of the roofline's train cell
    #: the dry run's train cell (``launch/dryrun.build_train_cell``): the
    #: client and server learning rates and the default zsign codec
    client_lr: float = 0.01
    server_lr: float = 1.0
    zsign_z: int = 1                 # 1 = Gaussian, 0 = uniform (z=inf)
    zsign_sigma: float = 0.01
    notes: str = ""

    def reduced(self) -> "ArchConfig":
        """Tiny same-family f32 config for CPU tests (the reference's
        shrink rule: one hybrid super-block of 8 sublayers, one xLSTM group
        of 4 blocks, 2 layers elsewhere)."""
        m = self.model
        n_kv = max(1, min(m.n_kv_heads, 2)) if m.n_kv_heads < m.n_heads else 4
        layers = {"hybrid": 8, "xlstm": 4}.get(m.family, 2)
        red = dataclasses.replace(
            m, n_layers=layers, d_model=64, n_heads=4, n_kv_heads=n_kv,
            d_ff=0 if m.d_ff == 0 else 128, vocab=min(m.vocab, 997),
            moe_experts=min(m.moe_experts, 4) if m.moe_experts else 0,
            moe_topk=min(m.moe_topk, 2) if m.moe_topk else 0,
            sliding_window=min(m.sliding_window, 8) if m.sliding_window else 0,
            n_img_tokens=4 if m.n_img_tokens else 0,
            dtype=torch.float32)
        return dataclasses.replace(self, model=red)


#: every arch of the reference's registry
_ARCH_IDS = [
    "granite_moe_1b_a400m", "llama4_scout_17b_a16e", "granite_3_8b",
    "qwen2_0_5b", "h2o_danube_3_4b", "qwen2_5_32b", "jamba_1_5_large_398b",
    "xlstm_350m", "internvl2_1b", "seamless_m4t_large_v2",
]


def list_archs():
    return list(_ARCH_IDS)


def get_arch(arch_id: str) -> ArchConfig:
    arch_id = arch_id.replace("-", "_").replace(".", "_")
    if arch_id not in _ARCH_IDS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {_ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{arch_id}").ARCH
