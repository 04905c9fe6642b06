"""Model API (port of ``repro.models.api``): ModelCfg + build_model ->
ModelBundle, for the dense family, and ``params_from_numpy`` to carry the
reference's weights across."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core.tree import tree_paths, tree_set
from repro_torch.models import layers as L


@dataclasses.dataclass(frozen=True)
class ModelCfg:
    name: str
    family: str                 # dense (the one family ported so far)
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    qkv_bias: bool = False
    sliding_window: int = 0
    tie_embeddings: bool = True
    rope_theta: float = 1e4
    dtype: Any = torch.float32
    q_chunk: int = 512

    @property
    def d_head(self) -> int:
        return self.d_model // self.n_heads

    def attn_cfg(self) -> L.AttnCfg:
        return L.AttnCfg(d_model=self.d_model, n_heads=self.n_heads,
                         n_kv_heads=self.n_kv_heads, d_head=self.d_head,
                         qkv_bias=self.qkv_bias,
                         sliding_window=self.sliding_window,
                         rope_theta=self.rope_theta, q_chunk=self.q_chunk)


@dataclasses.dataclass(frozen=True)
class ModelBundle:
    cfg: ModelCfg
    init: Callable                # (generator, device) -> params
    loss_fn: Callable             # (params, {"tokens": (B, S)}) -> scalar


def build_model(cfg: ModelCfg) -> ModelBundle:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"model family {cfg.family!r} is not yet ported (ROADMAP queue "
            f"1 item 16); the port has the dense transformer")
    from repro_torch.models import transformer as T
    return ModelBundle(
        cfg=cfg,
        init=lambda gen, device="cpu": T.init_params(gen, cfg, device),
        loss_fn=lambda p, b: T.loss_fn(p, b, cfg))


_NP_TO_TORCH = {"float32": torch.float32, "float16": torch.float16,
                "bfloat16": torch.bfloat16}


def params_from_numpy(tree, cfg: ModelCfg, device="cpu") -> dict:
    """The reference's parameters (a nested dict of numpy arrays, as
    ``jax.tree.map(np.asarray, params)`` gives them) -> the port's tree with
    the same names, shapes and dtypes. Raises on a missing, extra or
    mis-shaped leaf."""
    from repro_torch.models.transformer import param_shapes
    want = dict(tree_paths(param_shapes(cfg)))
    got = dict(tree_paths(tree))
    missing, extra = sorted(set(want) - set(got)), sorted(set(got) - set(want))
    if missing or extra:
        raise ValueError(f"parameter tree mismatch: missing {missing}, "
                         f"extra {extra}")
    out: dict = {}
    for path, arr in got.items():
        arr = np.asarray(arr)
        if tuple(arr.shape) != tuple(want[path]):
            raise ValueError(f"{'.'.join(path)}: shape {arr.shape} != "
                             f"{want[path]}")
        dtype = _NP_TO_TORCH.get(arr.dtype.name)
        if dtype is None:
            raise ValueError(f"{'.'.join(path)}: unsupported dtype "
                             f"{arr.dtype}")
        t = torch.from_numpy(np.ascontiguousarray(arr.astype(np.float32)))
        tree_set(out, path, t.to(device=device, dtype=dtype))
    return out
