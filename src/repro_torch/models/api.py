"""Model API (port of ``repro.models.api``): ModelCfg + build_model ->
ModelBundle for every family of the reference (dense, moe, vlm, hybrid,
xlstm, encdec), and ``params_from_numpy`` to carry the reference's weights
across. Entry points put what they make on ``cuda`` unless the caller
passes ``device="cpu"``; ``cuda`` without a card raises."""
from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.tree import tree_paths, tree_set
from repro_torch.models import layers as L


@dataclasses.dataclass(frozen=True)
class ModelCfg:
    name: str
    family: str                 # dense | moe | hybrid | xlstm | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    moe_experts: int = 0
    moe_topk: int = 0
    #: expert-parallel experts (big experts: llama4, jamba): on a grid the
    #: dispatch buffer goes to the experts' ranks by an all-to-all over the
    #: sequence axes instead of the experts being gathered; one process
    #: computes the same function either way
    moe_ep: bool = False
    qkv_bias: bool = False
    sliding_window: int = 0
    tie_embeddings: bool = True
    rope_theta: float = 1e4
    dtype: Any = torch.float32
    n_img_tokens: int = 0       # vlm stub prefix length
    src_frac: float = 0.5       # encdec: fraction of seq_len used as source
    q_chunk: int = 512
    #: under a grid, keep the FSDP-gathered layer weights across the
    #: layer's remat (one gather a layer a round instead of two, for the
    #: layers' gathered bytes of memory); no effect off a grid
    remat_save_weights: bool = False

    @property
    def d_head(self) -> int:
        return self.d_model // self.n_heads

    def attn_cfg(self) -> L.AttnCfg:
        return L.AttnCfg(d_model=self.d_model, n_heads=self.n_heads,
                         n_kv_heads=self.n_kv_heads, d_head=self.d_head,
                         qkv_bias=self.qkv_bias,
                         sliding_window=self.sliding_window,
                         rope_theta=self.rope_theta, q_chunk=self.q_chunk)

    def attn_cfg_bidir(self) -> L.AttnCfg:
        return dataclasses.replace(self.attn_cfg(), causal=False,
                                   sliding_window=0)


class BatchLeaf(NamedTuple):
    """Shape and dtype of one leaf of a per-step training batch (the
    reference's ``jax.ShapeDtypeStruct``)."""
    shape: tuple
    dtype: torch.dtype


@dataclasses.dataclass(frozen=True)
class ModelBundle:
    cfg: ModelCfg
    init: Callable                # (generator, device) -> params
    loss_fn: Callable             # (params, batch) -> scalar
    decode_step: Callable         # (params, cache, tokens, position)
    #                               -> (logits, cache)
    init_cache: Callable          # (batch, max_len, device) -> cache
    train_batch_spec: Callable    # (micro_batch, seq_len) -> {name: BatchLeaf}
    decode_supported: bool = True
    #: eligible for the long_500k cell (the reference's rule, per family)
    subquadratic: bool = False
    #: the serving prefill (the dry run's prefill cell): (params, tokens)
    #: -> f32 logits of the last position (B, 1, V); the enc-dec's (params,
    #: embeds (B, S_src, D)) -> the encoder memory's last frame (B, 1, D)
    prefill: Optional[Callable] = None


def check_device(device) -> torch.device:
    """``device`` as a torch device; ``cuda`` with no card visible raises
    (an entry point never falls back to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} was asked for but no CUDA card "
                           f"is visible (pass the device cpu, --device cpu "
                           f"on the command line, to run on the CPU)")
    return device


#: the module of each family (the reference's ``build_model`` branches)
_FAMILY_MODULE = {"dense": "transformer", "moe": "transformer",
                  "vlm": "transformer", "hybrid": "hybrid",
                  "xlstm": "xlstm", "encdec": "encdec"}
#: encdec's cross-attention memory length in the serving cache
ENCDEC_SRC_LEN = 2048


def family_module(cfg: ModelCfg):
    if cfg.family not in _FAMILY_MODULE:
        raise ValueError(f"unknown family {cfg.family!r}")
    return importlib.import_module(
        f"repro_torch.models.{_FAMILY_MODULE[cfg.family]}")


def _lm_specs(cfg: ModelCfg):
    def spec(micro, seq):
        return {"tokens": BatchLeaf((micro, seq), torch.int32)}
    return spec


def build_model(cfg: ModelCfg) -> ModelBundle:
    M = family_module(cfg)
    extra = {"src_len": ENCDEC_SRC_LEN} if cfg.family == "encdec" else {}

    def init(gen, device="cuda"):
        return M.init_params(gen, cfg, device=check_device(device))

    def init_cache(b, m, device="cuda"):
        return M.init_cache(cfg, b, m, device=check_device(device), **extra)

    common = dict(
        cfg=cfg, init=init, init_cache=init_cache,
        decode_step=lambda p, c, t, pos: M.decode_step(p, c, t, pos, cfg),
        # the reference's per-family rule: a sliding window makes the
        # decoder-only transformer sub-quadratic (not the VLM's), the
        # recurrent and hybrid families are, enc-dec is not
        subquadratic={"dense": cfg.sliding_window > 0,
                      "moe": cfg.sliding_window > 0, "vlm": False,
                      "hybrid": True, "xlstm": True,
                      "encdec": False}[cfg.family])
    common["prefill"] = lambda p, t: M.prefill(p, t, cfg)
    if cfg.family == "encdec":
        def encdec_spec(micro, seq):
            s_src = int(seq * cfg.src_frac)
            return {"embeds": BatchLeaf((micro, s_src, cfg.d_model),
                                        torch.float32),
                    "tokens": BatchLeaf((micro, seq - s_src), torch.int32)}
        return ModelBundle(loss_fn=lambda p, b: M.loss_fn(p, b, cfg),
                           train_batch_spec=encdec_spec, **common)
    if cfg.family != "vlm":
        return ModelBundle(loss_fn=lambda p, b: M.loss_fn(p, b, cfg),
                           train_batch_spec=_lm_specs(cfg), **common)

    def vlm_loss(p, b):
        # the image embeds (B, P, D) stand in for the first P tokens'
        # embeddings; the text's are looked up inside the model, in the
        # table a grid gathers (and whose gradient it sums)
        img, txt = b["img_embeds"], b["tokens"]
        B, P = img.shape[0], img.shape[1]
        S = P + txt.shape[1]
        dev = txt.device
        mask = torch.cat([torch.zeros((B, P), device=dev),
                          torch.ones((B, S - P), device=dev)], dim=1)
        # the image prefix's tokens are a pad id (0), loss-masked out
        full_tokens = torch.cat([torch.zeros((B, P), dtype=txt.dtype,
                                             device=dev), txt], dim=1)
        return M.loss_fn(p, {"tokens": full_tokens, "img_embeds": img,
                             "loss_mask": mask}, cfg)

    def vlm_spec(micro, seq):
        P = cfg.n_img_tokens
        return {"img_embeds": BatchLeaf((micro, P, cfg.d_model),
                                        torch.float32),
                "tokens": BatchLeaf((micro, seq - P), torch.int32)}

    return ModelBundle(loss_fn=vlm_loss, train_batch_spec=vlm_spec,
                       **common)


_NP_TO_TORCH = {"float32": torch.float32, "float16": torch.float16,
                "bfloat16": torch.bfloat16}


def _checked_leaves(tree, cfg: ModelCfg) -> dict:
    """{path: leaf} of a full parameter tree, after checking its names and
    shapes against the family's."""
    want = dict(tree_paths(family_module(cfg).param_shapes(cfg)))
    got = dict(tree_paths(tree))
    missing, extra = sorted(set(want) - set(got)), sorted(set(got) - set(want))
    if missing or extra:
        raise ValueError(f"parameter tree mismatch: missing {missing}, "
                         f"extra {extra}")
    for path, leaf in got.items():
        if tuple(leaf.shape) != tuple(want[path]):
            raise ValueError(f"{'.'.join(path)}: shape {tuple(leaf.shape)} "
                             f"!= {want[path]}")
    return got


def _numpy_leaf(path, arr, device) -> torch.Tensor:
    arr = np.asarray(arr)
    dtype = _NP_TO_TORCH.get(arr.dtype.name)
    if dtype is None:
        raise ValueError(f"{'.'.join(path)}: unsupported dtype {arr.dtype}")
    t = torch.from_numpy(np.ascontiguousarray(arr.astype(np.float32)))
    return t.to(device=device, dtype=dtype)


def params_from_numpy(tree, cfg: ModelCfg, device="cuda") -> dict:
    """The reference's parameters (a nested dict of numpy arrays, as
    ``jax.tree.map(np.asarray, params)`` gives them) -> the port's tree with
    the same names, shapes and dtypes (each leaf keeps its own: the MoE
    router is f32 in a bf16 model). Raises on a missing, extra or
    mis-shaped leaf."""
    device = check_device(device)
    out: dict = {}
    for path, arr in _checked_leaves(tree, cfg).items():
        tree_set(out, path, _numpy_leaf(path, arr, device))
    return out


def _slice(leaf, spec, grid):
    """``leaf`` cut along every dimension ``spec`` shards: the piece at
    this rank's index over each dimension's axes."""
    from repro_torch.launch.sharding import spec_dims
    idx = [slice(None)] * len(leaf.shape)
    for dim, axes in spec_dims(spec):
        n = 1
        for a in axes:
            n *= grid.shape[a]
        c = leaf.shape[dim] // n
        i = grid.index(axes)
        idx[dim] = slice(i * c, (i + 1) * c)
    return leaf[tuple(idx)]


def shard_params(tree, cfg: ModelCfg, grid, plan, device="cuda") -> dict:
    """This rank's shards of a full parameter tree (the reference's numpy
    arrays, as ``params_from_numpy`` takes them, or the port's tensors):
    each leaf cut along every dimension its spec shards
    (``launch/sharding.param_specs`` on ``grid`` under ``plan``; an MoE
    expert tensor of the big plan along two), the piece at this rank's
    index over each dimension's axes, on ``device`` in the leaf's dtype. A
    replicated leaf is copied whole."""
    from repro_torch.launch.sharding import param_specs
    device = check_device(device)
    specs = dict(tree_paths(param_specs(
        family_module(cfg).param_shapes(cfg), grid, plan,
        moe_experts=cfg.moe_experts), ))
    out: dict = {}
    for path, leaf in _checked_leaves(tree, cfg).items():
        leaf = _slice(leaf, specs[path], grid)
        if isinstance(leaf, torch.Tensor):
            piece = leaf.to(device=device).contiguous().clone()
        else:
            piece = _numpy_leaf(path, leaf, device)
        tree_set(out, path, piece)
    return out


def shard_cache(cache, cache_specs, grid, device="cuda") -> dict:
    """This rank's slice of a whole serving cache (a family's
    ``init_cache``, or a filled one) under its spec tree
    (``launch/sharding.cache_specs``), each leaf a contiguous copy on
    ``device``: the slice a grid decode step takes (a recurrent state's
    initial values are not all zeros)."""
    device = check_device(device)
    out: dict = {}
    for path, spec in tree_paths(cache_specs):
        leaf = cache
        for k in path:
            leaf = leaf[k]
        tree_set(out, path, _slice(leaf, spec, grid).to(
            device=device).contiguous().clone())
    return out
