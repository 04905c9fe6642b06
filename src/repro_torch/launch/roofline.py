"""Analytic roofline terms per (arch x shape x plan) on the port's card
(port of the analytic half of ``repro.launch.roofline`` and ``dryrun``).

    PYTHONPATH=src python -m repro_torch.launch.roofline \\
        --arch qwen2_0_5b --shape train_4k --devices 2 [--json out.json]

prints one JSON result with the fields ``launch/report.py`` renders (its
"HBM/dev" column is the weight replica a device holds). The
terms are the reference's accounting, with the device count and the chip
as arguments instead of its TPU pod constants:

  fwd matmul FLOPs      = 2 * N_active_matmul * tokens
  bwd                   = 2x fwd;  full remat adds ~1x fwd  -> 8 N D total
  attention (causal)    = 2 * S^2 * H * hd * B per layer fwd (qk + av, halved)
  MODEL_FLOPS (useful)  = 6 * N_active * D

Parameter counts come from the port's own parameter trees, built on the
``meta`` device (nothing is allocated, at any width). The collective term
is the bytes the busiest rank moves in the round's one cross-rank reduce,
as ``core.wire.reduce_accumulator`` counts them (``REDUCE_STATS``), for a
1-bit sign wire's f32 accumulator. The model-sharded replica's dry run
(``launch/dryrun.py``, the counterpart of the reference's AOT compile)
traces the sharded round step on a fake process group and hands its
counted collective bytes to ``terms_for``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Dict, List, Optional

import torch


@dataclasses.dataclass(frozen=True)
class Chip:
    """Peak rates of one device: dense FLOP/s of the model's matmul type,
    memory bytes/s, interconnect bytes/s per direction."""
    name: str
    peak_flops: float
    hbm_bw: float
    link_bw: float


#: the package's one chip: NVIDIA H100 SXM5 80 GB (NVIDIA H100 Tensor Core
#: GPU datasheet: 989.4 TFLOP/s dense BF16, 3.35 TB/s HBM3, NVLink 900 GB/s
#: both directions = 450 GB/s each way)
H100 = Chip("H100 SXM 80GB", 989.4e12, 3.35e12, 450e9)


def param_counts(arch) -> Dict[str, int]:
    """Exact counts from the port's parameter tree of ``arch`` (shapes
    only, nothing allocated)."""
    from repro_torch.core.tree import tree_paths
    from repro_torch.models.api import build_model, family_module
    cfg = build_model(arch.model).cfg
    total = expert = embed = 0
    for keys, shape in tree_paths(family_module(cfg).param_shapes(cfg)):
        n = 1
        for d in shape:
            n *= d
        total += n
        if "moe" in keys and keys[-1] in ("w1", "w2", "w3"):
            expert += n
        if keys[-1] in ("embed", "lm_head"):
            embed += n
    m = arch.model
    active = total - (expert - expert * m.moe_topk / max(1, m.moe_experts))
    return {"total": int(total), "expert": int(expert), "embed": int(embed),
            "active": int(active),
            "matmul_active": int(active - embed +
                                 (m.d_model * m.vocab))}  # lm head matmul


def _attn_flops_fwd(m, tokens_per_seq: int, n_seqs: int,
                    causal=True) -> float:
    if m.family == "xlstm":
        # mLSTM quadratic form on 3/4 of layers + sLSTM linear
        n_q = m.n_layers * 3 // 4
        f = 4 * tokens_per_seq ** 2 * m.d_model * n_seqs * n_q * 0.5
        return f
    n_attn = m.n_layers
    if m.family == "hybrid":
        n_attn = m.n_layers // 8
    if m.family == "encdec":
        # enc self (bidir) + dec self (causal) on seq/2 each + cross
        s = tokens_per_seq // 2
        per = (4 * s * s * m.n_heads * (m.d_model // m.n_heads))
        return n_seqs * m.n_layers * (per + per * 0.5 + per)
    S = tokens_per_seq
    eff = S if m.sliding_window == 0 else min(S, 2 * m.sliding_window)
    per = 4 * S * eff * m.n_heads * (m.d_model // m.n_heads)
    return n_seqs * n_attn * per * (0.5 if causal and m.sliding_window == 0
                                    else 1.0)


@dataclasses.dataclass
class Terms:
    flops_per_dev: float
    hbm_bytes_per_dev: float
    coll_bytes_per_dev: float
    model_flops_total: float
    devices: int
    chip: Chip = H100

    def seconds(self):
        return {"compute": self.flops_per_dev / self.chip.peak_flops,
                "memory": self.hbm_bytes_per_dev / self.chip.hbm_bw,
                "collective": self.coll_bytes_per_dev / self.chip.link_bw}

    def dominant(self):
        s = self.seconds()
        return max(s, key=s.get)

    def roofline_fraction(self):
        """useful-compute time / max(term)."""
        s = self.seconds()
        t_useful = (self.model_flops_total / self.devices) / \
            self.chip.peak_flops
        return t_useful / max(s.values())


def _bytesize(m) -> int:
    return 2 if m.dtype == torch.bfloat16 else 4


def _replica_ways(plan, devices: int) -> int:
    """Devices that share one client's weight replica: all the devices
    over the clients that run side by side (the reference's 16 of a
    (16, 16) pod and 256 for a big arch; 1 for the port's ranks, each of
    which holds the whole model)."""
    side_by_side = plan.n_clients if plan.client_axes else 1
    return max(1, devices // side_by_side)


def train_terms(arch, shape, plan, coll_bytes_per_dev: float, devices: int,
                chip: Chip = H100) -> Terms:
    m = arch.model
    pc = param_counts(arch)
    n_dev = devices
    tokens = shape.global_batch * shape.seq_len * plan.local_steps
    n_seqs = shape.global_batch * plan.local_steps

    mm = 2.0 * pc["matmul_active"] * tokens          # fwd matmul
    at = _attn_flops_fwd(m, shape.seq_len, n_seqs)
    fwd = mm + at
    total_flops = 4.0 * fwd                          # fwd + bwd(2x) + remat(1x)
    model_flops = 6.0 * pc["active"] * tokens

    # memory traffic, per device: the weight replica shard read 3x (fwd,
    # remat, bwd) a client pass + grad write + server update rw; ~12
    # d_model-sized reads/writes per token per layer, x3 passes
    bytesize = _bytesize(m)
    w_dev = pc["total"] * bytesize / _replica_ways(plan, n_dev)
    tok_dev = tokens / n_dev
    act = tok_dev * m.d_model * bytesize * 12 * m.n_layers * 3
    w_traffic = w_dev * (3 * plan.client_groups + 4)
    hbm = w_traffic + act
    return Terms(total_flops / n_dev, hbm, coll_bytes_per_dev,
                 model_flops, n_dev, chip)


def prefill_terms(arch, shape, plan, coll_bytes_per_dev: float,
                  devices: int, chip: Chip = H100) -> Terms:
    m = arch.model
    pc = param_counts(arch)
    n_dev = devices
    tokens = shape.global_batch * shape.seq_len
    mm = 2.0 * (pc["matmul_active"] - m.d_model * m.vocab) * tokens \
        + 2.0 * m.d_model * m.vocab * shape.global_batch  # last-token head
    at = _attn_flops_fwd(m, shape.seq_len, shape.global_batch)
    total = mm + at
    model_flops = total
    bytesize = _bytesize(m)
    w_dev = pc["total"] * bytesize / n_dev
    act = tokens / n_dev * m.d_model * bytesize * 12
    return Terms(total / n_dev, w_dev + act, coll_bytes_per_dev,
                 model_flops, n_dev, chip)


def decode_terms(arch, shape, plan, coll_bytes_per_dev: float, devices: int,
                 chip: Chip = H100) -> Terms:
    m = arch.model
    pc = param_counts(arch)
    n_dev = devices
    B = shape.global_batch
    mm = 2.0 * pc["matmul_active"] * B
    # attention reads the KV cache: flops 4*S_eff*H*hd per token
    S_eff = shape.seq_len if m.sliding_window == 0 else min(
        shape.seq_len, m.sliding_window)
    n_attn = {"hybrid": m.n_layers // 8}.get(m.family, m.n_layers)
    if m.family == "xlstm":
        at, kv_bytes = 0.0, m.n_layers * B * m.d_model ** 2 / m.n_heads * 4
    else:
        at = 4.0 * S_eff * m.n_kv_heads * (m.d_model // m.n_heads) * B * n_attn
        kv_bytes = (2 * S_eff * m.n_kv_heads * (m.d_model // m.n_heads)
                    * B * n_attn * 2)
    total = mm + at
    bytesize = _bytesize(m)
    w_dev = pc["total"] * bytesize / n_dev if arch.big else \
        pc["total"] * bytesize / _replica_ways(plan, n_dev)
    hbm = w_dev + kv_bytes / n_dev
    return Terms(total / n_dev, hbm, coll_bytes_per_dev, total, n_dev, chip)


def terms_for(arch, shape, plan, coll_bytes_per_dev, devices: int,
              chip: Chip = H100) -> Terms:
    if shape.kind == "train":
        return train_terms(arch, shape, plan, coll_bytes_per_dev, devices,
                           chip)
    if shape.kind == "prefill":
        return prefill_terms(arch, shape, plan, coll_bytes_per_dev, devices,
                             chip)
    return decode_terms(arch, shape, plan, coll_bytes_per_dev, devices, chip)


class _RankMesh:
    """The mesh-like view of D ranks for ``sharding.make_plan``: clients
    side by side on ``data``, no model axis to share a replica over."""
    axis_names = ("data", "model")

    def __init__(self, devices: int):
        self.shape = {"data": devices, "model": 1}


def sign_reduce_bytes(arch, devices: int) -> int:
    """Bytes the busiest rank moves in a round's cross-rank reduce of a
    1-bit sign wire: its (d_pad,) f32 accumulator, d padded to the encode
    tile, plus the (1,) f32 loss (``wire.reduce_bytes_per_rank``)."""
    from repro_torch.core import wire
    from repro_torch.kernels.zsign.ops import TILE
    d = param_counts(arch)["total"]
    d_pad = -(-d // TILE) * TILE
    return (wire.reduce_bytes_per_rank(4 * d_pad, devices)
            + wire.reduce_bytes_per_rank(4, devices))


def analyze(arch_id: str, shape_name: str, devices: int,
            chip: Chip = H100) -> dict:
    """One cell's result in the fields ``launch/report.py`` reads."""
    from repro_torch.configs.common import SHAPES, get_arch
    from repro_torch.launch.sharding import make_plan
    arch, shape = get_arch(arch_id), SHAPES[shape_name]
    plan = make_plan(arch, shape, _RankMesh(devices))
    coll = sign_reduce_bytes(arch, devices) if shape.kind == "train" else 0
    t = terms_for(arch, shape, plan, coll, devices, chip)
    s = t.seconds()
    pc = param_counts(arch)
    return {"label": f"{arch_id}/{shape_name}/D={devices}",
            "chip": chip.name, "devices": devices,
            "plan": dataclasses.asdict(plan), "param_counts": pc,
            # the weight replica a device holds (the report's "HBM/dev";
            # no compiler reports the temporaries here)
            "argument_size_in_bytes": pc["total"] * _bytesize(arch.model)
            // _replica_ways(plan, devices),
            "temp_size_in_bytes": None,
            "flops_per_dev": t.flops_per_dev,
            "hbm_bytes_per_dev": t.hbm_bytes_per_dev,
            "coll_bytes_per_dev": t.coll_bytes_per_dev,
            "model_flops_total": t.model_flops_total,
            "t_compute_s": s["compute"], "t_memory_s": s["memory"],
            "t_collective_s": s["collective"], "dominant": t.dominant(),
            "roofline_fraction": t.roofline_fraction(),
            "useful_ratio": t.model_flops_total / max(1.0, t.flops_per_dev
                                                      * devices)}


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True,
                    help="train_4k | prefill_32k | decode_32k | long_500k")
    ap.add_argument("--devices", type=int, default=1)
    ap.add_argument("--json", default=None,
                    help="also write the result list to this file")
    args = ap.parse_args(argv)
    res = analyze(args.arch, args.shape, args.devices)
    print(json.dumps(res))
    if args.json:
        with open(args.json, "w") as f:
            json.dump([res], f, indent=1)


if __name__ == "__main__":
    main()
