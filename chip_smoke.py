#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card (NVIDIA H100).

    python3 chip_smoke.py

Phases, each of which raises (non-zero exit, no result line) on failure:

1. device and build: the card's name and power limit; both CUDA kernels
   (``src/repro_torch/kernels/zsign/csrc``) compiled from the sources here.
2. kernels against their plain PyTorch versions on the card, at small
   shapes: E1 ``zsign_encode`` bit-exact (z=1: bit-exact or every differing
   bit within 4 f32 ulp of its threshold, the erf rule) and each client's
   bytes in a batched launch equal to its own n = 1 launch; R1
   ``sign_reduce`` with f32 weights and a 0/1 mask, with and without a
   carried sum, equal as int32 bit patterns.
3. the main path at full width: ``repro_torch.launch.train.run`` on
   qwen2-0.5B (24 layers, d = 494,032,768 coordinates, bf16), 8 clients,
   2 local steps, 3 rounds of zsign(z=1, sigma=0.01); finite loss, params
   changed, 8 * d uplink bits per round, and each kernel launched exactly
   once per round (a wrapper counts only launches on CUDA tensors, so this
   also shows the cohort buffer and the wire stack lived on the card).
4. times at the main path's shapes (n = 8, d as above) with CUDA events,
   kernel and plain version compared on the same inputs, beside the bound.

The last line is ``{"ok": true, "device": {...}}``; the line before it
lists each kernel with its check, launches and times.
"""
from __future__ import annotations

import gc
import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

import torch  # noqa: E402

#: H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, non-tensor f32 ops/s
HBM_BYTES_PER_S = 3.35e12
NON_TENSOR_OPS_PER_S = 67e12
#: integer ops per threefry2x32-13 counter (13 rounds of add, rotate, xor;
#: 3 key injections of 3 ops; the first injection and ks2), and f32 ops per
#: encoded element (u, r, P, threshold, compare; erf counted as 20 for z=1)
OPS_PER_COUNTER = 13 * 3 + 3 * 3 + 4
OPS_PER_ELEM = 8
ERF_OPS = 20

FULL_ARGS = ["--arch", "qwen2_0_5b", "--clients", "8", "--local-steps", "2",
             "--micro-batch", "2", "--seq-len", "64", "--rounds", "3",
             "--compressor", "zsign", "--z", "1", "--sigma", "0.01",
             "--device", "cuda"]
QWEN2_COORDS = 494_032_768


def _time_ms(fn, reps: int, warmup: int = 1) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def _bound(nbytes: float, ops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / NON_TENSOR_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_device_and_build():
    from repro_torch.kernels.zsign import build
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(f"# device: {name} (count {torch.cuda.device_count()})")
    print(smi)
    t0 = time.time()
    build.build_all()
    print(f"# kernels built in {time.time() - t0:.1f} s")
    for src, log in build.BUILD_LOG.items():
        used = [ln.strip() for ln in log.splitlines() if "Used" in ln
                or "spill" in ln]
        print(f"# ptxas {src}: " + " | ".join(used))
    return name, smi


def phase_kernel_checks(dev):
    from repro_torch.core import noise
    from repro_torch.kernels.zsign import ops
    gen = torch.Generator(device=dev).manual_seed(11)
    d = 5 * 8192 + 3
    d_pad = -(-d // ops.TILE) * ops.TILE
    flips_z1 = 0
    for n in (1, 8, 13):
        x = torch.zeros((n, d_pad), device=dev)
        x[:, :d] = torch.randn((n, d), generator=gen, device=dev)
        keys = noise.client_keys(noise.prng_key(5), 0, n)
        for z in (noise.Z_INF, 1):
            for s in (0.0, 0.05):
                sig = torch.full((n,), s, device=dev)
                got = ops.zsign_encode(x, keys, sig, z)
                want = ops.zsign_encode_plain(x, keys, sig, z)
                torch.cuda.synchronize()
                nflip, far = ops.erf_rule_flips(x, keys, sig, z, got, want)
                if z == 1:
                    flips_z1 += nflip
                if far or (z != 1 and nflip):
                    raise AssertionError(
                        f"E1 n={n} z={z} sigma={s}: {nflip} bits differ "
                        f"({far} outside the erf rule)")
                if n == 8:
                    for c in range(n):
                        one = ops.zsign_encode(x[c:c + 1].contiguous(),
                                               keys[c:c + 1], sig[c:c + 1], z)
                        if not torch.equal(one[0], got[c]):
                            raise AssertionError(
                                f"E1 client {c}: batched bytes != n=1 bytes")
                    torch.cuda.synchronize()
    print(f"# E1 checks passed; z=1 bits differing from the plain version: "
          f"{flips_z1}")
    nb = 5 * 1024 + 7
    for n in (8, 13):
        packed = torch.randint(0, 256, (n, nb), generator=gen, device=dev,
                               dtype=torch.uint8)
        weights = {"f32": torch.randn((n,), generator=gen, device=dev),
                   "mask": torch.randint(0, 2, (n,), generator=gen,
                                         device=dev).float()}
        acc = torch.randn((8 * nb,), generator=gen, device=dev)
        for wname, w in weights.items():
            for a in (None, acc):
                got = ops.sign_reduce(packed, w, a)
                want = ops.sign_reduce_plain(packed, w, a)
                torch.cuda.synchronize()
                if not torch.equal(got.view(torch.int32),
                                   want.view(torch.int32)):
                    raise AssertionError(f"R1 n={n} {wname} acc="
                                         f"{a is not None}: bits differ")
    print("# R1 checks passed (int32 bit patterns equal)")
    return flips_z1


def phase_main_path():
    from repro_torch.core import wire
    from repro_torch.kernels.zsign import ops
    from repro_torch.launch import train
    args = train.parse_args(FULL_ARGS)
    rounds = []

    def on_round(t, before, after, m, sec):
        if t == 0:
            rounds.append({"embed0": before.params["embed"][:4].clone()})
        rounds.append({"sec": sec, "loss": float(m.loss),
                       "bits": float(m.uplink_bits),
                       "n_coords": wire.tree_spec(after.params).n_coords,
                       "final": after.params})

    ops.zsign_encode.launches = 0
    ops.sign_reduce.launches = 0
    history = train.run(args, on_round=on_round)
    launches = {"zsign_encode": ops.zsign_encode.launches,
                "sign_reduce": ops.sign_reduce.launches}
    torch.cuda.synchronize()
    first, per = rounds[0], rounds[1:]
    if len(history) != args.rounds or len(per) != args.rounds:
        raise AssertionError("train.run did not run every round")
    for r in per:
        if not math.isfinite(r["loss"]):
            raise AssertionError(f"non-finite loss {r['loss']}")
        if r["n_coords"] != QWEN2_COORDS:
            raise AssertionError(f"d = {r['n_coords']} != {QWEN2_COORDS}")
        if r["bits"] != args.clients * QWEN2_COORDS:
            raise AssertionError(f"uplink bits {r['bits']} != "
                                 f"{args.clients} * {QWEN2_COORDS}")
    final = per[-1]["final"]
    if torch.equal(final["embed"][:4], first["embed0"]):
        raise AssertionError("params did not change")
    for name, count in launches.items():
        if count != args.rounds:
            raise AssertionError(f"{name} launched {count} times in "
                                 f"{args.rounds} rounds (want one a round)")
    secs = [r["sec"] for r in per]
    print(json.dumps({"main_path": "qwen2_0_5b", "clients": args.clients,
                      "local_steps": args.local_steps, "rounds": args.rounds,
                      "round_s": secs,
                      "loss": [r["loss"] for r in per],
                      "launches": launches}))
    return launches, secs


def phase_times(dev):
    from repro_torch.core import noise
    from repro_torch.kernels.zsign import ops
    n, d = 8, QWEN2_COORDS
    d_pad = -(-d // ops.TILE) * ops.TILE
    nb = d_pad // 8
    gen = torch.Generator(device=dev).manual_seed(12)
    x = torch.zeros((n, d_pad), device=dev)
    for c in range(n):
        x[c, :d] = torch.randn((d,), generator=gen, device=dev) * 0.01
    keys = noise.client_keys(noise.prng_key(7), 0, n)
    sig = torch.full((n,), 0.01, device=dev)
    z = 1
    rows = []
    got = ops.zsign_encode(x, keys, sig, z)
    want = ops.zsign_encode_plain(x, keys, sig, z)
    torch.cuda.synchronize()
    nflip, far = ops.erf_rule_flips(x, keys, sig, z, got, want)
    if far:
        raise AssertionError(f"E1 at full width: {far} bits outside the "
                             "erf rule")
    enc_ms = _time_ms(lambda: ops.zsign_encode(x, keys, sig, z), reps=10,
                      warmup=2)
    enc_plain_ms = _time_ms(lambda: ops.zsign_encode_plain(x, keys, sig, z),
                            reps=2)
    elems = n * d_pad
    enc_bound, enc_by = _bound(
        nbytes=elems * 4 + elems / 8 + keys.numel() * 8 + n * 4,
        ops=elems / 4 * OPS_PER_COUNTER + elems * (OPS_PER_ELEM + ERF_OPS))
    rows.append({"name": "zsign_encode", "ms": enc_ms,
                 "plain_ms": enc_plain_ms, "bound_ms": enc_bound,
                 "bound_by": enc_by, "bits_differing": nflip,
                 "max_abs_err": 1 if nflip else 0})
    del x, want
    gc.collect()
    torch.cuda.empty_cache()
    packed = got
    mask = torch.ones((n,), device=dev)
    mask[3] = 0.0
    r_got = ops.sign_reduce(packed, mask)
    r_want = ops.sign_reduce_plain(packed, mask)
    torch.cuda.synchronize()
    if not torch.equal(r_got.view(torch.int32), r_want.view(torch.int32)):
        raise AssertionError("R1 at full width: bits differ")
    red_ms = _time_ms(lambda: ops.sign_reduce(packed, mask), reps=10,
                      warmup=2)
    red_plain_ms = _time_ms(lambda: ops.sign_reduce_plain(packed, mask),
                            reps=2)
    red_bound, red_by = _bound(nbytes=n * nb + 8 * nb * 4 + n * 4,
                               ops=n * 8 * nb * 2)
    rows.append({"name": "sign_reduce", "ms": red_ms,
                 "plain_ms": red_plain_ms, "bound_ms": red_bound,
                 "bound_by": red_by,
                 "max_abs_err": float((r_got - r_want).abs().max())})
    for r in rows:
        print(json.dumps({"time": r["name"], "shape": f"n={n} d={d}",
                          "ms": r["ms"], "plain_ms": r["plain_ms"],
                          "bound_ms": r["bound_ms"],
                          "bound_by": r["bound_by"]}))
    return {r["name"]: r for r in rows}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card visible", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name, smi = phase_device_and_build()
    flips_z1 = phase_kernel_checks(dev)
    launches, secs = phase_main_path()
    gc.collect()
    torch.cuda.empty_cache()
    times = phase_times(dev)
    enc, red = times["zsign_encode"], times["sign_reduce"]
    other_ms = min(secs) * 1e3 - enc["ms"] - red["ms"]
    print(json.dumps({"round_split_ms": {
        "round_min": min(secs) * 1e3, "encode_E1": enc["ms"],
        "reduce_R1": red["ms"], "local_sgd_and_rest": other_ms},
        "card": smi}))
    kernels = [
        {"name": "zsign_encode", "route": "cuda",
         "source": "src/repro_torch/kernels/zsign/csrc/zsign_encode.cu",
         "replaces": "src/repro/kernels/zsign/zsign.py:145",
         "launches": launches["zsign_encode"],
         "max_abs_err": enc["max_abs_err"], "ms": enc["ms"],
         "plain_ms": enc["plain_ms"], "bound_ms": enc["bound_ms"],
         "bound_by": enc["bound_by"], "library_ms": None,
         "check": f"bit-exact vs plain, z=1 flips {flips_z1} (small) / "
                  f"{enc['bits_differing']} (full width)"},
        {"name": "sign_reduce", "route": "cuda",
         "source": "src/repro_torch/kernels/zsign/csrc/sign_reduce.cu",
         "replaces": "src/repro/kernels/zsign/zsign.py:226",
         "launches": launches["sign_reduce"],
         "max_abs_err": red["max_abs_err"], "ms": red["ms"],
         "plain_ms": red["plain_ms"], "bound_ms": red["bound_ms"],
         "bound_by": red["bound_by"], "library_ms": None,
         "check": "int32 bit patterns equal to plain"},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
