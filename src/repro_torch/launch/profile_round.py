"""Where a full-width round's device time goes: torch.profiler over
``launch.train.run``.

    python -m repro_torch.launch.profile_round [train flags ...]

With no flags it profiles 2 rounds of the main path (qwen2-0.5B at full
width, 8 clients, 2 local steps, zsign z=1 sigma=0.01) after one warm-up
round, prints device time by kernel name (top 30) and the device's busy
share of the profiled wall time (summed kernel time over host wall time).
``--pipeline SPEC`` profiles another path at the same setup, e.g.

    python -m repro_torch.launch.profile_round --pipeline "ef|zsign(use_kernel=true)"

Any other train flag replaces the defaults altogether.
"""
from __future__ import annotations

import json
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.launch import train

DEFAULT = ["--arch", "qwen2_0_5b", "--clients", "8", "--local-steps", "2",
           "--micro-batch", "2", "--seq-len", "64", "--compressor", "zsign",
           "--z", "1", "--sigma", "0.01", "--device", "cuda"]


def main(argv=None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] == "--pipeline":
        argv = DEFAULT + argv
    args = train.parse_args(argv + ["--rounds", "3"])
    state = {"prof": None, "t0": 0.0}

    def on_round(t, before, after, m, sec):
        # round 0 warms up; rounds 1 and 2 are profiled
        if t == 0:
            torch.cuda.synchronize()
            state["prof"] = profile(activities=[ProfilerActivity.CPU,
                                                ProfilerActivity.CUDA])
            state["prof"].__enter__()
            state["t0"] = time.time()

    train.run(args, on_round=on_round)
    torch.cuda.synchronize()
    wall_ms = (time.time() - state["t0"]) * 1e3
    prof = state["prof"]
    prof.__exit__(None, None, None)
    # device-side rows (kernels, copies, memsets) only: operator rows also
    # report the device time of the kernels they launch
    rows = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                   for e in prof.key_averages()
                   if e.device_type != DeviceType.CPU), key=lambda r: -r[1])
    busy_ms = sum(ms for _, ms, _ in rows)
    print(prof.key_averages().table(sort_by="self_device_time_total",
                                    row_limit=30))
    print(json.dumps({"profiled_rounds": 2, "pipeline": args.pipeline,
                      "wall_ms": wall_ms,
                      "kernel_time_ms": busy_ms,
                      "busy_share": busy_ms / wall_ms,
                      "top": [{"name": k[:120], "device_ms": ms, "calls": c}
                              for k, ms, c in rows[:15]],
                      "card": torch.cuda.get_device_name(0)}))


if __name__ == "__main__":
    main()
