"""Batched serving on the PyTorch port: prefill-free KV-cache decode on a
reduced model.

    PYTHONPATH=src python examples/torch_serve_lm.py [--device cpu]

The port of ``examples/serve_lm.py``: 8 requests, 48 greedy steps against a
128-slot cache, through the bundle's ``decode_step`` (the cache is written
in place). The start tokens come from a torch generator, so the decoded
ids are not the reference's.
"""
import argparse
import time

import torch

from repro_torch.configs.common import get_arch
from repro_torch.launch.train import resolve_device
from repro_torch.models.api import build_model

ARCH = "qwen2_0_5b"
BATCH, STEPS, MAX_LEN = 8, 48, 128

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
device = resolve_device(ap.parse_args().device)

arch = get_arch(ARCH).reduced()
bundle = build_model(arch.model)
params = bundle.init(torch.Generator(device=device).manual_seed(0), device)
cache = bundle.init_cache(BATCH, MAX_LEN, device)

tokens = torch.randint(0, arch.model.vocab, (BATCH, 1),
                       generator=torch.Generator().manual_seed(1)).to(device)
out = [tokens]
t0 = time.time()
for pos in range(STEPS):
    logits, cache = bundle.decode_step(params, cache, tokens, pos)
    tokens = torch.argmax(logits[:, -1:], dim=-1)
    out.append(tokens)
seqs = torch.cat(out, dim=1).cpu()
dt = time.time() - t0
print(f"arch={arch.model.name} (reduced) batch={BATCH} device={device}")
print(f"decoded {STEPS} steps in {dt:.2f}s ({BATCH * STEPS / dt:.0f} tok/s "
      f"on {device})")
print("sample token ids:", seqs[0, :16].tolist())
assert seqs.shape == (BATCH, STEPS + 1)
assert bool(torch.all((seqs >= 0) & (seqs < arch.model.vocab)))
print("OK")
