"""Small MLP classifier of the paper-figure examples (port of
``repro.models.mlp``; it stands in for the paper's 2-layer CNN)."""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.models.api import check_device


def mlp_loss_builder(dim: int, n_classes: int, width: int = 64):
    """-> ``(init, loss_fn, acc_fn)`` of a 3-layer ReLU MLP on ``{x, y}``
    batches. ``init(gen, device="cuda")`` draws the weights from the
    ``torch.Generator`` ``gen`` (N(0, 1/fan_in), zero biases: the reference's
    law, not its values); ``loss_fn(p, batch)`` is the mean cross-entropy
    (log_softmax against one-hot labels); ``acc_fn(p, x, y)`` the
    accuracy, a Python float."""
    shapes = {"w1": (dim, width), "b1": (width,), "w2": (width, width),
              "b2": (width,), "w3": (width, n_classes), "b3": (n_classes,)}

    def init(gen: torch.Generator, device="cuda"):
        device = check_device(device)
        p = {}
        for k, shape in shapes.items():
            if k.startswith("w"):
                w = torch.randn(shape, generator=gen) / math.sqrt(shape[0])
            else:
                w = torch.zeros(shape)
            p[k] = w.to(device)
        return p

    def logits_fn(p, x):
        h = torch.relu(x @ p["w1"] + p["b1"])
        h = torch.relu(h @ p["w2"] + p["b2"])
        return h @ p["w3"] + p["b3"]

    def loss_fn(p, batch):
        lp = torch.log_softmax(logits_fn(p, batch["x"]), dim=-1)
        oh = torch.nn.functional.one_hot(batch["y"].long(),
                                         n_classes).to(lp.dtype)
        return -torch.mean(torch.sum(lp * oh, dim=-1))

    def acc_fn(p, x, y):
        with torch.no_grad():
            pred = torch.argmax(logits_fn(p, x), dim=-1)
            return float(torch.mean((pred == y.to(pred.device)).float()))

    return init, loss_fn, acc_fn


def params_from_numpy(tree, device="cuda") -> dict:
    """An MLP params dict of numpy arrays (the reference's params, say) ->
    f32 tensors on ``device``."""
    device = check_device(device)
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)).to(device)
            for k, v in tree.items()}
