"""Seeded weights, made on the device by the benchmark itself.

The parameter set is the plain reference's (``reference/models.py``),
which names its tensors as the program does.  Two draws fill one flat
buffer each (a normal and a uniform), and every leaf is a scaled slice:

* conv and linear kernels: normal, std 1/sqrt(fan-in);
* the style table: unit normal;
* every bias: normal, std 0.1;
* BatchNorm: scale uniform in [0.5, 1.5], shift normal std 0.1, running
  mean normal std 0.1, running variance uniform in [0.5, 2] (a trained
  model's statistics, so folding them is far from a no-op).

The same seed on the same device gives the same tensors, so the reference
draws its own copy after the program has run.
"""

from __future__ import annotations

from typing import Dict

import torch

from bench_port.harness.seeds import generator
from bench_port.reference.models import build


def spec(cfg: dict) -> Dict[str, torch.Size]:
    """name → shape of every parameter and buffer of the configuration's
    modules (``gen.``, ``psenc.``, ``disc.``), in the reference's order."""
    with torch.device("meta"):
        mods = dict(zip(("gen", "psenc", "disc"), build(cfg)))
    return {f"{m}.{k}": v.shape for m, mod in mods.items() if mod is not None
            for k, v in mod.state_dict().items()}


def make(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    shapes = spec(cfg)
    sizes = [s.numel() for s in shapes.values()]
    g = generator(seed, "weights", device)
    normal = torch.randn(sum(sizes), generator=g, device=device)
    uniform = torch.rand(sum(sizes), generator=g, device=device)
    out, at = {}, 0
    for (name, shape), n in zip(shapes.items(), sizes):
        z, u = normal[at:at + n].view(shape), uniform[at:at + n].view(shape)
        at += n
        leaf = name.rsplit(".", 1)[-1]
        if ".norm." in name:
            out[name] = {"weight": 0.5 + u, "bias": 0.1 * z,
                         "running_mean": 0.1 * z,
                         "running_var": 0.5 + 1.5 * u}[leaf]
        elif leaf == "embedding":
            out[name] = z.clone()
        elif leaf == "bias":
            out[name] = 0.1 * z
        else:
            out[name] = z * (shape[1:].numel() ** -0.5)
    return out


def part(weights: Dict[str, torch.Tensor], module: str
         ) -> Dict[str, torch.Tensor]:
    """The state dict of one module (``gen``, ``psenc`` or ``disc``)."""
    prefix = module + "."
    return {k[len(prefix):]: v for k, v in weights.items()
            if k.startswith(prefix)}
