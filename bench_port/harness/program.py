"""The system under test, built from a configuration file and the
benchmark's weights: the port's train state and k-step call, and its
serving function.  The only module of the harness that imports the
program (``mixstage_tpu_torch``).

Every key of a configuration file that the program takes is passed to it
here; where the program has no option for a key (the clip norm, TF32),
set-up checks that the program does what the file states and refuses to
run otherwise.  The keys ``name``, ``source``, ``description``,
``reduced`` and ``assumed`` only document the file."""

from __future__ import annotations

from typing import Dict

import torch

from bench_port.harness.weights import part


def step_factory(cfg: dict, traffic: dict, device):
    """The program's ``StepFactory`` of the configuration: a GAN against
    ``discriminator`` where the file names one."""
    from mixstage_tpu_torch.train.state import ClippedOptimizer
    from mixstage_tpu_torch.train.steps import StepConfig, StepFactory

    if ClippedOptimizer.MAX_NORM != cfg["clip_grad_norm"]:
        raise ValueError(f"the program clips at {ClippedOptimizer.MAX_NORM}"
                         f", the configuration at {cfg['clip_grad_norm']}")
    scfg = StepConfig(
        model=cfg["model"], gan="discriminator" in cfg,
        criterion=cfg["loss"],
        input_modalities=(cfg["input_modality"],),
        time_steps=traffic["frames"], out_feats=cfg["out_feats"],
        num_clusters=cfg.get("num_clusters"),
        num_speakers=cfg["num_speakers"],
        style_dim=cfg.get("style_dim", 10),
        lambda_id=cfg.get("lambda_id", 1.0),
        train_only=bool(cfg.get("train_only", 0)),
        argmax=bool(cfg.get("argmax", 0)),
        some_grad_flag=bool(cfg.get("some_grad_flag", 0)),
        discriminator=cfg.get("discriminator"),
        dg_iter_ratio=cfg["dg_iter_ratio"], lr=cfg["lr"], optim=cfg["optim"],
        fused_decoder=bool(cfg.get("fused_decoder", 0)),
        dtype=getattr(torch, cfg["dtype"]),
        model_kwargs=(("in_channels", cfg["in_channels"]),))
    factory = StepFactory(scfg, device=device)
    check_precision(cfg)
    return factory


def check_precision(cfg: dict) -> None:
    """The program sets its float32 precision itself (no TF32 on the
    card); refuse a configuration that states another."""
    tf32 = torch.cuda.is_available() and (
        torch.backends.cudnn.allow_tf32 or
        torch.backends.cuda.matmul.allow_tf32)
    if bool(tf32) != bool(cfg["tf32"]):
        raise ValueError(f"the configuration states tf32 {cfg['tf32']}; "
                         f"the program runs with TF32 {bool(tf32)}")


def train_state(factory, weights: Dict[str, torch.Tensor]):
    """The program's train state carrying the benchmark's weights, zero
    optimizer state and counters."""
    state = factory.init(seed=0)
    for name in ("gen", "psenc", "disc"):
        mod = getattr(state, name)
        if mod is not None:
            mod.load_state_dict(part(weights, name))
    return state


def leaves(state) -> Dict[str, torch.Tensor]:
    """Host copies of every parameter and buffer of the train state, by
    the reference's names."""
    out = {}
    for name in ("gen", "psenc", "disc"):
        mod = getattr(state, name)
        if mod is not None:
            out.update({f"{name}.{k}": v.detach().cpu().clone()
                        for k, v in mod.state_dict().items()})
    return out


def state_tensors(state) -> Dict[str, torch.Tensor]:
    """Every tensor of the train state by name, not copied: the modules'
    parameters and buffers by the reference's names, and each optimizer's
    slots as ``<g_opt|d_opt>.<slot>.<leaf>``."""
    out = {}
    for name in ("gen", "psenc", "disc"):
        mod = getattr(state, name)
        if mod is not None:
            out.update({f"{name}.{k}": v.detach()
                        for k, v in mod.state_dict().items()})
    for tag, opt, prefix in (("g_opt", state.g_opt, ""),
                             ("d_opt", state.d_opt, "disc.")):
        for slot, tensors in opt.slots().items():
            out.update({f"{tag}.{slot}.{prefix}{n}": t
                        for n, t in zip(opt.names, tensors)})
    return out


def counters(state) -> Dict[str, int]:
    """The train state's step counters and each optimizer's count."""
    return {"g_count": state.g_opt.count, "d_count": state.d_opt.count,
            "lambda_step": state.lambda_step, "step": state.step}


def serving_fn(cfg: dict, weights: Dict[str, torch.Tensor], device,
               traffic: dict):
    """``build_serving_fn`` of the configuration's generator (built by the
    program's own model registry, as its trainer builds it) carrying the
    benchmark's weights: the kernel route on the card."""
    from mixstage_tpu_torch.serve import build_serving_fn

    with torch.device(device):
        model = step_factory(cfg, traffic, device).build_modules()[0]
    model.load_state_dict(part(weights, "gen"))
    return build_serving_fn(model, device=device)
