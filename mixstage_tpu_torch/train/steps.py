"""GAN train and eval steps of the Mix-StAGE generator.

Counterpart of ``mixstage_tpu/train/steps.py`` for the flagship
configuration (``JointLateClusterSoftStyle4_G`` against
``Speech2Gesture_D``, audio input, f32).  The JAX package jits pure
functions of a state pytree; here the modules live in ``TrainState`` and a
step updates it in place, with ``module.train()`` / ``.eval()`` as the mode:

* G step: G and D in TRAIN mode.  D's running statistics update from the
  fakes; its parameters get no update (gradients w.r.t. G's leaves only).
* D step: G in EVAL mode under ``no_grad`` (running statistics, no update).
  D runs on the fakes, then on the reals; the second call starts from the
  statistics the first one left.
* ``some_grad_flag`` freezes psenc's parameters for the id_out loss only.
* The λ ramp reads ``lambda_step``; both steps advance it.  The curriculum
  ``use_pose_input`` coin is a Python argument.
* ``fused_decoder``: the backbone runs through autograd and the mixture
  decoder through kernel K3 (``ops/cuda/train_decoder.py``); the decoder's
  running statistics take the flax rule from K3's batch mean / variance.

Configurations the port does not cover yet raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from mixstage_tpu_torch.device import resolve_device
from mixstage_tpu_torch.models.layers import PoseStyleEncoder, reset_parameters_
from mixstage_tpu_torch.models.registry import (get_model_def,
                                                infer_discriminator_name)
from mixstage_tpu_torch.ops.mixture import index_select_outputs
from mixstage_tpu_torch.train import losses as L
from mixstage_tpu_torch.train.state import (TrainState, g_named_parameters,
                                            make_optimizer,
                                            translate_optim_kwargs)

Batch = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class StepConfig:
    """Static configuration of the steps (the JAX field names)."""

    model: str = "JointLateClusterSoftStyle4_G"
    gan: bool = False
    criterion: str = "L1Loss"
    input_modalities: Tuple[str, ...] = ("audio/log_mel_512",)
    time_steps: int = 64
    out_feats: int = 96
    num_clusters: Optional[int] = None
    num_speakers: int = 1
    style_dim: int = 10
    text_channels: Optional[int] = None
    lambda_id: float = 1.0
    train_only: bool = False
    softmax: bool = True
    argmax: bool = False
    some_grad_flag: bool = False
    curriculum_iters: int = 1000
    style_losses: Tuple = ()
    discriminator: Optional[str] = None
    dg_iter_ratio: float = 1.0
    lambda_gan: float = 1.0
    lambda_D: float = 1.0
    joint: bool = False
    no_grad: bool = False
    weighted: bool = False
    lr: float = 1e-4
    loss_kwargs: Tuple = ()
    optim_kwargs: Tuple = ()
    optim: str = "Adam"
    noise: float = 0.0
    optim_separate: Optional[float] = None
    optim_mu_dtype: Optional[str] = None
    fused_decoder: bool = False
    audio_lowering: Optional[str] = None
    p_dropout: float = 0.0
    dtype: Any = torch.float32
    model_kwargs: Tuple = ()

    @property
    def is_classifier(self) -> bool:
        return "Classifier" in self.model

    @property
    def has_cluster(self) -> bool:
        return self.num_clusters is not None and "Cluster" in self.model

    @property
    def has_style(self) -> bool:
        return "Style" in self.model and not self.is_classifier

    @property
    def d_prob(self) -> float:
        r = self.dg_iter_ratio
        return r / (r + 1.0)


def _unsupported(cfg: StepConfig) -> Optional[str]:
    """Why the port cannot run ``cfg`` yet (None when it can)."""
    later = "(ROADMAP queue 1)"
    if not cfg.has_style or cfg.is_classifier:
        return (f"model {cfg.model!r}: the port trains the Mix-StAGE style "
                f"generators; the classifier and the simple models come "
                f"later {later}")
    if any(not m.startswith("audio/") for m in cfg.input_modalities) or \
            len(cfg.input_modalities) != 1 or cfg.text_channels:
        return f"text modalities and fused streams come later {later}"
    if not cfg.gan:
        return f"the non-GAN trainer comes later {later}"
    if cfg.weighted:
        return f"the weighted GAN comes later {later}"
    if cfg.joint:
        return f"the joint discriminator comes later {later}"
    if cfg.dtype != torch.float32:
        return f"dtype {cfg.dtype}: bf16 training comes later {later}"
    if cfg.noise > 0:
        return f"pose noise comes later {later}"
    if cfg.p_dropout > 0:
        return f"dropout comes later {later}"
    if cfg.optim_separate is not None or cfg.optim_mu_dtype:
        return f"optim_separate / optim_mu_dtype come later {later}"
    if cfg.style_losses or "Disentangle" in cfg.model:
        return f"the Disentangle losses come later {later}"
    if cfg.audio_lowering:
        return ("audio_lowering is a TPU relowering plan of the same math; "
                f"the port runs native convs {later}")
    return None


def _to_device(batch: Batch, device) -> Batch:
    if batch.get("confidence") is not None:
        raise NotImplementedError("the confidence loss comes later "
                                  "(ROADMAP queue 1)")
    out = {}
    for k, v in batch.items():
        if v is None:
            out[k] = None
        elif k == "x":
            out[k] = [torch.as_tensor(a, dtype=torch.float32, device=device)
                      for a in v]
        else:
            t = torch.as_tensor(np.asarray(v) if not torch.is_tensor(v)
                                else v, device=device)
            out[k] = t.float() if t.is_floating_point() else t
    return out


class StepFactory:
    """Builds the train state and the step callables for a StepConfig.

    ``device=None`` is the CUDA card (raises without one); the tests pass
    ``device="cpu"``."""

    def __init__(self, cfg: StepConfig, g_schedule=None, d_schedule=None,
                 device=None):
        why = _unsupported(cfg)
        if why:
            raise NotImplementedError(why)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.gen_cls = get_model_def(cfg.model)
        d_name = cfg.discriminator or infer_discriminator_name(cfg.model)
        try:
            self.disc_cls = get_model_def(d_name)
        except KeyError:
            # the JAX package (and the reference) fall back to the shared D
            self.disc_cls = get_model_def("Speech2Gesture_D")
        self.criterion = L.get_criterion(cfg.criterion,
                                         **dict(cfg.loss_kwargs))
        opt_kw = translate_optim_kwargs(dict(cfg.optim_kwargs))
        self.g_tx = make_optimizer(cfg.optim, cfg.lr, schedule=g_schedule,
                                   **opt_kw)
        self.d_tx = make_optimizer(cfg.optim, cfg.lr, schedule=d_schedule,
                                   **opt_kw)

    # ------------------------------------------------------------------ init
    def build_modules(self):
        cfg = self.cfg
        mk = dict(cfg.model_kwargs)
        gen = self.gen_cls(out_feats=cfg.out_feats,
                           num_clusters=cfg.num_clusters or 1,
                           num_speakers=cfg.num_speakers,
                           style_dim=cfg.style_dim, **mk)
        psenc = PoseStyleEncoder(input_channels=cfg.out_feats,
                                 num_speakers=cfg.num_speakers)
        disc = self.disc_cls(in_channels=cfg.out_feats, out_shape=1)
        return gen, psenc, disc

    def _state(self, gen, psenc, disc) -> TrainState:
        gen, psenc, disc = (m.to(self.device) for m in (gen, psenc, disc))
        return TrainState(
            gen=gen, psenc=psenc, disc=disc,
            g_opt=self.g_tx(g_named_parameters(gen, psenc)),
            d_opt=self.d_tx(list(disc.named_parameters())))

    def init(self, seed: int = 0) -> TrainState:
        """Fresh modules with weights drawn from ``seed`` (on the CPU, then
        moved), zero optimizer moments and counters."""
        gen = torch.Generator().manual_seed(seed)
        modules = self.build_modules()
        for m in modules:
            reset_parameters_(m, gen)
        return self._state(*modules)

    def init_from_flax(self, g_params, g_state, d_params, d_state,
                       g_opt_state=None, d_opt_state=None,
                       counters: Optional[Dict[str, int]] = None
                       ) -> TrainState:
        """A state carrying a JAX ``TrainState``'s trees (numpy-convertible):
        params, batch stats and, when given, the Adam moments and counts of
        the optimizer states, and the counters."""
        from mixstage_tpu_torch.interop.weights import (load_flax_state,
                                                        load_flax_opt_state)
        gen, psenc, disc = self.build_modules()
        load_flax_state(gen, g_params["gen"], g_state["gen"])
        load_flax_state(psenc, g_params["psenc"], g_state["psenc"])
        load_flax_state(disc, d_params, d_state)
        state = self._state(gen, psenc, disc)
        if g_opt_state is not None:
            load_flax_opt_state(state.g_opt, {"gen": gen, "psenc": psenc},
                                g_opt_state)
        if d_opt_state is not None:
            load_flax_opt_state(state.d_opt, {None: disc}, d_opt_state)
        for k, v in (counters or {}).items():
            setattr(state, k, int(v))
        return state

    # --------------------------------------------------------------- helpers
    def _style_weights_train(self, psenc_score, T):
        """Per-window speaker scores broadcast over time, soft / hard
        selected (``steps.py:284-295``)."""
        cfg = self.cfg
        score = psenc_score[:, None, :].expand(-1, T, -1)
        if cfg.softmax:
            w = torch.softmax(score, dim=-1)
            if cfg.argmax:
                w = F.one_hot(w.argmax(-1), cfg.num_speakers).to(score.dtype)
            return w
        return score

    def _apply_psenc(self, state, y, frozen=False):
        if not frozen:
            return state.psenc(y)
        params = {n: p.detach() for n, p in state.psenc.named_parameters()}
        return torch.func.functional_call(state.psenc, params, (y,))

    def _apply_gen_style(self, state, batch, style_weights, use_pose_input,
                         train):
        kwargs = dict(input_modalities=list(self.cfg.input_modalities),
                      use_pose_input=use_pose_input)
        if train and self.cfg.fused_decoder:
            return self._apply_gen_style_fused(state, batch, style_weights,
                                               kwargs)
        return state.gen(list(batch["x"]), batch["y"], style_weights,
                         **kwargs)

    def _apply_gen_style_fused(self, state, batch, style_weights, kwargs):
        """Train-mode forward with the mixture decoder through K3
        (``steps.py:323-356``): the backbone through autograd, the decoder
        as ``DecoderTrain``; its running statistics take the flax rule from
        K3's batch mean and (biased) variance."""
        from mixstage_tpu_torch.ops.cuda.train_decoder import \
            fused_decoder_train

        gen = state.gen
        x_feat, labels_score, labels_cap_soft = gen.backbone(
            list(batch["x"]), batch["y"], style_weights, **kwargs)
        M = gen.num_clusters
        xr, mu, var = fused_decoder_train(x_feat, gen)
        pose = index_select_outputs(xr, labels_cap_soft, M)
        for i, layer in enumerate(gen.decoder_layers()):
            layer.norm.update_running_stats(mu[:, i].reshape(-1),
                                            var[:, i].reshape(-1))
        return {"pose": pose, "labels_score": labels_score,
                "labels_cap_soft": labels_cap_soft}

    def _apply_disc(self, state, x):
        return state.disc(x)[0]

    def _d_input(self, pose):
        """Velocity fed to D (``steps.py:245-255``, not joint)."""
        return L.velocity(pose)

    # ------------------------------------------------- generator forward core
    def _style_forward(self, state, batch, use_pose_input, train,
                       sample_flag):
        """Mix-StAGE forward with the style machinery and the id / cluster
        losses (``steps.py:379-437``): (pose, losses, aux)."""
        cfg = self.cfg
        T = batch["y"].shape[1]
        psenc_flag = (not sample_flag) and (train or not cfg.train_only)
        zero = torch.zeros((), device=self.device)
        if psenc_flag:
            score = self._apply_psenc(state, batch["y"])
            id_in = L.cross_entropy(score, batch["style"][:, 0])
            style_weights = self._style_weights_train(score, T)
        elif batch.get("style_soft") is not None:
            id_in = zero
            style_weights = batch["style_soft"].float()
        else:
            id_in = zero
            style_weights = F.one_hot(batch["style"].long(),
                                      cfg.num_speakers).float()
        out = self._apply_gen_style(state, batch, style_weights,
                                    use_pose_input, train)
        pose = out["pose"]
        label_loss = zero
        if cfg.has_cluster and batch.get("labels") is not None:
            M = cfg.num_clusters
            label_loss = L.cross_entropy(out["labels_score"].reshape(-1, M),
                                         batch["labels"].reshape(-1))
        if psenc_flag:
            score_out = self._apply_psenc(state, pose,
                                          frozen=cfg.some_grad_flag)
            id_out = L.cross_entropy(score_out, batch["style"][:, 0])
        else:
            id_out = zero
        losses = {"label": label_loss, "id_in": id_in * cfg.lambda_id,
                  "id_out": id_out * cfg.lambda_id}
        return pose, losses, {"labels_cap_soft": out.get("labels_cap_soft")}

    def _forward(self, state, batch, use_pose_input, train, sample_flag):
        return self._style_forward(state, batch, use_pose_input, train,
                                   sample_flag)

    @staticmethod
    def _modes(state, g_train: bool, d_train: bool):
        state.gen.train(g_train)
        state.psenc.train(g_train)
        state.disc.train(d_train)

    # ----------------------------------------------------------------- steps
    def make_steps(self):
        """{"g", "d", "eval"} step callables of this config."""
        return {"g": self._g_step, "d": self._d_step, "eval": self._eval_step}

    def _g_step(self, state: TrainState, batch: Batch, rng=None,
                use_pose_input: bool = False):
        """GAN G step (``steps.py:508-554``): (state, losses, pose)."""
        cfg = self.cfg
        batch = _to_device(batch, self.device)
        y = batch["y"]
        lambda_gan = L.lambda_schedule(state.lambda_step, cfg.lambda_gan)
        W = torch.ones((y.shape[0],), device=self.device)
        self._modes(state, True, True)
        with torch.enable_grad():
            pose, internal, _ = self._forward(state, batch, use_pose_input,
                                              True, False)
            d_score = self._apply_disc(state, self._d_input(pose))
            if cfg.no_grad:
                d_score = d_score.detach()
            G_gan = lambda_gan * L.sample_wise_weight_mean(
                self.criterion(d_score, torch.ones_like(d_score)), 1.0 / W)
            pose_loss = L.sample_wise_weight_mean(self.criterion(pose, y),
                                                  1.0 / W)
            total = pose_loss + G_gan + sum(internal.values())
            grads = torch.autograd.grad(total, state.g_opt.params,
                                        allow_unused=True)
        state.g_opt.step([torch.zeros_like(p) if g is None else g
                          for g, p in zip(grads, state.g_opt.params)])
        state.step += 1
        state.g_step += 1
        state.lambda_step += 1
        state.curriculum_step += 1
        losses = {"pose": pose_loss, "G_gan": G_gan, "total": total, "W": W,
                  **internal}
        return state, {k: v.detach() for k, v in losses.items()}, \
            pose.detach()

    def _d_step(self, state: TrainState, batch: Batch, rng=None,
                use_pose_input: bool = False):
        """GAN D step (``steps.py:557-605``): (state, losses, pose)."""
        cfg = self.cfg
        batch = _to_device(batch, self.device)
        y = batch["y"]
        lambda_D = L.lambda_schedule(state.lambda_step, cfg.lambda_D)
        W = torch.ones((y.shape[0],), device=self.device)
        self._modes(state, False, True)
        with torch.no_grad():
            pose, internal, _ = self._forward(state, batch, use_pose_input,
                                              False, False)
        fake_v, real_v = self._d_input(pose), self._d_input(y)
        with torch.enable_grad():
            fake_score = self._apply_disc(state, fake_v)
            real_score = self._apply_disc(state, real_v)
            fake_D = lambda_D * L.sample_wise_weight_mean(
                self.criterion(fake_score, torch.zeros_like(fake_score)),
                torch.ones_like(W))
            real_D = L.sample_wise_weight_mean(
                self.criterion(real_score, torch.ones_like(real_score)),
                torch.ones_like(W))
            total = real_D + fake_D + sum(internal.values())
            grads = torch.autograd.grad(total, state.d_opt.params)
        state.d_opt.step(grads)
        state.step += 1
        state.lambda_step += 1
        losses = {"real_D": real_D, "fake_D": fake_D, "total": total,
                  "W": W, **internal}
        return state, {k: v.detach() for k, v in losses.items()}, pose

    @torch.no_grad()
    def _eval_step(self, state: TrainState, batch: Batch,
                   use_pose_input: bool = False, sample_flag: bool = False):
        """Eval / sampling forward (``steps.py:608-616``): (losses, pose,
        aux), every module in eval mode."""
        batch = _to_device(batch, self.device)
        self._modes(state, False, False)
        pose, internal, aux = self._forward(state, batch, use_pose_input,
                                            False, sample_flag)
        pose_loss = self.criterion(pose, batch["y"]).mean()
        losses = {"pose": pose_loss,
                  "total": pose_loss + sum(internal.values()), **internal}
        return losses, pose, aux

    # -- multi-step training driver -------------------------------------------
    def union_keys(self) -> Sequence[str]:
        """The loss keys of both branches (``steps.py:674-684``)."""
        keys = {"pose", "G_gan", "real_D", "fake_D", "total"}
        if self.cfg.has_style:
            keys |= {"label", "id_in", "id_out"}
        return sorted(keys)

    def make_scan_train_step(self, k: int):
        """k sequential train steps per call (``steps.py:656-723``):
        ``fn(state, stacked_batches, coins (k,) host bools: True = D step,
        rngs=None) → (state, {key: (k,) float32}, poses (k, B, T, F))``.
        The audio-input branch only, as in the JAX package; the losses stay
        on the device (no host sync per step)."""
        keys = self.union_keys()

        def scan_step(state, batches: Batch, coins, rngs=None):
            coins = np.asarray(coins, dtype=bool)
            if coins.shape != (k,):
                raise ValueError(f"coins must have shape ({k},), got "
                                 f"{coins.shape}")
            rows, poses = [], []
            for i in range(k):
                batch = {key: None if v is None else
                         (type(v)(a[i] for a in v) if key == "x" else v[i])
                         for key, v in batches.items()}
                step = self._d_step if coins[i] else self._g_step
                state, losses, pose = step(state, batch,
                                           use_pose_input=False)
                zero = torch.zeros((), device=self.device)
                rows.append([losses.get(key, zero).float() for key in keys])
                poses.append(pose)
            stacked = torch.stack([torch.stack(r) for r in rows])
            return state, {key: stacked[:, j] for j, key in enumerate(keys)}, \
                torch.stack(poses)

        return scan_step
