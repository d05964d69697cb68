"""Train and eval steps: the GAN, the non-GAN and the classifier trainers.

Counterpart of ``mixstage_tpu/train/steps.py``: every configuration its
``StepFactory`` builds.  ``audio_lowering`` takes every plan JAX takes
(``models/layers.py::resolve_audio_lowerings``; a bad one raises
``ValueError``): all compute the same math on the same parameters, and
the native convolutions run for each.
The JAX package jits pure functions of a state pytree; here the modules
live in ``TrainState`` and a step updates it in place, with
``module.train()`` / ``.eval()`` as the mode:

* G step: G and D in TRAIN mode.  D's running statistics update from the
  fakes; its parameters get no update (gradients w.r.t. G's leaves only).
* D step: G in EVAL mode under ``no_grad`` (running statistics, no update).
  D runs on the fakes, then on the reals; the second call starts from the
  statistics the first one left.
* non-GAN step (``gan=False``, ``steps.py:477-505``): G alone, the pose
  loss and the internal losses; the classifier step (``StyleClassifier_G``,
  ``:619-651``): cross-entropy on the speaker id, with its accuracy.
* ``make_steps()`` gives ``{"g", "d", "eval"}`` for a GAN, else
  ``{"train", "eval"}``.
* the model family follows the name: a Mix-StAGE style generator with its
  pose-style encoder, ``StyleClassifier_G``, or a simple generator
  (``Speech2Gesture_G``) on the early-fused inputs.
* ``weighted``: D has two classes; before each step D in eval mode scores
  the real poses and ``W = clip(1 / p_real, 0.1, 10)`` per sample weighs
  G's losses by ``1 / W`` (``:257-271``); ``joint``: D sees the velocity
  concatenated with the input streams (``:245-255``).
* ``noise`` adds ``noise · N(0, 1)`` to the target pose, drawn by
  ``pose_noise``; ``p_dropout`` drops in every ``ConvNormRelu`` of the
  modules run in training mode.  Each step takes an ``rng`` (a seed or a
  ``torch.Generator``; None is seed 0) and splits a noise and a dropout
  generator from it (``split_rng``), as JAX splits ``noise_rng`` and
  ``drop_rng``.  The draws are torch's, not JAX's.
* a batch with ``confidence`` adds the confidence entropy loss to G's
  total (``:273-281``).
* ``some_grad_flag`` freezes psenc's parameters for the id_out loss only.
* The λ ramp reads ``lambda_step``; both GAN steps advance it.  The
  curriculum ``use_pose_input`` coin is a Python argument.
* ``fused_decoder``: the backbone runs through autograd and the mixture
  decoder through kernel K3 (``ops/cuda/train_decoder.py``); the decoder's
  running statistics take the flax rule from K3's batch mean / variance.
  It needs ``p_dropout == 0`` (``:338-339``).  Another model ignores the
  flag, as JAX reads it only in the Mix-StAGE generator's forward
  (``:310``): its step runs unfused, K3 launched 0 times.
* ``dtype=torch.bfloat16`` (``steps.py:136-137``): the modules compute in
  bf16 with float32 parameters, BatchNorm statistics and optimizer state;
  the batch's float leaves are cast to bf16 (``bench.py:227-229``), the
  losses are computed in bf16 as flax computes them and returned as
  float32 scalars (``steps.py:689-695``), the pose in bf16.  K3 runs its
  bf16 mode.
* ``dtype=torch.float64`` (the parity mode): float64 parameters,
  statistics, optimizer state and losses.  K3 has no float64 mode, so
  ``fused_decoder`` at float64 is refused on the card (its plain versions
  run it on the CPU).
* text input streams (``text/w2v``, ``text/bert``): the Mix-StAGE
  generator gets a ``text_encoder`` on ``text_channels`` (else the
  stream's own width, ``text_channels()``) and fuses several streams
  through its ``concat_encoder``; a
  simple generator takes the streams concatenated on the channels (early
  fusion).  The joint D counts each text stream's width.
  ``optim_separate`` gives G's optimizer the text encoder's own constant
  learning rate (``state.SeparateTextOptimizer``; D's has none).
* a Disentangle generator (``models/registry.py``) gets ``style_losses``
  as its keyword; its ``internal_losses`` join the G total and, detached,
  the D total, and the k-step driver carries their keys.  The fused G step
  runs the generator's ``backbone``, which emits none, so there they are
  absent, as in the JAX package (``steps.py:323-356``).

* ``layout`` (``parallel/mesh.py``, one rank a process): every step takes
  the global batch, moves it to the device (the pose noise is drawn at its
  global shape, so it is the single-process draw), keeps its rank's rows
  (``shard_batch``; a batch that does not split stays whole) and runs
  under ``batch_stats``, so BatchNorm and K3 take the global batch's
  statistics; gradients are averaged over the data group before the
  optimizer's clip, and the step returns the global losses (scalars: the
  means over the ranks; ``W``: gathered) and the global pose, as JAX's
  GSPMD step does.  Dropout masks are drawn at each rank's shape.  Under
  expert parallelism (``shard_state_mixture``) the generator decodes its
  rank's experts.
* A step is a host half (``_begin``: the modes, λ and the optimizer's
  step scalars into device slots), a device half (``_body``) and the
  host counters (``_count``); the k-step function replays the device half
  as a CUDA graph where it can (``train/graphs.py``).
* Under a ``torch.profiler`` trace each train step is a span
  (``train/profiling.py``): ``train.g_step`` (the simple and the
  classifier's steps too) or ``train.d_step``, with the id ``graph`` (1
  for a replay, else 0); an op-by-op step's holds one ``train.forward``
  (G's forward, a D step's no-grad one too, D's scores and the losses),
  one ``train.backward`` (``torch.autograd.grad``) and one
  ``train.update`` (the gradients' all-reduce, clip and optimizer).

Configurations the port does not cover raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import inspect
from functools import partial
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from mixstage_tpu_torch.device import resolve_device
from mixstage_tpu_torch.models.layers import (PoseStyleEncoder,
                                              confidence_entropy_loss,
                                              dropout_rng, reset_parameters_,
                                              resolve_audio_lowerings,
                                              softmax)
from mixstage_tpu_torch.models.registry import (DISENTANGLE_INTERNAL_LOSSES,
                                                get_model_def,
                                                infer_discriminator_name)
from mixstage_tpu_torch.parallel.mesh import (all_gather, all_reduce_grads,
                                              batch_stats, batch_stats_group,
                                              mean_over_data, shard_batch,
                                              stats_exchange)
from mixstage_tpu_torch.train import losses as L
from mixstage_tpu_torch.train.graphs import STEP_SPAN, StepGraphs
from mixstage_tpu_torch.train.profiling import span
from mixstage_tpu_torch.train.state import (TrainState, g_named_parameters,
                                            make_optimizer,
                                            translate_optim_kwargs)

Batch = Dict[str, Any]
Rng = Union[None, int, torch.Generator]

# the joint D's extra input channels per stream (steps.py:178-183)
JOINT_CHANNELS = {"audio/log_mel_512": 128, "audio/log_mel_400": 64,
                  "text/w2v": 300, "text/bert": 768}


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
    def fuses_decoder(self) -> bool:
        """``fused_decoder`` where it applies: a Mix-StAGE generator."""
        return self.fused_decoder and self.has_style

    @property
    def d_prob(self) -> float:
        r = self.dg_iter_ratio
        return r / (r + 1.0)


def _unsupported(cfg: StepConfig) -> Optional[str]:
    """Why the port cannot run ``cfg`` (None when it can)."""
    if cfg.fuses_decoder and cfg.p_dropout > 0:
        return (f"-fused_decoder requires p_dropout == 0 (steps.py:338-339):"
                f" K3 has no dropout (ROADMAP queue 3)")
    return None


def _float_to(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A float leaf in the compute ``dtype``: through float32 (the batch's
    dtype, ``bench.py:227-229``), or straight to float64."""
    return t.to(dtype) if dtype == torch.float64 else t.float().to(dtype)


def _to_device(batch: Batch, device, dtype=torch.float32) -> Batch:
    """The batch on ``device``, its float leaves in the compute ``dtype``."""
    out = {}
    for k, v in batch.items():
        if v is None:
            out[k] = None
        elif k == "x":
            out[k] = [_float_to(torch.as_tensor(a, device=device), dtype)
                      for a in v]
        else:
            t = torch.as_tensor(np.asarray(v) if not torch.is_tensor(v)
                                else v, device=device)
            out[k] = _float_to(t, dtype) if t.is_floating_point() else t
    return out


def split_rng(rng: Rng, device) -> Tuple[torch.Generator, torch.Generator]:
    """(noise, dropout) generators on ``device`` from a step's ``rng``: a
    seed (two seeds spawned from it by numpy's ``SeedSequence``), a
    ``torch.Generator`` (two seeds drawn from it) or None (seed 0)."""
    if isinstance(rng, torch.Generator):
        seeds = torch.randint(0, 2 ** 62, (2,), generator=rng,
                              device=rng.device).tolist()
    else:
        seq = np.random.SeedSequence(0 if rng is None else int(rng))
        seeds = [int(child.generate_state(1, np.uint64)[0] >> np.uint64(1))
                 for child in seq.spawn(2)]
    return tuple(torch.Generator(device=device).manual_seed(s)
                 for s in seeds)


def pose_noise(shape, dtype, device, generator) -> torch.Tensor:
    """N(0, 1) noise of ``shape`` for the target pose (``steps.py:480-484``):
    every draw of the steps' noise stream goes through this function."""
    return torch.randn(shape, generator=generator, dtype=dtype, device=device)


def resize_nearest_time(x, length: int):
    """(B, T, C) → (B, length, C) as ``jax.image.resize(..., "nearest")``
    takes it: source frame ``floor((i + 0.5) · T / length)`` in float32
    (half-pixel centres: torch's ``mode="nearest"`` takes ``floor(i · T /
    length)``, ``"nearest-exact"`` this rule)."""
    T = x.shape[1]
    if T == length:
        return x
    src = (torch.arange(length, dtype=torch.float32, device=x.device)
           + 0.5) * T / length
    return x.index_select(1, src.floor().long().clamp_max(T - 1))


class StepFactory:
    """Builds the train state and the step callables for a StepConfig.

    ``device=None`` is the CUDA card (raises without one); the tests pass
    ``device="cpu"``.  ``layout``: the data-parallel (or data × expert)
    layout the steps run under (None: one device)."""

    def __init__(self, cfg: StepConfig, g_schedule=None, d_schedule=None,
                 device=None, layout=None):
        why = _unsupported(cfg)
        if why:
            raise NotImplementedError(why)
        self.cfg = cfg
        self.layout = layout
        self.device = resolve_device(device)
        if cfg.fuses_decoder and cfg.dtype == torch.float64 and \
                self.device.type == "cuda":
            raise NotImplementedError(
                "-fused_decoder at float64: K3 has float32 and bfloat16 "
                "modes only; the float64 parity mode runs the unfused "
                "decoder on the card (ROADMAP queue 3)")
        self.gen_cls = get_model_def(cfg.model)
        if cfg.audio_lowering and "audio_lowerings" in \
                inspect.signature(self.gen_cls).parameters:
            # JAX checks the plan of a generator that takes one
            # (``steps.py:142-146``); the native convs run for every plan
            resolve_audio_lowerings(cfg.audio_lowering)
        self.disc_cls = None
        if cfg.gan:
            d_name = cfg.discriminator or infer_discriminator_name(cfg.model)
            try:
                self.disc_cls = get_model_def(d_name)
            except (KeyError, NotImplementedError):
                # the JAX package (and the reference) fall back to the
                # shared D (steps.py:170-177)
                self.disc_cls = get_model_def("Speech2Gesture_D")
        self.criterion = L.get_criterion(cfg.criterion,
                                         **dict(cfg.loss_kwargs))
        opt_kw = translate_optim_kwargs(dict(cfg.optim_kwargs))
        if cfg.optim_mu_dtype and cfg.optim in ("Adam", "AdamW"):
            opt_kw["mu_dtype"] = cfg.optim_mu_dtype
        self.g_tx = make_optimizer(cfg.optim, cfg.lr, schedule=g_schedule,
                                   text_lr=cfg.optim_separate, **opt_kw)
        self.d_tx = make_optimizer(cfg.optim, cfg.lr, schedule=d_schedule,
                                   **opt_kw) if cfg.gan else None
        self._lambda_slot = None

    # ------------------------------------------------------------------ init
    def d_in_channels(self) -> int:
        """D's input width: the pose velocity, and the input streams when
        ``joint`` (``steps.py:178-183``)."""
        cfg = self.cfg
        extra = sum(JOINT_CHANNELS.get(m, 0) for m in cfg.input_modalities)
        return cfg.out_feats + (extra if cfg.joint else 0)

    def text_channels(self) -> Optional[int]:
        """The text encoder's input width when an input stream is text:
        ``text_channels``, else the stream's own width (``text/w2v`` 300,
        ``text/bert`` 768; flax infers it from the data), else 300
        (``mix_stage.py:70-73``); None without a text stream (flax builds
        no text encoder then)."""
        text = [m for m in self.cfg.input_modalities
                if m.split("/")[0] == "text"]
        if not text:
            return None
        return self.cfg.text_channels or JOINT_CHANNELS.get(text[0], 300)

    def build_modules(self):
        """(gen, psenc or None, disc or None) of the model family
        (``steps.py:130-199``); at float64 moved to float64."""
        cfg = self.cfg
        mk = dict(cfg.model_kwargs)
        if "Disentangle" in cfg.model:
            mk.setdefault("style_losses", dict(cfg.style_losses))
        common = dict(dtype=cfg.dtype, p=cfg.p_dropout)
        psenc = disc = None
        if cfg.has_style:
            gen = self.gen_cls(out_feats=cfg.out_feats,
                               num_clusters=cfg.num_clusters or 1,
                               num_speakers=cfg.num_speakers,
                               style_dim=cfg.style_dim,
                               input_modalities=cfg.input_modalities,
                               text_channels=self.text_channels(),
                               **common, **mk)
            psenc = PoseStyleEncoder(input_channels=cfg.out_feats,
                                     num_speakers=cfg.num_speakers, **common)
        elif cfg.is_classifier:
            gen = self.gen_cls(in_channels=cfg.out_feats,
                               num_speakers=cfg.num_speakers, **common, **mk)
        else:
            gen = self.gen_cls(out_feats=cfg.out_feats, **common, **mk)
        if cfg.gan:
            disc = self.disc_cls(in_channels=self.d_in_channels(),
                                 out_shape=2 if cfg.weighted else 1,
                                 **common)
        modules = (gen, psenc, disc)
        if cfg.dtype == torch.float64:
            for m in modules:
                if m is not None:
                    m.double()
        return modules

    def _state(self, gen, psenc, disc) -> TrainState:
        gen, psenc, disc = (None if m is None else m.to(self.device)
                            for m in (gen, psenc, disc))
        return TrainState(
            gen=gen, psenc=psenc, disc=disc,
            g_opt=self.g_tx(g_named_parameters(gen, psenc)),
            d_opt=None if disc is None else
            self.d_tx(list(disc.named_parameters())))

    def init(self, seed: int = 0) -> TrainState:
        """Fresh modules with weights drawn from ``seed`` (on the CPU, then
        moved), zero optimizer state and counters."""
        gen = torch.Generator().manual_seed(seed)
        modules = self.build_modules()
        for m in modules:
            if m is not None:
                reset_parameters_(m, gen)
        return self._state(*modules)

    def init_from_flax(self, g_params, g_state, d_params=None, d_state=None,
                       g_opt_state=None, d_opt_state=None,
                       counters: Optional[Dict[str, int]] = None
                       ) -> TrainState:
        """A state carrying a JAX ``TrainState``'s trees (numpy-convertible):
        params, batch stats and, when given, the optimizer states and the
        counters."""
        from mixstage_tpu_torch.interop.weights import (load_flax_opt_state,
                                                        load_flax_state)
        gen, psenc, disc = self.build_modules()
        load_flax_state(gen, g_params["gen"], g_state["gen"])
        g_mods = {"gen": gen}
        if psenc is not None:
            load_flax_state(psenc, g_params["psenc"], g_state["psenc"])
            g_mods["psenc"] = psenc
        if disc is not None:
            load_flax_state(disc, d_params, d_state)
        state = self._state(gen, psenc, disc)
        if g_opt_state is not None:
            load_flax_opt_state(state.g_opt, g_mods, g_opt_state)
        if d_opt_state is not None and disc is not None:
            load_flax_opt_state(state.d_opt, {None: disc}, d_opt_state)
        for k, v in (counters or {}).items():
            setattr(state, k, int(v))
        return state

    @torch.no_grad()
    def check(self, state: TrainState, batch: Batch) -> None:
        """Run G (and D) once on ``batch`` in eval mode, changing nothing,
        as flax's init runs the modules on the JAX trainer's first batch:
        input streams that do not fit the modules (a 1-D text stream, text
        of another length than the audio) raise here, at set-up."""
        self.make_steps()["eval"](state, batch)
        if state.disc is not None:
            b = _to_device(batch, self.device, self.cfg.dtype)
            self._modes(state, False, False)
            self._apply_disc(state, self._d_input(b["y"], b["x"]))

    # --------------------------------------------------------------- helpers
    def _prepare(self, batch: Batch, rng: Rng):
        """The batch on the device (with the pose noise added to ``y``) and
        the step's dropout generator (None when nothing draws)."""
        cfg = self.cfg
        batch = _to_device(batch, self.device, cfg.dtype)
        if cfg.noise <= 0 and cfg.p_dropout <= 0:
            return batch, None
        noise_gen, drop_gen = split_rng(rng, self.device)
        if cfg.noise > 0:
            y = batch["y"]
            batch = {**batch, "y": y + cfg.noise * pose_noise(
                tuple(y.shape), y.dtype, y.device, noise_gen)}
        return batch, drop_gen

    def _style_weights_train(self, psenc_score, T):
        """Per-window speaker scores broadcast over time, soft / hard
        selected (``steps.py:284-295``)."""
        cfg = self.cfg
        score = psenc_score[:, None, :].expand(-1, T, -1)
        if cfg.softmax:
            w = softmax(score, dim=-1)
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
        as ``DecoderTrain`` (its statistics exchanged over the data group
        under data parallelism; the rank's experts under expert
        parallelism); its running statistics take the flax rule from K3's
        batch mean and (biased) variance."""
        from mixstage_tpu_torch.ops.cuda.train_decoder import \
            fused_decoder_train

        gen = state.gen
        x_feat, labels_score, labels_cap_soft = gen.backbone(
            list(batch["x"]), batch["y"], style_weights, **kwargs)
        exchange = stats_exchange(batch_stats_group())
        stats = []

        def decode(x):
            xr, mu, var = fused_decoder_train(x, gen, exchange)
            stats.append((mu, var))
            return xr

        pose = gen.mixture(x_feat, labels_cap_soft, decode)
        mu, var = stats[0]
        for i, layer in enumerate(gen.decoder_layers()):
            layer.norm.update_running_stats(mu[:, i].reshape(-1),
                                            var[:, i].reshape(-1))
        return {"pose": pose, "labels_score": labels_score,
                "labels_cap_soft": labels_cap_soft}

    def _apply_disc(self, state, x):
        return state.disc(x)[0]

    @staticmethod
    def _fuse_inputs(x_list):
        """Early fusion for the single-stream models (``steps.py:239-243``)."""
        x_list = list(x_list)
        return x_list[0] if len(x_list) == 1 else torch.cat(x_list, dim=-1)

    def _d_input(self, pose, x_list):
        """Velocity fed to D, ⊕ the input streams when ``joint``
        (``steps.py:245-255``); a stream whose length differs from the
        pose's is resized to it (``resize_nearest_time``)."""
        v = L.velocity(pose)
        if not self.cfg.joint:
            return v
        xs = [resize_nearest_time(x, v.shape[1])
              for x in list(x_list)[:len(self.cfg.input_modalities)]]
        return torch.cat([v] + xs, dim=-1)

    @torch.no_grad()
    def _estimate_weights(self, state, real_v):
        """Per-sample weights from the 2-class D in eval mode
        (``steps.py:257-271``): ``clip(1 / clip(p_real, 1e-3, 1), 0.1,
        10)``, p_real the softmax's class 1 averaged over time."""
        training = state.disc.training
        state.disc.eval()
        score = state.disc(real_v)[0]
        state.disc.train(training)
        p_real = softmax(score, dim=-1)[..., 1].mean(dim=1)
        return (1.0 / p_real.clamp(1e-3, 1.0)).clamp(0.1, 10.0)

    def _weights(self, state, batch):
        """W (B,): estimated when ``weighted``, else ones."""
        if self.cfg.weighted:
            return self._estimate_weights(
                state, self._d_input(batch["y"], batch["x"]))
        return torch.ones((batch["y"].shape[0],), device=self.device,
                          dtype=self.cfg.dtype)

    def _with_confidence(self, total, batch, y, pose):
        """``total`` plus the confidence entropy loss when the batch carries
        ``confidence`` (``steps.py:273-281``; JAX adds a 0 otherwise)."""
        if batch.get("confidence") is None:
            return total
        conf = batch["confidence"].reshape(y.shape)
        return total + confidence_entropy_loss(y, pose, conf, beta=1.0,
                                               epsilon=0.5).mean()

    # ------------------------------------------------- generator forward core
    def _style_forward(self, state, batch, use_pose_input, train,
                       sample_flag):
        """Mix-StAGE forward with the style machinery and the id / cluster
        losses (``steps.py:379-437``): (pose, losses, aux)."""
        cfg = self.cfg
        T = batch["y"].shape[1]
        psenc_flag = (not sample_flag) and (train or not cfg.train_only)
        zero = torch.zeros((), device=self.device, dtype=cfg.dtype)
        if psenc_flag:
            score = self._apply_psenc(state, batch["y"])
            id_in = L.cross_entropy(score, batch["style"][:, 0])
            style_weights = self._style_weights_train(score, T)
        elif batch.get("style_soft") is not None:
            id_in = zero
            style_weights = batch["style_soft"].to(cfg.dtype)
        else:
            id_in = zero
            style_weights = F.one_hot(batch["style"].long(),
                                      cfg.num_speakers).to(cfg.dtype)
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
        # a Disentangle generator's named internal losses (already weighted
        # by its style_losses) join the total (steps.py:430-435)
        losses.update(out.get("internal_losses", {}))
        return pose, losses, {"labels_cap_soft": out.get("labels_cap_soft")}

    def _forward(self, state, batch, use_pose_input, train, sample_flag):
        """The model family's forward: (pose, internal losses, aux)."""
        if self.cfg.has_style:
            return self._style_forward(state, batch, use_pose_input, train,
                                       sample_flag)
        # a simple generator on the early-fused inputs (steps.py:358-367,
        # :446-449)
        pose, internal = state.gen(self._fuse_inputs(batch["x"]),
                                   batch["y"])
        return pose, {f"internal_{i}": v for i, v in enumerate(internal)}, {}

    def _lambda(self, step: int, init: float) -> torch.Tensor:
        """The λ ramp's weight at ``step`` in its device slot: a host float
        in float32 (float64 at float64, where JAX's ramp is float64), put
        into a 0-d float32 (float64) tensor that the steps read, so that a
        captured step reads each step's value.  At bfloat16 the float32
        slot keeps the weighted GAN loss (and the total) float32, as JAX's
        device-computed λ keeps them (``losses.py:81-93``)."""
        dt = torch.float64 if self.cfg.dtype == torch.float64 \
            else torch.float32
        if self._lambda_slot is None:
            self._lambda_slot = torch.zeros((), dtype=dt, device=self.device)
        self._lambda_slot.fill_(L.lambda_schedule(step, init, dtype=dt))
        return self._lambda_slot

    def _out(self, losses):
        """Loss values as float32, whatever the compute dtype
        (``steps.py:689-695``; at float32 the tensors themselves), float64
        at float64 (the JAX package's per-step values in its x64 mode)."""
        dt = torch.float64 if self.cfg.dtype == torch.float64 \
            else torch.float32
        return {k: v.detach().to(dt) for k, v in losses.items()}

    @staticmethod
    def _modes(state, g_train: bool, d_train: bool):
        state.gen.train(g_train)
        if state.psenc is not None:
            state.psenc.train(g_train)
        if state.disc is not None:
            state.disc.train(d_train)

    def _step_g_opt(self, state, total):
        with span("train.backward"):
            grads = torch.autograd.grad(total, state.g_opt.params,
                                        allow_unused=True)
        with span("train.update"):
            state.g_opt.update(all_reduce_grads(
                [torch.zeros_like(p) if g is None else g
                 for g, p in zip(grads, state.g_opt.params)], self.layout))

    def _shard(self, batch):
        """(this rank's rows of the device batch, whether it was split):
        the batch itself without a data-parallel layout or when its size
        does not divide the data extent (then every rank runs all of it)."""
        lay = self.layout
        if lay is None or not lay.divides(batch["y"].shape[0]):
            return batch, False
        return shard_batch(batch, lay), True

    def _report(self, losses, pose, sharded):
        """The step's (losses, pose) as the single-device step returns them:
        for a split batch the scalar losses averaged over the data group,
        ``W`` and the pose gathered."""
        losses = self._out(losses)
        if not sharded:
            return losses, pose
        return mean_over_data(losses, self.layout), \
            all_gather(pose.contiguous(), self.layout.data_group)

    # ----------------------------------------------------------------- steps
    def make_steps(self):
        """The step callables of this config: {"g", "d", "eval"} for a GAN,
        {"train", "eval"} otherwise (``steps.py:452-474``)."""
        cfg = self.cfg
        if cfg.is_classifier:
            return {"train": self._classifier_step,
                    "eval": partial(self._classifier_step, train=False)}
        if not cfg.gan:
            return {"train": self._simple_train_step,
                    "eval": self._eval_step}
        return {"g": self._g_step, "d": self._d_step, "eval": self._eval_step}

    def _simple_train_step(self, state: TrainState, batch: Batch,
                           rng: Rng = None, use_pose_input: bool = False):
        """Non-GAN step (``steps.py:477-505``): (state, losses, pose)."""
        return self._eager("train", state, batch, rng, use_pose_input)

    def _g_step(self, state: TrainState, batch: Batch, rng: Rng = None,
                use_pose_input: bool = False):
        """GAN G step (``steps.py:508-554``): (state, losses, pose)."""
        return self._eager("g", state, batch, rng, use_pose_input)

    def _d_step(self, state: TrainState, batch: Batch, rng: Rng = None,
                use_pose_input: bool = False):
        """GAN D step (``steps.py:557-605``): (state, losses, pose)."""
        return self._eager("d", state, batch, rng, use_pose_input)

    def _eager(self, kind: str, state: TrainState, batch: Batch, rng: Rng,
               use_pose_input: bool):
        """One step of ``kind`` ("train": non-GAN, "g", "d") run op by op:
        the batch to the device, the host half (``_begin``), the device
        half (``_body``), the counters (``_count``)."""
        with span(STEP_SPAN[kind], graph=0):
            batch, drop_gen = self._prepare(batch, rng)
            batch, sharded = self._shard(batch)
            self._begin(kind, state)
            losses, pose = self._body(kind, state, batch, drop_gen, sharded,
                                      use_pose_input)
            self._count(kind, state)
            return (state, *self._report(losses, pose, sharded))

    def _begin(self, kind: str, state: TrainState) -> None:
        """A step's host half: the modules' modes, then λ and the
        optimizer's step scalars into their device slots."""
        cfg = self.cfg
        if kind == "d":
            self._modes(state, False, True)
            self._lambda(state.lambda_step, cfg.lambda_D)
            state.d_opt.advance()
            return
        self._modes(state, True, kind == "g")
        if kind == "g":
            self._lambda(state.lambda_step, cfg.lambda_gan)
        state.g_opt.advance()

    @staticmethod
    def _count(kind: str, state: TrainState) -> None:
        """The host counters a step of ``kind`` advances."""
        state.step += 1
        if kind != "d":
            state.g_step += 1
            state.curriculum_step += 1
        if kind != "train":
            state.lambda_step += 1

    def _body(self, kind: str, state: TrainState, batch: Batch, drop_gen,
              sharded: bool, use_pose_input: bool):
        """A step's device half, after ``_begin``: (losses, pose).  It
        reads λ and the optimizer's scalars from their slots and no other
        host value that changes from step to step, so the k-step
        function can capture it (``train/graphs.py``)."""
        body = {"train": self._simple_body, "g": self._g_body,
                "d": self._d_body}[kind]
        return body(state, batch, drop_gen, sharded, use_pose_input)

    def _simple_body(self, state, batch, drop_gen, sharded, use_pose_input):
        y = batch["y"]
        with torch.enable_grad(), dropout_rng(drop_gen), \
                batch_stats(self.layout, sharded):
            with span("train.forward"):
                pose, internal, _ = self._forward(state, batch,
                                                  use_pose_input, True,
                                                  False)
                pose_loss = self.criterion(pose, y).mean()
                total = self._with_confidence(pose_loss, batch, y, pose) + \
                    sum(internal.values())
            self._step_g_opt(state, total)
        return {"pose": pose_loss, "total": total, **internal}, pose.detach()

    def _g_body(self, state, batch, drop_gen, sharded, use_pose_input):
        cfg = self.cfg
        y = batch["y"]
        W = self._weights(state, batch)
        with torch.enable_grad(), dropout_rng(drop_gen), \
                batch_stats(self.layout, sharded):
            with span("train.forward"):
                pose, internal, _ = self._forward(state, batch,
                                                  use_pose_input, True,
                                                  False)
                d_score = self._apply_disc(state,
                                           self._d_input(pose, batch["x"]))
                if cfg.no_grad:
                    d_score = d_score.detach()
                G_gan = self._lambda_slot * L.sample_wise_weight_mean(
                    self.criterion(d_score, torch.ones_like(d_score)),
                    1.0 / W)
                pose_loss = L.sample_wise_weight_mean(
                    self.criterion(pose, y), 1.0 / W)
                total = self._with_confidence(pose_loss + G_gan, batch, y,
                                              pose) + sum(internal.values())
            self._step_g_opt(state, total)
        return {"pose": pose_loss, "G_gan": G_gan, "total": total, "W": W,
                **internal}, pose.detach()

    def _d_body(self, state, batch, drop_gen, sharded, use_pose_input):
        y = batch["y"]
        W = self._weights(state, batch)
        with span("train.forward"):
            with torch.no_grad():
                pose, internal, _ = self._forward(state, batch,
                                                  use_pose_input, False,
                                                  False)
            fake_v, real_v = self._d_input(pose, batch["x"]), \
                self._d_input(y, batch["x"])
            with torch.enable_grad(), dropout_rng(drop_gen), \
                    batch_stats(self.layout, sharded):
                fake_score = self._apply_disc(state, fake_v)
                real_score = self._apply_disc(state, real_v)
                fake_D = self._lambda_slot * L.sample_wise_weight_mean(
                    self.criterion(fake_score,
                                   torch.zeros_like(fake_score)),
                    torch.ones_like(W))
                real_D = L.sample_wise_weight_mean(
                    self.criterion(real_score, torch.ones_like(real_score)),
                    torch.ones_like(W))
                total = real_D + fake_D + sum(internal.values())
        # the masks and the statistics' group were taken in the forward
        with span("train.backward"):
            grads = torch.autograd.grad(total, state.d_opt.params)
        with span("train.update"):
            state.d_opt.update(all_reduce_grads(grads, self.layout))
        return {"real_D": real_D, "fake_D": fake_D, "total": total, "W": W,
                **internal}, pose

    @torch.no_grad()
    def _eval_step(self, state: TrainState, batch: Batch,
                   use_pose_input: bool = False, sample_flag: bool = False):
        """Eval / sampling forward (``steps.py:608-616``): (losses, pose,
        aux), every module in eval mode."""
        batch = _to_device(batch, self.device, self.cfg.dtype)
        batch, sharded = self._shard(batch)
        self._modes(state, False, False)
        pose, internal, aux = self._forward(state, batch, use_pose_input,
                                            False, sample_flag)
        pose_loss = self.criterion(pose, batch["y"]).mean()
        losses = {"pose": pose_loss,
                  "total": pose_loss + sum(internal.values()), **internal}
        losses, pose = self._report(losses, pose, sharded)
        if sharded:
            aux = {k: None if v is None else
                   all_gather(v.contiguous(), self.layout.data_group)
                   for k, v in aux.items()}
        return losses, pose, aux

    def _classifier_step(self, state: TrainState, batch: Batch,
                         rng: Rng = None, train: bool = True):
        """The style classifier's step (``steps.py:619-651``): on the pose
        ``y``, cross-entropy against the window's speaker, and the
        accuracy.  Training: (state, {"pose", "total", "acc"}, logits);
        ``train=False``: (losses, logits, {}), the model in eval mode."""
        batch = _to_device(batch, self.device, self.cfg.dtype)
        batch, sharded = self._shard(batch)
        y_true = batch["style"][:, 0].long()
        self._modes(state, train, False)
        if not train:
            with torch.no_grad():
                logits, _ = state.gen(batch["y"])
                loss = L.cross_entropy(logits, y_true)
            acc = (logits.argmax(-1) == y_true).float().mean()
            return (*self._report({"pose": loss, "total": loss, "acc": acc},
                                  logits, sharded), {})
        with span("train.g_step", graph=0):
            drop_gen = split_rng(rng, self.device)[1] \
                if self.cfg.p_dropout > 0 else None
            state.g_opt.advance()
            with torch.enable_grad(), dropout_rng(drop_gen), \
                    batch_stats(self.layout, sharded):
                with span("train.forward"):
                    logits, _ = state.gen(batch["y"])
                    loss = L.cross_entropy(logits, y_true)
                self._step_g_opt(state, loss)
        acc = (logits.argmax(-1) == y_true).float().mean()
        state.step += 1
        state.g_step += 1
        return (state, *self._report({"pose": loss, "total": loss,
                                      "acc": acc}, logits.detach(), sharded))

    # -- multi-step training driver -------------------------------------------
    def union_keys(self) -> Sequence[str]:
        """The loss keys of both branches (``steps.py:674-684``); ``W`` is a
        (B,) entry."""
        keys = {"pose", "G_gan", "real_D", "fake_D", "total"}
        if self.cfg.has_style:
            keys |= {"label", "id_in", "id_out"}
        if "Disentangle" in self.cfg.model:
            keys |= set(DISENTANGLE_INTERNAL_LOSSES)
        if self.cfg.gan and self.cfg.weighted:
            keys |= {"W"}
        return sorted(keys)

    def _row(self, losses, keys) -> torch.Tensor:
        """One step's losses as one float32 row: each of ``keys`` in order
        (0 where the step has none), ``W``'s B entries in its place."""
        zero = torch.zeros((1,), device=self.device)
        return torch.cat([losses[key].float().reshape(-1) if key in losses
                          else zero for key in keys])

    @staticmethod
    def _columns(rows, keys) -> Dict[str, torch.Tensor]:
        """The (k, n) rows of a call as {key: (k,), W: (k, B)}."""
        B = rows.shape[1] - len(keys) + 1
        out, j = {}, 0
        for key in keys:
            n = B if key == "W" else 1
            col = rows[:, j:j + n]
            out[key] = col if key == "W" else col[:, 0]
            j += n
        return out

    def _graphable(self) -> bool:
        """Whether a replayed step computes what the op-by-op one does: on
        CUDA, with no data-parallel layout (its collectives are not
        captured), and nothing drawn per step (a replay cannot reseed the
        noise and dropout generators)."""
        cfg = self.cfg
        return self.device.type == "cuda" and self.layout is None and \
            cfg.noise <= 0 and cfg.p_dropout <= 0

    def make_scan_train_step(self, k: int):
        """k sequential train steps per call (``steps.py:656-723``):
        ``fn(state, stacked_batches, coins (k,) host bools: True = D step
        (ignored without a GAN), rngs=None (k seeds or generators)) →
        (state, {key: (k,) float32, W (k, B)}, poses (k, B, T, F) in the
        compute dtype)``.  The audio-input branch only, as in the JAX
        package; the losses stay on the device (no host sync per step).
        Where ``_graphable``, every call after the first on the same state
        and batch layout replays each kind of step as a CUDA graph
        (``train/graphs.py``); the first call, and a call after the state's
        tensors or the layout changed, runs op by op."""
        if self.cfg.is_classifier:
            raise ValueError("the k-step driver runs the generator's steps; "
                             "the classifier trains one step at a time")
        keys = self.union_keys()
        graphs = StepGraphs(self, keys) if self._graphable() else None

        def scan_step(state, batches: Batch, coins, rngs=None):
            coins = np.asarray(coins, dtype=bool)
            if coins.shape != (k,):
                raise ValueError(f"coins must have shape ({k},), got "
                                 f"{coins.shape}")
            replay = graphs is not None and graphs.engage(state, batches)
            rows = poses = None
            for i in range(k):
                batch = {key: None if v is None else
                         (type(v)(a[i] for a in v) if key == "x" else v[i])
                         for key, v in batches.items()}
                kind = "train" if not self.cfg.gan else \
                    ("d" if coins[i] else "g")
                if replay:
                    row, pose = graphs.step(kind, state, batch)
                else:
                    _, losses, pose = self._eager(
                        kind, state, batch, None if rngs is None else rngs[i],
                        False)
                    row = self._row(losses, keys)
                if rows is None:
                    rows = row.new_empty((k, *row.shape))
                    poses = pose.new_empty((k, *pose.shape))
                rows[i].copy_(row)
                poses[i].copy_(pose)
            if graphs is not None and not replay:
                graphs.settle(state, batches)
            return state, self._columns(rows, keys), poses

        return scan_step
