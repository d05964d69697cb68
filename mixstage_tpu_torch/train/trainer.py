"""Experiment lifecycle (host side): the port's counterpart of
``mixstage_tpu/train/trainer.py``.

One trainer owns the data, the transforms, the metrics, the bookkeeping,
the GAN and curriculum host coins, sampling and style transfer; the
per-batch compute is the port's ``StepFactory`` steps, which move each
numpy batch to the device.  ``Trainer(args, subset, update, device=None)``
runs on the card (``device="cpu"`` runs the plain versions on the CPU, as
the tests do).

``-num_devices N`` trains data-parallel over a process group of N ranks
(``parallel/mesh.py``), launched by ``torchrun --nproc_per_node N -m
mixstage_tpu_torch.cli.train ...`` (``cli.train`` joins the group through
``parallel/multihost.setup``); 0 takes the world, and N other than the
world's size raises ``ValueError``.  Rank r runs on ``cuda:(LOCAL_RANK %
device_count)``.  Every rank reads the same seeded global batch and draws
the same coins, the steps keep the rank's rows and return the global
losses and pose, so the run takes the single-process trainer's decisions.
Only rank 0 writes files (checkpoints, logs, metrics, h5 dumps, the data's
preprocessing files); the others wait for them at a barrier.

The host coins follow the JAX trainer draw for draw, so the two trainers
take the same D/G and curriculum decisions from the same ``-seed``: before
every step (train, dev or test) the JAX trainer draws a step key from the
coin generator (``trainer.py:465, 886, 971``); the port draws the same
number and seeds the step's noise and dropout generators with it
(``steps.split_rng``), so one ``-seed`` reproduces a run.

The model family sets the loop: the GAN's D/G coin, the non-GAN step
(``-gan 0``) and the style classifier (``-model StyleClassifier_G``, whose
metric is its accuracy, ``{split}_acc``).  The weighted GAN feeds its
sample weights back to the weighted sampler and, with
``-update_D_prob_flag``, to the D/G coin (``trainer.py:295-312``).  A
``-pretrained_model_weights`` checkpoint of ``StyleClassifier_G`` (the
port's or the JAX package's) turns on the style Inception Score.
``-render N`` renders the sampled keypoints after ``sample``
(``render_samples``: videos and the HTML grid).

Text (``-modalities`` with ``text/w2v`` or ``text/bert``): ``Data`` gets
``-repeat_text`` and ``-filler``, ZNorm skips the hidden keys
(``text/tokens``, ``text/filler``, ``audio/silence``) and the generator's
``text_channels`` come from the data's width.  ``-pos 1`` takes the cluster
labels from a loaded ``text/pos`` stream (raw, before ZNorm) in place of
the k-means labels, and changes nothing where none is loaded, as in the
JAX package.

Flags the port cannot run yet raise ``NotImplementedError`` naming their
ROADMAP item; none is ignored silently.
"""

from __future__ import annotations

import itertools
import json
import pickle as pkl
import sys
import time
from functools import partial
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

from mixstage_tpu_torch import evaluation
from mixstage_tpu_torch.bookkeeping import BookKeeper
from mixstage_tpu_torch.config import Config
from mixstage_tpu_torch.data.dataset import Data
from mixstage_tpu_torch.data.transforms import (Compose, KMeansTransform,
                                                Relative2Parent, RemoveJoints,
                                                ZNorm)
from mixstage_tpu_torch.parallel.mesh import (any_rank, make_mesh,
                                              replicate_state)
from mixstage_tpu_torch.parallel.multihost import local_device
from mixstage_tpu_torch.train.sampling import to_numpy
from mixstage_tpu_torch.train.state import make_schedule
from mixstage_tpu_torch.train.steps import StepConfig, StepFactory

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float64": torch.float64}
# the batch arrays' numpy dtype per compute dtype (bf16 batches travel as
# float32 and are cast on the device, as the steps cast them)
NP_DTYPES = {"float32": np.float32, "bfloat16": np.float32,
             "float64": np.float64}


def _expand_mask(mask) -> List[int]:
    """'range(x, y)' strings + ints → flat joint list (trainer.py:69)."""
    out = []
    for m in mask:
        if isinstance(m, int):
            out.append(m)
        else:
            out.extend(list(eval(m, {"range": range})))  # noqa: S307 - reference contract
    return out


def check_export_variants(args: Config) -> None:
    """Raise ``ValueError`` for an ``-export_variants`` name that is not
    one of the port's variants (``plain`` and ``kernel``, or the JAX
    package's ``xla`` and ``pallas`` for them; ``export.py``).  The flags
    the port does not run yet are refused by ``StepFactory`` (the step
    configuration) and ``cli.serve`` (``-serve_partition`` over more than
    one device)."""
    if args.export_dir:
        from mixstage_tpu_torch.export import resolve_variants

        resolve_variants([v.strip() for v in
                          (args.export_variants or "").split(",")
                          if v.strip()])


class TrainingPreempted(RuntimeError):
    """A preemption signal (SIGTERM) arrived mid-training; the live state has
    already been checkpointed (``BookKeeper.save_preempt``) when this is
    raised.  ``cli.train`` turns it into exit code 75 (EX_TEMPFAIL) so
    cluster schedulers retry the same command, which auto-resumes."""


class Trainer:
    """The Mix-StAGE GAN trainer's lifecycle: data, steps, metrics, files."""

    def __init__(self, args: Config, args_subset=None, args_dict_update=None,
                 device=None):
        # the layout follows the command line's -num_devices (not a
        # restored checkpoint's): N ranks, or the world for 0
        self.layout = make_mesh(args.num_devices)
        if device is None and self.layout.world > 1:
            device = local_device("cuda")
        self.book = BookKeeper(args, args_subset,
                               args_dict_update=args_dict_update or {},
                               tensorboard=args.tb, layout=self.layout)
        self.args = args = self.book.args
        check_export_variants(args)

        self.path2data = args.path2data
        self.speaker = args.speaker if isinstance(args.speaker, list) \
            else [args.speaker]
        self.modalities = args.modalities
        self.input_modalities = args.input_modalities or self.modalities[1:]
        self.output_modalities = args.output_modalities or self.modalities[:1]
        self.output_modality = self.output_modalities[0]
        self.mask = _expand_mask(args.mask)
        self.batch_size = args.batch_size
        self.time = args.time
        self.fs_new = args.fs_new if isinstance(args.fs_new, list) \
            else [args.fs_new] * len(self.modalities)
        self.window_hop = args.window_hop
        self.num_epochs = args.num_epochs
        self.num_clusters = args.num_clusters
        self.feats = args.feats
        self.style_iters = args.style_iters
        self.sample_all_styles = args.sample_all_styles
        self.fp = DTYPES[args.dtype]
        self.np_fp = NP_DTYPES[args.dtype]

        # ------------------------------------------------------------- data
        # rank 0 opens the data (which writes its missing-interval ledger)
        # and fits and writes the preprocessing files; the others read them
        # after it
        self._after_rank0()
        self.data = Data(self.path2data, self.speaker, self.modalities,
                         self.fs_new, time=self.time, split=args.split,
                         batch_size=self.batch_size,
                         shuffle=bool(args.shuffle),
                         window_hop=self.window_hop,
                         style_iters=self.style_iters,
                         num_training_sample=args.num_training_sample,
                         load_data=bool(args.load_data),
                         sample_all_styles=self.sample_all_styles,
                         repeat_text=args.repeat_text,
                         quantile_sample=args.quantile_sample,
                         quantile_num_training_sample=args.quantile_num_training_sample,
                         weighted=args.weighted, filler=args.filler,
                         num_training_iters=args.num_training_iters)
        self.data_train = self.data.train
        self.data_dev = self.data.dev
        self.data_test = self.data.test
        self.style_dict = self.data.style_dict
        self.data_shape = self.data.shape
        self.parents = self.data.modality_classes[self.output_modality].parents
        print("Data Loaded")

        # --------------------------------------------------------- transforms
        pre_dir = (Path(self.path2data) / "preprocessing").as_posix()
        self.cluster = None
        if self.num_clusters is not None:
            self.cluster = KMeansTransform(
                [self.output_modality], savepath=f"{pre_dir}/kmeans",
                key=self.speaker, data=self.data_train,
                num_clusters=self.num_clusters, mask=self.mask,
                feats=self.feats, seed=args.seed)
        pre_transforms = []
        pre_op = None
        if args.relative2parent:
            pre_transforms.append(Relative2Parent())
            pre_op = Compose(list(pre_transforms))
        hidden = ["text/tokens", "text/filler", "audio/silence"]
        znorm_modalities = [m for m in self.modalities if m not in hidden]
        pre_transforms.append(ZNorm(znorm_modalities, savepath=f"{pre_dir}/muvar",
                                    key=self.speaker, data=self.data_train,
                                    relative2parent=args.relative2parent,
                                    pre=pre_op))
        self.pre = Compose(pre_transforms)
        self.transform = Compose([RemoveJoints(self.mask, self.parents)])
        self._release_ranks()

        if args.preprocess_only:
            # reference exits after data preprocessing (trainer.py:131-133)
            print("Data Preprocessing done")
            raise SystemExit(1)

        # ------------------------------------------------------------- steps
        out_feats = self.data_shape[self.output_modality][-1] - 2 * len(self.mask)
        text_channels = None
        for key in ("text/w2v", "text/bert"):
            if key in self.data_shape:
                text_channels = self.data_shape[key][-1]
        mk = dict(args.modelKwargs or {})
        steps_per_epoch = max(len(self.data_train), 1)
        total_steps = steps_per_epoch * self.num_epochs
        schedule = make_schedule(args.scheduler, args.lr, args.gamma,
                                 args.scheduler_warmup_steps, total_steps,
                                 steps_per_epoch)
        self.step_cfg = StepConfig(
            model=args.model, gan=bool(args.gan), criterion=args.loss,
            input_modalities=tuple(self.input_modalities),
            time_steps=self.data_shape[self.input_modalities[0]][0],
            out_feats=out_feats, num_clusters=self.num_clusters,
            num_speakers=len(self.style_dict), style_dim=args.style_dim,
            text_channels=text_channels, lambda_id=mk.pop("lambda_id", 1.0),
            train_only=bool(mk.pop("train_only", 0)),
            softmax=bool(mk.pop("softmax", 1)),
            argmax=bool(mk.pop("argmax", 0)),
            some_grad_flag=bool(mk.pop("some_grad_flag", False)),
            style_losses=tuple(sorted((args.style_losses or {}).items())),
            discriminator=args.discriminator,
            dg_iter_ratio=args.dg_iter_ratio, lambda_gan=args.lambda_gan,
            lambda_D=args.lambda_D, joint=bool(args.joint),
            no_grad=bool(args.no_grad), weighted=bool(args.weighted),
            lr=args.lr, optim=args.optim, noise=args.noise,
            loss_kwargs=tuple(sorted((args.lossKwargs or {}).items())),
            optim_kwargs=tuple(sorted((args.optimKwargs or {}).items())),
            optim_separate=args.optim_separate,
            optim_mu_dtype=args.optim_mu_dtype,
            fused_decoder=bool(args.fused_decoder),
            audio_lowering=args.audio_lowering,
            p_dropout=float(mk.pop("p", 0.0)), dtype=self.fp,
            model_kwargs=tuple(mk.items()))
        self.factory = StepFactory(self.step_cfg, g_schedule=schedule,
                                   d_schedule=schedule, device=device,
                                   layout=self.layout)
        self.device = self.factory.device
        self.steps = self.factory.make_steps()
        self._scan_k = int(args.scan_steps or 0)
        if args.weighted and args.update_D_prob_flag:
            # the chunk's D/G coins are flipped at its start, so the
            # adaptive D-prob lags by up to k steps: at most 8
            # (trainer.py:771-781)
            self._scan_k = min(self._scan_k, 8)
        # the classifier trains one step at a time (the JAX package's
        # k-step driver runs the generator's steps)
        self._scan_step = (self.factory.make_scan_train_step(self._scan_k)
                           if self._scan_k > 1 and
                           not self.step_cfg.is_classifier else None)
        self._schedule = schedule

        # --------------------------------------------------------- state/init
        self._coin = np.random.default_rng(args.seed or 0)
        self._preempted = False  # set by the SIGTERM handler, polled in loops
        self._d_prob = self.step_cfg.d_prob
        batch0 = self._peek_batch()   # the JAX trainer's init batch
        self.state = replicate_state(self.factory.init(seed=args.seed or 0),
                                     self.layout)
        self.factory.check(self.state, batch0)
        print("Model Created")
        if args.load:
            print("Loading Model")
            self.state = self.book._load_model(self.state)
            if args.save_optim:
                self.state = self.book._load_train_state(self.state)

        # ------------------------------------------------------------ metrics
        self.num_styles = len(self.style_dict)
        self._init_label_hist()
        self._after_rank0()             # the F1 metric's k-means file
        self._init_metrics()
        self._release_ranks()
        self.weight_counter: Dict[int, int] = {}

    def _after_rank0(self):
        """Opens a block that rank 0 runs first (it writes the data's
        files): the other ranks wait here until ``_release_ranks``."""
        if not self.layout.is_main:
            self.layout.barrier()

    def _release_ranks(self):
        """Closes an ``_after_rank0`` block: rank 0 lets the others run it,
        reading what it wrote."""
        if self.layout.is_main:
            self.layout.barrier()

    # ------------------------------------------------------------------ data
    def peek_batches(self, n_batches: int = 1, batch_size: int = 2):
        """The first ``n_batches`` processed step batches drawn across the
        train/dev/test loaders (``trainer.py:219-235``): the one copy of
        the "peek real data" iteration, used by the data check at set-up
        (``_peek_batch``) and the ``-serve_int8`` activation calibration
        (``cli/serve.py``).  Raises when there is no data."""
        out = []
        for loader in (self.data_train, self.data_dev, self.data_test):
            for batch in loader.iter_all(batch_size=batch_size):
                out.append(self.get_processed_batch(batch)[0])
                if len(out) >= n_batches:
                    return out
        if not out:
            raise RuntimeError("dataset is empty")
        return out

    def _peek_batch(self):
        """The first processed step batch of two windows (the JAX trainer
        initialises its model on it)."""
        return self.peek_batches(1, batch_size=2)[0]

    def get_processed_batch(self, batch):
        """Numpy batch → step batch (trainer.py:851-863 + cluster/style
        variants :1221-1239, :1360-1365), all numpy: the steps move it to
        the device.

        Returns ``(step_batch, y_unnormed, insert)``; ``insert`` is THIS
        batch's removed joint slices, handed back to ``calculate_metrics``.
        It travels with the batch rather than through shared
        ``RemoveJoints`` state, because prefetch workers, the k-step chunk
        and the sampling metric worker all run forward passes ahead of the
        matching inverse."""
        labels = None
        if self.args.pos and "text/pos" in batch:
            # POS tag classes as the cluster labels (trainer.py:252-255)
            labels = np.asarray(batch["text/pos"], np.int64)
        elif self.cluster is not None:
            transform_cluster = Compose([RemoveJoints(self.mask)])
            labels = self.cluster(
                transform_cluster(np.asarray(batch[self.output_modality])))
        pre_batch = self.pre({k: v for k, v in batch.items()
                              if isinstance(v, np.ndarray)})
        x = [np.asarray(pre_batch[mod], np.float64)
             for mod in self.input_modalities]
        y_ = np.asarray(pre_batch[self.output_modality])
        rm = RemoveJoints(self.mask, self.parents)  # per-call: no shared state
        y = rm(y_)
        insert = rm.insert

        step_batch = {"x": tuple(np.asarray(x_, self.np_fp) for x_ in x),
                      "y": np.asarray(y, self.np_fp)}
        if "pose/confidence" in batch:
            conf = Compose([RemoveJoints(self.mask)])(
                np.asarray(batch["pose/confidence"]))
            step_batch["confidence"] = np.asarray(conf, self.np_fp)
        if labels is not None:
            step_batch["labels"] = np.asarray(labels, np.int32)
        if self.step_cfg.has_style or self.step_cfg.is_classifier:
            step_batch["style"] = np.asarray(batch["style"], np.int32)
        return step_batch, y_, insert

    # ----------------------------------------------------------------- coins
    def _curriculum_coin(self) -> bool:
        """Pose-input curriculum coin (jlcss4.py:127-129): P(pose input)
        decays 1→0 over curriculum_iters G-steps."""
        if not self.step_cfg.has_style:
            return False
        thresh = min(int(self.state.curriculum_step)
                     / max(self.step_cfg.curriculum_iters, 1), 1.0)
        return bool(self._coin.random() > thresh)

    def _gan_coin(self) -> bool:
        return bool(self._coin.random() < self._d_prob)

    def _step_key(self) -> int:
        """The JAX trainer's per-step key draw (``trainer.py:465``): the
        seed of the step's noise and dropout generators, drawn where JAX
        draws its key, so the coins that follow are the JAX trainer's."""
        return int(self._coin.integers(1 << 31))

    def _maybe_update_d_prob(self, W):
        """``-update_D_prob_flag``: adapt the D/G coin from the sample
        weights (``losses.adaptive_d_prob``)."""
        if self.args.update_D_prob_flag:
            from mixstage_tpu_torch.train.losses import adaptive_d_prob

            self._d_prob = adaptive_d_prob(self._d_prob, W,
                                           self.step_cfg.dg_iter_ratio)

    def _weighted_feedback(self, batch, W):
        """Per-sample weights → the weighted sampler (``trainer.py:
        303-312``) and the optional D-prob adaptation."""
        W = torch.as_tensor(W).double().cpu().numpy()
        if hasattr(self.data_train.sampler, "weights"):
            idx = np.asarray(batch.get("idx", []))
            if idx.size:
                Wc = np.clip(W, 0.1, None)
                self.data_train.sampler.weights[idx[:len(Wc)]] = \
                    Wc[:len(idx)]
        self._maybe_update_d_prob(W)

    def _renormalize_sampler_weights(self):
        """The weighted sampler's weights standardised to mean 1, clipped
        to [0.1, 10], after each epoch (``trainer.py:502-514``)."""
        sampler = self.data_train.sampler
        if not hasattr(sampler, "weights"):
            return
        w = np.asarray(sampler.weights, np.float64)
        w = (w - w.mean()) / (w.std() + 1e-12) + 1
        w = np.clip(w, 0.1, 10.0)
        if np.isnan(w).any():
            w = np.ones_like(w)
        sampler.weights = w

    # ------------------------------------------------- preemption survival
    def request_preempt(self, signum=None, frame=None):
        """Signal-handler entry: flag only (async-signal-safe); the training
        loop checkpoints + raises at its next host-side step boundary."""
        self._preempted = True

    def _install_preempt_handler(self):
        if not self.args.preempt_save:
            return None
        import signal

        try:
            prev = signal.signal(signal.SIGTERM,
                                 lambda s, f: self.request_preempt(s, f))
            return (signal.SIGTERM, prev)
        except ValueError:  # not the main thread (embedded / test harness)
            return None

    def _check_preempt(self, epoch: int, where: str):
        """Poll the preemption flag at a host-side step boundary; on a hit,
        snapshot the LIVE state (weights + optimizer + counters) and unwind.

        Within-epoch progress is IN the snapshot; the resume re-enters the
        current epoch, so the only cost is that epoch's partial metrics."""
        if not self.args.preempt_save or not any_rank(self._preempted,
                                                      self.layout):
            return
        meta = {"epoch_next": int(epoch), "step": int(self.state.step),
                "reason": "SIGTERM", "time": time.asctime(),
                "best_dev_score": float(self.book.best_dev_score),
                "stop_count": int(self.book.stop_count)}
        self.book.log(f"preempted at {where}: checkpointing live state "
                      f"(epoch {epoch}, step {meta['step']})")
        self.book.save_preempt(self.state, meta)
        self.book._save_res()
        raise TrainingPreempted(where)

    def _maybe_resume_preempt(self) -> int:
        """Consume a preemption snapshot for this PREFIX, if any; returns the
        epoch to start from (0 on a fresh run)."""
        if not self.args.preempt_save:
            return 0
        out = self.book.load_preempt(self.state)
        if out is None:
            return 0
        self.state, meta = out
        self.book.best_dev_score = float(
            meta.get("best_dev_score", self.book.best_dev_score))
        self.book.stop_count = int(meta.get("stop_count", 0))
        epoch = int(meta.get("epoch_next", 0))
        self.book.log(f"resuming from preemption checkpoint "
                      f"(epoch {epoch}, step {meta.get('step', '?')})")
        self.book.clear_preempt()  # one-shot: a new signal writes a fresh one
        return epoch

    # ------------------------------------------------------------------ train
    def train(self, exp_num):
        start_epoch = self._maybe_resume_preempt()
        handler = self._install_preempt_handler()
        try:
            self._train_epochs(exp_num, start_epoch)
        finally:
            if handler is not None:
                import signal

                signal.signal(*handler)

    def _train_epochs(self, exp_num, start_epoch=0):
        for epoch in range(start_epoch, self.num_epochs):
            self._check_preempt(epoch, f"epoch {epoch} start")
            train_loss, train_metrics, _ = self.train_loop(
                self.data_train, "train", epoch, num_iters=self.args.num_iters)
            dev_loss, dev_metrics, _ = self.train_loop(
                self.data_dev, "dev", num_iters=self.args.num_iters)
            test_loss, test_metrics, _ = self.train_loop(
                self.data_test, "test", num_iters=self.args.num_iters)

            if self.args.weighted:
                self._renormalize_sampler_weights()

            self.book.update_res({"train": train_loss, "dev": dev_loss,
                                  "test": test_loss})
            self.book.update_res(train_metrics)
            self.book.update_res(dev_metrics)
            self.book.update_res(test_metrics)
            self.book._save_res()
            if self.args.tb:
                # per-epoch loss/pck/spatialNorm scalars per split
                # (reference trainer.py:533-551)
                cpk = self.args.cpk
                scalars = [[f"{cpk}/train", train_loss, epoch],
                           [f"{cpk}/dev", dev_loss, epoch],
                           [f"{cpk}/test", test_loss, epoch]]
                for split, metrics in (("train", train_metrics),
                                       ("dev", dev_metrics),
                                       ("test", test_metrics)):
                    # tag order mirrors upstream exactly: pck_<split> but
                    # <split>_spatialNorm (trainer.py:537-551)
                    for tag, key in ((f"pck_{split}", f"{split}_pck"),
                                     (f"{split}_spatialNorm",
                                      f"{split}_spatialNorm")):
                        if key in metrics:
                            scalars.append([f"{cpk}/{tag}",
                                            metrics[key], epoch])
                self.book.update_tb({"scalar": scalars})
            self.book.print_res(
                epoch, key_order=["train", "dev", "test"],
                metric_order=self.metric_order, exp=exp_num,
                lr=float(self._schedule(int(self.state.step))))
            if self.book.stop_training(self.state, epoch):
                break

        if self.args.num_iters > 0:
            self.state = self.book._load_model(self.state)
            test_loss, test_metrics, _ = self.train_loop(self.data_test,
                                                         "test", 0)
            self.book.update_res({"test": test_loss})
            self.book.update_res(test_metrics)
            self.book._save_res()
        self.book.clear_preempt()  # clean completion: no stale snapshot

    def _count_weights(self, batch):
        if "idx" in batch:
            for i in np.asarray(batch["idx"]).tolist():
                self.weight_counter[i] = self.weight_counter.get(i, 0) + 1

    def _accumulate(self, running, losses, B):
        for k, v in losses.items():
            if v.dim() == 0:
                running[k] = running.get(k, 0.0) + float(v) * B

    def _metrics_of_step(self, step_batch, y_cap, y_, insert):
        if self.step_cfg.is_classifier:      # y_cap are logits
            return
        kwargs = {}
        if "style" in step_batch:
            kwargs["style"] = np.asarray(step_batch["style"])
        self.calculate_metrics(to_numpy(y_cap), y_, "same", insert=insert,
                               **kwargs)

    def _train_step(self, batch, step_batch):
        """One train step (``trainer.py:465-479``): a GAN's D or G step by
        the coin, else the model's own step, seeded by the JAX trainer's
        key draw; the weighted GAN's feedback.  ``(losses, pose)``."""
        rng = self._step_key()
        if self.step_cfg.gan:
            fn = self.steps["d"] if self._gan_coin() else self.steps["g"]
            self.state, losses, y_cap = fn(
                self.state, step_batch, rng,
                use_pose_input=self._curriculum_coin())
        else:
            self.state, losses, y_cap = self.steps["train"](
                self.state, step_batch, rng)
        if self.args.weighted and "W" in losses:
            self._weighted_feedback(batch, losses["W"])
        return losses, y_cap

    def train_loop(self, data, desc, epoch=0, num_iters=0, train=True):
        """One pass over ``data``: train steps when ``desc`` is "train"
        (and ``train``), else eval steps.  Returns (mean pose loss,
        metrics, per-style metrics)."""
        from mixstage_tpu_torch.data.prefetch import prefetch
        from mixstage_tpu_torch.train.profiling import StepTimer, trace

        training = desc == "train" and train
        self.metrics_reset()
        running = {"total": 0.0}
        running_count = 1e-10
        t0 = time.time()
        timer = StepTimer(desc)
        # host batch prep runs ahead of the steps on the card
        prepared = prefetch(data,
                            lambda b: (b, self.get_processed_batch(b)),
                            depth=2 if not self._scan_k else self._scan_k + 2,
                            workers=max(1, int(self.args.num_workers)))
        with trace(self.args.profile_dir if training and epoch == 0 and
                   self.layout.is_main else None):
            if training and self._scan_step is not None:
                return self._train_loop_scan(prepared, desc, epoch, timer,
                                             running, running_count, t0)
            count = -1
            for count, (batch, (step_batch, y_, insert)) in enumerate(prepared):
                if training:
                    self._check_preempt(epoch, f"train step {count}")
                timer.start()
                self._count_weights(batch)
                B = step_batch["y"].shape[0]
                if training:
                    losses, y_cap = self._train_step(batch, step_batch)
                else:
                    self._step_key()
                    losses, y_cap, _ = self.steps["eval"](self.state,
                                                          step_batch)
                self._accumulate(running, losses, B)
                running_count += B
                self._nan_guard(float(losses["total"]), f"{desc} step {count}")
                self._metrics_of_step(step_batch, y_cap, y_, insert)
                timer.stop()
                if self.args.debug and count >= self.args.debug:
                    break
                if not training and num_iters > 0 and count >= num_iters:
                    break

        loss_avg = running.get("pose", running["total"]) / running_count
        metrics, metrics_split = self._split_metrics(desc, running,
                                                     running_count)
        if training:
            dt = time.time() - t0
            metrics[f"{desc}_steps_per_sec"] = (count + 1) / max(dt, 1e-9)
            metrics.update(timer.summary(prefix=""))
        return loss_avg, metrics, metrics_split

    def _split_metrics(self, desc, running, running_count):
        """(metrics, per-style metrics) of a loop: the classifier's
        accuracy, or the pose metrics under ``-metrics``
        (``trainer.py:505-513``)."""
        if self.step_cfg.is_classifier:
            return {f"{desc}_acc": running.get("acc", 0.0) / running_count}, {}
        if self.args.metrics:
            return self.get_metrics(desc)
        return {}, {}

    # ---------------------------------------------------------------- metrics
    def _stack_factory(self):
        args = self.args
        speakers = list(self.style_dict.keys())
        if args.mix and args.load:
            return partial(evaluation.Stack, n=len(speakers),
                           speakers=speakers, sample_styles=["mix"])
        if args.sample_all_styles != 0 and args.load:
            styles = ["same"] + ["_".join(p) for p in
                                 itertools.permutations(self.speaker, 2)]
            return partial(evaluation.Stack, n=len(speakers),
                           speakers=speakers, sample_styles=styles)
        if args.load:
            return partial(evaluation.Stack, n=len(speakers),
                           speakers=speakers, sample_styles=["same", "style"])
        return partial(evaluation.Stack, n=0, speakers=[],
                       sample_styles=["same"])

    def _init_metrics(self):
        Stack = self._stack_factory()
        feats_count = self.data_shape[self.output_modality][-1] // 2
        mean = self.pre.transforms[-1].variable_dict[self.output_modality][0]
        mean_masked = RemoveJoints(self.mask)(
            np.asarray(mean).reshape(1, 1, -1))[0, 0]
        self.pck = Stack(evaluation.PCK(num_joints=feats_count))
        self.l1 = Stack(evaluation.L1())
        self.vel_l1 = Stack(evaluation.VelL1())
        self.diversity = Stack(evaluation.Diversity(mean_masked))
        self.expressiveness = Stack(evaluation.Expressiveness(mean_masked))
        self.f1_cluster = KMeansTransform(
            [self.output_modality],
            savepath=(Path(self.path2data) / "preprocessing" / "kmeans").as_posix(),
            key=self.speaker, data=self.data_train, num_clusters=8,
            mask=self.mask, feats=self.feats, verbose=False,
            seed=self.args.seed)
        self.f1 = Stack(evaluation.F1(num_clusters=8))
        self.fid = Stack(evaluation.FID())
        self.w1 = Stack(evaluation.W1())
        self.metrics_objects = [self.pck, self.l1, self.vel_l1, self.diversity,
                                self.expressiveness, self.f1, self.fid, self.w1]
        self.IS = None
        if not self.args.pretrained_model:
            clf_fn = self._load_is_classifier()
            if clf_fn is not None:
                speakers_rev = {sp: i for i, sp in
                                enumerate(self.data.speakers)}
                weight = np.array([[speakers_rev[sp.split("|")[0]]]
                                   for sp in self.speaker])
                self.IS = Stack(evaluation.InceptionScoreStyle(
                    len(self.data.speakers), weight, clf_fn))
                self.metrics_objects.append(self.IS)

    def _load_is_classifier(self):
        """The frozen ``StyleClassifier_G`` forward of the IS metric
        (``trainer.py:584-614``): from ``-pretrained_model_weights``, what
        ``cli.train -model StyleClassifier_G`` writes, the port's torch
        checkpoint or the JAX package's flax msgpack or orbax one (its
        ``g_params/gen`` and ``g_state/gen`` through the weight bridge),
        over every speaker of the data.  None when no file is named or it
        does not exist; any other file raises."""
        path = self.args.pretrained_model_weights
        if not path or not Path(path).exists():
            return None
        from mixstage_tpu_torch.bookkeeping import (is_port_checkpoint,
                                                    read_checkpoint)
        from mixstage_tpu_torch.interop.weights import load_flax_state
        from mixstage_tpu_torch.models.style_classifier import \
            StyleClassifier_G

        clf = StyleClassifier_G(in_channels=self.step_cfg.out_feats,
                                num_speakers=len(self.data.speakers),
                                dtype=self.fp)
        if self.fp == torch.float64:
            clf.double()
        kind, ckpt = read_checkpoint(path)
        if kind == "orbax":
            kind, ckpt = "flax", ckpt["model"]
        if kind == "flax":
            load_flax_state(clf, ckpt["g_params"]["gen"],
                            (ckpt.get("g_state") or {}).get("gen", {}))
        elif is_port_checkpoint(ckpt):
            clf.load_state_dict(ckpt["gen"])
        else:
            raise ValueError(f"{path} is not a checkpoint of the IS "
                             f"metric's StyleClassifier_G")
        clf = clf.to(self.device).eval()
        out = torch.float64 if self.fp == torch.float64 else torch.float32

        @torch.no_grad()
        def clf_fn(y):
            y = torch.as_tensor(np.asarray(y), device=self.device)
            return clf(y.to(self.fp))[0].to(out).cpu().numpy()

        return clf_fn

    def metrics_reset(self):
        for obj in self.metrics_objects:
            obj.reset()

    @property
    def metric_order(self):
        return ["pck", "F1", "style_IS"] if self.args.metrics else []

    def get_metrics(self, desc):
        metrics, metrics_split = {}, {}
        for metric in self.metrics_objects:
            avgs = metric.get_averages(desc)
            if isinstance(avgs, tuple):
                metrics.update(avgs[0])
                if not metrics_split:
                    metrics_split = {kn: {sp: {} for sp in avgs[1][kn]}
                                     for kn in avgs[1]}
                for kn in avgs[1]:
                    for sp in avgs[1][kn]:
                        metrics_split[kn][sp].update(avgs[1][kn][sp])
            else:
                metrics.update(avgs)
        return metrics, metrics_split

    def calculate_metrics(self, y_cap, y_, kwargs_name, insert=None,
                          **kwargs):
        """Metric cascade in znormed + raw spaces (trainer.py:865-915).

        ``insert``: the SAME batch's removed joint slices from
        ``get_processed_batch``."""
        if kwargs_name is None:
            kwargs_name = "same"
        if kwargs.get("style") is not None:
            idx = int(np.asarray(kwargs["style"]).reshape(-1)[0])
            style_vector = np.asarray(kwargs["style"])
        else:
            idx = 0
            style_vector = np.zeros((y_cap.shape[0], y_cap.shape[1]),
                                    np.int64)
        if self.IS is not None:
            try:
                self.IS(y_cap, style_vector, self.mask, idx=idx,
                        kwargs_name=kwargs_name)
            except (ValueError, IndexError):
                # the metric takes 64-frame windows with a style row each;
                # a sampled interval (its windows flattened to one row, or
                # of another length) fails before any meter updates, and
                # the JAX trainer skips those calls too (trainer.py:
                # 663-668)
                pass

        y_cap_full = self.transform(y_cap, inv=True, batch_gt=y_,
                                    insert=insert)
        self.l1(y_cap_full, y_, self.mask, idx=idx, kwargs_name=kwargs_name)
        self.vel_l1(y_cap_full, y_, self.mask, idx=idx, kwargs_name=kwargs_name)
        self.fid(y_cap_full, y_, self.mask, idx=idx, kwargs_name=kwargs_name)

        y_cap_raw = self.pre({self.output_modality: y_cap_full},
                             inv=True)[self.output_modality]
        y_raw = self.pre({self.output_modality: np.asarray(y_)},
                         inv=True)[self.output_modality]
        B, T = y_cap_raw.shape[0], y_cap_raw.shape[1]
        y_cap_j = y_cap_raw.reshape(B, T, 2, -1)
        y_j = y_raw.reshape(B, T, 2, -1)
        self.w1(y_cap_j, y_j, self.mask, idx=idx, kwargs_name=kwargs_name)

        y_cap_f = y_cap_j.reshape(-1, 2, y_cap_j.shape[-1]).copy()
        y_f = y_j.reshape(-1, 2, y_j.shape[-1]).copy()
        y_cap_f[..., 0] = 0
        y_f[..., 0] = 0
        self.pck(y_cap_f, y_f, self.mask, idx=idx, kwargs_name=kwargs_name)

        rm = RemoveJoints(self.mask)
        y_cap_m = rm(y_cap_f.reshape(1, y_cap_f.shape[0], -1),
                     save_insert=False)[0]
        y_m = rm(y_f.reshape(1, y_f.shape[0], -1), save_insert=False)[0]
        self.diversity(y_cap_m, y_m, idx=idx, kwargs_name=kwargs_name)
        self.expressiveness(y_cap_m, y_m, idx=idx, kwargs_name=kwargs_name)
        self.f1(self.f1_cluster(y_cap_m[None]), self.f1_cluster(y_m[None]),
                idx=idx, kwargs_name=kwargs_name)
        # the raw root-zeroed (B*T, 2, joints) pose, the array dumped to the
        # keypoints h5 tree (trainer.py:899-915)
        return y_cap_f

    # ---------------------------------------------------------- label history
    def _init_label_hist(self):
        if self.num_clusters is None:
            return
        if self.sample_all_styles:
            kwargs_names = [f"{s1}_{s2}" for s2 in self.speaker
                            for s1 in self.speaker if s1 != s2]
        else:
            kwargs_names = ["style", "same"]
        descs = ["test", "train", "dev"]
        self.labels_hist = {kn: {d: {i: np.zeros(self.num_clusters)
                                     for i in range(self.num_styles)}
                                 for d in descs} for kn in kwargs_names}
        # chunk lists, concatenated once at save time
        self.labels_hist_tensor = {
            kn: {d: {i: [np.zeros((1, self.num_clusters))]
                     for i in range(self.num_styles)}
                 for d in descs} for kn in kwargs_names}

    def _update_labels(self, labels_cap_soft, desc, style, kwargs_name):
        if self.num_clusters is None or labels_cap_soft is None:
            return
        if kwargs_name is None:
            kwargs_name = "same"
        if kwargs_name not in self.labels_hist:
            return
        soft = np.asarray(labels_cap_soft).reshape(-1, self.num_clusters)
        if desc == "test":
            self.labels_hist_tensor[kwargs_name][desc][style].append(soft)
        self.labels_hist[kwargs_name][desc][style] += np.bincount(
            soft.argmax(-1), minlength=self.num_clusters).astype(np.float64)

    def _save_labels(self):
        if self.num_clusters is None:
            return
        speakers = self.speaker
        hist = {kn: {d: {speakers[i]: self.labels_hist[kn][d][i].tolist()
                         for i in self.labels_hist[kn][d]}
                     for d in ["test", "train", "dev"]}
                for kn in self.labels_hist}
        with open(self.book.name("histogram", "json",
                                 self.book.save_dir), "w") as f:
            json.dump(hist, f)
        tensors = {kn: {d: {speakers[i]:
                            np.concatenate(self.labels_hist_tensor[kn][d][i], 0)
                            for i in self.labels_hist_tensor[kn][d]}
                        for d in ["test", "train", "dev"]}
                   for kn in self.labels_hist_tensor}
        with open(self.book.name("style", "pkl", self.book.save_dir),
                  "wb") as f:
            pkl.dump(tensors, f)

    # ------------------------------------------------------------- experiment
    def start_exp(self):
        self.book._start_log()

    def finish_exp(self):
        self.book._stop_log()

    def get_gt(self, path2h5):
        """An interval's output stream as (frames, 2, joints) with the root
        joint's coordinates set to 0 (``trainer.py:756-763``)."""
        from mixstage_tpu_torch.data.hdf5 import HDF5

        Y = HDF5.load_array(path2h5, self.output_modality)
        feats_shape = self.data_shape[self.output_modality][-1] // 2
        Y = Y.reshape(-1, 2, feats_shape).copy()
        Y[..., 0] = 0
        return Y

    # -------------------------------------------------------------- sampling
    def update_kwargs_styles(self, style):
        """Yield (style_array, kwargs_name) per style-transfer target
        (trainer.py:1367-1386)."""
        if not self.step_cfg.has_style:
            yield style, None
            return
        style_id = int(np.asarray(style).reshape(-1)[0])
        if self.args.mix:
            # uniform mixture over all learned styles (reference -mix flag)
            yield style, None
            yield ("__mix__", "mix")
            return
        if self.sample_all_styles:
            yield style, None
            for shift in range(1, self.num_styles):
                target = (style + shift) % self.num_styles
                name = "{}_{}".format(self.speaker[style_id],
                                      self.speaker[(style_id + shift)
                                                   % self.num_styles])
                yield target, name
        else:
            yield style, None
            yield (style + 1) % self.num_styles, "style"

    def sample(self, exp_num):
        from mixstage_tpu_torch.train.sampling import sample_loop

        self.dir_name = self.book.name.dir(self.args.save_dir)
        self.state = self.book._load_model(self.state)
        if self.step_cfg.is_classifier:
            return self._sample_classifier(exp_num)
        test_loss, test_metrics, test_split = sample_loop(self, "test")
        train_loss, train_metrics, _ = sample_loop(self, "train")
        dev_loss, dev_metrics, _ = sample_loop(self, "dev")
        if self.sample_all_styles == 0 and self.layout.is_main:
            self._save_labels()
            with open(self.book.name("metrics", "json",
                                     self.book.save_dir), "w") as f:
                json.dump(test_split, f)
            with open(self.book.name("cummMetrics", "json",
                                     self.book.save_dir), "w") as f:
                json.dump(test_metrics, f)
        print("Sampled- Train:{:.4f}/{:.4f}, Dev:{:.4f}/{:.4f}, "
              "Test:{:.4f}/{:.4f}".format(
                  train_loss, train_metrics.get("train_pck", 0.0),
                  dev_loss, dev_metrics.get("dev_pck", 0.0),
                  test_loss, test_metrics.get("test_pck", 0.0)))
        self.book.update_res({"train": train_loss, "dev": dev_loss,
                              "test": test_loss})
        self.book.update_res(train_metrics)
        self.book.update_res(dev_metrics)
        self.book.update_res(test_metrics)
        self.book.print_res(epoch=0, key_order=["train", "dev", "test"],
                            metric_order=self.metric_order, exp=exp_num, lr=0)
        if self.args.render and self.layout.is_main:
            self.render_samples()

    def render_samples(self, max_videos: int = 10):
        """Render the dumped keypoints to videos and the HTML grid
        (``-render``, ``trainer.py:819-845``): at most ``max_videos``
        intervals, each tree's files in sorted order, without audio;
        returns the files written."""
        from mixstage_tpu_torch.animation.animation import animate
        from mixstage_tpu_torch.data.hdf5 import HDF5
        from mixstage_tpu_torch.htmlgrid.to_html import make_html_file

        exp_dir = Path(self.dir_name)
        feats_shape = self.data_shape[self.output_modality][-1] // 2
        written = []
        for kp_dir in sorted(exp_dir.glob("keypoints*")):
            subname = kp_dir.name.replace("keypoints", "").lstrip("_") or None
            for h5file in sorted(kp_dir.rglob("*.h5")):
                if len(written) >= max_videos:
                    break
                y_pred = HDF5.load_array(h5file.as_posix(),
                                         self.output_modality)
                if y_pred.ndim == 2:
                    y_pred = y_pred.reshape(-1, 2, feats_shape)
                desc = h5file.parent.parent.name
                written.append(animate(y_pred, h5file.stem, self.parents,
                                       exp_dir.as_posix(), desc, self.data,
                                       None, None, None, subname))
        make_html_file(exp_dir.as_posix())
        return written

    def _sample_classifier(self, exp_num):
        """The classifier has no pose to sample: its loss and accuracy on
        each split's windows, in eval mode, into ``PREFIX_res.json``.  (The
        JAX package's sampling pass calls the classifier's eval step with
        the pose models' arguments and stops there.)"""
        res = {}
        for desc in ("test", "train", "dev"):
            loss, metrics, _ = self.train_loop(getattr(self, f"data_{desc}"),
                                               desc, train=False)
            res[desc] = loss
            self.book.update_res(metrics)
        print("Sampled- Train:{train:.4f}, Dev:{dev:.4f}, "
              "Test:{test:.4f}".format(**res))
        self.book.update_res(res)
        self.book.print_res(epoch=0, key_order=["train", "dev", "test"],
                            metric_order=[], exp=exp_num, lr=0)

    def _train_loop_scan(self, prepared, desc, epoch, timer, running,
                         running_count, t0):
        """k-step training loop: one call of the k-step driver per k
        batches (``StepFactory.make_scan_train_step``).  Used after the
        curriculum phase; curriculum batches take the per-step path."""
        k = self._scan_k
        pend = []
        count = 0

        def flush():
            nonlocal running_count, count
            if not pend:
                return
            if len(pend) < k or any(
                    p[1]["y"].shape != pend[0][1]["y"].shape for p in pend):
                # ragged tail or shape change: per-step path
                for batch, sb, y_, ins in pend:
                    self._one_train_step(batch, sb, y_, ins, running)
                    running_count += sb["y"].shape[0]
                    count += 1
                pend.clear()
                return
            batches = [p[1] for p in pend]
            stacked = {key: (tuple(np.stack([b["x"][j] for b in batches])
                                   for j in range(len(batches[0]["x"])))
                             if key == "x" else
                             np.stack([b[key] for b in batches]))
                       for key in batches[0]}
            coins = np.array([self._gan_coin() if self.step_cfg.gan
                              else False for _ in range(k)])
            rngs = [self._step_key() for _ in range(k)]
            timer.start()
            self.state, losses, poses = self._scan_step(self.state, stacked,
                                                        coins, rngs)
            timer.stop()
            B = batches[0]["y"].shape[0]
            losses = {key: v.float().cpu().numpy()
                      for key, v in losses.items()}
            self._nan_guard(losses["total"], f"train scan chunk (k={k})")
            for i, (batch, sb, y_, ins) in enumerate(pend):
                for key in losses:
                    if losses[key][i].ndim == 0:
                        running[key] = running.get(key, 0.0) + \
                            float(losses[key][i]) * B
                running_count += B
                if self.args.weighted and "W" in losses:
                    self._weighted_feedback(batch, losses["W"][i])
                self._metrics_of_step(sb, poses[i], y_, ins)
                count += 1
            pend.clear()

        in_curriculum = (self.step_cfg.has_style and
                         int(self.state.curriculum_step)
                         < self.step_cfg.curriculum_iters)
        for batch, (step_batch, y_, insert) in prepared:
            self._check_preempt(epoch, f"train scan batch {count}")
            self._count_weights(batch)
            if in_curriculum:
                self._one_train_step(batch, step_batch, y_, insert, running)
                running_count += step_batch["y"].shape[0]
                count += 1
                in_curriculum = (int(self.state.curriculum_step)
                                 < self.step_cfg.curriculum_iters)
            else:
                pend.append((batch, step_batch, y_, insert))
                if len(pend) == k:
                    flush()
            if self.args.debug and count >= self.args.debug:
                break
        flush()
        loss_avg = running.get("pose", running.get("total", 0.0)) / running_count
        metrics, metrics_split = self._split_metrics(desc, running,
                                                     running_count)
        dt = time.time() - t0
        metrics[f"{desc}_steps_per_sec"] = count / max(dt, 1e-9)
        metrics.update(timer.summary(prefix=""))
        return loss_avg, metrics, metrics_split

    def _nan_guard(self, total, where: str):
        """NaN-loss tripwire (reference trainer.py:642-643 drops into pdb):
        interactive pdb only under a tty and ``-debug``; otherwise a
        ``FloatingPointError`` that names the step."""
        if not np.isnan(total).any():
            return
        msg = (f"NaN train loss at {where} (step counter "
               f"{int(self.state.step)}).  Re-run under "
               "torch.autograd.set_detect_anomaly(True) to trap the "
               "originating op.")
        self.book.log(msg)
        if self.args.debug and sys.stdin.isatty():
            import pdb
            pdb.set_trace()
        else:
            raise FloatingPointError(msg)

    def _one_train_step(self, batch, step_batch, y_, insert, running):
        """Single per-step call (the k-step loop's fallbacks)."""
        B = step_batch["y"].shape[0]
        losses, y_cap = self._train_step(batch, step_batch)
        self._accumulate(running, losses, B)
        self._nan_guard(float(losses["total"]), "train step (scan fallback)")
        self._metrics_of_step(step_batch, y_cap, y_, insert)
