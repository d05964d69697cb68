"""Plain PyTorch GAN train steps: the G step, the D step, the global-norm
clip and Adam, at float32.

The published GAN trainer (github.com/chahuja/mix-stage,
``src/trainer_chiahuja.py``'s ``TrainerGAN`` and
``TrainerLateClusterStyleGAN``) as the port reproduces it:

* G step (G, the pose-style encoder and D in training mode): the pose-style
  encoder scores the real pose (``id_in``); with ``argmax`` its one-hot
  argmax is the style; the generator's pose and cluster scores give the L1
  pose loss, the cluster cross-entropy (``label``) and, through the encoder
  with its weights frozen (``some_grad_flag``), ``id_out``; D scores the
  fake velocity, and λ·mean |D − 1| is ``G_gan``.  ``id_in`` and ``id_out``
  are weighed by ``lambda_id``.  λ ramps from 1 to 2 over 300 steps.
* D step (G in eval mode, without gradients; with ``train_only`` the
  style is the true speaker's one-hot): D on the fake and then on the real
  velocity, λ·mean |D(fake)| + mean |D(real) − 1| plus G's cluster loss
  (a constant).
* Each optimizer clips its gradients to the global norm
  ``clip_grad_norm`` (dividing by max(norm / clip, 1)) and takes an Adam
  step (b1 0.9, b2 0.999, eps 1e-8, bias corrections in float32),
  learning rate ``lr``.

``ReferenceTrainer.run(batches, coins)`` follows a sequence of steps and
records each step's total loss; ``resume`` first sets it to a train state
taken from elsewhere (parameters, statistics, moments and counts).
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F

from bench_port.reference.models import build


def l1(a, b):
    return (a - b).abs().mean()


def cross_entropy(logits, labels):
    return -F.log_softmax(logits, -1).gather(
        -1, labels.long()[..., None])[..., 0].mean()


def velocity(x):
    v = x[:, 1:] - x[:, :-1]
    return torch.cat([torch.zeros_like(x[:, :1]), v], dim=1)


def gan_lambda(step: int) -> float:
    frac = (torch.tensor(step, dtype=torch.float32) / 300).clamp(0.0, 1.0)
    return float(1.0 + 1.0 * frac)


class Adam:
    def __init__(self, params: List[torch.Tensor], lr: float, clip: float):
        self.params, self.lr, self.clip, self.count = params, lr, clip, 0
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]
        self.first = None

    @torch.no_grad()
    def step(self, grads):
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads)).float()
        grads = [g / (norm / self.clip).clamp_min(1.0) for g in grads]
        if self.first is None:
            self.first = [g.detach().cpu().clone() for g in grads]
        self.count += 1
        c = torch.tensor(float(self.count))
        bc1 = float(1.0 - torch.tensor(0.9) ** c)
        bc2 = float(1.0 - torch.tensor(0.999) ** c)
        for p, g, m, v in zip(self.params, grads, self.mu, self.nu):
            m.mul_(0.9).add_(g * 0.1)
            v.mul_(0.999).add_(g * g * 0.001)
            p.add_(-self.lr * ((m / bc1) / ((v / bc2).sqrt() + 1e-8)))


class ReferenceTrainer:
    """The G and D steps of ``cfg`` (a configuration file) on the tensors
    ``weights`` (name → tensor, the program's state-dict names under
    ``gen.``, ``psenc.`` and ``disc.``)."""

    @staticmethod
    def follows(cfg: dict) -> None:
        """Raise unless the reference trains as ``cfg`` states."""
        for key, value in (("loss", "L1Loss"), ("optim", "Adam"),
                           ("discriminator", "Speech2Gesture_D")):
            if cfg.get(key) != value:
                raise NotImplementedError(
                    f"the reference trains with {key} {value!r}, the "
                    f"configuration states {cfg.get(key)!r}")
        if "Style" in cfg["model"] and cfg.get("train_only") != 1:
            raise NotImplementedError("the reference's D step takes the true "
                                      "speaker's style: train_only 1")

    def __init__(self, cfg: dict, weights: Dict[str, torch.Tensor], device):
        self.follows(cfg)
        self.cfg = cfg
        gen, psenc, disc = build(cfg)
        self.mods = {"gen": gen, "psenc": psenc, "disc": disc}
        for name, mod in self.mods.items():
            if mod is None:
                continue
            mod.to(device)
            mod.load_state_dict({k[len(name) + 1:]: v
                                 for k, v in weights.items()
                                 if k.startswith(name + ".")})
        self.gen, self.psenc, self.disc = gen, psenc, disc
        self.g_params = list(gen.parameters()) + (
            list(psenc.parameters()) if psenc is not None else [])
        self.g_names = [f"gen.{k}" for k, _ in gen.named_parameters()] + (
            [f"psenc.{k}" for k, _ in psenc.named_parameters()]
            if psenc is not None else [])
        self.d_names = [f"disc.{k}" for k, _ in disc.named_parameters()]
        clip = cfg["clip_grad_norm"]
        self.g_opt = Adam(self.g_params, cfg["lr"], clip)
        self.d_opt = Adam(list(disc.parameters()), cfg["lr"], clip)
        self.lambda_step = 0

    @torch.no_grad()
    def resume(self, tensors: Dict[str, torch.Tensor],
               counters: Dict[str, int]) -> None:
        """Set every parameter and buffer (by program name), each
        optimizer's moments (``<g_opt|d_opt>.<mu|nu>.<leaf>``) and count,
        and the λ ramp's step, to a train state's."""
        for k, v in self.leaves().items():
            v.copy_(tensors[k])
        for tag, opt, names in (("g_opt", self.g_opt, self.g_names),
                                ("d_opt", self.d_opt, self.d_names)):
            for slot in ("mu", "nu"):
                for t, n in zip(getattr(opt, slot), names):
                    t.copy_(tensors[f"{tag}.{slot}.{n}"])
            opt.count = int(counters[tag[0] + "_count"])
        self.lambda_step = int(counters["lambda_step"])

    def leaves(self) -> Dict[str, torch.Tensor]:
        """Every parameter and buffer by its program name."""
        out = {}
        for name, mod in self.mods.items():
            if mod is not None:
                out.update({f"{name}.{k}": v
                            for k, v in mod.state_dict().items()})
        return out

    def first_grads(self) -> Dict[str, torch.Tensor]:
        """Each optimizer's first (clipped) gradient by program name, for
        the optimizers that have stepped."""
        out = {}
        for names_o, opt in ((self.g_names, self.g_opt),
                             (self.d_names, self.d_opt)):
            if opt.first is not None:
                out.update(zip(names_o, opt.first))
        return out

    def _generate(self, audio, style_w):
        if self.psenc is None:
            return self.gen(audio), {}
        pose, score = self.gen(audio, style_w)
        return pose, {"score": score}

    def g_step(self, b) -> float:
        cfg = self.cfg
        for m in self.mods.values():
            if m is not None:
                m.train()
        y, audio = b["y"], b["audio"]
        lam = gan_lambda(self.lambda_step)
        total = 0.0
        with torch.enable_grad():
            if self.psenc is not None:
                sid = b["style"][:, 0]
                score = self.psenc(y)
                id_in = cross_entropy(score, sid)
                T = y.shape[1]
                w = torch.softmax(score, -1)
                if cfg["argmax"]:
                    w = F.one_hot(w.argmax(-1), cfg["num_speakers"]).float()
                pose, out = self._generate(audio, w[:, None].expand(
                    -1, T, -1))
                label = cross_entropy(
                    out["score"].reshape(-1, cfg["num_clusters"]),
                    b["labels"].reshape(-1))
                if cfg["some_grad_flag"]:
                    frozen = {k: v.detach()
                              for k, v in self.psenc.named_parameters()}
                    score_out = torch.func.functional_call(self.psenc,
                                                           frozen, (pose,))
                else:
                    score_out = self.psenc(pose)
                id_out = cross_entropy(score_out, sid)
                total = label + cfg["lambda_id"] * id_in + \
                    cfg["lambda_id"] * id_out
            else:
                pose, _ = self._generate(audio, None)
            d = self.disc(velocity(pose))
            g_gan = lam * (d - 1.0).abs().mean()
            total = l1(pose, y) + g_gan + total
            grads = torch.autograd.grad(total, self.g_params,
                                        allow_unused=True)
        self.g_opt.step([torch.zeros_like(p) if g is None else g
                         for g, p in zip(grads, self.g_params)])
        self.lambda_step += 1
        return float(total.detach())

    def d_step(self, b) -> float:
        cfg = self.cfg
        self.gen.eval()
        if self.psenc is not None:
            self.psenc.eval()
        self.disc.train()
        y, audio = b["y"], b["audio"]
        lam = gan_lambda(self.lambda_step)
        with torch.no_grad():
            const = 0.0
            if self.psenc is not None:
                w = F.one_hot(b["style"].long(), cfg["num_speakers"]).float()
                pose, out = self._generate(audio, w)
                const = cross_entropy(
                    out["score"].reshape(-1, cfg["num_clusters"]),
                    b["labels"].reshape(-1))
            else:
                pose, _ = self._generate(audio, None)
        with torch.enable_grad():
            fake = self.disc(velocity(pose))
            real = self.disc(velocity(y))
            total = real.sub(1.0).abs().mean() + lam * fake.abs().mean() + \
                const
            grads = torch.autograd.grad(total, list(self.disc.parameters()))
        self.d_opt.step(list(grads))
        self.lambda_step += 1
        return float(total.detach())

    def run(self, batches: List[dict], coins) -> List[float]:
        """Follow the steps: ``coins[i]`` True is a D step on
        ``batches[i]``, False a G step; each step's total loss."""
        return [self.d_step(b) if c else self.g_step(b)
                for b, c in zip(batches, coins)]
