"""The paper's metric suite, updated incrementally per batch (the port's
copy of ``mixstage_tpu/evaluation/metrics.py``).

``AverageMeter``, ``Stack``, ``L1``, ``VelL1``, ``F1``, ``Diversity``,
``Expressiveness`` (whose ``spatialNorm`` ratio is the dev-selection
metric), ``PCK``, ``InceptionScoreStyle``, streaming ``FID`` and ``W1`` on
speed / acceleration histograms, all in numpy on the host.  ``F1`` counts
its confusion matrix with ``np.bincount`` where the JAX package calls
scikit-learn; FID's ``scipy.linalg`` and W1's ``scipy.stats`` stay.
"""

from __future__ import annotations

import copy
from typing import Callable

import numpy as np


class AverageMeter:
    """Streaming average (+ optional second stream) — metrics.py:37-65."""

    def __init__(self, name: str, fmt: str = ":f"):
        self.name = name
        self.fmt = fmt
        self.reset()

    def reset(self):
        self.val = 0
        self.avg = 0.0
        self.sum = 0
        self.count = 0
        self.val2 = 0
        self.sum_energy = 0
        self.avg_energy = 0

    def update(self, val, n=1, val2=None):
        self.count += n
        self.val = val
        self.sum = self.sum + val * n
        self.avg = self.sum / self.count
        self.val2 = val2
        if val2 is not None:
            self.sum_energy += val2 * n
            self.avg_energy = self.sum_energy / self.count


class Stack:
    """Wrap a metric into an overall copy + per-(style-pair × speaker) copies
    (metrics.py:67-92)."""

    def __init__(self, metric, n: int = 0, speakers=(), sample_styles=("same",)):
        self.metric = metric
        self.metrics = {} if n == 0 else \
            {s: [copy.deepcopy(metric) for _ in range(n)] for s in sample_styles}
        self.speakers = list(speakers)
        assert len(self.speakers) == n

    def __call__(self, y, gt, mask_idx=(0, 7, 8, 9), idx=0, kwargs_name="same"):
        self.metric(y, gt, mask_idx)
        if self.metrics and kwargs_name in self.metrics:
            self.metrics[kwargs_name][idx](y, gt, mask_idx)

    def reset(self):
        self.metric.reset()
        for key in self.metrics:
            for m in self.metrics[key]:
                m.reset()

    def get_averages(self, desc):
        if self.metrics:
            return (self.metric.get_averages(desc),
                    {key: {self.speakers[i]: m.get_averages(desc)
                           for i, m in enumerate(self.metrics[key])}
                     for key in self.metrics})
        return self.metric.get_averages(desc)


def _unmasked(feat_count, mask_idx):
    return sorted(set(range(feat_count)) - set(mask_idx))


class L1:
    def __init__(self):
        self.average_meter = AverageMeter("L1")

    def __call__(self, y, gt, mask_idx=(0, 7, 8, 9)):
        y = np.asarray(y)
        gt = np.asarray(gt)
        mask = _unmasked(y.shape[-1] // 2, mask_idx)
        y = y.reshape(y.shape[0], y.shape[1], 2, -1)
        gt = gt.reshape(gt.shape[0], gt.shape[1], 2, -1)
        self.average_meter.update(np.abs(y[..., mask] - gt[..., mask]).mean(),
                                  n=y.shape[0])

    def reset(self):
        self.average_meter.reset()

    def get_averages(self, desc):
        return {f"{desc}_L1": float(self.average_meter.avg)}


class VelL1:
    def __init__(self):
        self.average_meter = AverageMeter("VelL1")

    def __call__(self, y, gt, mask_idx=(0, 7, 8, 9)):
        y = np.asarray(y)
        gt = np.asarray(gt)
        mask = _unmasked(y.shape[-1] // 2, mask_idx)
        y = y.reshape(y.shape[0], y.shape[1], 2, -1)
        gt = gt.reshape(gt.shape[0], gt.shape[1], 2, -1)
        yv = y[:, 1:] - y[:, :-1]
        gv = gt[:, 1:] - gt[:, :-1]
        self.average_meter.update(np.abs(yv[..., mask] - gv[..., mask]).mean(),
                                  n=y.shape[0])

    def reset(self):
        self.average_meter.reset()

    def get_averages(self, desc):
        return {f"{desc}_VelL1": float(self.average_meter.avg)}


class F1:
    """Confusion-matrix cluster agreement (metrics.py:133-171)."""

    def __init__(self, num_clusters: int = 8):
        self.num_clusters = num_clusters
        self.labels = list(range(num_clusters))
        self.reset()

    def __call__(self, y, gt, mask_idx=None):
        """Rows: the true cluster, columns: the predicted one; pairs with a
        label outside ``0..num_clusters-1`` are not counted (scikit-learn's
        ``confusion_matrix(gt, y, labels=range(n))``)."""
        n = self.num_clusters
        gt = np.asarray(gt).reshape(-1).astype(np.int64)
        y = np.asarray(y).reshape(-1).astype(np.int64)
        ok = (gt >= 0) & (gt < n) & (y >= 0) & (y < n)
        self.cm += np.bincount(gt[ok] * n + y[ok],
                               minlength=n * n).reshape(n, n)

    def reset(self):
        self.cm = np.zeros((self.num_clusters, self.num_clusters))

    def get_precision(self):
        with np.errstate(divide="ignore", invalid="ignore"):
            return np.nan_to_num(np.diag(self.cm) / self.cm.sum(axis=0))

    def get_recall(self):
        with np.errstate(divide="ignore", invalid="ignore"):
            return np.nan_to_num(np.diag(self.cm) / self.cm.sum(axis=1))

    def get_F1(self):
        precision, recall = self.get_precision(), self.get_recall()
        with np.errstate(divide="ignore", invalid="ignore"):
            f1 = 2 * (precision * recall / (precision + recall))
        try:
            return float(np.average(np.nan_to_num(f1),
                                    weights=self.cm.sum(axis=1)))
        except ZeroDivisionError:
            return 0.0

    def get_acc(self):
        total = self.cm.sum()
        return float(np.diag(self.cm).sum() / total) if total else 0.0

    def get_averages(self, desc):
        return {f"{desc}_acc": self.get_acc(),
                f"{desc}_F1": self.get_F1(),
                f"{desc}_precision": float(np.mean(self.get_precision())),
                f"{desc}_recall": float(np.mean(self.get_recall()))}


class Diversity:
    """L1 distance from the dataset mean pose (metrics.py:173-190)."""

    def __init__(self, mean):
        self.div = AverageMeter("diversity")
        self.div_gt = AverageMeter("diversity_gt")
        self.mean = np.asarray(mean)

    def reset(self):
        self.div.reset()
        self.div_gt.reset()

    def __call__(self, y, gt, mask_idx=None):
        y = np.asarray(y)
        gt = np.asarray(gt)
        self.div.update(np.abs(y - self.mean).mean(), n=y.shape[0])
        self.div_gt.update(np.abs(gt - self.mean).mean(), n=y.shape[0])

    def get_averages(self, desc):
        return {f"{desc}_diversity": float(self.div.avg),
                f"{desc}_diversity_gt": float(self.div_gt.avg)}


class Expressiveness:
    """spatial/spatialNorm/energy/power expressivity (metrics.py:192-245).
    ``spatialNorm`` is the reference's dev-selection key."""

    def __init__(self, mean):
        self.spatial = AverageMeter("spatial")
        self.spatial_norm = AverageMeter("spatial_norm")
        self.energy = AverageMeter("energy")
        self.power = AverageMeter("power")
        self.mean = np.asarray(mean)

    def reset(self):
        for m in [self.spatial, self.spatial_norm, self.energy, self.power]:
            m.reset()

    @staticmethod
    def get_dist(y, mean):
        """Mean per-joint euclidean distance to `mean`; y (N, feats),
        mean broadcastable to y (metrics.py:205-208)."""
        y = y.reshape(y.shape[0], 2, -1)
        mean = np.broadcast_to(np.asarray(mean), (y.shape[0], y.shape[1]
                                                  * y.shape[2]))
        mean = mean.reshape(y.shape)
        return np.sqrt(((y - mean) ** 2).sum(axis=-2)).mean(-1)

    def get_expressivity(self, y, gt, mean):
        return float(np.sqrt(
            ((self.get_dist(y, mean) - self.get_dist(gt, mean)) ** 2).mean(-1)))

    def __call__(self, y, gt, mask_idx=None):
        y = np.asarray(y)
        gt = np.asarray(gt)
        mean = np.broadcast_to(self.mean, y.shape)
        self.spatial.update(self.get_expressivity(y, gt, mean), n=y.shape[0])
        self.spatial_norm.update(self.get_expressivity(mean, gt, mean),
                                 n=y.shape[0])
        yv, gv = y[1:] - y[:-1], gt[1:] - gt[:-1]
        self.energy.update(self.get_expressivity(yv, gv, np.zeros_like(yv)),
                           n=yv.shape[0])
        ya, ga = yv[1:] - yv[:-1], gv[1:] - gv[:-1]
        self.power.update(self.get_expressivity(ya, ga, np.zeros_like(ya)),
                          n=ya.shape[0])

    def get_averages(self, desc):
        if self.spatial_norm.avg > 0:
            spatial_norm = float(self.spatial.avg) / float(self.spatial_norm.avg)
        else:
            spatial_norm = 1000
        return {f"{desc}_spatialNorm": spatial_norm,
                f"{desc}_spatial": float(self.spatial.avg),
                f"{desc}_energy": float(self.energy.avg),
                f"{desc}_power": float(self.power.avg)}


class PCK:
    """Probability of Correct Keypoint at α ∈ {0.1, 0.2}, per-joint meters +
    bbox-scaled threshold (metrics.py:247-303).  Inputs (B, 2, joints)."""

    def __init__(self, alphas=(0.1, 0.2), num_joints: int = 52):
        self.alphas = list(alphas)
        self.num_joints = num_joints
        self.avg_meters = {f"pck_{al}_{jnt}": AverageMeter(f"pck_{al}_{jnt}")
                           for al in self.alphas for jnt in range(num_joints)}
        self.avg_meters.update({f"pck_{al}": AverageMeter(f"pck_{al}")
                                for al in self.alphas})
        self.avg_meters["pck"] = AverageMeter("pck")

    @staticmethod
    def get_thresh(gt, alpha):
        h = gt[:, 0, :].max(axis=-1) - gt[:, 0, :].min(axis=-1)
        w = gt[:, 1, :].max(axis=-1) - gt[:, 1, :].min(axis=-1)
        return alpha * np.maximum(h, w)[:, None]

    def __call__(self, y, gt, mask_idx=(0, 7, 8, 9)):
        y = np.asarray(y)
        gt = np.asarray(gt)
        B = y.shape[0]
        dist = np.sqrt(((y - gt) ** 2).sum(axis=1))  # (B, joints)
        mask = _unmasked(self.num_joints, mask_idx)
        for alpha in self.alphas:
            thresh = self.get_thresh(gt, alpha)
            pck = (dist < thresh).astype(np.float64)
            col_means = pck.mean(axis=0)  # hoisted: one reduce, not J of them
            for jnt in range(self.num_joints):
                self.avg_meters[f"pck_{alpha}_{jnt}"].update(
                    col_means[jnt], n=B)
            self.avg_meters[f"pck_{alpha}"].update(pck[:, mask].mean(),
                                                   n=B * len(mask))
        for alpha in self.alphas:
            self.avg_meters["pck"].update(self.avg_meters[f"pck_{alpha}"].avg,
                                          n=B * len(mask))

    def reset(self):
        for m in self.avg_meters.values():
            m.reset()

    def get_averages(self, desc):
        out = {}
        for alpha in self.alphas:
            for jnt in range(self.num_joints):
                out[f"{desc}_pck_{alpha}_{jnt}"] = \
                    float(self.avg_meters[f"pck_{alpha}_{jnt}"].avg)
            out[f"{desc}_pck_{alpha}"] = float(self.avg_meters[f"pck_{alpha}"].avg)
        out[f"{desc}_pck"] = float(self.avg_meters["pck"].avg)
        return out


class InceptionScoreStyle:
    """Inception Score over speaker styles via a frozen StyleClassifier
    (metrics.py:305-371).

    ``classifier_fn``: callable mapping a (B, 64, feats) pose window to
    (B, num_all_speakers) logits, a frozen ``StyleClassifier_G``'s forward:
    the trainer loads it from a ``-pretrained_model_weights`` checkpoint of
    the port (``Trainer._load_is_classifier``), one that ``cli.train
    -model StyleClassifier_G -speaker '["all"]'`` writes.
    """

    def __init__(self, num_clusters: int, weight: np.ndarray,
                 classifier_fn: Callable, eps: float = 1e-6):
        self.p_y = AverageMeter("p_y")
        self.p_yx = AverageMeter("p_yx")
        self.p_y_subset = AverageMeter("p_y")
        self.p_yx_subset = AverageMeter("p_yx")
        self.f1 = F1(num_clusters=num_clusters)
        weight = np.asarray(weight).astype(np.int64)
        self.weight = weight.squeeze(-1) if weight.ndim > 1 else weight
        self.f1_subset = F1(num_clusters=len(self.weight))
        self.cce = AverageMeter("cce")
        self.cce_subset = AverageMeter("cce")
        self.eps = eps
        self.classifier_fn = classifier_fn

    @staticmethod
    def _softmax(x):
        z = x - x.max(-1, keepdims=True)
        e = np.exp(z)
        return e / e.sum(-1, keepdims=True)

    @staticmethod
    def _cce(logits, labels):
        p = InceptionScoreStyle._softmax(logits)
        return float(-np.log(p[np.arange(len(labels)),
                               labels.astype(int)] + 1e-12).mean())

    def __call__(self, y, gt, mask_idx=(0, 7, 8, 9)):
        y = np.asarray(y).reshape(-1, 64, np.asarray(y).shape[-1])
        gt = np.asarray(gt).astype(np.int64)
        logits = np.asarray(self.classifier_fn(y))
        p_y = self._softmax(logits)
        p_y_subset = self._softmax(logits[:, self.weight])
        self.f1_subset(p_y[:, self.weight].argmax(-1), gt[:, 0])
        self.cce_subset.update(self._cce(logits[:, self.weight], gt[:, 0]),
                               n=len(y))
        self._update_is(p_y, self.p_y, self.p_yx)
        self._update_is(p_y_subset, self.p_y_subset, self.p_yx_subset)
        gt_global = self.weight[gt[:, 0]]
        self.f1(p_y.argmax(-1), gt_global)
        self.cce.update(self._cce(logits, gt_global), n=len(y))

    def _update_is(self, p_y, meter_p_y, meter_p_yx):
        meter_p_y.update(p_y.mean(0), n=p_y.shape[0])
        meter_p_yx.update((p_y * np.log(p_y + self.eps)).mean(0),
                          n=p_y.shape[0])

    def get_is(self, p_y, p_yx):
        py, pyx = np.asarray(p_y.avg), np.asarray(p_yx.avg)
        kl = pyx - py * np.log(py + self.eps)
        return float(np.exp(kl.sum()))

    def reset(self):
        for m in [self.p_y, self.p_yx, self.p_y_subset, self.p_yx_subset,
                  self.cce, self.cce_subset]:
            m.reset()
        self.f1.reset()
        self.f1_subset.reset()

    def get_averages(self, desc):
        out = {f"{desc}_style_IS": self.get_is(self.p_y, self.p_yx),
               f"{desc}_style_IS_subset": self.get_is(self.p_y_subset,
                                                      self.p_yx_subset),
               f"{desc}_style_cce": float(self.cce.avg),
               f"{desc}_style_cce_subset": float(self.cce_subset.avg)}
        out.update(self.f1.get_averages(desc + "_style"))
        out.update(self.f1_subset.get_averages(desc + "_style_subset"))
        return out


class FID:
    """Streaming Fréchet distance on masked pose frames (metrics.py:374-473)."""

    def __init__(self):
        self.gt_sum = AverageMeter("gt_sum")
        self.gt_square = AverageMeter("gt_square")
        self.y_sum = AverageMeter("y_sum")
        self.y_square = AverageMeter("y_square")

    def __call__(self, y, gt, mask_idx=(0, 7, 8, 9)):
        y = np.asarray(y)
        gt = np.asarray(gt)
        mask = _unmasked(y.shape[-1] // 2, mask_idx)
        y = y.reshape(y.shape[0], y.shape[1], 2, -1)[..., mask]
        y = y.reshape(-1, y.shape[-2] * y.shape[-1])
        gt = gt.reshape(gt.shape[0], gt.shape[1], 2, -1)[..., mask]
        gt = gt.reshape(-1, gt.shape[-2] * gt.shape[-1])
        self.gt_sum.update(gt.mean(0, keepdims=True), n=gt.shape[0])
        self.y_sum.update(y.mean(0, keepdims=True), n=y.shape[0])
        self.gt_square.update(gt.T @ gt / gt.shape[0], n=gt.shape[0])
        self.y_square.update(y.T @ y / y.shape[0], n=y.shape[0])

    def reset(self):
        for m in [self.gt_sum, self.gt_square, self.y_sum, self.y_square]:
            m.reset()

    @staticmethod
    def calculate_frechet_distance(mu1, sigma1, mu2, sigma2, eps=1e-6):
        from scipy import linalg

        diff = mu1 - mu2
        covmean = linalg.sqrtm(sigma1.dot(sigma2))
        if not np.isfinite(covmean).all():
            offset = np.eye(sigma1.shape[0]) * eps
            covmean = linalg.sqrtm((sigma1 + offset).dot(sigma2 + offset))
        if np.iscomplexobj(covmean):
            covmean = covmean.real
        return (diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2)
                - 2 * np.trace(covmean))

    def get_averages(self, desc):
        try:
            N = self.gt_sum.count
            gt_mu = np.asarray(self.gt_sum.avg).squeeze()
            y_mu = np.asarray(self.y_sum.avg).squeeze()
            gt_s = np.asarray(self.gt_sum.sum)
            y_s = np.asarray(self.y_sum.sum)
            gt_sigma = (np.asarray(self.gt_square.sum)
                        - gt_s.T @ gt_s / N) / (N - 1)
            y_sigma = (np.asarray(self.y_square.sum)
                       - y_s.T @ y_s / N) / (N - 1)
            fid = self.calculate_frechet_distance(gt_mu, gt_sigma, y_mu, y_sigma)
        except Exception:
            fid = 1000
        return {f"{desc}_FID": float(fid)}


class W1:
    """Wasserstein-1 between speed/accel histograms (metrics.py:476-532)."""

    def __init__(self):
        self.gt_vel = AverageMeter("gt_vel")
        self.gt_acc = AverageMeter("gt_acc")
        self.y_vel = AverageMeter("y_vel")
        self.y_acc = AverageMeter("y_acc")
        self.ranges = np.arange(0, 300, 0.1)

    @staticmethod
    def get_vel_acc(y):
        diff = lambda x: x[:, 1:] - x[:, :-1]
        absolute = lambda x: np.sqrt((x ** 2).sum(2)).mean(-1).reshape(-1)
        vel = diff(y)
        acc = diff(vel)
        return absolute(vel), absolute(acc)

    def __call__(self, y, gt, mask_idx=(0, 7, 8, 9)):
        y = np.asarray(y)
        gt = np.asarray(gt)
        mask = _unmasked(y.shape[-1], mask_idx)
        y = y.reshape(y.shape[0], y.shape[1], 2, -1)[..., mask]
        gt = gt.reshape(gt.shape[0], gt.shape[1], 2, -1)[..., mask]
        y_vel, y_acc = self.get_vel_acc(y)
        gt_vel, gt_acc = self.get_vel_acc(gt)
        self.y_vel.update(np.histogram(y_vel, bins=self.ranges)[0], n=1)
        self.y_acc.update(np.histogram(y_acc, bins=self.ranges)[0], n=1)
        self.gt_vel.update(np.histogram(gt_vel, bins=self.ranges)[0], n=1)
        self.gt_acc.update(np.histogram(gt_acc, bins=self.ranges)[0], n=1)

    def reset(self):
        for m in [self.gt_vel, self.gt_acc, self.y_vel, self.y_acc]:
            m.reset()

    def get_averages(self, desc):
        import scipy.stats

        N = self.ranges[:-1]
        try:
            w1_vel = scipy.stats.wasserstein_distance(
                N, N, self.y_vel.sum, self.gt_vel.sum)
            w1_acc = scipy.stats.wasserstein_distance(
                N, N, self.y_acc.sum, self.gt_acc.sum)
        except Exception:
            w1_vel = w1_acc = 1000
        return {f"{desc}_W1_vel": float(w1_vel),
                f"{desc}_W1_acc": float(w1_acc)}
