"""The port's metric suite against the JAX package's on the same arrays:
each metric class fed the same batches, then its averages compared.
Counts (F1's confusion matrix, W1's histograms), PCK and F1 exactly; the
rest within 1e-10 relative (the same numpy arithmetic; FID's matrix square
root and W1's distance call the same scipy functions)."""

import numpy as np
import pytest

from mixstage_tpu import evaluation as jev
from mixstage_tpu_torch import evaluation as pev

J = 52                                   # joints
MASK = (0, 7, 8, 9)
EXACT = ("PCK", "F1")


def _pose_batches(seed, n=3, b=4, t=64, scale=1.0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        gt = np.cumsum(rng.normal(size=(b, t, 2 * J)), 1) * scale + 300
        y = gt + rng.normal(size=gt.shape) * 5 * scale
        out.append((y, gt))
    return out


def _flat_pck(batches):
    return [(y.reshape(-1, 2, J), gt.reshape(-1, 2, J)) for y, gt in batches]


def _masked(batches):
    keep = sorted(set(range(J)) - set(MASK))
    return [(y.reshape(-1, 2, J)[..., keep].reshape(-1, 2 * len(keep)),
             gt.reshape(-1, 2, J)[..., keep].reshape(-1, 2 * len(keep)))
            for y, gt in batches]


def _labels(seed, n=3, m=8):
    rng = np.random.default_rng(seed)
    # one label out of range on each side: neither counts
    out = []
    for _ in range(n):
        gt = rng.integers(0, m, size=(4, 64))
        y = np.where(rng.random((4, 64)) < 0.6, gt,
                     rng.integers(0, m, size=(4, 64)))
        y[0, 0], gt[1, 1] = m, -1
        out.append((y, gt))
    return out


def _mean_pose(seed):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(2 * (J - len(MASK)),)) * 50 + 300


def _classifier(seed, speakers=5):
    w = np.random.default_rng(seed).normal(size=(2 * J, speakers)) / 30

    def fn(y):
        return np.asarray(y).mean(1) @ w
    return fn


CASES = {
    "L1": (lambda m: m.L1(), _pose_batches(1)),
    "VelL1": (lambda m: m.VelL1(), _pose_batches(2)),
    "FID": (lambda m: m.FID(), _pose_batches(3, b=16, scale=0.2)),
    "W1": (lambda m: m.W1(), [(y.reshape(4, 64, 2, J),
                               gt.reshape(4, 64, 2, J))
                              for y, gt in _pose_batches(4, scale=0.3)]),
    "PCK": (lambda m: m.PCK(num_joints=J), _flat_pck(_pose_batches(5))),
    "F1": (lambda m: m.F1(num_clusters=8), _labels(6)),
    "Diversity": (lambda m: m.Diversity(_mean_pose(7)),
                  _masked(_pose_batches(8))),
    "Expressiveness": (lambda m: m.Expressiveness(_mean_pose(9)),
                       _masked(_pose_batches(10))),
}


def _assert_averages(got, want, exact):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        if exact:
            assert g == w, (k, g, w)
        else:
            assert abs(g - w) <= 1e-10 * max(abs(w), 1e-300), (k, g, w)


@pytest.mark.parametrize("name", sorted(CASES))
def test_metric_matches_jax(name):
    make, batches = CASES[name]
    jm, pm = make(jev), make(pev)
    for y, gt in batches:
        jm(y, gt, MASK)
        pm(y, gt, MASK)
    _assert_averages(pm.get_averages("dev"), jm.get_averages("dev"),
                     name in EXACT)
    if name == "F1":
        np.testing.assert_array_equal(pm.cm, jm.cm)
        assert pm.cm.sum() == sum(y.size for y, _ in batches) - 2 * len(
            batches)
    if name == "W1":
        for a in ("gt_vel", "gt_acc", "y_vel", "y_acc"):
            np.testing.assert_array_equal(getattr(pm, a).sum,
                                          getattr(jm, a).sum)
    pm.reset()
    jm.reset()
    _assert_averages(pm.get_averages("x"), jm.get_averages("x"), True)


def test_stack_splits_by_style_and_speaker():
    speakers = ["oliver", "maher"]
    stacks = [m.Stack(m.L1(), n=2, speakers=speakers,
                      sample_styles=["same", "style"]) for m in (jev, pev)]
    for i, (y, gt) in enumerate(_pose_batches(11, n=4)):
        for s in stacks:
            s(y, gt, MASK, idx=i % 2, kwargs_name=["same", "style"][i // 2])
    (jo, js), (po, ps) = (s.get_averages("test") for s in stacks)
    assert po == jo and ps == js


def test_inception_score_matches_jax():
    weight = np.array([[3], [1]])
    rng = np.random.default_rng(12)
    metrics = [m.InceptionScoreStyle(5, weight, _classifier(13))
               for m in (jev, pev)]
    for _ in range(3):
        y = rng.normal(size=(4, 64, 2 * J))
        style = rng.integers(0, 2, size=(4, 64))
        for mtr in metrics:
            mtr(y, style)
    got, want = (mtr.get_averages("test") for mtr in metrics[::-1])
    _assert_averages(got, want, False)


def test_average_meter_matches_jax():
    a, b = jev.AverageMeter("a"), pev.AverageMeter("a")
    for v, n, v2 in ((1.5, 3, None), (2.0, 1, 4.0), (-1.0, 2, 1.0)):
        a.update(v, n, v2)
        b.update(v, n, v2)
    assert vars(a) == vars(b)
