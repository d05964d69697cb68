"""The port's config and CLI sweep against the JAX package's: the same
flags and defaults, and for each argv the same permutations (as dicts), in
the same order, with the same typed-flag overrides."""

import pytest

from mixstage_tpu import config as jcfg
from mixstage_tpu_torch import config as pcfg

# argv → (argv, number of permutations)
ARGVS = {
    "defaults": ([], 1),
    "flagship": (["-path2data", "/data", "-speaker", '["oliver", "maher"]',
                  "-model", "JointLateClusterSoftStyle4_G", "-gan", "1",
                  "-loss", "L1Loss", "-fused_decoder", "1", "-num_clusters",
                  "8", "-modelKwargs", '{"in_channels": 64}'], 1),
    "sweep": (["-lr", "0.1", "0.2", "-batch_size", "4", "8", "-dtype",
               "float32", "bfloat16"], 8),
    "list_valued": (["-speaker", '["oliver"]', '["maher", "jon"]', "-mask",
                     "[0, 7]", '[0, "range(7, 10)"]'], 4),
    "double_dash": (["--exp", "3", "--scan_steps", "8", "--num_workers",
                     "2", "-preempt_save", "0", "-load",
                     "/x/PREFIX_weights.p"], 1),
}


def _perms(mod, argv):
    out = []
    mod.argparse_n_loop(lambda cfg, i: out.append(
        (i, cfg.to_dict(), mod.get_args_update_dict(cfg),
         mod.get_args_update_dict(cfg, argv))), argv)
    return out


def test_same_flags_and_defaults():
    assert pcfg._FLAG_NAMES == jcfg._FLAG_NAMES
    assert pcfg.Config().to_dict() == jcfg.Config().to_dict()


@pytest.mark.parametrize("name", sorted(ARGVS))
def test_argparse_n_loop_matches_jax(name):
    argv, n = ARGVS[name]
    got, want = _perms(pcfg, argv), _perms(jcfg, argv)
    assert got == want
    assert len(got) == n


def test_config_round_trips_through_json(tmp_path):
    cfg = pcfg.config_from_dict({"lr": 0.5, "speaker": ["a", "b"],
                                 "not_a_flag": 1})
    cfg.save(tmp_path / "c.args")
    back = pcfg.load_config(tmp_path / "c.args")
    assert back.to_dict() == cfg.to_dict()
    assert back.lr == 0.5 and back.speaker == ["a", "b"]
