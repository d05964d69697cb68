"""Reference (chahuja/mix-stage) checkpoint → the port's modules.

The port's copy of ``mixstage_tpu/interop/torch_import.py``.  The reference
saves ``model.state_dict()`` through pycasper into ``PREFIX_weights.p``;
for GAN trainers the saved module is the GAN wrapper, so keys carry
``G.`` / ``D.`` prefixes (reference ``src/model/trainer.py:1041-1087``,
``gan.py``), while non-GAN trainers save the generator's keys unprefixed
(``trainer.py:917-968``).

The conversion walks a template tree in the JAX package's (flax) layout —
the port's own modules seen through the weight bridge
(``interop/weights.py::to_flax_state``) — and renames every leaf path to
its reference key with the same rule tables as the JAX package
(``_GEN_RULES`` …, ``_rename`` ``:114``, ``_to_flax`` ``:129``,
``convert_reference_checkpoint`` ``:168``).  A template leaf with no
reference key raises; reference keys no leaf reads are reported.  The
converted trees then load into the port's modules through the bridge
(``load_reference_state``), so every converted tensor equals what the JAX
package's converter followed by the bridge gives, bit for bit.

Layout translation (torch ↔ flax, undone by the bridge):
  conv1d  torch (Cout, Cin/groups, K)     → flax (K, Cin/groups, Cout)
  conv2d  torch (Cout, Cin, Kh, Kw)       → flax (Kh, Kw, Cin, Cout)
  linear  torch (Cout, Cin)               → flax (Cin, Cout)
  batch-norm weight/bias/running_{mean,var} → scale/bias/mean/var (copy)
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

# flax-path → torch-key renames, applied to the '/'-joined path WITHIN one
# tree ('gen', 'psenc' or the discriminator).  First match wins; the match
# is substituted and the remainder handled by the leaf rules below.
_GEN_RULES: List[Tuple[str, str]] = [
    (r"^unet/pre(\d+)/", r"unet.pre_downsampling_conv.\1."),
    (r"^unet/down(\d+)/", r"unet.conv1.\1."),
    (r"^unet/up(\d+)/", r"unet.conv2.\1."),
    (r"^decoder(\d+)/", r"decoder.\1."),
    (r"^(audio_encoder|text_encoder)/conv(\d+)/", r"\1.conv.\2."),
    (r"^(classify_cluster|pose_encoder)/stack/conv(\d+)/", r"\1.conv.\2."),
    (r"^classify_cluster/logits/", r"classify_cluster.logits."),
    (r"^style_emb/embedding$", r"style_emb.emb.weight"),
    # single ConvNormRelu stored inside an nn.Sequential in the reference
    (r"^concat_encoder/", r"concat_encoder.0."),
    (r"^smoothen/", r"smoothen."),
    # StyleClassifier_G stack (style_classifier.py:19-26; its nn.Sequential
    # duplicates the same modules under 'model.N' — skipped as aliases)
    (r"^classifier(\d+)/", r"classifier.\1."),
]

_PSENC_RULES: List[Tuple[str, str]] = [
    (r"^stack/conv(\d+)/", r"pose_style_encoder.conv.\1."),
]

_DISC_RULES: List[Tuple[str, str]] = [
    # reference D.conv1 is nn.Sequential(conv, leaky) (speech2gesture.py)
    (r"^conv1/", r"conv1.0."),
    (r"^conv2_0/", r"conv2.0."),
]

# leaf renames (suffix of the path after module renaming)
_LEAF_RULES: List[Tuple[str, str]] = [
    (r"conv/kernel$", "conv.weight"),
    (r"conv/bias$", "conv.bias"),
    (r"norm/scale$", "norm.weight"),
    (r"norm/bias$", "norm.bias"),
    (r"norm/mean$", "norm.running_mean"),
    (r"norm/var$", "norm.running_var"),
    (r"(^|/)kernel$", r"\1weight"),
    (r"embedding$", "embedding"),  # already fully renamed by module rule
]


def sniff_torch_file(path: str) -> bool:
    """True when ``path`` is a torch checkpoint (zip archive or pickle)
    rather than a flax msgpack blob: torch.save's zip format starts with
    ``PK``, its legacy pickle format with ``\\x80``; msgpack maps and
    arrays never start with either byte.  The port's own checkpoints are
    torch files too: ``is_reference_state_dict`` tells them apart."""
    try:
        with open(path, "rb") as f:
            magic = f.read(4)
    except (OSError, IsADirectoryError):
        return False
    return magic[:2] == b"PK" or (len(magic) > 0 and magic[0] == 0x80)


def is_reference_state_dict(obj) -> bool:
    """A flat ``{key: tensor}`` state dict (keys with or without ``G.`` /
    ``D.``), as the reference saves: string keys, no nested dict, at least
    one tensor.  The port's checkpoints nest one state dict per module."""
    return (isinstance(obj, dict) and bool(obj)
            and all(isinstance(k, str) for k in obj)
            and not any(isinstance(v, dict) for v in obj.values())
            and any(torch.is_tensor(v) for v in obj.values()))


def state_dict_to_numpy(sd) -> Dict[str, np.ndarray]:
    """``{key: float numpy array}`` of a loaded state dict; non-tensor
    entries are dropped.  The reference trains in float64
    (``trainer.py:138``): values are cast later, against the template
    leaf's dtype."""
    return {key: val.detach().cpu().numpy() for key, val in sd.items()
            if torch.is_tensor(val)}


def load_torch_state_dict(path: str) -> Dict[str, np.ndarray]:
    """Load a reference ``PREFIX_weights.p`` (``weights_only``) into
    ``{key: float numpy array}``."""
    return state_dict_to_numpy(torch.load(path, map_location="cpu",
                                          weights_only=True))


def _rename(path: str, rules: List[Tuple[str, str]]) -> str:
    # leaf rules first: they key on the flax '/'-separated suffix, which the
    # module rules below rewrite into torch's '.'-separated form
    for pat, repl in _LEAF_RULES:
        new, n = re.subn(pat, repl, path)
        if n:
            path = new
            break
    for pat, repl in rules:
        new, n = re.subn(pat, repl, path)
        if n:
            path = new
    return path.replace("/", ".")


def _to_flax(arr: np.ndarray, template_leaf: Any, torch_key: str,
             flax_path: str = "") -> np.ndarray:
    """Torch layout → flax layout for one leaf, shape-checked."""
    tshape = tuple(np.shape(template_leaf))
    if torch_key.endswith(("weight",)) and arr.ndim == 3 \
            and not torch_key.endswith(("norm.weight", "emb.weight")):
        arr = arr.transpose(2, 1, 0)
    elif torch_key.endswith("weight") and arr.ndim == 4:
        arr = arr.transpose(2, 3, 1, 0)
    elif torch_key.endswith("weight") and arr.ndim == 2 \
            and flax_path.endswith("kernel"):
        # linear layer: torch (Cout, Cin) → flax Dense (Cin, Cout), decided
        # by the template leaf's role (a flax 'kernel'), never by shape: a
        # shape test skips the transpose on square Cin == Cout matrices
        arr = arr.T
    if arr.shape != tshape:
        raise ValueError(
            f"shape mismatch importing '{torch_key}': torch {arr.shape} "
            f"(after layout transpose) vs flax template {tshape}")
    dtype = getattr(template_leaf, "dtype", np.dtype(np.float32))
    return np.ascontiguousarray(arr.astype(dtype))


def _fill_tree(template: Any, sd: Dict[str, np.ndarray], prefix: str,
               rules: List[Tuple[str, str]], used: set,
               missing: List[str], path: str = "") -> Any:
    if isinstance(template, dict):
        return {k: _fill_tree(v, sd, prefix, rules, used, missing,
                              f"{path}/{k}" if path else k)
                for k, v in template.items()}
    torch_key = prefix + _rename(path, rules)
    if torch_key not in sd:
        missing.append(f"{path} (expected torch key '{torch_key}')")
        return template
    used.add(torch_key)
    return _to_flax(sd[torch_key], template, torch_key, flax_path=path)


def convert_reference_checkpoint(
        sd: Dict[str, np.ndarray],
        template: Dict[str, Any]) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Convert a reference state dict into ``template``-shaped trees.

    ``template`` is ``{g_params, g_state, d_params, d_state}`` in the flax
    layout (``reference_template``).  Returns ``(converted, report)``,
    where the report lists the skipped reference keys; raises
    ``ValueError`` when a template leaf has no source key."""
    gan_style = any(k.startswith("G.") for k in sd)
    gp = "G." if gan_style else ""
    used: set = set()
    missing: List[str] = []
    out: Dict[str, Any] = {}

    for part in ("g_params", "g_state"):
        tree = template.get(part) or {}
        conv = {}
        for sub, subtree in tree.items():
            rules = _PSENC_RULES if sub == "psenc" else _GEN_RULES
            conv[sub] = _fill_tree(subtree, sd, gp, rules, used, missing)
        out[part] = conv
    for part in ("d_params", "d_state"):
        tree = template.get(part)
        if not tree:
            out[part] = tree
            continue
        if not gan_style and not any(k.startswith("D.") for k in sd):
            # reference non-GAN checkpoints carry no discriminator: keep
            # the freshly initialised one (the reference's -gan 0 resume)
            out[part] = tree
            continue
        out[part] = _fill_tree(tree, sd, "D.", _DISC_RULES, used, missing)

    if missing:
        raise ValueError(
            "reference checkpoint is missing weights for "
            f"{len(missing)} flax leaves; first few: {missing[:5]}. "
            "Is the checkpoint from the same -model/-modelKwargs?")

    skipped = sorted(k for k in sd if k not in used)
    # momentum counters and unused reference branches are expected noise
    expected = re.compile(
        r"num_batches_tracked$|^(G\.)?(eye|thresh)|"
        r"^(G\.)?(style_dec|style_dec_gr|text_encoder|pose_encoder|"
        r"concat_encoder|smoothen|concat_encoder2|model)\.")
    surprising = [k for k in skipped if not expected.search(k)]
    report = {"n_converted": len(used), "n_skipped": len(skipped),
              "skipped": skipped, "surprising_skipped": surprising}
    return out, report


def reference_template(state) -> Dict[str, Any]:
    """The port's ``TrainState`` modules as the converter's template:
    ``{g_params, g_state, d_params, d_state}`` in the flax layout (numpy,
    through the weight bridge), shaped as the JAX package's checkpoint
    trees."""
    from mixstage_tpu_torch.interop.weights import to_flax_state

    if state.psenc is None or state.disc is None:
        raise NotImplementedError(
            "a reference checkpoint converts into the Mix-StAGE GAN's "
            "modules (gen, psenc, disc); the other model families come "
            "later (ROADMAP queue 1 item 7)")
    gen_p, gen_s = to_flax_state(state.gen)
    ps_p, ps_s = to_flax_state(state.psenc)
    d_p, d_s = to_flax_state(state.disc)
    return {"g_params": {"gen": gen_p, "psenc": ps_p},
            "g_state": {"gen": gen_s, "psenc": ps_s},
            "d_params": d_p, "d_state": d_s}


def load_reference_state(state, sd: Dict[str, np.ndarray]):
    """Convert the reference state dict ``sd`` (numpy, ``load_torch_state_
    dict``) and load it into ``state``'s modules in place.  Returns
    ``(state, report)``."""
    from mixstage_tpu_torch.interop.weights import load_flax_state

    conv, report = convert_reference_checkpoint(sd, reference_template(state))
    load_flax_state(state.gen, conv["g_params"]["gen"], conv["g_state"]["gen"])
    load_flax_state(state.psenc, conv["g_params"]["psenc"],
                    conv["g_state"]["psenc"])
    load_flax_state(state.disc, conv["d_params"], conv["d_state"])
    return state, report
