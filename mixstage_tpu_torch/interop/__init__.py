from mixstage_tpu_torch.interop.torch_import import (
    convert_reference_checkpoint, load_reference_state, load_torch_state_dict,
    sniff_torch_file)
from mixstage_tpu_torch.interop.weights import (jax_train_state_of,
                                                load_flax_opt_state,
                                                load_flax_state,
                                                load_jax_train_state,
                                                to_flax_opt_state,
                                                to_flax_state)

__all__ = ["load_flax_state", "to_flax_state", "load_flax_opt_state",
           "to_flax_opt_state", "load_jax_train_state", "jax_train_state_of",
           "convert_reference_checkpoint", "load_reference_state",
           "load_torch_state_dict", "sniff_torch_file"]
