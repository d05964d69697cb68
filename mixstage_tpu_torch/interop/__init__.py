from mixstage_tpu_torch.interop.weights import (load_flax_opt_state,
                                                load_flax_state,
                                                to_flax_opt_state,
                                                to_flax_state)

__all__ = ["load_flax_state", "to_flax_state", "load_flax_opt_state",
           "to_flax_opt_state"]
