"""Rendering: the skeleton rasteriser (host C++), its writers and
``animate`` (the port's copy of ``mixstage_tpu/animation``)."""

from mixstage_tpu_torch.animation.animation import (animate,  # noqa: F401
                                                    render_ground_truth,
                                                    save_animation)
