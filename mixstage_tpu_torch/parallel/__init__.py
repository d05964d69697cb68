"""Host-side parallel helpers (counterpart of ``mixstage_tpu/parallel``;
the device layouts of its ``mesh.py`` are ROADMAP queue 1 item 6)."""

from mixstage_tpu_torch.parallel.parallel import parallel  # noqa: F401
