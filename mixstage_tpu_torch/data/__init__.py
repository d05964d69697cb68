"""The data pipeline (counterpart of ``mixstage_tpu/data``): the PATS h5
layout, the master CSV, windowing, samplers and transforms, and the mel DSP
of the waveform serving path."""
