"""The port's own copies of the data-side DSP it serves with."""
