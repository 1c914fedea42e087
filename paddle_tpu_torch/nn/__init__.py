"""Layers and functionals of the port (``paddle_tpu.nn`` counterpart),
kept to what the ported slices use."""
