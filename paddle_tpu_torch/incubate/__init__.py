"""Incubating APIs (``paddle_tpu.incubate`` counterpart): the train-state
checkpoints (``checkpoint``)."""
