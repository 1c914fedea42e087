"""Distributed training of the port (``paddle_tpu.distributed``
counterpart); the single-device engine is the part ported so far."""
