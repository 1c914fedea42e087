"""``callbacks`` — the hapi callbacks under the reference's top-level
name (``paddle_tpu.callbacks`` counterpart)."""
from .hapi.callbacks import (Callback, EarlyStopping, LRScheduler,
                             ModelCheckpoint, ProgBarLogger,
                             ReduceLROnPlateau, TelemetryLogger, VisualDL)

__all__ = ["Callback", "ProgBarLogger", "ModelCheckpoint", "VisualDL",
           "LRScheduler", "EarlyStopping", "ReduceLROnPlateau",
           "TelemetryLogger"]
