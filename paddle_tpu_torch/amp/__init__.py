"""Mixed precision (``paddle_tpu.amp`` counterpart): ``auto_cast`` over the
reference's op lists, and dynamic loss scaling for fp16 (``GradScaler``,
``AmpScaler``)."""
from .auto_cast import (amp_guard, amp_state, auto_cast, black_list,
                        decorate, maybe_cast_inputs, white_list)
from .grad_scaler import AmpScaler, GradScaler, current_loss_scale

__all__ = ["auto_cast", "amp_guard", "amp_state", "decorate",
           "maybe_cast_inputs", "white_list", "black_list", "AmpScaler",
           "GradScaler", "current_loss_scale"]
