"""Mixed precision (``paddle_tpu.amp`` counterpart): ``auto_cast`` over the
reference's op lists. ``GradScaler`` is not ported yet (bf16 needs no
loss scaling)."""
from .auto_cast import (amp_guard, amp_state, auto_cast, black_list,
                        decorate, maybe_cast_inputs, white_list)

__all__ = ["auto_cast", "amp_guard", "amp_state", "decorate",
           "maybe_cast_inputs", "white_list", "black_list"]
