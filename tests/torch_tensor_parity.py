"""The reference side of the tensor namespace's parity cases
(``torch_tensor_cases``): each case through ``paddle_tpu.tensor`` and
through ``paddle_tpu_torch.tensor`` on the CPU, on the same numpy inputs."""
import numpy as np
import pytest

import paddle_tpu as paddle
import paddle_tpu_torch as ptt
import torch_tensor_cases as tc


class RefAdapter:
    T = paddle.tensor

    def tensor(self, a, requires_grad):
        return paddle.to_tensor(a, stop_gradient=not requires_grad)

    def is_tensor(self, o):
        return isinstance(o, paddle.Tensor)

    def numpy(self, o):
        if not self.is_tensor(o):
            return np.asarray(o), None
        arr = np.asarray(o.numpy())
        name = str(arr.dtype)
        if name == "bfloat16":
            arr = arr.astype(np.float32)
        return arr, name

    def backward(self, out, ct):
        (out * ct).sum().backward()

    def grad(self, t):
        return np.asarray(t.grad.numpy())


@pytest.fixture
def on_cpu():
    """The port's current device set to the CPU for the test."""
    from paddle_tpu_torch.core import place

    prev = place.get_device()
    ptt.set_device("cpu")
    yield
    place._current_device = prev


def check_case(name, case, seed=0):
    """The case through both packages; asserts parity and returns the
    worst errors."""
    want = tc.run(name, case, RefAdapter(), seed)
    got = tc.run(name, case, tc.PortAdapter(ptt.tensor, "cpu"), seed)
    if case.kind == "random":
        tc.compare_random(name, want[0])
    return tc.compare(name, case, got, want)
