"""Linear algebra and statistics.

Every function of ``paddle_tpu_torch.tensor`` in these groups against
``paddle_tpu.tensor`` on the same numpy inputs, on the CPU.
``torch_tensor_cases`` holds the cases, their inputs and their stated
tolerances; each compares values, dtypes and, where the case names
inputs, the gradients of one cotangent through the first output."""
import pytest

import torch_tensor_cases as tc
from torch_tensor_parity import check_case, on_cpu  # noqa: F401
import torch_threads  # noqa: F401  (one torch thread a worker)

CASES = {**tc.linalg_cases(),
         **tc.stat_cases()}


@pytest.mark.parametrize("name", sorted(CASES))
def test_linalg_function_matches_the_reference(name, on_cpu):  # noqa: F811
    check_case(name, CASES[name])
