"""One intra-op thread for torch in the port's test processes.

The suite runs under pytest-xdist, several worker processes on the
machine's cores, and torch's default of one intra-op thread per core
makes every worker's threads contend with the others' (OpenMP threads
spin between parallel regions). The port's tests are small ops in
Python loops: alone on an 8-core machine, `bench decode --smoke` took
210 s with torch's default of 8 threads against 4.3 s with 1, and
`bench longctx --smoke` 41.7 s against 5.8 s. Every `test_torch_*.py`
module imports this module; the JAX package's tests do not use torch.
"""
import torch

torch.set_num_threads(1)
