"""Distributed training of the port — counterpart of
``paddle_tpu.distributed``: the world (``init_parallel_env``), the
collectives over ``torch.distributed``, the launcher and ``spawn``, the
mesh of ranks and the fleet engine (data parallelism, ZeRO 1-3 and
sequence parallelism). ``split`` (tensor parallelism) raises: it is the
second half of the multi-device port."""
from .communication import (  # noqa: F401
    Group,
    ReduceOp,
    all_gather,
    all_gather_object,
    all_reduce,
    alltoall,
    barrier,
    broadcast,
    get_group,
    new_group,
    recv,
    reduce,
    reduce_scatter,
    scatter,
    send,
    wait,
)
from .parallel import (  # noqa: F401
    ParallelEnv,
    get_rank,
    get_world_size,
    init_parallel_env,
)

from . import fleet  # noqa: F401
from . import launch  # noqa: F401
from . import utils  # noqa: F401
from .fleet import mesh_utils  # noqa: F401


def _spawn_worker(func, rank, nprocs, args, env):
    import os

    os.environ.update(env)
    os.environ["PADDLE_TRAINER_ID"] = os.environ["RANK"] = str(rank)
    os.environ["PADDLE_TRAINERS_NUM"] = os.environ["WORLD_SIZE"] = \
        str(nprocs)
    os.environ["PADDLE_LOCAL_RANK"] = os.environ["LOCAL_RANK"] = str(rank)
    func(*args)


def spawn(func, args=(), nprocs=-1, join=True, daemon=False, **options):
    """Paddle's ``distributed.spawn``: start ``nprocs`` local worker
    processes (default: one per card, else one) running ``func(*args)``
    with the launcher's rank environment, rank 0's free local port as the
    rendezvous (``MASTER_ADDR``/``MASTER_PORT``), so that each worker's
    ``init_parallel_env()`` joins the world. ``options['backend'] =
    'gloo'`` makes the workers join on the CPU. With ``join`` a worker
    that fails raises here."""
    import multiprocessing as mp

    import torch

    from .launch import _free_ports

    if nprocs == -1:
        nprocs = max(1, torch.cuda.device_count())
    env = {"MASTER_ADDR": "127.0.0.1",
           "MASTER_PORT": str(_free_ports(1)[0])}
    if options.get("backend") == "gloo":
        env["PADDLE_DIST_DEVICE"] = "cpu"
    ctx = mp.get_context("spawn")
    procs = []
    for rank in range(nprocs):
        p = ctx.Process(target=_spawn_worker,
                        args=(func, rank, nprocs, args, env), daemon=daemon)
        p.start()
        procs.append(p)
    if join:
        for p in procs:
            p.join()
        failed = [(rank, p.exitcode) for rank, p in enumerate(procs)
                  if p.exitcode != 0]
        if failed:
            raise RuntimeError(
                f"spawn worker(s) failed (rank, exitcode): {failed}")
    return procs


def split(x, size, operation, axis=0, num_partitions=1, gather_out=True,
          weight_attr=None, bias_attr=None, name=None):
    """Paddle's ``distributed.split`` (a model-parallel linear or
    embedding) is tensor parallelism, the second half of the multi-device
    port; it raises."""
    raise NotImplementedError(
        "distributed.split is tensor parallelism, the second half of the "
        "multi-device port")
