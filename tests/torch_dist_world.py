"""A gloo world of N ranks for the port's multi-process parity tests.

``World(n, root)`` spawns ``n`` processes that join one
``torch.distributed`` world on the CPU (gloo, a ``file://`` store under
``root``: every world has its own rendezvous, so xdist workers never
meet) and then serve tasks: ``world.run(name, **kwargs)`` calls
``torch_dist_workers.<name>(**kwargs)`` on every rank and returns the
ranks' results in rank order. Every collective of the world carries a
60 s timeout, and ``run`` gives up after ``timeout_s``: a hang fails the
test instead of using up the suite's clock. A module starts its world
once (a module-scoped fixture) and reuses it across its cases; the
workers import torch and the port only.
"""
from __future__ import annotations

import multiprocessing as mp
import os
import traceback

_COLLECTIVE_TIMEOUT_S = 60.0


def _serve(rank, n, init_method, conn):
    os.environ.update({"PADDLE_TRAINER_ID": str(rank),
                       "PADDLE_TRAINERS_NUM": str(n),
                       "PADDLE_LOCAL_RANK": str(rank)})
    try:
        import torch

        torch.set_num_threads(1)
        from paddle_tpu_torch.distributed import init_parallel_env

        import torch_dist_workers

        init_parallel_env(device="cpu", init_method=init_method,
                          timeout_s=_COLLECTIVE_TIMEOUT_S)
        conn.send(("ready", None))
    except Exception:  # noqa: BLE001 — reported to the parent
        conn.send(("error", traceback.format_exc()))
        return
    while True:
        msg = conn.recv()
        if msg is None:
            break
        name, kwargs = msg
        try:
            out = getattr(torch_dist_workers, name)(**kwargs)
            conn.send(("ok", out))
        except Exception:  # noqa: BLE001
            conn.send(("error", traceback.format_exc()))
    torch.distributed.destroy_process_group()


class World:
    def __init__(self, n: int, root: str, timeout_s: float = 180.0):
        self.n = n
        self.timeout_s = timeout_s
        os.makedirs(root, exist_ok=True)
        init = "file://" + os.path.join(root, f"store{n}")
        ctx = mp.get_context("spawn")
        self._conns, self._procs = [], []
        for r in range(n):
            parent, child = ctx.Pipe()
            p = ctx.Process(target=_serve, args=(r, n, init, child),
                            daemon=True)
            p.start()
            self._conns.append(parent)
            self._procs.append(p)
        self._collect("start")

    def _collect(self, what):
        out, errors = [], []
        for r, c in enumerate(self._conns):
            if not c.poll(self.timeout_s):
                self.close()
                raise AssertionError(f"rank {r} gave no answer to {what} "
                                     f"within {self.timeout_s:.0f} s")
            kind, val = c.recv()
            if kind == "error":
                errors.append(f"--- rank {r} ---\n{val}")
            out.append(val)
        if errors:
            raise AssertionError(f"{what} failed:\n" + "\n".join(errors))
        return out

    def run(self, name: str, **kwargs) -> list:
        for c in self._conns:
            c.send((name, kwargs))
        return self._collect(name)

    def close(self) -> None:
        for c in self._conns:
            try:
                c.send(None)
            except (OSError, BrokenPipeError):
                pass
        for p in self._procs:
            p.join(10)
            if p.is_alive():
                p.kill()
                p.join()
