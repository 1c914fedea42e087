"""Process launcher — ``python -m paddle_tpu_torch.distributed.launch``,
counterpart of ``paddle_tpu.distributed.launch`` (Paddle's fleet.launch).

Spawns one trainer process per device on this host with the reference's
environment contract (``PADDLE_TRAINER_ID``, ``PADDLE_TRAINERS_NUM``,
``PADDLE_TRAINER_ENDPOINTS``, ``PADDLE_CURRENT_ENDPOINT``,
``PADDLE_LOCAL_RANK``) and torch's (``MASTER_ADDR``, ``MASTER_PORT`` —
rank 0's endpoint —, ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``), which
``init_parallel_env`` reads: on the card each rank takes
``cuda:LOCAL_RANK``; ``backend="cpu"`` (``--backend cpu``) exports
``PADDLE_DIST_DEVICE=cpu`` so that the ranks join a gloo world. It
streams each rank's output to ``<log_dir>/workerlog.<rank>`` and
supervises the children: any child's death tears the job down (no rank
is replaced; recovery is checkpoint-based).

Elastic relaunch (``--max_restarts`` / ``PADDLE_TPU_MAX_RESTARTS``): a
torn-down job is relaunched whole, with capped attempts and
deterministic exponential backoff, when the teardown was recoverable —
the ranks resume from their last committed checkpoint:

- exit **77** (``EXIT_PREEMPTED``): a rank checkpointed on SIGTERM and
  asked to be relaunched;
- exit **113** (``EXIT_WATCHDOG``): a rank self-aborted on a hang (its
  step watchdog or a collective's hang guard);
- a **signal-killed rank** (negative returncode) or a rank whose
  heartbeat file (``--rank_hang_timeout``) went stale: the supervisor
  tears the survivors down so nobody blocks forever in a collective,
  and the job restarts.

Every other non-zero exit keeps the fail-fast contract. Telemetry:
``resilience/job_restarts``, ``resilience/restarts`` (preemption
relaunches), ``resilience/rank_failures`` (+ per-rank
``resilience/rank_failures.rank<i>``).

Multi-host: pass ``--ips host1,host2`` and ``--started_port`` and run the
same command on every host; rank 0's host:port is the rendezvous.
"""
from __future__ import annotations

import argparse
import os
import signal
import socket
import subprocess
import sys
import time
from typing import List, Optional

__all__ = ["launch", "get_cluster_env", "watch_local_trainers",
           "supervise_local_trainers", "rank_telemetry_path",
           "heartbeat_path"]


def _free_ports(n: int) -> List[int]:
    socks, ports = [], []
    for _ in range(n):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        socks.append(s)
        ports.append(s.getsockname()[1])
    for s in socks:
        s.close()
    return ports


def get_cluster_env(node_ip: str, ips: List[str], nproc_per_node: int,
                    base_port: Optional[int] = None):
    """Build the per-rank env dicts for this node (launch_utils.get_cluster
    parity). Returns (envs, global_endpoints)."""
    nnodes = len(ips)
    if nnodes > 1 and base_port is None:
        raise ValueError(
            "multi-node launch requires --started_port: without a common "
            "base port each node would advertise unknowable (0) ports for "
            "its peers and the endpoint lists would disagree across nodes"
        )
    node_rank = ips.index(node_ip)
    ports = ([base_port + i for i in range(nproc_per_node)] if base_port
             else _free_ports(nproc_per_node))
    # endpoints of ALL ranks (node-major) — ports must match across nodes
    # when base_port is given; for single-node free ports are fine
    all_eps = []
    for ni, ip in enumerate(ips):
        for pi in range(nproc_per_node):
            port = (base_port + pi) if base_port else (
                ports[pi] if ni == node_rank else 0)
            all_eps.append(f"{ip}:{port}")
    world = nnodes * nproc_per_node
    envs = []
    for local_rank in range(nproc_per_node):
        rank = node_rank * nproc_per_node + local_rank
        env = {
            "PADDLE_TRAINER_ID": str(rank),
            "PADDLE_TRAINERS_NUM": str(world),
            "PADDLE_TRAINER_ENDPOINTS": ",".join(all_eps),
            "PADDLE_CURRENT_ENDPOINT": all_eps[rank],
            "PADDLE_LOCAL_RANK": str(local_rank),
            "PADDLE_NNODES": str(nnodes),
            "PADDLE_NODE_RANK": str(node_rank),
            # torch's names (init_parallel_env reads either contract)
            "MASTER_ADDR": all_eps[0].rsplit(":", 1)[0],
            "MASTER_PORT": all_eps[0].rsplit(":", 1)[1],
            "RANK": str(rank),
            "WORLD_SIZE": str(world),
            "LOCAL_RANK": str(local_rank),
        }
        envs.append(env)
    return envs, all_eps


def _teardown(procs: List[subprocess.Popen], grace_s: float = 10.0,
              sig: int = signal.SIGTERM, mark: bool = True) -> None:
    """Terminate every still-running child (marking it so the log report
    does not blame it), escalating to SIGKILL after ``grace_s`` — a rank
    hung in a collective ignores SIGTERM forever. The Ctrl-C path reuses
    this with ``sig=SIGINT, mark=False`` (children get their own
    KeyboardInterrupt; nobody was "killed by the watcher")."""
    for q in procs:
        if q.poll() is None:
            if mark:
                q.killed_by_watcher = True
            q.send_signal(sig)
    deadline = time.time() + grace_s
    for q in procs:
        if q.poll() is None:
            try:
                q.wait(timeout=max(0.1, deadline - time.time()))
            except subprocess.TimeoutExpired:
                q.kill()


def supervise_local_trainers(procs: List[subprocess.Popen],
                             poll_interval: float = 1.0,
                             heartbeat_files: Optional[List[str]] = None,
                             hang_timeout: float = 0.0):
    """Supervisor loop (launch_utils.py:556 fail-fast watch, grown
    rank-failure detection): block until all children exit cleanly, or
    tear the job down as soon as one rank fails — by exiting non-zero,
    by dying to a signal (negative returncode: SIGKILL/OOM), or, with
    ``hang_timeout`` > 0, by letting its heartbeat file go stale (a rank
    alive-but-stuck in a collective; teardown here is what keeps the
    OTHER ranks from blocking forever). Returns ``(rc, events)`` where
    ``events`` is a list of ``{"rank", "kind": "exit"|"signal"|"hang",
    "rc"}`` failure records the launcher folds into telemetry.

    A hang resolves to ``EXIT_WATCHDOG`` — the same restartable code a
    rank's own watchdog uses, because it is the same fault observed from
    outside. ``hang_timeout`` must cover the slowest legitimate
    heartbeat gap INCLUDING worker startup (import + first-step
    compile), the watchdog-deadline sizing rule.
    """
    events: List[dict] = []
    start = time.time()
    try:
        while True:
            alive = False
            for rank, p in enumerate(procs):
                rc = p.poll()
                if rc is None:
                    alive = True
                elif rc != 0:
                    events.append({"rank": rank,
                                   "kind": "signal" if rc < 0 else "exit",
                                   "rc": rc})
                    _teardown(procs)
                    return rc, events
            if not alive:
                return 0, events
            if hang_timeout > 0 and heartbeat_files:
                now = time.time()
                for rank, (p, hb) in enumerate(zip(procs, heartbeat_files)):
                    if p.poll() is not None:
                        continue
                    try:
                        last = os.path.getmtime(hb)
                    except OSError:
                        last = start  # no beat yet: count from job start
                    stale = now - max(last, start)
                    if stale > hang_timeout:
                        events.append({"rank": rank, "kind": "hang",
                                       "rc": None, "stale_s": stale})
                        _teardown(procs)
                        return _watchdog_exit_code(), events
            time.sleep(poll_interval)
    except KeyboardInterrupt:
        _teardown(procs, sig=signal.SIGINT, mark=False)
        return 130, events


def watch_local_trainers(procs: List[subprocess.Popen],
                         poll_interval: float = 1.0) -> int:
    """Back-compat fail-fast watch: ``supervise_local_trainers`` without
    heartbeat/hang detection, returning only the exit code."""
    rc, _events = supervise_local_trainers(procs, poll_interval)
    return rc


def rank_telemetry_path(base: Optional[str], log_dir: str, rank) -> str:
    """Per-rank telemetry JSONL sink. With a user-provided ``base``
    (``--telemetry_jsonl`` / PADDLE_TPU_TELEMETRY_JSONL) rank files land
    beside it as ``<base-stem>.rank<i>.jsonl`` — a SHARED path across
    ranks would interleave concurrent appends into one corrupt log.
    Default: ``<log_dir>/telemetry.rank<i>.jsonl``."""
    if base:
        root, ext = os.path.splitext(base)
        return f"{root}.rank{rank}{ext or '.jsonl'}"
    return os.path.join(log_dir, f"telemetry.rank{rank}.jsonl")


def heartbeat_path(log_dir: str, rank) -> str:
    """Per-rank heartbeat file the supervisor's hang detection watches.
    Exported to each worker as ``PADDLE_TPU_HEARTBEAT_FILE`` and touched
    by ``resilience.watchdog.heartbeat`` at every step boundary (the
    same cadence that feeds the in-process watchdog)."""
    return os.path.join(log_dir, f"heartbeat.rank{rank}")


def _run_job_once(training_script, script_args, envs, log_dir, backend,
                  extra_env, log_mode: str,
                  telemetry_jsonl: Optional[str] = None,
                  rank_hang_timeout: float = 0.0,
                  poll_interval: float = 1.0,
                  attempt: int = 0):
    """Spawn every rank, supervise, surface the failing log tail. One
    launch attempt — the restart policy lives in ``launch``. Returns
    ``(rc, events)`` from ``supervise_local_trainers``."""
    procs = []
    logs = []
    hb_files = []
    for local_rank, env in enumerate(envs):
        full_env = {**os.environ, **env, **(extra_env or {})}
        # attempt stamp: tells a live rank's files from those a killed
        # previous attempt left behind
        full_env["PADDLE_TPU_LAUNCH_ATTEMPT"] = str(attempt)
        if backend == "cpu":  # the ranks join a gloo world on the CPU
            full_env["PADDLE_DIST_DEVICE"] = "cpu"
        rank = env["PADDLE_TRAINER_ID"]
        # per-rank telemetry sink: the watchdog's dump on a hang and the
        # integrity monitor's records land here, one file a rank
        full_env["PADDLE_TPU_TELEMETRY_JSONL"] = rank_telemetry_path(
            telemetry_jsonl, log_dir, rank)
        hb = heartbeat_path(log_dir, rank)
        hb_files.append(hb)
        full_env["PADDLE_TPU_HEARTBEAT_FILE"] = hb
        # ops plane: one HTTP port per rank — a shared PADDLE_TPU_OPS_PORT
        # would have every local rank racing one bind (first wins, the
        # rest invisible to the scrape config), so the launcher offsets
        # the base port by the GLOBAL rank: rank i serves on base + i
        ops_base = full_env.get("PADDLE_TPU_OPS_PORT", "").strip()
        if ops_base:
            try:
                base_ops_port = int(ops_base)
            except ValueError:
                base_ops_port = 0
            if base_ops_port > 0:
                full_env["PADDLE_TPU_OPS_PORT"] = str(
                    base_ops_port + int(rank))
        log_f = open(os.path.join(log_dir, f"workerlog.{rank}"), log_mode)
        logs.append(log_f)
        p = subprocess.Popen(
            [sys.executable, "-u", training_script, *script_args],
            env=full_env, stdout=log_f, stderr=subprocess.STDOUT,
        )
        procs.append(p)
    rc, events = supervise_local_trainers(
        procs, poll_interval=poll_interval, heartbeat_files=hb_files,
        hang_timeout=rank_hang_timeout)
    for f in logs:
        f.close()
    if rc not in (0, _preempt_exit_code()):
        hung = {e["rank"]: e for e in events if e["kind"] == "hang"}
        # surface the failing rank's tail, like the reference's log pull
        for local_rank, env in enumerate(envs):
            rank = env["PADDLE_TRAINER_ID"]
            path = os.path.join(log_dir, f"workerlog.{rank}")
            try:
                with open(path) as f:
                    tail = f.readlines()[-20:]
                p = procs[local_rank]
                if local_rank in hung:
                    sys.stderr.write(
                        f"----- rank {rank} hung (no heartbeat for "
                        f"{hung[local_rank]['stale_s']:.1f}s); job torn "
                        "down; log tail -----\n")
                    sys.stderr.writelines(tail)
                elif getattr(p, "killed_by_watcher", False):
                    sys.stderr.write(
                        f"----- rank {rank} terminated by watcher after "
                        "another rank failed -----\n")
                elif p.returncode is not None and p.returncode < 0:
                    sys.stderr.write(
                        f"----- rank {rank} killed by signal "
                        f"{-p.returncode}; log tail -----\n")
                    sys.stderr.writelines(tail)
                elif p.returncode not in (0, None):
                    sys.stderr.write(f"----- rank {rank} failed; log tail -----\n")
                    sys.stderr.writelines(tail)
            except OSError:
                pass
    return rc, events


def _death_timestamp(log_dir: str, envs: List[dict]) -> float:
    """Best-effort date of a dead attempt's death: the newest per-rank
    heartbeat mtime — ranks touch their heartbeat file every step, so
    the last beat is the last moment the job was provably making
    progress (for a hang that is well BEFORE the supervisor's stale
    detection; for a preemption it is the last step before the spill).
    Falls back to now when no rank ever beat."""
    now = time.time()
    best = None
    for env in envs:
        try:
            m = os.path.getmtime(
                heartbeat_path(log_dir, env["PADDLE_TRAINER_ID"]))
        except OSError:
            continue
        if best is None or m > best:
            best = m
    if best is None or best > now:
        return now
    return best


def _preempt_exit_code() -> int:
    from ..resilience.preemption import EXIT_PREEMPTED

    return EXIT_PREEMPTED


def _watchdog_exit_code() -> int:
    from ..resilience.watchdog import EXIT_WATCHDOG

    return EXIT_WATCHDOG


def launch(training_script: str, script_args: List[str],
           nproc_per_node: int = 1, ips: str = "127.0.0.1",
           node_ip: Optional[str] = None, base_port: Optional[int] = None,
           log_dir: str = "log", backend: Optional[str] = None,
           extra_env: Optional[dict] = None,
           max_restarts: Optional[int] = None,
           restart_backoff: float = 1.0,
           telemetry_jsonl: Optional[str] = None,
           rank_hang_timeout: Optional[float] = None) -> int:
    """Launch + supervise the local ranks; with ``max_restarts`` > 0 (or
    ``PADDLE_TPU_MAX_RESTARTS``), a job torn down by a RECOVERABLE fault
    is restarted whole with capped attempts and deterministic
    exponential backoff (see module docstring): exit 77 (preempted,
    checkpointed), exit 113 (watchdog/collective-timeout self-abort), a
    signal-killed rank, or — with ``rank_hang_timeout`` > 0 (or
    ``PADDLE_TPU_RANK_HANG_TIMEOUT``) — a rank whose per-step heartbeat
    file went stale. Any other non-zero exit keeps the reference's
    fail-fast contract.

    ``telemetry_jsonl`` (or ``PADDLE_TPU_TELEMETRY_JSONL``): append one
    launcher telemetry record there when the job ends after >= 1
    relaunch — the ``resilience/restarts`` counter lives in THIS
    process, so without a sink it would never reach the JSONL the
    workers write. Every RANK additionally gets its own sink
    (``rank_telemetry_path``: ``<log_dir>/telemetry.rank<i>.jsonl`` by
    default) exported as its PADDLE_TPU_TELEMETRY_JSONL."""
    from ..profiler import goodput as _goodput
    from ..profiler.telemetry import get_telemetry
    from ..resilience.retry import backoff_delays

    ip_list = [s.strip() for s in ips.split(",") if s.strip()]
    node_ip = node_ip or ip_list[0]
    envs, _ = get_cluster_env(node_ip, ip_list, nproc_per_node, base_port)
    os.makedirs(log_dir, exist_ok=True)
    if max_restarts is None:
        max_restarts = int(os.environ.get("PADDLE_TPU_MAX_RESTARTS", "0"))
    if telemetry_jsonl is None:
        telemetry_jsonl = os.environ.get("PADDLE_TPU_TELEMETRY_JSONL")
    if rank_hang_timeout is None:
        rank_hang_timeout = float(
            os.environ.get("PADDLE_TPU_RANK_HANG_TIMEOUT", "0") or 0)
    # fresh job ⇒ fresh telemetry: workerlog.<rank> opens with mode "w"
    # below, but the per-rank telemetry sinks are APPENDED by workers, so
    # stale files from a previous job in this log_dir (possibly with a
    # larger world — ghost ranks) would pollute telemetry_agg's cluster
    # view and its straggler medians. Relaunch attempts keep appending.
    # Heartbeat files are stale the same way: a previous job's fresh
    # mtimes would mask a rank of THIS job hanging before its first beat.
    import glob as _glob

    pattern = rank_telemetry_path(telemetry_jsonl, log_dir, "*")
    for stale in (_glob.glob(pattern)
                  + _glob.glob(heartbeat_path(log_dir, "*"))):
        try:
            os.remove(stale)
        except OSError:
            pass
    delays = backoff_delays(max_restarts, base=restart_backoff)
    tel = get_telemetry()
    attempt = 0
    rank_failures = 0
    pending_death_ts = None
    while True:
        if pending_death_ts is not None:
            # the children respawn NOW: the job was dead from the
            # (heartbeat-dated) death of the previous attempt to this
            # instant. The histogram records the relaunch cost; the
            # launcher's own goodput ledger books the same seconds as
            # restart_downtime (a transfer out of its base state, so its
            # ledger still conserves) — that is how the category
            # survives the worker process that caused it.
            downtime_s = max(0.0, time.time() - pending_death_ts)
            tel.observe("resilience/restart_downtime_ms",
                        downtime_s * 1e3)
            _goodput.ledger().reattribute("restart_downtime", downtime_s)
            pending_death_ts = None
        rc, events = _run_job_once(training_script, script_args, envs,
                                   log_dir, backend, extra_env,
                                   log_mode="w" if attempt == 0 else "a",
                                   telemetry_jsonl=telemetry_jsonl,
                                   rank_hang_timeout=rank_hang_timeout,
                                   attempt=attempt)
        for ev in events:
            if ev["kind"] in ("signal", "hang"):
                rank_failures += 1
                tel.counter("resilience/rank_failures")
                # events carry LOCAL proc indices; the counter gets the
                # global trainer id (they differ on multi-node launches)
                gid = envs[ev["rank"]]["PADDLE_TRAINER_ID"]
                tel.counter(f"resilience/rank_failures.rank{gid}")
        restartable = (rc == _preempt_exit_code()
                       or rc == _watchdog_exit_code()
                       or rc < 0)
        if not restartable or attempt >= max_restarts:
            if telemetry_jsonl and (attempt or rank_failures):
                # the launcher owns job_restarts/rank_failures — without
                # this flush they would never reach the JSONL the
                # workers (and telemetry_agg) share
                tel.to_jsonl(telemetry_jsonl, tag="launch")
            if rc < 0:
                # a signal-killed rank surfacing as the job's exit: the
                # shell convention is 128+signum (a raw negative would
                # wrap to a meaningless status through sys.exit)
                rc = 128 + (-rc)
            return rc
        tel.counter("resilience/job_restarts")
        if rc == _preempt_exit_code():
            # the original preemption-relaunch counter keeps its narrow
            # meaning (tools/check_resilience.py gates on it)
            tel.counter("resilience/restarts")
        why = {_preempt_exit_code(): "preempted",
               _watchdog_exit_code(): "hung/self-aborted"}.get(
                   rc, "rank failure")
        # date the death BEFORE the backoff sleep: heartbeat mtimes are
        # still fresh from the dead attempt and the stale-file sweep at
        # job start already removed any previous job's files
        pending_death_ts = _death_timestamp(log_dir, envs)
        sys.stderr.write(
            f"[launch] job {why} (exit {rc}); relaunching in "
            f"{delays[attempt]:.2f}s (attempt {attempt + 1}/{max_restarts})\n")
        time.sleep(delays[attempt])
        attempt += 1


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="paddle_tpu_torch.distributed.launch",
        description="Multi-process trainer launcher (fleet.launch parity)",
    )
    parser.add_argument("--nproc_per_node", type=int, default=1)
    parser.add_argument("--ips", type=str, default="127.0.0.1",
                        help="comma-separated host ips (same order everywhere)")
    parser.add_argument("--node_ip", type=str, default=None)
    parser.add_argument("--started_port", type=int, default=None)
    parser.add_argument("--log_dir", type=str, default="log")
    parser.add_argument("--backend", type=str, default=None,
                        choices=[None, "cpu", "gpu"])
    parser.add_argument("--max_restarts", type=int, default=None,
                        help="relaunch budget for recoverable job exits "
                             "(preempted 77, watchdog 113, signal-killed "
                             "or hung rank; default: "
                             "PADDLE_TPU_MAX_RESTARTS or 0)")
    parser.add_argument("--rank_hang_timeout", type=float, default=None,
                        help="seconds without a per-rank heartbeat-file "
                             "touch before the supervisor declares the "
                             "rank hung and tears the job down for "
                             "relaunch; must cover worker startup + first "
                             "compile (default: "
                             "PADDLE_TPU_RANK_HANG_TIMEOUT or 0 = off)")
    parser.add_argument("--restart_backoff", type=float, default=1.0,
                        help="base seconds of the deterministic "
                             "exponential relaunch backoff")
    parser.add_argument("--telemetry_jsonl", type=str, default=None,
                        help="JSONL sink for the launcher's own telemetry "
                             "(resilience/restarts) after a relaunched job "
                             "ends (default: PADDLE_TPU_TELEMETRY_JSONL)")
    parser.add_argument("training_script")
    parser.add_argument("script_args", nargs=argparse.REMAINDER)
    args = parser.parse_args(argv)
    rc = launch(args.training_script, args.script_args,
                nproc_per_node=args.nproc_per_node, ips=args.ips,
                node_ip=args.node_ip, base_port=args.started_port,
                log_dir=args.log_dir, backend=args.backend,
                max_restarts=args.max_restarts,
                restart_backoff=args.restart_backoff,
                telemetry_jsonl=args.telemetry_jsonl,
                rank_hang_timeout=args.rank_hang_timeout)
    sys.exit(rc)


if __name__ == "__main__":
    main()
