"""Silent-corruption defense — detect-and-repair for finite-but-wrong;
counterpart of ``paddle_tpu.resilience.integrity``.

The rest of the resilience stack catches *loud* failures: NaN/Inf
(StepGuard), hung steps (the watchdog), torn checkpoint files (manifest
CRCs). Silent data corruption — a memory bit flip or a marginal card
producing finite-but-wrong numbers — lets data-parallel replicas quietly
diverge and commits the poison to checkpoints as truth. This module, in
the reference's layers:

1. **State fingerprints** — engines built with ``fingerprint_every=N``
   fold params + optimizer state + buffers into three scalars (an f32
   sum, an f32 abs-sum and a bit-exact 32-bit XOR word;
   ``core.sanitizer.tree_fingerprint``, the multi-tensor kernel of
   ``ops.tree_reduce`` on the card) and publish them
   (:func:`publish_fingerprint`: ``gauge/integrity/fingerprint.*`` as
   device scalars that are read only when the gauges are, and a bounded
   per-rank history).

2. **Cross-rank divergence detection + repair**
   (:class:`IntegrityMonitor`) — replicas running the same steps on the
   same data must agree bit for bit. Every fingerprint interval the
   monitor exchanges digests (``distributed.communication.
   all_gather_object``: a shared-filesystem rendezvous) and votes on a
   mismatch: the minority rank(s) take the full state of a healthy rank
   (ties trust the lowest rank — run >= 3 replicas for a true majority).
   If that repair cannot complete, the ladder falls back to the
   StepGuard snapshot (``snapshot_restore``). The reference's third rung,
   ``ClusterCheckpoint.restore()``, waits for ``resilience/cluster.py``:
   a monitor given a ``checkpoint`` raises ``NotImplementedError``.
   Counted in ``resilience/sdc_detected`` / ``resilience/sdc_repaired``
   (+ ``sdc_repaired.rank<i>`` naming the repaired rank).

3. **Logical state fingerprints** — :func:`host_state_fingerprint`, a
   CRC32 over a state tree's values (not a file's bytes), for
   checkpoints to record at commit and verify after load.

4. **Golden-step self-test** (:func:`selftest`) — a canned deterministic
   forward and backward compared bit-exactly against a stored golden
   digest, flagging a bad card or a miscompiling toolchain before it eats
   real work. Goldens are keyed by (torch version, CUDA version, device
   name) so a legitimate toolchain change re-records instead of raising.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import sys
import time
import zlib
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

import torch

from ..core.tree import flatten_with_path
from ..profiler.telemetry import get_telemetry
from .watchdog import EXIT_WATCHDOG, dump_stacks

__all__ = [
    "IntegrityError", "IntegrityPolicy", "IntegrityMonitor",
    "fingerprint_digest", "publish_fingerprint", "host_state_fingerprint",
    "pick_healthy", "corrupt_param_bit", "selftest", "golden_step_digest",
]

_ENV_GOLDEN = "PADDLE_TPU_GOLDEN_STEP"
_ENV_RENDEZVOUS = "PADDLE_TPU_INTEGRITY_DIR"
_ENV_FP_EVERY = "PADDLE_TPU_FINGERPRINT_EVERY"
_ENV_LAUNCH_ATTEMPT = "PADDLE_TPU_LAUNCH_ATTEMPT"


class IntegrityError(RuntimeError):
    """This process computed provably wrong numbers: the golden-step
    self-test disagreed with its stored digest, or a divergence repair
    could not complete. Continuing would train on (or serve) corrupt
    state."""


def _launch_attempt() -> int:
    """The launcher's attempt number (``PADDLE_TPU_LAUNCH_ATTEMPT``, 0):
    exchange keys carry it, so a relaunched job never reads a dead
    attempt's files."""
    try:
        return int(os.environ.get(_ENV_LAUNCH_ATTEMPT, "0") or 0)
    except ValueError:
        return 0


def _report_timeout(extra: str, tag: str) -> str:
    """A cross-rank wait timed out: count it first (so the dump's own
    telemetry and the JSONL sink see it), dump every thread's stack, flush
    the rank's JSONL sink. Returns the report; the caller exits."""
    tel = get_telemetry()
    tel.counter("resilience/collective_timeouts")
    report = dump_stacks(extra=extra)
    sink = os.environ.get("PADDLE_TPU_TELEMETRY_JSONL")
    if sink:
        try:
            tel.to_jsonl(sink, tag=tag)
        except Exception:
            pass  # the exit must not be blocked by a bad sink
    return report


def fingerprint_every_from_env(default: int = 0) -> int:
    try:
        return int(os.environ.get(_ENV_FP_EVERY, str(default)) or default)
    except ValueError:
        return default


# -- fingerprint plumbing (engine side) -------------------------------------

def publish_fingerprint(history, step: int, fp: Dict[str, Any],
                        every: int) -> None:
    """Engine hook after a fingerprinting step: publish the three
    scalars as deferred gauges (device scalars — read only when the
    gauges are, never a step sync) plus the interval, and append to the
    engine's bounded history deque."""
    tel = get_telemetry()
    tel.gauge("integrity/fingerprint_every", int(every))
    tel.gauge("integrity/fingerprint.sum", fp["sum"])
    tel.gauge("integrity/fingerprint.abs_sum", fp["abs_sum"])
    tel.gauge("integrity/fingerprint.xor", fp["xor"])
    history.append((int(step), fp))


def _host(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return np.asarray(v.detach().cpu().item())
    return np.asarray(v)


def fingerprint_digest(fp: Dict[str, Any]) -> str:
    """Canonical bit-exact wire form of one fingerprint: the raw bytes
    of sum (f32) + abs_sum (f32) + xor (u32), hex-encoded. String
    equality == bit-for-bit state agreement; a float tolerance here
    would re-admit exactly the silent class this defends against.
    Takes host values or the engines' device scalars."""
    return (_host(fp["sum"]).astype(np.float32).tobytes()
            + _host(fp["abs_sum"]).astype(np.float32).tobytes()
            + (_host(fp["xor"]).astype(np.int64) & 0xFFFFFFFF)
            .astype(np.uint32).tobytes()).hex()


# -- logical (host-side) state fingerprint ----------------------------------

def host_state_fingerprint(tree) -> Dict[str, int]:
    """Deterministic CRC32 over a state pytree's *values* (leaf paths,
    dtypes, shapes, raw bytes — in flatten order). Unlike the per-file
    CRCs a checkpoint manifest records, this is computed from the
    in-memory state BEFORE serialization and recomputed from the
    deserialized state after load — so corruption anywhere on the
    device→pickle→disk→unpickle→device path is caught even when the
    bytes-on-disk hash matches what was (already corrupt) written. Tensor
    leaves are read to the host; a bf16 one by its raw bits."""
    crc = 0
    leaves = 0
    nbytes = 0
    for path, leaf in flatten_with_path(tree):
        dtype, a = _raw_leaf(leaf)
        crc = zlib.crc32(path.encode(), crc)
        crc = zlib.crc32(f"{dtype}|{a.shape}".encode(), crc)
        crc = zlib.crc32(np.ascontiguousarray(a).tobytes(), crc)
        leaves += 1
        nbytes += a.nbytes
    return {"crc32": crc & 0xFFFFFFFF, "leaves": leaves, "bytes": nbytes}


def _raw_leaf(leaf) -> Tuple[str, np.ndarray]:
    """``(dtype name, host array of the raw values)``."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return "bfloat16", t.view(torch.int16).numpy()
        a = t.numpy()
        return str(a.dtype), a
    a = np.asarray(leaf)
    return str(a.dtype), a


# -- majority vote -----------------------------------------------------------

def pick_healthy(entries: Sequence[Tuple[int, str]]
                 ) -> Tuple[List[int], List[int]]:
    """Majority vote over ``(rank, digest)`` pairs: the largest group of
    bit-identical fingerprints is presumed healthy, everyone else is the
    corrupt minority. Ties (e.g. a 2-replica world, 1 vs 1) trust the
    group containing the LOWEST rank — a documented presumption, not
    knowledge; deployments that need a true majority run >= 3 replicas.
    Returns ``(healthy_ranks, minority_ranks)``, both sorted."""
    groups: Dict[str, List[int]] = {}
    for rank, digest in entries:
        groups.setdefault(digest, []).append(int(rank))
    best = max(groups.values(), key=lambda rs: (len(rs), -min(rs)))
    healthy = sorted(best)
    minority = sorted(r for rs in groups.values() for r in rs
                      if rs is not best)
    return healthy, minority


# -- deterministic in-device corruption (fault injection) --------------------

def corrupt_param_bit(engine, name: Optional[str] = None, index: int = 0,
                      bit: int = 1) -> str:
    """The ``bitflip_param@step:rank`` fault: flip ONE low-mantissa bit
    of one element of one parameter, in place in the engine's device
    state (the layer's parameter: in master mode its resident cast, as
    the reference flips its resident parameter). The damage is
    deliberately *silent* — a tiny, finite value change the NaN/Inf sweep
    can never see — so only the bit-exact fingerprint divergence path can
    catch it. Returns the parameter name."""
    named = dict(engine._layer.named_parameters())
    if name is None:
        floats = sorted(n for n, p in named.items()
                        if p.is_floating_point())
        if not floats:
            raise ValueError("engine has no floating parameter to corrupt")
        name = floats[0]
    p = named[name].detach()
    bits = 8 * p.element_size()
    view = {8: torch.uint8, 16: torch.int16, 32: torch.int32,
            64: torch.int64}[bits]
    raw = p.view(-1).view(view)
    mask = 1 << int(bit)
    if view != torch.uint8 and mask >= 1 << (bits - 1):
        mask -= 1 << bits  # the sign bit of a signed view
    i = int(index) % raw.numel()
    with torch.no_grad():
        raw[i] = raw[i] ^ torch.tensor(mask, dtype=view, device=raw.device)
    return name


# -- golden-step self-test ---------------------------------------------------

def _golden_key(device) -> str:
    dev = torch.device(device)
    kind = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else dev.type)
    return f"torch-{torch.__version__}|cuda-{torch.version.cuda}|{kind}"


def golden_step_digest(device=None) -> str:
    """Run the canned deterministic step — a tiny fixed-weight MLP
    forward + backward on ``device`` (default ``"cuda"``), inputs and
    weights from integer ramps (no RNG, no environment dependence, TF32
    off) — and digest every output bit. Same toolchain + same healthy
    card ⇒ same digest, always; a different digest inside one
    environment key means the hardware or the compiler is producing
    wrong numbers."""
    from ..core.place import resolve_device

    dev = resolve_device(device)
    f32 = dict(dtype=torch.float32, device=dev)
    w1 = (((torch.arange(64 * 32, **f32) % 13) - 6.0).reshape(64, 32)
          * 0.05).requires_grad_()
    w2 = (((torch.arange(32 * 8, **f32) % 11) - 5.0).reshape(32, 8)
          * 0.07).requires_grad_()
    x = torch.sin(torch.arange(16 * 64, **f32) * 0.01).reshape(16, 64)
    y = torch.cos(torch.arange(16 * 8, **f32) * 0.02).reshape(16, 8)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        loss = ((torch.tanh(x @ w1) @ w2 - y) ** 2).mean()
        g1, g2 = torch.autograd.grad(loss, (w1, w2))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    h = hashlib.sha256()
    for out in (loss, g1, g2):
        h.update(out.detach().cpu().numpy().astype(np.float32).tobytes())
    return h.hexdigest()


def selftest(path: Optional[str] = None, record: bool = True,
             raise_on_mismatch: bool = True, device=None) -> Dict[str, Any]:
    """Golden-step self-test: compare this process's canned-step digest
    against the golden stored at ``path`` (default
    ``$PADDLE_TPU_GOLDEN_STEP``) for this environment key. No entry yet
    and ``record=True`` ⇒ record it (the startup run establishes the
    golden; every relaunch re-verifies). Mismatch ⇒ the chip or the
    toolchain is computing wrong numbers: ``resilience/selftest_failures``
    is bumped and :class:`IntegrityError` raised (or the result returned
    with ``ok=False`` when ``raise_on_mismatch=False``). The step runs on
    ``device`` (default ``"cuda"``).

    Returns ``{"ok", "recorded", "key", "digest", "golden", "path"}``.
    """
    tel = get_telemetry()
    tel.counter("resilience/selftest_runs")
    path = path or os.environ.get(_ENV_GOLDEN)
    key = _golden_key(device if device is not None else "cuda")
    digest = golden_step_digest(device)
    result = {"ok": True, "recorded": False, "key": key, "digest": digest,
              "golden": None, "path": path}
    if not path:
        return result  # nowhere to compare against: a smoke run
    goldens: Dict[str, str] = {}
    if os.path.exists(path):
        try:
            with open(path) as f:
                goldens = json.load(f)
        except (OSError, ValueError):
            goldens = {}  # unreadable golden: re-record below
    golden = goldens.get(key)
    result["golden"] = golden
    if golden is None:
        if record:
            from ..framework.io import atomic_replace

            goldens[key] = digest

            def _write(tmp):
                with open(tmp, "w") as f:
                    json.dump(goldens, f, indent=1, sort_keys=True)

            atomic_replace(path, _write)
            result["recorded"] = True
        return result
    if golden != digest:
        tel.counter("resilience/selftest_failures")
        result["ok"] = False
        if raise_on_mismatch:
            raise IntegrityError(
                f"golden-step self-test FAILED for {key}: canned step "
                f"digest {digest[:16]}… != stored golden {golden[:16]}… "
                f"({path}). This chip or toolchain is computing wrong "
                f"numbers — do not train through it. (A legitimate "
                f"toolchain upgrade changes the environment key and "
                f"re-records instead of landing here.)")
    return result


# -- the cross-rank monitor --------------------------------------------------

@dataclasses.dataclass
class IntegrityPolicy:
    """Knobs for :class:`IntegrityMonitor`.

    ``rendezvous_dir``: shared filesystem directory for the fingerprint
    exchange + repair payloads (defaults to ``$PADDLE_TPU_INTEGRITY_DIR``;
    the only transport until ``torch.distributed`` is ported). ``timeout_s``
    bounds every cross-rank wait (a dead peer must become a restartable
    exit, not a forever-block); ``hang_exit=False`` raises
    ``CollectiveTimeout`` instead (tests, embedders). ``golden_path``
    runs :func:`selftest` at monitor construction."""

    rendezvous_dir: Optional[str] = None
    timeout_s: float = 120.0
    poll_s: float = 0.05
    hang_exit: bool = True
    golden_path: Optional[str] = None
    # give up (IntegrityError) when any ONE rank is repaired more than
    # this many times — one cosmic ray per chip is tolerable, repetition
    # on the same chip is hardware to replace
    max_repairs: int = 8


class IntegrityMonitor:
    """Cross-rank divergence detection + healthy-replica repair over an
    engine built with ``fingerprint_every=N``.

    Drive it from :class:`StepGuard` (``StepGuard(step, policy,
    integrity=monitor)``) or call :meth:`after_step` at step boundaries
    yourself. Each new engine fingerprint is exchanged across ranks
    (``communication.all_gather_object``, a shared-filesystem
    rendezvous); on mismatch the majority (ties: lowest rank) is presumed
    healthy and the minority restores the healthy source's full state
    (params + buffers + optimizer state), falling back to the local
    StepGuard snapshot when the healthy payload cannot be read. The
    cluster-checkpoint rung is not ported: ``checkpoint`` raises.
    ``last_event`` keeps the most recent detection for gates:
    ``{"step", "healthy", "minority", "source", "repaired", "via"}``.
    """

    def __init__(self, engine, rank: Optional[int] = None,
                 world_size: Optional[int] = None,
                 policy: Optional[IntegrityPolicy] = None,
                 snapshot_restore: Optional[Callable[[], bool]] = None,
                 checkpoint=None):
        from ..distributed.communication import launch_world_rank

        if checkpoint is not None:
            raise NotImplementedError(
                "IntegrityMonitor(checkpoint=...): the ClusterCheckpoint "
                "rung of the repair ladder waits for the port of "
                "resilience/cluster.py")
        self._engine = engine
        self.policy = policy or IntegrityPolicy()
        env_world, env_rank = launch_world_rank()
        self.rank = env_rank if rank is None else int(rank)
        self.world_size = env_world if world_size is None else int(world_size)
        self._snapshot_restore = snapshot_restore
        self._checkpoint = checkpoint
        self._last_seen_step: Optional[int] = None
        self._repairs_by_rank: Dict[int, int] = {}
        self.last_event: Optional[Dict[str, Any]] = None
        if self.policy.rendezvous_dir is None:
            self.policy.rendezvous_dir = os.environ.get(_ENV_RENDEZVOUS)
        if self.policy.golden_path or os.environ.get(_ENV_GOLDEN):
            selftest(self.policy.golden_path,
                     device=getattr(engine, "_device", None))
        if not getattr(engine, "fingerprint_every", 0):
            raise ValueError(
                "IntegrityMonitor needs an engine built with "
                "fingerprint_every > 0 (TrainStep/ParallelTrainStep ctor "
                "arg) — without state fingerprints there is nothing to "
                "compare across ranks")

    # -- step-boundary hook -------------------------------------------------
    def after_step(self, step_count: Optional[int] = None) -> bool:
        """Consume the engine's newest fingerprint, if any; exchange +
        compare across ranks on a new one. Returns True when a
        divergence was detected at this boundary. Newness is judged from
        the history's step label alone — the scalar D2H fetch
        (``last_fingerprint``) is paid only once per interval, never on
        the 99 off-interval boundaries."""
        hist = self._engine.fingerprint_history()
        if not hist or hist[-1][0] == self._last_seen_step:
            return False  # no new fingerprint since the last boundary
        rec = self._engine.last_fingerprint()
        step, fp = rec
        self._last_seen_step = step
        if self.world_size <= 1:
            return False
        from ..distributed.communication import CollectiveTimeout

        try:
            return self._check(step, fp)
        except CollectiveTimeout as e:
            if not self.policy.hang_exit:
                raise
            report = _report_timeout(
                extra=f"{e}; exiting {EXIT_WATCHDOG} for relaunch",
                tag="integrity_timeout")
            sys.stderr.write(report + "\n")
            sys.exit(EXIT_WATCHDOG)

    # -- internals ----------------------------------------------------------
    def _check(self, step: int, fp) -> bool:
        from ..distributed.communication import all_gather_object

        digest = fingerprint_digest(fp)
        # keys carry the launch attempt: a relaunched job (restartable
        # exit mid-repair) re-reaches the same step numbers, and a stale
        # attempt's fp/repair files satisfying the new attempt's waits
        # would compare live state against a dead run
        attempt = _launch_attempt()
        gathered = all_gather_object(
            {"rank": self.rank, "step": int(step), "fp": digest},
            key=f"integrity-fp-a{attempt}-{int(step)}",
            rendezvous_dir=self.policy.rendezvous_dir,
            timeout_s=self.policy.timeout_s, poll_s=self.policy.poll_s,
            rank=self.rank, world_size=self.world_size,
            cleanup_prev=True)
        entries = [(int(g["rank"]), str(g["fp"])) for g in gathered]
        if len({d for _, d in entries}) <= 1:
            return False  # bit-for-bit agreement — the common case
        tel = get_telemetry()
        tel.counter("resilience/sdc_detected")
        healthy, minority = pick_healthy(entries)
        source = healthy[0]
        event = {"step": int(step), "healthy": healthy,
                 "minority": minority, "source": source,
                 "repaired": False, "via": None}
        self.last_event = event
        sys.stderr.write(
            f"[integrity] rank {self.rank}: state fingerprints DIVERGED at "
            f"step {step}: minority rank(s) {minority} vs healthy "
            f"{healthy} — repairing from rank {source}\n")
        self._repair(step, source, minority, event)
        if event["repaired"]:
            # counted only for repairs that actually happened — a
            # healthy rank whose publish failed must not fabricate
            # sdc_repaired (and phantom SUSPECT-CHIP findings) for a
            # minority peer it never reached
            tel.counter("resilience/sdc_repaired")
            for m in minority:
                tel.counter(f"resilience/sdc_repaired.rank{m}")
            # give-up is per REPAIRED RANK (the documented contract):
            # one cosmic ray each on N different chips is fine; the
            # same chip repaired past the budget is hardware to replace.
            # Only actual repairs count — a failed publish must not
            # charge the budget of a rank that was never touched.
            for m in minority:
                n = self._repairs_by_rank[m] = \
                    self._repairs_by_rank.get(m, 0) + 1
                if n > self.policy.max_repairs:
                    raise IntegrityError(
                        f"rank {self.rank}: rank {m} needed {n} "
                        f"silent-corruption repairs in one run — that "
                        f"replica has a persistently bad chip; replace "
                        f"the hardware instead of laundering its state")
        return True

    def _repair(self, step: int, source: int, minority: List[int],
                event: Dict[str, Any]) -> None:
        """Repair ladder: healthy-replica state publish → local StepGuard
        snapshot. Every rank participates (the publish is
        collective-shaped); only minority ranks install."""
        try:
            self._repair_from_source(step, source, minority)
            event["repaired"] = True
            event["via"] = "healthy_replica"
            return
        except Exception as e:  # noqa: BLE001 — ladder, not a crash
            sys.stderr.write(
                f"[integrity] rank {self.rank}: healthy-replica repair "
                f"failed ({e}); falling back\n")
        if self.rank not in minority:
            # a healthy rank has nothing to restore, but its publish
            # FAILED — it must not claim a repair it cannot know
            # happened (the minority may have died mid-restore); it
            # carries correct state and continues, leaving the peer's
            # fate to the supervisor/timeout machinery
            event["via"] = "publish_failed"
            return
        if self._snapshot_restore is not None:
            try:
                if self._snapshot_restore() is not False:
                    event["repaired"] = True
                    event["via"] = "snapshot"
                    return
            except Exception as e:  # noqa: BLE001
                sys.stderr.write(
                    f"[integrity] rank {self.rank}: snapshot restore "
                    f"failed ({e})\n")
        raise IntegrityError(
            f"rank {self.rank}: state diverged at step {step} and no "
            f"repair source succeeded (healthy replica, snapshot) — "
            f"refusing to continue on corrupt state")

    def _repair_from_source(self, step: int, source: int,
                            minority: List[int]) -> None:
        """Publish the healthy source's full engine state to the corrupt
        minority over the shared filesystem: an atomic, CRC-verified
        payload (``framework.io.save``) + per-minority done-acks so every
        rank leaves this interval in lockstep."""
        root = self.policy.rendezvous_dir
        if not root:
            raise IntegrityError(
                "no repair transport: IntegrityPolicy.rendezvous_dir "
                "(PADDLE_TPU_INTEGRITY_DIR) is unset")
        from ..framework import io as _io

        # attempt-scoped like the fp exchange: a relaunched attempt
        # re-reaching this step must never restore the dead attempt's
        # payload on presence alone
        payload_path = os.path.join(
            root, f"repair-a{_launch_attempt()}-step{int(step)}.ckpt")
        if self.rank == source:
            host = {"state": self._engine.snapshot_state(),
                    "step": int(step), "source": int(source)}
            _io.save(host, payload_path)  # atomic: presence == complete
        if self.rank in minority:
            self._wait_for(lambda: os.path.exists(payload_path),
                           f"healthy rank {source}'s repair payload for "
                           f"step {step}")
            payload = _io.load(payload_path)
            self._engine.restore_state(payload["state"])
            done = payload_path + f".done.rank{self.rank}"
            _io.atomic_replace(done, lambda tmp: open(tmp, "w").close())

        def _all_done() -> bool:
            return all(os.path.exists(payload_path + f".done.rank{m}")
                       for m in minority)

        self._wait_for(_all_done,
                       f"minority rank(s) {minority} to ack the step-{step} "
                       f"repair")

    def _wait_for(self, predicate, what: str) -> None:
        from ..distributed.communication import CollectiveTimeout

        deadline = time.monotonic() + self.policy.timeout_s
        while not predicate():
            if time.monotonic() > deadline:
                raise CollectiveTimeout(
                    f"rank {self.rank}: gave up waiting for {what} after "
                    f"{self.policy.timeout_s:.1f}s — a peer rank is dead "
                    f"or hung")
            time.sleep(self.policy.poll_s)
