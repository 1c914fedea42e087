"""Resilient training runtime — counterpart of ``paddle_tpu.resilience``,
detect-recover-continue over the engines' finite sweep and state
fingerprints:

- :class:`StepGuard` / :class:`RecoveryPolicy` (``guard.py``) — skip
  non-finite optimizer updates on the device, quarantine the offending
  batch, back off the AMP loss scale, roll back to a rolling last-good
  snapshot after K consecutive bad steps, give up after too many;
- :class:`Watchdog` (``watchdog.py``) — step-boundary heartbeat
  deadline; on a hang, dump all thread stacks + telemetry and abort with
  ``EXIT_WATCHDOG``;
- preemption (``preemption.py``) — SIGTERM/SIGINT → flag → emergency
  checkpoint → ``EXIT_PREEMPTED``;
- :func:`retry_call` (``retry.py``) — deterministic exponential backoff
  for checkpoint and staging I/O;
- :class:`FaultInjector` (``inject.py``) — deterministic, env/API-driven
  fault injection (NaN batch, SIGTERM, slow step, rank kill/hang, bit
  flip, request faults) so every path above stays exercised;
- :class:`IntegrityMonitor` / :func:`selftest` (``integrity.py``) —
  silent-corruption defense: cross-rank fingerprint divergence detection
  with healthy-replica repair, logical state fingerprints, and the
  golden-step self-test.

Not ported yet: ``cluster.py`` (``ClusterCheckpoint``,
``CollectiveGuard``), which waits for the multi-device port;
``CollectiveTimeout`` lives in ``distributed.communication``.
"""
from ..distributed.communication import CollectiveTimeout
from .guard import (RecoveryPolicy, StepGuard, finite_report,
                    load_quarantine, quarantine_batch, replay_quarantine)
from .inject import (FaultInjector, active_injector, clear_injector,
                     install_injector)
from .integrity import (IntegrityError, IntegrityMonitor, IntegrityPolicy,
                        corrupt_param_bit, fingerprint_digest,
                        golden_step_digest, host_state_fingerprint,
                        pick_healthy, selftest)
from .preemption import (EXIT_PREEMPTED, PreemptionHandler,
                         clear_preemption_request, exit_for_relaunch,
                         install_preemption_handler, preemption_requested,
                         uninstall_preemption_handler)
from .retry import backoff_delays, retry_call
from .watchdog import (EXIT_WATCHDOG, Watchdog, current_watchdog, heartbeat,
                       install_watchdog, uninstall_watchdog)

__all__ = [
    "CollectiveTimeout",
    "RecoveryPolicy", "StepGuard", "finite_report", "quarantine_batch",
    "load_quarantine", "replay_quarantine",
    "FaultInjector", "install_injector", "active_injector", "clear_injector",
    "IntegrityError", "IntegrityMonitor", "IntegrityPolicy",
    "corrupt_param_bit", "fingerprint_digest", "golden_step_digest",
    "host_state_fingerprint", "pick_healthy", "selftest",
    "EXIT_PREEMPTED", "PreemptionHandler", "install_preemption_handler",
    "uninstall_preemption_handler", "preemption_requested",
    "clear_preemption_request", "exit_for_relaunch",
    "backoff_delays", "retry_call",
    "EXIT_WATCHDOG", "Watchdog", "install_watchdog", "uninstall_watchdog",
    "heartbeat", "current_watchdog",
]
