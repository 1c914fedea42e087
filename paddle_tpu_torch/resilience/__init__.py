"""Resilience (``paddle_tpu.resilience`` counterpart), kept to what
``hapi.Model.fit`` and the prefetcher use: the preemption flag and its
relaunch exit (``preemption``), and deterministic retries
(``retry``). ``StepGuard``, the watchdog, fault injection, cluster
checkpoints and the integrity monitor are not ported yet."""
from .preemption import (EXIT_PREEMPTED, PreemptionHandler,
                         clear_preemption_request, exit_for_relaunch,
                         install_preemption_handler, preemption_requested,
                         uninstall_preemption_handler)
from .retry import backoff_delays, retry_call

__all__ = ["EXIT_PREEMPTED", "PreemptionHandler",
           "install_preemption_handler", "uninstall_preemption_handler",
           "preemption_requested", "clear_preemption_request",
           "exit_for_relaunch", "backoff_delays", "retry_call"]
