"""Launch and cluster helpers — counterpart of
``paddle_tpu.distributed.utils`` (Paddle's ``distributed/utils.py``)."""
from __future__ import annotations

from .launch import get_cluster_env  # noqa: F401

__all__ = ["get_host_name_ip", "get_cluster_from_args", "get_gpus"]


def get_host_name_ip():
    import socket

    try:
        host = socket.gethostname()
        return host, socket.gethostbyname(socket.getfqdn(host))
    except OSError:
        return None


def get_gpus(selected_gpus=None):
    """The card indices to use: ``selected_gpus`` (a list or a
    comma-separated string), else every card of this host."""
    if selected_gpus:
        return [int(g) for g in (selected_gpus.split(",")
                                 if isinstance(selected_gpus, str)
                                 else selected_gpus)]
    import torch

    return list(range(torch.cuda.device_count()))


def get_cluster_from_args(args, selected_gpus=None):
    ips = getattr(args, "cluster_node_ips", None) or "127.0.0.1"
    ips = ips.split(",") if isinstance(ips, str) else ips
    ip = getattr(args, "node_ip", None) or ips[0]
    port = int(getattr(args, "started_port", None) or 6170)
    devices = get_gpus(selected_gpus)
    return get_cluster_env(ip, ips, len(devices), port)
