"""Serving runtime of the port (counterpart of
``paddle_tpu.inference.serving``): the one-shot ``ServingEngine`` over an
``inference.Predictor`` and the token-level ``TokenServingEngine``, with
a bounded admission queue that sheds explicitly, deadlines at every
stage, drain on SIGTERM with exit 77, and every request terminal exactly
once.

    from paddle_tpu_torch.inference import Config, create_predictor
    from paddle_tpu_torch.inference.serving import ServeConfig, ServingEngine

    predictor = create_predictor(Config("model"))      # .pdexport
    engine = ServingEngine(predictor, ServeConfig(
        capacity=64, buckets=(1, 2, 4, 8), default_deadline_s=0.5))
    engine.install_preemption().start()
    req = engine.submit([x], deadline_s=0.2)           # per-sample input
    req.wait()
"""
from .admission import AdmissionQueue
from .decode import (DecodeScheduler, GenRequest, TokenServeConfig,
                     TokenServingEngine, dense_greedy_reference)
from .engine import ServeConfig, ServingEngine
from .kv_cache import KVCacheConfig, KVCachePool
from .loadgen import (run_generation_streams, run_load, run_streams,
                      summarize, summarize_generation)
from .request import Request, RequestStatus
from .scheduler import BatchScheduler

__all__ = [
    "AdmissionQueue", "BatchScheduler", "DecodeScheduler", "GenRequest",
    "KVCacheConfig", "KVCachePool", "Request", "RequestStatus",
    "ServeConfig", "ServingEngine", "TokenServeConfig",
    "TokenServingEngine", "dense_greedy_reference",
    "run_generation_streams", "run_load", "run_streams", "summarize",
    "summarize_generation",
]
