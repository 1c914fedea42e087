"""Token-level serving runtime of the port (counterpart of
``paddle_tpu.inference.serving``, decode half)."""
from .admission import AdmissionQueue
from .decode import (DecodeScheduler, GenRequest, TokenServeConfig,
                     TokenServingEngine, dense_greedy_reference)
from .engine import ServeConfig, ServingEngine
from .kv_cache import KVCacheConfig, KVCachePool
from .loadgen import run_generation_streams, summarize_generation
from .request import Request, RequestStatus

__all__ = ["AdmissionQueue", "DecodeScheduler", "GenRequest",
           "TokenServeConfig", "TokenServingEngine", "dense_greedy_reference",
           "ServeConfig", "ServingEngine", "KVCacheConfig", "KVCachePool",
           "run_generation_streams", "summarize_generation", "Request",
           "RequestStatus"]
