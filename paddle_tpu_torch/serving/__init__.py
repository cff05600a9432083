"""Serving of the port: paged KV cache, continuous-batching scheduler and
the `LLMEngine`."""
from .engine import EngineConfig, LLMEngine
from .kv_cache import BlockAllocatorError, BlockKVCache
from .scheduler import Request, SamplingParams, Scheduler, SchedulerOutput

__all__ = ["EngineConfig", "LLMEngine", "BlockKVCache",
           "BlockAllocatorError", "Request", "SamplingParams", "Scheduler",
           "SchedulerOutput"]
