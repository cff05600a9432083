"""Serving of the port: paged KV cache (with prefix caching and
copy-on-fork), continuous-batching scheduler, the n-gram draft proposer
and the `LLMEngine`."""
from .engine import EngineConfig, LLMEngine
from .kv_cache import BlockAllocatorError, BlockKVCache, prefix_block_keys
from .scheduler import Request, SamplingParams, Scheduler, SchedulerOutput
from .spec import propose_ngram

__all__ = ["EngineConfig", "LLMEngine", "BlockKVCache",
           "BlockAllocatorError", "Request", "SamplingParams", "Scheduler",
           "SchedulerOutput", "prefix_block_keys", "propose_ngram"]
