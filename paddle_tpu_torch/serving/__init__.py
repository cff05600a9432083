"""Serving of the port: paged KV cache (with prefix caching and
copy-on-fork), continuous-batching scheduler, the n-gram draft proposer,
the `LLMEngine` and the OpenAI-compatible HTTP front door (`ApiServer`).

Serve over HTTP::

    engine = LLMEngine(model, EngineConfig(metrics_port=0))
    server = start_api_server(engine, port=8000)
    ...   # POST /v1/completions, /v1/chat/completions; GET /v1/models
    server.stop()
"""
from .api import ApiServer, api_error, parse_api_keys, start_api_server
from .engine import EngineConfig, LLMEngine
from .kv_cache import BlockAllocatorError, BlockKVCache, prefix_block_keys
from .scheduler import Request, SamplingParams, Scheduler, SchedulerOutput
from .spec import propose_ngram

__all__ = ["ApiServer", "EngineConfig", "LLMEngine", "BlockKVCache",
           "BlockAllocatorError", "Request", "SamplingParams", "Scheduler",
           "SchedulerOutput", "api_error", "parse_api_keys",
           "prefix_block_keys", "propose_ngram", "start_api_server"]
