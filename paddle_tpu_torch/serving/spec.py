"""n-gram / prompt-lookup draft proposal for speculative decoding — a copy
of `paddle_tpu/serving/spec.py` (stdlib only).

The proposer guesses the next k tokens of a row from the row's OWN
history: take the longest recent n-gram (down to ``ngram_min`` tokens)
ending at the current position, find its most recent PREVIOUS occurrence
in the context, and propose the tokens that followed it.  On repetitive
text the continuation after a repeated n-gram is often the same, so
verification accepts several tokens per step.

Drafts are free to be wrong: verification scores them against the real
model in one fixed-shape multi-token call and accepts only the prefix the
model would have emitted anyway (token-identical greedy decoding).
"""
from __future__ import annotations

__all__ = ["propose_ngram"]


def propose_ngram(context, k, ngram_max=3, ngram_min=1, window=1024) -> list:
    """Up to `k` draft tokens continuing `context` (a list of int token
    ids), from the most recent previous occurrence of the longest
    matching suffix n-gram; [] when nothing matches.

    Only the trailing `window` tokens are searched — proposal runs on
    the host inside the decode loop, so the scan must stay O(window)
    per row regardless of context length.
    """
    n = len(context)
    if n < 2 or k <= 0:
        return []
    lo = max(0, n - int(window))
    for size in range(min(int(ngram_max), n - 1), int(ngram_min) - 1, -1):
        tail = context[n - size:]
        # most recent prior occurrence: scan candidate start positions
        # right-to-left, excluding the suffix occurrence itself
        for start in range(n - size - 1, lo - 1, -1):
            if context[start:start + size] == tail:
                follow = context[start + size:start + size + int(k)]
                if follow:
                    return [int(t) for t in follow]
        # no occurrence at this size: a shorter n-gram may still match
    return []
