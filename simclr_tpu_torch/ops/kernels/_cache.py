"""A cache for the tensors that the kernel wrappers build lazily (index
tables and constants, one per device), which a trace must not fill.

``torch.export`` and ``torch.compile`` run a wrapper on fake tensors, and a
tensor that the wrapper builds there is a fake tensor of that trace: kept
in a ``functools.cache``, it would be handed to every later real call.
``trace_safe_cache`` keeps only what is built outside a trace; within one,
a cached tensor is used as it is (the trace holds it as a constant) and a
missing one is built anew each time.
"""

from __future__ import annotations

import functools

import torch


def trace_safe_cache(build):
    """``functools.cache`` of ``build(*args)``, except for results built
    while ``torch.compiler.is_compiling()``, which are returned and not
    kept."""
    store = {}

    @functools.wraps(build)
    def cached(*args):
        value = store.get(args)
        if value is None:
            value = build(*args)
            if not torch.compiler.is_compiling():
                store[args] = value
        return value

    cached.cache_clear = store.clear
    return cached
