"""Spans and counters of the program.

`span(name)` marks a stage of the program as a torch.profiler
`record_function` range, so that it lands in the profiler's trace on the
same clock as the device operations it launched. With no profiler running
it is one flag read and a shared object that does nothing: a running
profiler is the only switch. The spans, by time on the caller's thread:

  ssq.ssq_cwt, ssq.ssq_stft    the public entry point, the whole call
  ssq.plan                     host planning and the upload of its arrays
  ssq.prep                     device work before a kernel: NaN screen,
                               cast, pad, filterbank sampling, rfft
  ssq.launch.<entry>           one call into a C entry point of csrc/
  ssq.pack                     the torch.complex packs of the outputs
  ssq.serve.request            TransformServer.__call__ / .batch
  ssq.serve.run                the transform of the padded requests
  ssq.serve.fetch              the trim and the copy to host memory

`COUNTS` counts, always: `launch.<entry>`, the calls into each C entry
point (one a call: kernel A's call runs its whole row-chunk loop, B's one
a bin range), `serve.samples` and `serve.bucket_samples`, the samples
TransformServer was handed and those it transformed after the pad to its
buckets, and of the server's fetch to host memory: `serve.fetch_bytes`,
the bytes of the arrays it hands back (on every device);
`serve.fetch_pinned`, the arrays copied from a CUDA device into
page-locked blocks; `serve.fetch_pinned_new`, those of them whose block
grew the pinned pool (the change of `torch.cuda.host_memory_stats()`'s
`num_host_alloc` over the fetch; 1 - new / pinned is the pool's reuse).
"""
from __future__ import annotations

import collections
import functools

import torch

__all__ = ["COUNTS", "count", "span", "spanned"]

COUNTS = collections.Counter()


def count(name: str, n: int = 1):
    COUNTS[name] += n


class _Off:
    """The span while no profiler runs."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def span(name: str):
    """A context manager: `record_function(name)` while a profiler runs,
    else one that does nothing."""
    if torch.autograd.profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _OFF


def spanned(name: str):
    """Decorator: each call of the function runs inside `span(name)`."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap
