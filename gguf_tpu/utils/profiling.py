"""Tracing helpers: jax.profiler traces for timeline analysis and named
regions that show up in them.

    from gguf_tpu.utils.profiling import trace, annotate

    with trace("chiprun_out/trace"):         # open in xprof/tensorboard
        step(...)

    with annotate("decode-step"):            # named region in the timeline
        step(...)
"""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def trace(log_dir: str, create_perfetto_link: bool = False):
    """jax.profiler trace context; writes an xprof trace under log_dir."""
    import jax

    jax.profiler.start_trace(log_dir, create_perfetto_link=create_perfetto_link)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """Named region for the profiler timeline (TraceAnnotation)."""
    import jax

    return jax.profiler.TraceAnnotation(name)
