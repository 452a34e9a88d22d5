"""Stdlib observability plumbing copied from the JAX package: the
metrics registry, the JSONL event log, tracing (spans and W3C trace
contexts) and the HTTP server base.

As in the JAX package, an event emitted under a sampled trace carries
its trace id: the event log joins against the trace sink.
"""

from . import events, tracing

events.set_trace_provider(tracing.current_trace_id)
