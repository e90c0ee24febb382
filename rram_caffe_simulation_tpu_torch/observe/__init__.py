"""Training telemetry (counterpart of the reference package's observe/):
the record schema, the in-step counters, the host sinks, span tracing,
the profiler context and the crossbar health census."""
