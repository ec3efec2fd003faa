"""The harness: inputs, the served window, the trace, the check."""
