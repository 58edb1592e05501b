"""Data for the port: the trace half of `repro.data.pipeline`."""
