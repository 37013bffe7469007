"""The drivers of the benchmark's windows, one module a driver, named by a
traffic file's ``driver`` (see ``benchmark/harness.py``)."""
