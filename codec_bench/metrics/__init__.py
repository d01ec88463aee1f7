"""One reader per per-layer metric, found by file name (``<metric>.py``).

A reader defines ``UNIT`` and ``read(run)``, where ``run`` is the harness's
:class:`codec_bench.harness.RunView` of a traced run; it returns the
metric's value, or None where the run holds nothing for it to read, and the
harness then leaves the metric out of the result line.
"""
