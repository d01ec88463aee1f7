"""One module per mix: the program entry that a cell's calls drive.

A mix names its ``LAYER`` (the profiler range around each call), whether its
pool holds received frames, source or a simulation's call indices (``POOL``:
"rx", "tx" or "sim"), and for receive mixes which frames the decoder must
recover (``RECOVERY``, a rule of :mod:`codec_bench.reference.recovery`) and
which symbols a frame delivers (``DELIVERS``: "first_k" or "all"). ``setup(config, device)`` builds what
the calls need; ``call(state, *inputs)`` is one call of the entry and
returns a :class:`codec_bench.port.Out`; ``failed(state, out)`` gives the
per-frame flags that reach the host after each call. A simulation mix's
``setup(config, device, traffic, seed)`` builds the program's step,
``call(state, call_index)`` returns its counters on the card and
``failed`` flattens them into the one tensor that reaches the host.
"""
