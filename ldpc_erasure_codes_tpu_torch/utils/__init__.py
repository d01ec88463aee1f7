"""Host-side utilities: device selection, oracles, golden vectors, native
I/O, streaming, profiling, and the CLI.

Submodules (the JAX package's ``utils/__init__.py`` exports ``native``,
``profiling`` and ``streaming`` the same way):

* ``device`` — the card: selection, memory sizes, name and power limit.
* ``oracle`` — NumPy MATLAB-semantics reference implementations.
* ``verify`` — the checks and the PASSED/FAILED battery.
* ``golden`` — the MATLAB<->accelerator golden-vector protocol.
* ``native`` — ctypes loader for the C++ I/O library (vector files, symbol
  expansion, bit-plane transpose, Vlist headers, the block reassembler and
  the UDP burst calls).
* ``streaming`` — FEC packet block assembly (reorder buffer -> decode
  batches); ``vita`` — VITA-49 framing; ``udp`` — the UDP datapath.
* ``profiling`` — timing/throughput helpers, a ``torch.profiler`` wrapper,
  the decoders' spans and counters, and the host-sync locator.
* ``cli`` — the command-line interface (``python -m
  ldpc_erasure_codes_tpu_torch.utils.cli``).
"""

from ldpc_erasure_codes_tpu_torch.utils import native, profiling, streaming

__all__ = ["native", "profiling", "streaming"]
