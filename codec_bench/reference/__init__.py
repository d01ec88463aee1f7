"""The benchmark's plain reference, in NumPy and plain PyTorch.

It imports nothing of the program and takes nothing the program made. The
(2040, 1530) parity-check matrix comes from the frozen copy of the code file
beside this module, through its own reader; RS(255, 192) is built from the
frozen GF(256) tables (``gf256.json``). From those alone it works out each
code's systematic encoder (:class:`.codes.Code`) and, for a loss mask, which
frames a decoder must recover (:mod:`.recovery`).
"""
