"""Golden-vector protocol: the MATLAB <-> accelerator integration test.

Counterpart of ``ldpc_erasure_codes_tpu/utils/golden.py`` (:1-392). The
oracle side ("MATLAB side") writes encoder-input / encoder-output /
decoder-noisy-input / decoder-output text vector files; the accelerator
side reads them, runs the port's encoder and decoders on ``device`` (the
CUDA kernels on the card, their plain versions on the CPU) and compares
bit-exactly, reporting PASSED/FAILED (the reference's
Matlab/data_gen_for_OpenCL_erasure_codec.m:53-91,
OpenCL/host/src/main.cpp:274-305,413-425).

The generators run the port's NumPy oracle (``utils/oracle.py``), GF(256)
tables and RS generator, drawing from ``np.random.default_rng(seed)`` in
the JAX package's order, so both packages write the same files for the
same code and seed.

The LDPC verifiers decode with ``hybrid_decode_escalated`` (JAX's
``hybrid.py:225-308``, the same defaults: 10 sweeps, a 128-symbol GE
bucket), where JAX's call ``hybrid_decode``: the oracle's hybrid has no
bucket, so a set may hold frames whose residual outgrows 128, which the
plain call fails for bucket size alone. The CLI's default GF(256) set
(``golden --gf 256 --code n2040_k1530_gf256``, PER .2, seed 0) is one:
after 10 Jacobi sweeps its frames keep 315, 225, 179 and 0 erasures, and
JAX's own ``verify_golden_nb`` reports decode=FAILED on it. Escalated, the
bucket costs time and never a result: every frame must still equal the
oracle's.

File format: one decimal uint16 per line; a 0 in the decoder input marks an
erasure (in-band, main.cpp:380-387 — so golden sources are drawn nonzero);
each value expands to a wide symbol by replication across all 16-bit lanes.
"""

from __future__ import annotations

import dataclasses
import os
import pathlib

import numpy as np
import torch

from ldpc_erasure_codes_tpu_torch.codes.io import LDPCCode
from ldpc_erasure_codes_tpu_torch.utils import native, oracle

ENC_IN = "encoder_input.txt"
ENC_OUT = "encoder_output.txt"
DEC_IN = "decoder_noisy_input.txt"
DEC_OUT = "decoder_output.txt"
# NB/RS extension: GF(256) symbols are bytes and zero is a LEGAL symbol
# value, so in-band zero-as-erasure (main.cpp:380-387) cannot mark erasures;
# the non-binary protocol adds an explicit 0/1 mask file instead.
DEC_MASK = "decoder_erasure_mask.txt"


@dataclasses.dataclass
class GoldenSet:
    """One golden frame set on disk (frames concatenated per file)."""

    directory: pathlib.Path
    code_name: str
    n: int
    k: int
    frames: int


def _write(d: pathlib.Path, files: dict[str, list[np.ndarray]]) -> None:
    for name, frames in files.items():
        native.write_vector_file(d / name, np.concatenate(frames))


def generate_golden(
    code: LDPCCode,
    directory: str | os.PathLike,
    *,
    frames: int = 4,
    per: float = 0.2,
    seed: int = 0,
) -> GoldenSet:
    """Oracle side: draw nonzero 16-bit sources, encode with the NumPy
    MATLAB-semantics encoder, erase i.i.d., decode with the oracle hybrid
    decoder, and write all four vector files."""
    if code.gf_order != 2:
        raise ValueError("golden protocol covers binary codes")
    d = pathlib.Path(directory)
    d.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    enc_in, enc_out, dec_in, dec_out = [], [], [], []
    attempts, max_attempts = 0, 50 * frames
    planes = np.arange(16, dtype=np.uint16)
    while len(enc_in) < frames:
        if attempts >= max_attempts:
            raise RuntimeError(
                f"generate_golden: only {len(enc_in)}/{frames} decodable frames after "
                f"{attempts} draws at per={per} — lower the erasure rate"
            )
        attempts += 1
        src = rng.integers(1, 1 << 16, size=code.k, dtype=np.uint16)
        # Bit-plane encode through the oracle: replication means every bit
        # plane of a symbol is either the value's bit or zero, so encoding
        # the 16 planes independently equals encoding the replicated symbol.
        src_bits = ((src[None, :] >> planes[:, None]) & 1).astype(np.uint8)
        cw_bits = np.stack([oracle.encode_triangular(code, p) for p in src_bits])  # (16, n)
        cw = np.bitwise_or.reduce(cw_bits.astype(np.uint16) << planes[:, None], axis=0)
        erased = rng.random(code.n) < per
        noisy = np.where(erased, 0, cw).astype(np.uint16)
        # Oracle decode of the erasure pattern on every bit plane; a frame
        # any plane cannot decode is re-drawn, to keep golden sets decodable.
        dec_bits, ok_all = [], True
        for b in range(16):
            recv = np.where(erased, oracle.ERASED, cw_bits[b].astype(np.int64))
            out, _, singular = oracle.hybrid_ml_decode(code, recv, peel_iters=10)
            ok_all &= not (singular or np.any(out < 0))
            dec_bits.append(np.maximum(out, 0).astype(np.uint16))
        if not ok_all:
            continue
        enc_in.append(src)
        enc_out.append(cw)
        dec_in.append(noisy)
        dec_out.append(np.bitwise_or.reduce(np.stack(dec_bits) << planes[:, None], axis=0))
    _write(d, {ENC_IN: enc_in, ENC_OUT: enc_out, DEC_IN: dec_in, DEC_OUT: dec_out})
    return GoldenSet(d, code.name, code.n, code.k, len(enc_in))


def generate_golden_nb(
    code: LDPCCode,
    directory: str | os.PathLike,
    *,
    frames: int = 4,
    per: float = 0.15,
    seed: int = 0,
) -> GoldenSet:
    """Oracle side, GF(256) tier: byte symbols through the NumPy NB
    triangular encoder and NB hybrid decoder
    (Matlab/ErasureCodes_NonBinaryLDPCSim.m:172-182,
    My_LDPC_HybridML_NonBinary_Erasure_Decoder.m). Writes the four vector
    files plus the explicit erasure-mask file (see DEC_MASK note)."""
    if code.gf_order != 256:
        raise ValueError("generate_golden_nb needs a GF(256) code")
    d = pathlib.Path(directory)
    d.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    enc_in, enc_out, dec_in, dec_mask, dec_out = [], [], [], [], []
    attempts, max_attempts = 0, 50 * frames
    while len(enc_in) < frames:
        if attempts >= max_attempts:
            raise RuntimeError(
                f"generate_golden_nb: only {len(enc_in)}/{frames} decodable frames after "
                f"{attempts} draws at per={per}"
            )
        attempts += 1
        src = rng.integers(1, 256, size=code.k, dtype=np.uint16)
        cw = oracle.encode_triangular_nb(code, src.astype(np.int64))
        erased = rng.random(code.n) < per
        out, _iters, singular = oracle.hybrid_ml_decode_nb(
            code, np.where(erased, oracle.ERASED, cw), peel_iters=10
        )
        if singular or np.any(out < 0):
            continue
        enc_in.append(src)
        enc_out.append(cw.astype(np.uint16))
        dec_in.append(np.where(erased, 0, cw).astype(np.uint16))
        dec_mask.append(erased.astype(np.uint16))
        dec_out.append(out.astype(np.uint16))
    _write(d, {ENC_IN: enc_in, ENC_OUT: enc_out, DEC_IN: dec_in, DEC_MASK: dec_mask,
               DEC_OUT: dec_out})
    return GoldenSet(d, code.name, code.n, code.k, len(enc_in))


def generate_golden_rs(
    n: int,
    k: int,
    directory: str | os.PathLike,
    *,
    frames: int = 4,
    per: float = 0.2,
    seed: int = 0,
) -> GoldenSet:
    """Oracle side, RS tier: systematic Vandermonde encode + the faithful
    table-optimized MATLAB decoder (oracle.rs_decode,
    My_RS_Decode_Optimize_With_GFTables.m:15-119)."""
    from ldpc_erasure_codes_tpu_torch.gf.tables import gf_matmul_np
    from ldpc_erasure_codes_tpu_torch.rs.code import rs_systematic_generator

    d = pathlib.Path(directory)
    d.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    g = rs_systematic_generator(n, k)
    enc_in, enc_out, dec_in, dec_mask, dec_out = [], [], [], [], []
    attempts, max_attempts = 0, 50 * frames
    while len(enc_in) < frames:
        if attempts >= max_attempts:
            raise RuntimeError(
                f"generate_golden_rs: only {len(enc_in)}/{frames} decodable frames after "
                f"{attempts} draws at per={per}"
            )
        attempts += 1
        src = rng.integers(1, 256, size=k, dtype=np.uint8)
        cw = gf_matmul_np(src[None, :], g)[0]
        erased = rng.random(n) < per
        if int(erased.sum()) > n - k:
            continue  # beyond the MDS bound — undecodable by any decoder
        recv_ind = np.nonzero(~erased)[0][:k]
        msg = oracle.rs_decode(recv_ind, cw[recv_ind].astype(np.int64), g, k)
        full = gf_matmul_np(np.asarray(msg, dtype=np.uint8)[None, :], g)[0]
        enc_in.append(src.astype(np.uint16))
        enc_out.append(cw.astype(np.uint16))
        dec_in.append(np.where(erased, 0, cw).astype(np.uint16))
        dec_mask.append(erased.astype(np.uint16))
        dec_out.append(full.astype(np.uint16))
    _write(d, {ENC_IN: enc_in, ENC_OUT: enc_out, DEC_IN: dec_in, DEC_MASK: dec_mask,
               DEC_OUT: dec_out})
    return GoldenSet(d, f"rs_{n}_{k}", n, k, len(enc_in))


def _read(d: pathlib.Path, n: int, k: int, nb: bool) -> tuple[np.ndarray, ...]:
    """(encoder input, encoder output, decoder input, decoder output, and
    for GF(256)/RS the erasure mask) of a set, one frame per row."""
    out = [native.read_vector_file(d / ENC_IN).reshape(-1, k)]
    out += [native.read_vector_file(d / f).reshape(-1, n) for f in (ENC_OUT, DEC_IN, DEC_OUT)]
    if nb:
        out.append(native.read_vector_file(d / DEC_MASK).reshape(-1, n) != 0)
    return tuple(out)


def _bytes(vals: np.ndarray, words: int, device) -> torch.Tensor:
    """Byte symbols replicated across ``words`` uint8 lanes, on ``device``."""
    return torch.from_numpy(np.repeat(vals.astype(np.uint8)[:, :, None], words, axis=2)).to(device)


def _byte_frames_ok(got: torch.Tensor, want: np.ndarray) -> bool:
    """Lane 0 equals ``want`` and every lane equals lane 0."""
    got = got.cpu().numpy()
    lanes_agree = bool((got == got[:, :, :1]).all())
    return lanes_agree and np.array_equal(got[:, :, 0], want.astype(np.uint8))


def _report(tag: str, frames: int, enc_ok: bool, dec_ok: bool) -> tuple[bool, str]:
    """(passed, the report line JAX's verifiers print)."""
    enc, dec = ("PASSED" if ok else "FAILED" for ok in (enc_ok, dec_ok))
    return bool(enc_ok and dec_ok), f"{tag}: frames={frames} encode={enc} decode={dec}"


def verify_golden(
    code: LDPCCode,
    directory: str | os.PathLike,
    *,
    device: torch.device | str,
    words: int = 8,
    peel_iters: int = 10,
    emax: int = 128,
) -> tuple[bool, str]:
    """Accelerator side: read the vector files, run the port's packed
    encoder and the escalated hybrid decoder (module docstring; JAX's
    defaults otherwise) on ``device``, compare bit-exactly.

    Returns (passed, report). Mirrors the host harness verify_output()
    (main.cpp:298-305,413-425) for both the encode and decode directions.
    Symbols are the uint32 words of ``native.expand_symbols``, handed to the
    port as int32 words with the same bits (a view, not a conversion).
    """
    from ldpc_erasure_codes_tpu_torch.ops.arrays import code_arrays
    from ldpc_erasure_codes_tpu_torch.ops.encode import encode_packed
    from ldpc_erasure_codes_tpu_torch.ops.hybrid import hybrid_decode_escalated

    enc_in, enc_out, dec_in, dec_out = _read(pathlib.Path(directory), code.n, code.k, nb=False)
    arrays = code_arrays(code, device)

    def expand(vals):  # (frames, n) values -> int32 word frames, erasure masks
        sym, er = zip(*(native.expand_symbols(f, words) for f in vals))
        return (torch.from_numpy(np.stack(sym).view(np.int32)).to(device),
                torch.from_numpy(np.stack(er)).to(device))

    def collapse(v):
        return np.stack([native.collapse_symbols(f) for f in v.cpu().numpy().view(np.uint32)])

    cw = encode_packed(arrays, expand(enc_in)[0])
    enc_ok = np.array_equal(collapse(cw), enc_out)
    sym, er = expand(dec_in)
    v, _e, _iters, failed, _ = hybrid_decode_escalated(arrays, sym, er, peel_iters=peel_iters,
                                                       emax=emax)
    dec_ok = not bool(failed.any()) and np.array_equal(collapse(v), dec_out)
    return _report(f"golden {code.name}", enc_in.shape[0], enc_ok, dec_ok)


def verify_golden_nb(
    code: LDPCCode,
    directory: str | os.PathLike,
    *,
    device: torch.device | str,
    words: int = 8,
    peel_iters: int = 10,
    emax: int = 128,
) -> tuple[bool, str]:
    """Accelerator side, GF(256) tier: the port's packed NB encoder and
    the escalated wide NB hybrid decoder on ``device``, byte symbols replicated across
    ``words`` lanes (a multiple of 4), compared bit-exactly."""
    from ldpc_erasure_codes_tpu_torch.ops.arrays import code_arrays
    from ldpc_erasure_codes_tpu_torch.ops.encode import encode_packed
    from ldpc_erasure_codes_tpu_torch.ops.hybrid import hybrid_decode_escalated

    enc_in, enc_out, dec_in, dec_out, dec_mask = _read(pathlib.Path(directory), code.n, code.k,
                                                       nb=True)
    arrays = code_arrays(code, device)
    cw = encode_packed(arrays, _bytes(enc_in, words, device), gf_order=256)
    enc_ok = _byte_frames_ok(cw, enc_out)
    mask = torch.from_numpy(dec_mask).to(device)
    sym = _bytes(dec_in, words, device) * ~mask[:, :, None]  # erased slots zero
    v, _e, _iters, failed, _ = hybrid_decode_escalated(arrays, sym, mask, gf_order=256,
                                                       peel_iters=peel_iters, emax=emax)
    dec_ok = not bool(failed.any()) and _byte_frames_ok(v, dec_out)
    return _report(f"golden-nb {code.name}", enc_in.shape[0], enc_ok, dec_ok)


def verify_golden_rs(
    n: int,
    k: int,
    directory: str | os.PathLike,
    *,
    device: torch.device | str,
    words: int = 8,
) -> tuple[bool, str]:
    """Accelerator side, RS tier: the port's ``rs_encode`` and ``rs_decode``
    (the GF(256) Gauss-Jordan solve) on ``device``, byte symbols replicated
    across ``words`` lanes (a multiple of 4), compared bit-exactly against
    the MATLAB-faithful oracle files."""
    from ldpc_erasure_codes_tpu_torch.ops.arrays import code_arrays
    from ldpc_erasure_codes_tpu_torch.rs.code import rs_code
    from ldpc_erasure_codes_tpu_torch.rs.decode import rs_decode, rs_encode

    enc_in, enc_out, dec_in, dec_out, dec_mask = _read(pathlib.Path(directory), n, k, nb=True)
    arrays = code_arrays(rs_code(n, k), device)
    enc_ok = _byte_frames_ok(rs_encode(arrays, _bytes(enc_in, words, device)), enc_out)
    mask = torch.from_numpy(dec_mask).to(device)
    sym = _bytes(dec_in, words, device) * ~mask[:, :, None]
    v, _e, failed = rs_decode(arrays, sym, mask)
    dec_ok = not bool(failed.any()) and _byte_frames_ok(v, dec_out)
    return _report(f"golden-rs ({n},{k})", enc_in.shape[0], enc_ok, dec_ok)
