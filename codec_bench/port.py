"""What the benchmark takes from the program: its code tables, its encoder
(which builds the receive pools) and the shape of what an entry returns.

The program is ``ldpc_erasure_codes_tpu_torch``; it is imported here, when a
run sets up, and never at module import.
"""

from __future__ import annotations

import hashlib
import os
from typing import NamedTuple

import numpy as np
import torch


class Out(NamedTuple):
    """One call's outputs: ``values`` (B, n, W) int32 words, ``erased``
    (B, n) bool where the decoder left a symbol unknown, ``failed`` (B,)
    bool where it flagged a frame (None where the entry returns no flags)."""

    values: torch.Tensor
    erased: torch.Tensor | None
    failed: torch.Tensor | None


def gf256(config: dict) -> bool:
    """Whether the configuration's code is a GF(256) LDPC lift, whose
    entries take a frame's int32 words as bytes and ``gf_order=256``."""
    return config["code"]["kind"] == "ldpc" and config["code"].get("gf_order", 2) == 256


def sha256(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def check_code_files(config: dict, bench_root: str, repo_root: str) -> None:
    """The frozen code file and the program's copy must both have the
    digest the configuration records. For a GF(256) lift, the frozen lift
    file must have its recorded digest too, and the program's coefficients
    for ``port_name`` must equal the file's."""
    code = config["code"]
    if code["kind"] != "ldpc":
        return
    for path in (os.path.join(bench_root, code["file"]), os.path.join(repo_root, code["port_file"])):
        got = sha256(path)
        if got != code["sha256"]:
            raise ValueError(f"{path}: sha256 {got}, the configuration records {code['sha256']}")
    lift = code.get("lift")
    if lift is None:
        return
    path = os.path.join(bench_root, lift["file"])
    got = sha256(path)
    if got != lift["sha256"]:
        raise ValueError(f"{path}: sha256 {got}, the configuration records {lift['sha256']}")
    from ldpc_erasure_codes_tpu_torch.codes.io import get_code

    program = get_code(code["port_name"])
    with np.load(path) as z:
        frozen = z["vlist_val"]
    if program.gf_order != code["gf_order"] or not np.array_equal(program.vlist_val, frozen):
        raise ValueError(f"{code['port_name']}: the program's GF({program.gf_order}) coefficients "
                         f"differ from {path}")


def code_arrays(config: dict, device: torch.device):
    """The program's code tables for the configuration's code."""
    from ldpc_erasure_codes_tpu_torch.ops.arrays import code_arrays as build

    code = config["code"]
    if code["kind"] == "ldpc":
        from ldpc_erasure_codes_tpu_torch.codes.io import get_code

        return build(get_code(code["port_name"]), device)
    from ldpc_erasure_codes_tpu_torch.rs.code import rs_code

    return build(rs_code(code["n"], code["k"]), device)


def encode(config: dict, arrays, source: torch.Tensor) -> torch.Tensor:
    """The program's systematic encode of (B, k, W) int32 source words; a
    GF(256) code encodes their bytes."""
    if config["code"]["kind"] == "ldpc":
        from ldpc_erasure_codes_tpu_torch.ops.encode import encode_packed

        if gf256(config):
            return encode_packed(arrays, source.view(torch.uint8), gf_order=256).view(torch.int32)
        return encode_packed(arrays, source)
    from ldpc_erasure_codes_tpu_torch.rs.decode import rs_encode

    return rs_encode(arrays, source.view(torch.uint8)).view(torch.int32)
