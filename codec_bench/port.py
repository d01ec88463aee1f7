"""What the benchmark takes from the program: its code tables, its encoder
(which builds the receive pools) and the shape of what an entry returns.

The program is ``ldpc_erasure_codes_tpu_torch``; it is imported here, when a
run sets up, and never at module import.
"""

from __future__ import annotations

import hashlib
import os
from typing import NamedTuple

import torch


class Out(NamedTuple):
    """One call's outputs: ``values`` (B, n, W) int32 words, ``erased``
    (B, n) bool where the decoder left a symbol unknown, ``failed`` (B,)
    bool where it flagged a frame (None where the entry returns no flags)."""

    values: torch.Tensor
    erased: torch.Tensor | None
    failed: torch.Tensor | None


def sha256(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def check_code_files(config: dict, bench_root: str, repo_root: str) -> None:
    """The frozen code file and the program's copy must both have the
    digest the configuration records."""
    code = config["code"]
    if code["kind"] != "ldpc":
        return
    for path in (os.path.join(bench_root, code["file"]), os.path.join(repo_root, code["port_file"])):
        got = sha256(path)
        if got != code["sha256"]:
            raise ValueError(f"{path}: sha256 {got}, the configuration records {code['sha256']}")


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
    """The program's systematic encode of (B, k, W) int32 source words."""
    if config["code"]["kind"] == "ldpc":
        from ldpc_erasure_codes_tpu_torch.ops.encode import encode_packed

        return encode_packed(arrays, source)
    from ldpc_erasure_codes_tpu_torch.rs.decode import rs_encode

    return rs_encode(arrays, source.view(torch.uint8)).view(torch.int32)
