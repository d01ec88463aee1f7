"""GF(2) syndrome ``rhs = H . y`` of packed words through the code's topology.

Counterpart of the TPU kernel ``ldpc_erasure_codes_tpu/ops/pallas_synd.py::
f2_syndrome_tiled`` (:43-114) and its entry ``syndrome_from_topo``
(:117-145), the GE syndrome of ``ops/ge.py::ge_solve_packed`` when the
code's topology is at hand (``static_topo``, ge.py:354-377). The TPU kernel
bakes the Vlist into its program and works on the tile-major layout; the
port reads the Vlist tables from :class:`CodeArrays` and keeps the flat
(B, n, W) layout, returning (B, m, W) words (the JAX entry returns the
same bits as (B, m_pad, 4W) bytes). Erased slots must hold zero.

:func:`syndrome_from_topo` runs :func:`syndrome_from_topo_reference` for
CPU tensors. For CUDA tensors it takes one of two routes, chosen from the
shapes before launch (:func:`synd_route`):

* "list": ``f2_matvec_wide``'s list route (``csrc/f2mm.cu``) with the
  Vlist as its row lists (``vlist_idx`` padded with n, ``vlist_len``) over
  K = n symbols: each check's neighbours summed out of a shared-memory
  slab of the frame's symbols;
* "walk": ``csrc/synd.cu``, a warp per (frame, chunk of words) walking the
  checks in order, for the shapes where no slab fits.
"""

from __future__ import annotations

import torch

from ldpc_erasure_codes_tpu_torch.ops import _build, nbmm
from ldpc_erasure_codes_tpu_torch.ops.arrays import CodeArrays


def _check(arrays: CodeArrays, values: torch.Tensor) -> None:
    if values.dtype != torch.int32:
        raise TypeError(f"values must be torch.int32 words, got {values.dtype}")
    if values.dim() != 3 or values.shape[2] < 1:
        raise ValueError(f"values must be (B, n, W) with W >= 1, got {tuple(values.shape)}")
    if values.shape[1] < arrays.min_n:
        raise ValueError(f"n={values.shape[1]} is shorter than the code's columns ({arrays.min_n})")
    if values.device != arrays.device:
        raise ValueError(f"values on {values.device}, code tables on {arrays.device}")
    if not values.is_contiguous():
        raise ValueError("values must be contiguous")


def syndrome_from_topo_reference(arrays: CodeArrays, values: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch syndrome: a loop over the Vlist's neighbour slots, each
    a gather of one symbol per check, as ge.py's ``_syndrome_known``
    (:63-74) takes and XOR-reduces them."""
    _check(arrays, values)
    b, n, w = values.shape
    vp = torch.cat([values, values.new_zeros(b, 1, w)], dim=1)  # column n reads zero
    slot = torch.arange(arrays.dmax, device=values.device)
    idx = torch.where(slot[None, :] < arrays.vlist_len[:, None], arrays.vlist_idx, n).long()
    rhs = values.new_zeros(b, arrays.m, w)
    for j in range(arrays.dmax):
        rhs ^= vp[:, idx[:, j], :]
    return rhs


def synd_route(n: int, m: int, dmax: int, w: int) -> str:
    """The route :func:`syndrome_from_topo` takes for (B, n, W = ``w``)
    frames of a code with m checks of at most ``dmax`` neighbours: "list"
    where the list route's slab fits (:func:`.nbmm.f2_rows_slab_words`),
    else "walk" (n >= 65535, lists wider than n // 8, or a slab over
    shared memory even at 4 words)."""
    return "list" if nbmm.f2_rows_slab_words(n, m, dmax, w) is not None else "walk"


def launch_list(arrays: CodeArrays, values: torch.Tensor, wc: int | None = None) -> torch.Tensor:
    """The list route on CUDA tensors, at Wc = ``wc`` words per block
    (default: :func:`.nbmm.f2_slab_words`'s choice; raises where no slab
    fits). Counts one launch of :func:`syndrome_from_topo`."""
    _check(arrays, values)
    n, w = values.shape[1:]
    if wc is None:
        wc = nbmm.f2_slab_words(arrays.vlist_idx, n, w)
        if wc is None:
            raise ValueError(f"no list-route slab fits n={n}, lists "
                             f"{tuple(arrays.vlist_idx.shape)}")
    return nbmm.launch_rows(values, arrays.vlist_idx, arrays.vlist_len, wc,
                            counter=syndrome_from_topo)


def launch_walk(arrays: CodeArrays, values: torch.Tensor) -> torch.Tensor:
    """The walk route (``csrc/synd.cu``) on CUDA tensors. Counts one launch
    of :func:`syndrome_from_topo`."""
    _check(arrays, values)
    b, n, w = values.shape
    out = torch.empty((b, arrays.m, w), dtype=torch.int32, device=values.device)
    rc = _build.library().ldpc_synd_launch(
        values.data_ptr(), arrays.vlist_idx.data_ptr(), arrays.vlist_len.data_ptr(),
        out.data_ptr(), b, n, arrays.m, arrays.dmax, w,
        torch.cuda.current_stream(values.device).cuda_stream,
    )
    _build.check(rc, "ldpc_synd_launch")
    syndrome_from_topo.launches += 1
    return out


def syndrome_from_topo(arrays: CodeArrays, values: torch.Tensor) -> torch.Tensor:
    """(B, n, W) int32 frames, erased slots zero -> (B, m, W) int32 syndrome.

    CPU tensors take :func:`syndrome_from_topo_reference`; CUDA tensors
    launch the route :func:`synd_route` picks (or raise).
    ``syndrome_from_topo.launches`` counts launches of either route;
    ``f2_matvec_wide.launches`` does not move.
    """
    _check(arrays, values)
    if values.device.type == "cpu":
        return syndrome_from_topo_reference(arrays, values)
    if values.device.type != "cuda":
        raise ValueError(f"unsupported device {values.device}")
    _, n, w = values.shape
    if synd_route(n, arrays.m, arrays.dmax, w) == "list":
        return launch_list(arrays, values)
    return launch_walk(arrays, values)


syndrome_from_topo.launches = 0
