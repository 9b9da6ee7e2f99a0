"""Constraint blocks packed for the kernels.

Both kernels that read constraint rows (``riccati_fused.cu`` and
``ls_rollout_al.cu``) take the blocks' shared stacks concatenated row-wise,
Cx [N, P, n], Cu [N, P, m], b [N, P] and the knot mask repeated per row
[N, P], plus a block table: one (first row, p, cone code) entry per block,
passed by value to the kernel with one multiplier pointer per block, so the
per-lane multipliers are read where they lie. The stacks do not change
during a solve: the solver packs them once per solve.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Sequence, Tuple

import torch

from ..cones import Cone

MAX_BLOCKS = 16
MAX_ROWS = 64
CONE_CODES = {Cone.ZERO: 0, Cone.NONPOS: 1, Cone.SOC: 2}


@dataclass(frozen=True)
class PackedBlocks:
    Cx: torch.Tensor     # [N, P, n]
    Cu: torch.Tensor     # [N, P, m]
    b: torch.Tensor      # [N, P]
    mask: torch.Tensor   # [N, P]: each block's knot mask on its rows
    meta: Tuple[Tuple[int, int, int], ...]   # (first row, p, cone code)

    @property
    def P(self) -> int:
        return self.Cx.shape[1]


def pack_blocks(blocks: Sequence, N: int, n: int, m: int,
                like: torch.Tensor) -> PackedBlocks:
    """Concatenate the blocks' stacks row-wise (dtype and device of
    ``like``). Raises beyond MAX_BLOCKS blocks or MAX_ROWS rows."""
    P = sum(c.p for c in blocks)
    if len(blocks) > MAX_BLOCKS or P > MAX_ROWS:
        raise ValueError(f"the kernels take at most {MAX_BLOCKS} blocks and "
                         f"{MAX_ROWS} constraint rows; got {len(blocks)} "
                         f"blocks, {P} rows")
    meta, row = [], 0
    for c in blocks:
        meta.append((row, c.p, CONE_CODES[c.cone]))
        row += c.p
    if not blocks:
        empty = torch.empty((N, 0), dtype=like.dtype, device=like.device)
        return PackedBlocks(Cx=empty[..., None].expand(N, 0, n),
                            Cu=empty[..., None].expand(N, 0, m), b=empty,
                            mask=empty, meta=())
    return PackedBlocks(
        Cx=torch.cat([c.Cx for c in blocks], dim=1).contiguous(),
        Cu=torch.cat([c.Cu for c in blocks], dim=1).contiguous(),
        b=torch.cat([c.b for c in blocks], dim=1).contiguous(),
        mask=torch.cat([c.mask[:, None].expand(N, c.p) for c in blocks],
                       dim=1).contiguous(),
        meta=tuple(meta))


def table_args(packed: PackedBlocks, lams: Sequence[torch.Tensor]):
    """(block count, int[3 * count] table, void*[count] multiplier
    pointers) for a kernel entry point, the arrays as void pointers (each
    keeps its array alive)."""
    nb = len(packed.meta)
    meta = (ctypes.c_int * max(1, 3 * nb))(
        *[v for entry in packed.meta for v in entry])
    ptrs = (ctypes.c_void_p * max(1, nb))(*[lam.data_ptr() for lam in lams])
    return (nb, ctypes.cast(meta, ctypes.c_void_p),
            ctypes.cast(ptrs, ctypes.c_void_p))
