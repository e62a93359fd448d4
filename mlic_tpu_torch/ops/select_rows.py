"""Row select ``table[row]`` per column: kernel K1 and its plain version.

Port of ``mlic_tpu/ops/pallas_select.py`` (``select_rows_pallas``) and of
``device_rans.select_rows`` (:387), for the Gaussian row-parameter table
(65 rows x 6 columns m, b, A, C, B, L).  The codec launches it once per
``Codec.update``, in ``parametric.self_check``; the kernels that code a
batch (K4, K7) select their rows in their own shared memory with the
same rule, and the plain versions of both call ``select_rows_plain``.
Rows outside
``[0, n_rows)`` select row 0, as the TPU kernel's compare+select chain does.
Exact by construction: the kernel copies the table's own f32 values.
"""

from __future__ import annotations

import torch

from mlic_tpu_torch.ops._build import KERNELS, stream_handle

KERNEL = KERNELS["select_rows"]
MAX_ROWS, MAX_COLS = 128, 8


def select_rows_plain(row: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """``[table[row][..., j] for j]`` stacked: [n_cols, *row.shape] f32."""
    n_rows = table.shape[0]
    r = torch.where((row >= 0) & (row < n_rows), row, 0).long()
    return table[r].movedim(-1, 0).contiguous()


def select_rows(row: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """K1 for CUDA tensors, the plain version for CPU tensors.

    row: int32, any shape, contiguous.  table: f32 [n_rows <= 128,
    n_cols <= 8], contiguous, on the same device.  Returns f32
    [n_cols, *row.shape]; ``m, b, A, C, B, L = select_rows(...)`` unpacks
    the codec's columns."""
    if row.device.type == "cpu":
        return select_rows_plain(row, table)
    if row.device.type != "cuda" or table.device != row.device:
        raise ValueError("select_rows: row and table must share a CUDA device")
    if row.dtype != torch.int32 or table.dtype != torch.float32:
        raise TypeError("select_rows: row must be int32 and table float32")
    if table.dim() != 2 or not (1 <= table.shape[0] <= MAX_ROWS
                                and 1 <= table.shape[1] <= MAX_COLS):
        raise ValueError(f"select_rows: table shape {tuple(table.shape)} "
                         f"exceeds [{MAX_ROWS}, {MAX_COLS}]")
    if not (row.is_contiguous() and table.is_contiguous()):
        raise ValueError("select_rows: inputs must be contiguous")
    n_rows, n_cols = table.shape
    out = torch.empty((n_cols,) + tuple(row.shape), dtype=torch.float32,
                      device=row.device)
    KERNEL.launch(row.data_ptr(), table.data_ptr(), out.data_ptr(),
                  row.numel(), n_rows, n_cols, stream_handle(row))
    return out
