"""Plain float CSR/COO matrix — the GraphBLAST/cuSPARSE baseline substrate.

The torch twin of ``repro.core.csr``: CSR pointers plus a COO row-index
array, so SpMV is a gather plus a segment reduction (``scatter_reduce``)
over edges.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.semiring import ARITHMETIC, BOOLEAN, Semiring
from repro_torch.device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class CSRMatrix:
    row_ptr: torch.Tensor   # int32[n_rows + 1]
    col_idx: torch.Tensor   # int32[nnz]
    row_idx: torch.Tensor   # int32[nnz] (COO twin of row_ptr, for segment ops)
    values: torch.Tensor    # float32[nnz]
    n_rows: int
    n_cols: int


def from_coo(rows, cols, n_rows: int, n_cols: int,
             device: DeviceLike = None) -> CSRMatrix:
    """Sorted, de-duplicated binary CSR (every stored value is 1)."""
    dev = resolve_device(device)
    rows = torch.as_tensor(rows, device=dev).to(torch.int64)
    cols = torch.as_tensor(cols, device=dev).to(torch.int64)
    key = torch.unique(rows * n_cols + cols)
    vals = torch.ones(key.shape[0], dtype=torch.float32, device=dev)
    r, c = key // n_cols, key % n_cols
    ptr = torch.zeros(n_rows + 1, dtype=torch.int64, device=dev)
    ptr[1:] = torch.cumsum(torch.bincount(r, minlength=n_rows), 0)
    return CSRMatrix(row_ptr=ptr.to(torch.int32), col_idx=c.to(torch.int32),
                     row_idx=r.to(torch.int32), values=vals,
                     n_rows=n_rows, n_cols=n_cols)


def mxv(m: CSRMatrix, x: torch.Tensor, semiring: Semiring = ARITHMETIC,
        a_value: Optional[float] = None) -> torch.Tensor:
    """y_i = ⊕_j A_ij ⊗ x_j over edges (segment reduce by destination row).

    ``a_value`` overrides the stored edge values with a uniform value (parity
    with the binary-matrix B2SR path, whose edges carry no values).
    """
    vals = (m.values.to(x.dtype) if a_value is None
            else torch.full_like(m.values, a_value, dtype=x.dtype))
    prod = semiring.mul(vals, x[m.col_idx.long()])
    if semiring is BOOLEAN:
        prod = prod.to(torch.int32)
    y = torch.full((m.n_rows,), semiring.add_identity, dtype=prod.dtype,
                   device=x.device)
    y = y.scatter_reduce(0, m.row_idx.long(), prod, semiring.reduce,
                         include_self=True)
    return y > 0 if semiring is BOOLEAN else y


def mxv_masked(m: CSRMatrix, x: torch.Tensor, mask: torch.Tensor,
               semiring: Semiring = ARITHMETIC, complement: bool = False,
               a_value: Optional[float] = None) -> torch.Tensor:
    """Masked mxv: output elements where mask (or ~mask) is 0 are ⊕-identity."""
    y = mxv(m, x, semiring, a_value)
    keep = (mask == 0) if complement else (mask != 0)
    return torch.where(keep, y, semiring.identity_for(y.dtype, y.device))
