"""Plain float CSR/COO matrix — the GraphBLAST/cuSPARSE baseline substrate.

The torch twin of ``repro.core.csr``: CSR pointers plus a COO row-index
array, so SpMV is a gather plus a segment reduction (``scatter_reduce``)
over edges.

The product with a dense matrix (``spmm``) is one ``torch.sparse.mm``.
The products over two matrices stay sparse, where the reference's
densify: the boolean SpGEMM is a ``torch.sparse`` CSR product (cuSPARSE
on the card) over row chunks of bounded work, and the triangle sum
intersects sorted rows. Column indices are sorted within each row
(``from_coo`` sorts), which both rely on.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Optional

import torch

from repro_torch.core.b2sr import B2SR, ceil_div, coo_to_b2sr, stack_rows
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


def spmm(m: CSRMatrix, x: torch.Tensor) -> torch.Tensor:
    """Y = A @ X for dense X ``[n_cols, d]`` (arithmetic semiring): one
    ``torch.sparse.mm`` of the CSR (cuSPARSE SpMM on the card)."""
    return torch.sparse.mm(to_sparse(m, dtype=x.dtype), x)


#: Work of one row chunk of the sparse products: wedges (pairs of
#: consecutive edges), each at most one product entry.
CHUNK_WEDGES = 1 << 27


def to_sparse(m: CSRMatrix, rows: slice = slice(None),
              dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """A ``torch.sparse_csr_tensor`` of the rows ``rows`` (a step-1 slice),
    its values in ``dtype``."""
    r0, r1, _ = rows.indices(m.n_rows)
    lo, hi = int(m.row_ptr[r0]), int(m.row_ptr[r1])
    with warnings.catch_warnings():     # "sparse CSR support is in beta"
        warnings.simplefilter("ignore", UserWarning)
        return torch.sparse_csr_tensor(
            m.row_ptr[r0:r1 + 1] - lo, m.col_idx[lo:hi],
            m.values[lo:hi].to(dtype), size=(r1 - r0, m.n_cols),
            check_invariants=False)


def to_dense(m: CSRMatrix) -> torch.Tensor:
    dense = torch.zeros((m.n_rows, m.n_cols), dtype=m.values.dtype,
                        device=m.values.device)
    dense[m.row_idx.long(), m.col_idx.long()] = m.values
    return dense


def row_lengths(m: CSRMatrix) -> torch.Tensor:
    return (m.row_ptr[1:] - m.row_ptr[:-1]).long()


def work_chunks(work: torch.Tensor):
    """Split ``[0, len(work))`` into runs whose work is at most
    ``CHUNK_WEDGES`` (a single item may exceed it): yields ``(start, end)``."""
    budget = CHUNK_WEDGES
    cum = torch.cumsum(work, 0)
    n, start = work.shape[0], 0
    while start < n:
        base = int(cum[start - 1]) if start else 0
        end = int(torch.searchsorted(cum, base + budget, right=True))
        end = min(max(end, start + 1), n)
        yield start, end
        start = end


def expand(work: torch.Tensor, start: int):
    """One slot per unit of ``work`` of items ``start, start + 1, ...``:
    (the item of each slot, the slot's offset within its item)."""
    idx = torch.arange(start, start + work.shape[0], device=work.device)
    rep = torch.repeat_interleave(idx, work)
    first = torch.cumsum(work, 0) - work
    return rep, torch.arange(rep.shape[0], device=work.device) - first[
        rep - start]


def is_in(sorted_keys: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Whether each entry of ``q`` is in ``sorted_keys`` (binary search)."""
    if not sorted_keys.numel():
        return torch.zeros_like(q, dtype=torch.bool)
    pos = torch.searchsorted(sorted_keys, q).clamp(max=sorted_keys.numel() - 1)
    return sorted_keys[pos] == q


def mxm_bool(a: CSRMatrix, b: CSRMatrix, tile_dim: int,
             mask: Optional[CSRMatrix] = None,
             complement: bool = False) -> B2SR:
    """Boolean C⟨M⟩ = A ∨.∧ B as B2SR: a float CSR product per chunk of
    tile-rows, its pattern masked and packed.

    Chunks hold whole tile-rows, so their B2SR pieces concatenate.
    """
    t = tile_dim
    n_tr = ceil_div(a.n_rows, t)
    wedges = torch.zeros(n_tr * t, dtype=torch.int64, device=a.values.device)
    wedges.index_add_(0, a.row_idx.long(),
                      row_lengths(b)[a.col_idx.long()])
    bs = to_sparse(b)
    m_keys = (None if mask is None else
              mask.row_idx.long() * mask.n_cols + mask.col_idx.long())
    pieces = []
    for tr0, tr1 in work_chunks(wedges.view(n_tr, t).sum(1)):
        r0, r1 = tr0 * t, min(tr1 * t, a.n_rows)
        c = to_sparse(a, slice(r0, r1)) @ bs
        crow = c.crow_indices()
        rr = torch.repeat_interleave(
            torch.arange(r1 - r0, device=crow.device), crow[1:] - crow[:-1])
        cc = c.col_indices()
        if m_keys is not None:
            hit = is_in(m_keys, (rr + r0) * b.n_cols + cc)
            keep = ~hit if complement else hit
            rr, cc = rr[keep], cc[keep]
        pieces.append(coo_to_b2sr(rr, cc, r1 - r0, b.n_cols, t, rr.device))
    if not pieces:
        return coo_to_b2sr(a.row_idx[:0], a.col_idx[:0], a.n_rows, b.n_cols,
                           t, a.values.device)
    return stack_rows(pieces, b.n_cols, t)


def masked_dot_sum(a: CSRMatrix, bt: CSRMatrix, mask_rows: torch.Tensor,
                   mask_cols: torch.Tensor) -> torch.Tensor:
    """Σ_{(r,c) in the mask} |row r of A ∩ row c of Bᵀ| = Σ mask ⊙ (A·B),
    as int64, by sorted-row intersection.

    Each mask entry walks the shorter of its two rows and looks every
    entry up in the other, a binary search over the sorted
    ``row * n + col`` keys of that matrix.
    """
    dev = a.values.device
    total = torch.zeros((), dtype=torch.int64, device=dev)
    if not mask_rows.numel():
        return total
    n = a.n_cols
    r, c = mask_rows.long(), mask_cols.long()
    mats = (a, bt)
    keys = [m.row_idx.long() * n + m.col_idx.long() for m in mats]
    lens = [row_lengths(m) for m in mats]
    a_walks = lens[0][r] <= lens[1][c]          # walk A's row, probe Bᵀ's
    walk = torch.where(a_walks, r, c)
    probe = torch.where(a_walks, c, r)
    work = torch.where(a_walks, lens[0][r], lens[1][c])
    for e0, e1 in work_chunks(work):
        rep, off = expand(work[e0:e1], e0)
        side = a_walks[rep]
        for src, m, k in ((0, a, keys[1]), (1, bt, keys[0])):
            sel = side if src == 0 else ~side
            w_rows, offs = walk[rep[sel]], off[sel]
            q = probe[rep[sel]] * n + m.col_idx[
                m.row_ptr.long()[w_rows] + offs].long()
            total += is_in(k, q).sum()
    return total


def tri_sum(l: CSRMatrix) -> torch.Tensor:
    """Σ (L·Lᵀ ⊙ L) for a strict lower triangle ``L``: the triangle count
    (int64), each triangle once."""
    return masked_dot_sum(l, l, l.row_idx, l.col_idx)
