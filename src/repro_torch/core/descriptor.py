"""GraphBLAS operation descriptor (the spec's ``GrB_Descriptor``).

  mask         structural output mask, applied right before the store
               (paper §V); a ``BitVector`` for packed mxv.
  complement   use ⟨¬M⟩ instead of ⟨M⟩ (BFS keeps *unvisited* bits).
  transpose_a  operate on Aᵀ: ``vxm`` is ``mxv`` with ``transpose_a=True``,
               resolved against the stored transpose.
  replace      True (default): masked-out entries get the ⊕-identity.
               False: masked-out entries come from ``out=``.
  row_chunk    bounded-memory evaluation over row chunks (disables the
               bucketed path).
  direction    None, or "pull" for the early-exit pull row
               (``mxv_pull``), valid only for the masked packed traversal.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

#: Sentinel distinguishing "kwarg not given" from an explicit None.
_UNSET = object()


@dataclasses.dataclass(frozen=True)
class Descriptor:
    mask: Any = None
    complement: bool = False
    transpose_a: bool = False
    replace: bool = True
    row_chunk: Optional[int] = None
    direction: Optional[str] = None

    def replace_with(self, **kw) -> "Descriptor":
        return dataclasses.replace(self, **kw)


#: The all-defaults descriptor (no mask, no transpose, replace semantics).
DEFAULT = Descriptor()


def merge_sugar(desc: Optional[Descriptor], mask=_UNSET, complement=_UNSET,
                row_chunk=_UNSET) -> Descriptor:
    """Fold ``mask=``/``complement=``/``row_chunk=`` kwargs into a
    :class:`Descriptor`; passing both a ``desc`` and kwargs raises."""
    sugar = {k: v for k, v in
             (("mask", mask), ("complement", complement),
              ("row_chunk", row_chunk)) if v is not _UNSET}
    if desc is None:
        return Descriptor(**sugar) if sugar else DEFAULT
    if sugar:
        raise ValueError(
            f"pass either desc= or the {sorted(sugar)} kwargs, not both")
    return desc
