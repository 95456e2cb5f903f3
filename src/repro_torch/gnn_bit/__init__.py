"""BitGNN: binary GNN inference on the bit path.

``binarize``: the straight-through-estimator binarizers, per-feature α
scales and activation packing into :class:`~repro_torch.core.operands.
BitMatrix` words. ``layers``: registry-dispatched aggregation over a B2SR
adjacency: the float GCN product (the dense mxm row), the packed
bin·bin→full row and the α·popcount reconstruction of ±1 aggregation.
"""

from repro_torch.gnn_bit import binarize, layers  # noqa: F401
