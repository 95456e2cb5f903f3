"""B2SR SpMM: the multi-frontier traversal, the dense SpMM and the
popcount SpMM of the BitGNN layers."""
