"""B2SR SpMM: the multi-frontier traversal and the dense SpMM."""
