"""Boolean B2SR mxv: the BFS push and pull steps."""
