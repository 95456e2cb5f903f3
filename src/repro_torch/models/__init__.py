"""Models built on the port's GraphBLAS layer."""
