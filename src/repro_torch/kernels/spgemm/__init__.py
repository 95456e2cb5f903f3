"""Boolean B2SR SpGEMM with sparse output."""
