"""Several devices: the (data, model, seq) grid and the sharded match."""
