"""The (dp, mp) mesh on torch.distributed: process grid, row-sharded vocab
tables, collectives, the sharded top-k and the local launcher."""
