"""The distributed slab transform's machinery: the shard mesh, the DEFAULT
exchange policy, the exchange, and the two mesh engines."""
