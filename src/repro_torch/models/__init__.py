"""Models of the serving path: layers, the RG-LRU block, assembly and
weights."""
