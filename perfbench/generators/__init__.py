"""General traffic generators, one module each, named by the mixes."""
