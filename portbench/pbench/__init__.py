"""The benchmark's own code: the genome and read generators, the window,
the trace arithmetic and the checks on module names. It imports nothing of
the program at module level, and nothing of the JAX package ever."""
