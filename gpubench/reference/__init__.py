"""The plain float32 reference the benchmark holds the program against.
It imports nothing of the program, of the JAX package or of JAX."""
