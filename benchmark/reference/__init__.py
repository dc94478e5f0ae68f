"""The plain reference of the benchmark: PyTorch and NumPy only. Nothing here
imports the program under test, JAX, or the JAX package."""
