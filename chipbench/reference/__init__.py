"""Plain references that decide ``correct``: plain PyTorch and NumPy, given
the inputs and draws the benchmark made, working out again whatever the port
derived from them. Nothing here imports JAX, the JAX package or the port."""
