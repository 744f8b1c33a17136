"""The plain reference the benchmark's check compares the port with: plain
PyTorch and NumPy, importing nothing of the port."""
