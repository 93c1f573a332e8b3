"""Plain PyTorch / NumPy reference of the DLB step.  Imports nothing of
the program under test, and nothing of JAX."""
