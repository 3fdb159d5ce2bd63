"""The plain PyTorch reference that decides ``correct``. It imports
nothing of the port and nothing of JAX."""
