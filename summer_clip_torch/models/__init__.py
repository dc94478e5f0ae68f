"""Model zoo of the port: CLIP towers (PyTorch modules)."""
