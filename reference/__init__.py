"""Plain float32 PyTorch references of the models the port runs, each in a
file of its own that imports nothing of the port."""
