"""The plain PyTorch reference. It imports nothing of the program."""
