"""The plain reference: plain PyTorch, nothing of the program."""
