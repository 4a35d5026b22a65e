"""The plain reference: plain PyTorch and numpy, importing nothing of the
program, that both the checks and the control use."""
