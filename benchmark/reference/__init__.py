"""The plain reference: PWCLO-Net in plain PyTorch, float32, importing nothing of the program."""
