"""The plain reference: PyTorch operations only, float32 with TF32 off. It
imports nothing of the program and takes nothing the program made."""
