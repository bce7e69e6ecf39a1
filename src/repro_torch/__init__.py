"""PyTorch/CUDA port of the Frontier simulator stack for one NVIDIA H100."""
