"""Plain torch versions of the ops and the wrappers of their CUDA kernels."""
