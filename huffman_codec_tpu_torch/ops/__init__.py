"""The port's device ops: plain tensor code and the CUDA kernel wrappers."""
