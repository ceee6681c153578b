"""Least work of the kernel sites and FLOPs of a call, from shapes."""
