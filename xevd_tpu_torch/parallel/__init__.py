"""GOP-parallel decode: a batch of independent IDR-led GOPs through the
batched kernels (parallel/gop.py, the port of xevd_tpu/parallel/gop.py)."""
