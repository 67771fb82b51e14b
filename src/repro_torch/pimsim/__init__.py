"""Analytical SAL-PIM performance model (paper-evaluation reproduction):
the port's own copy of `repro.pimsim`, plain Python with the same
arithmetic in the same order (no framework, no device).

Its figures are models of the paper's hardware, not measurements of any
card: `hbm.py` models the paper's HBM2-based SAL-PIM (Table 2) and
`gpu_model.py` the paper's Titan RTX baseline running FasterTransformer.
No number it gives is the H100's.
"""
