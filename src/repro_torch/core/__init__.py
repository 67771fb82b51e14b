"""LUT tables, the nonlinear policy and the SAL-PIM engine."""
