"""The plain reference the benchmark judges the program's tokens by: plain
float32 PyTorch (TF32 off) with its own LUT tables, importing nothing of
the program."""
