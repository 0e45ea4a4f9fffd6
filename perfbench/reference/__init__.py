"""Plain PyTorch references of the benchmark's configurations, float32
with TF32 off, and the lower-precision control.  They import nothing of
the program under test and take nothing it made: the harness hands them
the weights and inputs it drew from the seed, and the program's outputs
only to judge them."""
