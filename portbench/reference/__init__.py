"""Plain float32 references of what the cells run, in plain PyTorch.

Frozen copies of the port's plain paths, written over dicts of HF-named
tensors. They import nothing of ``interspeech_ser_tpu_torch`` and nothing of
JAX, and take nothing that the program made: the benchmark makes the weights
and the inputs and hands the same to both sides.
"""
