"""PyTorch + CUDA port of tpu-ser for one NVIDIA H100: extraction, fusion
training and scoring, and LoRA fine-tuning.

The JAX package ``interspeech_ser_tpu`` stays the reference. This package
imports torch and never jax, flax, pandas, transformers or safetensors. Its
``__init__`` files import nothing, so importing one host module never pulls
in a heavy one; the CUDA kernels (``csrc/``) are built on first launch.
"""
