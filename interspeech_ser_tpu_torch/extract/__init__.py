"""Batched embedding extraction (wav dir -> per-utterance .pt)."""
