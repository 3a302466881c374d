"""Fusion training and scoring engine, its lazy feature data pipeline, and the LoRA fine-tune."""
