"""Fusion scoring engine and its lazy feature data pipeline."""
