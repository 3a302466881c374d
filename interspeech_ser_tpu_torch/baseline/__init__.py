"""Host-side copies of the challenge baseline's label and audio loaders."""
