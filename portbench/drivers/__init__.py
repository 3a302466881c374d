"""The drivers a traffic file names: ``extract`` (a speech encoder's
embedding extraction) and ``fusion_train`` (the lazy-fusion trainer)."""
