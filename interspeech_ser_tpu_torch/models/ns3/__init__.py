"""NS3 FACodec prosody extraction (``facodec.py``)."""
