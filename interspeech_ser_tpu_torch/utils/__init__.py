"""Host-side helpers: audio, .pt I/O, configs, labels, metrics."""
