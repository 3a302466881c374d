"""Speech encoder, fusion classifier, weight converters and loaders."""
