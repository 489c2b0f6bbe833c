"""Data substrate of the port: the reference's deterministic token pipeline."""
