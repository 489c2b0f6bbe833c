"""Checkpoint substrate of the port (see :mod:`.checkpoint`)."""
