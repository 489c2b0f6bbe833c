"""Model → Program IR exports of the port."""
