"""Host-side utilities of the port: certificate and checkpoints."""
