"""Scientific mini-apps of the port (only minibude so far)."""
