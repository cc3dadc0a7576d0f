"""Scientific mini-apps of the port: minibude, bonds and binomial so far."""
