"""Launch entry points of the port (so far the deploy-time tuner)."""
