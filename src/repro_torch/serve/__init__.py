"""Serving of the port (only the batch buckets so far)."""
