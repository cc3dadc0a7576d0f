"""Serving of the port (so far the batch buckets and the flush policy)."""
